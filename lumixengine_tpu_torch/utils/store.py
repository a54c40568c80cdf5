"""DenseStore — fixed-capacity SoA component store on the host (counterpart
of ``lumixengine_tpu/utils/store.py``): dense slots with a freelist, an
entity column and typed numpy field arrays that snapshot to tensors."""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch


class DenseStore:
    def __init__(self, capacity: int, fields: Dict[str, Tuple[Tuple[int, ...], Any, Any]]):
        """fields: name -> (trailing_shape, dtype, default)."""
        self.capacity = int(capacity)
        self.entity = np.full(self.capacity, -1, np.int32)
        self.data: Dict[str, np.ndarray] = {}
        self._defaults = {}
        for name, (shape, dtype, default) in fields.items():
            arr = np.zeros((self.capacity,) + tuple(shape), dtype)
            if default is not None:
                arr[:] = default
            self.data[name] = arr
            self._defaults[name] = default
        self._slot_of: Dict[int, int] = {}
        self._free = list(range(self.capacity - 1, -1, -1))

    def __len__(self):
        return len(self._slot_of)

    def __contains__(self, entity: int) -> bool:
        return entity in self._slot_of

    def grow(self, new_capacity: int) -> None:
        """Grow to `new_capacity` slots; existing slots keep their indices."""
        new_capacity = int(new_capacity)
        if new_capacity <= self.capacity:
            return
        old = self.capacity
        self.entity = np.concatenate([self.entity, np.full(new_capacity - old, -1, np.int32)])
        for name, arr in self.data.items():
            ext = np.zeros((new_capacity - old,) + arr.shape[1:], arr.dtype)
            d = self._defaults[name]
            if d is not None:
                ext[:] = d
            self.data[name] = np.concatenate([arr, ext])
        self._free = list(range(new_capacity - 1, old - 1, -1)) + self._free
        self.capacity = new_capacity

    def add(self, entity: int, **values) -> int:
        if entity in self._slot_of:
            raise ValueError(f"entity {entity} already in store")
        if not self._free:
            self.grow(max(self.capacity * 2, 8))
        slot = self._free.pop()
        self.entity[slot] = entity
        for name, v in values.items():
            self.data[name][slot] = v
        self._slot_of[entity] = slot
        return slot

    def remove(self, entity: int) -> None:
        slot = self._slot_of.pop(entity, None)
        if slot is None:
            return
        self.entity[slot] = -1
        for name, arr in self.data.items():
            d = self._defaults[name]
            arr[slot] = d if d is not None else 0
        self._free.append(slot)

    def slot_of(self, entity: int) -> int:
        return self._slot_of.get(entity, -1)

    def get(self, entity: int, field: str):
        return self.data[field][self._slot_of[entity]]

    def set(self, entity: int, field: str, value) -> None:
        self.data[field][self._slot_of[entity]] = value

    def device(self, device, world=None) -> Dict[str, torch.Tensor]:
        """Snapshot to tensors on `device`. When `world` is given, the entity
        column is translated into the world's topo-sorted device slots."""
        ent = self.entity if world is None else world.to_slots(self.entity)
        out = {"entity": torch.as_tensor(ent, device=device)}
        for name, arr in self.data.items():
            out[name] = torch.as_tensor(arr, device=device)
        return out
