"""World: host-side scene builder + device-side WorldState (counterpart of
``lumixengine_tpu/engine/world.py``).

Two tiers, as in the reference:

* host tier (``World``, numpy): structural edits — create entity, set
  parent, component membership, local transforms;
* device tier (``WorldState``, tensors): what one frame step reads and
  writes, in SoA layout ``[..., C, N]`` with the entity slots in
  topo-sorted order. A leading world-batch axis, when present, replaces
  the reference's ``vmap``.

The slot permutation is the reference's (stable argsort of hierarchy
level), so every static index built from it matches the JAX package.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from lumixengine_tpu_torch.core import host_math as hm
from lumixengine_tpu_torch.core.transform import Transform
from lumixengine_tpu_torch.ops import hierarchy as hier

INVALID_ENTITY = -1
MAX_COMPONENT_TYPES = 64


def map_tensors(fn, x: Any) -> Any:
    """Apply `fn` to every tensor of a state (nested dataclasses and dicts;
    None and the empty tuple, a module without device state, pass through)."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if x is None or x == ():
        return x
    if isinstance(x, dict):
        return {k: map_tensors(fn, v) for k, v in x.items()}
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: map_tensors(fn, getattr(x, f.name))
                          for f in dataclasses.fields(x)})
    raise TypeError(f"not a state tree: {type(x).__name__}")


@dataclass
class WorldState:
    """Everything one frame of simulation touches (optionally batched [W, ...])."""

    alive: torch.Tensor          # bool [N]
    parent: torch.Tensor         # int32 [N] parent slot, -1 = root / dead
    level: torch.Tensor          # int32 [N] hierarchy depth (0 = root)
    local: Transform             # [N] local (== global for roots)
    world: Transform             # [N] derived global
    modules: Dict[str, Any]      # per-module state, keyed by module name
    frame: torch.Tensor          # int32 frame counter
    time: torch.Tensor           # float32 accumulated sim time

    def replace(self, **kw) -> "WorldState":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "WorldState":
        return map_tensors(lambda t: t.to(device), self)


class World:
    """Host-side scene container (the reference World's building API)."""

    def __init__(self, capacity: int = 4096, allocator=None):
        # `allocator` is accepted and unused, as in the reference
        self.capacity = int(capacity)
        n = self.capacity
        self.alive = np.zeros(n, bool)
        self.parent = np.full(n, INVALID_ENTITY, np.int32)
        self.generation = np.zeros(n, np.int32)
        self.archetype = np.zeros(n, np.uint64)
        self.partition_of = np.zeros(n, np.int16)
        self.partitions = ["main"]
        self.active_partition = 0
        self.local_pos = np.zeros((n, 3), np.float32)
        self.local_rot = np.tile(hm.QUAT_IDENTITY, (n, 1))
        self.local_scale = np.ones((n, 3), np.float32)
        self.names: Dict[int, str] = {}
        self._free = list(range(n - 1, -1, -1))
        self._count = 0
        self._level = np.zeros(n, np.int32)
        self._max_depth = 0
        self._level_indices: List[np.ndarray] = []
        self._levels_dirty = True  # force initial slot build
        self._perm = np.arange(n, dtype=np.int32)
        self._slot_of = np.arange(n, dtype=np.int32)
        self._slot_level = np.zeros(n, np.int32)
        self._slot_parent = np.full(n, INVALID_ENTITY, np.int32)
        self._plan = hier.HierarchyPlan([])
        self.topology_version = 0
        self.modules: Dict[str, Any] = {}
        self.component_types: Dict[str, Any] = {}

    # -- entities -------------------------------------------------------------

    def create_entity(self, position=(0.0, 0.0, 0.0), rotation=hm.QUAT_IDENTITY,
                      scale=(1.0, 1.0, 1.0), parent: int = INVALID_ENTITY,
                      name: Optional[str] = None) -> int:
        """A new entity; with a `parent`, the transform given is its local one."""
        if not self._free:
            raise RuntimeError(f"world capacity {self.capacity} exhausted")
        e = self._free.pop()
        self.alive[e] = True
        self.parent[e] = INVALID_ENTITY
        self.archetype[e] = 0
        self.partition_of[e] = self.active_partition
        self.local_pos[e] = np.asarray(position, np.float32)
        self.local_rot[e] = hm.quat_normalize(np.asarray(rotation, np.float32))
        self.local_scale[e] = np.asarray(scale, np.float32)
        self._count += 1
        if name is not None:
            self.names[e] = name
        if parent != INVALID_ENTITY:
            self.parent[e] = parent
            self._levels_dirty = True
        else:
            self._level[e] = 0
        return e

    def destroy_entity(self, e: int) -> None:
        """Free `e`: its children become roots keeping their global
        transform, its components are destroyed, its slot is recycled."""
        if not self.alive[e]:
            return
        for c in np.nonzero(self.parent == e)[0]:
            self.set_parent(int(c), INVALID_ENTITY)
        for name, (bit, module) in list(self.component_types.items()):
            if self.archetype[e] & np.uint64(1 << bit):
                module.destroy_component(e, name)
        self.alive[e] = False
        self.parent[e] = INVALID_ENTITY
        self.archetype[e] = 0
        self.generation[e] += 1
        self.names.pop(e, None)
        self._free.append(e)
        self._count -= 1
        self._levels_dirty = True

    @property
    def entity_count(self) -> int:
        return self._count

    def is_alive(self, e: int) -> bool:
        return 0 <= e < self.capacity and bool(self.alive[e])

    # -- hierarchy --------------------------------------------------------------

    def set_parent(self, child: int, parent: int) -> None:
        """Reparent, preserving the child's GLOBAL transform."""
        if parent != INVALID_ENTITY:
            p = parent
            while p != INVALID_ENTITY:
                if p == child:
                    raise ValueError("hierarchy cycle")
                p = int(self.parent[p])
        g_pos, g_rot, g_scale = self.get_global_transform(child)
        self.parent[child] = parent
        if parent == INVALID_ENTITY:
            self.local_pos[child], self.local_rot[child], self.local_scale[child] = g_pos, g_rot, g_scale
        else:
            pp, pr, ps = self.get_global_transform(parent)
            self.local_pos[child], self.local_rot[child], self.local_scale[child] = hm.compute_local(
                pp, pr, ps, g_pos, g_rot, g_scale)
        self._levels_dirty = True

    def get_parent(self, e: int) -> int:
        return int(self.parent[e])

    def children_of(self, e: int) -> List[int]:
        return [int(c) for c in np.nonzero(self.parent == e)[0]]

    def _refresh_levels(self) -> None:
        if not self._levels_dirty:
            return
        self._level, self._level_indices = hier.compute_level_indices_host(self.parent)
        self._max_depth = len(self._level_indices)
        self._rebuild_slots()
        self._levels_dirty = False

    def _rebuild_slots(self) -> None:
        """Topo-sorted slot permutation + static propagation plan (the
        reference's order exactly: stable argsort by level)."""
        n = self.capacity
        order = np.argsort(self._level, kind="stable").astype(np.int32)  # slot -> entity
        self._perm = order
        self._slot_of = np.empty(n, np.int32)
        self._slot_of[order] = np.arange(n, dtype=np.int32)
        self._slot_level = self._level[order]
        pe = self.parent[order]
        self._slot_parent = np.where(pe >= 0, self._slot_of[np.maximum(pe, 0)], -1).astype(np.int32)
        self.topology_version += 1
        segments = []
        for d in range(1, self._max_depth + 1):
            idx = np.nonzero(self._slot_level == d)[0]
            if idx.size == 0:
                continue
            start, end = int(idx[0]), int(idx[-1]) + 1
            segments.append((start, end, self._slot_parent[start:end]))
        self._plan = hier.HierarchyPlan(segments)

    @property
    def plan(self) -> hier.HierarchyPlan:
        self._refresh_levels()
        return self._plan

    @property
    def perm(self) -> np.ndarray:
        """slot -> entity permutation."""
        self._refresh_levels()
        return self._perm

    @property
    def max_depth(self) -> int:
        """The deepest hierarchy level (0: no entity has a parent)."""
        self._refresh_levels()
        return self._max_depth

    @property
    def level_indices(self) -> List[np.ndarray]:
        """Per-level ENTITY-id arrays, levels 1..max_depth, for
        ``ops.hierarchy.propagate_indexed`` on entity-ordered states (the
        device state is in slot order: see ``perm``)."""
        self._refresh_levels()
        return self._level_indices

    def hierarchy_is_uniform_scale(self) -> bool:
        """True when every entity in a parent/child relation has a uniform
        local scale (within 1e-6): SRT compose is then associative and
        ``ops.hierarchy.propagate_doubling`` is exact."""
        involved = self.parent >= 0
        parents = self.parent[involved]
        if parents.size:
            involved = involved.copy()
            involved[parents] = True
        s = self.local_scale[involved]
        if s.size == 0:
            return True
        return bool(np.allclose(s[:, 0:1], s, rtol=0.0, atol=1e-6))

    def slot(self, e: int) -> int:
        self._refresh_levels()
        return int(self._slot_of[e])

    def to_slots(self, entities: np.ndarray) -> np.ndarray:
        """Entity ids (−1 preserved) → device slots."""
        self._refresh_levels()
        e = np.asarray(entities, np.int32)
        return np.where(e >= 0, self._slot_of[np.maximum(e, 0)], -1).astype(np.int32)

    # -- transforms (host path) ---------------------------------------------------

    def get_local_transform(self, e: int):
        return self.local_pos[e].copy(), self.local_rot[e].copy(), self.local_scale[e].copy()

    def set_local_transform(self, e: int, position=None, rotation=None, scale=None) -> None:
        if position is not None:
            self.local_pos[e] = np.asarray(position, np.float32)
        if rotation is not None:
            self.local_rot[e] = hm.quat_normalize(np.asarray(rotation, np.float32))
        if scale is not None:
            self.local_scale[e] = np.asarray(scale, np.float32)

    def get_global_transform(self, e: int):
        """Walk the parent chain, composed root → entity."""
        chain = [e]
        p = int(self.parent[e])
        while p != INVALID_ENTITY:
            chain.append(p)
            p = int(self.parent[p])
        root = chain[-1]
        pos = self.local_pos[root].copy()
        rot = self.local_rot[root].copy()
        scale = self.local_scale[root].copy()
        for c in reversed(chain[:-1]):
            pos, rot, scale = hm.compose(pos, rot, scale, self.local_pos[c],
                                         self.local_rot[c], self.local_scale[c])
        return pos, rot, scale

    def set_global_transform(self, e: int, position=None, rotation=None, scale=None) -> None:
        """Set the global transform; stores the equivalent local one."""
        g_pos, g_rot, g_scale = self.get_global_transform(e)
        if position is not None:
            g_pos = np.asarray(position, np.float32)
        if rotation is not None:
            g_rot = hm.quat_normalize(np.asarray(rotation, np.float32))
        if scale is not None:
            g_scale = np.asarray(scale, np.float32)
        p = int(self.parent[e])
        if p == INVALID_ENTITY:
            self.local_pos[e], self.local_rot[e], self.local_scale[e] = g_pos, g_rot, g_scale
        else:
            pp, pr, ps = self.get_global_transform(p)
            self.local_pos[e], self.local_rot[e], self.local_scale[e] = hm.compute_local(
                pp, pr, ps, g_pos, g_rot, g_scale)

    def set_position(self, e: int, p) -> None:
        self.set_global_transform(e, position=p)

    def set_rotation(self, e: int, r) -> None:
        self.set_global_transform(e, rotation=r)

    def set_scale(self, e: int, s) -> None:
        self.set_global_transform(e, scale=s)

    # -- names / partitions -------------------------------------------------------

    def set_entity_name(self, e: int, name: str) -> None:
        self.names[e] = name

    def get_entity_name(self, e: int) -> str:
        return self.names.get(e, "")

    def find_by_name(self, name: str) -> int:
        for e, n in self.names.items():
            if n == name and self.alive[e]:
                return e
        return INVALID_ENTITY

    def create_partition(self, name: str) -> int:
        """New entities are tagged with the active partition."""
        self.partitions.append(name)
        return len(self.partitions) - 1

    def set_active_partition(self, p: int) -> None:
        self.active_partition = int(p)

    def destroy_partition(self, p: int) -> int:
        """Destroy every entity tagged with partition `p`; returns how many."""
        doomed = [e for e in range(self.capacity)
                  if self.alive[e] and int(self.partition_of[e]) == int(p)]
        for e in doomed:
            self.destroy_entity(e)
        if self.active_partition == int(p):
            self.active_partition = 0
        return len(doomed)

    # -- components ---------------------------------------------------------------

    def register_component_type(self, name: str, module) -> int:
        if name in self.component_types:
            raise ValueError(f"component type {name!r} already registered")
        bit = len(self.component_types)
        if bit >= MAX_COMPONENT_TYPES:
            raise RuntimeError("MAX_COMPONENT_TYPES exceeded")
        self.component_types[name] = (bit, module)
        return bit

    def create_component(self, e: int, ctype: str, **props):
        bit, module = self.component_types[ctype]
        if self.archetype[e] & np.uint64(1 << bit):
            raise ValueError(f"entity {e} already has component {ctype!r}")
        out = module.create_component(e, ctype, **props)
        self.archetype[e] |= np.uint64(1 << bit)
        return out

    def destroy_component(self, e: int, ctype: str) -> None:
        bit, module = self.component_types[ctype]
        if not (self.archetype[e] & np.uint64(1 << bit)):
            return
        module.destroy_component(e, ctype)
        self.archetype[e] &= ~np.uint64(1 << bit)

    def has_component(self, e: int, ctype: str) -> bool:
        bit, _ = self.component_types[ctype]
        return bool(self.archetype[e] & np.uint64(1 << bit))

    def get_module(self, name: str):
        return self.modules[name]

    # -- device state ---------------------------------------------------------------

    def device_state(self, device) -> WorldState:
        """Snapshot the host arrays into one unbatched WorldState on `device`:
        component-major [C, N] rows in topo-sorted slot order."""
        self._refresh_levels()
        p = self._perm

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=device)

        local = Transform(pos=t(self.local_pos[p].T), rot=t(self.local_rot[p].T),
                          scale=t(self.local_scale[p].T))
        return WorldState(
            alive=t(self.alive[p]),
            parent=t(self._slot_parent),
            level=t(self._slot_level),
            local=local,
            world=hier.propagate_plan(local, self._plan),
            modules={name: m.device_state(device) for name, m in self.modules.items()},
            frame=torch.zeros((), dtype=torch.int32, device=device),
            time=torch.zeros((), dtype=torch.float32, device=device),
        )

    def load_state(self, state: WorldState, slot_of=None, skip=None) -> None:
        """Copy a device snapshot's local transforms back to the host arrays,
        then each module's part (``IModule.load_state``).

        slot_of: the entity->slot permutation `state` was taken with (pass
        the one captured at snapshot time when the topology has changed
        since); defaults to the current one. skip: entity ids whose host
        values are newer than the snapshot, left untouched. Of a world
        batch, world 0 is read.
        """
        if slot_of is None:
            self._refresh_levels()
            slot_of = self._slot_of
        inv = np.asarray(slot_of)

        def host(t):
            a = t.detach().cpu().numpy()
            return a[0] if a.ndim == (3 if t.dtype.is_floating_point else 2) else a

        pos = host(state.local.pos).T[inv]
        rot = host(state.local.rot).T[inv]
        scale = host(state.local.scale).T[inv]
        keep = host(state.alive)[inv].copy()   # entities that existed in the snapshot
        if skip:
            keep[list(skip)] = False
        self.local_pos[keep] = pos[keep]
        self.local_rot[keep] = rot[keep]
        self.local_scale[keep] = scale[keep]
        for name, m in self.modules.items():
            if name in state.modules:
                m.load_state(state.modules[name])
