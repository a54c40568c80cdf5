"""Transform-hierarchy propagation (counterpart of
``lumixengine_tpu/ops/hierarchy.py``): global = parent.global ∘ local with
the non-associative SRT compose, root → leaf; a root's global is its local.

``propagate_plan`` is the engine's path. Device slots are topo-sorted by
the World (roots first, then level 1, ...), so each level is a contiguous
segment whose parents sit at host-known positions. One level costs one
index gather of the parents, one compose and one slice write. The
parent-position index tensors are built once per device and cached on the
plan.

The other three work on ENTITY-ordered states (``World.perm`` maps slot
order to entity order) with parent ids ``[..., N]`` (-1 for roots), which
may differ from world to world of a batch:

* ``propagate``: one masked full-width pass per level up to max_depth;
* ``propagate_indexed``: per level, the host's entity-id arrays
  (``World.level_indices``, shared by the batch) gather and scatter only
  that level's entities on the packed [..., 10, N] form;
* ``propagate_doubling``: pointer jumping, ceil(log2(max_depth)) rounds
  (at least 1), as in the reference; exact only where every entity in the
  hierarchy has a uniform scale (``World.hierarchy_is_uniform_scale``),
  since SRT compose is associative only then, and where max_depth is not
  a power of two (r rounds reach 2^r - 1 levels).
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from lumixengine_tpu_torch.core import transform as xf
from lumixengine_tpu_torch.core.transform import Transform
from lumixengine_tpu_torch.ops.physics_ops import take_rows, take_vecs


def propagate(local: Transform, parent: torch.Tensor, level: torch.Tensor,
              max_depth: int) -> Transform:
    """Masked full-width path: for d in 1..max_depth every entity composes
    its parent's current global with its local, and those at level d keep
    it. local [..., c, N] in entity order; parent and level int [..., N]."""
    parent_safe = torch.clamp_min(parent, 0).to(torch.int64)
    world = local
    for d in range(1, max_depth + 1):
        parent_t = Transform(pos=take_vecs(world.pos, parent_safe),
                             rot=take_vecs(world.rot, parent_safe),
                             scale=take_vecs(world.scale, parent_safe))
        composed = xf.compose(parent_t, local)
        world = xf.where(level == d, composed, world)
    return world


def propagate_indexed(local: Transform, parent: torch.Tensor,
                      level_indices: Sequence[np.ndarray]) -> Transform:
    """Per-level path: level d's entity ids (host arrays, roots excluded)
    gather their parents' packed globals, compose with their locals and
    scatter back, O(N) in all. local in entity order; parent int [..., N]."""
    world = local.packed()                                   # [..., 10, N]
    local_packed = world
    for idx_np in level_indices:
        if len(idx_np) == 0:
            continue
        idx = torch.as_tensor(np.asarray(idx_np, np.int64), device=world.device)
        pids = take_rows(parent, idx).to(torch.int64)        # [..., K_d]
        parent_t = Transform.from_packed(take_vecs(world, pids))
        local_t = Transform.from_packed(local_packed.index_select(-1, idx))
        new_packed = xf.compose(parent_t, local_t).packed()
        batch = torch.broadcast_shapes(world.shape[:-2], new_packed.shape[:-2])
        world = world.expand(batch + world.shape[-2:]).index_copy(-1, idx, new_packed)
    return Transform.from_packed(world)


def propagate_doubling(local: Transform, parent: torch.Tensor, max_depth: int) -> Transform:
    """Pointer-jumping path: each round composes every entity with its
    current ancestor prefix and doubles its pointer, so after r rounds it
    has composed its 2^r - 1 nearest ancestors. The reference's round count
    is kept: at a max_depth that is a power of two the deepest level misses
    its root. Exact only for uniform-scale hierarchies. local in entity
    order; parent int [..., N]."""
    if max_depth <= 0:
        return local
    world = local.packed()
    ptr = parent.to(torch.int64)
    for _ in range(max(1, math.ceil(math.log2(max_depth)))):
        has = ptr >= 0
        pid = torch.clamp_min(ptr, 0)
        parent_t = Transform.from_packed(take_vecs(world, pid))
        composed = xf.compose(parent_t, Transform.from_packed(world)).packed()
        world = torch.where(has.unsqueeze(-2), composed, world)
        ptr = torch.where(has, take_rows(ptr, pid), ptr)
    return Transform.from_packed(world)


class HierarchyPlan:
    """Static propagation schedule in topo-sorted slot space: one
    (start, end, parent_pos int32[K_d]) segment per level 1..D."""

    def __init__(self, segments):
        self.segments = [(int(s), int(e), np.asarray(p, np.int32)) for (s, e, p) in segments]
        self._index: Dict[str, List[torch.Tensor]] = {}

    def __len__(self):
        return len(self.segments)

    def parent_index(self, device) -> List[torch.Tensor]:
        """The segments' parent positions as int64 tensors on `device`."""
        key = str(torch.device(device))
        if key not in self._index:
            self._index[key] = [torch.as_tensor(p.astype(np.int64), device=device)
                                for _, _, p in self.segments]
        return self._index[key]


def propagate_plan(local: Transform, plan: HierarchyPlan) -> Transform:
    """Roots' globals are their locals; each level composes its contiguous
    slice with its gathered parents, top-down. Returns new tensors; `local`
    is left untouched."""
    pos, rot, scale = local.pos.clone(), local.rot.clone(), local.scale.clone()
    for (start, end, _), pp in zip(plan.segments, plan.parent_index(pos.device)):
        if end <= start:
            continue
        parent_t = Transform(pos=pos.index_select(-1, pp), rot=rot.index_select(-1, pp),
                             scale=scale.index_select(-1, pp))
        local_t = Transform(pos=pos[..., start:end], rot=rot[..., start:end],
                            scale=scale[..., start:end])
        new_t = xf.compose(parent_t, local_t)
        pos[..., start:end] = new_t.pos
        rot[..., start:end] = new_t.rot
        scale[..., start:end] = new_t.scale
    return Transform(pos=pos, rot=rot, scale=scale)


def compute_levels_host(parent) -> Tuple[np.ndarray, int]:
    """Host-side level computation on topology change: (level int32[N],
    max_depth). Dead/root slots (parent == -1) get level 0. Raises on cycles."""
    parent = np.asarray(parent, np.int32)
    n = parent.shape[0]
    level = np.zeros(n, np.int32)
    changed = True
    rounds = 0
    while changed:
        changed = False
        mask = parent >= 0
        new_level = np.where(mask, level[np.maximum(parent, 0)] + 1, 0)
        if not np.array_equal(new_level, level):
            level = new_level.astype(np.int32)
            changed = True
        rounds += 1
        if rounds > n + 1:
            raise ValueError("cycle detected in entity hierarchy")
    return level, int(level.max(initial=0))


def compute_level_indices_host(parent) -> Tuple[np.ndarray, List[np.ndarray]]:
    """(level, [entity ids of level 1, of level 2, ...]): the per-level
    arrays ``propagate_indexed`` takes (roots, level 0, excluded)."""
    level, max_depth = compute_levels_host(parent)
    indices = [np.nonzero(level == d)[0].astype(np.int32) for d in range(1, max_depth + 1)]
    return level, indices
