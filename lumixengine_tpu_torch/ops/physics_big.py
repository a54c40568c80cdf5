"""Pair compaction for the pruned broadphase (counterpart of
``compact_pairs`` in ``lumixengine_tpu/ops/physics_big.py``).

The reference packed the pair ids into a ``top_k`` key, a TPU layout trick.
Here it is a stable compaction by prefix sums, with the same slot order: the
overlapping candidates in ascending index, then the others in ascending
index, cut at the budget. The warm-start gate keys on that order.
"""
from __future__ import annotations

import torch


def compact_pairs(pa: torch.Tensor, pb: torch.Tensor, ok: torch.Tensor, budget: int):
    """pa, pb: int64 [P] candidate pairs; ok: bool [..., P] overlap mask.

    Returns (pa_c, pb_c int32 [..., budget], valid bool [..., budget] = the
    slot holds an overlapping pair, overflow int32 [...] = max(#ok − budget, 0)).
    """
    p = ok.shape[-1]
    oki = ok.to(torch.int64)
    n_ok = oki.sum(dim=-1, keepdim=True)
    rank_ok = torch.cumsum(oki, dim=-1) - 1
    rank_no = n_ok + torch.cumsum(1 - oki, dim=-1) - 1
    dest = torch.where(ok, rank_ok, rank_no)          # candidate -> slot
    iota = torch.arange(p, device=ok.device).expand(ok.shape)
    order = torch.empty_like(dest).scatter_(-1, dest, iota)  # slot -> candidate
    idx = order[..., :budget]
    valid = torch.arange(budget, device=ok.device) < n_ok
    overflow = torch.clamp_min(n_ok.squeeze(-1) - budget, 0).to(torch.int32)
    return pa[idx].to(torch.int32), pb[idx].to(torch.int32), valid, overflow
