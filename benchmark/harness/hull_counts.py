"""The byte count of the banded polytope SAT (the span physics.banded_hulls)
that hulls.sat_roofline holds its device time to: what any implementation
of the stage's contract must move, whatever it keeps on chip.

The contract (ops/physics_banded.py banded_polytope_grids, once a sweep):
from the bodies' rank-ordered tables, the [k, K, NB] contact grids of every
pair slot (d, i) that joins rank i to rank i + d, d = 1..K.
"""
from __future__ import annotations


def sat_bytes(w: int, nb: int, sweeps: int, k: int, K: int, v: int, f: int) -> int:
    """Bytes over `w` worlds of `nb` bodies, `sweeps` sweeps of k x K slots a
    body, hulls of `v` vertex and `f` face-axis slots. Per sweep and body,
    its ranked tables read once: the order entry (8 B), position (12 B),
    rotation (16 B), vertices (12 v B), face axes (12 f B) and support
    radius (4 B). Per sweep and pair slot, the grids written once: point and
    normal (12 B each), depth (4 B) and the active flag (1 B)."""
    body = 8 + 12 + 16 + 12 * v + 12 * f + 4
    slot = 12 + 12 + 4 + 1
    return w * sweeps * nb * (body + k * K * slot)
