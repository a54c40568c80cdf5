"""The yardstick's work counts and the card's published peaks.

The counts are frozen copies of ``lumixengine_tpu_torch/ops/culling.py``'s
``k1_bytes`` and ``k1_flops`` and ``ops/solver.py``'s ``k2_bytes`` and
``k2_flops`` as of commit e797e34, so that a kernel's roofline share counts
the same work whatever implements it. A byte is counted once for each input
read and each output written; the contact solve's counts depend on the
active slots of its inputs, as its work does.
"""
from __future__ import annotations

# One NVIDIA H100 SXM (NVIDIA's data sheet), dense, at its 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

K2_ROWS = 30  # operand words per contact slot


def k1_bytes(w: int, k: int) -> int:
    """Frustum cull of k spheres in each of w worlds: centre (12 B) and
    radius (4 B) read and the mask (1 B) written per sphere, the 8 planes
    (128 B) read per world."""
    return w * k * 17 + w * 8 * 4 * 4


def k1_flops(w: int, k: int) -> int:
    """Per sphere 6 plane tests of 3 multiplies and 3 adds, 5 minimums and
    the compare against -r."""
    return w * k * (6 * 6 + 5 + 1)


def k2_bytes(w: int, nb: int, c: int, n_active: int) -> int:
    """Contact solve of w worlds of nb bodies and c slots, n_active of them
    active: act and the 3 warm-start lambdas read and the 3 lambdas written
    for every slot; the other 26 operand words of an active slot read; 9
    body words read and 9 written a world, and inv_mass."""
    return 4 * (w * c * 7 + n_active * (K2_ROWS - 4) + w * 18 * nb + nb)


def k2_flops(w: int, nb: int, c: int, n_active: int, n_pair: int, iterations: int,
             position_iterations: int) -> int:
    """The warm-start lambdas of every slot; per active contact the warm
    start, each velocity pass and each position pass, and as much again on
    the second body for the n_pair contacts that have one; per body the
    update after each pass."""
    per_active = 36 + 96 * iterations + 24 * position_iterations
    per_pair = 21 + 33 * iterations + 3 * position_iterations
    per_body = 12 * (1 + iterations) + 6 * position_iterations
    return 4 * w * c + n_active * per_active + n_pair * per_pair + w * nb * per_body


def roofline_share(nbytes: int, flops: int, seconds: float) -> float:
    """The least time the card could take for the work (bytes over the
    memory's peak or operations over float32's, the longer) over the time
    measured, as a percentage."""
    return 100.0 * max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S) / seconds
