"""lumixengine_tpu_torch — the engine ported to PyTorch and CUDA for the H100.

The JAX package ``lumixengine_tpu`` beside this one is the reference; each
module here mirrors the module of the same path there. This package imports
torch and numpy only. Its hand-written Hopper kernels live in ``csrc/`` and
are built with ``nvcc`` at first use (see ``ops/native.py``).

The ported slice is the flagship frame step with its animation and particle
arms at zero: hierarchy propagation, rigid bodies on the pruned broadphase
branch with the fused contact solver (kernel K2), and the frustum cull pass
(kernel K1). Anything outside the slice raises ``NotImplementedError``.
"""
