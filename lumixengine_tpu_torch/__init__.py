"""lumixengine_tpu_torch — the engine ported to PyTorch and CUDA for the H100.

The JAX package ``lumixengine_tpu`` beside this one is the reference; each
module here mirrors the module of the same path there. This package imports
torch and numpy only. Its hand-written Hopper kernels live in ``csrc/`` and
are built with ``nvcc`` at first use (see ``ops/native.py``).

It runs the engine as its users start it: ``app.create_full_engine()`` with
the eight systems and the ``Runner``'s game loop, the flagship frame step
with the frustum cull (kernel K1) and the fused contact solve (kernel K2),
the PhysicsModule with its game content, the render views, the scripts (the
Lua interpreter and its device fast path), navigation, GUI, audio and the
core splines and signals, and the host tier that loads and saves worlds: the
world blob, prefabs and checkpoints (``engine/serialize.py``), the ``.unv``
importer and writer with ``importers/instantiate.py``, shipped navmeshes and
the per-phase cost model; the asset codecs (FBX with its ``.meta`` sidecar,
``.anm``, ``.mat``, composite textures) and the asset compiler, the terminal
UI (``app.main --tui``), the editor (``editor/app.py``'s ``EditorApp``, its
command stack, its host views and the views that drive the device: game
view, scene view, animation graph, particle script, voxelizer) and the
sharded step (``parallel/mesh.py``). Every public name, class member and
parameter of the JAX package has its counterpart here, or a reason written
beside it in ``tests/test_torch_surface_helpers.py``.
"""
