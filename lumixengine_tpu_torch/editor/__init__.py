"""The editor (counterpart of ``lumixengine_tpu/editor/``): the terminal
editor application ``app.EditorApp`` with its undo stack
(``commands.py``), entity tree and property grid, and its views: the log,
the asset browser with the asset compiler and its file watcher, the
profiler, the scene view, the animation graph and particle script editors,
the physics view, the game view (play in editor through the Runner), the
material and model-meta editors, the voxelizer, the settings and the spline
editor; gizmo math and entity folders. Terminal-grade: each view renders to
text, the frames as ANSI half-block images (``core/os_terminal.py``). The
views that touch the device run on the engine's device: the card unless the
engine was made for the CPU.

    python -m lumixengine_tpu_torch.editor.app [--world x.unv] [--device cpu]
"""
