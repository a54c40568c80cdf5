"""The port stands on torch and numpy alone: no module under
lumixengine_tpu_torch/, nor chip_smoke.py, imports jax, flax or the JAX
package. (An ast scan: this image imports jax at interpreter start, so a
sys.modules check cannot tell.)"""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "lumixengine_tpu"}
PKG = ROOT / "lumixengine_tpu_torch"
# _build/ holds build outputs (git ignores it), not sources of the package
SOURCES = sorted(p for p in PKG.rglob("*.py") if "_build" not in p.relative_to(PKG).parts)
SOURCES.append(ROOT / "chip_smoke.py")
SOURCES.append(ROOT / "tools" / "host_tier.py")
SOURCES.append(ROOT / "tools" / "asset_tier.py")
SOURCES.append(ROOT / "tools" / "editor_tier.py")
SOURCES.append(ROOT / "tools" / "surface_tier.py")
SOURCES.append(ROOT / "tools" / "members_tier.py")
# the editor's host views and app, and the world sharding's dry run (the modules that joined
# the package last)
EDITOR_AND_SHARDING = [f"lumixengine_tpu_torch/editor/{m}.py" for m in (
    "app", "asset_browser", "commands", "entity_folders", "gizmo", "log_ui", "material_editor",
    "meta_editor", "physics_view", "profiler_ui", "scene_view", "settings_ui",
    "spline_editor")] + ["lumixengine_tpu_torch/parallel/mesh.py",
                         "lumixengine_tpu_torch/parallel/dryrun.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


def test_the_scan_sees_the_package():
    names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    assert "lumixengine_tpu_torch/ops/solver.py" in names
    assert "lumixengine_tpu_torch/ops/culling.py" in names
    assert "lumixengine_tpu_torch/importers/instantiate.py" in names
    assert "lumixengine_tpu_torch/engine/serialize.py" in names
    assert "tools/host_tier.py" in names
    assert "tools/asset_tier.py" in names
    assert "lumixengine_tpu_torch/importers/fbx.py" in names
    assert "lumixengine_tpu_torch/core/os_terminal.py" in names
    assert "lumixengine_tpu_torch/editor/game_view.py" in names
    assert "tools/editor_tier.py" in names
    assert "tools/surface_tier.py" in names
    assert "tools/members_tier.py" in names
    assert len(names) >= 20


@pytest.mark.parametrize("name", EDITOR_AND_SHARDING)
def test_the_scan_sees_the_editor_and_the_sharding(name):
    assert name in {p.relative_to(ROOT).as_posix() for p in SOURCES}


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_import(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_catches_a_jax_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import os\nfrom jax import numpy\nimport lumixengine_tpu.ops\n")
    assert set(_imported_roots(f)) & FORBIDDEN == {"jax", "lumixengine_tpu"}
