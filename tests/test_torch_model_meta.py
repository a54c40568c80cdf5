"""The model `.meta` sidecar in the port (importers/model_meta.py) against the
JAX package: serialize and parse round-trip to equal text and fields;
``apply_meta`` under every origin mode, on a static prop and on a skinned
document (scale, origin, culling scale, LODs), gives models equal within
ATOL; ``compile_fbx`` with convex cooking (the port's
``physics/cooking.cook_convex_cached``) gives a hull equal to the
reference's within ATOL, and the AssetCompiler plugin recompiles on a meta
edit in both packages. The FBX files come from ``models/asset_scenes.py``."""
import numpy as np
import pytest

from lumixengine_tpu.editor import asset_compiler as rac
from lumixengine_tpu.importers import fbx as rfbx
from lumixengine_tpu.importers import model_meta as rmm
from lumixengine_tpu_torch.editor import asset_compiler as pac
from lumixengine_tpu_torch.importers import fbx as pfbx
from lumixengine_tpu_torch.importers import model_meta as pmm
from lumixengine_tpu_torch.models import asset_scenes as A
from test_torch_fbx import assert_models_equal

ATOL = 1e-6


def _meta(mm, **kw):
    m = mm.ModelMeta(**kw)
    m.lods_distances[0] = 15.0
    m.lods_distances[1] = 60.5
    return m


def test_meta_round_trip_equal():
    for kw in (dict(), dict(physics="convex", origin="bottom", scene_scale=2.5, culling_scale=1.2,
                            lod_count=2, split=True, ignore_animations=True,
                            create_impostor=True),
               dict(physics="trimesh", origin="center_xz", scene_scale=0.5)):
        rtext, ptext = _meta(rmm, **kw).serialize(), _meta(pmm, **kw).serialize()
        assert ptext == rtext
        r, p = rmm.parse_meta(rtext), pmm.parse_meta(ptext)
        for k in ("physics", "origin", "scene_scale", "culling_scale", "lod_count", "split",
                  "ignore_animations", "create_impostor"):
            assert getattr(p, k) == getattr(r, k), k
        np.testing.assert_array_equal(p.lods_distances, r.lods_distances)
    text = 'physics = "convex",\n  scale = 3\nbogus = {\nlod2_distance = 7\norigin = "nowhere"\n'
    r, p = rmm.parse_meta(text), pmm.parse_meta(text)
    assert (p.physics, p.scene_scale, p.origin) == (r.physics, r.scene_scale, r.origin) \
        == ("convex", 3.0, "source")
    np.testing.assert_array_equal(p.lods_distances, r.lods_distances)
    assert pmm.meta_path("a/b.fbx") == rmm.meta_path("a/b.fbx") == "a/b.fbx.meta"


@pytest.mark.parametrize("origin", ["source", "center", "center_xz", "bottom"])
@pytest.mark.parametrize("kind", ["static", "skinned"])
def test_apply_meta_equal(kind, origin):
    data = A.rock_fbx(1) if kind == "static" else A.skinned_fbx(2)
    rm = rfbx.to_model(rfbx.FbxDoc(rfbx.parse_fbx(data)), name="m")
    pm = pfbx.to_model(pfbx.FbxDoc(pfbx.parse_fbx(data)), name="m")
    kw = dict(origin=origin, scene_scale=0.5, culling_scale=1.5, lod_count=3)
    ro = rmm.apply_meta(rm, _meta(rmm, **kw))
    po = pmm.apply_meta(pm, _meta(pmm, **kw))
    assert ro is rm and po is pm
    assert_models_equal(rm, pm)
    assert pm.lod_distances[0] == 15.0 and np.isinf(pm.lod_distances[2])
    if kind == "static" and origin == "bottom":
        assert abs(float(pm.vertex_positions[:, 1].min())) < 1e-6


def _write(tmp_path, name, data, meta):
    p = tmp_path / name
    p.write_bytes(data)
    (tmp_path / (name + ".meta")).write_text(meta)
    return str(p)


def test_compile_fbx_with_convex_cooking(tmp_path):
    path = _write(tmp_path, "rock.fbx", A.rock_fbx(0), A.meta_text("convex"))
    src = open(path, "rb").read()
    r, p = rmm.compile_fbx(path, src), pmm.compile_fbx(path, src)
    assert_models_equal(r["model"], p["model"])
    assert p["meta"].scene_scale == 0.5 and p["meta"].origin == "bottom"
    (rk, rh), (pk, ph) = r["physics"], p["physics"]
    assert pk == rk == "convex"
    for k in ("verts", "axes", "inertia_diag", "com"):
        np.testing.assert_allclose(getattr(ph, k), getattr(rh, k), atol=ATOL, rtol=0, err_msg=k)
    for k in ("n_verts", "n_faces"):
        assert getattr(ph, k) == getattr(rh, k), k
    for k in ("bound_radius", "volume"):
        assert abs(getattr(ph, k) - getattr(rh, k)) <= ATOL, k
    assert ph.n_verts >= 4
    # a parsed document is taken as it is; trimesh cooking is deferred
    path2 = _write(tmp_path, "box.fbx", A.box_fbx(0), 'physics = "trimesh"\n')
    out = pmm.compile_fbx(path2, pfbx.FbxDoc(pfbx.parse_fbx(A.box_fbx(0))))
    assert out["physics"] == ("trimesh", None) == rmm.compile_fbx(
        path2, rfbx.FbxDoc(rfbx.parse_fbx(A.box_fbx(0))))["physics"]


def test_asset_compiler_plugin_recompiles_on_meta_edit(tmp_path):
    outs = {}
    for name, mm, ac in (("jax", rmm, rac), ("torch", pmm, pac)):
        d = tmp_path / name
        d.mkdir()
        path = _write(d, "sphere.fbx", A.sphere_fbx(0), A.meta_text())
        compiler = ac.AssetCompiler()
        mm.register(compiler)
        first = compiler.compile(path)
        v0 = compiler.version(path)
        (d / "sphere.fbx.meta").write_text("scale = 1.0\nlod_count = 1\n")
        compiler.on_file_changed(path + ".meta")
        assert compiler.version(path) == v0 + 1
        outs[name] = (first, compiler.get(path))
    for (r, p) in zip(outs["jax"], outs["torch"]):
        assert_models_equal(r["model"], p["model"])
        assert p["physics"] is None and r["physics"] is None
    e1 = np.ptp(outs["torch"][0]["model"].vertex_positions, axis=0)
    e2 = np.ptp(outs["torch"][1]["model"].vertex_positions, axis=0)
    np.testing.assert_allclose(e2, e1 * 2.0, rtol=1e-5)
