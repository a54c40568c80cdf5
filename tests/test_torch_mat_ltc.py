"""The `.mat` and composite-texture (`.ltc`) codecs in the port
(importers/mat.py, importers/composite_texture.py) against the JAX package,
on files ``models/asset_scenes.py`` writes: ``parse_mat``, ``write_mat``
(its number format) and ``to_material`` give equal results; ``parse_ltc``
reads the graph that reaches every node type of the reader to equal nodes
and links; the integer-hash gradient noise is bit for bit equal, the circle,
the bilinear resample and the baked layers equal within ATOL; unknown node
types raise the same errors; and each codec's AssetCompiler plugin compiles
to equal output."""
import struct

import numpy as np
import pytest

from lumixengine_tpu.editor import asset_compiler as rac
from lumixengine_tpu.importers import composite_texture as rct
from lumixengine_tpu.importers import mat as rmat
from lumixengine_tpu_torch.editor import asset_compiler as pac
from lumixengine_tpu_torch.importers import composite_texture as pct
from lumixengine_tpu_torch.importers import mat as pmat
from lumixengine_tpu_torch.models import asset_scenes as A

ATOL = 1e-6


def test_parse_and_write_mat_equal():
    r, p = rmat.parse_mat(A.MAT_TEXT), pmat.parse_mat(A.MAT_TEXT.encode())
    assert vars(p) == vars(r)
    assert p.backface_culling is False and p.layer == "transparent"
    assert p.textures == ["textures/rock_albedo.tga", "", "textures/rock_normal.tga"]
    assert p.uniforms["Material color"] == (0.8, 0.55, 0.3, 1.0)
    text = pmat.write_mat(p)
    assert text == rmat.write_mat(r)
    assert vars(pmat.parse_mat(text)) == vars(p)
    for v in (0.1, 2.0, -0.333333333, 7):
        assert pmat._fmt_num(v) == rmat._fmt_num(v)
    # comments and unknown keys are skipped; a bad uniform raises in both
    extra = "# note\nunknown_key 3\nuniform \"Roughness\", 0.5 # half\n"
    assert vars(pmat.parse_mat(extra)) == vars(rmat.parse_mat(extra))
    for mod in (rmat, pmat):
        with pytest.raises(ValueError, match="bad uniform"):
            mod.parse_mat('uniform "x", oops\n')


def test_to_material_equal():
    r = rmat.to_material("rock", rmat.parse_mat(A.MAT_TEXT))
    p = pmat.to_material("rock", pmat.parse_mat(A.MAT_TEXT))
    for k in ("name", "shader", "layer", "uniforms", "textures", "defines", "alpha_blend"):
        assert getattr(p, k) == getattr(r, k), k
    assert p.uniforms["roughness"] == 0.75 and p.uniforms["color_g"] == 0.55
    assert p.textures == {"slot0": "textures/rock_albedo.tga", "slot2": "textures/rock_normal.tga"}
    assert p.alpha_blend


@pytest.fixture(scope="module")
def ltc():
    return A.ltc_bytes(*A.composite_graph())


def test_parse_ltc_equal(ltc):
    r, p = rct.parse_ltc(ltc), pct.parse_ltc(ltc)
    assert [vars(n) for n in p.nodes] == [vars(n) for n in r.nodes]
    assert p.links == r.links
    assert {n.type for n in p.nodes} == set(pct._PAYLOAD)     # every node type the reader knows
    bad_magic = b"XXXX" + ltc[4:]
    bad_version = ltc[:4] + struct.pack("<I", 1) + ltc[8:]
    unknown = A.ltc_bytes([("OUTPUT", 1, {"output_type": 0, "layers": 1, "channels": 4})], [])
    unknown = unknown[:16] + struct.pack("<I", 14) + unknown[20:]     # VALUE_NOISE
    for mod in (rct, pct):
        with pytest.raises(ValueError, match="magic"):
            mod.parse_ltc(bad_magic)
        with pytest.raises(ValueError, match="unsupported"):
            mod.parse_ltc(bad_version)
        with pytest.raises(ValueError, match="VALUE_NOISE"):
            mod.parse_ltc(unknown)


def test_noise_exact_and_kernels_equal():
    q = np.array([0, 1, 2, 123456, 0xFFFFFFFF], np.uint32)
    np.testing.assert_array_equal(pct._ihash1d(q), rct._ihash1d(q))
    for w, h, scale in ((64, 64, 4.0), (96, 40, 7.5), (512, 512, 16.0)):
        a, b = rct.gradient_noise(w, h, scale), pct.gradient_noise(w, h, scale)
        assert b.dtype == a.dtype == np.float32
        np.testing.assert_array_equal(b, a)
    np.testing.assert_allclose(pct.circle(33, 21, 1.5), rct.circle(33, 21, 1.5), atol=ATOL,
                               rtol=0)
    img = np.random.default_rng(0).random((17, 23, 3)).astype(np.float32)
    np.testing.assert_allclose(pct._bilinear(img, 40, 9), rct._bilinear(img, 40, 9), atol=ATOL,
                               rtol=0)


def test_bake_equal(ltc):
    load = A.texture_loader(0)
    r = rct.CompositeTextureBaker(rct.parse_ltc(ltc), load_texture=load).bake()
    p = pct.CompositeTextureBaker(pct.parse_ltc(ltc), load_texture=load).bake()
    assert [x.shape for x in p] == [x.shape for x in r] == [(32, 32, 4), (40, 48, 4)]
    for a, b in zip(r, p):
        np.testing.assert_allclose(b, a, atol=ATOL, rtol=0)
    assert all(x.std() > 0.01 for x in p)
    for mod in (rct, pct):
        with pytest.raises(ValueError, match="texture loader"):
            mod.CompositeTextureBaker(mod.parse_ltc(ltc)).bake()


def test_compiler_plugins_equal(tmp_path, ltc):
    (tmp_path / "rock.mat").write_text(A.MAT_TEXT)
    (tmp_path / "detail.ltc").write_bytes(ltc)
    out = []
    for mat, ct, ac in ((rmat, rct, rac), (pmat, pct, pac)):
        compiler = ac.AssetCompiler()
        mat.register(compiler)
        ct.register(compiler, load_texture=A.texture_loader(0))
        out.append((compiler.compile(str(tmp_path / "rock.mat")),
                    compiler.compile(str(tmp_path / "detail.ltc"))))
    (rm, rl), (pm, pl) = out
    assert pm == rm and pm.decode() == pmat.write_mat(pmat.parse_mat(A.MAT_TEXT))
    assert [vars(n) for n in pl["graph"].nodes] == [vars(n) for n in rl["graph"].nodes]
    for a, b in zip(rl["layers"], pl["layers"]):
        assert b.dtype == np.uint8
        np.testing.assert_array_equal(b, a)
