"""The compiled clip codec in the port (importers/anm.py) against the JAX
package: the JAX package's synthetic cases (tests/test_anm.py: a random
clip, constant and bind-pose tracks, the LSB-first bit layout of a two-track
file, quaternions whose skipped channel changes sign, and the error
tolerances) encode to byte-equal ``.anm`` blobs in both packages, decode
to equal tracks and to clips within ATOL, and the port's decode of the
reference's bytes equals the reference's; ``compile_fbx_animations`` and the
AssetCompiler plugin on the character's take (``models/asset_scenes.py``)
give byte-equal blobs. Both packages' clips are built from the same numpy
draws."""
import importlib

import numpy as np
import pytest

from lumixengine_tpu.editor import asset_compiler as rac
from lumixengine_tpu.importers import anm as ranm
from lumixengine_tpu.importers import fbx as rfbx
from lumixengine_tpu_torch.editor import asset_compiler as pac
from lumixengine_tpu_torch.importers import anm as panm
from lumixengine_tpu_torch.importers import fbx as pfbx
from lumixengine_tpu_torch.models import asset_scenes as A

ATOL = 1e-6
PKG = {"jax": "lumixengine_tpu", "torch": "lumixengine_tpu_torch"}


def clip_cls(pkg):
    return importlib.import_module(f"{PKG[pkg]}.animation.animation").Clip


def random_clip(pkg, samples=48, bones=8, seed=0):
    """tests/test_anm.py's _random_clip with the package's Clip."""
    hm = importlib.import_module(f"{PKG[pkg]}.core.host_math")
    rng = np.random.default_rng(seed)
    base = rng.uniform(-1, 1, (bones, 3)).astype(np.float32)
    t = np.linspace(0, 2 * np.pi, samples, dtype=np.float32)
    pos = base[None] + 0.3 * np.sin(
        t[:, None, None] + rng.uniform(0, 6, (1, bones, 3))).astype(np.float32)
    axes = rng.normal(size=(bones, 3)).astype(np.float32)
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    rot = np.zeros((samples, bones, 4), np.float32)
    for f in range(samples):
        ang = (0.8 * np.sin(t[f] + np.arange(bones))).astype(np.float32)
        rot[f] = hm.quat_from_axis_angle(axes, ang)
    return clip_cls(pkg)(name="rand", pos=pos, rot=rot, fps=30.0)


def const_clip(pkg):
    samples, bones = 10, 4
    pos = np.tile(np.arange(bones * 3, dtype=np.float32).reshape(1, bones, 3), (samples, 1, 1))
    rot = np.zeros((samples, bones, 4), np.float32)
    rot[..., 3] = 1.0
    return clip_cls(pkg)(name="const", pos=pos, rot=rot)


def two_track_clip(pkg):
    pos = np.zeros((3, 2, 3), np.float32)
    pos[:, 0, 0] = [0.0, 0.5, 1.0]
    pos[:, 1, 2] = [0.0, 1.0, 2.0]
    rot = np.zeros((3, 2, 4), np.float32)
    rot[..., 3] = 1.0
    return clip_cls(pkg)(name="2track", pos=pos, rot=rot)


def spin_clip(pkg):
    hm = importlib.import_module(f"{PKG[pkg]}.core.host_math")
    ang = np.linspace(-2.5, 2.5, 33, dtype=np.float32)      # w crosses 0
    axis = np.array([[0.0, 1.0, 0.0]], np.float32)
    rot = np.stack([hm.quat_from_axis_angle(axis, np.array([a], np.float32))[0]
                    for a in ang])[:, None, :]
    return clip_cls(pkg)(name="spin", pos=np.zeros((33, 1, 3), np.float32), rot=rot)


# case → (the function making the clip, encode_clip keyword arguments)
CASES = {
    "random": (lambda pkg: random_clip(pkg), dict(skeleton="models/test.fbx")),
    "const": (const_clip, {}),
    "const_bind": (const_clip, dict(bind_pos="first")),
    "two_track": (two_track_clip, {}),
    "spin": (spin_clip, {}),
    "fine": (lambda pkg: random_clip(pkg, 64, 16, 3), dict(translation_error=0.5,
                                                            rotation_error=0.5)),
    "coarse": (lambda pkg: random_clip(pkg, 64, 16, 3), dict(translation_error=16.0,
                                                              rotation_error=16.0)),
}


def assert_anm_equal(r, p):
    assert (p.skeleton, p.fps, p.frame_count, p.flags) == (r.skeleton, r.fps, r.frame_count,
                                                           r.flags)
    assert p.translation_stream == r.translation_stream
    assert p.rotation_stream == r.rotation_stream
    assert (p.translations_frame_size_bits, p.rotations_frame_size_bits) == \
        (r.translations_frame_size_bits, r.rotations_frame_size_bits)
    for rt, pt in zip(r.translations + r.rotations, p.translations + p.rotations):
        for k, v in vars(rt).items():
            w = getattr(pt, k)
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(w, v, err_msg=k)
            else:
                assert w == v, k
    assert len(p.translations) == len(r.translations) and len(p.rotations) == len(r.rotations)


@pytest.mark.parametrize("case", list(CASES))
def test_encodings_byte_equal_and_decodes_agree(case):
    make, kw = CASES[case]
    rclip, pclip = make("jax"), make("torch")
    np.testing.assert_array_equal(pclip.pos, rclip.pos)
    np.testing.assert_array_equal(pclip.rot, rclip.rot)
    names = [f"bone{i}" for i in range(pclip.bone_count)]
    kw = dict(kw)
    if kw.get("bind_pos") == "first":
        kw["bind_pos"] = pclip.pos[0]
    rblob, pblob = ranm.encode_clip(rclip, names, **kw), panm.encode_clip(pclip, names, **kw)
    assert pblob == rblob
    r, p = ranm.decode_anm(rblob), panm.decode_anm(rblob)
    assert_anm_equal(r, p)
    rt, pt = r.dense_tracks(), p.dense_tracks()
    for a, b in zip(rt, pt):
        assert sorted(a) == sorted(b)
        for h in a:
            np.testing.assert_array_equal(b[h], a[h])
    rdec = r.to_clip(names, rclip.pos[0], rclip.rot[0], name="dec")
    pdec = p.to_clip(names, pclip.pos[0], pclip.rot[0], name="dec")
    np.testing.assert_allclose(pdec.pos, rdec.pos, atol=ATOL, rtol=0)
    np.testing.assert_allclose(pdec.rot, rdec.rot, atol=ATOL, rtol=0)
    pload = panm.load_clip(pblob, names, pclip.pos[0], pclip.rot[0], name="dec")
    np.testing.assert_array_equal(pload.pos, pdec.pos)
    # the JAX test's own bounds hold on the port's decode
    bound = 16 * 1e-4 + 1e-6 if case == "coarse" else 1e-4
    assert np.abs(pdec.pos - pclip.pos).max() <= bound
    if case in ("random", "spin", "two_track"):
        qerr = np.minimum(np.abs(pdec.rot - pclip.rot), np.abs(pdec.rot + pclip.rot)).max()
        assert qerr <= 1e-4
    if case == "const_bind":
        assert len(p.translations) == 0
    if case == "two_track":
        t0, t1 = [t for t in p.translations if not t.is_const]
        assert t1.offset_bits == sum(t0.bitsizes)
        np.testing.assert_allclose(p.get_translation(1, t0), [0.5, 0.0, 0.0], atol=1e-4)


def test_bad_blobs_raise_in_both():
    blob = panm.encode_clip(const_clip("torch"), ["a", "b", "c", "d"])
    for bad, msg in ((b"XXXX" + blob[4:], "magic"),
                     (blob[:4] + (9).to_bytes(4, "little") + blob[8:], "not supported"),
                     (blob[:4] + (6).to_bytes(4, "little") + blob[8:], "too old")):
        for mod in (ranm, panm):
            with pytest.raises(ValueError, match=msg):
                mod.decode_anm(bad)


@pytest.fixture(scope="module")
def character_take():
    data = A.character_fbx(0)
    rsk = rfbx.to_model(rfbx.FbxDoc(rfbx.parse_fbx(data)), name="c").skeleton
    psk = pfbx.to_model(pfbx.FbxDoc(pfbx.parse_fbx(data)), name="c").skeleton
    return data, rsk, psk


def test_compile_fbx_animations_on_the_take(character_take, tmp_path):
    data, rsk, psk = character_take
    path = "models/character.fbx"
    r = ranm.compile_fbx_animations(path, data, skeleton=rsk)
    p = panm.compile_fbx_animations(path, data, skeleton=psk)
    assert list(p) == list(r) == ["character"]
    assert p["character"] == r["character"]
    # without a skeleton the port builds one from the file's bones (the JAX
    # package's unpacking of build_skeleton's three results raises there)
    assert panm.compile_fbx_animations(path, data) == p
    a = panm.decode_anm(p["character"])
    assert a.skeleton == path and a.frame_count == 30
    dec = a.to_clip(psk.bone_names, psk.bind_pos, psk.bind_rot)
    clip = pfbx.to_clip(pfbx.FbxDoc(pfbx.parse_fbx(data)), psk, name="character")
    assert np.abs(dec.pos - clip.pos).max() <= 1e-4
    assert np.minimum(np.abs(dec.rot - clip.rot), np.abs(dec.rot + clip.rot)).max() <= 1e-4
    assert len(p["character"]) < 0.5 * (clip.pos.nbytes + clip.rot.nbytes)
    # a model-only file has no take
    assert panm.compile_fbx_animations("box.fbx", A.box_fbx(0), skeleton=psk) == {}
    # the AssetCompiler plugin in both packages
    f = tmp_path / "character.fbx"
    f.write_bytes(data)
    outs = []
    for mod, ac, sk in ((ranm, rac, rsk), (panm, pac, psk)):
        compiler = ac.AssetCompiler()
        mod.register(compiler, skeleton=sk)
        outs.append(compiler.compile(str(f)))
        assert compiler.get(str(f)) is outs[-1]
    assert outs[1] == outs[0]
