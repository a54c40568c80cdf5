"""The software present's device passes and the host render tier of the
port against the JAX package on the CPU: each pass of
renderer/postprocess.py on seeded numpy inputs (colour within COLOR_ATOL,
depth-like outputs within DEPTH_RTOL relative), the resize and
map_coordinates equivalences, film grain bit for bit, FSR3, the software
backend replaying a full stream with the builtin plugins (within
SOFT_LEVELS of the JAX backend's u8 image), texture loading and sampling,
the grass scatter, the render components, the textured raster, probes,
voxels and the SVG viewer."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.scipy.ndimage import map_coordinates

from lumixengine_tpu.renderer import postprocess as rpp
from lumixengine_tpu_torch import bridge
from lumixengine_tpu_torch.core import random as prng
from lumixengine_tpu_torch.renderer import postprocess as pp
from test_torch_bridge import ref_to_numpy
from test_torch_present import _pkg, run_pair, sync

torch.set_num_threads(2)

COLOR_ATOL = 1e-5     # [0, 1]-scale colour and factors
DEPTH_RTOL = 1e-5
SOFT_LEVELS = 2       # u8 levels, software present against the JAX backend
H, W = 36, 52
FOV, ASPECT = 1.1, W / H


def t(a):
    return torch.as_tensor(np.array(a))


def close(got, ref, atol=COLOR_ATOL, rtol=0.0, label=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (label, got.shape, ref.shape)
    err = float(np.max(np.abs(got.astype(np.float64) - ref))) if got.size else 0.0
    print(label, "max abs err", err)
    np.testing.assert_allclose(got, ref, atol=atol, rtol=rtol, err_msg=label)
    return err


def _scene(seed=0):
    """A seeded colour [H, W, 3] in [0, 2], a depth [H, W] of boxes at
    2-30 m with a sky band (inf), a camera."""
    rng = np.random.default_rng(seed)
    color = rng.uniform(0.0, 2.0, (H, W, 3)).astype(np.float32)
    depth = np.full((H, W), 25.0, np.float32)
    for _ in range(6):
        r0, c0 = rng.integers(0, H - 6), rng.integers(0, W - 8)
        depth[r0:r0 + rng.integers(3, 12), c0:c0 + rng.integers(4, 16)] = rng.uniform(2, 20)
    depth += rng.uniform(0, 0.05, depth.shape).astype(np.float32)
    depth[:5] = np.inf
    q = rng.normal(size=4).astype(np.float32)
    q /= np.linalg.norm(q)
    cam_pos = rng.uniform(-3, 3, 3).astype(np.float32)
    return color, depth, cam_pos, q


# -- resamplers ------------------------------------------------------------------


@pytest.mark.parametrize("kind,shape", [("bilinear", (6, 8)), ("bilinear", (9, 13)),
                                        ("bilinear", (12, 9)), ("bilinear", (30, 45)),
                                        ("nearest", (5, 7)), ("nearest", (12, 9)),
                                        ("nearest", (30, 45))])
def test_resize_matches_jax_image_resize(kind, shape):
    """jax.image.resize's half-pixel centres from [6, 8]: "bilinear"
    upsampling (the passes only upsample; downsampling antialiases there)
    is F.interpolate bilinear with align_corners=False, "nearest" (up or
    down) is nearest-exact."""
    rng = np.random.default_rng(sum(shape))
    img = rng.uniform(-1, 1, (6, 8, 3)).astype(np.float32)
    fn = pp.resize_bilinear if kind == "bilinear" else pp.resize_nearest
    ref = jax.image.resize(jnp.asarray(img), shape + (3,), kind)
    close(fn(t(img), *shape), ref, atol=2e-6, label=f"{kind} {shape}")
    ref2 = jax.image.resize(jnp.asarray(img[..., 0]), shape, kind)
    close(fn(t(img[..., 0]), *shape), ref2, atol=2e-6)


@pytest.mark.parametrize("size", [0.75, 0.5, (300, 400), 1.5, (200, 600)],
                         ids=["0.75", "0.5", "300x400", "1.5", "200x600"])
def test_fsr_upscale_matches_reference_when_it_shrinks(size):
    """fsr_upscale (and resize_bilinear under it) at an FSR3Plugin scale
    below 1, at one axis up and one down, and at an upscale, from a seeded
    270x480 colour: within COLOR_ATOL of the reference, whose
    jax.image.resize antialiases each axis that shrinks."""
    rng = np.random.default_rng(11)
    img = rng.uniform(0.0, 2.0, (270, 480, 3)).astype(np.float32)
    h, w = size if isinstance(size, tuple) else (int(270 * size), int(480 * size))
    close(pp.fsr_upscale(t(img), h, w, 0.4), rpp.fsr_upscale(jnp.asarray(img), h, w, 0.4),
          label=f"fsr_upscale {h}x{w}")
    close(pp.resize_bilinear(t(img[..., 0]), h, w),
          jax.image.resize(jnp.asarray(img[..., 0]), (h, w), "bilinear"), label="resize")


def test_bilinear_clamped_is_map_coordinates_order1_nearest():
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 5, (9, 13)).astype(np.float32)
    row = rng.uniform(-3, 12, (40, 30)).astype(np.float32)
    col = rng.uniform(-3, 16, (40, 30)).astype(np.float32)
    row[0, :5] = [0.0, 8.0, -0.5, 8.5, 4.0]          # on texels and past the edges
    ref = map_coordinates(jnp.asarray(img), [jnp.asarray(row), jnp.asarray(col)], order=1,
                          mode="nearest")
    close(pp.sample_bilinear_clamped(t(img), t(row), t(col)), ref, atol=2e-6)


def test_nearest_clamped_is_map_coordinates_order0():
    rng = np.random.default_rng(5)
    img = rng.uniform(0, 5, (6, 9, 11)).astype(np.float32)
    coords = [rng.uniform(-1, n, (50,)).astype(np.float32) for n in img.shape]
    coords[1][:6] = [0.5, 1.5, 2.5, -0.5, 7.5, 3.49999]   # halves round away from zero
    coords[2][:6] = [9.5, 10.5, 0.5, 1.5, 2.5, 4.5]
    ref = map_coordinates(jnp.asarray(img), [jnp.asarray(c) for c in coords], order=0,
                          mode="nearest")
    np.testing.assert_array_equal(np.asarray(pp.sample_nearest_clamped(
        t(img), [t(c) for c in coords])), np.asarray(ref))


# -- the passes -------------------------------------------------------------------


def test_geometry_helpers():
    color, depth, cam_pos, q = _scene()
    d = np.where(np.isfinite(depth), depth, 100.0).astype(np.float32)
    close(pp.view_positions(t(d), FOV, ASPECT), rpp.view_positions(jnp.asarray(d), FOV, ASPECT),
          atol=0, rtol=DEPTH_RTOL)
    close(pp.world_rays(t(q), FOV, ASPECT, H, W), rpp.world_rays(jnp.asarray(q), FOV, ASPECT, H, W),
          atol=COLOR_ATOL)


def test_blur_pyramid_and_bloom():
    color, *_ = _scene(1)
    c, jc = t(color), jnp.asarray(color)
    close(pp.blur5(c), rpp.blur5(jc), label="blur5")
    close(pp.blur5(c[..., 0]), rpp.blur5(jc[..., 0]), label="blur5 2d")
    close(pp.downsample2(c), rpp.downsample2(jc), label="downsample2")
    close(pp.downsample2(c[:-1, :-1]), rpp.downsample2(jc[:-1, :-1]), label="downsample2 odd")
    small = color[::3, ::4]
    close(pp.upsample_to(t(small), H, W), rpp.upsample_to(jnp.asarray(small), H, W),
          label="upsample")
    close(pp.bloom(c, 0.85, 0.6), rpp.bloom(jc, 0.85, 0.6), label="bloom")


@pytest.mark.parametrize("seed", [0, 3])
def test_depth_passes(seed):
    color, depth, cam_pos, q = _scene(seed)
    d, jd = t(depth), jnp.asarray(depth)
    close(pp.ssao(d, FOV, ASPECT, 0.8, 1.0, far=100.0),
          rpp.ssao(jd, FOV, ASPECT, 0.8, 1.0, far=100.0), label="ssao")
    sun = np.array([0.3, 0.8, -0.4], np.float32)
    close(pp.sss_shadow(d, FOV, ASPECT, t(sun), steps=8, shadow=0.45, far=100.0),
          rpp.sss_shadow(jd, FOV, ASPECT, jnp.asarray(sun), steps=8, shadow=0.45, far=100.0),
          label="sss")
    rng = np.random.default_rng(seed)
    ipos = rng.uniform(-10, 10, (40, 3)).astype(np.float32)
    irad = rng.uniform(0.5, 3, 40).astype(np.float32)
    mn = ipos.min(0) - 1.0
    inv = 1.0 / (ipos.max(0) + 1.0 - mn)
    bmin, binv = np.array([mn[0], mn[2]], np.float32), np.array([inv[0], inv[2]], np.float32)
    hm = pp.tdao_heightmap(t(ipos), t(irad), t(bmin), t(binv))
    rhm = rpp.tdao_heightmap(jnp.asarray(ipos), jnp.asarray(irad), jnp.asarray(bmin),
                             jnp.asarray(binv))
    np.testing.assert_array_equal(np.asarray(hm), np.asarray(rhm))
    close(pp.tdao(d, hm, t(cam_pos), t(q), FOV, ASPECT, t(bmin), t(binv), 0.7, far=100.0),
          rpp.tdao(jd, rhm, jnp.asarray(cam_pos), jnp.asarray(q), FOV, ASPECT,
                   jnp.asarray(bmin), jnp.asarray(binv), 0.7, far=100.0), label="tdao")


def test_sky_and_lens_passes():
    color, depth, cam_pos, q = _scene(2)
    c, d, jc, jd = t(color), t(depth), jnp.asarray(color), jnp.asarray(depth)
    rays = pp.world_rays(t(q), FOV, ASPECT, H, W)
    jrays = rpp.world_rays(jnp.asarray(q), FOV, ASPECT, H, W)
    sun = np.array([0.45, 0.8, 0.35], np.float32)
    close(pp.atmo(c, d, rays, t(sun), 100.0), rpp.atmo(jc, jd, jrays, jnp.asarray(sun), 100.0),
          label="atmo")
    faces = pp.default_cubemap(16)
    np.testing.assert_array_equal(np.asarray(faces), np.asarray(rpp.default_cubemap(16)))
    close(pp.cubemap_sky(c, d, rays, faces, 100.0),
          rpp.cubemap_sky(jc, jd, jrays, jnp.asarray(np.asarray(faces)), 100.0), label="cubemap")
    close(pp.dof(c, d, 12.0, 8.0, far=100.0), rpp.dof(jc, jd, 12.0, 8.0, far=100.0), label="dof")
    hist = np.roll(color, 3, axis=1) * 0.9
    close(pp.taa(c, t(hist), 0.15), rpp.taa(jc, jnp.asarray(hist), 0.15), label="taa")
    close(pp.tonemap_aces(c, 1.3), rpp.tonemap_aces(jc, 1.3), label="tonemap")
    close(pp.fsr_upscale(c, 54, 78, 0.4), rpp.fsr_upscale(jc, 54, 78, 0.4), label="fsr_upscale")


@pytest.mark.parametrize("frame", [0, 1, 37])
def test_film_grain_bit_for_bit(frame):
    color, *_ = _scene(3)
    key = prng.fold_in(prng.PRNGKey(7), frame)
    rkey = jax.random.fold_in(jax.random.PRNGKey(7), frame)
    got = pp.film_grain(t(color), key, 0.06)
    ref = rpp.film_grain(jnp.asarray(color), rkey, 0.06)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_decal_and_light_passes():
    color, depth, cam_pos, q = _scene(4)
    c, d, jc, jd = t(color * 0.5), t(depth), jnp.asarray(color * 0.5), jnp.asarray(depth)
    rng = np.random.default_rng(4)
    dpos = rng.uniform(-4, 4, (5, 3)).astype(np.float32)
    dpos[:, 2] -= 10.0
    drot = rng.normal(size=(5, 4)).astype(np.float32)
    drot /= np.linalg.norm(drot, axis=1, keepdims=True)
    dhe = rng.uniform(1, 6, (5, 3)).astype(np.float32)
    tints = rng.uniform(0, 1, (5, 3)).astype(np.float32)
    cam0, rot0 = np.zeros(3, np.float32), np.array([0, 0, 0, 1], np.float32)
    close(pp.decal_pass(c, d, FOV, ASPECT, t(cam0), t(rot0), t(dpos), t(drot), t(dhe), t(tints)),
          rpp.decal_pass(jc, jd, FOV, ASPECT, jnp.asarray(cam0), jnp.asarray(rot0),
                         *(jnp.asarray(a) for a in (dpos, drot, dhe, tints))), label="decals")
    n_l = 12
    lv = rng.uniform(-6, 6, (n_l, 3)).astype(np.float32)
    lv[:, 2] = -rng.uniform(1, 20, n_l)
    lcol = rng.uniform(0, 1, (n_l, 3)).astype(np.float32)
    lint = rng.uniform(1, 30, n_l).astype(np.float32)
    lrng = rng.uniform(3, 15, n_l).astype(np.float32)
    cl = rng.integers(-1, n_l, (16 * 8 * 24, 8)).astype(np.int32)
    for near, far_c in ((0.3, 500.0), (t(np.float32(0.1)), t(np.float32(100.0)))):
        jn = near if isinstance(near, float) else jnp.asarray(np.asarray(near))
        jf = far_c if isinstance(far_c, float) else jnp.asarray(np.asarray(far_c))
        close(pp.deferred_lights(c, d, FOV, ASPECT, t(lv), t(lcol), t(lint), t(lrng), t(cl),
                                 (16, 8, 24), near=near, far_cluster=far_c),
              rpp.deferred_lights(jc, jd, FOV, ASPECT, *(jnp.asarray(a) for a in
                                                         (lv, lcol, lint, lrng, cl)),
                                  (16, 8, 24), near=jn, far_cluster=jf), label="lights")


# -- FSR3 -----------------------------------------------------------------------


def test_fsr3_passes_match_reference():
    from lumixengine_tpu.renderer import fsr3 as rf
    from lumixengine_tpu_torch.renderer import fsr3 as pf

    for i in range(20):
        np.testing.assert_allclose(np.asarray(pf.jitter(i, 16)),
                                   np.asarray(rf.jitter(jnp.int32(i), 16)), atol=1e-7)
    color, depth, cam_pos, q = _scene(5)
    rng = np.random.default_rng(5)
    motion = rng.uniform(-0.02, 0.02, (H, W, 2)).astype(np.float32)
    dd, dm = pf.reconstruct_dilate(t(depth), t(motion))
    rdd, rdm = rf.reconstruct_dilate(jnp.asarray(depth), jnp.asarray(motion))
    np.testing.assert_array_equal(np.asarray(dd), np.asarray(rdd))
    np.testing.assert_array_equal(np.asarray(dm), np.asarray(rdm))
    prev = np.roll(depth, 2, axis=1) * 1.05
    close(pf.depth_clip(dd, dm, t(prev)), rf.depth_clip(rdd, rdm, jnp.asarray(prev)),
          label="depth_clip")
    np.testing.assert_array_equal(np.asarray(pf.create_locks(t(color))),
                                  np.asarray(rf.create_locks(jnp.asarray(color))))
    jit_px = np.array([0.21, -0.34], np.float32)
    up, conf = pf._upsample_lanczos(t(color), 72, 104, t(jit_px))
    rup, rconf = rf._upsample_lanczos(jnp.asarray(color), 72, 104, jnp.asarray(jit_px))
    close(up, rup, atol=5 * COLOR_ATOL, label="lanczos")
    close(conf, rconf, label="confidence")
    close(pf.rcas(t(color), 0.5), rf.rcas(jnp.asarray(color), 0.5), label="rcas")
    mv = pf.camera_motion_vectors(t(depth), FOV, ASPECT, t(cam_pos), t(q),
                                  t(cam_pos + 0.3), t(q))
    rmv = rf.camera_motion_vectors(jnp.asarray(depth), FOV, ASPECT, jnp.asarray(cam_pos),
                                   jnp.asarray(q), jnp.asarray(cam_pos + 0.3), jnp.asarray(q))
    close(mv, rmv, label="motion vectors")


def test_fsr3_dispatch_sequences_match_reference():
    """tests/test_fsr3.py's accumulation and disocclusion sequences through
    both packages, frame by frame."""
    from lumixengine_tpu.renderer import fsr3 as rf
    from lumixengine_tpu_torch.renderer import fsr3 as pf
    from test_fsr3 import H as OH, W as OW, h, w, _reference_image, _render_lowres

    ref_img = _reference_image()
    depth = np.full((h, w), 5.0, np.float32)
    motion = np.zeros((h, w, 2), np.float32)
    rs, ps = rf.init_state(h, w, OH, OW), pf.init_state(h, w, OH, OW)
    phase = int(8 * (OH / h) ** 2)
    errs = []
    for i in range(8):
        color = np.asarray(_render_lowres(ref_img, rf.jitter(rs.frame, phase)))
        rout, rs = rf.dispatch(rs, jnp.asarray(color), jnp.asarray(depth),
                               jnp.asarray(motion), OH, OW, 0.0)
        pout, ps = pf.dispatch(ps, t(color), t(depth), t(motion), OH, OW, 0.0)
        errs.append(close(pout, rout, atol=5 * COLOR_ATOL, label=f"frame {i}"))
        close(ps.lock, rs.lock, atol=1e-4)
    assert int(ps.frame) == 8
    # disocclusion: a near surface over half the view
    depth_b = depth.copy()
    depth_b[:, : w // 2] = 2.0
    green = np.broadcast_to(np.array([0.0, 1.0, 0.0], np.float32), (h, w, 3)).copy()
    rout, rs = rf.dispatch(rs, jnp.asarray(green), jnp.asarray(depth_b), jnp.asarray(motion),
                           OH, OW, 0.0)
    pout, ps = pf.dispatch(ps, t(green), t(depth_b), t(motion), OH, OW, 0.0)
    close(pout, rout, atol=5 * COLOR_ATOL, label="disoccluded")
    assert np.asarray(pout)[:, : OW // 2 - 4, 1].mean() > 0.95


# -- the software present ---------------------------------------------------------


def _soft_pair(num_entities=96, frames=2, plugins=True):
    def build(root):
        engine, world, renderer = _pkg(root, "models.demo_scenes").headless_demo_world(
            num_entities=num_entities)
        if plugins:
            _pkg(root, "renderer.plugins").install_builtins(renderer)
        return engine, world, renderer
    return run_pair(build, frames=frames)


def _soft_close(img, ref, label):
    diff = np.abs(np.asarray(img).astype(np.int32) - np.asarray(ref).astype(np.int32))
    print(label, "max u8 diff", int(diff.max()), "pixels over 0:", int((diff.max(-1) > 0).sum()))
    assert img.shape == ref.shape and diff.max() <= SOFT_LEVELS, (label, int(diff.max()))


def test_software_present_full_stream_with_builtin_plugins(tmp_path):
    """headless_demo_world(96) with the builtin plugins, 2 frames, two
    presents (the second with TAA history): each u8 image within
    SOFT_LEVELS of the JAX backend's; the PNG decodes to the image."""
    from lumixengine_tpu.renderer import gpu_soft as rgs
    from lumixengine_tpu_torch.renderer import gpu_soft as pgs
    from lumixengine_tpu_torch.renderer.texture import decode_png

    rrunner, prunner, *_ = _soft_pair()
    img, be = pgs.render_frame(prunner, str(tmp_path / "f.png"), width=160, height=90,
                               max_instances=128)
    ref, rbe = rgs.render_frame(rrunner, None, width=160, height=90, max_instances=128)
    _soft_close(img, ref, "frame 1")
    assert be.draw_calls == rbe.draw_calls >= 2 and img.std() > 4.0
    np.testing.assert_array_equal(decode_png((tmp_path / "f.png").read_bytes())[..., :3], img)
    rrunner.run(1)
    sync(rrunner, prunner)
    img2, be2 = pgs.render_frame(prunner, None, width=160, height=90, backend=be,
                                 max_instances=128)
    ref2, _ = rgs.render_frame(rrunner, None, width=160, height=90, backend=rbe,
                               max_instances=128)
    _soft_close(img2, ref2, "frame 2 (TAA)")
    assert be2.history is not None


@pytest.mark.parametrize("which", [("CubemapSkyPlugin",), ("FSR3Plugin", "SSSPlugin")])
def test_software_present_other_plugins(which):
    def build(root):
        engine, world, renderer = _pkg(root, "models.demo_scenes").headless_demo_world(
            num_entities=64)
        mod = _pkg(root, "renderer.plugins")
        mod.install_builtins(renderer, [getattr(mod, n) for n in which])
        return engine, world, renderer

    rrunner, prunner, *_ = run_pair(build, frames=1)
    img = prunner.present(width=120, height=68)
    ref = rrunner.present(width=120, height=68)
    _soft_close(img, ref, str(which))
    if "FSR3Plugin" in which:
        assert img.shape == (102, 180, 3)


def _component_scene(root):
    """Terrain with grass, a decal and a curve decal on a wall, procedural
    geometry and a point light."""
    engine, renderer = _pkg(root, "models.demo_scenes").build_engine(model_instances=16)
    rng = np.random.default_rng(0)
    tid = renderer.terrains.add(rng.uniform(0, 1, (65, 65)), xz_scale=1.0, y_scale=6.0,
                                grass_types=[{"density": 1.0, "height": 1.5}])
    world = engine.create_world(capacity=16)
    cam = world.create_entity(position=(0.0, 5.0, 40.0), name="camera")
    world.create_component(cam, "camera", fov=np.radians(70.0), near=0.3, far=500.0)
    t_ = world.create_entity(position=(-32.0, -4.0, -20.0), name="terrain")
    world.create_component(t_, "terrain", terrain=tid)
    wall = world.create_entity(position=(0.0, 6.0, 10.0), scale=(4.0,) * 3)
    world.create_component(wall, "model_instance", model="cube")
    dec = world.create_entity(position=(0.0, 6.0, 12.5))
    world.create_component(dec, "decal", material=3, half_extents=(1.0, 1.0, 2.0))
    cd = world.create_entity(position=(0.0, 6.0, 12.5))
    world.create_component(cd, "curve_decal", material=6, half_extents=(0.6, 1.0, 0.6),
                           bezier_p0=(-2.0, 0.0), bezier_p2=(2.0, 0.0))
    pg = world.create_entity(position=(8.0, 6.0, 10.0))
    world.create_component(pg, "procedural_geometry", vertices=np.array(
        [[-3, -3, 0], [3, -3, 0], [0, 3, 0]], np.float32))
    lamp = world.create_entity(position=(0.0, 6.0, 14.0))
    world.create_component(lamp, "point_light", color=(1.0, 0.2, 0.2), intensity=50.0,
                           range=15.0)
    return engine, world, (t_, dec, cd, pg, lamp)


def test_software_present_draws_the_components():
    """Terrain, grass, decals, procedural geometry and the clustered light
    through the recorded stream, against the JAX backend; the stream's
    commands equal the reference's."""
    from lumixengine_tpu.renderer import draw_stream as rds
    from lumixengine_tpu_torch.renderer import draw_stream as pds

    rrunner, prunner, _rh, (t_, dec, cd, pg, lamp) = run_pair(_component_scene)
    rs_ = rds.record_frame(rrunner.prepare_view(), rrunner.state.modules["renderer"],
                           rrunner.world.modules["renderer"])
    ps_ = pds.record_frame(prunner.prepare_view(), prunner.state.modules["renderer"],
                           prunner.world.modules["renderer"])
    strip = [(c.op, {k: v for k, v in c.args.items() if k in ("shader", "source", "entity",
                                                                  "terrain", "name")})
             for c in rs_.commands]
    assert [(c.op, {k: v for k, v in c.args.items() if k in ("shader", "source", "entity",
                                                             "terrain", "name")})
            for c in ps_.commands] == strip
    assert ("draw_terrain", {"entity": t_, "terrain": 0}) in strip
    assert ("dispatch", {"shader": "decals"}) in strip
    img = prunner.present(width=160, height=90)
    ref = rrunner.present(width=160, height=90)
    _soft_close(img, ref, "components")
    for runner in (rrunner, prunner):
        for e, ctype in ((dec, "decal"), (cd, "curve_decal"), (lamp, "point_light")):
            runner.world.destroy_component(e, ctype)
    rrunner.state = rrunner.world.device_state()
    sync(rrunner, prunner)
    bare = prunner.present(width=160, height=90)
    _soft_close(bare, rrunner.present(width=160, height=90), "no decals, no light")
    assert np.abs(img.astype(int) - bare.astype(int)).max() > 20


def test_nav_debug_overlay():
    from lumixengine_tpu.renderer import gpu_soft as rgs
    from lumixengine_tpu_torch.renderer import gpu_soft as pgs

    def build(root):
        engine = _pkg(root, "app").create_full_engine(
            model_instances=8, **({"device": "cpu"} if root.endswith("torch") else {}))
        world = engine.create_world(capacity=8)
        cam = world.create_entity(position=(16.0, 2.0, 44.0), name="camera")
        world.create_component(cam, "camera", fov=np.radians(70.0))
        e = world.create_entity()
        world.create_component(e, "nav_zone", origin=(0.0, 0.0), size=(32.0, 32.0), cell=1.0)
        world.modules["navigation"].zone.block_aabb(10.0, 10.0, 20.0, 20.0)
        return engine, world, None

    rrunner, prunner, *_ = run_pair(build)
    img, _ = pgs.render_frame(prunner, None, width=160, height=90, max_instances=8,
                              debug_nav=True)
    ref, _ = rgs.render_frame(rrunner, None, width=160, height=90, max_instances=8,
                              debug_nav=True)
    _soft_close(img, ref, "nav debug")
    orange = ((np.abs(img[..., 0].astype(int) - 230) < 30)
              & (np.abs(img[..., 1].astype(int) - 140) < 40)).sum()
    assert orange > 20


def test_host_dqs_matches_reference():
    from lumixengine_tpu.renderer.gpu_soft import skin_points_dq_np as rdq
    from lumixengine_tpu_torch.core import host_math as hm
    from lumixengine_tpu_torch.renderer.gpu_soft import skin_points_dq_np as pdq

    rng = np.random.default_rng(5)
    B, V = 6, 40
    real = rng.normal(size=(B, 4))
    real /= np.linalg.norm(real, axis=-1, keepdims=True)
    tq = np.concatenate([rng.uniform(-2, 2, (B, 3)), np.zeros((B, 1))], -1)
    pal = np.concatenate([real, 0.5 * hm.quat_mul(tq, real)], -1).T.astype(np.float32)
    bones4 = rng.integers(0, B, (V, 4)).astype(np.int32)
    wts = rng.uniform(0, 1, (V, 4)).astype(np.float32)
    wts /= wts.sum(-1, keepdims=True)
    pts = rng.uniform(-1, 1, (V, 3)).astype(np.float32)
    np.testing.assert_array_equal(pdq(pal, pts, bones4, wts), rdq(pal, pts, bones4, wts))


# -- textures, materials, terrain, components -------------------------------------


def _tga(data, rle=False, top_down=True):
    import struct

    h, w, _ = data.shape
    bgra = data[..., [2, 1, 0, 3]]
    if rle:
        body = b"".join(bytes([0x80 | 0]) + px.tobytes() for px in bgra.reshape(-1, 4))
    else:
        body = (bgra if top_down else bgra[::-1]).tobytes()
    hdr = struct.pack("<BBBHHBHHHHBB", 0, 0, 10 if rle else 2, 0, 0, 0, 0, 0, w, h, 32,
                      0x20 if (top_down or rle) else 0)
    return hdr + body


def test_texture_loaders_and_sampler():
    from lumixengine_tpu.renderer import texture as rt
    from lumixengine_tpu_torch.renderer import texture as pt

    rng = np.random.default_rng(6)
    data = rng.integers(0, 256, (5, 7, 4)).astype(np.uint8)
    for blob in (_tga(data), _tga(data, rle=True), _tga(data, top_down=False)):
        np.testing.assert_array_equal(pt.load_tga(blob).data, rt.load_tga(blob).data)
    raw = rng.integers(0, 65535, 64, dtype=np.uint16).tobytes()
    np.testing.assert_array_equal(pt.load_raw(raw).data, rt.load_raw(raw).data)
    for m1, m2 in zip(pt.build_mips(data), rt.build_mips(data)):
        np.testing.assert_array_equal(m1, m2)
    rgb = data[..., :3].copy()
    png = pt.encode_png(rgb)
    np.testing.assert_array_equal(pt.load_texture("x.png", png).data[..., :3], rgb)
    u = rng.uniform(-0.5, 1.5, (30,)).astype(np.float32)
    v = rng.uniform(-0.5, 1.5, (30,)).astype(np.float32)
    for wrap in ("repeat", "clamp"):
        close(pt.sample_bilinear(t(data), t(u), t(v), wrap),
              rt.sample_bilinear(jnp.asarray(data), jnp.asarray(u), jnp.asarray(v), wrap),
              atol=1e-3, label=wrap)


def _png(w, h, depth, ctype, samples, extra=b"", interlace=False):
    """A PNG of `samples` [h, w, ch] (uint16 at depth 16) with filter 0
    lines, Adam7-interlaced when asked; `extra` chunks go before IDAT."""
    import struct
    import zlib

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    def lines(px):
        out = b""
        for row in px:
            if depth == 16:
                out += b"\0" + row.astype(">u2").tobytes()
            elif depth == 8:
                out += b"\0" + row.astype(np.uint8).tobytes()
            else:
                bits = ((row.reshape(-1, 1) >> np.arange(depth - 1, -1, -1)) & 1).astype(np.uint8)
                out += b"\0" + np.packbits(bits.reshape(-1)).tobytes()
        return out

    if interlace:
        from lumixengine_tpu_torch.renderer.texture import _ADAM7
        raw = b"".join(lines(samples[r0::dr, c0::dc]) for r0, c0, dr, dc in _ADAM7
                       if samples[r0::dr, c0::dc].size)
    else:
        raw = lines(samples)
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
            + extra + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


_PNG_FORMS = [("gray16", 16, 0), ("gray_alpha16", 16, 4), ("rgb16", 16, 2), ("rgba16", 16, 6),
              ("palette1", 1, 3), ("palette2", 2, 3), ("palette4", 4, 3), ("palette8", 8, 3),
              ("gray1", 1, 0), ("gray2", 2, 0), ("gray4", 4, 0), ("gray8_trns", 8, 0),
              ("rgb8_trns", 8, 2), ("rgb16_trns", 16, 2), ("rgba8_interlaced", 8, 6),
              ("palette4_interlaced", 4, 3), ("gray16_interlaced", 16, 0)]


@pytest.mark.parametrize("form,depth,ctype", _PNG_FORMS, ids=[f[0] for f in _PNG_FORMS])
def test_png_forms_equal_pil(form, depth, ctype):
    """The stdlib PNG decoder against the reference's loader (PIL's
    Image.open(...).convert("RGBA")) array for array: palettes with tRNS
    alpha, every gray depth, 16-bit samples above 255 in each colour type,
    tRNS keys, Adam7 interlacing; a 13x7 image, odd so that lines end
    inside a byte."""
    import struct

    from lumixengine_tpu.renderer import texture as rt
    from lumixengine_tpu_torch.renderer import texture as pt

    rng = np.random.default_rng(depth * 10 + ctype)
    w, h = 13, 7
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    top = (1 << depth) if ctype != 3 else min(1 << depth, 12)
    samples = rng.integers(0, top, (h, w, ch)).astype(np.uint16 if depth == 16 else np.uint8)
    extra = b""
    if depth == 16:
        samples[0, :4] = np.array([0x1234, 0x00FF, 0x0010, 0xABCD])[:, None]
        assert (samples > 255).any()
    if ctype == 3:
        pal = rng.integers(0, 256, (12, 3)).astype(np.uint8).tobytes()
        extra = _chunk(b"PLTE", pal) + _chunk(b"tRNS", bytes([0, 90, 200, 17]))
    if form.endswith("_trns"):
        key = samples[1, 2].copy()
        if depth == 16:      # PIL holds the 16-bit key to the pixels' high bytes
            key = key >> 8
            samples[2, 3] = key << 8
        extra = _chunk(b"tRNS", struct.pack(">" + "H" * ch, *(int(v) for v in key)))
    blob = _png(w, h, depth, ctype, samples, extra, interlace=form.endswith("_interlaced"))
    ref = rt.load_image(blob).data
    got = pt.load_texture("x.png", blob).data
    assert got.dtype == np.uint8 and got.shape == (h, w, 4)
    np.testing.assert_array_equal(got, ref)


def _chunk(kind, body):
    import struct
    import zlib

    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def test_material_bank_and_textured_triangle_colors():
    from lumixengine_tpu.renderer import raster as rr
    from lumixengine_tpu_torch.renderer import raster as pr

    def textured(root):
        mat = _pkg(root, "renderer.material")
        rsys = _pkg(root, "renderer.render_module").RendererSystem(
            _pkg(root, "engine.engine").Engine())
        data = np.zeros((8, 8, 3), np.uint8)
        data[:, :4], data[:, 4:] = (255, 0, 0), (0, 0, 255)
        rsys.materials.add_texture(mat.Texture("halves.tga", data))
        m = rsys.materials.add(mat.Material("halves", uniforms={"color_r": 0.5, "color_g": 1.0,
                                                                  "color_b": 1.0},
                                            textures={"slot0": "halves.tga"}))
        from test_textured_raster import _two_quad_model

        v, uv, tri = _two_quad_model()
        mid = rsys.add_model(_pkg(root, "renderer.model").Model(
            name="quads", bounding_radius=3.0, vertex_positions=v, vertex_uvs=uv,
            vertex_triangles=tri, material_id=m))
        return rsys, mid

    (rsys, rmid), (psys, pmid) = textured("lumixengine_tpu"), textured("lumixengine_tpu_torch")
    got = pr.model_triangle_colors(pmid, psys.models, psys.materials)
    np.testing.assert_array_equal(got, rr.model_triangle_colors(rmid, rsys.models, rsys.materials))
    np.testing.assert_allclose(got[0], [127.5, 0, 0])
    bank = psys.materials.bank("cpu")
    rbank = rsys.materials.bank
    for f in ("uniforms", "layer_id", "alpha"):
        np.testing.assert_array_equal(getattr(bank, f).numpy(), np.asarray(getattr(rbank, f)))


def test_both_presents_show_the_texture():
    """tests/test_textured_raster.py's scene through both port presents,
    each against the JAX package's."""
    from test_torch_present import assert_present_close

    def build(root):
        mat = _pkg(root, "renderer.material")
        engine = _pkg(root, "engine.engine").Engine()
        rsys = _pkg(root, "renderer.render_module").RendererSystem(engine)
        data = np.zeros((8, 8, 3), np.uint8)
        data[:, :4], data[:, 4:] = (255, 0, 0), (0, 0, 255)
        rsys.materials.add_texture(mat.Texture("halves.tga", data))
        m = rsys.materials.add(mat.Material("halves", uniforms={"color_r": 1.0, "color_g": 1.0,
                                                                  "color_b": 1.0},
                                            textures={"slot0": "halves.tga"}))
        from test_textured_raster import _two_quad_model

        v, uv, tri = _two_quad_model()
        mid = rsys.add_model(_pkg(root, "renderer.model").Model(
            name="quads", bounding_radius=3.0, vertex_positions=v, vertex_uvs=uv,
            vertex_triangles=tri, material_id=m))
        engine.add_system(rsys)
        world = engine.create_world(capacity=8)
        cam = world.create_entity(position=(0.0, 0.0, 5.0))
        world.create_component(cam, "camera", fov=np.pi / 3, near=0.1, far=50.0)
        e = world.create_entity()
        world.create_component(e, "model_instance", model=mid)
        return engine, world, rsys

    from lumixengine_tpu.renderer import gpu_tpu as rg
    from lumixengine_tpu_torch.renderer import gpu_tpu as pg

    rrunner, prunner, *_ = run_pair(build)
    host = prunner.present(width=96, height=64)
    _soft_close(host, rrunner.present(width=96, height=64), "textured host")
    got = pg.TpuPresent(96, 64, lights=False)(prunner)
    assert_present_close(got, rg.TpuPresent(96, 64, lights=False)(rrunner), "textured device")
    for img in (host, np.asarray(got[0])):
        w = img.shape[1]
        left = img[:, : w // 2].reshape(-1, 3).astype(np.float32)
        right = img[:, w // 2:].reshape(-1, 3).astype(np.float32)
        red = (left[:, 0] > 2 * left[:, 1] + 20) & (left[:, 0] > 2 * left[:, 2] + 20)
        blue = (right[:, 2] > 2 * right[:, 1] + 20) & (right[:, 2] > 2 * right[:, 0] + 20)
        assert red.sum() > 20 and blue.sum() > 20


@pytest.mark.parametrize("density,slope", [(0.2, 0.7), (2.0, 0.95)])
def test_scatter_grass_bit_for_bit(density, slope):
    from lumixengine_tpu.renderer import terrain as rt
    from lumixengine_tpu_torch.renderer import terrain as pt

    rng = np.random.default_rng(7)
    hmap = rng.uniform(0, 3, (33, 41)).astype(np.float32)
    rreg, preg = rt.TerrainRegistry(), pt.TerrainRegistry()
    for reg in (rreg, preg):
        reg.add(np.zeros((8, 8), np.float32))
        reg.add(hmap, xz_scale=0.5, y_scale=2.0)
    ext = (41 * 0.5, 33 * 0.5)
    for gi in range(3):
        got = pt.scatter_grass(preg.bank("cpu"), 1, density, ext, prng.PRNGKey(17 + gi),
                               max_instances=512, max_slope_y=slope)
        ref = rt.scatter_grass(rreg.bank, 1, density, ext, jax.random.PRNGKey(17 + gi),
                               max_instances=512, max_slope_y=slope)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    keys = prng.split(prng.PRNGKey(3), 5)
    np.testing.assert_array_equal(keys.numpy(), np.asarray(
        jax.random.key_data(jax.random.split(jax.random.PRNGKey(3), 5))).astype(np.int64))
    d2 = rng.uniform(0, 1e4, (2, 50)).astype(np.float32)
    lods = np.array([10.0, 1000.0, 5000.0], np.float32)
    np.testing.assert_array_equal(pt.terrain_lod_levels(t(d2), lods).numpy(),
                                  np.asarray(rt.terrain_lod_levels(jnp.asarray(d2), lods)))
    assert preg.get(1) is preg.terrains[1]


GLOBAL_SCRIPT = """
global push : float3
emitter puff {
    emit_per_second 600
    max_particles 64
    out i_position : float3
    var pos : float3
    fn emit() { pos = entity_position; }
    fn update() { pos = pos + push * time_delta; }
    fn output() { i_position = pos; }
}
"""


def _components_world(root):
    engine, renderer = _pkg(root, "models.demo_scenes").build_engine(model_instances=8)
    renderer.add_particle_script("puff", GLOBAL_SCRIPT)
    tid = renderer.terrains.add(np.zeros((16, 16), np.float32))
    world = engine.create_world(capacity=16)
    cam = world.create_entity(position=(0.0, 2.0, 10.0))
    world.create_component(cam, "camera")
    ents = {}
    for ctype, props in (("terrain", {"terrain": tid}),
                         ("decal", {"material": 2, "half_extents": (1.0, 2.0, 3.0)}),
                         ("curve_decal", {"bezier_p0": (-1.0, 0.5), "bezier_p2": (2.0, 1.0)}),
                         ("procedural_geometry", {"vertices": np.eye(3, dtype=np.float32)}),
                         ("reflection_probe", {"size": 32}),
                         ("environment_probe", {"inner": (1.0, 2.0, 3.0)}),
                         ("particle_emitter", {"script": "puff", "capacities": {"puff": 16}})):
        e = world.create_entity(position=(float(len(ents)), 0.0, 0.0))
        world.create_component(e, ctype, **props)
        ents[ctype] = e
    return engine, world, ents


def test_render_components_create_and_destroy():
    """The six components the port used to refuse, created and destroyed in
    both packages with equal stores; the emitter's capacities override; a
    script global set by set_particle_global moves the particles as in the
    JAX package."""
    rrunner, prunner, rents, pents = run_pair(_components_world, frames=1)
    rm, pm = rrunner.world.modules["renderer"], prunner.world.modules["renderer"]
    for store in ("terrains", "decals", "curve_decals", "reflection_probes",
                  "environment_probes"):
        rs_, ps_ = getattr(rm, store), getattr(pm, store)
        np.testing.assert_array_equal(ps_.entity, rs_.entity)
        for f in rs_.data:
            np.testing.assert_array_equal(ps_.data[f], rs_.data[f], err_msg=f"{store}.{f}")
    e = pents["procedural_geometry"]
    np.testing.assert_array_equal(pm.procedural_geometries[e]["vertices"],
                                  rm.procedural_geometries[e]["vertices"])
    key = f"pe{pents['particle_emitter']}"
    assert pm.particle_emitters[key][1].caps == rm.particle_emitters[key][1].caps == {"puff": 16}
    assert prunner.state.modules["renderer"].particles[key]["puff"].alive.shape[-1] == 16
    # a global, then frames in both packages (the JAX step reads globals at
    # its build, so both restart)
    for runner, ents in ((rrunner, rents), (prunner, pents)):
        runner.world.modules["renderer"].set_particle_global(ents["particle_emitter"], "push",
                                                             [0.0, 3.0, 0.0])
    rrunner.start()
    rrunner.run(3)
    prunner.start()
    sync(rrunner, prunner)
    for runner in (rrunner, prunner):
        runner.run(4)
    got = bridge.state_to_numpy(prunner.state)
    ref = ref_to_numpy(rrunner.state)
    name = f"modules.renderer.particles.{key}.puff.channels"
    close(got[name], ref[name], atol=1e-5, label="particles under a global")
    assert np.abs(got[name]).max() > 0.1
    for ctype in pents:
        prunner.world.destroy_component(pents[ctype], ctype)
        rrunner.world.destroy_component(rents[ctype], ctype)
    assert not pm.procedural_geometries and not pm.particle_emitters
    for store in ("terrains", "decals", "curve_decals", "reflection_probes",
                  "environment_probes"):
        assert len(getattr(pm, store)) == len(getattr(rm, store)) == 0


def test_probes_voxels_and_viewer_equal_reference(tmp_path):
    from lumixengine_tpu.renderer import probes as rprobes, viewer as rviewer, voxels as rvox
    from lumixengine_tpu_torch.renderer import probes as pprobes, viewer as pviewer, \
        voxels as pvox

    def build(root):
        engine, renderer = _pkg(root, "models.demo_scenes").build_engine(model_instances=16)
        world = engine.create_world(capacity=16)
        cam = world.create_entity(position=(0.0, 0.0, 30.0), name="camera")
        world.create_component(cam, "camera")
        cube = world.create_entity(position=(2.0, 0.0, 0.0), scale=(2.0,) * 3)
        world.create_component(cube, "model_instance", model="cube")
        rock = world.create_entity(position=(-1.0, 3.0, -2.0))
        world.create_component(rock, "model_instance", model="rock")
        pe = world.create_entity(position=(0.0, 0.0, 0.0))
        world.create_component(pe, "environment_probe")
        rp = world.create_entity(position=(0.0, 1.0, 4.0))
        world.create_component(rp, "reflection_probe", size=16)
        return engine, world, renderer

    rrunner, prunner, *_ = run_pair(build)
    faces = pprobes.bake_probe(prunner, (0.0, 0.0, 0.0), size=32, max_instances=16)
    rfaces = rprobes.bake_probe(rrunner, (0.0, 0.0, 0.0), size=32, max_instances=16)
    np.testing.assert_array_equal(faces, rfaces)
    baked = pprobes.bake_all_probes(prunner, size=16)
    rbaked = rprobes.bake_all_probes(rrunner, size=16)
    assert sorted(baked) == sorted(rbaked) and len(baked) == 2
    for e in baked:
        np.testing.assert_array_equal(baked[e], rbaked[e])
    rays = np.broadcast_to(np.array([1.0, 0.0, 0.0], np.float32), (8, 8, 3)).copy()
    close(pp.cubemap_sky(torch.zeros(8, 8, 3), torch.full((8, 8), float("inf")), t(rays),
                         t(faces), 100.0)[4, 4], faces[0, 16, 16], atol=0.05)
    rng = np.random.default_rng(8)
    verts = rng.uniform(-1, 1, (30, 3)).astype(np.float32)
    idx = rng.integers(0, 30, (20, 3))
    g, mn, cell = pvox.voxelize_triangles(verts, idx, resolution=16)
    rg_, rmn, rcell = rvox.voxelize_triangles(verts, idx, resolution=16)
    np.testing.assert_array_equal(g, rg_)
    np.testing.assert_array_equal(pvox.occupancy_ao(g, 2), rvox.occupancy_ao(rg_, 2))
    p = pviewer.render_svg(prunner, str(tmp_path / "p.svg"))
    r = rviewer.render_svg(rrunner, str(tmp_path / "r.svg"))
    assert open(p).read() == open(r).read()
