"""The on-device present (renderer/gpu_tpu.py) in the port against the JAX
package on the CPU: the same world built in both packages, the JAX package
stepped, its state carried into the port (bridge.state_from_numpy), and both
presents run on that one state.

Limits (assert_present_close): overflow equal; the hit masks equal on at least
99.9% of the pixels; depth within 1e-5 relative where both hit; rgb within
1 level on at least 99.9% of the pixels. Each case of tests/test_gpu_tpu.py
that needs no reference demo asset is mirrored with its own assertions on
the port's image."""
import importlib

import numpy as np
import pytest
import torch

from lumixengine_tpu_torch import bridge
from lumixengine_tpu_torch.renderer import gpu_tpu as P
from test_torch_bridge import ref_to_numpy

torch.set_num_threads(2)

COVERAGE_MIN = 0.999      # share of pixels whose hit mask agrees
DEPTH_RTOL = 1e-5         # where both hit
RGB_LEVELS = 1            # u8 levels, on at least RGB_SHARE of the pixels
RGB_SHARE = 0.999


def _pkg(root, name):
    return importlib.import_module(f"{root}.{name}")


def assert_present_close(got, ref, label=""):
    """got, ref: (rgb u8 [H, W, 3], depth f32 [H, W], overflow). Returns the
    measured figures."""
    rgb, depth, ov = (np.asarray(x) for x in got)
    rrgb, rdepth, rov = (np.asarray(x) for x in ref)
    assert rgb.shape == rrgb.shape and rgb.dtype == np.uint8
    assert int(ov) == int(rov), (label, int(ov), int(rov))
    hit, rhit = np.isfinite(depth), np.isfinite(rdepth)
    coverage = float((hit == rhit).mean())
    both = hit & rhit
    rel = float((np.abs(depth[both] - rdepth[both]) / rdepth[both]).max()) if both.any() else 0.0
    diff = np.abs(rgb.astype(np.int32) - rrgb.astype(np.int32)).max(axis=-1)
    rgb_share = float((diff <= RGB_LEVELS).mean())
    figures = {"coverage": coverage, "depth_rel": rel, "rgb_share": rgb_share,
               "rgb_max": int(diff.max()), "overflow": int(ov)}
    print(label, figures)
    assert coverage >= COVERAGE_MIN, (label, figures)
    assert rel <= DEPTH_RTOL, (label, figures)
    assert rgb_share >= RGB_SHARE, (label, figures)
    return figures


def run_pair(build, frames=1):
    """build(root) → (engine, world, handles) for each package; the JAX
    runner runs `frames` frames and the port's runner takes its state."""
    rengine, rworld, rh = build("lumixengine_tpu")
    rrunner = _pkg("lumixengine_tpu", "app").Runner([], engine=rengine)
    rrunner.use_world(rworld)
    rrunner.start()
    rrunner.run(frames)
    pengine, pworld, ph = build("lumixengine_tpu_torch")
    pengine.device = torch.device("cpu")
    prunner = _pkg("lumixengine_tpu_torch", "app").Runner([], engine=pengine)
    prunner.use_world(pworld)
    prunner.start()
    sync(rrunner, prunner)
    return rrunner, prunner, rh, ph


def sync(rrunner, prunner):
    prunner.state = bridge.state_from_numpy(ref_to_numpy(rrunner.state), "cpu")


def presents(rrunner, prunner, width, height, **kw):
    ref = _pkg("lumixengine_tpu", "renderer.gpu_tpu").TpuPresent(width, height, **kw)(rrunner)
    got = P.TpuPresent(width, height, **kw)(prunner)
    return tuple(np.asarray(x) for x in got), tuple(np.asarray(x) for x in ref)


def demo(num_entities):
    def build(root):
        return _pkg(root, "models.demo_scenes").headless_demo_world(num_entities=num_entities)
    return build


# -- the soup and the raster --------------------------------------------------


def _soup_of(soup, cls):
    return cls(**{f: getattr(soup, f) for f in cls._fields})


@pytest.mark.parametrize("num_entities", [128, 512])
def test_bake_soup_equal(num_entities):
    rg = _pkg("lumixengine_tpu", "renderer.gpu_tpu")
    (_re, rworld, rr), (_pe, pworld, pr) = demo(num_entities)("lumixengine_tpu"), \
        demo(num_entities)("lumixengine_tpu_torch")
    ref = rg.bake_soup(rworld.modules["renderer"].statics(), rr.models, materials=rr.materials)
    got = P.bake_soup(pworld.modules["renderer"].statics(), pr.models, materials=pr.materials)
    for f in P.SoupStatics._fields:
        a, b = getattr(got, f), getattr(ref, f)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def _random_inputs(soup, seed, spread=12.0):
    """Instance transforms, visibility and a camera from a seeded numpy
    generator."""
    rng = np.random.default_rng(seed)
    n = soup.num_instances
    pos = rng.uniform(-spread, spread, (3, n)).astype(np.float32)
    pos[2] -= 2.0 * spread
    q = rng.normal(size=(4, n)).astype(np.float32)
    q /= np.linalg.norm(q, axis=0, keepdims=True)
    scale = rng.uniform(0.5, 3.0, (3, n)).astype(np.float32)
    visible = rng.uniform(size=n) < 0.9
    return pos, q, scale, visible, np.zeros(3, np.float32), \
        np.array([0, 0, 0, 1], np.float32), np.float32(1.1)


@pytest.mark.parametrize("seed,k_slots", [(0, 192), (1, 8)])
def test_make_raster_matches_reference(seed, k_slots):
    """One baked soup, the same inputs: the port's raster against the JAX
    package's (k_slots=8 makes tiles overflow: the certificate must agree)."""
    import jax.numpy as jnp

    rg = _pkg("lumixengine_tpu", "renderer.gpu_tpu")
    _re, rworld, rr = demo(256)("lumixengine_tpu")
    soup = rg.bake_soup(rworld.modules["renderer"].statics(), rr.models, materials=rr.materials)
    args = _random_inputs(soup, seed)
    ref = rg.make_raster(soup, 240, 136, k_slots=k_slots)(*(jnp.asarray(a) for a in args))
    got = P.make_raster(_soup_of(soup, P.SoupStatics), 240, 136, k_slots=k_slots,
                        device="cpu")(*(torch.as_tensor(a) for a in args))
    fig = assert_present_close(got, ref, f"seed {seed}")
    assert k_slots > 8 or fig["overflow"] > 0


def _tied_soup():
    """Six coincident screen-filling quads (two triangles each) at 5 m,
    each triangle its own colour: every triangle is large, the six first
    halves tie in area, and so do the six second halves."""
    corners = [[-37.3, -41.1, -5.0], [43.9, -39.7, -5.0], [41.3, 44.2, -5.0],
               [-38.8, 40.6, -5.0]]
    v = np.asarray(corners * 6, np.float32)
    t = np.asarray([[4 * i, 4 * i + 1, 4 * i + 2] if h == 0 else [4 * i, 4 * i + 2, 4 * i + 3]
                    for i in range(6) for h in range(2)], np.int32)
    e = len(t)
    return dict(vpos=v, vinst=np.zeros(len(v), np.int32), tri=t, tinst=np.zeros(e, np.int32),
                tcolor=np.tile(np.arange(1, e + 1, dtype=np.float32)[:, None] * 20.0, (1, 3)),
                num_instances=1, vbone4=np.zeros((len(v), 4), np.int32),
                vweight=np.zeros((len(v), 4), np.float32),
                vskin_col=np.full(len(v), -1, np.int32))


@pytest.mark.parametrize("large_cap", [3, 6, 7, 12])
def test_top_large_ties_in_index_order(large_cap):
    """Equal areas: the top-L keeps the lowest indices, in index order
    (lax.top_k's), so the first of the coincident triangles wins each
    half; under 7 no second half is kept and that half stays background.
    The image and the dropped count equal the JAX package's."""
    import jax.numpy as jnp

    rg = _pkg("lumixengine_tpu", "renderer.gpu_tpu")
    d = _tied_soup()
    args = (np.zeros((3, 1), np.float32), np.array([[0], [0], [0], [1]], np.float32),
            np.ones((3, 1), np.float32), np.ones(1, bool), np.zeros(3, np.float32),
            np.array([0, 0, 0, 1], np.float32), np.float32(1.1))
    ref = rg.make_raster(rg.SoupStatics(**d), 256, 256, large_cap=large_cap)(
        *(jnp.asarray(a) for a in args))
    got = P.make_raster(P.SoupStatics(**d), 256, 256, large_cap=large_cap, device="cpu")(
        *(torch.as_tensor(a) for a in args))
    assert_present_close(got, ref, f"L={large_cap}")
    assert int(got[2]) == 12 - large_cap
    rgb, depth = np.asarray(got[0])[..., 0], np.asarray(got[1])
    hit = np.isfinite(depth)
    # the larger halves are the even triangles: triangle 0 (colour 20) wins
    # its half; triangle 1 (colour 40) the other once it is kept
    colours = set(np.unique(rgb[hit]).tolist())
    assert hit.mean() > (0.99 if large_cap >= 7 else 0.3)
    assert (hit.mean() < 0.7) == (large_cap < 7)
    assert len(colours) == (2 if large_cap >= 7 else 1), colours


def test_int32_key_cap_raises():
    soup = P.SoupStatics(**_tied_soup())
    with pytest.raises(ValueError, match="8191 tiles"):
        P.make_raster(soup, 4096, 2048, device="cpu")


# -- TpuPresent on the demo world and the reference tests' scenes -------------


def test_tpu_present_demo_world():
    """headless_demo_world(128) after 2 frames at 240 x 136, with its 8
    point lights: the port's present against the JAX package's."""
    rrunner, prunner, *_ = run_pair(demo(128), frames=2)
    got, ref = presents(rrunner, prunner, 240, 136)
    assert_present_close(got, ref, "demo 128")
    rgb, depth, ov = got
    assert ov == 0 and (depth < np.inf).mean() > 0.01


def test_tpu_present_demo_world_large():
    """headless_demo_world(512), 320 x 180 (the main path's scene at a
    tenth of its entities): the same limits."""
    rrunner, prunner, *_ = run_pair(demo(512), frames=2)
    got, ref = presents(rrunner, prunner, 320, 180)
    assert_present_close(got, ref, "demo 512")


def test_tpu_present_occlusion_and_background():
    rrunner, prunner, *_ = run_pair(demo(8), frames=1)
    got, ref = presents(rrunner, prunner, 96, 64)
    assert_present_close(got, ref, "demo 8")
    rgb, depth, _ = got
    bg = depth == np.inf
    assert bg.any() and (rgb[bg] == 18).all()
    assert (depth[~bg] > 0).all()


def test_tpu_present_rebakes_on_topology_change():
    rrunner, prunner, *_ = run_pair(demo(32), frames=1)
    present = P.TpuPresent(width=64, height=32)
    present(prunner)
    v0 = present._soup_version
    for runner in (rrunner, prunner):
        w = runner.world
        w.destroy_entity(int(w.modules["renderer"].model_instances.entity[0]))
    rrunner.state = rrunner.world.device_state()
    sync(rrunner, prunner)
    got = present(prunner)
    assert present._soup_version != v0
    ref = _pkg("lumixengine_tpu", "renderer.gpu_tpu").TpuPresent(64, 32)(rrunner)
    assert_present_close(got, ref, "rebaked")


def _material_scene(root):
    E = _pkg(root, "engine.engine").Engine
    Model = _pkg(root, "renderer.model").Model
    Material = _pkg(root, "renderer.material").Material
    rsys_cls = _pkg(root, "renderer.render_module").RendererSystem
    engine = E()
    rsys = rsys_cls(engine)
    red = rsys.materials.add(Material("red", uniforms={"color_r": 1.0, "color_g": 0.1,
                                                       "color_b": 0.1}))
    mid = rsys.add_model(Model(name="ball", bounding_radius=1.0, material_id=red))
    engine.add_system(rsys)
    world = engine.create_world(capacity=16)
    cam = world.create_entity(position=(0.0, 0.0, 6.0))
    world.create_component(cam, "camera", fov=np.pi / 3, near=0.1, far=100.0)
    e = world.create_entity(position=(0.0, 0.0, 0.0))
    world.create_component(e, "model_instance", model=mid)
    lt = world.create_entity(position=(0.0, 1.5, 1.5))
    world.create_component(lt, "point_light", range=12.0, intensity=6.0)
    return engine, world, rsys


def test_tpu_present_material_albedo_and_clustered_lights():
    rrunner, prunner, *_ = run_pair(_material_scene)
    got, ref = presents(rrunner, prunner, 96, 64)
    assert_present_close(got, ref, "lit")
    got0, ref0 = presents(rrunner, prunner, 96, 64, lights=False)
    assert_present_close(got0, ref0, "unlit")
    (rgb, depth, ov), (rgb0, _d0, _) = got, got0
    hit = depth < np.inf
    assert hit.any() and ov == 0
    fg = rgb0[hit].astype(np.float32)
    assert fg[:, 0].mean() > 2.0 * fg[:, 1].mean()
    assert rgb[hit].astype(np.int32).sum() > rgb0[hit].astype(np.int32).sum()
    assert (rgb[~hit] == rgb0[~hit]).all()


def _terrain_scene(grass):
    def build(root):
        engine, renderer = _pkg(root, "models.demo_scenes").build_engine(model_instances=8)
        hm = np.zeros((32, 32), np.float32)
        if not grass:
            hm[12:20, 12:20] = 4.0
        tid = renderer.terrains.add(hm, xz_scale=1.0, y_scale=1.0,
                                    grass_types=[{"density": 2.0, "height": 1.5}] if grass else None)
        world = engine.create_world(capacity=8)
        cam = world.create_entity(position=(16.0, 3.0 if grass else 10.0, 40.0), name="cam")
        world.create_component(cam, "camera", fov=1.1, near=0.1, far=300.0)
        t = world.create_entity(position=(0.0, 0.0, 0.0), name="ground")
        world.create_component(t, "terrain", terrain=tid)
        return engine, world, renderer
    return build


def test_tpu_present_draws_terrain():
    rrunner, prunner, *_ = run_pair(_terrain_scene(False))
    got, ref = presents(rrunner, prunner, 96, 64, lights=False, k_slots=2048)
    assert_present_close(got, ref, "terrain")
    rgb, depth, ov = got
    hit = depth < np.inf
    assert ov == 0 and hit.sum() > 500
    fg = rgb[hit].astype(np.float32)
    assert fg[:, 1].mean() > fg[:, 0].mean() > fg[:, 2].mean()


def test_tpu_present_draws_grass():
    """The blades come from the port's threefry scatter: the soup equals the
    reference's array for array, and so does the image."""
    rrunner, prunner, *_ = run_pair(_terrain_scene(True))
    rp = _pkg("lumixengine_tpu", "renderer.gpu_tpu").TpuPresent(96, 64, lights=False,
                                                                 k_slots=2048)
    pp_ = P.TpuPresent(96, 64, lights=False, k_slots=2048)
    ref, got = rp(rrunner), pp_(prunner)
    assert_present_close(got, ref, "grass")
    rgm = _pkg("lumixengine_tpu", "renderer.gpu_tpu").grass_mesh(
        rrunner.world.modules["renderer"].system.terrains, 0,
        rrunner.world.modules["renderer"].system.terrains.get(0))
    pgm = P.grass_mesh(prunner.world.modules["renderer"].system.terrains, 0,
                       prunner.world.modules["renderer"].system.terrains.get(0), "cpu")
    np.testing.assert_array_equal(pgm[0], rgm[0])
    np.testing.assert_array_equal(pgm[1], rgm[1])
    fg = np.asarray(got[0]).reshape(-1, 3).astype(np.float32)
    grassy = (fg[:, 1] > fg[:, 0] + 20) & (fg[:, 1] > fg[:, 2] + 30)
    assert grassy.sum() > 10


def _procedural_scene(root):
    engine, renderer = _pkg(root, "models.demo_scenes").build_engine(model_instances=4)
    world = engine.create_world(capacity=8)
    cam = world.create_entity(position=(0.0, 0.0, 6.0), name="cam")
    world.create_component(cam, "camera", fov=1.1, near=0.1, far=100.0)
    e = world.create_entity(position=(0.0, 0.0, 0.0), name="pg")
    tri = np.array([[-1.5, -1.0, 0.0], [1.5, -1.0, 0.0], [0.0, 1.5, 0.0]], np.float32)
    world.create_component(e, "procedural_geometry", vertices=tri)
    return engine, world, renderer


def test_tpu_present_draws_procedural_geometry():
    rrunner, prunner, *_ = run_pair(_procedural_scene)
    got, ref = presents(rrunner, prunner, 96, 64, lights=False)
    assert_present_close(got, ref, "procedural")
    rgb, depth, ov = got
    hit = depth < np.inf
    assert ov == 0 and hit.sum() > 50
    fg = rgb[hit].astype(np.float32)
    assert fg[:, 0].mean() > fg[:, 2].mean() > fg[:, 1].mean()


def _storm(root):
    return _pkg(root, "models.demo_scenes").particle_stress_world(capacity=2048)


def test_tpu_present_splats_particles():
    rrunner, prunner, *_ = run_pair(_storm, frames=10)
    got, ref = presents(rrunner, prunner, 128, 72, lights=False)
    assert_present_close(got, ref, "splats")
    got0, _ref0 = presents(rrunner, prunner, 128, 72, lights=False, particles=False)
    (rgb, depth, _), (rgb0, depth0, _) = got, got0
    assert (rgb != rgb0).any(axis=-1).sum() > 20
    assert (np.isfinite(depth) & ~np.isfinite(depth0)).sum() > 10
    both = np.isfinite(depth) & np.isfinite(depth0)
    assert (depth[both] <= depth0[both] + 1e-4).all()


def _decal_scene(root):
    engine, renderer = _pkg(root, "models.demo_scenes").build_engine(model_instances=16)
    world = engine.create_world(capacity=16)
    cam = world.create_entity(position=(0.0, 0.0, 10.0), name="camera")
    world.create_component(cam, "camera", fov=np.radians(70.0))
    wall = world.create_entity(position=(0.0, 0.0, 0.0), scale=(4.0,) * 3)
    world.create_component(wall, "model_instance", model="cube")
    dec = world.create_entity(position=(0.0, 0.0, 2.5))
    world.create_component(dec, "decal", material=3, half_extents=(1.0, 1.0, 2.0))
    cd = world.create_entity(position=(0.0, 0.0, 2.5))
    world.create_component(cd, "curve_decal", material=6, half_extents=(0.6, 1.0, 0.6),
                           bezier_p0=(-2.0, 0.0), bezier_p2=(2.0, 0.0))
    return engine, world, (dec, cd)


def test_tpu_present_projects_decals():
    rrunner, prunner, (rdec, rcd), (pdec, pcd) = run_pair(_decal_scene)
    got, ref = presents(rrunner, prunner, 120, 68, lights=False)
    assert_present_close(got, ref, "decals")
    for runner, dec, cd in ((rrunner, rdec, rcd), (prunner, pdec, pcd)):
        runner.world.destroy_component(dec, "decal")
        runner.world.destroy_component(cd, "curve_decal")
    rrunner.state = rrunner.world.device_state()
    sync(rrunner, prunner)
    bare, rbare = presents(rrunner, prunner, 120, 68, lights=False)
    assert_present_close(bare, rbare, "no decals")
    diff = np.abs(got[0].astype(int) - bare[0].astype(int)).max(axis=-1)
    assert (diff > 20).sum() > 30


def _instanced_scene(root):
    engine, renderer = _pkg(root, "models.demo_scenes").build_engine(model_instances=8)
    world = engine.create_world(capacity=8)
    cam = world.create_entity(position=(0.0, 2.0, 14.0), name="cam")
    world.create_component(cam, "camera", fov=1.1, near=0.1, far=100.0)
    owner = world.create_entity(position=(0.0, 0.0, 0.0), name="rocks")
    n = 5
    world.create_component(
        owner, "instanced_model", model="cube",
        positions=np.stack([np.linspace(-6, 6, n), np.zeros(n), np.zeros(n)], -1
                           ).astype(np.float32),
        rotations=np.tile([0, 0, 0, 1.0], (n, 1)).astype(np.float32),
        scales=np.ones((n, 3), np.float32))
    return engine, world, renderer


def test_tpu_present_draws_instanced_models():
    rrunner, prunner, *_ = run_pair(_instanced_scene)
    got, ref = presents(rrunner, prunner, 128, 64, lights=False)
    assert_present_close(got, ref, "instanced")
    cols_hit = np.nonzero((got[1] < np.inf).any(axis=0))[0]
    assert int((np.diff(cols_hit) > 1).sum()) + 1 == 5


def _gui_scene(root):
    engine = _pkg(root, "app").create_full_engine(
        **({"device": "cpu"} if root.endswith("torch") else {}))
    world = engine.create_world(capacity=8)
    cam = world.create_entity(position=(0.0, 0.0, 6.0), name="cam")
    world.create_component(cam, "camera", fov=1.1, near=0.1, far=100.0)
    panel = world.create_entity(name="panel")
    world.create_component(panel, "gui_rect", anchor=(0.1, 0.1, 0.4, 0.3))
    world.create_component(panel, "gui_image", color=(1.0, 0.2, 0.2, 0.9))
    return engine, world, None


def test_present_tpu_composites_gui():
    rrunner, prunner, *_ = run_pair(_gui_scene)
    got = prunner.present_tpu(width=96, height=64)
    ref = rrunner.present_tpu(width=96, height=64)
    assert_present_close(got, ref, "gui")
    rgb0, _, _ = prunner.present_tpu(width=96, height=64, gui=False)
    diff = (got[0] != rgb0).any(axis=-1)
    assert diff.sum() > 50
    ys, xs = np.nonzero(diff)
    assert ys.max() < 64 * 0.4 and xs.max() < 96 * 0.5


def test_present_tpu_refuses_a_world_batch():
    rrunner, prunner, *_ = run_pair(demo(8))
    from lumixengine_tpu_torch.parallel.mesh import replicate_state

    prunner.state = replicate_state(prunner.state, 2, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="batch of 2"):
        prunner.present_tpu(width=64, height=32)


def test_app_main_writes_the_screenshot(tmp_path, capsys):
    """app.main boots headless_demo_world(2048), runs the frames and writes
    the software present with the builtin plugins as a PNG; with --tui it
    presents each frame to the terminal as ANSI half-blocks (before the port
    had the terminal UI, this test held its raise)."""
    from lumixengine_tpu_torch import app
    from lumixengine_tpu_torch.renderer.texture import decode_png

    shot = tmp_path / "out.png"
    assert app.main(["--frames", "3", "--screenshot", str(shot), "--device", "cpu"]) == 0
    img = decode_png(shot.read_bytes())
    assert img.shape == (270, 480, 4) and img[..., :3].std() > 4.0
    assert "'frame': 3" in capsys.readouterr().out
    assert app.main(["--frames", "1", "--tui", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("\x1b[H") == 1 and "\x1b[?1049h" in out and "\x1b[?1049l" in out
    assert "'frame': 1" in out


def _skinned_scene(root):
    """A seeded 40-bone-weighted mesh on the demo character's skeleton,
    animated by the `run` clip."""
    ds = _pkg(root, "models.demo_scenes")
    Model = _pkg(root, "renderer.model").Model
    engine, renderer, anim = ds.build_engine(with_animation=True, model_instances=4,
                                             animables=2, animators=0)
    sk = renderer.models.get(renderer.models.get_id("character")).skeleton
    rng = np.random.default_rng(11)
    v = rng.uniform(-0.6, 0.6, (60, 3)).astype(np.float32) + np.array([0, 1.0, 0], np.float32)
    tris = rng.integers(0, 60, (80, 3)).astype(np.int32)
    bones4 = rng.integers(0, sk.bone_count, (60, 4)).astype(np.int32)
    w = rng.uniform(0.1, 1.0, (60, 4)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    mid = renderer.add_model(Model(name="skinned", bounding_radius=2.5, skeleton=sk,
                                   vertex_positions=v, vertex_triangles=tris,
                                   vertex_bones4=bones4, vertex_weights=w))
    world = engine.create_world(capacity=8)
    cam = world.create_entity(position=(0.0, 1.0, 4.0), name="cam")
    world.create_component(cam, "camera", fov=1.1, near=0.1, far=100.0)
    e = world.create_entity(name="bot")
    world.create_component(e, "model_instance", model=mid)
    world.create_component(e, "animable", clip=2)          # run
    return engine, world, renderer


def test_tpu_present_skins_in_the_vertex_stage():
    """The posed mesh (dual-quaternion skinning on the animation palette in
    the vertex stage): equal to the JAX package's present, and it changes
    as the clip advances."""
    rrunner, prunner, *_ = run_pair(_skinned_scene, frames=1)
    got, ref = presents(rrunner, prunner, 128, 72, lights=False)
    assert_present_close(got, ref, "skinned")
    assert (got[1] < np.inf).any()
    soup = P.TpuPresent(128, 72, lights=False)
    soup(prunner)
    assert int((soup.soup.vskin_col >= 0).sum()) == 60
    rrunner.run(15)
    sync(rrunner, prunner)
    got2, ref2 = presents(rrunner, prunner, 128, 72, lights=False)
    assert_present_close(got2, ref2, "skinned, 15 frames on")
    assert (got2[0] != got[0]).any(axis=-1).mean() > 0.0005
