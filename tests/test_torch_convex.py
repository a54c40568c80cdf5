"""The port's hull and SDF cooking, convex narrowphase, SDF contacts,
queries, terrain sampling and heightfield contacts against the JAX
package's, on seeded numpy data through both on the CPU; and the JAX
package's convex and mesh tests (tests/test_physics_convex.py) run on the
port's PhysicsModule.

Tolerances: cooked hulls and SDF grids equal, bit for bit; the contact and
query functions within OPS_ATOL with their hit flags, body indices and
active flags equal; terrain heights and normals within TERRAIN_ATOL."""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lumixengine_tpu_torch.models import physics_scenes as PS

torch.set_num_threads(1)

OPS_ATOL = 1e-5
TERRAIN_ATOL = 1e-6
_BOX_SIGNS = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                      np.float32).T


def _clouds():
    rng = np.random.default_rng(21)
    clouds = {"cube": PS.CUBE_CLOUD, "tetra": PS.TETRA}
    for i in range(4):
        clouds[f"random{i}"] = rng.uniform(-0.45, 0.45, (10, 3)).astype(np.float32)
    clouds["sphere_cloud"] = rng.normal(size=(60, 3)).astype(np.float32)   # > 16 vertices: reduced
    return clouds


@pytest.mark.parametrize("name", list(_clouds()))
def test_cooked_hulls_equal_reference(name):
    from lumixengine_tpu.physics import cooking as RK
    from lumixengine_tpu_torch.physics import cooking as PK

    got, ref = PK.cook_convex(_clouds()[name]), RK.cook_convex(_clouds()[name])
    for f in ("verts", "axes", "n_verts", "n_faces", "bound_radius", "volume", "inertia_diag", "com"):
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), f


@pytest.mark.parametrize("mesh", ["box_2x1x2", "thin_slab"])
def test_cooked_sdf_equals_reference(mesh):
    from lumixengine_tpu.physics import cooking as RK
    from lumixengine_tpu_torch.physics import cooking as PK

    v = {"box_2x1x2": PS.box_mesh((-1, 1), (0, 1), (-1, 1)),
         "thin_slab": PS.box_mesh((-2, 2), (-0.1, 0.1), (-2, 2))}[mesh]
    got = PK.cook_mesh_sdf(v, PS.BOX_MESH_T, resolution=24)
    ref = RK.cook_mesh_sdf(v, PS.BOX_MESH_T, resolution=24)
    for f in ("grid", "origin", "cell", "bound_min", "bound_max"):
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), f
    assert (got.grid < 0).any() and (got.grid > 0).any()


def test_cooked_cube_properties():
    """tests/test_physics_convex.py::test_cooked_cube_properties on the port."""
    from lumixengine_tpu_torch.physics.cooking import cook_convex

    h = cook_convex(PS.CUBE_CLOUD)
    assert h.n_verts == 8 and h.n_faces == 3
    assert abs(h.volume - 1.0) < 1e-6
    np.testing.assert_allclose(h.inertia_diag, 1.0 / 6.0, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _polytopes(batch: tuple):
    """Seeded padded polytopes for P pairs: hulls, boxes, spheres and
    capsules as the statics pad them, poses near each other so that many
    pairs touch. Leading batch axes `batch` on the poses."""
    from lumixengine_tpu_torch.physics.cooking import cook_convex

    rng = np.random.default_rng(5)
    hulls = [cook_convex(c) for c in _clouds().values()]
    P = 96

    def one():
        kind = rng.integers(0, 4)
        v, ax, r = np.zeros((3, 16), np.float32), np.zeros((3, 12), np.float32), 0.0
        ax[1] = 1.0
        if kind == 0:
            h = hulls[rng.integers(0, len(hulls))]
            v[:] = h.verts.T
            ax[:] = h.axes.T
        elif kind == 1:
            he = rng.uniform(0.2, 0.6, 3).astype(np.float32)
            v[:, :8] = _BOX_SIGNS * he[:, None]
            v[:, 8:] = v[:, :1]
            ax[:, :3] = np.eye(3)
            ax[:, 3:] = ax[:, :1]
        else:
            r = float(rng.uniform(0.2, 0.5))
            if kind == 3:
                v[1, 0], v[1, 1:] = 0.4, -0.4
        return v, ax, np.float32(r)

    parts = [one() for _ in range(2 * P)]
    va = np.stack([p[0] for p in parts[:P]], -1)
    vb = np.stack([p[0] for p in parts[P:]], -1)
    fa = np.stack([p[1] for p in parts[:P]], -1)
    fb = np.stack([p[1] for p in parts[P:]], -1)
    ra = np.array([p[2] for p in parts[:P]], np.float32)
    rb = np.array([p[2] for p in parts[P:]], np.float32)
    pa = rng.uniform(-0.6, 0.6, batch + (3, P)).astype(np.float32)
    pb = pa + rng.uniform(-0.9, 0.9, batch + (3, P)).astype(np.float32)
    qa = rng.normal(size=batch + (4, P)).astype(np.float32)
    qb = rng.normal(size=batch + (4, P)).astype(np.float32)
    qa /= np.linalg.norm(qa, axis=-2, keepdims=True)
    qb /= np.linalg.norm(qb, axis=-2, keepdims=True)
    return (pa, qa, va, fa, ra, pb, qb, vb, fb, rb)


def _match(got, ref, atol=OPS_ATOL, comp_axis=-2):
    """Contact tuples (point, normal, depth, active): active flags equal, the
    rest within atol on the active slots. Vectors carry their 3 components
    at `comp_axis` (0 in the banded grids)."""
    act = np.asarray(ref[3])
    np.testing.assert_array_equal(got[3].numpy(), act)
    assert act.any()
    for g, r in zip(got[:3], ref[:3]):
        r = np.asarray(r)
        m = act if r.ndim == act.ndim else np.broadcast_to(np.expand_dims(act, comp_axis), r.shape)
        np.testing.assert_allclose(g.numpy()[m], r[m], rtol=0, atol=atol)


@pytest.mark.parametrize("batch", [(), (3,)])
def test_polytope_pair_contacts_match_reference(batch):
    from lumixengine_tpu.ops import convex_ops as RC
    from lumixengine_tpu_torch.ops import convex_ops as PC

    data = _polytopes(batch)
    ref = RC.polytope_pair_contacts_from_data(*[jnp.asarray(a) for a in data], points_per_pair=4)
    got = PC.polytope_pair_contacts_from_data(*[torch.as_tensor(a) for a in data],
                                              points_per_pair=4)
    _match(got, ref)


def _bodies(n=24, seed=8, batch=()):
    """Padded polytope bodies [3, V, n] with poses, dropped near the ground."""
    pa, qa, va, fa, ra, *_ = _polytopes(batch)
    rng = np.random.default_rng(seed)
    pos = pa[..., :n].copy()
    pos[..., 1, :] = rng.uniform(-0.2, 0.6, pos[..., 1, :].shape)
    return pos, qa[..., :n], va[..., :n], fa[..., :n], ra[:n]


@pytest.mark.parametrize("batch", [(), (2,)])
def test_polytope_ground_contacts_and_grids_match_reference(batch):
    from lumixengine_tpu.ops import convex_ops as RC
    from lumixengine_tpu_torch.ops import convex_ops as PC

    pos, rot, verts, _axes, rad = _bodies(batch=batch)
    idx = np.array([0, 3, 5, 8, 13, 21], np.int32)
    ref = RC.polytope_ground_contacts(jnp.asarray(pos), jnp.asarray(rot), verts[:, :, idx],
                                      rad[idx], idx, 0.1, points_per_body=4)
    got = PC.polytope_ground_contacts(torch.as_tensor(pos), torch.as_tensor(rot),
                                      torch.as_tensor(verts[:, :, idx]), torch.as_tensor(rad[idx]),
                                      torch.as_tensor(idx, dtype=torch.int64), 0.1, points_per_body=4)
    np.testing.assert_array_equal(got.body_a.numpy(), ref.body_a)
    _match((got.point, got.normal, got.depth, got.active),
           (ref.point, ref.normal, ref.depth, ref.active))
    sel = np.arange(24) % 3 != 1
    ref = RC.polytope_ground_grids(jnp.asarray(pos), jnp.asarray(rot), verts, rad, sel, 0.1)
    got = PC.polytope_ground_grids(torch.as_tensor(pos), torch.as_tensor(rot),
                                   torch.as_tensor(verts), torch.as_tensor(rad),
                                   torch.as_tensor(sel), 0.1)
    _match((got.point, got.normal, got.depth, got.active),
           (ref.point, ref.normal, ref.depth, ref.active))


def test_banded_polytope_grids_match_reference():
    from lumixengine_tpu.ops import physics_banded as RB
    from lumixengine_tpu_torch.ops import physics_banded as PB

    pos, rot, verts, axes, rad = _bodies(n=40, seed=9)
    pos = (pos * [[1.5], [1.0], [1.5]]).astype(np.float32)
    order = np.argsort(pos[0]).astype(np.int32)
    args = [pos[:, order], rot[:, order], verts[:, :, order], axes[:, :, order], rad[order]]
    ref = RB.banded_polytope_grids(*[jnp.asarray(a) for a in args], 6, 4)
    got = PB.banded_polytope_grids(*[torch.as_tensor(a) for a in args], 6, 4)
    _match(got, ref, comp_axis=0)


def test_raycast_convex_matches_reference():
    from lumixengine_tpu.ops import convex_ops as RC
    from lumixengine_tpu_torch.ops import convex_ops as PC

    pos, rot, verts, axes, rad = _bodies(n=24, seed=10)
    pos = pos * 4.0
    dots = np.einsum("cfn,cvn->fvn", axes, verts)
    lo, hi = (dots.min(axis=1) - rad).astype(np.float32), (dots.max(axis=1) + rad).astype(np.float32)
    rng = np.random.default_rng(11)
    origin = rng.uniform(-6, 6, (32, 3)).astype(np.float32)
    target = pos[:, rng.integers(0, 24, 32)].T + rng.uniform(-0.3, 0.3, (32, 3))
    d = (target - origin) / np.linalg.norm(target - origin, axis=-1, keepdims=True)
    mask = np.arange(24) % 5 != 0
    for o, dd in zip(origin, d.astype(np.float32)):
        ref = RC.raycast_convex(jnp.asarray(o), jnp.asarray(dd), jnp.asarray(pos), jnp.asarray(rot),
                                axes, lo, hi, jnp.asarray(mask))
        got = PC.raycast_convex(torch.as_tensor(o), torch.as_tensor(dd), torch.as_tensor(pos),
                                torch.as_tensor(rot), torch.as_tensor(axes), torch.as_tensor(lo),
                                torch.as_tensor(hi), torch.as_tensor(mask))
        assert bool(got[0]) == bool(ref[0])
        if bool(ref[0]):
            assert int(got[2]) == int(ref[2])
            np.testing.assert_allclose(float(got[1]), float(ref[1]), rtol=0, atol=OPS_ATOL)


@functools.lru_cache(maxsize=None)
def _sdf():
    from lumixengine_tpu_torch.physics.cooking import cook_mesh_sdf

    return cook_mesh_sdf(PS.box_mesh((-1, 1), (0, 1), (-1, 1)), PS.BOX_MESH_T, resolution=24)


def test_sdf_sample_gradient_and_contacts_match_reference():
    from lumixengine_tpu.core import host_math as hm
    from lumixengine_tpu.ops import convex_ops as RC
    from lumixengine_tpu_torch.ops import convex_ops as PC

    sdf = _sdf()
    rng = np.random.default_rng(12)
    p = rng.uniform(-2.0, 2.5, (2, 3, 200)).astype(np.float32)     # inside, near and beyond the grid
    g, o = sdf.grid, sdf.origin
    tg, to = torch.as_tensor(g), torch.as_tensor(o)
    np.testing.assert_allclose(PC.sdf_sample(tg, to, sdf.cell, torch.as_tensor(p)).numpy(),
                               np.asarray(RC.sdf_sample(g, o, sdf.cell, jnp.asarray(p))),
                               rtol=0, atol=OPS_ATOL)
    np.testing.assert_allclose(PC.sdf_gradient(tg, to, sdf.cell, torch.as_tensor(p)).numpy(),
                               np.asarray(RC.sdf_gradient(g, o, sdf.cell, jnp.asarray(p))),
                               rtol=0, atol=1e-4)   # a central difference over half a cell
    mrot = np.asarray(hm.quat_from_axis_angle(np.array([0.0, 1.0, 0.0]), 0.3), np.float32)
    mpos = np.array([0.2, -0.1, 0.0], np.float32)
    eff = rng.uniform(0.0, 0.3, 200).astype(np.float32)
    body = np.arange(200) % 7
    ref = RC.sdf_contacts(jnp.asarray(p), jnp.asarray(eff), body, g, o, sdf.cell, jnp.asarray(mpos),
                          jnp.asarray(mrot))
    got = PC.sdf_contacts(torch.as_tensor(p), torch.as_tensor(eff), torch.as_tensor(body), tg, to,
                          sdf.cell, torch.as_tensor(mpos), torch.as_tensor(mrot))
    _match((got.point, got.normal, got.depth, got.active),
           (ref.point, ref.normal, ref.depth, ref.active), atol=1e-4)


def _query_bodies(batch=()):
    rng = np.random.default_rng(13)
    n = 20
    pos = rng.uniform(-8, 8, batch + (3, n)).astype(np.float32)
    rot = rng.normal(size=batch + (4, n)).astype(np.float32)
    rot /= np.linalg.norm(rot, axis=-2, keepdims=True)
    shape = rng.integers(0, 3, n).astype(np.int32)
    radius = rng.uniform(0.3, 1.2, n).astype(np.float32)
    he = rng.uniform(0.3, 1.2, (3, n)).astype(np.float32)
    mask = np.arange(n) % 6 != 5
    origin = rng.uniform(-10, 10, batch + (16, 3)).astype(np.float32)
    d = rng.normal(size=batch + (16, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return pos, rot, shape, radius, he, mask, origin, d


@pytest.mark.parametrize("fn", ["raycast_spheres", "raycast_boxes", "raycast_all", "sweep"])
def test_queries_match_reference(fn):
    """Each query on 16 rays against 20 bodies: the JAX function per ray
    (as under vmap), the port's with the rays as a leading axis."""
    from lumixengine_tpu.ops import physics_ops as RP
    from lumixengine_tpu_torch.ops import physics_ops as PP

    pos, rot, shape, radius, he, mask, origin, d = _query_bodies()
    t = torch.as_tensor
    if fn == "raycast_spheres":
        got = PP.raycast_spheres(t(origin), t(d), t(pos), t(radius), t(mask))
        ref = [RP.raycast_spheres(o, dd, pos, radius, mask) for o, dd in zip(origin, d)]
    elif fn == "raycast_boxes":
        got = PP.raycast_boxes(t(origin), t(d), t(pos), t(rot), t(he), t(mask))
        ref = [RP.raycast_boxes(jnp.asarray(o), jnp.asarray(dd), pos, rot, he, mask)
               for o, dd in zip(origin, d)]
    elif fn == "raycast_all":
        got = PP.raycast_all(t(origin), t(d), t(pos), t(rot), t(shape).long(), t(radius), t(he),
                             t(mask))
        ref = [RP.raycast_all(jnp.asarray(o), jnp.asarray(dd), pos, rot, shape, radius, he, mask)
               for o, dd in zip(origin, d)]
    else:
        got = PP.sweep(t(origin), t(d), 0.4, t(pos), t(rot), t(shape).long(), t(radius), t(he),
                       t(mask))
        ref = [RP.sweep(jnp.asarray(o), jnp.asarray(dd), jnp.float32(0.4), pos, rot, shape, radius,
                        he, mask) for o, dd in zip(origin, d)]
    hit = np.array([bool(r[0]) for r in ref])
    np.testing.assert_array_equal(got[0].numpy(), hit)
    assert hit.any() and not hit.all()
    np.testing.assert_array_equal(got[2].numpy()[hit], np.array([int(r[2]) for r in ref])[hit])
    np.testing.assert_allclose(got[1].numpy()[hit], np.array([float(r[1]) for r in ref])[hit],
                               rtol=1e-5, atol=OPS_ATOL)   # b² − c cancels at |b| ≈ t


def _terrain_banks():
    from lumixengine_tpu.renderer.terrain import TerrainRegistry as RR
    from lumixengine_tpu_torch.renderer.terrain import TerrainRegistry as PR

    rng = np.random.default_rng(14)
    maps = [(PS.terrain_heights(3), 1.0, 1.0), (rng.uniform(0, 3, (20, 33)), 0.5, 2.0)]
    rr, pr = RR(), PR()
    for h, xz, y in maps:
        rr.add(h, xz_scale=xz, y_scale=y)
        pr.add(h, xz_scale=xz, y_scale=y)
    return rr.bank, pr.bank("cpu")


@pytest.mark.parametrize("tid", [0, 1])
def test_terrain_sampling_matches_reference(tid):
    from lumixengine_tpu.renderer import terrain as RT
    from lumixengine_tpu_torch.renderer import terrain as PT

    rbank, pbank = _terrain_banks()
    for f in ("heights", "inv_xz", "y_scale", "size"):
        np.testing.assert_array_equal(getattr(pbank, f).numpy(), np.asarray(getattr(rbank, f)))
    rng = np.random.default_rng(15 + tid)
    x, z = rng.uniform(-3, 70, (2, 4, 50)).astype(np.float32)   # inside and beyond the map
    np.testing.assert_allclose(PT.sample_height(pbank, tid, torch.as_tensor(x), torch.as_tensor(z)).numpy(),
                               np.asarray(RT.sample_height(rbank, tid, x, z)), rtol=0, atol=TERRAIN_ATOL)
    np.testing.assert_allclose(PT.sample_normal(pbank, tid, torch.as_tensor(x), torch.as_tensor(z)).numpy(),
                               np.asarray(RT.sample_normal(rbank, tid, x, z)), rtol=0, atol=TERRAIN_ATOL)


def test_heightfield_contacts_match_reference():
    from lumixengine_tpu.ops import physics_ops as RP
    from lumixengine_tpu_torch.ops import physics_ops as PP

    rbank, pbank = _terrain_banks()
    pos, rot, shape, radius, he, _mask, _o, _d = _query_bodies((2,))
    pos = (pos * [[1.5], [0.1], [1.5]] + [[0.0], [1.0], [0.0]]).astype(np.float32)
    dyn = np.arange(20) % 4 != 0
    origin = PS.TERRAIN_ORIGIN
    ref = RP.heightfield_contacts(jnp.asarray(pos), jnp.asarray(rot), jnp.asarray(shape),
                                  jnp.asarray(radius), jnp.asarray(he), jnp.asarray(dyn), rbank, 0,
                                  origin, slots_per_body=4, shape_np=shape)
    slot_mask = torch.as_tensor(PP.candidate_slot_mask(shape, 4))
    got = PP.heightfield_contacts(torch.as_tensor(pos), torch.as_tensor(rot),
                                  torch.as_tensor(shape).long(), torch.as_tensor(radius),
                                  torch.as_tensor(he), torch.as_tensor(dyn), pbank, 0, origin,
                                  slot_mask, slots_per_body=4)
    np.testing.assert_array_equal(slot_mask.numpy(), RP.candidate_slot_mask(shape, 4))
    _match((got.point, got.normal, got.depth, got.active),
           (ref.point, ref.normal, ref.depth, ref.active), atol=TERRAIN_ATOL * 10)


# -- the JAX package's convex tests on the port's module --------------------------


def _port_world(ground=True, gravity=(0.0, -9.81, 0.0)):
    engine, world, _phys = PS._game_world(None, 8, ground, False, 16, gravity=gravity)
    return engine, world


def test_raycast_convex_exact_on_the_port():
    """tests/test_physics_convex.py::test_raycast_convex_exact: the cube
    hull's face hit at t = 4.5, a ray past its corner inside its bounding
    sphere missing, the tetra's apex face from above."""
    engine, world = _port_world()
    e = world.create_entity(position=(0.0, 1.0, 0.0))
    world.create_component(e, "rigid_actor", motion="static", shape="convex", points=PS.CUBE_CLOUD)
    pm = world.modules["physics"]
    ms = world.device_state("cpu").modules["physics"]
    hit, t, idx = pm.raycast(ms, (0.0, 1.0, -5.0), (0.0, 0.0, 1.0))
    assert bool(hit) and abs(float(t) - 4.5) < 1e-3 and int(idx) == pm.actors.slot_of(e)
    hit2, _t2, _i2 = pm.raycast(ms, (0.7, 1.0, -5.0), (0.0, 0.0, 1.0))
    assert not bool(hit2)
    e2 = world.create_entity(position=(5.0, 1.0, 0.0))
    world.create_component(e2, "rigid_actor", motion="static", shape="convex", points=PS.TETRA)
    ms = world.device_state("cpu").modules["physics"]
    hit3, t3, _i3 = pm.raycast(ms, (5.0, 4.0, 0.0), (0.0, -1.0, 0.0))
    assert bool(hit3) and abs(float(t3) - 2.5) < 5e-2


def test_module_queries_match_reference_with_rays_per_world():
    """PhysicsModule.raycast and sweep with rays [W, R, 3] on a W=2 state of
    the drive world, against the JAX module per world and ray, with and
    without the layer filter."""
    import jax

    from test_torch_game_physics import built

    rsc, psc, tree = built("drive")
    from lumixengine_tpu_torch import bridge
    from test_torch_bridge import ref_from_numpy

    pstate = bridge.state_from_numpy({k: v[:2] for k, v in tree.items()}, "cpu")
    template = rsc.world.device_state()
    rms = [ref_from_numpy(template, {k: v[w] for k, v in tree.items()}).modules["physics"]
           for w in range(2)]
    rng = np.random.default_rng(16)
    origin = rng.uniform(-30, 30, (2, 24, 3)).astype(np.float32)
    origin[..., 1] = rng.uniform(0.2, 1.5, (2, 24))
    d = np.concatenate([-origin[..., :1], rng.uniform(-0.05, 0.05, (2, 24, 1)), -origin[..., 2:]], -1)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    pm, rm = psc.world.modules["physics"], rsc.world.modules["physics"]
    n_hits = 0
    for mask in (-1, PS.DRIVE_LAYER_MASK):
        for query in ("raycast", "sweep"):
            extra = (0.5,) if query == "sweep" else ()
            got = getattr(pm, query)(pstate.modules["physics"], origin, d, *extra, layer_mask=mask)
            for w in range(2):
                ref = jax.vmap(lambda o, dd, _w=w: getattr(rm, query)(rms[_w], o, dd, *extra,
                                                                      layer_mask=mask))(
                    jnp.asarray(origin[w]), jnp.asarray(d[w]))
                hit = np.asarray(ref[0])
                np.testing.assert_array_equal(got[0][w].numpy(), hit)
                np.testing.assert_array_equal(got[2][w].numpy()[hit], np.asarray(ref[2])[hit])
                np.testing.assert_allclose(got[1][w].numpy()[hit], np.asarray(ref[1])[hit],
                                           rtol=1e-5, atol=OPS_ATOL)
                n_hits += int(hit.sum())
    assert n_hits > 0
