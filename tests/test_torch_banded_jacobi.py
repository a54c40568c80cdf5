"""The banded Jacobi solve's wrapper on the CPU (the kernel itself,
csrc/banded_jacobi.cu, runs only on the card: tests/test_torch_banded_jacobi_gpu.py).
CPU tensors take the plain version bit for bit and launch nothing; the
kernel's operand checks refuse malformed sweeps and lay broadcast views out
by their strides without copying; the byte count the kernel's bound rests
on. tests/test_torch_banded.py holds the plain version against the JAX
package."""
import math

import pytest
import torch

from lumixengine_tpu_torch.ops import physics_banded as PB
from lumixengine_tpu_torch.ops import physics_ops as P

torch.set_num_threads(1)

K, KP, NB, DT = 8, 4, 48, 1.0 / 60.0
SCALARS = (10, 0.2, 0.005, 0.75)       # iterations, baumgarte, slop, relaxation


def _soup(batch=(), seed=0):
    """Spheres, boxes and capsules packed above a ground at y = 0.3, a few
    of them static, with seeded velocities and inertias: the solve's body
    operands and 4 sweeps of banded grids (ground on the first, p_fric and
    p_rest broadcast over the k axis as the PhysicsModule passes them), with
    seeded warm-start lambdas."""
    g = torch.Generator().manual_seed(seed)

    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(batch + shape, generator=g)

    rot = torch.randn(batch + (4, NB), generator=g)
    rot = rot / rot.norm(dim=-2, keepdim=True)
    pos = u(-1.2, 1.2, 3, NB) + torch.tensor([0.0, 1.4, 0.0])[:, None]
    shape = torch.randint(0, 3, (NB,), generator=g).expand(batch + (NB,))
    radius, he = u(0.2, 0.45, NB), u(0.2, 0.45, 3, NB)
    body = dict(vel=torch.randn(batch + (3, NB), generator=g),
                ang=torch.randn(batch + (3, NB), generator=g),
                im=u(0.5, 2.0, NB), iiw=u(1.0, 6.0, 3, NB), pos=pos)
    body["im"][..., ::9] = 0.0
    body["iiw"][..., ::9] = 0.0
    mn, mx = P.world_aabb(pos, rot, shape, radius, he)
    orders, ranks, _ = PB.sweep_orders(mn, mx, torch.ones(NB, dtype=torch.bool), 4)
    sweeps, warm = [], []
    for s, order in enumerate(orders):
        def rk(x, _o=order):
            return PB.take_ranked(x, _o)

        point, normal, depth, raw, ok = PB.banded_pair_grids(
            rk(pos), rk(rot), rk(radius), rk(he), rk(shape), rk(mn), rk(mx), K, KP, any_caps=True)
        if s:
            ok = ok & ~PB.cross_sweep_coverage(order, ranks[:s], K)
        sw = {"order": order, "p_point": point, "p_normal": normal, "p_depth": depth,
              "p_active": raw & ok.unsqueeze(-3),
              "p_fric": torch.rand(batch + (K, NB), generator=g).unsqueeze(-3).expand(depth.shape),
              "p_rest": torch.full(batch + (1, K, NB), 0.2).expand(depth.shape)}
        w = {"p": tuple(torch.rand(depth.shape, generator=g) * sc for sc in (0.2, 0.06, 0.06))}
        if s == 0:
            gc = P.ground_contacts(rk(pos), rk(rot), rk(shape), rk(radius), rk(he),
                                   rk((body["im"] > 0).expand(batch + (NB,))), ground_y=0.3,
                                   slots_per_body=4)
            sw.update(g_point=gc.point.reshape(batch + (3, 4, NB)),
                      g_normal=gc.normal.reshape(batch + (3, 4, NB)),
                      g_depth=gc.depth.reshape(batch + (4, NB)),
                      g_active=gc.active.reshape(batch + (4, NB)),
                      g_fric=torch.full(batch + (4, NB), 0.6), g_rest=torch.zeros(batch + (4, NB)))
            w["g"] = tuple(torch.rand(batch + (4, NB), generator=g) * 0.2 for _ in range(3))
        sweeps.append(sw)
        warm.append(w)
    assert sum(int(sw["p_active"].sum()) for sw in sweeps) > 50
    return body, sweeps, warm


def _args(body, sweeps):
    return (body["vel"], body["ang"], body["im"], body["iiw"], body["pos"], sweeps)


@pytest.mark.parametrize("case", ["warm", "cold", "batched", "one_sweep", "dt_tensor"])
def test_cpu_tensors_take_the_plain_version(case):
    """On the CPU the wrapper is the plain version, bit for bit, and
    launches nothing."""
    body, sweeps, warm = _soup((3,) if case == "batched" else ())
    if case == "one_sweep":
        sweeps = sweeps[:1]
    warm = None if case in ("cold", "one_sweep") else warm
    dt = torch.tensor(DT) if case == "dt_tensor" else DT
    kw = dict(iterations=10, baumgarte=0.2 if case == "dt_tensor" else 0.0, warm=warm)
    before = PB.solve_contacts_banded_cuda.launches
    got = PB.solve_contacts_banded_multi(*_args(body, sweeps), dt, **kw)
    ref = PB.solve_contacts_banded_multi_plain(*_args(body, sweeps), dt, **kw)
    assert PB.solve_contacts_banded_cuda.launches == before
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert len(got[2]) == len(sweeps)
    for g, r in zip(got[2], ref[2]):
        assert all(torch.equal(x, y) for x, y in zip(g, r))
    assert float((got[0] - body["vel"]).abs().max()) > 0.1


def test_the_kernel_refuses_cpu_tensors():
    body, sweeps, warm = _soup()
    with pytest.raises(ValueError, match="CUDA"):
        PB.solve_contacts_banded_cuda(*_args(body, sweeps), DT, warm=warm)


def _malformed(name, sweeps, warm):
    """One defect planted in a copy of the sweeps (or the warm list)."""
    sweeps = [dict(sw) for sw in sweeps]
    s1 = sweeps[1]
    if name == "missing_key":
        del s1["p_normal"]
    elif name == "missing_ground_key":
        del sweeps[0]["g_fric"]
    elif name == "active_not_bool":
        s1["p_active"] = s1["p_active"].float()
    elif name == "depth_float64":
        s1["p_depth"] = s1["p_depth"].double()
    elif name == "order_int32":
        s1["order"] = s1["order"].int()
    elif name == "other_window":
        s1["p_active"] = s1["p_active"][..., :K - 1, :]
    elif name == "point_not_3d":
        s1["p_point"] = s1["p_point"][:2]
    elif name == "other_bodies":
        s1["p_fric"] = s1["p_fric"][..., : NB - 1]
    elif name == "warm_two_lambdas":
        warm = [dict(w) for w in warm]
        warm[1]["p"] = warm[1]["p"][:2]
    elif name == "warm_short":
        warm = warm[:2]
    elif name == "not_a_tensor":
        s1["p_rest"] = 0.2
    elif name == "no_sweeps":
        sweeps = []
    return sweeps, warm


MALFORMED = ["missing_key", "missing_ground_key", "active_not_bool", "depth_float64",
             "order_int32", "other_window", "point_not_3d", "other_bodies", "warm_two_lambdas",
             "warm_short", "not_a_tensor", "no_sweeps"]


@pytest.mark.parametrize("name", MALFORMED)
def test_malformed_sweeps_are_refused(name):
    """The kernel's operand checks (run before anything touches the card)
    raise ValueError on a malformed sweeps entry."""
    body, sweeps, warm = _soup()
    PB._bj_operands(*_args(body, sweeps), DT, *SCALARS, warm)       # the sound operands pass
    bad_sweeps, bad_warm = _malformed(name, sweeps, warm)
    with pytest.raises(ValueError, match="banded jacobi"):
        PB._bj_operands(*_args(body, bad_sweeps), DT, *SCALARS, bad_warm)


def test_operands_are_read_through_their_strides():
    """Broadcast operands reach the kernel as views: p_fric's k axis and a
    shared inverse mass's world axis with stride 0, the batch flattened."""
    body, sweeps, warm = _soup((2, 3))
    call, arr, (batch, nb, k, K_, G) = PB._bj_operands(*_args(body, sweeps), DT, *SCALARS, warm)
    assert (batch, nb, k, K_, G) == ((2, 3), NB, KP, K, 4)
    assert (call.W, call.NB, call.S, call.k, call.K, call.G) == (6, NB, 4, KP, K, 4)
    fric = sweeps[0]["p_fric"]
    assert (arr[0].fric.a, arr[0].fric.d, arr[0].fric.i) == (0, NB, 1)
    assert arr[0].fric.w == fric.stride(1) and arr[0].fric.p == fric.data_ptr()
    assert arr[0].point.c == sweeps[0]["p_point"].stride(-4)
    assert arr[0].ground == 1 and arr[1].ground == 0
    assert (arr[1].warm_pairs, arr[1].warm_ground, arr[0].warm_ground) == (1, 0, 1)
    assert (call.vel.w, call.vel.c, call.vel.i) == (3 * NB, NB, 1)
    assert (call.iterations, call.dt_per_world, call.bias_live) == (10, 0, 1)
    assert math.isclose(call.bias_scale, 0.2 / DT, rel_tol=1e-6)
    shared = PB._bj_operands(body["vel"], body["ang"], torch.ones(NB), body["iiw"], body["pos"],
                             sweeps, torch.tensor(DT), *SCALARS, None)[0]
    assert (shared.inv_mass.w, shared.inv_mass.i) == (0, 1)
    assert (shared.dt_per_world, shared.dt_view.w) == (1, 0)       # one dt read by every world


def test_kernel_bytes():
    """banded_jacobi_bytes at the 10k-box drop's shape: every slot's flag
    and three lambdas, the active contacts' data, the bodies."""
    w, nb, s, k, k_, g, active = 4, 10_240, 4, 4, 40, 4, 246_000
    slots = w * nb * (s * k * k_ + g)
    want = slots * 13 + active * 48 + w * nb * (19 * 4 + 8 * s)
    assert PB.banded_jacobi_bytes(w, nb, s, k, k_, g, active) == want
    assert PB.banded_jacobi_bytes(w, nb, s, k, k_, g, active, warm=False) == want - active * 12
    assert math.isclose(want / 3.35e12 * 1e3, 0.108, rel_tol=0.05)
