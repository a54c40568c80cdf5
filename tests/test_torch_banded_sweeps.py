"""The banded contact stage's wrapper on the CPU (the kernel itself,
csrc/banded_grids.cu, runs only on the card: tests/test_torch_banded_sweeps_gpu.py).
CPU tensors take the plain version bit for bit and launch nothing; the
kernel's operand checks refuse what it does not take and lay broadcast
tables out by their strides without copying; the byte count the kernel's
bound rests on. tests/test_torch_banded.py and tests/test_torch_sap.py hold
the plain stage against the JAX package."""
import math

import pytest
import torch

from lumixengine_tpu_torch.ops import physics_banded as PB
from lumixengine_tpu_torch.ops import physics_ops as P

torch.set_num_threads(1)

K, KP, NB = 8, 4, 48


def stage_inputs(n_sweeps=4, batch=(), nb=NB, window=K, k=KP, seed=0, ground=True, warm=False,
                 layers=False, caps=True, device="cpu"):
    """banded_sweeps' arguments for a soup of spheres, boxes and (with
    `caps`) capsules packed into a 2.4 m cube above a ground at y = 0.3:
    every 7th body static, the last 3 slots unoccupied (parked far +x, as
    the PhysicsModule parks them), seeded friction and restitution; the
    sweeps of sweep_orders(n_sweeps); the ground stream with its friction
    and a restitution floor; with `warm`, last frame's carry (seeded
    lambdas, and the ranks of the soup 4 cm away, so that some pairs'
    ranks crossed); with `layers`, three layers of which 0 and 1 do not
    collide. As a dict of banded_sweeps' keyword arguments."""
    g = torch.Generator().manual_seed(seed)

    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=g)

    rot = torch.randn(batch + (4, nb), generator=g)
    rot = rot / rot.norm(dim=-2, keepdim=True)
    pos = u(-1.2, 1.2, *batch, 3, nb) + torch.tensor([0.0, 1.4, 0.0])[:, None]
    shape = torch.randint(0, 3 if caps else 2, (nb,), generator=g)
    radius, he = u(0.2, 0.45, nb), u(0.2, 0.45, 3, nb)
    dyn = torch.ones(nb, dtype=torch.bool)
    dyn[::7] = False
    occ = torch.ones(nb, dtype=torch.bool)
    occ[-3:] = False
    fric, rest = u(0.2, 0.9, nb), u(0.0, 0.4, nb)

    def bounds(p):
        mn, mx = P.world_aabb(p, rot, shape, radius, he)
        far = torch.where(occ, 0.0, 1e9)
        return mn + far, mx + far

    mn, mx = bounds(pos)
    orders, ranks, col_keys = PB.sweep_orders(mn, mx, occ, n_sweeps)
    args = dict(pos=pos, rot=rot, mn=mn, mx=mx, orders=orders, ranks=ranks, col_keys=col_keys,
                shape=shape, radius=radius, he=he, dyn=dyn, occ=occ, fric=fric, rest=rest,
                K=window, k=k, any_caps=caps, ground=None, carry=None, layers=None, hulls=None)
    if ground:
        gc = P.ground_contacts(pos, rot, shape, radius, he, dyn, ground_y=0.3, slots_per_body=4)
        args["ground"] = (gc, 0.6, 0.1)
    if warm:
        prev = PB.sweep_orders(*bounds(pos + u(-0.04, 0.04, *batch, 3, nb)), occ, n_sweeps)[1]
        n_s = len(orders)
        args["carry"] = (u(0.01, 0.3, *batch, n_s, 3, k, window, nb),
                         u(0.0, 0.2, *batch, 3, 4, nb), torch.stack(prev, dim=-2))
    if layers:
        matrix = torch.ones((3, 3), dtype=torch.bool)
        matrix[0, 1] = matrix[1, 0] = False
        args["layers"] = (torch.arange(nb) % 3, matrix.reshape(-1))
    return {key: _to(v, device) for key, v in args.items()}


def _to(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, P.Contacts):
        return P.Contacts(*(_to(v, device) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_to(v, device) for v in x)
    return x


def _equal(got, ref):
    """Two of banded_sweeps' results equal bit for bit, key for key."""
    (gs, gw, gm, gn), (rs, rw, rm, rn) = got, ref
    assert torch.equal(gm, rm) and torch.equal(gn, rn)
    assert len(gs) == len(rs)
    for a, b in zip(gs, rs):
        assert a.keys() == b.keys() and a["order"] is b["order"]
        for key in PB.PAIR_KEYS + PB.GROUND_KEYS:
            if key in a:
                assert a[key].dtype == b[key].dtype and torch.equal(a[key], b[key]), key
    assert (gw is None) == (rw is None)
    for a, b in zip(gw or (), rw or ()):
        assert a.keys() == b.keys()
        for key in a:
            assert all(torch.equal(x, y) for x, y in zip(a[key], b[key])), key


CASES = {"cold": {}, "warm": dict(warm=True), "batched": dict(batch=(2,), warm=True),
         "classic": dict(n_sweeps=1), "columns2": dict(n_sweeps=2, warm=True),
         "five_sweeps": dict(n_sweeps=5), "layers_no_ground": dict(layers=True, ground=False),
         "narrow_world": dict(nb=8, window=10, warm=True)}


@pytest.mark.parametrize("case", list(CASES))
def test_cpu_tensors_take_the_plain_version(case):
    """On the CPU the stage is the plain version, bit for bit, and
    launches nothing."""
    args = stage_inputs(**CASES[case])
    before = PB.banded_sweeps_cuda.launches
    got = PB.banded_sweeps(**args)
    ref = PB.banded_sweeps_plain(**args)
    assert PB.banded_sweeps_cuda.launches == before
    _equal(got, ref)
    assert int(got[3].sum()) > 0


def test_the_kernel_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        PB.banded_sweeps_cuda(**stage_inputs(warm=True))


def _malformed(name, args):
    """One defect planted in a copy of the arguments."""
    args = dict(args)
    if name == "pos_float64":
        args["pos"] = args["pos"].double()
    elif name == "rot_not_quaternions":
        args["rot"] = args["rot"][..., :3, :]
    elif name == "order_int32":
        args["orders"] = [args["orders"][0].int()] + list(args["orders"][1:])
    elif name == "ranks_int64":
        args["ranks"] = [r.long() for r in args["ranks"]]
    elif name == "column_keys_float":
        args["col_keys"] = [None if c is None else c.float() for c in args["col_keys"]]
    elif name == "radius_on_another_device":
        args["radius"] = torch.empty(NB, device="meta")
    elif name == "occupancy_not_bool":
        args["occ"] = args["occ"].int()
    elif name == "fric_other_bodies":
        args["fric"] = args["fric"][:-1]
    elif name == "too_many_points":
        args["k"] = 9
    elif name == "six_sweeps":
        args["orders"] = list(args["orders"]) * 2
    elif name == "lists_of_other_lengths":
        args["ranks"] = args["ranks"][:-1]
    elif name == "matrix_not_square":
        args["layers"] = (args["layers"][0], torch.ones(5, dtype=torch.bool))
    elif name == "ground_not_per_body":
        gc, f, r = args["ground"]
        args["ground"] = (gc._replace(depth=gc.depth[..., :-1]), f, r)
    elif name == "carry_short":
        lam, glam, rank = args["carry"]
        args["carry"] = (lam[..., :2, :, :, :, :], glam, rank)
    elif name == "carry_ranks_int64":
        lam, glam, rank = args["carry"]
        args["carry"] = (lam, glam, rank.long())
    return args


MALFORMED = ["pos_float64", "rot_not_quaternions", "order_int32", "ranks_int64",
             "column_keys_float", "radius_on_another_device", "occupancy_not_bool",
             "fric_other_bodies", "too_many_points", "six_sweeps", "lists_of_other_lengths",
             "matrix_not_square", "ground_not_per_body", "carry_short", "carry_ranks_int64"]


@pytest.mark.parametrize("name", MALFORMED)
def test_malformed_operands_are_refused(name):
    """The kernel's operand checks (run before anything touches the card)
    raise ValueError on what the kernel does not take."""
    args = stage_inputs(warm=True, layers=True)
    PB._bg_operands(**args)                       # the sound operands pass
    with pytest.raises(ValueError, match="banded grids"):
        PB._bg_operands(**_malformed(name, args))


def test_operands_are_read_through_their_strides():
    """Shared tables reach the kernel with world stride 0, the batch
    flattened to one axis; the carry's sweeps and the ground stream as
    views; the certificate's kind per sweep."""
    args = stage_inputs(batch=(2, 3), warm=True, layers=True)
    call, arr, (batch, nb, g_n), keep = PB._bg_operands(**args)
    assert (batch, nb, g_n) == ((2, 3), NB, 4) and len(keep) == 4
    assert (call.W, call.NB, call.S, call.k, call.K, call.G, call.L) == (6, NB, 4, KP, K, 4, 3)
    assert (call.warm, call.ground, call.layers, call.hulls, call.any_caps) == (1, 1, 1, 0, 1)
    assert (call.pos.w, call.pos.c, call.pos.i) == (3 * NB, NB, 1)
    assert (call.rot.w, call.rot.c) == (4 * NB, NB)
    assert (call.he.w, call.he.c, call.he.i) == (0, NB, 1)
    assert (call.radius.w, call.radius.i) == (0, 1) and call.radius.p == args["radius"].data_ptr()
    assert call.matrix.i == 1 and call.matrix.p == args["layers"][1].data_ptr()
    assert math.isclose(call.g_fric, 0.6, rel_tol=1e-7) and call.g_rest_on == 1
    lam = args["carry"][0]
    assert arr[2].prev_lam.p == lam[:, :, 2].data_ptr()
    assert (arr[2].prev_lam.w, arr[2].prev_lam.c, arr[2].prev_lam.d) == (
        lam.stride(1), lam.stride(3), lam.stride(-2))
    assert arr[1].prev_rank.w == args["carry"][2].stride(1)
    assert all(arr[s].col.p for s in range(4)) and not any(arr[s].window_miss for s in range(4))
    assert call.gc_point.a == NB and call.gc_point.c == 4 * NB
    classic = PB._bg_operands(**stage_inputs(n_sweeps=1, ground=False))
    assert (classic[1][0].window_miss, classic[1][0].col.p, classic[0].ground) == (1, None, 0)
    five = PB._bg_operands(**stage_inputs(n_sweeps=5))[1]
    assert [five[s].window_miss for s in range(5)] == [0] * 5 and five[0].col.p is None


def test_stage_bytes():
    """banded_grids_bytes at the 10k-box drop's shape, counted by hand."""
    w, nb, s, k, k_, g = 4, 10_240, 4, 4, 40, 4
    slots = w * nb * s * k * k_
    want = (slots * (12 + 12 + 4 + 1 + 12 + 12) + w * nb * s * (k_ * 8 + 98 + 4)
            + w * nb * (0 + 1 + 2 + 3) * 4 + w * nb * g * (2 * 29 + 24) + w * nb * 8)
    assert PB.banded_grids_bytes(w, nb, s, k, k_, g) == want
    cold = PB.banded_grids_bytes(w, nb, s, k, k_, g, warm=False)
    assert want - cold == slots * 24 + w * nb * s * 4 + w * nb * g * 24
    assert PB.banded_grids_bytes(1, 10, 1, 1, 1, 0, warm=False) == 10 * 29 + 10 * (8 + 98)
    assert math.isclose(want / 3.35e12 * 1e3, 0.44, rel_tol=0.05)
