"""Fused contact solve — the prologue in PyTorch, then kernel K2 or its plain
version (counterpart of ``lumixengine_tpu/ops/solver_pallas.py``).

K2 replaces ``lumixengine_tpu/ops/solver_pallas.py::solve_contacts_fused``
(kernel ``_make_kernel``): warm-start impulses, ``iterations`` projected-
Jacobi passes, then ``position_iterations`` split-impulse passes that return
``dpos`` for the caller to add after ``integrate_positions``. The CUDA source
is ``csrc/solver.cu``; its note says what bounds it on the H100 (the
dependent iteration chain and shared-memory atomics) and how one CTA per
world keeps every gather and scatter on chip.

Where the TPU version contracted one-hot incidence matrices, this one reads
``body_a`` / ``body_b`` index vectors (int32 ``[W, C]``, -1 = ground) and
scatters by index. ``solve`` takes the plain version for CPU tensors and
launches K2 for CUDA tensors; there is no fallback between the two.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from lumixengine_tpu_torch.core import math as lm
from lumixengine_tpu_torch.ops import native
from lumixengine_tpu_torch.ops import physics_ops as P

AX = -2
# K2 against solve_plain on the same inputs. The shared-memory atomics only
# reorder float sums (about 1e-6 on an H100); one projection pass too few on
# settled contacts already moves dpos by about 5e-4.
K2_PLAIN_ATOL = 1e-4


@dataclass
class ContactProblem:
    """K2's operands, world-batched: body tensors [W, 3, NB], contact
    vectors [W, 3, C], contact rows [W, C]; inv_mass [NB] is shared."""

    body_a: torch.Tensor       # int32 [W,C]
    body_b: torch.Tensor       # int32 [W,C], -1 = ground
    inv_mass: torch.Tensor     # [NB]
    inv_inertia: torch.Tensor  # [W,3,NB] world diagonal
    vel: torch.Tensor
    angvel: torch.Tensor
    r_a: torch.Tensor
    r_b: torch.Tensor
    n: torch.Tensor
    t1: torch.Tensor
    t2: torch.Tensor
    k_n: torch.Tensor
    k_t1: torch.Tensor
    k_t2: torch.Tensor
    v_target: torch.Tensor
    mu: torch.Tensor
    act: torch.Tensor
    relax: torch.Tensor
    ln0: torch.Tensor
    lt10: torch.Tensor
    lt20: torch.Tensor
    e0_p: torch.Tensor
    relax_p: torch.Tensor
    k_lin: torch.Tensor

    def tensors(self):
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}


def prologue(pos, vel, angvel, contacts: P.Contacts, inv_mass, inv_inertia_world, dt,
             friction, restitution, baumgarte: float = 0.2, slop: float = 0.005,
             relaxation: float = 0.75, warm_lambdas=None,
             proj_relaxation: float = 0.8) -> ContactProblem:
    """Per-contact constants (tangents, effective masses, velocity targets,
    degree-scaled relaxation) — the reference's jnp prologue. Inputs may
    carry any leading batch axes; the problem is flattened to [W, ...]."""
    ba = contacts.body_a.to(torch.int64)
    bb_raw = contacts.body_b.to(torch.int64)
    hasb = bb_raw >= 0
    bb = bb_raw.clamp_min(0)
    hasb3 = hasb.unsqueeze(AX)
    im_a = inv_mass[ba]
    im_b = torch.where(hasb, inv_mass[bb], 0.0)

    n = contacts.normal
    t1, t2 = P.orthonormal_tangents(n)
    pt = contacts.point
    r_a = pt - P.take_vecs(pos, ba)
    r_b = pt - torch.where(hasb3, P.take_vecs(pos, bb), 0.0)
    II_a = P.take_vecs(inv_inertia_world, ba)
    II_b = torch.where(hasb3, P.take_vecs(inv_inertia_world, bb), 0.0)

    def ang_term(r, d, IId):
        rxd = lm.cross(r, d, axis=AX)
        return torch.sum(lm.cross(IId * rxd, r, axis=AX) * d, dim=AX)

    k_n = torch.clamp_min(im_a + im_b + ang_term(r_a, n, II_a) + ang_term(r_b, n, II_b), 1e-9)
    k_t1 = torch.clamp_min(im_a + im_b + ang_term(r_a, t1, II_a) + ang_term(r_b, t1, II_b), 1e-9)
    k_t2 = torch.clamp_min(im_a + im_b + ang_term(r_a, t2, II_a) + ang_term(r_b, t2, II_b), 1e-9)
    bias = (baumgarte / dt) * torch.clamp_min(contacts.depth - slop, 0.0)
    va = P.take_vecs(vel, ba) + lm.cross(P.take_vecs(angvel, ba), r_a, axis=AX)
    vb = (torch.where(hasb3, P.take_vecs(vel, bb), 0.0)
          + lm.cross(torch.where(hasb3, P.take_vecs(angvel, bb), 0.0), r_b, axis=AX))
    vn0 = torch.sum((vb - va) * n, dim=AX)
    # restitution and Baumgarte bias do not stack (max, not sum)
    v_target = torch.maximum(bias, torch.where(vn0 < -0.5, -restitution * vn0, 0.0))
    act = contacts.active.to(torch.float32)

    # active-contact degree per body, both sides; per contact the larger end
    batch = torch.broadcast_shapes(act.shape[:-1], pos.shape[:-2])
    nb = pos.shape[-1]
    act_b = act.expand(batch + act.shape[-1:])
    ba_b = ba.expand(act_b.shape)
    bb_b = bb.expand(act_b.shape)
    hasb_b = hasb.expand(act_b.shape)
    deg = torch.zeros(batch + (nb,), dtype=torch.float32, device=act.device)
    deg = deg.scatter_add(-1, ba_b, act_b).scatter_add(-1, bb_b, act_b * hasb_b)
    deg_c = torch.clamp_min(torch.maximum(torch.gather(deg, -1, ba_b),
                                          torch.where(hasb_b, torch.gather(deg, -1, bb_b), 0.0)),
                            1.0)
    relax_c = torch.clamp_max(1.6 / deg_c, relaxation)
    relax_p = torch.clamp_max(1.6 / deg_c, proj_relaxation)
    e0_p = torch.where(contacts.active, torch.clamp_min(contacts.depth - slop, 0.0), 0.0)
    k_lin = torch.clamp_min(im_a + im_b, 1e-9)

    c = pt.shape[-1]
    zeros = torch.zeros(batch + (c,), dtype=torch.float32, device=act.device)
    warm = (zeros, zeros, zeros) if warm_lambdas is None else warm_lambdas

    def rows(x):
        return x.expand(batch + (c,)).reshape(-1, c).contiguous()

    def vecs(x, m):
        return x.expand(batch + (3, m)).reshape(-1, 3, m).contiguous()

    return ContactProblem(
        body_a=rows(ba).to(torch.int32), body_b=rows(bb_raw).to(torch.int32),
        inv_mass=inv_mass.contiguous(), inv_inertia=vecs(inv_inertia_world, nb),
        vel=vecs(vel, nb), angvel=vecs(angvel, nb),
        r_a=vecs(r_a, c), r_b=vecs(r_b, c), n=vecs(n, c), t1=vecs(t1, c), t2=vecs(t2, c),
        k_n=rows(k_n), k_t1=rows(k_t1), k_t2=rows(k_t2), v_target=rows(v_target),
        mu=rows(friction), act=rows(act), relax=rows(relax_c),
        ln0=rows(warm[0]), lt10=rows(warm[1]), lt20=rows(warm[2]),
        e0_p=rows(e0_p), relax_p=rows(relax_p), k_lin=rows(k_lin))


def solve_plain(p: ContactProblem, iterations: int, position_iterations: int):
    """K2's plain PyTorch version. Returns (vel, angvel, dpos [W,3,NB],
    ln, lt1, lt2 [W,C])."""
    w_, _, nb = p.vel.shape
    c = p.act.shape[-1]
    ba = p.body_a.to(torch.int64)
    hasb = p.body_b >= 0
    bb = p.body_b.to(torch.int64).clamp_min(0)
    ia3 = ba[:, None, :].expand(w_, 3, c)
    ib3 = bb[:, None, :].expand(w_, 3, c)
    hasb3 = hasb[:, None, :]
    im = p.inv_mass
    act, act3 = p.act, p.act[:, None, :]

    def gath_b(x):
        return torch.where(hasb3, torch.gather(x, -1, ib3), 0.0)

    def scatter(x, idx3, rows):  # [W,3,C] → [W,3,NB]
        return torch.zeros((w_, rows, nb), dtype=x.dtype, device=x.device).scatter_add_(-1, idx3, x)

    def apply(v, w, imp):
        tb = lm.cross(p.r_b, imp, axis=AX)
        ta = lm.cross(p.r_a, imp, axis=AX)
        dv = scatter(torch.where(hasb3, imp, 0.0), ib3, 3) - scatter(imp, ia3, 3)
        dw = scatter(torch.where(hasb3, tb, 0.0), ib3, 3) - scatter(ta, ia3, 3)
        return v + dv * im, w + dw * p.inv_inertia

    def rel_vel(v, w):
        va = torch.gather(v, -1, ia3) + lm.cross(torch.gather(w, -1, ia3), p.r_a, axis=AX)
        vb = gath_b(v) + lm.cross(gath_b(w), p.r_b, axis=AX)
        return vb - va

    ln = torch.clamp_min(p.ln0, 0.0) * act
    lt1 = p.lt10 * act
    lt2 = p.lt20 * act
    warm_imp = p.n * ln[:, None] + p.t1 * lt1[:, None] + p.t2 * lt2[:, None]
    warm_imp = torch.where(act3 > 0.0, warm_imp, 0.0)
    v, w = apply(p.vel, p.angvel, warm_imp)
    for _ in range(iterations):
        vr = rel_vel(v, w)
        vn = torch.sum(vr * p.n, dim=AX)
        dln = (p.v_target - vn) / p.k_n * p.relax
        new_ln = torch.clamp_min(ln + dln, 0.0)
        dln = (new_ln - ln) * act
        vt1 = torch.sum(vr * p.t1, dim=AX)
        vt2 = torch.sum(vr * p.t2, dim=AX)
        max_f = p.mu * (ln + dln)
        new_lt1 = torch.minimum(torch.maximum(lt1 + (-vt1 / p.k_t1) * p.relax, -max_f), max_f)
        new_lt2 = torch.minimum(torch.maximum(lt2 + (-vt2 / p.k_t2) * p.relax, -max_f), max_f)
        dlt1 = (new_lt1 - lt1) * act
        dlt2 = (new_lt2 - lt2) * act
        imp = p.n * dln[:, None] + p.t1 * dlt1[:, None] + p.t2 * dlt2[:, None]
        v, w = apply(v, w, imp)
        ln, lt1, lt2 = ln + dln, lt1 + dlt1, lt2 + dlt2

    dpos = torch.zeros_like(p.vel)
    lam = torch.zeros_like(act)
    for _ in range(position_iterations):
        sep = torch.sum((gath_b(dpos) - torch.gather(dpos, -1, ia3)) * p.n, dim=AX)
        dlam = (p.e0_p - sep) / p.k_lin * p.relax_p
        new_lam = torch.clamp_min(lam + dlam, 0.0)
        dlam = (new_lam - lam) * act
        step = p.n * dlam[:, None]
        dpos = dpos + (scatter(torch.where(hasb3, step, 0.0), ib3, 3) - scatter(step, ia3, 3)) * im
        lam = new_lam
    return v, w, dpos, ln, lt1, lt2


def solve_cuda(p: ContactProblem, iterations: int, position_iterations: int):
    """Launch K2 on the current stream. Same contract as solve_plain."""
    dev = p.vel.device
    w_, three, nb = p.vel.shape
    c = p.act.shape[-1]
    for name, t in p.tensors().items():
        want = torch.int32 if name in ("body_a", "body_b") else torch.float32
        if t.dtype != want:
            raise ValueError(f"{name} must be {want}, got {t.dtype}")
    shapes = {"inv_mass": (nb,), "inv_inertia": (w_, 3, nb), "angvel": (w_, 3, nb)}
    for name in ("r_a", "r_b", "n", "t1", "t2"):
        shapes[name] = (w_, 3, c)
    for name in ("body_a", "body_b", "k_n", "k_t1", "k_t2", "v_target", "mu", "act", "relax",
                 "ln0", "lt10", "lt20", "e0_p", "relax_p", "k_lin"):
        shapes[name] = (w_, c)
    for name, shape in shapes.items():
        if tuple(getattr(p, name).shape) != shape:
            raise ValueError(f"{name} has shape {tuple(getattr(p, name).shape)}, expected {shape}")
    native.check_operands(dev, **p.tensors())
    lib = native.library()
    if lib.lumix_solve_contacts_smem(nb) > 48 * 1024:
        raise ValueError(f"K2 keeps the bodies in 48 KB of shared memory: NB={nb} is too many")
    vel = torch.empty_like(p.vel)
    ang = torch.empty_like(p.vel)
    dpos = torch.empty_like(p.vel)
    ln, lt1, lt2, lam_p = (torch.empty_like(p.act) for _ in range(4))
    t = p.tensors()
    ptrs = [t[f.name].data_ptr() for f in dataclasses.fields(ContactProblem)]
    rc = lib.lumix_solve_contacts(*ptrs, vel.data_ptr(), ang.data_ptr(), dpos.data_ptr(),
                                  ln.data_ptr(), lt1.data_ptr(), lt2.data_ptr(), lam_p.data_ptr(),
                                  w_, nb, c, int(iterations), int(position_iterations),
                                  native.stream_handle(dev))
    native.check(rc, "lumix_solve_contacts")
    solve_cuda.launches += 1
    return vel, ang, dpos, ln, lt1, lt2


solve_cuda.launches = 0  # kernel launches, counted where K2 is launched


def solve(p: ContactProblem, iterations: int, position_iterations: int):
    """CPU tensors take the plain version; CUDA tensors launch K2."""
    dev = p.vel.device
    if dev.type == "cpu":
        return solve_plain(p, iterations, position_iterations)
    if dev.type == "cuda":
        return solve_cuda(p, iterations, position_iterations)
    raise ValueError(f"solve: unsupported device {dev}")


def solve_contacts_fused(pos, vel, angvel, contacts: P.Contacts, inv_mass, inv_inertia_world,
                         dt, friction, restitution, iterations: int = 8,
                         position_iterations: int = 0, **prologue_kw):
    """Prologue + K2 for states with any leading batch axes. Returns
    (vel, angvel, (lam_n, lam_t1, lam_t2), dpos) in the input's batch shape."""
    prob = prologue(pos, vel, angvel, contacts, inv_mass, inv_inertia_world, dt,
                    friction, restitution, **prologue_kw)
    v, w, dpos, ln, lt1, lt2 = solve(prob, iterations, position_iterations)
    batch = torch.broadcast_shapes(contacts.active.shape[:-1], pos.shape[:-2])
    nb, c = pos.shape[-1], ln.shape[-1]
    body = lambda x: x.reshape(batch + (3, nb))  # noqa: E731
    row = lambda x: x.reshape(batch + (c,))  # noqa: E731
    return body(v), body(w), (row(ln), row(lt1), row(lt2)), body(dpos)
