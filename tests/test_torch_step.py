"""The port as a whole: a reference world at frame 120 (bodies resting,
contacts active), bridged into the port, then 3 frames of
build_step(extra=cull_pass) in both packages, compared field by field — the
slice world (no characters, a 1-slot emitter), and the full flagship at
test size (characters, particles), with half of the animation clocks set
to wrap in the second frame. The reference runs its fused Pallas solver in
interpret mode, the semantics kernel K2 ports."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lumixengine_tpu.parallel.mesh import replicate_state as ref_replicate
from lumixengine_tpu_torch import bridge
from lumixengine_tpu_torch.models import demo_scenes as pds
from lumixengine_tpu_torch.parallel.mesh import replicate_state
from test_torch_animation import FLAGSHIP_TEST, near_wrap
from test_torch_bridge import (DT, assert_masks_agree, cull_margins, port_world, ref_from_numpy,
                               ref_to_numpy, reference_step, settled_reference, use_fused_solver)

torch.set_num_threads(1)

FRAMES = 3
TRANSFORM_ATOL = 1e-5   # entities the physics does not move
BODY_POS_ATOL = 1e-3    # physics pos/rot: solver sums reordered, 3 frames
BODY_VEL_ATOL = 5e-3    # the JAX package's own fused-vs-jnp bound
CLOCK_ATOL = 0.0       # animation clocks: adds and fmod, the same ops
POSE_ATOL = 1e-5       # poses, palettes: 13-level compose chains
PARTICLE_ATOL = 1e-4   # particle channels up to ~50 m (1 ulp 3.8e-6)
P = "modules.physics."
R = "modules.renderer."
A = "modules.animation."


def _body_mask(pworld, n_slots):
    pst = pworld.modules["physics"].statics()
    mask = np.zeros(n_slots, bool)
    mask[pst.entity_slots[pst.dyn_mask]] = True
    return mask


def _close(name, got, ref, atol, errs):
    errs[name] = max(errs.get(name, 0.0), float(np.abs(got - ref).max(initial=0.0)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol, err_msg=name)


def compare(pworld, pstate, got, ref, errs):
    n = got["alive"].shape[-1]
    body = _body_mask(pworld, n)
    for xf in ("local", "world"):
        for f in ("pos", "rot", "scale"):
            k = f"{xf}.{f}"
            _close(k, got[k][..., ~body], ref[k][..., ~body], TRANSFORM_ATOL, errs)
            _close(k + "[bodies]", got[k][..., body], ref[k][..., body], BODY_POS_ATOL, errs)
    mi_body = body[pworld.modules["renderer"].statics().mi_slots.clip(0)]
    for f in ("prev_pos", "prev_rot"):
        _close(R + f, got[R + f][..., ~mi_body], ref[R + f][..., ~mi_body], TRANSFORM_ATOL, errs)
        _close(R + f + "[bodies]", got[R + f][..., mi_body], ref[R + f][..., mi_body],
               BODY_POS_ATOL, errs)
    for f in ("pos", "rot"):
        _close(P + f, got[P + f], ref[P + f], BODY_POS_ATOL, errs)
    for f in ("vel", "angvel", "lam_n", "lam_t1", "lam_t2"):
        _close(P + f, got[P + f], ref[P + f], BODY_VEL_ATOL, errs)
    for k in (P + "sleep", P + "pair_key", P + "counters.pruned_pair_miss",
              P + "counters.sap_window_miss", P + "counters.active_contacts", "frame", "alive",
              "parent", "level"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    np.testing.assert_allclose(got["time"], ref["time"], rtol=1e-7)

    mi_m, lod_m, light_m = cull_margins(pworld, pstate)
    flips = {name: assert_masks_agree(name, got[R + name], ref[R + name], m)
             for name, m in (("mi_visible", mi_m), ("mi_lod", lod_m), ("pl_visible", light_m))}
    for counter, mask in (("visible_count", "mi_visible"), ("lights_visible", "pl_visible")):
        np.testing.assert_array_equal(got[R + "counters." + counter], got[R + mask].sum(-1))
        diff = np.abs(got[R + "counters." + counter].astype(np.int64)
                      - ref[R + "counters." + counter])
        assert diff.sum() <= flips[mask]
    return flips


@pytest.mark.parametrize("num_worlds", [1, 4])
def test_three_frames_match_reference(num_worlds, monkeypatch):
    engine, rworld, rstate = settled_reference()
    if num_worlds > 1:
        rstate = ref_replicate(rstate, num_worlds, jax.random.PRNGKey(0))
    use_fused_solver(monkeypatch, rworld)
    rstep = reference_step(engine, rworld, batched=num_worlds > 1)
    pengine, pworld, _pr, _pp = port_world()
    pstep = pengine.build_step(pworld, "cpu", extra=pworld.modules["renderer"].cull_pass)
    pstate = bridge.state_from_numpy(ref_to_numpy(rstate), "cpu")
    errs, flips, active = {}, [], []
    for _ in range(FRAMES):
        rstate = rstep(rstate, jnp.float32(DT))
        pstate = pstep(pstate, DT)
        got, ref = bridge.state_to_numpy(pstate), ref_to_numpy(rstate)
        flips.append(compare(pworld, pstate, got, ref, errs))
        active.append(int(got[P + "counters.active_contacts"].sum()))
    print(f"W={num_worlds}: active contacts per frame {active}, boundary flips {flips}")
    print("max abs err", {k: v for k, v in errs.items() if v > 0})
    assert min(active) > 0
    assert np.all(got[R + "counters.visible_count"] > 0)


@functools.lru_cache(maxsize=None)
def settled_flagship(frames: int = 120):
    """(engine, world, state) of the reference flagship at test size after
    `frames` frames of its normal CPU step (bodies down, particles falling,
    characters walking)."""
    from lumixengine_tpu.models import demo_scenes as rds

    engine, world, *_ = rds.full_frame_world(*FLAGSHIP_TEST)
    step = reference_step(engine, world, batched=False)
    run = jax.jit(lambda s: jax.lax.fori_loop(0, frames, lambda i, s: step(s, jnp.float32(DT)), s))
    return engine, world, jax.block_until_ready(run(world.device_state()))


def compare_arms(got, ref, errs):
    """The animation and particle fields and counters; returns the names
    checked."""
    checked = set()

    def close(k, atol):
        checked.add(k)
        _close(k, got[k], ref[k], atol, errs)

    def equal(k):
        checked.add(k)
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)

    for k in ("an_time", "ctrl_clocks", "ctrl_inputs"):
        close(A + k, CLOCK_ATOL)
    for k in ("pose_pos", "pose_rot", "palette"):
        close(A + k, POSE_ATOL)
    for k in ("pa_enabled", "counters.animated"):
        equal(A + k)
    for k in sorted(got):
        if k.startswith(R + "particles."):
            if k.endswith((".channels", ".outs")):
                close(k, PARTICLE_ATOL)
            else:
                equal(k)  # alive, emit_acc and the counters
    for k in ("prng", "counters.particles_alive", "counters.particles_emitted",
              "counters.particles_killed"):
        equal(R + k)
    return checked


@pytest.mark.parametrize("num_worlds", [1, 4])
def test_flagship_three_frames_match_reference(num_worlds, monkeypatch):
    """The full flagship at test size (512 entities, 8 characters, 32
    bodies — still the pruned physics branch —, 256 particles): every field
    the bridge carries."""
    engine, rworld, rstate = settled_flagship()
    if num_worlds > 1:
        rstate = ref_replicate(rstate, num_worlds, jax.random.PRNGKey(0))
    pengine, pworld, _pr, panim, _pp = pds.full_frame_world(*FLAGSHIP_TEST)
    assert pworld.modules["physics"].statics().pruned
    tree = near_wrap(ref_to_numpy(rstate), panim, pworld.modules, lead=1.5)
    rstate = ref_from_numpy(rstate, tree)
    use_fused_solver(monkeypatch, rworld)
    rstep = reference_step(engine, rworld, batched=num_worlds > 1)
    pstep = pengine.build_step(pworld, "cpu", extra=pworld.modules["renderer"].cull_pass)
    pstate = bridge.state_from_numpy(tree, "cpu")
    errs, killed = {}, []
    for _ in range(FRAMES):
        rstate = rstep(rstate, jnp.float32(DT))
        pstate = pstep(pstate, DT)
        got, ref = bridge.state_to_numpy(pstate), ref_to_numpy(rstate)
        assert set(got) == {k for k in ref if not bridge.is_skipped(k)}
        compare(pworld, pstate, got, ref, errs)
        checked = compare_arms(got, ref, errs)
        # every other field the bridge carries (the render components,
        # culling radii, counters, ...) is the same, bit for bit
        toleranced = {f"{xf}.{f}" for xf in ("local", "world") for f in ("pos", "rot", "scale")}
        toleranced |= {R + "prev_pos", R + "prev_rot", "time"}
        toleranced |= {P + f for f in ("pos", "rot", "vel", "angvel", "lam_n", "lam_t1", "lam_t2")}
        for k in sorted(set(got) - checked - toleranced):
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        killed.append(int(got[R + "counters.particles_killed"].sum()))
    print(f"W={num_worlds}: particles killed {killed}; max abs err",
          {k: v for k, v in errs.items() if v > 0})
    wrapped = got[A + "ctrl_clocks"][..., ::2] < tree[A + "ctrl_clocks"][..., ::2]
    assert wrapped.all()
    assert killed[-1] > 0 and np.all(got[R + "counters.particles_alive"] > 0)
    assert np.all(got[A + "counters.animated"] == 4)
    assert np.all(got[P + "counters.active_contacts"] > 0)
    moved = np.abs(got["local.pos"] - tree["local.pos"]).max(axis=-2)
    assert np.count_nonzero(moved) > 0


def test_replicate_state_diverges_worlds():
    """The port's own batch replication: seeded, per-world noise of the
    reference's magnitudes, worlds that step apart."""
    pengine, pworld, _pr, _pp = port_world()
    state = pworld.device_state("cpu")
    a = replicate_state(state, 3, torch.Generator().manual_seed(5))
    b = replicate_state(state, 3, torch.Generator().manual_seed(5))
    plain = replicate_state(state, 3)
    assert torch.equal(a.local.pos, b.local.pos)
    assert torch.equal(plain.local.pos[1], state.local.pos)
    noise = (a.local.pos - plain.local.pos).std().item()
    assert 0.005 < noise < 0.02
    dv = (a.modules["physics"].vel - plain.modules["physics"].vel).std().item()
    assert 0.025 < dv < 0.1
    sleep = a.modules["physics"].sleep
    assert int(sleep.min()) >= 0 and int(sleep.max()) < 16 and int(sleep.max()) > 0
    step = pengine.build_step(pworld, "cpu", extra=pworld.modules["renderer"].cull_pass)
    for _ in range(2):
        a = step(a, DT)
    assert a.frame.tolist() == [2, 2, 2]
    assert not torch.equal(a.modules["physics"].pos[0], a.modules["physics"].pos[1])
    for t in bridge.state_to_numpy(a).values():
        assert np.all(np.isfinite(t)) if t.dtype.kind == "f" else True
