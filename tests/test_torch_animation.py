"""The animation arm of the port against the JAX package: the baked
flagship clip bank, clip sampling and root-motion tracks, the pose ops and
palettes on random poses, the Blend1D weights, and one frame of the
animation module's update_parallel (animators) and update (animables) on
the flagship at test size, with clocks started just before their clip's
end so that the root motion wraps.

Tolerances: host bakes, frame indices, lerp weights and clocks exact;
sampled poses SAMPLE_ATOL (the reference's two-hot matmul vs a gather and
lerp: the two products and their sum round differently); composed poses,
palettes and root-motion transforms POSE_ATOL (13-level compose chains)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lumixengine_tpu.animation import controller as rctl
from lumixengine_tpu.models import demo_scenes as rds
from lumixengine_tpu.ops import pose as rpose
from lumixengine_tpu.ops import sampling as rsamp
from lumixengine_tpu.ops import skinning as rskin
from lumixengine_tpu_torch import bridge
from lumixengine_tpu_torch.animation import controller as pctl
from lumixengine_tpu_torch.models import demo_scenes as pds
from lumixengine_tpu_torch.ops import pose as ppose
from lumixengine_tpu_torch.ops import sampling as psamp
from lumixengine_tpu_torch.ops import skinning as pskin
from test_torch_bridge import ref_from_numpy, ref_to_numpy

torch.set_num_threads(1)

SAMPLE_ATOL = 1e-6
POSE_ATOL = 1e-5
DT = np.float32(1.0 / 60.0)
FLAGSHIP_TEST = (512, 8, 32, 256)


@pytest.fixture(scope="module")
def systems():
    """(reference anim system, port anim system) of build_engine(with_animation=True)."""
    return rds.build_engine(with_animation=True)[2], pds.build_engine(with_animation=True)[2]


def test_baked_bank_is_the_reference_s(systems):
    ra, pa = systems
    assert ra.max_bones == pa.max_bones == 32
    np.testing.assert_array_equal(pa.bank.table, np.asarray(ra.bank.table))
    np.testing.assert_array_equal(pa.bank.root_motion, np.asarray(ra.bank.root_motion))
    for f in ("clip_offset", "clip_frames", "clip_fps", "clip_length", "clip_flags",
              "root_end_pos", "root_end_rot"):
        np.testing.assert_array_equal(getattr(pa.bank_statics, f), getattr(ra.bank_statics, f))


def _times_and_clips(worlds=3, a=16, seed=0):
    rng = np.random.default_rng(seed)
    t = rng.uniform(-1.0, 3.0, (worlds, a)).astype(np.float32)
    t[:, :3] = [0.0, 1.0, 2.0 / 3.0]          # exactly at a clip's length or start
    clips = rng.integers(-1, 3, a).astype(np.int32)
    clips[:4] = [0, 1, 2, -1]
    return t, clips


def test_frame_weights(systems):
    ra, pa = systems
    t, clips = _times_and_clips()
    st = ra.bank_statics
    ref = jax.vmap(lambda tt: rsamp.frame_weights(
        tt, jnp.asarray(clips), st.clip_offset, st.clip_frames, st.clip_fps,
        st.clip_length))(jnp.asarray(t))
    got = psamp.frame_weights(torch.tensor(t), torch.tensor(clips).long(),
                              pa.bank_statics.on("cpu"))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_sample_clips_and_root_motion(systems):
    ra, pa = systems
    t, clips = _times_and_clips()
    st = ra.bank_statics
    rp, rr = jax.vmap(lambda tt: rsamp.sample_clips(ra.bank.table, tt, jnp.asarray(clips), st))(
        jnp.asarray(t))
    pp, pr = psamp.sample_clips(pa.bank.on("cpu"), torch.tensor(t), torch.tensor(clips).long(),
                                pa.bank_statics.on("cpu"))
    assert pp.shape == (3, 3, 32, 16) and pr.shape == (3, 4, 32, 16)
    np.testing.assert_allclose(pp.numpy(), np.asarray(rp), rtol=0, atol=SAMPLE_ATOL)
    np.testing.assert_allclose(pr.numpy(), np.asarray(rr), rtol=0, atol=SAMPLE_ATOL)
    rp, rr = jax.vmap(lambda tt: rsamp.sample_root_motion(
        ra.bank.root_motion, tt, jnp.asarray(clips), st))(jnp.asarray(t))
    pp, pr = psamp.sample_root_motion(pa.bank.on("cpu"), torch.tensor(t),
                                      torch.tensor(clips).long(), pa.bank_statics.on("cpu"))
    np.testing.assert_allclose(pp.numpy(), np.asarray(rp), rtol=0, atol=SAMPLE_ATOL)
    np.testing.assert_allclose(pr.numpy(), np.asarray(rr), rtol=0, atol=SAMPLE_ATOL)
    assert np.abs(np.asarray(rp)).max() > 0.1   # the walk and run clips travel


def _random_pose(worlds=2, b=32, a=12, seed=1):
    rng = np.random.default_rng(seed)
    pos = rng.normal(0, 0.3, (worlds, 3, b, a)).astype(np.float32)
    rot = rng.normal(size=(worlds, 4, b, a)).astype(np.float32)
    rot /= np.linalg.norm(rot, axis=1, keepdims=True)
    return pos, rot


def test_compute_absolute_and_palette(systems):
    ra, pa = systems
    from lumixengine_tpu.renderer.model import make_humanoid_skeleton

    sk = make_humanoid_skeleton(32, seed=7)
    pos, rot = _random_pose()
    rplan, pplan = rpose.BonePlan(sk.bone_parent), ppose.BonePlan(sk.bone_parent)
    assert len(pplan.levels) == len(rplan.levels) == 13
    ra_, rr_ = rpose.compute_absolute(jnp.asarray(pos), jnp.asarray(rot), rplan)
    pa_, pr_ = ppose.compute_absolute(torch.tensor(pos), torch.tensor(rot), pplan)
    np.testing.assert_allclose(pa_.numpy(), np.asarray(ra_), rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(pr_.numpy(), np.asarray(rr_), rtol=0, atol=POSE_ATOL)
    ibp, ibr = (np.ascontiguousarray(x.T) for x in sk.inverse_bind())
    ref = rskin.build_palette_dq(ra_, rr_, jnp.asarray(ibp), jnp.asarray(ibr))
    got = pskin.build_palette_dq(pa_, pr_, torch.tensor(ibp), torch.tensor(ibr))
    assert got.shape == (2, 8, 32, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=POSE_ATOL)


@pytest.mark.parametrize("t_kind", ["scalar", "per_animator"])
def test_blend_and_masked_blend(t_kind):
    pa_, ra_ = _random_pose(seed=2)
    pb, rb = _random_pose(seed=3)
    t = 0.3 if t_kind == "scalar" else np.random.default_rng(4).uniform(
        0, 1, (2, 12)).astype(np.float32)
    tr = t if t_kind == "scalar" else jnp.asarray(t)
    tp = t if t_kind == "scalar" else torch.tensor(t)
    ref = rpose.blend(jnp.asarray(pa_), jnp.asarray(ra_), jnp.asarray(pb), jnp.asarray(rb), tr)
    got = ppose.blend(*(torch.tensor(x) for x in (pa_, ra_, pb, rb)), tp)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=SAMPLE_ATOL)
    mask = np.arange(32) % 3 == 0
    ref = rpose.masked_blend(jnp.asarray(pa_), jnp.asarray(ra_), jnp.asarray(pb),
                             jnp.asarray(rb), tr, mask)
    got = ppose.masked_blend(*(torch.tensor(x) for x in (pa_, ra_, pb, rb)), tp,
                             torch.tensor(mask))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=SAMPLE_ATOL)
    np.testing.assert_array_equal(got[0].numpy()[:, :, ~mask], pa_[:, :, ~mask])


def _locomotion(mod, statics):
    return mod.Controller("locomotion", statics, mod.Blend1D(
        mod.Input(0), [(0.0, mod.AnimationNode(0)), (1.5, mod.AnimationNode(1)),
                       (4.0, mod.AnimationNode(2))]), inputs=["speed"])


def test_blend1d_weights(systems):
    """At, between and beyond the points 0, 1.5, 4: weights of the three
    slots, their clocks and the new clocks, both packages."""
    ra, pa = systems
    speed = np.array([[-1.0, 0.0, 0.75, 1.5, 2.75, 4.0, 5.0, 1e-7, 3.9999]], np.float32)
    clocks = np.random.default_rng(5).uniform(0, 1, (3, speed.shape[1])).astype(np.float32)
    clocks[:, 0] = [1.0 - 0.5 * DT, 1.0 - 0.5 * DT, 2.0 / 3.0 - 0.5 * DT]  # wrap this frame
    rs, _, rc = _locomotion(rctl, ra.bank_statics).eval(jnp.asarray(speed), jnp.asarray(clocks),
                                                        jnp.float32(DT))
    ps, masks, pc = _locomotion(pctl, pa.bank_statics).eval(torch.tensor(speed),
                                                            torch.tensor(clocks), torch.tensor(DT))
    assert not masks and len(ps) == len(rs) == 3
    np.testing.assert_array_equal(pc.numpy(), np.asarray(rc))
    for (pcl, pt, pw, pprev), (rcl, rt, rw, rprev) in zip(ps, rs):
        np.testing.assert_array_equal(pcl.numpy(), np.asarray(rcl))
        for g, r in ((pt, rt), (pw, rw), (pprev, rprev)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    w = np.stack([s[2].numpy() for s in ps])
    np.testing.assert_array_equal(w[:, :2], [[1, 1], [0, 0], [0, 0]])      # at/below 0: idle
    np.testing.assert_array_equal(w[:, 3], [0, 1, 0])                       # at 1.5: walk
    np.testing.assert_array_equal(w[:, 5:7], [[0, 0], [0, 0], [1, 1]])     # at/beyond 4: run
    np.testing.assert_allclose(w[:, 2], [0.5, 0.5, 0.0])
    np.testing.assert_allclose(w.sum(0), 1.0, rtol=1e-6)
    assert (pc.numpy()[:, 0] < clocks[:, 0]).all()                          # wrapped


def test_unported_nodes_raise():
    """Select, Switch, Blend2D, IKNode and Layers build, set up their clock
    rows as the reference's do, and evaluate to slots
    (tests/test_torch_anim_ext.py holds them to the reference's values)."""
    leaf = pctl.AnimationNode
    nodes = {
        "Select": pctl.Select(pctl.Input(0), [leaf(0), leaf(1)]),
        "Switch": pctl.Switch(pctl.Input(0), leaf(0), leaf(1)),
        "Blend2D": pctl.Blend2D(pctl.Input(0), pctl.Input(1),
                                [((0.0, 1.0), leaf(0)), ((1.0, 0.0), leaf(1))]),
        "IKNode": pctl.IKNode(leaf(0), chain=[0, 1, 2], target_inputs=(0, 1, 2)),
        "Layers": pctl.Layers([(leaf(0), None, 1.0), (leaf(1), np.ones(32, bool), 0.5)]),
    }
    statics = pds.build_engine(with_animation=True)[2].bank_statics
    for name, node in nodes.items():
        ctrl = pctl.Controller(name, statics, node, inputs=["a", "b", "c"])
        assert ctrl.num_clocks == {"Select": 5, "Switch": 5, "IKNode": 1}.get(name, 2), name
        assert (ctrl.ik_requests == [node]) == (name == "IKNode")
        slots, masks, clocks = ctrl.eval(torch.zeros(3, 4), torch.zeros(ctrl.num_clocks, 4),
                                         torch.tensor(DT))
        assert len(slots) == (1 if name == "IKNode" else 2) and clocks.shape[0] == ctrl.num_clocks
        assert (1 in masks) == (name == "Layers")


@pytest.fixture(scope="module")
def flagship_pair():
    return rds.full_frame_world(*FLAGSHIP_TEST), pds.full_frame_world(*FLAGSHIP_TEST)


def near_wrap(tree, anim_sys, modules, lead=0.5):
    """Move the clocks of every other animator and animable column (the
    last axis; any leading world axis too) to `lead` frames before the end
    of their clip, so that they wrap `lead` + 0.5 frames later."""
    lengths = np.asarray(anim_sys.bank_statics.clip_length)
    clocks = tree["modules.animation.ctrl_clocks"].copy()
    clocks[..., ::2] = (lengths - lead * DT)[:, None]
    tree["modules.animation.ctrl_clocks"] = clocks
    an = modules["animation"].animables
    t = tree["modules.animation.an_time"].copy()
    clip = an.data["clip"]
    sel = (an.entity >= 0) & (np.arange(an.capacity) % 2 == 0)
    t[..., sel] = lengths[clip[sel]] - lead * DT
    tree["modules.animation.an_time"] = t
    return tree


@pytest.mark.parametrize("phase", ["update_parallel", "update"])
def test_one_frame_of_the_module(flagship_pair, phase):
    (re, rw, _rr, ra, _rp), (pe, pw, _pr, pa, _pp) = flagship_pair
    rw.modules["animation"].prepare_statics()
    pw.modules["animation"].prepare_statics("cpu")
    tree = near_wrap(ref_to_numpy(rw.device_state()), pa, pw.modules)
    rstate = ref_from_numpy(rw.device_state(), tree)
    pstate = bridge.state_from_numpy(tree, "cpu")
    rfn = jax.jit(lambda s: getattr(rw.modules["animation"], phase)(s, jnp.float32(DT)))
    ref = ref_to_numpy(rfn(rstate))
    got = bridge.state_to_numpy(getattr(pw.modules["animation"], phase)(pstate,
                                                                      torch.tensor(DT)))
    for k in ("an_time", "ctrl_clocks", "ctrl_inputs", "counters.animated"):
        k = "modules.animation." + k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for k in ("pose_pos", "pose_rot", "palette"):
        k = "modules.animation." + k
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=POSE_ATOL, err_msg=k)
    for k in ("local.pos", "local.rot"):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=POSE_ATOL, err_msg=k)
    moved = np.abs(got["local.pos"] - tree["local.pos"]).max(axis=0)
    if phase == "update_parallel":
        clocks = got["modules.animation.ctrl_clocks"]
        assert (clocks[:, ::2] < tree["modules.animation.ctrl_clocks"][:, ::2]).all()  # wrapped
        assert np.count_nonzero(moved) > 0       # root motion moved the animators
    else:
        assert not moved.any()
        assert int(got["modules.animation.counters.animated"]) == 4
