"""The port's slice world against the reference's: for one seed, both
packages build the same scene, slot permutation, hierarchy plan, view and
physics statics, and initial device state."""
import numpy as np
import pytest
import torch

from lumixengine_tpu_torch import bridge
from test_torch_bridge import port_world, ref_to_numpy, reference_world

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def worlds():
    return reference_world(), port_world()


def test_host_scene_is_the_same(worlds):
    (_e, rw, _r, _p), (_pe, pw, _pr, _pp) = worlds
    assert pw.entity_count == rw.entity_count
    np.testing.assert_array_equal(pw.alive, rw.alive)
    np.testing.assert_array_equal(pw.parent, rw.parent)
    np.testing.assert_array_equal(pw.local_pos, rw.local_pos)
    np.testing.assert_array_equal(pw.local_rot, rw.local_rot)
    np.testing.assert_array_equal(pw.local_scale, rw.local_scale)


def test_slot_permutation_and_plan(worlds):
    (_e, rw, _r, _p), (_pe, pw, _pr, _pp) = worlds
    rplan, pplan = rw.plan, pw.plan
    np.testing.assert_array_equal(pw.perm, rw._perm)
    np.testing.assert_array_equal(pw._slot_parent, rw._slot_parent)
    np.testing.assert_array_equal(pw._slot_level, rw._slot_level)
    assert len(pplan) == len(rplan) > 0
    for (s0, e0, p0), (s1, e1, p1) in zip(pplan.segments, rplan.segments):
        assert (s0, e0) == (s1, e1)
        np.testing.assert_array_equal(p0, p1)


@pytest.mark.parametrize("field", ["mi_slots", "mi_mask", "mi_model", "radius", "lod_dist2",
                                   "material", "pl_slots", "pl_mask", "cam_slots"])
def test_view_statics(worlds, field):
    (_e, rw, _r, _p), (_pe, pw, _pr, _pp) = worlds
    ref = getattr(rw.modules["renderer"].statics(), field)
    got = getattr(pw.modules["renderer"].statics(), field)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("field", ["pair_a", "pair_b", "pair_budget", "contact_body_a",
                                   "contact_body_b", "friction", "restitution",
                                   "n_contact_slots", "inv_mass", "inv_inertia_body",
                                   "dyn_mask", "entity_slots", "friction_body",
                                   "restitution_body"])
def test_phys_statics(worlds, field):
    (_e, rw, _r, _p), (_pe, pw, _pr, _pp) = worlds
    rst, pst = rw.modules["physics"].statics(), pw.modules["physics"].statics()
    assert rst.pruned and pst.pruned
    ref, got = getattr(rst, field), getattr(pst, field)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_initial_device_state(worlds):
    (_e, rw, _r, _p), (_pe, pw, _pr, _pp) = worlds
    ref = ref_to_numpy(rw.device_state())
    got = bridge.state_to_numpy(pw.device_state("cpu"))
    assert set(got) == {k for k in ref if not bridge.is_skipped(k)}
    for k, v in got.items():
        assert v.dtype == ref[k].dtype, k
        assert v.shape == ref[k].shape, k
        if k.startswith("world."):
            # the derived globals: one compose per level, in either framework
            np.testing.assert_allclose(v, ref[k], rtol=0, atol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(v, ref[k], err_msg=k)


@pytest.mark.parametrize("kw", [{"num_characters": 2}, {"particle_capacity": 16}])
def test_unported_arms_raise(kw):
    """The animation and particle arms (which raised before they were
    ported) build what the reference builds: the same component counts and
    capacities, and an initial state of the same fields, shapes, dtypes and
    values."""
    from lumixengine_tpu.models import demo_scenes as rds
    from lumixengine_tpu_torch.models import demo_scenes as pds

    args = dict(num_entities=64, num_characters=0, num_bodies=24, particle_capacity=0)
    args.update(kw)
    _e, rw, _r, _a, _p = rds.full_frame_world(**args)
    _pe, pw, _pr, _pa, _pp = pds.full_frame_world(**args)
    ran, pan = rw.modules["animation"], pw.modules["animation"]
    for store in ("animables", "animators"):
        r, p = getattr(ran, store), getattr(pan, store)
        assert (len(p), p.capacity) == (len(r), r.capacity)
        np.testing.assert_array_equal(p.entity, r.entity)
    rpe, ppe = rw.modules["renderer"].particle_emitters, pw.modules["renderer"].particle_emitters
    assert {k: (e, ps.caps) for k, (e, ps) in ppe.items()} == \
        {k: (e, ps.caps) for k, (e, ps) in rpe.items()}
    ref = ref_to_numpy(rw.device_state())
    got = bridge.state_to_numpy(pw.device_state("cpu"))
    assert set(got) == {k for k in ref if not bridge.is_skipped(k)}
    for k, v in got.items():
        assert (v.dtype, v.shape) == (ref[k].dtype, ref[k].shape), k
        if k.startswith("world."):
            np.testing.assert_allclose(v, ref[k], rtol=0, atol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(v, ref[k], err_msg=k)
    n_char = args["num_characters"]
    assert len(pan.animables) + len(pan.animators) == n_char
    assert ppe["pe2"][1].caps == {"storm": max(args["particle_capacity"], 1)}


def test_unported_components_raise(worlds):
    _ref, (_pe, pw, _pr, _pp) = worlds
    for ctype, props in (("terrain", dict(terrain=0)),
                         ("property_animator", dict(curves=[])),
                         ("decal", dict(half_extents=(1.0, 1.0, 1.0)))):
        with pytest.raises(NotImplementedError):
            pw.create_component(0, ctype, **props)


def test_time_smoother_matches_reference():
    from lumixengine_tpu.engine.engine import TimeSmoother as RefSmoother
    from lumixengine_tpu_torch.engine.engine import TimeSmoother

    ref, got = RefSmoother(), TimeSmoother()
    rng = np.random.default_rng(0)
    for dt in rng.uniform(0.005, 0.05, 40):
        assert got.push(dt) == ref.push(dt)
