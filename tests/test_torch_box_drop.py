"""The 10k-box drop as a rendered world (``demo_scenes.box_drop_world``) at
test size: the engine's own step takes the PhysicsModule's banded branch,
the bodies are ``physics_scenes.box_block``'s, and one frame records each
span of the banded stages once, which the pruned flagship records none of."""
import threading
import time

import pytest
import torch

from lumixengine_tpu_torch.core import profiler
from lumixengine_tpu_torch.models import demo_scenes as DS
from lumixengine_tpu_torch.models import physics_scenes as PS
from lumixengine_tpu_torch.parallel.mesh import replicate_state

BANDED = ("physics.banded_sort", "physics.banded_grids", "physics.banded_jacobi",
          "physics.banded_project")
SOLVE = ("physics.banded_sort", "physics.banded_grids", "physics.banded_jacobi")
BOXES, SLOTS, WINDOW, SEED = 64, 320, 16, 5


def one_frame_spans(engine, world, worlds=2):
    """(name, start, end) of every block one frame of the engine's step
    (with the cull pass, as the benchmark builds it) records on this
    thread, with the recorder on."""
    step = engine.build_step(world, "cpu", extra=world.modules["renderer"].cull_pass)
    state = replicate_state(world.device_state("cpu"), worlds,
                            torch.Generator().manual_seed(SEED))
    was = profiler._enabled, profiler._paused
    profiler.enable(True)
    profiler.pause(False)
    t0 = time.perf_counter()
    try:
        step(state, 1 / 60)
    finally:
        profiler.enable(was[0])
        profiler.pause(was[1])
    me = threading.get_ident()
    return [(n, a, b) for n, a, b, tid in profiler.blocks() if a >= t0 and tid == me]


def test_box_drop_world_takes_the_banded_branch():
    engine, world, renderer, _phys = DS.box_drop_world(BOXES, SLOTS, WINDOW, seed=SEED)
    pm = world.modules["physics"]
    st = pm.statics()
    assert pm.broadphase == "auto" and pm.sap_neighbors == WINDOW
    assert st.banded and st.sap and not st.pruned and st.ground_plane
    assert world.capacity == SLOTS and pm.actors.capacity == SLOTS
    assert int(st.dyn_mask.sum()) == BOXES
    assert renderer.engine is engine and world.entity_count == BOXES + 1
    vs = world.device_state("cpu").modules["renderer"]
    assert int((vs.mi_entity >= 0).sum()) == BOXES and int((vs.cam_entity >= 0).sum()) == 1


def test_box_drop_world_bodies_are_box_block_s():
    """The same boxes at the same seed and size: start state and statics."""
    _e, world, _r, _p = DS.box_drop_world(BOXES, SLOTS, WINDOW, seed=SEED)
    _e2, block = PS.box_block(BOXES, SLOTS, seed=SEED, neighbors=WINDOW)
    a, b = (w.modules["physics"] for w in (world, block))
    sa, sb = a.device_state("cpu"), b.device_state("cpu")
    for f in ("pos", "rot", "vel", "angvel", "sleep", "sap_lam", "sap_glam", "sap_rank"):
        assert torch.equal(getattr(sa, f), getattr(sb, f)), f
    ta, tb = a.statics(), b.statics()
    assert ta.banded and tb.banded
    for f in ("shape", "half_extents", "inv_mass", "inv_inertia_body", "friction_body",
              "restitution_body", "dyn_mask", "occupied"):
        assert (getattr(ta, f) == getattr(tb, f)).all(), f


def test_one_frame_records_each_banded_span_once():
    spans = one_frame_spans(*DS.box_drop_world(BOXES, SLOTS, WINDOW, seed=SEED)[:2])
    names = [n for n, _a, _b in spans]
    for name in BANDED:
        assert names.count(name) == 1, (name, names)
    outer = {n: (a, b) for n, a, b in spans if n in ("physics.solve", "physics.update_parallel")}
    at = {n: (a, b) for n, a, b in spans}
    for name in SOLVE:
        assert outer["physics.solve"][0] <= at[name][0] <= at[name][1] <= outer["physics.solve"][1]
    a, b = at["physics.banded_project"]
    assert b <= outer["physics.update_parallel"][1] and a >= outer["physics.solve"][1]


@pytest.mark.parametrize("worlds", [1, 2])
def test_the_pruned_flagship_records_no_banded_span(worlds):
    engine, world, _renderer, _anim, _phys = DS.full_frame_world(512, 8, 32, 256)
    st = world.modules["physics"].statics()
    assert st.pruned and not st.sap
    names = {n for n, _a, _b in one_frame_spans(engine, world, worlds)}
    assert "physics.solve" in names and not names & set(BANDED)
