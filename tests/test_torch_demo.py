"""The headless demo tick (BASELINE config 1) in the port against the JAX
package: `headless_demo_world` builds the same host world from one seed in
both packages, and 3 frames of build_step(extra=cull_pass) agree field by
field (transforms within TRANSFORM_ATOL, the cull and LOD masks equal
outside `pipeline.cull_margins`, every other field bit for bit)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lumixengine_tpu.parallel.mesh import replicate_state as ref_replicate
from lumixengine_tpu_torch import bridge
from lumixengine_tpu_torch.models import demo_scenes as pds
from test_torch_bridge import DT, ref_to_numpy, reference_step
from test_torch_step import FRAMES, R, assert_rest_equal, compare

torch.set_num_threads(1)

N_ENTITIES = 256


def _worlds(num_entities=N_ENTITIES, seed=0):
    from lumixengine_tpu.models import demo_scenes as rds

    return rds.headless_demo_world(num_entities, seed=seed), pds.headless_demo_world(
        num_entities, seed=seed)


@pytest.mark.parametrize("seed", [0, 7])
def test_headless_demo_world_host_world_is_equal(seed):
    (_re, rworld, _rr), (_pe, pworld, _pr) = _worlds(seed=seed)
    assert pworld.entity_count == rworld.entity_count == N_ENTITIES
    for name in ("alive", "parent", "local_pos", "local_rot", "local_scale"):
        np.testing.assert_array_equal(getattr(pworld, name), getattr(rworld, name), err_msg=name)
    rworld._refresh_levels()
    np.testing.assert_array_equal(pworld.perm, rworld._perm)
    rm, pm = rworld.modules["renderer"], pworld.modules["renderer"]
    assert len(pm.point_lights) == len(rm.point_lights) == N_ENTITIES // 16
    assert 0 < len(pm.model_instances) == len(rm.model_instances) < N_ENTITIES
    assert pworld.plan.segments and max(pworld._slot_level) <= 3
    ref = ref_to_numpy(rworld.device_state())
    got = bridge.state_to_numpy(pworld.device_state("cpu"))
    assert set(got) == {k for k in ref if not bridge.is_skipped(k)}
    for k in got:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("num_worlds", [1, 4])
def test_demo_three_frames_match_reference(num_worlds):
    """Replicated with the reference's perturbation, bridged, then 3 frames
    in both packages: every field the bridge carries."""
    (rengine, rworld, _rr), (pengine, pworld, _pr) = _worlds()
    rstate = rworld.device_state()
    if num_worlds > 1:
        rstate = ref_replicate(rstate, num_worlds, jax.random.PRNGKey(3))
    rstep = reference_step(rengine, rworld, batched=num_worlds > 1)
    pstep = pengine.build_step(pworld, "cpu", extra=pworld.modules["renderer"].cull_pass)
    pstate = bridge.state_from_numpy(ref_to_numpy(rstate), "cpu")
    errs, flips = {}, []
    for _ in range(FRAMES):
        rstate = rstep(rstate, jnp.float32(DT))
        pstate = pstep(pstate, DT)
        got, ref = bridge.state_to_numpy(pstate), ref_to_numpy(rstate)
        assert set(got) == {k for k in ref if not bridge.is_skipped(k)}
        flips.append(compare(pworld, pstate, got, ref, errs))
        assert_rest_equal(got, ref, {R + m for m in ("mi_visible", "mi_lod", "pl_visible")}
                          | {R + "counters.visible_count", R + "counters.lights_visible"})
    print(f"W={num_worlds}: boundary flips {flips}; max abs err",
          {k: v for k, v in errs.items() if v > 0})
    visible = got[R + "counters.visible_count"]
    assert np.all(visible > 0) and np.all(visible < len(pworld.modules["renderer"].model_instances))
    assert np.all(got[R + "counters.lights_visible"] > 0)
    assert got["frame"].tolist() == ([FRAMES] * num_worlds if num_worlds > 1 else FRAMES)


def test_demo_world_default_size():
    """headless_demo_world's default: BASELINE's ~2k entities, 32 lights, capacity
    = entities."""
    _e, world, _r = pds.headless_demo_world()
    rm = world.modules["renderer"]
    assert world.entity_count == world.capacity == 2048
    assert len(rm.point_lights) == 32 and len(rm.cameras) == 1
    assert rm.model_instances.capacity == 2048
