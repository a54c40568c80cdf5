"""World sharding in the port (parallel/mesh.py and parallel/dryrun.py)
against the JAX package, on the CPU:

* ``dryrun.main(4)`` on a mesh of four ``cpu`` entries: the sharded step
  equal to the unsharded one bit for bit;
* the sharded step on the JAX dry run's own batch (``full_frame_world(128,
  4, 8, 64)`` replicated to 8 diverging worlds by ``PRNGKey(0)``): its
  summed ``visible_total`` equal to the JAX ``build_sharded_step``'s over
  the 8 host devices tests/conftest.py forces (4 of them), and the
  world positions within the step harness's tolerances of the JAX output;
* ``shard_world_batch``'s contiguous equal shards, ``donate``, and the
  mesh's refusals.
"""
import io
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lumixengine_tpu_torch import bridge
from lumixengine_tpu_torch.models import demo_scenes as pds
from lumixengine_tpu_torch.parallel import dryrun, mesh as M
from test_torch_bridge import ref_to_numpy
from test_torch_step import BODY_POS_ATOL, TRANSFORM_ATOL

torch.set_num_threads(2)

N_SHARDS = 4
DT = 1.0 / 60.0


def test_dryrun_main_is_bitwise_on_the_cpu():
    out = {}
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert dryrun.main(N_SHARDS, "cpu", out=out) == 0
    assert out["pos_gap"] == 0.0 and out["devices"] == ["cpu"] * N_SHARDS
    assert "dryrun ok: 4 shards" in buf.getvalue() and "(bitwise)" in buf.getvalue()
    assert out["visible_total"] > 0


def _jax_batch():
    """The JAX dry run's world, step and 2n-world batch, built as
    lumixengine_tpu/parallel/dryrun.py builds them."""
    from lumixengine_tpu.models import demo_scenes
    from lumixengine_tpu.parallel.mesh import replicate_state

    engine, world, *_ = demo_scenes.full_frame_world(
        num_entities=128, num_characters=4, num_bodies=8, particle_capacity=64)
    rmod = world.modules["renderer"]
    step_raw = engine.build_step(world, extra=lambda ws, dt: rmod.cull_pass(ws, dt), jit=False)
    batched = replicate_state(world.device_state(), N_SHARDS * 2,
                              perturb_key=jax.random.PRNGKey(0))
    return step_raw, batched


def test_sharded_step_matches_the_jax_sharded_step():
    from lumixengine_tpu.parallel.mesh import (build_sharded_step, make_world_mesh,
                                               shard_world_batch)

    assert len(jax.devices()) >= N_SHARDS
    step_raw, batched = _jax_batch()
    tree = ref_to_numpy(batched)
    # the JAX dry run's sharded step: donation and the psum'd metric
    rmesh = make_world_mesh(n_devices=N_SHARDS)
    rstep = build_sharded_step(step_raw, rmesh, donate=True, with_metrics=True)
    rout, rmetrics = rstep(shard_world_batch(batched, rmesh), jnp.float32(DT))
    ref = ref_to_numpy(rout)
    ref_vis = int(rmetrics["visible_total"])

    pengine, pworld, *_ = pds.full_frame_world(num_entities=128, num_characters=4, num_bodies=8,
                                               particle_capacity=64)
    rmod = pworld.modules["renderer"]
    pmesh = M.make_world_mesh(devices=["cpu"] * N_SHARDS)
    pstep = M.build_sharded_step(lambda d: pengine.build_step(pworld, d, extra=rmod.cull_pass),
                                 pmesh, donate=True, with_metrics=True)
    shards = M.shard_world_batch(bridge.state_from_numpy(tree, "cpu"), pmesh)
    outs, metrics = pstep(shards, DT)
    assert shards == [None] * N_SHARDS           # donated
    got = [bridge.state_to_numpy(o) for o in outs]
    vis = int(metrics["visible_total"])
    assert vis == ref_vis, (vis, ref_vis)
    pos = np.concatenate([g["world.pos"] for g in got])
    frame = np.concatenate([g["frame"] for g in got])
    np.testing.assert_array_equal(frame, ref["frame"])
    body = np.zeros(pos.shape[-1], bool)
    body[pworld.to_slots(np.asarray(pworld.modules["physics"].actors.entity[
        pworld.modules["physics"].actors.entity >= 0]))] = True
    np.testing.assert_allclose(pos[..., ~body], ref["world.pos"][..., ~body],
                               rtol=0, atol=TRANSFORM_ATOL)
    np.testing.assert_allclose(pos[..., body], ref["world.pos"][..., body],
                               rtol=0, atol=BODY_POS_ATOL)
    print(f"visible_total {vis}; max position gap "
          f"{float(np.abs(pos - ref['world.pos']).max()):.3e}")


def test_shards_are_contiguous_and_equal():
    _e, pworld, *_ = pds.full_frame_world(num_entities=64, num_characters=2, num_bodies=4,
                                          particle_capacity=16)
    state = M.replicate_state(pworld.device_state("cpu"), 6, torch.Generator().manual_seed(1))
    shards = M.shard_world_batch(state, M.make_world_mesh(devices=["cpu"] * 3))
    assert len(shards) == 3
    for i, sh in enumerate(shards):
        assert sh.local.pos.shape[0] == 2
        assert torch.equal(sh.local.pos, state.local.pos[2 * i:2 * i + 2])
        assert torch.equal(sh.modules["physics"].vel, state.modules["physics"].vel[2 * i:2 * i + 2])
    with pytest.raises(ValueError, match="equal shards"):
        M.shard_world_batch(state, ["cpu"] * 4)


def test_make_world_mesh_needs_devices_on_a_host_without_cuda():
    assert M.make_world_mesh(devices=["cpu", "cpu"]) == [torch.device("cpu")] * 2
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="no CUDA device"):
            M.make_world_mesh(2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dryrun.mesh_devices(2, "cuda")
