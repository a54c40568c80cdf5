"""Port ↔ reference state bridge, and the helpers the other port parity tests
share: the slice world at test size built by both packages, a JAX state
flattened to the bridge's dotted names, and a reference state stepped until
its bodies rest on the ground."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lumixengine_tpu_torch import bridge

torch.set_num_threads(1)

# the slice at test size: 496 candidate pairs > pruned_threshold 192, so the
# pruned branch runs (budget 192, C = 4·32 ground + 4·192 pair = 896)
N_ENTITIES = 512
N_BODIES = 32
DT = 1.0 / 60.0


def ref_to_numpy(tree) -> dict:
    """A JAX pytree (WorldState or part of it) → {dotted name: np.ndarray}."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]:
        name = ".".join(str(getattr(k, "name", getattr(k, "key", k))) for k in path)
        out[name] = np.asarray(leaf)
    return out


def ref_from_numpy(template, tree: dict):
    """A JAX pytree shaped like `template` with its leaves taken from the
    dotted-name numpy arrays `tree`."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(template)
    new = []
    for path, leaf in leaves:
        name = ".".join(str(getattr(k, "name", getattr(k, "key", k))) for k in path)
        new.append(jnp.asarray(tree[name], dtype=leaf.dtype))
    return jax.tree_util.tree_unflatten(treedef, new)


def reference_world(seed: int = 0):
    from lumixengine_tpu.models import demo_scenes as rds

    engine, world, renderer, _anim, phys = rds.full_frame_world(
        N_ENTITIES, 0, N_BODIES, 0, seed=seed)
    return engine, world, renderer, phys


def port_world(seed: int = 0):
    from lumixengine_tpu_torch.models import demo_scenes as pds

    engine, world, renderer, _anim, phys = pds.full_frame_world(
        N_ENTITIES, 0, N_BODIES, 0, seed=seed)
    return engine, world, renderer, phys


def reference_step(engine, world, batched: bool):
    """The reference's build_step(extra=cull_pass), jitted (vmapped when
    batched)."""
    rmod = world.modules["renderer"]
    raw = engine.build_step(world, extra=lambda ws, dt: rmod.cull_pass(ws, dt), jit=False)
    fn = jax.vmap(raw, in_axes=(0, None)) if batched else raw
    return jax.jit(fn)


def use_fused_solver(monkeypatch, world):
    """Make the reference world's physics run the fused Pallas contact solver
    (in interpret mode) — the semantics kernel K2 ports — for this test."""
    import lumixengine_tpu.ops.solver_pallas as SP

    monkeypatch.setattr(SP, "solve_contacts_fused",
                        functools.partial(SP.solve_contacts_fused, interpret=True))
    monkeypatch.setattr(world.modules["physics"], "solver_backend", "pallas")


@functools.lru_cache(maxsize=None)
def settled_reference(frames: int = 120):
    """(engine, world, state) of the reference slice world after `frames`
    frames of its normal CPU step: the bodies are down and the ground stream
    carries contacts."""
    engine, world, _r, _p = reference_world()
    step = reference_step(engine, world, batched=False)
    run = jax.jit(lambda s: jax.lax.fori_loop(0, frames, lambda i, s: step(s, jnp.float32(DT)), s))
    return engine, world, jax.block_until_ready(run(world.device_state()))


def cull_margins(world, state):
    """The port's cull margins for a port state, as numpy."""
    from lumixengine_tpu_torch.renderer import pipeline

    return tuple(m.numpy() for m in pipeline.cull_margins(state, world.modules["renderer"]))


def assert_masks_agree(name, got, ref, margin, boundary=1e-4):
    """Equal masks, except where the decision sits within `boundary` of its
    threshold. Returns the number of such boundary flips."""
    off = np.asarray(got) != np.asarray(ref)
    far = off & (np.abs(margin) >= boundary)
    assert not far.any(), f"{name}: {int(far.sum())} mismatches away from the boundary"
    return int(off.sum())


def test_roundtrip_single_world():
    _e, world, _r, _p = reference_world()
    tree = ref_to_numpy(world.device_state())
    back = bridge.state_to_numpy(bridge.state_from_numpy(tree, "cpu"))
    kept = {k for k in tree if not bridge.is_skipped(k)}
    assert set(back) == kept
    for k in kept:
        assert back[k].dtype == tree[k].dtype, k
        np.testing.assert_array_equal(back[k], tree[k], err_msg=k)


def test_roundtrip_world_batch():
    from lumixengine_tpu.parallel.mesh import replicate_state

    _e, world, _r, _p = reference_world()
    tree = ref_to_numpy(replicate_state(world.device_state(), 3, jax.random.PRNGKey(1)))
    state = bridge.state_from_numpy(tree, "cpu")
    assert state.local.pos.shape == (3, 3, N_ENTITIES)
    back = bridge.state_to_numpy(state)
    for k, v in back.items():
        np.testing.assert_array_equal(v, tree[k], err_msg=k)


def test_every_skipped_prefix_names_reference_fields():
    _e, world, _r, _p = reference_world()
    names = ref_to_numpy(world.device_state())
    for prefix, _why in bridge.SKIPPED:
        assert any(n.startswith(prefix) for n in names), prefix


def test_unknown_field_raises():
    _e, world, _r, _p = reference_world()
    tree = ref_to_numpy(world.device_state())
    tree["modules.physics.joint_lambda"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="joint_lambda"):
        bridge.state_from_numpy(tree, "cpu")


def test_missing_field_raises():
    _e, world, _r, _p = reference_world()
    tree = ref_to_numpy(world.device_state())
    del tree["modules.physics.pair_key"]
    with pytest.raises(KeyError):
        bridge.state_from_numpy(tree, "cpu")


def _flagship_tree(num_worlds):
    from lumixengine_tpu.models import demo_scenes as rds
    from lumixengine_tpu.parallel.mesh import replicate_state

    _e, world, *_ = rds.full_frame_world(N_ENTITIES, 8, N_BODIES, 64)
    return ref_to_numpy(replicate_state(world.device_state(), num_worlds, jax.random.PRNGKey(2)))


def test_roundtrip_animation_and_particles():
    """The flagship's animation state and emitter states, batched, go
    through the bridge and back unchanged, uint32 key included."""
    tree = _flagship_tree(3)
    state = bridge.state_from_numpy(tree, "cpu")
    anim, rs = state.modules["animation"], state.modules["renderer"]
    assert anim.pose_pos.shape == (3, 3, 32, 8) and anim.palette.shape == (3, 8, 32, 8)
    assert rs.particles["pe2"]["storm"].channels.shape == (3, 7, 64)
    assert rs.prng.dtype == torch.uint32 and rs.prng.shape == (3, 2)
    back = bridge.state_to_numpy(state)
    assert set(back) == {k for k in tree if not bridge.is_skipped(k)}
    assert any(k.startswith("modules.animation.") for k in back)
    assert any(k.startswith("modules.renderer.particles.pe2.storm.") for k in back)
    for k, v in back.items():
        assert v.dtype == tree[k].dtype, k
        np.testing.assert_array_equal(v, tree[k], err_msg=k)


def test_unknown_emitter_field_raises():
    tree = _flagship_tree(1)
    tree["modules.renderer.particles.pe2.storm.ribbon"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="ribbon"):
        bridge.state_from_numpy(tree, "cpu")
