"""The port's other hierarchy propagations (``ops/hierarchy.py``:
``propagate``, ``propagate_indexed``, ``propagate_doubling``,
``compute_level_indices_host``) and the World's hooks for them
(``max_depth``, ``level_indices``, ``hierarchy_is_uniform_scale``) against
the JAX package, on the worlds of tests/test_world.py: a random tree of
40 entities with non-uniform scales, a 30-deep chain, and a batch of two
worlds of one topology (the port's leading axis in place of ``vmap``).

The states are entity-ordered (the host's arrays), as these functions take
them; the device state's slot order maps to it through ``World.perm``.
Tolerance: both packages compose the same float32 operations in the same
order, so the transforms agree within PROP_ATOL = 1e-6 (observed 0 or an
ulp); the host arrays (levels, level indices, hooks) are equal.
``propagate_doubling`` is exact only for uniform-scale hierarchies, so it is
held to the JAX package and to ``propagate`` only there (and, at a
max_depth that is a power of two, only on the levels its rounds reach, in
both packages).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lumixengine_tpu.core import host_math as rhm
from lumixengine_tpu.core.transform import Transform as RT
from lumixengine_tpu.engine.world import INVALID_ENTITY, World as RWorld
from lumixengine_tpu.ops import hierarchy as rhier
from lumixengine_tpu_torch.core.transform import Transform as PT
from lumixengine_tpu_torch.engine.world import World as PWorld
from lumixengine_tpu_torch.ops import hierarchy as phier

torch.set_num_threads(1)

PROP_ATOL = 1e-6


def random_tree(cls, uniform: bool, seed: int = 0, n: int = 40):
    """tests/test_world.py's random tree (30% roots, random parents among the
    earlier entities, random locals); `uniform` draws one scale per entity."""
    rng = np.random.default_rng(seed)
    w = cls(capacity=64)
    entities = []
    for _ in range(n):
        parent = INVALID_ENTITY if not entities or rng.random() < 0.3 else int(rng.choice(entities))
        s = rng.uniform(0.5, 1.5, size=1 if uniform else 3).astype(np.float32)
        e = w.create_entity(
            position=rng.normal(size=3).astype(np.float32),
            rotation=rhm.quat_normalize(rng.normal(size=4).astype(np.float32)),
            scale=np.broadcast_to(s, (3,)).astype(np.float32))
        if parent != INVALID_ENTITY:
            w.set_parent(e, parent)
            w.set_local_transform(
                e, position=rng.normal(size=3).astype(np.float32),
                rotation=rhm.quat_normalize(rng.normal(size=4).astype(np.float32)))
        entities.append(e)
    return w


def deep_chain(cls, n: int = 30):
    """tests/test_world.py's chain of +1 m x offsets, `n` deep."""
    w = cls(capacity=64)
    prev = INVALID_ENTITY
    for _ in range(n):
        e = w.create_entity(position=(1.0, 0.0, 0.0))
        if prev != INVALID_ENTITY:
            w.set_parent(e, prev)
            w.set_local_transform(e, position=(1.0, 0.0, 0.0))
        prev = e
    return w


WORLDS = {"tree": lambda cls: random_tree(cls, uniform=False),
          "uniform_tree": lambda cls: random_tree(cls, uniform=True, seed=3),      # 4 deep
          "uniform_tree_5": lambda cls: random_tree(cls, uniform=True, seed=4),    # 5 deep
          "chain": deep_chain}


def host_locals(w, batch: int = 0):
    """The entity-ordered local transform as SoA numpy ([3|4, N]); with
    `batch` > 0, that many worlds whose positions are scaled by 1, 2, ..."""
    pos, rot, scale = w.local_pos.T.copy(), w.local_rot.T.copy(), w.local_scale.T.copy()
    if batch:
        pos = np.stack([pos * (i + 1) for i in range(batch)])
        rot, scale = np.stack([rot] * batch), np.stack([scale] * batch)
    return pos, rot, scale


def as_ref(arrs):
    return RT(*(jnp.asarray(a) for a in arrs))


def as_port(arrs):
    return PT(*(torch.from_numpy(np.ascontiguousarray(a)) for a in arrs))


def assert_close(got: PT, ref, what):
    for name in ("pos", "rot", "scale"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=0, atol=PROP_ATOL, err_msg=f"{what}.{name}")


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_world_hooks_match_reference(name):
    rw, pw = WORLDS[name](RWorld), WORLDS[name](PWorld)
    assert pw.max_depth == rw.max_depth > 0
    assert len(pw.level_indices) == len(rw.level_indices) == pw.max_depth
    for a, b in zip(pw.level_indices, rw.level_indices):
        np.testing.assert_array_equal(a, b)
    assert pw.hierarchy_is_uniform_scale() == rw.hierarchy_is_uniform_scale() == (name != "tree")
    # the hooks leave the slot order and the plan as they were
    np.testing.assert_array_equal(pw.perm, rw._perm)
    assert len(pw.plan) == len(rw.plan)
    for (s0, e0, p0), (s1, e1, p1) in zip(pw.plan.segments, rw.plan.segments):
        assert (s0, e0) == (s1, e1)
        np.testing.assert_array_equal(p0, p1)


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_compute_level_indices_host_matches_reference(name):
    w = WORLDS[name](RWorld)
    lv_p, idx_p = phier.compute_level_indices_host(w.parent)
    lv_r, idx_r = rhier.compute_level_indices_host(w.parent)
    np.testing.assert_array_equal(lv_p, lv_r)
    assert len(idx_p) == len(idx_r)
    for a, b in zip(idx_p, idx_r):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_propagate_and_indexed_match_reference(name):
    w = WORLDS[name](PWorld)
    level, idx = phier.compute_level_indices_host(w.parent)
    arrs = host_locals(w)
    parent = w.parent.astype(np.int32)
    ref = rhier.propagate(as_ref(arrs), jnp.asarray(parent), jnp.asarray(level), w.max_depth)
    got = phier.propagate(as_port(arrs), torch.from_numpy(parent), torch.from_numpy(level),
                          w.max_depth)
    assert_close(got, ref, f"{name} propagate")
    ref_i = rhier.propagate_indexed(as_ref(arrs), jnp.asarray(parent), idx)
    got_i = phier.propagate_indexed(as_port(arrs), torch.from_numpy(parent), w.level_indices)
    assert_close(got_i, ref_i, f"{name} propagate_indexed")
    # and both agree with the engine's plan path, mapped from slot order
    state = w.device_state("cpu")
    slot_of = w.to_slots(np.arange(w.capacity))
    for what, t in (("propagate", got), ("propagate_indexed", got_i)):
        for f in ("pos", "rot", "scale"):
            np.testing.assert_allclose(getattr(t, f).numpy(),
                                       getattr(state.world, f).numpy()[:, slot_of],
                                       rtol=0, atol=PROP_ATOL, err_msg=f"{name} {what} vs plan {f}")


@pytest.mark.parametrize("name", ["uniform_tree", "uniform_tree_5", "chain"])
def test_propagate_doubling_matches_reference_on_uniform_scale(name):
    """Equal to the JAX function; and, where pointer jumping reaches every
    ancestor, equal to the masked path up to rounding (another grouping of
    the same associative composes). Both packages take ceil(log2(max_depth))
    rounds (at least 1), and r rounds compose 2^r - 1 ancestors: at a
    max_depth that is a power of two (the 4-deep uniform tree), the deepest
    level misses its root in both packages alike."""
    w = WORLDS[name](PWorld)
    assert w.hierarchy_is_uniform_scale()
    arrs = host_locals(w)
    parent = w.parent.astype(np.int32)
    ref = rhier.propagate_doubling(as_ref(arrs), jnp.asarray(parent), w.max_depth)
    got = phier.propagate_doubling(as_port(arrs), torch.from_numpy(parent), w.max_depth)
    assert_close(got, ref, f"{name} propagate_doubling")
    level = phier.compute_levels_host(w.parent)[0]
    masked = phier.propagate(as_port(arrs), torch.from_numpy(parent), torch.from_numpy(level),
                             w.max_depth)
    reached = 2 ** max(1, int(np.ceil(np.log2(w.max_depth)))) - 1
    full = level <= reached
    assert (~full).any() == (w.max_depth & (w.max_depth - 1) == 0)
    for f in ("pos", "rot", "scale"):
        np.testing.assert_allclose(getattr(got, f).numpy()[:, full],
                                   getattr(masked, f).numpy()[:, full],
                                   rtol=0, atol=1e-4, err_msg=f"{name} doubling vs masked {f}")


def test_batch_of_two_worlds_matches_vmap():
    """tests/test_world.py's vmap case: two worlds of one topology, the
    second's positions doubled; the JAX functions under vmap against the
    port's batched calls."""
    w = PWorld(capacity=16)
    a = w.create_entity(position=(1.0, 0.0, 0.0))
    b = w.create_entity(position=(0.0, 1.0, 0.0))
    w.set_parent(b, a)
    arrs = host_locals(w, batch=2)
    parent = np.stack([w.parent, w.parent]).astype(np.int32)
    level = np.stack([phier.compute_levels_host(w.parent)[0]] * 2)
    rp, rl = jnp.asarray(parent), jnp.asarray(level)
    ref = jax.vmap(lambda loc, p, lv: rhier.propagate(loc, p, lv, 1))(as_ref(arrs), rp, rl)
    got = phier.propagate(as_port(arrs), torch.from_numpy(parent), torch.from_numpy(level), 1)
    assert_close(got, ref, "batched propagate")
    np.testing.assert_allclose(got.pos[:, :, b].numpy(), [[0.0, 1.0, 0.0], [0.0, 2.0, 0.0]],
                               atol=1e-5)
    ref_d = jax.vmap(lambda loc, p: rhier.propagate_doubling(loc, p, 1))(as_ref(arrs), rp)
    got_d = phier.propagate_doubling(as_port(arrs), torch.from_numpy(parent), 1)
    assert_close(got_d, ref_d, "batched propagate_doubling")
    ref_i = jax.vmap(lambda loc, p: rhier.propagate_indexed(loc, p, w.level_indices))(
        as_ref(arrs), rp)
    got_i = phier.propagate_indexed(as_port(arrs), torch.from_numpy(parent), w.level_indices)
    assert_close(got_i, ref_i, "batched propagate_indexed")
    # a parent row shared by the batch gives the same as one row per world
    shared = phier.propagate_indexed(as_port(arrs), torch.from_numpy(parent[0]),
                                     w.level_indices)
    assert_close(shared, ref_i, "shared-parent propagate_indexed")


def test_packed_form_round_trips():
    rng = np.random.default_rng(5)
    arrs = (rng.normal(size=(2, 3, 7)).astype(np.float32),
            rng.normal(size=(2, 4, 7)).astype(np.float32),
            rng.normal(size=(2, 3, 7)).astype(np.float32))
    t = as_port(arrs)
    packed = t.packed()
    np.testing.assert_array_equal(packed.numpy(), np.asarray(as_ref(arrs).packed()))
    back = PT.from_packed(packed)
    for f, a in zip(("pos", "rot", "scale"), arrs):
        np.testing.assert_array_equal(getattr(back, f).numpy(), a)
