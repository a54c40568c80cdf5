"""The port's threefry stream (lumixengine_tpu_torch/core/random.py) against
jax.random in its partitionable mode: PRNGKey, fold_in chains, bits and
uniform, single and batched keys. Tolerance: none — every word and every
float must be equal bit for bit."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lumixengine_tpu_torch.core import random as prng

torch.set_num_threads(1)

# words at and around the sign bit of int32, and at the ends of uint32
KEYS = np.array([[0, 0], [0x80000000, 0xFFFFFFFF], [0x7FFFFFFF, 0x80000000],
                 [0xFFFFFFFF, 0xFFFFFFFF], [123456789, 0x9ABCDEF0]], np.uint32)


def test_partitionable_mode_is_the_reference():
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", [0, 1, 7, -1, 2**31 - 1, 2**31, 2**33 + 7])
def test_prngkey(seed):
    got = prng.PRNGKey(seed)
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax.random.PRNGKey(seed)))


def test_fold_in_chains():
    """Chains of fold_in with Python ints and with int32 tensors (negative
    values are their uint32 bit patterns), from keys with top bits set."""
    rng = np.random.default_rng(0)
    for key in KEYS:
        got, ref = torch.tensor(key), jnp.asarray(key)
        for d in rng.integers(-2**31, 2**31, 6).tolist() + [0, 2**31 - 1, -1]:
            got = prng.fold_in(got, d if d >= 0 else torch.tensor(d, dtype=torch.int32))
            ref = jax.random.fold_in(ref, d if d >= 0 else np.int32(d))
            np.testing.assert_array_equal(got.numpy().astype(np.uint32), np.asarray(ref))


def test_fold_in_batched_frames():
    """A batch of keys folded with a per-world int32 frame counter, as the
    render module does: vmap over (key, frame)."""
    frames = np.array([0, 1, 2**31 - 1, -5, 77], np.int32)
    got = prng.fold_in(torch.tensor(KEYS), torch.tensor(frames))
    ref = jax.vmap(jax.random.fold_in)(jnp.asarray(KEYS), jnp.asarray(frames))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), np.asarray(ref))


@pytest.mark.parametrize("shape", [(2048,), (3, 5), (1,), (7,)])
def test_bits_and_uniform_single_key(shape):
    for key in KEYS:
        got_b = prng.bits(torch.tensor(key), shape).numpy().astype(np.uint32)
        np.testing.assert_array_equal(got_b, np.asarray(jax.random.bits(jnp.asarray(key), shape)))
        got = prng.uniform(torch.tensor(key), shape).numpy()
        ref = np.asarray(jax.random.uniform(jnp.asarray(key), shape))
        np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("worlds", [1, 4])
def test_uniform_batched_keys(worlds):
    """[W, 2048] draws from W keys (the particle path's shape), with keys
    derived from a folded chain so that their words cover the top bit."""
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(3), i))(
        jnp.arange(worlds, dtype=jnp.int32))
    keys = np.concatenate([np.asarray(keys), KEYS])[:max(worlds, 1)]
    got = prng.uniform(torch.tensor(keys), (2048,)).numpy()
    ref = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (2048,)))(jnp.asarray(keys)))
    assert got.shape == (len(keys), 2048)
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    assert 0.0 <= got.min() and got.max() < 1.0


def test_rotations_at_the_sign_bit():
    """The 32-bit rotate keeps the bits that cross the sign bit: every
    rotation amount of threefry on words with the top bit set."""
    x = torch.tensor([0x80000001, 0xFFFFFFFF, 0x40000000, 1], dtype=torch.int64)
    for r in (13, 15, 26, 6, 17, 29, 16, 24):
        want = [((v << r) | (v >> (32 - r))) & 0xFFFFFFFF for v in x.tolist()]
        assert prng._rotl(x, r).tolist() == want
