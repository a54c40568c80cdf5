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


@pytest.mark.parametrize("data", [5, 2**31 + 9, "frames"])
@pytest.mark.parametrize("batched", [False, True])
def test_fold_uniform_is_uniform_of_fold_in(batched, data):
    """fold_uniform(key, data, shape) = uniform(fold_in(key, data), shape),
    and jax.random's draw under the folded key, for a single key and a key
    batch, with an int and a per-world int32 tensor."""
    keys = KEYS if batched else KEYS[1]
    frames = np.array([0, 1, 2**31 - 1, -5, 77], np.int32)
    per_world = data == "frames"
    d = torch.tensor(frames) if per_world else data
    got = prng.fold_uniform(torch.tensor(keys), d, (3, 5))
    want = prng.uniform(prng.fold_in(torch.tensor(keys), d), (3, 5))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.numpy().view(np.uint32))
    jd = jnp.asarray(frames) if per_world else np.uint32(data & 0xFFFFFFFF)
    folded = jax.vmap(jax.random.fold_in, in_axes=(0 if batched else None, 0 if per_world else None),
                      axis_size=len(KEYS))(jnp.asarray(keys), jd)
    ref = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (3, 5)))(folded))
    np.testing.assert_array_equal(got.numpy().reshape(-1, 3, 5).view(np.uint32),
                                  ref[:len(got.reshape(-1, 3, 5))].view(np.uint32))


def test_cpu_keys_launch_no_kernel():
    """CPU keys take the plain version: the kernel's launch count stays."""
    before = prng.threefry_cuda.launches
    key = prng.PRNGKey(11)
    prng.fold_uniform(prng.fold_in(key, torch.tensor([1, 2], dtype=torch.int32)), 3, (8,))
    prng.bits(prng.split(key, 4), (5,))
    prng.uniform(key, (7,))
    assert prng.threefry_cuda.launches == before


def test_other_devices_raise():
    key = torch.zeros(2, dtype=torch.int64, device="meta")
    for call in (lambda: prng.fold_in(key, 1), lambda: prng.uniform(key, (4,)),
                 lambda: prng.fold_uniform(key, 1, (4,)), lambda: prng.split(key)):
        with pytest.raises(ValueError, match="unsupported device"):
            call()


@pytest.mark.parametrize("shape,batch,step,copied", [
    ((4, 2), (4,), 1, False),          # one key a batch entry
    ((2,), (4,), 0, False),            # one key for the batch
    ((1, 2), (4,), 0, False),
    ((4, 1, 2), (4, 3), 1, True),      # a key per row, broadcast over columns
    ((1, 3, 2), (1, 3), 1, False),     # leading ones: the same row-major order
])
def test_kernel_operand_steps(shape, batch, step, copied):
    """The kernel reads an operand's batch entry b at b * step; a key that
    broadcasts otherwise is materialised to the batch's shape."""
    key = torch.arange(int(np.prod(shape)), dtype=torch.int64).reshape(shape)
    t, wide, got_step = prng._kernel_operand("key", key, key.device, batch, (2,))
    assert (wide, got_step) == (1, step)
    assert (t.data_ptr() != key.data_ptr()) == copied
    if copied:
        assert torch.equal(t, key.expand(batch + (2,)))


def test_kernel_operand_refusals():
    with pytest.raises(ValueError, match="contiguous"):
        prng._kernel_operand("key", torch.zeros((4, 2), dtype=torch.int64)[::2], torch.device("cpu"),
                             (2,), (2,))
    with pytest.raises(ValueError, match="int16"):
        prng._kernel_operand("key", torch.zeros((4, 2), dtype=torch.int16), torch.device("cpu"),
                             (4,), (2,))
    with pytest.raises(ValueError, match="is on cpu"):
        prng._kernel_operand("data", torch.zeros(4, dtype=torch.int32), torch.device("meta"), (4,))
    for dtype, wide in ((torch.uint32, 0), (torch.int32, 0), (torch.int64, 1)):
        t = torch.zeros(4, dtype=torch.int32).to(torch.int64).to(dtype) if dtype != torch.uint32 \
            else torch.zeros(4, dtype=torch.int32).view(torch.uint32)
        assert prng._kernel_operand("data", t, torch.device("cpu"), (4,))[1:] == (wide, 1)


def test_threefry_work_counts():
    """The work chip_smoke.py holds the kernel's time against, at the
    flagship's draw [4096, 2048]: 40 ALU-pipe operations a hash (a funnel
    shift and a xor in each of 20 rounds), a fold per key, a xor and a shift
    per uniform; each int64 key read once and each float32 written once.
    The operations bound it: 0.0211 ms at 64 a clock on 132 SMs at 1.98 GHz,
    against 0.0100 ms for the bytes at 3.35 TB/s."""
    w, n = 4096, 2048
    ops = prng.threefry_alu_ops(w, n)
    assert ops == w * (40 * (n + 1) + 2 * n) == 352_485_376
    assert prng.threefry_alu_ops(w, n, fold=False, as_uniform=False) == w * n * 41
    nbytes = prng.threefry_bytes(w, n)
    assert nbytes == w * 16 + w * n * 4 == 33_619_968
    assert prng.threefry_bytes(w, n, key_bytes=8, as_uniform=False) == w * 8 + w * n * 8
    assert round(ops / (132 * 64 * 1.98e9) * 1e3, 4) == 0.0211
    assert round(nbytes / 3.35e12 * 1e3, 4) == 0.0100
