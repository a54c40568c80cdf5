"""The Threefry kernel (csrc/threefry.cu, core/random.py::threefry_cuda) on
the card against the plain version, bit for bit: fold_in, split, bits,
uniform and fold_uniform over key dtypes, data kinds, broadcast batches and
the particle path's shape; the benchmark reference's generator at one
shape; the operands it refuses; and one flagship frame that draws through
the kernel alone. These tests need a CUDA device and skip without one; run
them with ``python -m pytest --noconftest -m gpu tests/test_torch_threefry_gpu.py``
(the suite's conftest configures JAX)."""
import numpy as np
import pytest
import torch

from lumixengine_tpu_torch.core import random as prng

pytestmark = pytest.mark.gpu

torch.set_num_threads(1)

# words at and around the sign bit of int32, and at the ends of uint32
KEYS = np.array([[0, 0], [0x80000000, 0xFFFFFFFF], [0x7FFFFFFF, 0x80000000],
                 [0xFFFFFFFF, 0xFFFFFFFF], [123456789, 0x9ABCDEF0]], np.uint32)
SHAPES = [(1,), (7,), (3, 5), (2048,)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _keys(dtype, dev):
    """KEYS as the port may hold them: uint32 (through an int32 view), int32
    bit patterns or int64 words."""
    if dtype == torch.int64:
        return torch.tensor(KEYS.astype(np.int64), device=dev)
    k = torch.tensor(KEYS.view(np.int32), device=dev)
    return k.view(torch.uint32) if dtype == torch.uint32 else k


def _launched(fn, *args):
    """fn(*args), checked to launch the kernel exactly once."""
    before = prng.threefry_cuda.launches
    out = fn(*args)
    assert prng.threefry_cuda.launches == before + 1
    return out


def _same(got, want):
    assert got.device.type == "cuda" and got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got, want.to(got.device))


def _data(kind, dev):
    """fold_in's data: Python ints at and past the sign bit, or per-key
    tensors of int32 (negative bit patterns) and int64."""
    return {"int": 2**31 + 5, "int_neg": -1,
            "int32": torch.tensor([0, 1, -5, 2**31 - 1, 77], dtype=torch.int32, device=dev),
            "int64": torch.tensor([2**32 + 9, 3, 2**31, 0, -2], dtype=torch.int64, device=dev),
            }[kind]


@pytest.mark.parametrize("data", ["int", "int_neg", "int32", "int64"])
@pytest.mark.parametrize("dtype", [torch.uint32, torch.int32, torch.int64])
def test_fold_in_bit_exact(cuda, dtype, data):
    key, d = _keys(dtype, cuda), _data(data, cuda)
    _same(_launched(prng.fold_in, key, d), prng.fold_in_plain(key, d))
    # one key broadcast over the data, and one datum over the keys
    _same(_launched(prng.fold_in, key[1], d), prng.fold_in_plain(key[1], d))
    d0 = d[3:4] if isinstance(d, torch.Tensor) else d
    _same(_launched(prng.fold_in, key, d0), prng.fold_in_plain(key, d0))


def test_fold_in_broadcast_batches(cuda):
    """Batches that broadcast both ways, a 0-d datum, a chain of folds and
    split, against the plain version on the CPU."""
    key = _keys(torch.int64, cuda)
    cases = [(key.reshape(5, 1, 2), torch.arange(3, dtype=torch.int32, device=cuda)),
             (key[:4].reshape(2, 2, 2), torch.tensor([[7], [-7]], device=cuda)),
             (key, torch.tensor(-3, dtype=torch.int32, device=cuda))]
    for k, d in cases:
        _same(_launched(prng.fold_in, k, d), prng.fold_in_plain(k.cpu(), d.cpu()))
    got, want = key, key.cpu()
    for d in (0, 2**31 - 1, 12345, 2**32 - 1):
        got, want = prng.fold_in(got, d), prng.fold_in_plain(want, d)
    _same(got, want)
    for k in (key, key[2], _keys(torch.uint32, cuda)[3]):
        _same(_launched(prng.split, k, 3), prng.split_plain(k.cpu(), 3))
    _same(prng.split(key[0]), prng.split_plain(key[0].cpu()))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.uint32, torch.int32, torch.int64])
def test_bits_and_uniform_bit_exact(cuda, dtype, shape):
    key = _keys(dtype, cuda)
    for k in (key, key[1], key.reshape(5, 1, 2)):
        _same(_launched(prng.bits, k, shape), prng.bits_plain(k, shape))
        _same(_launched(prng.uniform, k, shape), prng.uniform_plain(k, shape))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("data", ["int", "int_neg", "int32", "int64"])
def test_fold_uniform_bit_exact(cuda, data, shape):
    key, d = _keys(torch.uint32, cuda), _data(data, cuda)
    _same(_launched(prng.fold_uniform, key, d, shape),
          prng.uniform_plain(prng.fold_in_plain(key, d), shape))
    _same(_launched(prng.fold_uniform, key[4], d, shape),
          prng.uniform_plain(prng.fold_in_plain(key[4], d), shape))


def test_the_particle_shape(cuda):
    """4096 per-world keys × 2048 draws, the flagship's shape: keys folded
    from a per-world frame counter, then the draws, folded in the launch
    and apart; equal to the plain version on the card and on the CPU."""
    g = torch.Generator(device=cuda).manual_seed(20)
    words = torch.randint(-2**31, 2**31, (4096, 2), generator=g, dtype=torch.int64, device=cuda)
    key = words.to(torch.int32).view(torch.uint32)
    frame = torch.randint(-2**31, 2**31, (4096,), generator=g, dtype=torch.int64,
                          device=cuda).to(torch.int32)
    folded = _launched(prng.fold_in, key, frame)
    _same(folded, prng.fold_in_plain(key, frame))
    want = prng.uniform_plain(prng.fold_in_plain(folded, 3), (2048,))
    _same(_launched(prng.fold_uniform, folded, 3, (2048,)), want)
    _same(_launched(prng.uniform, prng.fold_in(folded, 3), (2048,)), want)
    _same(_launched(prng.bits, folded, (2048,)), prng.bits_plain(folded, (2048,)))
    cpu = prng.uniform_plain(prng.fold_in_plain(folded.cpu(), 3), (2048,))
    _same(prng.fold_uniform(folded, 3, (2048,)), cpu)
    u = prng.fold_uniform(folded, 3, (2048,))
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0


def test_counters_past_the_sign_bit_and_the_low_word(cuda):
    """A draw of 2^32 + 6 floats (17 GB): its counters cross 2^31 (the
    low word's sign bit) and 2^32 (the high word), and n % 4 != 0 takes the
    kernel's word-by-word stores. The words around both crossings and at
    the end equal the plain hash of those counters."""
    n = 2**32 + 6
    key = _keys(torch.uint32, cuda)[1]
    u = _launched(prng.uniform, key, (n,))
    words = prng._words(key)
    for lo, hi in ((2**31 - 8, 2**31 + 8), (2**32 - 8, n)):
        c = torch.arange(lo, hi, dtype=torch.int64, device=cuda)
        y0, y1 = prng.threefry2x32(words[0], words[1], c >> 32, c & prng.MASK)
        want = ((((y0 ^ y1) >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0)
        _same(u[lo:hi], want)
    del u
    torch.cuda.empty_cache()


def test_against_the_benchmark_reference(cuda):
    """The benchmark's own generator (benchmark/reference/ops.py), read only:
    a per-world frame fold, then 2048 uniforms a world."""
    from benchmark.reference import ops as ref

    key = _keys(torch.int32, cuda)
    frame = torch.tensor([0, 1, -5, 2**31 - 1, 77], dtype=torch.int32, device=cuda)
    _same(prng.fold_in(key, frame), ref.fold_in(key, frame))
    k = ref.fold_in(key, frame)
    _same(prng.fold_uniform(key, frame, (2048,)), ref.uniform(k, 2048))
    _same(prng.fold_uniform(prng.fold_in(key, frame), 4, (2048,)),
          ref.uniform(ref.fold_in(k, 4), 2048))


def test_refuses_bad_operands(cuda):
    key = _keys(torch.int64, cuda)
    before = prng.threefry_cuda.launches
    with pytest.raises(ValueError, match="contiguous"):
        prng.fold_in(torch.zeros((4, 2), dtype=torch.int64, device=cuda)[::2], 1)
    with pytest.raises(ValueError, match="contiguous"):
        prng.uniform(torch.zeros((2, 4), dtype=torch.int64, device=cuda).t()[:2], (8,))
    with pytest.raises(ValueError, match="contiguous"):
        prng.fold_in(key, torch.arange(10, dtype=torch.int32, device=cuda)[::2])
    with pytest.raises(ValueError, match="is on cpu"):
        prng.fold_in(key, torch.arange(5, dtype=torch.int32))
    with pytest.raises(ValueError, match="is on cpu"):
        prng.fold_uniform(key, torch.arange(5, dtype=torch.int32), (8,))
    with pytest.raises(ValueError, match="int16"):
        prng.fold_in(key.to(torch.int16), 1)
    with pytest.raises(ValueError, match=r"\[\.\.\., 2\]"):
        prng.uniform(torch.zeros((4, 3), dtype=torch.int64, device=cuda), (8,))
    assert prng.threefry_cuda.launches == before


def test_flagship_frame_draws_through_the_kernel(cuda, monkeypatch):
    """One frame of the flagship at W=8 launches the kernel once for each
    fold and draw it asks for, runs no plain Threefry on the card, and each
    launch's output equals the plain version on the same operands."""
    from lumixengine_tpu_torch.models.demo_scenes import full_frame_world
    from lumixengine_tpu_torch.parallel.mesh import replicate_state

    engine, world, *_ = full_frame_world(10240, 64, 64, 2048)
    step = engine.build_step(world, cuda, extra=world.modules["renderer"].cull_pass)
    state = replicate_state(world.device_state(cuda), 8, torch.Generator(device=cuda).manual_seed(0))
    state = step(state, 1.0 / 60.0)

    plain = {"fold_in": prng.fold_in_plain, "split": prng.split_plain, "bits": prng.bits_plain,
             "uniform": prng.uniform_plain,
             "fold_uniform": lambda k, d, s: prng.uniform_plain(prng.fold_in_plain(k, d), s)}
    calls = []
    for name in plain:
        def record(*args, _fn=getattr(prng, name), _name=name):
            out = _fn(*args)
            calls.append((_name, args, out))
            return out
        monkeypatch.setattr(prng, name, record)
    hash_plain = prng.threefry2x32

    def plain_off_the_card(*words):
        assert not any(isinstance(w, torch.Tensor) and w.is_cuda for w in words)
        return hash_plain(*words)

    monkeypatch.setattr(prng, "threefry2x32", plain_off_the_card)
    before = prng.threefry_cuda.launches
    step(state, 1.0 / 60.0)
    torch.cuda.synchronize()
    monkeypatch.setattr(prng, "threefry2x32", hash_plain)
    names = [c[0] for c in calls]
    assert names.count("fold_uniform") == 5 and names.count("fold_in") == 6, names
    assert prng.threefry_cuda.launches == before + len(calls)
    for name, args, out in calls:
        _same(out, plain[name](*args))
