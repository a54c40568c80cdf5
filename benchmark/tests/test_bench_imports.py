"""What the benchmark loads: nothing of the JAX side (top-level names
compared whole: ``lumixengine_tpu_torch`` is not ``lumixengine_tpu``), and
a reference that imports nothing of the port."""
import ast
import os
import subprocess
import sys

from benchmark.harness import cell, spec

REFERENCE_DIR = os.path.join(spec.BENCH_DIR, "reference")
JAX_SIDE = set(cell.FORBIDDEN)


def imported_tops(path):
    tops = set()
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def python_files(top):
    for d, _dirs, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_file_of_the_benchmark_imports_the_jax_side():
    for path in python_files(spec.BENCH_DIR):
        assert not imported_tops(path) & JAX_SIDE, path


def test_the_reference_imports_nothing_of_the_port():
    """Every file under ``reference/``: the default reference's and each
    reference a configuration brings of its own, those added later too."""
    files = list(python_files(REFERENCE_DIR))
    assert len(files) >= 3
    for path in files:
        assert "lumixengine_tpu_torch" not in imported_tops(path), path
        assert not imported_tops(path) & JAX_SIDE, path


def test_the_reference_loads_nothing_of_the_port():
    """The reference built and stepped in a fresh process: no module of the
    port or of the JAX side is loaded."""
    code = (
        f"import sys; sys.path.insert(0, {spec.ROOT!r})\n"
        "import torch\n"
        "from benchmark.reference import model, recipe\n"
        "from benchmark.tests.small import SMALL_ARGS\n"
        "cfg = {'builder': 'models.demo_scenes.full_frame_world', 'args': SMALL_ARGS['full_frame']}\n"
        "m = model.Model(recipe.build(cfg, 3), 'cpu')\n"
        "m.frame(m.start(2, torch.Generator().manual_seed(3)), 1 / 60)\n"
        "print(sorted({n.split('.')[0] for n in sys.modules} & {'lumixengine_tpu_torch', "
        "'lumixengine_tpu', 'jax', 'jaxlib', 'flax'}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_run_loads_no_module_of_the_jax_side():
    """A small cell run in a fresh process, every metric reader and the
    reference loaded, then the run's own look at sys.modules."""
    code = (
        "import sys, time; t0 = time.perf_counter()\n"
        f"sys.path.insert(0, {spec.ROOT!r})\n"
        "from benchmark.harness import cell as C, spec\n"
        "from benchmark.tests.small import small_cell, SEED\n"
        "c = small_cell('full_frame.w4096', 2)\n"
        "c.per_layer = spec.benchmark()['per_layer']\n"
        "C.run_cell(c, SEED, 0.3, True, 'cpu', t0)\n"
        "tops = sorted({m.split('.')[0] for m in sys.modules})\n"
        "assert 'lumixengine_tpu_torch' in tops and 'benchmark' in tops\n"
        "print(sorted(set(tops) & set(C.FORBIDDEN)))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card():
    """benchmark/run.py exits non-zero and prints no result without a CUDA
    device."""
    out = subprocess.run([sys.executable, os.path.join(spec.BENCH_DIR, "run.py"), "--workload",
                          "crowd.w4096", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
