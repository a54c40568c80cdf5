"""Run one cell of the benchmark of lumixengine_tpu_torch once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA devices the cell
asks for. The last line of standard output is the result as one JSON
object; the numbers compared with the plain reference are the last lines of
standard error. See benchmark/README.md.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT
# every cache a run writes stays inside the checkout, at fixed paths
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = os.path.join(ROOT, ".bench_cache", _sub)

if __name__ == "__main__":
    from benchmark.harness.cell import main

    sys.exit(main(sys.argv[1:], T0))
