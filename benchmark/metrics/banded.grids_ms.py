"""banded.grids_ms: device time a frame of the span physics.banded_grids in
physics/module.py's banded branch: per sweep: the pair grids, their masks,
the cross-sweep coverage, the window certificate and the warm-start match
(harness/spans.py). None where the program has no such span."""
from benchmark.harness import spans


def read(run):
    return spans.device_ms(run, "physics.banded_grids")
