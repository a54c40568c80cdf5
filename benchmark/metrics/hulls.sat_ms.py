"""hulls.sat_ms: device time a frame of the span physics.banded_hulls: the
banded branch's polytope SAT over the hull pairs' partner views, one call a
sweep (ops/physics_banded.py banded_polytope_grids), inside
physics.banded_grids (harness/spans.py). None where the program has no
such span."""
from benchmark.harness import spans


def read(run):
    return spans.device_ms(run, "physics.banded_hulls")
