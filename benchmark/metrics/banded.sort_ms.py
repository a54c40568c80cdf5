"""banded.sort_ms: device time a frame of the span physics.banded_sort in
physics/module.py's banded branch: the AABBs, the four sweep orders and
their rank maps (harness/spans.py). None where the program has no such span."""
from benchmark.harness import spans


def read(run):
    return spans.device_ms(run, "physics.banded_sort")
