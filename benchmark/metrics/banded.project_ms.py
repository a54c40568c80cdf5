"""banded.project_ms: device time a frame of the span physics.banded_project in
physics/module.py's banded branch: the position projection,
project_positions_banded_multi (harness/spans.py). None where the program
has no such span."""
from benchmark.harness import spans


def read(run):
    return spans.device_ms(run, "physics.banded_project")
