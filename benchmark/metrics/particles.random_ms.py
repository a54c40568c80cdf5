"""particles.random_ms: device time a frame of the particle scripts' random
draws (the span particles.random around the Threefry fold_in and uniform
in renderer/particle_compiler.py's rand_uniform; harness/spans.py)."""
from benchmark.harness import spans


def read(run):
    return spans.device_ms(run, "particles.random")
