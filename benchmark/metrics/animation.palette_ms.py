"""animation.palette_ms: device time a frame of the skinning palettes (the
span animation.palette around each build_palette_dq and its index_copy in
both animation phases; harness/spans.py)."""
from benchmark.harness import spans


def read(run):
    return spans.device_ms(run, "animation.palette")
