"""frame_ms_p95: the 95th percentile of every frame's time in the window,
from the CUDA events at the frames' boundaries (linear interpolation)."""
import numpy as np


def read(run):
    return float(np.percentile(run.window.frame_ms, 95)) if run.window.frame_ms else None
