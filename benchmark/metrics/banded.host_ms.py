"""banded.host_ms: the host's milliseconds in the physics module's
update_parallel (the span physics.update_parallel: the contact stage and the
banded pipeline's dispatch, and any wait on a full launch queue), median
over the frames of a host pass of its own: the traffic's trace_frames frames
from the window's last state with the program's recorder on and no profiler
session, as in the window. None off the card, or where the frame records no
banded span (another branch, or a program without them)."""
import statistics

from benchmark.harness import spans

SPAN, BANDED = "physics.update_parallel", "physics.banded_sort"
_MEMO = "_banded_host_ms"


def read(run):
    if not run.on_card:
        return None
    if not hasattr(run, _MEMO):
        frames = int(run.cell.traffic["trace_frames"])
        _, blocks = spans.recorded(lambda: spans.run_frames(run.step, run.state, run.dt, frames,
                                                            run.clock.sync))
        ms = [(b - a) * 1e3 for n, a, b in blocks if n == SPAN]
        banded = any(n == BANDED for n, _a, _b in blocks)
        setattr(run, _MEMO, statistics.median(ms) if ms and banded else None)
    return getattr(run, _MEMO)
