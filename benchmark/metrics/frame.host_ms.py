"""frame.host_ms: the host's milliseconds in the frame step, the span
engine.frame read from the program's ring, median over the host pass's
frames (no profiler session, as in the window): dispatch, and any wait on
a full launch queue or a synchronise (harness/spans.py)."""
import statistics

from benchmark.harness import spans


def read(run):
    sp = spans.of(run)
    return None if sp is None else statistics.median(sp.frame_host_ms)
