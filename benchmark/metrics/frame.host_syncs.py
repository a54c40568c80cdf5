"""frame.host_syncs: the blocking CUDA runtime calls a frame inside the span
engine.frame (cudaStreamSynchronize, cudaDeviceSynchronize,
cudaEventSynchronize, the blocking cudaMemcpy), from the device pass's
trace (harness/spans.py)."""
from benchmark.harness import spans


def read(run):
    sp = spans.of(run)
    return None if sp is None else sp.host_syncs
