"""device.peak_mem_gib: torch.cuda.max_memory_allocated over the window,
reset just before it, in GiB."""


def read(run):
    return None if run.window_peak_bytes is None else run.window_peak_bytes / 2 ** 30
