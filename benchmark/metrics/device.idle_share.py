"""device.idle_share: the share of an untraced frame in which no operation
ran on the device: 1 - (the device's busy time a frame, the union of its
operations' intervals over the traced frames, divided by their number) /
(the mean frame time of the measured window, from its CUDA events).

The busy time comes from the trace, which records the device's activity
alone and barely moves the kernels' times; the frame time comes from the
untraced window, since the profiler slows the host's dispatch and so
lengthens the traced frames themselves (the `device` entry's `busy_s` and
`window_s` keep the traced window's own)."""


def read(run):
    tr, win = run.trace, run.window
    if tr is None or not run.on_card or tr.busy_s <= 0 or not win.frames:
        return None
    frame_s = win.seconds / win.frames
    return 100.0 * (1.0 - (tr.busy_s / tr.frames) / frame_s)
