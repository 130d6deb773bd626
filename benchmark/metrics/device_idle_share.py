"""device_idle_share (layer: device): 1 - the union of the kernel, memcpy
and memset intervals of the traced window over the window's wall
(``devtrace.device_busy``, a frozen copy of chip_smoke.py's)."""


def read(run):
    if run.trace is None:
        return None
    return 1.0 - run.trace.busy_s / run.window_s
