"""chain_ms_per_kread (layer: kernels): kernel B4's (``chain_fused_kernel``,
csrc/chain_fused.cu) device ms in the traced window, graph replays
included, per 1,000 reads completed.  Nothing when the trace has no such
kernel."""

KERNEL = "chain_fused_kernel"


def read(run):
    if run.trace is None or not run.completed:
        return None
    s = run.trace.seconds_of(KERNEL)
    if s is None:
        return None
    return s * 1000 / (run.completed / 1000)
