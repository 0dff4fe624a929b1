"""Device: the share of the profiled engine steps' wall time in which no
device activity ran."""


def read(run):
    tr = run.out.get("device_trace")
    if tr is None or not len(tr.kernel_start):
        return None
    return 100.0 * (1.0 - tr.busy_ns() / tr.window_ns())
