"""MoE FFN: device ms a probe step in the kernels launched inside the
``moe_forward`` ranges (the program's ``launch.fig6.expert_range``)."""

RANGE = "moe_forward"


def read(run):
    probe = run.out.get("probe")
    if not probe:
        return None
    tr = probe["trace"]
    ns = tr.in_range_ns(RANGE)
    return ns / tr.steps / 1e6 if ns else None
