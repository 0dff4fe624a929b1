"""Device: ms a traced engine step in which the device idled while the
host was inside the model's step (``model.decode_step`` or a span under
it), by the program's own spans (``repro_torch.tracing``).

Each idle stretch of the engine's profile (``Trace.gaps``) is put down
to the innermost span that covers its middle, of the spans recorded in
the profile's window: on one thread spans nest, so that is the latest
span to start before the middle, or the nearest span enclosing it that
is still open there.  Stretches under ``model.decode_step`` or its
children count here; those under an ``engine.*`` span and outside the
model's step count in ``device.idle_ms.engine``; those under no span in
neither.  Of the model's, those under a layer's mixer
(``model.attention``) count again in ``device.idle_ms.attention``, and
those under an MoE FFN (``moe_forward``) in ``device.idle_ms.moe``.  A
program without the tracer, or a profile with no span in its window,
gives nothing."""

import bisect

MODEL = "model.decode_step"
ENGINE = "engine."
ATTENTION = "model.attention"
MOE = "moe_forward"


def split(run):
    """ns of the traced idle time {"model", "engine", "none"}, by the span
    the host was in, and of the model's under {"attention", "moe"} (see
    above), and the traced steps; None where there is nothing to read."""
    tr = run.out.get("device_trace")
    if tr is None:
        return None
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    spans = tracing.spans(*tr.window)
    if not spans:
        return None
    starts = [s.start_ns for s in spans]
    by = {s.index: s for s in spans}
    out = {"model": 0, "engine": 0, "none": 0, "attention": 0, "moe": 0}
    for a, b in tr.gaps():
        mid = (a + b) // 2
        j = bisect.bisect_right(starts, mid) - 1
        s = spans[j] if j >= 0 else None
        while s is not None and s.end_ns < mid:
            s = by.get(s.parent)
        names = []
        while s is not None:
            names.append(s.name)
            s = by.get(s.parent)
        if MODEL in names:
            out["model"] += b - a
            if ATTENTION in names:
                out["attention"] += b - a
            elif MOE in names:
                out["moe"] += b - a
        elif any(n.startswith(ENGINE) for n in names):
            out["engine"] += b - a
        else:
            out["none"] += b - a
    return out, tr.steps


def read(run):
    got = split(run)
    if got is None:
        return None
    ns, steps = got
    return ns["model"] / steps / 1e6
