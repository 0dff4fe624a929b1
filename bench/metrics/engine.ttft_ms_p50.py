"""Serving engine: the median over every request of the window's waves
of ``RequestResult.ttft``, in ms, from t=0 of its wave on the engine's
clock.  Read on the host's clock, it moves with the host's speed as much
as with the program, so it is a per-layer reading beside
``serve_tokens_per_s`` and not held end to end (PERF.md section 2)."""


def read(run):
    e2e = run.out.get("e2e")
    return e2e.get("ttft_ms_p50") if e2e else None
