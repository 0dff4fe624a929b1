"""Serving engine: the median over every request of the window's waves
of ``RequestResult.tpot``, in ms.  Read on the host's clock, it moves
with the host's speed as much as with the program, so it is a per-layer
reading beside ``serve_tokens_per_s`` and not held end to end (PERF.md
section 2)."""


def read(run):
    e2e = run.out.get("e2e")
    return e2e.get("tpot_ms_p50") if e2e else None
