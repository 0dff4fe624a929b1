"""Serving engine: the share of slot-iterations of the engine's main loop
that produced a token, across the window's waves: tokens generated after
each request's first, over (main-loop iterations x slots)."""


def read(run):
    waves = run.out["window"]["waves"]
    made = sum(len(r.tokens) - 1 for w in waves for r in w["report"].results)
    slots = run.mix["slots"] * sum(w["report"].iterations for w in waves)
    return 100.0 * made / slots if slots else None
