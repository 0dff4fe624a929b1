"""Serving engine: the median over every request of the window's waves
of ``RequestResult.queue_wait``, in ms: the engine's clock when the
request first left the queue, minus its arrival.  All of a wave's
requests are due at t=0, so a request waits for the slots that free
before it (and their prompts' replays).  Read on the host's clock; a
program whose results carry no ``queue_wait`` gives nothing."""

import statistics


def read(run):
    waits = [getattr(r, "queue_wait", None)
             for w in run.out["window"]["waves"]
             for r in w["report"].results]
    if not waits or None in waits:
        return None
    return statistics.median(waits) * 1e3
