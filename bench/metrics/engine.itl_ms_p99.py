"""Serving engine: the 99th percentile of the gaps between consecutive
tokens of a request (``RequestResult.token_times``), in ms, over every
request of the window's waves.  A wave of the chat mix serves 1,680
tokens to 16 requests, 1,664 gaps, so about 16 lie beyond the
percentile in each wave.  A gap spans every decode step between two of
a request's tokens, so a prompt replayed for another request in that
time (up to 128 steps) sets the tail.  Read on the host's clock; a
program whose results carry no ``token_times`` gives nothing."""

import numpy as np


def read(run):
    gaps = []
    for w in run.out["window"]["waves"]:
        for r in w["report"].results:
            times = getattr(r, "token_times", None)
            if times is None:
                return None
            gaps.extend(np.diff(times))
    if not gaps:
        return None
    return float(np.percentile(gaps, 99)) * 1e3
