"""Device: ms a traced engine step in which the device idled while the
host was inside a layer's mixer (``model.attention``: the projections, RoPE,
the cache write and the attention kernel of a GQA, MLA or SSM layer).  Attributed as ``device.idle_ms.model`` says,
whose ``split`` it reads; a part of that metric's time."""

from bench.harness import spec


def read(run):
    got = spec.module("metrics", "device.idle_ms.model").split(run)
    if got is None:
        return None
    ns, steps = got
    return ns["attention"] / steps / 1e6
