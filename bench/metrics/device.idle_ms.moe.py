"""Device: ms a traced engine step in which the device idled while the
host was inside an MoE FFN (``moe_forward``: routing and the dispatch over
the experts).  Attributed as ``device.idle_ms.model`` says,
whose ``split`` it reads; a part of that metric's time."""

from bench.harness import spec


def read(run):
    got = spec.module("metrics", "device.idle_ms.model").split(run)
    if got is None:
        return None
    ns, steps = got
    return ns["moe"] / steps / 1e6
