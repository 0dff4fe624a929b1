"""Device: ms a traced engine step in which the device idled while the
host was inside an ``engine.*`` span and outside the model's step
(``model.decode_step``): admission, replay bookkeeping, uploads,
readbacks, retirement.  Attributed as ``device.idle_ms.model`` says,
whose ``split`` it reads."""

from bench.harness import spec


def read(run):
    got = spec.module("metrics", "device.idle_ms.model").split(run)
    if got is None:
        return None
    ns, steps = got
    return ns["engine"] / steps / 1e6
