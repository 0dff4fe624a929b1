"""Per-rank operation counts of one step: the port's counterpart of
``repro/launch/hlo_utils.py``.

The reference compiles a cell and parses XLA's partitioned HLO, which is
one device's program.  The port has no HLO: it runs the step once, on
DTensors over a process group (a fake one in ``launch.dryrun``), under
``OpCounter``, a dispatch mode that sees each rank's LOCAL operations.
It declines every operation on a DTensor (``NotImplemented``), so the
DTensor runs it and dispatches the local operations it issues, the
collectives of its redistributions included, back through the mode.
(``torch.utils.flop_counter.FlopCounterMode`` counts the DTensor's
global operation instead, the whole product on every rank.)

Counterparts, function for function:

  * ``OpCounter.dot_flops``        -- ``HloModule.total_dot_flops``:
    2 * M * N * K of every matrix product (mm, addmm, bmm, baddbmm; an
    einsum or a matmul reaches these) of one rank's local tensors;
  * ``OpCounter.collective_bytes`` -- ``HloModule.total_collective_bytes``:
    result bytes by kind, the reference's kinds (``all-reduce``,
    ``all-gather``, ``reduce-scatter``, ``all-to-all``,
    ``collective-permute``), of the functional and c10d collectives the
    rank issues;
  * ``count`` -- ``analyze``: both, plus ``collective_total``.

The reference's loop multipliers (``_propagate``, ``_trip_count``) have
no counterpart: eager PyTorch runs every layer and every recomputation,
so nothing is counted once for a loop body.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# dispatcher op (namespace.name) -> (kind, which tensor holds the result:
# "out" the op's return value, or the index of an argument)
_COLLECTIVES = {
    "_c10d_functional.all_reduce": ("all-reduce", "out"),
    "_c10d_functional.all_reduce_": ("all-reduce", "out"),
    "_c10d_functional.all_reduce_coalesced": ("all-reduce", "out"),
    "_c10d_functional.all_gather_into_tensor": ("all-gather", "out"),
    "_c10d_functional.all_gather_into_tensor_coalesced":
        ("all-gather", "out"),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", "out"),
    "_c10d_functional.reduce_scatter_tensor_coalesced":
        ("reduce-scatter", "out"),
    "_c10d_functional.all_to_all_single": ("all-to-all", "out"),
    "c10d.allreduce_": ("all-reduce", 0),
    "c10d.allgather_": ("all-gather", 0),
    "c10d._allgather_base_": ("all-gather", 0),
    "c10d.reduce_scatter_": ("reduce-scatter", 0),
    "c10d._reduce_scatter_base_": ("reduce-scatter", 0),
    "c10d.alltoall_": ("all-to-all", 0),
    "c10d.alltoall_base_": ("all-to-all", 0),
    "c10d.send": ("collective-permute", 0),
}


def _nbytes(x) -> float:
    if isinstance(x, torch.Tensor):
        return float(x.numel() * x.element_size())
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0.0


def _matmul_flops(name: str, args, out) -> float:
    """2 * (elements of the product) * (contracted length)."""
    if name in ("aten.mm", "aten.bmm"):
        k = args[0].shape[-1]
    elif name in ("aten.addmm", "aten.baddbmm"):
        k = args[1].shape[-1]
    else:
        return 0.0
    return 2.0 * out.numel() * k


class OpCounter(TorchDispatchMode):
    """Counts one rank's matrix-product FLOPs and collective bytes."""

    def __init__(self):
        super().__init__()
        self.dot_flops = 0.0
        self.collective_bytes: Dict[str, float] = defaultdict(float)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # count its local operations
        out = func(*args, **(kwargs or {}))
        if any(issubclass(t, FakeTensor) for t in types):
            # DTensor's sharding propagation runs an op once on fake
            # tensors of the global shapes to learn its output's: not
            # part of any rank's computation
            return out
        name = f"{func.namespace}.{func._opname}"
        self.dot_flops += _matmul_flops(name, args, out)
        coll = _COLLECTIVES.get(name)
        if coll is not None:
            kind, at = coll
            self.collective_bytes[kind] += _nbytes(out if at == "out"
                                                   else args[at])
        return out

    def summary(self) -> dict:
        coll = {k: v for k, v in self.collective_bytes.items() if v}
        return {"dot_flops": self.dot_flops, "collective_bytes": coll,
                "collective_total": sum(coll.values())}


def count(fn: Callable, *args, **kwargs) -> Tuple[object, dict]:
    """``(fn(*args, **kwargs), {"dot_flops", "collective_bytes",
    "collective_total"})`` of one rank."""
    with OpCounter() as counter:
        out = fn(*args, **kwargs)
    return out, counter.summary()
