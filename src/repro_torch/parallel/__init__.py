"""Distribution layer of the port (``repro/parallel``): an APEX plan to a
``torch.distributed`` ``DeviceMesh`` and DTensor placements, plus the
explicitly scheduled parallel patterns (GPipe pipeline, expert-parallel
dispatch, sequence-parallel flash-decoding) and deploy-time head padding.

The reference writes its patterns as ``shard_map`` bodies over a JAX
``Mesh``.  Here each function is the body: it takes the rank's LOCAL
shard and a ``torch.distributed.device_mesh.DeviceMesh`` whose axes carry
the reference's names (``"pod"``, ``"data"``, ``"model"``, ``"stage"``),
reads its groups with ``mesh.get_group(name)`` and its coordinate with
``mesh.get_local_rank(name)``.  The collectives, mapped once:

=========================================================  ==============================================
JAX (``shard_map`` body)                                   port
=========================================================  ==============================================
``jax.lax.axis_index(axis)``                               ``mesh.get_local_rank(axis)``
``pmax``                                                   ``all_reduce(op=MAX)`` on the axis group
``psum``                                                   ``all_reduce(op=SUM)``
``pmean``                                                  ``all_reduce(op=SUM)`` / group size (gloo has
                                                           no AVG)
``all_to_all(x, split_axis=0, concat_axis=0,               ``all_to_all_single`` on the contiguous buffer
tiled=False)`` on a ``(tp, ...)`` buffer
``ppermute`` ring ``i -> (i+1) % n``                       ``batch_isend_irecv``; when the axis has size 1
                                                           the permute is the identity and no P2P op is
                                                           issued
``device_put(x, NamedSharding(mesh, spec))``               ``distribute_tensor(x, mesh,
                                                           spec_to_placements(spec, mesh))``
=========================================================  ==============================================

A spec is a tuple with one entry per tensor dim, as a ``PartitionSpec``
is: an axis name, a tuple of names (major to minor), or None.  The rules
of ``sharding`` also take a plain mapping of axis sizes in place of a
mesh, so specs for a 16 x 16 or 2 x 16 x 16 mesh need no ranks.

The process groups are the caller's: on the CPU gloo ranks, on the card
NCCL (one H100 runs world size 1).
"""

from .plan_sharding import MaterializedPlan, plan_to_shardings
from .sharding import (batch_pspec, cache_pspecs, param_pspecs,
                       spec_to_placements, to_shardings)

__all__ = ["MaterializedPlan", "batch_pspec", "cache_pspecs",
           "param_pspecs", "plan_to_shardings", "spec_to_placements",
           "to_shardings"]
