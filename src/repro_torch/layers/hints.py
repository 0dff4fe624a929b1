"""Sharding hints usable from inside model code (``repro/layers/hints.py``),
and the mesh primitives every layer above reads: a mesh's axis sizes,
its batch axes, a spec as DTensor placements.

``shard_hint(x, *spec)`` redistributes ``x`` iff a mesh is active
(``launch.mesh.mesh_context`` sets it) AND ``x`` is a ``DTensor``; a plain
tensor comes back unchanged, so model code stays mesh-agnostic and on one
device every hint is a no-op.  As in the reference, each spec entry whose
axes' size does not divide its dim is dropped (``_sanitize``).

The reference calls these hints from its model code (the batch reshard
around attention, the MoE layout choice), where ``jit`` partitions the
sharded arrays.  The port's forward passes plain tensors to its kernels,
so no model code calls them yet: their call sites come with the
mesh-wide sharded train step (ROADMAP queue 1).

A mesh is a ``DeviceMesh`` or a plain mapping of axis names to sizes, in
mesh order.
"""

from __future__ import annotations

from contextvars import ContextVar
from typing import Dict, Mapping

# the mesh of the innermost ``launch.mesh.mesh_context``, or None
ACTIVE_MESH: ContextVar = ContextVar("repro_torch_active_mesh",
                                     default=None)


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` in mesh order."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    if mesh.mesh_dim_names is None:
        raise ValueError("the mesh's axes need names")
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def data_axes(mesh) -> tuple:
    """The batch axes of a mesh: ("pod", "data") where present."""
    sizes = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def spec_to_placements(spec, mesh) -> tuple:
    """A spec as DTensor placements on ``mesh`` (a ``DeviceMesh``), one per
    mesh dim: ``Shard(d)`` on each axis that tensor dim ``d`` is sharded
    over, ``Replicate()`` elsewhere.  A dim sharded over several axes
    (``("pod", "data")``) becomes several ``Shard(d)``, which DTensor
    splits in mesh order: the axes must be named major to minor in mesh
    order, as the reference's ``PartitionSpec`` reads them."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(axis_sizes(mesh))
    placements = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec}: axis {a!r} is not in the "
                                 f"mesh's axes {tuple(names)}")
        at = [names.index(a) for a in axes]
        if at != sorted(at) or len(set(at)) != len(at):
            raise ValueError(f"spec {spec}: axes {axes} must follow the "
                             f"mesh's order {tuple(names)}, once each")
        for i in at:
            if placements[i] != Replicate():
                raise ValueError(f"spec {spec}: axis {names[i]!r} shards "
                                 f"two dims")
            placements[i] = Shard(dim)
    return tuple(placements)


def mesh_axis_size(name: str) -> int:
    """The active mesh's size along ``name``; 1 without a mesh or axis."""
    mesh = ACTIVE_MESH.get()
    return 1 if mesh is None else axis_sizes(mesh).get(name, 1)


def data_axis_names() -> tuple:
    """The active mesh's batch axes; () without a mesh."""
    mesh = ACTIVE_MESH.get()
    return () if mesh is None else data_axes(mesh)


def _sanitize(x, entries) -> tuple:
    """Drop PER DIM any entry whose axes' size does not divide the dim
    (batch 1 must not veto a sequence sharding)."""
    out = []
    for dim, entry in zip(x.shape, entries):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        total = 1
        for a in axes:
            total *= mesh_axis_size(a)
        out.append(entry if (total <= 1 or dim % total == 0) else None)
    return tuple(out)


def shard_hint(x, *spec_entries):
    """``x`` redistributed to the sanitised spec on the active mesh when
    ``x`` is a ``DTensor``; ``x`` itself otherwise."""
    mesh = ACTIVE_MESH.get()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = _sanitize(x, spec_entries)
    if all(e is None for e in spec):
        return x
    return x.redistribute(mesh, spec_to_placements(spec, mesh))
