"""Sharding hints usable from inside model code (``repro/layers/hints.py``),
and the mesh primitives every layer above reads: a mesh's axis sizes,
its batch axes, a spec as DTensor placements.

``shard_hint(x, *spec)`` redistributes ``x`` iff a mesh is active
(``launch.mesh.mesh_context`` sets it) AND ``x`` is a ``DTensor``; a plain
tensor comes back unchanged, so model code stays mesh-agnostic and on one
device every hint is a no-op.  As in the reference, each spec entry whose
axes' size does not divide its dim is dropped (``_sanitize``).

The model calls these hints where the reference does (the batch
reshard around attention, the MoE layout choice).  Where ``jit``
partitions the reference's sharded arrays, the port's layers run on
DTensors, and ``on_shards`` hands each kernel wrapper one rank's local
shards (``local_map``), so that a kernel never sees a DTensor.

A mesh is a ``DeviceMesh`` or a plain mapping of axis names to sizes, in
mesh order.
"""

from __future__ import annotations

from contextvars import ContextVar
from typing import Callable, Dict, Mapping, Optional, Sequence

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

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
    if not isinstance(x, DTensor):
        return x
    spec = _sanitize(x, spec_entries)
    if all(e is None for e in spec):
        return x
    return x.redistribute(mesh, spec_to_placements(spec, mesh))


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def shard_offset(x, dim: int):
    """(the mesh dims that shard ``dim`` of the DTensor ``x``, this rank's
    first index along ``dim``): DTensor cuts a dim sharded over several
    mesh dims in mesh order, the first one major."""
    mesh = x.device_mesh
    at = [i for i, p in enumerate(x.placements)
          if isinstance(p, Shard) and p.dim == dim]
    n = 1
    coord = 0
    for i in at:
        coord = coord * mesh.size(i) + mesh.get_local_rank(i)
        n *= mesh.size(i)
    return at, coord * (x.shape[dim] // n)


def table_rows(table, ids):
    """``table[ids]``: the rows of an embedding table (V, d).

    On a DTensor table, a vocab-parallel lookup on each rank's shards
    (``on_shards``, the table's placements first): the rank takes the
    rows of its vocab shard for its ids (the batch keeps its sharding)
    and zeros for the others, and the vocab shards' outputs are summed at
    once (an all-reduce of the rows).  DTensor's own index and embedding
    rules are not used: their sharding propagation fails in the backward
    (torch 2.11) or on a batch-sharded lookup of a vocab-sharded table
    (2.13)."""
    if not is_dtensor(table):
        return table[ids]
    v0 = shard_offset(table, 0)[1]

    def lookup(tab, ids):
        j = ids - v0
        mine = (j >= 0) & (j < tab.shape[0])
        out = tab[j.clamp(0, tab.shape[0] - 1)]
        return out * mine[..., None].to(out.dtype)

    out = on_shards(lookup, (table, ids), ({"vocab": 0}, {"batch": 0}),
                    {"batch": 0, "vocab": "sum"})
    return out.redistribute(out.device_mesh, [
        Replicate() if p.is_partial() else p for p in out.placements])


def whole_last(x):
    """``x`` with its last dim whole on every rank: a DTensor sharded
    along it is gathered there; anything else comes back as it is."""
    if not is_dtensor(x):
        return x
    last = x.dim() - 1
    return x.redistribute(x.device_mesh, [
        Replicate() if isinstance(p, Shard) and p.dim == last else p
        for p in x.placements])


def split_last(x, *shape):
    """``x (..., F).reshape(*shape)`` with ``shape`` ending in ``(H, D)``,
    H * D = F: a flat dim split into heads.  A DTensor sharded along F
    over mesh dims whose sizes do not divide H is gathered along F first;
    a view cannot cut a head in two."""
    if is_dtensor(x):
        at = shard_offset(x, x.dim() - 1)[0]
        n = 1
        for i in at:
            n *= x.device_mesh.size(i)
        if shape[-2] % n:
            x = whole_last(x)
    return x.reshape(*shape)


def on_shards(fn: Callable, args: Sequence, dims: Sequence[Optional[dict]],
              out_dims):
    """``fn(*args)`` on one rank's local shards when an argument is a
    ``DTensor``; ``fn(*args)`` itself otherwise.

    ``dims[i]`` names the dims of ``args[i]`` that may stay sharded, as
    ``{role: tensor dim}`` (None for an argument that is not a tensor);
    ``out_dims`` does the same for each output (a dict, or a tuple of
    them), where the dim ``"sum"`` marks an output that is a partial sum
    over that role's shards.  A plain tensor among DTensors is taken as
    replicated.  A mesh dim takes the role of the first argument that is
    ``Shard(d)`` there with ``d`` one of its roles' dims: every argument
    and output with that role is sharded there along its own dim, and one
    without it is replicated there.  Every other mesh dim (a dim sharded
    along no role, a ``Partial`` sum) is replicated first, and so is a
    role whose dim in some argument the mesh dims on it do not divide.
    The inputs are redistributed to these placements
    (``local_map(redistribute_inputs=True)``), ``fn`` runs on the local
    tensors and its outputs come back as DTensors.  The gradient of an
    argument replicated on a mesh dim that carries a role is ``Partial``
    there: each rank's share of it comes from its own shard of the
    data."""
    lead = next((a for a in args if is_dtensor(a)), None)
    if lead is None:
        return fn(*args)
    mesh = lead.device_mesh
    roles = [None] * mesh.ndim
    for a, rd in zip(args, dims):
        if rd is None or not is_dtensor(a):
            continue
        by_dim = {d: r for r, d in rd.items()}
        for i, p in enumerate(a.placements):
            if roles[i] is None and isinstance(p, Shard) \
                    and p.dim in by_dim:
                roles[i] = by_dim[p.dim]
    for r in set(roles) - {None}:
        at = [i for i, q in enumerate(roles) if q == r]
        n = 1
        for i in at:
            n *= mesh.size(i)
        if any(a.shape[rd[r]] % n for a, rd in zip(args, dims)
               if rd is not None and r in rd):
            for i in at:
                roles[i] = None

    def placements(rd):
        if rd is None:
            return None
        return tuple(Replicate() if r is None or r not in rd
                     else Partial() if rd[r] == "sum" else Shard(rd[r])
                     for r in roles)

    # a plain tensor beside DTensors is the same on every rank
    # (``implicit_replication``): it becomes a replicated DTensor, so it
    # is cut like the others
    args = tuple(DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
                 if rd is not None and isinstance(a, torch.Tensor)
                 and not is_dtensor(a) else a
                 for a, rd in zip(args, dims))
    ins = tuple(placements(rd) if is_dtensor(a) else None
                for a, rd in zip(args, dims))
    # an argument replicated where a role is sharded meets only that
    # rank's share of the data: its gradient there is a partial sum
    grads = tuple(None if rd is None or not is_dtensor(a) else tuple(
        Replicate() if r is None else Shard(rd[r]) if r in rd else Partial()
        for r in roles) for a, rd in zip(args, dims))
    # local_map reads a tuple as one placement list per output
    outs = (tuple(list(placements(rd)) for rd in out_dims)
            if isinstance(out_dims, tuple) else list(placements(out_dims)))
    return local_map(fn, out_placements=outs, in_placements=ins,
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)(*args)
