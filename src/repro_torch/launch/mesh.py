"""Mesh construction (``repro/launch/mesh.py``): ``DeviceMesh``es over
the current ``torch.distributed`` world.

The caller initialises the process group (NCCL on the card, gloo on the
CPU).  A mesh spans ranks ``0 .. prod(shape) - 1`` in row-major order; a
world smaller than the shape raises ``ValueError``
(``parallel.sharding.make_mesh``).  Entry points build CUDA meshes unless
the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
from typing import Mapping

from repro_torch.layers.hints import ACTIVE_MESH, data_axes
from repro_torch.parallel.sharding import make_mesh

__all__ = ["data_axes", "make_mesh", "make_production_mesh", "mesh_context",
           "production_mesh_shape"]


def production_mesh_shape(multi_pod: bool = False) -> tuple:
    """16 x 16 ("data", "model") for one pod, 2 x 16 x 16 ("pod", "data",
    "model") for two."""
    return (2, 16, 16) if multi_pod else (16, 16)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The production mesh: the pod axis carries model-level data
    parallelism; it needs 256 (512) ranks."""
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(production_mesh_shape(multi_pod), axes, device)


@contextlib.contextmanager
def mesh_context(mesh):
    """Activate ``mesh`` for ``layers.hints`` inside the ``with`` block.

    For a ``DeviceMesh`` the block also runs under DTensor's
    ``implicit_replication``: a plain tensor the model builds beside its
    DTensors (positions, RoPE tables, masks) is the same on every rank
    and is taken as replicated."""
    token = ACTIVE_MESH.set(mesh)
    try:
        if isinstance(mesh, Mapping):
            yield mesh
        else:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                yield mesh
    finally:
        ACTIVE_MESH.reset(token)
