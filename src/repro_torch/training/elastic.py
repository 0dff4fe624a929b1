"""Elastic re-meshing (``repro/training/elastic.py``): resume a state on
a DIFFERENT mesh shape.

Device failure at scale means the replacement slice rarely matches the
old topology.  Checkpoints store full (unsharded) tensors per leaf
(``training/checkpoint.py``); ``reshard_state`` places each under its
spec on the new mesh.  Shrinking the "data" axis, dropping the "pod"
axis or resizing "model" needs no arithmetic, only re-slicing: a leaf
that is already a ``DTensor`` (sharded on the old mesh) is gathered to
its full value first, then distributed anew.
"""

from __future__ import annotations

from repro_torch.convert import map_tree
from repro_torch.parallel.sharding import spec_to_placements


def reshard_state(state, spec_tree, mesh):
    """Every leaf of ``state`` (nested dicts and lists of tensors) as a
    ``DTensor`` on ``mesh`` under the matching spec of ``spec_tree``."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def put(x, spec):
        if isinstance(x, DTensor):
            x = x.full_tensor()
        return distribute_tensor(x.detach(), mesh,
                                 spec_to_placements(spec, mesh))

    return map_tree(put, state, spec_tree)
