"""Sharding rules (``repro/parallel/sharding.py``): parameter, batch and
cache specs, and their DTensor placements.

The default production layout, as in the reference:

  * batch        -> ("pod", "data")   (model-level DP; the pod axis is DP)
  * TP           -> "model": attention heads / MLP d_ff columns / expert
                    axis (EP-style) or expert-ff (TP-style) for MoE / SSD
                    heads; vocab for embedding + LM head.
  * FSDP (train) -> "data" additionally shards every parameter's largest
                    replicated dim; optimizer state follows parameters.
  * KV caches    -> batch over the data axes, SEQUENCE over "model"
                    (several archs have fewer KV heads than a 16-wide
                    model axis); ``parallel.sp_decode`` combines the
                    sequence shards.

Rules are by parameter name; anything unmatched is replicated, and a dim
that does not divide falls back to replication.  The port keeps one
module per block where the reference stacks the blocks on a leading axis
(``convert.jax_path`` gives the correspondence), so the rules run on the
reference's EFFECTIVE (unstacked) shape and a spec here is the
reference's with its leading stacked entry dropped.  Caches keep the
reference's layout, leading repeat axis included, and their specs are the
reference's.

A spec is a tuple, one entry per tensor dim: an axis name, a tuple of
names (major to minor) or None.  ``mesh`` is a ``DeviceMesh`` or a plain
mapping of axis names to sizes, in mesh order.  ``make_mesh`` builds the
``DeviceMesh`` over the caller's process group; ``axis_sizes``,
``data_axes`` and ``spec_to_placements`` live in ``layers.hints``, the
lowest layer that reads a mesh.
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING, Dict, Mapping, Tuple, Union

import torch
from torch import nn

from repro_torch.convert import jax_path, map_tree
from repro_torch.device import resolve_device
from repro_torch.layers.hints import (axis_sizes, data_axes,
                                     spec_to_placements)
from repro_torch.models.config import ModelConfig

if TYPE_CHECKING:
    from torch.distributed.device_mesh import DeviceMesh

Spec = Tuple
MeshLike = Union["DeviceMesh", Mapping[str, int]]


def world_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(shape, axes, device=None):
    """A ``DeviceMesh`` of ``shape`` with axis names ``axes`` over the
    first ``prod(shape)`` ranks in row-major order; ranks past them get
    no coordinate.  A world smaller than the shape raises ``ValueError``.
    CUDA unless the caller passes ``device="cpu"``."""
    from torch.distributed.device_mesh import DeviceMesh
    shape, axes = tuple(shape), tuple(axes)
    n, world = math.prod(shape), world_size()
    if world < n:
        raise ValueError(f"a mesh of shape {shape} needs {n} ranks; the "
                         f"world has {world}")
    return DeviceMesh(resolve_device(device).type,
                      torch.arange(n).reshape(shape), mesh_dim_names=axes)


def _div(dim: int, n: int) -> bool:
    return n > 0 and dim % n == 0


def _data_entry(sizes: Mapping[str, int]):
    axes = data_axes(sizes)
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def batch_pspec(mesh: MeshLike) -> Spec:
    return (_data_entry(axis_sizes(mesh)),)


def _named_shapes(params) -> Dict[str, tuple]:
    items = (params.named_parameters() if isinstance(params, nn.Module)
             else params.items())
    return {name: tuple(t.shape) for name, t in items}


def param_pspecs(params, cfg: ModelConfig, mesh: MeshLike,
                 fsdp: bool = False,
                 log_fallbacks: bool = False) -> Dict[str, Spec]:
    """``{parameter name: spec}`` for the port's ``Transformer`` (or a
    mapping of names to tensors, meta tensors included)."""
    sizes = axis_sizes(mesh)
    m = sizes.get("model", 1)
    d = sizes.get("data", 1)
    ep_moe = cfg.ffn_kind == "moe" and _div(cfg.n_routed, m)
    # Head-aligned TP only: a flat (H*hd) projection split across more
    # shards than heads would cut heads apart; non-dividing head counts
    # replicate the projection (the reference's layer reshards the batch
    # around attention instead, through layers/hints.py).
    q_ok = _div(cfg.n_heads, m)
    kv_ok = _div(cfg.n_kv_heads, m)
    if cfg.attn_kind == "mla":
        kv_ok = q_ok
    ssm_ok = cfg.n_ssd_heads == 0 or _div(cfg.n_ssd_heads, m)

    def spec_for(name: str, shape: tuple) -> Spec:
        path, _ = jax_path(name)
        leaf = path[-1]
        nd = len(shape)
        col = None   # dim to shard over "model"
        # encoder layers always have head-aligned dims (n_heads == n_kv)
        enc = path[0] == "encoder"
        q_al = True if enc else q_ok
        kv_al = True if enc else kv_ok

        if leaf == "embed":
            col = 0 if _div(shape[0], m) else None
        elif leaf == "head":
            col = 1 if _div(shape[1], m) else None
        elif leaf in ("wq", "wukv", "bq"):
            dim = 1 if nd >= 2 else 0
            col = dim if (q_al and _div(shape[dim], m)) else None
        elif leaf in ("wk", "wv", "bk", "bv"):
            dim = 1 if nd >= 2 else 0
            col = dim if (kv_al and _div(shape[dim], m)) else None
        elif leaf == "wdkv":
            col = None                           # MLA latent proj: replicated
        elif leaf == "wo":
            col = 0 if (q_al and _div(shape[0], m)) else None
        elif leaf in ("w_up", "w_gate"):
            if nd == 3:                          # MoE expert stacks (E,d,f)
                col = 0 if ep_moe else (2 if _div(shape[2], m) else None)
            else:
                col = 1 if _div(shape[1], m) else None
        elif leaf == "w_down":
            if nd == 3:                          # MoE (E,f,d)
                col = 0 if ep_moe else (1 if _div(shape[1], m) else None)
            else:
                col = 0 if _div(shape[0], m) else None
        elif leaf in ("w_x", "w_z"):
            col = 1 if (ssm_ok and _div(shape[1], m)) else None
        elif leaf == "w_out":
            col = 0 if (ssm_ok and _div(shape[0], m)) else None
        elif leaf == "conv_x":
            col = 1 if (ssm_ok and _div(shape[1], m)) else None
        elif leaf in ("conv_x_b", "norm_w", "a_log", "dt_bias", "d_skip"):
            col = 0 if (ssm_ok and _div(shape[0], m)) else None

        spec = [None] * nd
        if col is not None and m > 1:
            spec[col] = "model"
        # the embedding table stays vocab-sharded only, as in the
        # reference (a 2D-sharded table replicates the gather)
        if fsdp and d > 1 and leaf != "embed":
            best, best_size = None, 0
            for i in range(nd):
                if spec[i] is None and _div(shape[i], d) \
                        and shape[i] > best_size:
                    best, best_size = i, shape[i]
            if best is not None and best_size >= d:
                spec[best] = "data"
        if log_fallbacks and col is None and nd >= 2 and max(shape) >= 1024:
            print(f"  [sharding] replicated (no divisible dim): {name} "
                  f"{shape}")
        return tuple(spec)

    return {name: spec_for(name, shape)
            for name, shape in _named_shapes(params).items()}


def _map_with_path(fn, tree, path: str = ""):
    if isinstance(tree, Mapping):
        return {k: _map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, f"{path}/{i}")
                for i, v in enumerate(tree)]
    return fn(path, tree)


def cache_pspecs(cache, cfg: ModelConfig, mesh: MeshLike):
    """Cache layout: batch over the data axes, sequence over "model"; a
    tree of specs shaped like ``cache`` (``models.transformer.init_cache``).
    """
    sizes = axis_sizes(mesh)
    dax = _data_entry(sizes)
    d_total = 1
    for a in ("pod", "data"):
        d_total *= sizes.get(a, 1)
    m = sizes.get("model", 1)

    def spec_for(path: str, x) -> Spec:
        leaf = path.rsplit("/", 1)[-1]
        shape = tuple(x.shape)
        if leaf == "len":
            return (dax if shape[0] % max(d_total, 1) == 0 else None,)
        off = 0 if path.startswith("prefix") else 1   # leading repeat axis
        ndim = len(shape)
        spec = [None] * ndim
        if ndim > off and shape[off] % max(d_total, 1) == 0:
            spec[off] = dax                  # batch dim
        if leaf in ("k", "v", "xk", "xv", "c_kv", "k_pe"):
            seq_dim = off + 1
            if _div(shape[seq_dim], m) and m > 1:
                spec[seq_dim] = "model"
        elif leaf == "ssm":
            h_at = off + 1                   # (B, H, P, N): SSD heads
            if ndim > h_at and m > 1 and _div(shape[h_at], m):
                spec[h_at] = "model"
        elif leaf == "conv_x":
            ch = ndim - 1
            if m > 1 and _div(shape[ch], m):
                spec[ch] = "model"
        return tuple(spec)

    return _map_with_path(spec_for, cache)


def to_shardings(spec_tree, mesh):
    """Every spec of a tree (dicts, lists) as its placements on ``mesh``."""
    return map_tree(lambda s: spec_to_placements(s, mesh), spec_tree)


def distribute_params(params: nn.Module, pspecs: Mapping[str, Spec],
                      mesh) -> nn.Module:
    """Every parameter of ``params`` replaced, in place, by a parameter
    holding a ``DTensor`` on ``mesh`` under its spec in ``pspecs``
    (``param_pspecs``); meta parameters stay meta.  Returns ``params``."""
    from torch.distributed.tensor import distribute_tensor
    for name, p in list(params.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = params.get_submodule(owner) if owner else params
        new = nn.Parameter(distribute_tensor(
            p.detach(), mesh, spec_to_placements(pspecs[name], mesh)),
            requires_grad=p.requires_grad)
        if isinstance(mod, nn.ParameterDict):
            mod[leaf] = new
        else:
            setattr(mod, leaf, new)
    return params
