"""Carry parameters and caches between the JAX reference and the port.

The reference's pytrees are nested dicts with the repeating block's
parameters stacked on a leading R axis; the port's ``Transformer`` keeps
one module per block, so its parameter ``blocks.<r>.l0.attn.wq`` is
``tree["blocks"]["l0"]["attn"]["wq"][r]`` (a Mamba2 layer's
``blocks.<r>.l0.mixer.w_x`` likewise).  The reference keeps a model's
unscanned prefix blocks (deepseek's dense first layer) as the list
``tree["prefix"]``, without an R axis: the port's
``prefix.<i>.l0.attn.wukv`` is ``tree["prefix"][i]["l0"]["attn"]["wukv"]``,
and a cache's ``prefix`` list is carried alike.  Into the port,
``params_from_jax`` and ``cache_from_jax`` take host numpy arrays
(``jax.device_get(tree)``); the way back, ``params_to_numpy``, gives the
same layout as host numpy.  bf16 crosses as raw bits, with no rounding
through fp32: ``ml_dtypes.bfloat16`` arrays into the port, ``uint16``
arrays back (the port needs no ``ml_dtypes``).  Every leaf keeps its own
dtype: the fp32 leaves of a bf16 Mamba2 mixer (``a_log``, ``dt_bias``,
``d_skip``), the fp32 router of a bf16 MoE FFN and the fp32 SSM state
of a cache stay fp32.  Weights keep the JAX layout, so conversion is a
copy: a MoE FFN's experts stay stacked on their leading E axis, and its
shared experts' MLP is the submodule ``shared`` (parameter
``blocks.<r>.l0.ffn.shared.w_up`` is ``tree["blocks"]["l0"]["ffn"]
["shared"]["w_up"][r]``).  A decoder layer with cross-attention also
carries ``norm_x`` and ``xattn`` alike.  An encoder-decoder model's
encoder (``tree["encoder"]``: ``layers``, stacked over its ``n_layers``
on a leading axis, and ``final_norm``) is the port's ``encoder``:
``encoder.layers.<i>.attn.wq`` is ``tree["encoder"]["layers"]["attn"]
["wq"][i]``.  zamba2's shared attention block is the top-level
``shared`` (``norm1``, ``attn``, ``norm2``, ``mlp``), unstacked: the
port's ``shared.mlp.w_up`` is ``tree["shared"]["mlp"]["w_up"]``, and its
caches ``cache["shared"]["k"]``/``["v"]``.  The name ``shared`` also
names a MoE FFN's shared experts, ``blocks.<r>.l0.ffn.shared.w_up``;
the two never meet, as a path is read from its first part
(``jax_path``): ``blocks`` is a stacked block, anything else a path of
the tree as it stands.
"""

from __future__ import annotations

from typing import Callable, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.layers.moe import MoEParams
from repro_torch.models.config import ModelConfig
from repro_torch.models.encdec import Encoder, EncoderLayer
from repro_torch.models.transformer import (DecoderLayer, SharedBlock,
                                            SSMLayer, Transformer,
                                            check_supported)


def to_torch(a: np.ndarray, device=None) -> torch.Tensor:
    """A numpy array as a torch tensor; bf16 crosses bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _param(a, device) -> nn.Parameter:
    return nn.Parameter(to_torch(a, device))


def _param_dict(tree: Mapping, device, r=None) -> nn.ParameterDict:
    return nn.ParameterDict({
        name: _param(a if r is None else np.asarray(a)[r], device)
        for name, a in tree.items()})


def _ffn_dict(tree: Mapping, device, r: int) -> nn.ParameterDict:
    """An FFN's parameters of block ``r``: a dense MLP's, or a MoE FFN's
    with its shared experts, if any, as ``MoEParams.shared``."""
    if "router" not in tree:
        return _param_dict(tree, device, r)
    routed = {k: a for k, a in tree.items() if k != "shared"}
    shared = (_param_dict(tree["shared"], device, r) if "shared" in tree
              else None)
    return MoEParams(_param_dict(routed, device, r), shared)


def _block(block_tree: Mapping, cfg: ModelConfig, device,
           r: Optional[int]) -> nn.ModuleDict:
    """One block's layers from the reference's tree: slice ``r`` of the
    stacked leaves, or the leaves themselves (a prefix block) for None."""
    def leaf(a):
        return _param(a if r is None else np.asarray(a)[r], device)

    layers = {}
    for i, spec in enumerate(cfg.block_pattern):
        lt = block_tree[f"l{i}"]
        if spec.kind == "ssm":
            layers[f"l{i}"] = SSMLayer(leaf(lt["norm1"]),
                                       _param_dict(lt["mixer"], device, r))
            continue
        cross = {}
        if "xattn" in lt:
            cross = dict(norm_x=leaf(lt["norm_x"]),
                         xattn=_param_dict(lt["xattn"], device, r))
        layers[f"l{i}"] = DecoderLayer(
            leaf(lt["norm1"]), _param_dict(lt["attn"], device, r),
            leaf(lt["norm2"]), _ffn_dict(lt["ffn"], device, r), **cross)
    return nn.ModuleDict(layers)


def _encoder(tree: Mapping, device) -> Encoder:
    """The encoder from the reference's ``tree["encoder"]``: layer ``i``
    is slice ``i`` of the stacked ``layers`` leaves."""
    lt = tree["layers"]
    n = np.asarray(lt["norm1"]).shape[0]
    layers = nn.ModuleList(
        EncoderLayer(_param(np.asarray(lt["norm1"])[i], device),
                     _param_dict(lt["attn"], device, i),
                     _param(np.asarray(lt["norm2"])[i], device),
                     _param_dict(lt["mlp"], device, i))
        for i in range(n))
    return Encoder(layers, _param(tree["final_norm"], device))


def params_from_jax(tree: Mapping, cfg: ModelConfig,
                    device=None) -> Transformer:
    """The port's ``Transformer`` holding the reference's weights.

    ``tree`` is ``jax.device_get(repro.models.transformer.init_params(
    key, cfg))`` for a config the port carries (GQA or MLA with a dense
    or MoE FFN and prefix blocks, or Mamba2, with zamba2's shared block);
    or of
    ``repro.models.encdec.init_encdec_params`` for an encoder-decoder
    config."""
    check_supported(cfg)
    blocks = nn.ModuleList(
        _block(tree["blocks"], cfg, device, r)
        for r in range(cfg.block_repeat - cfg.first_k_dense))
    prefix = (nn.ModuleList(_block(b, cfg, device, None)
                            for b in tree["prefix"])
              if "prefix" in tree else None)
    head = _param(tree["head"], device) if "head" in tree else None
    encoder = (_encoder(tree["encoder"], device) if "encoder" in tree
               else None)
    shared = None
    if "shared" in tree:
        st = tree["shared"]
        shared = SharedBlock(_param(st["norm1"], device),
                             _param_dict(st["attn"], device),
                             _param(st["norm2"], device),
                             _param_dict(st["mlp"], device))
    return Transformer(_param(tree["embed"], device),
                       _param(tree["final_norm"], device), blocks, head,
                       prefix, encoder, shared)


def cache_from_jax(tree: Mapping, device=None) -> dict:
    """The port's cache from the reference's ``init_cache``/``prefill``
    cache pytree (attention, MLA and SSM layers, the prefix blocks' list
    and the shared block's ``shared``): same keys, shapes and dtypes."""
    def block(b: Mapping) -> dict:
        return {slot: {name: to_torch(a, device) for name, a in lc.items()}
                for slot, lc in b.items()}

    cache = {"blocks": block(tree["blocks"]),
             "len": to_torch(tree["len"], device).to(torch.int32)}
    if "prefix" in tree:
        cache["prefix"] = [block(b) for b in tree["prefix"]]
    if "shared" in tree:
        cache["shared"] = {name: to_torch(a, device)
                           for name, a in tree["shared"].items()}
    return cache


def jax_path(name: str) -> Tuple[Tuple, Optional[int]]:
    """A port parameter name -> (its path in the JAX pytree, its block
    index or None): ``blocks.3.l0.attn.wq`` -> ``(("blocks", "l0",
    "attn", "wq"), 3)``, ``prefix.0.l0.attn.wukv`` -> ``(("prefix", 0,
    "l0", "attn", "wukv"), None)`` (a list index),
    ``encoder.layers.2.attn.wq`` -> ``(("encoder", "layers", "attn",
    "wq"), 2)``, ``shared.mlp.w_up`` -> ``(("shared", "mlp", "w_up"),
    None)``, ``embed`` -> ``(("embed",), None)``."""
    parts = name.split(".")
    if parts[0] == "blocks":
        return ("blocks", *parts[2:]), int(parts[1])
    if parts[:2] == ["encoder", "layers"]:
        return ("encoder", "layers", *parts[3:]), int(parts[2])
    if parts[0] == "prefix":
        return ("prefix", int(parts[1]), *parts[2:]), None
    return tuple(parts), None


def _lookup(tree: Mapping, path: Tuple[str, ...]):
    for key in path:
        tree = tree[key]
    return tree


def _insert(tree: dict, path: Tuple, leaf) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = leaf


def to_jax_layout(named: Mapping[str, torch.Tensor]) -> dict:
    """Tensors keyed by port parameter name (``named_parameters()``) ->
    the JAX pytree layout: nested dicts, each block tensor stacked over
    the blocks (the encoder's layers) on a leading axis, and the prefix
    blocks a list.  Leaves
    are detached torch tensors."""
    tree: dict = {}
    stacks: dict = {}
    for name, t in named.items():
        path, r = jax_path(name)
        if r is None:
            _insert(tree, path, t.detach())
        else:
            stacks.setdefault(path, {})[r] = t.detach()
    for path, by_r in stacks.items():
        _insert(tree, path, torch.stack([by_r[r] for r in range(len(by_r))]))
    if "prefix" in tree:       # {0: block, 1: ...} -> [block, ...]
        tree["prefix"] = [tree["prefix"][i]
                          for i in range(len(tree["prefix"]))]
    return tree


def from_jax_layout(tree: Mapping, names: Iterable[str]) -> dict:
    """The inverse of ``to_jax_layout``: for each port parameter name,
    its tensor in ``tree`` (a block's slice of the stacked leaf)."""
    out = {}
    for name in names:
        path, r = jax_path(name)
        leaf = _lookup(tree, path)
        out[name] = leaf if r is None else leaf[r]
    return out


def map_tree(fn: Callable, tree, *rest):
    """``fn`` applied to every leaf of a tree of nested dicts and lists;
    with ``rest``, trees of the same structure, ``fn`` takes the leaf and
    the matching leaf of each."""
    if isinstance(tree, Mapping):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array; bf16 as its raw ``uint16`` bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def params_to_numpy(params: Transformer, cfg: ModelConfig) -> dict:
    """The port's parameters in the reference's pytree layout, as host
    numpy arrays (bf16 leaves as raw ``uint16`` bits): the tree that
    ``params_from_jax`` takes, so the two round-trip bit for bit."""
    check_supported(cfg)
    if len(params.blocks) != cfg.block_repeat - cfg.first_k_dense:
        raise ValueError(f"{len(params.blocks)} blocks, config has "
                         f"{cfg.block_repeat - cfg.first_k_dense} after "
                         f"{cfg.first_k_dense} prefix blocks")
    return map_tree(to_numpy, to_jax_layout(dict(params.named_parameters())))


@torch.no_grad()
def load_jax_layout(params: Transformer, tree: Mapping) -> None:
    """Copy a JAX-layout tree of tensors into ``params`` in place."""
    named = dict(params.named_parameters())
    for name, t in from_jax_layout(tree, named).items():
        named[name].copy_(t)
