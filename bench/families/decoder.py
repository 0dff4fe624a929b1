"""The ``decoder`` family, a decoder-only transformer with a dense SwiGLU
MLP or a mixture of experts: its weights' layout and the program's
``ModelConfig`` and parameter tree on them.

Leaf names are the reference's (``bench/reference/decoder.py``):
``embed``, ``head``, ``final_norm`` and ``layers.<i>.<leaf>`` with the
leaves ``norm1``, ``norm2``, ``wq``, ``wk``, ``wv``, ``wo`` and either
``w_up``, ``w_gate``, ``w_down`` (a dense MLP) or those three stacked
over the experts beside ``router`` (a MoE FFN).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def is_moe(conf: dict) -> bool:
    return conf.get("num_local_experts", 0) > 0


def head_dim(conf: dict) -> int:
    return conf.get("head_dim") or conf["hidden_size"] // conf[
        "num_attention_heads"]


def leaves(conf: dict) -> List[Tuple[str, tuple, torch.dtype, float]]:
    """(name, shape, dtype, scale) of every weight: matrices N(0, 1/fan_in)
    in the configuration's dtype, the router in fp32, a scale of 0 for an
    RMSNorm weight."""
    dt = getattr(torch, conf["torch_dtype"])
    d, V = conf["hidden_size"], conf["vocab_size"]
    H, Hkv, D = (conf["num_attention_heads"], conf["num_key_value_heads"],
                 head_dim(conf))
    f = conf["intermediate_size"]
    s_d, s_f, s_o = 1 / math.sqrt(d), 1 / math.sqrt(f), 1 / math.sqrt(H * D)
    out = [("embed", (V, d), dt, s_d)]
    for i in range(conf["num_hidden_layers"]):
        p = f"layers.{i}."
        out += [(p + "norm1", (d,), dt, 0.0), (p + "norm2", (d,), dt, 0.0),
                (p + "wq", (d, H * D), dt, s_d),
                (p + "wk", (d, Hkv * D), dt, s_d),
                (p + "wv", (d, Hkv * D), dt, s_d),
                (p + "wo", (H * D, d), dt, s_o)]
        if is_moe(conf):
            E = conf["num_local_experts"]
            out += [(p + "router", (d, E), torch.float32, s_d),
                    (p + "w_up", (E, d, f), dt, s_d),
                    (p + "w_gate", (E, d, f), dt, s_d),
                    (p + "w_down", (E, f, d), dt, s_f)]
        else:
            out += [(p + "w_up", (d, f), dt, s_d),
                    (p + "w_gate", (d, f), dt, s_d),
                    (p + "w_down", (f, d), dt, s_f)]
    out += [("final_norm", (d,), dt, 0.0)]
    if not conf.get("tie_word_embeddings", False):
        out += [("head", (d, V), dt, s_d)]
    return out


def port_config(conf: dict):
    """The program's ``ModelConfig`` for the configuration."""
    from repro_torch.models.config import LayerSpec, ModelConfig
    moe = is_moe(conf)
    return ModelConfig(
        name=conf["name"], d_model=conf["hidden_size"],
        vocab_size=conf["vocab_size"],
        block_pattern=(LayerSpec("attn", window=conf.get("sliding_window")),),
        block_repeat=conf["num_hidden_layers"],
        n_heads=conf["num_attention_heads"],
        n_kv_heads=conf["num_key_value_heads"], head_dim=head_dim(conf),
        rope_theta=float(conf["rope_theta"]), d_ff=conf["intermediate_size"],
        ffn_kind="moe" if moe else "dense",
        n_routed=conf.get("num_local_experts", 0),
        top_k=conf.get("num_experts_per_tok", 0),
        d_ff_expert=conf["intermediate_size"] if moe else 0,
        tie_embeddings=conf.get("tie_word_embeddings", False),
        dtype=conf["torch_dtype"])


def _leaf_name(port_name: str) -> str:
    """The harness's name of the program's parameter ``port_name``."""
    parts = port_name.split(".")
    if parts[0] != "blocks":
        return port_name
    # blocks.<i>.l0.<norm1|norm2> or blocks.<i>.l0.<attn|ffn>.<leaf>
    return f"layers.{parts[1]}.{parts[-1]}"


def port_model(conf: dict, weights: Dict[str, torch.Tensor]):
    """(ModelConfig, parameter tree) of the program for ``conf``, each
    parameter the very tensor of ``weights``."""
    from torch import nn
    from repro_torch.models import transformer as T
    cfg = port_config(conf)
    params = T.init_params(None, cfg, device="meta")
    names = [n for n, _ in params.named_parameters()]
    for name in names:
        t = weights[_leaf_name(name)]
        *path, leaf = name.split(".")
        owner = params
        for p in path:
            owner = getattr(owner, p)
        old = owner._parameters[leaf]
        if old.shape != t.shape or old.dtype != t.dtype:
            raise ValueError(f"{name}: the program wants {tuple(old.shape)} "
                             f"{old.dtype}, the weights are "
                             f"{tuple(t.shape)} {t.dtype}")
        owner.register_parameter(leaf, nn.Parameter(t, requires_grad=False))
    if len(names) != len(weights):
        raise ValueError(f"{len(weights)} weights for {len(names)} "
                         f"parameters")
    return cfg, params
