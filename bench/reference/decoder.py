"""Plain PyTorch reference of a decoder-only transformer, in float32.

Each layer is ``x + attn(rms(x))`` then ``x + ffn(rms(x))``:

  * RMSNorm: ``x / sqrt(mean(x^2) + eps) * w``;
  * attention: causal grouped-query attention, RoPE on q and k (the two
    halves of the head dimension rotated as a pair, frequencies
    ``theta^(-2i/D)``), scores scaled by ``1/sqrt(D)``, a softmax over
    the scores written out whole;
  * FFN: SwiGLU, ``(silu(x W_gate) * x W_up) W_down``; or a mixture of
    experts: router logits ``x W_router``, the top-k experts of each
    token, weights the softmax over their k logits (the published
    Mixtral routing), the sum of those experts' SwiGLU outputs;
  * the final RMSNorm and the LM head ``x W_head``.

Weights come from a ``fetch(name)`` callable that returns each leaf in
float32 (the names of ``bench/families/decoder.py``), so a caller can
hand over one layer at a time.  Nothing here reads a tensor of the program.

``low`` selects a control, the reference in the nearest precision below
the configuration's: ``"fp8"`` (for bf16) rounds every input of a
projection (the activations and the weight, not the router) to float8
e4m3 with one scale per tensor before the product.  The product itself
stays in float32.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
Fetch = Callable[[str], torch.Tensor]


def exact_float32() -> None:
    """float32 products in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.abs().amax().clamp_min(1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


ROUND = {"fp8": _fp8}


def mm(x: torch.Tensor, w: torch.Tensor, low) -> torch.Tensor:
    """``x @ w``; with ``low`` both inputs rounded as that control does."""
    if low:
        x, w = ROUND[low](x), ROUND[low](w)
    return x @ w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, heads, D) at positions 0 .. S-1."""
    S, _, D = x.shape
    half = D // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float64,
                                    device=x.device) * 2 / D)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * freqs
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(conf: dict, w: Dict[str, torch.Tensor], x: torch.Tensor,
              low) -> torch.Tensor:
    """Causal GQA over one sequence x (S, d)."""
    S = x.shape[0]
    H, Hkv = conf["num_attention_heads"], conf["num_key_value_heads"]
    D = conf.get("head_dim") or conf["hidden_size"] // H
    theta = float(conf["rope_theta"])
    q = rope(mm(x, w["wq"], low).view(S, H, D), theta)
    k = rope(mm(x, w["wk"], low).view(S, Hkv, D), theta)
    v = mm(x, w["wv"], low).view(S, Hkv, D)
    k = k.repeat_interleave(H // Hkv, dim=1)
    v = v.repeat_interleave(H // Hkv, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(D)
    window = conf.get("sliding_window")
    i = torch.arange(S, device=x.device)
    mask = i[None, :] <= i[:, None]
    if window:
        mask &= i[None, :] > i[:, None] - window
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    o = torch.einsum("hqk,khd->qhd", p, v).reshape(S, H * D)
    return mm(o, w["wo"], low)


def swiglu(x: torch.Tensor, up: torch.Tensor, gate: torch.Tensor,
           down: torch.Tensor, low) -> torch.Tensor:
    return mm(F.silu(mm(x, gate, low)) * mm(x, up, low), down, low)


def ffn(conf: dict, w: Dict[str, torch.Tensor], x: torch.Tensor,
        low) -> torch.Tensor:
    """x (N, d) -> (N, d)."""
    if "router" not in w:
        return swiglu(x, w["w_up"], w["w_gate"], w["w_down"], low)
    k = conf["num_experts_per_tok"]
    vals, experts = torch.topk(x @ w["router"], k, dim=-1)
    gates = torch.softmax(vals, dim=-1)
    out = torch.zeros_like(x)
    for e in range(w["router"].shape[1]):
        rows, slot = torch.nonzero(experts == e, as_tuple=True)
        if rows.numel():
            y = swiglu(x[rows], w["w_up"][e], w["w_gate"][e],
                       w["w_down"][e], low)
            out = out.index_add(0, rows, y * gates[rows, slot, None])
    return out


LAYER_LEAVES = ("norm1", "norm2", "wq", "wk", "wv", "wo", "router", "w_up",
                "w_gate", "w_down")


def layer_weights(fetch: Fetch, i: int, names) -> Dict[str, torch.Tensor]:
    return {n: fetch(f"layers.{i}.{n}") for n in LAYER_LEAVES
            if f"layers.{i}.{n}" in names}


def forward_hidden(conf: dict, fetch: Fetch, names, seqs: List[torch.Tensor],
                   low: Optional[str] = None) -> List[torch.Tensor]:
    """The final-norm hidden states (S_i, d) of each token sequence,
    computed one layer at a time over all sequences."""
    eps = conf["rms_norm_eps"]
    embed = fetch("embed")
    hs = [embed[s] for s in seqs]
    del embed
    for i in range(conf["num_hidden_layers"]):
        w = layer_weights(fetch, i, names)
        hs = [h + attention(conf, w, rms_norm(h, w["norm1"], eps), low)
              for h in hs]
        flat = torch.cat(hs)
        flat = flat + ffn(conf, w, rms_norm(flat, w["norm2"], eps), low)
        hs = list(torch.split(flat, [h.shape[0] for h in hs]))
        del w, flat
    norm = fetch("final_norm")
    return [rms_norm(h, norm, eps) for h in hs]


def head_weight(conf: dict, fetch: Fetch) -> torch.Tensor:
    return (fetch("embed").T if conf.get("tie_word_embeddings", False)
            else fetch("head"))


@torch.no_grad()
def logits(conf: dict, fetch: Fetch, names, seqs: List[torch.Tensor],
           low: Optional[str] = None,
           rows: Optional[List[slice]] = None) -> List[torch.Tensor]:
    """Logits (S_i, vocab) of each sequence, or of ``rows[i]`` of it."""
    hs = forward_hidden(conf, fetch, names, seqs, low)
    head = head_weight(conf, fetch)
    if rows is not None:
        hs = [h[r] for h, r in zip(hs, rows)]
    return [mm(h, head, low) for h in hs]
