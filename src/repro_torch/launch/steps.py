"""Train and serve steps of the port (``repro/launch/steps.py``).

train_step: microbatched gradient accumulation in fp32 and the chunked
cross-entropy, whose LM-head product and loss run over sequence chunks so
the (B, S, vocab) logits are never all held at once.

serve_step: one greedy decode iteration against the KV cache.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.layers.hints import (data_axis_names, is_dtensor,
                                     on_shards, shard_hint, shard_offset,
                                     table_rows, whole_last)
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.training.optimizer import (AdamWState, adamw_update,
                                            cosine_lr)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

class _SumAcross(torch.autograd.Function):
    """The sum of a tensor over the ranks of ``group``, for a result that
    every rank holds alike: the backward passes each rank's gradient
    through as it is (it is already the whole result's)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _chunk_lse(h: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """The sum of the logsumexp of ``h @ head`` over its rows.

    On a mesh, a vocab-parallel logsumexp on each rank's shards
    (``on_shards``): the batch rows and the vocab columns stay sharded
    (an FSDP-sharded head is gathered), each rank takes its shard's
    max-shifted sum of exponentials, and the ranks of a row add theirs
    up (an all-reduce of (B, c) sums).  DTensor's own choices gathered
    the (B, c, V) logits, ~0.4 TB a step for internlm2 ``train_4k`` on
    the 16 x 16 mesh."""
    if not is_dtensor(head):
        return torch.logsumexp((h @ head).float(), dim=-1).sum()
    import torch.distributed as dist
    groups = [head.device_mesh.get_group(i)
              for i in shard_offset(head, 1)[0]]

    def lse(h_l, head_l):
        logits = (h_l @ head_l).float()
        m = logits.amax(dim=-1, keepdim=True).detach()
        for g in groups:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=g)
        total = torch.exp(logits - m).sum(dim=-1)
        for g in groups:
            total = _SumAcross.apply(total, g)
        return (torch.log(total) + m[..., 0]).sum()

    return on_shards(lse, (h, head), ({"batch": 0}, {"vocab": 1}),
                     {"batch": "sum"})


def chunked_ce_loss(hidden: torch.Tensor, head: torch.Tensor,
                    labels: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """Mean cross-entropy over sequence chunks.  hidden: (B, S, d)
    post-norm; head: (d, V); labels: (B, S).  fp32 log-softmax.

      * the gold logit of every position comes from ONE gather of the
        label rows of ``head.T`` and a dot product, never a (B, c, V)
        one-hot;
      * only the logsumexp touches (B, c, V), one chunk at a time, and
        each chunk's logits are recomputed in the backward pass
        (``torch.utils.checkpoint``), so they are never all held;
      * the sequence is zero-padded to a multiple of the chunk, and each
        padded position's logsumexp, exactly log V, is subtracted again.
    """
    B, S, d = hidden.shape
    lab_vec = table_rows(head.T, labels)                  # (B, S, d)
    gold = torch.einsum("bsd,bsd->bs", hidden.float(), lab_vec.float())
    c = min(chunk, S)
    n_pad = -(-S // c) * c - S
    if n_pad:
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, n_pad))
    lse_total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, S + n_pad, c):
        lse_total = lse_total + checkpoint(_chunk_lse, hidden[:, i:i + c],
                                           head, use_reentrant=False)
    if n_pad:
        pad_lse = torch.logsumexp(
            torch.zeros(head.shape[1], dtype=torch.float32,
                        device=hidden.device), dim=0)
        lse_total = lse_total - B * n_pad * pad_lse
    return (lse_total - gold.sum()) / (B * S)


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------

def make_train_step(cfg: ModelConfig, *, microbatches: int = 1,
                    remat: bool = True, peak_lr: float = 3e-4,
                    loss_chunk: int = 512):
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``; batch on the parameters' device: ``{"tokens",
    "labels"}`` (B, S) int32 for LM archs; ``{"frames" (B, Ssrc, d),
    "tokens", "labels"}`` for an encoder-decoder; ``{"embeds" (B, S, d),
    "labels"}`` for a stub-frontend arch.  The parameters and the
    optimizer state are updated in place and returned.

    With one microbatch the gradients stay in the parameters' dtype and
    the clip norm is taken after their cast to fp32; with more, each
    microbatch's gradients are added into fp32 accumulators and the
    loss and gradients averaged, as in the reference.  An arch fed
    embeddings never reads its untied embedding table: ``embed`` gets a
    zero gradient, as ``jax.grad`` gives it, and AdamW still decays it.
    Any other parameter the loss does not reach raises, as autograd
    does."""
    unread = ("embed",) if cfg.embeds_input and not cfg.tie_embeddings \
        else ()

    def loss_fn(params: T.Transformer, batch: dict) -> torch.Tensor:
        head = params.embed.T if cfg.tie_embeddings else params.head
        if cfg.encoder is not None:
            memory = ED.encode(params, cfg, batch["frames"], remat=remat)
            hidden = T.forward(params, cfg, batch["tokens"],
                               enc_memory=memory, remat=remat,
                               return_hidden=True)
        elif cfg.embeds_input:
            hidden = T.forward(params, cfg, embeds=batch["embeds"],
                               remat=remat, return_hidden=True)
        else:
            hidden = T.forward(params, cfg, batch["tokens"], remat=remat,
                               return_hidden=True)
        return chunked_ce_loss(hidden, head, batch["labels"],
                               chunk=loss_chunk)

    def grads_of(loss: torch.Tensor, named: dict) -> list:
        read = [n for n in named if n not in unread]
        grads = dict(zip(read, torch.autograd.grad(
            loss, [named[n] for n in read])))
        return [grads[n] if n in grads else torch.zeros_like(p)
                for n, p in named.items()]

    def train_step(params: T.Transformer, opt_state: AdamWState,
                   batch: dict):
        named = dict(params.named_parameters())
        leaves = list(named.values())
        if microbatches > 1:
            rows = {x.shape[0] for x in batch.values()}
            if len(rows) != 1 or next(iter(rows)) % microbatches:
                raise ValueError(f"batch rows {sorted(rows)} do not split "
                                 f"into {microbatches} microbatches")
            grads = [torch.zeros_like(p, dtype=torch.float32)
                     for p in leaves]
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            for mb in range(microbatches):
                # a microbatch is a run of rows, as in the reference (a
                # slice: a batch sharded over more ranks than it has
                # microbatches cannot be viewed as (microbatches, rows));
                # on a mesh it is sharded over the data axes again
                part = {k: shard_hint(
                    x[mb * (x.shape[0] // microbatches):
                      (mb + 1) * (x.shape[0] // microbatches)],
                    data_axis_names() or None, *([None] * (x.dim() - 1)))
                    for k, x in batch.items()}
                mb_loss = loss_fn(params, part)
                mb_grads = grads_of(mb_loss, named)
                # fp32 += bf16 promotes each element exactly, with no fp32
                # copy of the whole gradient
                torch._foreach_add_(grads, list(mb_grads))
                del mb_grads
                loss = loss + mb_loss.detach()
            loss = loss / microbatches
            torch._foreach_div_(grads, microbatches)
        else:
            loss = loss_fn(params, batch)
            grads = grads_of(loss, named)
            loss = loss.detach()
        lr = cosine_lr(int(opt_state.step) + 1, peak_lr=peak_lr)
        params, opt_state, metrics = adamw_update(
            params, dict(zip(named, grads)), opt_state, lr)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# serve step
# ---------------------------------------------------------------------------

def make_serve_step(cfg: ModelConfig):
    """Returns ``serve_step(params, tokens (B, 1), cache) -> (next_tokens
    (B,) int32, cache)``: greedy decode of one iteration."""

    def serve_step(params: T.Transformer, tokens: torch.Tensor,
                   cache: dict):
        logits, cache = T.decode_step(params, cfg, tokens, cache)
        # the argmax reads whole rows: a vocab-sharded row is gathered
        # first (DTensor's argmax over a sharded dim fails at batch 1)
        return (torch.argmax(whole_last(logits), dim=-1).to(torch.int32),
                cache)

    return serve_step
