"""Deterministic sharded synthetic-token pipeline
(``repro/data/pipeline.py``).

Every (step, shard) batch is a pure function of ``(seed, step, shard)``:
it is drawn from ``numpy.random.default_rng((seed, step, shard))``, so any
host can recompute any shard and a resumed run needs only the step
counter.  Tokens follow a Zipf unigram distribution over the vocabulary,
so the loss curve is not degenerate.  The draws are not the reference's
(``jax.random`` cannot be reproduced here); the tests feed both sides
one numpy batch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class TokenPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    num_shards: int = 1
    seed: int = 0
    zipf_a: float = 1.2

    def __post_init__(self):
        if self.global_batch % self.num_shards:
            raise ValueError("global_batch must divide num_shards")
        ranks = np.arange(1, self.vocab_size + 1, dtype=np.float64)
        probs = ranks ** (-self.zipf_a)
        self._probs = probs / probs.sum()

    @property
    def shard_batch(self) -> int:
        return self.global_batch // self.num_shards

    def batch(self, step: int, shard: int = 0) -> dict:
        """{tokens, labels}, int32 CPU tensors (shard_batch, seq_len);
        labels are the next tokens."""
        rng = np.random.default_rng((self.seed, step, shard))
        toks = rng.choice(self.vocab_size,
                          size=(self.shard_batch, self.seq_len + 1),
                          p=self._probs).astype(np.int32)
        return {"tokens": torch.from_numpy(toks[:, :-1].copy()),
                "labels": torch.from_numpy(toks[:, 1:].copy())}

    def global_batch_at(self, step: int) -> dict:
        shards = [self.batch(step, s) for s in range(self.num_shards)]
        return {k: torch.cat([s[k] for s in shards]) for k in shards[0]}
