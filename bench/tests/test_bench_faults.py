"""A run with its timed path broken underneath comes out not correct,
once for each fault the cell can have: a step that returns its state
unchanged, half of the batch left out, and a token altered where it is
produced.  (The cell runs on one chip: there is no exchange between
chips to leave out.)  The runs skip the look for a chip and drive the
rest of a run on the CPU at a tiny size, against the cell's own
limits."""

from unittest import mock

import pytest

from conftest import CELL, tiny_run


def serve_fault(kind):
    from repro_torch.models import transformer as T
    step = T.decode_step
    calls = [0]

    def broken(params, cfg, tokens, cache, *args, **kwargs):
        calls[0] += 1
        if kind == "state_unchanged":
            kept = {k: v.clone() for k, v in cache["blocks"]["l0"].items()}
            logits, new = step(params, cfg, tokens, cache, *args, **kwargs)
            for k, v in kept.items():
                cache["blocks"]["l0"][k].copy_(v)
            return logits, new
        logits, new = step(params, cfg, tokens, cache, *args, **kwargs)
        if kind == "half_batch":
            logits = logits.clone()
            logits[logits.shape[0] // 2:] = 0
        elif kind == "token_altered" and calls[0] % 3 == 0:
            logits = logits.clone()
            best = logits[0].argmax()
            logits[0, (best + 1) % logits.shape[1]] = logits[0, best] + 1
        return logits, new

    return mock.patch.object(T, "decode_step", broken)


@pytest.mark.parametrize("kind", ["state_unchanged", "half_batch",
                                  "token_altered"])
def test_serving_faults_come_out_not_correct(kind):
    assert tiny_run(CELL, seed=31)["correct"]
    with serve_fault(kind):
        res = tiny_run(CELL, seed=31)
    assert res["correct"] is False

