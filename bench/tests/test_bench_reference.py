"""The plain reference agrees with the program at a tiny size on the CPU
(only this test imports both): the whole forward in fp32, and the
served tokens of a wave."""

import pytest
import torch

from bench.harness import model, spec
from bench.reference import decoder
from conftest import CELL, CONFIG, TINY_DENSE, TINY_MOE, tiny_run

FP32 = {"torch_dtype": "float32"}


def conf_of(tiny):
    c = {**spec.config(spec.benchmark(), CONFIG), **tiny, **FP32}
    if "num_local_experts" not in tiny:
        c.pop("num_local_experts", None)
    return c


@pytest.mark.parametrize("tiny", [TINY_MOE, TINY_DENSE], ids=["moe", "dense"])
def test_forward_logits_agree_in_fp32(tiny):
    from repro_torch.models import transformer as T
    conf = conf_of(tiny)
    weights = model.draw(conf, 11, "cpu")
    cfg, params = model.port_model(conf, weights)
    toks = torch.randint(0, conf["vocab_size"], (3, 17),
                         generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = T.forward(params, cfg, toks)
    want = decoder.logits(conf, weights.__getitem__, weights, list(toks))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


def test_served_tokens_are_the_reference_best_in_fp32():
    res = tiny_run(CELL, seed=21, overrides={"conf": FP32})
    assert res["correct"] and res["failed"] == 0
    assert res["checks"]["mean_gap"]["value"] < 1e-5


def test_served_tokens_agree_in_bf16():
    res = tiny_run(CELL, seed=22)
    assert res["correct"]
    assert res["checks"]["mean_gap"]["value"] < 0.05

