"""The benchmark's operation and byte counts, held to hand counts and to
the program's own per-op counter (``launch.op_counts``, the dry-run's)
at a tiny size."""

import pytest
import torch

from bench.harness import flops, model, spec
from conftest import CONFIG, TINY_DENSE, TINY_MOE


def conf_of(**over):
    c = {**spec.config(spec.benchmark(), CONFIG), **over}
    if over and "num_local_experts" not in over:
        c.pop("num_local_experts")
    return c


def test_hand_counts_at_the_published_widths():
    mix = conf_of()
    attn = 4096 * 4096 * 2 + 4096 * 1024 * 2
    per_layer = attn + 4096 * 8 + 2 * 3 * 4096 * 14336
    assert flops.matmul_params(mix) == 16 * per_layer + 4096 * 32000
    assert model.param_count(mix) == pytest.approx(23.48e9, rel=1e-3)
    every = attn + 4096 * 8 + 8 * 3 * 4096 * 14336
    assert flops.matmul_params(mix, active=False) == \
        16 * every + 4096 * 32000
    assert flops.attention_pair_flops(mix) == 4 * 32 * 128 * 16
    assert flops.decode_attention_bytes(8, 32, 8, 128, [129] * 8, 2) == \
        2 * 8 * 129 * 8 * 128 * 2 + 2 * 8 * 32 * 128 * 2


def test_serving_counts_each_token_once_with_its_context():
    c = conf_of()
    one = flops.token_flops(c, 1)
    assert flops.serve_flops(c, [(1, 1)]) == one
    assert flops.serve_flops(c, [(3, 2)]) == sum(
        flops.token_flops(c, k) for k in (1, 2, 3, 4))
    assert flops.token_flops(c, 10) - flops.token_flops(c, 9) == \
        flops.attention_pair_flops(c)


def test_peaks_by_the_cards_name():
    p = flops.peaks("NVIDIA H100 80GB HBM3")
    assert flops.flops_peak(p, "bfloat16") == 989e12
    assert flops.flops_peak(p, "float32") == 67e12
    assert p["hbm_bytes_per_s"] == 3.35e12
    assert flops.peaks("cpu") is None


def _counted(fn, *args):
    from repro_torch.launch import op_counts
    return op_counts.count(fn, *args)[1]["dot_flops"]


@pytest.mark.parametrize("tiny", [TINY_MOE, TINY_DENSE], ids=["moe", "dense"])
def test_decode_step_products_match_the_counter(tiny):
    from repro_torch.models import transformer as T
    conf = conf_of(**tiny)
    weights = model.draw(conf, 5, "cpu")
    cfg, params = model.port_model(conf, weights)
    B, S = 3, 24
    cache = T.init_cache(cfg, B, S, device="cpu")
    cache["len"] = torch.full((B,), S - 1, dtype=torch.int32)
    toks = torch.randint(1, conf["vocab_size"], (B, 1))
    counted = _counted(T.decode_step, params, cfg, toks, cache)
    # the program's dense dispatch runs every expert, and the plain
    # decode attention reads all S slots (the last one is the new token)
    every = 2 * flops.matmul_params(conf, active=False) \
        + flops.attention_pair_flops(conf) * S
    assert counted == B * every
    assert flops.token_flops(conf, S) <= every


@pytest.mark.parametrize("tiny", [TINY_MOE, TINY_DENSE], ids=["moe", "dense"])
def test_forward_products_match_the_counter(tiny):
    from repro_torch.models import transformer as T
    conf = conf_of(**tiny)
    weights = model.draw(conf, 6, "cpu")
    cfg, params = model.port_model(conf, weights)
    B, S = 2, 20
    toks = torch.randint(0, conf["vocab_size"], (B, S))
    with torch.no_grad():
        counted = _counted(T.forward, params, cfg, toks)
    # the plain flash forward computes the whole S x S score matrix and
    # the dense dispatch every expert; the benchmark counts the causal
    # pairs and the top-k experts only
    pairs = flops.attention_pair_flops(conf)
    assert counted == 2 * flops.matmul_params(conf, active=False) * B * S \
        + pairs * B * S * S
    assert flops.sequence_flops(conf, S) == \
        2 * flops.matmul_params(conf) * S + pairs * S * (S + 1) // 2
