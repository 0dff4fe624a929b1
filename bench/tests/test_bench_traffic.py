"""The ``serve_waves`` generator: stratified lengths, one fixed order for
every seed, and token ids that a seed repeats."""

import json
import math
from statistics import NormalDist

import numpy as np

from bench.harness import spec

traffic = spec.kind("serve_waves")


def chat():
    return spec.traffic("chat")


def test_stratified_lengths_are_the_trace_quantiles_clamped():
    mix = chat()
    n = mix["wave_requests"]
    mu, sigma = traffic.lognormal_params(mix["prompt_mean"],
                                         mix["prompt_std"])
    # the log-normal's own mean and std come back from (mu, sigma)
    assert math.isclose(math.exp(mu + sigma ** 2 / 2), mix["prompt_mean"])
    var = (math.exp(sigma ** 2) - 1) * math.exp(2 * mu + sigma ** 2)
    assert math.isclose(math.sqrt(var), mix["prompt_std"])
    got = traffic.stratified(n, mix["prompt_mean"], mix["prompt_std"], 10 ** 9)
    for i, g in enumerate(got):
        q = math.exp(mu + sigma * NormalDist().inv_cdf((i + 0.5) / n))
        assert g == max(1, int(round(q)))
    capped = traffic.stratified(n, mix["prompt_mean"], mix["prompt_std"],
                                mix["prompt_max"])
    assert capped == [min(g, mix["prompt_max"]) for g in got]
    assert max(capped) == mix["prompt_max"] and min(capped) >= 1


def test_every_seed_serves_the_same_lengths_in_the_same_order():
    mix = chat()
    a = [(len(r["prompt"]), r["gen_len"]) for r in traffic.wave(mix, 32000, 1, 0)]
    b = [(len(r["prompt"]), r["gen_len"]) for r in traffic.wave(mix, 32000, 2 ** 31 + 7, 5)]
    assert a == b == traffic.wave_lengths(mix)
    prompts = sorted(p for p, _ in a)
    outputs = sorted(g for _, g in a)
    n = mix["wave_requests"]
    assert prompts == traffic.stratified(n, mix["prompt_mean"], mix["prompt_std"], mix["prompt_max"])
    assert outputs == traffic.stratified(n, mix["output_mean"], mix["output_std"], mix["output_max"])


def test_a_seed_repeats_exactly_and_waves_differ():
    mix = chat()
    seed = 2 ** 33 + 11
    w1 = traffic.wave(mix, 32000, seed, 0)
    w2 = traffic.wave(mix, 32000, seed, 0)
    w3 = traffic.wave(mix, 32000, seed, 1)
    assert all(np.array_equal(a["prompt"], b["prompt"]) for a, b in zip(w1, w2))
    assert not all(np.array_equal(a["prompt"], c["prompt"]) for a, c in zip(w1, w3))
    for r in w1:
        assert r["prompt"].dtype == np.int32 and r["arrival"] == 0.0
        assert r["prompt"].min() >= 1 and r["prompt"].max() < 32000



def test_mix_files_are_plain_data_read_by_their_kind():
    folder = spec.BENCH_DIR / "traffic"
    mixes = sorted(folder.glob("*.json"))
    assert mixes
    for path in mixes:
        mix = json.loads(path.read_text())
        kind = spec.kind(mix["kind"])
        assert callable(kind.run) and callable(kind.readings), path
    for path in folder.iterdir():
        assert path.suffix in (".json", ".py") or path.name == "__pycache__"
