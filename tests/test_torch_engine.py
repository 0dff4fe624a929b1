"""The port's serving engine, on the CPU: the reference engine's tests
(tests/test_serving_engine.py, router aside) on the port, and a
cross-check against the JAX engine on the same requests and weights.

The cross-check runs in fp32 (bf16 greedy argmax can flip on near-ties
between two frameworks) with ``time_scale=0.0``, so that admission does
not depend on wall time: tokens per request, iterations and preemptions
must then be equal.
"""

import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.data.requests import make_serving_requests as j_requests  # noqa
from repro.models import transformer as JT  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data.requests import make_serving_requests  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving import engine as engine_mod  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402


@pytest.fixture(scope="module")
def small():
    cfg = TC.get_reduced("qwen2_0_5b")
    params = TT.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    return cfg, params


def _reqs(cfg, n, gen=6, ctx=12, rate=100.0):
    rs = make_serving_requests("chat", rate, n, cfg.vocab_size, max_len=ctx)
    for r in rs:
        r["gen_len"] = gen
        r["prompt"] = r["prompt"][:ctx]
    return rs


def _engine(cfg, params, **kw):
    return ServingEngine(cfg, params, device="cpu", **kw)


def test_all_requests_served(small):
    cfg, params = small
    eng = _engine(cfg, params, max_batch=3, max_len=64)
    rep = eng.run(_reqs(cfg, 5), time_scale=0.0)
    assert len(rep.results) == 5
    for r in rep.results:
        assert len(r.tokens) == 6
        assert r.e2e >= r.ttft >= 0
        assert r.tpot > 0


def test_greedy_decode_deterministic(small):
    cfg, params = small
    r1 = _engine(cfg, params, max_batch=2, max_len=64).run(
        _reqs(cfg, 3), time_scale=0.0)
    r2 = _engine(cfg, params, max_batch=2, max_len=64).run(
        _reqs(cfg, 3), time_scale=0.0)
    assert {r.rid: r.tokens for r in r1.results} == \
        {r.rid: r.tokens for r in r2.results}


def test_kv_budget_preemption(small):
    cfg, params = small
    eng = _engine(cfg, params, max_batch=4, max_len=64, kv_token_budget=40)
    rep = eng.run(_reqs(cfg, 4, gen=8, ctx=16), time_scale=0.0)
    assert len(rep.results) == 4           # everyone completes eventually
    assert rep.preemptions > 0             # 4 x 16-token prompts > 40


def test_engine_matches_model_decode(small):
    """Engine-produced tokens == raw greedy decode_step tokens."""
    cfg, params = small
    prompt = torch.tensor([[5, 9, 3, 7]], dtype=torch.int32)
    cache = TT.init_cache(cfg, 1, 64, device="cpu")
    for t in range(4):
        logits, cache = TT.decode_step(params, cfg, prompt[:, t:t + 1],
                                       cache)
    toks = [int(torch.argmax(logits[0]))]
    for _ in range(3):
        logits, cache = TT.decode_step(
            params, cfg, torch.tensor([[toks[-1]]], dtype=torch.int32),
            cache)
        toks.append(int(torch.argmax(logits[0])))
    eng = _engine(cfg, params, max_batch=1, max_len=64)
    rep = eng.run([dict(rid=0, arrival=0.0, prompt=[5, 9, 3, 7],
                        gen_len=4)], time_scale=0.0)
    assert rep.results[0].tokens == toks


def test_snapshot_restore_replays_inflight(small):
    cfg, params = small
    eng = _engine(cfg, params, max_batch=2, max_len=64)
    reqs = _reqs(cfg, 3)
    eng.queue = sorted(reqs, key=lambda r: r["arrival"])
    eng._admit(now=1e9)                     # two slots in flight
    snap = eng.snapshot()
    assert len(snap["inflight"]) == 2 and len(snap["queue"]) == 1
    eng.restore(snap)
    assert not any(s.active for s in eng.slots) and not eng.lens.any()
    rep = eng.run(reqs, time_scale=0.0)
    assert sorted(r.rid for r in rep.results) == [0, 1, 2]


def _fake_clock(monkeypatch, eng, prefill_costs=True):
    """Replace the engine's wall clock by one that advances 1.0 per decode
    step (prefill replay steps included unless ``prefill_costs`` is
    False), so the virtual clock counts steps."""
    clock = [0.0]
    in_prefill = [False]
    decode, prefill = eng._decode, eng._prefill_slot

    def timed_decode(toks):
        if prefill_costs or not in_prefill[0]:
            clock[0] += 1.0
        return decode(toks)

    def flagged_prefill(i):
        in_prefill[0] = True
        try:
            prefill(i)
        finally:
            in_prefill[0] = False

    monkeypatch.setattr(eng, "_decode", timed_decode)
    monkeypatch.setattr(eng, "_prefill_slot", flagged_prefill)
    monkeypatch.setattr(engine_mod, "time",
                        types.SimpleNamespace(perf_counter=lambda: clock[0]))


@pytest.mark.parametrize("prompts,ttfts", [
    ([4], [4.0]),             # the request's own 4 replay steps
    ([4, 3], [7.0, 7.0]),     # both admitted in one iteration: 4 + 3 steps
])
def test_ttft_counts_the_prefill_replay_steps(small, monkeypatch, prompts,
                                              ttfts):
    """The first token is stamped after the admitting iteration's prefills,
    not at its start (the reference's rule), so TTFT includes them."""
    cfg, params = small
    eng = _engine(cfg, params, max_batch=2, max_len=64)
    _fake_clock(monkeypatch, eng)
    reqs = [dict(rid=i, arrival=0.0, prompt=list(range(1, n + 1)),
                 gen_len=3) for i, n in enumerate(prompts)]
    rep = eng.run(reqs, time_scale=0.0)
    total = sum(prompts) + 2             # replay steps + 2 iterations
    by_rid = {r.rid: r for r in rep.results}
    for rid, ttft in enumerate(ttfts):
        r = by_rid[rid]
        assert r.ttft == ttft
        assert r.e2e == total
        assert r.tpot == (total - ttft) / 2
    assert rep.total_time == total and rep.iterations == 2


def test_first_token_stamp_of_zero_counts_as_set(small, monkeypatch):
    """A request whose first token is stamped at virtual time 0.0 keeps
    that stamp (the reference's ``first_token_t or now`` would re-stamp
    it at the next iteration: TPOT 2/3 here instead of 1)."""
    cfg, params = small
    eng = _engine(cfg, params, max_batch=1, max_len=64)
    _fake_clock(monkeypatch, eng, prefill_costs=False)
    rep = eng.run([dict(rid=0, arrival=0.0, prompt=[5, 9, 3], gen_len=4)],
                  time_scale=0.0)
    (r,) = rep.results
    assert (r.ttft, r.tpot, r.e2e) == (0.0, 1.0, 3.0)


def test_serve_entry_point_on_cpu():
    """``launch.serve`` end to end at reduced size: every request served
    with its (capped) token count; all arrive at t=0."""
    lines = []
    report, reqs = serve(arch="qwen2-0.5b", size="reduced", requests=3,
                         max_batch=2, max_len=32, prompt_cap=8, gen_cap=4,
                         seed=0, device="cpu", log=lines.append)
    assert sorted(r.rid for r in report.results) == [0, 1, 2]
    want = {r["rid"]: max(r["gen_len"], 2) for r in reqs}
    assert all(len(r.tokens) == want[r.rid] for r in report.results)
    assert all(len(r["prompt"]) <= 8 and r["gen_len"] <= 4 for r in reqs)
    assert len(lines) == 1 and "3 requests" in lines[0]


def test_engine_refuses_params_in_another_dtype(small):
    cfg, params = small
    with pytest.raises(ValueError, match="serves"):
        ServingEngine(cfg, params, device="cpu", dtype="float32")


@pytest.mark.parametrize("trace,rate,n,max_len,seed", [
    ("chat", 100.0, 6, 12, 0),
    ("summarization", 0.5, 4, 4096, 3),
    ("creation", 2.0, 5, 2048, 11),
])
def test_requests_equal_reference(trace, rate, n, max_len, seed):
    ours = make_serving_requests(trace, rate, n, 512, seed=seed,
                                 max_len=max_len)
    ref = j_requests(trace, rate, n, 512, seed=seed, max_len=max_len)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert (a["rid"], a["arrival"], a["gen_len"]) == \
            (b["rid"], b["arrival"], b["gen_len"])
        np.testing.assert_array_equal(a["prompt"], b["prompt"])
        assert a["prompt"].dtype == b["prompt"].dtype


@pytest.mark.parametrize("budget", [None, 40])
@pytest.mark.parametrize("arch,ctx", [("qwen2-0.5b", 14),
                                      ("mixtral-8x7b", 30),
                                      ("gemma3-12b", 30),
                                      ("deepseek-v2-lite-16b", 14)])
def test_engine_matches_jax_engine_fp32(arch, ctx, budget):
    """Same requests, same (converted) fp32 weights: same tokens per rid,
    iterations and preemptions as the reference engine.  mixtral's and
    gemma3's prompts of up to 30 tokens and 7 more generated run past
    their rings of 32 slots (gemma3: beside its global layers' full
    caches); deepseek serves from latent caches, its prefix block's
    beside the scanned blocks'."""
    jcfg = dataclasses.replace(JC.get_reduced(arch), dtype="float32")
    tcfg = dataclasses.replace(TC.get_reduced(arch), dtype="float32")
    jparams = JT.init_params(jax.random.PRNGKey(1), jcfg)
    tparams = params_from_jax(jax.device_get(jparams), tcfg, device="cpu")
    reqs = _reqs(tcfg, 5, gen=7, ctx=ctx)
    kw = dict(max_batch=3, max_len=48, kv_token_budget=budget)
    jrep = JEngine(jcfg, jparams, **kw).run(reqs, time_scale=0.0)
    trep = ServingEngine(tcfg, tparams, device="cpu", **kw).run(
        reqs, time_scale=0.0)
    assert {r.rid: r.tokens for r in trep.results} == \
        {r.rid: r.tokens for r in jrep.results}
    assert trep.iterations == jrep.iterations
    assert trep.preemptions == jrep.preemptions
    if budget is not None:
        assert trep.preemptions > 0


def test_serve_entry_point_cuts_depth():
    """``depth`` keeps that many blocks at full width (mixtral FULL on
    one card runs at depth 16 of 32)."""
    lines = []
    report, _ = serve(arch="mixtral-8x7b", size="reduced", requests=2,
                      max_batch=2, max_len=64, prompt_cap=40, gen_cap=3,
                      seed=0, device="cpu", log=lines.append, depth=1)
    assert sorted(r.rid for r in report.results) == [0, 1]
    assert "mixtral-reduced" in lines[0]
