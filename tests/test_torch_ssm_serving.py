"""The port's engine serving mamba2 REDUCED on the CPU, against each
request served alone by the JAX package (``prefill`` on a fresh batch-1
cache, then greedy ``decode_step``), in fp32.

The reference engine replays one slot's prompt through ``decode_step``
over the whole batch and restores only the other slots' lengths, so
their SSM states and conv windows advance for good, and a reused slot
starts from the state its last request left.  The port zeroes an
admitted slot's state and puts the other active slots' state back after
the replay (``repro_torch/serving/engine.py``).  The last test pins the
reference's behaviour, which the port departs from on purpose.

Arrivals are in engine steps: a fake clock advances 1.0 per decode step
(prompt-replay steps included), so admission does not depend on wall
time.
"""

import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.serving import engine as engine_mod  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

ARCH = "mamba2-2.7b"
MAX_LEN = 64

_jprefill = jax.jit(JT.prefill, static_argnums=(1, 3))
_jdecode = jax.jit(JT.decode_step, static_argnums=(1,))


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(JC.get_reduced(ARCH), dtype="float32")
    tcfg = dataclasses.replace(TC.get_reduced(ARCH), dtype="float32")
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.device_get(jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def served_alone(jcfg, jparams, req) -> list:
    """The tokens of ``req`` served alone by the JAX package: ``prefill``
    of its prompt on a fresh batch-1 cache, then greedy ``decode_step``,
    as many tokens as the engine gives it (at least 2)."""
    prompt = jnp.asarray(np.asarray(req["prompt"], np.int32))[None]
    logits, cache = _jprefill(jparams, jcfg, prompt, MAX_LEN)
    toks = [int(jnp.argmax(logits[0]))]
    while len(toks) < max(req["gen_len"], 2):
        logits, cache = _jdecode(jparams, jcfg,
                                 jnp.asarray([[toks[-1]]], jnp.int32), cache)
        toks.append(int(jnp.argmax(logits[0])))
    return toks


def _requests(vocab, arrivals, prompt_lens, gen_lens, seed=0):
    rng = np.random.default_rng(seed)
    return [dict(rid=i, arrival=float(a),
                 prompt=rng.integers(1, vocab, n).astype(np.int32),
                 gen_len=g)
            for i, (a, n, g) in enumerate(zip(arrivals, prompt_lens,
                                              gen_lens))]


def _step_clock(monkeypatch, eng):
    """The engine's clock advances 1.0 per decode step."""
    clock = [0.0]
    decode = eng._decode

    def timed_decode(toks):
        clock[0] += 1.0
        return decode(toks)

    monkeypatch.setattr(eng, "_decode", timed_decode)
    monkeypatch.setattr(engine_mod, "time",
                        types.SimpleNamespace(perf_counter=lambda: clock[0]))


def _watch_prefills(monkeypatch, eng, log):
    """Check every prefill: the admitted slot's state is zero before it,
    and every other active slot's state is the same after it."""
    prefill = eng._prefill_slot

    def checked(i):
        state = eng._state()
        assert state and all(not t[:, i].any() for t in state), i
        others = [j for j, s in enumerate(eng.slots) if s.active and j != i]
        before = [t[:, others].clone() for t in state]
        prefill(i)
        for t, rows in zip(state, before):
            assert torch.equal(t[:, others], rows), (i, others)
        log.append((i, eng.slots[i].rid, others))

    monkeypatch.setattr(eng, "_prefill_slot", checked)


@pytest.mark.parametrize("max_batch", [2, 4])
def test_each_request_gets_the_tokens_it_gets_alone(models, monkeypatch,
                                                    max_batch):
    """Staggered arrivals, a reused slot and a preemption: every request's
    tokens equal those of the request served alone by the JAX package."""
    jcfg, tcfg, jparams, tparams = models
    reqs = _requests(tcfg.vocab_size, arrivals=[0, 0, 3, 9, 30, 31],
                     prompt_lens=[5, 8, 5, 8, 5, 8],
                     gen_lens=[6, 4, 7, 5, 6, 3])
    eng = ServingEngine(tcfg, tparams, max_batch=max_batch,
                        max_len=MAX_LEN, kv_token_budget=22, device="cpu")
    _step_clock(monkeypatch, eng)
    log = []
    _watch_prefills(monkeypatch, eng, log)
    rep = eng.run(reqs, time_scale=1.0)
    assert rep.preemptions >= 1
    slots = [i for i, _, _ in log]
    assert len(slots) > len(set(slots))            # a slot was reused
    assert any(others for _, _, others in log)     # with neighbours active
    got = {r.rid: r.tokens for r in rep.results}
    assert sorted(got) == [r["rid"] for r in reqs]
    for r in reqs:
        assert got[r["rid"]] == served_alone(jcfg, jparams, r), r["rid"]


def test_admitted_slot_state_is_zero_before_its_prefill(models,
                                                        monkeypatch):
    """``_admit`` zeroes the admitted slot's ``ssm``, ``conv_x`` and
    ``conv_bc`` rows in every layer and touches no other slot's."""
    _, tcfg, _, tparams = models
    eng = ServingEngine(tcfg, tparams, max_batch=3, max_len=MAX_LEN,
                        device="cpu")
    gen = torch.Generator().manual_seed(0)
    state = eng._state()
    assert len(state) == 3 * len(tcfg.block_pattern)
    for t in state:
        t.normal_(generator=gen)
    stale = [t.clone() for t in state]
    seen = {}
    monkeypatch.setattr(eng, "_prefill_slot", lambda i: seen.update(
        {i: [t.clone() for t in eng._state()]}))
    eng.queue = _requests(tcfg.vocab_size, [0], [5], [4])
    eng._admit(now=0.0)
    (i, rows), = seen.items()
    for t, old in zip(rows, stale):
        assert not t[:, i].any()
        rest = [j for j in range(3) if j != i]
        assert torch.equal(t[:, rest], old[:, rest])


def test_reference_engine_tokens_change_with_a_neighbour(models):
    """The reference fault the port departs from: the JAX engine gives a
    request its tokens served alone when it is alone, and other tokens
    when a neighbour's prompt is replayed beside it.  The port gives the
    alone tokens both times."""
    jcfg, tcfg, jparams, tparams = models
    a, b = _requests(tcfg.vocab_size, arrivals=[0, 0], prompt_lens=[5, 8],
                     gen_lens=[6, 6])
    alone = served_alone(jcfg, jparams, a)
    kw = dict(max_batch=2, max_len=MAX_LEN)

    def tokens(rep):
        return {r.rid: r.tokens for r in rep.results}

    assert tokens(JEngine(jcfg, jparams, **kw).run(
        [a], time_scale=0.0))[0] == alone
    assert tokens(JEngine(jcfg, jparams, **kw).run(
        [a, b], time_scale=0.0))[0] != alone
    port = tokens(ServingEngine(tcfg, tparams, device="cpu", **kw).run(
        [a, b], time_scale=0.0))
    assert port == {0: alone, 1: served_alone(jcfg, jparams, b)}
