"""The serving engine's decode step replayed as a CUDA graph
(``models.transformer.CapturedStep``, ``serving.engine.GRAPH_DEVICES``).

On the CPU nothing is captured, and the engine is today's.  With a
stand-in for ``torch.cuda``'s streams, ``CUDAGraph`` and ``graph``, whose
replay runs the captured ``_decode_step`` call again and writes its
logits into the tensor the capture returned (Python's launch counters
put back, since a graph's replay runs no Python), the CPU drives the
capture path: static buffers, the warm-up step, the zeroed cache, the
launch counters and the engine's ``graph_steps``.  The tests marked
``chip`` run the real graph on a card:

    python -m pytest -q -m chip tests/test_torch_graph.py

This file imports no JAX, so that it runs on a card's machine.
"""

import contextlib
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as C  # noqa: E402
from repro_torch.data.requests import make_serving_requests  # noqa: E402
from repro_torch.kernels import decode_attention as DA  # noqa: E402
from repro_torch.kernels import rmsnorm as RMS  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving import engine as engine_mod  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

GQA, SSM, MLA, MOE = ("qwen2-0.5b", "mamba2-2.7b", "deepseek-v2-lite-16b",
                      "mixtral-8x7b")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def model(arch, device="cpu", dtype="float32"):
    cfg = dataclasses.replace(C.get_reduced(arch), dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(0)
    return cfg, T.init_params(gen, cfg, device=device)


def requests(cfg, n=5, gen=5, ctx=10):
    rs = make_serving_requests("chat", 1.0, n, cfg.vocab_size, seed=1,
                               max_len=ctx)
    for r in rs:
        r["gen_len"] = gen
        r["prompt"] = r["prompt"][:ctx]
    return rs


def served(report):
    return ({r.rid: r.tokens for r in report.results}, report.iterations,
            report.preemptions, report.replay_steps)


# -- the stand-in ------------------------------------------------------------

class _Stream:
    def wait_stream(self, other):
        pass


class _Graph:
    """Replays the ``_decode_step`` calls made while it was captured."""

    def __init__(self):
        self.calls = []

    def replay(self):
        counts = T._launch_counts()
        for args, logits in self.calls:
            logits.copy_(_REAL_STEP[0](*args))
        T._set_launch_counts(counts)


_CAPTURING = [None]
_REAL_STEP = [None]


@contextlib.contextmanager
def _capture(graph, stream=None):
    _CAPTURING[0] = graph
    try:
        yield
    finally:
        _CAPTURING[0] = None


@pytest.fixture
def graphs(monkeypatch):
    """The capture path on the CPU; yields the list of captured graphs."""
    made = []
    real = _REAL_STEP[0] = T._decode_step

    def step(*args):
        out = real(*args)
        if _CAPTURING[0] is not None:
            _CAPTURING[0].calls.append((args, out))
        return out

    def graph():
        made.append(_Graph())
        return made[-1]

    monkeypatch.setattr(T, "_decode_step", step)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", graph)
    monkeypatch.setattr(torch.cuda, "graph", _capture)
    monkeypatch.setattr(engine_mod, "GRAPH_DEVICES", ("cpu",))
    return made


@pytest.fixture
def counting(monkeypatch):
    """The RMSNorm and decode-attention wrappers count a launch and run
    their plain versions, as their kernels count on a card."""
    monkeypatch.setattr(RMS, "launches", 0)
    monkeypatch.setattr(DA, "launches", 0)
    monkeypatch.setattr(DA, "variant_launches", {})

    def norm(x, w, eps=1e-6):
        RMS.launches += 1
        return RMS.rms_norm_plain(x, w, eps)

    def attend(q, k, v, lengths, scale=None, with_lse=False):
        DA.launches += 1
        key = (DA.padded_head_dim(q.shape[-1]), q.shape[1] // k.shape[2])
        DA.variant_launches[key] = DA.variant_launches.get(key, 0) + 1
        return DA.decode_attention_plain(q, k, v, lengths, scale, with_lse)

    monkeypatch.setattr(RMS, "rms_norm", norm)
    monkeypatch.setattr(DA, "decode_attention", attend)


# -- on the CPU ----------------------------------------------------------------

def test_the_engine_on_a_cpu_captures_nothing(monkeypatch):
    """No graph: each step is an eager call of ``decode_step``, and the
    tokens are a direct greedy decode's."""
    cfg, params = model(GQA)
    calls = []
    step = T.decode_step

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return step(*args, **kwargs)

    monkeypatch.setattr(T, "decode_step", spy)
    eng = ServingEngine(cfg, params, max_batch=1, max_len=64, device="cpu")
    rep = eng.run([dict(rid=0, arrival=0.0, prompt=[5, 9, 3, 7],
                        gen_len=4)], time_scale=0.0)
    assert rep.graph_steps == 0 and eng._graph is None
    assert calls == [{"graph": None}] * (rep.replay_steps + rep.iterations)
    monkeypatch.setattr(T, "decode_step", step)
    cache = T.init_cache(cfg, 1, 64, device="cpu")
    for t in (5, 9, 3, 7):
        logits, cache = T.decode_step(
            params, cfg, torch.tensor([[t]], dtype=torch.int32), cache)
    toks = [int(torch.argmax(logits[0]))]
    for _ in range(3):
        logits, cache = T.decode_step(
            params, cfg, torch.tensor([[toks[-1]]], dtype=torch.int32),
            cache)
        toks.append(int(torch.argmax(logits[0])))
    assert rep.results[0].tokens == toks


@pytest.mark.parametrize("arch", [GQA, SSM, MLA, MOE])
def test_replayed_steps_serve_the_eager_engines_tokens(arch, graphs):
    """A wave with prompt replay, slot reuse and preemption (a KV budget
    below the prompts'): the same tokens, iterations, preemptions and
    replay steps as the eager engine, every step a replay of the one
    graph captured."""
    cfg, params = model(arch)
    reqs = requests(cfg)
    kw = dict(max_batch=3, max_len=64, kv_token_budget=26, device="cpu")
    devices = engine_mod.GRAPH_DEVICES
    engine_mod.GRAPH_DEVICES = ()
    try:
        eager = ServingEngine(cfg, params, **kw).run(reqs, time_scale=0.0)
    finally:
        engine_mod.GRAPH_DEVICES = devices
    eng = ServingEngine(cfg, params, **kw)
    rep = eng.run(reqs, time_scale=0.0)
    assert eager.preemptions > 0 and eager.graph_steps == 0
    assert served(rep) == served(eager)
    assert rep.graph_steps == rep.replay_steps + rep.iterations
    assert len(graphs) == 1 and len(graphs[0].calls) == 1


def test_restore_captures_again(graphs):
    """``restore()`` allocates a new cache: the graph bound to the old one
    goes, the next step captures on the new one, and the replayed
    requests get the tokens they get from a fresh engine."""
    cfg, params = model(GQA)
    reqs = requests(cfg, n=3)
    eng = ServingEngine(cfg, params, max_batch=2, max_len=64, device="cpu")
    eng.queue = sorted(reqs, key=lambda r: r["arrival"])
    eng._admit(now=1e9)
    first = eng._graph
    assert first is not None and len(graphs) == 1
    eng.restore(eng.snapshot())
    assert eng._graph is None
    rep = eng.run(reqs, time_scale=0.0)
    assert eng._graph is not first and len(graphs) == 2
    fresh = ServingEngine(cfg, params, max_batch=2, max_len=64,
                          device="cpu").run(reqs, time_scale=0.0)
    assert served(rep) == served(fresh)
    assert rep.graph_steps == rep.replay_steps + rep.iterations


@pytest.mark.parametrize("arch", [SSM, GQA])
def test_capture_leaves_the_cache_as_it_found_it(arch, graphs):
    """The warm-up step writes K/V rows and advances SSM state in place;
    the capture zeroes the cache afterwards, so a replay starts from the
    state the eager step starts from."""
    cfg, params = model(arch)
    cache = T.init_cache(cfg, 2, 32, device="cpu")
    cache["len"] = torch.tensor([0, 5], dtype=torch.int32)
    toks = torch.tensor([[3], [7]], dtype=torch.int32)
    step = T.CapturedStep(params, cfg, cache, toks)
    leaves = list(T._cache_leaves({k: v for k, v in cache.items()
                                   if k != "len"}))
    assert leaves and all(not t.any() for t in leaves)
    assert torch.equal(cache["len"], torch.tensor([0, 5], dtype=torch.int32))
    eager = T.init_cache(cfg, 2, 32, device="cpu")
    eager["len"] = cache["len"].clone()
    for t in range(3):
        want, eager = T.decode_step(params, cfg, toks + t, eager)
        got, cache = T.decode_step(params, cfg, toks + t, cache, graph=step)
        assert torch.equal(got, want)
        assert torch.equal(cache["len"], eager["len"])
    for a, b in zip(T._cache_leaves(cache["blocks"]),
                    T._cache_leaves(eager["blocks"])):
        assert torch.equal(a, b)


def test_a_replay_advances_the_launch_counters_as_an_eager_step(
        graphs, counting):
    """Warm-up and capture leave the counters as they were; each replay
    adds one eager step's launches and kernel instances."""
    cfg, params = model(GQA)
    cache = T.init_cache(cfg, 2, 32, device="cpu")
    toks = torch.tensor([[3], [7]], dtype=torch.int32)
    T.decode_step(params, cfg, toks, cache)
    per_step = (RMS.launches, DA.launches, dict(DA.variant_launches))
    assert per_step[0] > 0 and per_step[1] > 0
    RMS.launches = DA.launches = 0
    DA.variant_launches.clear()
    reqs = requests(cfg, n=3)
    rep = ServingEngine(cfg, params, max_batch=2, max_len=64,
                        device="cpu").run(reqs, time_scale=0.0)
    steps = rep.replay_steps + rep.iterations
    assert rep.graph_steps == steps
    assert (RMS.launches, DA.launches) == (per_step[0] * steps,
                                           per_step[1] * steps)
    assert DA.variant_launches == {k: n * steps
                                   for k, n in per_step[2].items()}


def test_a_captured_step_refuses_what_it_is_not_bound_to(graphs):
    cfg, params = model(GQA)
    cache = T.init_cache(cfg, 2, 32, device="cpu")
    toks = torch.zeros((2, 1), dtype=torch.int32)
    step = T.CapturedStep(params, cfg, cache, toks)
    other = T.init_cache(cfg, 2, 32, device="cpu")
    with pytest.raises(ValueError, match="bound"):
        T.decode_step(params, cfg, toks, other, graph=step)
    with pytest.raises(ValueError, match="bound"):
        T.decode_step(params, cfg, toks[:1], cache, graph=step)
    with pytest.raises(ValueError, match="embeds"):
        T.decode_step(params, cfg, toks, cache, graph=step,
                      embeds=torch.zeros(2, 1, cfg.d_model))


# -- on a card -------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.chip
@pytest.mark.parametrize("arch", [MOE, SSM, MLA])
def test_on_a_card_the_graph_serves_the_eager_engines_tokens(arch, cuda,
                                                            monkeypatch):
    """bf16 on the card, a wave with prompt replay, slot reuse and
    preemption: the replayed engine's tokens are the eager engine's."""
    cfg, params = model(arch, cuda, "bfloat16")
    reqs = requests(cfg, n=6, gen=8, ctx=16)
    kw = dict(max_batch=4, max_len=64, kv_token_budget=40, device=cuda)
    eng = ServingEngine(cfg, params, **kw)
    rep = eng.run(reqs, time_scale=0.0)
    monkeypatch.setattr(engine_mod, "GRAPH_DEVICES", ())
    eager = ServingEngine(cfg, params, **kw).run(reqs, time_scale=0.0)
    assert eager.preemptions > 0 and eager.graph_steps == 0
    assert served(rep) == served(eager)
    assert rep.graph_steps == rep.replay_steps + rep.iterations > 0


@pytest.mark.chip
@pytest.mark.parametrize("arch", [MOE, SSM, MLA])
def test_on_a_card_replayed_logits_are_the_eager_steps(arch, cuda):
    """The same steps, eager on one cache and replayed on another: logits,
    lengths and caches bit for bit."""
    cfg, params = model(arch, cuda, "bfloat16")
    B, S = 4, 64
    gen = torch.Generator(device="cpu").manual_seed(2)
    caches = [T.init_cache(cfg, B, S, device=cuda) for _ in range(2)]
    for c in caches:
        c["len"] = torch.tensor([0, 3, 9, 20], dtype=torch.int32,
                                device=cuda)
    toks = torch.randint(1, cfg.vocab_size, (B, 1), generator=gen,
                         dtype=torch.int32).to(cuda)
    step = T.CapturedStep(params, cfg, caches[1], toks)
    for _ in range(6):
        toks = torch.randint(1, cfg.vocab_size, (B, 1), generator=gen,
                             dtype=torch.int32).to(cuda)
        want, caches[0] = T.decode_step(params, cfg, toks, caches[0])
        got, caches[1] = T.decode_step(params, cfg, toks, caches[1],
                                       graph=step)
        assert torch.equal(got, want)
        assert torch.equal(caches[0]["len"], caches[1]["len"])
    for a, b in zip(T._cache_leaves(caches[0]["blocks"]),
                    T._cache_leaves(caches[1]["blocks"])):
        assert torch.equal(a, b)


@pytest.mark.chip
def test_on_a_card_fig6_reduced_passes_its_launch_check(cuda):
    """``launch.fig6 --size reduced`` raises unless every engine step ran
    the RMSNorm and decode kernels as often as a direct step."""
    from repro_torch.launch import fig6
    out = fig6.run("reduced", cuda, log=lambda s: None)
    assert out["launched"]["rmsnorm"] > 0
    assert out["launched"]["decode_attention"] > 0
