"""The port's tracer (``repro_torch.tracing``) and the engine's counters
and stamps, on the CPU at a tiny size.

Spans are recorded only while a ``torch.profiler`` profile records; off,
``span`` is a shared no-op that enters no host range.  On, each
layer boundary is a span with its parent and ids, on the clock of the
profiler's own events.  The engine counts its replay steps and stamps
each request's queue wait and each token, and the profiler changes none
of what it serves.
"""

import time
import types
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import configs as TC  # noqa: E402
from repro_torch import tracing  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import decode_attention as DA  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import rmsnorm as RN  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving import engine as engine_mod  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

ENGINE_SPANS = ("engine.iteration", "engine.admit", "engine.replay_step",
                "engine.upload", "engine.readback", "engine.retire")
MODEL_SPANS = ("model.decode_step", "model.attention", "model.head",
               "moe_forward")


@pytest.fixture(scope="module")
def moe():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = TC.get_reduced("mixtral_8x7b")
    params = TT.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    yield cfg, params
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _empty_buffer():
    tracing.clear()
    yield
    tracing.clear()


def _reqs(prompts, gen=3):
    return [dict(rid=i, arrival=0.0, prompt=list(range(1, p + 1)),
                 gen_len=gen) for i, p in enumerate(prompts)]


def _serve(cfg, params, reqs, **kw):
    eng = ServingEngine(cfg, params, device="cpu", **kw)
    return eng.run([dict(r) for r in reqs], time_scale=0.0)


def _step_clock(monkeypatch, eng):
    """Make the engine's clock advance 1.0 per decode step, prompt
    replays included, so its stamps count steps."""
    clock = [0.0]
    decode = eng._decode

    def counted(toks):
        clock[0] += 1.0
        return decode(toks)

    monkeypatch.setattr(eng, "_decode", counted)
    monkeypatch.setattr(engine_mod, "time",
                        types.SimpleNamespace(perf_counter=lambda: clock[0]))


# -- off: nothing recorded, no range entered ------------------------------------

def test_without_a_profiler_no_span_is_recorded_and_no_range_entered(
        moe, monkeypatch):
    entered = []
    monkeypatch.setattr(tracing, "_RecordFunctionFast",
                        lambda name: entered.append(name))
    assert tracing.span("a") is tracing.span("b", rid=1, step=2)
    rep = _serve(*moe, _reqs([3, 2, 4]), max_batch=2, max_len=32)
    assert len(rep.results) == 3
    assert tracing.spans() == [] and entered == []


# -- on: the spans of every layer, their parents, ids and clock -----------------

def _profiled(moe, reqs, **kw):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rep = _serve(*moe, reqs, **kw)
    return rep, tracing.spans(), prof


def test_spans_under_a_profiler_nest_by_layer_with_their_ids(moe):
    reqs = _reqs([3, 2, 4])
    rep, spans, _ = _profiled(moe, reqs, max_batch=2, max_len=32)
    by = {s.index: s for s in spans}
    names = Counter(s.name for s in spans)
    assert set(names) == set(ENGINE_SPANS) | set(MODEL_SPANS)
    steps = rep.replay_steps + rep.iterations
    layers = moe[0].n_layers
    assert names["engine.iteration"] == rep.iterations
    assert names["engine.replay_step"] == rep.replay_steps == 9
    assert names["engine.admit"] == len(reqs)
    assert names["engine.retire"] == rep.iterations
    assert names["engine.upload"] == names["model.decode_step"] == steps
    assert names["model.head"] == steps
    assert names["model.attention"] == names["moe_forward"] == steps * layers
    # each decode step: argmax; each iteration: the copy to the host too
    assert names["engine.readback"] == steps + rep.iterations

    def parent(s):
        return by[s.parent].name if s.parent >= 0 else None

    for s in spans:
        p = parent(s)
        if s.name == "engine.iteration":
            assert p is None
        elif s.name in ("engine.admit", "engine.retire"):
            assert p == "engine.iteration"
        elif s.name == "engine.replay_step":
            assert p == "engine.admit"
            assert s.ids == {"rid": by[s.parent].ids["rid"]}
        elif s.name in ("engine.upload", "model.decode_step"):
            assert p in ("engine.replay_step", "engine.iteration")
        elif s.name == "engine.readback":
            assert p in ("engine.replay_step", "engine.iteration")
        else:
            assert p == "model.decode_step", s
        if s.parent >= 0:
            outer = by[s.parent]
            assert outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns
    iters = [s for s in spans if s.name == "engine.iteration"]
    assert [s.ids for s in iters] == [{"step": i}
                                      for i in range(rep.iterations)]
    admits = [s for s in spans if s.name == "engine.admit"]
    assert sorted(s.ids["rid"] for s in admits) == [0, 1, 2]
    replays = Counter(s.ids["rid"] for s in spans
                      if s.name == "engine.replay_step")
    assert replays == {r["rid"]: len(r["prompt"]) for r in reqs}


def test_spans_hold_the_profilers_ranges_on_its_clock(moe):
    """Each span holds the profiler's event of the same name (its stamps
    bracket the range; 50 us for the profiler's conversion of its own
    clock), and the span's ends lie within 1 ms of the event's in the
    median: a stall of the host between a stamp and the range only
    widens the span."""
    _, spans, prof = _profiled(moe, _reqs([3, 2]), max_batch=2, max_len=32)
    ranges = {}
    names = set(ENGINE_SPANS + MODEL_SPANS)
    for e in prof.profiler.kineto_results.events():
        if e.name() in names and str(e.device_type()).endswith("CPU"):
            ranges.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    slack = []
    for name in ENGINE_SPANS + MODEL_SPANS:
        ours = sorted((s.start_ns, s.end_ns) for s in spans
                      if s.name == name)
        theirs = sorted(ranges[name])
        assert len(ours) == len(theirs) > 0, name
        for (a, b), (c, d) in zip(ours, theirs):
            assert a - 50_000 <= c <= d <= b + 50_000, name
            slack += [abs(c - a), abs(b - d)]
    assert np.median(slack) < 1_000_000


def test_spans_filter_by_window_and_clear(moe):
    _, spans, _ = _profiled(moe, _reqs([2]), max_batch=1, max_len=32)
    assert spans == sorted(spans, key=lambda s: (s.start_ns, s.index))
    mid = spans[len(spans) // 2]
    inside = tracing.spans(mid.start_ns, mid.end_ns)
    assert mid in inside
    assert all(s.end_ns >= mid.start_ns and s.start_ns <= mid.end_ns
               for s in inside)
    assert tracing.spans(spans[-1].end_ns + 10 ** 9) == []
    tracing.clear()
    assert tracing.spans() == []


def test_a_span_left_by_an_exception_is_recorded_and_unwinds():
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(KeyError):
            with tracing.span("outer"):
                with tracing.span("inner", rid=7):
                    raise KeyError
        with tracing.span("after"):
            pass
    spans = {s.name: s for s in tracing.spans()}
    assert spans["inner"].parent == spans["outer"].index
    assert spans["inner"].ids == {"rid": 7}
    assert spans["after"].parent == -1


@pytest.mark.parametrize("name", ["rmsnorm", "decode_attention",
                                  "flash_attention", "ssd_scan"])
def test_each_kernel_launch_is_a_kernel_span(name, monkeypatch):
    """The ctypes launch of each wrapper, with a stand-in for the library
    (no card here), runs inside one ``kernel.<name>`` span."""
    called = []

    def fake_kernel(entry, argtypes):
        return lambda *args: called.append(time.time_ns()) or 0

    monkeypatch.setattr(build, "kernel", fake_kernel)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    for mod in (RN, DA, FA, SSD):
        monkeypatch.setattr(mod, "launches", mod.launches)
    monkeypatch.setattr(DA, "variant_launches", {})
    monkeypatch.setattr(SSD, "variant_launches",
                        dict.fromkeys(SSD.variant_launches, 0))
    with profile(activities=[ProfilerActivity.CPU]):
        if name == "rmsnorm":
            RN._launch(torch.ones(2, 64), torch.ones(64), 1e-6)
        elif name == "decode_attention":
            monkeypatch.setattr(DA, "check_kernel_args", lambda *a: None)
            monkeypatch.setattr(DA, "_sm_count", lambda device: 132)
            q, kv = torch.ones(2, 4, 64), torch.ones(2, 16, 2, 64)
            DA._launch(q, kv, kv, torch.full((2,), 16, dtype=torch.int32),
                       scale=0.125)
        elif name == "flash_attention":
            monkeypatch.setattr(FA, "check_kernel_args", lambda *a: None)
            t = torch.ones(1, 8, 2, 64)
            FA._launch(t, t, t, scale=0.125, causal=True, window=None,
                       q_offset=0)
        else:
            x, b = torch.zeros(1, 8, 1, 32), torch.zeros(1, 8, 16)
            SSD._launch(x, torch.zeros(1, 8, 1), torch.zeros(1), b, b, 128,
                        kernel="cuda_cores")
    spans = tracing.spans()
    assert [s.name for s in spans] == [f"kernel.{name}"]
    assert len(called) == 1
    assert spans[0].start_ns <= called[0] <= spans[0].end_ns


# -- counters and stamps, always on ---------------------------------------------

def test_replay_steps_count_every_prompt_token_replayed(moe):
    reqs = _reqs([3, 5, 2, 4])
    rep = _serve(*moe, reqs, max_batch=2, max_len=32)
    assert rep.preemptions == 0
    assert rep.replay_steps == sum(len(r["prompt"]) for r in reqs)


def test_replay_steps_count_again_after_a_preemption(moe, monkeypatch):
    eng = ServingEngine(*moe, max_batch=2, max_len=32, kv_token_budget=10,
                        device="cpu")
    replayed = []
    prefill = eng._prefill_slot

    def counted(i):
        replayed.append(len(eng.slots[i].prompt))
        prefill(i)

    monkeypatch.setattr(eng, "_prefill_slot", counted)
    reqs = _reqs([4, 4], gen=6)
    rep = eng.run(reqs, time_scale=0.0)
    assert rep.preemptions > 0 and len(replayed) > len(reqs)
    assert rep.replay_steps == sum(replayed) > 8
    assert [len(r.tokens) for r in rep.results] == [6, 6]
    # a second run counts its own replays only
    rep2 = eng.run(_reqs([3]), time_scale=0.0)
    assert rep2.replay_steps == 3


def test_token_times_stamp_every_token_and_average_to_tpot(moe):
    rep = _serve(*moe, _reqs([3, 2, 4, 1], gen=5), max_batch=2, max_len=32)
    for r in rep.results:
        assert len(r.token_times) == len(r.tokens) == 5
        assert r.token_times[0] == r.arrival + r.ttft
        assert r.token_times[-1] == r.arrival + r.e2e
        gaps = np.diff(r.token_times)
        assert (gaps > 0).all()
        assert gaps.mean() == pytest.approx(r.tpot, rel=1e-9)


def test_queue_wait_on_a_step_clock(moe, monkeypatch):
    """One slot, A (3 prompt tokens) then B: A leaves the queue at once;
    B when A's 3 replay steps and its one decode step are done, at A's
    end.  Tokens are stamped at the end of their steps."""
    eng = ServingEngine(*moe, max_batch=1, max_len=32, device="cpu")
    _step_clock(monkeypatch, eng)
    rep = eng.run(_reqs([3, 2], gen=2), time_scale=0.0)
    a, b = sorted(rep.results, key=lambda r: r.rid)
    assert a.queue_wait == 0.0 and a.token_times == [3.0, 4.0]
    assert b.queue_wait == a.e2e == 4.0 and b.token_times == [6.0, 7.0]
    assert rep.replay_steps == 5 and rep.iterations == 2


def test_a_preempted_request_keeps_its_first_queue_wait(moe, monkeypatch):
    eng = ServingEngine(*moe, max_batch=2, max_len=32, kv_token_budget=10,
                        device="cpu")
    _step_clock(monkeypatch, eng)
    rep = eng.run(_reqs([4, 4], gen=6), time_scale=0.0)
    assert rep.preemptions > 0
    a, b = sorted(rep.results, key=lambda r: r.rid)
    # B left the queue first once A's 4 replay steps were done
    assert a.queue_wait == 0.0 and b.queue_wait == 4.0
    assert b.ttft > b.queue_wait + 4


def test_queue_wait_on_the_host_clock(moe):
    rep = _serve(*moe, _reqs([3, 2], gen=3), max_batch=1, max_len=32)
    a, b = sorted(rep.results, key=lambda r: r.rid)
    step = min(np.diff(a.token_times).min(), np.diff(b.token_times).min())
    assert 0.0 <= a.queue_wait < step
    # B waited for A's replay, its tokens and the iteration that freed it
    assert b.queue_wait >= a.e2e > a.ttft


def test_the_profiler_changes_nothing_served(moe):
    reqs = _reqs([3, 5, 2, 4], gen=4)
    kw = dict(max_batch=2, max_len=32, kv_token_budget=10)
    off = _serve(*moe, reqs, **kw)
    on, spans, _ = _profiled(moe, reqs, **kw)
    assert spans
    assert off.preemptions == on.preemptions > 0
    assert (off.iterations, off.replay_steps) == (on.iterations,
                                                   on.replay_steps)
    assert {r.rid: r.tokens for r in off.results} == \
        {r.rid: r.tokens for r in on.results}
