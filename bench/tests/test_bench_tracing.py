"""The readers of the program's own counters, stamps and spans
(``engine.replay_step_share``, ``engine.queue_wait_ms_p50``,
``engine.itl_ms_p99``, ``device.idle_ms.model``,
``device.idle_ms.engine``, ``device.idle_ms.attention``,
``device.idle_ms.moe``), on synthetic runs; each gives nothing where
the program has nothing to read.  On a card, a span and the device trace
share a clock."""

import sys
from types import SimpleNamespace

import numpy as np
import pytest

from bench.harness import spec
from bench.harness.trace import Capture, Trace

NEW = ("engine.replay_step_share", "engine.queue_wait_ms_p50",
       "engine.itl_ms_p99", "device.idle_ms.model", "device.idle_ms.engine",
       "device.idle_ms.attention", "device.idle_ms.moe")
IDLE = NEW[3:]


def read(name, run):
    return spec.reader(name)(run)


def waves(*reports):
    return SimpleNamespace(out={"window": {"waves": [
        {"report": r} for r in reports]}})


def result(**kw):
    return SimpleNamespace(**kw)


def test_replay_step_share_reads_the_engines_counter():
    run = waves(SimpleNamespace(replay_steps=780, iterations=254,
                                results=[]),
                SimpleNamespace(replay_steps=780, iterations=254,
                                results=[]))
    assert read("engine.replay_step_share", run) == pytest.approx(
        100 * 780 / 1034)
    parent = waves(SimpleNamespace(iterations=254, results=[]))
    assert read("engine.replay_step_share", parent) is None


def test_queue_wait_median_in_ms():
    rep = SimpleNamespace(results=[result(queue_wait=w)
                                   for w in (0.0, 0.5, 2.0)])
    assert read("engine.queue_wait_ms_p50", waves(rep)) == 500.0
    parent = SimpleNamespace(results=[result(ttft=1.0)])
    assert read("engine.queue_wait_ms_p50", waves(parent)) is None
    assert read("engine.queue_wait_ms_p50",
                waves(SimpleNamespace(results=[]))) is None


def test_itl_p99_over_every_gap_of_every_request():
    # 200 gaps of 10 ms and 2 of 5 s: the 99th percentile lies among the
    # 10 ms gaps' upper edge, pulled up by the two stalls
    times = np.concatenate([np.arange(101) * 0.01,
                            1.0 + np.array([5.0, 10.0])]).tolist()
    rep = SimpleNamespace(results=[result(token_times=times),
                                   result(token_times=np.arange(100) * 0.01)])
    gaps = np.concatenate([np.diff(times), np.diff(np.arange(100) * 0.01)])
    got = read("engine.itl_ms_p99", waves(rep))
    assert got == pytest.approx(np.percentile(gaps, 99) * 1e3)
    parent = SimpleNamespace(results=[result(tpot=0.1)])
    assert read("engine.itl_ms_p99", waves(parent)) is None


# -- idle time by span ---------------------------------------------------------

def trace(window=(0, 1000), steps=2):
    """Kernels at [0, 100], [200, 300], [500, 600], [800, 1000]: idle
    from 100 to 200, 300 to 500 and 600 to 800."""
    start = np.array([0, 200, 500, 800], np.int64)
    dur = np.array([100, 100, 100, 200], np.int64)
    return Trace(["k"] * 4, start, dur, np.zeros(4, np.int64), {}, [],
                 np.zeros(0, np.int64), np.zeros(0, np.int64), window, steps)


def synthetic_spans():
    from repro_torch.tracing import Span
    return [
        Span("engine.iteration", 0, 660, -1, {"step": 0}, 0),
        # the first gap's middle (150): under the upload
        Span("engine.upload", 120, 180, 0, {}, 1),
        Span("model.decode_step", 190, 650, 0, {}, 2),
        Span("model.attention", 200, 290, 2, {}, 3),
        # the second gap's middle (400): after the MoE span ended, so
        # under the step that encloses it
        Span("moe_forward", 300, 380, 2, {}, 4),
        Span("model.head", 460, 640, 2, {}, 5),
        # the third gap's middle (700): after every span ended
    ]


def recorded(monkeypatch, held):
    """Make ``tracing.spans`` give ``held``'s spans that overlap its
    window."""
    from repro_torch import tracing
    monkeypatch.setattr(tracing, "spans", lambda t0, t1: [
        s for s in held if s.end_ns >= t0 and s.start_ns <= t1])


@pytest.fixture
def spans(monkeypatch):
    recorded(monkeypatch, synthetic_spans())


def test_idle_time_is_split_by_the_span_the_host_was_in(spans):
    run = SimpleNamespace(out={"device_trace": trace()})
    split, steps = spec.module("metrics", "device.idle_ms.model").split(run)
    assert split == {"engine": 100, "model": 200, "none": 200,
                     "attention": 0, "moe": 0}
    assert steps == 2
    assert read("device.idle_ms.model", run) == 200 / 2 / 1e6
    assert read("device.idle_ms.engine", run) == 100 / 2 / 1e6
    assert read("device.idle_ms.attention", run) == 0.0
    assert read("device.idle_ms.moe", run) == 0.0


def test_the_models_idle_time_is_split_by_attention_and_moe(monkeypatch):
    from repro_torch.tracing import Span
    recorded(monkeypatch, [
        Span("engine.iteration", 0, 900, -1, {"step": 0}, 0),
        Span("model.decode_step", 50, 890, 0, {}, 1),
        Span("model.attention", 60, 250, 1, {}, 2),
        # the first gap's middle (150): under a kernel inside a mixer
        Span("kernel.decode_attention", 140, 160, 2, {}, 3),
        # the second's (400): under an MoE FFN
        Span("moe_forward", 300, 450, 1, {}, 4),
        # the third's (700): under the step alone
    ])
    run = SimpleNamespace(out={"device_trace": trace()})
    split, _ = spec.module("metrics", "device.idle_ms.model").split(run)
    assert split == {"engine": 0, "model": 500, "none": 0,
                     "attention": 100, "moe": 200}
    assert read("device.idle_ms.attention", run) == 100 / 2 / 1e6
    assert read("device.idle_ms.moe", run) == 200 / 2 / 1e6


def test_idle_time_reads_only_the_spans_of_the_traces_window(spans):
    run = SimpleNamespace(out={"device_trace": trace(window=(700, 1000))})
    # the window holds no span: nothing to read
    for name in IDLE:
        assert read(name, run) is None


@pytest.mark.parametrize("name", IDLE)
def test_idle_readers_give_nothing_without_a_trace_or_spans(name,
                                                            monkeypatch):
    assert read(name, SimpleNamespace(out={})) is None
    recorded(monkeypatch, [])
    assert read(name, SimpleNamespace(out={"device_trace": trace()})) is None
    # a program without the tracer
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert read(name, SimpleNamespace(out={"device_trace": trace()})) is None


def test_every_new_metric_is_declared_for_the_cell():
    bench = spec.benchmark()
    got = {m["name"]: m for m in bench["per_layer"] if m["name"] in NEW}
    assert set(got) == set(NEW)
    for m in got.values():
        assert m["workloads"] == ["mixtral-eps1e-6.chat"]
        assert m["moves"] == "serve_tokens_per_s"


# -- on a card: the spans' clock is the device trace's -------------------------

@pytest.mark.chip
def test_a_span_holds_its_kernels_device_interval(cuda):
    """Two spans, each around a ``torch.cuda._sleep`` launch and a
    synchronise: each holds its kernel's device interval within 50 us on
    the trace's clock, and the first kernel ends before the second span
    begins, the second kernel starts after the first span ended."""
    import torch

    from repro_torch import tracing
    torch.cuda._sleep(1000)
    torch.cuda.synchronize(cuda)
    tracing.clear()
    cap = Capture(cuda)
    cap.start()
    for name in ("probe.first", "probe.second"):
        with tracing.span(name):
            torch.cuda._sleep(2_000_000)
            torch.cuda.synchronize(cuda)
    tr = cap.stop()
    ours = {s.name: s for s in tracing.spans(*tr.window)}
    # the two sleeps (``spin_kernel``), by far the longest activities
    k = sorted(np.argsort(tr.kernel_dur)[-2:], key=lambda i: tr.kernel_start[i])
    (a0, a1), (b0, b1) = [(int(tr.kernel_start[i]),
                           int(tr.kernel_start[i] + tr.kernel_dur[i]))
                          for i in k]
    first, second = ours["probe.first"], ours["probe.second"]
    tol = 50_000
    assert first.start_ns - tol <= a0 and a1 <= first.end_ns + tol
    assert second.start_ns - tol <= b0 and b1 <= second.end_ns + tol
    assert a1 <= second.start_ns + tol and first.end_ns <= b0 + tol
    tracing.clear()
