"""The reader of the engine's ``graph_steps`` counter
(``engine.graph_step_share``), on synthetic runs and on a tiny CPU run,
where the engine captures nothing; it gives nothing where the program's
reports carry no such counter."""

from types import SimpleNamespace

import pytest

from bench.harness import spec

from conftest import CELL, tiny_run

NAME = "engine.graph_step_share"


def waves(*reports):
    return SimpleNamespace(out={"window": {"waves": [
        {"report": r} for r in reports]}})


def report(**kw):
    return SimpleNamespace(results=[], **kw)


def test_graph_step_share_reads_the_engines_counter():
    read = spec.reader(NAME)
    full = [report(replay_steps=780, iterations=254, graph_steps=1034)] * 2
    assert read(waves(*full)) == 100.0
    half = report(replay_steps=6, iterations=4, graph_steps=5)
    assert read(waves(half)) == pytest.approx(50.0)
    # the parent's reports, which carry no such counter
    assert read(waves(report(replay_steps=780, iterations=254))) is None
    assert read(waves(report(iterations=254))) is None
    assert read(waves()) is None


def test_the_metric_is_declared_for_the_cell():
    got = [m for m in spec.benchmark()["per_layer"] if m["name"] == NAME]
    assert len(got) == 1
    assert got[0]["workloads"] == [CELL]
    assert got[0]["moves"] == "serve_tokens_per_s"
    assert got[0]["layer"] == "model step"


def test_a_cpu_run_replays_no_step():
    out = tiny_run(CELL, trace=True)
    assert out["metrics"][NAME]["value"] == 0.0
