"""The end-to-end statistics are taken over every request and all of the
window's time, never from medians of pieces."""

import statistics
from types import SimpleNamespace

import pytest

from bench.harness import spec

serve = spec.kind("serve_waves")


def result(rid, ttft, tpot, n):
    return SimpleNamespace(rid=rid, ttft=ttft, tpot=tpot, tokens=[1] * n)


def fake_window():
    w1 = [result(0, 1.0, 0.10, 3), result(1, 2.0, 0.20, 5),
          result(2, 9.0, 0.90, 2)]
    w2 = [result(0, 3.0, 0.30, 4), result(1, 4.0, 0.40, 6)]
    waves = [{"requests": [{"rid": r.rid, "prompt": [1] * 3, "gen_len": len(r.tokens)}
                           for r in w],
              "report": SimpleNamespace(results=w, iterations=it),
              "seconds": s} for w, it, s in ((w1, 6, 2.0), (w2, 7, 3.0))]
    return {"waves": waves, "seconds": 5.0}


def test_serving_statistics_cover_every_request_and_the_whole_window():
    e = serve.end_to_end(fake_window())
    assert e["serve_tokens_per_s"] == pytest.approx(20 / 5.0)
    # the median of all five requests, not a median of the waves' medians
    assert e["ttft_ms_p50"] == pytest.approx(3000.0)
    assert e["tpot_ms_p50"] == pytest.approx(300.0)
    assert statistics.median([statistics.median([1, 2, 9]),
                              statistics.median([3, 4])]) != 3.0


def test_counts_flag_missing_and_short_requests():
    win = fake_window()
    assert serve.counts(win) == {"attempted": 5, "failed": 0}
    win["waves"][0]["requests"][1]["gen_len"] = 9
    win["waves"][1]["report"].results.pop()
    assert serve.counts(win) == {"attempted": 5, "failed": 2}


def test_occupancy_counts_tokens_after_the_first_over_slot_iterations():
    run = SimpleNamespace(out={"window": fake_window()}, mix={"slots": 2})
    got = spec.reader("engine.occupancy")(run)
    assert got == pytest.approx(100.0 * (20 - 5) / (2 * 13))



@pytest.mark.parametrize("name,key", [("engine.ttft_ms_p50", "ttft_ms_p50"),
                                      ("engine.tpot_ms_p50", "tpot_ms_p50")])
def test_engine_latency_readings_are_the_windows_medians(name, key):
    e = serve.end_to_end(fake_window())
    run = SimpleNamespace(out={"window": fake_window(), "e2e": e})
    assert spec.reader(name)(run) == e[key]
    assert spec.reader(name)(SimpleNamespace(out={})) is None
