"""The port's fluid surrogate, multi-fidelity search, disaggregated pools
and dynamic re-planning (``repro_torch.core.fluid``, ``multifid``,
``dynamic``, ``repro_torch.disagg``) against the live reference, with
tolerance 0: trace summaries, fluid reports under light and heavy load,
KV-transfer estimates, disaggregated schemes, device ids and reports,
joint searches with and without a pool menu, multi-fidelity searches
(serial and forked), epoch schedules, the dynamic simulator and
``search(dynamic=...)``.  Each scenario runs once on each package, built
from that package alone, and ``plain`` turns both results into builtins;
wall-clock fields are set to 0 before the comparison."""

import dataclasses
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro import core as RCORE  # noqa: E402
from repro import disagg as RDIS  # noqa: E402
from repro.core import dynamic as RDYN  # noqa: E402
from repro.core import faults as RFLT  # noqa: E402
from repro.core import fluid as RFLU  # noqa: E402
from repro_torch import core as PCORE  # noqa: E402
from repro_torch import disagg as PDIS  # noqa: E402
from repro_torch.core import dynamic as PDYN  # noqa: E402
from repro_torch.core import faults as PFLT  # noqa: E402
from repro_torch.core import fluid as PFLU  # noqa: E402

from test_torch_simulator import plain  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
REF = types.SimpleNamespace(core=RCORE, disagg=RDIS, dyn=RDYN, faults=RFLT,
                            fluid=RFLU)
PORT = types.SimpleNamespace(core=PCORE, disagg=PDIS, dyn=PDYN,
                             faults=PFLT, fluid=PFLU)
SMALL = dict(hidden_size=256, num_hidden_layers=4, num_attention_heads=8,
             num_key_value_heads=4, intermediate_size=1024, vocab_size=1024)
MEDIUM = dict(hidden_size=512, num_hidden_layers=8, num_attention_heads=8,
              num_key_value_heads=4, intermediate_size=2048, vocab_size=4096)
# 80 layers of a 70B model: no KV room on one H100
BIG = dict(hidden_size=8192, num_hidden_layers=80, num_attention_heads=64,
           num_key_value_heads=8, intermediate_size=28672,
           vocab_size=128256)
# wall-clock fields of the search results, the only ones that may differ
CLOCK = frozenset({"seconds", "search_seconds", "screen_seconds",
                   "confirm_seconds"})
# with ``jobs=2`` the cache counters also depend on which worker priced
# which candidate first (they differ run to run in the reference too)
FORKED = CLOCK | {"cache_hits", "cache_misses"}


def clockless(obj, drop=CLOCK):
    """``plain(obj)`` with every field named in ``drop`` set to 0."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__, tuple(
            (f.name, 0 if f.name in drop
             else clockless(getattr(obj, f.name), drop))
            for f in dataclasses.fields(obj)))
    if isinstance(obj, (list, tuple)):
        return type(obj)(clockless(x, drop) for x in obj)
    return plain(obj)


def same(scenario, *args, **kwargs):
    """Run ``scenario`` on both packages; returns the reference's result
    once the two agree bit for bit."""
    port = scenario(PORT, *args, **kwargs)
    ref = scenario(REF, *args, **kwargs)
    drop = FORKED if kwargs.get("jobs", 1) > 1 else CLOCK
    assert clockless(port, drop) == clockless(ref, drop)
    return ref


def model(pkg, hf=SMALL, name="tiny"):
    return pkg.core.ir_from_hf_config(hf, name=name)


def cluster(pkg, name):
    """``"h100x4"``-style shorthand for the presets the reference's tests
    build by function."""
    kind, n = name.split("x")
    if kind == "2node":
        return pkg.core.h100_multinode(2, int(n))
    return getattr(pkg.core, f"{kind}_node")(int(n))


# ---------------------------------------------------------------------------
# the fluid surrogate
# ---------------------------------------------------------------------------

TRACES = {
    "chat": ("chat", 2.0, 0, 64),
    "summarization-stationary": ("summarization", 16.0, 3, 48),
    "summarization-piecewise": ("summarization", None, 3, 48),
}


def _trace(pkg, name):
    kind, rate, seed, n = TRACES[name]
    if rate is None:
        rate = pkg.core.PiecewiseRate(starts=(0.0, 2.0), rates=(2.0, 80.0))
    return pkg.core.get_trace(kind, arrival_rate=rate, seed=seed,
                              num_requests=n)


@pytest.mark.parametrize("name", sorted(TRACES))
def test_trace_summary_of_and_of_prefixes(name):
    def scenario(pkg):
        reqs = _trace(pkg, name)
        ts = pkg.core.TraceSummary
        return ts.of(reqs), ts.of_prefixes(reqs, (0.25, 0.5)), \
            ts.of(reqs).nonstationarity, ts.of(reqs[:1])

    summary, prefixes, _, _ = same(scenario)
    assert summary.n == TRACES[name][3]
    assert set(prefixes) == {0.25, 0.5, 1.0}


# light: a small model on 4 H100s under light chat load; heavy: a deeper
# model on 8 under a bursty summarization load (the reference's seeded
# screening points)
LOADS = {
    "light": (SMALL, "h100x4", ("chat", 2.0, 0, 32)),
    "heavy": (MEDIUM, "h100x8", ("summarization", 100.0, 7, 40)),
}


def _fluid_reports(pkg, load, family):
    hf, where, (kind, rate, seed, n) = LOADS[load]
    search = pkg.core.ApexSearch(model(pkg, hf), cluster(pkg, where))
    cands, kv = search.candidates(feasible_only=True,
                                  disaggregated=family == "disagg",
                                  max_disagg_plans=8)
    cands = [c for c in cands if c[0] == family]
    reqs = pkg.core.get_trace(kind, arrival_rate=rate, seed=seed,
                              num_requests=n)
    summary = pkg.core.TraceSummary.of(reqs)
    out = []
    for cand in cands:
        plan, sim = search.make_simulator(cand, kv, fluid=True)
        out.append((plan.label(), sim.simulate(reqs, summary=summary)))
    return out


@pytest.mark.parametrize("family", ["colocated", "disagg"])
@pytest.mark.parametrize("load", sorted(LOADS))
def test_fluid_reports_equal_the_references(load, family):
    reports = same(_fluid_reports, load, family)
    assert len(reports) > 1
    assert all(rep.feasible for _, rep in reports)
    assert {type(rep).__name__ for _, rep in reports} == \
        {"SimulationReport"}


def test_fluid_infeasible_verdicts_equal_the_references():
    """No KV room (a 70B model on one H100) and static batching on a
    disaggregated plan: infeasible on both sides, for the same reasons."""
    def scenario(pkg):
        big = model(pkg, BIG, name="big")
        one = pkg.core.h100_node(1)
        plan = pkg.core.map_scheme(pkg.core.generate_schemes(big, 1)[0], one)
        search = pkg.core.ApexSearch(big, one)
        reqs = pkg.core.get_trace("chat", arrival_rate=2.0, seed=0,
                                  num_requests=8)
        no_room = pkg.fluid.FluidSimulator(
            plan, search.store, search.coll).simulate(reqs)
        search = pkg.core.ApexSearch(model(pkg), pkg.core.h100_node(4))
        cands, kv = search.candidates(feasible_only=True,
                                      disaggregated=True, max_disagg_plans=4)
        dis = next(c for c in cands if c[0] == "disagg")
        _, sim = search.make_simulator(dis, kv, fluid=True)
        static = sim.simulate(reqs, policy=pkg.core.BatchingPolicy(
            mode="static"))
        return no_room, static

    no_room, static = same(scenario)
    assert not no_room.feasible and not static.feasible


# ---------------------------------------------------------------------------
# disaggregated pools
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["blocking", "layerwise"])
def test_kv_transfer_estimates_equal_the_references(mode):
    def scenario(pkg):
        coll = pkg.core.CollectiveModel(pkg.core.h100_multinode(2, 8))
        kv = pkg.disagg.KVTransferModel(coll, mode=mode)
        out = []
        for hf in (SMALL, MEDIUM):
            m = model(pkg, hf)
            for quant in ("fp16", "kv8"):
                for ctx in (1, 1000, 32768):
                    out.append(kv.kv_bytes(m, ctx, quant))
                    for span in (2, 8, 16):
                        for lanes in (1, 2, 8):
                            out.append(kv.estimate(m, ctx, quant, span,
                                                   lanes=lanes))
        return out

    estimates = same(scenario)
    assert len(estimates) == 2 * 2 * 3 * 10


POOLS = {
    "shared-h100x8": ("h100x8", None),
    "shared-2node": ("2nodex8", None),
    "hetero-h100x4-h200x4": ("h100x4", "h200x4"),
    "hetero-h200x2-h100x2": ("h200x2", "h100x2"),
}


def _schemes_and_plans(pkg, pools, hf=SMALL):
    first, second = POOLS[pools]
    m = model(pkg, hf)
    if second is None:
        clu = cluster(pkg, first)
        schemes = pkg.disagg.generate_disagg_schemes(m, clu,
                                                     max_plans=100000)
        plans = [pkg.disagg.map_disagg_scheme(s, clu) for s in schemes]
        spans = [pkg.disagg.cross_pool_span(clu, p)
                 for p in range(1, clu.num_devices)]
    else:
        pre, dec = cluster(pkg, first), cluster(pkg, second)
        schemes = pkg.disagg.generate_disagg_schemes(
            m, prefill_cluster=pre, decode_cluster=dec, max_plans=100000)
        plans = [pkg.disagg.map_disagg_scheme(s, prefill_cluster=pre,
                                              decode_cluster=dec)
                 for s in schemes]
        spans = [pkg.core.cross_pool_link(pre, dec)]
    labels = [s.label() for s in schemes]
    # each pool's first id and its groups' ids within the pool
    ids = [[(pool.device_offset,
             pkg.core.assign_physical_ids(pool.scheme, pool.cluster))
            for pool in (p.prefill_plan, p.decode_plan)] for p in plans]
    mixed = [pkg.disagg.is_mixed_label(p.label()) for p in plans]
    return labels, schemes, plans, ids, mixed, spans


@pytest.mark.parametrize("pools", sorted(POOLS))
def test_disagg_schemes_and_device_ids_equal_the_references(pools):
    labels, schemes, plans, ids, mixed, _ = same(_schemes_and_plans, pools)
    assert len(labels) > 1 and len(set(labels)) == len(labels)
    assert any(mixed) == (POOLS[pools][1] is not None)


def test_disagg_schemes_of_a_model_that_needs_h200_pools():
    """A 96-layer model too big for 2 x H100 pools but not for 2 x H200:
    the per-pool HBM filter admits the same splits on both sides."""
    mid = dict(BIG, num_hidden_layers=96)

    def scenario(pkg):
        m = model(pkg, mid, name="mid")
        return [[s.label() for s in pkg.disagg.generate_disagg_schemes(
                    m, prefill_cluster=cluster(pkg, pre),
                    decode_cluster=cluster(pkg, dec), max_plans=100000)]
                for pre, dec in (("h100x2", "h100x2"), ("h100x2", "h200x2"),
                                 ("h200x2", "h200x2"))]

    h100, mixed, h200 = same(scenario)
    assert not h100 and not mixed and h200


def _disagg_report(pkg, pools, mode, **simulate):
    first, second = POOLS[pools]
    m = model(pkg, SMALL)
    reqs = pkg.core.get_trace("summarization", arrival_rate=2.0, seed=1,
                              num_requests=24)
    if second is None:
        clu = cluster(pkg, first)
        schemes = pkg.disagg.generate_disagg_schemes(
            m, clu, max_plans=100000, transfer_mode=mode)
        scheme = next(s for s in schemes if s.prefill_devices == 8
                      and s.prefill.model_dp == 1 and s.decode.model_dp == 1)
        search = pkg.core.ApexSearch(m, clu)
        sim = pkg.disagg.DisaggSimulator(
            pkg.disagg.map_disagg_scheme(scheme, clu), search.store,
            search.coll)
    else:
        pre, dec = cluster(pkg, first), cluster(pkg, second)
        schemes = pkg.disagg.generate_disagg_schemes(
            m, prefill_cluster=pre, decode_cluster=dec, max_plans=100000,
            transfer_mode=mode)
        scheme = next(s for s in schemes
                      if s.prefill.model_dp == 1 and s.decode.model_dp == 1
                      and s.prefill.pp_stages == 1
                      and s.decode.pp_stages == 1)
        plan = pkg.disagg.map_disagg_scheme(scheme, prefill_cluster=pre,
                                            decode_cluster=dec)
        sim = pkg.disagg.DisaggSimulator(
            plan, pkg.core.ProfileStore(pkg.core.AnalyticBackend(pre)),
            pkg.core.CollectiveModel(pre))
    return sim.simulate(reqs, keep_records=True, **simulate)


@pytest.mark.parametrize("mode", ["blocking", "layerwise"])
@pytest.mark.parametrize("pools", ["shared-2node", "hetero-h100x4-h200x4"])
def test_disagg_reports_equal_the_references(pools, mode):
    rep = same(_disagg_report, pools, mode)
    assert rep.feasible and len(rep.records) == 24


def test_faulted_disagg_report_equals_the_references():
    """A degraded cross-pool link, a slow decode replica and a prefill
    replica down for a while: the resilience accounting the disaggregated
    simulator loads on demand."""
    def scenario(pkg):
        f = pkg.faults
        faults = f.FaultSchedule(
            link_faults=(f.LinkDegradation(start=0.0, end=1e9,
                                           factor=8.0),),
            stragglers=(f.Straggler(replica=0, start=2.0, end=6.0,
                                    slowdown=3.0, pool="decode"),),
            replica_faults=(f.ReplicaFault(replica=0, start=1.0,
                                           repair=3.0, pool="prefill"),))
        return _disagg_report(pkg, "shared-2node", "layerwise",
                              faults=faults)

    rep = same(scenario)
    assert rep.feasible and rep.resilience is not None


class _FreeRefetch:
    """A ``KVTransferModel`` whose full-cache re-fetch costs no wire time
    (the admission handoff is kept): the free re-fetch baseline."""

    def __init__(self, inner):
        self.inner = inner
        self.mode = inner.mode

    def kv_bytes(self, *a, **k):
        return self.inner.kv_bytes(*a, **k)

    def estimate(self, *a, **k):
        return dataclasses.replace(self.inner.estimate(*a, **k),
                                   wire_s=0.0)


def _refetch_reports(pkg, coupled):
    """Two requests that fill a decode pool sized to them: decode growth
    evicts the younger, whose re-admission waits on the re-fetch over a
    slow cross-pool link (the reference's ``test_disagg`` scenario)."""
    m = model(pkg, SMALL)
    pre = pkg.core.h100_node(2)
    schemes = pkg.disagg.generate_disagg_schemes(
        m, prefill_cluster=pre, decode_cluster=pkg.core.h100_node(2),
        max_plans=100000)
    scheme = next(s for s in schemes
                  if s.prefill.model_dp == 1 and s.decode.model_dp == 1
                  and s.prefill.pp_stages == 1 and s.decode.pp_stages == 1)
    ctx = 600
    need = (scheme.decode.weight_bytes_per_device()
            + scheme.decode.state_bytes_per_seq_per_device() * 512
            + (2 * (ctx + 1) + 2)
            * scheme.decode.kv_bytes_per_token_per_device())
    base = pkg.core.h100_node(2)
    dec = dataclasses.replace(
        base, device=dataclasses.replace(base.device, name="H100-tiny",
                                         hbm_bytes=need / 0.85),
        name="h100tiny x2")
    wan = pkg.core.NetworkLevel("wan", 4, 1e9, 1e-4, launch_s=5e-5)
    plan = pkg.disagg.map_disagg_scheme(scheme, prefill_cluster=pre,
                                        decode_cluster=dec, cross_level=wan)
    reqs = [pkg.core.Request(rid=0, arrival=0.0, context_len=ctx,
                             gen_len=50),
            pkg.core.Request(rid=1, arrival=0.0, context_len=ctx,
                             gen_len=400)]
    out = []
    for free in (False, True):
        sim = pkg.disagg.DisaggSimulator(
            plan, pkg.core.ProfileStore(pkg.core.AnalyticBackend(pre)),
            pkg.core.CollectiveModel(pre))
        if free:
            sim.kv = _FreeRefetch(sim.kv)
        extra = {} if coupled else dict(congestion=False,
                                        reprefill_occupancy=False)
        out.append(sim.simulate(reqs, keep_records=True, **extra))
    return out


@pytest.mark.parametrize("coupled", [False, True],
                         ids=["delay", "engine-coupled"])
def test_kv_constrained_refetch_reports_equal_the_references(coupled):
    paid, free = same(_refetch_reports, coupled)
    assert paid.feasible and free.feasible
    if not coupled:
        assert paid.preemptions > 0 and free.preemptions > 0
        assert paid.tpot_p95 > free.tpot_p95


def _joint_search(pkg, menu, **kwargs):
    if menu:
        search = pkg.core.ApexSearch(model(pkg), pkg.core.h100_node(4))
        kwargs["pool_menu"] = [pkg.core.h100_node(2), pkg.core.h200_node(2)]
        reqs = pkg.core.get_trace("chat", arrival_rate=4.0, seed=0,
                                  num_requests=24)
    else:
        search = pkg.core.ApexSearch(model(pkg), pkg.core.h100_node(8))
        reqs = pkg.core.get_trace("chat", arrival_rate=4.0, seed=0,
                                  num_requests=32)
    return search.search(reqs, objective="ttft", feasible_only=True,
                         disaggregated=True, max_disagg_plans=64, **kwargs)


@pytest.mark.parametrize("menu", [False, True], ids=["shared", "pool-menu"])
def test_disaggregated_search_equals_the_references(menu):
    res = same(_joint_search, menu)
    labels = [r.plan_label for r in res.all_reports]
    assert any(lab.startswith("disagg[") for lab in labels)
    assert any(not lab.startswith("disagg[") for lab in labels)
    assert any("#" in lab for lab in labels) == menu


def test_faulted_disaggregated_search_equals_the_references():
    """Ranked by degraded goodput over a seeded ensemble of replica
    faults, colocated and disaggregated plans alike."""
    def scenario(pkg):
        search = pkg.core.ApexSearch(model(pkg), pkg.core.h100_node(8))
        reqs = pkg.core.get_trace("chat", arrival_rate=4.0, seed=0,
                                  num_requests=24)
        return search.search(
            reqs, objective="degraded_goodput", feasible_only=True,
            disaggregated=True, max_disagg_plans=8,
            faults=pkg.core.fault_ensemble(seed=0, n=2, horizon_s=30.0,
                                           n_replicas=8,
                                           replica_mtbf_s=20.0))

    res = same(scenario)
    assert res.best.resilience is not None


# ---------------------------------------------------------------------------
# the multi-fidelity search
# ---------------------------------------------------------------------------

# name: (model, cluster, trace, search options); the reference's screening
# and halving points
MF_POINTS = {
    "light": (SMALL, "h100x4", ("chat", 2.0, 0, 32), {}),
    "heavy-disagg": (MEDIUM, "h100x8", ("summarization", 100.0, 7, 40),
                     dict(disaggregated=True, max_disagg_plans=32)),
    "chat-menu": (SMALL, "h100x8", ("chat", 8.0, 0, 48),
                  dict(disaggregated=True, max_disagg_plans=32,
                       pool_menu=("h100x4", "h200x4"))),
}


def _multifid(pkg, point, objective="latency", **kwargs):
    hf, where, (kind, rate, seed, n), opts = MF_POINTS[point]
    opts = dict(opts)
    if "pool_menu" in opts:
        opts["pool_menu"] = [cluster(pkg, c) for c in opts["pool_menu"]]
    search = pkg.core.ApexSearch(model(pkg, hf), cluster(pkg, where))
    reqs = pkg.core.get_trace(kind, arrival_rate=rate, seed=seed,
                              num_requests=n)
    return pkg.core.MultiFidelitySearch(search).search(
        reqs, objective=objective, feasible_only=True, **opts, **kwargs)


@pytest.mark.parametrize("point, objective, kwargs", [
    ("light", "latency", {}),
    ("light", "throughput", dict(jobs=2)),
    ("heavy-disagg", "latency", {}),
    ("heavy-disagg", "throughput", dict(jobs=2)),
    ("chat-menu", "latency", {}),
    ("chat-menu", "latency", dict(halving=False)),
], ids=["light", "light-jobs2", "heavy-disagg", "heavy-disagg-jobs2",
        "chat-menu", "chat-menu-no-halving"])
def test_multifidelity_search_equals_the_references(point, objective,
                                                    kwargs):
    res = same(_multifid, point, objective, **kwargs)
    assert res.best.feasible
    assert res.num_survivors <= res.num_candidates
    assert bool(res.rungs) == (point != "light"
                               and kwargs.get("halving", True))


def test_forked_multifidelity_search_equals_the_serial_one():
    """``jobs=2`` on the port gives its own serial run's reports, rungs
    and survivors, as the reference's does (the cache counters depend on
    the workers' order)."""
    serial = _multifid(PORT, "heavy-disagg")
    forked = _multifid(PORT, "heavy-disagg", jobs=2)
    assert clockless(forked, FORKED) == clockless(serial, FORKED)


def test_multifidelity_on_a_nonstationary_trace_equals_the_references():
    """The guard refuses a two-level trace by default, with the same
    message; screening at the peak rate and ignoring the guard give the
    reference's results."""
    def scenario(pkg):
        search = pkg.core.ApexSearch(model(pkg), pkg.core.h100_node(8))
        reqs = pkg.core.get_trace(
            "summarization", seed=3, num_requests=48,
            arrival_rate=pkg.core.PiecewiseRate(starts=(0.0, 2.0),
                                                rates=(2.0, 80.0)))
        mf = pkg.core.MultiFidelitySearch(search, frontier_k=4)
        with pytest.raises(ValueError, match="non-stationary") as refused:
            mf.search(reqs, objective="goodput")
        return (str(refused.value),
                mf.search(reqs, objective="goodput", nonstationary="peak"),
                mf.search(reqs, objective="goodput",
                          nonstationary="ignore"))

    _, peak, ignore = same(scenario)
    assert peak.best.feasible and ignore.best.feasible


# ---------------------------------------------------------------------------
# dynamic re-planning
# ---------------------------------------------------------------------------

def _nonstat_trace(pkg, n=60):
    return pkg.core.get_trace(
        "summarization", num_requests=n, seed=3,
        arrival_rate=pkg.core.PiecewiseRate(starts=(0.0, 1.0),
                                            rates=(30.0, 60.0)))


def test_schedules_equal_the_references():
    """``reactive_schedule`` over a burst, ``fault_schedule`` over replica
    faults and ``build_schedules`` over explicit and reactive specs."""
    def scenario(pkg):
        reqs = pkg.core.get_trace(
            "summarization", num_requests=140, seed=3,
            arrival_rate=pkg.core.PiecewiseRate(starts=(0.0, 4.0, 6.0),
                                                rates=(2.0, 60.0, 2.0)))
        horizon = max(r.arrival for r in reqs)
        d, f = pkg.dyn, pkg.faults
        reactive = [d.reactive_schedule(reqs, epoch_s=e, horizon_s=horizon,
                                        lo_plan=0, hi_plan=1, lag=lag,
                                        threshold_rps=thr)
                    for e in (1.0, 2.0) for lag in (1, 2)
                    for thr in (None, 10.0)]
        faults = f.FaultSchedule(replica_faults=(
            f.ReplicaFault(pool="serve", replica=0, start=3.0, repair=5.0),
            f.ReplicaFault(pool="serve", replica=1, start=4.0, repair=7.0)))
        by_fault = d.fault_schedule(faults, horizon_s=10.0, primary=0,
                                    fallback=1)
        explicit = (d.EpochSchedule.static(0),
                    d.EpochSchedule(epochs=((0.0, 0), (1.0, 1))),
                    d.EpochSchedule(epochs=((0.0, 1), (2.0, 1), (4.0, 0))))
        built = [d.build_schedules(spec, reqs, horizon, k=3) for spec in (
            d.DynamicSpec(schedules=explicit),
            d.DynamicSpec(epoch_s=2.0, top_k=3),
            d.DynamicSpec(epoch_s=1.0, schedules=explicit[1:],
                          threshold_rps=20.0, lag=2))]
        return reactive, by_fault, built

    reactive, by_fault, built = same(scenario)
    assert any(s.num_switches for s in reactive)
    assert by_fault.num_switches == 2
    assert len(built[0]) == 2 and len(built[1]) > 1


@pytest.mark.parametrize("switch", [False, True], ids=["static", "switch"])
@pytest.mark.parametrize("mechanism", ["drain", "migrate"])
def test_dynamic_plan_simulator_equals_the_references(mechanism, switch):
    def scenario(pkg):
        search = pkg.core.ApexSearch(model(pkg), pkg.core.h100_node(8))
        cands, kv = search.candidates(quant="fp16")
        d = pkg.dyn
        sched = d.EpochSchedule(epochs=((0.0, 0), (1.0, 3))) if switch \
            else d.EpochSchedule.static(0)
        dyn = d.DynamicPlanSimulator(search, cands, sched, kv_model=kv,
                                     mechanism=mechanism)
        return dyn.simulate(_nonstat_trace(pkg), keep_records=True)

    rep = same(scenario)
    assert len(rep.records) == 60
    assert rep.reconfig.num_switches == int(switch)
    if switch and mechanism == "migrate":
        assert rep.reconfig.switches[0].migrated > 0


@pytest.mark.parametrize("spec", ["empty", "drain", "migrate-reactive"])
def test_dynamic_search_equals_the_references(spec):
    def scenario(pkg):
        d = pkg.dyn
        dynamic = {
            "empty": d.DynamicSpec(),
            "drain": d.DynamicSpec(
                top_k=2, mechanism="drain",
                schedules=(d.EpochSchedule(epochs=((0.0, 0), (1.0, 1))),
                           d.EpochSchedule(epochs=((0.0, 1), (1.0, 0))))),
            "migrate-reactive": d.DynamicSpec(top_k=2, mechanism="migrate",
                                              epoch_s=0.1),
        }[spec]
        search = pkg.core.ApexSearch(model(pkg), pkg.core.h100_node(8))
        return search.search(_nonstat_trace(pkg, 48), objective="goodput",
                             slo_ttft_s=0.5, slo_tpot_s=0.2,
                             dynamic=dynamic)

    res = same(scenario)
    dyn = [r for r in res.all_reports if r.reconfig is not None]
    assert (len(dyn) > 0) == (spec != "empty")


# ---------------------------------------------------------------------------
# what importing the simulator loads
# ---------------------------------------------------------------------------

def test_importing_disagg_loads_no_engine_models_or_kernels():
    code = ("import sys, repro_torch.disagg, repro_torch.core\n"
            "from repro_torch.serving import PoolRouter\n"
            "print(sorted(m for m in sys.modules if m.startswith("
            "('repro_torch.serving.engine', 'repro_torch.models', "
            "'repro_torch.kernels', 'repro_torch.layers'))))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"
    from repro_torch.serving import ServingEngine
    assert ServingEngine.__module__ == "repro_torch.serving.engine"
