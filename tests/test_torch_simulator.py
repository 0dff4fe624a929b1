"""The port's copy of APEX's planner and simulator (``repro_torch.core``,
``repro_torch.serving.router``) against the live reference (``repro.core``,
``repro.serving.router``) on one interpreter, with tolerance 0: the IR of
every config, the cluster presets, the planner's schemes and the mapper's
device ids, the traces, the simulator's reports under each batching and
preemption policy, the plan search and the routers' splits.  Each side is
built from its own package (a port object fails the reference's
``isinstance`` checks), and ``plain`` turns both into builtins: floats
compare with ``==``, a NaN only with a NaN.  The fluid, disaggregated,
multi-fidelity and dynamic modes are ``test_torch_simulator_modes.py``'s."""

import dataclasses
import math
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro import configs as RC  # noqa: E402
from repro import core as R  # noqa: E402
from repro.core import cluster as RCL  # noqa: E402
from repro.serving import router as RR  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch import core as P  # noqa: E402
from repro_torch.core import cluster as PCL  # noqa: E402
from repro_torch.data.requests import make_serving_requests  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.serving import router as PR  # noqa: E402

CORE = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "core"
# the simulator's modules the port copies; profiles.py holds the profiler
# too, which runs on the card
COPIED = ("quant", "cluster", "collectives", "energy", "ir", "templates",
          "planner", "mapper", "trace", "metrics", "faults", "batching",
          "engine", "simulator", "search", "fluid", "multifid", "dynamic")
DISAGG = ("__init__", "kv_transfer", "pools", "simulate")
SCHEME_ARCHS = ("qwen2-0.5b", "mixtral-8x7b", "deepseek-v2-lite-16b")
# device memory a little above each FULL arch's heuristic plan on 8 H100s
# (weights alone): the 64 requests overflow the KV cache and preempt, so
# swap and sacrifice both run (mamba2 holds no KV cache, and never does)
SIM_HBM = {"qwen2-0.5b": 0.186e9, "mixtral-8x7b": 13.76e9,
           "deepseek-v2-lite-16b": 4.85e9, "mamba2-2.7b": 80e9,
           "zamba2-7b": 13.77e9}
POLICIES = {"continuous": {}, "static": dict(mode="static"),
            "chunked": dict(chunked_prefill=512)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The router's engines run tiny ops: one intra-op thread keeps them
    fast when several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def plain(obj):
    """``obj`` as builtins, for comparing two packages' objects: a
    dataclass (or another object of either package) as its class name and
    fields, a NaN as a marker that equals only itself."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__, tuple(
            (f.name, plain(getattr(obj, f.name)))
            for f in dataclasses.fields(obj)))
    if isinstance(obj, float):
        return ("nan",) if math.isnan(obj) else obj
    if isinstance(obj, dict):
        return {plain(k): plain(v) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return tuple(plain(x) for x in obj)
    if isinstance(obj, list):
        return [plain(x) for x in obj]
    if type(obj).__module__.split(".")[0] in ("repro", "repro_torch"):
        return (type(obj).__name__, plain(vars(obj)))
    return obj


def test_plain_tells_nan_and_classes_apart():
    assert plain([math.nan]) == plain([math.nan]) != plain([0.0])
    assert plain(math.inf) == plain(math.inf)
    a = P.AttentionCell(name="a", d_model=8, n_heads=2, n_kv_heads=2,
                        head_dim=4)
    b = R.AttentionCell(name="a", d_model=8, n_heads=2, n_kv_heads=2,
                        head_dim=4)
    assert plain(a) == plain(b) and a != b        # two packages' classes
    assert plain(a) != plain(dataclasses.replace(a, head_dim=8))


def test_copied_modules_import_no_torch_and_nothing_of_repro():
    bad = re.compile(r"^\s*(import|from)\s+(torch|jax|repro)\b(?!_)", re.M)
    for name in COPIED:
        assert not bad.search((CORE / f"{name}.py").read_text()), name
    for name in DISAGG:
        path = CORE.parent / "disagg" / f"{name}.py"
        assert not bad.search(path.read_text()), path.name
    router = CORE.parent / "serving" / "router.py"
    assert not bad.search(router.read_text())


@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("arch", sorted(C.ALIASES))
def test_to_ir_equals_the_references(arch, size):
    port = (C.get_config if size == "full" else C.get_reduced)(arch).to_ir()
    ref = (RC.get_config if size == "full" else RC.get_reduced)(arch).to_ir()
    assert isinstance(port, P.ModelIR) and not isinstance(port, R.ModelIR)
    assert plain(port) == plain(ref)
    for q in ("fp16", "bf16", "w8a8"):
        pq, rq = P.get_format(q), R.get_format(q)
        for what in ("weight_bytes", "kv_bytes_per_token",
                     "state_bytes_per_seq"):
            assert getattr(port, what)(pq) == getattr(ref, what)(rq), what


@pytest.mark.parametrize("name", sorted(R.CLUSTER_PRESETS))
def test_cluster_presets_equal_the_references(name):
    assert sorted(P.CLUSTER_PRESETS) == sorted(R.CLUSTER_PRESETS)
    port, ref = P.get_cluster(name), R.get_cluster(name)
    assert plain(port) == plain(ref)
    for kind in ("all_reduce", "all_gather", "all_to_all"):
        for group in sorted({1, min(2, port.num_devices),
                             port.num_devices}):
            assert P.CollectiveModel(port).query(kind, 1e6, group) == \
                R.CollectiveModel(ref).query(kind, 1e6, group)


def _schemes(pkg, cfgs, arch):
    return pkg.generate_schemes(cfgs.get_config(arch).to_ir(), 8)


@pytest.mark.parametrize("arch", SCHEME_ARCHS)
def test_generate_schemes_labels_in_order(arch):
    port, ref = _schemes(P, C, arch), _schemes(R, RC, arch)
    assert len(port) > 1
    assert [s.label() for s in port] == [s.label() for s in ref]
    assert plain(port) == plain(ref)


@pytest.mark.parametrize("cluster", ["h100x8", "h100x16-2node"])
@pytest.mark.parametrize("arch", SCHEME_ARCHS)
def test_map_scheme_gives_the_references_device_ids(arch, cluster):
    pc, rc = P.get_cluster(cluster), R.get_cluster(cluster)
    port = P.generate_schemes(C.get_config(arch).to_ir(), pc.num_devices)
    ref = R.generate_schemes(RC.get_config(arch).to_ir(), rc.num_devices)
    assert len(port) == len(ref) > 1
    for ps, rs in zip(port, ref):
        assert plain(P.map_scheme(ps, pc)) == plain(R.map_scheme(rs, rc))
        assert P.assign_physical_ids(ps, pc) == \
            R.assign_physical_ids(rs, rc)


@pytest.mark.parametrize("name", sorted(R.TRACE_SPECS))
def test_get_trace_equals_the_references(name):
    assert sorted(P.TRACE_SPECS) == sorted(R.TRACE_SPECS)
    for rate, n, seed in ((0.5, 64, 0), (20.0, 200, 3)):
        port = P.get_trace(name, arrival_rate=rate, num_requests=n,
                           seed=seed)
        ref = R.get_trace(name, arrival_rate=rate, num_requests=n,
                          seed=seed)
        assert len(port) == n and plain(port) == plain(ref)
    assert plain(P.trace_stats(port)) == plain(R.trace_stats(ref))


def _simulate(pkg, cluster_mod, cfgs, arch, policy, preemption):
    model = cfgs.get_config(arch).to_ir()
    device = dataclasses.replace(cluster_mod.H100, hbm_bytes=SIM_HBM[arch])
    clu = dataclasses.replace(pkg.h100_node(8), device=device)
    search = pkg.ApexSearch(model, clu)
    plan = pkg.map_scheme(pkg.heuristic_scheme(model, 8, cluster=clu), clu)
    sim = pkg.PlanSimulator(plan, search.store, search.coll)
    reqs = pkg.get_trace("chat", arrival_rate=20.0, num_requests=64)
    return sim.simulate(reqs, policy=pkg.BatchingPolicy(**POLICIES[policy]),
                        keep_records=True, preemption=preemption)


@pytest.mark.parametrize("preemption", ["swap", "sacrifice"])
@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("arch", sorted(SIM_HBM))
def test_simulate_reports_equal_the_references(arch, policy, preemption):
    port = _simulate(P, PCL, C, arch, policy, preemption)
    ref = _simulate(R, RCL, RC, arch, policy, preemption)
    assert ref.feasible and len(ref.records) == 64
    if policy != "static" and arch != "mamba2-2.7b":
        assert ref.preemptions > 0
        if preemption == "swap":
            assert ref.swap_outs > 0
    assert plain(port) == plain(ref)


def _search(pkg, cfgs, arch, **kwargs):
    search = pkg.ApexSearch(cfgs.get_config(arch).to_ir(),
                            pkg.get_cluster("h100x8"))
    reqs = pkg.get_trace("chat", arrival_rate=0.5, num_requests=64)
    if "faults" in kwargs:
        kwargs["faults"] = pkg.fault_ensemble(**kwargs["faults"])
    return search.evaluate_baseline(reqs), search.search(reqs, **kwargs)


@pytest.mark.parametrize("arch, kwargs", [
    ("qwen2-0.5b", {}),
    ("mixtral-8x7b", dict(feasible_only=True)),
    ("deepseek-v2-lite-16b", dict(feasible_only=True, objective="goodput")),
    # a seeded ensemble of replica faults, ranked by degraded goodput
    ("qwen2-0.5b", dict(feasible_only=True, objective="degraded_goodput",
                        faults=dict(seed=0, n=2, horizon_s=120.0,
                                    n_replicas=8, replica_mtbf_s=60.0))),
], ids=["qwen2-full", "mixtral-feasible", "deepseek-goodput",
        "qwen2-faults"])
def test_search_equals_the_references(arch, kwargs):
    port_base, port = _search(P, C, arch, **dict(kwargs))
    ref_base, ref = _search(R, RC, arch, **dict(kwargs))
    assert plain(port_base) == plain(ref_base)
    assert ref.num_schemes == len(ref.all_reports) > 1
    assert plain(port.all_reports) == plain(ref.all_reports)
    assert plain(port.best) == plain(ref.best)
    assert plain(port.best_plan) == plain(ref.best_plan)
    for field in ("num_schemes", "num_feasible", "objective", "cache_hits",
                  "cache_misses"):
        assert getattr(port, field) == getattr(ref, field), field
    if "faults" in kwargs:
        assert ref.best.resilience is not None


def _router_requests():
    return make_serving_requests("chat", 5.0, 64, 1000, seed=0, max_len=64)


def test_replica_router_split_equals_the_references():
    for reqs in (_router_requests(),
                 P.get_trace("chat", arrival_rate=5.0, num_requests=64)):
        ref_reqs = reqs if isinstance(reqs[0], dict) else R.get_trace(
            "chat", arrival_rate=5.0, num_requests=64)
        for n, rate in ((1, 512.0), (3, 512.0), (4, 50.0)):
            port = PR.ReplicaRouter([None] * n, drain_rate=rate).split(reqs)
            ref = RR.ReplicaRouter([None] * n,
                                   drain_rate=rate).split(ref_reqs)
            assert [[_rid(r) for r in b] for b in port] == \
                [[_rid(r) for r in b] for b in ref]
            assert sum(map(len, port)) == 64


def _rid(r):
    return r["rid"] if isinstance(r, dict) else r.rid


def test_pool_router_split_equals_the_references():
    reqs = _router_requests()
    for pre, dec in ((1, 1), (2, 3), (3, 2)):
        port = PR.PoolRouter(pre, dec).split(reqs)
        ref = RR.PoolRouter(pre, dec).split(reqs)
        assert [[[_rid(r) for r in b] for b in pool] for pool in port] == \
            [[[_rid(r) for r in b] for b in pool] for pool in ref]
    assert PR.derive_drain_rate(64.0, 0.5, 1.0) == \
        RR.derive_drain_rate(64.0, 0.5, 1.0)
    with pytest.raises(ValueError):
        PR.PoolRouter(0, 1)


def test_replica_router_runs_two_port_engines_on_the_cpu():
    """Each engine serves the requests the reference's router assigns its
    replica, every one to its full length."""
    cfg = C.get_reduced("qwen2-0.5b")
    params = T.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    engines = [ServingEngine(cfg, params, max_batch=2, max_len=64,
                             device="cpu") for _ in range(2)]
    # arrivals a millisecond apart: the backlog does not drain between
    # them, so both replicas get requests
    reqs = make_serving_requests("chat", 1000.0, 6, cfg.vocab_size, seed=0,
                                 max_len=12)
    for r in reqs:
        r["gen_len"] = min(r["gen_len"], 4)
    reports = PR.ReplicaRouter(engines).run(reqs, time_scale=0.0)
    want = RR.ReplicaRouter([None, None]).split(reqs)
    assert all(want)
    assert [sorted(res.rid for res in rep.results) for rep in reports] == \
        [sorted(r["rid"] for r in bucket) for bucket in want]
    by_rid = {r["rid"]: r for r in reqs}
    for rep in reports:
        for res in rep.results:
            assert len(res.tokens) == max(by_rid[res.rid]["gen_len"], 2)
