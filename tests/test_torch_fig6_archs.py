"""Fig. 6 for every arch the port's engine serves (``repro_torch.launch.fig6
--arch/--depth``), on the CPU: the port's simulator prices the cut the
engine serves as the JAX package's simulator prices its IR of that cut;
every engine arch runs end to end with its departure lines and the step
breakdown; the smoke's profile tables are the port's simulator's."""

import dataclasses
import importlib.util
import math
from pathlib import Path
from unittest import mock

import pytest

torch = pytest.importorskip("torch")

from repro import configs as RC  # noqa: E402
from repro import core as R  # noqa: E402

from repro_torch import configs as C  # noqa: E402
from repro_torch.core import AnalyticBackend, h100_node  # noqa: E402
from repro_torch.core.profiles import ProfileBackend  # noqa: E402
from repro_torch.core.profiles import TorchMeasuredBackend  # noqa: E402
from repro_torch.launch import fig6  # noqa: E402

ENGINE_ARCHS = ["internlm2-1.8b", "qwen1.5-32b", "mixtral-8x7b",
                "gemma3-12b", "deepseek-v2-lite-16b", "mamba2-2.7b",
                "zamba2-7b"]
STUB_ARCHS = ["qwen2-vl-7b", "seamless-m4t-large-v2"]
# the departure lines each arch prints beside "prefill" and "weights"
DEPARTURES = {
    "mixtral-8x7b": {"expert products"},
    "deepseek-v2-lite-16b": {"dense prefix", "MLA decode",
                             "expert products"},
    "mamba2-2.7b": {"SSM decode", "SSD head dim", "SSM state reserve"},
    "zamba2-7b": {"SSM decode", "SSD head dim", "SSM state reserve",
                  "shared block"},
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The engine and the profiler run tiny ops here: one intra-op thread
    keeps them fast when several test workers share the cores (six
    workers at torch's default threads ran this file 20x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_predictions(model, reqs, caps):
    """``fig6.predictions`` run on the JAX package's simulator (its search,
    plan, request and policy classes and its analytic backend)."""
    with mock.patch.multiple(fig6, ApexSearch=R.ApexSearch,
                             BatchingPolicy=R.BatchingPolicy,
                             Request=R.Request, h100_node=R.h100_node,
                             heuristic_scheme=R.heuristic_scheme):
        return fig6.predictions(model, R.AnalyticBackend(R.h100_node(1)),
                                reqs, caps, None)


class Recording(ProfileBackend):
    """The analytic backend, keeping the ``(op, axes)`` of each sample."""

    def __init__(self):
        self.inner = AnalyticBackend(h100_node(1))
        self.keys = set()

    def measure(self, op, axes, x):
        self.keys.add((op, tuple(axes)))
        return self.inner.measure(op, axes, x)


@pytest.mark.parametrize("cut", [False, True])
@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_analytic_predictions_equal_the_jax_packages_ir_of_the_cut(arch,
                                                                   cut):
    base = C.get_reduced(arch)
    depth = base.block_repeat - 1 if cut else base.block_repeat
    cfg = C.at_depth(base, depth)
    reqs = fig6.make_requests(cfg.vocab_size, 6, 12, 8, seed=0)
    port = fig6.predictions(cfg.to_ir(), AnalyticBackend(h100_node(1)),
                            reqs, (1, 4), None)
    ref_ir = dataclasses.replace(RC.get_reduced(arch),
                                 block_repeat=depth).to_ir()
    ref = reference_predictions(ref_ir, reqs, (1, 4))
    assert cfg.to_ir().block.repeat == depth
    for cap in (1, 4):
        assert port[cap].e2e_latency == ref[cap].e2e_latency
        assert port[cap].ttft_mean == ref[cap].ttft_mean


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_fig6_runs_each_engine_arch_on_the_cpu(arch):
    lines = []
    out = fig6.run(arch=arch, size="reduced", device="cpu", caps=(1, 2),
                   x_max=64, log=lines.append)
    assert out["arch"] == arch and out["card"] == "cpu"
    assert [r["cap"] for r in out["rows"]] == [1, 2]
    for r in out["rows"]:
        assert r["engine_steps"] > r["engine_iterations"] > 0
        assert all(math.isfinite(r[f"{n}_err"]) for n in fig6.BACKENDS)
    assert all(math.isfinite(v) for v in out["mean_err"].values())
    kinds = {s[len("fig6 departure "):].split(":")[0] for s in lines
             if s.startswith("fig6 departure ")}
    assert kinds == {"prefill", "weights"} | DEPARTURES.get(arch, set())
    assert len(out["departures"]) == len(kinds)
    step = [s for s in lines if s.startswith("fig6 step [cap 2, context")]
    assert len(step) == 1 and "simulator (ms)" in step[0]
    sim = out["step"]["simulator"]
    for name in fig6.BACKENDS:
        parts = sim[name]
        assert parts["total"] > 0 and abs(parts["rest"]) <= \
            1e-9 * parts["total"]
        if C.get_reduced(arch).ffn_kind == "moe":
            assert 0 < parts["moe gemm"] < parts["gemm"]
    engine = out["step"]["engine"]
    assert engine["wall_ms"] > 0 and engine["device"] is None
    assert out["samples"] > 0 and out["op_table"]


@pytest.mark.parametrize("arch", STUB_ARCHS)
def test_stub_frontend_archs_raise_before_an_engine_run(arch, monkeypatch):
    def never(*args, **kwargs):
        raise AssertionError("engine run")

    monkeypatch.setattr(fig6, "engine_runs", never)
    with pytest.raises(ValueError, match="stubbed frontend"):
        fig6.run(arch=arch, size="reduced", device="cpu")


def test_main_passes_arch_and_depth_to_run(monkeypatch):
    seen = {}

    def run(*args, **kwargs):
        seen.update(args=args, **kwargs)

    monkeypatch.setattr(fig6, "run", run)
    fig6.main(["--arch", "mixtral-8x7b", "--depth", "16", "--size", "full",
               "--device", "cpu"])
    assert seen["arch"] == "mixtral-8x7b" and seen["depth"] == 16
    assert seen["args"][:2] == ("full", "cpu")
    fig6.main(["--size", "reduced"])
    assert seen["arch"] == fig6.ARCH and seen["depth"] is None


def test_each_engine_arch_has_a_full_case_that_fits_its_engine():
    assert set(fig6.FULL_CASES) == {"qwen2-0.5b", *ENGINE_ARCHS}
    for arch in fig6.FULL_CASES:
        case = fig6.case_of(arch, "full")
        assert case["ctx"] + case["gen"] < case["max_len"]
        assert list(case["caps"]) == sorted(case["caps"])
    assert fig6.case_of("mixtral-8x7b", "full")["depth"] == 16
    assert fig6.case_of("mixtral-8x7b", "reduced")["depth"] is None
    with pytest.raises(ValueError):
        fig6.case_of("qwen2-0.5b", "tiny")


def test_check_samples_holds_each_sample_to_its_bound():
    measured = TorchMeasuredBackend("wall", device="cpu", repeats=1)
    measured.samples[("gemm", (896, 896, "bf16"), 4096.0)] = (1.0, 1.0)
    assert fig6.check_samples(measured, cuda=True) == 1
    measured.samples[("gemm", (896, 896, "bf16"), 4096.0)] = (1.0, 1e-9)
    assert fig6.check_samples(measured, cuda=False) == 1
    with pytest.raises(RuntimeError, match="below"):
        fig6.check_samples(measured, cuda=True)
    measured.samples[("gemm", (896, 896, "bf16"), 4096.0)] = (1.0,
                                                              math.nan)
    with pytest.raises(RuntimeError, match="not finite"):
        fig6.check_samples(measured, cuda=False)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", *ENGINE_ARCHS])
def test_smoke_arch_tables_are_the_simulators_for_each_full_arch(arch):
    """The smoke's tables are those the port's simulator queries for the
    FULL arch's Fig. 6 run and its step breakdown."""
    smoke = _smoke()
    cfg = C.at_depth(C.get_config(arch), fig6.case_of(arch, "full")["depth"])
    model = cfg.to_ir()
    rec = Recording()
    reqs = fig6.make_requests(cfg.vocab_size, 4, 64, 16, seed=0)
    fig6.predictions(model, rec, reqs, (1, 4), None)
    fig6.simulated_step(model, rec, 4, 72, None)
    assert set(smoke.arch_tables(cfg)) == rec.keys
    assert len(smoke.arch_tables(cfg)) == len(rec.keys)


def test_smoke_profile_covers_every_engine_arch_once():
    smoke = _smoke()
    assert set(smoke.PROFILE_ARCHS) == set(ENGINE_ARCHS)
    old = {(op, axes) for op, axes, _ in smoke.profile_keys(
        C.get_config("qwen2-0.5b"), C.get_config("mamba2-2.7b"), [1])}
    assert set(smoke.arch_tables(C.get_config("qwen2-0.5b"))) <= old
    every = {k for a in ENGINE_ARCHS
             for k in smoke.arch_tables(C.get_config(a))}
    largest = {"attn_decode": (40, 128), "attn_prefill": (40, 128),
               "ssd_scan": (7168, 64)}
    for op, axes in largest.items():
        assert (op, (*axes, "bf16")) in every - old
    b, hq, hkv, d, smax = smoke.PROFILE_ARCHS_DECODE
    assert (b, hq, hkv, d, smax) == (1, 40, 40, 128, 4096)
    b, s, h, p, n, chunk = smoke.PROFILE_ARCHS_SSD
    assert (h * p, n, s) == (7168, 64, 4096)
