"""The simulator folded into the port: ``ModelConfig.to_ir`` against the
JAX package's ``to_ir``, the measured profile backend
(``repro_torch.core.profiles.TorchMeasuredBackend``), Fig. 6
(``repro_torch.launch.fig6``) and the search-then-serve entry point
(``repro_torch.launch.serve``) on the CPU, and the imports of the folded
entry points.  Each side's objects come from its own package: IRs compare
by ``repr`` (class names and every field), predictions by their floats."""

import dataclasses
import math
import os
import re
import subprocess
import sys
from pathlib import Path
from unittest import mock

import pytest

torch = pytest.importorskip("torch")

from repro import configs as RC  # noqa: E402
from repro import core as R  # noqa: E402
from repro.core.energy import PowerModel as RefPowerModel  # noqa: E402

from repro_torch import configs as C  # noqa: E402
from repro_torch.core import AnalyticBackend, h100_node  # noqa: E402
from repro_torch.core.energy import PowerModel  # noqa: E402
from repro_torch.core.profiles import ProfileStore  # noqa: E402
from repro_torch.core.profiles import TorchMeasuredBackend  # noqa: E402
from repro_torch.launch import fig6  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.models.config import EncoderConfig  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
# the entry points the bridge held, and the modules they run on
FOLDED = ("repro_torch.launch.serve", "repro_torch.launch.fig6",
          "repro_torch.core", "repro_torch.core.profiles",
          "repro_torch.core.search", "repro_torch.models.config",
          "repro_torch.serving.router")


def reference_predictions(model, reqs, caps, x_max=None):
    """``fig6.predictions`` run on the JAX package's simulator (its
    search, plan, request and policy classes and its analytic backend):
    one implementation of the experiment, priced by either package."""
    with mock.patch.multiple(fig6, ApexSearch=R.ApexSearch,
                             BatchingPolicy=R.BatchingPolicy,
                             Request=R.Request, h100_node=R.h100_node,
                             heuristic_scheme=R.heuristic_scheme):
        return fig6.predictions(model, R.AnalyticBackend(R.h100_node(1)),
                                reqs, caps, x_max)


@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("name", sorted(C.ALIASES))
def test_model_ir_equals_the_jax_packages_to_ir(name, size):
    port = (C.get_config if size == "full" else C.get_reduced)(name)
    ref = (RC.get_config if size == "full" else RC.get_reduced)(name)
    assert repr(port.to_ir()) == repr(ref.to_ir())


@pytest.mark.parametrize("change", [
    dict(ffn_kind="moe", n_routed=8, top_k=2, d_ff_expert=64),
    dict(ffn_kind="moe", n_routed=4, top_k=1, d_ff_expert=32, n_shared=1,
         ffn_gated=False)])
def test_model_ir_takes_a_moe_ffn(change):
    """A dense config given a MoE FFN: the IR has a MoE cell where the
    MLP cell was, as the JAX package's ``to_ir`` gives it."""
    port = dataclasses.replace(C.get_reduced("qwen2-0.5b"), **change)
    ref = dataclasses.replace(RC.get_reduced("qwen2-0.5b"), **change)
    ir = port.to_ir()
    assert repr(ir) == repr(ref.to_ir())
    assert [type(c).__name__ for c in ir.block.cells] == ["AttentionCell",
                                                          "MoECell"]


@pytest.mark.parametrize("change", [dict(attn_kind="linear"),
                                    dict(ffn_kind="conv")])
def test_model_ir_raises_for_families_without_a_port_config(change):
    cfg = dataclasses.replace(C.get_reduced("qwen2-0.5b"), **change)
    with pytest.raises(NotImplementedError, match="dense GQA"):
        cfg.to_ir()


@pytest.mark.parametrize("base", ["zamba2-7b", "qwen2-0.5b"])
def test_model_ir_takes_the_shared_block(base):
    """A shared attention block, refused before the zamba2 slice: its
    attention and MLP cells follow the block's own, as the JAX package's
    ``to_ir`` gives them (over SSM layers, and over a dense decoder)."""
    port = dataclasses.replace(C.get_reduced(base), shared_attn=True)
    ref = dataclasses.replace(RC.get_reduced(base), shared_attn=True)
    ir = port.to_ir()
    assert repr(ir) == repr(ref.to_ir())
    assert [c.name for c in ir.block.cells][-2:] == ["shared_attn",
                                                     "shared_mlp"]


@pytest.mark.parametrize("change", [
    dict(encoder=EncoderConfig(n_layers=1, d_model=56, n_heads=7, d_ff=64)),
    dict(cross_attn=True)])
def test_model_ir_takes_an_encoder_and_cross_attention(change):
    """An encoder block and cross-attention cells, refused before the
    seamless slice: the IR equals the JAX package's ``to_ir``."""
    port = dataclasses.replace(C.get_reduced("qwen2-0.5b"), **change)
    ref = dataclasses.replace(RC.get_reduced("qwen2-0.5b"), **change)
    assert repr(port.to_ir()) == repr(ref.to_ir())


def test_measured_backends_share_one_profiling_pass():
    wall = TorchMeasuredBackend("wall", device="cpu", repeats=1)
    device = wall.sibling("device")
    power = PowerModel(h100_node(1).device)
    t_wall, e_wall = wall.measure("gemm", (24, 16, "bf16"), 8.0)
    calls = sum(wall.timer.calls.values())
    t_dev, e_dev = device.measure("gemm", (24, 16, "bf16"), 8.0)
    assert sum(wall.timer.calls.values()) == calls      # no second timing
    assert (t_wall, t_dev) == wall.samples[("gemm", (24, 16, "bf16"), 8.0)]
    assert e_wall == power.energy(t_wall, 0.7)
    assert e_dev == power.energy(t_dev, 0.7)
    ref_power = RefPowerModel(R.h100_node(1).device)
    assert (e_wall, e_dev) == (ref_power.energy(t_wall, 0.7),
                               ref_power.energy(t_dev, 0.7))
    with pytest.raises(ValueError, match="clock"):
        TorchMeasuredBackend("cpu_time", device="cpu")


def test_measured_tables_interpolate_through_the_simulators_store():
    store = ProfileStore(TorchMeasuredBackend("device", device="cpu",
                                              repeats=1), x_max=64)
    t = store.time("attn_decode", (1, 8, "bf16"), 48.0)
    t32, t64 = (store.time("attn_decode", (1, 8, "bf16"), x)
                for x in (32.0, 64.0))
    assert math.isfinite(t) and min(t32, t64) <= t <= max(t32, t64)
    assert store.misses == 1


def test_fig6_reduced_on_the_cpu_ends_with_finite_errors():
    lines = []
    out = fig6.run("reduced", device="cpu", caps=(1, 2), x_max=64,
                   log=lines.append)
    assert [r["cap"] for r in out["rows"]] == [1, 2]
    for r in out["rows"]:
        assert r["actual_s"] > 0 and r["engine_steps"] > r["cap"]
        for name in fig6.BACKENDS:
            assert r[f"{name}_s"] > 0
            assert math.isfinite(r[f"{name}_ratio"])
            assert math.isfinite(r[f"{name}_err"])
    last = out["rows"][-1]
    assert last["actual_ratio"] == 1.0
    assert all(last[f"{n}_err"] == 0.0 for n in fig6.BACKENDS)
    assert set(out["mean_err"]) == set(fig6.BACKENDS)
    assert all(math.isfinite(v) for v in out["mean_err"].values())
    for metric in ("ttft_mean", "tpot_mean"):
        assert set(out["latency"][metric]) == {1, 2}
    assert out["op_table"] and out["card"] == "cpu"
    assert any("mean relative error" in s for s in lines)
    assert any(s.startswith("fig6 TTFT") for s in lines)


def test_fig6_analytic_prediction_equals_the_jax_packages_ir():
    """The slice as a whole: the analytic predictions fig6 makes from the
    port's config on the port's simulator are the JAX package's simulator's
    on its own IR."""
    cfg = C.get_reduced("qwen2-0.5b")
    reqs = fig6.make_requests(cfg.vocab_size, 6, 12, 8, seed=0)
    port = fig6.predictions(cfg.to_ir(), AnalyticBackend(h100_node(1)),
                            reqs, (1, 4), None)
    ref = reference_predictions(RC.get_reduced("qwen2-0.5b").to_ir(), reqs,
                                (1, 4))
    for cap in (1, 4):
        assert port[cap].e2e_latency == ref[cap].e2e_latency
        assert port[cap].ttft_mean == ref[cap].ttft_mean


def test_serve_runs_the_search_then_the_engine_on_the_cpu():
    lines = []
    base, best, report, reqs = port_serve.plan_and_serve(
        size="reduced", requests=3, device="cpu", log=lines.append)
    assert lines[0].startswith("APEX: baseline")
    assert lines[1].startswith("APEX: optimal")
    assert lines[2].startswith("engine [qwen2-0.5b-reduced")
    assert best.best.e2e_latency <= base.e2e_latency
    assert len(report.results) == len(reqs) == 3


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "mixtral-8x7b",
                                  "gemma3-12b"])
def test_serve_runs_the_ssm_and_moe_archs_on_the_cpu(arch):
    """The engine serves every port config, SSM, MoE and gemma3's blocks
    of mixed windows included: the search on the FULL arch, then the
    engine at REDUCED size."""
    lines = []
    _, _, report, _ = port_serve.plan_and_serve(
        arch=arch, size="reduced", requests=3, device="cpu",
        log=lines.append)
    assert lines[2].startswith(f"engine [{C.get_reduced(arch).name}")
    assert sorted(r.rid for r in report.results) == [0, 1, 2]


def test_serve_passes_depth_to_the_engine(monkeypatch):
    """``depth`` reaches the port's entry point, which cuts the model to
    that many blocks (mixtral FULL fits one card at 16 of 32)."""
    seen = {}

    def engine(*args, **kwargs):
        seen.update(kwargs)
        return None, []

    monkeypatch.setattr(port_serve, "serve", engine)
    port_serve.plan_and_serve(arch="mixtral-8x7b", size="reduced",
                              requests=2, device="cpu", log=lambda s: None,
                              depth=1)
    assert seen["depth"] == 1


def test_serve_raises_for_an_arch_without_a_port_config():
    """Every arch of the JAX registry has a port config since the zamba2
    slice: a name neither package has."""
    assert sorted(RC.ALIASES) == sorted(C.ALIASES)
    assert "mamba3-1b" not in RC.ALIASES
    with pytest.raises(KeyError, match="not yet ported"):
        port_serve.plan_and_serve(arch="mamba3-1b", size="reduced",
                                  device="cpu", log=lambda s: None)


def test_serve_main_plans_then_serves(monkeypatch):
    """``python -m repro_torch.launch.serve`` runs the search for the named
    cluster and then the engine with the command line's engine options."""
    seen = {}

    def plan(arch, trace, cluster, log):
        seen["plan"] = (arch, trace, cluster)
        return "base", "best"

    def engine(*args, **kwargs):
        seen["engine"] = (args, kwargs)
        return None, []

    monkeypatch.setattr(port_serve, "plan", plan)
    monkeypatch.setattr(port_serve, "serve", engine)
    port_serve.main(["--arch", "mixtral-8x7b", "--cluster", "h200x8",
                     "--size", "reduced", "--device", "cpu", "--depth", "1",
                     "--max-batch", "2", "--gen-cap", "5"])
    assert seen["plan"] == ("mixtral-8x7b", "chat", "h200x8")
    args, kwargs = seen["engine"]
    assert args == ("mixtral-8x7b", "reduced", "chat", 8)
    assert (kwargs["depth"], kwargs["max_batch"], kwargs["gen_cap"]) == \
        (1, 2, 5)


def test_folded_entry_points_load_no_jax_and_no_repro():
    code = (
        "import importlib, sys\n"
        f"for m in {FOLDED!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'apex_bridge'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_the_bridge_is_gone_and_nothing_imports_it():
    assert not (REPO / "src" / "apex_bridge").exists()
    bridge = re.compile(r"^\s*(import|from)\s+apex_bridge\b", re.M)
    files = sorted((REPO / "src").rglob("*.py")) + sorted(
        (REPO / "tests").glob("*.py")) + [REPO / "chip_smoke.py"]
    for f in files:
        assert not bridge.search(f.read_text()), f
