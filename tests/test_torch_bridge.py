"""``apex_bridge``, where the simulator (``repro.core``) meets the port
(``repro_torch``): the IR of the port's configs against the JAX package's
``to_ir``, the measured profile backend, Fig. 6 and the serving entry
point on the CPU, and the bridge's imports."""

import dataclasses
import math
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro import configs as RC  # noqa: E402
from repro.core import AnalyticBackend, h100_node  # noqa: E402
from repro.core.energy import PowerModel  # noqa: E402
from repro.core.profiles import ProfileStore  # noqa: E402

import apex_bridge  # noqa: E402
from apex_bridge import fig6, serve  # noqa: E402
from apex_bridge.ir import model_ir  # noqa: E402
from apex_bridge.profiles import TorchMeasuredBackend  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch.models.config import EncoderConfig  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("name", sorted(C.ALIASES))
def test_model_ir_equals_the_jax_packages_to_ir(name, size):
    port = (C.get_config if size == "full" else C.get_reduced)(name)
    ref = (RC.get_config if size == "full" else RC.get_reduced)(name)
    assert model_ir(port) == ref.to_ir()


@pytest.mark.parametrize("change", [
    dict(ffn_kind="moe", n_routed=8, top_k=2, d_ff_expert=64),
    dict(ffn_kind="moe", n_routed=4, top_k=1, d_ff_expert=32, n_shared=1,
         ffn_gated=False)])
def test_model_ir_takes_a_moe_ffn(change):
    """A dense config given a MoE FFN: the IR has a MoE cell where the
    MLP cell was, as the JAX package's ``to_ir`` gives it."""
    port = dataclasses.replace(C.get_reduced("qwen2-0.5b"), **change)
    ref = dataclasses.replace(RC.get_reduced("qwen2-0.5b"), **change)
    ir = model_ir(port)
    assert ir == ref.to_ir()
    assert [type(c).__name__ for c in ir.block.cells] == ["AttentionCell",
                                                          "MoECell"]


@pytest.mark.parametrize("change", [dict(attn_kind="linear"),
                                    dict(ffn_kind="conv")])
def test_model_ir_raises_for_families_without_a_port_config(change):
    cfg = dataclasses.replace(C.get_reduced("qwen2-0.5b"), **change)
    with pytest.raises(NotImplementedError, match="dense GQA"):
        model_ir(cfg)


@pytest.mark.parametrize("base", ["zamba2-7b", "qwen2-0.5b"])
def test_model_ir_takes_the_shared_block(base):
    """A shared attention block, refused before the zamba2 slice: its
    attention and MLP cells follow the block's own, as the JAX package's
    ``to_ir`` gives them (over SSM layers, and over a dense decoder)."""
    port = dataclasses.replace(C.get_reduced(base), shared_attn=True)
    ref = dataclasses.replace(RC.get_reduced(base), shared_attn=True)
    ir = model_ir(port)
    assert ir == ref.to_ir()
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
    assert model_ir(port) == ref.to_ir()


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
    port's config are the simulator's on the JAX package's IR."""
    cfg = C.get_reduced("qwen2-0.5b")
    reqs = fig6.make_requests(cfg.vocab_size, 6, 12, 8, seed=0)
    args = (AnalyticBackend(h100_node(1)), reqs, (1, 4), None)
    port = fig6.predictions(model_ir(cfg), *args)
    ref = fig6.predictions(RC.get_reduced("qwen2-0.5b").to_ir(), *args)
    for cap in (1, 4):
        assert port[cap].e2e_latency == ref[cap].e2e_latency
        assert port[cap].ttft_mean == ref[cap].ttft_mean


def test_serve_runs_the_search_then_the_engine_on_the_cpu():
    lines = []
    base, best, report = serve.serve(size="reduced", requests=3,
                                     device="cpu", log=lines.append)
    assert lines[0].startswith("APEX: baseline")
    assert lines[1].startswith("APEX: optimal")
    assert lines[2].startswith("engine [qwen2-0.5b-reduced")
    assert best.best.e2e_latency <= base.e2e_latency
    assert len(report.results) == 3


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "mixtral-8x7b",
                                  "gemma3-12b"])
def test_serve_runs_the_ssm_and_moe_archs_on_the_cpu(arch):
    """The engine serves every port config, SSM, MoE and gemma3's blocks
    of mixed windows included: the search on the FULL arch, then the
    engine at REDUCED size."""
    lines = []
    _, _, report = serve.serve(arch=arch, size="reduced", requests=3,
                               device="cpu", log=lines.append)
    assert lines[2].startswith(f"engine [{C.get_reduced(arch).name}")
    assert sorted(r.rid for r in report.results) == [0, 1, 2]


def test_serve_passes_depth_to_the_engine(monkeypatch):
    """``depth`` reaches the port's entry point, which cuts the model to
    that many blocks (mixtral FULL fits one card at 16 of 32)."""
    seen = {}

    def engine(*args, **kwargs):
        seen.update(kwargs)
        return None, []

    monkeypatch.setattr(serve.port_serve, "serve", engine)
    serve.serve(arch="mixtral-8x7b", size="reduced", requests=2,
                device="cpu", log=lambda s: None, depth=1)
    assert seen["depth"] == 1


def test_serve_raises_for_an_arch_without_a_port_config():
    """Every arch of the JAX registry has a port config since the zamba2
    slice: a name neither package has."""
    assert sorted(RC.ALIASES) == sorted(C.ALIASES)
    assert "mamba3-1b" not in RC.ALIASES
    with pytest.raises(KeyError, match="not yet ported"):
        serve.serve(arch="mamba3-1b", size="reduced",
                    device="cpu", log=lambda s: None)


def test_importing_the_bridge_loads_no_jax_and_only_repro_core():
    mods = sorted(m.name for m in pkgutil.walk_packages(
        apex_bridge.__path__, "apex_bridge."))
    assert {"apex_bridge.fig6", "apex_bridge.serve", "apex_bridge.ir",
            "apex_bridge.profiles"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib') or (m.split('.')[0] == 'repro' and m != 'repro'"
        " and not m.startswith('repro.core')))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_only_the_bridge_imports_both_halves():
    bridge = re.compile(r"^\s*(import|from)\s+apex_bridge\b", re.M)
    for f in sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
            REPO / "chip_smoke.py"]:
        assert not bridge.search(f.read_text()), f
    beyond_core = re.compile(
        r"^\s*(import\s+(jax|jaxlib)\b|from\s+(jax|jaxlib)\b"
        r"|import\s+repro\.(?!core\b)|from\s+repro\.(?!core\b)\w"
        r"|from\s+repro\s+import)", re.M)
    for f in sorted((REPO / "src" / "apex_bridge").rglob("*.py")):
        assert not beyond_core.search(f.read_text()), f
