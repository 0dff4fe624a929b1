"""The PyTorch port stands alone: it imports neither JAX nor anything of
the JAX package ``repro``, and its entry points never pick the CPU on
their own."""

import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|jaxlib|repro)\b(?!_)"
    r"|from\s+(jax|jaxlib|repro)(\.|\s)(?!_))", re.M)


def _port_modules():
    import repro_torch
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_importing_every_port_module_loads_no_jax_and_no_repro():
    mods = _port_modules()
    for name in ("repro_torch.serving.engine", "repro_torch.layers.ssm",
                 "repro_torch.kernels.ssd_scan",
                 "repro_torch.configs.mamba2_2_7b",
                 "repro_torch.layers.moe",
                 "repro_torch.configs.mixtral_8x7b",
                 "repro_torch.configs.gemma3_12b",
                 "repro_torch.training.compress",
                 "repro_torch.training.elastic",
                 "repro_torch.parallel.padding",
                 "repro_torch.parallel.sharding",
                 "repro_torch.parallel.plan_sharding",
                 "repro_torch.parallel.sp_decode",
                 "repro_torch.parallel.ep",
                 "repro_torch.parallel.pipeline",
                 "repro_torch.layers.hints",
                 "repro_torch.launch.mesh",
                 "repro_torch.launch.shapes",
                 "repro_torch.launch.op_counts",
                 "repro_torch.launch.dryrun",
                 "repro_torch.launch.fig6",
                 "repro_torch.core.quant", "repro_torch.core.cluster",
                 "repro_torch.core.collectives", "repro_torch.core.energy",
                 "repro_torch.core.ir", "repro_torch.core.templates",
                 "repro_torch.core.planner", "repro_torch.core.mapper",
                 "repro_torch.core.trace", "repro_torch.core.metrics",
                 "repro_torch.core.faults", "repro_torch.core.batching",
                 "repro_torch.core.engine", "repro_torch.core.profiles",
                 "repro_torch.core.simulator", "repro_torch.core.search",
                 "repro_torch.serving.router", "repro_torch.core.fluid",
                 "repro_torch.core.multifid", "repro_torch.core.dynamic",
                 "repro_torch.disagg", "repro_torch.disagg.kv_transfer",
                 "repro_torch.disagg.pools", "repro_torch.disagg.simulate"):
        assert name in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_sources_name_no_jax_and_no_repro_import():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        hits = FORBIDDEN.findall(f.read_text())
        assert not hits, f"{f.relative_to(REPO)} imports {hits}"


def test_forbidden_pattern_catches_what_it_should():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import",
                 "from repro.models import x", "import repro",
                 "from repro import configs", "  import jaxlib"):
        assert FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.layers import x",
                 "from repro_torch import configs", "# see repro.layers",
                 "import jaxtyping_like_but_not"):
        assert not FORBIDDEN.search(line), line


def test_entry_points_never_pick_the_cpu_on_their_own():
    from repro_torch import resolve_device
    from repro_torch import configs as C
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ServingEngine
    cfg = C.get_reduced("qwen2-0.5b")
    params = T.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        with pytest.raises(ValueError):         # params are on the CPU
            ServingEngine(cfg, params)
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="CUDA"):
            ServingEngine(cfg, params)
