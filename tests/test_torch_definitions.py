"""The port against the JAX package definition by definition, on the CPU:
``param_count``, ``layer_norm`` and ``all_configs`` against the
reference's, every public function or class of a JAX-importing module of
``src/repro/`` against its counterpart in ``src/repro_torch/``, and every
public definition of the simulator's modules the port has copied against
its copy, name for name."""

import ast
import dataclasses
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.layers import norms as JN  # noqa: E402
from repro.models import encdec as JE  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch import layers as TL  # noqa: E402
from repro_torch import models as TM  # noqa: E402
from repro_torch.convert import params_from_jax, to_torch  # noqa: E402
from repro_torch.models import encdec as TE  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"

# Public definitions the port carries under another name or in another
# module: the Pallas kernels and their dispatchers become the CUDA
# kernels' wrappers, each reference becomes the wrapper's plain version,
# and the chunked SSD scan is the SSD wrapper's plain version (the layer
# adds the D-skip term).
COUNTERPARTS = {
    ("kernels/decode_attention/decode_attention.py",
     "decode_attention_pallas"):
        ("kernels/decode_attention.py", "decode_attention"),
    ("kernels/decode_attention/ops.py", "decode_attention"):
        ("kernels/decode_attention.py", "decode_attention"),
    ("kernels/decode_attention/ref.py", "decode_attention_ref"):
        ("kernels/decode_attention.py", "decode_attention_plain"),
    ("kernels/flash_attention/flash_attention.py",
     "flash_attention_pallas"):
        ("kernels/flash_attention.py", "flash_attention"),
    ("kernels/flash_attention/ops.py", "flash_attention"):
        ("kernels/flash_attention.py", "flash_attention"),
    ("kernels/flash_attention/ref.py", "attention_ref"):
        ("kernels/flash_attention.py", "flash_attention_plain"),
    ("kernels/rmsnorm/rmsnorm.py", "rms_norm_pallas"):
        ("kernels/rmsnorm.py", "rms_norm"),
    ("kernels/rmsnorm/ops.py", "fused_rms_norm"):
        ("kernels/rmsnorm.py", "rms_norm"),
    ("kernels/ssd_scan/ssd_scan.py", "ssd_scan_pallas"):
        ("kernels/ssd_scan.py", "ssd_scan"),
    ("kernels/ssd_scan/ops.py", "ssd_scan"):
        ("kernels/ssd_scan.py", "ssd_scan"),
    ("kernels/ssd_scan/ref.py", "ssd_scan_ref"):
        ("kernels/ssd_scan.py", "ssd_scan_sequential"),
    ("layers/ssm.py", "ssd_chunked"):
        ("kernels/ssd_scan.py", "ssd_scan_plain"),
}
# the simulator's modules (plain Python) the port copies, each under the
# same path
SIMULATOR = ("core/quant.py", "core/cluster.py", "core/collectives.py",
             "core/energy.py", "core/ir.py", "core/templates.py",
             "core/planner.py", "core/mapper.py", "core/trace.py",
             "core/metrics.py", "core/faults.py", "core/batching.py",
             "core/engine.py", "core/profiles.py", "core/simulator.py",
             "core/search.py", "serving/router.py", "core/fluid.py",
             "disagg/kv_transfer.py", "disagg/pools.py",
             "disagg/simulate.py", "disagg/__init__.py",
             "core/multifid.py", "core/dynamic.py")
# the simulator's modules of the next slice, not copied yet: none left
NEXT_SLICE = set()


def _defined(path: Path) -> set:
    """Names a module binds at its top level."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {a.asname or a.name for a in node.names}
    return names


def _jax_modules():
    for path in sorted((SRC / "repro").rglob("*.py")):
        text = path.read_text()
        if "import jax" in text or "from jax" in text:
            yield path


def test_every_public_definition_of_the_jax_modules_has_a_counterpart():
    missing, seen = [], 0
    for path in _jax_modules():
        rel = path.relative_to(SRC / "repro").as_posix()
        public = [n.name for n in ast.parse(path.read_text()).body
                  if isinstance(n, (ast.FunctionDef, ast.ClassDef))
                  and not n.name.startswith("_")]
        for name in public:
            seen += 1
            where, want = COUNTERPARTS.get((rel, name), (rel, name))
            target = SRC / "repro_torch" / where
            if not target.exists() or want not in _defined(target):
                missing.append(f"{rel}:{name} -> {where}:{want}")
    assert seen > 80
    assert not missing, missing


def _public(path: Path) -> list:
    return [n.name for n in ast.parse(path.read_text()).body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))
            and not n.name.startswith("_")]


def test_every_public_definition_of_the_simulator_has_its_copy():
    assert len(SIMULATOR) == 24 and not NEXT_SLICE
    missing, seen = [], 0
    for rel in SIMULATOR:
        target = SRC / "repro_torch" / rel
        defined = _defined(target) if target.exists() else set()
        for name in _public(SRC / "repro" / rel):
            seen += 1
            if name not in defined:
                missing.append(f"{rel}:{name}")
    assert seen > 140
    assert not missing, missing


def test_each_simulator_module_is_copied_or_in_the_next_slice():
    """Every module of the reference's simulator (``core/``, ``disagg/``
    and the router) is copied, or named for the next slice and absent."""
    ref = {p.relative_to(SRC / "repro").as_posix()
           for d in ("core", "disagg")
           for p in (SRC / "repro" / d).glob("*.py")
           if p.name != "__init__.py" or d == "disagg"}
    ref.add("serving/router.py")
    assert ref == set(SIMULATOR) | NEXT_SLICE
    for rel in NEXT_SLICE:
        assert not (SRC / "repro_torch" / rel).exists(), rel


def test_core_exports_the_references_names_and_torch_measured_backend():
    """``repro_torch.core`` exports what ``repro.core`` does, plus
    ``TorchMeasuredBackend``."""
    import repro.core as RCORE
    import repro_torch.core as TCORE
    assert {"FluidSimulator", "MultiFidelitySearch",
            "DynamicPlanSimulator"} <= set(RCORE.__all__)
    assert set(TCORE.__all__) == set(RCORE.__all__) | {
        "TorchMeasuredBackend"}
    for name in TCORE.__all__:
        assert hasattr(TCORE, name), name


def _reference_params(cfg, seed=0):
    init = JE.init_encdec_params if cfg.encoder is not None \
        else JT.init_params
    return jax.device_get(init(jax.random.PRNGKey(seed), cfg))


@pytest.mark.parametrize("arch", sorted(TC.ALIASES))
def test_param_count_equals_the_reference_on_converted_weights(arch):
    jcfg, tcfg = JC.get_reduced(arch), TC.get_reduced(arch)
    jparams = _reference_params(jcfg)
    want = JT.param_count(jparams)
    assert TM.param_count(params_from_jax(jparams, tcfg, device="cpu")) \
        == want
    init = TE.init_encdec_params if tcfg.encoder is not None \
        else TM.init_params
    fresh = init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert TM.param_count(fresh) == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(8, 128), (3, 7, 1024), (2, 1, 56)])
def test_layer_norm_equals_the_reference(shape, dtype):
    """fp32 within 1e-6; bf16 within one bf16 ulp of the reference's
    value (2^-7 of its magnitude)."""
    rng = np.random.default_rng(0)
    draw = [(rng.standard_normal(s) * scale + shift).astype(np.float32)
            for s, scale, shift in ((shape, 2.0, 0.5), (shape[-1:], 1.0, 0),
                                    (shape[-1:], 0.1, 0))]
    if dtype == "bfloat16":
        draw = [a.astype(ml_dtypes.bfloat16) for a in draw]
    port = TL.layer_norm(*map(to_torch, draw))
    ref = np.asarray(JN.layer_norm(*map(jnp.asarray, draw)))
    assert port.dtype == getattr(torch, dtype)
    got, want = port.float().numpy(), ref.astype(np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        assert np.all(np.abs(got - want) <= 2.0 ** -7 * np.abs(want))


def test_layer_norm_keeps_eps_and_the_affine_terms():
    x = torch.zeros(2, 4)
    w, b = torch.full((4,), 3.0), torch.arange(4.0)
    assert torch.equal(TL.layer_norm(x, w, b), b.expand(2, 4))
    y = TL.layer_norm(torch.tensor([[1.0, -1.0]]), torch.ones(2),
                      torch.zeros(2), eps=3.0)
    assert torch.allclose(y, torch.tensor([[0.5, -0.5]]))


def test_all_configs_has_the_references_keys_and_the_ports_configs():
    port, ref = TC.all_configs(), JC.all_configs()
    assert set(port) == set(ref) == set(TC.ARCHS)
    for name, cfg in port.items():
        assert cfg == TC.get_config(name)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref[name])
