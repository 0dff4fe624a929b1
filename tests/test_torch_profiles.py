"""The port's op profiler (``repro_torch.core.profiles``) against the
reference's ``MeasuredBackend`` and work model (``repro.core.profiles``),
on the CPU."""

import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import profiles as ref_profiles  # noqa: E402
from repro.kernels.decode_attention.ref import \
    decode_attention_ref  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro.kernels.ssd_scan.ref import ssd_scan_ref  # noqa: E402
from repro_torch.core import profiles as P  # noqa: E402
from repro_torch.kernels import decode_attention as DA  # noqa: E402

# small axes of each op, as the REDUCED configs' IR gives them
AXES = {
    "gemm": [(72, 56, "bf16"), (512, 56, "fp16"), (64, 32, "fp32"),
             (151936, 896, "bf16")],
    "attn_decode": [(1, 8, "bf16"), (2, 64, "bf16"), (8, 128, "fp32")],
    "attn_prefill": [(7, 8, "bf16"), (14, 64, "bf16"), (16, 128, "fp32")],
    "ssd_scan": [(128, 16, "bf16"), (5120, 128, "bf16"), (64, 8, "fp32")],
}
SMALL = {"gemm": (72, 56, "bf16"), "attn_decode": (2, 8, "bf16"),
         "attn_prefill": (7, 8, "bf16"), "ssd_scan": (128, 16, "bf16")}


@pytest.fixture
def cpu():
    return P.MeasuredBackend("cpu", repeats=2)


def test_grid_is_the_references():
    assert P._GRID == ref_profiles._GRID


@pytest.mark.parametrize("op", P.OPS)
def test_op_work_copy_equals_the_references(op):
    for axes in AXES[op]:
        for x in P._GRID + [0.5, 3.0, 1000.0]:
            assert P._op_work(op, axes, float(x)) == \
                ref_profiles._op_work(op, axes, float(x)), (op, axes, x)


def test_prefill_len_has_the_nearest_causal_area():
    for x in [0, 1, 2, 3, 4, 7, 100, 4095, 4096, 2 ** 20]:
        s = P.prefill_len(x)
        area = s * (s + 1) / 2
        best = min(abs(n * (n + 1) / 2 - x) for n in range(1, s + 3))
        assert s >= 1 and abs(area - x) == best, (x, s)


@pytest.mark.parametrize("x", [1, 2, 5, 64, 100, 1024])
def test_each_op_times_the_work_the_model_counts(cpu, x):
    a = cpu.inputs("gemm", (72, 56, "bf16"), x)
    assert tuple(a["a"].shape) == (x, 56) and tuple(a["b"].shape) == (56, 72)
    assert a["a"].dtype == torch.bfloat16
    a = cpu.inputs("attn_decode", (2, 8, "bf16"), x)
    assert tuple(a["q"].shape) == (1, 2, 8)
    assert tuple(a["k"].shape) == (1, x, 2, 8) == tuple(a["v"].shape)
    assert a["lengths"].tolist() == [x]
    a = cpu.inputs("attn_prefill", (7, 8, "fp32"), x)
    s = a["q"].shape[1]
    assert tuple(a["q"].shape) == (1, s, 7, 8) and a["q"].dtype == \
        torch.float32
    assert abs(s * (s + 1) / 2 - x) <= s          # within one row of x
    a = cpu.inputs("ssd_scan", (128, 16, "bf16"), x)
    assert tuple(a["x"].shape) == (1, x, 2, 64)
    assert tuple(a["b"].shape) == (1, x, 16) == tuple(a["c"].shape)
    assert tuple(a["dt"].shape) == (1, x, 2) and a["chunk"] == 128


@pytest.mark.parametrize("op", P.OPS)
def test_measure_gives_two_finite_positive_times(cpu, op):
    for x in (1, 16, 200):
        wall, device = cpu.measure(op, SMALL[op], x)
        assert math.isfinite(wall) and math.isfinite(device)
        assert wall > 0 and device > 0
    # one warm-up and two timed calls per clock, three samples
    assert cpu.calls[op] == 3 * (1 + 2 * cpu.repeats)
    assert sum(cpu.calls.values()) == cpu.calls[op]


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("op,axes,x", [
    ("gemm", (40, 24, "fp32"), 17),
    ("attn_decode", (2, 16, "fp32"), 37),
    ("attn_prefill", (3, 16, "fp32"), 60),
    ("ssd_scan", (128, 8, "fp32"), 150),
])
def test_each_op_computes_what_the_jax_reference_does(cpu, op, axes, x):
    """The timed call on the profiler's inputs against the JAX package's
    function on the same numbers."""
    a = cpu.inputs(op, axes, x)
    out = cpu.run(op, a)
    if op == "gemm":
        want = jnp.matmul(_np(a["a"]), _np(a["b"]))
    elif op == "attn_decode":
        want = decode_attention_ref(_np(a["q"]), _np(a["k"]), _np(a["v"]),
                                    a["lengths"].numpy())
    elif op == "attn_prefill":
        out = out[0]
        want = attention_ref(_np(a["q"]), _np(a["k"]), _np(a["v"]),
                             causal=True)
    else:
        want = ssd_scan_ref(_np(a["x"]), _np(a["dt"]), _np(a["a_log"]),
                            _np(a["b"]), _np(a["c"]))
    # fp32: summation order only; the chunked scan against the sequential
    # recurrence as tests/test_kernels.py holds it
    tol = 2e-4 if op == "ssd_scan" else 2e-5
    np.testing.assert_allclose(_np(out), np.asarray(want), rtol=tol,
                               atol=tol)


def test_unknown_op_or_dtype_raises(cpu):
    with pytest.raises(KeyError):
        cpu.measure("allreduce", (4, 4, "bf16"), 8)
    with pytest.raises(KeyError):
        P._op_work("conv", (4, 4, "bf16"), 8)
    for dtype in ("int8", "fp8"):
        with pytest.raises(ValueError, match="dtype"):
            cpu.measure("gemm", (4, 4, dtype), 8)
    with pytest.raises(ValueError):
        P.MeasuredBackend("cpu", repeats=0)
    assert sum(cpu.calls.values()) == 0


def test_without_a_card_the_profiler_raises_like_the_entry_points():
    if torch.cuda.is_available():
        assert P.MeasuredBackend().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            P.MeasuredBackend()


def test_mla_attn_decode_sample_runs_the_kernels_d512_instance(cpu):
    """deepseek's MLA decode is priced at (16, 512): the sample runs the
    decode kernel's head-dim-512 instance (group 1, as every sample's Hq =
    Hkv is), counted in ``calls`` like every other sample; the kernel's
    argument check takes that shape and refuses D 512 above group 1."""
    assert DA.padded_head_dim(512) == 512
    assert DA.max_group(512) == 1 and DA.max_group(256) == DA.MAX_GROUP
    cpu.measure("attn_decode", (16, 512, "bf16"), 8)
    assert cpu.calls["attn_decode"] == 1 + 2 * cpu.repeats
    a = cpu.inputs("attn_decode", (16, 512, "fp32"), 5)
    DA.check_kernel_args(a["q"], a["k"], a["v"], a["lengths"])
    with pytest.raises(ValueError, match="group 2 outside"):
        DA.check_kernel_args(torch.cat([a["q"], a["q"]], dim=1), a["k"],
                             a["v"], a["lengths"])
    want = decode_attention_ref(_np(a["q"]), _np(a["k"]), _np(a["v"]),
                                a["lengths"].numpy())
    np.testing.assert_allclose(_np(cpu.run("attn_decode", a)),
                               np.asarray(want), rtol=2e-5, atol=2e-5)
