"""Plain versions of the port's kernels against the TPU kernels (Pallas in
interpret mode) and their ref.py oracles, on the CPU, over the sweeps of
tests/test_kernels.py plus one qwen2-0.5b-shaped decode case.

The CUDA kernels themselves run only on the card (chip_smoke.py compares
each with its plain version there).  Here the wrappers must take the
plain version for CPU tensors without counting a launch, and their
argument checks must refuse what the kernels do not take.

Tolerances: fp32 2e-5 and bf16 2e-2, as in tests/test_kernels.py.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.decode_attention.decode_attention import \
    decode_attention_pallas  # noqa: E402
from repro.kernels.decode_attention.ref import \
    decode_attention_ref  # noqa: E402
from repro.kernels.rmsnorm.rmsnorm import rms_norm_pallas  # noqa: E402
from repro.layers.norms import rms_norm as rms_norm_ref  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import decode_attention as DA  # noqa: E402
from repro_torch.kernels import rmsnorm as RN  # noqa: E402

DTYPES = ["float32", "bfloat16"]


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _draw(rng, shape, dtype):
    a = rng.standard_normal(shape).astype(np.float32)
    return a.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else a


def _close(port, ref, dtype):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref).astype(np.float32),
                               **_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(8, 128), (3, 7, 256), (130, 64),
                                   (4, 1, 896)])
def test_rmsnorm_plain_matches_pallas_and_ref(shape, dtype):
    rng = np.random.default_rng(3)
    x = _draw(rng, shape, dtype)
    w = rng.standard_normal(shape[-1:]).astype(np.float32)
    port = RN.rms_norm_plain(to_torch(x), to_torch(w))
    assert port.dtype == to_torch(x).dtype and port.shape == x.shape
    _close(port, rms_norm_pallas(jnp.asarray(x), jnp.asarray(w),
                                 block_rows=32, interpret=True), dtype)
    _close(port, rms_norm_ref(jnp.asarray(x), jnp.asarray(w)), dtype)


def _lengths(B, smax):
    return np.asarray([(smax * (i + 1)) // (B + 1) + 1 for i in range(B)],
                      np.int32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [
    (2, 8, 2, 64, 128),
    (3, 8, 8, 32, 300),                # MHA, non-multiple length
    (1, 16, 2, 64, 1024),
    (2, 14, 2, 64, 300),               # qwen2-0.5b: group 7, D 64
])
def test_decode_attention_plain_matches_pallas_and_ref(shape, dtype):
    B, Hq, Hkv, D, smax = shape
    rng = np.random.default_rng(1)
    q = _draw(rng, (B, Hq, D), dtype)
    k = _draw(rng, (B, smax, Hkv, D), dtype)
    v = _draw(rng, (B, smax, Hkv, D), dtype)
    lens = _lengths(B, smax)
    port = DA.decode_attention_plain(to_torch(q), to_torch(k), to_torch(v),
                                     to_torch(lens))
    assert port.dtype == to_torch(q).dtype and tuple(port.shape) == q.shape
    jargs = [jnp.asarray(a) for a in (q, k, v, lens)]
    _close(port, decode_attention_pallas(*jargs, block_kv=64,
                                         interpret=True), dtype)
    _close(port, decode_attention_ref(*jargs), dtype)


def test_decode_attention_full_and_single_slot_lengths():
    """Lengths of 1 and Smax, the ends of what decoding produces."""
    rng = np.random.default_rng(5)
    q, k, v = (_draw(rng, s, "float32")
               for s in [(2, 4, 64), (2, 70, 2, 64), (2, 70, 2, 64)])
    lens = np.array([1, 70], np.int32)
    port = DA.decode_attention_plain(to_torch(q), to_torch(k), to_torch(v),
                                     to_torch(lens))
    _close(port, decode_attention_pallas(
        *[jnp.asarray(a) for a in (q, k, v, lens)], block_kv=64,
        interpret=True), "float32")
    # one valid slot: the output is that slot's V row
    np.testing.assert_allclose(port[0].numpy(),
                               np.repeat(v[0, 0], 2, axis=0), rtol=1e-6)


def test_cpu_tensors_take_plain_version_without_counting():
    rng = np.random.default_rng(6)
    x = to_torch(_draw(rng, (4, 1, 96), "bfloat16"))
    w = to_torch(_draw(rng, (96,), "bfloat16"))
    q, k, v = (to_torch(_draw(rng, s, "float32"))
               for s in [(2, 14, 8), (2, 9, 2, 8), (2, 9, 2, 8)])
    lens = torch.tensor([3, 9], dtype=torch.int32)
    n_rms, n_attn = RN.launches, DA.launches
    assert torch.equal(RN.rms_norm(x, w), RN.rms_norm_plain(x, w))
    assert torch.equal(DA.decode_attention(q, k, v, lens),
                       DA.decode_attention_plain(q, k, v, lens))
    assert (RN.launches, DA.launches) == (n_rms, n_attn)


def test_rmsnorm_kernel_checks_refuse_bad_args():
    x = torch.zeros(4, 1, 896, dtype=torch.bfloat16)
    w = torch.ones(896, dtype=torch.bfloat16)
    RN.check_kernel_args(x, w)
    RN.check_kernel_args(x, w.float())          # fp32 weight is taken
    bad = [
        (x.half(), w),                           # dtype
        (x, w[:448]),                            # weight shape
        (x.transpose(0, 2), w),                  # not contiguous
        (torch.zeros(2, 9000), torch.ones(9000)),  # d > MAX_D
    ]
    for bx, bw in bad:
        with pytest.raises(ValueError):
            RN.check_kernel_args(bx, bw)


def test_decode_attention_kernel_checks_refuse_bad_args():
    def args(B=4, Hq=14, Hkv=2, D=64, smax=512, dtype=torch.bfloat16,
             ldtype=torch.int32):
        return (torch.zeros(B, Hq, D, dtype=dtype),
                torch.zeros(B, smax, Hkv, D, dtype=dtype),
                torch.zeros(B, smax, Hkv, D, dtype=dtype),
                torch.ones(B, dtype=ldtype))

    DA.check_kernel_args(*args())                       # qwen2-0.5b
    DA.check_kernel_args(*args(Hq=16, Hkv=8, D=128))    # internlm2-1.8b
    DA.check_kernel_args(*args(Hq=8, Hkv=8, dtype=torch.float32))
    for bad in (args(D=16), args(Hq=18, Hkv=2), args(Hq=14, Hkv=4),
                args(dtype=torch.float16), args(ldtype=torch.int64)):
        with pytest.raises(ValueError):
            DA.check_kernel_args(*bad)
    q, k, v, lens = args()
    with pytest.raises(ValueError):                     # k/v mismatch
        DA.check_kernel_args(q, k, v[:, :, :, :32].contiguous(), lens)
    with pytest.raises(ValueError):                     # not contiguous
        DA.check_kernel_args(q.transpose(0, 1), k, v, lens)


def test_build_needs_nvcc_only_when_building(tmp_path, monkeypatch):
    """Importing the kernels needs no nvcc; building without one raises."""
    monkeypatch.setattr(build, "find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.compile_library(tmp_path / "out")


def test_build_refuses_an_installed_copy(tmp_path):
    """Outside a checkout (an installed package: no src/ tree, no
    pyproject.toml, no .cu sources) the build raises instead of writing
    into a directory shared across installs."""
    build.require_checkout()                       # this checkout
    site = tmp_path / "lib" / "python3" / "site-packages"
    csrc = site / "repro_torch" / "kernels" / "csrc"
    csrc.mkdir(parents=True)
    with pytest.raises(RuntimeError, match="checkout"):
        build.require_checkout(csrc, site.parent)
    (csrc / "a.cu").write_text("int a;")
    with pytest.raises(RuntimeError, match="checkout"):
        build.require_checkout(csrc, site.parent)
    src = tmp_path / "repo" / "src" / "repro_torch" / "kernels" / "csrc"
    src.mkdir(parents=True)
    (src / "a.cu").write_text("int a;")
    with pytest.raises(RuntimeError, match="checkout"):  # no pyproject
        build.require_checkout(src, tmp_path / "repo")
    (tmp_path / "repo" / "pyproject.toml").write_text("")
    build.require_checkout(src, tmp_path / "repo")


def test_source_hash_tracks_sources(tmp_path):
    (tmp_path / "a.cu").write_text("int a;")
    (tmp_path / "h.cuh").write_text("#pragma once")
    h1 = build.source_hash(tmp_path)
    assert h1 == build.source_hash(tmp_path)
    (tmp_path / "h.cuh").write_text("#pragma once\n")
    assert build.source_hash(tmp_path) != h1
    assert build.source_hash(tmp_path, ("-O2",)) != build.source_hash(
        tmp_path)
    assert {p.name for p in build.sources()} == {
        "decode_attention.cu", "errors.cu", "flash_attention.cu",
        "rmsnorm.cu", "ssd_scan.cu"}
