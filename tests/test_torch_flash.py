"""The flash-attention slice of the port against the JAX reference on the
CPU: the kernel's plain version against the TPU kernel (Pallas in
interpret mode) and its ref.py oracle, the port's ``blockwise_attention``
forward and gradients against the reference's custom VJP, and the RMSNorm
gradient against ``jax.grad``.

The CUDA kernel itself runs only on the card (chip_smoke.py holds it
against ``flash_attention_plain`` there).  Here the wrapper must take the
plain version for CPU tensors without counting a launch, and its
argument checks must refuse what the kernel does not take.

Tolerances:
  * outputs of the plain version: fp32 2e-5 and bf16 2e-2, as in
    tests/test_kernels.py (summation order; bf16 rounding of the
    inputs' products in the Pallas kernel);
  * lse: 1e-5 absolute against a float64 numpy logsumexp (fp32 sums);
  * gradients: fp32 rtol 1e-4 atol 1e-5, as in
    tests/test_kernels.py::test_flash_vjp_matches_naive_grad.
"""

import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention.flash_attention import \
    flash_attention_pallas  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro.layers import attention as JA  # noqa: E402
from repro.layers.norms import rms_norm as rms_norm_ref  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import rmsnorm as RN  # noqa: E402
from repro_torch.layers import attention as TA  # noqa: E402

DTYPES = ["float32", "bfloat16"]


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _draw(rng, shape, dtype="float32"):
    a = rng.standard_normal(shape).astype(np.float32)
    return a.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else a


def _lse_numpy(q, k, causal, window, q_offset):
    """float64 logsumexp of the masked, scaled scores: (B, Hq, Sq)."""
    q = np.asarray(q, np.float64)
    k = np.asarray(k, np.float64)
    rep = q.shape[2] // k.shape[2]
    s = np.einsum("bqhd,bkhd->bhqk", q, np.repeat(k, rep, axis=2))
    s /= math.sqrt(q.shape[-1])
    q_pos = q_offset + np.arange(q.shape[1])[:, None]
    k_pos = np.arange(k.shape[1])[None, :]
    mask = np.ones(s.shape[-2:], bool)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    s = np.where(mask, s, -np.inf)
    m = s.max(axis=-1, keepdims=True)
    return (m + np.log(np.exp(s - m).sum(axis=-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [
    # (B, Sq, Skv, Hq, Hkv, D, window, q_offset)
    (1, 64, 64, 4, 4, 32, None, 0),        # MHA
    (2, 130, 130, 8, 2, 32, None, 0),      # GQA + ragged length
    (1, 96, 96, 4, 2, 64, 37, 0),          # sliding window
    (1, 257, 257, 2, 1, 16, None, 0),      # odd lengths force padding
    (1, 130, 130, 14, 2, 64, None, 0),     # qwen2-0.5b heads: group 7
    (2, 40, 100, 4, 2, 32, None, 60),      # prefix cache: Sq < Skv
    (1, 70, 70, 2, 2, 256, None, 0),       # head dim 256 (gemma3): MHA
    (2, 70, 70, 4, 2, 256, 19, 0),         # group 2, window
    (1, 40, 77, 16, 2, 256, 23, 37),       # group 8, window and offset
])
def test_flash_plain_matches_pallas_and_ref(shape, dtype):
    B, Sq, Skv, Hq, Hkv, D, window, q_offset = shape
    rng = np.random.default_rng(0)
    q = _draw(rng, (B, Sq, Hq, D), dtype)
    k = _draw(rng, (B, Skv, Hkv, D), dtype)
    v = _draw(rng, (B, Skv, Hkv, D), dtype)
    out, lse = FA.flash_attention_plain(
        to_torch(q), to_torch(k), to_torch(v), causal=True, window=window,
        q_offset=q_offset)
    assert out.dtype == to_torch(q).dtype and tuple(out.shape) == q.shape
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (B, Hq, Sq)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    pallas = flash_attention_pallas(jq, jk, jv, causal=True, window=window,
                                    block_q=64, block_kv=32,
                                    q_offset=q_offset, interpret=True)
    ref = attention_ref(jq, jk, jv, causal=True, window=window,
                        q_offset=q_offset)
    for want in (pallas, ref):
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(want).astype(np.float32),
                                   **_tol(dtype))
    np.testing.assert_allclose(lse.numpy(),
                               _lse_numpy(q, k, True, window, q_offset),
                               rtol=0, atol=1e-5)


def test_flash_plain_row_with_no_valid_key_is_zero():
    """A row the window leaves empty gives 0 and a finite lse, as the
    kernel does (ref.py would give the mean of V)."""
    rng = np.random.default_rng(1)
    q, k, v = (to_torch(_draw(rng, (1, 4, 2, 16))) for _ in range(3))
    out, lse = FA.flash_attention_plain(q, k, v, causal=True, window=2,
                                        q_offset=6)   # rows 6..9, keys 0..3
    assert torch.equal(out[:, 2:], torch.zeros_like(out[:, 2:]))
    assert bool(torch.isfinite(lse).all())
    assert float(lse[0, 0, 3]) < -1e29


def _grad_case(rng, B, Sq, Skv, Hq, Hkv, D):
    return (_draw(rng, (B, Sq, Hq, D)), _draw(rng, (B, Skv, Hkv, D)),
            _draw(rng, (B, Skv, Hkv, D)))


@pytest.mark.parametrize("case", [
    # (B, Sq, Skv, Hq, Hkv, D, window, q_offset, q_block, kv_block)
    (1, 70, 70, 4, 2, 16, 23, 0, 32, 16),   # test_flash_vjp_matches_...
    (2, 70, 70, 4, 2, 16, None, 0, 32, 16),
    (1, 40, 70, 6, 2, 8, None, 30, 16, 32),
])
def test_blockwise_attention_forward_and_grads_match_reference(case):
    B, Sq, Skv, Hq, Hkv, D, window, q_offset, qb, kb = case
    rng = np.random.default_rng(5)
    q, k, v = _grad_case(rng, B, Sq, Skv, Hq, Hkv, D)

    def f_jax(q, k, v):
        return JA.blockwise_attention(q, k, v, causal=True, window=window,
                                      q_block=qb, kv_block=kb,
                                      q_offset=q_offset)

    jout = f_jax(*(jnp.asarray(a) for a in (q, k, v)))
    jgrads = jax.grad(lambda *a: jnp.sum(jnp.tanh(f_jax(*a))),
                      argnums=(0, 1, 2))(*(jnp.asarray(a)
                                           for a in (q, k, v)))
    tq, tk, tv = (to_torch(a).requires_grad_() for a in (q, k, v))
    tout = TA.blockwise_attention(tq, tk, tv, causal=True, window=window,
                                  q_block=qb, kv_block=kb,
                                  q_offset=q_offset)
    torch.tanh(tout).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=1e-4, atol=1e-5)
    for t, j in zip((tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j),
                                   rtol=1e-4, atol=1e-5)


def test_blockwise_attention_grads_in_bf16_keep_dtypes():
    rng = np.random.default_rng(6)
    q, k, v = (to_torch(a.astype(ml_dtypes.bfloat16)).requires_grad_()
               for a in _grad_case(rng, 1, 33, 33, 4, 1, 16))
    out = TA.blockwise_attention(q, k, v, q_block=16, kv_block=8)
    out.float().square().sum().backward()
    assert out.dtype == torch.bfloat16
    for t in (q, k, v):
        assert t.grad.dtype == torch.bfloat16
        assert bool(torch.isfinite(t.grad.float()).all())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(8, 128), (3, 7, 256), (4, 1, 896)])
def test_rms_norm_grads_match_jax_grad(shape, dtype, monkeypatch):
    """Both gradients of the port's RMSNorm against ``jax.grad``: autograd
    through the plain version (CPU tensors) and the explicit
    ``rms_norm_grads`` that the CUDA path's backward runs."""
    rng = np.random.default_rng(3)
    x = _draw(rng, shape, dtype)
    w = _draw(rng, shape[-1:], dtype)
    dy = _draw(rng, shape, "float32")

    def f(x, w):
        return jnp.sum(rms_norm_ref(x, w).astype(jnp.float32) * dy)

    jdx, jdw = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=1e-5, atol=1e-5)
    # CUDA path's Function with its kernel launch swapped for the plain
    # version, so its backward runs here
    monkeypatch.setattr(RN, "_launch", RN.rms_norm_plain)
    for apply in (RN.rms_norm_plain, RN._RMSNormKernel.apply):
        tx, tw = (to_torch(a).requires_grad_() for a in (x, w))
        y = apply(tx, tw, 1e-6)
        (y.float() * to_torch(dy)).sum().backward()
        assert tx.grad.dtype == tx.dtype and tw.grad.dtype == tw.dtype
        np.testing.assert_allclose(tx.grad.float().numpy(),
                                   np.asarray(jdx).astype(np.float32),
                                   **tol)
        np.testing.assert_allclose(tw.grad.float().numpy(),
                                   np.asarray(jdw).astype(np.float32),
                                   **tol)


def test_cpu_tensors_take_plain_version_without_counting():
    rng = np.random.default_rng(7)
    q = to_torch(_draw(rng, (2, 9, 14, 16), "bfloat16"))
    k, v = (to_torch(_draw(rng, (2, 9, 2, 16), "bfloat16"))
            for _ in range(2))
    n = FA.launches
    got = FA.flash_attention(q, k, v, window=4)
    want = FA.flash_attention_plain(q, k, v, window=4)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert FA.launches == n


def test_flash_kernel_checks_refuse_bad_args():
    def args(B=4, S=64, Hq=14, Hkv=2, D=64, dtype=torch.bfloat16):
        return (torch.zeros(B, S, Hq, D, dtype=dtype),
                torch.zeros(B, S, Hkv, D, dtype=dtype),
                torch.zeros(B, S, Hkv, D, dtype=dtype))

    FA.check_kernel_args(*args(), None, 0)                  # qwen2-0.5b
    FA.check_kernel_args(*args(Hq=16, Hkv=8, D=128), 37, 5)  # internlm2
    FA.check_kernel_args(*args(Hq=16, Hkv=8, D=256), 1024, 0)  # gemma3
    for D in (16, 32, 256):
        FA.check_kernel_args(*args(Hq=8, Hkv=8, D=D,
                                   dtype=torch.float32), None, 0)
    for bad in (args(D=24), args(D=512),                     # head dim
                args(Hq=18, Hkv=2), args(Hq=14, Hkv=4),      # group
                args(dtype=torch.float16),                   # dtype
                args(B=5000, Hq=16, Hkv=2)):                 # grid
        with pytest.raises(ValueError):
            FA.check_kernel_args(*bad, None, 0)
    q, k, v = args()
    for window, q_offset in ((0, 0), (None, -1)):
        with pytest.raises(ValueError):
            FA.check_kernel_args(q, k, v, window, q_offset)
    with pytest.raises(ValueError):                          # Dv != D
        FA.check_kernel_args(q, k, v[..., :32].contiguous(), None, 0)
    with pytest.raises(ValueError):                          # not contiguous
        FA.check_kernel_args(q.transpose(1, 2), k, v, None, 0)


def test_flash_kernel_checks_refuse_misaligned_bf16():
    """The bf16 kernel reads q, k and v through TMA maps, whose bases must
    be 16-byte aligned; the fp32 kernel reads elements and takes any."""
    def shifted(shape, dtype):
        n = math.prod(shape)
        return torch.zeros(n + 1, dtype=dtype)[1:].view(shape)

    q = torch.zeros(1, 8, 2, 16, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 1, 16, dtype=torch.bfloat16)
    FA.check_kernel_args(q, k, k, None, 0)
    for bad in ((shifted(q.shape, torch.bfloat16), k, k),
                (q, shifted(k.shape, torch.bfloat16), k),
                (q, k, shifted(k.shape, torch.bfloat16))):
        assert bad[0].is_contiguous() and bad[1].is_contiguous()
        with pytest.raises(ValueError, match="aligned"):
            FA.check_kernel_args(*bad, None, 0)
    qf = shifted(q.shape, torch.float32)
    kf = shifted(k.shape, torch.float32)
    FA.check_kernel_args(qf, kf, kf, None, 0)


def test_flash_kernel_checks_refuse_too_many_bf16_query_tiles():
    """The bf16 grid puts query tiles on y (at most 65535 of 128 rows)."""
    # expanded views: no memory behind them, and the tile count is checked
    # before contiguity
    row = torch.empty(1, 1, 1, 16, dtype=torch.bfloat16)
    k = torch.empty(1, 1, 1, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="query tiles"):
        FA.check_kernel_args(row.expand(1, 65535 * 128 + 1, 1, 16), k, k,
                             None, 0)
    with pytest.raises(ValueError, match="contiguous"):   # at the limit
        FA.check_kernel_args(row.expand(1, 65535 * 128, 1, 16), k, k,
                             None, 0)


@pytest.mark.parametrize("dtype,rows,threads", [
    (torch.bfloat16, 128, 288), (torch.float32, 64, 128)])
def test_flash_grid_reports_the_launch_geometry(dtype, rows, threads):
    """bf16: 128-row query tiles, two consumer warpgroups and a producer
    warp; fp32: 64-row tiles of one 128-thread block.  The grid's second
    axis is B * Hq either way."""
    for Sq in (1, rows - 1, rows, rows + 1, 1024):
        q = torch.zeros(4, Sq, 14, 64, dtype=dtype)
        (gx, gy), n = FA.grid(q)
        assert n == threads
        assert sorted((gx, gy)) == sorted((-(-Sq // rows), 4 * 14))
    # bf16 puts (b, h) on x, which launches fastest: every head's longest
    # causal tiles go first
    assert FA.grid(torch.zeros(4, 1024, 14, 64,
                               dtype=torch.bfloat16))[0] == (56, 8)
    assert FA.grid(torch.zeros(4, 1024, 14, 64))[0] == (16, 56)
