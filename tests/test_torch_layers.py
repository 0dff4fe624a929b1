"""Layers of the PyTorch port against the JAX reference, on the CPU.

Inputs are drawn with numpy from a seed and handed to both sides (bf16
crosses bit for bit).  Tolerances per module: fp32 2e-5 (the kernel
sweeps' bound, tests/test_kernels.py); bf16 2e-2 (one bf16 rounding of
an O(1) value, and the reference casts the softmax weights to bf16 before
p @ V where the port keeps them in fp32).
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402
from torch import nn  # noqa: E402

from repro.layers import attention as JA  # noqa: E402
from repro.layers import mlp as JM  # noqa: E402
from repro.layers import norms as JN  # noqa: E402
from repro.layers import rope as JR  # noqa: E402
from repro.models.transformer import ring_size as j_ring_size  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.layers import attention as TA  # noqa: E402
from repro_torch.layers import mlp as TM  # noqa: E402
from repro_torch.layers import norms as TN  # noqa: E402
from repro_torch.layers import rope as TR  # noqa: E402
from repro_torch.models.transformer import ring_size  # noqa: E402

DTYPES = ["float32", "bfloat16"]


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _draw(rng, shape, dtype, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return a.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else a


def _close(port, ref, dtype):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref).astype(np.float32),
                               **_tol(dtype))


def _pdict(tree):
    return nn.ParameterDict({k: nn.Parameter(to_torch(v),
                                             requires_grad=False)
                             for k, v in tree.items()})


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(8, 128), (3, 7, 256), (2, 1, 56)])
def test_rms_norm(shape, dtype):
    rng = np.random.default_rng(0)
    x = _draw(rng, shape, dtype)
    w = _draw(rng, shape[-1:], dtype)
    _close(TN.rms_norm(to_torch(x), to_torch(w)),
           JN.rms_norm(jnp.asarray(x), jnp.asarray(w)), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_rope_split_halves(dtype):
    rng = np.random.default_rng(1)
    q = _draw(rng, (2, 5, 4, 16), dtype)
    k = _draw(rng, (2, 5, 2, 16), dtype)
    pos = rng.integers(0, 300, size=(2, 5)).astype(np.int32)
    tq, tk = TR.apply_rope(to_torch(q), to_torch(k), to_torch(pos), 1e4)
    jq, jk = JR.apply_rope(jnp.asarray(q), jnp.asarray(k),
                           jnp.asarray(pos), 1e4)
    assert tq.dtype == to_torch(q).dtype
    _close(tq, jq, dtype)
    _close(tk, jk, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("gated", [True, False])
def test_mlp_forward(gated, dtype):
    rng = np.random.default_rng(2)
    d, f = 32, 96
    tree = {"w_up": _draw(rng, (d, f), dtype, d ** -0.5),
            "w_down": _draw(rng, (f, d), dtype, f ** -0.5)}
    if gated:
        tree["w_gate"] = _draw(rng, (d, f), dtype, d ** -0.5)
    x = _draw(rng, (2, 3, d), dtype)
    _close(TM.mlp_forward(_pdict(tree), to_torch(x)),
           JM.mlp_forward({k: jnp.asarray(v) for k, v in tree.items()},
                          jnp.asarray(x)), dtype)


def test_init_mlp_and_attention_shapes():
    gen = torch.Generator().manual_seed(0)
    p = TM.init_mlp(gen, 32, 96, gated=True, dtype=torch.float32)
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "w_up": (32, 96), "w_down": (96, 32), "w_gate": (32, 96)}
    a = TA.init_attention(gen, 32, 4, 2, 8, qkv_bias=True)
    assert {k: tuple(v.shape) for k, v in a.items()} == {
        "wq": (32, 32), "wk": (32, 16), "wv": (32, 16), "wo": (32, 32),
        "bq": (32,), "bk": (16,), "bv": (16,)}
    assert all(v.dtype == torch.bfloat16 for v in a.values())
    assert float(a["bq"].detach().float().abs().sum()) == 0.0


def _attn_tree(rng, d, hq, hkv, hd, dtype, bias=True):
    tree = {"wq": _draw(rng, (d, hq * hd), dtype, d ** -0.5),
            "wk": _draw(rng, (d, hkv * hd), dtype, d ** -0.5),
            "wv": _draw(rng, (d, hkv * hd), dtype, d ** -0.5),
            "wo": _draw(rng, (hq * hd, d), dtype, (hq * hd) ** -0.5)}
    if bias:
        tree["bq"] = _draw(rng, (hq * hd,), dtype, 0.5)
        tree["bk"] = _draw(rng, (hkv * hd,), dtype, 0.5)
        tree["bv"] = _draw(rng, (hkv * hd,), dtype, 0.5)
    return tree


@pytest.mark.parametrize("dtype", DTYPES)
def test_project_qkv_with_bias(dtype):
    rng = np.random.default_rng(3)
    tree = _attn_tree(rng, 32, 4, 2, 8, dtype)
    x = _draw(rng, (2, 3, 32), dtype)
    port = TA._project_qkv(_pdict(tree), to_torch(x), 4, 2, 8)
    ref = JA._project_qkv({k: jnp.asarray(v) for k, v in tree.items()},
                          jnp.asarray(x), 4, 2, 8)
    for p, r in zip(port, ref):
        assert tuple(p.shape) == r.shape
        _close(p, r, dtype)


def test_ring_size_matches_reference():
    for w in (1, 5, 15, 16, 17, 4096):
        assert ring_size(w) == j_ring_size(w)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["linear", "ring"])
def test_gqa_decode_step(case, dtype):
    """Two successive steps: the new rows land in the same cache slots and
    the attention outputs agree.  The ring case (window 5, Smax =
    ring_size(5)) has lengths that wrap around the ring."""
    rng = np.random.default_rng(4)
    B, d, hq, hkv, hd = 2, 32, 4, 2, 8
    if case == "ring":
        window, smax = 5, ring_size(5)
        lens = np.array([37, 3], np.int32)
    else:
        window, smax = None, 12
        lens = np.array([3, 10], np.int32)
    tree = _attn_tree(rng, d, hq, hkv, hd, dtype)
    ck = _draw(rng, (B, smax, hkv, hd), dtype)
    cv = _draw(rng, (B, smax, hkv, hd), dtype)
    jp = {k: jnp.asarray(v) for k, v in tree.items()}
    tp = _pdict(tree)
    jk, jv = jnp.asarray(ck), jnp.asarray(cv)
    tk, tv = to_torch(ck), to_torch(cv)
    kw = dict(n_heads=hq, n_kv_heads=hkv, head_dim=hd, window=window)
    for step in range(2):
        x = _draw(rng, (B, 1, d), dtype)
        jy, jk, jv = JA.gqa_decode_step(jp, jnp.asarray(x), jk, jv,
                                        jnp.asarray(lens + step), **kw)
        ty, tk, tv = TA.gqa_decode_step(tp, to_torch(x), tk, tv,
                                        to_torch(lens + step), **kw)
        _close(ty, jy, dtype)
        _close(tk, jk, dtype)
        _close(tv, jv, dtype)
