"""The fp8 KV-cache serving mode of the port against the JAX reference on
the CPU: the cast every cache write goes through (``device.
to_cache_dtype``), ``init_cache(cache_dtype=float8_e4m3fn)``'s layouts,
``decode_step`` through an e4m3 cache, and the decode-attention wrapper's
fp8 rules (the e4m3 kernel instance itself runs on the card only, in
``chip_smoke.py``).

Tolerances of ``decode_step`` through an e4m3 cache (REDUCED
qwen1.5-32b in fp32 and bf16, deepseek-v2-lite-16b's MLA latents in fp32;
2 layers, 6 steps; read over seeds 0-2): logits fp32 1e-4 and bf16 1e-1,
as over the bf16 caches of ``tests/test_torch_model.py``; the e4m3 cache
bit for bit in fp32 (read: every element), and in bf16 at least 95% of
the elements bit-equal (read: 96.5-97.2%) and every one within one e4m3
step (2^-3 of the larger value) plus the 5e-2 that bf16 caches are held
to (read: at most 0.75 of that): the two frameworks' bf16 products and
RoPE round K apart by up to 3.1e-2 (``tests/test_torch_model.py``), and
e4m3 rounds the two on.  deepseek is not held in bf16 here: its MoE
routes can flip between the frameworks at near-ties (the bf16 tests of
``tests/test_torch_mla.py`` replay the reference's routes), and a flip
moves logits by up to 0.7 (read, seed 1).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.device import to_cache_dtype, torch_dtype  # noqa: E402
from repro_torch.kernels import decode_attention as DA  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

FP8 = torch.float8_e4m3fn
EDGES = [0.0, -0.0, 448.0, 449.0, 455.9, 456.0, 460.0, 463.9, 464.0, 464.1,
         470.0, 480.0, 1000.0, 1e30, float("inf"), float("nan"),
         2.0 ** -6, 2.0 ** -7, 2.0 ** -9, 2.0 ** -10, 3 * 2.0 ** -11,
         1e-3, 1e-6, 0.1, 1.0, 3.3]
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 1e-1}
BITS_AGREE = {"float32": 1.0, "bfloat16": 0.95}
CACHE_TOL = {"float32": 0.0, "bfloat16": 5e-2}


def _jax_bits(x: np.ndarray, dtype) -> np.ndarray:
    return np.asarray(jnp.asarray(x, dtype).astype(jnp.float8_e4m3fn)
                      ).view(np.uint8)


def _torch_bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.uint8).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_to_cache_dtype_matches_jax_on_the_edges(dtype):
    x = np.array(EDGES + [-v for v in EDGES], np.float32)
    t = torch.from_numpy(x).to(torch_dtype(dtype))
    want = _jax_bits(t.float().numpy(), getattr(jnp, dtype))
    np.testing.assert_array_equal(_torch_bits(to_cache_dtype(t, FP8)), want)
    # control: torch's own cast saturates past 464 where JAX gives NaN
    assert (_torch_bits(t.to(FP8)) != want).sum() >= 10


def test_to_cache_dtype_matches_jax_on_every_bf16_value():
    bits = np.arange(1 << 16, dtype=np.uint16).view(np.int16)
    t = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    want = np.asarray(jnp.asarray(bits).view(jnp.bfloat16)
                      .astype(jnp.float8_e4m3fn)).view(np.uint8)
    np.testing.assert_array_equal(_torch_bits(to_cache_dtype(t, FP8)), want)


def test_to_cache_dtype_leaves_other_dtypes_to_to():
    x = torch.tensor([1000.0, -3.5, 1e-8])
    assert torch.equal(to_cache_dtype(x, torch.bfloat16),
                       x.to(torch.bfloat16))
    assert torch_dtype("float8_e4m3fn") is FP8


def _tree_layout(tree):
    """{path: (shape, dtype name)} of a cache tree of either package."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}/{k}")
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, f"{path}/{i}")
        else:
            name = str(t.dtype).replace("torch.", "")
            out[path] = (tuple(t.shape), name)

    walk(tree, "")
    return out


@pytest.mark.parametrize("arch", TC.ARCHS)
def test_init_cache_fp8_layout_matches_reference(arch):
    jcfg, tcfg = JC.get_reduced(arch), TC.get_reduced(arch)
    src = jcfg.cross_source_len if jcfg.cross_attn else 0
    want = jax.eval_shape(lambda: JT.init_cache(
        jcfg, 3, 40, source_len=src, cache_dtype=jnp.float8_e4m3fn))
    got = TT.init_cache(tcfg, 3, 40, device="meta", cache_dtype=FP8,
                        source_len=src)
    assert _tree_layout(got) == _tree_layout(want)
    layout = _tree_layout(got)
    # K/V, latents and conv windows in e4m3; SSM state fp32; len int32
    for path, (_, dt) in layout.items():
        leaf = path.rsplit("/", 1)[-1]
        want_dt = {"ssm": "float32", "len": "int32"}.get(leaf,
                                                         "float8_e4m3fn")
        assert dt == want_dt, path


def _cache_leaves(cache):
    tl = cache["blocks"]["l0"]
    out = dict(tl)
    for i, pc in enumerate(cache.get("prefix", [])):
        out.update({f"prefix{i}/{k}": v for k, v in pc["l0"].items()})
    return out


@pytest.mark.parametrize("arch,dtype", [
    ("qwen1.5-32b", "float32"), ("qwen1.5-32b", "bfloat16"),
    ("deepseek-v2-lite-16b", "float32")])
def test_decode_step_through_an_fp8_cache_matches_reference(arch, dtype):
    jcfg = dataclasses.replace(JC.get_reduced(arch), dtype=dtype)
    tcfg = dataclasses.replace(TC.get_reduced(arch), dtype=dtype)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.device_get(jparams), tcfg, device="cpu")
    B, max_len, steps = 2, 16, 6
    jstep = jax.jit(lambda p, t, c: JT.decode_step(p, jcfg, t, c))
    jcache = JT.init_cache(jcfg, B, max_len, cache_dtype=jnp.float8_e4m3fn)
    tcache = TT.init_cache(tcfg, B, max_len, device="cpu", cache_dtype=FP8)
    rng = np.random.default_rng(7)
    for _ in range(steps):
        toks = rng.integers(0, jcfg.vocab_size, size=(B, 1)).astype(np.int32)
        jl, jcache = jstep(jparams, jnp.asarray(toks), jcache)
        tl, tcache = TT.decode_step(tparams, tcfg, torch.from_numpy(toks),
                                    tcache)
        np.testing.assert_allclose(tl.float().numpy(),
                                   np.asarray(jl).astype(np.float32),
                                   rtol=0, atol=LOGIT_TOL[dtype])
    jleaves = _cache_leaves(jax.device_get(jcache))
    tleaves = _cache_leaves(tcache)
    assert set(jleaves) == set(tleaves)
    for name, t in tleaves.items():
        assert t.dtype == FP8, name
        a = _torch_bits(t)
        b = np.asarray(jleaves[name]).view(np.uint8)
        x = t.float().numpy()
        y = np.asarray(jleaves[name]).astype(np.float32)
        # one e4m3 step (2^-3 of the larger value) beyond the bf16 cache
        # tolerance of tests/test_torch_model.py
        tol = np.maximum(np.abs(x), np.abs(y)) / 8 + CACHE_TOL[dtype]
        with np.errstate(invalid="ignore"):
            share = np.nanmax(np.abs(x - y) / tol)
        print(arch, dtype, name, "bits equal", (a == b).mean(),
              "max share of the tolerance", share)
        assert (a == b).mean() >= BITS_AGREE[dtype], name
        assert np.all(np.abs(x - y) <= tol), name


def test_plain_decode_attention_reads_fp8_exactly():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(3, 8, 128, generator=g).to(torch.bfloat16)
    k = (torch.randn(3, 40, 2, 128, generator=g) * 4).to(FP8)
    v = (torch.randn(3, 40, 2, 128, generator=g) * 4).to(FP8)
    lens = torch.tensor([1, 17, 40], dtype=torch.int32)
    got = DA.decode_attention(q, k, v, lens)           # CPU: the plain one
    want = DA.decode_attention_plain(q, k.to(torch.bfloat16),
                                     v.to(torch.bfloat16), lens)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


@pytest.mark.parametrize("q_dtype,kv_dtype,head_dim,ok", [
    (torch.bfloat16, FP8, 128, True),
    (torch.float32, FP8, 128, False),
    (torch.bfloat16, FP8, 64, False),
    (FP8, FP8, 128, False),
    (torch.bfloat16, torch.bfloat16, 128, True),
])
def test_kernel_args_take_the_fp8_instance_only(q_dtype, kv_dtype, head_dim,
                                                ok):
    q = torch.zeros(2, 8, head_dim).to(q_dtype)
    k = torch.zeros(2, 64, 2, head_dim).to(kv_dtype)
    lens = torch.ones(2, dtype=torch.int32)
    if ok:
        DA.check_kernel_args(q, k, k, lens)
    else:
        with pytest.raises(ValueError):
            DA.check_kernel_args(q, k, k, lens)
    # a mixed pair of caches never passes
    with pytest.raises(ValueError):
        DA.check_kernel_args(q, k, k.to(torch.float32), lens)
