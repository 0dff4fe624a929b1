"""The port's GQA decoders against the JAX reference on the REDUCED
qwen2-0.5b, internlm2-1.8b, qwen1.5-32b and mixtral-8x7b configs (the
last with a MoE FFN and sliding-window ring caches: window 16, a ring of
32 slots), on the CPU, with the reference's weights carried across by
``convert.params_from_jax``.

Tolerances on logits after several decode steps (2 layers each):
  * fp32: 1e-4 (summation order differs between XLA and torch matmuls,
    and the reference's softmax over Smax slots against the port's
    masked softmax over the valid ones).
  * bf16: 1e-1 on logits and 5e-2 on the caches' K/V rows.  Measured on
    the CPU over these three configs, seeds 0-2 and 6 steps: at most
    6.1e-2 on logits (qwen2-0.5b, seed 0) and 3.1e-2 on K/V.  The
    reference rounds the attention weights to bf16 before p @ V where the
    port keeps them in fp32, and bf16 matmuls round at other places in
    the two frameworks.

``forward`` (the full sequence, 37 tokens, 2 layers): fp32 1e-4 on
logits and hidden states (read: at most 5.2e-6 over the three configs,
seeds 0-2); bf16 0.15 (read: logits at most 8.6e-2, hidden states
5.9e-2).  The reference's ``blockwise_attention`` keeps its accumulator
in bf16 and rounds p to bf16 before p @ V; the port's flash kernel and
its plain version keep both in fp32.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.convert import (cache_from_jax, params_from_jax,  # noqa
                                 params_to_numpy)
from repro_torch.models import transformer as TT  # noqa: E402

ARCHS = ["qwen2-0.5b", "internlm2-1.8b", "qwen1.5-32b", "mixtral-8x7b"]
DTYPES = ["float32", "bfloat16"]
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 1e-1}
CACHE_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
FORWARD_TOL = {"float32": 1e-4, "bfloat16": 0.15}


def _configs(arch, dtype):
    return (dataclasses.replace(JC.get_reduced(arch), dtype=dtype),
            dataclasses.replace(TC.get_reduced(arch), dtype=dtype))


def _models(arch, dtype, seed=0):
    jcfg, tcfg = _configs(arch, dtype)
    jparams = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    tparams = params_from_jax(jax.device_get(jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t).astype(np.float32)


def test_port_configs_equal_reference():
    for arch in ARCHS:
        for get in ("get_config", "get_reduced"):
            j = dataclasses.asdict(getattr(JC, get)(arch))
            t = dataclasses.asdict(getattr(TC, get)(arch))
            assert j == t, (arch, get)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_reference(arch, dtype):
    jcfg, tcfg = _configs(arch, dtype)
    jc = JT.init_cache(jcfg, 3, 24)
    tc = TT.init_cache(tcfg, 3, 24, device="cpu")
    assert set(tc["blocks"]) == set(jc["blocks"])
    for slot, lc in jc["blocks"].items():
        assert set(tc["blocks"][slot]) == set(lc)
        for name, a in lc.items():
            t = tc["blocks"][slot][name]
            assert tuple(t.shape) == a.shape
            assert str(t.dtype).split(".")[-1] == str(a.dtype)
            assert not t.any()
    assert tc["len"].dtype == torch.int32 and tuple(tc["len"].shape) == (3,)


def test_params_from_jax_is_bit_exact_in_bf16():
    jcfg, tcfg, jparams, tparams = _models("qwen2-0.5b", "bfloat16")
    tree = jax.device_get(jparams)
    assert tparams.embed.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tparams.embed.view(torch.int16).numpy(),
        np.asarray(tree["embed"]).view(np.int16))
    wq = tree["blocks"]["l0"]["attn"]["wq"]
    for r, blk in enumerate(tparams.blocks):
        np.testing.assert_array_equal(
            blk["l0"].attn["wq"].view(torch.int16).numpy(),
            np.asarray(wq)[r].view(np.int16))
    assert tparams.head is None                    # tied embeddings


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_logits_match_reference(arch, dtype):
    jcfg, tcfg, jparams, tparams = _models(arch, dtype)
    B, max_len, steps = 2, 16, 6
    jstep = jax.jit(lambda p, t, c: JT.decode_step(p, jcfg, t, c))
    jcache = JT.init_cache(jcfg, B, max_len)
    tcache = TT.init_cache(tcfg, B, max_len, device="cpu")
    rng = np.random.default_rng(7)
    for _ in range(steps):
        toks = rng.integers(0, jcfg.vocab_size, size=(B, 1)).astype(np.int32)
        jl, jcache = jstep(jparams, jnp.asarray(toks), jcache)
        tl, tcache = TT.decode_step(tparams, tcfg, torch.from_numpy(toks),
                                    tcache)
        assert tuple(tl.shape) == (B, jcfg.vocab_size)
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=0,
                                   atol=LOGIT_TOL[dtype])
    np.testing.assert_array_equal(tcache["len"].numpy(),
                                  np.asarray(jcache["len"]))
    for name in ("k", "v"):
        np.testing.assert_allclose(
            _np(tcache["blocks"]["l0"][name]),
            _np(jcache["blocks"]["l0"][name]), rtol=0,
            atol=CACHE_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_matches_reference(dtype):
    jcfg, tcfg, jparams, tparams = _models("qwen2-0.5b", dtype)
    rng = np.random.default_rng(8)
    toks = rng.integers(0, jcfg.vocab_size, size=(2, 7)).astype(np.int32)
    lens = np.array([7, 4], np.int32)
    jl, jc = JT.prefill(jparams, jcfg, jnp.asarray(toks), 16,
                        lengths=jnp.asarray(lens))
    tl, tc = TT.prefill(tparams, tcfg, torch.from_numpy(toks), 16,
                        lengths=torch.from_numpy(lens))
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=0,
                               atol=LOGIT_TOL[dtype])
    np.testing.assert_array_equal(tc["len"].numpy(), lens)
    ported = cache_from_jax(jax.device_get(jc))
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc["blocks"]["l0"][name]),
                                   _np(ported["blocks"]["l0"][name]),
                                   rtol=0, atol=CACHE_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_past_the_ring_matches_reference(dtype):
    """mixtral REDUCED: 40 prompt tokens into a ring of 32 slots (window
    16, ``max_len`` 64), so the ring wraps during the replay."""
    jcfg, tcfg, jparams, tparams = _models("mixtral-8x7b", dtype)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, jcfg.vocab_size, size=(2, 40)).astype(np.int32)
    lens = np.array([40, 35], np.int32)
    jl, jc = JT.prefill(jparams, jcfg, jnp.asarray(toks), 64,
                        lengths=jnp.asarray(lens))
    tl, tc = TT.prefill(tparams, tcfg, torch.from_numpy(toks), 64,
                        lengths=torch.from_numpy(lens))
    assert tc["blocks"]["l0"]["k"].shape[2] == 32
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=0,
                               atol=LOGIT_TOL[dtype])
    ported = cache_from_jax(jax.device_get(jc))
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc["blocks"]["l0"][name]),
                                   _np(ported["blocks"]["l0"][name]),
                                   rtol=0, atol=CACHE_TOL[dtype])


def test_moe_gqa_decoders_are_supported():
    """A MoE FFN under GQA attention is ported (mixtral, and a dense
    config given a MoE FFN); MoE beside MLA, first-k-dense prefixes or
    shared attention still raises."""
    for cfg in (TC.get_reduced("mixtral-8x7b"),
                dataclasses.replace(TC.get_reduced("qwen2-0.5b"),
                                    ffn_kind="moe", n_routed=4, top_k=2,
                                    d_ff_expert=32)):
        params = TT.init_params(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
        cache = TT.init_cache(cfg, 1, 8, device="cpu")
        logits, _ = TT.decode_step(params, cfg,
                                   torch.zeros(1, 1, dtype=torch.int32),
                                   cache)
        assert tuple(logits.shape) == (1, cfg.vocab_size)
        assert bool(torch.isfinite(logits).all())
        for change in (dict(attn_kind="mla"), dict(first_k_dense=1),
                       dict(shared_attn=True)):
            with pytest.raises(NotImplementedError):
                TT.init_cache(dataclasses.replace(cfg, **change), 1, 8)


def test_unported_families_raise():
    cfg = TC.get_reduced("qwen2-0.5b")
    for change in (dict(attn_kind="mla"), dict(ffn_kind="none"),
                   dict(shared_attn=True), dict(first_k_dense=1),
                   dict(embeds_input=True), dict(rope="mrope")):
        with pytest.raises(NotImplementedError):
            TT.init_cache(dataclasses.replace(cfg, **change), 1, 8)
    params = TT.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    cache = TT.init_cache(cfg, 1, 8, device="cpu")
    toks = torch.zeros(1, 1, dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        TT.decode_step(params, cfg, toks, cache,
                       embeds=torch.zeros(1, 1, cfg.d_model))
    with pytest.raises(NotImplementedError):
        TT.prefill(params, cfg, toks, 8, embeds=torch.zeros(1, 1, 56))


_jax_forward = jax.jit(JT.forward, static_argnums=(1,),
                       static_argnames=("remat", "return_hidden"))


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, dtype, remat):
    jcfg, tcfg, jparams, tparams = _models(arch, dtype)
    toks = np.random.default_rng(9).integers(
        0, jcfg.vocab_size, size=(2, 37)).astype(np.int32)
    for hidden in (False, True):
        jout = _jax_forward(jparams, jcfg, jnp.asarray(toks), remat=remat,
                            return_hidden=hidden)
        tout = TT.forward(tparams, tcfg, torch.from_numpy(toks),
                          remat=remat, return_hidden=hidden)
        width = jcfg.d_model if hidden else jcfg.vocab_size
        assert tuple(tout.shape) == (2, 37, width)
        assert str(tout.dtype).split(".")[-1] == dtype
        np.testing.assert_allclose(_np(tout.detach()), _np(jout), rtol=0,
                                   atol=FORWARD_TOL[dtype])


def test_forward_last_logits_equal_prefill():
    """The flash path and the decode-attention token replay give the
    same last-position logits (fp32: summation order only)."""
    _, tcfg, _, tparams = _models("qwen2-0.5b", "float32")
    toks = torch.from_numpy(np.random.default_rng(10).integers(
        0, tcfg.vocab_size, size=(2, 11)).astype(np.int32))
    with torch.no_grad():
        full = TT.forward(tparams, tcfg, toks)
    last, _ = TT.prefill(tparams, tcfg, toks, 16)
    np.testing.assert_allclose(full[:, -1].numpy(), last.numpy(), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_params_to_numpy_round_trips_bit_for_bit(arch, dtype):
    jcfg, tcfg, jparams, tparams = _models(arch, dtype)
    tree = jax.device_get(jparams)
    back = params_to_numpy(tparams, tcfg)
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    assert len(jax.tree.leaves(back)) == len(flat)
    for path, want in flat:
        got = back
        for p in path:
            got = got[p.key]
        want = np.asarray(want)
        if want.dtype == ml_dtypes.bfloat16:   # not mixtral's fp32 router
            assert got.dtype == np.uint16
            got = got.view(ml_dtypes.bfloat16)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.uint8),
                                      want.view(np.uint8))
