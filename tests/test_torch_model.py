"""The port's decoders against the JAX reference on the REDUCED
qwen2-0.5b, internlm2-1.8b, qwen1.5-32b, mixtral-8x7b (a MoE FFN and
sliding-window ring caches: window 16, a ring of 32 slots), gemma3-12b
(blocks of two window-16 layers and one global layer: rings of 32 slots
beside full caches, tied embeddings, head dim 24) and
deepseek-v2-lite-16b configs (MLA over latent caches, q/k 24 and v 16
wide; a dense prefix block before two MoE blocks of 8 experts, top-2,
one shared), on the CPU, with the reference's weights carried across by
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

import contextlib
import dataclasses
from unittest import mock

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
from repro_torch.layers import moe as TMoE  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.config import EncoderConfig  # noqa: E402

ARCHS = ["qwen2-0.5b", "internlm2-1.8b", "qwen1.5-32b", "mixtral-8x7b",
         "gemma3-12b", "deepseek-v2-lite-16b"]
DTYPES = ["float32", "bfloat16"]
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 1e-1}
CACHE_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
FORWARD_TOL = {"float32": 1e-4, "bfloat16": 0.15}
# gemma3 REDUCED's caches after a 40-token bf16 prefill, every slot of
# both blocks (six layers where the others have two): read on the CPU
# over seeds 0-2, at most 6.3e-2 / 8.1e-2 / 5.5e-2 in the first block's
# first layer (CACHE_TOL's 5e-2 covers two layers) and 0.111 in the
# second block; logits at most 5.1e-2, within LOGIT_TOL.
DEEP_CACHE_TOL = {"float32": 1e-4, "bfloat16": 0.15}


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


def _assert_caches_close(tcache, jcache, atol):
    """Every K/V (MLA: latent and RoPE key) leaf of the scanned blocks'
    first slot and of the prefix blocks' caches."""
    jc = jax.device_get(jcache)
    pairs = [(tcache["blocks"]["l0"], jc["blocks"]["l0"])] + [
        (t["l0"], j["l0"]) for t, j in zip(tcache.get("prefix", []),
                                           jc.get("prefix", []))]
    assert len(pairs) == 1 + len(jc.get("prefix", []))
    for tl, jl in pairs:
        assert set(tl) == set(jl)
        for name in tl:
            np.testing.assert_allclose(_np(tl[name]), _np(jl[name]), rtol=0,
                                       atol=atol)


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
    assert set(tc) == set(jc)
    jblocks = [jc["blocks"]] + list(jc.get("prefix", []))
    tblocks = [tc["blocks"]] + list(tc.get("prefix", []))
    assert len(tblocks) == len(jblocks)
    for jb, tb in zip(jblocks, tblocks):
        assert set(tb) == set(jb)
        for slot, lc in jb.items():
            assert set(tb[slot]) == set(lc)
            for name, a in lc.items():
                t = tb[slot][name]
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
    _assert_caches_close(tcache, jcache, CACHE_TOL[dtype])


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


@pytest.mark.parametrize("dtype", DTYPES)
def test_gemma3_prefill_past_the_rings_matches_reference(dtype):
    """gemma3 REDUCED: 40 prompt tokens into the rings of 32 slots of its
    window-16 layers (``max_len`` 64) beside the global layers' full
    caches of 64, so the rings wrap during the replay."""
    jcfg, tcfg, jparams, tparams = _models("gemma3-12b", dtype)
    rng = np.random.default_rng(12)
    toks = rng.integers(0, jcfg.vocab_size, size=(2, 40)).astype(np.int32)
    lens = np.array([40, 35], np.int32)
    jl, jc = JT.prefill(jparams, jcfg, jnp.asarray(toks), 64,
                        lengths=jnp.asarray(lens))
    tl, tc = TT.prefill(tparams, tcfg, torch.from_numpy(toks), 64,
                        lengths=torch.from_numpy(lens))
    assert [tc["blocks"][f"l{i}"]["k"].shape[2] for i in range(3)] == \
        [32, 32, 64]
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=0,
                               atol=LOGIT_TOL[dtype])
    ported = cache_from_jax(jax.device_get(jc))
    for slot in ("l0", "l1", "l2"):
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(tc["blocks"][slot][name]),
                                       _np(ported["blocks"][slot][name]),
                                       rtol=0, atol=DEEP_CACHE_TOL[dtype])


def test_gemma3_block_of_mixed_windows_is_supported():
    """A block of attention layers with their own windows passes
    ``check_supported``, and ``init_cache`` gives each slot its own cache:
    a ring of ``ring_size(window)`` slots for a windowed layer (up to
    ``max_len``), ``max_len`` slots for a global one (FULL: 1040 and
    4096 slots at ``max_len`` 4096)."""
    full = TC.get_config("gemma3-12b")
    TT.check_supported(full)
    assert [s.window for s in full.block_pattern] == [1024] * 5 + [None]
    assert TT.ring_size(1024) == 1040
    small = dataclasses.replace(full, d_model=32, vocab_size=16,
                                n_heads=2, n_kv_heads=1, head_dim=4,
                                d_ff=8, block_repeat=2)
    for max_len, want in ((4096, [1040] * 5 + [4096]),
                          (512, [512] * 6)):
        cache = TT.init_cache(small, 3, max_len, device="cpu")
        assert list(cache["blocks"]) == [f"l{i}" for i in range(6)]
        for i, n in enumerate(want):
            for name in ("k", "v"):
                assert tuple(cache["blocks"][f"l{i}"][name].shape) == \
                    (2, 3, n, 1, 4)


def test_gemma3_params_from_jax_are_bit_exact_and_tied():
    """The reference's gemma3 tree (tied embeddings: no ``head``; six
    layers a block) reaches the port bit for bit in bf16."""
    jcfg, tcfg, jparams, tparams = _models("gemma3-12b", "bfloat16")
    tree = jax.device_get(jparams)
    assert "head" not in tree and tparams.head is None
    np.testing.assert_array_equal(tparams.embed.view(torch.int16).numpy(),
                                  np.asarray(tree["embed"]).view(np.int16))
    for r, blk in enumerate(tparams.blocks):
        assert list(blk) == [f"l{i}" for i in range(3)]
        for i in range(3):
            lt = tree["blocks"][f"l{i}"]
            for got, want in ((blk[f"l{i}"].attn["wk"], lt["attn"]["wk"]),
                              (blk[f"l{i}"].ffn["w_down"],
                               lt["ffn"]["w_down"]),
                              (blk[f"l{i}"].norm2, lt["norm2"])):
                np.testing.assert_array_equal(
                    got.view(torch.int16).numpy(),
                    np.asarray(want)[r].view(np.int16))


def test_moe_gqa_decoders_are_supported():
    """A MoE FFN under GQA attention is ported (mixtral, and a dense
    config given a MoE FFN), also beside M-RoPE or cross-attention; MoE
    beside shared attention still raises."""
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
        for change in (dict(rope="mrope"), dict(cross_attn=True)):
            moe = dataclasses.replace(cfg, **change)
            p = TT.init_params(torch.Generator().manual_seed(0), moe,
                               device="cpu")
            c = TT.init_cache(moe, 1, 8, device="cpu", source_len=3)
            logits, _ = TT.decode_step(p, moe, torch.zeros(
                1, 1, dtype=torch.int32), c)
            assert bool(torch.isfinite(logits).all())
        with pytest.raises(NotImplementedError):
            TT.init_cache(dataclasses.replace(cfg, shared_attn=True), 1, 8)


def test_unported_families_raise():
    cfg = TC.get_reduced("qwen2-0.5b")
    for change in (dict(ffn_kind="none"), dict(shared_attn=True),
                   dict(shared_attn=True, rope="mrope")):
        with pytest.raises(NotImplementedError):
            TT.init_cache(dataclasses.replace(cfg, **change), 1, 8)
        with pytest.raises(NotImplementedError):
            TT.init_params(torch.Generator(),
                           dataclasses.replace(cfg, **change))


@pytest.mark.parametrize("change", [
    dict(rope="mrope"), dict(embeds_input=True), dict(cross_attn=True),
    dict(encoder=EncoderConfig(1, 56, 7, 64))])
def test_families_ported_since_run_on_tokens_and_embeds(change):
    """M-RoPE, embedding inputs, cross-attention and an encoder config
    were refused before the qwen2-vl and seamless slice: a decoder with
    one of them now decodes from token ids and from embeddings, and
    prefills from embeddings unless it has cross-attention (which
    prefills through ``encdec_prefill``, as in the reference).  Without
    a filled cross cache cross-attention adds nothing, as the
    reference's softmax over no source tokens does."""
    cfg = dataclasses.replace(TC.get_reduced("qwen2-0.5b"), **change)
    params = TT.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    cache = TT.init_cache(cfg, 1, 8, device="cpu")
    toks = torch.zeros(1, 1, dtype=torch.int32)
    emb = torch.randn(1, 1, cfg.d_model, generator=torch.Generator())
    for embeds in (None, emb):
        logits, cache = TT.decode_step(params, cfg, toks, cache,
                                       embeds=embeds)
        assert tuple(logits.shape) == (1, cfg.vocab_size)
        assert bool(torch.isfinite(logits).all())
    if cfg.cross_attn:
        with pytest.raises(ValueError, match="encdec_prefill"):
            TT.prefill(params, cfg, toks, 8, embeds=emb)
        plain = dataclasses.replace(cfg, cross_attn=False)
        x = torch.randn(1, 5, cfg.d_model)
        with torch.no_grad():
            got = TT.forward(params, cfg, embeds=x)
            # the same layers without the cross-attention call
            want = TT.forward(params, plain, embeds=x)
        assert torch.equal(got, want)
    else:
        last, pc = TT.prefill(params, cfg, toks, 8, embeds=emb)
        assert torch.equal(last, TT.decode_step(
            params, cfg, toks, TT.init_cache(cfg, 1, 8, device="cpu"),
            embeds=emb)[0])
        assert pc["len"].tolist() == [1]


# A router near-tie: a token's reference margin between its k-th and
# (k+1)-th router logits below this may pick other experts in the port.
# In bf16 the two frameworks' hidden states round apart layer by layer, and
# their fp32 router logits differ by up to 4.0e-2 (deepseek REDUCED) and
# 2.9e-2 (mixtral REDUCED) over 2 x 37 tokens at seed 0; the one token
# that picks other experts (deepseek, (1, 28) of the second MoE layer) has
# a margin of 9.6e-3, the next-closest token 1.7e-2.
ROUTE_TIE = 2e-2
# Arches whose bf16 forward meets such a near-tie at seed 0: the other
# experts move that row's logits by 0.83, so the port takes the
# reference's routes there (``_recorded_routes``).
NEAR_TIE_ARCHS = ("deepseek-v2-lite-16b",)


@contextlib.contextmanager
def _recorded_routes():
    """Inside: each ``jax.lax.top_k`` the reference traces also records,
    through an ordered ``jax.debug.callback``, its router logits and the
    experts it picked, so the reference keeps jit, ``lax.scan`` and remat.
    The port's MoE layers then take those experts in order, gated by the
    softmax of the port's own router logits at them, after checking that
    the port's own top-k (``layers.moe.route``) picks the same experts at
    every token but those of a near-tie (``ROUTE_TIE``).  Yields the
    routes not yet taken and the count of tokens that picked others."""
    routes, flips = [], []
    top_k, route = jax.lax.top_k, TMoE.route

    def recording(x, k):
        vals, idx = top_k(x, k)
        jax.debug.callback(
            lambda l, i: routes.append((np.array(l), np.array(i))),
            x, idx, ordered=True)
        return vals, idx

    def replaying(params, x, top_k, router_noise=None):
        logits, experts = (torch.from_numpy(a) for a in routes.pop(0))
        experts = experts.long()
        _, own = route(params, x, top_k, router_noise)
        same = (own.sort(-1).values == experts.sort(-1).values).all(-1)
        ranked = logits.sort(-1, descending=True).values
        tie = ranked[..., top_k - 1] - ranked[..., top_k] < ROUTE_TIE
        assert bool((same | tie).all()), "other experts away from a tie"
        flips.append(int((~same).sum()))
        own_logits = x.float() @ params["router"]
        return own_logits.gather(-1, experts).softmax(-1), experts

    with mock.patch.object(jax.lax, "top_k", recording), \
            mock.patch.object(TMoE, "route", replaying):
        yield routes, flips


_jax_forward = jax.jit(JT.forward, static_argnums=(1,),
                       static_argnames=("remat", "return_hidden"))


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, dtype, remat):
    """Each framework picks its own MoE routes, except deepseek in bf16
    (``NEAR_TIE_ARCHS``), where the port takes the reference's and checks
    that its own differ only at near-ties (``_recorded_routes``)."""
    jcfg, tcfg, jparams, tparams = _models(arch, dtype)
    toks = np.random.default_rng(9).integers(
        0, jcfg.vocab_size, size=(2, 37)).astype(np.int32)
    replay = arch in NEAR_TIE_ARCHS and dtype == "bfloat16"
    for hidden in (False, True):
        if replay:
            with _recorded_routes() as (routes, flips):
                # a fresh function: no trace cached without the callbacks
                jout = jax.jit(lambda p, t: JT.forward(
                    p, jcfg, t, remat=remat, return_hidden=hidden))(
                        jparams, jnp.asarray(toks))
                jax.effects_barrier()
                tout = TT.forward(tparams, tcfg, torch.from_numpy(toks),
                                  remat=remat, return_hidden=hidden)
            assert routes == [] and len(flips) == jcfg.n_layers - \
                jcfg.first_k_dense        # every MoE layer was replayed
        else:
            jout = _jax_forward(jparams, jcfg, jnp.asarray(toks),
                                remat=remat, return_hidden=hidden)
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
        for p in path:      # a dict key, or the index in the prefix list
            got = got[getattr(p, "key", getattr(p, "idx", None))]
        want = np.asarray(want)
        if want.dtype == ml_dtypes.bfloat16:   # not mixtral's fp32 router
            assert got.dtype == np.uint16
            got = got.view(ml_dtypes.bfloat16)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.uint8),
                                      want.view(np.uint8))


def _loss_and_grads(tparams, tcfg, toks, remat):
    tparams.zero_grad(set_to_none=True)
    logits = TT.forward(tparams, tcfg, toks, remat=remat)
    loss = logits.float().logsumexp(-1).mean()
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone()
                         for n, p in tparams.named_parameters()}


def test_nested_remat_keeps_loss_and_grads_of_gemma3():
    """gemma3 REDUCED in fp32: ``remat=True`` (a checkpoint per block and
    one per layer inside it) gives the loss and every gradient of
    ``remat=False`` (the recomputation runs the same kernels on the same
    inputs)."""
    _, tcfg, _, tparams = _models("gemma3-12b", "float32")
    toks = torch.from_numpy(np.random.default_rng(13).integers(
        0, tcfg.vocab_size, size=(2, 37)).astype(np.int32))
    loss0, grads0 = _loss_and_grads(tparams, tcfg, toks, remat=False)
    loss1, grads1 = _loss_and_grads(tparams, tcfg, toks, remat=True)
    assert loss0 == loss1
    assert set(grads0) == set(grads1)
    for name, g in grads0.items():
        torch.testing.assert_close(grads1[name], g, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("arch,per_block", [("gemma3-12b", 3 + 1),
                                            ("qwen2-0.5b", 1)])
def test_remat_checkpoints_each_layer_of_a_multi_layer_block(
        arch, per_block, monkeypatch):
    """Under ``remat`` a block of several layers takes one checkpoint per
    layer plus one for the block, as the reference's ``nest_remat``; a
    single-layer block takes one checkpoint.  Without ``remat`` none."""
    _, tcfg, _, tparams = _models(arch, "float32")
    seen = []
    real = TT.checkpoint

    def counting(fn, *args, **kw):
        seen.append(fn.__name__)
        return real(fn, *args, **kw)

    monkeypatch.setattr(TT, "checkpoint", counting)
    toks = torch.zeros(1, 5, dtype=torch.int32)
    TT.forward(tparams, tcfg, toks, remat=False)
    assert seen == []
    TT.forward(tparams, tcfg, toks, remat=True)
    R, n = tcfg.block_repeat, len(tcfg.block_pattern)
    assert len(seen) == R * per_block
    assert seen.count("_block_apply") == R
    assert seen.count("_layer_apply") == (R * n if n > 1 else 0)
