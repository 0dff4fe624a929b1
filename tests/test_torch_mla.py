"""The MLA slice of the port (deepseek-v2-lite-16b) against the JAX
reference on the CPU: ``mla_decode_step`` and ``mla_attention`` at the
REDUCED config's widths and at one layer of the FULL width (d 2048, 16
heads, latent rank 512, q/k 128 + 64 wide, v 128), the attention
wrappers' padding of a value head dim below the query's (decode and
flash), ``moe_forward`` at deepseek's 64 experts, top-6, 2 shared, the
model's ``prefill``, the dense prefix block through conversion and
checkpoints, and the entry points' handling of the arch.

Inputs are drawn with numpy (or the reference's ``init_mla``/``init_moe``)
from a seed and handed to both sides; bf16 crosses bit for bit.
Tolerances, as the existing tests state them:
  * layers (``tests/test_torch_layers.py``): fp32 2e-5; bf16 2e-2
    (one bf16 rounding of an O(1) value, and the reference casts the
    softmax weights to bf16 before p @ V where the port keeps them in
    fp32);
  * the full-sequence layer in bf16: 0.15, ``FORWARD_TOL`` of
    ``tests/test_torch_model.py`` (the reference's ``blockwise_attention``
    keeps its accumulator in bf16);
  * padded against unpadded plain versions: ``_same`` of
    ``tests/test_torch_hopper.py`` (fp32 1e-4; bf16 one rounding flip);
    against ``ref.py`` fp32 2e-5, bf16 2e-2;
  * MoE (``tests/test_torch_moe.py``): fp32 2e-5, bf16 5e-2;
  * model logits and caches (``tests/test_torch_model.py``): fp32 1e-4,
    bf16 1e-1 on logits and 5e-2 on the caches of the first two layers,
    ``DEEP_CACHE_TOL`` 0.15 past them.  deepseek REDUCED's bf16 prefill,
    read on the CPU over seeds 0-2: logits 3.9e-2 to 5.5e-2; the prefix
    layer's caches 0; the second layer's 1.6e-2 to 2.9e-2; the third
    layer's 2.3e-2 to 5.1e-2.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402
from torch import nn  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.kernels.decode_attention.ref import \
    decode_attention_ref  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro.layers import attention as JA  # noqa: E402
from repro.layers import moe as JMOE  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.training import checkpoint as JCK  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.convert import (cache_from_jax, map_tree,  # noqa: E402
                                 params_from_jax, to_numpy, to_torch)
from repro_torch.kernels import decode_attention as DA  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.launch import train as TTR  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.launch.train import train_state  # noqa: E402
from repro_torch.layers import attention as TA  # noqa: E402
from repro_torch.layers import moe as TMOE  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.training import checkpoint as TCK  # noqa: E402
from repro_torch.training import optimizer as TO  # noqa: E402

ARCH = "deepseek-v2-lite-16b"
DTYPES = ["float32", "bfloat16"]
LAYER_TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
             "bfloat16": dict(rtol=2e-2, atol=2e-2)}
FORWARD_TOL = {"float32": 2e-5, "bfloat16": 0.15}
MOE_TOL = {"float32": 2e-5, "bfloat16": 5e-2}
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 1e-1}
CACHE_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
DEEP_CACHE_TOL = {"float32": 1e-4, "bfloat16": 0.15}
# (d_model, n_heads, kv_lora_rank, qk_nope, qk_rope, v_head_dim, Smax):
# deepseek REDUCED's MLA, and one layer of the FULL width
WIDTHS = {"reduced": (64, 4, 32, 16, 8, 16, 12),
          "full": (2048, 16, 512, 128, 64, 128, 8)}


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t).astype(np.float32)


def _draw(rng, shape, dtype):
    a = rng.standard_normal(shape).astype(np.float32)
    return a.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else a


def _close(port, ref, tol):
    np.testing.assert_allclose(_np(port), _np(ref), **tol)


def _mla_params(width, dtype, seed=0):
    d, H, r, dn, dr, dv, _ = WIDTHS[width]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tree = jax.device_get(JA.init_mla(jax.random.PRNGKey(seed), d, H, r, dn,
                                      dr, dv, dtype=jdt))
    tp = nn.ParameterDict({k: nn.Parameter(to_torch(v), requires_grad=False)
                           for k, v in tree.items()})
    kw = dict(n_heads=H, kv_lora_rank=r, qk_nope_head_dim=dn,
              qk_rope_head_dim=dr, v_head_dim=dv)
    return {k: jnp.asarray(v) for k, v in tree.items()}, tp, kw


# -- the MLA layer ------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("width", ["reduced", "full"])
@pytest.mark.parametrize("where", ["start", "middle_and_last",
                                   "start_middle_last"])
def test_mla_decode_step_matches_reference(where, width, dtype):
    """Two steps from cache lengths 0, Smax/2 and Smax - 1 (B 1, 2 and
    3): y and both updated caches agree; the second step from Smax - 1
    writes the clamped last slot again and attends to every slot."""
    d, _, r, _, dr, _, smax = WIDTHS[width]
    lens = {"start": [0], "middle_and_last": [smax // 2, smax - 1],
            "start_middle_last": [0, smax // 2, smax - 1]}[where]
    B = len(lens)
    jp, tp, kw = _mla_params(width, dtype)
    rng = np.random.default_rng(B)
    cc, ck = _draw(rng, (B, smax, r), dtype), _draw(rng, (B, smax, dr), dtype)
    jc, jk = jnp.asarray(cc), jnp.asarray(ck)
    tc, tk = to_torch(cc), to_torch(ck)
    lens = np.asarray(lens, np.int32)
    for step in range(2):
        x = _draw(rng, (B, 1, d), dtype)
        jy, jc, jk = JA.mla_decode_step(jp, jnp.asarray(x), jc, jk,
                                        jnp.asarray(lens + step), **kw)
        ty, tc2, tk2 = TA.mla_decode_step(tp, to_torch(x), tc, tk,
                                          to_torch(lens + step), **kw)
        assert tc2 is tc and tk2 is tk              # written in place
        assert ty.dtype == tc.dtype and tuple(ty.shape) == (B, 1, d)
        _close(ty, jy, LAYER_TOL[dtype])
        _close(tc, jc, LAYER_TOL[dtype])
        _close(tk, jk, LAYER_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("width", ["reduced", "full"])
def test_mla_attention_matches_reference(width, dtype):
    d = WIDTHS[width][0]
    jp, tp, kw = _mla_params(width, dtype, seed=1)
    rng = np.random.default_rng(2)
    B, S = 2, 9
    x = _draw(rng, (B, S, d), dtype)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    want = JA.mla_attention(jp, jnp.asarray(x), jnp.asarray(pos), **kw)
    got = TA.mla_attention(tp, to_torch(x), to_torch(pos), **kw)
    assert got.dtype == to_torch(x).dtype and tuple(got.shape) == (B, S, d)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                               atol=FORWARD_TOL[dtype])


def test_mla_decode_step_equals_the_sequence_path():
    """fp32: decoding a sequence token by token into an empty latent
    cache gives the full-sequence layer's outputs."""
    jp, tp, kw = _mla_params("reduced", "float32", seed=3)
    d, smax = WIDTHS["reduced"][0], WIDTHS["reduced"][-1]
    x = to_torch(_draw(np.random.default_rng(3), (2, smax, d), "float32"))
    pos = torch.arange(smax, dtype=torch.int32).expand(2, smax)
    with torch.no_grad():
        full = TA.mla_attention(tp, x, pos, **kw)
        cc = torch.zeros(2, smax, kw["kv_lora_rank"])
        ck = torch.zeros(2, smax, kw["qk_rope_head_dim"])
        steps = [TA.mla_decode_step(tp, x[:, t:t + 1], cc, ck,
                                    torch.full((2,), t, dtype=torch.int32),
                                    **kw)[0] for t in range(smax)]
    torch.testing.assert_close(torch.cat(steps, dim=1), full, rtol=1e-5,
                               atol=1e-5)


# -- the wrappers' padding of Dv < D ------------------------------------------


def _same(got, want, dtype):
    tol = dict(rtol=2.0 ** -7, atol=1e-5) if dtype == "bfloat16" \
        else dict(rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D,Dv,width", [(24, 16, 64), (192, 128, 256)])
def test_decode_pads_v_to_the_width_of_q_and_k(D, Dv, width, dtype):
    """q and k padded from D and v from Dv to one kernel head dim, the
    scale that of the true D, the output sliced back to Dv: the padded
    plain version equals the unpadded one and ``ref.py``."""
    rng = np.random.default_rng(D)
    B, H, smax = 3, 4, 40
    q = _draw(rng, (B, H, D), dtype)
    k = _draw(rng, (B, smax, H, D), dtype)
    v = _draw(rng, (B, smax, H, Dv), dtype)
    lens = np.asarray([1, 17, 40], np.int32)
    seen = []

    def plain(qp, kp, vp, lengths, scale):
        seen.append((qp.shape[-1], kp.shape[-1], vp.shape[-1]))
        assert vp.is_contiguous()
        return DA.decode_attention_plain(qp, kp, vp, lengths, scale)

    targs = [to_torch(a) for a in (q, k, v, lens)]
    out = DA.attend_padded(plain, *targs)
    assert seen == [(width, width, width)]
    assert tuple(out.shape) == (B, H, Dv) and out.is_contiguous()
    _same(out, DA.decode_attention_plain(*targs), dtype)
    want = decode_attention_ref(*(jnp.asarray(a) for a in (q, k, v, lens)))
    _close(out, want, LAYER_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D,Dv,width", [(24, 16, 32), (192, 128, 256)])
def test_flash_pads_v_to_the_width_of_q_and_k(D, Dv, width, dtype):
    """The same for the flash wrapper: out sliced back to Dv, the lse
    that of the unpadded call."""
    rng = np.random.default_rng(D + 1)
    B, S, H = 2, 33, 4
    q = _draw(rng, (B, S, H, D), dtype)
    k = _draw(rng, (B, S, H, D), dtype)
    v = _draw(rng, (B, S, H, Dv), dtype)
    seen = []

    def plain(qp, kp, vp, **kw):
        seen.append((qp.shape[-1], kp.shape[-1], vp.shape[-1]))
        return FA.flash_attention_plain(qp, kp, vp, **kw)

    tq, tk, tv = to_torch(q), to_torch(k), to_torch(v)
    out, lse = FA.attend_padded(plain, tq, tk, tv, causal=True, window=None,
                                q_offset=0)
    want_out, want_lse = FA.flash_attention_plain(tq, tk, tv)
    assert seen == [(width, width, width)]
    assert tuple(out.shape) == (B, S, H, Dv) and out.is_contiguous()
    _same(out, want_out, dtype)
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)
    _close(out, attention_ref(*(jnp.asarray(a) for a in (q, k, v))),
           LAYER_TOL[dtype])


def test_padding_copies_nothing_where_d_and_dv_are_a_kernels():
    q, k, v = torch.randn(1, 2, 128), torch.randn(1, 5, 2, 128), \
        torch.randn(1, 5, 2, 128)
    seen = []
    DA.attend_padded(lambda *a, scale: seen.append(a) or a[0], q, k, v,
                     torch.tensor([5], dtype=torch.int32))
    assert all(a is b for a, b in zip(seen[0], (q, k, v)))


# -- MoE at deepseek's expert counts ------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_forward_at_64_experts_top6_with_2_shared(dtype):
    """deepseek's routing (64 experts, top-6, renormalised gates as in the
    reference) and its 2 shared experts, at a narrow width; every route
    agrees in fp32."""
    cfg = TC.get_config(ARCH)
    E, k, n_shared = cfg.n_routed, cfg.top_k, cfg.n_shared
    assert (E, k, n_shared) == (64, 6, 2)
    d, f = 64, 32
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jp = jax.device_get(JMOE.init_moe(jax.random.PRNGKey(5), d, f, E, k,
                                      n_shared, True, dtype=jdt))
    x = _draw(np.random.default_rng(6), (2, 7, d), dtype)
    want = JMOE.moe_forward(jp, jnp.asarray(x), k)

    def pd(t):
        return nn.ParameterDict({n: nn.Parameter(to_torch(a),
                                                 requires_grad=False)
                                 for n, a in t.items()})
    tp = TMOE.MoEParams(pd({n: a for n, a in jp.items() if n != "shared"}),
                        pd(jp["shared"]))
    assert tuple(tp.shared["w_up"].shape) == (d, f * n_shared)
    tx = to_torch(x)
    with torch.no_grad():
        got = TMOE.moe_forward(tp, tx, k)
        gates, experts = TMOE.route(tp, tx, k)
    logits = np.asarray(x).astype(np.float32) @ np.asarray(jp["router"])
    jvals, jidx = jax.lax.top_k(jnp.asarray(logits), k)
    if dtype == "float32":
        np.testing.assert_array_equal(experts.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(gates.numpy(),
                                   np.asarray(jax.nn.softmax(jvals, -1)),
                                   rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(gates.sum(-1), torch.ones(2, 7))
    err = float(np.abs(_np(got) - _np(want)).max())
    assert err <= MOE_TOL[dtype], f"max abs err {err:.3e}"


# -- the model ----------------------------------------------------------------


def _models(dtype, seed=0):
    jcfg = dataclasses.replace(JC.get_reduced(ARCH), dtype=dtype)
    tcfg = dataclasses.replace(TC.get_reduced(ARCH), dtype=dtype)
    jparams = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    tparams = params_from_jax(jax.device_get(jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def test_deepseek_is_supported_with_its_prefix_block():
    """MLA and ``first_k_dense`` pass ``check_supported``; the prefix
    block holds a dense MLP of ``d_ff_dense_first`` and no R axis, the
    scanned blocks MoE FFNs; a prefix as deep as the model raises, as in
    the reference."""
    full = TC.get_config(ARCH)
    TT.check_supported(full)
    assert (full.attn_kind, full.first_k_dense, full.block_repeat) == \
        ("mla", 1, 27)
    cfg = TC.get_reduced(ARCH)
    params = TT.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    assert len(params.prefix) == cfg.first_k_dense
    assert len(params.blocks) == cfg.block_repeat - cfg.first_k_dense
    pre, blk = params.prefix[0]["l0"], params.blocks[0]["l0"]
    assert "router" not in pre.ffn and "router" in blk.ffn
    assert tuple(pre.ffn["w_up"].shape) == (cfg.d_model,
                                            cfg.d_ff_dense_first)
    assert tuple(pre.attn["wukv"].shape) == (
        cfg.kv_lora_rank,
        cfg.n_heads * (cfg.qk_nope_head_dim + cfg.v_head_dim))
    cache = TT.init_cache(cfg, 2, 10, device="cpu")
    assert tuple(cache["prefix"][0]["l0"]["c_kv"].shape) == \
        (2, 10, cfg.kv_lora_rank)
    assert tuple(cache["blocks"]["l0"]["k_pe"].shape) == \
        (cfg.block_repeat - 1, 2, 10, cfg.qk_rope_head_dim)
    with pytest.raises(ValueError, match="first_k_dense"):
        TT.init_params(torch.Generator().manual_seed(0),
                       dataclasses.replace(cfg, first_k_dense=3),
                       device="cpu")


def test_a_missing_prefix_block_raises():
    """``decode_step`` and ``forward`` refuse a cache or parameters that
    lack the prefix blocks, rather than skip the dense first layer."""
    cfg = TC.get_reduced(ARCH)
    params = TT.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    cache = TT.init_cache(cfg, 1, 8, device="cpu")
    tok = torch.zeros(1, 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="prefix"):
        TT.decode_step(params, cfg, tok, dict(cache, prefix=[]))
    del cache["prefix"]
    with pytest.raises(ValueError, match="prefix"):
        TT.decode_step(params, cfg, tok, cache)
    params.prefix = None
    with pytest.raises(ValueError, match="prefix"):
        TT.forward(params, cfg, tok)


@pytest.mark.parametrize("dtype", DTYPES)
def test_deepseek_prefill_matches_reference(dtype):
    jcfg, tcfg, jparams, tparams = _models(dtype)
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
    assert len(ported["prefix"]) == len(tc["prefix"]) == 1
    # layer 1 (the prefix), layer 2 (block 0), layer 3 (block 1)
    for mine, theirs, tol in (
            (tc["prefix"][0]["l0"], ported["prefix"][0]["l0"], CACHE_TOL),
            ({n: t[0] for n, t in tc["blocks"]["l0"].items()},
             {n: t[0] for n, t in ported["blocks"]["l0"].items()},
             CACHE_TOL),
            ({n: t[1] for n, t in tc["blocks"]["l0"].items()},
             {n: t[1] for n, t in ported["blocks"]["l0"].items()},
             DEEP_CACHE_TOL)):
        for name in ("c_kv", "k_pe"):
            np.testing.assert_allclose(_np(mine[name]), _np(theirs[name]),
                                       rtol=0, atol=tol[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_deepseek_checkpoints_cross_between_packages(tmp_path, dtype):
    """A port checkpoint of deepseek REDUCED's train state (the prefix
    block a list, the router fp32) restores through the reference's
    manager bit for bit, and a reference checkpoint through the port's."""
    jcfg, tcfg, jp, tp = _models(dtype, seed=3)
    jo, to = JO.adamw_init(jp), TO.adamw_init(tp)
    TCK.CheckpointManager(str(tmp_path / "port")).save(
        5, train_state(tp, to))
    step, (rp, ro), _ = JCK.CheckpointManager(
        str(tmp_path / "port")).restore((jp, jo))
    assert step == 5
    for want, got in ((jp, rp), (jo.master, ro.master), (jo.m, ro.m)):
        for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(np.asarray(a).view(np.uint8),
                                          np.asarray(b).view(np.uint8))
    JCK.CheckpointManager(str(tmp_path / "jax")).save(6, (jp, jo))
    step, state, _ = TCK.CheckpointManager(str(tmp_path / "jax")).restore(
        train_state(tp, to))
    assert step == 6 and isinstance(state[0]["prefix"], list)
    back = map_tree(to_numpy, state[0])
    flat = jax.tree_util.tree_flatten_with_path(jax.device_get(jp))[0]
    assert any(getattr(p[0], "key", None) == "prefix" for p, _ in flat)
    for path, want in flat:
        got = back
        for p in path:
            got = got[getattr(p, "key", getattr(p, "idx", None))]
        np.testing.assert_array_equal(got.view(np.uint8),
                                      np.asarray(want).view(np.uint8))


def test_deepseek_serves_through_the_padded_route(monkeypatch):
    """deepseek REDUCED served in fp32 with the decode wrapper's padding
    taking the kernel's place (q/k 24 and v 16 wide, both padded to 64):
    the same tokens as the plain route."""
    cfg = dataclasses.replace(TC.get_reduced(ARCH), dtype="float32")
    params = TT.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    reqs = [dict(rid=i, arrival=0.0, prompt=list(range(3 + i, 12 + 2 * i)),
                 gen_len=5) for i in range(4)]

    def run():
        from repro_torch.serving.engine import ServingEngine
        eng = ServingEngine(cfg, params, device="cpu", max_batch=3,
                            max_len=32)
        rep = eng.run([dict(r) for r in reqs], time_scale=0.0)
        return {r.rid: r.tokens for r in rep.results}

    tokens = run()
    seen = []
    plain = DA.decode_attention_plain

    def decode(q, k, v, lengths):
        def kernel(qp, kp, vp, lens, scale):
            seen.append((qp.shape[-1], vp.shape[-1]))
            return plain(qp, kp, vp, lens, scale)
        return DA.attend_padded(kernel, q, k, v, lengths)

    monkeypatch.setattr(DA, "decode_attention", decode)
    assert run() == tokens
    assert set(seen) == {(64, 64)}


def test_serve_entry_point_runs_deepseek_and_keeps_its_prefix():
    """``launch.serve`` at reduced size on the CPU, at all 3 layers and cut
    to 2 (the prefix block and one MoE block); a cut that would keep only
    the prefix raises."""
    for depth in (None, 2):
        lines = []
        report, reqs = serve(arch=ARCH, size="reduced", requests=3,
                             max_batch=2, max_len=32, prompt_cap=8,
                             gen_cap=4, seed=0, device="cpu",
                             log=lines.append, depth=depth)
        want = {r["rid"]: max(r["gen_len"], 2) for r in reqs}
        assert {r.rid: len(r.tokens) for r in report.results} == want
        assert "deepseek-v2-lite-reduced" in lines[0]
    with pytest.raises(ValueError, match="prefix"):
        serve(arch=ARCH, size="reduced", requests=1, device="cpu",
              log=lambda s: None, depth=1)


def test_training_an_mla_model_is_refused():
    """MLA trains since the zamba2 slice (tests/test_torch_mla_train.py);
    what ``launch.train`` still refuses is a depth that keeps no block
    past the dense prefix, as ``launch.serve`` does."""
    with pytest.raises(ValueError, match="prefix"):
        TTR.train(ARCH, steps=1, batch=2, seq=8, device="cpu", depth=1)
