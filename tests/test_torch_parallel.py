"""The port's parallel layer against the JAX reference, in one process on
the CPU: int8 gradient compression, the EP bucketing and MoE dispatch,
sequence-parallel decode and the GPipe pipeline at one gloo rank against
the reference's ``shard_map`` functions on a (1, 1) mesh, the bucketing's
drops against a per-expert count written out, the sharding rules of
every registry config at FULL size, and head padding.

Tolerances: fp32 2e-5 where both sides compute the same arithmetic in
another order (EP, SP decode, pipeline); bit-equality where they must
agree exactly (the compression scale, the bucketing, the specs, the
padded weights).  Compression's unbiasedness and error bound are the
reference's own tests (``tests/test_training.py``).  Padding holds the
padded logits, fp32, to the unpadded ones at 1e-5 for MHA, and for GQA,
where the reference's padding is not exact, to the reference's padded
logits at 1e-5 (read: 2.7e-6; both move 6.06 from the unpadded logits).
"""

import dataclasses
import datetime
import types

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402
from hypothesis import given, settings  # noqa: E402
import hypothesis.strategies as st  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.layers import moe as JMoE  # noqa: E402
from repro.models import encdec as JE  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.parallel import ep as JEP  # noqa: E402
from repro.parallel import padding as JPad  # noqa: E402
from repro.parallel import pipeline as JPipe  # noqa: E402
from repro.parallel import sharding as JS  # noqa: E402
from repro.parallel import sp_decode as JSP  # noqa: E402
from repro.training import compress as JC8  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.convert import (jax_path, map_tree,  # noqa: E402
                                 params_from_jax, params_to_numpy)
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.layers.moe import MoEParams  # noqa: E402
from repro_torch.models import encdec as TE  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.parallel import ep as TEP  # noqa: E402
from repro_torch.parallel import padding as TPad  # noqa: E402
from repro_torch.parallel import pipeline as TPipe  # noqa: E402
from repro_torch.parallel import sharding as TS  # noqa: E402
from repro_torch.parallel import sp_decode as TSP  # noqa: E402
from repro_torch.training import compress as TC8  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
# fp32 router logits of the two frameworks agree to ~1e-6; the EP inputs
# keep every token's k-th and (k+1)-th logits further apart than this
ROUTE_MARGIN = 1e-4


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A gloo process group of one rank (FileStore rendezvous, 60 s
    timeout) for the module; ``make_mesh`` builds CPU meshes on it."""
    store = dist.FileStore(str(tmp_path_factory.mktemp("gloo") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield lambda shape, axes: make_mesh(shape, axes, device="cpu")
    finally:
        dist.destroy_process_group()


def _rng(seed=0):
    return np.random.default_rng(seed)


# -- compression --------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_scale_is_jax_bitwise_and_codes_round_jax_y(dtype):
    x = (_rng(1).standard_normal((64, 33)) * 0.3).astype(np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(xt.float().numpy()).astype(getattr(jnp, dtype))
    qj, sj = JC8.quantize_int8(xj, jax.random.PRNGKey(0))
    q, s = TC8.quantize_int8(xt, torch.Generator().manual_seed(0))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.asarray(sj).tobytes() == s.numpy().tobytes()
    y = np.asarray(xj.astype(jnp.float32) / sj)
    lo = np.clip(np.floor(y), -127, 127)
    hi = np.clip(np.floor(y) + 1, -127, 127)
    qn = q.numpy().astype(np.float32)
    assert ((qn == lo) | (qn == hi)).all()
    assert (qn == lo).any() and (qn == hi).any() and (qn != lo).any()
    assert np.abs(np.asarray(qj).astype(np.float32) - qn).max() <= 1


@given(st.integers(0, 2 ** 31 - 1))
@settings(max_examples=10, deadline=None)
def test_int8_quantization_unbiased(seed):
    """Stochastic rounding: E[dequant(quant(x))] == x (the reference's
    test, with a torch generator per draw)."""
    x = torch.from_numpy(
        (_rng(seed + 1).standard_normal(32) * 0.1).astype(np.float32))
    gen = torch.Generator().manual_seed(seed)
    acc = torch.zeros_like(x)
    n = 64
    for _ in range(n):
        q, s = TC8.quantize_int8(x, gen)
        acc = acc + TC8.dequantize_int8(q, s)
    mean = acc / n
    scale = float(x.abs().max()) / 127.0
    assert float((mean - x).abs().max()) < 4 * scale / np.sqrt(n) + 1e-6


def test_quantization_error_bounded():
    x = torch.from_numpy(_rng(0).standard_normal(256).astype(np.float32))
    q, s = TC8.quantize_int8(x, torch.Generator().manual_seed(1))
    err = (TC8.dequantize_int8(q, s) - x).abs()
    assert float(err.max()) <= float(s) + 1e-7


def test_compress_tree_draws_per_leaf_and_round_trips():
    a = torch.from_numpy(_rng(2).standard_normal((16, 8)).astype(np.float32))
    tree = {"w": a, "blocks": [{"b": a.clone()}, {"b": a[:4].clone()}]}
    codes, scales = TC8.compress_tree(tree, torch.Generator().manual_seed(3))
    again, _ = TC8.compress_tree(tree, torch.Generator().manual_seed(3))
    assert codes["blocks"][0]["b"].dtype == torch.int8
    assert scales["w"].dtype == torch.float32 and scales["w"].ndim == 0
    for c, d in zip((codes["w"], codes["blocks"][0]["b"]),
                    (again["w"], again["blocks"][0]["b"])):
        assert torch.equal(c, d)                       # seeded
    # the same values in two leaves draw different noise
    assert not torch.equal(codes["w"], codes["blocks"][0]["b"])
    back = TC8.decompress_tree(codes, scales)
    for x, y, s in ((a, back["w"], scales["w"]),
                    (a[:4], back["blocks"][1]["b"],
                     scales["blocks"][1]["b"])):
        assert float((x - y).abs().max()) <= float(s) + 1e-7


# -- expert parallelism -------------------------------------------------------

def test_bucket_by_expert_matches_jax_drops_included():
    rng = _rng(4)
    T, k, E, d, cap = 24, 2, 4, 8, 7
    x = rng.standard_normal((T, d)).astype(np.float32)
    idx = np.stack([rng.permutation(E)[:k] for _ in range(T)]).astype(
        np.int32)
    jb, (jt, je, js, jk), jd = JEP._bucket_by_expert(
        jnp.asarray(x), jnp.asarray(idx), E, cap)
    tb, (tt, te, ts, tk), td = TEP._bucket_by_expert(
        torch.from_numpy(x), torch.from_numpy(idx).long(), E, cap)
    assert int(jd) == int(td) > 0
    for j, t in ((jt, tt), (je, te), (js, ts), (jk, tk)):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    np.testing.assert_array_equal(np.asarray(jb), tb.numpy())


@pytest.mark.parametrize("cap", [1, 5, 24])
def test_bucket_drops_are_each_experts_overflow(cap):
    """Held against a count written out: an expert keeps its first
    ``min(count, cap)`` assignments in token order, and drops the rest."""
    rng = _rng(9)
    T, k, E, d = 32, 2, 4, 8
    # skewed routes: expert 0 is picked far more often than the others
    idx = np.stack([rng.choice(E, k, replace=False, p=[.55, .25, .1, .1])
                    for _ in range(T)])
    x = torch.from_numpy(rng.standard_normal((T, d)).astype(np.float32))
    buffers, (tok, e_idx, s_idx, kept), drops = TEP._bucket_by_expert(
        x, torch.from_numpy(idx).long(), E, cap)
    count = np.bincount(idx.reshape(-1), minlength=E)
    assert int(drops) == int(np.maximum(count - cap, 0).sum())
    assert np.bincount(e_idx[kept].numpy(), minlength=E).tolist() == \
        np.minimum(count, cap).tolist()
    for e in range(E):
        mine = np.flatnonzero(idx.reshape(-1) == e)[:cap]
        np.testing.assert_array_equal(
            buffers[e, :len(mine)].numpy(), x[mine // k].numpy())


def _moe_params(d, f, E, top_k, n_shared, gated, seed=0):
    jp = JMoE.init_moe(jax.random.PRNGKey(seed), d, f, E, top_k,
                       n_shared=n_shared, gated=gated, dtype=jnp.float32)
    tree = jax.device_get(jp)

    def pd(t):
        return torch.nn.ParameterDict(
            {n: torch.nn.Parameter(torch.from_numpy(np.array(a)))
             for n, a in t.items() if n != "shared"})

    return jp, MoEParams(pd(tree), pd(tree["shared"]) if n_shared else None)


def _route_margin(x, router, top_k):
    logits = np.sort(x.reshape(-1, x.shape[-1]) @ router, axis=-1)[:, ::-1]
    return float((logits[:, top_k - 1] - logits[:, top_k]).min())


@pytest.mark.parametrize("gated,n_shared", [(True, 0), (False, 0), (True, 2)])
def test_moe_ep_forward_one_rank_matches_jax_with_drops(one_rank, gated,
                                                        n_shared):
    d, f, E, k = 16, 32, 8, 2
    jp, tp = _moe_params(d, f, E, k, n_shared, gated)
    x = _rng(5).standard_normal((2, 16, d)).astype(np.float32)
    assert _route_margin(x, np.asarray(jp["router"]), k) > ROUTE_MARGIN
    jy, jdrop = JEP.moe_ep_forward(jp, jnp.asarray(x), k,
                                   jax.make_mesh((1, 1), ("data", "model")),
                                   cap_factor=1.25)
    mesh = one_rank((1, 1), ("data", "model"))
    ty, tdrop = TEP.moe_ep_forward(tp, torch.from_numpy(x), k, mesh,
                                   cap_factor=1.25)
    assert float(jdrop) > 0
    assert float(tdrop) == float(jdrop)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **TOL)


def test_sp_decode_one_rank_matches_jax(one_rank):
    rng = _rng(6)
    B, Hq, Hkv, D, Smax = 4, 8, 2, 16, 64
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Smax, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Smax, Hkv, D)).astype(np.float32)
    lens = np.array([5, 17, 40, 64], np.int32)
    jo = JSP.sp_decode_attention(
        *map(jnp.asarray, (q, k, v, lens)),
        jax.make_mesh((1, 1), ("data", "model")))
    to = TSP.sp_decode_attention(
        *map(torch.from_numpy, (q, k, v, lens)),
        one_rank((1, 1), ("data", "model")))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)


def test_pipeline_one_stage_matches_jax(one_rank):
    rng = _rng(7)
    n_micro, mb, S, d = 4, 2, 8, 16
    w = (rng.standard_normal((1, d, d)) * 0.3).astype(np.float32)
    x = rng.standard_normal((n_micro, mb, S, d)).astype(np.float32)
    jo = JPipe.pipeline_forward(lambda p, h: jnp.tanh(h @ p),
                                jnp.asarray(w), jnp.asarray(x),
                                JPipe.make_pp_mesh(1, tp=1), 1)
    to = TPipe.pipeline_forward(lambda p, h: torch.tanh(h @ p),
                                torch.from_numpy(w[0]), torch.from_numpy(x),
                                one_rank((1, 1), ("stage", "model")), 1)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)


# -- sharding rules -----------------------------------------------------------

MESHES = [{"data": 1, "model": 1}, {"data": 2, "model": 4},
          {"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}]


def _jax_mesh(sizes):
    return types.SimpleNamespace(shape=dict(sizes),
                                 axis_names=tuple(sizes))


def _lookup(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _full_trees(arch):
    jcfg, tcfg = JC.get_config(arch), TC.get_config(arch)
    enc = jcfg.cross_attn
    jinit = JE.init_encdec_params if enc else JT.init_params
    jparams = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0), jcfg))
    tinit = TE.init_encdec_params if enc else TT.init_params
    tparams = tinit(torch.Generator(), tcfg, device="meta")
    src = 256 if enc else 0
    jcache = jax.eval_shape(lambda: JT.init_cache(jcfg, 128, 4096,
                                                  source_len=src))
    tcache = TT.init_cache(tcfg, 128, 4096, device="meta", source_len=src)
    return jcfg, tcfg, jparams, tparams, jcache, tcache


@pytest.mark.parametrize("arch", TC.ARCHS)
def test_pspecs_match_jax_at_full_size(arch):
    jcfg, tcfg, jparams, tparams, jcache, tcache = _full_trees(arch)
    names = dict(tparams.named_parameters())
    # every reference leaf (times its stacked blocks) is one port name
    n_ref = sum(
        leaf.shape[0] if path[0].key in ("blocks",) or (
            path[0].key == "encoder" and path[1].key == "layers") else 1
        for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0])
    assert len(names) == n_ref
    for sizes in MESHES:
        for fsdp in (False, True):
            ref = JS.param_pspecs(jparams, jcfg, _jax_mesh(sizes), fsdp=fsdp)
            got = TS.param_pspecs(tparams, tcfg, sizes, fsdp=fsdp)
            assert set(got) == set(names)
            for name, spec in got.items():
                path, r = jax_path(name)
                want = tuple(_lookup(ref, path))
                assert spec == (want if r is None else want[1:]), \
                    (arch, sizes, fsdp, name, spec, want)
        ref_c = JS.cache_pspecs(jcache, jcfg, _jax_mesh(sizes))
        got_c = TS.cache_pspecs(tcache, tcfg, sizes)
        flat = []
        map_tree(lambda g, w: flat.append((g, tuple(w))), got_c,
                 jax.tree.map(tuple, ref_c, is_leaf=lambda s: isinstance(
                     s, jax.sharding.PartitionSpec)))
        assert flat and all(g == w for g, w in flat), (arch, sizes)
    assert TS.batch_pspec({"pod": 2, "data": 16, "model": 16}) == \
        tuple(JS.batch_pspec(_jax_mesh(MESHES[3])))


@pytest.mark.parametrize("sizes,want", [
    ({"data": 2, "model": 4}, ("data",)),
    ({"pod": 2, "data": 16, "model": 16}, ("pod", "data")),
    ({"stage": 4, "model": 2}, ())])
def test_data_axes_rule_and_the_active_mesh(sizes, want):
    """One rule for the batch axes, read by the specs and by the hints
    (a mapping of axis sizes stands in for a mesh)."""
    from repro_torch.launch.mesh import data_axes, mesh_context
    from repro_torch.layers import hints
    assert data_axes(sizes) == want
    assert TS.batch_pspec(sizes) == (
        want if len(want) > 1 else (want[0] if want else None),)
    assert (hints.mesh_axis_size("model"), hints.data_axis_names()) == \
        (1, ())
    with mesh_context(sizes):
        assert hints.mesh_axis_size("model") == sizes["model"]
        assert hints.data_axis_names() == want
    assert hints.mesh_axis_size("model") == 1


# -- head padding -------------------------------------------------------------

def _reduced(arch, dtype="float32"):
    return (dataclasses.replace(JC.get_reduced(arch), dtype=dtype),
            dataclasses.replace(TC.get_reduced(arch), dtype=dtype))


def _padded_pair(arch):
    jcfg, tcfg = _reduced(arch)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.device_get(jparams), tcfg, device="cpu")
    jpad, jpcfg = JPad.pad_attention_heads(jparams, jcfg)
    tpad, tpcfg = TPad.pad_attention_heads(tparams, tcfg)
    assert (tpcfg.n_heads, tpcfg.n_kv_heads, tpcfg.head_dim) == \
        (jpcfg.n_heads, jpcfg.n_kv_heads, jpcfg.head_dim)
    assert TPad.padded_config(tcfg) == tpcfg
    return (jcfg, jparams, jpad, jpcfg), (tcfg, tparams, tpad, tpcfg)


def _tokens(cfg, B=2, S=16):
    return _rng(8).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _logits(params, cfg, toks):
    with torch.no_grad():
        return TT.forward(params, cfg, torch.from_numpy(toks)).numpy()


def test_padding_mha_equals_jax_tree_and_keeps_logits():
    (jcfg, _, jpad, jpcfg), (tcfg, tparams, tpad, tpcfg) = \
        _padded_pair("qwen1.5-32b")
    assert (tpcfg.n_heads, tpcfg.n_kv_heads) == (16, 16)
    want = jax.device_get(jpad)
    got = params_to_numpy(tpad, tpcfg)
    flat = []
    map_tree(lambda g, w: flat.append((g, np.asarray(w))), got, want)
    assert len(flat) == len(jax.tree.leaves(want))
    for g, w in flat:
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    # the unpadded model is left as it was
    assert tparams.blocks[0]["l0"].attn["wq"].shape[1] == 5 * 16
    toks = _tokens(tcfg)
    np.testing.assert_allclose(_logits(tpad, tpcfg, toks),
                               _logits(tparams, tcfg, toks),
                               rtol=1e-5, atol=1e-5)
    # decode through the padded caches too
    B = toks.shape[0]
    c0 = TT.init_cache(tcfg, B, 24, device="cpu")
    c1 = TT.init_cache(tpcfg, B, 24, device="cpu")
    for t in range(6):
        tok = torch.from_numpy(toks[:, t:t + 1])
        l0, c0 = TT.decode_step(tparams, tcfg, tok, c0)
        l1, c1 = TT.decode_step(tpad, tpcfg, tok, c1)
        np.testing.assert_allclose(l1.numpy(), l0.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_padding_gqa_follows_jax_and_is_not_exact():
    """qwen2-0.5b REDUCED (7 q / 1 kv heads padded to 16 / 16): the
    reference's padding regroups the heads, so its padded logits differ
    from the unpadded ones; the port's padded logits equal the
    reference's padded logits, fault included."""
    (jcfg, jparams, jpad, jpcfg), (tcfg, tparams, tpad, tpcfg) = \
        _padded_pair("qwen2-0.5b")
    toks = _tokens(tcfg)
    jl = np.asarray(JT.forward(jpad, jpcfg, jnp.asarray(toks)))
    jl0 = np.asarray(JT.forward(jparams, jcfg, jnp.asarray(toks)))
    tl = _logits(tpad, tpcfg, toks)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5)
    assert np.abs(jl - jl0).max() > 1.0
    assert np.abs(tl - _logits(tparams, tcfg, toks)).max() > 1.0


def test_padding_aligned_is_identity_and_mla_raises():
    jcfg, tcfg = _reduced("deepseek-v2-lite-16b")
    tparams = TT.init_params(torch.Generator().manual_seed(0), tcfg,
                             device="cpu")
    with pytest.raises(NotImplementedError):
        TPad.pad_attention_heads(tparams, tcfg)
    with pytest.raises(NotImplementedError):
        JPad.pad_attention_heads(jax.eval_shape(
            lambda: JT.init_params(jax.random.PRNGKey(0), jcfg)), jcfg)
    assert TPad.padded_config(TC.get_config("seamless-m4t-large-v2")) is \
        TC.get_config("seamless-m4t-large-v2")       # 16 / 16: aligned
    _, tcfg = _reduced("seamless-m4t-large-v2")      # 4 / 4
    tparams = TE.init_encdec_params(torch.Generator().manual_seed(0), tcfg,
                                    device="cpu")
    p, c = TPad.pad_attention_heads(tparams, tcfg, multiple=4)
    assert p is tparams and c is tcfg
