"""M-RoPE and embedding inputs (qwen2-vl-7b) in the port against the JAX
reference on the CPU: ``apply_mrope``, GQA attention and its decode step
under M-RoPE, and the REDUCED qwen2-vl model fed patch embeddings with
(t, h, w) position ids through ``forward``, ``prefill``/``decode_step``
and one train step, on the reference's weights (``params_from_jax``).

Tolerances:
  * ``apply_mrope``: fp32 1e-6 (the same fp32 angles; sin and cos of
    the two libraries differ in the last ulp); bf16 one bf16 ulp (2^-7
    relative) + 1e-6, as both round the fp32 rotation once.
  * attention, fp32 1e-5 on the outputs; bf16 5e-2 (read: 9.5e-7 and
    1.6e-2; the reference rounds p to bf16 before p @ V, the port keeps
    fp32).
  * model logits, as tests/test_torch_model.py holds the decoders: fp32
    1e-4; bf16 ``forward`` 0.15, decode and prefill 1e-1 (read: fp32 at
    most 2.0e-6; bf16 ``forward`` 3.5e-2, decode and prefill 3.1e-2).
  * one train step, as tests/test_torch_training.py: fp32 loss 1e-5,
    grad norm rtol 1e-5, masters 1e-6; bf16 5e-3, 5e-3, 5e-5.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.layers import attention as JA  # noqa: E402
from repro.layers import rope as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.convert import (map_tree, params_from_jax,  # noqa: E402
                                 to_jax_layout, to_numpy, to_torch)
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.layers import attention as TA  # noqa: E402
from repro_torch.layers import rope as TR  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.training import optimizer as TO  # noqa: E402

ARCH = "qwen2-vl-7b"
DTYPES = ["float32", "bfloat16"]
ATTN_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 1e-1}
FORWARD_TOL = {"float32": 1e-4, "bfloat16": 0.15}
TRAIN_TOL = {"float32": dict(loss=1e-5, gnorm=1e-5, master=1e-6),
             "bfloat16": dict(loss=5e-3, gnorm=5e-3, master=5e-5)}


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t).astype(np.float32)


def _thw(rng, B, S, grid=4):
    """(B, S, 3) position ids whose axes differ: t counts, h and w run
    over a grid of patches."""
    return np.stack([np.broadcast_to(np.arange(S), (B, S)),
                     rng.integers(0, grid, (B, S)),
                     rng.integers(0, grid, (B, S))], -1).astype(np.int32)


def _models(dtype, seed=0):
    jcfg = dataclasses.replace(JC.get_reduced(ARCH), dtype=dtype)
    tcfg = dataclasses.replace(TC.get_reduced(ARCH), dtype=dtype)
    jp = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, params_from_jax(jax.device_get(jp), tcfg,
                                           device="cpu")


def test_port_configs_equal_reference():
    for get in ("get_config", "get_reduced"):
        assert dataclasses.asdict(getattr(JC, get)(ARCH)) == \
            dataclasses.asdict(getattr(TC, get)(ARCH))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", [8, 128])
def test_apply_mrope_matches_reference(D, dtype):
    rng = np.random.default_rng(D)
    q = rng.standard_normal((2, 11, 3, D)).astype(np.float32)
    k = rng.standard_normal((2, 11, 1, D)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 11, 3)).astype(np.int32)
    jdt = getattr(jnp, dtype)
    jq, jk = JR.apply_mrope(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                            jnp.asarray(pos))
    tdt = getattr(torch, dtype)
    tq, tk = TR.apply_mrope(torch.from_numpy(q).to(tdt),
                            torch.from_numpy(k).to(tdt),
                            torch.from_numpy(pos))
    assert tq.dtype == tdt and tk.dtype == tdt
    tol = (dict(rtol=0, atol=1e-6) if dtype == "float32"
           else dict(rtol=2.0 ** -7, atol=1e-6))
    np.testing.assert_allclose(_np(tq), _np(jq), **tol)
    np.testing.assert_allclose(_np(tk), _np(jk), **tol)


def test_mrope_of_equal_axes_is_rope():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((2, 9, 7, 8)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 9, 1, 8)).astype(
        np.float32))
    pos = torch.from_numpy(rng.integers(0, 500, (2, 9)).astype(np.int32))
    mq, mk = TR.apply_mrope(q, k, pos[..., None].expand(2, 9, 3))
    rq, rk = TR.apply_rope(q, k, pos)
    assert torch.equal(mq, rq) and torch.equal(mk, rk)


def test_mrope_sections_default_and_must_sum_to_half():
    assert TR.mrope_sections(128) == (16, 24, 24)
    assert TR.mrope_sections(8) == (1, 1, 2)
    q = torch.zeros(1, 2, 1, 8)
    pos = torch.zeros(1, 2, 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="sum to 4"):
        TR.apply_mrope(q, q, pos, sections=(1, 1, 1))
    with pytest.raises(ValueError):
        JR.apply_mrope(jnp.zeros((1, 2, 1, 8)), jnp.zeros((1, 2, 1, 8)),
                       jnp.zeros((1, 2, 3), jnp.int32), sections=(1, 1, 1))


def _attention_params(dtype, rng):
    jp = JA.init_attention(jax.random.PRNGKey(3), 56, 7, 1, 8,
                           qkv_bias=True, dtype=getattr(jnp, dtype))
    # non-zero biases, so that they are rotated too
    jp = {n: (a + jnp.asarray(rng.standard_normal(a.shape) * 0.1, a.dtype)
              if n.startswith("b") else a) for n, a in jp.items()}
    tp = torch.nn.ParameterDict({n: torch.nn.Parameter(to_torch(
        np.asarray(jax.device_get(a)))) for n, a in jp.items()})
    return jp, tp


@pytest.mark.parametrize("dtype", DTYPES)
def test_gqa_attention_and_decode_step_under_mrope(dtype):
    rng = np.random.default_rng(1)
    jp, tp = _attention_params(dtype, rng)
    kw = dict(n_heads=7, n_kv_heads=1, head_dim=8, rope="mrope")
    x = rng.standard_normal((2, 13, 56)).astype(np.float32)
    pos = _thw(rng, 2, 13)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = JA.gqa_attention(jp, jnp.asarray(x, jdt), jnp.asarray(pos), **kw)
    got = TA.gqa_attention(tp, torch.from_numpy(x).to(tdt),
                           torch.from_numpy(pos), **kw)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                               atol=ATTN_TOL[dtype])
    # decode: the position broadcast to all three axes
    ck = rng.standard_normal((2, 16, 1, 8)).astype(np.float32)
    cv = rng.standard_normal((2, 16, 1, 8)).astype(np.float32)
    xs = rng.standard_normal((2, 1, 56)).astype(np.float32)
    lens = np.array([3, 15], np.int32)
    wy, wk, _ = JA.gqa_decode_step(jp, jnp.asarray(xs, jdt),
                                   jnp.asarray(ck, jdt), jnp.asarray(cv, jdt),
                                   jnp.asarray(lens), **kw)
    tk = torch.from_numpy(ck).to(tdt)
    with torch.no_grad():
        ty, tk, _ = TA.gqa_decode_step(tp, torch.from_numpy(xs).to(tdt), tk,
                                       torch.from_numpy(cv).to(tdt),
                                       torch.from_numpy(lens), **kw)
    np.testing.assert_allclose(_np(ty), _np(wy), rtol=0,
                               atol=ATTN_TOL[dtype])
    np.testing.assert_allclose(_np(tk), _np(wk), rtol=0,
                               atol=ATTN_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_with_embeds_and_positions_matches_reference(dtype):
    jcfg, tcfg, jp, tp = _models(dtype)
    rng = np.random.default_rng(2)
    emb = rng.standard_normal((2, 17, jcfg.d_model)).astype(np.float32)
    pos = _thw(rng, 2, 17)
    for positions in (pos, None):        # given ids; the default arange
        want = JT.forward(jp, jcfg, embeds=jnp.asarray(emb),
                          positions=None if positions is None
                          else jnp.asarray(positions))
        with torch.no_grad():
            got = TT.forward(tp, tcfg, embeds=torch.from_numpy(emb),
                             positions=None if positions is None
                             else torch.from_numpy(positions))
        assert tuple(got.shape) == (2, 17, jcfg.vocab_size)
        np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                                   atol=FORWARD_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_and_decode_step_with_embeds_match_reference(dtype):
    jcfg, tcfg, jp, tp = _models(dtype)
    rng = np.random.default_rng(3)
    B, S, max_len = 2, 9, 16
    emb = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    toks = np.zeros((B, S), np.int32)
    lens = np.array([9, 6], np.int32)
    jl, jc = JT.prefill(jp, jcfg, jnp.asarray(toks), max_len,
                        embeds=jnp.asarray(emb), lengths=jnp.asarray(lens))
    tl, tc = TT.prefill(tp, tcfg, torch.from_numpy(toks), max_len,
                        embeds=torch.from_numpy(emb),
                        lengths=torch.from_numpy(lens))
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=0,
                               atol=LOGIT_TOL[dtype])
    for step in range(3):
        e = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
        jl, jc = JT.decode_step(jp, jcfg, jnp.zeros((B, 1), jnp.int32), jc,
                                embeds=jnp.asarray(e))
        tl, tc = TT.decode_step(tp, tcfg, torch.zeros(B, 1,
                                                      dtype=torch.int32),
                                tc, embeds=torch.from_numpy(e))
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=0,
                                   atol=LOGIT_TOL[dtype])
    assert tc["len"].tolist() == [12, 9]
    # a prompt's slice reaches the kernels contiguous, as they take it
    step_rows = torch.from_numpy(emb)[:, 3:4]
    assert not step_rows.is_contiguous()
    assert TT._embed(tp, tcfg, None, step_rows).is_contiguous()


@pytest.mark.parametrize("dtype", DTYPES)
def test_train_step_on_the_embeds_batch_matches_reference(dtype):
    """One step on ``{"embeds", "labels"}``: the embedding table gets a
    zero gradient (the loss never reads it) and is still decayed."""
    jcfg, tcfg, jp, tp = _models(dtype)
    rng = np.random.default_rng(4)
    B, S = 4, 16
    emb = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    labels = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jo, to = JO.adamw_init(jp), TO.adamw_init(tp)
    jstep = jax.jit(JS.make_train_step(jcfg, microbatches=2, remat=True))
    tstep = TS.make_train_step(tcfg, microbatches=2, remat=True)
    _, jo, jm = jstep(jp, jo, {"embeds": jnp.asarray(emb),
                               "labels": jnp.asarray(labels)})
    tp, to, tm = tstep(tp, to, {"embeds": torch.from_numpy(emb),
                                "labels": torch.from_numpy(labels)})
    tol = TRAIN_TOL[dtype]
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= tol["loss"]
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=tol["gnorm"])
    tmaster = map_tree(to_numpy, to_jax_layout(to.master))
    for path, want in jax.tree_util.tree_flatten_with_path(
            jax.device_get(jo.master))[0]:
        got = tmaster
        for p in path:
            got = got[p.key]
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=tol["master"])
    assert not to.m["embed"].any()


def test_serving_skips_the_stub_frontend_arch(monkeypatch):
    """The port's engine entry point refuses qwen2-vl (the reference skips
    its engine demo); the search-then-serve entry point runs the plan
    search, then skips the engine."""
    with pytest.raises(ValueError, match="stub-frontend"):
        port_serve.serve(ARCH, size="reduced", device="cpu")

    def no_engine(*args, **kwargs):
        raise AssertionError("the engine ran")

    monkeypatch.setattr(port_serve, "serve", no_engine)
    lines = []
    base, best, report, reqs = port_serve.plan_and_serve(
        arch=ARCH, size="reduced", device="cpu", log=lines.append)
    assert report is None and reqs == [] and best.num_schemes > 0
    assert lines[-1] == "(reduced engine demo skipped: stub-frontend arch)"
