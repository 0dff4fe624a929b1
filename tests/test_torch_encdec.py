"""The encoder-decoder (seamless-m4t-large-v2 REDUCED) in the port
against the JAX reference on the CPU, on the reference's weights: the
encoder, the cross K/V, ``encdec_forward``, ``encdec_prefill`` and
decode steps with their cross caches, a train step on the frames batch,
the converter's round trip, the refusals, the flash kernel's plain
version without the causal mask at Sq != Skv (against the Pallas kernel
in interpret mode and ``ref.py``, and its backward against
``jax.grad``), and the launches the smoke counts.

The reference's encoder attends through ``blockwise_attention`` (plain
XLA, its own CPU route); the port's through the flash wrapper, whose
plain version runs for CPU tensors.

Tolerances:
  * fp32: 1e-5 on memory, cross K/V and caches, 1e-4 on logits
    (summation order; read at most 1.4e-6 on memory and cross K/V, 2.0e-6
    on logits and caches);
  * bf16: 5e-2 on memory, cross K/V and caches, 0.15 on
    ``encdec_forward`` logits, 1e-1 on decode logits (read: 3.1e-2 on
    memory and cross K/V, 3.5e-2 on forward logits, 4.7e-2 on decode
    logits and caches), the decoders' limits of
    tests/test_torch_model.py: the reference rounds p to bf16 before
    p @ V, the port keeps fp32;
  * one train step, as tests/test_torch_training.py: fp32 loss 1e-5,
    grad norm rtol 1e-5, masters 1e-6; bf16 5e-3, 5e-3, 5e-5;
  * non-causal attention in fp32: 2e-5 against Pallas and ``ref.py``
    (tests/test_kernels.py's fp32 limit), 1e-5 on the gradients.
"""

import dataclasses
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.kernels.flash_attention.flash_attention import \
    flash_attention_pallas  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.layers import attention as JA  # noqa: E402
from repro.models import encdec as JED  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.convert import (cache_from_jax, map_tree,  # noqa: E402
                                 params_from_jax, params_to_numpy,
                                 to_jax_layout, to_numpy)
from repro_torch.data.pipeline import TokenPipeline  # noqa: E402
from repro_torch.kernels import decode_attention as DA  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import rmsnorm as RN  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch.train import stub_inputs, train  # noqa: E402
from repro_torch.layers import attention as TA  # noqa: E402
from repro_torch.models import encdec as TED  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402
from repro_torch.training import optimizer as TO  # noqa: E402

ARCH = "seamless-m4t-large-v2"
DTYPES = ["float32", "bfloat16"]
MEM_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
FORWARD_TOL = {"float32": 1e-4, "bfloat16": 0.15}
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 1e-1}
TRAIN_TOL = {"float32": dict(loss=1e-5, gnorm=1e-5, master=1e-6),
             "bfloat16": dict(loss=5e-3, gnorm=5e-3, master=5e-5)}


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t).astype(np.float32)


def _models(dtype, seed=0):
    jcfg = dataclasses.replace(JC.get_reduced(ARCH), dtype=dtype)
    tcfg = dataclasses.replace(TC.get_reduced(ARCH), dtype=dtype)
    jp = JED.init_encdec_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, params_from_jax(jax.device_get(jp), tcfg,
                                           device="cpu")


def _frames(cfg, B=2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, cfg.cross_source_len,
                                cfg.d_model)).astype(np.float32)


def test_port_configs_equal_reference():
    for get in ("get_config", "get_reduced"):
        assert dataclasses.asdict(getattr(JC, get)(ARCH)) == \
            dataclasses.asdict(getattr(TC, get)(ARCH))


@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_and_cross_kv_match_reference(dtype):
    jcfg, tcfg, jp, tp = _models(dtype)
    fr = _frames(jcfg)
    jm = JED.encode(jp, jcfg, jnp.asarray(fr))
    with torch.no_grad():
        tm = TED.encode(tp, tcfg, torch.from_numpy(fr))
        tkv = TED._project_cross_kv(tp, tcfg, tm)
    assert tm.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(tm), _np(jm), rtol=0, atol=MEM_TOL[dtype])
    # the reference's projection of ITS memory, the port's of the port's
    jkv = JED._project_cross_kv(jp, jcfg, jm)
    for name in ("xk", "xv"):
        want = jkv["l0"][name]
        assert tuple(tkv["l0"][name].shape) == want.shape == (
            jcfg.block_repeat, 2, jcfg.cross_source_len, jcfg.n_kv_heads,
            jcfg.resolved_head_dim)
        np.testing.assert_allclose(_np(tkv["l0"][name]), _np(want), rtol=0,
                                   atol=MEM_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_encdec_forward_matches_reference(dtype):
    jcfg, tcfg, jp, tp = _models(dtype)
    fr = _frames(jcfg, seed=1)
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (2, 11)).astype(np.int32)
    want = JED.encdec_forward(jp, jcfg, jnp.asarray(fr), jnp.asarray(toks))
    with torch.no_grad():
        got = TED.encdec_forward(tp, tcfg, torch.from_numpy(fr),
                                 torch.from_numpy(toks))
    assert tuple(got.shape) == (2, 11, jcfg.vocab_size)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                               atol=FORWARD_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_encdec_prefill_and_decode_steps_match_reference(dtype):
    """The first logits, 4 decode steps' logits, and the caches: the cross
    K/V written once by the prefill and the self-attention K/V rows."""
    jcfg, tcfg, jp, tp = _models(dtype)
    fr = _frames(jcfg, seed=2)
    bos = np.zeros((2, 1), np.int32)
    jl, jc, jm = JED.encdec_prefill(jp, jcfg, jnp.asarray(fr),
                                    jnp.asarray(bos), 16)
    tl, tc, tm = TED.encdec_prefill(tp, tcfg, torch.from_numpy(fr),
                                    torch.from_numpy(bos), 16)
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=0,
                               atol=LOGIT_TOL[dtype])
    rng = np.random.default_rng(2)
    for _ in range(4):
        t = rng.integers(0, jcfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jc = JED.encdec_decode_step(jp, jcfg, jnp.asarray(t), jc)
        tl, tc = TED.encdec_decode_step(tp, tcfg, torch.from_numpy(t), tc)
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=0,
                                   atol=LOGIT_TOL[dtype])
    jcache = jax.device_get(jc)
    assert tc["len"].tolist() == np.asarray(jcache["len"]).tolist() == [5, 5]
    for name in ("k", "v", "xk", "xv"):
        np.testing.assert_allclose(
            _np(tc["blocks"]["l0"][name]),
            _np(jcache["blocks"]["l0"][name]), rtol=0, atol=MEM_TOL[dtype])
    # the reference's cache, carried over, decodes alike in the port
    tc2 = cache_from_jax(jcache, device="cpu")
    t = np.ones((2, 1), np.int32)
    jl, _ = JED.encdec_decode_step(jp, jcfg, jnp.asarray(t), jc)
    tl, _ = TED.encdec_decode_step(tp, tcfg, torch.from_numpy(t), tc2)
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=0,
                               atol=LOGIT_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_train_step_on_the_frames_batch_matches_reference(dtype):
    """One step on ``{"frames", "tokens", "labels"}`` (2 microbatches,
    remat: the encoder's layers checkpointed, as under jax.checkpoint)
    against the reference's ``jax.grad`` step."""
    jcfg, tcfg, jp, tp = _models(dtype)
    rng = np.random.default_rng(3)
    B, S = 4, 12
    fr = rng.standard_normal((B, jcfg.cross_source_len,
                              jcfg.d_model)).astype(np.float32)
    toks = rng.integers(0, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
    jo, to = JO.adamw_init(jp), TO.adamw_init(tp)
    jstep = jax.jit(JS.make_train_step(jcfg, microbatches=2, remat=True))
    tstep = TS.make_train_step(tcfg, microbatches=2, remat=True)
    _, jo, jm = jstep(jp, jo, {"frames": jnp.asarray(fr),
                               "tokens": jnp.asarray(toks[:, :-1]),
                               "labels": jnp.asarray(toks[:, 1:])})
    tp, to, tm = tstep(tp, to, {
        "frames": torch.from_numpy(fr),
        "tokens": torch.from_numpy(toks[:, :-1].copy()),
        "labels": torch.from_numpy(toks[:, 1:].copy())})
    tol = TRAIN_TOL[dtype]
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= tol["loss"]
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=tol["gnorm"])
    tmaster = map_tree(to_numpy, to_jax_layout(to.master))
    leaves = jax.tree_util.tree_flatten_with_path(
        jax.device_get(jo.master))[0]
    assert any(p[0].key == "encoder" for p, _ in leaves)
    for path, want in leaves:
        got = tmaster
        for p in path:
            got = got[p.key]
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=tol["master"])


def test_params_round_trip_bit_for_bit_in_bf16():
    """Encoder (stacked layers, final norm) and decoder cross-attention
    (``norm_x``, ``xattn``) cross into the port and back unchanged."""
    _, tcfg, jp, tp = _models("bfloat16")
    tree = jax.device_get(jp)
    back = params_to_numpy(tp, tcfg)
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    keys = {tuple(p.key for p in path) for path, _ in leaves}
    assert ("encoder", "final_norm") in keys
    assert ("blocks", "l0", "xattn", "wk") in keys
    assert ("blocks", "l0", "norm_x") in keys
    for path, want in leaves:
        got = back
        for p in path:
            got = got[p.key]
        assert got.dtype == np.uint16
        np.testing.assert_array_equal(
            got, np.asarray(want).view(ml_dtypes.bfloat16).view(np.uint16))
    assert len(tp.encoder.layers) == tcfg.encoder.n_layers
    assert params_from_jax(back_as_bf16(back), tcfg,
                           device="cpu").encoder.final_norm.dtype == \
        torch.bfloat16


def back_as_bf16(tree):
    return map_tree(lambda a: a.view(ml_dtypes.bfloat16), tree)


def test_prefill_engine_and_serve_refuse_the_encoder_decoder(monkeypatch):
    """``prefill`` raises as the reference's does; the engine raises the
    same error before it allocates a cache; the serve entry point refuses
    the stub-frontend arch."""
    _, tcfg, _, tp = _models("float32")
    with pytest.raises(ValueError, match="encdec_prefill"):
        TT.prefill(tp, tcfg, torch.zeros(1, 3, dtype=torch.int32), 8)

    def no_cache(*args, **kwargs):
        raise AssertionError("the engine allocated a cache")

    monkeypatch.setattr(TE.T, "init_cache", no_cache)
    with pytest.raises(ValueError, match="encdec_prefill"):
        TE.ServingEngine(tcfg, tp, device="cpu")
    with pytest.raises(ValueError, match="stub-frontend"):
        port_serve.serve(ARCH, size="reduced", device="cpu")
    with pytest.raises(ValueError, match="needs cfg.encoder"):
        TED.init_encdec_params(torch.Generator(), TC.get_reduced(
            "qwen2-0.5b"))


@pytest.mark.parametrize("Sq,Skv,group", [(40, 40, 1), (24, 65, 1),
                                          (33, 100, 2)])
def test_non_causal_flash_plain_matches_pallas_and_ref(Sq, Skv, group):
    """The flash kernel's plain version without the causal mask, as the
    encoder (Sq = Skv) and cross-attention (Sq != Skv, a ragged last
    key tile) call it: out against ``flash_attention_pallas`` in
    interpret mode and ``ref.py``; the lse against the log-sum-exp of
    the scores."""
    rng = np.random.default_rng(Sq + Skv)
    q = rng.standard_normal((2, Sq, 2 * group, 16)).astype(np.float32)
    k = rng.standard_normal((2, Skv, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, Skv, 2, 16)).astype(np.float32)
    out, lse = FA.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                  causal=False)
    pallas = flash_attention_pallas(*map(jnp.asarray, (q, k, v)),
                                    causal=False, block_q=16, block_kv=32,
                                    interpret=True)
    ref = attention_ref(*map(jnp.asarray, (q, k, v)), causal=False)
    for want in (pallas, ref):
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5)
    s = np.einsum("bqhd,bkhd->bhqk", q, np.repeat(k, group, axis=2)) / 4.0
    want_lse = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + \
        s.max(-1)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("Sq,Skv", [(24, 65), (40, 40)])
def test_non_causal_blockwise_backward_matches_jax_grad(Sq, Skv):
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, Sq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, Skv, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, Skv, 2, 16)).astype(np.float32)
    w = rng.standard_normal((2, Sq, 4, 16)).astype(np.float32)

    def jloss(q, k, v):
        out = JA.blockwise_attention(q, k, v, causal=False, q_block=16,
                                     kv_block=32)
        return jnp.sum(out * w)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = TA.blockwise_attention(tq, tk, tv, causal=False, q_block=16,
                                 kv_block=32)
    (out * torch.from_numpy(w)).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def _counting(monkeypatch):
    calls = {"flash": 0, "rms": 0, "decode": 0}
    for name, mod, attr in (("flash", FA, "flash_attention"),
                            ("rms", RN, "rms_norm"),
                            ("decode", DA, "decode_attention")):
        fn = getattr(mod, attr)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(mod, attr, wrapped)
    return calls


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_serving_launches_equal_the_smokes_counts(monkeypatch):
    """What chip_smoke.py asserts on the card, counted here by calls into
    the wrappers: an encode runs one flash attention a layer and 2 L + 1
    RMSNorms; a decode step 3 RMSNorms a layer and the final one, and
    two decode attentions a layer (self and cross)."""
    calls = _counting(monkeypatch)
    _, tcfg, _, tp = _models("float32")
    smoke = _smoke()
    fr = torch.from_numpy(_frames(tcfg))
    with torch.no_grad():
        TED.encode(tp, tcfg, fr)
    assert (calls["rms"], calls["flash"]) == smoke.encode_launches(tcfg)
    _, cache, _ = TED.encdec_prefill(tp, tcfg, fr,
                                     torch.zeros(2, 1, dtype=torch.int32), 8)
    for k in calls:
        calls[k] = 0
    TED.encdec_decode_step(tp, tcfg, torch.ones(2, 1, dtype=torch.int32),
                           cache)
    want = smoke.decode_launches_per_step(tcfg)
    assert (calls["rms"], calls["decode"], calls["flash"]) == \
        (want[0], want[1], want[2]) == (3 * 2 + 1, 2 * 2, 0)


@pytest.mark.parametrize("arch,R", [(ARCH, 2), (ARCH, 1),
                                    ("qwen2-vl-7b", 2)])
def test_launches_per_train_step_equal_the_smokes_count(arch, R,
                                                         monkeypatch):
    """One train step with remat (2 microbatches) makes the flash and
    RMSNorm launches ``train_launches_per_step`` says: the encoder's
    layers, the decoders' self and cross attentions."""
    calls = _counting(monkeypatch)
    cfg = dataclasses.replace(TC.get_reduced(arch), block_repeat=R)
    gen = torch.Generator().manual_seed(0)
    params = (TED.init_encdec_params(gen, cfg, device="cpu")
              if cfg.encoder is not None
              else TT.init_params(gen, cfg, device="cpu"))
    batch = TokenPipeline(cfg.vocab_size, 12, 4).global_batch_at(0)
    batch.update(stub_inputs(cfg, 4, 12, 0, 0, "cpu"))
    TS.make_train_step(cfg, microbatches=2, remat=True)(
        params, TO.adamw_init(params), batch)
    want = _smoke().train_launches_per_step(cfg, 2)
    assert (calls["rms"], calls["flash"]) == (want[0], want[2])
    assert calls["decode"] == want[1] == want[3] == 0


def test_train_runs_the_encoder_decoder_and_resumes(tmp_path):
    """``launch.train`` draws frames per step from (seed, step): a run cut
    at step 2 and resumed ends where an unbroken run does."""
    log = []
    _, _, whole = train(ARCH, steps=3, batch=2, seq=8, device="cpu",
                        log=log.append)
    train(ARCH, steps=2, batch=2, seq=8, device="cpu", log=log.append,
          ckpt_dir=str(tmp_path), ckpt_every=2)
    _, _, rest = train(ARCH, steps=3, batch=2, seq=8, device="cpu",
                       log=log.append, ckpt_dir=str(tmp_path))
    assert rest == whole[2:] and all(np.isfinite(whole))
    assert stub_inputs(TC.get_reduced(ARCH), 2, 8, 1, 0,
                       "cpu")["frames"].shape == (2, 8, 64)
