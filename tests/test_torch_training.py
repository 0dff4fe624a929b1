"""The training path of the port against the JAX reference on the CPU:
chunked cross-entropy, AdamW and its schedule, whole train steps on the
REDUCED dense configs, the token pipeline, checkpoints (also read across
the two packages) and crash-resume of ``launch.train``.

Tolerances:
  * ``chunked_ce_loss``: fp32 rtol 1e-5 on the loss and its gradients
    (summation order of the fp32 logsumexp);
  * AdamW: fp32 rtol 1e-6 atol 1e-8 (the same elementwise formula; torch
    may fuse a multiply-add, and a moment that nearly cancels keeps only
    its absolute error of ~1e-9);
  * ``make_train_step``, 3 steps, fp32: loss 1e-5, grad norm rtol 1e-5,
    params and masters 1e-6 (read: 9.5e-7, 1.9e-7 and 1.5e-7 over both
    configs, 1-2 microbatches, remat on and off).  bf16: loss 5e-3, grad
    norm rtol 5e-3, masters 5e-5, params one bf16 ulp + 1e-4 (read:
    1.9e-3, 1.8e-3, 2.5e-5 and 3.1e-5).  In bf16 the reference's
    attention rounds p to bf16 and keeps its accumulator in bf16 where
    the port keeps fp32, so gradients differ in the third digit, and a
    gradient near zero can flip the sign of its Adam update, moving a
    master by up to 2 lr.
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
from repro.launch import steps as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.training import checkpoint as JCK  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.convert import (map_tree, params_from_jax,  # noqa: E402
                                 params_to_numpy, to_jax_layout, to_numpy)
from repro_torch.data.pipeline import TokenPipeline  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import rmsnorm as RN  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch.train import train, train_state  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.training import checkpoint as TCK  # noqa: E402
from repro_torch.training import optimizer as TO  # noqa: E402


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


# -- loss -----------------------------------------------------------------------

@pytest.mark.parametrize("S,chunk", [(32, 8), (30, 8), (5, 512)])
def test_chunked_ce_loss_and_grads_match_reference(S, chunk):
    rng = np.random.default_rng(0)
    B, d, V = 2, 16, 50
    hidden = rng.standard_normal((B, S, d)).astype(np.float32)
    head = (rng.standard_normal((d, V)) / 4).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)

    def f(h, w):
        return JS.chunked_ce_loss(h, w, jnp.asarray(labels), chunk=chunk)

    jloss, (jdh, jdw) = jax.value_and_grad(f, argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(head))
    th = torch.from_numpy(hidden).requires_grad_()
    tw = torch.from_numpy(head).requires_grad_()
    tloss = TS.chunked_ce_loss(th, tw, torch.from_numpy(labels),
                               chunk=chunk)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jdh), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), rtol=1e-5,
                               atol=1e-7)


# -- optimizer --------------------------------------------------------------------

@pytest.mark.parametrize("grad_scale", [10.0, 1e-2])   # clip on, clip off
def test_adamw_update_matches_reference(grad_scale):
    rng = np.random.default_rng(1)
    shapes = {"a": (3, 4), "b": (7,), "c": (2, 2, 2)}
    w0 = {n: rng.standard_normal(s).astype(np.float32)
          for n, s in shapes.items()}
    jw = {n: jnp.asarray(a) for n, a in w0.items()}
    tw = {n: torch.from_numpy(a.copy()) for n, a in w0.items()}
    jstate, tstate = JO.adamw_init(jw), TO.adamw_init(tw)
    for step in range(3):
        g = {n: (grad_scale * rng.standard_normal(s)).astype(np.float32)
             for n, s in shapes.items()}
        lr = 1e-2 * (step + 1)
        jw, jstate, jm = JO.adamw_update(
            jw, {n: jnp.asarray(a) for n, a in g.items()}, jstate, lr)
        tw, tstate, tm = TO.adamw_update(
            tw, {n: torch.from_numpy(a) for n, a in g.items()}, tstate, lr)
        assert int(tstate.step) == int(jstate.step) == step + 1
        assert (float(jm["grad_norm"]) > 1.0) == (grad_scale > 1.0)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        for n in shapes:
            for mine, ref in ((tw[n], jw[n]), (tstate.master[n],
                                               jstate.master[n]),
                              (tstate.m[n], jstate.m[n]),
                              (tstate.v[n], jstate.v[n])):
                np.testing.assert_allclose(_np(mine), _np(ref), rtol=1e-6,
                                           atol=1e-8)


def test_adamw_casts_params_from_fp32_masters():
    w = {"x": torch.tensor([0.3, -1.7], dtype=torch.bfloat16)}
    state = TO.adamw_init(w)
    assert state.master["x"].dtype == torch.float32
    w, state, _ = TO.adamw_update(w, {"x": torch.ones(2, dtype=torch.bfloat16)},
                                  state, lr=1e-3)
    assert w["x"].dtype == torch.bfloat16
    assert torch.equal(w["x"], state.master["x"].to(torch.bfloat16))


def test_cosine_lr_matches_reference():
    for step in (0, 1, 50, 99, 100, 101, 5000, 9999, 10000, 20000):
        np.testing.assert_allclose(
            TO.cosine_lr(step), float(JO.cosine_lr(jnp.asarray(step))),
            rtol=1e-6)
    assert TO.cosine_lr(1) == pytest.approx(3e-6)


# -- train step ---------------------------------------------------------------------

def _train_pair(arch, dtype, microbatches, remat, steps=3, seed=0, B=4,
                S=16):
    """Yield (jax metrics, port metrics, jax state, port state) per step
    from the same weights and batches."""
    jcfg = dataclasses.replace(JC.get_reduced(arch), dtype=dtype)
    tcfg = dataclasses.replace(TC.get_reduced(arch), dtype=dtype)
    jp = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_jax(jax.device_get(jp), tcfg, device="cpu")
    jo, to = JO.adamw_init(jp), TO.adamw_init(tp)
    jstep = jax.jit(JS.make_train_step(jcfg, microbatches=microbatches,
                                       remat=remat))
    tstep = TS.make_train_step(tcfg, microbatches=microbatches,
                               remat=remat)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        toks = rng.integers(0, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
        jp, jo, jm = jstep(jp, jo, {"tokens": jnp.asarray(toks[:, :-1]),
                                    "labels": jnp.asarray(toks[:, 1:])})
        tp, to, tm = tstep(tp, to, {
            "tokens": torch.from_numpy(toks[:, :-1].copy()),
            "labels": torch.from_numpy(toks[:, 1:].copy())})
        yield jm, tm, (jp, jo), (params_to_numpy(tp, tcfg), to)


TRAIN_TOL = {
    "float32": dict(loss=1e-5, gnorm=1e-5, master=1e-6,
                    params=dict(rtol=0, atol=1e-6)),
    "bfloat16": dict(loss=5e-3, gnorm=5e-3, master=5e-5,
                     params=dict(rtol=2.0 ** -7, atol=1e-4)),
}


@pytest.mark.parametrize("arch,dtype,microbatches,remat", [
    ("qwen2-0.5b", "float32", 1, False),
    ("qwen2-0.5b", "float32", 2, True),
    ("internlm2-1.8b", "float32", 1, True),
    ("internlm2-1.8b", "float32", 2, False),
    ("qwen2-0.5b", "bfloat16", 2, True),
    ("mixtral-8x7b", "float32", 1, False),
    ("mixtral-8x7b", "float32", 2, True),
    ("gemma3-12b", "float32", 2, True),
    ("gemma3-12b", "bfloat16", 2, True),
])
def test_train_step_matches_reference(arch, dtype, microbatches, remat):
    tol = TRAIN_TOL[dtype]
    for jm, tm, (jp, jo), (tp, to) in _train_pair(arch, dtype, microbatches,
                                                  remat):
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= tol["loss"]
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]),
                                   rtol=tol["gnorm"])
        assert int(to.step) == int(jo.step)
        jleaves = jax.tree_util.tree_flatten_with_path(jax.device_get(jp))[0]
        tmaster = map_tree(to_numpy, to_jax_layout(to.master))
        jmaster = jax.device_get(jo.master)
        for path, want in jleaves:
            got, gm, wm = tp, tmaster, jmaster
            for p in path:
                got, gm, wm = got[p.key], gm[p.key], wm[p.key]
            if dtype == "bfloat16":
                got = got.view(ml_dtypes.bfloat16)
            np.testing.assert_allclose(_np(got), _np(want), **tol["params"])
            np.testing.assert_allclose(gm, np.asarray(wm), rtol=0,
                                       atol=tol["master"])


@pytest.mark.parametrize("remat", [False, True])
def test_kernel_calls_per_train_step(remat, monkeypatch):
    """The launch counts chip_smoke.py asserts, derived on the CPU by
    counting calls into the two kernel wrappers: per microbatch, the
    forward runs R flash attentions and 2R + 1 RMSNorms (two per layer
    and the final norm); with remat, the backward runs each block's
    forward again: R more flash attentions and 2R more RMSNorms."""
    calls = {"flash": 0, "rms": 0}
    flash, rms = FA.flash_attention, RN.rms_norm

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(FA, "flash_attention", count("flash", flash))
    monkeypatch.setattr(RN, "rms_norm", count("rms", rms))
    cfg = TC.get_reduced("qwen2-0.5b")
    R, mb = cfg.block_repeat, 2
    params = TT.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    opt = TO.adamw_init(params)
    batch = TokenPipeline(cfg.vocab_size, 16, 4).global_batch_at(0)
    step = TS.make_train_step(cfg, microbatches=mb, remat=remat)
    step(params, opt, batch)
    again = 1 if remat else 0
    assert calls["flash"] == R * mb * (1 + again)
    assert calls["rms"] == (2 * R + 1) * mb + 2 * R * mb * again


@pytest.mark.parametrize("arch,R", [("gemma3-12b", 1), ("gemma3-12b", 2),
                                    ("qwen2-0.5b", 2)])
def test_launches_per_train_step_equal_the_smokes_count(arch, R,
                                                         monkeypatch):
    """chip_smoke.py asserts ``train_launches_per_step`` on the card; here
    it must equal the calls into the two kernel wrappers of one step with
    remat, for gemma3's blocks of three layers (each also checkpointed
    inside the block's checkpoint) and qwen2's single-layer blocks."""
    calls = {"flash": 0, "rms": 0}
    flash, rms = FA.flash_attention, RN.rms_norm

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(FA, "flash_attention", count("flash", flash))
    monkeypatch.setattr(RN, "rms_norm", count("rms", rms))
    cfg = dataclasses.replace(TC.get_reduced(arch), block_repeat=R)
    params = TT.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    batch = TokenPipeline(cfg.vocab_size, 24, 4).global_batch_at(0)
    TS.make_train_step(cfg, microbatches=2, remat=True)(
        params, TO.adamw_init(params), batch)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    want = smoke.train_launches_per_step(cfg, 2)
    assert (calls["rms"], calls["flash"]) == (want[0], want[2])
    assert want[1] == want[3] == 0


# -- data -------------------------------------------------------------------------

def test_pipeline_deterministic_and_sharded():
    pipe = TokenPipeline(vocab_size=100, seq_len=8, global_batch=4,
                         num_shards=2, seed=7)
    a = pipe.batch(3, 0)
    b = pipe.batch(3, 0)
    assert torch.equal(a["tokens"], b["tokens"])               # recomputable
    assert a["tokens"].dtype == torch.int32
    c = pipe.batch(3, 1)
    assert not torch.equal(a["tokens"], c["tokens"])           # shards differ
    d = pipe.batch(4, 0)
    assert not torch.equal(a["tokens"], d["tokens"])           # steps differ
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])  # shifted
    g = pipe.global_batch_at(0)
    assert tuple(g["tokens"].shape) == (4, 8)
    assert torch.equal(g["tokens"][2:], pipe.batch(0, 1)["tokens"])
    other = TokenPipeline(vocab_size=100, seq_len=8, global_batch=4,
                          num_shards=2, seed=8)
    assert not torch.equal(other.batch(3, 0)["tokens"], a["tokens"])
    with pytest.raises(ValueError):
        TokenPipeline(vocab_size=100, seq_len=8, global_batch=3,
                      num_shards=2)


def test_pipeline_draws_zipf_tokens():
    pipe = TokenPipeline(vocab_size=1000, seq_len=512, global_batch=8)
    toks = pipe.global_batch_at(0)["tokens"].flatten()
    counts = torch.bincount(toks.long(), minlength=1000).float()
    p = 1.0 / torch.arange(1, 1001, dtype=torch.float64) ** 1.2
    want = float(p[0] / p.sum())                           # ~0.18
    assert abs(float(counts[0]) / toks.numel() - want) < 0.02
    assert counts[0] > counts[1] > counts[10]


# -- checkpoints --------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    mgr = TCK.CheckpointManager(str(tmp_path), keep=2)
    state = {"a": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
             "b": {"c": torch.ones(4, dtype=torch.float32)},
             "n": np.arange(3, dtype=np.int32)}
    mgr.save(5, state, extra={"rng": 42})
    step, restored, extra = mgr.restore(state)
    assert step == 5 and extra["rng"] == 42
    assert restored["a"].dtype == torch.bfloat16
    assert torch.equal(restored["a"], state["a"])
    assert torch.equal(restored["b"]["c"], state["b"]["c"])
    assert torch.equal(restored["n"], torch.arange(3, dtype=torch.int32))


def test_checkpoint_rotation_and_corruption(tmp_path):
    import os
    mgr = TCK.CheckpointManager(str(tmp_path), keep=2)
    state = {"w": torch.ones(3)}
    for s in (1, 2, 3):
        mgr.save(s, state)
    assert len(mgr.list_checkpoints()) == 2      # rotated
    # corrupt the newest; restore must fall back to the older one
    newest = mgr.list_checkpoints()[-1]
    victim = [f for f in os.listdir(newest) if f.endswith(".npy")][0]
    with open(os.path.join(newest, victim), "wb") as f:
        f.write(b"garbage")
    step, _, _ = mgr.restore(state)
    assert step == 2
    with pytest.raises(FileNotFoundError):
        mgr.restore({"missing": torch.ones(3)})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_between_packages(tmp_path, dtype):
    """A port checkpoint of the train state, in the reference's layout,
    restores through the reference's manager into its own template as the
    same arrays, and a reference checkpoint restores through the port's."""
    jcfg = dataclasses.replace(JC.get_reduced("qwen2-0.5b"), dtype=dtype)
    tcfg = dataclasses.replace(TC.get_reduced("qwen2-0.5b"), dtype=dtype)
    jp = JT.init_params(jax.random.PRNGKey(3), jcfg)
    tp = params_from_jax(jax.device_get(jp), tcfg, device="cpu")
    jo, to = JO.adamw_init(jp), TO.adamw_init(tp)
    TCK.CheckpointManager(str(tmp_path / "port")).save(
        7, train_state(tp, to))
    step, (rp, ro), _ = JCK.CheckpointManager(
        str(tmp_path / "port")).restore((jp, jo))
    assert step == 7
    for want, got in ((jp, rp), (jo.master, ro.master), (jo.v, ro.v)):
        for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(np.asarray(a).view(np.uint8),
                                          np.asarray(b).view(np.uint8))
    assert int(ro.step) == 0
    JCK.CheckpointManager(str(tmp_path / "jax")).save(9, (jp, jo))
    step, state, _ = TCK.CheckpointManager(str(tmp_path / "jax")).restore(
        train_state(tp, to))
    assert step == 9
    back = map_tree(to_numpy, state[0])
    for path, want in jax.tree_util.tree_flatten_with_path(
            jax.device_get(jp))[0]:
        got = back
        for p in path:
            got = got[p.key]
        np.testing.assert_array_equal(got.view(np.uint8),
                                      np.asarray(want).view(np.uint8))
    assert tp.embed.dtype == state[0]["embed"].dtype


# -- train ------------------------------------------------------------------------

def test_train_resume_bitexact(tmp_path):
    """Crash-resume yields the same state as an uninterrupted run."""
    kw = dict(steps=4, batch=2, seq=16, ckpt_every=2, device="cpu",
              log=lambda *a: None)
    p1, o1, l1 = train("qwen2-0.5b", ckpt_dir=str(tmp_path / "a"), **kw)
    # interrupted run: 2 steps, then resume to 4
    train("qwen2-0.5b", ckpt_dir=str(tmp_path / "b"),
          **dict(kw, steps=2))
    logs = []
    history = []
    p2, o2, l2 = train("qwen2-0.5b", ckpt_dir=str(tmp_path / "b"),
                       **dict(kw, log=logs.append), history=history)
    assert logs[0] == "resumed from step 2"
    assert [h["step"] for h in history] == [2, 3]
    assert l2 == l1[2:]
    for (n1, a), (n2, b) in zip(p1.named_parameters(),
                                p2.named_parameters()):
        assert n1 == n2 and torch.equal(a, b)
    for name in o1.master:
        assert torch.equal(o1.master[name], o2.master[name])
        assert torch.equal(o1.v[name], o2.v[name])
    assert int(o1.step) == int(o2.step) == 4


def test_train_picks_no_cpu_on_its_own_and_refuses_unported_archs():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train("qwen2-0.5b", steps=1, batch=2, seq=8)
    with pytest.raises(KeyError, match="not yet ported"):
        train("mamba3-1b", steps=1, batch=2, seq=8, device="cpu")
    # MLA, refused before the zamba2 slice, now trains (its dense prefix
    # block and one MoE block), and a depth must keep a block past the
    # prefix
    _, _, losses = train("deepseek-v2-lite-16b", steps=1, batch=2, seq=8,
                         device="cpu", log=lambda *a: None, depth=2)
    assert np.isfinite(losses).all()
    with pytest.raises(ValueError, match="prefix"):
        train("deepseek-v2-lite-16b", steps=1, batch=2, seq=8,
              device="cpu", depth=1)
    # embedding inputs, refused before the qwen2-vl slice, now train
    cfg = dataclasses.replace(TC.get_reduced("qwen2-0.5b"), embeds_input=True)
    params = TT.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    batch = {"embeds": torch.randn(2, 8, cfg.d_model),
             "labels": torch.zeros(2, 8, dtype=torch.int32)}
    _, _, m = TS.make_train_step(cfg)(params, TO.adamw_init(params), batch)
    assert np.isfinite(float(m["loss"])) and np.isfinite(
        float(m["grad_norm"]))


def test_a_parameter_cut_off_from_the_loss_raises():
    """Only an embeddings-fed arch's untied ``embed`` gets a zero gradient
    when the loss does not reach it; any other unreached parameter (here
    one added beside the model's) still raises, as autograd does."""
    cfg = TC.get_reduced("qwen2-0.5b")
    params = TT.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    params.register_parameter("stray", torch.nn.Parameter(torch.ones(3)))
    batch = {"tokens": torch.zeros(2, 8, dtype=torch.int32),
             "labels": torch.zeros(2, 8, dtype=torch.int32)}
    with pytest.raises(RuntimeError, match="not have been used"):
        TS.make_train_step(cfg)(params, TO.adamw_init(params), batch)
