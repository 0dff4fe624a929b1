"""MLA training (deepseek-v2-lite-16b) in the port against the JAX
reference on the CPU: whole train steps of deepseek REDUCED (the dense
prefix block, then MoE blocks; MLA's flash forward with v padded to the
width of q and k, and the plain backward with Dv != D), the launch
counts chip_smoke.py asserts, and ``launch.train`` at a cut depth with
crash-resume.

Tolerances, those of tests/test_torch_training.py: fp32 loss 1e-5, grad
norm rtol 1e-5, params and masters 1e-6; bf16 loss 5e-3, grad norm rtol
5e-3, masters 5e-5, params one bf16 ulp + 1e-4.

Routes: both frameworks run the reference's routes, recorded as its
step runs (``_reference_routes``), each gated by its own router logits.
In fp32 the port's own routes must equal them at every token.  In bf16
the two frameworks' hidden states round apart layer by layer, so their
fp32 router logits differ (ROUTER_TOL 0.1 on the largest difference of
a call [read on the CPU at seed 0 over 3 steps of 1 and 2
microbatches: 0.023 to 0.053]), and a near-tie may send a token to other
experts and move its loss by whole units.  The port's own routes may
then differ only where the reference's margin between its k-th and
(k+1)-th logits is below twice that call's difference, as a difference
of logits that small can reorder them [flips read at margins 1.1e-4 to
0.022; tests/test_torch_model.py's fixed ROUTE_TIE of 2e-2 for one
forward does not bound them here].
"""

import contextlib
import dataclasses
import importlib.util
from pathlib import Path
from unittest import mock

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.convert import (map_tree, params_from_jax,  # noqa: E402
                                 params_to_numpy, to_jax_layout, to_numpy)
from repro_torch.data.pipeline import TokenPipeline  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import rmsnorm as RN  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.layers import moe as TMOE  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.training import optimizer as TO  # noqa: E402

ARCH = "deepseek-v2-lite-16b"
ROUTER_TOL = 0.1
TRAIN_TOL = {
    "float32": dict(loss=1e-5, gnorm=1e-5, master=1e-6,
                    params=dict(rtol=0, atol=1e-6)),
    "bfloat16": dict(loss=5e-3, gnorm=5e-3, master=5e-5,
                     params=dict(rtol=2.0 ** -7, atol=1e-4)),
}


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t).astype(np.float32)


@contextlib.contextmanager
def _reference_routes(near_ties: bool):
    """Inside: each ``jax.lax.top_k`` the reference traces also records,
    through an ordered ``jax.debug.callback``, its router logits and the
    experts it picked.  The port's MoE layers take those experts in
    order, gated by the softmax of the port's own router logits at them,
    after checking that the port's own router logits lie within
    ROUTER_TOL of the reference's and that its own top-k picks the same
    experts at every token, or with ``near_ties`` at every token but
    those whose reference margin is below twice the call's largest logit
    difference.  Yields the count of tokens that picked others."""
    routes, flips = [], [0]
    top_k, route = jax.lax.top_k, TMOE.route

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
        own_logits = x.float() @ params["router"]
        diff = float((own_logits.detach() - logits).abs().max())
        assert diff <= ROUTER_TOL, diff
        same = (own.sort(-1).values == experts.sort(-1).values).all(-1)
        ranked = logits.sort(-1, descending=True).values
        tie = ranked[..., top_k - 1] - ranked[..., top_k] < 2 * diff
        assert bool((same | (tie & near_ties)).all()), \
            "the port picked other experts away from a near-tie"
        flips[0] += int((~same).sum())
        return own_logits.gather(-1, experts).softmax(-1), experts

    with mock.patch.object(jax.lax, "top_k", recording), \
            mock.patch.object(TMOE, "route", replaying):
        yield flips
    assert not routes, f"{len(routes)} recorded routes were not taken"


def _models(dtype, seed=0):
    jcfg = dataclasses.replace(JC.get_reduced(ARCH), dtype=dtype)
    tcfg = dataclasses.replace(TC.get_reduced(ARCH), dtype=dtype)
    jp = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_jax(jax.device_get(jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("dtype,microbatches,remat", [
    ("float32", 1, False),
    ("float32", 2, True),
    ("float32", 1, True),
    ("bfloat16", 1, False),
    ("bfloat16", 2, True),
])
def test_deepseek_train_step_matches_reference(dtype, microbatches, remat):
    """Three steps of deepseek REDUCED (a dense prefix block and two MoE
    blocks) against the JAX train step: loss, grad norm, the updated
    parameters and masters.  Both frameworks run the same routes (the
    reference's, recorded as its step runs); in fp32 the port's own are
    the same everywhere, in bf16 away from near-ties.  With remat both
    route again in the backward's recomputation, block after block in
    the same order, so the recorded routes are taken in turn there
    too."""
    tol = TRAIN_TOL[dtype]
    jcfg, tcfg, jp, tp = _models(dtype)
    jo, to = JO.adamw_init(jp), TO.adamw_init(tp)
    tstep = TS.make_train_step(tcfg, microbatches=microbatches, remat=remat)
    rng = np.random.default_rng(0)
    for _ in range(3):
        toks = rng.integers(0, jcfg.vocab_size, (4, 17)).astype(np.int32)
        with _reference_routes(near_ties=dtype == "bfloat16"):
            # a fresh trace each step, so every step records its routes
            jstep = jax.jit(JS.make_train_step(jcfg,
                                               microbatches=microbatches,
                                               remat=remat))
            jp, jo, jm = jstep(jp, jo, {"tokens": jnp.asarray(toks[:, :-1]),
                                        "labels": jnp.asarray(toks[:, 1:])})
            jax.effects_barrier()
            tp, to, tm = tstep(tp, to, {
                "tokens": torch.from_numpy(toks[:, :-1].copy()),
                "labels": torch.from_numpy(toks[:, 1:].copy())})
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= tol["loss"]
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]),
                                   rtol=tol["gnorm"])
        tparams = params_to_numpy(tp, tcfg)
        tmaster = map_tree(to_numpy, to_jax_layout(to.master))
        jmaster = jax.device_get(jo.master)
        leaves = jax.tree_util.tree_flatten_with_path(jax.device_get(jp))[0]
        assert any(getattr(p[0], "key", None) == "prefix" for p, _ in leaves)
        for path, want in leaves:
            got, gm, wm = tparams, tmaster, jmaster
            for p in path:
                key = p.key if hasattr(p, "key") else p.idx
                got, gm, wm = got[key], gm[key], wm[key]
            if np.asarray(want).dtype == ml_dtypes.bfloat16:
                got = got.view(ml_dtypes.bfloat16)
            np.testing.assert_allclose(_np(got), _np(want), **tol["params"])
            np.testing.assert_allclose(gm, np.asarray(wm), rtol=0,
                                       atol=tol["master"])


def test_launches_equal_the_smokes_count(monkeypatch):
    """chip_smoke.py asserts ``train_launches_per_step`` on the card; here
    it equals the calls into the two wrappers of one step with remat:
    the prefix block is not checkpointed and runs once a microbatch, each
    MoE block twice.  For deepseek FULL at depth 2 (2 microbatches): 14
    RMSNorms and 6 flash attentions a step."""
    calls = {"flash": 0, "rms": 0}
    flash, rms = FA.flash_attention, RN.rms_norm

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(FA, "flash_attention", count("flash", flash))
    monkeypatch.setattr(RN, "rms_norm", count("rms", rms))
    cfg = TC.get_reduced(ARCH)
    params = TT.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    TS.make_train_step(cfg, microbatches=2, remat=True)(
        params, TO.adamw_init(params),
        TokenPipeline(cfg.vocab_size, 16, 4).global_batch_at(0))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    want = smoke.train_launches_per_step(cfg, 2)
    R = cfg.block_repeat - cfg.first_k_dense
    assert (calls["rms"], calls["flash"]) == (want[0], want[2])
    assert want == ((2 * (1 + 2 * R) + 1) * 2, 0, (1 + 2 * R) * 2, 0)
    full = dataclasses.replace(TC.get_config(ARCH), block_repeat=2)
    assert smoke.train_launches_per_step(full, 2) == (14, 0, 6, 0)


def test_train_at_a_cut_depth_resumes_bit_exact(tmp_path):
    """``launch.train`` trains deepseek REDUCED cut to its prefix block and
    one MoE block; an interrupted run resumed from its checkpoint ends
    where an unbroken one does."""
    kw = dict(steps=4, batch=2, seq=16, ckpt_every=2, device="cpu",
              log=lambda *a: None, depth=2)
    p1, o1, l1 = train(ARCH, ckpt_dir=str(tmp_path / "a"), **kw)
    assert all(np.isfinite(l1))
    assert len(p1.prefix) == 1 and len(p1.blocks) == 1
    train(ARCH, ckpt_dir=str(tmp_path / "b"), **dict(kw, steps=2))
    p2, o2, l2 = train(ARCH, ckpt_dir=str(tmp_path / "b"), **kw)
    assert l2 == l1[2:]
    for (n1, a), (n2, b) in zip(p1.named_parameters(),
                                p2.named_parameters()):
        assert n1 == n2 and torch.equal(a, b)
    for name in o1.master:
        assert torch.equal(o1.master[name], o2.master[name])
