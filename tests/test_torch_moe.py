"""The MoE slice of the port against the JAX reference on the CPU: the
mixtral configs, ``moe_forward`` and its routing (with the tie order of
``jax.lax.top_k``), the parameter tree of a MoE model and its conversion
both ways, and AdamW over a bf16 MoE model's fp32 router.

Inputs are drawn with numpy from a seed and handed to both sides (bf16
crosses bit for bit).  Routes: both sides take the top-k of the same
fp32 router logits, which differ by summation order only, so every
route must agree in fp32; in bf16 a failing comparison names the routes
that differ.  Output tolerances (readings on the CPU over the cases
below and router seeds 3, 7 and 11 in brackets): fp32 2e-5 [9.5e-7];
bf16 5e-2 [3.1e-2, two bf16 ulps of an output of |y| < 4].  In bf16 the
two frameworks round the expert products, SiLU and GELU at other
places, and the sum over experts accumulates in bf16 on both sides, as
in the reference.
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
from repro.layers import moe as JMOE  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.convert import (load_jax_layout, params_from_jax,  # noqa
                                 params_to_numpy, to_jax_layout, to_torch)
from repro_torch.layers import moe as TMOE  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.training import optimizer as TO  # noqa: E402

ARCH = "mixtral-8x7b"
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 2e-5, "bfloat16": 5e-2}
D, F_EXPERT, N_ROUTED = 64, 96, 4           # mixtral REDUCED's FFN


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t).astype(np.float32)


def _port_moe(tree) -> TMOE.MoEParams:
    """The port's MoE parameters holding the reference's leaves."""
    def pd(t):
        return nn.ParameterDict({k: nn.Parameter(to_torch(v),
                                                 requires_grad=False)
                                 for k, v in t.items()})
    routed = {k: v for k, v in tree.items() if k != "shared"}
    return TMOE.MoEParams(pd(routed),
                          pd(tree["shared"]) if "shared" in tree else None)


def _routes(jparams, x, top_k):
    logits = np.asarray(x).astype(np.float32) @ np.asarray(
        jparams["router"])
    return np.asarray(jax.lax.top_k(jnp.asarray(logits), top_k)[1])


def test_mixtral_configs_equal_reference():
    for get in ("get_config", "get_reduced"):
        assert dataclasses.asdict(getattr(JC, get)(ARCH)) == \
            dataclasses.asdict(getattr(TC, get)(ARCH))
    assert TC.get_config(ARCH).ffn_kind == "moe"


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("n_shared", [0, 1])
@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("B,S", [(2, 5), (1, 1)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_forward_matches_reference(dtype, B, S, gated, n_shared, top_k):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jp = jax.device_get(JMOE.init_moe(
        jax.random.PRNGKey(3), D, F_EXPERT, N_ROUTED, top_k, n_shared,
        gated, dtype=jdt))
    assert jp["router"].dtype == np.float32
    x = np.random.default_rng(4).standard_normal((B, S, D)).astype(
        np.float32)
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
    want = JMOE.moe_forward(jp, jnp.asarray(x), top_k)
    tp = _port_moe(jp)
    tx = to_torch(x)
    with torch.no_grad():
        got = TMOE.moe_forward(tp, tx, top_k)
        _, experts = TMOE.route(tp, tx, top_k)
    assert got.dtype == tx.dtype and tuple(got.shape) == (B, S, D)
    flips = np.argwhere(experts.numpy() != _routes(jp, x, top_k))
    if dtype == "float32":
        assert not len(flips), f"routes differ at (b, s, k) {flips.tolist()}"
    err = float(np.abs(_np(got) - _np(want)).max())
    assert err <= TOL[dtype], (f"max abs err {err:.3e}; routes that differ "
                               f"at (b, s, k): {flips.tolist()}")


@pytest.mark.parametrize("top_k", [1, 2])
def test_equal_router_logits_pick_the_lower_expert_first(top_k):
    """Two equal router columns: the lower index comes first, as
    ``jax.lax.top_k`` orders ties, and the two gates are equal exactly."""
    rng = np.random.default_rng(5)
    router = -np.abs(rng.standard_normal((D, N_ROUTED))).astype(np.float32)
    router[:, 1] = router[:, 2] = 1.0
    x = np.abs(rng.standard_normal((2, 3, D))).astype(np.float32)
    params = nn.ParameterDict({"router": nn.Parameter(
        torch.from_numpy(router), requires_grad=False)})
    gates, experts = TMOE.route(params, torch.from_numpy(x), top_k)
    want = np.asarray(jax.lax.top_k(jnp.asarray(x @ router), top_k)[1])
    np.testing.assert_array_equal(experts.numpy(), want)
    np.testing.assert_array_equal(experts.numpy(),
                                  np.broadcast_to([1, 2][:top_k],
                                                  (2, 3, top_k)))
    if top_k == 2:
        assert torch.equal(gates[..., 0], gates[..., 1])
        assert bool((gates == 0.5).all())


@pytest.mark.parametrize("n_shared", [0, 1])
@pytest.mark.parametrize("dtype", DTYPES)
def test_init_params_gives_the_reference_tree(dtype, n_shared):
    """Same leaves, shapes and dtypes as the reference's ``init_params``;
    the router fp32 in a bf16 model."""
    jcfg = dataclasses.replace(JC.get_reduced(ARCH), dtype=dtype,
                               n_shared=n_shared)
    tcfg = dataclasses.replace(TC.get_reduced(ARCH), dtype=dtype,
                               n_shared=n_shared)
    jtree = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0),
                                                  jcfg))
    tp = TT.init_params(torch.Generator().manual_seed(0), tcfg,
                        device="cpu")
    ttree = to_jax_layout(dict(tp.named_parameters()))
    jleaves = jax.tree_util.tree_flatten_with_path(jtree)[0]
    assert len(jleaves) == len(jax.tree.leaves(ttree))
    for path, want in jleaves:
        got = ttree
        for p in path:
            got = got[p.key]
        assert tuple(got.shape) == want.shape, path
        assert str(got.dtype).split(".")[-1] == str(want.dtype), path
    ffn = tp.blocks[0]["l0"].ffn
    assert ffn["router"].dtype == torch.float32
    assert (ffn.shared is not None) == bool(n_shared)


@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_params_cross_bit_for_bit_with_shared_experts(dtype):
    """``params_from_jax`` copies every leaf bit for bit (the fp32 router
    stays fp32), ``params_to_numpy`` gives the reference's tree back, and
    ``load_jax_layout`` puts it back into a fresh model."""
    jcfg = dataclasses.replace(JC.get_reduced(ARCH), dtype=dtype,
                               n_shared=1)
    tcfg = dataclasses.replace(TC.get_reduced(ARCH), dtype=dtype,
                               n_shared=1)
    tree = jax.device_get(JT.init_params(jax.random.PRNGKey(2), jcfg))
    assert "shared" in tree["blocks"]["l0"]["ffn"]
    tp = params_from_jax(tree, tcfg, device="cpu")
    back = params_to_numpy(tp, tcfg)
    fresh = TT.init_params(torch.Generator().manual_seed(1), tcfg,
                           device="cpu")
    load_jax_layout(fresh, to_jax_layout(dict(tp.named_parameters())))
    again = params_to_numpy(fresh, tcfg)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(jax.tree.leaves(back)) == len(flat)
    for path, want in flat:
        got, got2 = back, again
        for p in path:
            got, got2 = got[p.key], got2[p.key]
        want = np.asarray(want)
        for g in (got, got2):
            if want.dtype == ml_dtypes.bfloat16:
                assert g.dtype == np.uint16
                g = g.view(ml_dtypes.bfloat16)
            assert g.dtype == want.dtype and g.shape == want.shape, path
            np.testing.assert_array_equal(g.view(np.uint8),
                                          want.view(np.uint8))
    assert tp.blocks[0]["l0"].ffn["router"].dtype == torch.float32
    assert tp.blocks[1]["l0"].ffn.shared["w_up"].dtype == \
        getattr(torch, dtype)


def test_adamw_takes_the_fp32_router_beside_bf16_experts(monkeypatch):
    """AdamW over a bf16 mixtral: fp32 masters of every leaf, the router
    updated in fp32 and the experts cast back to bf16; the update equals
    the reference's, and cutting the leaves into small groups changes no
    number."""
    jcfg = dataclasses.replace(JC.get_reduced(ARCH), dtype="bfloat16")
    tcfg = dataclasses.replace(TC.get_reduced(ARCH), dtype="bfloat16")
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.device_get(jp), tcfg, device="cpu")
    named = dict(tp.named_parameters())
    rng = np.random.default_rng(6)
    grads = {n: rng.standard_normal(tuple(p.shape)).astype(np.float32)
             for n, p in named.items()}
    results = []
    for group_elems in (TO.GROUP_ELEMS, 3000):
        monkeypatch.setattr(TO, "GROUP_ELEMS", group_elems)
        params = {n: p.detach().clone() for n, p in named.items()}
        state = TO.adamw_init(params)
        assert {m.dtype for m in state.master.values()} == {torch.float32}
        params, state, _ = TO.adamw_update(
            params, {n: torch.from_numpy(g).to(named[n].dtype)
                     for n, g in grads.items()}, state, 1e-3)
        results.append((params, state))
    (p1, s1), (p2, s2) = results
    for n in named:
        assert p1[n].dtype == named[n].dtype
        assert torch.equal(p1[n], p2[n])
        assert torch.equal(s1.master[n], s2.master[n])
    router = "blocks.0.l0.ffn.router"
    assert p1[router].dtype == torch.float32
    assert p1["blocks.0.l0.ffn.w_up"].dtype == torch.bfloat16
    jgrads = to_jax_layout({n: torch.from_numpy(g).to(named[n].dtype)
                            for n, g in grads.items()})
    jgrads = jax.tree.map(lambda t: jnp.asarray(_np(t)).astype(
        jnp.float32 if t.dtype == torch.float32 else jnp.bfloat16), jgrads)
    jw, jstate, _ = JO.adamw_update(jp, jgrads, JO.adamw_init(jp), 1e-3)
    tmaster = to_jax_layout(s1.master)
    for path, want in jax.tree_util.tree_flatten_with_path(
            jax.device_get(jstate.master))[0]:
        got = tmaster
        for p in path:
            got = got[p.key]
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                                   atol=1e-8)
