"""The zamba2 slice of the port against the JAX reference on the CPU: the
config, the SSD scan at head dim 112 (split into panels of 64 by the
wrapper; the plain version against the TPU kernel in interpret mode and
its ref.py oracle), the zamba2 REDUCED model and a variant of it whose
SSD heads are 112 wide (``forward``, ``decode_step`` with every cache
leaf, ``prefill``, ``init_cache``), the tied shared block's gradient, a
whole train step, the launch counts chip_smoke.py asserts, checkpoints
across the two packages, and the engine serving the hybrid cache.

The CUDA kernels run only on the card (chip_smoke.py holds them against
their plain versions there); the wrappers take their plain versions for
CPU tensors.

Tolerances (readings on the CPU at seed 0 in brackets):
  * the panel split: the split plain version equals the unsplit one to
    1e-6 in fp32 [0: no sum runs over the head dim].
  * the scan at P 112: as tests/test_torch_ssm.py, fp32 2e-4, bf16 one
    bf16 ulp (rtol 2^-7) plus atol 1e-5 [fp32 4.7e-6 max abs; bf16 2.0e-3
    max abs, no element beyond one ulp].
  * the model, fp32: logits, hidden states and every cache leaf 1e-4
    [forward 6.1e-6, decode logits 3.8e-6, caches 3.1e-6]; bf16 as
    tests/test_torch_ssm.py's model tolerances (``forward`` 0.25,
    decode-step logits 0.15, conv windows 0.15, SSM state 1e-2), the
    shared block's K/V cache 0.15, tests/test_torch_model.py's
    DEEP_CACHE_TOL for caches past the first layers [forward 0.135,
    decode logits 0.083, conv windows 0.064, SSM state 6.3e-3, K/V
    0.094].  The reference rounds to bf16 inside its chunked scan and
    its attention where the port's kernels round once.
  * the tied block's gradient, fp32: rtol 1e-4 and atol 1e-4 times the
    largest gradient of the leaf (at least 1e-3) against ``jax.grad``
    [2.6e-6 of the largest]; the per-application copies sum to the tied
    gradient to 1e-6.
  * a train step: as tests/test_torch_training.py (fp32 loss 1e-5,
    grad norm rtol 1e-5, params and masters 1e-6; bf16 loss 5e-3, grad
    norm rtol 5e-3, masters 5e-5, params one bf16 ulp + 1e-4).
"""

import dataclasses
import importlib.util
import itertools
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.kernels.ssd_scan.ref import ssd_scan_ref  # noqa: E402
from repro.kernels.ssd_scan.ssd_scan import ssd_scan_pallas  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.training import checkpoint as JCK  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.convert import (cache_from_jax, jax_path,  # noqa: E402
                                 map_tree, params_from_jax,
                                 params_to_numpy, to_jax_layout, to_numpy,
                                 to_torch)
from repro_torch.data.pipeline import TokenPipeline  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import rmsnorm as RN  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.launch.train import train, train_state  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving import engine as engine_mod  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.training import checkpoint as TCK  # noqa: E402
from repro_torch.training import optimizer as TO  # noqa: E402

ARCH = "zamba2-7b"
DTYPES = ["float32", "bfloat16"]
# the REDUCED config, and one whose SSD heads are zamba2's 112 wide
VARIANTS = {"reduced": {}, "p112": dict(d_inner=224, n_ssd_heads=2)}
FORWARD_TOL = {"float32": 1e-4, "bfloat16": 0.25}
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 0.15}
CACHE_TOL = {"float32": {"ssm": 1e-4, "conv_x": 1e-4, "conv_bc": 1e-4,
                         "k": 1e-4, "v": 1e-4},
             "bfloat16": {"ssm": 1e-2, "conv_x": 0.15, "conv_bc": 0.15,
                          "k": 0.15, "v": 0.15}}
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


def _configs(dtype, variant="reduced", **change):
    change = dict(VARIANTS[variant], dtype=dtype, **change)
    return (dataclasses.replace(JC.get_reduced(ARCH), **change),
            dataclasses.replace(TC.get_reduced(ARCH), **change))


def _models(dtype, variant="reduced", seed=0, **change):
    jcfg, tcfg = _configs(dtype, variant, **change)
    jparams = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    tparams = params_from_jax(jax.device_get(jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _leaves(tree, prefix=()):
    """(path, leaf) of a tree of nested dicts, in sorted key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


# -- config -----------------------------------------------------------------

def test_zamba2_configs_equal_reference():
    for get in ("get_config", "get_reduced"):
        assert dataclasses.asdict(getattr(JC, get)(ARCH)) == \
            dataclasses.asdict(getattr(TC, get)(ARCH))
    full = TC.get_config(ARCH)
    assert full.d_inner // full.n_ssd_heads == 112
    assert full.n_layers == 6 * 13 + 13
    for get in (TC.get_config, TC.get_reduced):
        TT.check_supported(get(ARCH))


# -- the SSD scan at head dims above 64 ---------------------------------------

def _scan_inputs(shape, seed=0, dtype="float32"):
    B, S, H, P, N, _ = shape
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, S, H, P)) * 0.5).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((B, S, H)), 0).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 8.0, H)).astype(np.float32)
    b = (rng.standard_normal((B, S, N)) * 0.3).astype(np.float32)
    c = (rng.standard_normal((B, S, N)) * 0.3).astype(np.float32)
    if dtype == "bfloat16":
        x, b, c = (a.astype(ml_dtypes.bfloat16) for a in (x, b, c))
    return x, dt, a_log, b, c


@pytest.mark.parametrize("P", [112, 68, 100])
def test_split_plain_equals_unsplit(P):
    """Panels of 64 (the last zero-padded), each with its head's dt and
    a_log, then merged back: the plain version's output unchanged."""
    shape = (2, 150, 3, P, 16, 128)
    x, dt, a_log, b, c = (to_torch(a) for a in _scan_inputs(shape, seed=P))
    xs, dts, a_logs = SSD.split_panels(x, dt, a_log)
    k = -(-P // SSD.PANEL_P)
    assert tuple(xs.shape) == (2, 150, 3 * k, SSD.PANEL_P)
    assert tuple(dts.shape) == (2, 150, 3 * k) and a_logs.shape == (3 * k,)
    # panel j of head h is head h k + j, with that head's dt and a_log
    assert torch.equal(xs[:, :, 1 * k], x[:, :, 1, :SSD.PANEL_P])
    assert torch.equal(dts[:, :, 2 * k + 1], dt[:, :, 2])
    assert not xs.reshape(2, 150, 3, -1)[..., P:].any()
    whole = SSD.ssd_scan_plain(x, dt, a_log, b, c, chunk=128)
    split = SSD.merge_panels(SSD.ssd_scan_plain(xs, dts, a_logs, b, c,
                                                chunk=128), P)
    assert tuple(split.shape) == tuple(whole.shape)
    np.testing.assert_allclose(split.numpy(), whole.numpy(), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_scan_at_p112_matches_pallas_and_ref(dtype):
    """The wrapper (the plain version, unsplit, on the CPU) and the split
    plain version at P 112 against ``ssd_scan_pallas`` in interpret mode
    and ``ref.py``."""
    shape = (1, 200, 2, 112, 16, 128)
    x, dt, a_log, b, c = _scan_inputs(shape, seed=1, dtype=dtype)
    jargs = [jnp.asarray(a) for a in (x, dt, a_log, b, c)]
    wants = (ssd_scan_ref(*jargs),
             ssd_scan_pallas(*jargs, chunk=128, interpret=True))
    targs = [to_torch(a) for a in (x, dt, a_log, b, c)]
    before = SSD.launches
    xs, dts, a_logs = SSD.split_panels(*targs[:3])
    got = {"wrapper": SSD.ssd_scan(*targs, chunk=128),
           "split": SSD.merge_panels(SSD.ssd_scan_plain(
               xs, dts, a_logs, *targs[3:], chunk=128), 112)}
    assert SSD.launches == before
    tol = dict(rtol=2e-4, atol=2e-4) if dtype == "float32" \
        else dict(rtol=2.0 ** -7, atol=1e-5)
    for name, y in got.items():
        assert tuple(y.shape) == x.shape and y.dtype == targs[0].dtype
        for want in wants:
            np.testing.assert_allclose(_np(y), _np(want), err_msg=name,
                                       **tol)


def test_kernel_args_take_p112_and_refuse_other_head_dims():
    x, dt, a_log, b, c = (to_torch(a) for a in _scan_inputs(
        (1, 40, 2, 112, 64, 128)))
    SSD.check_kernel_args(x, dt, a_log, b, c, 128)
    SSD.check_kernel_args(x.bfloat16(), dt, a_log, b.bfloat16(),
                          c.bfloat16(), 128)
    # bf16 at chunk 128 runs its panels of 64 on the tensor-core kernel
    assert SSD.variant(torch.bfloat16, torch.bfloat16, 112, 64, 128) == \
        "wgmma"
    assert SSD.variant(torch.float32, torch.float32, 112, 64, 128) == \
        "cuda_cores"
    assert SSD.variant(torch.bfloat16, torch.bfloat16, 100, 64, 128) == \
        "wgmma"
    for P in (110, 114, SSD.MAX_P + 4):
        with pytest.raises(ValueError, match="head dim"):
            SSD.check_kernel_args(torch.zeros(1, 40, 2, P), dt, a_log, b,
                                  c, 128)


def test_split_head_dims_read_a_padded_copy_of_x():
    """At P 112 the tensor-core kernel reads the padded panels, a new
    tensor, so x itself need not be 16-byte aligned; b and c, which it
    reads as they are, still must be."""
    def shifted(shape):
        n = int(np.prod(shape))
        return torch.zeros(n + 1, dtype=torch.bfloat16)[1:].view(shape)

    dt, a_log = torch.zeros(1, 40, 2), torch.zeros(2)
    b = torch.zeros(1, 40, 64, dtype=torch.bfloat16)
    SSD.check_kernel_args(shifted((1, 40, 2, 112)), dt, a_log, b, b, 128)
    with pytest.raises(ValueError, match="aligned"):
        SSD.check_kernel_args(shifted((1, 40, 2, 64)), dt, a_log, b, b, 128)
    with pytest.raises(ValueError, match="aligned"):
        SSD.check_kernel_args(torch.zeros(1, 40, 2, 112,
                                          dtype=torch.bfloat16),
                              dt, a_log, shifted((1, 40, 64)), b, 128)
    xs, _, _ = SSD.split_panels(shifted((1, 40, 2, 112)), dt, a_log)
    assert xs.is_contiguous() and xs.data_ptr() % 16 == 0


# -- the model --------------------------------------------------------------

_jax_forward = jax.jit(JT.forward, static_argnums=(1,),
                       static_argnames=("remat", "return_hidden"))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_matches_reference(dtype, variant):
    jcfg, tcfg, jparams, tparams = _models(dtype, variant)
    toks = np.random.default_rng(9).integers(
        0, jcfg.vocab_size, size=(2, 150)).astype(np.int32)
    for hidden, remat in ((False, False), (True, True)):
        jout = _jax_forward(jparams, jcfg, jnp.asarray(toks), remat=remat,
                            return_hidden=hidden)
        tout = TT.forward(tparams, tcfg, torch.from_numpy(toks),
                          remat=remat, return_hidden=hidden)
        width = jcfg.d_model if hidden else jcfg.vocab_size
        assert tuple(tout.shape) == (2, 150, width)
        assert str(tout.dtype).split(".")[-1] == dtype
        np.testing.assert_allclose(_np(tout), _np(jout), rtol=0,
                                   atol=FORWARD_TOL[dtype])


def test_init_cache_matches_reference():
    for dtype in DTYPES:
        jcfg, tcfg = _configs(dtype)
        jc = jax.device_get(JT.init_cache(jcfg, 3, 24))
        tc = TT.init_cache(tcfg, 3, 24, device="cpu")
        assert set(tc) == set(jc) == {"blocks", "len", "shared"}
        for path, a in _leaves(jc):
            t = tc
            for p in path:
                t = t[p]
            assert tuple(t.shape) == a.shape, path
            assert str(t.dtype).split(".")[-1] == str(a.dtype), path
            assert not t.any()
        assert tuple(tc["shared"]["k"].shape) == (
            tcfg.block_repeat, 3, 24, tcfg.n_kv_heads, tcfg.head_dim)


def _assert_cache_close(tcache, jcache, dtype):
    jcache = jax.device_get(jcache)
    np.testing.assert_array_equal(tcache["len"].numpy(), jcache["len"])
    n = 0
    for path, want in _leaves(jcache):
        if path == ("len",):
            continue
        got = tcache
        for p in path:
            got = got[p]
        assert tuple(got.shape) == want.shape, path
        np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                                   atol=CACHE_TOL[dtype][path[-1]],
                                   err_msg=str(path))
        n += 1
    return n


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_step_logits_and_caches_match_reference(dtype, variant):
    """Six steps from an empty cache: the logits and every cache leaf, the
    shared block's K/V of each application included."""
    jcfg, tcfg, jparams, tparams = _models(dtype, variant)
    B = 2
    jstep = jax.jit(lambda p, t, c: JT.decode_step(p, jcfg, t, c))
    jcache = JT.init_cache(jcfg, B, 16)
    tcache = TT.init_cache(tcfg, B, 16, device="cpu")
    rng = np.random.default_rng(7)
    for _ in range(6):
        toks = rng.integers(0, jcfg.vocab_size, size=(B, 1)).astype(np.int32)
        jl, jcache = jstep(jparams, jnp.asarray(toks), jcache)
        tl, tcache = TT.decode_step(tparams, tcfg, torch.from_numpy(toks),
                                    tcache)
        assert tuple(tl.shape) == (B, jcfg.vocab_size)
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=0,
                                   atol=LOGIT_TOL[dtype])
    # 2 slots x 3 SSM leaves + the shared k and v
    assert _assert_cache_close(tcache, jcache, dtype) == \
        3 * len(tcfg.block_pattern) + 2
    assert tcache["shared"]["k"][:, :, 6:].abs().sum() == 0
    assert tcache["shared"]["k"][:, :, :6].abs().sum() > 0


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_matches_reference(dtype, variant):
    jcfg, tcfg, jparams, tparams = _models(dtype, variant)
    rng = np.random.default_rng(8)
    toks = rng.integers(0, jcfg.vocab_size, size=(2, 7)).astype(np.int32)
    lens = np.array([7, 4], np.int32)
    jl, jc = JT.prefill(jparams, jcfg, jnp.asarray(toks), 16,
                        lengths=jnp.asarray(lens))
    tl, tc = TT.prefill(tparams, tcfg, torch.from_numpy(toks), 16,
                        lengths=torch.from_numpy(lens))
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=0,
                               atol=LOGIT_TOL[dtype])
    _assert_cache_close(tc, jc, dtype)
    ported = cache_from_jax(jax.device_get(jc))
    assert set(ported) == {"blocks", "len", "shared"}
    assert torch.equal(ported["shared"]["v"].float(),
                       torch.from_numpy(_np(jc["shared"]["v"])))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_equals_token_replay_decode(variant):
    """The chunked SSD scan and the flash kernel's plain version over the
    sequence against the one-step recurrence and decode attention, token
    by token: the same logits at every position (fp32, 130 tokens: two
    chunks, the second ragged)."""
    _, tcfg, _, tparams = _models("float32", variant)
    toks = torch.from_numpy(np.random.default_rng(10).integers(
        0, tcfg.vocab_size, size=(2, 130)).astype(np.int32))
    with torch.no_grad():
        full = TT.forward(tparams, tcfg, toks)
    cache = TT.init_cache(tcfg, 2, 130, device="cpu")
    for t in range(130):
        logits, cache = TT.decode_step(tparams, tcfg, toks[:, t:t + 1],
                                       cache)
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(),
                                   rtol=0, atol=1e-4)


def test_shared_block_is_required_by_the_config():
    """A config with ``shared_attn`` refuses params without the shared
    block and the other way round; a shared block beside attention
    layers stays refused."""
    _, tcfg, _, tparams = _models("float32")
    toks = torch.zeros(1, 4, dtype=torch.int32)
    plain = dataclasses.replace(tcfg, shared_attn=False)
    with pytest.raises(ValueError, match="shared"):
        TT.forward(tparams, plain, toks)
    bare = TT.init_params(torch.Generator().manual_seed(0), plain,
                          device="cpu")
    with pytest.raises(ValueError, match="shared"):
        TT.decode_step(bare, tcfg, toks[:, :1],
                       TT.init_cache(tcfg, 1, 8, device="cpu"))
    with pytest.raises(NotImplementedError, match="shared attention"):
        TT.check_supported(dataclasses.replace(
            TC.get_reduced("qwen2-0.5b"), shared_attn=True))


# -- parameters and checkpoints -----------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_params_round_trip(dtype):
    jcfg, tcfg, jparams, tparams = _models(dtype)
    assert isinstance(tparams.shared, TT.SharedBlock)
    assert "bq" not in tparams.shared.attn
    back = params_to_numpy(tparams, tcfg)
    flat, _ = jax.tree_util.tree_flatten_with_path(jax.device_get(jparams))
    assert len(jax.tree.leaves(back)) == len(flat)
    assert sorted(back["shared"]) == ["attn", "mlp", "norm1", "norm2"]
    for path, want in flat:
        got = back
        for p in path:
            got = got[p.key]
        want = np.asarray(want)
        if want.dtype == ml_dtypes.bfloat16:
            got = got.view(ml_dtypes.bfloat16)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.uint8),
                                      want.view(np.uint8))


def test_shared_names_do_not_clash():
    """``shared`` names zamba2's top-level block and a MoE FFN's shared
    experts; each name maps to its own path, and a tree holding both
    crosses into the JAX layout and back."""
    assert jax_path("shared.mlp.w_up") == (("shared", "mlp", "w_up"), None)
    assert jax_path("blocks.1.l0.ffn.shared.w_up") == (
        ("blocks", "l0", "ffn", "shared", "w_up"), 1)
    named = {"shared.mlp.w_up": torch.full((2, 3), 1.0),
             "blocks.0.l0.ffn.shared.w_up": torch.full((2, 3), 2.0),
             "blocks.1.l0.ffn.shared.w_up": torch.full((2, 3), 3.0)}
    tree = to_jax_layout(named)
    assert float(tree["shared"]["mlp"]["w_up"][0, 0]) == 1.0
    assert tree["blocks"]["l0"]["ffn"]["shared"]["w_up"][:, 0, 0].tolist() \
        == [2.0, 3.0]
    from repro_torch.convert import from_jax_layout
    back = from_jax_layout(tree, named)
    for name, t in named.items():
        assert torch.equal(back[name], t)


@pytest.mark.parametrize("dtype", DTYPES)
def test_checkpoints_cross_between_packages(tmp_path, dtype):
    """A port checkpoint of a zamba2 train state, the shared block among
    its leaves, restores through the reference's manager as the same
    arrays, and the other way round."""
    jcfg, tcfg, jp, tp = _models(dtype, seed=3)
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


# -- the tied block's gradient and the train step -------------------------------

def _batch(vocab, seed=0, B=4, S=16):
    toks = np.random.default_rng(seed).integers(
        0, vocab, (B, S + 1)).astype(np.int32)
    return toks[:, :-1].copy(), toks[:, 1:].copy()


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_tied_block_gradient_matches_jax_grad(variant, remat):
    """The shared block's gradient, summed by autograd over its
    ``block_repeat`` applications, against ``jax.grad`` of the same
    chunked loss (fp32)."""
    jcfg, tcfg, jp, tp = _models("float32", variant)
    toks, labels = _batch(jcfg.vocab_size)

    def jloss(p):
        hidden = JT.forward(p, jcfg, jnp.asarray(toks), remat=remat,
                            return_hidden=True)
        return JS.chunked_ce_loss(hidden, p["head"], jnp.asarray(labels))

    want = jax.device_get(jax.jit(jax.grad(jloss))(jp)["shared"])
    hidden = TT.forward(tp, tcfg, torch.from_numpy(toks), remat=remat,
                        return_hidden=True)
    loss = TS.chunked_ce_loss(hidden, tp.head, torch.from_numpy(labels))
    named = dict(tp.shared.named_parameters())
    got = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    assert len(got) == len(jax.tree.leaves(want)) == 9
    for name, g in got.items():
        w = want
        for p in name.split("."):
            w = w[p]
        scale = max(1e-3, float(np.abs(w).max()))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)


def test_tied_block_gradient_is_the_sum_over_applications(monkeypatch):
    """Untied into one copy per application, the copies' gradients sum to
    the tied block's (fp32, no remat)."""
    _, tcfg, _, tp = _models("float32")
    toks, labels = (torch.from_numpy(a) for a in _batch(tcfg.vocab_size))

    def shared_grads(params):
        hidden = TT.forward(params, tcfg, toks, return_hidden=True)
        loss = TS.chunked_ce_loss(hidden, params.head, labels)
        return torch.autograd.grad(loss, list(params.parameters()),
                                   allow_unused=True)

    names = [n for n, _ in tp.named_parameters()]
    tied = dict(zip(names, shared_grads(tp)))
    copies = [TT.SharedBlock(*(torch.nn.Parameter(p.detach().clone())
                               if isinstance(p, torch.Tensor) else
                               torch.nn.ParameterDict({
                                   k: torch.nn.Parameter(v.detach().clone())
                                   for k, v in p.items()})
                               for p in (tp.shared.norm1, tp.shared.attn,
                                         tp.shared.norm2, tp.shared.mlp)))
              for _ in range(tcfg.block_repeat)]
    turn = itertools.count()
    apply = TT._shared_apply
    monkeypatch.setattr(TT, "_shared_apply", lambda cfg, shared, x, pos:
                        apply(cfg, copies[next(turn)], x, pos))
    hidden = TT.forward(tp, tcfg, toks, return_hidden=True)
    loss = TS.chunked_ce_loss(hidden, tp.head, labels)
    per = [dict(c.named_parameters()) for c in copies]
    leaves = list(per[0])
    grads = torch.autograd.grad(loss, [c[n] for c in per for n in leaves])
    assert next(turn) == tcfg.block_repeat
    for j, n in enumerate(leaves):
        summed = sum(grads[r * len(leaves) + j]
                     for r in range(tcfg.block_repeat))
        np.testing.assert_allclose(summed.numpy(),
                                   tied[f"shared.{n}"].numpy(), rtol=0,
                                   atol=1e-6, err_msg=n)


@pytest.mark.parametrize("dtype,microbatches,remat", [
    ("float32", 1, False),
    ("float32", 2, True),
    ("bfloat16", 2, True),
    ("bfloat16", 1, False),
])
def test_train_step_matches_reference(dtype, microbatches, remat):
    """Three steps at depth 2 (two applications of the tied block) of the
    P-112 variant against the JAX train step: loss, grad norm, updated
    parameters and masters, the shared block's among them."""
    tol = TRAIN_TOL[dtype]
    jcfg, tcfg, jp, tp = _models(dtype, "p112", block_repeat=2)
    jo, to = JO.adamw_init(jp), TO.adamw_init(tp)
    jstep = jax.jit(JS.make_train_step(jcfg, microbatches=microbatches,
                                       remat=remat))
    tstep = TS.make_train_step(tcfg, microbatches=microbatches, remat=remat)
    for s in range(3):
        toks, labels = _batch(jcfg.vocab_size, seed=s)
        jp, jo, jm = jstep(jp, jo, {"tokens": jnp.asarray(toks),
                                    "labels": jnp.asarray(labels)})
        tp, to, tm = tstep(tp, to, {"tokens": torch.from_numpy(toks),
                                    "labels": torch.from_numpy(labels)})
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= tol["loss"]
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]),
                                   rtol=tol["gnorm"])
        tparams = params_to_numpy(tp, tcfg)
        tmaster = map_tree(to_numpy, to_jax_layout(to.master))
        jmaster = jax.device_get(jo.master)
        leaves = jax.tree_util.tree_flatten_with_path(jax.device_get(jp))[0]
        assert any(p[0].key == "shared" for p, _ in leaves)
        for path, want in leaves:
            got, gm, wm = tparams, tmaster, jmaster
            for p in path:
                got, gm, wm = got[p.key], gm[p.key], wm[p.key]
            if np.asarray(want).dtype == ml_dtypes.bfloat16:
                got = got.view(ml_dtypes.bfloat16)
            np.testing.assert_allclose(_np(got), _np(want), **tol["params"])
            np.testing.assert_allclose(gm, np.asarray(wm), rtol=0,
                                       atol=tol["master"])


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("R", [1, 2])
def test_launches_equal_the_smokes_count(R, monkeypatch):
    """chip_smoke.py asserts ``train_launches_per_step`` and
    ``decode_launches_per_step`` on the card; here they must equal the
    calls into the wrappers: with remat every Mamba2 layer runs three
    times (the block's recomputation runs through the shared block after
    it) and the shared block twice a block; a decode step runs two
    RMSNorms a layer and a shared application, one decode attention an
    application."""
    smoke = _smoke()
    cfg = dataclasses.replace(TC.get_reduced(ARCH), block_repeat=R)
    params = TT.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    calls = dict.fromkeys(("rms", "flash", "ssd"), 0)
    for name, mod, attr in (("rms", RN, "rms_norm"),
                            ("flash", FA, "flash_attention"),
                            ("ssd", SSD, "ssd_scan")):
        def wrapped(*a, _fn=getattr(mod, attr), _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, attr, wrapped)
    TS.make_train_step(cfg, microbatches=2, remat=True)(
        params, TO.adamw_init(params),
        TokenPipeline(cfg.vocab_size, 24, 4).global_batch_at(0))
    want = smoke.train_launches_per_step(cfg, 2)
    assert (calls["rms"], calls["flash"], calls["ssd"]) == (
        want[0], want[2], want[3])
    n = len(cfg.block_pattern)
    assert want == ((2 * 3 * n * R + 2 * 2 * R + 1) * 2, 0, 2 * R * 2,
                    3 * n * R * 2)
    assert smoke.decode_launches_per_step(cfg) == (
        2 * (n + 1) * R + 1, R, 0, 0)
    full = TC.get_config(ARCH)
    assert smoke.decode_launches_per_step(full) == (183, 13, 0, 0)
    assert smoke.train_launches_per_step(
        dataclasses.replace(full, block_repeat=2), 2) == (162, 0, 8, 72)


# -- serving ------------------------------------------------------------------

MAX_LEN = 64
_jprefill = jax.jit(JT.prefill, static_argnums=(1, 3))
_jdecode = jax.jit(JT.decode_step, static_argnums=(1,))


def _served_alone(jcfg, jparams, req) -> list:
    """The tokens of ``req`` served alone by the JAX package: ``prefill``
    on a fresh batch-1 cache, then greedy ``decode_step``."""
    prompt = jnp.asarray(np.asarray(req["prompt"], np.int32))[None]
    logits, cache = _jprefill(jparams, jcfg, prompt, MAX_LEN)
    toks = [int(jnp.argmax(logits[0]))]
    while len(toks) < max(req["gen_len"], 2):
        logits, cache = _jdecode(jparams, jcfg,
                                 jnp.asarray([[toks[-1]]], jnp.int32), cache)
        toks.append(int(jnp.argmax(logits[0])))
    return toks


def test_engine_serves_each_request_as_alone(monkeypatch):
    """Staggered arrivals, a reused slot and a preemption over the hybrid
    cache (SSM state and the shared block's K/V through one slot): every
    request's tokens equal those of the request served alone by the JAX
    package (fp32); the admitted slot's SSM state is zero before its
    prefill and the other active slots' is put back after it."""
    jcfg, tcfg, jparams, tparams = _models("float32")
    rng = np.random.default_rng(0)
    reqs = [dict(rid=i, arrival=float(a),
                 prompt=rng.integers(1, tcfg.vocab_size, n).astype(np.int32),
                 gen_len=g)
            for i, (a, n, g) in enumerate(zip(
                [0, 0, 3, 9, 30, 31], [5, 8, 5, 8, 5, 8],
                [6, 4, 7, 5, 6, 3]))]
    eng = ServingEngine(tcfg, tparams, max_batch=2, max_len=MAX_LEN,
                        kv_token_budget=22, device="cpu")
    assert len(eng._state()) == 3 * len(tcfg.block_pattern)
    clock = [0.0]
    decode, prefill = eng._decode, eng._prefill_slot

    def timed_decode(toks):
        clock[0] += 1.0
        return decode(toks)

    log = []

    def checked(i):
        state = eng._state()
        assert all(not t[:, i].any() for t in state), i
        others = [j for j, s in enumerate(eng.slots) if s.active and j != i]
        before = [t[:, others].clone() for t in state]
        prefill(i)
        for t, rows in zip(state, before):
            assert torch.equal(t[:, others], rows), (i, others)
        log.append((i, others))

    monkeypatch.setattr(eng, "_decode", timed_decode)
    monkeypatch.setattr(eng, "_prefill_slot", checked)
    monkeypatch.setattr(engine_mod, "time",
                        types.SimpleNamespace(perf_counter=lambda: clock[0]))
    rep = eng.run(reqs, time_scale=1.0)
    assert rep.preemptions >= 1
    slots = [i for i, _ in log]
    assert len(slots) > len(set(slots))
    assert any(others for _, others in log)
    got = {r.rid: r.tokens for r in rep.results}
    assert sorted(got) == [r["rid"] for r in reqs]
    for r in reqs:
        assert got[r["rid"]] == _served_alone(jcfg, jparams, r), r["rid"]


def test_serve_and_train_entry_points_run_zamba2():
    """``launch.serve`` and ``launch.train`` on the CPU at reduced size, at
    both repeats and cut to one."""
    for depth in (None, 1):
        lines = []
        report, reqs = serve(arch=ARCH, size="reduced", requests=3,
                             max_batch=2, max_len=32, prompt_cap=8,
                             gen_cap=4, seed=0, device="cpu",
                             log=lines.append, depth=depth)
        assert {r.rid: len(r.tokens) for r in report.results} == {
            r["rid"]: max(r["gen_len"], 2) for r in reqs}
        assert "zamba2-reduced" in lines[0]
        _, _, losses = train(ARCH, steps=2, batch=2, seq=8, device="cpu",
                             log=lambda *a: None, depth=depth)
        assert np.isfinite(losses).all()
