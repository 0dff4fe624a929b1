"""The Mamba2 slice of the port against the JAX reference on the CPU: the
SSD-scan kernel's plain version against the TPU kernel (Pallas in
interpret mode) and its ref.py oracle, the scan's gradients against
``jax.grad`` of the reference's chunked scan, the Mamba2 mixer, the
mamba2 REDUCED model (``forward``, ``decode_step``, ``prefill``), a whole
train step, the launch counts chip_smoke.py asserts, and checkpoints
across the two packages.  Serving is in tests/test_torch_ssm_serving.py.

The CUDA kernel itself runs only on the card (chip_smoke.py holds it
against ``ssd_scan_plain`` and the sequential recurrence there).  Here
the wrapper must take the plain version for CPU tensors without counting
a launch, and its argument checks must refuse what the kernel does not
take.

Tolerances (readings on the CPU over seeds 0-2 in brackets):
  * the scan, fp32: 2e-4, the sweep tolerance of
    tests/test_kernels.py::test_ssd_scan_sweep (chunked and sequential
    sums round differently; [1.2e-5 at S = 300]).  bf16 inputs: both
    sides compute in fp32 and round once, so one bf16 ulp (rtol 2^-7)
    plus atol 1e-5.
  * gradients of the scan, fp32: rtol 1e-4 and atol 1e-4 times the
    largest gradient of the tensor (at least 1) against ``jax.grad``:
    the same chunked algorithm, summed in another order; a_log's
    gradient sums every (b, s, p) of its head with cancellation [1.8e-4
    on -0.205 beside 9.11].
  * the mixer and the model, fp32: layer 2e-5 [4.9e-6], logits, hidden
    states and caches 1e-4 [6.6e-6].
  * bf16: layer 0.1 [0.035], ``forward`` 0.25 [0.121 at S = 300],
    decode-step logits 0.15 [0.068], conv windows 0.15 [0.055], SSM
    state 1e-2 [2.6e-3].  The reference's ``ssd_chunked`` rounds to
    bf16 inside the scan (the decay-weighted scores and dt x before the
    intra-chunk product, the carried state before the inter-chunk
    product, exp(cum)); the port's kernel and its plain version, like
    the Pallas kernel, stay in fp32 and round once.  bf16 matmuls and
    elementwise ops also round at other places in the two frameworks,
    and the differences grow through the layers.
  * a train step: as tests/test_torch_training.py (fp32 loss 1e-5,
    grad norm rtol 1e-5, params and masters 1e-6; bf16 loss 5e-3, grad
    norm rtol 5e-3, masters 5e-5, params one bf16 ulp + 1e-4).
"""

import dataclasses

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
from repro.layers import ssm as JSSM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.training import checkpoint as JCK  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.convert import (cache_from_jax, map_tree,  # noqa: E402
                                 params_from_jax, params_to_numpy,
                                 to_jax_layout, to_numpy, to_torch)
from repro_torch.data.pipeline import TokenPipeline  # noqa: E402
from repro_torch.kernels import rmsnorm as RN  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch.train import train, train_state  # noqa: E402
from repro_torch.layers import ssm as TSSM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.config import LayerSpec  # noqa: E402
from repro_torch.training import checkpoint as TCK  # noqa: E402
from repro_torch.training import optimizer as TO  # noqa: E402

ARCH = "mamba2-2.7b"
DTYPES = ["float32", "bfloat16"]
# (B, S, H, P, N, chunk): tests/test_kernels.py's sweep, then three
# chunks of 128 with the last one padded
SSD_SHAPES = [(2, 64, 4, 8, 16, 16), (1, 100, 2, 16, 32, 32),
              (2, 33, 8, 4, 8, 8), (1, 300, 4, 32, 16, 128)]
LAYER_TOL = {"float32": 2e-5, "bfloat16": 0.1}
FORWARD_TOL = {"float32": 1e-4, "bfloat16": 0.25}
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 0.15}
CACHE_TOL = {"float32": {"ssm": 1e-4, "conv_x": 1e-4, "conv_bc": 1e-4},
             "bfloat16": {"ssm": 1e-2, "conv_x": 0.15, "conv_bc": 0.15}}


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t).astype(np.float32)


def _configs(dtype):
    return (dataclasses.replace(JC.get_reduced(ARCH), dtype=dtype),
            dataclasses.replace(TC.get_reduced(ARCH), dtype=dtype))


def _models(dtype, seed=0):
    jcfg, tcfg = _configs(dtype)
    jparams = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    tparams = params_from_jax(jax.device_get(jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _scan_inputs(shape, seed=0, a_max=8.0, dtype="float32"):
    """numpy inputs of the scan as tests/test_kernels.py draws them."""
    B, S, H, P, N, _ = shape
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, S, H, P)) * 0.5).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((B, S, H)), 0).astype(np.float32)
    a_log = np.log(np.linspace(1.0, a_max, H)).astype(np.float32)
    b = (rng.standard_normal((B, S, N)) * 0.3).astype(np.float32)
    c = (rng.standard_normal((B, S, N)) * 0.3).astype(np.float32)
    if dtype == "bfloat16":
        x, b, c = (a.astype(ml_dtypes.bfloat16) for a in (x, b, c))
    return x, dt, a_log, b, c


# -- configs --------------------------------------------------------------------

def test_mamba2_configs_equal_reference():
    for get in ("get_config", "get_reduced"):
        assert dataclasses.asdict(getattr(JC, get)(ARCH)) == \
            dataclasses.asdict(getattr(TC, get)(ARCH))
    assert "mamba2-2.7b" in TC.ALIASES


# -- the scan -------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_scan_plain_matches_pallas_and_ref(shape, dtype):
    chunk = shape[-1]
    x, dt, a_log, b, c = _scan_inputs(shape, dtype=dtype)
    jargs = [jnp.asarray(a) for a in (x, dt, a_log, b, c)]
    want_ref = ssd_scan_ref(*jargs)
    want_pallas = ssd_scan_pallas(*jargs, chunk=chunk, interpret=True)
    targs = [to_torch(a) for a in (x, dt, a_log, b, c)]
    before = SSD.launches
    got = {"plain": SSD.ssd_scan_plain(*targs, chunk=chunk),
           "wrapper": SSD.ssd_scan(*targs, chunk=chunk),
           "sequential": SSD.ssd_scan_sequential(*targs)}
    assert SSD.launches == before              # the CPU path launches nothing
    tol = dict(rtol=2e-4, atol=2e-4) if dtype == "float32" \
        else dict(rtol=2.0 ** -7, atol=1e-5)
    for name, y in got.items():
        assert tuple(y.shape) == x.shape and y.dtype == targs[0].dtype
        for want in (want_ref, want_pallas):
            np.testing.assert_allclose(_np(y), _np(want), err_msg=name,
                                       **tol)


def test_ssd_scan_pads_without_touching_the_state():
    """S = 100 in chunks of 32: the last chunk's 28 zero rows must not
    change y; appending more rows must not change the first 100."""
    x, dt, a_log, b, c = (to_torch(a) for a in _scan_inputs(
        (1, 128, 2, 16, 32, 32), seed=3))
    full = SSD.ssd_scan_plain(x, dt, a_log, b, c, chunk=32)
    cut = SSD.ssd_scan_plain(x[:, :100], dt[:, :100], a_log, b[:, :100],
                             c[:, :100], chunk=32)
    np.testing.assert_allclose(cut.numpy(), full[:, :100].numpy(),
                               rtol=0, atol=1e-6)


def test_ssd_scan_large_decay_stays_finite_with_gradients():
    """A = -16 and dt ~ 2: cum reaches about -4000 inside one 128-chunk,
    where exp(-cum_j) overflows.  Output and gradients must stay finite
    and agree with the sequential recurrence."""
    shape = (1, 256, 4, 8, 16, 128)
    x, dt, a_log, b, c = _scan_inputs(shape, seed=4, a_max=16.0)
    dt = dt + 1.5
    targs = [torch.from_numpy(a).requires_grad_() for a in
             (x, dt, a_log, b, c)]
    y = SSD.ssd_scan(*targs, chunk=128)
    ref = SSD.ssd_scan_sequential(*(t.detach() for t in targs))
    np.testing.assert_allclose(y.detach().numpy(), ref.numpy(), rtol=2e-4,
                               atol=2e-4)
    y.square().sum().backward()
    for t in targs:
        assert bool(torch.isfinite(t.grad).all())


def _jax_scan_grads(x, dt, a_log, b, c, g, chunk):
    def loss(*args):
        y, _ = JSSM.ssd_chunked(*args, jnp.zeros(x.shape[2]), chunk=chunk)
        return jnp.sum(y * g)
    return jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (x, dt, a_log, b, c)))


@pytest.mark.parametrize("shape", SSD_SHAPES[:2] + SSD_SHAPES[3:])
def test_ssd_scan_grads_match_jax(shape):
    """Both the CPU autograd of the wrapper and ``ssd_scan_grads`` (the
    backward of the CUDA path) against jax.grad of ``ssd_chunked``."""
    chunk = shape[-1]
    x, dt, a_log, b, c = _scan_inputs(shape, seed=5)
    g = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)
    want = _jax_scan_grads(x, dt, a_log, b, c, jnp.asarray(g), chunk)
    targs = [torch.from_numpy(a).requires_grad_() for a in
             (x, dt, a_log, b, c)]
    (SSD.ssd_scan(*targs, chunk=chunk) * torch.from_numpy(g)).sum() \
        .backward()
    recomputed = SSD.ssd_scan_grads(*(t.detach() for t in targs),
                                    torch.from_numpy(g), chunk=chunk)
    for name, t, r, w in zip("x dt a_log b c".split(), targs, recomputed,
                             want):
        scale = max(1.0, float(np.abs(np.asarray(w)).max()))
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=name)
        np.testing.assert_array_equal(r.numpy(), t.grad.numpy())


def test_ssd_scan_kernel_args_are_checked():
    x, dt, a_log, b, c = (to_torch(a) for a in _scan_inputs(
        (1, 40, 2, 8, 16, 16)))
    SSD.check_kernel_args(x, dt, a_log, b, c, 16)
    SSD.check_kernel_args(x.bfloat16(), dt, a_log, b.bfloat16(),
                          c.bfloat16(), 128)
    bad = [
        (x.half(), dt, a_log, b, c, 16),                   # dtype
        (x, dt.bfloat16(), a_log, b, c, 16),               # dt not fp32
        (x, dt, a_log.double(), b, c, 16),                 # a_log not fp32
        (x, dt, a_log, b.bfloat16(), c, 16),               # b, c differ
        (x.transpose(2, 3).contiguous().transpose(2, 3), dt, a_log, b, c,
         16),                                              # not contiguous
        (x, dt[:, :-1], a_log, b, c, 16),                  # dt shape
        (x, dt, a_log[:1], b, c, 16),                      # a_log shape
        (x, dt, a_log, b[:, :-1], c, 16),                  # b shape
        (x[..., None], dt, a_log, b, c, 16),               # x not 4-D
        (torch.zeros(1, 40, 2, 260), dt, a_log, b, c, 16),  # P > MAX_P
        (torch.zeros(1, 40, 2, 6), dt, a_log, b, c, 16),   # P % 4
        (x, dt, a_log, torch.zeros(1, 40, 10), torch.zeros(1, 40, 10),
         16),                                              # N % 4
        (x, dt, a_log, torch.zeros(1, 40, 129), torch.zeros(1, 40, 129),
         16),                                              # N > 128
        (x, dt, a_log, b, c, 0),                           # chunk 0
    ]
    for args in bad:
        with pytest.raises(ValueError):
            SSD.check_kernel_args(*args)
    long = torch.zeros(1, 300, 2, 8)
    with pytest.raises(ValueError):                        # Q = 256
        SSD.check_kernel_args(long, torch.zeros(1, 300, 2), a_log,
                              torch.zeros(1, 300, 16),
                              torch.zeros(1, 300, 16), 256)
    # meta tensors (a shape trace) take the plain version, as the CPU does
    y = SSD.ssd_scan(x.to("meta"), dt.to("meta"), a_log.to("meta"),
                     b.to("meta"), c.to("meta"))
    assert y.device.type == "meta" and y.shape == x.shape


# -- the mixer ------------------------------------------------------------------

def _mixer(dtype, seed=0):
    jcfg, tcfg, jparams, tparams = _models(dtype, seed)
    jmix = jax.tree.map(lambda a: a[0], jparams["blocks"]["l0"]["mixer"])
    dims = dict(d_inner=jcfg.d_inner, d_state=jcfg.d_state,
                n_heads=jcfg.n_ssd_heads)
    return jcfg, jmix, tparams.blocks[0]["l0"].mixer, dims


@pytest.mark.parametrize("S", [37, 300])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba2_forward_matches_reference(dtype, S):
    jcfg, jmix, tmix, dims = _mixer(dtype)
    x = jnp.asarray(np.random.default_rng(1).standard_normal(
        (2, S, jcfg.d_model)).astype(np.float32)).astype(jcfg.dtype)
    want = JSSM.mamba2_forward(jmix, x, **dims)
    got = TSSM.mamba2_forward(tmix, to_torch(np.asarray(x)), **dims)
    assert tuple(got.shape) == (2, S, jcfg.d_model)
    assert str(got.dtype).split(".")[-1] == dtype
    np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                               atol=LAYER_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba2_decode_step_matches_reference(dtype):
    jcfg, jmix, tmix, dims = _mixer(dtype)
    rng = np.random.default_rng(2)
    P = jcfg.d_inner // jcfg.n_ssd_heads
    state = rng.standard_normal((2, jcfg.n_ssd_heads, P, jcfg.d_state)
                                ).astype(np.float32)
    jconv = {"x": rng.standard_normal((2, 3, jcfg.d_inner)),
             "bc": rng.standard_normal((2, 3, 2 * jcfg.d_state))}
    jconv = {k: jnp.asarray(v.astype(np.float32)).astype(jcfg.dtype)
             for k, v in jconv.items()}
    x = jnp.asarray(rng.standard_normal((2, 1, jcfg.d_model)).astype(
        np.float32)).astype(jcfg.dtype)
    wy, wstate, wconv = JSSM.mamba2_decode_step(jmix, x, jnp.asarray(state),
                                                jconv, **dims)
    tconv = {k: to_torch(np.asarray(v)) for k, v in jconv.items()}
    tstate = torch.from_numpy(state.copy())
    with torch.no_grad():
        gy, gstate, gconv = TSSM.mamba2_decode_step(
            tmix, to_torch(np.asarray(x)), tstate, tconv, **dims)
    np.testing.assert_array_equal(tstate.numpy(), state)   # not modified
    np.testing.assert_allclose(_np(gy), _np(wy), rtol=0,
                               atol=LAYER_TOL[dtype])
    assert gstate.dtype == torch.float32
    np.testing.assert_allclose(gstate.numpy(), _np(wstate), rtol=0,
                               atol=CACHE_TOL[dtype]["ssm"])
    for k in ("x", "bc"):          # the windows shift exactly
        np.testing.assert_array_equal(_np(gconv[k][:, :-1]),
                                      _np(wconv[k][:, :-1]))


def test_causal_conv_and_softplus_match_reference():
    """The conv sums its taps in the reference's order: fp32 to rounding,
    bf16 within one ulp (SiLU rounds once in torch, per op in XLA).
    softplus is ``jax.nn.softplus`` also above 20, where F.softplus
    would return its input."""
    rng = np.random.default_rng(3)
    for dtype, tol in ((jnp.float32, 1e-6), (jnp.bfloat16, 2.0 ** -7)):
        x = jnp.asarray(rng.standard_normal((2, 9, 6)), dtype)
        w = jnp.asarray(rng.standard_normal((4, 6)) * 0.1, dtype)
        bias = jnp.asarray(rng.standard_normal(6) * 0.1, dtype)
        got = TSSM._causal_conv(*(to_torch(np.asarray(a))
                                  for a in (x, w, bias)))
        want = JSSM._causal_conv(x, w, bias)
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    v = np.linspace(-40.0, 40.0, 101).astype(np.float32)
    np.testing.assert_allclose(
        TSSM.softplus(torch.from_numpy(v)).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(v))), rtol=1e-6, atol=0)


# -- the model ------------------------------------------------------------------

def test_mamba2_init_cache_matches_reference():
    for dtype in DTYPES:
        jcfg, tcfg = _configs(dtype)
        jc = JT.init_cache(jcfg, 3, 24)
        tc = TT.init_cache(tcfg, 3, 24, device="cpu")
        for name, a in jc["blocks"]["l0"].items():
            t = tc["blocks"]["l0"][name]
            assert tuple(t.shape) == a.shape
            assert str(t.dtype).split(".")[-1] == str(a.dtype)
            assert not t.any()
        assert set(tc["blocks"]["l0"]) == {"ssm", "conv_x", "conv_bc"}


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba2_params_round_trip_keeps_fp32_leaves(dtype):
    jcfg, tcfg, jparams, tparams = _models(dtype)
    for name in ("a_log", "dt_bias", "d_skip"):
        assert tparams.blocks[0]["l0"].mixer[name].dtype == torch.float32
    back = params_to_numpy(tparams, tcfg)
    flat, _ = jax.tree_util.tree_flatten_with_path(jax.device_get(jparams))
    assert len(jax.tree.leaves(back)) == len(flat)
    for path, want in flat:
        got = back
        for p in path:
            got = got[p.key]
        want = np.asarray(want)
        if want.dtype == ml_dtypes.bfloat16:
            assert got.dtype == np.uint16
            got = got.view(ml_dtypes.bfloat16)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.uint8),
                                      want.view(np.uint8))


_jax_forward = jax.jit(JT.forward, static_argnums=(1,),
                       static_argnames=("remat", "return_hidden"))


@pytest.mark.parametrize("S", [37, 300])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba2_model_forward_matches_reference(dtype, S):
    jcfg, tcfg, jparams, tparams = _models(dtype)
    toks = np.random.default_rng(9).integers(
        0, jcfg.vocab_size, size=(2, S)).astype(np.int32)
    for hidden, remat in ((False, False), (True, True)):
        jout = _jax_forward(jparams, jcfg, jnp.asarray(toks), remat=remat,
                            return_hidden=hidden)
        tout = TT.forward(tparams, tcfg, torch.from_numpy(toks),
                          remat=remat, return_hidden=hidden)
        width = jcfg.d_model if hidden else jcfg.vocab_size
        assert tuple(tout.shape) == (2, S, width)
        assert str(tout.dtype).split(".")[-1] == dtype
        np.testing.assert_allclose(_np(tout), _np(jout), rtol=0,
                                   atol=FORWARD_TOL[dtype])


def _assert_ssm_cache_close(tcache, jcache, dtype):
    for name, tol in CACHE_TOL[dtype].items():
        got = tcache["blocks"]["l0"][name]
        want = jcache["blocks"]["l0"][name]
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=tol,
                                   err_msg=name)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba2_decode_step_logits_and_cache_match_reference(dtype):
    jcfg, tcfg, jparams, tparams = _models(dtype)
    B, steps = 2, 6
    jstep = jax.jit(lambda p, t, c: JT.decode_step(p, jcfg, t, c))
    jcache = JT.init_cache(jcfg, B, 16)
    tcache = TT.init_cache(tcfg, B, 16, device="cpu")
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
    _assert_ssm_cache_close(tcache, jcache, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba2_prefill_matches_reference(dtype):
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
    assert ported["blocks"]["l0"]["ssm"].dtype == torch.float32
    _assert_ssm_cache_close(tc, jax.device_get(jc), dtype)


def test_mamba2_forward_equals_token_replay_decode():
    """The chunked SSD scan and the one-step recurrence give the same
    logits at every position (fp32, 150 tokens: two chunks)."""
    _, tcfg, _, tparams = _models("float32")
    toks = torch.from_numpy(np.random.default_rng(10).integers(
        0, tcfg.vocab_size, size=(2, 150)).astype(np.int32))
    with torch.no_grad():
        full = TT.forward(tparams, tcfg, toks)
    cache = TT.init_cache(tcfg, 2, 150, device="cpu")
    for t in range(150):
        logits, cache = TT.decode_step(tparams, tcfg, toks[:, t:t + 1],
                                       cache)
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(),
                                   rtol=0, atol=1e-4)


def test_mamba2_is_supported_and_its_neighbours_are_not():
    cfg = TC.get_reduced(ARCH)
    TT.check_supported(cfg)
    # zamba2's shared attention block over the SSM layers is ported
    TT.check_supported(dataclasses.replace(cfg, shared_attn=True))
    for change in (dict(n_ssm_groups=2),
                   dict(ffn_kind="moe"),
                   dict(block_pattern=(LayerSpec("ssm"),
                                       LayerSpec("attn")))):  # attn, no FFN
        with pytest.raises(NotImplementedError):
            TT.check_supported(dataclasses.replace(cfg, **change))




# -- training -------------------------------------------------------------------

TRAIN_TOL = {
    "float32": dict(loss=1e-5, gnorm=1e-5, master=1e-6,
                    params=dict(rtol=0, atol=1e-6)),
    "bfloat16": dict(loss=5e-3, gnorm=5e-3, master=5e-5,
                     params=dict(rtol=2.0 ** -7, atol=1e-4)),
}


@pytest.mark.parametrize("dtype,microbatches,remat", [
    ("float32", 1, False),
    ("float32", 2, True),
    ("bfloat16", 2, True),
])
def test_mamba2_train_step_matches_reference(dtype, microbatches, remat):
    tol = TRAIN_TOL[dtype]
    jcfg, tcfg, jp, tp = _models(dtype)
    jo, to = JO.adamw_init(jp), TO.adamw_init(tp)
    jstep = jax.jit(JS.make_train_step(jcfg, microbatches=microbatches,
                                       remat=remat))
    tstep = TS.make_train_step(tcfg, microbatches=microbatches, remat=remat)
    rng = np.random.default_rng(0)
    for _ in range(3):
        toks = rng.integers(0, jcfg.vocab_size, (4, 17)).astype(np.int32)
        jp, jo, jm = jstep(jp, jo, {"tokens": jnp.asarray(toks[:, :-1]),
                                    "labels": jnp.asarray(toks[:, 1:])})
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
        for path, want in jax.tree_util.tree_flatten_with_path(
                jax.device_get(jp))[0]:
            got, gm, wm = tparams, tmaster, jmaster
            for p in path:
                got, gm, wm = got[p.key], gm[p.key], wm[p.key]
            if np.asarray(want).dtype == ml_dtypes.bfloat16:
                got = got.view(ml_dtypes.bfloat16)
            np.testing.assert_allclose(_np(got), _np(want), **tol["params"])
            np.testing.assert_allclose(gm, np.asarray(wm), rtol=0,
                                       atol=tol["master"])


@pytest.mark.parametrize("remat", [False, True])
def test_ssd_and_rmsnorm_calls_per_train_step(remat, monkeypatch):
    """The launch counts chip_smoke.py asserts, derived on the CPU by
    counting calls into the two kernel wrappers: per microbatch, the
    forward runs R SSD scans and 2R + 1 RMSNorms (norm1 and the gated
    norm of every layer, and the final norm); with remat, the backward
    runs each block's forward again: R more scans and 2R more RMSNorms.
    For mamba2-2.7b (R = 64, 2 microbatches): 256 and 514 per step."""
    calls = {"ssd": 0, "rms": 0}
    ssd, rms = SSD.ssd_scan, RN.rms_norm

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(SSD, "ssd_scan", count("ssd", ssd))
    monkeypatch.setattr(RN, "rms_norm", count("rms", rms))
    cfg = TC.get_reduced(ARCH)
    R, mb = cfg.block_repeat, 2
    params = TT.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    step = TS.make_train_step(cfg, microbatches=mb, remat=remat)
    step(params, TO.adamw_init(params),
         TokenPipeline(cfg.vocab_size, 16, 4).global_batch_at(0))
    again = 1 if remat else 0
    assert calls["ssd"] == R * mb * (1 + again)
    assert calls["rms"] == (2 * R + 1) * mb + 2 * R * mb * again
    assert (R, mb) == (3, 2)
    full = TC.get_config(ARCH).block_repeat
    assert (2 * full * mb, (4 * full + 1) * mb) == (256, 514)


def test_adamw_groups_change_no_number(monkeypatch):
    """The update in groups of a few leaves equals the update in one
    group, bit for bit, over a model of bf16 and fp32 leaves."""
    _, _, _, tparams = _models("bfloat16")
    named = dict(tparams.named_parameters())
    assert {p.dtype for p in named.values()} == {torch.bfloat16,
                                                 torch.float32}
    rng = np.random.default_rng(11)
    grads = {n: torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(
        np.float32)).to(p.dtype) for n, p in named.items()}
    results = []
    for group_elems, n_groups in ((TO.GROUP_ELEMS, 1), (5000, 10)):
        monkeypatch.setattr(TO, "GROUP_ELEMS", group_elems)
        params = {n: p.detach().clone() for n, p in named.items()}
        state = TO.adamw_init(params)
        assert len(TO._groups(state.master)) >= n_groups
        for lr in (1e-3, 2e-3):
            params, state, metrics = TO.adamw_update(params, grads, state,
                                                     lr)
        results.append((params, state, float(metrics["grad_norm"])))
    (p1, s1, g1), (p2, s2, g2) = results
    assert g1 == g2
    for n in named:
        assert torch.equal(p1[n], p2[n]) and p1[n].dtype == named[n].dtype
        assert torch.equal(s1.master[n], s2.master[n])
        assert torch.equal(s1.v[n], s2.v[n])


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba2_checkpoints_cross_between_packages(tmp_path, dtype):
    """A port checkpoint of a mamba2 train state (bf16 weights beside
    fp32 ``a_log``/``dt_bias``/``d_skip``) restores through the
    reference's manager as the same arrays, and the other way round."""
    jcfg, tcfg, jp, tp = _models(dtype, seed=3)
    jo, to = JO.adamw_init(jp), TO.adamw_init(tp)
    TCK.CheckpointManager(str(tmp_path / "port")).save(
        7, train_state(tp, to))
    step, (rp, ro), _ = JCK.CheckpointManager(
        str(tmp_path / "port")).restore((jp, jo))
    assert step == 7
    for want, got in ((jp, rp), (jo.master, ro.master), (jo.m, ro.m)):
        for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(np.asarray(a).view(np.uint8),
                                          np.asarray(b).view(np.uint8))
    JCK.CheckpointManager(str(tmp_path / "jax")).save(9, (jp, jo))
    step, state, _ = TCK.CheckpointManager(str(tmp_path / "jax")).restore(
        train_state(tp, to))
    assert step == 9
    assert state[0]["blocks"]["l0"]["mixer"]["a_log"].dtype == torch.float32
    back = map_tree(to_numpy, state[0])
    for path, want in jax.tree_util.tree_flatten_with_path(
            jax.device_get(jp))[0]:
        got = back
        for p in path:
            got = got[p.key]
        np.testing.assert_array_equal(got.view(np.uint8),
                                      np.asarray(want).view(np.uint8))


def test_mamba2_train_resumes_bit_exact(tmp_path):
    kw = dict(steps=4, batch=2, seq=16, ckpt_every=2, device="cpu",
              log=lambda *a: None)
    p1, o1, l1 = train(ARCH, ckpt_dir=str(tmp_path / "a"), **kw)
    assert all(np.isfinite(l1))
    train(ARCH, ckpt_dir=str(tmp_path / "b"), **dict(kw, steps=2))
    p2, o2, l2 = train(ARCH, ckpt_dir=str(tmp_path / "b"), **kw)
    assert l2 == l1[2:]
    for (n1, a), (n2, b) in zip(p1.named_parameters(),
                                p2.named_parameters()):
        assert n1 == n2 and a.dtype == b.dtype and torch.equal(a, b)
    for name in o1.master:
        assert torch.equal(o1.master[name], o2.master[name])
