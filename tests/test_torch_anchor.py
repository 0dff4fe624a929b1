"""The fp32 anchor of chip_smoke.py's bf16 checks, on the CPU.

chip_smoke.py reads each bf16 run of a logits check (the plain versions,
and the kernels) by its distance from a third run of the same inputs
through the plain versions in fp32, on the bf16 run's own weights and
cache upcast exactly (the anchor), and holds the kernel run's distance to
at most ANCHOR_RATIO times the plain run's.  Here, at REDUCED size, with
the kernel wrappers counting their calls and running their plain
versions (as they do for CPU tensors):

  * the anchor's weights and cache are the bf16 leaves ``.float()`` bit
    for bit, its cache a copy taken before the bf16 runs write theirs,
    and the anchor launches nothing;
  * the plain path against itself reads a ratio of exactly 1.0, and the
    decode kernels that swap output pairs or drop the last tile of a row
    (``broken_decode``; start lengths 37, 200 and 500, past one tile of
    32 slots) read above ANCHOR_RATIO;
  * the anchor's logits are the JAX package's fp32 ``decode_step`` on
    the same upcast weights and cache, carried over by
    ``params_from_jax`` / ``cache_from_jax``, within 1e-4 (the fp32
    tolerance of tests/test_torch_model.py).
"""

import contextlib
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
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.convert import cache_from_jax, params_from_jax  # noqa
from repro_torch.kernels import decode_attention as DA  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import rmsnorm as RN  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

FP32_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def smoke(monkeypatch):
    """chip_smoke.py on the CPU, each kernel wrapper counting its calls
    into its module's ``launches`` as a launch would."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "DEVICE", "cpu")
    for kmod, attr in ((RN, "rms_norm"), (DA, "decode_attention"),
                       (FA, "flash_attention"), (SSD, "ssd_scan")):
        def counted(*a, _fn=getattr(kmod, attr), _mod=kmod, **kw):
            _mod.launches += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(kmod, attr, counted)
    mod.reset_counts()
    return mod


def _seeded(smoke, arch, lens=(0, 37, 200, 500), max_len=512):
    """A bf16 REDUCED model and a cache of seeded K/V (and SSM state)
    at ``lens``, as ``model_check`` makes them."""
    cfg = dataclasses.replace(TC.get_reduced(arch), dtype="bfloat16")
    gen = torch.Generator().manual_seed(0)
    params = TT.init_params(gen, cfg, device="cpu")
    cache = TT.init_cache(cfg, len(lens), max_len, device="cpu")
    for t in smoke.cache_leaves(cache):
        t.normal_(generator=gen)
    cache["len"] = torch.tensor(lens, dtype=torch.int32)
    return cfg, params, cache


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "zamba2-7b"])
def test_anchor_weights_and_cache_are_the_bf16_leaves_upcast(smoke, arch):
    cfg, params, cache = _seeded(smoke, arch)
    before = {n: p.detach().clone() for n, p in params.named_parameters()}
    anchor_cache = smoke.upcast_cache(torch, cache)
    want = smoke.clone_cache(cache)
    toks = torch.ones(4, 1, dtype=torch.int32)
    # the bf16 run writes its cache (zamba2's fp32 SSM state too) in place
    smoke.reset_counts()
    TT.decode_step(params, cfg, toks, cache)
    assert smoke.counts()[0] > 0
    for got, leaf in zip(smoke.cache_leaves(anchor_cache),
                         smoke.cache_leaves(want), strict=True):
        assert got.dtype == torch.float32
        assert torch.equal(got, leaf.float())
    assert torch.equal(anchor_cache["len"], want["len"])

    seen = {}

    def run(cfg32):
        seen.update((n, p.detach().clone())
                    for n, p in params.named_parameters())
        return TT.decode_step(params, cfg32, toks, anchor_cache)[0]

    logits = smoke.fp32_anchor(torch, params, cfg, run)
    assert smoke.counts() == (0, 0, 0, 0)
    assert logits.dtype == torch.float32
    assert set(seen) == set(before)
    for n, p in before.items():
        assert seen[n].dtype == torch.float32
        assert torch.equal(seen[n], p.float()), n


def test_anchor_fails_when_it_launches(smoke):
    cfg, params, _ = _seeded(smoke, "qwen2-0.5b")

    def run(cfg32):
        RN.launches += 1                 # as a kernel left unpatched would

    with pytest.raises(RuntimeError, match="launched"):
        smoke.fp32_anchor(torch, params, cfg, run)


@pytest.mark.parametrize("kind", [None, "swap_pairs", "drop_tile"])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "gemma3-12b"])
def test_ratio_is_one_for_plain_and_above_the_limit_for_controls(
        smoke, arch, kind):
    patch = (smoke.broken_decode(torch, kind) if kind
             else contextlib.nullcontext())
    with patch:
        r = smoke.model_check(torch, "bfloat16", reduced=True, arch=arch,
                              anchor=True)
    a = r["anchor"]
    assert a["rows"] == r["rows"] == 4 * 6
    assert 0 < a["d_plain"] < 0.1
    if kind is None:
        assert r["worst"] == 0.0
        assert a["ratio"] == 1.0
    else:
        assert a["ratio"] > smoke.ANCHOR_RATIO, a


def test_anchor_matches_the_reference_fp32_decode_step(smoke):
    """The reference's bf16 weights and a seeded bf16 cache in the
    reference's layout, carried into the port bit for bit; the port's
    anchor (upcast, plain versions in fp32) against the reference's
    ``decode_step`` in fp32 on the same leaves cast to fp32."""
    arch, B, max_len, steps = "qwen2-0.5b", 4, 64, 4
    jcfg = dataclasses.replace(JC.get_reduced(arch), dtype="bfloat16")
    tcfg = dataclasses.replace(TC.get_reduced(arch), dtype="bfloat16")
    jparams = jax.device_get(JT.init_params(jax.random.PRNGKey(3), jcfg))
    rng = np.random.default_rng(3)

    def seeded(a):
        return rng.standard_normal(a.shape).astype(a.dtype)

    jcache = jax.device_get(JT.init_cache(jcfg, B, max_len))
    jcache = dict(jcache, blocks=jax.tree_util.tree_map(seeded,
                                                        jcache["blocks"]),
                  len=np.array([0, 5, 33, 60], np.int32))
    tparams = params_from_jax(jparams, tcfg, device="cpu")
    tcache = cache_from_jax(jcache)
    toks = rng.integers(0, jcfg.vocab_size, size=(steps, B, 1)).astype(
        np.int32)

    def up(a):
        a = np.asarray(a)
        return a.astype(np.float32) if a.dtype == ml_dtypes.bfloat16 else a

    jcfg32 = dataclasses.replace(jcfg, dtype="float32")
    jstep = jax.jit(lambda p, t, c: JT.decode_step(p, jcfg32, t, c))
    jp, jc = jax.tree_util.tree_map(up, jparams), \
        jax.tree_util.tree_map(up, jcache)
    want = []
    for s in range(steps):
        logits, jc = jstep(jp, jnp.asarray(toks[s]), jc)
        want.append(np.asarray(logits))

    anchor_cache = smoke.upcast_cache(torch, tcache)

    def run(cfg32):
        out, c = [], anchor_cache
        for s in range(steps):
            logits, c = TT.decode_step(tparams, cfg32,
                                       torch.from_numpy(toks[s]), c)
            out.append(logits)
        return out

    got = smoke.fp32_anchor(torch, tparams, tcfg, run)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == torch.float32 and w.dtype == np.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=FP32_TOL)
