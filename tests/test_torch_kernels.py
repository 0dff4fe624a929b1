"""Plain versions of the port's kernels against the TPU kernels (Pallas in
interpret mode) and their ref.py oracles, on the CPU, over the sweeps of
tests/test_kernels.py plus one qwen2-0.5b-shaped decode case.

The CUDA kernels themselves run only on the card (chip_smoke.py compares
each with its plain version there).  Here the wrappers must take the
plain version for CPU tensors without counting a launch, and their
argument checks must refuse what the kernels do not take.

Tolerances: fp32 2e-5 and bf16 2e-2, as in tests/test_kernels.py.
"""

import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.decode_attention.decode_attention import \
    decode_attention_pallas  # noqa: E402
from repro.kernels.decode_attention.ref import \
    decode_attention_ref  # noqa: E402
from repro.kernels.rmsnorm.rmsnorm import rms_norm_pallas  # noqa: E402
from repro.layers.norms import rms_norm as rms_norm_ref  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import decode_attention as DA  # noqa: E402
from repro_torch.kernels import rmsnorm as RN  # noqa: E402

DTYPES = ["float32", "bfloat16"]


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _draw(rng, shape, dtype):
    a = rng.standard_normal(shape).astype(np.float32)
    return a.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else a


def _close(port, ref, dtype):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref).astype(np.float32),
                               **_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(8, 128), (3, 7, 256), (130, 64),
                                   (4, 1, 896)])
def test_rmsnorm_plain_matches_pallas_and_ref(shape, dtype):
    rng = np.random.default_rng(3)
    x = _draw(rng, shape, dtype)
    w = rng.standard_normal(shape[-1:]).astype(np.float32)
    port = RN.rms_norm_plain(to_torch(x), to_torch(w))
    assert port.dtype == to_torch(x).dtype and port.shape == x.shape
    _close(port, rms_norm_pallas(jnp.asarray(x), jnp.asarray(w),
                                 block_rows=32, interpret=True), dtype)
    _close(port, rms_norm_ref(jnp.asarray(x), jnp.asarray(w)), dtype)


def _lengths(B, smax):
    return np.asarray([(smax * (i + 1)) // (B + 1) + 1 for i in range(B)],
                      np.int32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [
    (2, 8, 2, 64, 128),
    (3, 8, 8, 32, 300),                # MHA, non-multiple length
    (1, 16, 2, 64, 1024),
    (2, 14, 2, 64, 300),               # qwen2-0.5b: group 7, D 64
    (2, 2, 2, 256, 70),                # head dim 256 (gemma3): MHA
    (3, 16, 8, 256, 100),              # gemma3-12b heads: group 2
    (1, 16, 2, 256, 130),              # group 8
])
def test_decode_attention_plain_matches_pallas_and_ref(shape, dtype):
    B, Hq, Hkv, D, smax = shape
    rng = np.random.default_rng(1)
    q = _draw(rng, (B, Hq, D), dtype)
    k = _draw(rng, (B, smax, Hkv, D), dtype)
    v = _draw(rng, (B, smax, Hkv, D), dtype)
    lens = _lengths(B, smax)
    port = DA.decode_attention_plain(to_torch(q), to_torch(k), to_torch(v),
                                     to_torch(lens))
    assert port.dtype == to_torch(q).dtype and tuple(port.shape) == q.shape
    jargs = [jnp.asarray(a) for a in (q, k, v, lens)]
    _close(port, decode_attention_pallas(*jargs, block_kv=64,
                                         interpret=True), dtype)
    _close(port, decode_attention_ref(*jargs), dtype)


def test_decode_attention_full_and_single_slot_lengths():
    """Lengths of 1 and Smax, the ends of what decoding produces."""
    rng = np.random.default_rng(5)
    q, k, v = (_draw(rng, s, "float32")
               for s in [(2, 4, 64), (2, 70, 2, 64), (2, 70, 2, 64)])
    lens = np.array([1, 70], np.int32)
    port = DA.decode_attention_plain(to_torch(q), to_torch(k), to_torch(v),
                                     to_torch(lens))
    _close(port, decode_attention_pallas(
        *[jnp.asarray(a) for a in (q, k, v, lens)], block_kv=64,
        interpret=True), "float32")
    # one valid slot: the output is that slot's V row
    np.testing.assert_allclose(port[0].numpy(),
                               np.repeat(v[0, 0], 2, axis=0), rtol=1e-6)


def test_cpu_tensors_take_plain_version_without_counting():
    rng = np.random.default_rng(6)
    x = to_torch(_draw(rng, (4, 1, 96), "bfloat16"))
    w = to_torch(_draw(rng, (96,), "bfloat16"))
    q, k, v = (to_torch(_draw(rng, s, "float32"))
               for s in [(2, 14, 8), (2, 9, 2, 8), (2, 9, 2, 8)])
    lens = torch.tensor([3, 9], dtype=torch.int32)
    n_rms, n_attn = RN.launches, DA.launches
    assert torch.equal(RN.rms_norm(x, w), RN.rms_norm_plain(x, w))
    assert torch.equal(DA.decode_attention(q, k, v, lens),
                       DA.decode_attention_plain(q, k, v, lens))
    assert (RN.launches, DA.launches) == (n_rms, n_attn)


def test_rmsnorm_kernel_checks_refuse_bad_args():
    x = torch.zeros(4, 1, 896, dtype=torch.bfloat16)
    w = torch.ones(896, dtype=torch.bfloat16)
    RN.check_kernel_args(x, w)
    RN.check_kernel_args(x, w.float())          # fp32 weight is taken
    bad = [
        (x.half(), w),                           # dtype
        (x, w[:448]),                            # weight shape
        (x.transpose(0, 2), w),                  # not contiguous
        (torch.zeros(2, 9000), torch.ones(9000)),  # d > MAX_D
    ]
    for bx, bw in bad:
        with pytest.raises(ValueError):
            RN.check_kernel_args(bx, bw)


def test_decode_attention_kernel_checks_refuse_bad_args():
    def args(B=4, Hq=14, Hkv=2, D=64, smax=512, dtype=torch.bfloat16,
             ldtype=torch.int32):
        return (torch.zeros(B, Hq, D, dtype=dtype),
                torch.zeros(B, smax, Hkv, D, dtype=dtype),
                torch.zeros(B, smax, Hkv, D, dtype=dtype),
                torch.ones(B, dtype=ldtype))

    DA.check_kernel_args(*args())                       # qwen2-0.5b
    DA.check_kernel_args(*args(Hq=16, Hkv=8, D=128))    # internlm2-1.8b
    DA.check_kernel_args(*args(Hq=16, Hkv=8, D=256))    # gemma3-12b
    DA.check_kernel_args(*args(Hq=8, Hkv=8, dtype=torch.float32))
    DA.check_kernel_args(*args(B=1, Hq=16, Hkv=16, D=512))  # MLA's latent
    for bad in (args(D=16), args(Hq=18, Hkv=2), args(Hq=14, Hkv=4),
                args(Hq=16, Hkv=8, D=512),              # D 512: group 1
                args(dtype=torch.float16), args(ldtype=torch.int64)):
        with pytest.raises(ValueError):
            DA.check_kernel_args(*bad)
    q, k, v, lens = args()
    with pytest.raises(ValueError):                     # k/v mismatch
        DA.check_kernel_args(q, k, v[:, :, :, :32].contiguous(), lens)
    with pytest.raises(ValueError):                     # not contiguous
        DA.check_kernel_args(q.transpose(0, 1), k, v, lens)


def _split_decode(q, k, v, lengths, span, keep_empty=False):
    """The CUDA kernel's split-KV algorithm in plain torch: each span of
    ``span`` slots gives a partial (m, l, acc) in fp32 over its valid
    slots, and the spans merge by the LSE rule exp(m_s - M).  The kernel
    runs only the live spans (those starting before lengths[b], at least
    one); ``keep_empty`` merges every span of the grid, the empty ones
    with m = NEG_INF and l = 0."""
    B, Hq, D = q.shape
    Smax, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    splits = -(-Smax // span)
    qf = q.float().view(B, Hkv, group, D)
    out = torch.zeros(B, Hkv, group, D)
    for b in range(B):
        n = min(max(int(lengths[b]), 0), Smax)
        live = -(-n // span) if n > span else 1
        parts = []
        for s in range(splits if keep_empty else live):
            lo, hi = s * span, min((s + 1) * span, n)
            m = torch.full((Hkv, group), DA.NEG_INF)
            l = torch.zeros(Hkv, group)
            acc = torch.zeros(Hkv, group, D)
            if hi > lo:
                kk = k[b, lo:hi].float().transpose(0, 1)     # (Hkv, n, D)
                vv = v[b, lo:hi].float().transpose(0, 1)
                sc = torch.einsum("hgd,hnd->hgn", qf[b], kk) / math.sqrt(D)
                m = sc.amax(-1)
                p = torch.exp(sc - m[..., None])
                l = p.sum(-1)
                acc = torch.einsum("hgn,hnd->hgd", p, vv)
            parts.append((m, l, acc))
        big_m = torch.stack([m for m, _, _ in parts]).amax(0)
        w = [torch.exp(m - big_m) for m, _, _ in parts]
        lsum = sum(wi * l for wi, (_, l, _) in zip(w, parts))
        a = sum(wi[..., None] * acc for wi, (_, _, acc) in zip(w, parts))
        out[b] = a / lsum.clamp_min(1e-30)[..., None]
    return out.view(B, Hq, D).to(q.dtype)


@pytest.mark.parametrize("smax", [1, 31, 64, 70, 512, 32768])
@pytest.mark.parametrize("rows", [1, 8, 56, 1024])
@pytest.mark.parametrize("sms", [1, 78, 132])
def test_decode_split_plan_covers_every_slot_once(smax, rows, sms):
    span, splits = DA.split_plan(smax, rows, sms)
    assert span % DA.SPAN_QUANTUM == 0 and 1 <= splits <= DA.MAX_SPLITS
    # the spans tile [0, smax): every slot in exactly one, none empty
    cover = np.zeros(smax, np.int64)
    for s in range(splits):
        assert s * span < smax
        cover[s * span:min((s + 1) * span, smax)] += 1
    assert (cover == 1).all()
    # the shortest span whose split count stays within the cap: the
    # blocks that fill the card (BLOCKS_PER_SM per SM), MAX_SPLITS, and
    # one span per SPAN_QUANTUM slots
    cap = min(-(-DA.BLOCKS_PER_SM * sms // rows), DA.MAX_SPLITS,
              -(-smax // DA.SPAN_QUANTUM))
    assert splits <= cap
    shorter = span - DA.SPAN_QUANTUM
    assert shorter == 0 or -(-smax // shorter) > cap
    # the grid (splits, Hkv, B) stays inside CUDA's limits
    assert splits < 2 ** 31


def test_decode_split_plan_fills_the_card_at_the_serve_shape():
    """qwen2-0.5b at batch 4 (B * Hkv = 8) with 512-slot caches on 132
    SMs: more blocks than the 8 of one block per (b, kv head)."""
    span, splits = DA.split_plan(512, 8, 132)
    assert (span, splits) == (128, 4) and 8 * splits > 8
    assert DA.split_plan(32768, 8, 132) == (512, 64)
    with pytest.raises(ValueError):
        DA.split_plan(0, 8, 132)


def test_decode_grid_reports_the_launch_geometry(monkeypatch):
    class Props:
        multi_processor_count = 132
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device=None: Props())
    DA._sm_count.cache_clear()
    monkeypatch.setattr(DA, "_sm_count", DA._sm_count.__wrapped__)
    q = torch.zeros(4, 14, 64)
    k = torch.zeros(4, 512, 2, 64)
    assert DA.grid(q, k) == (4, 2, 4)
    assert DA.grid(q, torch.zeros(4, 70, 2, 64)) == (1, 2, 4)


@pytest.mark.parametrize("span", [16, 32, 128])
def test_decode_split_combine_matches_plain_pallas_and_ref(span):
    """The split + LSE combine at small spans, some of them empty (lengths
    short of Smax, 1, and 0), against decode_attention_plain, the Pallas
    kernel (interpret mode) and ref.py, fp32 at 2e-5."""
    rng = np.random.default_rng(11)
    B, Hq, Hkv, D, smax = 5, 14, 2, 64, 100
    q = _draw(rng, (B, Hq, D), "float32")
    k = _draw(rng, (B, smax, Hkv, D), "float32")
    v = _draw(rng, (B, smax, Hkv, D), "float32")
    lens = np.array([1, 16, 33, 97, 100], np.int32)
    tq, tk, tv, tl = (to_torch(a) for a in (q, k, v, lens))
    port = _split_decode(tq, tk, tv, tl, span)
    tol = dict(rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        port.numpy(), DA.decode_attention_plain(tq, tk, tv, tl).numpy(),
        **tol)
    jargs = [jnp.asarray(a) for a in (q, k, v, lens)]
    np.testing.assert_allclose(port.numpy(), np.asarray(
        decode_attention_pallas(*jargs, block_kv=64, interpret=True)), **tol)
    np.testing.assert_allclose(port.numpy(),
                               np.asarray(decode_attention_ref(*jargs)),
                               **tol)
    # empty spans (m = NEG_INF, l = 0) merge in as 0 and no NaN
    every = _split_decode(tq, tk, tv, tl, span, keep_empty=True)
    assert torch.isfinite(every).all()
    np.testing.assert_allclose(every.numpy(), port.numpy(), **tol)
    # a row with no valid slot gives 0, as the TPU kernel does
    tl0 = torch.tensor([0, 16, 33, 97, 100], dtype=torch.int32)
    zero = _split_decode(tq, tk, tv, tl0, span, keep_empty=True)
    assert torch.equal(zero[0], torch.zeros(Hq, D))


def test_decode_ticket_buffer_is_kept_per_device_and_stream():
    DA._tickets.clear()
    try:
        a = DA._ticket_buffer(torch.device("cpu"), 7, 8)
        assert a.dtype == torch.int32 and a.numel() >= 8
        assert not a.any()
        assert DA._ticket_buffer(torch.device("cpu"), 7, 8) is a
        assert DA._ticket_buffer(torch.device("cpu"), 9, 8) is not a
        big = DA._ticket_buffer(torch.device("cpu"), 7, 1000)
        assert big.numel() >= 1000 and not big.any()
    finally:
        DA._tickets.clear()


def test_build_needs_nvcc_only_when_building(tmp_path, monkeypatch):
    """Importing the kernels needs no nvcc; building without one raises."""
    monkeypatch.setattr(build, "find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.compile_library(tmp_path / "out")


def test_build_refuses_an_installed_copy(tmp_path):
    """Outside a checkout (an installed package: no src/ tree, no
    pyproject.toml, no .cu sources) the build raises instead of writing
    into a directory shared across installs."""
    build.require_checkout()                       # this checkout
    site = tmp_path / "lib" / "python3" / "site-packages"
    csrc = site / "repro_torch" / "kernels" / "csrc"
    csrc.mkdir(parents=True)
    with pytest.raises(RuntimeError, match="checkout"):
        build.require_checkout(csrc, site.parent)
    (csrc / "a.cu").write_text("int a;")
    with pytest.raises(RuntimeError, match="checkout"):
        build.require_checkout(csrc, site.parent)
    src = tmp_path / "repo" / "src" / "repro_torch" / "kernels" / "csrc"
    src.mkdir(parents=True)
    (src / "a.cu").write_text("int a;")
    with pytest.raises(RuntimeError, match="checkout"):  # no pyproject
        build.require_checkout(src, tmp_path / "repo")
    (tmp_path / "repo" / "pyproject.toml").write_text("")
    build.require_checkout(src, tmp_path / "repo")


def test_source_hash_tracks_sources(tmp_path):
    (tmp_path / "a.cu").write_text("int a;")
    (tmp_path / "h.cuh").write_text("#pragma once")
    h1 = build.source_hash(tmp_path)
    assert h1 == build.source_hash(tmp_path)
    (tmp_path / "h.cuh").write_text("#pragma once\n")
    assert build.source_hash(tmp_path) != h1
    assert build.source_hash(tmp_path, ("-O2",)) != build.source_hash(
        tmp_path)
    # the link flags count too (a library added at link time rebuilds)
    assert build.source_hash(tmp_path, link_flags=(
        *build.LINK_FLAGS, "-lcuda")) != build.source_hash(tmp_path)
    assert {p.name for p in build.sources()} == {
        "decode_attention.cu", "decode_attention_d256_bf16.cu",
        "decode_attention_d256_f32.cu", "decode_attention_d512.cu",
        "decode_attention_fp8.cu", "errors.cu", "flash_attention.cu",
        "rmsnorm.cu", "ssd_scan.cu"}
