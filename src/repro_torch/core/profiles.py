"""Offline op profiler on one card: the port of ``MeasuredBackend`` in
``repro/core/profiles.py`` (paper §3.5).

The simulator prices every serving iteration from tables of ``(x, time)``
samples, one table per ``(op, axes)`` key, sampled over ``_GRID``.
``MeasuredBackend.measure(op, axes, x)`` runs one sample of one op on the
device and reads two clocks on it:

  * **wall**: the best of ``repeats`` host-clock readings
    (``time.perf_counter``) around one call followed by
    ``torch.cuda.synchronize()``, the reference's clock (it waits with
    ``block_until_ready``).  It counts the launch and the synchronisation,
    as the engine pays them;
  * **device**: the best of ``repeats`` CUDA-event readings around one
    call: the op's time on the card alone.  A sleep kernel queued before
    the first event keeps the card busy while the host enqueues the call,
    so the wrapper's host-side work does not show as idle time between
    the events.

On the CPU, which a caller gets only by asking for it, the device is the
host: both clocks read ``perf_counter`` and the kernels' wrappers run
their plain versions.

Each op runs what the engine or the trainer runs, in the dtype its axes
name (``"bf16"`` and ``"fp16"`` run in bfloat16, the engine's dtype, which
costs what fp16 does on Hopper's tensor cores; ``"fp32"`` in float32;
any other dtype raises, since the port has no int8 or fp8 kernels):

  ==============  ===========================  ================================
  op              axes; x                      timed call
  ==============  ===========================  ================================
  ``gemm``        n, k, dtype; m = x           ``torch.matmul`` (m, k) @ (k, n)
  ``attn_decode`` kv_heads, head_dim, dtype;   ``kernels.decode_attention``,
                  x KV tokens                  B 1, Smax = length = x,
                                               Hq = Hkv = kv_heads
  ``attn_prefill`` heads, head_dim, dtype;     ``kernels.flash_attention``,
                  x query-key products         causal, B 1, Hq = Hkv = heads,
                                               S = ``prefill_len(x)``
  ``ssd_scan``    d_inner, d_state, dtype;     ``kernels.ssd_scan``, B 1,
                  x tokens                     S = x, d_inner // 64 heads of
                                               P 64, N = d_state, chunk 128
  ==============  ===========================  ================================

Departures from the reference, which times jitted einsums on a CPU:

  * it returns ``(wall_s, device_s)``, not ``(time_s, energy_j)``; energy
    belongs to the simulator's ``PowerModel``, which the port does not
    copy;
  * a GEMM runs in its axes' dtype (the reference: fp32 whatever the
    dtype);
  * ``attn_decode`` keeps the reference's interface, which loses the GQA
    group and the batch: the IR sums KV tokens over the batch and keys the
    table by kv heads, so a sample is one sequence of x slots read by
    one query head per kv head.  The engine's step reads the same K/V
    bytes for ``group`` query heads each;
  * ``attn_prefill`` is causal at the S whose causal area ``S(S+1)/2`` is
    nearest x (the IR counts causal area, ``repro/core/ir.py``), not
    non-causal at S = sqrt(x);
  * ``ssd_scan`` runs the port's kernel with the model's dt and A, not the
    reference's scan with dt 1 and A -1;
  * the L2 cache is flushed (a read of ``FLUSH_BYTES``) before each timed
    call: in the engine an op's weights and cache are evicted by the
    other layers' before it runs again;
  * inputs come from one seeded ``torch.Generator`` on the device.

``calls`` counts the calls of each op's function, warm-up included: on a
card each is one launch of the op's kernel (or one matrix product).

The simulator prices MLA's decode at the latent width, ``(n_heads,
kv_lora_rank)`` = (16, 512) for deepseek-v2-lite-16b: that sample runs
the decode kernel's head-dim-512 instance, which takes group 1, all a
sample's ``Hq = Hkv`` needs.

``_op_work`` is a copy of the reference's work model: the FLOPs and bytes
the simulator's analytic backend and roofline bound charge a sample.
"""

from __future__ import annotations

import math
import time
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ssd_scan as _ssd

# The profiler's grid of x points (a copy of the reference's): powers of
# two from 1 to 2^40.
_GRID = [2 ** i for i in range(0, 41)]

DTYPES = {"bf16": torch.bfloat16, "fp16": torch.bfloat16,
          "fp32": torch.float32}
OPS = ("gemm", "attn_decode", "attn_prefill", "ssd_scan")
SSD_HEAD_DIM = 64
SSD_CHUNK = 128
# more than twice the H100's 50 MB L2
FLUSH_BYTES = 128 << 20
# the sleep before a device reading lasts twice the call's wall time, at
# this many cycles a second (above the H100's 1.98 GHz boost clock)
SLEEP_HZ = 2.0e9


def _op_work(op: str, axes: tuple, x: float) -> Tuple[float, float, str]:
    """(flops, bytes, dtype) the simulator charges one sample: a copy of
    ``_op_work`` in ``repro/core/profiles.py``."""
    if op == "gemm":
        n, k, dtype = axes
        m = x
        bytes_per = 2.0 if dtype in ("fp16", "bf16") else 1.0
        flops = 2.0 * m * n * k
        nbytes = (m * k + m * n + n * k) * bytes_per
        return flops, nbytes, dtype
    if op == "attn_prefill":
        heads, head_dim, dtype = axes
        qk = x
        flops = 4.0 * qk * heads * head_dim
        nbytes = 4.0 * math.sqrt(max(qk, 1.0)) * heads * head_dim * 2.0
        return flops, nbytes, dtype
    if op == "attn_decode":
        kv_heads, head_dim, dtype = axes
        kv_tokens = x
        bytes_per = 2.0 if dtype in ("fp16", "bf16") else 1.0
        flops = 4.0 * kv_tokens * kv_heads * head_dim
        nbytes = 2.0 * kv_tokens * kv_heads * head_dim * bytes_per
        return flops, nbytes, dtype
    if op == "ssd_scan":
        d_inner, d_state, dtype = axes
        t = x
        flops = 6.0 * t * d_inner * d_state
        nbytes = 2.0 * t * d_inner * 2.0
        return flops, nbytes, dtype
    raise KeyError(f"unknown profile op {op!r}; known: {OPS}")


def sample_dtype(name: str) -> torch.dtype:
    """The dtype a sample whose axes name ``name`` runs in."""
    try:
        return DTYPES[name]
    except KeyError:
        raise ValueError(f"no kernels for dtype {name!r}; the profiler "
                         f"runs {sorted(DTYPES)}") from None


def prefill_len(area: float) -> int:
    """The sequence length S >= 1 whose causal area S(S+1)/2 is nearest
    ``area`` (the lower S on a tie)."""
    s = max(1, int((math.sqrt(8.0 * max(area, 0.0) + 1.0) - 1.0) / 2.0))
    return min((s, s + 1), key=lambda n: abs(n * (n + 1) / 2.0 - area))


class MeasuredBackend:
    """Times one sample of an op on ``device`` (CUDA unless the caller
    passes ``device="cpu"``; without a card ``None`` raises)."""

    def __init__(self, device=None, repeats: int = 3):
        if repeats < 1:
            raise ValueError(f"repeats must be >= 1, got {repeats}")
        self.device = resolve_device(device)
        self.repeats = repeats
        self.gen = torch.Generator(device=self.device).manual_seed(0)
        self.calls: Dict[str, int] = {op: 0 for op in OPS}
        self._flush_buf = None

    # -- inputs ---------------------------------------------------------------

    def _randn(self, *shape, dtype=torch.float32, scale: float = 1.0
               ) -> torch.Tensor:
        t = torch.randn(*shape, generator=self.gen, device=self.device)
        return (t * scale).to(dtype)

    def inputs(self, op: str, axes: tuple, x: float) -> Dict[str, object]:
        """The tensors (and static arguments) one sample of ``op`` at
        ``x`` runs on."""
        if op not in OPS:
            raise KeyError(f"unknown profile op {op!r}; known: {OPS}")
        dt = sample_dtype(axes[-1])
        n_x = max(1, int(x))
        if op == "gemm":
            n, k, _ = axes
            return dict(a=self._randn(n_x, k, dtype=dt),
                        b=self._randn(k, n, dtype=dt))
        if op == "attn_decode":
            kv_heads, head_dim, _ = axes
            return dict(
                q=self._randn(1, kv_heads, head_dim, dtype=dt),
                k=self._randn(1, n_x, kv_heads, head_dim, dtype=dt),
                v=self._randn(1, n_x, kv_heads, head_dim, dtype=dt),
                lengths=torch.full((1,), n_x, dtype=torch.int32,
                                   device=self.device))
        if op == "attn_prefill":
            heads, head_dim, _ = axes
            s = prefill_len(x)
            return {name: self._randn(1, s, heads, head_dim, dtype=dt)
                    for name in ("q", "k", "v")}
        d_inner, d_state, _ = axes
        h = max(1, d_inner // SSD_HEAD_DIM)
        # dt and A as the model makes them (layers.ssm, init_mamba2)
        return dict(
            x=self._randn(1, n_x, h, SSD_HEAD_DIM, dtype=dt, scale=0.5),
            dt=F.softplus(self._randn(1, n_x, h)),
            a_log=torch.log(torch.linspace(1.0, 16.0, h,
                                           device=self.device)),
            b=self._randn(1, n_x, d_state, dtype=dt, scale=0.3),
            c=self._randn(1, n_x, d_state, dtype=dt, scale=0.3),
            chunk=SSD_CHUNK)

    def run(self, op: str, a: Dict[str, object]):
        """One call of ``op`` on ``inputs(op, ...)``'s tensors."""
        self.calls[op] += 1
        if op == "gemm":
            return torch.matmul(a["a"], a["b"])
        if op == "attn_decode":
            return _decode.decode_attention(a["q"], a["k"], a["v"],
                                            a["lengths"])
        if op == "attn_prefill":
            return _flash.flash_attention(a["q"], a["k"], a["v"],
                                          causal=True)
        return _ssd.ssd_scan(a["x"], a["dt"], a["a_log"], a["b"], a["c"],
                             a["chunk"])

    # -- clocks ---------------------------------------------------------------

    def _cuda(self) -> bool:
        return self.device.type == "cuda"

    def _sync(self) -> None:
        if self._cuda():
            torch.cuda.synchronize(self.device)

    def _flush(self) -> None:
        """Evict the L2 cache by reading a buffer larger than it."""
        if not self._cuda():
            return
        if self._flush_buf is None:
            self._flush_buf = torch.ones(FLUSH_BYTES // 4,
                                         dtype=torch.float32,
                                         device=self.device)
        self._flush_buf.sum()

    def measure(self, op: str, axes: tuple, x: float) -> Tuple[float, float]:
        """``(wall_s, device_s)`` of one call of ``op`` at ``x``: each the
        best of ``repeats`` calls, after one warm-up call (which builds the
        kernels on their first use)."""
        a = self.inputs(op, axes, x)
        wall = device = math.inf
        with torch.no_grad():
            self.run(op, a)
            for _ in range(self.repeats):
                self._flush()
                self._sync()
                t0 = time.perf_counter()
                self.run(op, a)
                self._sync()
                wall = min(wall, time.perf_counter() - t0)
            for _ in range(self.repeats):
                self._flush()
                if self._cuda():
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    torch.cuda._sleep(int(2.0 * wall * SLEEP_HZ) + 100_000)
                    start.record()
                    self.run(op, a)
                    end.record()
                    end.synchronize()
                    device = min(device, start.elapsed_time(end) / 1e3)
                else:
                    t0 = time.perf_counter()
                    self.run(op, a)
                    device = min(device, time.perf_counter() - t0)
        return wall, device
