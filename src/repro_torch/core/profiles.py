"""Operation-level profiling results, and the offline op profiler on one
card (paper §3.5): the port's ``repro/core/profiles.py``.

The simulator prices every serving iteration from tables of ``(x, time,
energy)`` samples, one table per ``(op, axes)`` key, sampled over
``_GRID`` and interpolated linearly between them (``ProfileStore``).  A
``ProfileBackend`` produces the samples: ``AnalyticBackend``, the
roofline model of the target device, or ``TorchMeasuredBackend``, the
samples ``MeasuredBackend`` times on the card.  ``_interp``,
``ProfileBackend``, ``AnalyticBackend``, ``_op_work``, ``ProfileStore``
and ``CollectiveModel`` are copies of the reference's and give its
results bit for bit.

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

  * it returns ``(wall_s, device_s)``, not ``(time_s, energy_j)``;
    ``TorchMeasuredBackend`` reads one of the two clocks and charges
    energy through the simulator's ``PowerModel`` at utilization 0.7,
    as the reference's ``MeasuredBackend`` does;
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

``_op_work`` is the work model: the FLOPs and bytes the analytic backend
and the profiler's roofline bound charge a sample.

``TorchMeasuredBackend`` is the ``ProfileBackend`` over the profiler:
one clock of its two, ``"wall"`` or ``"device"``, with energy for
``h100_node(1)``'s device.  One ``measure`` call of the profiler gives
both clocks; the backends of a ``sibling`` pair share its samples, so one
profiling pass fills the wall and the device tables.
"""

from __future__ import annotations

import bisect
import copy
import dataclasses
import math
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device

from . import collectives as _coll
from .cluster import Cluster, h100_node
from .energy import PowerModel

# Grid of interpolation x-points the profiler samples. Log-spaced powers
# of two from 1 to 2^40 — covers token counts, qk products and byte sizes.
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


def _interp(points: List[Tuple[float, float, float]], x: float
            ) -> Tuple[float, float]:
    """Piecewise-linear interpolation over sorted (x, t, e) points."""
    if x <= points[0][0]:
        # Linear through origin below the grid (cost ~ 0 at x = 0).
        x0, t0, e0 = points[0]
        return t0 * x / x0, e0 * x / x0
    if x >= points[-1][0]:
        # Linear extrapolation using the last segment's slope.
        (x0, t0, e0), (x1, t1, e1) = points[-2], points[-1]
        dt = (t1 - t0) / (x1 - x0)
        de = (e1 - e0) / (x1 - x0)
        return t1 + dt * (x - x1), e1 + de * (x - x1)
    xs = [p[0] for p in points]
    i = bisect.bisect_right(xs, x)
    (x0, t0, e0), (x1, t1, e1) = points[i - 1], points[i]
    w = (x - x0) / (x1 - x0)
    return t0 + w * (t1 - t0), e0 + w * (e1 - e0)


class ProfileBackend:
    """Produces one (time_s, energy_j) sample — the 'profiler' interface."""

    def measure(self, op: str, axes: tuple, x: float) -> Tuple[float, float]:
        raise NotImplementedError


@dataclasses.dataclass
class AnalyticBackend(ProfileBackend):
    """Roofline-style analytic device model.

    Time = max(flops / (peak * eff_c(x)), bytes / (hbm_bw * eff_m)) + launch
    overhead.  The compute-efficiency curve ``eff_c`` saturates with
    arithmetic intensity/batch (small GEMMs underutilize the MXU/tensor
    cores) — this is what makes decode memory-bound and prefill
    compute-bound in the simulation, matching §2.1.

    ``freq_ghz`` scales compute and bandwidth linearly from the device's
    base frequency (paper Table 4's 0.8 GHz rows); energy uses the
    frequency-aware power model in core/energy.py.
    """

    cluster: Cluster
    freq_ghz: Optional[float] = None
    gemm_eff_max: float = 0.85
    mem_eff: float = 0.80
    launch_overhead_s: float = 4e-6

    def __post_init__(self):
        self.power = PowerModel(self.cluster.device,
                                freq_ghz=self.freq_ghz)

    def _rates(self, dtype: str) -> Tuple[float, float]:
        dev = self.cluster.device
        scale = 1.0
        if self.freq_ghz is not None:
            scale = self.freq_ghz / dev.base_freq_ghz
        return dev.flops(dtype) * scale, dev.hbm_bw * self.mem_eff * scale

    def measure(self, op: str, axes: tuple, x: float) -> Tuple[float, float]:
        flops, nbytes, dtype = _op_work(op, axes, x)
        peak, bw = self._rates(dtype)
        # MXU efficiency saturates with the x variable (token count / size).
        half = 256.0 if op == "gemm" else 4096.0
        eff = self.gemm_eff_max * (x / (x + half))
        t_compute = flops / (peak * max(eff, 1e-3))
        t_mem = nbytes / bw
        t = max(t_compute, t_mem) + self.launch_overhead_s
        util = min(1.0, (flops / peak) / t) if t > 0 else 0.0
        energy = self.power.energy(t, util)
        return t, energy


def _op_work(op: str, axes: tuple, x: float) -> Tuple[float, float, str]:
    """Recover (flops, bytes, dtype) for a profile sample point.

    Mirrors the OpCall construction in core/ir.py so that analytic samples
    land on the same work model the simulator reports MFU/MBU against.
    """
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
    if op in _coll.COLLECTIVE_FNS or op == "p2p":
        # handled by CollectiveModel, not the device backend
        raise ValueError(f"collective op {op} must go through CollectiveModel")
    raise KeyError(f"unknown profile op {op!r}")


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
        # the wrappers load at first use, so that the simulator (``core``,
        # ``disagg``) imports none of them
        from repro_torch.kernels import decode_attention as _decode
        from repro_torch.kernels import flash_attention as _flash
        from repro_torch.kernels import ssd_scan as _ssd
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


class ProfileStore:
    """Grid-sampled profiling tables with linear interpolation.

    Tables are built lazily: the first query for an (op, axes) key samples
    the backend over the x-grid (bounded to a window around the query) and
    caches the curve; subsequent queries interpolate.  ``grid_stride``
    subsamples the grid (a stride of 2 keeps every 2nd power of two) to
    emulate a sparser profiling run — used by tests to bound interpolation
    error.  ``x_max`` caps the grid (measured backends can't run 2^40-token
    GEMMs); queries beyond it extrapolate linearly.
    """

    def __init__(self, backend: ProfileBackend, grid_stride: int = 1,
                 x_max: Optional[float] = None):
        self.backend = backend
        self.grid_stride = max(1, grid_stride)
        self.x_max = x_max
        self._tables: Dict[tuple, List[Tuple[float, float, float]]] = {}
        self.lookups = 0
        self.misses = 0

    def _table(self, op: str, axes: tuple) -> List[Tuple[float, float, float]]:
        key = (op, axes)
        tbl = self._tables.get(key)
        if tbl is None:
            self.misses += 1
            grid = [g for g in _GRID[:: self.grid_stride]
                    if self.x_max is None or g <= self.x_max]
            tbl = []
            for gx in grid:
                t, e = self.backend.measure(op, axes, float(gx))
                tbl.append((float(gx), t, e))
            self._tables[key] = tbl
        return tbl

    def query(self, op: str, axes: tuple, x: float) -> Tuple[float, float]:
        """(time_s, energy_j) for one operation instance."""
        self.lookups += 1
        if x <= 0:
            return 0.0, 0.0
        return _interp(self._table(op, axes), x)

    def time(self, op: str, axes: tuple, x: float) -> float:
        return self.query(op, axes, x)[0]


class CollectiveModel:
    """Collective-communication lookup (paper profiles these separately).

    Thin adapter over core/collectives.py cost functions + the energy model;
    grouped here so search.py passes one object around.
    """

    def __init__(self, cluster: Cluster, freq_ghz: Optional[float] = None):
        self.cluster = cluster
        self.power = PowerModel(cluster.device, freq_ghz=freq_ghz)

    def query(self, kind: str, nbytes: float, group_size: int
              ) -> Tuple[float, float]:
        if kind == "p2p":
            t = _coll.p2p_time(nbytes, group_size, self.cluster)
        else:
            t = _coll.collective_time(kind, nbytes, group_size, self.cluster)
        # Communication keeps devices at low compute utilization.
        e = self.power.energy(t, utilization=0.15) * group_size
        return t, e

    def time(self, kind: str, nbytes: float, group_size: int) -> float:
        return self.query(kind, nbytes, group_size)[0]


CLOCKS = ("wall", "device")
UTILIZATION = 0.7


def _checked(clock: str) -> str:
    if clock not in CLOCKS:
        raise ValueError(f"clock must be one of {CLOCKS}, got {clock!r}")
    return clock


class TorchMeasuredBackend(ProfileBackend):
    """Profile samples timed on ``device`` (CUDA unless the caller passes
    ``device="cpu"``), read on ``clock``; energy for ``h100_node(1)``'s
    device."""

    def __init__(self, clock: str = "wall", device=None, repeats: int = 3):
        self.clock = _checked(clock)
        self.power = PowerModel(h100_node(1).device)
        self.timer = MeasuredBackend(device, repeats)
        # (op, axes, x) -> (wall_s, device_s)
        self.samples: Dict[tuple, Tuple[float, float]] = {}

    def sibling(self, clock: str) -> "TorchMeasuredBackend":
        """A backend on ``clock`` that shares this one's profiler and
        samples."""
        other = copy.copy(self)
        other.clock = _checked(clock)
        return other

    def sample(self, op: str, axes: tuple, x: float) -> Tuple[float, float]:
        """``(wall_s, device_s)`` of one sample, timed on first use."""
        key = (op, tuple(axes), float(x))
        if key not in self.samples:
            self.samples[key] = self.timer.measure(op, tuple(axes), x)
        return self.samples[key]

    def measure(self, op: str, axes: tuple, x: float) -> Tuple[float, float]:
        wall, device = self.sample(op, axes, x)
        t = wall if self.clock == "wall" else device
        return t, self.power.energy(t, UTILIZATION)
