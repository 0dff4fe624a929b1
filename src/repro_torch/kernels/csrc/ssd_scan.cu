// Mamba2 chunked SSD scan (state-space duality), without the D-skip term.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/ssd_scan.py,
// ssd_scan_pallas / _ssd_kernel.  x (B, S, H, P), dt (B, S, H) fp32
// (softplus-activated), a_log (H,) fp32 and b, c (B, S, N) (n_groups = 1)
// give y (B, S, H, P) in x's dtype.  Per (b, h), chunk after chunk of Q
// rows (the sequence padded with zero rows to a multiple of Q), in fp32:
//   cum = cumsum(dt * A), A = -exp(a_log[h])
//   y   = ((C B^T) o L) @ (dt x) + exp(cum) o (C h^T),
//         L[i, j] = exp(cum_i - cum_j) for j <= i, 0 above the diagonal
//   h  <- exp(cum_last) h + (dt x exp(cum_last - cum))^T B
// with the (P, N) state h carried from one chunk to the next.  L is
// computed as exp(cum_i - cum_j) for j <= i only: factored as
// exp(cum_i) exp(-cum_j) it overflows, since cum reaches about -1400
// inside one 128-row chunk when A = -16.  Zero rows (dt = 0, x = 0,
// b = c = 0) leave the state untouched, so the padding is exact.
//
// Bound on the H100: HBM bytes in bf16.  At mamba2-2.7b's training shape
// (B 4, S 1024, H 80, P 64, N 128, Q 128) the kernel must read x, dt, b, c
// and write y, 87 MB, 0.026 ms at 3.35 TB/s.  The least work is
// 13.5 GFLOP (C B^T once per (b, chunk), the lower triangle of the
// intra-chunk product, C h^T and the state update per (b, h, chunk)),
// 0.014 ms at the 989 TFLOP/s of bf16 tensor cores; in fp32 the bytes
// double and the operations at 67 TFLOP/s bound it (0.2 ms).
//
// The Pallas kernel walks the chunks along the minor grid axis, which
// runs in order on one TPU core, and keeps the state in VMEM scratch
// across those steps.  CUDA blocks run in no order, so here one CTA owns
// one (b, h) and loops over the chunks itself.  Two kernels, picked by
// the wrapper's written rule (ssd_scan.py, `variant`; a dispatch, not a
// fallback):
//
// bf16 x, b and c at chunk 128, P 32 or 64, N 16, 32, 64 or 128 (the
// mamba2 configs): tensor cores (ssd_scan_wgmma_kernel, namespace tc).  A
// 288-thread CTA: two consumer warpgroups of 64 chunk rows each and one
// producer warp, as in flash_attention.cu, with its Hopper helpers
// (hopper.cuh).  The producer's lane 0 loads each chunk's C and B (a 4-D
// map (N, 1, S, B)) and x (the map (P, H, S, B)) with TMA into a
// two-stage ring of swizzled tiles (rows past S read as zeros, so a short
// or ragged sequence is zero-padded to 128 rows, which is exact); the
// warp loads dt and every lane runs the row-order sum cum = cumsum(dt A)
// over the chunk, the values broadcast by shuffles.  Per chunk each
// consumer warpgroup computes
//   y = exp(cum_i) (C h^T)        wgmma, C and h K-major in shared memory
//   S = C B^T per 64 keys        wgmma, as flash's Q K^T (warpgroup 0
//                                 needs keys 0-63 only)
//   W'[i, j] = S exp(cum_i - cum_j) dt_j, j <= i, in registers (dt folded
//                                 into W' keeps x an exact bf16 operand)
//   y += W' x                    register-sourced wgmma, x MN-major, as
//                                 flash's P V
// and stores y through shared memory with a TMA store.  The fp32
// operands go to the bf16 tensor cores split into bf16 terms (hi =
// bf16(v), lo = bf16(v - hi), ..., all products into one fp32
// accumulator): W' in three (hi + mid + lo), h and x o s in two.
// Rounding any one of them to bf16 once breaks the bf16 limits of
// chip_smoke.py (tests/test_torch_hopper.py emulates the arithmetic on
// the CPU).  Two terms of W' hold those limits too (6.3e-4 of outputs not
// bit-equal on an H100), but the mamba2 depth-8 bf16 train parity then
// read masters 0.110 against MAMBA_TRAIN_TOL's 0.1; three terms read
// 1.0e-4 not bit-equal and masters 0.088-0.090 (seeds 0-2) for 5% more
// time (0.201 -> 0.210 ms).  Then the state
//   h <- exp(cum_last) h + (x o s)^T B,  s_i = dt_i exp(cum_last - cum_i)
// by register-sourced wgmma with A = (x o s)^T built from x in shared
// memory and B MN-major; at N = 128 each warpgroup owns 64 of h's
// columns (fp32, in registers from chunk to chunk), below that
// warpgroup 0 all of them, and the owners write h's bf16 hi/lo copy for
// the next chunk's C h^T.  Shared memory at P 64, N 128: two stages of C,
// B and x (160 KB), h hi/lo (32 KB) and y (16 KB), so one CTA per SM; the
// B * H = 320 CTAs of the training shape take three waves on 132 SMs.
// At that shape it takes 0.210 ms on an H100 (the CUDA-core kernel
// 1.66).  With W' in two terms it took 0.201 ms, about 8.4 us per
// chunk, of which (diagnostic copies, time only) the intra-chunk part is
// ~3.5 us, the state update ~1.8 (0.6 of it building A from shared
// memory), C h^T ~0.5, and the rest the chunk's loads, the y store and
// the barriers.  Issuing the S of keys 64-127
// beside W' of keys 0-63, or one warpgroup doing the whole state update,
// measured slower; 2.42 waves of work take three.
//
// Everything else (fp32, other chunks, P or N): CUDA cores
// (ssd_scan_kernel).  One 256-thread block per (b, h), the fp32 state
// staying in shared memory from chunk to chunk.  Per chunk the block
// stages dt x, B and C in fp32 in shared memory (rows of B, C and the
// state padded to N + 4 floats, so float4 reads down a column by 8 lanes
// hit 32 distinct banks), takes the cumulative sum of dt A in one thread,
// then walks the Q x Q score matrix in 32-row panels: a panel of
// (C B^T) o L (each thread a 4 x 4 register tile, column blocks right of
// the diagonal skipped), then those rows of y, intra-chunk and
// carried-state parts together (each thread 4 rows x 2 columns).  Last it
// updates the state (each thread 8 x 4 entries).  At the largest shape
// (Q 128, P 64, N 128) a block takes 215 KB of shared memory, so one
// block of 8 warps runs per SM.  With so few warps the time goes to
// latency, not to bandwidth: the inner loops read shared memory as
// float4s and the staging issues 16 loads per thread before it stores
// (1.66 ms at the training shape in bf16 on an H100; 2.29 with scalar
// reads and one load at a time).  fp32 runs only the parity reference.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPanel = 32;       // rows of the score panel
constexpr int kMaxQ = 128;
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// Floats of shared memory for chunks of q rows (q, p, n multiples of 4).
__host__ __device__ inline int smem_floats(int q, int p, int n) {
  return q * p               // dt x, then dt x exp(cum_last - cum)
         + 2 * q * (n + 4)   // B, C
         + p * (n + 4)       // carried state h
         + kPanel * q        // one panel of (C B^T) o L
         + 4 * q;            // dt, cum, exp(cum), exp(cum_last - cum)
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Stages rows [s0, s0 + Q) of a row-major slice (rows `stride` elements
// apart, `width` used) into shared memory as fp32 rows of pitch `pitch`,
// each times scale[i] when a scale is given; rows from Q to Qp and past
// the sequence are zero.  Each thread issues kInFlight loads before it
// stores any: with one block per SM, a load at a time would leave the
// block waiting out the memory latency once per element it stages.
template <typename TS>
__device__ __forceinline__ void stage(const TS* __restrict__ src,
                                      size_t stride, int width,
                                      float* __restrict__ dst, int pitch,
                                      const float* __restrict__ scale,
                                      int Q, int Qp, int s0, int seqlen) {
  constexpr int kInFlight = 16;
  const int total = Qp * width;
  for (int base = threadIdx.x; base < total; base += kThreads * kInFlight) {
    float v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int idx = base + u * kThreads;
      const int i = idx / width;
      v[u] = 0.f;
      if (idx < total && i < Q && s0 + i < seqlen) {
        v[u] = apex::to_float(
            src[static_cast<size_t>(s0 + i) * stride + (idx - i * width)]);
      }
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int idx = base + u * kThreads;
      if (idx < total) {
        const int i = idx / width;
        dst[i * pitch + (idx - i * width)] =
            scale == nullptr ? v[u] : v[u] * scale[i];
      }
    }
  }
}

template <typename T, typename TB>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a_log,
                    const TB* __restrict__ b, const TB* __restrict__ c,
                    T* __restrict__ y, int seqlen, int heads, int P, int N,
                    int Q) {
  extern __shared__ float4 smem4[];
  // A chunk is Q rows of the sequence, held as Qp = round4(Q) rows whose
  // tail rows are zero, like the padding past the sequence's end.
  const int Qp = round4(Q);
  const int NP = N + 4;              // pitch of B, C and h rows
  float* xdt = reinterpret_cast<float*>(smem4);   // [Qp][P]
  float* bs = xdt + Qp * P;          // [Qp][NP]
  float* cs = bs + Qp * NP;          // [Qp][NP]
  float* hs = cs + Qp * NP;          // [P][NP]
  float* wp = hs + P * NP;           // [kPanel][Qp]
  float* dts = wp + kPanel * Qp;     // [Qp]
  float* cum = dts + Qp;             // [Qp]
  float* ecum = cum + Qp;            // [Qp]
  float* dec = ecum + Qp;            // [Qp]

  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;
  const int bi = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const float A = -expf(a_log[h]);
  const size_t row_x = static_cast<size_t>(heads) * P;   // x / y row pitch

  for (int i = tid; i < P * NP; i += kThreads) hs[i] = 0.f;

  const int n_chunks = (seqlen + Q - 1) / Q;
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const int s0 = chunk * Q;
    __syncthreads();   // the previous chunk is done with every buffer
    // -- stage dt, B and C; rows past the chunk or the sequence are zero --
    for (int i = tid; i < Qp; i += kThreads) {
      const int s = s0 + i;
      dts[i] = i < Q && s < seqlen
                   ? dt[(static_cast<size_t>(bi) * seqlen + s) * heads + h]
                   : 0.f;
    }
    const size_t b_off = static_cast<size_t>(bi) * seqlen * N;
    stage(b + b_off, N, N, bs, NP, nullptr, Q, Qp, s0, seqlen);
    stage(c + b_off, N, N, cs, NP, nullptr, Q, Qp, s0, seqlen);
    __syncthreads();
    // -- warp 0: cum = cumsum(dt A) in row order, then the exps; all: dt x.
    // The sum runs in one thread, unfused, in the order of torch.cumsum
    // over a leading axis: cum reaches about -1400 in a chunk, where one
    // fp32 ulp is 1.2e-4, and a sum in another order moves L by that.
    if (ty == 0) {
      if (tx == 0) {
        float run = 0.f;
        for (int i = 0; i < Qp; ++i) {
          run = __fadd_rn(run, __fmul_rn(dts[i], A));
          cum[i] = run;
        }
      }
      __syncwarp();
      const float last = cum[Qp - 1];
      for (int i = tx; i < Qp; i += 32) {
        ecum[i] = expf(cum[i]);
        dec[i] = expf(last - cum[i]);
      }
    }
    stage(x + static_cast<size_t>(bi) * seqlen * row_x +
              static_cast<size_t>(h) * P,
          row_x, P, xdt, P, dts, Q, Qp, s0, seqlen);
    __syncthreads();

    // -- 32-row panels of the chunk -----------------------------------------
    for (int r0 = 0; r0 < Qp; r0 += kPanel) {
      // (C B^T) o L for rows r0 + 4 ty + {0..3}, columns tx + 32 kk; the
      // column blocks right of the panel's last row are all masked.  Rows
      // of C are read as float4 by the whole warp (one address), rows of B
      // as float4 by each lane (pitch N + 4: 8 lanes cover 32 banks).
      const int nk = min(r0 / 32 + 1, (Qp + 31) / 32);
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) acc[i][kk] = 0.f;
      int rrow[4], jcol[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) rrow[i] = min(r0 + ty * 4 + i, Qp - 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) jcol[kk] = min(tx + 32 * kk, Qp - 1);
#pragma unroll 2
      for (int n = 0; n < N; n += 4) {
        float4 cr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cr[i] = ld4(cs + rrow[i] * NP + n);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kk < nk) {
            const float4 bv = ld4(bs + jcol[kk] * NP + n);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[i][kk] += cr[i].x * bv.x;
              acc[i][kk] += cr[i].y * bv.y;
              acc[i][kk] += cr[i].z * bv.z;
              acc[i][kk] += cr[i].w * bv.w;
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + ty * 4 + i;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int j = tx + 32 * kk;
          if (kk < nk && r < Qp && j < Qp) {
            wp[(r - r0) * Qp + j] =
                j <= r ? acc[i][kk] * expf(cum[r] - cum[j]) : 0.f;
          }
        }
      }
      __syncthreads();
      // y for rows r0 + ty + 8 a, columns tx + 32 e: the intra-chunk part
      // from the panel, plus exp(cum) times C h^T from the carried state.
      // Rows of the panel past Qp hold stale values and are not stored.
      const int jmax = min(r0 + kPanel, Qp);
      float yi[4][2], yc[4][2];
      int pcol[2], crow[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) pcol[e] = min(tx + 32 * e, P - 1);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        crow[a] = min(r0 + ty + 8 * a, Qp - 1);
#pragma unroll
        for (int e = 0; e < 2; ++e) yi[a][e] = yc[a][e] = 0.f;
      }
      for (int j = 0; j < jmax; j += 4) {
        float xv[4][2];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int e = 0; e < 2; ++e) xv[u][e] = xdt[(j + u) * P + pcol[e]];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float4 w = ld4(wp + (ty + 8 * a) * Qp + j);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            yi[a][e] += w.x * xv[0][e];
            yi[a][e] += w.y * xv[1][e];
            yi[a][e] += w.z * xv[2][e];
            yi[a][e] += w.w * xv[3][e];
          }
        }
      }
#pragma unroll 2
      for (int n = 0; n < N; n += 4) {
        float4 hv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) hv[e] = ld4(hs + pcol[e] * NP + n);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float4 cv = ld4(cs + crow[a] * NP + n);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            yc[a][e] += cv.x * hv[e].x;
            yc[a][e] += cv.y * hv[e].y;
            yc[a][e] += cv.z * hv[e].z;
            yc[a][e] += cv.w * hv[e].w;
          }
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = r0 + ty + 8 * a;
        const int s = s0 + r;
        if (r < Q && s < seqlen) {
          T* yrow = y + (static_cast<size_t>(bi) * seqlen + s) * row_x +
                    static_cast<size_t>(h) * P;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int p = tx + 32 * e;
            if (p < P) {
              yrow[p] = apex::from_float<T>(yi[a][e] + ecum[r] * yc[a][e]);
            }
          }
        }
      }
      __syncthreads();   // the next panel overwrites wp
    }

    // -- state: h <- exp(cum_last) h + (dt x exp(cum_last - cum))^T B ------
    // Each thread owns rows 8 ty + {0..7} and columns 4 tx + {0..3} of h.
    for (int idx = tid; idx < Qp * P; idx += kThreads) {
      xdt[idx] *= dec[idx / P];
    }
    __syncthreads();
    const float decay = expf(cum[Qp - 1]);
    const int p0 = 8 * ty;
    const int n0 = min(4 * tx, N - 4);
    float acc[8][4];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[a][k] = 0.f;
    if (p0 < P) {
#pragma unroll 2
      for (int i = 0; i < Qp; ++i) {
        const float4 bv = ld4(bs + i * NP + n0);
        const float4 x0 = ld4(xdt + i * P + p0);
        const float4 x1 = p0 + 4 < P ? ld4(xdt + i * P + p0 + 4)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
        const float xw[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          acc[a][0] += xw[a] * bv.x;
          acc[a][1] += xw[a] * bv.y;
          acc[a][2] += xw[a] * bv.z;
          acc[a][3] += xw[a] * bv.w;
        }
      }
    }
    if (4 * tx < N) {
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        if (p0 + a < P) {
          float4* hp = reinterpret_cast<float4*>(hs + (p0 + a) * NP + n0);
          float4 hv = *hp;
          hv.x = hv.x * decay + acc[a][0];
          hv.y = hv.y * decay + acc[a][1];
          hv.z = hv.z * decay + acc[a][2];
          hv.w = hv.w * decay + acc[a][3];
          *hp = hv;
        }
      }
    }
  }
}

template <typename T, typename TB>
int launch(const void* x, const void* dt, const void* a_log, const void* b,
           const void* c, void* y, int batch, int seqlen, int heads, int P,
           int N, int Q, cudaStream_t stream) {
  const int bytes =
      smem_floats(round4(Q), P, N) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T, TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<T, TB><<<batch * heads, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a_log), static_cast<const TB*>(b),
      static_cast<const TB*>(c), static_cast<T*>(y), seqlen, heads, P, N, Q);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bc(int bc_dtype, const void* x, const void* dt, const void* a_log,
              const void* b, const void* c, void* y, int batch, int seqlen,
              int heads, int P, int N, int Q, cudaStream_t stream) {
  if (bc_dtype == apex::kFloat32) {
    return launch<T, float>(x, dt, a_log, b, c, y, batch, seqlen, heads, P,
                            N, Q, stream);
  }
  if (bc_dtype == apex::kBFloat16) {
    return launch<T, __nv_bfloat16>(x, dt, a_log, b, c, y, batch, seqlen,
                                    heads, P, N, Q, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}


// ---- bf16, chunk 128: wgmma + TMA ------------------------------------------

namespace tc {

using namespace apex::hopper;

constexpr int kQ = 128;          // chunk rows: two warpgroups of 64
constexpr int kStages = 2;       // C/B/x ring depth
constexpr int kConsumers = 256;  // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;  // and one producer warp

// Shared-memory layout for head dim P and state dim N (each 16, 32, 64 or
// 128 bf16 columns; P is 32 or 64).  Per ring stage: C and B (kQ rows of
// N, in SwizzleAtom<N> atoms of kQ rows each), then x (kQ rows of P, one
// SwizzleAtom<P> atom).  After the ring: the carried state h as a bf16
// hi/lo pair, each P rows of N in SwizzleAtom<N> atoms of P rows; and the
// chunk's y, laid out as x, which TMA stores.
template <int P, int N>
struct SsdCfg {
  using AtomN = SwizzleAtom<N>;
  using AtomP = SwizzleAtom<P>;
  static constexpr int kBCAtom = kQ * AtomN::kRowBytes;  // one C or B atom
  static constexpr int kBCBytes = kQ * N * 2;
  static constexpr int kXBytes = kQ * P * 2;
  static constexpr int kHAtom = P * AtomN::kRowBytes;    // one h atom
  static constexpr int kHBytes = P * N * 2;
  static constexpr int kStageBytes = 2 * kBCBytes + kXBytes;
  // + 1 KB to align the base to the 1024-byte period of the 128 B swizzle
  static constexpr int kSmem =
      kStages * kStageBytes + 2 * kHBytes + kXBytes + 1024;
  // the state update: each warpgroup owns kNW of h's N columns at N = 128,
  // warpgroup 0 all of them below
  static constexpr int kStateWGs = N == 128 ? 2 : 1;
  static constexpr int kNW = N / kStateWGs;
};

// acc (+)= A B^T over 16 of K, both operands K-major in shared memory,
// n = 64 or 32 columns by the accumulator's size.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int scale_d) {
  wgmma_ss_n64(d, a, b, scale_d);
}
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a,
                                         uint64_t b, int scale_d) {
  wgmma_ss_n32(d, a, b, scale_d);
}

// hi = bf16(x0, x1) and lo = bf16 of what hi leaves out, as the pairs of an
// A fragment: hi + lo holds x to about 2^-17 of |x|.
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 back = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - back.x, x1 - back.y);
}

// The same in three terms, hi + mid + lo, to about 2^-25 of |x|.
__device__ __forceinline__ void split_pair3(float x0, float x1, uint32_t& hi,
                                            uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 back = __bfloat1622float2(h);
  const float r0 = x0 - back.x;
  const float r1 = x1 - back.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mback = __bfloat1622float2(m);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = pack_bf16(r0 - mback.x, r1 - mback.y);
}

template <int P, int N>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_scan_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                          const __grid_constant__ CUtensorMap map_b,
                          const __grid_constant__ CUtensorMap map_c,
                          const __grid_constant__ CUtensorMap map_y,
                          const float* __restrict__ dt,
                          const float* __restrict__ a_log, int seqlen,
                          int heads) {
  using G = SsdCfg<P, N>;
  using AN = typename G::AtomN;
  using AP = typename G::AtomP;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_full[kStages];
  __shared__ __align__(8) uint64_t bar_empty[kStages];
  // per stage and chunk row: dt, cum = cumsum(dt A), exp(cum) and
  // dt exp(cum_last - cum)
  __shared__ float s_dt[kStages][kQ];
  __shared__ float s_cum[kStages][kQ];
  __shared__ float s_ecum[kStages][kQ];
  __shared__ float s_sdec[kStages][kQ];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* s_hhi = base + kStages * G::kStageBytes;
  uint8_t* s_hlo = s_hhi + G::kHBytes;
  uint8_t* s_y = s_hlo + G::kHBytes;

  const int bi = blockIdx.x / heads;
  const int h = blockIdx.x - bi * heads;
  const int n_chunks = (seqlen + kQ - 1) / kQ;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      // the producer lane 0's expect_tx arrival and all 32 lanes' after
      // they wrote the stage's dt and cum rows
      mbar_init(&bar_full[s], 1 + 32);
      mbar_init(&bar_empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i < 2 * G::kHBytes / 16; i += kThreads) {
    reinterpret_cast<uint4*>(s_hhi)[i] = make_uint4(0, 0, 0, 0);
  }
  fence_proxy_async();
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // producer warp: lane 0 issues the chunk's copies, then the warp loads
    // dt and sums cum in row order (as torch.cumsum does: cum reaches
    // about -1400 in a chunk, where an fp32 ulp is 1.2e-4, so a sum in
    // another order moves exp(cum_i - cum_j) by that)
    const int lane = threadIdx.x - kConsumers;
    const float A = -expf(a_log[h]);
    for (int i = 0; i < n_chunks; ++i) {
      const int stage = i % kStages;
      const int s0 = i * kQ;
      // lane l loads the dt of rows l + 32 k (before the wait, so the
      // loads overlap it)
      float dtv[kQ / 32];
#pragma unroll
      for (int k = 0; k < kQ / 32; ++k) {
        const int s = s0 + lane + 32 * k;
        dtv[k] = s < seqlen
                     ? dt[(static_cast<size_t>(bi) * seqlen + s) * heads + h]
                     : 0.f;
      }
      mbar_wait(&bar_empty[stage], ((i / kStages) & 1) ^ 1);
      uint8_t* st = base + stage * G::kStageBytes;
      if (lane == 0) {
        mbar_expect_tx(&bar_full[stage], 2 * G::kBCBytes + G::kXBytes);
#pragma unroll
        for (int a = 0; a < AN::kAtoms; ++a) {
          tma_load(st + a * G::kBCAtom, &map_c, &bar_full[stage],
                   a * AN::kAtomCols, 0, s0, bi);
          tma_load(st + G::kBCBytes + a * G::kBCAtom, &map_b,
                   &bar_full[stage], a * AN::kAtomCols, 0, s0, bi);
        }
        tma_load(st + 2 * G::kBCBytes, &map_x, &bar_full[stage], 0, h, s0,
                 bi);
      }
      // every lane runs the row-order sum over all kQ rows, the values
      // broadcast by shuffles, and keeps the cum of its own rows
      float run = 0.f;
      float cumv[kQ / 32] = {};
#pragma unroll
      for (int k = 0; k < kQ / 32; ++k) {
#pragma unroll
        for (int l = 0; l < 32; ++l) {
          run = __fadd_rn(run,
                          __fmul_rn(__shfl_sync(0xffffffffu, dtv[k], l), A));
          if (l == lane) cumv[k] = run;
        }
      }
#pragma unroll
      for (int k = 0; k < kQ / 32; ++k) {
        const int r = lane + 32 * k;
        s_dt[stage][r] = dtv[k];
        s_cum[stage][r] = cumv[k];
        s_ecum[stage][r] = expf(cumv[k]);
        s_sdec[stage][r] = dtv[k] * expf(run - cumv[k]);   // run: cum_last
      }
      mbar_arrive(&bar_full[stage]);
    }
    return;
  }

  // consumers: warpgroup wg owns chunk rows 64 wg .. 64 wg + 63; a thread
  // holds rows r0 and r0 + 8 of them (the wgmma fragment), in each
  // 8-column group the two columns cq, cq + 1
  const int wg = threadIdx.x >> 7;
  const int t = threadIdx.x & 127;
  const int r0 = 16 * (t >> 5) + ((t & 31) >> 2);
  const int cq = 2 * (t & 3);
  const int row[2] = {64 * wg + r0, 64 * wg + r0 + 8};
  constexpr uint32_t kSboN = 8 * AN::kRowBytes;  // next group of 8 rows
  constexpr uint32_t kSboP = 8 * AP::kRowBytes;
  // the state update's rows are h's P rows (rows past P of m64 are zero at
  // P = 32); this warpgroup's columns start at n0
  const bool owns_state = G::kStateWGs == 2 || wg == 0;
  const int n0 = G::kStateWGs == 2 ? wg * G::kNW : 0;
  const uint32_t hhi_addr = smem_u32(s_hhi);
  const uint32_t hlo_addr = smem_u32(s_hlo);

  float hacc[G::kNW / 2];   // fp32 h[r0 + 8 hh][n0 + 8 c + cq + j]
#pragma unroll
  for (int e = 0; e < G::kNW / 2; ++e) hacc[e] = 0.f;

  for (int i = 0; i < n_chunks; ++i) {
    const int stage = i % kStages;
    const int s0 = i * kQ;
    mbar_wait(&bar_full[stage], (i / kStages) & 1);
    const uint8_t* st = base + stage * G::kStageBytes;
    const uint32_t c_addr = smem_u32(st) + wg * 64 * AN::kRowBytes;
    const uint32_t b_addr = smem_u32(st + G::kBCBytes);
    const uint8_t* s_x = st + 2 * G::kBCBytes;
    const uint32_t x_addr = smem_u32(s_x);
    const float* dts = s_dt[stage];
    const float* cum = s_cum[stage];
    const float* ecum = s_ecum[stage];
    const float cum_row[2] = {cum[row[0]], cum[row[1]]};

    // carried state: y = exp(cum_i) (C h^T), h as bf16 hi + lo (B operand
    // K-major, P rows of N).  (C h^T in an accumulator of its own, added
    // to the intra-chunk part at the end as the plain version does, read
    // the same share of outputs not bit-equal and 0.25 ms on an H100.)
    float yacc[P / 2];
#pragma unroll
    for (int e = 0; e < P / 2; ++e) yacc[e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int part = 0; part < 2; ++part) {
      const uint32_t h_addr = part == 0 ? hhi_addr : hlo_addr;
#pragma unroll
      for (int ks = 0; ks < N / 16; ++ks) {
        const uint32_t col = (ks * 16) / AN::kAtomCols;
        const uint32_t within = ((ks * 16) % AN::kAtomCols) * 2;
        wgmma_ss(yacc,
                 make_desc(c_addr + col * G::kBCAtom + within, 16, kSboN,
                           AN::kLayout),
                 make_desc(h_addr + col * G::kHAtom + within, 16, kSboN,
                           AN::kLayout),
                 part > 0 || ks > 0);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(yacc);
#pragma unroll
    for (int e = 0; e < P / 2; ++e) yacc[e] *= ecum[row[(e >> 1) & 1]];

    // intra-chunk: per 64 keys, S = C B^T on the tensor cores, then
    // W'[i, j] = S exp(cum_i - cum_j) dt_j for j <= i in registers, split
    // into bf16 hi + mid + lo, and y += W' x with x MN-major (imm-trans-b).
    // Warpgroup 0's rows see keys 0-63 only.
    for (int half = 0; half <= wg; ++half) {
      float s[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < N / 16; ++ks) {
        const uint32_t col = (ks * 16) / AN::kAtomCols;
        const uint32_t within = ((ks * 16) % AN::kAtomCols) * 2;
        wgmma_ss_n64(
            s,
            make_desc(c_addr + col * G::kBCAtom + within, 16, kSboN,
                      AN::kLayout),
            make_desc(b_addr + half * 64 * AN::kRowBytes + col * G::kBCAtom +
                          within,
                      16, kSboN, AN::kLayout),
            ks > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      // s[4 c + 2 hh + j]: row row[hh], key 64 half + 8 c + cq + j
#pragma unroll
      for (int c = 0; c < 8; ++c) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int key = 64 * half + 8 * c + cq + j;
          const float ck = cum[key];
          const float dk = dts[key];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int e = 4 * c + 2 * hh + j;
            s[e] = key <= row[hh] ? s[e] * expf(cum_row[hh] - ck) * dk : 0.f;
          }
        }
      }
      uint32_t w_hi[4][4], w_mid[4][4], w_lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          split_pair3(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], w_hi[kk][r],
                      w_mid[kk][r], w_lo[kk][r]);
        }
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // keys 64 half + 16 kk .. + 15 are rows of x; N = P columns
        const uint64_t dx =
            make_desc(x_addr + (64 * half + 16 * kk) * AP::kRowBytes,
                      G::kXBytes, kSboP, AP::kLayout);
        wgmma_rs(yacc, w_hi[kk], dx);
        wgmma_rs(yacc, w_mid[kk], dx);
        wgmma_rs(yacc, w_lo[kk], dx);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(yacc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        fence_regs(w_hi[kk]);
        fence_regs(w_mid[kk]);
        fence_regs(w_lo[kk]);
      }
    }
    // y to shared memory in x's swizzled layout; one thread stores the
    // tile with TMA (rows past the sequence are not written): 0.214 ->
    // 0.201 ms at the training shape on an H100 against 4-byte stores
    // straight from the fragment.
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int c = 0; c < P / 8; ++c) {
        *reinterpret_cast<__nv_bfloat162*>(
            s_y + swizzle<AP::kRowBytes>(row[hh], 2 * (8 * c + cq))) =
            __floats2bfloat162_rn(yacc[4 * c + 2 * hh],
                                  yacc[4 * c + 2 * hh + 1]);
      }
    }
    fence_proxy_async();
    // every warpgroup is done reading h and has written its rows of y
    named_sync(1, kConsumers);
    if (threadIdx.x == 0) {
      tma_store(&map_y, s_y, 0, h, s0, bi);
      bulk_commit();
    }
    if (owns_state) {
      const float* sdec = s_sdec[stage];
      const float decay = ecum[kQ - 1];
#pragma unroll
      for (int e = 0; e < G::kNW / 2; ++e) hacc[e] *= decay;
      uint32_t a_hi[kQ / 16][4], a_lo[kQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < kQ / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int p = r0 + 8 * (r & 1);
          const int i0 = 16 * kk + 8 * (r >> 1) + cq;
          float v0 = 0.f, v1 = 0.f;
          if (p < P) {
            v0 = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
                     s_x + swizzle<AP::kRowBytes>(i0, 2 * p))) *
                 sdec[i0];
            v1 = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
                     s_x + swizzle<AP::kRowBytes>(i0 + 1, 2 * p))) *
                 sdec[i0 + 1];
          }
          split_pair(v0, v1, a_hi[kk][r], a_lo[kk][r]);
        }
      }
      const uint32_t bn_addr = b_addr + (n0 / AN::kAtomCols) * G::kBCAtom;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQ / 16; ++kk) {
        const uint64_t db = make_desc(bn_addr + 16 * kk * AN::kRowBytes,
                                      G::kBCAtom, kSboN, AN::kLayout);
        wgmma_rs(hacc, a_hi[kk], db);
        wgmma_rs(hacc, a_lo[kk], db);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(hacc);
#pragma unroll
      for (int kk = 0; kk < kQ / 16; ++kk) {
        fence_regs(a_hi[kk]);
        fence_regs(a_lo[kk]);
      }
      // h as bf16 hi/lo, K-major (P rows of N), for the next chunk
#pragma unroll
      for (int c = 0; c < G::kNW / 8; ++c) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int p = r0 + 8 * hh;
          if (p < P) {
            const int n = n0 + 8 * c + cq;
            const uint32_t off = (n / AN::kAtomCols) * G::kHAtom +
                                 swizzle<AN::kRowBytes>(
                                     p, 2 * (n % AN::kAtomCols));
            uint32_t hi, lo;
            split_pair(hacc[4 * c + 2 * hh], hacc[4 * c + 2 * hh + 1], hi,
                       lo);
            *reinterpret_cast<uint32_t*>(s_hhi + off) = hi;
            *reinterpret_cast<uint32_t*>(s_hlo + off) = lo;
          }
        }
      }
      fence_proxy_async();
    }
    if (threadIdx.x == 0) bulk_wait_read();   // y's tile may be rewritten
    named_sync(1, kConsumers);   // h is written; the stage is read
    mbar_arrive(&bar_empty[stage]);
  }
  if (threadIdx.x == 0) bulk_wait();
}

template <int P, int N>
int launch(const void* x, const void* dt, const void* a_log, const void* b,
           const void* c, void* y, int batch, int seqlen, int heads,
           cudaStream_t stream) {
  CUtensorMap map_x, map_b, map_c, map_y;
  // x and y as (P, H, S, B); b and c as (N, 1, S, B): one head
  int err = encode<P>(&map_x, x, heads, seqlen, batch, kQ);
  if (err == 0) err = encode<P>(&map_y, y, heads, seqlen, batch, kQ);
  if (err == 0) err = encode<N>(&map_b, b, 1, seqlen, batch, kQ);
  if (err == 0) err = encode<N>(&map_c, c, 1, seqlen, batch, kQ);
  if (err != 0) return err;
  constexpr int bytes = SsdCfg<P, N>::kSmem;
  cudaError_t e = cudaFuncSetAttribute(
      ssd_scan_wgmma_kernel<P, N>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_scan_wgmma_kernel<P, N><<<batch * heads, kThreads, bytes, stream>>>(
      map_x, map_b, map_c, map_y, static_cast<const float*>(dt),
      static_cast<const float*>(a_log), seqlen, heads);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int launch_n(int N, const void* x, const void* dt, const void* a_log,
             const void* b, const void* c, void* y, int batch, int seqlen,
             int heads, cudaStream_t stream) {
  switch (N) {
    case 16:
      return launch<P, 16>(x, dt, a_log, b, c, y, batch, seqlen, heads,
                           stream);
    case 32:
      return launch<P, 32>(x, dt, a_log, b, c, y, batch, seqlen, heads,
                           stream);
    case 64:
      return launch<P, 64>(x, dt, a_log, b, c, y, batch, seqlen, heads,
                           stream);
    case 128:
      return launch<P, 128>(x, dt, a_log, b, c, y, batch, seqlen, heads,
                            stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace tc

}  // namespace

// x, y: (batch, seqlen, heads, head_dim) of x_dtype; dt: (batch, seqlen,
// heads) fp32; a_log: (heads,) fp32; b, c: (batch, seqlen, d_state) of
// bc_dtype.  All contiguous.  chunk is the rows per chunk Q (the caller
// passes min(chunk, seqlen)); 1 <= Q <= 128; head_dim in 4..64 and d_state
// in 4..128, both multiples of 4.  Returns cudaGetLastError() after the
// launch.
extern "C" int apex_ssd_scan(const void* x, const void* dt,
                             const void* a_log, const void* b, const void* c,
                             void* y, int batch, int seqlen, int heads,
                             int head_dim, int d_state, int chunk,
                             int x_dtype, int bc_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch < 1 || seqlen < 1 || heads < 1 || head_dim < 4 ||
      head_dim > kMaxP || head_dim % 4 != 0 || d_state < 4 ||
      d_state > kMaxN || d_state % 4 != 0 || chunk < 1 ||
      chunk > kMaxQ || static_cast<long long>(batch) * heads > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (x_dtype == apex::kFloat32) {
    return launch_bc<float>(bc_dtype, x, dt, a_log, b, c, y, batch, seqlen,
                            heads, head_dim, d_state, chunk, s);
  }
  if (x_dtype == apex::kBFloat16) {
    return launch_bc<__nv_bfloat16>(bc_dtype, x, dt, a_log, b, c, y, batch,
                                    seqlen, heads, head_dim, d_state, chunk,
                                    s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// x, y: (batch, seqlen, heads, head_dim) bf16; dt: (batch, seqlen, heads)
// fp32; a_log: (heads,) fp32; b, c: (batch, seqlen, d_state) bf16.  All
// contiguous, x, b, c and y 16-byte aligned.  Chunks of 128 rows (the last
// one zero-padded); head_dim 32 or 64; d_state 16, 32, 64 or 128.
// Returns cudaGetLastError() after the launch, or tc::kTensorMapError +
// the CUresult of a failed tensor-map encode.
extern "C" int apex_ssd_scan_wgmma(const void* x, const void* dt,
                                   const void* a_log, const void* b,
                                   const void* c, void* y, int batch,
                                   int seqlen, int heads, int head_dim,
                                   int d_state, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch < 1 || seqlen < 1 || heads < 1 ||
      static_cast<long long>(batch) * heads > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (head_dim == 32) {
    return tc::launch_n<32>(d_state, x, dt, a_log, b, c, y, batch, seqlen,
                            heads, s);
  }
  if (head_dim == 64) {
    return tc::launch_n<64>(d_state, x, dt, a_log, b, c, y, batch, seqlen,
                            heads, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
