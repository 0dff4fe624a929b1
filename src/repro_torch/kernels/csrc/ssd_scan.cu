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
// Design: the Pallas kernel walks the chunks along the minor grid axis,
// which runs in order on one TPU core, and keeps the state in VMEM
// scratch across those steps.  CUDA blocks run in no order, so here one
// 256-thread block owns one (b, h) and loops over the chunks itself, the
// fp32 state staying in shared memory from chunk to chunk.  Per chunk the
// block stages dt x, B and C in fp32 in shared memory (rows of B, C and
// the state padded to N + 4 floats, so float4 reads down a column by 8
// lanes hit 32 distinct banks), takes the cumulative sum of dt A in one
// thread, then walks the Q x Q score matrix in 32-row panels: a panel of
// (C B^T) o L (each thread a 4 x 4 register tile, column blocks right of
// the diagonal skipped), then those rows of y, intra-chunk and
// carried-state parts together (each thread 4 rows x 2 columns).  Last it
// updates the state (each thread 8 x 4 entries).  At the largest shape
// (Q 128, P 64, N 128) a block takes 215 KB of shared memory, so one
// block of 8 warps runs per SM and the B * H = 320 blocks of the training
// shape take three waves on 132 SMs.  With so few warps the time goes to
// latency, not to bandwidth: the inner loops read shared memory as
// float4s and the staging issues 16 loads per thread before it stores
// (a first version with scalar reads and one load at a time took 2.29 ms
// at the training shape in bf16, this one 1.66 ms on an H100).
// All products run as fp32 FMAs on the CUDA cores and C B^T is recomputed
// for every head; tensor cores (wgmma), TMA staging and sharing C B^T
// across the heads of a group are the redesign that closes the gap.
#include "common.cuh"

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
