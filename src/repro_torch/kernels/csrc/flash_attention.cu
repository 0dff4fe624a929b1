// Flash attention over a full sequence (training forward, prefill), causal
// with an optional sliding window, grouped-query (GQA).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py,
// flash_attention_pallas / _attn_kernel: q (B, Sq, Hq, D) attends to
// k, v (B, Skv, Hkv, D) with kv head h / group, an fp32 online softmax
// (m, l, acc) over BQ x BK tiles, the mask k < Skv, k <= q_pos (causal) and
// k > q_pos - window with q_pos = q_offset + row, tiles wholly outside it
// skipped, the finite NEG_INF = -1e30 and the final division clamping l at
// 1e-30.  Beside the output it writes the row's log-sum-exp
// lse = m + log(max(l, 1e-30)) in fp32, which the backward pass needs.
// Masked scores get probability 0 explicitly, so a row with no valid key
// yields 0 and a finite lse (about -1e30).
//
// Bound on the H100: operations.  At the training shape of qwen2-0.5b
// (B 4, S 1024, Hq 14, Hkv 2, D 64, causal) the work is
// 4 * B * Hq * D * S (S + 1) / 2 = 7.5 GFLOP, 7.6 us at the 989 TFLOP/s of
// dense bf16 tensor cores, against 17 MB of q, k, v and out, 5 us at
// 3.35 TB/s.
//
// Design: the Pallas kernel walks KV tiles along the minor grid axis, which
// runs in order on one TPU core, and carries (m, l, acc) in VMEM across
// those steps.  CUDA blocks run in no order, so here one 128-thread block
// owns a BQ = 64-row query tile of one (b, h) and loops over the KV tiles
// itself, from the first tile the window reaches to the last tile
// causality allows (the Pallas `live` test turned into loop bounds).
// The grid is (ceil(Sq / BQ), B * Hq), the query tiles taken last-first
// so the long causal rows start first.  K and V are read at kv head
// h / group with no repeat in memory.  The tiles sit in shared memory as
// fp32: Q^T and K^T (so a thread reads 4 query rows and 2 x 4 keys as
// float4s), then V in K's place, and P^T.  Each thread computes a 4 x 8
// block of the 64 x 64 score tile with fp32 FMAs on the CUDA cores; the 8
// threads that share 4 rows reduce their row max and row sum with
// shuffles and each keeps those 4 rows' (m, l) and a 4 x D/8 block of the
// accumulator in registers.  This spends none of the tensor cores, whose
// rate the bound assumes; a wgmma / TMA pipeline with producer and
// consumer warps is the redesign that closes the gap.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kLd = 68;          // row pitch of Q^T, K^T and P^T (floats)
constexpr int kRows = 4;         // query rows per thread
constexpr int kCols = 8;         // keys per thread in the score tile
constexpr float kNegInf = -1e30f;

template <int D>
constexpr int smem_floats() {
  // Q^T [D][kLd], K^T [D][kLd] (then V [kBK][D] in its place), P^T [kBK][kLd]
  return D * kLd + D * kLd + kBK * kLd;
}

// Key (within the tile) of a thread's j-th score column: two runs of 4
// keys, 32 apart, so the 8 threads of a row group read 128 contiguous
// bytes of K^T per float4.
__device__ __forceinline__ int score_col(int tx, int j) {
  return (j >> 2) * 32 + tx * 4 + (j & 3);
}

// Column of the output / V that a thread's e-th accumulator holds.
template <int D>
__device__ __forceinline__ int out_col(int tx, int e) {
  if constexpr (D >= 32) {
    return (e >> 2) * 32 + tx * 4 + (e & 3);
  } else {
    return tx * (D / 8) + e;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           float* __restrict__ lse, int sq, int skv, int hq,
                           int hkv, int group, int q_offset, int causal,
                           int window, float scale) {
  constexpr int E = D / 8;       // accumulator columns per thread
  extern __shared__ __align__(16) float smem[];
  float* s_qt = smem;            // [D][kLd]
  float* s_kv = s_qt + D * kLd;  // K^T [D][kLd], then V [kBK][D]
  float* s_pt = s_kv + D * kLd;  // [kBK][kLd]

  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / hq;
  const int h = bh - b * hq;
  const int kvh = h / group;
  const int q0 = q_tile * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid & 7;        // column group
  const int ty = tid >> 3;       // row group: rows 4 ty .. 4 ty + 3

  const size_t q_pitch = static_cast<size_t>(hq) * D;
  const size_t kv_pitch = static_cast<size_t>(hkv) * D;
  const T* qb = q + static_cast<size_t>(b) * sq * q_pitch + h * D;
  const T* kb = k + static_cast<size_t>(b) * skv * kv_pitch + kvh * D;
  const T* vb = v + static_cast<size_t>(b) * skv * kv_pitch + kvh * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    const int row = q0 + r;
    s_qt[d * kLd + r] =
        row < sq ? apex::to_float(qb[static_cast<size_t>(row) * q_pitch + d])
                 : 0.f;
  }

  int q_pos[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) q_pos[i] = q_offset + q0 + ty * kRows + i;

  // KV range any row of this tile can see: the `live` test as bounds.
  const int q_last = min(q0 + kBQ, sq) - 1;
  int k_end = skv;
  if (causal) k_end = min(k_end, q_offset + q_last + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_offset + q0 - window + 1);

  float m[kRows], l[kRows], acc[kRows][E];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
  }

  for (int k0 = (k_begin / kBK) * kBK; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's P V is done with s_kv and s_pt
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D;
      const int d = i - c * D;
      const int key = k0 + c;
      s_kv[d * kLd + c] =
          key < skv
              ? apex::to_float(kb[static_cast<size_t>(key) * kv_pitch + d])
              : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
    }
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&s_qt[d * kLd + ty * 4]);
      const float4 b0 =
          *reinterpret_cast<const float4*>(&s_kv[d * kLd + tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&s_kv[d * kLd + 32 + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] += av[i] * bv[j];
      }
    }

    // mask, then the online softmax; the 8 threads of a row group are
    // lanes 8g .. 8g + 7 of one warp
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float mx = kNegInf;
      unsigned valid = 0;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int key = k0 + score_col(tx, j);
        const bool ok = key < skv && (!causal || key <= q_pos[i]) &&
                        (window <= 0 || key > q_pos[i] - window);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        valid |= static_cast<unsigned>(ok) << j;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = (valid >> j) & 1u ? expf(s[i][j] - m_new) : 0.f;
        s[i][j] = p;
        ps += p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) {
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      }
      l[i] = l[i] * corr + ps;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i][e] *= corr;
    }

    __syncthreads();  // every thread is done reading K^T
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      *reinterpret_cast<float4*>(&s_pt[score_col(tx, j) * kLd + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D;
      const int key = k0 + c;
      const size_t at = static_cast<size_t>(key) * kv_pitch + (i - c * D);
      s_kv[i] = key < skv ? apex::to_float(vb[at]) : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 p4 = *reinterpret_cast<const float4*>(&s_pt[c * kLd + ty * 4]);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
      float vv[E];
      if constexpr (D >= 32) {
#pragma unroll
        for (int e = 0; e < E; e += 4) {
          const float4 x = *reinterpret_cast<const float4*>(
              &s_kv[c * D + out_col<D>(tx, e)]);
          vv[e] = x.x;
          vv[e + 1] = x.y;
          vv[e + 2] = x.z;
          vv[e + 3] = x.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) vv[e] = s_kv[c * D + out_col<D>(tx, e)];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int e = 0; e < E; ++e) acc[i][e] += pv[i] * vv[e];
      }
    }
  }

  T* ob = out + static_cast<size_t>(b) * sq * q_pitch + h * D;
  float* lb = lse + static_cast<size_t>(bh) * sq;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty * kRows + i;
    if (row < sq) {
      const float l_safe = fmaxf(l[i], 1e-30f);
      const float inv = 1.0f / l_safe;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        ob[static_cast<size_t>(row) * q_pitch + out_col<D>(tx, e)] =
            apex::from_float<T>(acc[i][e] * inv);
      }
      if (tx == 0) lb[row] = m[i] + logf(l_safe);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int batch, int sq, int skv, int hq, int hkv, int q_offset,
           int causal, int window, float scale, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, batch * hq);
  flash_attention_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), sq, skv, hq, hkv, hq / hkv, q_offset, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dim(int head_dim, const void* q, const void* k, const void* v,
               void* out, void* lse, int batch, int sq, int skv, int hq,
               int hkv, int q_offset, int causal, int window, float scale,
               cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch<T, 16>(q, k, v, out, lse, batch, sq, skv, hq, hkv,
                           q_offset, causal, window, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, out, lse, batch, sq, skv, hq, hkv,
                           q_offset, causal, window, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, lse, batch, sq, skv, hq, hkv,
                           q_offset, causal, window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, lse, batch, sq, skv, hq, hkv,
                            q_offset, causal, window, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, out: (batch, sq, hq, D); k, v: (batch, skv, hkv, D); lse: (batch, hq,
// sq) fp32.  All contiguous; q/k/v/out of one dtype.  D is 16, 32, 64 or
// 128; hq is a multiple of hkv with hq / hkv in 1..8; sq, skv >= 1;
// batch * hq <= 65535; window <= 0 means none.  Returns cudaGetLastError()
// after the launch.
extern "C" int apex_flash_attention(const void* q, const void* k,
                                    const void* v, void* out, void* lse,
                                    int batch, int sq, int skv, int hq,
                                    int hkv, int head_dim, int q_offset,
                                    int causal, int window, int dtype,
                                    float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hkv < 1 || hq % hkv != 0 || hq / hkv > 8 || sq < 1 || skv < 1 ||
      batch < 1 || batch * hq > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == apex::kFloat32) {
    return launch_dim<float>(head_dim, q, k, v, out, lse, batch, sq, skv, hq,
                             hkv, q_offset, causal, window, scale, s);
  }
  if (dtype == apex::kBFloat16) {
    return launch_dim<__nv_bfloat16>(head_dim, q, k, v, out, lse, batch, sq,
                                     skv, hq, hkv, q_offset, causal, window,
                                     scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
