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
// Two kernels, picked by dtype (a dispatch, not a fallback):
//
// bf16: tensor cores.  A 288-thread CTA owns a 128-row query tile of one
// (b, h): two consumer warpgroups of 64 rows each and one producer warp.
// The producer's lane 0 loads Q once and K/V tiles of BK = 64 keys into a
// three-stage ring with TMA (cp.async.bulk.tensor over a 4-D map (D, H, S,
// B), so the ragged end of a sequence reads zeros, not the next batch's
// rows), each stage guarded by a full and an empty mbarrier, so the loads
// of the next tiles overlap the math on tile j.  Shared memory is swizzled
// by D: 32, 64 or 128 B for rows of 16, 32 or 64 bf16; D = 128 and 256
// are two and four 128 B atoms side by side.  At D = 256 three stages
// would take 64 KB of Q and 192 KB of K/V, more than the 227 KB a CTA
// may have, so the ring has two stages there (193 KB), and P V runs as
// two m64n128k16 products on the halves of O and V (wgmma's N stops at
// 256, and the halves reuse the D = 128 instruction); O is 128 fp32
// registers a thread.  Per tile each consumer warpgroup issues
// S = Q K^T as D / 16 wgmma m64n64k16 with both operands K-major in
// shared memory (bf16 x bf16 products are exact in fp32, so S matches
// the reference's fp32 dot up to summation order), runs the online
// softmax in registers in fp32 with expf, and adds P V with
// register-sourced wgmma m64nDk16, V MN-major (imm-trans-b).  BK = 64
// keeps S, P and O of D = 128 in registers; a BK = 128 tile would fit
// shared memory too, but not the register file of two warpgroups.
// P stays fp32 as in the reference, which multiplies fp32 p by v: it is
// split as P_hi = bf16(P), P_lo = bf16(P - P_hi), and both products go
// into the same accumulator (1.5x the least work).  Rounding P to bf16
// once moves 39% of bf16 outputs off the fp32-P result (10.6% beyond
// one bf16 ulp; causal S 1024, D 64, on the CPU); the split moves 0.22%,
// none beyond one ulp, so the limits of chip_smoke.py hold unchanged.
// Only the diagonal and window-edge tiles are masked: the softmax is
// compiled twice, and interior tiles run the copy with no key test and
// no probability select (0.073 -> 0.052 ms at the training shape on an
// H100).  A warpgroup skips the math on a tile that is wholly masked for
// its 64 rows.  Within a warpgroup S, the softmax and P V of a tile run
// in turn; the overlap comes from the other warpgroup and, for D <= 64,
// a second CTA on the SM (four consumer warpgroups).  Issuing S of tile j + 1 beside P V of
// tile j read slower on an H100 (0.158 against 0.108 ms at the training
// shape): it spills at the two-CTA register cap.  The grid is (B * Hq,
// ceil(Sq / 128)), query tiles last-first: x launches fastest, so the
// tiles with the most keys start first on the whole card and the short
// ones fill the tail (0.107 -> 0.075 ms at the training shape on an
// H100); the KV loop runs over the tiles the causal and window `live`
// test of the Pallas kernel keeps.  cuTensorMapEncodeTiled comes from
// cudaGetDriverEntryPointByVersion, so the library does not link
// libcuda.  At the training shape the tensor-core work is 7.6 us at
// the bf16 peak, 11.4 us with P_lo; the softmax's expf is kept for fp32
// agreement with the reference (__expf in its place read 0.081 against
// 0.107 ms before the grid order changed).
//
// fp32: CUDA cores (the tensor cores have no fp32 mode, and TF32 would
// miss the fp32 limits; fp32 only runs the parity reference).  One
// 128-thread block owns a BQ = 64-row query tile of one (b, h) and loops
// over the KV tiles itself; the grid is (ceil(Sq / BQ), B * Hq), query
// tiles last-first.  The tiles sit in shared memory as Q^T and K^T (so a
// thread reads 4 query rows and 2 x 4 keys as float4s), then V in K's
// place, and P^T.  Each thread computes a 4 x 8 block of the 64 x 64
// score tile with FMAs; the 8 threads that share 4 rows reduce their row
// max and row sum with shuffles and each keeps those 4 rows' (m, l) and a
// 4 x D/8 block of the accumulator in registers.
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

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

// ---- bf16: wgmma + TMA ------------------------------------------------------

namespace tc {

using namespace apex::hopper;

constexpr int kBQ = 128;         // query rows per CTA: two warpgroups of 64
constexpr int kBK = 64;          // keys per K/V tile
constexpr int kConsumers = 256;  // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;  // and one producer warp

// Shared-memory layout for head dim D: Q and the K/V tiles in swizzle
// atoms of SwizzleAtom<D> (hopper.cuh).
template <int D>
struct Cfg : SwizzleAtom<D> {
  using SwizzleAtom<D>::kRowBytes;
  static constexpr int kQAtom = kBQ * kRowBytes;   // bytes of one Q atom
  static constexpr int kKVAtom = kBK * kRowBytes;  // bytes of one K/V atom
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kKVBytes = kBK * D * 2;     // one K or V tile
  static constexpr int kStages = D > 128 ? 2 : 3;  // K/V ring depth
  // P V: one m64nDk16 product up to D = 128, else kPvParts of N = 128
  static constexpr int kPvN = D < 128 ? D : 128;
  static constexpr int kPvParts = D / kPvN;
  // Q, then K[stage], then V[stage]; + 1 KB to align the base to the
  // 1024-byte period of the 128 B swizzle
  static constexpr int kSmem = kQBytes + 2 * kStages * kKVBytes + 1024;
};

// Two CTAs per SM for D <= 64 (registers capped near 112 a thread), one
// for D = 128 and 256.
template <int D>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 2 : 1)
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                                 const __grid_constant__ CUtensorMap map_k,
                                 const __grid_constant__ CUtensorMap map_v,
                                 __nv_bfloat16* __restrict__ out,
                                 float* __restrict__ lse, int sq, int skv,
                                 int hq, int group, int q_offset, int causal,
                                 int window, float scale) {
  using C = Cfg<D>;
  constexpr int kStages = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_q;
  __shared__ __align__(8) uint64_t bar_full[kStages];
  __shared__ __align__(8) uint64_t bar_empty[kStages];
  uint8_t* s_q = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* s_k = s_q + C::kQBytes;               // [kStages][kKVBytes]
  uint8_t* s_v = s_k + kStages * C::kKVBytes;    // [kStages][kKVBytes]

  // x runs fastest in launch order: every (b, h)'s longest causal rows
  // start first, and the short tiles fill in behind them
  const int q_tile = gridDim.y - 1 - blockIdx.y;
  const int bh = blockIdx.x;
  const int b = bh / hq;
  const int h = bh - b * hq;
  const int kvh = h / group;
  const int q0 = q_tile * kBQ;

  // KV range any row of this tile can see: the `live` test as bounds
  const int q_last = min(q0 + kBQ, sq) - 1;
  int k_end = skv;
  if (causal) k_end = min(k_end, q_offset + q_last + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_offset + q0 - window + 1);
  const int kt0 = (k_begin / kBK) * kBK;
  const int n_tiles = k_end > kt0 ? (k_end - kt0 + kBK - 1) / kBK : 0;

  if (threadIdx.x == 0) {
    mbar_init(&bar_q, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bar_full[s], 1);
      mbar_init(&bar_empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // producer: lane 0 of the last warp issues every copy
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(&bar_q, C::kQBytes);
#pragma unroll
      for (int a = 0; a < C::kAtoms; ++a) {
        tma_load(s_q + a * C::kQAtom, &map_q, &bar_q, a * C::kAtomCols, h,
                 q0, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int stage = i % kStages;
        const int k0 = kt0 + i * kBK;
        mbar_wait(&bar_empty[stage], ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(&bar_full[stage], 2 * C::kKVBytes);
        uint8_t* dk = s_k + stage * C::kKVBytes;
        uint8_t* dv = s_v + stage * C::kKVBytes;
#pragma unroll
        for (int a = 0; a < C::kAtoms; ++a) {
          tma_load(dk + a * C::kKVAtom, &map_k, &bar_full[stage],
                   a * C::kAtomCols, kvh, k0, b);
          tma_load(dv + a * C::kKVAtom, &map_v, &bar_full[stage],
                   a * C::kAtomCols, kvh, k0, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the tile; a
  // thread holds rows r0 and r0 + 8 of them (the wgmma fragment), in each
  // 8-column group the two columns cq, cq + 1
  const int wg = threadIdx.x >> 7;
  const int t = threadIdx.x & 127;
  const int r0 = 16 * (t >> 5) + ((t & 31) >> 2);
  const int cq = 2 * (t & 3);
  const int pos_lo = q_offset + q0 + 64 * wg;   // position of row 0
  const int pos_hi = pos_lo + 63;
  const int pos[2] = {pos_lo + r0, pos_lo + r0 + 8};
  const uint32_t q_addr = smem_u32(s_q) + wg * 64 * C::kRowBytes;
  constexpr uint32_t kSbo = 8 * C::kRowBytes;  // next group of 8 rows

  // the m64nDk16 accumulator fragment, by P V part: element e of the
  // whole is o[e / kPart][e % kPart], the part's own fragment element
  constexpr int kPart = C::kPvN / 2;
  float o[C::kPvParts][kPart];
  auto o_at = [&](int e) -> float& { return o[e / kPart][e % kPart]; };
#pragma unroll
  for (int e = 0; e < D / 2; ++e) o_at(e) = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  mbar_wait(&bar_q, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int stage = i % kStages;
    const int k0 = kt0 + i * kBK;
    mbar_wait(&bar_full[stage], (i / kStages) & 1);
    // the whole tile is masked for these 64 rows: nothing to add
    const bool skip = (causal && k0 > pos_hi) ||
                      (window > 0 && k0 + kBK - 1 <= pos_lo - window);
    if (!skip) {
      const uint32_t k_addr = smem_u32(s_k + stage * C::kKVBytes);
      const uint32_t v_addr = smem_u32(s_v + stage * C::kKVBytes);
      float s[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        // 16 columns of D: atom ks * 16 / kAtomCols, 32 bytes per step
        const uint32_t col = (ks * 16) / C::kAtomCols;
        const uint32_t within = ((ks * 16) % C::kAtomCols) * 2;
        wgmma_ss_n64(
            s, make_desc(q_addr + col * C::kQAtom + within, 16, kSbo,
                         C::kLayout),
            make_desc(k_addr + col * C::kKVAtom + within, 16, kSbo,
                      C::kLayout),
            ks > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // s[4 c + 2 hh + j]: row r0 + 8 hh, key k0 + 8 c + cq + j.  Only a
      // tile the causal or window mask cuts (or the ragged end) tests
      // keys: the softmax is compiled twice, with and without the mask.
      float corr[2];
      auto softmax = [&](auto masked) {
        uint32_t valid = 0xffffffffu;
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int c = 0; c < 8; ++c) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int e = 4 * c + 2 * hh + j;
              float x = s[e] * scale;
              if constexpr (decltype(masked)::value) {
                const int key = k0 + 8 * c + cq + j;
                const bool ok = key < skv &&
                                (!causal || key <= pos[hh]) &&
                                (window <= 0 || key > pos[hh] - window);
                if (!ok) {
                  x = kNegInf;
                  valid &= ~(1u << e);
                }
              }
              s[e] = x;
              mx[hh] = fmaxf(mx[hh], x);
            }
          }
        }
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          // the 4 threads of a quad hold the same two rows
          mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
          mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
          const float m_new = fmaxf(m[hh], mx[hh]);
          corr[hh] = expf(m[hh] - m_new);
          m[hh] = m_new;
        }
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int hh = (e >> 1) & 1;
          float p = expf(s[e] - m[hh]);
          if constexpr (decltype(masked)::value) {
            p = (valid >> e) & 1u ? p : 0.f;
          }
          s[e] = p;
          rs[hh] += p;
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 1);
          rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 2);
          l[hh] = l[hh] * corr[hh] + rs[hh];
        }
      };
      if (k0 + kBK > skv || (causal && k0 + kBK - 1 > pos_lo) ||
          (window > 0 && k0 <= pos_hi - window)) {
        softmax(std::true_type{});
      } else {
        softmax(std::false_type{});
      }
#pragma unroll
      for (int e = 0; e < D / 2; ++e) o_at(e) *= corr[(e >> 1) & 1];

      // P as the A fragments of 4 k16 steps, split into bf16 hi + lo
      uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float x0 = s[8 * kk + 2 * r];
          const float x1 = s[8 * kk + 2 * r + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
          const float2 back = __bfloat1622float2(hi);
          p_hi[kk][r] = *reinterpret_cast<const uint32_t*>(&hi);
          p_lo[kk][r] = pack_bf16(x0 - back.x, x1 - back.y);
        }
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int part = 0; part < C::kPvParts; ++part) {
          // keys 16 kk .. 16 kk + 15 are rows of V; N = kPvN columns of
          // it, from atom part * kPvN / kAtomCols, span the atoms
          const uint64_t dv = make_desc(
              v_addr + (part * C::kPvN / C::kAtomCols) * C::kKVAtom +
                  kk * 16 * C::kRowBytes,
              C::kKVAtom, kSbo, C::kLayout);
          wgmma_rs(o[part], p_hi[kk], dv);
          wgmma_rs(o[part], p_lo[kk], dv);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int part = 0; part < C::kPvParts; ++part) fence_regs(o[part]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        fence_regs(p_hi[kk]);
        fence_regs(p_lo[kk]);
      }
    }
    mbar_arrive(&bar_empty[stage]);
  }

  const size_t q_pitch = static_cast<size_t>(hq) * D;
  __nv_bfloat16* ob = out + static_cast<size_t>(b) * sq * q_pitch + h * D;
  float* lb = lse + static_cast<size_t>(bh) * sq;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + 64 * wg + r0 + 8 * hh;
    if (row < sq) {
      const float l_safe = fmaxf(l[hh], 1e-30f);
      const float inv = 1.0f / l_safe;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        *reinterpret_cast<__nv_bfloat162*>(
            ob + static_cast<size_t>(row) * q_pitch + 8 * c + cq) =
            __floats2bfloat162_rn(o_at(4 * c + 2 * hh) * inv,
                                  o_at(4 * c + 2 * hh + 1) * inv);
      }
      if ((t & 3) == 0) lb[row] = m[hh] + logf(l_safe);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int batch, int sq, int skv, int hq, int hkv, int q_offset,
           int causal, int window, float scale, cudaStream_t stream) {
  CUtensorMap map_q, map_k, map_v;
  int err = encode<D>(&map_q, q, hq, sq, batch, kBQ);
  if (err == 0) err = encode<D>(&map_k, k, hkv, skv, batch, kBK);
  if (err == 0) err = encode<D>(&map_v, v, hkv, skv, batch, kBK);
  if (err != 0) return err;
  constexpr int bytes = Cfg<D>::kSmem;
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(batch * hq, (sq + kBQ - 1) / kBQ);
  flash_attention_wgmma_kernel<D><<<grid, kThreads, bytes, stream>>>(
      map_q, map_k, map_v, static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), sq, skv, hq, hq / hkv, q_offset, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc


template <int D>
int launch_dtype(int dtype, const void* q, const void* k, const void* v,
                 void* out, void* lse, int batch, int sq, int skv, int hq,
                 int hkv, int q_offset, int causal, int window, float scale,
                 cudaStream_t stream) {
  if (dtype == apex::kFloat32) {
    return launch<float, D>(q, k, v, out, lse, batch, sq, skv, hq, hkv,
                            q_offset, causal, window, scale, stream);
  }
  return tc::launch<D>(q, k, v, out, lse, batch, sq, skv, hq, hkv, q_offset,
                       causal, window, scale, stream);
}

int launch_dim(int head_dim, int dtype, const void* q, const void* k,
               const void* v, void* out, void* lse, int batch, int sq,
               int skv, int hq, int hkv, int q_offset, int causal, int window,
               float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch_dtype<16>(dtype, q, k, v, out, lse, batch, sq, skv, hq,
                              hkv, q_offset, causal, window, scale, stream);
    case 32:
      return launch_dtype<32>(dtype, q, k, v, out, lse, batch, sq, skv, hq,
                              hkv, q_offset, causal, window, scale, stream);
    case 64:
      return launch_dtype<64>(dtype, q, k, v, out, lse, batch, sq, skv, hq,
                              hkv, q_offset, causal, window, scale, stream);
    case 128:
      return launch_dtype<128>(dtype, q, k, v, out, lse, batch, sq, skv, hq,
                               hkv, q_offset, causal, window, scale, stream);
    case 256:
      return launch_dtype<256>(dtype, q, k, v, out, lse, batch, sq, skv, hq,
                               hkv, q_offset, causal, window, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, out: (batch, sq, hq, D); k, v: (batch, skv, hkv, D); lse: (batch, hq,
// sq) fp32.  All contiguous; q/k/v/out of one dtype, fp32 (CUDA cores) or
// bf16 (wgmma + TMA: q, k and v 16-byte aligned).  D is 16, 32, 64, 128
// or 256; hq is a multiple of hkv with hq / hkv in 1..8; sq, skv >= 1;
// batch * hq <= 65535 and, for bf16, ceil(sq / 128) <= 65535; window <= 0
// means none.  Returns cudaGetLastError()
// after the launch, or tc::kTensorMapError + the CUresult of a failed
// tensor-map encode.
extern "C" int apex_flash_attention(const void* q, const void* k,
                                    const void* v, void* out, void* lse,
                                    int batch, int sq, int skv, int hq,
                                    int hkv, int head_dim, int q_offset,
                                    int causal, int window, int dtype,
                                    float scale, void* stream) {
  if (hkv < 1 || hq % hkv != 0 || hq / hkv > 8 || sq < 1 || skv < 1 ||
      batch < 1 || batch * hq > 65535 ||
      (dtype != apex::kFloat32 && dtype != apex::kBFloat16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_dim(head_dim, dtype, q, k, v, out, lse, batch, sq, skv, hq,
                    hkv, q_offset, causal, window, scale,
                    static_cast<cudaStream_t>(stream));
}
