// Decode attention: one new query token per sequence against its KV cache,
// grouped-query (GQA), for the port's serving decode step.
//
// Replaces the TPU kernel
// src/repro/kernels/decode_attention/decode_attention.py,
// decode_attention_pallas / _decode_kernel: the `group` query heads of a kv
// head form one panel, an fp32 online softmax (m, l, acc) streams over the
// cache, slots at or past lengths[b] are skipped, NEG_INF is the finite
// -1e30 and the final division clamps l at 1e-30, so a row with no valid
// slot stays finite (it yields 0, as the TPU kernel does).
//
// Bound on the H100: HBM bytes.  The work reads
// sum_b lengths[b] * Hkv * (D + Dv) * sizeof(T) bytes of cache and does
// about 4 * group flops per cache element, well under the ~295 flop/byte
// the card needs before compute limits.
//
// Design: the TPU walks KV tiles in order on one core and carries the
// softmax state in VMEM scratch across grid steps.  CUDA blocks run in
// no order, so the sequential grid axis becomes a loop inside the block:
// a (kv head, sequence) pair is one 256-thread block, and its 8 warps
// take every 8th tile of 32 slots.  Within a tile each lane owns one
// slot: it reads that slot's K row with 16-byte loads and forms the
// q.k dot products for all `group` heads against the query panel, which
// sits in shared memory (every lane reads the same address: a
// broadcast).  The tile's max is one warp reduction per head; each lane
// keeps a partial softmax sum.  For p @ V the lanes switch roles: lane
// i holds D/32 contiguous columns of the accumulator, the warp reads
// one V row per slot (one coalesced load), and the slot's weight comes
// from its owner by a shuffle.  The 8 warp states are merged through
// shared memory at the end, rescaled by exp(m_w - M).  B * Hkv blocks
// (8 for qwen2-0.5b at batch 4) leave most of the 132 SMs idle; a
// split-KV grid with an LSE combine across blocks is the redesign that
// fixes that.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxGroup = 8;
constexpr float kNegInf = -1e30f;

// 16 bytes of a row as floats: 4 fp32 or 8 bf16 values.
__device__ __forceinline__ void load16(const float* p, float (&o)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  o[0] = x.x;
  o[1] = x.y;
  o[2] = x.z;
  o[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&o)[8]) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const int* __restrict__ lengths,
                            T* __restrict__ out, int smax, int hkv, int group,
                            float scale) {
  constexpr int E = D / 32;                 // accumulator columns per lane
  constexpr int kVec = 16 / sizeof(T);      // elements per 16-byte load
  __shared__ float sm_q[kMaxGroup][D];
  __shared__ float sm_m[kWarps][kMaxGroup];
  __shared__ float sm_l[kWarps][kMaxGroup];
  __shared__ float sm_acc[kWarps][kMaxGroup][D];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int hq = hkv * group;
  int n = lengths[b];
  n = n < 0 ? 0 : (n > smax ? smax : n);

  const T* qb = q + (static_cast<size_t>(b) * hq + h * group) * D;
  for (int i = threadIdx.x; i < group * D; i += kThreads) {
    sm_q[i / D][i % D] = apex::to_float(qb[i]);
  }
  __syncthreads();

  float m[kMaxGroup];    // running max, the same in every lane of a warp
  float l[kMaxGroup];    // this lane's share of the softmax denominator
  float acc[kMaxGroup][E];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  // consecutive slots of one (b, h) are hkv * D elements apart
  const size_t slot_stride = static_cast<size_t>(hkv) * D;
  const T* kb = k + (static_cast<size_t>(b) * smax * hkv + h) * D;
  const T* vb = v + (static_cast<size_t>(b) * smax * hkv + h) * D;

  for (int t0 = warp * 32; t0 < n; t0 += kWarps * 32) {
    const bool live = t0 + lane < n;
    float sc[kMaxGroup];
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) sc[g] = 0.f;
    if (live) {
      const T* kr = kb + static_cast<size_t>(t0 + lane) * slot_stride;
#pragma unroll
      for (int c = 0; c < D; c += kVec) {
        float kv[kVec];
        load16(kr + c, kv);
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) {
          if (g < group) {
#pragma unroll
            for (int j = 0; j < kVec; ++j) sc[g] += sm_q[g][c + j] * kv[j];
          }
        }
      }
    }
    float p[kMaxGroup];
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      p[g] = 0.f;
      if (g < group) {  // uniform across the block
        const float s = live ? sc[g] * scale : kNegInf;
        const float m_new = fmaxf(m[g], warp_max(s));
        const float corr = expf(m[g] - m_new);
        p[g] = live ? expf(s - m_new) : 0.f;
        l[g] = l[g] * corr + p[g];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] *= corr;
        m[g] = m_new;
      }
    }
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      if (t0 + j < n) {  // uniform across the warp
        const T* vr = vb + static_cast<size_t>(t0 + j) * slot_stride +
                      lane * E;
        float vv[E];
#pragma unroll
        for (int e = 0; e < E; ++e) vv[e] = apex::to_float(vr[e]);
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) {
          if (g < group) {
            const float pj = __shfl_sync(0xffffffffu, p[g], j);
#pragma unroll
            for (int e = 0; e < E; ++e) acc[g][e] += pj * vv[e];
          }
        }
      }
    }
  }

#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g < group) {
      const float lw = apex::warp_sum(l[g]);
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = lw;
      }
#pragma unroll
      for (int e = 0; e < E; ++e) sm_acc[warp][g][lane * E + e] = acc[g][e];
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < group * D; i += kThreads) {
    const int g = i / D;
    const int d = i - g * D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.f;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w][g] - mx);
      lsum += sm_l[w][g] * c;
      a += sm_acc[w][g][d] * c;
    }
    out[(static_cast<size_t>(b) * hq + h * group + g) * D + d] =
        apex::from_float<T>(a / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, const void* lengths,
            void* out, int batch, int hkv, int group, int smax, float scale,
            cudaStream_t stream) {
  const dim3 grid(hkv, batch);
  decode_attention_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths),
      static_cast<T*>(out), smax, hkv, group, scale);
}

}  // namespace

// q: (batch, hkv * group, D); k, v: (batch, smax, hkv, D); lengths:
// (batch,) int32; out: (batch, hkv * group, D).  All contiguous, q/k/v/out
// of one dtype, k and v 16-byte aligned.  D is 64 or 128 and group 1..8.
// Returns
// cudaGetLastError() after the launch.
extern "C" int apex_decode_attention(const void* q, const void* k,
                                     const void* v, const void* lengths,
                                     void* out, int batch, int hkv, int group,
                                     int smax, int head_dim, int dtype,
                                     float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (group < 1 || group > kMaxGroup) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool bf16 = dtype == apex::kBFloat16;
  if (dtype != apex::kFloat32 && !bf16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (head_dim == 64) {
    if (bf16) {
      launch<__nv_bfloat16, 64>(q, k, v, lengths, out, batch, hkv, group,
                                smax, scale, s);
    } else {
      launch<float, 64>(q, k, v, lengths, out, batch, hkv, group, smax, scale,
                        s);
    }
  } else if (head_dim == 128) {
    if (bf16) {
      launch<__nv_bfloat16, 128>(q, k, v, lengths, out, batch, hkv, group,
                                 smax, scale, s);
    } else {
      launch<float, 128>(q, k, v, lengths, out, batch, hkv, group, smax,
                         scale, s);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
