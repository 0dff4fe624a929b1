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
// softmax state in VMEM scratch across grid steps.  CUDA blocks run in no
// order, and one block per (kv head, sequence) leaves most of the card
// idle (8 blocks on 132 SMs for qwen2-0.5b at batch 4), so the cache is
// split (flash-decoding): the grid is (splits, Hkv, B) and block s takes
// slots [s * span, (s + 1) * span) of its (b, kv head); the wrapper picks
// span and splits from Smax and the SM count.  A block whose span starts
// at or past lengths[b] exits at once.  Inside a block 4 warps take every
// 4th tile of 32 slots.  Per tile a lane owns one slot: it reads that
// slot's K row with 16-byte loads, and the V rows it will need, before
// any arithmetic, so both loads are in flight together; it forms the q.k
// dot products for all `group` heads against the query panel in shared
// memory (every lane reads the same address: a broadcast).  The tile's max
// is one warp reduction per head; each lane keeps a partial softmax sum.
// For p @ V a lane owns one 16-byte column chunk of a subset of the
// tile's rows (the weights come through shared memory), and the rows'
// partial sums meet by shuffles at the end.  The 4 warp states merge
// through shared memory, rescaled by exp(m_w - M).  A span that is the
// only live one for its row writes the output; otherwise the block
// writes its (m, l, acc) to an fp32 workspace, and the last block of the
// (b, kv head) to finish, found by a ticket (atomicAdd on a per-(b, kv
// head) counter after __threadfence), merges the live spans with the LSE
// rule exp(m_s - M) and resets the counter to 0: one launch per call.  A
// span with no valid slot has m = -1e30 and l = 0 and adds 0.  Where the
// caller passes `lse`, the block that writes a row's output also writes
// its log-sum-exp M + log L (-1e30 where L = 0): ranks that each attend
// over their own shard of a sequence-sharded cache merge their outputs by
// it (parallel/sp_decode.py), so the kernel serves that path too.
//
// This header holds the kernel and its launcher; decode_attention.cu has
// the C entry point and the instances of head dims 64 and 128,
// decode_attention_d256_{f32,bf16}.cu those of head dim 256,
// decode_attention_d512.cu the group-1 ones of head dim 512, and
// decode_attention_fp8.cu the instance over e4m3 caches (bf16 q and
// output, head dim 128; the cache type TK is a template parameter of its
// own, read 16 values a load and converted in registers): nvcc builds
// the five in parallel (the D = 256 instances, fully unrolled over 8
// groups, took 80 of the 121 s of one file's build on an H100 host).
#pragma once

#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;          // slots per warp tile
constexpr int kMaxGroup = 8;
constexpr int kMaxSplits = 64;
constexpr float kNegInf = -1e30f;

// 16 bytes of a row as floats: 4 fp32 or 8 bf16 values.
__device__ __forceinline__ void unpack16(const uint4& x, float (&o)[4]) {
  o[0] = __uint_as_float(x.x);
  o[1] = __uint_as_float(x.y);
  o[2] = __uint_as_float(x.z);
  o[3] = __uint_as_float(x.w);
}
__device__ __forceinline__ void unpack16(const uint4& x, float (&o)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// ... or 16 e4m3 values: Hopper's packed cvt, e4m3x2 -> f16x2, then to
// float; both steps are exact.
__device__ __forceinline__ void unpack16(const uint4& x, float (&o)[16]) {
  const __nv_fp8x2_storage_t* p =
      reinterpret_cast<const __nv_fp8x2_storage_t*>(&x);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float2 f =
        __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(p[i], __NV_E4M3)));
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 load16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

// ws: the workspace of the split grid, fp32, [B][hkv][splits] blocks of
// group * D accumulator values, then as many (group) maxima, then sums.
// G = group, the query heads of a kv head, is a template parameter: the
// loops over heads unroll without branches.  T is the type of q and the
// output, TK that of the K/V cache.
template <typename T, int D, int G, typename TK = T>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const T* __restrict__ q, const TK* __restrict__ k,
                            const TK* __restrict__ v,
                            const int* __restrict__ lengths,
                            T* __restrict__ out, float* __restrict__ ws,
                            int* __restrict__ tickets,
                            float* __restrict__ lse, int smax, int hkv,
                            int span, float scale) {
  constexpr int kVec = 16 / sizeof(TK);     // elements per 16-byte load
  constexpr int kChunks = D / kVec;         // 16-byte chunks of a row
  // In P V a lane owns kOwn chunks of a row, kLanes chunks apart: one
  // chunk, except above 32 chunks (fp32 D = 256: two per lane; D = 512:
  // bf16 two, fp32 four).
  constexpr int kOwn = kChunks > 32 ? kChunks / 32 : 1;
  constexpr int kLanes = kChunks / kOwn;    // lanes that cover a row
  constexpr int kSub = 32 / kLanes;         // lanes sharing a chunk in P V
  constexpr int kRowsPV = kTile / kSub;     // V rows of a tile per lane
  // q . k reads the K row in passes of kPass chunks: the whole row up to
  // 32 chunks (128 registers); at D >= 256, where the accumulators take
  // 8 G registers or more, 16 chunks a pass
  constexpr int kPass = kChunks < 32 ? kChunks : (D > 128 ? 16 : 32);
  // V rows are loaded with the K row where both fit in 128 registers
  // (D <= 64, and bf16 D = 128; the others load them as they multiply)
  constexpr bool kEarlyV = kRowsPV * kOwn + kChunks <= 32;
  static_assert(!kEarlyV || kOwn == 1, "early V loads take one chunk");
  __shared__ float sm_q[G][D];
  __shared__ float sm_p[kWarps][G][kTile];
  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  // The warps' accumulators, then (once they are merged, past a
  // __syncthreads) the spans' weights and sums of the combine: at G = 8,
  // D = 256 the two apart would pass the 48 KB of static shared memory.
  __shared__ float sm_acc_raw[kWarps * G * D > 2 * kMaxSplits * G
                                  ? kWarps * G * D
                                  : 2 * kMaxSplits * G];
  auto& sm_acc = *reinterpret_cast<float(*)[kWarps][G][D]>(sm_acc_raw);
  // m, then exp(m - M); and l
  auto& sm_w = *reinterpret_cast<float(*)[kMaxSplits][G]>(sm_acc_raw);
  auto& sm_ls = *reinterpret_cast<float(*)[kMaxSplits][G]>(
      sm_acc_raw + kMaxSplits * G);
  __shared__ float sm_lsum[G];
  __shared__ int sm_last;

  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int splits = gridDim.x;
  int n = lengths[b];
  n = n < 0 ? 0 : (n > smax ? smax : n);
  const int live = n > span ? (n + span - 1) / span : 1;
  if (split >= live) return;
  const int lo = split * span;
  const int hi = min(lo + span, n);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int chunk = lane % kLanes;
  const int sub = lane / kLanes;
  const int hq = hkv * G;

  const T* qb = q + (static_cast<size_t>(b) * hq + h * G) * D;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    sm_q[i / D][i % D] = apex::to_float(qb[i]);
  }
  __syncthreads();

  float m[G];    // running max, the same in every lane of a warp
  float l[G];    // this lane's share of the softmax denominator
  // chunks chunk + o * kLanes (o < kOwn) of rows sub, sub + kSub, ...
  float acc[G][kOwn * kVec];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kOwn * kVec; ++e) acc[g][e] = 0.f;
  }

  // consecutive slots of one (b, h) are hkv * D elements apart
  const size_t slot_stride = static_cast<size_t>(hkv) * D;
  const TK* kb = k + (static_cast<size_t>(b) * smax * hkv + h) * D;
  const TK* vb = v + (static_cast<size_t>(b) * smax * hkv + h) * D;

  for (int t0 = lo + warp * kTile; t0 < hi; t0 += kWarps * kTile) {
    const bool live_slot = t0 + lane < hi;
    const TK* kr = kb + static_cast<size_t>(t0 + lane) * slot_stride;
    uint4 kraw[kPass];
    uint4 vraw[kEarlyV ? kRowsPV * kOwn : 1];
    if (live_slot) {
#pragma unroll
      for (int c = 0; c < kPass; ++c) kraw[c] = load16(kr + c * kVec);
    }
    // chunk `chunk + o * kLanes` of V row `sub + r * kSub` of the tile
    auto load_v = [&](int r, int o) {
      const int slot = t0 + sub + r * kSub;
      const TK* vr = vb + static_cast<size_t>(slot) * slot_stride;
      return slot < hi ? load16(vr + (chunk + o * kLanes) * kVec)
                       : make_uint4(0, 0, 0, 0);
    };
    if constexpr (kEarlyV) {
#pragma unroll
      for (int r = 0; r < kRowsPV; ++r) vraw[r] = load_v(r, 0);
    }

    float sc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) sc[g] = 0.f;
    if (live_slot) {
#pragma unroll
      for (int c0 = 0; c0 < kChunks; c0 += kPass) {
        if (c0 > 0) {
#pragma unroll
          for (int c = 0; c < kPass; ++c) {
            kraw[c] = load16(kr + (c0 + c) * kVec);
          }
        }
#pragma unroll
        for (int c = 0; c < kPass; ++c) {
          float kv[kVec];
          unpack16(kraw[c], kv);
#pragma unroll
          for (int g = 0; g < G; ++g) {
#pragma unroll
            for (int j = 0; j < kVec; ++j) {
              sc[g] += sm_q[g][(c0 + c) * kVec + j] * kv[j];
            }
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float s = live_slot ? sc[g] * scale : kNegInf;
      const float m_new = fmaxf(m[g], warp_max(s));
      const float corr = expf(m[g] - m_new);
      const float p = live_slot ? expf(s - m_new) : 0.f;
      l[g] = l[g] * corr + p;
#pragma unroll
      for (int e = 0; e < kOwn * kVec; ++e) acc[g][e] *= corr;
      m[g] = m_new;
      sm_p[warp][g][lane] = p;
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kRowsPV; ++r) {
      const int j = sub + r * kSub;
#pragma unroll
      for (int o = 0; o < kOwn; ++o) {
        uint4 raw;
        if constexpr (kEarlyV) {
          raw = vraw[r];
        } else {
          raw = load_v(r, o);
        }
        float vv[kVec];
        unpack16(raw, vv);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pj = sm_p[warp][g][j];
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[g][o * kVec + e] += pj * vv[e];
        }
      }
    }
    __syncwarp();  // sm_p is rewritten by the next tile
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int e = 0; e < kOwn * kVec; ++e) {
#pragma unroll
      for (int off = kLanes; off < 32; off <<= 1) {
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
      }
    }
    const float lw = apex::warp_sum(l[g]);
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = lw;
    }
    if (sub == 0) {
#pragma unroll
      for (int o = 0; o < kOwn; ++o) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          sm_acc[warp][g][(chunk + o * kLanes) * kVec + e] =
              acc[g][o * kVec + e];
        }
      }
    }
  }
  __syncthreads();

  // merge the warps: this span's (m, l, acc)
  const size_t row = static_cast<size_t>(b) * hkv + h;   // (b, kv head)
  const size_t part = row * splits + split;
  const size_t n_parts = static_cast<size_t>(gridDim.z) * hkv * splits;
  float* ws_acc = ws;
  float* ws_m = ws + n_parts * G * D;
  float* ws_l = ws_m + n_parts * G;
  T* ob = out + (static_cast<size_t>(b) * hq + h * G) * D;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
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
    if (live == 1) {
      ob[i] = apex::from_float<T>(a / fmaxf(lsum, 1e-30f));
      if (lse != nullptr && d == 0) {
        lse[static_cast<size_t>(b) * hq + h * G + g] =
            lsum > 0.f ? mx + logf(lsum) : kNegInf;
      }
    } else {
      ws_acc[part * G * D + i] = a;
      if (d == 0) {
        ws_m[part * G + g] = mx;
        ws_l[part * G + g] = lsum;
      }
    }
  }
  if (live == 1) return;

  // the last live span of this (b, kv head) to finish combines them all;
  // past these barriers sm_acc is dead and its storage holds sm_w, sm_ls
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    sm_last = atomicAdd(&tickets[row], 1) == live - 1;
  }
  __syncthreads();
  if (!sm_last) return;
  __threadfence();
  // L2 reads (__ldcg: other SMs wrote them), many in flight at a time
  const size_t first = row * splits;
  for (int i = threadIdx.x; i < live * G; i += kThreads) {
    sm_w[i / G][i % G] = __ldcg(&ws_m[first * G + i]);
    sm_ls[i / G][i % G] = __ldcg(&ws_l[first * G + i]);
  }
  __syncthreads();
  for (int g = warp; g < G; g += kWarps) {   // a warp per head
    float mx = kNegInf;
    for (int s = lane; s < live; s += 32) mx = fmaxf(mx, sm_w[s][g]);
    mx = warp_max(mx);
    float lsum = 0.f;
    for (int s = lane; s < live; s += 32) {
      const float c = expf(sm_w[s][g] - mx);
      sm_w[s][g] = c;
      lsum += sm_ls[s][g] * c;
    }
    lsum = apex::warp_sum(lsum);
    if (lane == 0) {
      sm_lsum[g] = lsum;
      if (lse != nullptr) {
        lse[static_cast<size_t>(b) * hq + h * G + g] =
            lsum > 0.f ? mx + logf(lsum) : kNegInf;
      }
    }
  }
  __syncthreads();
  // 16-byte loads, 16 spans in flight per thread
  const float4* part_acc =
      reinterpret_cast<const float4*>(ws_acc + first * G * D);
  constexpr int kCols = G * D / 4;
  constexpr int kUnroll = 16;
  for (int c = threadIdx.x; c < kCols; c += kThreads) {
    const int g = (4 * c) / D;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < live; s0 += kUnroll) {
      float4 x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        x[u] = s0 + u < live
                   ? __ldcg(&part_acc[static_cast<size_t>(s0 + u) * kCols + c])
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float w =
            s0 + u < live ? sm_w[min(s0 + u, kMaxSplits - 1)][g] : 0.f;
        a.x += w * x[u].x;
        a.y += w * x[u].y;
        a.z += w * x[u].z;
        a.w += w * x[u].w;
      }
    }
    const float l_safe = fmaxf(sm_lsum[g], 1e-30f);
    T* o = ob + 4 * c;
    o[0] = apex::from_float<T>(a.x / l_safe);
    o[1] = apex::from_float<T>(a.y / l_safe);
    o[2] = apex::from_float<T>(a.z / l_safe);
    o[3] = apex::from_float<T>(a.w / l_safe);
  }
  if (threadIdx.x == 0) tickets[row] = 0;
}

template <typename T, int D, int G, typename TK = T>
void launch_group(const void* q, const void* k, const void* v,
                  const void* lengths, void* out, void* ws, void* tickets,
                  void* lse, int batch, int hkv, int smax, int span,
                  int splits, float scale, cudaStream_t stream) {
  const dim3 grid(splits, hkv, batch);
  decode_attention_kernel<T, D, G, TK><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const TK*>(k),
      static_cast<const TK*>(v), static_cast<const int*>(lengths),
      static_cast<T*>(out), static_cast<float*>(ws),
      static_cast<int*>(tickets), static_cast<float*>(lse), smax, hkv, span,
      scale);
}

template <typename T, int D, typename TK = T>
void launch(const void* q, const void* k, const void* v, const void* lengths,
            void* out, void* ws, void* tickets, void* lse, int batch, int hkv,
            int group, int smax, int span, int splits, float scale,
            cudaStream_t stream) {
  using Fn = void (*)(const void*, const void*, const void*, const void*,
                      void*, void*, void*, void*, int, int, int, int, int,
                      float, cudaStream_t);
  constexpr Fn by_group[kMaxGroup] = {
      launch_group<T, D, 1, TK>, launch_group<T, D, 2, TK>,
      launch_group<T, D, 3, TK>, launch_group<T, D, 4, TK>,
      launch_group<T, D, 5, TK>, launch_group<T, D, 6, TK>,
      launch_group<T, D, 7, TK>, launch_group<T, D, 8, TK>};
  by_group[group - 1](q, k, v, lengths, out, ws, tickets, lse, batch, hkv,
                      smax, span, splits, scale, stream);
}

}  // namespace

namespace apex {

// The head-dim-256 instances, each dtype in a translation unit of its own:
// launch<float, 256> and launch<__nv_bfloat16, 256>.
void launch_decode_d256_f32(const void* q, const void* k, const void* v,
                            const void* lengths, void* out, void* ws,
                            void* tickets, void* lse, int batch, int hkv,
                            int group, int smax, int span, int splits,
                            float scale, cudaStream_t stream);
void launch_decode_d256_bf16(const void* q, const void* k, const void* v,
                             const void* lengths, void* out, void* ws,
                             void* tickets, void* lse, int batch, int hkv,
                             int group, int smax, int span, int splits,
                             float scale, cudaStream_t stream);
// Head dim 512, group 1 only (decode_attention_d512.cu): returns
// cudaErrorInvalidValue for any other group, else 0.
int launch_decode_d512(const void* q, const void* k, const void* v,
                       const void* lengths, void* out, void* ws,
                       void* tickets, void* lse, int batch, int hkv,
                       int group, int smax, int span, int splits, bool bf16,
                       float scale, cudaStream_t stream);

}  // namespace apex

