// Decode attention's C entry point and the instances of head dims 64 and
// 128; the kernel and its design are in decode_attention.cuh.
#include "decode_attention.cuh"

// q: (batch, hkv * group, D); k, v: (batch, smax, hkv, D); lengths:
// (batch,) int32; out: (batch, hkv * group, D).  All contiguous, q/k/v/out
// of one dtype, k and v 16-byte aligned.  D is 64, 128 or 256 with group
// 1..8, or 512 with group 1.
// The grid is (splits, hkv, batch) with span * splits >= smax and splits
// <= 64.  ws: fp32, batch * hkv * splits * group * (D + 2) values, unused
// (may be null) when splits == 1; tickets: batch * hkv int32 zeros, left
// zero.  lse: null, or fp32 (batch, hkv * group), which then receives each
// row's log-sum-exp of its scaled scores (-1e30 for a row with no valid
// slot), so that partial results over disjoint slot ranges can be merged.
// Returns cudaGetLastError() after the launch.
extern "C" int apex_decode_attention(const void* q, const void* k,
                                     const void* v, const void* lengths,
                                     void* out, void* ws, void* tickets,
                                     void* lse, int batch, int hkv,
                                     int group, int smax, int head_dim,
                                     int span, int splits, int dtype,
                                     float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (group < 1 || group > kMaxGroup || splits < 1 || splits > kMaxSplits ||
      span < 1 || static_cast<long long>(span) * splits < smax ||
      (splits > 1 && (ws == nullptr || tickets == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool bf16 = dtype == apex::kBFloat16;
  if (dtype != apex::kFloat32 && !bf16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (head_dim == 64) {
    if (bf16) {
      launch<__nv_bfloat16, 64>(q, k, v, lengths, out, ws, tickets, lse,
                                batch, hkv, group, smax, span, splits, scale,
                                s);
    } else {
      launch<float, 64>(q, k, v, lengths, out, ws, tickets, lse, batch, hkv,
                        group, smax, span, splits, scale, s);
    }
  } else if (head_dim == 128) {
    if (bf16) {
      launch<__nv_bfloat16, 128>(q, k, v, lengths, out, ws, tickets, lse,
                                 batch, hkv, group, smax, span, splits, scale,
                                 s);
    } else {
      launch<float, 128>(q, k, v, lengths, out, ws, tickets, lse, batch, hkv,
                         group, smax, span, splits, scale, s);
    }
  } else if (head_dim == 256) {
    if (bf16) {
      apex::launch_decode_d256_bf16(q, k, v, lengths, out, ws, tickets, lse,
                                    batch, hkv, group, smax, span, splits,
                                    scale, s);
    } else {
      apex::launch_decode_d256_f32(q, k, v, lengths, out, ws, tickets, lse,
                                   batch, hkv, group, smax, span, splits,
                                   scale, s);
    }
  } else if (head_dim == 512) {
    const int err = apex::launch_decode_d512(q, k, v, lengths, out, ws,
                                             tickets, lse, batch, hkv, group,
                                             smax, span, splits, bf16, scale,
                                             s);
    if (err != 0) return err;
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
