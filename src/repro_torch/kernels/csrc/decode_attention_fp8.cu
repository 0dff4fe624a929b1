// Decode attention over an fp8 (e4m3) KV cache: q and the output bf16,
// k and v float8_e4m3fn, head dim 128, groups 1-8 (qwen1.5-32b's 40 q /
// 40 kv heads are group 1).  The kernel of decode_attention.cuh with the
// cache type TK = __nv_fp8_e4m3: a 16-byte load takes 16 values of a row,
// which Hopper's packed cvt turns into f16 pairs and then floats in
// registers, so the cache is read once, at one byte a value; the scores,
// softmax and accumulators are fp32 as in every instance, and the split
// plan and the in-kernel combine are those of the others.
//
// Replaces, as decode_attention.cu does, decode_attention_pallas
// (src/repro/kernels/decode_attention/decode_attention.py) after the
// reference's read-side upcast of an fp8 cache
// (src/repro/layers/attention.py, gqa_decode_step): e4m3 -> bf16 -> fp32
// loses nothing, so reading e4m3 straight into fp32 computes the same
// function.
#include "decode_attention.cuh"

// As apex_decode_attention (decode_attention.cu), with q and out bf16 and
// k, v e4m3 (one byte a value, 16-byte aligned); head_dim must be 128.
extern "C" int apex_decode_attention_fp8(const void* q, const void* k,
                                         const void* v, const void* lengths,
                                         void* out, void* ws, void* tickets,
                                         void* lse, int batch, int hkv,
                                         int group, int smax, int head_dim,
                                         int span, int splits, float scale,
                                         void* stream) {
  if (head_dim != 128 || group < 1 || group > kMaxGroup || splits < 1 ||
      splits > kMaxSplits || span < 1 ||
      static_cast<long long>(span) * splits < smax ||
      (splits > 1 && (ws == nullptr || tickets == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  launch<__nv_bfloat16, 128, __nv_fp8_e4m3>(
      q, k, v, lengths, out, ws, tickets, lse, batch, hkv, group, smax,
      span, splits, scale, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
