// Decode attention at head dim 512, group 1, in fp32 and bf16: the width at
// which the simulator prices MLA's decode, (n_heads, kv_lora_rank) =
// (16, 512) for deepseek-v2-lite-16b, one query head a kv head.  Only group
// 1 is built: its block takes 11 KB of static shared memory, where group 8
// would need 86 KB, past the 48 KB a block may hold statically
// (decode_attention.cuh).
#include "decode_attention.cuh"

int apex::launch_decode_d512(const void* q, const void* k, const void* v,
                             const void* lengths, void* out, void* ws,
                             void* tickets, void* lse, int batch, int hkv,
                             int group, int smax, int span, int splits,
                             bool bf16, float scale, cudaStream_t stream) {
  if (group != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (bf16) {
    launch_group<__nv_bfloat16, 512, 1>(q, k, v, lengths, out, ws, tickets,
                                        lse, batch, hkv, smax, span, splits,
                                        scale, stream);
  } else {
    launch_group<float, 512, 1>(q, k, v, lengths, out, ws, tickets, lse,
                                batch, hkv, smax, span, splits, scale,
                                stream);
  }
  return 0;
}
