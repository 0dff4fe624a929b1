// Decode attention at head dim 256 in bf16, a translation unit of its own
// so that nvcc builds it beside the others (decode_attention.cuh).
#include "decode_attention.cuh"

void apex::launch_decode_d256_bf16(const void* q, const void* k,
                                   const void* v, const void* lengths,
                                   void* out, void* ws, void* tickets,
                                   void* lse, int batch, int hkv, int group,
                                   int smax, int span, int splits, float scale,
                                   cudaStream_t stream) {
  launch<__nv_bfloat16, 256>(q, k, v, lengths, out, ws, tickets, lse,
                             batch, hkv, group, smax, span, splits, scale,
                             stream);
}
