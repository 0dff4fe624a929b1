// RMSNorm over the last axis for the port's decoder layers.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm/rmsnorm.py,
// rms_norm_pallas / _rmsnorm_kernel: fp32 mean of squares,
// 1/sqrt(var + eps), times the fp32 weight, cast back to x's dtype.
//
// Bound on the H100: HBM bytes.  It reads rows*d elements of x and d of w
// and writes rows*d elements, with about 4 flops per element, far below
// the ~295 flop/byte the card needs before compute limits.  On the
// decode path rows is the batch (4), so a launch moves ~16 KB and its
// time is launch latency, not bandwidth.
//
// Design: the TPU tiles rows into 256-row VMEM panels with d resident.
// Here one 256-thread block owns a row: the fp32 sum of squares is reduced
// by warp shuffles, then one shared-memory step across the 8 warps; the
// second pass re-reads the row, which is then in L1/L2, scales it and
// stores it.  A warp per row was measured too and lost at every d and
// row count the models use (chip_smoke.py shapes; see PERF.md): a lane of
// a warp per row makes d/32 loads per pass, a thread of a block d/256, and
// at these sizes the time is the latency of those rounds of loads.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const T* __restrict__ x, const W* __restrict__ w,
                   T* __restrict__ y, int d, float eps) {
  __shared__ float partial[kWarps];
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = apex::to_float(xr[i]);
    ss += v * v;
  }
  ss = apex::warp_sum(ss);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) total += partial[i];
  const float inv = 1.0f / sqrtf(total / static_cast<float>(d) + eps);
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = apex::to_float(xr[i]) * inv;
    yr[i] = apex::from_float<T>(v * apex::to_float(w[i]));
  }
}

template <typename T, typename W>
void launch(const void* x, const void* w, void* y, long long rows, int d,
            float eps, cudaStream_t stream) {
  rmsnorm_kernel<T, W><<<static_cast<unsigned>(rows), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<T*>(y),
      d, eps);
}

}  // namespace

// x, y: (rows, d) contiguous, dtype x_dtype; w: (d,) contiguous, dtype
// w_dtype.  Returns cudaGetLastError() after the launch.
extern "C" int apex_rmsnorm(const void* x, const void* w, void* y,
                            long long rows, int d, float eps, int x_dtype,
                            int w_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using apex::kBFloat16;
  using apex::kFloat32;
  if (x_dtype == kFloat32 && w_dtype == kFloat32) {
    launch<float, float>(x, w, y, rows, d, eps, s);
  } else if (x_dtype == kFloat32 && w_dtype == kBFloat16) {
    launch<float, __nv_bfloat16>(x, w, y, rows, d, eps, s);
  } else if (x_dtype == kBFloat16 && w_dtype == kFloat32) {
    launch<__nv_bfloat16, float>(x, w, y, rows, d, eps, s);
  } else if (x_dtype == kBFloat16 && w_dtype == kBFloat16) {
    launch<__nv_bfloat16, __nv_bfloat16>(x, w, y, rows, d, eps, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
