// RMSNorm over the last axis for the port's decoder layers and Mamba2
// mixers.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm/rmsnorm.py,
// rms_norm_pallas / _rmsnorm_kernel: fp32 mean of squares,
// 1/sqrt(var + eps), times the fp32 weight, cast back to x's dtype.
//
// Bound on the H100: HBM bytes.  It reads rows*d elements of x and d of w
// and writes rows*d elements, with about 4 flops per element, far below
// the ~295 flop/byte the card needs before compute limits.  At the qwen2
// training shape (4096 rows of 896 bf16) that is 14.7 MB, 4.4 us at
// 3.35 TB/s; on the decode path rows is the batch (4), so a launch moves
// ~16 KB and its time is launch latency, not bandwidth.
//
// Two kernels, picked by the wrapper's written rule (rmsnorm.py,
// `variant`; a dispatch, not a fallback):
//
// vector (d a multiple of the 16-byte vector, 16-byte aligned x, w and
// y): the row lives in registers.  A group of `warps_per_row` warps (1,
// 2, 4 or 8: the fewest that give each lane at most 8 vectors) owns a
// row, and a 256-thread block holds 8 / warps_per_row rows.  Each lane
// loads its kVecs 16-byte vectors of x (8 bf16 or 4 fp32) at once, so
// every load of the row is in flight together; the fp32 sum of squares is
// reduced by warp shuffles (and, for a group of warps, one shared-memory
// step); then the lane scales the values it still holds and stores 16
// bytes at a time.  x is read once.  kVecs is a template parameter (1-8),
// so the row stays in registers without local memory: d 896 bf16 is one
// warp of 4 vectors a lane, d 2560 two warps of 5, d 5120 four warps of
// 5.  At the training shape it takes 0.0055 ms on an H100 (F.rms_norm
// 0.0068); the first design, a 256-thread block to each row
// reading it twice with scalar loads, took 0.0096.
//
// rows (any other d or alignment): one 256-thread block owns a row and
// walks it element by element, reading it twice (the first design).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxVecs = 8;   // 16-byte vectors of the row a lane holds

// kN values of type T side by side: one load or store of kN * sizeof(T)
// bytes (two 16-byte ones for 8 fp32 weights).
template <typename T, int kN>
struct alignas(kN * sizeof(T) < 16 ? kN * sizeof(T) : 16) Pack {
  T v[kN];
};

template <typename T, int kN>
__device__ __forceinline__ void load_floats(const T* __restrict__ p,
                                            float (&out)[kN]) {
  const Pack<T, kN> r = *reinterpret_cast<const Pack<T, kN>*>(p);
#pragma unroll
  for (int i = 0; i < kN; ++i) out[i] = apex::to_float(r.v[i]);
}

template <typename T, typename W, int kVecs>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_vec_kernel(const T* __restrict__ x, const W* __restrict__ w,
                       T* __restrict__ y, long long rows, int d,
                       int warps_per_row, float eps) {
  constexpr int kN = 16 / static_cast<int>(sizeof(T));  // values a vector
  __shared__ float partial[kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int group = warp / warps_per_row;      // the block's row
  const int part = warp - group * warps_per_row;
  const long long row =
      static_cast<long long>(blockIdx.x) * (kWarps / warps_per_row) + group;
  const bool live = row < rows;
  const int nv = d / kN;
  const int stride = 32 * warps_per_row;       // vectors between a lane's
  const int v0 = part * 32 + lane;
  const T* xr = x + (live ? row : 0) * static_cast<long long>(d);

  float v[kVecs][kN];
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int vi = v0 + k * stride;
    if (live && vi < nv) {
      load_floats<T, kN>(xr + vi * kN, v[k]);
    } else {
#pragma unroll
      for (int i = 0; i < kN; ++i) v[k][i] = 0.f;
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
#pragma unroll
    for (int i = 0; i < kN; ++i) ss += v[k][i] * v[k][i];
  }
  ss = apex::warp_sum(ss);
  if (warps_per_row > 1) {           // the same for the whole block
    if (lane == 0) partial[warp] = ss;
    __syncthreads();
    ss = 0.f;
    for (int i = 0; i < warps_per_row; ++i) {
      ss += partial[group * warps_per_row + i];
    }
  }
  if (!live) return;
  const float inv = 1.0f / sqrtf(ss / static_cast<float>(d) + eps);
  T* yr = y + row * static_cast<long long>(d);
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int vi = v0 + k * stride;
    if (vi < nv) {
      float wv[kN];
      load_floats<W, kN>(w + vi * kN, wv);
      Pack<T, kN> out;
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        out.v[i] = apex::from_float<T>(v[k][i] * inv * wv[i]);
      }
      *reinterpret_cast<Pack<T, kN>*>(yr + vi * kN) = out;
    }
  }
}

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_rows_kernel(const T* __restrict__ x, const W* __restrict__ w,
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

template <typename T, typename W, int kVecs>
void launch_vec(const void* x, const void* w, void* y, long long rows, int d,
                int warps_per_row, float eps, cudaStream_t stream) {
  const long long per_block = kWarps / warps_per_row;
  const unsigned blocks =
      static_cast<unsigned>((rows + per_block - 1) / per_block);
  rmsnorm_vec_kernel<T, W, kVecs><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<T*>(y),
      rows, d, warps_per_row, eps);
}

// warps_per_row 0: the rows kernel; else the vector kernel with `vecs`
// 16-byte vectors a lane.
template <typename T, typename W>
int launch(const void* x, const void* w, void* y, long long rows, int d,
           float eps, int warps_per_row, int vecs, cudaStream_t stream) {
  if (warps_per_row == 0) {
    rmsnorm_rows_kernel<T, W><<<static_cast<unsigned>(rows), kThreads, 0,
                                stream>>>(
        static_cast<const T*>(x), static_cast<const W*>(w),
        static_cast<T*>(y), d, eps);
    return static_cast<int>(cudaGetLastError());
  }
  constexpr int kN = 16 / static_cast<int>(sizeof(T));
  const bool ok = (warps_per_row == 1 || warps_per_row == 2 ||
                   warps_per_row == 4 || warps_per_row == 8) &&
                  vecs >= 1 && vecs <= kMaxVecs && d % kN == 0 &&
                  static_cast<long long>(vecs) * 32 * warps_per_row * kN >= d;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  using Fn = void (*)(const void*, const void*, void*, long long, int, int,
                     float, cudaStream_t);
  constexpr Fn kLaunch[kMaxVecs] = {
      launch_vec<T, W, 1>, launch_vec<T, W, 2>, launch_vec<T, W, 3>,
      launch_vec<T, W, 4>, launch_vec<T, W, 5>, launch_vec<T, W, 6>,
      launch_vec<T, W, 7>, launch_vec<T, W, 8>};
  kLaunch[vecs - 1](x, w, y, rows, d, warps_per_row, eps, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: (rows, d) contiguous, dtype x_dtype; w: (d,) contiguous, dtype
// w_dtype.  warps_per_row 0 launches the rows kernel; 1, 2, 4 or 8 the
// vector kernel with `vecs` (1-8) 16-byte vectors a lane, which needs d a
// multiple of the vector, vecs * 32 * warps_per_row vectors >= the row
// and x, w, y 16-byte aligned.  Returns cudaGetLastError() after the
// launch.
extern "C" int apex_rmsnorm(const void* x, const void* w, void* y,
                            long long rows, int d, float eps, int x_dtype,
                            int w_dtype, int warps_per_row, int vecs,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using apex::kBFloat16;
  using apex::kFloat32;
  if (x_dtype == kFloat32 && w_dtype == kFloat32) {
    return launch<float, float>(x, w, y, rows, d, eps, warps_per_row, vecs,
                                s);
  }
  if (x_dtype == kFloat32 && w_dtype == kBFloat16) {
    return launch<float, __nv_bfloat16>(x, w, y, rows, d, eps, warps_per_row,
                                        vecs, s);
  }
  if (x_dtype == kBFloat16 && w_dtype == kFloat32) {
    return launch<__nv_bfloat16, float>(x, w, y, rows, d, eps, warps_per_row,
                                        vecs, s);
  }
  if (x_dtype == kBFloat16 && w_dtype == kBFloat16) {
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, y, rows, d, eps,
                                                warps_per_row, vecs, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
