// Error text for the codes the kernels' C entry points return: a
// cudaError_t, or 100000 + the CUresult of a failed tensor-map encode
// (hopper.cuh).
#include <cuda_runtime.h>

extern "C" const char* apex_error_string(int err) {
  if (err >= 100000) {
    return "cuTensorMapEncodeTiled failed (the code less 100000 is its "
           "CUresult)";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
