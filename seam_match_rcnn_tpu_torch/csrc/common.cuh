// Shared includes and helpers of the hand-written Hopper kernels.
//
// Every kernel library entry point has a plain C interface (pointers,
// ints, floats and the CUDA stream as a void*), launches on the caller's
// stream, allocates nothing, and returns cudaGetLastError() right after its
// launch so that a refused launch is reported to the Python wrapper.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace seam {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, like torch's .to(bfloat16)
}

}  // namespace seam
