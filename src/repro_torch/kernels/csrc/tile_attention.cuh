// What every kernel source of the port shares: the dtype codes of the C
// entry points, the block size, the running-max start of the online
// softmax, float conversions, warp reductions, the float32 kernels' float4
// dot product, the block-table copy of the paged kernels and the
// once-per-process kernel setup (prepare_kernels).
//
// The attention kernels keep the online softmax's state (running max m,
// running sum l, unnormalised accumulator) in float32 registers.  Masked
// scores are -INFINITY and contribute probability 0, so a row that sees no
// valid key keeps l = 0 and an accumulator of 0 and finishes as 0 /
// max(l, 1e-30) = 0: finite, as the TPU kernels guarantee.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

namespace rt {

// dtype codes shared with the Python wrappers (kernels/_build.py)
enum DType { F32 = 0, BF16 = 1, I8 = 3 };

constexpr int kThreads = 128;        // threads per block, every kernel
constexpr float kNegInit = -1e30f;   // running-max start, as the TPU kernels

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The float32 CUDA-core kernels' operands: a float4 from shared memory,
// and its dot product with another added to acc, one fmaf at a time, in
// order (exact float32 products, one fixed order of summation).
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float fma4(const float4& a, const float4& b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

// A paged kernel's block-table row, copied to shared memory once.
__device__ inline void load_block_table(int* dst, const int* __restrict__ row, int n_log) {
  for (int i = threadIdx.x; i < n_log; i += blockDim.x) dst[i] = row[i];
}

// Once per process, when the library is bound (each source's rt_prepare_*
// entry): every kernel instantiation its launchers can pick may take all
// the dynamic shared memory a block can opt in to on the current device.
// Asking for a kernel's attributes loads its module, so no launch, and no
// CUDA graph capture, meets a lazy module load or an attribute call.
inline cudaError_t prepare_kernels(std::initializer_list<const void*> kernels) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  for (const void* kernel : kernels) {
    cudaFuncAttributes attr;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin - static_cast<int>(attr.sharedSizeBytes));
  }
  return err;
}

}  // namespace rt
