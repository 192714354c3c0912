// Hopper (sm_90a) building blocks shared by the port's wgmma kernels (the
// grouped GEMM's backward; meant for the flash kernels and the SSD scan
// too), as inline PTX:
//
// - mbarriers: init, arrive, arrive with an expected transaction count,
//   and a wait on a phase's parity; named barriers, and the warp-uniform
//   values that wgmma's conditions must be made of;
// - the Tensor Memory Accelerator: a 3D tile load into shared memory that
//   completes on an mbarrier, a 3D tile store from shared memory in a bulk
//   group, and the proxy fence that makes threads' shared-memory writes
//   visible to it (and to wgmma);
// - wgmma: the shared-memory matrix descriptor of a 128-byte-swizzled
//   tile, fence / commit / wait, and m64n128k16 bf16 x bf16 -> float32
//   with A and B from shared memory, each K-major or, through its
//   transpose bit, MN-major;
// - setmaxnreg, for warp-specialised kernels whose consumers need more
//   registers than their producer;
// - on the host, a 3D bf16 tensor map with 128-byte swizzle, encoded
//   through the cuTensorMapEncodeTiled entry point that the runtime hands
//   out (so the library needs no -lcuda).
//
// The layouts.  A TMA box whose innermost extent is 64 bf16 (128 bytes),
// loaded with 128-byte swizzle, lands as rows of 128 bytes in which the
// 16-byte chunk j of row r sits at chunk j ^ (r % 8); a group of 8 rows
// is one 1024-byte swizzle atom, so the tile's base must be 1024-aligned.
// Such a tile is a wgmma operand in two ways:
//   K-major (the row is 64 values of K, rows the M or N index): SBO 1024
//     bytes between 8-row groups; one k16 step further along K is the
//     same descriptor with its start address 32 bytes on (the hardware
//     swizzles the address it computes);
//   MN-major (the row is 64 values of M or N, rows the K index; transpose
//     bit set): SBO 1024 bytes between 8-row groups along K, LBO the byte
//     distance from one 64-wide block of M or N to the next; one k16 step
//     is 16 rows, 2048 bytes.
// The m64nNk16 float32 accumulator of thread t of the warpgroup (warp w =
// t / 32, lane l): d[4j + h] at row 16 w + l / 4 + 8 (h / 2), column 8 j +
// 2 (l % 4) + h % 2.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"  // smem_u32

namespace rt {

// ---- mbarriers --------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// after every mbar_init, before any other thread uses the barriers
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// arrive, and expect `bytes` more of transactions (TMA loads) in this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.  A fresh barrier
// is in phase 0, so waiting on parity 1 returns at once (a producer's
// first pass over its empty ring).  A phase that has not completed after
// two seconds (a lost arrival or a short transaction count) traps, so the
// launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint64_t t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
    if (t0 == 0)
      t0 = now;
    else if (now - t0 > 2000000000ull)
      __trap();
  }
}

// v of lane 0, which the compiler then knows to be the same in every lane
// of the warp.  Derive every condition and loop bound that encloses a
// wgmma from such values: under one the compiler cannot prove uniform it
// serialises the wgmma (ptxas warning C7520).
__device__ __forceinline__ int warp_uniform(int v) { return __shfl_sync(0xffffffffu, v, 0); }

// named barrier `id` (1-15; 0 is __syncthreads) over `count` threads
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---- TMA ----------------------------------------------------------------------
// The box at (c0, c1, c2) (innermost first) of `map` into shared `dst`;
// its bytes complete on `bar`.  Elements outside the tensor land as zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Shared `src` to the box at (c0, c1, c2) of `map`, in this thread's bulk
// group; elements outside the tensor are not written.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until at most n of this thread's store groups still read shared memory
template <int n>
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(n) : "memory");
}

// until at most n of this thread's store groups are still in flight
template <int n>
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(n) : "memory");
}

// this thread's shared-memory writes made visible to the async proxy (a
// TMA store, a wgmma operand read); a barrier then publishes them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// byte offset of the 16-byte chunk `chunk` of row `row` in a 128-byte
// swizzled tile
__device__ __forceinline__ uint32_t sw128(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// ---- wgmma --------------------------------------------------------------------
// Descriptor of a 128-byte-swizzled shared tile at `p` (layout type 1),
// byte offsets lbo and sbo.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// until at most n of the warpgroup's committed groups are in flight
template <int n>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(n) : "memory");
}

#define RT_ACC8(i)                                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),        \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// Keeps the compiler from moving reads or writes of accumulators across
// an asynchronous wgmma: every register "changes" here.
__device__ __forceinline__ void wgmma_fence_acc(float (&d)[64]) {
  asm volatile("" : RT_ACC8(0), RT_ACC8(8), RT_ACC8(16), RT_ACC8(24), RT_ACC8(32), RT_ACC8(40),
                    RT_ACC8(48), RT_ACC8(56)::"memory");
}

// d (64 x 128, float32) += A (64 x 16) B (16 x 128), bf16 from shared
// memory; kTA / kTB: the operand is MN-major (transposed)
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : RT_ACC8(0), RT_ACC8(8), RT_ACC8(16), RT_ACC8(24), RT_ACC8(32), RT_ACC8(40),
        RT_ACC8(48), RT_ACC8(56)
      : "l"(da), "l"(db), "r"(1), "n"(kTA), "n"(kTB));
}

#undef RT_ACC8

// ---- setmaxnreg ---------------------------------------------------------------
// The warpgroup's registers per thread raised / lowered to n (a multiple
// of 8 in [24, 256]); all four warps execute it.
template <int n>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(n));
}

template <int n>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(n));
}

// ---- host: tensor maps ----------------------------------------------------------
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled needs the device's context current on the calling
// thread; the runtime binds it lazily, and autograd runs a backward on a
// thread of its own where nothing may have bound it yet.  cudaSetDevice
// binds it.
inline cudaError_t bind_context() {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  return err == cudaSuccess ? cudaSetDevice(dev) : err;
}

// A bf16 tensor of extents (n0, n1, n2), n0 contiguous, rows of n0 and
// planes of n0 * n1 elements, cut into boxes of (b0, b1, 1) with 128-byte
// swizzle (b0 * 2 <= 128).  Needs n0 % 8 == 0 and a 16-byte aligned base.
// Returns cudaErrorInvalidValue when cuTensorMapEncodeTiled refuses it.
inline cudaError_t tensor_map_3d(CUtensorMap* map, const void* base, int n0, int n1, int n2,
                                 int b0, int b1) {
  static EncodeTiledFn encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<EncodeTiledFn>(fn);
  }();
  if (encode == nullptr) return cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(n0), static_cast<cuuint64_t>(n1),
                              static_cast<cuuint64_t>(n2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(n0) * 2,
                                 static_cast<cuuint64_t>(n0) * n1 * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(b0), static_cast<cuuint32_t>(b1), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace rt
