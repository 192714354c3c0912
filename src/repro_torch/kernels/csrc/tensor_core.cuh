// Tensor-core building blocks shared by the bf16 kernels of the port
// (prefill flash attention and paged extend, grouped expert GEMM; the
// decode kernel and the SSD scan use the copies): 16-, 8- and 4-byte
// cp.async copies from device to shared memory, ldmatrix fragment loads
// and the mma.sync m16n8k16 bf16 product with float32 accumulators, as
// inline PTX; and the warp reductions of the decode kernel and the SSD
// scan.
//
// Fragment layouts of m16n8k16 (lane = 4 * g + t, g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major), 4 registers of 2 bf16:
//     a0 (row g, cols 2t, 2t+1), a1 (row g+8, same cols),
//     a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, cols 2t+8, 2t+9);
//   B (16 x 8, "col"), 2 registers: b0 (k rows 2t, 2t+1, col g),
//     b1 (k rows 2t+8, 2t+9, col g);
//   C/D (16 x 8 float32): c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8).
// A row-major shared tile feeds A through ldmatrix.x4 with lane l pointing
// at row (l % 16), column 8 * (l / 16) of the 16 x 16 block.  A shared tile
// stored [n][k] feeds B through ldmatrix.x4 (two n-tiles of 8); one stored
// [k][n] through ldmatrix.x4.trans.
//
// Shared tiles keep a row stride of (width + 8) bf16: with width % 16 == 0
// the eight 16-byte rows an ldmatrix phase reads start on distinct 4-bank
// groups, so the reads have no bank conflicts.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace rt {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device to shared memory, asynchronously; when !ok nothing
// is read and the 16 bytes are zero-filled (src must still be a valid
// address: callers pass the tensor's base).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// kBytes (4, 8 or 16) from device to shared memory, asynchronously,
// through L1 (cp.async.ca: the .cg form takes only 16 bytes).  Both
// addresses are kBytes-aligned.
template <int kBytes>
__device__ __forceinline__ void cp_async_ca(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "n"(kBytes)
               : "memory");
}


__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n of this thread's committed groups are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d += a * b on one 16 x 8 x 16 tile: bf16 operands, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c ? a : b as one selp: opaque to the compiler, which would otherwise
// turn a select between two elements of a register array into a load at
// a computed index and move the array to local memory
__device__ __forceinline__ float select(bool c, float a, float b) {
  float r;
  asm("{\n .reg .pred p;\n setp.ne.b32 p, %3, 0;\n selp.f32 %0, %1, %2, p;\n}\n"
      : "=f"(r)
      : "f"(a), "f"(b), "r"(static_cast<int>(c)));
  return r;
}

// The halving steps of a warp sum of n values a lane, from lane offset o
// down: at offset o a lane keeps the half of its values that its lane bit
// o selects and adds its partner's part of that half.  From o = 16 (the
// whole warp), after log2(n) steps x[0] of lane L holds value L >> (5 -
// log2(n)) summed over the lanes that share those top bits; from o = 8
// with n = 16, value L % 16 summed over the 16 lanes of L's half warp.  A
// template, so that every index is a constant and x stays in registers.
template <int kSize, int n, int o>
__device__ __forceinline__ void halve_sum(float (&x)[kSize], int lane) {
  if constexpr (n > 1) {
    constexpr int half = n / 2;
    const bool up = lane & o;
#pragma unroll
    for (int j = 0; j < half; ++j) {
      const float send = select(up, x[j], x[j + half]);
      const float keep = select(up, x[j + half], x[j]);
      x[j] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
    halve_sum<kSize, half, o / 2>(x, lane);
  }
}

// Two floats rounded to bf16 in one register, `lo` in the low half (the
// lower column of a fragment).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace rt
