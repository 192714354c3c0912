// Shared-memory attention tile of the port's CUDA-core attention kernels
// (float32 prefill flash, paged extend over float32 or int8 arenas, dense
// decode).
//
// One thread block owns a tile of `nr` query rows (q heads or q positions)
// and streams key/value tiles of `nc` rows through shared memory, keeping
// the online-softmax state (running max m, running sum l, unnormalised
// accumulator acc) in float32 shared memory.  The TPU kernels carried the
// same state in VMEM scratch across the sequential kv grid axis; on Hopper
// blocks run in parallel and in no order, so the kv axis is a loop inside
// the block instead.
//
// Masked scores are stored as -INFINITY and contribute probability 0, so a
// row that sees no valid key keeps acc = 0, l = 0 and finishes as
// 0 / max(l, 1e-30) = 0: finite, as the TPU kernels guarantee.
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

// Row stride of the q/k/v tiles: one float of padding keeps the column
// walks of tile_scores free of shared-memory bank conflicts.
__host__ __device__ inline int tile_ld(int dh) { return dh + 1; }

// Bytes of dynamic shared memory for a tile of nq query rows, nk key rows.
__host__ __device__ inline size_t tile_smem_bytes(int nq, int nk, int dh) {
  const size_t ld = tile_ld(dh);
  return sizeof(float) * (nq * ld + 2 * nk * ld + (size_t)nq * nk + (size_t)nq * dh + 3 * (size_t)nq);
}

struct Tile {
  float* q;     // [nq][ld]
  float* k;     // [nk][ld]
  float* v;     // [nk][ld]
  float* s;     // [nq][nk]  scores, then probabilities
  float* acc;   // [nq][dh]
  float* m;     // [nq]
  float* l;     // [nq]
  float* corr;  // [nq]
  int ld;
  int nk;       // row stride of s
  int dh;
};

__device__ inline Tile carve_tile(float* base, int nq, int nk, int dh) {
  Tile t;
  t.ld = tile_ld(dh);
  t.nk = nk;
  t.dh = dh;
  t.q = base;
  t.k = t.q + nq * t.ld;
  t.v = t.k + nk * t.ld;
  t.s = t.v + nk * t.ld;
  t.acc = t.s + nq * nk;
  t.m = t.acc + nq * dh;
  t.l = t.m + nq;
  t.corr = t.l + nq;
  return t;
}

// First float past the tile, for kernel-specific scratch behind it.
__device__ inline float* tile_end(const Tile& t, int nq) { return t.corr + nq; }

__device__ inline void tile_init(const Tile& t, int nq) {
  for (int i = threadIdx.x; i < nq * t.dh; i += blockDim.x) t.acc[i] = 0.f;
  for (int i = threadIdx.x; i < nq; i += blockDim.x) {
    t.m[i] = kNegInit;
    t.l[i] = 0.f;
  }
}

constexpr int kLoadBatch = 16;  // device-memory loads in flight per thread

// dst_a[r][d] = float(src_a[r * stride_a + d]) * mul_a for r < nvalid,
// 0 for nvalid <= r < nrows; the same for (dst_b, src_b, stride_b, mul_b)
// unless src_b is null (K and V tiles load together).  Consecutive threads
// read consecutive d, so reads coalesce; each thread loads kLoadBatch
// elements of each array into registers before it stores any, so its
// loads are in flight together instead of one latency each.
template <typename T>
__device__ inline void load_rows(float* dst_a, const T* __restrict__ src_a,
                                 int64_t stride_a, float mul_a, float* dst_b,
                                 const T* __restrict__ src_b, int64_t stride_b,
                                 float mul_b, int ld, int nrows, int nvalid, int dh) {
  const int total = nrows * dh;
  for (int base = threadIdx.x; base < total; base += blockDim.x * kLoadBatch) {
    float a[kLoadBatch], b[kLoadBatch];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int i = base + u * blockDim.x;
      const int r = i / dh, d = i - (i / dh) * dh;
      const bool ok = i < total && r < nvalid;
      a[u] = ok ? to_f(src_a[r * stride_a + d]) : 0.f;
      b[u] = ok && src_b != nullptr ? to_f(src_b[r * stride_b + d]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int i = base + u * blockDim.x;
      if (i < total) {
        const int r = i / dh, d = i - (i / dh) * dh;
        dst_a[r * ld + d] = a[u] * mul_a;
        if (src_b != nullptr) dst_b[r * ld + d] = b[u] * mul_b;
      }
    }
  }
}

// A paged kernel's block-table row, copied to shared memory once.
__device__ inline void load_block_table(int* dst, const int* __restrict__ row, int n_log) {
  for (int i = threadIdx.x; i < n_log; i += blockDim.x) dst[i] = row[i];
}

// Slot position of page slot threadIdx.x (threads >= P get 0), read before
// the page's K/V loads so that its latency overlaps theirs.  Needs
// P <= blockDim.x, which the wrappers check.
__device__ inline int fetch_slot_pos(const int* __restrict__ page_sp, int64_t stride, int P) {
  return threadIdx.x < P ? page_sp[threadIdx.x * stride] : 0;
}

// s[r][c] = scale * <q_r, k_c> where valid(r, c), else -inf.
template <typename Valid>
__device__ inline void tile_scores(const Tile& t, int nr, int nc, float scale, Valid valid) {
  for (int i = threadIdx.x; i < nr * nc; i += blockDim.x) {
    const int r = i / nc, c = i - (i / nc) * nc;
    float out = -INFINITY;
    if (valid(r, c)) {
      const float* qr = t.q + r * t.ld;
      const float* kc = t.k + c * t.ld;
      float a = 0.f;
      for (int d = 0; d < t.dh; ++d) a = fmaf(qr[d], kc[d], a);
      out = a * scale;
    }
    t.s[r * t.nk + c] = out;
  }
}

// Online-softmax update, one warp per row: s becomes p = exp(s - m_new),
// corr = exp(m_old - m_new), l = l * corr + sum(p).
__device__ inline void tile_softmax(const Tile& t, int nr, int nc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int r = warp; r < nr; r += nw) {
    float* sr = t.s + r * t.nk;
    float mx = -INFINITY;
    for (int c = lane; c < nc; c += 32) mx = fmaxf(mx, sr[c]);
    mx = warp_max(mx);
    const float m_old = t.m[r];
    const float m_new = fmaxf(m_old, mx);
    float sum = 0.f;
    for (int c = lane; c < nc; c += 32) {
      const float sv = sr[c];
      const float p = sv == -INFINITY ? 0.f : expf(sv - m_new);
      sr[c] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float cr = expf(m_old - m_new);
      t.corr[r] = cr;
      t.l[r] = t.l[r] * cr + sum;
      t.m[r] = m_new;
    }
  }
}

// acc[r][d] = acc[r][d] * corr[r] + sum_c p[r][c] * v[c][d].
__device__ inline void tile_pv(const Tile& t, int nr, int nc) {
  for (int i = threadIdx.x; i < nr * t.dh; i += blockDim.x) {
    const int r = i / t.dh, d = i - (i / t.dh) * t.dh;
    const float* pr = t.s + r * t.nk;
    float a = t.acc[i] * t.corr[r];
    for (int c = 0; c < nc; ++c) a = fmaf(pr[c], t.v[c * t.ld + d], a);
    t.acc[i] = a;
  }
}

// One key/value tile through the block: scores, softmax update, P.V.
// The caller has loaded t.k / t.v (and whatever `valid` reads) and synced.
template <typename Valid>
__device__ inline void tile_step(const Tile& t, int nr, int nc, float scale, Valid valid) {
  tile_scores(t, nr, nc, scale, valid);
  __syncthreads();
  tile_softmax(t, nr, nc);
  __syncthreads();
  tile_pv(t, nr, nc);
  __syncthreads();
}

// out[r * row_stride + d] = acc[r][d] / max(l[r], 1e-30) for r < nr.
template <typename T>
__device__ inline void tile_store(const Tile& t, int nr, T* __restrict__ out, int64_t row_stride) {
  for (int i = threadIdx.x; i < nr * t.dh; i += blockDim.x) {
    const int r = i / t.dh, d = i - (i / t.dh) * t.dh;
    out[r * row_stride + d] = from_f<T>(t.acc[i] / fmaxf(t.l[r], 1e-30f));
  }
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
