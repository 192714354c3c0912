// Grouped expert GEMM for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/moe_gmm/moe_gmm.py::_gmm_kernel
// (wrapper gmm).  Over the MoE capacity layout it computes, for every
// expert e, out[e, c] = x[e, c] @ w[e] for c < counts[e] and writes 0 for
// the padding rows at or past counts[e]: (E, C, D) x (E, D, F) -> (E, C, F),
// float32 or bf16 in and out, float32 accumulation.
//
// What bounds it on the H100: at decode (C = 8 tokens, a few experts hit)
// the weight bytes of the experts that received a token, D * F * 2 bytes
// each; the empty experts' weights need not move at all.  At a 1024-token
// prefill (C = 192) every expert is busy and the 2 * counts * D * F flops
// bind on the tensor cores.
//
// What this simple design does about it: a grid of (expert, C-tile,
// F-tile) blocks.  Each block reads counts[e] from device memory (the
// wrapper never synchronises on it); a tile that starts at or past it
// writes its zeros and returns before it loads a single weight, so the
// weight bytes read are those of the busy experts only, as the Pallas
// kernel's pl.when skipped them.  A busy tile loops over D in 32-deep
// slices through shared memory; each thread loads its weights as 16-byte
// vectors, and the next slice's loads are issued before the current
// slice's arithmetic, so the weight stream does not wait on the FMAs.
// Each thread keeps a 2 x 4 register tile of float32 sums, computed with
// plain FMAs, and the register budget is held to 4 blocks per SM.  Rows past counts[e] load
// as zero and their warps skip the arithmetic.  Any C, D and F are taken:
// ragged tiles are masked (the Pallas wrapper asserted C % block_c == 0 and
// F % block_f == 0, which the decode and prefill shapes break).  The
// prefill shapes want tensor-core products (wgmma with TMA-fed tiles); that
// is later work.
#include "tile_attention.cuh"  // dtype codes and conversions

namespace rt {

constexpr int kGmmThreads = 256;
constexpr int kBC = 32;  // rows (capacity slots) per tile
constexpr int kBF = 64;  // output columns per tile
constexpr int kBK = 32;  // depth of one shared-memory slice
constexpr int kXLoads = kBC * kBK / kGmmThreads;  // 4 x elements per thread
constexpr int kWLoads = kBK * kBF / kGmmThreads;  // 8 w elements per thread

// 16 bytes of T as floats.
__device__ inline void unpack(const uint4& v, float* out, float) {
  out[0] = __uint_as_float(v.x);
  out[1] = __uint_as_float(v.y);
  out[2] = __uint_as_float(v.z);
  out[3] = __uint_as_float(v.w);
}
__device__ inline void unpack(const uint4& v, float* out, __nv_bfloat16) {
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(h[i]);
}

// One D-slice of a tile in flight: raw x and w values between their
// device-memory loads and their shared-memory stores.  With kVec each
// thread loads its 8 w values of one slice row as 16-byte vectors (F a
// multiple of 8, so a vector never straddles the ragged F edge); else
// element by element.
template <typename T, bool kVec>
struct Slice {
  static constexpr int kV = 16 / sizeof(T);  // elements per vector
  T x[kXLoads];
  uint4 wv[kWLoads / kV];
  T w[kVec ? 1 : kWLoads];

  __device__ inline void load(const T* __restrict__ xe, const T* __restrict__ we, int k0,
                              int rows, int D, int F, int f0) {
    const int tid = threadIdx.x;
#pragma unroll
    for (int u = 0; u < kXLoads; ++u) {
      const int i = tid + u * kGmmThreads, r = i / kBK, kk = i % kBK;
      x[u] = r < rows && k0 + kk < D ? xe[(int64_t)r * D + k0 + kk] : from_f<T>(0.f);
    }
    if constexpr (kVec) {
      const int kk = tid / (kBF / kWLoads), f = (tid % (kBF / kWLoads)) * kWLoads;
      const bool ok = k0 + kk < D && f0 + f < F;
      const T* src = we + (int64_t)(k0 + kk) * F + f;
#pragma unroll
      for (int u = 0; u < kWLoads / kV; ++u)
        wv[u] = ok ? reinterpret_cast<const uint4*>(src)[u] : make_uint4(0, 0, 0, 0);
    } else {
#pragma unroll
      for (int u = 0; u < kWLoads; ++u) {
        const int i = tid + u * kGmmThreads, kk = i / kBF, f = i % kBF;
        w[u] = k0 + kk < D && f0 + f < F ? we[(int64_t)(k0 + kk) * F + f] : from_f<T>(0.f);
      }
    }
  }

  __device__ inline void store(float (*xs)[kBC + 1], float (*ws)[kBF]) const {
    const int tid = threadIdx.x;
#pragma unroll
    for (int u = 0; u < kXLoads; ++u) {
      const int i = tid + u * kGmmThreads;
      xs[i % kBK][i / kBK] = to_f(x[u]);
    }
    if constexpr (kVec) {
      const int kk = tid / (kBF / kWLoads), f = (tid % (kBF / kWLoads)) * kWLoads;
      float vals[kWLoads];
#pragma unroll
      for (int u = 0; u < kWLoads / kV; ++u) unpack(wv[u], vals + u * kV, T());
#pragma unroll
      for (int u = 0; u < kWLoads; u += 4)
        *reinterpret_cast<float4*>(&ws[kk][f + u]) =
            make_float4(vals[u], vals[u + 1], vals[u + 2], vals[u + 3]);
    } else {
#pragma unroll
      for (int u = 0; u < kWLoads; ++u) {
        const int i = tid + u * kGmmThreads;
        ws[i / kBF][i % kBF] = to_f(w[u]);
      }
    }
  }
};

template <typename T, bool kVec>
__global__ void __launch_bounds__(kGmmThreads, 4) gmm_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const int* __restrict__ counts,
    T* __restrict__ out, int C, int D, int F) {
  __shared__ float xs[kBK][kBC + 1];             // transposed x slice
  __shared__ __align__(16) float ws[kBK][kBF];   // w slice
  const int e = blockIdx.x, c0 = blockIdx.y * kBC, f0 = blockIdx.z * kBF;
  const int tid = threadIdx.x;
  const int count = min(max(counts[e], 0), C);
  T* o = out + (int64_t)e * C * F;
  if (c0 >= count) {  // an empty tile: zeros, and no weight is loaded
    for (int i = tid; i < kBC * kBF; i += kGmmThreads) {
      const int r = c0 + i / kBF, f = f0 + i % kBF;
      if (r < C && f < F) o[(int64_t)r * F + f] = from_f<T>(0.f);
    }
    return;
  }
  const T* xe = x + ((int64_t)e * C + c0) * D;
  const T* we = w + (int64_t)e * D * F + f0;
  const int rows = min(kBC, count - c0);         // valid rows of this tile
  const int tx = tid & 15, ty = tid >> 4;        // columns tx*4.., rows ty*2..
  const bool busy = ty * 2 < rows;
  float acc[2][4] = {};

  Slice<T, kVec> slice;
  slice.load(xe, we, 0, rows, D, F, f0);
  for (int k0 = 0; k0 < D; k0 += kBK) {
    slice.store(xs, ws);
    __syncthreads();
    // the next slice's loads are in flight while this one is multiplied
    if (k0 + kBK < D) slice.load(xe, we, k0 + kBK, rows, D, F, f0);
    if (busy) {
#pragma unroll 8
      for (int kk = 0; kk < kBK; ++kk) {
        const float a0 = xs[kk][ty * 2], a1 = xs[kk][ty * 2 + 1];
        const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
        acc[0][0] = fmaf(a0, b.x, acc[0][0]);
        acc[0][1] = fmaf(a0, b.y, acc[0][1]);
        acc[0][2] = fmaf(a0, b.z, acc[0][2]);
        acc[0][3] = fmaf(a0, b.w, acc[0][3]);
        acc[1][0] = fmaf(a1, b.x, acc[1][0]);
        acc[1][1] = fmaf(a1, b.y, acc[1][1]);
        acc[1][2] = fmaf(a1, b.z, acc[1][2]);
        acc[1][3] = fmaf(a1, b.w, acc[1][3]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = c0 + ty * 2 + i;
    if (r >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = f0 + tx * 4 + j;
      if (f < F) o[(int64_t)r * F + f] = from_f<T>(r < count ? acc[i][j] : 0.f);
    }
  }
}

template <typename T>
cudaError_t launch_gmm(const void* x, const void* w, const int* counts, void* out, int E,
                       int C, int D, int F, cudaStream_t stream) {
  const dim3 grid(E, (C + kBC - 1) / kBC, (F + kBF - 1) / kBF);
  // 16-byte weight vectors need F % 8 == 0 and a 16-byte aligned base
  const bool vec = F % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  auto kernel = vec ? gmm_kernel<T, true> : gmm_kernel<T, false>;
  kernel<<<grid, kGmmThreads, 0, stream>>>(static_cast<const T*>(x),
                                           static_cast<const T*>(w), counts,
                                           static_cast<T*>(out), C, D, F);
  return cudaGetLastError();
}

}  // namespace rt

// Plain C entry point bound with ctypes.  x (E, C, D), w (E, D, F) and out
// (E, C, F) are contiguous; counts is an (E,) int32 device array.  Returns
// cudaGetLastError() of the launch.
extern "C" int rt_gmm(const void* x, const void* w, const void* counts, void* out, int E,
                      int C, int D, int F, int dtype, void* stream) {
  using namespace rt;
  const int* cnt = static_cast<const int*>(counts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E == 0 || C == 0 || F == 0) return cudaSuccess;
  switch (dtype) {
    case F32:
      return launch_gmm<float>(x, w, cnt, out, E, C, D, F, s);
    case BF16:
      return launch_gmm<__nv_bfloat16>(x, w, cnt, out, E, C, D, F, s);
    default:
      return cudaErrorInvalidValue;
  }
}
