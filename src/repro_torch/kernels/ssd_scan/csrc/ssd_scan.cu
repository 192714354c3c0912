// Mamba-2 SSD chunk scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/ssd_scan.py::
// _ssd_chunk_kernel (wrapper ssd_chunks).  Per (row b, head h, chunk c) of
// Q steps, all in float32:
//   cs      = cumsum(dA)                                     (Q,)
//   y_diag  = ((C B^T) * L) x,  L[i, j] = exp(cs_i - cs_j) for i >= j, else 0
//   states  = sum_q exp(cs_last - cs_q) x_q^T B_q            (P, N)
//   decay   = exp(cs_last)
// B and C belong to the head's group g = h / (H / G).  The inter-chunk
// recurrence and the state -> output term stay outside, in ops.ssd, as the
// JAX wrapper keeps them outside Pallas.
//
// What bounds it on the H100: the bytes.  At the cold prefill of
// mamba2-2.7b (B 8, S 128, Q 16, H 80, P 64, N 128) the chunk states
// written are 168 MB of the call's 211 MB; the products are 1.85 GFLOP,
// 0.03 ms at the float32 peak against 0.06 ms for the bytes.  At Q 128 the
// products are the larger term.
//
// Design: one block of 256 threads per (b, h, c); the TPU kernel's grid
// ran these steps in order, here they are independent blocks.  The cumsum
// is a block scan with warp shuffles in float32 (the TPU kernel wrote it
// as a triangular matmul: it has no shuffles), 256 steps at a time with a
// carry.  Q x Q, Q x N and Q x P do not fit in shared memory together at
// Q 256 (the score matrix alone is 256 KB), so the query rows are tiled: a
// tile of 32 rows of C meets the tiles of 32 rows of B and x at or below
// the diagonal, and each thread keeps groups of 4 consecutive outputs of
// the tile in registers.  The chunk state is a second pass over the key
// tiles, with each x row scaled by exp(cs_last - cs_q) as it is loaded;
// each thread accumulates 4 x 4 tiles of (P, N) from 16-byte shared loads
// (two loads for 16 FMAs).  Tiles are loaded with several device loads in
// flight per thread.  Every tensor comes with its strides, so the model's
// (B, S, H, P) and (B, S, G, N) layouts are read in place, without the
// five-axis transposes of the JAX wrapper, and y_diag is written straight
// into a (B, S, H, P) buffer.  P and N must be multiples of 4.  The
// products run on CUDA cores out of shared memory.  C B^T is the same for
// the H / G heads of a group; sharing it across them, and tensor-core
// tiles, are later work.
//
// A step with dA = 0 and x = 0 (a masked pad step) is an exact identity:
// a chunk of such steps gives decay = 1 and states = 0 bit for bit, which
// the snapshot restore relies on.  The build uses no fast-math flags.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rt {

constexpr int kSsdThreads = 256;
constexpr int kSsdWarps = kSsdThreads / 32;
constexpr int kSsdTile = 32;                 // rows per tile
constexpr int kSsdMaxP = 256;                // head dim limit
constexpr int kYTasks = kSsdTile * kSsdMaxP / 4 / kSsdThreads;  // 4-wide y outputs/thread
constexpr int kStateTiles = 2;               // 4 x 4 state tiles per thread per pass
constexpr int kLoadBatch = 8;                // device loads in flight per thread

// Inclusive scan of one value per thread over the block.  `tot` holds
// kSsdWarps floats of shared memory; the caller syncs before the next call.
__device__ inline float block_scan(float v, float* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  if (lane == 31) tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kSsdWarps ? tot[lane] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float n = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += n;
    }
    if (lane < kSsdWarps) tot[lane] = t;
  }
  __syncthreads();
  return warp > 0 ? v + tot[warp - 1] : v;
}

// dst[r * ld + c] = src[r * s_r + c * s_c] (times scale[r] when given) for
// r < nrows, c < ncols.  Each thread issues kLoadBatch device loads before
// it stores any, so the loads are in flight together.
__device__ inline void load_tile(float* dst, int ld, const float* __restrict__ src,
                                 int64_t s_r, int64_t s_c, int nrows, int ncols,
                                 const float* scale) {
  const int total = nrows * ncols;
  for (int base = threadIdx.x; base < total; base += kSsdThreads * kLoadBatch) {
    float v[kLoadBatch];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int i = base + u * kSsdThreads;
      const int r = i / ncols, c = i - r * ncols;
      v[u] = i < total ? src[r * s_r + c * s_c] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int i = base + u * kSsdThreads;
      if (i < total) {
        const int r = i / ncols, c = i - r * ncols;
        dst[r * ld + c] = scale != nullptr ? v[u] * scale[r] : v[u];
      }
    }
  }
}

__device__ inline void fma4x4(float (&acc)[16], const float4& a, const float4& b) {
  const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i * 4 + j] = fmaf(av[i], bv[j], acc[i * 4 + j]);
}

// Shared-memory floats of one block (P and N multiples of 4).
__host__ __device__ inline size_t ssd_smem_floats(int Q, int P, int N) {
  return 2 * (size_t)Q + 2 * (size_t)kSsdTile * (N + 1) + (size_t)kSsdTile * P +
         (size_t)kSsdTile * (kSsdTile + 1);
}

__global__ void __launch_bounds__(kSsdThreads) ssd_chunk_kernel(
    const float* __restrict__ x, int64_t x_sb, int64_t x_sh, int64_t x_sc, int64_t x_sq,
    int64_t x_sp,
    const float* __restrict__ dA, int64_t a_sb, int64_t a_sh, int64_t a_sc, int64_t a_sq,
    const float* __restrict__ Bm, int64_t b_sb, int64_t b_sg, int64_t b_sc, int64_t b_sq,
    int64_t b_sn,
    const float* __restrict__ Cm, int64_t c_sb, int64_t c_sg, int64_t c_sc, int64_t c_sq,
    int64_t c_sn,
    float* __restrict__ y, int64_t y_sb, int64_t y_sh, int64_t y_sc, int64_t y_sq,
    int64_t y_sp,
    float* __restrict__ states, float* __restrict__ decay,
    int H, int nc, int Q, int P, int N, int HG) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float tot[kSsdWarps];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, g = h / HG;
  const int tid = threadIdx.x;
  const int ldn = N + 1, lds = kSsdTile + 1;
  // xt first: 16-byte aligned for its float4 reads, as bt is in the state
  // pass (unpadded there; the score pass pads B and C rows by one float so
  // that threads on consecutive key rows hit distinct banks)
  float* xt = smem;                        // [T][P]   x rows of the key tile
  float* bt = xt + kSsdTile * P;           // [T][ldn] B rows of the key tile
  float* ct = bt + kSsdTile * ldn;         // [T][ldn] C rows of the query tile
  float* st = ct + kSsdTile * ldn;         // [T][lds] masked scores
  float* cs = st + kSsdTile * lds;         // [Q]      cumsum of dA
  float* wt = cs + Q;                      // [Q]      exp(cs_last - cs_q)

  const float* xb = x + b * x_sb + h * x_sh + c * x_sc;
  const float* ab = dA + b * a_sb + h * a_sh + c * a_sc;
  const float* bb = Bm + b * b_sb + g * b_sg + c * b_sc;
  const float* cb = Cm + b * c_sb + g * c_sg + c * c_sc;
  float* yb = y + b * y_sb + h * y_sh + c * y_sc;
  const int64_t blk = ((int64_t)b * H + h) * nc + c;

  // cs = cumsum(dA): block scans of kSsdThreads steps, each from the carry
  float carry = 0.f;
  for (int q0 = 0; q0 < Q; q0 += kSsdThreads) {
    const int q = q0 + tid;
    const float v = block_scan(q < Q ? ab[q * a_sq] : 0.f, tot) + carry;
    if (q < Q) cs[q] = v;
    __syncthreads();
    carry = cs[min(q0 + kSsdThreads, Q) - 1];
    __syncthreads();
  }
  const float last = cs[Q - 1];
  for (int q = tid; q < Q; q += kSsdThreads) wt[q] = expf(last - cs[q]);
  if (tid == 0) decay[blk] = expf(last);

  // y_diag, one tile of query rows at a time; each thread owns up to
  // kYTasks groups of 4 consecutive outputs of one row
  const int p4 = P / 4;
  for (int i0 = 0; i0 < Q; i0 += kSsdTile) {
    const int nr = min(kSsdTile, Q - i0);
    load_tile(ct, ldn, cb + i0 * c_sq, c_sq, c_sn, nr, N, nullptr);
    float4 acc[kYTasks];
#pragma unroll
    for (int k = 0; k < kYTasks; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j0 = 0; j0 <= i0; j0 += kSsdTile) {
      const int nk = min(kSsdTile, Q - j0);
      __syncthreads();                      // the previous tile's readers
      load_tile(bt, ldn, bb + j0 * b_sq, b_sq, b_sn, nk, N, nullptr);
      load_tile(xt, P, xb + j0 * x_sq, x_sq, x_sp, nk, P, nullptr);
      __syncthreads();
      for (int i = tid; i < nr * nk; i += kSsdThreads) {
        const int r = i / nk, kc = i - r * nk;
        const int qi = i0 + r, kj = j0 + kc;
        float s = 0.f;
        if (kj <= qi) {
          const float* cr = ct + r * ldn;
          const float* br = bt + kc * ldn;
          float dot = 0.f;
#pragma unroll 8
          for (int n = 0; n < N; ++n) dot = fmaf(cr[n], br[n], dot);
          s = dot * expf(cs[qi] - cs[kj]);
        }
        st[r * lds + kc] = s;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kYTasks; ++k) {
        const int i = tid + k * kSsdThreads;
        if (i < nr * p4) {
          const int r = i / p4, pp = (i - r * p4) * 4;
          const float* sr = st + r * lds;
          float4 a = acc[k];
          for (int kc = 0; kc < nk; ++kc) {
            const float sv = sr[kc];
            const float4 xv = *reinterpret_cast<const float4*>(xt + kc * P + pp);
            a.x = fmaf(sv, xv.x, a.x);
            a.y = fmaf(sv, xv.y, a.y);
            a.z = fmaf(sv, xv.z, a.z);
            a.w = fmaf(sv, xv.w, a.w);
          }
          acc[k] = a;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kYTasks; ++k) {
      const int i = tid + k * kSsdThreads;
      if (i < nr * p4) {
        const int r = i / p4, pp = (i - r * p4) * 4;
        float* yr = yb + (i0 + r) * y_sq + pp * y_sp;
        yr[0] = acc[k].x;
        yr[y_sp] = acc[k].y;
        yr[2 * y_sp] = acc[k].z;
        yr[3 * y_sp] = acc[k].w;
      }
    }
    __syncthreads();                        // ct is reloaded next
  }

  // chunk state: 4 x 4 register tiles of (P, N), each row of x scaled by
  // exp(cs_last - cs_q) as it is loaded
  float* sb = states + blk * P * N;
  const int n4 = N / 4, n_tiles = p4 * n4;
  for (int base = 0; base < n_tiles; base += kStateTiles * kSsdThreads) {
    float acc[kStateTiles][16];
#pragma unroll
    for (int s = 0; s < kStateTiles; ++s)
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[s][e] = 0.f;
    for (int j0 = 0; j0 < Q; j0 += kSsdTile) {
      const int nk = min(kSsdTile, Q - j0);
      __syncthreads();
      load_tile(bt, N, bb + j0 * b_sq, b_sq, b_sn, nk, N, nullptr);
      load_tile(xt, P, xb + j0 * x_sq, x_sq, x_sp, nk, P, wt + j0);
      __syncthreads();
#pragma unroll
      for (int s = 0; s < kStateTiles; ++s) {
        const int t = base + tid + s * kSsdThreads;
        if (t < n_tiles) {
          const int pp = (t / n4) * 4, nn = (t - (t / n4) * n4) * 4;
          for (int kc = 0; kc < nk; ++kc) {
            fma4x4(acc[s], *reinterpret_cast<const float4*>(xt + kc * P + pp),
                   *reinterpret_cast<const float4*>(bt + kc * N + nn));
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < kStateTiles; ++s) {
      const int t = base + tid + s * kSsdThreads;
      if (t < n_tiles) {
        const int pp = (t / n4) * 4, nn = (t - (t / n4) * n4) * 4;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          *reinterpret_cast<float4*>(sb + (int64_t)(pp + i) * N + nn) = make_float4(
              acc[s][i * 4], acc[s][i * 4 + 1], acc[s][i * 4 + 2], acc[s][i * 4 + 3]);
        }
      }
    }
  }
}

}  // namespace rt

// Plain C entry point bound with ctypes.  x and y: (Bb, H, nc, Q, P); dA:
// (Bb, H, nc, Q); B and C: (Bb, G, nc, Q, N), each given by its strides in
// elements; states (Bb, H, nc, P, N) and decay (Bb, H, nc) are contiguous.
// Everything is float32.  Returns cudaGetLastError() of the launch.
extern "C" int rt_ssd_chunks(
    const void* x, int64_t x_sb, int64_t x_sh, int64_t x_sc, int64_t x_sq, int64_t x_sp,
    const void* dA, int64_t a_sb, int64_t a_sh, int64_t a_sc, int64_t a_sq,
    const void* B, int64_t b_sb, int64_t b_sg, int64_t b_sc, int64_t b_sq, int64_t b_sn,
    const void* C, int64_t c_sb, int64_t c_sg, int64_t c_sc, int64_t c_sq, int64_t c_sn,
    void* y, int64_t y_sb, int64_t y_sh, int64_t y_sc, int64_t y_sq, int64_t y_sp,
    void* states, void* decay, int Bb, int H, int G, int nc, int Q, int P, int N,
    void* stream) {
  using namespace rt;
  if (Bb == 0 || H == 0 || nc == 0) return cudaSuccess;
  if (Q <= 0 || P <= 0 || P > kSsdMaxP || P % 4 || N <= 0 || N % 4 || G <= 0 || H % G) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(float) * ssd_smem_floats(Q, P, N);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(nc, H, Bb);
  ssd_chunk_kernel<<<grid, kSsdThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), x_sb, x_sh, x_sc, x_sq, x_sp,
      static_cast<const float*>(dA), a_sb, a_sh, a_sc, a_sq,
      static_cast<const float*>(B), b_sb, b_sg, b_sc, b_sq, b_sn,
      static_cast<const float*>(C), c_sb, c_sg, c_sc, c_sq, c_sn,
      static_cast<float*>(y), y_sb, y_sh, y_sc, y_sq, y_sp,
      static_cast<float*>(states), static_cast<float*>(decay), H, nc, Q, P, N, H / G);
  return cudaGetLastError();
}
