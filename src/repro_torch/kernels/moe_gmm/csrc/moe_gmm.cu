// Grouped expert GEMM for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/moe_gmm/moe_gmm.py::_gmm_kernel
// (wrapper gmm).  Over the MoE capacity layout it computes, for every
// expert e, out[e, c] = x[e, c] @ w[e] for c < counts[e] and writes 0 for
// the padding rows at or past counts[e]: (E, C, D) x (E, D, F) -> (E, C, F),
// float32 accumulation.  The route is by dtype alone.
//
// What bounds it on the H100: the weight bytes of the experts that
// received a token, D * F * 2 bytes each in bf16; the empty experts'
// weights need not move at all.  At deepseek-moe-16b's decode (C = 8, 37
// of 64 experts hit) that is 213 MB, 0.064 ms at 3.35 TB/s; at its
// 1024-token prefill (C = 192, every expert busy, about 96 rows each) the
// 369 MB of all 64 experts, 0.110 ms of a 0.128 ms bound, while the
// 35 GFLOP of products would take 0.036 ms at the bf16 tensor-core peak.
// So each weight byte should leave device memory about once.
//
// Common to both routes: a grid of (C tile, F tile, expert) blocks.  Each
// block reads counts[e] on the device (the wrapper never synchronises on
// it); a tile that starts at or past it writes its zeros and returns
// before it loads a single weight, as the Pallas kernel's pl.when skipped
// it.  Rows past counts[e] are never read (the dispatch buffer holds
// garbage there): they load as zeros and are written as exact zeros.  Any
// C, D and F are taken; ragged tiles are masked (the Pallas wrapper
// asserted C % block_c == 0 and F % block_f == 0, which the decode and
// prefill shapes break).
//
// bf16: gmm_tc_kernel, on the tensor cores.  m16n8k16 bf16 MMAs with
// float32 accumulators, from ldmatrix fragments (the (D, F) row-major
// weights through ldmatrix.trans) of bf16 shared tiles padded against bank
// conflicts, fed by a three-stage cp.async ring of 64-deep K slices, so the
// weight stream runs two slices ahead of the products.  Rows past
// counts[e] are zero-filled by the copy itself.  To read each weight byte
// about once, the M tile covers an expert's count in as few tiles as
// possible.  Above C 64 the capacity is twice the mean count (capacity
// factor 2), so the tile is 128 rows above C 128 (the prefill's C 192:
// counts average 96, rarely pass 128, capped at 192) and 64 rows above
// C 32 (the warm extend's C 96: counts average 48); at C <= 32 (decode's
// dropless C 8, with 0-3 tokens an expert) it is 16 rows, whose MMA rows
// are half empty at C 8, but the products are 3% of that call and the
// weight stream binds, so the tile is not transposed.  The C tiles of one
// (expert, F tile) sit next to each other in the grid, so a second busy C
// tile finds the weights in L2, and the F tiles of one expert follow each
// other, so its x rows leave device memory once.  Each warp computes 64 x
// 32 (16 x 32 in the 16-row tile); warps wholly past counts[e] skip the
// MMAs.  Unaligned shapes (D or F not a multiple of 8) fill the same
// shared tiles with element loads.  Tuned on the H100 against 64 x 64 warp
// tiles, 128 x 256 block tiles, 32- and 128-deep slices and 2 to 6 stages,
// all slower at the prefill shape (PERF.md, section 6).
//
// float32: gmm_kernel, plain FMAs on CUDA cores, so that products stay
// exact float32.  Each thread keeps a 2 x 4 register tile of sums over
// 32 x 64 output tiles, loops over D in 32-deep slices through float32
// shared memory with 16-byte weight loads issued a slice ahead, and the
// register budget is held to 4 blocks per SM.
//
// The backward (rt_gmm_bwd; the TPU package has none: JAX trains the MoE
// block through einsums and XLA's gradients).  With the output's cotangent
// dy (E, C, F): dX (E, C, D) = dy[e, c] @ w[e]^T for c < counts[e], 0 past
// it, and dW (E, D, F) = x[e, :counts[e]]^T @ dy[e, :counts[e]], zeros for
// an expert with no token.  dX is the forward's tile with w read as it lies
// (the B slices stored [n][k] and fed through ldmatrix without .trans, so
// no transposed copy of the 369 MB weights is made): gmm_dx_tc_kernel,
// the same tiles by C, the same early return before any weight load.  dW
// is a grouped product whose reduction runs over each expert's own count:
// gmm_dw_tc_kernel, 128 x 128 tiles of (D, F) over a grid of (D tile, F
// tile, expert), A = x^T from row-major x slices through ldmatrix.trans,
// B = dy as the forward loads w, the same three-stage cp.async ring over
// 64-slot slices of the count's rows; rows at or past counts[e] are never
// read.  Each output element is summed by one thread in one fixed order
// (no atomics, no split of the reduction), so two calls are bitwise
// equal.  float32: gmm_kernel's other two passes (kDx, kDw), exact float32
// products on CUDA cores.
#include "tensor_core.cuh"
#include "tile_attention.cuh"  // dtype codes, prepare_kernels

namespace rt {

// ---- float32: FMAs on CUDA cores ------------------------------------------
// One body, three passes.  kFwd: out (E, C, F) = x @ w[e], the rows capacity
// slots, the reduction over D.  kDx (the backward's dX): w read as it lies,
// (E, F, D), out = x @ w[e]^T.  kDw (its dW): out (E, D, F) = x[e,
// :count]^T @ w[e, :count] with the cotangent (E, C, F) in w's place, the
// rows x's D columns, the reduction over the count's slots.
enum Pass { kFwd, kDx, kDw };

constexpr int kGmmThreads = 256;
constexpr int kBC = 32;  // output rows per tile (capacity slots; kDw: columns of x)
constexpr int kBF = 64;  // output columns per tile
constexpr int kBK = 32;  // depth of one shared-memory slice
constexpr int kXLoads = kBC * kBK / kGmmThreads;  // 4 x elements per thread
constexpr int kWLoads = kBK * kBF / kGmmThreads;  // 8 w elements per thread
// row stride of the w slice: kDx fills it down its columns, so its rows are
// padded (by 4 floats, keeping the float4 reads aligned)
template <Pass kPass>
constexpr int kLdW = kPass == kDx ? kBF + 4 : kBF;

// One slice of a tile in flight: raw x and w values between their
// device-memory loads and their shared-memory stores.  With kVec each
// thread loads its 8 w values of one slice row as two 16-byte vectors (F a
// multiple of 8, so a vector never straddles the ragged F edge); else
// element by element.  Every pass reads along the dimension that lies
// contiguous in memory.
template <bool kVec, Pass kPass>
struct Slice {
  float x[kXLoads];
  float4 wv[kWLoads / 4];
  float w[kVec ? 1 : kWLoads];

  // k0: the slice's first reduction index, K the reduction's length, rows
  // the tile's valid output rows, ldx x's row stride
  __device__ inline void load(const float* __restrict__ xe, const float* __restrict__ we,
                              int k0, int rows, int K, int ldx, int F, int f0) {
    const int tid = threadIdx.x;
#pragma unroll
    for (int u = 0; u < kXLoads; ++u) {
      const int i = tid + u * kGmmThreads;
      if constexpr (kPass == kDw) {  // x^T: slot kk, column r
        const int kk = i / kBC, r = i % kBC;
        x[u] = r < rows && k0 + kk < K ? xe[(int64_t)(k0 + kk) * ldx + r] : 0.f;
      } else {
        const int r = i / kBK, kk = i % kBK;
        x[u] = r < rows && k0 + kk < K ? xe[(int64_t)r * ldx + k0 + kk] : 0.f;
      }
    }
    if constexpr (kPass == kDx) {  // w^T: element (kk, f) at we[f * K + kk]
#pragma unroll
      for (int u = 0; u < kWLoads; ++u) {
        const int i = tid + u * kGmmThreads, kk = i % kBK, f = i / kBK;
        w[u] = k0 + kk < K && f0 + f < F ? we[(int64_t)f * K + k0 + kk] : 0.f;
      }
    } else if constexpr (kVec) {
      const int kk = tid / (kBF / kWLoads), f = (tid % (kBF / kWLoads)) * kWLoads;
      const bool ok = k0 + kk < K && f0 + f < F;
      const float* src = we + (int64_t)(k0 + kk) * F + f;
#pragma unroll
      for (int u = 0; u < kWLoads / 4; ++u)
        wv[u] = ok ? reinterpret_cast<const float4*>(src)[u] : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
#pragma unroll
      for (int u = 0; u < kWLoads; ++u) {
        const int i = tid + u * kGmmThreads, kk = i / kBF, f = i % kBF;
        w[u] = k0 + kk < K && f0 + f < F ? we[(int64_t)(k0 + kk) * F + f] : 0.f;
      }
    }
  }

  __device__ inline void store(float (*xs)[kBC + 1], float (*ws)[kLdW<kPass>]) const {
    const int tid = threadIdx.x;
#pragma unroll
    for (int u = 0; u < kXLoads; ++u) {
      const int i = tid + u * kGmmThreads;
      if constexpr (kPass == kDw)
        xs[i / kBC][i % kBC] = x[u];
      else
        xs[i % kBK][i / kBK] = x[u];
    }
    if constexpr (kPass == kDx) {
#pragma unroll
      for (int u = 0; u < kWLoads; ++u) {
        const int i = tid + u * kGmmThreads;
        ws[i % kBK][i / kBK] = w[u];
      }
    } else if constexpr (kVec) {
      const int kk = tid / (kBF / kWLoads), f = (tid % (kBF / kWLoads)) * kWLoads;
#pragma unroll
      for (int u = 0; u < kWLoads / 4; ++u)
        *reinterpret_cast<float4*>(&ws[kk][f + 4 * u]) = wv[u];
    } else {
#pragma unroll
      for (int u = 0; u < kWLoads; ++u) {
        const int i = tid + u * kGmmThreads;
        ws[i / kBF][i % kBF] = w[u];
      }
    }
  }
};

template <bool kVec, Pass kPass>
__global__ void __launch_bounds__(kGmmThreads, 4) gmm_kernel(
    const float* __restrict__ x, const float* __restrict__ w, const int* __restrict__ counts,
    float* __restrict__ out, int C, int D, int F) {
  __shared__ float xs[kBK][kBC + 1];                      // transposed x slice
  __shared__ __align__(16) float ws[kBK][kLdW<kPass>];    // w slice
  const int e = blockIdx.x, c0 = blockIdx.y * kBC, f0 = blockIdx.z * kBF;
  const int tid = threadIdx.x;
  const int count = min(max(counts[e], 0), C);
  const int M = kPass == kDw ? D : C;                     // output rows
  float* o = out + (int64_t)e * M * F;
  if (kPass == kDw ? count == 0 : c0 >= count) {  // an empty tile: zeros, and no weight is loaded
    for (int i = tid; i < kBC * kBF; i += kGmmThreads) {
      const int r = c0 + i / kBF, f = f0 + i % kBF;
      if (r < M && f < F) o[(int64_t)r * F + f] = 0.f;
    }
    return;
  }
  const int K = kPass == kDw ? count : D;                 // the reduction's length
  const float* xe = kPass == kDw ? x + (int64_t)e * C * D + c0 : x + ((int64_t)e * C + c0) * D;
  const float* we = kPass == kDx ? w + ((int64_t)e * F + f0) * D
                                 : w + (int64_t)e * (kPass == kDw ? C : D) * F + f0;
  const int rows = min(kBC, (kPass == kDw ? D : count) - c0);  // valid rows of this tile
  const int tx = tid & 15, ty = tid >> 4;        // columns tx*4.., rows ty*2..
  const bool busy = ty * 2 < rows;
  float acc[2][4] = {};

  Slice<kVec, kPass> slice;
  slice.load(xe, we, 0, rows, K, D, F, f0);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    slice.store(xs, ws);
    __syncthreads();
    // the next slice's loads are in flight while this one is multiplied
    if (k0 + kBK < K) slice.load(xe, we, k0 + kBK, rows, K, D, F, f0);
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
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = f0 + tx * 4 + j;
      if (f < F) o[(int64_t)r * F + f] = kPass == kDw || r < count ? acc[i][j] : 0.f;
    }
  }
}

// out (E, M, F) with M = D for kDw, else C; for kDx the arguments are the
// kernel's own: x the cotangent (E, C, D = the model's F), w (E, F, D)
template <Pass kPass>
cudaError_t launch_gmm_f32(const void* x, const void* w, const int* counts, void* out, int E,
                           int C, int D, int F, cudaStream_t stream) {
  const int M = kPass == kDw ? D : C;
  const dim3 grid(E, (M + kBC - 1) / kBC, (F + kBF - 1) / kBF);
  auto kernel = gmm_kernel<false, kPass>;
  // 16-byte row vectors need F % 8 == 0 and a 16-byte aligned base
  if constexpr (kPass != kDx)
    if (F % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0) kernel = gmm_kernel<true, kPass>;
  kernel<<<grid, kGmmThreads, 0, stream>>>(static_cast<const float*>(x),
                                           static_cast<const float*>(w), counts,
                                           static_cast<float*>(out), C, D, F);
  return cudaGetLastError();
}

// ---- bf16: mma.sync on the tensor cores -----------------------------------
using bf16 = __nv_bfloat16;

constexpr int kTcBK = 64;      // depth of one K slice
constexpr int kTcStages = 3;   // slices in the cp.async ring
constexpr int kTcLdA = kTcBK + 8;

// A block tile of WM x WN warps, each MT x NT MMA tiles of 16 x 8, at most
// 128 registers a thread so that kMinBlocks blocks fit on an SM.
template <int WM, int WN, int MT, int NT, int kMinBlocks_>
struct TcTile {
  static constexpr int kWN = WN, kMT = MT, kNT = NT, kMinBlocks = kMinBlocks_;
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int kBM = WM * MT * 16;
  static constexpr int kBN = WN * NT * 8;
  static constexpr int kLdB = kBN + 8;
  // B slices stored [k][n] (w as the forward reads it) or [n][k] (w^T, dX)
  template <bool kWT>
  static constexpr int kStageB = kWT ? kBN * kTcLdA : kTcBK * kLdB;
  template <bool kWT>
  static constexpr size_t kSmem = sizeof(bf16) * kTcStages * (kBM * kTcLdA + kStageB<kWT>);
};
using TcWide = TcTile<2, 4, 4, 4, 2>;    // 128 x 128, 8 warps of 64 x 32 (C > 128)
using TcMedium = TcTile<1, 4, 4, 4, 4>;  // 64 x 128, 4 warps of 64 x 32 (32 < C <= 128)
using TcNarrow = TcTile<1, 4, 1, 4, 4>;  // 16 x 128, 4 warps of 16 x 32 (C <= 32)

// One (C tile, F tile, expert) block of out = x @ w[e] (kWT false, w (E, D,
// F)) or out = x @ w[e]^T (kWT true, w (E, F, D) as it lies: the
// backward's dX, with the cotangent as x).  D is the reduction.
template <typename Tile, bool kVec, bool kWT>
__device__ __forceinline__ void gmm_tc_tile(const bf16* __restrict__ x,
                                            const bf16* __restrict__ w,
                                            const int* __restrict__ counts,
                                            bf16* __restrict__ out, int C, int D, int F) {
  constexpr int kBM = Tile::kBM, kBN = Tile::kBN, kLdB = Tile::kLdB, kThr = Tile::kThreads;
  constexpr int kWN = Tile::kWN, kMT = Tile::kMT, kNT = Tile::kNT;
  constexpr int kStageB = Tile::template kStageB<kWT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* as = reinterpret_cast<bf16*>(smem_raw);  // [kTcStages][kBM][kTcLdA]
  bf16* bs = as + kTcStages * kBM * kTcLdA;      // [kTcStages][kStageB]
  const int c0 = blockIdx.x * kBM, f0 = blockIdx.y * kBN, e = blockIdx.z;
  const int tid = threadIdx.x;
  const int count = min(max(counts[e], 0), C);
  bf16* o = out + (int64_t)e * C * F;
  if (c0 >= count) {  // an empty tile: zeros, and no weight is loaded
    const bf16 zero = __float2bfloat16(0.f);
    for (int i = tid; i < kBM * kBN; i += kThr) {
      const int r = c0 + i / kBN, f = f0 + i % kBN;
      if (r < C && f < F) o[(int64_t)r * F + f] = zero;
    }
    return;
  }
  const int rows = min(kBM, count - c0);  // valid rows of this tile
  const bf16* xe = x + ((int64_t)e * C + c0) * D;
  const bf16* we = kWT ? w + ((int64_t)e * F + f0) * D : w + (int64_t)e * D * F + f0;

  // slice kt of x (rows past `rows` and columns past D zero) and of w
  // (rows past D and columns past F zero) into ring stage `stage`
  auto load = [&](int kt, int stage) {
    const int k0 = kt * kTcBK;
    bf16* ad = as + stage * kBM * kTcLdA;
    bf16* bd = bs + stage * kStageB;
    if constexpr (kVec) {
      for (int c = tid; c < kBM * (kTcBK / 8); c += kThr) {
        const int r = c / (kTcBK / 8), kk = (c % (kTcBK / 8)) * 8;
        const bool ok = r < rows && k0 + kk < D;
        cp_async16(ad + r * kTcLdA + kk, ok ? xe + (int64_t)r * D + k0 + kk : xe, ok);
      }
      if constexpr (kWT) {
        for (int c = tid; c < kBN * (kTcBK / 8); c += kThr) {
          const int n = c / (kTcBK / 8), kk = (c % (kTcBK / 8)) * 8;
          const bool ok = f0 + n < F && k0 + kk < D;
          cp_async16(bd + n * kTcLdA + kk, ok ? we + (int64_t)n * D + k0 + kk : we, ok);
        }
      } else {
        for (int c = tid; c < kTcBK * (kBN / 8); c += kThr) {
          const int r = c / (kBN / 8), n = (c % (kBN / 8)) * 8;
          const bool ok = k0 + r < D && f0 + n < F;
          cp_async16(bd + r * kLdB + n, ok ? we + (int64_t)(k0 + r) * F + n : we, ok);
        }
      }
    } else {  // element loads, stored before the barrier that publishes them
      const bf16 zero = __float2bfloat16(0.f);
      for (int i = tid; i < kBM * kTcBK; i += kThr) {
        const int r = i / kTcBK, kk = i % kTcBK;
        ad[r * kTcLdA + kk] = r < rows && k0 + kk < D ? xe[(int64_t)r * D + k0 + kk] : zero;
      }
      if constexpr (kWT) {
        for (int i = tid; i < kBN * kTcBK; i += kThr) {
          const int n = i / kTcBK, kk = i % kTcBK;
          bd[n * kTcLdA + kk] = f0 + n < F && k0 + kk < D ? we[(int64_t)n * D + k0 + kk] : zero;
        }
      } else {
        for (int i = tid; i < kTcBK * kBN; i += kThr) {
          const int r = i / kBN, n = i % kBN;
          bd[r * kLdB + n] = k0 + r < D && f0 + n < F ? we[(int64_t)(k0 + r) * F + n] : zero;
        }
      }
    }
  };

  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp / kWN, wn = warp % kWN;  // the warp's tile: rows wm*kMT*16, cols wn*kNT*8
  const bool busy = wm * kMT * 16 < rows;      // warps wholly past counts[e] skip the MMAs
  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int n_k = (D + kTcBK - 1) / kTcBK;
#pragma unroll
  for (int st = 0; st < kTcStages - 1; ++st) {
    if (st < n_k) load(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<kTcStages - 2>();  // slice kt landed
    __syncthreads();                 // ... for every thread; slice kt-1 is consumed
    const int nxt = kt + kTcStages - 1;
    if (nxt < n_k) load(nxt, nxt % kTcStages);  // into the stage slice kt-1 used
    cp_async_commit();
    if (!busy) continue;
    const bf16* at = as + (kt % kTcStages) * kBM * kTcLdA + (wm * kMT * 16 + (lane & 15)) * kTcLdA +
                     (lane >> 4) * 8;
    // [k][n] slices through ldmatrix.trans; [n][k] ones (kWT) through
    // ldmatrix, lanes 8-15 and 24-31 at k + 8, lanes 16-31 at n + 8
    const bf16* bt =
        kWT ? bs + (kt % kTcStages) * kStageB +
                  (wn * kNT * 8 + (lane & 7) + (lane >> 4) * 8) * kTcLdA + ((lane >> 3) & 1) * 8
            : bs + (kt % kTcStages) * kStageB +
                  ((lane & 7) + ((lane >> 3) & 1) * 8) * kLdB + wn * kNT * 8 + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk) {
      uint32_t a[kMT][4], b[kNT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) ldmatrix_x4(a[i], at + i * 16 * kTcLdA + kk * 16);
#pragma unroll
      for (int j = 0; j < kNT; j += 2) {
        uint32_t r[4];
        if constexpr (kWT)
          ldmatrix_x4(r, bt + j * 8 * kTcLdA + kk * 16);
        else
          ldmatrix_x4_trans(r, bt + kk * 16 * kLdB + j * 8);
        b[j][0] = r[0];
        b[j][1] = r[1];
        b[j + 1][0] = r[2];
        b[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }
  cp_async_wait<0>();

  // rows at or past counts[e] are written as exact zeros
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = c0 + wm * kMT * 16 + i * 16 + g + 8 * h;
      if (r >= C) continue;
      const bool live = r < count;
      bf16* orow = o + (int64_t)r * F;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int f = f0 + wn * kNT * 8 + j * 8 + 2 * t4;
        const float v0 = live ? acc[i][j][2 * h] : 0.f, v1 = live ? acc[i][j][2 * h + 1] : 0.f;
        if constexpr (kVec) {  // F % 8 == 0: f < F implies f + 1 < F
          if (f < F) *reinterpret_cast<uint32_t*>(orow + f) = pack_bf16(v0, v1);
        } else {
          if (f < F) orow[f] = __float2bfloat16(v0);
          if (f + 1 < F) orow[f + 1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

template <typename Tile, bool kVec>
__global__ void __launch_bounds__(Tile::kThreads, Tile::kMinBlocks) gmm_tc_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w, const int* __restrict__ counts,
    bf16* __restrict__ out, int C, int D, int F) {
  gmm_tc_tile<Tile, kVec, false>(x, w, counts, out, C, D, F);
}

// dX (E, C, D) = dy (E, C, F) @ w[e]^T: in the tile's names x is dy, its D
// the model's F and its F the model's D
template <typename Tile, bool kVec>
__global__ void __launch_bounds__(Tile::kThreads, Tile::kMinBlocks) gmm_dx_tc_kernel(
    const bf16* __restrict__ dy, const bf16* __restrict__ w, const int* __restrict__ counts,
    bf16* __restrict__ dx, int C, int F, int D) {
  gmm_tc_tile<Tile, kVec, true>(dy, w, counts, dx, C, F, D);
}

template <typename Tile, bool kWT>
cudaError_t launch_gmm_tc(const void* x, const void* w, const int* counts, void* out, int E,
                          int C, int D, int F, cudaStream_t stream) {
  const dim3 grid((C + Tile::kBM - 1) / Tile::kBM, (F + Tile::kBN - 1) / Tile::kBN, E);
  // 16-byte copies need D and F multiples of 8 and 16-byte aligned bases
  const bool vec = D % 8 == 0 && F % 8 == 0 &&
                   (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                    reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  auto kernel = kWT ? (vec ? gmm_dx_tc_kernel<Tile, true> : gmm_dx_tc_kernel<Tile, false>)
                    : (vec ? gmm_tc_kernel<Tile, true> : gmm_tc_kernel<Tile, false>);
  kernel<<<grid, Tile::kThreads, Tile::template kSmem<kWT>, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), counts,
      static_cast<bf16*>(out), C, D, F);
  return cudaGetLastError();
}

// the bf16 tile by C: 16 rows at C <= 32, 64 at C <= 128, 128 above
template <bool kWT>
cudaError_t launch_gmm_tc_by_c(const void* x, const void* w, const int* counts, void* out,
                               int E, int C, int D, int F, cudaStream_t stream) {
  if (C <= 32) return launch_gmm_tc<TcNarrow, kWT>(x, w, counts, out, E, C, D, F, stream);
  if (C <= 128) return launch_gmm_tc<TcMedium, kWT>(x, w, counts, out, E, C, D, F, stream);
  return launch_gmm_tc<TcWide, kWT>(x, w, counts, out, E, C, D, F, stream);
}

// ---- bf16 dW: x^T dy over each expert's count -----------------------------
constexpr int kDwLdA = TcWide::kBM + 8;  // A slices stored [k][m], x's rows as they lie
constexpr size_t kDwSmem = sizeof(bf16) * kTcStages * kTcBK * (kDwLdA + TcWide::kLdB);

// One (D tile, F tile, expert) block of dW[e] = x[e, :count]^T @ dy[e,
// :count]: TcWide's 128 x 128 tile and 8 warps of 64 x 32, the reduction
// over the count's slots in 64-slot slices.
template <bool kVec>
__global__ void __launch_bounds__(TcWide::kThreads, TcWide::kMinBlocks) gmm_dw_tc_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ dy, const int* __restrict__ counts,
    bf16* __restrict__ dw, int C, int D, int F) {
  constexpr int kBM = TcWide::kBM, kBN = TcWide::kBN, kLdB = TcWide::kLdB;
  constexpr int kThr = TcWide::kThreads, kWN = TcWide::kWN, kMT = TcWide::kMT,
                kNT = TcWide::kNT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* as = reinterpret_cast<bf16*>(smem_raw);  // [kTcStages][kTcBK][kDwLdA]
  bf16* bs = as + kTcStages * kTcBK * kDwLdA;    // [kTcStages][kTcBK][kLdB]
  const int m0 = blockIdx.x * kBM, f0 = blockIdx.y * kBN, e = blockIdx.z;
  const int tid = threadIdx.x;
  const int count = min(max(counts[e], 0), C);
  bf16* o = dw + (int64_t)e * D * F;
  if (count == 0) {  // an expert with no token: zeros, and nothing is loaded
    const bf16 zero = __float2bfloat16(0.f);
    for (int i = tid; i < kBM * kBN; i += kThr) {
      const int r = m0 + i / kBN, f = f0 + i % kBN;
      if (r < D && f < F) o[(int64_t)r * F + f] = zero;
    }
    return;
  }
  const bf16* xe = x + (int64_t)e * C * D + m0;
  const bf16* ge = dy + (int64_t)e * C * F + f0;

  // slots [k0, k0 + 64) of x's columns m0.. and of dy's columns f0..
  // (slots at or past count, columns past D or F zero) into stage `stage`
  auto load = [&](int kt, int stage) {
    const int k0 = kt * kTcBK;
    bf16* ad = as + stage * kTcBK * kDwLdA;
    bf16* bd = bs + stage * kTcBK * kLdB;
    if constexpr (kVec) {
      for (int c = tid; c < kTcBK * (kBM / 8); c += kThr) {
        const int r = c / (kBM / 8), m = (c % (kBM / 8)) * 8;
        const bool ok = k0 + r < count && m0 + m < D;
        cp_async16(ad + r * kDwLdA + m, ok ? xe + (int64_t)(k0 + r) * D + m : xe, ok);
      }
      for (int c = tid; c < kTcBK * (kBN / 8); c += kThr) {
        const int r = c / (kBN / 8), n = (c % (kBN / 8)) * 8;
        const bool ok = k0 + r < count && f0 + n < F;
        cp_async16(bd + r * kLdB + n, ok ? ge + (int64_t)(k0 + r) * F + n : ge, ok);
      }
    } else {  // element loads, stored before the barrier that publishes them
      const bf16 zero = __float2bfloat16(0.f);
      for (int i = tid; i < kTcBK * kBM; i += kThr) {
        const int r = i / kBM, m = i % kBM;
        ad[r * kDwLdA + m] = k0 + r < count && m0 + m < D ? xe[(int64_t)(k0 + r) * D + m] : zero;
      }
      for (int i = tid; i < kTcBK * kBN; i += kThr) {
        const int r = i / kBN, n = i % kBN;
        bd[r * kLdB + n] = k0 + r < count && f0 + n < F ? ge[(int64_t)(k0 + r) * F + n] : zero;
      }
    }
  };

  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp / kWN, wn = warp % kWN;  // the warp's tile: rows wm*kMT*16, cols wn*kNT*8
  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int n_k = (count + kTcBK - 1) / kTcBK;
#pragma unroll
  for (int st = 0; st < kTcStages - 1; ++st) {
    if (st < n_k) load(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<kTcStages - 2>();  // slice kt landed
    __syncthreads();                 // ... for every thread; slice kt-1 is consumed
    const int nxt = kt + kTcStages - 1;
    if (nxt < n_k) load(nxt, nxt % kTcStages);
    cp_async_commit();
    // A = x^T from [k][m] slices through ldmatrix.trans: lanes 8-15 and
    // 24-31 at m + 8, lanes 16-31 at k + 8; B as the forward reads w
    const bf16* at = as + (kt % kTcStages) * kTcBK * kDwLdA +
                     ((lane & 7) + (lane >> 4) * 8) * kDwLdA + wm * kMT * 16 +
                     ((lane >> 3) & 1) * 8;
    const bf16* bt = bs + (kt % kTcStages) * kTcBK * kLdB +
                     ((lane & 7) + ((lane >> 3) & 1) * 8) * kLdB + wn * kNT * 8 + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk) {
      uint32_t a[kMT][4], b[kNT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) ldmatrix_x4_trans(a[i], at + kk * 16 * kDwLdA + i * 16);
#pragma unroll
      for (int j = 0; j < kNT; j += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, bt + kk * 16 * kLdB + j * 8);
        b[j][0] = r[0];
        b[j][1] = r[1];
        b[j + 1][0] = r[2];
        b[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wm * kMT * 16 + i * 16 + g + 8 * h;
      if (r >= D) continue;
      bf16* orow = o + (int64_t)r * F;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int f = f0 + wn * kNT * 8 + j * 8 + 2 * t4;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if constexpr (kVec) {  // F % 8 == 0: f < F implies f + 1 < F
          if (f < F) *reinterpret_cast<uint32_t*>(orow + f) = pack_bf16(v0, v1);
        } else {
          if (f < F) orow[f] = __float2bfloat16(v0);
          if (f + 1 < F) orow[f + 1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

cudaError_t launch_gmm_dw_tc(const void* x, const void* dy, const int* counts, void* dw, int E,
                             int C, int D, int F, cudaStream_t stream) {
  const dim3 grid((D + TcWide::kBM - 1) / TcWide::kBM, (F + TcWide::kBN - 1) / TcWide::kBN, E);
  const bool vec = D % 8 == 0 && F % 8 == 0 &&
                   (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy) |
                    reinterpret_cast<uintptr_t>(dw)) % 16 == 0;
  auto kernel = vec ? gmm_dw_tc_kernel<true> : gmm_dw_tc_kernel<false>;
  kernel<<<grid, TcWide::kThreads, kDwSmem, stream>>>(static_cast<const bf16*>(x),
                                                      static_cast<const bf16*>(dy), counts,
                                                      static_cast<bf16*>(dw), C, D, F);
  return cudaGetLastError();
}

}  // namespace rt

// Once per process, when the library is bound: every grouped-GEMM
// instantiation (prepare_kernels).
extern "C" int rt_prepare_gmm() {
  using namespace rt;
  return prepare_kernels(
      {(const void*)gmm_kernel<true, kFwd>, (const void*)gmm_kernel<false, kFwd>,
       (const void*)gmm_kernel<false, kDx>, (const void*)gmm_kernel<true, kDw>,
       (const void*)gmm_kernel<false, kDw>, (const void*)gmm_tc_kernel<TcNarrow, true>,
       (const void*)gmm_tc_kernel<TcNarrow, false>, (const void*)gmm_tc_kernel<TcMedium, true>,
       (const void*)gmm_tc_kernel<TcMedium, false>, (const void*)gmm_tc_kernel<TcWide, true>,
       (const void*)gmm_tc_kernel<TcWide, false>, (const void*)gmm_dx_tc_kernel<TcNarrow, true>,
       (const void*)gmm_dx_tc_kernel<TcNarrow, false>,
       (const void*)gmm_dx_tc_kernel<TcMedium, true>,
       (const void*)gmm_dx_tc_kernel<TcMedium, false>,
       (const void*)gmm_dx_tc_kernel<TcWide, true>, (const void*)gmm_dx_tc_kernel<TcWide, false>,
       (const void*)gmm_dw_tc_kernel<true>, (const void*)gmm_dw_tc_kernel<false>});
}

// Plain C entry point bound with ctypes.  x (E, C, D), w (E, D, F) and out
// (E, C, F) are contiguous; counts is an (E,) int32 device array.  float32
// takes the CUDA-core kernel, bf16 the tensor-core kernel (16-row tiles at
// C <= 32, 64-row tiles at C <= 128, 128-row tiles above).  Returns
// cudaGetLastError() of the launch.
extern "C" int rt_gmm(const void* x, const void* w, const void* counts, void* out, int E,
                      int C, int D, int F, int dtype, void* stream) {
  using namespace rt;
  const int* cnt = static_cast<const int*>(counts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E == 0 || C == 0 || F == 0) return cudaSuccess;
  switch (dtype) {
    case F32:
      return launch_gmm_f32<kFwd>(x, w, cnt, out, E, C, D, F, s);
    case BF16:
      return launch_gmm_tc_by_c<false>(x, w, cnt, out, E, C, D, F, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The backward of rt_gmm, from the cotangent dy (E, C, F) of its output:
// dx (E, C, D), rows at or past counts[e] exact zeros, and dw (E, D, F),
// each contiguous in x's dtype; a null dx or dw skips that part.  dX takes
// rt_gmm's kernel and tile for the dtype, over w read as (E, F, D); dW the
// CUDA-core kDw pass (float32) or gmm_dw_tc_kernel (bf16).  Returns the
// first launch error.
extern "C" int rt_gmm_bwd(const void* x, const void* w, const void* counts, const void* dy,
                          void* dx, void* dw, int E, int C, int D, int F, int dtype,
                          void* stream) {
  using namespace rt;
  const int* cnt = static_cast<const int*>(counts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != F32 && dtype != BF16) return cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (dx != nullptr && E > 0 && C > 0 && D > 0)
    err = dtype == F32 ? launch_gmm_f32<kDx>(dy, w, cnt, dx, E, C, F, D, s)
                       : launch_gmm_tc_by_c<true>(dy, w, cnt, dx, E, C, F, D, s);
  if (err == cudaSuccess && dw != nullptr && E > 0 && D > 0 && F > 0)
    err = dtype == F32 ? launch_gmm_f32<kDw>(x, dy, cnt, dw, E, C, D, F, s)
                       : launch_gmm_dw_tc(x, dy, cnt, dw, E, C, D, F, s);
  return err;
}
