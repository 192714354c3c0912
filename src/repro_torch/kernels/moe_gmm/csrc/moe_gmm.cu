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
// exact float32 (each a fmaf in a fixed order).  One body serves the
// forward and both parts of the backward (see below): 256 threads, each
// with an 8 x 8 register tile, 16-deep slices double-buffered k-major in
// shared memory, so that a thread reads two float4 of each operand a k.
//
// The backward (rt_gmm_bwd) replaces no TPU kernel: the TPU package has
// none, JAX trains the MoE block through einsums and XLA's gradients.
// With the output's cotangent dy (E, C, F): dX (E, C, D) = dy[e, c] @
// w[e]^T for c < counts[e], exact zeros past it, and dW (E, D, F) = x[e,
// :counts[e]]^T @ dy[e, :counts[e]], zeros for an expert with no token.
// What bounds it on the H100: bytes.  At deepseek-moe-16b's training shape
// (E 64, C 240, D 2048, F 1408, about 192 live rows an expert) dX moves
// the 369 MB of weights, dy's live rows and all of dx (0.467 GB, 0.139 ms
// at 3.35 TB/s) for 70.9 GFLOP (0.072 ms at 989 TFLOP/s); dW reads the
// live rows of x and dy and writes the 369 MB of dW (0.454 GB).  So each
// weight byte should leave device memory once, dW's writes should run
// under its loads and products, and the products, half the bytes' time,
// have to overlap the copies.
//
// bf16 with D and F multiples of 8 and 16-byte aligned bases (every
// training shape): wgmma fed by TMA, warp-specialised (gmm_dx_wgmma_kernel,
// gmm_dw_wgmma_kernel; the building blocks in hopper.cuh).  One producer
// thread keeps a ring of 64-deep slices in flight; two consumer
// warpgroups multiply the slices that have landed.  The tensor maps see x,
// dy and dx as 3D (E, C, *) and w and dw as (E, D, F), so a box past C
// or past D or F is zero-filled by the hardware, never another expert's
// rows.  dX: a persistent grid walks (expert, D tile of 128) tiles that
// each hold all of the expert's live rows (up to 4 m64 sub-tiles; C
// above 256 takes more C tiles), so w[e] is read once, as it lies
// (K-major B, no transposed copy), and the next tile loads while the last
// one is stored.  Sub-tiles that start at or past counts[e] load nothing
// and issue no wgmma, and an expert with no token loads no weight; rows
// of a live sub-tile past counts[e] do load, but reach only their own
// output rows, which are written as exact zeros.  dW: a block per (D
// tile of 128, expert) keeps x's slots resident and walks the F tiles,
// each output tile leaving through a TMA store while the next one's
// products run; A and B are x's and dy's slots as they lie (MN-major,
// the transpose bits).  Slots from counts[e] to the last k16 step are
// zeroed in shared memory before it; later slots are not multiplied.
// The ring depths and tiles were chosen on the H100 (PERF.md, section 6).
// Other bf16 shapes take element loads into mma.sync tiles: dX the
// forward's tile over w read as it lies (gmm_dx_tc_kernel, tiles by C),
// dW gmm_dw_tc_kernel (128 x 128 tiles of (D, F), A through
// ldmatrix.trans); there rows at or past counts[e] are never read.  Each
// output element is summed by one thread (or one warpgroup) in one fixed
// order, with no atomics and no split of the reduction, so two calls are
// bitwise equal.  float32: gmm_kernel's other two passes (kDx, kDw), exact
// float32 products on CUDA cores: 141.8 GFLOP at the training shape, 2.115
// ms at the CUDA cores' 67 TFLOP/s, so operations, not bytes, bound it.
// dX runs 64 x 256 tiles over the live rows (the expert slowest in the
// grid, its 4 row tiles of one column tile next to each other, so w[e] is
// read from device memory about once), dW 128 x 128 tiles of (D, F) over
// the count's slots.
#include "hopper.cuh"
#include "tensor_core.cuh"
#include "tile_attention.cuh"  // dtype codes, prepare_kernels

namespace rt {

// ---- float32: FMAs on CUDA cores ------------------------------------------
// One body, three passes, each out (E, M, F) = A B over a reduction of
// length K.  kFwd: A = x[e] (C, D), B = w[e] (D, F), the rows capacity
// slots.  kDx (the backward's dX): A = the cotangent (E, C, D = the
// model's F), B = w[e]^T with w read as it lies, (E, F, D).  kDw (its dW):
// out (E, D, F) = x[e, :count]^T dy[e, :count], A = x^T, B = the cotangent
// (E, C, F) in w's place, the reduction over the count's slots.
enum Pass { kFwd, kDx, kDw };

constexpr int kGmmThreads = 256;
constexpr int kGmmBK = 16;  // depth of one shared-memory slice

// A block tile of kBM x kBN outputs, each thread 8 x 8 of them: rows ty *
// 8 .. + 7 and columns tx * 4 .. + 3 and kBN / 2 + tx * 4 .. + 3, 128
// registers, two blocks an SM.  dW: 128 x 128 tiles of (D, F), a warp 4
// ty by 8 tx.  The passes whose rows are capacity slots: 64 rows (counts
// run to about 192 of C 240 in training: three full tiles, where 128
// would leave a quarter of the second one empty) by 256 columns, a warp
// one ty by 32 tx, so that a warp whose 8 rows lie wholly past counts[e]
// skips its products.  Slices are k-major in shared memory, [k][m] and
// [k][n]; an operand that lies k-major in device memory (kDw's A, kFwd's
// and kDw's B) arrives by cp.async, the others through registers, 4
// threads a 64-byte run of a row (coalesced), and a transposing store.
// On the H100 at the training shape, 8 x 16 thread tiles, 8-deep slices,
// partial unrolling and one 16-byte piece a row per thread were all
// slower (PERF.md, section 6).
template <Pass kPass>
struct GmmTile {
  static constexpr int kBM = kPass == kDw ? 128 : 64;
  static constexpr int kBN = kPass == kDw ? 128 : 256;
  static constexpr int kTX = kBN / 8;                 // threads across the columns
  static constexpr int kWTX = kPass == kDw ? 8 : 32;  // a warp's threads across
  static constexpr int kWTY = 32 / kWTX;              // ... and down
  static constexpr int kWX = kTX / kWTX;              // warps across the columns
  static constexpr bool kAsyncA = kPass == kDw;
  static constexpr bool kAsyncB = kPass != kDx;
  static constexpr int kAElems = kBM * kGmmBK / kGmmThreads;  // a thread's share of a slice
  static constexpr int kBElems = kBN * kGmmBK / kGmmThreads;
};

// Element (kk, col) of a slice stored k-major with rows of ld floats: each
// group of 4 rows starts 8 floats further on, so that a transposing store
// by 8 consecutive columns x 4 row groups (a warp) hits 32 distinct banks,
// while a read at one kk keeps its offset a compile-time constant.
__host__ __device__ constexpr int slice_at(int kk, int col, int ld) {
  return kk * ld + 8 * (kk >> 2) + col;
}
template <int ld>
constexpr int kSliceSize = slice_at(kGmmBK, 0, ld);

// kVec: D and F multiples of 4 and x, w and out on 16 bytes, so every
// operand row and output row is a run of float4; else element loads and
// stores.
template <bool kVec, Pass kPass>
__global__ void __launch_bounds__(kGmmThreads, kVec ? 2 : 1) gmm_kernel(
    const float* __restrict__ x, const float* __restrict__ w, const int* __restrict__ counts,
    float* __restrict__ out, int C, int D, int F) {
  using T = GmmTile<kPass>;
  constexpr int kBM = T::kBM, kBN = T::kBN;
  constexpr int kSA = kSliceSize<kBM>, kSB = kSliceSize<kBN>;
  constexpr bool kAsyncA = kVec && T::kAsyncA, kAsyncB = kVec && T::kAsyncB;
  __shared__ __align__(16) float a_sm[2 * kSA];  // two stages of [kGmmBK][kBM]
  __shared__ __align__(16) float b_sm[2 * kSB];  // two stages of [kGmmBK][kBN]
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN, e = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int count = min(max(counts[e], 0), C);
  const int M = kPass == kDw ? D : C;  // output rows
  float* o = out + (int64_t)e * M * F;
  if (kPass == kDw ? count == 0 : m0 >= count) {  // an empty tile: zeros, and no weight is loaded
    for (int i = tid; i < kBM * kBN; i += kGmmThreads) {
      const int r = m0 + i / kBN, f = n0 + i % kBN;
      if (r < M && f < F) o[(int64_t)r * F + f] = 0.f;
    }
    return;
  }
  const int K = kPass == kDw ? count : D;                      // the reduction's length
  const int rows = min(kBM, (kPass == kDw ? D : count) - m0);  // rows of A to read
  const int cols = min(kBN, F - n0);
  // A(m, k) = xa[m * D + k] (kFwd, kDx) or xa[k * D + m] (kDw); B(k, n) =
  // wb[k * F + n] (kFwd, kDw) or wb[n * D + k] (kDx)
  const float* xa = kPass == kDw ? x + (int64_t)e * C * D + m0 : x + ((int64_t)e * C + m0) * D;
  const float* wb = kPass == kDx ? w + ((int64_t)e * F + n0) * D
                                 : w + (int64_t)e * (kPass == kDw ? C : D) * F + n0;
  const int wy = warp / T::kWX;
  const int ty = wy * T::kWTY + lane / T::kWTX, tx = (warp % T::kWX) * T::kWTX + lane % T::kWTX;
  const bool busy = wy * T::kWTY * 8 < rows;  // warps wholly past counts[e] skip the products

  // The next slice between its loads and its shared-memory stores: for an
  // operand that lies k-contiguous, float4 runs along k, 4 threads a row
  // (kVec), or elements, 16 threads a row; else elements along m or n.
  constexpr int kQ = kGmmBK / 4;  // float4 runs of a row in a slice
  constexpr int kAChunks = kBM * kQ, kBChunks = kBN * kQ;
  constexpr int kACopies = (kAChunks + kGmmThreads - 1) / kGmmThreads;  // a thread's chunks
  constexpr int kBCopies = (kBChunks + kGmmThreads - 1) / kGmmThreads;
  constexpr int kAV = kVec && !T::kAsyncA ? kACopies : 1;
  constexpr int kBV = kVec && !T::kAsyncB ? kBCopies : 1;
  float4 av[kAV], bv[kBV];
  float ae[kVec ? 1 : T::kAElems], be[kVec ? 1 : T::kBElems];
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  // element u of a thread's share: (row along m or n, kk)
  auto elem = [&](int u, bool k_contiguous, int width, int& rc, int& kk) {
    const int c = tid + u * kGmmThreads;
    if (k_contiguous) {
      rc = c / kGmmBK, kk = c % kGmmBK;
    } else {
      rc = c % width, kk = c / width;
    }
  };

  // slice k0 into stage st: the cp.async parts now, the rest into registers
  auto fetch = [&](int k0, int st) {
    if constexpr (kAsyncA) {  // A^T rows: chunk (kk, mq)
#pragma unroll
      for (int u = 0; u < kACopies; ++u) {
        const int c = tid + u * kGmmThreads, kk = c / (kBM / 4), mq = (c % (kBM / 4)) * 4;
        const bool ok = c < kAChunks && k0 + kk < K && mq < rows;
        if (c < kAChunks)  // nothing read from an invalid chunk's address
          cp_async16(a_sm + st * kSA + slice_at(kk, mq, kBM),
                     xa + (ok ? (int64_t)(k0 + kk) * D + mq : 0), ok);
      }
    } else if constexpr (kVec) {  // A rows along k: chunk (m, kq)
#pragma unroll
      for (int u = 0; u < kAV; ++u) {
        const int c = tid + u * kGmmThreads, m = c / kQ, kq = (c % kQ) * 4;
        av[u] = c < kAChunks && m < rows && k0 + kq < K
                    ? *reinterpret_cast<const float4*>(xa + (int64_t)m * D + k0 + kq)
                    : zero4;
      }
    } else {
#pragma unroll
      for (int u = 0; u < T::kAElems; ++u) {
        int m, kk;
        elem(u, kPass != kDw, kBM, m, kk);
        const int64_t at = kPass == kDw ? (int64_t)(k0 + kk) * D + m : (int64_t)m * D + k0 + kk;
        ae[u] = m < rows && k0 + kk < K ? xa[at] : 0.f;
      }
    }
    if constexpr (kAsyncB) {  // B rows: chunk (kk, nq)
#pragma unroll
      for (int u = 0; u < kBCopies; ++u) {
        const int c = tid + u * kGmmThreads, kk = c / (kBN / 4), nq = (c % (kBN / 4)) * 4;
        const bool ok = c < kBChunks && k0 + kk < K && nq < cols;
        if (c < kBChunks)
          cp_async16(b_sm + st * kSB + slice_at(kk, nq, kBN),
                     wb + (ok ? (int64_t)(k0 + kk) * F + nq : 0), ok);
      }
    } else if constexpr (kVec) {  // B^T rows along k: chunk (n, kq)
#pragma unroll
      for (int u = 0; u < kBV; ++u) {
        const int c = tid + u * kGmmThreads, n = c / kQ, kq = (c % kQ) * 4;
        bv[u] = c < kBChunks && n < cols && k0 + kq < K
                    ? *reinterpret_cast<const float4*>(wb + (int64_t)n * D + k0 + kq)
                    : zero4;
      }
    } else {
#pragma unroll
      for (int u = 0; u < T::kBElems; ++u) {
        int n, kk;
        elem(u, kPass == kDx, kBN, n, kk);
        const int64_t at = kPass == kDx ? (int64_t)n * D + k0 + kk : (int64_t)(k0 + kk) * F + n;
        be[u] = n < cols && k0 + kk < K ? wb[at] : 0.f;
      }
    }
  };
  // the register parts of the slice into stage st
  auto store = [&](int st) {
    if constexpr (!kAsyncA) {
      float* as = a_sm + st * kSA;
      if constexpr (kVec) {
#pragma unroll
        for (int u = 0; u < kAV; ++u) {
          const int c = tid + u * kGmmThreads, m = c / kQ, kq = (c % kQ) * 4;
          if (c >= kAChunks) break;
          as[slice_at(kq, m, kBM)] = av[u].x;
          as[slice_at(kq + 1, m, kBM)] = av[u].y;
          as[slice_at(kq + 2, m, kBM)] = av[u].z;
          as[slice_at(kq + 3, m, kBM)] = av[u].w;
        }
      } else {
#pragma unroll
        for (int u = 0; u < T::kAElems; ++u) {
          int m, kk;
          elem(u, kPass != kDw, kBM, m, kk);
          as[slice_at(kk, m, kBM)] = ae[u];
        }
      }
    }
    if constexpr (!kAsyncB) {
      float* bs = b_sm + st * kSB;
      if constexpr (kVec) {
#pragma unroll
        for (int u = 0; u < kBV; ++u) {
          const int c = tid + u * kGmmThreads, n = c / kQ, kq = (c % kQ) * 4;
          if (c >= kBChunks) break;
          bs[slice_at(kq, n, kBN)] = bv[u].x;
          bs[slice_at(kq + 1, n, kBN)] = bv[u].y;
          bs[slice_at(kq + 2, n, kBN)] = bv[u].z;
          bs[slice_at(kq + 3, n, kBN)] = bv[u].w;
        }
      } else {
#pragma unroll
        for (int u = 0; u < T::kBElems; ++u) {
          int n, kk;
          elem(u, kPass == kDx, kBN, n, kk);
          bs[slice_at(kk, n, kBN)] = be[u];
        }
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int n_k = (K + kGmmBK - 1) / kGmmBK;
  if (n_k > 0) {
    fetch(0, 0);
    store(0);
  }
  cp_async_commit();
  for (int kt = 0; kt < n_k; ++kt) {
    const int st = kt & 1;
    cp_async_wait<0>();  // slice kt landed
    __syncthreads();     // ... for every thread; slice kt - 1 is consumed
    const bool more = kt + 1 < n_k;
    if (more) fetch((kt + 1) * kGmmBK, st ^ 1);
    cp_async_commit();
    if (busy) {
      const float* at = a_sm + st * kSA + ty * 8;
      const float* bt = b_sm + st * kSB + tx * 4;
#pragma unroll
      for (int kk = 0; kk < kGmmBK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(at + slice_at(kk, 0, kBM));
        const float4 a1 = *reinterpret_cast<const float4*>(at + slice_at(kk, 4, kBM));
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float4 b0 = *reinterpret_cast<const float4*>(bt + slice_at(kk, 0, kBN));
        const float4 b1 = *reinterpret_cast<const float4*>(bt + slice_at(kk, kBN / 2, kBN));
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    if (more) store(st ^ 1);  // after the products: the loads had them to land
  }
  cp_async_wait<0>();

  // rows past counts[e] (kFwd, kDx) are written as exact zeros
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + ty * 8 + i;
    if (r >= M) continue;
    const bool live = kPass == kDw || r < count;
    float* orow = o + (int64_t)r * F + n0;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int c = tx * 4 + g * (kBN / 2);
      const float4 v = live ? make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                                          acc[i][4 * g + 3])
                            : zero4;
      if constexpr (kVec) {
        if (c < cols) *reinterpret_cast<float4*>(orow + c) = v;
      } else {
        if (c < cols) orow[c] = v.x;
        if (c + 1 < cols) orow[c + 1] = v.y;
        if (c + 2 < cols) orow[c + 2] = v.z;
        if (c + 3 < cols) orow[c + 3] = v.w;
      }
    }
  }
}

// out (E, M, F) with M = D for kDw, else C; for kDx the arguments are the
// kernel's own: x the cotangent (E, C, D = the model's F), w (E, F, D).
// The grid walks an expert's tiles together, the expert slowest and the
// row tiles fastest: an expert's w (kFwd, kDx) or its x and cotangent
// slots (kDw) stay in L2 while its other tiles read them.
template <Pass kPass>
cudaError_t launch_gmm_f32(const void* x, const void* w, const int* counts, void* out, int E,
                           int C, int D, int F, cudaStream_t stream) {
  using T = GmmTile<kPass>;
  const int M = kPass == kDw ? D : C;
  const dim3 grid((M + T::kBM - 1) / T::kBM, (F + T::kBN - 1) / T::kBN, E);
  const bool vec = D % 4 == 0 && F % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                    reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  auto kernel = vec ? gmm_kernel<true, kPass> : gmm_kernel<false, kPass>;
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
// backward's dX on unaligned shapes, with the cotangent as x, element
// loads only).  D is the reduction.
template <typename Tile, bool kVec, bool kWT>
__device__ __forceinline__ void gmm_tc_tile(const bf16* __restrict__ x,
                                            const bf16* __restrict__ w,
                                            const int* __restrict__ counts,
                                            bf16* __restrict__ out, int C, int D, int F) {
  static_assert(!(kVec && kWT), "aligned dX shapes take gmm_dx_wgmma_kernel");
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
      for (int c = tid; c < kTcBK * (kBN / 8); c += kThr) {
        const int r = c / (kBN / 8), n = (c % (kBN / 8)) * 8;
        const bool ok = k0 + r < D && f0 + n < F;
        cp_async16(bd + r * kLdB + n, ok ? we + (int64_t)(k0 + r) * F + n : we, ok);
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

// dX (E, C, D) = dy (E, C, F) @ w[e]^T on shapes TMA cannot describe: in
// the tile's names x is dy, its D the model's F and its F the model's D
template <typename Tile>
__global__ void __launch_bounds__(Tile::kThreads, Tile::kMinBlocks) gmm_dx_tc_kernel(
    const bf16* __restrict__ dy, const bf16* __restrict__ w, const int* __restrict__ counts,
    bf16* __restrict__ dx, int C, int F, int D) {
  gmm_tc_tile<Tile, false, true>(dy, w, counts, dx, C, F, D);
}

template <typename Tile, bool kWT>
cudaError_t launch_gmm_tc(const void* x, const void* w, const int* counts, void* out, int E,
                          int C, int D, int F, cudaStream_t stream) {
  const dim3 grid((C + Tile::kBM - 1) / Tile::kBM, (F + Tile::kBN - 1) / Tile::kBN, E);
  // 16-byte copies need D and F multiples of 8 and 16-byte aligned bases
  const bool vec = D % 8 == 0 && F % 8 == 0 &&
                   (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                    reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  auto kernel = kWT ? gmm_dx_tc_kernel<Tile>
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

// ---- bf16 dW on unaligned shapes: x^T dy over each expert's count ----------
constexpr int kDwLdA = TcWide::kBM + 8;  // A slices stored [k][m], x's rows as they lie
constexpr size_t kDwSmem = sizeof(bf16) * kTcStages * kTcBK * (kDwLdA + TcWide::kLdB);

// One (D tile, F tile, expert) block of dW[e] = x[e, :count]^T @ dy[e,
// :count]: TcWide's 128 x 128 tile and 8 warps of 64 x 32, the reduction
// over the count's slots in 64-slot slices of element loads.
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
  const bf16 zero = __float2bfloat16(0.f);
  if (count == 0) {  // an expert with no token: zeros, and nothing is loaded
    for (int i = tid; i < kBM * kBN; i += kThr) {
      const int r = m0 + i / kBN, f = f0 + i % kBN;
      if (r < D && f < F) o[(int64_t)r * F + f] = zero;
    }
    return;
  }
  const bf16* xe = x + (int64_t)e * C * D + m0;
  const bf16* ge = dy + (int64_t)e * C * F + f0;

  // slots [k0, k0 + 64) of x's columns m0.. and of dy's columns f0..
  // (slots at or past count, columns past D or F zero) into stage
  // `stage`, stored before the barrier that publishes them
  auto load = [&](int kt, int stage) {
    const int k0 = kt * kTcBK;
    bf16* ad = as + stage * kTcBK * kDwLdA;
    bf16* bd = bs + stage * kTcBK * kLdB;
    for (int i = tid; i < kTcBK * kBM; i += kThr) {
      const int r = i / kBM, m = i % kBM;
      ad[r * kDwLdA + m] = k0 + r < count && m0 + m < D ? xe[(int64_t)(k0 + r) * D + m] : zero;
    }
    for (int i = tid; i < kTcBK * kBN; i += kThr) {
      const int r = i / kBN, n = i % kBN;
      bd[r * kLdB + n] = k0 + r < count && f0 + n < F ? ge[(int64_t)(k0 + r) * F + n] : zero;
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
  for (int st = 0; st < kTcStages - 1; ++st)
    if (st < n_k) load(st, st);
  for (int kt = 0; kt < n_k; ++kt) {
    __syncthreads();  // slice kt is stored; slice kt-1 is consumed
    const int nxt = kt + kTcStages - 1;
    if (nxt < n_k) load(nxt, nxt % kTcStages);
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
        if (f < F) orow[f] = __float2bfloat16(acc[i][j][2 * h]);
        if (f + 1 < F) orow[f + 1] = __float2bfloat16(acc[i][j][2 * h + 1]);
      }
    }
  }
}

cudaError_t launch_gmm_dw_tc(const void* x, const void* dy, const int* counts, void* dw, int E,
                             int C, int D, int F, cudaStream_t stream) {
  const dim3 grid((D + TcWide::kBM - 1) / TcWide::kBM, (F + TcWide::kBN - 1) / TcWide::kBN, E);
  gmm_dw_tc_kernel<<<grid, TcWide::kThreads, kDwSmem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy), counts,
      static_cast<bf16*>(dw), C, D, F);
  return cudaGetLastError();
}

// ---- bf16 dX and dW on wgmma fed by TMA -----------------------------------
// Three warpgroups a block: two consumers that issue wgmma and write the
// output, and a producer whose one thread keeps a ring of TMA loads in
// flight.  A stage lands on its `full` barrier (the producer's
// arrive_expect_tx and the loads' bytes); each consumer warp arrives on
// its `empty` barrier once its products from the stage are done.  Every
// tile is 64 bf16 wide (128 bytes, swizzled), so one box is 64 x 64 = 8 KB.
constexpr int kWgThreads = 384;
constexpr int kBox = 64 * 64 * 2;

// the dynamic shared memory's first 1024-aligned byte (128-byte swizzle)
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// this thread's float32 pairs of one m64 x n128 accumulator, as bf16,
// into two swizzled 64 x 64 boxes at `out` (columns 0-63, 64-127); rows
// whose `live` is false are written as zeros
__device__ __forceinline__ void stage_tile(unsigned char* out, const float (&acc)[64],
                                           bool live0, bool live1) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + g + 8 * h;
    const bool live = h ? live1 : live0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float v0 = live ? acc[4 * j + 2 * h] : 0.f, v1 = live ? acc[4 * j + 2 * h + 1] : 0.f;
      *reinterpret_cast<uint32_t*>(out + (j / 8) * kBox + sw128(r, j % 8) + 4 * t4) =
          pack_bf16(v0, v1);
    }
  }
}

// dX: a persistent grid, one block an SM, walks the (expert, C tile of
// 256, D tile of 128) tiles, D fastest, so the blocks running together
// share an expert's dy rows in L2.  A tile holds every live row of its
// four m64 sub-tiles (C <= 256: all the expert's), so each weight byte
// leaves device memory once.  K = F in 64-wide slices: A the live
// sub-tiles of dy (E, C, F) as they lie, B w[e]'s 128 rows of (D, F) as
// they lie; both K-major.  Consumer warpgroup g owns sub-tiles 2g and 2g
// + 1 (2 x m64n128 accumulators); a sub-tile that starts at or past
// counts[e] is neither loaded nor multiplied.  The ring runs on across
// tiles: the next tile's slices load while the consumers store the last
// one, a sub-tile at a time, through TMA from staging boxes of their own.
constexpr int kDxBN = 128, kDxBM = 256, kDxStages = 4;
constexpr int kDxStage = 4 * kBox + kDxBN * 128;  // 32 KB of dy rows, 16 KB of w
constexpr size_t kDxSmem =
    1024 + kDxStages * kDxStage + 4 * kBox + 2 * kDxStages * sizeof(uint64_t);

__global__ void __launch_bounds__(kWgThreads, 1) gmm_dx_wgmma_kernel(
    const __grid_constant__ CUtensorMap dy_map,  // (F, C, E), boxes 64 x 64
    const __grid_constant__ CUtensorMap w_map,   // (F, D, E), boxes 64 x 128
    const __grid_constant__ CUtensorMap dx_map,  // (D, C, E), boxes 64 x 64
    const int* __restrict__ counts, int E, int C, int D, int F) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* staging = smem + kDxStages * kDxStage;  // 2 boxes a consumer
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 4 * kBox);
  uint64_t* empty = full + kDxStages;
  const int n_d = (D + kDxBN - 1) / kDxBN, n_c = (C + kDxBM - 1) / kDxBM;
  const int n_tiles = E * n_c * n_d, n_k = (F + 63) / 64;
  const int tid = threadIdx.x, wg = warp_uniform(tid >> 7);
  if (tid == 0) {
    for (int s = 0; s < kDxStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // tile t: its expert, first row and first column, the expert's count
  // (made warp-uniform where a whole warp asks: the consumers) and its
  // sub-tiles with a live row
  struct Tile {
    int e, c0, d0, count, live;
  };
  auto tile = [&](int t, bool whole_warp) {
    Tile u;
    u.d0 = t % n_d * kDxBN;
    u.c0 = t / n_d % n_c * kDxBM;
    u.e = t / (n_d * n_c);
    const int count = min(max(counts[u.e], 0), C);
    u.count = whole_warp ? warp_uniform(count) : count;
    u.live = min(max((u.count - u.c0 + 63) / 64, 0), 4);
    return u;
  };

  if (wg == 2) {  // the producer
    if (tid == 256) {
      int it = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const Tile u = tile(t, false);
        for (int kt = 0; u.live && kt < n_k; ++kt, ++it) {
          const int s = it % kDxStages;
          mbar_wait(&empty[s], ((it / kDxStages) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[s], u.live * kBox + kDxBN * 128);
          unsigned char* st = smem + s * kDxStage;
          for (int i = 0; i < u.live; ++i)
            tma_load_3d(st + i * kBox, &dy_map, &full[s], kt * 64, u.c0 + 64 * i, u.e);
          tma_load_3d(st + 4 * kBox, &w_map, &full[s], kt * 64, u.d0, u.e);
        }
      }
    }
    return;
  }

  unsigned char* out = staging + wg * 2 * kBox;
  const bool lead = (tid & 127) == 0;
  // one finished m64 sub-tile of rows r.. (this thread's rows r0 and r0 +
  // 8) out through the staging boxes, once the last store has read them
  auto store = [&](const float (&acc)[64], const Tile& u, int r, int r0) {
    if (lead) tma_store_wait_read<0>();
    bar_sync(2 + wg, 128);
    stage_tile(out, acc, r0 < u.count, r0 + 8 < u.count);
    fence_proxy_async();
    bar_sync(2 + wg, 128);
    if (lead) {
      for (int h = 0; h < 2; ++h)
        if (r < C && u.d0 + 64 * h < D)
          tma_store_3d(&dx_map, out + h * kBox, u.d0 + 64 * h, r, u.e);
      tma_store_commit();
    }
  };
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const Tile u = tile(t, true);
    float acc0[64], acc1[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
    const bool on0 = 2 * wg < u.live, on1 = 2 * wg + 1 < u.live;
    for (int kt = 0; u.live && kt < n_k; ++kt, ++it) {
      const int s = it % kDxStages;
      mbar_wait(&full[s], (it / kDxStages) & 1);
      const unsigned char* st = smem + s * kDxStage;
      wgmma_fence_acc(acc0);
      wgmma_fence_acc(acc1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // k16 steps: 32 bytes along the swizzled rows
        const uint64_t db = wgmma_desc(st + 4 * kBox + 32 * kk, 16, 1024);
        if (on0)
          wgmma_m64n128k16<0, 0>(acc0, wgmma_desc(st + 2 * wg * kBox + 32 * kk, 16, 1024), db);
        if (on1)
          wgmma_m64n128k16<0, 0>(acc1, wgmma_desc(st + (2 * wg + 1) * kBox + 32 * kk, 16, 1024),
                                 db);
      }
      wgmma_commit();
      wgmma_wait<1>();  // slice kt-1's products are done: release its stage
      wgmma_fence_acc(acc0);
      wgmma_fence_acc(acc1);
      if (kt > 0 && (tid & 31) == 0) mbar_arrive(&empty[(it - 1) % kDxStages]);
    }
    wgmma_wait<0>();
    wgmma_fence_acc(acc0);
    wgmma_fence_acc(acc1);
    if (u.live && (tid & 31) == 0) mbar_arrive(&empty[(it - 1) % kDxStages]);

    // rows at or past counts[e] are written as exact zeros; rows past C
    // are clipped by the store
    const int r = u.c0 + 128 * wg, r0 = r + 16 * ((tid >> 5) & 3) + ((tid & 31) >> 2);
    store(acc0, u, r, r0);
    store(acc1, u, r + 64, r0 + 64);
  }
  if (lead) tma_store_wait<0>();
}

// dW: one block per (D tile of 128, expert) walks the F tiles of 128, so
// its output tile leaves through a TMA store while the next tile's
// products run.  K = the expert's count in 64-slot slices: A x[e]'s
// slots of (C, D) as they lie, B dy[e]'s of (C, F), both MN-major (the
// transpose bits).  x's first four slices (C <= 256: all of them) load
// with the first F tile and stay resident, so x leaves L2 once a block
// rather than once an F tile; later slices ride each stage beside dy's.
// Consumer warpgroup g owns the tile's D rows 64 g.. (one m64n128
// accumulator).  The hardware zero-fills only past C, so slots from
// counts[e] up to the last k16 step (at most 15) are zeroed in shared
// memory before that step, in A and B: NaNs there would reach every
// output element.  Slots past that step are never multiplied.
constexpr int kDwBM = 128, kDwBN = 128, kDwStages = 4, kDwResident = 4;
constexpr int kDwStage = 4 * kBox;  // 2 boxes of dy slots, 2 of x slots past the resident ones
constexpr size_t kDwWgSmem = 1024 + kDwResident * 2 * kBox + kDwStages * kDwStage + 4 * kBox +
                             2 * kDwStages * sizeof(uint64_t);

// rows [r0, r1) of a 64-row swizzled box, zeroed by the warpgroup's 128 threads
__device__ __forceinline__ void zero_rows(unsigned char* box, int r0, int r1) {
  for (int i = threadIdx.x & 127; i < (r1 - r0) * 8; i += 128)
    *reinterpret_cast<uint4*>(box + (r0 + i / 8) * 128 + (i % 8) * 16) = make_uint4(0, 0, 0, 0);
}

__global__ void __launch_bounds__(kWgThreads, 1) gmm_dw_wgmma_kernel(
    const __grid_constant__ CUtensorMap x_map,   // (D, C, E), boxes 64 x 64
    const __grid_constant__ CUtensorMap dy_map,  // (F, C, E), boxes 64 x 64
    const __grid_constant__ CUtensorMap dw_map,  // (F, D, E), boxes 64 x 64
    const int* __restrict__ counts, int C, int D, int F) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* resident = align1024(smem_raw);                 // x's first slices
  unsigned char* ring = resident + kDwResident * 2 * kBox;
  unsigned char* staging = ring + kDwStages * kDwStage;          // 2 boxes a consumer
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 4 * kBox);
  uint64_t* empty = full + kDwStages;
  const int m0 = blockIdx.x * kDwBM, e = blockIdx.y;
  const int tid = threadIdx.x, wg = warp_uniform(tid >> 7);
  const int count = warp_uniform(min(max(counts[e], 0), C));
  const int n_k = (count + 63) / 64, n_f = (F + kDwBN - 1) / kDwBN;
  if (tid == 0) {
    for (int s = 0; s < kDwStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();
  // where slice kt of x lies, and whether the stage of F tile j loads it
  auto x_slice = [&](int kt, unsigned char* st) {
    return kt < kDwResident ? resident + kt * 2 * kBox : st + 2 * kBox;
  };
  auto loads_x = [&](int j, int kt) { return j == 0 || kt >= kDwResident; };

  if (wg == 2) {  // the producer
    if (tid == 256) {
      int it = 0;
      for (int j = 0; j < n_f; ++j)
        for (int kt = 0; kt < n_k; ++kt, ++it) {
          const int s = it % kDwStages;
          mbar_wait(&empty[s], ((it / kDwStages) & 1) ^ 1);
          const bool lx = loads_x(j, kt);
          mbar_arrive_expect_tx(&full[s], (lx ? 4 : 2) * kBox);
          unsigned char* st = ring + s * kDwStage;
          tma_load_3d(st, &dy_map, &full[s], j * kDwBN, 64 * kt, e);
          tma_load_3d(st + kBox, &dy_map, &full[s], j * kDwBN + 64, 64 * kt, e);
          if (lx) {
            unsigned char* xs = x_slice(kt, st);
            tma_load_3d(xs, &x_map, &full[s], m0, 64 * kt, e);
            tma_load_3d(xs + kBox, &x_map, &full[s], m0 + 64, 64 * kt, e);
          }
        }
    }
    return;
  }

  unsigned char* out = staging + wg * 2 * kBox;
  const bool lead = (tid & 127) == 0;
  int it = 0;
  for (int j = 0; j < n_f; ++j) {
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < n_k; ++kt, ++it) {
      const int s = it % kDwStages;
      mbar_wait(&full[s], (it / kDwStages) & 1);
      unsigned char* st = ring + s * kDwStage;
      unsigned char* xs = x_slice(kt, st);
      const int rows = min(64, count - 64 * kt);  // live slots of the slice
      const int n16 = (rows + 15) / 16;
      if (rows % 16) {  // the last slice: zero its slots past counts[e]
        if (loads_x(j, kt)) zero_rows(xs + wg * kBox, rows, 16 * n16);
        zero_rows(st + wg * kBox, rows, 16 * n16);
        fence_proxy_async();
        bar_sync(1, 256);
      }
      wgmma_fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // k16 steps: 16 rows of 128 bytes
        if (kk < n16)
          wgmma_m64n128k16<1, 1>(acc, wgmma_desc(xs + wg * kBox + 2048 * kk, kBox, 1024),
                                 wgmma_desc(st + 2048 * kk, kBox, 1024));
      wgmma_commit();
      wgmma_wait<1>();  // the previous slice's products are done: release its stage
      wgmma_fence_acc(acc);
      if (kt > 0 && (tid & 31) == 0) mbar_arrive(&empty[(it - 1) % kDwStages]);
    }
    wgmma_wait<0>();
    wgmma_fence_acc(acc);
    if (n_k > 0 && (tid & 31) == 0) mbar_arrive(&empty[(it - 1) % kDwStages]);

    // the previous tile's store has read the staging boxes before they
    // are written again
    if (lead) tma_store_wait_read<0>();
    bar_sync(2 + wg, 128);
    stage_tile(out, acc, true, true);
    fence_proxy_async();
    bar_sync(2 + wg, 128);
    if (lead) {
      for (int h = 0; h < 2; ++h)
        if (m0 + 64 * wg < D && j * kDwBN + 64 * h < F)
          tma_store_3d(&dw_map, out + h * kBox, j * kDwBN + 64 * h, m0 + 64 * wg, e);
      tma_store_commit();
    }
  }
  if (lead) tma_store_wait<0>();
}

// The tensor maps of one call and its two launches; a map that
// cuTensorMapEncodeTiled refuses is an error, before anything launches.
cudaError_t launch_gmm_bwd_wgmma(const void* x, const void* w, const int* counts,
                                 const void* dy, void* dx, void* dw, int E, int C, int D,
                                 int F, cudaStream_t stream) {
  CUtensorMap dy_map, w_map, dx_map, x_map, dw_map;
  cudaError_t err = bind_context();
  if (err == cudaSuccess) err = tensor_map_3d(&dy_map, dy, F, C, E, 64, 64);
  if (err == cudaSuccess && dx != nullptr) err = tensor_map_3d(&w_map, w, F, D, E, 64, 128);
  if (err == cudaSuccess && dx != nullptr) err = tensor_map_3d(&dx_map, dx, D, C, E, 64, 64);
  if (err == cudaSuccess && dw != nullptr) err = tensor_map_3d(&x_map, x, D, C, E, 64, 64);
  if (err == cudaSuccess && dw != nullptr) err = tensor_map_3d(&dw_map, dw, F, D, E, 64, 64);
  if (err != cudaSuccess) return err;
  if (dx != nullptr) {
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    const int n_tiles = E * ((C + kDxBM - 1) / kDxBM) * ((D + kDxBN - 1) / kDxBN);
    gmm_dx_wgmma_kernel<<<min(n_tiles, sms), kWgThreads, kDxSmem, stream>>>(
        dy_map, w_map, dx_map, counts, E, C, D, F);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess && dw != nullptr) {
    const dim3 grid((D + kDwBM - 1) / kDwBM, E);
    gmm_dw_wgmma_kernel<<<grid, kWgThreads, kDwWgSmem, stream>>>(x_map, dy_map, dw_map, counts,
                                                                  C, D, F);
    err = cudaGetLastError();
  }
  return err;
}

// TMA describes a nonempty bf16 tensor whose rows are multiples of 16
// bytes from a 16-byte aligned base
bool gmm_bwd_takes_wgmma(const void* x, const void* w, const void* dy, const void* dx,
                         const void* dw, int E, int C, int D, int F) {
  return E > 0 && C > 0 && D > 0 && F > 0 && D % 8 == 0 && F % 8 == 0 &&
         (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
          reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(dx) |
          reinterpret_cast<uintptr_t>(dw)) % 16 == 0;
}

}  // namespace rt

// Once per process, when the library is bound: every grouped-GEMM
// instantiation (prepare_kernels).
extern "C" int rt_prepare_gmm() {
  using namespace rt;
  return prepare_kernels(
      {(const void*)gmm_kernel<true, kFwd>, (const void*)gmm_kernel<false, kFwd>,
       (const void*)gmm_kernel<true, kDx>, (const void*)gmm_kernel<false, kDx>,
       (const void*)gmm_kernel<true, kDw>,
       (const void*)gmm_kernel<false, kDw>, (const void*)gmm_tc_kernel<TcNarrow, true>,
       (const void*)gmm_tc_kernel<TcNarrow, false>, (const void*)gmm_tc_kernel<TcMedium, true>,
       (const void*)gmm_tc_kernel<TcMedium, false>, (const void*)gmm_tc_kernel<TcWide, true>,
       (const void*)gmm_tc_kernel<TcWide, false>, (const void*)gmm_dx_tc_kernel<TcNarrow>,
       (const void*)gmm_dx_tc_kernel<TcMedium>, (const void*)gmm_dx_tc_kernel<TcWide>,
       (const void*)gmm_dw_tc_kernel, (const void*)gmm_dx_wgmma_kernel,
       (const void*)gmm_dw_wgmma_kernel});
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
// each contiguous in x's dtype; a null dx or dw skips that part.  bf16
// with D and F multiples of 8 and 16-byte aligned bases takes
// gmm_dx_wgmma_kernel and gmm_dw_wgmma_kernel; other bf16 shapes
// rt_gmm's element-load tile by C over w read as (E, F, D) and
// gmm_dw_tc_kernel; float32 the CUDA-core kDx and kDw passes.  Returns
// the first tensor-map or launch error.
extern "C" int rt_gmm_bwd(const void* x, const void* w, const void* counts, const void* dy,
                          void* dx, void* dw, int E, int C, int D, int F, int dtype,
                          void* stream) {
  using namespace rt;
  const int* cnt = static_cast<const int*>(counts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != F32 && dtype != BF16) return cudaErrorInvalidValue;
  if (dtype == BF16 && gmm_bwd_takes_wgmma(x, w, dy, dx, dw, E, C, D, F))
    return launch_gmm_bwd_wgmma(x, w, cnt, dy, dx, dw, E, C, D, F, s);
  cudaError_t err = cudaSuccess;
  if (dx != nullptr && E > 0 && C > 0 && D > 0)
    err = dtype == F32 ? launch_gmm_f32<kDx>(dy, w, cnt, dx, E, C, F, D, s)
                       : launch_gmm_tc_by_c<true>(dy, w, cnt, dx, E, C, F, D, s);
  if (err == cudaSuccess && dw != nullptr && E > 0 && D > 0 && F > 0)
    err = dtype == F32 ? launch_gmm_f32<kDw>(x, dy, cnt, dw, E, C, D, F, s)
                       : launch_gmm_dw_tc(x, dy, cnt, dw, E, C, D, F, s);
  return err;
}
