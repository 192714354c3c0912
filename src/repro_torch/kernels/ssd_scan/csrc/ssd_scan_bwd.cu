// The backward of the Mamba-2 SSD scan for Hopper (sm_90a): the gradient
// of kernels/ssd_scan/ops.py::ssd.
//
// The TPU package has no backward kernel: JAX trains through jax.grad of
// the plain ssd_chunked (src/repro/models/mamba2.py:112), the scan whose
// per-chunk step is the Pallas kernel src/repro/kernels/ssd_scan/
// ssd_scan.py::_ssd_chunk_kernel.  This is the gradient of the port's
// forward (csrc/ssd_scan.cu), in the forward's notation, per row b and head
// h with g = h / (H / G), all in float32:
//   h_s = exp(a_s) h_{s-1} + x'_s B_s^T,  y_s = h_s C_s,  x'_s = x_s dt'_s,
//   a_s = dt'_s A,  A = -exp(A_log[h]),  dt' zero at masked steps.
// With g_s = dL/dy_s the adjoint state runs backwards, G_s = g_s C_s^T +
// exp(a_{s+1}) G_{s+1} from the final state's gradient, and dC_s = h_s^T
// g_s, dB_s = G_s^T x'_s (both summed over the group's heads), dx'_s = G_s
// B_s, da_s = exp(a_s) <G_s, h_{s-1}>, dx = dx' dt', ddt = mask (<dx', x>
// + A da), dA_log = A sum dt' da, d initial state = exp(a_1) G_1.
//
// The states: the forward, when autograd records it, runs the scan with a
// checkpoint after every sub-chunk of K <= 16 steps (ops._SSD) and keeps
// them; both routes read the state entering each sub-chunk back, 4 B S H
// P N / K bytes (336 MB at mamba2-2.7b's training microbatch B 4, S 512,
// H 80, P 64, N 128: 0.1 ms of reads at 3.35 TB/s), where recomputing
// them would double the forward's products.
//
// Per sub-chunk of T = K steps, with cs the cumsum of a over its steps,
// L_ij = exp(cs_i - cs_j) for j <= i, h0 the state entering it and H the
// adjoint at its end:
//   - the step pairs C_i . B_j and g_i . x'_j; Z = h0^T g and W = H^T x'
//     (T x N, sums over P); V = H B^T (P x T, sums over N); <H, h0>;
//   - dx'_j = sum_{i >= j} (C_i . B_j) L_ij g_i + exp(cs_T - cs_j) V_j;
//     dB_j = sum_{i >= j} (g_i . x'_j) L_ij C_i + exp(cs_T - cs_j) W_j;
//     dC_i = sum_{j <= i} (g_i . x'_j) L_ij B_j + exp(cs_i) Z_i;
//   - da_k from every product whose decay spans step k: the outputs i >=
//     k against h0 (exp(cs_i) C_i . Z_i), the state against h0 and the
//     inputs j < k (exp(cs_T) <H, h0>, exp(cs_T - cs_j) B_j . W_j) and the
//     pairs i >= k > j ((C_i . B_j)(g_i . x'_j) L_ij).  The derivative of
//     cs summed backwards would give the same in exact arithmetic, but a
//     pair's term added to one step and taken from another cancels in
//     float32;
//   - the adjoint before the sub-chunk, exp(cs_T) H + U, U = sum_i
//     exp(cs_i) g_i C_i^T.
// Every exponent is of a difference cs_i - cs_j with j <= i, or of cs_i:
// at most 0, no overflow.  The parts of dB, dC (by head and P tile), ddt
// (by P tile) and dA_log (by block) go to float32 scratch, and
// ssd_scan_bwd_sum_kernel sums them over the group's heads, the P tiles
// and the blocks in a fixed order.  No atomics: two calls are bitwise
// equal.  A step with dt' = 0 gives dx, ddt and dB exactly 0.
//
// Both routes are chunk-parallel, in three launches.  Only H carries from
// one sub-chunk to the one before it, and H_{c-1} = exp(cs_T) H_c + U_c
// needs no other output of sub-chunk c, so the serial part is small: an
// adjoint kernel walks each row from the last step with H in registers
// and writes H at the end of every span of R sub-chunks (and the initial
// state's gradient); a span kernel, one block per (span, P tile, head,
// row), walks its span's sub-chunks from the last, from that H; then
// ssd_scan_bwd_sum_kernel, the fixed-order sums.
//
// What bounds it on the H100.  At that microbatch (x, B and C in bf16)
// the call must read x, dt, B, C, dy and the states (0.40 GB) and write
// dx, ddt, dB and dC (0.02 GB): 0.126 ms at 3.35 TB/s.  Its products are
// 8 P N per (row, step, head) for Z, W, V and U plus the step pairs, 11.8
// GFLOP: 0.176 ms at the float32 CUDA-core peak of 67 TFLOP/s, or, counted
// in the TF32 passes of the bf16 route below (3 for a product of two
// float32 operands, 2 for a float32 one with a bf16 one), 26.5 GFLOP: 0.054
// ms at 495 TFLOP/s.  So on the tensor cores the bytes bound it, on CUDA
// cores the operations.
//
// The bf16 route (x, B and C in bf16), on the tensor cores, spans of R =
// ops.BWD_SPAN (8) sub-chunks:
//   - kernel A (ssd_bwd_adjoint_kernel), one block of 8 warps per (P tile
//     of 64, N tile of up to 64, head, row), walks the row from the last
//     step in pieces of 64 steps with H in mma.sync accumulator registers
//     (16 rows of P and half the tile's columns a warp), adds U of the
//     whole piece as one product (k = 64) on the tensor cores, and writes H
//     at the end of every span;
//   - kernel B (ssd_bwd_span_kernel), one block of 8 warps per (span, P
//     tile, head, row): from that H it walks the span's sub-chunks from
//     the last, with H and h0 in shared memory and h0 of the next
//     sub-chunk fetched with cp.async behind the current one's work (and
//     for N <= 64, three blocks an SM, its x, dy, B and C too), every
//     product above in m16n8k8 TF32 (Z, W, V, the step pairs, then dB, dC
//     and dx' from the pairs, and U for the next H), the pairs' part of
//     da_k by all threads and the rest on warp 0.
// Split precision: a float32 operand (dy, h0, H, the pairs under L, the
// rows scaled by exp(cs)) is split into hi + lo, both TF32, and the
// product is hi hi + hi lo + lo hi (lo lo is below float32's rounding);
// a bf16 operand (x, B, C) is exact in TF32 and needs no lo, so C B^T is
// one pass.  No operand ever takes a single TF32 pass.  Every fragment is
// read at offsets fixed at compile time from a per-lane base, and with
// one or two tiles the passes go to separate accumulators.
//
// The float32 route (x, B and C in float32) has the same shape on CUDA
// cores, every product an fmaf in a fixed order (exact float32 products:
// the float32 card-vs-CPU training parity rests on them), in spans of R =
// ops.BWD_SPAN_F32 (4) sub-chunks, short enough to spread a row of 8:
//   - ssd_bwd_adjoint_f32_kernel, one block of 256 threads per (P tile of
//     64, N tile of up to 128, head, row), H in registers (4 rows by up to
//     8 columns a thread), dy and C of the piece before staged with
//     cp.async behind each piece of up to 64 steps;
//   - ssd_bwd_span_f32_kernel, one block of 256 threads per (span, P tile,
//     head, row), two blocks an SM up to N 128, H and h0 in shared memory
//     (rows of N + 4 floats), the next sub-chunk's h0 fetched with cp.async
//     behind the current one's work and, where two stages fit (N <= 64),
//     its x, dy, B and C too.  Every product is a register tile read as
//     float4 from shared rows, the warps split by role: Z, W', then dC and
//     dB on warps 0-3; V, C B^T, g x^T, the pairs, then dx' on warps 4-7;
//     U on all; the pairs' part of da_k on every thread, the rest on warp 0.
// Rows 6f and 6f' of PERF.md (chip_smoke.py phase 3) time the float32
// route at mamba2's and zamba2's training microbatch.
// P and N must be multiples of 4, N at most 256 (the wrapper checks).
#include <algorithm>

#include "tensor_core.cuh"
#include "tile_attention.cuh"

namespace rt {

constexpr int kBwdPT = 64;          // rows of P a block owns
constexpr int kBwdThreads = 256;    // 8 warps
constexpr int kBwdSub = 16;         // steps of a sub-chunk, at most
constexpr int kBwdMaxN = 256;       // state columns
constexpr int kLdp = kBwdPT + 4;    // float32 route: row stride of the (step, P) tiles
constexpr int kLdt = kBwdSub + 1;   // float32 route: row stride of the (step, step) tiles

// kW consecutive floats of shared memory (kW 1, 2 or 4) into v[0 .. kW)
template <int kW>
__device__ __forceinline__ void bwd_load(const float* p, float* v) {
  if constexpr (kW == 4) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
  } else if constexpr (kW == 2) {
    const float2 u = *reinterpret_cast<const float2*>(p);
    v[0] = u.x; v[1] = u.y;
  } else {
    v[0] = *p;
  }
}

// v[0 .. kW) to kW consecutive floats at p (kW 1, 2 or 4)
template <int kW>
__device__ __forceinline__ void bwd_store(float* p, const float* v) {
  if constexpr (kW == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (kW == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(const float4& u, const float4& w, float acc) {
  acc = fmaf(u.x, w.x, acc);
  acc = fmaf(u.y, w.y, acc);
  acc = fmaf(u.z, w.z, acc);
  return fmaf(u.w, w.w, acc);
}

struct BwdArgs {
  const void* x;
  int64_t x_sb, x_ss, x_sh, x_sp;
  const float* dt;
  int64_t dt_sb, dt_ss, dt_sh;
  const float* A_log;
  const void* B;
  int64_t b_sb, b_ss, b_sg, b_sn;
  const void* C;
  int64_t c_sb, c_ss, c_sg, c_sn;
  const unsigned char* mask;  // (B, S) bool, or null
  int64_t m_sb, m_ss;
  const float* init;  // (B, H, P, N), or null
  int64_t i_sb, i_sh, i_sp, i_sn;
  const float* dy;  // (B, S, H, P)
  int64_t g_sb, g_ss, g_sh, g_sp;
  const float* dfinal;  // (B, H, P, N), or null
  int64_t f_sb, f_sh, f_sp, f_sn;
  const float* states;  // (B, S / K, H, P, N) contiguous: after each sub-chunk
  float* dx;            // (B, S, H, P) contiguous
  float* dtp;           // (B, S, H, npt): ddt by P tile
  float* dbp;           // (B, S, H, npt, N): dB by head and P tile
  float* dcp;           // (B, S, H, npt, N): dC by head and P tile
  float* dap;           // (B, n_span, H, npt): dA_log by block
  float* dinit;         // (B, H, P, N) contiguous
  int S, H, G, P, N, K;
  float* hs;            // (B, n_span, H, P, N): H at every span's end
  int R, n_span;        // sub-chunks a span, spans a row
  __nv_bfloat16* dx16;  // bf16: dx (B, S, H, P) in bf16, in place of dx
};

// ---------------------------------------------------------------------------
// The bf16 route: kernels A and B
// ---------------------------------------------------------------------------
constexpr int kTcPT = 64;            // rows of P a block owns
constexpr int kTcSub = 16;           // steps of a sub-chunk, at most
constexpr int kAdjThreads = 256;     // kernel A: 8 warps, 16 rows of P and half the N tile each
constexpr int kSpanThreads = 256;    // kernel B: 8 warps
constexpr int kTcLdp = kTcPT + 4;    // row stride of the (step, P) tiles
constexpr int kTcLdt = kTcSub + 8;   // row stride of the (step, step) tiles

// The TF32 operand(s) of x: exact (a bf16 value: hi = x, no lo) or split,
// x = hi + lo with hi x rounded to TF32's 10 mantissa bits (to nearest,
// on the bits: no special case is needed for finite x) and lo = x - hi
// exact in float32 (|lo| <= 2^-11 |x|; the tensor core reads its top 19
// bits, so hi + lo holds x to about 2^-22).
template <bool kExact>
__device__ __forceinline__ void tf32_parts(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (kExact) {
    hi = __float_as_uint(x);
    lo = 0u;
  } else {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
  }
}

// d += a * b on one 16 x 8 x 8 tile: TF32 operands, float32 accumulators.
// Fragments (lane = 4 * g + t): A a0 (row g, col t), a1 (row g + 8, col
// t), a2 (row g, col t + 4), a3 (row g + 8, col t + 4); B b0 (k row t, col
// g), b1 (k row t + 4, col g); C/D as m16n8k16's (tensor_core.cuh).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[t] (16 x 8) += A (16 x 8 kSteps) B_t (8 kSteps x 8) for kN tiles t
// by one warp, the A fragments loaded once a k-step for all kN.  The
// operands are read through this lane's fragment positions, so that every
// offset is a constant of the unrolled loops: fa(ks, i, kk) is A at row g
// + 8 i, column 8 ks + t + 4 kk, and fb(u, ks, kk) is B_u at row 8 ks + t
// + 4 kk, column g (lane = 4 g + t).  An operand marked exact holds bf16
// values (or 0); a float32 one is split, and the passes are lo hi, hi lo
// and hi hi.  With one or two tiles the passes and the k-steps' parities
// go to separate accumulators, summed at the end, so that no chain of
// dependent products is longer than kSteps.
template <int kSteps, int kN, bool kExactA, bool kExactB, typename FA, typename FB>
__device__ __forceinline__ void mma_tiles(float (&acc)[kN][4], FA fa, FB fb) {
  constexpr bool kSplitAcc = kN <= 2;
  constexpr int kL = kSplitAcc ? (!kExactA) + (!kExactB) : 0;  // lo passes
  float hh[kN][4], lo[kN][kL > 0 ? kL : 1][4];
#pragma unroll
  for (int t = 0; t < kN; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      hh[t][e] = 0.f;
      lo[t][0][e] = 0.f;
      if constexpr (kL > 1) lo[t][kL - 1][e] = 0.f;
    }
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    uint32_t ah[4], al[4];
    tf32_parts<kExactA>(fa(ks, 0, 0), ah[0], al[0]);
    tf32_parts<kExactA>(fa(ks, 1, 0), ah[1], al[1]);
    tf32_parts<kExactA>(fa(ks, 0, 1), ah[2], al[2]);
    tf32_parts<kExactA>(fa(ks, 1, 1), ah[3], al[3]);
#pragma unroll
    for (int t = 0; t < kN; ++t) {
      uint32_t bh[2], bl[2];
      tf32_parts<kExactB>(fb(t, ks, 0), bh[0], bl[0]);
      tf32_parts<kExactB>(fb(t, ks, 1), bh[1], bl[1]);
      if constexpr (kSplitAcc) {
        if constexpr (!kExactA) mma_tf32(lo[t][0], al, bh[0], bh[1]);
        if constexpr (!kExactB) mma_tf32(lo[t][kL - 1], ah, bl[0], bl[1]);
        mma_tf32(ks & 1 ? hh[t] : acc[t], ah, bh[0], bh[1]);
      } else {
        if constexpr (!kExactA) mma_tf32(acc[t], al, bh[0], bh[1]);
        if constexpr (!kExactB) mma_tf32(acc[t], ah, bl[0], bl[1]);
        mma_tf32(acc[t], ah, bh[0], bh[1]);
      }
    }
  }
  if constexpr (kSplitAcc) {
#pragma unroll
    for (int t = 0; t < kN; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float l = kL > 0 ? lo[t][0][e] : 0.f;
        if constexpr (kL > 1) l += lo[t][1][e];
        acc[t][e] = (acc[t][e] + hh[t][e]) + l;
      }
  }
}

// mma_tiles for one tile: fb(ks, kk)
template <int kSteps, bool kExactA, bool kExactB, typename FA, typename FB>
__device__ __forceinline__ void mma_tile(float (&acc)[4], FA fa, FB fb) {
  float(&one)[1][4] = *reinterpret_cast<float(*)[1][4]>(&acc);
  mma_tiles<kSteps, 1, kExactA, kExactB>(one, fa,
                                         [&](int, int ks, int kk) { return fb(ks, kk); });
}

// The inclusive scan of a = dt' A over the sub-chunk's steps by warp 0,
// lanes 0 .. 15 (a = 0 past K, so cs there is cs_T); returns cs.
__device__ __forceinline__ float scan16(float v, int lane) {
#pragma unroll
  for (int o = 1; o < kTcSub; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// 8 bytes from device to shared memory, asynchronously (through L1); when
// !ok nothing is read and the 8 bytes are zero-filled (src must still be
// a valid address)
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 8 : 0)
               : "memory");
}

// The inclusive scan of v over lanes 0 .. 31 of a warp
__device__ __forceinline__ float scan32(float v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// Programmatic dependent launch (sm_90): a kernel launched with
// cudaLaunchAttributeProgrammaticStreamSerialization may start while the
// kernel before it on the stream finishes; grid_dep_wait() blocks until
// that kernel has completed and its writes are visible (a no-op without
// the attribute), and grid_dep_launch() lets the next kernel start.
__device__ __forceinline__ void grid_dep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void grid_dep_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// rows x (kBytes kCh bytes) of a row-major tile from src (row stride rs
// elements, unit element stride) into dst (row stride ld elements) with
// cp.async of kBytes (8 or 16) bytes by nthr threads: row r < nrows and
// chunk q < nq are read, the rest zero-filled.  Rows and src start on
// kBytes bytes (the wrapper sees to it).
template <typename T, int kRows, int kCh, int kBytes = 8>
__device__ __forceinline__ void stage_tile(T* dst, int ld, const T* src, int64_t rs, int nrows,
                                           int nq, int tid, int nthr) {
  constexpr int kPer = kBytes / sizeof(T);
#pragma unroll 4
  for (int i = tid; i < kRows * kCh; i += nthr) {
    const int r = i / kCh, q = i - r * kCh;
    const bool ok = r < nrows && q < nq;
    if constexpr (kBytes == 16) {
      cp_async16(dst + r * ld + q * kPer, ok ? src + r * rs + q * kPer : src, ok);
    } else {
      cp_async8(dst + r * ld + q * kPer, ok ? src + r * rs + q * kPer : src, ok);
    }
  }
}

// Kernel A: block (P tile and N tile blockIdx.x, head blockIdx.y, row
// blockIdx.z), 8 warps; warp w owns rows 16 (w % 4) .. + 15 of the P tile
// and half w / 4 of the tile's 8 kNT columns of H, kNT / 2 n-tiles of 8 in
// accumulator layout.
// Walks the row in pieces of up to 64 steps (the span of R sub-chunks, or
// R K / 64 pieces of it) from the last: at a span's end H goes to hs, then
// H = exp(cs_T) H + U with cs the cumsum over the piece's steps and U =
// sum_i exp(cs_i) g_i C_i^T as one product over the piece (k = 64;
// exp(cs_i) g_i split, C_i exact), so the walk is S / 64 products long.
// The piece before is staged with cp.async into the other of two buffers
// behind the products.
template <int kNT>
__global__ void __launch_bounds__(kAdjThreads, 3) ssd_bwd_adjoint_kernel(BwdArgs a) {
  constexpr int kCols = 8 * kNT, kNH = kNT / 2;  // columns; n-tiles a warp
  constexpr int kSpan = 64;                  // steps of a piece, at most
  constexpr int kLdg = kTcPT + 8;            // f32 dy, read as A^T: = 8 mod 32
  constexpr int kLdc = kCols + 8;            // bf16 C, read as B: = 8 mod 64
  constexpr int kStage = kSpan * kLdg + kSpan * kLdc / 2;  // floats a buffer
  extern __shared__ __align__(16) float sm[];
  float* ecs = sm + 2 * kStage;              // [64] exp(cs_i)
  float* decs = ecs + kSpan;                 // exp(cs_T)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int n_nt = (a.N + kCols - 1) / kCols;
  const int nti = blockIdx.x % n_nt, pti = blockIdx.x / n_nt;
  const int n0 = nti * kCols, p0 = pti * kTcPT, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (a.H / a.G);
  const int pt = min(kTcPT, a.P - p0), nc = min(kCols, a.N - n0);
  // pieces of pc sub-chunks (at most 64 steps), R / pc of them a span
  const int pc = min(a.R, 64 / a.K), L = pc * a.K, n_piece = (a.S / a.K + pc - 1) / pc;
  const float A = -expf(a.A_log[h]);
  const float* gg = a.dy + b * a.g_sb + h * a.g_sh + p0;
  const __nv_bfloat16* cg =
      static_cast<const __nv_bfloat16*>(a.C) + b * a.c_sb + g * a.c_sg + n0;
  const float* dtg = a.dt + b * a.dt_sb + h * a.dt_sh;
  const unsigned char* mg = a.mask != nullptr ? a.mask + b * a.m_sb : nullptr;
  const int64_t PN = (int64_t)a.P * a.N;
  const int rw = 16 * (warp & 3);     // this warp's first row of the P tile
  const int cw = 8 * kNH * (warp >> 2);  // and its first column

  // H = dL/d the final state (0 past the tile and N)
  float acc[kNH][4];
#pragma unroll
  for (int nt = 0; nt < kNH; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = rw + gq + (e >> 1) * 8, col = cw + 8 * nt + 2 * tq + (e & 1);
      acc[nt][e] = a.dfinal != nullptr && r < pt && col < nc
                       ? a.dfinal[b * a.f_sb + h * a.f_sh + (p0 + r) * a.f_sp +
                                  (n0 + col) * a.f_sn]
                       : 0.f;
    }

  // piece s's dy and C into buffer s % 2; warp 0: its dt and mask (steps
  // lane, lane + 32) into registers
  float dt0 = 0.f, dt1 = 0.f, mk0 = 0.f, mk1 = 0.f;
  auto stage = [&](int s) {
    float* gsm = sm + (s & 1) * kStage;
    __nv_bfloat16* csm = reinterpret_cast<__nv_bfloat16*>(gsm + kSpan * kLdg);
    const int t0 = s * L, rows = min(L, a.S - t0);
    stage_tile<float, kSpan, kTcPT / 4, 16>(gsm, kLdg, gg + t0 * a.g_ss, a.g_ss, rows, pt / 4,
                                            tid, kAdjThreads);
    stage_tile<__nv_bfloat16, kSpan, kCols / 4>(csm, kLdc, cg + t0 * a.c_ss, a.c_ss, rows,
                                                nc / 4, tid, kAdjThreads);
    cp_async_commit();
    if (warp == 0) {  // independent loads: used at the next span
      auto live = [&](int i) {
        return i < rows && (mg == nullptr || mg[(t0 + i) * a.m_ss]) ? 1.f : 0.f;
      };
      mk0 = live(lane);
      mk1 = live(lane + 32);
      dt0 = lane < rows ? dtg[(t0 + lane) * a.dt_ss] : 0.f;
      dt1 = lane + 32 < rows ? dtg[(t0 + lane + 32) * a.dt_ss] : 0.f;
    }
  };
  stage(n_piece - 1);
  for (int s = n_piece - 1; s >= 0; --s) {
    if (s == 0) grid_dep_launch();  // kernel B may start its prologue
    if (warp == 0) {  // cs over the piece's steps
      const float v0 = scan32(mk0 != 0.f ? dt0 * A : 0.f, lane);
      const float v1 =
          scan32(mk1 != 0.f ? dt1 * A : 0.f, lane) + __shfl_sync(0xffffffffu, v0, 31);
      ecs[lane] = expf(v0);
      ecs[lane + 32] = expf(v1);
      const float last = __shfl_sync(0xffffffffu, v1, 31);
      if (lane == 0) *decs = expf(last);
    }
    if (s > 0) {
      stage(s - 1);  // the buffer's last readers finished at the barrier below
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // piece s's tiles and decays are ready
    if (((s + 1) * pc) % a.R == 0 || s == n_piece - 1) {  // H at the end of a span
      float* dst = a.hs + (((int64_t)b * a.n_span + s * pc / a.R) * a.H + h) * PN +
                   (int64_t)p0 * a.N + n0;
#pragma unroll
      for (int nt = 0; nt < kNH; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = rw + gq + 8 * hf, col = cw + 8 * nt + 2 * tq;
          if (r < pt && col < nc)
            *reinterpret_cast<float2*>(dst + (int64_t)r * a.N + col) =
                make_float2(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
        }
    }
    const float* gsm = sm + (s & 1) * kStage;
    const __nv_bfloat16* csm = reinterpret_cast<const __nv_bfloat16*>(gsm + kSpan * kLdg);
    const float d = *decs;
#pragma unroll
    for (int nt = 0; nt < kNH; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] *= d;
    {
      const float* ep = ecs + tq;
      const float* gp = gsm + tq * kLdg + rw + gq;
      const __nv_bfloat16* cp = csm + tq * kLdc + cw + gq;
      mma_tiles<kSpan / 8, kNH, false, true>(
          acc,
          [&](int ks, int i, int kk) {
            return ep[8 * ks + 4 * kk] * gp[(8 * ks + 4 * kk) * kLdg + 8 * i];
          },
          [&](int nt, int ks, int kk) {
            return __bfloat162float(cp[(8 * ks + 4 * kk) * kLdc + 8 * nt]);
          });
    }
    __syncthreads();  // the buffer and the decays are read
  }
  // d initial state = H before the first piece
  float* dst = a.dinit + ((int64_t)b * a.H + h) * PN + (int64_t)p0 * a.N + n0;
#pragma unroll
  for (int nt = 0; nt < kNH; ++nt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = rw + gq + 8 * hf, col = cw + 8 * nt + 2 * tq;
      if (r < pt && col < nc)
        *reinterpret_cast<float2*>(dst + (int64_t)r * a.N + col) =
            make_float2(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
    }
}

// Kernel A's dynamic shared memory, bytes: two buffers of 64 steps of dy
// and C, and the decays
__host__ __device__ constexpr size_t adjoint_smem_bytes(int n_cols) {
  return sizeof(float) * (2 * (64 * (kTcPT + 8) + 64 * (n_cols + 8) / 2) + 64 + 4);
}

// Kernel B's buffers of a sub-chunk's x, dy, B and C: two (the next one
// staged behind the current one) where three blocks an SM still fit
__host__ __device__ constexpr int span_stages(int n_pad) { return n_pad <= 64 ? 2 : 1; }

// Kernel B's shared memory, bytes, with n_pad state columns: h0 and H
// (float32 [64][n_pad + 8], read as B: stride = 8 mod 32), the stages of
// dy (float32 [16][68], read as A: = 4 mod 32), x (bf16 [16][72]), B and C
// (bf16 [16][n_pad + 8], read as A and B: = 8 mod 64), three (step, step)
// tiles, the decays and the warps' parts.
__host__ __device__ constexpr size_t span_smem_bytes(int n_pad) {
  return sizeof(float) * (2 * (size_t)kTcPT * (n_pad + 8) + span_stages(n_pad) * kTcSub * kTcLdp +
                          3 * kTcSub * kTcLdt + 6 * kTcSub + 2 * 8 * kTcSub + 4 * kTcSub + 16) +
         2 * span_stages(n_pad) * (kTcSub * (kTcPT + 8) + 2 * (size_t)kTcSub * (n_pad + 8));
}

// Kernel B: block (span and P tile blockIdx.x, head blockIdx.y, row
// blockIdx.z), 8 warps.  Walks sub-chunks c_hi - 1 .. c_lo of span
// blockIdx.x / npt from kernel A's H at the span's end (its states and
// first tiles are staged before it waits for kernel A).  Per sub-chunk,
// once the next sub-chunk's x, dy, B and C are staged with cp.async (two
// buffers, N <= 64):
//   phase 1 (tensor cores): warp w owns n-tiles w, w + 8, .. of Z = g h0
//     (3 passes) and W' = x H (2; W = dt' W'), the (P rows 16 (w % 4),
//     steps 8 (w / 4)) tile of V = H B^T (2), warps 0-1 an n-tile of C B^T
//     (1) and warps 2-3 one of g x^T (2); <H, h0> by every thread;
//   then the next sub-chunk's h0 is staged with cp.async (h0 is read);
//   phase 2: the pairs under L, one (i, j) a thread; each warp's part of
//     the rows' C_i . Z_i and B_j . W'_j;
//   phase 3 (tensor cores): from the accumulators of phase 1, dB = exp(cs_T
//     - cs) W + (ML)^T C and dC = exp(cs) Z + ML B, then dx'^T = exp(cs_T -
//     cs) V + g^T S (3 passes), dx and dx' . x; then H = exp(cs_T) H + U
//     for the sub-chunk before (warp w: rows 16 (w % 4), half w / 4 of N);
//   the pairs' part of da_k by every thread;
//   then (one buffer, N > 64) the next sub-chunk's x, dy, B and C are
//   staged with cp.async;
//   phase 4 (warp 0): da_k, ddt and the block's dA_log part.
template <int kNR>
__global__ void __launch_bounds__(kSpanThreads, kNR <= 4 ? 3 : kNR <= 8 ? 2 : 1)
    ssd_bwd_span_kernel(BwdArgs a) {
  constexpr int kNPad = 16 * kNR, kNT = kNPad / 8;
  constexpr int kLdh = kNPad + 8, kLdn = kNPad + 8, kLdx = kTcPT + 8, kC4 = kNPad / 4;
  constexpr int kNTW = kNT >= 8 ? kNT / 8 : 1;  // Z / W n-tiles a warp
  constexpr int kNTH = kNT / 2;                 // H update n-tiles a warp
  extern __shared__ __align__(16) float sm[];
  float* hin = sm;                        // [64][kLdh] h0
  float* hb = hin + kTcPT * kLdh;         // [64][kLdh] H
  constexpr int kStages = span_stages(kNPad);
  float* gs2 = hb + kTcPT * kLdh;         // [kStages][16][kTcLdp] g = dy
  float* sc = gs2 + kStages * kTcSub * kTcLdp;  // [16][kTcLdt] C_i . B_j, then S = (C_i . B_j) L_ij
  float* ml = sc + kTcSub * kTcLdt;       // [16][kTcLdt] g_i . x_j, then ML = (g_i . x'_j) L_ij
  float* tt = ml + kTcSub * kTcLdt;       // [16][kTcLdt] S_ij (g_i . x'_j)
  float* cum = tt + kTcSub * kTcLdt;      // [16] cs
  float* ec = cum + kTcSub;               // [16] exp(cs_i)
  float* wt = ec + kTcSub;                // [16] exp(cs_T - cs_j)
  float* dtm = wt + kTcSub;               // [16] dt'
  float* mk = dtm + kTcSub;               // [16] the mask, 1 or 0
  float* pr = mk + kTcSub;                // [16] sum_{i >= k > j} TT_ij
  float* yop = pr + kTcSub;               // [8][16] C_i . Z_i by warp
  float* uup = yop + 8 * kTcSub;          // [8][16] B_j . W'_j by warp
  float* dxp = uup + 8 * kTcSub;          // [4][16] dx' . x by 16 rows of P
  float* red = dxp + 4 * kTcSub;          // [8] <H, h0> by warp
  float* dec = red + 8;                   // exp(cs_T)
  // kStages buffers of [16][kLdx] x, [16][kLdn] B, [16][kLdn] C
  __nv_bfloat16* xs2 = reinterpret_cast<__nv_bfloat16*>(dec + 8);
  __nv_bfloat16* bs2 = xs2 + kStages * kTcSub * kLdx;
  __nv_bfloat16* cs2 = bs2 + kStages * kTcSub * kLdn;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int npt = (a.P + kTcPT - 1) / kTcPT;
  const int pti = blockIdx.x % npt, span = blockIdx.x / npt;
  const int p0 = pti * kTcPT, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (a.H / a.G);
  const int pt = min(kTcPT, a.P - p0);
  const int K = a.K, N = a.N, n_sub = a.S / K;
  const int c_lo = span * a.R, c_hi = min(c_lo + a.R, n_sub);
  const float A = -expf(a.A_log[h]);
  const __nv_bfloat16* xg =
      static_cast<const __nv_bfloat16*>(a.x) + b * a.x_sb + h * a.x_sh + p0;
  const __nv_bfloat16* bg = static_cast<const __nv_bfloat16*>(a.B) + b * a.b_sb + g * a.b_sg;
  const __nv_bfloat16* cg = static_cast<const __nv_bfloat16*>(a.C) + b * a.c_sb + g * a.c_sg;
  const float* dtg = a.dt + b * a.dt_sb + h * a.dt_sh;
  const float* gg = a.dy + b * a.g_sb + h * a.g_sh + p0;
  const unsigned char* mg = a.mask != nullptr ? a.mask + b * a.m_sb : nullptr;
  const int64_t PN = (int64_t)a.P * N;
  const int mt = warp & 3, jt = warp >> 2;  // this warp's V / dx' tile
  auto bf = [](__nv_bfloat16 v) { return __bfloat162float(v); };

  // rows of this P tile of a (P, N) float32 state into a [64][kLdh] tile,
  // asynchronously (0 past the tile and N): thread tid copies 16 bytes of
  // rows tid / kC4 + kRowsPer u
  constexpr int kRowsPer = kSpanThreads / kC4;
  const int sp = tid / kC4, sn = (tid % kC4) * 4;
  auto stage_state = [&](float* dst, const float* src) {
    const float* from = src + (int64_t)sp * N + sn;
#pragma unroll
    for (int u = 0; u < kTcPT / kRowsPer; ++u) {
      const bool ok = sn < N && sp + u * kRowsPer < pt;
      cp_async16(dst + (sp + u * kRowsPer) * kLdh + sn,
                 ok ? from + (int64_t)u * kRowsPer * N : src, ok);
    }
  };
  // h0 of sub-chunk c: the forward's state after sub-chunk c - 1, else the
  // initial state or 0
  auto stage_h0 = [&](int c) {
    if (c > 0) {
      stage_state(hin, a.states + (((int64_t)b * n_sub + c - 1) * a.H + h) * PN +
                           (int64_t)p0 * N);
    } else {
      for (int i = tid; i < kTcPT * kNPad; i += kSpanThreads) {
        const int p = i / kNPad, n = i - p * kNPad;
        hin[p * kLdh + n] =
            a.init != nullptr && p < pt && n < N
                ? a.init[b * a.i_sb + h * a.i_sh + (p0 + p) * a.i_sp + n * a.i_sn]
                : 0.f;
      }
    }
    cp_async_commit();
  };
  // sub-chunk c's x, dy, B and C into buffer c % 2 (0 past K, the tile and
  // N); warp 0: its dt' and mask into registers
  float dtv = 0.f, mkv = 0.f;
  auto stage_steps = [&](int c) {
    const int s0 = c * K, st = c & (kStages - 1);
    stage_tile<__nv_bfloat16, kTcSub, kTcPT / 4>(xs2 + st * kTcSub * kLdx, kLdx,
                                                 xg + s0 * a.x_ss, a.x_ss, K, pt / 4, tid,
                                                 kSpanThreads);
    stage_tile<float, kTcSub, kTcPT / 4, 16>(gs2 + st * kTcSub * kTcLdp, kTcLdp,
                                             gg + s0 * a.g_ss, a.g_ss, K, pt / 4, tid,
                                             kSpanThreads);
    stage_tile<__nv_bfloat16, kTcSub, kNPad / 4>(bs2 + st * kTcSub * kLdn, kLdn,
                                                 bg + s0 * a.b_ss, a.b_ss, K, N / 4, tid,
                                                 kSpanThreads);
    stage_tile<__nv_bfloat16, kTcSub, kNPad / 4>(cs2 + st * kTcSub * kLdn, kLdn,
                                                 cg + s0 * a.c_ss, a.c_ss, K, N / 4, tid,
                                                 kSpanThreads);
    cp_async_commit();
    if (warp == 0) {  // two independent loads: used at the next barrier
      mkv = lane < K && (mg == nullptr || mg[(s0 + lane) * a.m_ss]) ? 1.f : 0.f;
      dtv = lane < K ? dtg[(s0 + lane) * a.dt_ss] : 0.f;
    }
  };
  stage_h0(c_hi - 1);
  stage_steps(c_hi - 1);
  grid_dep_wait();  // kernel A's H (what comes before needs nothing of it)
  stage_state(hb, a.hs + (((int64_t)b * a.n_span + span) * a.H + h) * PN + (int64_t)p0 * N);
  cp_async_commit();

  float dA_acc = 0.f;  // warp 0: sum of dt' da over the span's steps
  for (int c = c_hi - 1; c >= c_lo; --c) {
    const int s0 = c * K;
    const int st = c & (kStages - 1);
    const float* gs = gs2 + st * kTcSub * kTcLdp;
    const __nv_bfloat16* xs = xs2 + st * kTcSub * kLdx;
    const __nv_bfloat16* bs = bs2 + st * kTcSub * kLdn;
    const __nv_bfloat16* cs = cs2 + st * kTcSub * kLdn;
    if (warp == 0) {  // dt', the mask and the decays
      const float dv = mkv != 0.f ? dtv : 0.f;
      const float v = scan16(dv * A, lane);
      const float last = __shfl_sync(0xffffffffu, v, kTcSub - 1);
      if (lane < kTcSub) {
        mk[lane] = mkv;
        dtm[lane] = dv;
        cum[lane] = v;
        ec[lane] = expf(v);
        wt[lane] = expf(last - v);
      }
      if (lane == 0) *dec = expf(last);
    }
    if (kStages == 2 && c > c_lo) {
      stage_steps(c - 1);  // behind this sub-chunk (its buffer's readers are done)
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // the tiles, h0, H and the decays are ready

    // phase 1
    float zacc[kNTW][4], wacc[kNTW][4], vacc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int q = 0; q < kNTW; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) zacc[q][e] = wacc[q][e] = 0.f;
    if (warp < kNT) {  // n-tiles warp + 8 q (kNT is 2, 4 or a multiple of 8)
      const float* ga = gs + gq * kTcLdp + tq;
      const float* hz = hin + tq * kLdh + 8 * warp + gq;
      mma_tiles<kTcPT / 8, kNTW, false, false>(
          zacc, [&](int ks, int i, int kk) { return ga[8 * i * kTcLdp + 8 * ks + 4 * kk]; },
          [&](int q, int ks, int kk) { return hz[(8 * ks + 4 * kk) * kLdh + 64 * q]; });
      const __nv_bfloat16* xa = xs + gq * kLdx + tq;
      const float* hw = hb + tq * kLdh + 8 * warp + gq;
      mma_tiles<kTcPT / 8, kNTW, true, false>(
          wacc, [&](int ks, int i, int kk) { return bf(xa[8 * i * kLdx + 8 * ks + 4 * kk]); },
          [&](int q, int ks, int kk) { return hw[(8 * ks + 4 * kk) * kLdh + 64 * q]; });
    }
    {
      const float* va = hb + (16 * mt + gq) * kLdh + tq;
      const __nv_bfloat16* vb = bs + (8 * jt + gq) * kLdn + tq;
      mma_tile<kNT, false, true>(
          vacc, [&](int ks, int i, int kk) { return va[8 * i * kLdh + 8 * ks + 4 * kk]; },
          [&](int ks, int kk) { return bf(vb[8 * ks + 4 * kk]); });
    }
    if (warp < 4) {
      float pacc[4] = {0.f, 0.f, 0.f, 0.f};
      const int j0 = 8 * (warp & 1);
      if (warp < 2) {
        const __nv_bfloat16* ca = cs + gq * kLdn + tq;
        const __nv_bfloat16* cb = bs + (j0 + gq) * kLdn + tq;
        mma_tile<kNT, true, true>(
            pacc, [&](int ks, int i, int kk) { return bf(ca[8 * i * kLdn + 8 * ks + 4 * kk]); },
            [&](int ks, int kk) { return bf(cb[8 * ks + 4 * kk]); });
      } else {
        const float* ga = gs + gq * kTcLdp + tq;
        const __nv_bfloat16* xb = xs + (j0 + gq) * kLdx + tq;
        mma_tile<kTcPT / 8, false, true>(
            pacc, [&](int ks, int i, int kk) { return ga[8 * i * kTcLdp + 8 * ks + 4 * kk]; },
            [&](int ks, int kk) { return bf(xb[8 * ks + 4 * kk]); });
      }
      float* dst = (warp < 2 ? sc : ml) + j0 + 2 * tq;
      dst[gq * kTcLdt] = pacc[0];
      dst[gq * kTcLdt + 1] = pacc[1];
      dst[(gq + 8) * kTcLdt] = pacc[2];
      dst[(gq + 8) * kTcLdt + 1] = pacc[3];
    }
    {
      float hd = 0.f;
#pragma unroll
      for (int u = 0; u < kTcPT / kRowsPer; ++u) {
        const int o = (sp + u * kRowsPer) * kLdh + sn;
        hd = dot4(*reinterpret_cast<const float4*>(hb + o),
                  *reinterpret_cast<const float4*>(hin + o), hd);
      }
      hd = warp_sum(hd);
      if (lane == 0) red[warp] = hd;
    }
    __syncthreads();  // h0 and H are read; C B^T and g x^T are ready
    if (c > c_lo) stage_h0(c - 1);  // behind this sub-chunk's work

    // phase 2: the pairs under L (0 above the diagonal and past K), each in
    // place by the thread that reads it
    {
      const int i = tid >> 4, j = tid & 15;
      float s = 0.f, m = 0.f, t = 0.f;
      if (j <= i && i < K) {
        const float L = expf(cum[i] - cum[j]);
        const float gx = ml[i * kTcLdt + j] * dtm[j];
        s = sc[i * kTcLdt + j] * L;
        m = gx * L;
        t = s * gx;
      }
      sc[i * kTcLdt + j] = s;
      ml[i * kTcLdt + j] = m;
      tt[i * kTcLdt + j] = t;
    }
    // this warp's parts of C_i . Z_i and B_j . W'_j (rows gq, gq + 8)
    {
      float y0 = 0.f, y1 = 0.f, u0 = 0.f, u1 = 0.f;
#pragma unroll
      for (int q = 0; q < kNTW; ++q) {
        const int n = 8 * (warp + 8 * q) + 2 * tq;
        if (warp < kNT) {
          y0 = fmaf(zacc[q][0], bf(cs[gq * kLdn + n]), y0);
          y0 = fmaf(zacc[q][1], bf(cs[gq * kLdn + n + 1]), y0);
          y1 = fmaf(zacc[q][2], bf(cs[(gq + 8) * kLdn + n]), y1);
          y1 = fmaf(zacc[q][3], bf(cs[(gq + 8) * kLdn + n + 1]), y1);
          u0 = fmaf(wacc[q][0], bf(bs[gq * kLdn + n]), u0);
          u0 = fmaf(wacc[q][1], bf(bs[gq * kLdn + n + 1]), u0);
          u1 = fmaf(wacc[q][2], bf(bs[(gq + 8) * kLdn + n]), u1);
          u1 = fmaf(wacc[q][3], bf(bs[(gq + 8) * kLdn + n + 1]), u1);
        }
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        y0 += __shfl_xor_sync(0xffffffffu, y0, o);
        y1 += __shfl_xor_sync(0xffffffffu, y1, o);
        u0 += __shfl_xor_sync(0xffffffffu, u0, o);
        u1 += __shfl_xor_sync(0xffffffffu, u1, o);
      }
      if (tq == 0) {
        yop[warp * kTcSub + gq] = y0;
        yop[warp * kTcSub + gq + 8] = y1;
        uup[warp * kTcSub + gq] = u0;
        uup[warp * kTcSub + gq + 8] = u1;
      }
    }
    __syncthreads();  // S, ML and TT are ready

    // phase 3: dB and dC of this head and tile, rows j = gq, gq + 8
    const float w0 = wt[gq] * dtm[gq], w1 = wt[gq + 8] * dtm[gq + 8];
    const float e0 = ec[gq], e1 = ec[gq + 8];
    if (warp < kNT) {
#pragma unroll
      for (int q = 0; q < kNTW; ++q) {
        wacc[q][0] *= w0, wacc[q][1] *= w0, wacc[q][2] *= w1, wacc[q][3] *= w1;
        zacc[q][0] *= e0, zacc[q][1] *= e0, zacc[q][2] *= e1, zacc[q][3] *= e1;
      }
      const float* mb = ml + tq * kTcLdt + gq;  // (ML)^T
      const __nv_bfloat16* cb = cs + tq * kLdn + 8 * warp + gq;
      mma_tiles<2, kNTW, false, true>(  // dB, in place of W
          wacc, [&](int ks, int i, int kk) { return mb[(8 * ks + 4 * kk) * kTcLdt + 8 * i]; },
          [&](int q, int ks, int kk) { return bf(cb[(8 * ks + 4 * kk) * kLdn + 64 * q]); });
      const float* mc = ml + gq * kTcLdt + tq;  // ML
      const __nv_bfloat16* bb = bs + tq * kLdn + 8 * warp + gq;
      mma_tiles<2, kNTW, false, true>(  // dC, in place of Z
          zacc, [&](int ks, int i, int kk) { return mc[8 * i * kTcLdt + 8 * ks + 4 * kk]; },
          [&](int q, int ks, int kk) { return bf(bb[(8 * ks + 4 * kk) * kLdn + 64 * q]); });
#pragma unroll
      for (int q = 0; q < kNTW; ++q) {
        const int n = 8 * (warp + 8 * q) + 2 * tq;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int j = gq + 8 * hf;
          if (j < K && n < N) {
            const int64_t o = ((((int64_t)b * a.S + s0 + j) * a.H + h) * npt + pti) * N + n;
            *reinterpret_cast<float2*>(a.dbp + o) =
                make_float2(wacc[q][2 * hf], wacc[q][2 * hf + 1]);
            *reinterpret_cast<float2*>(a.dcp + o) =
                make_float2(zacc[q][2 * hf], zacc[q][2 * hf + 1]);
          }
        }
      }
    }
    // the pairs' part of da_k, sum_{i >= k > j} TT_ij: thread (k, j), the
    // 16 lanes of a half warp summed
    {
      const int k = tid >> 4, j = tid & 15;
      float v = 0.f;
#pragma unroll
      for (int i = 1; i < kTcSub; ++i)
        if (j < k && i >= k) v += tt[i * kTcLdt + j];
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (j == 0) pr[k] = v;
    }
    // dx'^T (P rows 16 mt + gq (+ 8), steps j0, j0 + 1), dx = dx' dt', and
    // dx' . x summed over the 16 rows
    {
      const int j0 = 8 * jt + 2 * tq;
      float dxa[4] = {vacc[0] * wt[j0], vacc[1] * wt[j0 + 1], vacc[2] * wt[j0],
                      vacc[3] * wt[j0 + 1]};
      const float* gt = gs + tq * kTcLdp + 16 * mt + gq;  // g^T
      const float* sb = sc + tq * kTcLdt + 8 * jt + gq;
      mma_tile<2, false, false>(
          dxa, [&](int ks, int i, int kk) { return gt[(8 * ks + 4 * kk) * kTcLdp + 8 * i]; },
          [&](int ks, int kk) { return sb[(8 * ks + 4 * kk) * kTcLdt]; });
      float d0 = 0.f, d1 = 0.f;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int p = 16 * mt + gq + 8 * hf;
        d0 = fmaf(dxa[2 * hf], bf(xs[j0 * kLdx + p]), d0);
        d1 = fmaf(dxa[2 * hf + 1], bf(xs[(j0 + 1) * kLdx + p]), d1);
        if (p < pt) {
          __nv_bfloat16* o = a.dx16 + (((int64_t)b * a.S + s0 + j0) * a.H + h) * a.P + p0 + p;
          if (j0 < K) o[0] = __float2bfloat16(dxa[2 * hf] * dtm[j0]);
          if (j0 + 1 < K)
            o[(int64_t)a.H * a.P] = __float2bfloat16(dxa[2 * hf + 1] * dtm[j0 + 1]);
        }
      }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        d0 += __shfl_xor_sync(0xffffffffu, d0, o);
        d1 += __shfl_xor_sync(0xffffffffu, d1, o);
      }
      if (gq == 0) {
        dxp[mt * kTcSub + j0] = d0;
        dxp[mt * kTcSub + j0 + 1] = d1;
      }
    }
    // H = exp(cs_T) H + sum_i exp(cs_i) g_i C_i^T, the adjoint at the end
    // of sub-chunk c - 1 (no reader of H is left in this sub-chunk)
    if (c > c_lo) {
      constexpr int kG = kNTH < 4 ? kNTH : 4;  // n-tiles a product
      const float d = *dec;
#pragma unroll
      for (int q0 = 0; q0 < kNTH; q0 += kG) {
        float acc[kG][4];
#pragma unroll
        for (int t = 0; t < kG; ++t) {
          const float* r0 = hb + (16 * mt + gq) * kLdh + 8 * (jt * kNTH + q0 + t) + 2 * tq;
          const float2 u = *reinterpret_cast<const float2*>(r0);
          const float2 w = *reinterpret_cast<const float2*>(r0 + 8 * kLdh);
          acc[t][0] = u.x * d, acc[t][1] = u.y * d, acc[t][2] = w.x * d, acc[t][3] = w.y * d;
        }
        const float* ep = ec + tq;
        const float* gt = gs + tq * kTcLdp + 16 * mt + gq;
        const __nv_bfloat16* cu = cs + tq * kLdn + 8 * (jt * kNTH + q0) + gq;
        mma_tiles<2, kG, false, true>(
            acc,
            [&](int ks, int i, int kk) {
              return ep[8 * ks + 4 * kk] * gt[(8 * ks + 4 * kk) * kTcLdp + 8 * i];
            },
            [&](int t, int ks, int kk) { return bf(cu[(8 * ks + 4 * kk) * kLdn + 8 * t]); });
#pragma unroll
        for (int t = 0; t < kG; ++t) {
          float* r0 = hb + (16 * mt + gq) * kLdh + 8 * (jt * kNTH + q0 + t) + 2 * tq;
          *reinterpret_cast<float2*>(r0) = make_float2(acc[t][0], acc[t][1]);
          *reinterpret_cast<float2*>(r0 + 8 * kLdh) = make_float2(acc[t][2], acc[t][3]);
        }
      }
    }
    __syncthreads();  // the warps' parts are ready; the tiles are read
    if (kStages == 1 && c > c_lo) stage_steps(c - 1);  // behind phase 4

    // phase 4 (warp 0): da_k, step k = lane: the state against h0, the
    // inputs j < k (a prefix), the outputs i >= k (a suffix) and the pairs;
    // ddt and the dA_log sum
    if (warp == 0) {
      float y = 0.f, u = 0.f, hdot = 0.f;
      if (lane < kTcSub) {
        for (int w = 0; w < 8; ++w) {
          y += yop[w * kTcSub + lane];
          u += uup[w * kTcSub + lane];
        }
        y *= ec[lane];
        u *= wt[lane] * dtm[lane];
      }
      for (int w = 0; w < 8; ++w) hdot += red[w];
      float pre = u, suf = y;
#pragma unroll
      for (int o = 1; o < kTcSub; o <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, pre, o);
        const float dn = __shfl_down_sync(0xffffffffu, suf, o);
        if (lane >= o) pre += up;
        if (lane + o < kTcSub) suf += dn;
      }
      float da = 0.f;
      if (lane < K) {
        da = *dec * hdot + (pre - u) + suf + pr[lane];
        const float dxd = dxp[lane] + dxp[kTcSub + lane] + dxp[2 * kTcSub + lane] +
                          dxp[3 * kTcSub + lane];
        a.dtp[(((int64_t)b * a.S + s0 + lane) * a.H + h) * npt + pti] =
            mk[lane] != 0.f ? dxd + A * da : 0.f;
      }
      dA_acc += warp_sum(lane < K ? dtm[lane] * da : 0.f);
    }
  }
  grid_dep_launch();  // the sums may start (they wait for this grid)
  if (tid == 0) a.dap[(((int64_t)b * a.n_span + span) * a.H + h) * npt + pti] = A * dA_acc;
}

// ---------------------------------------------------------------------------
// The float32 route: the adjoint and span kernels on CUDA cores
// ---------------------------------------------------------------------------
constexpr int kAdjPiece = 64;  // float32 adjoint: steps of a piece, at most

// The float32 adjoint kernel's dynamic shared memory, bytes: two buffers
// of a piece's dy ([64][kLdp]) and C ([64][n_cols + 4]), and the decays
__host__ __device__ constexpr size_t adjoint_f32_smem_bytes(int n_cols) {
  return sizeof(float) * (2 * kAdjPiece * (kLdp + n_cols + 4) + kAdjPiece + 4);
}

// Block (P tile and N tile blockIdx.x, head blockIdx.y, row blockIdx.z),
// 256 threads; thread (pg, ng) of 16 x 16 holds rows 4 pg .. + 3 of the P
// tile and kC = kCols / 16 columns of the N tile of H in registers, vector
// q at columns q 16 kV + kV ng .. (a warp 4 row groups by 8 column groups:
// its dy and C reads are 64- and 128-byte runs).  Walks the row in pieces of pc
// sub-chunks (pc = min(R, 64 / K): a span, or R K / 64 pieces of it) from
// the last: at a span's end H goes to hs, then H = exp(cs_T) H + sum_i
// exp(cs_i) g_i C_i^T over the piece's steps (cs the cumsum over the
// piece), one fmaf an element a step.  The piece before is staged with
// cp.async into the other of two buffers behind the products.
template <int kCols>
__global__ void __launch_bounds__(kBwdThreads, 2) ssd_bwd_adjoint_f32_kernel(BwdArgs a) {
  constexpr int kC = kCols / 16;            // columns a thread: 1 .. 8
  constexpr int kV = kC < 4 ? kC : 4, kQ = kC / kV;  // kQ vectors of kV
  constexpr int kLdc = kCols + 4;           // C rows
  constexpr int kStage = kAdjPiece * (kLdp + kLdc);  // floats a buffer
  extern __shared__ __align__(16) float sm[];
  float* ecs = sm + 2 * kStage;             // [64] exp(cs_i)
  float* decs = ecs + kAdjPiece;            // exp(cs_T)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pg = 4 * (warp & 3) + (lane & 3), ng = 8 * (warp >> 2) + (lane >> 2);
  const int n_nt = (a.N + kCols - 1) / kCols;
  const int nti = blockIdx.x % n_nt, pti = blockIdx.x / n_nt;
  const int n0 = nti * kCols, p0 = pti * kBwdPT, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (a.H / a.G);
  const int pt = min(kBwdPT, a.P - p0), nc = min(kCols, a.N - n0);
  const int pc = min(a.R, kAdjPiece / a.K), L = pc * a.K, n_piece = (a.S / a.K + pc - 1) / pc;
  const float A = -expf(a.A_log[h]);
  const float* gg = a.dy + b * a.g_sb + h * a.g_sh + p0;
  const float* cg = static_cast<const float*>(a.C) + b * a.c_sb + g * a.c_sg + n0;
  const float* dtg = a.dt + b * a.dt_sb + h * a.dt_sh;
  const unsigned char* mg = a.mask != nullptr ? a.mask + b * a.m_sb : nullptr;
  const int64_t PN = (int64_t)a.P * a.N;
  const int r0 = 4 * pg;  // this thread's first row
  auto col = [&](int e) { return (e / kV) * 16 * kV + kV * ng + e % kV; };

  // H = dL/d the final state (0 past the tile and N)
  float acc[4][kC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < kC; ++e)
      acc[r][e] = a.dfinal != nullptr && r0 + r < pt && col(e) < nc
                      ? a.dfinal[b * a.f_sb + h * a.f_sh + (p0 + r0 + r) * a.f_sp +
                                 (n0 + col(e)) * a.f_sn]
                      : 0.f;
  // H to dst (rows of this tile of a (P, N) state)
  auto put = [&](float* dst) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < kQ; ++q)
        if (r0 + r < pt && col(q * kV) < nc)
          bwd_store<kV>(dst + (int64_t)(p0 + r0 + r) * a.N + n0 + col(q * kV), acc[r] + q * kV);
  };

  // piece s's dy and C into buffer s % 2; warp 0: its dt and mask (steps
  // lane, lane + 32) into registers
  float dt0 = 0.f, dt1 = 0.f, mk0 = 0.f, mk1 = 0.f;
  auto stage = [&](int s) {
    float* gsm = sm + (s & 1) * kStage;
    float* csm = gsm + kAdjPiece * kLdp;
    const int t0 = s * L, rows = min(L, a.S - t0);
    stage_tile<float, kAdjPiece, kBwdPT / 4, 16>(gsm, kLdp, gg + t0 * a.g_ss, a.g_ss, rows,
                                                  pt / 4, tid, kBwdThreads);
    stage_tile<float, kAdjPiece, kCols / 4, 16>(csm, kLdc, cg + t0 * a.c_ss, a.c_ss, rows,
                                                 nc / 4, tid, kBwdThreads);
    cp_async_commit();
    if (warp == 0) {  // independent loads: used at the next piece
      auto live = [&](int i) {
        return i < rows && (mg == nullptr || mg[(t0 + i) * a.m_ss]) ? 1.f : 0.f;
      };
      mk0 = live(lane);
      mk1 = live(lane + 32);
      dt0 = lane < rows ? dtg[(t0 + lane) * a.dt_ss] : 0.f;
      dt1 = lane + 32 < rows ? dtg[(t0 + lane + 32) * a.dt_ss] : 0.f;
    }
  };
  stage(n_piece - 1);
  for (int s = n_piece - 1; s >= 0; --s) {
    if (s == 0) grid_dep_launch();  // the span kernel may start its prologue
    if (warp == 0) {  // cs over the piece's steps
      const float v0 = scan32(mk0 != 0.f ? dt0 * A : 0.f, lane);
      const float v1 =
          scan32(mk1 != 0.f ? dt1 * A : 0.f, lane) + __shfl_sync(0xffffffffu, v0, 31);
      ecs[lane] = expf(v0);
      ecs[lane + 32] = expf(v1);
      const float last = __shfl_sync(0xffffffffu, v1, 31);
      if (lane == 0) *decs = expf(last);
    }
    if (s > 0) {
      stage(s - 1);  // the buffer's last readers finished at the barrier below
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // piece s's tiles and decays are ready
    if (((s + 1) * pc) % a.R == 0 || s == n_piece - 1)  // H at the end of a span
      put(a.hs + (((int64_t)b * a.n_span + s * pc / a.R) * a.H + h) * PN);
    const float* gp = sm + (s & 1) * kStage + r0;
    const float* cp = sm + (s & 1) * kStage + kAdjPiece * kLdp + kV * ng;
    const float d = *decs;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int e = 0; e < kC; ++e) acc[r][e] *= d;
#pragma unroll 4
    for (int i = 0; i < L; ++i) {
      const float4 gv = ld4(gp + i * kLdp);
      const float e = ecs[i];
      const float gw[4] = {gv.x * e, gv.y * e, gv.z * e, gv.w * e};
      float cv[kC];
#pragma unroll
      for (int q = 0; q < kQ; ++q) bwd_load<kV>(cp + i * kLdc + q * 16 * kV, cv + q * kV);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < kC; ++q) acc[r][q] = fmaf(gw[r], cv[q], acc[r][q]);
    }
    __syncthreads();  // the buffer and the decays are read
  }
  put(a.dinit + (int64_t)b * a.H * PN + (int64_t)h * PN);  // d initial state
}

// kRows x (4 kCh floats) of a row-major float32 tile from src (row stride
// rs, unit element stride, rows on 16 bytes) into dst (row stride ld) with
// 16-byte cp.async by the block's 256 threads, rows >= nrows and chunks >=
// nq zero-filled.  The loop is not unrolled: the copies' addresses are
// formed at each call, where unrolled ones were hoisted out of the span
// kernel's walk and held in registers across it.
template <int kRows, int kCh>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const float* src, int64_t rs,
                                           int nrows, int nq, int tid) {
#pragma unroll 1
  for (int i = tid; i < kRows * kCh; i += kBwdThreads) {
    const int r = i / kCh, q = i - r * kCh;
    const bool ok = r < nrows && q < nq;
    cp_async16(dst + r * ld + 4 * q, ok ? src + r * rs + 4 * q : src, ok);
  }
}

// The float32 span kernel's stages of a sub-chunk's x, dy, B and C: two
// (the next one staged behind the current one) where they fit beside two
// blocks' state (N <= 64), else one, so that N 128 keeps two blocks an SM
// (one block an SM, with two stages or with the registers of one, was
// slower in development builds)
__host__ __device__ constexpr int span_f32_stages(int n_pad) { return n_pad <= 64 ? 2 : 1; }

// floats of one stage: x and dy ([16][kLdp]), B and C ([16][n_pad + 4])
__host__ __device__ constexpr int span_f32_stage_floats(int n_pad) {
  return 2 * kBwdSub * kLdp + 2 * kBwdSub * (n_pad + 4);
}

// The float32 span kernel's shared memory, bytes: h0 and H ([64][n_pad +
// 4]), the stages, three (step, step) tiles, the decays and the warps'
// parts.
__host__ __device__ constexpr size_t span_f32_smem_bytes(int n_pad) {
  return sizeof(float) * (2 * (size_t)kBwdPT * (n_pad + 4) +
                          span_f32_stages(n_pad) * (size_t)span_f32_stage_floats(n_pad) +
                          3 * kBwdSub * kLdt + 6 * kBwdSub + 3 * 2 * kBwdSub + 8);
}

// Block (span and P tile blockIdx.x, head blockIdx.y, row blockIdx.z), 256
// threads.  Walks sub-chunks c_hi - 1 .. c_lo of span blockIdx.x / npt from
// the adjoint kernel's H at the span's end (its states and first tiles
// are staged before it waits for that kernel).  What bounds it is shared
// memory's bandwidth: a warp's 16-byte read takes four of its cycles, so
// every product is a register tile whose operands each serve 2-4 products,
// and the warps split the products by role.  Per sub-chunk:
//   phase 1: warps 0-1 Z = g h0, warps 2-3 W' = x H (W = dt' W'), thread
//     (ztg, zng) steps ztg + 4 i by kZC columns (4 x 8 at N 128), then the
//     row dots C_t . Z_t and B_t . W'_t; warps 4-7 rows vr + 16 k of V = H
//     B^T and C_vr . B_j at steps j = vt, vt + 8 in one walk over N, g_vr .
//     x_j, <H, h0>, then the pairs (vr, j) under L;
//   then the next sub-chunk's h0 is staged with cp.async (h0 is read);
//   phase 2: from the registers of phase 1, dC = exp(cs) Z + ML B (warps
//     0-1), dB = exp(cs_T - cs) dt' W' + (ML)^T C (warps 2-3) and dx' =
//     exp(cs_T - cs) V + S^T g, dx and dx' . x (warps 4-7); the pairs' part
//     of da_k; then H = exp(cs_T) H + U for the sub-chunk before, thread
//     (upg, ung) rows 4 upg .. + 3 by kUC columns;
//   then (one stage) the next sub-chunk's x, dy, B and C are staged (its dt
//     and mask went to registers at the sub-chunk's start);
//   phase 3 (warp 0): da_k, ddt and the block's dA_log part.
template <int kNR>
__global__ void __launch_bounds__(kBwdThreads, kNR <= 8 ? 2 : 1)
    ssd_bwd_span_f32_kernel(BwdArgs a) {
  constexpr int kNPad = 16 * kNR, kLdh = kNPad + 4;
  constexpr int kStages = span_f32_stages(kNPad);
  constexpr int kStage = span_f32_stage_floats(kNPad);
  // Z / W': 16 column groups of kZC columns, kZQ vectors of kZV
  constexpr int kZC = kNPad / 16, kZV = kZC < 4 ? kZC : 4, kZQ = kZC / kZV;
  // U: 16 column groups of kUC columns, kUQ vectors of kUV, kUP a pass
  constexpr int kUC = kNPad / 16, kUV = kUC < 4 ? kUC : 4, kUQ = kUC / kUV;
  constexpr int kUP = kUQ < 2 ? kUQ : 2;
  extern __shared__ __align__(16) float sm[];
  float* hin = sm;                          // [64][kLdh] h0
  float* hb = hin + kBwdPT * kLdh;          // [64][kLdh] H
  float* st = hb + kBwdPT * kLdh;           // kStages x {x, g: [16][kLdp]; B, C: [16][kLdh]}
  float* sc = st + kStages * kStage;        // [16][kLdt] C_i . B_j, then S = (C_i . B_j) L_ij
  float* ml = sc + kBwdSub * kLdt;          // [16][kLdt] g_i . x_j, then ML = (g_i . x'_j) L_ij
  float* tt = ml + kBwdSub * kLdt;          // [16][kLdt] S_ij (g_i . x'_j)
  float* cum = tt + kBwdSub * kLdt;         // [16] cs
  float* ec = cum + kBwdSub;                // [16] exp(cs_i)
  float* wt = ec + kBwdSub;                 // [16] exp(cs_T - cs_j)
  float* dtm = wt + kBwdSub;                // [16] dt'
  float* mk = dtm + kBwdSub;                // [16] the mask, 1 or 0
  float* pr = mk + kBwdSub;                 // [16] sum_{i >= k > j} TT_ij
  float* yop = pr + kBwdSub;                // [2][16] C_t . Z_t by warp of Z
  float* uup = yop + 2 * kBwdSub;           // [2][16] B_t . W'_t by warp of W'
  float* dxp = uup + 2 * kBwdSub;           // [2][16] dx' . x by warp of V
  float* red = dxp + 2 * kBwdSub;           // [4] <H, h0> by warp of V
  float* dec = red + 4;                     // exp(cs_T)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int npt = (a.P + kBwdPT - 1) / kBwdPT;
  const int pti = blockIdx.x % npt, span = blockIdx.x / npt;
  const int p0 = pti * kBwdPT, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (a.H / a.G);
  const int pt = min(kBwdPT, a.P - p0);
  const int K = a.K, N = a.N, n_sub = a.S / K;
  const int c_lo = span * a.R, c_hi = min(c_lo + a.R, n_sub);
  const float A = -expf(a.A_log[h]);
  const int64_t PN = (int64_t)a.P * N;
  // warps 0-3, Z (zh 0) or W' (zh 1): step group ztg, column group zng (a
  // warp 4 step groups by 8 column groups)
  const int zh = warp >> 1, ztg = lane & 3, zng = 8 * (warp & 1) + (lane >> 2);
  // warps 4-7: V rows vr + 16 k and C row vr against B rows vt and vt + 8
  // (a warp 8 rows by 4 steps)
  const int vu = warp & 3, vr = 8 * (vu & 1) + (lane & 7), vt = 4 * (vu >> 1) + (lane >> 3);
  // U: rows 4 upg .. + 3, column group ung (a warp 4 row groups by 8)
  const int upg = 4 * (warp & 3) + (lane & 3), ung = 8 * (warp >> 2) + (lane >> 2);

  // warp 0: sub-chunk c's dt and mask into registers (two independent
  // loads: used at the next sub-chunk's start).  The row's pointers are
  // formed where they are used, so that they hold no register between.
  float dtv = 0.f, mkv = 0.f;
  auto load_dt = [&](int c) {
    if (warp == 0) {
      const int s = c * K + lane;
      mkv = lane < K && (a.mask == nullptr || a.mask[b * a.m_sb + s * a.m_ss]) ? 1.f : 0.f;
      dtv = lane < K ? a.dt[b * a.dt_sb + s * a.dt_ss + h * a.dt_sh] : 0.f;
    }
  };
  // sub-chunk c's x, dy, B and C into its stage (0 past K, the tile and N)
  auto stage_steps = [&](int c) {
    const int s0 = c * K;
    const float* xg = static_cast<const float*>(a.x) + b * a.x_sb + h * a.x_sh + p0;
    const float* gg = a.dy + b * a.g_sb + h * a.g_sh + p0;
    const float* bg = static_cast<const float*>(a.B) + b * a.b_sb + g * a.b_sg;
    const float* cg = static_cast<const float*>(a.C) + b * a.c_sb + g * a.c_sg;
    float* xs = st + (c & (kStages - 1)) * kStage;
    float* gs = xs + kBwdSub * kLdp;
    float* bs = gs + kBwdSub * kLdp;
    float* cs = bs + kBwdSub * kLdh;
    stage_rows<kBwdSub, kBwdPT / 4>(xs, kLdp, xg + s0 * a.x_ss, a.x_ss, K, pt / 4, tid);
    stage_rows<kBwdSub, kBwdPT / 4>(gs, kLdp, gg + s0 * a.g_ss, a.g_ss, K, pt / 4, tid);
    stage_rows<kBwdSub, kNPad / 4>(bs, kLdh, bg + s0 * a.b_ss, a.b_ss, K, N / 4, tid);
    stage_rows<kBwdSub, kNPad / 4>(cs, kLdh, cg + s0 * a.c_ss, a.c_ss, K, N / 4, tid);
    cp_async_commit();
  };
  // rows of this P tile of a (P, N) float32 state into a [64][kLdh] tile
  auto stage_state = [&](float* dst, const float* src) {
    stage_rows<kBwdPT, kNPad / 4>(dst, kLdh, src + (int64_t)p0 * N, N, pt, N / 4, tid);
  };
  // h0 of sub-chunk c: the forward's state after sub-chunk c - 1, else the
  // initial state or 0
  auto stage_h0 = [&](int c) {
    if (c > 0) {
      stage_state(hin, a.states + (((int64_t)b * n_sub + c - 1) * a.H + h) * PN);
    } else {
      for (int i = tid; i < kBwdPT * kNPad; i += kBwdThreads) {
        const int p = i / kNPad, n = i - p * kNPad;
        hin[p * kLdh + n] =
            a.init != nullptr && p < pt && n < N
                ? a.init[b * a.i_sb + h * a.i_sh + (p0 + p) * a.i_sp + n * a.i_sn]
                : 0.f;
      }
    }
    cp_async_commit();
  };
  load_dt(c_hi - 1);
  stage_h0(c_hi - 1);
  stage_steps(c_hi - 1);
  grid_dep_wait();  // the adjoint kernel's H (what comes before needs nothing of it)
  stage_state(hb, a.hs + (((int64_t)b * a.n_span + span) * a.H + h) * PN);
  cp_async_commit();

  float dA_acc = 0.f;  // warp 0: sum of dt' da over the span's steps
  for (int c = c_hi - 1; c >= c_lo; --c) {
    const int s0 = c * K;
    const float* xs = st + (c & (kStages - 1)) * kStage;
    const float* gs = xs + kBwdSub * kLdp;
    const float* bs = gs + kBwdSub * kLdp;
    const float* cs = bs + kBwdSub * kLdh;
    if (warp == 0) {  // dt', the mask and the decays
      const float dv = mkv != 0.f ? dtv : 0.f;
      const float v = scan16(dv * A, lane);
      const float last = __shfl_sync(0xffffffffu, v, kBwdSub - 1);
      if (lane < kBwdSub) {
        mk[lane] = mkv;
        dtm[lane] = dv;
        cum[lane] = v;
        ec[lane] = expf(v);
        wt[lane] = expf(last - v);
      }
      if (lane == 0) *dec = expf(last);
    }
    if (c > c_lo) load_dt(c - 1);
    if (kStages == 2 && c > c_lo) {
      stage_steps(c - 1);  // behind this sub-chunk (its stage's readers are done)
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // the tiles, h0, H and the decays are ready

    // phase 1, warps 0-3: Z = g h0 (warps 0-1) or W' = x H (warps 2-3),
    // steps ztg + 4 i by the kZC columns of vectors q at q 16 kZV + zng
    // kZV, then this warp's part of the row dots C_t . Z_t or B_t . W'_t.
    // Warps 4-7: rows vr + 16 k of V = H B^T and C_vr . B_j at steps j = vt
    // and vt + 8, g_vr . x_j, <H, h0>, the pairs (vr, j) under L, then dx'.
    float zw[4][kZC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < kZC; ++e) zw[i][e] = 0.f;
    float vacc[4][2], cb[2] = {0.f, 0.f};
#pragma unroll
    for (int k = 0; k < 4; ++k) vacc[k][0] = vacc[k][1] = 0.f;
    if (warp < 4) {
      const float* ap = (zh ? xs : gs) + ztg * kLdp;
      const float* bp = (zh ? hb : hin) + zng * kZV;
#pragma unroll 1
      for (int p = 0; p < pt; p += 4) {
        float av[4][4];  // av[i][k]: step ztg + 4 i, row p + k
#pragma unroll
        for (int i = 0; i < 4; ++i) bwd_load<4>(ap + 4 * i * kLdp + p, av[i]);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float bv[kZC];
#pragma unroll
          for (int q = 0; q < kZQ; ++q)
            bwd_load<kZV>(bp + (p + k) * kLdh + q * 16 * kZV, bv + q * kZV);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < kZC; ++e) zw[i][e] = fmaf(av[i][k], bv[e], zw[i][e]);
        }
      }
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      const float* rp = (zh ? bs : cs) + ztg * kLdh + zng * kZV;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < kZQ; ++q) {
          float v[kZV];
          bwd_load<kZV>(rp + 4 * i * kLdh + q * 16 * kZV, v);
#pragma unroll
          for (int e = 0; e < kZV; ++e) part[i] = fmaf(zw[i][q * kZV + e], v[e], part[i]);
        }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) part[i] += __shfl_xor_sync(0xffffffffu, part[i], o);
      if (lane < 4) {
#pragma unroll
        for (int i = 0; i < 4; ++i) (zh ? uup : yop)[(warp & 1) * kBwdSub + lane + 4 * i] = part[i];
      }
    } else {
      {
        const float* hr = hb + vr * kLdh;
        const float* cr = cs + vr * kLdh;
        const float* br = bs + vt * kLdh;
        auto quad = [&](int n) {
          const float4 b0 = ld4(br + n), b1 = ld4(br + 8 * kLdh + n);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float4 hv = ld4(hr + 16 * k * kLdh + n);
            vacc[k][0] = dot4(hv, b0, vacc[k][0]);
            vacc[k][1] = dot4(hv, b1, vacc[k][1]);
          }
          const float4 cv = ld4(cr + n);
          cb[0] = dot4(cv, b0, cb[0]);
          cb[1] = dot4(cv, b1, cb[1]);
        };
        if constexpr (kNR >= 8) {  // two quads in flight where registers allow
#pragma unroll 2
          for (int n = 0; n < N; n += 4) quad(n);
        } else {
#pragma unroll 1
          for (int n = 0; n < N; n += 4) quad(n);
        }
      }
      float gx[2] = {0.f, 0.f};  // g_vr . x_vt, g_vr . x_vt+8 (x', not x, below)
      {
        const float* gi = gs + vr * kLdp;
        const float* xj = xs + vt * kLdp;
#pragma unroll 2
        for (int p = 0; p < pt; p += 4) {
          const float4 gv = ld4(gi + p);
          gx[0] = dot4(gv, ld4(xj + p), gx[0]);
          gx[1] = dot4(gv, ld4(xj + 8 * kLdp + p), gx[1]);
        }
      }
      float hd = 0.f;
      for (int i = tid - 128; i < kBwdPT * kNPad / 4; i += 128) {
        const int o = (i / (kNPad / 4)) * kLdh + (i % (kNPad / 4)) * 4;
        hd = dot4(ld4(hb + o), ld4(hin + o), hd);
      }
      hd = warp_sum(hd);
      if (lane == 0) red[vu] = hd;
      // the pairs under L (0 above the diagonal and past K): S = (C_i . B_j)
      // L_ij, ML = (g_i . x'_j) L_ij, TT = S_ij (g_i . x'_j)
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int i = vr, j = vt + 8 * m;
        float s = 0.f, ml_ = 0.f, t = 0.f;
        if (j <= i && i < K) {
          const float L = expf(cum[i] - cum[j]);
          const float gxv = gx[m] * dtm[j];
          s = cb[m] * L;
          ml_ = gxv * L;
          t = s * gxv;
        }
        sc[i * kLdt + j] = s;
        ml[i * kLdt + j] = ml_;
        tt[i * kLdt + j] = t;
      }
    }
    __syncthreads();  // h0 is read; S, ML, TT and the row dots are ready
    if (c > c_lo) stage_h0(c - 1);  // behind this sub-chunk's work

    // phase 2, warps 0-3: dC = exp(cs) Z + ML B (warps 0-1) and dB =
    // exp(cs_T - cs) dt' W' + (ML)^T C (warps 2-3), this head's and tile's
    // parts
    if (warp < 4) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ztg + 4 * i;
        const float f = zh ? wt[t] * dtm[t] : ec[t];
#pragma unroll
        for (int e = 0; e < kZC; ++e) zw[i][e] *= f;
      }
      const float* rp = (zh ? cs : bs) + zng * kZV;
#pragma unroll 2
      for (int j = 0; j < K; ++j) {
        float mv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          mv[i] = zh ? ml[j * kLdt + ztg + 4 * i] : ml[(ztg + 4 * i) * kLdt + j];
        float v[kZC];
#pragma unroll
        for (int q = 0; q < kZQ; ++q) bwd_load<kZV>(rp + j * kLdh + q * 16 * kZV, v + q * kZV);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < kZC; ++e) zw[i][e] = fmaf(mv[i], v[e], zw[i][e]);
      }
      float* out = zh ? a.dbp : a.dcp;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ztg + 4 * i;
        if (t >= K) continue;
        float* row = out + ((((int64_t)b * a.S + s0 + t) * a.H + h) * npt + pti) * N;
#pragma unroll
        for (int q = 0; q < kZQ; ++q) {
          const int n = q * 16 * kZV + zng * kZV;
          if (n < N) bwd_store<kZV>(row + n, zw[i] + q * kZV);
        }
      }
    } else {
      // dx' = exp(cs_T - cs_j) V + sum_i S_ij g_i at rows vr + 16 k, steps
      // vt and vt + 8, once warps 4-7 have S; dx = dx' dt' out, and dx' . x
      // summed over the warp's 8 rows vr
      float dxa[4][2];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float w = wt[vt + 8 * m];
#pragma unroll
        for (int k = 0; k < 4; ++k) dxa[k][m] = w * vacc[k][m];
      }
#pragma unroll 2
      for (int i = 0; i < K; ++i) {
        const float s0_ = sc[i * kLdt + vt], s1_ = sc[i * kLdt + vt + 8];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float gv = gs[i * kLdp + vr + 16 * k];
          dxa[k][0] = fmaf(s0_, gv, dxa[k][0]);
          dxa[k][1] = fmaf(s1_, gv, dxa[k][1]);
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int t = vt + 8 * m;
        const float dv = dtm[t];
        float* row = a.dx + (((int64_t)b * a.S + s0 + t) * a.H + h) * a.P + p0;
        float d = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int p = vr + 16 * k;
          d = fmaf(dxa[k][m], xs[t * kLdp + p], d);
          if (t < K && p < pt) row[p] = dxa[k][m] * dv;
        }
#pragma unroll
        for (int o = 1; o < 8; o <<= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
        if ((lane & 7) == 0) dxp[(vu & 1) * kBwdSub + t] = d;
      }
    }
    // the pairs' part of da_k, sum_{i >= k > j} TT_ij: thread (k, j), the
    // 16 lanes of a half warp summed
    {
      const int k = tid >> 4, j = tid & 15;
      float v = 0.f;
#pragma unroll
      for (int i = 1; i < kBwdSub; ++i)
        if (j < k && i >= k) v += tt[i * kLdt + j];
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (j == 0) pr[k] = v;
    }
    // H = exp(cs_T) H + sum_i exp(cs_i) g_i C_i^T, the adjoint at the end
    // of sub-chunk c - 1 (no reader of H is left in this sub-chunk), kUP
    // vectors a pass
    if (c > c_lo) {
      const float d = *dec;
#pragma unroll
      for (int q0 = 0; q0 < kUQ; q0 += kUP) {
        float acc[4][kUP * kUV];
        float* hp = hb + 4 * upg * kLdh + (q0 * 16 + ung) * kUV;
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int qq = 0; qq < kUP; ++qq) {
            bwd_load<kUV>(hp + r * kLdh + qq * 16 * kUV, acc[r] + qq * kUV);
#pragma unroll
            for (int e = 0; e < kUV; ++e) acc[r][qq * kUV + e] *= d;
          }
        const float* cp = cs + (q0 * 16 + ung) * kUV;
#pragma unroll 2
        for (int i = 0; i < K; ++i) {
          const float4 gv = ld4(gs + i * kLdp + 4 * upg);
          const float e = ec[i];
          const float gw[4] = {gv.x * e, gv.y * e, gv.z * e, gv.w * e};
          float cv[kUP * kUV];
#pragma unroll
          for (int qq = 0; qq < kUP; ++qq)
            bwd_load<kUV>(cp + i * kLdh + qq * 16 * kUV, cv + qq * kUV);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int e2 = 0; e2 < kUP * kUV; ++e2) acc[r][e2] = fmaf(gw[r], cv[e2], acc[r][e2]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int qq = 0; qq < kUP; ++qq)
            bwd_store<kUV>(hp + r * kLdh + qq * 16 * kUV, acc[r] + qq * kUV);
      }
    }
    __syncthreads();  // the parts are ready; the tiles are read
    if (kStages == 1 && c > c_lo) stage_steps(c - 1);  // behind phase 3

    // phase 3 (warp 0): da_k, step k = lane: the state against h0, the
    // inputs j < k (a prefix), the outputs i >= k (a suffix) and the pairs;
    // ddt and the dA_log sum
    if (warp == 0) {
      float y = 0.f, u = 0.f, hdot = 0.f;
      if (lane < kBwdSub) {
        y = yop[lane] + yop[kBwdSub + lane];
        u = uup[lane] + uup[kBwdSub + lane];
        y *= ec[lane];
        u *= wt[lane] * dtm[lane];
      }
#pragma unroll
      for (int w = 0; w < 4; ++w) hdot += red[w];
      float pre = u, suf = y;
#pragma unroll
      for (int o = 1; o < kBwdSub; o <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, pre, o);
        const float dn = __shfl_down_sync(0xffffffffu, suf, o);
        if (lane >= o) pre += up;
        if (lane + o < kBwdSub) suf += dn;
      }
      float da = 0.f;
      if (lane < K) {
        da = *dec * hdot + (pre - u) + suf + pr[lane];
        const float dxd = dxp[lane] + dxp[kBwdSub + lane];
        a.dtp[(((int64_t)b * a.S + s0 + lane) * a.H + h) * npt + pti] =
            mk[lane] != 0.f ? dxd + A * da : 0.f;
      }
      dA_acc += warp_sum(lane < K ? dtm[lane] * da : 0.f);
    }
  }
  grid_dep_launch();  // the sums may start (they wait for this grid)
  if (tid == 0) a.dap[(((int64_t)b * a.n_span + span) * a.H + h) * npt + pti] = A * dA_acc;
}


struct BwdSumArgs {
  const float* dbp;
  const float* dcp;
  const float* dtp;
  const float* dap;
  void* dB;    // (B, S, G, N), float32 or (bf16) bf16
  void* dC;    // (B, S, G, N), the same
  float* ddt;  // (B, S, H)
  float* dA;   // (H,)
  int Bb, S, H, G, N, npt;
  int nda;   // dA_log parts a head and P tile: rows x spans
  int bf16;  // dB and dC in bf16
};

// The parts summed in a fixed order, one output a thread: blockIdx.y 0 dB
// and 1 dC (over the group's heads and the P tiles), 2 ddt (over the P
// tiles), 3 dA_log (over the rows' blocks and the P tiles).
__global__ void __launch_bounds__(256) ssd_scan_bwd_sum_kernel(BwdSumArgs a) {
  grid_dep_wait();
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t rows = (int64_t)a.Bb * a.S;
  const int HG = a.H / a.G;
  if (blockIdx.y < 2) {
    if (i >= rows * a.G * a.N) return;
    const int n = static_cast<int>(i % a.N);
    const int64_t r = i / a.N;
    const int g = static_cast<int>(r % a.G);
    const float* src =
        (blockIdx.y ? a.dcp : a.dbp) + ((r / a.G * a.H + (int64_t)g * HG) * a.npt) * a.N + n;
    float acc = 0.f;
#pragma unroll 8
    for (int k = 0; k < HG * a.npt; ++k) acc += src[(int64_t)k * a.N];
    void* out = blockIdx.y ? a.dC : a.dB;
    if (a.bf16) {
      static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(acc);
    } else {
      static_cast<float*>(out)[i] = acc;
    }
  } else if (blockIdx.y == 2) {
    if (i >= rows * a.H) return;
    float acc = 0.f;
    for (int k = 0; k < a.npt; ++k) acc += a.dtp[i * a.npt + k];
    a.ddt[i] = acc;
  } else {
    if (i >= a.H) return;
    float acc = 0.f;
    for (int b = 0; b < a.nda; ++b)
      for (int k = 0; k < a.npt; ++k) acc += a.dap[((int64_t)b * a.H + i) * a.npt + k];
    a.dA[i] = acc;
  }
}

// kernel<<<grid, threads, smem, stream>>>(args) as a programmatic
// dependent launch: it may start while the kernel before it on the stream
// finishes (it calls grid_dep_wait() before it reads that kernel's output)
template <typename Args>
cudaError_t launch_after(void (*kernel)(Args), dim3 grid, int threads, size_t smem,
                         cudaStream_t stream, const Args& args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args);
}

// The float32 route: the adjoint kernel (N tiles of 16, 32, 64 or 128
// columns), then the span kernel (N padded to the next of 16, 32, 64, 128,
// 256)
template <int kCols>
cudaError_t launch_adjoint_f32(const BwdArgs& a, int Bb, cudaStream_t stream) {
  const int npt = (a.P + kBwdPT - 1) / kBwdPT, n_nt = (a.N + kCols - 1) / kCols;
  ssd_bwd_adjoint_f32_kernel<kCols><<<dim3(npt * n_nt, a.H, Bb), kBwdThreads,
                                       adjoint_f32_smem_bytes(kCols), stream>>>(a);
  return cudaGetLastError();
}

template <int kNR>
cudaError_t launch_span_f32(const BwdArgs& a, int Bb, cudaStream_t stream) {
  const int npt = (a.P + kBwdPT - 1) / kBwdPT;
  return launch_after(ssd_bwd_span_f32_kernel<kNR>, dim3(npt * a.n_span, a.H, Bb), kBwdThreads,
                      span_f32_smem_bytes(16 * kNR), stream, a);
}

cudaError_t launch_bwd_f32(const BwdArgs& a, int Bb, cudaStream_t stream) {
  cudaError_t err = a.N <= 16   ? launch_adjoint_f32<16>(a, Bb, stream)
                    : a.N <= 32 ? launch_adjoint_f32<32>(a, Bb, stream)
                    : a.N <= 64 ? launch_adjoint_f32<64>(a, Bb, stream)
                                : launch_adjoint_f32<128>(a, Bb, stream);
  if (err != cudaSuccess) return err;
  if (a.N <= 16) return launch_span_f32<1>(a, Bb, stream);
  if (a.N <= 32) return launch_span_f32<2>(a, Bb, stream);
  if (a.N <= 64) return launch_span_f32<4>(a, Bb, stream);
  if (a.N <= 128) return launch_span_f32<8>(a, Bb, stream);
  return launch_span_f32<16>(a, Bb, stream);
}

// The bf16 route: kernel A (N tiles of 16, 32 or 64 columns), then kernel
// B (N padded to the next of 16, 32, 64, 128, 256)
template <int kNT>
cudaError_t launch_adjoint(const BwdArgs& a, int Bb, cudaStream_t stream) {
  const int npt = (a.P + kTcPT - 1) / kTcPT, n_nt = (a.N + 8 * kNT - 1) / (8 * kNT);
  ssd_bwd_adjoint_kernel<kNT><<<dim3(npt * n_nt, a.H, Bb), kAdjThreads,
                                 adjoint_smem_bytes(8 * kNT), stream>>>(a);
  return cudaGetLastError();
}

template <int kNR>
cudaError_t launch_span(const BwdArgs& a, int Bb, cudaStream_t stream) {
  const int npt = (a.P + kTcPT - 1) / kTcPT;
  return launch_after(ssd_bwd_span_kernel<kNR>, dim3(npt * a.n_span, a.H, Bb), kSpanThreads,
                      span_smem_bytes(16 * kNR), stream, a);
}

cudaError_t launch_bwd_bf16(const BwdArgs& a, int Bb, cudaStream_t stream) {
  cudaError_t err = a.N <= 16   ? launch_adjoint<2>(a, Bb, stream)
                    : a.N <= 32 ? launch_adjoint<4>(a, Bb, stream)
                                : launch_adjoint<8>(a, Bb, stream);
  if (err != cudaSuccess) return err;
  if (a.N <= 16) return launch_span<1>(a, Bb, stream);
  if (a.N <= 32) return launch_span<2>(a, Bb, stream);
  if (a.N <= 64) return launch_span<4>(a, Bb, stream);
  if (a.N <= 128) return launch_span<8>(a, Bb, stream);
  return launch_span<16>(a, Bb, stream);
}

}  // namespace rt

// Once per process, when the library is bound: every instantiation
// (prepare_kernels).
extern "C" int rt_prepare_ssd_bwd() {
  using namespace rt;
  return prepare_kernels(
      {(const void*)ssd_bwd_adjoint_f32_kernel<16>, (const void*)ssd_bwd_adjoint_f32_kernel<32>,
       (const void*)ssd_bwd_adjoint_f32_kernel<64>, (const void*)ssd_bwd_adjoint_f32_kernel<128>,
       (const void*)ssd_bwd_span_f32_kernel<1>,
       (const void*)ssd_bwd_span_f32_kernel<2>, (const void*)ssd_bwd_span_f32_kernel<4>,
       (const void*)ssd_bwd_span_f32_kernel<8>, (const void*)ssd_bwd_span_f32_kernel<16>,
       (const void*)ssd_bwd_adjoint_kernel<2>, (const void*)ssd_bwd_adjoint_kernel<4>,
       (const void*)ssd_bwd_adjoint_kernel<8>, (const void*)ssd_bwd_span_kernel<1>,
       (const void*)ssd_bwd_span_kernel<2>, (const void*)ssd_bwd_span_kernel<4>,
       (const void*)ssd_bwd_span_kernel<8>, (const void*)ssd_bwd_span_kernel<16>,
       (const void*)ssd_scan_bwd_sum_kernel});
}

// Plain C entry point bound with ctypes.  x (Bb, S, H, P), B and C (Bb, S,
// G, N) float32 or bf16 (one dtype code for the three) with their strides;
// dt (Bb, S, H), A_log (H,) and dy (Bb, S, H, P) float32; mask (Bb, S)
// bool or null; init and dfinal (Bb, H, P, N) float32 or null; states (Bb,
// S / K, H, P, N) contiguous float32, the forward's state after every K
// steps.  Scratch: hs (Bb, n_span, H, P, N), the adjoint at every span's
// end (n_span = ceil(S / K / R)); dtp (Bb, S, H, npt), dbp and dcp (Bb, S,
// H, npt, N), dap (Bb, n_span, H, npt), npt = ceil(P / 64).  Out,
// contiguous: dx (Bb, S, H, P), dB and dC (Bb, S, G, N) in the dtype of x
// (float32 or bf16), dinit (Bb, H, P, N), ddt (Bb, S, H) and dA (H,)
// float32.  K divides S, at most 16; R >= 1 sub-chunks a span, a multiple
// of 64 / K when R K > 64; P and N are multiples of 4, N <= 256; x, B, C
// and dy have unit last strides and rows on 16 bytes (bf16 x, B and C on
// 8).  float32 runs the float32 adjoint and span kernels, bf16 kernels A
// and B; then the sums.  Returns cudaGetLastError() after the launches.
extern "C" int rt_ssd_scan_bwd(
    const void* x, int64_t x_sb, int64_t x_ss, int64_t x_sh, int64_t x_sp, int dtype,
    const void* dt, int64_t dt_sb, int64_t dt_ss, int64_t dt_sh, const void* A_log,
    const void* B, int64_t b_sb, int64_t b_ss, int64_t b_sg, int64_t b_sn,
    const void* C, int64_t c_sb, int64_t c_ss, int64_t c_sg, int64_t c_sn,
    const void* mask, int64_t m_sb, int64_t m_ss,
    const void* init, int64_t i_sb, int64_t i_sh, int64_t i_sp, int64_t i_sn,
    const void* dy, int64_t g_sb, int64_t g_ss, int64_t g_sh, int64_t g_sp,
    const void* dfinal, int64_t f_sb, int64_t f_sh, int64_t f_sp, int64_t f_sn,
    const void* states, void* hs, void* dx, void* dtp, void* dbp, void* dcp, void* dap,
    void* dinit, void* ddt, void* dB, void* dC, void* dA, int Bb, int S, int H, int G, int P,
    int N, int K, int R, void* stream) {
  using namespace rt;
  if (Bb == 0 || H == 0 || S == 0) return cudaSuccess;
  if (K <= 0 || K > kBwdSub || S % K || P <= 0 || P % 4 || N <= 0 || N % 4 ||
      N > kBwdMaxN || G <= 0 || H % G || R <= 0) {
    return cudaErrorInvalidValue;
  }
  if (dtype != F32 && dtype != BF16) return cudaErrorInvalidValue;
  if (hs == nullptr || R % std::min(R, 64 / K)) return cudaErrorInvalidValue;
  const int n_span = (S / K + R - 1) / R;
  BwdArgs a = {x, x_sb, x_ss, x_sh, x_sp, static_cast<const float*>(dt), dt_sb, dt_ss,
               dt_sh, static_cast<const float*>(A_log), B, b_sb, b_ss, b_sg, b_sn, C,
               c_sb, c_ss, c_sg, c_sn, static_cast<const unsigned char*>(mask), m_sb,
               m_ss, static_cast<const float*>(init), i_sb, i_sh, i_sp, i_sn,
               static_cast<const float*>(dy), g_sb, g_ss, g_sh, g_sp,
               static_cast<const float*>(dfinal), f_sb, f_sh, f_sp, f_sn,
               static_cast<const float*>(states), static_cast<float*>(dx),
               static_cast<float*>(dtp), static_cast<float*>(dbp), static_cast<float*>(dcp),
               static_cast<float*>(dap), static_cast<float*>(dinit), S, H, G, P, N, K,
               static_cast<float*>(hs), R, n_span, static_cast<__nv_bfloat16*>(dx)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == F32 ? launch_bwd_f32(a, Bb, s) : launch_bwd_bf16(a, Bb, s);
  if (err != cudaSuccess) return err;
  const int npt = (P + kBwdPT - 1) / kBwdPT;
  BwdSumArgs r = {static_cast<const float*>(dbp), static_cast<const float*>(dcp),
                  static_cast<const float*>(dtp),
                  static_cast<const float*>(dap), dB, dC, static_cast<float*>(ddt),
                  static_cast<float*>(dA), Bb, S, H, G, N, npt, Bb * n_span, dtype == BF16};
  const int64_t most = std::max<int64_t>((int64_t)Bb * S * std::max(G * N, H), H);
  const dim3 grid(static_cast<unsigned>((most + 255) / 256), 4);
  return launch_after(ssd_scan_bwd_sum_kernel, grid, 256, 0, s, r);
}
