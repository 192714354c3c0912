// The backward of the Mamba-2 SSD scan for Hopper (sm_90a): the gradient
// of kernels/ssd_scan/ops.py::ssd in two launches.
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
// them; this kernel reads the state entering each sub-chunk back, 4 B S H P
// N / K bytes (336 MB at mamba2-2.7b's training microbatch B 4, S 512, H
// 80, P 64, N 128: 0.1 ms of reads at 3.35 TB/s), where recomputing them
// would double the forward's products.
//
// What bounds it on the H100: the float32 products.  At that microbatch
// (x, B and C in bf16) the call reads x, dt, B, C, dy and the states (0.40
// GB) and writes dx, ddt, dB and dC (0.02 GB): 0.126 ms at 3.35 TB/s.
// Its products, 8 P N per (row, step, head) for Z, W, V and the adjoint
// update below plus the step pairs, are 11.8 GFLOP: 0.176 ms at the
// float32 CUDA-core peak of 67 TFLOP/s.
//
// Design (kernel 1): one block of 256 threads per (P tile of 64, head,
// row) walks the row's sub-chunks from the last to the first with the
// adjoint H (dL/d the state at the sub-chunk's end, rows of its P tile) in
// shared memory.  Per sub-chunk of T = K steps, with cs the cumsum of a
// over its steps, L_ij = exp(cs_i - cs_j) for j <= i, h0 the state
// entering it:
//   - stage x, x' = x dt', g, B, C and h0 as float32 tiles;
//   - the step pairs C_i . B_j and g_i . x'_j (one pair a thread);
//     Z = h0^T g and W = H^T x' (16 x N, sums over the tile's P); V = H B^T
//     (16 x P, sums over N, the 16 lanes of a row group summed as the
//     forward sums C h^T) and <H, h0>;
//   - dx'_j = sum_{i >= j} (C_i . B_j) L_ij g_i + exp(cs_T - cs_j) V_j;
//     dB_j = sum_{i >= j} (g_i . x'_j) L_ij C_i + exp(cs_T - cs_j) W_j;
//     dC_i = sum_{j <= i} (g_i . x'_j) L_ij B_j + exp(cs_i) Z_i;
//   - da_k (warp 0) from every product whose decay spans step k: the
//     outputs i >= k against h0 (exp(cs_i) C_i . Z_i), the state against
//     h0 and the inputs j < k (exp(cs_T) <H, h0>, exp(cs_T - cs_j) B_j .
//     W_j) and the pairs i >= k > j ((C_i . B_j)(g_i . x'_j) L_ij).  The
//     derivative of cs summed backwards would give the same in exact
//     arithmetic, but a pair's term added to one step and taken from
//     another cancels in float32;
//   - H = exp(cs_T) H + sum_i exp(cs_i) g_i C_i^T.
// Every exponent is of a difference cs_i - cs_j with j <= i, or of cs_i:
// at most 0, no overflow.  Per block the kernel writes dx (its tile) and
// its parts of dB, dC, ddt (sums over P) and dA_log (a sum over steps)
// to float32 scratch; kernel 2 sums them over the group's heads, the P
// tiles and the rows in a fixed order.  No atomics: two calls are
// bitwise equal.  A step with dt' = 0 gives dx, ddt and dB exactly 0.
//
// The products run on CUDA cores in float32 (TF32 would break the float32
// card-vs-CPU training parity).  Shared memory holds H and h0 (64 x N
// each) beside the 16-step tiles: 122 KB at N 128, 221 KB at N 256, one
// block an SM.  P and N must be multiples of 4, N at most 256 (the
// wrapper checks).
#include <algorithm>

#include "tensor_core.cuh"
#include "tile_attention.cuh"

namespace rt {

constexpr int kBwdPT = 64;          // rows of P a block owns
constexpr int kBwdThreads = 256;    // 8 warps
constexpr int kBwdSub = 16;         // steps of a sub-chunk, at most
constexpr int kBwdMaxN = 256;       // state columns
constexpr int kLdp = kBwdPT + 4;    // row stride of the (step, P) tiles
constexpr int kLdt = kBwdSub + 1;   // row stride of the (step, step) tiles

// row stride of the (step, N) and (P, N) tiles
__host__ __device__ constexpr int bwd_ldn(int n_pad) { return n_pad + 4; }

// floats of shared memory of a block with n_pad state columns
__host__ __device__ constexpr size_t bwd_smem_floats(int n_pad) {
  return 4 * kBwdSub * kLdp + (size_t)(4 * kBwdSub + 2 * kBwdPT) * bwd_ldn(n_pad) +
         3 * kBwdSub * kLdt + 9 * kBwdSub + 16;
}

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

__device__ __forceinline__ void fma4(float4& acc, const float4& u, float s) {
  acc.x = fmaf(u.x, s, acc.x);
  acc.y = fmaf(u.y, s, acc.y);
  acc.z = fmaf(u.z, s, acc.z);
  acc.w = fmaf(u.w, s, acc.w);
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
  float* dap;           // (B, H, npt): dA_log by row and P tile
  float* dinit;         // (B, H, P, N) contiguous
  int S, H, G, P, N, K;
};

// Block (P tile blockIdx.x, head blockIdx.y, row blockIdx.z).  kNR: state
// columns a thread of the (row group, lane) layout holds (N <= 16 kNR).
template <typename T, int kNR>
__global__ void __launch_bounds__(kBwdThreads) ssd_scan_bwd_kernel(BwdArgs a) {
  constexpr int kNPad = 16 * kNR;
  constexpr int kLdn = bwd_ldn(kNPad);
  constexpr int kG4 = kNPad / 4;                             // groups of 4 columns
  constexpr int kRowStep = kBwdThreads / kG4;                // Z / W: rows apart
  constexpr int kZR = (kBwdSub + kRowStep - 1) / kRowStep;   // Z / W: rows a thread
  constexpr int kW = kNR < 4 ? kNR : 4;                      // columns of one chunk
  constexpr int kQ = kNR / kW;                               // chunks, 16 kW apart
  extern __shared__ __align__(16) float sm[];
  float* xs = sm;                        // [16][kLdp] x' = x dt'
  float* xr = xs + kBwdSub * kLdp;       // [16][kLdp] x
  float* gs = xr + kBwdSub * kLdp;       // [16][kLdp] g = dy
  float* vs = gs + kBwdSub * kLdp;       // [16][kLdp] V = H B^T, by step
  float* bs = vs + kBwdSub * kLdp;       // [16][kLdn] B
  float* cs = bs + kBwdSub * kLdn;       // [16][kLdn] C
  float* zs = cs + kBwdSub * kLdn;       // [16][kLdn] Z = h0^T g, by step
  float* ws = zs + kBwdSub * kLdn;       // [16][kLdn] W = H^T x', by step
  float* hin = ws + kBwdSub * kLdn;      // [64][kLdn] h0
  float* hb = hin + kBwdPT * kLdn;       // [64][kLdn] H
  float* sc = hb + kBwdPT * kLdn;        // [16][kLdt] (C_i . B_j) L_ij
  float* ml = sc + kBwdSub * kLdt;       // [16][kLdt] (g_i . x'_j) L_ij
  float* tt = ml + kBwdSub * kLdt;       // [16][kLdt] (C_i . B_j)(g_i . x'_j) L_ij
  float* cum = tt + kBwdSub * kLdt;      // [16] cs
  float* ec = cum + kBwdSub;             // [16] exp(cs_i)
  float* wt = ec + kBwdSub;              // [16] exp(cs_T - cs_j)
  float* dtm = wt + kBwdSub;             // [16] dt'
  float* mk = dtm + kBwdSub;             // [16] the mask, 1 or 0
  float* yo = mk + kBwdSub;              // [16] exp(cs_i) C_i . Z_i
  float* uu = yo + kBwdSub;              // [16] exp(cs_T - cs_j) B_j . W_j
  float* dxd = uu + kBwdSub;             // [16][2] dx' . x, by half of the tile
  float* red = dxd + 2 * kBwdSub;        // [8] <H, h0>, by warp
  float* dec = red + 8;                  // exp(cs_T)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int l16 = tid & 15, pr = tid >> 4;
  const int pti = blockIdx.x, npt = gridDim.x;
  const int p0 = pti * kBwdPT, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (a.H / a.G);
  const int pt = min(kBwdPT, a.P - p0);  // rows of this P tile
  const int K = a.K, n_sub = a.S / K, N = a.N;
  const float A = -expf(a.A_log[h]);
  const T* xg = static_cast<const T*>(a.x) + b * a.x_sb + h * a.x_sh + p0 * a.x_sp;
  const T* bg = static_cast<const T*>(a.B) + b * a.b_sb + g * a.b_sg;
  const T* cg = static_cast<const T*>(a.C) + b * a.c_sb + g * a.c_sg;
  const float* dtg = a.dt + b * a.dt_sb + h * a.dt_sh;
  const float* gg = a.dy + b * a.g_sb + h * a.g_sh + p0 * a.g_sp;
  const unsigned char* mg = a.mask != nullptr ? a.mask + b * a.m_sb : nullptr;
  const int64_t PN = (int64_t)a.P * N;
  // column of chunk element c of this thread in the (row group, lane)
  // layout: rows 4 pr .. + 3, columns (c / kW) 16 kW + l16 kW + c % kW
  auto col_of = [&](int c) { return (c / kW) * 16 * kW + l16 * kW + c % kW; };

  // H = dL/d the final state (rows of this tile; 0 past the tile and N)
  for (int i = tid; i < kBwdPT * kNPad; i += kBwdThreads) {
    const int p = i / kNPad, n = i - p * kNPad;
    hb[p * kLdn + n] =
        a.dfinal != nullptr && p < pt && n < N
            ? a.dfinal[b * a.f_sb + h * a.f_sh + (p0 + p) * a.f_sp + n * a.f_sn]
            : 0.f;
  }
  float dA_acc = 0.f;  // warp 0: sum of dt' da over the row's steps
  for (int c = n_sub - 1; c >= 0; --c) {
    const int s0 = c * K;
    if (tid < kBwdSub) {
      const float m = tid < K && (mg == nullptr || mg[(s0 + tid) * a.m_ss]) ? 1.f : 0.f;
      mk[tid] = m;
      dtm[tid] = m != 0.f ? dtg[(s0 + tid) * a.dt_ss] : 0.f;
    }
    __syncthreads();  // dt' is ready; the last sub-chunk's readers are done

    // float32 tiles: x, x' = x dt', g (rows past K and past the tile 0);
    // B, C (columns past N 0); h0, the forward's state after sub-chunk
    // c - 1, the initial state or 0
    for (int i = tid; i < kBwdSub * kBwdPT; i += kBwdThreads) {
      const int j = i / kBwdPT, p = i - j * kBwdPT;
      float xv = 0.f, gv = 0.f;
      if (j < K && p < pt) {
        xv = to_f(xg[(s0 + j) * a.x_ss + p * a.x_sp]);
        gv = gg[(s0 + j) * a.g_ss + p * a.g_sp];
      }
      xr[j * kLdp + p] = xv;
      xs[j * kLdp + p] = xv * dtm[j];
      gs[j * kLdp + p] = gv;
    }
    for (int i = tid; i < kBwdSub * kNPad; i += kBwdThreads) {
      const int j = i / kNPad, n = i - j * kNPad;
      const bool in = j < K && n < N;
      bs[j * kLdn + n] = in ? to_f(bg[(s0 + j) * a.b_ss + n * a.b_sn]) : 0.f;
      cs[j * kLdn + n] = in ? to_f(cg[(s0 + j) * a.c_ss + n * a.c_sn]) : 0.f;
    }
    if (c > 0) {
      const float* src =
          a.states + (((int64_t)b * n_sub + c - 1) * a.H + h) * PN + (int64_t)p0 * N;
      for (int i = tid; i < kBwdPT * kG4; i += kBwdThreads) {
        const int p = i / kG4, n = (i - p * kG4) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (p < pt && n < N) v = *reinterpret_cast<const float4*>(src + (int64_t)p * N + n);
        *reinterpret_cast<float4*>(hin + p * kLdn + n) = v;
      }
    } else {
      for (int i = tid; i < kBwdPT * kNPad; i += kBwdThreads) {
        const int p = i / kNPad, n = i - p * kNPad;
        hin[p * kLdn + n] =
            a.init != nullptr && p < pt && n < N
                ? a.init[b * a.i_sb + h * a.i_sh + (p0 + p) * a.i_sp + n * a.i_sn]
                : 0.f;
      }
    }
    __syncthreads();

    // warp 0: a = dt' A and its inclusive scan over the K steps
    if (warp == 0) {
      float v = lane < K ? dtm[lane] * A : 0.f;
#pragma unroll
      for (int o = 1; o < kBwdSub; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      const float last = __shfl_sync(0xffffffffu, v, K - 1);
      if (lane < kBwdSub) {  // past K: cs = cs_T (those rows are 0)
        cum[lane] = v;
        ec[lane] = expf(v);
        wt[lane] = expf(last - v);
      }
      if (lane == 0) *dec = expf(last);
    }
    // the step pairs C_i . B_j and g_i . x'_j, one (i, j) a thread
    const int pi = tid >> 4, pj = tid & 15;
    float dot_cb = 0.f, dot_gx = 0.f;
    if (pj <= pi && pi < K) {
      const float4* ci = reinterpret_cast<const float4*>(cs + pi * kLdn);
      const float4* bj = reinterpret_cast<const float4*>(bs + pj * kLdn);
#pragma unroll 4
      for (int n = 0; n < kNPad / 4; ++n) dot_cb = dot4(ci[n], bj[n], dot_cb);
      const float4* gi = reinterpret_cast<const float4*>(gs + pi * kLdp);
      const float4* xj = reinterpret_cast<const float4*>(xs + pj * kLdp);
#pragma unroll 4
      for (int p = 0; p < kBwdPT / 4; ++p) dot_gx = dot4(gi[p], xj[p], dot_gx);
    }
    // Z = h0^T g and W = H^T x' by step: columns 4 n4 .. + 3 of rows r0,
    // r0 + kRowStep, ...
    {
      const int n4 = tid % kG4, r0 = tid / kG4;
      float4 zacc[kZR], wacc[kZR];
#pragma unroll
      for (int k = 0; k < kZR; ++k) {
        zacc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
        wacc[k] = zacc[k];
      }
      if (r0 < kBwdSub) {
        for (int p = 0; p < pt; ++p) {
          const float4 hv = *reinterpret_cast<const float4*>(hin + p * kLdn + 4 * n4);
          const float4 bv = *reinterpret_cast<const float4*>(hb + p * kLdn + 4 * n4);
#pragma unroll
          for (int k = 0; k < kZR; ++k) {
            const int r = r0 + k * kRowStep;
            if (r < K) {
              fma4(zacc[k], hv, gs[r * kLdp + p]);
              fma4(wacc[k], bv, xs[r * kLdp + p]);
            }
          }
        }
#pragma unroll
        for (int k = 0; k < kZR; ++k) {
          const int r = r0 + k * kRowStep;
          *reinterpret_cast<float4*>(zs + r * kLdn + 4 * n4) = zacc[k];
          *reinterpret_cast<float4*>(ws + r * kLdn + 4 * n4) = wacc[k];
        }
      }
    }
    // V = H B^T by step and <H, h0>: B's rows 4 at a time, every lane's
    // part for its 4 rows of H, then the 16 lanes' parts summed: lane l16
    // keeps step 4 r + l16 / 4, row 4 pr + l16 % 4
    {
      float hv[4][kNR];
      float hd = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          float hi[kW];
          bwd_load<kW>(hb + (4 * pr + i) * kLdn + col_of(q * kW), hv[i] + q * kW);
          bwd_load<kW>(hin + (4 * pr + i) * kLdn + col_of(q * kW), hi);
#pragma unroll
          for (int e = 0; e < kW; ++e) hd = fmaf(hv[i][q * kW + e], hi[e], hd);
        }
#pragma unroll
      for (int r = 0; r < kBwdSub / 4; ++r) {
        if (4 * r >= K) continue;  // block-uniform
        float part[16];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          float bv[kNR];
#pragma unroll
          for (int q = 0; q < kQ; ++q)
            bwd_load<kW>(bs + (4 * r + ii) * kLdn + col_of(q * kW), bv + q * kW);
#pragma unroll
          for (int pp = 0; pp < 4; ++pp) {
            float acc = 0.f;
#pragma unroll
            for (int e = 0; e < kNR; ++e) acc = fmaf(bv[e], hv[pp][e], acc);
            part[ii * 4 + pp] = acc;
          }
        }
        halve_sum<16, 16, 8>(part, lane);
        vs[(4 * r + (l16 >> 2)) * kLdp + 4 * pr + (l16 & 3)] = part[0];
      }
      hd = warp_sum(hd);
      if (lane == 0) red[warp] = hd;
    }
    __syncthreads();  // cs, Z, W, V and <H, h0> are ready

    // the pairs under L, 0 above the diagonal and past K
    {
      float s = 0.f, m = 0.f, t = 0.f;
      if (pj <= pi && pi < K) {
        const float L = expf(cum[pi] - cum[pj]);
        s = dot_cb * L;
        m = dot_gx * L;
        t = s * dot_gx;
      }
      sc[pi * kLdt + pj] = s;
      ml[pi * kLdt + pj] = m;
      tt[pi * kLdt + pj] = t;
    }
    __syncthreads();

    // dx' = sum_{i >= j} S_ij g_i + exp(cs_T - cs_j) V_j: P row tid % 64,
    // steps tid / 64 + 4 k (one step a warp); dx = dx' dt' out, dx' . x
    // summed over the warp's 32 rows
    {
      const int p = tid & (kBwdPT - 1);
#pragma unroll
      for (int k = 0; k < kBwdSub / 4; ++k) {
        const int j = (tid >> 6) + 4 * k;
        if (j >= K) continue;  // warp-uniform
        float acc = wt[j] * vs[j * kLdp + p];
        for (int i = j; i < K; ++i) acc = fmaf(sc[i * kLdt + j], gs[i * kLdp + p], acc);
        if (p < pt) a.dx[(((int64_t)b * a.S + s0 + j) * a.H + h) * a.P + p0 + p] = acc * dtm[j];
        const float d = warp_sum(acc * xr[j * kLdp + p]);
        if (lane == 0) dxd[2 * j + (p >> 5)] = d;
      }
    }
    // dB_j = sum_{i >= j} ML_ij C_i + exp(cs_T - cs_j) W_j and dC_j =
    // sum_{i <= j} ML_ji B_i + exp(cs_j) Z_j: this head's and tile's parts
    for (int u = tid; u < kBwdSub * kNPad; u += kBwdThreads) {
      const int j = u / kNPad, n = u - j * kNPad;
      if (j >= K || n >= N) continue;
      float db = wt[j] * ws[j * kLdn + n], dc = ec[j] * zs[j * kLdn + n];
      for (int i = j; i < K; ++i) db = fmaf(ml[i * kLdt + j], cs[i * kLdn + n], db);
      for (int i = 0; i <= j; ++i) dc = fmaf(ml[j * kLdt + i], bs[i * kLdn + n], dc);
      const int64_t o = ((((int64_t)b * a.S + s0 + j) * a.H + h) * npt + pti) * N + n;
      a.dbp[o] = db;
      a.dcp[o] = dc;
    }
    // exp(cs_i) C_i . Z_i and exp(cs_T - cs_j) B_j . W_j: warp w rows 2 w,
    // 2 w + 1 (0 past K: those rows of Z and W are 0)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = 2 * warp + rr;
      float s1 = 0.f, s2 = 0.f;
      for (int n = lane; n < kNPad; n += 32) {
        s1 = fmaf(cs[r * kLdn + n], zs[r * kLdn + n], s1);
        s2 = fmaf(bs[r * kLdn + n], ws[r * kLdn + n], s2);
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (lane == 0) {
        yo[r] = ec[r] * s1;
        uu[r] = wt[r] * s2;
      }
    }
    // H = exp(cs_T) H + sum_i exp(cs_i) g_i C_i^T, rows 4 pr .. + 3 (no
    // reader of H is left in this sub-chunk)
    {
      const float d = *dec;
      float hv[4][kNR];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          bwd_load<kW>(hb + (4 * pr + i) * kLdn + col_of(q * kW), hv[i] + q * kW);
#pragma unroll
          for (int e = 0; e < kW; ++e) hv[i][q * kW + e] *= d;
        }
      for (int i = 0; i < K; ++i) {
        const float4 gv = *reinterpret_cast<const float4*>(gs + i * kLdp + 4 * pr);
        const float e = ec[i];
        const float gw[4] = {gv.x * e, gv.y * e, gv.z * e, gv.w * e};
        float cv[kNR];
#pragma unroll
        for (int q = 0; q < kQ; ++q)
          bwd_load<kW>(cs + i * kLdn + col_of(q * kW), cv + q * kW);
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int e2 = 0; e2 < kNR; ++e2) hv[ii][e2] = fmaf(gw[ii], cv[e2], hv[ii][e2]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < kNR; ++e) hb[(4 * pr + i) * kLdn + col_of(e)] = hv[i][e];
    }
    __syncthreads();  // dx' . x, the output and state terms are ready

    // warp 0: da_k, step k = lane; ddt and the dA_log sum
    if (warp == 0) {
      float da = 0.f;
      if (lane < K) {
        float hdot = 0.f;
        for (int w = 0; w < kBwdThreads / 32; ++w) hdot += red[w];
        da = *dec * hdot;
        for (int j = 0; j < lane; ++j) da += uu[j];
        for (int i = lane; i < K; ++i) {
          da += yo[i];
          for (int j = 0; j < lane; ++j) da += tt[i * kLdt + j];
        }
      }
      if (lane < K) {
        const float ddt = mk[lane] != 0.f ? dxd[2 * lane] + dxd[2 * lane + 1] + A * da : 0.f;
        a.dtp[(((int64_t)b * a.S + s0 + lane) * a.H + h) * npt + pti] = ddt;
      }
      dA_acc += warp_sum(lane < K ? dtm[lane] * da : 0.f);
    }
    __syncthreads();  // H is updated
  }
  // d initial state = H; this block's part of dA_log
  for (int i = tid; i < kBwdPT * kNPad; i += kBwdThreads) {
    const int p = i / kNPad, n = i - p * kNPad;
    if (p < pt && n < N)
      a.dinit[((int64_t)b * a.H + h) * PN + (int64_t)(p0 + p) * N + n] = hb[p * kLdn + n];
  }
  if (tid == 0) a.dap[((int64_t)b * a.H + h) * npt + pti] = A * dA_acc;
}

struct BwdSumArgs {
  const float* dbp;
  const float* dcp;
  const float* dtp;
  const float* dap;
  float* dB;   // (B, S, G, N)
  float* dC;   // (B, S, G, N)
  float* ddt;  // (B, S, H)
  float* dA;   // (H,)
  int Bb, S, H, G, N, npt;
};

// Kernel 2: the parts summed in a fixed order, one output a thread:
// blockIdx.y 0 dB and 1 dC (over the group's heads and the P tiles), 2 ddt
// (over the P tiles), 3 dA_log (over the rows and the P tiles).
__global__ void __launch_bounds__(256) ssd_scan_bwd_sum_kernel(BwdSumArgs a) {
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
    for (int k = 0; k < HG * a.npt; ++k) acc += src[(int64_t)k * a.N];
    (blockIdx.y ? a.dC : a.dB)[i] = acc;
  } else if (blockIdx.y == 2) {
    if (i >= rows * a.H) return;
    float acc = 0.f;
    for (int k = 0; k < a.npt; ++k) acc += a.dtp[i * a.npt + k];
    a.ddt[i] = acc;
  } else {
    if (i >= a.H) return;
    float acc = 0.f;
    for (int b = 0; b < a.Bb; ++b)
      for (int k = 0; k < a.npt; ++k) acc += a.dap[((int64_t)b * a.H + i) * a.npt + k];
    a.dA[i] = acc;
  }
}

template <typename T, int kNR>
cudaError_t launch_bwd(const BwdArgs& a, int Bb, cudaStream_t stream) {
  const size_t smem = sizeof(float) * bwd_smem_floats(16 * kNR);
  const dim3 grid((a.P + kBwdPT - 1) / kBwdPT, a.H, Bb);
  ssd_scan_bwd_kernel<T, kNR><<<grid, kBwdThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// N padded to the next of 16, 32, 64, 128, 256
template <typename T>
cudaError_t launch_bwd_n(const BwdArgs& a, int Bb, cudaStream_t stream) {
  if (a.N <= 16) return launch_bwd<T, 1>(a, Bb, stream);
  if (a.N <= 32) return launch_bwd<T, 2>(a, Bb, stream);
  if (a.N <= 64) return launch_bwd<T, 4>(a, Bb, stream);
  if (a.N <= 128) return launch_bwd<T, 8>(a, Bb, stream);
  return launch_bwd<T, 16>(a, Bb, stream);
}

}  // namespace rt

// Once per process, when the library is bound: every instantiation
// (prepare_kernels).
extern "C" int rt_prepare_ssd_bwd() {
  using namespace rt;
#define RT_BWD_KERNELS(T)                                                             \
  (const void*)ssd_scan_bwd_kernel<T, 1>, (const void*)ssd_scan_bwd_kernel<T, 2>,     \
      (const void*)ssd_scan_bwd_kernel<T, 4>, (const void*)ssd_scan_bwd_kernel<T, 8>, \
      (const void*)ssd_scan_bwd_kernel<T, 16>
  return prepare_kernels({RT_BWD_KERNELS(float), RT_BWD_KERNELS(__nv_bfloat16),
                          (const void*)ssd_scan_bwd_sum_kernel});
#undef RT_BWD_KERNELS
}

// Plain C entry point bound with ctypes.  x (Bb, S, H, P), B and C (Bb, S,
// G, N) float32 or bf16 (one dtype code for the three) with their strides;
// dt (Bb, S, H), A_log (H,) and dy (Bb, S, H, P) float32; mask (Bb, S)
// bool or null; init and dfinal (Bb, H, P, N) float32 or null; states (Bb,
// S / K, H, P, N) contiguous float32, the forward's state after every K
// steps.  Scratch: dtp (Bb, S, H, npt), dbp and dcp (Bb, S, H, npt, N), dap
// (Bb, H, npt), npt = ceil(P / 64).  Out, contiguous float32: dx (Bb, S,
// H, P), dinit (Bb, H, P, N), ddt (Bb, S, H), dB and dC (Bb, S, G, N), dA
// (H,).  K divides S, at most 16; P and N are multiples of 4, N <= 256.
// Returns cudaGetLastError() after the two launches.
extern "C" int rt_ssd_scan_bwd(
    const void* x, int64_t x_sb, int64_t x_ss, int64_t x_sh, int64_t x_sp, int dtype,
    const void* dt, int64_t dt_sb, int64_t dt_ss, int64_t dt_sh, const void* A_log,
    const void* B, int64_t b_sb, int64_t b_ss, int64_t b_sg, int64_t b_sn,
    const void* C, int64_t c_sb, int64_t c_ss, int64_t c_sg, int64_t c_sn,
    const void* mask, int64_t m_sb, int64_t m_ss,
    const void* init, int64_t i_sb, int64_t i_sh, int64_t i_sp, int64_t i_sn,
    const void* dy, int64_t g_sb, int64_t g_ss, int64_t g_sh, int64_t g_sp,
    const void* dfinal, int64_t f_sb, int64_t f_sh, int64_t f_sp, int64_t f_sn,
    const void* states, void* dx, void* dtp, void* dbp, void* dcp, void* dap, void* dinit,
    void* ddt, void* dB, void* dC, void* dA, int Bb, int S, int H, int G, int P, int N,
    int K, void* stream) {
  using namespace rt;
  if (Bb == 0 || H == 0 || S == 0) return cudaSuccess;
  if (K <= 0 || K > kBwdSub || S % K || P <= 0 || P % 4 || N <= 0 || N % 4 ||
      N > kBwdMaxN || G <= 0 || H % G) {
    return cudaErrorInvalidValue;
  }
  if (dtype != F32 && dtype != BF16) return cudaErrorInvalidValue;
  BwdArgs a = {x, x_sb, x_ss, x_sh, x_sp, static_cast<const float*>(dt), dt_sb, dt_ss,
               dt_sh, static_cast<const float*>(A_log), B, b_sb, b_ss, b_sg, b_sn, C,
               c_sb, c_ss, c_sg, c_sn, static_cast<const unsigned char*>(mask), m_sb,
               m_ss, static_cast<const float*>(init), i_sb, i_sh, i_sp, i_sn,
               static_cast<const float*>(dy), g_sb, g_ss, g_sh, g_sp,
               static_cast<const float*>(dfinal), f_sb, f_sh, f_sp, f_sn,
               static_cast<const float*>(states), static_cast<float*>(dx),
               static_cast<float*>(dtp), static_cast<float*>(dbp), static_cast<float*>(dcp),
               static_cast<float*>(dap), static_cast<float*>(dinit), S, H, G, P, N, K};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == F32 ? launch_bwd_n<float>(a, Bb, s)
                                 : launch_bwd_n<__nv_bfloat16>(a, Bb, s);
  if (err != cudaSuccess) return err;
  const int npt = (P + kBwdPT - 1) / kBwdPT;
  BwdSumArgs r = {static_cast<const float*>(dbp), static_cast<const float*>(dcp),
                  static_cast<const float*>(dtp),
                  static_cast<const float*>(dap), static_cast<float*>(dB),
                  static_cast<float*>(dC), static_cast<float*>(ddt), static_cast<float*>(dA),
                  Bb, S, H, G, N, npt};
  const int64_t most = std::max<int64_t>((int64_t)Bb * S * std::max(G * N, H), H);
  const dim3 grid(static_cast<unsigned>((most + 255) / 256), 4);
  ssd_scan_bwd_sum_kernel<<<grid, 256, 0, s>>>(r);
  return cudaGetLastError();
}
