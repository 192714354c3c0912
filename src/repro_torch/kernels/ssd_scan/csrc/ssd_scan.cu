// Mamba-2 SSD scan for Hopper (sm_90a): the whole chunked scan of
// kernels/ssd_scan/ops.py::ssd in one launch.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/ssd_scan.py::
// _ssd_chunk_kernel (wrapper ssd_chunks) together with the JAX wrapper
// around it (repro/kernels/ssd_scan/ops.py::ssd: the dt mask, dA = dt * A,
// the inter-chunk recurrence and the state -> output term).  Per row b and
// head h, all in float32, with dt' = dt at real steps and 0 at masked ones:
//   x'_s = x_s * dt'_s,   a_s = dt'_s * A,   A = -exp(A_log[h])
//   y_s  = sum_{t <= s} (C_s . B_t) exp(a_{t+1} + .. + a_s) x'_t   (+ the
//          initial state's term C_s . h0 exp(a_1 + .. + a_s))
//   h    = the state after the last step, and with checkpoints the state
//          after every chunk of Q steps.
// B and C belong to the head's group g = h / (H / G).  x, B and C are read
// as stored (float32 or bf16), dt, A_log, the states and y are float32.
//
// What bounds it on the H100: the bytes with checkpoints, the float32
// products without.  At the cold prefill of mamba2-2.7b (B 8, S 128, Q 16,
// H 80, P 64, N 128; x, B and C in bf16) the call reads x, dt, B and C (11
// MB), writes y (21 MB), the final state (21 MB) and 8 checkpoints of 21
// MB (168 MB): 0.22 GB, 0.066 ms at 3.35 TB/s; without checkpoints (the
// dense-cache prefill) 0.05 GB, 0.016 ms.  Its products, 2 * S * P * N
// per (row, head) for each of the state update and the state -> output
// term, plus C B^T once per group and its product with x, are 2.8 GFLOP,
// 0.041 ms at the float32 CUDA-core peak.  Before this kernel the scan wrote
// the chunk states, read them back for the host recurrence (one op per
// chunk) and again for the output term: 0.85 GB and nc + 6 host ops.
//
// Design: one block of 256 threads per (P tile of 64, head, row), walking
// the row's steps in order with the running state tile (64, N) of its
// head in registers.  The TPU kernel's grid ran the (row, head, chunk)
// steps in order and left the recurrence to XLA; here the chunk axis is a
// loop inside the block and the recurrence never leaves the chip.  The
// walk is in sub-chunks of up to 16 steps that never straddle a
// checkpoint (the chunk of Q steps when checkpoints are asked for, else
// the whole row): the SSD is exact at any chunk length, so the result is
// the chunked scan's up to float32 rounding, and short sub-chunks keep the
// quadratic part (C B^T, 16 x 16) small.  Per sub-chunk of T steps:
//   - the next sub-chunk's x, dt, B and C are prefetched with cp.async
//     into the other stage of a two-stage ring (the mask byte in a
//     register), then this one is converted to float32 working tiles
//     (x' = x * dt', B, C; rows past T and columns past N zero);
//   - warp 0 scans a = dt' * A with shuffles: cs, exp(cs_i), exp(cs_T -
//     cs_j) and the sub-chunk's decay exp(cs_T);
//   - S = (C B^T) * L, L_ij = exp(cs_i - cs_j) for j <= i, once for the
//     block's 64 rows of P;
//   - y_i = exp(cs_i) (C h^T)_i + sum_{j <= i} S_ij x'_j, written straight
//     into the (B, S, H, P) output;
//   - h = exp(cs_T) h + sum_j exp(cs_T - cs_j) x'_j^T B_j in registers;
//     at a checkpoint h is written to the (B, nc, H, P, N) buffer.
// After the last sub-chunk the final state is written.
//
// The products run on CUDA cores in float32 (a single TF32 pass would
// break the float32 tolerances and the card-vs-CPU token identity).
// Thread (pr, l) = (tid / 16, tid % 16) holds rows 4 pr .. + 3 and N / 16
// columns of the state (chunks of 4 at q * 64 + 4 l, so 16 lanes read 256
// contiguous bytes); C h^T takes 4 steps at a time and sums the 16 lanes
// of a row group by a halving reduce-scatter (15 shuffles for 16 values);
// C B^T is one (i, j) pair a thread.  C B^T is computed again for each
// head of a group, 1/16 of the block's products at 16-step sub-chunks.  P
// and N must be multiples of 4 (the wrapper checks), N at most 256 (the
// state tile in registers).
//
// A step with dt' = 0 (a masked pad step) is an exact identity: a = -0, so
// every decay is exp(0) = 1 and x' = 0, and h passes through bit for bit;
// the snapshot restore relies on it.  The build uses no fast-math flags.
#include <algorithm>

#include "tensor_core.cuh"
#include "tile_attention.cuh"

namespace rt {

constexpr int kScanPT = 64;                // rows of P a block owns
constexpr int kScanThreads = 4 * kScanPT;  // 16 lanes for 4 rows; 8 warps
constexpr int kScanSub = 16;               // steps of a sub-chunk, at most
constexpr int kScanMaxN = 256;             // state columns: 16 lanes x kNR, kNR <= 16
constexpr int kLdx = kScanPT + 8;          // row stride of x' (and y partials)

// rows x (cpr * per) elements of T from src (row stride rs, element
// stride es) into dst (row stride ld), by the whole block, cpr copies a
// row: cp.async of vb bytes (16, 8 or 4, per = vb / sizeof(T) elements;
// es == 1 and every row start aligned), or element by element (vb 0, per
// 1)
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* src, int64_t rs,
                                           int64_t es, int rows, int cpr, int per, int vb) {
  for (int c = threadIdx.x; c < rows * cpr; c += kScanThreads) {
    const int r = c / cpr, e = (c - r * cpr) * per;
    T* d = dst + r * ld + e;
    const T* s = src + r * rs + e * es;
    if (vb == 16) {
      cp_async_ca<16>(d, s);
    } else if (vb == 8) {
      cp_async_ca<8>(d, s);
    } else if (vb == 4) {
      cp_async_ca<4>(d, s);
    } else {
      *d = *s;
    }
  }
}

// kW consecutive floats of shared memory (kW 1, 2 or 4) into v[0 .. kW)
template <int kW>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
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

// Shared memory of a block: two raw stages (x, B, C as stored, dt, mask)
// and the float32 working tiles.
struct ScanSmem {
  size_t stage, x, bc, dt;  // bytes of a stage and offsets in it
  size_t xs, bs, cs, sc, cum, total;
};

__host__ __device__ inline ScanSmem scan_smem(int esize, int n_pad) {
  ScanSmem m;
  m.x = 0;
  m.bc = (size_t)kScanSub * kScanPT * esize;
  m.dt = m.bc + (size_t)2 * kScanSub * n_pad * esize;
  m.stage = m.dt + sizeof(float) * 2 * kScanSub;
  const int ldn = n_pad + 8;
  m.xs = 2 * m.stage;
  m.bs = m.xs + sizeof(float) * kScanSub * kLdx;
  m.cs = m.bs + sizeof(float) * kScanSub * ldn;
  m.sc = m.cs + sizeof(float) * kScanSub * ldn;
  m.cum = m.sc + sizeof(float) * kScanSub * (kScanSub + 1);
  m.total = m.cum + sizeof(float) * (3 * kScanSub + 4);
  return m;
}

struct ScanArgs {
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
  float* y;      // (B, S, H, P), contiguous
  float* final;  // (B, H, P, N), contiguous
  float* ckpt;   // (B, nc, H, P, N), contiguous, or null
  int S, H, G, P, N, Q;
  int vbx, vbbc;  // copy widths of x and of B / C rows
};

// Block (P tile blockIdx.x, head blockIdx.y, row blockIdx.z).  kNR: state
// columns a thread holds (N <= 16 kNR).
template <typename T, int kNR>
__global__ void __launch_bounds__(kScanThreads, 2) ssd_scan_kernel(ScanArgs a) {
  constexpr int kW = kNR < 4 ? kNR : 4;  // columns of one chunk
  constexpr int kQ = kNR / kW;           // chunks, 16 * kW columns apart
  constexpr int kNPad = 16 * kNR;
  constexpr int kLdn = kNPad + 8;
  constexpr int kLds = kScanSub + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const ScanSmem m = scan_smem(sizeof(T), kNPad);
  float* xs = reinterpret_cast<float*>(smem + m.xs);    // [16][kLdx]  x'
  float* bs = reinterpret_cast<float*>(smem + m.bs);    // [16][kLdn]
  float* cs = reinterpret_cast<float*>(smem + m.cs);    // [16][kLdn]
  float* sc = reinterpret_cast<float*>(smem + m.sc);    // [16][kLds] (C B^T) * L
  float* cum = reinterpret_cast<float*>(smem + m.cum);  // [16] cs
  float* wt = cum + kScanSub;                           // [16] exp(cs_T - cs_j)
  float* ec = wt + kScanSub;                            // [16] exp(cs_i)
  float* dec = ec + kScanSub;                           // exp(cs_T)

  const int tid = threadIdx.x, lane = tid & 31, l16 = tid & 15, pr = tid >> 4;
  const int p0 = blockIdx.x * kScanPT, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (a.H / a.G);
  const int pt = min(kScanPT, a.P - p0);  // rows of this P tile
  const int nc = a.S / a.Q;                         // chunks (checkpoints)
  const int spc = (a.Q + kScanSub - 1) / kScanSub;  // sub-chunks a chunk
  const int n_sub = nc * spc;
  const T* xg = static_cast<const T*>(a.x) + b * a.x_sb + h * a.x_sh + p0 * a.x_sp;
  const T* bg = static_cast<const T*>(a.B) + b * a.b_sb + g * a.b_sg;
  const T* cg = static_cast<const T*>(a.C) + b * a.c_sb + g * a.c_sg;
  const float* dtg = a.dt + b * a.dt_sb + h * a.dt_sh;
  const unsigned char* mg = a.mask != nullptr ? a.mask + b * a.m_sb : nullptr;
  // copies a row and elements a copy, of x and of B / C
  const int per_x = a.vbx ? a.vbx / static_cast<int>(sizeof(T)) : 1;
  const int per_bc = a.vbbc ? a.vbbc / static_cast<int>(sizeof(T)) : 1;
  const int cpr_x = (pt + per_x - 1) / per_x, cpr_bc = (a.N + per_bc - 1) / per_bc;

  // sub-chunk k: steps [s0, s0 + nt), the r-th of its chunk
  auto sub = [&](int k, int& s0) {
    const int c = k / spc, r = k - c * spc;
    s0 = c * a.Q + r * kScanSub;
    return min(kScanSub, a.Q - r * kScanSub);
  };
  // issue the copies of the sub-chunk at step s0 (nt steps) into stage
  // st; the mask bit of step tid comes back in a register
  auto prefetch = [&](int s0, int nt, int st, int& mbit) {
    unsigned char* raw = smem + st * m.stage;
    stage_rows(reinterpret_cast<T*>(raw + m.x), kScanPT, xg + s0 * a.x_ss, a.x_ss, a.x_sp, nt,
               cpr_x, per_x, a.vbx);
    stage_rows(reinterpret_cast<T*>(raw + m.bc), kNPad, bg + s0 * a.b_ss, a.b_ss, a.b_sn, nt,
               cpr_bc, per_bc, a.vbbc);
    stage_rows(reinterpret_cast<T*>(raw + m.bc) + kScanSub * kNPad, kNPad, cg + s0 * a.c_ss,
               a.c_ss, a.c_sn, nt, cpr_bc, per_bc, a.vbbc);
    if (tid < nt) {
      cp_async_ca<4>(reinterpret_cast<float*>(raw + m.dt) + tid, dtg + (s0 + tid) * a.dt_ss);
      mbit = mg == nullptr || mg[(s0 + tid) * a.m_ss];
    }
  };

  // state element hs[i][c] of this thread: row 4 pr + i, column col_of(c)
  // of the tile
  auto col_of = [&](int c) { return (c / kW) * 16 * kW + l16 * kW + c % kW; };
  float hs[4][kNR];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kNR; ++c) {
      const int p = 4 * pr + i, n = col_of(c);
      hs[i][c] = a.init != nullptr && p < pt && n < a.N
                     ? a.init[b * a.i_sb + h * a.i_sh + (p0 + p) * a.i_sp + n * a.i_sn]
                     : 0.f;
    }
  // the state to device memory: rows of this tile, columns below N (N % 4
  // == 0, so a chunk of columns is all in or all out); dst is the (P, N)
  // state of this row and head
  auto store_state = [&](float* dst) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < kNR; c += kW) {
        const int p = 4 * pr + i, n = col_of(c);
        if (p >= pt || n >= a.N) continue;
        float* d = dst + (p0 + p) * a.N + n;
        if constexpr (kW == 4) {
          *reinterpret_cast<float4*>(d) =
              make_float4(hs[i][c], hs[i][c + 1], hs[i][c + 2], hs[i][c + 3]);
        } else {
#pragma unroll
          for (int e = 0; e < kW; ++e) d[e] = hs[i][c + e];
        }
      }
  };
  const float A = -expf(a.A_log[h]);
  const int64_t PN = (int64_t)a.P * a.N, HP = (int64_t)a.H * a.P;
  float* yg = a.y + (int64_t)b * a.S * HP + (int64_t)h * a.P + p0;  // step 0, row p0
  float* ckg = a.ckpt != nullptr ? a.ckpt + ((int64_t)b * nc * a.H + h) * PN : nullptr;

  int mbit = 1, s0, nt = n_sub > 0 ? sub(0, s0) : 0;
  if (n_sub > 0) prefetch(s0, nt, 0, mbit);
  cp_async_commit();
  for (int k = 0; k < n_sub; ++k) {
    const int st = k & 1;
    unsigned char* raw = smem + st * m.stage;
    float* dts = reinterpret_cast<float*>(raw + m.dt);
    int* mks = reinterpret_cast<int*>(dts + kScanSub);
    if (tid < nt) mks[tid] = mbit;
    cp_async_wait<0>();
    __syncthreads();  // stage st landed; the previous sub-chunk's readers are done
    int s1 = 0;
    const int nt1 = k + 1 < n_sub ? sub(k + 1, s1) : 0;
    if (k + 1 < n_sub) prefetch(s1, nt1, st ^ 1, mbit);
    cp_async_commit();

    // warp 0: a = dt' A and its inclusive scan over the nt steps
    if (tid < 32) {
      const float dtm = lane < nt && mks[lane] ? dts[lane] : 0.f;
      float v = dtm * A;
#pragma unroll
      for (int o = 1; o < kScanSub; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      const float last = __shfl_sync(0xffffffffu, v, nt - 1);
      if (lane < kScanSub) {  // past nt: cs = cs_T, weight 1 (x' is 0 there)
        cum[lane] = v;
        wt[lane] = expf(last - v);
        ec[lane] = expf(v);
      }
      if (lane == 0) *dec = expf(last);
    }
    // float32 working tiles: x' = x dt', B, C; rows past nt, rows of x'
    // past the tile and columns past N zero
    const T* xr = reinterpret_cast<const T*>(raw + m.x);
    const T* br = reinterpret_cast<const T*>(raw + m.bc);
    const T* cr = br + kScanSub * kNPad;
    for (int i = tid; i < kScanSub * kScanPT; i += kScanThreads) {
      const int j = i / kScanPT, p = i - j * kScanPT;
      const float dtm = j < nt && mks[j] ? dts[j] : 0.f;
      xs[j * kLdx + p] = j < nt && p < pt ? to_f(xr[i]) * dtm : 0.f;
    }
    for (int i = tid; i < kScanSub * kNPad; i += kScanThreads) {
      const int j = i / kNPad, n = i - j * kNPad;
      const bool in = j < nt && n < a.N;
      bs[j * kLdn + n] = in ? to_f(br[i]) : 0.f;
      cs[j * kLdn + n] = in ? to_f(cr[i]) : 0.f;
    }
    __syncthreads();

    // S = (C B^T) * L, one (i, j) pair a thread, 0 above the diagonal
    {
      const int i = tid >> 4, j = tid & 15;
      const float4* ci = reinterpret_cast<const float4*>(cs + i * kLdn);
      const float4* bj = reinterpret_cast<const float4*>(bs + j * kLdn);
      float dot = 0.f;
      if (j <= i) {
#pragma unroll 4
        for (int n = 0; n < kNPad / 4; ++n) {
          const float4 u = ci[n], w = bj[n];
          dot = fmaf(u.x, w.x, dot);
          dot = fmaf(u.y, w.y, dot);
          dot = fmaf(u.z, w.z, dot);
          dot = fmaf(u.w, w.w, dot);
        }
      }
      sc[i * kLds + j] = j <= i ? dot * expf(cum[i] - cum[j]) : 0.f;
    }

    // C h^T: 4 steps at a time, every lane's part for its 4 rows, then
    // the 16 lanes' parts summed: lane l16 keeps step 4 r + l16 / 4, row
    // 4 pr + l16 % 4
    float yo[kScanSub / 4];
#pragma unroll
    for (int r = 0; r < kScanSub / 4; ++r) {
      yo[r] = 0.f;
      if (4 * r >= nt) continue;  // block-uniform
      float part[16];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = 4 * r + ii;
        float cv[kNR];
#pragma unroll
        for (int q = 0; q < kQ; ++q)
          load_vec<kW>(cs + i * kLdn + q * 16 * kW + l16 * kW, cv + q * kW);
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) {
          float acc = 0.f;
#pragma unroll
          for (int c = 0; c < kNR; ++c) acc = fmaf(cv[c], hs[pp][c], acc);
          part[ii * 4 + pp] = acc;
        }
      }
      halve_sum<16, 16, 8>(part, lane);
      yo[r] = part[0];
    }
    __syncthreads();  // S is ready

    // y = exp(cs_i) (C h^T)_i + sum_{j <= i} S_ij x'_j
    const int pl = 4 * pr + (l16 & 3);
#pragma unroll
    for (int r = 0; r < kScanSub / 4; ++r) {
      const int i = 4 * r + (l16 >> 2);
      if (i < nt && pl < pt) {
        float yd = 0.f;
#pragma unroll
        for (int j = 0; j < kScanSub; ++j)  // S is 0 above the diagonal
          yd = fmaf(sc[i * kLds + j], xs[j * kLdx + pl], yd);
        yg[(s0 + i) * HP + pl] = fmaf(ec[i], yo[r], yd);
      }
    }

    // h = exp(cs_T) h + sum_j exp(cs_T - cs_j) x'_j^T B_j
    const float d = *dec;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < kNR; ++c) hs[i][c] *= d;
    for (int j = 0; j < nt; ++j) {
      const float4 xv = *reinterpret_cast<const float4*>(xs + j * kLdx + 4 * pr);
      const float w = wt[j];
      const float xw[4] = {xv.x * w, xv.y * w, xv.z * w, xv.w * w};
      float bv[kNR];
#pragma unroll
      for (int q = 0; q < kQ; ++q)
        load_vec<kW>(bs + j * kLdn + q * 16 * kW + l16 * kW, bv + q * kW);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kNR; ++c) hs[i][c] = fmaf(xw[i], bv[c], hs[i][c]);
    }

    // the state at a checkpoint (the end of a chunk)
    if (ckg != nullptr && (k + 1) % spc == 0) store_state(ckg + (int64_t)(k / spc) * a.H * PN);
    s0 = s1;
    nt = nt1;
  }
  cp_async_wait<0>();
  store_state(a.final + ((int64_t)b * a.H + h) * PN);
}

template <typename T, int kNR>
cudaError_t launch_scan(const ScanArgs& a, int Bb, cudaStream_t stream) {
  const size_t smem = scan_smem(sizeof(T), 16 * kNR).total;
  const dim3 grid((a.P + kScanPT - 1) / kScanPT, a.H, Bb);
  ssd_scan_kernel<T, kNR><<<grid, kScanThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// N padded to the next of 16, 32, 64, 128, 256
template <typename T>
cudaError_t launch_scan_n(const ScanArgs& a, int Bb, cudaStream_t stream) {
  if (a.N <= 16) return launch_scan<T, 1>(a, Bb, stream);
  if (a.N <= 32) return launch_scan<T, 2>(a, Bb, stream);
  if (a.N <= 64) return launch_scan<T, 4>(a, Bb, stream);
  if (a.N <= 128) return launch_scan<T, 8>(a, Bb, stream);
  return launch_scan<T, 16>(a, Bb, stream);
}

// widest of 16, 8, 4 bytes that a row copy of `width` elements of esize
// bytes can use: contiguous rows (es 1) whose starts and length are all
// multiples of it; else 0 (element by element)
inline int copy_width(const void* base, int64_t es, int64_t bits, int width, int esize) {
  if (es != 1) return 0;
  const uint64_t align = (uint64_t)bits * esize | (uint64_t)width * esize |
                         reinterpret_cast<uintptr_t>(base);
  return align % 16 == 0 ? 16 : align % 8 == 0 ? 8 : align % 4 == 0 ? 4 : 0;
}

}  // namespace rt

// Once per process, when the library is bound: every scan instantiation
// (prepare_kernels).
extern "C" int rt_prepare_ssd() {
  using namespace rt;
#define RT_SCAN_KERNELS(T)                                                    \
  (const void*)ssd_scan_kernel<T, 1>, (const void*)ssd_scan_kernel<T, 2>,     \
      (const void*)ssd_scan_kernel<T, 4>, (const void*)ssd_scan_kernel<T, 8>, \
      (const void*)ssd_scan_kernel<T, 16>
  return prepare_kernels({RT_SCAN_KERNELS(float), RT_SCAN_KERNELS(__nv_bfloat16)});
#undef RT_SCAN_KERNELS
}

// Plain C entry point bound with ctypes.  x (Bb, S, H, P), B and C (Bb,
// S, G, N) float32 or bf16 (one dtype code for the three) with their
// strides; dt (Bb, S, H) and A_log (H,) float32; mask (Bb, S) bool or
// null; init (Bb, H, P, N) float32 or null; y (Bb, S, H, P), final (Bb,
// H, P, N) and ckpt (Bb, S / Q, H, P, N, or null) contiguous float32.  Q
// divides S: the checkpoint interval (S without checkpoints).  P and N are
// multiples of 4, N <= 256.  Returns cudaGetLastError() of the launch.
extern "C" int rt_ssd_scan(
    const void* x, int64_t x_sb, int64_t x_ss, int64_t x_sh, int64_t x_sp, int dtype,
    const void* dt, int64_t dt_sb, int64_t dt_ss, int64_t dt_sh, const void* A_log,
    const void* B, int64_t b_sb, int64_t b_ss, int64_t b_sg, int64_t b_sn,
    const void* C, int64_t c_sb, int64_t c_ss, int64_t c_sg, int64_t c_sn,
    const void* mask, int64_t m_sb, int64_t m_ss,
    const void* init, int64_t i_sb, int64_t i_sh, int64_t i_sp, int64_t i_sn,
    void* y, void* final, void* ckpt, int Bb, int S, int H, int G, int P, int N, int Q,
    void* stream) {
  using namespace rt;
  if (Bb == 0 || H == 0) return cudaSuccess;
  if (Q <= 0 || S % Q || P <= 0 || P % 4 || N <= 0 || N % 4 || N > kScanMaxN || G <= 0 ||
      H % G) {
    return cudaErrorInvalidValue;
  }
  const int esize = dtype == F32 ? 4 : dtype == BF16 ? 2 : 0;
  if (esize == 0) return cudaErrorInvalidValue;
  ScanArgs a = {x, x_sb, x_ss, x_sh, x_sp, static_cast<const float*>(dt), dt_sb, dt_ss, dt_sh,
                static_cast<const float*>(A_log), B, b_sb, b_ss, b_sg, b_sn, C, c_sb, c_ss,
                c_sg, c_sn, static_cast<const unsigned char*>(mask), m_sb, m_ss,
                static_cast<const float*>(init), i_sb, i_sh, i_sp, i_sn,
                static_cast<float*>(y), static_cast<float*>(final), static_cast<float*>(ckpt),
                S, H, G, P, N, Q, 0, 0};
  // x rows of a P tile start at multiples of 64 elements; B and C rows
  // hold N elements
  a.vbx = copy_width(x, x_sp, x_sb | x_ss | x_sh, P % kScanPT ? 4 : kScanPT, esize);
  a.vbbc = std::min(copy_width(B, b_sn, b_sb | b_ss | b_sg, N, esize),
                    copy_width(C, c_sn, c_sb | c_ss | c_sg, N, esize));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == F32 ? launch_scan_n<float>(a, Bb, s) : launch_scan_n<__nv_bfloat16>(a, Bb, s);
}
