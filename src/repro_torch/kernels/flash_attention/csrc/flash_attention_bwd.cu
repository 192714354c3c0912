// The backward of prefill flash attention for Hopper (sm_90a).
//
// rt_flash_attention_bwd is the gradient of rt_flash_attention (the port of
// the TPU kernel src/repro/kernels/flash_attention/flash_attention.py::
// _flash_kernel, which has no backward: JAX trains through the plain
// layers.chunked_attention, whose gradient XLA derives).  From q, k, v, the
// forward's output and log-sum-exp (lse) and the output's cotangent dout it
// computes dq, dk and dv, recomputing P = exp(scale q.k - lse) tile by
// tile, under every mask the forward takes: causal, sliding window,
// bidirectional, the per-row key-length mask kv_len and Sq != Skv (q
// positions aligned to the end of the keys), with GQA (q head h reads kv
// head h / G).  Every sum is float32, D = rowsum(dout * out) among them
// (float32 (B, Hq, Sq) scratch).  Launches go on the caller's stream, with
// no atomics: each gradient element is written once, by one block, so two
// calls on the same inputs give the same bits.  The route is by dtype
// alone, as in the forward:
//
// * bf16: bwd_dq_tc_kernel, which also writes D, then bwd_dkdv_tc_kernel:
//   FlashAttention-2's backward on the tensor cores (mma.sync m16n8k16 bf16
//   from ldmatrix fragments, float32 accumulators).
// * float32: bwd_dot_kernel (D, one warp a row), then bwd_dkdv_kernel,
//   which also stores dS^T, then bwd_dq_kernel, on CUDA cores, so that the
//   products stay exact float32 (each a fmaf in a fixed order: the card's
//   float32 train steps are held to the CPU's), as the forward's
//   flash_kernel does.
//
// Bound on the H100 at qwen3-4b's training shape (bf16, causal, B4 S512
// Hq32 Hkv8 Dh128): 84.2 MB of q, k, v, out, dout and lse in and dq, dk,
// dv out take 0.0251 ms at 3.35 TB/s; the five causal matrix products (S,
// dP, dV, dK, dQ) are 21.5 GFLOP, 0.0217 ms at the bf16 tensor-core peak.
// Bytes bound the call, but only just: near its bound a kernel has to run
// its products near the tensor cores' peak as well.  In float32 the same
// 21.5 GFLOP take 0.321 ms at the CUDA cores' 67 TFLOP/s, against 0.050 ms
// for its 168 MB: operations bound it, and the route is built to keep the
// FMA pipes busy.
//
// The float32 route:
//
// * bwd_dkdv_kernel: one block of 8 warps per (kv head, row b, 64 keys; 32
//   past Dh 128), the earliest keys first, K and V resident in shared
//   memory, walking packed (q position, q head) rows as the bf16 route
//   does (one walk covers the G q heads), 32 rows of Q and dO a step
//   through a two-stage cp.async ring.  The two groups of 4 warps split a
//   step by product, so a thread's tiles are as large as its registers
//   allow (4 x 4 of S^T or dP^T, 8 x 8 of dV or dK at Dh 128, every
//   operand a float4 read from rows padded against bank conflicts): group
//   0 forms P^T and sums dV, group 1 forms dS^T from P^T and dP^T and sums
//   dK, and also stores dS^T to a float32 scratch (B, Hkv, Skv, G Sq
//   rounded up to 64).  The mask is a branch-free test of each row's key
//   window.  One block an SM (151 KB of shared memory at Dh 128).
// * bwd_dq_kernel: dQ = dS K as a GEMM pass over that scratch, in place of
//   recomputing S and dP (five products in all, not seven): a block per
//   (kv head, row b, 64 packed rows), the last rows first, K and dS^T
//   tiles of 32 keys through a two-stage ring, each group summing half of
//   a tile's keys, the halves meeting in a fixed order.  The scratch costs
//   134 MB written and read at the training shape, where recomputing S
//   and dP would cost 8.6 GFLOP more (PERF.md, section 6).
//
// Any Dh % 4 == 0 up to 256 runs in three classes (64, 128, 256), a
// smaller Dh with zero columns; rows start on 16 bytes (the wrapper copies
// otherwise).
//
// The bf16 route:
//
// * bwd_dkdv_tc_kernel: one block of 4 warps per (kv head, row b, tile of
//   32 keys): each pair of warps owns 16 keys and holds their dK and dV in
//   float32 registers for the whole walk, with K and V resident in shared
//   memory.  The walk goes over packed (q position, q head) rows as the
//   forward packs them (row p is q position p / G of q head p % G of the
//   kv head), so one walk covers the G q heads, from the first position
//   the causal limit lets see the block's keys to the last the window
//   does.  Q, dO, lse and D tiles of 64 packed rows stream through a
//   two-stage cp.async ring, and each warp of a pair takes 32 of the rows.
//   With keys as the M dimension, S^T = K Q^T and dP^T = V dO^T take K and
//   V as A fragments and Q and dO as B fragments; P^T = exp2(scale log2e
//   S^T - lse log2e) and dS^T = P^T (dP^T - D) are formed in registers,
//   rounded to bf16 and used directly as the A operand of dV += P^T dO and
//   dK += dS^T Q (Q and dO through ldmatrix.trans): the forward's P -> A
//   trick, with no trip through shared memory.  A warp skips rows that
//   none of its keys can see, and at the end the pair's two sums meet in
//   shared memory in a fixed order.  32-key tiles give the causal walk
//   twice the blocks of 64-key ones (512 at the training shape, the
//   longest walks first), so the short walks of the late keys fill the
//   card while the early keys' long walks run.  Past Dh 128 the
//   accumulators (2 x 16 x Dh floats a warp) would not fit in registers,
//   so a block accumulates 128 of the columns and each key tile has two
//   blocks, each recomputing S^T and dP^T.  dK and dV take 128 of a
//   thread's registers at Dh 128, so two blocks share an SM.
// * bwd_dq_tc_kernel: one block of 4 warps per (64 packed rows, kv head,
//   row b), the forward's grid, the rows that see the most keys first;
//   each warp owns 16 rows, with their lse and D in registers (D summed
//   from dout and out by the quad of lanes that holds a row, and stored
//   for the dK/dV kernel).  Up to Dh 128 a thread takes at most 170
//   registers, so three blocks share an SM.  K and V
//   tiles of 32 keys stream through a two-stage cp.async ring; S = Q K^T
//   and dP = dO V^T run as the forward's Q K^T, and dS, rounded to bf16 in
//   registers, is the A operand of dQ += dS K (K through ldmatrix.trans).
//
// Masks apply per element only in tiles that cross the causal limit, the
// window, the key limit or the ragged end of the rows; elsewhere the walk's
// bounds are the mask.  A row with no valid key gets zero gradients.  Any
// Dh % 16 == 0 up to 256 is taken, in three classes (Dh <= 64, <= 128,
// <= 256), each instantiated twice: for Dh equal to the class's largest,
// with constant loop bounds, and for the rest with guarded loops; the
// wrapper raises on any other bf16 head dim.  Left for
// a wgmma + TMA redesign: S and dP are computed in both kernels (seven
// products where the minimum is five; folding dQ into the dK/dV walk needs
// a deterministic cross-block sum), the products are warp-level mma.sync
// rather than warpgroup wgmma, and the copies are cp.async by every thread
// rather than TMA from one producer warp.
#include <type_traits>

#include "tensor_core.cuh"
#include "tile_attention.cuh"

namespace rt {

// ---------------------------------------------------------------------------
// D (both routes) and the float32 route: CUDA cores
// ---------------------------------------------------------------------------
__device__ __forceinline__ int bwd_key_limit(const int* kv_len, int b, int Skv) {
  return kv_len != nullptr ? max(0, min(Skv, kv_len[b])) : Skv;
}

__global__ void __launch_bounds__(kThreads) bwd_dot_kernel(
    const float* __restrict__ out, int64_t o_sb, int64_t o_ss, int64_t o_sh,
    const float* __restrict__ dout, int64_t d_sb, int64_t d_ss, int64_t d_sh,
    float* __restrict__ D, int Sq, int Dh) {
  const int i = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int h = blockIdx.y, b = blockIdx.z, lane = threadIdx.x & 31;
  if (i >= Sq) return;
  const float* o = out + b * o_sb + i * o_ss + h * o_sh;
  const float* g = dout + b * d_sb + i * d_ss + h * d_sh;
  float acc = 0.f;
  for (int d = lane; d < Dh; d += 32) acc = fmaf(o[d], g[d], acc);
  acc = warp_sum(acc);
  if (lane == 0) D[((int64_t)b * gridDim.y + h) * Sq + i] = acc;
}

constexpr int kF32Threads = 256;  // two groups of 4 warps

// Tiles of the float32 kernels in the head-dim class kDh (64, 128 or
// 256; a smaller Dh runs in its class with zero columns): kNX resident
// rows (keys of bwd_dkdv_kernel, packed rows of bwd_dq_kernel), kNA
// streamed rows a step, rows of kDh + 4 floats (16-byte rows whose float4
// reads by 8 consecutive rows hit distinct banks), and P and dS stored
// [a][x] with rows of kNX + 4.  A thread's tiles: kSX x kSA of its
// group's S or dP (4 x 4 at Dh <= 128), kAX x kAD of its group's sum (8 x
// 8 at Dh 128).  bwd_dkdv_kernel's shared memory at Dh 128: 66 KB
// resident, 66 KB for the two stages, 17 KB of P and dS: one block an SM.
template <int kDh>
struct F32Tile {
  static constexpr int kNX = kDh > 128 ? 32 : 64;
  static constexpr int kNA = 32;
  static constexpr int kLd = kDh + 4;
  static constexpr int kLdP = kNX + 4;
  static constexpr int kSX = kNX / 16, kSA = kNA / 8;
  static constexpr int kAX = kNX / 8, kAD = kDh / 16;
  static constexpr size_t kDkdvSmem =
      sizeof(float) * (2 * kNX * kLd + 4 * kNA * kLd + 2 * kNA * kLdP + 4 * kNA);
  static constexpr size_t kDqSmem = sizeof(float) * 2 * kNA * (kLd + kLdP);
};

// The float32 kernels' arguments: the entry point's pointers and strides.
struct BwdF32Params {
  const float *q, *k, *v, *dout, *lse, *D;
  float *dq, *dk, *dv;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, d_sb, d_ss, d_sh;
  int64_t dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh;
  const int* kv_len;
  int Sq, Skv, G, Dh, causal, window;
  float scale;
  float* ds;      // dS^T (B, Hkv, Skv, ds_ld): row key, column packed row
  int64_t ds_ld;  // G Sq rounded up to 64
};

// acc[r][c] += sum over a in [a_lo, a_lo + n) of w[a][x_r] o[a][col_c], a
// thread's rows x = ai * kAX .. + kAX - 1 and columns aj * 4 + 64 u .. +
// 3, in order of a: the products that sum a step into the accumulators,
// kUnroll values of a at a time.
template <int kDh, int n, int kUnroll>
__device__ __forceinline__ void sum_rows(float (&acc)[F32Tile<kDh>::kAX][F32Tile<kDh>::kAD],
                                         const float* w, const float* o, int a_lo, int ai,
                                         int aj) {
  using T = F32Tile<kDh>;
  constexpr int kAX = T::kAX, kAD = T::kAD;
  for (int a0 = a_lo; a0 < a_lo + n; a0 += kUnroll) {
#pragma unroll
    for (int da = 0; da < kUnroll; ++da) {
      const int a = a0 + da;
      float wv[kAX];
#pragma unroll
      for (int q = 0; q < kAX / 4; ++q) {
        const float4 t = lds4(w + a * T::kLdP + ai * kAX + 4 * q);
        wv[4 * q] = t.x, wv[4 * q + 1] = t.y, wv[4 * q + 2] = t.z, wv[4 * q + 3] = t.w;
      }
      float4 ov[kAD / 4];
#pragma unroll
      for (int u = 0; u < kAD / 4; ++u) ov[u] = lds4(o + a * T::kLd + aj * 4 + 64 * u);
#pragma unroll
      for (int r = 0; r < kAX; ++r)
#pragma unroll
        for (int u = 0; u < kAD / 4; ++u) {
          acc[r][4 * u] = fmaf(wv[r], ov[u].x, acc[r][4 * u]);
          acc[r][4 * u + 1] = fmaf(wv[r], ov[u].y, acc[r][4 * u + 1]);
          acc[r][4 * u + 2] = fmaf(wv[r], ov[u].z, acc[r][4 * u + 2]);
          acc[r][4 * u + 3] = fmaf(wv[r], ov[u].w, acc[r][4 * u + 3]);
        }
    }
  }
}

// bwd_dkdv_kernel: one block of two groups of 4 warps per (kv head, row b,
// kNX keys), the earliest keys (the longest causal walks) first in the
// grid.  K and V of the block's keys stay in shared memory; the walk goes
// over packed (q position, q head) rows as the bf16 route packs them, so
// one walk covers the G q heads, from the first row the causal limit lets
// see the keys to the last the window does, kNA rows of Q and dO (with
// their lse and D) a step through a two-stage cp.async ring.  The groups
// split each step by product, so that a thread's tiles are as large as
// the registers allow: group 0 forms S^T = K Q^T, then P^T = exp(scale S^T
// - lse), 0 where masked, and sums dV += P^T dO; group 1 forms dP^T = V
// dO^T, then, once P^T is in shared memory, dS^T = P^T (dP^T - D), which
// it also stores to the dS^T scratch for bwd_dq_kernel, and sums dK +=
// dS^T Q.  dK and dV stay in registers for the whole walk.
template <int kDh>
__global__ void __launch_bounds__(kF32Threads, 1) bwd_dkdv_kernel(const BwdF32Params p) {
  using T = F32Tile<kDh>;
  constexpr int kNX = T::kNX, kNA = T::kNA, kLd = T::kLd, kLdP = T::kLdP;
  constexpr int kSX = T::kSX, kSA = T::kSA, kAX = T::kAX, kAD = T::kAD;
  constexpr int kChunks = kDh / 4;  // 16-byte chunks of a row
  extern __shared__ __align__(16) float smem_f32[];
  float* ks = smem_f32;             // [kNX][kLd]
  float* vs = ks + kNX * kLd;       // [kNX][kLd]
  float* qs = vs + kNX * kLd;       // [2][kNA][kLd]
  float* dos = qs + 2 * kNA * kLd;  // [2][kNA][kLd]
  float* ps = dos + 2 * kNA * kLd;  // [kNA][kLdP]
  float* dss = ps + kNA * kLdP;     // [kNA][kLdP]
  float* lse_s = dss + kNA * kLdP;  // [2][kNA]
  float* D_s = lse_s + 2 * kNA;     // [2][kNA]

  const int hkv = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * kNX;
  const int G = p.G, Sq = p.Sq, Skv = p.Skv, nch = p.Dh / 4;
  const int Hq = gridDim.x * G, off = Skv - Sq;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = warp >> 2, gw = warp & 3;  // the warp's group and its place in it
  const int n_keys = bwd_key_limit(p.kv_len, b, Skv);
  const int64_t stat = ((int64_t)b * Hq + hkv * G) * Sq;  // (b, hkv * G + h, i) at + h Sq + i
  const float* qb = p.q + b * p.q_sb + (int64_t)hkv * G * p.q_sh;
  const float* db = p.dout + b * p.d_sb + (int64_t)hkv * G * p.d_sh;
  float* dsb = p.ds + ((int64_t)b * gridDim.x + hkv) * Skv * p.ds_ld;

  // the packed rows whose positions can see a key of [k0, k0 + nk):
  // causal, off + i >= k0; windowed, off + i < k0 + nk - 1 + window
  const int nk = max(0, min(kNX, n_keys - k0));
  const int i_begin = p.causal ? max(0, k0 - off) : 0;
  const int i_end = nk == 0           ? 0
                    : p.window >= 0 ? max(0, min(Sq, k0 + nk - 1 + p.window - off))
                                    : Sq;
  const int a_begin = G * i_begin / kNA * kNA, a_end = G * i_end;
  const int n_steps = a_end > a_begin ? (a_end - a_begin + kNA - 1) / kNA : 0;

  // Rows [0, n) of two tiles: a thread copies chunk ch of rows r0, r0 +
  // kRowStep, ...; rows(r, ok, src_a, src_b) gives row r's validity and
  // sources (in bounds also when invalid: a copy that reads nothing still
  // takes an address), once for both tiles.  Chunks past nch and invalid
  // rows are zeros.
  constexpr int kRowStep = kF32Threads / kChunks;
  const int r0 = tid / kChunks, ch = tid % kChunks, cho = ch < nch ? 4 * ch : 0;
  auto copy_rows = [&](float* dst_a, float* dst_b, auto n, auto rows) {
#pragma unroll
    for (int u = 0; u < decltype(n)::value / kRowStep; ++u) {
      const int r = r0 + u * kRowStep;
      bool ok;
      const float *src_a, *src_b;
      rows(r, ok, src_a, src_b);
      cp_async16(dst_a + r * kLd + 4 * ch, src_a + cho, ok & (ch < nch));
      cp_async16(dst_b + r * kLd + 4 * ch, src_b + cho, ok & (ch < nch));
    }
  };
  const float* kb = p.k + b * p.k_sb + hkv * p.k_sh;
  const float* vb = p.v + b * p.v_sb + hkv * p.v_sh;
  if (n_steps > 0)  // K and V of the block's keys; keys past the limit are zeros
    copy_rows(ks, vs, std::integral_constant<int, kNX>{},
              [&](int r, bool& ok, const float*& kr, const float*& vr) {
                ok = k0 + r < n_keys;
                const int64_t key = ok ? k0 + r : 0;
                kr = kb + key * p.k_ss;
                vr = vb + key * p.v_ss;
              });
  // step `step`'s Q and dO rows and their lse and D into ring stage
  // `stage`; rows past Sq are zeros (their statistics left stale: masked)
  auto fetch = [&](int step, int stage) {
    const int a0 = a_begin + step * kNA;
    copy_rows(qs + stage * kNA * kLd, dos + stage * kNA * kLd,
              std::integral_constant<int, kNA>{},
              [&](int r, bool& ok, const float*& qr, const float*& dr) {
                const int i = (a0 + r) / G, h = a0 + r - i * G;
                ok = i < Sq;
                const int64_t ic = ok ? i : 0;
                qr = qb + ic * p.q_ss + h * p.q_sh;
                dr = db + ic * p.d_ss + h * p.d_sh;
              });
    if (tid < kNA) {
      const int i = (a0 + tid) / G, h = a0 + tid - i * G;
      if (i < Sq) {
        cp_async_ca<4>(lse_s + stage * kNA + tid, p.lse + stat + (int64_t)h * Sq + i);
        cp_async_ca<4>(D_s + stage * kNA + tid, p.D + stat + (int64_t)h * Sq + i);
      }
    }
  };
  if (n_steps > 0) fetch(0, 0);
  cp_async_commit();  // K, V and the first step: one group

  // S phase: keys si + 16 s, rows sj + 8 t (a warp 4 x 8 of them, so each
  // float4 read is one wavefront); sum phase: keys ai * kAX .. + kAX - 1,
  // columns aj * 4 + 64 u .. + 3
  const int si = gw * 4 + (lane >> 3), sj = lane & 7;
  const int ai = (gw >> 1) * 4 + (lane >> 3), aj = (gw & 1) * 8 + (lane & 7);
  const float* xg = grp == 0 ? ks : vs;          // the group's product: S^T or dP^T
  const float* ag = grp == 0 ? qs : dos;
  const float* wg = grp == 0 ? ps : dss;         // the group's sum: P^T dO or dS^T Q
  const float* og = grp == 0 ? dos : qs;
  const float* stg = grp == 0 ? lse_s : D_s;     // its rows' statistic: lse or D

  float acc[kAX][kAD];
#pragma unroll
  for (int r = 0; r < kAX; ++r)
#pragma unroll
    for (int c = 0; c < kAD; ++c) acc[r][c] = 0.f;

  for (int step = 0; step < n_steps; ++step) {
    const int stage = step & 1, a0 = a_begin + step * kNA;
    cp_async_wait<0>();  // this step's rows (and K, V) landed
    __syncthreads();     // ... for every thread; the last step is consumed
    if (step + 1 < n_steps) fetch(step + 1, stage ^ 1);
    cp_async_commit();
    const float* at = ag + stage * kNA * kLd;

    float sv[kSX][kSA];
#pragma unroll
    for (int i = 0; i < kSX; ++i)
#pragma unroll
      for (int j = 0; j < kSA; ++j) sv[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kDh; d += 4) {
      float4 xv[kSX], av[kSA];
#pragma unroll
      for (int i = 0; i < kSX; ++i) xv[i] = lds4(xg + (si + 16 * i) * kLd + d);
#pragma unroll
      for (int j = 0; j < kSA; ++j) av[j] = lds4(at + (sj + 8 * j) * kLd + d);
#pragma unroll
      for (int i = 0; i < kSX; ++i)
#pragma unroll
        for (int j = 0; j < kSA; ++j) sv[i][j] = fma4(xv[i], av[j], sv[i][j]);
    }

    // the keys [lo, hi] each of the thread's rows sees (none past Sq: hi
    // -1) and its statistic; the mask, without a branch
    int lo[kSA], hi[kSA];
    float st[kSA];
#pragma unroll
    for (int j = 0; j < kSA; ++j) {
      const int a = sj + 8 * j, i = (a0 + a) / G, qp = off + i;
      hi[j] = i >= Sq ? -1 : p.causal ? min(qp, n_keys - 1) : n_keys - 1;
      lo[j] = p.window >= 0 ? qp - p.window + 1 : 0;
      st[j] = stg[stage * kNA + a];
    }
    auto valid = [&](int i, int j) {
      const int key = k0 + si + 16 * i;
      return (key >= lo[j]) & (key <= hi[j]);
    };
    if (grp == 0) {  // P^T, 0 where masked
#pragma unroll
      for (int i = 0; i < kSX; ++i)
#pragma unroll
        for (int j = 0; j < kSA; ++j)
          ps[(sj + 8 * j) * kLdP + si + 16 * i] =
              select(valid(i, j), expf(sv[i][j] * p.scale - st[j]), 0.f);
    }
    __syncthreads();
    if (grp == 1) {  // dS^T = P^T (dP^T - D), 0 where masked, also to the scratch
#pragma unroll
      for (int i = 0; i < kSX; ++i)
#pragma unroll
        for (int j = 0; j < kSA; ++j) {
          const int at_p = (sj + 8 * j) * kLdP + si + 16 * i;
          const float ds = select(valid(i, j), ps[at_p] * (sv[i][j] - st[j]), 0.f);
          dss[at_p] = ds;
          const int key = k0 + si + 16 * i, pr = a0 + sj + 8 * j;
          if (key < Skv && pr < p.ds_ld) dsb[(int64_t)key * p.ds_ld + pr] = ds;
        }
    }
    __syncthreads();
    sum_rows<kDh, kNA, 8>(acc, wg, og + stage * kNA * kLd, 0, ai, aj);
  }
  cp_async_wait<0>();

  // dV (group 0) and dK = scale sum dS^T Q (group 1): keys past the limit
  // store 0, keys past Skv nothing.  float4 stores of the thread's
  // columns below Dh.
  const float mul = grp == 0 ? 1.f : p.scale;
#pragma unroll
  for (int r = 0; r < kAX; ++r) {
    const int key = k0 + ai * kAX + r;
    if (key >= Skv) continue;
    float* o = grp == 0 ? p.dv + b * p.dv_sb + key * p.dv_ss + hkv * p.dv_sh
                        : p.dk + b * p.dk_sb + key * p.dk_ss + hkv * p.dk_sh;
#pragma unroll
    for (int u = 0; u < kAD / 4; ++u) {
      const int col = aj * 4 + 64 * u;
      if (col < p.Dh)
        *reinterpret_cast<float4*>(o + col) =
            make_float4(acc[r][4 * u] * mul, acc[r][4 * u + 1] * mul, acc[r][4 * u + 2] * mul,
                        acc[r][4 * u + 3] * mul);
    }
  }
}

// bwd_dq_kernel: dQ = scale dS K from the dS^T that bwd_dkdv_kernel stored,
// a GEMM pass in place of recomputing S and dP (five products in all
// instead of seven).  One block of two groups per (kv head, row b, kNX
// packed rows), the last rows (the longest causal walks) first, walking
// the key tiles its rows can see; K and dS^T tiles of kNA keys come
// through a two-stage cp.async ring (keys past the limit as zeros).  In a
// tile that crosses the causal limit or the window, the entries the dK/dV
// walk did not visit are zeroed first.  Each group sums half of a tile's
// keys, and the halves meet at the end in a fixed order.
template <int kDh>
__global__ void __launch_bounds__(kF32Threads, kDh > 128 ? 1 : 2) bwd_dq_kernel(const BwdF32Params p) {
  using T = F32Tile<kDh>;
  constexpr int kNX = T::kNX, kNA = T::kNA, kLd = T::kLd, kLdP = T::kLdP;
  constexpr int kAX = T::kAX, kAD = T::kAD, kChunks = kDh / 4;
  extern __shared__ __align__(16) float smem_f32[];
  float* ks = smem_f32;             // [2][kNA][kLd]
  float* dss = ks + 2 * kNA * kLd;  // [2][kNA][kLdP]
  const int hkv = blockIdx.x, b = blockIdx.y;
  const int G = p.G, Sq = p.Sq, Skv = p.Skv, nch = p.Dh / 4, off = Skv - Sq;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = warp >> 2, gw = warp & 3;
  const int n_keys = bwd_key_limit(p.kv_len, b, Skv);
  const int x0 = (gridDim.z - 1 - blockIdx.z) * kNX;
  const int q_lo = off + x0 / G, q_hi = off + min(Sq - 1, (x0 + kNX - 1) / G);
  const int n_tiles = (n_keys + kNA - 1) / kNA;
  const int t_end = p.causal ? min(n_tiles, max(0, q_hi) / kNA + 1) : n_tiles;
  const int t_begin = p.window >= 0 ? max(0, q_lo - p.window + 1) / kNA : 0;
  const int n_steps = max(0, t_end - t_begin);
  const float* kb = p.k + b * p.k_sb + hkv * p.k_sh;
  const float* dsb = p.ds + ((int64_t)b * gridDim.x + hkv) * Skv * p.ds_ld + x0;

  auto fetch = [&](int t, int stage) {
    float* kd = ks + stage * kNA * kLd;
    float* dd = dss + stage * kNA * kLdP;
    // invalid rows and chunks read nothing, from an address in bounds
    constexpr int kRowStep = kF32Threads / kChunks;
    const int ch = tid % kChunks, cho = ch < nch ? 4 * ch : 0;
#pragma unroll
    for (int u = 0; u < kNA / kRowStep; ++u) {
      const int r = tid / kChunks + u * kRowStep, key = t * kNA + r;
      const bool ok = key < n_keys;
      cp_async16(kd + r * kLd + 4 * ch, kb + (ok ? (int64_t)key * p.k_ss : 0) + cho,
                 ok & (ch < nch));
    }
    constexpr int kXC = kNX / 4;  // 16-byte chunks of a dS^T row
#pragma unroll
    for (int u = 0; u < kNA * kXC / kF32Threads; ++u) {
      const int c = tid + u * kF32Threads, r = c / kXC, xc = c % kXC, key = t * kNA + r;
      const bool ok = key < n_keys;
      cp_async16(dd + r * kLdP + 4 * xc, dsb + (ok ? (int64_t)key * p.ds_ld : 0) + 4 * xc, ok);
    }
  };
  if (n_steps > 0) fetch(t_begin, 0);
  cp_async_commit();

  const int ai = (gw >> 1) * 4 + (lane >> 3), aj = (gw & 1) * 8 + (lane & 7);
  float acc[kAX][kAD];
#pragma unroll
  for (int r = 0; r < kAX; ++r)
#pragma unroll
    for (int c = 0; c < kAD; ++c) acc[r][c] = 0.f;
  for (int step = 0; step < n_steps; ++step) {
    const int stage = step & 1, k0 = (t_begin + step) * kNA;
    cp_async_wait<0>();  // this tile landed
    __syncthreads();     // ... for every thread; the last tile is consumed
    if (step + 1 < n_steps) fetch(t_begin + step + 1, stage ^ 1);
    cp_async_commit();
    float* dd = dss + stage * kNA * kLdP;
    if ((p.causal && k0 + kNA - 1 > q_lo) || (p.window >= 0 && k0 <= q_hi - p.window)) {
      for (int e = tid; e < kNA * kNX; e += kF32Threads) {
        const int a = e / kNX, x = e % kNX, qp = off + (x0 + x) / G, key = k0 + a;
        if ((p.causal & (key > qp)) | ((p.window >= 0) & (key <= qp - p.window)))
          dd[a * kLdP + x] = 0.f;
      }
      __syncthreads();
    }
    sum_rows<kDh, kNA / 2, 4>(acc, dd, ks + stage * kNA * kLd, grp * (kNA / 2), ai, aj);
  }
  cp_async_wait<0>();

  // dQ = scale (group 0's half + group 1's half), the halves meeting in
  // the ring in a fixed order; rows past Sq dropped, float4 columns below
  // Dh
  float* red = ks;  // [kNX][kDh]
  __syncthreads();  // the ring is free
  if (grp == 1) {
#pragma unroll
    for (int r = 0; r < kAX; ++r)
#pragma unroll
      for (int u = 0; u < kAD / 4; ++u)
        *reinterpret_cast<float4*>(red + (ai * kAX + r) * kDh + aj * 4 + 64 * u) =
            make_float4(acc[r][4 * u], acc[r][4 * u + 1], acc[r][4 * u + 2], acc[r][4 * u + 3]);
  }
  __syncthreads();
  if (grp == 1) return;
#pragma unroll
  for (int r = 0; r < kAX; ++r) {
    const int pr = x0 + ai * kAX + r, i = pr / G, h = pr - i * G;
    if (i >= Sq) continue;
    float* o = p.dq + b * p.dq_sb + i * p.dq_ss + (hkv * G + h) * p.dq_sh;
#pragma unroll
    for (int u = 0; u < kAD / 4; ++u) {
      const int col = aj * 4 + 64 * u;
      const float4 t = lds4(red + (ai * kAX + r) * kDh + col);
      if (col < p.Dh)
        *reinterpret_cast<float4*>(o + col) = make_float4(
            (acc[r][4 * u] + t.x) * p.scale, (acc[r][4 * u + 1] + t.y) * p.scale,
            (acc[r][4 * u + 2] + t.z) * p.scale, (acc[r][4 * u + 3] + t.w) * p.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 route: the tensor cores
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTcKeys = 32;   // keys per dK/dV block: 16 a warp pair
constexpr int kTcStep = 64;   // packed rows per step of the dK/dV walk: 32 a warp
constexpr int kTcAcc = 128;   // dK/dV columns one block accumulates
constexpr int kTcRows = 64;   // packed rows per dQ block, 16 a warp
constexpr int kTcBN = 32;     // keys per kv tile of the dQ walk

// dK/dV blocks per key tile: each accumulates at most kTcAcc columns.
template <int kDhMax>
__host__ __device__ constexpr int dkdv_parts() { return kDhMax > kTcAcc ? 2 : 1; }

// Shared memory of bwd_dkdv_tc_kernel: resident K and V, then a two-stage
// ring of Q and dO tiles (bf16, row stride Dh + 8) and of their rows' lse
// and D (float32); after the walk the ring's space passes the second row
// half's dK and dV to the first (2 warps x 2 x 16 x kAcc floats).
template <int kDhMax>
inline size_t dkdv_tc_smem_bytes(int dh) {
  const size_t ring = sizeof(bf16) * (size_t)(dh + 8) * 4 * kTcStep + sizeof(float) * 4 * kTcStep;
  const size_t red = sizeof(float) * 2 * 2 * 16 * (kDhMax / dkdv_parts<kDhMax>());
  return sizeof(bf16) * (size_t)(dh + 8) * 2 * kTcKeys + (ring > red ? ring : red);
}

// Shared memory of bwd_dq_tc_kernel: the Q and dO rows, then a two-stage
// ring of K and V tiles.
inline size_t dq_tc_smem_bytes(int dh) {
  return sizeof(bf16) * (size_t)(dh + 8) * (2 * kTcRows + 4 * kTcBN);
}

// Element offsets, in a shared tile of row stride ld, of the address lane
// `lane` hands ldmatrix (tensor_core.cuh's layouts): a 16 x 16 A block of a
// row-major tile (ldmatrix_x4); two 8-wide n-tiles of B from a tile stored
// [n][k] (ldmatrix_x4: registers 0-1 n-tile 0, 2-3 n-tile 1); the same
// from a tile stored [k][n] (ldmatrix_x4_trans).
__device__ __forceinline__ int frag_a(int lane, int ld) {
  return (lane & 15) * ld + (lane >> 4) * 8;
}
__device__ __forceinline__ int frag_b(int lane, int ld) {
  return ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int frag_bt(int lane, int ld) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
}

// 2^x in one MUFU instruction; results below 2^-126 flush to 0, which P
// and dS can take.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The A fragment of a 16 x 16 block from the two 16 x 8 accumulator tiles
// that hold it side by side, rounded to bf16 (the forward's P -> A trick).
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// kExact: Dh == kDhMax, so every loop bound over the head dim is a
// constant and the unrolled loops carry no guards, which otherwise keep
// the compiler from overlapping one slice's loads with the last one's
// products.
template <int kDhMax, bool kExact>
__global__ void __launch_bounds__(kThreads, kDhMax <= 128 ? 2 : 1) bwd_dkdv_tc_kernel(
    const bf16* __restrict__ q, int64_t q_sb, int64_t q_ss, int64_t q_sh,
    const bf16* __restrict__ k, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    const bf16* __restrict__ v, int64_t v_sb, int64_t v_ss, int64_t v_sh,
    const bf16* __restrict__ dout, int64_t d_sb, int64_t d_ss, int64_t d_sh,
    const float* __restrict__ lse, const float* __restrict__ D,
    bf16* __restrict__ dk, int64_t dk_sb, int64_t dk_ss, int64_t dk_sh,
    bf16* __restrict__ dv, int64_t dv_sb, int64_t dv_ss, int64_t dv_sh,
    int Sq, int Skv, const int* __restrict__ kv_len, int G, int Dh, int causal, int window,
    float scale) {
  constexpr int kParts = dkdv_parts<kDhMax>();
  constexpr int kAcc = kDhMax / kParts;            // columns accumulated
  constexpr int kWR = kTcStep / 2;                 // rows a warp takes a step
  constexpr int kPerRow = kThreads / kTcStep;      // threads copying one row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dh = kExact ? kDhMax : Dh;
  const int ld = dh + 8;
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);    // [kTcKeys][ld]
  bf16* vs = ks + kTcKeys * ld;                    // [kTcKeys][ld]
  bf16* qs = vs + kTcKeys * ld;                    // [2][kTcStep][ld]
  bf16* dos = qs + 2 * kTcStep * ld;               // [2][kTcStep][ld]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * kTcStep * ld);  // [2][kTcStep]
  float* D_s = lse_s + 2 * kTcStep;                                // [2][kTcStep]

  const int hkv = blockIdx.x, b = blockIdx.y;
  const int k0 = (blockIdx.z / kParts) * kTcKeys;
  const int c0 = (blockIdx.z % kParts) * kAcc;     // the block's first column
  const int n_acc = kExact ? kAcc / 16 : min(kAcc, Dh - c0) / 16;  // its 16-wide slices
  const int Hq = gridDim.x * G, off = Skv - Sq;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int kg = warp & 1, rh = warp >> 1;         // the warp's keys and row half
  const int chunks = dh / 8, n_kk = dh / 16;
  const int n_keys = bwd_key_limit(kv_len, b, Skv);
  const int nk = max(0, min(kTcKeys, n_keys - k0));  // the block's valid keys
  const float scale_log2 = scale * kLog2e;

  // K and V of the block's keys, resident; keys past the limit are zeros
  const bf16* kb = k + b * k_sb + hkv * k_sh;
  const bf16* vb = v + b * v_sb + hkv * v_sh;
  for (int c = tid; c < kTcKeys * chunks; c += kThreads) {
    const int r = c / chunks, d = (c - r * chunks) * 8;
    const bool ok = r < nk;
    const int64_t row = ok ? k0 + r : 0;
    cp_async16(ks + r * ld + d, kb + row * k_ss + d, ok);
    cp_async16(vs + r * ld + d, vb + row * v_ss + d, ok);
  }

  // the packed rows whose positions can see a key of [k0, k0 + nk):
  // causal, off + i >= k0; windowed, off + i < k0 + nk - 1 + window
  const int i_begin = causal ? max(0, k0 - off) : 0;
  const int i_end = nk == 0        ? 0
                    : window >= 0 ? max(0, min(Sq, k0 + nk - 1 + window - off))
                                  : Sq;
  const int p_begin = G * i_begin / kTcStep * kTcStep, p_end = G * i_end;
  const int n_steps = p_end > p_begin ? (p_end - p_begin + kTcStep - 1) / kTcStep : 0;

  // step `step`'s Q and dO rows and their lse and D into ring stage `stage`,
  // kPerRow threads a row; rows past Sq are zeros (their lse and D left
  // stale: masked)
  const int fr = tid / kPerRow, fc = tid % kPerRow;
  const bf16* qb = q + b * q_sb + hkv * G * q_sh;
  const bf16* db = dout + b * d_sb + hkv * G * d_sh;
  const int64_t stat = ((int64_t)b * Hq + hkv * G) * Sq;
  auto fetch = [&](int step, int stage) {
    const int p = p_begin + step * kTcStep + fr, i = p / G, h = p - i * G;
    const bool ok = i < Sq;
    bf16* qd = qs + (stage * kTcStep + fr) * ld;
    bf16* dd = dos + (stage * kTcStep + fr) * ld;
    const bf16* qsrc = ok ? qb + i * q_ss + h * q_sh : q;
    const bf16* dsrc = ok ? db + i * d_ss + h * d_sh : dout;
    for (int cc = fc; cc < chunks; cc += kPerRow) {
      cp_async16(qd + cc * 8, qsrc + (ok ? cc * 8 : 0), ok);
      cp_async16(dd + cc * 8, dsrc + (ok ? cc * 8 : 0), ok);
    }
    if (fc == 0 && ok) {
      cp_async_ca<4>(lse_s + stage * kTcStep + fr, lse + stat + (int64_t)h * Sq + i);
      cp_async_ca<4>(D_s + stage * kTcStep + fr, D + stat + (int64_t)h * Sq + i);
    }
  };
  if (n_steps > 0) fetch(0, 0);
  cp_async_commit();  // K, V and the first tile: one group

  const int kw = k0 + kg * 16;                    // the warp's first key
  const int kw_last = min(kw + 15, n_keys - 1);   // its last valid key
  float dk_acc[kAcc / 8][4], dv_acc[kAcc / 8][4];
#pragma unroll
  for (int j = 0; j < kAcc / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  const bf16* kf = ks + kg * 16 * ld + frag_a(lane, ld);
  const bf16* vf = vs + kg * 16 * ld + frag_a(lane, ld);
  const int ob = frag_b(lane, ld) + rh * kWR * ld;
  const int obt = frag_bt(lane, ld) + rh * kWR * ld + c0;

  for (int step = 0; step < n_steps; ++step) {
    const int stage = step & 1;
    cp_async_wait<0>();  // this tile (and K, V) landed
    __syncthreads();     // ... for every warp; the last tile is consumed
    if (step + 1 < n_steps) fetch(step + 1, stage ^ 1);
    cp_async_commit();
    const int pw = p_begin + step * kTcStep + rh * kWR;   // the warp's first row
    const int tq_lo = off + pw / G, tq_hi = off + min(Sq - 1, (pw + kWR - 1) / G);
    // rows that none of the warp's keys can see
    if (kw_last < kw || pw >= G * Sq || (causal && tq_hi < kw) ||
        (window >= 0 && kw_last <= tq_lo - window))
      continue;
    const bool masked = kw_last < kw + 15 || pw + kWR > G * Sq ||
                        (causal && kw + 15 > tq_lo) || (window >= 0 && kw <= tq_hi - window);
    const bf16* qt = qs + stage * kTcStep * ld;
    const bf16* dt = dos + stage * kTcStep * ld;
    const float* ls = lse_s + stage * kTcStep + rh * kWR;
    const float* Ds = D_s + stage * kTcStep + rh * kWR;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x kWR rows a warp
    float s[kWR / 8][4], dp[kWR / 8][4];
#pragma unroll
    for (int j = 0; j < kWR / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDhMax / 16; ++kk) {
      if (kk < n_kk) {
        uint32_t ak[4], av[4];
        ldmatrix_x4(ak, kf + kk * 16);
        ldmatrix_x4(av, vf + kk * 16);
#pragma unroll
        for (int j = 0; j < kWR / 16; ++j) {
          uint32_t bq[4], bd[4];
          ldmatrix_x4(bq, qt + j * 16 * ld + ob + kk * 16);
          ldmatrix_x4(bd, dt + j * 16 * ld + ob + kk * 16);
          mma_bf16(s[2 * j], ak, bq[0], bq[1]);
          mma_bf16(s[2 * j + 1], ak, bq[2], bq[3]);
          mma_bf16(dp[2 * j], av, bd[0], bd[1]);
          mma_bf16(dp[2 * j + 1], av, bd[2], bd[3]);
        }
      }
    }

    // P^T and dS^T / scale in place of S^T and dP^T; 0 where masked
#pragma unroll
    for (int j = 0; j < kWR / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t4 + (e & 1);
        float p = fast_exp2(s[j][e] * scale_log2 - ls[c] * kLog2e);
        float ds = p * (dp[j][e] - Ds[c]);
        if (masked) {
          const int i = (pw + c) / G, qp = off + i, kp = kw + g + 8 * (e >> 1);
          const bool ok = i < Sq && kp <= kw_last && (!causal || kp <= qp) &&
                          (window < 0 || kp > qp - window);
          p = select(ok, p, 0.f);
          ds = select(ok, ds, 0.f);
        }
        s[j][e] = p;
        dp[j][e] = ds;
      }
    }

    // dV += P^T dO and dK += dS^T Q, P^T and dS^T as A from registers
#pragma unroll
    for (int kk = 0; kk < kWR / 16; ++kk) {
      uint32_t ap[4], as[4];
      acc_to_a(ap, s[2 * kk], s[2 * kk + 1]);
      acc_to_a(as, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int jd = 0; jd < kAcc / 16; ++jd) {
        if (jd < n_acc) {
          uint32_t bd[4], bq[4];
          ldmatrix_x4_trans(bd, dt + kk * 16 * ld + obt + jd * 16);
          ldmatrix_x4_trans(bq, qt + kk * 16 * ld + obt + jd * 16);
          mma_bf16(dv_acc[2 * jd], ap, bd[0], bd[1]);
          mma_bf16(dv_acc[2 * jd + 1], ap, bd[2], bd[3]);
          mma_bf16(dk_acc[2 * jd], as, bq[0], bq[1]);
          mma_bf16(dk_acc[2 * jd + 1], as, bq[2], bq[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free

  // the warp pair's sum, in a fixed order: the second row half hands its
  // dK and dV to the first through the ring, fragment by fragment
  float* red = reinterpret_cast<float*>(qs) + kg * 2 * (kAcc / 8) * 4 * 32 + lane;
  if (rh == 1) {
#pragma unroll
    for (int j = 0; j < kAcc / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        red[(j * 4 + e) * 32] = dk_acc[j][e];
        red[((kAcc / 8 + j) * 4 + e) * 32] = dv_acc[j][e];
      }
  }
  __syncthreads();
  if (rh == 1) return;

  // dK = scale * sum dS^T Q and dV of the warp's keys; keys past the
  // limit store 0, keys past Skv nothing
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = kw + g + 8 * h;
    if (key >= Skv) continue;
    bf16* dkr = dk + b * dk_sb + key * dk_ss + hkv * dk_sh + c0 + 2 * t4;
    bf16* dvr = dv + b * dv_sb + key * dv_ss + hkv * dv_sh + c0 + 2 * t4;
#pragma unroll
    for (int j = 0; j < kAcc / 8; ++j) {
      if (j < 2 * n_acc) {
        const float* rk = red + (j * 4 + 2 * h) * 32;
        const float* rv = red + ((kAcc / 8 + j) * 4 + 2 * h) * 32;
        *reinterpret_cast<uint32_t*>(dkr + j * 8) =
            pack_bf16((dk_acc[j][2 * h] + rk[0]) * scale, (dk_acc[j][2 * h + 1] + rk[32]) * scale);
        *reinterpret_cast<uint32_t*>(dvr + j * 8) =
            pack_bf16(dv_acc[j][2 * h] + rv[0], dv_acc[j][2 * h + 1] + rv[32]);
      }
    }
  }
}

template <int kDhMax, bool kExact>
__global__ void __launch_bounds__(kThreads, kDhMax <= 128 ? 3 : 1) bwd_dq_tc_kernel(
    const bf16* __restrict__ q, int64_t q_sb, int64_t q_ss, int64_t q_sh,
    const bf16* __restrict__ k, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    const bf16* __restrict__ v, int64_t v_sb, int64_t v_ss, int64_t v_sh,
    const bf16* __restrict__ dout, int64_t d_sb, int64_t d_ss, int64_t d_sh,
    const bf16* __restrict__ out, int64_t o_sb, int64_t o_ss, int64_t o_sh,
    const float* __restrict__ lse, float* __restrict__ D,
    bf16* __restrict__ dq, int64_t dq_sb, int64_t dq_ss, int64_t dq_sh,
    int Sq, int Skv, const int* __restrict__ kv_len, int G, int Dh, int causal, int window,
    float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dh = kExact ? kDhMax : Dh;
  const int ld = dh + 8;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);    // [kTcRows][ld]
  bf16* dos = qs + kTcRows * ld;                   // [kTcRows][ld]
  bf16* ks = dos + kTcRows * ld;                   // [2][kTcBN][ld]
  bf16* vs = ks + 2 * kTcBN * ld;                  // [2][kTcBN][ld]
  // the last rows first: under the causal mask they see the most keys
  const int p0 = (gridDim.x - 1 - blockIdx.x) * kTcRows, hkv = blockIdx.y, b = blockIdx.z;
  const int Hq = gridDim.y * G, off = Skv - Sq;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int chunks = dh / 8, n_kk = dh / 16;
  const int n_keys = bwd_key_limit(kv_len, b, Skv);
  const float scale_log2 = scale * kLog2e;

  // the block's Q and dO rows; rows past Sq are zeros and never stored
  for (int c = tid; c < kTcRows * chunks; c += kThreads) {
    const int r = c / chunks, d = (c - r * chunks) * 8;
    const int i = (p0 + r) / G, h = hkv * G + p0 + r - i * G;
    const bool ok = i < Sq;
    cp_async16(qs + r * ld + d, ok ? q + b * q_sb + i * q_ss + h * q_sh + d : q, ok);
    cp_async16(dos + r * ld + d, ok ? dout + b * d_sb + i * d_ss + h * d_sh + d : dout, ok);
  }

  // the kv tiles the block's rows can see
  const int q_lo = off + p0 / G;
  const int q_hi = off + min(Sq - 1, (p0 + kTcRows - 1) / G);
  const int n_tiles = (n_keys + kTcBN - 1) / kTcBN;
  const int t_end = causal ? min(n_tiles, q_hi / kTcBN + 1) : n_tiles;
  const int t_begin = window >= 0 ? max(0, q_lo - window + 1) / kTcBN : 0;
  const bf16* kb = k + b * k_sb + hkv * k_sh;
  const bf16* vb = v + b * v_sb + hkv * v_sh;
  // kv tile t into ring stage `stage`, kPerRow threads a key; keys past
  // the limit are zeros
  constexpr int kPerRow = kThreads / kTcBN;
  const int fr = tid / kPerRow, fc = tid % kPerRow;
  auto fetch = [&](int t, int stage) {
    const int key = t * kTcBN + fr;
    const bool ok = key < n_keys;
    const int64_t row = ok ? key : 0;
    bf16* kd = ks + (stage * kTcBN + fr) * ld;
    bf16* vd = vs + (stage * kTcBN + fr) * ld;
    for (int cc = fc; cc < chunks; cc += kPerRow) {
      cp_async16(kd + cc * 8, kb + row * k_ss + (ok ? cc * 8 : 0), ok);
      cp_async16(vd + cc * 8, vb + row * v_ss + (ok ? cc * 8 : 0), ok);
    }
  };
  if (t_begin < t_end) fetch(t_begin, 0);
  cp_async_commit();  // Q, dO and the first kv tile: one group

  // this thread's rows g and g + 8 of the warp's 16: q position, lse in
  // log2 units and D = rowsum(dout * out), which the quad's four lanes sum
  // over every fourth 16-byte chunk and the dK/dV kernel reads after this
  // one; a row past Sq gets lse = inf, so P = 0
  const int wr = p0 + warp * 16;
  int qpos[2];
  float lse2[2], Dr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = wr + g + 8 * h, i = p / G, hq = hkv * G + p - i * G;
    qpos[h] = off + i;
    const int64_t at = ((int64_t)b * Hq + hq) * Sq + i;
    lse2[h] = i < Sq ? lse[at] * kLog2e : INFINITY;
    float sum = 0.f;
    if (i < Sq) {
      const bf16* orow = out + b * o_sb + i * o_ss + hq * o_sh;
      const bf16* drow = dout + b * d_sb + i * d_ss + hq * d_sh;
      for (int cc = t4; cc < chunks; cc += 4) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + cc * 8);
        const uint4 dv = *reinterpret_cast<const uint4*>(drow + cc * 8);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 a = __bfloat1622float2(o2[u]), c = __bfloat1622float2(d2[u]);
          sum = fmaf(a.x, c.x, fmaf(a.y, c.y, sum));
        }
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    Dr[h] = sum;
    if (t4 == 0 && i < Sq) D[at] = sum;
  }
  const int wq_lo = off + wr / G, wq_hi = off + (wr + 15) / G;
  float dq_acc[kDhMax / 8][4];
#pragma unroll
  for (int j = 0; j < kDhMax / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[j][e] = 0.f;
  const bf16* qf = qs + warp * 16 * ld + frag_a(lane, ld);
  const bf16* df = dos + warp * 16 * ld + frag_a(lane, ld);
  const int ob = frag_b(lane, ld), obt = frag_bt(lane, ld);

  for (int t = t_begin; t < t_end; ++t) {
    const int stage = (t - t_begin) & 1;
    cp_async_wait<0>();  // this tile (and Q, dO) landed
    __syncthreads();     // ... for every warp; the last tile is consumed
    if (t + 1 < t_end) fetch(t + 1, stage ^ 1);
    cp_async_commit();
    const bf16* kt = ks + stage * kTcBN * ld;
    const bf16* vt = vs + stage * kTcBN * ld;

    // S = Q K^T and dP = dO V^T: 16 rows x kTcBN keys a warp
    float s[kTcBN / 8][4], dp[kTcBN / 8][4];
#pragma unroll
    for (int j = 0; j < kTcBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDhMax / 16; ++kk) {
      if (kk < n_kk) {
        uint32_t aq[4], ad[4];
        ldmatrix_x4(aq, qf + kk * 16);
        ldmatrix_x4(ad, df + kk * 16);
#pragma unroll
        for (int j = 0; j < kTcBN / 16; ++j) {
          uint32_t bk[4], bv[4];
          ldmatrix_x4(bk, kt + j * 16 * ld + ob + kk * 16);
          ldmatrix_x4(bv, vt + j * 16 * ld + ob + kk * 16);
          mma_bf16(s[2 * j], aq, bk[0], bk[1]);
          mma_bf16(s[2 * j + 1], aq, bk[2], bk[3]);
          mma_bf16(dp[2 * j], ad, bv[0], bv[1]);
          mma_bf16(dp[2 * j + 1], ad, bv[2], bv[3]);
        }
      }
    }

    // dS / scale = P (dP - D) in place of S; 0 where masked
    const int k0 = t * kTcBN;
    const bool masked = k0 + kTcBN > n_keys || (causal && k0 + kTcBN - 1 > wq_lo) ||
                        (window >= 0 && k0 <= wq_hi - window);
#pragma unroll
    for (int j = 0; j < kTcBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float ds = fast_exp2(s[j][e] * scale_log2 - lse2[h]) * (dp[j][e] - Dr[h]);
        if (masked) {
          const int kp = k0 + j * 8 + 2 * t4 + (e & 1);
          ds = select(kp < n_keys && (!causal || kp <= qpos[h]) &&
                          (window < 0 || kp > qpos[h] - window),
                      ds, 0.f);
        }
        s[j][e] = ds;
      }
    }

    // dQ += dS K, dS as A from registers
#pragma unroll
    for (int kk = 0; kk < kTcBN / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int jd = 0; jd < kDhMax / 16; ++jd) {
        if (jd < n_kk) {
          uint32_t bk[4];
          ldmatrix_x4_trans(bk, kt + kk * 16 * ld + obt + jd * 16);
          mma_bf16(dq_acc[2 * jd], a, bk[0], bk[1]);
          mma_bf16(dq_acc[2 * jd + 1], a, bk[2], bk[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // dQ = scale * sum dS K, rows past Sq dropped
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = wr + g + 8 * h, i = p / G;
    if (i >= Sq) continue;
    bf16* dqr = dq + b * dq_sb + i * dq_ss + (hkv * G + p - i * G) * dq_sh + 2 * t4;
#pragma unroll
    for (int j = 0; j < kDhMax / 8; ++j) {
      if (j < 2 * n_kk)
        *reinterpret_cast<uint32_t*>(dqr + j * 8) =
            pack_bf16(dq_acc[j][2 * h] * scale, dq_acc[j][2 * h + 1] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------
// The pointers and (b, s, h) strides of one call, as the entry point takes
// them.
struct BwdArgs {
  const void *q, *k, *v, *out, *dout;
  const int64_t *qs, *ks, *vs, *os, *ds;
  const float* lse;
  float* D;
  void *dq, *dk, *dv;
  const int64_t *dqs, *dks, *dvs;
  int B, Hq, Hkv, Sq, Skv;
  const int* kv_len;
  int Dh, causal, window;
  float* ds_scratch;
};

// The dK/dV kernel (which stores dS^T), then the dQ pass, in the head
// dim's class.
template <int kDh>
cudaError_t launch_bwd_f32_as(const BwdArgs& a, const BwdF32Params& p, cudaStream_t stream) {
  using T = F32Tile<kDh>;
  bwd_dkdv_kernel<kDh><<<dim3(a.Hkv, a.B, (a.Skv + T::kNX - 1) / T::kNX), kF32Threads,
                         T::kDkdvSmem, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dq_kernel<kDh><<<dim3(a.Hkv, a.B, (p.G * a.Sq + T::kNX - 1) / T::kNX), kF32Threads,
                       T::kDqSmem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_bwd_f32(const BwdArgs& a, float scale, cudaStream_t stream) {
  const int G = a.Hq / a.Hkv;
  bwd_dot_kernel<<<dim3((a.Sq + 3) / 4, a.Hq, a.B), kThreads, 0, stream>>>(
      static_cast<const float*>(a.out), a.os[0], a.os[1], a.os[2],
      static_cast<const float*>(a.dout), a.ds[0], a.ds[1], a.ds[2], a.D, a.Sq, a.Dh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const BwdF32Params p{static_cast<const float*>(a.q), static_cast<const float*>(a.k),
                       static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
                       a.lse, a.D, static_cast<float*>(a.dq), static_cast<float*>(a.dk),
                       static_cast<float*>(a.dv),
                       a.qs[0], a.qs[1], a.qs[2], a.ks[0], a.ks[1], a.ks[2],
                       a.vs[0], a.vs[1], a.vs[2], a.ds[0], a.ds[1], a.ds[2],
                       a.dqs[0], a.dqs[1], a.dqs[2], a.dks[0], a.dks[1], a.dks[2],
                       a.dvs[0], a.dvs[1], a.dvs[2],
                       a.kv_len, a.Sq, a.Skv, G, a.Dh, a.causal, a.window, scale,
                       a.ds_scratch, (G * a.Sq + 63) / 64 * 64};
  return a.Dh <= 64    ? launch_bwd_f32_as<64>(a, p, stream)
         : a.Dh <= 128 ? launch_bwd_f32_as<128>(a, p, stream)
                       : launch_bwd_f32_as<256>(a, p, stream);
}

template <int kDhMax, bool kExact>
cudaError_t launch_bwd_tc_as(const BwdArgs& a, float scale, cudaStream_t stream) {
  const int G = a.Hq / a.Hkv;
  const bf16* qp = static_cast<const bf16*>(a.q);
  const bf16* kp = static_cast<const bf16*>(a.k);
  const bf16* vp = static_cast<const bf16*>(a.v);
  const bf16* dp = static_cast<const bf16*>(a.dout);
  bwd_dq_tc_kernel<kDhMax, kExact><<<dim3((G * a.Sq + kTcRows - 1) / kTcRows, a.Hkv, a.B),
                                     kThreads, dq_tc_smem_bytes(a.Dh), stream>>>(
      qp, a.qs[0], a.qs[1], a.qs[2], kp, a.ks[0], a.ks[1], a.ks[2], vp, a.vs[0], a.vs[1],
      a.vs[2], dp, a.ds[0], a.ds[1], a.ds[2], static_cast<const bf16*>(a.out), a.os[0],
      a.os[1], a.os[2], a.lse, a.D, static_cast<bf16*>(a.dq), a.dqs[0], a.dqs[1], a.dqs[2],
      a.Sq, a.Skv, a.kv_len, G, a.Dh, a.causal, a.window, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_tiles = (a.Skv + kTcKeys - 1) / kTcKeys;
  bwd_dkdv_tc_kernel<kDhMax, kExact><<<dim3(a.Hkv, a.B, n_tiles * dkdv_parts<kDhMax>()),
                                       kThreads, dkdv_tc_smem_bytes<kDhMax>(a.Dh), stream>>>(
      qp, a.qs[0], a.qs[1], a.qs[2], kp, a.ks[0], a.ks[1], a.ks[2], vp, a.vs[0], a.vs[1],
      a.vs[2], dp, a.ds[0], a.ds[1], a.ds[2], a.lse, a.D, static_cast<bf16*>(a.dk), a.dks[0],
      a.dks[1], a.dks[2], static_cast<bf16*>(a.dv), a.dvs[0], a.dvs[1], a.dvs[2], a.Sq, a.Skv,
      a.kv_len, G, a.Dh, a.causal, a.window, scale);
  return cudaGetLastError();
}

// The head dim's class, exact where Dh is the class's largest.
template <int kDhMax>
cudaError_t launch_bwd_tc(const BwdArgs& a, float scale, cudaStream_t stream) {
  return a.Dh == kDhMax ? launch_bwd_tc_as<kDhMax, true>(a, scale, stream)
                        : launch_bwd_tc_as<kDhMax, false>(a, scale, stream);
}

}  // namespace rt

// Once per process, when the library is bound (prepare_kernels).
extern "C" int rt_prepare_flash_bwd() {
  using namespace rt;
  return prepare_kernels({(const void*)bwd_dkdv_kernel<64>, (const void*)bwd_dkdv_kernel<128>,
                          (const void*)bwd_dkdv_kernel<256>, (const void*)bwd_dq_kernel<64>,
                          (const void*)bwd_dq_kernel<128>, (const void*)bwd_dq_kernel<256>,
                          (const void*)bwd_dkdv_tc_kernel<64, true>,
                          (const void*)bwd_dkdv_tc_kernel<64, false>,
                          (const void*)bwd_dkdv_tc_kernel<128, true>,
                          (const void*)bwd_dkdv_tc_kernel<128, false>,
                          (const void*)bwd_dkdv_tc_kernel<256, true>,
                          (const void*)bwd_dkdv_tc_kernel<256, false>,
                          (const void*)bwd_dq_tc_kernel<64, true>,
                          (const void*)bwd_dq_tc_kernel<64, false>,
                          (const void*)bwd_dq_tc_kernel<128, true>,
                          (const void*)bwd_dq_tc_kernel<128, false>,
                          (const void*)bwd_dq_tc_kernel<256, true>,
                          (const void*)bwd_dq_tc_kernel<256, false>,
                          (const void*)bwd_dot_kernel});
}

// Plain C entry point bound with ctypes.  q, out, dout, dq: (B, Sq, Hq, Dh);
// k, v, dk, dv: (B, Skv, Hkv, Dh), each given by its (b, s, h) strides in
// elements with a contiguous last dim, every row on 16 bytes (dq, dk, dv
// contiguous); lse and D (scratch): float32 (B, Hq, Sq) contiguous;
// kv_len (B,) int32 or null; window < 0 = none.  Dh a multiple of 4 up to
// 256 in float32, of 16 up to 256 in bf16 (the wrapper checks).  Returns
// cudaGetLastError() of its launches.
extern "C" int rt_flash_attention_bwd(
    const void* q, int64_t q_sb, int64_t q_ss, int64_t q_sh,
    const void* k, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    const void* v, int64_t v_sb, int64_t v_ss, int64_t v_sh,
    const void* out, int64_t o_sb, int64_t o_ss, int64_t o_sh,
    const void* dout, int64_t d_sb, int64_t d_ss, int64_t d_sh,
    const void* lse, void* D, void* ds_scratch,
    void* dq, int64_t dq_sb, int64_t dq_ss, int64_t dq_sh,
    void* dk, int64_t dk_sb, int64_t dk_ss, int64_t dk_sh,
    void* dv, int64_t dv_sb, int64_t dv_ss, int64_t dv_sh,
    int B, int Hq, int Hkv, int Sq, int Skv, const void* kv_len, int Dh, int causal,
    int window, int dtype, void* stream) {
  using namespace rt;
  const bool tc = dtype == BF16;
  if ((dtype != F32 && !tc) || Dh % (tc ? 16 : 4) || Dh > 256 || Hq % Hkv)
    return cudaErrorInvalidValue;
  const int64_t qs[3] = {q_sb, q_ss, q_sh}, ks[3] = {k_sb, k_ss, k_sh},
                vs[3] = {v_sb, v_ss, v_sh}, os[3] = {o_sb, o_ss, o_sh},
                ds[3] = {d_sb, d_ss, d_sh}, dqs[3] = {dq_sb, dq_ss, dq_sh},
                dks[3] = {dk_sb, dk_ss, dk_sh}, dvs[3] = {dv_sb, dv_ss, dv_sh};
  const BwdArgs a{q, k, v, out, dout, qs, ks, vs, os, ds,
                  static_cast<const float*>(lse), static_cast<float*>(D), dq, dk, dv,
                  dqs, dks, dvs, B, Hq, Hkv, Sq, Skv, static_cast<const int*>(kv_len), Dh,
                  causal, window, static_cast<float*>(ds_scratch)};
  const float scale = rsqrtf(static_cast<float>(Dh));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!tc) return ds_scratch != nullptr ? launch_bwd_f32(a, scale, s) : cudaErrorInvalidValue;
  return Dh <= 64 ? launch_bwd_tc<64>(a, scale, s)
         : Dh <= 128 ? launch_bwd_tc<128>(a, scale, s)
                     : launch_bwd_tc<256>(a, scale, s);
}
