// Prefill flash attention and paged extend attention for Hopper (sm_90a).
//
// rt_flash_attention replaces the TPU kernel src/repro/kernels/
// flash_attention/flash_attention.py::_flash_kernel (wrapper
// flash_attention_bhsd): tiled causal or bidirectional attention with GQA
// (q head h reads kv head h / G), q positions offset by Skv - Sq, an
// optional sliding window, an optional key-length mask (row b sees keys
// below kv_len[b]: an encoder's padded source frames, and cross-attention
// to them, where Skv may be above or below Sq), and the online softmax in
// float32.  The route is by dtype alone:
//
// * bf16: flash_tc_kernel (the body flash_tc_body over a dense key
//   source, DenseKeys<bf16>), on the tensor cores.
//   Bound on the H100: at the serving buckets (S 128) the call is bound by
//   latency and by the Q, K, V and output bytes (B8 S128 Hq32 Hkv8 Dh128:
//   21 MB, 0.006 ms at 3.35 TB/s, and 1.1 GFLOP of products, 0.001 ms at
//   the bf16 peak); at long buckets by the QK^T and PV products, 4 * B *
//   Hq * Sq * Skv * Dh flops (about half under the causal mask).
//   Design (FlashAttention-2's inner loop, written with mma.sync): a block
//   of 4 warps owns 64 packed rows, row p = (q position p / G, q head
//   p % G of kv head blockIdx.y), so one K/V tile in shared memory serves
//   all G q heads of its kv group and the grid has Hkv, not Hq, heads.
//   Each warp holds 16 rows.  K/V tiles of 32 keys stay bf16 in shared
//   memory, padded so that ldmatrix reads have no bank conflicts, and
//   stream through a two-stage cp.async ring: the next tile's copy is in
//   flight while this tile is multiplied.  Up to Dh 128 a block takes at
//   most 128 registers a thread and 52 KB of shared memory, so four fit on
//   an SM and the serving grids (512 blocks at S 128) run as one wave;
//   64-key tiles, 8-warp blocks and deeper rings were slower there.  S = Q K^T runs
//   as m16n8k16 bf16 MMAs from ldmatrix fragments (Q re-read from shared
//   memory per tile, which keeps registers for the float32 output);
//   scores, running max and running sum stay in registers, the row max and
//   sum are reduced across the quad of lanes that holds a row by shuffles,
//   and P is rounded to bf16 in registers and used directly as the A
//   operand of the PV MMA (V through ldmatrix.trans).  The block walks only
//   the kv tiles its rows can see: it stops at the causal limit of its
//   newest row and starts at the window of its oldest; masks are applied
//   only in tiles that cross a limit or the ragged end.  A row with no
//   valid key finishes as 0 / max(l, 1e-30) = 0.  Any Dh % 16 == 0 up to
//   256 is taken (three instantiations: Dh <= 64, <= 128, <= 256); the
//   wrapper raises on any other bf16 head dim.
//
// * float32: flash_kernel (the body flash_f32_body over the same dense
//   key source, DenseKeys<float>), on CUDA cores, so that the products
//   stay exact float32: every product is an fmaf, each output element is
//   summed over the keys in one fixed order, with no atomics (the card's
//   greedy tokens and train steps are held to the CPU's in float32, and
//   TF32 tensor-core products would break that; two calls give the same
//   bits).
//   Bound on the H100 by its operations: at qwen3-4b's training shape
//   (B4 S512 Hq32 Hkv8 Dh128, causal, with the LSE) 8.61 GFLOP, 0.1285 ms
//   at the 67 TFLOP/s of float32 FMAs, against 0.0251 ms for its 84 MB.
//   Design (the bf16 route's shape on CUDA cores): a block of 4 warps owns
//   64 packed rows (32 past Dh 128) of one kv head, so one K/V tile in
//   shared memory serves its G q heads; the grid is (Hkv, B, row tiles),
//   the last rows (the longest causal walks) first.  K/V tiles of 32 keys
//   stream through a two-stage ring of 16-byte cp.async copies.  Each
//   thread holds a 4 x 4 tile of S (4 rows x 4 keys) and a 4 x 16 tile of
//   the output at Dh 128 in registers, every operand a float4 read from
//   rows padded to Dh + 4 floats (a warp's reads of 4 or 8 consecutive
//   rows fall on distinct banks), so each float4 pair feeds 16 or 32
//   fmafs.  The running max is reduced across the 8 lanes of a row by
//   shuffles, each lane keeps its part of the running sum to the end, and
//   P crosses the warp's lanes through the warp's own shared buffer (a
//   warp barrier, not a block one): one block barrier a kv tile.  Masks
//   apply only in tiles that cross a limit.  Any Dh % 4 == 0 up to 256
//   runs in three classes (64, 128, 256), a smaller Dh with zero columns;
//   at Dh 128 a block takes 110 KB of shared memory, so two share an SM.
//
// Both routes also write, when given a float32 (B, Hq, Sq) pointer, each
// row's log-sum-exp of its scaled scores (the running max plus the log of
// the running sum, in natural-log units), which the backward in
// flash_attention_bwd.cu reads to recompute P; a null pointer (every
// serving launch) skips the store.
//
// Any Sq is accepted: the ragged last q tile and kv tile are masked inside
// the block (the TPU wrapper required Sq % block_q == 0).  Under a key-length
// mask both routes end the row's key walk at min(Skv, kv_len[b]), so tiles
// past it are never read and the ragged end is the mask; a row with
// kv_len 0 stores 0 (the JAX plain version's finite -1e30 gives such a row
// the mean of V instead: callers must not read it).
//
// rt_paged_extend_attention replaces flash_attention.py::
// _paged_extend_kernel (wrapper paged_extend_attention_bhsd): the Sq suffix
// queries of row b sit at absolute positions pos[b] + i and attend to the
// row's block-table pages of a (N, P, L, Hkv, Dh) arena.  A slot counts iff
// 0 <= slot_pos <= q_pos; sentinel pages (id < 0 or >= N) are never read;
// the key walk stops after the newest query position; int8 arenas
// dequantise per (page, layer).  Bound on the H100: the bytes of Q, the
// K/V pages and the output (B8 S64 behind a 64-token prefix, Hq 32, Hkv 8,
// Dh 128: 12.6 MB, 0.0038 ms at 3.35 TB/s; the products, 0.6 GFLOP, take
// under 0.001 ms at the bf16 peak), and latency.  The route is by dtype,
// as for prefill:
//
// * bf16 q with a bf16 arena: paged_extend_tc_kernel<., bf16>, which is
//   flash_tc_kernel's body (flash_tc_body) over a paged key source
//   (PagedKeys): the same packed (q position, q head) rows, so one page
//   read serves all G q heads of its kv group, the same bf16 tiles of 32
//   keys through the two-stage cp.async ring and mma.sync products.  Key
//   k of a tile is slot k % P of page bt[k / P] (the row's block table in
//   shared memory), which takes any page size: 16 on the pool, down to 1
//   for a dense cache of odd length seen as an arena.  The tile's slot
//   positions land in shared memory beside K and V (4-byte cp.async), and
//   the mask 0 <= slot_pos <= q_pos applies in every tile; rows of
//   unmapped pages are zero-filled and masked.
// * bf16 q with an int8 arena: paged_extend_tc_kernel<., int8_t>, the
//   same body and rows over PagedKeys<int8_t>.  The codes stream through
//   a two-stage cp.async ring of their own (16 codes a copy, half the
//   bytes of a bf16 tile), with each key's k and v scale (4-byte cp.async:
//   a 32-key tile spans 32 / P pages, so the scales are per key) beside
//   the slot positions.  Once a stage has landed, its codes are turned
//   into bf16 (exact: |code| <= 127) in one bf16 K/V tile, and after a
//   barrier the unchanged ldmatrix / mma.sync products read it.  The
//   scales apply in float32, as JAX dequantises: each score column is
//   multiplied by its key's k scale, and P V takes p * v_scale of its key
//   column as the bf16 A operand (the row sum keeps the unscaled p).  One
//   bf16 tile in place of a second bf16 stage keeps the block at the bf16
//   route's 52 KB at Dh 128, so four blocks still fit on an SM.
// * float32 q (exact products, for the card-vs-CPU parity), over a
//   float32 or an int8 arena: paged_extend_kernel<., float / int8_t>,
//   flash_kernel's body (flash_f32_body) over a paged key source
//   (PagedF32Keys, on the bf16 route's page walk, PagedWalk): the same
//   packed rows, 32-key tiles of any page size and slot-position mask.
//   Arena rows on 16 bytes stream through the cp.async ring; any other
//   view (the wrapper cannot copy an arena cheaply) is read element by
//   element into the same tiles.  An int8 arena's codes land in a ring of their own with each
//   key's k and v scale, and each landed stage is written as code * scale
//   (JAX's dequantised values, exactly) into one float K/V tile.  Dh % 4
//   == 0 up to 256.
//
// Both tensor-core routes take Dh % 16 == 0 up to 256 and arena rows that
// start on 16 bytes (the wrapper raises otherwise).
#include <type_traits>

#include "tensor_core.cuh"
#include "tile_attention.cuh"

namespace rt {

// Keys [0, key_limit) of row b take part: all Skv, or with a key-length
// mask (kv_len != nullptr) the first min(Skv, kv_len[b]).  The walk stops
// there, so tiles wholly past the limit are never read.
__device__ __forceinline__ int key_limit(const int* kv_len, int b, int Skv) {
  return kv_len != nullptr ? max(0, min(Skv, kv_len[b])) : Skv;
}

using bf16 = __nv_bfloat16;

constexpr int kBN = 32;        // keys per kv tile, both routes
constexpr int kStages = 2;     // kv tiles in the cp.async ring, both routes
constexpr int kTcRows = 64;    // packed (q position, q head) rows per bf16 block, 16 a warp

// The Q rows and n_tiles K and V tiles, bf16 with a row stride of Dh + 8.
__host__ __device__ inline size_t tc_tile_bytes(int dh, int n_tiles) {
  return sizeof(bf16) * (size_t)(dh + 8) * (kTcRows + 2 * n_tiles * kBN);
}

// Shared memory of flash_tc_kernel: the Q rows and a two-stage ring of K
// and V tiles.
__host__ __device__ inline size_t flash_tc_smem_bytes(int dh) {
  return tc_tile_bytes(dh, kStages);
}

// Eight int8 codes as eight bf16 (the lower code in each word's low
// half), exactly: code c, biased to c + 128 in the low byte of the float
// 2^23 + (c + 128), less 2^23 + 128, is c as a float; with at most 8
// significant bits its low 16 bits are 0, so its high half is c in bf16.
__device__ __forceinline__ uint4 bf16x8_of_int8x8(uint2 w) {
  uint32_t r[4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t u = (h ? w.y : w.x) ^ 0x80808080u;
    float f[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) - 8388736.f;
    r[2 * h] = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
    r[2 * h + 1] = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
  }
  return make_uint4(r[0], r[1], r[2], r[3]);
}

// Key source of both bodies for prefill: key k of (b, hkv) is the row at
// kb + k k_ss, on 16 bytes; causal and window masks by key index, applied
// only in tiles that cross a limit or the ragged end.
template <typename T>
struct DenseKeys {
  static constexpr bool kInt8 = false;
  const T* kb;
  const T* vb;
  int64_t k_ss, v_ss;
  int Skv, causal, window;

  __device__ int t_begin(int q_lo) const {
    return window >= 0 ? max(0, q_lo - window + 1) / kBN : 0;
  }
  __device__ int t_end(int q_hi) const {
    const int n_tiles = (Skv + kBN - 1) / kBN;
    return causal ? min(n_tiles, q_hi / kBN + 1) : n_tiles;
  }
  // tile t into kd / vd, row stride ld, `chunks` 16-byte copies a row
  __device__ void load(int t, int, T* kd, T* vd, int ld, int chunks) const {
    const int k0 = t * kBN;
    for (int c = threadIdx.x; c < kBN * chunks; c += kThreads) {
      const int r = c / chunks, d = (c - r * chunks) * (16 / (int)sizeof(T));
      const bool ok = k0 + r < Skv;  // keys past Skv are zeros: 0 * V stays 0
      const int64_t row = ok ? k0 + r : 0;
      cp_async16(kd + r * ld + d, kb + row * k_ss + d, ok);
      cp_async16(vd + r * ld + d, vb + row * v_ss + d, ok);
    }
  }
  // does tile k0 need the per-element mask for rows at [wq_lo, wq_hi]?
  __device__ bool masked(int k0, int wq_lo, int wq_hi) const {
    return k0 + kBN > Skv || (causal && k0 + kBN - 1 > wq_lo) ||
           (window >= 0 && k0 <= wq_hi - window);
  }
  __device__ bool ok(int k0, int c, int, int qp) const {
    const int kp = k0 + c;
    return kp < Skv && (!causal || kp <= qp) && (window < 0 || kp > qp - window);
  }
};

// What the paged key sources of both bodies share: logical key k of row b
// is slot k % P of page bt[k / P] of a (N, P, L, Hkv, Dh) arena, any P.
// The block table row sits in shared memory; each tile's slot positions
// land in sps (4-byte cp.async), and a key counts iff 0 <= slot_pos <=
// q_pos.  Keys of unmapped pages (id < 0 or >= N) or past n_log are never
// read: their K/V rows are zero-filled and their slot_pos is -1.  Over
// int8 codes each key's k and v scale of its (page, layer) lands in scs
// ([kStages][k, v][kBN], 0 for unmapped pages): a tile spans kBN / P
// pages, so the scales are per key.
struct PagedWalk {
  const int* sp;           // slot_pos + layer * sp_sl
  int64_t sp_sn, sp_sp;
  const int* bts;          // the row's block table, shared memory [n_log]
  int* sps;                // slot positions, shared memory [kStages][kBN]
  int n_log, N, P;
  // int8 only
  const float* ksc;        // k_scale + layer * sc_sl
  const float* vsc;        // v_scale + layer * sc_sl
  int64_t sc_sn;
  float* scs;              // the keys' scales, shared memory

  __device__ int t_begin(int) const { return 0; }
  // the walk stops after the tile holding the newest row's position, as
  // logical page j holds positions [j * P, (j + 1) * P)
  __device__ int t_end(int q_hi) const {
    return min((n_log * P + kBN - 1) / kBN, q_hi / kBN + 1);
  }
  __device__ int page_of(int key, int& slot) const {
    const int j = key / P;
    slot = key - j * P;
    const int page = j < n_log ? bts[j] : -1;
    return page >= 0 && page < N ? page : -1;
  }
  // tile t's slot positions and, over int8 codes, its keys' scales into
  // stage `stage`: threads 0 .. kBN - 1 the positions, kBN .. 3 kBN - 1
  // key c % kBN's k (c < kBN) or v scale
  __device__ void load_meta(int t, int stage, bool int8) const {
    const int k0 = t * kBN;
    const int c = threadIdx.x - kBN;
    if (int8 && c >= 0 && c < 2 * kBN) {
      int slot;
      const int page = page_of(k0 + c % kBN, slot);
      float* dst = scs + stage * 2 * kBN + c;
      if (page >= 0)
        cp_async_ca<4>(dst, (c < kBN ? ksc : vsc) + page * sc_sn);
      else
        *dst = 0.f;
    }
    if (threadIdx.x < kBN) {
      int slot;
      const int page = page_of(k0 + threadIdx.x, slot);
      int* dst = sps + stage * kBN + threadIdx.x;
      if (page >= 0)
        cp_async_ca<4>(dst, sp + page * sp_sn + slot * sp_sp);
      else
        *dst = -1;
    }
  }
  __device__ bool masked(int, int, int) const { return true; }
  __device__ bool ok(int, int c, int stage, int qp) const {
    const int s = sps[stage * kBN + c];
    return s >= 0 && s <= qp;
  }
};

// Key source of flash_tc_body for paged extend (PagedWalk's pages): bf16
// K/V rows land in the stage's tiles.  KT int8_t: the stage's codes land
// in a ring of their own ([kStages][K, V][kBN][Dh] codes), and convert()
// turns a landed stage's codes into the bf16 tile the products read; the
// scales apply to the scores and to P.
template <typename KT>
struct PagedKeys : PagedWalk {
  static constexpr bool kInt8 = std::is_same_v<KT, int8_t>;
  const KT* k;
  const KT* v;
  int64_t a_sn, a_sp, lh;  // lh: the layer's and kv head's offset
  int8_t* codes;           // int8: the ring of codes, shared memory

  // tile t into stage `stage`: bf16 rows into kd / vd (row stride ld),
  // int8 codes into the stage of the ring (kd / vd unused)
  __device__ void load(int t, int stage, bf16* kd, bf16* vd, int ld, int chunks) const {
    const int k0 = t * kBN;
    if constexpr (kInt8) {
      const int dh = chunks * 8, n16 = chunks / 2;  // 16 codes a copy
      int8_t* kc = codes + stage * 2 * kBN * dh;
      int8_t* vc = kc + kBN * dh;
      for (int c = threadIdx.x; c < kBN * n16; c += kThreads) {
        const int r = c / n16, d = (c - r * n16) * 16;
        int slot;
        const int page = page_of(k0 + r, slot);
        const int64_t off = page >= 0 ? page * a_sn + slot * a_sp + lh : 0;
        cp_async16(kc + r * dh + d, k + off + d, page >= 0);
        cp_async16(vc + r * dh + d, v + off + d, page >= 0);
      }
    } else {
      for (int c = threadIdx.x; c < kBN * chunks; c += kThreads) {
        const int r = c / chunks, d = (c - r * chunks) * 8;
        int slot;
        const int page = page_of(k0 + r, slot);
        const int64_t off = page >= 0 ? page * a_sn + slot * a_sp + lh : 0;
        cp_async16(kd + r * ld + d, k + off + d, page >= 0);
        cp_async16(vd + r * ld + d, v + off + d, page >= 0);
      }
    }
    load_meta(t, stage, kInt8);
  }
  // int8: a landed stage's codes as bf16 into the tile kd / vd
  __device__ void convert(int stage, bf16* kd, bf16* vd, int ld, int chunks) const {
    const int dh = chunks * 8;
    const int8_t* kc = codes + stage * 2 * kBN * dh;
    const int8_t* vc = kc + kBN * dh;
    for (int c = threadIdx.x; c < kBN * chunks; c += kThreads) {
      const int r = c / chunks, d = (c - r * chunks) * 8;
      *reinterpret_cast<uint4*>(kd + r * ld + d) =
          bf16x8_of_int8x8(*reinterpret_cast<const uint2*>(kc + r * dh + d));
      *reinterpret_cast<uint4*>(vd + r * ld + d) =
          bf16x8_of_int8x8(*reinterpret_cast<const uint2*>(vc + r * dh + d));
    }
  }
  // int8: the k or v scales of keys c and c + 1 of a stage (c even)
  __device__ float2 k_scales(int stage, int c) const {
    return *reinterpret_cast<const float2*>(scs + stage * 2 * kBN + c);
  }
  __device__ float2 v_scales(int stage, int c) const {
    return *reinterpret_cast<const float2*>(scs + stage * 2 * kBN + kBN + c);
  }
};

// The body shared by the prefill and paged extend tensor-core kernels:
// packed rows p0 .. p0 + 63 of kv head hkv in row b; row p is q position
// p / G (absolute position off + p / G) of q head hkv * G + p % G.  A key
// source of int8 codes (Keys::kInt8) has one bf16 K/V tile, which each
// landed stage is converted into, and scales applied to the scores and P.
template <int kDhMax, class Keys>
__device__ __forceinline__ void flash_tc_body(
    const bf16* __restrict__ q, int64_t q_sb, int64_t q_ss, int64_t q_sh,
    bf16* __restrict__ out, int64_t o_sb, int64_t o_ss, int64_t o_sh, float* __restrict__ lse,
    int Sq, int G, int Dh, int off, float scale_log2, const Keys& keys, bf16* qs) {
  const int ld = Dh + 8;
  constexpr int kTiles = Keys::kInt8 ? 1 : kStages;  // bf16 K/V tiles
  bf16* ks = qs + kTcRows * ld;                   // [kTiles][kBN][ld]
  bf16* vs = ks + kTiles * kBN * ld;            // [kTiles][kBN][ld]
  // offset of the tile a stage's keys are read from
  auto tile = [&](int st) { return (Keys::kInt8 ? 0 : st) * kBN * ld; };
  const int p0 = blockIdx.x * kTcRows, hkv = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int chunks = Dh / 8;                      // 16-byte chunks of a row
  const int n_kk = Dh / 16;                       // 16-deep slices of a row

  // the block's Q rows; rows past Sq are zero-filled and never stored
  for (int c = tid; c < kTcRows * chunks; c += kThreads) {
    const int r = c / chunks, d = (c - r * chunks) * 8;
    const int p = p0 + r, i = p / G;
    const bool ok = i < Sq;
    const bf16* src = ok ? q + b * q_sb + i * q_ss + (hkv * G + p % G) * q_sh + d : q;
    cp_async16(qs + r * ld + d, src, ok);
  }

  // the kv tiles the block's rows can see
  const int q_lo = off + p0 / G;
  const int q_hi = off + min(Sq - 1, (p0 + kTcRows - 1) / G);
  const int t_end = keys.t_end(q_hi);
  const int t_begin = keys.t_begin(q_lo);

  // prologue: tiles t_begin .. t_begin + kStages - 2 in flight, one
  // commit group each (Q rides in the first)
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (t_begin + st < t_end)
      keys.load(t_begin + st, st, ks + tile(st), vs + tile(st), ld, chunks);
    cp_async_commit();
  }

  // this thread's two rows of the warp's 16: g and g + 8
  const int wr = p0 + warp * 16;
  int qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) qpos[h] = off + (wr + g + 8 * h) / G;
  const int wq_lo = off + wr / G, wq_hi = off + (wr + 15) / G;
  float o[kDhMax / 8][4];
#pragma unroll
  for (int j = 0; j < kDhMax / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {kNegInit, kNegInit}, l[2] = {0.f, 0.f};
  const bf16* qw = qs + (warp * 16 + (lane & 15)) * ld + (lane >> 4) * 8;

  for (int t = t_begin; t < t_end; ++t) {
    const int stage = (t - t_begin) % kStages;
    cp_async_wait<kStages - 2>();  // this tile (and Q) landed
    __syncthreads();                 // ... for every warp; tile t - 1 is consumed
    const int nxt = t + kStages - 1;
    if (nxt < t_end) {               // into t - 1's stage
      const int ns = (nxt - t_begin) % kStages;
      keys.load(nxt, ns, ks + tile(ns), vs + tile(ns), ld, chunks);
    }
    cp_async_commit();
    if constexpr (Keys::kInt8) {
      keys.convert(stage, ks, vs, ld, chunks);
      __syncthreads();  // the bf16 tile is whole for every warp
    }
    const bf16* kt = ks + tile(stage);
    const bf16* vt = vs + tile(stage);

    // S = Q K^T, 16 rows x kBN keys per warp
    float s[kBN / 8][4];
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDhMax / 16; ++kk) {
      if (kk < n_kk) {
        uint32_t a[4];
        ldmatrix_x4(a, qw + kk * 16);
#pragma unroll
        for (int j = 0; j < kBN / 16; ++j) {
          uint32_t bk[4];
          ldmatrix_x4(bk, kt + (j * 16 + (lane & 7) + ((lane >> 4) << 3)) * ld + kk * 16 +
                              ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * j], a, bk[0], bk[1]);
          mma_bf16(s[2 * j + 1], a, bk[2], bk[3]);
        }
      }
    }

    // scale into log2 units (int8: times the key's k scale, in float32 as
    // JAX dequantises); mask where the key source asks for it
    const int k0 = t * kBN;
    const bool masked = keys.masked(k0, wq_lo, wq_hi);
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      float f[2] = {scale_log2, scale_log2};  // this lane's key columns of s[j]
      if constexpr (Keys::kInt8) {
        const float2 sk = keys.k_scales(stage, j * 8 + 2 * t4);
        f[0] *= sk.x;
        f[1] *= sk.y;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * f[e & 1];
        if (masked && !keys.ok(k0, j * 8 + 2 * t4 + (e & 1), stage, qpos[e >> 1])) x = -INFINITY;
        s[j][e] = x;
      }
    }

    // online softmax: row max over the quad, p = 2^(s - m), rescale O
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);  // finite: m starts at -1e30
      const float corr = exp2f(m[h] - m_new);
      m[h] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        s[j][2 * h] = exp2f(s[j][2 * h] - m_new);  // -inf -> 0
        s[j][2 * h + 1] = exp2f(s[j][2 * h + 1] - m_new);
        sum += s[j][2 * h] + s[j][2 * h + 1];
      }
      l[h] = l[h] * corr + sum;  // this lane's part; the quad sums at the end
#pragma unroll
      for (int j = 0; j < kDhMax / 8; ++j) {
        o[j][2 * h] *= corr;
        o[j][2 * h + 1] *= corr;
      }
    }

    // int8: V = code * v_scale, each key column's scale taken into P
    // (the sum l above keeps the unscaled p)
    if constexpr (Keys::kInt8) {
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const float2 sv = keys.v_scales(stage, j * 8 + 2 * t4);
        s[j][0] *= sv.x;
        s[j][1] *= sv.y;
        s[j][2] *= sv.x;
        s[j][3] *= sv.y;
      }
    }

    // O += P V: P rounded to bf16 in registers is the A operand
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const bf16* vrow = vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
#pragma unroll
      for (int jd = 0; jd < kDhMax / 16; ++jd) {
        if (jd < n_kk) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vrow + jd * 16);
          mma_bf16(o[2 * jd], a, bv[0], bv[1]);
          mma_bf16(o[2 * jd + 1], a, bv[2], bv[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // out = O / l, rows past Sq dropped; a row with no valid key stores 0;
  // lse (when given) = (m + log2 l) ln 2, m and l being in log2 units
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = l[h];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    const int p = wr + g + 8 * h, i = p / G;
    if (i >= Sq) continue;
    if (lse != nullptr && t4 == 0)
      lse[((int64_t)b * gridDim.y * G + hkv * G + p % G) * Sq + i] =
          (m[h] + log2f(fmaxf(sum, 1e-30f))) * 0.6931471805599453f;
    bf16* orow = out + b * o_sb + i * o_ss + (hkv * G + p % G) * o_sh + 2 * t4;
#pragma unroll
    for (int j = 0; j < kDhMax / 8; ++j) {
      if (j < 2 * n_kk)
        *reinterpret_cast<uint32_t*>(orow + j * 8) =
            pack_bf16(o[j][2 * h] * inv, o[j][2 * h + 1] * inv);
    }
  }
}

// Up to Dh 128 the register budget is held to 128 a thread, so that four
// blocks fit on an SM (the S 128 grids are one wave of them).
template <int kDhMax>
__global__ void __launch_bounds__(kThreads, kDhMax <= 128 ? 4 : 1) flash_tc_kernel(
    const bf16* __restrict__ q, int64_t q_sb, int64_t q_ss, int64_t q_sh,
    const bf16* __restrict__ k, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    const bf16* __restrict__ v, int64_t v_sb, int64_t v_ss, int64_t v_sh,
    bf16* __restrict__ out, int64_t o_sb, int64_t o_ss, int64_t o_sh,
    int Sq, int Skv, const int* __restrict__ kv_len, int G, int Dh, int causal, int window,
    float scale_log2, float* __restrict__ lse) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hkv = blockIdx.y, b = blockIdx.z;
  // q positions stay aligned to the end of all Skv keys; the key source
  // ends at the row's limit
  const DenseKeys<bf16> keys{k + b * k_sb + hkv * k_sh, v + b * v_sb + hkv * v_sh, k_ss, v_ss,
                             key_limit(kv_len, b, Skv), causal, window};
  flash_tc_body<kDhMax>(q, q_sb, q_ss, q_sh, out, o_sb, o_ss, o_sh, lse, Sq, G, Dh, Skv - Sq,
                        scale_log2, keys, reinterpret_cast<bf16*>(smem_raw));
}

// Shared memory of paged_extend_tc_kernel: the tiles (bf16 arena:
// flash_tc_kernel's; int8: the Q rows, one bf16 K/V tile, then the ring
// of codes and the keys' scales), then the stages' slot positions and
// the row's block table.  At Dh 128 about 52 KB either way, so four
// blocks fit on an SM.
template <typename KT>
__host__ __device__ inline size_t paged_extend_tc_tiles_bytes(int dh) {
  if constexpr (std::is_same_v<KT, int8_t>)
    return tc_tile_bytes(dh, 1) + (size_t)kStages * 2 * kBN * (dh + sizeof(float));
  else
    return flash_tc_smem_bytes(dh);
}
template <typename KT>
__host__ __device__ inline size_t paged_extend_tc_smem_bytes(int dh, int n_log) {
  return paged_extend_tc_tiles_bytes<KT>(dh) + sizeof(int) * ((size_t)kStages * kBN + n_log);
}

template <int kDhMax, typename KT>
__global__ void __launch_bounds__(kThreads, kDhMax <= 128 ? 4 : 1) paged_extend_tc_kernel(
    const bf16* __restrict__ q, int64_t q_sb, int64_t q_ss, int64_t q_sh,
    const KT* __restrict__ k, const KT* __restrict__ v,
    int64_t a_sn, int64_t a_sp, int64_t a_sl, int64_t a_sh,
    const int* __restrict__ slot_pos, int64_t sp_sn, int64_t sp_sp, int64_t sp_sl,
    const int* __restrict__ block_table, int64_t bt_sb, int n_log,
    const int* __restrict__ pos, int layer,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    int64_t sc_sn, int64_t sc_sl,
    bf16* __restrict__ out, int64_t o_sb, int64_t o_ss, int64_t o_sh,
    int Sq, int G, int Dh, int N, int P, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hkv = blockIdx.y, b = blockIdx.z;
  // int8: [codes | scales] after the Q rows and the one K/V tile
  int8_t* codes = reinterpret_cast<int8_t*>(smem_raw + tc_tile_bytes(Dh, 1));
  float* scs = reinterpret_cast<float*>(codes + kStages * 2 * kBN * Dh);
  int* sps = reinterpret_cast<int*>(smem_raw + paged_extend_tc_tiles_bytes<KT>(Dh));
  int* bts = sps + kStages * kBN;
  load_block_table(bts, block_table + b * bt_sb, n_log);
  const int off = pos[b];
  __syncthreads();
  const PagedKeys<KT> keys{{slot_pos + layer * sp_sl, sp_sn, sp_sp, bts, sps, n_log, N, P,
                            k_scale + layer * sc_sl, v_scale + layer * sc_sl, sc_sn, scs},
                           k, v, a_sn, a_sp, layer * a_sl + hkv * a_sh, codes};
  flash_tc_body<kDhMax>(q, q_sb, q_ss, q_sh, out, o_sb, o_ss, o_sh, nullptr, Sq, G, Dh, off,
                        scale_log2, keys, reinterpret_cast<bf16*>(smem_raw));
}

template <int kDhMax>
cudaError_t launch_flash_tc(const void* q, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                            const void* k, int64_t k_sb, int64_t k_ss, int64_t k_sh,
                            const void* v, int64_t v_sb, int64_t v_ss, int64_t v_sh,
                            void* out, int64_t o_sb, int64_t o_ss, int64_t o_sh, int B,
                            int Hq, int Hkv, int Sq, int Skv, const int* kv_len, int Dh,
                            int causal, int window, float* lse, cudaStream_t stream) {
  const size_t smem = flash_tc_smem_bytes(Dh);
  auto kernel = flash_tc_kernel<kDhMax>;
  const int G = Hq / Hkv;
  const dim3 grid((Sq * G + kTcRows - 1) / kTcRows, Hkv, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), q_sb, q_ss, q_sh, static_cast<const bf16*>(k), k_sb, k_ss,
      k_sh, static_cast<const bf16*>(v), v_sb, v_ss, v_sh, static_cast<bf16*>(out), o_sb,
      o_ss, o_sh, Sq, Skv, kv_len, G, Dh, causal, window,
      rsqrtf(static_cast<float>(Dh)) * 1.4426950408889634f, lse);
  return cudaGetLastError();
}

// The bf16 route: Dh % 16 == 0 up to 256, 16-byte aligned rows (every
// stride but the last a multiple of 8 elements); the wrapper checks both.
inline cudaError_t launch_flash_bf16(const void* q, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                                     const void* k, int64_t k_sb, int64_t k_ss, int64_t k_sh,
                                     const void* v, int64_t v_sb, int64_t v_ss, int64_t v_sh,
                                     void* out, int64_t o_sb, int64_t o_ss, int64_t o_sh,
                                     int B, int Hq, int Hkv, int Sq, int Skv,
                                     const int* kv_len, int Dh, int causal, int window,
                                     float* lse, cudaStream_t stream) {
  if (Dh % 16 || Dh > 256) return cudaErrorInvalidValue;
  const int64_t strides = q_sb | q_ss | q_sh | k_sb | k_ss | k_sh | v_sb | v_ss | v_sh |
                          o_sb | o_ss | o_sh;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
  if (strides % 8 || bases % 16) return cudaErrorMisalignedAddress;
#define RT_FLASH_TC(DH)                                                                    \
  return launch_flash_tc<DH>(q, q_sb, q_ss, q_sh, k, k_sb, k_ss, k_sh, v, v_sb, v_ss, v_sh, \
                             out, o_sb, o_ss, o_sh, B, Hq, Hkv, Sq, Skv, kv_len, Dh, causal, \
                             window, lse, stream)
  if (Dh <= 64) RT_FLASH_TC(64);
  if (Dh <= 128) RT_FLASH_TC(128);
  RT_FLASH_TC(256);
#undef RT_FLASH_TC
}

// The bf16 q paged extend routes: flash_tc_body over a paged key source
// of bf16 rows or int8 codes (KT).  Dh % 16 == 0 up to 256; 16-byte
// aligned q, out and arena rows (the wrapper checks both and copies q if
// needed; an arena it cannot copy).
template <typename KT>
cudaError_t launch_paged_extend_tc(
    const void* q, int64_t q_sb, int64_t q_ss, int64_t q_sh, const void* k, const void* v,
    int64_t a_sn, int64_t a_sp, int64_t a_sl, int64_t a_sh,
    const int* slot_pos, int64_t sp_sn, int64_t sp_sp, int64_t sp_sl,
    const int* block_table, int64_t bt_sb, int n_log, const int* pos, int layer,
    const float* k_scale, const float* v_scale, int64_t sc_sn, int64_t sc_sl,
    void* out, int64_t o_sb, int64_t o_ss, int64_t o_sh,
    int B, int Hq, int Hkv, int Sq, int Dh, int N, int P, cudaStream_t stream) {
  if (Dh % 16 || Dh > 256) return cudaErrorInvalidValue;
  constexpr int64_t kRow = 16 / sizeof(KT);  // arena elements in 16 bytes
  const int64_t q_strides = q_sb | q_ss | q_sh | o_sb | o_ss | o_sh;
  const int64_t a_strides = a_sn | a_sp | a_sl | a_sh;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
  if (q_strides % 8 || a_strides % kRow || bases % 16) return cudaErrorMisalignedAddress;
  const size_t smem = paged_extend_tc_smem_bytes<KT>(Dh, n_log);
  const int G = Hq / Hkv;
  const dim3 grid((Sq * G + kTcRows - 1) / kTcRows, Hkv, B);
  const float scale_log2 = rsqrtf(static_cast<float>(Dh)) * 1.4426950408889634f;
#define RT_EXTEND_TC(DH)                                                                   \
  {                                                                                        \
    paged_extend_tc_kernel<DH, KT><<<grid, kThreads, smem, stream>>>(                      \
        static_cast<const bf16*>(q), q_sb, q_ss, q_sh, static_cast<const KT*>(k),          \
        static_cast<const KT*>(v), a_sn, a_sp, a_sl, a_sh, slot_pos, sp_sn, sp_sp, sp_sl,  \
        block_table, bt_sb, n_log, pos, layer, k_scale, v_scale, sc_sn, sc_sl,             \
        static_cast<bf16*>(out), o_sb, o_ss, o_sh, Sq, G, Dh, N, P, scale_log2);           \
    return cudaGetLastError();                                                             \
  }
  if (Dh <= 64) RT_EXTEND_TC(64);
  if (Dh <= 128) RT_EXTEND_TC(128);
  RT_EXTEND_TC(256);
#undef RT_EXTEND_TC
}

// ---------------------------------------------------------------------------
// float32 route: CUDA cores, exact float32 products
// ---------------------------------------------------------------------------
// Tiles of the float32 body in the head-dim class kDh (64, 128 or 256; a
// smaller Dh runs in its class with zero columns).  A warp owns kWarpRows
// packed rows; its lane (rg, cg) = (lane / 8, lane % 8) holds rows rg +
// 4 i (i < kTR) of them: of S, keys cg + 8 j of the tile (j < 4), of the
// output accumulator, columns 4 cg + 32 u .. + 3 (u < kCU).  Q, K and V
// rows are kDh + 4 floats: the float4 reads of 4 (or 8) consecutive rows
// by a warp fall on distinct banks.  Each warp has its own P buffer,
// [key][the warp's rows], so P crosses lanes with no block barrier.
template <int kDh>
struct F32Fwd {
  static constexpr int kTR = kDh > 128 ? 2 : 4;
  static constexpr int kWarpRows = 4 * kTR;
  static constexpr int kRows = 4 * kWarpRows;   // a block: 64, or 32 past Dh 128
  static constexpr int kLd = kDh + 4;
  static constexpr int kCU = kDh / 32;
  static constexpr int kChunks = kDh / 4;       // 16-byte chunks of a row
  // Q rows, kTiles K and V tiles, the warps' P buffers (floats)
  __host__ __device__ static constexpr size_t body_bytes(int tiles) {
    return sizeof(float) *
           ((size_t)kRows * kLd + 2 * (size_t)tiles * kBN * kLd + 4 * kBN * kWarpRows);
  }
};

// Key source of flash_f32_body for paged extend (PagedWalk's pages):
// float rows land in the stage's tiles.  Arena rows on 16 bytes (vec)
// stream through 16-byte cp.async copies; any other view, which the
// wrapper cannot copy cheaply, through element loads into the same tiles.
// KT int8_t: the stage's codes land in a ring of their own ([kStages][K,
// V][kBN][kDh] codes), and convert() writes a landed stage as code *
// scale, the arena's values exactly as JAX dequantises them, into the one
// float K/V tile.
template <typename KT, int kDh>
struct PagedF32Keys : PagedWalk {
  static constexpr bool kInt8 = std::is_same_v<KT, int8_t>;
  using T = F32Fwd<kDh>;
  const KT* k;
  const KT* v;
  int64_t a_sn, a_sp, lh;  // lh: the layer's and kv head's offset
  int8_t* codes;           // int8: the ring of codes, shared memory
  int Dh, vec;

  // tile t into stage `stage`: float rows into kd / vd, int8 codes into
  // the stage of the ring (kd / vd unused); columns past Dh are zeros
  __device__ void load(int t, int stage, float* kd, float* vd, int, int) const {
    const int k0 = t * kBN;
    constexpr int kCpr = kInt8 ? kDh / 16 : T::kChunks;  // 16-byte copies a row
    constexpr int kE = 16 / sizeof(KT);                  // elements a copy
    KT* kc;
    KT* vc;
    int ld;
    if constexpr (kInt8) {
      kc = codes + stage * 2 * kBN * kDh;
      vc = kc + kBN * kDh;
      ld = kDh;
    } else {
      kc = kd;
      vc = vd;
      ld = T::kLd;
    }
    if (vec) {
      for (int c = threadIdx.x; c < kBN * kCpr; c += kThreads) {
        const int r = c / kCpr, e = (c % kCpr) * kE;
        int slot;
        const int page = page_of(k0 + r, slot);
        const bool ok = page >= 0 && e < Dh;
        const int64_t off = ok ? page * a_sn + slot * a_sp + lh + e : 0;
        cp_async16(kc + r * ld + e, k + off, ok);
        cp_async16(vc + r * ld + e, v + off, ok);
      }
    } else {
      for (int c = threadIdx.x; c < kBN * kDh; c += kThreads) {
        const int r = c / kDh, e = c % kDh;
        int slot;
        const int page = page_of(k0 + r, slot);
        const bool ok = page >= 0 && e < Dh;
        const int64_t off = ok ? page * a_sn + slot * a_sp + lh + e : 0;
        kc[r * ld + e] = ok ? k[off] : KT(0);
        vc[r * ld + e] = ok ? v[off] : KT(0);
      }
    }
    load_meta(t, stage, kInt8);
  }
  // int8: a landed stage's codes times their keys' scales into kd / vd
  __device__ void convert(int stage, float* kd, float* vd) const {
    const int8_t* kc = codes + stage * 2 * kBN * kDh;
    const int8_t* vc = kc + kBN * kDh;
    const float* sc = scs + stage * 2 * kBN;
    for (int c = threadIdx.x; c < kBN * T::kChunks; c += kThreads) {
      const int r = c / T::kChunks, e = (c % T::kChunks) * 4;
      const char4 a = *reinterpret_cast<const char4*>(kc + r * kDh + e);
      const char4 w = *reinterpret_cast<const char4*>(vc + r * kDh + e);
      const float s = sc[r], t = sc[kBN + r];
      *reinterpret_cast<float4*>(kd + r * T::kLd + e) =
          make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
      *reinterpret_cast<float4*>(vd + r * T::kLd + e) =
          make_float4(w.x * t, w.y * t, w.z * t, w.w * t);
    }
  }
};

// The body shared by the float32 prefill and paged extend kernels: packed
// rows p0 .. p0 + kRows - 1 of kv head hkv = blockIdx.x in row b =
// blockIdx.y, the last rows (the longest causal walks) in the first
// blocks; row p is q position p / G (absolute position off + p / G) of q
// head hkv * G + p % G.  K/V tiles of kBN keys stream through a
// two-stage cp.async ring (an int8 source: its codes do, and each landed
// stage is converted into one float tile).  A thread's S and output
// tiles stay in registers (F32Fwd); the running max is reduced across the
// 8 lanes that share a row by shuffles, each lane keeps its part of the
// running sum until the end, and P crosses the warp's lanes through its
// own shared buffer.  Every product is an fmaf, each output element is
// summed over the keys in one order: two calls give the same bits.
template <int kDh, class Keys>
__device__ __forceinline__ void flash_f32_body(
    const float* __restrict__ q, int64_t q_sb, int64_t q_ss, int64_t q_sh,
    float* __restrict__ out, int64_t o_sb, int64_t o_ss, int64_t o_sh, float* __restrict__ lse,
    int Sq, int G, int Dh, int off, float scale_log2, const Keys& keys, float* smem) {
  using T = F32Fwd<kDh>;
  constexpr int kTR = T::kTR, kLd = T::kLd, kCU = T::kCU, kWR = T::kWarpRows;
  constexpr int kTiles = Keys::kInt8 ? 1 : kStages;  // float K/V tiles
  float* qs = smem;                                     // [kRows][kLd]
  float* ks = qs + T::kRows * kLd;                      // [kTiles][kBN][kLd]
  float* vs = ks + kTiles * kBN * kLd;               // [kTiles][kBN][kLd]
  float* ps = vs + kTiles * kBN * kLd;               // [4 warps][kBN][kWR]
  auto tile = [&](int st) { return (Keys::kInt8 ? 0 : st) * kBN * kLd; };
  const int hkv = blockIdx.x, b = blockIdx.y;
  const int p0 = (gridDim.z - 1 - blockIdx.z) * T::kRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = lane >> 3, cg = lane & 7;
  const int nch = Dh / 4;

  // the block's Q rows; rows past Sq and columns past Dh are zeros
  for (int c = tid; c < T::kRows * T::kChunks; c += kThreads) {
    const int r = c / T::kChunks, ch = c % T::kChunks;
    const int p = p0 + r, i = p / G;
    const bool ok = i < Sq && ch < nch;
    const float* src = ok ? q + b * q_sb + i * q_ss + (hkv * G + p % G) * q_sh + 4 * ch : q;
    cp_async16(qs + r * kLd + 4 * ch, src, ok);
  }

  // the dense source copies Dh columns a row: the K/V tiles' columns
  // past Dh are zeroed here once, for every stage
  if constexpr (std::is_same_v<Keys, DenseKeys<float>>)
    if (Dh < kDh)
      for (int c = tid; c < 2 * kTiles * kBN * (kDh - Dh) / 4; c += kThreads) {
        const int r = c / ((kDh - Dh) / 4), e = Dh + 4 * (c % ((kDh - Dh) / 4));
        *reinterpret_cast<float4*>(ks + r * kLd + e) = make_float4(0.f, 0.f, 0.f, 0.f);
      }

  // the kv tiles the block's rows can see; the first rides with Q
  const int q_lo = off + p0 / G;
  const int q_hi = off + min(Sq - 1, (p0 + T::kRows - 1) / G);
  const int t_end = keys.t_end(q_hi);
  const int t_begin = keys.t_begin(q_lo);
  if (t_begin < t_end) keys.load(t_begin, 0, ks + tile(0), vs + tile(0), kLd, nch);
  cp_async_commit();

  const int wr = warp * kWR;  // the warp's first row in the block
  int qpos[kTR];
#pragma unroll
  for (int i = 0; i < kTR; ++i) qpos[i] = off + (p0 + wr + rg + 4 * i) / G;
  const int wq_lo = off + (p0 + wr) / G, wq_hi = off + (p0 + wr + kWR - 1) / G;
  float o[kTR][4 * kCU];
#pragma unroll
  for (int i = 0; i < kTR; ++i)
#pragma unroll
    for (int c = 0; c < 4 * kCU; ++c) o[i][c] = 0.f;
  float m[kTR], l[kTR];
#pragma unroll
  for (int i = 0; i < kTR; ++i) m[i] = kNegInit, l[i] = 0.f;
  const float* qw = qs + (wr + rg) * kLd;
  float* pw = ps + warp * kBN * kWR;

  for (int t = t_begin; t < t_end; ++t) {
    const int stage = (t - t_begin) & 1;
    cp_async_wait<0>();  // this tile (and Q) landed
    __syncthreads();     // ... for every thread; tile t - 1 is consumed
    if (t + 1 < t_end)
      keys.load(t + 1, stage ^ 1, ks + tile(stage ^ 1), vs + tile(stage ^ 1), kLd, nch);
    cp_async_commit();
    if constexpr (Keys::kInt8) {
      keys.convert(stage, ks, vs);
      __syncthreads();  // the float tile is whole for every warp
    }
    const float* kt = ks + tile(stage) + cg * kLd;
    const float* vt = vs + tile(stage) + 4 * cg;

    // S = Q K^T: rows rg + 4 i, keys cg + 8 j
    float s[kTR][4];
#pragma unroll
    for (int i = 0; i < kTR; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kDh; d += 4) {
      float4 qv[kTR], kv[4];
#pragma unroll
      for (int i = 0; i < kTR; ++i) qv[i] = lds4(qw + 4 * i * kLd + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = lds4(kt + 8 * j * kLd + d);
#pragma unroll
      for (int i = 0; i < kTR; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fma4(qv[i], kv[j], s[i][j]);
    }

    // scores in log2 units, masked where the key source asks; online
    // softmax: the row max over the 8 lanes of the row, p = 2^(s - m),
    // the lane's part of the sum, O rescaled
    const int k0 = t * kBN;
    const bool masked = keys.masked(k0, wq_lo, wq_hi);
#pragma unroll
    for (int i = 0; i < kTR; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * scale_log2;
        if (masked && !keys.ok(k0, cg + 8 * j, stage, qpos[i])) x = -INFINITY;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);  // finite: m starts at -1e30
      const float corr = exp2f(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = exp2f(s[i][j] - m_new);  // -inf -> 0
        sum += s[i][j];
      }
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int c = 0; c < 4 * kCU; ++c) o[i][c] *= corr;
    }

    // P into the warp's buffer, [key][rg * kTR + i], then O += P V
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* dst = pw + (cg + 8 * j) * kWR + rg * kTR;
      if constexpr (kTR == 4)
        *reinterpret_cast<float4*>(dst) = make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      else
        *reinterpret_cast<float2*>(dst) = make_float2(s[0][j], s[1][j]);
    }
    __syncwarp();
#pragma unroll 4
    for (int c = 0; c < kBN; ++c) {
      float pv[kTR];
      const float* src = pw + c * kWR + rg * kTR;
      if constexpr (kTR == 4) {
        const float4 x = lds4(src);
        pv[0] = x.x, pv[1] = x.y, pv[2] = x.z, pv[3] = x.w;
      } else {
        const float2 x = *reinterpret_cast<const float2*>(src);
        pv[0] = x.x, pv[1] = x.y;
      }
      float4 vv[kCU];
#pragma unroll
      for (int u = 0; u < kCU; ++u) vv[u] = lds4(vt + c * kLd + 32 * u);
#pragma unroll
      for (int i = 0; i < kTR; ++i)
#pragma unroll
        for (int u = 0; u < kCU; ++u) {
          o[i][4 * u] = fmaf(pv[i], vv[u].x, o[i][4 * u]);
          o[i][4 * u + 1] = fmaf(pv[i], vv[u].y, o[i][4 * u + 1]);
          o[i][4 * u + 2] = fmaf(pv[i], vv[u].z, o[i][4 * u + 2]);
          o[i][4 * u + 3] = fmaf(pv[i], vv[u].w, o[i][4 * u + 3]);
        }
    }
  }
  cp_async_wait<0>();

  // out = O / l, rows past Sq dropped; a row with no valid key stores 0;
  // lse (when given) = (m + log2 l) ln 2, m and l being in log2 units
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    float sum = l[i];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    sum += __shfl_xor_sync(0xffffffffu, sum, 4);
    const int p = p0 + wr + rg + 4 * i, qi = p / G, h = hkv * G + p % G;
    if (qi >= Sq) continue;
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    if (lse != nullptr && cg == 0)
      lse[((int64_t)b * gridDim.x * G + h) * Sq + qi] =
          (m[i] + log2f(fmaxf(sum, 1e-30f))) * 0.6931471805599453f;
    float* orow = out + b * o_sb + qi * o_ss + h * o_sh + 4 * cg;
#pragma unroll
    for (int u = 0; u < kCU; ++u)
      if (4 * cg + 32 * u < Dh)
        *reinterpret_cast<float4*>(orow + 32 * u) =
            make_float4(o[i][4 * u] * inv, o[i][4 * u + 1] * inv, o[i][4 * u + 2] * inv,
                        o[i][4 * u + 3] * inv);
  }
}

// Up to Dh 128 two blocks share an SM (110 KB of shared memory at Dh
// 128); past it one block of 32 rows.
template <int kDh>
__global__ void __launch_bounds__(kThreads, kDh > 128 ? 1 : 2) flash_kernel(
    const float* __restrict__ q, int64_t q_sb, int64_t q_ss, int64_t q_sh,
    const float* __restrict__ k, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    const float* __restrict__ v, int64_t v_sb, int64_t v_ss, int64_t v_sh,
    float* __restrict__ out, int64_t o_sb, int64_t o_ss, int64_t o_sh,
    int Sq, int Skv, const int* __restrict__ kv_len, int G, int Dh, int causal, int window,
    float scale_log2, float* __restrict__ lse) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hkv = blockIdx.x, b = blockIdx.y;
  // q positions stay aligned to the end of all Skv keys; the key source
  // ends at the row's limit
  const DenseKeys<float> keys{k + b * k_sb + hkv * k_sh, v + b * v_sb + hkv * v_sh, k_ss, v_ss,
                              key_limit(kv_len, b, Skv), causal, window};
  flash_f32_body<kDh>(q, q_sb, q_ss, q_sh, out, o_sb, o_ss, o_sh, lse, Sq, G, Dh, Skv - Sq,
                      scale_log2, keys, reinterpret_cast<float*>(smem_raw));
}

// Shared memory of paged_extend_kernel: the body's tiles (an int8 arena:
// one float K/V tile, then the ring of codes and the keys' scales), then
// the stages' slot positions and the row's block table.
template <int kDh, typename KT>
__host__ __device__ inline size_t paged_extend_tiles_bytes() {
  if constexpr (std::is_same_v<KT, int8_t>)
    return F32Fwd<kDh>::body_bytes(1) + (size_t)kStages * 2 * kBN * (kDh + sizeof(float));
  else
    return F32Fwd<kDh>::body_bytes(kStages);
}

template <int kDh, typename KT>
__global__ void __launch_bounds__(kThreads, kDh > 128 ? 1 : 2) paged_extend_kernel(
    const float* __restrict__ q, int64_t q_sb, int64_t q_ss, int64_t q_sh,
    const KT* __restrict__ k, const KT* __restrict__ v,
    int64_t a_sn, int64_t a_sp, int64_t a_sl, int64_t a_sh,
    const int* __restrict__ slot_pos, int64_t sp_sn, int64_t sp_sp, int64_t sp_sl,
    const int* __restrict__ block_table, int64_t bt_sb, int n_log,
    const int* __restrict__ pos, int layer,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    int64_t sc_sn, int64_t sc_sl,
    float* __restrict__ out, int64_t o_sb, int64_t o_ss, int64_t o_sh,
    int Sq, int G, int Dh, int N, int P, int vec, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hkv = blockIdx.x, b = blockIdx.y;
  // int8: [codes | scales] after the Q rows, the one K/V tile and P
  int8_t* codes = reinterpret_cast<int8_t*>(smem_raw + F32Fwd<kDh>::body_bytes(1));
  float* scs = reinterpret_cast<float*>(codes + kStages * 2 * kBN * kDh);
  int* sps = reinterpret_cast<int*>(smem_raw + paged_extend_tiles_bytes<kDh, KT>());
  int* bts = sps + kStages * kBN;
  load_block_table(bts, block_table + b * bt_sb, n_log);
  const int off = pos[b];
  __syncthreads();
  const PagedF32Keys<KT, kDh> keys{
      {slot_pos + layer * sp_sl, sp_sn, sp_sp, bts, sps, n_log, N, P, k_scale + layer * sc_sl,
       v_scale + layer * sc_sl, sc_sn, scs},
      k, v, a_sn, a_sp, layer * a_sl + hkv * a_sh, codes, Dh, vec};
  flash_f32_body<kDh>(q, q_sb, q_ss, q_sh, out, o_sb, o_ss, o_sh, nullptr, Sq, G, Dh, off,
                      scale_log2, keys, reinterpret_cast<float*>(smem_raw));
}

// The float32 route: Dh % 4 == 0 up to 256; q, out and (prefill) k, v
// rows on 16 bytes (the wrapper copies q, k and v otherwise).  An extend's
// arena may lie anywhere: rows off 16 bytes (or int8 rows of a head dim
// that is not a multiple of 16) take element loads.
inline cudaError_t launch_flash_f32(const void* q, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                                    const void* k, int64_t k_sb, int64_t k_ss, int64_t k_sh,
                                    const void* v, int64_t v_sb, int64_t v_ss, int64_t v_sh,
                                    void* out, int64_t o_sb, int64_t o_ss, int64_t o_sh,
                                    int B, int Hq, int Hkv, int Sq, int Skv,
                                    const int* kv_len, int Dh, int causal, int window,
                                    float* lse, cudaStream_t stream) {
  if (Dh % 4 || Dh > 256) return cudaErrorInvalidValue;
  const int64_t strides = q_sb | q_ss | q_sh | k_sb | k_ss | k_sh | v_sb | v_ss | v_sh |
                          o_sb | o_ss | o_sh;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
  if (strides % 4 || bases % 16) return cudaErrorMisalignedAddress;
  const int G = Hq / Hkv;
  const float scale_log2 = rsqrtf(static_cast<float>(Dh)) * 1.4426950408889634f;
#define RT_FLASH_F32(DH)                                                                      \
  {                                                                                           \
    const dim3 grid(Hkv, B, (Sq * G + F32Fwd<DH>::kRows - 1) / F32Fwd<DH>::kRows);            \
    flash_kernel<DH><<<grid, kThreads, F32Fwd<DH>::body_bytes(kStages), stream>>>(         \
        static_cast<const float*>(q), q_sb, q_ss, q_sh, static_cast<const float*>(k), k_sb,   \
        k_ss, k_sh, static_cast<const float*>(v), v_sb, v_ss, v_sh, static_cast<float*>(out), \
        o_sb, o_ss, o_sh, Sq, Skv, kv_len, G, Dh, causal, window, scale_log2, lse);           \
    return cudaGetLastError();                                                                \
  }
  if (Dh <= 64) RT_FLASH_F32(64);
  if (Dh <= 128) RT_FLASH_F32(128);
  RT_FLASH_F32(256);
#undef RT_FLASH_F32
}

template <typename KT>
cudaError_t launch_paged_extend_f32(
    const void* q, int64_t q_sb, int64_t q_ss, int64_t q_sh, const void* k, const void* v,
    int64_t a_sn, int64_t a_sp, int64_t a_sl, int64_t a_sh,
    const int* slot_pos, int64_t sp_sn, int64_t sp_sp, int64_t sp_sl,
    const int* block_table, int64_t bt_sb, int n_log, const int* pos, int layer,
    const float* k_scale, const float* v_scale, int64_t sc_sn, int64_t sc_sl,
    void* out, int64_t o_sb, int64_t o_ss, int64_t o_sh,
    int B, int Hq, int Hkv, int Sq, int Dh, int N, int P, cudaStream_t stream) {
  if (Dh % 4 || Dh > 256) return cudaErrorInvalidValue;
  const int64_t q_strides = q_sb | q_ss | q_sh | o_sb | o_ss | o_sh;
  const uintptr_t q_bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(out);
  if (q_strides % 4 || q_bases % 16) return cudaErrorMisalignedAddress;
  constexpr int64_t kRow = 16 / sizeof(KT);  // arena elements in 16 bytes
  const int64_t a_strides = a_sn | a_sp | a_sl | a_sh;
  const uintptr_t a_bases = reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v);
  const int vec = a_strides % kRow == 0 && a_bases % 16 == 0 && Dh % kRow == 0;
  const int G = Hq / Hkv;
  const float scale_log2 = rsqrtf(static_cast<float>(Dh)) * 1.4426950408889634f;
  const size_t table = sizeof(int) * ((size_t)kStages * kBN + n_log);
#define RT_EXTEND_F32(DH)                                                                     \
  {                                                                                           \
    const dim3 grid(Hkv, B, (Sq * G + F32Fwd<DH>::kRows - 1) / F32Fwd<DH>::kRows);            \
    paged_extend_kernel<DH, KT><<<grid, kThreads, paged_extend_tiles_bytes<DH, KT>() + table, \
                                  stream>>>(                                                  \
        static_cast<const float*>(q), q_sb, q_ss, q_sh, static_cast<const KT*>(k),            \
        static_cast<const KT*>(v), a_sn, a_sp, a_sl, a_sh, slot_pos, sp_sn, sp_sp, sp_sl,     \
        block_table, bt_sb, n_log, pos, layer, k_scale, v_scale, sc_sn, sc_sl,                \
        static_cast<float*>(out), o_sb, o_ss, o_sh, Sq, G, Dh, N, P, vec, scale_log2);        \
    return cudaGetLastError();                                                                \
  }
  if (Dh <= 64) RT_EXTEND_F32(64);
  if (Dh <= 128) RT_EXTEND_F32(128);
  RT_EXTEND_F32(256);
#undef RT_EXTEND_F32
}

}  // namespace rt

// Once per process, when the library is bound: every flash and paged
// extend instantiation (prepare_kernels).
extern "C" int rt_prepare_flash() {
  using namespace rt;
  return prepare_kernels({(const void*)flash_kernel<64>, (const void*)flash_kernel<128>,
                          (const void*)flash_kernel<256>, (const void*)flash_tc_kernel<64>,
                          (const void*)flash_tc_kernel<128>, (const void*)flash_tc_kernel<256>,
                          (const void*)paged_extend_kernel<64, float>,
                          (const void*)paged_extend_kernel<128, float>,
                          (const void*)paged_extend_kernel<256, float>,
                          (const void*)paged_extend_kernel<64, int8_t>,
                          (const void*)paged_extend_kernel<128, int8_t>,
                          (const void*)paged_extend_kernel<256, int8_t>,
                          (const void*)paged_extend_tc_kernel<64, bf16>,
                          (const void*)paged_extend_tc_kernel<128, bf16>,
                          (const void*)paged_extend_tc_kernel<256, bf16>,
                          (const void*)paged_extend_tc_kernel<64, int8_t>,
                          (const void*)paged_extend_tc_kernel<128, int8_t>,
                          (const void*)paged_extend_tc_kernel<256, int8_t>});
}

// Plain C entry points bound with ctypes.  Every tensor is given by its
// strides (elements) with a contiguous last dim.  Each returns
// cudaGetLastError() of its launch.

// q/out: (B, Sq, Hq, Dh); k/v: (B, Skv, Hkv, Dh); window < 0 = none; kv_len:
// (B,) int32 key-length mask (key kp of row b counts iff kp < kv_len[b]) or
// null; lse: float32 (B, Hq, Sq) contiguous, each row's log-sum-exp, or null.
// float32 takes the CUDA-core kernel, bf16 the tensor-core kernel.
extern "C" int rt_flash_attention(
    const void* q, int64_t q_sb, int64_t q_ss, int64_t q_sh,
    const void* k, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    const void* v, int64_t v_sb, int64_t v_ss, int64_t v_sh,
    void* out, int64_t o_sb, int64_t o_ss, int64_t o_sh,
    int B, int Hq, int Hkv, int Sq, int Skv, const void* kv_len, int Dh, int causal,
    int window, int dtype, void* lse, void* stream) {
  using namespace rt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* kl = static_cast<const int*>(kv_len);
  float* ls = static_cast<float*>(lse);
  switch (dtype) {
    case F32:  // CUDA cores: exact float32 products
      return launch_flash_f32(q, q_sb, q_ss, q_sh, k, k_sb, k_ss, k_sh, v, v_sb, v_ss, v_sh,
                              out, o_sb, o_ss, o_sh, B, Hq, Hkv, Sq, Skv, kl, Dh, causal,
                              window, ls, s);
    case BF16:  // tensor cores
      return launch_flash_bf16(q, q_sb, q_ss, q_sh, k, k_sb, k_ss, k_sh, v, v_sb, v_ss, v_sh,
                               out, o_sb, o_ss, o_sh, B, Hq, Hkv, Sq, Skv, kl, Dh, causal,
                               window, ls, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// q/out: (B, Sq, Hq, Dh); arena k/v: (N, P, L, Hkv, Dh) sharing strides;
// slot_pos: (N, P, L); block_table: (B, n_log); pos: (B,).
extern "C" int rt_paged_extend_attention(
    const void* q, int64_t q_sb, int64_t q_ss, int64_t q_sh, int q_dtype,
    const void* k, const void* v, int kv_dtype,
    int64_t a_sn, int64_t a_sp, int64_t a_sl, int64_t a_sh,
    const void* slot_pos, int64_t sp_sn, int64_t sp_sp, int64_t sp_sl,
    const void* block_table, int64_t bt_sb, int n_log, const void* pos, int layer,
    const void* k_scale, const void* v_scale, int64_t sc_sn, int64_t sc_sl,
    void* out, int64_t o_sb, int64_t o_ss, int64_t o_sh,
    int B, int Hq, int Hkv, int Sq, int Dh, int N, int P, void* stream) {
  using namespace rt;
  const int* sp = static_cast<const int*>(slot_pos);
  const int* bt = static_cast<const int*>(block_table);
  const int* ps = static_cast<const int*>(pos);
  const float* ksc = static_cast<const float*>(k_scale);
  const float* vsc = static_cast<const float*>(v_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RT_EXTEND_F32(KT)                                                                   \
  return launch_paged_extend_f32<KT>(q, q_sb, q_ss, q_sh, k, v, a_sn, a_sp, a_sl, a_sh, sp, \
                                     sp_sn, sp_sp, sp_sl, bt, bt_sb, n_log, ps, layer, ksc,   \
                                     vsc, sc_sn, sc_sl, out, o_sb, o_ss, o_sh, B, Hq, Hkv,    \
                                     Sq, Dh, N, P, s)
#define RT_EXTEND_BF16(KT)                                                                 \
  return launch_paged_extend_tc<KT>(q, q_sb, q_ss, q_sh, k, v, a_sn, a_sp, a_sl, a_sh, sp, \
                                    sp_sn, sp_sp, sp_sl, bt, bt_sb, n_log, ps, layer, ksc,   \
                                    vsc, sc_sn, sc_sl, out, o_sb, o_ss, o_sh, B, Hq, Hkv,    \
                                    Sq, Dh, N, P, s)
  const bool quant = kv_dtype == I8;
  if (!quant && kv_dtype != q_dtype) return cudaErrorInvalidValue;
  switch (q_dtype) {
    case F32:  // CUDA cores: exact float32 products
      if (quant) RT_EXTEND_F32(int8_t);
      RT_EXTEND_F32(float);
    case BF16:  // tensor cores, over a bf16 or an int8 arena
      if (quant) RT_EXTEND_BF16(int8_t);
      RT_EXTEND_BF16(bf16);
    default:
      return cudaErrorInvalidValue;
  }
#undef RT_EXTEND_BF16
#undef RT_EXTEND_F32
}
