// Decode attention for Hopper (sm_90a): one kernel over dense per-slot
// caches and paged arenas.
//
// decode_split_kernel<..., DenseKeys> replaces the TPU kernel
// src/repro/kernels/decode_attention/decode_attention.py::_decode_kernel
// (wrapper decode_attention_bhd).  One decode query per row and q head
// attends to the row's dense (S, Hkv, Dh) cache.  A slot counts iff its
// position p (slot_pos[b, s], or s without a slot_pos plane) has lo < p <
// kv_len[b], where lo = kv_len[b]-1-window with a window and -1 without:
// the masks of repro/models/layers.py::decode_attention_ref, which serves
// rolling sliding-window buffers (the Pallas kernel had neither).  Without
// slot_pos the key walk covers only the live slots [max(lo+1, 0),
// min(S, kv_len)), as the Pallas kernel skipped blocks past kv_len; a
// rolling buffer's valid slots lie anywhere, so with slot_pos it walks all
// S slots.  Any S is taken: the last key tile is ragged and never read
// past S (the Pallas wrapper asserted S % block_k == 0).
//
// decode_split_kernel<..., PagedKeys> replaces the TPU kernel
// src/repro/kernels/decode_attention/decode_attention.py::
// _paged_decode_kernel (wrapper paged_decode_attention_bhd).  One decode
// query per row and q head attends to the row's pages of a (N, P, L, Hkv,
// Dh) arena through a (B, n_log) block table.  A slot counts iff 0 <=
// slot_pos < kv_len[b]; sentinel pages (id < 0 or >= N) and pages that
// start at or past kv_len are never read; int8 arenas dequantise with
// per-(page, layer) scales.
//
// What bounds both on the H100: the K and V bytes streamed from device
// memory, B * kv_len * Hkv * Dh * 2 * bytes per layer; the arithmetic is
// 4 * G flops per K/V element pair, far below the card's ridge point.  At
// the serving shapes those bytes are few (B8 kv_len 87..129, Hkv 8, Dh 128:
// about 4 MB, 0.0012 ms at 3.35 TB/s), so what bounds the call is latency:
// the dependent round trips to device memory and the work a block does
// after its last byte lands.
//
// The design (flash-decoding, merged on chip): the blocks of one (row, kv
// head) form a thread-block cluster of n_split <= 8 (the portable size),
// each walking a contiguous range of the row's keys.  A key source gives
// the range and the copies: PagedKeys splits the logical pages [0, n_log)
// evenly and finds key k at slot k % P of page bt[k / P] (the split's
// block-table entries in shared memory); DenseKeys reads slot s of row b
// at b * c_sb + s * c_ss + h * c_sh with no block table and splits the
// live slots above (all S slots with a slot_pos plane) evenly, so that on
// the dense route every split gets keys.  The host picks n_split from the
// shapes, the block count and the SM count alone (ops.decode_splits: the
// smallest power of two that gives two blocks per SM, capped by 8 and by
// n_log pages or S slots), so no device value is read back.  A block reads
// kv_len (and its block-table entries) in one round trip, then issues
// every key of its range into a shared-memory tile at once (16-byte
// cp.async, or 8 or 4 bytes, or element by element, where the head dim or
// the strides need it), bf16, float32 or int8 as stored, with its slot
// positions and scales beside them; a ring of two tiles of up to 8 KB of K
// streams longer ranges (small tiles leave room for more blocks on an SM,
// which is what the long ranges need).  Q of the block's G heads sits in
// registers, each lane holding kE consecutive elements of the head dim.
// Each warp takes a quarter of a tile's keys, 8 at a time (4 at G 8), and
// computes each lane's part of q . k for all 32 (key, head) pairs (8 at
// G 1); one halving reduction across the lanes (31 shuffles for 32 pairs)
// leaves each lane with one pair's score, the online softmax runs once
// per pair in its lane, and shuffles hand every lane the heads'
// corrections and the pairs' p for its part of P V.  All in float32 on
// CUDA cores (float32 stays exact float32 for the card-vs-CPU parity),
// with the softmax state and the output accumulator in registers.  The warps
// merge in shared memory into the block's (m, l, acc); after
// cluster.sync(), block rank 0 reads the other blocks' partials through
// distributed shared memory, merges them with ops.lse_combine's weights
// and writes the output.  One launch per call, no workspace, nothing read
// back.  A split with nothing to do still reaches both cluster barriers
// and adds m = -1e30, l = 0, acc = 0, which weighs 0; a row with no valid
// key anywhere finishes as 0 / max(0, 1e-30) = 0.
#include <cooperative_groups.h>

#include <algorithm>
#include <type_traits>

#include "tensor_core.cuh"
#include "tile_attention.cuh"

namespace rt {

// ---- the key walk split across the blocks of a cluster ----

constexpr int kDecodeStages = 2;         // key tiles in the cp.async ring
constexpr int kDecodeTileBytes = 8192;   // K bytes of a tile, at most
constexpr int kDecodeWarps = kThreads / 32;

template <typename T> struct Vec;  // kE elements of T read from shared memory as one load
template <> struct Vec<float> {
  template <int kE> __device__ static void load(const float* p, float (&x)[kE]) {
    if constexpr (kE == 2) {
      const float2 a = *reinterpret_cast<const float2*>(p);
      x[0] = a.x; x[1] = a.y;
    } else {
#pragma unroll
      for (int i = 0; i < kE; i += 4) {
        const float4 a = *reinterpret_cast<const float4*>(p + i);
        x[i] = a.x; x[i + 1] = a.y; x[i + 2] = a.z; x[i + 3] = a.w;
      }
    }
  }
};
template <> struct Vec<__nv_bfloat16> {
  template <int kE> __device__ static void load(const __nv_bfloat16* p, float (&x)[kE]) {
#pragma unroll
    for (int i = 0; i < kE; i += 2) {
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + i));
      x[i] = a.x; x[i + 1] = a.y;
    }
  }
};
template <> struct Vec<int8_t> {
  template <int kE> __device__ static void load(const int8_t* p, float (&x)[kE]) {
#pragma unroll
    for (int i = 0; i < kE; i += 2) {
      const char2 a = *reinterpret_cast<const char2*>(p + i);
      x[i] = static_cast<float>(a.x); x[i + 1] = static_cast<float>(a.y);
    }
  }
};

// ---- key sources ----
//
// A key source names the keys of one (row b, kv head h) and the range of
// them that split `split` of `n_split` walks.  The source itself holds the
// call's arguments and is never written; what a block derives from it is
// a Split.  stage() runs in the first round trip (beside the kv_len read;
// the paged source copies its block-table entries into `ents`, shared
// memory), plan() once kv_len is known and returns the split's key count;
// offset() is the element offset of key i of the split in the K and V
// tensors, or -1 when it is not read, and position() writes its position
// (cp.async or a plain store), with the int8 scales beside it.  Masked
// keys get position -1.  kWindowed: whether the kernel applies the window
// (dense only).

// Keys of a paged arena: logical pages [split * n_log / n_split, (split +
// 1) * n_log / n_split) of the row; key i of the split is slot i % P of
// the split's page i / P.
struct PagedKeys {
  const int* block_table;
  int64_t bt_sb;
  int n_log, N, P, layer;
  int64_t a_sn, a_sp, a_sl, a_sh;
  const int* slot_pos;
  int64_t sp_sn, sp_sp, sp_sl;
  const float *k_scale, *v_scale;
  int64_t sc_sn, sc_sl;
  struct Split {
    int lo, hi;    // the split's logical pages
    int64_t base;  // layer and head offset of a page row
  };
  __host__ __device__ int max_keys(int n) const { return (n_log + n - 1) / n * P; }
  __host__ __device__ int smem_ints(int n) const { return ((n_log + n - 1) / n + 3) & ~3; }
  __host__ uint64_t stride_bits() const { return (uint64_t)(a_sn | a_sp | a_sl | a_sh); }
  static constexpr bool kWindowed = false;
  __device__ Split stage(int b, int h, int split, int n_split, int* ents, int tid) const {
    // 32-bit divisions: a 64-bit one is a subroutine call, whose saved
    // registers spill
    Split sp;
    sp.lo = split * n_log / n_split;
    sp.hi = (split + 1) * n_log / n_split;
    for (int j = sp.lo + tid; j < sp.hi; j += kThreads)
      ents[j - sp.lo] = block_table[b * bt_sb + j];
    sp.base = layer * a_sl + h * a_sh;
    return sp;
  }
  // pages that start at or past kv_len are never read; no window
  __device__ int plan(Split& sp, int len, int) const {
    const int live_hi = min(sp.hi, len > 0 ? (len + P - 1) / P : 0);
    return max(0, live_hi - sp.lo) * P;
  }
  __device__ int64_t offset(const Split& sp, const int* ents, int i) const {
    const int j = i / P, slot = i - j * P;  // the split's pages start on a page
    const int page = ents[j];
    if (page < 0 || page >= N) return -1;  // unmapped: never read
    return page * a_sn + slot * a_sp + sp.base;
  }
  template <bool kQuant>
  __device__ void position(const Split&, const int* ents, int i, int* dst, float* ks,
                           float* vs) const {
    const int j = i / P, slot = i - j * P;
    const int page = ents[j];
    if (page < 0 || page >= N) {
      *dst = -1;  // masked, K/V never read
      return;
    }
    cp_async_ca<4>(dst, slot_pos + page * sp_sn + slot * sp_sp + layer * sp_sl);
    if (kQuant) {
      cp_async_ca<4>(ks, k_scale + page * sc_sn + layer * sc_sl);
      cp_async_ca<4>(vs, v_scale + page * sc_sn + layer * sc_sl);
    }
  }
};

// Keys of a dense (B, S, Hkv, Dh) cache: slot s of row b at b * c_sb + s *
// c_ss + h * c_sh, no block table.  Without a slot_pos plane slot s holds
// position s and the splits share the live slots [max(lo + 1, 0), min(S,
// kv_len)) evenly (ops.dense_live_range); with one (a rolling buffer) they
// share all S slots and the mask reads each slot's position.
struct DenseKeys {
  int64_t c_sb, c_ss, c_sh;
  const int* slot_pos;
  int64_t sp_sb, sp_ss;
  int S;
  struct Split {
    int split, n_split;
    int s0;           // the split's first slot
    int64_t base;     // row and head offset of slot 0
    int64_t sp_base;  // row offset of the slot_pos plane
  };
  __host__ __device__ int max_keys(int n_split) const { return (S + n_split - 1) / n_split; }
  __host__ __device__ int smem_ints(int) const { return 0; }
  __host__ uint64_t stride_bits() const { return (uint64_t)(c_sb | c_ss | c_sh); }
  static constexpr bool kWindowed = true;
  __device__ Split stage(int b, int h, int split, int n_split, int*, int) const {
    return Split{split, n_split, 0, b * c_sb + h * c_sh, b * sp_sb};
  }
  __device__ int plan(Split& sp, int len, int lo) const {
    const int begin = slot_pos != nullptr ? 0 : max(lo + 1, 0);
    const int end = slot_pos != nullptr ? S : min(S, len);
    const int n = max(end - begin, 0);
    sp.s0 = begin + sp.split * n / sp.n_split;
    return begin + (sp.split + 1) * n / sp.n_split - sp.s0;
  }
  __device__ int64_t offset(const Split& sp, const int*, int i) const {
    return sp.base + (int64_t)(sp.s0 + i) * c_ss;
  }
  template <bool kQuant>
  __device__ void position(const Split& sp, const int*, int i, int* dst, float*, float*) const {
    if (slot_pos != nullptr) cp_async_ca<4>(dst, slot_pos + sp.sp_base + (sp.s0 + i) * sp_ss);
    else *dst = sp.s0 + i;
  }
};

// Block of a decode call: split s = blockIdx.x (its rank in the cluster
// of n_split = gridDim.x blocks) of row b = blockIdx.z, kv head blockIdx.y
// / n_hc, q heads g0 .. g0 + kG - 1 of that group (g0 = kG * (blockIdx.y %
// n_hc); n_hc > 1 only when G > 8).  The split walks the keys that its key
// source gives it, in tiles of kt keys.  Each lane holds kE consecutive
// elements of the head dim (lane * kE ..); warp w takes keys [w * kt / 4,
// (w + 1) * kt / 4) of a tile, kB at a time, and keeps its own online
// softmax (m, l, acc) in registers, in log2 units.  window < 0: no window.
template <typename QT, typename KT, int kG, int kE, typename Keys>
__global__ void __launch_bounds__(kThreads) decode_split_kernel(
    const QT* __restrict__ q, int64_t q_sb, int64_t q_sh,
    const KT* __restrict__ k, const KT* __restrict__ v, const Keys src,
    const int* __restrict__ kv_len, int window,
    QT* __restrict__ out, int64_t o_sb, int64_t o_sh,
    int G, int Dh, int n_hc, int kt, int ld, int vb, size_t area_bytes, float scale_log2) {
  constexpr int kDh = 32 * kE;                        // head dims a warp covers
  // keys a warp takes per step, and the (key, head) pairs of a step: 8 or
  // 32, so that a step's scores reduce across the warp by halving
  constexpr int kB = kG == 8 ? 4 : 8;
  constexpr int kN = kB * kG;
  constexpr int kLogN = kN == 32 ? 5 : 3;
  constexpr int kShift = 5 - kLogN;       // lane >> kShift: the lane's pair
  constexpr int kLogG = kG == 8 ? 3 : (kG == 4 ? 2 : 0);
  static_assert(kG == 1 || kG == 4 || kG == 8, "kG is 1, 4 or 8");
  constexpr int kPart = 2 * kG + kG * kDh;            // floats of one (m, l, acc)
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_split = gridDim.x, split = blockIdx.x;
  const int h = blockIdx.y / n_hc, g0 = (blockIdx.y - h * n_hc) * kG, b = blockIdx.z;
  const int gb = min(kG, G - g0);                     // heads of this block
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // shared memory: the K/V ring (reused by the warps' partials at the
  // end), slot positions and scales of each tile, the key source's
  // entries (the split's block table), the block's partial (read by rank
  // 0 through distributed shared memory) and rank 0's merge weights
  KT* ring = reinterpret_cast<KT*>(smem_raw);         // [stage][K, V][kt][ld]
  float* ws = reinterpret_cast<float*>(smem_raw);     // [warp][kPart], after the walk
  int* sps = reinterpret_cast<int*>(smem_raw + area_bytes);  // [stage][kt]
  float* kss = reinterpret_cast<float*>(sps + kDecodeStages * kt);  // [stage][kt]
  float* vss = kss + kDecodeStages * kt;              // [stage][kt]
  int* ents = reinterpret_cast<int*>(vss + kDecodeStages * kt);     // [smem_ints]
  float* part = reinterpret_cast<float*>(ents + src.smem_ints(n_split));
  float* wts = part + kPart;                          // [8][kG]

  // round trip 1: kv_len, the key source's entries and q
  const int len = kv_len[b];
  typename Keys::Split range = src.stage(b, h, split, n_split, ents, tid);
  const bool lane_on = lane * kE < Dh;
  float qf[kG][kE];
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int d = lane * kE + e;
      qf[g][e] = g < gb && d < Dh
                     ? to_f(q[b * q_sb + (int64_t)(h * G + g0 + g) * q_sh + d]) * scale_log2
                     : 0.f;
    }
  // the pad columns [Dh, ld) of every ring row stay zero: copies never
  // write them and the lanes that read them multiply by q = 0
  const int n_stage = min(kDecodeStages, (src.max_keys(n_split) + kt - 1) / kt);  // as decode_plan
  const int pad = (ld - Dh) * static_cast<int>(sizeof(KT));
  if (pad > 0) {
    unsigned char* rows = smem_raw + Dh * sizeof(KT);
    for (int i = tid; i < n_stage * 2 * kt * pad; i += kThreads) {
      const int r = i / pad;
      rows[(size_t)r * ld * sizeof(KT) + (i - r * pad)] = 0;
    }
  }
  // positions must be > lo: kv_len - 1 - window with a window, else -1
  // (always on a paged key source, which takes no window)
  const int lo = Keys::kWindowed && window >= 0 ? max(len - 1 - window, -1) : -1;
  __syncthreads();

  const int n_keys = src.plan(range, len, lo);
  const int n_tiles = (n_keys + kt - 1) / kt;
  const int esize = sizeof(KT);
  const int cpr = vb ? Dh * esize / vb : Dh;          // copies per row

  // round trip 2: a tile's K and V rows, slot positions and scales
  auto load_tile = [&](int t, int stage) {
    KT* kd = ring + (stage * 2) * kt * ld;
    KT* vd = kd + kt * ld;
    for (int c = tid; c < kt * cpr; c += kThreads) {
      const int r = c / cpr, part_i = c - r * cpr;
      const int key = t * kt + r;
      if (key >= n_keys) continue;
      const int64_t off = src.offset(range, ents, key);
      if (off < 0) continue;
      if (vb == 16) {
        const int d = part_i * (16 / esize);
        cp_async_ca<16>(kd + r * ld + d, k + off + d);
        cp_async_ca<16>(vd + r * ld + d, v + off + d);
      } else if (vb == 8) {
        const int d = part_i * (8 / esize);
        cp_async_ca<8>(kd + r * ld + d, k + off + d);
        cp_async_ca<8>(vd + r * ld + d, v + off + d);
      } else if (vb == 4) {
        const int d = part_i * (4 / esize);
        cp_async_ca<4>(kd + r * ld + d, k + off + d);
        cp_async_ca<4>(vd + r * ld + d, v + off + d);
      } else {                                           // element by element
        kd[r * ld + part_i] = k[off + part_i];
        vd[r * ld + part_i] = v[off + part_i];
      }
    }
    if (tid < kt) {
      const int key = t * kt + tid;
      int* dst = sps + stage * kt + tid;
      if (key < n_keys) {
        src.template position<kQuant>(range, ents, key, dst, kss + stage * kt + tid,
                                      vss + stage * kt + tid);
      } else {
        *dst = -1;                                       // past the split's keys
      }
    }
  };

  // Each lane holds the output accumulator of its kE head dims for all
  // kG heads, and the softmax state (m, l) of head jm % kG, where jm =
  // lane >> kShift is the (key, head) pair whose score the lane ends with
  // after a step's reduction; lanes of one head hold equal (m, l).
  const int jm = lane >> kShift, im = jm / kG;
  float m_mine = kNegInit, l_mine = 0.f, acc[kG][kE];
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[g][e] = 0.f;

  // prologue: tiles 0 .. kDecodeStages - 2 in flight, one commit group each
#pragma unroll
  for (int st = 0; st < kDecodeStages - 1; ++st) {
    if (st < n_tiles) load_tile(st, st);
    cp_async_commit();
  }
  const int per_warp = kt / kDecodeWarps;
  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t % kDecodeStages;
    cp_async_wait<kDecodeStages - 2>();  // tile t landed
    __syncthreads();     // ... for every thread; tile t - 1 is consumed
    const int nxt = t + kDecodeStages - 1;  // into tile t - 1's stage
    if (nxt < n_tiles) load_tile(nxt, nxt % kDecodeStages);
    cp_async_commit();
    const KT* kt_s = ring + (stage * 2) * kt * ld;
    const KT* vt_s = kt_s + kt * ld;
    const int* sp_t = sps + stage * kt;
    const int r_end = (warp + 1) * per_warp;
    for (int r0 = warp * per_warp; r0 < r_end; r0 += kB) {
      unsigned vmask = 0;                                // keys that count
#pragma unroll
      for (int i = 0; i < kB; ++i) {
        const int spv = r0 + i < r_end ? sp_t[r0 + i] : -1;
        vmask |= (spv > lo && spv < len ? 1u : 0u) << i;
      }
      if (!vmask) continue;                              // warp-uniform
      // this lane's part of q . k for every (key i, head g): x[i * kG + g]
      float x[kN];
#pragma unroll
      for (int i = 0; i < kB; ++i) {
        float kx[kE];
#pragma unroll
        for (int e = 0; e < kE; ++e) kx[e] = 0.f;
        if ((vmask >> i & 1) && lane_on)
          Vec<KT>::template load<kE>(kt_s + (r0 + i) * ld + lane * kE, kx);
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          float acc_s = 0.f;
#pragma unroll
          for (int e = 0; e < kE; ++e) acc_s = fmaf(qf[g][e], kx[e], acc_s);
          x[i * kG + g] = acc_s;
        }
      }
      // sum over the warp by halving (halve_sum), then full xor steps
      halve_sum<kN, kN, 16>(x, lane);
#pragma unroll
      for (int o = 16 >> kLogN; o > 0; o >>= 1) x[0] += __shfl_xor_sync(0xffffffffu, x[0], o);
      // online softmax of head jm % kG over its kB keys, one score a lane
      const bool vm = vmask >> im & 1;
      const float ksc = kQuant && vm ? kss[stage * kt + r0 + im] : 1.f;
      const float vsc = kQuant && vm ? vss[stage * kt + r0 + im] : 1.f;
      const float sc = vm ? x[0] * ksc : -INFINITY;
      float mx = sc;
#pragma unroll
      for (int o = 16; o >= (1 << (kShift + kLogG)); o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_mine, mx);             // finite: m starts at -1e30
      const float corr = exp2f(m_mine - m_new);
      const float p = exp2f(sc - m_new);                 // masked: 0
      float sum = p;
#pragma unroll
      for (int o = 16; o >= (1 << (kShift + kLogG)); o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l_mine = l_mine * corr + sum;
      m_mine = m_new;
      // every lane takes each head's correction, then each pair's p * v_scale
      const float pv = p * vsc;
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const float cg = __shfl_sync(0xffffffffu, corr, g << kShift);
#pragma unroll
        for (int e = 0; e < kE; ++e) acc[g][e] *= cg;
      }
#pragma unroll
      for (int i = 0; i < kB; ++i) {
        float pb[kG];                                    // every lane takes part
#pragma unroll
        for (int g = 0; g < kG; ++g) pb[g] = __shfl_sync(0xffffffffu, pv, (i * kG + g) << kShift);
        if (!(vmask >> i & 1) || !lane_on) continue;
        float vx[kE];
        Vec<KT>::template load<kE>(vt_s + (r0 + i) * ld + lane * kE, vx);
#pragma unroll
        for (int g = 0; g < kG; ++g)
#pragma unroll
          for (int e = 0; e < kE; ++e) acc[g][e] = fmaf(pb[g], vx[e], acc[g][e]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it takes the warps' partials

  float* wp = ws + warp * kPart;
  if (im == 0) {                                         // lanes of pairs (0, g)
    wp[jm] = m_mine;
    wp[kG + jm] = l_mine;
  }
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int e = 0; e < kE; ++e) wp[2 * kG + g * kDh + lane * kE + e] = acc[g][e];
  __syncthreads();

  // the block's partial: the warps merged with the LSE weights; an empty
  // warp (m = -1e30, l = 0, acc = 0) adds 0
  for (int i = tid; i < kG * kDh; i += kThreads) {
    const int g = i / kDh;
    float mx = kNegInit;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) mx = fmaxf(mx, ws[w * kPart + g]);
    float a = 0.f, sum = 0.f;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) {
      const float c = exp2f(ws[w * kPart + g] - mx);
      a = fmaf(c, ws[w * kPart + 2 * kG + i], a);
      sum = fmaf(c, ws[w * kPart + kG + g], sum);
    }
    part[2 * kG + i] = a;
    if (i - g * kDh == 0) {
      part[g] = mx;
      part[kG + g] = sum;
    }
  }

  // every split's partial is ready; rank 0 merges them (ops.lse_combine's
  // arithmetic, in log2 units) and writes the output.  An empty split
  // (m = -1e30, l = 0, acc = 0) weighs 0, and if every split is empty the
  // output is 0 / max(0, 1e-30) = 0.
  cluster.sync();
  if (split == 0) {
    if (tid < gb) {
      const int g = tid;
      float mx = kNegInit;
      for (int r = 0; r < n_split; ++r) mx = fmaxf(mx, cluster.map_shared_rank(part, r)[g]);
      float sum = 0.f;
      for (int r = 0; r < n_split; ++r) {
        const float* rp = cluster.map_shared_rank(part, r);
        const float c = exp2f(rp[g] - mx);
        wts[r * kG + g] = c;
        sum = fmaf(c, rp[kG + g], sum);
      }
      const float inv = 1.f / fmaxf(sum, 1e-30f);
      for (int r = 0; r < n_split; ++r) wts[r * kG + g] *= inv;
    }
    __syncthreads();
    for (int i = tid; i < gb * Dh; i += kThreads) {
      const int g = i / Dh, d = i - g * Dh;
      float a = 0.f;
      for (int r = 0; r < n_split; ++r)
        a = fmaf(wts[r * kG + g], cluster.map_shared_rank(part, r)[2 * kG + g * kDh + d], a);
      out[b * o_sb + (int64_t)(h * G + g0 + g) * o_sh + d] = from_f<QT>(a);
    }
  }
  cluster.sync();  // no block leaves while rank 0 reads its shared memory
}

// Host-side plan of one decode launch: keys per tile, shared-memory row
// stride and copy width, the bytes of the ring and of the whole block.
struct DecodePlan {
  int kt, ld, vb;
  size_t area, smem;
};

template <typename Keys>
inline DecodePlan decode_plan(const Keys& src, int esize, int Dh, int n_split, int kG, int kE,
                              const void* k, const void* v) {
  DecodePlan pl;
  pl.ld = (Dh + 15) / 16 * 16;
  // copy width: the widest of 16, 8, 4 bytes that every row start and the
  // row length are multiples of; else element by element
  const uint64_t align = (uint64_t)Dh * esize | src.stride_bits() * esize |
                         reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v);
  pl.vb = align % 16 == 0 ? 16 : align % 8 == 0 ? 8 : align % 4 == 0 ? 4 : 0;
  // a tile holds the split's keys, up to 8 KB of K (and as much V), 16
  // keys at least; one stage if a tile holds them all
  const int max_keys = src.max_keys(n_split);
  const int want = (max_keys + 15) / 16 * 16;
  int kt = 16;
  while (kt < want && kt < 128 && (size_t)2 * kt * pl.ld * esize <= kDecodeTileBytes) kt *= 2;
  pl.kt = kt;
  const int stages = std::min(kDecodeStages, (max_keys + kt - 1) / kt);
  const size_t ring = (size_t)stages * 2 * kt * pl.ld * esize;
  const size_t part = sizeof(float) * (2 * kG + kG * 32 * kE);
  pl.area = (std::max(ring, kDecodeWarps * part) + 15) / 16 * 16;
  pl.smem = pl.area + sizeof(int) * 3 * kDecodeStages * kt + sizeof(int) * src.smem_ints(n_split) +
            part + sizeof(float) * 8 * kG;
  return pl;
}

template <typename QT, typename KT, int kG, int kE, typename Keys>
cudaError_t launch_decode_split(const void* q, int64_t q_sb, int64_t q_sh, const void* k,
                                const void* v, const Keys& src, const int* kv_len, int window,
                                void* out, int64_t o_sb, int64_t o_sh, int B, int Hkv, int G,
                                int Dh, int n_split, cudaStream_t stream) {
  const DecodePlan pl = decode_plan(src, sizeof(KT), Dh, n_split, kG, kE, k, v);
  auto kernel = decode_split_kernel<QT, KT, kG, kE, Keys>;
  cudaError_t err = cudaSuccess;
  const int n_hc = (G + kG - 1) / kG;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, Hkv * n_hc, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // can a cluster of n_split such blocks be resident at all?  Asked once
  // per instantiation, cluster size and larger shared-memory size
  static size_t checked[9] = {0};
  if (pl.smem > checked[n_split]) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    checked[n_split] = pl.smem;
  }
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const QT*>(q), q_sb, q_sh,
                            static_cast<const KT*>(k), static_cast<const KT*>(v), src, kv_len,
                            window, static_cast<QT*>(out), o_sb, o_sh, G, Dh, n_hc, pl.kt, pl.ld,
                            pl.vb, pl.area, rsqrtf(static_cast<float>(Dh)) * 1.4426950408889634f);
}

// q heads per block (kG) and head-dim elements per lane (kE) by G and Dh
template <typename QT, typename KT, typename Keys>
cudaError_t launch_decode(const void* q, int64_t q_sb, int64_t q_sh, const void* k,
                          const void* v, const Keys& src, const int* kv_len, int window,
                          void* out, int64_t o_sb, int64_t o_sh, int B, int Hkv, int G, int Dh,
                          int n_split, cudaStream_t stream) {
  if (Dh > 256 || n_split < 1 || n_split > 8) return cudaErrorInvalidValue;
#define RT_DECODE_SPLIT(KG, KE)                                                              \
  return launch_decode_split<QT, KT, KG, KE, Keys>(q, q_sb, q_sh, k, v, src, kv_len, window, \
                                                   out, o_sb, o_sh, B, Hkv, G, Dh, n_split,  \
                                                   stream)
#define RT_DECODE_KE(KG)                      \
  {                                           \
    if (Dh <= 64) RT_DECODE_SPLIT(KG, 2);     \
    if (Dh <= 128) RT_DECODE_SPLIT(KG, 4);    \
    RT_DECODE_SPLIT(KG, 8);                   \
  }
  if (G == 1) RT_DECODE_KE(1);
  if (G <= 4) RT_DECODE_KE(4);
  RT_DECODE_KE(8);
#undef RT_DECODE_KE
#undef RT_DECODE_SPLIT
}

// every (kG, kE) instantiation of one dtype pair and key source
template <typename QT, typename KT, typename Keys>
cudaError_t prepare_decode() {
#define RT_DECODE_KERNELS(KG)                                \
  (const void*)decode_split_kernel<QT, KT, KG, 2, Keys>,     \
      (const void*)decode_split_kernel<QT, KT, KG, 4, Keys>, \
      (const void*)decode_split_kernel<QT, KT, KG, 8, Keys>
  return prepare_kernels({RT_DECODE_KERNELS(1), RT_DECODE_KERNELS(4), RT_DECODE_KERNELS(8)});
#undef RT_DECODE_KERNELS
}

}  // namespace rt

// Once per process, when the library is bound: every decode instantiation
// (prepare_kernels).
extern "C" int rt_prepare_decode() {
  using namespace rt;
  cudaError_t err = prepare_decode<float, float, DenseKeys>();
  if (err == cudaSuccess) err = prepare_decode<__nv_bfloat16, __nv_bfloat16, DenseKeys>();
  if (err == cudaSuccess) err = prepare_decode<float, float, PagedKeys>();
  if (err == cudaSuccess) err = prepare_decode<float, int8_t, PagedKeys>();
  if (err == cudaSuccess) err = prepare_decode<__nv_bfloat16, __nv_bfloat16, PagedKeys>();
  if (err == cudaSuccess) err = prepare_decode<__nv_bfloat16, int8_t, PagedKeys>();
  return err;
}

// Plain C entry points bound with ctypes; each returns cudaGetLastError() of
// its launch.  q/out: (B, Hq, Dh) views given by their batch and head
// strides; Dh <= 256; n_split (1..8): the blocks, one cluster, that split a
// row's keys (ops.decode_splits).
//
// Dense: k/v caches (B, S, Hkv, Dh) share the strides (c_sb, c_ss, c_sh) and
// have a contiguous last dim; slot_pos is a (B, S) int32 plane or null;
// window < 0 means no window.
extern "C" int rt_dense_decode_attention(
    const void* q, int64_t q_sb, int64_t q_sh, int dtype,
    const void* k, const void* v, int64_t c_sb, int64_t c_ss, int64_t c_sh,
    const void* slot_pos, int64_t sp_sb, int64_t sp_ss, const void* kv_len, int window,
    void* out, int64_t o_sb, int64_t o_sh,
    int B, int Hkv, int G, int Dh, int S, int n_split, void* stream) {
  using namespace rt;
  const DenseKeys src = {c_sb, c_ss, c_sh, static_cast<const int*>(slot_pos), sp_sb, sp_ss, S};
  const int* kl = static_cast<const int*>(kv_len);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32:
      return launch_decode<float, float>(q, q_sb, q_sh, k, v, src, kl, window, out, o_sb, o_sh,
                                         B, Hkv, G, Dh, n_split, s);
    case BF16:
      return launch_decode<__nv_bfloat16, __nv_bfloat16>(q, q_sb, q_sh, k, v, src, kl, window,
                                                         out, o_sb, o_sh, B, Hkv, G, Dh,
                                                         n_split, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Paged: arena k/v share strides (N, P, L, Hkv) and have a contiguous last
// dim.
extern "C" int rt_paged_decode_attention(
    const void* q, int64_t q_sb, int64_t q_sh, int q_dtype,
    const void* k, const void* v, int kv_dtype,
    int64_t a_sn, int64_t a_sp, int64_t a_sl, int64_t a_sh,
    const void* slot_pos, int64_t sp_sn, int64_t sp_sp, int64_t sp_sl,
    const void* block_table, int64_t bt_sb, int n_log, const void* kv_len, int layer,
    const void* k_scale, const void* v_scale, int64_t sc_sn, int64_t sc_sl,
    void* out, int64_t o_sb, int64_t o_sh,
    int B, int Hkv, int G, int Dh, int N, int P, int n_split, void* stream) {
  using namespace rt;
  const PagedKeys src = {static_cast<const int*>(block_table), bt_sb, n_log, N, P, layer,
                         a_sn, a_sp, a_sl, a_sh, static_cast<const int*>(slot_pos), sp_sn, sp_sp,
                         sp_sl, static_cast<const float*>(k_scale),
                         static_cast<const float*>(v_scale), sc_sn, sc_sl};
  const int* kl = static_cast<const int*>(kv_len);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RT_DECODE(QT, KT)                                                                  \
  return launch_decode<QT, KT>(q, q_sb, q_sh, k, v, src, kl, -1, out, o_sb, o_sh, B, Hkv, G, \
                               Dh, n_split, s)
  const bool quant = kv_dtype == I8;
  if (!quant && kv_dtype != q_dtype) return cudaErrorInvalidValue;
  switch (q_dtype) {
    case F32:
      if (quant) RT_DECODE(float, int8_t);
      RT_DECODE(float, float);
    case BF16:
      if (quant) RT_DECODE(__nv_bfloat16, int8_t);
      RT_DECODE(__nv_bfloat16, __nv_bfloat16);
    default:
      return cudaErrorInvalidValue;
  }
#undef RT_DECODE
}
