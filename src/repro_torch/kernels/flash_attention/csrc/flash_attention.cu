// Prefill flash attention and paged extend attention for Hopper (sm_90a).
//
// rt_flash_attention replaces the TPU kernel src/repro/kernels/
// flash_attention/flash_attention.py::_flash_kernel (wrapper
// flash_attention_bhsd): tiled causal or bidirectional attention with GQA
// (q head h reads kv head h / G), q positions offset by Skv - Sq, an
// optional sliding window, and the online softmax in float32.
//   Bound on the H100: at long prefill buckets the QK^T and PV products,
//   4 * B * Hq * Sq * Skv * Dh flops (about half of it under the causal
//   mask); at short buckets the K/V bytes.
//   Design: one block per (row, q head, tile of 64 q positions) loops over
//   32-key tiles up to the causal limit, skipping tiles wholly outside the
//   window.  Any Sq is accepted: the ragged last q tile and kv tile are
//   masked inside the block (the TPU wrapper required Sq % block_q == 0).
//   The products run on CUDA cores out of shared memory; moving them onto
//   the tensor cores (wgmma) is the next step for long buckets.
//
// rt_paged_extend_attention replaces flash_attention.py::
// _paged_extend_kernel (wrapper paged_extend_attention_bhsd): the Sq suffix
// queries of row b sit at absolute positions pos[b] + i and attend to the
// row's block-table pages of a (N, P, L, Hkv, Dh) arena.  A slot counts iff
// 0 <= slot_pos <= q_pos; sentinel pages and pages past the tile's newest
// query position are skipped; int8 arenas dequantise per (page, layer).
//   Bound on the H100: the K/V page bytes streamed, as for paged decode.
//   Design: one block per (row, q head, tile of 32 suffix positions) walks
//   the row's pages in order with one page as the key tile.  Each of the G
//   q heads of a group re-reads the group's pages (mostly from L2);
//   sharing one page read across the group is the next step.
#include "tile_attention.cuh"

namespace rt {

constexpr int kFlashQ = 64;   // q positions per prefill block
constexpr int kFlashK = 32;   // key positions per prefill kv tile
constexpr int kExtendQ = 32;  // suffix positions per extend block

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_kernel(
    const T* __restrict__ q, int64_t q_sb, int64_t q_ss, int64_t q_sh,
    const T* __restrict__ k, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    const T* __restrict__ v, int64_t v_sb, int64_t v_ss, int64_t v_sh,
    T* __restrict__ out, int64_t o_sb, int64_t o_ss, int64_t o_sh,
    int Sq, int Skv, int G, int Dh, int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int i0 = blockIdx.x * kFlashQ, hq = blockIdx.y, b = blockIdx.z;
  const int hkv = hq / G;
  const int nr = min(kFlashQ, Sq - i0);
  const int q_lo = Skv - Sq + i0;           // absolute position of row 0
  const int q_hi = q_lo + nr - 1;
  Tile t = carve_tile(smem, kFlashQ, kFlashK, Dh);

  load_rows(t.q, q + b * q_sb + i0 * q_ss + hq * q_sh, q_ss, 1.f, (float*)nullptr,
            (const T*)nullptr, 0, 0.f, t.ld, nr, nr, Dh);
  tile_init(t, nr);
  __syncthreads();

  const int n_tiles = (Skv + kFlashK - 1) / kFlashK;
  const int end = causal ? min(n_tiles, q_hi / kFlashK + 1) : n_tiles;
  const T* kb = k + b * k_sb + hkv * k_sh;
  const T* vb = v + b * v_sb + hkv * v_sh;
  for (int kt = 0; kt < end; ++kt) {
    const int k0 = kt * kFlashK;
    const int nc = min(kFlashK, Skv - k0);
    // every key of the tile is older than the window of the oldest row
    if (window >= 0 && k0 + nc - 1 <= q_lo - window) continue;
    load_rows(t.k, kb + k0 * k_ss, k_ss, 1.f, t.v, vb + k0 * v_ss, v_ss, 1.f, t.ld,
              nc, nc, Dh);
    __syncthreads();
    tile_step(t, nr, nc, scale, [&](int r, int c) {
      const int qp = q_lo + r, kp = k0 + c;
      return (!causal || qp >= kp) && (window < 0 || kp > qp - window);
    });
  }
  tile_store(t, nr, out + b * o_sb + i0 * o_ss + hq * o_sh, o_ss);
}

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads) paged_extend_kernel(
    const QT* __restrict__ q, int64_t q_sb, int64_t q_ss, int64_t q_sh,
    const KT* __restrict__ k, const KT* __restrict__ v,
    int64_t a_sn, int64_t a_sp, int64_t a_sl, int64_t a_sh,
    const int* __restrict__ slot_pos, int64_t sp_sn, int64_t sp_sp, int64_t sp_sl,
    const int* __restrict__ block_table, int64_t bt_sb, int n_log,
    const int* __restrict__ pos, int layer,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    int64_t sc_sn, int64_t sc_sl,
    QT* __restrict__ out, int64_t o_sb, int64_t o_ss, int64_t o_sh,
    int Sq, int G, int Dh, int N, int P, float scale) {
  extern __shared__ float smem[];
  const int i0 = blockIdx.x * kExtendQ, hq = blockIdx.y, b = blockIdx.z;
  const int hkv = hq / G;
  const int nr = min(kExtendQ, Sq - i0);
  const int q_lo = pos[b] + i0;             // absolute position of row 0
  const int q_hi = q_lo + nr - 1;           // newest attendable position
  Tile t = carve_tile(smem, kExtendQ, P, Dh);
  int* sp_tile = reinterpret_cast<int*>(tile_end(t, kExtendQ));   // [P]
  int* bt_tile = sp_tile + P;                                      // [n_log]

  load_rows(t.q, q + b * q_sb + i0 * q_ss + hq * q_sh, q_ss, 1.f, (float*)nullptr,
            (const QT*)nullptr, 0, 0.f, t.ld, nr, nr, Dh);
  load_block_table(bt_tile, block_table + b * bt_sb, n_log);
  tile_init(t, nr);
  __syncthreads();

  for (int j = 0; j < n_log && j * P <= q_hi; ++j) {
    const int page = bt_tile[j];
    if (page < 0 || page >= N) continue;  // unmapped sentinel page
    float ks = 1.f, vs = 1.f;
    if (k_scale != nullptr) {
      ks = k_scale[page * sc_sn + layer * sc_sl];
      vs = v_scale[page * sc_sn + layer * sc_sl];
    }
    const int64_t base = page * a_sn + layer * a_sl + hkv * a_sh;
    const int sp = fetch_slot_pos(slot_pos + page * sp_sn + layer * sp_sl, sp_sp, P);
    load_rows(t.k, k + base, a_sp, ks, t.v, v + base, a_sp, vs, t.ld, P, P, Dh);
    if (threadIdx.x < P) sp_tile[threadIdx.x] = sp;
    __syncthreads();
    tile_step(t, nr, P, scale, [&](int r, int c) {
      const int sp = sp_tile[c];
      return sp >= 0 && sp <= q_lo + r;
    });
  }
  tile_store(t, nr, out + b * o_sb + i0 * o_ss + hq * o_sh, o_ss);
}

template <typename T>
cudaError_t launch_flash(const void* q, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                         const void* k, int64_t k_sb, int64_t k_ss, int64_t k_sh,
                         const void* v, int64_t v_sb, int64_t v_ss, int64_t v_sh,
                         void* out, int64_t o_sb, int64_t o_ss, int64_t o_sh,
                         int B, int Hq, int Hkv, int Sq, int Skv, int Dh, int causal,
                         int window, cudaStream_t stream) {
  const size_t smem = tile_smem_bytes(kFlashQ, kFlashK, Dh);
  auto kernel = flash_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kFlashQ - 1) / kFlashQ, Hq, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), q_sb, q_ss, q_sh, static_cast<const T*>(k), k_sb, k_ss,
      k_sh, static_cast<const T*>(v), v_sb, v_ss, v_sh, static_cast<T*>(out), o_sb, o_ss,
      o_sh, Sq, Skv, Hq / Hkv, Dh, causal, window, rsqrtf(static_cast<float>(Dh)));
  return cudaGetLastError();
}

template <typename QT, typename KT>
cudaError_t launch_paged_extend(
    const void* q, int64_t q_sb, int64_t q_ss, int64_t q_sh, const void* k, const void* v,
    int64_t a_sn, int64_t a_sp, int64_t a_sl, int64_t a_sh,
    const int* slot_pos, int64_t sp_sn, int64_t sp_sp, int64_t sp_sl,
    const int* block_table, int64_t bt_sb, int n_log, const int* pos, int layer,
    const float* k_scale, const float* v_scale, int64_t sc_sn, int64_t sc_sl,
    void* out, int64_t o_sb, int64_t o_ss, int64_t o_sh,
    int B, int Hq, int Hkv, int Sq, int Dh, int N, int P, cudaStream_t stream) {
  const size_t smem = tile_smem_bytes(kExtendQ, P, Dh) + sizeof(int) * (P + n_log);
  auto kernel = paged_extend_kernel<QT, KT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kExtendQ - 1) / kExtendQ, Hq, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), q_sb, q_ss, q_sh,
      static_cast<const KT*>(k), static_cast<const KT*>(v), a_sn, a_sp, a_sl, a_sh,
      slot_pos, sp_sn, sp_sp, sp_sl, block_table, bt_sb, n_log, pos, layer,
      k_scale, v_scale, sc_sn, sc_sl, static_cast<QT*>(out), o_sb, o_ss, o_sh,
      Sq, Hq / Hkv, Dh, N, P, rsqrtf(static_cast<float>(Dh)));
  return cudaGetLastError();
}

}  // namespace rt

// Plain C entry points bound with ctypes.  Every tensor is given by its
// strides (elements) with a contiguous last dim.  Each returns
// cudaGetLastError() of its launch.

// q/out: (B, Sq, Hq, Dh); k/v: (B, Skv, Hkv, Dh); window < 0 = none.
extern "C" int rt_flash_attention(
    const void* q, int64_t q_sb, int64_t q_ss, int64_t q_sh,
    const void* k, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    const void* v, int64_t v_sb, int64_t v_ss, int64_t v_sh,
    void* out, int64_t o_sb, int64_t o_ss, int64_t o_sh,
    int B, int Hq, int Hkv, int Sq, int Skv, int Dh, int causal, int window, int dtype,
    void* stream) {
  using namespace rt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RT_FLASH(T)                                                                    \
  return launch_flash<T>(q, q_sb, q_ss, q_sh, k, k_sb, k_ss, k_sh, v, v_sb, v_ss, v_sh, \
                         out, o_sb, o_ss, o_sh, B, Hq, Hkv, Sq, Skv, Dh, causal, window, s)
  switch (dtype) {
    case F32: RT_FLASH(float);
    case BF16: RT_FLASH(__nv_bfloat16);
    default: return cudaErrorInvalidValue;
  }
#undef RT_FLASH
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
#define RT_EXTEND(QT, KT)                                                               \
  return launch_paged_extend<QT, KT>(q, q_sb, q_ss, q_sh, k, v, a_sn, a_sp, a_sl, a_sh, \
                                     sp, sp_sn, sp_sp, sp_sl, bt, bt_sb, n_log, ps,     \
                                     layer, ksc, vsc, sc_sn, sc_sl, out, o_sb, o_ss,    \
                                     o_sh, B, Hq, Hkv, Sq, Dh, N, P, s)
  const bool quant = kv_dtype == I8;
  if (!quant && kv_dtype != q_dtype) return cudaErrorInvalidValue;
  switch (q_dtype) {
    case F32:
      if (quant) RT_EXTEND(float, int8_t);
      RT_EXTEND(float, float);
    case BF16:
      if (quant) RT_EXTEND(__nv_bfloat16, int8_t);
      RT_EXTEND(__nv_bfloat16, __nv_bfloat16);
    default:
      return cudaErrorInvalidValue;
  }
#undef RT_EXTEND
}
