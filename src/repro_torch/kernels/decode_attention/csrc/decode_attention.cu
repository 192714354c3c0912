// Decode attention for Hopper (sm_90a): dense per-slot caches and paged
// arenas.
//
// decode_kernel replaces the TPU kernel src/repro/kernels/decode_attention/
// decode_attention.py::_decode_kernel (wrapper decode_attention_bhd).  One
// decode query per row and q head attends to the row's dense (S, Hkv, Dh)
// cache.  A slot counts iff its position p (slot_pos[b, s], or s without a
// slot_pos plane) has 0 <= p < kv_len[b] and, with a window, p > kv_len[b]-1-
// window: the masks of repro/models/layers.py::decode_attention_ref, which
// serves rolling sliding-window buffers (the Pallas kernel had neither).
// Without slot_pos the key walk stops at kv_len (and starts at the window),
// as the Pallas kernel skipped blocks past kv_len; a rolling buffer's valid
// slots lie anywhere, so with slot_pos it walks all S slots.  Any S is
// taken: the last key tile is ragged (the Pallas wrapper asserted
// S % block_k == 0).
//
// paged_decode_kernel replaces the TPU kernel src/repro/kernels/decode_attention/
// decode_attention.py::_paged_decode_kernel (wrapper
// paged_decode_attention_bhd).  One decode query per row and q head attends
// to the row's pages of a (N, P, L, Hkv, Dh) arena through a (B, n_log)
// block table.  A slot counts iff 0 <= slot_pos < kv_len[b]; sentinel pages
// (page id >= N) and pages that start at or past kv_len are skipped; int8
// arenas dequantise with per-(page, layer) scales.
//
// What bounds both on the H100: the K and V bytes streamed from device
// memory, B * kv_len * Hkv * Dh * 2 * bytes per layer; the arithmetic is
// 4 * G flops per K/V element pair, far below the card's ridge point.
//
// What this simple design does about it: one block per (row, kv head) walks
// the row's key tiles (dense) or pages (paged) in order; the G q heads of
// the group sit in shared memory, so each K/V tile is read from device
// memory once for all G heads and the grid reads every live K/V byte
// exactly once.  m, l and acc stay in
// float32.  With only B * Hkv blocks most SMs idle at small batch; splitting
// the key walk across blocks (flash-decoding) is the next step.
#include "tile_attention.cuh"

namespace rt {

constexpr int kDenseTile = 32;  // key rows per shared-memory tile, dense kernel

template <typename T>
__global__ void __launch_bounds__(kThreads) decode_kernel(
    const T* __restrict__ q, int64_t q_sb, int64_t q_sh,
    const T* __restrict__ k, const T* __restrict__ v,
    int64_t c_sb, int64_t c_ss, int64_t c_sh,
    const int* __restrict__ slot_pos, int64_t sp_sb, int64_t sp_ss,
    const int* __restrict__ kv_len, int window,
    T* __restrict__ out, int64_t o_sb, int64_t o_sh,
    int G, int Dh, int S, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  Tile t = carve_tile(smem, G, kDenseTile, Dh);
  int* sp_tile = reinterpret_cast<int*>(tile_end(t, G));  // [kDenseTile]

  load_rows(t.q, q + b * q_sb + (int64_t)h * G * q_sh, q_sh, 1.f, (float*)nullptr,
            (const T*)nullptr, 0, 0.f, t.ld, G, G, Dh);
  tile_init(t, G);
  const int len = kv_len[b];
  const int lo = window >= 0 ? len - 1 - window : -1;  // positions must be > lo
  const int* sp_row = slot_pos != nullptr ? slot_pos + b * sp_sb : nullptr;
  const int begin = sp_row != nullptr ? 0 : max(lo + 1, 0);
  const int end = sp_row != nullptr ? S : min(S, len);
  __syncthreads();

  for (int s0 = begin; s0 < end; s0 += kDenseTile) {
    const int n = min(kDenseTile, end - s0);
    const int i = threadIdx.x;
    // the slot's position, read before the K/V loads so its latency overlaps
    const int sp = i < n ? (sp_row != nullptr ? sp_row[(s0 + i) * sp_ss] : s0 + i) : -1;
    const int64_t base = b * c_sb + (int64_t)s0 * c_ss + h * c_sh;
    load_rows(t.k, k + base, c_ss, 1.f, t.v, v + base, c_ss, 1.f, t.ld, n, n, Dh);
    if (i < kDenseTile) sp_tile[i] = sp;
    __syncthreads();
    tile_step(t, G, n, scale, [&](int, int c) {
      const int p = sp_tile[c];
      return p >= 0 && p < len && p > lo;
    });
  }
  tile_store(t, G, out + b * o_sb + (int64_t)h * G * o_sh, o_sh);
}

template <typename T>
cudaError_t launch_decode(const void* q, int64_t q_sb, int64_t q_sh, const void* k,
                          const void* v, int64_t c_sb, int64_t c_ss, int64_t c_sh,
                          const int* slot_pos, int64_t sp_sb, int64_t sp_ss,
                          const int* kv_len, int window, void* out, int64_t o_sb,
                          int64_t o_sh, int B, int Hkv, int G, int Dh, int S,
                          cudaStream_t stream) {
  const size_t smem = tile_smem_bytes(G, kDenseTile, Dh) + sizeof(int) * kDenseTile;
  auto kernel = decode_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B, Hkv), kThreads, smem, stream>>>(
      static_cast<const T*>(q), q_sb, q_sh, static_cast<const T*>(k),
      static_cast<const T*>(v), c_sb, c_ss, c_sh, slot_pos, sp_sb, sp_ss, kv_len, window,
      static_cast<T*>(out), o_sb, o_sh, G, Dh, S, rsqrtf(static_cast<float>(Dh)));
  return cudaGetLastError();
}

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const QT* __restrict__ q, int64_t q_sb, int64_t q_sh,
    const KT* __restrict__ k, const KT* __restrict__ v,
    int64_t a_sn, int64_t a_sp, int64_t a_sl, int64_t a_sh,
    const int* __restrict__ slot_pos, int64_t sp_sn, int64_t sp_sp, int64_t sp_sl,
    const int* __restrict__ block_table, int64_t bt_sb, int n_log,
    const int* __restrict__ kv_len, int layer,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    int64_t sc_sn, int64_t sc_sl,
    QT* __restrict__ out, int64_t o_sb, int64_t o_sh,
    int G, int Dh, int N, int P, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  Tile t = carve_tile(smem, G, P, Dh);
  int* sp_tile = reinterpret_cast<int*>(tile_end(t, G));   // [P]
  int* bt_tile = sp_tile + P;                               // [n_log]

  load_rows(t.q, q + b * q_sb + (int64_t)h * G * q_sh, q_sh, 1.f, (float*)nullptr,
            (const QT*)nullptr, 0, 0.f, t.ld, G, G, Dh);
  load_block_table(bt_tile, block_table + b * bt_sb, n_log);
  tile_init(t, G);
  const int len = kv_len[b];
  __syncthreads();

  for (int j = 0; j < n_log && j * P < len; ++j) {
    const int page = bt_tile[j];
    if (page < 0 || page >= N) continue;  // unmapped sentinel page
    float ks = 1.f, vs = 1.f;
    if (k_scale != nullptr) {
      ks = k_scale[page * sc_sn + layer * sc_sl];
      vs = v_scale[page * sc_sn + layer * sc_sl];
    }
    const int64_t base = page * a_sn + layer * a_sl + h * a_sh;
    const int sp = fetch_slot_pos(slot_pos + page * sp_sn + layer * sp_sl, sp_sp, P);
    load_rows(t.k, k + base, a_sp, ks, t.v, v + base, a_sp, vs, t.ld, P, P, Dh);
    if (threadIdx.x < P) sp_tile[threadIdx.x] = sp;
    __syncthreads();
    tile_step(t, G, P, scale, [&](int, int c) {
      const int sp = sp_tile[c];
      return sp >= 0 && sp < len;
    });
  }
  tile_store(t, G, out + b * o_sb + (int64_t)h * G * o_sh, o_sh);
}

template <typename QT, typename KT>
cudaError_t launch_paged_decode(
    const void* q, int64_t q_sb, int64_t q_sh, const void* k, const void* v,
    int64_t a_sn, int64_t a_sp, int64_t a_sl, int64_t a_sh,
    const int* slot_pos, int64_t sp_sn, int64_t sp_sp, int64_t sp_sl,
    const int* block_table, int64_t bt_sb, int n_log, const int* kv_len, int layer,
    const float* k_scale, const float* v_scale, int64_t sc_sn, int64_t sc_sl,
    void* out, int64_t o_sb, int64_t o_sh,
    int B, int Hkv, int G, int Dh, int N, int P, cudaStream_t stream) {
  const size_t smem = tile_smem_bytes(G, P, Dh) + sizeof(int) * (P + n_log);
  auto kernel = paged_decode_kernel<QT, KT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B, Hkv), kThreads, smem, stream>>>(
      static_cast<const QT*>(q), q_sb, q_sh,
      static_cast<const KT*>(k), static_cast<const KT*>(v), a_sn, a_sp, a_sl, a_sh,
      slot_pos, sp_sn, sp_sp, sp_sl, block_table, bt_sb, n_log, kv_len, layer,
      k_scale, v_scale, sc_sn, sc_sl, static_cast<QT*>(out), o_sb, o_sh,
      G, Dh, N, P, rsqrtf(static_cast<float>(Dh)));
  return cudaGetLastError();
}

}  // namespace rt

// Plain C entry points bound with ctypes; each returns cudaGetLastError() of
// its launch.  q/out: (B, Hq, Dh) views given by their batch and head
// strides.
//
// Dense: k/v caches (B, S, Hkv, Dh) share the strides (c_sb, c_ss, c_sh) and
// have a contiguous last dim; slot_pos is a (B, S) int32 plane or null;
// window < 0 means no window.
extern "C" int rt_decode_attention(
    const void* q, int64_t q_sb, int64_t q_sh, int dtype,
    const void* k, const void* v, int64_t c_sb, int64_t c_ss, int64_t c_sh,
    const void* slot_pos, int64_t sp_sb, int64_t sp_ss, const void* kv_len, int window,
    void* out, int64_t o_sb, int64_t o_sh,
    int B, int Hkv, int G, int Dh, int S, void* stream) {
  using namespace rt;
  const int* sp = static_cast<const int*>(slot_pos);
  const int* kl = static_cast<const int*>(kv_len);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32:
      return launch_decode<float>(q, q_sb, q_sh, k, v, c_sb, c_ss, c_sh, sp, sp_sb, sp_ss,
                                  kl, window, out, o_sb, o_sh, B, Hkv, G, Dh, S, s);
    case BF16:
      return launch_decode<__nv_bfloat16>(q, q_sb, q_sh, k, v, c_sb, c_ss, c_sh, sp, sp_sb,
                                          sp_ss, kl, window, out, o_sb, o_sh, B, Hkv, G,
                                          Dh, S, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Paged: arena k/v share strides (N, P, L, Hkv) and
// have a contiguous last dim.
extern "C" int rt_paged_decode_attention(
    const void* q, int64_t q_sb, int64_t q_sh, int q_dtype,
    const void* k, const void* v, int kv_dtype,
    int64_t a_sn, int64_t a_sp, int64_t a_sl, int64_t a_sh,
    const void* slot_pos, int64_t sp_sn, int64_t sp_sp, int64_t sp_sl,
    const void* block_table, int64_t bt_sb, int n_log, const void* kv_len, int layer,
    const void* k_scale, const void* v_scale, int64_t sc_sn, int64_t sc_sl,
    void* out, int64_t o_sb, int64_t o_sh,
    int B, int Hkv, int G, int Dh, int N, int P, void* stream) {
  using namespace rt;
  const int* sp = static_cast<const int*>(slot_pos);
  const int* bt = static_cast<const int*>(block_table);
  const int* kl = static_cast<const int*>(kv_len);
  const float* ksc = static_cast<const float*>(k_scale);
  const float* vsc = static_cast<const float*>(v_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RT_DECODE(QT, KT)                                                             \
  return launch_paged_decode<QT, KT>(q, q_sb, q_sh, k, v, a_sn, a_sp, a_sl, a_sh, sp, \
                                     sp_sn, sp_sp, sp_sl, bt, bt_sb, n_log, kl, layer, \
                                     ksc, vsc, sc_sn, sc_sl, out, o_sb, o_sh, B, Hkv,  \
                                     G, Dh, N, P, s)
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
