// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/
// decode_attention.py::_paged_decode_kernel (wrapper
// paged_decode_attention_bhd).  One decode query per row and q head attends
// to the row's pages of a (N, P, L, Hkv, Dh) arena through a (B, n_log)
// block table.  A slot counts iff 0 <= slot_pos < kv_len[b]; sentinel pages
// (page id >= N) and pages that start at or past kv_len are skipped; int8
// arenas dequantise with per-(page, layer) scales.
//
// What bounds it on the H100: the K and V bytes streamed from device
// memory, B * kv_len * Hkv * Dh * 2 * bytes per layer; the arithmetic is
// 4 * G flops per K/V element pair, far below the card's ridge point.
//
// What this simple design does about it: one block per (row, kv head) walks
// the row's pages in order; the G q heads of the group sit in shared memory,
// so each K/V page tile is read from device memory once for all G heads and
// the grid reads every live K/V byte exactly once.  m, l and acc stay in
// float32.  With only B * Hkv blocks most SMs idle at small batch; splitting
// the page walk across blocks (flash-decoding) is the next step.
#include "tile_attention.cuh"

namespace rt {

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

// Plain C entry point bound with ctypes.  q/out: (B, Hq, Dh) views given by
// their batch and head strides; arena k/v share strides (N, P, L, Hkv) and
// have a contiguous last dim.  Returns cudaGetLastError() of the launch.
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
