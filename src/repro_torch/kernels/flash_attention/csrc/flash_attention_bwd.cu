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
// head h / G).  Inputs are float32 or bf16, every sum float32.
//
// Three launches on the caller's stream, no atomics, so two calls on the
// same inputs give the same bits:
//
// * bwd_dot_kernel: D = rowsum(dout * out), float32 (B, Hq, Sq), one warp
//   a row.
// * bwd_dkdv_kernel: one block per (row, kv head, tile of kBK keys).  dK
//   and dV of its keys stay in float32 shared memory while the block loops
//   over the G q heads of its kv head and over the q tiles that can see
//   its keys (the causal limit and the window bound the walk): per q tile
//   P, dP = dout V^T, dS = P (dP - D) scale, then dV += P^T dout and
//   dK += dS^T Q.  Each (key, dim) sum is owned by one thread.
// * bwd_dq_kernel: one block per (row, q head, tile of kBQ q positions),
//   looping over the kv tiles its rows can see: dQ += dS K.
//
// Bound on the H100 at qwen3-4b's training shape (bf16, causal, B4 S512 Hq32
// Hkv8 Dh128): about 21.5 GFLOP of products in the five causal matrix
// products (0.022 ms at the bf16 tensor-core peak) against about 84 MB of
// q, k, v, out, dout, lse in and dq, dk, dv out (0.025 ms at 3.35 TB/s), so
// bytes set the bound.  This first kernel runs its products on CUDA cores
// in float32 from shared-memory tiles (each thread a 4 x 4 or 2 x 4 block
// of outputs, its columns strided so that a warp's reads hit distinct
// banks), seven products where the minimum is five (S and dP are computed
// in both kernels): it is far from the bound, and the tensor cores
// (mma.sync, then wgmma) are a later PR's work.
#include "tile_attention.cuh"

namespace rt {

constexpr int kBQ = 32;  // q positions per tile
constexpr int kBK = 32;  // keys per tile

__device__ __forceinline__ int bwd_key_limit(const int* kv_len, int b, int Skv) {
  return kv_len != nullptr ? max(0, min(Skv, kv_len[b])) : Skv;
}

// out[r][c] for r < M, c < N (M % RM == 0, N % RN == 0): epi(r, c, sum_t
// A(r, t) B(c, t)) with A(r, t) = a[r * ar + t * at], B(c, t) = b[c * br +
// t * bt].  A thread owns rows r0 .. r0 + RM - 1 and columns cb, cb + tn,
// ..., so the threads of a warp read neighbouring columns.
template <int RM, int RN, class Epi>
__device__ __forceinline__ void mm_tile(const float* __restrict__ a, int ar, int at,
                                        const float* __restrict__ b, int br, int bt, int M,
                                        int N, int K, Epi epi) {
  const int tn = N / RN, tiles = (M / RM) * tn;
  for (int tt = threadIdx.x; tt < tiles; tt += blockDim.x) {
    const int r0 = (tt / tn) * RM, cb = tt - (tt / tn) * tn;
    float acc[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
    for (int t = 0; t < K; ++t) {
      float av[RM], bv[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) av[i] = a[(r0 + i) * ar + t * at];
#pragma unroll
      for (int j = 0; j < RN; ++j) bv[j] = b[(cb + j * tn) * br + t * bt];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) epi(r0 + i, cb + j * tn, acc[i][j]);
  }
}

// float32 shared memory of the two tile kernels: four (32, Dh + 1) input
// tiles, one (32, Dh) or two accumulators, the P and dS tiles and the rows'
// lse and D.
__host__ __device__ inline size_t bwd_smem_bytes(int dh, int n_acc) {
  const size_t ld = tile_ld(dh);
  return sizeof(float) * (4 * kBK * ld + (size_t)n_acc * kBK * dh + 2 * kBQ * (kBK + 1) + 2 * kBQ);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) bwd_dot_kernel(
    const T* __restrict__ out, int64_t o_sb, int64_t o_ss, int64_t o_sh,
    const T* __restrict__ dout, int64_t d_sb, int64_t d_ss, int64_t d_sh,
    float* __restrict__ D, int Sq, int Dh) {
  const int i = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int h = blockIdx.y, b = blockIdx.z, lane = threadIdx.x & 31;
  if (i >= Sq) return;
  const T* o = out + b * o_sb + i * o_ss + h * o_sh;
  const T* g = dout + b * d_sb + i * d_ss + h * d_sh;
  float acc = 0.f;
  for (int d = lane; d < Dh; d += 32) acc = fmaf(to_f(o[d]), to_f(g[d]), acc);
  acc = warp_sum(acc);
  if (lane == 0) D[((int64_t)b * gridDim.y + h) * Sq + i] = acc;
}

// P[r][c] = exp(scale <q_r, k_c> - lse_r) where (r, c) is valid, else 0;
// dS[r][c] = <dout_r, v_c> (turned into dS by bwd_ds).
template <class Valid>
__device__ __forceinline__ void bwd_p_dp(const float* qs, const float* dos, const float* ks,
                                         const float* vs, const float* lse_s, float* ps,
                                         float* dss, int ld, int Dh, float scale, Valid valid) {
  constexpr int lp = kBK + 1;
  mm_tile<2, 4>(qs, ld, 1, ks, ld, 1, kBQ, kBK, Dh, [&](int r, int c, float x) {
    ps[r * lp + c] = valid(r, c) ? expf(x * scale - lse_s[r]) : 0.f;
  });
  mm_tile<2, 4>(dos, ld, 1, vs, ld, 1, kBQ, kBK, Dh,
                [&](int r, int c, float x) { dss[r * lp + c] = x; });
}

// dS = P (dP - D) scale, in place over dP.
__device__ __forceinline__ void bwd_ds(const float* ps, float* dss, const float* D_s,
                                       float scale) {
  constexpr int lp = kBK + 1;
  for (int i = threadIdx.x; i < kBQ * kBK; i += blockDim.x) {
    const int r = i / kBK, c = i - r * kBK;
    dss[r * lp + c] = ps[r * lp + c] * (dss[r * lp + c] - D_s[r]) * scale;
  }
}

// lse and D of q rows i0 .. i0 + nr - 1 of head h (0 past nr).
__device__ __forceinline__ void load_row_stats(float* lse_s, float* D_s, const float* lse,
                                               const float* D, int64_t base, int nr) {
  for (int r = threadIdx.x; r < kBQ; r += blockDim.x) {
    lse_s[r] = r < nr ? lse[base + r] : 0.f;
    D_s[r] = r < nr ? D[base + r] : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) bwd_dkdv_kernel(
    const T* __restrict__ q, int64_t q_sb, int64_t q_ss, int64_t q_sh,
    const T* __restrict__ k, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    const T* __restrict__ v, int64_t v_sb, int64_t v_ss, int64_t v_sh,
    const T* __restrict__ dout, int64_t d_sb, int64_t d_ss, int64_t d_sh,
    const float* __restrict__ lse, const float* __restrict__ D,
    T* __restrict__ dk, int64_t dk_sb, int64_t dk_ss, int64_t dk_sh,
    T* __restrict__ dv, int64_t dv_sb, int64_t dv_ss, int64_t dv_sh,
    int Sq, int Skv, const int* __restrict__ kv_len, int G, int Dh, int causal, int window,
    float scale) {
  extern __shared__ float smem[];
  const int ld = tile_ld(Dh);
  float* ks = smem;                 // [kBK][ld]
  float* vs = ks + kBK * ld;        // [kBK][ld]
  float* qs = vs + kBK * ld;        // [kBQ][ld]
  float* dos = qs + kBQ * ld;       // [kBQ][ld]
  float* dks = dos + kBQ * ld;      // [kBK][Dh]
  float* dvs = dks + kBK * Dh;      // [kBK][Dh]
  float* ps = dvs + kBK * Dh;       // [kBQ][kBK + 1]
  float* dss = ps + kBQ * (kBK + 1);
  float* lse_s = dss + kBQ * (kBK + 1);
  float* D_s = lse_s + kBQ;

  const int k0 = blockIdx.x * kBK, hkv = blockIdx.y, b = blockIdx.z;
  const int Hq = gridDim.y * G, off = Skv - Sq;
  const int nk = max(0, min(kBK, bwd_key_limit(kv_len, b, Skv) - k0));
  load_rows(ks, k + b * k_sb + k0 * k_ss + hkv * k_sh, k_ss, 1.f, vs,
            v + b * v_sb + k0 * v_ss + hkv * v_sh, v_ss, 1.f, ld, kBK, nk, Dh);
  for (int i = threadIdx.x; i < 2 * kBK * Dh; i += blockDim.x) dks[i] = 0.f;

  // the q positions that can see a key of [k0, k0 + nk): causal, i >= k0 -
  // off; windowed, off + i < k0 + nk - 1 + window
  int i_begin = causal ? max(0, k0 - off) : 0;
  int i_end = window >= 0 ? min(Sq, k0 + nk - 1 + window - off) : Sq;
  if (nk == 0) i_end = 0;
  i_begin = (i_begin / kBQ) * kBQ;

  for (int g = 0; g < G; ++g) {
    const int hq = hkv * G + g;
    for (int i0 = i_begin; i0 < i_end; i0 += kBQ) {
      const int nr = min(kBQ, Sq - i0);
      __syncthreads();  // the previous tile's reads are done
      load_rows(qs, q + b * q_sb + i0 * q_ss + hq * q_sh, q_ss, 1.f, dos,
                dout + b * d_sb + i0 * d_ss + hq * d_sh, d_ss, 1.f, ld, kBQ, nr, Dh);
      load_row_stats(lse_s, D_s, lse, D, ((int64_t)b * Hq + hq) * Sq + i0, nr);
      __syncthreads();
      bwd_p_dp(qs, dos, ks, vs, lse_s, ps, dss, ld, Dh, scale, [&](int r, int c) {
        const int qp = off + i0 + r, kp = k0 + c;
        return r < nr && c < nk && (!causal || qp >= kp) && (window < 0 || kp > qp - window);
      });
      __syncthreads();
      bwd_ds(ps, dss, D_s, scale);
      __syncthreads();
      // dV[c][d] += sum_r P[r][c] dout[r][d]; dK[c][d] += sum_r dS[r][c] q[r][d]
      mm_tile<4, 4>(ps, 1, kBK + 1, dos, 1, ld, kBK, Dh, kBQ,
                    [&](int c, int d, float x) { dvs[c * Dh + d] += x; });
      mm_tile<4, 4>(dss, 1, kBK + 1, qs, 1, ld, kBK, Dh, kBQ,
                    [&](int c, int d, float x) { dks[c * Dh + d] += x; });
    }
  }
  __syncthreads();
  const int n_store = min(kBK, Skv - k0);  // keys past the limit store 0
  for (int i = threadIdx.x; i < n_store * Dh; i += blockDim.x) {
    const int c = i / Dh, d = i - c * Dh;
    dk[b * dk_sb + (k0 + c) * dk_ss + hkv * dk_sh + d] = from_f<T>(dks[i]);
    dv[b * dv_sb + (k0 + c) * dv_ss + hkv * dv_sh + d] = from_f<T>(dvs[i]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) bwd_dq_kernel(
    const T* __restrict__ q, int64_t q_sb, int64_t q_ss, int64_t q_sh,
    const T* __restrict__ k, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    const T* __restrict__ v, int64_t v_sb, int64_t v_ss, int64_t v_sh,
    const T* __restrict__ dout, int64_t d_sb, int64_t d_ss, int64_t d_sh,
    const float* __restrict__ lse, const float* __restrict__ D,
    T* __restrict__ dq, int64_t dq_sb, int64_t dq_ss, int64_t dq_sh,
    int Sq, int Skv, const int* __restrict__ kv_len, int G, int Dh, int causal, int window,
    float scale) {
  extern __shared__ float smem[];
  const int ld = tile_ld(Dh);
  float* ks = smem;                 // [kBK][ld]
  float* vs = ks + kBK * ld;        // [kBK][ld]
  float* qs = vs + kBK * ld;        // [kBQ][ld]
  float* dos = qs + kBQ * ld;       // [kBQ][ld]
  float* dqs = dos + kBQ * ld;      // [kBQ][Dh]
  float* ps = dqs + kBQ * Dh;       // [kBQ][kBK + 1]
  float* dss = ps + kBQ * (kBK + 1);
  float* lse_s = dss + kBQ * (kBK + 1);
  float* D_s = lse_s + kBQ;

  const int i0 = blockIdx.x * kBQ, hq = blockIdx.y, b = blockIdx.z;
  const int hkv = hq / G, off = Skv - Sq;
  const int nr = min(kBQ, Sq - i0);
  const int n_keys = bwd_key_limit(kv_len, b, Skv);
  load_rows(qs, q + b * q_sb + i0 * q_ss + hq * q_sh, q_ss, 1.f, dos,
            dout + b * d_sb + i0 * d_ss + hq * d_sh, d_ss, 1.f, ld, kBQ, nr, Dh);
  load_row_stats(lse_s, D_s, lse, D, ((int64_t)b * gridDim.y + hq) * Sq + i0, nr);
  for (int i = threadIdx.x; i < kBQ * Dh; i += blockDim.x) dqs[i] = 0.f;

  // the kv tiles the rows can see
  const int q_lo = off + i0, q_hi = off + i0 + nr - 1;
  const int n_tiles = (n_keys + kBK - 1) / kBK;
  const int t_end = causal ? min(n_tiles, q_hi / kBK + 1) : n_tiles;
  const int t_begin = window >= 0 ? max(0, q_lo - window + 1) / kBK : 0;
  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBK, nk = min(kBK, n_keys - k0);
    __syncthreads();  // the previous tile's reads are done
    load_rows(ks, k + b * k_sb + k0 * k_ss + hkv * k_sh, k_ss, 1.f, vs,
              v + b * v_sb + k0 * v_ss + hkv * v_sh, v_ss, 1.f, ld, kBK, nk, Dh);
    __syncthreads();
    bwd_p_dp(qs, dos, ks, vs, lse_s, ps, dss, ld, Dh, scale, [&](int r, int c) {
      const int qp = q_lo + r, kp = k0 + c;
      return r < nr && c < nk && (!causal || qp >= kp) && (window < 0 || kp > qp - window);
    });
    __syncthreads();
    bwd_ds(ps, dss, D_s, scale);
    __syncthreads();
    // dQ[r][d] += sum_c dS[r][c] k[c][d]
    mm_tile<4, 4>(dss, kBK + 1, 1, ks, 1, ld, kBQ, Dh, kBK,
                  [&](int r, int d, float x) { dqs[r * Dh + d] += x; });
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nr * Dh; i += blockDim.x) {
    const int r = i / Dh, d = i - r * Dh;
    dq[b * dq_sb + (i0 + r) * dq_ss + hq * dq_sh + d] = from_f<T>(dqs[i]);
  }
}

template <typename T>
cudaError_t launch_flash_bwd(const void* q, const int64_t* qs, const void* k, const int64_t* ks,
                             const void* v, const int64_t* vs, const void* out,
                             const int64_t* os, const void* dout, const int64_t* ds,
                             const float* lse, float* D, void* dq, const int64_t* dqs,
                             void* dk, const int64_t* dks, void* dv, const int64_t* dvs, int B,
                             int Hq, int Hkv, int Sq, int Skv, const int* kv_len, int Dh,
                             int causal, int window, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const float scale = rsqrtf(static_cast<float>(Dh));
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dp = static_cast<const T*>(dout);
  bwd_dot_kernel<T><<<dim3((Sq + 3) / 4, Hq, B), kThreads, 0, stream>>>(
      static_cast<const T*>(out), os[0], os[1], os[2], dp, ds[0], ds[1], ds[2], D, Sq, Dh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dkdv_kernel<T><<<dim3((Skv + kBK - 1) / kBK, Hkv, B), kThreads, bwd_smem_bytes(Dh, 2),
                       stream>>>(
      qp, qs[0], qs[1], qs[2], kp, ks[0], ks[1], ks[2], vp, vs[0], vs[1], vs[2], dp, ds[0],
      ds[1], ds[2], lse, D, static_cast<T*>(dk), dks[0], dks[1], dks[2], static_cast<T*>(dv),
      dvs[0], dvs[1], dvs[2], Sq, Skv, kv_len, G, Dh, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dq_kernel<T><<<dim3((Sq + kBQ - 1) / kBQ, Hq, B), kThreads, bwd_smem_bytes(Dh, 1),
                     stream>>>(
      qp, qs[0], qs[1], qs[2], kp, ks[0], ks[1], ks[2], vp, vs[0], vs[1], vs[2], dp, ds[0],
      ds[1], ds[2], lse, D, static_cast<T*>(dq), dqs[0], dqs[1], dqs[2], Sq, Skv, kv_len, G,
      Dh, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace rt

// Once per process, when the library is bound (prepare_kernels).
extern "C" int rt_prepare_flash_bwd() {
  using namespace rt;
  return prepare_kernels({(const void*)bwd_dkdv_kernel<float>,
                          (const void*)bwd_dkdv_kernel<__nv_bfloat16>,
                          (const void*)bwd_dq_kernel<float>,
                          (const void*)bwd_dq_kernel<__nv_bfloat16>,
                          (const void*)bwd_dot_kernel<float>,
                          (const void*)bwd_dot_kernel<__nv_bfloat16>});
}

// Plain C entry point bound with ctypes.  q, out, dout, dq: (B, Sq, Hq, Dh);
// k, v, dk, dv: (B, Skv, Hkv, Dh), each given by its (b, s, h) strides in
// elements with a contiguous last dim; lse and D (scratch): float32 (B, Hq,
// Sq) contiguous; kv_len (B,) int32 or null; window < 0 = none.  Dh a
// multiple of 4 up to 256 (the wrapper checks).  Returns cudaGetLastError()
// of its launches.
extern "C" int rt_flash_attention_bwd(
    const void* q, int64_t q_sb, int64_t q_ss, int64_t q_sh,
    const void* k, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    const void* v, int64_t v_sb, int64_t v_ss, int64_t v_sh,
    const void* out, int64_t o_sb, int64_t o_ss, int64_t o_sh,
    const void* dout, int64_t d_sb, int64_t d_ss, int64_t d_sh,
    const void* lse, void* D,
    void* dq, int64_t dq_sb, int64_t dq_ss, int64_t dq_sh,
    void* dk, int64_t dk_sb, int64_t dk_ss, int64_t dk_sh,
    void* dv, int64_t dv_sb, int64_t dv_ss, int64_t dv_sh,
    int B, int Hq, int Hkv, int Sq, int Skv, const void* kv_len, int Dh, int causal,
    int window, int dtype, void* stream) {
  using namespace rt;
  if (Dh % 4 || Dh > 256 || Hq % Hkv) return cudaErrorInvalidValue;
  const int64_t qs[3] = {q_sb, q_ss, q_sh}, ks[3] = {k_sb, k_ss, k_sh},
                vs[3] = {v_sb, v_ss, v_sh}, os[3] = {o_sb, o_ss, o_sh},
                ds[3] = {d_sb, d_ss, d_sh}, dqs[3] = {dq_sb, dq_ss, dq_sh},
                dks[3] = {dk_sb, dk_ss, dk_sh}, dvs[3] = {dv_sb, dv_ss, dv_sh};
  const float* ls = static_cast<const float*>(lse);
  float* Dp = static_cast<float*>(D);
  const int* kl = static_cast<const int*>(kv_len);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32:
      return launch_flash_bwd<float>(q, qs, k, ks, v, vs, out, os, dout, ds, ls, Dp, dq, dqs,
                                     dk, dks, dv, dvs, B, Hq, Hkv, Sq, Skv, kl, Dh, causal,
                                     window, s);
    case BF16:
      return launch_flash_bwd<__nv_bfloat16>(q, qs, k, ks, v, vs, out, os, dout, ds, ls, Dp,
                                             dq, dqs, dk, dks, dv, dvs, B, Hq, Hkv, Sq, Skv,
                                             kl, Dh, causal, window, s);
    default:
      return cudaErrorInvalidValue;
  }
}
