// Flash-attention backward for Hopper (sm_90a), split in two kernels as the
// JAX package's default backward is: a dq pass and a dk/dv pass, both
// recomputing the probabilities from the forward's saved fp32 LSE.
//
// Replaces the TPU kernels mxnet_tpu/ops/flash_attention.py::
// _flash_bwd_dq_kernel and _flash_bwd_dkv_kernel (driven by
// _pallas_flash_bwd_split). Same function as the oracle's scan backward in
// _flash_bwd_rule: with p = exp(scale * q.k - lse), dp = dO.v and
// ds = p * (dp - delta) * scale, where delta = rowsum(dO * O) in fp32 is
// computed by the wrapper,
//   dq = sum_k ds K,   dk = sum_q ds^T Q,   dv = sum_q p^T dO.
// Masks, layouts and grouped-query heads as in flash_common.cuh. Storage
// float32 or bfloat16; every product and sum in fp32, one rounding at the
// store.
//
// Design.
// - dq: one CUDA block per (batch * head, 64 query rows). It keeps Q and dO
//   in shared memory and walks the visible key tiles (kv_tiles()), holding
//   its 64 x kD dq accumulator in registers (4 rows x kD / 16 dims a thread).
// - dk/dv: one CUDA block per (batch * kv head, 64 key rows), the body in
//   flash_bwd_kv.cuh. It keeps K and V in shared memory and walks, for each
//   query head of its group in turn, the query tiles that see its keys
//   (q_tiles()). The group's sum of dk and dv therefore happens in
//   registers, in a fixed order, with no atomics: the result is
//   deterministic, and K/V are never repeated.
// In both, a thread computes 4 x 4 entries of the score tile and of dp, and
// p (and ds) go through shared memory for the second product.
//
// Bound on this card: 6 * T * S' * D operations in dq and 8 * T * S' * D in
// dk/dv per (batch, head), S' the visible keys, against reading Q, K, V, dO,
// LSE, delta once and writing the gradients. In fp32 operations bound both
// kernels (67 TFLOP/s) at the training slice's T = S = 128; in bf16 the
// bytes would at that length (below the tensor cores' ridge of 295 flops per
// byte) and the operations (989 TFLOP/s) at long sequences. This first
// version runs on the CUDA cores in fp32 for both types (no wgmma, no TMA),
// so it stays well below either bound; the times are in PERF.md.

#include "flash_bwd_kv.cuh"

namespace mxtpu_flash {
namespace {

template <int kD>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (2 * (kBQ + kBK) * (kD + 1) + kBQ * kLdP);
}

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ g,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    Dims d) {
  constexpr int kLd = kD + 1;
  constexpr int kDPer = kD / 16;
  extern __shared__ float smem[];
  float* q_t = smem;               // kBQ x kLd
  float* g_t = q_t + kBQ * kLd;    // kBQ x kLd (dO)
  float* k_t = g_t + kBQ * kLd;    // kBK x kLd
  float* v_t = k_t + kBK * kLd;    // kBK x kLd
  float* ds_t = v_t + kBK * kLd;   // kBQ x kLdP

  const int bh = blockIdx.y;
  const int b = bh / d.H;
  const int h = bh - b * d.H;
  const int kvh = h / (d.H / d.KVH);
  const int q0 = blockIdx.x * kBQ;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<kD>(q_t, q + b * d.q_s[0] + h * d.q_s[1], d.q_s[2], q0, kBQ, d.T,
                d.D);
  load_tile<kD>(g_t, g + b * d.g_s[0] + h * d.g_s[1], d.g_s[2], q0, kBQ, d.T,
                d.D);
  const T* kb = k + b * d.k_s[0] + kvh * d.k_s[1];
  const T* vb = v + b * d.v_s[0] + kvh * d.v_s[1];

  float lse_r[4], delta_r[4], acc[4][kDPer];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const bool ok = row < d.T;
    lse_r[i] = ok ? lse[(long long)bh * d.T + row] : 0.f;
    delta_r[i] = ok ? delta[(long long)bh * d.T + row] : 0.f;
#pragma unroll
    for (int e = 0; e < kDPer; ++e) acc[i][e] = 0.f;
  }

  int lo, hi;
  kv_tiles(d, q0, min(q0 + kBQ, d.T), &lo, &hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int c0 = kt * kBK;
    __syncthreads();
    load_tile<kD>(k_t, kb, d.k_s[2], c0, kBK, d.S, d.D);
    load_tile<kD>(v_t, vb, d.v_s[2], c0, kBK, d.S, d.D);
    __syncthreads();

    float s[4][4], dp[4][4];
    score_and_dp<kD>(s, dp, q_t, g_t, k_t, v_t, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx + 16 * j;
        float p =
            expf(masked_score(d, row, col, s[i][j] * d.scale) - lse_r[i]);
        if (row >= d.T) p = 0.f;
        ds_t[(ty + 16 * i) * kLdP + tx + 16 * j] =
            p * (dp[i][j] - delta_r[i]) * d.scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float ds[4], kk[kDPer];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = ds_t[(ty + 16 * i) * kLdP + j];
#pragma unroll
      for (int e = 0; e < kDPer; ++e) kk[e] = k_t[j * kLd + tx + 16 * e];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < kDPer; ++e) acc[i][e] += ds[i] * kk[e];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= d.T) continue;
    T* out = dq + ((long long)bh * d.T + row) * d.D;
#pragma unroll
    for (int e = 0; e < kDPer; ++e) {
      const int c = tx + 16 * e;
      if (c < d.D) store(out + c, acc[i][e]);
    }
  }
}

// The dk/dv kernel: the key-tile body of flash_bwd_kv.cuh without dq.
template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ g,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, Dims d) {
  bwd_kv_block<T, kD, false>(q, k, v, g, lse, delta, nullptr, dk, dv, d);
}

template <typename T, int kD>
int launch_dq(const void* q, const void* k, const void* v, const void* g,
              const float* lse, const float* delta, void* dq, const Dims& d,
              cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<kD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((d.T + kBQ - 1) / kBQ, d.B * d.H);
  flash_bwd_dq_kernel<T, kD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g), lse, delta,
      static_cast<T*>(dq), d);
  return (int)cudaGetLastError();
}

template <typename T, int kD>
int launch_dkv(const void* q, const void* k, const void* v, const void* g,
               const float* lse, const float* delta, void* dk, void* dv,
               const Dims& d, cudaStream_t stream) {
  constexpr size_t smem = kv_smem_bytes<kD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, kD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((d.S + kBK - 1) / kBK, d.B * d.KVH);
  flash_bwd_dkv_kernel<T, kD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), d);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dq(const void* q, const void* k, const void* v, const void* g,
                const float* lse, const float* delta, void* dq, const Dims& d,
                cudaStream_t s) {
  if (d.D <= 32) return launch_dq<T, 32>(q, k, v, g, lse, delta, dq, d, s);
  if (d.D <= 64) return launch_dq<T, 64>(q, k, v, g, lse, delta, dq, d, s);
  if (d.D <= 128) return launch_dq<T, 128>(q, k, v, g, lse, delta, dq, d, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch_dkv(const void* q, const void* k, const void* v, const void* g,
                 const float* lse, const float* delta, void* dk, void* dv,
                 const Dims& d, cudaStream_t s) {
  if (d.D <= 32)
    return launch_dkv<T, 32>(q, k, v, g, lse, delta, dk, dv, d, s);
  if (d.D <= 64)
    return launch_dkv<T, 64>(q, k, v, g, lse, delta, dk, dv, d, s);
  if (d.D <= 128)
    return launch_dkv<T, 128>(q, k, v, g, lse, delta, dk, dv, d, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace mxtpu_flash

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. strides: 12 element strides, (batch,
// head, row) of q, k, v and dO. lse, delta: (B, H, T) fp32. dq is
// (B, H, T, D), contiguous. Returns cudaGetLastError() after the launch.
int mxtpu_flash_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                       const void* g, const void* lse, const void* delta,
                       void* dq, int B, int H, int KVH, int T, int S, int D,
                       int causal, int window, float scale,
                       const long long* strides, void* stream) {
  using namespace mxtpu_flash;
  const Dims d = make_dims(B, H, KVH, T, S, D, causal, window, scale, strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 0) return dispatch_dq<float>(q, k, v, g, l, dl, dq, d, s);
  if (dtype == 1)
    return dispatch_dq<__nv_bfloat16>(q, k, v, g, l, dl, dq, d, s);
  return (int)cudaErrorInvalidValue;
}

// As mxtpu_flash_bwd_dq; dk and dv are (B, KVH, S, D), contiguous, summed
// over each kv head's group of query heads.
int mxtpu_flash_bwd_dkv(int dtype, const void* q, const void* k,
                        const void* v, const void* g, const void* lse,
                        const void* delta, void* dk, void* dv, int B, int H,
                        int KVH, int T, int S, int D, int causal, int window,
                        float scale, const long long* strides, void* stream) {
  using namespace mxtpu_flash;
  const Dims d = make_dims(B, H, KVH, T, S, D, causal, window, scale, strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 0)
    return dispatch_dkv<float>(q, k, v, g, l, dl, dk, dv, d, s);
  if (dtype == 1)
    return dispatch_dkv<__nv_bfloat16>(q, k, v, g, l, dl, dk, dv, d, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

MXTPU_DEFINE_ERROR_STRING
