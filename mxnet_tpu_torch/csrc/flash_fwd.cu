// Flash-attention forward for Hopper (sm_90a): O = softmax(scale * Q K^T) V
// and the fp32 log-sum-exp of every query row, without a T x S score matrix
// in device memory.
//
// Replaces the TPU kernel mxnet_tpu/ops/flash_attention.py::_flash_fwd_kernel
// (driven by _pallas_flash_fwd). Same function as its oracle _jnp_flash_fwd:
// dense, causal (bottom-right aligned), sliding window, and grouped-query
// heads read unrepeated (see flash_common.cuh for the layouts and the mask).
// Storage float32 or bfloat16; every product and sum in fp32.
//
// Design. One CUDA block per (batch * head, 64 query rows). The block keeps
// its Q tile in shared memory and walks the key tiles of 64 rows that its
// rows can see -- the causal triangle and the window band are cut to whole
// tiles in kv_tiles(), which does the work of the TPU's banded grid, and
// only the boundary tiles are masked score by score. Each of the 256 threads
// owns 4 query rows (ty + 16 i) x 4 key columns (tx + 16 j) of the score
// tile and the same 4 rows x kD / 16 dims of the output accumulator, so the
// online-softmax state m, l of a row lives in registers, replicated over the
// 16 lanes that share the row and updated with half-warp shuffles. P goes
// through shared memory for the P V product. Ragged T and S are masked in
// the kernel; D <= 128 is padded to kD in {32, 64, 128} with zeros.
//
// Bound on this card: 4 * T * S' * D operations per (batch, head), S' the
// visible keys, against reading Q, K, V once and writing O and the LSE. At
// the training slice's shape (T = S = 128, D = 64) that is 32 flops per byte
// in fp32, above the CUDA cores' ridge (67 TFLOP/s over 3.35 TB/s = 20), so
// operations bound it; in bf16 it is 64 flops per byte, below the tensor
// cores' ridge (295), so bytes would. Long sequences (T = 4096) are
// operation-bound in both. This first version runs on the CUDA cores in fp32
// for both types (no wgmma, no TMA) and its inner products read shared memory
// once per two FMAs, so it stays well below either bound; the time is in
// PERF.md.

#include "flash_common.cuh"

namespace mxtpu_flash {
namespace {

template <int kD>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * ((kBQ + 2 * kBK) * (kD + 1) + kBQ * kLdP);
}

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, Dims d) {
  constexpr int kLd = kD + 1;
  constexpr int kDPer = kD / 16;  // output dims per thread
  extern __shared__ float smem[];
  float* q_t = smem;               // kBQ x kLd
  float* k_t = q_t + kBQ * kLd;    // kBK x kLd
  float* v_t = k_t + kBK * kLd;    // kBK x kLd
  float* p_t = v_t + kBK * kLd;    // kBQ x kLdP

  const int bh = blockIdx.y;
  const int b = bh / d.H;
  const int h = bh - b * d.H;
  const int kvh = h / (d.H / d.KVH);
  const int q0 = blockIdx.x * kBQ;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  const T* qb = q + b * d.q_s[0] + h * d.q_s[1];
  const T* kb = k + b * d.k_s[0] + kvh * d.k_s[1];
  const T* vb = v + b * d.v_s[0] + kvh * d.v_s[1];
  load_tile<kD>(q_t, qb, d.q_s[2], q0, kBQ, d.T, d.D);

  float m[4], l[4], acc[4][kDPer];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kDPer; ++e) acc[i][e] = 0.f;
  }

  int lo, hi;
  kv_tiles(d, q0, min(q0 + kBQ, d.T), &lo, &hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int c0 = kt * kBK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    load_tile<kD>(k_t, kb, d.k_s[2], c0, kBK, d.S, d.D);
    load_tile<kD>(v_t, vb, d.v_s[2], c0, kBK, d.S, d.D);
    __syncthreads();

    float s[4][4] = {};
    tile_dot<kD>(s, q_t, k_t, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = masked_score(d, row, c0 + tx + 16 * j, s[i][j] * d.scale);
        mx = fmaxf(mx, s[i][j]);
      }
      // column c0 < S is in every visited tile, so m_new is finite
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        p_t[(ty + 16 * i) * kLdP + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < kDPer; ++e) acc[i][e] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float p[4], vv[kDPer];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = p_t[(ty + 16 * i) * kLdP + j];
#pragma unroll
      for (int e = 0; e < kDPer; ++e) vv[e] = v_t[j * kLd + tx + 16 * e];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < kDPer; ++e) acc[i][e] += p[i] * vv[e];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= d.T) continue;
    const float lf = fmaxf(l[i], 1e-30f);
    const float inv = 1.f / lf;
    T* orow = o + ((long long)bh * d.T + row) * d.D;
#pragma unroll
    for (int e = 0; e < kDPer; ++e) {
      const int c = tx + 16 * e;
      if (c < d.D) store(orow + c, acc[i][e] * inv);
    }
    if (tx == 0) lse[(long long)bh * d.T + row] = m[i] + logf(lf);
  }
}

template <typename T, int kD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const Dims& d, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<kD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((d.T + kBQ - 1) / kBQ, d.B * d.H);
  flash_fwd_kernel<T, kD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, d);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, float* lse,
             const Dims& d, cudaStream_t stream) {
  if (d.D <= 32) return launch<T, 32>(q, k, v, o, lse, d, stream);
  if (d.D <= 64) return launch<T, 64>(q, k, v, o, lse, d, stream);
  if (d.D <= 128) return launch<T, 128>(q, k, v, o, lse, d, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace mxtpu_flash

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. strides: 12 element strides, (batch,
// head, row) of q, k, v and an unused fourth tensor. Returns
// cudaGetLastError() after the launch.
int mxtpu_flash_fwd(int dtype, const void* q, const void* k, const void* v,
                    void* o, void* lse, int B, int H, int KVH, int T, int S,
                    int D, int causal, int window, float scale,
                    const long long* strides, void* stream) {
  using namespace mxtpu_flash;
  const Dims d = make_dims(B, H, KVH, T, S, D, causal, window, scale, strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0) return dispatch<float>(q, k, v, o, l, d, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(q, k, v, o, l, d, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

MXTPU_DEFINE_ERROR_STRING
