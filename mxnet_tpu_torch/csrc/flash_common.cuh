// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu,
// flash_bwd_fused.cu): the problem geometry, the mask, the tile ranges a
// block walks, tile loads into shared memory and the thread layout of a
// 64 x 64 score tile, and the score and dp tiles the backward kernels share.
//
// Layouts. q and dO are (B, H, T, D), k and v (B, KVH, S, D), each with its
// own element strides for batch, head and row and a contiguous last dim;
// outputs (O, dq, dk, dv) are contiguous; lse and delta are (B, H, T) fp32.
// Query head h reads kv head h / (H / KVH), so grouped-query attention never
// needs repeated K/V.
//
// Mask (the JAX package's oracle, mxnet_tpu/ops/flash_attention.py
// _jnp_flash_fwd): with off = S - T, query row q sees key column c when
// c <= q + off (causal, bottom-right aligned) and q + off - c < window
// (window > 0; the wrapper forces causal on with a window). Masked scores
// are -1e30 as in the oracle; columns past S are -inf, so they never count.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mxtpu_flash {

constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 64;        // key rows per tile
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 scores each
constexpr int kLdP = kBK + 1;  // padded row of a score tile in shared memory
constexpr float kMasked = -1e30f;

struct Dims {
  int B, H, KVH, T, S, D;
  int causal, window;
  // 0 when some query row sees no key at all (causal with T > S): then every
  // tile is visited, so such rows get the oracle's uniform average
  int skip;
  float scale;
  // element strides (batch, head, row) of q, k, v and dO
  long long q_s[3], k_s[3], v_s[3], g_s[3];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// The score a (row q, column c) pair enters the softmax with, given its raw
// dot product times scale.
__device__ __forceinline__ float masked_score(const Dims& d, int q, int c,
                                              float s) {
  if (c >= d.S) return -INFINITY;
  if (d.causal) {
    const int rel = q + (d.S - d.T) - c;
    if (rel < 0 || (d.window > 0 && rel >= d.window)) return kMasked;
  }
  return s;
}

// Key tiles [*lo, *hi) that query rows [q0, q1) can see.
__device__ __forceinline__ void kv_tiles(const Dims& d, int q0, int q1,
                                         int* lo, int* hi) {
  *lo = 0;
  *hi = (d.S + kBK - 1) / kBK;
  if (!d.skip || !d.causal) return;
  const int off = d.S - d.T;
  const int c_last = q1 - 1 + off;  // >= 0 whenever skip is set
  *hi = min(*hi, c_last / kBK + 1);
  if (d.window > 0) {
    const int c_first = q0 + off - d.window + 1;
    if (c_first > 0) *lo = c_first / kBK;
  }
}

// Query tiles [*lo, *hi) that can see key columns [c0, c1).
__device__ __forceinline__ void q_tiles(const Dims& d, int c0, int c1,
                                        int* lo, int* hi) {
  *lo = 0;
  *hi = (d.T + kBQ - 1) / kBQ;
  if (!d.skip || !d.causal) return;
  const int off = d.S - d.T;
  const int q_first = max(0, c0 - off);
  int q_end = d.T;
  if (d.window > 0) q_end = min(q_end, c1 - 1 - off + d.window);
  *lo = q_first / kBQ;
  *hi = q_end > q_first ? (q_end + kBQ - 1) / kBQ : *lo;
}

// rows x kD tile starting at row0 of a (rows_total, D) matrix with the given
// row stride, into shared memory as fp32 with row pitch kD + 1; rows past the
// end and dims past D are zero.
template <int kD, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long row_stride, int row0,
                                          int rows, int rows_total, int D) {
  for (int i = threadIdx.x; i < rows * kD; i += kThreads) {
    const int r = i / kD;
    const int c = i - r * kD;
    float v = 0.f;
    if (row0 + r < rows_total && c < D)
      v = to_f(src[(long long)(row0 + r) * row_stride + c]);
    dst[r * (kD + 1) + c] = v;
  }
}

// acc[i][j] += sum_d A[ty + 16 i][d] * B[tx + 16 j][d] over both tiles' rows
// (pitch kD + 1): the 4 x 4 scores a thread owns. With the padded pitch the
// 16 lanes reading B rows hit 16 different banks.
template <int kD>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* A,
                                         const float* B, int ty, int tx) {
#pragma unroll 8
  for (int d = 0; d < kD; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * (kD + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * (kD + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
  }
}

// s = Q K^T and dp = dO V^T for the thread's 4 x 4 entries, both tiles of
// pitch kD + 1.
template <int kD>
__device__ __forceinline__ void score_and_dp(float (&s)[4][4],
                                             float (&dp)[4][4],
                                             const float* q_t,
                                             const float* g_t,
                                             const float* k_t,
                                             const float* v_t, int ty,
                                             int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
  tile_dot<kD>(s, q_t, k_t, ty, tx);
  tile_dot<kD>(dp, g_t, v_t, ty, tx);
}

// Reductions over the 16 lanes (tx) that share a row; a warp holds two rows.
__device__ __forceinline__ float row_max(float x) {
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The one routine every source exports for the wrapper's error messages.
#define MXTPU_DEFINE_ERROR_STRING                                 \
  extern "C" const char* mxtpu_cuda_error_string(int code) {      \
    return cudaGetErrorString(static_cast<cudaError_t>(code));    \
  }

inline Dims make_dims(int B, int H, int KVH, int T, int S, int D, int causal,
                      int window, float scale, const long long* strides) {
  Dims d;
  d.B = B; d.H = H; d.KVH = KVH; d.T = T; d.S = S; d.D = D;
  d.causal = causal || window > 0;
  d.window = window;
  d.skip = !(d.causal && T > S);
  d.scale = scale;
  for (int i = 0; i < 3; ++i) {
    d.q_s[i] = strides[i];
    d.k_s[i] = strides[3 + i];
    d.v_s[i] = strides[6 + i];
    d.g_s[i] = strides[9 + i];
  }
  return d;
}

}  // namespace mxtpu_flash
