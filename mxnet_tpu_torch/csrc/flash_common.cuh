// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu,
// flash_bwd_fused.cu): the problem geometry, the storage types, the mask
// and the tile ranges a block walks. Every kernel multiplies on the tensor
// cores through flash_mma.cuh.
//
// Layouts. q and dO are (B, H, T, D), k and v (B, KVH, S, D), each with its
// own element strides for batch, head and row and a contiguous last dim;
// outputs (O, dq, dk, dv) are contiguous; lse and delta are (B, H, T) fp32.
// Query head h reads kv head h / (H / KVH), so grouped-query attention never
// needs repeated K/V. Storage float32, bfloat16 or float16; every product
// and sum in fp32.
//
// Mask (the JAX package's oracle, mxnet_tpu/ops/flash_attention.py
// _jnp_flash_fwd): with off = S - T, query row q sees key column c when
// c <= q + off (causal, bottom-right aligned) and q + off - c < window
// (window > 0; the wrapper forces causal on with a window). Masked scores
// are -1e30 as in the oracle; columns past S are -inf, so they never count.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mxtpu_flash {

constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 64;        // key rows per tile
constexpr int kThreads = 256;  // 8 warps: a backward block
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
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store(__half* p, float x) {
  *p = __float2half_rn(x);
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

// Return FN<T>(...) for the storage type T that dtype names: 0 = float32,
// 1 = bfloat16, 2 = float16 (the wrappers' dtype codes).
#define MXTPU_FLASH_DISPATCH(FN, ...)                  \
  if (dtype == 0) return FN<float>(__VA_ARGS__);       \
  if (dtype == 1) return FN<__nv_bfloat16>(__VA_ARGS__); \
  if (dtype == 2) return FN<__half>(__VA_ARGS__);      \
  return (int)cudaErrorInvalidValue

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
