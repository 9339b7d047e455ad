// Fused flash-attention backward for Hopper (sm_90a): one pass over (key
// tile, query tile) pairs computes the probabilities once and emits all
// three gradients, as the JAX package's opt-in fused backward does
// (MXTPU_FLASH_BWD=fused).
//
// Replaces the TPU kernel mxnet_tpu/ops/flash_attention.py::
// _flash_bwd_kernel (driven by _pallas_flash_bwd). Same function as the
// oracle's scan backward in _flash_bwd_rule and as flash_bwd.cu: with
// p = exp(scale * q.k - lse), dp = dO.v and ds = p * (dp - delta) * scale,
// where delta = rowsum(dO * O) in fp32 is computed by the wrapper,
//   dq = sum_k ds K,   dk = sum_q ds^T Q,   dv = sum_q p^T dO.
// Masks, layouts and grouped-query heads as in flash_common.cuh. Storage
// float32 or bfloat16; every product and sum in fp32.
//
// Design. One CUDA block per (batch * kv head, 64 key rows), the body the
// dk/dv kernel of flash_bwd.cu runs (flash_bwd_kv.cuh): it keeps K and V in
// shared memory and walks, for each query head of its group in turn, the
// query tiles that see its keys (q_tiles(): causal and window tiles are
// skipped whole). Per tile it forms s and dp, then p and ds in shared
// memory, and runs the three products that consume them: dv += p^T dO and
// dk += ds^T Q into registers (summed over the group in a fixed order,
// stored once), and the tile's dq contribution ds K, added with atomicAdd
// into a zeroed fp32 (B, H, T, D) workspace the wrapper allocates. That
// workspace takes the place of the TPU kernel's full-T VMEM scratch, which
// needs an ordered grid: here the blocks that share query rows run in
// parallel, in no order. For float32 storage the workspace is dq itself;
// for bfloat16 the wrapper rounds it.
//
// Determinism. dk and dv repeat bit for bit, like every other kernel of the
// port. dq does not: the order in which the key blocks' atomic adds land
// changes from run to run, so dq moves by fp32 rounding between runs.
//
// Bound on this card: 10 * T * S' * D operations per (batch, head), S' the
// visible keys (five products where flash_bwd.cu does 6 + 8), against
// reading Q, K, V, dO, O, LSE and delta once and writing the three
// gradients once. In fp32 on the CUDA cores (67 TFLOP/s) the operations
// bound it at every training shape the port runs (above ~20 flops per byte;
// at T = S = 8192, D = 128 over 1000). This first version runs on the CUDA
// cores in fp32 for both storage types (no wgmma, no TMA); its times are in
// PERF.md.

#include "flash_bwd_kv.cuh"

namespace mxtpu_flash {
namespace {

// K6: the key-tile body of flash_bwd_kv.cuh with dq.
template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_fused_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ g,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       float* __restrict__ dq, T* __restrict__ dk,
                       T* __restrict__ dv, Dims d) {
  bwd_kv_block<T, kD, true>(q, k, v, g, lse, delta, dq, dk, dv, d);
}

template <typename T, int kD>
int launch_fused(const void* q, const void* k, const void* v, const void* g,
                 const float* lse, const float* delta, float* dq, void* dk,
                 void* dv, const Dims& d, cudaStream_t stream) {
  constexpr size_t smem = kv_smem_bytes<kD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_fused_kernel<T, kD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((d.S + kBK - 1) / kBK, d.B * d.KVH);
  flash_bwd_fused_kernel<T, kD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g), lse, delta, dq,
      static_cast<T*>(dk), static_cast<T*>(dv), d);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_fused(const void* q, const void* k, const void* v,
                   const void* g, const float* lse, const float* delta,
                   float* dq, void* dk, void* dv, const Dims& d,
                   cudaStream_t s) {
  if (d.D <= 32)
    return launch_fused<T, 32>(q, k, v, g, lse, delta, dq, dk, dv, d, s);
  if (d.D <= 64)
    return launch_fused<T, 64>(q, k, v, g, lse, delta, dq, dk, dv, d, s);
  if (d.D <= 128)
    return launch_fused<T, 128>(q, k, v, g, lse, delta, dq, dk, dv, d, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace mxtpu_flash

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. strides: 12 element strides, (batch,
// head, row) of q, k, v and dO. lse, delta: (B, H, T) fp32. dq: a ZEROED
// fp32 (B, H, T, D) workspace the kernel adds into. dk and dv are
// (B, KVH, S, D) in the storage type, contiguous, summed over each kv
// head's group of query heads. Returns cudaGetLastError() after the launch.
int mxtpu_flash_bwd_fused(int dtype, const void* q, const void* k,
                          const void* v, const void* g, const void* lse,
                          const void* delta, void* dq, void* dk, void* dv,
                          int B, int H, int KVH, int T, int S, int D,
                          int causal, int window, float scale,
                          const long long* strides, void* stream) {
  using namespace mxtpu_flash;
  const Dims d = make_dims(B, H, KVH, T, S, D, causal, window, scale, strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  float* dqf = static_cast<float*>(dq);
  if (dtype == 0)
    return dispatch_fused<float>(q, k, v, g, l, dl, dqf, dk, dv, d, s);
  if (dtype == 1)
    return dispatch_fused<__nv_bfloat16>(q, k, v, g, l, dl, dqf, dk, dv, d,
                                         s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

MXTPU_DEFINE_ERROR_STRING
