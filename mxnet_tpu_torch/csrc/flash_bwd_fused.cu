// Fused flash-attention backward for Hopper (sm_90a): one pass over (key
// tile, query tile) pairs computes the probabilities once and emits all
// three gradients, as the JAX package's opt-in fused backward does
// (MXTPU_FLASH_BWD=fused).
//
// Replaces the TPU kernel mxnet_tpu/ops/flash_attention.py::
// _flash_bwd_kernel (:263), driven by _pallas_flash_bwd (:356). Same
// function as the oracle's scan backward in _flash_bwd_rule and as
// flash_bwd.cu: with p = exp(scale * q.k - lse), dp = dO.v and
// ds = p * (dp - delta) * scale, where delta = rowsum(dO * O) in fp32 is
// computed by the wrapper,
//   dq = sum_k ds K,   dk = sum_q ds^T Q,   dv = sum_q p^T dO.
// Masks, layouts and grouped-query heads as in flash_common.cuh. Storage
// float32, bfloat16 or float16; every product in fp32 accuracy (3xTF32,
// flash_mma.cuh), every sum in fp32.
//
// Design. One block of 8 warps per (64 key rows, batch * kv head), the
// body the dk/dv kernel of flash_bwd.cu runs (flash_bwd_kv.cuh): it keeps K
// and V in shared memory and walks the query tiles that see its keys
// (q_tiles(): causal and window tiles are skipped whole), from the last
// down, every query head of its group at each, through a two-stage
// cp.async ring. Per tile it forms s and dp on the tensor cores, writes p
// and ds once to shared memory, and runs the three products that consume
// them: dv += p^T dO and dk += ds^T Q into C fragments in registers (summed
// over the walk in a fixed order, stored once), and the tile's dq
// contribution ds K, added into a zeroed fp32 (B, H, T, D) workspace the
// wrapper allocates. That workspace takes the place of the TPU kernel's
// full-T VMEM scratch, which its sequential grid fills in ascending
// key-block order; here the blocks that share query rows run in parallel.
// For float32 storage the workspace is dq itself; for a 16-bit type the
// wrapper rounds it. Blocks are numbered tile-major over a 1-D grid, key
// tile 0 first: under a causal mask it walks the most query tiles (at
// T = 8192, 128 against the last tile's 1), so the short blocks fill the
// tail.
//
// Determinism. dk and dv repeat bit for bit, like every other kernel of the
// port, and so does dq: the blocks add into each query tile in ascending
// key-tile order, the reference's order. A zeroed int32 (B * H, query
// tiles) array the wrapper allocates counts, per query tile, the warps that
// have added into it; a warp of key tile kt waits (an acquire load) until
// the warps of the key tiles below kt that see the tile (its rank, from
// q_tiles()) have counted themselves, adds its 16 rows x kD / 2 columns
// with vector reductions (red.global.add.v4.f32), and counts itself with a
// release reduction (add_frags_in_turn). A block only ever waits on blocks
// of lower index, so the design relies on the card dispatching blocks in
// index order. What the order costs is the count more than the wait: a
// warp's release waits until its reductions are performed (PERF.md has
// the kernel's time on an H100 before and after).
//
// Bound on this card: 10 * T * S' * D operations per (batch, head), S' the
// visible keys (five products where flash_bwd.cu does 6 + 8), against
// reading Q, K, V, dO, O, LSE and delta once and writing the three
// gradients once. On the tensor cores as 3xTF32 that is 3 * 10 * T * S' * D
// over 495 TFLOP/s; at T = S = 8192, D = 128 the operations bound it (over
// 1000 flops per byte). Shared memory as in flash_bwd_kv.cuh: 230,400 bytes
// at kD = 128, one block of 8 warps per SM.

#include "flash_bwd_kv.cuh"

namespace mxtpu_flash {
namespace {

// K6: the key-tile body of flash_bwd_kv.cuh with dq.
template <typename T, int kD>
__global__ void __launch_bounds__(kThreads, blocks_for(kv_smem_bytes<kD>()))
flash_bwd_fused_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ g,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       float* __restrict__ dq, int* __restrict__ dq_turn,
                       T* __restrict__ dk, T* __restrict__ dv, Dims d) {
  const int nbh = d.B * d.KVH;
  bwd_kv_block<T, kD, true>(q, k, v, g, lse, delta, dq, dq_turn, dk, dv, d,
                            (int)(blockIdx.x / nbh), (int)(blockIdx.x % nbh));
}

template <typename T, int kD>
int launch_fused(const void* q, const void* k, const void* v, const void* g,
                 const float* lse, const float* delta, float* dq, int* turn,
                 void* dk, void* dv, const Dims& d, cudaStream_t stream) {
  constexpr size_t smem = kv_smem_bytes<kD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_fused_kernel<T, kD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((d.S + kBK - 1) / kBK) * d.B * d.KVH;
  flash_bwd_fused_kernel<T, kD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g), lse, delta, dq,
      turn, static_cast<T*>(dk), static_cast<T*>(dv), d);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_fused(const void* q, const void* k, const void* v,
                   const void* g, const float* lse, const float* delta,
                   float* dq, int* turn, void* dk, void* dv, const Dims& d,
                   cudaStream_t s) {
  if (d.D <= 32)
    return launch_fused<T, 32>(q, k, v, g, lse, delta, dq, turn, dk, dv, d,
                               s);
  if (d.D <= 64)
    return launch_fused<T, 64>(q, k, v, g, lse, delta, dq, turn, dk, dv, d,
                               s);
  if (d.D <= 128)
    return launch_fused<T, 128>(q, k, v, g, lse, delta, dq, turn, dk, dv, d,
                                s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int resources_for(int d_bucket, int* out) {
  if (d_bucket == 32)
    return kernel_resources(flash_bwd_fused_kernel<T, 32>,
                            kv_smem_bytes<32>(), kThreads, out);
  if (d_bucket == 64)
    return kernel_resources(flash_bwd_fused_kernel<T, 64>,
                            kv_smem_bytes<64>(), kThreads, out);
  if (d_bucket == 128)
    return kernel_resources(flash_bwd_fused_kernel<T, 128>,
                            kv_smem_bytes<128>(), kThreads, out);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace mxtpu_flash

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. strides: 12 element
// strides, (batch, head, row) of q, k, v and dO. lse, delta: (B, H, T) fp32.
// dq: a ZEROED fp32 (B, H, T, D) workspace the kernel adds into; dq_turn: a
// ZEROED int32 (B * H, ceil(T / 64)) array of turns. dk and dv are
// (B, KVH, S, D) in the storage type, contiguous, summed over each kv
// head's group of query heads. Returns cudaGetLastError() after the launch.
int mxtpu_flash_bwd_fused(int dtype, const void* q, const void* k,
                          const void* v, const void* g, const void* lse,
                          const void* delta, void* dq, void* dq_turn,
                          void* dk, void* dv,
                          int B, int H, int KVH, int T, int S, int D,
                          int causal, int window, float scale,
                          const long long* strides, void* stream) {
  using namespace mxtpu_flash;
  const Dims d = make_dims(B, H, KVH, T, S, D, causal, window, scale, strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  float* dqf = static_cast<float*>(dq);
  int* turn = static_cast<int*>(dq_turn);
  MXTPU_FLASH_DISPATCH(dispatch_fused, q, k, v, g, l, dl, dqf, turn, dk, dv,
                       d, s);
}

// kernel: 0, the one kernel; dtype as above; d_bucket: 32, 64 or 128.
// out: registers per thread, static and dynamic shared bytes per block,
// blocks per SM at that dynamic size, local (spill) bytes per thread,
// threads per block.
int mxtpu_flash_bwd_resources(int kernel, int dtype, int d_bucket, int* out) {
  using namespace mxtpu_flash;
  if (kernel != 0) return (int)cudaErrorInvalidValue;
  MXTPU_FLASH_DISPATCH(resources_for, d_bucket, out);
}

}  // extern "C"

MXTPU_DEFINE_ERROR_STRING
