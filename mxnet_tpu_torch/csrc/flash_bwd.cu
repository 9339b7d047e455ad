// Flash-attention backward for Hopper (sm_90a), split in two kernels as the
// JAX package's default backward is: a dq pass and a dk/dv pass, both
// recomputing the probabilities from the forward's saved fp32 LSE.
//
// Replaces the TPU kernels mxnet_tpu/ops/flash_attention.py::
// _flash_bwd_dq_kernel (:457) and _flash_bwd_dkv_kernel (:505), driven by
// _pallas_flash_bwd_split (:555). Same function as the oracle's scan
// backward in _flash_bwd_rule: with p = exp(scale * q.k - lse), dp = dO.v
// and ds = p * (dp - delta) * scale, where delta = rowsum(dO * O) in fp32,
//   dq = sum_k ds K,   dk = sum_q ds^T Q,   dv = sum_q p^T dO.
// The dq kernel computes delta itself from the dO tile it holds and its
// rows of O (the TPU path's _bwd_preamble does it in XLA before the
// kernels) and writes it for the dk/dv kernel, launched next on the same
// stream. Masks, layouts and grouped-query heads as in flash_common.cuh.
// Storage float32, bfloat16 or float16; every product in fp32 accuracy
// (3xTF32), every sum in fp32, one rounding at the store.
//
// Bound on this card: 6 * T * S' * D operations in dq and 8 * T * S' * D in
// dk/dv per (batch, head), S' the visible keys, against reading Q, K, V, dO,
// O, LSE once (delta written by dq, read by dk/dv) and writing the
// gradients. The products run on the
// tensor cores as 3xTF32 (flash_mma.cuh), three TF32 products each, so the
// operations bound is 3 * ops over 495 TFLOP/s. At BERT-base's T = S = 128,
// D = 64 in fp32 the bytes (3.35 TB/s) bound both kernels; at long
// sequences the operations do.
//
// Design.
// - dq: one block of 8 warps per (64 query rows, batch * head). It keeps Q
//   and dO in shared memory; once they land, each warp forms delta of its
//   16 rows from dO and O (two lanes a row, products rounded and then
//   summed in fp32, as the torch expression rowsum(dO * O) does) and the
//   block writes it once per row, also where the rows see no key tile. It
//   then walks the visible key tiles (kv_tiles())
//   through a two-stage cp.async ring of K and V. Per tile each warp forms
//   a 16 x 32 corner of s and dp in mma C fragments, writes its ds to
//   shared memory, and after one barrier multiplies ds K for its 16 rows x
//   kD / 2 dims into a C-fragment accumulator: every dq value has one
//   owner, summed in a fixed order.
// - dk/dv: one block of 8 warps per (64 key rows, batch * kv head), the
//   body in flash_bwd_kv.cuh. It keeps K and V in shared memory and walks,
//   for each query head of its group in turn, the query tiles that see its
//   keys (q_tiles()) through the same ring. The group's sum of dk and dv
//   happens in registers, in a fixed order, with no atomics: the result is
//   deterministic, and K/V are never repeated.
// - Blocks are numbered tile-major over a 1-D grid with the tiles that walk
//   the most partners first (the last query tile for dq, key tile 0 for
//   dk/dv under a causal mask), so the short ones fill the tail.
// - Shared memory, fp32 (16-bit tiles are converted while stored): dq
//   212,992 bytes at kD = 128 (1 block, 8 warps per SM), 114,688 at 64 and
//   65,536 at 32 (2 blocks, 16 warps); dk/dv as in flash_bwd_kv.cuh (1
//   block at 128 and 64, 2 at 32). mxtpu_flash_bwd_resources reports the
//   figures the runtime gives.

#include "flash_bwd_kv.cuh"

namespace mxtpu_flash {
namespace {

template <int kD>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (6 * kBQ * kD + kBQ * kPd);
}

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads, blocks_for(dq_smem_bytes<kD>()))
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ g,
                    const T* __restrict__ o, const float* __restrict__ lse,
                    float* __restrict__ delta, T* __restrict__ dq, Dims d) {
  constexpr int kN = kD / 16;
  constexpr bool kSmall = sizeof(T) == 4;  // 16-bit storage is exact in TF32
  extern __shared__ __align__(16) float smem[];
  float* q_t = smem;                 // kBQ x kD
  float* g_t = q_t + kBQ * kD;       // kBQ x kD (dO)
  float* ring = g_t + kBQ * kD;      // 2 x (K, V): kBK x kD each
  float* ds_t = ring + 4 * kBK * kD; // kBQ x kPd

  const int nbh = d.B * d.H;
  const int n_qt = (d.T + kBQ - 1) / kBQ;
  const int qt = n_qt - 1 - (int)(blockIdx.x / nbh);
  const int bh = (int)(blockIdx.x % nbh);
  const int b = bh / d.H;
  const int h = bh - b * d.H;
  const int kvh = h / (d.H / d.KVH);
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const int g8 = (tid & 31) >> 2;
  const int tq = tid & 3;

  load_tile_async<kD, kThreads>(q_t, q + b * d.q_s[0] + h * d.q_s[1],
                                d.q_s[2], q0, kBQ, d.T, d.D, tid);
  load_tile_async<kD, kThreads>(g_t, g + b * d.g_s[0] + h * d.g_s[1],
                                d.g_s[2], q0, kBQ, d.T, d.D, tid);
  const T* kb = k + b * d.k_s[0] + kvh * d.k_s[1];
  const T* vb = v + b * d.v_s[0] + kvh * d.v_s[1];

  int lo, hi;
  kv_tiles(d, q0, min(q0 + kBQ, d.T), &lo, &hi);
  auto issue = [&](int kt, int st) {
    float* k_s = ring + 2 * st * kBK * kD;
    load_tile_async<kD, kThreads>(k_s, kb, d.k_s[2], kt * kBK, kBK, d.S,
                                  d.D, tid);
    load_tile_async<kD, kThreads>(k_s + kBK * kD, vb, d.v_s[2], kt * kBK,
                                  kBK, d.S, d.D, tid);
  };
  if (lo < hi) issue(lo, 0);
  cp_async_commit();

  const int lane = tid & 31;
  const int m0 = 16 * (w & 3);         // the warp's query rows
  const int n0 = 32 * (w >> 2);        // its keys in s and dp
  const int nd = (kD / 2) * (w >> 2);  // its dims in dq
  float l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + m0 + g8 + 8 * i;
    l[i] = row < d.T ? lse[(long long)bh * d.T + row] : 0.f;
  }

  // delta = rowsum(dO * O) of the warp's rows, lanes 2r and 2r + 1 on row
  // m0 + r; warps w and w + 4 share rows, and w < 4 writes them
  cp_async_wait_all();
  __syncthreads();  // Q and dO landed
  float dl[2];
  {
    const int r = m0 + (lane >> 1);
    const int row = q0 + r;
    float part = 0.f;
    if (row < d.T) {
      const T* orow = o + ((long long)bh * d.T + row) * d.D;
      for (int c = lane & 1; c < d.D; c += 2)
        part = __fadd_rn(part, __fmul_rn(g_t[tile_idx<kD>(r, c)],
                                         to_f(orow[c])));
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (w < 4 && (lane & 1) == 0 && row < d.T)
      delta[(long long)bh * d.T + row] = part;
    dl[0] = __shfl_sync(0xffffffffu, part, 2 * g8);
    dl[1] = __shfl_sync(0xffffffffu, part, 2 * g8 + 16);
  }
  float sum[kN][4], acc[kN][4];
  zero_frags<kN>(sum);

  for (int kt = lo; kt < hi; ++kt) {
    const int st = (kt - lo) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile kt landed; tile kt - 1 fully consumed
    if (kt + 1 < hi) issue(kt + 1, st ^ 1);
    cp_async_commit();
    const float* k_s = ring + 2 * st * kBK * kD;
    const float* v_s = k_s + kBK * kD;

    float s[4][4], dp[4][4];
    score_and_dp_mma<kD, kSmall>(s, dp, q_t, g_t, k_s, v_s, m0, n0,
                                 tid & 31);
    probs_to_smem<false, false>(d, s, dp, l, dl, nullptr, ds_t, q0, kt * kBK,
                                m0, n0, g8, tq);
    __syncthreads();
    pd_b_mma<kD, kN, kSmall, false>(acc, ds_t, k_s, m0, nd, g8, tq);
    add_into<kN>(sum, acc);
  }
  cp_async_wait_all();

  store_frags<kN>(dq + (long long)bh * d.T * d.D, sum, q0 + m0, d.T, d.D,
                  nd, g8, tq);
}

// The dk/dv kernel: the key-tile body of flash_bwd_kv.cuh without dq.
template <typename T, int kD>
__global__ void __launch_bounds__(kThreads, blocks_for(kv_smem_bytes<kD>()))
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ g,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, Dims d) {
  const int nbh = d.B * d.KVH;
  bwd_kv_block<T, kD, false>(q, k, v, g, lse, delta, nullptr, nullptr, dk,
                             dv, d,
                             (int)(blockIdx.x / nbh),
                             (int)(blockIdx.x % nbh));
}

template <typename T, int kD>
int launch_dq(const void* q, const void* k, const void* v, const void* g,
              const void* o, const float* lse, float* delta, void* dq,
              const Dims& d, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<kD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((d.T + kBQ - 1) / kBQ) * d.B * d.H;
  flash_bwd_dq_kernel<T, kD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const T*>(o), lse, delta, static_cast<T*>(dq), d);
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
  const unsigned grid = (unsigned)((d.S + kBK - 1) / kBK) * d.B * d.KVH;
  flash_bwd_dkv_kernel<T, kD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), d);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dq(const void* q, const void* k, const void* v, const void* g,
                const void* o, const float* lse, float* delta, void* dq,
                const Dims& d, cudaStream_t s) {
  if (d.D <= 32)
    return launch_dq<T, 32>(q, k, v, g, o, lse, delta, dq, d, s);
  if (d.D <= 64)
    return launch_dq<T, 64>(q, k, v, g, o, lse, delta, dq, d, s);
  if (d.D <= 128)
    return launch_dq<T, 128>(q, k, v, g, o, lse, delta, dq, d, s);
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

template <typename T, int kD>
int resources_of(int kernel, int* out) {
  if (kernel == 0)
    return kernel_resources(flash_bwd_dq_kernel<T, kD>, dq_smem_bytes<kD>(),
                            kThreads, out);
  return kernel_resources(flash_bwd_dkv_kernel<T, kD>, kv_smem_bytes<kD>(),
                          kThreads, out);
}

template <typename T>
int resources_for(int kernel, int d_bucket, int* out) {
  if (d_bucket == 32) return resources_of<T, 32>(kernel, out);
  if (d_bucket == 64) return resources_of<T, 64>(kernel, out);
  if (d_bucket == 128) return resources_of<T, 128>(kernel, out);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace mxtpu_flash

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. strides: 12 element
// strides, (batch, head, row) of q, k, v and dO. o: the forward's output,
// (B, H, T, D) contiguous in the storage type. lse: (B, H, T) fp32, read;
// delta: (B, H, T) fp32, written (rowsum(dO * O)) for mxtpu_flash_bwd_dkv.
// dq is (B, H, T, D), contiguous. Returns cudaGetLastError() after the
// launch.
int mxtpu_flash_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                       const void* g, const void* o, const void* lse,
                       void* delta, void* dq, int B, int H, int KVH, int T,
                       int S, int D, int causal, int window, float scale,
                       const long long* strides, void* stream) {
  using namespace mxtpu_flash;
  const Dims d = make_dims(B, H, KVH, T, S, D, causal, window, scale, strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  MXTPU_FLASH_DISPATCH(dispatch_dq, q, k, v, g, o, l, dl, dq, d, s);
}

// As mxtpu_flash_bwd_dq, with delta read (as mxtpu_flash_bwd_dq wrote it);
// dk and dv are (B, KVH, S, D), contiguous, summed over each kv head's
// group of query heads.
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
  MXTPU_FLASH_DISPATCH(dispatch_dkv, q, k, v, g, l, dl, dk, dv, d, s);
}

// kernel: 0 = dq, 1 = dk/dv; dtype as above; d_bucket: 32, 64 or 128. out:
// registers per thread, static and dynamic shared bytes per block, blocks
// per SM at that dynamic size, local (spill) bytes per thread, threads per
// block.
int mxtpu_flash_bwd_resources(int kernel, int dtype, int d_bucket, int* out) {
  using namespace mxtpu_flash;
  MXTPU_FLASH_DISPATCH(resources_for, kernel, d_bucket, out);
}

}  // extern "C"

MXTPU_DEFINE_ERROR_STRING
