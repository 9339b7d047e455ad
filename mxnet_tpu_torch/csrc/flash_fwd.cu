// Flash-attention forward for Hopper (sm_90a): O = softmax(scale * Q K^T) V
// and the fp32 log-sum-exp of every query row, without a T x S score matrix
// in device memory.
//
// Replaces the TPU kernel mxnet_tpu/ops/flash_attention.py::_flash_fwd_kernel
// (driven by _pallas_flash_fwd). Same function as its oracle _jnp_flash_fwd:
// dense, causal (bottom-right aligned), sliding window, and grouped-query
// heads read unrepeated (see flash_common.cuh for the layouts and the mask).
// Storage float32, bfloat16 or float16: O in the storage type, the LSE in
// fp32, P kept in fp32 for P V (the Pallas kernel's cast of P to V's type
// applies only on a TPU; the oracle keeps P in fp32).
//
// Bound on this card: 4 * T * S' * D operations per (batch, head), S' the
// visible keys, against reading Q, K, V once and writing O and the LSE. The
// products run on the tensor cores as 3xTF32 (flash_mma.cuh): three TF32
// products each, so the operations bound is 3 * ops over 495 TFLOP/s. At
// BERT-base's T = S = 128, D = 64 in fp32 that is 0.0195 ms against 0.0302
// ms of bytes (3.35 TB/s): bytes bound it. At Llama-3-8B's T = S = 8192,
// D = 128, causal, the operations do (3.33 ms a call).
//
// Design.
// - One block per (query tile, batch * head), numbered tile-major over a
//   1-D grid with the last query tile first: under a causal mask it walks
//   the most key tiles, so the short blocks fill the tail.
// - Warps own rows: each warp holds 16 query rows, so the online-softmax
//   state (running max m and sum l of a row) never leaves the warp and the
//   block needs no barrier between the softmax and P V. A block is 8 warps
//   (128 rows) at kD >= 64 and 4 warps (64 rows) at 32: at BERT-base's
//   T = 128 one block then reads each head's K and V once. At kD = 64, 4
//   warps (80 KB, 235 registers, no spill) and 8 warps alone on an SM
//   (no spill) were both slower there on an H100 than 2 blocks of 8 warps
//   (96 KB each, held to 128 registers, a few bytes of spill); at
//   kD = 128, 4 warps were slower at Llama-3-8B's shape.
// - Q sits in a swizzled shared tile, read per k-step with ldmatrix
//   (holding its split fragments in registers would take 128 of them at
//   kD = 128). K and V come through a two-stage cp.async ring of 64-key
//   tiles: the next tile's copy is in flight while this one is multiplied.
//   kv_tiles() skips the tiles no row of the block can see, and only the
//   tiles a warp's rows see in part are masked, score by score.
// - S = Q K^T: a 16 x 64 score tile per warp in mma C fragments. Row max
//   and row sum are two shuffles across the four lanes of a quad.
// - P V keeps P in registers: in the paired k order (lane t holds k = 2t
//   and 2t + 1) P's C fragment of keys 8j.. is already the A fragment of
//   k-step j (c0 -> a0, c2 -> a1, c1 -> a2, c3 -> a3). P is split into big
//   and small once per tile; V's B fragments come from the swizzled tile
//   with load_b_paired, conflict-free.
// - The tensor cores' fp32 accumulator truncates, so each tile's P V
//   product starts from zero and is added to acc * alpha with an ordinary
//   fp32 add; one mma chain over the whole walk would drift (see
//   zero_frags in flash_mma.cuh).
// - bf16 and fp16 storage: Q, K and V are exact in TF32 and their small
//   terms are skipped; P's stays.
// - Shared memory, fp32: Q plus two stages of K and V. 196,608 bytes at
//   kD = 128 (1 block, 8 warps per SM), 98,304 at 64 (2 blocks of 8
//   warps) and 40,960 at 32 (4 warps a block). mxtpu_flash_fwd_resources
//   reports the figures the runtime gives.

#include "flash_mma.cuh"

namespace mxtpu_flash {
namespace {

template <int kD>
__host__ __device__ constexpr int fwd_warps() {
  return kD >= 64 ? 8 : 4;
}

// the Q tile and two stages of K and V
template <int kD>
__host__ __device__ constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * (16 * fwd_warps<kD>() + 4 * kBK) * kD;
}

template <typename T, int kD>
__global__ void __launch_bounds__(32 * fwd_warps<kD>(),
                                  blocks_for(fwd_smem_bytes<kD>()))
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, Dims d) {
  constexpr int kRows = 16 * fwd_warps<kD>();  // query rows of a block
  constexpr int kNT = 32 * fwd_warps<kD>();    // threads of a block
  constexpr int kN = kD / 8;     // 8-dim C fragments of a warp's O rows
  constexpr int kS = kBK / 8;    // 8-key C fragments of its score rows
  constexpr int kJ = 4;          // O fragments formed at once in P V
  constexpr bool kSmall = sizeof(T) == 4;  // 16-bit storage is exact in TF32
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(16) float smem[];
  float* q_t = smem;               // kRows x kD
  float* ring = q_t + kRows * kD;  // 2 x (K, V): kBK x kD each

  const int nbh = d.B * d.H;
  const int n_qt = (d.T + kRows - 1) / kRows;
  const int qt = n_qt - 1 - (int)(blockIdx.x / nbh);
  const int bh = (int)(blockIdx.x % nbh);
  const int b = bh / d.H;
  const int h = bh - b * d.H;
  const int kvh = h / (d.H / d.KVH);
  const int q0 = qt * kRows;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g8 = lane >> 2;
  const int tq = lane & 3;
  const int m0 = 16 * (tid >> 5);  // the warp's rows in the Q tile
  const int r0 = q0 + m0;          // and in the sequence

  load_tile_async<kD, kNT>(q_t, q + b * d.q_s[0] + h * d.q_s[1], d.q_s[2],
                           q0, kRows, d.T, d.D, tid);
  const T* kb = k + b * d.k_s[0] + kvh * d.k_s[1];
  const T* vb = v + b * d.v_s[0] + kvh * d.v_s[1];

  int lo, hi;
  kv_tiles(d, q0, min(q0 + kRows, d.T), &lo, &hi);
  auto issue = [&](int kt, int st) {
    float* k_s = ring + 2 * st * kBK * kD;
    load_tile_async<kD, kNT>(k_s, kb, d.k_s[2], kt * kBK, kBK, d.S, d.D,
                             tid);
    load_tile_async<kD, kNT>(k_s + kBK * kD, vb, d.v_s[2], kt * kBK, kBK,
                             d.S, d.D, tid);
  };
  if (lo < hi) issue(lo, 0);
  cp_async_commit();

  // rows r0 + g8 (i = 0) and r0 + g8 + 8 (i = 1) of the lane
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[kN][4];
  zero_frags<kN>(acc);
  const int off = d.S - d.T;

  for (int kt = lo; kt < hi; ++kt) {
    const int st = (kt - lo) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile kt landed; tile kt - 1 fully consumed
    if (kt + 1 < hi) issue(kt + 1, st ^ 1);
    cp_async_commit();
    const float* k_s = ring + 2 * st * kBK * kD;
    const float* v_s = k_s + kBK * kD;
    const int c0 = kt * kBK;

    // s = Q K^T: the warp's 16 rows x the tile's 64 keys
    float s[kS][4];
    zero_frags<kS>(s);
#pragma unroll
    for (int k0 = 0; k0 < kD; k0 += 8) {
      FragA aq;
      load_a<kD>(aq, q_t, m0, k0, lane);
#pragma unroll
      for (int j = 0; j < kS; j += 2) {
        FragB bk[2];
        load_b_t2<kD>(bk[0], bk[1], k_s, 8 * j, k0, lane);
        mma_3xtf32<kSmall, kSmall>(s[j], aq, bk[0]);
        mma_3xtf32<kSmall, kSmall>(s[j + 1], aq, bk[1]);
      }
    }

    // Scale, and mask where some of the warp's rows see only part of the
    // tile (the first row bounds the causal edge, the last the window's).
    const bool whole =
        c0 + kBK <= d.S &&
        (!d.causal || (c0 + kBK - 1 <= r0 + off &&
                       (d.window == 0 || r0 + 15 + off - c0 < d.window)));
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kS; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[j][2 * i + e] * d.scale;
          if (!whole)
            x = masked_score(d, r0 + g8 + 8 * i, c0 + 8 * j + 2 * tq + e, x);
          s[j][2 * i + e] = x;
          mx[i] = fmaxf(mx[i], x);
        }
    // column c0 < S is in every visited tile, so the new max is finite
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f((m[i] - m_new) * kLog2e);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kS; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f((s[j][2 * i + e] - m[i]) * kLog2e);
          s[j][2 * i + e] = p;
          rs[i] += p;
        }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l[i] = l[i] * alpha[i] + rs[i];
    }

    // P as the A fragments of the tile's 8 k-steps, split once
    FragA pa[kS];
#pragma unroll
    for (int j = 0; j < kS; ++j) {
      pa[j].set(0, s[j][0]);
      pa[j].set(1, s[j][2]);
      pa[j].set(2, s[j][1]);
      pa[j].set(3, s[j][3]);
    }

    // acc = acc * alpha + P V, the tile's product from zero, kJ O
    // fragments at a time
#pragma unroll
    for (int n = 0; n < kN; n += kJ) {
      float t[kJ][4];
      zero_frags<kJ>(t);
#pragma unroll
      for (int j = 0; j < kS; ++j)
#pragma unroll
        for (int jj = 0; jj < kJ; ++jj) {
          FragB bv;
          load_b_paired<kD>(bv, v_s, 8 * (n + jj), 8 * j, g8, tq);
          mma_3xtf32<true, kSmall>(t[jj], pa[j], bv);
        }
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) {
        acc[n + jj][0] = acc[n + jj][0] * alpha[0] + t[jj][0];
        acc[n + jj][1] = acc[n + jj][1] * alpha[0] + t[jj][1];
        acc[n + jj][2] = acc[n + jj][2] * alpha[1] + t[jj][2];
        acc[n + jj][3] = acc[n + jj][3] * alpha[1] + t[jj][3];
      }
    }
  }
  cp_async_wait_all();

  // O = acc / l in the storage type; LSE = m + log(l), once per row
  float lf[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) lf[i] = fmaxf(l[i], 1e-30f);
  const float inv0 = 1.f / lf[0], inv1 = 1.f / lf[1];
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    acc[j][0] *= inv0;
    acc[j][1] *= inv0;
    acc[j][2] *= inv1;
    acc[j][3] *= inv1;
  }
  store_frags<kN>(o + (long long)bh * d.T * d.D, acc, r0, d.T, d.D, 0, g8,
                  tq);
  if (tq == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + g8 + 8 * i;
      if (row < d.T) lse[(long long)bh * d.T + row] = m[i] + logf(lf[i]);
    }
  }
}

template <typename T, int kD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const Dims& d, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<kD>();
  constexpr int rows = 16 * fwd_warps<kD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((d.T + rows - 1) / rows) * d.B * d.H;
  flash_fwd_kernel<T, kD><<<grid, 32 * fwd_warps<kD>(), smem, stream>>>(
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

template <typename T>
int resources_for(int d_bucket, int* out) {
  if (d_bucket == 32)
    return kernel_resources(flash_fwd_kernel<T, 32>, fwd_smem_bytes<32>(),
                            32 * fwd_warps<32>(), out);
  if (d_bucket == 64)
    return kernel_resources(flash_fwd_kernel<T, 64>, fwd_smem_bytes<64>(),
                            32 * fwd_warps<64>(), out);
  if (d_bucket == 128)
    return kernel_resources(flash_fwd_kernel<T, 128>, fwd_smem_bytes<128>(),
                            32 * fwd_warps<128>(), out);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace mxtpu_flash

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. strides: 12 element
// strides, (batch, head, row) of q, k, v and an unused fourth tensor.
// Returns cudaGetLastError() after the launch.
int mxtpu_flash_fwd(int dtype, const void* q, const void* k, const void* v,
                    void* o, void* lse, int B, int H, int KVH, int T, int S,
                    int D, int causal, int window, float scale,
                    const long long* strides, void* stream) {
  using namespace mxtpu_flash;
  const Dims d = make_dims(B, H, KVH, T, S, D, causal, window, scale, strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  MXTPU_FLASH_DISPATCH(dispatch, q, k, v, o, l, d, s);
}

// dtype as above; d_bucket: 32, 64 or 128. out: registers per thread,
// static and dynamic shared bytes per block, blocks per SM at that dynamic
// size, local (spill) bytes per thread, threads per block.
int mxtpu_flash_fwd_resources(int dtype, int d_bucket, int* out) {
  using namespace mxtpu_flash;
  MXTPU_FLASH_DISPATCH(resources_for, d_bucket, out);
}

}  // extern "C"

MXTPU_DEFINE_ERROR_STRING
