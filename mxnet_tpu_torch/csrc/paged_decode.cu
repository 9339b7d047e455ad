// Paged decode attention for Hopper (sm_90a): one query token per sequence,
// K/V read from the paged block pool through per-sequence block tables.
//
// Replaces the TPU kernel mxnet_tpu/ops/flash_attention.py::_paged_decode_kernel
// (driven by _pallas_paged_decode). Same function: for each sequence b and
// query head h, out[b, h] = softmax(scale * q[b, h] . K[ctx]) . V[ctx] over the
// first lens[b] positions of the sequence, with K/V row p found at pool block
// tables[b, p / block_size], offset p % block_size, kv head h / (H / KVH).
// Online softmax in fp32 (running max m, running sum l, fp32 accumulator);
// masked columns score -1e30; l is floored at 1e-30; lens[b] == 0 gives zeros.
//
// Layouts (all contiguous): q, out (B, H, D); k_pool, v_pool
// (num_blocks, block_size, KVH, D) -- one layer's slice; tables (B, max_blocks)
// int32; lens (B,) int32. Storage type float32, bfloat16 or float16 (the
// same for q and the pools); all arithmetic in fp32.
//
// Design. One CUDA block per (sequence, kv head). It loads that head's
// `group = H / KVH` query rows once into shared memory, then walks the
// sequence's context in tiles of kTile positions: each warp fetches whole K/V
// rows (lanes across the head dim, so loads coalesce), resolving each row's
// pool block from the table itself -- there is no scalar prefetch. Scores are
// one thread per (query row, position), over K rows padded against bank
// conflicts; the softmax update is one warp per query row; the P.V update
// gives each thread fixed (row, dim) accumulator cells. Only the
// ceil(ctx / block_size) blocks the sequence uses are read.
//
// Bound on this card: the bytes of K and V for the positions in context,
// read once, over 3.35 TB/s (H100 SXM). The arithmetic is 4 * H * D flops per
// position against 2 * KVH * D * sizeof(T) bytes, far below the ridge point,
// so this is a memory-bound function. This first version cannot approach that
// bound at the serving slice's shape: B * KVH = 8 sequences x 1 kv head is 8
// CUDA blocks on 132 SMs, and each block walks its context serially. Splitting
// the context across blocks (flash-decoding), TMA loads and tuning are later
// work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kTile = 64;      // context positions per step of the walk
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) {
  return __half2float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store(__half* p, float x) {
  *p = __float2half_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const int* __restrict__ tables,
                    const int* __restrict__ lens, T* __restrict__ out, int H,
                    int KVH, int D, int block_size, int max_blocks,
                    float scale) {
  extern __shared__ float smem[];
  const int group = H / KVH;
  const int seq = blockIdx.x / KVH;
  const int kvh = blockIdx.x % KVH;
  float* q_s = smem;                   // group x D
  float* acc = q_s + group * D;        // group x D
  const int k_stride = D + 1;          // padded: see the score loop
  float* k_s = acc + group * D;        // kTile x k_stride
  float* v_s = k_s + kTile * k_stride; // kTile x D
  float* p_s = v_s + kTile * D;        // group x kTile
  float* m_s = p_s + group * kTile;    // group
  float* l_s = m_s + group;            // group
  float* alpha_s = l_s + group;        // group

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int kWarps = kThreads / 32;

  const size_t head0 = (size_t)seq * H + (size_t)kvh * group;
  const T* q_rows = q + head0 * D;
  for (int i = tid; i < group * D; i += kThreads) {
    q_s[i] = to_float(q_rows[i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < group; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  // The table covers at most max_blocks * block_size positions.
  const int ctx = min(max(lens[seq], 0), max_blocks * block_size);
  const int* table = tables + (size_t)seq * max_blocks;
  const size_t row_stride = (size_t)KVH * D;  // pool distance between tokens
  __syncthreads();

  for (int tile0 = 0; tile0 < ctx; tile0 += kTile) {
    const int valid = min(kTile, ctx - tile0);
    // K/V rows of this tile: one warp per row, lanes across the head dim.
    for (int t = warp; t < valid; t += kWarps) {
      const int pos = tile0 + t;
      const int blk = table[pos / block_size];
      const size_t row =
          ((size_t)blk * block_size + pos % block_size) * row_stride +
          (size_t)kvh * D;
      for (int d = lane; d < D; d += 32) {
        k_s[t * k_stride + d] = to_float(k_pool[row + d]);
        v_s[t * D + d] = to_float(v_pool[row + d]);
      }
    }
    __syncthreads();
    // Scores: one thread per (query row, position). K rows sit k_stride
    // floats apart in shared memory, so the 32 lanes of a warp (32
    // positions of one query row) read 32 different banks; q is a
    // broadcast. Masked columns score -1e30.
    for (int pair = tid; pair < group * kTile; pair += kThreads) {
      const int g = pair / kTile;
      const int t = pair - g * kTile;
      float s = kNegInf;
      if (t < valid) {
        const float* qr = q_s + g * D;
        const float* kr = k_s + t * k_stride;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        int d = 0;
        for (; d + 3 < D; d += 4) {
          a0 += qr[d] * kr[d];
          a1 += qr[d + 1] * kr[d + 1];
          a2 += qr[d + 2] * kr[d + 2];
          a3 += qr[d + 3] * kr[d + 3];
        }
        for (; d < D; ++d) a0 += qr[d] * kr[d];
        s = ((a0 + a1) + (a2 + a3)) * scale;
      }
      p_s[g * kTile + t] = s;
    }
    __syncthreads();
    // Online softmax update: one warp per query row.
    for (int g = warp; g < group; g += kWarps) {
      float* row = p_s + g * kTile;
      float mx = kNegInf;
      for (int t = lane; t < kTile; t += 32) mx = fmaxf(mx, row[t]);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.f;
      for (int t = lane; t < kTile; t += 32) {
        const float p = expf(row[t] - m_new);
        row[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
        alpha_s[g] = alpha;
      }
    }
    __syncthreads();
    // acc = acc * alpha + P . V (columns past `valid` have p == 0).
    for (int i = tid; i < group * D; i += kThreads) {
      const int g = i / D;
      const int d = i - g * D;
      const float* p = p_s + g * kTile;
      float a = acc[i] * alpha_s[g];
#pragma unroll 8
      for (int t = 0; t < valid; ++t) a += p[t] * v_s[t * D + d];
      acc[i] = a;
    }
    __syncthreads();
  }

  T* o = out + head0 * D;
  for (int i = tid; i < group * D; i += kThreads) {
    const float l = fmaxf(l_s[i / D], 1e-30f);
    store(o + i, ctx > 0 ? acc[i] / l : 0.f);
  }
}

size_t smem_bytes(int group, int D) {
  return sizeof(float) * ((size_t)2 * group * D + (size_t)kTile * (2 * D + 1) +
                          (size_t)group * kTile + (size_t)3 * group);
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* tables, const int* lens, void* out, int B, int H,
           int KVH, int D, int block_size, int max_blocks, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(H / KVH, D);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  paged_decode_kernel<T><<<B * KVH, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), tables, lens, static_cast<T*>(out), H,
      KVH, D, block_size, max_blocks, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory (bytes) one block of the kernel needs; the wrapper checks it
// against the card's per-block limit before launching.
size_t mxtpu_paged_decode_smem_bytes(int group, int D) {
  return smem_bytes(group, D);
}

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Returns cudaGetLastError()
// after launch.
int mxtpu_paged_decode(int dtype, const void* q, const void* k_pool,
                       const void* v_pool, const void* tables,
                       const void* lens, void* out, int B, int H, int KVH,
                       int D, int block_size, int max_blocks, float scale,
                       void* stream) {
  const int* t = static_cast<const int*>(tables);
  const int* l = static_cast<const int*>(lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, t, l, out, B, H, KVH, D,
                         block_size, max_blocks, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, t, l, out, B, H, KVH, D,
                                 block_size, max_blocks, scale, s);
  if (dtype == 2)
    return launch<__half>(q, k_pool, v_pool, t, l, out, B, H, KVH, D,
                          block_size, max_blocks, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* mxtpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
