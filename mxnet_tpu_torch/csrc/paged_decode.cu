// Paged decode attention for Hopper (sm_90a): one query token per sequence,
// K/V read from the paged block pool through per-sequence block tables.
//
// Replaces the TPU kernel mxnet_tpu/ops/flash_attention.py::_paged_decode_kernel
// (driven by _pallas_paged_decode). Same function: for each sequence b and
// query head h, out[b, h] = softmax(scale * q[b, h] . K[ctx]) . V[ctx] over the
// first lens[b] positions of the sequence, with K/V row p found at pool block
// tables[b, p / block_size], offset p % block_size, kv head h / (H / KVH).
// Online softmax in fp32 (running max m, running sum l, fp32 accumulator);
// masked columns score -1e30; l is floored at 1e-30; lens[b] == 0 gives zeros;
// the context is clamped to max_blocks * block_size.
//
// Layouts (all contiguous): q, out (B, H, D); k_pool, v_pool
// (num_blocks, block_size, KVH, D) -- one layer's slice; tables (B, max_blocks)
// int32; lens (B,) int32. Storage type float32, bfloat16 or float16 (the
// same for q and the pools); all arithmetic in fp32.
//
// Design: split-context flash-decoding, in two kernels.
//
// 1. The split kernel. Grid (nsplit, B * KVH * ceil(group / 16)), group =
//    H / KVH. A block takes up to 16 query rows of one (sequence, kv head)
//    and one range of its context: with ctx = min(lens[b], max_blocks *
//    block_size), every split spans per = ceil(ctx / nsplit) positions
//    rounded up to a multiple of block_size (whole pool blocks, one table
//    entry per block_size rows), split s covering [s * per, min(ctx,
//    (s + 1) * per)). The block reads lens itself, so the wrapper never
//    reads it on the host; nsplit is the wrapper's choice from the grid's
//    size and the card's SM count, never from lens. The block copies its
//    range 32 rows of K and V at a time through a two-stage cp.async ring
//    (16 bytes a thread, neighbouring threads on neighbouring addresses,
//    each row's pool block looked up in the table): chunk c + 1 is in flight
//    while chunk c is consumed. Its query rows sit in shared memory as fp32,
//    loaded once. Each warp owns 4 query rows for the whole range (warp w
//    rows w, w + 4, w + 8 and w + 12, so a group of 4 keeps 4 warps busy):
//    lane j scores position j of the chunk against them, the warp's shuffles give
//    the chunk's max and sum (the online softmax's m, l and alpha stay in
//    registers), and each lane keeps kD / 32 dims of the 4 rows'
//    accumulators in registers for P.V. Warps share only the ring, so a
//    chunk costs one barrier. The split writes its (m, l, acc[D]) to an fp32
//    workspace the wrapper allocates; a split with no positions writes
//    m = -1e30, l = 0 and no acc.
// 2. The combine kernel. One warp per (sequence, query head) reads the
//    splits in ascending order: M = max m, L = sum l e^(m - M),
//    O = sum acc e^(m - M) / max(L, 1e-30), skipping empty splits, and
//    zeros where lens == 0. The order is fixed, so a call repeats bit for
//    bit. Two kernels rather than the last block of each (sequence, kv
//    head) combining its 16 rows after an atomic ticket: on an H100 that
//    took longer at both of chip_smoke.py's shapes (PERF.md), and it needs
//    a ticket zeroed before every call.
//
// Bound on this card: bytes. Per position the function does 4 * H * D
// operations (q.k and p.v, a multiply and an add each) on 2 * KVH * D *
// sizeof(T) bytes of K and V: at the serving shape (H 16, KVH 1, D 128,
// fp32) 8192 operations on 1024 bytes, 8 a byte, under the fp32 ridge of
// 67 TFLOP/s / 3.35 TB/s = 20. So the K/V bytes read once over 3.35 TB/s
// bound it, tensor cores would not move it, and the scores and P.V stay fp32
// on the CUDA cores. The first version ran one block per (sequence, kv head)
// -- 8 blocks on 132 SMs at the serving shape, each walking its context
// serially; splitting the context gives the card two blocks per SM.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockRows = 16;              // query rows per block
constexpr int kRows = kBlockRows / kWarps;  // query rows per warp
constexpr int kChunk = 32;                  // positions per ring stage: a lane each
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

// 16 bytes from global to shared memory; bytes == 0 writes zeros instead
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// N values of T from shared memory (N * sizeof(T) bytes, aligned to that
// size when it is 4, 8 or 16) as fp32
template <typename T, int N>
__device__ __forceinline__ void load_vals(const T* p, float (&o)[N]) {
  constexpr int kBytes = N * (int)sizeof(T);
  if constexpr (kBytes == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = to_float(t[i]);
  } else if constexpr (kBytes == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = to_float(t[i]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = to_float(p[i]);
  }
}

// One ring row: kD values of T and 16 bytes of padding, so the 8 lanes of a
// quarter warp reading 16 bytes of 8 consecutive rows hit 8 different bank
// groups in the score loop.
template <typename T, int kD>
__host__ __device__ constexpr int ring_row() {
  return kD + 16 / (int)sizeof(T);
}

// q (fp32, kBlockRows x kD), p (fp32, kBlockRows x kChunk), then the ring:
// two stages of K and V, kChunk rows each
template <typename T, int kD>
__host__ __device__ constexpr size_t split_smem_bytes() {
  return sizeof(float) * (size_t)kBlockRows * (kD + kChunk) +
         sizeof(T) * (size_t)4 * kChunk * ring_row<T, kD>();
}

// ws: acc (B * H, nsplit, D) fp32, then (m, l) (B * H, nsplit, 2) fp32.
// vec: every row of the pools is 16-byte aligned and D * sizeof(T) is a
// multiple of 16, so rows are copied 16 bytes at a time.
template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                          const T* __restrict__ v_pool,
                          const int* __restrict__ tables,
                          const int* __restrict__ lens, float* __restrict__ ws,
                          int B, int H, int KVH, int D, int block_size,
                          int max_blocks, int nsplit, int vec, float scale) {
  constexpr int kVec = 16 / (int)sizeof(T);  // values in 16 bytes
  constexpr int kRow = ring_row<T, kD>();
  constexpr int kDL = kD / 32;  // dims per lane in P.V
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // kBlockRows x kD
  float* p_s = q_s + kBlockRows * kD;           // kBlockRows x kChunk
  T* ring = reinterpret_cast<T*>(p_s + kBlockRows * kChunk);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int group = H / KVH;
  const int parts = (group + kBlockRows - 1) / kBlockRows;
  const int split = blockIdx.x;
  const int seq = blockIdx.y / (KVH * parts);
  const int rest = blockIdx.y - seq * KVH * parts;
  const int kvh = rest / parts;
  const int r0 = (rest - kvh * parts) * kBlockRows;  // first row of the group
  const int rows = min(kBlockRows, group - r0);
  const size_t head0 = (size_t)seq * H + (size_t)kvh * group + r0;
  float* ml = ws + (size_t)B * H * nsplit * D;

  const int ctx = min(max(lens[seq], 0), max_blocks * block_size);
  const int per = ((ctx + nsplit - 1) / nsplit + block_size - 1) / block_size *
                  block_size;
  const int p0 = split * per;
  const int p1 = min(ctx, p0 + per);
  if (p0 >= p1) {  // the whole block leaves: no barrier is pending
    if (tid < rows) {
      ml[((head0 + tid) * nsplit + split) * 2] = kNegInf;
      ml[((head0 + tid) * nsplit + split) * 2 + 1] = 0.f;
    }
    return;
  }

  // Dims past D stay zero in q and in the ring, so the loops run over kD.
  if (D < kD) {
    for (int i = tid; i < 4 * kChunk * kRow; i += kThreads)
      store(ring + i, 0.f);
    __syncthreads();  // the zeroed ring before any copy lands in it
  }

  const int* table = tables + (size_t)seq * max_blocks;
  const size_t row_stride = (size_t)KVH * D;  // pool distance between tokens
  // rows c0 .. c0 + kChunk - 1 of the context into ring stage st; rows past
  // p1 are zeros
  auto issue = [&](int c0, int st) {
    T* k_s = ring + (size_t)st * 2 * kChunk * kRow;
    T* v_s = k_s + kChunk * kRow;
    const int valid = min(kChunk, p1 - c0);
    if (vec) {
      const int pieces = D / kVec;
      for (int i = tid; i < kChunk * pieces; i += kThreads) {
        const int t = i / pieces;
        const int e = (i - t * pieces) * kVec;
        size_t src = 0;
        if (t < valid) {
          const int pos = c0 + t;
          src = ((size_t)table[pos / block_size] * block_size +
                 pos % block_size) * row_stride + (size_t)kvh * D + e;
        }
        const int bytes = t < valid ? 16 : 0;
        cp_async16(k_s + t * kRow + e, k_pool + src, bytes);
        cp_async16(v_s + t * kRow + e, v_pool + src, bytes);
      }
    } else {
      for (int i = tid; i < kChunk * D; i += kThreads) {
        const int t = i / D;
        const int e = i - t * D;
        if (t < valid) {
          const int pos = c0 + t;
          const size_t src = ((size_t)table[pos / block_size] * block_size +
                              pos % block_size) * row_stride +
                             (size_t)kvh * D + e;
          k_s[t * kRow + e] = k_pool[src];
          v_s[t * kRow + e] = v_pool[src];
        } else {
          store(k_s + t * kRow + e, 0.f);
          store(v_s + t * kRow + e, 0.f);
        }
      }
    }
  };

  float m[kRows], l[kRows], acc[kRows][kDL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kDL; ++e) acc[r][e] = 0.f;
  }
  // warp w owns rows w, w + kWarps, ...; rows past `rows` compute zeros
  const bool has_rows = warp < rows;  // warp-uniform
  const float* q_w = q_s + warp * kD;
  float* p_w = p_s + warp * kRows * kChunk;

  const int chunks = (p1 - p0 + kChunk - 1) / kChunk;
  issue(p0, 0);
  cp_async_commit();
  // the query rows while the first chunk is in flight
  for (int i = tid; i < kBlockRows * kD; i += kThreads) {
    const int r = i / kD;
    const int d = i - r * kD;
    q_s[i] = (r < rows && d < D) ? to_float(q[(head0 + r) * D + d]) : 0.f;
  }
  for (int c = 0; c < chunks; ++c) {
    const int st = c & 1;
    cp_async_wait_all();
    __syncthreads();  // chunk c (and q) landed; every warp is done with c - 1
    if (c + 1 < chunks) issue(p0 + (c + 1) * kChunk, st ^ 1);
    cp_async_commit();
    if (!has_rows) continue;
    const T* k_s = ring + (size_t)st * 2 * kChunk * kRow;
    const T* v_s = k_s + kChunk * kRow;
    const int valid = min(kChunk, p1 - p0 - c * kChunk);

    // scores: lane j against row j of the chunk; q is a broadcast
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const T* k_row = k_s + lane * kRow;
#pragma unroll 4
    for (int d0 = 0; d0 < kD; d0 += kVec) {
      float kv[kVec];
      load_vals<T, kVec>(k_row + d0, kv);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int e = 0; e < kVec; e += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(
              q_w + r * kWarps * kD + d0 + e);
          s[r] += qv.x * kv[e] + qv.y * kv[e + 1] + qv.z * kv[e + 2] +
                  qv.w * kv[e + 3];
        }
      }
    }

    // online softmax over the chunk: one row at a time, across the lanes
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float sc = lane < valid ? s[r] * scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sc));
      const float p = expf(sc - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
      p_w[r * kChunk + lane] = p;
#pragma unroll
      for (int e = 0; e < kDL; ++e) acc[r][e] *= alpha;
    }
    __syncwarp();

    // P.V: the lane's dims lane * kDL .., rows past `valid` have p == 0 and
    // V == 0, so the walk goes in steps of 4
    for (int t0 = 0; t0 < valid; t0 += 4) {
      float pr[kRows][4];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 pv =
            *reinterpret_cast<const float4*>(p_w + r * kChunk + t0);
        pr[r][0] = pv.x;
        pr[r][1] = pv.y;
        pr[r][2] = pv.z;
        pr[r][3] = pv.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[kDL];
        load_vals<T, kDL>(v_s + (t0 + u) * kRow + lane * kDL, vv);
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int e = 0; e < kDL; ++e) acc[r][e] += pr[r][u] * vv[e];
      }
    }
  }
  cp_async_wait_all();

  if (!has_rows) return;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = r * kWarps + warp;
    if (row >= rows) break;
    const size_t at = (head0 + row) * nsplit + split;
    float* a = ws + at * D;
#pragma unroll
    for (int e = 0; e < kDL; ++e) {
      const int d = lane * kDL + e;
      if (d < D) a[d] = acc[r][e];
    }
    if (lane == 0) {
      ml[at * 2] = m[r];
      ml[at * 2 + 1] = l[r];
    }
  }
}

// One warp per (sequence, query head): the splits in ascending order. The
// lanes first find M over the splits and each split's weight e^(m - M) (0
// for an empty split) into shared memory, nsplit at a time; then every lane
// walks the splits in ascending order for L and for its dims of O, eight
// splits' loads in flight at a time.
template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
paged_decode_combine_kernel(const float* __restrict__ ws,
                            const int* __restrict__ lens, T* __restrict__ out,
                            int B, int H, int D, int max_ctx, int nsplit) {
  constexpr int kDL = kD / 32;
  constexpr int kSplitsAStep = 8;  // splits whose loads are in flight at once
  extern __shared__ float w_s[];  // kWarps x (weight, l * weight) x nsplit
  const int bh = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (bh >= B * H) return;  // no block barrier below
  const int lane = threadIdx.x & 31;
  T* o = out + (size_t)bh * D;
  if (min(max(lens[bh / H], 0), max_ctx) == 0) {
    for (int d = lane; d < D; d += 32) store(o + d, 0.f);
    return;
  }
  const float* acc = ws + (size_t)bh * nsplit * D;
  const float* ml = ws + (size_t)B * H * nsplit * D + (size_t)bh * nsplit * 2;
  float mx = kNegInf;
  for (int s = lane; s < nsplit; s += 32) mx = fmaxf(mx, ml[2 * s]);
  const float M = warp_max(mx);
  float* w = w_s + (threadIdx.x >> 5) * 2 * nsplit;
  for (int s = lane; s < nsplit; s += 32) {
    const float l = ml[2 * s + 1];
    const float wt = l > 0.f ? expf(ml[2 * s] - M) : 0.f;  // empty: no acc
    w[s] = wt;
    w[nsplit + s] = l * wt;
  }
  __syncwarp();
  float L = 0.f;
  float sum[kDL];
#pragma unroll
  for (int e = 0; e < kDL; ++e) sum[e] = 0.f;
  for (int s0 = 0; s0 < nsplit; s0 += kSplitsAStep) {
    float a[kSplitsAStep][kDL];
#pragma unroll
    for (int u = 0; u < kSplitsAStep; ++u) {
      const bool use = s0 + u < nsplit && w[s0 + u] != 0.f;
#pragma unroll
      for (int e = 0; e < kDL; ++e) {
        const int d = lane + 32 * e;
        a[u][e] = use && d < D ? acc[(size_t)(s0 + u) * D + d] : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kSplitsAStep; ++u) {
      if (s0 + u >= nsplit || w[s0 + u] == 0.f) continue;
      L += w[nsplit + s0 + u];
#pragma unroll
      for (int e = 0; e < kDL; ++e) sum[e] += a[u][e] * w[s0 + u];
    }
  }
  const float denom = fmaxf(L, 1e-30f);
#pragma unroll
  for (int e = 0; e < kDL; ++e) {
    const int d = lane + 32 * e;
    if (d < D) store(o + d, sum[e] / denom);
  }
}

// Both kernels on one stream: the split kernel, then the combine.
template <typename T, int kD>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* tables, const int* lens, float* ws, void* out, int B,
           int H, int KVH, int D, int block_size, int max_blocks, int nsplit,
           float scale, cudaStream_t stream) {
  constexpr size_t smem = split_smem_bytes<T, kD>();
  // the split kernel's shared memory can pass the 48 KB default (76 KB in
  // fp32 at kD = 128): raise its limit once per device
  static unsigned long long raised = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (!(raised >> dev & 1ull)) {
    err = cudaFuncSetAttribute(paged_decode_split_kernel<T, kD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    raised |= 1ull << dev;
  }
  const int parts = (H / KVH + kBlockRows - 1) / kBlockRows;
  const int vec = (size_t)D * sizeof(T) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(k_pool) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(v_pool) % 16 == 0;
  const dim3 grid((unsigned)nsplit, (unsigned)(B * KVH * parts));
  paged_decode_split_kernel<T, kD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), tables, lens, ws, B, H, KVH, D,
      block_size, max_blocks, nsplit, vec, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned cgrid = (unsigned)((B * H + kWarps - 1) / kWarps);
  paged_decode_combine_kernel<T, kD>
      <<<cgrid, kThreads, sizeof(float) * kWarps * 2 * nsplit, stream>>>(
          ws, lens, static_cast<T*>(out), B, H, D, max_blocks * block_size,
          nsplit);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k_pool, const void* v_pool,
             const int* tables, const int* lens, float* ws, void* out, int B,
             int H, int KVH, int D, int block_size, int max_blocks,
             int nsplit, float scale, cudaStream_t s) {
  if (D <= 32)
    return launch<T, 32>(q, k_pool, v_pool, tables, lens, ws, out, B, H, KVH,
                         D, block_size, max_blocks, nsplit, scale, s);
  if (D <= 64)
    return launch<T, 64>(q, k_pool, v_pool, tables, lens, ws, out, B, H, KVH,
                         D, block_size, max_blocks, nsplit, scale, s);
  if (D <= 128)
    return launch<T, 128>(q, k_pool, v_pool, tables, lens, ws, out, B, H,
                          KVH, D, block_size, max_blocks, nsplit, scale, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
size_t smem_for(int D) {
  if (D <= 32) return split_smem_bytes<T, 32>();
  if (D <= 64) return split_smem_bytes<T, 64>();
  return split_smem_bytes<T, 128>();
}

}  // namespace

extern "C" {

// Shared memory (bytes) one block of the split kernel takes at a storage
// type (dtype as below) and head dim: the same for every group size.
size_t mxtpu_paged_decode_smem_bytes(int dtype, int D) {
  if (dtype == 0) return smem_for<float>(D);
  if (dtype == 1) return smem_for<__nv_bfloat16>(D);
  return smem_for<__half>(D);
}

// The split kernel, then the combine kernel, on `stream`. dtype: 0 =
// float32, 1 = bfloat16, 2 = float16. ws: fp32 workspace of
// B * H * nsplit * (D + 2) values, written by the first and read by the
// second. Returns the first launch's error, else cudaGetLastError() after
// the second.
int mxtpu_paged_decode(int dtype, const void* q, const void* k_pool,
                       const void* v_pool, const void* tables,
                       const void* lens, void* ws, void* out, int B, int H,
                       int KVH, int D, int block_size, int max_blocks,
                       int nsplit, float scale, void* stream) {
  const int* t = static_cast<const int*>(tables);
  const int* l = static_cast<const int*>(lens);
  float* w = static_cast<float*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k_pool, v_pool, t, l, w, out, B, H, KVH, D,
                           block_size, max_blocks, nsplit, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k_pool, v_pool, t, l, w, out, B, H,
                                   KVH, D, block_size, max_blocks, nsplit,
                                   scale, s);
  if (dtype == 2)
    return dispatch<__half>(q, k_pool, v_pool, t, l, w, out, B, H, KVH, D,
                            block_size, max_blocks, nsplit, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* mxtpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
