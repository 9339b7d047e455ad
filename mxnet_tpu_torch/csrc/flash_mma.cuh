// Tensor-core products in fp32 accuracy for Hopper (sm_90a), and the
// shared-memory tiles that feed them: the pieces every flash-attention
// kernel is built from (flash_fwd.cu; flash_bwd.cu and flash_bwd_fused.cu
// through flash_bwd_kv.cuh).
//
// 3xTF32. A warp-level mma.sync.m16n8k8 takes TF32 operands (fp32 with 10
// explicit mantissa bits) and accumulates in fp32. Each fp32 operand x is
// split into big = tf32(x) and small = tf32(x - big), rounded to nearest
// with ties away from zero (cvt.rna's rounding); big + small holds 22 of
// x's 24 mantissa bits. A product then runs as three TF32 products into
// the same fp32 accumulator, small.big + big.small + big.big in that
// order, the order CUTLASS's OpMultiplyAddFastF32 uses (PyTorch's fp32
// memory-efficient attention on sm80+). The dropped small.small term and the
// missing bits are about 2^-22 of each product: fp32 accuracy at a third of
// the TF32 tensor-core rate (495 / 3 = 165 TFLOP/s dense on an H100 SXM)
// instead of the CUDA cores' 67. An operand known to be exact in TF32 (a
// bfloat16 value, 8 mantissa bits, or a float16 one, 10 bits with an
// exponent inside fp32's range) has small == 0: its correction term is
// skipped (kSmallA / kSmallB false), which changes no bit of the result.
//
// Why mma.sync and not wgmma: tf32 wgmma takes only K-major A and B, while
// three of the backward's five products contract over the query or key axis
// of row-major tiles (p^T dO, ds^T Q, ds K), and so does the forward's P V.
// mma.sync reads its fragments from shared memory by hand, in either
// orientation, and takes A from registers (the forward's P).
//
// Fragment layout of m16n8k8 .tf32 (g = lane >> 2, t = lane & 3):
//   A (16 x 8, row): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                    a3 (g + 8, t + 4)
//   B (8 x 8, col):  b0 (k = t, n = g), b1 (k = t + 4, n = g)
//   C (16 x 8):      c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//                    c3 (g + 8, 2t + 1)
// A product may permute k as long as A and B agree: the "paired" loaders
// below give lane t the k indices 2t and 2t + 1 instead of t and t + 4,
// which is what makes reads along the contracted rows conflict-free.
//
// Tiles. A walked or stationary tile is rows x kD fp32 in shared memory
// with row pitch kD (kD in {32, 64, 128}) and its 16-byte chunks XOR-
// swizzled by row: column c of row r lives at c ^ ((r & 7) << 2). A chunk
// stays whole, so cp.async copies 16 bytes at a time and ldmatrix reads 8
// rows of one chunk column from 8 different bank groups; and the paired
// loaders' pattern (row 2t + e, col g) hits 32 different banks.

#pragma once

#include <stdint.h>

#include "flash_common.cuh"

namespace mxtpu_flash {

// ---------------------------------------------------------------------------
// 3xTF32 products
// ---------------------------------------------------------------------------

// The TF32 value nearest x, ties away from zero, as fp32 bits with the 13
// low mantissa bits zero: what cvt.rna.tf32.f32 gives for every finite x
// below the largest TF32 value, done as an integer add of half the dropped
// bits and a mask. The cvt runs on the conversion pipe at a quarter of the
// integer rate, and with two splits per operand element K2 and K6 ran
// slower with it on an H100, for the same bits.
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small (to 2^-22 of x), both TF32
__device__ __forceinline__ void tf32_split(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_bits(x);
  small = tf32_bits(x - __uint_as_float(big));
}

template <int N>
struct Frag {
  uint32_t big[N], small[N];
  __device__ __forceinline__ void set(int i, float x) {
    tf32_split(x, big[i], small[i]);
  }
  // split the raw fp32 words ldmatrix left in small[]
  __device__ __forceinline__ void split_raw() {
#pragma unroll
    for (int i = 0; i < N; ++i)
      tf32_split(__uint_as_float(small[i]), big[i], small[i]);
  }
};
using FragA = Frag<4>;
using FragB = Frag<2>;

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += A B in fp32 accuracy: small.big, big.small, big.big
template <bool kSmallA, bool kSmallB>
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const FragA& a,
                                           const FragB& b) {
  if constexpr (kSmallA) mma_tf32(c, a.small, b.big);
  if constexpr (kSmallB) mma_tf32(c, a.big, b.small);
  mma_tf32(c, a.big, b.big);
}

// ---------------------------------------------------------------------------
// swizzled rows x kD fp32 tiles
// ---------------------------------------------------------------------------

template <int kD>
__device__ __forceinline__ int tile_idx(int r, int c) {
  return r * kD + (c ^ ((r & 7) << 2));
}

// ldmatrix.x4 of four 8-row x 4-fp32 blocks (16 bytes a row, whole
// chunks of the swizzled tile): lanes 8 i .. 8 i + 7 name the rows of block
// i, and each lane receives word t of row g of every block, which is the
// tf32 fragment layout (g, t). The 8 rows of a block sit in 8 different
// chunk columns, so the read is conflict-free.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const float* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// A fragment, rows m0.. of the tile, k = columns k0..k0+7 (plain order):
// blocks (rows +0, cols +0), (+8, +0), (+0, +4), (+8, +4)
template <int kD>
__device__ __forceinline__ void load_a(FragA& a, const float* t, int m0,
                                       int k0, int lane) {
  const int blk = lane >> 3;
  ldmatrix_x4(a.small, t + tile_idx<kD>(m0 + (lane & 7) + 8 * (blk & 1),
                                        k0 + 4 * (blk >> 1)));
  a.split_raw();
}

// B fragments of B = tile^T, B[k][n] = tile[n0 + n][k0 + k] (plain order),
// for n0 and n0 + 8: blocks (rows +0, cols +0), (+0, +4), (+8, +0), (+8, +4)
template <int kD>
__device__ __forceinline__ void load_b_t2(FragB& b0, FragB& b1,
                                          const float* t, int n0, int k0,
                                          int lane) {
  const int blk = lane >> 3;
  uint32_t r[4];
  ldmatrix_x4(r, t + tile_idx<kD>(n0 + (lane & 7) + 8 * (blk >> 1),
                                  k0 + 4 * (blk & 1)));
  b0.set(0, __uint_as_float(r[0]));
  b0.set(1, __uint_as_float(r[1]));
  b1.set(0, __uint_as_float(r[2]));
  b1.set(1, __uint_as_float(r[3]));
}

// B fragment of B = tile: B[k][n] = tile[k0 + k][n0 + n], k paired
template <int kD>
__device__ __forceinline__ void load_b_paired(FragB& b, const float* t,
                                              int n0, int k0, int g, int tq) {
  b.set(0, t[tile_idx<kD>(k0 + 2 * tq, n0 + g)]);
  b.set(1, t[tile_idx<kD>(k0 + 2 * tq + 1, n0 + g)]);
}

// ---------------------------------------------------------------------------
// the 64 x 64 p and ds tiles: written from C fragments (row g, col 2t + e),
// read as A of a product over their columns (row g, col 2t + e, paired) and
// over their rows (row 2t + e, col g, paired); this swizzle keeps all three
// on 32 different banks
// ---------------------------------------------------------------------------

constexpr int kPd = 64;

__device__ __forceinline__ int pd_idx(int r, int c) {
  return r * kPd + (c ^ ((r & 1) | ((r & 6) << 2)));
}

// A[m][k] = pd[m0 + m][k0 + k], k paired
__device__ __forceinline__ void load_a_pd(FragA& a, const float* t, int m0,
                                          int k0, int g, int tq) {
  a.set(0, t[pd_idx(m0 + g, k0 + 2 * tq)]);
  a.set(1, t[pd_idx(m0 + g + 8, k0 + 2 * tq)]);
  a.set(2, t[pd_idx(m0 + g, k0 + 2 * tq + 1)]);
  a.set(3, t[pd_idx(m0 + g + 8, k0 + 2 * tq + 1)]);
}

// A[m][k] = pd[k0 + k][m0 + m] (the transpose), k paired
__device__ __forceinline__ void load_a_pd_t(FragA& a, const float* t, int m0,
                                            int k0, int g, int tq) {
  a.set(0, t[pd_idx(k0 + 2 * tq, m0 + g)]);
  a.set(1, t[pd_idx(k0 + 2 * tq, m0 + g + 8)]);
  a.set(2, t[pd_idx(k0 + 2 * tq + 1, m0 + g)]);
  a.set(3, t[pd_idx(k0 + 2 * tq + 1, m0 + g + 8)]);
}

// ---------------------------------------------------------------------------
// asynchronous copies into the swizzled tiles
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(float* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows row0 .. row0 + rows - 1 of a (rows_total, D) matrix with the given
// row stride into a swizzled rows x kD fp32 tile; rows past rows_total and
// columns past D are zero. A float32 chunk of 4 columns that lies whole
// inside the matrix and is 16-byte aligned goes by cp.async (the caller
// commits and waits); a 16-bit type, a chunk that straddles D or an
// unaligned row is read and converted by the thread and stored directly.
template <int kD, int kThreadsPerTile, typename T>
__device__ __forceinline__ void load_tile_async(float* dst, const T* src,
                                                long long row_stride,
                                                int row0, int rows,
                                                int rows_total, int D,
                                                int tid) {
  constexpr int kChunks = kD / 4;
  for (int i = tid; i < rows * kChunks; i += kThreadsPerTile) {
    const int r = i / kChunks;
    const int c = (i - r * kChunks) * 4;
    float* out = dst + tile_idx<kD>(r, c);
    const int row = row0 + r;
    if (row >= rows_total || c >= D) {
      *reinterpret_cast<float4*>(out) = make_float4(0.f, 0.f, 0.f, 0.f);
      continue;
    }
    const T* in = src + (long long)row * row_stride + c;
    if constexpr (sizeof(T) == 4) {
      if (c + 4 <= D && (reinterpret_cast<uintptr_t>(in) & 15) == 0) {
        cp_async16(out, in);
        continue;
      }
    }
    float4 x;
    x.x = to_f(in[0]);
    x.y = c + 1 < D ? to_f(in[1]) : 0.f;
    x.z = c + 2 < D ? to_f(in[2]) : 0.f;
    x.w = c + 3 < D ? to_f(in[3]) : 0.f;
    *reinterpret_cast<float4*>(out) = x;
  }
}

// n fp32 values src[0 .. valid) into dst, zeros past valid, by cp.async
__device__ __forceinline__ void load_vec_async(float* dst, const float* src,
                                               int n, int valid, int tid,
                                               int nthreads) {
  for (int i = tid; i < n; i += nthreads) {
    if (i < valid)
      cp_async4(dst + i, src + i);
    else
      dst[i] = 0.f;
  }
}

// ---------------------------------------------------------------------------
// C fragments, launch shapes
// ---------------------------------------------------------------------------

// blocks of this many dynamic shared bytes that fit one SM's 228 KB (each
// block also holds 1 KB the runtime reserves), at most 2: the minimum the
// kernels ask the register allocator for
__host__ __device__ constexpr int blocks_for(size_t smem) {
  return (233472 / (smem + 1024)) >= 2 ? 2 : 1;
}

// The tensor cores add into an fp32 accumulator with truncation, so a sum
// chained through mma over thousands of rows drifts toward zero: past 1e-5
// of the largest dk over a group of 4 heads of 2048 rows, in the model of
// tests/test_torch_flash_tf32x3.py. Each tile's product therefore starts
// from zero and is added to the running sum with an ordinary
// (round-to-nearest) fp32 add.
template <int kN>
__device__ __forceinline__ void zero_frags(float (&acc)[kN][4]) {
#pragma unroll
  for (int j = 0; j < kN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}
template <int kN>
__device__ __forceinline__ void add_into(float (&sum)[kN][4],
                                         const float (&acc)[kN][4]) {
#pragma unroll
  for (int j = 0; j < kN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sum[j][e] += acc[j][e];
}

// Store C fragments acc (rows r0 + g8 (+ 8), columns nd + 8 j + 2 tq (+ 1))
// into a row-major (rows_total, D) matrix in the storage type.
template <int kN, typename T>
__device__ __forceinline__ void store_frags(T* out, const float (&acc)[kN][4],
                                            int r0, int rows_total, int D,
                                            int nd, int g8, int tq) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g8 + 8 * i;
    if (row >= rows_total) continue;
#pragma unroll
    for (int j = 0; j < kN; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = nd + 8 * j + 2 * tq + e;
        if (c < D) store(out + (long long)row * D + c, acc[j][2 * i + e]);
      }
  }
}

// Registers, static and dynamic shared memory, blocks per SM, local
// (spill) bytes and threads of one kernel at its launch configuration,
// into out[0..5].
template <typename K>
int kernel_resources(K* kernel, size_t smem, int threads, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)smem;
  out[3] = blocks;
  out[4] = (int)a.localSizeBytes;
  out[5] = threads;
  return 0;
}

}  // namespace mxtpu_flash
