// Fused 1x1-convolution (matmul) + BatchNorm-statistics kernels for Hopper
// (sm_90a): the forward K4 and its backward K5 (dW and dX).
//
// Replaces the TPU kernels of mxnet_tpu/ops/fused_conv_bn.py:
//   _fwd_kernel (driven by _fused_fwd_pallas)  -> mxtpu_fused_fwd
//   _dw_kernel  (driven by _fused_bwd_pallas)  -> mxtpu_fused_dw
//   _dx_kernel  (driven by _fused_bwd_pallas)  -> mxtpu_fused_dx
// Same functions as their oracles _fused_fwd_reference and
// _fused_bwd_reference, cast for cast (mm = the storage type of x):
//   forward  xa = round_mm(relu?(x * scale + shift))      (prologue optional)
//            acc = xa @ w in fp32; y = round_mm(acc);
//            ysum[n] = sum_m acc[m, n], yssq[n] = sum_m acc[m, n]^2
//   backward dY = round_mm((dy + dsum[n]) + (2 y) * dssq[n])
//            dW = xa^T dY in fp32, stored in w's type
//            dxa = dY w^T in fp32; without a prologue dx = round_mm(dxa);
//            with one, dxa = 0 where relu cut (x * scale + shift <= 0),
//            dx = round_mm(dxa * scale), dscale[k] = sum_m dxa * x,
//            dbias[k] = sum_m dxa
// x (M, K), w (K, N), y and dy (M, N), all row-major and contiguous, in
// float32, bfloat16 or float16; scale, shift, dsum, dssq and the statistics
// are fp32.
// The prologue and dY are formed with __fmul_rn/__fadd_rn in the oracle's
// order, so no FMA contraction makes them differ from the plain version
// before the rounding to mm.
//
// The TPU kernels carry the column statistics (and dW's contraction over M)
// in VMEM scratch across a sequential grid; here blocks run in no order, so
// nothing is carried and no float atomics are used:
//   - K4 and dX write one partial (sum, sum of squares / dscale, dbias) per
//     128-row tile to a workspace, summed in the block in a fixed order, and
//     reduce_pairs() then sums the tiles in a fixed order;
//   - dW splits M into S contiguous ranges (enough blocks to fill the card
//     once when K x N is small: at K = N = 64, M = 401408 one tile would
//     walk all rows on one SM), writes S partial dW tiles and
//     reduce_splits() sums them in split order. S follows the card's SM
//     count, so it is fixed for a card and a shape.
// Every result is therefore the same from run to run. One call of each
// launcher enqueues its tile kernel and its reduction on the given stream.
//
// Bound on this card: 2 M K N operations against reading x, w (dy, y) once
// and writing y (dx, dW) once. All three kernels multiply on the tensor
// cores as 3xTF32 mma.sync.m16n8k8 (flash_mma.cuh: each fp32 operand split
// into TF32 big + small parts, small.big + big.small + big.big into an fp32
// accumulator), which keeps fp32 accuracy at 495 / 3 TFLOP/s; a bf16 or
// fp16 operand is exact in TF32, so its small part is zero and one TF32
// product does the same work. At ResNet-50's nine 1x1 shapes in fp32 that
// puts K4's bound at 2.8152 ms per training step (30 calls): the bytes bind
// at K = N = 64 and where K or N is 64 and the other 256 (3.35 TB/s), the
// operations at the six shapes with K, N >= 128 (the CUDA cores' 67 TFLOP/s
// would make it 5.7546 ms).
//
// Every kernel: a block of 8 warps owns a 128 x 64 output tile, each warp
// 32 x 32 of it (2 x 4 mma tiles). The contraction advances in k-tiles of
// 32 through a cp.async ring, so the copies of later k-tiles are in flight
// while the tensor cores work on this one. The tensor-core accumulator
// truncates, so each mma step's product starts from zero and is added to
// the running sums with an ordinary fp32 add (warp_ktile).
//   - K4 contracts over K: xa (M, K) is K-major, a 128 x 32 tile in
//     flash_mma.cuh's tile_idx swizzle read by ldmatrix (load_a); w (K, N)
//     is MN-major, k-tile rows of 64 columns in mn_idx() swizzle
//     (load_b_mn). On the training path (fp32, no prologue: every
//     ResNet-50 call) nothing needs forming, so the raw fp32 operands land
//     by cp.async straight in their swizzled tiles, a three-stage ring with
//     one barrier per k-tile. With a prologue or 16-bit storage, a
//     two-stage ring of the raw operands feeds a form pass (below) that
//     builds the fp32 tiles. The epilogue stores y from the C fragments
//     (four consecutive columns a thread, one vector store) and takes the
//     column sum and sum of squares of the fp32 sums: each thread's rows,
//     a fixed shuffle tree over the warp's row groups, the 4 warp rows in
//     order, one partial pair per 128-row tile.
//   - K5's dX contracts over N, along which dY (M, N) and w (K, N) are both
//     contiguous: its tiles are K-major as K4's xa.
//   - K5's dW contracts over M, along which x and dY are both strided (MN-
//     major; tf32 wgmma takes only K-major operands, hence mma.sync): its
//     tiles are k-tile rows of 128 or 64 columns in mn_idx() swizzle. The
//     larger of K and N lies on the 128 side (kSwap: dW^T = dY^T xa).
// K5 always forms: a two-stage ring copies the raw operands (dy, y and x
// or w, in their storage type, 16 bytes at a time where a row is 16-byte
// aligned, else 4-byte copies or plain loads); once a stage lands, a form
// pass turns it into fp32 tiles in shared memory: dY (form_dy, rounded to
// mm), xa (the prologue, rounded to mm), w, and zeros outside the
// matrices. The stage is refilled as soon as it is formed, before the
// products, so both stages are in flight while the tensor cores work.
// Shared memory in fp32: 72 KB for K4, 104 KB for dX, 105.5 KB for dW with
// K < N, 89.5 KB for dW with K >= N: two blocks (16 warps) per SM, at most
// 128 registers a thread and no local memory. mxtpu_fused_resources
// reports what the runtime gives each kernel.

#include "flash_mma.cuh"

namespace mxtpu_fcbn {
namespace {

namespace fm = mxtpu_flash;
using fm::store;
using fm::to_f;

constexpr int kBM = 128;        // output rows per tile
constexpr int kBN = 64;         // output columns per tile
constexpr int kThreads = 256;   // 8 warps of 32 x 32 outputs each
constexpr int kRedRows = 16;    // reduce_pairs: tile stripes per column
constexpr int kDwBlocksPerSm = 2;  // dW: resident blocks (launch bounds)
constexpr int kKC = 32;         // contraction per k-tile (4 mma steps)
constexpr int kStages = 2;      // ring depth where a form pass runs
constexpr int kFwdStages = 3;   // K4's ring depth where none runs

// The value rounded to the storage type T (round to nearest even).
template <typename T>
__device__ __forceinline__ float rnd(float x);
template <>
__device__ __forceinline__ float rnd<float>(float x) { return x; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
template <>
__device__ __forceinline__ float rnd<__half>(float x) {
  return __half2float(__float2half_rn(x));
}

// x * scale + shift, relu, in the oracle's order (no FMA contraction).
template <bool kRelu>
__device__ __forceinline__ float prologue(float v, float s, float t) {
  v = __fadd_rn(__fmul_rn(v, s), t);
  return kRelu ? fmaxf(v, 0.f) : v;
}

// (dy + dsum) + (2 y) * dssq, in the oracle's order.
__device__ __forceinline__ float form_dy(float dy, float y, float ds,
                                         float dq) {
  return __fadd_rn(__fadd_rn(dy, ds), __fmul_rn(2.f * y, dq));
}

// out0[c] = sum_t part[t][0][c], out1[c] = sum_t part[t][1][c], over the
// tiles in a fixed order: stripe r of a column takes tiles r, r + 16, ...,
// then the 16 stripe sums are added in order.
__global__ void __launch_bounds__(32 * kRedRows)
reduce_pairs(const float* __restrict__ part, float* __restrict__ out0,
             float* __restrict__ out1, int tiles, int ncols) {
  __shared__ float red[2][kRedRows][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float a = 0.f, b = 0.f;
  if (c < ncols) {
#pragma unroll 8
    for (int t = threadIdx.y; t < tiles; t += kRedRows) {
      a += part[(2LL * t) * ncols + c];
      b += part[(2LL * t + 1) * ncols + c];
    }
  }
  red[0][threadIdx.y][threadIdx.x] = a;
  red[1][threadIdx.y][threadIdx.x] = b;
  __syncthreads();
  if (threadIdx.y == 0 && c < ncols) {
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int r = 0; r < kRedRows; ++r) {
      sa += red[0][r][threadIdx.x];
      sb += red[1][r][threadIdx.x];
    }
    out0[c] = sa;
    out1[c] = sb;
  }
}

// ---------------------------------------------------------------------------
// staging, form pass and 3xTF32 warp tiles (K4 and K5)
// ---------------------------------------------------------------------------

template <int kN>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kN) : "memory");
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Rows row0 .. row0 + kRows - 1 and columns col0 .. col0 + kW - 1 of a
// row-major matrix (row stride ld, rows_end rows, cols_end columns) into a
// dense kRows x kW tile of T by cp.async: 16 bytes at a time where the
// chunk lies whole inside the matrix and the rows are 16-byte aligned
// (vec), else element by element (4-byte copies for fp32, loads and stores
// for the 16-bit types). Each thread copies one chunk column, rows
// kRowStep apart, from one base address. Elements outside the matrix are
// not written: the form pass replaces them with zeros.
template <int kRows, int kW, typename T>
__device__ __forceinline__ void stage_raw(T* dst, const T* src, long long ld,
                                          long long row0, long long rows_end,
                                          int col0, int cols_end, bool vec,
                                          int tid) {
  constexpr int kE = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int kPerRow = kW / kE;
  constexpr int kRowStep = kThreads / kPerRow;  // between a thread's rows
  const int r0 = tid / kPerRow, c = (tid % kPerRow) * kE;
  const int col = col0 + c;
  if (col >= cols_end) return;
  const T* in0 = src + (row0 + r0) * ld + col;
  const long long step = kRowStep * ld;
#pragma unroll
  for (int j = 0; j < (kRows * kPerRow + kThreads - 1) / kThreads; ++j) {
    const int r = r0 + j * kRowStep;
    if (r >= kRows || row0 + r >= rows_end) continue;
    T* out = dst + r * kW + c;
    const T* in = in0 + j * step;
    if (vec && col + kE <= cols_end) {
      fm::cp_async16(reinterpret_cast<float*>(out), in);
      continue;
    }
    for (int e = 0; e < kE && col + e < cols_end; ++e) {
      if constexpr (sizeof(T) == 4)
        fm::cp_async4(reinterpret_cast<float*>(out + e), in + e);
      else
        out[e] = in[e];
    }
  }
}

// Four consecutive raw values as fp32.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
template <typename T>
__device__ __forceinline__ void load4(const T* p, float (&v)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = to_f(p[e]);
}

// MN-major fp32 tile: kKC rows along the contraction, kW columns; the
// 16-byte chunk j of row r lives at chunk j ^ 2 (r & 3). The fragment
// reads below (8 bytes at rows t and t + 4, columns 2 g) then hit 32
// different banks in each half-warp, and chunks stay whole for the form
// pass's 16-byte stores.
template <int kW>
__device__ __forceinline__ int mn_idx(int r, int c) {
  return r * kW + (c ^ ((r & 3) << 3));
}

// The m16 x k8 A fragment of an MN-major tile with its rows paired:
// A[r][k] = tile[k0 + k][p0 + 2 g + h] for r = g + 8 h, so a0/a1 and a2/a3
// are each one 8-byte read. The C fragment's row g + 8 h is then tile row
// p0 + 2 g + h.
template <int kW>
__device__ __forceinline__ void load_a_mn(fm::FragA& a, const float* t,
                                          int p0, int k0, int g, int tq) {
  const float2 lo =
      *reinterpret_cast<const float2*>(t + mn_idx<kW>(k0 + tq, p0 + 2 * g));
  const float2 hi = *reinterpret_cast<const float2*>(
      t + mn_idx<kW>(k0 + tq + 4, p0 + 2 * g));
  a.set(0, lo.x);
  a.set(1, lo.y);
  a.set(2, hi.x);
  a.set(3, hi.y);
}

// The k8 x n8 B fragments of two interleaved n8 tiles of an MN-major tile:
// B_jj[k][n] = tile[k0 + k][n0 + 2 n + jj] (jj = 0 for b0, 1 for b1), two
// 8-byte reads. The C fragment's column n of tile jj is then tile column
// n0 + 2 n + jj.
template <int kW>
__device__ __forceinline__ void load_b_mn(fm::FragB& b0, fm::FragB& b1,
                                          const float* t, int n0, int k0,
                                          int g, int tq) {
  const float2 lo =
      *reinterpret_cast<const float2*>(t + mn_idx<kW>(k0 + tq, n0 + 2 * g));
  const float2 hi = *reinterpret_cast<const float2*>(
      t + mn_idx<kW>(k0 + tq + 4, n0 + 2 * g));
  b0.set(0, lo.x);
  b0.set(1, hi.x);
  b1.set(0, lo.y);
  b1.set(1, hi.y);
}

// d = A B from a zero accumulator (C given as 0, no register to clear)
__device__ __forceinline__ void mma_tf32_from_zero(float (&d)[4],
                                                   const uint32_t (&a)[4],
                                                   const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// sum[i][j] += the warp's product over one k-tile for its mma tiles (rows
// + 16 i, columns + 8 j) in fp32 accuracy; load_a(a, 16 i, k8) and
// load_b(b0, b1, 16 jp, k8) fetch the fragments. kSmall: the operands have
// TF32 small parts (fp32 storage). The tensor cores' accumulator truncates:
// with four mma steps (twelve mma) chained before the fp32 add, the
// ResNet-50 gradient moved 1.6e-4 of its largest value from the float64
// run, farther than the fp32 plain version's 1.1e-4 (PERF.md). So
// each mma step's product (small.big + big.small + big.big, the small
// terms first, CUTLASS's order) starts from zero and is added to the
// running sum with an ordinary, round-to-nearest fp32 add. The eight
// tiles' products are issued product by product, so eight independent
// chains keep the tensor cores busy. The loop over the mma steps stays
// rolled: unrolled, the compiler hoists the next step's fragments and the
// fp32 kernels spill 36 to 84 bytes a thread at 128 registers.
template <bool kSmall, typename LA, typename LB>
__device__ __forceinline__ void warp_ktile(float (&sum)[2][4][4], LA load_a,
                                           LB load_b) {
#pragma unroll 1
  for (int k8 = 0; k8 < kKC; k8 += 8) {
    fm::FragA a[2];
    fm::FragB b[4];
    load_a(a[0], 0, k8);
    load_a(a[1], 16, k8);
    load_b(b[0], b[1], 0, k8);
    load_b(b[2], b[3], 16, k8);
    float d[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma_tf32_from_zero(d[i][j], kSmall ? a[i].small : a[i].big,
                           b[j].big);
    if constexpr (kSmall) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          fm::mma_tf32(d[i][j], a[i].big, b[j].small);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) fm::mma_tf32(d[i][j], a[i].big, b[j].big);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[i][j][e] += d[i][j][e];
  }
}

// ---------------------------------------------------------------------------
// K4: y = xa @ w with the column statistics of the fp32 sums
// ---------------------------------------------------------------------------

// fp32 storage and no prologue: the tiles are the raw operands, nothing to
// form (every call of the training path)
template <typename T, bool kPro>
__host__ __device__ constexpr bool fwd_direct() {
  return sizeof(T) == 4 && !kPro;
}

// Direct: kFwdStages stages of the fp32 tiles (xa 128 x 32, w 32 x 64).
// Formed: the fp32 tiles once, then kStages raw stages of x and w in T.
template <typename T, bool kPro>
__host__ __device__ constexpr size_t fwd_smem_bytes() {
  return fwd_direct<T, kPro>()
             ? kFwdStages * kKC * (kBM + kBN) * sizeof(float)
             : kKC * (kBM + kBN) * (sizeof(float) + kStages * sizeof(T));
}

// Rows row0 .. row0 + kRows - 1 and columns col0 .. col0 + kW - 1 of a
// row-major fp32 matrix (row stride ld, rows_end rows, cols_end columns)
// into an fp32 tile that keeps element (r, c) at idx(r, c), 16-byte chunks
// whole: by one 16-byte cp.async where the chunk lies whole inside the
// matrix and the rows are 16-byte aligned (vec), else by 4-byte cp.async
// element by element; zeros outside the matrix are stored directly. Each
// thread copies one chunk column, rows kRowStep apart.
template <int kRows, int kW, typename Idx>
__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          long long ld, long long row0,
                                          long long rows_end, int col0,
                                          int cols_end, bool vec, int tid,
                                          Idx idx) {
  constexpr int kPerRow = kW / 4;
  constexpr int kRowStep = kThreads / kPerRow;
  const int r0 = tid / kPerRow, c = (tid % kPerRow) * 4;
  const int col = col0 + c;
  const float* in0 = src + (row0 + r0) * ld + col;
#pragma unroll
  for (int j = 0; j < kRows / kRowStep; ++j) {
    const int r = r0 + j * kRowStep;
    float* out = dst + idx(r, c);
    const float* in = in0 + j * kRowStep * ld;
    if (row0 + r >= rows_end || col >= cols_end) {
      *reinterpret_cast<float4*>(out) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else if (vec && col + 4 <= cols_end) {
      fm::cp_async16(out, in);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (col + e < cols_end)
          fm::cp_async4(out + e, in + e);
        else
          out[e] = 0.f;
      }
    }
  }
}

// Two values into p[0], p[1] of a 16-bit type by one 4-byte store.
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// v[0 .. 4) into p[0 .. 4) in T: by vector stores where vec and all four
// lie inside the row (room: the row's columns from p on), else one by one.
__device__ __forceinline__ void store4(float* p, const float (&v)[4],
                                       int room, bool vec) {
  if (vec && room >= 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (c < room) p[c] = v[c];
}
template <typename T>
__device__ __forceinline__ void store4(T* p, const float (&v)[4], int room,
                                       bool vec) {
  if (vec && room >= 4) {
    store2(p, v[0], v[1]);
    store2(p + 2, v[2], v[3]);
    return;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (c < room) store(p + c, v[c]);
}

// The warp's products over one k-tile: xa (a_t) K-major, w (b_t) MN-major.
template <bool kSmall>
__device__ __forceinline__ void fwd_products(float (&sum)[2][4][4],
                                             const float* a_t,
                                             const float* b_t, int wr, int wc,
                                             int lane) {
  const int g = lane >> 2, tq = lane & 3;
  warp_ktile<kSmall>(
      sum,
      [&](fm::FragA& a, int i16, int k8) {
        fm::load_a<kKC>(a, a_t, wr + i16, k8, lane);
      },
      [&](fm::FragB& b0, fm::FragB& b1, int j16, int k8) {
        load_b_mn<kBN>(b0, b1, b_t, wc + j16, k8, g, tq);
      });
}

// The block owns y's rows m0 .. m0 + 127 and columns n0 .. n0 + 63 and
// writes its partial (sum, sum of squares) pair of those columns to
// part[(blockIdx.y * 2 + {0, 1}) * N + n].
template <typename T, bool kPro, bool kRelu>
__global__ void __launch_bounds__(kThreads, 2)
fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
           const float* __restrict__ scale, const float* __restrict__ shift,
           T* __restrict__ y, float* __restrict__ part, int M, int K, int N) {
  constexpr bool kSmall = sizeof(T) == 4;  // 16-bit storage is exact in TF32
  constexpr int kTile = kKC * (kBM + kBN);  // xa and w tiles, elements
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int n0 = blockIdx.x * kBN;
  const long long m0 = (long long)blockIdx.y * kBM;
  const int steps = (K + kKC - 1) / kKC;
  const bool vec_x = aligned16(x) && (K * sizeof(T)) % 16 == 0;
  const bool vec_w = aligned16(w) && (N * sizeof(T)) % 16 == 0;

  const int wr = 32 * (warp & 3), wc = 32 * (warp >> 2);
  float sum[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) fm::zero_frags<4>(sum[i]);

  if constexpr (fwd_direct<T, kPro>()) {
    const float* xf = reinterpret_cast<const float*>(x);
    const float* wf = reinterpret_cast<const float*>(w);
    auto issue = [&](int s) {
      float* a_t = smem + (s % kFwdStages) * kTile;
      const int k0 = s * kKC;
      stage_f32<kBM, kKC>(a_t, xf, K, m0, M, k0, K, vec_x, tid,
                          [](int r, int c) { return fm::tile_idx<kKC>(r, c); });
      stage_f32<kKC, kBN>(a_t + kBM * kKC, wf, N, k0, K, n0, N, vec_w, tid,
                          [](int r, int c) { return mn_idx<kBN>(r, c); });
    };
#pragma unroll
    for (int s = 0; s < kFwdStages - 1; ++s) {
      if (s < steps) issue(s);
      fm::cp_async_commit();
    }
    for (int s = 0; s < steps; ++s) {
      cp_async_wait<kFwdStages - 2>();
      __syncthreads();  // stage s landed; every warp is done with s - 1
      if (s + kFwdStages - 1 < steps) issue(s + kFwdStages - 1);
      fm::cp_async_commit();
      const float* a_t = smem + (s % kFwdStages) * kTile;
      fwd_products<kSmall>(sum, a_t, a_t + kBM * kKC, wr, wc, lane);
    }
  } else {
    float* a_t = smem;             // kBM x kKC xa, K-major (tile_idx)
    float* b_t = a_t + kBM * kKC;  // kKC x kBN w, MN-major (mn_idx)
    T* ring = reinterpret_cast<T*>(smem + kTile);
    auto issue = [&](int s) {
      T* st = ring + (s % kStages) * kTile;
      const int k0 = s * kKC;
      stage_raw<kBM, kKC>(st, x, K, m0, M, k0, K, vec_x, tid);
      stage_raw<kKC, kBN>(st + kBM * kKC, w, N, k0, K, n0, N, vec_w, tid);
    };
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      if (s < steps) issue(s);
      fm::cp_async_commit();
    }
    // each thread forms the same 4 columns of xa and of w at every step
    const int cx = (tid % (kKC / 4)) * 4, cw = (tid % (kBN / 4)) * 4;
    for (int s = 0; s < steps; ++s) {
      cp_async_wait<kStages - 1>();
      __syncthreads();  // stage s landed; the fp32 tiles are free again
      const T* st = ring + (s % kStages) * kTile;
      const int k = s * kKC + cx;
      float sc[4], sh[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[e] = kPro && k + e < K ? scale[k + e] : 0.f;
        sh[e] = kPro && k + e < K ? shift[k + e] : 0.f;
      }
#pragma unroll
      for (int r = tid / (kKC / 4); r < kBM; r += kThreads / (kKC / 4)) {
        float v[4];
        load4(st + r * kKC + cx, v);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (kPro) v[e] = rnd<T>(prologue<kRelu>(v[e], sc[e], sh[e]));
          if (m0 + r >= M || k + e >= K) v[e] = 0.f;
        }
        *reinterpret_cast<float4*>(a_t + fm::tile_idx<kKC>(r, cx)) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
#pragma unroll
      for (int r = tid / (kBN / 4); r < kKC; r += kThreads / (kBN / 4)) {
        float v[4];
        load4(st + kBM * kKC + r * kBN + cw, v);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (s * kKC + r >= K || n0 + cw + e >= N) v[e] = 0.f;
        *reinterpret_cast<float4*>(b_t + mn_idx<kBN>(r, cw)) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
      __syncthreads();  // the fp32 tiles are formed, stage s is free
      if (s + kStages < steps) issue(s + kStages);
      fm::cp_async_commit();
      fwd_products<kSmall>(sum, a_t, b_t, wr, wc, lane);
    }
  }
  cp_async_wait<0>();

  // y, and each thread's column sums over its 4 rows. With load_b_mn's
  // interleaved columns, C element (g + 8 h, 2 tq + b) of mma tile (i, j)
  // is tile row wr + 16 i + g + 8 h, column wc + 16 (j / 2) + 4 tq + 2 b +
  // j % 2: for each pair of n8 tiles a thread holds 4 consecutive columns
  // of a row, column c = 2 b + j % 2 of them in sum[i][j][2 h + b].
  const bool vec_y = aligned16(y) && (N * sizeof(T)) % 16 == 0;
  float cs[2][4] = {}, cq[2][4] = {};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = m0 + wr + 16 * i + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        float v[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          v[c] = sum[i][2 * jp + (c & 1)][2 * h + (c >> 1)];
          cs[jp][c] += v[c];
          cq[jp][c] = fmaf(v[c], v[c], cq[jp][c]);
        }
        const int n = n0 + wc + 16 * jp + 4 * tq;
        store4(y + m * N + n, v, N - n, vec_y);
      }
    }

  // over the warp's 8 row groups (lanes of one tq) by a fixed shuffle tree,
  // then over the 4 warps of a column range in order, into the tile's pair
#pragma unroll
  for (int jp = 0; jp < 2; ++jp)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        cs[jp][c] += __shfl_xor_sync(0xffffffffu, cs[jp][c], o);
        cq[jp][c] += __shfl_xor_sync(0xffffffffu, cq[jp][c], o);
      }
  __syncthreads();  // every warp is done reading the tiles
  float* red = smem;  // [4 warp rows][2][kBN]
  if (g == 0) {
#pragma unroll
    for (int jp = 0; jp < 2; ++jp)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = wc + 16 * jp + 4 * tq + c;
        red[((warp & 3) * 2 + 0) * kBN + col] = cs[jp][c];
        red[((warp & 3) * 2 + 1) * kBN + col] = cq[jp][c];
      }
  }
  __syncthreads();
  if (tid < 2 * kBN) {
    const int which = tid / kBN, col = tid % kBN;
    float t = 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r) t += red[(r * 2 + which) * kBN + col];
    if (n0 + col < N)
      part[((long long)blockIdx.y * 2 + which) * N + n0 + col] = t;
  }
}

// ---------------------------------------------------------------------------
// K5 dW: dW = xa^T dY over one split [m_lo, m_hi) of the rows
// ---------------------------------------------------------------------------

// kSwap = false: tile rows are k (xa's columns), columns n; kSwap = true:
// tile rows are n, columns k. The fp32 tiles, the block's column vectors
// (scale and shift of x's WX columns, dsum and dssq of dY's WY), then the
// ring; a raw stage holds x (kKC x WX), dy and y (kKC x WY).
template <typename T, bool kSwap>
__host__ __device__ constexpr size_t dw_smem_bytes() {
  return kStages * kKC * (kSwap ? kBN + 2 * kBM : kBM + 2 * kBN) * sizeof(T) +
         kKC * (kBM + kBN) * sizeof(float) + 2 * (kBM + kBN) * sizeof(float);
}

// Partial p of split s lands at ws[s * K * N + k * N + n].
template <typename T, bool kPro, bool kRelu, bool kSwap>
__global__ void __launch_bounds__(kThreads, 2)
dw_kernel(const T* __restrict__ x, const T* __restrict__ dy,
          const T* __restrict__ y, const float* __restrict__ dsum,
          const float* __restrict__ dssq, const float* __restrict__ scale,
          const float* __restrict__ shift, float* __restrict__ ws, int M,
          int K, int N, int chunk) {
  constexpr bool kSmall = sizeof(T) == 4;  // 16-bit storage is exact in TF32
  constexpr int WX = kSwap ? kBN : kBM, WY = kSwap ? kBM : kBN;
  constexpr int kStage = kKC * (WX + 2 * WY);  // raw elements per stage
  extern __shared__ __align__(16) float smem[];
  float* a_t = smem;               // kKC x kBM, MN-major
  float* b_t = a_t + kKC * kBM;    // kKC x kBN, MN-major
  float* vx = b_t + kKC * kBN;     // scale, shift of the block's x columns
  float* vy = vx + 2 * WX;         // dsum, dssq of its dY columns
  T* ring = reinterpret_cast<T*>(vy + 2 * WY);
  float* xa_t = kSwap ? b_t : a_t;
  float* dy_t = kSwap ? a_t : b_t;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int r0 = blockIdx.y * kBM;  // first tile row (k, or n if kSwap)
  const int c0 = blockIdx.x * kBN;  // first tile column
  const int kc0 = kSwap ? c0 : r0;  // first column of x
  const int nc0 = kSwap ? r0 : c0;  // first column of dy and y
  const long long m_lo = (long long)blockIdx.z * chunk;
  const long long m_hi = min((long long)M, m_lo + chunk);
  const int steps = (int)((m_hi - m_lo + kKC - 1) / kKC);
  const bool vec_x = aligned16(x) && (K * sizeof(T)) % 16 == 0;
  const bool vec_y =
      aligned16(dy) && aligned16(y) && (N * sizeof(T)) % 16 == 0;

  auto issue = [&](int s) {
    T* st = ring + (s % kStages) * kStage;
    const long long m = m_lo + (long long)s * kKC;
    stage_raw<kKC, WX>(st, x, K, m, m_hi, kc0, K, vec_x, tid);
    stage_raw<kKC, WY>(st + kKC * WX, dy, N, m, m_hi, nc0, N, vec_y, tid);
    stage_raw<kKC, WY>(st + kKC * (WX + WY), y, N, m, m_hi, nc0, N, vec_y,
                       tid);
  };
#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    if (s < steps) issue(s);
    fm::cp_async_commit();
  }

  // each thread forms the same 4 columns of xa and of dY at every step
  const int cx = (tid % (WX / 4)) * 4, cy = (tid % (WY / 4)) * 4;
  for (int i = tid; i < WX; i += kThreads) {
    const int k = kc0 + i;
    vx[i] = kPro && k < K ? scale[k] : 0.f;
    vx[WX + i] = kPro && k < K ? shift[k] : 0.f;
  }
  for (int i = tid; i < WY; i += kThreads) {
    const int n = nc0 + i;
    vy[i] = n < N ? dsum[n] : 0.f;
    vy[WY + i] = n < N ? dssq[n] : 0.f;
  }

  const int wr = 32 * (warp & 3), wc = 32 * (warp >> 2);
  float sum[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) fm::zero_frags<4>(sum[i]);

  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 1>();
    __syncthreads();  // stage s landed; the fp32 tiles are free again
    const T* st = ring + (s % kStages) * kStage;
    const long long m = m_lo + (long long)s * kKC;
    float sc[4], sh[4], ds[4], dq[4];
    load4(vx + cx, sc);
    load4(vx + WX + cx, sh);
    load4(vy + cy, ds);
    load4(vy + WY + cy, dq);
#pragma unroll
    for (int r = tid / (WX / 4); r < kKC; r += kThreads / (WX / 4)) {
      float v[4];
      load4(st + r * WX + cx, v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (kPro) v[e] = rnd<T>(prologue<kRelu>(v[e], sc[e], sh[e]));
        if (m + r >= m_hi || kc0 + cx + e >= K) v[e] = 0.f;
      }
      *reinterpret_cast<float4*>(xa_t + mn_idx<WX>(r, cx)) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
#pragma unroll
    for (int r = tid / (WY / 4); r < kKC; r += kThreads / (WY / 4)) {
      float d[4], yv[4];
      load4(st + kKC * WX + r * WY + cy, d);
      load4(st + kKC * (WX + WY) + r * WY + cy, yv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        d[e] = rnd<T>(form_dy(d[e], yv[e], ds[e], dq[e]));
        if (m + r >= m_hi || nc0 + cy + e >= N) d[e] = 0.f;
      }
      *reinterpret_cast<float4*>(dy_t + mn_idx<WY>(r, cy)) =
          make_float4(d[0], d[1], d[2], d[3]);
    }
    __syncthreads();  // the fp32 tiles are formed, stage s is free
    if (s + kStages < steps) issue(s + kStages);
    fm::cp_async_commit();

    warp_ktile<kSmall>(
        sum,
        [&](fm::FragA& a, int i16, int k8) {
          load_a_mn<kBM>(a, a_t, wr + i16, k8, g, tq);
        },
        [&](fm::FragB& b0, fm::FragB& b1, int j16, int k8) {
          load_b_mn<kBN>(b0, b1, b_t, wc + j16, k8, g, tq);
        });
  }
  cp_async_wait<0>();

  // the fragments' paired rows and interleaved columns (load_a_mn,
  // load_b_mn): C element (g + 8 h, 2 tq + b) of mma tile (i, j) is tile
  // row 16 i + 2 g + h, column 16 (j / 2) + 4 tq + 2 b + j % 2
  float* out = ws + (long long)blockIdx.z * K * N;
  const int R = kSwap ? N : K, C = kSwap ? K : N;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + wr + 16 * i + 2 * g + h;
      if (r >= R) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int c = c0 + wc + 16 * (j >> 1) + 4 * tq + 2 * b + (j & 1);
          if (c >= C) continue;
          out[kSwap ? (long long)c * N + r : (long long)r * N + c] =
              sum[i][j][2 * h + b];
        }
    }
}

// dw[e] = sum over splits s of ws[s][e], in split order, stored in T.
template <typename T>
__global__ void reduce_splits(const float* __restrict__ ws, T* __restrict__ dw,
                              long long elems, int splits) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= elems) return;
  float t = 0.f;
#pragma unroll 8
  for (int s = 0; s < splits; ++s) t += ws[s * elems + e];
  store(&dw[e], t);
}

// ---------------------------------------------------------------------------
// K5 dX: dxa = dY w^T, then the prologue's chain factor and its statistics
// ---------------------------------------------------------------------------

// Raw stage: dy and y (kBM x kKC), w (kBN x kKC).
template <typename T>
__host__ __device__ constexpr size_t dx_smem_bytes() {
  return kStages * kKC * (2 * kBM + kBN) * sizeof(T) +
         kKC * (kBM + kBN) * sizeof(float);
}

template <typename T, bool kPro, bool kRelu>
__global__ void __launch_bounds__(kThreads, 2)
dx_kernel(const T* __restrict__ dy, const T* __restrict__ y,
          const T* __restrict__ w, const float* __restrict__ dsum,
          const float* __restrict__ dssq, const T* __restrict__ x,
          const float* __restrict__ scale, const float* __restrict__ shift,
          T* __restrict__ dx, float* __restrict__ part, int M, int K, int N) {
  constexpr bool kSmall = sizeof(T) == 4;  // 16-bit storage is exact in TF32
  constexpr int kStage = kKC * (2 * kBM + kBN);  // raw elements per stage
  extern __shared__ __align__(16) float smem[];
  float* a_t = smem;               // kBM x kKC dY, K-major (tile_idx)
  float* b_t = a_t + kBM * kKC;    // kBN x kKC w, K-major
  T* ring = reinterpret_cast<T*>(b_t + kBN * kKC);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int k0 = blockIdx.x * kBN;
  const long long m0 = (long long)blockIdx.y * kBM;
  const int steps = (N + kKC - 1) / kKC;
  const bool vec_y =
      aligned16(dy) && aligned16(y) && (N * sizeof(T)) % 16 == 0;
  const bool vec_w = aligned16(w) && (N * sizeof(T)) % 16 == 0;

  auto issue = [&](int s) {
    T* st = ring + (s % kStages) * kStage;
    const int n0 = s * kKC;
    stage_raw<kBM, kKC>(st, dy, N, m0, M, n0, N, vec_y, tid);
    stage_raw<kBM, kKC>(st + kBM * kKC, y, N, m0, M, n0, N, vec_y, tid);
    stage_raw<kBN, kKC>(st + 2 * kBM * kKC, w, N, k0, K, n0, N, vec_w, tid);
  };
#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    if (s < steps) issue(s);
    fm::cp_async_commit();
  }

  const int wr = 32 * (warp & 3), wc = 32 * (warp >> 2);
  const int c = (tid % (kKC / 4)) * 4;  // this thread's 4 columns of a stage
  float sum[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) fm::zero_frags<4>(sum[i]);

  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 1>();
    __syncthreads();  // stage s landed; the fp32 tiles are free again
    const T* st = ring + (s % kStages) * kStage;
    const int n = s * kKC + c;
    float ds[4], dq[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ds[e] = n + e < N ? dsum[n + e] : 0.f;
      dq[e] = n + e < N ? dssq[n + e] : 0.f;
    }
#pragma unroll
    for (int r = tid / (kKC / 4); r < kBM; r += kThreads / (kKC / 4)) {
      float d[4], yv[4];
      load4(st + r * kKC + c, d);
      load4(st + kBM * kKC + r * kKC + c, yv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        d[e] = rnd<T>(form_dy(d[e], yv[e], ds[e], dq[e]));
        if (m0 + r >= M || n + e >= N) d[e] = 0.f;
      }
      *reinterpret_cast<float4*>(a_t + fm::tile_idx<kKC>(r, c)) =
          make_float4(d[0], d[1], d[2], d[3]);
    }
#pragma unroll
    for (int r = tid / (kKC / 4); r < kBN; r += kThreads / (kKC / 4)) {
      float v[4];
      load4(st + 2 * kBM * kKC + r * kKC + c, v);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + r >= K || n + e >= N) v[e] = 0.f;
      *reinterpret_cast<float4*>(b_t + fm::tile_idx<kKC>(r, c)) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();  // the fp32 tiles are formed, stage s is free
    if (s + kStages < steps) issue(s + kStages);
    fm::cp_async_commit();

    warp_ktile<kSmall>(
        sum,
        [&](fm::FragA& a, int i16, int k8) {
          fm::load_a<kKC>(a, a_t, wr + i16, k8, lane);
        },
        [&](fm::FragB& b0, fm::FragB& b1, int j16, int k8) {
          fm::load_b_t2<kKC>(b0, b1, b_t, wc + j16, k8, lane);
        });
  }
  cp_async_wait<0>();

  // dx, and each thread's column sums over its 4 rows (columns wc + 8 j +
  // 2 tq + b)
  float cs[4][2] = {}, cb[4][2] = {};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = m0 + wr + 16 * i + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int k = k0 + wc + 8 * j + 2 * tq + b;
          if (k >= K) continue;
          float d = sum[i][j][2 * h + b];
          if (kPro) {
            const float xv = to_f(x[m * K + k]);
            if (kRelu && !(prologue<false>(xv, scale[k], shift[k]) > 0.f))
              d = 0.f;
            store(&dx[m * K + k], __fmul_rn(d, scale[k]));
            cs[j][b] = fmaf(d, xv, cs[j][b]);
            cb[j][b] += d;
          } else {
            store(&dx[m * K + k], d);
          }
        }
    }
  if (!kPro) return;

  // over the warp's 8 row groups (lanes of one tq) by a fixed shuffle tree,
  // then over the 4 warps of a column range in order, into the tile's pair
  __syncthreads();  // every warp is done reading a_t
  float* red = a_t;  // [4 warp rows][2][kBN]
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        cs[j][b] += __shfl_xor_sync(0xffffffffu, cs[j][b], o);
        cb[j][b] += __shfl_xor_sync(0xffffffffu, cb[j][b], o);
      }
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int col = wc + 8 * j + 2 * tq + b;
        red[((warp & 3) * 2 + 0) * kBN + col] = cs[j][b];
        red[((warp & 3) * 2 + 1) * kBN + col] = cb[j][b];
      }
  }
  __syncthreads();
  if (tid < 2 * kBN) {
    const int which = tid / kBN, col = tid % kBN;
    float t = 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r) t += red[(r * 2 + which) * kBN + col];
    if (k0 + col < K)
      part[((long long)blockIdx.y * 2 + which) * K + k0 + col] = t;
  }
}

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

// Multiprocessors of the current device (0 if the query fails).
inline int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return sms;
}

// Rows of dW's contraction per split: a multiple of kKC, at least 256, and
// as many splits as K x N tiles fit in one wave of resident blocks, so
// that the blocks of a call end together (two waves of half the rows were
// slower at ResNet-50's shapes, PERF.md).
inline int dw_chunk(int M, int K, int N, int sms) {
  const int R = K >= N ? K : N, C = K >= N ? N : K;
  const int tiles = cdiv(R, kBM) * cdiv(C, kBN);
  int splits = kDwBlocksPerSm * sms / tiles;
  const int most = cdiv(M, 256);
  if (splits > most) splits = most;
  if (splits < 1) splits = 1;
  return cdiv(cdiv(M, splits), kKC) * kKC;
}

template <typename T, bool kPro, bool kRelu>
int launch_fwd(const void* x, const void* w, const float* scale,
               const float* shift, void* y, float* ysum, float* yssq,
               float* ws, int M, int K, int N, cudaStream_t st) {
  constexpr size_t smem = fwd_smem_bytes<T, kPro>();
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<T, kPro, kRelu>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(cdiv(N, kBN), cdiv(M, kBM));
  fwd_kernel<T, kPro, kRelu><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), scale, shift,
      static_cast<T*>(y), ws, M, K, N);
  reduce_pairs<<<cdiv(N, 32), dim3(32, kRedRows), 0, st>>>(ws, ysum, yssq,
                                                           grid.y, N);
  return (int)cudaGetLastError();
}

template <typename T, bool kPro, bool kRelu, bool kSwap>
int launch_dw_tiles(const T* x, const T* dy, const T* y, const float* ds,
                    const float* dq, const float* scale, const float* shift,
                    float* ws, int M, int K, int N, int chunk, int splits,
                    cudaStream_t st) {
  constexpr size_t smem = dw_smem_bytes<T, kSwap>();
  cudaError_t err = cudaFuncSetAttribute(
      dw_kernel<T, kPro, kRelu, kSwap>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int R = kSwap ? N : K, C = kSwap ? K : N;
  const dim3 grid(cdiv(C, kBN), cdiv(R, kBM), splits);
  dw_kernel<T, kPro, kRelu, kSwap><<<grid, kThreads, smem, st>>>(
      x, dy, y, ds, dq, scale, shift, ws, M, K, N, chunk);
  return 0;
}

template <typename T, bool kPro, bool kRelu>
int launch_dw(const void* x, const void* dy, const void* y, const float* ds,
              const float* dq, const float* scale, const float* shift,
              void* dw, float* ws, int M, int K, int N, cudaStream_t st) {
  const int chunk = dw_chunk(M, K, N, sm_count());
  const int splits = cdiv(M, chunk);
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  const T* yt = static_cast<const T*>(y);
  const int err =
      K >= N ? launch_dw_tiles<T, kPro, kRelu, false>(
                   xt, dyt, yt, ds, dq, scale, shift, ws, M, K, N, chunk,
                   splits, st)
             : launch_dw_tiles<T, kPro, kRelu, true>(
                   xt, dyt, yt, ds, dq, scale, shift, ws, M, K, N, chunk,
                   splits, st);
  if (err) return err;
  const long long elems = (long long)K * N;
  reduce_splits<T><<<cdiv(elems, 256), 256, 0, st>>>(
      ws, static_cast<T*>(dw), elems, splits);
  return (int)cudaGetLastError();
}

template <typename T, bool kPro, bool kRelu>
int launch_dx(const void* dy, const void* y, const void* w, const float* ds,
              const float* dq, const void* x, const float* scale,
              const float* shift, void* dx, float* dscale, float* dbias,
              float* ws, int M, int K, int N, cudaStream_t st) {
  constexpr size_t smem = dx_smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      dx_kernel<T, kPro, kRelu>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(cdiv(K, kBN), cdiv(M, kBM));
  dx_kernel<T, kPro, kRelu><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(dy), static_cast<const T*>(y),
      static_cast<const T*>(w), ds, dq, static_cast<const T*>(x), scale,
      shift, static_cast<T*>(dx), ws, M, K, N);
  if (kPro)
    reduce_pairs<<<cdiv(K, 32), dim3(32, kRedRows), 0, st>>>(
        ws, dscale, dbias, grid.y, K);
  return (int)cudaGetLastError();
}

// kernel: 0 = K4, 1 = dW with K >= N, 2 = dW with K < N, 3 = dX
template <typename T, bool kPro, bool kRelu>
int resources_of(int kernel, int* out) {
  if (kernel == 0)
    return fm::kernel_resources(fwd_kernel<T, kPro, kRelu>,
                                fwd_smem_bytes<T, kPro>(), kThreads, out);
  if (kernel == 1)
    return fm::kernel_resources(dw_kernel<T, kPro, kRelu, false>,
                                dw_smem_bytes<T, false>(), kThreads, out);
  if (kernel == 2)
    return fm::kernel_resources(dw_kernel<T, kPro, kRelu, true>,
                                dw_smem_bytes<T, true>(), kThreads, out);
  if (kernel == 3)
    return fm::kernel_resources(dx_kernel<T, kPro, kRelu>, dx_smem_bytes<T>(),
                                kThreads, out);
  return (int)cudaErrorInvalidValue;
}

// Pick the instantiation for (dtype, apply, relu); dtype 0 = float32,
// 1 = bfloat16, 2 = float16.
#define MXTPU_FCBN_DISPATCH(FN, ...)                                   \
  if (dtype == 0) {                                                    \
    if (!apply) return FN<float, false, false>(__VA_ARGS__);           \
    if (relu) return FN<float, true, true>(__VA_ARGS__);               \
    return FN<float, true, false>(__VA_ARGS__);                        \
  }                                                                    \
  if (dtype == 1) {                                                    \
    if (!apply) return FN<__nv_bfloat16, false, false>(__VA_ARGS__);   \
    if (relu) return FN<__nv_bfloat16, true, true>(__VA_ARGS__);       \
    return FN<__nv_bfloat16, true, false>(__VA_ARGS__);                \
  }                                                                    \
  if (dtype == 2) {                                                    \
    if (!apply) return FN<__half, false, false>(__VA_ARGS__);          \
    if (relu) return FN<__half, true, true>(__VA_ARGS__);              \
    return FN<__half, true, false>(__VA_ARGS__);                       \
  }                                                                    \
  return (int)cudaErrorInvalidValue

}  // namespace
}  // namespace mxtpu_fcbn

extern "C" {

// fp32 elements of scratch each launcher needs: kernel 0 = forward, 1 = dW,
// 2 = dX (0 without a prologue).
long long mxtpu_fused_workspace(int kernel, int M, int K, int N, int apply) {
  using namespace mxtpu_fcbn;
  if (kernel == 0) return 2LL * cdiv(M, kBM) * N;
  if (kernel == 1)
    return (long long)cdiv(M, dw_chunk(M, K, N, sm_count())) * K * N;
  return apply ? 2LL * cdiv(M, kBM) * K : 0;
}

// y (M, N) and ysum, yssq (N,) fp32 from x (M, K) and w (K, N). scale and
// shift (K,) fp32 are read only when apply != 0. Returns cudaGetLastError()
// after the two launches.
int mxtpu_fused_fwd(int dtype, const void* x, const void* w,
                    const float* scale, const float* shift, void* y,
                    float* ysum, float* yssq, float* ws, int M, int K, int N,
                    int apply, int relu, void* stream) {
  using namespace mxtpu_fcbn;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  MXTPU_FCBN_DISPATCH(launch_fwd, x, w, scale, shift, y, ysum, yssq, ws, M,
                      K, N, st);
}

// dW (K, N) in the storage type from x, dy, y and dsum, dssq (N,) fp32.
int mxtpu_fused_dw(int dtype, const void* x, const void* dy, const void* y,
                   const float* dsum, const float* dssq, const float* scale,
                   const float* shift, void* dw, float* ws, int M, int K,
                   int N, int apply, int relu, void* stream) {
  using namespace mxtpu_fcbn;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  MXTPU_FCBN_DISPATCH(launch_dw, x, dy, y, dsum, dssq, scale, shift, dw, ws,
                      M, K, N, st);
}

// dx (M, K) and, when apply != 0, dscale and dbias (K,) fp32.
int mxtpu_fused_dx(int dtype, const void* dy, const void* y, const void* w,
                   const float* dsum, const float* dssq, const void* x,
                   const float* scale, const float* shift, void* dx,
                   float* dscale, float* dbias, float* ws, int M, int K,
                   int N, int apply, int relu, void* stream) {
  using namespace mxtpu_fcbn;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  MXTPU_FCBN_DISPATCH(launch_dx, dy, y, w, dsum, dssq, x, scale, shift, dx,
                      dscale, dbias, ws, M, K, N, st);
}

// Registers, static and dynamic shared bytes, blocks per SM, local (spill)
// bytes and threads of one kernel (0 = K4, 1 = dW with K >= N, 2 = dW with
// K < N, 3 = dX) at its launch configuration, into out[0..5].
int mxtpu_fused_resources(int kernel, int dtype, int apply, int relu,
                          int* out) {
  using namespace mxtpu_fcbn;
  MXTPU_FCBN_DISPATCH(resources_of, kernel, out);
}

}  // extern "C"

MXTPU_DEFINE_ERROR_STRING
