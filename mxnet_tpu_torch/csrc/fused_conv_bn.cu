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
// float32 or bfloat16; scale, shift, dsum, dssq and the statistics are fp32.
// The prologue and dY are formed with __fmul_rn/__fadd_rn in the oracle's
// order, so no FMA contraction makes them differ from the plain version
// before the rounding to mm.
//
// Design. One generic SIMT tile: a block of 256 threads owns a 128 x 64
// output tile, each thread 8 rows x 4 columns of fp32 accumulators, and the
// contraction advances 16 at a time through shared memory (operands stored
// as fp32 after the prologue and the rounding to mm, so bf16 products are
// exact and only the sums round). Loads past M, K or N are zeros; the
// prologue is applied only in bounds, so padding rows add nothing to any
// statistic. The TPU kernels carry the column statistics (and dW's
// contraction over M) in VMEM scratch across a sequential grid; here blocks
// run in no order, so nothing is carried and no float atomics are used:
//   - K4 and dX write one partial (sum, sum of squares / dscale, dbias) per
//     128-row tile to a workspace, summed over the block's 16 thread rows in
//     a fixed order, and reduce_pairs() then sums the tiles in a fixed
//     order;
//   - dW splits M into S contiguous ranges (enough blocks to fill the card
//     when K x N is small: at K = N = 64, M = 401408 one tile would walk all
//     rows on one SM), writes S partial dW tiles and reduce_splits() sums
//     them in split order.
// Every result is therefore the same from run to run. One call of each
// launcher enqueues its tile kernel and its reduction on the given stream.
// dW puts the larger of K and N on the 128-row side of the tile.
//
// Bound on this card: 2 M K N operations against reading x, w (dy, y) once
// and writing y (dx, dW) once. At ResNet-50's 1x1 shapes in fp32 that is
// 2 K N / (4 (K + N)) flops per byte, 16 at K = N = 64 (below the CUDA
// cores' ridge of 67 TFLOP/s / 3.35 TB/s = 20, bytes bind) and 160 to 400
// at K, N >= 256 (operations bind). This first version runs on the CUDA
// cores in fp32 for both storage types (no wgmma, no TMA, no multi-stage
// pipeline) and stays below either bound; the times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mxtpu_fcbn {
namespace {

constexpr int kBM = 128;        // output rows per tile
constexpr int kBN = 64;         // output columns per tile
constexpr int kBC = 16;         // contraction step
constexpr int kThreads = 256;   // 16 x 16 threads, 8 x 4 outputs each
constexpr int kLdA = kBM + 4;   // padded rows in shared memory (16-byte
constexpr int kLdB = kBN + 4;   // aligned for float4 reads)
constexpr int kRedRows = 16;    // reduce_pairs: tile stripes per column
constexpr int kDwTargetBlocks = 512;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The value rounded to the storage type T (round to nearest even).
template <typename T>
__device__ __forceinline__ float rnd(float x);
template <>
__device__ __forceinline__ float rnd<float>(float x) { return x; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
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

// S[r][c] = op(m0 + r, c0 + c) for a kBC x W tile whose rows run along the
// contraction (row-major operands read along their rows); zeros outside
// [.., mend) x [.., cend).
template <int W, int LD, typename Op>
__device__ __forceinline__ void load_rows(float* S, long long m0,
                                          long long mend, int c0, int cend,
                                          Op op) {
  constexpr int kPer = W * kBC / kThreads;  // 8 for W = 128, 4 for W = 64
  constexpr int kTpr = W / kPer;            // threads per tile row: 16
  const int r = threadIdx.x / kTpr;
  const int cc = (threadIdx.x % kTpr) * kPer;
  const long long m = m0 + r;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int c = c0 + cc + j;
    S[r * LD + cc + j] = (m < mend && c < cend) ? op(m, c) : 0.f;
  }
}

// S[c][r] = op(r0 + r, c0 + c): a W x kBC block of a row-major operand
// whose columns run along the contraction, stored transposed; zeros outside
// [.., rend) x [.., cend).
template <int W, int LD, typename Op>
__device__ __forceinline__ void load_cols(float* S, long long r0,
                                          long long rend, int c0, int cend,
                                          Op op) {
  constexpr int kPer = W * kBC / kThreads;  // 8 for W = 128, 4 for W = 64
  constexpr int kTpr = kBC / kPer;          // threads per operand row
  const int r = threadIdx.x / kTpr;
  const int cc = (threadIdx.x % kTpr) * kPer;
  const long long row = r0 + r;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int c = c0 + cc + j;
    S[(cc + j) * LD + r] = (row < rend && c < cend) ? op(row, c) : 0.f;
  }
}

// acc[i][j] += sum_c A[c][ty * 8 + i] * B[c][tx * 4 + j]
__device__ __forceinline__ void mma_tile(const float* A, const float* B,
                                         float (&acc)[8][4], int ty, int tx) {
#pragma unroll
  for (int c = 0; c < kBC; ++c) {
    const float4 a0 = *reinterpret_cast<const float4*>(A + c * kLdA + ty * 8);
    const float4 a1 =
        *reinterpret_cast<const float4*>(A + c * kLdA + ty * 8 + 4);
    const float4 b = *reinterpret_cast<const float4*>(B + c * kLdB + tx * 4);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
  }
}

// Sum s[j], q[j] (each thread's 4 columns) over the block's 16 thread rows
// in a fixed order and write the tile's partial pair for columns
// [c0, c0 + 64) to part[(tile * 2 + {0, 1}) * ncols + c].
__device__ __forceinline__ void block_pair_partial(const float (&s)[4],
                                                   const float (&q)[4],
                                                   float* part, long long tile,
                                                   int c0, int ncols) {
  __shared__ float red[2][kThreads / 16][kBN];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red[0][ty][tx * 4 + j] = s[j];
    red[1][ty][tx * 4 + j] = q[j];
  }
  __syncthreads();
  if (threadIdx.x < 2 * kBN) {
    const int which = threadIdx.x / kBN, col = threadIdx.x % kBN;
    float t = 0.f;
#pragma unroll
    for (int r = 0; r < kThreads / 16; ++r) t += red[which][r][col];
    if (c0 + col < ncols) part[(tile * 2 + which) * ncols + c0 + col] = t;
  }
}

// ---------------------------------------------------------------------------
// K4: y = prologue(x) @ w with the column statistics of the fp32 accumulator
// ---------------------------------------------------------------------------

template <typename T, bool kPro, bool kRelu>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
           const float* __restrict__ scale, const float* __restrict__ shift,
           T* __restrict__ y, float* __restrict__ part, int M, int K, int N) {
  __shared__ __align__(16) float As[kBC * kLdA];
  __shared__ __align__(16) float Bs[kBC * kLdB];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int n0 = blockIdx.x * kBN;
  const long long m0 = (long long)blockIdx.y * kBM;
  float acc[8][4] = {};

  auto xa = [&](long long m, int k) {
    float v = to_f(x[m * K + k]);
    if (kPro) v = rnd<T>(prologue<kRelu>(v, scale[k], shift[k]));
    return v;
  };
  auto wv = [&](long long k, int n) { return to_f(w[k * N + n]); };
  for (int c0 = 0; c0 < K; c0 += kBC) {
    load_cols<kBM, kLdA>(As, m0, M, c0, K, xa);
    load_rows<kBN, kLdB>(Bs, c0, K, n0, N, wv);
    __syncthreads();
    mma_tile(As, Bs, acc, ty, tx);
    __syncthreads();
  }

  float s[4] = {}, q[4] = {};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + ty * 8 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) store(&y[m * N + n], acc[i][j]);
      s[j] += acc[i][j];
      q[j] = fmaf(acc[i][j], acc[i][j], q[j]);
    }
  }
  block_pair_partial(s, q, part, blockIdx.y, n0, N);
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
// K5 dW: dW = xa^T dY over one split [m_lo, m_hi) of the rows
// ---------------------------------------------------------------------------

// kSwap = false: tile rows are k (xa's columns), columns n; kSwap = true:
// tile rows are n, columns k. Partial p of split s lands at
// ws[s * K * N + k * N + n].
template <typename T, bool kPro, bool kRelu, bool kSwap>
__global__ void __launch_bounds__(kThreads)
dw_kernel(const T* __restrict__ x, const T* __restrict__ dy,
          const T* __restrict__ y, const float* __restrict__ dsum,
          const float* __restrict__ dssq, const float* __restrict__ scale,
          const float* __restrict__ shift, float* __restrict__ ws, int M,
          int K, int N, int chunk) {
  __shared__ __align__(16) float As[kBC * kLdA];
  __shared__ __align__(16) float Bs[kBC * kLdB];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int r0 = blockIdx.y * kBM;  // first tile row (k, or n if kSwap)
  const int c0 = blockIdx.x * kBN;  // first tile column
  const long long m_lo = (long long)blockIdx.z * chunk;
  const long long m_hi = min((long long)M, m_lo + chunk);
  float acc[8][4] = {};

  auto xa = [&](long long m, int k) {
    float v = to_f(x[m * K + k]);
    if (kPro) v = rnd<T>(prologue<kRelu>(v, scale[k], shift[k]));
    return v;
  };
  auto dY = [&](long long m, int n) {
    const long long e = m * N + n;
    return rnd<T>(form_dy(to_f(dy[e]), to_f(y[e]), dsum[n], dssq[n]));
  };
  for (long long m = m_lo; m < m_hi; m += kBC) {
    if (kSwap) {
      load_rows<kBM, kLdA>(As, m, m_hi, r0, N, dY);
      load_rows<kBN, kLdB>(Bs, m, m_hi, c0, K, xa);
    } else {
      load_rows<kBM, kLdA>(As, m, m_hi, r0, K, xa);
      load_rows<kBN, kLdB>(Bs, m, m_hi, c0, N, dY);
    }
    __syncthreads();
    mma_tile(As, Bs, acc, ty, tx);
    __syncthreads();
  }

  float* out = ws + (long long)blockIdx.z * K * N;
  const int R = kSwap ? N : K, C = kSwap ? K : N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + ty * 8 + i;
    if (r >= R) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx * 4 + j;
      if (c >= C) continue;
      out[kSwap ? (long long)c * N + r : (long long)r * N + c] = acc[i][j];
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

template <typename T, bool kPro, bool kRelu>
__global__ void __launch_bounds__(kThreads)
dx_kernel(const T* __restrict__ dy, const T* __restrict__ y,
          const T* __restrict__ w, const float* __restrict__ dsum,
          const float* __restrict__ dssq, const T* __restrict__ x,
          const float* __restrict__ scale, const float* __restrict__ shift,
          T* __restrict__ dx, float* __restrict__ part, int M, int K, int N) {
  __shared__ __align__(16) float As[kBC * kLdA];
  __shared__ __align__(16) float Bs[kBC * kLdB];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * kBN;
  const long long m0 = (long long)blockIdx.y * kBM;
  float acc[8][4] = {};

  auto dY = [&](long long m, int n) {
    const long long e = m * N + n;
    return rnd<T>(form_dy(to_f(dy[e]), to_f(y[e]), dsum[n], dssq[n]));
  };
  auto wv = [&](long long k, int n) { return to_f(w[k * N + n]); };
  for (int c0 = 0; c0 < N; c0 += kBC) {
    load_cols<kBM, kLdA>(As, m0, M, c0, N, dY);
    load_cols<kBN, kLdB>(Bs, k0, K, c0, N, wv);
    __syncthreads();
    mma_tile(As, Bs, acc, ty, tx);
    __syncthreads();
  }

  float s[4] = {}, q[4] = {};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + ty * 8 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + tx * 4 + j;
      if (k >= K) continue;
      float d = acc[i][j];
      if (kPro) {
        const float xv = to_f(x[m * K + k]);
        if (kRelu && !(prologue<false>(xv, scale[k], shift[k]) > 0.f))
          d = 0.f;
        store(&dx[m * K + k], __fmul_rn(d, scale[k]));
        s[j] = fmaf(d, xv, s[j]);
        q[j] += d;
      } else {
        store(&dx[m * K + k], d);
      }
    }
  }
  if (kPro) block_pair_partial(s, q, part, blockIdx.y, k0, K);
}

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

// Rows of dW's contraction per split: a multiple of kBC, at least 256, and
// few enough splits that K x N tiles times splits is about kDwTargetBlocks.
inline int dw_chunk(int M, int K, int N) {
  const int R = K >= N ? K : N, C = K >= N ? N : K;
  const int tiles = cdiv(R, kBM) * cdiv(C, kBN);
  int splits = cdiv(kDwTargetBlocks, tiles);
  const int most = cdiv(M, 256);
  if (splits > most) splits = most;
  if (splits < 1) splits = 1;
  return cdiv(cdiv(M, splits), kBC) * kBC;
}

template <typename T, bool kPro, bool kRelu>
int launch_fwd(const void* x, const void* w, const float* scale,
               const float* shift, void* y, float* ysum, float* yssq,
               float* ws, int M, int K, int N, cudaStream_t st) {
  const dim3 grid(cdiv(N, kBN), cdiv(M, kBM));
  fwd_kernel<T, kPro, kRelu><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), scale, shift,
      static_cast<T*>(y), ws, M, K, N);
  reduce_pairs<<<cdiv(N, 32), dim3(32, kRedRows), 0, st>>>(ws, ysum, yssq,
                                                           grid.y, N);
  return (int)cudaGetLastError();
}

template <typename T, bool kPro, bool kRelu>
int launch_dw(const void* x, const void* dy, const void* y, const float* ds,
              const float* dq, const float* scale, const float* shift,
              void* dw, float* ws, int M, int K, int N, cudaStream_t st) {
  const int chunk = dw_chunk(M, K, N);
  const int splits = cdiv(M, chunk);
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  const T* yt = static_cast<const T*>(y);
  if (K >= N) {
    const dim3 grid(cdiv(N, kBN), cdiv(K, kBM), splits);
    dw_kernel<T, kPro, kRelu, false><<<grid, kThreads, 0, st>>>(
        xt, dyt, yt, ds, dq, scale, shift, ws, M, K, N, chunk);
  } else {
    const dim3 grid(cdiv(K, kBN), cdiv(N, kBM), splits);
    dw_kernel<T, kPro, kRelu, true><<<grid, kThreads, 0, st>>>(
        xt, dyt, yt, ds, dq, scale, shift, ws, M, K, N, chunk);
  }
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
  const dim3 grid(cdiv(K, kBN), cdiv(M, kBM));
  dx_kernel<T, kPro, kRelu><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(dy), static_cast<const T*>(y),
      static_cast<const T*>(w), ds, dq, static_cast<const T*>(x), scale,
      shift, static_cast<T*>(dx), ws, M, K, N);
  if (kPro)
    reduce_pairs<<<cdiv(K, 32), dim3(32, kRedRows), 0, st>>>(
        ws, dscale, dbias, grid.y, K);
  return (int)cudaGetLastError();
}

// Pick the instantiation for (dtype, apply, relu); dtype 0 = float32,
// 1 = bfloat16.
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
  return (int)cudaErrorInvalidValue

}  // namespace
}  // namespace mxtpu_fcbn

extern "C" {

// fp32 elements of scratch each launcher needs: kernel 0 = forward, 1 = dW,
// 2 = dX (0 without a prologue).
long long mxtpu_fused_workspace(int kernel, int M, int K, int N, int apply) {
  using namespace mxtpu_fcbn;
  if (kernel == 0) return 2LL * cdiv(M, kBM) * N;
  if (kernel == 1) return (long long)cdiv(M, dw_chunk(M, K, N)) * K * N;
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

const char* mxtpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
