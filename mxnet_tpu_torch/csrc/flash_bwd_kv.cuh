// The body of the backward kernels that own a tile of 64 key rows: the
// dk/dv kernel of the split backward (K2, flash_bwd.cu) and the fused
// backward (K6, flash_bwd_fused.cu), which also adds each tile's dq
// contribution into an fp32 workspace.
//
// A block of (batch * kv head, 64 key rows) keeps K and V in shared memory
// and walks, for each query head of its group in turn, the query tiles that
// see its keys (q_tiles(): causal and window tiles are skipped whole). Per
// tile it forms s and dp, then p and ds in shared memory, and runs the
// products that consume them: dv += p^T dO and dk += ds^T Q into registers,
// so the group's sum happens in a fixed order with no atomics and K/V are
// never repeated; with kDq, also the tile's ds K, added with atomicAdd into
// dq rows that other blocks add into too.

#pragma once

#include "flash_common.cuh"

namespace mxtpu_flash {

template <int kD>
constexpr size_t kv_smem_bytes() {
  return sizeof(float) *
         (2 * (kBQ + kBK) * (kD + 1) + 2 * kBQ * kLdP + 2 * kBQ);
}

// dq: a zeroed fp32 (B, H, T, D) workspace when kDq, unused otherwise; dk and
// dv: (B, KVH, S, D) in the storage type.
template <typename T, int kD, bool kDq>
__device__ __forceinline__ void bwd_kv_block(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq,
    T* __restrict__ dk, T* __restrict__ dv, const Dims& d) {
  constexpr int kLd = kD + 1;
  constexpr int kDPer = kD / 16;
  extern __shared__ float smem[];
  float* k_t = smem;                 // kBK x kLd
  float* v_t = k_t + kBK * kLd;      // kBK x kLd
  float* q_t = v_t + kBK * kLd;      // kBQ x kLd
  float* g_t = q_t + kBQ * kLd;      // kBQ x kLd (dO)
  float* p_t = g_t + kBQ * kLd;      // kBQ x kLdP
  float* ds_t = p_t + kBQ * kLdP;    // kBQ x kLdP
  float* lse_t = ds_t + kBQ * kLdP;  // kBQ
  float* delta_t = lse_t + kBQ;      // kBQ

  const int bkvh = blockIdx.y;
  const int b = bkvh / d.KVH;
  const int kvh = bkvh - b * d.KVH;
  const int group = d.H / d.KVH;
  const int c0 = blockIdx.x * kBK;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<kD>(k_t, k + b * d.k_s[0] + kvh * d.k_s[1], d.k_s[2], c0, kBK,
                d.S, d.D);
  load_tile<kD>(v_t, v + b * d.v_s[0] + kvh * d.v_s[1], d.v_s[2], c0, kBK,
                d.S, d.D);

  // the thread's key rows ty + 16 jj and dims tx + 16 e
  float dk_acc[4][kDPer], dv_acc[4][kDPer];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
#pragma unroll
    for (int e = 0; e < kDPer; ++e) dk_acc[jj][e] = dv_acc[jj][e] = 0.f;

  int lo, hi;
  q_tiles(d, c0, min(c0 + kBK, d.S), &lo, &hi);
  for (int hg = 0; hg < group; ++hg) {
    const int h = kvh * group + hg;
    const long long bh = (long long)b * d.H + h;
    const T* qb = q + b * d.q_s[0] + h * d.q_s[1];
    const T* gb = g + b * d.g_s[0] + h * d.g_s[1];
    float* dqb = kDq ? dq + bh * d.T * d.D : nullptr;
    for (int qt = lo; qt < hi; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();
      load_tile<kD>(q_t, qb, d.q_s[2], q0, kBQ, d.T, d.D);
      load_tile<kD>(g_t, gb, d.g_s[2], q0, kBQ, d.T, d.D);
      for (int r = threadIdx.x; r < kBQ; r += kThreads) {
        const bool ok = q0 + r < d.T;
        lse_t[r] = ok ? lse[bh * d.T + q0 + r] : 0.f;
        delta_t[r] = ok ? delta[bh * d.T + q0 + r] : 0.f;
      }
      __syncthreads();

      // s and p once per tile, for every gradient
      float s[4][4], dp[4][4];
      score_and_dp<kD>(s, dp, q_t, g_t, k_t, v_t, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const int row = q0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = c0 + tx + 16 * j;
          float p =
              expf(masked_score(d, row, col, s[i][j] * d.scale) - lse_t[r]);
          if (row >= d.T) p = 0.f;
          p_t[r * kLdP + tx + 16 * j] = p;
          ds_t[r * kLdP + tx + 16 * j] = p * (dp[i][j] - delta_t[r]) * d.scale;
        }
      }
      __syncthreads();

      // dv += p^T dO and dk += ds^T Q: the thread's key rows ty + 16 jj
#pragma unroll 4
      for (int i = 0; i < kBQ; ++i) {
        float p[4], ds[4], gg[kDPer], qq[kDPer];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          p[jj] = p_t[i * kLdP + ty + 16 * jj];
          ds[jj] = ds_t[i * kLdP + ty + 16 * jj];
        }
#pragma unroll
        for (int e = 0; e < kDPer; ++e) {
          gg[e] = g_t[i * kLd + tx + 16 * e];
          qq[e] = q_t[i * kLd + tx + 16 * e];
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int e = 0; e < kDPer; ++e) {
            dv_acc[jj][e] += p[jj] * gg[e];
            dk_acc[jj][e] += ds[jj] * qq[e];
          }
      }

      if constexpr (kDq) {
        // dq[rows] += ds K: the thread's query rows ty + 16 i
        float dq_acc[4][kDPer];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < kDPer; ++e) dq_acc[i][e] = 0.f;
#pragma unroll 4
        for (int j = 0; j < kBK; ++j) {
          float ds[4], kk[kDPer];
#pragma unroll
          for (int i = 0; i < 4; ++i) ds[i] = ds_t[(ty + 16 * i) * kLdP + j];
#pragma unroll
          for (int e = 0; e < kDPer; ++e) kk[e] = k_t[j * kLd + tx + 16 * e];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < kDPer; ++e) dq_acc[i][e] += ds[i] * kk[e];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = q0 + ty + 16 * i;
          if (row >= d.T) continue;
          float* out = dqb + (long long)row * d.D;
#pragma unroll
          for (int e = 0; e < kDPer; ++e) {
            const int c = tx + 16 * e;
            if (c < d.D) atomicAdd(out + c, dq_acc[i][e]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const int row = c0 + ty + 16 * jj;
    if (row >= d.S) continue;
    const long long off = ((long long)bkvh * d.S + row) * d.D;
#pragma unroll
    for (int e = 0; e < kDPer; ++e) {
      const int c = tx + 16 * e;
      if (c < d.D) {
        store(dk + off + c, dk_acc[jj][e]);
        store(dv + off + c, dv_acc[jj][e]);
      }
    }
  }
}

}  // namespace mxtpu_flash
