// The body of the backward kernels that own a tile of 64 key rows: the
// dk/dv kernel of the split backward (K2, flash_bwd.cu) and the fused
// backward (K6, flash_bwd_fused.cu), which also adds each tile's dq
// contribution into an fp32 workspace, in ascending key-tile order; and the
// pieces K2's dq kernel shares with them.
//
// A block of (64 key rows, batch * kv head) keeps K and V in shared memory
// and walks the query tiles that see its keys (q_tiles(): causal and window
// tiles are skipped whole) for each query head of its group: K2 head by
// head, each head's tiles ascending; K6 tile by tile from the last, every
// head of the group at each tile (see bwd_kv_block on why). The
// walked tiles (Q, dO, LSE and delta) come through a two-stage ring of
// cp.async copies: the next tile's copy is in flight while the current one
// is multiplied. Per tile, 8 warps each form a 16 x 32 corner of s = Q K^T
// and dp = dO V^T in mma C fragments (3xTF32, flash_mma.cuh), turn them
// into p and ds, and write both once to shared memory; then each warp runs
// dv += p^T dO and dk += ds^T Q for its 16 keys x kD / 2 dims into C
// fragments in registers, so the group's sum happens in a fixed order with
// no atomics and K/V are never repeated; with kDq, also the tile's ds K for
// its 16 query rows x kD / 2 dims, added into dq rows that other blocks add
// into too, four adjacent columns per vector reduction, when the warp's
// turn comes (add_frags_in_turn).
//
// Shared memory, fp32: K, V, two stages of Q and dO (64 x kD each), p and
// ds (64 x 64 each), two stages of LSE and delta: 230,400 bytes at
// kD = 128 (one block, 8 warps per SM) and 82,944 at 32 (two blocks). At
// kD = 64 p and ds take one buffer in turn, 115,712 bytes instead of
// 132,096, which lets two blocks share an SM (the budget is 232,448 a
// block, 233,472 an SM with 1,024 reserved a block): two more barriers a
// tile, and dk/dv faster at BERT-base's shape on an H100.

#pragma once

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace mxtpu_flash {

// K, V, two stages of Q and dO, two stages of LSE and delta, and p and ds
// (n_pd of them: 2, or 1 when one buffer takes both in turn)
template <int kD>
__host__ __device__ constexpr size_t kv_smem_bytes(int n_pd) {
  return sizeof(float) * (6 * kBQ * kD + n_pd * kBQ * kPd + 4 * kBQ);
}
// p and ds share one buffer (two more barriers a tile) where that lets one
// more block onto an SM: at kD = 64, 132,096 bytes become 115,712
template <int kD>
__host__ __device__ constexpr bool kv_share_pd() {
  return blocks_for(kv_smem_bytes<kD>(1)) > blocks_for(kv_smem_bytes<kD>(2));
}
template <int kD>
__host__ __device__ constexpr size_t kv_smem_bytes() {
  return kv_smem_bytes<kD>(kv_share_pd<kD>() ? 1 : 2);
}

// s = Q K^T and dp = dO V^T for the warp's query rows m0..m0+15 and keys
// n0..n0+31 (four C fragments each), both tiles swizzled rows x kD.
template <int kD, bool kSmall>
__device__ __forceinline__ void score_and_dp_mma(
    float (&s)[4][4], float (&dp)[4][4], const float* q_t, const float* g_t,
    const float* k_t, const float* v_t, int m0, int n0, int lane) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll 2
  for (int k0 = 0; k0 < kD; k0 += 8) {
    FragA aq, ag;
    load_a<kD>(aq, q_t, m0, k0, lane);
    load_a<kD>(ag, g_t, m0, k0, lane);
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      FragB bk[2], bv[2];
      load_b_t2<kD>(bk[0], bk[1], k_t, n0 + 8 * j, k0, lane);
      load_b_t2<kD>(bv[0], bv[1], v_t, n0 + 8 * j, k0, lane);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mma_3xtf32<kSmall, kSmall>(s[j + h], aq, bk[h]);
        mma_3xtf32<kSmall, kSmall>(dp[j + h], ag, bv[h]);
      }
    }
  }
}

// p = exp(scale * s - lse) and ds = p * (dp - delta) * scale from the C
// fragments of score_and_dp_mma: p into p_t (with kP), ds into ds_t, or
// with kDsInRegs in place of dp (for frags_to_pd later). The 64 x 64 tiles'
// rows m0 + g8 (+ 8) are query rows q0 + those, columns n0 + .. key columns
// c0 + those. lse and delta of the lane's two rows.
template <bool kP, bool kDsInRegs>
__device__ __forceinline__ void probs_to_smem(
    const Dims& d, const float (&s)[4][4], float (&dp)[4][4],
    const float (&l)[2], const float (&dl)[2], float* p_t, float* ds_t,
    int q0, int c0, int m0, int n0, int g8, int tq) {
  constexpr float kLog2e = 1.4426950408889634f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = m0 + g8 + 8 * i;
    const int row = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = n0 + 8 * j + 2 * tq + e;
        float p = exp2f((masked_score(d, row, c0 + cl,
                                      s[j][2 * i + e] * d.scale) - l[i]) *
                        kLog2e);
        if (row >= d.T) p = 0.f;
        if constexpr (kP) p_t[pd_idx(r, cl)] = p;
        const float ds = p * (dp[j][2 * i + e] - dl[i]) * d.scale;
        if constexpr (kDsInRegs)
          dp[j][2 * i + e] = ds;
        else
          ds_t[pd_idx(r, cl)] = ds;
      }
  }
}

// the C fragments x of a warp's 16 x 32 corner (rows m0.., columns n0..)
// into a 64 x 64 tile
__device__ __forceinline__ void frags_to_pd(const float (&x)[4][4], float* t,
                                            int m0, int n0, int g8, int tq) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        t[pd_idx(m0 + g8 + 8 * i, n0 + 8 * j + 2 * tq + e)] = x[j][2 * i + e];
}

// acc = (64 x 64 tile, read as A by load) x (B tile read paired, rows k)
// for the warp's 16 rows m0.. and dims nd.., over the tile's 64 columns:
// ds K (load_a_pd), p^T dO and ds^T Q (load_a_pd_t)
template <int kD, int kN, bool kSmall, bool kTransposeA>
__device__ __forceinline__ void pd_b_mma(float (&acc)[kN][4],
                                         const float* a_t, const float* b_t,
                                         int m0, int nd, int g8, int tq) {
  zero_frags<kN>(acc);
#pragma unroll
  for (int k0 = 0; k0 < kPd; k0 += 8) {
    FragA a;
    if constexpr (kTransposeA)
      load_a_pd_t(a, a_t, m0, k0, g8, tq);
    else
      load_a_pd(a, a_t, m0, k0, g8, tq);
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      FragB b;
      load_b_paired<kD>(b, b_t, nd + 8 * j, k0, g8, tq);
      mma_3xtf32<true, kSmall>(acc[j], a, b);
    }
  }
}

// The rank of key tile kt among the key tiles whose blocks add into query
// tile qt, from the q_tiles() arithmetic the walk itself uses. For
// kt' <= kt the range q_tiles(kt') starts at or before q_tiles(kt)'s (its
// first row only grows with the key column) and, with kt walking qt, ends
// no earlier as kt' grows, so the key tiles that see qt below kt are the
// contiguous run [first, kt): a binary search for first.
__device__ __forceinline__ int dq_rank(const Dims& d, int kt, int qt) {
  int a = 0, b = kt;
  while (a < b) {
    const int mid = (a + b) >> 1;
    int lo, hi;
    q_tiles(d, mid * kBK, min(mid * kBK + kBK, d.S), &lo, &hi);
    if (hi > qt)
      b = mid;
    else
      a = mid + 1;
  }
  return kt - a;
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Add C fragments acc (rows r0 + g8 (+ 8), columns nd + 8 j + 2 tq (+ 1))
// into the fp32 (rows_total, D) workspace dq once it is this warp's turn:
// *turn counts the warps (kThreads / 32 a block) that have added into this
// query tile, so the warp waits for rank blocks' worth (an acquire load),
// adds, and counts itself with a release reduction, which makes its adds
// visible first. Lanes t and t ^ 1 trade two values so that each holds four
// adjacent columns of one row, added by one vector reduction
// (red.global.add.v4.f32, sm_90) when D % 4 == 0, else one scalar reduction
// per value.
template <int kN>
__device__ __forceinline__ void add_frags_in_turn(
    float* dq, const float (&acc)[kN][4], int r0, int rows_total, int D,
    int nd, int g8, int tq, int* turn, int rank) {
  const int lane = threadIdx.x & 31;
  if (lane == 0 && rank > 0) {
    const int target = rank * (kThreads / 32);
    while (load_acquire(turn) < target) __nanosleep(32);
  }
  __syncwarp();
  const bool odd = tq & 1;
  const int row = r0 + g8 + (odd ? 8 : 0);
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const float r0v = __shfl_xor_sync(0xffffffffu,
                                      odd ? acc[j][0] : acc[j][2], 1);
    const float r1v = __shfl_xor_sync(0xffffffffu,
                                      odd ? acc[j][1] : acc[j][3], 1);
    const float4 x = odd ? make_float4(r0v, r1v, acc[j][2], acc[j][3])
                         : make_float4(acc[j][0], acc[j][1], r0v, r1v);
    const int c = nd + 8 * j + 2 * (tq & 2);
    if (row >= rows_total || c >= D) continue;
    float* out = dq + (long long)row * D + c;
    if ((D & 3) == 0) {
      atomicAdd(reinterpret_cast<float4*>(out), x);
    } else {
      atomicAdd(out, x.x);
      if (c + 1 < D) atomicAdd(out + 1, x.y);
      if (c + 2 < D) atomicAdd(out + 2, x.z);
      if (c + 3 < D) atomicAdd(out + 3, x.w);
    }
  }
  // the lanes' adds come before lane 0's release in causality order
  __syncwarp();
  if (lane == 0)
    asm volatile("red.release.gpu.global.add.s32 [%0], 1;\n" ::"l"(turn)
                 : "memory");
}

// dq: a zeroed fp32 (B, H, T, D) workspace when kDq, unused otherwise;
// dq_turn: a zeroed int32 (B * H, query tiles) count of the warps that have
// added into each query tile, when kDq; dk and dv: (B, KVH, S, D) in the
// storage type. The block's key tile is kt, its batch * kv head bkvh.
//
// With kDq the blocks of one batch * kv head add into each query tile in
// ascending key-tile order, as the reference's sequential grid does, so dq
// repeats bit for bit. A block waits only on blocks of lower key tiles,
// which have lower indices in the tile-major grid: this relies on the card
// dispatching blocks in index order, so that every block waited on is
// resident or done. And the walk makes the waits short: every block goes
// from the last query tile down, all heads of the group at each tile, so
// a tile it shares with the block of the key tile below comes at the same
// step of both walks (both end at the last query tile; a window only drops
// tiles from the top of the lower block's walk), and a block lags the one
// below it by one add rather than by whole tiles.
template <typename T, int kD, bool kDq>
__device__ __forceinline__ void bwd_kv_block(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq,
    int* __restrict__ dq_turn, T* __restrict__ dk, T* __restrict__ dv,
    const Dims& d, int kt, int bkvh) {
  constexpr int kN = kD / 16;  // 8-dim fragments in a warp's kD / 2 dims
  constexpr bool kSmall = sizeof(T) == 4;  // 16-bit storage is exact in TF32
  extern __shared__ __align__(16) float smem[];
  float* k_t = smem;                          // kBK x kD
  float* v_t = k_t + kBK * kD;                // kBK x kD
  float* ring = v_t + kBK * kD;               // 2 x (Q, dO): kBQ x kD each
  constexpr bool kShare = kv_share_pd<kD>();
  float* p_t = ring + 4 * kBQ * kD;           // kBQ x kPd
  float* ds_t = kShare ? p_t : p_t + kBQ * kPd;  // kBQ x kPd
  float* rows_t = ds_t + kBQ * kPd;           // 2 x (LSE, delta): kBQ each

  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const int g8 = (tid & 31) >> 2;
  const int tq = tid & 3;
  const int b = bkvh / d.KVH;
  const int kvh = bkvh - b * d.KVH;
  const int group = d.H / d.KVH;
  const int c0 = kt * kBK;

  load_tile_async<kD, kThreads>(k_t, k + b * d.k_s[0] + kvh * d.k_s[1],
                                d.k_s[2], c0, kBK, d.S, d.D, tid);
  load_tile_async<kD, kThreads>(v_t, v + b * d.v_s[0] + kvh * d.v_s[1],
                                d.v_s[2], c0, kBK, d.S, d.D, tid);

  int lo, hi;
  q_tiles(d, c0, min(c0 + kBK, d.S), &lo, &hi);
  const int per = hi - lo;
  const int n = group * per;

  // walked tile it: query head hg of the group and query tile qt
  auto tile_of = [&](int it, int* hg, int* qt) {
    if constexpr (kDq) {
      const int i = it / group;
      *hg = it - i * group;
      *qt = hi - 1 - i;
    } else {
      *hg = it / per;
      *qt = lo + it - *hg * per;
    }
  };
  // walked tile it into ring stage st
  auto issue = [&](int it, int st) {
    int hg, qt;
    tile_of(it, &hg, &qt);
    const int q0 = qt * kBQ;
    const int h = kvh * group + hg;
    const long long bh = (long long)b * d.H + h;
    float* q_s = ring + 2 * st * kBQ * kD;
    load_tile_async<kD, kThreads>(q_s, q + b * d.q_s[0] + h * d.q_s[1],
                                  d.q_s[2], q0, kBQ, d.T, d.D, tid);
    load_tile_async<kD, kThreads>(q_s + kBQ * kD,
                                  g + b * d.g_s[0] + h * d.g_s[1], d.g_s[2],
                                  q0, kBQ, d.T, d.D, tid);
    float* r_s = rows_t + 2 * st * kBQ;
    const int valid = min(kBQ, d.T - q0);
    load_vec_async(r_s, lse + bh * d.T + q0, kBQ, valid, tid, kThreads);
    load_vec_async(r_s + kBQ, delta + bh * d.T + q0, kBQ, valid, tid,
                   kThreads);
  };
  if (n > 0) issue(0, 0);
  cp_async_commit();

  // S/dP and dq: query rows m0 (+ 16 per warp pair); dv/dk: key rows m0
  const int m0 = 16 * (w & 3);
  const int n0 = 32 * (w >> 2);      // the warp's keys in s and dp
  const int nd = (kD / 2) * (w >> 2);  // the warp's dims in dk, dv and dq
  float dk_acc[kN][4], dv_acc[kN][4], acc[kN][4];
  zero_frags<kN>(dk_acc);
  zero_frags<kN>(dv_acc);

  for (int it = 0; it < n; ++it) {
    const int st = it & 1;
    cp_async_wait_all();
    __syncthreads();  // tile it landed; tile it - 1 fully consumed
    if (it + 1 < n) issue(it + 1, st ^ 1);
    cp_async_commit();

    int hg, qt;
    tile_of(it, &hg, &qt);
    const int q0 = qt * kBQ;
    const float* q_s = ring + 2 * st * kBQ * kD;
    const float* g_s = q_s + kBQ * kD;
    const float* r_s = rows_t + 2 * st * kBQ;

    // s and p once per tile, for every gradient
    float s[4][4], dp[4][4];
    score_and_dp_mma<kD, kSmall>(s, dp, q_s, g_s, k_t, v_t, m0, n0,
                                 tid & 31);
    const float l[2] = {r_s[m0 + g8], r_s[m0 + g8 + 8]};
    const float dl[2] = {r_s[kBQ + m0 + g8], r_s[kBQ + m0 + g8 + 8]};
    probs_to_smem<true, kShare>(d, s, dp, l, dl, p_t, ds_t, q0, c0, m0, n0,
                                g8, tq);
    __syncthreads();

    // dv += p^T dO and dk += ds^T Q: the warp's keys m0.., dims nd..
    pd_b_mma<kD, kN, kSmall, true>(acc, p_t, g_s, m0, nd, g8, tq);
    add_into<kN>(dv_acc, acc);
    if constexpr (kShare) {
      __syncthreads();  // every warp is done with p
      frags_to_pd(dp, ds_t, m0, n0, g8, tq);
      __syncthreads();
    }
    pd_b_mma<kD, kN, kSmall, true>(acc, ds_t, q_s, m0, nd, g8, tq);
    add_into<kN>(dk_acc, acc);

    if constexpr (kDq) {
      // dq[rows] += ds K: the warp's query rows m0.., dims nd..
      pd_b_mma<kD, kN, kSmall, false>(acc, ds_t, k_t, m0, nd, g8, tq);
      const long long bh = (long long)b * d.H + kvh * group + hg;
      const int n_qt = (d.T + kBQ - 1) / kBQ;
      add_frags_in_turn<kN>(dq + bh * d.T * d.D, acc, q0 + m0, d.T, d.D, nd,
                            g8, tq, dq_turn + bh * n_qt + qt,
                            dq_rank(d, kt, qt));
    }
  }
  cp_async_wait_all();

  const long long off = (long long)bkvh * d.S * d.D;
  store_frags<kN>(dk + off, dk_acc, c0 + m0, d.S, d.D, nd, g8, tq);
  store_frags<kN>(dv + off, dv_acc, c0 + m0, d.S, d.D, nd, g8, tq);
}

}  // namespace mxtpu_flash
