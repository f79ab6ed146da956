// Packed-qkv self-attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel aa_clip_iqm_tpu/ops/pallas_attention.py:
// _flash_packed_bwd_kernelized -> _bwd_kernel_grouped (one program per
// q-block with whole (blk, L) score rows in VMEM, dK/dV carried in fp32
// scratch across the sequential q-block axis of the grid).
//
// What it computes, per (batch b, head h), from the packed qkv (B, L, 3W) and
// dO (B, L, W), read strided as the forward kernel reads them:
//   S = scale * Q K^T in fp32, keys >= valid_len masked; P = softmax(S);
//   dV = P^T dO;  dP = dO V^T;  D = rowsum(P * dP);  dS = P * (dP - D);
//   dQ = scale * dS K;  dK = scale * dS^T Q,
// with P and dS rounded to the input dtype before their products, fp32
// accumulation everywhere and one rounding of dQ, dK, dV at the end. The
// three land in one dqkv (B, L, 3W) at column sections 0, W and 2W, so no
// concatenation follows. D is rowsum(P * dP) with the fp32 P, as the TPU
// kernel has it (not rowsum(dO * O), which differs by the rounding of O);
// nothing is saved by the forward beyond qkv. The scale is applied to the
// fp32 products (S after Q K^T, dK after dS^T Q), where the TPU kernel scales
// q first: the same numbers whenever the scale is a power of two, as it is
// for the one head width built here (64).
//
// What bounds it on the H100: at ViT-L/518 (B=8, L=1370, 16 heads of 64) the
// five products are 10*B*H*L^2*hd = 1.54e11 FLOP (155 us at 989 TFLOP/s dense
// bf16) against ~157 MB of qkv/dO/dqkv traffic (47 us at 3.35 TB/s):
// compute-bound.
//
// What the design does about it. A Hopper grid has no sequential axis to carry
// dK/dV along, and a block cannot hold (blk, L) rows, so the work is two
// kernels on one stream, both with the forward kernel's register layout
// (4 warps, 16 rows each, mma.sync m16n8k16 with operands from ldmatrix, the
// streamed tiles double-buffered by cp.async), and no atomics, so the result
// is the same from run to run:
//   1. dq kernel, one block per 64-query tile: a first sweep over the key
//      tiles takes the online row maximum, sum and sum(p * dP) and writes the
//      row's log-sum-exp and D to a (B, H, L) fp32 scratch; a second sweep
//      recomputes S and dP, forms dS and accumulates dQ += dS K.
//   2. dk/dv kernel, one block per 64-key tile, walking the query tiles: it
//      computes the transposed tiles directly, S^T = K Q^T and dP^T = V dO^T
//      (this block's K and V rows are the A operands, held in registers), so
//      P^T and dS^T come out in the accumulator layout that converts in
//      registers to the A operand of dV += P^T dO and dK += dS^T Q. The
//      statistics of the query columns come from the scratch.
// That is nine tile products where five would do (S and dP are computed three
// times): the price of no atomics and of saving nothing in the forward.
// fp32 inputs take the same two kernels with shared-memory tiles and plain
// FMAs. Head width 64 only, as the forward. Not yet done: TMA, wgmma, one
// pass with dQ reduced across key tiles.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

using namespace aaclip;

namespace {

constexpr int BT = 64;                 // rows per tile (queries or keys)
constexpr int NWARPS = 4;              // each warp owns 16 rows of the block's tile
constexpr int NTHREADS = NWARPS * 32;
constexpr int HD = 64;
constexpr int LD = HD + 8;             // bf16 tile row stride (16-byte padding)
constexpr size_t TILE = round_up(sizeof(bf16) * BT * LD, 128);

// Start copying rows [r0, r0 + 64) of one head's column panel into shared
// memory; rows at or past L are zero-filled.
__device__ __forceinline__ void load_panel(bf16* dst, const bf16* src,
                                           long row_stride, int r0, int L) {
  constexpr int VPR = HD / 8;          // 16-byte vectors per row
  for (int i = threadIdx.x; i < BT * VPR; i += NTHREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    const bool real = r0 + r < L;
    cp_async16(dst + r * LD + c, real ? src + (long)(r0 + r) * row_stride + c : src,
               real ? 16 : 0);
  }
}

// c[8][4] = A . B^T for this warp's 16 rows (A operands a[kk]) against the 64
// rows of a [row][d] tile: the tile's plain 8x8 matrices are B operands; lane
// l addresses row (l % 8) + 8 (l / 16), column block (l / 8) % 2.
__device__ __forceinline__ void product_nt(float (&c)[BT / 8][4],
                                           const unsigned (&a)[HD / 16][4],
                                           const bf16* tile, int lane) {
#pragma unroll
  for (int n = 0; n < BT / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[n][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < BT / 16; ++j) {
      unsigned b[4];
      ldsm_x4(b, tile + (j * 16 + lane % 8 + (lane / 16) * 8) * LD + kk * 16 +
                     ((lane / 8) % 2) * 8);
      mma16816(c[2 * j], a[kk], b[0], b[1]);
      mma16816(c[2 * j + 1], a[kk], b[2], b[3]);
    }
  }
}

// acc[8][4] += P . T for this warp's 16 rows, P (16 x 64) given in the
// accumulator layout and rounded to bf16 here, T a [row][d] tile whose
// transposed 8x8 matrices are the B operands.
__device__ __forceinline__ void product_acc(float (&acc)[HD / 8][4],
                                            const float (&p)[BT / 8][4],
                                            const bf16* tile) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    unsigned a[4];
    a[0] = pack_bf16x2(p[2 * kk][0], p[2 * kk][1]);
    a[1] = pack_bf16x2(p[2 * kk][2], p[2 * kk][3]);
    a[2] = pack_bf16x2(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    a[3] = pack_bf16x2(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
      unsigned b[4];
      ldsm_x4_t(b, tile_lane_row(tile + kk * 16 * LD + j * 16, LD));
      mma16816(acc[2 * j], a, b[0], b[1]);
      mma16816(acc[2 * j + 1], a, b[2], b[3]);
    }
  }
}

// Rows g and g + 8 of this warp's 16 x 64 accumulator, times `mul`, into the
// (B, L, 3W) output at `dst` (row 0 of the block's tile, this head's columns).
__device__ __forceinline__ void store_rows(bf16* dst, long row_stride,
                                           const float (&acc)[HD / 8][4], float mul,
                                           int row0, int L, int warp, int lane) {
  const int g = lane / 4, tq = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + r * 8;
    if (row0 + row >= L) continue;
    bf16* p = dst + (long)row * row_stride + 2 * tq;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(p + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * r] * mul, acc[n][2 * r + 1] * mul);
  }
}

// ---------------------------------------------------------------------------
// bf16, kernel 1: row statistics, then dQ. Shared memory: Q, dO, K[2], V[2].
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NTHREADS)
attention_bwd_dq_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dO,
                        bf16* __restrict__ dqkv, float* __restrict__ lse_out,
                        float* __restrict__ d_out, int L, int W, int H, int n_keys,
                        float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  auto tile = [&](int i) { return reinterpret_cast<bf16*>(smem + i * TILE); };
  bf16* Qs = tile(0);
  bf16* Gs = tile(1);
  auto kbuf = [&](int i) { return tile(2 + i); };
  auto vbuf = [&](int i) { return tile(4 + i); };

  const int q0 = blockIdx.x * BT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const long row_stride = 3L * W;
  const bf16* base = qkv + (long)b * L * row_stride + h * HD;
  const bf16* ksrc = base + W;
  const bf16* vsrc = base + 2 * W;
  const int ntiles = (n_keys + BT - 1) / BT;

  load_panel(Qs, base, row_stride, q0, L);
  load_panel(Gs, dO + (long)b * L * W + h * HD, W, q0, L);
  load_panel(kbuf(0), ksrc, row_stride, 0, L);
  load_panel(vbuf(0), vsrc, row_stride, 0, L);
  cp_async_commit();

  unsigned qa[HD / 16][4], ga[HD / 16][4];   // this warp's Q and dO rows
  float dq[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq[n][i] = 0.f;
  // Rows g and g + 8: running max, then (per-lane partial) sum and
  // sum(p * dP); after the first sweep, the log-sum-exp and D.
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f}, d_run[2] = {0.f, 0.f};
  float lse[2] = {0.f, 0.f}, dsum[2] = {0.f, 0.f};

  for (int it = 0; it < 2 * ntiles; ++it) {
    const int kt = it % ntiles;
    if (it + 1 < 2 * ntiles) {
      const int nt = (it + 1) % ntiles;
      load_panel(kbuf((it + 1) & 1), ksrc, row_stride, nt * BT, L);
      load_panel(vbuf((it + 1) & 1), vsrc, row_stride, nt * BT, L);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        ldsm_x4(qa[kk], tile_lane_row(Qs + warp * 16 * LD + kk * 16, LD));
        ldsm_x4(ga[kk], tile_lane_row(Gs + warp * 16 * LD + kk * 16, LD));
      }
    }
    if (it == ntiles) {
      // End of the first sweep: finish the statistics and write them out.
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float l = l_run[r], d = d_run[r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        d += __shfl_xor_sync(0xffffffffu, d, 1);
        d += __shfl_xor_sync(0xffffffffu, d, 2);
        lse[r] = m_run[r] + logf(l);
        dsum[r] = d / l;
        const int q = q0 + warp * 16 + g + r * 8;
        if (tq == 0 && q < L) {
          const long off = ((long)b * H + h) * L + q;
          lse_out[off] = lse[r];
          d_out[off] = dsum[r];
        }
      }
    }
    const bf16* Kt = kbuf(it & 1);
    const bf16* Vt = vbuf(it & 1);

    float sc[BT / 8][4], dp[BT / 8][4];
    product_nt(sc, qa, Kt, lane);        // Q K^T
    product_nt(dp, ga, Vt, lane);        // dO V^T
    const int k0 = kt * BT;
    // The lane holds columns 2tq, 2tq+1 of each n8 tile for rows g (i = 0, 1)
    // and g + 8 (i = 2, 3).
#pragma unroll
    for (int n = 0; n < BT / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + n * 8 + 2 * tq + (i & 1);
        sc[n][i] = key < n_keys ? sc[n][i] * scale : -INFINITY;
      }

    if (it < ntiles) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < BT / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) mx[i / 2] = fmaxf(mx[i / 2], sc[n][i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // k0 < n_keys, so key k0 is real and the row max is finite.
        const float m_new = fmaxf(m_run[r], mx[r]);
        const float alpha = expf(m_run[r] - m_new);
        m_run[r] = m_new;
        l_run[r] *= alpha;
        d_run[r] *= alpha;
      }
#pragma unroll
      for (int n = 0; n < BT / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = expf(sc[n][i] - m_run[i / 2]);
          l_run[i / 2] += p;
          d_run[i / 2] += p * dp[n][i];
        }
    } else {
      // dS = P (dP - D), in place of the scores; dQ += dS K.
#pragma unroll
      for (int n = 0; n < BT / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          sc[n][i] = expf(sc[n][i] - lse[i / 2]) * (dp[n][i] - dsum[i / 2]);
      product_acc(dq, sc, Kt);
    }
    __syncthreads();  // this tile's buffers are refilled next iteration
  }

  store_rows(dqkv + ((long)b * L + q0) * row_stride + h * HD, row_stride, dq, scale,
             q0, L, warp, lane);
}

// ---------------------------------------------------------------------------
// bf16, kernel 2: dK and dV. Shared memory: K, V, Q[2], dO[2], then the query
// columns' statistics lse[2][64], D[2][64].
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NTHREADS)
attention_bwd_dkv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dO,
                         bf16* __restrict__ dqkv, const float* __restrict__ lse_in,
                         const float* __restrict__ d_in, int L, int W, int H,
                         int n_keys, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  auto tile = [&](int i) { return reinterpret_cast<bf16*>(smem + i * TILE); };
  bf16* Ks = tile(0);
  bf16* Vs = tile(1);
  auto qbuf = [&](int i) { return tile(2 + i); };
  auto gbuf = [&](int i) { return tile(4 + i); };
  float* stat = reinterpret_cast<float*>(smem + 6 * TILE);   // [2][2][64]

  const int k0 = blockIdx.x * BT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const long row_stride = 3L * W;
  const bf16* base = qkv + (long)b * L * row_stride + h * HD;
  const bf16* gsrc = dO + (long)b * L * W + h * HD;
  const float* lse_row = lse_in + ((long)b * H + h) * L;
  const float* d_row = d_in + ((long)b * H + h) * L;
  const int ntiles = (L + BT - 1) / BT;

  // Statistics of query tile t into buffer `buf`: threads 0-63 take the
  // log-sum-exp (+inf past L, which makes P zero there), 64-127 take D.
  auto load_stats = [&](int buf, int t) {
    const int c = threadIdx.x % BT, q = t * BT + c;
    const bool is_d = threadIdx.x >= BT;
    float v = is_d ? 0.f : INFINITY;
    if (q < L) v = is_d ? d_row[q] : lse_row[q];
    stat[(buf * 2 + (is_d ? 1 : 0)) * BT + c] = v;
  };

  load_panel(Ks, base + W, row_stride, k0, L);
  load_panel(Vs, base + 2 * W, row_stride, k0, L);
  load_panel(qbuf(0), base, row_stride, 0, L);
  load_panel(gbuf(0), gsrc, W, 0, L);
  cp_async_commit();
  load_stats(0, 0);

  unsigned ka[HD / 16][4], va[HD / 16][4];   // this warp's K and V rows
  float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[n][i] = dv[n][i] = 0.f;
  // Keys of rows g and g + 8; rows at or past n_keys are masked (P = 0).
  const bool live[2] = {k0 + warp * 16 + g < n_keys, k0 + warp * 16 + g + 8 < n_keys};

  for (int qt = 0; qt < ntiles; ++qt) {
    if (qt + 1 < ntiles) {
      load_panel(qbuf((qt + 1) & 1), base, row_stride, (qt + 1) * BT, L);
      load_panel(gbuf((qt + 1) & 1), gsrc, W, (qt + 1) * BT, L);
      cp_async_commit();
      load_stats((qt + 1) & 1, qt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (qt == 0) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        ldsm_x4(ka[kk], tile_lane_row(Ks + warp * 16 * LD + kk * 16, LD));
        ldsm_x4(va[kk], tile_lane_row(Vs + warp * 16 * LD + kk * 16, LD));
      }
    }
    const bf16* Qt = qbuf(qt & 1);
    const bf16* Gt = gbuf(qt & 1);
    const float* lse_s = stat + (qt & 1) * 2 * BT;
    const float* d_s = lse_s + BT;

    float st[BT / 8][4], dpt[BT / 8][4];
    product_nt(st, ka, Qt, lane);        // S^T = K Q^T
    product_nt(dpt, va, Gt, lane);       // dP^T = V dO^T
    // The lane holds query columns 2tq, 2tq+1 of each n8 tile for key rows g
    // (i = 0, 1) and g + 8 (i = 2, 3). P^T in st, dS^T in dpt.
#pragma unroll
    for (int n = 0; n < BT / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = n * 8 + 2 * tq + (i & 1);
        const float p = live[i / 2] ? expf(st[n][i] * scale - lse_s[c]) : 0.f;
        st[n][i] = p;
        dpt[n][i] = p * (dpt[n][i] - d_s[c]);
      }
    product_acc(dv, st, Gt);             // dV += P^T dO
    product_acc(dk, dpt, Qt);            // dK += dS^T Q
    __syncthreads();  // this tile's buffers are refilled next iteration
  }

  bf16* out = dqkv + ((long)b * L + k0) * row_stride + h * HD;
  store_rows(out + W, row_stride, dk, scale, k0, L, warp, lane);
  store_rows(out + 2 * W, row_stride, dv, 1.f, k0, L, warp, lane);
}

// ---------------------------------------------------------------------------
// fp32: the same two kernels on shared-memory tiles with plain FMAs.
// ---------------------------------------------------------------------------

constexpr int LDF = HD + 4;            // fp32 tile row stride
constexpr size_t TILE_F = round_up(sizeof(float) * BT * LDF, 128);

__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              long row_stride, int r0, int L) {
  constexpr int VPR = HD / 4;
  for (int i = threadIdx.x; i < BT * VPR; i += NTHREADS) {
    const int r = i / VPR, c = (i % VPR) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < L)
      val = *reinterpret_cast<const float4*>(src + (long)(r0 + r) * row_stride + c);
    *reinterpret_cast<float4*>(dst + r * LDF + c) = val;
  }
}

// C[r][c] = sum_d A[r][d] B[c][d] over the 64 x 64 tile, all threads.
__device__ __forceinline__ void tile_nt_f32(float* C, const float* A, const float* Bt) {
  for (int i = threadIdx.x; i < BT * BT; i += NTHREADS) {
    const int r = i / BT, c = i % BT;
    float acc = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) acc = fmaf(A[r * LDF + d], Bt[c * LDF + d], acc);
    C[r * LDF + c] = acc;
  }
}

// Acc[r][d] += sum_c P[r][c] T[c][d] over the 64 x 64 tile, all threads.
__device__ __forceinline__ void tile_acc_f32(float* Acc, const float* P, const float* T) {
  for (int i = threadIdx.x; i < BT * HD; i += NTHREADS) {
    const int r = i / HD, d = i % HD;
    float acc = Acc[r * LDF + d];
#pragma unroll 8
    for (int c = 0; c < BT; ++c) acc = fmaf(P[r * LDF + c], T[c * LDF + d], acc);
    Acc[r * LDF + d] = acc;
  }
}

// Shared memory: Q, dO, K, V, S, dP, dQ (7 tiles) and the row statistics
// m, l, d (3 x 64). Threads 0-63 own one query row's statistics each.
__global__ void __launch_bounds__(NTHREADS)
attention_bwd_dq_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ dO,
                            float* __restrict__ dqkv, float* __restrict__ lse_out,
                            float* __restrict__ d_out, int L, int W, int H, int n_keys,
                            float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  auto tile = [&](int i) { return reinterpret_cast<float*>(smem + i * TILE_F); };
  float *Qs = tile(0), *Gs = tile(1), *Ks = tile(2), *Vs = tile(3), *Ss = tile(4),
        *Ps = tile(5), *Acc = tile(6);
  float* rowstat = tile(7);            // [3][64]: m (then lse), l, d (then D)

  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const long row_stride = 3L * W;
  const float* base = qkv + (long)b * L * row_stride + h * HD;
  const int ntiles = (n_keys + BT - 1) / BT;
  const int row = threadIdx.x;         // statistics owner when < 64

  load_tile_f32(Qs, base, row_stride, q0, L);
  load_tile_f32(Gs, dO + (long)b * L * W + h * HD, W, q0, L);
  for (int i = threadIdx.x; i < BT * LDF; i += NTHREADS) Acc[i] = 0.f;
  if (row < BT) {
    rowstat[row] = -INFINITY;
    rowstat[BT + row] = 0.f;
    rowstat[2 * BT + row] = 0.f;
  }
  __syncthreads();

  for (int it = 0; it < 2 * ntiles; ++it) {
    const int k0 = (it % ntiles) * BT;
    if (it == ntiles && row < BT) {
      const float l = rowstat[BT + row];
      rowstat[row] += logf(l);
      rowstat[2 * BT + row] /= l;
      if (q0 + row < L) {
        const long off = ((long)b * H + h) * L + q0 + row;
        lse_out[off] = rowstat[row];
        d_out[off] = rowstat[2 * BT + row];
      }
    }
    load_tile_f32(Ks, base + W, row_stride, k0, L);
    load_tile_f32(Vs, base + 2 * W, row_stride, k0, L);
    __syncthreads();
    tile_nt_f32(Ss, Qs, Ks);
    tile_nt_f32(Ps, Gs, Vs);
    __syncthreads();
    if (it < ntiles) {
      if (row < BT) {
        float mx = -INFINITY;
        for (int c = 0; c < BT && k0 + c < n_keys; ++c)
          mx = fmaxf(mx, Ss[row * LDF + c] * scale);
        const float m_new = fmaxf(rowstat[row], mx);
        const float alpha = expf(rowstat[row] - m_new);
        float l = rowstat[BT + row] * alpha, d = rowstat[2 * BT + row] * alpha;
        for (int c = 0; c < BT && k0 + c < n_keys; ++c) {
          const float p = expf(Ss[row * LDF + c] * scale - m_new);
          l += p;
          d += p * Ps[row * LDF + c];
        }
        rowstat[row] = m_new;
        rowstat[BT + row] = l;
        rowstat[2 * BT + row] = d;
      }
    } else {
      for (int i = threadIdx.x; i < BT * BT; i += NTHREADS) {
        const int r = i / BT, c = i % BT;
        const float p = k0 + c < n_keys
                            ? expf(Ss[r * LDF + c] * scale - rowstat[r]) : 0.f;
        Ss[r * LDF + c] = p * (Ps[r * LDF + c] - rowstat[2 * BT + r]);
      }
      __syncthreads();
      tile_acc_f32(Acc, Ss, Ks);
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < BT * HD; i += NTHREADS) {
    const int r = i / HD, d = i % HD;
    if (q0 + r < L)
      dqkv[((long)b * L + q0 + r) * row_stride + h * HD + d] = Acc[r * LDF + d] * scale;
  }
}

// Shared memory: K, V, Q, dO, P^T, dS^T, dK, dV (8 tiles) and lse, D (2 x 64).
__global__ void __launch_bounds__(NTHREADS)
attention_bwd_dkv_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ dO,
                             float* __restrict__ dqkv, const float* __restrict__ lse_in,
                             const float* __restrict__ d_in, int L, int W, int H,
                             int n_keys, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  auto tile = [&](int i) { return reinterpret_cast<float*>(smem + i * TILE_F); };
  float *Ks = tile(0), *Vs = tile(1), *Qs = tile(2), *Gs = tile(3), *Pt = tile(4),
        *Dt = tile(5), *dK = tile(6), *dV = tile(7);
  float* stat = tile(8);               // [2][64]: lse, D of the query columns

  const int k0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const long row_stride = 3L * W;
  const float* base = qkv + (long)b * L * row_stride + h * HD;
  const float* gsrc = dO + (long)b * L * W + h * HD;
  const float* lse_row = lse_in + ((long)b * H + h) * L;
  const float* d_row = d_in + ((long)b * H + h) * L;

  load_tile_f32(Ks, base + W, row_stride, k0, L);
  load_tile_f32(Vs, base + 2 * W, row_stride, k0, L);
  for (int i = threadIdx.x; i < BT * LDF; i += NTHREADS) dK[i] = dV[i] = 0.f;

  for (int q0 = 0; q0 < L; q0 += BT) {
    load_tile_f32(Qs, base, row_stride, q0, L);
    load_tile_f32(Gs, gsrc, W, q0, L);
    {
      const int c = threadIdx.x % BT, q = q0 + c;
      const bool is_d = threadIdx.x >= BT;
      float v = is_d ? 0.f : INFINITY;
      if (q < L) v = is_d ? d_row[q] : lse_row[q];
      stat[(is_d ? BT : 0) + c] = v;
    }
    __syncthreads();
    tile_nt_f32(Pt, Ks, Qs);
    tile_nt_f32(Dt, Vs, Gs);
    __syncthreads();
    for (int i = threadIdx.x; i < BT * BT; i += NTHREADS) {
      const int r = i / BT, c = i % BT;
      const float p = k0 + r < n_keys ? expf(Pt[r * LDF + c] * scale - stat[c]) : 0.f;
      Pt[r * LDF + c] = p;
      Dt[r * LDF + c] = p * (Dt[r * LDF + c] - stat[BT + c]);
    }
    __syncthreads();
    tile_acc_f32(dV, Pt, Gs);
    tile_acc_f32(dK, Dt, Qs);
    __syncthreads();
  }

  for (int i = threadIdx.x; i < BT * HD; i += NTHREADS) {
    const int r = i / HD, d = i % HD;
    if (k0 + r < L) {
      float* out = dqkv + ((long)b * L + k0 + r) * row_stride + h * HD + d;
      out[W] = dK[r * LDF + d] * scale;
      out[2 * W] = dV[r * LDF + d];
    }
  }
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, size_t smem, dim3 grid, cudaStream_t stream,
                   Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NTHREADS, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. lse and d are (B, H, L) float32 scratch.
// Returns the first failing launch's cudaError_t.
extern "C" int aaclip_packed_attention_bwd(const void* qkv, const void* dO, void* dqkv,
                                           void* lse, void* d, int B, int L, int W,
                                           int num_heads, int head_dim, int valid_len,
                                           float scale, int dtype, void* stream) {
  if (B <= 0 || L <= 0 || num_heads <= 0 || head_dim * num_heads != W ||
      valid_len <= 0 || (W % 8) != 0)
    return cudaErrorInvalidValue;
  // Head width 64 only, as the forward kernel.
  if (head_dim != HD) return cudaErrorInvalidValue;
  const int n_keys = valid_len < L ? valid_len : L;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  float* d_f = static_cast<float*>(d);
  const dim3 grid((L + BT - 1) / BT, num_heads, B);
  cudaError_t err;
  if (dtype == 1) {
    const bf16* x = static_cast<const bf16*>(qkv);
    const bf16* g = static_cast<const bf16*>(dO);
    bf16* out = static_cast<bf16*>(dqkv);
    err = launch(attention_bwd_dq_kernel, 6 * TILE, grid, s, x, g, out, lse_f, d_f, L,
                 W, num_heads, n_keys, scale);
    if (err != cudaSuccess) return err;
    return launch(attention_bwd_dkv_kernel, 6 * TILE + 4 * BT * sizeof(float), grid, s,
                  x, g, out, (const float*)lse_f, (const float*)d_f, L, W, num_heads,
                  n_keys, scale);
  }
  if (dtype == 0) {
    const float* x = static_cast<const float*>(qkv);
    const float* g = static_cast<const float*>(dO);
    float* out = static_cast<float*>(dqkv);
    err = launch(attention_bwd_dq_f32_kernel, 7 * TILE_F + 3 * BT * sizeof(float), grid,
                 s, x, g, out, lse_f, d_f, L, W, num_heads, n_keys, scale);
    if (err != cudaSuccess) return err;
    return launch(attention_bwd_dkv_f32_kernel, 8 * TILE_F + 2 * BT * sizeof(float),
                  grid, s, x, g, out, (const float*)lse_f, (const float*)d_f, L, W,
                  num_heads, n_keys, scale);
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* aaclip_packed_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
