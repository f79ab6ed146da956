// Packed-qkv self-attention backward for Hopper (sm_90a), plain (B4) and
// value-value (B6).
//
// Replaces the TPU kernels aa_clip_iqm_tpu/ops/pallas_attention.py:
// _flash_packed_bwd_kernelized -> _bwd_kernel_grouped (B4: one program per
// q-block with whole (blk, L) score rows in VMEM, dK/dV carried in fp32
// scratch across the sequential q-block axis of the grid) and
// _flash_packed_vv_bwd_kernelized -> _vv_bwd_kernel_grouped (B6: the same
// walk for q = k = v = A, the three terms of dA summed in one fp32 scratch).
//
// What it computes, per (batch b, head h), from the packed qkv (B, L, 3W),
// dO (B, L, W) and the row log-sum-exp (B, H, L) that the forward (B1,
// csrc/packed_attention.cu) wrote:
//   S = scale * Q K^T in fp32, keys >= valid_len masked; P = exp(S - lse);
//   dP = dO V^T;  D = rowsum(P * dP);  dS = P * (dP - D);
//   dV = P^T dO;  dQ = scale * dS K;  dK = scale * dS^T Q,
// with P and dS rounded to the input dtype before their products, fp32
// accumulation everywhere and one rounding of dQ, dK, dV at the end. The
// three land in one dqkv (B, L, 3W) at column sections 0, W and 2W, so no
// concatenation follows. D is rowsum(P * dP) with the fp32 P, as the TPU
// kernel has it. The scale is applied to the fp32 products (S after Q K^T,
// dK after dS^T Q), where the TPU kernel scales q first: the same numbers
// whenever the scale is a power of two, as it is for the one head width
// built here (64).
//
// What bounds it on the H100: at ViT-L/518 (B=8, L=1370, 16 heads of 64)
// the five distinct products are 10*B*H*L^2*hd = 1.54e11 FLOP (155 us at 989
// TFLOP/s dense bf16) against ~157 MB of qkv/dO/dqkv traffic (47 us at 3.35
// TB/s): compute-bound. Without atomics, and with D summed from P * dP,
// S and dP are computed three times: nine products, 2.77e11 FLOP, 280 us at
// the peak.
//
// What the design does about it. Two launches on one stream, no atomics, so
// the result is the same from run to run:
//   1. dq kernel, one block per 128-query tile: a first pass over the key
//      tiles computes S, dP and P from the saved log-sum-exp (no running
//      max) and sums D; it writes each query's {lse log2 e, D} into one
//      (B, H, Lp, 2) fp32 array (Lp = L rounded up to 64; {inf, 0} past L);
//      a second pass computes S, dP and dS and accumulates dQ += dS K;
//   2. dk/dv kernel, one block per 128-key tile, walking the query tiles:
//      the transposed tiles S^T = K Q^T and dP^T = V dO^T, P^T and dS^T from
//      the statistics (one 16-byte load for two query columns), dV += P^T dO
//      and dK += dS^T Q.
// Both are warp-specialised on the wgmma core's primitives
// (csrc/gemm_sm90.cuh): a producer warp loads the block's own 128 rows once
// and streams the other side's 64-row tiles through a 4-stage mbarrier ring
// by TMA (3-D tensor maps over (B, L, columns), so a tile's rows past L read
// as zero; 128-byte swizzle); two consumer warpgroups of 64 rows each run
// wgmma.mma_async m64n64k16: the S-type products with the block's own rows
// as A fragments in registers (read once by ldmatrix through the swizzle)
// and the streamed tile as a K-major B, then P or dS converted in registers
// to the A operand of the second product, whose B (a [row][hd] tile) is read
// N-major through the transpose bit. The exponentials are exp2 of a fused
// multiply-add, and run while the tile's dP product does. Keys at or past
// valid_len are masked before the exponent, queries past L get P = 0 from
// an infinite log-sum-exp.
//
// The value-value variant (VV = true; CLIP-Surgery, q = k = v = A, the value
// columns) takes the same kernels with all three operand sections at the
// value columns. A is read as Q, K and V at once, so its gradient has three
// terms, dA = P^T dO + scale dS A + scale dS^T A (value, query and key
// operands). The dq kernel writes the query term per token, unrounded, to an
// fp32 (B, L, W) scratch; the dk/dv kernel adds it to the value and key terms
// of the same tokens and rounds each element of dA once, as the TPU kernel's
// single fp32 scratch does. It writes zeros to the q and k columns of dqkv
// (the forward never reads them). fp32 inputs take the same two launches
// with 64-row shared-memory tiles and plain FMAs. Head width 64 only, as the
// forward. Not yet done: one pass with dQ reduced across key tiles, a
// software pipeline that overlaps one tile's exponentials with the next
// tile's products inside a warpgroup, persistent blocks.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "gemm_sm90.cuh"

using namespace aaclip;

namespace {

constexpr int HD = 64;
constexpr float LOG2E = 1.4426950408889634f;

// 2^x in one MUFU instruction (ex2.approx, relative error about 2^-22,
// subnormal results flushed to zero): P is rounded to bf16 before it is
// used, and keeps it by far.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Column offsets of the operands in a packed qkv row: q, k, v at sections 0,
// 1, 2, or all three at the value section for the value-value variant.
template <bool VV>
__host__ __device__ __forceinline__ int q_off(int W) { return VV ? 2 * W : 0; }
template <bool VV>
__host__ __device__ __forceinline__ int k_off(int W) { return VV ? 2 * W : W; }

// The query statistics that the dq kernel writes and the dk/dv kernel reads,
// one
// (B, H, Lp, 2) fp32 array with Lp = L rounded up to 64: for each query
// {lse log2 e, D}, so that a thread loads a pair of query columns with one
// 16-byte load and P = 2^(S scale log2 e - lse log2 e); queries in [L, Lp)
// hold {inf, 0}: P = 0 there.
__host__ __device__ __forceinline__ int padded(int L) { return (L + 63) / 64 * 64; }

// ---------------------------------------------------------------------------
// bf16: the two tile kernels on wgmma, fed by TMA.
// ---------------------------------------------------------------------------

constexpr int BR = 128;                // rows a block owns: two warpgroups of 64
constexpr int BS = 64;                 // rows of a streamed tile
constexpr int THREADS = 384;           // consumer warpgroups 0 and 1, producer 2
constexpr int STAGES = 4;
constexpr int OWN = BR * HD * 2;       // bytes of one owned 128-row box
constexpr int TILE = BS * HD * 2;      // bytes of one streamed 64-row box
constexpr int RING = 2 * OWN;          // the ring follows the two owned boxes
constexpr int BARS = RING + STAGES * 2 * TILE;
constexpr int SMEM = BARS + (2 * STAGES + 1) * 8 + 1024;   // + 1 KB to align

// The four 3-D tensor maps of a call: qkv (B, L, 3W) and dO (B, L, W), each
// in 128-row boxes (a block's own rows) and 64-row boxes (the streamed
// tiles).
struct Maps {
  CUtensorMap qkv_own, qkv_tile, do_own, do_tile;
};

// What both tile kernels share: the block's own boxes X, Y (loaded once),
// the ring of streamed pairs (U, V) and its barriers.
struct Ring {
  unsigned char* own;                  // X at 0, Y at OWN
  unsigned char* ring;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* own_full;
  __device__ unsigned char* u(int s) const { return ring + s * 2 * TILE; }
  __device__ unsigned char* v(int s) const { return ring + s * 2 * TILE + TILE; }
};

__device__ __forceinline__ Ring make_ring() {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  Ring r;
  r.own = smem;
  r.ring = smem + RING;
  r.full = reinterpret_cast<uint64_t*>(smem + BARS);
  r.empty = r.full + STAGES;
  r.own_full = r.empty + STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      gemm90::mbar_init(&r.full[s], 1);
      gemm90::mbar_init(&r.empty[s], 2);   // one arrival per consumer warpgroup
    }
    gemm90::mbar_init(r.own_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return r;
}

// The producer thread: the block's own rows (x at column x_col of map
// x_map, y at y_col of y_map, rows r0 .. r0 + 127 of batch b), then the
// tiles of 64 rows (u at u_col of u_map, v at v_col of v_map) passes times
// over, n tiles a pass.
__device__ __forceinline__ void produce(const Ring& r, const CUtensorMap& x_map, int x_col,
                                        const CUtensorMap& y_map, int y_col, int r0,
                                        const CUtensorMap& u_map, int u_col,
                                        const CUtensorMap& v_map, int v_col, int n, int passes,
                                        int b) {
  gemm90::mbar_expect_tx(r.own_full, 2 * OWN);
  gemm90::tma_load_3d(r.own, x_map, r.own_full, x_col, r0, b);
  gemm90::tma_load_3d(r.own + OWN, y_map, r.own_full, y_col, r0, b);
  for (int t = 0; t < n * passes; ++t) {
    const int s = t % STAGES;
    gemm90::mbar_wait(&r.empty[s], ((t / STAGES) & 1) ^ 1);
    gemm90::mbar_expect_tx(&r.full[s], 2 * TILE);
    gemm90::tma_load_3d(r.u(s), u_map, &r.full[s], u_col, t % n * BS, b);
    gemm90::tma_load_3d(r.v(s), v_map, &r.full[s], v_col, t % n * BS, b);
  }
}

// Descriptors: a streamed [row][hd] tile as the K-major B operand (its rows
// are the product's N) or as the N-major B operand (its rows are the
// product's K, read through the transpose bit). k-step kk of 16.
__device__ __forceinline__ uint64_t tile_k_major(const unsigned char* tile, int kk) {
  return gemm90::smem_desc(tile + kk * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t tile_n_major(const unsigned char* tile, int kk) {
  return gemm90::smem_desc(tile + kk * 16 * 128, TILE, 1024);
}

// The warpgroup's 64 rows of an owned box as the A fragments of the four
// k-steps over hd, read once with ldmatrix through the 128-byte swizzle
// (16-byte chunk c of row r lies at chunk c ^ (r % 8)): lane l gives row
// l % 16 of the warp's 16, chunk 2 kk + l / 16.
__device__ __forceinline__ void own_fragments(const unsigned char* box, int wg,
                                              unsigned (&a)[4][4]) {
  const int lane = threadIdx.x % 32;
  const int row = wg * 64 + (threadIdx.x % 128 / 32) * 16 + lane % 16;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int chunk = 2 * kk + lane / 16;
    const unsigned char* p = box + row * 128 + ((chunk ^ (row & 7)) << 4);
    ldsm_x4(a[kk], reinterpret_cast<const bf16*>(p));
  }
}

__device__ __forceinline__ void fence_fragments(unsigned (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) gemm90::fence_regs(a[kk]);
}

// The products whose A operand lies in registers. wgmma reads those
// registers after it is issued, until its group has been waited for, so
// each call pins them (fence_fragments) right after the issue, and the
// caller pins them again after the wait: the compiler may neither move
// them nor reuse their registers while the product runs.
//
// acc (64 x 64 of the warpgroup) = A . B^T over hd = 64: A the warpgroup's
// rows of an owned box as register fragments, B a streamed tile read
// K-major.
__device__ __forceinline__ void product_own_tile(float (&acc)[32], unsigned (&a)[4][4],
                                                 const unsigned char* tile) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    gemm90::wgmma_bf16_rs<0>(acc, a[kk], tile_k_major(tile, kk), kk > 0);
  fence_fragments(a);
}

// acc += P . T over the tile's 64 rows: P (64 x 64) given as m16n8k16 A
// fragments in registers, T a streamed tile read N-major.
__device__ __forceinline__ void product_regs_tile(float (&acc)[32], unsigned (&a)[4][4],
                                                  const unsigned char* tile) {
#pragma unroll
  for (int kk = 0; kk < BS / 16; ++kk)
    gemm90::wgmma_bf16_rs<1>(acc, a[kk], tile_n_major(tile, kk));
  fence_fragments(a);
}

// The accumulator layout (per 8-column group i: rows g and g + 8, columns
// 8i + 2 (lane % 4), +1) as the A fragments of the next product's k-steps,
// rounded to bf16: k-step kk takes column groups 2kk and 2kk + 1.
__device__ __forceinline__ void to_a_fragments(const float (&c)[32], unsigned (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16x2(c[8 * kk + 0], c[8 * kk + 1]);
    a[kk][1] = pack_bf16x2(c[8 * kk + 2], c[8 * kk + 3]);
    a[kk][2] = pack_bf16x2(c[8 * kk + 4], c[8 * kk + 5]);
    a[kk][3] = pack_bf16x2(c[8 * kk + 6], c[8 * kk + 7]);
  }
}

// Rows g and g + 8 (h = 0, 1) of the warpgroup's 64 x 64 accumulator, times
// `mul`, into bf16 rows of `dst` (row stride ld) from token row0; rows at or
// past L are skipped.
__device__ __forceinline__ void store_bf16(bf16* dst, long ld, const float (&acc)[32], float mul,
                                           int row0, int L) {
  const int lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= L) continue;
    bf16* p = dst + (long)row * ld + 2 * tq;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * i) =
          __floats2bfloat162_rn(acc[4 * i + 2 * h] * mul, acc[4 * i + 2 * h + 1] * mul);
  }
}

// The dq kernel: D and dQ (for VV the query term, unrounded, into the fp32
// scratch). Owned: Q (X) and dO (Y) of 128 queries; streamed: K (U) and V
// (V) tiles, walked twice: the first pass sums D = rowsum(P * dP) in fp32,
// as the TPU kernel has it, and writes each query's {lse log2 e, D} for the
// dk/dv kernel; the second forms dS and accumulates dQ. (D = rowsum(dO * O)
// from the forward's bf16 output would save the first pass, but O carries
// the bf16 rounding of P in the forward's P V and of its own output: that
// moves dS's rounding in about one entry in a hundred and takes dK past
// the 6-ulp gate against the TPU kernel's at ViT-L/518; under vv, where
// each row's diagonal score dominates and dP - D cancels, dA far past it.)
template <bool VV>
__global__ void __launch_bounds__(THREADS, 1)
attention_bwd_dq_kernel(const __grid_constant__ Maps maps, const float* __restrict__ lse,
                        float2* __restrict__ stats, bf16* __restrict__ dqkv,
                        float* __restrict__ qterm, int L, int W, int H, int n_keys, float scale) {
  const Ring r = make_ring();
  const int q0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const int wg = threadIdx.x / 128;
  const int ntiles = (n_keys + BS - 1) / BS;

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256)
      produce(r, maps.qkv_own, q_off<VV>(W) + h * HD, maps.do_own, h * HD, q0, maps.qkv_tile,
              k_off<VV>(W) + h * HD, maps.qkv_tile, 2 * W + h * HD, ntiles, 2, b);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int lane = threadIdx.x % 32, tq = lane % 4;
  const int row0 = q0 + wg * 64 + (threadIdx.x % 128 / 32) * 16;   // this warp's rows
  // Rows g and g + 8: lse log2 e (P = 2^(S scale log2 e - lse log2 e)),
  // infinite past L: P = 0 there.
  const float scale2 = scale * LOG2E;
  float lse_r[2], d_r[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q = row0 + lane / 4 + 8 * i;
    lse_r[i] = q < L ? lse[((long)b * H + h) * L + q] * LOG2E : INFINITY;
  }
  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  gemm90::fence_regs(dq);
  gemm90::mbar_wait(r.own_full, 0);
  unsigned qa[4][4], ga[4][4];                      // this warpgroup's Q and dO rows
  own_fragments(r.own, wg, qa);
  own_fragments(r.own + OWN, wg, ga);

  // Use t of the ring: S = Q K^T and dP = dO V^T of key tile t % ntiles,
  // and P (keys past n_keys masked) into sc, computed while dP runs.
  auto scores = [&](int t, float (&sc)[32], float (&dp)[32]) {
    const int s = t % STAGES, k0 = t % ntiles * BS;
    gemm90::mbar_wait(&r.full[s], (t / STAGES) & 1);
    gemm90::wgmma_fence();
    product_own_tile(sc, qa, r.u(s));               // Q K^T
    gemm90::wgmma_commit();
    product_own_tile(dp, ga, r.v(s));               // dO V^T
    gemm90::wgmma_commit();
    gemm90::wgmma_wait<1>();
    gemm90::fence_regs(sc);
    if (k0 + BS <= n_keys) {                        // no masked key in the tile
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = fast_exp2(fmaf(sc[i], scale2, -lse_r[(i / 2) & 1]));
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = k0 + 8 * (i / 4) + 2 * tq + (i & 1);
        sc[i] = key < n_keys ? fast_exp2(fmaf(sc[i], scale2, -lse_r[(i / 2) & 1])) : 0.f;
      }
    }
    gemm90::wgmma_wait<0>();
    gemm90::fence_regs(dp);
    fence_fragments(qa);
    fence_fragments(ga);
  };
  auto release = [&](int t) {
    if (threadIdx.x % 128 == 0) gemm90::mbar_arrive(&r.empty[t % STAGES]);
  };

  // Pass 1: D.
  for (int t = 0; t < ntiles; ++t) {
    float sc[32], dp[32];
    scores(t, sc, dp);
    release(t);
#pragma unroll
    for (int i = 0; i < 32; ++i) d_r[(i / 2) & 1] += sc[i] * dp[i];
  }
  const int Lp = padded(L);
  float2* stats_bh = stats + ((long)b * H + h) * Lp;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    d_r[i] += __shfl_xor_sync(0xffffffffu, d_r[i], 1);
    d_r[i] += __shfl_xor_sync(0xffffffffu, d_r[i], 2);
    const int q = row0 + lane / 4 + 8 * i;
    if (tq == 0 && q < Lp)
      stats_bh[q] = q < L ? make_float2(lse_r[i], d_r[i]) : make_float2(INFINITY, 0.f);
  }

  // Pass 2: dS = P (dP - D), dQ += dS K.
  for (int t = ntiles; t < 2 * ntiles; ++t) {
    float sc[32], dp[32];
    scores(t, sc, dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] *= dp[i] - d_r[(i / 2) & 1];
    unsigned ds[4][4];
    to_a_fragments(sc, ds);
    gemm90::wgmma_fence();
    product_regs_tile(dq, ds, r.u(t % STAGES));     // dQ += dS K
    gemm90::wgmma_commit();
    gemm90::wgmma_wait<0>();
    gemm90::fence_regs(dq);
    fence_fragments(ds);
    release(t);
  }

  if (VV) {
    const int g = lane / 4;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + g + 8 * hh;
      if (row >= L) continue;
      float* p = qterm + ((long)b * L + row) * W + h * HD + 2 * tq;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<float2*>(p + 8 * i) =
            make_float2(dq[4 * i + 2 * hh] * scale, dq[4 * i + 2 * hh + 1] * scale);
    }
  } else {
    store_bf16(dqkv + (long)b * L * 3 * W + h * HD, 3L * W, dq, scale, row0, L);
  }
}

// The dk/dv kernel: dK and dV (for VV, dA). Owned: K (X) and V (Y) of 128 keys;
// streamed: Q (U) and dO (V) tiles, and the query columns' statistics read
// into registers ahead of each tile.
template <bool VV>
__global__ void __launch_bounds__(THREADS, 1)
attention_bwd_dkv_kernel(const __grid_constant__ Maps maps,
                         const float4* __restrict__ stats, bf16* __restrict__ dqkv,
                         const float* __restrict__ qterm, int L, int W, int H, int n_keys,
                         float scale) {
  const Ring r = make_ring();
  const int k0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const int wg = threadIdx.x / 128;
  const int ntiles = (L + BS - 1) / BS;

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256)
      produce(r, maps.qkv_own, k_off<VV>(W) + h * HD, maps.qkv_own, 2 * W + h * HD, k0,
              maps.qkv_tile, q_off<VV>(W) + h * HD, maps.do_tile, h * HD, ntiles, 1, b);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int lane = threadIdx.x % 32, tq = lane % 4;
  const int row0 = k0 + wg * 64 + (threadIdx.x % 128 / 32) * 16;   // this warp's keys
  const bool live[2] = {row0 + lane / 4 < n_keys, row0 + lane / 4 + 8 < n_keys};
  const float scale2 = scale * LOG2E;
  // Query pairs (2c, 2c + 1) of this head: {lse log2 e, D, lse log2 e, D}.
  const float4* stats_bh = stats + ((long)b * H + h) * (padded(L) / 2);
  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  gemm90::fence_regs(dk);
  gemm90::fence_regs(dv);
  gemm90::mbar_wait(r.own_full, 0);
  unsigned ka[4][4], va[4][4];                      // this warpgroup's K and V rows
  own_fragments(r.own, wg, ka);
  own_fragments(r.own + OWN, wg, va);

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % STAGES;
    // The query columns 8j + 2 (lane % 4) + e of this tile: lse log2 e
    // (infinite past L: P = 0) and D, loaded while the tile arrives.
    float lse_c[16], d_c[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 sv = stats_bh[(t * BS + 8 * j + 2 * tq) / 2];
      lse_c[2 * j] = sv.x;
      d_c[2 * j] = sv.y;
      lse_c[2 * j + 1] = sv.z;
      d_c[2 * j + 1] = sv.w;
    }
    gemm90::mbar_wait(&r.full[s], (t / STAGES) & 1);
    const unsigned char* Qt = r.u(s);
    const unsigned char* Gt = r.v(s);
    float st[32], dpt[32];
    gemm90::wgmma_fence();
    product_own_tile(st, ka, Qt);                   // S^T = K Q^T
    gemm90::wgmma_commit();
    product_own_tile(dpt, va, Gt);                  // dP^T = V dO^T
    gemm90::wgmma_commit();
    // P^T (keys past n_keys masked: P = 0) while dP^T runs; then dV += P^T
    // dO while dS^T is formed.
    gemm90::wgmma_wait<1>();
    gemm90::fence_regs(st);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      st[i] = live[(i / 2) & 1] ? fast_exp2(fmaf(st[i], scale2, -lse_c[2 * (i / 4) + (i & 1)]))
                                : 0.f;
    unsigned pa[4][4], da[4][4];
    to_a_fragments(st, pa);
    gemm90::wgmma_fence();
    product_regs_tile(dv, pa, Gt);                  // dV += P^T dO
    gemm90::wgmma_commit();
    gemm90::wgmma_wait<1>();
    gemm90::fence_regs(dpt);
    fence_fragments(ka);
    fence_fragments(va);
#pragma unroll
    for (int i = 0; i < 32; ++i) dpt[i] = st[i] * (dpt[i] - d_c[2 * (i / 4) + (i & 1)]);
    to_a_fragments(dpt, da);
    gemm90::wgmma_fence();
    product_regs_tile(dk, da, Qt);                  // dK += dS^T Q
    gemm90::wgmma_commit();
    gemm90::wgmma_wait<0>();
    gemm90::fence_regs(dv);
    gemm90::fence_regs(dk);
    fence_fragments(pa);
    fence_fragments(da);
    if (threadIdx.x % 128 == 0) gemm90::mbar_arrive(&r.empty[s]);
  }

  const long ld = 3L * W;
  bf16* out = dqkv + (long)b * L * ld + h * HD;
  if (VV) {
    // dA = dV + scale dK + the query term, rounded once; zeros in the q and
    // k columns.
    const int g = lane / 4;
    const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + g + 8 * hh;
      if (row >= L) continue;
      bf16* p = out + (long)row * ld + 2 * tq;
      const float* qt = qterm + ((long)b * L + row) * W + h * HD + 2 * tq;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float2 q2 = *reinterpret_cast<const float2*>(qt + 8 * i);
        *reinterpret_cast<__nv_bfloat162*>(p + 8 * i + 2 * W) = __floats2bfloat162_rn(
            dv[4 * i + 2 * hh] + dk[4 * i + 2 * hh] * scale + q2.x,
            dv[4 * i + 2 * hh + 1] + dk[4 * i + 2 * hh + 1] * scale + q2.y);
        *reinterpret_cast<__nv_bfloat162*>(p + 8 * i) = zero;
        *reinterpret_cast<__nv_bfloat162*>(p + 8 * i + W) = zero;
      }
    }
  } else {
    store_bf16(out + W, ld, dk, scale, row0, L);
    store_bf16(out + 2 * W, ld, dv, 1.f, row0, L);
  }
}

// ---------------------------------------------------------------------------
// fp32: the same two kernels on 64-row shared-memory tiles with plain FMAs.
// ---------------------------------------------------------------------------

constexpr int BT = 64;                 // rows per fp32 tile (queries or keys)
constexpr int NTHREADS_F = 128;
constexpr int LDF = HD + 4;            // fp32 tile row stride
constexpr size_t TILE_F = round_up(sizeof(float) * BT * LDF, 128);

__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              long row_stride, int r0, int L) {
  constexpr int VPR = HD / 4;
  for (int i = threadIdx.x; i < BT * VPR; i += NTHREADS_F) {
    const int r = i / VPR, c = (i % VPR) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < L)
      val = *reinterpret_cast<const float4*>(src + (long)(r0 + r) * row_stride + c);
    *reinterpret_cast<float4*>(dst + r * LDF + c) = val;
  }
}

// C[r][c] = sum_d A[r][d] B[c][d] over the 64 x 64 tile, all threads.
__device__ __forceinline__ void tile_nt_f32(float* C, const float* A, const float* Bt) {
  for (int i = threadIdx.x; i < BT * BT; i += NTHREADS_F) {
    const int r = i / BT, c = i % BT;
    float acc = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) acc = fmaf(A[r * LDF + d], Bt[c * LDF + d], acc);
    C[r * LDF + c] = acc;
  }
}

// Acc[r][d] += sum_c P[r][c] T[c][d] over the 64 x 64 tile, all threads.
__device__ __forceinline__ void tile_acc_f32(float* Acc, const float* P, const float* T) {
  for (int i = threadIdx.x; i < BT * HD; i += NTHREADS_F) {
    const int r = i / HD, d = i % HD;
    float acc = Acc[r * LDF + d];
#pragma unroll 8
    for (int c = 0; c < BT; ++c) acc = fmaf(P[r * LDF + c], T[c * LDF + d], acc);
    Acc[r * LDF + d] = acc;
  }
}

// Shared memory: Q, dO, K, V, S, dP, dQ (7 tiles) and the query rows'
// lse log2 e and D (2 x 64). Two sweeps over the keys, as kernel 2: D, then
// dQ; the statistics go out for the dk/dv kernel.
template <bool VV>
__global__ void __launch_bounds__(NTHREADS_F)
attention_bwd_dq_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ dO,
                            float* __restrict__ dqkv, const float* __restrict__ lse,
                            float2* __restrict__ stats, float* __restrict__ qterm, int L, int W,
                            int H, int n_keys, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  auto tile = [&](int i) { return reinterpret_cast<float*>(smem + i * TILE_F); };
  float *Qs = tile(0), *Gs = tile(1), *Ks = tile(2), *Vs = tile(3), *Ss = tile(4),
        *Ps = tile(5), *Acc = tile(6);
  float* rowstat = tile(7);            // [2][64]: lse log2 e, D of the block's query rows

  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const long row_stride = 3L * W;
  const float* base = qkv + (long)b * L * row_stride + h * HD;
  const float scale2 = scale * LOG2E;
  const int ntiles = (n_keys + BT - 1) / BT;
  const int row = threadIdx.x;         // owner of the row's statistics when < 64

  load_tile_f32(Qs, base + q_off<VV>(W), row_stride, q0, L);
  load_tile_f32(Gs, dO + (long)b * L * W + h * HD, W, q0, L);
  for (int i = threadIdx.x; i < BT * LDF; i += NTHREADS_F) Acc[i] = 0.f;
  if (row < BT) {
    // Rows past L: P = 0 (their Q rows are zero and never written).
    const int q = q0 + row;
    rowstat[row] = q < L ? lse[((long)b * H + h) * L + q] * LOG2E : INFINITY;
    rowstat[BT + row] = 0.f;
  }
  __syncthreads();

  for (int it = 0; it < 2 * ntiles; ++it) {
    const int k0 = it % ntiles * BT;
    if (it == ntiles && row < BT && q0 + row < padded(L))
      stats[((long)b * H + h) * padded(L) + q0 + row] =
          make_float2(rowstat[row], rowstat[BT + row]);
    load_tile_f32(Ks, base + k_off<VV>(W), row_stride, k0, L);
    load_tile_f32(Vs, base + 2 * W, row_stride, k0, L);
    __syncthreads();
    tile_nt_f32(Ss, Qs, Ks);
    tile_nt_f32(Ps, Gs, Vs);
    __syncthreads();
    if (it < ntiles) {
      if (row < BT) {
        float d = rowstat[BT + row];
        for (int c = 0; c < BT && k0 + c < n_keys; ++c)
          d += exp2f(Ss[row * LDF + c] * scale2 - rowstat[row]) * Ps[row * LDF + c];
        rowstat[BT + row] = d;
      }
    } else {
      for (int i = threadIdx.x; i < BT * BT; i += NTHREADS_F) {
        const int r = i / BT, c = i % BT;
        const float p = k0 + c < n_keys ? exp2f(Ss[r * LDF + c] * scale2 - rowstat[r]) : 0.f;
        Ss[r * LDF + c] = p * (Ps[r * LDF + c] - rowstat[BT + r]);
      }
      __syncthreads();
      tile_acc_f32(Acc, Ss, Ks);
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < BT * HD; i += NTHREADS_F) {
    const int r = i / HD, d = i % HD;
    if (q0 + r >= L) continue;
    if (VV)
      qterm[((long)b * L + q0 + r) * W + h * HD + d] = Acc[r * LDF + d] * scale;
    else
      dqkv[((long)b * L + q0 + r) * row_stride + h * HD + d] = Acc[r * LDF + d] * scale;
  }
}

// Shared memory: K, V, Q, dO, P^T, dS^T, dK, dV (8 tiles) and lse, D (2 x 64).
template <bool VV>
__global__ void __launch_bounds__(NTHREADS_F)
attention_bwd_dkv_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ dO,
                             float* __restrict__ dqkv, const float2* __restrict__ stats,
                             const float* __restrict__ qterm, int L, int W, int H, int n_keys,
                             float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  auto tile = [&](int i) { return reinterpret_cast<float*>(smem + i * TILE_F); };
  float *Ks = tile(0), *Vs = tile(1), *Qs = tile(2), *Gs = tile(3), *Pt = tile(4),
        *Dt = tile(5), *dK = tile(6), *dV = tile(7);
  float* stat = tile(8);               // [2][64]: lse log2 e, D of the query columns

  const int k0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const long row_stride = 3L * W;
  const float* base = qkv + (long)b * L * row_stride + h * HD;
  const float* gsrc = dO + (long)b * L * W + h * HD;
  const float2* stats_bh = stats + ((long)b * H + h) * padded(L);
  const float scale2 = scale * LOG2E;

  load_tile_f32(Ks, base + k_off<VV>(W), row_stride, k0, L);
  load_tile_f32(Vs, base + 2 * W, row_stride, k0, L);
  for (int i = threadIdx.x; i < BT * LDF; i += NTHREADS_F) dK[i] = dV[i] = 0.f;

  for (int q0 = 0; q0 < L; q0 += BT) {
    load_tile_f32(Qs, base + q_off<VV>(W), row_stride, q0, L);
    load_tile_f32(Gs, gsrc, W, q0, L);
    if (threadIdx.x < BT) {
      const float2 st = stats_bh[q0 + threadIdx.x];
      stat[threadIdx.x] = st.x;
      stat[BT + threadIdx.x] = st.y;
    }
    __syncthreads();
    tile_nt_f32(Pt, Ks, Qs);
    tile_nt_f32(Dt, Vs, Gs);
    __syncthreads();
    for (int i = threadIdx.x; i < BT * BT; i += NTHREADS_F) {
      const int r = i / BT, c = i % BT;
      const float p = k0 + r < n_keys ? exp2f(Pt[r * LDF + c] * scale2 - stat[c]) : 0.f;
      Pt[r * LDF + c] = p;
      Dt[r * LDF + c] = p * (Dt[r * LDF + c] - stat[BT + c]);
    }
    __syncthreads();
    tile_acc_f32(dV, Pt, Gs);
    tile_acc_f32(dK, Dt, Qs);
    __syncthreads();
  }

  for (int i = threadIdx.x; i < BT * HD; i += NTHREADS_F) {
    const int r = i / HD, d = i % HD;
    if (k0 + r >= L) continue;
    float* out = dqkv + ((long)b * L + k0 + r) * row_stride + h * HD + d;
    if (VV) {
      out[0] = out[W] = 0.f;
      out[2 * W] = dV[r * LDF + d] + dK[r * LDF + d] * scale +
                   qterm[((long)b * L + k0 + r) * W + h * HD + d];
    } else {
      out[W] = dK[r * LDF + d] * scale;
      out[2 * W] = dV[r * LDF + d];
    }
  }
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, size_t smem, dim3 grid, int threads, cudaStream_t stream,
                   Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <bool VV>
cudaError_t launch_bf16(const bf16* qkv, const bf16* dO, bf16* dqkv, const float* lse,
                        float* stats, float* qterm, int B, int L, int W, int H, int n_keys,
                        float scale, cudaStream_t s) {
  Maps maps;
  const long ld = 3L * W;
  cudaError_t err = gemm90::tensor_map_3d(&maps.qkv_own, qkv, 3 * W, L, B, ld, L * ld, BR);
  if (err == cudaSuccess)
    err = gemm90::tensor_map_3d(&maps.qkv_tile, qkv, 3 * W, L, B, ld, L * ld, BS);
  if (err == cudaSuccess)
    err = gemm90::tensor_map_3d(&maps.do_own, dO, W, L, B, W, (long)L * W, BR);
  if (err == cudaSuccess)
    err = gemm90::tensor_map_3d(&maps.do_tile, dO, W, L, B, W, (long)L * W, BS);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + BR - 1) / BR, H, B);
  err = launch(attention_bwd_dq_kernel<VV>, SMEM, grid, THREADS, s, maps, lse,
               reinterpret_cast<float2*>(stats), dqkv, qterm, L, W, H, n_keys, scale);
  if (err != cudaSuccess) return err;
  return launch(attention_bwd_dkv_kernel<VV>, SMEM, grid, THREADS, s, maps,
                reinterpret_cast<const float4*>(stats), dqkv, (const float*)qterm, L, W, H,
                n_keys, scale);
}

template <bool VV>
cudaError_t launch_f32(const float* qkv, const float* dO, float* dqkv, const float* lse,
                       float* stats, float* qterm, int B, int L, int W, int H, int n_keys,
                       float scale, cudaStream_t s) {
  const dim3 grid((L + BT - 1) / BT, H, B);
  cudaError_t err = launch(attention_bwd_dq_f32_kernel<VV>, 7 * TILE_F + 2 * BT * sizeof(float),
                           grid, NTHREADS_F, s, qkv, dO, dqkv, lse,
                           reinterpret_cast<float2*>(stats), qterm, L, W, H, n_keys, scale);
  if (err != cudaSuccess) return err;
  return launch(attention_bwd_dkv_f32_kernel<VV>, 8 * TILE_F + 2 * BT * sizeof(float), grid,
                NTHREADS_F, s, qkv, dO, dqkv, reinterpret_cast<const float2*>(stats),
                (const float*)qterm, L, W, H, n_keys, scale);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. lse is the forward's log-sum-exp
// (B, H, L) fp32; stats a (B, H, Lp, 2) fp32 scratch, Lp = L rounded up to
// 64, for each query's {lse log2 e, D}; qterm a (B, L, W) fp32 scratch, used
// only when vv is set (it may be null otherwise). Pointers 16-byte aligned.
// Returns the first failing launch's cudaError_t.
extern "C" int aaclip_packed_attention_bwd(const void* qkv, const void* dO, const void* lse,
                                           void* dqkv, void* stats, void* qterm, int B, int L,
                                           int W, int num_heads, int head_dim, int valid_len,
                                           float scale, int vv, int dtype, void* stream) {
  if (B <= 0 || L <= 0 || num_heads <= 0 || head_dim * num_heads != W || valid_len <= 0 ||
      (W % 8) != 0 || (vv && qterm == nullptr) || lse == nullptr || stats == nullptr ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  // Head width 64 only, as the forward kernel.
  if (head_dim != HD) return cudaErrorInvalidValue;
  const int n_keys = valid_len < L ? valid_len : L;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  float* st = static_cast<float*>(stats);
  float* qt = static_cast<float*>(qterm);
  if (dtype == 1) {
    const bf16* x = static_cast<const bf16*>(qkv);
    const bf16* g = static_cast<const bf16*>(dO);
    bf16* dx = static_cast<bf16*>(dqkv);
    return vv ? launch_bf16<true>(x, g, dx, lse_f, st, qt, B, L, W, num_heads, n_keys, scale, s)
              : launch_bf16<false>(x, g, dx, lse_f, st, qt, B, L, W, num_heads, n_keys, scale,
                                   s);
  }
  const float* x = static_cast<const float*>(qkv);
  const float* g = static_cast<const float*>(dO);
  float* dx = static_cast<float*>(dqkv);
  return vv ? launch_f32<true>(x, g, dx, lse_f, st, qt, B, L, W, num_heads, n_keys, scale, s)
            : launch_f32<false>(x, g, dx, lse_f, st, qt, B, L, W, num_heads, n_keys, scale, s);
}

extern "C" const char* aaclip_packed_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
