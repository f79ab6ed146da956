// Fused attention half of a transformer block for Hopper (sm_90a).
//
// Replaces the TPU kernel aa_clip_iqm_tpu/ops/pallas_attn_block.py:
// ln_attn_residual -> _kernel (one program per (batch item, 2-head panel):
// LayerNorm of the whole item into VMEM once, the panel's q/k/v projected
// from it, whole-row attention, and the out-projection accumulated across
// panels in an fp32 (L, d) VMEM scratch, flushed once with the residual).
//
// What it computes, for x (B, L, d) bf16:
//   xn  = LayerNorm(x) in fp32, rounded to bf16;
//   qkv = xn . W_qkv + b_qkv (bf16 products, fp32 accumulation, fp32 bias,
//         one rounding); for vv only the value section, which is q, k and v;
//   O   = softmax(scale * Q K^T) V per head (fp32 scores and softmax, exact
//         up to the online rescale, P rounded to bf16 before P.V, O rounded
//         to bf16), keys >= valid_len masked;
//   y   = x + O . W_out + b_out, the out-projection accumulated in fp32
//         across all heads, the residual and bias added once, one rounding.
//
// What bounds it on the H100: at ViT-L/518 batch 8 (L = 1370, d = 1024, 16
// heads of 64) 8*B*L*d^2 + 4*B*H*L^2*hd = 9.19e10 + 6.15e10 = 1.53e11 FLOP
// (155 us at 989 TFLOP/s dense bf16) against ~52 MB of x, y and weight
// traffic (16 us at 3.35 TB/s): compute-bound.
//
// What the design does about it. The TPU program keeps a whole item's LN(x)
// (1408 x 1024 bf16, 2.9 MB) and the fp32 (L, d) accumulator (5.8 MB) in VMEM;
// a Hopper block has 227 KB. So two launches on one stream:
//   1. LayerNorm fused into the packed qkv projection. One block (4 warps)
//      per 64-row x 128-column output tile. Its prologue takes the 64 rows'
//      statistics (two passes over the row, fp32); LN(x) is never stored: each
//      32-wide k-slice of the tile is normalised on its way from device memory
//      into a shared-memory ring, next to the W_qkv slice streamed by
//      cp.async, four slots deep. mma.sync m16n8k16 from ldmatrix; the bias
//      joins the fp32 accumulator in the epilogue, which writes qkv once. The
//      projection (B*L, 3d), or (B*L, d) for vv, is the one intermediate in
//      device memory.
//   2. Attention, out-projection and residual. One block (8 warps) per
//      (batch item, 32-query tile), looping over the heads four at a time:
//      each warp pair takes one head, each warp 16 query rows, and runs B1's
//      online-softmax loop (csrc/packed_attention.cu) over 64-key tiles of
//      the four heads' K and V, double-buffered by cp.async. The normalised
//      (32 x 256) output of the four heads is staged in shared memory as bf16
//      and multiplied at once by those heads' 256 rows of W_out, streamed in
//      16-row stages through a 4-slot ring that reuses the K/V buffers. The
//      out-projection accumulator (32 x d fp32) lives in registers for the
//      whole head loop, each warp owning d/8 columns, as B2 holds its own;
//      the epilogue adds b_out and x and rounds once. The attention output
//      never reaches device memory.
// Head width 64, heads in groups of 4 and d <= 1024 only (ViT-L: 16 heads of
// 64). Not yet done: TMA, wgmma, sharing the W_out stream across a cluster.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

using namespace aaclip;

namespace {

constexpr int HD = 64;

// ---------------------------------------------------------------------------
// Launch 1: LayerNorm -> qkv projection.
// ---------------------------------------------------------------------------

constexpr int P_BM = 64;               // rows per block
constexpr int P_BN = 128;              // output columns per block
constexpr int P_BK = 32;               // k per pipeline stage
constexpr int P_SLOTS = 4;             // ring depth: 3 stages in flight
constexpr int P_THREADS = 128;         // 4 warps, 2 x 2 over the 64 x 128 tile
constexpr int P_LDA = P_BK + 8;        // A slot row stride (16-byte padding)
constexpr int P_LDB = P_BN + 8;        // B slot row stride
constexpr size_t P_A = round_up(sizeof(float) * 2 * P_BM, 128);   // after the row stats
constexpr size_t P_ASLOT = round_up(sizeof(bf16) * P_BM * P_LDA, 128);
constexpr size_t P_B = P_A + P_SLOTS * P_ASLOT;
constexpr size_t P_BSLOT = round_up(sizeof(bf16) * P_BK * P_LDB, 128);
constexpr size_t P_BYTES = P_B + P_SLOTS * P_BSLOT;
constexpr int P_AV = P_BM * P_BK / 8 / P_THREADS;   // 16-byte x vectors per thread per stage

// qkv[:, n0 : n0 + 128] = LN(x) . W[:, col_off + n0 : ...] + b[col_off + n0 : ...]
// for 64 rows; W is (d, ldw) row-major, qkv (M, ncols).
__global__ void __launch_bounds__(P_THREADS)
ln_qkv_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_g,
              const float* __restrict__ ln_b, const bf16* __restrict__ w,
              const float* __restrict__ bias, bf16* __restrict__ qkv, int M, int d, int ldw,
              int col_off, int ncols, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* stats = reinterpret_cast<float*>(smem);            // [64][mean, rstd]
  auto aslot = [&](int t) { return reinterpret_cast<bf16*>(smem + P_A + (t % P_SLOTS) * P_ASLOT); };
  auto bslot = [&](int t) { return reinterpret_cast<bf16*>(smem + P_B + (t % P_SLOTS) * P_BSLOT); };

  const int row0 = blockIdx.x * P_BM;
  const int n0 = blockIdx.y * P_BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int wr = warp / 2, wc = warp % 2;   // this warp's 32 rows and 64 columns
  const int nk = d / P_BK;

  // W stage t: k-rows [t * 32, +32) of this block's 128 columns; always
  // commit, so that group counts stay aligned with stage numbers.
  auto issue_b = [&](int t) {
    if (t < nk) {
      const bf16* src = w + (long)(t * P_BK) * ldw + col_off + n0;
      bf16* dst = bslot(t);
      for (int i = threadIdx.x; i < P_BK * (P_BN / 8); i += P_THREADS) {
        const int r = i / (P_BN / 8), c = (i % (P_BN / 8)) * 8;
        cp_async16(dst + r * P_LDB + c, src + (long)r * ldw + c);
      }
    }
    cp_async_commit();
  };
  // x stage t (64 rows x 32 k) goes through registers: loaded, then
  // normalised with the row statistics and the LayerNorm parameters, rounded
  // to bf16 and stored into its ring slot. Rows past M are zero.
  uint4 xa[P_AV];
  auto load_a = [&](int t) {
    if (t >= nk) return;
#pragma unroll
    for (int j = 0; j < P_AV; ++j) {
      const int v = threadIdx.x + j * P_THREADS;
      const int r = v / (P_BK / 8), c = (v % (P_BK / 8)) * 8;
      xa[j] = row0 + r < M
                  ? *reinterpret_cast<const uint4*>(x + (long)(row0 + r) * d + t * P_BK + c)
                  : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto store_a = [&](int t) {
    if (t >= nk) return;
    bf16* dst = aslot(t);
#pragma unroll
    for (int j = 0; j < P_AV; ++j) {
      const int v = threadIdx.x + j * P_THREADS;
      const int r = v / (P_BK / 8), c = (v % (P_BK / 8)) * 8;
      const int k = t * P_BK + c;
      const float mean = stats[2 * r], rstd = stats[2 * r + 1];
      const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&xa[j]);
      uint4 packed;
      unsigned* pw = reinterpret_cast<unsigned*>(&packed);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(xv[e]);
        pw[e] = pack_bf16x2((f.x - mean) * rstd * ln_g[k + 2 * e] + ln_b[k + 2 * e],
                            (f.y - mean) * rstd * ln_g[k + 2 * e + 1] + ln_b[k + 2 * e + 1]);
      }
      *reinterpret_cast<uint4*>(dst + r * P_LDA + c) = packed;
    }
  };

  for (int t = 0; t < P_SLOTS - 1; ++t) issue_b(t);

  // Row statistics, one warp per row, two passes (mean, then the variance
  // about it), fp32. Rows past M get zeros and are never written.
  for (int r = warp; r < P_BM; r += P_THREADS / 32) {
    float mean = 0.f, rstd = 0.f;
    if (row0 + r < M) {
      const bf16* src = x + (long)(row0 + r) * d;
      float s = 0.f;
      for (int c = lane * 8; c < d; c += 256) {
        const uint4 raw = *reinterpret_cast<const uint4*>(src + c);
        const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(v[e]);
          s += f.x + f.y;
        }
      }
      mean = warp_sum(s) / d;
      float q = 0.f;
      for (int c = lane * 8; c < d; c += 256) {
        const uint4 raw = *reinterpret_cast<const uint4*>(src + c);
        const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(v[e]);
          q += (f.x - mean) * (f.x - mean) + (f.y - mean) * (f.y - mean);
        }
      }
      rstd = rsqrtf(warp_sum(q) / d + eps);
    }
    if (lane == 0) {
      stats[2 * r] = mean;
      stats[2 * r + 1] = rstd;
    }
  }
  __syncthreads();
  for (int t = 0; t < P_SLOTS - 1; ++t) {
    load_a(t);
    store_a(t);
  }

  float acc[2][8][4];                  // [row tile][n8 tile][fragment]
#pragma unroll
  for (int rt = 0; rt < 2; ++rt)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[rt][n][i] = 0.f;

  for (int t = 0; t < nk; ++t) {
    cp_async_wait<P_SLOTS - 2>();      // W stage t has landed (this thread's part)
    __syncthreads();                   // ... everyone's, and x stage t; stage t-1 is done
    issue_b(t + P_SLOTS - 1);          // into stage t-1's slot
    load_a(t + P_SLOTS - 1);           // its latency hides behind this stage's products
    const bf16* A = aslot(t);
    const bf16* Bs = bslot(t);
#pragma unroll
    for (int kk = 0; kk < P_BK / 16; ++kk) {
      unsigned a[2][4];
#pragma unroll
      for (int rt = 0; rt < 2; ++rt)
        ldsm_x4(a[rt], tile_lane_row(A + (wr * 32 + rt * 16) * P_LDA + kk * 16, P_LDA));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        unsigned b[4];
        ldsm_x4_t(b, tile_lane_row(Bs + kk * 16 * P_LDB + wc * 64 + j * 16, P_LDB));
#pragma unroll
        for (int rt = 0; rt < 2; ++rt) {
          mma16816(acc[rt][2 * j], a[rt], b[0], b[1]);
          mma16816(acc[rt][2 * j + 1], a[rt], b[2], b[3]);
        }
      }
    }
    store_a(t + P_SLOTS - 1);          // stage t-1's slot, read by no one now
  }
  cp_async_wait<0>();                  // only empty groups remain

  // qkv = acc + bias in fp32, one rounding.
#pragma unroll
  for (int rt = 0; rt < 2; ++rt)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = n0 + wc * 64 + n * 8 + 2 * tq;
      const float b0 = bias[col_off + col], b1 = bias[col_off + col + 1];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + wr * 32 + rt * 16 + g + half * 8;
        if (row < M)
          *reinterpret_cast<__nv_bfloat162*>(qkv + (long)row * ncols + col) =
              __floats2bfloat162_rn(acc[rt][n][2 * half] + b0, acc[rt][n][2 * half + 1] + b1);
      }
    }
}

// ---------------------------------------------------------------------------
// Launch 2: attention -> out-projection -> residual.
// ---------------------------------------------------------------------------

constexpr int A_BQ = 32;               // query rows per block
constexpr int A_THREADS = 256;         // 8 warps
constexpr int G = 4;                   // heads per group: one per warp pair
constexpr int BK = 64;                 // keys per tile
constexpr int LDH = HD + 8;            // K / V tile row stride
constexpr int LDQ = G * HD + 8;        // Q and O staging row stride
constexpr int WS = 16;                 // W_out rows per ring stage
constexpr int W_SLOTS = 4;             // W_out ring depth: 3 stages in flight
constexpr int MAX_G = 8;               // 16-column output groups per warp (d <= 1024)
constexpr size_t KV_TILE = round_up(sizeof(bf16) * BK * LDH, 128);
constexpr size_t S_O = round_up(sizeof(bf16) * A_BQ * LDQ, 128);   // after Q
constexpr size_t S_REGION = 2 * S_O;
constexpr size_t KV_BYTES = 2 * 2 * G * KV_TILE;                    // [stage][K, V][head]

__host__ __device__ inline size_t w_slot_bytes(int d) {
  return round_up(sizeof(bf16) * WS * (d + 8), 128);
}
__host__ __device__ inline size_t attn_smem_bytes(int d) {
  const size_t ring = W_SLOTS * w_slot_bytes(d);
  return S_REGION + (ring > KV_BYTES ? ring : KV_BYTES);
}

// y rows [q0, q0 + 32) of batch item blockIdx.y. qkv holds the item's rows at
// qkv + b * L * ld_qkv, the heads of q, k and v at column offsets q_off,
// k_off and v_off (all three equal for vv).
__global__ void __launch_bounds__(A_THREADS, 1)
attn_out_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ x,
                const bf16* __restrict__ w_out, const float* __restrict__ b_out,
                bf16* __restrict__ y, int L, int d, int H, int ld_qkv, int q_off, int k_off,
                int v_off, int n_keys, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Os = reinterpret_cast<bf16*>(smem + S_O);
  unsigned char* region = smem + S_REGION;   // K/V tiles, then the W_out ring
  auto kv = [&](int stage, int which, int head) {
    return reinterpret_cast<bf16*>(region + ((stage * 2 + which) * G + head) * KV_TILE);
  };
  const int ldw = d + 8;
  const size_t wslot = w_slot_bytes(d);
  auto wbuf = [&](int t) { return reinterpret_cast<bf16*>(region + (t % W_SLOTS) * wslot); };

  const int q0 = blockIdx.x * A_BQ;
  const long tok0 = (long)blockIdx.y * L;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int hw = warp / 2;             // this warp's head within the group
  const int rw = warp % 2;             // this warp's 16 query rows
  const bf16* src = qkv + tok0 * ld_qkv;
  const int ntiles = (n_keys + BK - 1) / BK;
  const int ngroups = d / 128;         // this warp's 16-column output groups
  const int col0 = warp * (d / 8);     // this warp's first output column

  float acc[2][2 * MAX_G][4];          // out-projection: [row tile][n8 tile][fragment]
#pragma unroll
  for (int rt = 0; rt < 2; ++rt)
#pragma unroll
    for (int n = 0; n < 2 * MAX_G; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[rt][n][i] = 0.f;

  for (int h0 = 0; h0 < H; h0 += G) {
    // Keys [k0, k0 + 64) of the group's four heads, K and V, into `stage`;
    // rows at or past L are zero-filled.
    auto load_kv = [&](int stage, int k0) {
      constexpr int VPR = HD / 8;
      for (int i = threadIdx.x; i < 2 * G * BK * VPR; i += A_THREADS) {
        const int which = i / (G * BK * VPR);
        const int head = (i / (BK * VPR)) % G;
        const int r = (i / VPR) % BK, c = (i % VPR) * 8;
        const bool real = k0 + r < L;
        const bf16* p = src + (long)(k0 + r) * ld_qkv + (which ? v_off : k_off) +
                        (h0 + head) * HD + c;
        cp_async16(kv(stage, which, head) + r * LDH + c, real ? p : src, real ? 16 : 0);
      }
    };
    for (int i = threadIdx.x; i < A_BQ * G * (HD / 8); i += A_THREADS) {
      const int r = i / (G * HD / 8), c = (i % (G * HD / 8)) * 8;
      const bool real = q0 + r < L;
      cp_async16(Qs + r * LDQ + c,
                 real ? src + (long)(q0 + r) * ld_qkv + q_off + h0 * HD + c : src,
                 real ? 16 : 0);
    }
    load_kv(0, 0);
    cp_async_commit();

    float o[HD / 8][4];                // this warp's rows of its head's output
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

    for (int kt = 0; kt < ntiles; ++kt) {
      if (kt + 1 < ntiles) {
        load_kv((kt + 1) & 1, (kt + 1) * BK);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* Kt = kv(kt & 1, 0, hw);
      const bf16* Vt = kv(kt & 1, 1, hw);

      // S = Q K^T (B1's layout; the Q operands are re-read from shared
      // memory each tile, which keeps registers for the accumulator).
      float sc[BK / 8][4];
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[n][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        unsigned qa[4];
        ldsm_x4(qa, tile_lane_row(Qs + rw * 16 * LDQ + hw * HD + kk * 16, LDQ));
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) {
          unsigned kb[4];
          ldsm_x4(kb, Kt + (j * 16 + lane % 8 + (lane / 16) * 8) * LDH + kk * 16 +
                          ((lane / 8) % 2) * 8);
          mma16816(sc[2 * j], qa, kb[0], kb[1]);
          mma16816(sc[2 * j + 1], qa, kb[2], kb[3]);
        }
      }

      // Scale, mask, online softmax (rows g and g + 8 of the warp's 16).
      const int k0 = kt * BK;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + n * 8 + 2 * tq + (i & 1);
          const float s = key < n_keys ? sc[n][i] * scale : -INFINITY;
          sc[n][i] = s;
          mx[i / 2] = fmaxf(mx[i / 2], s);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // k0 < n_keys, so key k0 is real and the row max is finite.
        const float m_new = fmaxf(m_run[r], mx[r]);
        const float alpha = expf(m_run[r] - m_new);
        m_run[r] = m_new;
        l_run[r] *= alpha;
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          o[n][2 * r] *= alpha;
          o[n][2 * r + 1] *= alpha;
        }
      }
      // O += P V, P = exp(S - m) rounded to bf16 one 16-key group at a time.
#pragma unroll
      for (int kk2 = 0; kk2 < BK / 16; ++kk2) {
        unsigned pa[4];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int n = 2 * kk2 + h2;
          const float p0 = expf(sc[n][0] - m_run[0]), p1 = expf(sc[n][1] - m_run[0]);
          const float p2 = expf(sc[n][2] - m_run[1]), p3 = expf(sc[n][3] - m_run[1]);
          l_run[0] += p0 + p1;
          l_run[1] += p2 + p3;
          pa[2 * h2] = pack_bf16x2(p0, p1);
          pa[2 * h2 + 1] = pack_bf16x2(p2, p3);
        }
#pragma unroll
        for (int j = 0; j < HD / 16; ++j) {
          unsigned vb[4];
          ldsm_x4_t(vb, tile_lane_row(Vt + kk2 * 16 * LDH + j * 16, LDH));
          mma16816(o[2 * j], pa, vb[0], vb[1]);
          mma16816(o[2 * j + 1], pa, vb[2], vb[3]);
        }
      }
      __syncthreads();  // this tile's buffers are refilled next iteration
    }

    // Normalise and stage this warp's rows of its head as bf16.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
      const float inv = 1.f / l_run[r];
      bf16* dst = Os + (rw * 16 + g + r * 8) * LDQ + hw * HD + 2 * tq;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
            __floats2bfloat162_rn(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    }

    // acc += O[32 x 256] . W_out[h0 * 64 : h0 * 64 + 256, :], in 16-row
    // stages through the ring (which reuses the K/V buffers: every warp is
    // past the loop's last barrier). One barrier per stage, as in B2.
    constexpr int NST = G * HD / WS;
    auto issue_w = [&](int t) {
      if (t < NST) {
        const bf16* wsrc = w_out + (long)(h0 * HD + t * WS) * d;
        bf16* dst = wbuf(t);
        const int vpr = d / 8;
        for (int i = threadIdx.x; i < WS * vpr; i += A_THREADS) {
          const int r = i / vpr, c = (i % vpr) * 8;
          cp_async16(dst + r * ldw + c, wsrc + (long)r * d + c);
        }
      }
      cp_async_commit();
    };
    for (int t = 0; t < W_SLOTS - 1; ++t) issue_w(t);
    for (int t = 0; t < NST; ++t) {
      cp_async_wait<W_SLOTS - 2>();
      __syncthreads();                 // stage t landed, Os staged; stage t-1 done
      issue_w(t + W_SLOTS - 1);
      const bf16* buf = wbuf(t);
      unsigned a[2][4];
#pragma unroll
      for (int rt = 0; rt < 2; ++rt)
        ldsm_x4(a[rt], tile_lane_row(Os + rt * 16 * LDQ + t * WS, LDQ));
#pragma unroll
      for (int j = 0; j < MAX_G; ++j) {
        if (j < ngroups) {
          unsigned b[4];
          ldsm_x4_t(b, tile_lane_row(buf + col0 + j * 16, ldw));
#pragma unroll
          for (int rt = 0; rt < 2; ++rt) {
            mma16816(acc[rt][2 * j], a[rt], b[0], b[1]);
            mma16816(acc[rt][2 * j + 1], a[rt], b[2], b[3]);
          }
        }
      }
    }
    cp_async_wait<0>();                // only empty groups remain
    __syncthreads();                   // Q, O and the region are refilled next group
  }

  // y = x + acc + b_out in fp32, one rounding.
#pragma unroll
  for (int rt = 0; rt < 2; ++rt)
#pragma unroll
    for (int n = 0; n < 2 * MAX_G; ++n) {
      if (n < 2 * ngroups) {
        const int col = col0 + n * 8 + 2 * tq;
        const float b0 = b_out[col], b1 = b_out[col + 1];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = q0 + rt * 16 + g + half * 8;
          if (row < L) {
            const long off = (tok0 + row) * d + col;
            const float2 xv =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + off));
            *reinterpret_cast<__nv_bfloat162*>(y + off) = __floats2bfloat162_rn(
                xv.x + acc[rt][n][2 * half] + b0, xv.y + acc[rt][n][2 * half + 1] + b1);
          }
        }
      }
    }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)optin) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// x, y: (B, L, d) bf16; LayerNorm scale/bias and both biases fp32; w_qkv
// (d, 3d) and w_out (d, d) bf16, (in, out); qkv: bf16 scratch of (B*L, 3d),
// or (B*L, d) for vv. Two launches on `stream`. Returns the first failing
// launch's cudaError_t.
extern "C" int aaclip_ln_attn_residual(const void* x, const void* ln_g, const void* ln_b,
                                       const void* w_qkv, const void* b_qkv,
                                       const void* w_out, const void* b_out, void* qkv, void* y,
                                       int B, int L, int d, int num_heads, int valid_len,
                                       float eps, float scale, int vv, void* stream) {
  if (B <= 0 || L <= 0 || B > 65535 || valid_len <= 0 || d % 128 != 0 || d > 128 * MAX_G ||
      num_heads * HD != d || num_heads % G != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * L;
  const int ncols = vv ? d : 3 * d;
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* qkv_b = static_cast<bf16*>(qkv);

  cudaError_t err = set_smem(ln_qkv_kernel, P_BYTES);
  if (err != cudaSuccess) return err;
  ln_qkv_kernel<<<dim3((M + P_BM - 1) / P_BM, ncols / P_BN), P_THREADS, P_BYTES, s>>>(
      xb, static_cast<const float*>(ln_g), static_cast<const float*>(ln_b),
      static_cast<const bf16*>(w_qkv), static_cast<const float*>(b_qkv), qkv_b, M, d, 3 * d,
      vv ? 2 * d : 0, ncols, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem = attn_smem_bytes(d);
  err = set_smem(attn_out_kernel, smem);
  if (err != cudaSuccess) return err;
  const int n_keys = valid_len < L ? valid_len : L;
  attn_out_kernel<<<dim3((L + A_BQ - 1) / A_BQ, B), A_THREADS, smem, s>>>(
      qkv_b, xb, static_cast<const bf16*>(w_out), static_cast<const float*>(b_out),
      static_cast<bf16*>(y), L, d, num_heads, ncols, 0, vv ? 0 : d, vv ? 0 : 2 * d, n_keys,
      scale);
  return cudaGetLastError();
}

extern "C" const char* aaclip_ln_attn_residual_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
