// The attention forward tile walk shared by the packed-qkv kernel (B1,
// csrc/packed_attention.cu), the unpacked flash kernel (B7,
// csrc/flash_attention.cu) and the attention stage of the fused half-block
// (B8, csrc/ln_attn_residual.cu): the three differ only in where a block's
// q, k, v rows and output rows live, which a Layout of strides says. Each
// source instantiates the kernels with a tag type named after itself, so
// that a profiler tells them apart by the kernel's name; the tag also
// carries the head width, `Tag::hd`: 64 for every tag, and 112 for B1's
// second instance (packed_attention_hd112, EVA02-CLIP-E/14+'s heads), so
// that the 64-wide kernels keep their names.
//
// What it computes, per (batch b = blockIdx.z, head h = blockIdx.y):
//   S = scale * Q K^T in fp32, keys >= n_keys masked to -inf,
//   O = softmax(S) V, with the probabilities rounded to V's dtype before the
//   P.V product and fp32 accumulation, O rounded once; where the caller
//   gives an lse buffer (B, H, L) fp32, also each row's natural-log
//   log-sum-exp m + log(l) of the scaled scores, which the backward (B4/B6)
//   rebuilds P from. B7 and B8 pass null.
//
// What bounds it on the H100: 4 L^2 hd FLOP per (batch, head) against
// 4 L hd elements of traffic, compute-bound at every length on the path
// (at ViT-L/518 batch 8, 6.15e10 FLOP: 62 us at 989 TFLOP/s dense bf16,
// against 27 us of traffic). At hd = 64 the softmax's exponentials are as
// many per tile as the products' multiply-adds are per 64 lanes: a
// 128 x 128 tile's 16,384 exponentials take the SM's 16 MUFU lanes about
// 1,024 cycles, as long as its two products take the tensor cores. So the
// exponentials have to run under the products.
//
// What the design does about it. Two paths:
//   - bf16: one block of three warpgroups owns 128 query rows of one head
//     and walks the keys in 128-key tiles (the TPU online kernel's blk_k,
//     pallas_attention.py:157) with an online softmax. A producer warp
//     loads the block's Q box once and streams K and V boxes through a
//     4-stage mbarrier ring by TMA (3-D tensor maps over (planes, L,
//     columns), 128-byte swizzle, so rows past L read as zero and no caller
//     pads; tiles wholly past n_keys are never loaded). Two consumer
//     warpgroups own 64 query rows each: S = Q K^T is wgmma m64n128k16 with
//     both operands in shared memory (K read K-major), 64 fp32 registers a
//     thread; P is converted in registers into the A fragments of
//     O += P V, wgmma m64n64k16 with V read N-major through the transpose
//     bit, O 32 fp32 registers a thread. Each warpgroup pipelines its own
//     tiles: the scores of tile t are issued together with P(t-1) V(t-1),
//     so tile t's exponentials (ex2.approx of one FMA, scale log2 e folded
//     in) run while the tensor cores do P(t-1) V(t-1); and the two
//     warpgroups take turns to issue their products (ping-pong on two
//     named barriers), so that one's softmax also runs under the other's
//     products. The row max and sum are quad shuffles; only the last key
//     tile is masked (a copy of the step of its own, so that no branch sits
//     between a register-operand wgmma's issue and its wait);
//   - fp32: one 128-thread block per 64-row query tile, 64-key tiles, plain
//     FMAs over shared-memory tiles, so it keeps full fp32 precision.
// Rows past L are never written, nor their log-sum-exp.
//
// Head width 112 (bf16): a head row is 224 bytes, more than the 128 bytes
// of one swizzle row, so Q, K and V are loaded as two 64-column boxes each,
// columns [0, 64) and [64, 128) of the head: the second box's last 16
// columns are the next head's (or, past the section's width, TMA's zeros)
// and are never multiplied. S = Q K^T takes seven k16 steps, four in the
// first box and three in the second (the start advanced 32 bytes a step
// inside the swizzle row, as at 64); O += P V is wgmma m64n112k16, V read
// N-major with the two boxes one LBO apart, so O holds 56 fp32 registers a
// thread. The boxes being twice as large, the K/V ring has three stages
// (Q 32 KB + 3 x 64 KB: 224 KB of the SM's 227 KB) where it has four at
// 64. The extra 16 columns cost 14% more TMA traffic, which the L2 serves
// (every query block of a head reads the same K and V), and no products.
//
// Online softmax differs from the TPU kernels' whole-row softmax only by fp32
// rounding of the running rescale, plus the bf16 rounding of P (taken against
// the running instead of the final row max); over 128-key tiles it is the
// TPU online kernel's own (_flash_kernel, pallas_attention.py:45), block for
// block.
#pragma once

#include <math.h>

#include <type_traits>

#include "common.cuh"
#include "gemm_sm90.cuh"

namespace aaclip {
namespace attn_fwd {
namespace {  // each source that includes this is a library of its own

// Where block (head blockIdx.y, batch blockIdx.z) finds its rows: row r of q
// (k, v alike) at q + z * batch + y * head + r * ld, row r of the output at
// out + z * out_batch + y * out_head + r * out_ld (elements). Heads lie
// side by side in a row (head < ld: B1, B8) or one plane each (B7).
struct Layout {
  long batch, head;
  int ld;
  long out_batch, out_head;
  int out_ld;
};

__device__ __forceinline__ long in_offset(const Layout& lay) {
  return blockIdx.z * lay.batch + blockIdx.y * lay.head;
}
__device__ __forceinline__ long out_offset(const Layout& lay) {
  return blockIdx.z * lay.out_batch + blockIdx.y * lay.out_head;
}

// ---------------------------------------------------------------------------
// bf16 path: wgmma fed by TMA, warp-specialised.
// ---------------------------------------------------------------------------

constexpr int TQ = 128;                // query rows per block: two warpgroups of 64
constexpr int TK = 128;                // keys per tile
constexpr int WG_THREADS = 384;        // consumer warpgroups 0 and 1, producer 2
constexpr int STAGES = 4;
constexpr int BOX = TQ * 64 * 2;       // bytes of one 128-row x 64-column box

// The bf16 walk's shared memory at head width HD: the Q boxes, then the
// ring's K and V boxes per stage (BOXES 64-column boxes each), then the
// barriers.
template <int HD_>
struct Smem {
  static_assert(HD_ == 64 || HD_ == 112, "head width 64 or 112");
  static constexpr int BOXES = (HD_ + 63) / 64;
  static constexpr int STAGES_ = HD_ == 64 ? STAGES : 3;
  static constexpr int PANEL = BOXES * BOX;      // one operand's boxes of a tile
  static constexpr int RING = PANEL;             // the ring follows the Q boxes
  static constexpr int BARS = RING + STAGES_ * 2 * PANEL;
  static constexpr int SIZE = BARS + (2 * STAGES_ + 1) * 8 + 1024;   // + 1 KB to align
};
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.69314718055994531f;

// The tensor maps of q, k and v, each over (planes, L, columns) in 128 x 64
// boxes, and where block (h, b)'s boxes are: columns from h * col_step,
// plane b * zstep + h * ystep.
struct Maps {
  CUtensorMap q, k, v;
  int col_step, ystep, zstep;
};

// 2^x in one MUFU instruction (ex2.approx, relative error about 2^-22,
// subnormal results flushed to zero): P is rounded to bf16 before it is
// used, and keeps it by far.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// O += P V for one k16 step of keys: wgmma m64nHDk16 with P (A) from
// registers and V (B) N-major behind its descriptor.
template <int HD_>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD_ / 2], const unsigned (&a)[4],
                                         uint64_t desc_v);

template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32], const unsigned (&a)[4],
                                             uint64_t desc_v) {
  gemm90::wgmma_bf16_rs<1>(o, a, desc_v);
}

template <>
__device__ __forceinline__ void wgmma_pv<112>(float (&d)[56], const unsigned (&a)[4],
                                              uint64_t desc_v) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_v), "r"(1));
}

template <class Tag>
__global__ void __launch_bounds__(WG_THREADS, 1)
attention_wgmma_kernel(const __grid_constant__ Maps maps, bf16* __restrict__ out,
                       float* __restrict__ lse, Layout lay, int L, int n_keys, float scale) {
  constexpr int HD = Tag::hd;
  using S = Smem<HD>;
  constexpr int STAGES = S::STAGES_;
  extern __shared__ unsigned char smem_raw[];
  // The boxes start on 1024-byte swizzle atoms (TMA writes, wgmma reads).
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  auto kbox = [&](int s) { return smem + S::RING + s * 2 * S::PANEL; };
  auto vbox = [&](int s) { return smem + S::RING + s * 2 * S::PANEL + S::PANEL; };
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* empty = full + STAGES;
  uint64_t* q_full = empty + STAGES;
  const int q0 = blockIdx.x * TQ;
  const int wg = threadIdx.x / 128;
  const int ntiles = (n_keys + TK - 1) / TK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      gemm90::mbar_init(&full[s], 1);
      gemm90::mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    gemm90::mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // Producer: the Q box, then tile t's K and V boxes into stage t % STAGES
    // once the consumers have released its use t - STAGES.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      const int col = blockIdx.y * maps.col_step;
      const int plane = blockIdx.z * maps.zstep + blockIdx.y * maps.ystep;
      gemm90::mbar_expect_tx(q_full, S::PANEL);
#pragma unroll
      for (int j = 0; j < S::BOXES; ++j)
        gemm90::tma_load_3d(smem + j * BOX, maps.q, q_full, col + 64 * j, q0, plane);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES;
        gemm90::mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
        gemm90::mbar_expect_tx(&full[s], 2 * S::PANEL);
#pragma unroll
        for (int j = 0; j < S::BOXES; ++j) {
          gemm90::tma_load_3d(kbox(s) + j * BOX, maps.k, &full[s], col + 64 * j, t * TK, plane);
          gemm90::tma_load_3d(vbox(s) + j * BOX, maps.v, &full[s], col + 64 * j, t * TK, plane);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int lane = threadIdx.x % 32, tq = lane % 4;
  // This thread's rows: row0 (h = 0) and row0 + 8 (h = 1). Accumulator
  // register 4i + 2h + e holds column 8i + 2 tq + e of row row0 + 8h.
  const int row0 = q0 + wg * 64 + (threadIdx.x % 128 / 32) * 16 + lane / 4;
  const float scale2 = scale * LOG2E;
  const unsigned char* qa = smem + wg * 64 * 128;   // this warpgroup's Q rows
  float o[HD / 2], sc[64];
  unsigned pa[8][4];                   // P of the previous tile, as A fragments
  // Running max of S scale log2 e and this lane's part of the running sum.
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  gemm90::fence_regs(o);

  auto fence_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) gemm90::fence_regs(pa[kk]);
  };
  // S = Q K^T of the tile in stage s, issued as one commit group: k-step
  // kk reads 32 bytes into box kk / 4.
  auto issue_scores = [&](int s) {
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = 0.f;
    gemm90::fence_regs(sc);
    gemm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int at = kk / 4 * BOX + kk % 4 * 32;
      gemm90::wgmma_bf16<128, 0>(sc, gemm90::smem_desc(qa + at, 16, 1024),
                                 gemm90::smem_desc(kbox(s) + at, 16, 1024));
    }
    gemm90::wgmma_commit();
  };
  // O += P V of the tile in stage s, issued as one commit group; pa is read
  // until the group has been waited for.
  auto issue_pv = [&](int s) {
    gemm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
      wgmma_pv<HD>(o, pa[kk], gemm90::smem_desc(vbox(s) + kk * 16 * 128, BOX, 1024));
    fence_p();
    gemm90::wgmma_commit();
  };
  // The online softmax of the scores in sc (keys from k0): the new running
  // max m of S scale log2 e, alpha = 2^(m_old - m_new) per row, the sum
  // rescaled and P = 2^(S scale log2 e - m_new) (one FMA and one ex2) in
  // place of the scores. MASKED: the last tile, where keys >= n_keys (past
  // L: zero-filled rows) are masked.
  auto softmax = [&](int k0, float (&alpha)[2], auto masked) {
    if constexpr (decltype(masked)::value) {
#pragma unroll
      for (int i = 0; i < 64; ++i)
        if (k0 + 8 * (i / 4) + 2 * tq + (i & 1) >= n_keys) sc[i] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 64; ++i) mx[(i / 2) & 1] = fmaxf(mx[(i / 2) & 1], sc[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // k0 < n_keys, so key k0 is real and the row max is finite.
      const float m_new = fmaxf(m_run[r], mx[r] * scale2);
      alpha[r] = fast_exp2(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      sc[i] = fast_exp2(fmaf(sc[i], scale2, -m_run[(i / 2) & 1]));
      l_run[(i / 2) & 1] += sc[i];
    }
  };
  // P rounded to bf16 as the A fragments of the k-steps over the tile's
  // keys: k-step kk takes column groups 2kk and 2kk + 1.
  auto to_fragments = [&]() {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) pa[kk][j] = pack_bf16x2(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
  };
  // Every row, moved or not (alpha = 1 exactly where the max stayed put):
  // a warp that skipped the rescale where no row's max moved measured
  // slower.
  auto rescale = [&](const float (&alpha)[2]) {
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i / 2) & 1];
  };
  // Ping-pong: the two consumer warpgroups take turns to issue their
  // products (named barrier 1 + wg: this warpgroup's 128 threads wait and
  // the other's 128 arrive), so that one warpgroup's softmax runs while the
  // other's products do. Warpgroup 0 takes the first turn.
  auto my_turn = [&]() { asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg)); };
  auto your_turn = [&]() { asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg)); };
  auto release = [&](int s) {
    if (threadIdx.x % 128 == 0) gemm90::mbar_arrive(&empty[s]);
  };
  // Step t >= 1: S(t) and P(t-1) V(t-1) issued together; tile t's softmax
  // while P(t-1) V(t-1) runs; then O rescaled to tile t's max and P(t) made
  // the next step's operand.
  auto step = [&](int t, auto masked) {
    const int s = t % STAGES, prev = (t - 1) % STAGES;
    gemm90::mbar_wait(&full[s], (t / STAGES) & 1);
    my_turn();
    issue_scores(s);
    issue_pv(prev);
    your_turn();
    gemm90::wgmma_wait<1>();
    gemm90::fence_regs(sc);
    float alpha[2];
    softmax(t * TK, alpha, masked);
    gemm90::wgmma_wait<0>();
    gemm90::fence_regs(o);
    fence_p();
    release(prev);
    rescale(alpha);
    to_fragments();
  };

  using Plain = std::integral_constant<bool, false>;
  using Masked = std::integral_constant<bool, true>;
  gemm90::mbar_wait(q_full, 0);
  if (wg == 1) your_turn();
  {
    gemm90::mbar_wait(&full[0], 0);
    my_turn();
    issue_scores(0);
    your_turn();
    gemm90::wgmma_wait<0>();
    gemm90::fence_regs(sc);
    float alpha[2];                    // O is zero: nothing to rescale
    if (ntiles == 1)
      softmax(0, alpha, Masked{});
    else
      softmax(0, alpha, Plain{});
    to_fragments();
  }
  for (int t = 1; t < ntiles - 1; ++t) step(t, Plain{});
  if (ntiles > 1) step(ntiles - 1, Masked{});
  my_turn();
  issue_pv((ntiles - 1) % STAGES);
  your_turn();
  gemm90::wgmma_wait<0>();
  gemm90::fence_regs(o);
  fence_p();
  release((ntiles - 1) % STAGES);

  // Normalise and write rows row0 and row0 + 8 straight from registers.
  bf16* dst_base = out + out_offset(lay);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    const int row = row0 + 8 * r;
    if (row >= L) continue;
    if (lse != nullptr && tq == 0)
      lse[((long)blockIdx.z * gridDim.y + blockIdx.y) * L + row] = m_run[r] * LN2 + logf(l_run[r]);
    const float inv = 1.f / l_run[r];
    bf16* dst = dst_base + (long)row * lay.out_ld + 2 * tq;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(dst + i * 8) =
          __floats2bfloat162_rn(o[4 * i + 2 * r] * inv, o[4 * i + 2 * r + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// fp32 path: shared-memory tiles and plain FMAs.
// ---------------------------------------------------------------------------

constexpr int BQ = 64;                 // query rows per block
constexpr int BK = 64;                 // keys per tile
constexpr int NWARPS = 4;              // each warp owns 16 query rows
constexpr int NTHREADS = NWARPS * 32;
constexpr int ROWS_PER_WARP = BQ / NWARPS;

constexpr int LDS = BK + 4;            // score / probability row stride

// The fp32 path's shared memory at head width HD: q/k/v tiles and the
// accumulator with row stride LDT, the scores with LDS.
template <int HD_>
struct F32Smem {
  static constexpr int LDT = HD_ + 4;
  static constexpr size_t F_Q = 0;
  static constexpr size_t F_K = F_Q + round_up(sizeof(float) * BQ * LDT, 128);
  static constexpr size_t F_V = F_K + round_up(sizeof(float) * BK * LDT, 128);
  static constexpr size_t F_S = F_V + round_up(sizeof(float) * BK * LDT, 128);
  static constexpr size_t F_O = F_S + round_up(sizeof(float) * BQ * LDS, 128);
  static constexpr size_t SIZE = F_O + round_up(sizeof(float) * BQ * LDT, 128);
};

// Copy rows [r0, r0 + ROWS) of one head's (L, HD) panel into shared memory,
// 16 bytes per thread per step; rows at or past L are zero-filled.
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, int row_stride,
                                              int r0, int L) {
  constexpr int VPR = HD / 4, LDT = F32Smem<HD>::LDT;
  for (int i = threadIdx.x; i < ROWS * VPR; i += NTHREADS) {
    const int r = i / VPR, c = (i % VPR) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < L)
      val = *reinterpret_cast<const float4*>(src + (long)(r0 + r) * row_stride + c);
    *reinterpret_cast<float4*>(dst + r * LDT + c) = val;
  }
}

template <class Tag>
__global__ void __launch_bounds__(NTHREADS)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, Layout lay, int L, int n_keys, float scale) {
  constexpr int HD = Tag::hd;
  using F = F32Smem<HD>;
  constexpr int LDT = F::LDT;
  constexpr size_t F_Q = F::F_Q, F_K = F::F_K, F_V = F::F_V, F_S = F::F_S, F_O = F::F_O;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + F_Q);
  float* Ks = reinterpret_cast<float*>(smem + F_K);
  float* Vs = reinterpret_cast<float*>(smem + F_V);
  float* Ss = reinterpret_cast<float*>(smem + F_S);   // scores, then P
  float* Os = reinterpret_cast<float*>(smem + F_O);

  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wr0 = warp * ROWS_PER_WARP;
  const long in_off = in_offset(lay);

  load_tile_f32<HD, BQ>(Qs, q + in_off, lay.ld, q0, L);
  for (int i = threadIdx.x; i < BQ * LDT; i += NTHREADS) Os[i] = 0.f;
  // Lanes 2i and 2i+1 own row wr0 + i of the online softmax (each takes
  // every other column) and both keep its running max and sum.
  static_assert(ROWS_PER_WARP * 2 == 32, "two lanes per softmax row");
  const int my_row = wr0 + lane / 2, half = lane % 2;
  float m_row = -INFINITY, l_row = 0.f;
  __syncthreads();

  for (int k0 = 0; k0 < n_keys; k0 += BK) {
    load_tile_f32<HD, BK>(Ks, k + in_off, lay.ld, k0, L);
    load_tile_f32<HD, BK>(Vs, v + in_off, lay.ld, k0, L);
    __syncthreads();

    for (int i = lane; i < ROWS_PER_WARP * BK; i += 32) {
      const int r = wr0 + i / BK, c = i % BK;
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) acc = fmaf(Qs[r * LDT + d], Ks[c * LDT + d], acc);
      Ss[r * LDS + c] = acc;
    }
    __syncwarp();

    float sv[BK / 2];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int c = 2 * j + half;
      sv[j] = (k0 + c < n_keys) ? Ss[my_row * LDS + c] * scale : -INFINITY;
      mx = fmaxf(mx, sv[j]);
    }
    // k0 < n_keys, so key k0 is real and the pair's max is finite.
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_row, mx);
    const float alpha = expf(m_row - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const float p = expf(sv[j] - m_new);
      sum += p;
      Ss[my_row * LDS + 2 * j + half] = p;   // each lane overwrites what it read
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    m_row = m_new;
    l_row = l_row * alpha + sum;
    for (int c = half; c < HD; c += 2) Os[my_row * LDT + c] *= alpha;
    __syncwarp();

    for (int i = lane; i < ROWS_PER_WARP * HD; i += 32) {
      const int r = wr0 + i / HD, c = i % HD;
      float acc = Os[r * LDT + c];
#pragma unroll 8
      for (int key = 0; key < BK; ++key) acc = fmaf(Ss[r * LDS + key], Vs[key * LDT + c], acc);
      Os[r * LDT + c] = acc;
    }
    __syncthreads();  // K/V tiles are overwritten by the next iteration
  }

  float* dst_base = out + out_offset(lay);
  if (lse != nullptr && half == 0 && q0 + my_row < L)
    lse[((long)blockIdx.z * gridDim.y + blockIdx.y) * L + q0 + my_row] = m_row + logf(l_row);
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const float inv = 1.f / __shfl_sync(0xffffffffu, l_row, 2 * i);
    const int row = q0 + wr0 + i;
    if (row >= L) break;
    float* dst = dst_base + (long)row * lay.out_ld;
    for (int c = lane; c < HD; c += 32) dst[c] = Os[(wr0 + i) * LDT + c] * inv;
  }
}

// The three tensor maps of a bf16 call, each over (planes, L, columns):
// with heads side by side in a row (lay.head < lay.ld) a plane is a batch item
// and block (h, b) reads columns from h * HD of plane b; with one plane per
// head (B7: batch 1, or planes heads apart) it reads plane b * heads + h.
// Row strides and pointers must suit TMA: 16-byte multiples.
template <int HD>
inline cudaError_t make_maps(Maps* maps, const bf16* q, const bf16* k, const bf16* v,
                             const Layout& lay, int L, int heads, int batch) {
  const bool cols = lay.head < lay.ld;
  if (lay.ld % 8 || (!cols && batch > 1 && lay.batch != heads * lay.head) ||
      gemm90::misaligned(q) || gemm90::misaligned(k) || gemm90::misaligned(v))
    return cudaErrorInvalidValue;
  const int dim0 = cols ? heads * HD : HD, planes = cols ? batch : heads * batch;
  const long ld2 = cols ? lay.batch : lay.head;
  cudaError_t err = gemm90::tensor_map_3d(&maps->q, q, dim0, L, planes, lay.ld, ld2, TQ);
  if (err == cudaSuccess) err = gemm90::tensor_map_3d(&maps->k, k, dim0, L, planes, lay.ld, ld2, TK);
  if (err == cudaSuccess) err = gemm90::tensor_map_3d(&maps->v, v, dim0, L, planes, lay.ld, ld2, TK);
  maps->col_step = cols ? HD : 0;
  maps->ystep = cols ? 0 : 1;
  maps->zstep = cols ? 1 : heads;
  return err;
}

// Launch the kernel for `dtype` (0 = float32, 1 = bfloat16) over a grid of
// query tiles (128 rows for bf16, 64 for fp32) x heads x batch items; lse
// (batch, heads, L) fp32 or null. Returns the launch's error.
template <class Tag>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, void* out,
                   float* lse, const Layout& lay, int L, int heads, int batch, int n_keys,
                   float scale, cudaStream_t stream) {
  cudaError_t err;
  if (dtype == 1) {
    Maps maps;
    err = make_maps<Tag::hd>(&maps, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                             static_cast<const bf16*>(v), lay, L, heads, batch);
    constexpr int smem = Smem<Tag::hd>::SIZE;
    if (err == cudaSuccess) err = gemm90::set_smem(attention_wgmma_kernel<Tag>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((L + TQ - 1) / TQ, heads, batch);
    attention_wgmma_kernel<Tag><<<grid, WG_THREADS, smem, stream>>>(
        maps, static_cast<bf16*>(out), lse, lay, L, n_keys, scale);
    return cudaGetLastError();
  }
  if (dtype == 0) {
    constexpr size_t smem = F32Smem<Tag::hd>::SIZE;
    err = cudaFuncSetAttribute(attention_f32_kernel<Tag>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((L + BQ - 1) / BQ, heads, batch);
    attention_f32_kernel<Tag><<<grid, NTHREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), lse, lay, L, n_keys, scale);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace attn_fwd
}  // namespace aaclip
