// Flash attention's backward for Hopper (sm_90a): dq, dk and dv of GQA
// attention under the causal / sliding window / q_offset masks, from q, k,
// v, the forward's output and its log-sum-exp (flash_attention_sm90.cu and
// flash_attention.cu write it), and the output's cotangent dO.
//
// Replaces: no TPU kernel.  The Pallas kernel
// src/repro/kernels/attention/flash_attention.py::flash_attention has no
// custom_vjp: jax.grad differentiates the plain route (ref.mha, or
// ref.mha_banded where the dispatch picks it), which builds the float32
// (B, KV, G, S_q, S_kv) logits.  This kernel computes the same gradient
// tile by tile and never holds an S_q x S_kv tensor.
//
// What bounds it on an H100: operations.  The least work is twice the
// forward's products, 8·B·H·D per visible (query, key) pair, over the 989
// TFLOP/s bf16 tensor-core peak (67 TFLOP/s float32 on FMA); its bytes are
// q, k, v, o, dO and lse read and dq, dk, dv written once.  Only `wgmma`
// reaches the tensor cores' rate, with its operands in shared memory in the
// swizzled layouts that TMA writes; and the card has 132 SMs to fill.
//
// What the design does about it (FlashAttention-2's two passes, on
// FlashAttention-3's shape of two consumer warpgroups of 64 rows, without
// atomics, so that two calls give the same bits):
//   * Δ = rowsum(dO ∘ O) in float32, one warp per (batch, head, row)
//     (delta_kernel), into a (B, H, S_q) scratch the wrapper allocates.
//   * dK and dV (dkdv_sm90_kernel): one block per (128 keys, query head,
//     batch row), not per kv head, so that GQA's G heads do not run one
//     after another inside a block: B·H·S_kv/128 blocks (768 at
//     qwen2-vl-2b's 2 x 4096, 12 heads on 2, where one block per kv head
//     and 64 keys gave 256).  Each block loops over the query tiles of its
//     head that see its keys (the causal and window bands bound the loop).
//     Where G > 1 each block writes its head's dK and dV in float32 to a
//     (2, B, S_kv, H, D) scratch and dkdv_sum_kernel sums each group's G
//     heads in head order, so the sum's order is fixed whatever the
//     scheduling; at G = 1 the block writes dk and dv itself.  The blocks
//     with the most query tiles go first (under the causal mask, the first
//     key tiles).
//   * dQ (dq_sm90_kernel): one block per (128 query rows, head, batch row),
//     over the key tiles its rows see, the last query rows first under the
//     causal mask.  It recomputes S and dP, so that dQ needs no atomics
//     across the dK/dV pass's blocks.
//   * A block is two consumer warpgroups of 64 rows each (at D = 256 one
//     64-row group, each warpgroup owning 128 of the columns: 128
//     accumulator floats a thread for each of dK and dV would not fit; both
//     compute the tile's S and dP).  The streamed 64-row tiles (Q and dO;
//     K and V) are shared by both.  Warp 0 keeps the copies in flight: TMA
//     loads (`cp.async.bulk.tensor`, 128-byte swizzle; 64-byte at D = 32)
//     of the block's own tiles once, and of the streamed tiles STAGES - 1
//     ahead into a ring (3 stages, 2 at D = 256) with full and empty
//     `mbarrier`s, and with each query tile its rows' lse and Δ by
//     `cp.async` whose completion the full barrier counts.  The tensor maps
//     cover the caller's (B, S, heads, D) views through their strides; rows
//     past S are zero-filled.  No producer warpgroup and no `setmaxnreg`:
//     with a producer warpgroup handing its registers to the consumers
//     (setmaxnreg 24/232, two blocks an SM), ptxas (CUDA 12.9) spilled in
//     dK/dV's loop at D = 128 and serialised its wgmma, and the backward
//     ran 1.6x slower than with the registers given at launch (PERF.md §6,
//     tools/flash_bwd_variants.py); a lone producer warp caps a 288-thread
//     block at 168 registers a thread.  256 threads at up to 255 registers:
//     one block an SM.
//   * Per pair of tiles, on each consumer warpgroup: Sᵀ = K·Qᵀ and dPᵀ =
//     V·dOᵀ (S = Q·Kᵀ and dP = dO·Vᵀ in the dQ pass) are `wgmma` m64n64k16
//     with both operands in shared memory, issued together; P =
//     exp2(S·scale·log2e − lse·log2e) on the accumulator fragment while dP
//     runs, rounded to bf16 (where the forward rounds P) into register A
//     fragments; dS = P ∘ (dP − Δ), rounded the same; then dV += Pᵀ·dO and
//     dK += dSᵀ·Q (dQ += dS·K) as `wgmma` m64nDk16 with dO and Q (K) read
//     MN-major from shared memory.  A warpgroup skips a tile pair with no
//     visible pair.
//   * A key past S_kv is zero-filled and scores 0, not -inf: it is masked
//     to P = 0 as are keys outside the band and query rows past S_q; a row
//     that sees no key (lse = -inf) gets P = 0.
//   * float32 runs on the FMA pipes (a TF32 product would miss float32's
//     tolerance): 32 x 32 tiles in shared memory padded by one float, 128
//     threads as 16 x 8, each owning 2 x 4 scores and 2 rows x D/8 columns
//     of the accumulators; its dK/dV block loops over the G heads of its kv
//     head.
#include <math.h>

#include "common.cuh"

namespace repro {
namespace {

constexpr float kLog2e = 1.4426950408889634f;

struct BwdArgs {
  const void *q, *k, *v, *o, *dout;
  const float* lse;  // (B, H, S_q), natural log
  float* delta;      // (B, H, S_q) scratch
  float* acc;        // bf16 at G > 1: per-head dK, dV, (2, B, S_kv, H, D) float32 scratch
  void *dq, *dk, *dv;
  int B, S_q, S_kv, H, KV, G;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh, do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh;
  int causal, window, q_offset;
  float scale;
};

__device__ __forceinline__ bool visible(const BwdArgs& a, int qi, int kp) {
  const int qp = qi + a.q_offset;
  return qi < a.S_q && kp < a.S_kv && (!a.causal || kp <= qp) &&
         (a.window <= 0 || kp > qp - a.window);
}

struct Span {
  int begin, end;
};

// Keys that some of the rows q0 .. q0 + rows - 1 can see.
__device__ __forceinline__ Span keys_seen(const BwdArgs& a, int q0, int rows) {
  const int q_first = q0 + a.q_offset;
  const int q_last = min(q0 + rows, a.S_q) - 1 + a.q_offset;
  int end = a.S_kv;
  if (a.causal) end = min(end, q_last + 1);
  const int begin = a.window > 0 ? max(0, q_first - a.window + 1) : 0;
  return {begin, end};
}

// Query rows that see some of the keys k0 .. k0 + keys - 1.
__device__ __forceinline__ Span queries_seeing(const BwdArgs& a, int k0, int keys) {
  const int k_last = min(k0 + keys, a.S_kv) - 1;
  const int begin = a.causal ? max(0, k0 - a.q_offset) : 0;
  int end = a.S_q;
  if (a.window > 0) end = min(end, max(0, k_last + a.window - a.q_offset));
  return {begin, end};
}

// Whether some pair of the tile (rows q0.., keys k0..) is masked.
__device__ __forceinline__ bool edge_tile(const BwdArgs& a, int q0, int rows, int k0, int keys) {
  return k0 + keys > a.S_kv || q0 + rows > a.S_q ||
         (a.causal && k0 + keys - 1 > q0 + a.q_offset) ||
         (a.window > 0 && k0 <= q0 + rows - 1 + a.q_offset - a.window);
}

// ---------------------------------------------------------------------------
// Δ = rowsum(dO ∘ O)
// ---------------------------------------------------------------------------

constexpr int kDeltaWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kDeltaWarps * 32) delta_kernel(BwdArgs a, int D) {
  const long long row = static_cast<long long>(blockIdx.x) * kDeltaWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<long long>(a.B) * a.H * a.S_q) return;
  const int i = static_cast<int>(row % a.S_q);
  const int h = static_cast<int>((row / a.S_q) % a.H);
  const int b = static_cast<int>(row / (static_cast<long long>(a.S_q) * a.H));
  const T* o = static_cast<const T*>(a.o) + b * a.o_sb + i * a.o_ss + h * a.o_sh;
  const T* d = static_cast<const T*>(a.dout) + b * a.do_sb + i * a.do_ss + h * a.do_sh;
  float s = 0.f;
  for (int c = lane; c < D; c += 32) s += to_float(o[c]) * to_float(d[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) a.delta[row] = s;
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma fed by TMA
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;  // rows of a tile (keys or query rows): one wgmma M

// A pass's block: two consumer warpgroups, 256 threads, one block per SM.
// Below D = 256 each warpgroup owns 64 of the block's 128 rows (keys of
// dK/dV, query rows of dQ) and every column; at D = 256 both own the
// block's 64 rows and each half of the columns (both compute S and dP).
template <int D>
struct Sm90 {
  static constexpr int BOXC = D < 64 ? D : 64;            // columns per TMA box
  static constexpr int SWZ = BOXC * 2;                     // bytes per swizzled row: 128 or 64
  static constexpr uint32_t LAYOUT = SWZ == 128 ? 1 : 2;   // descriptor swizzle mode
  static constexpr int NCH = D / BOXC;                     // column boxes per row
  static constexpr int TILE = kTile * D * 2;               // bytes of one 64-row tile
  static constexpr int CW = D == 256 ? 2 : 1;              // warpgroups per 64 rows
  static constexpr int RW = 2 / CW;                        // 64-row groups per block
  static constexpr int ROWS = kTile * RW;                  // the block's own rows
  static constexpr int DC = D / CW;                        // accumulator columns a warpgroup
  static constexpr int THREADS = 256;
  static constexpr int STAGES = D == 256 ? 2 : 3;          // depth of the streamed ring
  // The two operands' own tiles, STAGES pairs of streamed tiles, the rows'
  // statistics (STAGES x 2 x 64 streamed, 2 x ROWS own), the barriers, and
  // 1024 bytes to align the tiles.
  static constexpr int SMEM = 1024 + (2 * RW + 2 * STAGES) * TILE +
                              (STAGES * 2 * kTile + 2 * ROWS) * 4 + (1 + 2 * STAGES) * 8;
};

// The two tiles a pass keeps (K, V; Q, dO) and the two it streams (Q, dO;
// K, V): the positions (1..3) of the head, sequence and batch coordinates
// in each tensor map's dimension order.
struct MapDims {
  int r0[3], r1[3], t0[3], t1[3];
};

// D (64 x DC, f32) += A (64 x 16, registers) · B (16 x DC, shared, MN-major).
template <int DC>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a, uint64_t db) {
  wgmma_rs_n32(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a, uint64_t db) {
  wgmma_rs_n64(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a, uint64_t db) {
  wgmma_rs_n128(d, a, db);
}

// Keeps a register A fragment alive until the wgmma that reads it is done.
__device__ __forceinline__ void keep(const uint32_t (&f)[4][4]) {
#pragma unroll
  for (int t = 0; t < 4; ++t)
    asm volatile("" ::"r"(f[t][0]), "r"(f[t][1]), "r"(f[t][2]), "r"(f[t][3]));
}

// A 64 x 64 f32 accumulator fragment in bf16, as the four A fragments of a
// product over its 64 columns: columns 16t..16t+15 are registers 8t..8t+7.
__device__ __forceinline__ void to_a(uint32_t (&f)[4][4], const float* s) {
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int x = 0; x < 4; ++x) f[t][x] = pack_bf16(s[8 * t + 2 * x], s[8 * t + 2 * x + 1]);
}

// cp.async of one float, zero-filled when !valid; and an arrival on `bar`
// once this thread's earlier cp.async copies have landed (counted in the
// barrier's arrivals: .noinc).
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Rows row0 .. row0 + rows - 1 of head h: the lse (natural log) at
// dst[0..rows) and Δ at dst[rows..2·rows), copied by the 32 lanes of a warp;
// rows past S_q read 0 (their Q and dO rows are zero, so P·dO and dS·Q add
// nothing).
__device__ __forceinline__ void load_stats(const BwdArgs& a, float* dst, int b, int h, int row0,
                                           int rows, int lane) {
  for (int r = lane; r < rows; r += 32) {
    const bool ok = row0 + r < a.S_q;
    const long long idx = ok ? (static_cast<long long>(b) * a.H + h) * a.S_q + row0 + r : 0;
    cp_async_f32(dst + r, a.lse + idx, ok);
    cp_async_f32(dst + rows + r, a.delta + idx, ok);
  }
}

// The lse in log2 units for P = exp2(s·scale·log2e − lse2); +inf (P = 0)
// for a row that sees no key.
__device__ __forceinline__ float lse2_from(float lse) {
  return lse == -INFINITY ? INFINITY : lse * kLog2e;
}

// Whether some pair of a 64-row tile of queries q0.. and one of keys k0..
// is visible.
__device__ __forceinline__ bool any_visible(const BwdArgs& a, int q0, int k0) {
  if (q0 >= a.S_q || k0 >= a.S_kv) return false;
  const int q_first = q0 + a.q_offset;
  const int q_last = min(q0 + kTile, a.S_q) - 1 + a.q_offset;
  if (a.causal && k0 > q_last) return false;
  return a.window <= 0 || min(k0 + kTile, a.S_kv) - 1 > q_first - a.window;
}

// One block of a bf16 pass.  dK/dV (kDQ false): the block's own tiles are
// ROWS keys of K and V, the streamed ones 64-row query tiles of Q and dO
// with their rows' lse and Δ, the accumulators dK (acc0) and dV (acc1).
// dQ: the own tiles are ROWS rows of Q and dO (and their lse and Δ), the
// streamed ones key tiles of K and V, the accumulator dQ.  Warp 0 issues
// the copies (lane 0 the TMA loads, every lane the statistics' cp.async):
// the own tiles and the first STAGES - 1 streamed tiles at the start, then
// at each step the tile STAGES - 1 ahead, into the stage both warpgroups
// released a step before.  Accumulator fragment of a 64 x N wgmma:
// register j of thread (warp w, lane l) of a warpgroup holds row 16w + l/4
// + 8·((j/2) % 2) and column 8·(j/4) + 2·(l % 4) + j % 2.
template <int D, bool kDQ>
__device__ __forceinline__ void bwd_pass(const CUtensorMap* r0, const CUtensorMap* r1,
                                         const CUtensorMap* t0, const CUtensorMap* t1,
                                         const BwdArgs& a, const MapDims& md) {
  using T = Sm90<D>;
  constexpr int S = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sR = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                           ~static_cast<uintptr_t>(1023));
  uint8_t* sT = sR + 2 * T::RW * T::TILE;  // [S][2] streamed tiles
  float* sStatT = reinterpret_cast<float*>(sT + S * 2 * T::TILE);  // [S][2][64]
  float* sStatR = sStatT + S * 2 * kTile;                          // [2][ROWS]
  uint64_t* bar_res = reinterpret_cast<uint64_t*>(sStatR + 2 * T::ROWS);
  uint64_t* bar_full = bar_res + 1;    // a stage's tiles (and statistics) landed
  uint64_t* bar_empty = bar_full + S;  // both warpgroups are done with a stage

  // Block -> (own tile, head, batch): tile-major, heads fastest (a group's
  // heads read the same K and V tiles at about the same time).  The tiles
  // with the most work go first: under the causal mask the first key tiles
  // (dK/dV) and the last query tiles (dQ); without it the band, if any,
  // gives the other end the most.
  const int per = a.B * a.H;
  const int n_own = ((kDQ ? a.S_q : a.S_kv) + T::ROWS - 1) / T::ROWS;
  const int ord = blockIdx.x / per;
  const int b = (blockIdx.x % per) / a.H;
  const int h = blockIdx.x % a.H;
  const int own = ((a.causal != 0) != kDQ) ? ord : n_own - 1 - ord;
  const int p0 = own * T::ROWS;  // first key (dK/dV) or query row (dQ) of the block
  const int kvh = h / a.G;
  const Span span = kDQ ? keys_seen(a, p0, T::ROWS) : queries_seeing(a, p0, T::ROWS);
  const int t_begin = span.begin / kTile;
  const int n = span.end > span.begin ? (span.end + kTile - 1) / kTile - t_begin : 0;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(bar_res, kDQ ? 33 : 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&bar_full[s], kDQ ? 1 : 33);
      mbar_init(&bar_empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int r_head = kDQ ? h : kvh;
  const int t_head = kDQ ? kvh : h;
  // Streamed tile j into its stage, with (dK/dV) its rows' statistics.
  auto issue = [&](int j) {
    const int st = j % S;
    const int p = (t_begin + j) * kTile;
    if (!kDQ) {
      load_stats(a, sStatT + st * 2 * kTile, b, h, p, kTile, lane);
      cp_async_arrive(&bar_full[st]);
    }
    if (lane == 0) {
      uint8_t* dst = sT + st * 2 * T::TILE;
      mbar_expect_tx(&bar_full[st], 2 * T::TILE);
      for (int ch = 0; ch < T::NCH; ++ch) {
        tma_load(dst + ch * kTile * T::SWZ, t0, md.t0, &bar_full[st], ch * T::BOXC, t_head, p, b);
        tma_load(dst + T::TILE + ch * kTile * T::SWZ, t1, md.t1, &bar_full[st], ch * T::BOXC,
                 t_head, p, b);
      }
    }
  };
  if (warp == 0) {
    if (kDQ) {
      load_stats(a, sStatR, b, h, p0, T::ROWS, lane);
      cp_async_arrive(bar_res);
    }
    if (lane == 0) {
      mbar_expect_tx(bar_res, 2 * T::RW * T::TILE);
      for (int rg = 0; rg < T::RW; ++rg)
        for (int ch = 0; ch < T::NCH; ++ch) {
          const int off = rg * T::TILE + ch * kTile * T::SWZ;
          tma_load(sR + off, r0, md.r0, bar_res, ch * T::BOXC, r_head, p0 + rg * kTile, b);
          tma_load(sR + T::RW * T::TILE + off, r1, md.r1, bar_res, ch * T::BOXC, r_head,
                   p0 + rg * kTile, b);
        }
    }
    for (int j = 0; j < min(S - 1, n); ++j) issue(j);
  }

  // Consumer warpgroup wg: rows p0 + rg·64 .. of the block, accumulator
  // columns cg·DC ...
  constexpr int NA = T::DC / 2;  // accumulator registers a thread, per product
  const int wg = warp / 4;
  const int rg = wg / T::CW;
  const int cg = wg % T::CW;
  const int w = warp % 4;
  const int r_lo = 16 * w + lane / 4;  // this thread's fragment rows: r_lo, r_lo + 8
  const int c_lane = 2 * (lane % 4);
  const int row0 = p0 + rg * kTile;     // this warpgroup's first own row
  const float sl2 = a.scale * kLog2e;
  // This warpgroup's columns of an MN-major streamed tile: DC / BOXC boxes in.
  const uint32_t col_off = (cg * T::DC / T::BOXC) * kTile * T::SWZ;

  float acc0[NA], acc1[kDQ ? 1 : NA];  // dK and dV, or dQ
#pragma unroll
  for (int j = 0; j < NA; ++j) acc0[j] = 0.f;
#pragma unroll
  for (int j = 0; j < (kDQ ? 1 : NA); ++j) acc1[j] = 0.f;
  const uint64_t dr0 = make_desc(sR + rg * T::TILE, 16, 8 * T::SWZ, T::LAYOUT);
  const uint64_t dr1 = make_desc(sR + (T::RW + rg) * T::TILE, 16, 8 * T::SWZ, T::LAYOUT);
  mbar_wait(bar_res, 0);
  float row_l2[2] = {0.f, 0.f}, row_dt[2] = {0.f, 0.f};  // dQ: this thread's rows
  if (kDQ) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      row_l2[r] = lse2_from(sStatR[rg * kTile + r_lo + 8 * r]);
      row_dt[r] = sStatR[T::ROWS + rg * kTile + r_lo + 8 * r];
    }
  }

  for (int i = 0; i < n; ++i) {
    const int st = i % S;
    const int p = (t_begin + i) * kTile;
    const int q0 = kDQ ? row0 : p;
    const int k0 = kDQ ? p : row0;
    // Warp 0 refills the stage that step i - 1 used with tile i + S - 1.
    if (warp == 0 && i + S - 1 < n) {
      const int j = i + S - 1;
      if (j >= S) mbar_wait(&bar_empty[j % S], (j / S - 1) & 1);
      issue(j);
    }
    mbar_wait(&bar_full[st], (i / S) & 1);
    if (any_visible(a, q0, k0)) {
      const uint8_t* tt = sT + st * 2 * T::TILE;
      const float* stat = sStatT + st * 2 * kTile;

      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (S = Q·Kᵀ and dP = dO·Vᵀ): 64 x 64, f32.
      float s[32], dp[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] = dp[j] = 0.f;
      const uint64_t dt0 = make_desc(tt, 16, 8 * T::SWZ, T::LAYOUT);
      const uint64_t dt1 = make_desc(tt + T::TILE, 16, 8 * T::SWZ, T::LAYOUT);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int e = kk * 16;
        const uint32_t off = ((e / T::BOXC) * kTile * T::SWZ + (e % T::BOXC) * 2) >> 4;
        wgmma_ss_n64(s, dr0 + off, dt0 + off, kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int e = kk * 16;
        const uint32_t off = ((e / T::BOXC) * kTile * T::SWZ + (e % T::BOXC) * 2) >> 4;
        wgmma_ss_n64(dp, dr1 + off, dt1 + off, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
#pragma unroll
      for (int j = 0; j < 32; ++j) fence_reg(s[j]);

      // P on the fragment, while dP runs: rows are keys and columns query
      // rows (dK/dV), or the other way round (dQ).
      const bool edge = edge_tile(a, q0, kTile, k0, kTile);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int row = r_lo + 8 * ((j / 2) % 2);
        const int col = 8 * (j / 4) + c_lane + j % 2;
        const float l2 = kDQ ? row_l2[(j / 2) % 2] : lse2_from(stat[col]);
        float pv = exp2f(fmaf(s[j], sl2, -l2));
        if (edge && !visible(a, q0 + (kDQ ? row : col), k0 + (kDQ ? col : row))) pv = 0.f;
        s[j] = pv;
      }
      uint32_t pa[4][4], da[4][4];  // P (dK/dV only) and dS as A fragments
      if (!kDQ) to_a(pa, s);
      wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < 32; ++j) fence_reg(dp[j]);

      // dS = P ∘ (dP − Δ).
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float dt = kDQ ? row_dt[(j / 2) % 2] : stat[kTile + 8 * (j / 4) + c_lane + j % 2];
        s[j] *= dp[j] - dt;
      }
      to_a(da, s);
      // dV += Pᵀ·dO and dK += dSᵀ·Q (dQ += dS·K), with dO, Q (K) read
      // MN-major from the streamed tiles.
      const uint64_t m0 = make_desc(tt, kTile * T::SWZ, 8 * T::SWZ, T::LAYOUT) + (col_off >> 4);
      const uint64_t m1 =
          make_desc(tt + T::TILE, kTile * T::SWZ, 8 * T::SWZ, T::LAYOUT) + (col_off >> 4);
      wgmma_fence();
      if (!kDQ) {
#pragma unroll
        for (int t = 0; t < 4; ++t) wgmma_rs<T::DC>(acc1, pa[t], m1 + ((t * 16 * T::SWZ) >> 4));
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) wgmma_rs<T::DC>(acc0, da[t], m0 + ((t * 16 * T::SWZ) >> 4));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < NA; ++j) fence_reg(acc0[j]);
      if (!kDQ) {
#pragma unroll
        for (int j = 0; j < NA; ++j) fence_reg(acc1[j]);
      }
      if (!kDQ) keep(pa);
      keep(da);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&bar_empty[st]);
  }

  // Epilogue, through the outputs' strides: dK (times the scale) and dV
  // in bf16, or at G > 1 this head's dK and dV in float32 to the scratch;
  // dQ times the scale.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r_lo + 8 * r;
    if (row >= (kDQ ? a.S_q : a.S_kv)) continue;
#pragma unroll
    for (int j = 2 * r; j < NA; j += 4) {
      const int col = cg * T::DC + 8 * (j / 4) + c_lane;
      if (kDQ) {
        bf16* dq = static_cast<bf16*>(a.dq) + b * a.dq_sb + row * a.dq_ss + h * a.dq_sh + col;
        *reinterpret_cast<__nv_bfloat162*>(dq) =
            __floats2bfloat162_rn(acc0[j] * a.scale, acc0[j + 1] * a.scale);
      } else if (a.acc != nullptr) {
        const long long plane = static_cast<long long>(a.B) * a.S_kv * a.H * D;
        float* dk = a.acc + ((static_cast<long long>(b) * a.S_kv + row) * a.H + h) * D + col;
        *reinterpret_cast<float2*>(dk) = make_float2(acc0[j], acc0[j + 1]);
        *reinterpret_cast<float2*>(dk + plane) = make_float2(acc1[j], acc1[j + 1]);
      } else {
        bf16* dk = static_cast<bf16*>(a.dk) + b * a.dk_sb + row * a.dk_ss + kvh * a.dk_sh + col;
        bf16* dv = static_cast<bf16*>(a.dv) + b * a.dv_sb + row * a.dv_ss + kvh * a.dv_sh + col;
        *reinterpret_cast<__nv_bfloat162*>(dk) =
            __floats2bfloat162_rn(acc0[j] * a.scale, acc0[j + 1] * a.scale);
        *reinterpret_cast<__nv_bfloat162*>(dv) = __floats2bfloat162_rn(acc1[j], acc1[j + 1]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(Sm90<D>::THREADS, 1)
    dkdv_sm90_kernel(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap to,
                     const BwdArgs a, const MapDims md) {
  bwd_pass<D, false>(&tk, &tv, &tq, &to, a, md);
}

template <int D>
__global__ void __launch_bounds__(Sm90<D>::THREADS, 1)
    dq_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap to,
                   const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                   const BwdArgs a, const MapDims md) {
  bwd_pass<D, true>(&tq, &to, &tk, &tv, a, md);
}

// dk and dv (bf16) from the per-head float32 scratch: each group's G heads
// summed in head order, dk times the scale.  One thread per 4 columns of a
// (batch, key, kv head).
constexpr int kSumThreads = 256;

__global__ void __launch_bounds__(kSumThreads) dkdv_sum_kernel(BwdArgs a, int D) {
  const int per_row = a.KV * D / 4;
  const long long i = static_cast<long long>(blockIdx.x) * kSumThreads + threadIdx.x;
  if (i >= static_cast<long long>(a.B) * a.S_kv * per_row) return;
  const long long row = i / per_row;  // b·S_kv + key
  const int kvh = static_cast<int>(i % per_row) / (D / 4);
  const int col = (static_cast<int>(i % per_row) % (D / 4)) * 4;
  const long long plane = static_cast<long long>(a.B) * a.S_kv * a.H * D;
  const float* src = a.acc + (row * a.H + static_cast<long long>(kvh) * a.G) * D + col;
  float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
  for (int g = 0; g < a.G; ++g) {
    const float4 x = *reinterpret_cast<const float4*>(src + g * D);
    const float4 y = *reinterpret_cast<const float4*>(src + plane + g * D);
    sk.x += x.x;
    sk.y += x.y;
    sk.z += x.z;
    sk.w += x.w;
    sv.x += y.x;
    sv.y += y.y;
    sv.z += y.z;
    sv.w += y.w;
  }
  const int b = static_cast<int>(row / a.S_kv);
  const int key = static_cast<int>(row % a.S_kv);
  bf16* dk = static_cast<bf16*>(a.dk) + b * a.dk_sb + key * a.dk_ss + kvh * a.dk_sh + col;
  bf16* dv = static_cast<bf16*>(a.dv) + b * a.dv_sb + key * a.dv_ss + kvh * a.dv_sh + col;
  reinterpret_cast<__nv_bfloat162*>(dk)[0] = __floats2bfloat162_rn(sk.x * a.scale, sk.y * a.scale);
  reinterpret_cast<__nv_bfloat162*>(dk)[1] = __floats2bfloat162_rn(sk.z * a.scale, sk.w * a.scale);
  reinterpret_cast<__nv_bfloat162*>(dv)[0] = __floats2bfloat162_rn(sv.x, sv.y);
  reinterpret_cast<__nv_bfloat162*>(dv)[1] = __floats2bfloat162_rn(sv.z, sv.w);
}

// ---------------------------------------------------------------------------
// float32: FMA
// ---------------------------------------------------------------------------

constexpr int kFT = 32;         // rows of every tile (queries or keys)
constexpr int kFThreads = 128;  // 16 (rows, 2 each) x 8 (columns)

template <int D>
constexpr int fma_smem_bytes() {
  return (4 * kFT * (D + 1) + kFT * (kFT + 1) * 2 + 2 * kFT) * 4;
}

// kFT rows of D floats into a tile of row stride D + 1; rows at or past
// `valid` are zero.
template <int D>
__device__ __forceinline__ void load_f32(float* dst, const float* src, long long stride, int valid) {
  constexpr int PER = D / 4;
  for (int idx = threadIdx.x; idx < kFT * PER; idx += kFThreads) {
    const int r = idx / PER;
    const int c = (idx % PER) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) x = *reinterpret_cast<const float4*>(src + static_cast<long long>(r) * stride + c);
    float* d = dst + r * (D + 1) + c;
    d[0] = x.x;
    d[1] = x.y;
    d[2] = x.z;
    d[3] = x.w;
  }
}

template <int D>
__global__ void __launch_bounds__(kFThreads) dkdv_fma_kernel(BwdArgs a) {
  constexpr int DP = D + 1, PP = kFT + 1, DN = D / 8;
  extern __shared__ float fsm[];
  float* sK = fsm;
  float* sV = sK + kFT * DP;
  float* sQ = sV + kFT * DP;
  float* sO = sQ + kFT * DP;  // dO
  float* sP = sO + kFT * DP;  // [key][query]
  float* sS = sP + kFT * PP;  // dS, [key][query]
  float* sL = sS + kFT * PP;
  float* sD = sL + kFT;

  const int k0 = blockIdx.x * kFT;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x % 8;  // queries tx + 8j; columns tx + 8c
  const int ty = threadIdx.x / 8;  // keys 2ty, 2ty + 1

  load_f32<D>(sK, static_cast<const float*>(a.k) + b * a.k_sb + kvh * a.k_sh + k0 * a.k_ss,
              a.k_ss, a.S_kv - k0);
  load_f32<D>(sV, static_cast<const float*>(a.v) + b * a.v_sb + kvh * a.v_sh + k0 * a.v_ss,
              a.v_ss, a.S_kv - k0);
  const Span qs = queries_seeing(a, k0, kFT);
  const int qt0 = qs.begin / kFT;
  const int nqt = qs.end > qs.begin ? (qs.end + kFT - 1) / kFT - qt0 : 0;

  float dk[2][DN], dv[2][DN];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < DN; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int g = 0; g < a.G; ++g) {
    const int h = kvh * a.G + g;
    for (int qt = 0; qt < nqt; ++qt) {
      const int q0 = (qt0 + qt) * kFT;
      __syncthreads();  // the previous step's readers are done
      load_f32<D>(sQ, static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh + q0 * a.q_ss,
                  a.q_ss, a.S_q - q0);
      load_f32<D>(sO,
                  static_cast<const float*>(a.dout) + b * a.do_sb + h * a.do_sh + q0 * a.do_ss,
                  a.do_ss, a.S_q - q0);
      if (threadIdx.x < kFT) {
        const int r = threadIdx.x;
        const long long idx = (static_cast<long long>(b) * a.H + h) * a.S_q + q0 + r;
        const bool ok = q0 + r < a.S_q;
        sL[r] = ok ? a.lse[idx] : 0.f;
        sD[r] = ok ? a.delta[idx] : 0.f;
      }
      __syncthreads();

      float s[2][4], dp[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kk[2], vv[2], qq[4], oo[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          kk[i] = sK[(2 * ty + i) * DP + d];
          vv[i] = sV[(2 * ty + i) * DP + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qq[j] = sQ[(tx + 8 * j) * DP + d];
          oo[j] = sO[(tx + 8 * j) * DP + d];
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] += kk[i] * qq[j];
            dp[i][j] += vv[i] * oo[j];
          }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qr = tx + 8 * j;
          const bool ok = visible(a, q0 + qr, k0 + 2 * ty + i);
          const float p = ok ? expf(s[i][j] * a.scale - sL[qr]) : 0.f;
          sP[(2 * ty + i) * PP + qr] = p;
          sS[(2 * ty + i) * PP + qr] = p * (dp[i][j] - sD[qr]);
        }
      __syncthreads();

#pragma unroll 4
      for (int qr = 0; qr < kFT; ++qr) {
        float p[2], ds[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          p[i] = sP[(2 * ty + i) * PP + qr];
          ds[i] = sS[(2 * ty + i) * PP + qr];
        }
#pragma unroll
        for (int c = 0; c < DN; ++c) {
          const float oo = sO[qr * DP + tx + 8 * c];
          const float qq = sQ[qr * DP + tx + 8 * c];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            dv[i][c] += p[i] * oo;
            dk[i][c] += ds[i] * qq;
          }
        }
      }
    }
  }

  float* dkb = static_cast<float*>(a.dk) + b * a.dk_sb + kvh * a.dk_sh;
  float* dvb = static_cast<float*>(a.dv) + b * a.dv_sb + kvh * a.dv_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + 2 * ty + i;
    if (key < a.S_kv) {
#pragma unroll
      for (int c = 0; c < DN; ++c) {
        dkb[key * a.dk_ss + tx + 8 * c] = dk[i][c] * a.scale;
        dvb[key * a.dv_ss + tx + 8 * c] = dv[i][c];
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kFThreads) dq_fma_kernel(BwdArgs a) {
  constexpr int DP = D + 1, PP = kFT + 1, DN = D / 8;
  extern __shared__ float fsm[];
  float* sQ = fsm;
  float* sO = sQ + kFT * DP;  // dO
  float* sK = sO + kFT * DP;
  float* sV = sK + kFT * DP;
  float* sS = sV + kFT * DP;  // dS, [query][key]
  float* sL = sS + kFT * PP;
  float* sD = sL + kFT;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kFT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / a.G;
  const int tx = threadIdx.x % 8;  // keys tx + 8j; columns tx + 8c
  const int ty = threadIdx.x / 8;  // rows 2ty, 2ty + 1

  load_f32<D>(sQ, static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh + q0 * a.q_ss, a.q_ss,
              a.S_q - q0);
  load_f32<D>(sO, static_cast<const float*>(a.dout) + b * a.do_sb + h * a.do_sh + q0 * a.do_ss,
              a.do_ss, a.S_q - q0);
  if (threadIdx.x < kFT) {
    const int r = threadIdx.x;
    const long long idx = (static_cast<long long>(b) * a.H + h) * a.S_q + q0 + r;
    const bool ok = q0 + r < a.S_q;
    sL[r] = ok ? a.lse[idx] : 0.f;
    sD[r] = ok ? a.delta[idx] : 0.f;
  }
  const Span ks = keys_seen(a, q0, kFT);
  const int t0 = ks.begin / kFT;
  const int t1 = ks.end > ks.begin ? (ks.end + kFT - 1) / kFT : t0;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  float dq[2][DN];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < DN; ++c) dq[i][c] = 0.f;

  for (int t = t0; t < t1; ++t) {
    const int k0 = t * kFT;
    __syncthreads();
    load_f32<D>(sK, kb + k0 * a.k_ss, a.k_ss, a.S_kv - k0);
    load_f32<D>(sV, vb + k0 * a.v_ss, a.v_ss, a.S_kv - k0);
    __syncthreads();

    float s[2][4], dp[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qq[2], oo[2], kk[4], vv[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        qq[i] = sQ[(2 * ty + i) * DP + d];
        oo[i] = sO[(2 * ty + i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kk[j] = sK[(tx + 8 * j) * DP + d];
        vv[j] = sV[(tx + 8 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] += qq[i] * kk[j];
          dp[i][j] += oo[i] * vv[j];
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 2 * ty + i;
        const bool ok = visible(a, q0 + r, k0 + tx + 8 * j);
        const float p = ok ? expf(s[i][j] * a.scale - sL[r]) : 0.f;
        sS[r * PP + tx + 8 * j] = p * (dp[i][j] - sD[r]);
      }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kFT; ++kk) {
      float ds[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) ds[i] = sS[(2 * ty + i) * PP + kk];
#pragma unroll
      for (int c = 0; c < DN; ++c) {
        const float kv = sK[kk * DP + tx + 8 * c];
#pragma unroll
        for (int i = 0; i < 2; ++i) dq[i][c] += ds[i] * kv;
      }
    }
  }

  float* dqb = static_cast<float*>(a.dq) + b * a.dq_sb + h * a.dq_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + 2 * ty + i;
    if (row < a.S_q) {
#pragma unroll
      for (int c = 0; c < DN; ++c) dqb[row * a.dq_ss + tx + 8 * c] = dq[i][c] * a.scale;
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// Error codes besides CUDA's (as flash_attention_sm90.cu's): the driver
// entry point or a tensor map.
constexpr int kErrNoEncode = -1;
constexpr int kErrTensorMap = -2;

template <typename Kernel, typename... Args>
cudaError_t launch_one(Kernel kernel, dim3 grid, int threads, int smem, cudaStream_t stream,
                       Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int D>
int launch_sm90(const BwdArgs& a, int dkdv_blocks, int dq_blocks, cudaStream_t stream) {
  using T = Sm90<D>;
  if (encode_tiled() == nullptr) return kErrNoEncode;
  CUtensorMap mq, mk, mv, mo;
  int q_dims[3], k_dims[3], v_dims[3], o_dims[3];
  if (!make_bshd_map(&mq, a.q, a.B, a.S_q, a.H, D, a.q_sb, a.q_ss, a.q_sh, T::BOXC, kTile,
                     q_dims) ||
      !make_bshd_map(&mk, a.k, a.B, a.S_kv, a.KV, D, a.k_sb, a.k_ss, a.k_sh, T::BOXC, kTile,
                     k_dims) ||
      !make_bshd_map(&mv, a.v, a.B, a.S_kv, a.KV, D, a.v_sb, a.v_ss, a.v_sh, T::BOXC, kTile,
                     v_dims) ||
      !make_bshd_map(&mo, a.dout, a.B, a.S_q, a.H, D, a.do_sb, a.do_ss, a.do_sh, T::BOXC, kTile,
                     o_dims))
    return kErrTensorMap;
  MapDims kv_res{}, q_res{};
  for (int i = 0; i < 3; ++i) {
    kv_res.r0[i] = q_res.t0[i] = k_dims[i];
    kv_res.r1[i] = q_res.t1[i] = v_dims[i];
    kv_res.t0[i] = q_res.r0[i] = q_dims[i];
    kv_res.t1[i] = q_res.r1[i] = o_dims[i];
  }
  cudaError_t err = launch_one(dkdv_sm90_kernel<D>, dim3(dkdv_blocks), T::THREADS, T::SMEM,
                               stream, mk, mv, mq, mo, a, kv_res);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.acc != nullptr) {
    const long long n = static_cast<long long>(a.B) * a.S_kv * a.KV * D / 4;
    const dim3 grid(static_cast<unsigned>((n + kSumThreads - 1) / kSumThreads));
    err = launch_one(dkdv_sum_kernel, grid, kSumThreads, 0, stream, a, D);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(launch_one(dq_sm90_kernel<D>, dim3(dq_blocks), T::THREADS, T::SMEM,
                                     stream, mq, mo, mk, mv, a, q_res));
}

int ceil_div(int x, int y) { return (x + y - 1) / y; }

template <int D>
int launch_bwd(const BwdArgs& a, bool bf16_route, int dkdv_blocks, int dq_blocks,
               cudaStream_t stream) {
  // The caller's plan (flash_attention.py::bwd_plan) must be the grids
  // below, and bring the dK/dV scratch exactly where G > 1 on the bf16 route.
  const int tile = bf16_route ? Sm90<D>::ROWS : kFT;
  const int per = bf16_route ? a.B * a.H : a.B * a.KV;
  if (dkdv_blocks != ceil_div(a.S_kv, tile) * per ||
      dq_blocks != ceil_div(a.S_q, tile) * a.B * a.H ||
      (a.acc != nullptr) != (bf16_route && a.G > 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(a.B) * a.H * a.S_q;
  const dim3 dgrid(static_cast<unsigned>((rows + kDeltaWarps - 1) / kDeltaWarps));
  if (bf16_route) {
    delta_kernel<bf16><<<dgrid, kDeltaWarps * 32, 0, stream>>>(a, D);
  } else {
    delta_kernel<float><<<dgrid, kDeltaWarps * 32, 0, stream>>>(a, D);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bf16_route) return launch_sm90<D>(a, dkdv_blocks, dq_blocks, stream);
  err = launch_one(dkdv_fma_kernel<D>, dim3(ceil_div(a.S_kv, kFT), a.KV, a.B), kFThreads,
                   fma_smem_bytes<D>(), stream, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_one(dq_fma_kernel<D>, dim3(ceil_div(a.S_q, kFT), a.H, a.B),
                                     kFThreads, fma_smem_bytes<D>(), stream, a));
}

}  // namespace
}  // namespace repro

// dtype 0 = float32 (FMA), 1 = bfloat16 (tensor cores), for every tensor
// but lse, delta and acc (float32; lse and delta (B, H, S_q) contiguous).
// q, o, dout, dq (B,S_q,H,D); k, v, dk, dv (B,S_kv,KV,D); strides in
// elements, last dimension contiguous, rows 16-byte aligned.  `delta` is
// scratch of the lse's shape; `acc` the bf16 route's (2, B, S_kv, H, D)
// contiguous scratch where H > KV, else null.  dkdv_blocks and dq_blocks
// are the two passes' block counts (flash_attention.py::bwd_plan).  Returns
// the CUDA error of the launches (0 on success), cudaErrorInvalidValue if
// the plan does not match, -1 if the driver's cuTensorMapEncodeTiled is not
// available, -2 if it refuses a tensor map.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* delta, void* dq, void* dk, void* dv, int dtype, int B, int S_q,
    int S_kv, int H, int KV, int D, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh, long long do_sb,
    long long do_ss, long long do_sh, long long dq_sb, long long dq_ss, long long dq_sh,
    long long dk_sb, long long dk_ss, long long dk_sh, long long dv_sb, long long dv_ss,
    long long dv_sh, int causal, int window, int q_offset, float scale, void* acc,
    int dkdv_blocks, int dq_blocks, void* stream) {
  float* scratch = static_cast<float*>(acc);
  const repro::BwdArgs a{q,     k,      v,     o,     dout,  lse,   delta,  scratch,
                         dq,    dk,     dv,    B,     S_q,   S_kv,  H,      KV,
                         H / KV, q_sb,  q_ss,  q_sh,  k_sb,  k_ss,  k_sh,   v_sb,
                         v_ss,  v_sh,   o_sb,  o_ss,  o_sh,  do_sb, do_ss,  do_sh,
                         dq_sb, dq_ss,  dq_sh, dk_sb, dk_ss, dk_sh, dv_sb,  dv_ss,
                         dv_sh, causal, window, q_offset, scale};
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool bf = dtype == 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return repro::launch_bwd<32>(a, bf, dkdv_blocks, dq_blocks, st);
    case 64: return repro::launch_bwd<64>(a, bf, dkdv_blocks, dq_blocks, st);
    case 128: return repro::launch_bwd<128>(a, bf, dkdv_blocks, dq_blocks, st);
    case 256: return repro::launch_bwd<256>(a, bf, dkdv_blocks, dq_blocks, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
