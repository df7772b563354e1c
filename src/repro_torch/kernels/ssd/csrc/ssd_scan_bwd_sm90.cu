// Mamba-2 SSD scan's backward for Hopper (sm_90a), bfloat16 x, B, C and dy:
// dx, ddt, dA, dB, dC, dD and dh0 from the forward's inputs and the
// cotangents of y (dy) and of the final state (dh_final; null in training).
//
// Replaces: nothing on the TPU.  The Pallas kernel
// src/repro/kernels/ssd/ssd_scan.py::ssd has no custom_vjp; jax.grad
// differentiates its plain version, ref.ssd_chunked.  ref.ssd_bwd_plain
// writes out the same passes in PyTorch; float32 inputs take the FMA
// kernels of ssd_scan_bwd.cu.
//
// What bounds it on an H100: at mamba2-370m's training shape (4 x 4096, H
// 32, P 64, N 128) the least work is twice the forward's products, 52.6
// GFLOP (53 µs of bf16 tensor-core time), and x, dt, B, C, dy read and dx,
// ddt, dB, dC written, 222 MB (66 µs at 3.35 TB/s): bytes, narrowly.  The
// chunked backward this kernel computes also moves the chunk states and
// their cotangents, one P x N float32-sized slot per (batch row, head,
// chunk): written by the chunk-state pass, read and rewritten by the walk,
// read by the gradient pass, 2.15 GB at that shape (~0.64 ms at 3.35
// TB/s).  Cutting that needs a scan chained across blocks; it is not done
// here.  What the design does about the rest, four launches:
//   1. ssd_bwd_states_sm90_kernel, one block per (chunk, head group, batch
//      row), the group's heads in order: B and C land once per block
//      (TMA); a copy warp keeps two heads' x and dy (TMA) and decays in a
//      2-stage ring; warpgroup 0 makes H's part (x∘w)ᵀ·B, warpgroup 1 G's
//      part (dy∘exp(cum))ᵀ·C (wgmma, A from registers as hi + lo), each
//      staged in shared memory in its slot's layout (part_off) and written
//      by one 32 KB bulk store.
//   2. ssd_bwd_passing_sm90_kernel, one thread per 8 values of a (head,
//      batch row)'s state: H[c] forwards from h0, G[c] backwards from
//      dh_final, written as bf16 hi + lo planes (hi = bf16(v), lo = bf16(v
//      − hi), as the products took them before) over the part they
//      replace, already in the swizzled layout of the gradient pass's
//      shared-memory tiles: the same bytes, and the gradient pass feeds
//      them to wgmma as they land.
//   3. ssd_bwd_grads_sm90_kernel, one block per (chunk, head group, batch
//      row): C·Bᵀ once per block, not per head; dB and dC summed over the
//      group's heads in float32 registers, in head order, so that no
//      per-head dB/dC scratch exists (one group: written once in bf16;
//      several: each group's sums to a float32 (groups, 2, B, S, N)
//      scratch).  Two warpgroups and no copy warp: a 288-thread block is
//      allocated as 12 warps and capped at 168 registers a thread, where
//      this pass spilled and ptxas serialised its wgmma; at 256 threads it
//      has 255.  Warp 4 issues each head's x and dy (TMA), G and H (32 KB
//      bulk copies) and dt (cp.async) one head ahead into a 2-stage ring,
//      and takes each head's scalar tail (dcum, da, ddt, the chunk's Σ
//      dt·da and Σ dy·x) once all eight warps have released it.  Every
//      product runs on wgmma (m64n64k16, f32 accumulators).  Warpgroup 0
//      (rows t) holds C·Bᵀ, makes M = dY·Xᵀ and the gates L = exp(cum_t −
//      cum_s) once per head, K = L ∘ dt_s ∘ M and C·Bᵀ ∘ L, hands each to
//      warpgroup 1 as hi + lo planes through one 16 KB buffer, and adds
//      the head's dC (exp(cum) ∘ dY·H + K·B) into its sum; it makes H C.
//      Warpgroup 1 (rows s) reads Kᵀ and (C·Bᵀ ∘ L)ᵀ from those planes as
//      MN-major A operands, adds the head's dB (dt·exp(tot − cum) ∘ X·G +
//      Kᵀ·C) into its sum, and makes U = exp(tot − cum) ∘ B·Gᵀ + (C·Bᵀ ∘
//      L)ᵀ·dY, dx = dt·U + D·dy, x·U and dy·x.  rowt = Σ_s (C·Bᵀ)∘K, colt =
//      Σ_t (C·Bᵀ)∘K, x·U and dy·(H C) come from the accumulator fragments
//      by sums over a thread's elements and shuffles across its quad (rows)
//      or warp (columns, then the four warps in order); ⟨G, H⟩ from the
//      planes.  dB and dC are made in halves of 64 columns.
//   4. ssd_bwd_reduce_sm90_kernel: dA and dD over (batch row, chunk), a
//      warp per head, and where there are several groups dB and dC as the
//      groups' sums in group order.
// No atomics anywhere: two calls give the same bits.  ssd_scan.bwd_plan
// lays out the launches and the scratch; it takes as many heads a group as
// the fewest groups that give >= 132 blocks (one wave) allow: all 32 at
// mamba2-370m's 4 x 4096.
// Rounding points, as the first version of this kernel had them: x, dy, B
// and C enter the products exactly; every float32 operand enters as hi +
// lo (C·Bᵀ ∘ L, K, H, G, and in the chunk-state pass x∘w and dy∘exp(cum)),
// each part one product into the same float32 sum; the within-chunk
// cumsum is kept in double and each decay's difference rounded once
// before the exp; dx, dB and dC are rounded to bf16 once.  P (16, 32, 64)
// and N (<= 128) are padded to 64 and 128 in shared memory by the loads'
// zero fill, so one layout serves every shape.
#include "../../attention/csrc/common.cuh"

namespace repro {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kQ = 64;                 // chunk length
constexpr int kPP = 64;                // P padded
constexpr int kNP = 128;               // N padded
constexpr int kTile = kQ * 64 * 2;     // bytes of a 64 x 64 bf16 box (128-byte rows)
constexpr int kPlane = 2 * kTile;      // one bf16 plane of a 64 x 128 state
constexpr int kSlot = kPP * kNP * 4;   // one (b, h, c) state: f32 part or hi + lo planes
constexpr int kConsumers = 256;        // two warpgroups
constexpr int kThreads = kConsumers + 32;  // the chunk-state pass: and its copy warp
constexpr int kCopyWarp = kConsumers / 32;
constexpr int kWalkThreads = 256;      // the walk's block, 8 values a thread
constexpr int kReduceThreads = 256;

struct Args {
  const bf16* x;           // (B, S, H, P)
  const float* dt;         // (B, S, H), last dim contiguous
  const float* A;          // (H,)
  const float* D;          // (H,)
  const float* h0;         // (B, H, P, N) or null
  const float* dh_final;   // (B, H, P, N) or null
  bf16* dx;                // (B, S, H, P) contiguous
  float* ddt;              // (B, S, H) contiguous
  float* dA;               // (H,)
  bf16* dBm;               // (B, S, N) contiguous
  bf16* dCm;               // (B, S, N) contiguous
  float* dD;               // (H,)
  float* dh0;              // (B, H, P, N) or null
  uint8_t* states;         // (2, B, H, nc) slots of kSlot bytes
  float* a_tot;            // (B, H, nc)
  float* ad;               // (2, B, nc, H): each chunk's Σ dt·da and Σ dy·x
  float* gsum;             // (groups, 2, B, S, N): each group's dB and dC, or null
  int B, S, H, P, N, nc, group, groups;
  long long dt_sb, dt_ss;
  int xd[3], dyd[3];       // positions of (head, row, batch) in x's and dy's tensor maps
};

__device__ __forceinline__ uint8_t* slot(const Args& a, int which, int b, int h, int c) {
  return a.states + ((((long long)which * a.B + b) * a.H + h) * a.nc + c) * kSlot;
}

// Byte offset of element (r, c) in a tile of 64-column boxes of 64 rows
// with the 128-byte swizzle (TMA's, and wgmma's layout 1): the 16-byte
// chunk index XOR the row mod 8.
__device__ __forceinline__ int sw(int r, int c) {
  return (c >> 6) * kTile + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4) + ((c & 7) << 1);
}
// Byte offset of the float32 part's value (p, n) in its slot: the 8 values
// (p, n0..n0 + 7), n0 = n & ~7, whose bf16 hi and lo planes the walk writes
// at sw(p, n0) and sw(p, n0) + kPlane, are stored as their first four and
// last four at those same two places.  So a walk thread reads exactly the
// bytes it then overwrites, and no thread's planes land on another's part.
__device__ __forceinline__ int part_off(int p, int n) {
  return sw(p, n & ~7) + ((n & 7) < 4 ? 4 * (n & 7) : kPlane + 4 * ((n & 7) - 4));
}
__device__ __forceinline__ float ld_bf16(const uint8_t* tile, int r, int c) {
  return __bfloat162float(*reinterpret_cast<const bf16*>(tile + sw(r, c)));
}
__device__ __forceinline__ float2 ld_bf16x2(const uint8_t* tile, int r, int c) {  // c even
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(tile + sw(r, c)));
}
__device__ __forceinline__ float2 bf2(uint32_t v) {  // two packed bf16 values
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}
// acc + (g_hi + g_lo)·(h_hi + h_lo) over two packed pairs, in order.
__device__ __forceinline__ float dot2(uint32_t ghi, uint32_t glo, uint32_t hhi, uint32_t hlo,
                                     float acc) {
  const float2 a = bf2(ghi), b = bf2(glo), c = bf2(hhi), d = bf2(hlo);
  acc += (a.x + b.x) * (c.x + d.x);
  return acc + (a.y + b.y) * (c.y + d.y);
}

// wgmma descriptors of such a tile: K-major (rows are M or N, a k step of
// 16 moves 32 bytes within a box, 64 columns a box) and MN-major (rows are
// K, a k step of 16 moves 16 rows; 64-column boxes 8 KB apart).
__device__ __forceinline__ uint64_t kdesc(const uint8_t* tile, int k) {
  return make_desc(tile + (k >> 6) * kTile + (k & 63) * 2, 16, 1024, 1);
}
__device__ __forceinline__ uint64_t mdesc(const uint8_t* tile, int k) {
  return make_desc(tile + k * 128, kTile, 1024, 1);
}

// D (64 x 64, f32) += A (64 x 16, shared) · B (16 x 64, shared), each
// K-major, or MN-major with kTA / kTB.
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_ss64(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, "
      "%35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(kTA), "n"(kTB));
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}
template <int N>
__device__ __forceinline__ void fence_all(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_reg(d[i]);
}
// Keeps register A fragments alive until the wgmma that reads them is done.
__device__ __forceinline__ void keep(const uint32_t (&f)[4][4]) {
#pragma unroll
  for (int t = 0; t < 4; ++t)
    asm volatile("" ::"r"(f[t][0]), "r"(f[t][1]), "r"(f[t][2]), "r"(f[t][3]));
}
// A 64 x 64 accumulator as the hi and lo parts of the four A fragments of
// a product over its 64 columns: columns 16t..16t+15 are registers 8t..8t+7.
__device__ __forceinline__ void split_a(const float (&s)[32], uint32_t (&hi)[4][4],
                                        uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float v0 = s[8 * t + 2 * x], v1 = s[8 * t + 2 * x + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
      const float2 hf = __bfloat1622float2(h);
      hi[t][x] = *reinterpret_cast<const uint32_t*>(&h);
      lo[t][x] = pack_bf16(v0 - hf.x, v1 - hf.y);
    }
}
// acc (64 x 64) += (hi + lo) · B, B MN-major (K rows from `tile`).
__device__ __forceinline__ void rs64(float (&acc)[32], const uint32_t (&hi)[4][4],
                                     const uint32_t (&lo)[4][4], const uint8_t* tile) {
#pragma unroll
  for (int t = 0; t < 4; ++t) wgmma_rs_n64(acc, hi[t], mdesc(tile, 16 * t));
#pragma unroll
  for (int t = 0; t < 4; ++t) wgmma_rs_n64(acc, lo[t], mdesc(tile, 16 * t));
}

// Sum over the 4 lanes of a quad (the lanes holding one accumulator row).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// A bulk copy of `bytes` from shared to global memory in this thread's bulk
// group; the shared-memory writes it reads must be fenced for the async
// proxy first.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, int bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void bulk_wait_read() {  // this thread's bulk stores have read
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int col, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row), "r"(batch)
      : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// One head's chunk vectors, written by one warp: cum (the inclusive
// cumsum of the float32 products A·dt in double), dt (0 past S),
// exp(cum_t) and exp(tot − cum_t).
struct Decay {
  double cum[kQ];
  float dt[kQ], ecum[kQ], etail[kQ];
};

// One warp: the decay of a chunk from its dt (lane l holds rows 2l and
// 2l + 1; 0 past S) by one shuffle scan (as ssd_scan.cu's forward), into
// `d`; returns tot.
__device__ __forceinline__ double scan_decay(const float (&dv)[2], float Ah, Decay* d) {
  const int lane = threadIdx.x % 32;
  double v[2], run = 0.0;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    run += static_cast<double>(Ah * dv[e]);
    v[e] = run;
  }
  double tot = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double up = __shfl_up_sync(0xffffffffu, tot, off);
    if (lane >= off) tot += up;
  }
  double excl = __shfl_up_sync(0xffffffffu, tot, 1);
  if (lane == 0) excl = 0.0;
  tot = __shfl_sync(0xffffffffu, tot, 31);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int t = 2 * lane + e;
    const double cum = excl + v[e];
    d->cum[t] = cum;
    d->dt[t] = dv[e];
    d->ecum[t] = expf(static_cast<float>(cum));
    d->etail[t] = expf(static_cast<float>(tot - cum));
  }
  return tot;
}

__device__ __forceinline__ const float* dt_row(const Args& a, int b, int h, int t) {
  return a.dt + b * a.dt_sb + (long long)t * a.dt_ss + h;
}

// cp.async of one float, zero-filled when !valid; and an arrival on `bar`
// once this thread's earlier cp.async copies have landed (counted in the
// barrier's arrivals: .noinc).
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Per-head vectors of the gradient pass, in floats: rowt, each consumer
// warp of warpgroup 0's column sums of (C·Bᵀ)∘K (colt is their sum), x·U,
// exp(cum)·dy·(H C), dy·x, and the consumers' ⟨G, H⟩ partials.
constexpr int kRowt = 0, kColp = kQ, kXu = kColp + 4 * kQ, kInter = kXu + kQ,
              kDyx = kInter + kQ, kRed = kDyx + kQ, kVecFloats = kRed + kConsumers;

// Shared memory of the two passes over (chunk, head group, batch row),
// from a 1024-byte aligned base: C and B (two 64-column boxes each), then
// two stages of the ring, each holding a head's x and dy boxes, its
// vectors and (gradient pass) its G and H planes, then per-head vectors
// (double-buffered by head parity) and the barriers.
template <bool kGrads>
struct Smem {
  static constexpr int kC = 0;
  static constexpr int kB = kC + 2 * kTile;
  static constexpr int kRing = kB + 2 * kTile;
  static constexpr int kX = 0;                    // within a stage
  static constexpr int kDy = kX + kTile;
  static constexpr int kG = kDy + kTile;          // [hi, lo] planes, as the walk writes them
  static constexpr int kH = kG + (kGrads ? 2 * kPlane : 0);
  static constexpr int kDt = kH + (kGrads ? 2 * kPlane : 0);  // the gradient pass's dt as loaded
  static constexpr int kDecay = kDt + (kGrads ? kQ * 4 : 0);  // one per consumer warpgroup
  static constexpr int kStage =
      (kDecay + (kGrads ? 2 : 1) * static_cast<int>(sizeof(Decay)) + 1023) / 1024 * 1024;
  // The gradient pass's planes for warpgroup 1 (K, then C·Bᵀ ∘ L) and
  // per-head vectors (kVecFloats, double-buffered by head parity); the
  // chunk-state pass's parts, one slot per warpgroup, on their way out.
  static constexpr int kS1 = kRing + 2 * kStage;
  static constexpr int kOut = kS1;
  static constexpr int kVec = kS1 + (kGrads ? 2 * kTile : 2 * kSlot);
  static constexpr int kBars = kVec + (kGrads ? 2 * kVecFloats * 4 : 0);
  static constexpr int kBytes = kBars + 5 * 8;    // full[2], empty[2], cb
  static constexpr int kAlloc = kBytes + 1024;
};

__device__ __forceinline__ uint8_t* aligned_base() {
  extern __shared__ uint8_t smem_raw[];
  return smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
}

// B and C of a block's chunk into their tiles (two 64-column boxes each,
// at the same offsets in both passes), on `cb`; by one thread.
__device__ __forceinline__ void load_bc(uint8_t* base, const CUtensorMap* tb,
                                        const CUtensorMap* tc, uint64_t* cb, int t0, int b) {
  mbar_expect_tx(cb, 4 * kTile);
  for (int box = 0; box < 2; ++box) {
    tma_load_3d(base + Smem<true>::kC + box * kTile, tc, cb, 64 * box, t0, b);
    tma_load_3d(base + Smem<true>::kB + box * kTile, tb, cb, 64 * box, t0, b);
  }
}

// The chunk-state pass's copy warp, head j of the block: its x and dy into
// its stage and its decay, on full[j % 2] (two arrivals: the transaction
// bytes, then the decay); returns tot.
__device__ __forceinline__ double states_head(const Args& a, const CUtensorMap* tx,
                                              const CUtensorMap* tdy, uint8_t* base,
                                              uint64_t* full, int j, int b, int h, int t0,
                                              int valid) {
  using S = Smem<false>;
  const int st = j & 1, lane = threadIdx.x % 32;
  uint8_t* stage = base + S::kRing + st * S::kStage;
  if (lane == 0) {
    mbar_expect_tx(&full[st], 2 * kTile);
    tma_load(stage + S::kX, tx, a.xd, &full[st], 0, h, t0, b);
    tma_load(stage + S::kDy, tdy, a.dyd, &full[st], 0, h, t0, b);
  }
  float dv[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int t = 2 * lane + e;
    dv[e] = t < valid ? *dt_row(a, b, h, t0 + t) : 0.f;
  }
  const double tot = scan_decay(dv, a.A[h], reinterpret_cast<Decay*>(stage + S::kDecay));
  __syncwarp();
  if (lane == 0) mbar_arrive(&full[st]);
  return tot;
}

// ---------------------------------------------------------------------------
// Pass 1: each head's chunk parts of H, (x∘w)ᵀ·B with w_t = exp(tot − cum_t)
// dt_t (warpgroup 0), and of G, (dy∘exp(cum))ᵀ·C (warpgroup 1): P x N
// float32 each, 64 x 128 with zeros past P and N, into the head's slots
// (laid out by part_off); and tot.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads, 1)
    ssd_bwd_states_sm90_kernel(const __grid_constant__ CUtensorMap tx,
                               const __grid_constant__ CUtensorMap tdy,
                               const __grid_constant__ CUtensorMap tb,
                               const __grid_constant__ CUtensorMap tc, const Args a) {
  using S = Smem<false>;
  uint8_t* base = aligned_base();
  uint64_t* full = reinterpret_cast<uint64_t*>(base + S::kBars);
  uint64_t* cb = full + 2;
  const int c = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;
  const int t0 = c * kQ, valid = min(kQ, a.S - t0);
  const int hg0 = grp * a.group, heads = min(a.group, a.H - hg0);
  if (threadIdx.x == 0) {
    mbar_init(&full[0], 2);
    mbar_init(&full[1], 2);
    mbar_init(cb, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x / 32 == kCopyWarp) {
    if (threadIdx.x % 32 == 0) load_bc(base, &tb, &tc, cb, t0, b);
    const auto head = [&](int j) {
      const double tot = states_head(a, &tx, &tdy, base, full, j, b, hg0 + j, t0, valid);
      if (threadIdx.x % 32 == 0)
        a.a_tot[((long long)b * a.H + hg0 + j) * a.nc + c] = static_cast<float>(tot);
    };
    for (int j = 0; j < min(2, heads); ++j) head(j);
    for (int j = 0; j < heads; ++j) {
      bar_sync(1 + (j & 1), kThreads);  // the consumers are done with head j's stage
      if (j + 2 < heads) head(j + 2);
    }
    return;
  }

  const int wg = threadIdx.x / 128, w = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4, r0 = 16 * w + g;
  const uint8_t* rhs = base + (wg == 0 ? S::kB : S::kC);  // B for H's part, C for G's
  mbar_wait(cb, 0);
  for (int j = 0; j < heads; ++j) {
    const int st = j & 1, h = hg0 + j;
    const uint8_t* stage = base + S::kRing + st * S::kStage;
    mbar_wait(&full[st], (j >> 1) & 1);
    const uint8_t* src = stage + (wg == 0 ? S::kX : S::kDy);
    const Decay* d = reinterpret_cast<const Decay*>(stage + S::kDecay);
    // A = (x∘w)ᵀ or (dy∘exp(cum))ᵀ: rows p, k = t, as hi + lo fragments.
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int kt = 0; kt < 4; ++kt)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int p = r0 + 8 * (x & 1), t = 16 * kt + 2 * q + 8 * (x >> 1);
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float s = wg == 0 ? d->etail[t + e] * d->dt[t + e] : d->ecum[t + e];
          v[e] = ld_bf16(src, t + e, p) * s;
        }
        const __nv_bfloat162 hv = __floats2bfloat162_rn(v[0], v[1]);
        const float2 hf = __bfloat1622float2(hv);
        hi[kt][x] = *reinterpret_cast<const uint32_t*>(&hv);
        lo[kt][x] = pack_bf16(v[0] - hf.x, v[1] - hf.y);
      }
    float acc[64];
    zero(acc);
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) wgmma_rs_n128(acc, hi[kt], mdesc(rhs, 16 * kt));
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) wgmma_rs_n128(acc, lo[kt], mdesc(rhs, 16 * kt));
    wgmma_commit();
    wgmma_wait<0>();
    fence_all(acc);
    keep(hi);
    keep(lo);
    __syncwarp();
    bar_arrive(1 + st, kThreads);  // the stage is free; the part goes out from registers
    // The part, in its slot's layout, into this warpgroup's staging slot
    // (once the previous head's store has read it), then one bulk store.
    uint8_t* out = base + S::kOut + wg * kSlot;
    const bool elected = threadIdx.x % 128 == 0;
    if (elected) bulk_wait_read();
    bar_sync(3 + wg, 128);
#pragma unroll
    for (int j2 = 0; j2 < 64; j2 += 2) {
      const int p = r0 + 8 * ((j2 >> 1) & 1), n = 8 * (j2 >> 2) + 2 * q;
      *reinterpret_cast<float2*>(out + part_off(p, n)) = make_float2(acc[j2], acc[j2 + 1]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_sync(3 + wg, 128);
    if (elected) bulk_store(slot(a, wg, b, h, c), out, kSlot);
  }
  if (threadIdx.x % 128 == 0) bulk_wait_read();  // the last part is read before exit
}

// ---------------------------------------------------------------------------
// Pass 2: one thread per 8 values (p, n0..n0 + 7) of the padded 64 x 128
// state of a (head, batch row), kWalkThreads a block.  Forwards from h0:
// in place of each chunk's part, H[c], the state entering it; backwards
// from dh_final: G[c], the state's cotangent leaving it (G[c−1] =
// exp(tot_c)·G[c] + the chunk's part); each as bf16 hi + lo planes in the
// gradient pass's swizzled tile layout, over the same 32 bytes of the slot
// that held the thread's part (part_off).  Each walk reads kWalk chunks'
// parts and decays before it writes any, so that the loads are in flight
// together; the chain is arithmetic.  dh0 where h0 was given.
// ---------------------------------------------------------------------------
constexpr int kWalk = 8;

__global__ void __launch_bounds__(kWalkThreads) ssd_bwd_passing_sm90_kernel(const Args a) {
  const int i = blockIdx.x * kWalkThreads + threadIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int p = i / (kNP / 8), n0 = (i % (kNP / 8)) * 8;
  const long long bh = (long long)b * a.H + h;
  const float* at = a.a_tot + bh * a.nc;
  const int off = sw(p, n0);  // this thread's 16 bytes in the hi plane (lo: + kPlane)
  for (int which = 0; which < 2; ++which) {
    const float* init = which == 0 ? a.h0 : a.dh_final;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = init != nullptr && p < a.P && n0 + e < a.N ? init[(bh * a.P + p) * a.N + n0 + e] : 0.f;
    for (int k0 = 0; k0 < a.nc; k0 += kWalk) {
      float4 part[kWalk][2];
      float decay[kWalk];
#pragma unroll
      for (int u = 0; u < kWalk; ++u) {
        const int c = which == 0 ? k0 + u : a.nc - 1 - (k0 + u);
        const bool in = k0 + u < a.nc;
        const uint8_t* src = slot(a, which, b, h, in ? c : 0) + off;
        part[u][0] = in ? *reinterpret_cast<const float4*>(src) : make_float4(0.f, 0.f, 0.f, 0.f);
        part[u][1] = in ? *reinterpret_cast<const float4*>(src + kPlane)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        decay[u] = in ? at[c] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kWalk; ++u) {
        if (k0 + u >= a.nc) continue;
        const int c = which == 0 ? k0 + u : a.nc - 1 - (k0 + u);
        uint32_t hv[4], lv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const __nv_bfloat162 hh = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
          const float2 hf = __bfloat1622float2(hh);
          hv[e] = *reinterpret_cast<const uint32_t*>(&hh);
          lv[e] = pack_bf16(v[2 * e] - hf.x, v[2 * e + 1] - hf.y);
        }
        uint8_t* dst = slot(a, which, b, h, c) + off;
        *reinterpret_cast<uint4*>(dst) = make_uint4(hv[0], hv[1], hv[2], hv[3]);
        *reinterpret_cast<uint4*>(dst + kPlane) = make_uint4(lv[0], lv[1], lv[2], lv[3]);
        const float s = expf(decay[u]);
        const float pv[8] = {part[u][0].x, part[u][0].y, part[u][0].z, part[u][0].w,
                             part[u][1].x, part[u][1].y, part[u][1].z, part[u][1].w};
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = fmaf(s, v[e], pv[e]);
      }
    }
    if (which == 1 && a.dh0 != nullptr && p < a.P) {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (n0 + e < a.N) a.dh0[(bh * a.P + p) * a.N + n0 + e] = v[e];
    }
  }
}

// ---------------------------------------------------------------------------
// Pass 3: one block per (chunk, head group, batch row), the group's heads
// in order.  See the header note for the split of the work.
// ---------------------------------------------------------------------------

// Named barriers between the warpgroups, over one 16 KB buffer of bf16 hi
// + lo planes that warpgroup 0 fills and warpgroup 1 reads transposed (an
// MN-major A operand): K, then C·Bᵀ ∘ L, each head.  kBarK / kBarS1: the
// planes are written; kBarKFree / kBarS1Free: read.  kBarDecay + the
// warpgroup: its copy of the head's decay is written.
constexpr int kBarK = 1, kBarKFree = 2, kBarS1 = 3, kBarS1Free = 4, kBarDecay = 5;

// v (a 64 x 64 accumulator fragment, rows t, columns s) as hi + lo planes
// in the swizzled tile layout; fenced for the other warpgroup's wgmma.
__device__ __forceinline__ void store_planes(uint8_t* buf, const float (&v)[32], int r0, int q) {
#pragma unroll
  for (int j = 0; j < 32; j += 2) {
    const int t = r0 + 8 * ((j >> 1) & 1), s = 8 * (j >> 2) + 2 * q;
    const __nv_bfloat162 hv = __floats2bfloat162_rn(v[j], v[j + 1]);
    const float2 hf = __bfloat1622float2(hv);
    *reinterpret_cast<__nv_bfloat162*>(buf + sw(t, s)) = hv;
    *reinterpret_cast<uint32_t*>(buf + kTile + sw(t, s)) = pack_bf16(v[j] - hf.x, v[j + 1] - hf.y);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Warpgroup 0, one head (rows t): M = dY·Xᵀ, the gates L, K = L ∘ dt_s ∘ M
// and C·Bᵀ ∘ L, each handed to warpgroup 1 through the planes; rowt and
// the column sums of (C·Bᵀ)∘K; the head's dC (exp(cum) ∘ dY·H + K·B)
// into dsum; H C and exp(cum)·dy·(H C).
__device__ __forceinline__ void grads_wg0(const uint8_t* base, const uint8_t* stage,
                                          const Decay* d, uint8_t* planes,
                                          const float (&cb)[32], float (&dsum)[2][32],
                                          float* vec, int w, int lane, bool first) {
  using S = Smem<true>;
  const int q = lane % 4, r0 = 16 * w + lane / 4;
  const uint8_t *sx = stage + S::kX, *sdy = stage + S::kDy, *sH = stage + S::kH;
  const uint8_t *sB = base + S::kB, *sC = base + S::kC;
  float m[32];
  zero(m);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kPP / 16; ++kk)
    wgmma_ss64<0, 0>(m, kdesc(sdy, 16 * kk), kdesc(sx, 16 * kk));
  wgmma_commit();
  wgmma_wait<0>();
  fence_all(m);
  // L[t, s] = exp(cum_t − cum_s) on and below the diagonal (selected before
  // the exp, whose argument is positive above it), 0 above: K = L·dt_s·M
  // and C·Bᵀ ∘ L from one gate each.
  float s1[32], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int t = r0 + 8 * ((j >> 1) & 1), s = 8 * (j >> 2) + 2 * q + (j & 1);
    const float l = s <= t ? expf(static_cast<float>(d->cum[t] - d->cum[s])) : 0.f;
    m[j] = l * d->dt[s] * m[j];
    s1[j] = l * cb[j];
    rs[(j >> 1) & 1] += cb[j] * m[j];
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const float v = quad_sum(rs[rr]);
    if (q == 0) vec[kRowt + r0 + 8 * rr] = v;
  }
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = cb[4 * jj + e] * m[4 * jj + e] + cb[4 * jj + 2 + e] * m[4 * jj + 2 + e];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < 4) vec[kColp + w * kQ + 8 * jj + 2 * q + e] = v;
    }
  // K to warpgroup 1 (once it is done with the previous head's planes),
  // then dC += K·B from K's own fragments.
  if (!first) bar_sync(kBarS1Free, kConsumers);
  store_planes(planes, m, r0, q);
  bar_arrive(kBarK, kConsumers);
  {
    uint32_t khi[4][4], klo[4][4];
    split_a(m, khi, klo);
    wgmma_fence();
    rs64(dsum[0], khi, klo, sB);
    rs64(dsum[1], khi, klo, sB + kTile);
    wgmma_commit();
    wgmma_wait<0>();
    fence_all(dsum[0]);
    fence_all(dsum[1]);
    keep(khi);
    keep(klo);
  }
  // dC's other term, per 64-column half: exp(cum) ∘ dY·H.
  const float ec[2] = {d->ecum[r0], d->ecum[r0 + 8]};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float tmp[32];
    zero(tmp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kPP / 16; ++kk)
      wgmma_ss64<0, 1>(tmp, kdesc(sdy, 16 * kk), mdesc(sH + half * kTile, 16 * kk));
#pragma unroll
    for (int kk = 0; kk < kPP / 16; ++kk)
      wgmma_ss64<0, 1>(tmp, kdesc(sdy, 16 * kk), mdesc(sH + kPlane + half * kTile, 16 * kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_all(tmp);
#pragma unroll
    for (int j = 0; j < 32; ++j) dsum[half][j] += tmp[j] * ec[(j >> 1) & 1];
  }
  // C·Bᵀ ∘ L to warpgroup 1, once it is done with K.
  bar_sync(kBarKFree, kConsumers);
  store_planes(planes, s1, r0, q);
  bar_arrive(kBarS1, kConsumers);
  // H C (64 x P) and exp(cum_t) dy_t·(H C)_t.
  float hc[32];
  zero(hc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kNP / 16; ++kk)
    wgmma_ss64<0, 0>(hc, kdesc(sC, 16 * kk), kdesc(sH, 16 * kk));
#pragma unroll
  for (int kk = 0; kk < kNP / 16; ++kk)
    wgmma_ss64<0, 0>(hc, kdesc(sC, 16 * kk), kdesc(sH + kPlane, 16 * kk));
  wgmma_commit();
  wgmma_wait<0>();
  fence_all(hc);
  float ir[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 32; j += 2) {
    const int rr = (j >> 1) & 1, p = 8 * (j >> 2) + 2 * q;
    const float2 dyv = ld_bf16x2(sdy, r0 + 8 * rr, p);
    ir[rr] += dyv.x * hc[j] + dyv.y * hc[j + 1];
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const float v = quad_sum(ir[rr]);
    if (q == 0) vec[kInter + r0 + 8 * rr] = ec[rr] * v;
  }
}

// Warpgroup 1, one head (rows s), first part: dB's term dt·exp(tot − cum)
// ∘ X·G into dsum, per 64-column half.
__device__ __forceinline__ void grads_wg1_xg(const uint8_t* stage, const Decay* d,
                                             float (&dsum)[2][32], int w, int lane) {
  using S = Smem<true>;
  const int r0 = 16 * w + lane / 4;
  const uint8_t *sx = stage + S::kX, *sG = stage + S::kG;
  const float wr[2] = {d->dt[r0] * d->etail[r0], d->dt[r0 + 8] * d->etail[r0 + 8]};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float tmp[32];
    zero(tmp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kPP / 16; ++kk)
      wgmma_ss64<0, 1>(tmp, kdesc(sx, 16 * kk), mdesc(sG + half * kTile, 16 * kk));
#pragma unroll
    for (int kk = 0; kk < kPP / 16; ++kk)
      wgmma_ss64<0, 1>(tmp, kdesc(sx, 16 * kk), mdesc(sG + kPlane + half * kTile, 16 * kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_all(tmp);
#pragma unroll
    for (int j = 0; j < 32; ++j) dsum[half][j] += tmp[j] * wr[(j >> 1) & 1];
  }
}

// Warpgroup 1, the rest of the head: dB += Kᵀ·C with Kᵀ read from the
// planes; U = exp(tot − cum) ∘ B·Gᵀ + (C·Bᵀ ∘ L)ᵀ·dY; dx, x·U and dy·x.
__device__ __forceinline__ void grads_wg1(const Args& a, const uint8_t* base,
                                          const uint8_t* stage, const Decay* d,
                                          const uint8_t* planes, float (&dsum)[2][32],
                                          float* vec, int w, int lane, bool last, int b, int h,
                                          int t0, int valid) {
  using S = Smem<true>;
  const int q = lane % 4, r0 = 16 * w + lane / 4;
  const uint8_t *sx = stage + S::kX, *sdy = stage + S::kDy, *sG = stage + S::kG;
  const uint8_t *sB = base + S::kB, *sC = base + S::kC;
  bar_sync(kBarK, kConsumers);
  wgmma_fence();
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int kk = 0; kk < kQ / 16; ++kk)
        wgmma_ss64<1, 1>(dsum[half], mdesc(planes + p * kTile, 16 * kk),
                         mdesc(sC + half * kTile, 16 * kk));
  wgmma_commit();
  wgmma_wait<0>();
  fence_all(dsum[0]);
  fence_all(dsum[1]);
  bar_arrive(kBarKFree, kConsumers);
  const float et[2] = {d->etail[r0], d->etail[r0 + 8]};
  const float dts[2] = {d->dt[r0], d->dt[r0 + 8]};
  float u[32];
  zero(u);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kNP / 16; ++kk) wgmma_ss64<0, 0>(u, kdesc(sB, 16 * kk), kdesc(sG, 16 * kk));
#pragma unroll
  for (int kk = 0; kk < kNP / 16; ++kk)
    wgmma_ss64<0, 0>(u, kdesc(sB, 16 * kk), kdesc(sG + kPlane, 16 * kk));
  wgmma_commit();
  wgmma_wait<0>();
  fence_all(u);
#pragma unroll
  for (int j = 0; j < 32; ++j) u[j] *= et[(j >> 1) & 1];
  bar_sync(kBarS1, kConsumers);
  wgmma_fence();
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int kk = 0; kk < kQ / 16; ++kk)
      wgmma_ss64<1, 1>(u, mdesc(planes + p * kTile, 16 * kk), mdesc(sdy, 16 * kk));
  wgmma_commit();
  wgmma_wait<0>();
  fence_all(u);
  if (!last) bar_arrive(kBarS1Free, kConsumers);
  // dx = dt·U + D·dy (rows past S and columns past P not written); x·U and
  // dy·x of each row.
  const float Dh = a.D[h];
  float xr[2] = {0.f, 0.f}, yr[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 32; j += 2) {
    const int rr = (j >> 1) & 1, s = r0 + 8 * rr, p = 8 * (j >> 2) + 2 * q;
    const float2 xv = ld_bf16x2(sx, s, p), dyv = ld_bf16x2(sdy, s, p);
    xr[rr] += xv.x * u[j] + xv.y * u[j + 1];
    yr[rr] += xv.x * dyv.x + xv.y * dyv.y;
    if (s < valid && p < a.P)
      *reinterpret_cast<__nv_bfloat162*>(a.dx + (((long long)b * a.S + t0 + s) * a.H + h) * a.P +
                                         p) =
          __floats2bfloat162_rn(dts[rr] * u[j] + Dh * dyv.x, dts[rr] * u[j + 1] + Dh * dyv.y);
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const float v = quad_sum(xr[rr]), v2 = quad_sum(yr[rr]);
    if (q == 0) {
      vec[kXu + r0 + 8 * rr] = v;
      vec[kDyx + r0 + 8 * rr] = v2;
    }
  }
}

// The issuing warp's tail of one head: dcum_t = rowt_t + inter_t − dt_t x_t·U_t
// (+ exp(tot)·⟨G, H⟩ + Σ_t (dt x·U − colt) at the chunk's end), reverse-
// summed in double into da; ddt = x·U + A·da; the chunk's Σ dt·da and
// Σ dy·x into the `ad` scratch.
__device__ __forceinline__ void grads_tail(const Args& a, const Decay* d, const float* vec,
                                           int b, int h, int c, int t0, int valid) {
  const int lane = threadIdx.x % 32;
  double gsum = 0.0;
  for (int k = lane; k < kConsumers; k += 32) gsum += vec[kRed + k];
  gsum = warp_sum(gsum);
  const double tot = d->cum[kQ - 1];
  double dcum[2], side = 0.0, sdyx = 0.0;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int t = 2 * lane + e;
    float colt = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) colt += vec[kColp + w * kQ + t];
    const double dxu = static_cast<double>(d->dt[t]) * vec[kXu + t];
    dcum[e] = static_cast<double>(vec[kRowt + t]) + vec[kInter + t] - dxu;
    side += dxu - colt;
    sdyx += vec[kDyx + t];
  }
  side = warp_sum(side);
  if (lane == 31) dcum[1] += exp(tot) * gsum + side;  // ⟨G, the state leaving the chunk⟩
  double v = dcum[0] + dcum[1];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double up = __shfl_down_sync(0xffffffffu, v, off);
    if (lane + off < 32) v += up;
  }
  double after = __shfl_down_sync(0xffffffffu, v, 1);
  if (lane == 31) after = 0.0;
  const double da[2] = {after + dcum[1] + dcum[0], after + dcum[1]};
  const float Ah = a.A[h];
  double sda = 0.0;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int t = 2 * lane + e;
    if (t < valid)
      a.ddt[((long long)b * a.S + t0 + t) * a.H + h] =
          static_cast<float>(vec[kXu + t] + Ah * da[e]);
    sda += d->dt[t] * da[e];
  }
  sda = warp_sum(sda);
  sdyx = warp_sum(sdyx);
  if (lane == 0) {
    const long long i = ((long long)b * a.nc + c) * a.H + h;
    a.ad[i] = static_cast<float>(sda);
    a.ad[(long long)a.B * a.nc * a.H + i] = static_cast<float>(sdyx);
  }
}

// The gradient pass's block: the two warpgroups, 256 threads, so that
// each thread may hold up to 255 registers (a copy warp beside them would
// cap a 288-thread block, allocated as 12 warps, at 168: it spilled and
// serialised the wgmma).  Warp 4, the first of warpgroup 1 (which computes
// no gates), issues the loads (one thread the TMA and bulk copies; its
// lanes dt by cp.async, counted by the full barrier) and takes each head's
// tail once all eight warps have released the head.
constexpr int kGradThreads = kConsumers;
constexpr int kIssuerWarp = 4;

__device__ __forceinline__ void grads_issue(const Args& a, const CUtensorMap* tx,
                                            const CUtensorMap* tdy, uint8_t* stage,
                                            uint64_t* full, int b, int h, int c, int t0,
                                            int valid) {
  using S = Smem<true>;
  const int lane = threadIdx.x % 32;
  if (lane == 0) {
    mbar_expect_tx(full, 2 * kTile + 2 * kSlot);
    tma_load(stage + S::kX, tx, a.xd, full, 0, h, t0, b);
    tma_load(stage + S::kDy, tdy, a.dyd, full, 0, h, t0, b);
    bulk_load(stage + S::kG, slot(a, 1, b, h, c), kSlot, full);
    bulk_load(stage + S::kH, slot(a, 0, b, h, c), kSlot, full);
  }
  float* dts = reinterpret_cast<float*>(stage + S::kDt);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int t = 2 * lane + e;
    cp_async4(dts + t, dt_row(a, b, h, t0 + (t < valid ? t : 0)), t < valid);
  }
  cp_async_arrive(full);
}

__global__ void __launch_bounds__(kGradThreads, 1)
    ssd_bwd_grads_sm90_kernel(const __grid_constant__ CUtensorMap tx,
                              const __grid_constant__ CUtensorMap tdy,
                              const __grid_constant__ CUtensorMap tb,
                              const __grid_constant__ CUtensorMap tc, const Args a) {
  using S = Smem<true>;
  uint8_t* base = aligned_base();
  uint64_t* full = reinterpret_cast<uint64_t*>(base + S::kBars);
  uint64_t* empty = full + 2;
  uint64_t* cbar = full + 4;
  uint8_t* planes = base + S::kS1;
  const int c = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;
  const int t0 = c * kQ, valid = min(kQ, a.S - t0);
  const int hg0 = grp * a.group, heads = min(a.group, a.H - hg0);
  const int wg = threadIdx.x / 128, w = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int q = lane % 4, r0 = 16 * w + lane / 4;
  const bool issuer = threadIdx.x / 32 == kIssuerWarp;
  const auto vecs = [&](int j) {
    return reinterpret_cast<float*>(base + S::kVec) + (j & 1) * kVecFloats;
  };
  const auto stage_of = [&](int j) { return base + S::kRing + (j & 1) * S::kStage; };
  const auto decay_of = [&](int j, int g) {
    return reinterpret_cast<Decay*>(stage_of(j) + S::kDecay) + g;
  };
  const auto issue = [&](int j) {
    grads_issue(a, &tx, &tdy, stage_of(j), &full[j & 1], b, hg0 + j, c, t0, valid);
  };
  if (threadIdx.x == 0) {
    for (int st = 0; st < 2; ++st) {
      mbar_init(&full[st], 33);
      mbar_init(&empty[st], kConsumers / 32);
    }
    mbar_init(cbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (issuer) {
    if (lane == 0) load_bc(base, &tb, &tc, cbar, t0, b);
    for (int j = 0; j < min(2, heads); ++j) issue(j);
  }
  // The issuing warp, once every warp has released head j: its tail, then
  // head j + 2 into its stage.
  const auto retire = [&](int j) {
    mbar_wait(&empty[j & 1], (j >> 1) & 1);
    grads_tail(a, decay_of(j, 1), vecs(j), b, hg0 + j, c, t0, valid);
    __syncwarp();
    if (j + 2 < heads) issue(j + 2);
  };
  // Each head's start, per warpgroup: its copy of the decay from the dt
  // that landed with the head.
  const auto decay = [&](int j) {
    mbar_wait(&full[j & 1], (j >> 1) & 1);
    if (w == 0) {
      const float* dts = reinterpret_cast<const float*>(stage_of(j) + S::kDt);
      const float dv[2] = {dts[2 * lane], dts[2 * lane + 1]};
      scan_decay(dv, a.A[hg0 + j], decay_of(j, wg));
    }
    bar_sync(kBarDecay + wg, 128);
    return static_cast<const Decay*>(decay_of(j, wg));
  };
  // Each head's end, per consumer: its share of ⟨G, H⟩ (the planes of G
  // and H share one layout, so equal offsets hold the same (p, n)), then
  // its warp's release of the head.
  const auto head_done = [&](int j) {
    const uint8_t* stage = stage_of(j);
    const int ct = threadIdx.x;
    float gh = 0.f;
#pragma unroll
    for (int r = 0; r < kPlane / 16 / kConsumers; ++r) {
      const int o = 16 * (ct + kConsumers * r);
      const uint4 ghi = *reinterpret_cast<const uint4*>(stage + S::kG + o);
      const uint4 glo = *reinterpret_cast<const uint4*>(stage + S::kG + kPlane + o);
      const uint4 hhi = *reinterpret_cast<const uint4*>(stage + S::kH + o);
      const uint4 hlo = *reinterpret_cast<const uint4*>(stage + S::kH + kPlane + o);
      gh = dot2(ghi.x, glo.x, hhi.x, hlo.x, gh);
      gh = dot2(ghi.y, glo.y, hhi.y, hlo.y, gh);
      gh = dot2(ghi.z, glo.z, hhi.z, hlo.z, gh);
      gh = dot2(ghi.w, glo.w, hhi.w, hlo.w, gh);
    }
    vecs(j)[kRed + ct] = gh;
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[j & 1]);
  };
  mbar_wait(cbar, 0);
  float dsum[2][32];  // dC (warpgroup 0) or dB (1) over the group's heads so far
  zero(dsum[0]);
  zero(dsum[1]);
  // The two warpgroups' loops apart, so that neither holds the other's
  // registers.
  if (wg == 0) {
    // C·Bᵀ [t][s], once per block.
    float cb[32];
    zero(cb);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kNP / 16; ++kk)
      wgmma_ss64<0, 0>(cb, kdesc(base + S::kC, 16 * kk), kdesc(base + S::kB, 16 * kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_all(cb);
    for (int j = 0; j < heads; ++j) {
      const Decay* d = decay(j);
      grads_wg0(base, stage_of(j), d, planes, cb, dsum, vecs(j), w, lane, j == 0);
      head_done(j);
    }
  } else {
    for (int j = 0; j < heads; ++j) {
      const Decay* d = decay(j);
      grads_wg1_xg(stage_of(j), d, dsum, w, lane);
      if (issuer && j > 0) retire(j - 1);
      grads_wg1(a, base, stage_of(j), d, planes, dsum, vecs(j), w, lane, j + 1 == heads, b,
                hg0 + j, t0, valid);
      head_done(j);
    }
    if (issuer) retire(heads - 1);
  }

  // The group's dC (warpgroup 0) or dB (1): in bf16 where one group covers
  // every head, else in float32 into the group's scratch.
  const int which = wg == 0 ? 1 : 0;
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int t = r0 + 8 * ((j >> 1) & 1), n = 64 * half + 8 * (j >> 2) + 2 * q + (j & 1);
      if (t >= valid || n >= a.N) continue;
      const long long e = ((long long)b * a.S + t0 + t) * a.N + n;
      if (a.groups == 1) {
        (which == 0 ? a.dBm : a.dCm)[e] = __float2bfloat16(dsum[half][j]);
      } else {
        a.gsum[((long long)grp * 2 + which) * a.B * a.S * a.N + e] = dsum[half][j];
      }
    }
}

// Pass 4: dB and dC as the sums of the groups' scratch in group order (one
// thread per (batch row, position, n); only where there are several
// groups); the last block takes dA and dD over (batch row, chunk), a warp
// per head.
__global__ void __launch_bounds__(kReduceThreads) ssd_bwd_reduce_sm90_kernel(const Args a) {
  if (blockIdx.x == gridDim.x - 1) {  // a warp per head, lanes over (batch row, chunk)
    const long long stride = (long long)a.B * a.nc * a.H;
    const int lane = threadIdx.x % 32;
    for (int h = threadIdx.x / 32; h < a.H; h += kReduceThreads / 32) {
      double sa = 0.0, sd = 0.0;
      for (long long i = h + (long long)lane * a.H; i < stride; i += 32LL * a.H) {
        sa += a.ad[i];
        sd += a.ad[stride + i];
      }
      sa = warp_sum(sa);
      sd = warp_sum(sd);
      if (lane == 0) {
        a.dA[h] = static_cast<float>(sa);
        a.dD[h] = static_cast<float>(sd);
      }
    }
    return;
  }
  const long long e = (long long)blockIdx.x * kReduceThreads + threadIdx.x;
  const long long bsn = (long long)a.B * a.S * a.N;
  if (e >= bsn) return;
  float sb = 0.f, sc = 0.f;
  for (int grp = 0; grp < a.groups; ++grp) {
    sb += a.gsum[(2LL * grp) * bsn + e];
    sc += a.gsum[(2LL * grp + 1) * bsn + e];
  }
  a.dBm[e] = __float2bfloat16(sb);
  a.dCm[e] = __float2bfloat16(sc);
}

// Tensor map of a (B, S, N) bf16 view with element strides sb, ss (N
// contiguous): boxes of 64 columns x 64 rows x 1, 128-byte swizzle.
bool make_bsn_map(CUtensorMap* map, const void* ptr, int B, int S, int N, long long sb,
                  long long ss) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  if (B == 1) sb = ss * S;  // a batch of one may carry any stride
  const cuuint64_t gdim[3] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t gstride[2] = {static_cast<cuuint64_t>(ss) * 2, static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[3] = {64, kQ, 1};
  const cuuint32_t estride[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), gdim, gstride,
                box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kErrNoEncode = -1;
constexpr int kErrTensorMap = -2;

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace
}  // namespace repro

// x, B, C, dy and dx, dB, dC bfloat16; dt, A, D, h0, dh_final, ddt, dA, dD,
// dh0 and the scratch float32; h0, dh_final and dh0 may be null (dh0 is
// written where it is not).  Strides are in elements; the last dimension
// of x, dt, B, C and dy is contiguous, and x, B, C and dy start 16-byte
// aligned with strides that are multiples of 8 elements; the outputs are
// contiguous.  Scratch, as ssd_scan.bwd_plan lays it out: states (2, B, H,
// ⌈S/64⌉) slots of 64·128 floats, a_tot (B, H, ⌈S/64⌉), ad (2, B, ⌈S/64⌉,
// H) and, where the groups of `group` heads are more than one, gsum
// (groups, 2, B, S, N).  `blocks` (the chunk-state and gradient passes'
// blocks) and `reduce_blocks` must be the plan's.  P is 16, 32 or 64 and N
// at most 128.  Four launches on `stream`; returns the CUDA error of the
// launches (0 on success), -1 if the driver's cuTensorMapEncodeTiled is
// not available, -2 if it refuses a tensor map.
extern "C" int repro_ssd_scan_bwd_sm90(
    const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
    const float* D, const float* h0, const void* dy, const float* dh_final, void* dx, float* ddt,
    float* dA, void* dBm, void* dCm, float* dD, float* dh0, float* states, float* a_tot,
    float* ad, float* gsum, int B, int S, int H, int P, int N, int group, int blocks,
    int reduce_blocks, long long x_sb, long long x_ss, long long x_sh, long long dt_sb,
    long long dt_ss, long long b_sb, long long b_ss, long long c_sb, long long c_ss,
    long long dy_sb, long long dy_ss, long long dy_sh, void* stream) {
  using namespace repro;
  if (S < 1 || B < 1 || H < 1 || N < 1 || N > kNP || (P != 16 && P != 32 && P != 64) ||
      group < 1 || group > H)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = (S + kQ - 1) / kQ, groups = (H + group - 1) / group;
  const long long bsn = static_cast<long long>(B) * S * N;
  const long long want_reduce = groups > 1 ? (bsn + kReduceThreads - 1) / kReduceThreads + 1 : 1;
  const long long batch = B > 1 ? (x_sb | b_sb | c_sb | dy_sb) : 0;
  if (static_cast<long long>(nc) * groups * B != blocks || reduce_blocks != want_reduce ||
      (groups > 1) != (gsum != nullptr) || !aligned16(x) || !aligned16(Bm) || !aligned16(Cm) ||
      !aligned16(dy) || (batch | x_ss | x_sh | b_ss | c_ss | dy_ss | dy_sh) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (encode_tiled() == nullptr) return kErrNoEncode;
  Args a;
  a.x = static_cast<const bf16*>(x);
  a.dt = dt;
  a.A = A;
  a.D = D;
  a.h0 = h0;
  a.dh_final = dh_final;
  a.dx = static_cast<bf16*>(dx);
  a.ddt = ddt;
  a.dA = dA;
  a.dBm = static_cast<bf16*>(dBm);
  a.dCm = static_cast<bf16*>(dCm);
  a.dD = dD;
  a.dh0 = dh0;
  a.states = reinterpret_cast<uint8_t*>(states);
  a.a_tot = a_tot;
  a.ad = ad;
  a.gsum = gsum;
  a.B = B;
  a.S = S;
  a.H = H;
  a.P = P;
  a.N = N;
  a.nc = nc;
  a.group = group;
  a.groups = groups;
  a.dt_sb = dt_sb;
  a.dt_ss = dt_ss;
  CUtensorMap tx, tdy, tb, tc;
  if (!make_bshd_map(&tx, x, B, S, H, P, x_sb, x_ss, x_sh, 64, kQ, a.xd) ||
      !make_bshd_map(&tdy, dy, B, S, H, P, dy_sb, dy_ss, dy_sh, 64, kQ, a.dyd) ||
      !make_bsn_map(&tb, Bm, B, S, N, b_sb, b_ss) || !make_bsn_map(&tc, Cm, B, S, N, c_sb, c_ss))
    return kErrTensorMap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_states_sm90_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Smem<false>::kAlloc);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ssd_bwd_grads_sm90_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<true>::kAlloc);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nc, groups, B);
  ssd_bwd_states_sm90_kernel<<<grid, kThreads, Smem<false>::kAlloc, st>>>(tx, tdy, tb, tc, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_passing_sm90_kernel<<<dim3(kPP * kNP / 8 / kWalkThreads, H, B), kWalkThreads, 0, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_grads_sm90_kernel<<<grid, kGradThreads, Smem<true>::kAlloc, st>>>(tx, tdy, tb, tc, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_reduce_sm90_kernel<<<static_cast<unsigned>(reduce_blocks), kReduceThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
