// Mamba-2 SSD chunked scan for Hopper (sm_90a), bfloat16 x, B and C: one
// launch, the state kept on chip, the products on the tensor cores.
//
// Replaces: src/repro/kernels/ssd/ssd_scan.py::ssd (Pallas body `_kernel`),
// which walks the chunks of one (batch, head) in order along a sequential
// grid axis with the (P, N) state in VMEM scratch.  It computes what
// ref.ssd_chunked computes; float32 inputs take the FMA kernel of
// ssd_scan.cu instead.
//
// What bounds it on an H100: bytes, up to S ≈ 8192 at mamba2-370m's widths
// (H 32, P 64, N 128).  The call must read x (bf16), dt (f32), B and C
// (bf16, shared by all heads) and write y (bf16) and the final state (f32):
// ~8.3 KB per token plus 1 MB of state, so 1.7 µs at S = 512 and 22 µs at
// S = 8192 over 3.35 TB/s.  The products are 2·Q·(Q·P + 2·N·P) flops per
// (head, chunk) plus 2·Q·Q·N per chunk for C·Bᵀ: 13 µs of bf16 tensor-core
// time at S = 8192.
//
// What the design does about it:
//   * One launch, no scratch in device memory.  Block (P-tile, head, batch
//     row) owns 16 of the head's P columns: y[:, p] needs only x[:, p] and
//     the state's row h[p, :], so the rows of the state are independent and
//     a head splits into P/16 blocks (128 at mamba width and B = 1, where
//     (b, h) blocks would fill 32 of 132 SMs).  Each block walks its chunks
//     in order with its (16, N) slice of the state in float32 registers,
//     as the TPU kernel keeps the state in VMEM.
//   * The products run on the tensor cores over the kernel's own chunk of
//     Q = 64 tokens (the function does not depend on it).  x, B and C go in
//     as they are.  The three float32 operands are split into bf16 parts,
//     each part one product into the same f32 sum: the gated scores W into
//     hi + mid + lo (24 bits), x∘w and the state h into hi + lo (16 bits).
//     Rounded once to bf16 they miss the tolerance at mamba width (y by
//     more than the atol of 0.05 beyond one bf16 step); with W in two
//     parts y, before its rounding to bf16, is further from a float64
//     scan than the float32 plain version is, which flips elements of
//     |y| > 8 by a whole bf16 step (0.0625) at the kernel test cases;
//     three parts bring it to the plain version's own error
//     (tests/test_torch_ssd.py emulates all three).  The three split
//     products (W·x, C·hᵀ, (x∘w)ᵀ·B) do 2.2× their unsplit tensor-core
//     work.
//   * Three roles, so that the state-free work of later chunks overlaps the
//     state chain of this one, through a 3-stage ring in shared memory
//     (mbarriers FULL (B/C landed), READY (x, dt, scan) and EMPTY (released)
//     per stage; a named barrier per stage from producers to consumers):
//       copy warp (warp 12): TMA loads of a chunk's B and C tiles (128-, 64-
//       or 32-byte swizzle, tensor maps over the caller's strides, zeros
//       past S and N), `cp.async` of its x tile and dt, then the chunk's
//       a_cum scan (in double) and decays; it runs up to two chunks ahead.
//       producers (warps 4-11, two warpgroups): G = C·Bᵀ as one `wgmma`
//       m64n64k16 chain per warpgroup, both operands K-major from the TMA
//       tiles; W = G ∘ exp(a_cum_t − a_cum_s) ∘ dt_s in place in the
//       accumulator; then y_in = W·x with `mma.sync`, its A fragments taken
//       straight from W's accumulator layout in three parts (as flash takes
//       P from S), so W never goes to shared memory; each group leaves its
//       share of y_in there in float32.  Group 1 also makes x∘w (w_s =
//       exp(a_tot − a_cum_s)·dt_s) in two parts.  C's 8-row blocks are
//       stored permuted (c_row) so that every warp's 16 accumulator rows
//       pair a short row block with a long one: each warp gates 9 of the
//       triangle's 36 8x8 blocks, half per group.
//       consumers (warps 0-3, `mma.sync` m16n8k16): y_out = C·h_prevᵀ, y =
//       y_in + exp(a_cum_t)·y_out + D·x into a shared-memory tile that one
//       TMA store writes out (dropping rows past S), then h = exp(a_tot)·h +
//       (x∘w)ᵀ·B on their 16-column pairs of the state, whose hi/lo copy
//       (double-buffered) the next chunk's C·hᵀ reads.  Consumer warp w
//       takes the 16-row tiles {0, 3} or {1, 2} of y and one of the two
//       8-column halves of the P-tile.
//     The other tiles are [row][16-byte chunk] with the chunk index
//     XOR-swizzled by row, so `ldmatrix` (and `.trans` for x, x∘w and B,
//     which enter K-major) hits distinct banks.  x, B and C need 16-byte
//     aligned rows (the wrapper checks).
//
// Kept from ssd_scan.cu: the within-chunk cumsum a_cum in double, and the
// gate's differences a_cum_t − a_cum_s rounded about once before the exp
// (here from float hi + lo pairs of a_cum·log2(e), so the gate's inner loop
// has no float64); the upper triangle selected away before the exp; a
// ragged last chunk read as dt = 0 and x = B = C = 0 past S (it adds
// nothing to the state) with its rows past S not written; h0 as the state's
// initial value.  N is padded in shared memory to a power of two >= 16
// (zeros).
#include <cuda.h>

#include "../../attention/csrc/common.cuh"

namespace repro {
namespace {

constexpr int kQ = 64;            // internal chunk length
constexpr int kPT = 16;           // P columns per block
constexpr int kConsumers = 128;   // warps 0-3
constexpr int kProducers = 256;   // warps 4-11
constexpr int kCopyWarp = 12;     // the loads and the a_cum scan
constexpr int kThreads = kConsumers + kProducers + 32;
constexpr int kStages = 3;
constexpr int kMTiles = kQ / 16;  // 16-row tiles of a chunk
// Named barriers: FULL per stage (producers arrive, consumers wait), and
// the consumers' own.
constexpr int kBarFull = 1;
constexpr int kBarConsumers = kBarFull + kStages;

struct Sm90Args {
  const __nv_bfloat16* x;   // (B, S, H, P), last dim contiguous
  const float* dt;          // (B, S, H), last dim contiguous
  const float* A;           // (H,)
  const __nv_bfloat16* Bm;  // (B, S, N), last dim contiguous: through a tensor map
  const __nv_bfloat16* Cm;  // (B, S, N), last dim contiguous: through a tensor map
  const float* D;           // (H,)
  const float* h0;          // (B, H, P, N) or null
  __nv_bfloat16* y;         // (B, S, H, P) contiguous
  float* h_final;           // (B, H, P, N) contiguous
  int S, H, P, N, nc;
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss;
};

// Shared memory, in bytes, for N padded to NP.  A stage holds one chunk:
// its C, B, x and dt tiles and what is made of them (the producer groups'
// shares of W·x, x∘w in two parts, a_cum·log2(e), exp(a_cum_t), w_s,
// exp(a_tot)); then come the state's hi/lo copy and the y tile the TMA
// stores (both double-buffered), and the stages' mbarriers.  C and B start
// 1024-byte aligned, as TMA's swizzle wants.
template <int NP>
struct Smem {
  static constexpr int kC = 0;                        // bf16 [kQ][NP], TMA layout
  static constexpr int kB = kC + kQ * NP * 2;         // bf16 [kQ][NP], TMA layout
  static constexpr int kX = kB + kQ * NP * 2;         // bf16 [kQ][kPT]
  static constexpr int kYp = kX + kQ * kPT * 2;       // float [2 groups][kQ][kPT]: W·x
  static constexpr int kXw = kYp + 2 * kQ * kPT * 4;  // bf16 [2][kQ][kPT]
  static constexpr int kAcum = kXw + 2 * kQ * kPT * 2;  // float2 [kQ]: a_cum·log2(e)
  static constexpr int kDt = kAcum + kQ * 8;          // float [kQ]
  static constexpr int kDecIn = kDt + kQ * 4;         // float [kQ]: exp(a_cum_t)
  static constexpr int kWdec = kDecIn + kQ * 4;       // float [kQ]: exp(a_tot − a_cum_s)·dt_s
  static constexpr int kDecay = kWdec + kQ * 4;       // float [4]: exp(a_tot)
  static constexpr int kStage = (kDecay + 16 + 1023) / 1024 * 1024;
  static constexpr int kH = kStages * kStage;         // bf16 [2 buffers][hi, lo][kPT][NP]
  static constexpr int kHBuf = 2 * kPT * NP * 2;
  static constexpr int kY = kH + 2 * kHBuf;           // bf16 [2 buffers][kQ][kPT]: y, for TMA
  static constexpr int kBars = kY + 2 * kQ * kPT * 2;  // uint64 full, ready, empty [kStages]
  static constexpr int kBytes = kBars + 3 * kStages * 8;
  static constexpr int kAlloc = kBytes + 1024;        // room to align the base
  static_assert(kH % 16 == 0 && kBars % 8 == 0, "tiles start 16-byte aligned");
};

// Element offset of the 16-byte chunk c of row r in a tile of CG chunks per
// row (CG a power of two): the chunk index is XORed with a function of the
// row such that any 8 consecutive rows' chunk c fall in 8 distinct bank
// groups, which is what `ldmatrix` reads at once.
template <int CG>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int kShift = CG >= 8 ? 0 : (CG == 4 ? 1 : 2);
  constexpr int kMask = (CG < 8 ? CG : 8) - 1;
  return r * CG * 8 + ((c ^ ((r >> kShift) & kMask)) << 3);
}

// Element offset of column chunk c of row r in a C or B tile, as TMA writes
// it with the 128-, 64- or 32-byte swizzle: rows of min(NP, 64) columns,
// in NP / 64 blocks of kQ rows when NP = 128.
template <int NP>
__device__ __forceinline__ int bc_off(int r, int c) {
  if constexpr (NP >= 64) return (c >> 3) * (kQ * 64) + swz<8>(r, c & 7);
  else return swz<NP / 8>(r, c);
}

// The shared-memory row of C's row t.  C's 8-row blocks are stored
// permuted, block β at row 16β for β < 4 and at 16(7 − β) + 8 for β >= 4,
// so that the 16-row tile w holds the blocks w and 7 − w: the warp holding
// that tile of G = C·Bᵀ then gates (w + 1) + (8 − w) = 9 blocks of the
// triangle, whatever its w.
__device__ __forceinline__ int c_row(int t) {
  const int beta = t >> 3;
  return (beta < 4 ? 16 * beta : 16 * (7 - beta) + 8) + (t & 7);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
// A 3-D TMA box (col, row, batch) into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int col, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row), "r"(batch)
      : "memory");
}
// A 4-D TMA store of a box from shared memory, in the bulk group of this
// thread; the shared-memory writes it reads must be fenced for the async
// proxy first.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      "cp.async.bulk.commit_group;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
template <int N>
__device__ __forceinline__ void tma_store_wait_read() {  // all but the N newest bulk groups
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// 2^x on the SFU, subnormal results flushed to zero.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t* r, const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(row)));
}
// The split of a float pair into `Parts` bf16 pairs, each the bf16 rounding
// of what the earlier parts leave.
template <int Parts>
__device__ __forceinline__ void split(float v0, float v1, uint32_t* out) {
#pragma unroll
  for (int i = 0; i < Parts; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
    out[i] = *reinterpret_cast<const uint32_t*>(&h);
    const float2 hf = __bfloat1622float2(h);
    v0 -= hf.x;
    v1 -= hf.y;
  }
}

__device__ __forceinline__ void chunk_decay(const float* sdt, float Ah, float2* acum2,
                                            float* dec_in, float* wdec, float* decay);

// The copy warp: chunk c's B and C tiles by TMA (zeros past S and N; C's
// row blocks permuted, see c_row), x (kQ x kPT, this block's columns) and
// dt (kQ) by `cp.async` (zeros past S).
template <int NP>
__device__ __forceinline__ void load_chunk(const Sm90Args& a, const CUtensorMap* tb,
                                           const CUtensorMap* tc, uint8_t* stage,
                                           uint64_t* full, int b, int h, int p0, int c) {
  using S = Smem<NP>;
  constexpr int kBoxCols = NP < 64 ? NP : 64;
  const int lane = threadIdx.x % 32;
  const int t0 = c * kQ;
  if (lane == 0) {
    mbar_expect_tx(full, 2 * kQ * NP * 2);
#pragma unroll
    for (int blk = 0; blk < NP / kBoxCols; ++blk) {
      const int off = blk * kQ * kBoxCols * 2;
      tma_load_3d(stage + S::kB + off, tb, full, blk * kBoxCols, t0, b);
#pragma unroll
      for (int beta = 0; beta < kQ / 8; ++beta)
        tma_load_3d(stage + S::kC + off + c_row(8 * beta) * kBoxCols * 2, tc, full,
                    blk * kBoxCols, t0 + 8 * beta, b);
    }
  }
  const int valid = min(kQ, a.S - t0);
  __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(stage + S::kX);
  const __nv_bfloat16* xm = a.x + b * a.x_sb + (long long)t0 * a.x_ss + h * a.x_sh + p0;
#pragma unroll
  for (int j = 0; j < 2 * kQ / 32; ++j) {  // kQ x 2 chunks of 16 bytes
    const int i = lane + 32 * j, r = i / 2, k = i % 2;
    const bool ok = r < valid;
    cp_async16(sx + swz<2>(r, k), xm + (ok ? r : 0) * a.x_ss + 8 * k, ok);
  }
  float* sdt = reinterpret_cast<float*>(stage + S::kDt);
#pragma unroll
  for (int e = 0; e < 2; ++e) {  // the rows this lane scans
    const int r = 2 * lane + e;
    const bool ok = r < valid;
    cp_async4(sdt + r, a.dt + b * a.dt_sb + (long long)(t0 + (ok ? r : 0)) * a.dt_ss + h, ok);
  }
}

// The copy warp, running up to kStages − 1 chunks ahead of the producers:
// each chunk's loads once the consumers have released its stage, then the
// a_cum scan of the chunk before it, whose dt it copied itself.
template <int NP>
__device__ __forceinline__ void copier(const Sm90Args& a, const CUtensorMap* tb,
                                       const CUtensorMap* tc, uint8_t* smem, int b, int h,
                                       int p0) {
  using S = Smem<NP>;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::kBars);
  uint64_t* ready = full + kStages;
  uint64_t* empty = ready + kStages;
  const float Ah = a.A[h];
  load_chunk<NP>(a, tb, tc, smem, full, b, h, p0, 0);
  cp_async_commit();
  for (int c = 0; c < a.nc; ++c) {
    if (c + 1 < a.nc) {
      const int next = (c + 1) % kStages;
      if (c + 1 >= kStages) mbar_wait(&empty[next], ((c + 1) / kStages - 1) & 1);
      load_chunk<NP>(a, tb, tc, smem + next * S::kStage, &full[next], b, h, p0, c + 1);
    }
    cp_async_commit();
    cp_async_wait<1>();  // chunk c's x and dt
    __syncwarp();
    uint8_t* stage = smem + (c % kStages) * S::kStage;
    chunk_decay(reinterpret_cast<const float*>(stage + S::kDt), Ah,
                reinterpret_cast<float2*>(stage + S::kAcum),
                reinterpret_cast<float*>(stage + S::kDecIn),
                reinterpret_cast<float*>(stage + S::kWdec),
                reinterpret_cast<float*>(stage + S::kDecay));
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(&ready[c % kStages]);
  }
}

// The copy warp: a_cum (the inclusive cumsum of the float32 products
// A·dt, in double) and what the chunk needs of it: a_cum·log2(e) as a float
// hi + lo pair (a difference of two pairs, hi − hi + (lo − lo), is the
// double difference rounded about once, with no float64 in the gate's inner
// loop), exp(a_cum_t), exp(a_tot − a_cum_s)·dt_s and exp(a_tot).
__device__ __forceinline__ void chunk_decay(const float* sdt, float Ah, float2* acum2,
                                            float* dec_in, float* wdec, float* decay) {
  constexpr double kLog2e = 1.4426950408889634;
  const int lane = threadIdx.x % 32;
  const float d0 = sdt[2 * lane], d1 = sdt[2 * lane + 1];
  const double v0 = static_cast<double>(Ah * d0);
  const double v1 = v0 + static_cast<double>(Ah * d1);
  double tot = v1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double up = __shfl_up_sync(0xffffffffu, tot, off);
    if (lane >= off) tot += up;
  }
  double excl = __shfl_up_sync(0xffffffffu, tot, 1);
  if (lane == 0) excl = 0.0;
  const double a_tot = __shfl_sync(0xffffffffu, tot, 31);
  const double a[2] = {excl + v0, excl + v1};
  const float d[2] = {d0, d1};
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const double l2 = a[e] * kLog2e;
    const float hi = static_cast<float>(l2);
    acum2[2 * lane + e] = make_float2(hi, static_cast<float>(l2 - hi));
    dec_in[2 * lane + e] = expf(static_cast<float>(a[e]));
    wdec[2 * lane + e] = expf(static_cast<float>(a_tot - a[e])) * d[e];
  }
  if (lane == 0) decay[0] = expf(static_cast<float>(a_tot));
}

template <int NP>
__device__ __forceinline__ void producer(const Sm90Args& a, uint8_t* smem) {
  using S = Smem<NP>;
  constexpr int kBoxCols = NP < 64 ? NP : 64;
  constexpr int kRowBytes = kBoxCols * 2;  // the swizzle's width
  constexpr uint32_t kLayout = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  const int tid = threadIdx.x - kConsumers;
  const int pw = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  // Each warpgroup computes all of G = C·Bᵀ (64 x 64); warp w of either
  // holds the rows t_a = 8w + g and t_b = 8(7 − w) + g (c_row), whose
  // (w + 1) + (8 − w) valid 8-column blocks are items 0..8: group 0 gates
  // items 0-4, group 1 items 5-8.
  const int grp = pw / 4, w = pw % 4;
  const int item_lo = grp ? 5 : 0, item_hi = grp ? 9 : 5;
  // Whether this thread gates block i of row t_a (rr = 0) or t_b (rr = 1).
  auto mine = [&](int rr, int i) {
    const int k = rr ? w + 1 + i : i;
    return (rr ? i <= 7 - w : i <= w) && k >= item_lo && k < item_hi;
  };
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::kBars);
  uint64_t* ready = full + kStages;

  for (int c = 0; c < a.nc; ++c) {
    uint8_t* stage = smem + (c % kStages) * S::kStage;
    mbar_wait(&full[c % kStages], (c / kStages) & 1);   // C and B
    mbar_wait(&ready[c % kStages], (c / kStages) & 1);  // x, dt, a_cum
    const float* sdt = reinterpret_cast<const float*>(stage + S::kDt);
    const float2* ac = reinterpret_cast<const float2*>(stage + S::kAcum);

    // G = C·Bᵀ on the tensor cores (wgmma, both operands K-major from the
    // TMA tiles).
    float d[32];
    {
      const uint64_t dc = make_desc(stage + S::kC, 16, 8 * kRowBytes, kLayout);
      const uint64_t db = make_desc(stage + S::kB, 16, 8 * kRowBytes, kLayout);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NP / 16; ++kk) {
        const int e = 16 * kk;
        const uint32_t off = (e / kBoxCols) * kQ * kRowBytes + (e % kBoxCols) * 2;
        wgmma_ss_n64(d, dc + (off >> 4), db + (off >> 4), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int j = 0; j < 32; ++j) fence_reg(d[j]);
    }

    // W = G ∘ exp(a_cum_t − a_cum_s) ∘ dt_s (s <= t) in place of G, on this
    // thread's blocks (zero elsewhere).
    const int ta = 8 * w + g, tb = 8 * (7 - w) + g;
    const float2 act[2] = {ac[ta], ac[tb]};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int s = 8 * i + 2 * tig + e;
        const bool any = mine(0, i) || mine(1, i);
        const float2 acs = any ? ac[s] : make_float2(0.f, 0.f);
        const float ds = any ? sdt[s] : 0.f;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float& v = d[4 * i + 2 * rr + e];
          const float seg = (act[rr].x - acs.x) + (act[rr].y - acs.y);
          v = mine(rr, i) && s <= (rr ? tb : ta) ? v * ex2(seg) * ds : 0.f;
        }
      }
    // This warpgroup's share of y_in = W·x for the rows t_a (fragment row g)
    // and t_b (row g + 8): the A fragments come straight from W's
    // accumulator layout, in three bf16 parts; x by `ldmatrix.trans`.
    float yp[2][4] = {};
    const __nv_bfloat16* sx = reinterpret_cast<const __nv_bfloat16*>(stage + S::kX);
#pragma unroll
    for (int j = 0; j < kMTiles; ++j) {
      if (!mine(0, 2 * j) && !mine(1, 2 * j) && !mine(0, 2 * j + 1) && !mine(1, 2 * j + 1))
        continue;
      uint32_t af[3][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {  // (t_a, 2j), (t_b, 2j), (t_a, 2j+1), (t_b, 2j+1)
        const float* v = &d[4 * (2 * j + r / 2) + 2 * (r % 2)];
        uint32_t parts[3];
        split<3>(v[0], v[1], parts);
#pragma unroll
        for (int q = 0; q < 3; ++q) af[q][r] = parts[q];
      }
      uint32_t xf[4];
      ldmatrix_x4_trans(xf, sx + swz<2>(16 * j + (lane & 7) + 8 * ((lane >> 3) & 1), lane >> 4));
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        mma_bf16(yp[0], af[q], xf[0], xf[1]);
        mma_bf16(yp[1], af[q], xf[2], xf[3]);
      }
    }
    float* ypart = reinterpret_cast<float*>(stage + S::kYp) + grp * kQ * kPT;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        *reinterpret_cast<float2*>(ypart + (rr ? tb : ta) * kPT + 8 * nt + 2 * tig) =
            make_float2(yp[nt][2 * rr], yp[nt][2 * rr + 1]);
    // x∘w in two parts, [s][p]: one 16-byte chunk per thread of warps 4-7.
    if (grp == 1) {
      __nv_bfloat16* sxw = reinterpret_cast<__nv_bfloat16*>(stage + S::kXw);
      const int r = (tid - 128) / 2, k = tid % 2;
      const int o = swz<2>(r, k);
      float xv[8];
      Vec<__nv_bfloat16>::load(sx + o, xv);
      const float wr = reinterpret_cast<const float*>(stage + S::kWdec)[r];
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t parts[2];
        split<2>(xv[2 * e] * wr, xv[2 * e + 1] * wr, parts);
        hi[e] = parts[0];
        lo[e] = parts[1];
      }
      *reinterpret_cast<uint4*>(sxw + o) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(sxw + kQ * kPT + o) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    bar_arrive(kBarFull + c % kStages, kConsumers + kProducers);
  }
}

// The state's hi/lo copy in shared memory, [p][n], for C·hᵀ: each consumer
// warp writes its column pairs jp = warp + 4i from the accumulator.
template <int NP, int PW>
__device__ __forceinline__ void store_state(const float (&hacc)[PW][2][4], __nv_bfloat16* sh) {
  constexpr int CG = NP / 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
#pragma unroll
  for (int i = 0; i < PW; ++i) {
    const int jp = warp + 4 * i;
    if (jp >= NP / 16) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int o = swz<CG>(g + 8 * rr, 2 * jp + half) + 2 * tig;
        uint32_t parts[2];
        split<2>(hacc[i][half][2 * rr], hacc[i][half][2 * rr + 1], parts);
        *reinterpret_cast<uint32_t*>(sh + o) = parts[0];
        *reinterpret_cast<uint32_t*>(sh + kPT * NP + o) = parts[1];
      }
  }
}

// Consumers: warp w writes y's 16-row tiles M0 and M1 at the P-tile's
// columns 8(w % 2)..8(w % 2) + 7, and updates the state's column pairs
// jp ≡ w (mod 4).
template <int NP, int M0, int M1>
__device__ __forceinline__ void consumer(const Sm90Args& a, const CUtensorMap* ty, uint8_t* smem,
                                         int b, int h, int p0) {
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Smem<NP>::kBars);
  uint64_t* ready = full + kStages;
  uint64_t* empty = ready + kStages;
  using S = Smem<NP>;
  constexpr int CG = NP / 8;
  constexpr int KN = NP / 16;
  constexpr int kPairs = NP / 16;  // 16-column pairs of the state
  constexpr int kPairsW = (kPairs + 3) / 4;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  const int nt = warp % 2;  // which 8 of the P-tile's 16 columns
  const float Dh = a.D[h];
  const long long bh = (long long)b * a.H + h;
  __nv_bfloat16* shbuf = reinterpret_cast<__nv_bfloat16*>(smem + S::kH);

  // The state's rows p0 + {g, g + 8}, columns 16jp + 8half + 2tig + {0, 1}.
  float hacc[kPairsW][2][4];
#pragma unroll
  for (int i = 0; i < kPairsW; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int jp = warp + 4 * i;
        const int n = 16 * jp + 8 * half + 2 * tig + (q & 1);
        const int p = p0 + g + 8 * (q >> 1);
        hacc[i][half][q] = (a.h0 != nullptr && jp < kPairs && n < a.N)
                               ? a.h0[(bh * a.P + p) * a.N + n] : 0.f;
      }
  store_state<NP>(hacc, shbuf);

  for (int c = 0; c < a.nc; ++c) {
    const uint8_t* stage = smem + (c % kStages) * S::kStage;
    bar_sync(kBarFull + c % kStages, kConsumers + kProducers);  // chunk c's y_in and x∘w
    mbar_wait(&full[c % kStages], (c / kStages) & 1);   // and, seen here, its tiles
    mbar_wait(&ready[c % kStages], (c / kStages) & 1);
    const __nv_bfloat16* sc = reinterpret_cast<const __nv_bfloat16*>(stage + S::kC);
    const __nv_bfloat16* sb = reinterpret_cast<const __nv_bfloat16*>(stage + S::kB);
    const __nv_bfloat16* sx = reinterpret_cast<const __nv_bfloat16*>(stage + S::kX);
    const float* ypart = reinterpret_cast<const float*>(stage + S::kYp);
    const __nv_bfloat16* sxw = reinterpret_cast<const __nv_bfloat16*>(stage + S::kXw);
    const float* dec_in = reinterpret_cast<const float*>(stage + S::kDecIn);
    const __nv_bfloat16* sh = shbuf + (c % 2) * (S::kHBuf / 2);

    // y_out = C·hᵀ (hi and lo of h, summed apart for shorter chains), for
    // the tiles M0 and M1; y_in = W·x comes from the producers.
    float yhi[2][4], ylo[2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int q = 0; q < 4; ++q) yhi[u][q] = ylo[u][q] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KN; ++kk) {
      uint32_t hf[2], lf[2];
      const int o = swz<CG>(8 * nt + (lane & 7), 2 * kk + ((lane >> 3) & 1));
      ldmatrix_x2(hf, sh + o);
      ldmatrix_x2(lf, sh + kPT * NP + o);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int m = u ? M1 : M0;
        uint32_t cf[4];
        ldmatrix_x4(cf, sc + bc_off<NP>(c_row(16 * m + (lane & 7) + 8 * ((lane >> 3) & 1)),
                                        2 * kk + (lane >> 4)));
        mma_bf16(yhi[u], cf, hf[0], hf[1]);
        mma_bf16(ylo[u], cf, lf[0], lf[1]);
      }
    }
    // y = y_in + exp(a_cum_t)·y_out + D·x, rows past S not written; the
    // shared-memory operands are read before the first store.
    const int t0 = c * kQ;
    float di[2][2];
    float2 xv[2][2], yin[2][2];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int t = 16 * (u ? M1 : M0) + g + 8 * rr;
        di[u][rr] = dec_in[t];
        xv[u][rr] = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(sx + swz<2>(t, nt) + 2 * tig));
        const int o = t * kPT + 8 * nt + 2 * tig;
        const float2 y0 = *reinterpret_cast<const float2*>(ypart + o);
        const float2 y1 = *reinterpret_cast<const float2*>(ypart + kQ * kPT + o);
        yin[u][rr] = make_float2(y0.x + y1.x, y0.y + y1.y);
      }
    __nv_bfloat16* sy = reinterpret_cast<__nv_bfloat16*>(smem + S::kY) + (c % 2) * kQ * kPT;
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int t = 16 * (u ? M1 : M0) + g + 8 * rr;
        const int q = 2 * rr;
        const float y0 =
            yin[u][rr].x + di[u][rr] * (yhi[u][q] + ylo[u][q]) + Dh * xv[u][rr].x;
        const float y1 =
            yin[u][rr].y + di[u][rr] * (yhi[u][q + 1] + ylo[u][q + 1]) + Dh * xv[u][rr].y;
        *reinterpret_cast<uint32_t*>(sy + t * kPT + 8 * nt + 2 * tig) = pack_bf16(y0, y1);
      }
    // One TMA store of the chunk's (kQ, 16) tile of y; it drops the rows
    // past S.  The buffer is written again two chunks later, after the
    // next FULL barrier, which thread 0 reaches only once this store has
    // read it.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_sync(kBarConsumers, kConsumers);
    if (threadIdx.x == 0) {
      tma_store_4d(ty, sy, p0, h, t0, b);
      tma_store_wait_read<1>();
    }

    // h = exp(a_tot)·h + (x∘w)ᵀ·B on this warp's column pairs.
    const float decay = *reinterpret_cast<const float*>(stage + S::kDecay);
    uint32_t ahi[kMTiles][4], alo[kMTiles][4];
#pragma unroll
    for (int kk = 0; kk < kMTiles; ++kk) {
      const int o = swz<2>(16 * kk + (lane & 7) + 8 * (lane >> 4), (lane >> 3) & 1);
      ldmatrix_x4_trans(ahi[kk], sxw + o);
      ldmatrix_x4_trans(alo[kk], sxw + kQ * kPT + o);
    }
#pragma unroll
    for (int i = 0; i < kPairsW; ++i) {
      const int jp = warp + 4 * i;
      if (jp >= kPairs) continue;
      float chi[2][4], clo[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int q = 0; q < 4; ++q) chi[half][q] = clo[half][q] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kMTiles; ++kk) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, sb + bc_off<NP>(16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1),
                                              2 * jp + (lane >> 4)));
        mma_bf16(chi[0], ahi[kk], bf[0], bf[1]);
        mma_bf16(clo[0], alo[kk], bf[0], bf[1]);
        mma_bf16(chi[1], ahi[kk], bf[2], bf[3]);
        mma_bf16(clo[1], alo[kk], bf[2], bf[3]);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          hacc[i][half][q] = decay * hacc[i][half][q] + (chi[half][q] + clo[half][q]);
    }
    // The next chunk's C·hᵀ reads this copy after its FULL barrier, which
    // every consumer reaches only when done with this chunk's copy.
    if (c + 1 < a.nc) store_state<NP>(hacc, shbuf + ((c + 1) % 2) * (S::kHBuf / 2));
    // Release the stage, where a later chunk will refill it.
    if (c + kStages < a.nc) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[c % kStages]);
    }
  }

  float* hf = a.h_final + bh * a.P * a.N;
#pragma unroll
  for (int i = 0; i < kPairsW; ++i) {
    const int jp = warp + 4 * i;
    if (jp >= kPairs) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = 16 * jp + 8 * half + 2 * tig + (q & 1);
        if (n < a.N) hf[(long long)(p0 + g + 8 * (q >> 1)) * a.N + n] = hacc[i][half][q];
      }
  }
}

template <int NP>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_sm90_kernel(const __grid_constant__ CUtensorMap tb, const __grid_constant__ CUtensorMap tc,
                    const __grid_constant__ CUtensorMap ty, const Sm90Args a) {
  extern __shared__ uint8_t smem_raw[];
  // Offset from the array, not a cast through an integer: the compiler then
  // keeps knowing the pointer is shared memory (STS/LDS, not generic ST/LD).
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int p0 = blockIdx.x * kPT, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  if (threadIdx.x == 0) {
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + Smem<NP>::kBars);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&full[kStages + s], 1);                    // ready
      mbar_init(&full[2 * kStages + s], kConsumers / 32);  // empty: one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == kCopyWarp) copier<NP>(a, &tb, &tc, smem, b, h, p0);
  else if (warp >= 4) producer<NP>(a, smem);
  else if (warp < 2) consumer<NP, 0, 3>(a, &ty, smem, b, h, p0);
  else consumer<NP, 1, 2>(a, &ty, smem, b, h, p0);
  if (threadIdx.x == 0) tma_store_wait_read<0>();  // the last y tile is read before exit
}

// Tensor map of a (B, S, N) bf16 view with element strides sb, ss (N
// contiguous): boxes of box_cols x rows x 1, swizzled as bc_off reads them.
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int N, long long sb, long long ss,
              int box_cols, int rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  // A batch of one may carry any stride; give it one past the rows.
  if (B == 1) sb = ss * S;
  const cuuint64_t gdim[3] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t gstride[2] = {static_cast<cuuint64_t>(ss) * 2, static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t estride[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = box_cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                      : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), gdim, gstride,
                box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Tensor map of y, (B, S, H, P) bf16 contiguous: boxes of 16 columns of one
// head over kQ rows, unswizzled.
bool make_y_map(CUtensorMap* map, void* y, int B, int S, int H, int P) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t gdim[4] = {static_cast<cuuint64_t>(P), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(P) * 2;
  const cuuint64_t gstride[3] = {row, row * H, row * H * S};
  const cuuint32_t box[4] = {kPT, 1, kQ, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, y, gdim, gstride, box, estride,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Error codes besides CUDA's: the driver entry point or a tensor map.
constexpr int kErrNoEncode = -1;
constexpr int kErrTensorMap = -2;

template <int NP>
int launch(const Sm90Args& a, int B, long long b_sb, long long b_ss, long long c_sb,
           long long c_ss, dim3 grid, cudaStream_t stream) {
  constexpr int kBoxCols = NP < 64 ? NP : 64;
  if (encode_tiled() == nullptr) return kErrNoEncode;
  CUtensorMap tb, tc, ty;
  if (!make_map(&tb, a.Bm, B, a.S, a.N, b_sb, b_ss, kBoxCols, kQ) ||
      !make_map(&tc, a.Cm, B, a.S, a.N, c_sb, c_ss, kBoxCols, 8) ||
      !make_y_map(&ty, a.y, B, a.S, a.H, a.P))
    return kErrTensorMap;
  constexpr int bytes = Smem<NP>::kAlloc;
  cudaError_t err = cudaFuncSetAttribute(ssd_sm90_kernel<NP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_sm90_kernel<NP><<<grid, kThreads, bytes, stream>>>(tb, tc, ty, a);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace
}  // namespace repro

// x, B and C bfloat16; dt, A, D, h0 and h_final float32; h0 may be null.
// Strides are in elements; the last dimension of x, dt, B and C is
// contiguous, and x, B and C start 16-byte aligned with strides (batch
// strides too when B > 1) that are multiples of 8 elements.  y is
// contiguous (B, S, H, P), h_final (B, H, P, N).  The grid is the
// wrapper's plan, (P / 16, H, B), and must agree with the shapes.  Returns
// the CUDA error of the launch (0 on success), -1 if the driver's
// cuTensorMapEncodeTiled is not available, -2 if it refuses a tensor map.
extern "C" int repro_ssd_scan_sm90(
    const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
    const float* D, const float* h0, void* y, float* h_final, int B, int S, int H, int P,
    int N, int grid_x, int grid_y, int grid_z, long long x_sb, long long x_ss, long long x_sh,
    long long dt_sb, long long dt_ss, long long b_sb, long long b_ss, long long c_sb,
    long long c_ss, void* stream) {
  const long long batch = B > 1 ? (x_sb | b_sb | c_sb) : 0;
  if (S < 1 || N < 1 || N > 128 || P % repro::kPT != 0 || P > 4 * repro::kPT
      || grid_x * repro::kPT != P || grid_y != H || grid_z != B || !repro::aligned16(x)
      || !repro::aligned16(Bm) || !repro::aligned16(Cm)
      || (batch | x_ss | x_sh | b_ss | c_ss) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  repro::Sm90Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.dt = dt;
  a.A = A;
  a.Bm = static_cast<const __nv_bfloat16*>(Bm);
  a.Cm = static_cast<const __nv_bfloat16*>(Cm);
  a.D = D;
  a.h0 = h0;
  a.y = static_cast<__nv_bfloat16*>(y);
  a.h_final = h_final;
  a.S = S;
  a.H = H;
  a.P = P;
  a.N = N;
  a.nc = (S + repro::kQ - 1) / repro::kQ;
  a.x_sb = x_sb;
  a.x_ss = x_ss;
  a.x_sh = x_sh;
  a.dt_sb = dt_sb;
  a.dt_ss = dt_ss;
  const dim3 grid(grid_x, grid_y, grid_z);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 16) return repro::launch<16>(a, B, b_sb, b_ss, c_sb, c_ss, grid, st);
  if (N <= 32) return repro::launch<32>(a, B, b_sb, b_ss, c_sb, c_ss, grid, st);
  if (N <= 64) return repro::launch<64>(a, B, b_sb, b_ss, c_sb, c_ss, grid, st);
  return repro::launch<128>(a, B, b_sb, b_ss, c_sb, c_ss, grid, st);
}
