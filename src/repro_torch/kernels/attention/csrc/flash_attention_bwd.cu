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
// q, k, v, o, dO and lse read and dq, dk, dv written once.
//
// What the design does about it (FlashAttention-2's two passes, without
// atomics, so that two calls give the same bits):
//   * Δ = rowsum(dO ∘ O) in float32, one warp per (batch, head, row)
//     (delta_kernel), into a (B, H, S_q) scratch the wrapper allocates.
//   * dK and dV: one block per (key tile of 64, kv head, batch row).  Each
//     warp owns 16 keys; the block loops over the G query heads of its kv
//     head and over the query tiles that can see its keys (the causal and
//     window bands bound the loop), so GQA's sum over the group stays in
//     registers.  Per (query tile, key tile): Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ,
//     P = exp2(S·scale·log2e − lse·log2e) on the accumulator fragment, dV
//     += Pᵀ·dO with P rounded to bf16 (where the forward rounds it), dS = P
//     ∘ (dP − Δ), dK += dSᵀ·Q.  Q and dO tiles are double-buffered by
//     cp.async while the previous pair computes.
//   * dQ: one block per (query tile of 64, head, batch row), each warp 16
//     rows, over the key tiles the rows can see (double-buffered):
//     S = Q·Kᵀ, dP = dO·Vᵀ, dS, dQ += dS·K.
//   * bf16 runs on the tensor cores with mma.sync m16n8k16 (f32 sums)
//     whose operands come from shared memory by ldmatrix (.trans for the
//     operands read along their rows); the tiles are stored with their
//     16-byte chunks XOR-swizzled by row so that ldmatrix's eight rows hit
//     distinct banks.  The accumulator fragment of Sᵀ, dPᵀ (or S, dP) is
//     the A fragment of the next product, as P is in the forward.
//   * At D = 256 (recurrentgemma-9b: 16 heads on 1, window 2048) one
//     warp's dK and dV (or dQ) over all 256 columns would need 256 floats a
//     thread: the block has two warps per 16 rows, each owning 128 columns
//     of the accumulators and both computing the tile's S and dP.
//   * float32 runs on the FMA pipes (a TF32 product would miss float32's
//     tolerance): 32 x 32 tiles in shared memory padded by one float, 128
//     threads as 16 x 8, each owning 2 x 4 scores and 2 rows x D/8 columns
//     of the accumulators.
//   * A key past S_kv is zero-filled and scores 0, not -inf: it is masked
//     to P = 0 as are keys outside the band; a query row past S_q, or one
//     that sees no key (lse = -inf), gets P = 0.
#include <math.h>

#include "common.cuh"

namespace repro {
namespace {

constexpr float kLog2e = 1.4426950408889634f;

struct BwdArgs {
  const void *q, *k, *v, *o, *dout;
  const float* lse;  // (B, H, S_q), natural log
  float* delta;      // (B, H, S_q) scratch
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

// lse in log2 units for P = exp2(s·scale·log2e − lse2); +inf (P = 0) for a
// row past S_q or one that sees no key.
__device__ __forceinline__ float lse2_of(const BwdArgs& a, long long idx, bool valid) {
  if (!valid) return INFINITY;
  const float l = a.lse[idx];
  return l == -INFINITY ? INFINITY : l * kLog2e;
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
// bfloat16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kKeys = 64;  // keys per dK/dV block (16 per warp)
constexpr int kRows = 64;  // query rows per dQ block (16 per warp)

template <int D>
struct Mma {
  static constexpr int DC = D < 128 ? D : 128;   // accumulator columns per warp
  static constexpr int NCG = D / DC;             // warps per 16 rows
  static constexpr int THREADS = 128 * NCG;
  static constexpr int BQ = D <= 64 ? 64 : 32;   // query rows per step of the dK/dV block
  static constexpr int BK = D <= 64 ? 64 : 32;   // keys per step of the dQ block
  static constexpr int DKDV_SMEM = (2 * kKeys * D + 4 * BQ * D) * 2 + 4 * BQ * 4;
  static constexpr int DQ_SMEM = (2 * kRows * D + 4 * BK * D) * 2 + 2 * kRows * 4;
};

// Element offset of the 16-byte chunk c of row r in a tile of rows of D
// bf16 values, chunks XOR-swizzled by row.
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int CG = D / 8;
  constexpr int M = (CG < 8 ? CG : 8) - 1;
  return r * D + ((c ^ (r & M)) << 3);
}

// `rows` rows of D values from `src` (row stride `stride`) into a swizzled
// tile; rows at or past `valid` are zero-filled.
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long long stride, int valid,
                                          int rows, int tid, int nthreads) {
  constexpr int CG = D / 8;
  for (int idx = tid; idx < rows * CG; idx += nthreads) {
    const int r = idx / CG;
    const int c = idx % CG;
    const bool ok = r < valid;
    cp_async16(dst + swz<D>(r, c), src + static_cast<long long>(ok ? r : 0) * stride + c * 8, ok);
  }
}

// acc (16 x 8N, f32, N n-tiles) += A (16 x D, rows r0.. of tile `ta`) ·
// Bᵀ where B (8N x D) is rows 0.. of tile `tb`: both operands K-major.
template <int D, int N>
__device__ __forceinline__ void mma_abt(float (*acc)[4], const bf16* ta, int r0, const bf16* tb,
                                        int lane) {
#pragma unroll
  for (int kp = 0; kp < D / 32; ++kp) {
    uint32_t a0[4], a1[4];  // K-steps 2kp and 2kp + 1
    ldmatrix_x4(a0, ta + swz<D>(r0 + lane % 16, 4 * kp + lane / 16));
    ldmatrix_x4(a1, ta + swz<D>(r0 + lane % 16, 4 * kp + 2 + lane / 16));
#pragma unroll
    for (int nt = 0; nt < N; ++nt) {
      uint32_t bf[4];
      ldmatrix_x4(bf, tb + swz<D>(8 * nt + lane % 8, 4 * kp + lane / 8));
      mma_bf16(acc[nt], a0, bf[0], bf[1]);
      mma_bf16(acc[nt], a1, bf[2], bf[3]);
    }
  }
}

// acc (16 x 8CT, f32) += A (16 x 16J, registers) · B where B is rows 0..16J
// of tile `tb` at columns c0.. (read along its rows: ldmatrix.trans).
template <int D, int J, int CT>
__device__ __forceinline__ void mma_ab(float (*acc)[4], uint32_t (*a)[4], const bf16* tb,
                                       int c0, int lane) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int dp = 0; dp < CT / 2; ++dp) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, tb + swz<D>(16 * j + 8 * ((lane / 8) % 2) + lane % 8,
                                        c0 / 8 + 2 * dp + lane / 16));
      mma_bf16(acc[2 * dp], a[j], bf[0], bf[1]);
      mma_bf16(acc[2 * dp + 1], a[j], bf[2], bf[3]);
    }
  }
}

// The accumulator fragment of a 16 x 16J tile as J A fragments in bf16.
template <int J>
__device__ __forceinline__ void to_a(uint32_t (*a)[4], float (*c)[4]) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    a[j][0] = pack_bf16(c[2 * j][0], c[2 * j][1]);
    a[j][1] = pack_bf16(c[2 * j][2], c[2 * j][3]);
    a[j][2] = pack_bf16(c[2 * j + 1][0], c[2 * j + 1][1]);
    a[j][3] = pack_bf16(c[2 * j + 1][2], c[2 * j + 1][3]);
  }
}

// Accumulator fragment of an m16n8 product: register e of lane l holds row
// l/4 + 8·(e/2) and column 2·(l % 4) + e % 2 of its n-tile.
template <int D>
__global__ void __launch_bounds__(Mma<D>::THREADS) dkdv_mma_kernel(BwdArgs a) {
  using M = Mma<D>;
  constexpr int BQ = M::BQ, DC = M::DC, NT = BQ / 8, CT = DC / 8;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + kKeys * D;
  bf16* sQ = sV + kKeys * D;  // [2][BQ][D]
  bf16* sO = sQ + 2 * BQ * D;  // dO, [2][BQ][D]
  float* sL = reinterpret_cast<float*>(sO + 2 * BQ * D);  // [2][BQ] lse, log2 units
  float* sD = sL + 2 * BQ;                               // [2][BQ] Δ

  const int k0 = blockIdx.x * kKeys;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int kw = warp % 4;          // keys k0 + 16kw ..
  const int c0 = (warp / 4) * DC;   // accumulator columns c0 ..
  const int key_lo = k0 + 16 * kw + lane / 4;  // this thread's keys: key_lo, key_lo + 8

  load_rows<D>(sK, static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sh + k0 * a.k_ss,
               a.k_ss, a.S_kv - k0, kKeys, tid, M::THREADS);
  load_rows<D>(sV, static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sh + k0 * a.v_ss,
               a.v_ss, a.S_kv - k0, kKeys, tid, M::THREADS);
  cp_async_commit();

  const Span qs = queries_seeing(a, k0, kKeys);
  const int qt0 = qs.begin / BQ;
  const int nqt = qs.end > qs.begin ? (qs.end + BQ - 1) / BQ - qt0 : 0;
  const int n = nqt * a.G;

  auto issue = [&](int i) {  // step i: head kvh·G + i / nqt, query tile qt0 + i % nqt
    if (i < n) {
      const int h = kvh * a.G + i / nqt;
      const int q0 = (qt0 + i % nqt) * BQ;
      const int buf = i & 1;
      load_rows<D>(sQ + buf * BQ * D,
                   static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh + q0 * a.q_ss, a.q_ss,
                   a.S_q - q0, BQ, tid, M::THREADS);
      load_rows<D>(sO + buf * BQ * D,
                   static_cast<const bf16*>(a.dout) + b * a.do_sb + h * a.do_sh + q0 * a.do_ss,
                   a.do_ss, a.S_q - q0, BQ, tid, M::THREADS);
      for (int r = tid; r < BQ; r += M::THREADS) {
        const long long idx = (static_cast<long long>(b) * a.H + h) * a.S_q + q0 + r;
        const bool ok = q0 + r < a.S_q;
        sL[buf * BQ + r] = lse2_of(a, idx, ok);
        sD[buf * BQ + r] = ok ? a.delta[idx] : 0.f;
      }
    }
    cp_async_commit();
  };
  issue(0);

  float dk[CT][4], dv[CT][4];
#pragma unroll
  for (int j = 0; j < CT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  const float sl2 = a.scale * kLog2e;

  for (int i = 0; i < n; ++i) {
    issue(i + 1);
    cp_async_wait<1>();  // step i's tiles (and K, V) have landed
    __syncthreads();
    const int buf = i & 1;
    const int q0 = (qt0 + i % nqt) * BQ;
    const bf16* tQ = sQ + buf * BQ * D;
    const bf16* tO = sO + buf * BQ * D;
    const float* tL = sL + buf * BQ;
    const float* tD = sD + buf * BQ;

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: 16 keys x BQ queries.
    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
    mma_abt<D, NT>(st, sK, 16 * kw, tQ, lane);
    mma_abt<D, NT>(dpt, sV, 16 * kw, tO, lane);

    // P and dS on the fragments.
    const bool edge = edge_tile(a, q0, BQ, k0, kKeys);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qr = 8 * nt + 2 * (lane % 4) + (e & 1);
        float p = exp2f(fmaf(st[nt][e], sl2, -tL[qr]));
        if (edge && !visible(a, q0 + qr, key_lo + 8 * (e >> 1))) p = 0.f;
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - tD[qr]);
      }
    uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
    to_a<BQ / 16>(pa, st);
    to_a<BQ / 16>(dsa, dpt);

    // dV += Pᵀ·dO and dK += dSᵀ·Q over this warp's columns.
    mma_ab<D, BQ / 16, CT>(dv, pa, tO, c0, lane);
    mma_ab<D, BQ / 16, CT>(dk, dsa, tQ, c0, lane);
    __syncthreads();  // buffer `buf` is refilled by step i + 2's copies
  }
  cp_async_wait<0>();

  bf16* dkb = static_cast<bf16*>(a.dk) + b * a.dk_sb + kvh * a.dk_sh;
  bf16* dvb = static_cast<bf16*>(a.dv) + b * a.dv_sb + kvh * a.dv_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_lo + 8 * r;
    if (key < a.S_kv) {
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int col = c0 + 8 * j + 2 * (lane % 4);
        *reinterpret_cast<__nv_bfloat162*>(dkb + key * a.dk_ss + col) =
            __floats2bfloat162_rn(dk[j][2 * r] * a.scale, dk[j][2 * r + 1] * a.scale);
        *reinterpret_cast<__nv_bfloat162*>(dvb + key * a.dv_ss + col) =
            __floats2bfloat162_rn(dv[j][2 * r], dv[j][2 * r + 1]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(Mma<D>::THREADS) dq_mma_kernel(BwdArgs a) {
  using M = Mma<D>;
  constexpr int BK = M::BK, DC = M::DC, NT = BK / 8, CT = DC / 8;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sO = sQ + kRows * D;  // dO
  bf16* sK = sO + kRows * D;  // [2][BK][D]
  bf16* sV = sK + 2 * BK * D;  // [2][BK][D]
  float* sL = reinterpret_cast<float*>(sV + 2 * BK * D);  // [kRows] lse, log2 units
  float* sD = sL + kRows;                                // [kRows] Δ

  // Blocks of the last query rows (the most keys when causal) go first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / a.G;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int rw = warp % 4;         // rows q0 + 16rw ..
  const int c0 = (warp / 4) * DC;  // accumulator columns c0 ..
  const int row_lo = 16 * rw + lane / 4;  // this thread's rows (in the block): row_lo, row_lo + 8

  load_rows<D>(sQ, static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh + q0 * a.q_ss, a.q_ss,
               a.S_q - q0, kRows, tid, M::THREADS);
  load_rows<D>(sO, static_cast<const bf16*>(a.dout) + b * a.do_sb + h * a.do_sh + q0 * a.do_ss,
               a.do_ss, a.S_q - q0, kRows, tid, M::THREADS);
  for (int r = tid; r < kRows; r += M::THREADS) {
    const long long idx = (static_cast<long long>(b) * a.H + h) * a.S_q + q0 + r;
    const bool ok = q0 + r < a.S_q;
    sL[r] = lse2_of(a, idx, ok);
    sD[r] = ok ? a.delta[idx] : 0.f;
  }
  cp_async_commit();

  const Span ks = keys_seen(a, q0, kRows);
  const int t0 = ks.begin / BK;
  const int n = ks.end > ks.begin ? (ks.end + BK - 1) / BK - t0 : 0;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  auto issue = [&](int i) {
    if (i < n) {
      const int k0 = (t0 + i) * BK;
      const int buf = i & 1;
      load_rows<D>(sK + buf * BK * D, kb + k0 * a.k_ss, a.k_ss, a.S_kv - k0, BK, tid, M::THREADS);
      load_rows<D>(sV + buf * BK * D, vb + k0 * a.v_ss, a.v_ss, a.S_kv - k0, BK, tid, M::THREADS);
    }
    cp_async_commit();
  };
  issue(0);

  float dq[CT][4];
#pragma unroll
  for (int j = 0; j < CT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
  const float sl2 = a.scale * kLog2e;

  for (int i = 0; i < n; ++i) {
    issue(i + 1);
    cp_async_wait<1>();
    __syncthreads();
    const int buf = i & 1;
    const int k0 = (t0 + i) * BK;
    const bf16* tK = sK + buf * BK * D;
    const bf16* tV = sV + buf * BK * D;

    // S = Q·Kᵀ and dP = dO·Vᵀ: 16 rows x BK keys.
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mma_abt<D, NT>(s, sQ, 16 * rw, tK, lane);
    mma_abt<D, NT>(dp, sO, 16 * rw, tV, lane);

    const bool edge = edge_tile(a, q0, kRows, k0, BK);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row_lo + 8 * (e >> 1);
        float p = exp2f(fmaf(s[nt][e], sl2, -sL[r]));
        if (edge && !visible(a, q0 + r, k0 + 8 * nt + 2 * (lane % 4) + (e & 1))) p = 0.f;
        dp[nt][e] = p * (dp[nt][e] - sD[r]);
      }
    uint32_t dsa[BK / 16][4];
    to_a<BK / 16>(dsa, dp);

    // dQ += dS·K over this warp's columns.
    mma_ab<D, BK / 16, CT>(dq, dsa, tK, c0, lane);
    __syncthreads();
  }
  cp_async_wait<0>();

  bf16* dqb = static_cast<bf16*>(a.dq) + b * a.dq_sb + h * a.dq_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row_lo + 8 * r;
    if (row < a.S_q) {
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int col = c0 + 8 * j + 2 * (lane % 4);
        *reinterpret_cast<__nv_bfloat162*>(dqb + row * a.dq_ss + col) =
            __floats2bfloat162_rn(dq[j][2 * r] * a.scale, dq[j][2 * r + 1] * a.scale);
      }
    }
  }
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

template <typename Kernel>
cudaError_t launch_one(Kernel kernel, dim3 grid, int threads, int smem, const BwdArgs& a,
                       cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(const BwdArgs& a, bool bf16_route, cudaStream_t stream) {
  const long long rows = static_cast<long long>(a.B) * a.H * a.S_q;
  const dim3 dgrid(static_cast<unsigned>((rows + kDeltaWarps - 1) / kDeltaWarps));
  if (bf16_route) {
    delta_kernel<bf16><<<dgrid, kDeltaWarps * 32, 0, stream>>>(a, D);
  } else {
    delta_kernel<float><<<dgrid, kDeltaWarps * 32, 0, stream>>>(a, D);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (bf16_route) {
    using M = Mma<D>;
    err = launch_one(dkdv_mma_kernel<D>, dim3((a.S_kv + kKeys - 1) / kKeys, a.KV, a.B),
                     M::THREADS, M::DKDV_SMEM, a, stream);
    if (err != cudaSuccess) return err;
    return launch_one(dq_mma_kernel<D>, dim3((a.S_q + kRows - 1) / kRows, a.H, a.B), M::THREADS,
                      M::DQ_SMEM, a, stream);
  }
  err = launch_one(dkdv_fma_kernel<D>, dim3((a.S_kv + kFT - 1) / kFT, a.KV, a.B), kFThreads,
                   fma_smem_bytes<D>(), a, stream);
  if (err != cudaSuccess) return err;
  return launch_one(dq_fma_kernel<D>, dim3((a.S_q + kFT - 1) / kFT, a.H, a.B), kFThreads,
                    fma_smem_bytes<D>(), a, stream);
}

}  // namespace
}  // namespace repro

// dtype 0 = float32 (FMA), 1 = bfloat16 (tensor cores), for every tensor
// but lse and delta (float32, (B, H, S_q) contiguous).  q, o, dout, dq
// (B,S_q,H,D); k, v, dk, dv (B,S_kv,KV,D); strides in elements, last
// dimension contiguous, rows 16-byte aligned.  `delta` is scratch of the
// lse's shape.  Returns the CUDA error of the launches (0 on success).
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* delta, void* dq, void* dk, void* dv, int dtype, int B, int S_q,
    int S_kv, int H, int KV, int D, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh, long long do_sb,
    long long do_ss, long long do_sh, long long dq_sb, long long dq_ss, long long dq_sh,
    long long dk_sb, long long dk_ss, long long dk_sh, long long dv_sb, long long dv_ss,
    long long dv_sh, int causal, int window, int q_offset, float scale, void* stream) {
  const repro::BwdArgs a{q,     k,     v,     o,     dout,  lse,   delta, dq,    dk,
                         dv,    B,     S_q,   S_kv,  H,     KV,    H / KV, q_sb, q_ss,
                         q_sh,  k_sb,  k_ss,  k_sh,  v_sb,  v_ss,  v_sh,  o_sb,  o_ss,
                         o_sh,  do_sb, do_ss, do_sh, dq_sb, dq_ss, dq_sh, dk_sb, dk_ss,
                         dk_sh, dv_sb, dv_ss, dv_sh, causal, window, q_offset, scale};
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool bf = dtype == 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return static_cast<int>(repro::launch_bwd<32>(a, bf, st));
    case 64: return static_cast<int>(repro::launch_bwd<64>(a, bf, st));
    case 128: return static_cast<int>(repro::launch_bwd<128>(a, bf, st));
    case 256: return static_cast<int>(repro::launch_bwd<256>(a, bf, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
