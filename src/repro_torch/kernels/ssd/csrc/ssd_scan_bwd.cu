// Mamba-2 SSD scan's backward for Hopper (sm_90a): dx, ddt, dA, dB, dC, dD
// and dh0 from the forward's inputs and the cotangents of y (dy) and of the
// final state (dh_final; null in training, where the state is discarded).
//
// Replaces: nothing on the TPU.  The Pallas kernel
// src/repro/kernels/ssd/ssd_scan.py::ssd has no custom_vjp; jax.grad
// differentiates its plain version, ref.ssd_chunked.  This kernel computes
// that vector-Jacobian product: ref.ssd_bwd_plain writes out the same passes
// in PyTorch.
//
// What bounds it on an H100: at mamba2-370m's training shape (4 x 4096, H 32,
// P 64, N 128, bf16) the least work is twice the forward's products, 52.6
// GFLOP (53 µs of bf16 tensor-core time), and x, dt, B, C, dy read and dx,
// ddt, dB, dC written, 222 MB (66 µs at 3.35 TB/s): bytes, narrowly.  This
// kernel is far from either: it keeps the chunk states and their
// cotangents in device memory (1.07 GB written and read at that shape),
// sums dB and dC over heads in a second pass, runs one block of 8 warps per
// SM in its gradient pass, and uses mma.sync, not wgmma.  It is the simple,
// correct version.
//
// The design (the chunked backward; chunk Q = 64 whatever the caller's
// chunk, since the function does not depend on it), four launches:
//   1. ssd_bwd_states: one block per (chunk, head, batch row) computes the
//      chunk's own part of the state entering the next chunk, Σ_s
//      exp(tot − cum_s)·dt_s·x_s B_sᵀ, and of the state's cotangent entering
//      it, Σ_t exp(cum_t)·dy_t C_tᵀ (both P x N), and tot.
//   2. ssd_bwd_passing: one thread per 4 adjacent (p, n) of a (batch row,
//      head) walks the chunks forwards, leaving in place of each chunk's
//      part the state entering it (H[c], from h0), then backwards, leaving
//      the state's cotangent leaving it (G[c], from dh_final: G[c−1] =
//      exp(tot_c)·G[c] + the chunk's part); dh0 is where it ends.
//   3. ssd_bwd_grads: one block per (chunk, head, batch row), with K = L ∘
//      dt_s ∘ dY·Xᵀ (L[t, s] = exp(cum_t − cum_s), s <= t) and U = (C·Bᵀ ∘
//      L)ᵀ dY + exp(tot − cum) ∘ B·Gᵀ: dx = dt·U + D·dy; this head's dB =
//      Kᵀ C + dt·exp(tot − cum) ∘ X·G and dC = K B + exp(cum) ∘ dY·H into
//      scratch; dcum_t = Σ_s (C_t·B_s) K[t, s] + exp(cum_t) dy_t·(H C_t) −
//      dt_t x_t·U_t, plus ⟨G, the state leaving the chunk⟩ at the chunk's
//      end, reverse-summed in double within the chunk into da; ddt = x·U +
//      A·da; the chunk's Σ dt·da and Σ dy·x into scratch.
//   4. ssd_bwd_reduce: dB and dC summed over the heads, and dA and dD over
//      the batch rows and chunks, each in a fixed order.
// No atomics: two calls on the same inputs give the same bits.
//
// Products: bf16 inputs run them on the tensor cores (mma.sync m16n8k16,
// fragments by ldmatrix from bf16 tiles in shared memory), float32 inputs on
// the FMA pipes from float tiles.  x, dy, B and C enter as they are; the
// float32 operands (the gated scores, K, the states and their cotangents,
// x∘w and dy∘exp(cum)) enter as bf16 hi + lo planes, each part one product
// into the same float32 sum (16 bits of mantissa): rounded once, C·Bᵀ ∘ L
// or K moves dA by 0.13 of its max at mamba2-370m's training shape.  Tile
// loads are 16-byte cp.async on the MMA route (else 16-byte loads, several
// in flight per thread): one block runs on an SM, and loads that wait one
// at a time leave it idle.  The within-chunk cumsum is kept in double and
// each decay's difference rounded once before the exp, as in the forward
// kernels.  A ragged last chunk reads dt = 0 and x = B = C = dy = 0 past S,
// so it adds nothing, and its rows past S are not written.
#include <type_traits>

#include "../../attention/csrc/common.cuh"

namespace repro {
namespace {

constexpr int kQ = 64;            // internal chunk length
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kAcc = 32;          // accumulators a thread holds: up to 64 x 128 outputs

struct BwdArgs {
  const void* x;          // (B, S, H, P), last dim contiguous
  const float* dt;        // (B, S, H), last dim contiguous
  const float* A;         // (H,)
  const void* Bm;         // (B, S, N), last dim contiguous
  const void* Cm;         // (B, S, N), last dim contiguous
  const float* D;         // (H,)
  const float* h0;        // (B, H, P, N) or null
  const void* dy;         // (B, S, H, P), last dim contiguous, or null (zero)
  const float* dh_final;  // (B, H, P, N) or null (zero)
  void* dx;               // (B, S, H, P) contiguous
  float* ddt;             // (B, S, H) contiguous
  float* dA;              // (H,)
  void* dBm;              // (B, S, N) contiguous
  void* dCm;              // (B, S, N) contiguous
  float* dD;              // (H,)
  float* dh0;             // (B, H, P, N) or null
  float* states;          // (2, B, H, nc, P, N): each chunk's parts, then H[c] and G[c]
  float* a_tot;           // (B, H, nc)
  float* parts;           // (2, B, S, H, N): each head's dB and dC
  float* ad;              // (2, B, nc, H): each chunk's Σ dt·da and Σ dy·x
  int B, S, H, P, N, NP, nc;
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss;
  long long b_sb, b_ss;
  long long c_sb, c_ss;
  long long dy_sb, dy_ss, dy_sh;
};

template <typename T>
constexpr bool kMmaOf = std::is_same<T, __nv_bfloat16>::value;

// A tile in shared memory, row-major with row stride ld.  FMA: float
// values.  MMA: bf16 values in one plane where they are bf16 (x, dy, B, C:
// exact) and in hi + lo planes where they are float32 (get: hi + lo, 16
// bits of mantissa), rows 16-byte aligned and padded by 8 values so that
// ldmatrix's 8 row reads hit distinct banks.
template <bool kMma>
struct Tile;
template <>
struct Tile<false> {
  float* p;
  int ld;
  __device__ __forceinline__ float get(int r, int c) const { return p[r * ld + c]; }
  __device__ __forceinline__ float get_hi(int r, int c) const { return p[r * ld + c]; }
  __device__ __forceinline__ void set(int r, int c, float v) const { p[r * ld + c] = v; }
};
template <>
struct Tile<true> {
  __nv_bfloat16* hi;
  __nv_bfloat16* lo;  // null where the values are bf16
  int ld;
  __device__ __forceinline__ float get(int r, int c) const {
    const float v = __bfloat162float(hi[r * ld + c]);
    return lo != nullptr ? v + __bfloat162float(lo[r * ld + c]) : v;
  }
  __device__ __forceinline__ float get_hi(int r, int c) const {  // the hi plane alone
    return __bfloat162float(hi[r * ld + c]);
  }
  __device__ __forceinline__ void set(int r, int c, float v) const {
    const __nv_bfloat16 h = __float2bfloat16(v);
    hi[r * ld + c] = h;
    if (lo != nullptr) lo[r * ld + c] = __float2bfloat16(v - __bfloat162float(h));
  }
};

// Four 8 x 8 bf16 matrices from the row addresses lanes 8i..8i+7 give for
// matrix i, transposed with kTrans.
template <bool kTrans>
__device__ __forceinline__ void ldsm(uint32_t* r, const __nv_bfloat16* row) {
  if constexpr (kTrans) {
    ldmatrix_x4_trans(r, row);
  } else {
    ldmatrix_x4(r, row);
  }
}

__device__ __forceinline__ void zero(float* acc) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
}

// The MMA route of gemm for a warp that owns kTiles 8-column tiles (with
// kGuard, up to kTiles: those at or past N are skipped).  Each k step loads
// every fragment first and then issues the products tile after tile, hi·hi,
// then hi·lo, then lo·hi, so that no product waits on the one before it.
template <bool kAT, bool kBT, int kTiles, bool kGuard>
__device__ __forceinline__ void mma_tiles(float* acc, int M, int N, int K, const Tile<true> A,
                                          const Tile<true> B) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mt = M / 16, nt = N / 8, wpr = kWarps / mt, tm = warp % mt, tn0 = warp / mt;
  const int r8 = lane % 8, mat = lane / 8;  // this lane gives row r8 of matrix mat
  const bool a_lo = A.lo != nullptr, b_lo = B.lo != nullptr;
  for (int k0 = 0; k0 < K; k0 += 16) {
    // A's matrices: rows +0 / +8 and columns +0 / +8, in a0..a3's order.
    const int am = tm * 16 + (mat & 1) * 8, ak = k0 + (mat >> 1) * 8;
    const int aoff = kAT ? (ak + r8) * A.ld + am : (am + r8) * A.ld + ak;
    uint32_t ahi[4], alo[4], bf[kTiles][4];
    ldsm<kAT>(ahi, A.hi + aoff);
    if (a_lo) ldsm<kAT>(alo, A.lo + aoff);
    // B's matrices: k +0 / +8 from the hi plane, then from the lo.
    const int bk = k0 + (mat & 1) * 8;
    const __nv_bfloat16* bp = mat < 2 || !b_lo ? B.hi : B.lo;
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      const int bn = (tn0 + wpr * j) * 8;
      if (!kGuard || bn < N) ldsm<kBT>(bf[j], bp + (kBT ? (bk + r8) * B.ld + bn : (bn + r8) * B.ld + bk));
    }
#pragma unroll
    for (int j = 0; j < kTiles; ++j)
      if (!kGuard || tn0 + wpr * j < nt) mma_bf16(acc + 4 * j, ahi, bf[j][0], bf[j][1]);
    if (b_lo) {
#pragma unroll
      for (int j = 0; j < kTiles; ++j)
        if (!kGuard || tn0 + wpr * j < nt) mma_bf16(acc + 4 * j, ahi, bf[j][2], bf[j][3]);
    }
    if (a_lo) {
#pragma unroll
      for (int j = 0; j < kTiles; ++j)
        if (!kGuard || tn0 + wpr * j < nt) mma_bf16(acc + 4 * j, alo, bf[j][0], bf[j][1]);
    }
  }
}

// acc += A · B for A (M x K) stored [m][k], or [k][m] with kAT, and B
// (K x N) stored [n][k], or [k][n] with kBT.  M is 16, 32 or 64, N a
// multiple of 16 up to 128, K a multiple of 16.
// FMA: thread (ty, tx) = (tid / 16, tid % 16) owns (ty + 16i, tx + 16j) at
// acc[8i + j].  MMA (mma.sync m16n8k16): warp w owns the 16-row block
// w % (M/16) and the 8-column tiles w / (M/16) + (8 / (M/16))·j at
// acc[4j .. 4j + 3], in mma.sync's C layout; the fragments come from
// ldmatrix (.trans where the tile is stored the other way), and a tile with
// a lo plane enters as hi + lo, each part one product into the same float32
// sum (the lo·lo product is left out).  Where the warps' tiles divide the
// columns evenly (every shape of mamba2-370m), a path with no guard runs.
template <bool kMma, bool kAT, bool kBT>
__device__ __forceinline__ void gemm(float* acc, int M, int N, int K, const Tile<kMma> A,
                                     const Tile<kMma> B) {
  if constexpr (!kMma) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16, mi = M / 16, nj = N / 16;
    for (int k = 0; k < K; ++k) {
      float av[4], bv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        av[i] = i < mi ? (kAT ? A.get(k, ty + 16 * i) : A.get(ty + 16 * i, k)) : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        bv[j] = j < nj ? (kBT ? B.get(k, tx + 16 * j) : B.get(tx + 16 * j, k)) : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[8 * i + j] += av[i] * bv[j];
    }
  } else {
    const int nt = N / 8, wpr = kWarps / (M / 16);
    if (nt == 8 * wpr) {
      mma_tiles<kAT, kBT, 8, false>(acc, M, N, K, A, B);
    } else if (nt == 4 * wpr) {
      mma_tiles<kAT, kBT, 4, false>(acc, M, N, K, A, B);
    } else if (nt == 2 * wpr) {
      mma_tiles<kAT, kBT, 2, false>(acc, M, N, K, A, B);
    } else {
      mma_tiles<kAT, kBT, kAcc / 4, true>(acc, M, N, K, A, B);
    }
  }
}

// f(m, n, v) for each output (m, n) of an M x N product this thread holds.
template <bool kMma, typename F>
__device__ __forceinline__ void for_each(float* acc, int M, int N, F f) {
  if constexpr (!kMma) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16, mi = M / 16, nj = N / 16;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (i < mi && j < nj) f(ty + 16 * i, tx + 16 * j, acc[8 * i + j]);
  } else {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
    const int mt = M / 16, nt = N / 8, wpr = kWarps / mt;
    const int row = (warp % mt) * 16 + g, tn0 = warp / mt;
#pragma unroll
    for (int j = 0; j < kAcc / 4; ++j) {
      const int tn = tn0 + wpr * j;
      if (tn < nt) {
#pragma unroll
        for (int r = 0; r < 4; ++r) f(row + 8 * (r >> 1), tn * 8 + 2 * q + (r & 1), acc[4 * j + r]);
      }
    }
  }
}

// Lane-wise sum over the warp, in a fixed order (every lane gets it).
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// dt of the chunk (0 past S) and cum, the inclusive cumsum of the float32
// products A·dt over the chunk in double; warp 0 does it with one shuffle
// scan (as the forward's ssd_scan.cu).
__device__ void load_decay(const BwdArgs& a, int b, int h, int t0, int valid, float* dt_s,
                           double* acum_s) {
  if (threadIdx.x >= 32) return;
  constexpr int E = kQ / 32;
  const int lane = threadIdx.x;
  const float Ah = a.A[h];
  double v[E];
  double run = 0.0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int t = lane * E + e;
    const float d = t < valid ? a.dt[b * a.dt_sb + (long long)(t0 + t) * a.dt_ss + h] : 0.f;
    dt_s[t] = d;
    run += static_cast<double>(Ah * d);
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
#pragma unroll
  for (int e = 0; e < E; ++e) acum_s[lane * E + e] = excl + v[e];
}

// `rows` rows of `cols` values (row stride `rs` in device memory), zero past
// `valid` rows and from `cols` to `cols_pad`: put(row, col, value) for each.
// Where the rows are 16-byte aligned, 16-byte loads (Vec); else one value a
// load.  Each thread issues kBatch loads before it puts any, so that a block
// keeps that many in flight per thread.
constexpr int kBatch = 4;
template <typename T, typename Put>
__device__ __forceinline__ void load_rows(const T* src, long long rs, int rows, int valid,
                                          int cols, int cols_pad, Put put) {
  constexpr int V = Vec<T>::N;
  if (reinterpret_cast<uintptr_t>(src) % 16 == 0 && rs % V == 0 && cols % V == 0) {
    const int per_row = cols_pad / V, total = rows * per_row;
    for (int base = threadIdx.x; base < total; base += kThreads * kBatch) {
      float v[kBatch][V];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * kThreads, t = i / per_row, c = i % per_row * V;
        if (i < total && t < valid && c < cols) {
          Vec<T>::load(src + t * rs + c, v[u]);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) v[u][e] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * kThreads;
        if (i < total) {
#pragma unroll
          for (int e = 0; e < V; ++e) put(i / per_row, i % per_row * V + e, v[u][e]);
        }
      }
    }
    return;
  }
  const int total = rows * cols_pad;
  for (int base = threadIdx.x; base < total; base += kThreads * kBatch * 2) {
    float v[kBatch * 2];
#pragma unroll
    for (int u = 0; u < kBatch * 2; ++u) {
      const int i = base + u * kThreads, t = i / cols_pad, n = i % cols_pad;
      v[u] = i < total && t < valid && n < cols ? to_float(src[t * rs + n]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch * 2; ++u) {
      const int i = base + u * kThreads;
      if (i < total) put(i / cols_pad, i % cols_pad, v[u]);
    }
  }
}

// `rows` rows of `cols` values (row stride `rs`) copied as they are into
// shared memory (row stride ld) by 16-byte cp.async, zeros past `valid` rows
// and from `cols` to `cols_pad`; false, and nothing copied, where the rows
// are not 16-byte aligned or there is no operand.  The caller waits.
template <typename T>
__device__ __forceinline__ bool copy_rows_async(T* dst, int ld, const T* src, long long rs,
                                                int rows, int valid, int cols, int cols_pad) {
  constexpr int V = 16 / sizeof(T);
  if (src == nullptr || reinterpret_cast<uintptr_t>(src) % 16 != 0 || rs % V != 0 ||
      cols % V != 0)
    return false;
  const int per_row = cols_pad / V;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int t = i / per_row, c = i % per_row * V;
    const bool in = t < valid && c < cols;
    cp_async16(dst + t * ld + c, in ? src + t * rs + c : src, in);
  }
  return true;
}

// An operand's kQ rows into its tile: on the MMA route the bf16 values as
// they are, into the hi plane, by cp.async where the rows allow it;
// otherwise (and on the FMA route) through registers.
template <typename T>
__device__ __forceinline__ void load_tile(const Tile<kMmaOf<T>>& dst, const T* src, long long rs,
                                          int valid, int cols, int cols_pad) {
  if constexpr (kMmaOf<T>) {
    if (copy_rows_async(dst.hi, dst.ld, src, rs, kQ, valid, cols, cols_pad)) return;
  }
  load_rows(src, rs, kQ, valid, cols, cols_pad, [&](int t, int n, float v) { dst.set(t, n, v); });
}

template <typename T>
struct Operands {  // a block's rows of x, dy, B and C in device memory
  const T *x, *dy, *bm, *cm;
  __device__ Operands(const BwdArgs& a, int b, int h, int t0) {
    x = static_cast<const T*>(a.x) + b * a.x_sb + h * a.x_sh + t0 * a.x_ss;
    dy = a.dy == nullptr ? nullptr
                         : static_cast<const T*>(a.dy) + b * a.dy_sb + h * a.dy_sh + t0 * a.dy_ss;
    bm = static_cast<const T*>(a.Bm) + b * a.b_sb + t0 * a.b_ss;
    cm = static_cast<const T*>(a.Cm) + b * a.c_sb + t0 * a.c_ss;
  }
};

// Shared memory, in bytes: the vectors, then tiles of `elems` values each,
// each 16-byte aligned.  The tiles' row padding: 8 values on the MMA route
// (ldmatrix), 1 on the FMA route.
__host__ __device__ constexpr int round16(int bytes) { return (bytes + 15) / 16 * 16; }
template <typename T>
constexpr int kPadOf = kMmaOf<T> ? 8 : 1;
template <typename T>
constexpr int kElemOf = kMmaOf<T> ? 2 : 4;  // bytes of a tile value

// Tile views of a bump-allocated region of shared memory.
template <typename T>
struct Carve {
  char* base;
  int at;
  __device__ Tile<kMmaOf<T>> tile(int rows, int ld, bool split) {
    if constexpr (kMmaOf<T>) {
      auto* hi = reinterpret_cast<__nv_bfloat16*>(base + at);
      at += round16(rows * ld * 2);
      __nv_bfloat16* lo = nullptr;
      if (split) {
        lo = reinterpret_cast<__nv_bfloat16*>(base + at);
        at += round16(rows * ld * 2);
      }
      return {hi, lo, ld};
    } else {
      auto* p = reinterpret_cast<float*>(base + at);
      at += round16(rows * ld * 4);
      return {p, ld};
    }
  }
  __device__ float* floats(int n) {
    float* p = reinterpret_cast<float*>(base + at);
    at += round16(n * 4);
    return p;
  }
};

// Pass 1's shared memory: cum (double), dt, then x∘w and dy∘exp(cum)
// (split), B and C.
template <typename T>
__host__ __device__ constexpr int states_smem(int P, int NP) {
  const int planes = kMmaOf<T> ? 2 : 1, xs = P + kPadOf<T>, ns = NP + kPadOf<T>;
  return round16(3 * kQ * 4) + 2 * planes * round16(kQ * xs * kElemOf<T>) +
         2 * round16(kQ * ns * kElemOf<T>);
}

// Pass 1: each chunk's own part of H, (x∘w)ᵀ B, and of G, (dy∘exp(cum))ᵀ C,
// and tot.
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_states_kernel(BwdArgs a) {
  constexpr bool kMma = kMmaOf<T>;
  extern __shared__ float smem[];
  const int P = a.P, N = a.N, NP = a.NP;
  double* acum_s = reinterpret_cast<double*>(smem);  // kQ
  float* dt_s = smem + 2 * kQ;                       // kQ
  Carve<T> mem{reinterpret_cast<char*>(smem), round16(3 * kQ * 4)};
  const Tile<kMma> xw = mem.tile(kQ, P + kPadOf<T>, true);   // x_s·exp(tot − cum_s)·dt_s
  const Tile<kMma> dyw = mem.tile(kQ, P + kPadOf<T>, true);  // dy_t·exp(cum_t)
  const Tile<kMma> bt = mem.tile(kQ, NP + kPadOf<T>, false);
  const Tile<kMma> ct = mem.tile(kQ, NP + kPadOf<T>, false);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * kQ, valid = min(kQ, a.S - t0);
  const Operands<T> in(a, b, h, t0);

  // x and dy go into the hi planes (exact) and are scaled and split below.
  load_tile(xw, in.x, a.x_ss, valid, P, P);
  load_tile(dyw, in.dy, a.dy_ss, in.dy ? valid : 0, P, P);
  load_tile(bt, in.bm, a.b_ss, valid, N, NP);
  load_tile(ct, in.cm, a.c_ss, valid, N, NP);
  cp_async_commit();
  load_decay(a, b, h, t0, valid, dt_s, acum_s);
  cp_async_wait<0>();
  __syncthreads();
  const double tot = acum_s[kQ - 1];
  for (int i = threadIdx.x; i < kQ * P; i += kThreads) {
    const int t = i / P, p = i % P;
    xw.set(t, p, xw.get_hi(t, p) * (expf(static_cast<float>(tot - acum_s[t])) * dt_s[t]));
    dyw.set(t, p, dyw.get_hi(t, p) * expf(static_cast<float>(acum_s[t])));
  }
  __syncthreads();

  const long long bhc = ((long long)b * a.H + h) * a.nc + c;
  const long long plane = (long long)a.B * a.H * a.nc * P * N;
  float acc[kAcc];
  const auto write = [&](float* out) {
    for_each<kMma>(acc, P, NP, [&](int m, int n, float& v) {
      if (n < N) out[m * N + n] = v;
    });
  };
  zero(acc);
  gemm<kMma, true, true>(acc, P, NP, kQ, xw, bt);
  write(a.states + bhc * P * N);
  zero(acc);
  gemm<kMma, true, true>(acc, P, NP, kQ, dyw, ct);
  write(a.states + plane + bhc * P * N);
  if (threadIdx.x == 0) a.a_tot[bhc] = static_cast<float>(tot);
}

// Pass 2: one thread per 4 adjacent (p, n) of one (batch row, head), with
// 16-byte loads of the states: H[c] forwards from h0, G[c] backwards from
// dh_final, each in place of the chunk's part; dh0 where h0 was given.
// Each walk reads kWalk chunks' parts and decays before it writes any, so
// that the loads are in flight together; the chain is arithmetic.
__device__ __forceinline__ float4 fma4(float s, float4 h, float4 p) {
  return make_float4(s * h.x + p.x, s * h.y + p.y, s * h.z + p.z, s * h.w + p.w);
}
__device__ __forceinline__ float4 load4(const float* p) {  // p may be unaligned
  return p == nullptr ? make_float4(0.f, 0.f, 0.f, 0.f) : make_float4(p[0], p[1], p[2], p[3]);
}
__global__ void __launch_bounds__(kThreads) ssd_bwd_passing_kernel(BwdArgs a) {
  constexpr int kWalk = 8;
  const int PN = a.P * a.N;  // a multiple of 16
  const int e = (blockIdx.x * kThreads + threadIdx.x) * 4;
  if (e >= PN) return;
  const long long bh = (long long)blockIdx.z * a.H + blockIdx.y;
  const float* at = a.a_tot + bh * a.nc;
  float4* hst = reinterpret_cast<float4*>(a.states + bh * a.nc * PN + e);
  float4* gst = reinterpret_cast<float4*>(a.states + ((long long)a.B * a.H + bh) * a.nc * PN + e);
  const long long step = PN / 4;  // one chunk, in float4
  float4 hs = load4(a.h0 != nullptr ? a.h0 + bh * PN + e : nullptr);
  for (int c0 = 0; c0 < a.nc; c0 += kWalk) {
    float4 part[kWalk];
    float decay[kWalk];
#pragma unroll
    for (int u = 0; u < kWalk; ++u) {
      const bool in = c0 + u < a.nc;
      part[u] = in ? hst[(c0 + u) * step] : make_float4(0.f, 0.f, 0.f, 0.f);
      decay[u] = in ? at[c0 + u] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kWalk; ++u) {
      if (c0 + u < a.nc) {
        hst[(c0 + u) * step] = hs;
        hs = fma4(expf(decay[u]), hs, part[u]);
      }
    }
  }
  float4 gs = load4(a.dh_final != nullptr ? a.dh_final + bh * PN + e : nullptr);
  for (int c0 = a.nc - 1; c0 >= 0; c0 -= kWalk) {
    float4 part[kWalk];
    float decay[kWalk];
#pragma unroll
    for (int u = 0; u < kWalk; ++u) {
      const bool in = c0 - u >= 0;
      part[u] = in ? gst[(c0 - u) * step] : make_float4(0.f, 0.f, 0.f, 0.f);
      decay[u] = in ? at[c0 - u] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kWalk; ++u) {
      if (c0 - u >= 0) {
        gst[(c0 - u) * step] = gs;
        gs = fma4(expf(decay[u]), gs, part[u]);
      }
    }
  }
  if (a.dh0 != nullptr) {
    float* out = a.dh0 + bh * PN + e;
    out[0] = gs.x;
    out[1] = gs.y;
    out[2] = gs.z;
    out[3] = gs.w;
  }
}

// Pass 3's shared memory: cum (double), eight vectors of kQ floats and one
// of kThreads, then x, dy, C and B, C·Bᵀ ∘ L (S1) and K (S2) (split), G
// then H (split), and on the MMA route C·Bᵀ and K again as float tiles for
// the sums (on the FMA route S1 and S2 hold them) and a float tile that G
// and then H land in (cp.async) before they are split; last U, then H C
// (float).
constexpr int kVecBytes = kQ * 8 + 8 * kQ * 4 + kThreads * 4;
template <typename T>
__host__ __device__ constexpr int grads_smem(int P, int NP) {
  const int planes = kMmaOf<T> ? 2 : 1, e = kElemOf<T>;
  const int xs = P + kPadOf<T>, ns = NP + kPadOf<T>, qs = kQ + kPadOf<T>;
  return kVecBytes + 2 * round16(kQ * xs * e) + 2 * round16(kQ * ns * e) +
         2 * planes * round16(kQ * qs * e) + planes * round16(P * ns * e) +
         (kMmaOf<T> ? 2 * round16(kQ * (kQ + 4) * 4) + round16(P * NP * 4) : 0) +
         round16(kQ * (P + 4) * 4);
}

// Pass 3: one chunk of one head of one batch row.
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_grads_kernel(BwdArgs a) {
  constexpr bool kMma = kMmaOf<T>;
  extern __shared__ float smem[];
  const int P = a.P, N = a.N, NP = a.NP;
  const int tid = threadIdx.x;
  double* acum_s = reinterpret_cast<double*>(smem);  // kQ
  float* dt_s = smem + 2 * kQ;      // kQ
  float* ecum_s = dt_s + kQ;        // exp(cum_t)
  float* etail_s = ecum_s + kQ;     // exp(tot − cum_t)
  float* rowt_s = etail_s + kQ;     // Σ_s (C_t·B_s) K[t, s]
  float* colt_s = rowt_s + kQ;      // Σ_t (C_t·B_s) K[t, s]
  float* xu_s = colt_s + kQ;        // x_t·U_t
  float* inter_s = xu_s + kQ;       // exp(cum_t) dy_t·(H C_t)
  float* dyx_s = inter_s + kQ;      // dy_t·x_t
  float* red_s = dyx_s + kQ;        // kThreads: ⟨G, H⟩ per thread
  Carve<T> mem{reinterpret_cast<char*>(smem), kVecBytes};
  const int xs = P + kPadOf<T>, ns = NP + kPadOf<T>, qs = kQ + kPadOf<T>;
  const Tile<kMma> xt = mem.tile(kQ, xs, false);
  const Tile<kMma> dyt = mem.tile(kQ, xs, false);
  const Tile<kMma> ct = mem.tile(kQ, ns, false);
  const Tile<kMma> bt = mem.tile(kQ, ns, false);
  const Tile<kMma> s1 = mem.tile(kQ, qs, true);   // C·Bᵀ ∘ L
  const Tile<kMma> s2 = mem.tile(kQ, qs, true);   // K
  const Tile<kMma> gh = mem.tile(P, ns, true);    // G, then H
  // C·Bᵀ and K as floats, (kQ x qf): their own tiles on the MMA route,
  // S1's and S2's on the FMA route.
  int qf = qs;
  float *cbf, *kf, *stage = nullptr;  // stage: (P x NP), G then H as they are
  if constexpr (kMma) {
    qf = kQ + 4;
    cbf = mem.floats(kQ * qf);
    kf = mem.floats(kQ * qf);
    stage = mem.floats(P * NP);
  } else {
    cbf = s1.p;
    kf = s2.p;
  }
  const int uf = P + 4;
  float* u_s = mem.floats(kQ * uf);  // U, then H C
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * kQ, valid = min(kQ, a.S - t0);
  const long long bhc = ((long long)b * a.H + h) * a.nc + c;
  const long long plane = (long long)a.B * a.H * a.nc * P * N;
  const Operands<T> in(a, b, h, t0);

  const float* G = a.states + plane + bhc * P * N;
  const float* H = a.states + bhc * P * N;
  // The MMA route lands G (and later H) as it is in `stage` and splits it
  // there: every load of the block is in flight at once, and H's during
  // the products that come before it is needed.
  const auto land = [&](const float* src) {
    if (!copy_rows_async(stage, NP, src, N, P, P, N, NP))
      load_rows(src, N, P, P, N, NP, [&](int p, int n, float v) { stage[p * NP + n] = v; });
    cp_async_commit();
  };
  load_tile(xt, in.x, a.x_ss, valid, P, P);
  load_tile(dyt, in.dy, a.dy_ss, in.dy ? valid : 0, P, P);
  load_tile(ct, in.cm, a.c_ss, valid, N, NP);
  load_tile(bt, in.bm, a.b_ss, valid, N, NP);
  if constexpr (kMma) {
    land(G);
  } else {
    load_rows(G, N, P, P, N, NP, [&](int p, int n, float v) { gh.set(p, n, v); });
  }
  load_decay(a, b, h, t0, valid, dt_s, acum_s);
  if constexpr (kMma) {
    cp_async_wait<0>();
    __syncthreads();
    for (int i = tid; i < P * NP; i += kThreads) gh.set(i / NP, i % NP, stage[i]);
    __syncthreads();
    land(H);
  }
  __syncthreads();
  const double tot = acum_s[kQ - 1];
  if (tid < kQ) {
    ecum_s[tid] = expf(static_cast<float>(acum_s[tid]));
    etail_s[tid] = expf(static_cast<float>(tot - acum_s[tid]));
  }
  float acc[kAcc];
  // C·Bᵀ, and K = L ∘ dt_s ∘ dY·Xᵀ on and below the diagonal (selected
  // before the exp, whose argument is positive above it), 0 above.
  zero(acc);
  gemm<kMma, false, false>(acc, kQ, kQ, NP, ct, bt);
  for_each<kMma>(acc, kQ, kQ, [&](int t, int s, float& v) { cbf[t * qf + s] = v; });
  zero(acc);
  gemm<kMma, false, false>(acc, kQ, kQ, P, dyt, xt);
  for_each<kMma>(acc, kQ, kQ, [&](int t, int s, float& v) {
    const float k =
        s <= t ? expf(static_cast<float>(acum_s[t] - acum_s[s])) * dt_s[s] * v : 0.f;
    kf[t * qf + s] = k;
    if constexpr (kMma) s2.set(t, s, k);
  });
  __syncthreads();
  if (tid < kQ) {
    float r = 0.f;
    for (int s = 0; s <= tid; ++s) r += cbf[tid * qf + s] * kf[tid * qf + s];
    rowt_s[tid] = r;
  } else if (tid < 2 * kQ) {
    const int s = tid - kQ;
    float r = 0.f;
    for (int t = s; t < kQ; ++t) r += cbf[t * qf + s] * kf[t * qf + s];
    colt_s[s] = r;
  } else if (tid < 3 * kQ) {
    const int t = tid - 2 * kQ;
    float r = 0.f;
    for (int p = 0; p < P; ++p) r += dyt.get(t, p) * xt.get(t, p);
    dyx_s[t] = r;
  }
  __syncthreads();
  for (int i = tid; i < kQ * kQ; i += kThreads) {
    const int t = i / kQ, s = i % kQ;
    s1.set(t, s, s <= t ? expf(static_cast<float>(acum_s[t] - acum_s[s])) * cbf[t * qf + s]
                        : 0.f);
  }
  __syncthreads();

  // U = exp(tot − cum) ∘ B·Gᵀ + (C·Bᵀ ∘ L)ᵀ dY, (kQ x P); dx = dt·U + D·dy.
  zero(acc);
  gemm<kMma, false, false>(acc, kQ, P, NP, bt, gh);
  for_each<kMma>(acc, kQ, P, [&](int m, int, float& v) { v *= etail_s[m]; });
  gemm<kMma, true, true>(acc, kQ, P, kQ, s1, dyt);
  T* dx = static_cast<T*>(a.dx) + ((long long)b * a.S + t0) * a.H * P + (long long)h * P;
  const float Dh = a.D[h];
  for_each<kMma>(acc, kQ, P, [&](int m, int n, float& v) {
    u_s[m * uf + n] = v;
    if (m < valid) dx[(long long)m * a.H * P + n] = from_float<T>(dt_s[m] * v + Dh * dyt.get(m, n));
  });
  __syncthreads();
  if (tid < kQ) {
    float r = 0.f;
    for (int p = 0; p < P; ++p) r += xt.get(tid, p) * u_s[tid * uf + p];
    xu_s[tid] = r;
  }

  // This head's dB = dt·exp(tot − cum) ∘ X·G + Kᵀ C, (kQ x N).
  const long long part_row = (long long)a.H * N;
  float* part = a.parts + ((long long)b * a.S + t0) * part_row + (long long)h * N;
  zero(acc);
  gemm<kMma, false, true>(acc, kQ, NP, P, xt, gh);
  for_each<kMma>(acc, kQ, NP, [&](int m, int, float& v) { v *= dt_s[m] * etail_s[m]; });
  gemm<kMma, true, true>(acc, kQ, NP, kQ, s2, ct);
  for_each<kMma>(acc, kQ, NP, [&](int m, int n, float& v) {
    if (m < valid && n < N) part[m * part_row + n] = v;
  });
  __syncthreads();

  // H in place of G, and ⟨G, H⟩ on the way.
  float ghs = 0.f;
  const auto swap_in = [&](int p, int n, float v) {
    ghs += gh.get(p, n) * v;
    gh.set(p, n, v);
  };
  if constexpr (kMma) {
    cp_async_wait<0>();
    __syncthreads();
    for (int i = tid; i < P * NP; i += kThreads) swap_in(i / NP, i % NP, stage[i]);
  } else {
    load_rows(H, N, P, P, N, NP, swap_in);
  }
  red_s[tid] = ghs;
  __syncthreads();
  // H C into u_s (kQ x P), and this head's dC = exp(cum) ∘ dY·H + K B.
  zero(acc);
  gemm<kMma, false, false>(acc, kQ, P, NP, ct, gh);
  for_each<kMma>(acc, kQ, P, [&](int m, int n, float& v) { u_s[m * uf + n] = v; });
  zero(acc);
  gemm<kMma, false, true>(acc, kQ, NP, P, dyt, gh);
  for_each<kMma>(acc, kQ, NP, [&](int m, int, float& v) { v *= ecum_s[m]; });
  gemm<kMma, false, true>(acc, kQ, NP, kQ, s2, bt);
  part += (long long)a.B * a.S * part_row;
  for_each<kMma>(acc, kQ, NP, [&](int m, int n, float& v) {
    if (m < valid && n < N) part[m * part_row + n] = v;
  });
  __syncthreads();
  if (tid < kQ) {
    float r = 0.f;
    for (int p = 0; p < P; ++p) r += dyt.get(tid, p) * u_s[tid * uf + p];
    inter_s[tid] = ecum_s[tid] * r;
  }
  __syncthreads();

  // dcum, its suffix sums da within the chunk, ddt, and the chunk's sums.
  if (tid < 32) {
    const int lane = tid;
    double gsum = 0.0;
    for (int k = lane; k < kThreads; k += 32) gsum += red_s[k];
    gsum = warp_sum(gsum);
    double dcum[2], side = 0.0, sdyx = 0.0;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int t = 2 * lane + e;
      const double dxu = static_cast<double>(dt_s[t]) * xu_s[t];
      dcum[e] = static_cast<double>(rowt_s[t]) + inter_s[t] - dxu;
      side += dxu - colt_s[t];
      sdyx += dyx_s[t];
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
            static_cast<float>(xu_s[t] + Ah * da[e]);
      sda += dt_s[t] * da[e];
    }
    sda = warp_sum(sda);
    sdyx = warp_sum(sdyx);
    if (lane == 0) {
      const long long i = ((long long)b * a.nc + c) * a.H + h;
      a.ad[i] = static_cast<float>(sda);
      a.ad[(long long)a.B * a.nc * a.H + i] = static_cast<float>(sdyx);
    }
  }
}

// Pass 4: dB and dC over the heads, one thread per (batch row, position,
// n); the last block takes dA and dD over (batch row, chunk).
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_reduce_kernel(BwdArgs a) {
  if (blockIdx.x == gridDim.x - 1) {
    const long long stride = (long long)a.B * a.nc * a.H;
    for (int h = threadIdx.x; h < a.H; h += kThreads) {
      double sa = 0.0, sd = 0.0;
      for (long long i = h; i < stride; i += a.H) {
        sa += a.ad[i];
        sd += a.ad[stride + i];
      }
      a.dA[h] = static_cast<float>(sa);
      a.dD[h] = static_cast<float>(sd);
    }
    return;
  }
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long bsn = (long long)a.B * a.S * a.N;
  if (e >= bsn) return;
  const long long bs = e / a.N;
  const float* pb = a.parts + bs * a.H * a.N + e % a.N;
  const float* pc = pb + bsn * a.H;
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < a.H; ++h) {
    sb += pb[(long long)h * a.N];
    sc += pc[(long long)h * a.N];
  }
  static_cast<T*>(a.dBm)[e] = from_float<T>(sb);
  static_cast<T*>(a.dCm)[e] = from_float<T>(sc);
}

template <typename T>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  const size_t smem1 = states_smem<T>(a.P, a.NP);
  const size_t smem3 = grads_smem<T>(a.P, a.NP);
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_states_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_bwd_grads_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem3);
  if (err != cudaSuccess) return err;
  const dim3 chunks(a.nc, a.H, a.B);
  ssd_bwd_states_kernel<T><<<chunks, kThreads, smem1, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_passing_kernel<<<dim3((a.P * a.N / 4 + kThreads - 1) / kThreads, a.H, a.B), kThreads,
                           0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_grads_kernel<T><<<chunks, kThreads, smem3, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long bsn = (long long)a.B * a.S * a.N;
  ssd_bwd_reduce_kernel<T><<<(unsigned)((bsn + kThreads - 1) / kThreads + 1), kThreads, 0,
                             stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// dtype (of x, dy, B and C, and of dx, dB and dC): 0 = float32 (FMA),
// 1 = bfloat16 (mma.sync).  dt, A, D, h0, dh_final, ddt, dA, dD, dh0 and the
// scratch are float32; h0, dy, dh_final and dh0 may be null (dh0 is written
// where it is not).  Strides are in elements; the last dimension of x, dt, B,
// C and dy is contiguous; the outputs are contiguous.  Scratch: states (2, B,
// H, ⌈S/64⌉, P, N), a_tot (B, H, ⌈S/64⌉), parts (2, B, S, H, N), ad (2, B,
// ⌈S/64⌉, H).  P is 16, 32 or 64 and N at most 128.  Four launches on
// `stream`; returns the CUDA error of the launches (0 on success).
extern "C" int repro_ssd_scan_bwd(
    const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
    const float* D, const float* h0, const void* dy, const float* dh_final, void* dx, float* ddt,
    float* dA, void* dBm, void* dCm, float* dD, float* dh0, float* states, float* a_tot,
    float* parts, float* ad, int dtype, int B, int S, int H, int P, int N, long long x_sb,
    long long x_ss, long long x_sh, long long dt_sb, long long dt_ss, long long b_sb,
    long long b_ss, long long c_sb, long long c_ss, long long dy_sb, long long dy_ss,
    long long dy_sh, void* stream) {
  if (S < 1 || N < 1 || N > 128 || (P != 16 && P != 32 && P != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  repro::BwdArgs a;
  a.x = x;
  a.dt = dt;
  a.A = A;
  a.Bm = Bm;
  a.Cm = Cm;
  a.D = D;
  a.h0 = h0;
  a.dy = dy;
  a.dh_final = dh_final;
  a.dx = dx;
  a.ddt = ddt;
  a.dA = dA;
  a.dBm = dBm;
  a.dCm = dCm;
  a.dD = dD;
  a.dh0 = dh0;
  a.states = states;
  a.a_tot = a_tot;
  a.parts = parts;
  a.ad = ad;
  a.B = B;
  a.S = S;
  a.H = H;
  a.P = P;
  a.N = N;
  a.NP = (N + 15) / 16 * 16;
  a.nc = (S + repro::kQ - 1) / repro::kQ;
  a.x_sb = x_sb;
  a.x_ss = x_ss;
  a.x_sh = x_sh;
  a.dt_sb = dt_sb;
  a.dt_ss = dt_ss;
  a.b_sb = b_sb;
  a.b_ss = b_ss;
  a.c_sb = c_sb;
  a.c_ss = c_ss;
  a.dy_sb = dy_sb;
  a.dy_ss = dy_ss;
  a.dy_sh = dy_sh;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(repro::launch_bwd<float>(a, st));
  if (dtype == 1) return static_cast<int>(repro::launch_bwd<__nv_bfloat16>(a, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
