// Mamba-2 SSD scan's backward for float32 inputs on the card: dx, ddt, dA,
// dB, dC, dD and dh0 from the forward's inputs and the cotangents of y (dy)
// and of the final state (dh_final; null in training, where the state is
// discarded).  bfloat16 inputs take ssd_scan_bwd_sm90.cu.
//
// Replaces: nothing on the TPU.  The Pallas kernel
// src/repro/kernels/ssd/ssd_scan.py::ssd has no custom_vjp; jax.grad
// differentiates its plain version, ref.ssd_chunked.  This kernel computes
// that vector-Jacobian product: ref.ssd_bwd_plain writes out the same passes
// in PyTorch.
//
// What bounds it on an H100: operations.  The least work is twice the
// forward's products (52.6 GFLOP at mamba2-370m's 4 x 4096, H 32, P 64, N
// 128) on the FMA pipes at 67 TFLOP/s (a TF32 product would miss float32's
// tolerance).  This kernel keeps the chunk states and their cotangents in
// device memory and sums dB and dC over heads in a second pass; it is off
// the training path, which runs in bf16.
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
//      scratch; dcum_t = Σ_s (C_t·B_s) K[t, s] − Σ_t' (C_t'·B_t) K[t', t] +
//      exp(cum_t) dy_t·(H C_t) − dt_t exp(tot − cum_t) x_t·(G B_t), plus ⟨G,
//      the state leaving the chunk⟩ = exp(tot)·⟨G, H⟩ + Σ_t dt_t exp(tot −
//      cum_t) x_t·(G B_t) at the chunk's end, reverse-summed in double
//      within the chunk into da; ddt = x·U + A·da; the chunk's Σ dt·da and
//      Σ dy·x into scratch.  ref.ssd_bwd_plain writes the same dcum with
//      −dt_t x_t·U_t in place of its second and fourth terms and Σ_t (dt_t
//      x_t·U_t − Σ_t' (C_t'·B_t) K[t', t]) in place of the end's second;
//      in float32 the large parts of those sums cancel, and the rounding
//      left, times Σ dt, would be most of dA's error.
//   4. ssd_bwd_reduce: dB and dC summed over the heads, and dA and dD over
//      the batch rows and chunks, each in a fixed order.
// No atomics: two calls on the same inputs give the same bits.
//
// Products run on the FMA pipes from float tiles in shared memory, loaded
// with 16-byte loads, several in flight per thread; the sums over a chunk
// row that feed dA, dt and dD (rowt, colt, x·U, dy·x, ⟨G, H⟩, dy·(H C))
// add their float products in double, four threads a row (rowt and colt
// add the same float products, so their totals agree).  The within-chunk
// cumsum is kept in double and each decay's difference rounded once before
// the exp, as in the forward kernels.  A ragged last chunk reads dt = 0 and
// x = B = C = dy = 0 past S, so it adds nothing, and its rows past S are
// not written.
#include "../../attention/csrc/common.cuh"

namespace repro {
namespace {

constexpr int kQ = 64;            // internal chunk length
constexpr int kThreads = 256;
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

// A float tile in shared memory, row-major with row stride ld.
struct Tile {
  float* p;
  int ld;
  __device__ __forceinline__ float get(int r, int c) const { return p[r * ld + c]; }
  __device__ __forceinline__ void set(int r, int c, float v) const { p[r * ld + c] = v; }
};

__device__ __forceinline__ void zero(float* acc) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
}

// acc += A · B for A (M x K) stored [m][k], or [k][m] with kAT, and B
// (K x N) stored [n][k], or [k][n] with kBT.  M is 16, 32 or 64, N a
// multiple of 16 up to 128.  Thread (ty, tx) = (tid / 16, tid % 16) owns
// (ty + 16i, tx + 16j) at acc[8i + j].
template <bool kAT, bool kBT>
__device__ __forceinline__ void gemm(float* acc, int M, int N, int K, const Tile A, const Tile B) {
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
}

// f(m, n, v) for each output (m, n) of an M x N product this thread holds.
template <typename F>
__device__ __forceinline__ void for_each(float* acc, int M, int N, F f) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16, mi = M / 16, nj = N / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (i < mi && j < nj) f(ty + 16 * i, tx + 16 * j, acc[8 * i + j]);
}

// Lane-wise sum over the warp, in a fixed order (every lane gets it).
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Σ f(k) over lo <= k < hi in double for one chunk row, four threads a row
// (row threadIdx.x / 4; quarter q = threadIdx.x % 4 takes k ≡ lo + q mod 4),
// the quarters added by shuffles in a fixed order: all four get the same
// bits.  Every thread of the block calls it.
static_assert(kThreads == 4 * kQ, "four threads a chunk row");
template <typename F>
__device__ __forceinline__ double row_sum(int lo, int hi, F f) {
  double r = 0.0;
  for (int k = lo + threadIdx.x % 4; k < hi; k += 4) r += f(k);
  r += __shfl_xor_sync(0xffffffffu, r, 1);
  return r + __shfl_xor_sync(0xffffffffu, r, 2);
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

// `rows` rows of `cols` floats (row stride `rs` in device memory), zero past
// `valid` rows and from `cols` to `cols_pad`: put(row, col, value) for each.
// Where the rows are 16-byte aligned, 16-byte loads; else one value a load.
// Each thread issues kBatch loads before it puts any, so that a block keeps
// that many in flight per thread.
constexpr int kBatch = 4;
template <typename Put>
__device__ __forceinline__ void load_rows(const float* src, long long rs, int rows, int valid,
                                          int cols, int cols_pad, Put put) {
  constexpr int V = Vec<float>::N;
  if (reinterpret_cast<uintptr_t>(src) % 16 == 0 && rs % V == 0 && cols % V == 0) {
    const int per_row = cols_pad / V, total = rows * per_row;
    for (int base = threadIdx.x; base < total; base += kThreads * kBatch) {
      float v[kBatch][V];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * kThreads, t = i / per_row, c = i % per_row * V;
        if (i < total && t < valid && c < cols) {
          Vec<float>::load(src + t * rs + c, v[u]);
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
      v[u] = i < total && t < valid && n < cols ? src[t * rs + n] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch * 2; ++u) {
      const int i = base + u * kThreads;
      if (i < total) put(i / cols_pad, i % cols_pad, v[u]);
    }
  }
}

// An operand's kQ rows into its tile.
__device__ __forceinline__ void load_tile(const Tile& dst, const float* src, long long rs,
                                          int valid, int cols, int cols_pad) {
  load_rows(src, rs, kQ, valid, cols, cols_pad, [&](int t, int n, float v) { dst.set(t, n, v); });
}

struct Operands {  // a block's rows of x, dy, B and C in device memory
  const float *x, *dy, *bm, *cm;
  __device__ Operands(const BwdArgs& a, int b, int h, int t0) {
    x = static_cast<const float*>(a.x) + b * a.x_sb + h * a.x_sh + t0 * a.x_ss;
    dy = a.dy == nullptr
             ? nullptr
             : static_cast<const float*>(a.dy) + b * a.dy_sb + h * a.dy_sh + t0 * a.dy_ss;
    bm = static_cast<const float*>(a.Bm) + b * a.b_sb + t0 * a.b_ss;
    cm = static_cast<const float*>(a.Cm) + b * a.c_sb + t0 * a.c_ss;
  }
};

// Shared memory, in bytes: the vectors, then float tiles, each 16-byte
// aligned, their rows padded by one value.
__host__ __device__ constexpr int round16(int bytes) { return (bytes + 15) / 16 * 16; }
constexpr int kPad = 1;

// Tile views of a bump-allocated region of shared memory.
struct Carve {
  char* base;
  int at;
  __device__ Tile tile(int rows, int ld) {
    auto* p = reinterpret_cast<float*>(base + at);
    at += round16(rows * ld * 4);
    return {p, ld};
  }
  __device__ float* floats(int n) {
    float* p = reinterpret_cast<float*>(base + at);
    at += round16(n * 4);
    return p;
  }
};

// Pass 1's shared memory: cum (double), dt, then x∘w and dy∘exp(cum), B and
// C.
__host__ __device__ constexpr int states_smem(int P, int NP) {
  return round16(3 * kQ * 4) + 2 * round16(kQ * (P + kPad) * 4) +
         2 * round16(kQ * (NP + kPad) * 4);
}

// Pass 1: each chunk's own part of H, (x∘w)ᵀ B, and of G, (dy∘exp(cum))ᵀ C,
// and tot.
__global__ void __launch_bounds__(kThreads) ssd_bwd_states_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  const int P = a.P, N = a.N, NP = a.NP;
  double* acum_s = reinterpret_cast<double*>(smem);  // kQ
  float* dt_s = smem + 2 * kQ;                       // kQ
  Carve mem{reinterpret_cast<char*>(smem), round16(3 * kQ * 4)};
  const Tile xw = mem.tile(kQ, P + kPad);   // x_s·exp(tot − cum_s)·dt_s
  const Tile dyw = mem.tile(kQ, P + kPad);  // dy_t·exp(cum_t)
  const Tile bt = mem.tile(kQ, NP + kPad);
  const Tile ct = mem.tile(kQ, NP + kPad);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * kQ, valid = min(kQ, a.S - t0);
  const Operands in(a, b, h, t0);

  // x and dy land as they are and are scaled below.
  load_tile(xw, in.x, a.x_ss, valid, P, P);
  load_tile(dyw, in.dy, a.dy_ss, in.dy ? valid : 0, P, P);
  load_tile(bt, in.bm, a.b_ss, valid, N, NP);
  load_tile(ct, in.cm, a.c_ss, valid, N, NP);
  load_decay(a, b, h, t0, valid, dt_s, acum_s);
  __syncthreads();
  const double tot = acum_s[kQ - 1];
  for (int i = threadIdx.x; i < kQ * P; i += kThreads) {
    const int t = i / P, p = i % P;
    xw.set(t, p, xw.get(t, p) * (expf(static_cast<float>(tot - acum_s[t])) * dt_s[t]));
    dyw.set(t, p, dyw.get(t, p) * expf(static_cast<float>(acum_s[t])));
  }
  __syncthreads();

  const long long bhc = ((long long)b * a.H + h) * a.nc + c;
  const long long plane = (long long)a.B * a.H * a.nc * P * N;
  float acc[kAcc];
  const auto write = [&](float* out) {
    for_each(acc, P, NP, [&](int m, int n, float& v) {
      if (n < N) out[m * N + n] = v;
    });
  };
  zero(acc);
  gemm<true, true>(acc, P, NP, kQ, xw, bt);
  write(a.states + bhc * P * N);
  zero(acc);
  gemm<true, true>(acc, P, NP, kQ, dyw, ct);
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

// Pass 3's shared memory: seven vectors of kQ doubles (cum and the sums
// below) and one of kThreads, three of kQ floats, then x, dy, C and B, C·Bᵀ
// then C·Bᵀ ∘ L (S1), K (S2), G then H, and last U, then H C.
constexpr int kVecBytes = 7 * kQ * 8 + kThreads * 8 + 3 * kQ * 4;
__host__ __device__ constexpr int grads_smem(int P, int NP) {
  const int xs = P + kPad, ns = NP + kPad, qs = kQ + kPad;
  return kVecBytes + 2 * round16(kQ * xs * 4) + 2 * round16(kQ * ns * 4) +
         2 * round16(kQ * qs * 4) + round16(P * ns * 4) + round16(kQ * (P + 4) * 4);
}

// Pass 3: one chunk of one head of one batch row.
__global__ void __launch_bounds__(kThreads) ssd_bwd_grads_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  const int P = a.P, N = a.N, NP = a.NP;
  const int tid = threadIdx.x;
  double* acum_s = reinterpret_cast<double*>(smem);  // kQ
  double* rowt_s = acum_s + kQ;     // Σ_s (C_t·B_s) K[t, s]
  double* colt_s = rowt_s + kQ;     // Σ_t (C_t·B_s) K[t, s]
  double* xu_s = colt_s + kQ;       // x_t·U_t
  double* xug_s = xu_s + kQ;        // x_t·(exp(tot − cum_t) G B_t), U's part from G
  double* inter_s = xug_s + kQ;     // exp(cum_t) dy_t·(H C_t)
  double* dyx_s = inter_s + kQ;     // dy_t·x_t
  double* red_s = dyx_s + kQ;       // kThreads: ⟨G, H⟩ per thread
  float* dt_s = reinterpret_cast<float*>(red_s + kThreads);  // kQ
  float* ecum_s = dt_s + kQ;        // exp(cum_t)
  float* etail_s = ecum_s + kQ;     // exp(tot − cum_t)
  Carve mem{reinterpret_cast<char*>(smem), kVecBytes};
  const int xs = P + kPad, ns = NP + kPad, qs = kQ + kPad;
  const Tile xt = mem.tile(kQ, xs);
  const Tile dyt = mem.tile(kQ, xs);
  const Tile ct = mem.tile(kQ, ns);
  const Tile bt = mem.tile(kQ, ns);
  const Tile s1 = mem.tile(kQ, qs);   // C·Bᵀ, then C·Bᵀ ∘ L
  const Tile s2 = mem.tile(kQ, qs);   // K
  const Tile gh = mem.tile(P, ns);    // G, then H
  const int qf = qs;
  float *cbf = s1.p, *kf = s2.p;
  const int uf = P + 4;
  float* u_s = mem.floats(kQ * uf);  // U, then H C
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * kQ, valid = min(kQ, a.S - t0);
  const long long bhc = ((long long)b * a.H + h) * a.nc + c;
  const long long plane = (long long)a.B * a.H * a.nc * P * N;
  const Operands in(a, b, h, t0);

  const float* G = a.states + plane + bhc * P * N;
  const float* H = a.states + bhc * P * N;
  load_tile(xt, in.x, a.x_ss, valid, P, P);
  load_tile(dyt, in.dy, a.dy_ss, in.dy ? valid : 0, P, P);
  load_tile(ct, in.cm, a.c_ss, valid, N, NP);
  load_tile(bt, in.bm, a.b_ss, valid, N, NP);
  load_rows(G, N, P, P, N, NP, [&](int p, int n, float v) { gh.set(p, n, v); });
  load_decay(a, b, h, t0, valid, dt_s, acum_s);
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
  gemm<false, false>(acc, kQ, kQ, NP, ct, bt);
  for_each(acc, kQ, kQ, [&](int t, int s, float& v) { cbf[t * qf + s] = v; });
  zero(acc);
  gemm<false, false>(acc, kQ, kQ, P, dyt, xt);
  for_each(acc, kQ, kQ, [&](int t, int s, float& v) {
    const float k =
        s <= t ? expf(static_cast<float>(acum_s[t] - acum_s[s])) * dt_s[s] * v : 0.f;
    kf[t * qf + s] = k;
  });
  __syncthreads();
  const int row = tid / 4;  // this thread's chunk row in row_sum
  {
    const double rowt = row_sum(0, row + 1, [&](int s) {
      return static_cast<double>(cbf[row * qf + s] * kf[row * qf + s]);
    });
    const double colt = row_sum(row, kQ, [&](int t) {
      return static_cast<double>(cbf[t * qf + row] * kf[t * qf + row]);
    });
    const double dyx = row_sum(0, P, [&](int p) {
      return static_cast<double>(dyt.get(row, p) * xt.get(row, p));
    });
    if (tid % 4 == 0) {
      rowt_s[row] = rowt;
      colt_s[row] = colt;
      dyx_s[row] = dyx;
    }
  }
  __syncthreads();
  for (int i = tid; i < kQ * kQ; i += kThreads) {
    const int t = i / kQ, s = i % kQ;
    s1.set(t, s, s <= t ? expf(static_cast<float>(acum_s[t] - acum_s[s])) * cbf[t * qf + s]
                        : 0.f);
  }
  __syncthreads();

  // U = exp(tot − cum) ∘ B·Gᵀ + (C·Bᵀ ∘ L)ᵀ dY, (kQ x P); dx = dt·U + D·dy.
  // x·U's first part on its own (xug) as well.
  zero(acc);
  gemm<false, false>(acc, kQ, P, NP, bt, gh);
  for_each(acc, kQ, P, [&](int m, int n, float& v) {
    v *= etail_s[m];
    u_s[m * uf + n] = v;
  });
  __syncthreads();
  const auto xu_row = [&]() {
    return row_sum(0, P, [&](int p) {
      return static_cast<double>(xt.get(row, p) * u_s[row * uf + p]);
    });
  };
  {
    const double r = xu_row();
    if (tid % 4 == 0) xug_s[row] = r;
  }
  __syncthreads();
  gemm<true, true>(acc, kQ, P, kQ, s1, dyt);
  float* dx =
      static_cast<float*>(a.dx) + ((long long)b * a.S + t0) * a.H * P + (long long)h * P;
  const float Dh = a.D[h];
  for_each(acc, kQ, P, [&](int m, int n, float& v) {
    u_s[m * uf + n] = v;
    if (m < valid) dx[(long long)m * a.H * P + n] = dt_s[m] * v + Dh * dyt.get(m, n);
  });
  __syncthreads();
  {
    const double r = xu_row();
    if (tid % 4 == 0) xu_s[row] = r;
  }

  // This head's dB = dt·exp(tot − cum) ∘ X·G + Kᵀ C, (kQ x N).
  const long long part_row = (long long)a.H * N;
  float* part = a.parts + ((long long)b * a.S + t0) * part_row + (long long)h * N;
  zero(acc);
  gemm<false, true>(acc, kQ, NP, P, xt, gh);
  for_each(acc, kQ, NP, [&](int m, int, float& v) { v *= dt_s[m] * etail_s[m]; });
  gemm<true, true>(acc, kQ, NP, kQ, s2, ct);
  for_each(acc, kQ, NP, [&](int m, int n, float& v) {
    if (m < valid && n < N) part[m * part_row + n] = v;
  });
  __syncthreads();

  // H in place of G, and ⟨G, H⟩ on the way.
  double ghs = 0.0;
  const auto swap_in = [&](int p, int n, float v) {
    ghs += static_cast<double>(gh.get(p, n) * v);
    gh.set(p, n, v);
  };
  load_rows(H, N, P, P, N, NP, swap_in);
  red_s[tid] = ghs;
  __syncthreads();
  // H C into u_s (kQ x P), and this head's dC = exp(cum) ∘ dY·H + K B.
  zero(acc);
  gemm<false, false>(acc, kQ, P, NP, ct, gh);
  for_each(acc, kQ, P, [&](int m, int n, float& v) { u_s[m * uf + n] = v; });
  zero(acc);
  gemm<false, true>(acc, kQ, NP, P, dyt, gh);
  for_each(acc, kQ, NP, [&](int m, int, float& v) { v *= ecum_s[m]; });
  gemm<false, true>(acc, kQ, NP, kQ, s2, bt);
  part += (long long)a.B * a.S * part_row;
  for_each(acc, kQ, NP, [&](int m, int n, float& v) {
    if (m < valid && n < N) part[m * part_row + n] = v;
  });
  __syncthreads();
  {
    const double r = row_sum(0, P, [&](int p) {
      return static_cast<double>(dyt.get(row, p) * u_s[row * uf + p]);
    });
    if (tid % 4 == 0) inter_s[row] = ecum_s[row] * r;
  }
  __syncthreads();

  // dcum, its suffix sums da within the chunk, ddt, and the chunk's sums.
  // dt_t x_t·U_t is colt_t, its part within the chunk, plus dt_t xug_t, so
  // dcum takes colt_t and dt_t xug_t where they arise and the chunk's end
  // adds Σ dt xug: no term is the small difference of two large sums.
  if (tid < 32) {
    const int lane = tid;
    double gsum = 0.0;
    for (int k = lane; k < kThreads; k += 32) gsum += red_s[k];
    gsum = warp_sum(gsum);
    double dcum[2], side = 0.0, sdyx = 0.0;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int t = 2 * lane + e;
      const double dxg = static_cast<double>(dt_s[t]) * xug_s[t];
      dcum[e] = rowt_s[t] - colt_s[t] + inter_s[t] - dxg;
      side += dxg;
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
  static_cast<float*>(a.dBm)[e] = sb;
  static_cast<float*>(a.dCm)[e] = sc;
}

cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  const size_t smem1 = states_smem(a.P, a.NP);
  const size_t smem3 = grads_smem(a.P, a.NP);
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_states_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_bwd_grads_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem3);
  if (err != cudaSuccess) return err;
  const dim3 chunks(a.nc, a.H, a.B);
  ssd_bwd_states_kernel<<<chunks, kThreads, smem1, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_passing_kernel<<<dim3((a.P * a.N / 4 + kThreads - 1) / kThreads, a.H, a.B), kThreads,
                           0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_grads_kernel<<<chunks, kThreads, smem3, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long bsn = (long long)a.B * a.S * a.N;
  ssd_bwd_reduce_kernel<<<(unsigned)((bsn + kThreads - 1) / kThreads + 1), kThreads, 0,
                             stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// dtype (of x, dy, B and C, and of dx, dB and dC): 0 = float32, the only
// one this entry takes (bfloat16: repro_ssd_scan_bwd_sm90).  dt, A, D, h0,
// dh_final, ddt, dA, dD, dh0 and the scratch are float32; h0, dy, dh_final
// and dh0 may be null (dh0 is written where it is not).  Strides are in
// elements; the last dimension of x, dt, B, C and dy is contiguous; the
// outputs are contiguous.  Scratch: states (2, B, H, ⌈S/64⌉, P, N), a_tot
// (B, H, ⌈S/64⌉), parts (2, B, S, H, N), ad (2, B, ⌈S/64⌉, H).  P is 16, 32
// or 64 and N at most 128.  Four launches on `stream`; returns the CUDA
// error of the launches (0 on success).
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
  if (dtype == 0) return static_cast<int>(repro::launch_bwd(a, st));
  return static_cast<int>(cudaErrorInvalidValue);  // bf16: ssd_scan_bwd_sm90.cu
}
