// Mamba-2 SSD chunked scan for Hopper (sm_90a), float32 inputs.  bfloat16
// inputs take the one-launch tensor-core kernel of ssd_scan_sm90.cu.
//
// Replaces: src/repro/kernels/ssd/ssd_scan.py::ssd (Pallas body `_kernel`),
// which walks the chunks of one (batch, head) in order along a sequential
// grid axis with the (P, N) state in VMEM, and adds the h0 read-out outside
// the kernel.
//
// What bounds it on an H100: at mamba2-370m's prefill shapes (H 32, P 64,
// N 128, bf16) the scan moves ~8.8 KB per token (x, y, dt, B, C) plus 1 MB
// of final state, and does 2·Q·(Q·N + Q·P + 2·N·P) flops per (head, chunk)
// of Q = 128.  Bytes bound it at short S (~1.6 µs at S = 512); at S = 8192
// bytes and tensor-core flops are about even (~22 µs).  This kernel does its
// products on the FMA pipes in float32, so it is far from either bound: it
// is the simple, correct first version.
//
// What the design does about it (chunk-parallel, the decomposition of
// ref.ssd_chunked, in three launches on one stream):
//   1. chunk_state: one block per (chunk, head, batch row) computes the
//      chunk's own contribution to the state, Σ_s exp(a_tot − a_cum_s)·dt_s
//      · x_s ⊗ B_s (P × N), and a_tot, into float32 scratch.
//   2. state_passing: one thread per (batch, head, p, n) walks the chunks in
//      order, h ← exp(a_tot)·h + state; it leaves the state entering each
//      chunk in the scratch, and writes the final state.  h0 is the initial
//      value of this walk (the reference adds its read-out outside its
//      kernel; the sum is the same in another order).
//   3. chunk_scan: one block per (chunk, head, batch row) computes
//      y = (C·Bᵀ ∘ exp(segsum) ∘ dt)·x + exp(a_cum)·C·h_prevᵀ + D·x and
//      writes it in x's dtype.
// The TPU walks (b, h) pairs in order; on the card B·H = 32 pairs would fill
// 32 of 132 SMs.  Cutting by chunk instead gives B·H·⌈S/64⌉ blocks: 256 at
// S = 512 for passes 1 and 3 (all in flight: pass 3 fits two blocks per SM),
// and B·H·P·N/256 = 1024 blocks for pass 2.
//
// Shared memory: the internal chunk is kQ = 64 whatever the caller's chunk
// (the function does not depend on it).  Pass 3 holds C, then B, then h_prev
// (rows padded to N + 1 floats against bank conflicts), x and the (kQ, kQ)
// gate in float32: 97 KB at N = 128, P = 64, set through
// cudaFuncAttributeMaxDynamicSharedMemorySize; pass 1 holds x·w and B: 49 KB.
//
// Precision: the within-chunk cumsum a_cum is kept in double.  In float32,
// a_cum_t − a_cum_s for nearby t, s cancels: at |a_cum| ≈ 60 its rounding
// alone moved y by ~20 float32 steps.  The differences are taken in double
// and rounded once before expf; products and sums are float32.
//
// The masked upper triangle is selected before the exp (exp of a positive
// segment sum could overflow, and inf·0 is NaN).  A ragged last chunk reads
// dt = 0 and x = B = C = 0 past S, so it adds nothing to the state, and its
// rows past S are not written.
#include "../../attention/csrc/common.cuh"

namespace repro {
namespace {

constexpr int kQ = 64;           // internal chunk length
constexpr int kThreads = 256;    // a 16 x 16 grid of threads
constexpr int kMaxNJ = 8;        // N <= 16 * kMaxNJ = 128

struct SsdArgs {
  const void* x;      // (B, S, H, P), last dim contiguous
  const float* dt;    // (B, S, H), last dim contiguous
  const float* A;     // (H,)
  const void* Bm;     // (B, S, N), last dim contiguous
  const void* Cm;     // (B, S, N), last dim contiguous
  const float* D;     // (H,)
  const float* h0;    // (B, H, P, N) or null
  void* y;            // (B, S, H, P) contiguous
  float* h_final;     // (B, H, P, N)
  float* states;      // (B, H, nc, P, N) scratch
  float* a_tot;       // (B, H, nc) scratch
  int B, S, H, P, N, nc;
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss;
  long long b_sb, b_ss;
  long long c_sb, c_ss;
};

// dt of the chunk (0 past S) and a_cum, the inclusive cumsum of the float32
// products A·dt over the chunk in double, into shared memory; warp 0 does it
// with one shuffle scan.
__device__ void load_decay(const SsdArgs& a, int b, int h, int t0, int valid, float* dt_s,
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

// Pass 1: the chunk's own state contribution (P, N) and its a_tot.
template <typename T, int PJ>
__global__ void __launch_bounds__(kThreads) chunk_state_kernel(SsdArgs a) {
  constexpr int P = 16 * PJ;
  extern __shared__ float smem[];
  double* acum_s = reinterpret_cast<double*>(smem);  // kQ
  float* dt_s = smem + 2 * kQ;     // kQ
  float* xw_s = dt_s + kQ;         // kQ x P: x_s · exp(a_tot − a_cum_s) · dt_s
  float* b_s = xw_s + kQ * P;      // kQ x N
  const int N = a.N;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * kQ;
  const int valid = min(kQ, a.S - t0);

  load_decay(a, b, h, t0, valid, dt_s, acum_s);
  __syncthreads();
  const double a_tot = acum_s[kQ - 1];
  const T* x = static_cast<const T*>(a.x) + b * a.x_sb + h * a.x_sh;
  for (int i = threadIdx.x; i < kQ * P; i += kThreads) {
    const int t = i / P, p = i % P;
    xw_s[i] = t < valid
        ? to_float(x[(long long)(t0 + t) * a.x_ss + p])
              * (expf(static_cast<float>(a_tot - acum_s[t])) * dt_s[t])
        : 0.f;
  }
  const T* bm = static_cast<const T*>(a.Bm) + b * a.b_sb;
  for (int i = threadIdx.x; i < kQ * N; i += kThreads) {
    const int t = i / N, n = i % N;
    b_s[i] = t < valid ? to_float(bm[(long long)(t0 + t) * a.b_ss + n]) : 0.f;
  }
  __syncthreads();

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;  // rows p = ty + 16i, cols n = tx + 16j
  float acc[PJ][kMaxNJ];
#pragma unroll
  for (int i = 0; i < PJ; ++i)
#pragma unroll
    for (int j = 0; j < kMaxNJ; ++j) acc[i][j] = 0.f;
  for (int s = 0; s < valid; ++s) {
    float xv[PJ], bv[kMaxNJ];
#pragma unroll
    for (int i = 0; i < PJ; ++i) xv[i] = xw_s[s * P + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < kMaxNJ; ++j) {
      const int n = tx + 16 * j;
      bv[j] = n < N ? b_s[s * N + n] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < PJ; ++i)
#pragma unroll
      for (int j = 0; j < kMaxNJ; ++j) acc[i][j] += xv[i] * bv[j];
  }
  const long long bhc = ((long long)b * a.H + h) * a.nc + c;
  float* st = a.states + bhc * P * N;
#pragma unroll
  for (int i = 0; i < PJ; ++i)
#pragma unroll
    for (int j = 0; j < kMaxNJ; ++j) {
      const int n = tx + 16 * j;
      if (n < N) st[(ty + 16 * i) * N + n] = acc[i][j];
    }
  if (threadIdx.x == 0) a.a_tot[bhc] = static_cast<float>(a_tot);
}

// Pass 2: the state entering each chunk (in place of the chunk's own
// contribution) and the final state; one thread per (p, n) of one (b, h).
__global__ void __launch_bounds__(kThreads) state_passing_kernel(SsdArgs a) {
  const int PN = a.P * a.N;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= PN) return;
  const long long bh = (long long)blockIdx.z * a.H + blockIdx.y;
  float hs = a.h0 != nullptr ? a.h0[bh * PN + e] : 0.f;
  float* st = a.states + bh * a.nc * PN + e;
  const float* at = a.a_tot + bh * a.nc;
  for (int c = 0; c < a.nc; ++c) {
    const float contrib = st[(long long)c * PN];
    st[(long long)c * PN] = hs;
    hs = expf(at[c]) * hs + contrib;
  }
  a.h_final[bh * PN + e] = hs;
}

// Pass 3: y of one chunk from its inputs and the state entering it.
template <typename T, int PJ>
__global__ void __launch_bounds__(kThreads) chunk_scan_kernel(SsdArgs a) {
  constexpr int P = 16 * PJ;
  constexpr int WS = kQ + 1;       // row stride of the gate
  extern __shared__ float smem[];
  const int N = a.N;
  const int NS = N + 1;            // row stride of C, B and h_prev
  double* acum_s = reinterpret_cast<double*>(smem);  // kQ
  float* dt_s = smem + 2 * kQ;     // kQ
  float* x_s = dt_s + kQ;          // kQ x P
  float* w_s = x_s + kQ * P;       // kQ x WS: gated C·Bᵀ, zero above the diagonal
  float* c_s = w_s + kQ * WS;      // kQ x NS
  float* bh_s = c_s + kQ * NS;     // kQ x NS: B, then the (P <= kQ) rows of h_prev
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * kQ;
  const int valid = min(kQ, a.S - t0);

  load_decay(a, b, h, t0, valid, dt_s, acum_s);
  const T* x = static_cast<const T*>(a.x) + b * a.x_sb + h * a.x_sh;
  for (int i = threadIdx.x; i < kQ * P; i += kThreads) {
    const int t = i / P, p = i % P;
    x_s[i] = t < valid ? to_float(x[(long long)(t0 + t) * a.x_ss + p]) : 0.f;
  }
  const T* bm = static_cast<const T*>(a.Bm) + b * a.b_sb;
  const T* cm = static_cast<const T*>(a.Cm) + b * a.c_sb;
  for (int i = threadIdx.x; i < kQ * N; i += kThreads) {
    const int t = i / N, n = i % N;
    const bool ok = t < valid;
    c_s[t * NS + n] = ok ? to_float(cm[(long long)(t0 + t) * a.c_ss + n]) : 0.f;
    bh_s[t * NS + n] = ok ? to_float(bm[(long long)(t0 + t) * a.b_ss + n]) : 0.f;
  }
  __syncthreads();

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  // The gate W[t][s] = (C_t·B_s)·exp(a_cum_t − a_cum_s)·dt_s for s <= t;
  // rows t = ty + 16i, columns s = tx + 16j.
  {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int n = 0; n < N; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) cv[i] = c_s[(ty + 16 * i) * NS + n];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bh_s[(tx + 16 * j) * NS + n];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += cv[i] * bv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = ty + 16 * i, s = tx + 16 * j;
        w_s[t * WS + s] =
            s <= t ? acc[i][j] * expf(static_cast<float>(acum_s[t] - acum_s[s])) * dt_s[s] : 0.f;
      }
  }
  __syncthreads();  // B is no longer read: its rows take h_prev
  const float* hp = a.states + (((long long)b * a.H + h) * a.nc + c) * P * N;
  for (int i = threadIdx.x; i < P * N; i += kThreads) bh_s[(i / N) * NS + i % N] = hp[i];
  __syncthreads();

  // y[t][p] for rows t = ty + 16i and columns p = tx + 16j.
  float yi[4][PJ], yo[4][PJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < PJ; ++j) yi[i][j] = yo[i][j] = 0.f;
  for (int s = 0; s < valid; ++s) {
    float wv[4], xv[PJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) wv[i] = w_s[(ty + 16 * i) * WS + s];
#pragma unroll
    for (int j = 0; j < PJ; ++j) xv[j] = x_s[s * P + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < PJ; ++j) yi[i][j] += wv[i] * xv[j];
  }
  for (int n = 0; n < N; ++n) {
    float cv[4], hv[PJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) cv[i] = c_s[(ty + 16 * i) * NS + n];
#pragma unroll
    for (int j = 0; j < PJ; ++j) hv[j] = bh_s[(tx + 16 * j) * NS + n];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < PJ; ++j) yo[i][j] += cv[i] * hv[j];
  }
  T* y = static_cast<T*>(a.y) + ((long long)b * a.S + t0) * a.H * P + (long long)h * P;
  const float Dh = a.D[h];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = ty + 16 * i;
    if (t < valid) {
      const float decay_in = expf(static_cast<float>(acum_s[t]));
#pragma unroll
      for (int j = 0; j < PJ; ++j) {
        const int p = tx + 16 * j;
        y[(long long)t * a.H * P + p] =
            from_float<T>(yi[i][j] + decay_in * yo[i][j] + Dh * x_s[t * P + p]);
      }
    }
  }
}

template <typename T, int PJ>
cudaError_t launch(const SsdArgs& a, cudaStream_t stream) {
  constexpr int P = 16 * PJ;
  // a_cum (kQ doubles) and dt, then each pass's tiles, in float32 words.
  const size_t smem1 = sizeof(float) * (3 * kQ + kQ * P + kQ * a.N);
  const size_t smem3 = sizeof(float) * (3 * kQ + kQ * P + kQ * (kQ + 1) + 2 * kQ * (a.N + 1));
  cudaError_t err = cudaFuncSetAttribute(chunk_state_kernel<T, PJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(chunk_scan_kernel<T, PJ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem3);
  if (err != cudaSuccess) return err;
  const dim3 chunks(a.nc, a.H, a.B);
  chunk_state_kernel<T, PJ><<<chunks, kThreads, smem1, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  state_passing_kernel<<<dim3((P * a.N + kThreads - 1) / kThreads, a.H, a.B), kThreads, 0,
                         stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  chunk_scan_kernel<T, PJ><<<chunks, kThreads, smem3, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_p(const SsdArgs& a, cudaStream_t stream) {
  switch (a.P) {
    case 16: return launch<T, 1>(a, stream);
    case 32: return launch<T, 2>(a, stream);
    case 64: return launch<T, 4>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

// dtype (of x, B and C): 0 = float32, the only one taken.  dt, A, D, h0 and the
// outputs h_final and the scratch are float32; h0 may be null.  Strides are
// in elements; the last dimension of x, dt, B and C is contiguous, y is
// contiguous (B, S, H, P).  states is (B, H, ⌈S/64⌉, P, N) and a_tot
// (B, H, ⌈S/64⌉).  Returns the CUDA error of the launches (0 on success).
extern "C" int repro_ssd_scan(
    const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
    const float* D, const float* h0, void* y, float* h_final, float* states, float* a_tot,
    int dtype, int B, int S, int H, int P, int N, long long x_sb, long long x_ss,
    long long x_sh, long long dt_sb, long long dt_ss, long long b_sb, long long b_ss,
    long long c_sb, long long c_ss, void* stream) {
  if (S < 1 || N < 1 || N > 16 * repro::kMaxNJ) return static_cast<int>(cudaErrorInvalidValue);
  repro::SsdArgs a;
  a.x = x;
  a.dt = dt;
  a.A = A;
  a.Bm = Bm;
  a.Cm = Cm;
  a.D = D;
  a.h0 = h0;
  a.y = y;
  a.h_final = h_final;
  a.states = states;
  a.a_tot = a_tot;
  a.B = B;
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
  a.b_sb = b_sb;
  a.b_ss = b_ss;
  a.c_sb = c_sb;
  a.c_ss = c_ss;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(repro::launch_p<float>(a, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
