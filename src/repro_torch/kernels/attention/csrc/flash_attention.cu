// Flash attention (prefill) in float32 for Hopper (sm_90a): GQA, causal /
// sliding window / q_offset masks, online softmax in float32.
//
// Replaces: src/repro/kernels/attention/flash_attention.py::flash_attention
// (Pallas body `_kernel`), which walks a (B, H, nq, nk) grid with the K/V
// tile index innermost and (acc, m, l) carried in VMEM scratch.  This file
// is the float32 route; bfloat16 goes to the tensor-core kernel in
// flash_attention_sm90.cu (the wrapper picks the route by dtype).  A TF32
// product would miss float32's tolerance, so float32 stays on the FMA pipes.
//
// What bounds it on an H100: operations.  At prefill lengths of a few
// hundred tokens and more, 4·S_q·S_kv·D flops (halved when causal) against
// (2·S_q·H + 2·S_kv·KV)·D elements moved puts it far above the ridge; the
// least time is the flops over the 67 TFLOP/s float32 FMA peak.
//
// What the design does about it:
//   * One block per (q tile of 64 rows, q head, batch row).  The K/V head is
//     h / G, read through the (B, S, KV, D) strides, so K/V are never
//     repeated or transposed in device memory.
//   * The Q tile is staged once in shared memory; K and V tiles of 32 rows
//     are staged in turn with 16-byte loads.  Rows are padded by one float
//     so that the column reads below hit distinct banks.
//   * 128 threads as a 16 x 8 grid: each thread owns a 4 x 4 block of the
//     score tile (register reuse: 8 shared loads per 16 FMAs) and 4 rows x
//     D/8 columns of the output accumulator.  Row max and row sum are
//     reduced across the 8 lanes of a row with shuffles.
//   * Tiles wholly outside the causal diagonal or the window are never
//     visited (the loop bounds come from the masks); ragged tile edges are
//     masked in the kernel and out-of-range rows are loaded as zeros, so the
//     wrapper makes no padded copies.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 32;         // keys per K/V tile
constexpr int kThreads = 128;
constexpr int kTX = 8;          // threads along keys / output columns
constexpr int kTY = 16;         // threads along query rows
constexpr int kRM = kBQ / kTY;  // query rows per thread
constexpr int kKN = kBK / kTX;  // keys per thread
static_assert(kTX * kTY == kThreads, "thread grid");

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, S_q, S_kv, H, KV, G;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int causal, window, q_offset;
  float scale;
};

__host__ __device__ constexpr int smem_floats(int D) {
  return kBQ * (D + 1) + 2 * kBK * (D + 1) + kBQ * (kBK + 1);
}

// rows x D tile starting at sequence row `row0` -> shared (row stride D + 1),
// float32; rows at or past `rows_total` are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long row_stride,
                                          int row0, int rows_total, int rows) {
  constexpr int VEC = Vec<T>::N;
  constexpr int PER_ROW = D / VEC;
  for (int idx = threadIdx.x; idx < rows * PER_ROW; idx += kThreads) {
    const int r = idx / PER_ROW;
    const int c = (idx % PER_ROW) * VEC;
    float tmp[VEC];
    if (row0 + r < rows_total) {
      Vec<T>::load(src + (long long)(row0 + r) * row_stride + c, tmp);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) tmp[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[r * (D + 1) + c + i] = tmp[i];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_kernel(FlashArgs a) {
  constexpr int DP = D + 1;
  constexpr int PP = kBK + 1;
  constexpr int DN = D / kTX;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * DP;
  float* sV = sK + kBK * DP;
  float* sP = sV + kBK * DP;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / a.G;
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;

  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  load_tile<T, D>(sQ, qb, a.q_ss, q0, a.S_q, kBQ);

  // Key range any row of this tile can see.
  const int q_first = q0 + a.q_offset;
  const int q_last = min(q0 + kBQ, a.S_q) - 1 + a.q_offset;
  int k_end = a.S_kv;
  if (a.causal) k_end = min(k_end, q_last + 1);
  const int k_begin = a.window > 0 ? max(0, q_first - a.window + 1) : 0;
  const int t_begin = k_begin / kBK;
  const int t_end = k_end > 0 ? (k_end + kBK - 1) / kBK : 0;

  float m[kRM], l[kRM], acc[kRM][DN];
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DN; ++c) acc[i][c] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's readers are done (and sQ is loaded)
    load_tile<T, D>(sK, kb, a.k_ss, k0, a.S_kv, kBK);
    load_tile<T, D>(sV, vb, a.v_ss, k0, a.S_kv, kBK);
    __syncthreads();

    float s[kRM][kKN];
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < kKN; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[kRM], kv[kKN];
#pragma unroll
      for (int i = 0; i < kRM; ++i) qv[i] = sQ[(ty * kRM + i) * DP + d];
#pragma unroll
      for (int j = 0; j < kKN; ++j) kv[j] = sK[(tx + j * kTX) * DP + d];
#pragma unroll
      for (int i = 0; i < kRM; ++i)
#pragma unroll
        for (int j = 0; j < kKN; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      const int qp = q0 + ty * kRM + i + a.q_offset;
      float rmax = kNegInf;
      bool ok[kKN];
#pragma unroll
      for (int j = 0; j < kKN; ++j) {
        const int kp = k0 + tx + j * kTX;
        ok[j] = kp < a.S_kv && (!a.causal || kp <= qp) && (a.window <= 0 || kp > qp - a.window);
        s[i][j] = ok[j] ? s[i][j] * a.scale : kNegInf;
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < kKN; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        rsum += p;
        sP[(ty * kRM + i) * PP + tx + j * kTX] = p;
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DN; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[kRM];
#pragma unroll
      for (int i = 0; i < kRM; ++i) pv[i] = sP[(ty * kRM + i) * PP + j];
#pragma unroll
      for (int c = 0; c < DN; ++c) {
        const float vv = sV[j * DP + tx + c * kTX];
#pragma unroll
        for (int i = 0; i < kRM; ++i) acc[i][c] += pv[i] * vv;
      }
    }
  }

  T* ob = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int row = q0 + ty * kRM + i;
    if (row < a.S_q) {
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < DN; ++c)
        ob[(long long)row * a.o_ss + tx + c * kTX] = from_float<T>(acc[i][c] / denom);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const FlashArgs& a, cudaStream_t stream) {
  const int smem = smem_floats(D) * static_cast<int>(sizeof(float));
  cudaError_t err =
      cudaFuncSetAttribute(flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S_q + kBQ - 1) / kBQ, a.H, a.B);
  flash_kernel<T, D><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const FlashArgs& a, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

// float32 only.  q (B,S_q,H,D), k/v (B,S_kv,KV,D), o
// (B,S_q,H,D); strides in elements, last dimension contiguous.  Returns the
// CUDA error of the launch (0 on success).
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int B, int S_q, int S_kv,
    int H, int KV, int D, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, int causal, int window, int q_offset,
    float scale, void* stream) {
  repro::FlashArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.B = B;
  a.S_q = S_q;
  a.S_kv = S_kv;
  a.H = H;
  a.KV = KV;
  a.G = H / KV;
  a.q_sb = q_sb;
  a.q_ss = q_ss;
  a.q_sh = q_sh;
  a.k_sb = k_sb;
  a.k_ss = k_ss;
  a.k_sh = k_sh;
  a.v_sb = v_sb;
  a.v_ss = v_ss;
  a.v_sh = v_sh;
  a.o_sb = o_sb;
  a.o_ss = o_ss;
  a.o_sh = o_sh;
  a.causal = causal;
  a.window = window;
  a.q_offset = q_offset;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(repro::launch_d<float>(a, D, st));
}
