// One-token GQA decode attention against a KV cache, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/attention/decode_attention.py::decode_attention
// (Pallas body `_kernel`), which streams the cache block by block along a
// sequential grid axis with (m, l, acc) carried in VMEM scratch.
//
// What bounds it on an H100: bytes.  Each cache entry is read once per kv
// head and used for G = H/KV dot products and G axpys, about 2·G flops per
// byte in bf16 — far below the ~295 flops/byte where the tensor cores would
// become the limit.  The least time is the valid cache bytes over 3.35 TB/s.
//
// What the design does about it (split-K, "flash-decoding"):
//   * At serving shapes B·KV is 8..32, far below the 132 SMs, so the cache
//     is cut into `n_split` chunks along the sequence and every
//     (chunk, kv head, batch row) is a block: enough blocks to keep every
//     SM's memory pipe busy.
//   * A block loads its G query rows once (registers), then streams its
//     chunk of K and V with 16-byte loads.  One cache row is spread over
//     D/VEC lanes; a warp covers 32/(D/VEC) rows at a time, so every load
//     instruction moves 512 contiguous-per-row bytes.
//   * Each row slot keeps float32 running (m, l, acc) per query row; the
//     slots are merged in shared memory and the block writes one partial
//     (m, l, acc) per query row.  A second small kernel combines the chunks.
//   * Chunks at or past min(cache_len[b], S_max), or wholly before the
//     sliding window, read nothing.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kDecodeWarps = 4;
constexpr int kDecodeThreads = kDecodeWarps * 32;
constexpr int kCombineThreads = 128;

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* cache_len;
  void* out;
  float* part_m;    // (B, KV, n_split, G)
  float* part_l;    // (B, KV, n_split, G)
  float* part_acc;  // (B, KV, n_split, G, D)
  int B, H, KV, G, S_max;
  int chunk, n_split, window;
  float scale;
  long long q_sb, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_sh;
};

template <typename T, int D, int GMAX>
__global__ void __launch_bounds__(kDecodeThreads) decode_split_kernel(DecodeArgs a) {
  constexpr int VEC = Vec<T>::N;
  constexpr int LANES = D / VEC;  // lanes that share one cache row
  static_assert(LANES <= 32 && 32 % LANES == 0, "a cache row must fit in one warp");
  constexpr int ROWS_PER_WARP = 32 / LANES;
  constexpr int R = kDecodeWarps * ROWS_PER_WARP;  // rows in flight per block

  const T* __restrict__ q = static_cast<const T*>(a.q);
  const T* __restrict__ k = static_cast<const T*>(a.k);
  const T* __restrict__ v = static_cast<const T*>(a.v);

  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = warp * ROWS_PER_WARP + lane / LANES;  // row slot, 0..R-1
  const int d0 = (lane % LANES) * VEC;                 // this lane's slice of D
  const int G = a.G;

  const int len = a.cache_len[b];
  const int valid_end = min(len, a.S_max);
  const int valid_begin = a.window > 0 ? max(len - a.window, 0) : 0;
  const int c0 = split * a.chunk;
  const int c1 = min(c0 + a.chunk, valid_end);
  const int start = max(c0, valid_begin);

  float qr[GMAX][VEC];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      qr[g][i] = g < G ? to_float(q[b * a.q_sb + (long long)(kvh * G + g) * a.q_sh + d0 + i])
                       : 0.f;
    }
  }

  float m[GMAX], l[GMAX], acc[GMAX][VEC];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[g][i] = 0.f;
  }

  const T* kb = k + b * a.k_sb + kvh * a.k_sh + d0;
  const T* vb = v + b * a.v_sb + kvh * a.v_sh + d0;
  // The trip count is uniform across the block so that every lane reaches
  // the shuffles below; lanes past the chunk's end contribute nothing.
  for (int base = start; base < c1; base += R) {
    const int p = base + row;
    const bool ok = p < c1;
    float kf[VEC], vf[VEC];
    if (ok) {
      Vec<T>::load(kb + (long long)p * a.k_ss, kf);
      Vec<T>::load(vb + (long long)p * a.v_ss, vf);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) kf[i] = vf[i] = 0.f;
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < G) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) s += qr[g][i] * kf[i];
#pragma unroll
        for (int off = LANES / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        if (ok) {
          s *= a.scale;
          const float m_new = fmaxf(m[g], s);
          const float alpha = expf(m[g] - m_new);
          const float pw = expf(s - m_new);
          l[g] = l[g] * alpha + pw;
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[g][i] = acc[g][i] * alpha + pw * vf[i];
          m[g] = m_new;
        }
      }
    }
  }

  // Merge the R row slots, one query row at a time, through shared memory.
  __shared__ float sm_m[R];
  __shared__ float sm_l[R];
  __shared__ float sm_acc[R][D];
  const long long part = ((long long)(b * a.KV + kvh) * a.n_split + split) * G;
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < G) {
      if (lane % LANES == 0) {
        sm_m[row] = m[g];
        sm_l[row] = l[g];
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) sm_acc[row][d0 + i] = acc[g][i];
      __syncthreads();
      for (int d = threadIdx.x; d < D; d += kDecodeThreads) {
        float mm = kNegInf;
        for (int r = 0; r < R; ++r) mm = fmaxf(mm, sm_m[r]);
        float ll = 0.f, aa = 0.f;
        for (int r = 0; r < R; ++r) {
          const float w = expf(sm_m[r] - mm);
          ll += sm_l[r] * w;
          aa += sm_acc[r][d] * w;
        }
        a.part_acc[(part + g) * D + d] = aa;
        if (d == 0) {
          a.part_m[part + g] = mm;
          a.part_l[part + g] = ll;
        }
      }
      __syncthreads();
    }
  }
}

// out[b, h] = Σ_s acc_s·e^(m_s − M) / Σ_s l_s·e^(m_s − M) over the chunks.
// A row with no valid entry (l = 0 everywhere) comes out as zeros, as in the
// TPU kernel.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads) decode_combine_kernel(DecodeArgs a, int D) {
  T* __restrict__ out = static_cast<T*>(a.out);
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / a.G;
  const int g = h % a.G;
  const long long base = (long long)(b * a.KV + kvh) * a.n_split;
  float mm = kNegInf;
  for (int s = 0; s < a.n_split; ++s) mm = fmaxf(mm, a.part_m[(base + s) * a.G + g]);
  for (int d = threadIdx.x; d < D; d += kCombineThreads) {
    float ll = 0.f, aa = 0.f;
    for (int s = 0; s < a.n_split; ++s) {
      const long long idx = (base + s) * a.G + g;
      const float w = expf(a.part_m[idx] - mm);
      ll += a.part_l[idx] * w;
      aa += a.part_acc[idx * D + d] * w;
    }
    out[b * a.o_sb + h * a.o_sh + d] = from_float<T>(aa / fmaxf(ll, 1e-30f));
  }
}

template <typename T, int D, int GMAX>
cudaError_t launch(const DecodeArgs& a, cudaStream_t stream) {
  decode_split_kernel<T, D, GMAX>
      <<<dim3(a.n_split, a.KV, a.B), kDecodeThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T><<<dim3(a.H, a.B), kCombineThreads, 0, stream>>>(a, D);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_g(const DecodeArgs& a, cudaStream_t stream) {
  if (a.G <= 2) return launch<T, D, 2>(a, stream);
  if (a.G <= 4) return launch<T, D, 4>(a, stream);
  if (a.G <= 8) return launch<T, D, 8>(a, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_d(const DecodeArgs& a, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_g<T, 32>(a, stream);
    case 64: return launch_g<T, 64>(a, stream);
    case 128: return launch_g<T, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the last
// dimension of q, the caches and out is contiguous.  Returns the CUDA error
// of the launches (0 on success).
extern "C" int repro_decode_attention(
    const void* q, const void* k_cache, const void* v_cache, const int* cache_len, void* out,
    float* part_m, float* part_l, float* part_acc, int dtype, int B, int H, int KV, int D,
    int S_max, int chunk, int n_split, int window, float scale, long long q_sb, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_sh, void* stream) {
  repro::DecodeArgs a;
  a.q = q;
  a.k = k_cache;
  a.v = v_cache;
  a.cache_len = cache_len;
  a.out = out;
  a.part_m = part_m;
  a.part_l = part_l;
  a.part_acc = part_acc;
  a.B = B;
  a.H = H;
  a.KV = KV;
  a.G = H / KV;
  a.S_max = S_max;
  a.chunk = chunk;
  a.n_split = n_split;
  a.window = window;
  a.scale = scale;
  a.q_sb = q_sb;
  a.q_sh = q_sh;
  a.k_sb = k_sb;
  a.k_ss = k_ss;
  a.k_sh = k_sh;
  a.v_sb = v_sb;
  a.v_ss = v_ss;
  a.v_sh = v_sh;
  a.o_sb = o_sb;
  a.o_sh = o_sh;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(repro::launch_d<float>(a, D, st));
  if (dtype == 1) return static_cast<int>(repro::launch_d<__nv_bfloat16>(a, D, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
