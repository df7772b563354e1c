// Flash attention (prefill) in bfloat16 on Hopper's tensor cores (sm_90a):
// GQA, causal / sliding window / q_offset masks, online softmax in float32.
//
// Replaces: src/repro/kernels/attention/flash_attention.py::flash_attention
// (Pallas body `_kernel`), which walks a (B, H, nq, nk) grid with the K/V
// tile index innermost and (acc, m, l) carried in VMEM scratch.  This file
// is the bfloat16 route; float32 goes to the FMA kernel in
// flash_attention.cu (the wrapper picks the route by dtype).
//
// What bounds it on an H100: operations at long prompts (4·S_q·S_kv·D
// flops, halved when causal, over the 989 TFLOP/s bf16 tensor-core peak),
// bytes and latency at short ones.  Only `wgmma` reaches the tensor-core
// rate, and it needs its operands in shared memory in the swizzled layouts
// that TMA writes.
//
// What the design does about it:
//   * A block is NC consumer warpgroups of 64 query rows each (NC = 2 on
//     128 consecutive rows of one head when that still gives two waves of
//     blocks, else NC = 1 so that short prompts spread over more SMs) and
//     one producer warp.  Two consumers on consecutive rows of one head
//     (rather than on two heads of one KV group) keep the grid simple for
//     every GQA ratio, odd ones (minitron's 3) included, and still share
//     each K/V tile between 128 rows.
//   * The producer keeps TMA loads (`cp.async.bulk.tensor`, 128-byte
//     swizzle; 64-byte at D = 32) in flight: Q once, then 64-key K and V
//     tiles into a ring of kStages stages with full and empty `mbarrier`s.
//     The tensor maps cover the caller's 4-D (B, S, heads, D) view through
//     its strides, so strided views of a projection go in without a copy,
//     and rows past S are zero-filled by TMA.
//   * S = Q·Kᵀ is `wgmma` m64n64k16 with both operands in shared memory
//     (bf16 in, f32 accumulate).  The online softmax runs on the
//     accumulator fragment in registers (each thread holds 2 rows; row max
//     and sum across the 4 threads of a row by shuffles, the sum only once
//     in the epilogue).  P is rounded to bf16 in registers, where the plain
//     version rounds the probabilities, and is the register A operand of
//     O += P·V (`wgmma` m64nDk16, V read MN-major from shared memory).
//   * Tiles that no row of a consumer can see are skipped; tiles on the
//     causal diagonal, the window edge or past S_kv are masked in registers
//     (a zero-filled key scores 0, not -inf).  O is divided by l in the
//     epilogue and stored through the output's strides.  Where the
//     caller asks for it (training: the backward kernel reads it), the
//     row's log-sum-exp, m·ln 2 + ln l, goes to a float32 (B, H, S_q)
//     tensor; -inf for a row that sees no key.
//   * D = 256 (recurrentgemma-9b's local attention) keeps the same tiles:
//     four 64-column TMA boxes per row, 161 KB of shared memory, so one
//     block per SM; P·V is two N = 128 products over the two halves of V,
//     and the 128-float O accumulator per thread gets the register budget
//     of one block per SM.  Always one consumer: ptxas gives a 288-thread
//     block at most 168 registers a thread, and the two-consumer block
//     spilled.
#include <cuda.h>
#include <math.h>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kRows = 64;     // query rows per consumer warpgroup (one wgmma M)
constexpr int kBK = 64;       // keys per K/V tile
constexpr int kStages = 2;    // K/V ring depth
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Sm90Args {
  void* o;
  float* lse;  // (B, H, S_q) log-sum-exp, natural log; null: not wanted
  int S_q, S_kv, H, G;
  long long o_sb, o_ss, o_sh;
  int causal, window, q_offset;
  float scale_log2;  // softmax scale times log2(e): p = 2^(s·scale_log2 − m)
  // Position (1..3) of the head, sequence and batch coordinates in each
  // tensor map's dimension order (dimension 0 is D).
  int q_dims[3], k_dims[3], v_dims[3];
};

template <int D>
struct Tiles {
  static constexpr int BOXC = D < 64 ? D : 64;            // columns per TMA box
  static constexpr int SWZ = BOXC * 2;                     // bytes per swizzled row: 128 or 64
  static constexpr uint32_t LAYOUT = SWZ == 128 ? 1 : 2;   // descriptor swizzle mode
  static constexpr int NCH = D / BOXC;                     // column boxes per row
  static constexpr int Q_BYTES = kRows * D * 2;            // one consumer's Q tile
  static constexpr int KV_BYTES = kBK * D * 2;             // one K or V tile
};

template <int D, int NC>
constexpr int smem_bytes() {
  return 1024 + NC * Tiles<D>::Q_BYTES + 2 * kStages * Tiles<D>::KV_BYTES +
         (1 + 3 * kStages) * 8;
}

// O += P·V for one 16-key slice, by head dim.
template <int D>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* p, uint64_t dv);
template <>
__device__ __forceinline__ void wgmma_pv<32>(float* o, const uint32_t* p, uint64_t dv) {
  wgmma_rs_n32(o, p, dv);
}
template <>
__device__ __forceinline__ void wgmma_pv<64>(float* o, const uint32_t* p, uint64_t dv) {
  wgmma_rs_n64(o, p, dv);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float* o, const uint32_t* p, uint64_t dv) {
  wgmma_rs_n128(o, p, dv);
}
// Columns 128..255 are V's boxes 2 and 3, and registers 64..127 of the
// 64 x 256 accumulator fragment.
template <>
__device__ __forceinline__ void wgmma_pv<256>(float* o, const uint32_t* p, uint64_t dv) {
  wgmma_rs_n128(o, p, dv);
  wgmma_rs_n128(o + 64, p, dv + ((2 * kBK * Tiles<256>::SWZ) >> 4));
}

// Accumulator fragment of a 64 x N wgmma: register j of thread (warp w,
// lane l) of the warpgroup holds row 16w + l/4 + 8·((j/2) % 2) and column
// 8·(j/4) + 2·(l % 4) + j % 2.
template <int D, int NC>
__global__ void __launch_bounds__(NC * 128 + 32, NC == 1 && D < 256 ? 2 : 1)
    flash_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, const Sm90Args a) {
  using T = Tiles<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                           ~static_cast<uintptr_t>(1023));
  uint8_t* sK = sQ + NC * T::Q_BYTES;
  uint8_t* sV = sK + kStages * T::KV_BYTES;
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sV + kStages * T::KV_BYTES);
  uint64_t* bar_k = bar_q + 1;        // K tile of a stage landed
  uint64_t* bar_v = bar_k + kStages;  // V tile of a stage landed
  uint64_t* bar_e = bar_v + kStages;  // every consumer warp is done with a stage

  // Blocks of the last query rows (the most keys when causal) go first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * NC * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  // Key tiles that some row of the block can see.
  const int q_first = q0 + a.q_offset;
  const int q_last = min(q0 + NC * kRows, a.S_q) - 1 + a.q_offset;
  int k_end = a.S_kv;
  if (a.causal) k_end = min(k_end, q_last + 1);
  const int k_begin = a.window > 0 ? max(0, q_first - a.window + 1) : 0;
  const int t_begin = k_begin / kBK;
  const int n_tiles = k_end > k_begin ? (k_end + kBK - 1) / kBK - t_begin : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bar_k[s], 1);
      mbar_init(&bar_v[s], 1);
      mbar_init(&bar_e[s], NC * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (warp == NC * 4) {
    // Producer: one thread issues every TMA load of the block.
    if (lane == 0) {
      mbar_expect_tx(bar_q, NC * T::Q_BYTES);
      for (int c = 0; c < NC; ++c)
        for (int ch = 0; ch < T::NCH; ++ch)
          tma_load(sQ + c * T::Q_BYTES + ch * kRows * T::SWZ, &tq, a.q_dims, bar_q, ch * T::BOXC,
                   h, q0 + c * kRows, b);
      const int kvh = h / a.G;
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        const int use = i / kStages;
        if (use > 0) mbar_wait(&bar_e[st], (use - 1) & 1);
        const int k0 = (t_begin + i) * kBK;
        mbar_expect_tx(&bar_k[st], T::KV_BYTES);
        for (int ch = 0; ch < T::NCH; ++ch)
          tma_load(sK + st * T::KV_BYTES + ch * kBK * T::SWZ, &tk, a.k_dims, &bar_k[st],
                   ch * T::BOXC, kvh, k0, b);
        mbar_expect_tx(&bar_v[st], T::KV_BYTES);
        for (int ch = 0; ch < T::NCH; ++ch)
          tma_load(sV + st * T::KV_BYTES + ch * kBK * T::SWZ, &tv, a.v_dims, &bar_v[st],
                   ch * T::BOXC, kvh, k0, b);
      }
    }
    return;
  }

  // Consumer warpgroup `wg`: query rows row0 .. row0 + 63.
  const int wg = warp / 4;
  const int w = warp % 4;
  const int row0 = q0 + wg * kRows;
  const int r_lo = row0 + w * 16 + lane / 4;  // this thread's rows: r_lo and r_lo + 8
  const int c_lane = 2 * (lane % 4);
  const int c_first = row0 + a.q_offset;
  const int c_last = row0 + kRows - 1 + a.q_offset;

  float o[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) o[j] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's share of each row's sum
  const uint64_t dq = make_desc(sQ + wg * T::Q_BYTES, 16, 8 * T::SWZ, T::LAYOUT);
  mbar_wait(bar_q, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    const uint32_t parity = (i / kStages) & 1;
    const int k0 = (t_begin + i) * kBK;
    const bool skip = (a.causal && k0 > c_last) ||
                      (a.window > 0 && k0 + kBK - 1 <= c_first - a.window);
    mbar_wait(&bar_k[st], parity);
    if (!skip) {
      // S = Q·Kᵀ, 64 x 64, f32.
      float s[kBK / 2];
#pragma unroll
      for (int j = 0; j < kBK / 2; ++j) s[j] = 0.f;
      const uint64_t dk = make_desc(sK + st * T::KV_BYTES, 16, 8 * T::SWZ, T::LAYOUT);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int e = kk * 16;
        const uint32_t col = (e % T::BOXC) * 2;
        wgmma_ss_n64(s, dq + ((e / T::BOXC * kRows * T::SWZ + col) >> 4),
                     dk + ((e / T::BOXC * kBK * T::SWZ + col) >> 4), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int j = 0; j < kBK / 2; ++j) fence_reg(s[j]);

      const bool edge = k0 + kBK > a.S_kv || (a.causal && k0 + kBK - 1 > c_first) ||
                        (a.window > 0 && k0 <= c_last - a.window);
      if (edge) {
#pragma unroll
        for (int j = 0; j < kBK / 2; ++j) {
          const int kp = k0 + 8 * (j / 4) + c_lane + j % 2;
          const int qp = r_lo + 8 * ((j / 2) % 2) + a.q_offset;
          const bool ok = kp < a.S_kv && (!a.causal || kp <= qp) &&
                          (a.window <= 0 || kp > qp - a.window);
          if (!ok) s[j] = -INFINITY;
        }
      }

      // Online softmax in base 2 on the fragment.
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kBK / 2; ++j) mx[(j / 2) % 2] = fmaxf(mx[(j / 2) % 2], s[j]);
      float mb[2], alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_run[r], mx[r] * a.scale_log2);
        mb[r] = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet
        alpha[r] = exp2f(m_run[r] - mb[r]);
        m_run[r] = m_new;
      }
#pragma unroll
      for (int j = 0; j < kBK / 2; ++j) {
        const int r = (j / 2) % 2;
        s[j] = exp2f(fmaf(s[j], a.scale_log2, -mb[r]));
        rsum[r] += s[j];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rsum[r];
#pragma unroll
      for (int j = 0; j < D / 2; ++j) o[j] *= alpha[(j / 2) % 2];
      // P in bf16 as the A fragment: keys 16t..16t+15 are s[8t..8t+7].
      uint32_t p[kBK / 16][4];
#pragma unroll
      for (int t = 0; t < kBK / 16; ++t)
#pragma unroll
        for (int x = 0; x < 4; ++x) p[t][x] = pack_bf16(s[8 * t + 2 * x], s[8 * t + 2 * x + 1]);

      // O += P·V.
      mbar_wait(&bar_v[st], parity);
      const uint64_t dv = make_desc(sV + st * T::KV_BYTES, kBK * T::SWZ, 8 * T::SWZ, T::LAYOUT);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < kBK / 16; ++t) wgmma_pv<D>(o, p[t], dv + ((t * 16 * T::SWZ) >> 4));
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int j = 0; j < D / 2; ++j) fence_reg(o[j]);
    } else {
      mbar_wait(&bar_v[st], parity);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&bar_e[st]);
  }

  // Epilogue: O / l, stored through the output's strides; the log-sum-exp.
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = l > 0.f ? 1.f / l : 0.f;
    const int row = r_lo + 8 * r;
    if (a.lse != nullptr && lane % 4 == 0 && row < a.S_q)
      a.lse[(static_cast<long long>(b) * a.H + h) * a.S_q + row] =
          l > 0.f ? m_run[r] * kLn2 + logf(l) : -INFINITY;
    if (row < a.S_q) {
#pragma unroll
      for (int j = 2 * r; j < D / 2; j += 4) {
        const int col = 8 * (j / 4) + c_lane;
        *reinterpret_cast<__nv_bfloat162*>(ob + row * a.o_ss + col) =
            __floats2bfloat162_rn(o[j] * inv, o[j + 1] * inv);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: tensor maps and launch
// ---------------------------------------------------------------------------

struct Operands {
  const void *q, *k, *v;
  int B, S_q, S_kv, H, KV;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
};

// Error codes besides CUDA's: the driver entry point or a tensor map.
constexpr int kErrNoEncode = -1;
constexpr int kErrTensorMap = -2;

template <int D, int NC>
int launch(const Operands& x, Sm90Args a, cudaStream_t stream) {
  using T = Tiles<D>;
  if (encode_tiled() == nullptr) return kErrNoEncode;
  CUtensorMap tq, tk, tv;
  if (!make_bshd_map(&tq, x.q, x.B, x.S_q, x.H, D, x.q_sb, x.q_ss, x.q_sh, T::BOXC, kRows,
                     a.q_dims) ||
      !make_bshd_map(&tk, x.k, x.B, x.S_kv, x.KV, D, x.k_sb, x.k_ss, x.k_sh, T::BOXC, kBK,
                     a.k_dims) ||
      !make_bshd_map(&tv, x.v, x.B, x.S_kv, x.KV, D, x.v_sb, x.v_ss, x.v_sh, T::BOXC, kBK,
                     a.v_dims))
    return kErrTensorMap;
  constexpr int smem = smem_bytes<D, NC>();
  cudaError_t err = cudaFuncSetAttribute(flash_sm90_kernel<D, NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((x.S_q + NC * kRows - 1) / (NC * kRows), x.H, x.B);
  flash_sm90_kernel<D, NC><<<grid, NC * 128 + 32, smem, stream>>>(tq, tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

// Two consumers per block share each K/V tile between 128 rows; they are
// used when that still gives at least two blocks per SM (never at D = 256).
template <int D>
int launch_nc(const Operands& x, const Sm90Args& a, cudaStream_t stream) {
  if constexpr (D == 256) {
    return launch<D, 1>(x, a, stream);
  } else {
    int device = 0, sms = 132;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    const long long wide =
        static_cast<long long>((x.S_q + 2 * kRows - 1) / (2 * kRows)) * x.H * x.B;
    return wide >= 2LL * sms ? launch<D, 2>(x, a, stream) : launch<D, 1>(x, a, stream);
  }
}

}  // namespace
}  // namespace repro

// q (B,S_q,H,D), k/v (B,S_kv,KV,D), o (B,S_q,H,D), all bfloat16; strides in
// elements, last dimension contiguous, rows 16-byte aligned.  Returns the
// CUDA error of the launch (0 on success), -1 if the driver's
// cuTensorMapEncodeTiled is not available, -2 if it refuses a tensor map.
extern "C" int repro_flash_attention_sm90(
    const void* q, const void* k, const void* v, void* o, int B, int S_q, int S_kv, int H,
    int KV, int D, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, int causal, int window, int q_offset,
    float scale, void* lse, void* stream) {
  const repro::Operands x{q,    k,    v,    B,    S_q,  S_kv, H,    KV,
                          q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  repro::Sm90Args a{};
  a.o = o;
  a.lse = static_cast<float*>(lse);
  a.S_q = S_q;
  a.S_kv = S_kv;
  a.H = H;
  a.G = H / KV;
  a.o_sb = o_sb;
  a.o_ss = o_ss;
  a.o_sh = o_sh;
  a.causal = causal;
  a.window = window;
  a.q_offset = q_offset;
  a.scale_log2 = scale * repro::kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return repro::launch_nc<32>(x, a, st);
    case 64: return repro::launch_nc<64>(x, a, st);
    case 128: return repro::launch_nc<128>(x, a, st);
    case 256: return repro::launch_nc<256>(x, a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
