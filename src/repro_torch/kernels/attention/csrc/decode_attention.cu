// One-token GQA decode attention against a KV cache, for Hopper (sm_90a),
// in one launch.
//
// Replaces: src/repro/kernels/attention/decode_attention.py::decode_attention
// (Pallas body `_kernel`), which streams the cache block by block along a
// sequential grid axis with (m, l, acc) carried in VMEM scratch.
//
// What bounds it on an H100: bytes.  Each valid cache entry is read once per
// kv head and used for G = H/KV dot products and G axpys, about 2·G flops
// per byte in bf16, far below the ~295 flops/byte where the tensor cores
// would become the limit.  The least time is the valid cache bytes over
// 3.35 TB/s, a few microseconds at serving shapes.  At those shapes what
// sets the time is latency: of the launch, of the loads, and of the chain
// of arithmetic and barriers each block runs per tile of entries.
//
// What the design does about it:
//   * Blocks are (chunk, kv head, batch row).  When the caller's cache
//     length is one host int (the engine's case) the wrapper splits only
//     the valid range [valid_begin, valid_end), so every block has entries;
//     with per-example lengths it splits S_max and blocks past their row's
//     length read nothing.
//   * bfloat16 (the main path, `decode_mma_kernel`): each warp owns every
//     fourth 16-entry tile of the block's chunk and streams it through its
//     own 2-stage `cp.async` ring, so the warps run without block barriers.
//     Both products run on the tensor cores as `mma.sync` m16n8k16 (the
//     G <= 8 query rows padded to 16): S = Q·Kᵀ with Q's fragments held in
//     registers for the whole kernel and K's read by `ldmatrix`, the online
//     softmax on the accumulator fragment (one max and rescale per row and
//     tile), and O += P·V with P repacked from S's fragment in registers
//     and V read by `ldmatrix.trans`.  K and V sit in shared memory with
//     their 16-byte chunks XOR-swizzled by row, so `ldmatrix`'s eight rows
//     hit distinct banks.  The four warps' (m, l, O) merge in shared memory.
//   * float32 (`decode_fma_kernel`; the tensor cores would need TF32, which
//     misses float32's tolerance): 32-entry tiles through a block-wide
//     2-stage ring; lane j computes the whole dot product of entry j with
//     the warp's query rows (read as shared-memory broadcasts), then one
//     max, one exp per entry and one rescale per row and tile, then the
//     value product with every thread owning a (query row, 16-byte column
//     slice) of the accumulator.
//   * The chunks of one (batch row, kv head) are one thread-block cluster
//     (n_split <= 8, the portable cluster size) and are merged in the same
//     launch through distributed shared memory: each block leaves its
//     (m, l, acc) partial in its own shared memory, and after a cluster
//     barrier the cluster's first block reads the others' and writes the
//     output.  No partial goes through device memory.  With one chunk the
//     block writes the output itself.
//   * Scores are kept in base 2 with the softmax scale folded in, so each
//     weight is one exp2.
#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSplit = 8;  // chunks per (batch row, kv head): one cluster
constexpr int kMaxGroup = 8;  // query rows per kv head
constexpr float kLog2e = 1.4426950408889634f;

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* cache_len;  // (B,) per-example lengths, or null: `len` for all
  int len;
  void* out;
  int B, KV, G, S_max;
  int base, chunk, n_split, window;
  float scale_log2;  // softmax scale times log2(e): weights are 2^(s − m)
  long long q_sb, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_sh;
};

// The entries [start, end) of this block's chunk.
struct Range {
  int start, end;
};
__device__ __forceinline__ Range block_range(const DecodeArgs& a, int b, int split) {
  const int len = a.cache_len != nullptr ? a.cache_len[b] : a.len;
  const int valid_end = min(len, a.S_max);
  const int valid_begin = a.window > 0 ? max(len - a.window, 0) : 0;
  const int c0 = a.base + split * a.chunk;
  const int c1 = min(c0 + a.chunk, valid_end);
  return {max(c0, valid_begin), c1};
}

// Copies `rows` cache rows (of D elements, row stride `stride`) starting at
// `src` into a tile of `tile_rows` rows in shared memory whose 16-byte
// chunk c of row r sits at chunk c ^ (r & 7) (for rows of fewer than 8
// chunks, c ^ (r & (chunks - 1))); rows past `rows` are zero-filled.  The
// `n_threads` threads from `first` issue the copies.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long stride, int rows,
                                          int tile_rows, int first, int n_threads) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CG = D / VEC;
  constexpr int SWZ = (CG < 8 ? CG : 8) - 1;
  for (int idx = first; idx < tile_rows * CG; idx += n_threads) {
    const int r = idx / CG;
    const int c = idx % CG;
    const bool ok = r < rows;
    cp_async16(dst + r * D + (c ^ (r & SWZ)) * VEC, src + (ok ? r : 0) * stride + c * VEC, ok);
  }
}
template <typename T, int D>
__device__ __forceinline__ int swizzled(int r, int c) {  // element offset of chunk c of row r
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CG = D / VEC;
  constexpr int SWZ = (CG < 8 ? CG : 8) - 1;
  return r * D + (c ^ (r & SWZ)) * VEC;
}

// Floats of dynamic shared memory behind the ring that receive the
// cluster's partials: acc [n_split][G][D], then m and l [n_split][G].
__host__ __device__ constexpr int gather_floats(int n_split, int G, int D) {
  return n_split > 1 ? n_split * G * (D + 2) : 0;
}

// The split barrier of the cluster: every block arrives once it starts
// (cluster_started) and waits before it first touches another block's
// shared memory (cluster_wait_started).
__device__ __forceinline__ void cluster_started() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait_started() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Ends every block: the block's partial is in sM, sL (G rows, base 2) and
// sAcc (G x D, unnormalised).  With one chunk the block writes out = acc /
// l.  Otherwise every block of the cluster stores its partial into the
// `gather` buffer of the cluster's first block (distributed shared memory,
// stores that need no round trip), one cluster barrier orders them, and
// the first block merges from its own shared memory:
//   out = Σ_s acc_s·2^(m_s − M) / Σ_s l_s·2^(m_s − M).
// A row with no valid entry (l = 0 everywhere) comes out as zeros, as in
// the TPU kernel.
template <typename T, int D>
__device__ __forceinline__ void finish(const DecodeArgs& a, const float* sAcc, const float* sM,
                                       const float* sL, float* gather, int b, int kvh) {
  const int G = a.G;
  const int n_split = a.n_split;
  T* out = static_cast<T*>(a.out) + b * a.o_sb + (long long)kvh * G * a.o_sh;
  if (n_split == 1) {
    for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
      const int g = idx / D;
      out[g * a.o_sh + idx % D] = from_float<T>(sAcc[idx] / fmaxf(sL[g], 1e-30f));
    }
    return;
  }
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  cluster_wait_started();
  float* first = cluster.map_shared_rank(gather, 0);
  float* gM = first + n_split * G * D;
  float* gL = gM + n_split * G;
  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) first[rank * G * D + idx] = sAcc[idx];
  if (threadIdx.x < G) {
    gM[rank * G + threadIdx.x] = sM[threadIdx.x];
    gL[rank * G + threadIdx.x] = sL[threadIdx.x];
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  if (rank != 0) return;
  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
    const int g = idx / D;
    float mm = kNegInf;
    for (int r = 0; r < n_split; ++r) mm = fmaxf(mm, gather[n_split * G * D + r * G + g]);
    float ll = 0.f, aa = 0.f;
    for (int r = 0; r < n_split; ++r) {
      const float w = exp2f(gather[n_split * G * D + r * G + g] - mm);
      ll += gather[n_split * G * (D + 1) + r * G + g] * w;
      aa += gather[r * G * D + idx] * w;
    }
    out[g * a.o_sh + idx % D] = from_float<T>(aa / fmaxf(ll, 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// float32: FMA pipes
// ---------------------------------------------------------------------------

constexpr int kFmaTile = 32;  // entries per tile: one per lane in the scores and the softmax
// Ring depth: one tile in flight while one is used.  Per block the tile's
// arithmetic, not the load, is the longer chain; deeper rings measured
// slower at the serving shapes (more shared memory per block, fewer blocks
// per SM).
constexpr int kFmaStages = 2;

template <int D>
__host__ __device__ constexpr int fma_smem_bytes() {
  return 2 * kFmaStages * kFmaTile * D * static_cast<int>(sizeof(float));
}

template <int D, int GMAX>
__global__ void __launch_bounds__(kThreads) decode_fma_kernel(DecodeArgs a) {
  using T = float;
  constexpr int VEC = Vec<T>::N;
  constexpr int CG = D / VEC;  // 16-byte chunks of a cache row
  constexpr int SLOTS = (GMAX * CG + kThreads - 1) / kThreads;  // accumulator chunks per thread
  static_assert(GMAX <= 2 * kWarps, "two query rows per warp");
  static_assert(kFmaTile == 32, "one entry per lane");

  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + kFmaStages * kFmaTile * D;
  float* gather = reinterpret_cast<float*>(smem_raw + fma_smem_bytes<D>());
  __shared__ __align__(16) float sQ[GMAX][D];  // query rows times scale·log2(e)
  __shared__ float sP[GMAX][kFmaTile + 1];     // probabilities of the tile
  __shared__ float sAlpha[GMAX];
  __shared__ float sAcc[GMAX * D], sM[GMAX], sL[GMAX];

  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int G = a.G;
  if (a.n_split > 1) cluster_started();
  const Range range = block_range(a, b, split);
  const int n = max(range.end - range.start, 0);
  const int n_tiles = (n + kFmaTile - 1) / kFmaTile;

  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  auto issue = [&](int t) {
    if (t < n_tiles) {
      const int row0 = range.start + t * kFmaTile;
      const int rows = min(kFmaTile, range.end - row0);
      const int stage = (t % kFmaStages) * kFmaTile * D;
      load_tile<T, D>(sK + stage, kb + row0 * a.k_ss, a.k_ss, rows, kFmaTile, tid, kThreads);
      load_tile<T, D>(sV + stage, vb + row0 * a.v_ss, a.v_ss, rows, kFmaTile, tid, kThreads);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < kFmaStages - 1; ++t) issue(t);

  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + (long long)kvh * G * a.q_sh;
  for (int idx = tid; idx < G * D; idx += kThreads)
    sQ[idx / D][idx % D] = q[(idx / D) * a.q_sh + idx % D] * a.scale_log2;
  // Warp w owns query rows w and w + 4: their running max and sum (base 2).
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  float acc[SLOTS][VEC];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s)
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[s][i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    issue(t + kFmaStages - 1);
    cp_async_wait<kFmaStages - 1>();
    __syncthreads();  // the tile (and, the first time, sQ) is visible to all
    const T* tK = sK + (t % kFmaStages) * kFmaTile * D;
    const T* tV = sV + (t % kFmaStages) * kFmaTile * D;
    const int rows = min(kFmaTile, n - t * kFmaTile);

    // Lane j scores entry j of the tile against the warp's query rows: a
    // whole dot product per thread, no shuffles.
    float sc[2] = {0.f, 0.f};
    if (warp < G) {
#pragma unroll
      for (int c = 0; c < CG; ++c) {
        float kf[VEC];
        Vec<T>::load(tK + swizzled<T, D>(lane, c), kf);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int g = warp + r * kWarps;
          if (g < G) {
#pragma unroll
            for (int i = 0; i < VEC; ++i) sc[r] += sQ[g][c * VEC + i] * kf[i];
          }
        }
      }
    }
    // One max, one exp per entry and one rescale factor per row and tile.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int g = warp + r * kWarps;
      if (g < G) {
        const float x = lane < rows ? sc[r] : -INFINITY;
        float mx = x;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m_run[r], mx);
        const float p = exp2f(x - m_new);
        float sum = p;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        const float alpha = exp2f(m_run[r] - m_new);
        l_run[r] = l_run[r] * alpha + sum;
        m_run[r] = m_new;
        sP[g][lane] = p;
        if (lane == 0) sAlpha[g] = alpha;
      }
    }
    __syncthreads();

    // acc = acc·alpha + P·V over the tile.
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int slot = tid + s * kThreads;
      const int g = slot / CG;
      const int c = slot % CG;
      if (g < G) {
        const float alpha = sAlpha[g];
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[s][i] *= alpha;
        // Entries past `rows` have p = 0 and zero-filled values.
#pragma unroll 8
        for (int j = 0; j < kFmaTile; ++j) {
          const float p = sP[g][j];
          float vf[VEC];
          Vec<T>::load(tV + swizzled<T, D>(j, c), vf);
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[s][i] += p * vf[i];
        }
      }
    }
    __syncthreads();  // the stage is refilled by the next iteration's copies
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int g = warp + r * kWarps;
    if (g < G && lane == 0) {
      sM[g] = m_run[r];
      sL[g] = l_run[r];
    }
  }
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int slot = tid + s * kThreads;
    const int g = slot / CG;
    if (g < G) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) sAcc[g * D + (slot % CG) * VEC + i] = acc[s][i];
    }
  }
  __syncthreads();
  finish<T, D>(a, sAcc, sM, sL, gather, b, kvh);
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync)
// ---------------------------------------------------------------------------

constexpr int kMmaTile = 16;   // entries per warp tile: one K-step of P·V
constexpr int kMmaStages = 2;  // each warp's ring: one tile in flight while one is used

template <int D>
__host__ __device__ constexpr int mma_smem_bytes() {
  return kWarps * kMmaStages * 2 * kMmaTile * D * static_cast<int>(sizeof(__nv_bfloat16));
}

// Fragments of m16n8k16 for lane l: A holds row l/4 (and l/4 + 8) at
// columns 2(l % 4) + {0, 1} (and + 8); B holds column l/4 at rows
// 2(l % 4) + {0, 1} (and + 8); C holds row l/4 (c0, c1) and l/4 + 8 (c2,
// c3) at columns 2(l % 4) + {0, 1}.  The query rows are A's rows 0..G-1;
// rows 8..15 are zero, so their registers are constant zeros.
template <int D>
__global__ void __launch_bounds__(kThreads) decode_mma_kernel(DecodeArgs a) {
  using T = __nv_bfloat16;
  constexpr int KS = D / 16;  // K-steps of Q·Kᵀ
  constexpr int NT = D / 8;   // n-tiles of P·V
  static_assert(KS % 2 == 0, "ldmatrix.x4 reads two K-steps");

  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ float sAcc[kMaxGroup * D], sM[kMaxGroup], sL[kMaxGroup];
  __shared__ float wM[kWarps][kMaxGroup], wL[kWarps][kMaxGroup];

  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int G = a.G;
  if (a.n_split > 1) cluster_started();
  const Range range = block_range(a, b, split);
  const int n = max(range.end - range.start, 0);
  const int n_tiles = (n + kMmaTile - 1) / kMmaTile;
  float* gather = reinterpret_cast<float*>(smem_raw + mma_smem_bytes<D>());

  // Warp w streams tiles w, w + 4, ... of the chunk through its own ring
  // of [stage][K, V][kMmaTile][D].
  T* ring = reinterpret_cast<T*>(smem_raw) + warp * kMmaStages * 2 * kMmaTile * D;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  auto issue = [&](int i) {  // the warp's i-th tile
    const int t = warp + kWarps * i;
    if (t < n_tiles) {
      const int row0 = range.start + t * kMmaTile;
      const int rows = min(kMmaTile, range.end - row0);
      T* stage = ring + (i % kMmaStages) * 2 * kMmaTile * D;
      load_tile<T, D>(stage, kb + row0 * a.k_ss, a.k_ss, rows, kMmaTile, lane, 32);
      load_tile<T, D>(stage + kMmaTile * D, vb + row0 * a.v_ss, a.v_ss, rows, kMmaTile, lane, 32);
    }
    cp_async_commit();
  };
  issue(0);

  // Q's A fragments, held for the whole kernel.
  const int g_lane = lane / 4;
  const int c_lane = 2 * (lane % 4);
  uint32_t qa[KS][2];
  const T* q_row = static_cast<const T*>(a.q) + b * a.q_sb + (long long)(kvh * G + g_lane) * a.q_sh;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    qa[ks][0] = g_lane < G ? *reinterpret_cast<const uint32_t*>(q_row + 16 * ks + c_lane) : 0u;
    qa[ks][1] = g_lane < G ? *reinterpret_cast<const uint32_t*>(q_row + 16 * ks + 8 + c_lane) : 0u;
  }

  float m_run = kNegInf, l_run = 0.f;  // row g_lane, base 2; l is this thread's share
  float o[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  const int n_mine = n_tiles > warp ? (n_tiles - warp + kWarps - 1) / kWarps : 0;
  for (int i = 0; i < n_mine; ++i) {
    issue(i + 1);
    cp_async_wait<kMmaStages - 1>();
    __syncwarp();  // every lane's copies of the tile have landed
    const T* tK = ring + (i % kMmaStages) * 2 * kMmaTile * D;
    const T* tV = tK + kMmaTile * D;
    const int rows = min(kMmaTile, n - (warp + kWarps * i) * kMmaTile);

    // S = Q·Kᵀ for the tile's 16 entries (two n-tiles of 8).
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int kp = 0; kp < KS / 2; ++kp) {
        uint32_t kf[4];  // K-steps 2kp and 2kp + 1 of entries 8nt..8nt+7
        ldmatrix_x4(kf, tK + swizzled<T, D>(8 * nt + lane % 8, 4 * kp + lane / 8));
        const uint32_t a0[4] = {qa[2 * kp][0], 0u, qa[2 * kp][1], 0u};
        const uint32_t a1[4] = {qa[2 * kp + 1][0], 0u, qa[2 * kp + 1][1], 0u};
        mma_bf16(s[nt], a0, kf[0], kf[1]);
        mma_bf16(s[nt], a1, kf[2], kf[3]);
      }
    }

    // Online softmax on the fragment: row g_lane's 16 scores sit in the 4
    // lanes of a quad.
    float x[2][2];
    float mx = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        x[nt][e] = 8 * nt + c_lane + e < rows ? s[nt][e] * a.scale_log2 : -INFINITY;
        mx = fmaxf(mx, x[nt][e]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = exp2f(m_run - m_new);
    float p[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) p[nt][e] = exp2f(x[nt][e] - m_new);
    l_run = l_run * alpha + (p[0][0] + p[0][1] + p[1][0] + p[1][1]);
    m_run = m_new;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      o[j][0] *= alpha;
      o[j][1] *= alpha;
    }

    // O += P·V, P in bf16 from S's fragment (rows 8..15 zero).
    const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]), 0u, pack_bf16(p[1][0], p[1][1]), 0u};
#pragma unroll
    for (int dp = 0; dp < NT / 2; ++dp) {
      uint32_t vf[4];  // entries 0..7 and 8..15 of columns 16dp.. and 16dp + 8..
      ldmatrix_x4_trans(vf, tV + swizzled<T, D>(8 * ((lane / 8) % 2) + lane % 8, 2 * dp + lane / 16));
      mma_bf16(o[2 * dp], pa, vf[0], vf[1]);
      mma_bf16(o[2 * dp + 1], pa, vf[2], vf[3]);
    }
    __syncwarp();  // the stage is refilled by the next iteration's copies
  }
  cp_async_wait<0>();

  // Merge the four warps' (m, l, O) in shared memory (over the rings).
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 1);
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 2);
  if (lane % 4 == 0 && g_lane < G) {
    wM[warp][g_lane] = m_run;
    wL[warp][g_lane] = l_run;
  }
  __syncthreads();  // every warp is done with its ring
  float* wO = reinterpret_cast<float*>(smem_raw);  // [kWarps][G][D]
  if (g_lane < G) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      wO[(warp * G + g_lane) * D + 8 * j + c_lane] = o[j][0];
      wO[(warp * G + g_lane) * D + 8 * j + c_lane + 1] = o[j][1];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < G * D; idx += kThreads) {
    const int g = idx / D;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, wM[w][g]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = exp2f(wM[w][g] - mm);
      ll += wL[w][g] * wt;
      aa += wO[(w * G + g) * D + idx % D] * wt;
    }
    sAcc[idx] = aa;
    if (idx % D == 0) {
      sM[g] = mm;
      sL[g] = ll;
    }
  }
  __syncthreads();
  finish<T, D>(a, sAcc, sM, sL, gather, b, kvh);
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// The n_split blocks of one (batch row, kv head) as one cluster, with
// `ring` bytes of dynamic shared memory plus the gather buffer.
template <typename Kernel>
cudaError_t launch_cluster(Kernel kernel, int ring, int D, const DecodeArgs& a,
                           cudaStream_t stream) {
  const int smem = ring + gather_floats(a.n_split, a.G, D) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.n_split, a.KV, a.B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = a.n_split;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fma(const DecodeArgs& a, cudaStream_t stream) {
  constexpr int ring = fma_smem_bytes<D>();
  if (a.G <= 2) return launch_cluster(decode_fma_kernel<D, 2>, ring, D, a, stream);
  if (a.G <= 4) return launch_cluster(decode_fma_kernel<D, 4>, ring, D, a, stream);
  if (a.G <= 8) return launch_cluster(decode_fma_kernel<D, 8>, ring, D, a, stream);
  return cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_d(const DecodeArgs& a, int dtype, cudaStream_t stream) {
  if (dtype == 0) return launch_fma<D>(a, stream);
  if (dtype == 1 && a.G <= kMaxGroup)
    return launch_cluster(decode_mma_kernel<D>, mma_smem_bytes<D>(), D, a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro

// dtype: 0 = float32 (FMA kernel), 1 = bfloat16 (tensor-core kernel).
// cache_len: (B,) int32 on the device, or null, and then `len` holds for
// every row.  Blocks cover chunks of `chunk` entries starting at `base`,
// n_split <= 8 of them per (batch row, kv head); G = H / KV <= 8.  Strides
// are in elements; the last dimension of q, the caches and out is
// contiguous, rows 16-byte aligned.  Returns the CUDA error of the launch
// (0 on success).
extern "C" int repro_decode_attention(
    const void* q, const void* k_cache, const void* v_cache, const int* cache_len, int len,
    void* out, int dtype, int B, int H, int KV, int D, int S_max, int base, int chunk,
    int n_split, int window, float scale, long long q_sb, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_sh, void* stream) {
  repro::DecodeArgs a;
  a.q = q;
  a.k = k_cache;
  a.v = v_cache;
  a.cache_len = cache_len;
  a.len = len;
  a.out = out;
  a.B = B;
  a.KV = KV;
  a.G = H / KV;
  a.S_max = S_max;
  a.base = base;
  a.chunk = chunk;
  a.n_split = n_split;
  a.window = window;
  a.scale_log2 = scale * repro::kLog2e;
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
  if (n_split < 1 || n_split > repro::kMaxSplit) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return static_cast<int>(repro::launch_d<32>(a, dtype, st));
    case 64: return static_cast<int>(repro::launch_d<64>(a, dtype, st));
    case 128: return static_cast<int>(repro::launch_d<128>(a, dtype, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
