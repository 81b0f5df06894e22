// Exact-key max-pool forward for Hopper (sm_90a): training BN from given
// statistics, relu, and the max over the neighbour axis whose winners and
// ties an f32 key decides, in one pass over the final layer's f32
// pre-activations.
//
// Replaces scanobjectnn_tpu/ops/pallas/poolkey_kernel.py:
// bn_relu_exactkey_pool (body _kernel).  Semantics are documented in
// scanobjectnn_torch/ops/cuda/poolkey_kernel.py.  For every (row, channel)
// and every neighbour slot k of z32 [rows, K, C]:
//   value  y   = relu(cd(((cd(z) - mean) * r) * gamma + beta))
//   key    key = relu(((z - mean) * r) * gamma + beta)
// with cd the compute dtype's rounding (bf16, round to nearest even; the
// identity in f32) and r = rsqrt(var + eps) a per-channel input, so the
// kernel and its plain version read the same r.  Outputs: kmax = max key,
// cnt = the number of slots whose key equals kmax, pooled = max of y over
// those slots.  A NaN key makes the column's kmax NaN, cnt 0 and pooled
// -inf, as the plain version's amax and == give.
//
// Bit-equality with the plain version is the contract: the op order is
// ((z - mean) * r) * gamma + beta in __fsub_rn / __fmul_rn / __fadd_rn, so
// nvcc cannot contract a product and a sum into an FMA, and the rounding
// to bf16 is __float2bfloat16_rn.
//
// Bound: bytes.  z32 is read once (4 bytes an element, about 14 f32
// operations each) and only [rows, C] outputs are written; at PointNet's
// global pool (rows 32, K = C = 1024) 134 MB, 40 us at 3.35 TB/s.
//
// The reduction is split over K without changing a bit.  A partial over a
// run of slots is (best key, slots at it, largest value among them, a NaN
// key seen); two partials of adjacent runs merge, the earlier first, by
// keeping the larger best (the earlier on a tie, as a serial walk keeps
// its first winner), adding the counts on a tie (integer-valued floats,
// exact below 2^24) and taking the larger value, and ORing the NaN flags.
// Any partition of the slots then gives the serial walk's outputs.
//
// Layout (the launch plan comes from poolkey_kernel.plan in Python; the
// entry point refuses one it cannot run).  A thread reads vec channels of a
// slot (vec = 4: 16-byte loads; vec = 1: one channel) and loads kAhead
// slots before it uses them.  Two routes:
//   * the column route (one team), where rows x C hold enough columns to
//     fill the card: thread i of the grid owns flattened column i of
//     [rows, C / vec], walks all K slots and writes its outputs;
//   * the split route, where they do not (PointNet's 32 rows of 1024
//     channels, a group-all layer's 16): a block owns one (row, tile of
//     lanes x vec channels).  `lanes` threads side by side read a slot's
//     tile, and the block's `teams` such teams take contiguous runs of the
//     slots.  The teams' partials merge by warp shuffles within a warp, then
//     across warps through shared memory in warp order (no atomics).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "kernel_info.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / kWarp;
constexpr int kMaxTile = kWarp * 4;  // channels a block: 32 lanes of 4
constexpr int kAhead = 4;            // slots a thread loads before it uses them
// The column route's least resident blocks of kMaxThreads an SM, by vec
// (ptxas then caps the registers to fit them: 32 at vec 1; at vec 4 a cap
// of 64 was slower at K = 128 on an H100, studies/pool_key.py --sweep).
constexpr int kColumnBlocks1 = 8, kColumnBlocks4 = 1;

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// relu that keeps a NaN (torch.relu's clamp_min(0)).
__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

__device__ __forceinline__ float affine(float z, float mean, float r, float g, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(z, mean), r), g), b);
}

template <bool BF16>
__device__ __forceinline__ float cd(float v) {
  if constexpr (BF16) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

// (best, n, pool) of the earlier slots absorbs a later partial (file doc).
// A NaN key never wins nor ties, so a slot is merged as (key, 1, y).
__device__ __forceinline__ void merge(float& best, float& n, float& pool, float b2, float n2, float p2) {
  if (b2 > best) {
    best = b2;
    n = n2;
    pool = p2;
  } else if (b2 == best) {
    n = __fadd_rn(n, n2);
    pool = fmaxf(pool, p2);
  }
}

template <int V>
__device__ __forceinline__ void load(float (&out)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 w = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = w.x;
    out[1] = w.y;
    out[2] = w.z;
    out[3] = w.w;
  } else {
    out[0] = __ldg(p);
  }
}

// One channel's outputs, the NaN rule applied.
template <bool BF16>
__device__ __forceinline__ void finish(float best, float n, float pool, bool nan, int64_t e,
                                       void* __restrict__ pooled, float* __restrict__ kmax,
                                       float* __restrict__ cnt) {
  if (nan) {
    best = __int_as_float(0x7fc00000);
    n = 0.f;
    pool = -inf_f();
  }
  if constexpr (BF16) {
    static_cast<__nv_bfloat16*>(pooled)[e] = __float2bfloat16_rn(pool);
  } else {
    static_cast<float*>(pooled)[e] = pool;
  }
  kmax[e] = best;
  cnt[e] = n;
}

// One thread's partials over slots [j0, j1) of its V channels ch0.. of
// `row` (ch0 < c), the NaN keys as bits of `nan`.
template <bool BF16, int V>
__device__ __forceinline__ void walk(const float* __restrict__ z, const float* __restrict__ gamma,
                                     const float* __restrict__ beta, const float* __restrict__ mean,
                                     const float* __restrict__ rr, int64_t row, int k, int c, int ch0, int j0,
                                     int j1, float (&best)[V], float (&n)[V], float (&pool)[V], int& nan) {
  float mu[V], r[V], g[V], b[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    mu[v] = mean[ch0 + v];
    r[v] = rr[ch0 + v];
    g[v] = gamma[ch0 + v];
    b[v] = beta[ch0 + v];
  }
  for (int j = j0; j < j1; j += kAhead) {
    const float* zp = z + (row * k + j) * c + ch0;
    float zv[kAhead][V];
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      if (j + q < j1) load<V>(zv[q], zp + static_cast<int64_t>(q) * c);
    }
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      if (j + q >= j1) break;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float y = relu(cd<BF16>(affine(cd<BF16>(zv[q][v]), mu[v], r[v], g[v], b[v])));
        const float key = relu(affine(zv[q][v], mu[v], r[v], g[v], b[v]));
        merge(best[v], n[v], pool[v], key, 1.f, y);
        if (key != key) nan |= 1 << v;
      }
    }
  }
}

// The column route (one team): thread i of the grid owns the
// V channels of flattened column i of [rows, c / V] and walks all K slots.
template <bool BF16, int V>
__global__ void __launch_bounds__(kMaxThreads, V == 1 ? kColumnBlocks1 : kColumnBlocks4)
    poolkey_columns_kernel(const float* __restrict__ z, const float* __restrict__ gamma,
                           const float* __restrict__ beta, const float* __restrict__ mean,
                           const float* __restrict__ rr, int64_t columns, int k, int c,
                           void* __restrict__ pooled, float* __restrict__ kmax, float* __restrict__ cnt) {
  const int64_t col = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (col >= columns) return;
  const int words = c / V;
  const int64_t row = col / words;
  const int ch0 = static_cast<int>(col % words) * V;
  float best[V], n[V], pool[V];
  int nan = 0;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    best[v] = -inf_f();
    n[v] = 0.f;
    pool[v] = -inf_f();
  }
  walk<BF16, V>(z, gamma, beta, mean, rr, row, k, c, ch0, 0, k, best, n, pool, nan);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    finish<BF16>(best[v], n[v], pool[v], (nan >> v) & 1, row * c + ch0 + v, pooled, kmax, cnt);
  }
}

// The split route: a block owns one (row, tile of lanes x V channels); its
// teams take contiguous runs of the slots.
template <bool BF16, int V>
__global__ void __launch_bounds__(kMaxThreads)
    poolkey_kernel(const float* __restrict__ z, const float* __restrict__ gamma,
                   const float* __restrict__ beta, const float* __restrict__ mean,
                   const float* __restrict__ rr, int k, int c, int lanes,
                   void* __restrict__ pooled, float* __restrict__ kmax, float* __restrict__ cnt) {
  // Each warp's partials (its first team's lanes).
  __shared__ float w_best[kMaxWarps][kMaxTile], w_n[kMaxWarps][kMaxTile], w_pool[kMaxWarps][kMaxTile];
  __shared__ int w_nan[kMaxWarps][kMaxTile];

  const int tile_ch = lanes * V;
  const int tiles = (c + tile_ch - 1) / tile_ch;
  const int tile = static_cast<int>(blockIdx.x % tiles);
  const int row = static_cast<int>(blockIdx.x / tiles);  // an int, as rows: an int64 row spilled to the stack
  const int t = threadIdx.x, lane = t % lanes, team = t / lanes, teams = blockDim.x / lanes;
  const int ch0 = tile * tile_ch + lane * V;

  // The team's run [j0, j1) of the slots (poolkey_kernel.runs in Python).
  const int per_team = (k + teams - 1) / teams;
  const int j0 = min(k, team * per_team), j1 = min(k, j0 + per_team);

  float best[V], n[V], pool[V];
  int nan = 0;  // bit v: a NaN key in channel ch0 + v
#pragma unroll
  for (int v = 0; v < V; ++v) {
    best[v] = -inf_f();
    n[v] = 0.f;
    pool[v] = -inf_f();
  }
  // vec 4 takes only c % 4 == 0, so the lane's 4 channels are all in range.
  if (ch0 < c) walk<BF16, V>(z, gamma, beta, mean, rr, row, k, c, ch0, j0, j1, best, n, pool, nan);

  // Teams of one warp: team i absorbs team i + d, d = 1, 2, 4, ...; the
  // first team ends with the warp's slots in order.  (A lane whose partner
  // lies past the warp merges with itself; no later step reads it.)
  const int lw = t % kWarp, warp = t / kWarp, warps = blockDim.x / kWarp;
  for (int off = lanes; off < kWarp; off *= 2) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float b2 = __shfl_down_sync(0xffffffffu, best[v], off);
      const float n2 = __shfl_down_sync(0xffffffffu, n[v], off);
      const float p2 = __shfl_down_sync(0xffffffffu, pool[v], off);
      merge(best[v], n[v], pool[v], b2, n2, p2);
    }
    nan |= __shfl_down_sync(0xffffffffu, nan, off);
  }
  if (lw < lanes) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      w_best[warp][lane * V + v] = best[v];
      w_n[warp][lane * V + v] = n[v];
      w_pool[warp][lane * V + v] = pool[v];
      w_nan[warp][lane * V + v] = (nan >> v) & 1;
    }
  }
  __syncthreads();

  // The warps in order, then the outputs.
  for (int cc = t; cc < tile_ch; cc += blockDim.x) {
    float fb = w_best[0][cc], fn = w_n[0][cc], fp = w_pool[0][cc];
    int fnan = w_nan[0][cc];
    for (int w = 1; w < warps; ++w) {
      merge(fb, fn, fp, w_best[w][cc], w_n[w][cc], w_pool[w][cc]);
      fnan |= w_nan[w][cc];
    }
    const int ch = tile * tile_ch + cc;
    if (ch < c) finish<BF16>(fb, fn, fp, fnan != 0, static_cast<int64_t>(row) * c + ch, pooled, kmax, cnt);
  }
}

using Kernel = void (*)(const float*, const float*, const float*, const float*, const float*, int, int, int,
                        void*, float*, float*);
using ColumnsKernel = void (*)(const float*, const float*, const float*, const float*, const float*, int64_t, int,
                               int, void*, float*, float*);

Kernel pick(int bf16, int vec) {
  if (bf16) return vec == 4 ? poolkey_kernel<true, 4> : poolkey_kernel<true, 1>;
  return vec == 4 ? poolkey_kernel<false, 4> : poolkey_kernel<false, 1>;
}

ColumnsKernel pick_columns(int bf16, int vec) {
  if (bf16) return vec == 4 ? poolkey_columns_kernel<true, 4> : poolkey_columns_kernel<true, 1>;
  return vec == 4 ? poolkey_columns_kernel<false, 4> : poolkey_columns_kernel<false, 1>;
}

// Blocks of the plan, or 0 where the entry point cannot run it.  One team
// is the column route: blocks of `lanes` threads (whole warps, to 256) over
// the rows x c / vec flattened columns.
int64_t plan_blocks(int rows, int k, int c, int vec, int lanes, int teams) {
  if (rows < 1 || k < 1 || c < 1 || (vec != 1 && vec != 4) || (vec == 4 && c % 4 != 0)) return 0;
  if (lanes < 1 || (lanes & (lanes - 1)) != 0 || teams < 1) return 0;
  int64_t blocks;
  if (teams == 1) {
    if (lanes < kWarp || lanes > kMaxThreads) return 0;
    blocks = (static_cast<int64_t>(rows) * (c / vec) + lanes - 1) / lanes;
  } else {
    const int64_t threads = static_cast<int64_t>(lanes) * teams;
    if (lanes > kWarp || threads % kWarp != 0 || threads > kMaxThreads) return 0;
    const int tile_ch = lanes * vec;
    blocks = static_cast<int64_t>(rows) * ((c + tile_ch - 1) / tile_ch);
  }
  return blocks > INT_MAX ? 0 : blocks;
}

}  // namespace

// z32 [rows, k, c] f32; gamma, beta, mean, r [c] f32; all contiguous ->
// pooled [rows, c] (bf16 when bf16 != 0, else f32), kmax and cnt [rows, c]
// f32.  The plan: vec (1 or 4) channels a thread; one team: the column
// route in blocks of `lanes` threads (32 to 256, a power of two); else the
// split route with lanes a team (a power of two to 32) and teams a block
// (lanes x teams whole warps, at most 256 threads).  vec 4 needs
// c % 4 == 0 and z32 on a 16-byte boundary.
extern "C" int poolkey_launch(const void* z32, const void* gamma, const void* beta, const void* mean,
                              const void* r, int rows, int k, int c, int bf16, int vec, int lanes, int teams,
                              void* pooled, void* kmax, void* cnt, void* stream) {
  const int64_t blocks = plan_blocks(rows, k, c, vec, lanes, teams);
  if (blocks == 0 || (vec == 4 && reinterpret_cast<uintptr_t>(z32) % 16 != 0)) return cudaErrorInvalidValue;
  const auto* zf = static_cast<const float*>(z32);
  const auto* gf = static_cast<const float*>(gamma);
  const auto* bf = static_cast<const float*>(beta);
  const auto* mf = static_cast<const float*>(mean);
  const auto* rf = static_cast<const float*>(r);
  auto* kf = static_cast<float*>(kmax);
  auto* cf = static_cast<float*>(cnt);
  auto s = static_cast<cudaStream_t>(stream);
  if (teams == 1) {
    pick_columns(bf16, vec)<<<static_cast<unsigned>(blocks), lanes, 0, s>>>(
        zf, gf, bf, mf, rf, static_cast<int64_t>(rows) * (c / vec), k, c, pooled, kf, cf);
  } else {
    pick(bf16, vec)<<<static_cast<unsigned>(blocks), lanes * teams, 0, s>>>(zf, gf, bf, mf, rf, k, c, lanes,
                                                                           pooled, kf, cf);
  }
  return cudaGetLastError();
}

// info = {registers, local bytes a thread, 0, resident blocks per SM at
// `threads` a block} of the build a plan takes (columns != 0: the column
// route's).
extern "C" int poolkey_info(int bf16, int vec, int threads, int columns, int* info) {
  if ((vec != 1 && vec != 4) || threads < kWarp || threads > kMaxThreads || threads % kWarp != 0) {
    return cudaErrorInvalidValue;
  }
  return columns ? kernel_info(pick_columns(bf16, vec), 0, threads, info)
                 : kernel_info(pick(bf16, vec), 0, threads, info);
}
