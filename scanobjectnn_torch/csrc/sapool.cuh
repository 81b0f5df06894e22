// Row staging, folded-BN MLP and max-pool of the fused eval-time SA layer,
// shared by safused.cu (#3 and #10) and sabucket.cu (#4), so the layer and
// max-pool code cannot drift between the three.  Each kernel selects its
// rows first (a ball scan, a given grouping, or a ball scan over a sorted
// window) into shared memory, then calls mlp_pool.  Semantics are documented
// in scanobjectnn_torch/ops/cuda/safused_kernel.py.
//
// A block handles QPB = max(1, 64 / K4) queries of one cloud (K4: K rounded
// up to a multiple of 4) and stages 64 rows at a time, each query's slots
// in K4 rows (the pad rows repeat its last slot, so they leave its max
// unchanged; the rows past QPB * K4 are zeros, never pooled):
//   2. the rows [c3 | feat[idx]] of a chunk of at most 64 slots are staged
//      in shared memory k-major ([k][row], f32; c3 rounded to the compute
//      type, features converted exactly), each warp's loads of a batch of
//      rows in flight together;
//   3. each layer is a register-tiled product over the 64 rows: a thread
//      holds TR rows x TC columns of sums (4 x 4, or 8 x 4 above 64 output
//      columns in a kernel built for two blocks an SM), and each k step
//      reads its TR activations and TC weights with 16-byte shared loads
//      for TR * TC FMAs.  W is staged in slices of 2048 floats (converted to
//      f32 once), double-buffered through registers: the next slice's loads
//      are in flight while the block multiplies the current one.  A hidden
//      layer stores relu(acc + b), rounded to the compute type, k-major in
//      the other activation buffer;
//   4. the last layer's epilogue takes each thread's max over its rows, 4 at
//      a time (every aligned group of 4 rows lies in one query), into the
//      free W ring; then one thread a (query, column) takes the max over the
//      query's groups, so its activations are never stored.
// A kernel is built for three blocks an SM (80 registers a thread) where
// three fit the SM's shared memory, as at SSG's SA1, so that one block's
// selection hides behind the others' products, and for two (128) otherwise,
// as at SA2 (min_blocks).
// K <= 64 is one chunk.  K > 64 (MSG's 128) takes one query per block and
// repeats 2-4 over chunks of 64 slots, carrying the running max of each
// column in shared memory from one chunk to the next.
//
// Every output is the same FMA chain as the plain version's f32 product:
// acc starts at 0 and runs fmaf over k in ascending order, on the CUDA
// cores, for both compute types (no TF32, no mma, no split of k, no float
// atomics); layer 0 sums feats·W0f (or takes the prelifted term) and c3·W0x
// apart, then adds them.  In bf16 the products of bf16 operands are exact in
// f32, and these sums give the plain version's bits (cuBLAS's f32 product)
// on an H100.  A version whose bf16 MLP runs mma.sync on the tensor cores
// (studies/sa_mma.cuh, studies/sa_mma.py) holds each call's bf16 gate, but
// sums in another order, and the bf16 roundings it flips spread through the
// layers after: 37% of the bf16 SSG forward's logits differ by an ulp, past
// the models' logits gate (PERF.md section 6).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 64;        // staged rows per block, and slots per chunk
constexpr int kLdr = kMaxRows + 4;  // row stride of the k-major activations (floats)
constexpr int kSlice = 2048;        // floats of one staged W slice
constexpr int kMaxK = 1024;
constexpr int kMaxLayers = 8;
constexpr size_t kMaxSmem = 227 * 1024;

struct Layers {
  int n;
  int width[kMaxLayers];
  const void* w[kMaxLayers];  // [width[l-1], width[l]] in the compute type; w[0] unused
  const float* b[kMaxLayers];
};

struct Args {
  int ball;              // 1: a row's coordinates are xyz[idx] - new_xyz; 0: a given grouping
  const float* xyz;      // [B, N, 3] (ball)
  const float* new_xyz;  // [B, M, 3] (ball)
  const float* grouped;  // [B, M, K, 3] centred coordinates (given grouping), or null
  const int32_t* gidx;   // [B, M, K] neighbour indices (given grouping), or null
  const void* src;       // [B, N, cs] compute type, or null
  int n, m, cs, k, qpb;
  float r2;
  const void* w0x;  // [3, C0] or null
  const void* w0f;  // [cs, C0] or null (prelifted: src rows are layer-0 terms)
  int prelifted;
  int wa, wb;  // widths (k rows) of the two activation buffers
  void* pooled;  // [B, M, Cout] compute type
  int32_t* idx;  // [B, M, K] (ball scan, K <= 64), or null
};

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round an f32 value to the compute type and back (identity for f32).
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f<T>(from_f<T>(v));
}

__host__ __device__ __forceinline__ int round_up4(int x) { return (x + 3) & ~3; }

// A thread's TR x TC register tile of a layer's 64 rows x kCols columns.
// The threads form kRowThreads x kColThreads, row group fastest, so a warp
// spans few column groups.  Rows and columns go in runs of 4 (one 16-byte
// shared load), the runs of a thread kRowThreads (kColThreads) runs apart,
// so the threads of a warp read contiguous words.
template <int TR, int TC>
struct Tile {
  static constexpr int kRowThreads = kMaxRows / TR;
  static constexpr int kColThreads = kThreads / kRowThreads;
  static constexpr int kCols = TC * kColThreads;  // output columns a pass
  static constexpr int kDepth = kSlice / kCols;   // k rows of a W slice
  static constexpr int kLoads = kSlice / kThreads;
  static __device__ __forceinline__ int row(int rg, int i) { return (i / 4) * 4 * kRowThreads + 4 * rg + (i & 3); }
  static __device__ __forceinline__ int col(int cg, int j) { return (j / 4) * 4 * kColThreads + 4 * cg + (j & 3); }
};

// Where the last layer's pass pools: the chunk's first slot, each query's
// staged rows (K4, or the chunk's slots rounded up to 4), whether this is
// the last chunk, the queries' rows in [0, M), the running max (K > 64).
struct Pool {
  int s0, nsp;
  bool last;
  const int* qrow;
  float* run_max;
};

// W rows [k0, k0 + kDepth) x columns [n0, n0 + kCols) of w [kin, cout] into
// registers, zeros past w's edges (the loads of one thread: its column,
// every kStep-th row; 32-bit index arithmetic keeps the addresses cheap).
// They stay in the compute type until store_slice converts them, so that
// nothing waits for them before the current slice's products.
template <typename T, typename Tl>
__device__ __forceinline__ void load_slice(const T* __restrict__ w, int kin, int cout, int k0, int n0,
                                           T (&pre)[Tl::kLoads]) {
  constexpr int kStep = kThreads / Tl::kCols;
  const int kk = k0 + threadIdx.x / Tl::kCols, c = n0 + threadIdx.x % Tl::kCols;
  const int base = kk * cout + c;
#pragma unroll
  for (int u = 0; u < Tl::kLoads; ++u) pre[u] = (c < cout && kk + u * kStep < kin) ? w[base + u * kStep * cout] : T();
}

// The slice in f32 into ws [kDepth][kCols].
template <typename T, typename Tl>
__device__ __forceinline__ void store_slice(float* ws, const T (&pre)[Tl::kLoads]) {
#pragma unroll
  for (int u = 0; u < Tl::kLoads; ++u) ws[threadIdx.x + u * kThreads] = to_f<T>(pre[u]);
}

// acc[i][j] = fmaf(act[k][row i], ws[k][col j], acc[i][j]) for one k.
template <int TR, int TC>
__device__ __forceinline__ void fma_step(const float* ak, const float* wk, int rg, int cg,
                                         float (&acc)[TR][TC]) {
  using Tl = Tile<TR, TC>;
  float av[TR], wv[TC];
#pragma unroll
  for (int h = 0; h < TR / 4; ++h) {
    const float4 v = *reinterpret_cast<const float4*>(ak + Tl::row(rg, 4 * h));
    av[4 * h] = v.x, av[4 * h + 1] = v.y, av[4 * h + 2] = v.z, av[4 * h + 3] = v.w;
  }
#pragma unroll
  for (int h = 0; h < TC / 4; ++h) {
    const float4 v = *reinterpret_cast<const float4*>(wk + Tl::col(cg, 4 * h));
    wv[4 * h] = v.x, wv[4 * h + 1] = v.y, wv[4 * h + 2] = v.z, wv[4 * h + 3] = v.w;
  }
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
}

// acc += act[k] (x) w[k, n0 + ...] over k < kin in ascending order, W staged
// slice by slice in `ring` (two slices): the next slice's loads are in
// flight while the block multiplies the current one.  Every thread of the
// block must call it; it ends with a barrier, after which the ring is free.
template <typename T, int TR, int TC>
__device__ __forceinline__ void fma_chain(const float* act, const T* __restrict__ w, int kin, int cout, int n0,
                                          float* ring, int rg, int cg, float (&acc)[TR][TC]) {
  using Tl = Tile<TR, TC>;
  const int nsl = (kin + Tl::kDepth - 1) / Tl::kDepth;
  if (nsl == 0) return;
  T pre[Tl::kLoads];
  load_slice<T, Tl>(w, kin, cout, 0, n0, pre);
  store_slice<T, Tl>(ring, pre);
  __syncthreads();
  for (int s = 0; s < nsl; ++s) {
    const int k0 = s * Tl::kDepth;
    if (s + 1 < nsl) load_slice<T, Tl>(w, kin, cout, k0 + Tl::kDepth, n0, pre);
    const float* ws = ring + (s & 1) * kSlice;
    const float* ak = act + k0 * kLdr;
    if (kin - k0 >= Tl::kDepth) {
#pragma unroll
      for (int kk = 0; kk < Tl::kDepth; ++kk) fma_step<TR, TC>(ak + kk * kLdr, ws + kk * Tl::kCols, rg, cg, acc);
    } else {
      for (int kk = 0; kk < kin - k0; ++kk) fma_step<TR, TC>(ak + kk * kLdr, ws + kk * Tl::kCols, rg, cg, acc);
    }
    if (s + 1 < nsl) store_slice<T, Tl>(ring + ((s + 1) & 1) * kSlice, pre);
    __syncthreads();
  }
}

// Columns [n0, n0 + kCols) of layer l over the block's 64 rows: the sums,
// then relu(acc + b) rounded into `out` [cout][kLdr] (a hidden layer), or
// the max-pool into pooled / run_max (the last layer).  Every thread of the
// block must call it.
template <typename T, int TR, int TC>
__device__ __forceinline__ void layer_pass(const Args& a, const Layers& L, int l, const float* in, float* out,
                                           float* ring, int n0, const Pool& pool) {
  using Tl = Tile<TR, TC>;
  const int tid = threadIdx.x, rg = tid % Tl::kRowThreads, cg = tid / Tl::kRowThreads;
  const int cout = L.width[l];
  float acc[TR][TC];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = 0.f;

  // Layer l's input, or layer 0's over the staged rows [c3(3) | feat(cs)]:
  // feats·W0f (no chain without it).
  const bool feats = l == 0 && a.w0f;
  fma_chain<T, TR, TC>(feats ? in + 3 * kLdr : in, static_cast<const T*>(l > 0 ? L.w[l] : a.w0f),
                       l > 0 ? L.width[l - 1] : (feats ? a.cs : 0), cout, n0, ring, rg, cg, acc);
  if (l == 0 && !a.w0f && a.prelifted) {  // the prelifted layer-0 terms
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int c = n0 + Tl::col(cg, j);
#pragma unroll
      for (int i = 0; i < TR; ++i) acc[i][j] = c < cout ? in[(3 + c) * kLdr + Tl::row(rg, i)] : 0.f;
    }
  }
  if (l == 0 && a.w0x) {  // + c3·W0x, a sum of its own (from 0, k = 0, 1, 2) added afterwards
    const T* w0x = static_cast<const T*>(a.w0x);
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int c = n0 + Tl::col(cg, j);
      const float wx0 = c < cout ? to_f<T>(w0x[c]) : 0.f;
      const float wx1 = c < cout ? to_f<T>(w0x[cout + c]) : 0.f;
      const float wx2 = c < cout ? to_f<T>(w0x[2 * cout + c]) : 0.f;
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const int r = Tl::row(rg, i);
        float x = fmaf(in[r], wx0, 0.f);
        x = fmaf(in[kLdr + r], wx1, x);
        x = fmaf(in[2 * kLdr + r], wx2, x);
        acc[i][j] += x;
      }
    }
  }

  if (l + 1 < L.n) {  // a hidden layer: relu(acc + b), rounded, into out[c][row]
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int c = n0 + Tl::col(cg, j);
      if (c >= cout) continue;
      const float bias = L.b[l][c];
#pragma unroll
      for (int h = 0; h < TR / 4; ++h) {
        float4 v;
        v.x = round_to<T>(fmaxf(acc[4 * h][j] + bias, 0.f));
        v.y = round_to<T>(fmaxf(acc[4 * h + 1][j] + bias, 0.f));
        v.z = round_to<T>(fmaxf(acc[4 * h + 2][j] + bias, 0.f));
        v.w = round_to<T>(fmaxf(acc[4 * h + 3][j] + bias, 0.f));
        *reinterpret_cast<float4*>(out + c * kLdr + Tl::row(rg, 4 * h)) = v;
      }
    }
    return;
  }

  // The last layer: the max of relu(acc + b) over each aligned group of 4
  // rows (one query's) into part [16][kCols], in the ring, which fma_chain
  // left free; then one thread a (query, column) over the query's groups.
  float* part = ring;
#pragma unroll
  for (int j = 0; j < TC; ++j) {
    const int c = Tl::col(cg, j);
    const float bias = n0 + c < cout ? L.b[l][n0 + c] : 0.f;
#pragma unroll
    for (int h = 0; h < TR / 4; ++h) {
      float mx = fmaxf(acc[4 * h][j] + bias, 0.f);
#pragma unroll
      for (int q = 1; q < 4; ++q) mx = fmaxf(mx, fmaxf(acc[4 * h + q][j] + bias, 0.f));
      part[(Tl::row(rg, 4 * h) / 4) * Tl::kCols + c] = mx;
    }
  }
  __syncthreads();
  const int groups = pool.nsp / 4;
  T* pooled = static_cast<T*>(a.pooled);
  for (int t = tid; t < a.qpb * Tl::kCols; t += kThreads) {
    const int ql = t / Tl::kCols, c = t - ql * Tl::kCols, col = n0 + c;
    if (col >= cout) continue;
    float mx = pool.s0 == 0 ? -INFINITY : pool.run_max[ql * cout + col];
    for (int g = ql * groups; g < (ql + 1) * groups; ++g) mx = fmaxf(mx, part[g * Tl::kCols + c]);
    if (!pool.last) {
      pool.run_max[ql * cout + col] = mx;
    } else if (pool.qrow[ql] >= 0) {
      pooled[(static_cast<size_t>(blockIdx.y) * a.m + pool.qrow[ql]) * cout + col] = from_f<T>(mx);
    }
  }
  __syncthreads();  // the ring is free again
}

// Layer l in passes of the tile its width takes.  A kernel built for two
// blocks an SM (128 registers a thread) takes 8 x 4 sums a thread in passes
// of 128 columns above 64 output columns, and 4 x 4 in one pass of 64 up to
// 64; one built for three (80 registers) takes 4 x 4 in passes of 64.  (8 x
// 8 in passes of 256 read as fast at SSG's SA2 on an H100 and spilled
// registers beside the others; 8 x 4 in the three-block build spilled.)
template <typename T, int MinBlocks>
__device__ __forceinline__ void layer(const Args& a, const Layers& L, int l, const float* in, float* out,
                                      float* ring, const Pool& pool) {
  const int cout = L.width[l];
  if (MinBlocks < 3 && cout > 64) {
    for (int n0 = 0; n0 < cout; n0 += Tile<8, 4>::kCols) layer_pass<T, 8, 4>(a, L, l, in, out, ring, n0, pool);
  } else {
    for (int n0 = 0; n0 < cout; n0 += Tile<4, 4>::kCols) layer_pass<T, 4, 4>(a, L, l, in, out, ring, n0, pool);
  }
}

// Steps 2-4 for the block's queries of cloud blockIdx.y.  sidx [qpb, K]: the
// selected point of each (query, slot); qrow [qpb]: each query's index in
// [0, M), or -1 for a dummy query (staged from query 0, never written out).
// buf: the floats plan_mlp_pool counts, 16-byte aligned: the
// activations A [wa][kLdr] (staged rows, odd layers) and B [wb][kLdr] (even
// layers), the W ring [2][kSlice], then [Cout] when K > 64.  MinBlocks: the
// blocks an SM the kernel is built for (min_blocks).
template <typename T, int MinBlocks>
__device__ __forceinline__ void mlp_pool(const Args& a, const Layers& L, const int* sidx, const int* qrow,
                                         float* buf) {
  const int k = a.k, qpb = a.qpb;
  const int kc = min(k, kMaxRows);  // slots per chunk: all of them when K <= 64
  float* act_a = buf;
  float* act_b = act_a + a.wa * kLdr;
  float* ring = act_b + a.wb * kLdr;
  float* run_max = ring + 2 * kSlice;  // [cout] across chunks (K > 64 only)
  const int b = blockIdx.y, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* cloud = a.ball ? a.xyz + static_cast<size_t>(b) * a.n * 3 : nullptr;
  const T* src = static_cast<const T*>(a.src);

  for (int s0 = 0; s0 < k; s0 += kc) {
    const int ns = min(kc, k - s0), nsp = round_up4(ns), used = qpb * nsp;

    // 2. Stage the rows [c3 | feat[idx]] of slots [s0, s0 + ns): query ql's
    //    slot s in row ql * nsp + s, its pad rows repeating slot ns - 1,
    //    zeros past qpb * nsp.  c3: one thread a (row, coordinate).  The
    //    features: warp w takes rows w + 8 i, and issues the loads of its
    //    eight rows before it stores them, 32 columns at a time.
    for (int e = threadIdx.x; e < kMaxRows * 3; e += kThreads) {
      const int r = e / 3, j = e - 3 * r;
      const int ql = min(r / nsp, qpb - 1), s = min(r - ql * nsp, ns - 1);
      const int bq = b * a.m + max(qrow[ql], 0);
      float v = 0.f;
      if (r < used && a.ball) {
        v = round_to<T>(cloud[3 * sidx[ql * k + s0 + s] + j] - a.new_xyz[bq * 3 + j]);
      } else if (r < used && a.grouped) {
        v = round_to<T>(a.grouped[static_cast<size_t>(bq * k + s0 + s) * 3 + j]);
      }
      act_a[j * kLdr + r] = v;
    }
    if (src) {
      constexpr int kWarps = kThreads / 32, kRows = kMaxRows / kWarps;
      const T* cloud_src = src + static_cast<size_t>(b) * a.n * a.cs;
      int off[kRows];  // each row's source row, or -1 for a zero row
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = warp + i * kWarps, ql = min(r / nsp, qpb - 1), s = min(r - ql * nsp, ns - 1);
        off[i] = r < used ? sidx[ql * k + s0 + s] * a.cs : -1;
      }
      for (int j0 = 0; j0 < a.cs; j0 += 32) {
        const int j = j0 + lane;
        T v[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) v[i] = (j < a.cs && off[i] >= 0) ? cloud_src[off[i] + j] : T();
        if (j < a.cs) {
#pragma unroll
          for (int i = 0; i < kRows; ++i) act_a[(3 + j) * kLdr + warp + i * kWarps] = to_f<T>(v[i]);
        }
      }
    }
    __syncthreads();

    // 3.-4. The layers: layer l reads `in` and writes `out`, alternating
    //       buffers; the last pools.
    const Pool pool{s0, nsp, s0 + ns >= k, qrow, run_max};
    const float* in = act_a;
    for (int l = 0; l < L.n; ++l) {
      float* out = (l % 2 == 0) ? act_b : act_a;
      layer<T, MinBlocks>(a, L, l, in, out, ring, pool);
      in = out;
    }
  }
}

// Fills the layer table, QPB and the two buffer widths; returns the floats
// mlp_pool<T>'s buffer needs, or 0 for a K or layer count it does not take.
// The same for both compute types; a template so that a build can
// specialise it with mlp_pool (studies/sa_mma.cuh).
template <typename T>
size_t plan_mlp_pool(Args& a, Layers& L, int n_layers, const int* widths, const void* const* weights,
                     const float* const* biases) {
  if (a.k < 1 || a.k > kMaxK || n_layers < 1 || n_layers > kMaxLayers) return 0;
  a.qpb = a.k >= kMaxRows ? 1 : kMaxRows / round_up4(a.k);
  L.n = n_layers;
  // Buffer A holds the staged rows and the outputs of odd hidden layers,
  // buffer B the outputs of even hidden layers (the last layer stores none).
  a.wa = 3 + a.cs;
  a.wb = 1;
  for (int l = 0; l < n_layers; ++l) {
    L.width[l] = widths[l];
    L.w[l] = weights[l];
    L.b[l] = biases[l];
    if (l + 1 < n_layers) {
      int& w = (l % 2 == 0) ? a.wb : a.wa;
      w = max(w, widths[l]);
    }
  }
  // The two buffers, the W ring, and run_max when K > 64.
  size_t words = static_cast<size_t>(kLdr) * (a.wa + a.wb) + 2 * kSlice;
  if (a.k > kMaxRows) words += widths[n_layers - 1];
  return words;
}

// The blocks an SM a kernel with `smem` bytes of dynamic shared memory a
// block is built for: three where three fit in the SM's 228 KB (1 KB of it
// reserved a block), as at SSG's SA1, else two, as at its SA2.
inline int min_blocks(size_t smem) { return 3 * (smem + 1024) <= 228 * 1024 ? 3 : 2; }

// Launches `kernel` with `smem` bytes of dynamic shared memory.
template <typename K, typename... P>
cudaError_t launch_with_smem(K kernel, dim3 grid, size_t smem, cudaStream_t stream, P... args) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// info = {registers a thread, local-memory bytes a thread, smem, resident
// blocks of kThreads per SM at `smem` bytes of dynamic shared memory}.
template <typename K>
cudaError_t kernel_info(K kernel, size_t smem, int* info) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  int blocks = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = static_cast<int>(smem);
  info[3] = blocks;
  return err;
}

}  // namespace
