// k-nearest-neighbour search for Hopper (sm_90a): the general kNN and the
// self-kNN graph.
//
// knn_launch replaces scanobjectnn_tpu/ops/pallas/knn_kernel.py:
// knn_point_pallas (body _knn_general_kernel); knn_graph_tile_kernel replaces
// knn_graph_pallas (body _knn_kernel), DGCNN's per-layer feature-space graph
// with the self edge included.  Semantics are documented in
// scanobjectnn_torch/ops/cuda/knn_kernel.py.  The TPU kernels build a
// [T, N] distance block with one MXU matmul and run k argmin rounds over it.
// On the card the general kNN takes one of four routes, which the wrapper's
// plan (knn_kernel.point_plan) picks and knn_launch checks; the graph kernel
// (k <= 32) computes a tile of distances a block and selects from it a warp
// a query (below).
//
// Distance: max(qq - 2*inner + kk, 0) + bias, every sum in ascending channel
// order with __fmul_rn/__fadd_rn (nvcc may not contract them into FMAs), so
// the bits equal the plain version's elementwise tensor ops.  A query's
// distance to itself is exactly 0 (inner == qq, bit for bit).  Ties: a key
// enters a list only when strictly below its last entry and behind every
// entry it does not beat, and keys come in ascending index, so the lowest
// index wins a tie.  Slots no key filled
// (N < k, or distances that are +inf or NaN) stay (+inf, 0).
//
// Bound: operations.  A (query, key) pair costs about 2C + 4 f32 operations
// (the inner product, the expansion, the clamp, one compare); the bytes are
// the points read once and the outputs.  At the FP decoder's fp3 (B=32,
// M=1024 queries, N=512 keys, C=3) that is 16.8M pairs, 2.5 us at the card's
// 67 TFLOP/s f32 rate; DGCNN's C=64 graph at B=32, N=1024 is 33.6M pairs of
// 132 operations, 66 us.  What the calls spend beyond that is the selection
// and, at small B*M, the card left empty.
//
// The group route (knn_group_kernel, k <= kGroupMaxK = 16): G lanes a
// query, G from the wrapper (knn_kernel.group_lanes: the least power of two
// that gives a launch about six warps an SM).  Each block stages a tile of
// its cloud's keys and their |k|^2 (and bias) in shared memory; lane l of a
// group scans the keys j with j % G == l into its own register list (KCAP
// >= k entries: 4, 8 or 16, unrolled; a key that does not beat the list's
// last entry skips the insertion), and the group merges its G sorted lists
// k times by a shuffle minimum of (distance bits, index).  The query row
// stays in registers at the compile-time widths 3 and 64.  An insertion
// costs about 5 KCAP instructions, and in a warp some lane inserts at
// nearly every key, so G = 1 stays the fastest where B*M fills the card
// (BGA's fp3, PointCNN's k = 8), and longer lists (32-64 entries, 130-255
// registers, spills) lost to the warp route at every k > 16 timed; hence
// the warp route (knn_warp_kernel, 16 < k <= 64): a warp a query, its list
// one entry a lane (two registers above k = 32), the keys 32 at a time, the
// cloud's first 32 sorted by a warp bitonic network; later keys below the
// k-th entry are buffered in shared memory and merged into the list 32 at
// a time (a bitonic sort of the buffer and bitonic merges), where one warp
// insertion a key (knn_graph_tile_kernel's rule) was slower at PointCNN's
// k > 16 calls (PERF.md §6).

// The selection (knn_select_kernel, k > 64): one block a query computes its
// distance to every key of its cloud, the same expressions in the same
// order, into shared memory as 64-bit words (the distance's order-preserving
// bits, then the key index), finds the k-th smallest word by a radix select
// (8-bit digits from the top, integer histograms in shared memory), compacts
// the min(k, N) words at or below it in index order and sorts only those
// (a bitonic sort).  A sort of all N words, the route before it, took 55
// stages of N/2 compare-exchanges at N = 1024 to keep 128.  A cloud of more
// than kSortTile (16384) keys (knn_select_tiled_kernel) is taken a tile of
// kSortTile keys at a time, each tile's first min(k, tile) words selected so,
// and merged into the query's running list of min(k, N) words, kept in a
// scratch buffer in device memory (two lists, read and written in turn):
// each word's place in the merged list is its rank in its own list plus the
// number of words of the other list below it (a binary search).  The words
// are distinct (the index is in the low bits), so the merge is exact and
// stable by construction: ties at the lowest index, +inf and NaN last.  A k
// whose selected words do not fit a block's shared memory with the tile's
// takes the full sort (knn_sort_kernel, knn_sort_tiled_kernel: every word
// of a tile sorted), the fourth route.
//
// The self-kNN graph above k = kGraphMaxK (32) is the general kNN with the
// cloud as its own queries (knn_graph_launch), on the plan the wrapper makes
// for it: the same bits as knn_graph_plain by construction.
//
// The self-kNN graph up to k = 32 (knn_graph_tile_kernel): the same pairs.
// With a query a thread, its divergent list insertion would hold a warp for
// every key any of the warp's 32 queries takes (most of the first ~640 keys
// at k = 20), and its C=64 inner products would be dependent chains; so a
// block computes a 64 x 64 tile of distances at a time, 16 independent
// chains a thread, and each warp selects from the tile's rows with a list
// held one entry a lane.  A query takes about k ln(N/k) + k insertions (98 measured
// at N=1024, k=20); the first 32 keys' share goes in as one warp sort, and
// each later insertion costs four warp-wide exchanges (its distance, its
// place, the entries moved).  Measured on an H100, the selection takes
// about 0.12 ms of DGCNN's C=3 graph at B=32, N=1024, k=20, ten times the
// arithmetic; keeping ranks in place of moving entries (two exchanges an
// insertion) was no faster.  Without contraction the inner products
// take two f32 instructions a channel, so the issue bound is 2C + 4
// instructions a pair at 33.5 T instructions/s (10 us at C=3 and 132 us at
// C=64 for that graph), not the FMA rate.
//
// The fused graph and gather (edge_gather_knn at k <= 32, replacing
// scanobjectnn_tpu/ops/pallas/edge_kernel.py: edge_gather_knn, body
// _knn_gather_kernel): the same graph kernels, built with an epilogue
// (GATHER), which, once a warp's lists are final, copies each query's k
// neighbour rows of a second tensor vals [b, n, Cv] (f32 or bf16, any Cv)
// into out [b, n, k, Cv], its indices taken from the list by shuffle, as
// well as writing idx.  The rows are copied as words of 8, 4 or 2 bytes (the
// widest that divides a row and both pointers' alignment): a row of at
// least 32 words a step, 32 words a lane at a time (Cv = 64 in f32: a float2
// a lane); a shorter row's words as one contiguous run of the query's k
// rows, a word a lane (Cv = 3 in f32: the k * 3 floats in order).  vals
// (8 MB at DGCNN's T-Net) stays in L2, and the 168 MB of rows are written
// without a second launch that rereads idx.  A null vals builds and launches
// the graph alone, so #11's own calls keep their code.

#include <cuda_runtime.h>

#include <cstdint>

#include "kernel_info.cuh"

namespace {

constexpr int kThreads = 128;            // threads of a group-route block
constexpr int kMaxK = 64;                // MAX_K of knn_kernel.py: the list routes
constexpr int kGroupMaxK = 16;           // GROUP_MAX_K of knn_kernel.py: the group route
constexpr int kGraphMaxK = 32;           // GRAPH_MAX_K of knn_kernel.py
constexpr int kSmemFloats = 12 * 1024;   // 48 KB: a key tile, its |k|^2 and bias
constexpr int kSortThreads = 256;        // threads of a selection or sort block
constexpr int kSortTile = 16384;         // SORT_TILE of knn_kernel.py
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// sum over i of a[i] * b[i] in ascending i, without contraction.  W > 0 is
// a compile-time width; W == 0 reads the width w at run time.
template <int W>
__device__ __forceinline__ float dot(const float* a, const float* b, int w) {
  const int width = W > 0 ? W : w;
  float s = __fmul_rn(a[0], b[0]);
#pragma unroll
  for (int i = 1; i < width; ++i) s = __fadd_rn(s, __fmul_rn(a[i], b[i]));
  return s;
}

// dot<W> of a query row in registers with a key row in shared memory; a
// width that is a multiple of 4 reads the key as float4 (16-byte aligned),
// in the same ascending order.
template <int W>
__device__ __forceinline__ float dot_row(const float (&q)[W], const float* kp) {
  if constexpr (W % 4 == 0) {
    const float4* k4 = reinterpret_cast<const float4*>(kp);
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < W / 4; ++v) {
      const float4 kv = k4[v];
      s = v == 0 ? __fmul_rn(q[0], kv.x) : __fadd_rn(s, __fmul_rn(q[4 * v], kv.x));
      s = __fadd_rn(s, __fmul_rn(q[4 * v + 1], kv.y));
      s = __fadd_rn(s, __fmul_rn(q[4 * v + 2], kv.z));
      s = __fadd_rn(s, __fmul_rn(q[4 * v + 3], kv.w));
    }
    return s;
  } else {
    return dot<W>(q, kp, W);
  }
}

// max(qq - 2 * inner + kk, 0), keeping a NaN.
__device__ __forceinline__ float expand(float qq, float inner, float kk) {
  const float d = __fadd_rn(__fsub_rn(qq, __fmul_rn(2.f, inner)), kk);
  return d < 0.f ? 0.f : d;
}

// Strict insertion of (d, j) into the ascending list (bd, bi), unrolled so
// the list stays in registers.  At step p bd[p] and bd[p - 1] still hold
// their values from before this key.
template <int KCAP>
__device__ __forceinline__ void insert(float (&bd)[KCAP], int (&bi)[KCAP], float d, int j) {
  if (!(d < bd[KCAP - 1])) return;
#pragma unroll
  for (int p = KCAP - 1; p > 0; --p) {
    if (d < bd[p - 1]) {
      bd[p] = bd[p - 1];
      bi[p] = bi[p - 1];
    } else if (d < bd[p]) {
      bd[p] = d;
      bi[p] = j;
    }
  }
  if (d < bd[0]) {
    bd[0] = d;
    bi[0] = j;
  }
}

template <int KCAP>
__device__ __forceinline__ void clear(float (&bd)[KCAP], int (&bi)[KCAP]) {
#pragma unroll
  for (int p = 0; p < KCAP; ++p) {
    bd[p] = inf_f();
    bi[p] = 0;
  }
}

// Order-preserving bits of a distance: unsigned order equals float order;
// -0 and +0 tie (the plain version's sort), a NaN sorts as +inf.
__device__ __forceinline__ uint32_t order_bits(float d) {
  if (d != d) d = inf_f();
  const uint32_t u = d == 0.f ? 0u : __float_as_uint(d);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_bits(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// The 64-bit word of a list entry: the distance's order bits, then the key
// index; unsigned order is (distance, index) order.
__device__ __forceinline__ unsigned long long entry_word(float d, int j) {
  return (static_cast<unsigned long long>(order_bits(d)) << 32) | static_cast<uint32_t>(j);
}

// Stage keys [base, base + count) of a cloud [n, width], their |k|^2 and,
// where cbias is not null, their bias in shared memory.  Every thread of the
// block must call it.
__device__ __forceinline__ void stage_tile(const float* __restrict__ cloud,
                                           const float* __restrict__ cbias, int base, int count,
                                           int width, float* skeys, float* skk, float* sbias) {
  __syncthreads();  // the last tile is no longer read
  for (int e = threadIdx.x; e < count * width; e += kThreads) {
    skeys[e] = cloud[static_cast<size_t>(base) * width + e];
  }
  if (cbias != nullptr) {
    for (int t = threadIdx.x; t < count; t += kThreads) sbias[t] = cbias[base + t];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < count; t += kThreads) {
    skk[t] = dot<0>(skeys + t * width, skeys + t * width, width);
  }
  __syncthreads();
}

// k nearest keys of each query, G = g lanes a query (g a power of two up to
// 32, chosen by the wrapper): lane l of a group scans the keys j with
// j % g == l in ascending index into its own list (insert: within a lane the
// lowest index wins a tie), KCAP >= k entries kept; then the group merges its
// g lists k times by a group-wide minimum of (distance bits, index), the
// lane whose head won dropping it.  The lists hold no +inf or NaN (the strict
// insertion never lets them in), so an empty head, (+inf, 0), loses to every
// entry and, once it wins, the rest of the row is (+inf, 0).  W as in dot.
template <int KCAP, int W>
__global__ void __launch_bounds__(kThreads)
    knn_group_kernel(const float* __restrict__ queries, const float* __restrict__ keys,
                     const float* __restrict__ bias, int m, int n, int c, int k, int tile, int g,
                     float* __restrict__ dist, int32_t* __restrict__ idx) {
  extern __shared__ __align__(16) float smem[];
  const int width = W > 0 ? W : c;
  float* skeys = smem;                // [tile, width]
  float* skk = skeys + tile * width;  // [tile]
  float* sbias = skk + tile;          // [tile]
  const int b = blockIdx.y;
  const int gl = threadIdx.x & (g - 1);  // the lane's place in its group
  const int qi = (blockIdx.x * kThreads + threadIdx.x) / g;
  const bool active = qi < m;  // no early return: every thread joins the barriers
  const float* q = queries + (static_cast<size_t>(b) * m + (active ? qi : 0)) * width;
  float qr[W > 0 ? W : 1];
  float qq;
  if constexpr (W > 0) {
#pragma unroll
    for (int i = 0; i < W; ++i) qr[i] = q[i];
    qq = dot<W>(qr, qr, W);
  } else {
    qr[0] = 0.f;
    qq = dot<0>(q, q, width);
  }
  float bd[KCAP];
  int bi[KCAP];
  clear(bd, bi);
  const float* cloud = keys + static_cast<size_t>(b) * n * width;
  const float* cbias = bias != nullptr ? bias + static_cast<size_t>(b) * n : nullptr;

  auto scan = [&](int base, int t) {
    const float* kp = skeys + t * width;
    float inner;
    if constexpr (W > 0) {
      inner = dot_row<W>(qr, kp);
    } else {
      inner = dot<0>(q, kp, width);
    }
    float d = expand(qq, inner, skk[t]);
    if (cbias != nullptr) d = __fadd_rn(d, sbias[t]);
    insert(bd, bi, d, base + t);
  };
  for (int base = 0; base < n; base += tile) {
    const int count = min(tile, n - base);
    stage_tile(cloud, cbias, base, count, width, skeys, skk, sbias);
    if (!active) continue;
    if (g == 1) {  // a unit stride, which the compiler unrolls: faster at BGA's fp3 than a run-time one
      for (int t = 0; t < count; ++t) scan(base, t);
    } else {
      for (int t = gl; t < count; t += g) scan(base, t);
    }
  }
  if (!active) return;  // a group's lanes share their query: they leave together
  const size_t row = (static_cast<size_t>(b) * m + qi) * k;
  if (g == 1) {
#pragma unroll
    for (int p = 0; p < KCAP; ++p) {
      if (p < k) {
        dist[row + p] = bd[p];
        idx[row + p] = bi[p];
      }
    }
    return;
  }
  const int lane = threadIdx.x & 31;
  const unsigned group = g == 32 ? kFull : ((1u << g) - 1u) << (lane & ~(g - 1));
  unsigned long long head = entry_word(bd[0], bi[0]);
  for (int r = 0; r < k; ++r) {
    unsigned long long best = head;
    for (int s = 1; s < g; s <<= 1) {
      const unsigned long long o = __shfl_xor_sync(group, best, s, g);
      best = o < best ? o : best;
    }
    if (gl == (r & (g - 1))) {
      const float d = from_order_bits(static_cast<uint32_t>(best >> 32));
      const bool real = d < inf_f();
      dist[row + r] = real ? d : inf_f();
      idx[row + r] = real ? static_cast<int>(best & 0xffffffffu) : 0;
    }
    if (head == best) {  // this lane's head won (or the group's lists are all empty)
#pragma unroll
      for (int p = 0; p + 1 < KCAP; ++p) {
        bd[p] = bd[p + 1];
        bi[p] = bi[p + 1];
      }
      bd[KCAP - 1] = inf_f();
      bi[KCAP - 1] = 0;
      head = entry_word(bd[0], bi[0]);
    }
  }
}

// Self-kNN graph at k <= kGraphMaxK.  A block takes kGraphQT queries of one
// cloud and walks the cloud's keys in tiles of kGraphKT, staged in shared
// memory with the queries (channel-major; a width above kGraphSlice in
// slices of that many channels, the queries staged again for each; C = 64
// by cp.async, below).  Each thread sums a 4 x 4 register tile of inner
// products: independent chains of __fmul_rn/__fadd_rn in ascending channel
// order, each from -0, the additive identity (its first sum is its first
// product, bit for bit, as dot's), 16-byte shared loads feeding several
// products.  The tile is expanded with |q|^2 and |k|^2, which
// graph_norms_kernel computed once a point, into a distance tile in shared
// memory.  Then each warp walks the rows of its kGraphRows queries 32 keys
// at a time, in ascending key order, against the query's list, which the
// warp holds one entry a lane, ascending.  The cloud's first 32 keys are
// sorted by (distance, index) with a warp bitonic network and the first k
// make the list.  After that a ballot marks the keys below the list's k-th
// entry; they go in lowest lane first, each tested again against the k-th
// entry as it then stands (bit k-1 of ballot(entry <= d)), at position
// popc(ballot(entry <= d)), and the entries from there up move one lane up
// (__shfl_up_sync).  An equal distance stays behind the lower index already
// in the list, +inf and NaN never pass the strict test, and slots no key
// filled keep (+inf, 0).
constexpr int kGraphThreads = 256;                           // 8 warps, 16 x 16 over a tile's pairs
constexpr int kGraphQT = 64;                                 // queries a block: 4 a thread
constexpr int kGraphKT = 64;                                 // keys a tile: 4 a thread
constexpr int kGraphSlice = 64;                              // channels staged at once
constexpr int kGraphRows = kGraphQT / (kGraphThreads / 32);  // lists a warp keeps
constexpr int kGraphMinBlocks = 4;                           // blocks an SM: 64 registers a thread

static_assert(kGraphQT == 4 * (kGraphThreads / 16) && kGraphKT == 4 * 16, "4 x 4 pairs a thread");
static_assert(kGraphKT % 32 == 0, "the selection reads 32 keys at a time");

// |x|^2 of each of `total` points [total, c]: dot<W> of the row with itself.
template <int W>
__global__ void graph_norms_kernel(const float* __restrict__ feats, long long total, int c,
                                   float* __restrict__ norms) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const float* row = feats + i * (W > 0 ? W : c);
  norms[i] = dot<W>(row, row, c);
}

// Rows [row0, row0 + rows) of a cloud [n, width], channels [c0, c0 + cs),
// into dst [cs][STRIDE] channel-major; rows from `rows` to STRIDE are zero.
// Every thread of the block calls it.  VEC reads four channels at once (the
// cloud 16-byte aligned, width, c0 and cs multiples of 4).
template <bool VEC, int STRIDE>
__device__ __forceinline__ void stage_rows(const float* __restrict__ cloud, int width, int row0, int rows,
                                           int c0, int cs, float* dst) {
  if constexpr (VEC) {
    for (int e = threadIdx.x; e < STRIDE * (cs >> 2); e += kGraphThreads) {
      const int v = e / STRIDE, j = e - v * STRIDE;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j < rows) x = *reinterpret_cast<const float4*>(cloud + static_cast<size_t>(row0 + j) * width + c0 + 4 * v);
      float* col = dst + 4 * v * STRIDE + j;
      col[0] = x.x;
      col[STRIDE] = x.y;
      col[2 * STRIDE] = x.z;
      col[3 * STRIDE] = x.w;
    }
  } else {
    for (int e = threadIdx.x; e < STRIDE * cs; e += kGraphThreads) {
      const int ch = e / STRIDE, j = e - ch * STRIDE;
      dst[ch * STRIDE + j] = j < rows ? cloud[static_cast<size_t>(row0 + j) * width + c0 + ch] : 0.f;
    }
  }
}

// Shared bytes of a knn_graph_tile_kernel block that stages `slice` channels.
constexpr size_t graph_smem_bytes(int slice) {
  return sizeof(float) * (static_cast<size_t>(slice) * (kGraphQT + kGraphKT) + kGraphQT * kGraphKT + kGraphQT +
                          kGraphKT);
}

// (d, i) of each lane sorted ascending across the warp by (distance,
// index): a bitonic network of 15 exchange steps.
__device__ __forceinline__ void warp_sort(float& d, int& i, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float od = __shfl_xor_sync(kFull, d, stride);
      const int oi = __shfl_xor_sync(kFull, i, stride);
      const bool other_first = od < d || (od == d && oi < i);
      const bool keep_first = ((lane & stride) == 0) == ((lane & size) == 0);
      if (other_first == keep_first) {
        d = od;
        i = oi;
      }
    }
  }
}

// One key tile's selection for the calling warp's kGraphRows queries: rows
// warp * kGraphRows + t of the distance tile sd [kGraphQT][kGraphKT], which
// the warp wrote itself, keys [base, base + count) of the cloud.  ld and li
// are the warp's lists, lane p holding entry p.
__device__ __forceinline__ void select_tile(const float* sd, int base, int count, int qrows, int k,
                                            float (&ld)[kGraphRows], int (&li)[kGraphRows]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned kmask = k >= 32 ? kFull : (1u << k) - 1u;
#pragma unroll
  for (int t = 0; t < kGraphRows; ++t) {
    const int r = warp * kGraphRows + t;
    if (r >= qrows) break;  // warp-uniform
    const float* row = sd + r * kGraphKT;
    int h0 = 0;
    if (base == 0) {
      // The cloud's first 32 keys: sorted by (distance, index), the first
      // k make the list (+inf and NaN never: slots (+inf, 0)).
      float d = lane < count ? row[lane] : inf_f();
      int i = lane;
      if (!(d < inf_f())) d = inf_f();
      warp_sort(d, i, lane);
      const bool keep = lane < k && d < inf_f();
      ld[t] = keep ? d : inf_f();
      li[t] = keep ? i : 0;
      h0 = 32;
    }
    float thr = __shfl_sync(kFull, ld[t], k - 1);
#pragma unroll
    for (int h = h0; h < kGraphKT; h += 32) {
      const float d = h + lane < count ? row[h + lane] : inf_f();
      unsigned cand = __ballot_sync(kFull, d < thr);
      while (cand) {  // warp-uniform
        const int s = __ffs(cand) - 1;
        cand &= cand - 1;
        const float dc = __shfl_sync(kFull, d, s);
        const unsigned below = __ballot_sync(kFull, ld[t] <= dc);
        if ((below >> (k - 1)) & 1u) continue;  // the k-th entry is not above dc
        const int pos = __popc(below & kmask);
        const float up_d = __shfl_up_sync(kFull, ld[t], 1);
        const int up_i = __shfl_up_sync(kFull, li[t], 1);
        if (lane > pos) {
          ld[t] = up_d;
          li[t] = up_i;
        } else if (lane == pos) {
          ld[t] = dc;
          li[t] = base + h + s;
        }
      }
      thr = __shfl_sync(kFull, ld[t], k - 1);
    }
  }
}

// The warp's lists, lane p < k writing entry p of each of its queries.
__device__ __forceinline__ void write_lists(int32_t* __restrict__ idx, int b, int n, int q0, int qrows, int k,
                                            const int (&li)[kGraphRows]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int t = 0; t < kGraphRows; ++t) {
    const int r = warp * kGraphRows + t;
    if (r < qrows && lane < k) idx[(static_cast<size_t>(b) * n + q0 + r) * k + lane] = li[t];
  }
}

// Stores of the fused gather's rows: streaming (__stcs), unless a build
// defines KNN_GATHER_STREAM to 0 (plain stores, which studies/ball_edge.py
// times beside them).  The rows (168 MB at the T-Net) pass through L2 once
// either way; streamed, the T-Net's call took 0.2359 ms against 0.2578 by
// CUDA events on an H100.
#ifndef KNN_GATHER_STREAM
#define KNN_GATHER_STREAM 1
#endif
template <typename T>
__device__ __forceinline__ void store_word(T* p, T v) {
  if constexpr (KNN_GATHER_STREAM) {
    __stcs(p, v);
  } else {
    *p = v;
  }
}

// The fused gather's epilogue: for each of the warp's queries, the rows of
// vals [n, units] (the cloud's, in words of type T) at the k indices of its
// list (lane s holding slot s's) into out [n, k, units], an exact copy.
template <typename T>
__device__ __forceinline__ void gather_lists(const T* __restrict__ vals, T* __restrict__ out, int b, int n, int q0,
                                             int qrows, int k, int units, const int (&li)[kGraphRows]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* cloud = vals + static_cast<size_t>(b) * n * units;
#pragma unroll
  for (int t = 0; t < kGraphRows; ++t) {
    const int r = warp * kGraphRows + t;
    if (r >= qrows) break;  // warp-uniform
    T* dst = out + (static_cast<size_t>(b) * n + q0 + r) * k * units;
    if (units >= 32) {  // a row a step
#pragma unroll 4
      for (int s = 0; s < k; ++s) {
        const T* src = cloud + static_cast<size_t>(__shfl_sync(kFull, li[t], s)) * units;
        for (int u = lane; u < units; u += 32) store_word(dst + s * units + u, src[u]);
      }
    } else {  // the k rows' words in order, a word a lane
      const int total = k * units;
      for (int e0 = 0; e0 < total; e0 += 32) {
        const int e = e0 + lane;
        const int s = min(e / units, k - 1);
        const int p = __shfl_sync(kFull, li[t], s);
        if (e < total) store_word(dst + e, cloud[static_cast<size_t>(p) * units + (e - s * units)]);
      }
    }
  }
}

// The fused gather's arguments: vals [b, n, row bytes] and out [b, n, k, row
// bytes], copied in words of `word` bytes (8, 4 or 2), `units` words a row.
struct GatherArgs {
  const void* vals;
  void* out;
  int units, word;
};

template <bool GATHER>
__device__ __forceinline__ void gather_epilogue(const GatherArgs& g, int b, int n, int q0, int qrows, int k,
                                                const int (&li)[kGraphRows]) {
  if constexpr (GATHER) {
    if (g.word == 8) {
      gather_lists(static_cast<const uint2*>(g.vals), static_cast<uint2*>(g.out), b, n, q0, qrows, k, g.units, li);
    } else if (g.word == 4) {
      gather_lists(static_cast<const unsigned*>(g.vals), static_cast<unsigned*>(g.out), b, n, q0, qrows, k, g.units,
                   li);
    } else {
      gather_lists(static_cast<const unsigned short*>(g.vals), static_cast<unsigned short*>(g.out), b, n, q0, qrows,
                   k, g.units, li);
    }
  }
}

// Self-kNN over a cloud [n, c] with its norms [n] (graph_norms_kernel):
// writes the indices (GATHER: and the rows, gather_epilogue).  k <= 32; any
// width (in slices of kGraphSlice channels above it).  A thread's pairs are queries 4tq.. x keys 4tk.. of
// the tile, and a warp's queries are the rows it selects from.
template <bool GATHER>
__global__ void __launch_bounds__(kGraphThreads, kGraphMinBlocks)
    knn_graph_tile_kernel(const float* __restrict__ feats, const float* __restrict__ norms, int n, int c, int k,
                          int32_t* __restrict__ idx, GatherArgs gather) {
  extern __shared__ __align__(16) float smem[];
  const int slice = min(c, kGraphSlice);
  float* sq = smem;                       // [slice][kGraphQT]
  float* sk = sq + slice * kGraphQT;      // [slice][kGraphKT]
  float* sd = sk + slice * kGraphKT;      // [kGraphQT][kGraphKT]
  float* sqq = sd + kGraphQT * kGraphKT;  // [kGraphQT]
  float* skk = sqq + kGraphQT;            // [kGraphKT]
  const int b = blockIdx.y, q0 = blockIdx.x * kGraphQT;
  const int qrows = min(kGraphQT, n - q0);
  const float* cloud = feats + static_cast<size_t>(b) * n * c;
  const float* cnorm = norms + static_cast<size_t>(b) * n;
  const int tid = threadIdx.x;
  const int tq = tid >> 4, tk = tid & 15;
  const bool one_slice = c <= slice;
  if (tid < kGraphQT) sqq[tid] = tid < qrows ? cnorm[q0 + tid] : 0.f;
  if (one_slice) stage_rows<false, kGraphQT>(cloud, c, q0, qrows, 0, c, sq);
  float ld[kGraphRows];  // lane p: entry p of each list (distance, key)
  int li[kGraphRows];
#pragma unroll
  for (int t = 0; t < kGraphRows; ++t) {
    ld[t] = inf_f();
    li[t] = 0;
  }

  for (int base = 0; base < n; base += kGraphKT) {
    const int count = min(kGraphKT, n - base);
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = -0.f;
    }
    for (int c0 = 0; c0 < c; c0 += slice) {
      const int cs = min(slice, c - c0);
      __syncthreads();  // the last tile's keys are no longer read
      if (!one_slice) stage_rows<false, kGraphQT>(cloud, c, q0, qrows, c0, cs, sq);
      stage_rows<false, kGraphKT>(cloud, c, base, count, c0, cs, sk);
      if (c0 == 0 && tid < kGraphKT) skk[tid] = tid < count ? cnorm[base + tid] : 0.f;
      __syncthreads();
#pragma unroll 4
      for (int ch = 0; ch < cs; ++ch) {
        const float4 qv = *reinterpret_cast<const float4*>(sq + ch * kGraphQT + 4 * tq);
        const float4 kv = *reinterpret_cast<const float4*>(sk + ch * kGraphKT + 4 * tk);
        const float qa[4] = {qv.x, qv.y, qv.z, qv.w}, ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(qa[i], ka[j]));
        }
      }
    }
    const float4 kk = *reinterpret_cast<const float4*>(skk + 4 * tk);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float qq = sqq[4 * tq + i];
      const float4 d = make_float4(expand(qq, acc[i][0], kk.x), expand(qq, acc[i][1], kk.y),
                                   expand(qq, acc[i][2], kk.z), expand(qq, acc[i][3], kk.w));
      *reinterpret_cast<float4*>(sd + (4 * tq + i) * kGraphKT + 4 * tk) = d;
    }
    __syncwarp();  // the warp's rows are its own
    select_tile(sd, base, count, qrows, k, ld, li);
  }
  write_lists(idx, b, n, q0, qrows, k, li);
  gather_epilogue<GATHER>(gather, b, n, q0, qrows, k, li);
}

// A key tile of a cloud [n, 64] for knn_graph_tile64_kernel: keys [base,
// base + count) into dst [kGraphKT][kGraph64Stride] row-major by cp.async
// (16 bytes a copy, rows from count on filled with zeros), committed as one
// group.  Every thread of the block calls it.
constexpr int kGraph64Stride = 68;  // floats a staged key row: conflict-free 16-byte loads
__device__ __forceinline__ void stage_keys64(const float* __restrict__ cloud, int base, int count, float* dst) {
  for (int e = threadIdx.x; e < kGraphKT * 16; e += kGraphThreads) {
    const int j = e >> 4, v = e & 15;
    const float* src = cloud + static_cast<size_t>(base + (j < count ? j : 0)) * 64 + 4 * v;
    const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst + j * kGraph64Stride + 4 * v));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(to), "l"(src), "r"(j < count ? 16 : 0));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void wait_keys64() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Shared bytes of a knn_graph_tile64_kernel block.
constexpr size_t graph64_smem_bytes() {
  return sizeof(float) * (64 * kGraphQT + kGraphKT * kGraph64Stride + kGraphQT * kGraphKT + kGraphQT);
}

// knn_graph_tile_kernel at C = 64 over a 16-byte aligned cloud.  The key
// tiles are copied row-major by cp.async, each issued as soon as every warp
// has multiplied the tile before it, so that it lands while the warps
// expand and select; a thread's keys are tk, tk + 16, tk + 32 and tk + 48
// of the tile, read four channels at a time from rows kGraph64Stride floats
// apart (no bank conflicts), and the same chains in the same order.
template <bool GATHER>
__global__ void __launch_bounds__(kGraphThreads, kGraphMinBlocks)
    knn_graph_tile64_kernel(const float* __restrict__ feats, const float* __restrict__ norms, int n, int k,
                            int32_t* __restrict__ idx, GatherArgs gather) {
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;                             // [64][kGraphQT] channel-major
  float* sk = sq + 64 * kGraphQT;               // [kGraphKT][kGraph64Stride] row-major
  float* sd = sk + kGraphKT * kGraph64Stride;   // [kGraphQT][kGraphKT]
  float* sqq = sd + kGraphQT * kGraphKT;        // [kGraphQT]
  const int b = blockIdx.y, q0 = blockIdx.x * kGraphQT;
  const int qrows = min(kGraphQT, n - q0);
  const float* cloud = feats + static_cast<size_t>(b) * n * 64;
  const float* cnorm = norms + static_cast<size_t>(b) * n;
  const int tid = threadIdx.x;
  const int tq = tid >> 4, tk = tid & 15;
  stage_keys64(cloud, 0, min(kGraphKT, n), sk);
  if (tid < kGraphQT) sqq[tid] = tid < qrows ? cnorm[q0 + tid] : 0.f;
  stage_rows<true, kGraphQT>(cloud, 64, q0, qrows, 0, 64, sq);
  float ld[kGraphRows];  // lane p: entry p of each list (distance, key)
  int li[kGraphRows];
#pragma unroll
  for (int t = 0; t < kGraphRows; ++t) {
    ld[t] = inf_f();
    li[t] = 0;
  }
  wait_keys64();
  __syncthreads();

  for (int base = 0; base < n; base += kGraphKT) {
    const int count = min(kGraphKT, n - base);
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = -0.f;
    }
#pragma unroll 4
    for (int v = 0; v < 16; ++v) {
      float4 kv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = *reinterpret_cast<const float4*>(sk + (tk + 16 * j) * kGraph64Stride + 4 * v);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 qv = *reinterpret_cast<const float4*>(sq + (4 * v + u) * kGraphQT + 4 * tq);
        const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
        float ka[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) ka[j] = u == 0 ? kv[j].x : u == 1 ? kv[j].y : u == 2 ? kv[j].z : kv[j].w;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(qa[i], ka[j]));
        }
      }
    }
    __syncthreads();  // every warp has read this key tile
    if (base + kGraphKT < n) stage_keys64(cloud, base + kGraphKT, min(kGraphKT, n - base - kGraphKT), sk);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = tk + 16 * j;
      const float kk = key < count ? cnorm[base + key] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) sd[(4 * tq + i) * kGraphKT + key] = expand(sqq[4 * tq + i], acc[i][j], kk);
    }
    __syncwarp();  // the warp's rows are its own
    select_tile(sd, base, count, qrows, k, ld, li);
    wait_keys64();
    __syncthreads();  // the next key tile is in
  }
  write_lists(idx, b, n, q0, qrows, k, li);
  gather_epilogue<GATHER>(gather, b, n, q0, qrows, k, li);
}

// k nearest keys of one query (blockIdx.x of cloud blockIdx.y) for any k:
// all N distances sorted in shared memory (npow = N rounded up to a power
// of two).  W as in dot.
template <int W>
__global__ void __launch_bounds__(kSortThreads)
    knn_sort_kernel(const float* __restrict__ queries, const float* __restrict__ keys,
                    const float* __restrict__ bias, int m, int n, int c, int k, int npow,
                    float* __restrict__ dist, int32_t* __restrict__ idx) {
  extern __shared__ __align__(16) unsigned long long skey[];
  const int width = W > 0 ? W : c;
  const int b = blockIdx.y, qi = blockIdx.x;
  const float* q = queries + (static_cast<size_t>(b) * m + qi) * width;
  const float qq = dot<W>(q, q, width);
  const float* cloud = keys + static_cast<size_t>(b) * n * width;
  for (int j = threadIdx.x; j < npow; j += kSortThreads) {
    unsigned long long key = ~0ull;
    if (j < n) {
      const float* kp = cloud + static_cast<size_t>(j) * width;
      float d = expand(qq, dot<W>(q, kp, width), dot<W>(kp, kp, width));
      if (bias != nullptr) d = __fadd_rn(d, bias[static_cast<size_t>(b) * n + j]);
      key = (static_cast<unsigned long long>(order_bits(d)) << 32) | static_cast<uint32_t>(j);
    }
    skey[j] = key;
  }
  __syncthreads();
  for (int size = 2; size <= npow; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < npow / 2; i += kSortThreads) {
        const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
        const unsigned long long a = skey[lo], z = skey[hi];
        if ((a > z) == ((lo & size) == 0)) {
          skey[lo] = z;
          skey[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  const size_t row = (static_cast<size_t>(b) * m + qi) * k;
  for (int p = threadIdx.x; p < k; p += kSortThreads) {
    float d = inf_f();
    int j = 0;
    if (p < n) {
      const float v = from_order_bits(static_cast<uint32_t>(skey[p] >> 32));
      if (v < inf_f()) {
        d = v;
        j = static_cast<int>(skey[p] & 0xffffffffu);
      }
    }
    dist[row + p] = d;
    idx[row + p] = j;
  }
}

// k nearest keys of each query at k <= kMaxK, a warp a query (the warp
// route of knn_launch): a block takes kWarpQT queries of one cloud (their
// rows and |q|^2 staged channel-major in shared memory) and walks the
// cloud's keys in tiles staged channel-major (a row stride of tile + 1
// floats: a warp's 32 keys of one channel, and a staging warp's 32 channels
// of one key, fall in 32 banks).  Each warp keeps the lists of kWarpRows
// queries, E entries a lane (entry p in lane p % 32 of register p / 32), and
// takes a tile 32 keys at a time: lane t's distance to key h + t, the same
// expressions in the same order as dot and expand, then select_chunk (the
// cloud's first 32 keys sorted by a warp bitonic network; after that the
// keys below the k-th entry buffered, 32 at most, in the query's slot of a
// shared buffer and merged into the list by flush_buffer).
constexpr int kWarpThreads = 256;                             // 8 warps
constexpr int kWarpRows = 2;                                  // queries a warp keeps lists for
constexpr int kWarpQT = kWarpRows * (kWarpThreads / 32);      // queries a block
constexpr int kWarpQS = kWarpQT + 1;                          // row stride of the staged queries
// Four blocks an SM (64 registers, no spill), two queries a warp: on an H100
// at PointCNN's five calls with k > 16 faster than four queries a warp at
// two blocks an SM (the lists' shuffle chains want warps more than rows a
// warp; PERF.md §6).
constexpr int kWarpMinBlocks = 4;

// Keys a tile of the warp route at width c within kSmemFloats, a multiple
// of 32 (0: the width does not fit), and its shared bytes.
constexpr int kWarpBufFloats = 2 * kWarpQT * 32;              // the rows' candidate buffers

int warp_tile(int n, int c) {
  const int fit = (kSmemFloats - c * kWarpQS - kWarpQT - c - kWarpBufFloats) / (c + 2);
  const int need = (n + 31) / 32 * 32;
  const int tile = (fit < need ? fit : need) / 32 * 32;
  return tile > 0 ? tile : 0;
}

size_t warp_smem_bytes(int c, int tile) {
  return sizeof(float) * (static_cast<size_t>(c) * kWarpQS + kWarpQT + static_cast<size_t>(c) * (tile + 1) + 2 * tile +
                          kWarpBufFloats);
}

// (da, ia) before (db, ib): by distance, then index.
__device__ __forceinline__ bool entry_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// A bitonic sequence of 32 entries, one a lane, sorted ascending by
// (distance, index): compare-exchanges at strides 16, 8, 4, 2, 1.
__device__ __forceinline__ void bitonic_finish(float& d, int& i, int lane) {
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    const float od = __shfl_xor_sync(kFull, d, stride);
    const int oi = __shfl_xor_sync(kFull, i, stride);
    if (entry_less(od, oi, d, i) == ((lane & stride) == 0)) {
      d = od;
      i = oi;
    }
  }
}

// Merge a query's buffered candidates (sd, si: bn of them, in the warp's
// shared buffer) into its list: the buffer sorted by a warp bitonic network,
// reversed against the list (E = 1) or its second register (E = 2), the
// lane-wise minimum (the 32 smallest of both, a bitonic sequence) sorted;
// at E = 2 the two registers then merged the same way (minimum and
// maximum).  A list entry that ties a buffered one on distance has the
// lower index (keys come in ascending index), so the order is the strict
// insertion's.  thr: entry k - 1 afterwards.
template <int E>
__device__ __forceinline__ void flush_buffer(const float* sd, const int* si, int& bn, int k, float& d0, int& i0,
                                             float& d1, int& i1, float& thr) {
  const int lane = threadIdx.x & 31;
  __syncwarp();  // the buffer's writes are visible
  float d = lane < bn ? sd[lane] : inf_f();
  int i = lane < bn ? si[lane] : 0;
  warp_sort(d, i, lane);
  const float rd = __shfl_sync(kFull, d, 31 - lane);
  const int ri = __shfl_sync(kFull, i, 31 - lane);
  float& md = E == 1 ? d0 : d1;
  int& mi = E == 1 ? i0 : i1;
  if (entry_less(rd, ri, md, mi)) {
    md = rd;
    mi = ri;
  }
  bitonic_finish(md, mi, lane);
  if constexpr (E == 2) {
    const float hd = __shfl_sync(kFull, d1, 31 - lane);
    const int hi = __shfl_sync(kFull, i1, 31 - lane);
    const bool swap = entry_less(hd, hi, d0, i0);
    d1 = swap ? d0 : hd;
    i1 = swap ? i0 : hi;
    if (swap) {
      d0 = hd;
      i0 = hi;
    }
    bitonic_finish(d0, i0, lane);
    bitonic_finish(d1, i1, lane);
  }
  bn = 0;
  __syncwarp();  // the buffer is read before it is written again
  thr = __shfl_sync(kFull, E == 1 ? d0 : d1, (k - 1) & 31);
}

// One 32-key chunk of a query's selection: lane t holds d, the distance to
// key j0 + t (+inf past the tile).  The list: (d0, i0) in lane p is entry
// p, (d1, i1) entry 32 + p (E = 2 only); the cloud's first chunk makes it
// (sorted by a warp bitonic network, its first min(k, 32) kept).  Later keys
// below entry k - 1 (thr) go to the query's buffer (sd, si, bn entries),
// which is merged into the list when the next chunk's would not fit.
template <int E>
__device__ __forceinline__ void select_chunk(float d, int j0, int k, bool first, float* sd, int* si, int& bn,
                                             float& d0, int& i0, float& d1, int& i1, float& thr) {
  const int lane = threadIdx.x & 31;
  if (first) {
    float dd = d < inf_f() ? d : inf_f();  // +inf and NaN never: slots (+inf, 0)
    int i = lane;
    warp_sort(dd, i, lane);
    const bool keep = lane < k && dd < inf_f();
    d0 = keep ? dd : inf_f();
    i0 = keep ? j0 + i : 0;
    thr = __shfl_sync(kFull, E == 1 ? d0 : d1, (k - 1) & 31);
    return;
  }
  unsigned cand = __ballot_sync(kFull, d < thr);
  if (bn + __popc(cand) > 32) {  // warp-uniform
    flush_buffer<E>(sd, si, bn, k, d0, i0, d1, i1, thr);
    cand = __ballot_sync(kFull, d < thr);
  }
  if ((cand >> lane) & 1u) {
    const int at = bn + __popc(cand & ((1u << lane) - 1u));
    sd[at] = d;
    si[at] = j0 + lane;
  }
  bn += __popc(cand);
}

// E = 1 at k <= 32, 2 at k <= 64; W = 3 keeps the query rows and a key's
// channels in registers, W = 0 reads them from shared memory.
template <int E, int W>
__global__ void __launch_bounds__(kWarpThreads, kWarpMinBlocks)
    knn_warp_kernel(const float* __restrict__ queries, const float* __restrict__ keys,
                    const float* __restrict__ bias, int m, int n, int c, int k, int tile,
                    float* __restrict__ dist, int32_t* __restrict__ idx) {
  extern __shared__ __align__(16) float smem[];
  const int width = W > 0 ? W : c;
  const int ld_k = tile + 1;
  float* sq = smem;                     // [width][kWarpQS]
  float* sqq = sq + width * kWarpQS;    // [kWarpQT]
  float* skeys = sqq + kWarpQT;         // [width][tile + 1]
  float* skk = skeys + width * ld_k;    // [tile]
  float* sbias = skk + tile;            // [tile]
  float* sbd = sbias + tile;            // [kWarpQT][32]: the rows' buffered candidates
  int* sbi = reinterpret_cast<int*>(sbd + kWarpQT * 32);
  const int b = blockIdx.y, q0 = blockIdx.x * kWarpQT;
  const int qrows = min(kWarpQT, m - q0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* cq = queries + (static_cast<size_t>(b) * m + q0) * width;
  for (int e = tid; e < kWarpQT * width; e += kWarpThreads) {
    const int r = e / width, ch = e - r * width;
    sq[ch * kWarpQS + r] = r < qrows ? cq[e] : 0.f;
  }
  __syncthreads();
  if (tid < kWarpQT) {
    float t = __fmul_rn(sq[tid], sq[tid]);
    for (int ch = 1; ch < width; ++ch) t = __fadd_rn(t, __fmul_rn(sq[ch * kWarpQS + tid], sq[ch * kWarpQS + tid]));
    sqq[tid] = t;
  }
  constexpr int QW = W > 0 ? W : 1;
  float qv0[kWarpRows], qv1[kWarpRows], qv2[kWarpRows];  // W = 3: the rows' channels
  float qq[kWarpRows], thr[kWarpRows];
  float d0[kWarpRows], d1[kWarpRows];  // the lists (select_chunk)
  int i0[kWarpRows], i1[kWarpRows];
  int bn[kWarpRows];  // entries in each row's buffer
  static_assert(QW == 1 || QW == 3, "the warp route keeps rows of width 3 in registers");
  __syncthreads();
#pragma unroll
  for (int rr = 0; rr < kWarpRows; ++rr) {
    const int r = warp * kWarpRows + rr;
    qq[rr] = sqq[r];
    qv0[rr] = sq[r];
    qv1[rr] = W == 3 ? sq[kWarpQS + r] : 0.f;
    qv2[rr] = W == 3 ? sq[2 * kWarpQS + r] : 0.f;
    d0[rr] = d1[rr] = thr[rr] = inf_f();
    i0[rr] = i1[rr] = bn[rr] = 0;
  }
  const float* cloud = keys + static_cast<size_t>(b) * n * width;
  const float* cbias = bias != nullptr ? bias + static_cast<size_t>(b) * n : nullptr;

  for (int base = 0; base < n; base += tile) {
    const int count = min(tile, n - base);
    __syncthreads();  // the last tile is no longer read
    for (int e = tid; e < count * width; e += kWarpThreads) {
      const int t = e / width, ch = e - t * width;
      skeys[ch * ld_k + t] = cloud[static_cast<size_t>(base) * width + e];
    }
    if (cbias != nullptr) {
      for (int t = tid; t < count; t += kWarpThreads) sbias[t] = cbias[base + t];
    }
    __syncthreads();
    for (int t = tid; t < count; t += kWarpThreads) {
      float kk = __fmul_rn(skeys[t], skeys[t]);
      for (int ch = 1; ch < width; ++ch) kk = __fadd_rn(kk, __fmul_rn(skeys[ch * ld_k + t], skeys[ch * ld_k + t]));
      skk[t] = kk;
    }
    __syncthreads();
    for (int h = 0; h < count; h += 32) {
      const int t = h + lane;
      const bool valid = t < count;
      const int tt = valid ? t : 0;
      const float k0 = skeys[tt];
      const float k1 = W == 3 ? skeys[ld_k + tt] : 0.f;
      const float k2 = W == 3 ? skeys[2 * ld_k + tt] : 0.f;
      const float kk = skk[tt];
      const float kb = cbias != nullptr ? sbias[tt] : 0.f;
      float inner[kWarpRows];  // each row's chain in ascending channel order
#pragma unroll
      for (int rr = 0; rr < kWarpRows; ++rr) inner[rr] = __fmul_rn(qv0[rr], k0);
      if constexpr (W == 3) {
#pragma unroll
        for (int rr = 0; rr < kWarpRows; ++rr) {
          inner[rr] = __fadd_rn(inner[rr], __fmul_rn(qv1[rr], k1));
          inner[rr] = __fadd_rn(inner[rr], __fmul_rn(qv2[rr], k2));
        }
      } else {
        for (int ch = 1; ch < width; ++ch) {  // a key channel read once for the warp's rows
          const float kc = skeys[ch * ld_k + tt];
          const float* qc = sq + ch * kWarpQS + warp * kWarpRows;
#pragma unroll
          for (int rr = 0; rr < kWarpRows; ++rr) inner[rr] = __fadd_rn(inner[rr], __fmul_rn(qc[rr], kc));
        }
      }
#pragma unroll
      for (int rr = 0; rr < kWarpRows; ++rr) {
        const int r = warp * kWarpRows + rr;
        if (r < qrows) {  // warp-uniform
          float d = expand(qq[rr], inner[rr], kk);
          if (cbias != nullptr) d = __fadd_rn(d, kb);
          const int row = warp * kWarpRows + rr;
          select_chunk<E>(valid ? d : inf_f(), base + h, k, base + h == 0, sbd + row * 32, sbi + row * 32, bn[rr],
                          d0[rr], i0[rr], d1[rr], i1[rr], thr[rr]);
        }
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < kWarpRows; ++rr) {
    const int r = warp * kWarpRows + rr;
    if (r < qrows) {
      if (bn[rr] > 0) flush_buffer<E>(sbd + r * 32, sbi + r * 32, bn[rr], k, d0[rr], i0[rr], d1[rr], i1[rr], thr[rr]);
      const size_t row = (static_cast<size_t>(b) * m + q0 + r) * k;
      if (lane < k) {
        dist[row + lane] = d0[rr];
        idx[row + lane] = i0[rr];
      }
      if (E == 2 && 32 + lane < k) {
        dist[row + 32 + lane] = d1[rr];
        idx[row + 32 + lane] = i1[rr];
      }
    }
  }
}

// Words of list[0, len) below x (a binary search; the words are distinct).
__device__ __forceinline__ int count_below(const unsigned long long* list, int len, unsigned long long x) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (list[mid] < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// knn_sort_kernel for a cloud of more than kSortTile keys: each tile of
// kSortTile keys sorted as there, its first min(k, tile) words merged into
// the running list; scratch holds two lists of min(k, n) words a query.
template <int W>
__global__ void __launch_bounds__(kSortThreads)
    knn_sort_tiled_kernel(const float* __restrict__ queries, const float* __restrict__ keys,
                          const float* __restrict__ bias, int m, int n, int c, int k,
                          unsigned long long* __restrict__ scratch, float* __restrict__ dist,
                          int32_t* __restrict__ idx) {
  extern __shared__ __align__(16) unsigned long long skey[];
  const int width = W > 0 ? W : c;
  const int b = blockIdx.y, qi = blockIdx.x;
  const int keep = min(k, n);
  const float* q = queries + (static_cast<size_t>(b) * m + qi) * width;
  const float qq = dot<W>(q, q, width);
  const float* cloud = keys + static_cast<size_t>(b) * n * width;
  unsigned long long* run = scratch + (static_cast<size_t>(b) * m + qi) * 2 * keep;
  unsigned long long* next = run + keep;
  int cur = 0;  // words in run
  for (int base = 0; base < n; base += kSortTile) {
    const int count = min(kSortTile, n - base);
    int npow = 1;
    while (npow < count) npow <<= 1;
    for (int jj = threadIdx.x; jj < npow; jj += kSortThreads) {
      unsigned long long key = ~0ull;
      if (jj < count) {
        const int j = base + jj;
        const float* kp = cloud + static_cast<size_t>(j) * width;
        float d = expand(qq, dot<W>(q, kp, width), dot<W>(kp, kp, width));
        if (bias != nullptr) d = __fadd_rn(d, bias[static_cast<size_t>(b) * n + j]);
        key = (static_cast<unsigned long long>(order_bits(d)) << 32) | static_cast<uint32_t>(j);
      }
      skey[jj] = key;
    }
    __syncthreads();
    for (int size = 2; size <= npow; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int i = threadIdx.x; i < npow / 2; i += kSortThreads) {
          const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
          const unsigned long long a = skey[lo], z = skey[hi];
          if ((a > z) == ((lo & size) == 0)) {
            skey[lo] = z;
            skey[hi] = a;
          }
        }
        __syncthreads();
      }
    }
    const int take = min(keep, count), len = min(keep, cur + take);
    for (int i = threadIdx.x; i < take; i += kSortThreads) {
      const int pos = i + count_below(run, cur, skey[i]);
      if (pos < len) next[pos] = skey[i];
    }
    for (int i = threadIdx.x; i < cur; i += kSortThreads) {
      const int pos = i + count_below(skey, take, run[i]);
      if (pos < len) next[pos] = run[i];
    }
    __syncthreads();  // next is complete; skey and run are free
    unsigned long long* t = run;
    run = next;
    next = t;
    cur = len;
  }
  const size_t row = (static_cast<size_t>(b) * m + qi) * k;
  for (int p = threadIdx.x; p < k; p += kSortThreads) {
    float d = inf_f();
    int j = 0;
    if (p < cur) {
      const float v = from_order_bits(static_cast<uint32_t>(run[p] >> 32));
      if (v < inf_f()) {
        d = v;
        j = static_cast<int>(run[p] & 0xffffffffu);
      }
    }
    dist[row + p] = d;
    idx[row + p] = j;
  }
}

// The k > kMaxK route by selection (knn_select_kernel, knn_select_tiled_kernel):
// the same words as the sort, but only the first min(k, count) of them are
// sorted.  select_words finds the k-th smallest word by a radix select over
// its 8-bit digits from the top (a block histogram of the digit among the
// words that match the digits fixed so far, integer shared atomics added a
// warp's equal digits at once; then the digit at which the running count
// reaches the rank still wanted), stopping at the first digit whose words
// are all wanted.  The words at or below the prefix found are compacted in
// index order (a block scan of per-thread counts over contiguous runs):
// exactly min(k, count) of them, the words being distinct; a bitonic sort of
// those orders them.
constexpr int kRadixBins = 256;
constexpr int kSelectAux = 4 + kSortThreads / 32;  // ints: the digit found, and the warps' counts
constexpr size_t kSmemMax = 232448;                // the most shared memory a block may use (227 KB)

int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Shared bytes of a select block for clouds of n keys at k: the words of a
// tile (at most kSortTile), the selected words padded to a power of two, the
// histogram and the scratch ints.
size_t select_smem_bytes(int n, int k) {
  const int words = n < kSortTile ? n : kSortTile;
  const int sel = pow2_at_least(k < words ? k : words);
  return sizeof(unsigned long long) * (static_cast<size_t>(words) + sel) + sizeof(unsigned) * kRadixBins +
         sizeof(int) * kSelectAux;
}

// The `take` smallest of the distinct words w[0, count) (1 <= take <= count)
// sorted ascending into sel[0, take), sel[take, spow) = ~0 (spow a power of
// two >= take).  hist: kRadixBins counters, aux: kSelectAux ints.  Every
// thread of the block calls it; it returns after a barrier.
__device__ void select_words(const unsigned long long* w, int count, int take, unsigned long long* sel, int spow,
                             unsigned* hist, int* aux) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int shift = 64;                 // the words taken: (word >> shift) <= prefix (all at 64)
  unsigned long long prefix = 0;  // the digits fixed so far
  if (take < count) {
    int remaining = take;  // the rank still wanted among the words that match the prefix
    for (shift = 56;; shift -= 8) {
      for (int i = tid; i < kRadixBins; i += kSortThreads) hist[i] = 0;
      __syncthreads();
      for (int j0 = warp * 32; j0 < count; j0 += kSortThreads) {  // every lane of a warp in step
        const int j = j0 + lane;
        int bin = -1;
        if (j < count) {
          const unsigned long long x = w[j];
          if (shift == 56 || (x >> (shift + 8)) == prefix) bin = static_cast<int>((x >> shift) & 255u);
        }
        const unsigned peers = __match_any_sync(kFull, bin);
        if (bin >= 0 && lane == __ffs(peers) - 1) atomicAdd(&hist[bin], static_cast<unsigned>(__popc(peers)));
      }
      __syncthreads();
      if (warp == 0) {
        unsigned cnt[kRadixBins / 32], own = 0;
#pragma unroll
        for (int u = 0; u < kRadixBins / 32; ++u) {
          cnt[u] = hist[lane * (kRadixBins / 32) + u];
          own += cnt[u];
        }
        unsigned incl = own;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const unsigned t = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += t;
        }
        unsigned before = incl - own;
        if (before < static_cast<unsigned>(remaining) && static_cast<unsigned>(remaining) <= incl) {
          bool found = false;
#pragma unroll
          for (int u = 0; u < kRadixBins / 32; ++u) {
            if (!found) {
              if (before + cnt[u] >= static_cast<unsigned>(remaining)) {
                found = true;
                aux[0] = lane * (kRadixBins / 32) + u;
                aux[1] = static_cast<int>(before);
                aux[2] = static_cast<int>(cnt[u]);
              } else {
                before += cnt[u];
              }
            }
          }
        }
      }
      __syncthreads();
      remaining -= aux[1];
      prefix = (prefix << 8) | static_cast<unsigned>(aux[0]);
      if (aux[2] == remaining) break;  // every word of this digit is wanted (always so at shift 0)
    }
  }
  // Compaction in index order: thread t takes words [t * per, (t + 1) * per).
  const int per = (count + kSortThreads - 1) / kSortThreads;
  const int j0 = min(tid * per, count), j1 = min(j0 + per, count);
  int mine = 0;
  for (int j = j0; j < j1; ++j) mine += shift == 64 || (w[j] >> shift) <= prefix;
  int incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) aux[4 + warp] = incl;
  __syncthreads();
  int at = incl - mine;
  for (int i = 0; i < warp; ++i) at += aux[4 + i];
  for (int j = j0; j < j1; ++j) {
    const unsigned long long x = w[j];
    if (shift == 64 || (x >> shift) <= prefix) sel[at++] = x;
  }
  for (int i = take + tid; i < spow; i += kSortThreads) sel[i] = ~0ull;
  __syncthreads();
  for (int size = 2; size <= spow; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < spow / 2; i += kSortThreads) {
        const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
        const unsigned long long a = sel[lo], z = sel[hi];
        if ((a > z) == ((lo & size) == 0)) {
          sel[lo] = z;
          sel[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

// The word of query q's distance to key j of a cloud (knn_sort_kernel's).
template <int W>
__device__ __forceinline__ unsigned long long key_word(const float* q, float qq, const float* cloud,
                                                       const float* cbias, int j, int width) {
  const float* kp = cloud + static_cast<size_t>(j) * width;
  float d = expand(qq, dot<W>(q, kp, width), dot<W>(kp, kp, width));
  if (cbias != nullptr) d = __fadd_rn(d, cbias[j]);
  return entry_word(d, j);
}

// Row p < k of a query's output from its sorted words (len of them).
__device__ __forceinline__ void write_word(const unsigned long long* words, int len, int p, float* dist,
                                           int32_t* idx) {
  float d = inf_f();
  int j = 0;
  if (p < len) {
    const float v = from_order_bits(static_cast<uint32_t>(words[p] >> 32));
    if (v < inf_f()) {
      d = v;
      j = static_cast<int>(words[p] & 0xffffffffu);
    }
  }
  *dist = d;
  *idx = j;
}

// k nearest keys of one query (blockIdx.x of cloud blockIdx.y), n <= kSortTile:
// its n words in shared memory, the first min(k, n) selected and sorted.
template <int W>
__global__ void __launch_bounds__(kSortThreads)
    knn_select_kernel(const float* __restrict__ queries, const float* __restrict__ keys,
                      const float* __restrict__ bias, int m, int n, int c, int k, int spow,
                      float* __restrict__ dist, int32_t* __restrict__ idx) {
  extern __shared__ __align__(16) unsigned long long swords[];
  unsigned long long* sel = swords + n;                          // [spow]
  unsigned* hist = reinterpret_cast<unsigned*>(sel + spow);      // [kRadixBins]
  int* aux = reinterpret_cast<int*>(hist + kRadixBins);          // [kSelectAux]
  const int width = W > 0 ? W : c;
  const int b = blockIdx.y, qi = blockIdx.x;
  const float* q = queries + (static_cast<size_t>(b) * m + qi) * width;
  const float qq = dot<W>(q, q, width);
  const float* cloud = keys + static_cast<size_t>(b) * n * width;
  const float* cbias = bias != nullptr ? bias + static_cast<size_t>(b) * n : nullptr;
  for (int j = threadIdx.x; j < n; j += kSortThreads) swords[j] = key_word<W>(q, qq, cloud, cbias, j, width);
  __syncthreads();
  const int take = min(k, n);
  select_words(swords, n, take, sel, spow, hist, aux);
  const size_t row = (static_cast<size_t>(b) * m + qi) * k;
  for (int p = threadIdx.x; p < k; p += kSortThreads) write_word(sel, take, p, dist + row + p, idx + row + p);
}

// knn_select_kernel for a cloud of more than kSortTile keys: each tile's
// first min(k, tile) words selected and sorted, then merged into the running
// list as knn_sort_tiled_kernel merges them.
template <int W>
__global__ void __launch_bounds__(kSortThreads)
    knn_select_tiled_kernel(const float* __restrict__ queries, const float* __restrict__ keys,
                            const float* __restrict__ bias, int m, int n, int c, int k, int spow,
                            unsigned long long* __restrict__ scratch, float* __restrict__ dist,
                            int32_t* __restrict__ idx) {
  extern __shared__ __align__(16) unsigned long long swords[];
  unsigned long long* sel = swords + kSortTile;                  // [spow]
  unsigned* hist = reinterpret_cast<unsigned*>(sel + spow);      // [kRadixBins]
  int* aux = reinterpret_cast<int*>(hist + kRadixBins);          // [kSelectAux]
  const int width = W > 0 ? W : c;
  const int b = blockIdx.y, qi = blockIdx.x;
  const int keep = min(k, n);
  const float* q = queries + (static_cast<size_t>(b) * m + qi) * width;
  const float qq = dot<W>(q, q, width);
  const float* cloud = keys + static_cast<size_t>(b) * n * width;
  const float* cbias = bias != nullptr ? bias + static_cast<size_t>(b) * n : nullptr;
  unsigned long long* run = scratch + (static_cast<size_t>(b) * m + qi) * 2 * keep;
  unsigned long long* next = run + keep;
  int cur = 0;  // words in run
  for (int base = 0; base < n; base += kSortTile) {
    const int count = min(kSortTile, n - base);
    for (int jj = threadIdx.x; jj < count; jj += kSortThreads) {
      swords[jj] = key_word<W>(q, qq, cloud, cbias, base + jj, width);
    }
    __syncthreads();
    const int take = min(keep, count), len = min(keep, cur + take);
    select_words(swords, count, take, sel, spow, hist, aux);
    for (int i = threadIdx.x; i < take; i += kSortThreads) {
      const int pos = i + count_below(run, cur, sel[i]);
      if (pos < len) next[pos] = sel[i];
    }
    for (int i = threadIdx.x; i < cur; i += kSortThreads) {
      const int pos = i + count_below(sel, take, run[i]);
      if (pos < len) next[pos] = run[i];
    }
    __syncthreads();  // next is complete; swords, sel and run are free
    unsigned long long* t = run;
    run = next;
    next = t;
    cur = len;
  }
  const size_t row = (static_cast<size_t>(b) * m + qi) * k;
  for (int p = threadIdx.x; p < k; p += kSortThreads) write_word(run, cur, p, dist + row + p, idx + row + p);
}

// The routes of knn_launch (knn_kernel.point_plan picks one for a call).
enum Route { kGroupRoute = 0, kWarpRoute = 1, kSelectRoute = 2, kSortRoute = 3 };

// A kernel of dynamic shared memory `smem` on grid x threads, the limit raised
// above 48 KB.
template <typename K, typename... A>
cudaError_t run_kernel(K kernel, dim3 grid, int threads, size_t smem, cudaStream_t s, A... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, s>>>(args...);
  return cudaGetLastError();
}

// The full sort (knn_sort_kernel, knn_sort_tiled_kernel): any k.
cudaError_t launch_sort(const float* q, const float* keys, const float* bias, int b, int m, int n,
                        int c, int k, float* dist, int32_t* idx, unsigned long long* scratch,
                        cudaStream_t s) {
  int npow = 1;
  while (npow < n && npow < kSortTile) npow <<= 1;
  const size_t smem = sizeof(unsigned long long) * static_cast<size_t>(npow);
  const dim3 grid(m, b);
  if (n > kSortTile) {
    return c == 3 ? run_kernel(knn_sort_tiled_kernel<3>, grid, kSortThreads, smem, s, q, keys, bias, m, n, c, k,
                               scratch, dist, idx)
                  : run_kernel(knn_sort_tiled_kernel<0>, grid, kSortThreads, smem, s, q, keys, bias, m, n, c, k,
                               scratch, dist, idx);
  }
  return c == 3 ? run_kernel(knn_sort_kernel<3>, grid, kSortThreads, smem, s, q, keys, bias, m, n, c, k, npow, dist,
                             idx)
                : run_kernel(knn_sort_kernel<0>, grid, kSortThreads, smem, s, q, keys, bias, m, n, c, k, npow, dist,
                             idx);
}

// The selection (knn_select_kernel, knn_select_tiled_kernel): any k whose
// select_smem_bytes fit a block.
cudaError_t launch_select(const float* q, const float* keys, const float* bias, int b, int m, int n,
                          int c, int k, float* dist, int32_t* idx, unsigned long long* scratch,
                          cudaStream_t s) {
  const size_t smem = select_smem_bytes(n, k);
  const int spow = pow2_at_least(min(k, min(n, kSortTile)));
  const dim3 grid(m, b);
  if (n > kSortTile) {
    return c == 3 ? run_kernel(knn_select_tiled_kernel<3>, grid, kSortThreads, smem, s, q, keys, bias, m, n, c, k,
                               spow, scratch, dist, idx)
                  : run_kernel(knn_select_tiled_kernel<0>, grid, kSortThreads, smem, s, q, keys, bias, m, n, c, k,
                               spow, scratch, dist, idx);
  }
  return c == 3 ? run_kernel(knn_select_kernel<3>, grid, kSortThreads, smem, s, q, keys, bias, m, n, c, k, spow,
                             dist, idx)
                : run_kernel(knn_select_kernel<0>, grid, kSortThreads, smem, s, q, keys, bias, m, n, c, k, spow,
                             dist, idx);
}

// Keys a tile of the group route, and its shared bytes.
int group_tile(int n, int c) {
  const int fit = kSmemFloats / (c + 2);
  return n < fit ? n : fit;
}

size_t group_smem_bytes(int tile, int c) { return sizeof(float) * static_cast<size_t>(tile) * (c + 2); }

template <int KCAP, int W>
cudaError_t launch_group(const float* q, const float* keys, const float* bias, int b, int m, int n,
                         int c, int k, int g, float* dist, int32_t* idx, cudaStream_t s) {
  const int tile = group_tile(n, c);
  const int per_block = kThreads / g;
  const dim3 grid((m + per_block - 1) / per_block, b);
  knn_group_kernel<KCAP, W><<<grid, kThreads, group_smem_bytes(tile, c), s>>>(q, keys, bias, m, n, c, k, tile, g,
                                                                              dist, idx);
  return cudaGetLastError();
}

// C = 3 (points) and C = 64 (DGCNN's EdgeConv 2-4 features) keep the query
// row in registers; other widths re-read it.
template <int KCAP>
cudaError_t launch_group_c(const float* q, const float* keys, const float* bias, int b, int m, int n,
                           int c, int k, int g, float* dist, int32_t* idx, cudaStream_t s) {
  if (c == 3) return launch_group<KCAP, 3>(q, keys, bias, b, m, n, c, k, g, dist, idx, s);
  if (c == 64) return launch_group<KCAP, 64>(q, keys, bias, b, m, n, c, k, g, dist, idx, s);
  return launch_group<KCAP, 0>(q, keys, bias, b, m, n, c, k, g, dist, idx, s);
}

template <int E>
cudaError_t launch_warp(const float* q, const float* keys, const float* bias, int b, int m, int n, int c, int k,
                        float* dist, int32_t* idx, cudaStream_t s) {
  const int tile = warp_tile(n, c);
  const dim3 grid((m + kWarpQT - 1) / kWarpQT, b);
  const size_t smem = warp_smem_bytes(c, tile);
  return c == 3 ? run_kernel(knn_warp_kernel<E, 3>, grid, kWarpThreads, smem, s, q, keys, bias, m, n, c, k, tile,
                             dist, idx)
                : run_kernel(knn_warp_kernel<E, 0>, grid, kWarpThreads, smem, s, q, keys, bias, m, n, c, k, tile,
                             dist, idx);
}

bool is_group_width(int g) { return g >= 1 && g <= 32 && (g & (g - 1)) == 0; }

// Whether knn_launch can run a (route, group) plan at (n, c, k).
bool plan_ok(int route, int group, int n, int c, int k) {
  switch (route) {
    case kGroupRoute: return k <= kGroupMaxK && is_group_width(group) && c + 2 <= kSmemFloats;
    case kWarpRoute: return k <= kMaxK && warp_tile(n, c) >= 32;
    case kSelectRoute: return select_smem_bytes(n, k) <= kSmemMax;
    case kSortRoute: return true;
    default: return false;
  }
}

cudaError_t launch_point(const float* q, const float* kp, const float* bp, int b, int m, int n, int c, int k,
                         int route, int g, float* d, int32_t* i, unsigned long long* scratch, cudaStream_t s) {
  if (!plan_ok(route, g, n, c, k)) return cudaErrorInvalidValue;
  if ((route == kSelectRoute || route == kSortRoute) && n > kSortTile && scratch == nullptr) {
    return cudaErrorInvalidValue;
  }
  switch (route) {
    case kGroupRoute:
      if (k <= 4) return launch_group_c<4>(q, kp, bp, b, m, n, c, k, g, d, i, s);
      if (k <= 8) return launch_group_c<8>(q, kp, bp, b, m, n, c, k, g, d, i, s);
      return launch_group_c<16>(q, kp, bp, b, m, n, c, k, g, d, i, s);
    case kWarpRoute:
      return k <= 32 ? launch_warp<1>(q, kp, bp, b, m, n, c, k, d, i, s)
                     : launch_warp<2>(q, kp, bp, b, m, n, c, k, d, i, s);
    case kSelectRoute: return launch_select(q, kp, bp, b, m, n, c, k, d, i, scratch, s);
    default: return launch_sort(q, kp, bp, b, m, n, c, k, d, i, scratch, s);
  }
}

// C = 64 (DGCNN's EdgeConv 2-4) takes knn_graph_tile64_kernel where the
// cloud is 16-byte aligned, as its 16-byte copies need; every other width,
// C = 3 included, the run-time width.  A compile-time C = 3 build spilled
// 8-16 bytes at 64 registers in every variant tried on an H100, and at 80
// registers (three blocks an SM) it took 0.22 ms against 0.17 at DGCNN's
// C=3 graph; the run-time width at C = 3 has no spill.
bool graph_c64(const void* feats, int c) { return c == 64 && reinterpret_cast<uintptr_t>(feats) % 16 == 0; }

// |x|^2 of every point into norms [b, n], then the tiled graph kernel
// (knn_graph_tile64_kernel at C = 64 when the cloud is 16-byte aligned),
// built with the fused gather where gather.vals is not null.
template <bool GATHER>
cudaError_t launch_graph_tiles(const float* feats, const float* norms, int b, int n, int c, int k, int32_t* idx,
                               const GatherArgs& gather, cudaStream_t s) {
  const bool c64 = graph_c64(feats, c);
  const size_t smem = c64 ? graph64_smem_bytes() : graph_smem_bytes(c < kGraphSlice ? c : kGraphSlice);
  const dim3 grid((n + kGraphQT - 1) / kGraphQT, b);
  cudaError_t err = cudaSuccess;
  if (c64) {
    err = cudaFuncSetAttribute(knn_graph_tile64_kernel<GATHER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    knn_graph_tile64_kernel<GATHER><<<grid, kGraphThreads, smem, s>>>(feats, norms, n, k, idx, gather);
  } else {
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(knn_graph_tile_kernel<GATHER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    knn_graph_tile_kernel<GATHER><<<grid, kGraphThreads, smem, s>>>(feats, norms, n, c, k, idx, gather);
  }
  return cudaGetLastError();
}

cudaError_t launch_graph(const float* feats, float* norms, int b, int n, int c, int k, int32_t* idx,
                         const GatherArgs& gather, cudaStream_t s) {
  const long long total = static_cast<long long>(b) * n;
  if (graph_c64(feats, c)) {
    graph_norms_kernel<64><<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(feats, total, c, norms);
  } else {
    graph_norms_kernel<0><<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(feats, total, c, norms);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return gather.vals != nullptr ? launch_graph_tiles<true>(feats, norms, b, n, c, k, idx, gather, s)
                                : launch_graph_tiles<false>(feats, norms, b, n, c, k, idx, gather, s);
}

// The widest word (8, 4 or 2 bytes, at least `esize`) that divides a row of
// `row` bytes and both pointers' alignment.
int gather_word(const void* vals, const void* out, int row, int esize) {
  for (int word = 8; word > esize; word >>= 1) {
    if (row % word == 0 && reinterpret_cast<uintptr_t>(vals) % word == 0 &&
        reinterpret_cast<uintptr_t>(out) % word == 0) {
      return word;
    }
  }
  return esize;
}

}  // namespace

// queries [b, m, c], keys [b, n, c], bias [b, n] or null, all f32 and
// contiguous -> dist [b, m, k] f32, idx [b, m, k] int32, ascending.  Any k
// and N, by the plan knn_kernel.point_plan makes: route 0, the group route
// (k <= kMaxK; group lanes a query, a power of two up to 32), 1 the warp
// route (k <= kMaxK), 2 the selection (its shared bytes within 227 KB), 3
// the full sort; a plan the kernels cannot run is refused.  scratch: 2 * b *
// m * min(k, n) 64-bit words on routes 2 and 3 when n > kSortTile (the
// tiles' merged lists), else null.
extern "C" int knn_launch(const void* queries, const void* keys, const void* bias, int b, int m,
                          int n, int c, int k, int route, int group, void* dist, void* idx, void* scratch,
                          void* stream) {
  if (b < 1 || b > 65535 || m < 1 || n < 1 || c < 1 || c + 2 > kSmemFloats || k < 1) {
    return cudaErrorInvalidValue;
  }
  return launch_point(static_cast<const float*>(queries), static_cast<const float*>(keys),
                      static_cast<const float*>(bias), b, m, n, c, k, route, group, static_cast<float*>(dist),
                      static_cast<int32_t*>(idx), static_cast<unsigned long long*>(scratch),
                      static_cast<cudaStream_t>(stream));
}

// feats [b, n, c] f32, contiguous -> idx [b, n, k] int32: each point's k
// nearest points, itself included, ascending.  Up to kGraphMaxK: the tiled
// graph kernel, dist [b, n] f32 scratch (the points' |x|^2), route and group
// unused; with vals [b, n, cv] (esize bytes an element: 4, f32, or 2,
// bf16), the same kernel with the fused gather, out [b, n, k, cv] the rows
// of vals at idx.  Above it: knn_launch with the cloud as its queries on the
// plan (route, group), dist [b, n, k] f32 scratch, and scratch as
// knn_launch's; vals must then be null (the gather is launched apart).
extern "C" int knn_graph_launch(const void* feats, int b, int n, int c, int k, int route, int group, void* idx,
                                void* dist, void* scratch, const void* vals, void* out, int cv, int esize,
                                void* stream) {
  if (b < 1 || b > 65535 || n < 1 || c < 1 || c + 1 > kSmemFloats || k < 1 || dist == nullptr) {
    return cudaErrorInvalidValue;
  }
  if (vals != nullptr && (out == nullptr || k > kGraphMaxK || cv < 1 || (esize != 2 && esize != 4))) {
    return cudaErrorInvalidValue;
  }
  if (k > kGraphMaxK) {
    return knn_launch(feats, feats, nullptr, b, n, n, c, k, route, group, dist, idx, scratch, stream);
  }
  GatherArgs gather{nullptr, nullptr, 0, 0};
  if (vals != nullptr) {
    const int word = gather_word(vals, out, cv * esize, esize);
    gather = GatherArgs{vals, out, cv * esize / word, word};
  }
  auto* f = static_cast<const float*>(feats);
  auto* norms = static_cast<float*>(dist);
  auto* i = static_cast<int32_t*>(idx);
  auto s = static_cast<cudaStream_t>(stream);
  return launch_graph(f, norms, b, n, c, k, i, gather, s);
}

// The kernel knn_launch runs on the plan (route, group) at (n, c, k), as
// kernel_info reads it: info = {registers, local bytes a thread, dynamic
// shared bytes a block, resident blocks per SM}.
extern "C" int knn_point_info(int route, int group, int n, int c, int k, int* info) {
  if (n < 1 || c < 1 || c + 2 > kSmemFloats || k < 1 || !plan_ok(route, group, n, c, k)) {
    return cudaErrorInvalidValue;
  }
  const bool c3 = c == 3;
  switch (route) {
    case kGroupRoute: {
      const size_t smem = group_smem_bytes(group_tile(n, c), c);
      auto pick = [&](auto k3, auto k64, auto k0) {
        return c3 ? kernel_info(k3, smem, kThreads, info)
                  : c == 64 ? kernel_info(k64, smem, kThreads, info) : kernel_info(k0, smem, kThreads, info);
      };
      if (k <= 4) return pick(knn_group_kernel<4, 3>, knn_group_kernel<4, 64>, knn_group_kernel<4, 0>);
      if (k <= 8) return pick(knn_group_kernel<8, 3>, knn_group_kernel<8, 64>, knn_group_kernel<8, 0>);
      return pick(knn_group_kernel<16, 3>, knn_group_kernel<16, 64>, knn_group_kernel<16, 0>);
    }
    case kWarpRoute: {
      const size_t smem = warp_smem_bytes(c, warp_tile(n, c));
      if (k <= 32) {
        return c3 ? kernel_info(knn_warp_kernel<1, 3>, smem, kWarpThreads, info)
                  : kernel_info(knn_warp_kernel<1, 0>, smem, kWarpThreads, info);
      }
      return c3 ? kernel_info(knn_warp_kernel<2, 3>, smem, kWarpThreads, info)
                : kernel_info(knn_warp_kernel<2, 0>, smem, kWarpThreads, info);
    }
    case kSelectRoute: {
      const size_t smem = select_smem_bytes(n, k);
      if (n > kSortTile) {
        return c3 ? kernel_info(knn_select_tiled_kernel<3>, smem, kSortThreads, info)
                  : kernel_info(knn_select_tiled_kernel<0>, smem, kSortThreads, info);
      }
      return c3 ? kernel_info(knn_select_kernel<3>, smem, kSortThreads, info)
                : kernel_info(knn_select_kernel<0>, smem, kSortThreads, info);
    }
    default: {
      const size_t smem = sizeof(unsigned long long) * static_cast<size_t>(pow2_at_least(min(n, kSortTile)));
      if (n > kSortTile) {
        return c3 ? kernel_info(knn_sort_tiled_kernel<3>, smem, kSortThreads, info)
                  : kernel_info(knn_sort_tiled_kernel<0>, smem, kSortThreads, info);
      }
      return c3 ? kernel_info(knn_sort_kernel<3>, smem, kSortThreads, info)
                : kernel_info(knn_sort_kernel<0>, smem, kSortThreads, info);
    }
  }
}

// The tiled graph kernel as knn_graph_launch takes it at width c (a 16-byte
// aligned cloud), gather 0 the graph alone, else built with the fused
// gather: info = {registers, local bytes a thread, dynamic shared bytes a
// block, resident blocks per SM}.
extern "C" int knn_graph_info(int c, int gather, int* info) {
  if (c < 1 || c + 1 > kSmemFloats) return cudaErrorInvalidValue;
  const size_t smem = graph_smem_bytes(c < kGraphSlice ? c : kGraphSlice);
  if (graph_c64(reinterpret_cast<const void*>(16), c)) {
    return gather ? kernel_info(knn_graph_tile64_kernel<true>, graph64_smem_bytes(), kGraphThreads, info)
                  : kernel_info(knn_graph_tile64_kernel<false>, graph64_smem_bytes(), kGraphThreads, info);
  }
  return gather ? kernel_info(knn_graph_tile_kernel<true>, smem, kGraphThreads, info)
                : kernel_info(knn_graph_tile_kernel<false>, smem, kGraphThreads, info);
}
