// k-nearest-neighbour search for Hopper (sm_90a): the general kNN and the
// self-kNN graph.
//
// knn_kernel replaces scanobjectnn_tpu/ops/pallas/knn_kernel.py:
// knn_point_pallas (body _knn_general_kernel); knn_graph_kernel replaces
// knn_graph_pallas (body _knn_kernel), DGCNN's per-layer feature-space graph
// with the self edge included.  Semantics are documented in
// scanobjectnn_torch/ops/cuda/knn_kernel.py.  The TPU kernels build a
// [T, N] distance block with one MXU matmul and run k argmin rounds over it;
// on the card each thread owns one query, scans the keys in ascending index
// and keeps its k best in registers, so no distance row is stored.
//
// Distance: max(qq - 2*inner + kk, 0) + bias, every sum in ascending channel
// order with __fmul_rn/__fadd_rn (nvcc may not contract them into FMAs), so
// the bits equal the plain version's elementwise tensor ops.  A query's
// distance to itself is exactly 0 (inner == qq, bit for bit).  Ties: a key
// enters the list only when strictly below an entry (insert), and keys come
// in ascending index, so the lowest index wins a tie.  Slots no key filled
// (N < k, or distances that are +inf or NaN) stay (+inf, 0).
//
// Bound: operations.  A (query, key) pair costs about 2C + 4 f32 operations
// (the inner product, the expansion, the clamp, one compare); the bytes are
// the points read once and the outputs.  At the FP decoder's fp3 (B=32,
// M=1024 queries, N=512 keys, C=3) that is 16.8M pairs, 2.5 us at the card's
// 67 TFLOP/s f32 rate; DGCNN's C=64 graph at B=32, N=1024 is 33.6M pairs of
// 132 operations, 66 us.  Each block stages a tile of its cloud's keys and
// their |k|^2 (and bias) in shared memory, where every thread reads the same
// key at once (a broadcast); the top-k list is fully unrolled into
// registers, at a capacity KCAP of 4, 8, 16, 32, 48 or 64 entries: the
// smallest that holds k.  KCAP = 48 serves PointCNN's k = 48 (xdconv_4) and
// KCAP = 64 the rest up to kMaxK; a list of 64 takes 128 registers, and a
// key that does not beat the list's last entry skips the unrolled insertion,
// which after the first few hundred keys is nearly every key.  Both
// kernels keep the query row in registers at the compile-time widths 3 and
// 64 (the generic width re-reads it from memory for every key); the graph
// kernel also evaluates two keys per step, two independent chains of
// dependent adds, before inserting them in index order.
//
// k > 64 (knn_sort_kernel): one block per query computes the query's
// distance to every key of its cloud, the same expressions in the same
// order, into shared memory as 64-bit keys (the distance's order-preserving
// bits, then the key index), sorts them with a block-wide bitonic sort and
// writes the first k: ascending distance, ties to the lowest index, +inf
// and NaN (sorted as +inf) never selected.  The cloud's N keys, padded to a
// power of two, fit the block's shared memory up to kSortTile (16384, 128
// KB).  A larger cloud (knn_sort_tiled_kernel) is sorted a tile of
// kSortTile keys at a time, exactly so, and each tile's first min(k, tile)
// words are merged into the query's running list of min(k, N) words, kept
// in a scratch buffer in device memory (two lists, read and written in
// turn): each word's place in the merged list is its rank in its own list
// plus the number of words of the other list below it (a binary search).
// The words are distinct (the index is in the low bits), so the merge is
// exact and stable by construction: ties at the lowest index, +inf and NaN
// last.  Bound: operations, as above, plus the sort's
// log2(N)(log2(N)+1)/2 compare-exchange steps over N/2 pairs a query (per
// tile of the larger clouds); the sort, not the distances, sets this
// path's time.
//
// The self-kNN graph above k = kGraphMaxK (32) is this general kernel with
// the cloud as its own queries (knn_graph_launch): the register lists up to
// k = 64, the sort above, the same bits as knn_graph_plain by construction.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;            // queries per block
constexpr int kMaxK = 64;                // MAX_K of knn_kernel.py
constexpr int kGraphMaxK = 32;           // GRAPH_MAX_K of knn_kernel.py
constexpr int kSmemFloats = 12 * 1024;   // 48 KB: a key tile, its |k|^2 and bias
constexpr int kSortThreads = 256;        // threads of a knn_sort_kernel block
constexpr int kSortTile = 16384;         // SORT_TILE of knn_kernel.py

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

// KCAP >= k entries are kept (the first k are written); W as in dot.
template <int KCAP, int W>
__global__ void __launch_bounds__(kThreads)
    knn_kernel(const float* __restrict__ queries, const float* __restrict__ keys,
               const float* __restrict__ bias, int m, int n, int c, int k, int tile,
               float* __restrict__ dist, int32_t* __restrict__ idx) {
  extern __shared__ __align__(16) float smem[];
  const int width = W > 0 ? W : c;
  float* skeys = smem;                // [tile, width]
  float* skk = skeys + tile * width;  // [tile]
  float* sbias = skk + tile;          // [tile]
  const int b = blockIdx.y;
  const int qi = blockIdx.x * kThreads + threadIdx.x;
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

  for (int base = 0; base < n; base += tile) {
    const int count = min(tile, n - base);
    stage_tile(cloud, cbias, base, count, width, skeys, skk, sbias);
    if (!active) continue;
    for (int t = 0; t < count; ++t) {
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
    }
  }
  if (!active) return;
  const size_t row = (static_cast<size_t>(b) * m + qi) * k;
#pragma unroll
  for (int p = 0; p < KCAP; ++p) {
    if (p < k) {
      dist[row + p] = bd[p];
      idx[row + p] = bi[p];
    }
  }
}

// Self-kNN over a cloud [n, c]: every point is a query and a key; writes
// the indices only.  KCAP >= k; W as in dot.
template <int KCAP, int W>
__global__ void __launch_bounds__(kThreads)
    knn_graph_kernel(const float* __restrict__ feats, int n, int c, int k, int tile,
                     int32_t* __restrict__ idx) {
  extern __shared__ __align__(16) float smem[];
  const int width = W > 0 ? W : c;
  float* skeys = smem;                // [tile, width]
  float* skk = skeys + tile * width;  // [tile]
  const int b = blockIdx.y;
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  const bool active = qi < n;  // no early return: every thread joins the barriers
  const float* cloud = feats + static_cast<size_t>(b) * n * width;
  const float* q = cloud + static_cast<size_t>(active ? qi : 0) * width;
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

  for (int base = 0; base < n; base += tile) {
    const int count = min(tile, n - base);
    stage_tile(cloud, nullptr, base, count, width, skeys, skk, nullptr);
    if (!active) continue;
    for (int t = 0; t < count; t += 2) {
      // Two keys per step (the second repeats the last key of an odd tile
      // and is then not inserted): independent chains the SM interleaves.
      const int u = min(t + 1, count - 1);
      float i0, i1;
      if constexpr (W > 0) {
        i0 = dot_row<W>(qr, skeys + t * width);
        i1 = dot_row<W>(qr, skeys + u * width);
      } else {
        i0 = dot<0>(q, skeys + t * width, width);
        i1 = dot<0>(q, skeys + u * width, width);
      }
      const float d0 = expand(qq, i0, skk[t]);
      const float d1 = expand(qq, i1, skk[u]);
      insert(bd, bi, d0, base + t);
      if (u > t) insert(bd, bi, d1, base + u);
    }
  }
  if (!active) return;
  const size_t row = (static_cast<size_t>(b) * n + qi) * k;
#pragma unroll
  for (int p = 0; p < KCAP; ++p) {
    if (p < k) idx[row + p] = bi[p];
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

cudaError_t launch_sort(const float* q, const float* keys, const float* bias, int b, int m, int n,
                        int c, int k, float* dist, int32_t* idx, unsigned long long* scratch,
                        cudaStream_t s) {
  int npow = 1;
  while (npow < n && npow < kSortTile) npow <<= 1;
  const size_t smem = sizeof(unsigned long long) * static_cast<size_t>(npow);
  const dim3 grid(m, b);
  auto run = [&](auto kernel, auto... args) {
    if (smem > 48 * 1024) {
      const cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    kernel<<<grid, kSortThreads, smem, s>>>(args...);
    return cudaGetLastError();
  };
  if (n > kSortTile) {
    if (scratch == nullptr) return cudaErrorInvalidValue;
    return c == 3 ? run(knn_sort_tiled_kernel<3>, q, keys, bias, m, n, c, k, scratch, dist, idx)
                  : run(knn_sort_tiled_kernel<0>, q, keys, bias, m, n, c, k, scratch, dist, idx);
  }
  return c == 3 ? run(knn_sort_kernel<3>, q, keys, bias, m, n, c, k, npow, dist, idx)
                : run(knn_sort_kernel<0>, q, keys, bias, m, n, c, k, npow, dist, idx);
}

template <int KCAP, int W>
cudaError_t launch(const float* q, const float* keys, const float* bias, int b, int m, int n,
                   int c, int k, float* dist, int32_t* idx, cudaStream_t s) {
  const int fit = kSmemFloats / (c + 2);
  const int tile = n < fit ? n : fit;
  const size_t smem = sizeof(float) * static_cast<size_t>(tile) * (c + 2);
  const dim3 grid((m + kThreads - 1) / kThreads, b);
  knn_kernel<KCAP, W><<<grid, kThreads, smem, s>>>(q, keys, bias, m, n, c, k, tile, dist, idx);
  return cudaGetLastError();
}

// C = 3 (points) and C = 64 (DGCNN's EdgeConv 2-4 features, the graph
// above k = 32) keep the query row in registers; other widths re-read it.
template <int KCAP>
cudaError_t launch_c(const float* q, const float* keys, const float* bias, int b, int m, int n,
                     int c, int k, float* dist, int32_t* idx, cudaStream_t s) {
  if (c == 3) return launch<KCAP, 3>(q, keys, bias, b, m, n, c, k, dist, idx, s);
  if (c == 64) return launch<KCAP, 64>(q, keys, bias, b, m, n, c, k, dist, idx, s);
  return launch<KCAP, 0>(q, keys, bias, b, m, n, c, k, dist, idx, s);
}

template <int KCAP, int W>
cudaError_t launch_graph(const float* feats, int b, int n, int c, int k, int32_t* idx,
                         cudaStream_t s) {
  // Rows of 64 floats start 256 bytes apart: dot_row's float4 reads stay aligned.
  const int fit = kSmemFloats / (c + 1);
  const int tile = n < fit ? n : fit;
  const size_t smem = sizeof(float) * static_cast<size_t>(tile) * (c + 1);
  const dim3 grid((n + kThreads - 1) / kThreads, b);
  knn_graph_kernel<KCAP, W><<<grid, kThreads, smem, s>>>(feats, n, c, k, tile, idx);
  return cudaGetLastError();
}

template <int KCAP>
cudaError_t launch_graph_c(const float* feats, int b, int n, int c, int k, int32_t* idx,
                           cudaStream_t s) {
  if (c == 3) return launch_graph<KCAP, 3>(feats, b, n, c, k, idx, s);
  if (c == 64) return launch_graph<KCAP, 64>(feats, b, n, c, k, idx, s);
  return launch_graph<KCAP, 0>(feats, b, n, c, k, idx, s);
}

}  // namespace

// queries [b, m, c], keys [b, n, c], bias [b, n] or null, all f32 and
// contiguous -> dist [b, m, k] f32, idx [b, m, k] int32, ascending.  Any k
// and N; scratch: 2 * b * m * min(k, n) 64-bit words when k > kMaxK and
// n > kSortTile (the tiled sort's lists), else null.
extern "C" int knn_launch(const void* queries, const void* keys, const void* bias, int b, int m,
                          int n, int c, int k, void* dist, void* idx, void* scratch, void* stream) {
  if (b < 1 || b > 65535 || m < 1 || n < 1 || c < 1 || c + 2 > kSmemFloats || k < 1) {
    return cudaErrorInvalidValue;
  }
  auto* q = static_cast<const float*>(queries);
  auto* kp = static_cast<const float*>(keys);
  auto* bp = static_cast<const float*>(bias);
  auto* d = static_cast<float*>(dist);
  auto* i = static_cast<int32_t*>(idx);
  auto s = static_cast<cudaStream_t>(stream);
  if (k <= 4) return launch_c<4>(q, kp, bp, b, m, n, c, k, d, i, s);
  if (k <= 8) return launch_c<8>(q, kp, bp, b, m, n, c, k, d, i, s);
  if (k <= 16) return launch_c<16>(q, kp, bp, b, m, n, c, k, d, i, s);
  if (k <= 32) return launch_c<32>(q, kp, bp, b, m, n, c, k, d, i, s);
  if (k <= 48) return launch_c<48>(q, kp, bp, b, m, n, c, k, d, i, s);
  if (k <= kMaxK) return launch_c<64>(q, kp, bp, b, m, n, c, k, d, i, s);
  return launch_sort(q, kp, bp, b, m, n, c, k, d, i, static_cast<unsigned long long*>(scratch), s);
}

// feats [b, n, c] f32, contiguous -> idx [b, n, k] int32: each point's k
// nearest points, itself included, ascending.  Above kGraphMaxK: the
// general kernel (knn_launch) with the cloud as its queries, dist [b, n, k]
// f32 scratch, and scratch as knn_launch's (null unless k > kMaxK and
// n > kSortTile).
extern "C" int knn_graph_launch(const void* feats, int b, int n, int c, int k, void* idx, void* dist,
                                void* scratch, void* stream) {
  if (b < 1 || b > 65535 || n < 1 || c < 1 || c + 1 > kSmemFloats || k < 1) {
    return cudaErrorInvalidValue;
  }
  if (k > kGraphMaxK) {
    if (dist == nullptr) return cudaErrorInvalidValue;
    return knn_launch(feats, feats, nullptr, b, n, n, c, k, dist, idx, scratch, stream);
  }
  auto* f = static_cast<const float*>(feats);
  auto* i = static_cast<int32_t*>(idx);
  auto s = static_cast<cudaStream_t>(stream);
  if (k <= 8) return launch_graph_c<8>(f, b, n, c, k, i, s);
  if (k <= 16) return launch_graph_c<16>(f, b, n, c, k, i, s);
  if (k <= 20) return launch_graph_c<20>(f, b, n, c, k, i, s);
  return launch_graph_c<32>(f, b, n, c, k, i, s);
}
