// DGCNN's EdgeConv neighbour reductions, forward and backward, for Hopper
// (sm_90a).
//
// Replaces scanobjectnn_tpu/ops/pallas/edge_kernel.py: edge_reduce_pallas,
// forward body _fwd_kernel and backward _er_bwd_kernel/_er_bwd.  Semantics
// are documented in scanobjectnn_torch/ops/cuda/edge_kernel.py.  The TPU
// kernel fused the kNN with the gather because its one-hot MXU gather cost
// nothing beside the argmin rounds; it split the values into three bf16
// terms to gather them exactly, and saved the gathered [B, k, N, Cv] rows
// for the backward.  On the card the kNN graph is knn_graph_kernel (knn.cu),
// a gather is a load, and nothing per edge is stored: the backward reads the
// values again.
//
// Forward: a warp (a half-warp where 64 channels fill it: two queries a
// warp) per query, its lanes across the channels (float4 where the width
// allows), walks the query's k neighbours in slot order and keeps max, min,
// their tie counts, the sum and the sum of squares in registers.  The rows
// it reads are one cloud's values (512 KB at N = 1024, Cv = 128), which stay
// in L2.  Sums run in slot order with __fmul_rn/__fadd_rn, the order of the
// plain version's explicit adds, so kernel and plain version agree bit for
// bit.  The reductions cost about 17 f32 instructions an (edge, channel),
// which set its pace at DGCNN's shapes (about 25 us of issue a Cv = 64 call
// on 132 SMs), so the design adds little around them: a step loads the rows
// of kFwdBatch (4) slots before it reduces any, their indices read by every
// lane of the query from one L1 line, and the six outputs are streamed out
// (__stcs, evict-first).  Measured on an H100 and not kept (PERF.md §6):
// the indices read one a lane and passed on by shuffle, 8 slots a step
// (more registers, half the warps), and each (cloud, 8-channel slice)
// staged in shared memory with the rows read from there (no L2 rereads, but
// a shuffle, a shared load and the indices reread for every slice).

// Backward: dvals[j] = sum over the edges (q, r) with idx[q, r] == j of
//   ds[q] + 2 g dq2[q] + [g == mmax[q]] dmax[q] / max(cntmax[q], 1)
//                      + [g == mmin[q]] dmin[q] / max(cntmin[q], 1)
// with g = vals[j], the value the forward gathered for that edge, bit for
// bit.  It runs in gather form over the graph's inverse index: the counting
// sort of countsort.cuh lists each point's incoming edges in ascending
// (query, slot) order, and each (point, channel) is one chain of adds from
// +0 in that order, every operation rounded on its own.  No float atomics:
// two calls give the same bits.
//
// A point's edges come from about k different queries, so a per-edge walk
// reads each query's eight rows (32 Cv bytes) k times over, from L2: at
// B=32, N=1024, k=20, Cv=64 that is 1.34 GB a call against 67 MB of unique
// bytes.  So one block of 1024 threads takes a (cloud, slice of S channels)
// and first stages, for every query of the cloud, the slice's ds, dq2,
// mmax, mmin and the two quotients dmax / max(cntmax, 1) and dmin /
// max(cntmin, 1), formed once a query with the ops the sum would use: 24
// bytes a (query, channel), 192 KB at N = 1024, S = 8, one block an SM.
// Then S threads a point (a point's S channels side by side, 32 / S points
// a warp) walk its edges; the group's lanes read S edge numbers at once and
// pass each query on by shuffle, and every per-edge operand comes from
// shared memory: ds, dq2, mmax and mmin as one float4 (a group of eight
// lanes reads one query's 128-byte row: no bank conflicts) and the
// quotients as a float2 (two points of a half-warp conflict where their
// queries' rows share a bank half).  The steps are branch-free (the max and
// min terms by select), so a chunk's loads are in flight together.  Each
// query row now leaves L2 once a (cloud, slice), not k times.  The slice
// width is chosen in Python (edge_kernel.bwd_slice_width: 8 channels,
// halved until 24 N S bytes fit in 227 KB); a cloud whose single channel
// does not fit (N > 9685) takes the per-edge kernel, a route the wrapper
// counts.
//
// Bound: bytes.  The forward reads the values and the indices once and
// writes six [B, N, Cv] outputs; the backward reads the values, the indices
// and eight per-query tensors and writes dvals.  At B=32, N=1024, Cv=128,
// k=20 that is 120 MB forward (36 us at 3.35 TB/s) and 170 MB backward (51
// us).  The forward's gathers reread B N k Cv 4 bytes from L2 besides (336
// MB at Cv = 128), which the bound does not count, and its reductions' f32
// instructions take longer than either at DGCNN's shapes.  What sets the staged sum's pace is shared memory: 24 bytes a (edge,
// channel), 1 GB a Cv = 64 call, about 34 us at 128 bytes a clock on 132
// SMs, with a shuffle an edge and steps past a point's last edge on top.

#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

#include "countsort.cuh"
#include "kernel_info.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// VEC consecutive floats at p (p aligned to 4 * VEC bytes).
template <int VEC>
__device__ __forceinline__ void load(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// VEC floats streamed to p (aligned to 4 * VEC bytes), evict-first: the six
// outputs are written once and never read here, so they should not push the
// gathered cloud rows out of L2.
template <int VEC>
__device__ __forceinline__ void store_cs(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else if constexpr (VEC == 2) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
    __stcs(p, v[0]);
  }
}

// One slot's value x into a lane's reductions.
template <int VEC>
__device__ __forceinline__ void step(const float (&x)[VEC], float (&mx)[VEC], float (&mn)[VEC], float (&s)[VEC],
                                     float (&q)[VEC], float (&cx)[VEC], float (&cn)[VEC]) {
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const float y = x[v];
    cx[v] = y > mx[v] ? 1.f : cx[v] + (y == mx[v] ? 1.f : 0.f);
    mx[v] = (y > mx[v] || y != y) ? y : mx[v];
    cn[v] = y < mn[v] ? 1.f : cn[v] + (y == mn[v] ? 1.f : 0.f);
    mn[v] = (y < mn[v] || y != y) ? y : mn[v];
    s[v] = __fadd_rn(s[v], y);
    q[v] = __fadd_rn(q[v], __fmul_rn(y, y));
  }
}

// L lanes a query (32, or 16 where a half-warp holds every channel of a
// point: two queries a warp), each lane VEC channels a pass: the six
// reductions of vals[b, idx[row, r]] over the slots r = 0..k-1, in slot
// order.  max and min keep a NaN, as torch.amax does; a tie count is the
// number of slots equal to the max (where the max is NaN, the count it had
// when the NaN came).  A step loads the rows of kFwdBatch slots, their
// indices read by every lane of the query (one L1 line), before it reduces
// any.  The outputs are streamed out (__stcs).
constexpr int kFwdBatch = 4;

template <int VEC, int L>
__global__ void __launch_bounds__(kThreads)
    edge_reduce_fwd_kernel(const float* __restrict__ vals, const int32_t* __restrict__ idx,
                           int n, int k, int cv, long long rows, float* __restrict__ mmax,
                           float* __restrict__ mmin, float* __restrict__ sum,
                           float* __restrict__ sumsq, float* __restrict__ cntmax,
                           float* __restrict__ cntmin) {
  static_assert(L == 16 || L == 32, "a query takes a half-warp or a warp");
  constexpr int Q = 32 / L;  // queries a warp
  const int lane = threadIdx.x & (L - 1);
  const long long stride = static_cast<long long>(gridDim.x) * kWarps * Q;
  for (long long row = (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * Q + (threadIdx.x & 31) / L;
       row < rows; row += stride) {
    const long long b = row / n;
    const int32_t* nb = idx + row * k;
    const float* cloud = vals + b * n * cv;
    for (int c0 = lane * VEC; c0 < cv; c0 += L * VEC) {
      float g[kFwdBatch][VEC], mx[VEC], mn[VEC], s[VEC], q[VEC], cx[VEC], cn[VEC];
      load<VEC>(cloud + static_cast<size_t>(nb[0]) * cv + c0, g[0]);  // slot 0 starts every reduction
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        mx[v] = mn[v] = s[v] = g[0][v];
        q[v] = __fmul_rn(g[0][v], g[0][v]);
        cx[v] = cn[v] = 1.f;
      }
      int r = 1;
      for (; r + kFwdBatch <= k; r += kFwdBatch) {
#pragma unroll
        for (int u = 0; u < kFwdBatch; ++u) load<VEC>(cloud + static_cast<size_t>(nb[r + u]) * cv + c0, g[u]);
#pragma unroll
        for (int u = 0; u < kFwdBatch; ++u) step<VEC>(g[u], mx, mn, s, q, cx, cn);
      }
      for (; r < k; ++r) {
        load<VEC>(cloud + static_cast<size_t>(nb[r]) * cv + c0, g[0]);
        step<VEC>(g[0], mx, mn, s, q, cx, cn);
      }
      const size_t o = static_cast<size_t>(row) * cv + c0;
      store_cs<VEC>(mmax + o, mx);
      store_cs<VEC>(mmin + o, mn);
      store_cs<VEC>(sum + o, s);
      store_cs<VEC>(sumsq + o, q);
      store_cs<VEC>(cntmax + o, cx);
      store_cs<VEC>(cntmin + o, cn);
    }
  }
}

// The per-edge route, for clouds whose one channel does not fit the staged
// kernel's shared memory: one warp per point row = b * n + j, dvals[row] =
// the sum, in ascending edge order, of the coefficients of the edges aimed
// at j (module doc), each edge's eight query rows read from device memory.
// offsets/perm come from count_sort_kernel over idx [b, n * k]; an edge e is
// slot e % k of query e / k.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
    edge_reduce_bwd_edge_kernel(const float* __restrict__ vals, const int32_t* __restrict__ offsets,
                                const int32_t* __restrict__ perm, int n, int k, int cv, long long rows,
                                const float* __restrict__ mmax, const float* __restrict__ mmin,
                                const float* __restrict__ cntmax, const float* __restrict__ cntmin,
                                const float* __restrict__ dmax, const float* __restrict__ dmin,
                                const float* __restrict__ ds, const float* __restrict__ dq2,
                                float* __restrict__ dvals) {
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  const long long r = static_cast<long long>(n) * k;
  for (long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       row < rows; row += stride) {
    const long long b = row / n;
    const int j = static_cast<int>(row - b * n);
    const int32_t* off = offsets + b * (n + 1);
    const int start = off[j], end = off[j + 1];
    const int32_t* edges = perm + b * r;
    for (int c0 = lane * VEC; c0 < cv; c0 += 32 * VEC) {
      float g[VEC], acc[VEC];
      load<VEC>(vals + static_cast<size_t>(row) * cv + c0, g);
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] = 0.f;
      for (int t = start; t < end; ++t) {
        const size_t o = (static_cast<size_t>(b) * n + edges[t] / k) * cv + c0;
        float d_s[VEC], d_q[VEC], mx[VEC], mn[VEC], cx[VEC], cn[VEC], dx[VEC], dn[VEC];
        load<VEC>(ds + o, d_s);
        load<VEC>(dq2 + o, d_q);
        load<VEC>(mmax + o, mx);
        load<VEC>(mmin + o, mn);
        load<VEC>(cntmax + o, cx);
        load<VEC>(cntmin + o, cn);
        load<VEC>(dmax + o, dx);
        load<VEC>(dmin + o, dn);
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          float coeff = __fadd_rn(d_s[v], __fmul_rn(__fmul_rn(2.f, g[v]), d_q[v]));
          if (g[v] == mx[v]) coeff = __fadd_rn(coeff, __fdiv_rn(dx[v], fmaxf(cx[v], 1.f)));
          if (g[v] == mn[v]) coeff = __fadd_rn(coeff, __fdiv_rn(dn[v], fmaxf(cn[v], 1.f)));
          acc[v] = __fadd_rn(acc[v], coeff);
        }
      }
      store<VEC>(dvals + static_cast<size_t>(row) * cv + c0, acc);
    }
  }
}

constexpr int kBwdThreads = 1024;           // the staged kernel's block
constexpr int kBwdStagedBytes = 24;         // staged bytes a (query, channel)
constexpr size_t kBwdSmemMax = 232448;      // 227 KB: the most shared memory a block may use

size_t staged_smem_bytes(int n, int s) { return static_cast<size_t>(kBwdStagedBytes) * n * s; }

// One block a (channel slice, cloud) = (blockIdx.x, blockIdx.y): the
// slice's channels c0 .. c0 + S - 1 of every query staged in shared memory
// (module doc), then dvals of those channels for every point of the cloud.
// Channels at or past cv are staged as zeros and not written.
template <int S>
__global__ void __launch_bounds__(kBwdThreads, 1)
    edge_reduce_bwd_staged_kernel(const float* __restrict__ vals, const int32_t* __restrict__ offsets,
                                  const int32_t* __restrict__ perm, int n, int k, int cv,
                                  const float* __restrict__ mmax, const float* __restrict__ mmin,
                                  const float* __restrict__ cntmax, const float* __restrict__ cntmin,
                                  const float* __restrict__ dmax, const float* __restrict__ dmin,
                                  const float* __restrict__ ds, const float* __restrict__ dq2,
                                  float* __restrict__ dvals) {
  static_assert(S == 1 || S == 2 || S == 4 || S == 8, "a slice is 1, 2, 4 or 8 channels");
  extern __shared__ float4 staged[];
  float4* rows = staged;                                     // [n][S]: ds, dq2, mmax, mmin
  float2* quot = reinterpret_cast<float2*>(staged + n * S);  // [n][S]: the two quotients
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * S;
  const size_t cloud = static_cast<size_t>(blockIdx.y) * n;  // the cloud's first row

  // Stage element e = q * S + c, two a thread at a time so that each thread
  // has sixteen loads in flight.
  const int elems = n * S;
  for (int e = tid; e < elems; e += 2 * kBwdThreads) {
    float v[2][8];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int eu = e + u * kBwdThreads;
      const int ch = c0 + eu % S;
      const bool in = eu < elems && ch < cv;
      const size_t o = (cloud + eu / S) * cv + ch;
      v[u][0] = in ? ds[o] : 0.f;
      v[u][1] = in ? dq2[o] : 0.f;
      v[u][2] = in ? mmax[o] : 0.f;
      v[u][3] = in ? mmin[o] : 0.f;
      v[u][4] = in ? dmax[o] : 0.f;
      v[u][5] = in ? cntmax[o] : 0.f;
      v[u][6] = in ? dmin[o] : 0.f;
      v[u][7] = in ? cntmin[o] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int eu = e + u * kBwdThreads;
      if (eu < elems) {
        rows[eu] = make_float4(v[u][0], v[u][1], v[u][2], v[u][3]);
        quot[eu] = make_float2(__fdiv_rn(v[u][4], fmaxf(v[u][5], 1.f)), __fdiv_rn(v[u][6], fmaxf(v[u][7], 1.f)));
      }
    }
  }
  __syncthreads();

  const int c = tid % S;                                      // the thread's channel in the slice
  const unsigned group = ((1u << S) - 1u) << ((tid & 31) - c);  // the lanes of the thread's point
  const size_t ch = static_cast<size_t>(c0 + c);
  const bool in = ch < static_cast<size_t>(cv);
  const int32_t* off = offsets + static_cast<size_t>(blockIdx.y) * (n + 1);
  const int32_t* edges = perm + static_cast<size_t>(blockIdx.y) * n * k;
  for (int j = tid / S; j < n; j += kBwdThreads / S) {
    const int start = off[j], end = off[j + 1];
    const size_t o = (cloud + j) * cv + ch;
    const float g = in ? vals[o] : 0.f;
    const float g2 = __fmul_rn(2.f, g);
    float acc = 0.f;
    // A chunk of S edges: lane c holds edge t0 + c (the next chunk's is
    // already in flight), and its query's staged element goes to the group
    // by shuffle.  The steps are branch-free, so a chunk's loads are in
    // flight together.
    int next = start + c < end ? edges[start + c] : 0;
    for (int t0 = start; t0 < end; t0 += S) {
      const int mine = next / k * S;
      next = t0 + S + c < end ? edges[t0 + S + c] : 0;
      const int count = end - t0;
#pragma unroll
      for (int i = 0; i < S; ++i) {
        const int at = __shfl_sync(group, mine, i, S) + c;
        const float4 q = rows[at];
        const float2 d = quot[at];
        float coeff = __fadd_rn(q.x, __fmul_rn(g2, q.y));
        coeff = g == q.z ? __fadd_rn(coeff, d.x) : coeff;
        coeff = g == q.w ? __fadd_rn(coeff, d.y) : coeff;
        acc = __fadd_rn(acc, i < count ? coeff : 0.f);  // a step past the last edge adds +0
      }
    }
    if (in) dvals[o] = acc;
  }
}

int blocks_for(long long rows) {
  const long long blocks = (rows + kWarps - 1) / kWarps;
  return static_cast<int>(blocks < 132 * 64 ? blocks : 132 * 64);
}

// The largest vector of floats (4, 2 or 1) that divides `width` and to
// which every pointer is aligned.
int aligned_vec(int width, std::initializer_list<const void*> ptrs) {
  int vec = width % 4 == 0 ? 4 : width % 2 == 0 ? 2 : 1;
  for (const void* p : ptrs) {
    while (vec > 1 && reinterpret_cast<uintptr_t>(p) % (4 * vec) != 0) vec /= 2;
  }
  return vec;
}

// The backward's per-edge route: 4 floats a lane at widths that are
// multiples of 128, 2 at multiples of 64, else 1 (a warp's lanes across the
// channels), every pointer aligned to the vector.
int vec_for(int cv, std::initializer_list<const void*> ptrs) {
  return aligned_vec(cv % 128 == 0 ? 4 : cv % 64 == 0 ? 2 : 1, ptrs);
}

// The staged backward at slice width S over b clouds; `in` holds mmax, mmin,
// cntmax, cntmin, dmax, dmin, ds, dq2.
template <int S>
cudaError_t launch_staged(const float* vals, const int32_t* off, const int32_t* p, int b, int n, int k, int cv,
                          const float* const* in, float* out, cudaStream_t s) {
  const size_t smem = staged_smem_bytes(n, S);
  const cudaError_t err = cudaFuncSetAttribute(edge_reduce_bwd_staged_kernel<S>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((cv + S - 1) / S, b);
  edge_reduce_bwd_staged_kernel<S><<<grid, kBwdThreads, smem, s>>>(vals, off, p, n, k, cv, in[0], in[1], in[2],
                                                                    in[3], in[4], in[5], in[6], in[7], out);
  return cudaGetLastError();
}

// The forward at VEC floats a lane and L lanes a query.
template <int L>
cudaError_t launch_fwd(int vec, const float* v, const int32_t* i, int n, int k, int cv, long long rows,
                       float* const* o, cudaStream_t s) {
  const long long per_block = kWarps * (32 / L);
  const long long blocks = (rows + per_block - 1) / per_block;
  const int grid = static_cast<int>(blocks < 132 * 64 ? blocks : 132 * 64);
  switch (vec) {
    case 4:
      edge_reduce_fwd_kernel<4, L><<<grid, kThreads, 0, s>>>(v, i, n, k, cv, rows, o[0], o[1], o[2], o[3], o[4], o[5]);
      break;
    case 2:
      edge_reduce_fwd_kernel<2, L><<<grid, kThreads, 0, s>>>(v, i, n, k, cv, rows, o[0], o[1], o[2], o[3], o[4], o[5]);
      break;
    default:
      edge_reduce_fwd_kernel<1, L><<<grid, kThreads, 0, s>>>(v, i, n, k, cv, rows, o[0], o[1], o[2], o[3], o[4], o[5]);
  }
  return cudaGetLastError();
}

}  // namespace

// vals [b, n, cv] f32, idx [b, n, k] int32 in [0, n), contiguous -> mmax,
// mmin, sum, sumsq, cntmax, cntmin [b, n, cv] f32.  lanes: the lanes a query
// takes (16 or 32, edge_kernel.fwd_lanes); anything else is refused.
extern "C" int edge_reduce_fwd_launch(const void* vals, const void* idx, int b, int n, int k,
                                      int cv, int lanes, void* mmax, void* mmin, void* sum, void* sumsq,
                                      void* cntmax, void* cntmin, void* stream) {
  if (b < 1 || n < 1 || k < 1 || cv < 1 || (lanes != 16 && lanes != 32)) return cudaErrorInvalidValue;
  const long long rows = static_cast<long long>(b) * n;
  auto* v = static_cast<const float*>(vals);
  auto* i = static_cast<const int32_t*>(idx);
  float* const o[6] = {static_cast<float*>(mmax), static_cast<float*>(mmin), static_cast<float*>(sum),
                       static_cast<float*>(sumsq), static_cast<float*>(cntmax), static_cast<float*>(cntmin)};
  auto s = static_cast<cudaStream_t>(stream);
  const int vec = aligned_vec(cv, {vals, mmax, mmin, sum, sumsq, cntmax, cntmin});
  return lanes == 16 ? launch_fwd<16>(vec, v, i, n, k, cv, rows, o, s) : launch_fwd<32>(vec, v, i, n, k, cv, rows, o, s);
}

// The backward of edge_reduce_fwd_launch in vals: the forward's vals, idx
// and mmax, mmin, cntmax, cntmin, and the cotangents dmax, dmin, ds, dq2
// [b, n, cv] f32 -> dvals [b, n, cv] f32.  slice: the channels a block
// stages (1, 2, 4 or 8, with 24 n slice bytes within 227 KB), or 0 for the
// per-edge kernel; anything else is refused.  offsets [b, n + 1], perm
// [b, n * k] and counts [b, count_sort_tiles_for(n, n * k), n] int32 are
// scratch.
extern "C" int edge_reduce_bwd_launch(const void* vals, const void* idx, const void* mmax,
                                      const void* mmin, const void* cntmax, const void* cntmin,
                                      const void* dmax, const void* dmin, const void* ds,
                                      const void* dq2, int b, int n, int k, int cv, int slice, void* offsets,
                                      void* perm, void* counts, void* dvals, void* stream) {
  if (b < 1 || b > 65535 || n < 1 || k < 1 || cv < 1) return cudaErrorInvalidValue;
  if (static_cast<long long>(n) * k > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (slice != 0 && slice != 1 && slice != 2 && slice != 4 && slice != 8) return cudaErrorInvalidValue;
  if (slice > 0 && staged_smem_bytes(n, slice) > kBwdSmemMax) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto* off = static_cast<int32_t*>(offsets);
  auto* p = static_cast<int32_t*>(perm);
  cudaError_t err =
      launch_count_sort(static_cast<const int32_t*>(idx), b, n, n * k, off, p, static_cast<int32_t*>(counts), s);
  if (err != cudaSuccess) return err;
  auto f = [](const void* q) { return static_cast<const float*>(q); };
  auto* out = static_cast<float*>(dvals);
  const float* in[8] = {f(mmax), f(mmin), f(cntmax), f(cntmin), f(dmax), f(dmin), f(ds), f(dq2)};
  switch (slice) {
    case 8: return launch_staged<8>(f(vals), off, p, b, n, k, cv, in, out, s);
    case 4: return launch_staged<4>(f(vals), off, p, b, n, k, cv, in, out, s);
    case 2: return launch_staged<2>(f(vals), off, p, b, n, k, cv, in, out, s);
    case 1: return launch_staged<1>(f(vals), off, p, b, n, k, cv, in, out, s);
    default: break;
  }
  const long long rows = static_cast<long long>(b) * n;
  const int grid = blocks_for(rows);
  switch (vec_for(cv, {vals, mmax, mmin, cntmax, cntmin, dmax, dmin, ds, dq2, dvals})) {
    case 4:
      edge_reduce_bwd_edge_kernel<4><<<grid, kThreads, 0, s>>>(f(vals), off, p, n, k, cv, rows, in[0], in[1], in[2],
                                                               in[3], in[4], in[5], in[6], in[7], out);
      break;
    case 2:
      edge_reduce_bwd_edge_kernel<2><<<grid, kThreads, 0, s>>>(f(vals), off, p, n, k, cv, rows, in[0], in[1], in[2],
                                                               in[3], in[4], in[5], in[6], in[7], out);
      break;
    default:
      edge_reduce_bwd_edge_kernel<1><<<grid, kThreads, 0, s>>>(f(vals), off, p, n, k, cv, rows, in[0], in[1], in[2],
                                                               in[3], in[4], in[5], in[6], in[7], out);
  }
  return cudaGetLastError();
}

// A build of this file's kernels: info = {registers, local bytes a thread,
// dynamic shared bytes a block, resident blocks per SM}.  kernel 0: the
// staged backward at slice width `width` for a cloud of n points; 1: the
// backward's per-edge route at `width` floats a lane (1, 2 or 4); 2 and 3:
// the forward at 32 and 16 lanes a query, `width` floats a lane.
extern "C" int edge_info(int kernel, int width, int n, int* info) {
  if (kernel == 0) {
    if (n < 1 || staged_smem_bytes(n, width) > kBwdSmemMax) return cudaErrorInvalidValue;
    const size_t smem = staged_smem_bytes(n, width);
    switch (width) {
      case 8: return kernel_info(edge_reduce_bwd_staged_kernel<8>, smem, kBwdThreads, info);
      case 4: return kernel_info(edge_reduce_bwd_staged_kernel<4>, smem, kBwdThreads, info);
      case 2: return kernel_info(edge_reduce_bwd_staged_kernel<2>, smem, kBwdThreads, info);
      case 1: return kernel_info(edge_reduce_bwd_staged_kernel<1>, smem, kBwdThreads, info);
      default: return cudaErrorInvalidValue;
    }
  }
  if (kernel == 1) {
    switch (width) {
      case 4: return kernel_info(edge_reduce_bwd_edge_kernel<4>, 0, kThreads, info);
      case 2: return kernel_info(edge_reduce_bwd_edge_kernel<2>, 0, kThreads, info);
      case 1: return kernel_info(edge_reduce_bwd_edge_kernel<1>, 0, kThreads, info);
      default: return cudaErrorInvalidValue;
    }
  }
  if (kernel == 2 || kernel == 3) {  // the forward at 32 (2) or 16 (3) lanes a query, `width` floats a lane
    const bool half = kernel == 3;
    switch (width) {
      case 4: return half ? kernel_info(edge_reduce_fwd_kernel<4, 16>, 0, kThreads, info)
                          : kernel_info(edge_reduce_fwd_kernel<4, 32>, 0, kThreads, info);
      case 2: return half ? kernel_info(edge_reduce_fwd_kernel<2, 16>, 0, kThreads, info)
                          : kernel_info(edge_reduce_fwd_kernel<2, 32>, 0, kThreads, info);
      case 1: return half ? kernel_info(edge_reduce_fwd_kernel<1, 16>, 0, kThreads, info)
                          : kernel_info(edge_reduce_fwd_kernel<1, 32>, 0, kThreads, info);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}
