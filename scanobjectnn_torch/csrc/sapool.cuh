// Row staging, folded-BN MLP and max-pool of the fused eval-time SA layer,
// shared by safused.cu (#3 and #10) and sabucket.cu (#4), so the layer and
// max-pool code cannot drift between the three.  Each kernel selects its
// rows first (a ball scan, a given grouping, or a ball scan over a sorted
// window) into shared memory, then calls mlp_pool.  Semantics are documented
// in scanobjectnn_torch/ops/cuda/safused_kernel.py.
//
// A block handles QPB = max(1, 64 / K) queries of one cloud and stages at
// most 64 (query, slot) rows at a time:
//   2. the rows [c3 | feat[idx]] of a chunk of at most 64 slots are staged
//      in shared memory (c3 rounded to the compute type, features converted
//      to f32 exactly);
//   3. each hidden layer maps 8 rows x 1 output column to a thread (one
//      weight load, read through L2, feeds 8 FMAs; the activations are
//      warp-broadcast reads of shared memory) and stores relu(acc + b),
//      rounded to the compute type, in the other shared buffer;
//   4. the last layer runs per (query, column) over the chunk's slots and
//      keeps a running max, so its activations are never stored.
// K <= 64 is one chunk of QPB * K rows.  K > 64 (MSG's 128) takes one query
// per block and repeats 2-4 over chunks of 64 slots, carrying the running
// max of each column in shared memory from one chunk to the next.
//
// Steps 3-4 run on the CUDA cores in f32 FMA, k in ascending order (never
// TF32), for both compute types: in bf16 the products of bf16 operands are
// exact in f32, and these sums give the plain version's bits (cuBLAS's f32
// product) on an H100.  A version whose bf16 MLP runs mma.sync on the
// tensor cores (studies/sa_mma.cuh, studies/sa_mma.py) holds each call's
// bf16 gate, but sums in another order, and the bf16 roundings it flips
// spread through the layers after: 37% of the bf16 SSG forward's logits
// differ by an ulp, past the models' logits gate (PERF.md section 6).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerTask = 8;
constexpr int kMaxRows = 64;  // staged rows per block, and slots per chunk
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
  int wa, wb;  // widths of the two activation buffers
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

// acc[i] += sum_k in[r[i] * ld + k] * w[k * cout + c], k < kin.
template <typename T>
__device__ __forceinline__ void accumulate(const float* in, int ld, int kin,
                                           const T* __restrict__ w, int cout,
                                           int c, const int (&r)[kRowsPerTask],
                                           float (&acc)[kRowsPerTask]) {
  for (int kk = 0; kk < kin; ++kk) {
    const float wv = to_f<T>(w[kk * cout + c]);
#pragma unroll
    for (int i = 0; i < kRowsPerTask; ++i) acc[i] = fmaf(in[r[i] * ld + kk], wv, acc[i]);
  }
}

// Pre-bias sums of layer l for rows r and column c.
template <typename T>
__device__ __forceinline__ void layer_sums(const Args& a, const Layers& L, int l,
                                           const float* in, int c,
                                           const int (&r)[kRowsPerTask],
                                           float (&acc)[kRowsPerTask]) {
#pragma unroll
  for (int i = 0; i < kRowsPerTask; ++i) acc[i] = 0.f;
  if (l > 0) {
    accumulate<T>(in, L.width[l - 1], L.width[l - 1],
                  static_cast<const T*>(L.w[l]), L.width[l], c, r, acc);
    return;
  }
  // Layer 0 over staged rows [c3(3) | feat(cs)]: feats·W0f + c3·W0x.
  const int ld = 3 + a.cs, c0 = L.width[0];
  if (a.w0f) {
    accumulate<T>(in + 3, ld, a.cs, static_cast<const T*>(a.w0f), c0, c, r, acc);
  } else if (a.prelifted) {
#pragma unroll
    for (int i = 0; i < kRowsPerTask; ++i) acc[i] = in[r[i] * ld + 3 + c];
  }
  if (a.w0x) {
    float accx[kRowsPerTask];
#pragma unroll
    for (int i = 0; i < kRowsPerTask; ++i) accx[i] = 0.f;
    accumulate<T>(in, ld, 3, static_cast<const T*>(a.w0x), c0, c, r, accx);
#pragma unroll
    for (int i = 0; i < kRowsPerTask; ++i) acc[i] += accx[i];
  }
}

// Steps 2-4 for the block's queries of cloud blockIdx.y.  sidx [qpb, K]: the
// selected point of each (query, slot); qrow [qpb]: each query's index in
// [0, M), or -1 for a dummy query (staged from query 0, never written out).
// buf: [qpb * min(K, 64), wa + wb] floats, then [Cout] when K > 64.
template <typename T>
__device__ __forceinline__ void mlp_pool(const Args& a, const Layers& L, const int* sidx,
                                         const int* qrow, float* buf) {
  const int k = a.k, qpb = a.qpb;
  const int kc = min(k, kMaxRows);  // slots per chunk: all of them when K <= 64
  const int cap = qpb * kc;         // staged rows per chunk
  float* buf_a = buf;                // [cap, wa]: staged rows, odd layers
  float* buf_b = buf_a + cap * a.wa;  // [cap, wb]: even layers
  float* run_max = buf_b + cap * a.wb;  // [cout] across chunks (K > 64 only)
  const int b = blockIdx.y, tid = threadIdx.x;
  const float* cloud = a.ball ? a.xyz + static_cast<size_t>(b) * a.n * 3 : nullptr;

  const int ld0 = 3 + a.cs;
  const T* src = static_cast<const T*>(a.src);
  const int l_last = L.n - 1, cout_last = L.width[l_last];
  T* pooled = static_cast<T*>(a.pooled);
  int r[kRowsPerTask];
  float acc[kRowsPerTask];
  for (int s0 = 0; s0 < k; s0 += kc) {
    const int ns = min(kc, k - s0), rows = qpb * ns;

    // 2. Stage the rows [c3 | feat[idx]] of slots [s0, s0 + ns).  Row r0 of
    //    the chunk is sidx[s0 + r0]: K > 64 runs one query a block, and
    //    K <= 64 one chunk (s0 = 0).
    for (int e = tid; e < rows * ld0; e += kThreads) {
      const int r0 = e / ld0, j = e - r0 * ld0, p = sidx[s0 + r0];
      float v;
      if (j < 3) {
        const int ql = r0 / ns;
        const size_t bq = static_cast<size_t>(b) * a.m + max(qrow[ql], 0);
        if (a.ball) {
          v = round_to<T>(cloud[3 * p + j] - a.new_xyz[bq * 3 + j]);
        } else {
          const int s = s0 + r0 - ql * ns;
          v = a.grouped ? round_to<T>(a.grouped[(bq * k + s) * 3 + j]) : 0.f;
        }
      } else {
        v = to_f<T>(src[(static_cast<size_t>(b) * a.n + p) * a.cs + (j - 3)]);
      }
      buf_a[e] = v;
    }
    __syncthreads();

    // 3. Hidden layers: layer l reads `in` and writes `out`, alternating buffers.
    const float* in = buf_a;
    for (int l = 0; l < l_last; ++l) {
      float* out = (l % 2 == 0) ? buf_b : buf_a;
      const int cout = L.width[l];
      const int nblk = (rows + kRowsPerTask - 1) / kRowsPerTask;
      for (int t = tid; t < nblk * cout; t += kThreads) {
        const int c = t % cout, rb = (t / cout) * kRowsPerTask;
#pragma unroll
        for (int i = 0; i < kRowsPerTask; ++i) r[i] = min(rb + i, rows - 1);
        layer_sums<T>(a, L, l, in, c, r, acc);
        const float bias = L.b[l][c];
#pragma unroll
        for (int i = 0; i < kRowsPerTask; ++i)
          if (rb + i < rows) out[(rb + i) * cout + c] = round_to<T>(fmaxf(acc[i] + bias, 0.f));
      }
      __syncthreads();
      in = out;
    }

    // 4. Last layer with the max-pool over each query's slots of this chunk,
    //    carried across chunks in run_max.
    for (int t = tid; t < qpb * cout_last; t += kThreads) {
      const int ql = t / cout_last, c = t - ql * cout_last;
      const float bias = L.b[l_last][c];
      float mx = s0 == 0 ? -INFINITY : run_max[t];
      for (int j0 = 0; j0 < ns; j0 += kRowsPerTask) {
#pragma unroll
        for (int i = 0; i < kRowsPerTask; ++i) r[i] = ql * ns + min(j0 + i, ns - 1);  // repeats leave the max unchanged
        layer_sums<T>(a, L, l_last, in, c, r, acc);
#pragma unroll
        for (int i = 0; i < kRowsPerTask; ++i) mx = fmaxf(mx, fmaxf(acc[i] + bias, 0.f));
      }
      if (s0 + ns < k) {
        run_max[t] = mx;
      } else if (qrow[ql] >= 0) {
        pooled[(static_cast<size_t>(b) * a.m + qrow[ql]) * cout_last + c] = from_f<T>(mx);
      }
    }
    __syncthreads();  // the next chunk restages buf_a
  }
}

// Fills the layer table, QPB and the two buffer widths; returns the floats
// mlp_pool's buffer needs, or 0 for a K or layer count it does not take.
inline size_t plan_mlp_pool(Args& a, Layers& L, int n_layers, const int* widths,
                            const void* const* weights, const float* const* biases) {
  if (a.k < 1 || a.k > kMaxK || n_layers < 1 || n_layers > kMaxLayers) return 0;
  a.qpb = a.k >= kMaxRows ? 1 : kMaxRows / a.k;
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
  // The two buffers of one chunk, and run_max when K > 64.
  const size_t rows = static_cast<size_t>(a.qpb) * min(a.k, kMaxRows);
  size_t words = rows * (a.wa + a.wb);
  if (a.k > kMaxRows) words += widths[n_layers - 1];
  return words;
}

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

}  // namespace
