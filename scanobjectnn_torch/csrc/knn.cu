// General k-nearest-neighbour search for Hopper (sm_90a).
//
// Replaces scanobjectnn_tpu/ops/pallas/knn_kernel.py: knn_point_pallas
// (body _knn_general_kernel).  Semantics are documented in
// scanobjectnn_torch/ops/cuda/knn_kernel.py.  The TPU kernel builds a
// [T, N] distance block with one MXU matmul and runs k argmin rounds over
// it; on the card each thread owns one query, scans the keys in ascending
// index and keeps its k best in registers, so no distance row is stored.
//
// Distance: max(qq - 2*inner + kk, 0) + bias, every sum in ascending channel
// order with __fmul_rn/__fadd_rn (nvcc may not contract them into FMAs), so
// the bits equal the plain version's elementwise tensor ops.  Ties: a key
// enters the list only when strictly below an entry, and keys come in
// ascending index, so the lowest index wins a tie.  Slots no key filled
// (N < k, or distances that are +inf or NaN) stay (+inf, 0).
//
// Bound: operations.  A (query, key) pair costs about 2C + 4 f32 operations
// (the inner product, the expansion, the clamp, one compare); the bytes are
// the points read once and the [B, M, k] outputs.  At the FP decoder's fp3
// (B=32, M=1024 queries, N=512 keys, C=3) that is 16.8M pairs, about 168
// MFLOP, 2.5 us at the card's 67 TFLOP/s f32 rate, against 1.4 MB, 0.4 us at
// 3.35 TB/s.  Each block stages a tile of its cloud's keys, their |k|^2 and
// bias in shared memory, where every thread reads the same key at once (a
// broadcast); the top-k list is fully unrolled into registers.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;            // queries per block
constexpr int kMaxK = 32;                // knn_point_kernel's MAX_K
constexpr int kSmemFloats = 12 * 1024;   // 48 KB: a key tile, its |k|^2 and bias

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

// KCAP >= k entries are kept (the first k are written); W as in dot.
template <int KCAP, int W>
__global__ void __launch_bounds__(kThreads)
    knn_kernel(const float* __restrict__ queries, const float* __restrict__ keys,
               const float* __restrict__ bias, int m, int n, int c, int k, int tile,
               float* __restrict__ dist, int32_t* __restrict__ idx) {
  extern __shared__ float smem[];
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
#pragma unroll
  for (int p = 0; p < KCAP; ++p) {
    bd[p] = inf_f();
    bi[p] = 0;
  }
  const float* cloud = keys + static_cast<size_t>(b) * n * width;
  const float* cbias = bias != nullptr ? bias + static_cast<size_t>(b) * n : nullptr;

  for (int base = 0; base < n; base += tile) {
    const int count = min(tile, n - base);
    __syncthreads();  // the last tile is no longer read
    for (int e = threadIdx.x; e < count * width; e += kThreads) {
      skeys[e] = cloud[static_cast<size_t>(base) * width + e];
    }
    for (int t = threadIdx.x; t < count; t += kThreads) {
      sbias[t] = cbias != nullptr ? cbias[base + t] : 0.f;
    }
    __syncthreads();
    for (int t = threadIdx.x; t < count; t += kThreads) {
      skk[t] = dot<W>(skeys + t * width, skeys + t * width, width);
    }
    __syncthreads();
    if (!active) continue;
    for (int t = 0; t < count; ++t) {
      const float* kp = skeys + t * width;
      float inner;
      if constexpr (W > 0) {
        inner = dot<W>(qr, kp, W);
      } else {
        inner = dot<0>(q, kp, width);
      }
      float d = __fadd_rn(__fsub_rn(qq, __fmul_rn(2.f, inner)), skk[t]);
      d = d < 0.f ? 0.f : d;  // max(d, 0) that keeps a NaN
      if (cbias != nullptr) d = __fadd_rn(d, sbias[t]);
      if (!(d < bd[KCAP - 1])) continue;
      // Strict insertion, unrolled so the list stays in registers.  At step p
      // bd[p] and bd[p - 1] still hold their values from before this key.
      const int j = base + t;
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

template <int KCAP>
cudaError_t launch_c(const float* q, const float* keys, const float* bias, int b, int m, int n,
                     int c, int k, float* dist, int32_t* idx, cudaStream_t s) {
  return c == 3 ? launch<KCAP, 3>(q, keys, bias, b, m, n, c, k, dist, idx, s)
                : launch<KCAP, 0>(q, keys, bias, b, m, n, c, k, dist, idx, s);
}

}  // namespace

// queries [b, m, c], keys [b, n, c], bias [b, n] or null, all f32 and
// contiguous -> dist [b, m, k] f32, idx [b, m, k] int32, ascending.
extern "C" int knn_launch(const void* queries, const void* keys, const void* bias, int b, int m,
                          int n, int c, int k, void* dist, void* idx, void* stream) {
  if (b < 1 || b > 65535 || m < 1 || n < 1 || c < 1 || c + 2 > kSmemFloats || k < 1 ||
      k > kMaxK) {
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
  return launch_c<32>(q, kp, bp, b, m, n, c, k, d, i, s);
}
