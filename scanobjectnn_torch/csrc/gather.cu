// Row gather and deterministic scatter-add for Hopper (sm_90a).
//
// Replaces scanobjectnn_tpu/ops/pallas/onehot.py: flat_gather
// (_flat_gather_impl) and flat_scatter (_flat_scatter_impl), which the
// training path reaches through edge_kernel.gather_neighbors_pallas and its
// VJP.  Semantics are documented in
// scanobjectnn_torch/ops/cuda/gather_kernel.py.  The TPU moves rows through
// one-hot MXU matmuls over bf16 Dekker splits (its scatter keeps about 17
// mantissa bits); on the card a gather is a load, and the scatter sums exact
// f32.
//
// Bound: bytes.  The gather reads and writes R rows of C floats, the
// scatter reads R rows and writes N.  Both give one warp to a row, its lanes
// across the channels (float4 when C % 4 == 0 and the rows are 16-byte
// aligned), so a row moves as whole 128-byte lines.
//
// The scatter is deterministic: it uses no float atomics.  Per cloud, one
// block sorts the R row indices by target with the stable counting sort of
// countsort.cuh.  A second kernel gives each output row one warp, which sums
// the row's contributions in ascending row order.  Two calls on the same
// input give the same bits, in the order of a sequential index_add_.

#include <cuda_runtime.h>

#include <cstdint>

#include "countsort.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// out[row] = vals[b, idx[row]] for row = b * r + i; a row whose index is
// outside [0, n) is written as NaN (never a stray read).
template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
    gather_kernel(const float* __restrict__ vals, const int32_t* __restrict__ idx, int n,
                  int r, int c, long long rows, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       row < rows; row += stride) {
    const long long b = row / r;
    const int j = idx[row];  // warp-uniform
    float* dst = out + row * c;
    if (j < 0 || j >= n) {
      for (int ch = lane; ch < c; ch += 32) dst[ch] = __int_as_float(0x7fc00000);
      continue;
    }
    const float* src = vals + (b * n + j) * c;
    if (kVec4) {
      const float4* s4 = reinterpret_cast<const float4*>(src);
      float4* d4 = reinterpret_cast<float4*>(dst);
      for (int v = lane; v < c / 4; v += 32) d4[v] = s4[v];
    } else {
      for (int ch = lane; ch < c; ch += 32) dst[ch] = src[ch];
    }
  }
}

// out[b, j] = sum of upd[b, i] over the rows i aimed at j, in ascending i;
// 0 where there is none.  One warp per output row.
template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
    scatter_sum_kernel(const float* __restrict__ upd, const int32_t* __restrict__ offsets,
                       const int32_t* __restrict__ perm, int n, int r, int c,
                       long long rows, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       row < rows; row += stride) {
    const long long b = row / n;
    const int j = static_cast<int>(row - b * n);
    const int32_t* off = offsets + b * (n + 1);
    const int start = off[j], end = off[j + 1];
    const int32_t* rows_of = perm + b * r;
    const float* src = upd + b * r * c;
    float* dst = out + row * c;
    if (kVec4) {
      for (int v = lane; v < c / 4; v += 32) {
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int t = start; t < end; ++t) {
          const float4 u = reinterpret_cast<const float4*>(src + static_cast<size_t>(rows_of[t]) * c)[v];
          acc.x += u.x;
          acc.y += u.y;
          acc.z += u.z;
          acc.w += u.w;
        }
        reinterpret_cast<float4*>(dst)[v] = acc;
      }
    } else {
      for (int ch = lane; ch < c; ch += 32) {
        float acc = 0.f;
        for (int t = start; t < end; ++t) acc += src[static_cast<size_t>(rows_of[t]) * c + ch];
        dst[ch] = acc;
      }
    }
  }
}

int blocks_for(long long rows) {
  const long long blocks = (rows + kWarps - 1) / kWarps;
  return static_cast<int>(blocks < 132 * 64 ? blocks : 132 * 64);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" int gather_launch(const void* vals, const void* idx, int b, int n, int r, int c,
                             void* out, void* stream) {
  if (b < 1 || n < 1 || r < 1 || c < 1) return cudaErrorInvalidValue;
  const long long rows = static_cast<long long>(b) * r;
  auto* v = static_cast<const float*>(vals);
  auto* i = static_cast<const int32_t*>(idx);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (c % 4 == 0 && aligned16(vals) && aligned16(out)) {
    gather_kernel<true><<<blocks_for(rows), kThreads, 0, s>>>(v, i, n, r, c, rows, o);
  } else {
    gather_kernel<false><<<blocks_for(rows), kThreads, 0, s>>>(v, i, n, r, c, rows, o);
  }
  return cudaGetLastError();
}

extern "C" int scatter_add_launch(const void* idx, const void* upd, int b, int n, int r, int c,
                                  void* offsets, void* perm, void* out, void* stream) {
  if (b < 1 || n < 1 || r < 1 || c < 1) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto* off = static_cast<int32_t*>(offsets);
  auto* p = static_cast<int32_t*>(perm);
  const cudaError_t err = launch_count_sort(static_cast<const int32_t*>(idx), b, n, r, off, p, s);
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(b) * n;
  auto* u = static_cast<const float*>(upd);
  auto* o = static_cast<float*>(out);
  if (c % 4 == 0 && aligned16(upd) && aligned16(out)) {
    scatter_sum_kernel<true><<<blocks_for(rows), kThreads, 0, s>>>(u, off, p, n, r, c, rows, o);
  } else {
    scatter_sum_kernel<false><<<blocks_for(rows), kThreads, 0, s>>>(u, off, p, n, r, c, rows, o);
  }
  return cudaGetLastError();
}
