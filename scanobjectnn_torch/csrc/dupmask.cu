// Duplicate-point mask for Hopper (sm_90a): PointCNN's unique-kNN input.
//
// Replaces scanobjectnn_tpu/ops/pallas/knn_kernel.py: duplicate_mask_pallas
// (body _dup_mask_kernel).  Semantics are documented in
// scanobjectnn_torch/ops/cuda/dupmask_kernel.py: dup[b, j] = 1.0 where point
// j equals some point i < j of its cloud in all three coordinates under
// float == (so -0.0 equals 0.0, and a coordinate that is NaN equals
// nothing), else 0.0.  The TPU kernel builds a [T, N] equality block per
// tile of rows and reduces it; on the card each thread owns one point j and
// scans the points i < j in ascending order, staged through shared memory
// a tile at a time, and stops at the first match.
//
// Bound: operations, and in practice the launch.  A cloud of N points needs
// at most N(N-1)/2 comparisons of three floats: at B=32, N=1024 that is 16.8M
// pairs, about 1 us of work at the card's 67 TFLOP/s f32 rate, against
// 0.5 MB of bytes (the points read once, the mask written once).  Every
// thread of a block reads the same staged point at once (a broadcast); a
// block stops scanning as soon as every thread in it has found its twin or
// run out of earlier points (__syncthreads_and).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;  // points per block, and points per staged tile

__global__ void __launch_bounds__(kThreads)
    dupmask_kernel(const float* __restrict__ xyz, int n, float* __restrict__ dup) {
  __shared__ float sx[kThreads];
  __shared__ float sy[kThreads];
  __shared__ float sz[kThreads];
  const int b = blockIdx.y;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const bool active = j < n;  // no early return: every thread joins the barriers
  const float* cloud = xyz + static_cast<size_t>(b) * n * 3;
  float x = 0.f, y = 0.f, z = 0.f;
  if (active) {
    x = cloud[3 * j];
    y = cloud[3 * j + 1];
    z = cloud[3 * j + 2];
  }
  bool found = false;
  // The block's last point has earlier points in [0, last); the loop bound
  // and the barrier's vote are the same for every thread of the block.
  const int last = min(n, static_cast<int>(blockIdx.x + 1) * kThreads) - 1;
  for (int base = 0; base < last; base += kThreads) {
    const int i = base + threadIdx.x;
    if (i < n) {
      sx[threadIdx.x] = cloud[3 * i];
      sy[threadIdx.x] = cloud[3 * i + 1];
      sz[threadIdx.x] = cloud[3 * i + 2];
    }
    __syncthreads();
    if (active && !found) {
      const int count = min(kThreads, j - base);  // points i < j in this tile
      for (int t = 0; t < count; ++t) {
        if (sx[t] == x && sy[t] == y && sz[t] == z) {
          found = true;
          break;
        }
      }
    }
    // Also the barrier before the next tile overwrites this one.
    const bool done = !active || found || j <= base + kThreads;
    if (__syncthreads_and(done)) break;
  }
  if (active) dup[static_cast<size_t>(b) * n + j] = found ? 1.f : 0.f;
}

}  // namespace

// xyz [b, n, 3] f32, contiguous -> dup [b, n] f32 of 1.0 and 0.0.
extern "C" int dupmask_launch(const void* xyz, int b, int n, void* dup, void* stream) {
  if (b < 1 || b > 65535 || n < 1) return cudaErrorInvalidValue;
  const dim3 grid((n + kThreads - 1) / kThreads, b);
  dupmask_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), n, static_cast<float*>(dup));
  return cudaGetLastError();
}
