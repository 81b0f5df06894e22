// Duplicate-point mask for Hopper (sm_90a): PointCNN's unique-kNN input.
//
// Replaces scanobjectnn_tpu/ops/pallas/knn_kernel.py: duplicate_mask_pallas
// (body _dup_mask_kernel).  Semantics are documented in
// scanobjectnn_torch/ops/cuda/dupmask_kernel.py: dup[b, j] = 1.0 where point
// j equals some point i < j of its cloud in all three coordinates under
// float == (so -0.0 equals 0.0, and a coordinate that is NaN equals
// nothing), else 0.0.  The TPU kernel builds a [T, N] equality block per
// tile of rows and reduces it.
//
// Bound: operations, and in practice the launch.  A cloud of N points needs
// at most N(N-1)/2 comparisons of three floats: at B=32, N=1024 that is 16.8M
// pairs, about 1 us of work at the card's 67 TFLOP/s f32 rate, against
// 0.5 MB of bytes (the points read once, the mask written once).  What sets
// the time is the longest chain of comparisons one thread makes, and how
// much of the card the grid fills.  So a block takes a tile of 128 points
// and gives each point eight threads (strands): strand s compares the point
// with the earlier points s, s + 8, s + 16, ..., read from the cloud staged
// in shared memory as one float4 a point; the strands' findings are ORed
// in shared memory, exact in any order.  At N = 1024 the longest chain is
// 128 comparisons (1023 with one thread a point), and a grid of B = 32
// clouds is 256 blocks of 32 warps, two blocks an SM: one wave.  A warp is
// 32 points of one strand, so its lanes read the same staged point at once
// (a broadcast).  A strand compares four points a step (four loads in
// flight, one test of the found flag); the earlier points are staged kChunk
// at a time; a thread stops after the step that finds a match, and the
// block stops staging once every thread has found its twin or run out of
// earlier points (__syncthreads_and).

#include <cuda_runtime.h>

#include <cstdint>

#include "kernel_info.cuh"

namespace {

constexpr int kTile = 128;                   // points a block
constexpr int kStrands = 8;                  // threads a point
constexpr int kThreads = kTile * kStrands;   // 1024
constexpr int kChunk = 2048;                 // earlier points staged at once (32 KB)

__global__ void __launch_bounds__(kThreads, 2)
    dupmask_kernel(const float* __restrict__ xyz, int n, float* __restrict__ dup) {
  __shared__ float4 points[kChunk];
  __shared__ int hit[kTile];
  const int tid = threadIdx.x;
  const int u = tid % kTile, strand = tid / kTile;
  const int j = blockIdx.x * kTile + u;
  const bool active = j < n;  // no early return: every thread joins the barriers
  const float* cloud = xyz + static_cast<size_t>(blockIdx.y) * n * 3;
  float x = 0.f, y = 0.f, z = 0.f;
  if (active) {
    x = cloud[3 * j];
    y = cloud[3 * j + 1];
    z = cloud[3 * j + 2];
  }
  if (tid < kTile) hit[tid] = 0;
  bool found = false;
  // The block's last point has earlier points in [0, last); the loop bound
  // and the barrier's vote are the same for every thread of the block.
  const int last = min(n, static_cast<int>(blockIdx.x + 1) * kTile) - 1;
  for (int base = 0; base < last; base += kChunk) {
    const int len = min(kChunk, last - base);
    for (int i = tid; i < len; i += kThreads) {
      const float* p = cloud + 3 * static_cast<size_t>(base + i);
      points[i] = make_float4(p[0], p[1], p[2], 0.f);
    }
    __syncthreads();
    if (active && !found) {
      const int count = min(len, j - base);  // points i < j in this chunk
      int i = strand;
      for (; i + 3 * kStrands < count && !found; i += 4 * kStrands) {
        const float4 p0 = points[i], p1 = points[i + kStrands], p2 = points[i + 2 * kStrands],
                     p3 = points[i + 3 * kStrands];
        found = (p0.x == x && p0.y == y && p0.z == z) | (p1.x == x && p1.y == y && p1.z == z) |
                (p2.x == x && p2.y == y && p2.z == z) | (p3.x == x && p3.y == y && p3.z == z);
      }
      for (; i < count && !found; i += kStrands) {
        const float4 p = points[i];
        found = p.x == x && p.y == y && p.z == z;
      }
    }
    // Also the barrier before the next chunk overwrites this one.
    const bool done = !active || found || j <= base + kChunk;
    if (__syncthreads_and(done)) break;
  }
  if (found) atomicOr(&hit[u], 1);  // an OR: any strand, any order
  __syncthreads();
  if (active && strand == 0) dup[static_cast<size_t>(blockIdx.y) * n + j] = hit[u] ? 1.f : 0.f;
}

// An empty kernel launched as dupmask_kernel is: the floor of a call.
__global__ void __launch_bounds__(kThreads) dupmask_floor_kernel() {}

dim3 grid_for(int b, int n) { return dim3((n + kTile - 1) / kTile, b); }

}  // namespace

// xyz [b, n, 3] f32, contiguous -> dup [b, n] f32 of 1.0 and 0.0.
extern "C" int dupmask_launch(const void* xyz, int b, int n, void* dup, void* stream) {
  if (b < 1 || b > 65535 || n < 1) return cudaErrorInvalidValue;
  dupmask_kernel<<<grid_for(b, n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), n, static_cast<float*>(dup));
  return cudaGetLastError();
}

// The empty kernel at dupmask_launch's grid and block for [b, n, 3]: what a
// launch of that shape costs with no work in it.
extern "C" int dupmask_floor_launch(int b, int n, void* stream) {
  if (b < 1 || b > 65535 || n < 1) return cudaErrorInvalidValue;
  dupmask_floor_kernel<<<grid_for(b, n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}

// dupmask_kernel's build: info = {registers, local bytes a thread, dynamic
// shared bytes a block, resident blocks per SM}.
extern "C" int dupmask_info(int* info) { return kernel_info(dupmask_kernel, 0, kThreads, info); }
