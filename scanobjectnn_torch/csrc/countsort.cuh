// The per-cloud stable counting sort that turns a row index into its
// inverse, shared by the deterministic scatter-add (gather.cu) and the
// EdgeConv backward (edge.cu), so both sum a point's incoming rows in the
// same ascending order.
//
// One block per cloud b.  idx[b, 0..r) names a point in [0, n) for every
// row.  offsets[b, 0..n]: exclusive prefix sums of the number of rows aimed
// at each point; perm[b, offsets[j]..offsets[j+1]): the rows aimed at point
// j, in ascending order.  Rows whose index is outside [0, n) are left out.
// The counts are integer atomics in shared memory (order-free), a block scan
// turns them into offsets, and one warp assigns the positions in row order
// with __match_any_sync.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kSortThreads = 512;
constexpr size_t kSortMaxSmem = 227 * 1024;

__global__ void __launch_bounds__(kSortThreads)
    count_sort_kernel(const int32_t* __restrict__ idx, int n, int r,
                      int32_t* __restrict__ offsets, int32_t* __restrict__ perm) {
  extern __shared__ int cursor[];  // [n]: counts, then each point's next free slot
  __shared__ int warp_sums[kSortThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int32_t* row_idx = idx + static_cast<size_t>(blockIdx.x) * r;
  int32_t* off = offsets + static_cast<size_t>(blockIdx.x) * (n + 1);
  int32_t* out_perm = perm + static_cast<size_t>(blockIdx.x) * r;

  for (int j = tid; j < n; j += kSortThreads) cursor[j] = 0;
  __syncthreads();
  for (int i = tid; i < r; i += kSortThreads) {
    const int j = row_idx[i];
    if (j >= 0 && j < n) atomicAdd(&cursor[j], 1);  // integer: order-free
  }
  __syncthreads();

  // Exclusive scan of the counts: each thread sums one contiguous chunk, and
  // a block scan of the chunk sums gives every chunk its base.
  const int per = (n + kSortThreads - 1) / kSortThreads;
  const int lo = min(tid * per, n), hi = min(lo + per, n);
  int sum = 0;
  for (int j = lo; j < hi; ++j) sum += cursor[j];
  int incl = sum;
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kSortThreads / 32 ? warp_sums[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += v;
    }
    if (lane < kSortThreads / 32) warp_sums[lane] = w;  // inclusive per warp
  }
  __syncthreads();
  int run = incl - sum + (warp > 0 ? warp_sums[warp - 1] : 0);
  for (int j = lo; j < hi; ++j) {
    const int cnt = cursor[j];
    cursor[j] = run;
    off[j] = run;
    run += cnt;
  }
  if (tid == kSortThreads - 1) off[n] = run;
  __syncthreads();

  // Stable fill: one warp walks the rows in order, 32 at a time.  Lanes aimed
  // at the same point take consecutive slots in lane order; the highest of
  // them advances the point's cursor.
  if (warp != 0) return;
  const unsigned below = (1u << lane) - 1u;
  for (int base = 0; base < r; base += 32) {
    const int i = base + lane;
    int j = i < r ? row_idx[i] : -1;
    const bool valid = j >= 0 && j < n;
    if (!valid) j = -1;
    const unsigned peers = __match_any_sync(0xffffffffu, j);
    const int slot = valid ? cursor[j] + __popc(peers & below) : 0;
    __syncwarp();
    if (valid) {
      out_perm[slot] = i;
      if ((peers >> lane) == 1u) cursor[j] += __popc(peers);
    }
    __syncwarp();
  }
}

// Launch count_sort_kernel over b clouds of r rows aimed at n points;
// offsets [b, n + 1] and perm [b, r] int32.
cudaError_t launch_count_sort(const int32_t* idx, int b, int n, int r, int32_t* offsets,
                              int32_t* perm, cudaStream_t s) {
  const size_t smem = sizeof(int) * static_cast<size_t>(n);
  if (smem > kSortMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        count_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  count_sort_kernel<<<b, kSortThreads, smem, s>>>(idx, n, r, offsets, perm);
  return cudaGetLastError();
}

}  // namespace
