// The per-cloud stable counting sort that turns a row index into its
// inverse, shared by the deterministic scatter-add (gather.cu) and the
// EdgeConv backward (edge.cu), so both sum a point's incoming rows in the
// same ascending order.
//
// idx[b, 0..r) names a point in [0, n) for every row.  offsets[b, 0..n]:
// exclusive prefix sums of the number of rows aimed at each point;
// perm[b, offsets[j]..offsets[j+1]): the rows aimed at point j, in ascending
// order.  Rows whose index is outside [0, n) are left out (perm past
// offsets[b, n] is not written).
//
// The sort is spread over the card in three kernels.  Each cloud's rows are
// cut into tiles of count_sort_tile(n) rows (1024, or n rounded up to 1024,
// so the scratch stays within r + n ints a cloud):
//   1. count: one block a (tile, cloud) counts its rows per point in shared
//      memory (integer atomics: order-free) into counts [b, tiles, n];
//   2. scan: one block a cloud turns the counts, in (point, tile) order,
//      into offsets and into each (tile, point)'s first slot, in place;
//   3. fill: one block a (tile, cloud); each of its first 8 warps (fewer
//      where their cursors would not fit) owns a contiguous segment
//      of the tile and counts its rows per point (__match_any_sync, one lane
//      a point adds), the per-(warp, point) counts are turned into prefix
//      slots starting at the tile's slot, and each warp then walks its
//      segment in order, 32 rows at a time: lanes aimed at one point take
//      consecutive slots in lane order, the highest advances the cursor.
// Every slot is fixed by the row order alone, so offsets and perm equal a
// stable argsort's.  The wrapper allocates counts
// (count_sort_tiles(n, r) * n ints a cloud); the kernels allocate nothing.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kSortTile = 1024;      // rows of a tile, at least
constexpr int kSortThreads = 256;    // count and fill kernels
constexpr int kScanThreads = 1024;   // scan kernel: one point a thread a round
constexpr int kFillWarps = 8;        // warps that walk a tile's rows in the fill, at most
constexpr size_t kSortMaxSmem = 227 * 1024;

int count_sort_tile(int n) { return n <= kSortTile ? kSortTile : (n + kSortTile - 1) / kSortTile * kSortTile; }

int count_sort_tiles(int n, int r) {
  const long long tile = count_sort_tile(n);
  return static_cast<int>((r + tile - 1) / tile);
}

// Warps of a fill block: eight, halved until their [warps, n] cursors fit.
int fill_warps(int n) {
  int w = kFillWarps;
  while (w > 1 && sizeof(int) * static_cast<size_t>(w) * n > kSortMaxSmem) w /= 2;
  return w;
}

__global__ void __launch_bounds__(kSortThreads)
    count_tiles_kernel(const int32_t* __restrict__ idx, int n, int r, int tile, int32_t* __restrict__ counts) {
  extern __shared__ int cnt[];  // [n]
  const int tid = threadIdx.x, t = blockIdx.x, tiles = gridDim.x;
  const int32_t* row_idx = idx + static_cast<size_t>(blockIdx.y) * r;
  for (int j = tid; j < n; j += kSortThreads) cnt[j] = 0;
  __syncthreads();
  const long long start = static_cast<long long>(t) * tile;
  const int lo = static_cast<int>(start), hi = static_cast<int>(start + tile < r ? start + tile : r);
  for (int i = lo + tid; i < hi; i += kSortThreads) {
    const int j = row_idx[i];
    if (j >= 0 && j < n) atomicAdd(&cnt[j], 1);  // integer: order-free
  }
  __syncthreads();
  int32_t* out = counts + (static_cast<size_t>(blockIdx.y) * tiles + t) * n;
  for (int j = tid; j < n; j += kSortThreads) out[j] = cnt[j];
}

__global__ void __launch_bounds__(kScanThreads)
    count_scan_kernel(int32_t* __restrict__ counts, int n, int tiles, int32_t* __restrict__ offsets) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int32_t* cnt = counts + static_cast<size_t>(blockIdx.x) * tiles * n;
  int32_t* off = offsets + static_cast<size_t>(blockIdx.x) * (n + 1);
  int carry = 0;
  for (int j0 = 0; j0 < n; j0 += kScanThreads) {
    const int j = j0 + tid;
    int total = 0;
    if (j < n) {
      for (int t = 0; t < tiles; ++t) total += cnt[static_cast<size_t>(t) * n + j];
    }
    int incl = total;
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sums[lane];
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, w, d);
        if (lane >= d) w += v;
      }
      warp_sums[lane] = w;  // inclusive per warp
    }
    __syncthreads();
    if (j < n) {
      int run = carry + incl - total + (warp > 0 ? warp_sums[warp - 1] : 0);
      off[j] = run;
      for (int t = 0; t < tiles; ++t) {
        const size_t e = static_cast<size_t>(t) * n + j;
        const int v = cnt[e];
        cnt[e] = run;
        run += v;
      }
    }
    carry += warp_sums[kScanThreads / 32 - 1];
    __syncthreads();  // warp_sums is reused
  }
  if (tid == 0) off[n] = carry;
}

__global__ void __launch_bounds__(kSortThreads)
    count_fill_kernel(const int32_t* __restrict__ idx, int n, int r, int tile, int warps,
                      const int32_t* __restrict__ slots, int32_t* __restrict__ perm) {
  extern __shared__ int cursor[];  // [warps, n]: the first `warps` warps walk the rows
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = blockIdx.x, tiles = gridDim.x;
  const int32_t* row_idx = idx + static_cast<size_t>(blockIdx.y) * r;
  int32_t* out_perm = perm + static_cast<size_t>(blockIdx.y) * r;
  int* mine = cursor + warp * n;
  const unsigned below = (1u << lane) - 1u;
  const int seg = tile / warps;
  const long long start = static_cast<long long>(t) * tile + static_cast<long long>(warp) * seg;
  const bool walks = warp < warps;
  const int lo = static_cast<int>(start < r ? start : r);
  const int hi = walks ? static_cast<int>(start + seg < r ? start + seg : r) : lo;

  for (int e = tid; e < warps * n; e += kSortThreads) cursor[e] = 0;
  __syncthreads();
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    int j = i < hi ? row_idx[i] : -1;
    const bool valid = j >= 0 && j < n;
    if (!valid) j = -1;
    const unsigned peers = __match_any_sync(0xffffffffu, j);
    if (valid && (peers & below) == 0u) mine[j] += __popc(peers);  // the lowest lane of each point
    __syncwarp();
  }
  __syncthreads();
  const int32_t* first = slots + (static_cast<size_t>(blockIdx.y) * tiles + t) * n;
  for (int j = tid; j < n; j += kSortThreads) {
    int run = first[j];
    for (int w = 0; w < warps; ++w) {
      const int v = cursor[w * n + j];
      cursor[w * n + j] = run;
      run += v;
    }
  }
  __syncthreads();
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    int j = i < hi ? row_idx[i] : -1;
    const bool valid = j >= 0 && j < n;
    if (!valid) j = -1;
    const unsigned peers = __match_any_sync(0xffffffffu, j);
    const int slot = valid ? mine[j] + __popc(peers & below) : 0;
    __syncwarp();
    if (valid) {
      out_perm[slot] = i;
      if ((peers >> lane) == 1u) mine[j] += __popc(peers);
    }
    __syncwarp();
  }
}

// The sort over b clouds of r rows aimed at n points: offsets [b, n + 1] and
// perm [b, r] int32 out, counts [b, count_sort_tiles(n, r), n] int32
// scratch.
cudaError_t launch_count_sort(const int32_t* idx, int b, int n, int r, int32_t* offsets, int32_t* perm,
                              int32_t* counts, cudaStream_t s) {
  if (b < 1 || n < 1 || r < 1 || b > 65535) return cudaErrorInvalidValue;
  const size_t count_smem = sizeof(int) * static_cast<size_t>(n);
  if (count_smem > kSortMaxSmem) return cudaErrorInvalidValue;
  const int warps = fill_warps(n);
  const size_t fill_smem = count_smem * warps;
  const int tile = count_sort_tile(n), tiles = count_sort_tiles(n, r);
  cudaError_t err = cudaFuncSetAttribute(count_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(count_smem));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(count_fill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(fill_smem));
  }
  if (err != cudaSuccess) return err;
  const dim3 grid(tiles, b);
  count_tiles_kernel<<<grid, kSortThreads, count_smem, s>>>(idx, n, r, tile, counts);
  count_scan_kernel<<<b, kScanThreads, 0, s>>>(counts, n, tiles, offsets);
  count_fill_kernel<<<grid, kSortThreads, fill_smem, s>>>(idx, n, r, tile, warps, counts, perm);
  return cudaGetLastError();
}

}  // namespace
