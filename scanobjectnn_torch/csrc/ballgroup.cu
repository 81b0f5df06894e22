// Ball query, with or without the centred grouping of the coordinates, for
// Hopper (sm_90a).
//
// Replaces two kernels of scanobjectnn_tpu/ops/pallas/ballquery_kernel.py:
// query_ball_group_pallas -> _qbg_call (ballgroup_launch: idx, cnt and the
// grouped coordinates) and query_ball_pallas (ballquery_launch: idx and cnt
// only, the same kernel with no coordinate write).  Semantics are documented
// in scanobjectnn_torch/ops/cuda/ballgroup_kernel.py.  The TPU kernel's rank
// cumsum matmuls, one-hot slot extraction and bf16 Dekker splits are not
// carried over: the selection is a ballot scan under the hit rule of
// ballscan.cuh (ball_hit, which the fused SA layers' ball_scan calls too),
// and the coordinates are loads.
//
// The launch plan (ballgroup_kernel.ball_plan, checked here): a block takes
// `queries` queries of one cloud, Q of them a warp (Q = 1 or 2; 32 lanes a
// query), and stages the cloud's coordinates once in shared memory as
// float4 (x, y, z, 0: one 16-byte load a point), `tile` points at a time in
// point order (one tile where the cloud fits), padded with +inf points to a
// whole step, which are never hits, so the scan tests no bound.  Each step a
// lane loads U points (U chunks of 32, U = 4 or 8 from the plan) and tests
// each against the warp's Q queries before the warp consumes the ballots in
// point order, so the loads and distances of a step do not wait on the
// last chunk's count, a loaded point serves Q queries, and a step without a
// hit skips the counting.  A hit below the K-th writes its index (and its
// centred coordinates) straight to its place in the output row; hits past
// the K-th are counted and ignored, so scanning further changes nothing.  A
// query stops once it has K hits, a block stops staging tiles once all its
// queries have.  The row is then padded with the first hit (its index kept
// by the lane that took it and found by a warp minimum, its coordinates
// read from the staged tile where it still holds them), or point 0 where
// there is none.  No rows buffer: a block's
// shared memory is its tile, whatever K.
//
// Bound: the scan of the points each query reaches (about nine f32
// operations a point), and the outputs (idx, cnt and, for the ball group,
// the [K, 3] centred coordinates) written once.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "ballscan.cuh"
#include "kernel_info.cuh"

namespace {

constexpr int kMaxK = 1024;     // MAX_NSAMPLE in ballgroup_kernel.py
constexpr int kMaxWarps = 8;    // MAX_WARPS: warps a block, at most
constexpr int kMaxTile = 3072;  // MAX_TILE: points staged at once (48 KB of float4)
constexpr unsigned kFull = 0xffffffffu;

bool plan_ok(int queries, int per_warp, int unroll, int tile) {
  const bool per_warp_ok = per_warp == 1 || per_warp == 2;
  const bool unroll_ok = unroll == 4 || unroll == 8;
  return per_warp_ok && unroll_ok && queries >= 1 && queries % per_warp == 0 && queries / per_warp <= kMaxWarps &&
         tile >= 1 && tile <= kMaxTile;
}

// Points of a staged tile of `count` points, padded to whole steps.
__host__ __device__ constexpr int padded(int count, int unroll) {
  return (count + 32 * unroll - 1) / (32 * unroll) * (32 * unroll);
}

constexpr size_t smem_bytes(int tile, int unroll) { return sizeof(float4) * static_cast<size_t>(padded(tile, unroll)); }

// One block: blockDim.x / 32 warps of Q queries of cloud blockIdx.y.  Every
// thread runs every barrier; a query past m scans nothing.
template <int U, int Q>
__global__ void __launch_bounds__(kMaxWarps * 32)
    ballgroup_kernel(const float* __restrict__ xyz, const float* __restrict__ new_xyz, int n, int m, int k,
                     float r2, int tile, float* __restrict__ grouped,  // null: no coordinates
                     int32_t* __restrict__ idx, int32_t* __restrict__ cnt) {
  extern __shared__ float4 stage[];  // [padded(tile, U)]: x, y, z, 0 of the tile's points
  const int lane = threadIdx.x & 31;
  const unsigned before = (1u << lane) - 1u;
  const int b = blockIdx.y;
  const int q0 = (blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * Q;
  const float* cloud = xyz + static_cast<size_t>(b) * n * 3;
  const float inf = __int_as_float(0x7f800000);
  float qx[Q], qy[Q], qz[Q];
  int hits[Q];   // warp-uniform: a sum of ballot popcounts
  int first[Q];  // the lane that takes a query's first hit: its index; else INT_MAX
  bool active[Q];
  int32_t* row[Q];  // the query's idx row
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    active[j] = q0 + j < m;
    const size_t bq = static_cast<size_t>(b) * m + (active[j] ? q0 + j : 0);
    qx[j] = new_xyz[3 * bq];
    qy[j] = new_xyz[3 * bq + 1];
    qz[j] = new_xyz[3 * bq + 2];
    hits[j] = 0;
    first[j] = INT_MAX;
    row[j] = idx + bq * k;
  }
  int first_staged = 0, count = 0;  // the tile staged last
  for (int t0 = 0; t0 < n; t0 += tile) {
    first_staged = t0;
    count = min(tile, n - t0);
    const int steps = padded(count, U);
    __syncthreads();  // the last tile is no longer read
    for (int p = threadIdx.x; p < steps; p += blockDim.x) {
      const float* src = cloud + 3 * (static_cast<size_t>(t0) + p);
      stage[p] = p < count ? make_float4(src[0], src[1], src[2], 0.f) : make_float4(inf, inf, inf, 0.f);
    }
    __syncthreads();
    bool any_active = false;
#pragma unroll
    for (int j = 0; j < Q; ++j) any_active |= active[j];
    for (int base = lane; base - lane < steps && any_active; base += 32 * U) {  // warp-uniform
      unsigned ballot[Q][U];
      unsigned any = 0u;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float4 v = stage[base + 32 * u];
#pragma unroll
        for (int j = 0; j < Q; ++j) {
          ballot[j][u] = active[j] ? __ballot_sync(kFull, ball_hit(qx[j], qy[j], qz[j], v.x, v.y, v.z, r2)) : 0u;
          any |= ballot[j][u];
        }
      }
      if (any == 0u) continue;  // warp-uniform: no hit in the step, nothing to count
      any_active = false;
#pragma unroll
      for (int j = 0; j < Q; ++j) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const unsigned bits = ballot[j][u];
          if (bits == 0u) continue;  // warp-uniform
          const int pos = hits[j] + __popc(bits & before);
          if ((bits >> lane) & 1u && pos < k) {
            const int p = base + 32 * u;
            row[j][pos] = t0 + p;
            if (pos == 0) first[j] = t0 + p;
            if (grouped != nullptr) {
              const float4 v = stage[p];
              float* out = grouped + (static_cast<size_t>(row[j] - idx) + pos) * 3;
              out[0] = v.x - qx[j];
              out[1] = v.y - qy[j];
              out[2] = v.z - qz[j];
            }
          }
          hits[j] += __popc(bits);
        }
        active[j] = active[j] && hits[j] < k;
        any_active |= active[j];
      }
    }
    if (!__syncthreads_or(any_active)) break;  // block-uniform
  }
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    if (q0 + j >= m) break;  // warp-uniform
    const size_t bq = static_cast<size_t>(b) * m + q0 + j;
    const int filled = min(hits[j], k);
    if (lane == 0) cnt[bq] = filled;
    const int pad = hits[j] > 0 ? __reduce_min_sync(kFull, first[j]) : 0;  // no hit: point 0
    for (int s = filled + lane; s < k; s += 32) row[j][s] = pad;
    if (grouped == nullptr) continue;
    const int p = pad - first_staged;  // in the tile staged last, still in shared memory?
    const float4 v = p >= 0 && p < count ? stage[p]
                                         : make_float4(cloud[3 * pad], cloud[3 * pad + 1], cloud[3 * pad + 2], 0.f);
    const float dx = v.x - qx[j], dy = v.y - qy[j], dz = v.z - qz[j];
    float* out = grouped + bq * k * 3;
    for (int e = 3 * filled + lane; e < 3 * k; e += 32) {
      const int c = e % 3;
      out[e] = c == 0 ? dx : c == 1 ? dy : dz;
    }
  }
}

// The instantiation of a plan's queries a warp and unroll (plan_ok holds them).
template <int Q>
auto kernel_of_unroll(int unroll) {
  return unroll == 4 ? ballgroup_kernel<4, Q> : ballgroup_kernel<8, Q>;
}

auto kernel_of(int per_warp, int unroll) {
  return per_warp == 1 ? kernel_of_unroll<1>(unroll) : kernel_of_unroll<2>(unroll);
}

cudaError_t launch(const void* xyz, const void* new_xyz, int b, int n, int m, int k, float r2, int queries,
                   int per_warp, int unroll, int tile, void* grouped, void* idx, void* cnt, void* stream) {
  if (b < 1 || b > 65535 || n < 1 || m < 1 || k < 1 || k > kMaxK || !plan_ok(queries, per_warp, unroll, tile)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((m + queries - 1) / queries, b);
  kernel_of(per_warp, unroll)<<<grid, queries / per_warp * 32, smem_bytes(tile, unroll),
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const float*>(new_xyz), n, m, k, r2, tile,
      static_cast<float*>(grouped), static_cast<int32_t*>(idx), static_cast<int32_t*>(cnt));
  return cudaGetLastError();
}

}  // namespace

// xyz [b, n, 3], new_xyz [b, m, 3] f32 -> grouped [b, m, k, 3] f32 (null:
// none), idx [b, m, k] int32, cnt [b, m] int32, on the plan (queries a
// block, queries a warp, unroll, tile) of ballgroup_kernel.ball_plan; a plan
// the kernel cannot run is refused.
extern "C" int ballgroup_launch(const void* xyz, const void* new_xyz, int b, int n, int m, int k, float r2,
                                int queries, int per_warp, int unroll, int tile, void* grouped, void* idx, void* cnt,
                                void* stream) {
  return launch(xyz, new_xyz, b, n, m, k, r2, queries, per_warp, unroll, tile, grouped, idx, cnt, stream);
}

extern "C" int ballquery_launch(const void* xyz, const void* new_xyz, int b, int n, int m, int k, float r2,
                                int queries, int per_warp, int unroll, int tile, void* idx, void* cnt, void* stream) {
  return launch(xyz, new_xyz, b, n, m, k, r2, queries, per_warp, unroll, tile, nullptr, idx, cnt, stream);
}

// The kernel a launch on the plan builds: info = {registers, local bytes a
// thread, dynamic shared bytes a block, resident blocks per SM}.
extern "C" int ballgroup_info(int queries, int per_warp, int unroll, int tile, int* info) {
  if (!plan_ok(queries, per_warp, unroll, tile)) return cudaErrorInvalidValue;
  return kernel_info(kernel_of(per_warp, unroll), smem_bytes(tile, unroll), queries / per_warp * 32, info);
}
