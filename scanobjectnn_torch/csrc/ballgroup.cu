// Ball query, with or without the centred grouping of the coordinates, for
// Hopper (sm_90a).
//
// Replaces two kernels of scanobjectnn_tpu/ops/pallas/ballquery_kernel.py:
// query_ball_group_pallas -> _qbg_call (ballgroup_launch: idx, cnt and the
// grouped coordinates) and query_ball_pallas (ballquery_launch: idx and cnt
// only, the same kernel with no coordinate write).  Semantics are documented
// in scanobjectnn_torch/ops/cuda/ballgroup_kernel.py.  The TPU kernel's rank
// cumsum matmuls, one-hot slot extraction and bf16 Dekker splits are not
// carried over: the selection is the warp-ballot scan of ballscan.cuh (the
// same device function the fused SA layer runs), and the coordinates are
// loads.
//
// Bound: the scan of the N candidates of each query (one warp per query,
// 32 candidates per step, stopping after K hits).  The cloud, 12 KB at
// N=1024, stays in L1/L2 for the queries of a block.  The outputs (idx, cnt
// and, for the ball group, the [K, 3] centred coordinates) are written once,
// coalesced.

#include <cuda_runtime.h>

#include <cstdint>

#include "ballscan.cuh"

namespace {

constexpr int kWarps = 8;  // queries per block
constexpr int kMaxK = 1024;

__global__ void __launch_bounds__(kWarps * 32)
    ballgroup_kernel(const float* __restrict__ xyz, const float* __restrict__ new_xyz,
                     int n, int m, int k, float r2, float* __restrict__ grouped,  // null: no coordinates
                     int32_t* __restrict__ idx, int32_t* __restrict__ cnt) {
  extern __shared__ int rows[];  // [kWarps, k]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y, q = blockIdx.x * kWarps + warp;
  if (q >= m) return;  // warp-uniform, and no block barrier follows
  int* row = rows + warp * k;
  const float* cloud = xyz + static_cast<size_t>(b) * n * 3;
  const size_t bq = static_cast<size_t>(b) * m + q;
  const float qx = new_xyz[3 * bq], qy = new_xyz[3 * bq + 1], qz = new_xyz[3 * bq + 2];
  const int filled = ball_scan(cloud, n, qx, qy, qz, r2, k, row);
  if (lane == 0) cnt[bq] = filled;
  int32_t* out_idx = idx + bq * k;
  for (int s = lane; s < k; s += 32) out_idx[s] = row[s];
  if (grouped == nullptr) return;
  float* out = grouped + bq * k * 3;
  for (int e = lane; e < 3 * k; e += 32) {
    const int s = e / 3, c = e - 3 * s;
    out[e] = cloud[3 * row[s] + c] - (c == 0 ? qx : (c == 1 ? qy : qz));
  }
}

cudaError_t launch(const void* xyz, const void* new_xyz, int b, int n, int m, int k, float r2,
                   void* grouped, void* idx, void* cnt, void* stream) {
  if (b < 1 || n < 1 || m < 1 || k < 1 || k > kMaxK) return cudaErrorInvalidValue;
  const dim3 grid((m + kWarps - 1) / kWarps, b);
  const size_t smem = sizeof(int) * kWarps * static_cast<size_t>(k);  // <= 32 KB
  ballgroup_kernel<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const float*>(new_xyz), n, m, k, r2,
      static_cast<float*>(grouped), static_cast<int32_t*>(idx), static_cast<int32_t*>(cnt));
  return cudaGetLastError();
}

}  // namespace

extern "C" int ballgroup_launch(const void* xyz, const void* new_xyz, int b, int n, int m,
                                int k, float r2, void* grouped, void* idx, void* cnt,
                                void* stream) {
  return launch(xyz, new_xyz, b, n, m, k, r2, grouped, idx, cnt, stream);
}

extern "C" int ballquery_launch(const void* xyz, const void* new_xyz, int b, int n, int m,
                                int k, float r2, void* idx, void* cnt, void* stream) {
  return launch(xyz, new_xyz, b, n, m, k, r2, nullptr, idx, cnt, stream);
}
