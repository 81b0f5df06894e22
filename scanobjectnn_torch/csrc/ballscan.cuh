// The ball query's hit rule, and the warp-ballot ball scan that the fused SA
// layers (safused.cu, sabucket.cu) run, so the rule cannot drift between
// them and the ball group (ballgroup.cu), whose own scan calls ball_hit too.
//
// A point is a hit when d2 < r2 with
//   d2 = ((qx-x)^2 + (qy-y)^2) + (qz-z)^2
// from direct differences, without FMA contraction (__fmul_rn/__fadd_rn: the
// bits of d2 decide boundary hits); r2 is the radius squared in double,
// rounded once to f32 by the caller.  A NaN coordinate is never a hit.
//
// ball_scan: one warp selects the first k points of a cloud, in point
// order, that lie inside the ball around (qx, qy, qz).  The candidates are
// scanned 32 at a time (ballot + popc keep the point order) and the scan
// stops after k hits.

#pragma once

#include <cuda_runtime.h>

static __device__ __forceinline__ bool ball_hit(float qx, float qy, float qz, float x, float y, float z,
                                                float r2) {
  const float dx = qx - x, dy = qy - y, dz = qz - z;
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
  return d2 < r2;
}

// cloud: [n, 3] f32; row: k ints visible to the whole warp (shared memory).
// Every lane of the warp must call it.  On return row[0, k) holds the hits,
// padded with the first hit, or point 0 where there is none, and every lane
// sees it.  Returns min(hits, k).
static __device__ __forceinline__ int ball_scan(const float* __restrict__ cloud, int n,
                                                float qx, float qy, float qz, float r2,
                                                int k, int* row) {
  const int lane = threadIdx.x & 31;
  int cnt = 0;  // warp-uniform: a sum of ballot popcounts
  for (int base = 0; base < n && cnt < k; base += 32) {
    const int p = base + lane;
    const bool hit = p < n && ball_hit(qx, qy, qz, cloud[3 * p], cloud[3 * p + 1], cloud[3 * p + 2], r2);
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    const int pos = cnt + __popc(mask & ((1u << lane) - 1u));
    if (hit && pos < k) row[pos] = p;
    cnt += __popc(mask);
  }
  __syncwarp();
  const int filled = min(cnt, k);
  const int first = filled > 0 ? row[0] : 0;  // no hit: point 0
  for (int s = filled + lane; s < k; s += 32) row[s] = first;
  __syncwarp();
  return filled;
}
