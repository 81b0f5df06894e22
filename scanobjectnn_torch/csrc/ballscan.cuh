// The warp-ballot ball scan shared by the fused SA layer (safused.cu) and the
// ball group (ballgroup.cu), so the hit rule cannot drift between the two.
//
// One warp selects the first k points of a cloud, in point order, that lie
// inside the ball around (qx, qy, qz).  A point is a hit when d2 < r2 with
//   d2 = ((qx-x)^2 + (qy-y)^2) + (qz-z)^2
// from direct differences, without FMA contraction (__fmul_rn/__fadd_rn: the
// bits of d2 decide boundary hits); r2 is the radius squared in double,
// rounded once to f32 by the caller.  The candidates are scanned 32 at a
// time (ballot + popc keep the point order) and the scan stops after k hits.

#pragma once

#include <cuda_runtime.h>

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
    bool hit = false;
    if (p < n) {
      const float dx = qx - cloud[3 * p], dy = qy - cloud[3 * p + 1], dz = qz - cloud[3 * p + 2];
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      hit = d2 < r2;
    }
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
