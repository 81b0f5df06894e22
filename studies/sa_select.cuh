// The fused SA layer's selection alone: a study, not part of the package.
//
// studies/sa_fma.py compiles csrc/safused.cu (#3, #10) and csrc/sabucket.cu
// (#4) with this header pre-included (nvcc --pre-include, -I csrc).  It
// includes sapool.cuh first, so the sources' own include of it is a no-op,
// then specialises mlp_pool for both compute types and both builds (two or
// three blocks an SM) to stop after step 1: each block selects its rows
// (the ball scan, the given indices, or #4's gate, window and scan) as the
// package's kernel does, then writes, for each of its queries, the sum of
// its selected indices into column 0 of pooled, so that no step of the
// selection is dead code.  The time of a
// call with this build is the selection's share of the package's.

#pragma once

#include "sapool.cuh"

namespace {

template <typename T>
__device__ __forceinline__ void selection_only(const Args& a, const Layers& L, const int* sidx, const int* qrow) {
  for (int ql = threadIdx.x; ql < a.qpb; ql += kThreads) {
    if (qrow[ql] < 0) continue;
    int sum = 0;
    for (int s = 0; s < a.k; ++s) sum += sidx[ql * a.k + s];
    static_cast<T*>(a.pooled)[(static_cast<size_t>(blockIdx.y) * a.m + qrow[ql]) * L.width[L.n - 1]] =
        from_f<T>(static_cast<float>(sum));
  }
}

#define SA_SELECTION_ONLY(T, B)                                                                           \
  template <>                                                                                             \
  __device__ __forceinline__ void mlp_pool<T, B>(const Args& a, const Layers& L, const int* sidx,         \
                                                 const int* qrow, float*) {                               \
    selection_only<T>(a, L, sidx, qrow);                                                                  \
  }
SA_SELECTION_ONLY(float, 2)
SA_SELECTION_ONLY(float, 3)
SA_SELECTION_ONLY(__nv_bfloat16, 2)
SA_SELECTION_ONLY(__nv_bfloat16, 3)
#undef SA_SELECTION_ONLY

}  // namespace
