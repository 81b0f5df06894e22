// Stable rank sort of point clouds by a scalar key, for Hopper (sm_90a).
//
// Replaces scanobjectnn_tpu/ops/pallas/ranksort_kernel.py (rank_sort_points,
// pl.pallas_call): the prep of the spatially bucketed SA layer (sabucket.cu),
// which sorts the points and the queries of each cloud along its widest axis.
// Semantics are documented in scanobjectnn_torch/ops/cuda/ranksort_kernel.py.
// The TPU kernel counted each rank by N^2 key comparisons on the VPU and
// moved the payload by one-hot MXU products of bf16 Dekker planes; on the
// card the payload moves by plain loads and stores, so neither is carried
// over.  The sort is the stable one: rank(i) = #{j : key_j < key_i or
// (key_j == key_i and j < i)}, -0.0 equal to +0.0, and a NaN key after every
// number (ties among NaNs by index), so the rank is always a permutation.
//
// One block a cloud: the N keys become 64-bit words (order-preserving bits of
// the key, then the index, so every word is distinct and the index breaks
// ties), padded to a power of two in shared memory (N = 2048: 16 KB), and a
// block-wide bitonic sort orders them: log2(N)^2 / 2 steps of N/2
// compare-exchanges, instead of the N^2 comparisons of a counting rank.  Then
// thread r reads word r and writes the sorted row r (coordinates, the original
// id, the feature row) and rank[id] = r.
// Bound: bytes (each input read once, each output written once); the sort's
// shared-memory steps and barriers set its time at B = 128 clouds of 2048.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxN = 16384;  // 128 KB of sort words

// Order-preserving bits of a key: unsigned order equals float order, -0 and
// +0 equal, a NaN after +inf.
__device__ __forceinline__ uint32_t order_bits(float v) {
  if (v != v) return 0xffffffffu;
  const uint32_t u = v == 0.f ? 0u : __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__global__ void __launch_bounds__(kThreads)
    ranksort_kernel(const float* __restrict__ key, const float* __restrict__ xyz,
                    const uint16_t* __restrict__ feats, int n, int npow, int row_units,
                    float* __restrict__ xyz_s, int32_t* __restrict__ ids, int32_t* __restrict__ rank,
                    uint16_t* __restrict__ feats_s) {
  extern __shared__ unsigned long long words[];
  const size_t b = blockIdx.x;
  const float* k = key + b * n;
  for (int j = threadIdx.x; j < npow; j += kThreads)
    words[j] = j < n ? (static_cast<unsigned long long>(order_bits(k[j])) << 32) | static_cast<uint32_t>(j)
                     : ~0ull;
  __syncthreads();
  for (int size = 2; size <= npow; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < npow / 2; i += kThreads) {
        const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
        const unsigned long long a = words[lo], z = words[hi];
        if ((a > z) == ((lo & size) == 0)) {
          words[lo] = z;
          words[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int r = threadIdx.x; r < n; r += kThreads) {
    const int id = static_cast<int>(words[r] & 0xffffffffu);
    const size_t src = b * n + id, dst = b * n + r;
    ids[dst] = id;
    rank[src] = r;
    for (int c = 0; c < 3; ++c) xyz_s[dst * 3 + c] = xyz[src * 3 + c];
    if (feats != nullptr)
      for (int u = 0; u < row_units; ++u) feats_s[dst * row_units + u] = feats[src * row_units + u];
  }
}

}  // namespace

// key [B, N] f32, xyz [B, N, 3] f32, feats [B, N, row_units] 16-bit units or
// null; outputs xyz_s [B, N, 3], ids [B, N], rank [B, N], feats_s or null.
extern "C" int ranksort_launch(const void* key, const void* xyz, const void* feats, int b, int n,
                               int row_units, void* xyz_s, void* ids, void* rank, void* feats_s,
                               void* stream) {
  if (n < 1 || n > kMaxN || b < 1) return cudaErrorInvalidValue;
  int npow = 1;
  while (npow < n) npow <<= 1;
  const size_t smem = sizeof(unsigned long long) * static_cast<size_t>(npow);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(ranksort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  ranksort_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(key), static_cast<const float*>(xyz), static_cast<const uint16_t*>(feats), n,
      npow, row_units, static_cast<float*>(xyz_s), static_cast<int32_t*>(ids), static_cast<int32_t*>(rank),
      static_cast<uint16_t*>(feats_s));
  return cudaGetLastError();
}
