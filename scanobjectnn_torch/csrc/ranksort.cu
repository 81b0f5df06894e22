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
// ties), padded with all-ones words to P = threads * E, a power of two, and a
// bitonic network orders them.  Thread t holds the words t*E .. t*E+E-1 in
// registers (the plan, ranksort_kernel.sort_plan, picks E and the threads):
//   * a compare-exchange at a stride below E stays in the thread's registers;
//   * a stride below 32*E pairs two lanes of one warp: __shfl_xor_sync, no
//     barrier;
//   * only strides of 32*E and above go through shared memory: the merge that
//     needs them stores the block's words, runs those steps in place with a
//     barrier after each, and loads the words back for its warp and register
//     steps.  At N = 2048 (E = 8, 256 threads) that is 6 shared-memory steps of
//     the network's 66, and 9 barriers in place of 66.
// Words sit in shared memory at i ^ ((i >> 4) & (E-1)): a warp's stores of one
// register, E words apart, and the in-place steps' 32 consecutive words both
// fall in distinct bank pairs.  Then the block's ids and their inverse, the
// ranks, pass through shared memory (row r takes id = word r's index,
// rank[id] = r), so that the stores of ids, ranks, sorted rows and feature
// rows are consecutive across a warp (the ranks scattered straight to device
// memory took a third of the call).
// Bound: bytes (each input read once, each output written once); at B = 128
// clouds of 2048 the network's shuffles and compare-and-selects set its time.

#include <cuda_runtime.h>

#include <cstdint>

#include "kernel_info.cuh"

namespace {

constexpr int kMaxN = 16384;  // 128 KB of sort words
constexpr int kMaxThreads = 1024;
constexpr int kWarp = 32;
constexpr int kRowsInFlight = 8;  // the payload's rows loaded before their stores

using u64 = unsigned long long;

// Order-preserving bits of a key: unsigned order equals float order, -0 and
// +0 equal, a NaN after +inf.
__device__ __forceinline__ uint32_t order_bits(float v) {
  if (v != v) return 0xffffffffu;
  const uint32_t u = v == 0.f ? 0u : __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The shared-memory slot of word i (a permutation within aligned groups of E).
template <int E>
__device__ __forceinline__ int slot(int i) {
  return i ^ ((i >> 4) & (E - 1));
}

// a, b := ascending ? (min, max) : (max, min).
__device__ __forceinline__ void cmpx(u64& a, u64& b, bool ascending) {
  const bool swap = (a > b) == ascending;
  const u64 lo = swap ? b : a, hi = swap ? a : b;
  a = lo;
  b = hi;
}

// The compare-exchanges of one merge at strides E/2 .. 1, all in direction
// `ascending` (a merge of size > E, so the direction is the thread's).
template <int E>
__device__ __forceinline__ void register_steps(u64 (&w)[E], bool ascending) {
#pragma unroll
  for (int j = E / 2; j > 0; j >>= 1) {
#pragma unroll
    for (int e = 0; e < E; ++e)
      if ((e & j) == 0) cmpx(w[e], w[e | j], ascending);
  }
}

// Sorts the P = blockDim.x * E words of w (thread t: words t*E + e) into
// ascending order across the block.  s: P words of shared memory.
template <int E>
__device__ __forceinline__ void block_sort(u64 (&w)[E], u64* s, int p_words) {
  const int t = threadIdx.x, lane = t & (kWarp - 1), threads = blockDim.x;
  const int base = t * E;
  // Merges of size 2 .. E: inside the thread, each pair's own direction.
#pragma unroll
  for (int size = 2; size <= E; size <<= 1) {
#pragma unroll
    for (int j = size / 2; j > 0; j >>= 1) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        if ((e & j) == 0) cmpx(w[e], w[e | j], ((base + e) & size) == 0);
    }
  }
  for (int size = 2 * E; size <= p_words; size <<= 1) {
    const bool ascending = (base & size) == 0;
    int j = size / 2;
    if (j >= kWarp * E) {
      // Strides of a warp's words and above: in place in shared memory.
#pragma unroll
      for (int e = 0; e < E; ++e) s[slot<E>(base + e)] = w[e];
      __syncthreads();
      for (; j >= kWarp * E; j >>= 1) {
        for (int p = t; p < p_words / 2; p += threads) {
          const int lo = 2 * p - (p & (j - 1)), hi = lo + j;
          const u64 a = s[slot<E>(lo)], z = s[slot<E>(hi)];
          if ((a > z) == ((lo & size) == 0)) {
            s[slot<E>(lo)] = z;
            s[slot<E>(hi)] = a;
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int e = 0; e < E; ++e) w[e] = s[slot<E>(base + e)];
    }
    // Strides E .. 16*E: the partner is lane ^ (j / E) of the same warp.
    for (; j >= E; j >>= 1) {
      const int mask = j / E;
      const bool keep_min = ((lane & mask) == 0) == ascending;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const u64 other = __shfl_xor_sync(0xffffffffu, w[e], mask);
        w[e] = (other < w[e]) == keep_min ? other : w[e];
      }
    }
    register_steps<E>(w, ascending);
  }
}

template <int E>
__global__ void __launch_bounds__(kMaxThreads)
    ranksort_kernel(const float* __restrict__ key, const float* __restrict__ xyz,
                    const uint16_t* __restrict__ feats, int n, int p_words, int row_units,
                    float* __restrict__ xyz_s, int32_t* __restrict__ ids, int32_t* __restrict__ rank,
                    uint16_t* __restrict__ feats_s) {
  extern __shared__ u64 words[];
  const size_t b = blockIdx.x, cloud = b * n;
  const int t = threadIdx.x, threads = blockDim.x, base = t * E;
  const float* cxyz = xyz + cloud * 3;
  const float* k = key + cloud;
  u64 w[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = base + e;
    w[e] = i < n ? (static_cast<u64>(order_bits(__ldg(k + i))) << 32) | static_cast<uint32_t>(i) : ~0ull;
  }
  block_sort<E>(w, words, p_words);

  // Sorted position base + e holds word w[e]: its id, and the position as
  // the id's rank, through shared memory, so that consecutive threads store
  // consecutive rows and ranks.
  int32_t* sid = reinterpret_cast<int32_t*>(words);  // p_words ids, then n ranks
  int32_t* srank = sid + p_words;
  __syncthreads();  // every thread's last reads of the sort words are done
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (base + e < n) {
      const int id = static_cast<int>(w[e] & 0xffffffffu);
      sid[base + e] = id;
      srank[id] = base + e;
    }
  }
  __syncthreads();
  // Rows r = t + q * threads (q < E covers the P >= n positions),
  // kRowsInFlight at a time: every load of a group issued before its first
  // store (a loop of one row at a time: 2.5 µs more at N = 2048 on an H100).
  constexpr int kInFlight = E < kRowsInFlight ? E : kRowsInFlight;
#pragma unroll
  for (int q0 = 0; q0 < E; q0 += kInFlight) {
    int id[kInFlight];
    float x[kInFlight], y[kInFlight], z[kInFlight];
#pragma unroll
    for (int q = 0; q < kInFlight; ++q) {
      const int r = t + (q0 + q) * threads;
      id[q] = r < n ? sid[r] : 0;
      x[q] = __ldg(cxyz + 3 * id[q]);
      y[q] = __ldg(cxyz + 3 * id[q] + 1);
      z[q] = __ldg(cxyz + 3 * id[q] + 2);
    }
#pragma unroll
    for (int q = 0; q < kInFlight; ++q) {
      const int r = t + (q0 + q) * threads;
      if (r < n) {
        const size_t dst = cloud + r;
        ids[dst] = id[q];
        rank[dst] = srank[r];
        xyz_s[dst * 3] = x[q];
        xyz_s[dst * 3 + 1] = y[q];
        xyz_s[dst * 3 + 2] = z[q];
      }
    }
  }
  if (feats == nullptr) return;
  for (int q = t; q < n * row_units; q += threads) {
    const int r = q / row_units, u = q - r * row_units;
    feats_s[(cloud + r) * row_units + u] = __ldg(feats + (cloud + sid[r]) * row_units + u);
  }
}

// The padded width of a plan: the least power of two >= n that gives every
// thread E words and the block whole warps, or 0 where (threads, E) is no
// plan.
int plan_words(int n, int threads, int per_thread) {
  if (n < 1 || n > kMaxN) return 0;
  if (per_thread != 1 && per_thread != 2 && per_thread != 4 && per_thread != 8 && per_thread != 16) return 0;
  int p = kWarp * per_thread;
  while (p < n) p <<= 1;
  return threads * per_thread == p && threads <= kMaxThreads ? p : 0;
}

template <int E>
int launch(const void* key, const void* xyz, const void* feats, int b, int n, int p_words, int row_units,
           void* xyz_s, void* ids, void* rank, void* feats_s, cudaStream_t stream) {
  const size_t smem = sizeof(u64) * static_cast<size_t>(p_words);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(ranksort_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  ranksort_kernel<E><<<b, p_words / E, smem, stream>>>(
      static_cast<const float*>(key), static_cast<const float*>(xyz), static_cast<const uint16_t*>(feats), n,
      p_words, row_units, static_cast<float*>(xyz_s), static_cast<int32_t*>(ids), static_cast<int32_t*>(rank),
      static_cast<uint16_t*>(feats_s));
  return cudaGetLastError();
}

}  // namespace

// key [B, N] f32, xyz [B, N, 3] f32, feats [B, N, row_units] 16-bit units or
// null; outputs xyz_s [B, N, 3], ids [B, N], rank [B, N], feats_s or null.
// threads a block and per_thread words a thread: ranksort_kernel.sort_plan;
// refused unless threads * per_thread is the least power of two >= N with
// threads a multiple of 32, at most 1024, and per_thread 1, 2, 4, 8 or 16.
extern "C" int ranksort_launch(const void* key, const void* xyz, const void* feats, int b, int n, int row_units,
                               int threads, int per_thread, void* xyz_s, void* ids, void* rank, void* feats_s,
                               void* stream) {
  const int p = plan_words(n, threads, per_thread);
  if (p == 0 || b < 1 || row_units < 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (per_thread) {
    case 1: return launch<1>(key, xyz, feats, b, n, p, row_units, xyz_s, ids, rank, feats_s, s);
    case 2: return launch<2>(key, xyz, feats, b, n, p, row_units, xyz_s, ids, rank, feats_s, s);
    case 4: return launch<4>(key, xyz, feats, b, n, p, row_units, xyz_s, ids, rank, feats_s, s);
    case 8: return launch<8>(key, xyz, feats, b, n, p, row_units, xyz_s, ids, rank, feats_s, s);
    default: return launch<16>(key, xyz, feats, b, n, p, row_units, xyz_s, ids, rank, feats_s, s);
  }
}

// The kernel a plan takes: info = {registers, local bytes a thread, dynamic
// shared bytes, resident blocks per SM}.
extern "C" int ranksort_info(int n, int threads, int per_thread, int* info) {
  const int p = plan_words(n, threads, per_thread);
  if (p == 0) return cudaErrorInvalidValue;
  const size_t smem = sizeof(u64) * static_cast<size_t>(p);
  switch (per_thread) {
    case 1: return kernel_info(ranksort_kernel<1>, smem, threads, info);
    case 2: return kernel_info(ranksort_kernel<2>, smem, threads, info);
    case 4: return kernel_info(ranksort_kernel<4>, smem, threads, info);
    case 8: return kernel_info(ranksort_kernel<8>, smem, threads, info);
    default: return kernel_info(ranksort_kernel<16>, smem, threads, info);
  }
}
