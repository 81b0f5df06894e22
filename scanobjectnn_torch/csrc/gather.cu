// Row gather and deterministic scatter-add for Hopper (sm_90a).
//
// Replaces scanobjectnn_tpu/ops/pallas/onehot.py: flat_gather
// (_flat_gather_impl) and flat_scatter (_flat_scatter_impl), which the
// training path reaches through edge_kernel.gather_neighbors_pallas and its
// VJP.  Semantics are documented in
// scanobjectnn_torch/ops/cuda/gather_kernel.py.  The TPU moves rows through
// one-hot MXU matmuls over bf16 Dekker splits (its scatter keeps about 17
// mantissa bits); on the card a gather is a load, and the scatter sums exact
// f32.
//
// Bound: bytes.  The gather reads and writes R rows of C floats, the
// scatter reads R rows and writes N.  Both give one warp to a row, its lanes
// across the channels (float4 when C % 4 == 0 and the rows are 16-byte
// aligned), so a row moves as whole 128-byte lines; the scatter's sum gives
// a warp 2 to 8 output rows where a row has at most 16 lanes' worth.
//
// The scatter is deterministic: it uses no float atomics.  The stable
// counting sort of countsort.cuh (three kernels over (tile of rows, cloud)
// blocks) turns the R row indices into each point's rows in ascending
// order.  The sum kernel then adds each output row's contributions in that
// order, the perm entries read 32 at a time and the loads of the next rows
// issued ahead.  Two calls on the same input give the same bits, those of a
// sequential index_add_.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "countsort.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// out[row] = vals[b, idx[row]] for row = b * r + i; a row whose index is
// outside [0, n) is written as NaN (never a stray read).
template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
    gather_kernel(const float* __restrict__ vals, const int32_t* __restrict__ idx, int n,
                  int r, int c, long long rows, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       row < rows; row += stride) {
    const long long b = row / r;
    const int j = idx[row];  // warp-uniform
    float* dst = out + row * c;
    if (j < 0 || j >= n) {
      for (int ch = lane; ch < c; ch += 32) dst[ch] = __int_as_float(0x7fc00000);
      continue;
    }
    const float* src = vals + (b * n + j) * c;
    if (kVec4) {
      const float4* s4 = reinterpret_cast<const float4*>(src);
      float4* d4 = reinterpret_cast<float4*>(dst);
      for (int v = lane; v < c / 4; v += 32) d4[v] = s4[v];
    } else {
      for (int ch = lane; ch < c; ch += 32) dst[ch] = src[ch];
    }
  }
}

// out[b, j] = sum of upd[b, i] over the rows i aimed at j, in ascending i;
// 0 where there is none.  L lanes an output row (32 / L rows a warp), across
// its channels (float4 with kVec4).  The sum is one chain of adds, so a
// point that many rows aim at (a ball query's padding repeats each query's
// first hit: up to 374 rows a point at SSG's SA2) waits on its loads: the
// lanes load kAhead rows into registers, then add them in order.  With
// L = 32 the warp reads 32 of the row's perm entries at once and hands them
// round by shuffles.
template <int L, bool kVec4>
__global__ void __launch_bounds__(kThreads)
    scatter_sum_kernel(const float* __restrict__ upd, const int32_t* __restrict__ offsets,
                       const int32_t* __restrict__ perm, int n, int r, int c,
                       long long rows, float* __restrict__ out) {
  constexpr int kRowsPerWarp = 32 / L, kAhead = 8;
  using Vec = typename std::conditional<kVec4, float4, float>::type;
  const int lane = threadIdx.x & 31, sub = lane % L;
  const int units = kVec4 ? c / 4 : c, lines = (c + 31) / 32;  // 128-byte lines a row
  const long long stride = static_cast<long long>(gridDim.x) * kWarps * kRowsPerWarp;
  for (long long row = (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * kRowsPerWarp + lane / L;
       row < rows; row += stride) {
    const long long b = row / n;
    const int j = static_cast<int>(row - b * n);
    const int32_t* off = offsets + b * (n + 1);
    const int start = off[j], end = off[j + 1];
    const int32_t* rows_of = perm + b * r;
    const Vec* src = reinterpret_cast<const Vec*>(upd + b * r * c);
    for (int v0 = 0; v0 < units; v0 += L) {  // the same trip count on every lane
      const int v = v0 + sub;
      const bool on = v < units;
      float acc[kVec4 ? 4 : 1] = {};
      auto add = [&](const Vec& u) {
        if constexpr (kVec4) {
          acc[0] += u.x;
          acc[1] += u.y;
          acc[2] += u.z;
          acc[3] += u.w;
        } else {
          acc[0] += u;
        }
      };
      Vec ahead[kAhead];
      if constexpr (L == 32) {
        int next = lane < end - start ? rows_of[start + lane] : 0;
        for (int base = start; base < end; base += 32) {
          const int cnt = min(32, end - base);  // warp-uniform
          const int here = next;
          // The next 32 rows' perm entries, and their cache lines asked of
          // L2 now (the warp's lanes across the (row, line) pairs).
          const int cnt_next = min(32, end - base - 32);
          next = lane < cnt_next ? rows_of[base + 32 + lane] : 0;
          for (int e0 = 0; e0 < cnt_next * lines; e0 += 32) {
            const int e = e0 + lane, row_of_e = __shfl_sync(0xffffffffu, next, min(e / lines, 31));
            if (e < cnt_next * lines) {
              asm volatile("prefetch.global.L2 [%0];" ::"l"(upd + b * r * c + static_cast<size_t>(row_of_e) * c + (e % lines) * 32));
            }
          }
          for (int u0 = 0; u0 < cnt; u0 += kAhead) {
#pragma unroll
            for (int k = 0; k < kAhead; ++k) {
              const int i = __shfl_sync(0xffffffffu, here, (u0 + k) & 31);
              if (on && u0 + k < cnt) ahead[k] = src[static_cast<size_t>(i) * units + v];
            }
#pragma unroll
            for (int k = 0; k < kAhead; ++k) {
              if (on && u0 + k < cnt) add(ahead[k]);
            }
          }
        }
      } else {
        for (int t0 = start; t0 < end; t0 += kAhead) {
#pragma unroll
          for (int k = 0; k < kAhead; ++k) {
            if (on && t0 + k < end) ahead[k] = src[static_cast<size_t>(rows_of[t0 + k]) * units + v];
          }
#pragma unroll
          for (int k = 0; k < kAhead; ++k) {
            if (on && t0 + k < end) add(ahead[k]);
          }
        }
      }
      if (on) {
        if constexpr (kVec4) {
          reinterpret_cast<float4*>(out + row * c)[v] = make_float4(acc[0], acc[1], acc[2], acc[3]);
        } else {
          out[row * c + v] = acc[0];
        }
      }
    }
  }
}

int blocks_for(long long rows) {
  const long long blocks = (rows + kWarps - 1) / kWarps;
  return static_cast<int>(blocks < 132 * 64 ? blocks : 132 * 64);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int L>
void launch_sum(bool vec4, const float* upd, const int32_t* off, const int32_t* perm, int n, int r, int c,
                long long rows, float* out, cudaStream_t s) {
  const int grid = blocks_for((rows + 32 / L - 1) / (32 / L));
  if (vec4) {
    scatter_sum_kernel<L, true><<<grid, kThreads, 0, s>>>(upd, off, perm, n, r, c, rows, out);
  } else {
    scatter_sum_kernel<L, false><<<grid, kThreads, 0, s>>>(upd, off, perm, n, r, c, rows, out);
  }
}

}  // namespace

extern "C" int gather_launch(const void* vals, const void* idx, int b, int n, int r, int c,
                             void* out, void* stream) {
  if (b < 1 || n < 1 || r < 1 || c < 1) return cudaErrorInvalidValue;
  const long long rows = static_cast<long long>(b) * r;
  auto* v = static_cast<const float*>(vals);
  auto* i = static_cast<const int32_t*>(idx);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (c % 4 == 0 && aligned16(vals) && aligned16(out)) {
    gather_kernel<true><<<blocks_for(rows), kThreads, 0, s>>>(v, i, n, r, c, rows, o);
  } else {
    gather_kernel<false><<<blocks_for(rows), kThreads, 0, s>>>(v, i, n, r, c, rows, o);
  }
  return cudaGetLastError();
}

// Scratch of the counting sort: count_sort_tiles(n, r) * n int32 a cloud.
extern "C" int count_sort_tiles_for(int n, int r) { return n < 1 || r < 1 ? 0 : count_sort_tiles(n, r); }

// The counting sort alone: idx [b, r] int32 -> offsets [b, n + 1] and perm
// [b, r] int32; counts is its scratch.
extern "C" int count_sort_launch(const void* idx, int b, int n, int r, void* offsets, void* perm, void* counts,
                                 void* stream) {
  return launch_count_sort(static_cast<const int32_t*>(idx), b, n, r, static_cast<int32_t*>(offsets),
                           static_cast<int32_t*>(perm), static_cast<int32_t*>(counts),
                           static_cast<cudaStream_t>(stream));
}

extern "C" int scatter_add_launch(const void* idx, const void* upd, int b, int n, int r, int c,
                                  void* offsets, void* perm, void* counts, void* out, void* stream) {
  if (b < 1 || n < 1 || r < 1 || c < 1) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto* off = static_cast<int32_t*>(offsets);
  auto* p = static_cast<int32_t*>(perm);
  const cudaError_t err =
      launch_count_sort(static_cast<const int32_t*>(idx), b, n, r, off, p, static_cast<int32_t*>(counts), s);
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(b) * n;
  auto* u = static_cast<const float*>(upd);
  auto* o = static_cast<float*>(out);
  const bool vec4 = c % 4 == 0 && aligned16(upd) && aligned16(out);
  const int units = vec4 ? c / 4 : c;
  if (units <= 4) {
    launch_sum<4>(vec4, u, off, p, n, r, c, rows, o, s);
  } else if (units <= 8) {
    launch_sum<8>(vec4, u, off, p, n, r, c, rows, o, s);
  } else if (units <= 16) {
    launch_sum<16>(vec4, u, off, p, n, r, c, rows, o, s);
  } else {
    launch_sum<32>(vec4, u, off, p, n, r, c, rows, o, s);
  }
  return cudaGetLastError();
}
