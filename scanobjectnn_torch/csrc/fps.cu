// Farthest point sampling for Hopper (sm_90a).
//
// Replaces scanobjectnn_tpu/ops/pallas/fps_kernel.py (fps_pallas and
// fps_pallas_with_coords, body _fps_kernel).  Semantics and the NaN rule are
// documented in scanobjectnn_torch/ops/cuda/fps_kernel.py.
//
// Bound: latency.  The npoint-1 selection steps are strictly serial, each a
// block-wide argmax over N points, so the kernel runs one block per cloud and
// keeps the per-step critical path short: each thread holds PPT points and
// their running min-distance in registers, the cloud's coordinates sit in
// shared memory (one 16-byte word a point) for the broadcast of the winner,
// and a step costs one __syncthreads.  The argmax runs on an
// order-preserving 32-bit key of the running minimum (its bits; a NaN above
// +inf): a thread's best by integer compares, a warp's by two redux
// instructions (__reduce_max_sync of the key, then __reduce_min_sync of the
// index among the lanes that hold it), the warps' winners through a
// double-buffered shared array, reduced the same way by every warp.
//
// Distances use __fmul_rn/__fadd_rn so nvcc cannot contract them into FMAs:
// the bits of d decide ties and must match the plain version.
//
// N > 8192 (fps_large_kernel): the cloud no longer fits in the registers of
// 1024 threads (16 points a thread would exceed the SM's 64K registers), so
// each thread reads its points' coordinates from device memory every step
// and keeps their running min-distance in a scratch row of the same length
// (4 B a point, in L2 for any cloud a user loads).  The selection is the
// register kernel's step for step: the same distance expression, the same
// NaN-propagating minimum, the same argmax (block_argmax).  Bound: the bytes of a
// step, 16 B a point (coordinates and min-distance read, min-distance
// written), mostly from L2, one step after another.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "kernel_info.cuh"

namespace {

constexpr int kMaxWarps = 32;
constexpr int kRegisterMaxPoints = 8 * 1024;  // REGISTER_MAX_POINTS of fps_kernel.py
constexpr int kThreads = 512;                 // the register kernel's block up to 4096 points
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoPoint = INT_MAX;        // index of a thread or lane without a point

// The NaN-propagating minimum (a NaN in either gives NaN), one instruction.
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// A running minimum is >= +0 or NaN, so its bits are an order-preserving
// key: every NaN is above +inf (kNanKeys), whatever its sign and payload.
constexpr unsigned kNanKeys = 0x7f800001u;  // the smallest NaN key

// One point's key folded into a thread's best (key, index).  Points come in
// ascending index and a later one must be strictly larger, so an equal key
// keeps the lower index.
__device__ __forceinline__ void take_point(unsigned& bk, unsigned& bi, float md, int p, bool first) {
  const unsigned key = __float_as_uint(md);
  if (first || key > bk) {
    bk = key;
    bi = static_cast<unsigned>(p);
  }
}

// The block's argmax from each thread's best (key, index): a larger key
// wins, equal keys go to the lower index, and a NaN key poisons the result
// (index n).  A warp's winner takes two redux instructions (the largest
// key, then the lowest index that holds it); the warps' winners go through
// a double-buffered shared array, one barrier a step, and every warp
// reduces them the same way.
__device__ __forceinline__ unsigned block_argmax(unsigned key, unsigned id, int n, uint2 (*win)[kMaxWarps],
                                                 int buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const unsigned wk = __reduce_max_sync(kFull, key);
  const unsigned wi = __reduce_min_sync(kFull, key == wk ? id : kFull);
  if (lane == 0) win[buf][warp] = make_uint2(wk, wi);
  __syncthreads();
  const uint2 o = lane < nwarps ? win[buf][lane] : make_uint2(0u, kFull);
  const unsigned gk = __reduce_max_sync(kFull, o.x);
  const unsigned gi = __reduce_min_sync(kFull, o.x == gk ? o.y : kFull);
  return gk >= kNanKeys ? static_cast<unsigned>(n) : gi;
}

__device__ __forceinline__ float sq_dist(float px, float py, float pz, float lx, float ly, float lz) {
  const float dx = px - lx, dy = py - ly, dz = pz - lz;
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

template <int PPT>
__global__ void __launch_bounds__(1024) fps_kernel(const float* __restrict__ xyz, int n, int m,
                                                   int32_t* __restrict__ idx, float* __restrict__ new_xyz) {
  extern __shared__ float4 spts[];  // [n]: x, y, z, 0
  __shared__ uint2 win[2][kMaxWarps];

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const float* cloud = xyz + static_cast<size_t>(blockIdx.x) * n * 3;
  for (int p = tid; p < n; p += nthreads) spts[p] = make_float4(cloud[3 * p], cloud[3 * p + 1], cloud[3 * p + 2], 0.f);
  __syncthreads();

  // Thread tid owns points tid, tid + nthreads, ... (strided: coalesced).
  float px[PPT], py[PPT], pz[PPT], md[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = tid + k * nthreads;
    const float4 v = p < n ? spts[p] : make_float4(0.f, 0.f, 0.f, 0.f);
    px[k] = v.x;
    py[k] = v.y;
    pz[k] = v.z;
    md[k] = 1e38f;
  }

  int32_t* out_idx = idx + static_cast<size_t>(blockIdx.x) * m;
  float* out_xyz = new_xyz ? new_xyz + static_cast<size_t>(blockIdx.x) * m * 3 : nullptr;
  float lx = spts[0].x, ly = spts[0].y, lz = spts[0].z;
  if (tid == 0) {
    out_idx[0] = 0;
    if (out_xyz) {
      out_xyz[0] = lx;
      out_xyz[1] = ly;
      out_xyz[2] = lz;
    }
  }

  for (int j = 1; j < m; ++j) {
    unsigned bk = 0u, bi = kNoPoint;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int p = tid + k * nthreads;
      if (p < n) {
        const float d = sq_dist(px[k], py[k], pz[k], lx, ly, lz);
        md[k] = min_nan(d, md[k]);
        take_point(bk, bi, md[k], p, k == 0);
      }
    }
    const unsigned best = block_argmax(bk, bi, n, win, j & 1);
    if (best < static_cast<unsigned>(n)) {
      const float4 w = spts[best];
      lx = w.x;
      ly = w.y;
      lz = w.z;
    } else {  // NaN row: index n, coordinates (0, 0, 0)
      lx = ly = lz = 0.f;
    }
    if (tid == 0) {
      out_idx[j] = static_cast<int32_t>(best);
      if (out_xyz) {
        out_xyz[3 * j] = lx;
        out_xyz[3 * j + 1] = ly;
        out_xyz[3 * j + 2] = lz;
      }
    }
  }
}

// One block of 1024 threads a cloud, for any N: thread tid owns points tid,
// tid + 1024, ...; mind [B, N] holds their running min-distance (written at
// step 1, so it needs no initialisation).
__global__ void __launch_bounds__(1024) fps_large_kernel(const float* __restrict__ xyz, int n, int m,
                                                         float* __restrict__ mind, int32_t* __restrict__ idx,
                                                         float* __restrict__ new_xyz) {
  __shared__ uint2 win[2][kMaxWarps];
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const float* cloud = xyz + static_cast<size_t>(blockIdx.x) * n * 3;
  float* md = mind + static_cast<size_t>(blockIdx.x) * n;
  int32_t* out_idx = idx + static_cast<size_t>(blockIdx.x) * m;
  float* out_xyz = new_xyz ? new_xyz + static_cast<size_t>(blockIdx.x) * m * 3 : nullptr;
  float lx = cloud[0], ly = cloud[1], lz = cloud[2];
  if (tid == 0) {
    out_idx[0] = 0;
    if (out_xyz) {
      out_xyz[0] = lx;
      out_xyz[1] = ly;
      out_xyz[2] = lz;
    }
  }

  for (int j = 1; j < m; ++j) {
    unsigned bk = 0u, bi = kNoPoint;
#pragma unroll 4
    for (int p = tid; p < n; p += nthreads) {
      const float d = sq_dist(cloud[3 * p], cloud[3 * p + 1], cloud[3 * p + 2], lx, ly, lz);
      const float cur = j == 1 ? 1e38f : md[p];
      const float nd = min_nan(d, cur);
      md[p] = nd;
      take_point(bk, bi, nd, p, p == tid);
    }
    const unsigned best = block_argmax(bk, bi, n, win, j & 1);
    if (best < static_cast<unsigned>(n)) {
      lx = cloud[3 * best];
      ly = cloud[3 * best + 1];
      lz = cloud[3 * best + 2];
    } else {  // NaN row: index n, coordinates (0, 0, 0)
      lx = ly = lz = 0.f;
    }
    if (tid == 0) {
      out_idx[j] = static_cast<int32_t>(best);
      if (out_xyz) {
        out_xyz[3 * j] = lx;
        out_xyz[3 * j + 1] = ly;
        out_xyz[3 * j + 2] = lz;
      }
    }
  }
}

template <int PPT>
cudaError_t launch_fps(const float* xyz, int b, int n, int m, int32_t* idx, float* new_xyz, int threads,
                       cudaStream_t stream) {
  const size_t smem = sizeof(float4) * static_cast<size_t>(n);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(fps_kernel<PPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  fps_kernel<PPT><<<b, threads, smem, stream>>>(xyz, n, m, idx, new_xyz);
  return cudaGetLastError();
}

// Threads of the register kernel's block for n <= kRegisterMaxPoints: one
// point a thread up to kThreads, up to 8 points a thread of kThreads, and
// 1024 threads of up to 8 points above that.  Measured on an H100 (SXM,
// 700 W) at B = 16 and 128: 512 threads took the shortest step at N = 512,
// 1024 and 2048 (0.31-0.45 us; 128-256 threads and 1024 threads were
// 5-70% slower).
int fps_threads(int n) {
  int threads = 32;
  while (threads < kThreads && threads < n) threads *= 2;
  return threads * 8 < n ? 1024 : threads;
}

}  // namespace

// xyz [b, n, 3] f32 -> idx [b, m] int32 and, when new_xyz is not null,
// new_xyz [b, m, 3] f32.  mind: scratch of b * n floats, read only when
// n > kRegisterMaxPoints (fps_large_kernel); null otherwise.
extern "C" int fps_launch(const void* xyz, int b, int n, int m, void* idx,
                          void* new_xyz, void* mind, void* stream) {
  if (b < 1 || n < 1 || m < 1) return cudaErrorInvalidValue;
  auto* x = static_cast<const float*>(xyz);
  auto* i = static_cast<int32_t*>(idx);
  auto* c = static_cast<float*>(new_xyz);
  auto s = static_cast<cudaStream_t>(stream);
  if (n > kRegisterMaxPoints) {
    if (mind == nullptr) return cudaErrorInvalidValue;
    fps_large_kernel<<<b, 1024, 0, s>>>(x, n, m, static_cast<float*>(mind), i, c);
    return cudaGetLastError();
  }
  const int threads = fps_threads(n);
  const int ppt = (n + threads - 1) / threads;
  if (ppt <= 1) return launch_fps<1>(x, b, n, m, i, c, threads, s);
  if (ppt <= 2) return launch_fps<2>(x, b, n, m, i, c, threads, s);
  if (ppt <= 4) return launch_fps<4>(x, b, n, m, i, c, threads, s);
  if (ppt <= 8) return launch_fps<8>(x, b, n, m, i, c, threads, s);
  return cudaErrorInvalidValue;
}

// The kernel a launch at n points takes: info = {registers, local bytes a
// thread, dynamic shared bytes a block, resident blocks per SM, threads a
// block}.
extern "C" int fps_info(int n, int* info) {
  if (n < 1) return cudaErrorInvalidValue;
  if (n > kRegisterMaxPoints) {
    info[4] = 1024;
    return kernel_info(fps_large_kernel, 0, 1024, info);
  }
  const int threads = fps_threads(n), ppt = (n + threads - 1) / threads;
  const size_t smem = sizeof(float4) * static_cast<size_t>(n);
  info[4] = threads;
  if (ppt <= 1) return kernel_info(fps_kernel<1>, smem, threads, info);
  if (ppt <= 2) return kernel_info(fps_kernel<2>, smem, threads, info);
  if (ppt <= 4) return kernel_info(fps_kernel<4>, smem, threads, info);
  if (ppt <= 8) return kernel_info(fps_kernel<8>, smem, threads, info);
  return cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
