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
// shared memory for the broadcast of the winner, and a step costs one
// __syncthreads (warp-shuffle argmax, per-warp winners through a
// double-buffered shared array, then every warp reduces those redundantly).
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
// NaN-propagating minimum, the same argmax exchange.  Bound: the bytes of a
// step, 16 B a point (coordinates and min-distance read, min-distance
// written), mostly from L2, one step after another.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kMaxWarps = 32;
constexpr int kRegisterMaxPoints = 8 * 1024;  // REGISTER_MAX_POINTS of fps_kernel.py

// Argmax step on (value, index): NaN poisons the result (its index is n),
// a larger value wins, equal values go to the lower index.  Commutative and
// associative, so every lane of a butterfly ends with the same winner.
__device__ __forceinline__ void take_max(float& v, int& i, float ov, int oi) {
  if (isnan(v)) return;
  if (isnan(ov) || ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    take_max(v, i, ov, oi);
  }
}

template <int PPT>
__global__ void __launch_bounds__(1024) fps_kernel(const float* __restrict__ xyz, int n, int m,
                           int32_t* __restrict__ idx,
                           float* __restrict__ new_xyz) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + n;
  float* sz = sy + n;
  __shared__ float win_v[2][kMaxWarps];
  __shared__ int win_i[2][kMaxWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const float* cloud = xyz + static_cast<size_t>(blockIdx.x) * n * 3;
  for (int p = tid; p < n; p += nthreads) {
    sx[p] = cloud[3 * p];
    sy[p] = cloud[3 * p + 1];
    sz[p] = cloud[3 * p + 2];
  }
  __syncthreads();

  // Thread tid owns points tid, tid + nthreads, ... (strided: coalesced).
  float px[PPT], py[PPT], pz[PPT], md[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = tid + k * nthreads;
    px[k] = p < n ? sx[p] : 0.f;
    py[k] = p < n ? sy[p] : 0.f;
    pz[k] = p < n ? sz[p] : 0.f;
    md[k] = 1e38f;
  }

  int32_t* out_idx = idx + static_cast<size_t>(blockIdx.x) * m;
  float* out_xyz =
      new_xyz ? new_xyz + static_cast<size_t>(blockIdx.x) * m * 3 : nullptr;
  float lx = sx[0], ly = sy[0], lz = sz[0];
  if (tid == 0) {
    out_idx[0] = 0;
    if (out_xyz) {
      out_xyz[0] = lx;
      out_xyz[1] = ly;
      out_xyz[2] = lz;
    }
  }

  for (int j = 1; j < m; ++j) {
    float bv = -INFINITY;
    int bi = INT_MAX;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int p = tid + k * nthreads;
      if (p < n) {
        const float dx = px[k] - lx, dy = py[k] - ly, dz = pz[k] - lz;
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz));
        const float cur = md[k];
        md[k] = (isnan(d) || d < cur) ? d : cur;  // NaN-propagating minimum
        take_max(bv, bi, md[k], isnan(md[k]) ? n : p);
      }
    }
    warp_argmax(bv, bi);
    const int buf = j & 1;  // double buffer: one barrier per step suffices
    if (lane == 0) {
      win_v[buf][warp] = bv;
      win_i[buf][warp] = bi;
    }
    __syncthreads();
    bv = lane < nwarps ? win_v[buf][lane] : -INFINITY;
    bi = lane < nwarps ? win_i[buf][lane] : INT_MAX;
    warp_argmax(bv, bi);
    if (bi < n) {
      lx = sx[bi];
      ly = sy[bi];
      lz = sz[bi];
    } else {  // NaN row: index n, coordinates (0, 0, 0)
      lx = ly = lz = 0.f;
    }
    if (tid == 0) {
      out_idx[j] = bi;
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
  __shared__ float win_v[2][kMaxWarps];
  __shared__ int win_i[2][kMaxWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
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
    float bv = -INFINITY;
    int bi = INT_MAX;
#pragma unroll 4
    for (int p = tid; p < n; p += nthreads) {
      const float dx = cloud[3 * p] - lx, dy = cloud[3 * p + 1] - ly, dz = cloud[3 * p + 2] - lz;
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      const float cur = j == 1 ? 1e38f : md[p];
      const float nd = (isnan(d) || d < cur) ? d : cur;  // NaN-propagating minimum
      md[p] = nd;
      take_max(bv, bi, nd, isnan(nd) ? n : p);
    }
    warp_argmax(bv, bi);
    const int buf = j & 1;  // double buffer: one barrier per step suffices
    if (lane == 0) {
      win_v[buf][warp] = bv;
      win_i[buf][warp] = bi;
    }
    __syncthreads();
    bv = lane < nwarps ? win_v[buf][lane] : -INFINITY;
    bi = lane < nwarps ? win_i[buf][lane] : INT_MAX;
    warp_argmax(bv, bi);
    if (bi < n) {
      lx = cloud[3 * bi];
      ly = cloud[3 * bi + 1];
      lz = cloud[3 * bi + 2];
    } else {  // NaN row: index n, coordinates (0, 0, 0)
      lx = ly = lz = 0.f;
    }
    if (tid == 0) {
      out_idx[j] = bi;
      if (out_xyz) {
        out_xyz[3 * j] = lx;
        out_xyz[3 * j + 1] = ly;
        out_xyz[3 * j + 2] = lz;
      }
    }
  }
}

template <int PPT>
cudaError_t launch_fps(const float* xyz, int b, int n, int m, int32_t* idx,
                       float* new_xyz, int threads, cudaStream_t stream) {
  const size_t smem = 3 * static_cast<size_t>(n) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fps_kernel<PPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  fps_kernel<PPT><<<b, threads, smem, stream>>>(xyz, n, m, idx, new_xyz);
  return cudaGetLastError();
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
  // About 4 points per thread up to 1024 threads, then up to 8 (N <= 8192;
  // 16 per thread at 1024 threads would exceed the SM's 64K registers).
  int threads = 32;
  while (threads < 1024 && threads * 4 < n) threads *= 2;
  const int ppt = (n + threads - 1) / threads;
  if (ppt <= 1) return launch_fps<1>(x, b, n, m, i, c, threads, s);
  if (ppt <= 2) return launch_fps<2>(x, b, n, m, i, c, threads, s);
  if (ppt <= 4) return launch_fps<4>(x, b, n, m, i, c, threads, s);
  if (ppt <= 8) return launch_fps<8>(x, b, n, m, i, c, threads, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
