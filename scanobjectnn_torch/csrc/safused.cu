// Fused eval-time SA layer for Hopper (sm_90a): ball select + gather +
// folded-BN MLP + max-pool in one kernel.
//
// Replaces scanobjectnn_tpu/ops/pallas/safused_kernel.py (sa_ball_mlp_pool ->
// _sa_ball_mlp_call, K <= 64).  Semantics are documented in
// scanobjectnn_torch/ops/cuda/safused_kernel.py; the TPU mechanisms (one-hot
// MXU slot extraction, the block-triangular cumsum, bf16 Dekker splits) are
// not carried over: on the card a gather is a load.
//
// One block handles QPB = max(1, 64 / K) queries of one cloud, i.e. R = QPB*K
// <= 64 (query, slot) rows:
//   1. ball select: one warp per query scans the candidates 32 at a time in
//      point order (ballot + popc keep the order) and stops after K hits;
//   2. the rows [c3 | feat[idx]] are staged in shared memory (c3 rounded to
//      the compute type, features converted to f32 exactly);
//   3. each hidden layer maps 8 rows x 1 output column to a thread (one
//      weight load, read through L2, feeds 8 FMAs; the activations are
//      warp-broadcast reads of shared memory) and stores relu(acc + b),
//      rounded to the compute type, in the other shared buffer;
//   4. the last layer runs per (query, column) over the K slots and keeps a
//      running max, so its activations are never stored.
// Bound: the MLP's FLOPs on CUDA cores (tensor cores are later work).
//
// Distances use __fmul_rn/__fadd_rn so nvcc cannot contract them into FMAs:
// the bits of d2 decide ball-boundary hits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerTask = 8;
constexpr int kMaxRows = 64;
constexpr int kMaxLayers = 8;
constexpr size_t kMaxSmem = 227 * 1024;

struct Layers {
  int n;
  int width[kMaxLayers];
  const void* w[kMaxLayers];  // [width[l-1], width[l]] in the compute type; w[0] unused
  const float* b[kMaxLayers];
};

struct Args {
  const float* xyz;      // [B, N, 3]
  const float* new_xyz;  // [B, M, 3]
  const void* src;       // [B, N, cs] compute type, or null
  int n, m, cs, k, qpb;
  float r2;
  const void* w0x;  // [3, C0] or null
  const void* w0f;  // [cs, C0] or null (prelifted: src rows are layer-0 terms)
  int prelifted;
  int wa, wb;  // widths of the two activation buffers
  void* pooled;  // [B, M, Cout] compute type
  int32_t* idx;  // [B, M, K]
};

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round an f32 value to the compute type and back (identity for f32).
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f<T>(from_f<T>(v));
}

// acc[i] += sum_k in[r[i] * ld + k] * w[k * cout + c], k < kin.
template <typename T>
__device__ __forceinline__ void accumulate(const float* in, int ld, int kin,
                                           const T* __restrict__ w, int cout,
                                           int c, const int (&r)[kRowsPerTask],
                                           float (&acc)[kRowsPerTask]) {
  for (int kk = 0; kk < kin; ++kk) {
    const float wv = to_f<T>(w[kk * cout + c]);
#pragma unroll
    for (int i = 0; i < kRowsPerTask; ++i) acc[i] = fmaf(in[r[i] * ld + kk], wv, acc[i]);
  }
}

// Pre-bias sums of layer l for rows r and column c.
template <typename T>
__device__ __forceinline__ void layer_sums(const Args& a, const Layers& L, int l,
                                           const float* in, int c,
                                           const int (&r)[kRowsPerTask],
                                           float (&acc)[kRowsPerTask]) {
#pragma unroll
  for (int i = 0; i < kRowsPerTask; ++i) acc[i] = 0.f;
  if (l > 0) {
    accumulate<T>(in, L.width[l - 1], L.width[l - 1],
                  static_cast<const T*>(L.w[l]), L.width[l], c, r, acc);
    return;
  }
  // Layer 0 over staged rows [c3(3) | feat(cs)]: feats·W0f + c3·W0x.
  const int ld = 3 + a.cs, c0 = L.width[0];
  if (a.w0f) {
    accumulate<T>(in + 3, ld, a.cs, static_cast<const T*>(a.w0f), c0, c, r, acc);
  } else if (a.prelifted) {
#pragma unroll
    for (int i = 0; i < kRowsPerTask; ++i) acc[i] = in[r[i] * ld + 3 + c];
  }
  if (a.w0x) {
    float accx[kRowsPerTask];
#pragma unroll
    for (int i = 0; i < kRowsPerTask; ++i) accx[i] = 0.f;
    accumulate<T>(in, ld, 3, static_cast<const T*>(a.w0x), c0, c, r, accx);
#pragma unroll
    for (int i = 0; i < kRowsPerTask; ++i) acc[i] += accx[i];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    safused_kernel(const Args a, const Layers L) {
  extern __shared__ float smem[];
  const int k = a.k, qpb = a.qpb, rows = qpb * k;
  int* sidx = reinterpret_cast<int*>(smem);  // [rows]
  float* buf_a = smem + rows;                // [rows, wa]: staged rows, odd layers
  float* buf_b = buf_a + rows * a.wa;        // [rows, wb]: even layers

  const int b = blockIdx.y, q0 = blockIdx.x * qpb;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = kThreads / 32;
  const float* cloud = a.xyz + static_cast<size_t>(b) * a.n * 3;

  // 1. Ball select, one warp per query.
  for (int ql = warp; ql < qpb; ql += nwarps) {
    int* row = sidx + ql * k;
    const int q = q0 + ql;
    if (q >= a.m) {  // ragged last block: dummy rows, never written out
      for (int s = lane; s < k; s += 32) row[s] = 0;
      continue;
    }
    const float* qp = a.new_xyz + (static_cast<size_t>(b) * a.m + q) * 3;
    const float qx = qp[0], qy = qp[1], qz = qp[2];
    int cnt = 0;
    for (int base = 0; base < a.n && cnt < k; base += 32) {
      const int p = base + lane;
      bool hit = false;
      if (p < a.n) {
        const float dx = qx - cloud[3 * p], dy = qy - cloud[3 * p + 1],
                    dz = qz - cloud[3 * p + 2];
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                   __fmul_rn(dz, dz));
        hit = d2 < a.r2;
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
    int32_t* out = a.idx + (static_cast<size_t>(b) * a.m + q) * k;
    for (int s = lane; s < k; s += 32) out[s] = row[s];
  }
  __syncthreads();

  // 2. Stage rows [c3 | feat[idx]].
  const int ld0 = 3 + a.cs;
  const T* src = static_cast<const T*>(a.src);
  for (int e = tid; e < rows * ld0; e += kThreads) {
    const int r = e / ld0, j = e - r * ld0, p = sidx[r];
    float v;
    if (j < 3) {
      const int q = min(q0 + r / k, a.m - 1);
      v = round_to<T>(cloud[3 * p + j] - a.new_xyz[(static_cast<size_t>(b) * a.m + q) * 3 + j]);
    } else {
      v = to_f<T>(src[(static_cast<size_t>(b) * a.n + p) * a.cs + (j - 3)]);
    }
    buf_a[e] = v;
  }
  __syncthreads();

  // 3. Hidden layers: layer l reads `in` and writes `out`, alternating buffers.
  const float* in = buf_a;
  int r[kRowsPerTask];
  float acc[kRowsPerTask];
  for (int l = 0; l + 1 < L.n; ++l) {
    float* out = (l % 2 == 0) ? buf_b : buf_a;
    const int cout = L.width[l];
    const int nblk = (rows + kRowsPerTask - 1) / kRowsPerTask;
    for (int t = tid; t < nblk * cout; t += kThreads) {
      const int c = t % cout, r0 = (t / cout) * kRowsPerTask;
#pragma unroll
      for (int i = 0; i < kRowsPerTask; ++i) r[i] = min(r0 + i, rows - 1);
      layer_sums<T>(a, L, l, in, c, r, acc);
      const float bias = L.b[l][c];
#pragma unroll
      for (int i = 0; i < kRowsPerTask; ++i)
        if (r0 + i < rows) out[(r0 + i) * cout + c] = round_to<T>(fmaxf(acc[i] + bias, 0.f));
    }
    __syncthreads();
    in = out;
  }

  // 4. Last layer with the max-pool over each query's K slots.
  const int l = L.n - 1, cout = L.width[l];
  T* pooled = static_cast<T*>(a.pooled);
  for (int t = tid; t < qpb * cout; t += kThreads) {
    const int ql = t / cout, c = t - ql * cout;
    const float bias = L.b[l][c];
    float mx = -INFINITY;
    for (int s0 = 0; s0 < k; s0 += kRowsPerTask) {
#pragma unroll
      for (int i = 0; i < kRowsPerTask; ++i) r[i] = ql * k + min(s0 + i, k - 1);  // repeats leave the max unchanged
      layer_sums<T>(a, L, l, in, c, r, acc);
#pragma unroll
      for (int i = 0; i < kRowsPerTask; ++i) mx = fmaxf(mx, fmaxf(acc[i] + bias, 0.f));
    }
    const int q = q0 + ql;
    if (q < a.m) pooled[(static_cast<size_t>(b) * a.m + q) * cout + c] = from_f<T>(mx);
  }
}

template <typename T>
cudaError_t launch(const Args& a, const Layers& L, int b, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        safused_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((a.m + a.qpb - 1) / a.qpb, b);
  safused_kernel<T><<<grid, kThreads, smem, stream>>>(a, L);
  return cudaGetLastError();
}

}  // namespace

extern "C" int safused_launch(const void* xyz, const void* new_xyz, const void* src,
                              int b, int n, int m, int cs, int k, float r2,
                              const void* w0x, const void* w0f, int prelifted,
                              int bf16, int n_layers, const int* widths,
                              const void* const* weights, const float* const* biases,
                              void* pooled, void* idx, void* stream) {
  if (k < 1 || k > kMaxRows || n_layers < 1 || n_layers > kMaxLayers) return cudaErrorInvalidValue;
  Args a{};
  a.xyz = static_cast<const float*>(xyz);
  a.new_xyz = static_cast<const float*>(new_xyz);
  a.src = src;
  a.n = n;
  a.m = m;
  a.cs = cs;
  a.k = k;
  a.qpb = k >= kMaxRows ? 1 : kMaxRows / k;
  a.r2 = r2;
  a.w0x = w0x;
  a.w0f = w0f;
  a.prelifted = prelifted;
  a.pooled = pooled;
  a.idx = static_cast<int32_t*>(idx);
  Layers L{};
  L.n = n_layers;
  // Buffer A holds the staged rows and the outputs of odd hidden layers,
  // buffer B the outputs of even hidden layers (the last layer stores none).
  a.wa = 3 + cs;
  a.wb = 1;
  for (int l = 0; l < n_layers; ++l) {
    L.width[l] = widths[l];
    L.w[l] = weights[l];
    L.b[l] = biases[l];
    if (l + 1 < n_layers) {
      int& w = (l % 2 == 0) ? a.wb : a.wa;
      w = max(w, widths[l]);
    }
  }
  const int rows = a.qpb * k;
  const size_t smem = sizeof(float) * (static_cast<size_t>(rows) * (1 + a.wa + a.wb));
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(a, L, b, smem, s) : launch<float>(a, L, b, smem, s);
}
