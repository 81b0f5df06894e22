// Exact-key max-pool forward for Hopper (sm_90a): training BN from given
// statistics, relu, and the max over the neighbour axis whose winners and
// ties an f32 key decides, in one pass over the final layer's f32
// pre-activations.
//
// Replaces scanobjectnn_tpu/ops/pallas/poolkey_kernel.py:
// bn_relu_exactkey_pool (body _kernel).  Semantics are documented in
// scanobjectnn_torch/ops/cuda/poolkey_kernel.py.  For every (row, channel)
// and every neighbour slot k of z32 [rows, K, C]:
//   value  y   = relu(cd(((cd(z) - mean) * r) * gamma + beta))
//   key    key = relu(((z - mean) * r) * gamma + beta)
// with cd the compute dtype's rounding (bf16, round to nearest even; the
// identity in f32) and r = rsqrt(var + eps) a per-channel input, so the
// kernel and its plain version read the same r.  Outputs: kmax = max key,
// cnt = the number of slots whose key equals kmax, pooled = max of y over
// those slots.  A NaN key makes the column's kmax NaN, cnt 0 and pooled
// -inf, as the plain version's amax and == give.
//
// Bit-equality with the plain version is the contract: the op order is
// ((z - mean) * r) * gamma + beta in __fsub_rn / __fmul_rn / __fadd_rn, so
// nvcc cannot contract a product and a sum into an FMA, and the rounding
// to bf16 is __float2bfloat16_rn.
//
// Bound: bytes.  z32 is read once (4 bytes an element, a handful of f32
// operations each) and only [rows, C] outputs are written; at the SSG SA1
// step (B=16: 8192 rows, K=32, C=128) 134 MB, 40 us at 3.35 TB/s.  One
// thread owns one (row, channel) column and walks its K slots: neighbouring
// threads read neighbouring channels of the same slot (coalesced), four
// slots loaded ahead of their use.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kAhead = 4;  // slots loaded before they are used

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// relu that keeps a NaN (torch.relu's clamp_min(0)).
__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

__device__ __forceinline__ float affine(float z, float mean, float r, float g, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(z, mean), r), g), b);
}

template <bool BF16>
__device__ __forceinline__ float cd(float v) {
  if constexpr (BF16) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads)
    poolkey_kernel(const float* __restrict__ z, const float* __restrict__ gamma,
                   const float* __restrict__ beta, const float* __restrict__ mean,
                   const float* __restrict__ rr, int rows, int k, int c, void* __restrict__ pooled,
                   float* __restrict__ kmax, float* __restrict__ cnt) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= static_cast<int64_t>(rows) * c) return;
  const int ch = static_cast<int>(e % c);
  const int64_t row = e / c;
  const float mu = mean[ch], r = rr[ch], g = gamma[ch], b = beta[ch];
  const float* zp = z + row * k * c + ch;
  float best = -inf_f(), pool = -inf_f(), n = 0.f;
  bool nan_key = false;
  for (int j0 = 0; j0 < k; j0 += kAhead) {
    float zv[kAhead];
#pragma unroll
    for (int q = 0; q < kAhead; ++q) zv[q] = j0 + q < k ? zp[static_cast<int64_t>(j0 + q) * c] : 0.f;
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      if (j0 + q >= k) break;
      const float y = relu(cd<BF16>(affine(cd<BF16>(zv[q]), mu, r, g, b)));
      const float key = relu(affine(zv[q], mu, r, g, b));
      if (key > best) {
        best = key;
        n = 1.f;
        pool = y;
      } else if (key == best) {
        n = __fadd_rn(n, 1.f);
        pool = fmaxf(pool, y);
      } else if (key != key) {
        nan_key = true;
      }
    }
  }
  if (nan_key) {
    best = __int_as_float(0x7fc00000);
    n = 0.f;
    pool = -inf_f();
  }
  if constexpr (BF16) {
    static_cast<__nv_bfloat16*>(pooled)[e] = __float2bfloat16_rn(pool);
  } else {
    static_cast<float*>(pooled)[e] = pool;
  }
  kmax[e] = best;
  cnt[e] = n;
}

}  // namespace

// z32 [rows, k, c] f32; gamma, beta, mean, r [c] f32; all contiguous ->
// pooled [rows, c] (bf16 when bf16 != 0, else f32), kmax and cnt [rows, c]
// f32.
extern "C" int poolkey_launch(const void* z32, const void* gamma, const void* beta, const void* mean,
                              const void* r, int rows, int k, int c, int bf16, void* pooled,
                              void* kmax, void* cnt, void* stream) {
  if (rows < 1 || k < 1 || c < 1) return cudaErrorInvalidValue;
  const int64_t blocks = (static_cast<int64_t>(rows) * c + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto args = [&](auto kernel) {
    kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const float*>(z32), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<const float*>(mean),
        static_cast<const float*>(r), rows, k, c, pooled, static_cast<float*>(kmax),
        static_cast<float*>(cnt));
  };
  if (bf16) {
    args(poolkey_kernel<true>);
  } else {
    args(poolkey_kernel<false>);
  }
  return cudaGetLastError();
}
