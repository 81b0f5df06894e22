// SpiderConv's contraction (SpiderCNN's Taylor-feature convolution),
// forward and backward, for Hopper (sm_90a).
//
// Replaces scanobjectnn_tpu/ops/pallas/spider_kernel.py: spider_conv_pallas,
// forward _mix_kernel, backward _dmix_kernel and _dw_kernel.  Semantics are
// documented in scanobjectnn_torch/ops/cuda/spider_kernel.py.  With row
// m = b * n + i, reduction index r = (k * C + c) * T + t and the Taylor
// product p[m, r] = feat[b, idx[m, k], c] * g[m, k, t]:
//   forward          out[m, o]      = sum_r p[m, r] W[r, o]
//   data backward    D[m, r]        = sum_o dout[m, o] W[r, o]
//                    dgath[m, k, c] = sum_t g[m, k, t] D[m, r]
//                    dg[m, k, t]    = sum_c feat[b, idx[m, k], c] D[m, r]
//   weight backward  dW[r, o]       = sum_m p[m, r] dout[m, o]
// dfeat is the scatter-add of dgath (gather.cu), which the wrapper runs.
//
// The TPU kernel gathered rows with one-hot MXU matmuls, broadcast g over
// each C-block with a kron(I_K, 1_C) matmul, padded C to 8 and O to 128
// lanes, rounded every operand to bf16, saved the gathered rows for the
// backward and accumulated dW over a revisiting (T, B, tile) grid.  None of
// that is kept.  Each of the three products is a register-tiled matrix
// product in f32 on the CUDA cores: a block owns a BM x BN tile of the
// output, walks the reduction in chunks of kBK and stages both operands of a
// chunk in shared memory; the next chunk is fetched into registers while the
// current one is multiplied.  The Taylor product is formed as it is staged:
// a gather is a load, one cloud's rows (at most 1024 x 128 floats) sit in
// L2, and the [M, K*C*T] operand never exists in device memory.  Each p is
// rounded once (__fmul_rn), as the plain version's outer product rounds it;
// the sums use FMA.  Nothing runs in TF32.
//
// Determinism: the data backward sums over t and over c in ascending order
// in one thread each; the weight backward splits the rows into a fixed
// number of slices (spider_bwd_weight_slices, from the shapes alone), each
// block writes its slice's partial tile, and a second pass adds the
// partials in slice order.  No float atomics: two calls give the same bits.
//
// Bound: operations.  Each of the three products is 2 * M * (K*C*T) * O
// flops in f32; at B=32, N=1024, k=20, T=5 the four layers' forward is 282
// GFLOP, 4.2 ms at 67 TFLOP/s, and every call's bytes move in under 0.03
// ms.  This first version runs a 4x2 to 8x4 outer product per thread per
// staged value on the CUDA cores, two 256-thread blocks per SM at the
// 128 x 64 tiles; tensor cores (3xTF32 splits keep f32 accuracy) are for a
// later version.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 16;   // reduction chunk
constexpr int kPad = 4;   // shared-memory row padding (keeps float4 alignment)
constexpr int kMaxT = 64; // the data backward's column tile holds one channel's T values

// Division by an invariant divisor d >= 1 for 0 <= x < 2^31 (multiply-high
// and shift; Granlund and Montgomery).
struct FastDiv {
  unsigned mul, shift;
};

FastDiv make_div(unsigned d) {
  unsigned shift = 0;
  while (shift < 31 && (1u << shift) < d) ++shift;
  const uint64_t one = 1;
  const uint64_t magic = ((one << 32) * ((one << shift) - d)) / d + 1;
  return {static_cast<unsigned>(magic), shift};
}

__device__ __forceinline__ int fast_div(const FastDiv& f, int x) {
  const unsigned u = static_cast<unsigned>(x);
  return static_cast<int>((__umulhi(u, f.mul) + u) >> f.shift);
}

struct Spider {
  const float* __restrict__ feat;   // [B, N, C]
  const int32_t* __restrict__ idx;  // [B, N, K]
  const float* __restrict__ g;      // [B, N, K, T]
  int rows, n, k, c, t, r_len;      // rows = B * N, r_len = K * C * T
  FastDiv by_n, by_ct, by_t;
};

// The slot, channel and Taylor index of reduction index r.
__device__ __forceinline__ void split_r(const Spider& s, int r, int& kk, int& cc, int& tt) {
  kk = fast_div(s.by_ct, r);
  const int rem = r - kk * s.c * s.t;
  cc = fast_div(s.by_t, rem);
  tt = rem - cc * s.t;
}

// Row of m's neighbour in slot kk, or nullptr for an index outside [0, n).
__device__ __forceinline__ const float* neighbour(const Spider& s, int m, int kk) {
  const int j = s.idx[static_cast<long long>(m) * s.k + kk];
  if (static_cast<unsigned>(j) >= static_cast<unsigned>(s.n)) return nullptr;
  return s.feat + (static_cast<long long>(fast_div(s.by_n, m)) * s.n + j) * s.c;
}

// p[m, r] for r = (kk, cc, tt), rounded once; NaN for a bad index.
__device__ __forceinline__ float taylor_product(const Spider& s, int m, int kk, int cc, int tt) {
  const float* row = neighbour(s, m, kk);
  if (row == nullptr) return __int_as_float(0x7fc00000);
  return __fmul_rn(row[cc], s.g[(static_cast<long long>(m) * s.k + kk) * s.t + tt]);
}

template <int L>
__device__ __forceinline__ void load_smem(const float* p, float (&v)[L]) {
  if constexpr (L % 4 == 0) {
#pragma unroll
    for (int i = 0; i < L; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      v[i] = q.x; v[i + 1] = q.y; v[i + 2] = q.z; v[i + 3] = q.w;
    }
  } else if constexpr (L % 2 == 0) {
#pragma unroll
    for (int i = 0; i < L; i += 2) {
      const float2 q = *reinterpret_cast<const float2*>(p + i);
      v[i] = q.x; v[i + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < L; ++i) v[i] = p[i];
  }
}

// acc[TM x TN] += As[q, rows] x Bs[q, cols] over one staged chunk; the
// thread owns rows ty * TM .. and columns tx * TN ...
template <int BM, int BN, int TM, int TN>
__device__ __forceinline__ void multiply_chunk(const float* As, const float* Bs, int tx, int ty,
                                               float (&acc)[TM][TN]) {
#pragma unroll
  for (int q = 0; q < kBK; ++q) {
    float a[TM], b[TN];
    load_smem<TM>(As + q * (BM + kPad) + ty * TM, a);
    load_smem<TN>(Bs + q * (BN + kPad) + tx * TN, b);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// Forward: out[m, o] over a BM x BN tile.  A = p is staged with the
// reduction index fastest across threads (neighbouring threads read
// neighbouring channels of one gathered row), B = W with o fastest.
template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kThreads, 2)
    spider_fwd_kernel(Spider s, const float* __restrict__ w, int o_len, float* __restrict__ out) {
  static_assert((BM / TM) * (BN / TN) == kThreads, "one output micro-tile per thread");
  constexpr int kA = BM * kBK / kThreads, kB = BN * kBK / kThreads, kRowStep = kThreads / kBK;
  __shared__ __align__(16) float As[kBK * (BM + kPad)];
  __shared__ __align__(16) float Bs[kBK * (BN + kPad)];
  const int tid = threadIdx.x, tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = blockIdx.x * BM, o0 = blockIdx.y * BN;
  const int qa = tid % kBK, ma = tid / kBK;
  float ra[kA], rb[kB], acc[TM][TN] = {};

  auto fetch = [&](int r0) {
    const int r = r0 + qa;
    int kk = 0, cc = 0, tt = 0;
    if (r < s.r_len) split_r(s, r, kk, cc, tt);
#pragma unroll
    for (int i = 0; i < kA; ++i) {
      const int m = m0 + ma + i * kRowStep;
      ra[i] = (r < s.r_len && m < s.rows) ? taylor_product(s, m, kk, cc, tt) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      const int e = tid + i * kThreads, o = o0 + e % BN, rr = r0 + e / BN;
      rb[i] = (rr < s.r_len && o < o_len) ? w[static_cast<long long>(rr) * o_len + o] : 0.f;
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < kA; ++i) As[qa * (BM + kPad) + ma + i * kRowStep] = ra[i];
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      const int e = tid + i * kThreads;
      Bs[(e / BN) * (BN + kPad) + e % BN] = rb[i];
    }
  };

  fetch(0);
  for (int r0 = 0; r0 < s.r_len; r0 += kBK) {
    stash();
    __syncthreads();
    if (r0 + kBK < s.r_len) fetch(r0 + kBK);
    multiply_chunk<BM, BN, TM, TN>(As, Bs, tx, ty, acc);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= s.rows) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int o = o0 + tx * TN + j;
      if (o < o_len) out[static_cast<long long>(m) * o_len + o] = acc[i][j];
    }
  }
}

// Data backward: a block owns BM rows and one slot kk = blockIdx.y, and
// walks the channels in chunks of cc_max (cc_max * T <= BN columns).  Per
// chunk, D = dout W^T over the chunk's contiguous W rows (both operands
// staged with o fastest), then dgath over t and the running dg over c, each
// in ascending order in one thread.
constexpr int kDataBM = 64, kDataBN = 64, kDataTM = 4, kDataTN = 4;

__global__ void __launch_bounds__(kThreads)
    spider_bwd_data_kernel(Spider s, const float* __restrict__ w, const float* __restrict__ dout,
                           int o_len, int cc_max, float* __restrict__ dgath, float* __restrict__ dg) {
  constexpr int BM = kDataBM, BN = kDataBN, TM = kDataTM, TN = kDataTN;
  static_assert((BM / TM) * (BN / TN) == kThreads, "one output micro-tile per thread");
  constexpr int kA = BM * kBK / kThreads, kB = BN * kBK / kThreads, kStep = kThreads / kBK;
  __shared__ __align__(16) float As[kBK * (BM + kPad)];
  __shared__ __align__(16) float Bs[kBK * (BN + kPad)];
  __shared__ float Ds[BM * (BN + 1)];
  __shared__ float Gs[BM * kMaxT];
  const int tid = threadIdx.x, tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = blockIdx.x * BM, kk = blockIdx.y;
  const int q = tid % kBK, wl = tid / kBK;
  const int t_len = s.t;

  for (int c0 = 0; c0 < s.c; c0 += cc_max) {
    const int cn = min(cc_max, s.c - c0), ncol = cn * t_len;
    const long long base = (static_cast<long long>(kk) * s.c + c0) * t_len;  // first W row of the chunk
    float ra[kA], rb[kB], acc[TM][TN] = {};
    auto fetch = [&](int o_start) {
      const int o = o_start + q;
#pragma unroll
      for (int i = 0; i < kA; ++i) {
        const int m = m0 + wl + i * kStep;
        ra[i] = (o < o_len && m < s.rows) ? dout[static_cast<long long>(m) * o_len + o] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kB; ++i) {
        const int col = wl + i * kStep;
        rb[i] = (o < o_len && col < ncol) ? w[(base + col) * o_len + o] : 0.f;
      }
    };
    fetch(0);
    for (int o_start = 0; o_start < o_len; o_start += kBK) {
#pragma unroll
      for (int i = 0; i < kA; ++i) As[q * (BM + kPad) + wl + i * kStep] = ra[i];
#pragma unroll
      for (int i = 0; i < kB; ++i) Bs[q * (BN + kPad) + wl + i * kStep] = rb[i];
      __syncthreads();
      if (o_start + kBK < o_len) fetch(o_start + kBK);
      multiply_chunk<BM, BN, TM, TN>(As, Bs, tx, ty, acc);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) Ds[(ty * TM + i) * (BN + 1) + tx * TN + j] = acc[i][j];
    }
    __syncthreads();
    for (int e = tid; e < BM * cn; e += kThreads) {
      const int ml = e / cn, ci = e - ml * cn, m = m0 + ml;
      if (m >= s.rows) continue;
      const long long edge = static_cast<long long>(m) * s.k + kk;
      const float* gr = s.g + edge * t_len;
      float acc_t = 0.f;
      for (int tt = 0; tt < t_len; ++tt) acc_t = fmaf(gr[tt], Ds[ml * (BN + 1) + ci * t_len + tt], acc_t);
      dgath[edge * s.c + c0 + ci] = acc_t;
    }
    for (int e = tid; e < BM * t_len; e += kThreads) {
      const int ml = e / t_len, tt = e - ml * t_len, m = m0 + ml;
      if (m >= s.rows) continue;
      const float* row = neighbour(s, m, kk);
      float acc_c = c0 == 0 ? 0.f : Gs[e];
      for (int ci = 0; ci < cn; ++ci) {
        const float f = row == nullptr ? __int_as_float(0x7fc00000) : row[c0 + ci];
        acc_c = fmaf(f, Ds[ml * (BN + 1) + ci * t_len + tt], acc_c);
      }
      Gs[e] = acc_c;
    }
    __syncthreads();
  }
  for (int e = tid; e < BM * t_len; e += kThreads) {
    const int ml = e / t_len, tt = e - ml * t_len, m = m0 + ml;
    if (m < s.rows) dg[(static_cast<long long>(m) * s.k + kk) * t_len + tt] = Gs[e];
  }
}

// Weight backward: the partial dW tile [BM rows of r, BN columns of o]
// over the rows of slice blockIdx.z.  A = p is staged with r fastest (a
// thread keeps one r, split once), B = dout with o fastest.
template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kThreads, 2)
    spider_bwd_weight_kernel(Spider s, const float* __restrict__ dout, int o_len, int slice_rows,
                             float* __restrict__ part) {
  static_assert((BM / TM) * (BN / TN) == kThreads, "one output micro-tile per thread");
  static_assert(kThreads % BM == 0, "a thread stages one r");
  constexpr int kA = BM * kBK / kThreads, kB = BN * kBK / kThreads, kStepA = kThreads / BM;
  __shared__ __align__(16) float As[kBK * (BM + kPad)];
  __shared__ __align__(16) float Bs[kBK * (BN + kPad)];
  const int tid = threadIdx.x, tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int r0 = blockIdx.x * BM, o0 = blockIdx.y * BN;
  const long long first = static_cast<long long>(blockIdx.z) * slice_rows;
  const int m_begin = static_cast<int>(first < s.rows ? first : s.rows);
  const int m_end = static_cast<int>(first + slice_rows < s.rows ? first + slice_rows : s.rows);
  const int rl = tid % BM, qa = tid / BM, r = r0 + rl;
  int kk = 0, cc = 0, tt = 0;
  if (r < s.r_len) split_r(s, r, kk, cc, tt);
  float ra[kA], rb[kB], acc[TM][TN] = {};

  auto fetch = [&](int m_start) {
#pragma unroll
    for (int i = 0; i < kA; ++i) {
      const int m = m_start + qa + i * kStepA;
      ra[i] = (r < s.r_len && m < m_end) ? taylor_product(s, m, kk, cc, tt) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      const int e = tid + i * kThreads, o = o0 + e % BN, m = m_start + e / BN;
      rb[i] = (m < m_end && o < o_len) ? dout[static_cast<long long>(m) * o_len + o] : 0.f;
    }
  };

  fetch(m_begin);
  for (int m_start = m_begin; m_start < m_end; m_start += kBK) {
#pragma unroll
    for (int i = 0; i < kA; ++i) As[(qa + i * kStepA) * (BM + kPad) + rl] = ra[i];
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      const int e = tid + i * kThreads;
      Bs[(e / BN) * (BN + kPad) + e % BN] = rb[i];
    }
    __syncthreads();
    if (m_start + kBK < m_end) fetch(m_start + kBK);
    multiply_chunk<BM, BN, TM, TN>(As, Bs, tx, ty, acc);
    __syncthreads();
  }
  float* tile = part + static_cast<long long>(blockIdx.z) * s.r_len * o_len;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int rr = r0 + ty * TM + i;
    if (rr >= s.r_len) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int o = o0 + tx * TN + j;
      if (o < o_len) tile[static_cast<long long>(rr) * o_len + o] = acc[i][j];
    }
  }
}

// dW[i] = part[0][i] + part[1][i] + ..., in slice order.
__global__ void __launch_bounds__(kThreads)
    sum_slices_kernel(const float* __restrict__ part, int slices, long long len, float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < len; i += stride) {
    float acc = part[i];
    for (int z = 1; z < slices; ++z) acc = __fadd_rn(acc, part[z * len + i]);
    out[i] = acc;
  }
}

int ceil_div(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

// The shapes every entry point takes: rows = B * N and K * C * T must fit in
// an int, and T must fit in the data backward's column tile.
bool make_spider(const void* feat, const void* idx, const void* g, int b, int n, int k, int c, int t,
                 Spider& s) {
  if (b < 1 || n < 1 || k < 1 || c < 1 || t < 1 || t > kMaxT) return false;
  const long long rows = static_cast<long long>(b) * n, r_len = static_cast<long long>(k) * c * t;
  if (rows > INT_MAX || r_len > INT_MAX) return false;
  s = {static_cast<const float*>(feat), static_cast<const int32_t*>(idx), static_cast<const float*>(g),
       static_cast<int>(rows), n, k, c, t, static_cast<int>(r_len),
       make_div(n), make_div(static_cast<unsigned>(c * t)), make_div(t)};
  return true;
}

// The forward and the weight backward tile: 128 x 64 (8 x 4 a thread) when
// O >= 64, else 64 x 32 (4 x 2 a thread).
bool wide(int o) { return o >= 64; }

}  // namespace

// feat [b, n, c] f32, idx [b, n, k] int32 in [0, n), g [b, n, k, t] f32,
// w [k * c * t, o] f32, all contiguous -> out [b, n, o] f32.
extern "C" int spider_fwd_launch(const void* feat, const void* idx, const void* g, const void* w, int b,
                                 int n, int k, int c, int t, int o, void* out, void* stream) {
  Spider s;
  if (!make_spider(feat, idx, g, b, n, k, c, t, s) || o < 1) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto* wp = static_cast<const float*>(w);
  auto* op = static_cast<float*>(out);
  if (wide(o)) {
    const dim3 grid(ceil_div(s.rows, 128), ceil_div(o, 64));
    spider_fwd_kernel<128, 64, 8, 4><<<grid, kThreads, 0, st>>>(s, wp, o, op);
  } else {
    const dim3 grid(ceil_div(s.rows, 64), ceil_div(o, 32));
    spider_fwd_kernel<64, 32, 4, 2><<<grid, kThreads, 0, st>>>(s, wp, o, op);
  }
  return cudaGetLastError();
}

// The data backward: the forward's inputs and dout [b, n, o] f32 ->
// dgath [b, n, k, c] and dg [b, n, k, t] f32.
extern "C" int spider_bwd_data_launch(const void* feat, const void* idx, const void* g, const void* w,
                                      const void* dout, int b, int n, int k, int c, int t, int o, void* dgath,
                                      void* dg, void* stream) {
  Spider s;
  if (!make_spider(feat, idx, g, b, n, k, c, t, s) || o < 1 || k > 65535) return cudaErrorInvalidValue;
  const dim3 grid(ceil_div(s.rows, kDataBM), k);
  spider_bwd_data_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      s, static_cast<const float*>(w), static_cast<const float*>(dout), o, kDataBN / t,
      static_cast<float*>(dgath), static_cast<float*>(dg));
  return cudaGetLastError();
}

// The number of row slices of the weight backward at these shapes: enough
// blocks for eight waves of two per SM of an H100 (132 SMs), so the last
// wave's tail is short, in slices of at least 256 rows.
extern "C" int spider_bwd_weight_slices(int rows, int r_len, int o) {
  if (rows < 1 || r_len < 1 || o < 1) return 1;
  const long long tiles = wide(o) ? static_cast<long long>(ceil_div(r_len, 128)) * ceil_div(o, 64)
                                  : static_cast<long long>(ceil_div(r_len, 64)) * ceil_div(o, 32);
  const long long want = (8 * 2 * 132 + tiles - 1) / tiles, most = rows / 256 > 1 ? rows / 256 : 1;
  return static_cast<int>(want < most ? want : most);
}

// The weight backward: feat, idx, g and dout -> dw [k * c * t, o] f32.
// With slices > 1 (spider_bwd_weight_slices), part [slices, k * c * t, o]
// f32 is scratch for the partial tiles; with slices == 1 part may be dw.
extern "C" int spider_bwd_weight_launch(const void* feat, const void* idx, const void* g, const void* dout,
                                        int b, int n, int k, int c, int t, int o, int slices, void* part,
                                        void* dw, void* stream) {
  Spider s;
  if (!make_spider(feat, idx, g, b, n, k, c, t, s) || o < 1 || slices < 1 || slices > 65535) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto* dp = static_cast<const float*>(dout);
  float* target = slices == 1 ? static_cast<float*>(dw) : static_cast<float*>(part);
  const int slice_rows = ceil_div(ceil_div(s.rows, slices), kBK) * kBK;
  if (wide(o)) {
    const dim3 grid(ceil_div(s.r_len, 128), ceil_div(o, 64), slices);
    spider_bwd_weight_kernel<128, 64, 8, 4><<<grid, kThreads, 0, st>>>(s, dp, o, slice_rows, target);
  } else {
    const dim3 grid(ceil_div(s.r_len, 64), ceil_div(o, 32), slices);
    spider_bwd_weight_kernel<64, 32, 4, 2><<<grid, kThreads, 0, st>>>(s, dp, o, slice_rows, target);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return err;
  const long long len = static_cast<long long>(s.r_len) * o;
  const long long blocks = (len + kThreads - 1) / kThreads;
  sum_slices_kernel<<<static_cast<int>(blocks < 132 * 16 ? blocks : 132 * 16), kThreads, 0, st>>>(
      target, slices, len, static_cast<float*>(dw));
  return cudaGetLastError();
}
