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
// output and stages both operands of a chunk of the reduction in shared
// memory.  The forward walks the reduction slot by slot with a cp.async
// ring (below); the backward kernels walk it in chunks of kBK, fetching the
// next chunk into registers while the current one is multiplied.  The
// Taylor product is formed as it is staged: a gather is a load, one cloud's
// rows (at most 1024 x 128 floats) sit in L2, and the [M, K*C*T] operand
// never exists in device memory.  Each p is rounded once (__fmul_rn), as
// the plain version's outer product rounds it; the sums use FMA.  Nothing
// runs in TF32.
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
// ms.  The forward runs an 8 x 8 outer product per thread per staged value
// (128 x 128 tiles), the backward kernels 4x2 to 8x4, two 256-thread blocks
// per SM.

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

// ---------------------------------------------------------------------------
// Forward: out[m, o] = sum_r p[m, r] W[r, o], staged slot by slot.
//
// The reduction is walked chunk by chunk, a chunk being one slot k and a
// group of cb channels [c0, c0 + cb): its indices (c, t) are consecutive, so
// its W rows are one contiguous [cb * T, O] slab.  Once per call,
// spider_fwd_pack_kernel copies each slab, cut into tiles of BN columns and
// padded with zeros to kc rows (cb * T rounded up to 8) and to whole tiles,
// into a scratch buffer.  Per chunk, the block copies with cp.async into one
// stage of a ring: the slab's tile, each row's cb channels of its
// neighbour's feat row (the index read once per row and slot) and the row's
// T values of g; the next chunk is in flight while the current one is
// multiplied.  The [kc, BM] tile of p is formed in shared memory from the
// staged feat and g, each p rounded once (__fmul_rn).  Each thread then
// adds its TM x TN outputs' products with FMA, r ascending: every output is
// the chain fmaf(p, w, acc) from 0 (padding adds exact zeros), and on an
// H100 it agrees bit for bit with cuBLAS's f32 product at SpiderCNN's
// conv1-3.
//
// Why not the tensor cores: a 3xTF32 version of this kernel
// (studies/spider_tf32.cu: mma.sync m16n8k8, both operands split into hi
// and lo TF32 terms, each k-step's three products added to the f32 sum)
// holds the per-call gate and runs conv1-4 1.39x faster, but its last
// bits differ from cuBLAS's f32 sums: in the SpiderCNN training step at
// B=32 they flip relu gates and move the gradients beyond the step's gate
// of 1e-4 of their scale against the plain path (studies/spider_tf32.py,
// PERF.md §6).
constexpr int kFwdBM = 128;
constexpr int kFwdMaxKC = 64;  // a chunk holds at most 64 reduction indices (T <= kMaxT)

constexpr int kFwdStages = 2;  // of the cp.async ring (three read slower at conv4 on an H100)

struct FwdPlan {
  int cb, groups, kc, bn, op, fs;  // fs: staged feat row stride (odd)
  int smem;                        // dynamic shared memory, bytes
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most kFwdStages - 2 committed groups are in flight.
__device__ __forceinline__ void cp_async_wait_ring() {
  static_assert(kFwdStages == 2, "one group in flight at most: wait for all");
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// W [K * C * T, O] -> wp [chunks][op / BN][kc][BN]: chunk (kk, grp)'s W rows
// (kk * C + grp * cb) * T + q, one tile of BN columns after another; zeros
// past the chunk's cb * T rows and past O.
template <int BN>
__global__ void __launch_bounds__(kThreads)
    spider_fwd_pack_kernel(const float* __restrict__ w, int c, int t, int o, FwdPlan p, long long len,
                           float* __restrict__ wp) {
  const int o_tiles = p.op / BN;
  for (long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; e < len;
       e += static_cast<long long>(gridDim.x) * kThreads) {
    const int col = static_cast<int>(e % BN);
    long long rest = e / BN;
    const int q = static_cast<int>(rest % p.kc);
    rest /= p.kc;
    const int ob = static_cast<int>(rest % o_tiles);
    const long long chunk = rest / o_tiles;
    const int kk = static_cast<int>(chunk / p.groups), grp = static_cast<int>(chunk % p.groups);
    const int c0 = grp * p.cb, valid = min(p.cb, c - c0) * t, o_col = ob * BN + col;
    wp[e] = q < valid && o_col < o ? w[((static_cast<long long>(kk) * c + c0) * t + q) * o + o_col] : 0.f;
  }
}

// One BM x BN output tile; each of the 256 threads owns TM x TN outputs:
// rows ty * TM / 2 + [0, TM / 2) and the same BM / 2 further, columns
// likewise in halves of BN.
template <int BN, int TM, int TN>
__global__ void __launch_bounds__(kThreads, 2)
    spider_fwd_kernel(Spider s, const float* __restrict__ wp, FwdPlan p, int o_len, float* __restrict__ out) {
  constexpr int BM = kFwdBM, SA = BM + 4, kHalves = kThreads / BM;
  static_assert((BM / TM) * (BN / TN) == kThreads, "one output micro-tile per thread");
  extern __shared__ __align__(16) float smem[];
  const int kc = p.kc, t_len = s.t;
  float* const As = smem;          // [kc][SA]: the chunk's p
  float* const ring = As + kc * SA;
  // A stage: the W tile [kc][BN], then the staged feat [BM][fs] and g [BM][T].
  const int stage_floats = kc * BN + BM * p.fs + BM * t_len;
  const int tid = threadIdx.x, tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = blockIdx.x * BM;
  const int nchunks = s.k * p.groups;

  // Staging: thread tid copies row lr's feat and g values, every other one.
  const int lr = tid % BM, half = tid / BM;
  const int m_load = m0 + lr;
  const bool row_ok = m_load < s.rows;
  const long long cloud = row_ok ? static_cast<long long>(m_load / s.n) * s.n : 0;
  int cached_k = -1, cached_j = 0;

  auto issue = [&](int chunk, int stage) {
    float* bs = ring + stage * stage_floats;
    float* frow = bs + kc * BN + lr * p.fs;
    float* grow = bs + kc * BN + BM * p.fs + lr * t_len;
    const float* src = wp + (static_cast<long long>(chunk) * gridDim.y + blockIdx.y) * kc * BN;
    for (int e = 4 * tid; e < kc * BN; e += 4 * kThreads) cp_async16(bs + e, src + e);
    const int kk = chunk / p.groups, c0 = (chunk - kk * p.groups) * p.cb, cbe = min(p.cb, s.c - c0);
    if (!row_ok) {
      for (int q = half; q < cbe; q += kHalves) frow[q] = 0.f;
      for (int q = half; q < t_len; q += kHalves) grow[q] = 0.f;
      return;
    }
    if (kk != cached_k) {
      cached_k = kk;
      cached_j = s.idx[static_cast<long long>(m_load) * s.k + kk];
    }
    if (static_cast<unsigned>(cached_j) >= static_cast<unsigned>(s.n)) {
      for (int q = half; q < cbe; q += kHalves) frow[q] = __int_as_float(0x7fc00000);
    } else {
      const float* fsrc = s.feat + (cloud + cached_j) * s.c + c0;
      for (int q = half; q < cbe; q += kHalves) cp_async4(frow + q, fsrc + q);
    }
    const float* gsrc = s.g + (static_cast<long long>(m_load) * s.k + kk) * t_len;
    for (int q = half; q < t_len; q += kHalves) cp_async4(grow + q, gsrc + q);
  };

  // Forming p: thread tid forms row lr's columns of every kHalves-th
  // channel, neighbouring threads on neighbouring rows; zeros past them.
  auto form = [&](int chunk, int stage) {
    const float* frow = ring + stage * stage_floats + kc * BN + lr * p.fs;
    const float* grow = ring + stage * stage_floats + kc * BN + BM * p.fs + lr * t_len;
    const int kk = chunk / p.groups, cbe = min(p.cb, s.c - (chunk - kk * p.groups) * p.cb);
    for (int cc = half; cc < cbe; cc += kHalves) {
      const float f = frow[cc];
      float* dst = As + cc * t_len * SA + lr;
      for (int tt = 0; tt < t_len; ++tt) dst[tt * SA] = __fmul_rn(f, grow[tt]);
    }
    for (int q = cbe * t_len + half; q < kc; q += kHalves) As[q * SA + lr] = 0.f;
  };

  float acc[TM][TN] = {};
  auto multiply = [&](int stage) {
    const float* bs = ring + stage * stage_floats;
#pragma unroll 4
    for (int q = 0; q < kc; ++q) {
      float a[2][TM / 2], b[2][TN / 2];
      load_smem<TM / 2>(As + q * SA + ty * (TM / 2), a[0]);
      load_smem<TM / 2>(As + q * SA + BM / 2 + ty * (TM / 2), a[1]);
      load_smem<TN / 2>(bs + q * BN + tx * (TN / 2), b[0]);
      load_smem<TN / 2>(bs + q * BN + BN / 2 + tx * (TN / 2), b[1]);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc[i][j] = fmaf(a[i / (TM / 2)][i % (TM / 2)], b[j / (TN / 2)][j % (TN / 2)], acc[i][j]);
        }
      }
    }
  };

  for (int c = 0; c < kFwdStages - 1; ++c) {
    if (c < nchunks) issue(c, c);
    cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait_ring();
    __syncthreads();  // chunk c landed; every thread is done with chunk c - 1
    if (c + kFwdStages - 1 < nchunks) issue(c + kFwdStages - 1, (c + kFwdStages - 1) % kFwdStages);
    cp_async_commit();
    form(c, c % kFwdStages);
    __syncthreads();
    multiply(c % kFwdStages);
  }

  const int o0 = blockIdx.y * BN;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + (i < TM / 2 ? 0 : BM / 2 - TM / 2) + ty * (TM / 2) + i;
    if (m >= s.rows) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int o = o0 + (j < TN / 2 ? 0 : BN / 2 - TN / 2) + tx * (TN / 2) + j;
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

// The weight backward tile: 128 x 64 (8 x 4 a thread) when O >= 64, else
// 64 x 32 (4 x 2 a thread).
bool wide(int o) { return o >= 64; }

// The forward's chunking and tiles at these shapes.  cb, the channels of a
// chunk, minimises the padded reduction depth ceil(C / cb) * kc, kc = cb * T
// rounded up to 8 and at most 64 (ties to the larger cb: fewer chunks).  The
// tile is 128 x 128 when O > 64, 128 x 64 when O > 32, else 128 x 32.  At
// SpiderCNN's shapes (T = 5) two blocks share an SM; a wide T takes one.
FwdPlan plan_fwd(int c, int t, int o) {
  FwdPlan p{};
  long long best = -1;
  for (int cb = 1; cb <= c && cb * t <= kFwdMaxKC; ++cb) {
    const int kc = (cb * t + 7) / 8 * 8;
    const long long cost = static_cast<long long>((c + cb - 1) / cb) * kc;
    if (best < 0 || cost <= best) {
      best = cost;
      p.cb = cb;
      p.kc = kc;
    }
  }
  p.groups = (c + p.cb - 1) / p.cb;
  p.bn = o > 64 ? 128 : o > 32 ? 64 : 32;
  p.op = ceil_div(o, p.bn) * p.bn;
  p.fs = p.cb | 1;  // odd: rows on different banks as the p tile is formed
  const int a_bytes = 4 * p.kc * (kFwdBM + 4);
  const int stage_bytes = 4 * (p.kc * p.bn + kFwdBM * p.fs + kFwdBM * t);
  p.smem = a_bytes + kFwdStages * stage_bytes;
  return p;
}

// Packs W into the scratch (spider_fwd_pack_kernel), then runs the product.
template <int BN, int TM, int TN>
cudaError_t launch_fwd(const Spider& s, const float* w, const FwdPlan& p, int c, int t, int o, float* wp,
                       float* out, cudaStream_t st) {
  const long long len = static_cast<long long>(s.k) * p.groups * p.kc * p.op;
  const long long blocks = (len + kThreads - 1) / kThreads;
  spider_fwd_pack_kernel<BN><<<static_cast<int>(blocks < 132 * 16 ? blocks : 132 * 16), kThreads, 0, st>>>(
      w, c, t, o, p, len, wp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kernel = spider_fwd_kernel<BN, TM, TN>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(ceil_div(s.rows, kFwdBM), ceil_div(o, BN));
  kernel<<<grid, kThreads, p.smem, st>>>(s, wp, p, o, out);
  return cudaGetLastError();
}

}  // namespace

// Floats of the forward's scratch (the packed W) at these shapes, or -1
// where the forward does not take them.
extern "C" long long spider_fwd_scratch(int k, int c, int t, int o) {
  if (k < 1 || c < 1 || t < 1 || t > kMaxT || o < 1) return -1;
  const FwdPlan p = plan_fwd(c, t, o);
  return static_cast<long long>(k) * p.groups * p.kc * p.op;
}

// feat [b, n, c] f32, idx [b, n, k] int32 in [0, n), g [b, n, k, t] f32,
// w [k * c * t, o] f32, all contiguous, scratch of spider_fwd_scratch floats
// -> out [b, n, o] f32.  Packs W into the scratch, then runs the product.
extern "C" int spider_fwd_launch(const void* feat, const void* idx, const void* g, const void* w, int b,
                                 int n, int k, int c, int t, int o, void* scratch, void* out, void* stream) {
  Spider s;
  if (!make_spider(feat, idx, g, b, n, k, c, t, s) || o < 1) return cudaErrorInvalidValue;
  const FwdPlan p = plan_fwd(c, t, o);
  if (ceil_div(o, p.bn) > 65535) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto* wf = static_cast<const float*>(w);
  auto* wp = static_cast<float*>(scratch);
  auto* op = static_cast<float*>(out);
  if (p.bn == 128) return launch_fwd<128, 8, 8>(s, wf, p, c, t, o, wp, op, st);
  if (p.bn == 64) return launch_fwd<64, 8, 4>(s, wf, p, c, t, o, wp, op, st);
  return launch_fwd<32, 4, 4>(s, wf, p, c, t, o, wp, op, st);
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
