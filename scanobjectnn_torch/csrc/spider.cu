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
// memory.  All three walk the reduction with a two-stage cp.async ring
// (below): the forward slot by slot over W packed once per call, the data
// backward over dout transposed and W^T packed once per call, the weight
// backward over row stages, forming p from each row's staged neighbour and
// basis values.  The Taylor product is formed as it is staged: a gather is a load, one cloud's
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
// ms.  Each runs up to an 8 x 8 outer product per thread per staged value
// (128 x 128 tiles), two 256-thread blocks per SM.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
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

// ---------------------------------------------------------------------------
// Backward, staged as the forward: both products walk their reduction in
// stages with a two-stage cp.async ring, 128-wide tiles and up to 8 x 8
// outputs a thread (multiply_halves, the forward's layout), f32 FMA.
//
// Chunks: one slot kk and cb channels, their cb * T reduction indices
// padded to `width` (32, 64 or 128) columns; plan_bwd picks width and cb.
//
// Data backward (a block owns 128 rows and one slot kk; it walks the slot's
// channel groups in order): D = dout W^T with o as the reduction, kBwdBK o
// a stage.  Both operands are staged with cp.async: dout transposed once
// per call into doutT [op][mp] (spider_transpose_kernel) and W^T packed
// once per call into per-chunk slabs wpt [chunk][op][width]
// (spider_bwd_pack_kernel), zeros past O, past the rows and past the
// chunk's columns.  Each D sums its products with FMA in ascending o from
// 0, as before the staging, so the data backward's bits are unchanged.
// Per group the tile goes to shared memory; dgath sums over t and dg's
// running sums over c (carried across groups) run in ascending order, one
// thread each, on the rows' basis values and the group's neighbour
// features, copied into shared memory with the ring (each row's neighbour
// index read once).
//
// Weight backward (a block owns one chunk's width x BN tile of dW over the
// rows of slice blockIdx.z): dW = p^T dout with the rows m as the
// reduction.  Per stage of kWeightBK rows the ring copies each row's dout
// columns, its neighbour's cb feature values (the index read once per row
// and slot) and its T basis values; the [kWeightBK, width] tile of p is
// formed in shared memory, each p rounded once (__fmul_rn).
constexpr int kBwdBK = 16;     // o values a stage of the data backward
constexpr int kWeightBK = 32;  // rows a stage of the weight backward
constexpr int kDataBM = 128;   // rows of a data-backward tile

struct BwdPlan {
  int cb, groups, width;  // channels of a chunk, chunks a slot, padded columns of a chunk
  int op, mp;             // O rounded up to kBwdBK, B * N rounded up to kDataBM
  int bn;                 // the weight backward's tile of o
};

// acc[TM][TN] += As[q][rows] x Bs[q][cols] for q < BK.  The thread owns
// rows ty * (TM / 2) + [0, TM / 2) and BM / 2 further, and columns likewise
// in halves of BN (the forward's layout: float4 reads, no bank conflicts).
template <int BK, int BM, int BN, int TM, int TN>
__device__ __forceinline__ void multiply_halves(const float* As, int sa, const float* Bs, int sb, int tx, int ty,
                                                float (&acc)[TM][TN]) {
#pragma unroll 4
  for (int q = 0; q < BK; ++q) {
    float a[2][TM / 2], b[2][TN / 2];
    load_smem<TM / 2>(As + q * sa + ty * (TM / 2), a[0]);
    load_smem<TM / 2>(As + q * sa + BM / 2 + ty * (TM / 2), a[1]);
    load_smem<TN / 2>(Bs + q * sb + tx * (TN / 2), b[0]);
    load_smem<TN / 2>(Bs + q * sb + BN / 2 + tx * (TN / 2), b[1]);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        acc[i][j] = fmaf(a[i / (TM / 2)][i % (TM / 2)], b[j / (TN / 2)][j % (TN / 2)], acc[i][j]);
      }
    }
  }
}

// Row (or column) of element i of a thread's half-split micro-tile.
template <int B, int T>
__device__ __forceinline__ int half_index(int t, int i) {
  return (i < T / 2 ? 0 : B / 2 - T / 2) + t * (T / 2) + i;
}

// W [K * C * T, O] -> wpt [chunk][op][width]: chunk (kk, grp)'s W rows
// (kk * C + grp * cb) * T + col, transposed; zeros past O and the chunk.
__global__ void __launch_bounds__(kThreads)
    spider_bwd_pack_kernel(const float* __restrict__ w, int c, int t, int o, BwdPlan p, long long len,
                           float* __restrict__ wpt) {
  for (long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; e < len;
       e += static_cast<long long>(gridDim.x) * kThreads) {
    const int col = static_cast<int>(e % p.width);
    const long long rest = e / p.width;
    const int q = static_cast<int>(rest % p.op);
    const long long chunk = rest / p.op;
    const int kk = static_cast<int>(chunk / p.groups), grp = static_cast<int>(chunk % p.groups);
    const int c0 = grp * p.cb, valid = min(p.cb, c - c0) * t;
    wpt[e] = col < valid && q < o ? w[((static_cast<long long>(kk) * c + c0) * t + col) * o + q] : 0.f;
  }
}

// dout [rows, o] -> doutT [op][mp], zeros past rows and o (32 x 32 tiles).
__global__ void __launch_bounds__(kThreads)
    spider_transpose_kernel(const float* __restrict__ dout, int rows, int o, BwdPlan p, float* __restrict__ doutt) {
  __shared__ float tile[32][33];
  const int m0 = blockIdx.x * 32, q0 = blockIdx.y * 32, lx = threadIdx.x % 32, ly = threadIdx.x / 32;
  for (int i = ly; i < 32; i += kThreads / 32) {
    const int m = m0 + i, q = q0 + lx;
    tile[i][lx] = m < rows && q < o ? dout[static_cast<long long>(m) * o + q] : 0.f;
  }
  __syncthreads();
  for (int i = ly; i < 32; i += kThreads / 32) {
    const int q = q0 + i, m = m0 + lx;
    if (q < p.op && m < p.mp) doutt[static_cast<long long>(q) * p.mp + m] = tile[lx][i];
  }
}

// The data backward's dynamic shared memory, bytes: the ring, the group's
// D [BM][cb * T + 1] (its valid columns only, so that two blocks share an
// SM at SpiderCNN's conv4), dg's running sums [BM][T], the rows' basis
// values [BM][T], the group's neighbour features [BM][cb | 1] and the
// neighbour points [BM].
int data_smem(int bn, int t, int cb) {
  return 4 * (2 * kBwdBK * (kDataBM + 4 + bn + 4) + kDataBM * (cb * t + 1 + 2 * t + (cb | 1) + 1));
}

template <int BN, int TN>
__global__ void __launch_bounds__(kThreads, 2)
    spider_bwd_data_kernel(Spider s, const float* __restrict__ wpt, const float* __restrict__ doutt, BwdPlan p,
                           float* __restrict__ dgath, float* __restrict__ dg) {
  constexpr int BM = kDataBM, TM = 8, SA = BM + 4, SB = BN + 4, BK = kBwdBK, kStage = BK * (SA + SB);
  static_assert((BM / TM) * (BN / TN) == kThreads, "one output micro-tile per thread");
  extern __shared__ __align__(16) float smem[];
  float* const ring = smem;                  // two stages: dout^T [BK][SA], then W^T [BK][SB]
  const int ds = p.cb * s.t + 1;             // D's row stride: the chunk's valid columns, + 1
  float* const Ds = ring + 2 * kStage;       // [BM][ds]: the group's D tile
  float* const Gs = Ds + BM * ds;            // [BM][T]: dg's running sums over c
  float* const Gv = Gs + BM * s.t;           // [BM][T]: g of each row and slot kk
  const int fs = p.cb | 1;
  float* const Fs = Gv + BM * s.t;           // [BM][fs]: the group's neighbour features
  int* const nbr = reinterpret_cast<int*>(Fs + BM * fs);  // [BM]: the neighbour's point, or -1
  const int tid = threadIdx.x, tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = blockIdx.x * BM, kk = blockIdx.y, t_len = s.t;
  const int n_oc = p.op / BK, total = p.groups * n_oc;

  // Each row's neighbour index, read once (seen after the first barrier),
  // and its basis values (with the first stage's copies).
  for (int r = tid; r < BM; r += kThreads) {
    const int m = m0 + r;
    int point = -1;
    if (m < s.rows) {
      const int j = s.idx[static_cast<long long>(m) * s.k + kk];
      if (static_cast<unsigned>(j) < static_cast<unsigned>(s.n)) point = fast_div(s.by_n, m) * s.n + j;
    }
    nbr[r] = point;
  }
  for (int e = tid; e < BM * t_len; e += kThreads) {
    const int ml = e / t_len, m = m0 + ml;
    if (m < s.rows) {
      cp_async4(Gv + e, s.g + (static_cast<long long>(m) * s.k + kk) * t_len + (e - ml * t_len));
    } else {
      Gv[e] = 0.f;
    }
  }
  // The neighbour features of group grp, channels [c0, c0 + cn) (NaN for a
  // bad index); read by the group's epilogue.
  auto issue_feat = [&](int grp) {
    const int c0 = grp * p.cb, cn = min(p.cb, s.c - c0);
    for (int e = tid; e < BM * cn; e += kThreads) {
      const int ml = e / cn, ci = e - ml * cn, point = nbr[ml];
      if (point >= 0) {
        cp_async4(Fs + ml * fs + ci, s.feat + static_cast<long long>(point) * s.c + c0 + ci);
      } else {
        Fs[ml * fs + ci] = __int_as_float(0x7fc00000);
      }
    }
  };

  auto issue = [&](int step, int stage) {
    const int grp = step / n_oc, oc = step - grp * n_oc;
    float* as = ring + stage * kStage;
    float* bs = as + BK * SA;
    const float* asrc = doutt + static_cast<long long>(oc * BK) * p.mp + m0;
    for (int e = tid; e < BK * (BM / 4); e += kThreads) {
      const int q = e / (BM / 4), v = e - q * (BM / 4);
      cp_async16(as + q * SA + 4 * v, asrc + static_cast<long long>(q) * p.mp + 4 * v);
    }
    const float* bsrc = wpt + (static_cast<long long>(kk * p.groups + grp) * p.op + oc * BK) * BN;
    for (int e = tid; e < BK * (BN / 4); e += kThreads) {
      const int q = e / (BN / 4), v = e - q * (BN / 4);
      cp_async16(bs + q * SB + 4 * v, bsrc + q * BN + 4 * v);
    }
  };

  float acc[TM][TN];
  issue(0, 0);
  cp_async_commit();
  for (int step = 0; step < total; ++step) {
    const int grp = step / n_oc, oc = step - grp * n_oc;
    if (oc == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    }
    cp_async_wait_ring();
    __syncthreads();  // stage step landed; every thread is done with step - 1
    if (oc == 0) issue_feat(grp);  // Fs is free: the last group's epilogue is done
    if (step + 1 < total) issue(step + 1, (step + 1) & 1);
    cp_async_commit();
    const float* as = ring + (step & 1) * kStage;
    multiply_halves<BK, BM, BN, TM, TN>(as, SA, as + BK * SA, SB, tx, ty, acc);
    if (oc + 1 < n_oc) continue;

    // The group's D is complete: dgath over t, dg's running sums over c.
    cp_async_wait_ring();  // the group's features
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = half_index<BN, TN>(tx, j);
        if (col < ds - 1) Ds[half_index<BM, TM>(ty, i) * ds + col] = acc[i][j];
      }
    __syncthreads();
    const int c0 = grp * p.cb, cn = min(p.cb, s.c - c0);
    for (int e = tid; e < BM * cn; e += kThreads) {
      const int ml = e / cn, ci = e - ml * cn, m = m0 + ml;
      if (m >= s.rows) continue;
      const long long edge = static_cast<long long>(m) * s.k + kk;
      const float* gr = Gv + ml * t_len;
      float acc_t = 0.f;
      for (int tt = 0; tt < t_len; ++tt) acc_t = fmaf(gr[tt], Ds[ml * ds + ci * t_len + tt], acc_t);
      dgath[edge * s.c + c0 + ci] = acc_t;
    }
    for (int e = tid; e < BM * t_len; e += kThreads) {
      const int ml = e / t_len, tt = e - ml * t_len, m = m0 + ml;
      if (m >= s.rows) continue;
      const float* row = Fs + ml * fs;
      float acc_c = c0 == 0 ? 0.f : Gs[e];
      for (int ci = 0; ci < cn; ++ci) acc_c = fmaf(row[ci], Ds[ml * ds + ci * t_len + tt], acc_c);
      Gs[e] = acc_c;
    }
    __syncthreads();  // Ds and Gs are free
  }
  for (int e = tid; e < BM * t_len; e += kThreads) {
    const int ml = e / t_len, tt = e - ml * t_len, m = m0 + ml;
    if (m < s.rows) dg[(static_cast<long long>(m) * s.k + kk) * t_len + tt] = Gs[e];
  }
}

// Floats of one stage of the weight backward's ring: dout [BK][BN + 4],
// feat [BK][cb | 1], g [BK][T], rounded up to 4 (16-byte stages).
__host__ __device__ __forceinline__ int weight_stage_floats(int bn, int cb, int t) {
  return (kWeightBK * (bn + 4 + (cb | 1) + t) + 3) / 4 * 4;
}

template <int BM, int BN>
__global__ void __launch_bounds__(kThreads, 2)
    spider_bwd_weight_kernel(Spider s, const float* __restrict__ dout, int o_len, BwdPlan p, int slice_rows,
                             float* __restrict__ part) {
  constexpr int BK = kWeightBK, TM = BM / 16, TN = BN / 16, SA = BM + 4, SB = BN + 4;
  constexpr int kSub = kThreads / BK;  // threads a staged row
  extern __shared__ __align__(16) float smem[];
  const int fs = p.cb | 1, t_len = s.t, stage_floats = weight_stage_floats(BN, p.cb, t_len);
  float* const As = smem;  // [BK][SA]: the stage's p
  float* const ring = As + BK * SA;
  const int tid = threadIdx.x, tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int kk = blockIdx.x / p.groups, c0 = (blockIdx.x - kk * p.groups) * p.cb;
  const int cbe = min(p.cb, s.c - c0), valid = cbe * t_len;
  const int o0 = blockIdx.y * BN;
  const long long first = static_cast<long long>(blockIdx.z) * slice_rows;
  const int m_begin = static_cast<int>(first < s.rows ? first : s.rows);
  const int m_end = static_cast<int>(first + slice_rows < s.rows ? first + slice_rows : s.rows);
  const int lr = tid % BK, sub = tid / BK;
  const bool vec = o_len % 4 == 0;

  auto issue = [&](int m_start, int stage) {
    float* bs = ring + stage * stage_floats;
    float* brow = bs + lr * SB;
    float* frow = bs + BK * SB + lr * fs;
    float* grow = bs + BK * SB + BK * fs + lr * t_len;
    const int m = m_start + lr;
    const bool ok = m < m_end;
    const float* dsrc = dout + static_cast<long long>(m) * o_len + o0;
    if (vec) {
      for (int v = sub; v < BN / 4; v += kSub) {
        if (ok && o0 + 4 * v < o_len) {
          cp_async16(brow + 4 * v, dsrc + 4 * v);
        } else {
          brow[4 * v] = brow[4 * v + 1] = brow[4 * v + 2] = brow[4 * v + 3] = 0.f;
        }
      }
    } else {
      for (int v = sub; v < BN; v += kSub) {
        if (ok && o0 + v < o_len) {
          cp_async4(brow + v, dsrc + v);
        } else {
          brow[v] = 0.f;
        }
      }
    }
    if (!ok) {
      for (int q = sub; q < cbe; q += kSub) frow[q] = 0.f;
      for (int q = sub; q < t_len; q += kSub) grow[q] = 0.f;
      return;
    }
    const int j = s.idx[static_cast<long long>(m) * s.k + kk];
    if (static_cast<unsigned>(j) >= static_cast<unsigned>(s.n)) {
      for (int q = sub; q < cbe; q += kSub) frow[q] = __int_as_float(0x7fc00000);
    } else {
      const float* fsrc = s.feat + (static_cast<long long>(fast_div(s.by_n, m)) * s.n + j) * s.c + c0;
      for (int q = sub; q < cbe; q += kSub) cp_async4(frow + q, fsrc + q);
    }
    const float* gsrc = s.g + (static_cast<long long>(m) * s.k + kk) * t_len;
    for (int q = sub; q < t_len; q += kSub) cp_async4(grow + q, gsrc + q);
  };

  // Row lr of the stage's p: channels sub, sub + kSub, ..., zeros past them.
  auto form = [&](int stage) {
    const float* frow = ring + stage * stage_floats + BK * SB + lr * fs;
    const float* grow = ring + stage * stage_floats + BK * SB + BK * fs + lr * t_len;
    float* dst = As + lr * SA;
    for (int cc = sub; cc < cbe; cc += kSub) {
      const float f = frow[cc];
      for (int tt = 0; tt < t_len; ++tt) dst[cc * t_len + tt] = __fmul_rn(f, grow[tt]);
    }
    for (int q = valid + sub; q < BM; q += kSub) dst[q] = 0.f;
  };

  float acc[TM][TN] = {};
  const int nsteps = (m_end - m_begin + BK - 1) / BK;
  if (nsteps > 0) issue(m_begin, 0);
  cp_async_commit();
  for (int c = 0; c < nsteps; ++c) {
    cp_async_wait_ring();
    __syncthreads();  // stage c landed; every thread is done with As
    if (c + 1 < nsteps) issue(m_begin + (c + 1) * BK, (c + 1) & 1);
    cp_async_commit();
    form(c & 1);
    __syncthreads();
    multiply_halves<BK, BM, BN, TM, TN>(As, SA, ring + (c & 1) * stage_floats, SB, tx, ty, acc);
  }
  float* tile = part + static_cast<long long>(blockIdx.z) * s.r_len * o_len;
  const long long r0 = (static_cast<long long>(kk) * s.c + c0) * t_len;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int rl = half_index<BM, TM>(ty, i);
    if (rl >= valid) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int o = o0 + half_index<BN, TN>(tx, j);
      if (o < o_len) tile[(r0 + rl) * o_len + o] = acc[i][j];
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

// The backward's chunking at these shapes: width (32, 64 or 128 columns)
// and cb = ceil(C / groups) with groups = ceil(C / (width / T)) minimise
// groups * width, weighted by how busy a tile that narrow keeps the FMA
// units (128: 100, 64: 118, 32: 167; ties to the wider tile).  At
// SpiderCNN's T = 5: conv1 (C = 3) takes 32 columns, conv2 (C = 32) 64 (3
// groups of 11), conv3-4 128 (3 and 6 groups of 22).  The weight
// backward's o tile is 128 when O > 64, 64 when O > 32, else 32.
BwdPlan plan_bwd(int rows, int c, int t, int o) {
  BwdPlan p{};
  long long best = -1;
  const int widths[3] = {128, 64, 32}, weights[3] = {100, 118, 167};
  for (int i = 0; i < 3; ++i) {
    const int per = widths[i] / t;
    if (per < 1) continue;
    const int groups = (c + per - 1) / per;
    const long long cost = static_cast<long long>(groups) * widths[i] * weights[i];
    if (best < 0 || cost < best) {
      best = cost;
      p.width = widths[i];
      p.groups = groups;
      p.cb = (c + groups - 1) / groups;
    }
  }
  p.op = ceil_div(o, kBwdBK) * kBwdBK;
  p.mp = ceil_div(rows, kDataBM) * kDataBM;
  p.bn = o > 64 ? 128 : o > 32 ? 64 : 32;
  return p;
}

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

template <int BN>
cudaError_t launch_bwd_data(const Spider& s, const float* w, const float* dout, const BwdPlan& p, int o,
                            float* scratch, float* dgath, float* dg, cudaStream_t st) {
  float* doutt = scratch;
  float* wpt = scratch + static_cast<long long>(p.op) * p.mp;
  spider_transpose_kernel<<<dim3(p.mp / 32, ceil_div(p.op, 32)), kThreads, 0, st>>>(dout, s.rows, o, p, doutt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long len = static_cast<long long>(s.k) * p.groups * p.op * p.width;
  const long long blocks = (len + kThreads - 1) / kThreads;
  spider_bwd_pack_kernel<<<static_cast<int>(blocks < 132 * 16 ? blocks : 132 * 16), kThreads, 0, st>>>(
      w, s.c, s.t, o, p, len, wpt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kernel = spider_bwd_data_kernel<BN, BN / 16>;
  const int smem = data_smem(BN, s.t, p.cb);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.mp / kDataBM, s.k), kThreads, smem, st>>>(s, wpt, doutt, p, dgath, dg);
  return cudaGetLastError();
}

template <int BM, int BN>
cudaError_t launch_bwd_weight(const Spider& s, const float* dout, const BwdPlan& p, int o, int slices,
                              float* target, cudaStream_t st) {
  auto kernel = spider_bwd_weight_kernel<BM, BN>;
  const int smem = 4 * (kWeightBK * (BM + 4) + 2 * weight_stage_floats(BN, p.cb, s.t));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const int slice_rows = ceil_div(ceil_div(s.rows, slices), kWeightBK) * kWeightBK;
  kernel<<<dim3(s.k * p.groups, ceil_div(o, BN), slices), kThreads, smem, st>>>(s, dout, o, p, slice_rows, target);
  return cudaGetLastError();
}

template <int BM>
cudaError_t launch_bwd_weight_bm(const Spider& s, const float* dout, const BwdPlan& p, int o, int slices,
                                 float* target, cudaStream_t st) {
  if (p.bn == 128) return launch_bwd_weight<BM, 128>(s, dout, p, o, slices, target, st);
  if (p.bn == 64) return launch_bwd_weight<BM, 64>(s, dout, p, o, slices, target, st);
  return launch_bwd_weight<BM, 32>(s, dout, p, o, slices, target, st);
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

// Floats of the data backward's scratch at these shapes (dout transposed,
// then W^T packed into chunk slabs), or -1 where it does not take them.
extern "C" long long spider_bwd_data_scratch(int b, int n, int k, int c, int t, int o) {
  if (b < 1 || n < 1 || k < 1 || c < 1 || t < 1 || t > kMaxT || o < 1) return -1;
  const BwdPlan p = plan_bwd(b * n, c, t, o);
  return static_cast<long long>(p.op) * p.mp + static_cast<long long>(k) * p.groups * p.op * p.width;
}

// The data backward: the forward's inputs, dout [b, n, o] f32 and scratch of
// spider_bwd_data_scratch floats -> dgath [b, n, k, c] and dg [b, n, k, t]
// f32.  Transposes dout and packs W into the scratch, then runs the product.
extern "C" int spider_bwd_data_launch(const void* feat, const void* idx, const void* g, const void* w,
                                      const void* dout, int b, int n, int k, int c, int t, int o, void* scratch,
                                      void* dgath, void* dg, void* stream) {
  Spider s;
  if (!make_spider(feat, idx, g, b, n, k, c, t, s) || o < 1 || k > 65535) return cudaErrorInvalidValue;
  const BwdPlan p = plan_bwd(s.rows, c, t, o);
  if (ceil_div(p.op, 32) > 65535) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto* wf = static_cast<const float*>(w);
  auto* dp = static_cast<const float*>(dout);
  auto* sc = static_cast<float*>(scratch);
  auto* gath = static_cast<float*>(dgath);
  auto* dgp = static_cast<float*>(dg);
  if (p.width == 128) return launch_bwd_data<128>(s, wf, dp, p, o, sc, gath, dgp, st);
  if (p.width == 64) return launch_bwd_data<64>(s, wf, dp, p, o, sc, gath, dgp, st);
  return launch_bwd_data<32>(s, wf, dp, p, o, sc, gath, dgp, st);
}

// The number of row slices of the weight backward at these shapes: enough
// blocks for eight waves of two per SM of an H100 (132 SMs), so the last
// wave's tail is short, in slices of at least 256 rows.
extern "C" int spider_bwd_weight_slices(int rows, int k, int c, int t, int o) {
  if (rows < 1 || k < 1 || c < 1 || t < 1 || t > kMaxT || o < 1) return 1;
  const BwdPlan p = plan_bwd(rows, c, t, o);
  const long long tiles = static_cast<long long>(k) * p.groups * ceil_div(o, p.bn);
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
  const BwdPlan p = plan_bwd(s.rows, c, t, o);
  if (ceil_div(o, p.bn) > 65535) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto* dp = static_cast<const float*>(dout);
  float* target = slices == 1 ? static_cast<float*>(dw) : static_cast<float*>(part);
  cudaError_t err = p.width == 128 ? launch_bwd_weight_bm<128>(s, dp, p, o, slices, target, st)
                    : p.width == 64 ? launch_bwd_weight_bm<64>(s, dp, p, o, slices, target, st)
                                    : launch_bwd_weight_bm<32>(s, dp, p, o, slices, target, st);
  if (err != cudaSuccess || slices == 1) return err;
  const long long len = static_cast<long long>(s.r_len) * o;
  const long long blocks = (len + kThreads - 1) / kThreads;
  sum_slices_kernel<<<static_cast<int>(blocks < 132 * 16 ? blocks : 132 * 16), kThreads, 0, st>>>(
      target, slices, len, static_cast<float*>(dw));
  return cudaGetLastError();
}
