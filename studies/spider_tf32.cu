// A 3xTF32 SpiderConv forward on the tensor cores, kept as a study beside
// the port's kernel (scanobjectnn_torch/csrc/spider.cu), which sums the same
// products with FMA on the CUDA cores.  studies/spider_tf32.py builds this
// file with nvcc and holds it against the port's forward and plain version,
// and in a SpiderCNN training step.  Semantics are those of
// scanobjectnn_torch/ops/cuda/spider_kernel.py.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxT = 64;

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


struct Spider {
  const float* __restrict__ feat;   // [B, N, C]
  const int32_t* __restrict__ idx;  // [B, N, K]
  const float* __restrict__ g;      // [B, N, K, T]
  int rows, n, k, c, t, r_len;      // rows = B * N, r_len = K * C * T
  FastDiv by_n, by_ct, by_t;
};

// ---------------------------------------------------------------------------
// Forward on the tensor cores: out[m, o] = sum_r p[m, r] W[r, o] in 3xTF32.
//
// The reduction is walked chunk by chunk, a chunk being one slot k and a
// group of cb channels [c0, c0 + cb): its indices (c, t) are consecutive, so
// its W rows are one contiguous [cb * T, O] slab.  Once per call,
// spider_fwd_pack_kernel writes each slab, padded with zeros to kc rows
// (cb * T rounded up to 8) and to whole column tiles, in the order in which
// mma.sync reads its B fragments.  Per chunk, the block copies with cp.async
// into one stage of a ring: the slab's column tile, each row's cb channels
// of its neighbour's feat row (the index read once per row and slot) and
// the row's T values of g; the next stage is in flight while the current
// one is multiplied.  The [BM, kc] tile of p is formed from the staged feat
// and g, each p rounded once (__fmul_rn), split into hi = rna_tf32(p) and
// lo = rna_tf32(p - hi) and stored in A-fragment order, one thread a
// fragment slot.  Each warp then runs mma.sync m16n8k8 TF32 over its
// WM x WN sub-tile, W split in registers the same way, adding
// a_lo b_hi + a_hi b_lo + a_hi b_hi in that order (CUTLASS's
// OpMultiplyAddFastF32) into a fresh tile per k-step of 8, which is then
// added to the f32 sum with IEEE adds.
constexpr int kFwdBM = 128;
constexpr int kFwdMaxKC = 64;  // a chunk holds at most 64 reduction indices (T <= kMaxT)

struct FwdPlan {
  int cb, groups, kc, bn, op, fs, stages;  // fs: staged feat row stride
  int smem;                                // dynamic shared memory, bytes
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

// Wait until at most `pending` (0, 1 or 2) committed groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending >= 2) {
    asm volatile("cp.async.wait_group 2;\n" ::);
  } else if (pending == 1) {
    asm volatile("cp.async.wait_group 1;\n" ::);
  } else {
    asm volatile("cp.async.wait_group 0;\n" ::);
  }
}

__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to about 21 bits, both TF32 values.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = to_tf32(x);
  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// d += a b on the tensor cores (m16n8k8, TF32 in, f32 out).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a b (a fresh accumulator).
__device__ __forceinline__ void mma_tf32_fresh(float (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// W [K * C * T, O] -> wp: for each chunk (kk, grp) and tile of BN columns,
// the [kc, BN] slab of W rows (kk * C + grp * cb) * T + q in the order of
// mma.sync's B fragments: for each k-step ks and 8 columns nt, lane
// (g, t) = (lane / 4, lane % 4) holds (W[8 ks + t][8 nt + g],
// W[8 ks + t + 4][8 nt + g]); zeros past the chunk's cb * T rows and past O.
template <int BN>
__global__ void __launch_bounds__(kThreads)
    spider_fwd_pack_kernel(const float* __restrict__ w, int c, int t, int o, FwdPlan p, long long pairs,
                           float2* __restrict__ wp) {
  const int o_tiles = p.op / BN;
  for (long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; e < pairs;
       e += static_cast<long long>(gridDim.x) * kThreads) {
    const int lane = static_cast<int>(e % 32);
    long long rest = e / 32;
    const int nt = static_cast<int>(rest % (BN / 8));
    rest /= BN / 8;
    const int ks = static_cast<int>(rest % (p.kc / 8));
    rest /= p.kc / 8;
    const int ob = static_cast<int>(rest % o_tiles);
    const long long chunk = rest / o_tiles;
    const int kk = static_cast<int>(chunk / p.groups), grp = static_cast<int>(chunk % p.groups);
    const int c0 = grp * p.cb, valid = min(p.cb, c - c0) * t;
    const int col = ob * BN + nt * 8 + lane / 4, q = ks * 8 + lane % 4;
    const float* src = w + ((static_cast<long long>(kk) * c + c0) * t) * o + col;
    const bool on = col < o;
    wp[e] = make_float2(on && q < valid ? src[static_cast<long long>(q) * o] : 0.f,
                        on && q + 4 < valid ? src[static_cast<long long>(q + 4) * o] : 0.f);
  }
}

// Threads of a forward block: one warp a WM x WN sub-tile.
template <int BN, int WM, int WN>
__host__ __device__ constexpr int fwd_threads() { return (kFwdBM / WM) * (BN / WN) * 32; }

// One BM x BN output tile.  Two blocks an SM of 8 warps, one of 16.
template <int BN, int WM, int WN>
__global__ void __launch_bounds__(fwd_threads<BN, WM, WN>(), 512 / fwd_threads<BN, WM, WN>())
    spider_fwd_kernel(Spider s, const float* __restrict__ wp, FwdPlan p, int o_len, int vec16,
                      float* __restrict__ out) {
  constexpr int BM = kFwdBM, kWarpsN = BN / WN, MT = WM / 16, NT = WN / 8;
  constexpr int kThr = fwd_threads<BN, WM, WN>(), kMTiles = BM / 16, kNTiles = BN / 8, kHalves = kThr / BM;
  extern __shared__ __align__(16) float smem[];
  const int kc = p.kc, ksteps = kc / 8, t_len = s.t;
  const int a_slots = ksteps * kMTiles * 32;
  // p's fragments, split: [ksteps][kMTiles][32 lanes] x (a0, a1, a2, a3)
  float4* const a_hi = reinterpret_cast<float4*>(smem);
  float4* const a_lo = a_hi + a_slots;
  int2* const cols = reinterpret_cast<int2*>(a_lo + a_slots);  // (c, t) of chunk column q
  float* const ring = reinterpret_cast<float*>(cols + kFwdMaxKC);
  // A stage: W's B fragments [ksteps][kNTiles][32] x (b0, b1), then the
  // staged feat [BM][fs] and g [BM][T].
  const int stage_floats = kc * BN + BM * p.fs + BM * t_len;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm0 = (warp / kWarpsN) * WM, wn0 = (warp % kWarpsN) * WN;
  const int m0 = blockIdx.x * BM;
  const int nchunks = s.k * p.groups;
  if (tid < kFwdMaxKC) cols[tid] = make_int2(tid / t_len, tid % t_len);

  // Staging: thread tid copies row lr's feat and g values, every kHalves-th.
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
    for (int e = 4 * tid; e < kc * BN; e += 4 * kThr) cp_async16(bs + e, src + e);
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
      if (vec16) {
        for (int q = 4 * half; q < cbe; q += 4 * kHalves) cp_async16(frow + q, fsrc + q);
      } else {
        for (int q = half; q < cbe; q += kHalves) cp_async4(frow + q, fsrc + q);
      }
    }
    const float* gsrc = s.g + (static_cast<long long>(m_load) * s.k + kk) * t_len;
    for (int q = half; q < t_len; q += kHalves) cp_async4(grow + q, gsrc + q);
  };

  // Forming p: one thread an A fragment slot, its four values rounded once
  // and split.
  auto form = [&](int chunk, int stage) {
    const float* fs = ring + stage * stage_floats + kc * BN;
    const float* gs = fs + BM * p.fs;
    const int kk = chunk / p.groups, c0 = (chunk - kk * p.groups) * p.cb;
    const int valid = min(p.cb, s.c - c0) * t_len;
    for (int slot = tid; slot < a_slots; slot += kThr) {
      const int w = slot >> 5, mt = w % kMTiles, ks = w / kMTiles;
      const int r0 = mt * 16 + (lane >> 2), q0 = ks * 8 + (lane & 3);
      const int2 c_lo = cols[q0], c_hi = cols[q0 + 4];
      const float* f0 = fs + r0 * p.fs;
      const float* f1 = f0 + 8 * p.fs;
      const float* g0 = gs + r0 * t_len;
      const float* g1 = g0 + 8 * t_len;
      const float v[4] = {q0 < valid ? __fmul_rn(f0[c_lo.x], g0[c_lo.y]) : 0.f,
                          q0 < valid ? __fmul_rn(f1[c_lo.x], g1[c_lo.y]) : 0.f,
                          q0 + 4 < valid ? __fmul_rn(f0[c_hi.x], g0[c_hi.y]) : 0.f,
                          q0 + 4 < valid ? __fmul_rn(f1[c_hi.x], g1[c_hi.y]) : 0.f};
      unsigned hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(v[i], hi[i], lo[i]);
      a_hi[slot] = make_float4(__uint_as_float(hi[0]), __uint_as_float(hi[1]), __uint_as_float(hi[2]),
                               __uint_as_float(hi[3]));
      a_lo[slot] = make_float4(__uint_as_float(lo[0]), __uint_as_float(lo[1]), __uint_as_float(lo[2]),
                               __uint_as_float(lo[3]));
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

  // acc += the chunk's product, one k-step of 8 at a time: the step's three
  // terms go into a fresh tensor-core tile, which is then added to acc in
  // IEEE f32 (the tensor cores' own f32 sum drops low bits: accumulating a
  // whole conv4 reduction of 4800 terms there misses the per-call gate).
  auto multiply = [&](int stage) {
    const float2* bfrag = reinterpret_cast<const float2*>(ring + stage * stage_floats);
    for (int ks = 0; ks < ksteps; ++ks) {
      unsigned bh[NT][2], bl[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 b = bfrag[(ks * kNTiles + wn0 / 8 + j) * 32 + lane];
        split_tf32(b.x, bh[j][0], bl[j][0]);
        split_tf32(b.y, bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int slot = (ks * kMTiles + wm0 / 16 + i) * 32 + lane;
        const float4 h = a_hi[slot], l = a_lo[slot];
        const unsigned ah[4] = {__float_as_uint(h.x), __float_as_uint(h.y), __float_as_uint(h.z),
                                __float_as_uint(h.w)};
        const unsigned al[4] = {__float_as_uint(l.x), __float_as_uint(l.y), __float_as_uint(l.z),
                                __float_as_uint(l.w)};
        float step[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32_fresh(step[j], al, bh[j]);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(step[j], ah, bl[j]);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(step[j], ah, bh[j]);
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[i][j][v] = __fadd_rn(acc[i][j][v], step[j][v]);
      }
    }
  };

  const int stages = p.stages;
  for (int c = 0; c < stages - 1; ++c) {
    if (c < nchunks) issue(c, c);
    cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait(stages - 2);
    __syncthreads();  // chunk c landed; every warp is done with chunk c - 1
    if (c + stages - 1 < nchunks) issue(c + stages - 1, (c + stages - 1) % stages);
    cp_async_commit();
    form(c, c % stages);
    __syncthreads();
    multiply(c % stages);
  }

  const int o0 = blockIdx.y * BN;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm0 + i * 16 + (lane >> 2) + 8 * h;
      if (m >= s.rows) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int o = o0 + wn0 + j * 8 + 2 * (lane & 3);
        float* dst = out + static_cast<long long>(m) * o_len + o;
        if (o < o_len) dst[0] = acc[i][j][2 * h];
        if (o + 1 < o_len) dst[1] = acc[i][j][2 * h + 1];
      }
    }
  }
}

// Data backward: a block owns BM rows and one slot kk = blockIdx.y, and
// walks the channels in chunks of cc_max (cc_max * T <= BN columns).  Per
// chunk, D = dout W^T over the chunk's contiguous W rows (both operands
// staged with o fastest), then dgath over t and the running dg over c, each
int ceil_div(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

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

// The forward's chunking and tiles at these shapes.  cb, the channels of a
// chunk, minimises the padded reduction depth ceil(C / cb) * kc, kc = cb * T
// rounded up to 8 and at most 64 (ties to the larger cb: fewer chunks).  The
// tile is 128 x 128 when O > 64, 128 x 64 when O > 32, else 128 x 32.  The
// ring takes as many stages (2 to 4) as fit beside the p tile in the shared
// memory of two blocks an SM (of one where two stages do not fit so).
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
  p.bn = o > 128 ? 256 : o > 64 ? 128 : o > 32 ? 64 : 32;
  p.op = ceil_div(o, p.bn) * p.bn;
  p.fs = (p.cb + 3) / 4 * 4;
  const int a_bytes = 2 * 4 * kFwdBM * p.kc + 8 * kFwdMaxKC;
  const int stage_bytes = 4 * (p.kc * p.bn + kFwdBM * p.fs + kFwdBM * t);
  int stages = ((p.bn == 256 ? 227 : 110) * 1024 - a_bytes) / stage_bytes;
  if (stages < 2) stages = (227 * 1024 - a_bytes) / stage_bytes;
  p.stages = stages < 4 ? stages : 4;
  p.smem = a_bytes + p.stages * stage_bytes;
  return p;
}

// Packs W into the scratch (spider_fwd_pack_kernel), then runs the product.
template <int BN, int WM, int WN>
cudaError_t launch_fwd(const Spider& s, const float* w, const FwdPlan& p, int c, int t, int o, int vec16,
                       float* wp, float* out, cudaStream_t st) {
  const long long pairs = static_cast<long long>(s.k) * p.groups * p.kc * p.op / 2;
  const long long blocks = (pairs + kThreads - 1) / kThreads;
  spider_fwd_pack_kernel<BN><<<static_cast<int>(blocks < 132 * 16 ? blocks : 132 * 16), kThreads, 0, st>>>(
      w, c, t, o, p, pairs, reinterpret_cast<float2*>(wp));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kernel = spider_fwd_kernel<BN, WM, WN>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(ceil_div(s.rows, kFwdBM), ceil_div(o, BN));
  kernel<<<grid, fwd_threads<BN, WM, WN>(), p.smem, st>>>(s, wp, p, o, vec16, out);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// Floats of the forward's scratch (the packed W) at these shapes, or -1
// where the forward does not take them.
extern "C" long long spider_tf32_scratch(int k, int c, int t, int o) {
  if (k < 1 || c < 1 || t < 1 || t > kMaxT || o < 1) return -1;
  const FwdPlan p = plan_fwd(c, t, o);
  return static_cast<long long>(k) * p.groups * p.kc * p.op;
}

// feat [b, n, c] f32, idx [b, n, k] int32 in [0, n), g [b, n, k, t] f32,
// w [k * c * t, o] f32, all contiguous, scratch of spider_tf32_scratch floats
// -> out [b, n, o] f32.  Packs W into the scratch, then runs the product.
extern "C" int spider_tf32_launch(const void* feat, const void* idx, const void* g, const void* w, int b,
                                 int n, int k, int c, int t, int o, void* scratch, void* out, void* stream) {
  Spider s;
  if (!make_spider(feat, idx, g, b, n, k, c, t, s) || o < 1) return cudaErrorInvalidValue;
  const FwdPlan p = plan_fwd(c, t, o);
  if (ceil_div(o, p.bn) > 65535) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto* wf = static_cast<const float*>(w);
  auto* wp = static_cast<float*>(scratch);
  auto* op = static_cast<float*>(out);
  const int vec16 = c % 4 == 0 && p.cb % 4 == 0 && aligned16(feat);
  if (p.bn == 256) return launch_fwd<256, 64, 32>(s, wf, p, c, t, o, vec16, wp, op, st);
  if (p.bn == 128) return launch_fwd<128, 64, 32>(s, wf, p, c, t, o, vec16, wp, op, st);
  if (p.bn == 64) return launch_fwd<64, 32, 32>(s, wf, p, c, t, o, vec16, wp, op, st);
  return launch_fwd<32, 32, 16>(s, wf, p, c, t, o, vec16, wp, op, st);
}

// The data backward: the forward's inputs and dout [b, n, o] f32 ->
