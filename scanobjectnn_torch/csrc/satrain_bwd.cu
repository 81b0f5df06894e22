// Backward of the fused SA training tail for Hopper (sm_90a): BN0 -> relu ->
// (Dense -> BN -> relu)* -> max over the neighbour axis, recomputed from the
// layer-0 pre-activations z1 with the saved batch statistics.
//
// Replaces scanobjectnn_tpu/ops/pallas/satrain_bwd.py: bwd_pallas (body
// _pass_kernel), the VJP of satrain_kernel.grouped_bn_mlp_pool.  It computes
// what satrain_kernel._bwd_xla computes, which
// scanobjectnn_torch/ops/cuda/satrain_kernel.py documents beside its plain
// version.  Training BN couples all R = groups * K rows through its batch
// statistics: layer i's backward needs the global sums S1_i = sum du_i and
// S2_i = sum du_i * zhat_i, and du_i needs dz_{i+1}, so the sums come one
// layer a pass, top down:
//   pool pass     (only where a chunk cannot hold whole groups) each group's
//                 max and tie count of the last layer's y, from this kernel's
//                 own recompute (a cuBLAS forward rounds otherwise, and a
//                 winner compared across the two would shatter the tie mask);
//   pass j        (j = L-1 .. 0) recompute the chain, take the pool backward
//                 (ties split evenly), walk down through the layers whose
//                 sums are known, and sum S1_j, S2_j; the pass that walks
//                 through layer j+1 also sums dW_{j+1} and db_{j+1};
//   final pass    walk down to layer 0 and write dz1.
// Where a chunk holds whole groups (K <= its rows, as at SSG's SA1) every
// pass takes each group's max and tie count from its own recompute, as
// bwd_pallas does, and the pool pass is not launched: L + 1 passes, not
// L + 2.  Nothing [rows, C_i]-sized (i >= 1) is written between the passes.
//
// Precision follows _bwd_xla: the recompute rounds matmul operands and h, y
// to the compute dtype (bf16 or f32) as the forward does, but the last
// layer under pool mode "1" (f32); the gradient walk (dy = dz W^T, dW = y^T
// dz) runs in f32 on the CUDA cores, no TF32; relu'(0) = 0.
//
// Design.  The wrapper plans each launch (ops/cuda/satrain_kernel.py:
// plan) and this file checks the plan and refuses one it cannot run.  A
// block takes chunks of 64, 32, 16, 8 or 4 rows: the plan takes the most
// blocks an SM, then the most rows, that the layers' buffers leave room
// for (SSG's SA1: 64 rows, two blocks an SM; SA2 and MSG's K = 128
// scales: 32 rows, two blocks; group-all's 256-512-1024: 16 rows, one).
// Activations sit k-major ([channel][row]) in shared memory: h_i of every
// layer i >= 1 (h_0 is z1, re-read from L2), and two buffers, one for the
// even and one for the odd layers below the top, that hold y (the next
// product's operand), then dy and dz on the way down.  Every product (h_i =
// y_{i-1} W_i, dy_{i-1} = dz_i W_i^T) is a register tile: a thread holds
// 4 x 4 sums (8 x 4 at 64 rows in a build for one block an SM) and reads
// its activations and weights with 16-byte shared loads; W (or W^T) is
// staged in shared memory slice by slice with cp.async, the next slices in
// flight while the block multiplies the current one (as sapool.cuh stages
// the eval MLP).  Each output is the FMA chain from 0 in ascending k, so its
// bits do not depend on the tiling, and the pool's max and a later pass's
// equality test see the same bits.  The BN epilogue (bias, rounding, zhat,
// u, relu) works on the tile's registers.  The per-channel constants (mean,
// r, gamma, beta, r gamma, S1/R, S2/R) are computed once a call into a table
// (consts_kernel; reduce_kernel adds each pass's S1/R and S2/R with the same
// __fdiv_rn as before), which each block copies into shared memory where it
// fits; 1/cnt is taken once per group and channel.  The top layer's pool
// backward and the per-channel sums (S1, S2, db) use every thread: a
// channel's rows in segments, added in order (column_sums).  dW_i =
// y_{i-1}^T dz_i is a third register tile (4 x 4 entries a thread, 64 x 64
// a tile, over the chunk's rows four at a time): a block sums its rows in
// order into its own slice of a partial buffer, in shared memory where that
// keeps the blocks an SM (written once), else in the partial buffer itself,
// read and written once per chunk (at most 64 rows); reduce_kernel sums the
// blocks in block order.  Where the partial buffer cannot hold a slice for
// enough blocks to fill the card (group-all: 2 MiB of dW_2 a block), the
// dW's tiles split across blockIdx.y, and with them the target's channels
// (the dy product below the emitting layer and S1, S2): every slice
// recomputes its rows down to the emitting layer.  No float atomics: two
// calls give the same bits.
//
// Bound: operations.  The least work is one forward recompute plus the dW
// and dy products (chip_smoke.py: satrain_work); this design does L + 1 or
// L + 2 forward recomputes, and the dy products above each pass's target
// again: at SSG SA2 (B=16: 131072 rows, 128-128-256) 111.7 GFLOP over five
// passes, 1.7 ms at the card's 67 TFLOP/s of f32 FMA (PERF.md section 6, PR
// 13, has the readings).  Two things stay out.  The merged algebra of the
// TPU kernel (two layers' scalars a pass from cross-moments) trades a
// forward recompute (98304 operations a row at SA2) for four moment
// products (262144): a gain on the TPU's matrix unit, a loss on the CUDA
// cores.  And tensor cores: one-pass TF32 is out by contract, and a bf16
// recompute on them would sum in another order than the plain version's
// products (PERF.md section 7).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLayers = 4;
constexpr int kMaxWidth = 1024;                   // channels of a layer
constexpr int kPerThread = kMaxWidth / kThreads;  // channels a thread owns in a per-channel loop
constexpr int kSlice = 2048;                      // floats of one staged W slice
constexpr int kConsts = 7;                        // per-channel constants a layer
constexpr int kDwSide = 64;                       // a dW tile: 64 x 64 entries
constexpr int kDwThreads = 16;                    // threads along each side of a dW tile
constexpr int kDwTileFloats = kDwSide * kDwSide;
constexpr int kPlanHead = 8, kPlanPass = 4;
constexpr size_t kMaxSmem = 227 * 1024;

enum { kMean, kR, kGamma, kBeta, kCoef, kS1n, kS2n };

struct Net {
  int layers, bf16, pool_f32, k, chunk_rows, pool_in_pass, sum_c;
  int width[kMaxLayers];
  int coff[kMaxLayers];  // layer i's first channel in a row of the constants table
  int64_t rows;
  float rcount;
  const void* z1;      // [rows, C0], compute dtype
  const float* dpool;  // [groups, C_{L-1}]
  const float* mean[kMaxLayers];
  const float* r[kMaxLayers];  // rsqrt(var + eps)
  const float* gamma[kMaxLayers];
  const float* beta[kMaxLayers];
  const float* wcd[kMaxLayers];   // [C_{i-1}, C_i], rounded to the compute dtype (i >= 1)
  const float* wt[kMaxLayers];    // [C_i, C_{i-1}] f32, transposed (i >= 1)
  const float* bias[kMaxLayers];  // (i >= 1)
  float* s1[kMaxLayers];          // dbeta
  float* s2[kMaxLayers];          // dgamma
  float* dw[kMaxLayers];          // (i >= 1)
  float* db[kMaxLayers];          // (i >= 1)
  float* pooled;   // [groups, C_{L-1}] (pool pass)
  float* share;    // [groups, C_{L-1}]: d_pooled / cnt (pool pass)
  float* table;    // [kConsts, sum_c]
  float* partial;  // [blocks, stride]
  void* dz1;       // [rows, C0], compute dtype
};

// One pass: the layer whose S1, S2 it sums (-1: dz1; the pool pass: the
// top layer), chunks a block, dW tiles a slice (blockIdx.y), floats of a
// block's partial slice, whether the dW and the constants live in shared
// memory, the target's channels a slice takes, and the buffers' offsets
// there (floats; -1: none): the W ring at 0, h_i, the even and odd layers'
// buffers, the dW, the constants.
struct Pass {
  int target, cpb, tiles_per_slice, stride, dw_smem, consts_smem;
  int cps;  // the target's channels a dW slice takes (a multiple of 4): its dy columns and S1, S2
  int h_off[kMaxLayers], b_off[2], dw_off, cst_off;
};

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ float cd(const Net& n, float v) {
  return n.bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

__device__ __forceinline__ float load_z1(const Net& n, int64_t i) {
  return n.bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(n.z1)[i]) : static_cast<const float*>(n.z1)[i];
}

__device__ __forceinline__ float cst_at(const Net& n, const float* cst, int kind, int i, int c) {
  return cst[kind * n.sum_c + n.coff[i] + c];
}

__device__ __forceinline__ float zhat_of(const Net& n, const float* cst, int i, int c, float h) {
  return __fmul_rn(__fsub_rn(h, cst_at(n, cst, kMean, i, c)), cst_at(n, cst, kR, i, c));
}

__device__ __forceinline__ float u_of(const Net& n, const float* cst, int i, int c, float zh) {
  return __fadd_rn(__fmul_rn(zh, cst_at(n, cst, kGamma, i, c)), cst_at(n, cst, kBeta, i, c));
}

// y_i = relu(u_i) in the compute dtype; the last layer stays f32 under pool
// mode "1".
__device__ __forceinline__ float y_from_u(const Net& n, int i, float u) {
  const float y = u < 0.f ? 0.f : u;
  return i == n.layers - 1 && n.pool_f32 ? y : cd(n, y);
}

__device__ __forceinline__ float y_of(const Net& n, const float* cst, int i, int c, float h) {
  return y_from_u(n, i, u_of(n, cst, i, c, zhat_of(n, cst, i, c, h)));
}

// dz_i = r gamma ((du - S1/R) - zhat S2/R).
__device__ __forceinline__ float dz_of(const Net& n, const float* cst, int i, int c, float zh, float du) {
  return __fmul_rn(cst_at(n, cst, kCoef, i, c),
                   __fsub_rn(__fsub_rn(du, cst_at(n, cst, kS1n, i, c)), __fmul_rn(zh, cst_at(n, cst, kS2n, i, c))));
}

// A thread's TR x TC register tile of a product over the chunk's Rows rows
// and kCols output columns a pass.  The threads form kRowThreads x
// kColThreads, row group fastest; rows and columns go in runs of 4 (one
// 16-byte shared load), a thread's runs kRowThreads (kColThreads) runs
// apart.
template <int Rows, int TR, int TC>
struct Tile {
  static constexpr int kLdr = Rows + 4;  // row stride of the k-major activations (floats)
  static constexpr int kRowThreads = Rows / TR;
  static constexpr int kColThreads = kThreads / kRowThreads;
  static constexpr int kCols = TC * kColThreads;
  static constexpr int kDepth = kSlice / kCols;  // k rows of a W slice
  static_assert(kDepth >= 1 && kSlice % kCols == 0, "a W slice holds whole rows");
  static __device__ __forceinline__ int row(int rg, int i) { return (i / 4) * 4 * kRowThreads + 4 * rg + (i & 3); }
  static __device__ __forceinline__ int col(int cg, int j) { return (j / 4) * 4 * kColThreads + 4 * cg + (j & 3); }
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// W slices a block's ring holds: two at 32 and 64 rows a chunk (one in
// flight; three or four read no faster on an H100 at SSG's SA1 and SA2),
// four below, where a chunk's few rows give each slice little work.
__host__ __device__ constexpr int ring_stages(int rows) { return rows >= 32 ? 2 : 4; }

// Copies W rows [k0, k0 + kSlice / Cols) x columns [n0, n0 + Cols) of w
// [kin, cout] into ws [kSlice / Cols][Cols] with cp.async, zeros past w's
// edges: 16 bytes a copy where cout % 4 == 0, else 4.
template <int Cols>
__device__ __forceinline__ void copy_slice(float* ws, const float* __restrict__ w, int kin, int cout, int k0, int n0) {
  constexpr int kQuads = kSlice / 4 / kThreads;
  const bool vec = (cout & 3) == 0;
#pragma unroll
  for (int u = 0; u < kQuads; ++u) {
    const int e = 4 * (threadIdx.x + u * kThreads), kk = k0 + e / Cols, c = n0 + e % Cols;
    const bool row = kk < kin;
    if (vec) {
      const bool in = row && c < cout;
      cp_async16(ws + e, in ? w + kk * cout + c : w, in ? 16 : 0);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = row && c + j < cout;
        cp_async4(ws + e + j, in ? w + kk * cout + c + j : w, in ? 4 : 0);
      }
    }
  }
}

// acc[i][j] = fmaf(act[k][row i], ws[k][col j], acc[i][j]) for one k.
template <int Rows, int TR, int TC>
__device__ __forceinline__ void fma_step(const float* ak, const float* wk, int rg, int cg, float (&acc)[TR][TC]) {
  using Tl = Tile<Rows, TR, TC>;
  float av[TR], wv[TC];
#pragma unroll
  for (int h = 0; h < TR / 4; ++h) {
    const float4 v = *reinterpret_cast<const float4*>(ak + Tl::row(rg, 4 * h));
    av[4 * h] = v.x, av[4 * h + 1] = v.y, av[4 * h + 2] = v.z, av[4 * h + 3] = v.w;
  }
#pragma unroll
  for (int h = 0; h < TC / 4; ++h) {
    const float4 v = *reinterpret_cast<const float4*>(wk + Tl::col(cg, 4 * h));
    wv[4 * h] = v.x, wv[4 * h + 1] = v.y, wv[4 * h + 2] = v.z, wv[4 * h + 3] = v.w;
  }
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
}

// acc += act[k] (x) w[k, n0 + ...] over k < kin in ascending order, W staged
// slice by slice through `ring` (ring_stages(Rows) slices, cp.async, all
// but one in flight while the block multiplies the current one).
// Every thread of the block must call it; it ends with a barrier, after
// which the ring is free.
template <int Rows, int TR, int TC>
__device__ __forceinline__ void fma_chain(const float* act, const float* __restrict__ w, int kin, int cout, int n0,
                                          float* ring, int rg, int cg, float (&acc)[TR][TC]) {
  using Tl = Tile<Rows, TR, TC>;
  constexpr int kStages = ring_stages(Rows);
  const int nsl = (kin + Tl::kDepth - 1) / Tl::kDepth;
#pragma unroll
  for (int st = 0; st + 1 < kStages; ++st) {
    if (st < nsl) copy_slice<Tl::kCols>(ring + st * kSlice, w, kin, cout, st * Tl::kDepth, n0);
    cp_async_commit();
  }
  for (int s = 0; s < nsl; ++s) {
    cp_async_wait<kStages - 2>();  // this thread's copies of slice s have landed
    __syncthreads();               // everyone's; and slice s - 1's stage is free
    const int next = s + kStages - 1;
    if (next < nsl) copy_slice<Tl::kCols>(ring + (next % kStages) * kSlice, w, kin, cout, next * Tl::kDepth, n0);
    cp_async_commit();
    const int k0 = s * Tl::kDepth;
    const float* ws = ring + (s % kStages) * kSlice;
    const float* ak = act + k0 * Tl::kLdr;
    if (kin - k0 >= Tl::kDepth) {
#pragma unroll
      for (int kk = 0; kk < Tl::kDepth; ++kk)
        fma_step<Rows, TR, TC>(ak + kk * Tl::kLdr, ws + kk * Tl::kCols, rg, cg, acc);
    } else {
      for (int kk = 0; kk < kin - k0; ++kk) fma_step<Rows, TR, TC>(ak + kk * Tl::kLdr, ws + kk * Tl::kCols, rg, cg, acc);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// acc_mem[tile][i][j][thread] += sum over t < nt4 of y[a][t] dz[c][t] for
// the dW tiles [tile_begin, tile_end): a thread owns a = a0 + ag + 16 i, c =
// c0 + cg + 16 j (i, j < 4), summed over the rows four at a time, in order.
// y [ca][ldr] and dz [cc][ldr] in shared memory, zeros in rows >= nt.
template <int Rows>
__device__ __forceinline__ void dw_product(const float* y, const float* dz, int ca, int cc, int nt4, int tile_begin,
                                           int tile_end, float* acc_mem, bool accumulate) {
  constexpr int ldr = Rows + 4;
  const int tid = threadIdx.x, ag = tid % kDwThreads, cg = tid / kDwThreads;
  const int tiles_c = (cc + kDwSide - 1) / kDwSide;
  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int a0 = (tile / tiles_c) * kDwSide, c0 = (tile % tiles_c) * kDwSide;
    float* mem = acc_mem + (tile - tile_begin) * kDwTileFloats + tid;
    int yo[4], dof[4];  // rows of y and dz (clamped to the buffers)
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      yo[i] = min(a0 + ag + i * kDwThreads, ca - 1) * ldr;
      dof[i] = min(c0 + cg + i * kDwThreads, cc - 1) * ldr;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = accumulate ? mem[(i * 4 + j) * kThreads] : 0.f;
    }
    for (int t = 0; t < nt4; t += 4) {
      float4 yv[4], dv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        yv[i] = *reinterpret_cast<const float4*>(y + yo[i] + t);
        dv[i] = *reinterpret_cast<const float4*>(dz + dof[i] + t);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = acc[i][j];
          a = fmaf(yv[i].x, dv[j].x, a);
          a = fmaf(yv[i].y, dv[j].y, a);
          a = fmaf(yv[i].z, dv[j].z, a);
          acc[i][j] = fmaf(yv[i].w, dv[j].w, a);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mem[(i * 4 + j) * kThreads] = acc[i][j];
  }
}

// What a product's epilogue stores: the forward's h = round(acc + b) into
// `out` and, for a hidden layer, y = y_of(h) into `y`; or (bias null) the
// sums themselves (dy).
struct Epi {
  float* out;
  float* y;
  const float* bias;
  int layer;
  bool round;
};

template <int Rows, int TR, int TC>
__device__ __forceinline__ void product_tiles(const Net& n, const float* cst, const float* act,
                                              const float* __restrict__ w, int kin, int cout, int lo, int hi,
                                              float* ring, const Epi& epi) {
  using Tl = Tile<Rows, TR, TC>;
  const int tid = threadIdx.x, rg = tid % Tl::kRowThreads, cg = tid / Tl::kRowThreads;
  for (int n0 = lo; n0 < hi; n0 += Tl::kCols) {
    float acc[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) acc[i][j] = 0.f;
    fma_chain<Rows, TR, TC>(act, w, kin, cout, n0, ring, rg, cg, acc);
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int c = n0 + Tl::col(cg, j);
      if (c >= hi) continue;
      const float b = epi.bias ? __ldg(epi.bias + c) : 0.f;
#pragma unroll
      for (int h = 0; h < TR / 4; ++h) {
        float v[4], yv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float x = acc[4 * h + q][j];
          if (epi.bias) {
            x = __fadd_rn(x, b);
            if (epi.round) x = cd(n, x);
            yv[q] = epi.y ? y_of(n, cst, epi.layer, c, x) : 0.f;
          }
          v[q] = x;
        }
        const int r = c * Tl::kLdr + Tl::row(rg, 4 * h);
        *reinterpret_cast<float4*>(epi.out + r) = make_float4(v[0], v[1], v[2], v[3]);
        if (epi.y) *reinterpret_cast<float4*>(epi.y + r) = make_float4(yv[0], yv[1], yv[2], yv[3]);
      }
    }
  }
}

// A product over the chunk, output columns [lo, hi) of cout: at 64 rows in
// a kernel built for one block an SM, 8 x 4 sums a thread in passes of 128
// columns above 64 output columns; else 4 x 4.  Every thread of the block
// must call it; the caller synchronises before reading the outputs.
template <int Rows, int MinBlocks>
__device__ __forceinline__ void product(const Net& n, const float* cst, const float* act, const float* w, int kin,
                                        int cout, float* ring, const Epi& epi, int lo = 0, int hi = -1) {
  if (hi < 0) hi = cout;
  if constexpr (Rows == 64 && MinBlocks == 1) {
    if (cout > 64) {
      product_tiles<64, 8, 4>(n, cst, act, w, kin, cout, lo, hi, ring, epi);
      return;
    }
  }
  product_tiles<Rows, 4, 4>(n, cst, act, w, kin, cout, lo, hi, ring, epi);
}

__host__ __device__ inline void buffer_widths(int layers, const int* width, int* hsum, int* b0, int* b1) {
  *hsum = 0;
  *b0 = *b1 = 0;
  for (int i = layers == 1 ? 0 : 1; i < layers; ++i) *hsum += width[i];
  for (int i = 0; i + 1 < layers; ++i) {
    int& b = (i & 1) ? *b1 : *b0;
    b = b > width[i] ? b : width[i];
  }
}

// Floats of shared memory a block takes at `rows` rows a chunk
// (ops/cuda/satrain_kernel.py: _smem_bytes counts the same).
size_t smem_floats(int rows, int layers, const int* width, int dw_floats, int consts_smem) {
  int hsum, b0, b1, sum_c = 0;
  buffer_widths(layers, width, &hsum, &b0, &b1);
  for (int i = 0; i < layers; ++i) sum_c += width[i];
  return static_cast<size_t>(ring_stages(rows)) * kSlice + static_cast<size_t>(rows + 4) * (hsum + b0 + b1) +
         dw_floats + (consts_smem ? kConsts * sum_c : 0);
}

// A pass with its shared-memory offsets, in smem_floats's order.
Pass make_pass(const Net& n, int rows, int target, int cpb, int tps, int cps, int stride, int dw_smem,
               int consts_smem) {
  Pass p{target, cpb, tps, stride, dw_smem, consts_smem, cps, {-1, -1, -1, -1}, {-1, -1}, -1, -1};
  const int ldr = rows + 4;
  int off = ring_stages(rows) * kSlice;
  for (int i = n.layers == 1 ? 0 : 1; i < n.layers; ++i) {
    p.h_off[i] = off;
    off += ldr * n.width[i];
  }
  int hsum, b0, b1;
  buffer_widths(n.layers, n.width, &hsum, &b0, &b1);
  p.b_off[0] = off;
  off += ldr * b0;
  p.b_off[1] = off;
  off += ldr * b1;
  p.dw_off = off;
  off += dw_smem ? tps * kDwTileFloats : 0;
  p.cst_off = off;
  return p;
}

// The constants: copied into shared memory where the pass keeps them
// there (every thread must call it before a barrier), else the table.
__device__ __forceinline__ const float* constants(const Net& n, const Pass& p, float* sm) {
  if (!p.consts_smem) return n.table;
  float* cst = sm + p.cst_off;
  for (int e = threadIdx.x; e < kConsts * n.sum_c; e += kThreads) cst[e] = n.table[e];
  return cst;
}

// Recompute h_1 .. h_{L-1} of rows [r0, r0 + nt) (h_0 when L == 1), each
// hidden layer's y into the buffer of its parity; rows >= nt start from
// zeros and are never read as results.
template <int Rows, int MinBlocks>
__device__ void forward(const Net& n, const Pass& p, float* sm, const float* cst, int64_t r0, int nt) {
  constexpr int ldr = Rows + 4;
  const int c0 = n.width[0];
  const bool one = n.layers == 1;
  float* dst = sm + (one ? p.h_off[0] : p.b_off[0]);
  for (int e = threadIdx.x; e < Rows * c0; e += kThreads) {
    const int t = e / c0, c = e - t * c0;
    float v = 0.f;
    if (t < nt) {
      v = load_z1(n, (r0 + t) * c0 + c);
      if (!one) v = y_of(n, cst, 0, c, v);
    }
    dst[c * ldr + t] = v;
  }
  __syncthreads();
  for (int i = 1; i < n.layers; ++i) {
    const bool top = i == n.layers - 1;
    product<Rows, MinBlocks>(n, cst, sm + p.b_off[(i - 1) & 1], n.wcd[i], n.width[i - 1], n.width[i], sm,
                             Epi{sm + p.h_off[i], top ? nullptr : sm + p.b_off[i & 1], n.bias[i], i,
                                 !(top && n.pool_f32)});
    __syncthreads();
  }
}

// The max of the last layer's y over each group's K rows and the number of
// rows that reach it.  A block takes one segment of a group (`seg_rows`
// rows, whole chunks; a group of `segs` segments) at a time.  With one
// segment a group it writes pooled and share = d_pooled / cnt; else the
// segment's (max, count) go to `part` [groups * segs, 2, C] for
// combine_kernel.
template <int Rows, int MinBlocks>
__global__ void __launch_bounds__(kThreads, MinBlocks)
    pool_kernel(const __grid_constant__ Net n, const __grid_constant__ Pass p, int segs, int seg_rows,
                float* part) {
  constexpr int ldr = Rows + 4;
  extern __shared__ __align__(16) float sm[];
  const float* cst = constants(n, p, sm);
  __syncthreads();
  const int last = n.layers - 1, cl = n.width[last];
  const float* hl = sm + p.h_off[last];
  const int64_t units = n.rows / n.k * segs;
  for (int64_t u = blockIdx.x; u < units; u += gridDim.x) {
    const int64_t g = u / segs;
    const int j_begin = static_cast<int>(u % segs) * seg_rows, j_end = min(n.k, j_begin + seg_rows);
    float best[kPerThread], count[kPerThread];
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      best[q] = -inf_f();
      count[q] = 0.f;
    }
    for (int j0 = j_begin; j0 < j_end; j0 += Rows) {
      const int nt = min(Rows, j_end - j0);
      forward<Rows, MinBlocks>(n, p, sm, cst, g * n.k + j0, nt);
#pragma unroll
      for (int q = 0; q < kPerThread; ++q) {
        const int c = threadIdx.x + q * kThreads;
        if (c >= cl) break;
        for (int t = 0; t < nt; ++t) {
          const float y = y_of(n, cst, last, c, hl[c * ldr + t]);
          if (y > best[q]) {
            best[q] = y;
            count[q] = 1.f;
          } else if (y == best[q]) {
            count[q] = __fadd_rn(count[q], 1.f);
          }
        }
      }
      __syncthreads();  // the next chunk overwrites h
    }
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const int c = threadIdx.x + q * kThreads;
      if (c >= cl) break;
      if (segs == 1) {
        n.pooled[g * cl + c] = best[q];
        n.share[g * cl + c] = __fmul_rn(__fdiv_rn(1.f, count[q]), n.dpool[g * cl + c]);
      } else {
        part[(u * 2) * cl + c] = best[q];
        part[(u * 2 + 1) * cl + c] = count[q];
      }
    }
  }
}

// Each (group, channel)'s segments combined in order: the largest max, and
// the counts of the segments that reach it summed; then share.
__global__ void __launch_bounds__(kThreads)
    combine_kernel(const __grid_constant__ Net n, int segs, const float* __restrict__ part) {
  const int cl = n.width[n.layers - 1];
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= n.rows / n.k * cl) return;
  const int64_t g = e / cl;
  const int c = static_cast<int>(e % cl);
  float best = -inf_f(), count = 0.f;
  for (int sg = 0; sg < segs; ++sg) {
    const int64_t u = g * segs + sg;
    const float m = part[(u * 2) * cl + c], k = part[(u * 2 + 1) * cl + c];
    if (m > best) {
      best = m;
      count = k;
    } else if (m == best) {
      count = __fadd_rn(count, k);
    }
  }
  n.pooled[e] = best;
  n.share[e] = __fmul_rn(__fdiv_rn(1.f, count), n.dpool[e]);
}

// The constants table: mean, r, gamma, beta, r gamma of every layer; S1/R
// and S2/R start at 0 and are filled by reduce_kernel.
__global__ void __launch_bounds__(kThreads) consts_kernel(const __grid_constant__ Net n) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= n.sum_c) return;
  int i = 0;
  while (i + 1 < n.layers && e >= n.coff[i + 1]) ++i;
  const int c = e - n.coff[i];
  const float r = n.r[i][c], gamma = n.gamma[i][c];
  float* t = n.table + e;
  t[kMean * n.sum_c] = n.mean[i][c];
  t[kR * n.sum_c] = r;
  t[kGamma * n.sum_c] = gamma;
  t[kBeta * n.sum_c] = n.beta[i][c];
  t[kCoef * n.sum_c] = __fmul_rn(r, gamma);
  t[kS1n * n.sum_c] = 0.f;
  t[kS2n * n.sum_c] = 0.f;
}

// The top layer's du at row value h given its group's max and share, and
// zhat (the pool backward: the cotangent split evenly over the winners).
__device__ __forceinline__ float top_du(const Net& n, const float* cst, int c, float h, float best, float share,
                                        float& zh) {
  const int top = n.layers - 1;
  zh = zhat_of(n, cst, top, c, h);
  const float u = u_of(n, cst, top, c, zh);
  return u > 0.f && y_from_u(n, top, u) == best ? share : 0.f;
}

// Ordered per-channel sums over the chunk's rows with every thread, for
// the channels [c0, c0 + channels): thread (c, s) sums f over channel c's
// rows [s seg, (s + 1) seg) into `scratch` [2][segs][channels] (shared
// memory), then one thread a channel adds the segments in order to its
// running sums acc1[c], acc2[c] (acc2 may be null).  Every thread of the
// block must call it.
template <typename F>
__device__ __forceinline__ void column_sums(int c0, int channels, int nt, float* scratch, float* acc1, float* acc2,
                                            F f) {
  if (channels <= 0) {
    __syncthreads();
    return;
  }
  const int segs = max(1, min(kThreads / channels, nt));
  const int seg = (nt + segs - 1) / segs;
  for (int e = threadIdx.x; e < channels * segs; e += kThreads) {
    const int c = e % channels, sg = e / channels, t_end = min(nt, (sg + 1) * seg);
    float a1 = 0.f, a2 = 0.f;
    for (int t = sg * seg; t < t_end; ++t) f(c0 + c, t, a1, a2);
    scratch[e] = a1;
    scratch[channels * segs + e] = a2;
  }
  __syncthreads();
  for (int c = c0 + threadIdx.x; c < c0 + channels; c += kThreads) {
    float a1 = acc1[c], a2 = acc2 ? acc2[c] : 0.f;
    for (int sg = 0; sg < segs; ++sg) {
      a1 = __fadd_rn(a1, scratch[sg * channels + c - c0]);
      a2 = __fadd_rn(a2, scratch[(segs + sg) * channels + c - c0]);
    }
    acc1[c] = a1;
    if (acc2) acc2[c] = a2;
  }
  __syncthreads();
}

// One pass of the walk (Pass, above).  Block (x, y) takes chunks [x cpb,
// (x + 1) cpb) and the dW tiles of slice y; its partial slice is [S1 | S2 |
// dW tiles (tile order) | db] at (y * gridDim.x + x) * stride, where it
// sums S1, S2 and db over its chunks (column_sums).
template <int Rows, int MinBlocks>
__global__ void __launch_bounds__(kThreads, MinBlocks)
    walk_kernel(const __grid_constant__ Net n, const __grid_constant__ Pass p) {
  constexpr int ldr = Rows + 4;
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, top = n.layers - 1, target = p.target, emit = target + 1;
  const bool with_dw = target >= 0 && emit <= top;
  const bool lead = blockIdx.y == 0;  // sums db
  const int dw_floats = with_dw ? p.tiles_per_slice * kDwTileFloats : 0;
  const int ct = target >= 0 ? n.width[target] : 0, ce = with_dw ? n.width[emit] : 0;
  float* part = n.partial + (static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x) * p.stride;
  float* part_db = part + 2 * ct + dw_floats;
  float* dw_acc = p.dw_smem ? sm + p.dw_off : part + 2 * ct;
  const float* cst = constants(n, p, sm);
  if (p.dw_smem) {
    for (int e = tid; e < dw_floats; e += kThreads) dw_acc[e] = 0.f;
  }
  if (target >= 0) {
    for (int c = tid; c < ct; c += kThreads) part[c] = part[ct + c] = 0.f;
  }
  if (lead) {
    for (int c = tid; c < ce; c += kThreads) part_db[c] = 0.f;
  }
  __syncthreads();
  const int tiles = with_dw ? ((ct + kDwSide - 1) / kDwSide) * ((ce + kDwSide - 1) / kDwSide) : 0;
  const int tile_begin = blockIdx.y * p.tiles_per_slice, tile_end = min(tiles, tile_begin + p.tiles_per_slice);

  const int64_t first = static_cast<int64_t>(blockIdx.x) * p.cpb;
  for (int64_t ch = first; ch < first + p.cpb; ++ch) {
    const int64_t r0 = ch * n.chunk_rows;
    if (r0 >= n.rows) break;
    const int nt = static_cast<int>(min(static_cast<int64_t>(n.chunk_rows), n.rows - r0));
    forward<Rows, MinBlocks>(n, p, sm, cst, r0, nt);

    // The top layer.  The pool backward splits the cotangent evenly over
    // each group's winners; with the pool in the pass, each (group,
    // channel)'s max and share = d_pooled / count come first, into the free
    // ring ([2][groups][cl] from kSlice on; the sums' scratch below it).
    const int cl = n.width[top];
    float* x = sm + p.h_off[top];
    float* pool = sm + kSlice;
    const int chunk_groups = n.pool_in_pass ? nt / n.k : 0;
    const int64_t g0 = r0 / n.k;
    const int j0 = static_cast<int>(r0 - g0 * n.k);
    if (n.pool_in_pass) {
      for (int e = tid; e < chunk_groups * cl; e += kThreads) {
        const int g = e / cl, c = e - g * cl;
        const float* xc = x + c * ldr + g * n.k;
        float best = -inf_f(), count = 0.f;
        for (int t = 0; t < n.k; ++t) {
          const float y = y_of(n, cst, top, c, xc[t]);
          if (y > best) {
            best = y;
            count = 1.f;
          } else if (y == best) {
            count = __fadd_rn(count, 1.f);
          }
        }
        pool[e] = best;
        pool[chunk_groups * cl + e] = __fmul_rn(__fdiv_rn(1.f, count), n.dpool[(g0 + g) * cl + c]);
      }
      __syncthreads();
    }
    // du of the top layer at (c, t), and zhat.
    auto top_at = [&](int c, int t, float& zh) {
      float best, share;
      if (n.pool_in_pass) {
        const int e = (t / n.k) * cl + c;
        best = pool[e];
        share = pool[chunk_groups * cl + e];
      } else {
        const int64_t pc = (g0 + (j0 + t) / n.k) * cl + c;
        best = n.pooled[pc];
        share = n.share[pc];
      }
      return top_du(n, cst, c, x[c * ldr + t], best, share, zh);
    };
    if (target == top) {
      column_sums(0, cl, nt, sm, part, part + cl, [&](int c, int t, float& a1, float& a2) {
        float zh;
        const float du = top_at(c, t, zh);
        a1 = __fadd_rn(a1, du);
        a2 = fmaf(du, zh, a2);
      });
    } else {
      // dz in place, zeros past nt; dz1 when the top is layer 0.
      for (int e = tid; e < Rows * cl; e += kThreads) {
        const int c = e / Rows, t = e - c * Rows;
        float v = 0.f;
        if (t < nt) {
          float zh;
          const float du = top_at(c, t, zh);
          v = dz_of(n, cst, top, c, zh, du);
        }
        if (top > 0) {
          x[c * ldr + t] = v;
        } else if (t < nt) {
          const int64_t o = (r0 + t) * cl + c;
          if (n.bf16) {
            static_cast<__nv_bfloat16*>(n.dz1)[o] = __float2bfloat16_rn(v);
          } else {
            static_cast<float*>(n.dz1)[o] = v;
          }
        }
      }
    }

    if (target < top && top > 0) {
      __syncthreads();
      for (int i = top; i >= 1; --i) {  // x holds dz_i
        const int ci = n.width[i], cp = n.width[i - 1];
        float* f = sm + p.b_off[(i - 1) & 1];  // y_{i-1} for dW_i, then dy_{i-1}
        if (i == emit) {
          // y_{i-1} into f, zeros past nt.  Below the top only: the top
          // product's operand is still there from the forward (its rows past
          // nt meet zeros in dz).
          if (i < top && i == 1) {
            for (int e = tid; e < Rows * cp; e += kThreads) {
              const int t = e / cp, c = e - t * cp;
              f[c * ldr + t] = t < nt ? y_of(n, cst, 0, c, load_z1(n, (r0 + t) * cp + c)) : 0.f;
            }
          } else if (i < top) {
            const float* h = sm + p.h_off[i - 1];
            for (int e = tid; e < Rows * cp; e += kThreads) {
              const int c = e / Rows, t = e - c * Rows;
              f[c * ldr + t] = t < nt ? y_of(n, cst, i - 1, c, h[c * ldr + t]) : 0.f;
            }
          }
          __syncthreads();
          dw_product<Rows>(f, x, cp, ci, (nt + 3) & ~3, tile_begin, tile_end, dw_acc, p.dw_smem || ch != first);
          if (lead) {
            column_sums(0, ci, nt, sm, part_db, nullptr,
                        [&](int c, int t, float& a1, float&) { a1 = __fadd_rn(a1, x[c * ldr + t]); });
          } else {
            __syncthreads();  // f is overwritten next
          }
        }
        // dy_{i-1} = dz_i W_i^T: in the pass that sums dW_i, each slice its
        // own channels of the target (the same sums, split by column).
        const int lo = i == emit ? min(cp, static_cast<int>(blockIdx.y) * p.cps) : 0;
        const int hi = i == emit ? min(cp, lo + p.cps) : cp;
        product<Rows, MinBlocks>(n, cst, x, n.wt[i], ci, cp, sm, Epi{f, nullptr, nullptr, 0, false}, lo, hi);
        __syncthreads();
        x = f;
        const int l = i - 1;
        if (l == target) {
          const float* h = l > 0 ? sm + p.h_off[l] : nullptr;
          column_sums(lo, hi - lo, nt, sm, part, part + cp, [&](int c, int t, float& a1, float& a2) {
            const float hv = l == 0 ? load_z1(n, (r0 + t) * cp + c) : h[c * ldr + t];
            const float zh = zhat_of(n, cst, l, c, hv);
            const float du = u_of(n, cst, l, c, zh) > 0.f ? x[c * ldr + t] : 0.f;
            a1 = __fadd_rn(a1, du);
            a2 = fmaf(du, zh, a2);
          });
          break;
        }
        if (l == 0) {  // the final pass: dz1
          for (int e = tid; e < nt * cp; e += kThreads) {
            const int t = e / cp, c = e - t * cp;
            const int64_t o = (r0 + t) * cp + c;
            const float zh = zhat_of(n, cst, 0, c, load_z1(n, o));
            const float du = u_of(n, cst, 0, c, zh) > 0.f ? x[c * ldr + t] : 0.f;
            const float dz = dz_of(n, cst, 0, c, zh, du);
            if (n.bf16) {
              static_cast<__nv_bfloat16*>(n.dz1)[o] = __float2bfloat16_rn(dz);
            } else {
              static_cast<float*>(n.dz1)[o] = dz;
            }
          }
          break;
        }
        // dz_l in place; zeros in the rows past nt.
        const float* h = sm + p.h_off[l];
        for (int e = tid; e < Rows * cp; e += kThreads) {
          const int c = e / Rows, t = e - c * Rows;
          float v = 0.f;
          if (t < nt) {
            const float zh = zhat_of(n, cst, l, c, h[c * ldr + t]);
            v = dz_of(n, cst, l, c, zh, u_of(n, cst, l, c, zh) > 0.f ? x[c * ldr + t] : 0.f);
          }
          x[c * ldr + t] = v;
        }
        __syncthreads();
      }
    }
    __syncthreads();  // the next chunk overwrites h and the buffers
  }
  if (p.dw_smem) {  // each thread copies the entries it summed
    for (int e = tid; e < dw_floats; e += kThreads) part[2 * ct + e] = dw_acc[e];
  }
}

// Sums the partial slices of the blocks_x blocks of each slice in block
// order and routes each entry to S1_t (and S1_t / R in the table), S2_t
// (each from the slice that takes its channel), dW_{t+1} (from tile order)
// or db_{t+1} (the first slice).
__global__ void __launch_bounds__(kThreads)
    reduce_kernel(const __grid_constant__ Net n, int target, int blocks_x, int slices, int tps, int cps, int stride) {
  const int ct = n.width[target], emit = target + 1;
  const int ce = emit < n.layers ? n.width[emit] : 0;
  const int64_t dwf = ce ? static_cast<int64_t>(tps) * kDwTileFloats : 0;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= 2 * ct + slices * dwf + ce) return;
  int64_t slice = 0, off;
  if (e < 2 * ct) {  // S1, S2 of a channel: from the slice that takes it
    off = e;
    slice = (e % ct) / cps;
  } else if (e < 2 * ct + slices * dwf) {
    slice = (e - 2 * ct) / dwf;
    off = 2 * ct + (e - 2 * ct) % dwf;
  } else {
    off = 2 * ct + dwf + (e - 2 * ct - slices * dwf);
  }
  float sum = 0.f;
  for (int b = 0; b < blocks_x; ++b) sum = __fadd_rn(sum, n.partial[(slice * blocks_x + b) * stride + off]);
  if (e < ct) {
    n.s1[target][e] = sum;
    n.table[kS1n * n.sum_c + n.coff[target] + e] = __fdiv_rn(sum, n.rcount);
  } else if (e < 2 * ct) {
    n.s2[target][e - ct] = sum;
    n.table[kS2n * n.sum_c + n.coff[target] + e - ct] = __fdiv_rn(sum, n.rcount);
  } else if (off < 2 * ct + dwf) {
    const int f = static_cast<int>(off - 2 * ct);
    const int tile = static_cast<int>(slice) * tps + f / kDwTileFloats, rem = f % kDwTileFloats;
    const int ij = rem / kThreads, th = rem % kThreads, tiles_c = (ce + kDwSide - 1) / kDwSide;
    const int a = (tile / tiles_c) * kDwSide + th % kDwThreads + (ij / 4) * kDwThreads;
    const int c = (tile % tiles_c) * kDwSide + th / kDwThreads + (ij % 4) * kDwThreads;
    if (tile < ((ct + kDwSide - 1) / kDwSide) * tiles_c && a < ct && c < ce) n.dw[emit][a * ce + c] = sum;
  } else {
    n.db[emit][off - 2 * ct - dwf] = sum;
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  return bytes > 48 * 1024 ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                  static_cast<int>(bytes))
                           : cudaSuccess;
}

int ceil_div(int64_t a, int64_t b) { return static_cast<int>((a + b - 1) / b); }

// The blocks an SM a kernel is built for at `bytes` of shared memory: two
// where two fit the SM's 228 KB (1 KB of it reserved a block) at 32 and 64
// rows a chunk (SSG's SA1), else one (128 and 255 registers a thread).
int min_blocks(int rows, size_t bytes) { return rows >= 32 && 2 * (bytes + 1024) <= 228 * 1024 ? 2 : 1; }

// Calls f.go<Rows, MinBlocks>() for the build a launch at `Rows` rows and
// `bytes` of shared memory takes.
template <int Rows, typename F>
cudaError_t with_build(size_t bytes, const F& f) {
  if constexpr (Rows >= 32) {
    if (min_blocks(Rows, bytes) == 2) return f.template go<Rows, 2>();
  }
  return f.template go<Rows, 1>();
}

struct PoolLaunch {
  const Net& n;
  const Pass& p;
  size_t bytes;
  int blocks, segs, seg_rows;
  cudaStream_t s;
  template <int Rows, int MinBlocks>
  cudaError_t go() const {
    const cudaError_t e = set_smem(pool_kernel<Rows, MinBlocks>, bytes);
    if (e == cudaSuccess) pool_kernel<Rows, MinBlocks><<<blocks, kThreads, bytes, s>>>(n, p, segs, seg_rows, n.partial);
    return e;
  }
};

struct WalkLaunch {
  const Net& n;
  const Pass& p;
  size_t bytes;
  dim3 grid;
  cudaStream_t s;
  template <int Rows, int MinBlocks>
  cudaError_t go() const {
    const cudaError_t e = set_smem(walk_kernel<Rows, MinBlocks>, bytes);
    if (e == cudaSuccess) walk_kernel<Rows, MinBlocks><<<grid, kThreads, bytes, s>>>(n, p);
    return e;
  }
};

// Walk passes [begin, end) of one call at `Rows` rows a chunk, as the plan
// (checked by the caller) lays them out; the constants table and the pool
// pass with the first.
template <int Rows>
cudaError_t run(const Net& n, const int* plan, int begin, int end, cudaStream_t s) {
  const int consts_smem = plan[6], top = n.layers - 1;
  const int* w = n.width;
  if (begin == 0) consts_kernel<<<ceil_div(n.sum_c, kThreads), kThreads, 0, s>>>(n);
  if (begin == 0 && !n.pool_in_pass) {
    const int segs = plan[3], seg_rows = plan[4], blocks = plan[5];
    const size_t bytes = sizeof(float) * smem_floats(Rows, n.layers, w, 0, consts_smem);
    const Pass p = make_pass(n, Rows, top, 1, 0, 0, 0, 0, consts_smem);
    cudaError_t err = with_build<Rows>(bytes, PoolLaunch{n, p, bytes, blocks, segs, seg_rows, s});
    if (err != cudaSuccess) return err;
    if (segs > 1) {
      combine_kernel<<<ceil_div(n.rows / n.k * w[top], kThreads), kThreads, 0, s>>>(n, segs, n.partial);
    }
  }
  for (int j = begin; j < end; ++j) {
    const int* q = plan + kPlanHead + kPlanPass * j;
    const int target = top - j, blocks_x = q[0], slices = q[2];
    const bool with_dw = target >= 0 && target < top;
    const int tiles = with_dw ? ceil_div(w[target], kDwSide) * ceil_div(w[target + 1], kDwSide) : 0;
    const int tps = with_dw ? ceil_div(tiles, slices) : 0;
    // A slice's channels start at a multiple of 4 (16-byte W loads).
    const int ct = target >= 0 ? w[target] : 0, cps = (ceil_div(ct, slices) + 3) & ~3;
    const int stride = 2 * ct + tps * kDwTileFloats + (with_dw ? w[target + 1] : 0);
    const Pass p = make_pass(n, Rows, target, q[1], tps, cps, stride, q[3], consts_smem);
    const size_t bytes = sizeof(float) * smem_floats(Rows, n.layers, w, q[3] ? tps * kDwTileFloats : 0, consts_smem);
    const dim3 grid(blocks_x, slices);
    cudaError_t err = with_build<Rows>(bytes, WalkLaunch{n, p, bytes, grid, s});
    if (err != cudaSuccess) return err;
    if (target >= 0) {
      const int64_t total = 2 * ct + static_cast<int64_t>(slices) * tps * kDwTileFloats + (with_dw ? w[target + 1] : 0);
      reduce_kernel<<<ceil_div(total, kThreads), kThreads, 0, s>>>(n, target, blocks_x, slices, tps, cps, stride);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

// The plan's checks (ops/cuda/satrain_kernel.py: plan lays it out): true if
// this file can run it within partial_floats of scratch, every launch built
// for the blocks an SM that the plan's waves assume (plan[7]).
bool plan_ok(const Net& n, const int* plan, int plan_len, int64_t groups, int partial_floats) {
  const int rows = plan[0], chunk = plan[1], in_pass = plan[2], segs = plan[3], seg_rows = plan[4],
            pool_blocks = plan[5], consts_smem = plan[6], blocks_per_sm = plan[7];
  const int top = n.layers - 1, cl = n.width[top];
  if (plan_len != kPlanHead + kPlanPass * (n.layers + 1)) return false;
  if (rows != 4 && rows != 8 && rows != 16 && rows != 32 && rows != 64) return false;
  if (chunk < 1 || chunk > rows || (in_pass != 0 && in_pass != 1) || (consts_smem != 0 && consts_smem != 1)) return false;
  if (in_pass) {
    if (n.k > rows || chunk != rows / n.k * n.k || (rows / n.k) * cl > kSlice / 2) return false;
  } else {
    if (chunk != rows || segs < 1 || seg_rows < rows || seg_rows % rows || pool_blocks < 1) return false;
    if (static_cast<int64_t>(segs) * seg_rows < n.k || static_cast<int64_t>(segs - 1) * seg_rows >= n.k) return false;
    if (segs > 1 && groups * segs * 2 * cl > partial_floats) return false;
  }
  const size_t base = sizeof(float) * smem_floats(rows, n.layers, n.width, 0, consts_smem);
  if (base > kMaxSmem || min_blocks(rows, base) != blocks_per_sm) return false;
  const int64_t chunks = (n.rows + chunk - 1) / chunk;
  for (int j = 0; j <= n.layers; ++j) {
    const int* q = plan + kPlanHead + kPlanPass * j;
    const int target = top - j, bx = q[0], cpb = q[1], slices = q[2], dw_smem = q[3];
    if (bx < 1 || cpb < 1 || slices < 1 || slices > 65535) return false;
    if (static_cast<int64_t>(bx) * cpb < chunks || static_cast<int64_t>(bx - 1) * cpb >= chunks) return false;
    const bool with_dw = target >= 0 && target < top;
    int dwf = 0;
    if (with_dw) {
      const int tiles = ceil_div(n.width[target], kDwSide) * ceil_div(n.width[target + 1], kDwSide);
      if (slices > tiles) return false;
      const int tps = ceil_div(tiles, slices);
      if ((slices - 1) * tps >= tiles) return false;
      dwf = tps * kDwTileFloats;
    } else if (slices != 1 || dw_smem) {
      return false;
    }
    if (target >= 0) {
      const int64_t stride = 2 * n.width[target] + dwf + (with_dw ? n.width[target + 1] : 0);
      if (static_cast<int64_t>(bx) * slices * stride > partial_floats) return false;
    }
    const size_t bytes = sizeof(float) * smem_floats(rows, n.layers, n.width, dw_smem ? dwf : 0, consts_smem);
    if (bytes > kMaxSmem || min_blocks(rows, bytes) != blocks_per_sm) return false;
  }
  return true;
}

}  // namespace

// z1 [groups * k, C0] (bf16 when bf16 != 0, else f32), d_pooled [groups,
// C_{L-1}] f32; widths [n_layers] (host); ptrs (host) holds device
// pointers, per layer i < L: mean, r = rsqrt(var + eps), gamma, beta, dbeta
// (out), dgamma (out); then per layer 1 <= i < L: W rounded to the compute
// dtype [C_{i-1}, C_i], W^T f32 [C_i, C_{i-1}], b, dW (out), db (out).
// plan [plan_len] (host): the launch plan, refused (cudaErrorInvalidValue)
// if this file cannot run it.  pooled, share: scratch [groups, C_{L-1}]
// f32; table: scratch [7, sum of the widths] f32; partial: scratch of
// partial_floats f32.  Writes dz1 [groups * k, C0] in the compute dtype.
// Runs walk passes [pass_begin, pass_end) of the L + 1 (pass j sums layer
// L-1-j's S1, S2; pass L writes dz1), the constants and the pool pass with
// pass 0: a caller that runs the passes one call at a time keeps pooled,
// share, table and partial between the calls and may rewrite the table's
// S1/R and S2/R rows of the layer a call summed (a process group's sums).
extern "C" int satrain_bwd_launch(const void* z1, const void* d_pooled, int groups, int k, int bf16,
                                  int pool_f32, int n_layers, const int* widths, const void* const* ptrs,
                                  const int* plan, int plan_len, void* pooled, void* share, void* table,
                                  void* partial, int partial_floats, void* dz1, int pass_begin, int pass_end,
                                  void* stream) {
  if (groups < 1 || k < 1 || n_layers < 1 || n_layers > kMaxLayers || plan_len < kPlanHead) {
    return cudaErrorInvalidValue;
  }
  if (pass_begin < 0 || pass_begin >= pass_end || pass_end > n_layers + 1) return cudaErrorInvalidValue;
  Net n{};
  n.layers = n_layers;
  n.bf16 = bf16;
  n.pool_f32 = pool_f32;
  n.k = k;
  n.chunk_rows = plan[1];
  n.pool_in_pass = plan[2];
  n.rows = static_cast<int64_t>(groups) * k;
  n.rcount = static_cast<float>(n.rows);
  n.z1 = z1;
  n.dpool = static_cast<const float*>(d_pooled);
  n.pooled = static_cast<float*>(pooled);
  n.share = static_cast<float*>(share);
  n.table = static_cast<float*>(table);
  n.partial = static_cast<float*>(partial);
  n.dz1 = dz1;
  for (int i = 0; i < n_layers; ++i) {
    if (widths[i] < 1 || widths[i] > kMaxWidth) return cudaErrorInvalidValue;
    n.width[i] = widths[i];
    n.coff[i] = n.sum_c;
    n.sum_c += widths[i];
    const void* const* p = ptrs + 6 * i;
    n.mean[i] = static_cast<const float*>(p[0]);
    n.r[i] = static_cast<const float*>(p[1]);
    n.gamma[i] = static_cast<const float*>(p[2]);
    n.beta[i] = static_cast<const float*>(p[3]);
    n.s1[i] = static_cast<float*>(const_cast<void*>(p[4]));
    n.s2[i] = static_cast<float*>(const_cast<void*>(p[5]));
  }
  for (int i = 1; i < n_layers; ++i) {
    const void* const* p = ptrs + 6 * n_layers + 5 * (i - 1);
    n.wcd[i] = static_cast<const float*>(p[0]);
    n.wt[i] = static_cast<const float*>(p[1]);
    n.bias[i] = static_cast<const float*>(p[2]);
    n.dw[i] = static_cast<float*>(const_cast<void*>(p[3]));
    n.db[i] = static_cast<float*>(const_cast<void*>(p[4]));
  }
  if (!plan_ok(n, plan, plan_len, groups, partial_floats)) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (plan[0]) {
    case 64: return run<64>(n, plan, pass_begin, pass_end, s);
    case 32: return run<32>(n, plan, pass_begin, pass_end, s);
    case 16: return run<16>(n, plan, pass_begin, pass_end, s);
    case 8: return run<8>(n, plan, pass_begin, pass_end, s);
    default: return run<4>(n, plan, pass_begin, pass_end, s);
  }
}

namespace {

template <typename K>
cudaError_t kernel_info(K kernel, size_t smem, int* info) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) err = set_smem(kernel, smem);
  int blocks = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = static_cast<int>(smem);
  info[3] = blocks;
  return err;
}

struct Info {
  int walk;
  size_t smem;
  int* info;
  template <int Rows, int MinBlocks>
  cudaError_t go() const {
    return walk ? kernel_info(walk_kernel<Rows, MinBlocks>, smem, info)
                : kernel_info(pool_kernel<Rows, MinBlocks>, smem, info);
  }
};

}  // namespace

// info = {registers a thread, local-memory bytes a thread, dynamic shared
// bytes, resident blocks per SM} of walk_kernel (walk != 0) or pool_kernel,
// built as a launch picks it at `rows` rows a chunk and the shared memory of
// these widths, a dW accumulator of dw_floats there and the constants there
// or not.
extern "C" int satrain_info(int rows, int n_layers, const int* widths, int dw_floats, int consts_smem, int walk,
                            int* info) {
  if (n_layers < 1 || n_layers > kMaxLayers) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * smem_floats(rows, n_layers, widths, dw_floats, consts_smem);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  switch (rows) {
    case 64: return with_build<64>(smem, Info{walk, smem, info});
    case 32: return with_build<32>(smem, Info{walk, smem, info});
    case 16: return with_build<16>(smem, Info{walk, smem, info});
    case 8: return with_build<8>(smem, Info{walk, smem, info});
    case 4: return with_build<4>(smem, Info{walk, smem, info});
    default: return cudaErrorInvalidValue;
  }
}
