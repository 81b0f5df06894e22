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
//   pool pass     each group's max and tie count of the last layer's y, from
//                 this kernel's own recompute (a cuBLAS forward rounds
//                 otherwise, and a winner compared across the two would
//                 shatter the tie mask);
//   pass j        (j = L-1 .. 0) recompute the chain, take the pool backward
//                 (ties split evenly), walk down through the layers whose
//                 sums are known, and sum S1_j, S2_j; the pass that walks
//                 through layer j+1 also sums dW_{j+1} and db_{j+1};
//   final pass    walk down to layer 0 and write dz1.
// Nothing [B, M, K, C]-sized is written between the passes: each recomputes
// its rows from z1 in shared memory.  The merged two-layers-a-pass algebra
// of the TPU kernel is later work.
//
// Precision follows _bwd_xla: the recompute rounds matmul operands and h, y
// to the compute dtype (bf16 or f32) as the forward does, but the last
// layer under pool mode "1" (f32); the gradient walk (dy = dz W^T, dW = y^T
// dz) runs in f32 on the CUDA cores, no TF32; relu'(0) = 0.
//
// Deterministic sums: a pass's blocks each own a contiguous range of rows
// and write their partial sums (S1, S2, dW, db) to their own slice of a
// buffer, which reduce_kernel sums over the blocks in a fixed order.  No
// float atomics.  A block accumulates its dW slice in place in that buffer
// (each entry always by the same thread).  The slice is C_j * C_{j+1}
// floats, so the wrapper's buffer (ops/cuda/satrain_kernel.py, 64 MiB)
// bounds the number of blocks of a pass: at SSG SA2's dW_2 (128 x 256) 482
// blocks of 272 rows, at SSG group-all's dW_2 (512 x 1024) 27 of 78.
//
// Bound: operations.  Each pass recomputes the whole forward chain of its
// rows (2 C_{i-1} C_i operations a row and layer) and walks the backward
// down to its target; at SSG SA2 (B=16: 131072 rows, 128-128-256) the five
// passes do about 100 GFLOP, 1.5 ms at the card's 67 TFLOP/s f32 rate.
// Each block takes chunks of up to 16 rows through the layers, h_i of every
// layer kept in shared memory; a thread owns a tile of up to 16 rows by 4
// columns of a product (registers), reading each weight quad from global
// memory (L2) once for those rows, and a 4 x 4 tile of its dW slice.  The
// pool pass splits a group into segments when there are few groups
// (group-all: 16 at B=16), combined by combine_kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLayers = 4;
constexpr int kMaxWidth = 1024;                    // channels of a layer
constexpr int kPerThread = kMaxWidth / kThreads;   // channels a thread owns
constexpr int kMaxChunk = 16;                      // rows a chunk
constexpr int kMaxBlocks = 8 * 132;                // blocks of a sum pass
constexpr size_t kSmemBudget = 200 * 1024;

struct Net {
  int layers, bf16, pool_f32, k, chunk;
  int width[kMaxLayers];
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
  float* pooled;   // [groups, C_{L-1}]
  float* cnt;      // [groups, C_{L-1}]
  float* partial;  // [blocks, stride]
  void* dz1;       // [rows, C0], compute dtype
};

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ float cd(const Net& n, float v) {
  return n.bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

__device__ __forceinline__ float zhat_of(const Net& n, int i, int c, float h) {
  return __fmul_rn(__fsub_rn(h, n.mean[i][c]), n.r[i][c]);
}

__device__ __forceinline__ float u_of(const Net& n, int i, int c, float zh) {
  return __fadd_rn(__fmul_rn(zh, n.gamma[i][c]), n.beta[i][c]);
}

// y_i = relu(u_i) in the compute dtype; the last layer stays f32 under pool
// mode "1".
__device__ __forceinline__ float y_of(const Net& n, int i, int c, float h) {
  const float u = u_of(n, i, c, zhat_of(n, i, c, h));
  const float y = u < 0.f ? 0.f : u;
  return i == n.layers - 1 && n.pool_f32 ? y : cd(n, y);
}

// out[t][c] = epi(c, sum over k of in[t][k] * w[k][c]) for t < nt; in [nt,
// cin] and out [nt, cout] in shared memory, w [cin, cout] in global memory.
// A thread owns a tile of up to kMaxChunk rows by 4 adjacent columns, its
// sums in registers: each input read from shared memory feeds 4 products,
// each weight quad read once feeds the tile's rows.  Every sum runs over k
// in ascending order.
template <typename Epi>
__device__ __forceinline__ void matmul(const float* in, int cin, const float* __restrict__ w, int cout,
                                       float* out, int nt, Epi epi) {
  const int quads = (cout + 3) / 4;
  const int rg = quads >= kThreads ? 1 : min(kThreads / quads, nt);
  const int tr = (nt + rg - 1) / rg;
  const bool vec = cout % 4 == 0;  // 16-byte weight rows
  for (int item = threadIdx.x; item < quads * rg; item += kThreads) {
    const int c0 = (item % quads) * 4;
    const int t0 = (item / quads) * tr;
    const int rows = min(tr, nt - t0);
    if (rows <= 0) continue;
    float acc[kMaxChunk][4];
#pragma unroll
    for (int t = 0; t < kMaxChunk; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
    for (int kk = 0; kk < cin; ++kk) {
      const float* wr = w + static_cast<size_t>(kk) * cout + c0;
      float wv[4];
      if (vec) {
        const float4 q = *reinterpret_cast<const float4*>(wr);
        wv[0] = q.x, wv[1] = q.y, wv[2] = q.z, wv[3] = q.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = c0 + j < cout ? wr[j] : 0.f;
      }
#pragma unroll
      for (int t = 0; t < kMaxChunk; ++t) {
        if (t < rows) {
          const float a = in[(t0 + t) * cin + kk];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[t][j] = fmaf(a, wv[j], acc[t][j]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kMaxChunk; ++t) {
      if (t < rows) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (c0 + j < cout) out[(t0 + t) * cout + c0 + j] = epi(c0 + j, acc[t][j]);
        }
      }
    }
  }
}

// Shared memory: h_i [chunk, C_i] for every layer, then two buffers
// [chunk, Cmax].
struct Smem {
  float* h[kMaxLayers];
  float* a;
  float* b;
};

__device__ __forceinline__ Smem carve(const Net& n, float* base) {
  Smem s;
  int cmax = 0;
  for (int i = 0; i < n.layers; ++i) {
    s.h[i] = base;
    base += n.chunk * n.width[i];
    cmax = max(cmax, n.width[i]);
  }
  s.a = base;
  s.b = base + n.chunk * cmax;
  return s;
}

// Recompute h_0 .. h_{L-1} of rows [r0, r0 + nt) (the forward chain).
__device__ void forward_chunk(const Net& n, const Smem& s, int64_t r0, int nt) {
  const int c0 = n.width[0];
  for (int e = threadIdx.x; e < nt * c0; e += kThreads) {
    const int64_t g = r0 * c0 + e;
    s.h[0][e] = n.bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(n.z1)[g])
                       : static_cast<const float*>(n.z1)[g];
  }
  __syncthreads();
  for (int i = 1; i < n.layers; ++i) {
    const int cin = n.width[i - 1], cout = n.width[i];
    for (int e = threadIdx.x; e < nt * cin; e += kThreads) s.a[e] = y_of(n, i - 1, e % cin, s.h[i - 1][e]);
    __syncthreads();
    const bool round = !(i == n.layers - 1 && n.pool_f32);
    const float* bias = n.bias[i];
    matmul(s.a, cin, n.wcd[i], cout, s.h[i], nt, [&](int c, float acc) {
      const float h = __fadd_rn(acc, bias[c]);
      return round ? cd(n, h) : h;
    });
    __syncthreads();
  }
}

// The max of the last layer's y over each group's K rows and the number of
// rows that reach it.  A block takes one segment of a group (`seg_rows`
// rows, whole chunks; a group of `segs` segments) at a time.  With one
// segment a group it writes pooled and cnt; else the segment's (max, count)
// go to `part` [groups * segs, 2, C] for combine_kernel.
__global__ void __launch_bounds__(kThreads)
    pool_kernel(const __grid_constant__ Net n, int segs, int seg_rows, float* part) {
  extern __shared__ __align__(16) float smem[];
  const Smem s = carve(n, smem);
  const int last = n.layers - 1, cl = n.width[last];
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
    for (int j0 = j_begin; j0 < j_end; j0 += n.chunk) {
      const int nt = min(n.chunk, j_end - j0);
      forward_chunk(n, s, g * n.k + j0, nt);
#pragma unroll
      for (int q = 0; q < kPerThread; ++q) {
        const int c = threadIdx.x + q * kThreads;
        if (c >= cl) break;
        for (int t = 0; t < nt; ++t) {
          const float y = y_of(n, last, c, s.h[last][t * cl + c]);
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
        n.cnt[g * cl + c] = count[q];
      } else {
        part[(u * 2) * cl + c] = best[q];
        part[(u * 2 + 1) * cl + c] = count[q];
      }
    }
  }
}

// Each (group, channel)'s segments combined in order: the largest max, and
// the counts of the segments that reach it summed.
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
  n.cnt[e] = count;
}

// One pass of the walk.  target >= 0: the block's partial sums of S1, S2
// of layer `target` and, when target + 1 < L, of dW and db of layer
// target + 1, into its slice [2 C_t | C_t C_{t+1} | C_{t+1}] of the partial
// buffer.  target < 0: dz1.  The block takes rows [blockIdx.x *
// rows_per_block, ...).
__global__ void __launch_bounds__(kThreads)
    walk_kernel(const __grid_constant__ Net n, int target, int64_t rows_per_block, int stride) {
  extern __shared__ __align__(16) float smem[];
  const Smem s = carve(n, smem);
  const int last = n.layers - 1;
  const int64_t r_begin = blockIdx.x * rows_per_block;
  const int64_t r_end = min(n.rows, r_begin + rows_per_block);
  const int emit = target + 1;
  const bool with_dw = target >= 0 && emit <= last;
  const int ct = target >= 0 ? n.width[target] : 0;
  float* part = n.partial + static_cast<int64_t>(blockIdx.x) * stride;
  float* part_dw = part + 2 * ct;
  const int dw_len = with_dw ? ct * n.width[emit] : 0;
  float s1[kPerThread], s2[kPerThread], dbs[kPerThread];
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) s1[q] = s2[q] = dbs[q] = 0.f;

  for (int64_t r0 = r_begin; r0 < r_end; r0 += n.chunk) {
    const int nt = static_cast<int>(min(static_cast<int64_t>(n.chunk), r_end - r0));
    forward_chunk(n, s, r0, nt);
    // Pool backward: the cotangent split evenly over each group's winners.
    const int cl = n.width[last];
    for (int e = threadIdx.x; e < nt * cl; e += kThreads) {
      const int c = e % cl;
      const int64_t pc = ((r0 + e / cl) / n.k) * cl + c;
      const float y = y_of(n, last, c, s.h[last][e]);
      s.a[e] = y == n.pooled[pc] ? __fmul_rn(__fdiv_rn(1.f, n.cnt[pc]), n.dpool[pc]) : 0.f;
    }
    __syncthreads();
    float* dy = s.a;
    float* other = s.b;
    for (int i = last;; --i) {
      const int ci = n.width[i];
      if (i == target) {
#pragma unroll
        for (int q = 0; q < kPerThread; ++q) {
          const int c = threadIdx.x + q * kThreads;
          if (c >= ci) break;
          for (int t = 0; t < nt; ++t) {
            const float zh = zhat_of(n, i, c, s.h[i][t * ci + c]);
            const float du = u_of(n, i, c, zh) > 0.f ? dy[t * ci + c] : 0.f;
            s1[q] = __fadd_rn(s1[q], du);
            s2[q] = fmaf(du, zh, s2[q]);
          }
        }
        break;
      }
      // dz_i = r gamma ((du - S1/R) - zhat S2/R), in place.
      for (int e = threadIdx.x; e < nt * ci; e += kThreads) {
        const int c = e % ci;
        const float zh = zhat_of(n, i, c, s.h[i][e]);
        const float du = u_of(n, i, c, zh) > 0.f ? dy[e] : 0.f;
        const float s1n = __fdiv_rn(n.s1[i][c], n.rcount), s2n = __fdiv_rn(n.s2[i][c], n.rcount);
        const float coef = __fmul_rn(n.r[i][c], n.gamma[i][c]);
        dy[e] = __fmul_rn(coef, __fsub_rn(__fsub_rn(du, s1n), __fmul_rn(zh, s2n)));
      }
      __syncthreads();
      if (i == 0) {  // the final pass
        const int64_t base = r0 * ci;
        for (int e = threadIdx.x; e < nt * ci; e += kThreads) {
          if (n.bf16) {
            static_cast<__nv_bfloat16*>(n.dz1)[base + e] = __float2bfloat16_rn(dy[e]);
          } else {
            static_cast<float*>(n.dz1)[base + e] = dy[e];
          }
        }
        break;
      }
      const int cp = n.width[i - 1];
      if (with_dw && i == emit) {
        for (int e = threadIdx.x; e < nt * cp; e += kThreads) other[e] = y_of(n, i - 1, e % cp, s.h[i - 1][e]);
        __syncthreads();
        // dW_i += y_{i-1}^T dz_i: a thread owns a 4 x 4 tile of the block's
        // slice, always the same one, summed over the rows in order.
        const int kq = (cp + 3) / 4, cq = (ci + 3) / 4;
        for (int item = threadIdx.x; item < kq * cq; item += kThreads) {
          const int k0 = (item / cq) * 4, c0 = (item % cq) * 4;
          float acc[4][4];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              acc[a][b] = r0 == r_begin || k0 + a >= cp || c0 + b >= ci ? 0.f : part_dw[(k0 + a) * ci + c0 + b];
            }
          }
          for (int t = 0; t < nt; ++t) {
            float yv[4], dv[4];
#pragma unroll
            for (int a = 0; a < 4; ++a) yv[a] = k0 + a < cp ? other[t * cp + k0 + a] : 0.f;
#pragma unroll
            for (int b = 0; b < 4; ++b) dv[b] = c0 + b < ci ? dy[t * ci + c0 + b] : 0.f;
#pragma unroll
            for (int a = 0; a < 4; ++a) {
#pragma unroll
              for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(yv[a], dv[b], acc[a][b]);
            }
          }
#pragma unroll
          for (int a = 0; a < 4; ++a) {
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              if (k0 + a < cp && c0 + b < ci) part_dw[(k0 + a) * ci + c0 + b] = acc[a][b];
            }
          }
        }
#pragma unroll
        for (int q = 0; q < kPerThread; ++q) {
          const int c = threadIdx.x + q * kThreads;
          if (c >= ci) break;
          for (int t = 0; t < nt; ++t) dbs[q] = __fadd_rn(dbs[q], dy[t * ci + c]);
        }
        __syncthreads();
      }
      // dy_{i-1} = dz_i W_i^T.
      matmul(dy, ci, n.wt[i], cp, other, nt, [](int, float acc) { return acc; });
      __syncthreads();
      float* tmp = dy;
      dy = other;
      other = tmp;
    }
    __syncthreads();  // the next chunk overwrites h and the buffers
  }
  if (target < 0) return;
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int c = threadIdx.x + q * kThreads;
    if (c < ct) {
      part[c] = s1[q];
      part[ct + c] = s2[q];
    }
    if (with_dw && c < n.width[emit]) part_dw[dw_len + c] = dbs[q];
  }
}

// Sums the partial slices of `blocks` blocks in block order and routes each
// entry to S1_t, S2_t, dW_{t+1} or db_{t+1}.
__global__ void __launch_bounds__(kThreads)
    reduce_kernel(const __grid_constant__ Net n, int target, int blocks, int stride) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= stride) return;
  float sum = 0.f;
  for (int b = 0; b < blocks; ++b) sum = __fadd_rn(sum, n.partial[static_cast<int64_t>(b) * stride + e]);
  const int ct = n.width[target];
  if (e < ct) {
    n.s1[target][e] = sum;
  } else if (e < 2 * ct) {
    n.s2[target][e - ct] = sum;
  } else {
    const int f = e - 2 * ct, ce = n.width[target + 1];
    if (f < ct * ce) {
      n.dw[target + 1][f] = sum;
    } else {
      n.db[target + 1][f - ct * ce] = sum;
    }
  }
}

}  // namespace

// z1 [groups * k, C0] (bf16 when bf16 != 0, else f32), d_pooled [groups,
// C_{L-1}] f32; widths [n_layers] (host); ptrs (host) holds device
// pointers, per layer i < L: mean, r = rsqrt(var + eps), gamma, beta, dbeta
// (out), dgamma (out); then per layer 1 <= i < L: W rounded to the compute
// dtype [C_{i-1}, C_i], W^T f32 [C_i, C_{i-1}], b, dW (out), db (out).
// pooled, cnt: scratch [groups, C_{L-1}] f32; partial: scratch of
// partial_floats f32.  Writes dz1 [groups * k, C0] in the compute dtype.
extern "C" int satrain_bwd_launch(const void* z1, const void* d_pooled, int groups, int k, int bf16,
                                  int pool_f32, int n_layers, const int* widths,
                                  const void* const* ptrs, void* pooled, void* cnt, void* partial,
                                  int partial_floats, void* dz1, void* stream) {
  if (groups < 1 || k < 1 || n_layers < 1 || n_layers > kMaxLayers) return cudaErrorInvalidValue;
  Net n{};
  n.layers = n_layers;
  n.bf16 = bf16;
  n.pool_f32 = pool_f32;
  n.k = k;
  n.rows = static_cast<int64_t>(groups) * k;
  n.rcount = static_cast<float>(n.rows);
  n.z1 = z1;
  n.dpool = static_cast<const float*>(d_pooled);
  n.pooled = static_cast<float*>(pooled);
  n.cnt = static_cast<float*>(cnt);
  n.partial = static_cast<float*>(partial);
  n.dz1 = dz1;
  int sum_c = 0, cmax = 0;
  for (int i = 0; i < n_layers; ++i) {
    if (widths[i] < 1 || widths[i] > kMaxWidth) return cudaErrorInvalidValue;
    n.width[i] = widths[i];
    sum_c += widths[i];
    cmax = std::max(cmax, widths[i]);
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
  const size_t row_bytes = sizeof(float) * static_cast<size_t>(sum_c + 2 * cmax);
  n.chunk = static_cast<int>(std::min(static_cast<size_t>(kMaxChunk), kSmemBudget / row_bytes));
  if (n.chunk < 1) return cudaErrorInvalidValue;
  const size_t smem = row_bytes * n.chunk;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(pool_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
    }
    if (err != cudaSuccess) return err;
  }
  auto s = static_cast<cudaStream_t>(stream);
  const int64_t chunks = (n.rows + n.chunk - 1) / n.chunk;
  // The pool pass: a group's chunks split into segments when there are too
  // few groups to fill the card (group-all), the segments' partials in the
  // (still unused) partial buffer.
  const int group_chunks = (k + n.chunk - 1) / n.chunk;
  int segs = std::min(group_chunks, std::max(1, (kMaxBlocks + groups - 1) / groups));
  if (static_cast<int64_t>(groups) * segs * 2 * widths[n_layers - 1] > partial_floats) segs = 1;
  const int seg_rows = ((group_chunks + segs - 1) / segs) * n.chunk;
  segs = (k + seg_rows - 1) / seg_rows;
  const int64_t units = static_cast<int64_t>(groups) * segs;
  pool_kernel<<<static_cast<unsigned>(std::min<int64_t>(units, kMaxBlocks)), kThreads, smem, s>>>(
      n, segs, seg_rows, n.partial);
  if (segs > 1) {
    const int64_t cells = static_cast<int64_t>(groups) * widths[n_layers - 1];
    combine_kernel<<<static_cast<unsigned>((cells + kThreads - 1) / kThreads), kThreads, 0, s>>>(n, segs,
                                                                                                 n.partial);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  for (int j = n_layers - 1; j >= 0; --j) {
    const int stride = 2 * widths[j] + (j + 1 < n_layers ? widths[j] * widths[j + 1] + widths[j + 1] : 0);
    int64_t blocks = std::min<int64_t>({kMaxBlocks, chunks, partial_floats / stride});
    if (blocks < 1) return cudaErrorInvalidValue;
    // Whole chunks a block, spread evenly; the last blocks may get fewer.
    const int64_t rows_per_block = ((chunks + blocks - 1) / blocks) * n.chunk;
    blocks = (n.rows + rows_per_block - 1) / rows_per_block;
    walk_kernel<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(n, j, rows_per_block, stride);
    reduce_kernel<<<(stride + kThreads - 1) / kThreads, kThreads, 0, s>>>(n, j, static_cast<int>(blocks), stride);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  walk_kernel<<<static_cast<unsigned>(chunks), kThreads, smem, s>>>(n, -1, n.chunk, 0);
  return cudaGetLastError();
}
