// The fused SA layer's bf16 MLP on the tensor cores: a study, not part of
// the package, which keeps f32 FMA in bf16 (csrc/sapool.cuh says why).
//
// studies/sa_mma.py compiles csrc/safused.cu (#3, #10) and csrc/sabucket.cu
// (#4) with this header pre-included (nvcc --pre-include, -I csrc).  It
// includes sapool.cuh first, so the sources' own include of it is a no-op,
// then specialises mlp_pool (for kernels built for two and three blocks an
// SM) and plan_mlp_pool for __nv_bfloat16, which every bf16 kernel and
// launch of the two sources instantiates: the MLP below and a planner that
// sizes its shared memory.  The f32 instantiations are the package's
// register-tiled FMA kernel.
//
// Each layer's rows x columns product runs mma.sync m16n8k16, bf16
// operands, f32 accumulators, as the TPU kernel's MXU dots with
// preferred_element_type f32.  Everything around the product is kept: the
// staged rows [c3 | feat[idx]] (bf16 already, so stored as bf16: c3 in
// columns 0-15, zero-padded from 3, the features from column 16), layer 0's
// two separate sums feats.W0f (or the prelifted rows) and c3.W0x added
// afterwards, relu(acc + b) rounded to bf16 between layers, and the last
// layer's max per (query, column), carried across 64-slot chunks at K > 64.
// A (query, slot) row sits in row ql * ns + s of the 64-row tile in both #3
// and #4, and an mma output element depends only on its own row and column,
// so #4 keeps #3's bits.

#pragma once

#include "sapool.cuh"

namespace {

// A block's 64-row tile (4 m16 tiles) is multiplied by 8 warps, 2 along
// the rows (2 m16 tiles each) by 4 along the columns; a pass covers up to
// 128 columns, a warp taking the column pairs (n8 tiles 2p, 2p + 1) with
// p = warp_n + 4 jj, jj < 2, so its accumulators take 32 registers and,
// under sa_mma.py's -maxrregcount=80, three blocks share an SM (the ball
// scan of one hides behind the products of the others).  Every width is padded to 16 with zeros (the
// padded weights and activations are exact zeros).  W is staged in shared
// memory in slices of kWSlice rows (16-byte loads where its rows allow) and
// read with ldmatrix.trans; the activation tiles with ldmatrix.  Row
// strides of 16 j + 8 bf16 put the 8 rows of an 8x8 ldmatrix read on
// different banks.  The last layer's relu(acc + b) >= 0 (or -0, or NaN,
// which fmaxf turns into 0), so its max per (query, column) is an integer
// atomicMax of the f32 bits in shared memory, exact in any order.
constexpr int kMmaRows = 64;   // = kMaxRows: the tile's rows
constexpr int kWSlice = 64;    // W rows a staged slice
constexpr int kNPass = 128;    // output columns a pass
constexpr int kPairs = kNPass / 64;  // column pairs a warp in a pass

__host__ __device__ __forceinline__ int pad16(int x) { return (x + 15) & ~15; }

// The row strides of the two activation tiles and of the staged W slice,
// from the shapes alone (the host's plan and every block compute them alike).
struct Strides {
  int lda, ldb, ldw;
};

__host__ __device__ __forceinline__ Strides mma_strides(const Args& a, const Layers& L) {
  int wa = 16 + pad16(a.cs), wb = 16, nc = 16;
  for (int l = 0; l < L.n; ++l) {
    nc = max(nc, min(kNPass, pad16(L.width[l])));
    if (l + 1 < L.n) {
      int& w = (l % 2 == 0) ? wb : wa;
      w = max(w, pad16(L.width[l]));
    }
  }
  return {wa + 8, wb + 8, nc + 8};
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices; lane l gives the address of row l & 7 of matrix l >> 3.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a (16x16, row) x b (16x8, col), bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of the m16 tile at row m0, columns [k0, k0 + 16) of a
// row-major bf16 tile with row stride ld.
__device__ __forceinline__ void load_a(uint32_t (&r)[4], const __nv_bfloat16* t, int ld, int m0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(r, t + (m0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}

// The B fragments of n8 tiles n0 and n0 + 8, rows [k0, k0 + 16) of a
// row-major [k][n] bf16 slice with row stride ld: r[0..1] and r[2..3].
__device__ __forceinline__ void load_b2(uint32_t (&r)[4], const __nv_bfloat16* w, int ld, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_trans(r, w + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 + (lane >> 4) * 8);
}

// Rows [k0, k0 + ks) and columns [n0, n0 + nc) of W [krows, cout] into ws
// [ks][ld], zeros past W's edges.  Every thread of the block must call it.
__device__ __forceinline__ void stage_w(const __nv_bfloat16* __restrict__ w, int krows, int cout, int k0,
                                        int ks, int n0, int nc, __nv_bfloat16* ws, int ld) {
  const int tid = threadIdx.x;
  if (cout % 8 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0) {
    const int vpr = nc / 8;  // 16-byte vectors a row
    for (int e = tid; e < ks * vpr; e += kThreads) {
      const int kk = e / vpr, nn = (e - kk * vpr) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + kk < krows && n0 + nn < cout)
        v = *reinterpret_cast<const uint4*>(w + static_cast<size_t>(k0 + kk) * cout + n0 + nn);
      *reinterpret_cast<uint4*>(ws + kk * ld + nn) = v;
    }
  } else {
    for (int e = tid; e < ks * nc; e += kThreads) {
      const int kk = e / nc, nn = e - kk * nc;
      ws[kk * ld + nn] = (k0 + kk < krows && n0 + nn < cout)
                             ? w[static_cast<size_t>(k0 + kk) * cout + n0 + nn]
                             : __float2bfloat16_rn(0.f);
    }
  }
}

// acc += in[:, col0 + k] x W[k, n0 + n] over k < kpad (a multiple of 16; W
// has krows real rows), for the warp's tiles.  Stages W slice by slice in
// ws; every thread of the block must call it.
__device__ __forceinline__ void mma_sums(const __nv_bfloat16* in, int ld, int col0, int kpad,
                                         const __nv_bfloat16* __restrict__ w, int krows, int cout, int n0,
                                         int nc, __nv_bfloat16* ws, int ldw, int rows,
                                         float (&acc)[2][kPairs][2][4]) {
  const int warp = threadIdx.x >> 5, warp_m = warp & 1, warp_n = warp >> 1;
  for (int k0 = 0; k0 < kpad; k0 += kWSlice) {
    const int ks = min(kWSlice, kpad - k0);
    __syncthreads();  // every warp is done with the last slice
    stage_w(w, krows, cout, k0, ks, n0, nc, ws, ldw);
    __syncthreads();
    for (int kb = 0; kb < ks; kb += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int mt = warp_m * 2 + mi;
        if (mt * 16 < rows) load_a(af[mi], in, ld, mt * 16, col0 + k0 + kb);
      }
#pragma unroll
      for (int jj = 0; jj < kPairs; ++jj) {
        const int pn = (warp_n + 4 * jj) * 16;
        if (pn >= nc) continue;
        uint32_t bf[4];
        load_b2(bf, ws, ldw, kb, pn);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          if ((warp_m * 2 + mi) * 16 >= rows) continue;
          mma_bf16(acc[mi][jj][0], af[mi], bf[0], bf[1]);
          mma_bf16(acc[mi][jj][1], af[mi], bf[2], bf[3]);
        }
      }
    }
  }
}

// Steps 2-4 of mlp_pool for bf16, on the tensor cores (above).  buf: the
// floats plan_mlp_pool<__nv_bfloat16> counts, aligned here to 16 bytes: the
// activation tiles A [64][lda] (staged rows, odd layers) and B [64][ldb]
// (even layers), the W slice [kWSlice][ldw], W0x [16][ldw], the pool
// [qpb][Cout].
__device__ __forceinline__ void mma_mlp_pool(const Args& a, const Layers& L, const int* sidx, const int* qrow,
                                             float* buf) {
  using bf16 = __nv_bfloat16;
  const Strides st = mma_strides(a, L);
  const int k = a.k, qpb = a.qpb;
  const int kc = min(k, kMaxRows);
  const int b = blockIdx.y, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp & 1, warp_n = warp >> 1, g = lane >> 2, tq = lane & 3;
  bf16* tile_a = reinterpret_cast<bf16*>((reinterpret_cast<uintptr_t>(buf) + 15) & ~static_cast<uintptr_t>(15));
  bf16* tile_b = tile_a + kMmaRows * st.lda;
  bf16* ws = tile_b + kMmaRows * st.ldb;
  bf16* wx = ws + kWSlice * st.ldw;
  int* pool = reinterpret_cast<int*>(wx + 16 * st.ldw);
  const float* cloud = a.ball ? a.xyz + static_cast<size_t>(b) * a.n * 3 : nullptr;
  const bf16* src = static_cast<const bf16*>(a.src);
  const bf16* w0x = static_cast<const bf16*>(a.w0x);
  const bf16* w0f = static_cast<const bf16*>(a.w0f);
  const int l_last = L.n - 1, cout_last = L.width[l_last];
  const int cs_pad = pad16(a.cs);
  bf16* pooled = static_cast<bf16*>(a.pooled);
  const bool vec_src = a.cs % 8 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0;

  for (int s0 = 0; s0 < k; s0 += kc) {
    const int ns = min(kc, k - s0), rows = qpb * ns;
    if (s0 == 0)
      for (int t = tid; t < qpb * cout_last; t += kThreads) pool[t] = 0;  // the bits of +0.f

    // 2. Stage the rows: c3 (bf16) in columns 0-2, zeros to 15; the source
    //    rows from column 16, zeros to 16 + cs_pad; zero rows past `rows`.
    for (int e = tid; e < kMmaRows * 16; e += kThreads) {
      const int r0 = e >> 4, j = e & 15;
      float v = 0.f;
      if (r0 < rows && j < 3) {
        const int ql = r0 / ns;
        const size_t bq = static_cast<size_t>(b) * a.m + max(qrow[ql], 0);
        if (a.ball) {
          v = cloud[3 * sidx[s0 + r0] + j] - a.new_xyz[bq * 3 + j];
        } else if (a.grouped) {
          v = a.grouped[(bq * k + s0 + r0 - ql * ns) * 3 + j];
        }
      }
      tile_a[r0 * st.lda + j] = __float2bfloat16_rn(v);
    }
    if (vec_src) {
      const int vpr = cs_pad / 8;
      for (int e = tid; e < kMmaRows * vpr; e += kThreads) {
        const int r0 = e / vpr, col = (e - r0 * vpr) * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (r0 < rows && col < a.cs)
          v = *reinterpret_cast<const uint4*>(src + (static_cast<size_t>(b) * a.n + sidx[s0 + r0]) * a.cs + col);
        *reinterpret_cast<uint4*>(tile_a + r0 * st.lda + 16 + col) = v;
      }
    } else {
      for (int e = tid; e < kMmaRows * cs_pad; e += kThreads) {
        const int r0 = e / cs_pad, col = e - r0 * cs_pad;
        tile_a[r0 * st.lda + 16 + col] =
            (r0 < rows && col < a.cs) ? src[(static_cast<size_t>(b) * a.n + sidx[s0 + r0]) * a.cs + col]
                                      : __float2bfloat16_rn(0.f);
      }
    }
    __syncthreads();

    // 3.-4. The layers, up to kNPass columns a pass.
    const bf16* in = tile_a;
    int ld_in = st.lda;
    for (int l = 0; l <= l_last; ++l) {
      const int cout = L.width[l], coutp = pad16(cout);
      bf16* out = (l % 2 == 0) ? tile_b : tile_a;
      const int ld_out = (l % 2 == 0) ? st.ldb : st.lda;
      for (int n0 = 0; n0 < coutp; n0 += kNPass) {
        const int nc = min(kNPass, coutp - n0);
        float acc[2][kPairs][2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int jj = 0; jj < kPairs; ++jj)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[mi][jj][h][e] = 0.f;
        if (l > 0) {
          mma_sums(in, ld_in, 0, pad16(L.width[l - 1]), static_cast<const bf16*>(L.w[l]), L.width[l - 1], cout,
                   n0, nc, ws, st.ldw, rows, acc);
        } else if (w0f) {  // feats . W0f
          mma_sums(tile_a, st.lda, 16, cs_pad, w0f, a.cs, cout, n0, nc, ws, st.ldw, rows, acc);
        } else if (a.prelifted) {  // the prelifted layer-0 terms
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int jj = 0; jj < kPairs; ++jj)
#pragma unroll
              for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const int r = (warp_m * 2 + mi) * 16 + g + 8 * (e >> 1);
                  const int c = n0 + (warp_n + 4 * jj) * 16 + 8 * h + 2 * tq + (e & 1);
                  if (c < coutp) acc[mi][jj][h][e] = __bfloat162float(tile_a[r * st.lda + 16 + c]);
                }
        }
        if (l == 0 && w0x) {  // + c3 . W0x, a sum of its own added afterwards
          __syncthreads();  // every warp is done with wx (the last pass)
          stage_w(w0x, 3, cout, 0, 16, n0, nc, wx, st.ldw);
          __syncthreads();
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            const int mt = warp_m * 2 + mi;
            if (mt * 16 >= rows) continue;
            uint32_t af[4];
            load_a(af, tile_a, st.lda, mt * 16, 0);
#pragma unroll
            for (int jj = 0; jj < kPairs; ++jj) {
              const int pn = (warp_n + 4 * jj) * 16;
              if (pn >= nc) continue;
              uint32_t bf[4];
              load_b2(bf, wx, st.ldw, 0, pn);
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                float x[4] = {0.f, 0.f, 0.f, 0.f};
                mma_bf16(x, af, bf[2 * h], bf[2 * h + 1]);
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[mi][jj][h][e] += x[e];
              }
            }
          }
        }

        // Epilogue: relu(acc + b), rounded to bf16 into `out`, or the max-pool.
        const float* bias = L.b[l];
        const bool whole_tiles = ns % 16 == 0;  // every m16 tile lies in one query
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int mt = warp_m * 2 + mi;
          if (mt * 16 >= rows) continue;
#pragma unroll
          for (int jj = 0; jj < kPairs; ++jj) {
            const int pn = (warp_n + 4 * jj) * 16;
            if (pn >= nc) continue;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int c = n0 + pn + 8 * h + 2 * tq;  // columns c, c + 1
              const float b0 = c < cout ? bias[c] : 0.f, b1 = c + 1 < cout ? bias[c + 1] : 0.f;
              const float* d = acc[mi][jj][h];
              const float v00 = fmaxf(d[0] + b0, 0.f), v01 = fmaxf(d[1] + b1, 0.f);  // row g
              const float v10 = fmaxf(d[2] + b0, 0.f), v11 = fmaxf(d[3] + b1, 0.f);  // row g + 8
              const int r = mt * 16 + g;
              if (l < l_last) {
                *reinterpret_cast<__nv_bfloat162*>(out + r * ld_out + c) = __floats2bfloat162_rn(v00, v01);
                *reinterpret_cast<__nv_bfloat162*>(out + (r + 8) * ld_out + c) = __floats2bfloat162_rn(v10, v11);
              } else if (whole_tiles) {
                float m0 = fmaxf(v00, v10), m1 = fmaxf(v01, v11);
#pragma unroll
                for (int off = 4; off < 32; off <<= 1) {
                  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
                  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
                }
                const int ql = (mt * 16) / ns;
                if (g == 0 && c < cout) atomicMax(pool + ql * cout_last + c, __float_as_int(m0));
                if (g == 0 && c + 1 < cout) atomicMax(pool + ql * cout_last + c + 1, __float_as_int(m1));
              } else {
                const float v[4] = {v00, v01, v10, v11};
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const int rr = r + 8 * (e >> 1), cc = c + (e & 1);
                  if (rr < rows && cc < cout) atomicMax(pool + (rr / ns) * cout_last + cc, __float_as_int(v[e]));
                }
              }
            }
          }
        }
      }
      __syncthreads();  // `out` complete (and the pool, after the last layer)
      in = out;
      ld_in = ld_out;
    }

    if (s0 + ns >= k) {
      for (int t = tid; t < qpb * cout_last; t += kThreads) {
        const int ql = t / cout_last;
        if (qrow[ql] >= 0)
          pooled[(static_cast<size_t>(b) * a.m + qrow[ql]) * cout_last + (t - ql * cout_last)] =
              __float2bfloat16_rn(__int_as_float(pool[t]));
      }
    }
  }
}

// The package's bf16 kernels, built for two or three blocks an SM, take it.
template <>
__device__ __forceinline__ void mlp_pool<__nv_bfloat16, 2>(const Args& a, const Layers& L, const int* sidx,
                                                           const int* qrow, float* buf) {
  mma_mlp_pool(a, L, sidx, qrow, buf);
}

template <>
__device__ __forceinline__ void mlp_pool<__nv_bfloat16, 3>(const Args& a, const Layers& L, const int* sidx,
                                                           const int* qrow, float* buf) {
  mma_mlp_pool(a, L, sidx, qrow, buf);
}

// plan_mlp_pool for bf16 in this build: the package's plan (QPB, the layer
// table), and the floats mlp_pool<__nv_bfloat16> needs in place of the
// package's, with 16 bytes of slack for alignment.
template <>
size_t plan_mlp_pool<__nv_bfloat16>(Args& a, Layers& L, int n_layers, const int* widths,
                                    const void* const* weights, const float* const* biases) {
  const size_t words = plan_mlp_pool<float>(a, L, n_layers, widths, weights, biases);
  if (words == 0) return words;
  const Strides st = mma_strides(a, L);
  const size_t bytes = 2 * static_cast<size_t>(kMmaRows) * (st.lda + st.ldb) +
                       2 * static_cast<size_t>(kWSlice + 16) * st.ldw +
                       4 * static_cast<size_t>(a.qpb) * L.width[L.n - 1] + 16;
  return (bytes + 3) / 4;
}

}  // namespace
