// Spatially bucketed fused eval-time SA layer for Hopper (sm_90a): ball select
// over a window of points sorted by key + gather + folded-BN MLP + max-pool.
//
// Replaces scanobjectnn_tpu/ops/pallas/sabucket_kernel.py
// (sa_ball_mlp_pool_bucketed -> _bucketed_pallas, pl.pallas_call).  Semantics
// are documented in scanobjectnn_torch/ops/cuda/sabucket_kernel.py: the
// pooled output of the fused layer (safused.cu) bit for bit, no idx.  The
// points and the queries arrive sorted along each cloud's widest axis
// (ranksort.cu); a tile of T sorted queries can only hit points whose key
// lies within r of the tile's key range, and those lie in one window of W
// sorted points.  The TPU kernel narrowed its one-hot MXU extractions to the
// window and re-ranked hits by original index with a dense matmul when a row
// had more than K; here the window is put back in original point order, so
// the ball scan of safused.cu keeps its semantics as they are.
//
// A block takes QPB = max(1, 64 / K4) consecutive sorted queries of one tile
// of cloud blockIdx.y (K4: K rounded up to 4; the tile's ceil(T / QPB)
// blocks share its window):
//   0. the gate, per tile, on the device: lo / hi = the tile's first / last
//      query key -/+ pad_r; start = #{sorted keys < lo}, end = #{sorted keys
//      <= hi} (counted by the whole block); c0 = clip(start / G, 0, N/G -
//      W/G); the tile overflows when end > c0·G + W (or lo or hi is NaN).
//      Block 0 of a tile writes the flag;
//   1. a tile that fits loads its window, sorted positions [c0·G, c0·G + W),
//      into shared memory in original point order: each point's original id
//      sets a bit of an N-bit map, a prefix count of the map gives each
//      point its place.  One warp a query runs ballscan.cuh's ball scan over
//      the window: every hit of the query lies in the window, so the first K
//      hits in window order are its first K hits in point order, padded with
//      the first hit (original point 0 when there is none).  A tile that
//      overflows scans the whole cloud, as safused.cu does;
//   2.-4. sapool.cuh's mlp_pool stages the rows from the unsorted inputs,
//      runs the register-tiled MLP and writes each pooled row at its
//      query's original index: the same rows and the same code as #3, so
//      the same bits.
// The window's buffers alias mlp_pool's, which are dead until step 2.
// Bound: the MLP's FLOPs on CUDA cores, as safused.cu; the window shortens
// only the ball scan (at most W points a query instead of N).

#include "ballscan.cuh"
#include "sapool.cuh"

namespace {

struct Bucket {
  const float* xyz_s;   // [B, N, 3] points sorted by key
  const int32_t* ids;   // [B, N] original id of each sorted point
  const float* q_s;     // [B, M, 3] queries sorted by key
  const int32_t* qids;  // [B, M] original index of each sorted query
  const int32_t* axis;  // [B] the key's coordinate
  int w, t, g, nsub;    // window, query tile, block granularity; blocks a tile
  float pad_r;
  int32_t* overflow;  // [B, M / T] 1 where the tile scanned the whole cloud
};

// Sum of v over the block, in *out (zeroed before, read after a barrier).
__device__ __forceinline__ void block_add(int v, int* out) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) atomicAdd(out, v);
}

template <typename T, int MinBlocks>
__global__ void __launch_bounds__(kThreads, MinBlocks)
    sabucket_kernel(const Args a, const Bucket bk, const Layers L) {
  extern __shared__ __align__(16) float smem[];
  const int k = a.k, qpb = a.qpb, n = a.n, nwords = (n + 31) / 32;
  int* sidx = reinterpret_cast<int*>(smem);  // [qpb, k]
  int* qrow = sidx + qpb * k;                // [qpb]
  int* counts = qrow + qpb;                  // start, end
  float* buf = smem + round_up4(qpb * (k + 1) + 2);  // mlp_pool's buffer, 16-byte aligned
  float* wxyz = buf;                         // [W, 3] window, original point order
  int* wid = reinterpret_cast<int*>(wxyz + 3 * bk.w);  // [W] original ids
  uint32_t* bits = reinterpret_cast<uint32_t*>(wid + bk.w);  // [nwords]
  int* before = reinterpret_cast<int*>(bits + nwords);       // [nwords] set bits of earlier words

  const int b = blockIdx.y, tile = blockIdx.x / bk.nsub, sub = blockIdx.x - tile * bk.nsub;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = kThreads / 32, ax = bk.axis[b];
  const size_t pb = static_cast<size_t>(b) * n, qb = static_cast<size_t>(b) * a.m;
  const int t0 = tile * bk.t;

  // 0. The gate.
  const float lo = __fsub_rn(bk.q_s[(qb + t0) * 3 + ax], bk.pad_r);
  const float hi = __fadd_rn(bk.q_s[(qb + t0 + bk.t - 1) * 3 + ax], bk.pad_r);
  if (tid < 2) counts[tid] = 0;
  for (int i = tid; i < nwords; i += kThreads) bits[i] = 0u;
  for (int ql = tid; ql < qpb; ql += kThreads) {
    const int pos = sub * qpb + ql;
    qrow[ql] = pos < bk.t ? bk.qids[qb + t0 + pos] : -1;
  }
  __syncthreads();
  int below = 0, upto = 0;
  for (int j = tid; j < n; j += kThreads) {
    const float key = bk.xyz_s[(pb + j) * 3 + ax];
    below += key < lo;
    upto += key <= hi;
  }
  block_add(below, counts);
  block_add(upto, counts + 1);
  __syncthreads();
  const int c0 = max(0, min(counts[0] / bk.g, n / bk.g - bk.w / bk.g));
  const int first = c0 * bk.g;
  const bool ov = counts[1] > first + bk.w || lo != lo || hi != hi;
  if (sub == 0 && tid == 0) bk.overflow[static_cast<size_t>(b) * (a.m / bk.t) + tile] = ov;

  // 1. The window in original point order, then the ball scan.
  if (!ov) {
    for (int i = tid; i < bk.w; i += kThreads) {
      const int id = bk.ids[pb + first + i];
      atomicOr(&bits[id >> 5], 1u << (id & 31));
    }
    __syncthreads();
    if (warp == 0) {
      int carry = 0;
      for (int w0 = 0; w0 < nwords; w0 += 32) {
        const int wi = w0 + lane;
        const int c = wi < nwords ? __popc(bits[wi]) : 0;
        int incl = c;
        for (int off = 1; off < 32; off <<= 1) {
          const int v = __shfl_up_sync(0xffffffffu, incl, off);
          if (lane >= off) incl += v;
        }
        if (wi < nwords) before[wi] = carry + incl - c;
        carry += __shfl_sync(0xffffffffu, incl, 31);
      }
    }
    __syncthreads();
    for (int i = tid; i < bk.w; i += kThreads) {
      const size_t s = pb + first + i;
      const int id = bk.ids[s];
      const int place = before[id >> 5] + __popc(bits[id >> 5] & ((1u << (id & 31)) - 1u));
      wid[place] = id;
      for (int c = 0; c < 3; ++c) wxyz[3 * place + c] = bk.xyz_s[s * 3 + c];
    }
    __syncthreads();
  }
  for (int ql = warp; ql < qpb; ql += nwarps) {
    int* row = sidx + ql * k;
    const int q = qrow[ql];
    if (q < 0) {  // past the tile's end: dummy rows, never written out
      for (int s = lane; s < k; s += 32) row[s] = 0;
      continue;
    }
    const float* qp = a.new_xyz + (qb + q) * 3;
    if (ov) {
      ball_scan(a.xyz + pb * 3, n, qp[0], qp[1], qp[2], a.r2, k, row);
    } else {
      const int filled = ball_scan(wxyz, bk.w, qp[0], qp[1], qp[2], a.r2, k, row);
      for (int s = lane; s < k; s += 32) row[s] = filled > 0 ? wid[row[s]] : 0;
    }
  }
  __syncthreads();  // mlp_pool overwrites the window
  mlp_pool<T, MinBlocks>(a, L, sidx, qrow, buf);
}

// The dynamic shared bytes of a block: sidx, qrow, counts, then (at the next
// 16 bytes) mlp_pool's buffer or the window (W points and their ids, the N-bit map and its
// prefix counts), the larger; 0 for a shape mlp_pool does not take.
template <typename T>
size_t plan_smem(Args& a, Layers& L, int w, int n_layers, const int* widths, const void* const* weights,
                 const float* const* biases) {
  const size_t words = plan_mlp_pool<T>(a, L, n_layers, widths, weights, biases);
  const size_t window = 4 * static_cast<size_t>(w) + 2 * static_cast<size_t>((a.n + 31) / 32);
  return words == 0 ? 0 : sizeof(float) * (round_up4(a.qpb * (a.k + 1) + 2) + (words > window ? words : window));
}

template <typename T>
cudaError_t plan_and_launch(Args& a, Bucket& bk, int b, int n_layers, const int* widths,
                            const void* const* weights, const float* const* biases, void* stream) {
  Layers L{};
  const size_t smem = plan_smem<T>(a, L, bk.w, n_layers, widths, weights, biases);
  if (smem == 0) return cudaErrorInvalidValue;
  bk.nsub = (bk.t + a.qpb - 1) / a.qpb;
  const dim3 grid((a.m / bk.t) * bk.nsub, b);
  auto s = static_cast<cudaStream_t>(stream);
  return min_blocks(smem) == 3 ? launch_with_smem(sabucket_kernel<T, 3>, grid, smem, s, a, bk, L)
                               : launch_with_smem(sabucket_kernel<T, 2>, grid, smem, s, a, bk, L);
}

template <typename T>
cudaError_t info_at(int k, int cs, int n, int w, int n_layers, const int* widths, int* info) {
  Args a{};
  a.k = k;
  a.cs = cs;
  a.n = n;
  Layers L{};
  const void* weights[kMaxLayers] = {};
  const float* biases[kMaxLayers] = {};
  const size_t smem = plan_smem<T>(a, L, w, n_layers, widths, weights, biases);
  if (smem == 0) return cudaErrorInvalidValue;
  return min_blocks(smem) == 3 ? kernel_info(sabucket_kernel<T, 3>, smem, info)
                               : kernel_info(sabucket_kernel<T, 2>, smem, info);
}

}  // namespace

// The bucketed layer (#4): xyz, new_xyz, src as safused_launch; the sorted
// points (xyz_s, ids) and queries (q_s, qids) and the key axis from
// ranksort.cu; (w, t, g) the window; overflow [B, M / T] out.
extern "C" int sabucket_launch(const void* xyz, const void* new_xyz, const void* src, const void* xyz_s,
                               const void* ids, const void* q_s, const void* qids, const void* axis, int b,
                               int n, int m, int cs, int k, float r2, int w, int t, int g, float pad_r,
                               const void* w0x, const void* w0f, int prelifted, int bf16, int n_layers,
                               const int* widths, const void* const* weights, const float* const* biases,
                               void* pooled, void* overflow, void* stream) {
  if (k < 1 || k > kMaxRows || g < 1 || t < 1 || w < 1 || w % g || n % g || w > n || m % t)
    return cudaErrorInvalidValue;
  Args a{};
  a.ball = 1;
  a.xyz = static_cast<const float*>(xyz);
  a.new_xyz = static_cast<const float*>(new_xyz);
  a.src = src;
  a.n = n;
  a.m = m;
  a.cs = cs;
  a.k = k;
  a.r2 = r2;
  a.w0x = w0x;
  a.w0f = w0f;
  a.prelifted = prelifted;
  a.pooled = pooled;
  Bucket bk{};
  bk.xyz_s = static_cast<const float*>(xyz_s);
  bk.ids = static_cast<const int32_t*>(ids);
  bk.q_s = static_cast<const float*>(q_s);
  bk.qids = static_cast<const int32_t*>(qids);
  bk.axis = static_cast<const int32_t*>(axis);
  bk.w = w;
  bk.t = t;
  bk.g = g;
  bk.pad_r = pad_r;
  bk.overflow = static_cast<int32_t*>(overflow);
  return bf16 ? plan_and_launch<__nv_bfloat16>(a, bk, b, n_layers, widths, weights, biases, stream)
              : plan_and_launch<float>(a, bk, b, n_layers, widths, weights, biases, stream);
}

// The kernel's instantiation that a layer with K slots, cs source channels
// and these widths over a window of W of N points takes in bf16 (or f32):
// info as safused_info's.
extern "C" int sabucket_info(int bf16, int k, int cs, int n, int w, int n_layers, const int* widths, int* info) {
  return bf16 ? info_at<__nv_bfloat16>(k, cs, n, w, n_layers, widths, info)
              : info_at<float>(k, cs, n, w, n_layers, widths, info);
}
