// Fused eval-time SA layer for Hopper (sm_90a): neighbour rows + gather +
// folded-BN MLP + max-pool in one kernel, with two ways to pick the rows.
//
// Replaces two kernels of scanobjectnn_tpu/ops/pallas/:
//   * safused_kernel.py (sa_ball_mlp_pool -> _sa_ball_mlp_call): the rows
//     are selected by a ball scan (safused_launch);
//   * samlp_kernel.py (sa_mlp_pool -> _sa_mlp_pool_call): the rows come from
//     a grouping computed before (centred coordinates and/or neighbour
//     indices: kNN, or a ball group; samlp_launch).
// Semantics are documented in scanobjectnn_torch/ops/cuda/safused_kernel.py
// and samlp_kernel.py; the TPU mechanisms (one-hot MXU slot extraction, the
// block-triangular cumsum, bf16 Dekker splits) are not carried over: on the
// card a gather is a load.  Both entry points share one kernel, and with
// sabucket.cu the row staging, layer and max-pool code of sapool.cuh: only
// the selection step (1.) and where a row's coordinates come from (2.)
// differ, so the layer and max-pool code cannot drift between them.
//
// One block handles QPB = max(1, 64 / K4) queries of one cloud (K4: K
// rounded up to a multiple of 4):
//   1. selection: the ball scan runs one warp per query over the candidates
//      32 at a time in point order (ballot + popc keep the order) and stops
//      after K hits (ball_scan in ballscan.cuh, shared with ballgroup.cu); it
//      writes all K indices to shared memory first, since padding needs the
//      first hit.  A given grouping loads its K indices instead;
//   2.-4. sapool.cuh's mlp_pool: staging, the register-tiled layers, the
//      last layer with the max-pool, over chunks of at most 64 slots.
// K > 64 takes one query per block in chunks of 64 slots rather than a whole
// 128-row block: at MSG SA2's widest scale (prelifted, wa = 3 + 128, wb =
// 128) a 64-row chunk needs 4 * 68 * 259 B = 70 KB of activations and 16 KB
// of W ring, so two blocks share an SM, with the same layer code as K <= 64.
// Bound: the MLP's FLOPs on the CUDA cores (sapool.cuh: why bf16 too).
//
#include "ballscan.cuh"
#include "sapool.cuh"

namespace {

template <typename T, int MinBlocks>
__global__ void __launch_bounds__(kThreads, MinBlocks)
    safused_kernel(const Args a, const Layers L) {
  extern __shared__ __align__(16) float smem[];
  const int k = a.k, qpb = a.qpb;
  int* sidx = reinterpret_cast<int*>(smem);  // [qpb, k]
  int* qrow = sidx + qpb * k;                // [qpb]
  const int b = blockIdx.y, q0 = blockIdx.x * qpb;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = kThreads / 32;
  const float* cloud = a.ball ? a.xyz + static_cast<size_t>(b) * a.n * 3 : nullptr;

  // 1. Selection, one warp per query: the ball scan (csrc/ballscan.cuh) or
  //    the given indices.
  for (int ql = warp; ql < qpb; ql += nwarps) {
    int* row = sidx + ql * k;
    const int q = q0 + ql;
    if (lane == 0) qrow[ql] = q < a.m ? q : -1;
    if (q >= a.m) {  // ragged last block: dummy rows, never written out
      for (int s = lane; s < k; s += 32) row[s] = 0;
      continue;
    }
    const size_t bq = static_cast<size_t>(b) * a.m + q;
    if (a.ball) {
      const float* qp = a.new_xyz + bq * 3;
      ball_scan(cloud, a.n, qp[0], qp[1], qp[2], a.r2, k, row);
      if (a.idx)
        for (int s = lane; s < k; s += 32) a.idx[bq * k + s] = row[s];
    } else {
      for (int s = lane; s < k; s += 32) row[s] = a.gidx ? a.gidx[bq * k + s] : 0;
    }
  }
  __syncthreads();
  mlp_pool<T, MinBlocks>(a, L, sidx, qrow, smem + round_up4(qpb * (k + 1)));
}

// Fills the layer table and the buffer widths; returns the dynamic shared
// bytes of a block (sidx [qpb, K] and qrow [qpb], then mlp_pool's buffer at
// the next 16 bytes), or 0 for a shape the kernel does not take.
template <typename T>
size_t plan_smem(Args& a, Layers& L, int n_layers, const int* widths, const void* const* weights,
                 const float* const* biases) {
  const size_t words = plan_mlp_pool<T>(a, L, n_layers, widths, weights, biases);
  return words == 0 ? 0 : sizeof(float) * (round_up4(a.qpb * (a.k + 1)) + words);
}

// Fills the layer table and the buffer widths, and launches.
template <typename T>
cudaError_t plan_and_launch(Args& a, int b, int n_layers, const int* widths, const void* const* weights,
                            const float* const* biases, void* stream) {
  Layers L{};
  const size_t smem = plan_smem<T>(a, L, n_layers, widths, weights, biases);
  if (smem == 0) return cudaErrorInvalidValue;
  const dim3 grid((a.m + a.qpb - 1) / a.qpb, b);
  auto s = static_cast<cudaStream_t>(stream);
  return min_blocks(smem) == 3 ? launch_with_smem(safused_kernel<T, 3>, grid, smem, s, a, L)
                               : launch_with_smem(safused_kernel<T, 2>, grid, smem, s, a, L);
}

cudaError_t plan_and_launch(Args& a, int b, int bf16, int n_layers, const int* widths,
                            const void* const* weights, const float* const* biases, void* stream) {
  return bf16 ? plan_and_launch<__nv_bfloat16>(a, b, n_layers, widths, weights, biases, stream)
              : plan_and_launch<float>(a, b, n_layers, widths, weights, biases, stream);
}

template <typename T>
cudaError_t info_at(int k, int cs, int n_layers, const int* widths, int* info) {
  Args a{};
  a.k = k;
  a.cs = cs;
  Layers L{};
  const void* weights[kMaxLayers] = {};
  const float* biases[kMaxLayers] = {};
  const size_t smem = plan_smem<T>(a, L, n_layers, widths, weights, biases);
  if (smem == 0) return cudaErrorInvalidValue;
  return min_blocks(smem) == 3 ? kernel_info(safused_kernel<T, 3>, smem, info)
                               : kernel_info(safused_kernel<T, 2>, smem, info);
}

}  // namespace

// The ball-selected layer (#3): idx [B, M, K] is written when not null.
extern "C" int safused_launch(const void* xyz, const void* new_xyz, const void* src,
                              int b, int n, int m, int cs, int k, float r2,
                              const void* w0x, const void* w0f, int prelifted,
                              int bf16, int n_layers, const int* widths,
                              const void* const* weights, const float* const* biases,
                              void* pooled, void* idx, void* stream) {
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
  a.idx = static_cast<int32_t*>(idx);
  return plan_and_launch(a, b, bf16, n_layers, widths, weights, biases, stream);
}

// The layer over a given grouping (#10): grouped [B, M, K, 3] and/or
// gidx [B, M, K] with src [B, N, cs].
extern "C" int samlp_launch(const void* grouped, const void* gidx, const void* src,
                            int b, int n, int m, int cs, int k,
                            const void* w0x, const void* w0f, int bf16, int n_layers,
                            const int* widths, const void* const* weights,
                            const float* const* biases, void* pooled, void* stream) {
  Args a{};
  a.grouped = static_cast<const float*>(grouped);
  a.gidx = static_cast<const int32_t*>(gidx);
  a.src = src;
  a.n = n;
  a.m = m;
  a.cs = cs;
  a.k = k;
  a.w0x = w0x;
  a.w0f = w0f;
  a.pooled = pooled;
  return plan_and_launch(a, b, bf16, n_layers, widths, weights, biases, stream);
}

// The kernel's instantiation that a layer with K slots, cs source channels
// and these widths takes in bf16 (or f32), at its shared memory: info =
// {registers a thread, local-memory bytes a thread, dynamic shared bytes,
// resident blocks per SM}.
extern "C" int safused_info(int bf16, int k, int cs, int n_layers, const int* widths, int* info) {
  return bf16 ? info_at<__nv_bfloat16>(k, cs, n_layers, widths, info) : info_at<float>(k, cs, n_layers, widths, info);
}
