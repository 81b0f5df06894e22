"""k-nearest-neighbour search: the CUDA kernels (``csrc/knn.cu``) beside
their plain PyTorch versions.

Replaces ``scanobjectnn_tpu/ops/pallas/knn_kernel.py``: ``knn_point_pallas``
(``_knn_general_kernel``, ``pl.pallas_call``), which the FP decoder's
``three_nn`` runs with k=3 and PointCNN's kNN with a duplicate bias, and
``knn_graph_pallas`` (``_knn_kernel``), DGCNN's self-kNN graph: five graphs
per forward, at C = 3 (the T-Net, EdgeConv 1) and C = 64 (EdgeConv 2-4).

Semantics (the contract of ``knn_point_pallas``):
  * ``knn_point_kernel(queries [B, M, C], keys [B, N, C], k, bias [B, N] or
    None) -> (d2 [B, M, k] f32, idx [B, M, k] int32)``, ascending;
  * ``d2 = max(qq - 2·inner + kk, 0) + bias[key]`` with ``qq = |q|²``,
    ``kk = |key|²`` and ``inner = q·key``, each a sum over the channels in
    ascending order, evaluated elementwise in f32 (no matmul, so no cuBLAS
    order and no TF32); the returned distances include the bias;
  * ties go to the lowest key index (the TPU's ``argmin_rows`` rule);
  * a slot that no key fills holds ``(+inf, 0)``: when N < k (the JAX
    ``three_nn`` pads so from one key), and for keys whose distance is +inf
    or NaN, which are never selected.
Any C, M and N and any k >= 1, as ``knn_point_pallas``: up to ``MAX_K``
(64; PointCNN's ``xdconv_4`` asks for k = 48) each query's list stays in
registers, above it the kernel sorts every distance of the query in shared
memory, a tile of at most ``SORT_TILE`` (16384) keys at a time; a larger
cloud's tiles are merged into a running list of min(k, N) words a query in
a scratch buffer that the wrapper allocates.  The outputs carry no
gradient.

``knn_graph_kernel(features [B, N, C], k) -> idx [B, N, k] int32`` is the
self-kNN: every point is a query and a key, so each point's first neighbour
is itself (its distance is exactly 0).  It is ``knn_point_kernel(x, x,
k)[1]`` bit for bit: up to ``GRAPH_MAX_K`` its own kernel, which takes the
points' |x|² once a point, sums 64 x 64 tiles of inner products a block
(4 x 4 a thread) and selects from each tile's rows a warp a query, the
query's list held one entry a lane; above it the general kernel with the
cloud as its queries (that very call).  ``graph_kernel_info`` reads its
registers, local memory and blocks per SM on the card.

What bounds it on the H100: operations, about 2C + 4 per (query, key) pair;
at fp3 (B=32, 1024 queries, 512 keys, C=3) about 2.5 us of f32 work against
0.4 us of bytes, so in practice the launch.  DGCNN's C=64 graph at B=32,
N=1024 is 33.6M pairs of about 132 operations: 66 us at the FMA rate, 132
us at the rate of separate f32 instructions, which the contract's
uncontracted sums need.  In the general kernel one thread per query scans
its cloud's keys, staged in shared memory in tiles, in ascending index and
keeps its k best in registers; above k = 64 one block per query sorts all
its distances (a bitonic sort of (distance bits, index) keys), whose
log2(N)²/2 steps, not the distances, then set the time.
"""

from __future__ import annotations

import ctypes

import torch

from scanobjectnn_torch.ops.cuda import _build

__all__ = [
    "GRAPH_MAX_K",
    "MAX_K",
    "SORT_TILE",
    "graph_kernel_info",
    "knn_graph_kernel",
    "knn_graph_plain",
    "knn_point_kernel",
    "knn_point_plain",
    "squared_distance_plain",
]

MAX_K = 64  # kMaxK in csrc/knn.cu: the largest k kept in registers
SORT_TILE = 16384  # kSortTile in csrc/knn.cu: keys sorted at once above MAX_K
GRAPH_MAX_K = 32  # kGraphMaxK in csrc/knn.cu: the largest k of the graph's own kernel


def _sum_of_products(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum over the last axis of a * b (broadcast), in ascending channel
    order, as separate f32 multiplies and adds (no contraction)."""
    s = a[..., 0] * b[..., 0]
    for i in range(1, a.shape[-1]):
        s = s + a[..., i] * b[..., i]
    return s


def squared_distance_plain(queries: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """``max(|q|² - 2 q·k + |k|², 0)`` [..., M, N] between queries [..., M, C]
    and keys [..., N, C], in f32, in the kernel's order of operations."""
    q, k = queries.float(), keys.float()
    qq = _sum_of_products(q, q)[..., :, None]
    kk = _sum_of_products(k, k)[..., None, :]
    inner = _sum_of_products(q[..., :, None, :], k[..., None, :, :])
    return torch.clamp((qq - 2.0 * inner) + kk, min=0.0)


def knn_point_plain(
    queries: torch.Tensor, keys: torch.Tensor, k: int, bias: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch kNN (module doc): (d2 f32 [B, M, k], idx int32 [B, M, k])."""
    d2 = squared_distance_plain(queries.detach(), keys.detach())
    if bias is not None:
        d2 = d2 + bias.detach().float()[:, None, :]
    # A stable sort keeps equal distances in key order (torch.topk promises
    # no order among equal values); +inf and NaN sort last.
    vals, order = torch.sort(d2, dim=-1, stable=True)
    vals, order = vals[..., :k], order[..., :k]
    if vals.shape[-1] < k:
        pad = (*vals.shape[:-1], k - vals.shape[-1])
        vals = torch.cat([vals, vals.new_full(pad, float("inf"))], -1)
        order = torch.cat([order, order.new_zeros(pad)], -1)
    chosen = vals < float("inf")
    vals = torch.where(chosen, vals, float("inf"))
    return vals, torch.where(chosen, order, 0).to(torch.int32)


def knn_graph_plain(features: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch self-kNN: ``knn_point_plain(features, features, k)[1]``."""
    return knn_point_plain(features, features, k)[1]


def _check_cuda(name: str, t: torch.Tensor, shape: tuple, device, fn: str = "knn_point_kernel") -> None:
    if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != shape:
        raise ValueError(
            f"{fn}: {name} must be float32 {shape} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


def knn_point_kernel(
    queries: torch.Tensor, keys: torch.Tensor, k: int, bias: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """k nearest keys of every query: queries [B, M, C] f32, keys [B, N, C]
    f32, bias [B, N] f32 or None -> (d2 [B, M, k] f32, idx [B, M, k] int32),
    ascending.

    A CPU tensor takes ``knn_point_plain``; a CUDA tensor launches the kernel
    (counted in ``knn_point_kernel.launches``, and above k = ``MAX_K`` in
    ``knn_point_kernel.sort_launches`` too, and of those, on a cloud of more
    than ``SORT_TILE`` keys, in ``knn_point_kernel.tiled_launches``) or
    raises."""
    if queries.device.type == "cpu":
        return knn_point_plain(queries, keys, k, bias)
    if queries.device.type != "cuda":
        raise ValueError(f"knn_point_kernel: unsupported device {queries.device}")
    if queries.dim() != 3 or keys.dim() != 3:
        raise ValueError(
            f"knn_point_kernel: need [B, M, C] and [B, N, C], got {tuple(queries.shape)}, {tuple(keys.shape)}"
        )
    b, m, c = queries.shape
    n = keys.shape[1]
    dev = queries.device
    _check_cuda("queries", queries, (b, m, c), dev)
    _check_cuda("keys", keys, (b, n, c), dev)
    if bias is not None:
        _check_cuda("bias", bias, (b, n), dev)
    if k < 1:
        raise ValueError(f"knn_point_kernel: kernel takes k >= 1, got {k}")
    if min(b, m, n, c) < 1:
        raise ValueError(f"knn_point_kernel: empty input {tuple(queries.shape)}, {tuple(keys.shape)}")
    dist = torch.empty(b, m, k, dtype=torch.float32, device=dev)
    idx = torch.empty(b, m, k, dtype=torch.int32, device=dev)
    scratch = _sort_scratch(b, m, n, k, dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.knn_launch(
            queries.data_ptr(), keys.data_ptr(), None if bias is None else bias.data_ptr(),
            b, m, n, c, k, dist.data_ptr(), idx.data_ptr(), None if scratch is None else scratch.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "knn_point_kernel")
    knn_point_kernel.launches += 1
    knn_point_kernel.sort_launches += k > MAX_K
    knn_point_kernel.tiled_launches += scratch is not None
    return dist, idx


knn_point_kernel.launches = 0
knn_point_kernel.sort_launches = 0  # of them, k > MAX_K (the sort)
knn_point_kernel.tiled_launches = 0  # of those, N > SORT_TILE (tiles merged)


def _sort_scratch(b: int, m: int, n: int, k: int, device) -> torch.Tensor | None:
    """The tiled sort's two lists of min(k, N) words a query, where the
    kernel takes that path (k > MAX_K and N > SORT_TILE), else None."""
    if k <= MAX_K or n <= SORT_TILE:
        return None
    return torch.empty(2 * b * m * min(k, n), dtype=torch.int64, device=device)


def knn_graph_kernel(features: torch.Tensor, k: int) -> torch.Tensor:
    """Self-kNN, self edge included: features [B, N, C] f32 -> idx [B, N, k]
    int32, ascending.

    A CPU tensor takes ``knn_graph_plain``; a CUDA tensor launches the
    kernel (counted in ``knn_graph_kernel.launches``; above ``GRAPH_MAX_K``
    the general kernel, also counted in ``knn_graph_kernel.routed_launches``)
    or raises."""
    if features.device.type == "cpu":
        return knn_graph_plain(features, k)
    if features.device.type != "cuda":
        raise ValueError(f"knn_graph_kernel: unsupported device {features.device}")
    if features.dim() != 3:
        raise ValueError(f"knn_graph_kernel: need [B, N, C], got {tuple(features.shape)}")
    b, n, c = features.shape
    _check_cuda("features", features, (b, n, c), features.device, "knn_graph_kernel")
    if k < 1:
        raise ValueError(f"knn_graph_kernel: kernel takes k >= 1, got {k}")
    if min(b, n, c) < 1:
        raise ValueError(f"knn_graph_kernel: empty input {tuple(features.shape)}")
    dev = features.device
    idx = torch.empty(b, n, k, dtype=torch.int32, device=dev)
    routed = k > GRAPH_MAX_K
    # Routed: the general kernel's distances; else the points' |x|².
    dist = torch.empty((b, n, k) if routed else (b, n), dtype=torch.float32, device=dev)
    scratch = _sort_scratch(b, n, n, k, dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.knn_graph_launch(
            features.data_ptr(), b, n, c, k, idx.data_ptr(), dist.data_ptr(),
            None if scratch is None else scratch.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "knn_graph_kernel")
    knn_graph_kernel.launches += 1
    knn_graph_kernel.routed_launches += routed
    return idx


knn_graph_kernel.launches = 0
knn_graph_kernel.routed_launches = 0  # of them, k > GRAPH_MAX_K (the general kernel)


def graph_kernel_info(c: int) -> dict:
    """The graph kernel (k <= ``GRAPH_MAX_K``) as a launch at width ``c``
    builds it: registers and local-memory bytes a thread, dynamic shared
    bytes a block, and resident blocks per SM, from
    ``cudaFuncGetAttributes`` and the occupancy API (on the card)."""
    info = (ctypes.c_int * 4)()
    _build.check(_build.library().knn_graph_info(c, ctypes.addressof(info)), "graph_kernel_info")
    return dict(zip(("registers", "local_bytes", "smem_bytes", "blocks_per_sm"), info))
