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
Any C, M and N and any k >= 1, as ``knn_point_pallas``, on the route
``point_plan`` picks (``ROUTES``; ``csrc/knn.cu`` refuses a plan it cannot
run): up to ``GROUP_MAX_K`` the group route, ``group_lanes`` lanes a query
each keeping a register list of its share of the keys, merged by a group
minimum; up to ``MAX_K`` (64; PointCNN's ``xdconv_4`` asks for k = 48) the
warp route, a warp a query holding its list one entry a lane; above it a
block a query selects its first min(k, N) distances by a radix select and
sorts only those (the selection), a tile of at most ``SORT_TILE`` (16384)
keys at a time; a larger cloud's tiles are merged into a running list of
min(k, N) words a query in a scratch buffer that the wrapper allocates.  A
k whose selected words do not fit a block's shared memory
(``select_smem_bytes``) sorts every word of a tile (the full sort).  The
outputs carry no gradient.

``knn_graph_kernel(features [B, N, C], k) -> idx [B, N, k] int32`` is the
self-kNN: every point is a query and a key, so each point's first neighbour
is itself (its distance is exactly 0).  It is ``knn_point_kernel(x, x,
k)[1]`` bit for bit: up to ``GRAPH_MAX_K`` its own kernel, which takes the
points' |x|² once a point, sums 64 x 64 tiles of inner products a block
(4 x 4 a thread) and selects from each tile's rows a warp a query, the
query's list held one entry a lane; above it the general kernel with the
cloud as its queries (that very call).  ``graph_kernel_info`` reads its
registers, local memory and blocks per SM on the card.  Up to
``GRAPH_MAX_K`` the same kernel, built with an epilogue, also copies a
second tensor's rows at each point's neighbours
(``edge_kernel.edge_gather_knn``).

What bounds it on the H100: operations, about 2C + 4 per (query, key) pair;
at fp3 (B=32, 1024 queries, 512 keys, C=3) about 2.5 us of f32 work against
0.4 us of bytes, so in practice the launch.  DGCNN's C=64 graph at B=32,
N=1024 is 33.6M pairs of about 132 operations: 66 us at the FMA rate, 132
us at the rate of separate f32 instructions, which the contract's
uncontracted sums need.  Beyond them the calls spend their time selecting
(a list insertion, the radix passes) and, at small B·M, on an idle card,
which the group lanes fill.  The launch choices are plain functions here
(``point_plan``, ``group_lanes``, ``warp_tile``, ``select_smem_bytes``),
held to the C source's constants by ``tests/test_torch_knn_plan.py``;
``point_kernel_info`` reads each route's registers, local memory and
blocks per SM on the card.
"""

from __future__ import annotations

import ctypes

import torch

from scanobjectnn_torch.ops.cuda import _build, takes_plain
from scanobjectnn_torch.ops.cuda.satrain_kernel import sm_count

__all__ = [
    "GRAPH_MAX_K",
    "GROUP_MAX_K",
    "MAX_K",
    "ROUTES",
    "SORT_TILE",
    "graph_kernel_info",
    "group_lanes",
    "knn_graph_kernel",
    "knn_graph_plain",
    "knn_point_kernel",
    "knn_point_plain",
    "point_kernel_info",
    "point_plan",
    "select_smem_bytes",
    "squared_distance_plain",
    "warp_tile",
]

MAX_K = 64  # kMaxK in csrc/knn.cu: the largest k of the list routes
SORT_TILE = 16384  # kSortTile in csrc/knn.cu: keys selected (or sorted) at once above MAX_K
GRAPH_MAX_K = 32  # kGraphMaxK in csrc/knn.cu: the largest k of the graph's own kernel
ROUTES = ("group", "warp", "select", "sort")  # knn_launch's route codes 0..3
GROUP_MAX_K = 16  # kGroupMaxK in csrc/knn.cu: the largest k of the group route (above it: the warp route)
FILL_THREADS_PER_SM = 192  # threads a group-route launch aims for on each SM
SMEM_FLOATS = 12 * 1024  # kSmemFloats in csrc/knn.cu: a list route's shared floats
SMEM_MAX = 232_448  # kSmemMax: the most shared memory a block may use on an H100 (227 KB)
WARP_QT = 16  # kWarpQT: queries a block of the warp route
RADIX_BINS, SELECT_AUX_INTS = 256, 12  # kRadixBins, kSelectAux


def group_lanes(queries: int, n: int, sms: int) -> int:
    """Lanes a query takes on the group route, for ``queries`` queries (B·M)
    on clouds of ``n`` keys on a card of ``sms`` SMs: the least power of two
    that gives the launch ``FILL_THREADS_PER_SM`` threads an SM, at most 32
    and at most ``n`` (a lane past the last key would scan nothing)."""
    g = 1
    while g < 32 and queries * g < sms * FILL_THREADS_PER_SM and 2 * g <= n:
        g *= 2
    return g


def warp_tile(n: int, c: int) -> int:
    """Keys a tile of the warp route at width ``c`` (``warp_tile`` in
    csrc/knn.cu): the staged queries, the queries' candidate buffers (32
    entries each) and the tile, channel-major, within ``SMEM_FLOATS``, a
    multiple of 32 and no more than ``n`` rounded up to 32; 0 where the
    width leaves no room for 32 keys."""
    fit = (SMEM_FLOATS - c * (WARP_QT + 1) - WARP_QT - c - 2 * WARP_QT * 32) // (c + 2)
    return max(min(fit, -(-n // 32) * 32) // 32 * 32, 0)


def select_smem_bytes(n: int, k: int) -> int:
    """Shared bytes of a block of the selection (``select_smem_bytes`` in
    csrc/knn.cu): the words of a tile of at most ``SORT_TILE`` keys, the
    selected words padded to a power of two, the radix histogram and its
    scratch ints."""
    words = min(n, SORT_TILE)
    sel = 1
    while sel < min(k, words):
        sel *= 2
    return 8 * (words + sel) + 4 * RADIX_BINS + 4 * SELECT_AUX_INTS


def point_plan(b: int, m: int, n: int, c: int, k: int, sms: int) -> tuple[str, int]:
    """The route of a kNN call and its group lanes: (route, lanes).

    k <= ``GROUP_MAX_K``: "group", ``group_lanes(b·m, n, sms)`` lanes a
    query.  Up to ``MAX_K``: "warp" (a warp a query), or where the width
    leaves the warp route no tile "select".  Above: "select", or "sort" (the
    full sort) where the selected words do not fit a block's shared memory.
    Lanes is 1 off the group route."""
    if k <= GROUP_MAX_K:
        return "group", group_lanes(b * m, n, sms)
    if k <= MAX_K and warp_tile(n, c) >= 32:
        return "warp", 1
    return ("select" if select_smem_bytes(n, k) <= SMEM_MAX else "sort"), 1


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
    on ``point_plan``'s route (counted in ``knn_point_kernel.launches``; at k
    <= ``MAX_K`` on the warp route in ``.warp_launches`` too; above it in
    ``.sort_launches``, and of those, on a cloud of more than ``SORT_TILE``
    keys, in ``.tiled_launches``, and on the full sort in
    ``.fullsort_launches``) or raises."""
    if takes_plain(queries):
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
    route, lanes = point_plan(b, m, n, c, k, sm_count(dev))
    scratch = _sort_scratch(b, m, n, k, route, dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.knn_launch(
            queries.data_ptr(), keys.data_ptr(), None if bias is None else bias.data_ptr(),
            b, m, n, c, k, ROUTES.index(route), lanes, dist.data_ptr(), idx.data_ptr(),
            None if scratch is None else scratch.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "knn_point_kernel")
    knn_point_kernel.launches += 1
    knn_point_kernel.sort_launches += k > MAX_K
    knn_point_kernel.tiled_launches += k > MAX_K and scratch is not None
    knn_point_kernel.warp_launches += route == "warp"
    knn_point_kernel.fullsort_launches += k > MAX_K and route == "sort"
    return dist, idx


knn_point_kernel.launches = 0
knn_point_kernel.sort_launches = 0  # of them, k > MAX_K (the selection, or the full sort)
knn_point_kernel.tiled_launches = 0  # of those, N > SORT_TILE (tiles merged)
knn_point_kernel.warp_launches = 0  # of the k <= MAX_K launches, the warp route's
knn_point_kernel.fullsort_launches = 0  # of the k > MAX_K launches, the full sort's (words past shared memory)


def _sort_scratch(b: int, m: int, n: int, k: int, route: str, device) -> torch.Tensor | None:
    """The tiled selection's (or sort's) two lists of min(k, N) words a
    query, where the kernel takes that path (route "select" or "sort" and N >
    SORT_TILE), else None."""
    if route not in ("select", "sort") or n <= SORT_TILE:
        return None
    return torch.empty(2 * b * m * min(k, n), dtype=torch.int64, device=device)


def knn_graph_kernel(features: torch.Tensor, k: int) -> torch.Tensor:
    """Self-kNN, self edge included: features [B, N, C] f32 -> idx [B, N, k]
    int32, ascending.

    A CPU tensor takes ``knn_graph_plain``; a CUDA tensor launches the
    kernel (counted in ``knn_graph_kernel.launches``; above ``GRAPH_MAX_K``
    the general kernel, also counted in ``knn_graph_kernel.routed_launches``)
    or raises."""
    if takes_plain(features):
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
    # Routed: the general kernel's distances, on its plan; else the points' |x|².
    dist = torch.empty((b, n, k) if routed else (b, n), dtype=torch.float32, device=dev)
    route, lanes = point_plan(b, n, n, c, k, sm_count(dev)) if routed else ("group", 1)
    scratch = _sort_scratch(b, n, n, k, route, dev) if routed else None
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.knn_graph_launch(
            features.data_ptr(), b, n, c, k, ROUTES.index(route), lanes, idx.data_ptr(), dist.data_ptr(),
            None if scratch is None else scratch.data_ptr(), None, None, 0, 0,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "knn_graph_kernel")
    knn_graph_kernel.launches += 1
    knn_graph_kernel.routed_launches += routed
    return idx


knn_graph_kernel.launches = 0
knn_graph_kernel.routed_launches = 0  # of them, k > GRAPH_MAX_K (the general kernel)


def graph_kernel_info(c: int, gather: bool = False) -> dict:
    """The graph kernel (k <= ``GRAPH_MAX_K``) as a launch at width ``c``
    builds it, alone or (``gather``) with the fused gather of
    ``edge_kernel.edge_gather_knn``: registers and local-memory bytes a
    thread, dynamic shared bytes a block, and resident blocks per SM, from
    ``cudaFuncGetAttributes`` and the occupancy API (on the card)."""
    info = (ctypes.c_int * 4)()
    _build.check(_build.library().knn_graph_info(c, int(gather), ctypes.addressof(info)), "graph_kernel_info")
    return dict(zip(("registers", "local_bytes", "smem_bytes", "blocks_per_sm"), info))


def point_kernel_info(route: str, n: int, c: int, k: int, lanes: int = 1) -> dict:
    """The kernel ``knn_point_kernel`` runs on ``route`` (``ROUTES``; the
    group route at ``lanes`` lanes a query) for clouds of ``n`` keys at width
    ``c`` and this ``k``: registers and local-memory bytes a thread, dynamic
    shared bytes a block, and resident blocks per SM (on the card)."""
    info = (ctypes.c_int * 4)()
    err = _build.library().knn_point_info(ROUTES.index(route), lanes, n, c, k, ctypes.addressof(info))
    _build.check(err, "point_kernel_info")
    return dict(zip(("registers", "local_bytes", "smem_bytes", "blocks_per_sm"), info))
