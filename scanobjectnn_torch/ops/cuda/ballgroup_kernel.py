"""Ball query, and ball query + centred grouping of the coordinates: the
CUDA kernel (``csrc/ballgroup.cu``) beside its plain PyTorch version.

Replaces ``scanobjectnn_tpu/ops/pallas/ballquery_kernel.py``:
``query_ball_group_pallas`` -> ``_qbg_call`` (``pl.pallas_call``), as
``query_ball_group``; and ``query_ball_pallas`` (``pl.pallas_call``), as
``query_ball_point``: the same kernel with no coordinate write, counted
apart.  The JAX package takes its kernel only at N >= 1024, a TPU
crossover; here every CUDA call launches the kernel.

Semantics (kept from the TPU kernel and the reference's CUDA op):
  * a point is a hit when ``d2 < r2`` with ``d2 = ((qx-x)² + (qy-y)²) +
    (qz-z)²`` from direct differences (no FMA) and ``r2 = radius*radius``
    taken in Python double and rounded once to f32;
  * ``idx`` holds the first K hits in point order, padded with the first
    hit; a query with no hit gets index 0 everywhere;
  * ``cnt = min(hits, K)``;
  * ``grouped_xyz = xyz[idx] - new_xyz`` (centred), so an empty row holds
    point 0's coordinates minus the query.
Outputs: ``grouped_xyz [B, M, K, 3]`` f32 (``query_ball_group`` only),
``idx [B, M, K]`` int32 and ``cnt [B, M]`` int32.  None carries a gradient: in the SA stack the
coordinates are data leaves.

What bounds it on the H100: the scan of the points each query reaches
(about nine f32 operations a point).  A block takes ``queries`` queries of
one cloud, ``per_warp`` (1 or 2) a warp of 32 lanes, and stages the cloud's
coordinates once in shared memory as float4, ``tile`` points at a time in
point order, padded with +inf points (never hits) to whole steps; each step
a lane loads ``unroll`` points and tests each against its warp's queries
before the warp consumes the ballots in point order, and a hit below the
K-th writes its index (and coordinates) straight to its place in the output
row.  A query stops after K hits, a block once all its queries have.  The
plan is ``ball_plan``'s, a plain function held to the C source's constants
by ``tests/test_torch_ball_plan.py``; the C entry points refuse a plan they
cannot run, and ``kernel_info`` reads a build's registers and local memory.
The hit rule is one device function, ``ball_hit`` in ``csrc/ballscan.cuh``,
which the fused SA layer's scan calls too.  The TPU kernel's rank cumsum
matmuls and bf16 splits are not carried over: the coordinates are loads.
K may be up to 1024 (MSG uses 128).
"""

from __future__ import annotations

import ctypes

import torch

from scanobjectnn_torch.ops.cuda import _build, takes_plain

__all__ = [
    "ball_plan",
    "ball_query_plain",
    "kernel_info",
    "query_ball_group",
    "query_ball_group_plain",
    "query_ball_point",
    "smem_bytes",
]

MAX_NSAMPLE = 1024  # kMaxK in csrc/ballgroup.cu
MAX_TILE = 3072  # kMaxTile: points a block stages at once (16 bytes each)
MAX_WARPS = 8  # kMaxWarps: warps a block
PER_WARP = (1, 2)  # queries a warp the kernel takes
UNROLLS = (4, 8)  # points a lane loads a step, which the kernel is built for
PLAN_UNROLL = {1: 8, 2: 4}  # the plan's points a lane a step, by queries a warp
PAIR_MIN_QUERIES = 8192  # B·M from which the plan gives a warp two queries


def ball_plan(b: int, n: int, m: int) -> tuple[int, int, int, int]:
    """The launch of a ball query over B clouds of ``n`` points with ``m``
    queries each: (queries a block, queries a warp, unroll, tile).  Two
    queries a warp (a loaded point tested against both) where B·M is at
    least ``PAIR_MIN_QUERIES``, so that half as many warps still fill an
    H100; else one.  Blocks of up to ``MAX_WARPS`` warps (fewer where M
    needs fewer); ``PLAN_UNROLL`` points a lane a step (4 at two queries a
    warp, where 8 needs more registers than four blocks an SM leave); the
    whole cloud staged where it fits ``MAX_TILE`` points.  Each choice was
    the fastest on an H100 at the main paths' calls
    (``studies/ball_edge.py``)."""
    per_warp = 2 if b * m >= PAIR_MIN_QUERIES else 1
    warps = min(MAX_WARPS, -(-m // per_warp))
    return warps * per_warp, per_warp, PLAN_UNROLL[per_warp], min(n, MAX_TILE)


def smem_bytes(tile: int, unroll: int) -> int:
    """Shared bytes of a block staging ``tile`` points (x, y, z, 0 in f32),
    padded to whole steps of 32 x ``unroll`` points, whatever K."""
    step = 32 * unroll
    return 16 * (-(-tile // step) * step)


def kernel_info(queries: int, per_warp: int, unroll: int, tile: int) -> dict:
    """Registers, local bytes a thread, dynamic shared bytes a block and
    resident blocks per SM of the kernel a launch on this plan builds (on
    the card)."""
    info = (ctypes.c_int * 4)()
    err = _build.library().ballgroup_info(queries, per_warp, unroll, tile, ctypes.addressof(info))
    _build.check(err, "ballgroup kernel_info")
    return dict(zip(("registers", "local_bytes", "smem_bytes", "blocks_per_sm"), info))


def ball_query_plain(
    radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The hit rule and selection (module doc) in plain PyTorch: returns
    (idx int64 [B, M, K], cnt int64 [B, M])."""
    x, q = xyz.detach().float(), new_xyz.detach().float()
    n = x.shape[1]
    diff = [q[:, :, None, c] - x[:, None, :, c] for c in range(3)]
    d2 = (diff[0] * diff[0] + diff[1] * diff[1]) + diff[2] * diff[2]  # [B, M, N]
    hit = d2 < torch.tensor(radius * radius, dtype=torch.float32)
    key = torch.where(hit, torch.arange(n, device=x.device), n)
    first = torch.topk(key, min(nsample, n), dim=-1, largest=False).values
    if nsample > n:
        first = torch.cat([first, first.new_full((*first.shape[:2], nsample - n), n)], -1)
    pad = torch.where(first[..., :1] < n, first[..., :1], 0)  # first hit, else point 0
    return torch.where(first < n, first, pad), hit.sum(-1).clamp(max=nsample)


def query_ball_group_plain(
    radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch ball group: (grouped_xyz f32 [B, M, K, 3], idx int32
    [B, M, K], cnt int32 [B, M])."""
    idx, cnt = ball_query_plain(radius, nsample, xyz, new_xyz)
    rows = torch.arange(xyz.shape[0], device=xyz.device)[:, None, None]
    grouped = xyz.detach().float()[rows, idx] - new_xyz.detach().float()[:, :, None, :]
    return grouped, idx.to(torch.int32), cnt.to(torch.int32)


def _check_inputs(fn: str, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor) -> None:
    for name, t in (("xyz", xyz), ("new_xyz", new_xyz)):
        if t.device != xyz.device or t.dtype != torch.float32 or t.dim() != 3 or t.shape[-1] != 3:
            raise ValueError(
                f"{fn}: {name} must be float32 [B, *, 3] on {xyz.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    if new_xyz.shape[0] != xyz.shape[0] or xyz.shape[1] < 1 or new_xyz.shape[1] < 1:
        raise ValueError(f"{fn}: shapes {tuple(xyz.shape)} and {tuple(new_xyz.shape)}")
    if not 1 <= nsample <= MAX_NSAMPLE:
        raise ValueError(f"{fn}: kernel takes 1 <= K <= {MAX_NSAMPLE}, got {nsample}")


def query_ball_group(
    radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ball query + centred grouping: xyz [B, N, 3] f32, new_xyz [B, M, 3]
    f32 -> (grouped_xyz [B, M, K, 3] f32, idx [B, M, K] int32, cnt [B, M]
    int32).

    A CPU tensor takes ``query_ball_group_plain``; a CUDA tensor launches
    the kernel on ``ball_plan``'s plan (counted in
    ``query_ball_group.launches``) or raises."""
    if takes_plain(xyz):
        return query_ball_group_plain(radius, nsample, xyz, new_xyz)
    if xyz.device.type != "cuda":
        raise ValueError(f"query_ball_group: unsupported device {xyz.device}")
    _check_inputs("query_ball_group", nsample, xyz, new_xyz)
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    grouped = torch.empty(b, m, nsample, 3, dtype=torch.float32, device=xyz.device)
    idx = torch.empty(b, m, nsample, dtype=torch.int32, device=xyz.device)
    cnt = torch.empty(b, m, dtype=torch.int32, device=xyz.device)
    plan = ball_plan(b, n, m)
    lib = _build.library()
    with torch.cuda.device(xyz.device):
        err = lib.ballgroup_launch(
            xyz.data_ptr(), new_xyz.data_ptr(), b, n, m, nsample, radius * radius, *plan,
            grouped.data_ptr(), idx.data_ptr(), cnt.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "query_ball_group")
    query_ball_group.launches += 1
    return grouped, idx, cnt


query_ball_group.launches = 0


def query_ball_point(
    radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Ball query: xyz [B, N, 3] f32, new_xyz [B, M, 3] f32 -> (idx [B, M,
    K] int32, cnt [B, M] int32).

    A CPU tensor takes ``ball_query_plain``; a CUDA tensor launches the
    kernel on ``ball_plan``'s plan (counted in ``query_ball_point.launches``)
    or raises."""
    if takes_plain(xyz):
        idx, cnt = ball_query_plain(radius, nsample, xyz, new_xyz)
        return idx.to(torch.int32), cnt.to(torch.int32)
    if xyz.device.type != "cuda":
        raise ValueError(f"query_ball_point: unsupported device {xyz.device}")
    _check_inputs("query_ball_point", nsample, xyz, new_xyz)
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    idx = torch.empty(b, m, nsample, dtype=torch.int32, device=xyz.device)
    cnt = torch.empty(b, m, dtype=torch.int32, device=xyz.device)
    plan = ball_plan(b, n, m)
    lib = _build.library()
    with torch.cuda.device(xyz.device):
        err = lib.ballquery_launch(
            xyz.data_ptr(), new_xyz.data_ptr(), b, n, m, nsample, radius * radius, *plan,
            idx.data_ptr(), cnt.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "query_ball_point")
    query_ball_point.launches += 1
    return idx, cnt


query_ball_point.launches = 0
