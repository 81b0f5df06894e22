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

What bounds it on the H100: the scan of N points per query.  One warp
scans a query's candidates 32 at a time in point order (a ballot keeps the
order) and stops after K hits; the selection is the same device function
as the fused SA layer's (``csrc/ballscan.cuh``).  The TPU kernel's rank
cumsum matmuls and bf16 splits are not carried over: the coordinates are
loads.  K may be up to 1024 (MSG uses 128).
"""

from __future__ import annotations

import torch

from scanobjectnn_torch.ops.cuda import _build

__all__ = ["ball_query_plain", "query_ball_group", "query_ball_group_plain", "query_ball_point"]

MAX_NSAMPLE = 1024  # kMaxK in csrc/ballgroup.cu


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
    the kernel (counted in ``query_ball_group.launches``) or raises."""
    if xyz.device.type == "cpu":
        return query_ball_group_plain(radius, nsample, xyz, new_xyz)
    if xyz.device.type != "cuda":
        raise ValueError(f"query_ball_group: unsupported device {xyz.device}")
    _check_inputs("query_ball_group", nsample, xyz, new_xyz)
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    grouped = torch.empty(b, m, nsample, 3, dtype=torch.float32, device=xyz.device)
    idx = torch.empty(b, m, nsample, dtype=torch.int32, device=xyz.device)
    cnt = torch.empty(b, m, dtype=torch.int32, device=xyz.device)
    lib = _build.library()
    with torch.cuda.device(xyz.device):
        err = lib.ballgroup_launch(
            xyz.data_ptr(), new_xyz.data_ptr(), b, n, m, nsample, radius * radius,
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
    kernel (counted in ``query_ball_point.launches``) or raises."""
    if xyz.device.type == "cpu":
        idx, cnt = ball_query_plain(radius, nsample, xyz, new_xyz)
        return idx.to(torch.int32), cnt.to(torch.int32)
    if xyz.device.type != "cuda":
        raise ValueError(f"query_ball_point: unsupported device {xyz.device}")
    _check_inputs("query_ball_point", nsample, xyz, new_xyz)
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    idx = torch.empty(b, m, nsample, dtype=torch.int32, device=xyz.device)
    cnt = torch.empty(b, m, dtype=torch.int32, device=xyz.device)
    lib = _build.library()
    with torch.cuda.device(xyz.device):
        err = lib.ballquery_launch(
            xyz.data_ptr(), new_xyz.data_ptr(), b, n, m, nsample, radius * radius,
            idx.data_ptr(), cnt.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "query_ball_point")
    query_ball_point.launches += 1
    return idx, cnt


query_ball_point.launches = 0
