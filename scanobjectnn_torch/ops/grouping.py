"""Ball query, grouping and kNN (counterpart of
``scanobjectnn_tpu/ops/grouping.py``).

``query_ball_point``, ``query_ball_group``, ``knn_point`` and
``knn_graph`` dispatch on the tensor's device, as ``ops/fps.py`` does: a
CUDA tensor runs the CUDA kernel
(``ops/cuda/ballgroup_kernel.py``, ``ops/cuda/knn_kernel.py``), a CPU
tensor its plain version.  ``knn_graph`` is DGCNN's self-kNN: each point's
first neighbour is itself.  The ball query takes the first K hits of
``d2 < radius²`` in point order and pads with the first hit (point 0 where
there is none); kNN returns ascending squared distances from the
``|a|² - 2a·b + |b|²`` expansion, ties to the lowest index.  Neither
output carries a gradient, since in the point stack the coordinates are
data leaves.  ``pairwise_squared_distance`` is that expansion as plain
tensor ops, differentiable.  ``group_point`` and ``batched_index_gather``
are plain indexing, differentiable in ``points`` (the backward is
PyTorch's own scatter-add); the SA and FP layers gather features with
``ops/cuda/gather_kernel.gather_neighbors`` instead.
"""

from __future__ import annotations

import torch

from scanobjectnn_torch.ops.cuda import ballgroup_kernel, knn_kernel

__all__ = [
    "batched_index_gather",
    "group_point",
    "knn_graph",
    "knn_point",
    "pairwise_squared_distance",
    "query_ball_group",
    "query_ball_point",
]


def pairwise_squared_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distances [..., M, N] between a [..., M, C] and b [..., N, C]
    as ``max(|a|² - 2a·b + |b|², 0)`` in f32 (the expansion of the JAX
    function, summed in ascending channel order without a matmul)."""
    return knn_kernel.squared_distance_plain(a, b)


def knn_point(k: int, xyz: torch.Tensor, new_xyz: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """k nearest points of ``xyz`` [B, N, C] for each query of ``new_xyz``
    [B, M, C]: (d2 [B, M, k] f32 ascending, idx [B, M, k] int32)."""
    return knn_kernel.knn_point_kernel(
        new_xyz.detach().float().contiguous(), xyz.detach().float().contiguous(), k
    )


def knn_graph(features: torch.Tensor, k: int) -> torch.Tensor:
    """Self-kNN over a feature cloud [B, N, C] -> idx [B, N, k] int32, the
    self edge included, ascending (ties to the lowest index)."""
    return knn_kernel.knn_graph_kernel(features.detach().float().contiguous(), k)


def query_ball_point(
    radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Ball query: (idx int32 [B, M, K], cnt int32 [B, M] = min(hits, K))."""
    return ballgroup_kernel.query_ball_point(
        radius, nsample, xyz.detach().float().contiguous(), new_xyz.detach().float().contiguous()
    )


def query_ball_group(
    radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ball query + centred grouping: (grouped_xyz [B, M, K, 3] f32, which
    is ``group_point(xyz, idx) - new_xyz[:, :, None]``, idx int32
    [B, M, K], cnt int32 [B, M])."""
    return ballgroup_kernel.query_ball_group(
        radius, nsample, xyz.detach().float().contiguous(), new_xyz.detach().float().contiguous()
    )


def batched_index_gather(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows per batch element: [B, N, C], [B, ...] -> [B, ..., C]."""
    rows = torch.arange(points.shape[0], device=points.device)
    return points[rows.reshape((-1,) + (1,) * (idx.dim() - 1)), idx.long()]


def group_point(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Grouped gather: [B, N, C], [B, M, K] -> [B, M, K, C]."""
    return batched_index_gather(points, idx)
