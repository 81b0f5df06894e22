"""Ball query and grouping (counterpart of ``scanobjectnn_tpu/ops/grouping.py``).

``query_ball_group`` dispatches on the tensor's device, as ``ops/fps.py``
does: a CUDA tensor runs the CUDA kernel (``ops/cuda/ballgroup_kernel.py``),
a CPU tensor its plain version.  The ball query takes the first K hits of
``d2 < radius²`` in point order and pads with the first hit (point 0 where
there is none); its outputs carry no gradient, since in the SA stack the
coordinates are data leaves.  ``group_point`` and ``batched_index_gather``
are plain indexing, differentiable in ``points`` (the backward is
PyTorch's own scatter-add); the SA layers gather features with
``ops/cuda/gather_kernel.gather_neighbors`` instead.
"""

from __future__ import annotations

import torch

from scanobjectnn_torch.ops.cuda import ballgroup_kernel

__all__ = ["batched_index_gather", "group_point", "query_ball_group"]


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
