"""PointNet++ set abstraction for inference (counterpart of
``scanobjectnn_tpu/nn/pointnet_modules.py``).

Ported: ``_fused_ball_scale``, ``sample_and_group_all``, the eval fused
branch and the group-all branch of ``SAModule``, and the eval path of
``GroupMLPPool``.  A ball-grouped SA layer at eval runs two kernels: FPS
for the centroids, then the fused ball-select + MLP + max-pool layer.
The unfused grouping path, kNN grouping, pooling modes other than max,
``mlp2`` and training are not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from scanobjectnn_torch import ops
from scanobjectnn_torch.nn.layers import MLP, mlp_final_max
from scanobjectnn_torch.ops.cuda.safused_kernel import sa_ball_mlp_pool
from scanobjectnn_torch.ops.cuda.samlp_kernel import fold_bn_mlp_params

__all__ = ["sample_and_group_all", "SAModule", "GroupMLPPool"]


class GroupMLPPool(MLP):
    """Grouped shared MLP + max-pool over the neighbour axis (dim 2).  Same
    children as ``MLP`` (``dense_i``/``bn_i``), so the eval BN fold reads
    them directly.  Eval only (the fused training tail is not ported)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.features)
        for i in range(n - 1):
            x = self.layer(i, x)
        return mlp_final_max(self, x, n - 1, dim=2)

    def folded(self) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
        """Eval-mode BN folded into the Dense params (f32)."""
        n = len(self.features)
        dense = [(getattr(self, f"dense_{i}").kernel, getattr(self, f"dense_{i}").bias) for i in range(n)]
        bn = [getattr(self, f"bn_{i}") for i in range(n)]
        return fold_bn_mlp_params(dense, [(m.scale, m.bias, m.mean, m.var) for m in bn])


def _fused_ball_scale(
    mlp: GroupMLPPool,
    radius: float,
    nsample: int,
    xyz: torch.Tensor,
    new_xyz: torch.Tensor,
    points: torch.Tensor | None,
    dtype: torch.dtype,
) -> torch.Tensor:
    """One fused eval-time ball-grouped SA scale in the SSG layer order
    ([xyz, feats]): fold the eval BN into the Dense weights, then ball
    select + gather + MLP + max-pool in one kernel.  Returns pooled
    [B, M, C]."""
    weights, biases = mlp.folded()
    pooled, _ = sa_ball_mlp_pool(
        radius, nsample, xyz.float().contiguous(), new_xyz.float().contiguous(),
        points, weights, biases, dtype=dtype,
    )
    return pooled


def sample_and_group_all(xyz: torch.Tensor, points: torch.Tensor | None):
    """Single group holding every point, centroid (0, 0, 0), coordinates
    concatenated before the features.  Returns (new_xyz [B,1,3], new_points
    [B,1,N,3+C])."""
    new_xyz = xyz.new_zeros(xyz.shape[0], 1, 3)
    if points is None:
        return new_xyz, xyz[:, None]
    return new_xyz, torch.cat([xyz, points], dim=-1)[:, None]


class SAModule(nn.Module):
    """PointNet set abstraction with max pooling, inference only.

    ``in_channels`` is the width of ``points`` (0 when there are none); the
    MLP's input adds the 3 centred coordinates (the JAX ``use_xyz=True``)."""

    def __init__(
        self,
        npoint: int | None,
        radius: float | None,
        nsample: int | None,
        mlp: Sequence[int],
        in_channels: int = 0,
        group_all: bool = False,
        dtype: torch.dtype | None = None,
    ):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.group_all, self.dtype = group_all, dtype
        self.mlp = GroupMLPPool(3 + in_channels, mlp, dtype=dtype)

    def forward(self, xyz: torch.Tensor, points: torch.Tensor | None):
        """Returns (new_xyz [B, npoint, 3], pooled [B, npoint, C])."""
        if self.training:
            raise NotImplementedError("SAModule training is not ported yet; call .eval()")
        if self.group_all:
            new_xyz, new_points = sample_and_group_all(xyz, points)
            return new_xyz, self.mlp(new_points)
        # idx + centroid coordinates in one FPS kernel pass.
        _, new_xyz = ops.farthest_point_sample_with_coords(xyz, self.npoint)
        pooled = _fused_ball_scale(
            self.mlp, self.radius, self.nsample, xyz, new_xyz, points,
            dtype=self.dtype or xyz.dtype,
        )
        return new_xyz, pooled
