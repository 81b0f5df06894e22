"""Farthest point sampling and point gathering (counterpart of
``scanobjectnn_tpu/ops/fps.py``).

FPS seeds with point 0, keeps a running min squared distance (init 1e38)
and takes the argmax with ties to the lowest index.  Dispatch follows the
tensor: a CUDA tensor runs the CUDA kernel (``ops/cuda/fps_kernel.py``),
a CPU tensor its plain version.  FPS has no gradient: it reads detached
coordinates, and only ``gather_point`` of its indices is differentiable.
"""

from __future__ import annotations

import torch

from scanobjectnn_torch.ops.cuda.fps_kernel import fps

__all__ = ["farthest_point_sample", "farthest_point_sample_with_coords", "gather_point"]


def farthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """[B, N, 3] -> int32 [B, npoint]."""
    return fps(xyz.detach().float().contiguous(), npoint, with_coords=False)


def farthest_point_sample_with_coords(
    xyz: torch.Tensor, npoint: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """FPS returning (idx [B, npoint], new_xyz [B, npoint, 3]) in one pass;
    ``new_xyz`` equals ``gather_point(xyz, idx)`` bit for bit, in
    ``xyz.dtype``.  For inference: neither output carries a gradient."""
    idx, new_xyz = fps(xyz.detach().float().contiguous(), npoint, with_coords=True)
    return idx, new_xyz.to(xyz.dtype)


def gather_point(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[B, N, C], [B, M] -> [B, M, C] (differentiable in ``points``)."""
    rows = torch.arange(points.shape[0], device=points.device)[:, None]
    return points[rows, idx.long()]
