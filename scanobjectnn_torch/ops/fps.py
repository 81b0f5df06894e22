"""Farthest point sampling and point gathering (counterpart of
``scanobjectnn_tpu/ops/fps.py``).

FPS seeds with point 0, keeps a running min squared distance (init 1e38)
and takes the argmax with ties to the lowest index.  Dispatch follows the
tensor: a CUDA tensor runs the CUDA kernel (``ops/cuda/fps_kernel.py``),
a CPU tensor its plain version.  FPS has no gradient: it reads detached
coordinates, and only ``gather_point`` of its indices is differentiable.

``prob_sample`` and ``prob_sample_pdf`` are the reference's ProbSample
(weighted categorical sampling by a binary search into a CDF), plain
tensor ops on any device: ``torch.searchsorted(side="left")`` clamped to
N-1, int32 indices, as the JAX functions.
"""

from __future__ import annotations

import torch

from scanobjectnn_torch.ops.cuda.fps_kernel import fps

__all__ = [
    "farthest_point_sample", "farthest_point_sample_with_coords", "gather_point", "prob_sample", "prob_sample_pdf",
]


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


def prob_sample(cumprob: torch.Tensor, uniforms: torch.Tensor) -> torch.Tensor:
    """Weighted categorical sampling by binary search into a CDF
    (tf_sampling_g.cu:7-104): ``cumprob`` [B, N] inclusive cumulative
    probabilities (last entry ~1), ``uniforms`` [B, M] in [0, 1) -> int32
    [B, M], the first index whose cumulative probability is >= the draw,
    at most N-1."""
    idx = torch.searchsorted(cumprob.contiguous(), uniforms.to(cumprob.dtype).contiguous(), side="left")
    return torch.clamp(idx, max=cumprob.shape[-1] - 1).to(torch.int32)


def prob_sample_pdf(pdf: torch.Tensor, uniforms: torch.Tensor) -> torch.Tensor:
    """``prob_sample`` on an unnormalised ``pdf`` [B, N] (the ProbSample
    wrapper's input, tf_sampling.py:14-23): its cumulative sum in f32, and
    the draws ``uniforms`` [B, M] in [0, 1) scaled by each row's total."""
    cdf = torch.cumsum(pdf.float(), dim=-1)
    return prob_sample(cdf, uniforms.float() * cdf[..., -1:])
