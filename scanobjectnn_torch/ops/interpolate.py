"""Three-nearest-neighbour inverse-distance interpolation, the FP
decoder's upsampling (counterpart of ``scanobjectnn_tpu/ops/interpolate.py``).

  * ``three_nn(xyz1 [B, N, 3], xyz2 [B, M, 3])`` -> (squared distances
    [B, N, 3] f32, idx [B, N, 3] int32), ascending, through the kNN kernel
    (``ops/cuda/knn_kernel.py``) on a CUDA tensor at every M; the JAX
    package takes its Pallas kernel only for M >= 512, a TPU choice.  With
    M < 3 the unfilled slots are (+inf, 0), the JAX ``1e40`` pad in f32, so
    their weight is 0.  No gradient.
  * ``three_interpolate_weights``: floor at 1e-10, ``1/d``, normalised.
  * ``three_interpolate(points [B, M, C], idx, weight)`` -> [B, N, C]:
    the 3 rows gathered by ``gather_neighbors`` (the gather kernel, whose
    backward is the deterministic scatter-add), weighted and summed.  The
    rounding is XLA's for the JAX ``einsum`` on the CPU, read from its
    bits: the weight is cast to the points' dtype, products and the sum over
    the 3 rows run in f32, and the result is cast once to the points' dtype
    (for bf16 points this gives the JAX bits exactly).
"""

from __future__ import annotations

import torch

from scanobjectnn_torch.ops.cuda import gather_kernel, knn_kernel

__all__ = ["three_interpolate", "three_interpolate_weights", "three_nn"]


def three_nn(xyz1: torch.Tensor, xyz2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The 3 nearest points of ``xyz2`` for each point of ``xyz1``."""
    return knn_kernel.knn_point_kernel(
        xyz1.detach().float().contiguous(), xyz2.detach().float().contiguous(), 3
    )


def three_interpolate_weights(dist: torch.Tensor) -> torch.Tensor:
    """Inverse-distance weights from squared 3-NN distances [..., 3]."""
    inv = 1.0 / torch.clamp(dist, min=1e-10)
    return inv / (inv[..., :1] + inv[..., 1:2] + inv[..., 2:3])


def three_interpolate(points: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """sum over j of ``weight[..., j] * points[b, idx[..., j]]`` (module
    doc), differentiable in ``points``."""
    gathered = gather_kernel.gather_neighbors(points.float().contiguous(), idx)  # [B, N, 3, C]
    w = weight.to(points.dtype).float()[..., None]
    out = gathered[:, :, 0] * w[:, :, 0]
    for j in (1, 2):
        out = out + gathered[:, :, j] * w[:, :, j]
    return out.to(points.dtype)
