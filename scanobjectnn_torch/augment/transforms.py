"""Batch augmentations for training (counterpart of
``scanobjectnn_tpu/augment/transforms.py``).

Each transform draws from a ``torch.Generator`` on the generator's device
(the default generator when none is given) and also takes its random draws
explicitly (``angles``, ``normal``), so that a test can feed it the JAX
package's draws.  Ranges, sigmas and clips are the reference's
(pointnet2/utils/provider.py).  ``points`` is [B, N, 3] f32.

Ported: the classification-train recipe (y-rotation, then jitter).  The
other transforms wait for the slices that use them.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "jitter_point_cloud",
    "rotate_point_cloud",
    "rotation_matrix_y",
    "standard_train_augment",
]


def _device(points: torch.Tensor, generator: torch.Generator | None) -> torch.device:
    return generator.device if generator is not None else points.device


def rotation_matrix_y(angle: torch.Tensor) -> torch.Tensor:
    """Rotation about the up (y) axis for the row-vector convention
    ``pc @ R`` (provider.py:34-52): angle.shape -> angle.shape + (3, 3)."""
    c, s = torch.cos(angle), torch.sin(angle)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    rows = torch.stack([c, z, s, z, o, z, -s, z, c], dim=-1)
    return rows.reshape(angle.shape + (3, 3))


def rotate_point_cloud(
    points: torch.Tensor, generator: torch.Generator | None = None, angles: torch.Tensor | None = None
) -> torch.Tensor:
    """Rotation about y by one angle per cloud, uniform in [0, 2π) (or the
    given ``angles`` [B]).  The product ``points @ R`` is written out in f32
    elementwise, so it never runs in TF32."""
    if angles is None:
        angles = torch.rand(points.shape[0], generator=generator, device=_device(points, generator))
        angles = angles * 2.0 * math.pi
    rot = rotation_matrix_y(angles.to(device=points.device, dtype=torch.float32))  # [B, 3, 3]
    p = points.float()
    return (p[..., 0:1] * rot[:, None, 0] + p[..., 1:2] * rot[:, None, 1]) + p[..., 2:3] * rot[:, None, 2]


def jitter_point_cloud(
    points: torch.Tensor,
    generator: torch.Generator | None = None,
    sigma: float = 0.01,
    clip: float = 0.05,
    normal: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-point gaussian jitter ``clip(sigma·normal, -clip, clip)``
    (provider.py:192-204); ``normal`` [B, N, 3] standard normal draws, or
    drawn here."""
    if normal is None:
        normal = torch.randn(points.shape, generator=generator, device=_device(points, generator))
    noise = torch.clamp(sigma * normal.to(device=points.device, dtype=points.dtype), -clip, clip)
    return points + noise


def standard_train_augment(
    points: torch.Tensor,
    generator: torch.Generator | None = None,
    angles: torch.Tensor | None = None,
    normal: torch.Tensor | None = None,
) -> torch.Tensor:
    """The reference classification-train recipe: rotate about y, then
    jitter (pointnet2/train.py:246-247)."""
    return jitter_point_cloud(rotate_point_cloud(points, generator, angles), generator, normal=normal)
