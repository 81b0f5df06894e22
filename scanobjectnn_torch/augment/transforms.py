"""Batch augmentations for training (counterpart of
``scanobjectnn_tpu/augment/transforms.py``).

Each transform draws from a ``torch.Generator`` on the generator's device
(the default generator when none is given) and also takes its random draws
explicitly (``angles``, ``normal``), so that a test can feed it the JAX
package's draws.  Ranges, sigmas and clips are the reference's
(pointnet2/utils/provider.py).  ``points`` is [B, N, 3] f32.

Ported: the classification-train recipe (y-rotation, then jitter), and
PointCNN's in-graph augmentation (``pointcnn_xforms``, ``pointcnn_augment``:
pointfly.get_xforms and pointfly.augment).  The other transforms wait for
the slices that use them.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "compose_xforms",
    "jitter_point_cloud",
    "pointcnn_augment",
    "pointcnn_xforms",
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


def _matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` over the last two axes, written out in f32 elementwise (no
    TF32): [..., M, 3] @ [..., 3, P]."""
    return (a[..., :, 0:1] * b[..., 0:1, :] + a[..., :, 1:2] * b[..., 1:2, :]) + a[..., :, 2:3] * b[..., 2:3, :]


def compose_xforms(angles: torch.Tensor, scales: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """PointCNN's per-cloud transforms from given draws: angles [3, num]
    about x, y and z, composed intrinsically ``Rx @ Ry @ Rz``, and per-axis
    scales [3, num] -> (xforms = diag(scales) @ R, R), each [num, 3, 3] f32.

    Documented deviation, as in the JAX package: the reference multiplies
    the scaling by the rotation elementwise, which keeps only the diagonal;
    this is the matrix product S @ R."""
    c, s = torch.cos(angles.float()), torch.sin(angles.float())
    z, o = torch.zeros_like(c[0]), torch.ones_like(c[0])
    rx = torch.stack([o, z, z, z, c[0], -s[0], z, s[0], c[0]], -1).reshape(-1, 3, 3)
    ry = torch.stack([c[1], z, s[1], z, o, z, -s[1], z, c[1]], -1).reshape(-1, 3, 3)
    rz = torch.stack([c[2], -s[2], z, s[2], c[2], z, z, z, o], -1).reshape(-1, 3, 3)
    rotations = _matmul3(_matmul3(rx, ry), rz)
    return scales.float().t()[:, :, None] * rotations, rotations


def _draw(generator, num: int, device, bound: float, method: str) -> torch.Tensor:
    """bound·N(0, 1) clipped at ±3·bound ("g") or bound·U(-1, 1) ("u")."""
    if method == "g":
        return torch.clamp(bound * torch.randn(num, generator=generator, device=device), -3 * bound, 3 * bound)
    return bound * (torch.rand(num, generator=generator, device=device) * 2.0 - 1.0)


def pointcnn_xforms(
    num: int,
    generator: torch.Generator | None = None,
    rotation_range: tuple = (0.0, math.pi, 0.0, "u"),
    scaling_range: tuple = (0.1, 0.1, 0.1, "g"),
    device: str | torch.device | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-cloud transforms (pointfly.py:75-92): per-axis rotation angles
    (uniform in ±bound, or gaussian clipped at 3σ) and per-axis scales
    (1 + the same draw) from ``generator``, composed by ``compose_xforms``:
    (xforms [num, 3, 3], rotations [num, 3, 3])."""
    device = generator.device if generator is not None else device
    angles = torch.stack([_draw(generator, num, device, float(rotation_range[i]), rotation_range[3])
                          for i in range(3)])
    scales = torch.stack([1.0 + _draw(generator, num, device, float(scaling_range[i]), scaling_range[3])
                          for i in range(3)])
    return compose_xforms(angles, scales)


def pointcnn_augment(
    points: torch.Tensor,
    generator: torch.Generator | None = None,
    jitter_range: float = 0.0,
    rotation_range: tuple = (0.0, math.pi, 0.0, "u"),
    scaling_range: tuple = (0.1, 0.1, 0.1, "g"),
    xforms: torch.Tensor | None = None,
) -> torch.Tensor:
    """pointfly.augment (pointfly.py:94-103): each cloud times its transform
    (``xforms`` [B, 3, 3], or drawn by ``pointcnn_xforms``), in f32 written
    out elementwise, then, where ``jitter_range`` is not 0, gaussian jitter
    clipped at ±5·range."""
    if xforms is None:
        xforms, _ = pointcnn_xforms(points.shape[0], generator, rotation_range, scaling_range, points.device)
    out = _matmul3(points.float(), xforms.to(device=points.device, dtype=torch.float32))
    if jitter_range:
        noise = jitter_range * torch.randn(out.shape, generator=generator, device=_device(out, generator))
        out = out + torch.clamp(noise.to(out.device), -5 * jitter_range, 5 * jitter_range)
    return out
