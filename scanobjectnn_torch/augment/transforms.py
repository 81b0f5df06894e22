"""Batch augmentations for training (counterpart of
``scanobjectnn_tpu/augment/transforms.py``).

Each transform draws from a ``torch.Generator`` on the generator's device
(the default generator when none is given) and also takes its random draws
explicitly (``angles``, ``normal``), so that a test can feed it the JAX
package's draws.  Ranges, sigmas and clips are the reference's
(pointnet2/utils/provider.py).  ``points`` is [B, N, 3] f32.

Every transform of the JAX module is ported: the classification-train
recipe (y-rotation, then jitter), PointCNN's in-graph augmentation
(``pointcnn_xforms``, ``pointcnn_augment``: pointfly.get_xforms and
pointfly.augment), the other rotations, shifts, scalings, dropout and
shuffling of provider.py, 3DmFV-Net's outliers, occlusion and gaussian
starving (3DmFV-Net/provider.py), and ``compose``.  Each takes the values it
would draw as optional arguments, in the form JAX draws them (a uniform
already in its range, a standard normal, a permutation), and draws them from
``generator`` where they are not given.  Ties follow JAX: ``argmax`` and
``argmin`` take the first extreme, and ``starve_gaussians`` keeps the lower
index first among equal scores (a stable sort, as ``jax.lax.top_k``).
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

__all__ = [
    "compose",
    "compose_xforms",
    "insert_outliers_to_point_cloud",
    "jitter_point_cloud",
    "occlude_point_cloud",
    "pointcnn_augment",
    "pointcnn_xforms",
    "random_point_dropout",
    "random_scale_point_cloud",
    "rotate_perturbation_point_cloud",
    "rotate_point_cloud",
    "rotate_point_cloud_by_angle",
    "rotate_point_cloud_z",
    "rotation_matrix_y",
    "scale_point_cloud_anisotropic",
    "shift_point_cloud",
    "shuffle_points",
    "standard_train_augment",
    "starve_gaussians",
    "translate_point_cloud",
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


def _rotate(points: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """``points @ rot`` per cloud ([B, 3, 3] or [3, 3]) in f32 written out
    elementwise (no TF32)."""
    p, rot = points.float(), rot.float()
    if rot.dim() == 2:
        rot = rot[None]
    return (p[..., 0:1] * rot[:, None, 0] + p[..., 1:2] * rot[:, None, 1]) + p[..., 2:3] * rot[:, None, 2]


def rotate_point_cloud(
    points: torch.Tensor, generator: torch.Generator | None = None, angles: torch.Tensor | None = None
) -> torch.Tensor:
    """Rotation about y by one angle per cloud, uniform in [0, 2π) (or the
    given ``angles`` [B]).  The product ``points @ R`` is written out in f32
    elementwise, so it never runs in TF32."""
    if angles is None:
        angles = torch.rand(points.shape[0], generator=generator, device=_device(points, generator))
        angles = angles * 2.0 * math.pi
    return _rotate(points, rotation_matrix_y(angles.to(device=points.device, dtype=torch.float32)))


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


def _uniform(shape, generator, device, low: float, high: float) -> torch.Tensor:
    """U[low, high) of ``shape`` from ``generator``."""
    return low + (high - low) * torch.rand(shape, generator=generator, device=device)


def _given(values: torch.Tensor, like: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    return values.to(device=like.device, dtype=dtype or like.dtype)


def _rotation_matrix_z(angle: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([c, s, z, -s, c, z, z, z, o], dim=-1).reshape(angle.shape + (3, 3))


def rotate_point_cloud_z(
    points: torch.Tensor, generator: torch.Generator | None = None, angles: torch.Tensor | None = None
) -> torch.Tensor:
    """Rotation about z by one angle per cloud, uniform in [0, 2π) (or the
    given ``angles`` [B]) (provider.py:54-72)."""
    if angles is None:
        angles = torch.rand(points.shape[0], generator=generator, device=_device(points, generator)) * 2.0 * math.pi
    return _rotate(points, _rotation_matrix_z(_given(angles, points, torch.float32)))


def rotate_point_cloud_by_angle(points: torch.Tensor, angle) -> torch.Tensor:
    """Every cloud turned about y by ``angle`` (provider.py:123-141).  A
    Python or numpy scalar takes its cosine and sine in float64 on the host,
    as JAX does for the voting angles; a tensor through
    ``rotation_matrix_y``."""
    if isinstance(angle, (int, float)) or (isinstance(angle, np.ndarray) and angle.ndim == 0):
        c, s = np.cos(float(angle)), np.sin(float(angle))
        rot = torch.tensor([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], dtype=torch.float32, device=points.device)
    else:
        rot = rotation_matrix_y(_given(torch.as_tensor(angle), points, torch.float32))
    return _rotate(points, rot)


def rotate_perturbation_point_cloud(
    points: torch.Tensor,
    generator: torch.Generator | None = None,
    angle_sigma: float = 0.06,
    angle_clip: float = 0.18,
    normal: torch.Tensor | None = None,
) -> torch.Tensor:
    """A small ``Rz·Ry·Rx`` per cloud, the angles ``clip(sigma·normal,
    ±clip)`` (``normal`` [B, 3] standard normal draws) (provider.py:167-190)."""
    b = points.shape[0]
    if normal is None:
        normal = torch.randn((b, 3), generator=generator, device=_device(points, generator))
    angles = torch.clamp(angle_sigma * _given(normal, points, torch.float32), -angle_clip, angle_clip)
    c, s = torch.cos(angles), torch.sin(angles)
    z, o = torch.zeros_like(c[:, 0]), torch.ones_like(c[:, 0])
    rx = torch.stack([o, z, z, z, c[:, 0], -s[:, 0], z, s[:, 0], c[:, 0]], -1).reshape(b, 3, 3)
    ry = torch.stack([c[:, 1], z, s[:, 1], z, o, z, -s[:, 1], z, c[:, 1]], -1).reshape(b, 3, 3)
    rz = torch.stack([c[:, 2], -s[:, 2], z, s[:, 2], c[:, 2], z, z, z, o], -1).reshape(b, 3, 3)
    return _rotate(points, _matmul3(_matmul3(rz, ry), rx))


def shift_point_cloud(
    points: torch.Tensor,
    generator: torch.Generator | None = None,
    shift_range: float = 0.1,
    shifts: torch.Tensor | None = None,
) -> torch.Tensor:
    """A translation per cloud, ``shifts`` [B, 1, 3] uniform in ±shift_range
    (provider.py:206-218)."""
    if shifts is None:
        shifts = _uniform((points.shape[0], 1, 3), generator, _device(points, generator), -shift_range, shift_range)
    return points + _given(shifts, points)


def random_scale_point_cloud(
    points: torch.Tensor,
    generator: torch.Generator | None = None,
    scale_low: float = 0.8,
    scale_high: float = 1.25,
    scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """An isotropic scale per cloud, ``scales`` [B, 1, 1] uniform in [low,
    high) (provider.py:221-233)."""
    if scales is None:
        scales = _uniform((points.shape[0], 1, 1), generator, _device(points, generator), scale_low, scale_high)
    return points * _given(scales, points)


def scale_point_cloud_anisotropic(
    points: torch.Tensor,
    generator: torch.Generator | None = None,
    smin: float = 0.66,
    smax: float = 1.5,
    scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """A scale per cloud and axis, ``scales`` [B, 1, 3] uniform in [smin,
    smax) (3DmFV-Net/provider.py scale_point_cloud)."""
    if scales is None:
        scales = _uniform((points.shape[0], 1, 3), generator, _device(points, generator), smin, smax)
    return points * _given(scales, points)


def translate_point_cloud(
    points: torch.Tensor,
    generator: torch.Generator | None = None,
    tval: float = 0.2,
    t: torch.Tensor | None = None,
) -> torch.Tensor:
    """A translation per cloud, ``t`` [B, 1, 3] uniform in ±tval
    (3DmFV-Net/provider.py translate_point_cloud)."""
    if t is None:
        t = _uniform((points.shape[0], 1, 3), generator, _device(points, generator), -tval, tval)
    return points + _given(t, points)


def random_point_dropout(
    points: torch.Tensor,
    generator: torch.Generator | None = None,
    max_dropout_ratio: float = 0.875,
    ratio: torch.Tensor | None = None,
    u: torch.Tensor | None = None,
) -> torch.Tensor:
    """Points whose draw ``u`` [B, N] (uniform in [0, 1)) is at most their
    cloud's ``ratio`` [B, 1] (uniform in [0, max_dropout_ratio)) take the
    cloud's first point (provider.py:236-244)."""
    device = _device(points, generator)
    if ratio is None:
        ratio = torch.rand((points.shape[0], 1), generator=generator, device=device) * max_dropout_ratio
    if u is None:
        u = torch.rand(points.shape[:2], generator=generator, device=device)
    drop = _given(u, points, torch.float32) <= _given(ratio, points, torch.float32)
    return torch.where(drop[..., None], points[:, :1, :], points)


def shuffle_points(
    points: torch.Tensor, generator: torch.Generator | None = None, perm: torch.Tensor | None = None
) -> torch.Tensor:
    """One point permutation ``perm`` [N] for the whole batch
    (provider.py:22-32)."""
    if perm is None:
        perm = torch.randperm(points.shape[1], generator=generator, device=_device(points, generator))
    return points[:, perm.to(points.device).long(), :]


def insert_outliers_to_point_cloud(
    points: torch.Tensor,
    generator: torch.Generator | None = None,
    outlier_ratio: float = 0.05,
    u: torch.Tensor | None = None,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """Points whose draw ``u`` [B, N] (uniform in [0, 1)) is below
    ``outlier_ratio`` become ``noise`` [B, N, 3] (uniform in [-1, 1))
    (3DmFV-Net/provider.py insert_outliers_to_point_cloud)."""
    device = _device(points, generator)
    if u is None:
        u = torch.rand(points.shape[:2], generator=generator, device=device)
    if noise is None:
        noise = _uniform(points.shape, generator, device, -1.0, 1.0)
    outlier = _given(u, points, torch.float32) < outlier_ratio
    return torch.where(outlier[..., None], _given(noise, points), points)


def _take_point(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points[b, idx[b]] as [B, 1, 3]."""
    return torch.gather(points, 1, idx.long()[:, None, None].expand(-1, 1, points.shape[-1]))


def occlude_point_cloud(
    points: torch.Tensor,
    generator: torch.Generator | None = None,
    occlusion_ratio: float = 0.25,
    pivot: torch.Tensor | None = None,
) -> torch.Tensor:
    """Occlusion, with static shapes as in JAX: each cloud's
    ``int(N·occlusion_ratio)`` points nearest its ``pivot`` point ([B]
    indices, uniform in [0, N)), and every point as near, take the point
    farthest from the pivot (the first such) (3DmFV-Net/provider.py
    occlude_point_cloud)."""
    b, n, _ = points.shape
    if pivot is None:
        pivot = torch.randint(0, n, (b,), generator=generator, device=_device(points, generator))
    sq = torch.square(points - _take_point(points, pivot.to(points.device)))
    d = (sq[..., 0] + sq[..., 1]) + sq[..., 2]  # [B, N]
    k = int(n * occlusion_ratio)
    if k == 0:
        return points
    thresh = torch.sort(d, dim=1).values[:, k - 1 : k]  # the k-th smallest distance
    far = _take_point(points, torch.argmax(d, dim=1))
    return torch.where((d <= thresh)[..., None], far, points)


def starve_gaussians(
    points: torch.Tensor,
    gmm_means,
    n_points: int,
    generator: torch.Generator | None = None,
    starve_coef: float = 0.6,
    keep: torch.Tensor | None = None,
    u: torch.Tensor | None = None,
) -> torch.Tensor:
    """Subsampling with sparse regions (3DmFV-Net/provider.py:182-211): a
    point's score is ``u`` [B, N] (uniform in [0, 1)) times its nearest
    gaussian's coefficient, 1 where ``keep`` [G] (Bernoulli 0.5 draws) holds
    and ``starve_coef`` elsewhere; the ``n_points`` highest scores survive, in
    descending order of score, the lower index first among equal ones:
    [B, n_points, 3]."""
    b, n, _ = points.shape
    means = torch.as_tensor(gmm_means, dtype=points.dtype, device=points.device)
    device = _device(points, generator)
    if keep is None:
        keep = torch.rand(means.shape[0], generator=generator, device=device) < 0.5
    if u is None:
        u = torch.rand((b, n), generator=generator, device=device)
    sq = torch.square(points[:, :, None, :] - means)
    d = (sq[..., 0] + sq[..., 1]) + sq[..., 2]  # [B, N, G]
    nearest = torch.argmin(d, dim=2)
    one = torch.ones((), dtype=points.dtype, device=points.device)
    sk = torch.where(keep.to(points.device).bool(), one, one * starve_coef)
    p = sk[nearest] * _given(u, points)
    top = torch.sort(p, dim=1, descending=True, stable=True).indices[:, :n_points]
    return torch.gather(points, 1, top[..., None].expand(-1, -1, points.shape[-1]))


def compose(*fns: Callable) -> Callable:
    """Chain transforms ``f(points, generator) -> points``, each drawing from
    the one generator in turn."""

    def apply(points: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        for fn in fns:
            points = fn(points, generator)
        return points

    return apply
