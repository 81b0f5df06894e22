"""Offline point-cloud rendering and voxelisation for the evaluation's
error dumps (counterpart of ``scanobjectnn_tpu/viz/render.py``, numpy
only; its images and PNG bytes are the JAX module's).

Behavioural reference: pointnet2/utils/pc_util.py: ``draw_point_cloud:209``
(an orthographic depth render of gaussian disks, the nearer points drawn
last), ``point_cloud_three_views:255`` (three rotated views side by side,
the error-case images of evaluate_scenennobjects.py:211-222),
``point_cloud_to_volume:24`` and ``volume_to_point_cloud``.  Images are
floats in [0, 1]; ``save_image`` and ``save_image_rgb`` write PNG with the
standard library.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "euler2mat",
    "draw_point_cloud",
    "point_cloud_three_views",
    "point_cloud_to_volume",
    "volume_to_point_cloud",
    "save_image",
    "save_image_rgb",
]


def euler2mat(z: float = 0.0, y: float = 0.0, x: float = 0.0) -> np.ndarray:
    """Rz·Ry·Rx rotation matrix (replaces the vendored 418-LoC
    eulerangles.py for the one call pc_util makes)."""
    mats = []
    if z:
        c, s = np.cos(z), np.sin(z)
        mats.append(np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]))
    if y:
        c, s = np.cos(y), np.sin(y)
        mats.append(np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]))
    if x:
        c, s = np.cos(x), np.sin(x)
        mats.append(np.array([[1, 0, 0], [0, c, -s], [0, s, c]]))
    out = np.eye(3)
    for m in mats:
        out = out @ m
    return out


def draw_point_cloud(
    points: np.ndarray,
    canvas_size: int = 500,
    space: float = 200.0,
    diameter: int = 25,
    xrot: float = 0.0,
    yrot: float = 0.0,
    zrot: float = 0.0,
    switch_xyz=(0, 1, 2),
    normalize: bool = True,
) -> np.ndarray:
    """Render one orthographic view: gaussian disks splatted with
    depth-dependent intensity, max-normalized (pc_util.draw_point_cloud)."""
    image = np.zeros((canvas_size, canvas_size))
    if points is None or len(points) == 0:
        return image
    m = euler2mat(zrot, yrot, xrot)
    pts = (m @ np.asarray(points, np.float64).T).T
    pts = pts[:, list(switch_xyz)]
    if normalize:
        centroid = pts.mean(axis=0)
        pts = pts - centroid
        furthest = np.sqrt((pts**2).sum(axis=1)).max()
        if furthest > 0:
            pts = pts / furthest

    # Sort by depth so nearer points splat last (reference sorts by z).
    order = np.argsort(pts[:, 2])
    pts = pts[order]

    radius = diameter // 2
    # Gaussian disk template.
    dx, dy = np.meshgrid(np.arange(-radius, radius + 1), np.arange(-radius, radius + 1))
    inside = dx**2 + dy**2 <= radius**2
    disk = np.exp(-(dx**2 + dy**2) / (radius**2 * 0.5)) * inside

    px = ((pts[:, 0] + 1.0) / 2.0 * space).astype(int) + (canvas_size - int(space)) // 2
    py = ((pts[:, 1] + 1.0) / 2.0 * space).astype(int) + (canvas_size - int(space)) // 2
    depth_weight = pts[:, 2] - pts[:, 2].min() + 0.5

    dj, di = np.nonzero(disk)
    dvals = disk[dj, di]
    for k in range(len(pts)):
        xs = px[k] + di - radius
        ys = py[k] + dj - radius
        valid = (xs >= 0) & (xs < canvas_size) & (ys >= 0) & (ys < canvas_size)
        image[ys[valid], xs[valid]] = np.maximum(
            image[ys[valid], xs[valid]], dvals[valid] * depth_weight[k]
        )
    if image.max() > 0:
        image = image / image.max()
    return image


def point_cloud_three_views(points: np.ndarray, canvas_size: int = 500) -> np.ndarray:
    """Three views at different euler angles, concatenated horizontally
    (pc_util.point_cloud_three_views:255)."""
    views = [
        draw_point_cloud(points, canvas_size, xrot=110 / 180 * np.pi, yrot=0, zrot=-45 / 180 * np.pi),
        draw_point_cloud(points, canvas_size, xrot=70 / 180 * np.pi, yrot=0, zrot=135 / 180 * np.pi),
        draw_point_cloud(points, canvas_size, xrot=180 / 180 * np.pi, yrot=0, zrot=90 / 180 * np.pi),
    ]
    return np.concatenate(views, axis=1)


def point_cloud_to_volume(points: np.ndarray, vsize: int, radius: float = 1.0) -> np.ndarray:
    """Occupancy voxelization of a cloud assumed within [-radius, radius]
    (pc_util.point_cloud_to_volume)."""
    vol = np.zeros((vsize, vsize, vsize), np.float32)
    voxel = 2 * radius / vsize
    locations = ((np.asarray(points) + radius) / voxel).astype(int)
    locations = np.clip(locations, 0, vsize - 1)
    vol[locations[:, 0], locations[:, 1], locations[:, 2]] = 1.0
    return vol


def volume_to_point_cloud(vol: np.ndarray) -> np.ndarray:
    """Inverse of occupancy voxelization: voxel centers of occupied cells."""
    idx = np.argwhere(vol > 0)
    return idx.astype(np.float32)


def _write_png(path: str, arr: np.ndarray, color_type: int) -> None:
    import struct
    import zlib

    h, w = arr.shape[:2]
    raw = b"".join(b"\x00" + arr[i].tobytes() for i in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)


def save_image(path: str, image: np.ndarray) -> None:
    """Write a grayscale float image [0,1] as PNG (stdlib only — the
    reference used the long-removed scipy.misc.imsave)."""
    _write_png(path, (np.clip(image, 0, 1) * 255).astype(np.uint8), color_type=0)


def save_image_rgb(path: str, image: np.ndarray) -> None:
    """Write an [H, W, 3] image as RGB PNG; uint8 passes through, float is
    treated as [0,1]."""
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    _write_png(path, arr, color_type=2)
