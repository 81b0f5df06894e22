"""The point-cloud viewer (counterpart of ``scanobjectnn_tpu/viz/show3d.py``;
the reference's pointnet2/utils/show3d_balls.py).

``render_frame`` projects a cloud to the screen and splats each point as a
z-buffered disk, the splat of ``native/render_balls.cpp`` written in
numpy: the disk's offsets (i, j) with i² + j² < r², in the C loop's order,
each raising its pixel's depth by r² − i² − j²; a pixel takes the colour
of the first (point, offset) in loop order that reaches its largest depth
above −2100000000 (the C loop's strict ``>``), its channels
``min(255, max(0, c·255))`` in f32 truncated to uint8.  The frame is the
JAX ``render_frame``'s pixel for pixel, with no native library to build.
``showpoints`` is the interactive loop where ``cv2`` is installed, and
otherwise renders (and saves) one frame.
"""

from __future__ import annotations

import numpy as np

__all__ = ["render_frame", "render_ball", "showpoints"]

_EMPTY_DEPTH = -2100000000


def _disk(radius: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(dx, dy, dz) of the splat's disk in the C loop's order."""
    r = max(radius, 1)
    i, j = np.meshgrid(np.arange(-r, r + 1), np.arange(-r, r + 1), indexing="ij")
    i, j = i.reshape(-1), j.reshape(-1)
    q = i * i + j * j
    inside = q < r * r
    return i[inside], j[inside], (r * r - q[inside])


def _channel(c: np.ndarray) -> np.ndarray:
    """``(uint8) std::min(255.0f, std::max(0.0f, c * 255.0f))``."""
    v = np.asarray(c, np.float32) * np.float32(255.0)
    v = np.where(np.float32(0.0) < v, v, np.float32(0.0))  # std::max(0, v): NaN gives 0
    v = np.where(v < np.float32(255.0), v, np.float32(255.0))
    return v.astype(np.uint8)


def render_ball(h: int, w: int, xyzs: np.ndarray, colors: np.ndarray, radius: int = 5) -> np.ndarray:
    """Splat int screen points [n, 3] (x, y, depth) with [n, 3] float
    colours into an [h, w, 3] uint8 image (module doc)."""
    xyzs = np.asarray(xyzs, np.int32).reshape(-1, 3)
    colors = np.asarray(colors, np.float32).reshape(-1, 3)
    dx, dy, dz = _disk(radius)
    n, k = len(xyzs), len(dx)
    xx = (xyzs[:, 0:1] + dx[None]).reshape(-1)
    yy = (xyzs[:, 1:2] + dy[None]).reshape(-1)
    zz = (xyzs[:, 2:3] + dz[None].astype(np.int32)).reshape(-1).astype(np.int64)
    order = np.arange(n * k)  # the C loop's order: point, then offset
    keep = (xx >= 0) & (xx < h) & (yy >= 0) & (yy < w) & (zz > _EMPTY_DEPTH)
    pix, zz, order = (xx * w + yy)[keep], zz[keep], order[keep]
    show = np.zeros((h * w, 3), np.uint8)
    if pix.size:
        # Per pixel the largest depth, the earliest in loop order among equals.
        s = np.lexsort((order, -zz, pix))
        first = np.ones(len(s), bool)
        first[1:] = pix[s][1:] != pix[s][:-1]
        win = s[first]
        point = order[win] // k
        show[pix[win]] = np.stack([_channel(colors[point, c]) for c in range(3)], axis=-1)
    return show.reshape(h, w, 3)


def render_frame(
    points: np.ndarray,
    colors: np.ndarray | None = None,
    size: int = 800,
    radius: int = 5,
    zoom: float = 1.0,
    rot_x: float = 0.0,
    rot_y: float = 0.0,
    background: tuple[int, int, int] = (0, 0, 0),
    normalize: bool = True,
) -> np.ndarray:
    """Render one frame of the cloud into an [size, size, 3] uint8 image."""
    pts = np.asarray(points, np.float64).copy()
    if normalize:
        pts -= pts.mean(axis=0)
        scale = np.abs(pts).max()
        if scale > 0:
            pts /= scale * 2.2

    cx, sx = np.cos(rot_x), np.sin(rot_x)
    cy, sy = np.cos(rot_y), np.sin(rot_y)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    pts = pts @ (rx @ ry).T

    screen = np.empty((len(pts), 3), np.int32)
    screen[:, 0] = (pts[:, 1] * zoom * size * 0.8 + size / 2).astype(np.int32)
    screen[:, 1] = (pts[:, 0] * zoom * size * 0.8 + size / 2).astype(np.int32)
    screen[:, 2] = (pts[:, 2] * zoom * size * 0.8).astype(np.int32)

    if colors is None:
        colors = np.ones((len(pts), 3), np.float32)
    img = render_ball(size, size, screen, np.asarray(colors, np.float32), radius)
    if any(background):
        bg = img.sum(axis=-1) == 0
        img[bg] = np.asarray(background, np.uint8)
    return img


def showpoints(
    points: np.ndarray,
    colors: np.ndarray | None = None,
    output_path: str | None = None,
    interactive: bool = True,
    **kwargs,
) -> np.ndarray:
    """Show (a cv2 window, where cv2 is installed and ``interactive``) or
    save one frame.  Keys in the interactive loop are the reference
    viewer's: q quits, n/m zoom, a/d and w/s rotate."""
    try:
        import cv2  # type: ignore
    except ImportError:
        cv2 = None

    if cv2 is None or not interactive:
        img = render_frame(points, colors, **kwargs)
        if output_path:
            from scanobjectnn_torch.viz.render import save_image

            save_image(output_path, img[..., 0] / 255.0)
        return img

    state = {"zoom": 1.0, "rx": 0.0, "ry": 0.0}
    keys = {"n": ("zoom", 1.1), "m": ("zoom", 1 / 1.1), "a": ("ry", 0.1), "d": ("ry", -0.1),
            "w": ("rx", 0.1), "s": ("rx", -0.1)}
    while True:
        img = render_frame(points, colors, zoom=state["zoom"], rot_x=state["rx"], rot_y=state["ry"], **kwargs)
        cv2.imshow("scanobjectnn_torch", img)
        key = chr(cv2.waitKey(10) & 0xFF)
        if key == "q":
            break
        if key in keys:
            name, step = keys[key]
            state[name] = state[name] * step if name == "zoom" else state[name] + step
    cv2.destroyAllWindows()
    return img
