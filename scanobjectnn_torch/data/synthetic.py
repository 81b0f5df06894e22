"""Seeded synthetic point clouds, numpy only (counterpart of
``scanobjectnn_tpu/data/synthetic.py``).

``make_synthetic_dataset`` gives class-separable clouds, one geometric
prototype per class (up to 15, as ScanObjectNN has), optionally with
background masks (-1 = background) and part ids.
``make_hard_synthetic_dataset`` gives near-confusable ellipsoid classes in
clutter, the regime BGA models are for.  Both draw from the same
``np.random.RandomState`` stream as the reference, so equal arguments give
bit-identical arrays.
"""

from __future__ import annotations

import numpy as np

__all__ = ["make_hard_synthetic_dataset", "make_synthetic_dataset", "write_synthetic_h5"]

_PROTOTYPES = (
    "sphere", "cube", "plane", "line", "two_clusters", "cylinder", "torus", "cone",
    "helix", "cross", "shell", "ellipsoid", "pyramid", "rings", "lattice",
)


def _unit(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _sample_prototype(kind: str, n: int, rng: np.random.RandomState) -> np.ndarray:
    """``n`` points [n, 3] (float64) of one prototype shape, roughly in [-1, 1]^3."""
    if kind == "sphere":
        return _unit(rng.randn(n, 3))
    if kind == "cube":
        return rng.uniform(-1, 1, (n, 3))
    if kind == "plane":
        p = rng.uniform(-1, 1, (n, 3))
        p[:, 2] *= 0.05
        return p
    if kind == "line":
        t = rng.uniform(-1, 1, (n, 1))
        return np.concatenate([t, 0.1 * rng.randn(n, 2)], axis=1)
    if kind == "two_clusters":
        c = rng.randint(0, 2, n) * 2.0 - 1.0
        return 0.25 * rng.randn(n, 3) + np.stack([c, c, np.zeros(n)], axis=1) * 0.8
    if kind == "cylinder":
        theta = rng.uniform(0, 2 * np.pi, n)
        return np.stack([np.cos(theta), rng.uniform(-1, 1, n), np.sin(theta)], axis=1)
    if kind == "torus":
        u = rng.uniform(0, 2 * np.pi, n)
        v = rng.uniform(0, 2 * np.pi, n)
        r, big_r = 0.3, 0.7
        ring = big_r + r * np.cos(v)
        return np.stack([ring * np.cos(u), r * np.sin(v), ring * np.sin(u)], axis=1)
    if kind == "cone":
        h = rng.uniform(0, 1, n)
        theta = rng.uniform(0, 2 * np.pi, n)
        return np.stack([(1 - h) * np.cos(theta), 2 * h - 1, (1 - h) * np.sin(theta)], axis=1)
    if kind == "helix":
        t = rng.uniform(-2 * np.pi, 2 * np.pi, n)
        return np.stack([0.8 * np.cos(t), t / (2 * np.pi), 0.8 * np.sin(t)], axis=1) + 0.03 * rng.randn(n, 3)
    if kind == "cross":
        axis = rng.randint(0, 3, n)
        p = 0.08 * rng.randn(n, 3)
        p[np.arange(n), axis] = rng.uniform(-1, 1, n)
        return p
    if kind == "shell":
        return _unit(rng.randn(n, 3)) * rng.uniform(0.8, 1.0, (n, 1))
    if kind == "ellipsoid":
        return _unit(rng.randn(n, 3)) * np.array([1.0, 0.4, 0.7])
    if kind == "pyramid":
        h = rng.uniform(0, 1, n)
        side = 1 - h
        return np.stack([rng.uniform(-1, 1, n) * side, 2 * h - 1, rng.uniform(-1, 1, n) * side], axis=1)
    if kind == "rings":
        which = rng.randint(0, 2, n)
        theta = rng.uniform(0, 2 * np.pi, n)
        y = np.where(which == 0, -0.6, 0.6)
        return np.stack([np.cos(theta), y, np.sin(theta)], axis=1) + 0.02 * rng.randn(n, 3)
    if kind == "lattice":
        g = rng.randint(0, 3, (n, 3)) - 1.0
        return g * 0.7 + 0.07 * rng.randn(n, 3)
    raise ValueError(kind)


def make_synthetic_dataset(
    num_per_class: int = 8,
    num_classes: int = 4,
    num_points: int = 128,
    seed: int = 0,
    with_mask: bool = False,
    with_parts: bool = False,
) -> tuple[np.ndarray, ...]:
    """Class-separable clouds: (data [B, N, 3] float32, labels [B] int64
    [, masks [B, N] int64] [, parts [B, N] int64]), ``num_per_class``
    clouds of each class in class order.

    With ``with_mask``, a quarter of each cloud's points are replaced by
    far-away background points with mask -1; the others keep a mask id in
    0..2 (the h5 convention: -1 is background).  Part ids are 0..2."""
    if not 1 <= num_classes <= len(_PROTOTYPES):
        raise ValueError(f"num_classes must be 1..{len(_PROTOTYPES)}, got {num_classes}")
    rng = np.random.RandomState(seed)
    data, masks, parts = [], [], []
    for label in range(num_classes):
        for _ in range(num_per_class):
            pc = _sample_prototype(_PROTOTYPES[label], num_points, rng).astype(np.float32)
            mask = rng.randint(0, 3, num_points).astype(np.int64)
            part = rng.randint(0, 3, num_points).astype(np.int64)
            if with_mask:
                n_bg = num_points // 4
                bg_idx = rng.choice(num_points, n_bg, replace=False)
                pc[bg_idx] = rng.uniform(2.0, 3.0, (n_bg, 3)).astype(np.float32)
                mask[bg_idx] = -1
            data.append(pc)
            masks.append(mask)
            parts.append(part)
    out = [np.stack(data), np.repeat(np.arange(num_classes, dtype=np.int64), num_per_class)]
    if with_mask:
        out.append(np.stack(masks))
    if with_parts:
        out.append(np.stack(parts))
    return tuple(out)


# Axis ratios of the hard dataset's classes: a grid of confusable ellipsoids.
_PROTO_RATIOS = np.array([
    [1.00, 0.85, 0.65],
    [1.00, 0.85, 0.45],
    [1.00, 0.72, 0.65],
    [1.00, 0.72, 0.45],
    [1.00, 0.59, 0.65],
    [1.00, 0.59, 0.45],
    [1.00, 0.46, 0.65],
    [1.00, 0.46, 0.45],
])


def make_hard_synthetic_dataset(
    num_per_class: int = 50,
    num_classes: int = 6,
    num_points: int = 256,
    clutter_frac: float = 0.5,
    seed: int = 0,
    return_parts: bool = False,
) -> tuple[np.ndarray, ...]:
    """Near-confusable classes in background clutter: (points [B, N, 3]
    float32, labels [B] int64, masks [B, N] int64 (-1 = background)
    [, parts [B, N] int64]).

    Each class is an ellipsoid with its own axis ratios under a per-cloud
    ±10% scale jitter.  ``clutter_frac`` of each cloud is background: half a
    distractor (a whole ellipsoid of another class, offset from the object)
    and half uniform clutter in the enclosing ball.  Part ids: 0 the object,
    1 the distractor, 2 the clutter.  The points of a cloud are shuffled."""
    protos = [_PROTO_RATIOS[c % len(_PROTO_RATIOS)] for c in range(num_classes)]
    rng = np.random.RandomState(seed)
    n_clutter = int(round(num_points * clutter_frac))
    n_fg = num_points - n_clutter
    n_distract = n_clutter // 2
    n_uniform = n_clutter - n_distract

    def ellipsoid(n, ratios):
        v = _unit(rng.randn(n, 3))
        jitter = 1.0 + 0.10 * rng.randn(3)
        return (v * ratios * jitter * 0.5).astype(np.float32)

    data, labels, masks, parts = [], [], [], []
    for label in range(num_classes):
        for _ in range(num_per_class):
            fg = ellipsoid(n_fg, protos[label])
            other = (label + rng.randint(1, num_classes)) % num_classes
            frag = ellipsoid(n_distract, protos[other])
            offset = rng.randn(3)
            offset *= rng.uniform(0.70, 1.00) / np.linalg.norm(offset)
            frag = frag + offset.astype(np.float32)
            clutter = _unit(rng.randn(n_uniform, 3))
            clutter = (clutter * rng.uniform(0.0, 1.0, (n_uniform, 1)) ** (1 / 3)).astype(np.float32)
            pc = np.concatenate([fg, frag, clutter], axis=0)
            mask = np.concatenate([np.zeros(n_fg, np.int64), -np.ones(n_clutter, np.int64)])
            part = np.concatenate([
                np.zeros(n_fg, np.int64), np.ones(n_distract, np.int64), np.full(n_uniform, 2, np.int64),
            ])
            perm = rng.permutation(num_points)
            data.append(pc[perm])
            masks.append(mask[perm])
            parts.append(part[perm])
            labels.append(label)
    out = (np.stack(data), np.array(labels, dtype=np.int64), np.stack(masks))
    return out + (np.stack(parts),) if return_parts else out


def write_synthetic_h5(path: str, **kwargs) -> None:
    """``make_synthetic_dataset(**kwargs)`` written as a ScanObjectNN h5
    container (``io.save_h5``): data and labels, and masks and parts where
    ``with_mask`` and ``with_parts`` ask for them."""
    from scanobjectnn_torch.data import io

    arrays = make_synthetic_dataset(**kwargs)
    mask = arrays[2] if kwargs.get("with_mask") else None
    parts = arrays[-1] if kwargs.get("with_parts") else None
    io.save_h5(path, arrays[0], arrays[1], mask=mask, parts=parts)
