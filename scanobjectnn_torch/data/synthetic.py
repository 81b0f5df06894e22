"""Seeded synthetic point clouds, numpy only (counterpart of
``scanobjectnn_tpu/data/synthetic.py``).

``make_synthetic_dataset`` gives class-separable clouds, one geometric
prototype per class (up to 15, as ScanObjectNN has).  It draws from the same
``np.random.RandomState`` stream as the reference, so equal arguments give
bit-identical clouds.  Masks, part ids and the hard (cluttered) variant are
not ported yet.
"""

from __future__ import annotations

import numpy as np

__all__ = ["make_synthetic_dataset"]

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
    num_per_class: int = 8, num_classes: int = 4, num_points: int = 128, seed: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Class-separable clouds: (data [B, N, 3] float32, labels [B] int64),
    ``num_per_class`` clouds of each class in class order."""
    if not 1 <= num_classes <= len(_PROTOTYPES):
        raise ValueError(f"num_classes must be 1..{len(_PROTOTYPES)}, got {num_classes}")
    rng = np.random.RandomState(seed)
    data = []
    for label in range(num_classes):
        for _ in range(num_per_class):
            data.append(_sample_prototype(_PROTOTYPES[label], num_points, rng).astype(np.float32))
            # The reference draws a mask id and a part id per point here;
            # drawing them keeps the stream, and so the next clouds, the same.
            rng.randint(0, 3, num_points)
            rng.randint(0, 3, num_points)
    labels = np.repeat(np.arange(num_classes, dtype=np.int64), num_per_class)
    return np.stack(data), labels
