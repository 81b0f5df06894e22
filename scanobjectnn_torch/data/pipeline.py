"""Epoch and batch pipeline, numpy only (counterpart of
``scanobjectnn_tpu/data/pipeline.py``).

Reference semantics (data_utils.py:108-233), kept exactly so that the port
visits clouds and points in the JAX package's order under the same seed:
  * rectangular input (h5, ``[B, N, 3]``): each epoch draws ONE point
    permutation shared by every cloud and keeps its first ``num_points``
    points; masks and parts take the same points (data_utils.py:171-233);
  * ragged input (the raw ``.bin`` clouds of ``io.load_data``, a list or an
    object array of ``[n_i, 3]`` clouds, ``is_ragged``): each cloud draws its
    own point permutation, in cloud order, and keeps its first
    ``num_points``; its mask and parts take the same points; a cloud below
    ``num_points`` raises (data_utils.py:108-131);
  * then the cloud order is shuffled, and the per-cloud ``types``
    (the discriminator's model-type labels) follow it;
  * training batches are fixed-size and drop the remainder
    (pointnet2/train.py:237); evaluation's ``padded_batches`` keeps it,
    padded by repeating its last row, with the count of real rows.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

__all__ = ["Batches", "EpochSampler", "is_ragged", "pad_or_trim_batch", "padded_batches"]


def is_ragged(data) -> bool:
    """Whether ``data`` is a list of clouds of their own sizes: a list, a
    tuple or an object array."""
    return isinstance(data, (list, tuple)) or (isinstance(data, np.ndarray) and data.dtype == object)


@dataclass
class EpochSampler:
    """Draws reference-faithful epoch views of an in-memory dataset.  The
    fields come in the JAX order, so ``num_points`` and later are passed by
    keyword."""

    data: np.ndarray  # [B, N_total, 3], or ragged: B clouds [n_i, 3]
    labels: np.ndarray  # [B]
    masks: np.ndarray | None = None  # [B, N_total], or ragged: [n_i] each
    parts: np.ndarray | None = None  # [B, N_total], or ragged: [n_i] each
    types: np.ndarray | None = None  # [B] (the discriminator's model-type labels)
    num_points: int = 1024
    shuffle: bool = True
    seed: int | None = None

    def __post_init__(self):
        self._rng = np.random.RandomState(self.seed) if self.seed is not None else np.random

    def epoch(self) -> dict[str, np.ndarray]:
        """One epoch view: {"points" [B, num_points, 3], "labels" [B]} and,
        where given, "masks" and "parts" [B, num_points] and "types" [B]."""
        if is_ragged(self.data):
            out = self._ragged_points()
        else:
            idx_pts = np.arange(self.data.shape[1])
            if self.shuffle:
                self._rng.shuffle(idx_pts)
            take = idx_pts[: self.num_points]
            out = {"points": self.data[:, take, :]}
            for key in ("masks", "parts"):
                if getattr(self, key) is not None:
                    out[key] = getattr(self, key)[:, take]
        idx = np.arange(len(self.labels))
        if self.shuffle:
            self._rng.shuffle(idx)
        out = {k: v[idx] for k, v in out.items()}
        out["labels"] = np.asarray(self.labels)[idx]
        if self.types is not None:
            out["types"] = np.asarray(self.types)[idx]
        return out

    def _ragged_points(self) -> dict[str, np.ndarray]:
        """Each cloud's own permutation, its first ``num_points`` points kept
        (float32), masks and parts co-sampled: stacked, in cloud order."""
        picked = {"points": []}
        for key in ("masks", "parts"):
            if getattr(self, key) is not None:
                picked[key] = []
        for i, pc in enumerate(self.data):
            if pc.shape[0] < self.num_points:
                raise ValueError(f"cloud has {pc.shape[0]} < num_points={self.num_points}")
            idx = np.arange(pc.shape[0])
            if self.shuffle:
                self._rng.shuffle(idx)
            take = idx[: self.num_points]
            picked["points"].append(pc[take])
            for key in picked.keys() - {"points"}:
                picked[key].append(np.asarray(getattr(self, key)[i])[take])
        out = {k: np.stack(v) for k, v in picked.items()}
        out["points"] = out["points"].astype(np.float32)
        return out


class Batches:
    """Fixed-size batches over an epoch view, the remainder dropped."""

    def __init__(self, epoch_view: dict[str, np.ndarray], batch_size: int):
        self.view = epoch_view
        self.batch_size = batch_size
        self.num_batches = len(epoch_view["labels"]) // batch_size

    def __len__(self) -> int:
        return self.num_batches

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        bs = self.batch_size
        for i in range(self.num_batches):
            yield {k: v[i * bs : (i + 1) * bs] for k, v in self.view.items()}


def pad_or_trim_batch(arr: np.ndarray, batch_size: int) -> np.ndarray:
    """Pad the leading axis up to ``batch_size`` by repeating the last row,
    or cut it down to ``batch_size``."""
    n = arr.shape[0]
    if n == batch_size:
        return arr
    if n > batch_size:
        return arr[:batch_size]
    return np.concatenate([arr, np.repeat(arr[-1:], batch_size - n, axis=0)], axis=0)


def padded_batches(epoch_view: dict[str, np.ndarray], batch_size: int) -> Iterator[tuple[dict[str, np.ndarray], int]]:
    """Fixed-size batches that keep the remainder: the last partial batch is
    padded to ``batch_size`` (its last row repeated) and each batch comes
    with its count of real rows, which the caller's tallies keep to.  The
    reference evaluates at BATCH_SIZE=1 (evaluate_scenennobjects.py:29): the
    same samples, none dropped."""
    n = len(epoch_view["labels"])
    for i in range(0, n, batch_size):
        chunk = {k: v[i : i + batch_size] for k, v in epoch_view.items()}
        valid = len(chunk["labels"])
        if valid < batch_size:
            chunk = {k: pad_or_trim_batch(v, batch_size) for k, v in chunk.items()}
        yield chunk, valid
