"""Epoch and batch pipeline, numpy only (counterpart of
``scanobjectnn_tpu/data/pipeline.py``).

Reference semantics (data_utils.py:171-233), kept exactly so that the port
visits clouds and points in the JAX package's order under the same seed:
  * each epoch draws ONE point permutation shared by every cloud and keeps
    its first ``num_points`` points; masks and parts take the same points;
  * then the cloud order is shuffled;
  * training batches are fixed-size and drop the remainder
    (pointnet2/train.py:237); evaluation's ``padded_batches`` keeps it,
    padded by repeating its last row, with the count of real rows.
Ported: rectangular point clouds with labels, masks and parts.  Types and
ragged (per-cloud size) input wait for the slices that read them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

__all__ = ["Batches", "EpochSampler", "pad_or_trim_batch", "padded_batches"]


@dataclass
class EpochSampler:
    """Draws reference-faithful epoch views of an in-memory dataset.  The
    fields come in the JAX order, so ``num_points`` and later are passed by
    keyword."""

    data: np.ndarray  # [B, N_total, 3]
    labels: np.ndarray  # [B]
    masks: np.ndarray | None = None  # [B, N_total]
    parts: np.ndarray | None = None  # [B, N_total]
    num_points: int = 1024
    shuffle: bool = True
    seed: int | None = None

    def __post_init__(self):
        if not (isinstance(self.data, np.ndarray) and self.data.ndim == 3):
            raise ValueError("EpochSampler takes rectangular clouds [B, N, 3]; ragged input is not ported yet")
        self._rng = np.random.RandomState(self.seed) if self.seed is not None else np.random

    def epoch(self) -> dict[str, np.ndarray]:
        """One epoch view: {"points" [B, num_points, 3], "labels" [B]} and,
        where given, "masks" and "parts" [B, num_points]."""
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
        out["labels"] = self.labels[idx]
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
