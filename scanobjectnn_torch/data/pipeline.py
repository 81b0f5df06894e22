"""Epoch and batch pipeline, numpy only (counterpart of
``scanobjectnn_tpu/data/pipeline.py``).

Reference semantics (data_utils.py:171-186), kept exactly so that the port
visits clouds and points in the JAX package's order under the same seed:
  * each epoch draws ONE point permutation shared by every cloud and keeps
    its first ``num_points`` points;
  * then the cloud order is shuffled;
  * batches are fixed-size and drop the remainder (pointnet2/train.py:237).
Ported: rectangular point clouds with labels.  Masks, parts, types and
ragged (per-cloud size) input wait for the slices that read them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

__all__ = ["Batches", "EpochSampler"]


@dataclass
class EpochSampler:
    """Draws reference-faithful epoch views of an in-memory dataset."""

    data: np.ndarray  # [B, N_total, 3]
    labels: np.ndarray  # [B]
    num_points: int = 1024
    shuffle: bool = True
    seed: int | None = None

    def __post_init__(self):
        if not (isinstance(self.data, np.ndarray) and self.data.ndim == 3):
            raise ValueError("EpochSampler takes rectangular clouds [B, N, 3]; ragged input is not ported yet")
        self._rng = np.random.RandomState(self.seed) if self.seed is not None else np.random

    def epoch(self) -> dict[str, np.ndarray]:
        """One epoch view: {"points" [B, num_points, 3], "labels" [B]}."""
        idx_pts = np.arange(self.data.shape[1])
        if self.shuffle:
            self._rng.shuffle(idx_pts)
        points = self.data[:, idx_pts[: self.num_points], :]
        idx = np.arange(len(self.labels))
        if self.shuffle:
            self._rng.shuffle(idx)
        return {"points": points[idx], "labels": self.labels[idx]}


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
