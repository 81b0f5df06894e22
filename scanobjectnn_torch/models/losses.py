"""Loss components (counterpart of ``scanobjectnn_tpu/models/losses.py``).

Only the classification loss of the SSG slice is ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["softmax_cross_entropy"]


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean sparse softmax cross-entropy over the batch, in f32
    (tf.nn.sparse_softmax_cross_entropy)."""
    return F.cross_entropy(logits.float(), labels.long())
