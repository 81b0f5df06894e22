"""Loss components (counterpart of ``scanobjectnn_tpu/models/losses.py``).

Ported: the classification loss, DGCNN's label-smoothed loss, the
per-point segmentation loss, the BGA joint loss and the T-Net
orthogonality penalty.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = [
    "joint_cls_seg_loss",
    "label_smoothed_cross_entropy",
    "per_point_cross_entropy",
    "softmax_cross_entropy",
    "transform_regularizer",
]


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean sparse softmax cross-entropy over the batch, in f32
    (tf.nn.sparse_softmax_cross_entropy)."""
    return F.cross_entropy(logits.float(), labels.long())


def label_smoothed_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, smoothing: float = 0.2) -> torch.Tensor:
    """DGCNN's loss (dgcnn get_loss): the mean cross-entropy in f32 against
    ``(1 - s)·onehot + s/K``."""
    logp = F.log_softmax(logits.float(), dim=-1)
    soft = F.one_hot(labels.long(), logits.shape[-1]).float() * (1.0 - smoothing) + smoothing / logits.shape[-1]
    return -(soft * logp).sum(-1).mean()


def per_point_cross_entropy(seg_logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-point softmax cross-entropy [B, N, C], [B, N] in f32, averaged
    over the points of each cloud, then over the clouds (the JAX
    ``mean(mean(per_point, axis=1))``)."""
    b, n, c = seg_logits.shape
    per_point = F.cross_entropy(seg_logits.float().reshape(b * n, c), targets.long().reshape(b * n), reduction="none")
    return per_point.reshape(b, n).mean(dim=1).mean()


def joint_cls_seg_loss(
    cls_logits: torch.Tensor,
    seg_logits: torch.Tensor,
    labels: torch.Tensor,
    masks: torch.Tensor,
    seg_weight: float = 0.5,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """BGA joint loss (1 - w)·CE_cls + w·CE_seg (pointnet2_cls_bga.py:78-93):
    returns (total, classify_loss, seg_loss)."""
    classify_loss = softmax_cross_entropy(cls_logits, labels)
    seg_loss = per_point_cross_entropy(seg_logits, masks)
    total = (1.0 - seg_weight) * classify_loss + seg_weight * seg_loss
    return total, classify_loss, seg_loss


def transform_regularizer(transform: torch.Tensor) -> torch.Tensor:
    """Orthogonality penalty ``0.5·Σ(T·Tᵀ − I)²`` over the batch of [B, K,
    K] transforms, in f32 (tf.nn.l2_loss; pointnet_cls.py:86-91).  The
    product is written out as f32 multiplies and sums, so it never runs in
    TF32 whatever the matmul flags say."""
    t = transform.float()
    gram = (t[:, :, None, :] * t[:, None, :, :]).sum(-1)  # [B, K, K]
    diff = gram - torch.eye(t.shape[-1], dtype=torch.float32, device=t.device)
    return 0.5 * torch.square(diff).sum()
