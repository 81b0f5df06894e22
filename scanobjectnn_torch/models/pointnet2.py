"""PointNet++ SSG classifier (counterpart of
``scanobjectnn_tpu/models/pointnet2.py``; reference
pointnet2/models/pointnet2_cls_ssg.py:23-57)."""

from __future__ import annotations

import torch
from torch import nn

from scanobjectnn_torch.models import losses
from scanobjectnn_torch.nn.layers import BatchNorm, Dense
from scanobjectnn_torch.nn.pointnet_modules import SAModule

__all__ = ["PointNet2ClsSSG"]


class _ClsHead(nn.Module):
    """FC 512 → dropout → 256 → dropout → num_classes (ssg :41-45).

    Dropout keeps each value with probability ``dropout_keep`` (0.5) and
    scales kept values by 1/keep, as flax ``nn.Dropout`` does; the mask is
    drawn from an explicit ``torch.Generator``.  It is the identity at
    eval."""

    def __init__(self, in_features: int, num_classes: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.dropout_keep = 0.5
        for i, f in enumerate(PointNet2ClsSSG.HEAD_DIMS):
            self.add_module(f"fc{i + 1}", Dense(in_features, f, dtype))
            self.add_module(f"bn{i + 1}", BatchNorm(f, dtype))
            in_features = f
        self.fc3 = Dense(in_features, num_classes, dtype)

    def _dropout(self, h: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
        if not self.training:
            return h
        if generator is None:
            raise ValueError("training draws the dropout mask: pass a torch.Generator")
        probs = torch.full(h.shape, self.dropout_keep, device=generator.device)
        keep = torch.bernoulli(probs, generator=generator).to(device=h.device, dtype=torch.bool)
        return torch.where(keep, h / self.dropout_keep, torch.zeros((), dtype=h.dtype, device=h.device))

    def forward(
        self, h: torch.Tensor, bn_momentum: float | None = None, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        for i in range(len(PointNet2ClsSSG.HEAD_DIMS)):
            h = getattr(self, f"fc{i + 1}")(h)
            h = torch.relu(getattr(self, f"bn{i + 1}")(h, bn_momentum))
            h = self._dropout(h, generator)
        return self.fc3(h)


class PointNet2ClsSSG(nn.Module):
    """SSG classifier: SA(512,0.2,32,[64,64,128]) → SA(128,0.4,64,[128,128,256])
    → SA(all,[256,512,1024]) → FC head.  ``forward(points [B, N, 3])``
    returns ``{"logits": [B, num_classes], "end_points": {}}``.

    In training mode BN uses batch statistics and updates its running stats
    with ``bn_momentum``, and the head's dropout draws from ``generator``."""

    # (npoint, radius, nsample, mlp, group_all) per SA layer, in order.
    SA_CONFIGS = (
        (512, 0.2, 32, (64, 64, 128), False),
        (128, 0.4, 64, (128, 128, 256), False),
        (None, None, None, (256, 512, 1024), True),
    )
    HEAD_DIMS = (512, 256)  # _ClsHead fc1/fc2 widths (fc3 = num_classes)

    def __init__(self, num_classes: int = 15, dtype: torch.dtype | None = None):
        super().__init__()
        channels = 0
        for i, (npoint, radius, nsample, mlp, group_all) in enumerate(self.SA_CONFIGS):
            self.add_module(
                f"sa{i + 1}",
                SAModule(npoint, radius, nsample, mlp, channels, group_all=group_all, dtype=dtype),
            )
            channels = mlp[-1]
        self.head = _ClsHead(channels, num_classes, dtype)

    def forward(
        self, points: torch.Tensor, bn_momentum: float = 0.9, generator: torch.Generator | None = None
    ) -> dict:
        xyz, feats = points, None
        for i in range(len(self.SA_CONFIGS)):
            xyz, feats = getattr(self, f"sa{i + 1}")(xyz, feats, bn_momentum)
        logits = self.head(feats.reshape(points.shape[0], -1), bn_momentum, generator)
        return {"logits": logits, "end_points": {}}

    @staticmethod
    def loss(outputs: dict, batch: dict) -> tuple[torch.Tensor, dict]:
        """Mean softmax cross-entropy: (loss, {"loss", "classify_loss"})."""
        loss = losses.softmax_cross_entropy(outputs["logits"], batch["labels"])
        return loss, {"loss": loss, "classify_loss": loss}
