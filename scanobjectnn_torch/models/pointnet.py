"""PointNet model family (counterpart of ``scanobjectnn_tpu/models/pointnet.py``):
the classifier with its T-Nets, the basic classifier, the BGA joint
classification and background segmentation, and part segmentation.
References: pointnet/models/pointnet_cls.py:21-93 (trunk, head, loss),
transform_nets.py:10-95 (the input and feature T-Nets),
pointnet_cls_basic.py:15-60, pointnet_seg.py:24-140, pointnet_partseg.py.

Every per-point MLP is a ``Dense`` stack on [B, N, C]; each of the three
global max-pools over N (the two T-Nets' ``mlp`` and the trunk's ``mlp2``)
ends a ``MaxPoolMLP``, so its last layer pools in the training pool mode
that ``nn.pointnet_modules.configure_training`` gives it: under "keys" in
bf16 it is ``ops.exactpool.dense_bn_exactkey_pool`` (#18 on the card).

Rounding, as in JAX: the input T-Net's product multiplies the f32 points
by the transform promoted to f32 (``mlp1``'s Dense then rounds); the
feature T-Net's product sums in f32 and rounds once to the compute dtype.

Parameter and buffer names follow the JAX tree
(``trunk.input_tnet.mlp.dense_0.kernel``, ``trunk.feature_tnet.transform.kernel``,
``fc_bn1.mean``, ``seg_mlp.dense_3.bias``, under part segmentation
``net.*``), so ``convert.load_jax_variables`` loads a JAX ``variables`` tree
unchanged.  Each class carries ``kind``; in bf16 training the three global
pools take exact-key pooling.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from scanobjectnn_torch.models import losses
from scanobjectnn_torch.models.pointnet2 import dropout
from scanobjectnn_torch.nn.layers import MLP, BatchNorm, Dense, MaxPoolMLP, matmul_f32

__all__ = ["PointNetCls", "PointNetClsBasic", "PointNetPartSeg", "PointNetSeg", "TransformNet"]

GLOBAL_WIDTH = 1024
HEAD_DIMS = (512, 256)


class TransformNet(nn.Module):
    """A T-Net predicting a [B, k, k] transform from [B, N, k] input
    (transform_nets.py:10-95): MLP 64, 128, 1024 → max over N → fc 512,
    256 → ``transform`` (zero-initialised) + the identity, added in the
    compute dtype."""

    def __init__(self, k: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.k = k
        self.mlp = MaxPoolMLP(k, (64, 128, GLOBAL_WIDTH), dim=1, dtype=dtype)
        self.fc = MLP(GLOBAL_WIDTH, HEAD_DIMS, dtype)
        self.transform = Dense(HEAD_DIMS[-1], k * k, dtype, zero_init=True)

    def forward(self, x: torch.Tensor, bn_momentum: float | None = None) -> torch.Tensor:
        out = self.transform(self.fc(self.mlp(x, bn_momentum), bn_momentum))
        eye = torch.eye(self.k, dtype=out.dtype, device=out.device).flatten()
        return (out + eye).reshape(x.shape[0], self.k, self.k)


class _PointNetTrunk(nn.Module):
    """[input T-Net →] MLP 64, 64 [→ feature T-Net] → MLP 64, 128, 1024 →
    max over N.  Returns (point_feat [B, N, 64], global_feat [B, 1024],
    end_points: {"transform": [B, 64, 64]} with the T-Nets)."""

    def __init__(self, use_tnet: bool = True, dtype: torch.dtype | None = None):
        super().__init__()
        self.use_tnet = use_tnet
        if use_tnet:
            self.input_tnet = TransformNet(3, dtype)
        self.mlp1 = MLP(3, (64, 64), dtype)
        if use_tnet:
            self.feature_tnet = TransformNet(64, dtype)
        self.mlp2 = MaxPoolMLP(64, (64, 128, GLOBAL_WIDTH), dim=1, dtype=dtype)

    def forward(self, points: torch.Tensor, bn_momentum: float | None = None):
        end_points = {}
        x = points
        if self.use_tnet:
            # f32 points against the transform promoted to f32 (module doc).
            x = matmul_f32(points, self.input_tnet(points, bn_momentum))
        x = self.mlp1(x, bn_momentum)
        if self.use_tnet:
            t_feat = self.feature_tnet(x, bn_momentum)
            end_points["transform"] = t_feat
            x = matmul_f32(x, t_feat).to(x.dtype)
        return x, self.mlp2(x, bn_momentum), end_points


def _build_head(module: nn.Module, num_classes: int, dtype: torch.dtype | None) -> None:
    """The class head's layers, as children of the model itself (JAX names
    ``fc1``, ``fc_bn1``, ``fc2``, ``fc_bn2``, ``fc3``)."""
    channels = GLOBAL_WIDTH
    for i, f in enumerate(HEAD_DIMS):
        module.add_module(f"fc{i + 1}", Dense(channels, f, dtype))
        module.add_module(f"fc_bn{i + 1}", BatchNorm(f, dtype))
        channels = f
    module.fc3 = Dense(channels, num_classes, dtype)


def _run_head(module: nn.Module, h: torch.Tensor, bn_momentum, generator) -> torch.Tensor:
    """fc 512 → 256, each BN, relu and dropout (keep ``module.dropout_keep``)
    → fc3."""
    for i in range(len(HEAD_DIMS)):
        h = getattr(module, f"fc{i + 1}")(h)
        h = torch.relu(getattr(module, f"fc_bn{i + 1}")(h, bn_momentum))
        h = dropout(h, module.dropout_keep, module.training, generator)
    return module.fc3(h)


class PointNetCls(nn.Module):
    """PointNet classifier (pointnet_cls.py:21-78); ``use_tnet=False`` is
    ``pointnet_cls_basic``.  ``forward(points [B, N, 3])`` returns
    ``{"logits": [B, num_classes], "end_points"}``."""

    kind = "cls"

    def __init__(self, num_classes: int = 15, use_tnet: bool = True, dtype: torch.dtype | None = None):
        super().__init__()
        self.dropout_keep = 0.7
        self.trunk = _PointNetTrunk(use_tnet, dtype)
        _build_head(self, num_classes, dtype)

    def forward(
        self, points: torch.Tensor, bn_momentum: float = 0.9, generator: torch.Generator | None = None
    ) -> dict:
        _, global_feat, end_points = self.trunk(points, bn_momentum)
        return {"logits": _run_head(self, global_feat, bn_momentum, generator), "end_points": end_points}

    @staticmethod
    def loss(outputs: dict, batch: dict, reg_weight: float = 0.001) -> tuple[torch.Tensor, dict]:
        """CE, plus ``reg_weight`` x the feature transform's orthogonality
        penalty where the model has T-Nets: (loss, {"classify_loss"[,
        "mat_diff_loss"], "loss"})."""
        classify = losses.softmax_cross_entropy(outputs["logits"], batch["labels"])
        metrics = {"classify_loss": classify}
        total = classify
        transform = outputs["end_points"].get("transform")
        if transform is not None:
            mat = losses.transform_regularizer(transform)
            metrics["mat_diff_loss"] = mat
            total = total + reg_weight * mat
        metrics["loss"] = total
        return total, metrics


class PointNetClsBasic(PointNetCls):
    """``pointnet_cls_basic`` (pointnet_cls_basic.py:15-60): the classifier
    without T-Nets."""

    def __init__(self, num_classes: int = 15, use_tnet: bool = False, dtype: torch.dtype | None = None):
        super().__init__(num_classes, use_tnet, dtype)


class PointNetSeg(nn.Module):
    """BGA PointNet (pointnet_seg.py:24-111): the class head on the global
    feature, and a per-point head on concat(point_feat, global_feat):
    MLP 512, 256, 128, 128 → ``seg_out`` (``seg_classes``: 2 for the BGA
    mask, the part count under part segmentation).  Returns ``{"logits",
    "seg_logits", "end_points"}``."""

    kind = "seg"
    SEG_DIMS = (512, 256, 128, 128)

    def __init__(self, num_classes: int = 15, seg_classes: int = 2, dtype: torch.dtype | None = None):
        super().__init__()
        self.dropout_keep = 0.7
        self.trunk = _PointNetTrunk(True, dtype)
        _build_head(self, num_classes, dtype)
        self.seg_mlp = MLP(64 + GLOBAL_WIDTH, self.SEG_DIMS, dtype)
        self.seg_out = Dense(self.SEG_DIMS[-1], seg_classes, dtype)

    def forward(
        self, points: torch.Tensor, bn_momentum: float = 0.9, generator: torch.Generator | None = None
    ) -> dict:
        b, n, _ = points.shape
        point_feat, global_feat, end_points = self.trunk(points, bn_momentum)
        logits = _run_head(self, global_feat, bn_momentum, generator)
        seg = torch.cat([point_feat, global_feat[:, None, :].expand(b, n, -1)], dim=-1)
        seg_logits = self.seg_out(self.seg_mlp(seg, bn_momentum))
        return {"logits": logits, "seg_logits": seg_logits, "end_points": end_points}

    @staticmethod
    def loss(
        outputs: dict, batch: dict, seg_weight: float = 0.5, reg_weight: float = 0.001
    ) -> tuple[torch.Tensor, dict]:
        """(1 - w)·CE_cls + w·CE_seg + ``reg_weight`` x the orthogonality
        penalty: (loss, {"loss", "classify_loss", "seg_loss",
        "mat_diff_loss"})."""
        total, classify, seg = losses.joint_cls_seg_loss(
            outputs["logits"], outputs["seg_logits"], batch["labels"], batch["masks"], seg_weight
        )
        mat = losses.transform_regularizer(outputs["end_points"]["transform"])
        total = total + reg_weight * mat
        return total, {"loss": total, "classify_loss": classify, "seg_loss": seg, "mat_diff_loss": mat}


class PointNetPartSeg(nn.Module):
    """Part segmentation (pointnet_partseg.py): ``net`` is ``PointNetSeg``
    with ``num_parts`` per-point classes.  Its class head runs too, as in
    JAX, so its BatchNorms' running statistics move each training step;
    its logits are dropped (its parameters get no gradient).  Returns
    ``{"seg_logits", "end_points"}``."""

    kind = "partseg"

    def __init__(self, num_parts: int = 6, dtype: torch.dtype | None = None):
        super().__init__()
        self.net = PointNetSeg(num_classes=15, seg_classes=num_parts, dtype=dtype)

    def forward(
        self, points: torch.Tensor, bn_momentum: float = 0.9, generator: torch.Generator | None = None
    ) -> dict:
        out = self.net(points, bn_momentum, generator)
        return {"seg_logits": out["seg_logits"], "end_points": out["end_points"]}

    @staticmethod
    def loss(outputs: dict, batch: dict, reg_weight: float = 0.001) -> tuple[torch.Tensor, dict]:
        """Mean per-point CE over all B·N points, in f32, plus ``reg_weight``
        x the orthogonality penalty: (loss, {"loss", "seg_loss",
        "mat_diff_loss"})."""
        seg_logits = outputs["seg_logits"]
        seg = F.cross_entropy(
            seg_logits.float().reshape(-1, seg_logits.shape[-1]), batch["parts"].long().reshape(-1)
        )
        mat = losses.transform_regularizer(outputs["end_points"]["transform"])
        total = seg + reg_weight * mat
        return total, {"loss": total, "seg_loss": seg, "mat_diff_loss": mat}
