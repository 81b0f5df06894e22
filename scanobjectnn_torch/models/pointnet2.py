"""PointNet++ models (counterpart of ``scanobjectnn_tpu/models/pointnet2.py``):
the SSG and MSG classifiers, BGA joint classification and background
segmentation, and part segmentation.  References:
pointnet2/models/pointnet2_cls_ssg.py:23-57, pointnet2_cls_bga.py:21-93,
pointnet2_cls_partseg.py:18-87, and the upstream PointNet++ MSG config
through pointnet_sa_module_msg (pointnet2/utils/pointnet_util.py:156-196).

Each model class carries ``kind``, the targets its loss reads: "cls"
(labels), "seg" (labels and background masks) or "partseg" (part ids).  In
bf16 training the ``Trainer`` gives these four exact-key pooling
(``nn/layers.mlp_final_max``).
"""

from __future__ import annotations

import torch
from torch import nn

from scanobjectnn_torch.models import losses
from scanobjectnn_torch.nn.layers import MLP, BatchNorm, Dense
from scanobjectnn_torch.nn.pointnet_modules import FPModule, SAModule, SAModuleMSG
from scanobjectnn_torch.parallel.mesh import draw_rows

__all__ = ["PointNet2BGA", "PointNet2ClsMSG", "PointNet2ClsSSG", "PointNet2PartSeg", "dropout"]


def dropout(h: torch.Tensor, keep: float, training: bool, generator: torch.Generator | None) -> torch.Tensor:
    """Keep each value with probability ``keep`` and scale kept values by
    1/keep, as flax ``nn.Dropout`` does, drawing the mask from ``generator``;
    the identity at eval.  Inside ``parallel.global_batch`` the mask is this
    rank's rows of the global batch's mask."""
    if not training:
        return h
    if generator is None:
        raise ValueError("training draws the dropout mask: pass a torch.Generator")

    def draw(rows: int, mine: slice) -> torch.Tensor:
        probs = torch.full((rows, *h.shape[1:]), keep, device=generator.device)
        return torch.bernoulli(probs, generator=generator)

    mask = draw_rows(draw, h.shape[0]).to(device=h.device, dtype=torch.bool)
    return torch.where(mask, h / keep, torch.zeros((), dtype=h.dtype, device=h.device))


def _sa_stack(module: nn.Module, sa_configs, dtype: torch.dtype | None) -> int:
    """Add ``sa1``, ``sa2``, ... to ``module``; returns the last width."""
    channels = 0
    for i, (npoint, radius, nsample, mlp, group_all) in enumerate(sa_configs):
        module.add_module(
            f"sa{i + 1}", SAModule(npoint, radius, nsample, mlp, channels, group_all=group_all, dtype=dtype)
        )
        channels = mlp[-1]
    return channels


class _ClsHead(nn.Module):
    """FC 512 → dropout → 256 → dropout → num_classes (ssg :41-45).

    Dropout keeps each value with probability ``dropout_keep`` (0.5); the
    mask is drawn from an explicit ``torch.Generator``.  It is the identity
    at eval."""

    def __init__(self, in_features: int, num_classes: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.dropout_keep = 0.5
        for i, f in enumerate(PointNet2ClsSSG.HEAD_DIMS):
            self.add_module(f"fc{i + 1}", Dense(in_features, f, dtype))
            self.add_module(f"bn{i + 1}", BatchNorm(f, dtype))
            in_features = f
        self.fc3 = Dense(in_features, num_classes, dtype)

    def forward(
        self, h: torch.Tensor, bn_momentum: float | None = None, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        for i in range(len(PointNet2ClsSSG.HEAD_DIMS)):
            h = getattr(self, f"fc{i + 1}")(h)
            h = torch.relu(getattr(self, f"bn{i + 1}")(h, bn_momentum))
            h = dropout(h, self.dropout_keep, self.training, generator)
        return self.fc3(h)


class PointNet2ClsSSG(nn.Module):
    """SSG classifier: SA(512,0.2,32,[64,64,128]) → SA(128,0.4,64,[128,128,256])
    → SA(all,[256,512,1024]) → FC head.  ``forward(points [B, N, 3])``
    returns ``{"logits": [B, num_classes], "end_points": {}}``.

    In training mode BN uses batch statistics and updates its running stats
    with ``bn_momentum``, and the head's dropout draws from ``generator``."""

    kind = "cls"
    # (npoint, radius, nsample, mlp, group_all) per SA layer, in order.
    SA_CONFIGS = (
        (512, 0.2, 32, (64, 64, 128), False),
        (128, 0.4, 64, (128, 128, 256), False),
        (None, None, None, (256, 512, 1024), True),
    )
    HEAD_DIMS = (512, 256)  # _ClsHead fc1/fc2 widths (fc3 = num_classes)

    def __init__(self, num_classes: int = 15, dtype: torch.dtype | None = None):
        super().__init__()
        self.head = _ClsHead(_sa_stack(self, self.SA_CONFIGS, dtype), num_classes, dtype)

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


class PointNet2ClsMSG(nn.Module):
    """Multi-scale-grouping classifier: SA-MSG(512; r 0.1, 0.2, 0.4; K 16,
    32, 128) → SA-MSG(128; r 0.2, 0.4, 0.8; K 32, 64, 128) →
    SA(all,[256,512,1024]) → the SSG head.  The second layer's scales are
    lifted (320 + 3 input channels, wider than each first layer).
    ``forward(points [B, N, 3])`` returns ``{"logits", "end_points"}``;
    training as ``PointNet2ClsSSG``.  JAX's ``remat_scales`` is not ported:
    it changes no value."""

    kind = "cls"
    # (npoint, radius_list, nsample_list, mlp_list) per MSG layer, in order.
    MSG_CONFIGS = (
        (512, (0.1, 0.2, 0.4), (16, 32, 128), ((32, 32, 64), (64, 64, 128), (64, 96, 128))),
        (128, (0.2, 0.4, 0.8), (32, 64, 128), ((64, 64, 128), (128, 128, 256), (128, 128, 256))),
    )
    GROUP_ALL_MLP = (256, 512, 1024)

    def __init__(self, num_classes: int = 15, dtype: torch.dtype | None = None):
        super().__init__()
        channels = 0
        for i, (npoint, radii, nsamples, mlps) in enumerate(self.MSG_CONFIGS):
            self.add_module(f"sa{i + 1}", SAModuleMSG(npoint, radii, nsamples, mlps, channels, dtype=dtype))
            channels = sum(mlp[-1] for mlp in mlps)
        i = len(self.MSG_CONFIGS)
        self.add_module(
            f"sa{i + 1}", SAModule(None, None, None, self.GROUP_ALL_MLP, channels, group_all=True, dtype=dtype)
        )
        self.head = _ClsHead(self.GROUP_ALL_MLP[-1], num_classes, dtype)

    def forward(
        self, points: torch.Tensor, bn_momentum: float = 0.9, generator: torch.Generator | None = None
    ) -> dict:
        xyz, feats = points, None
        for i in range(len(self.MSG_CONFIGS) + 1):
            xyz, feats = getattr(self, f"sa{i + 1}")(xyz, feats, bn_momentum)
        logits = self.head(feats.reshape(points.shape[0], -1), bn_momentum, generator)
        return {"logits": logits, "end_points": {}}

    loss = staticmethod(PointNet2ClsSSG.loss)


class _PointNet2Seg(nn.Module):
    """The SA trunk and FP decoder that BGA and part segmentation share:
    SA(512,0.2,64,[64,64,128]) → SA(128,0.4,64,[128,128,256]) →
    SA(all,[256,512,1024]); fp1 (256,256) from the coarsest level, fp2
    (256,128), fp3 (128,128,128) up to the input points; seg_fc1 128 →
    dropout → seg_fc2.  A subclass adds the head and ``fp1_source``, the
    width of what fp1 interpolates."""

    SA_CONFIGS = (
        (512, 0.2, 64, (64, 64, 128), False),
        (128, 0.4, 64, (128, 128, 256), False),
        (None, None, None, (256, 512, 1024), True),
    )
    FP_MLPS = ((256, 256), (256, 128), (128, 128, 128))
    SEG_FC = 128

    def _add_decoder(self, fp1_source: int, seg_out: int, dtype: torch.dtype | None) -> None:
        sa_widths = [mlp[-1] for *_, mlp, _ in self.SA_CONFIGS]
        skips = (sa_widths[1], sa_widths[0], 0)  # points1 of fp1, fp2, fp3
        source = fp1_source
        for i, (mlp, skip) in enumerate(zip(self.FP_MLPS, skips)):
            self.add_module(f"fp{i + 1}", FPModule(mlp, source + skip, dtype))
            source = mlp[-1]
        self.seg_fc1 = MLP(source, (self.SEG_FC,), dtype)
        self.seg_fc2 = Dense(self.SEG_FC, seg_out, dtype)

    def _trunk(self, points: torch.Tensor, bn_momentum: float):
        """[(xyz, feats)] of levels 0 to 3; level 0 has no features."""
        levels = [(points[..., :3], None)]
        for i in range(len(self.SA_CONFIGS)):
            levels.append(getattr(self, f"sa{i + 1}")(*levels[-1], bn_momentum))
        return levels

    def _decode(self, levels, source: torch.Tensor, bn_momentum: float, generator) -> torch.Tensor:
        """fp1 interpolates ``source`` from level 3 onto level 2, fp2 onto
        level 1, fp3 onto the input points; then the seg head."""
        for i, fine in enumerate((2, 1, 0)):
            xyz1, points1 = levels[fine]
            source = getattr(self, f"fp{i + 1}")(xyz1, levels[fine + 1][0], points1, source, bn_momentum)
        seg = self.seg_fc1(source, bn_momentum)
        seg = dropout(seg, self.dropout_keep, self.training, generator)
        return self.seg_fc2(seg)


class PointNet2BGA(_PointNet2Seg):
    """BGA PointNet++: the SA trunk → class head (fc1 512, fc2 256, fc3)
    whose 256-d activation after bn2/relu, before the second dropout, is the
    class vector; fp1 interpolates the class vector alone (the reference's
    l3_points concat is commented out), then the FP decoder → per-point
    2-way background mask.  ``forward`` returns ``{"logits", "seg_logits",
    "end_points"}``."""

    kind = "seg"
    FC_DIMS = (512, 256)

    def __init__(self, num_classes: int = 15, seg_classes: int = 2, dtype: torch.dtype | None = None):
        super().__init__()
        self.dropout_keep = 0.5
        channels = _sa_stack(self, self.SA_CONFIGS, dtype)
        for i, f in enumerate(self.FC_DIMS):
            self.add_module(f"fc{i + 1}", Dense(channels, f, dtype))
            self.add_module(f"bn{i + 1}", BatchNorm(f, dtype))
            channels = f
        self.fc3 = Dense(channels, num_classes, dtype)
        self._add_decoder(channels, seg_classes, dtype)

    def forward(
        self, points: torch.Tensor, bn_momentum: float = 0.9, generator: torch.Generator | None = None
    ) -> dict:
        levels = self._trunk(points, bn_momentum)
        h = levels[3][1].reshape(points.shape[0], -1)
        h = torch.relu(self.bn1(self.fc1(h), bn_momentum))
        h = dropout(h, self.dropout_keep, self.training, generator)
        h = torch.relu(self.bn2(self.fc2(h), bn_momentum))
        class_vector = h[:, None, :]  # [B, 1, 256]
        h = dropout(h, self.dropout_keep, self.training, generator)
        logits = self.fc3(h)
        seg_logits = self._decode(levels, class_vector, bn_momentum, generator)
        return {"logits": logits, "seg_logits": seg_logits, "end_points": {}}

    @staticmethod
    def loss(outputs: dict, batch: dict, seg_weight: float = 0.5) -> tuple[torch.Tensor, dict]:
        """(1 - w)·CE_cls + w·CE_seg: (loss, {"loss", "classify_loss", "seg_loss"})."""
        total, classify, seg = losses.joint_cls_seg_loss(
            outputs["logits"], outputs["seg_logits"], batch["labels"], batch["masks"], seg_weight
        )
        return total, {"loss": total, "classify_loss": classify, "seg_loss": seg}


class PointNet2PartSeg(_PointNet2Seg):
    """Part segmentation: the SA trunk → FP decoder, fp1 interpolating the
    1024-d global feature → per-point part logits.  ``forward`` returns
    ``{"seg_logits", "end_points"}``."""

    kind = "partseg"

    def __init__(self, num_parts: int = 6, dtype: torch.dtype | None = None):
        super().__init__()
        self.dropout_keep = 0.5
        channels = _sa_stack(self, self.SA_CONFIGS, dtype)
        self._add_decoder(channels, num_parts, dtype)

    def forward(
        self, points: torch.Tensor, bn_momentum: float = 0.9, generator: torch.Generator | None = None
    ) -> dict:
        levels = self._trunk(points, bn_momentum)
        seg_logits = self._decode(levels, levels[3][1], bn_momentum, generator)
        return {"seg_logits": seg_logits, "end_points": {}}

    @staticmethod
    def loss(outputs: dict, batch: dict) -> tuple[torch.Tensor, dict]:
        """Per-point CE: (loss, {"loss", "seg_loss"})."""
        seg = losses.per_point_cross_entropy(outputs["seg_logits"], batch["parts"])
        return seg, {"loss": seg, "seg_loss": seg}
