"""PointCNN: the X-Conv classifier and the encoder/decoder segmentation
network (counterpart of ``scanobjectnn_tpu/models/pointcnn.py``).
References: PointCNN/pointcnn.py:55-277 (the xconv stack with random, fps
or ids query sampling, the xdconv decoder, the FC heads; PointCNN_SEG's
shared encoder), pointcnn_cls.py:10-16 (the eval mean over representative
points), the settings modules pointcnn_cls/modelnet_x3_l4.py and
pointcnn_seg/object_dataset_x3.py, and the losses of train.py:139-140
(labels tiled over the representative points) and train_seg.py:137-146.

``PointCNNSetting`` carries both halves of a settings module: the
architecture and the training schedule (``recipe()``; the classes carry it
as ``recipe`` for the ``Trainer``).  "random" sampling is a prefix slice of
the cloud, which the epoch pipeline has already shuffled; "fps" runs the
FPS kernel; "ids" draws from the forward's generator, or, when none is
given, each sampling layer from a generator seeded 0 (each JAX layer takes
``PRNGKey(0)``).  The heads' dropout takes flax's *rate*; rate 0 draws
nothing.  ``logits`` is the mean of the per-point logits (the logits layer
is affine, so this is the reference's eval path).  BN momentum is fixed at
0.99: the ``bn_momentum`` a caller passes is ignored, as in the JAX package.

Parameter and buffer names follow the JAX tree
(``backbone.xconv_1.X_0.kernel``, ``backbone.xdconv_1_fuse.bn.mean``,
``head.fc_logits.bias``, ``cls_head.fc_class__logits.kernel``,
``seg_head.fc_seg__logits.kernel``: the double underscore is the prefix
plus "_logits"), so ``convert.load_jax_variables`` loads a JAX ``variables``
tree unchanged.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from scanobjectnn_torch import ops
from scanobjectnn_torch.models import losses
from scanobjectnn_torch.models.pointnet2 import dropout
from scanobjectnn_torch.models.recipes import TrainRecipe
from scanobjectnn_torch.nn.xconv import EluDense, XConv, inverse_density_sample

__all__ = [
    "FCParam",
    "PointCNNCls",
    "PointCNNSeg",
    "PointCNNSetting",
    "XConvParam",
    "XDConvParam",
    "modelnet_x3_l4",
    "object_dataset_x3",
]


@dataclass(frozen=True)
class XConvParam:
    K: int
    D: int
    P: int  # -1: keep all points
    C: int
    links: tuple[int, ...] = ()


@dataclass(frozen=True)
class XDConvParam:
    K: int
    D: int
    pts_layer_idx: int
    qrs_layer_idx: int


@dataclass(frozen=True)
class FCParam:
    C: int
    dropout_rate: float


@dataclass(frozen=True)
class PointCNNSetting:
    """A settings module: the architecture and the training half
    (lr base 0.01, staircase decay 0.5 every 8000 steps floored at 1e-6,
    weight decay 1e-5, Adam epsilon 1e-2, rotation y in [0, π] uniform and
    per-axis gaussian scaling σ=0.1, no jitter)."""

    xconv_params: tuple[XConvParam, ...]
    fc_params: tuple[FCParam, ...] = ()
    xdconv_params: tuple[XDConvParam, ...] = ()
    fc_params_classification: tuple[FCParam, ...] = ()
    fc_params_segmentation: tuple[FCParam, ...] = ()
    with_X_transformation: bool = True
    with_global: bool = True
    sorting_method: str | None = None
    sampling: str = "random"  # random | fps | ids
    data_dim: int = 3
    use_extra_features: bool = False
    learning_rate_base: float = 0.01
    decay_steps: int = 8000  # global steps (PointCNN/train.py:160)
    decay_rate: float = 0.5
    learning_rate_min: float = 1e-6
    weight_decay: float = 1e-5
    epsilon: float = 1e-2  # AdamOptimizer epsilon (train.py:167)
    jitter: float = 0.0
    rotation_range: tuple = (0.0, math.pi, 0.0, "u")
    scaling_range: tuple = (0.1, 0.1, 0.1, "g")

    def recipe(self) -> TrainRecipe:
        """The training half as a ``TrainRecipe`` for the ``Trainer``."""
        return TrainRecipe(
            learning_rate_base=self.learning_rate_base, decay_steps=self.decay_steps,
            decay_rate=self.decay_rate, learning_rate_min=self.learning_rate_min,
            weight_decay=self.weight_decay, adam_epsilon=self.epsilon,
            jitter=self.jitter, rotation_range=self.rotation_range, scaling_range=self.scaling_range,
        )


def modelnet_x3_l4(x: int = 3) -> PointCNNSetting:
    """PointCNN/pointcnn_cls/modelnet_x3_l4.py:54-67."""
    return PointCNNSetting(
        xconv_params=(
            XConvParam(8, 1, -1, 16 * x),
            XConvParam(12, 2, 384, 32 * x),
            XConvParam(16, 2, 128, 64 * x),
            XConvParam(16, 3, 128, 128 * x),
        ),
        fc_params=(FCParam(128 * x, 0.0), FCParam(64 * x, 0.8)),
        data_dim=6,
    )


def object_dataset_x3(x: int = 3) -> PointCNNSetting:
    """PointCNN/pointcnn_seg/object_dataset_x3.py:49-73."""
    return PointCNNSetting(
        xconv_params=(
            XConvParam(8, 1, -1, 16 * x),
            XConvParam(12, 2, 384, 32 * x),
            XConvParam(16, 2, 128, 64 * x),
            XConvParam(16, 3, 128, 128 * x),
        ),
        xdconv_params=(
            XDConvParam(16, 6, 3, 3),
            XDConvParam(16, 6, 3, 2),
            XDConvParam(12, 6, 2, 1),
            XDConvParam(8, 6, 1, 0),
            XDConvParam(8, 4, 0, 0),
        ),
        fc_params_classification=(FCParam(128 * x, 0.0), FCParam(64 * x, 0.8)),
        fc_params_segmentation=(FCParam(32 * x, 0.0), FCParam(32 * x, 0.5)),
        data_dim=3,
    )


class _PointCNNBackbone(nn.Module):
    """The xconv encoder and, with ``decode``, the xdconv decoder and its
    fuse layers.  ``forward`` returns (layer_pts, layer_fts), indexed as the
    reference's ``self.layer_pts`` / ``self.layer_fts`` (entry 0: the
    input).  ``widths`` holds the channels of each ``layer_fts`` entry."""

    def __init__(self, setting: PointCNNSetting, decode: bool, in_features: int, dtype=None):
        super().__init__()
        s = self.setting = setting
        self.decode = decode
        widths = [0]
        if in_features:
            self.features_hd = EluDense(in_features, s.xconv_params[0].C // 2, dtype=dtype)
            widths = [s.xconv_params[0].C // 2]
        for layer_idx, lp in enumerate(s.xconv_params):
            if layer_idx == 0:
                c_pts_fts = lp.C // 2 if not widths[-1] else lp.C // 4
                depth_multiplier = 4
            else:
                c_prev = s.xconv_params[layer_idx - 1].C
                c_pts_fts, depth_multiplier = c_prev // 4, math.ceil(lp.C / c_prev)
            with_global = s.with_global and layer_idx == len(s.xconv_params) - 1
            self.add_module(f"xconv_{layer_idx + 1}", XConv(
                lp.K, lp.D, lp.C, c_pts_fts, depth_multiplier, widths[-1], s.with_X_transformation,
                with_global, s.sorting_method, dtype,
            ))
            widths.append(sum(widths[link] for link in lp.links) + lp.C + (lp.C // 4 if with_global else 0))
        if decode:
            for layer_idx, dp in enumerate(s.xdconv_params):
                c_fts = widths[dp.pts_layer_idx + 1] if layer_idx == 0 else widths[-1]
                c = s.xconv_params[dp.qrs_layer_idx].C
                c_prev = s.xconv_params[dp.pts_layer_idx].C
                self.add_module(f"xdconv_{layer_idx + 1}", XConv(
                    dp.K, dp.D, c, c_prev // 4, 1, c_fts, s.with_X_transformation,
                    sorting_method=s.sorting_method, dtype=dtype,
                ))
                self.add_module(f"xdconv_{layer_idx + 1}_fuse",
                                EluDense(c + widths[dp.qrs_layer_idx + 1], c, dtype=dtype))
                widths.append(c)
        self.widths = tuple(widths)

    def _queries(self, layer_idx: int, pts: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
        s = self.setting
        lp = s.xconv_params[layer_idx]
        if lp.P == -1 or (layer_idx > 0 and lp.P == s.xconv_params[layer_idx - 1].P):
            return pts
        if s.sampling == "fps":
            return ops.gather_point(pts, ops.farthest_point_sample(pts, lp.P))
        if s.sampling == "ids":
            if generator is None:
                generator = torch.Generator(device=pts.device).manual_seed(0)
            return ops.gather_point(pts, inverse_density_sample(generator, pts, lp.K, lp.P))
        if s.sampling == "random":
            # The epoch pipeline shuffles the points, so a prefix is a
            # uniform sample (pointcnn.py:101).
            return pts[:, : lp.P, :]
        raise ValueError(f"unknown sampling {s.sampling!r}")

    def forward(self, points: torch.Tensor, features: torch.Tensor | None, generator=None):
        s = self.setting
        layer_pts = [points]
        layer_fts = [None if features is None else self.features_hd(features)]
        for layer_idx, lp in enumerate(s.xconv_params):
            pts, fts = layer_pts[-1], layer_fts[-1]
            qrs = self._queries(layer_idx, pts, generator)
            layer_pts.append(qrs)
            fts_xconv = getattr(self, f"xconv_{layer_idx + 1}")(pts, fts, qrs)
            p = qrs.shape[1]
            linked = [layer_fts[link][:, :p, :] for link in lp.links if layer_fts[link] is not None]
            layer_fts.append(torch.cat(linked + [fts_xconv], dim=-1) if linked else fts_xconv)
        if self.decode:
            for layer_idx, dp in enumerate(s.xdconv_params):
                pts = layer_pts[dp.pts_layer_idx + 1]
                fts = layer_fts[dp.pts_layer_idx + 1] if layer_idx == 0 else layer_fts[-1]
                qrs = layer_pts[dp.qrs_layer_idx + 1]
                fts_xdconv = getattr(self, f"xdconv_{layer_idx + 1}")(pts, fts, qrs)
                fuse = getattr(self, f"xdconv_{layer_idx + 1}_fuse")
                layer_pts.append(qrs)
                layer_fts.append(fuse(torch.cat([fts_xdconv, layer_fts[dp.qrs_layer_idx + 1]], dim=-1)))
        return layer_pts, layer_fts


class _FCHead(nn.Module):
    """``EluDense`` layers ``{prefix}{i}``, each followed by dropout at its
    rate, then the affine logits layer ``{prefix}_logits``."""

    def __init__(self, in_features: int, fc_params, num_out: int, prefix: str = "fc", dtype=None):
        super().__init__()
        self.rates = tuple(fc.dropout_rate for fc in fc_params)
        self.prefix = prefix
        for i, fc in enumerate(fc_params):
            self.add_module(f"{prefix}{i}", EluDense(in_features, fc.C, dtype=dtype))
            in_features = fc.C
        self.add_module(f"{prefix}_logits", EluDense(in_features, num_out, with_bn=False, activation=False,
                                                     dtype=dtype))

    def forward(self, h: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        for i, rate in enumerate(self.rates):
            h = getattr(self, f"{self.prefix}{i}")(h)
            if rate:
                h = dropout(h, 1.0 - rate, self.training, generator)
        return getattr(self, f"{self.prefix}_logits")(h)


def _split_features(setting: PointCNNSetting, points: torch.Tensor):
    if setting.use_extra_features and points.shape[-1] > 3:
        return points[..., :3], points[..., 3:]
    return points[..., :3], None


def _tiled_cross_entropy(point_logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE of every representative point against its cloud's label
    (PointCNN/train.py:139-140)."""
    b, p, c = point_logits.shape
    return losses.softmax_cross_entropy(point_logits.reshape(b * p, c), labels[:, None].expand(b, p).reshape(-1))


class PointCNNCls(nn.Module):
    """PointCNN classifier.  ``forward(points [B, N, 3])`` returns
    ``{"logits" [B, C] (the mean over points), "point_logits" [B, P, C],
    "end_points"}``."""

    kind = "cls"
    recipe = modelnet_x3_l4().recipe()

    def __init__(self, num_classes: int = 15, setting: PointCNNSetting | None = None, dtype=None):
        super().__init__()
        self.setting = setting = setting or modelnet_x3_l4()
        extra = setting.data_dim - 3 if setting.use_extra_features else 0
        self.backbone = _PointCNNBackbone(setting, False, extra, dtype)
        self.head = _FCHead(self.backbone.widths[-1], setting.fc_params, num_classes, dtype=dtype)

    def forward(self, points: torch.Tensor, bn_momentum: float = 0.99, generator: torch.Generator | None = None):
        _, layer_fts = self.backbone(*_split_features(self.setting, points), generator)
        point_logits = self.head(layer_fts[-1], generator)
        return {"logits": point_logits.mean(dim=1), "point_logits": point_logits, "end_points": {}}

    @staticmethod
    def loss(outputs: dict, batch: dict) -> tuple[torch.Tensor, dict]:
        """Tiled-label CE: (loss, {"loss", "classify_loss"})."""
        loss = _tiled_cross_entropy(outputs["point_logits"], batch["labels"])
        return loss, {"loss": loss, "classify_loss": loss}


class PointCNNSeg(nn.Module):
    """PointCNN_SEG: the shared encoder, a classification branch on the
    encoder's last features and the xdconv decoder's segmentation branch.
    ``forward`` returns ``{"logits", "point_logits", "seg_logits" [B, N,
    seg_classes], "end_points"}``."""

    kind = "seg"
    recipe = object_dataset_x3().recipe()

    def __init__(self, num_classes: int = 15, seg_classes: int = 2, setting: PointCNNSetting | None = None,
                 dtype=None):
        super().__init__()
        self.setting = setting = setting or object_dataset_x3()
        extra = setting.data_dim - 3 if setting.use_extra_features else 0
        self.backbone = _PointCNNBackbone(setting, True, extra, dtype)
        widths = self.backbone.widths
        self.cls_head = _FCHead(widths[len(setting.xconv_params)], setting.fc_params_classification, num_classes,
                                prefix="fc_class_", dtype=dtype)
        self.seg_head = _FCHead(widths[-1], setting.fc_params_segmentation, seg_classes, prefix="fc_seg_",
                                dtype=dtype)

    def forward(self, points: torch.Tensor, bn_momentum: float = 0.99, generator: torch.Generator | None = None):
        _, layer_fts = self.backbone(*_split_features(self.setting, points), generator)
        # The classification branch reads the encoder's last features.
        point_logits = self.cls_head(layer_fts[len(self.setting.xconv_params)], generator)
        seg_logits = self.seg_head(layer_fts[-1], generator)
        return {"logits": point_logits.mean(dim=1), "point_logits": point_logits, "seg_logits": seg_logits,
                "end_points": {}}

    @staticmethod
    def loss(outputs: dict, batch: dict, seg_weight: float = 0.5) -> tuple[torch.Tensor, dict]:
        """(1 - w)·tiled-label CE + w·per-point CE: (loss, {"loss",
        "classify_loss", "seg_loss"})."""
        classify = _tiled_cross_entropy(outputs["point_logits"], batch["labels"])
        seg = losses.per_point_cross_entropy(outputs["seg_logits"], batch["masks"])
        total = (1.0 - seg_weight) * classify + seg_weight * seg
        return total, {"loss": total, "classify_loss": classify, "seg_loss": seg}
