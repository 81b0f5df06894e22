"""Model registry (counterpart of ``scanobjectnn_tpu/models/__init__.py``).

Every name of the JAX registry is ported: ``pointnet_cls``,
``pointnet_cls_basic``, ``pointnet2_cls_ssg``, ``pointnet2_cls_msg``,
``dgcnn``, ``spidercnn_cls_xyz``, ``3dmfv_net_cls`` and ``pointcnn_cls``
("cls"), ``pointnet_seg``, ``pointnet2_cls_bga``, ``dgcnn_bga`` and
``pointcnn_seg`` ("seg"), ``pointnet_partseg`` and ``pointnet2_cls_partseg``
("partseg"), for inference and training in f32 and in bf16.  Any other
name raises ``KeyError``.  The registry maps a name to its class; the class
carries the model's ``kind``, its static ``loss(outputs, batch)`` (the JAX
``get_model`` returns the module, the loss and the kind) and, where the
family ships one, its training ``recipe`` (``get_recipe``; PointCNN's).
JAX's (class, defaults) entries become classes: ``pointnet_cls_basic`` is
``PointNetClsBasic``, ``PointNetCls`` without T-Nets.  ``get_model``
returns the module alone, on ``device``.
"""

from __future__ import annotations

import torch

from scanobjectnn_torch.convert import init_params
from scanobjectnn_torch.models.dgcnn import DGCNN, DGCNNBGA
from scanobjectnn_torch.models.pointcnn import PointCNNCls, PointCNNSeg
from scanobjectnn_torch.models.pointnet import PointNetCls, PointNetClsBasic, PointNetPartSeg, PointNetSeg
from scanobjectnn_torch.models.pointnet2 import PointNet2BGA, PointNet2ClsMSG, PointNet2ClsSSG, PointNet2PartSeg
from scanobjectnn_torch.models.recipes import TrainRecipe
from scanobjectnn_torch.models.spidercnn import SpiderCNNCls
from scanobjectnn_torch.models.threedmfv import ThreeDmFVNet

__all__ = [
    "DGCNN",
    "DGCNNBGA",
    "MODEL_REGISTRY",
    "PointCNNCls",
    "PointCNNSeg",
    "PointNet2BGA",
    "PointNet2ClsMSG",
    "PointNet2ClsSSG",
    "PointNet2PartSeg",
    "PointNetCls",
    "PointNetClsBasic",
    "PointNetPartSeg",
    "PointNetSeg",
    "SpiderCNNCls",
    "ThreeDmFVNet",
    "TrainRecipe",
    "get_model",
    "get_recipe",
]

MODEL_REGISTRY = {
    "pointnet_cls": PointNetCls,
    "pointnet_cls_basic": PointNetClsBasic,
    "pointnet_seg": PointNetSeg,
    "pointnet_partseg": PointNetPartSeg,
    "pointnet2_cls_ssg": PointNet2ClsSSG,
    "pointnet2_cls_msg": PointNet2ClsMSG,
    "pointnet2_cls_bga": PointNet2BGA,
    "pointnet2_cls_partseg": PointNet2PartSeg,
    "dgcnn": DGCNN,
    "dgcnn_bga": DGCNNBGA,
    "spidercnn_cls_xyz": SpiderCNNCls,
    "3dmfv_net_cls": ThreeDmFVNet,
    "pointcnn_cls": PointCNNCls,
    "pointcnn_seg": PointCNNSeg,
}


def _check_name(name: str) -> None:
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: {sorted(MODEL_REGISTRY)}")


def get_model(
    name: str, generator: torch.Generator | None = None, device: str | torch.device = "cuda", **overrides
) -> torch.nn.Module:
    """Instantiate a registered model with the reference init drawn from
    ``generator`` (a generator seeded 0 when None) and move it to
    ``device`` (the card unless the caller asks for the CPU)."""
    _check_name(name)
    module = MODEL_REGISTRY[name](**overrides)
    init_params(module, generator if generator is not None else torch.Generator().manual_seed(0))
    return module.to(device)


def get_recipe(name: str) -> TrainRecipe | None:
    """The training recipe a registered model ships with (None: the
    ``Trainer``'s defaults)."""
    _check_name(name)
    return getattr(MODEL_REGISTRY[name], "recipe", None)
