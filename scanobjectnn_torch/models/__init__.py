"""Model registry (counterpart of ``scanobjectnn_tpu/models/__init__.py``).

Ported: ``pointnet2_cls_ssg`` ("cls"), ``pointnet2_cls_msg`` ("cls"),
``pointnet2_cls_bga`` ("seg"), ``pointnet2_cls_partseg`` ("partseg"),
``dgcnn`` ("cls"), ``dgcnn_bga`` ("seg"), ``spidercnn_cls_xyz`` ("cls"),
``pointcnn_cls`` ("cls") and ``pointcnn_seg`` ("seg"), for inference and
f32 training, and the four ``pointnet2_*`` for bf16 training (their
``trains_in_bf16``); every other name
raises ``KeyError`` saying it is not ported yet.  The registry maps a name
to its class; the class carries the model's ``kind``, its static
``loss(outputs, batch)`` (the JAX ``get_model`` returns the module, the loss
and the kind) and, where the family ships one, its training ``recipe``
(``get_recipe``; PointCNN's).  ``get_model`` returns the module alone, on
``device``.
"""

from __future__ import annotations

import torch

from scanobjectnn_torch.convert import init_params
from scanobjectnn_torch.models.dgcnn import DGCNN, DGCNNBGA
from scanobjectnn_torch.models.pointcnn import PointCNNCls, PointCNNSeg
from scanobjectnn_torch.models.pointnet2 import PointNet2BGA, PointNet2ClsMSG, PointNet2ClsSSG, PointNet2PartSeg
from scanobjectnn_torch.models.recipes import TrainRecipe
from scanobjectnn_torch.models.spidercnn import SpiderCNNCls

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
    "SpiderCNNCls",
    "TrainRecipe",
    "get_model",
    "get_recipe",
]

MODEL_REGISTRY = {
    "pointnet2_cls_ssg": PointNet2ClsSSG,
    "pointnet2_cls_msg": PointNet2ClsMSG,
    "pointnet2_cls_bga": PointNet2BGA,
    "pointnet2_cls_partseg": PointNet2PartSeg,
    "dgcnn": DGCNN,
    "dgcnn_bga": DGCNNBGA,
    "spidercnn_cls_xyz": SpiderCNNCls,
    "pointcnn_cls": PointCNNCls,
    "pointcnn_seg": PointCNNSeg,
}


def _check_name(name: str) -> None:
    if name not in MODEL_REGISTRY:
        raise KeyError(
            f"model {name!r} is not ported to scanobjectnn_torch yet; "
            f"available: {sorted(MODEL_REGISTRY)}"
        )


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
