"""Model registry (counterpart of ``scanobjectnn_tpu/models/__init__.py``).

Only ``pointnet2_cls_ssg`` is ported, for inference and f32 training;
every other name raises ``KeyError`` saying it is not ported yet.
``get_model`` returns the module alone; its loss is the static
``loss(outputs, batch)`` on the module's class (the JAX one returns the
module, the loss and the model's kind).
"""

from __future__ import annotations

import torch

from scanobjectnn_torch.convert import init_params
from scanobjectnn_torch.models.pointnet2 import PointNet2ClsSSG

__all__ = ["MODEL_REGISTRY", "PointNet2ClsSSG", "get_model"]

MODEL_REGISTRY = {"pointnet2_cls_ssg": PointNet2ClsSSG}


def get_model(name: str, generator: torch.Generator | None = None, **overrides) -> torch.nn.Module:
    """Instantiate a registered model with the reference init drawn from
    ``generator`` (a generator seeded 0 when None)."""
    if name not in MODEL_REGISTRY:
        raise KeyError(
            f"model {name!r} is not ported to scanobjectnn_torch yet; "
            f"available: {sorted(MODEL_REGISTRY)}"
        )
    module = MODEL_REGISTRY[name](**overrides)
    init_params(module, generator if generator is not None else torch.Generator().manual_seed(0))
    return module
