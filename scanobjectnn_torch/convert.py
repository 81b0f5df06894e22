"""Weights between the JAX package and this one, and the reference init.

JAX ``variables`` are ``{"params": ..., "batch_stats": ...}`` nested dicts
of arrays with names such as ``sa1/mlp/dense_0/kernel`` or
``head/bn1/scale``.  This package names its parameters and buffers the same
way (``sa1.mlp.dense_0.kernel``, ``head.bn1.mean``) and keeps Dense kernels
in the JAX ``[in, out]`` layout, so the conversion is a renaming and no
tensor is transposed.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

__all__ = ["init_params", "jax_to_state_dict", "load_jax_variables"]


def _flatten(tree: Mapping, prefix: str = ""):
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            yield from _flatten(val, f"{name}.")
        else:
            yield name, val


def jax_to_state_dict(variables: Mapping) -> dict[str, torch.Tensor]:
    """Flatten JAX ``params`` and ``batch_stats`` (arrays or anything
    ``np.asarray`` takes) into a ``state_dict`` of f32 CPU tensors."""
    out = {}
    for collection in ("params", "batch_stats"):
        for name, val in _flatten(variables.get(collection, {})):
            out[name] = torch.from_numpy(np.array(val, dtype=np.float32))
    return out


def load_jax_variables(module: nn.Module, variables: Mapping) -> nn.Module:
    """Load JAX ``variables`` into ``module`` (every name must match)."""
    module.load_state_dict(jax_to_state_dict(variables), strict=True)
    return module


def init_params(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Reference init in module order, drawn from ``generator``:
    Glorot-uniform Dense kernels and zero biases; BatchNorm scale 1, bias
    0, running mean 0 and var 1."""
    for sub in module.modules():
        if hasattr(sub, "reset_parameters"):
            sub.reset_parameters(generator)
    return module
