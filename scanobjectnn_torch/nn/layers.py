"""Core NN layers (counterpart of ``scanobjectnn_tpu/nn/layers.py``).

Semantics kept from the JAX package, which ``torch.nn`` does not give:

  * ``Dense`` stores its kernel ``[in, out]`` (the JAX layout) and rounds
    where JAX rounds: operands cast to the compute dtype, products summed in
    f32, the f32 bias added, then ONE cast.  A bf16 ``torch.matmul`` would
    round its product to bf16 before the bias (a second rounding), so the
    product runs on the bf16-rounded operands upcast to f32 (``matmul_f32``).
  * ``BatchNorm`` eval is ``(x - mean) * rsqrt(var + 1e-3) * scale + bias``
    in f32, cast to the compute dtype (eps 1e-3, not torch's 1e-5).
  * Init is Glorot-uniform kernels and zero biases (``reset_parameters``
    with an explicit ``torch.Generator``).

Only inference is ported: training-mode BatchNorm (batch statistics with
the call-time EMA momentum) raises until the training step is ported.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

__all__ = ["BatchNorm", "Dense", "MLP", "matmul_f32", "mlp_final_max"]


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with f32 products and sums — JAX's
    ``preferred_element_type=float32`` on operands already rounded to the
    compute dtype (a bf16 x bf16 product is exact in f32)."""
    return torch.matmul(x.float(), w.float())


class Dense(nn.Module):
    """Linear layer over the last axis; kernel ``[in, out]``."""

    def __init__(self, in_features: int, features: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        fan_in, fan_out = self.kernel.shape
        limit = math.sqrt(6.0 / (fan_in + fan_out))  # flax glorot_uniform
        with torch.no_grad():
            self.kernel.uniform_(-limit, limit, generator=generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype or x.dtype
        y = matmul_f32(x.to(dtype), self.kernel.to(dtype)) + self.bias
        return y.to(dtype)


class BatchNorm(nn.Module):
    """Eval-mode batch normalization over the last axis, eps 1e-3.

    ``scale``/``bias`` are parameters and ``mean``/``var`` buffers, named as
    the JAX ``params``/``batch_stats`` leaves."""

    epsilon = 1e-3

    def __init__(self, features: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "training-mode BatchNorm is not ported yet; call .eval()"
            )
        y = (x.float() - self.mean) * torch.rsqrt(self.var + self.epsilon)
        y = y * self.scale + self.bias
        return y.to(self.dtype or x.dtype)


class MLP(nn.Module):
    """Dense→BN→ReLU stack over the last axis (a reference "shared MLP"),
    with children ``dense_i``/``bn_i`` as in the JAX param tree."""

    def __init__(self, in_features: int, features: Sequence[int], dtype: torch.dtype | None = None):
        super().__init__()
        self.features = tuple(features)
        for i, f in enumerate(self.features):
            self.add_module(f"dense_{i}", Dense(in_features, f, dtype))
            self.add_module(f"bn_{i}", BatchNorm(f, dtype))
            in_features = f

    def layer(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Dense_i → BN_i → relu."""
        x = getattr(self, f"dense_{i}")(x)
        return torch.relu(getattr(self, f"bn_{i}")(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(len(self.features)):
            x = self.layer(i, x)
        return x


def mlp_final_max(mdl: MLP, x: torch.Tensor, index: int, dim: int) -> torch.Tensor:
    """Final Dense→BN→relu→max-pool step of a shared-MLP stack: the eval
    branch (pool_f32 mode "0") of the JAX ``mlp_final_max``.  Returns the
    pooled tensor in the compute dtype."""
    return torch.amax(mdl.layer(index, x), dim=dim)
