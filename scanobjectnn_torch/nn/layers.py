"""Core NN layers (counterpart of ``scanobjectnn_tpu/nn/layers.py``).

Semantics kept from the JAX package, which ``torch.nn`` does not give:

  * ``Dense`` stores its kernel ``[in, out]`` (the JAX layout) and rounds
    where JAX rounds: operands cast to the compute dtype, products summed in
    f32, the f32 bias added, then ONE cast.  A bf16 ``torch.matmul`` would
    round its product to bf16 before the bias (a second rounding), so the
    product runs on the bf16-rounded operands upcast to f32 (``matmul_f32``).
    ``forward(x, keep_f32_output=True)`` skips the final cast (the operands
    still take the compute dtype).  ``Dense(highest_cols=(a, b))``
    multiplies input channels [a, b) in f32 against their kernel rows (no
    TF32), the other rows in the compute dtype, and returns f32: the caller
    subtracts products of uncentred coordinates (``LiftedGroupMLP``) and
    rounds after the cancellation.
  * ``BatchNorm`` normalizes as ``(x - mean) * rsqrt(var + 1e-3) * scale +
    bias`` in f32, cast to the compute dtype (eps 1e-3, not torch's 1e-5;
    ``forward(..., dtype=torch.float32)`` keeps f32).
    Eval reads the running stats.  Training takes the batch statistics in
    f32 over every axis but the last, with the BIASED variance
    ``max(E[x²] - E[x]², 0)``, and updates the running stats with the
    call-time momentum ``m`` as ``ra = m·ra + (1-m)·batch`` (``bn_decay``;
    ``F.batch_norm`` keeps an unbiased running var and the opposite
    momentum convention, so it is not used).  ``f32_key_input`` (exact-key
    pooling) also returns an f32 normalization of that unrounded copy of
    ``x`` under the same statistics, with no gradient.
  * Cross-replica BatchNorm, JAX's ``BatchNorm(axis_name=...)``: where
    ``configure_parallel`` gave a module a process group, training takes
    ``E[x]`` and ``E[x²]`` of this rank's rows and averages them over the
    group (``parallel.all_reduce_mean``, one collective a call, with its
    gradient) before ``var = max(E[x²] - E[x]², 0)``, so the statistics,
    and the running ones updated from them, are the global batch's on
    every rank.  Eval reads the running stats and calls no collective.
    The fused ops that take a BN's training statistics take its group too
    and reduce the same way inside (``dense_bn_exactkey_pool`` here, the
    SA training tail in ``nn/pointnet_modules.py``), so a group leaves the
    kernels on the path.  The name ``configure_parallel`` follows
    ``configure_training``: the group is set on the built model, not passed
    through every constructor as JAX's ``bn_axis_name`` is.
  * ``GroupNorm`` is flax's ``nn.GroupNorm`` on channels-last [B, N, C]
    input (``torch.nn.GroupNorm`` wants channels first and takes the
    two-pass variance): each of G groups of C/G channels takes its
    statistics over (N, C/G) in f32, even for a bf16 input, with flax's
    fast variance ``max(E[x²] - E[x]², 0)``, then ``y = (x - mean) *
    (rsqrt(var + eps) * scale) + bias`` in f32 and one cast
    (``flax.linen.normalization._compute_stats`` and ``_normalize``).
  * The max-pool is ``torch.amax``, which splits the gradient evenly across
    ties as ``jnp.max`` does.  In training, ``mlp_final_max`` honours the
    pool modes of the module it pools for (module doc of the function).
    ``MaxPoolMLP`` is the JAX ``MLP(final_max_axis=dim)``: a stack whose
    last layer pools through ``mlp_final_max`` (PointNet's three global
    pools).
  * Init is Glorot-uniform kernels and zero biases (``reset_parameters``
    with an explicit ``torch.Generator``); ``Dense(zero_init=True)`` starts
    its kernel at zero too (the JAX ``kernel_init=zeros``, DGCNN's T-Net
    ``transform``).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

from scanobjectnn_torch.parallel.mesh import all_reduce_mean

__all__ = [
    "BatchNorm", "Dense", "GroupNorm", "MLP", "MaxPoolMLP", "configure_parallel", "matmul_f32", "mlp_final_max",
]


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with f32 products and sums — JAX's
    ``preferred_element_type=float32`` on operands already rounded to the
    compute dtype (a bf16 x bf16 product is exact in f32)."""
    return torch.matmul(x.float(), w.float())


class Dense(nn.Module):
    """Linear layer over the last axis; kernel ``[in, out]``."""

    def __init__(
        self,
        in_features: int,
        features: int,
        dtype: torch.dtype | None = None,
        zero_init: bool = False,
        highest_cols: tuple[int, int] | None = None,
    ):
        super().__init__()
        self.dtype = dtype
        self.zero_init = zero_init
        self.highest_cols = highest_cols
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        fan_in, fan_out = self.kernel.shape
        limit = math.sqrt(6.0 / (fan_in + fan_out))  # flax glorot_uniform
        with torch.no_grad():
            if self.zero_init:
                self.kernel.zero_()
            else:
                self.kernel.uniform_(-limit, limit, generator=generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor, keep_f32_output: bool = False) -> torch.Tensor:
        dtype = self.dtype or x.dtype
        if self.highest_cols is None:
            y = matmul_f32(x.to(dtype), self.kernel.to(dtype))
        else:
            a, c = self.highest_cols
            y = matmul_f32(x[..., a:c], self.kernel[a:c])
            if a > 0:
                y = y + matmul_f32(x[..., :a].to(dtype), self.kernel[:a].to(dtype))
            if c < x.shape[-1]:
                y = y + matmul_f32(x[..., c:].to(dtype), self.kernel[c:].to(dtype))
        y = y + self.bias
        return y if keep_f32_output or self.highest_cols is not None else y.to(dtype)


class BatchNorm(nn.Module):
    """Batch normalization over the last axis, eps 1e-3, with a call-time
    momentum in training (module doc).

    ``scale``/``bias`` are parameters and ``mean``/``var`` buffers, named as
    the JAX ``params``/``batch_stats`` leaves.  ``group``: the process group
    whose global batch the training statistics cover (module doc; None: this
    process's batch)."""

    epsilon = 1e-3
    group = None

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

    def update_running(self, mean: torch.Tensor, var: torch.Tensor, bn_momentum: float | None) -> None:
        """``ra = m·ra + (1-m)·batch`` for the running mean and var."""
        if bn_momentum is None:
            raise ValueError("training-mode BatchNorm needs the call-time bn_momentum")
        # m and 1 - m in f32, as JAX takes them, but as Python scalars: a
        # tensor made from m would be a host-to-device copy, which waits for
        # the card on every call.
        m = np.float32(bn_momentum)
        m, rest = float(m), float(np.float32(1.0) - m)
        with torch.no_grad():
            self.mean.copy_(self.mean * m + mean * rest)
            self.var.copy_(self.var * m + var * rest)

    def global_moments(self, mean: torch.Tensor, mean2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(E[x], E[x²]) of the group's global batch from this rank's: their
        mean over ``group`` in one collective; as given without a group."""
        if self.group is None:
            return mean, mean2
        both = all_reduce_mean(torch.cat([mean, mean2]), self.group)
        return both[: mean.shape[0]], both[mean.shape[0]:]

    def forward(
        self,
        x: torch.Tensor,
        bn_momentum: float | None = None,
        f32_key_input: torch.Tensor | None = None,
        dtype: torch.dtype | None = None,
    ):
        """In training, ``bn_momentum`` (the scheduled ``bn_decay``) is
        required; eval ignores it.  Returns the normalized ``x`` in
        ``dtype``, else the module's compute dtype, else x's; with
        ``f32_key_input``, (that, the key)."""
        xf = x.float()
        if self.training:
            axes = tuple(range(x.dim() - 1))
            mean, mean2 = self.global_moments(xf.mean(dim=axes), torch.square(xf).mean(dim=axes))
            var = torch.clamp(mean2 - torch.square(mean), min=0.0)
            self.update_running(mean, var, bn_momentum)
        else:
            mean, var = self.mean, self.var
        r = torch.rsqrt(var + self.epsilon)
        y = (xf - mean) * r
        y = (y * self.scale + self.bias).to(dtype or self.dtype or x.dtype)
        if f32_key_input is None:
            return y
        with torch.no_grad():
            key = (f32_key_input.float() - mean) * r
            key = key * self.scale + self.bias
        return y, key


def configure_parallel(model: nn.Module, group) -> nn.Module:
    """Give every ``BatchNorm`` of ``model`` (``_PairBN`` too) the process
    ``group`` whose global batch its training statistics cover (module
    doc); None takes them over this process's batch again.  Parameter and
    buffer names do not change."""
    for sub in model.modules():
        if isinstance(sub, BatchNorm):
            sub.group = group
    return model


class GroupNorm(nn.Module):
    """Group normalization over the last axis of [B, ..., C], flax's
    semantics (module doc): no running statistics; ``scale``/``bias``
    parameters initialised to 1 and 0.  The output dtype is ``dtype``, or
    the input's promoted to at least f32, as flax's with ``dtype=None``."""

    def __init__(self, features: int, num_groups: int = 16, epsilon: float = 1e-5, dtype: torch.dtype | None = None):
        super().__init__()
        if features % num_groups:
            raise ValueError(f"GroupNorm: {features} channels do not split into {num_groups} groups")
        self.num_groups, self.epsilon, self.dtype = num_groups, epsilon, dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[0], x.shape[-1]
        xf = x.float()
        grouped = xf.reshape(b, -1, self.num_groups, c // self.num_groups)
        mean = grouped.mean(dim=(1, 3))  # [B, G]
        var = torch.clamp(torch.square(grouped).mean(dim=(1, 3)) - torch.square(mean), min=0.0)
        shape = (b,) + (1,) * (x.dim() - 2) + (c,)
        mean = mean.repeat_interleave(c // self.num_groups, dim=-1).reshape(shape)
        var = var.repeat_interleave(c // self.num_groups, dim=-1).reshape(shape)
        y = (xf - mean) * (torch.rsqrt(var + self.epsilon) * self.scale) + self.bias
        return y.to(self.dtype or torch.promote_types(x.dtype, torch.float32))


class MLP(nn.Module):
    """Dense→BN→ReLU stack over the last axis (a reference "shared MLP"),
    with children ``dense_i``/``bn_i`` as in the JAX param tree.
    ``bn_momentum`` is the BN call-time momentum, required in training."""

    def __init__(self, in_features: int, features: Sequence[int], dtype: torch.dtype | None = None):
        super().__init__()
        self.features, self.dtype = tuple(features), dtype
        for i, f in enumerate(self.features):
            self.add_module(f"dense_{i}", Dense(in_features, f, dtype))
            self.add_module(f"bn_{i}", BatchNorm(f, dtype))
            in_features = f

    def layer(self, i: int, x: torch.Tensor, bn_momentum: float | None = None) -> torch.Tensor:
        """Dense_i → BN_i → relu."""
        x = getattr(self, f"dense_{i}")(x)
        return torch.relu(getattr(self, f"bn_{i}")(x, bn_momentum))

    def forward(self, x: torch.Tensor, bn_momentum: float | None = None) -> torch.Tensor:
        for i in range(len(self.features)):
            x = self.layer(i, x, bn_momentum)
        return x


class MaxPoolMLP(MLP):
    """``MLP`` that ends in a max-pool over ``dim`` (the JAX
    ``MLP(final_max_axis=dim)``): layers 0..n-2, then the last layer and
    the pool through ``mlp_final_max`` in the module's ``pool_mode`` ("0"
    unless ``nn.pointnet_modules.configure_training`` gives another)."""

    pool_mode = "0"

    def __init__(self, in_features: int, features: Sequence[int], dim: int, dtype: torch.dtype | None = None):
        super().__init__(in_features, features, dtype)
        self.dim = dim

    def forward(self, x: torch.Tensor, bn_momentum: float | None = None) -> torch.Tensor:
        n = len(self.features)
        for i in range(n - 1):
            x = self.layer(i, x, bn_momentum)
        return mlp_final_max(self, x, n - 1, self.dim, bn_momentum)


def mlp_final_max(
    mdl: MLP,
    x: torch.Tensor,
    index: int,
    dim: int,
    bn_momentum: float | None = None,
    skip_dense: bool = False,
    x32: torch.Tensor | None = None,
) -> torch.Tensor:
    """Final Dense→BN→relu→max-pool step of a shared-MLP stack, with the
    pool modes of the JAX ``mlp_final_max``.  The mode is ``mdl.pool_mode``
    in training (``"0"`` where the module has none) and "0" at eval:

      "0"    the plain chain in the compute dtype (``torch.amax`` splits the
             gradient evenly across ties);
      "1"    the layer's Dense output and BN stay f32 across the pool, then
             one cast;
      "keys" the value chain stays in the compute dtype and an f32 key copy
             (the Dense's f32 sums, or ``x32``) decides winners and ties
             (``ops.exactpool.exact_key_max_pool``); with a Dense and a bf16
             compute dtype the step is one op,
             ``ops.exactpool.dense_bn_exactkey_pool`` (#18 on the card),
             whose batch statistics (over the BN's group) update the BN's
             running ones.

    ``mdl`` owns ``dense_{index}`` and ``bn_{index}``.  ``skip_dense``: the
    layer has no Dense of its own (``LiftedGroupMLP``'s layer 0, whose
    unrounded f32 pre-BN input ``x32`` then keys the pool).  Returns the
    pooled tensor in the compute dtype."""
    # ops.exactpool imports this module.
    from scanobjectnn_torch.ops.exactpool import dense_bn_exactkey_pool, exact_key_max_pool

    mode = getattr(mdl, "pool_mode", "0") if mdl.training else "0"
    cdtype = mdl.dtype or x.dtype
    dense = None if skip_dense else getattr(mdl, f"dense_{index}")
    bn = getattr(mdl, f"bn_{index}")
    if mode == "keys":
        if dense is not None and cdtype == torch.bfloat16:
            pooled, mean, var = dense_bn_exactkey_pool(
                x.to(cdtype), dense.kernel, dense.bias, bn.scale, bn.bias, dim, bn.group
            )
            bn.update_running(mean, var, bn_momentum)
            return pooled
        if dense is None:
            h32, z = (x if x32 is None else x32).float(), x
        else:
            h32 = dense(x, keep_f32_output=True)
            z = h32.to(cdtype)
        z, key = bn(z, bn_momentum, f32_key_input=h32)
        return exact_key_max_pool(torch.relu(z), torch.relu(key), dim).to(cdtype)
    if mode == "1":
        if dense is not None:
            x = dense(x, keep_f32_output=True)
        x = bn(x, bn_momentum, dtype=torch.float32)
    else:
        x = bn(x if dense is None else dense(x), bn_momentum)
    return torch.amax(torch.relu(x), dim=dim).to(cdtype)
