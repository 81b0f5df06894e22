"""Eval-mode BatchNorm fold for the fused SA kernels (counterpart of
``scanobjectnn_tpu/ops/pallas/samlp_kernel.py:fold_bn_mlp_params``).

Only the fold is ported here; the ``sa_mlp_pool`` kernel (eval SA from a
precomputed grouping) is still to port.

Eval BatchNorm is a per-channel affine, folded into the Dense weights:
  relu(BN(x @ W + b)) == relu(x @ (W*s) + (b*s + t)),
  s = gamma * rsqrt(var + eps), t = beta - mean*s.
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["fold_bn_mlp_params"]


def fold_bn_mlp_params(
    dense: Sequence[tuple[torch.Tensor, torch.Tensor]],
    bn: Sequence[tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]] | None,
    eps: float = 1e-3,
) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Fold eval BN into per-layer Dense params, all in f32.

    dense: ``(kernel [in, out], bias [out])`` per layer; bn: ``(scale, bias,
    mean, var)`` per layer, or None for an MLP without BN.  Returns
    ``(weights, biases)`` lists."""
    weights, biases = [], []
    for i, (w, b) in enumerate(dense):
        w, b = w.float(), b.float()
        if bn is not None:
            gamma, beta, mean, var = (t.float() for t in bn[i])
            s = gamma * torch.rsqrt(var + eps)
            w = w * s[None, :]
            b = b * s + (beta - mean * s)
        weights.append(w)
        biases.append(b)
    return weights, biases
