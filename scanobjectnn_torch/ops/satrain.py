"""The fused SA training tail as one autograd op (counterpart of
``scanobjectnn_tpu/ops/pallas/satrain_kernel.py``).

``grouped_bn_mlp_pool(z1, gammas, betas, ws, bs, pool_mode)`` takes z1
[B, M, K, C0], the first layer's pre-BN activations (Dense 0's output, in
the compute dtype), and runs BN0 -> relu -> (Dense_i -> BN_i -> relu)* ->
max over K with training batch statistics.  It returns (pooled [B, M, C]
in z1's dtype, means, vars): the statistics feed the caller's
``BatchNorm.update_running``, and their cotangents are ignored.  With a
process ``group`` the statistics, and the batch sums of the BN backward,
are the global batch's (``ops/cuda/satrain_kernel``'s module doc).

The forward is the plain chain (``ops/cuda/satrain_kernel.fwd_chain``);
only z1, the parameters and the per-channel statistics are saved, nothing
[B, M, K, C]-sized from the hidden layers.  The backward recomputes the
chain from z1: #17 (``grouped_bn_mlp_pool_bwd``, ``csrc/satrain_bwd.cu``)
on the card, its plain version (JAX's ``_bwd_xla``) on the CPU.  Pool
modes "0" (native) and "1" (the last layer in f32); exact keys never take
this tail.  JAX's Pallas eligibility rule (K, M and C0 multiples of 8) is
the TPU's: the CUDA kernel takes every shape.
"""

from __future__ import annotations

from typing import Sequence

import torch

from scanobjectnn_torch.ops.cuda.satrain_kernel import fwd_chain, grouped_bn_mlp_pool_bwd

__all__ = ["grouped_bn_mlp_pool"]


class _GroupedBnMlpPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z1, pool_mode, group, n_layers, *params):
        gammas, betas = params[:n_layers], params[n_layers:2 * n_layers]
        ws, bs = params[2 * n_layers:3 * n_layers - 1], params[3 * n_layers - 1:]
        _, _, pooled, means, variances = fwd_chain(z1, gammas, betas, ws, bs, pool_mode, group=group)
        ctx.pool_mode, ctx.group, ctx.n_layers = pool_mode, group, n_layers
        ctx.save_for_backward(z1, *params, *means, *variances)
        ctx.mark_non_differentiable(*means, *variances)
        return (pooled.to(z1.dtype), *means, *variances)

    @staticmethod
    def backward(ctx, d_pooled, *_stat_cotangents):
        n = ctx.n_layers
        z1, *saved = ctx.saved_tensors
        gammas, betas, ws, bs = saved[:n], saved[n:2 * n], saved[2 * n:3 * n - 1], saved[3 * n - 1:4 * n - 2]
        means, variances = saved[4 * n - 2:5 * n - 2], saved[5 * n - 2:]
        dz1, dgammas, dbetas, dws, dbs = grouped_bn_mlp_pool_bwd(
            z1.contiguous(), gammas, betas, ws, bs, means, variances, d_pooled, ctx.pool_mode, ctx.group
        )
        return (dz1, None, None, None, *dgammas, *dbetas, *dws, *dbs)


def grouped_bn_mlp_pool(
    z1: torch.Tensor,
    gammas: Sequence[torch.Tensor],
    betas: Sequence[torch.Tensor],
    ws: Sequence[torch.Tensor],
    bs: Sequence[torch.Tensor],
    pool_mode: str = "0",
    group=None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, ...], tuple[torch.Tensor, ...]]:
    """Fused BN -> relu -> (Dense -> BN -> relu)* -> max over K (module
    doc): gammas/betas per layer [C_i] f32, ws/bs of layers 1..L-1 (kernels
    [C_{i-1}, C_i] f32); statistics over ``group`` (None: this process's
    batch).  Returns (pooled, means, vars)."""
    n = len(gammas)
    if pool_mode not in ("0", "1"):
        raise ValueError(f"grouped_bn_mlp_pool: pool modes '0' and '1' only, got {pool_mode!r}")
    if z1.dim() != 4 or len(betas) != n or len(ws) != n - 1 or len(bs) != n - 1:
        raise ValueError(
            f"grouped_bn_mlp_pool: need z1 [B, M, K, C0] and {n} BN layers with {n - 1} Dense, "
            f"got {tuple(z1.shape)}, {len(betas)} betas, {len(ws)} kernels, {len(bs)} biases"
        )
    out = _GroupedBnMlpPool.apply(z1, pool_mode, group, n, *gammas, *betas, *ws, *bs)
    return out[0], tuple(out[1:1 + n]), tuple(out[1 + n:])
