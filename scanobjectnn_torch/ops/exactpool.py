"""Exact-key max-pool: bf16 pooling whose winners an f32 key decides
(counterpart of ``scanobjectnn_tpu/ops/exactpool.py``).

bf16 rounding makes near-equal rows of a max-pool tie, which splits the
pooled gradient among them; bf16 training of the max-pool families then
collapses (the JAX package's ``SYNTH_HARD.md``).  Here the value ``y``
stays in the compute dtype, and a gradient-free f32 ``key``, the same
activations before any bf16 rounding, picks the winners and the tie split:

    pooled = max of y over the slots of max key
    dy     = (key == max key) / count · d_pooled

  * ``exact_key_max_pool(y, key, dim)``: that op; no gradient to ``key``.
  * ``dense_bn_exactkey_pool(x, w, b, gamma, beta, dim, group=None)``: the
    final SA layer in bf16 training under exact keys as one op, Dense ->
    training BN -> relu -> exact-key pool, returning (pooled, mean, var).
    Forward: ``z32 = x·cd(w) + b`` (compute-dtype operands, f32 sums and
    bias), batch statistics of ``cd(z32)``, rounded explicitly (XLA does
    not fold JAX's ``astype(bf16).astype(f32)`` either), then
    ``ops/cuda/poolkey_kernel.bn_relu_exactkey_pool`` (#18 on the card,
    its plain version on the CPU) with ``r = rsqrt(var + 1e-3)``.  Pooled
    values are bit-equal to the module chain of ``nn/layers.mlp_final_max``.
    Backward (plain PyTorch, as in JAX, where it is XLA): the chain is
    recomputed from the saved inputs and per-channel statistics (no
    [.., K, C] tensor is saved), the winners come from this recompute's own
    keys, and dz is rounded to the compute dtype before the dx and dW
    products.  The statistics' cotangents are ignored: they only feed the
    running averages.  db is the true sum, 0 up to rounding.
    Under a process ``group`` (the BN's, ``nn.layers.configure_parallel``)
    the statistics are the global batch's: E[z] and E[z²] averaged over the
    group before the variance, as ``BatchNorm`` takes them; the backward's
    batch sums S1 = Σ du and S2 = Σ du·zhat are summed over the group for
    dz, over the global row count, while dgamma and dbeta stay this rank's
    sums (the ``Trainer`` averages every gradient over the ranks).  A group
    of one rank gives the no-group bits.
"""

from __future__ import annotations

import torch

import torch.distributed as dist

from scanobjectnn_torch.nn.layers import matmul_f32
from scanobjectnn_torch.parallel.mesh import sum_parts
from scanobjectnn_torch.ops.cuda.poolkey_kernel import bn_relu_exactkey_pool

__all__ = ["dense_bn_exactkey_pool", "exact_key_max_pool"]

EPS = 1e-3


def _winners(key: torch.Tensor, dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    eq = key == key.amax(dim, keepdim=True)
    return eq, eq.sum(dim, dtype=torch.float32)


class _ExactKeyMaxPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, key, dim):
        eq, cnt = _winners(key.detach(), dim)
        ctx.save_for_backward(eq, cnt)
        ctx.dim = dim
        return torch.where(eq, y, float("-inf")).amax(dim)

    @staticmethod
    def backward(ctx, d_pooled):
        eq, cnt = ctx.saved_tensors
        scale = (d_pooled.float() / cnt).unsqueeze(ctx.dim)
        return torch.where(eq, scale, 0.0).to(d_pooled.dtype), None, None


def exact_key_max_pool(y: torch.Tensor, key: torch.Tensor, dim: int) -> torch.Tensor:
    """Max-pool ``y`` over ``dim`` with the winners and ties decided by the
    f32 ``key`` of the same shape; the gradient splits evenly over the
    exact-key winners, in ``y``'s dtype."""
    return _ExactKeyMaxPool.apply(y, key, dim)


def _z32(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return matmul_f32(x, w.to(x.dtype)) + b


def _stats(zbf: torch.Tensor, group) -> tuple[torch.Tensor, torch.Tensor]:
    axes = tuple(range(zbf.dim() - 1))
    mean, mean2 = zbf.mean(dim=axes), torch.square(zbf).mean(dim=axes)
    if group is not None:
        mean, mean2 = (t / dist.get_world_size(group) for t in sum_parts((mean, mean2), group))
    return mean, torch.clamp(mean2 - torch.square(mean), min=0.0)


class _DenseBnExactkeyPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, gamma, beta, group):
        z32 = _z32(x, w, b)
        mean, var = _stats(z32.to(x.dtype).float(), group)
        pooled, _, _ = bn_relu_exactkey_pool(
            z32.contiguous(), gamma.detach().contiguous(), beta.detach().contiguous(), mean,
            torch.rsqrt(var + EPS), x.dtype,
        )
        ctx.save_for_backward(x, w, b, gamma, beta, mean, var)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return pooled, mean, var

    @staticmethod
    def backward(ctx, d_pooled, _d_mean, _d_var):
        x, w, b, gamma, beta, mean, var = ctx.saved_tensors
        cdtype = x.dtype
        z32 = _z32(x, w, b)
        r = torch.rsqrt(var + EPS)
        zhat = (z32.to(cdtype).float() - mean) * r
        u = zhat * gamma + beta
        eq, cnt = _winners(torch.relu(((z32 - mean) * r) * gamma + beta), -2)
        dy = torch.where(eq, (d_pooled.float() / cnt).unsqueeze(-2), 0.0)
        du = torch.where(u.to(cdtype) > 0, dy, 0.0)
        axes = tuple(range(x.dim() - 1))
        n_rows = float(x[..., 0].numel())
        s1 = du.sum(dim=axes)
        s2 = (du * zhat).sum(dim=axes)
        g1, g2 = s1, s2
        if ctx.group is not None:  # the global batch's sums and rows (module doc)
            g1, g2 = sum_parts((s1, s2), ctx.group)
            n_rows *= dist.get_world_size(ctx.group)
        dz = r * gamma * (du - g1 / n_rows - zhat * (g2 / n_rows))
        dzc = dz.to(cdtype)
        dx = matmul_f32(dzc, w.to(cdtype).t()).to(cdtype)
        dw = matmul_f32(x.reshape(-1, x.shape[-1]).t(), dzc.reshape(-1, dz.shape[-1]))
        return dx, dw, dz.sum(dim=axes), s2, s1, None


def dense_bn_exactkey_pool(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, dim: int,
    group=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused Dense -> training BN -> relu -> exact-key max-pool (module
    doc).  x [..., K, C_in] in the compute dtype, w [C_in, C] and b, gamma,
    beta [C] f32; pools over ``dim``, which must be the K axis (-2).
    ``group``: the process group whose global batch the statistics cover
    (None: this process's).  Returns (pooled [..., C] in x's dtype, batch
    mean, batch var)."""
    if dim not in (-2, x.dim() - 2):
        raise ValueError(f"dense_bn_exactkey_pool pools over the K axis (-2), got dim {dim} of {x.dim()}")
    return _DenseBnExactkeyPool.apply(x, w, b, gamma, beta, group)
