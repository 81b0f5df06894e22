"""Backward of the fused SA training tail: the CUDA kernel
(``csrc/satrain_bwd.cu``) beside its plain PyTorch version, and the forward
chain both recompute.

Replaces ``scanobjectnn_tpu/ops/pallas/satrain_bwd.py``: ``bwd_pallas``
(``pl.pallas_call`` per pass), the VJP of ``satrain_kernel.
grouped_bn_mlp_pool``; the plain version ports its oracle ``_bwd_xla``.

The tail is BN0 -> relu -> (Dense_i -> BN_i -> relu)* -> max over the
neighbour axis (-2) of z1 [B, M, K, C0], the layer-0 pre-activations, in
the compute dtype.  ``fwd_chain`` is JAX's ``_fwd_chain``: matmul operands
and each layer's h and y rounded to the compute dtype, f32 sums, BN in f32
with eps 1e-3, biased batch variance ``max(E[h²] - E[h]², 0)`` (or the
given statistics); pool mode "1" keeps the last layer's h and y in f32.

The backward, with R = B·M·K rows, u_i = zhat_i·gamma_i + beta_i and
du_i = dy_i·(u_i > 0):

    dy_{L-1} = (y == pooled) / cnt · d_pooled     (ties split evenly)
    S1_i = Σ du_i = dbeta_i,  S2_i = Σ du_i·zhat_i = dgamma_i
    dz_i = r_i·gamma_i·((du_i - S1_i/R) - zhat_i·S2_i/R)
    dW_i = y_{i-1}ᵀ dz_i,  db_i = Σ dz_i,  dy_{i-1} = dz_i W_iᵀ   (f32)

and dz1 = dz_0 rounded to the compute dtype.  db_i is the true sum: 0 up to
rounding, since it feeds a training BN.

``grouped_bn_mlp_pool_bwd`` on a CUDA tensor launches the kernel: L + 2
passes over the rows, each recomputing the chain from z1 (a pool pass for
the kernel's own winners, one pass per layer's sums, a final pass for dz1),
with deterministic block sums (no float atomics).  It is not bit-equal to
the plain version: its products sum in another order than cuBLAS's, so a
relu gate or a pool winner within f32 rounding of a tie may flip; two calls
give the same bits.  The scratch of a pass's block sums is at most
``PARTIAL_BYTES`` (64 MiB), which bounds its blocks (``csrc/satrain_bwd.cu``).

What bounds it on the H100: operations (each pass recomputes the forward
chain on the CUDA cores in f32).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from scanobjectnn_torch.ops.cuda import _build

__all__ = [
    "EPS",
    "PARTIAL_BYTES",
    "fwd_chain",
    "grouped_bn_mlp_pool_bwd",
    "grouped_bn_mlp_pool_bwd_plain",
]

EPS = 1e-3
PARTIAL_BYTES = 64 * 1024 * 1024
MAX_LAYERS, MAX_WIDTH = 4, 1024  # kMaxLayers, kMaxWidth in csrc/satrain_bwd.cu
_MAX_BLOCKS = 8 * 132  # kMaxBlocks


def _acc(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the type the chain sums in: f32 (float64 stays float64)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` on the operands' values in the summing type (a bf16 product
    is exact in f32)."""
    return torch.matmul(_acc(a), _acc(b))


def _stats(h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    axes = tuple(range(h.dim() - 1))
    hf = _acc(h)
    mean = hf.mean(dim=axes)
    return mean, torch.clamp(torch.square(hf).mean(dim=axes) - torch.square(mean), min=0.0)


def fwd_chain(
    z1: torch.Tensor,
    gammas: Sequence[torch.Tensor],
    betas: Sequence[torch.Tensor],
    ws: Sequence[torch.Tensor],
    bs: Sequence[torch.Tensor],
    pool_mode: str = "0",
    means: Sequence[torch.Tensor] | None = None,
    variances: Sequence[torch.Tensor] | None = None,
):
    """The tail's forward (module doc): (zhats, ys, pooled, means, vars),
    per layer, with the batch statistics or the given ones."""
    cdtype = z1.dtype
    n_layers = len(gammas)
    f32_last = pool_mode == "1"
    zhats, ys, out_means, out_vars = [], [], [], []
    h = z1
    for i in range(n_layers):
        keep_f32 = i == n_layers - 1 and f32_last
        if i > 0:
            h = _mm(ys[-1], ws[i - 1].to(cdtype)) + bs[i - 1]
            if not keep_f32:
                h = h.to(cdtype)
        mean, var = _stats(h) if means is None else (means[i], variances[i])
        out_means.append(mean)
        out_vars.append(var)
        zhat = (_acc(h) - mean) * torch.rsqrt(var + EPS)
        y = torch.relu(zhat * gammas[i] + betas[i])
        zhats.append(zhat)
        ys.append(y if keep_f32 else y.to(cdtype))
    return zhats, ys, ys[-1].amax(-2), out_means, out_vars


def grouped_bn_mlp_pool_bwd_plain(
    z1: torch.Tensor,
    gammas: Sequence[torch.Tensor],
    betas: Sequence[torch.Tensor],
    ws: Sequence[torch.Tensor],
    bs: Sequence[torch.Tensor],
    means: Sequence[torch.Tensor],
    variances: Sequence[torch.Tensor],
    d_pooled: torch.Tensor,
    pool_mode: str = "0",
):
    """Plain PyTorch backward (module doc; JAX ``_bwd_xla``): (dz1,
    dgammas, dbetas, dws, dbs), the tuples in layer order."""
    n_layers = len(gammas)
    zhats, ys, pooled, _, _ = fwd_chain(z1, gammas, betas, ws, bs, pool_mode, means, variances)
    r_count = float(z1.shape[0] * z1.shape[1] * z1.shape[2])
    axes = tuple(range(z1.dim() - 1))
    eq = _acc(ys[-1] == pooled.unsqueeze(-2))
    cnt = eq.sum(-2, keepdim=True)
    dy = eq / cnt * _acc(d_pooled).unsqueeze(-2)
    dgammas, dbetas, dws, dbs = [], [], [], []
    dz = None
    for i in range(n_layers - 1, -1, -1):
        du = dy * (zhats[i] * gammas[i] + betas[i] > 0.0)
        s1 = du.sum(dim=axes)
        s2 = (du * zhats[i]).sum(dim=axes)
        dgammas.append(s2)
        dbetas.append(s1)
        r = torch.rsqrt(variances[i] + EPS)
        dz = r * gammas[i] * (du - s1 / r_count - zhats[i] * (s2 / r_count))
        if i > 0:
            c_in, c_out = ys[i - 1].shape[-1], dz.shape[-1]
            dws.append(_mm(ys[i - 1].reshape(-1, c_in).t(), dz.reshape(-1, c_out)))
            dbs.append(dz.sum(dim=axes))
            dy = _mm(dz, ws[i - 1].t())
    return (
        dz.to(z1.dtype),
        tuple(reversed(dgammas)),
        tuple(reversed(dbetas)),
        tuple(reversed(dws)),
        tuple(reversed(dbs)),
    )


def _f32(name: str, t: torch.Tensor, shape: tuple, device) -> torch.Tensor:
    if t.device != device or tuple(t.shape) != shape:
        raise ValueError(
            f"grouped_bn_mlp_pool_bwd: {name} must be {shape} on {device}, got {tuple(t.shape)} on {t.device}"
        )
    return t.detach().float().contiguous()


def grouped_bn_mlp_pool_bwd(
    z1: torch.Tensor,
    gammas: Sequence[torch.Tensor],
    betas: Sequence[torch.Tensor],
    ws: Sequence[torch.Tensor],
    bs: Sequence[torch.Tensor],
    means: Sequence[torch.Tensor],
    variances: Sequence[torch.Tensor],
    d_pooled: torch.Tensor,
    pool_mode: str = "0",
):
    """The tail's backward (module doc): (dz1, dgammas, dbetas, dws, dbs).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (counted in ``grouped_bn_mlp_pool_bwd.launches``) or raises."""
    if z1.device.type == "cpu":
        return grouped_bn_mlp_pool_bwd_plain(z1, gammas, betas, ws, bs, means, variances, d_pooled, pool_mode)
    fn = "grouped_bn_mlp_pool_bwd"
    if z1.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {z1.device}")
    if z1.dim() != 4 or z1.dtype not in (torch.float32, torch.bfloat16) or not z1.is_contiguous():
        raise ValueError(f"{fn}: z1 must be a contiguous f32 or bf16 [B, M, K, C0], got {z1.dtype} {tuple(z1.shape)}")
    if pool_mode not in ("0", "1"):
        raise ValueError(f"{fn}: pool modes '0' and '1' only, got {pool_mode!r}")
    b, m, k, c0 = z1.shape
    widths = [int(g.shape[0]) for g in gammas]
    n_layers = len(widths)
    if not 1 <= n_layers <= MAX_LAYERS or max(widths) > MAX_WIDTH or widths[0] != c0:
        raise ValueError(f"{fn}: kernel takes 1 to {MAX_LAYERS} layers of at most {MAX_WIDTH} channels "
                         f"starting at C0 = {c0}, got {widths}")
    if not (len(betas) == len(means) == len(variances) == n_layers and len(ws) == len(bs) == n_layers - 1):
        raise ValueError(f"{fn}: {n_layers} layers need as many BN parameters and stats and {n_layers - 1} Dense")
    dev = z1.device
    groups = b * m
    keep = []  # every tensor the launch reads, alive until it is enqueued

    def ptr(t: torch.Tensor) -> int:
        keep.append(t)
        return t.data_ptr()

    dgammas = [torch.empty(c, device=dev) for c in widths]
    dbetas = [torch.empty(c, device=dev) for c in widths]
    dws = [torch.empty(widths[i - 1], widths[i], device=dev) for i in range(1, n_layers)]
    dbs = [torch.empty(widths[i], device=dev) for i in range(1, n_layers)]
    table = []
    for i, c in enumerate(widths):
        var = _f32(f"variances[{i}]", variances[i], (c,), dev)
        table += [ptr(_f32(f"means[{i}]", means[i], (c,), dev)), ptr(torch.rsqrt(var + EPS)),
                  ptr(_f32(f"gammas[{i}]", gammas[i], (c,), dev)), ptr(_f32(f"betas[{i}]", betas[i], (c,), dev)),
                  ptr(dbetas[i]), ptr(dgammas[i])]
    for i in range(1, n_layers):
        w = _f32(f"ws[{i - 1}]", ws[i - 1], (widths[i - 1], widths[i]), dev)
        table += [ptr(w.to(z1.dtype).float().contiguous()), ptr(w.t().contiguous()),
                  ptr(_f32(f"bs[{i - 1}]", bs[i - 1], (widths[i],), dev)), ptr(dws[i - 1]), ptr(dbs[i - 1])]
    dp = _f32("d_pooled", d_pooled, (b, m, widths[-1]), dev)
    strides = [2 * widths[j] + (widths[j] * widths[j + 1] + widths[j + 1] if j + 1 < n_layers else 0)
               for j in range(n_layers)]
    partial_floats = min(PARTIAL_BYTES // 4, max(strides) * _MAX_BLOCKS)
    if max(strides) > partial_floats:
        raise ValueError(f"{fn}: one block's sums ({max(strides)} floats) exceed the {PARTIAL_BYTES}-byte scratch")
    partial = torch.empty(partial_floats, device=dev)
    pooled = torch.empty(groups, widths[-1], device=dev)
    cnt = torch.empty(groups, widths[-1], device=dev)
    dz1 = torch.empty_like(z1)
    c_widths = (ctypes.c_int * n_layers)(*widths)
    c_ptrs = (ctypes.c_void_p * len(table))(*table)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.satrain_bwd_launch(
            z1.data_ptr(), dp.data_ptr(), groups, k, int(z1.dtype == torch.bfloat16), int(pool_mode == "1"),
            n_layers, ctypes.addressof(c_widths), ctypes.addressof(c_ptrs), pooled.data_ptr(), cnt.data_ptr(),
            partial.data_ptr(), partial_floats, dz1.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, fn)
    grouped_bn_mlp_pool_bwd.launches += 1
    return dz1, tuple(dgammas), tuple(dbetas), tuple(dws), tuple(dbs)


grouped_bn_mlp_pool_bwd.launches = 0
