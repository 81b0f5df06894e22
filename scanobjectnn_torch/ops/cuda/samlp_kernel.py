"""Eval-time SA layer over a given grouping: gather + folded-BN MLP +
max-pool, as a CUDA kernel (``csrc/safused.cu``, ``samlp_launch``) beside
its plain PyTorch version, and the eval BatchNorm fold of both fused SA
kernels.

Replaces ``scanobjectnn_tpu/ops/pallas/samlp_kernel.py``: ``sa_mlp_pool``
-> ``_sa_mlp_pool_call`` (``pl.pallas_call``), and
``fold_bn_mlp_params``.  ``SAModule`` reaches it at eval with ``knn=True``
(the rows are the K nearest points) or ``nsample > 64`` (a ball group).

Semantics (kept from the TPU kernel):
  * the rows of query m are the K neighbours ``idx[m]``; layer 0 is
    ``c3·W0x + src[idx]·W0f + b0`` with ``c3 = grouped_xyz[m]``, in the SSG
    row order [xyz(3), feats(C)]; without ``grouped_xyz`` (``use_xyz``
    False) W0 holds feature rows only, without features xyz rows only; then
    relu, the remaining folded layers with relu, and a max over the K rows;
  * precision: the source is cast to the compute dtype and gathered
    exactly, operands are rounded to the compute dtype before each product,
    products are summed in f32, the f32 bias is added, then relu; no
    prelift (the JAX function lifts nothing).
Output: ``pooled [B, M, Cout]`` in the compute dtype.

What bounds it on the H100: the folded MLP's FLOPs on CUDA cores, as the
ball-selected layer (``safused_kernel.py``): the kernel is the same one,
whose rows are staged from ``grouped_xyz``/``idx`` instead of a ball scan,
in chunks of at most 64 rows for any K.

Eval BatchNorm is a per-channel affine, folded into the Dense weights:
  relu(BN(x @ W + b)) == relu(x @ (W*s) + (b*s + t)),
  s = gamma * rsqrt(var + eps), t = beta - mean*s.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from scanobjectnn_torch.ops.cuda import _build, takes_plain
from scanobjectnn_torch.ops.cuda.gather_kernel import _check_cuda
from scanobjectnn_torch.ops.cuda.safused_kernel import (
    MAX_NSAMPLE,
    check_layer_count,
    layer_table,
    mlp_pool_plain,
    prepare,
)

__all__ = ["fold_bn_mlp_params", "sa_mlp_pool", "sa_mlp_pool_plain"]


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


def _prepared(grouped_xyz, idx, src_feats, weights, biases, dtype):
    if grouped_xyz is None and (src_feats is None or idx is None):
        raise ValueError("sa_mlp_pool: needs grouped_xyz, or idx with src_feats")
    src = src_feats if idx is not None else None
    return prepare(src, weights, biases, grouped_xyz is not None, True, dtype, prelift=False)


def sa_mlp_pool_plain(
    grouped_xyz: torch.Tensor | None,
    idx: torch.Tensor | None,
    src_feats: torch.Tensor | None,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain PyTorch version of ``sa_mlp_pool`` (module doc)."""
    p = _prepared(grouped_xyz, idx, src_feats, weights, biases, dtype)
    g = None
    if p.src is not None:
        rows = torch.arange(idx.shape[0], device=idx.device)[:, None, None]
        g = p.src[rows, idx.long()]
    return mlp_pool_plain(p, None if grouped_xyz is None else grouped_xyz.float(), g)


def sa_mlp_pool(
    grouped_xyz: torch.Tensor | None,
    idx: torch.Tensor | None,
    src_feats: torch.Tensor | None,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Gather + folded-BN MLP + max-pool over a given grouping.

    grouped_xyz: [B, M, K, 3] f32 centred coordinates, or None; idx: [B, M,
    K] int32 into ``src_feats`` [B, N, C], or None when the layer has no
    point features; weights/biases: folded per-layer Dense params
    (``fold_bn_mlp_params``), layer-0 rows [xyz(3), feats(C)].  Returns
    pooled [B, M, feats[-1]] in ``dtype``.

    CPU tensors take ``sa_mlp_pool_plain``; CUDA tensors launch the kernel
    (counted in ``sa_mlp_pool.launches``) or raise.  For inference: the
    output carries no gradient."""
    ref = grouped_xyz if grouped_xyz is not None else idx
    if ref is not None and takes_plain(ref):
        return sa_mlp_pool_plain(grouped_xyz, idx, src_feats, weights, biases, dtype)
    fn = "sa_mlp_pool"
    if ref is not None and ref.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {ref.device}")
    check_layer_count(fn, weights, biases)
    p = _prepared(grouped_xyz, idx, src_feats, weights, biases, dtype)
    dev = ref.device
    b, m, k = ref.shape[:3]
    if not 1 <= k <= MAX_NSAMPLE:
        raise ValueError(f"{fn}: kernel takes 1 <= K <= {MAX_NSAMPLE}, got {k}")
    if grouped_xyz is not None:
        _check_cuda(fn, "grouped_xyz", grouped_xyz, torch.float32, (b, m, k, 3), dev)
    n = cs = 0
    if p.src is not None:
        _check_cuda(fn, "idx", idx, torch.int32, (b, m, k), dev)
        n, cs = p.src.shape[1], p.src.shape[2]
        _check_cuda(fn, "src_feats", p.src, p.cdtype, (b, n, cs), dev)
    widths, c_widths, c_weights, c_biases = layer_table(fn, p, weights, cs, dev)
    pooled = torch.empty(b, m, widths[-1], dtype=p.cdtype, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.samlp_launch(
            None if grouped_xyz is None else grouped_xyz.data_ptr(),
            None if p.src is None else idx.data_ptr(),
            None if p.src is None else p.src.data_ptr(),
            b, n, m, cs, k,
            None if p.w0x is None else p.w0x.data_ptr(),
            None if p.w0f is None else p.w0f.data_ptr(),
            int(p.cdtype == torch.bfloat16), len(widths), ctypes.addressof(c_widths),
            ctypes.addressof(c_weights), ctypes.addressof(c_biases), pooled.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, fn)
    sa_mlp_pool.launches += 1
    return pooled


sa_mlp_pool.launches = 0
