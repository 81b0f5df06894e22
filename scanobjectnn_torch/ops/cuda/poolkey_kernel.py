"""Exact-key max-pool forward: the CUDA kernel (``csrc/poolkey.cu``) beside
its plain PyTorch version.

Replaces ``scanobjectnn_tpu/ops/pallas/poolkey_kernel.py``:
``bn_relu_exactkey_pool`` (``pl.pallas_call``), the forward of the final SA
layer in bf16 training under exact-key pooling (``ops/exactpool.py``
``dense_bn_exactkey_pool``).

``bn_relu_exactkey_pool(z32 [..., K, C] f32, gamma, beta, mean, r [C] f32,
cdtype) -> (pooled [..., C] cdtype, kmax [..., C] f32, cnt [..., C] f32)``:
with ``cd`` the rounding to ``cdtype``, for every slot of the K axis

    y   = relu(cd(((cd(z32) - mean) * r) * gamma + beta))   (the value chain)
    key = relu(((z32 - mean) * r) * gamma + beta)            (f32, unrounded)

``kmax`` is the largest key of the column, ``cnt`` the number of slots
whose key equals it, and ``pooled`` the largest ``y`` among those slots.
``r = rsqrt(var + 1e-3)`` comes in as a [C] tensor that the caller computes
once, so the kernel and the plain version read the same bits: the kernel
keeps the op order above in round-to-nearest intrinsics (no FMA
contraction) and rounds to bf16 as ``Tensor.to`` does, so the two agree bit
for bit.  Any K and C.  No gradient: the op's backward recomputes its own
winners (``exactpool``).

What bounds it on the H100: bytes (z32 read once, [.., C] written); one
thread a (row, channel) column walks the K slots with coalesced reads.
"""

from __future__ import annotations

import torch

from scanobjectnn_torch.ops.cuda import _build, takes_plain

__all__ = ["bn_relu_exactkey_pool", "bn_relu_exactkey_pool_plain"]


def bn_relu_exactkey_pool_plain(
    z32: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, mean: torch.Tensor, r: torch.Tensor,
    cdtype: torch.dtype,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version (module doc)."""
    zbf = z32.to(cdtype).float()
    y = torch.relu((((zbf - mean) * r) * gamma + beta).to(cdtype))
    key = torch.relu(((z32 - mean) * r) * gamma + beta)
    kmax = key.amax(-2)
    eq = key == kmax.unsqueeze(-2)
    cnt = eq.sum(-2, dtype=torch.float32)
    pooled = torch.where(eq, y, float("-inf")).amax(-2)
    return pooled, kmax, cnt


def _check(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != shape:
        raise ValueError(
            f"bn_relu_exactkey_pool: {name} must be float32 {shape} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"bn_relu_exactkey_pool: {name} must be contiguous")


def bn_relu_exactkey_pool(
    z32: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, mean: torch.Tensor, r: torch.Tensor,
    cdtype: torch.dtype = torch.bfloat16,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training BN from given statistics, relu and the exact-key max over
    axis -2 (module doc).  A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel (counted in
    ``bn_relu_exactkey_pool.launches``) or raises."""
    if takes_plain(z32):
        return bn_relu_exactkey_pool_plain(z32, gamma, beta, mean, r, cdtype)
    if z32.device.type != "cuda":
        raise ValueError(f"bn_relu_exactkey_pool: unsupported device {z32.device}")
    if z32.dim() < 2 or cdtype not in (torch.bfloat16, torch.float32):
        raise ValueError(
            f"bn_relu_exactkey_pool: need z32 [..., K, C] and a bf16 or f32 compute dtype, "
            f"got {tuple(z32.shape)}, {cdtype}"
        )
    *lead, k, c = z32.shape
    rows = 1
    for d in lead:
        rows *= d
    dev = z32.device
    _check("z32", z32, tuple(z32.shape), dev)
    for name, t in (("gamma", gamma), ("beta", beta), ("mean", mean), ("r", r)):
        _check(name, t, (c,), dev)
    if min(rows, k, c) < 1:
        raise ValueError(f"bn_relu_exactkey_pool: empty input {tuple(z32.shape)}")
    pooled = torch.empty(*lead, c, dtype=cdtype, device=dev)
    kmax = torch.empty(*lead, c, dtype=torch.float32, device=dev)
    cnt = torch.empty(*lead, c, dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.poolkey_launch(
            z32.data_ptr(), gamma.data_ptr(), beta.data_ptr(), mean.data_ptr(), r.data_ptr(), rows, k, c,
            int(cdtype == torch.bfloat16), pooled.data_ptr(), kmax.data_ptr(), cnt.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "bn_relu_exactkey_pool")
    bn_relu_exactkey_pool.launches += 1
    return pooled, kmax, cnt


bn_relu_exactkey_pool.launches = 0
