"""Duplicate-point mask: the CUDA kernel (``csrc/dupmask.cu``) beside its
plain PyTorch version.

Replaces ``scanobjectnn_tpu/ops/pallas/knn_kernel.py``:
``duplicate_mask_pallas`` (``_dup_mask_kernel``, ``pl.pallas_call``), the
input of PointCNN's unique kNN: times a bound on the squared distances it
becomes the kNN kernel's per-key bias, so that a point that repeats an
earlier one loses to every unique point (``nn/xconv.knn_indices_general``).

Semantics: ``duplicate_mask_kernel(xyz [B, N, 3] f32) -> [B, N] f32``, 1.0
where point j equals some point i < j of its cloud in all three coordinates
under float ``==`` and 0.0 elsewhere.  So ``-0.0`` equals ``0.0``, and a
point with a NaN coordinate is never a duplicate, nor the twin of one (the
JAX ``xyz == xyz`` of ``nn/xconv._duplicate_mask`` and of the TPU kernel).
The first of a group of equal points is never marked.  No gradient.

What bounds it on the H100: operations, at most N(N-1)/2 comparisons of
three floats a cloud (16.8M pairs at B=32, N=1024: about 1 us of f32 work
against 0.5 MB of bytes), so in practice the launch.  A block takes 128
points and eight threads a point, each scanning every eighth earlier point
of the cloud staged in shared memory and stopping at its first match; the
eight findings are ORed.  ``kernel_info`` reads the build's registers and
local memory; ``launch_floor`` launches an empty kernel of the same grid,
the floor of a call this small.
"""

from __future__ import annotations

import ctypes

import torch

from scanobjectnn_torch.ops.cuda import _build, takes_plain

__all__ = ["duplicate_mask_kernel", "duplicate_mask_plain", "kernel_info", "launch_floor"]


def duplicate_mask_plain(xyz: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch duplicate mask (module doc): [B, N, 3] -> [B, N] f32,
    from the [B, N, N] equality matrix and its strict upper triangle."""
    p = xyz.detach()
    n = p.shape[1]
    eq = (p[:, :, None, :] == p[:, None, :, :]).all(-1)  # eq[b, i, j]
    earlier = torch.ones(n, n, dtype=torch.bool, device=p.device).triu(1)  # i < j
    return (eq & earlier).any(dim=1).float()


def duplicate_mask_kernel(xyz: torch.Tensor) -> torch.Tensor:
    """1.0 where a point repeats an earlier point of its cloud: xyz [B, N, 3]
    f32 -> [B, N] f32.

    A CPU tensor takes ``duplicate_mask_plain``; a CUDA tensor launches the
    kernel (counted in ``duplicate_mask_kernel.launches``) or raises."""
    if takes_plain(xyz):
        return duplicate_mask_plain(xyz)
    if xyz.device.type != "cuda":
        raise ValueError(f"duplicate_mask_kernel: unsupported device {xyz.device}")
    if xyz.dim() != 3 or xyz.shape[-1] != 3 or xyz.dtype != torch.float32:
        raise ValueError(f"duplicate_mask_kernel: need float32 [B, N, 3], got {xyz.dtype} {tuple(xyz.shape)}")
    if not xyz.is_contiguous():
        raise ValueError("duplicate_mask_kernel: xyz must be contiguous")
    b, n, _ = xyz.shape
    if min(b, n) < 1:
        raise ValueError(f"duplicate_mask_kernel: empty input {tuple(xyz.shape)}")
    dup = torch.empty(b, n, dtype=torch.float32, device=xyz.device)
    lib = _build.library()
    with torch.cuda.device(xyz.device):
        err = lib.dupmask_launch(xyz.data_ptr(), b, n, dup.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "duplicate_mask_kernel")
    duplicate_mask_kernel.launches += 1
    return dup


duplicate_mask_kernel.launches = 0


def launch_floor(xyz: torch.Tensor) -> None:
    """Launch an empty kernel at ``duplicate_mask_kernel``'s grid and block
    for ``xyz`` [B, N, 3] on its card (not counted): what a launch of that
    shape costs with no work in it."""
    b, n, _ = xyz.shape
    with torch.cuda.device(xyz.device):
        err = _build.library().dupmask_floor_launch(b, n, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "duplicate_mask launch_floor")


def kernel_info() -> dict:
    """Registers, local bytes a thread, dynamic shared bytes a block and
    resident blocks per SM of the duplicate-mask kernel's build."""
    info = (ctypes.c_int * 4)()
    _build.check(_build.library().dupmask_info(ctypes.addressof(info)), "duplicate_mask kernel_info")
    return dict(zip(("registers", "local_bytes", "smem_bytes", "blocks_per_sm"), info))
