"""Stable rank sort of point clouds by a scalar key: the CUDA kernel
(``csrc/ranksort.cu``) beside its plain PyTorch version.

Replaces ``scanobjectnn_tpu/ops/pallas/ranksort_kernel.py``:
``rank_sort_points`` (``pl.pallas_call``), the prep of the spatially
bucketed SA layer (``sabucket_kernel.py``), which sorts a layer's points and
its queries along each cloud's widest axis.

``rank_sort_points(key [B, N] f32, xyz [B, N, 3] f32, feats [B, N, C] or
None) -> (xyz_s [B, N, 3] f32, ids [B, N] int32, rank [B, N] int32, feats_s
[B, N, C] or None)``:

  * the order is the stable one, JAX's comparison rank
    ``rank(i) = #{j : key_j < key_i or (key_j == key_i and j < i)}``, so
    -0.0 and +0.0 compare equal and tie by index;
  * a NaN key sorts after every number (ties among NaNs by index), as in
    ``torch.argsort``.  JAX's rule gives a NaN key rank 0, which collides
    with the smallest key's, so its rank is no permutation there; this one
    always is;
  * ``xyz_s[b, r] = xyz[b, ids[b, r]]`` bit for bit, ``rank`` is the
    inverse permutation (``ids[b, rank[b, i]] == i``), and ``feats_s`` the
    feature rows, any dtype, carried by the same permutation.

The TPU kernel's bf16 Dekker planes, its two-term id split, its one-hot MXU
scatter and its ``[B, 8, N]`` sublane padding are TPU mechanisms: the card
moves f32 and ints exactly with plain loads.

What bounds it on the H100: bytes.  One block a cloud sorts (key bits,
index) words in shared memory with a bitonic sort (N <= ``MAX_N``); its
barriers, not the bytes, set its time.
"""

from __future__ import annotations

import torch

from scanobjectnn_torch.ops.cuda import _build
from scanobjectnn_torch.ops.cuda.gather_kernel import _check_cuda

__all__ = ["rank_sort_points", "rank_sort_points_plain", "sort_order_key"]

MAX_N = 16384  # kMaxN in csrc/ranksort.cu


def sort_order_key(key: torch.Tensor) -> torch.Tensor:
    """int64 keys whose order is the sort's (module doc): the f32 value's
    order, -0.0 equal to +0.0, a NaN after +inf."""
    bits = key.float().contiguous().view(torch.int32).long()
    ordered = torch.where(bits < 0, -(bits + 2**31), bits)  # -0.0 (bits -2^31) maps to 0, as +0.0
    return torch.where(torch.isnan(key), 2**31, ordered)


def rank_sort_points_plain(
    key: torch.Tensor, xyz: torch.Tensor, feats: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """Plain PyTorch version (module doc): a stable argsort and gathers."""
    order = torch.argsort(sort_order_key(key), dim=1, stable=True)
    rank = torch.empty_like(order).scatter_(1, order, torch.arange(key.shape[1], device=key.device).expand_as(order))
    xyz_s = torch.gather(xyz, 1, order[..., None].expand(-1, -1, 3))
    feats_s = None if feats is None else torch.gather(feats, 1, order[..., None].expand(-1, -1, feats.shape[-1]))
    return xyz_s, order.to(torch.int32), rank.to(torch.int32), feats_s


def rank_sort_points(
    key: torch.Tensor, xyz: torch.Tensor, feats: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """Stable sort of each cloud by ``key`` (module doc).

    A CPU tensor takes ``rank_sort_points_plain``; a CUDA tensor launches the
    kernel (counted in ``rank_sort_points.launches``) or raises."""
    if key.device.type == "cpu":
        return rank_sort_points_plain(key, xyz, feats)
    fn = "rank_sort_points"
    if key.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {key.device}")
    if key.dim() != 2 or not 1 <= key.shape[1] <= MAX_N:
        raise ValueError(f"{fn}: key must be [B, N] with 1 <= N <= {MAX_N}, got {tuple(key.shape)}")
    dev = key.device
    b, n = key.shape
    _check_cuda(fn, "key", key, torch.float32, (b, n), dev)
    _check_cuda(fn, "xyz", xyz, torch.float32, (b, n, 3), dev)
    units = 0
    if feats is not None:
        if feats.dim() != 3 or feats.element_size() not in (2, 4):
            raise ValueError(f"{fn}: feats must be [B, N, C] of 2- or 4-byte elements, got {feats.dtype}")
        _check_cuda(fn, "feats", feats, feats.dtype, (b, n, feats.shape[-1]), dev)
        units = feats.shape[-1] * feats.element_size() // 2
    xyz_s = torch.empty_like(xyz)
    ids = torch.empty(b, n, dtype=torch.int32, device=dev)
    rank = torch.empty(b, n, dtype=torch.int32, device=dev)
    feats_s = None if feats is None else torch.empty_like(feats)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.ranksort_launch(
            key.data_ptr(), xyz.data_ptr(), None if feats is None else feats.data_ptr(), b, n, units,
            xyz_s.data_ptr(), ids.data_ptr(), rank.data_ptr(), None if feats_s is None else feats_s.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, fn)
    rank_sort_points.launches += 1
    return xyz_s, ids, rank, feats_s


rank_sort_points.launches = 0
