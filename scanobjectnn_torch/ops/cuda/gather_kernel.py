"""Row gather and deterministic scatter-add: the CUDA kernels
(``csrc/gather.cu``) beside their plain PyTorch versions, and
``gather_neighbors``, the neighbour gather whose backward is the scatter.

Replaces ``scanobjectnn_tpu/ops/pallas/onehot.py``: ``flat_gather``
(``_flat_gather_impl``, ``pl.pallas_call``) and ``flat_scatter``
(``_flat_scatter_impl``), which the training path reaches through
``edge_kernel.gather_neighbors_pallas`` and its VJP.

Semantics:
  * ``gather_rows(vals [B, N, C], idx [B, R]) -> [B, R, C]``:
    ``out[b, i] = vals[b, idx[b, i]]``, an exact copy;
  * ``scatter_add_rows(idx [B, R], upd [B, R, C], n) -> [B, n, C]`` f32:
    ``out[b, j] = sum of upd[b, i] over idx[b, i] == j``, in exact f32,
    summed in ascending ``i`` (the TPU kernel sums a 2-term bf16 split of
    the cotangent, about 17 mantissa bits: the port keeps the semantics,
    not the split);
  * ``gather_neighbors(vals [B, N, C], idx [B, M, K]) -> [B, M, K, C]`` is
    a ``torch.autograd.Function``: the gather forward, the scatter-add of
    the cotangent backward.
Indices must lie in ``[0, N)``.  The kernels never read out of bounds
(the gather writes a NaN row, the scatter drops the row); the plain
versions index as PyTorch does.  The kernels take f32 only (the training
path is f32).

What bounds them on the H100: bytes.  The gather moves R rows of C floats
in and out, the scatter reads R rows and writes N.  Both give one warp to a
row, lanes across the channels.  The scatter is deterministic: a per-cloud
stable counting sort of ``idx`` into an inverse index, then one warp per
output row sums its rows in ascending order, so two calls give the same
bits (f32 ``atomicAdd`` would not).
"""

from __future__ import annotations

import torch

from scanobjectnn_torch.ops.cuda import _build

__all__ = [
    "gather_neighbors",
    "gather_rows",
    "gather_rows_plain",
    "scatter_add_rows",
    "scatter_add_rows_plain",
]


def gather_rows_plain(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch row gather: [B, N, C], [B, R] -> [B, R, C]."""
    rows = torch.arange(vals.shape[0], device=vals.device)[:, None]
    return vals[rows, idx.long()]


def scatter_add_rows_plain(idx: torch.Tensor, upd: torch.Tensor, n: int) -> torch.Tensor:
    """Plain PyTorch scatter-add: [B, R], [B, R, C] -> [B, n, C] f32
    (``index_add_`` over the flattened batch)."""
    b, r, c = upd.shape
    flat = (idx.long() + n * torch.arange(b, device=idx.device)[:, None]).reshape(-1)
    out = torch.zeros(b * n, c, dtype=torch.float32, device=upd.device)
    return out.index_add_(0, flat, upd.reshape(b * r, c).float()).reshape(b, n, c)


def _check_cuda(fn: str, name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(
            f"{fn}: {name} must be {dtype} {shape} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


def gather_rows(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather: vals [B, N, C], idx [B, R] int -> [B, R, C].

    A CPU tensor takes ``gather_rows_plain``; a CUDA tensor launches the
    kernel (counted in ``gather_rows.launches``) or raises."""
    if vals.device.type == "cpu":
        return gather_rows_plain(vals, idx)
    if vals.device.type != "cuda":
        raise ValueError(f"gather_rows: unsupported device {vals.device}")
    if vals.dim() != 3 or idx.dim() != 2:
        raise ValueError(f"gather_rows: need [B, N, C] and [B, R], got {tuple(vals.shape)}, {tuple(idx.shape)}")
    b, n, c = vals.shape
    r = idx.shape[1]
    _check_cuda("gather_rows", "vals", vals, torch.float32, (b, n, c), vals.device)
    _check_cuda("gather_rows", "idx", idx, torch.int32, (b, r), vals.device)
    out = torch.empty(b, r, c, dtype=torch.float32, device=vals.device)
    lib = _build.library()
    with torch.cuda.device(vals.device):
        err = lib.gather_launch(
            vals.data_ptr(), idx.data_ptr(), b, n, r, c, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "gather_rows")
    gather_rows.launches += 1
    return out


def scatter_add_rows(idx: torch.Tensor, upd: torch.Tensor, n: int) -> torch.Tensor:
    """Deterministic scatter-add: idx [B, R] int, upd [B, R, C] -> [B, n, C]
    f32.

    A CPU tensor takes ``scatter_add_rows_plain``; a CUDA tensor launches
    the kernel (counted in ``scatter_add_rows.launches``) or raises."""
    if upd.device.type == "cpu":
        return scatter_add_rows_plain(idx, upd, n)
    if upd.device.type != "cuda":
        raise ValueError(f"scatter_add_rows: unsupported device {upd.device}")
    if upd.dim() != 3:
        raise ValueError(f"scatter_add_rows: need upd [B, R, C], got {tuple(upd.shape)}")
    b, r, c = upd.shape
    _check_cuda("scatter_add_rows", "upd", upd, torch.float32, (b, r, c), upd.device)
    _check_cuda("scatter_add_rows", "idx", idx, torch.int32, (b, r), upd.device)
    out = torch.empty(b, n, c, dtype=torch.float32, device=upd.device)
    offsets = torch.empty(b, n + 1, dtype=torch.int32, device=upd.device)
    perm = torch.empty(b, r, dtype=torch.int32, device=upd.device)
    lib = _build.library()
    with torch.cuda.device(upd.device):
        err = lib.scatter_add_launch(
            idx.data_ptr(), upd.data_ptr(), b, n, r, c, offsets.data_ptr(), perm.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "scatter_add_rows")
    scatter_add_rows.launches += 1
    return out


gather_rows.launches = 0
scatter_add_rows.launches = 0


class _GatherNeighbors(torch.autograd.Function):
    """Counterpart of ``edge_kernel.gather_neighbors_pallas`` and its
    custom VJP: gather forward, scatter-add of the cotangent backward."""

    @staticmethod
    def forward(ctx, vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        b, m, k = idx.shape
        flat = idx.reshape(b, m * k)
        ctx.save_for_backward(flat)
        ctx.n, ctx.dtype = vals.shape[1], vals.dtype
        return gather_rows(vals, flat).reshape(b, m, k, vals.shape[-1]).to(vals.dtype)

    @staticmethod
    def backward(ctx, dout: torch.Tensor):
        (flat,) = ctx.saved_tensors
        b, r = flat.shape
        upd = dout.reshape(b, r, dout.shape[-1]).float().contiguous()
        return scatter_add_rows(flat, upd, ctx.n).to(ctx.dtype), None


def gather_neighbors(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Neighbour gather [B, N, C], int32 [B, M, K] -> [B, M, K, C],
    differentiable in ``vals`` (backward: ``scatter_add_rows``)."""
    return _GatherNeighbors.apply(vals, idx)
