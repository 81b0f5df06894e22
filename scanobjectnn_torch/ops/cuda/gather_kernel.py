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
row, lanes across the channels (the scatter's sum takes several rows a warp
where C <= 16).  The scatter is deterministic: a stable counting sort of
``idx`` into an inverse index (``count_sort_kernel``: offsets and perm
equal to a stable argsort's), spread over (cloud, tile of rows) blocks,
then one warp per output row sums its rows in ascending order, so two
calls give the same bits (f32 ``atomicAdd`` would not), equal to the
sequential ``index_add_`` of ``scatter_add_rows_plain`` on the CPU.
"""

from __future__ import annotations

import torch

from scanobjectnn_torch.ops.cuda import _build, takes_plain

__all__ = [
    "count_sort_kernel",
    "count_sort_plain",
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
    if takes_plain(vals):
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


def count_sort_plain(idx: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch inverse index of idx [B, R] over n points: offsets
    [B, n + 1] (exclusive prefix sums of the rows aimed at each point) and
    perm [B, R] (the rows by point, ascending within a point: a stable
    argsort), int32; rows outside [0, n) are left out and perm past
    offsets[:, n] is -1."""
    b, r = idx.shape
    key = idx.long()
    valid = (key >= 0) & (key < n)
    key = torch.where(valid, key, torch.full_like(key, n))
    order = torch.argsort(key, dim=1, stable=True)
    counts = torch.zeros(b, n + 1, dtype=torch.long, device=idx.device).scatter_add_(1, key, torch.ones_like(key))
    offsets = torch.cat([torch.zeros(b, 1, dtype=torch.long, device=idx.device), counts[:, :n].cumsum(1)], 1)
    perm = torch.where(torch.arange(r, device=idx.device)[None] < offsets[:, n:], order, torch.full_like(order, -1))
    return offsets.to(torch.int32), perm.to(torch.int32)


def sort_buffers(lib, b: int, n: int, r: int, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """offsets [b, n + 1], perm [b, r] and the counting sort's scratch, int32
    on ``device``."""
    tiles = lib.count_sort_tiles_for(n, r)
    return (torch.empty(b, n + 1, dtype=torch.int32, device=device),
            torch.empty(b, r, dtype=torch.int32, device=device),
            torch.empty(b, tiles, n, dtype=torch.int32, device=device))


def count_sort_kernel(idx: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The counting sort that the scatter-add and the EdgeConv backward run,
    alone, on the card: idx [B, R] int32 -> (offsets, perm) as
    ``count_sort_plain``, but perm past offsets[:, n] is not written.
    Launches the sort (counted in
    ``count_sort_kernel.launches``) or raises."""
    if idx.device.type != "cuda" or idx.dim() != 2:
        raise ValueError(f"count_sort_kernel: need a CUDA [B, R] index, got {tuple(idx.shape)} on {idx.device}")
    b, r = idx.shape
    _check_cuda("count_sort_kernel", "idx", idx, torch.int32, (b, r), idx.device)
    lib = _build.library()
    offsets, perm, counts = sort_buffers(lib, b, n, r, idx.device)
    with torch.cuda.device(idx.device):
        err = lib.count_sort_launch(idx.data_ptr(), b, n, r, offsets.data_ptr(), perm.data_ptr(), counts.data_ptr(),
                                    torch.cuda.current_stream().cuda_stream)
    _build.check(err, "count_sort_kernel")
    count_sort_kernel.launches += 1
    return offsets, perm


def scatter_add_rows(idx: torch.Tensor, upd: torch.Tensor, n: int) -> torch.Tensor:
    """Deterministic scatter-add: idx [B, R] int, upd [B, R, C] -> [B, n, C]
    f32.

    A CPU tensor takes ``scatter_add_rows_plain``; a CUDA tensor launches
    the kernel (counted in ``scatter_add_rows.launches``) or raises."""
    if takes_plain(upd):
        return scatter_add_rows_plain(idx, upd, n)
    if upd.device.type != "cuda":
        raise ValueError(f"scatter_add_rows: unsupported device {upd.device}")
    if upd.dim() != 3:
        raise ValueError(f"scatter_add_rows: need upd [B, R, C], got {tuple(upd.shape)}")
    b, r, c = upd.shape
    _check_cuda("scatter_add_rows", "upd", upd, torch.float32, (b, r, c), upd.device)
    _check_cuda("scatter_add_rows", "idx", idx, torch.int32, (b, r), upd.device)
    out = torch.empty(b, n, c, dtype=torch.float32, device=upd.device)
    lib = _build.library()
    offsets, perm, counts = sort_buffers(lib, b, n, r, upd.device)
    with torch.cuda.device(upd.device):
        err = lib.scatter_add_launch(
            idx.data_ptr(), upd.data_ptr(), b, n, r, c, offsets.data_ptr(), perm.data_ptr(), counts.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "scatter_add_rows")
    scatter_add_rows.launches += 1
    return out


gather_rows.launches = 0
scatter_add_rows.launches = 0
count_sort_kernel.launches = 0


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
