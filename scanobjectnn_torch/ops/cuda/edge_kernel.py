"""DGCNN's neighbour reductions and neighbour gather: the CUDA kernels
(``csrc/edge.cu``, with ``csrc/knn.cu`` for the graph) beside their plain
PyTorch versions.

Replaces ``scanobjectnn_tpu/ops/pallas/edge_kernel.py``:
``edge_reduce_pallas`` (forward ``_fwd_kernel``, backward ``_er_bwd_kernel``,
``pl.pallas_call``), which every fused EdgeConv runs, and
``edge_gather_knn`` (``_knn_gather_kernel``), which the T-Net's first layer
runs.

Semantics:
  * ``edge_reduce(feats [B, N, Cf], vals [B, N, Cv], k)`` -> dict of
    ``mmax``, ``mmin``, ``s``, ``q2``, ``cntmax``, ``cntmin`` [B, N, Cv] f32
    and ``idx`` [B, N, k] int32: ``idx`` is the self-kNN graph of ``feats``
    (``knn_graph``, self edge included), and for each point the max, min,
    sum and sum of squares of ``vals`` over its k neighbours, with the number
    of neighbours equal to the max and to the min.  ``s`` and ``q2`` are
    sums in slot order: ``g0 + g1 + ...`` and ``g0*g0 + g1*g1 + ...``, each
    product and sum rounded to f32 on its own.  Differentiable in ``vals``
    only: the backward splits ``dmax`` and ``dmin`` evenly across tied
    neighbours, as ``jnp.max``'s VJP and ``torch.amax`` do;
  * ``edge_gather_knn(feats [B, N, Cf], vals [B, N, Cv], k)`` ->
    (gathered [B, N, k, Cv] in ``vals.dtype``, idx [B, N, k] int32),
    differentiable in ``vals``.  It returns rows in the dtype of ``vals``, as
    the JAX package's lax path (``gather_neighbors``) does, where its Pallas
    kernel returns f32 rows: with bf16 ``vals`` the T-Net's ``a + bj`` is a
    bf16 sum in the port and on the JAX lax path.

On the card ``edge_reduce`` is the graph kernel (``knn_graph_kernel``)
followed by ``edge_reduce_fwd_kernel``, one warp per point reading its k
neighbours' rows in slot order; its backward is ``edge_reduce_bwd_kernel``,
which sums each point's incoming edge coefficients in ascending (query,
slot) order over the graph's inverse index (``csrc/countsort.cuh``, shared
with the scatter-add), re-reading ``vals`` where the TPU saved the gathered
[B, k, N, Cv] rows.  ``edge_gather_knn`` is the graph kernel followed by
``gather_neighbors`` (the gather kernel #6; backward the scatter-add #7):
the TPU fused the kNN and the gather only because its one-hot MXU gather
cost nothing beside the argmin rounds.

What bounds them on the H100: bytes.  The forward reduce reads the values
once and writes six [B, N, Cv] outputs (120 MB at B=32, N=1024, Cv=128);
the backward reads eight per-query tensors and writes one.  The plain
versions use ``knn_graph_plain``, an indexing gather and reductions, and
autograd for the backward; the forward agrees with the kernel bit for bit.
"""

from __future__ import annotations

import torch

from scanobjectnn_torch.ops.cuda import _build
from scanobjectnn_torch.ops.cuda.gather_kernel import _check_cuda, gather_neighbors, gather_rows_plain, sort_buffers
from scanobjectnn_torch.ops.cuda.knn_kernel import knn_graph_kernel, knn_graph_plain

__all__ = [
    "REDUCTIONS",
    "edge_gather_knn",
    "edge_gather_knn_plain",
    "edge_reduce",
    "edge_reduce_bwd_kernel",
    "edge_reduce_fwd_kernel",
    "edge_reduce_plain",
    "reduce_neighbors_plain",
]

REDUCTIONS = ("mmax", "mmin", "s", "q2", "cntmax", "cntmin")


def _gather_plain(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[B, N, C], [B, M, k] -> [B, M, k, C] by indexing (differentiable)."""
    b, m, k = idx.shape
    return gather_rows_plain(vals, idx.reshape(b, m * k)).reshape(b, m, k, vals.shape[-1])


def reduce_neighbors_plain(vals: torch.Tensor, idx: torch.Tensor) -> dict:
    """The six reductions of ``edge_reduce`` over a given graph ``idx``
    (the plain version of ``edge_reduce_fwd_kernel``): an indexing gather
    and reductions, with ``s`` and ``q2`` summed in slot order."""
    g = _gather_plain(vals.float(), idx)  # [B, N, k, Cv]
    s, q2 = g[:, :, 0], g[:, :, 0] * g[:, :, 0]
    for r in range(1, idx.shape[-1]):
        s = s + g[:, :, r]
        q2 = q2 + g[:, :, r] * g[:, :, r]
    mmax, mmin = torch.amax(g, dim=2), torch.amin(g, dim=2)
    gd = g.detach()
    return {
        "mmax": mmax, "mmin": mmin, "s": s, "q2": q2,
        "cntmax": (gd == mmax.detach()[:, :, None]).sum(2).float(),
        "cntmin": (gd == mmin.detach()[:, :, None]).sum(2).float(),
    }


def edge_reduce_plain(feats: torch.Tensor, vals: torch.Tensor, k: int) -> dict:
    """Plain PyTorch ``edge_reduce`` (module doc): ``knn_graph_plain`` and
    ``reduce_neighbors_plain``; autograd gives the backward."""
    idx = knn_graph_plain(feats.detach().float(), k)
    return {**reduce_neighbors_plain(vals, idx), "idx": idx}


def edge_reduce_fwd_kernel(vals: torch.Tensor, idx: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The forward reduce on the card: vals [B, N, Cv] f32, idx [B, N, k]
    int32 in [0, N) -> (mmax, mmin, s, q2, cntmax, cntmin), each [B, N, Cv]
    f32.  Launches the kernel (counted in ``edge_reduce_fwd_kernel.launches``)
    or raises."""
    fn = "edge_reduce_fwd_kernel"
    if vals.device.type != "cuda" or vals.dim() != 3 or idx.dim() != 3:
        raise ValueError(f"{fn}: need CUDA [B, N, Cv] and [B, N, k], got {tuple(vals.shape)} on {vals.device}")
    b, n, cv = vals.shape
    k = idx.shape[-1]
    _check_cuda(fn, "vals", vals, torch.float32, (b, n, cv), vals.device)
    _check_cuda(fn, "idx", idx, torch.int32, (b, n, k), vals.device)
    if min(b, n, cv, k) < 1:
        raise ValueError(f"{fn}: empty input {tuple(vals.shape)}, {tuple(idx.shape)}")
    outs = tuple(torch.empty(b, n, cv, dtype=torch.float32, device=vals.device) for _ in REDUCTIONS)
    lib = _build.library()
    with torch.cuda.device(vals.device):
        err = lib.edge_reduce_fwd_launch(
            vals.data_ptr(), idx.data_ptr(), b, n, k, cv, *(o.data_ptr() for o in outs),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, fn)
    edge_reduce_fwd_kernel.launches += 1
    return outs


def edge_reduce_bwd_kernel(vals, idx, mmax, mmin, cntmax, cntmin, dmax, dmin, ds, dq2) -> torch.Tensor:
    """The backward of the forward reduce in ``vals``, on the card: the
    forward's inputs and outputs and the cotangents of mmax, mmin, s and q2
    ([B, N, Cv] f32) -> dvals [B, N, Cv] f32.  Launches the kernel (counted
    in ``edge_reduce_bwd_kernel.launches``) or raises."""
    fn = "edge_reduce_bwd_kernel"
    if vals.device.type != "cuda" or vals.dim() != 3 or idx.dim() != 3:
        raise ValueError(f"{fn}: need CUDA [B, N, Cv] and [B, N, k], got {tuple(vals.shape)} on {vals.device}")
    b, n, cv = vals.shape
    k = idx.shape[-1]
    _check_cuda(fn, "idx", idx, torch.int32, (b, n, k), vals.device)
    named = dict(vals=vals, mmax=mmax, mmin=mmin, cntmax=cntmax, cntmin=cntmin, dmax=dmax, dmin=dmin, ds=ds, dq2=dq2)
    for name, t in named.items():
        _check_cuda(fn, name, t, torch.float32, (b, n, cv), vals.device)
    if min(b, n, cv, k) < 1:
        raise ValueError(f"{fn}: empty input {tuple(vals.shape)}, {tuple(idx.shape)}")
    dvals = torch.empty(b, n, cv, dtype=torch.float32, device=vals.device)
    lib = _build.library()
    offsets, perm, counts = sort_buffers(lib, b, n, n * k, vals.device)
    with torch.cuda.device(vals.device):
        err = lib.edge_reduce_bwd_launch(
            vals.data_ptr(), idx.data_ptr(), mmax.data_ptr(), mmin.data_ptr(), cntmax.data_ptr(),
            cntmin.data_ptr(), dmax.data_ptr(), dmin.data_ptr(), ds.data_ptr(), dq2.data_ptr(),
            b, n, k, cv, offsets.data_ptr(), perm.data_ptr(), counts.data_ptr(), dvals.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, fn)
    edge_reduce_bwd_kernel.launches += 1
    return dvals


edge_reduce_fwd_kernel.launches = 0
edge_reduce_bwd_kernel.launches = 0


class _EdgeReduce(torch.autograd.Function):
    """Counterpart of ``edge_reduce_pallas`` and its custom VJP: the forward
    reduce kernel, and the backward kernel for ``vals``."""

    @staticmethod
    def forward(ctx, vals: torch.Tensor, idx: torch.Tensor):
        outs = edge_reduce_fwd_kernel(vals, idx)
        mmax, mmin, _, _, cntmax, cntmin = outs
        ctx.save_for_backward(vals, idx, mmax, mmin, cntmax, cntmin)
        ctx.mark_non_differentiable(cntmax, cntmin)
        return outs

    @staticmethod
    def backward(ctx, dmax, dmin, ds, dq2, _dcntmax, _dcntmin):
        vals, idx, mmax, mmin, cntmax, cntmin = ctx.saved_tensors
        cot = (t.float().contiguous() for t in (dmax, dmin, ds, dq2))
        return edge_reduce_bwd_kernel(vals, idx, mmax, mmin, cntmax, cntmin, *cot), None


def edge_reduce(feats: torch.Tensor, vals: torch.Tensor, k: int) -> dict:
    """Self-kNN graph of ``feats`` and the neighbour reductions of ``vals``
    (module doc); differentiable in ``vals``.

    A CPU tensor takes ``edge_reduce_plain``; a CUDA tensor launches the
    graph kernel and the reduce kernels, or raises."""
    if vals.device.type == "cpu":
        return edge_reduce_plain(feats, vals, k)
    idx = knn_graph_kernel(feats.detach().float().contiguous(), k)
    outs = _EdgeReduce.apply(vals.float().contiguous(), idx)
    return {**dict(zip(REDUCTIONS, outs)), "idx": idx}


def edge_gather_knn_plain(feats: torch.Tensor, vals: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch ``edge_gather_knn``: ``knn_graph_plain`` and an indexing
    gather."""
    idx = knn_graph_plain(feats.detach().float(), k)
    return _gather_plain(vals, idx), idx


def edge_gather_knn(feats: torch.Tensor, vals: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Self-kNN graph of ``feats`` and the neighbours' rows of ``vals``
    (module doc): (gathered [B, N, k, Cv] in ``vals.dtype``, idx [B, N, k]).

    A CPU tensor takes ``edge_gather_knn_plain``; a CUDA tensor launches the
    graph kernel and the gather kernel (counted together in
    ``edge_gather_knn.launches``), or raises."""
    if vals.device.type == "cpu":
        return edge_gather_knn_plain(feats, vals, k)
    idx = knn_graph_kernel(feats.detach().float().contiguous(), k)
    out = gather_neighbors(vals.float().contiguous(), idx).to(vals.dtype)
    edge_gather_knn.launches += 1
    return out, idx


edge_gather_knn.launches = 0
