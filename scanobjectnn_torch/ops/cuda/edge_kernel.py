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
    bf16 sum in the port and on the JAX lax path.  Its backward sums each
    point's row cotangents in f32 and casts the sum to the dtype of ``vals``
    once, as the Pallas VJP does (the lax path sums in bf16);
    ``edge_reduce``'s backward likewise.

On the card ``edge_reduce`` is the graph kernel (``knn_graph_kernel``)
followed by ``edge_reduce_fwd_kernel``, ``fwd_lanes`` lanes a point (a
half-warp up to 64 channels) reading its k neighbours' rows in slot order,
four slots' rows loaded at once, its outputs written with streaming stores;
its backward is ``edge_reduce_bwd_kernel``,
which sums each point's incoming edge coefficients in ascending (query,
slot) order over the graph's inverse index (``csrc/countsort.cuh``, shared
with the scatter-add), re-reading ``vals`` where the TPU saved the gathered
[B, k, N, Cv] rows.  A block of the backward takes a (cloud, slice of
``bwd_slice_width`` channels), stages every query's slice of the per-query
operands in shared memory (24 bytes a query and channel, the two quotients
formed once a query), then walks each point's edges; a cloud of more than
9685 points, whose one channel does not fit, takes the per-edge kernel
(counted in ``edge_reduce_bwd_kernel.routed_launches``).
``edge_reduce_bwd_ordered`` is the backward in the kernel's order, bit for
bit; ``kernel_info`` reads each build's registers and local memory.
``edge_gather_knn`` at k <= ``FUSED_MAX_K`` (32) is one kernel: the graph
kernel of ``csrc/knn.cu`` built with an epilogue that, once a warp's lists
are final, copies each point's k neighbour rows of ``vals`` (f32 or bf16,
an exact copy) to the output as well as writing ``idx``
(``knn_kernel.graph_kernel_info(c, gather=True)`` reads its build); its
backward is the scatter-add #7 over ``idx``.  Above it, the graph goes
through the general kNN and the rows through ``gather_neighbors`` (the
gather kernel #6), counted in ``edge_gather_knn.routed_launches``.

What bounds them on the H100: bytes.  The forward reduce reads the values
once and writes six [B, N, Cv] outputs (120 MB at B=32, N=1024, Cv=128);
the backward reads eight per-query tensors and writes one.  The plain
versions use ``knn_graph_plain``, an indexing gather and reductions, and
autograd for the backward; the forward agrees with the kernel bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from scanobjectnn_torch.ops.cuda import _build, takes_plain
from scanobjectnn_torch.ops.cuda.gather_kernel import (
    _check_cuda,
    gather_neighbors,
    gather_rows_plain,
    scatter_add_rows,
    sort_buffers,
)
from scanobjectnn_torch.ops.cuda.knn_kernel import GRAPH_MAX_K, knn_graph_kernel, knn_graph_plain

__all__ = [
    "FUSED_DTYPES",
    "FUSED_MAX_K",
    "REDUCTIONS",
    "bwd_slice_width",
    "edge_gather_knn",
    "edge_gather_knn_plain",
    "edge_reduce",
    "edge_reduce_bwd_kernel",
    "edge_reduce_bwd_ordered",
    "edge_reduce_fwd_kernel",
    "edge_reduce_plain",
    "fwd_lanes",
    "kernel_info",
    "reduce_neighbors_plain",
]

REDUCTIONS = ("mmax", "mmin", "s", "q2", "cntmax", "cntmin")
BWD_SMEM_BYTES = 232_448  # the most shared memory a block may use on an H100 (227 KB)
BWD_STAGED_BYTES = 24  # the backward's staged bytes a (query, channel)
BWD_MAX_SLICE = 8  # channels a block of the backward takes, at most
FWD_LANES = (16, 32)  # lanes a query of the forward may take
FUSED_MAX_K = GRAPH_MAX_K  # kGraphMaxK in csrc/knn.cu: the largest k of the fused graph and gather
FUSED_DTYPES = (torch.float32, torch.bfloat16)  # the dtypes of vals the fused gather copies as they are


def bwd_slice_width(n: int, cv: int) -> int:
    """Channels a block of the backward stages for clouds of ``n`` points
    and ``cv`` channels: 8, halved while ``24 n S`` bytes exceed 227 KB or
    half as many still hold every channel; 0 where one channel does not fit
    (``n`` > 9685): the per-edge route.  The blocks take channels [0, S),
    [S, 2S), ... up to ``cv``."""
    s = BWD_MAX_SLICE
    while s > 1 and (BWD_STAGED_BYTES * n * s > BWD_SMEM_BYTES or s // 2 >= cv):
        s //= 2
    return s if BWD_STAGED_BYTES * n * s <= BWD_SMEM_BYTES else 0


def fwd_lanes(cv: int) -> int:
    """Lanes a query of the forward takes at ``cv`` channels: 16 (two
    queries a warp) where 16 lanes of 4 floats hold every channel (``cv``
    <= 64), else 32."""
    return 16 if cv <= 64 else 32


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


def edge_reduce_bwd_ordered(vals, idx, mmax, mmin, cntmax, cntmin, dmax, dmin, ds, dq2) -> torch.Tensor:
    """The backward of the forward reduce in ``vals`` in the kernel's order
    (module doc): the same arguments as ``edge_reduce_bwd_kernel`` -> dvals
    [B, N, Cv] f32, bit for bit the kernel's.  Each edge's coefficient
    ``ds + (2 g) dq2``, plus ``dmax / fmax(cntmax, 1)`` where ``g == mmax``
    and then ``dmin / fmax(cntmin, 1)`` where ``g == mmin`` (``g`` the
    point's value), each operation rounded on its own; each point sums its
    edges from +0 in ascending (query, slot) order, padded with +0 terms
    to the most edges a point has (``acc + 0`` is ``acc``: a sum from +0
    is never -0).  Edges whose index is outside [0, N) are left out, as the
    counting sort leaves them out."""
    b, n, cv = vals.shape
    k = idx.shape[-1]
    flat = idx.reshape(b, n * k).long()
    point = torch.where((flat >= 0) & (flat < n), flat, n)  # n: left out
    order = torch.argsort(point, dim=1, stable=True)  # edges by (point, query, slot)
    counts = torch.zeros(b, n + 1, dtype=torch.long, device=vals.device)
    counts = counts.scatter_add_(1, point, torch.ones_like(point))[:, :n]
    starts = torch.cumsum(counts, 1) - counts
    rows = torch.arange(b, device=vals.device)[:, None]
    q = order // k
    g = vals[rows, torch.gather(point, 1, order).clamp(max=n - 1)]
    one = torch.ones((), dtype=torch.float32, device=vals.device)
    coeff = ds[rows, q] + (2.0 * g) * dq2[rows, q]
    coeff = torch.where(g == mmax[rows, q], coeff + (dmax / torch.fmax(cntmax, one))[rows, q], coeff)
    coeff = torch.where(g == mmin[rows, q], coeff + (dmin / torch.fmax(cntmin, one))[rows, q], coeff)
    acc = torch.zeros(b, n, cv, dtype=torch.float32, device=vals.device)
    last = coeff.shape[1] - 1
    for d in range(int(counts.max()) if n * k else 0):
        term = coeff[rows, (starts + d).clamp(max=last)]
        acc = acc + torch.where((d < counts)[..., None], term, 0.0)
    return acc


def edge_reduce_fwd_kernel(vals: torch.Tensor, idx: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The forward reduce on the card: vals [B, N, Cv] f32, idx [B, N, k]
    int32 in [0, N) -> (mmax, mmin, s, q2, cntmax, cntmin), each [B, N, Cv]
    f32.  Launches the kernel at ``fwd_lanes`` lanes a query (counted in
    ``edge_reduce_fwd_kernel.launches``) or raises."""
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
            vals.data_ptr(), idx.data_ptr(), b, n, k, cv, fwd_lanes(cv), *(o.data_ptr() for o in outs),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, fn)
    edge_reduce_fwd_kernel.launches += 1
    return outs


def edge_reduce_bwd_kernel(vals, idx, mmax, mmin, cntmax, cntmin, dmax, dmin, ds, dq2) -> torch.Tensor:
    """The backward of the forward reduce in ``vals``, on the card: the
    forward's inputs and outputs and the cotangents of mmax, mmin, s and q2
    ([B, N, Cv] f32) -> dvals [B, N, Cv] f32, bit for bit
    ``edge_reduce_bwd_ordered``.  Launches the kernel (counted in
    ``edge_reduce_bwd_kernel.launches``; clouds of more than 9685 points
    take the per-edge route, also counted in ``.routed_launches``) or
    raises."""
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
    width = bwd_slice_width(n, cv)
    lib = _build.library()
    offsets, perm, counts = sort_buffers(lib, b, n, n * k, vals.device)
    with torch.cuda.device(vals.device):
        err = lib.edge_reduce_bwd_launch(
            vals.data_ptr(), idx.data_ptr(), mmax.data_ptr(), mmin.data_ptr(), cntmax.data_ptr(),
            cntmin.data_ptr(), dmax.data_ptr(), dmin.data_ptr(), ds.data_ptr(), dq2.data_ptr(),
            b, n, k, cv, width, offsets.data_ptr(), perm.data_ptr(), counts.data_ptr(), dvals.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, fn)
    edge_reduce_bwd_kernel.launches += 1
    edge_reduce_bwd_kernel.routed_launches += width == 0
    return dvals


edge_reduce_fwd_kernel.launches = 0
edge_reduce_bwd_kernel.launches = 0
edge_reduce_bwd_kernel.routed_launches = 0  # of them, clouds of more than 9685 points (the per-edge kernel)

_INFO_KERNELS = {"bwd": 0, "bwd_edge": 1, "fwd": 2}


def kernel_info(kernel: str, width: int, n: int = 1024, lanes: int = 32) -> dict:
    """Registers, local bytes a thread, dynamic shared bytes a block and
    resident blocks per SM of a build of ``csrc/edge.cu``: ``kernel`` "bwd"
    (the staged backward at slice width ``width`` for clouds of ``n``
    points), "bwd_edge" (its per-edge route) or "fwd" (the forward at
    ``lanes`` lanes a query, 16 or 32), the last two at ``width`` floats a
    lane (1, 2 or 4)."""
    code = _INFO_KERNELS[kernel]
    if kernel == "fwd":
        if lanes not in FWD_LANES:
            raise ValueError(f"edge kernel_info: the forward takes 16 or 32 lanes a query, got {lanes}")
        code += lanes == 16
    info = (ctypes.c_int * 4)()
    err = _build.library().edge_info(code, width, n, ctypes.addressof(info))
    _build.check(err, "edge kernel_info")
    return dict(zip(("registers", "local_bytes", "smem_bytes", "blocks_per_sm"), info))


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
    if takes_plain(vals):
        return edge_reduce_plain(feats, vals, k)
    idx = knn_graph_kernel(feats.detach().float().contiguous(), k)
    outs = _EdgeReduce.apply(vals.float().contiguous(), idx)
    return {**dict(zip(REDUCTIONS, outs)), "idx": idx}


def edge_gather_knn_plain(feats: torch.Tensor, vals: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch ``edge_gather_knn``: ``knn_graph_plain`` and an indexing
    gather of ``vals`` cast to f32, the rows cast back (exact copies), so
    the backward sums each point's row cotangents in f32 and casts once, as
    the kernel's scatter-add does."""
    idx = knn_graph_plain(feats.detach().float(), k)
    return _gather_plain(vals.float(), idx).to(vals.dtype), idx


def _graph_gather_kernel(feats: torch.Tensor, vals: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused graph and gather on the card: feats [B, N, C] f32, vals
    [B, N, Cv] in ``FUSED_DTYPES``, both contiguous, k <= ``FUSED_MAX_K`` ->
    (rows [B, N, k, Cv] in ``vals.dtype``, idx [B, N, k] int32).  Launches
    the kernel (counted in ``edge_gather_knn.fused_launches``) or raises."""
    fn = "edge_gather_knn"
    b, n, c = feats.shape
    cv = vals.shape[-1]
    _check_cuda(fn, "feats", feats, torch.float32, (b, n, c), feats.device)
    _check_cuda(fn, "vals", vals, vals.dtype, (b, n, cv), feats.device)
    if vals.dtype not in FUSED_DTYPES or not 1 <= k <= FUSED_MAX_K or min(b, n, c, cv) < 1:
        raise ValueError(f"{fn}: the fused kernel takes {FUSED_DTYPES} vals and 1 <= k <= {FUSED_MAX_K}, "
                         f"got {vals.dtype} {tuple(vals.shape)}, k={k}")
    idx = torch.empty(b, n, k, dtype=torch.int32, device=feats.device)
    norms = torch.empty(b, n, dtype=torch.float32, device=feats.device)
    out = torch.empty(b, n, k, cv, dtype=vals.dtype, device=feats.device)
    lib = _build.library()
    with torch.cuda.device(feats.device):
        err = lib.knn_graph_launch(
            feats.data_ptr(), b, n, c, k, 0, 1, idx.data_ptr(), norms.data_ptr(), None, vals.data_ptr(),
            out.data_ptr(), cv, vals.element_size(), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, fn)
    edge_gather_knn.fused_launches += 1
    return out, idx


class _GraphGather(torch.autograd.Function):
    """The fused graph and gather: the rows forward, the scatter-add of
    their cotangent over ``idx`` backward (as ``gather_neighbors``)."""

    @staticmethod
    def forward(ctx, feats: torch.Tensor, vals: torch.Tensor, k: int):
        out, idx = _graph_gather_kernel(feats, vals, k)
        ctx.save_for_backward(idx)
        ctx.dtype = vals.dtype
        ctx.mark_non_differentiable(idx)
        return out, idx

    @staticmethod
    def backward(ctx, dout: torch.Tensor, _didx):
        (idx,) = ctx.saved_tensors
        b, n, k = idx.shape
        upd = dout.reshape(b, n * k, dout.shape[-1]).float().contiguous()
        return None, scatter_add_rows(idx.reshape(b, n * k), upd, n).to(ctx.dtype), None


def edge_gather_knn(feats: torch.Tensor, vals: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Self-kNN graph of ``feats`` and the neighbours' rows of ``vals``
    (module doc): (gathered [B, N, k, Cv] in ``vals.dtype``, idx [B, N, k]).

    A CPU tensor takes ``edge_gather_knn_plain``; a CUDA tensor launches,
    at k <= ``FUSED_MAX_K``, the fused graph and gather kernel (``vals`` in
    f32 or bf16 as they are, any other dtype through f32), above it the graph
    kernel and the gather kernel; every call is counted in
    ``edge_gather_knn.launches``, the fused ones also in ``.fused_launches``,
    the others in ``.routed_launches``.  Raises where a kernel fails."""
    if takes_plain(vals):
        return edge_gather_knn_plain(feats, vals, k)
    points = feats.detach().float().contiguous()
    if k <= FUSED_MAX_K:
        rows = vals.contiguous() if vals.dtype in FUSED_DTYPES else vals.float().contiguous()
        out, idx = _GraphGather.apply(points, rows, k)
        out = out.to(vals.dtype)
    else:
        idx = knn_graph_kernel(points, k)
        out = gather_neighbors(vals.float().contiguous(), idx).to(vals.dtype)
        edge_gather_knn.routed_launches += 1
    edge_gather_knn.launches += 1
    return out, idx


edge_gather_knn.launches = 0
edge_gather_knn.fused_launches = 0  # of them, k <= FUSED_MAX_K: the one fused kernel
edge_gather_knn.routed_launches = 0  # of them, k > FUSED_MAX_K: the general kNN, then the gather kernel
