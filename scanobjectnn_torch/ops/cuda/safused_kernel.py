"""Fused eval-time SA layer: ball select + gather + folded-BN MLP + max-pool,
as a CUDA kernel (``csrc/safused.cu``) beside its plain PyTorch version.

Replaces ``scanobjectnn_tpu/ops/pallas/safused_kernel.py``:
``sa_ball_mlp_pool`` -> ``_sa_ball_mlp_call`` (``pl.pallas_call``), with
and without point features, for every K the JAX function takes: K <= 64,
or K a multiple of 16 (MSG's 128, the chunked path), up to ``MAX_NSAMPLE``.

Semantics (kept from the TPU kernel):
  * ball select is the ball query of ``ballgroup_kernel.py`` (the same
    device function, ``csrc/ballscan.cuh``, and the same plain version):
    the first K hits of ``d2 < r2`` in point order, padded with the first
    hit, point 0 for a row with no hits;
  * per (query, slot) row, layer 0 is ``c3·W0x + feat[idx]·W0f + b0`` where
    ``c3`` are the point's coordinates minus the query's (``xyz_first``
    splits W0 as [xyz(3), feats(C)], otherwise [feats(C), xyz(3)]); then
    relu, the remaining folded layers with relu, and a max over the K slots;
  * bf16 policy: operands are rounded to bf16 before each layer, products
    are summed in f32, the f32 bias is added, then relu; a bf16 source is
    gathered as is, an f32 source exactly (a plain load on the card);
  * the prelift rule: with ``use_xyz`` and a feature width C > feats[0],
    ``feats @ W0f`` is computed per point before the gather (a plain matmul)
    and the kernel gathers the lifted rows.
Outputs: ``pooled [B, M, Cout]`` in the compute dtype and ``idx [B, M, K]``
int32 for K <= 64; at K > 64 ``idx`` is None, as in the JAX function.

What bounds it on the H100: the folded MLP's FLOPs (SA2 at B=128 is about
138 GFLOP) on the CUDA cores, fed from shared memory.  The kernel keeps
each block's rows (queries x K slots, 64 rows) and their activations in
shared memory and folds the last layer into the max-pool so its output
never lands in memory.  Each layer is a register-tiled f32 FMA product: a
thread holds up to 8 rows x 4 output columns of sums, read with 16-byte
shared loads from k-major activations and from W, which is staged in
shared memory slice by slice; every output is the same FMA chain as before
(from 0, k ascending), in f32 and in bf16 (the tensor-core version of the
bf16 MLP holds each call's gate but not the models' logits gate:
``csrc/sapool.cuh``).  K > 64 takes one query a block and runs the same
code over chunks of 64 slots, carrying each column's running max from
chunk to chunk.  ``kernel_info`` reads the kernels' registers, local memory
and blocks per SM.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch

from scanobjectnn_torch.nn.layers import matmul_f32
from scanobjectnn_torch.ops.cuda import _build, takes_plain
from scanobjectnn_torch.ops.cuda.ballgroup_kernel import ball_query_plain
from scanobjectnn_torch.ops.cuda.gather_kernel import _check_cuda

__all__ = ["fusable_nsample", "kernel_info", "sa_ball_mlp_pool", "sa_ball_mlp_pool_plain"]

IDX_MAX_NSAMPLE = 64  # kMaxRows in csrc/sapool.cuh: one chunk, idx returned
MAX_NSAMPLE = 1024  # kMaxK in csrc/sapool.cuh
MAX_LAYERS = 8  # kMaxLayers in csrc/sapool.cuh


def fusable_nsample(k: int) -> bool:
    """The K the fused layer takes, the JAX function's rule: K <= 64, or K a
    multiple of 16 (the chunked path), here up to ``MAX_NSAMPLE``."""
    return 1 <= k <= MAX_NSAMPLE and (k <= IDX_MAX_NSAMPLE or k % 16 == 0)


class _Prepared(NamedTuple):
    """Layer-0 split and casts shared by the kernel and the plain version."""

    src: torch.Tensor | None  # [B, N, Cs] in cdtype (lifted when prelifted)
    w0x: torch.Tensor | None  # [3, C0] xyz rows of W0, or None
    w0f: torch.Tensor | None  # [Cs, C0] feature rows, None when prelifted
    layers: list[tuple[torch.Tensor | None, torch.Tensor]]  # (W cdtype, b f32); W of layer 0 is None
    cdtype: torch.dtype

    @property
    def prelifted(self) -> bool:
        return self.src is not None and self.w0f is None


def prepare(src_feats, weights, biases, use_xyz, xyz_first, dtype, prelift: bool = True) -> _Prepared:
    """The weight split, prelift and casts of the JAX ``sa_ball_mlp_pool``
    (``prelift=False``: those of ``sa_mlp_pool``, which never lifts)."""
    cdtype = torch.bfloat16 if dtype == torch.bfloat16 else torch.float32
    w0 = weights[0]
    w0x = w0f = src = None
    if src_feats is not None and use_xyz:
        w0x = w0[:3] if xyz_first else w0[-3:]
        w0f = w0[3:] if xyz_first else w0[:-3]
        if prelift and src_feats.shape[-1] > w0.shape[1]:  # lift before the gather
            src = matmul_f32(src_feats.to(cdtype), w0f.to(cdtype)).to(cdtype)
            w0f = None
        else:
            src = src_feats.to(cdtype)
    elif src_feats is not None:
        w0f, src = w0, src_feats.to(cdtype)
    else:
        w0x = w0

    def cast(w):
        return None if w is None else w.to(cdtype).contiguous()

    layers = [(None, biases[0].float().contiguous())] + [
        (cast(w), b.float().contiguous()) for w, b in zip(weights[1:], biases[1:])
    ]
    src = None if src is None else src.contiguous()
    return _Prepared(src, cast(w0x), cast(w0f), layers, cdtype)


def sa_ball_mlp_pool_plain(
    radius: float,
    nsample: int,
    xyz: torch.Tensor,
    new_xyz: torch.Tensor,
    src_feats: torch.Tensor | None,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    use_xyz: bool = True,
    xyz_first: bool = True,
    dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Plain PyTorch version of the fused SA layer (module doc):
    returns (pooled [B, M, Cout] in the compute dtype, idx int32 [B, M, K],
    or None at K > 64)."""
    p = prepare(src_feats, weights, biases, use_xyz, xyz_first, dtype)
    idx, _ = ball_query_plain(radius, nsample, xyz, new_xyz)
    rows = torch.arange(xyz.shape[0], device=xyz.device)[:, None, None]
    c3 = xyz.float()[rows, idx] - new_xyz.float()[:, :, None, :]
    g = None if p.src is None else p.src[rows, idx]  # [B, M, K, Cs]
    return mlp_pool_plain(p, c3, g), (idx.to(torch.int32) if nsample <= IDX_MAX_NSAMPLE else None)


def mlp_pool_plain(p: _Prepared, c3: torch.Tensor | None, g: torch.Tensor | None) -> torch.Tensor:
    """The folded MLP and max-pool over the K rows of each query, in plain
    PyTorch: layer 0 from the gathered source rows ``g`` [B, M, K, Cs] (or
    the prelifted terms) and the centred coordinates ``c3`` [B, M, K, 3]
    f32, rounded to the compute dtype; returns pooled [B, M, Cout]."""
    h = None
    if g is not None:
        h = g.float() if p.prelifted else matmul_f32(g, p.w0f)
    if p.w0x is not None:
        hx = matmul_f32(c3.to(p.cdtype), p.w0x)
        h = hx if h is None else h + hx
    h = torch.relu(h + p.layers[0][1])
    for w, b in p.layers[1:]:
        h = torch.relu(matmul_f32(h.to(p.cdtype), w) + b)
    return torch.amax(h, dim=2).to(p.cdtype)


def check_layer_count(fn: str, weights, biases) -> None:
    if not 1 <= len(weights) == len(biases) <= MAX_LAYERS:
        raise ValueError(
            f"{fn}: kernel takes 1 to {MAX_LAYERS} layers with one bias each, "
            f"got {len(weights)} weights and {len(biases)} biases"
        )


def layer_table(fn: str, p: _Prepared, weights, cs: int, device):
    """Check the prepared layers against their widths (the kernel indexes
    every weight by them) and return the C arrays of the layer table:
    (widths list, c_widths, c_weights, c_biases)."""
    widths = [int(w.shape[-1]) for w in weights]
    if p.w0x is not None:
        _check_cuda(fn, "W0 xyz rows", p.w0x, p.cdtype, (3, widths[0]), device)
    if p.w0f is not None:
        _check_cuda(fn, "W0 feature rows", p.w0f, p.cdtype, (cs, widths[0]), device)
    for i, (w, bb) in enumerate(p.layers):
        if i > 0:
            _check_cuda(fn, f"weights[{i}]", w, p.cdtype, (widths[i - 1], widths[i]), device)
        _check_cuda(fn, f"biases[{i}]", bb, torch.float32, (widths[i],), device)
    n = len(widths)
    c_widths = (ctypes.c_int * n)(*widths)
    c_weights = (ctypes.c_void_p * n)(*[None if w is None else w.data_ptr() for w, _ in p.layers])
    c_biases = (ctypes.c_void_p * n)(*[bb.data_ptr() for _, bb in p.layers])
    return widths, c_widths, c_weights, c_biases


def sa_ball_mlp_pool(
    radius: float,
    nsample: int,
    xyz: torch.Tensor,
    new_xyz: torch.Tensor,
    src_feats: torch.Tensor | None,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    use_xyz: bool = True,
    xyz_first: bool = True,
    dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Fused ball select + gather + folded-BN MLP + max-pool.

    xyz: [B, N, 3] f32; new_xyz: [B, M, 3] f32 query centroids; src_feats:
    [B, N, C] or None; weights/biases: folded per-layer Dense params
    (``fold_bn_mlp_params``).  Returns (pooled [B, M, feats[-1]] in
    ``dtype``, idx int32 [B, M, K], or None at K > 64).

    A CPU tensor takes ``sa_ball_mlp_pool_plain``; a CUDA tensor launches
    the kernel (counted in ``sa_ball_mlp_pool.launches``, and at K > 64 in
    ``sa_ball_mlp_pool.chunked_launches`` too) or raises, also
    for a K that ``fusable_nsample`` refuses.  The kernel is for inference:
    its outputs carry no gradient."""
    if takes_plain(xyz):
        return sa_ball_mlp_pool_plain(
            radius, nsample, xyz, new_xyz, src_feats, weights, biases,
            use_xyz, xyz_first, dtype,
        )
    fn = "sa_ball_mlp_pool"
    if xyz.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {xyz.device}")
    if not fusable_nsample(nsample):
        raise ValueError(
            f"{fn}: kernel takes K <= {IDX_MAX_NSAMPLE}, or K a multiple of 16 up to "
            f"{MAX_NSAMPLE}, got {nsample}"
        )
    check_layer_count(fn, weights, biases)
    p = prepare(src_feats, weights, biases, use_xyz, xyz_first, dtype)
    dev = xyz.device
    b, n = xyz.shape[0], xyz.shape[1]
    m = new_xyz.shape[1]
    _check_cuda(fn, "xyz", xyz, torch.float32, (b, n, 3), dev)
    _check_cuda(fn, "new_xyz", new_xyz, torch.float32, (b, m, 3), dev)
    cs = 0 if p.src is None else p.src.shape[-1]
    if p.src is not None:
        _check_cuda(fn, "src_feats", p.src, p.cdtype, (b, n, cs), dev)
    widths, c_widths, c_weights, c_biases = layer_table(fn, p, weights, cs, dev)

    pooled = torch.empty(b, m, widths[-1], dtype=p.cdtype, device=dev)
    idx = None
    if nsample <= IDX_MAX_NSAMPLE:
        idx = torch.empty(b, m, nsample, dtype=torch.int32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.safused_launch(
            xyz.data_ptr(), new_xyz.data_ptr(),
            None if p.src is None else p.src.data_ptr(),
            b, n, m, cs, nsample, radius * radius,
            None if p.w0x is None else p.w0x.data_ptr(),
            None if p.w0f is None else p.w0f.data_ptr(),
            int(p.prelifted), int(p.cdtype == torch.bfloat16),
            len(widths), ctypes.addressof(c_widths), ctypes.addressof(c_weights),
            ctypes.addressof(c_biases), pooled.data_ptr(),
            None if idx is None else idx.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, fn)
    sa_ball_mlp_pool.launches += 1
    if idx is None:
        sa_ball_mlp_pool.chunked_launches += 1
    return pooled, idx


sa_ball_mlp_pool.launches = 0
sa_ball_mlp_pool.chunked_launches = 0  # of them, K > 64 (the chunked path)


def kernel_info(nsample: int, cs: int, widths: Sequence[int], dtype: torch.dtype,
                bucket: tuple[int, int] | None = None) -> dict:
    """The fused SA kernel instantiated for ``dtype`` (#3 and #10, or #4
    with ``bucket`` = (N, window)) at the shared memory of a layer with
    ``nsample`` slots, ``cs`` source channels (the lifted width when
    prelifted) and these widths: registers and local-memory bytes a thread,
    dynamic shared bytes a block, and resident blocks per SM, from
    ``cudaFuncGetAttributes`` and the occupancy API (on the card)."""
    lib = _build.library()
    info = (ctypes.c_int * 4)()
    c_widths = (ctypes.c_int * len(widths))(*widths)
    bf16 = int(dtype == torch.bfloat16)
    if bucket is None:
        err = lib.safused_info(bf16, nsample, cs, len(widths), ctypes.addressof(c_widths), ctypes.addressof(info))
    else:
        err = lib.sabucket_info(bf16, nsample, cs, *bucket, len(widths), ctypes.addressof(c_widths),
                                ctypes.addressof(info))
    _build.check(err, "kernel_info")
    return dict(zip(("registers", "local_bytes", "smem_bytes", "blocks_per_sm"), info))
