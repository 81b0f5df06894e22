"""Fused eval-time SA layer: ball select + gather + folded-BN MLP + max-pool,
as a CUDA kernel (``csrc/safused.cu``) beside its plain PyTorch version.

Replaces ``scanobjectnn_tpu/ops/pallas/safused_kernel.py``:
``sa_ball_mlp_pool`` -> ``_sa_ball_mlp_call`` (``pl.pallas_call``), for
K <= 64, with and without point features.

Semantics (kept from the TPU kernel):
  * ball select scans the N candidates in original order; a point is a hit
    when ``d2 < r2`` with ``d2 = ((qx-x)² + (qy-y)²) + (qz-z)²`` from direct
    differences (no FMA) and ``r2 = radius*radius`` taken in Python double
    and rounded once to f32; the first K hits are kept (the scan stops after
    K); short rows are padded with the first hit, a row with no hits uses
    point 0;
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
int32.

What bounds it on the H100: the folded MLP's FLOPs (SA2 at B=128 is about
138 GFLOP) on CUDA cores, fed from shared memory.  This first kernel keeps
each block's rows (queries x K slots, at most 64) and their activations in
shared memory, reads the weights through L2 (the SA2 weights, ~264 KB in
f32, do not fit in shared memory), gives each thread 8 rows of one output
column so one weight load feeds 8 FMAs, and folds the last layer into the
max-pool so its output never lands in memory.  Tensor cores (wgmma) are
the next step.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch

from scanobjectnn_torch.nn.layers import matmul_f32
from scanobjectnn_torch.ops.cuda import _build

__all__ = ["sa_ball_mlp_pool", "sa_ball_mlp_pool_plain"]

MAX_NSAMPLE = 64
MAX_LAYERS = 8  # kMaxLayers in csrc/safused.cu


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


def _prepare(src_feats, weights, biases, use_xyz, xyz_first, dtype) -> _Prepared:
    """The weight split, prelift and casts of the JAX ``sa_ball_mlp_pool``."""
    cdtype = torch.bfloat16 if dtype == torch.bfloat16 else torch.float32
    w0 = weights[0]
    w0x = w0f = src = None
    if src_feats is not None and use_xyz:
        w0x = w0[:3] if xyz_first else w0[-3:]
        w0f = w0[3:] if xyz_first else w0[:-3]
        if src_feats.shape[-1] > w0.shape[1]:  # prelift: lift before the gather
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


def _ball_select(radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor) -> torch.Tensor:
    """First ``nsample`` hits in point order, padded: int64 [B, M, K]."""
    x, q = xyz.float(), new_xyz.float()
    n = x.shape[1]
    diff = [q[:, :, None, c] - x[:, None, :, c] for c in range(3)]
    d2 = (diff[0] * diff[0] + diff[1] * diff[1]) + diff[2] * diff[2]  # [B, M, N]
    hit = d2 < torch.tensor(radius * radius, dtype=torch.float32)
    key = torch.where(hit, torch.arange(n, device=x.device), n)
    first = torch.topk(key, min(nsample, n), dim=-1, largest=False).values
    if nsample > n:
        first = torch.cat([first, first.new_full((*first.shape[:2], nsample - n), n)], -1)
    pad = torch.where(first[..., :1] < n, first[..., :1], 0)  # first hit, else point 0
    return torch.where(first < n, first, pad)


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
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the fused SA layer (module doc):
    returns (pooled [B, M, Cout] in the compute dtype, idx int32 [B, M, K])."""
    p = _prepare(src_feats, weights, biases, use_xyz, xyz_first, dtype)
    idx = _ball_select(radius, nsample, xyz, new_xyz)
    rows = torch.arange(xyz.shape[0], device=xyz.device)[:, None, None]
    c3 = (xyz.float()[rows, idx] - new_xyz.float()[:, :, None, :]).to(p.cdtype)
    h = None
    if p.src is not None:
        g = p.src[rows, idx]  # [B, M, K, Cs]
        h = g.float() if p.prelifted else matmul_f32(g, p.w0f)
    if p.w0x is not None:
        hx = matmul_f32(c3, p.w0x)
        h = hx if h is None else h + hx
    h = torch.relu(h + p.layers[0][1])
    for w, b in p.layers[1:]:
        h = torch.relu(matmul_f32(h.to(p.cdtype), w) + b)
    return torch.amax(h, dim=2).to(p.cdtype), idx.to(torch.int32)


def _check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(
            f"sa_ball_mlp_pool: {name} must be {dtype} {shape} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"sa_ball_mlp_pool: {name} must be contiguous")


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
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused ball select + gather + folded-BN MLP + max-pool.

    xyz: [B, N, 3] f32; new_xyz: [B, M, 3] f32 query centroids; src_feats:
    [B, N, C] or None; weights/biases: folded per-layer Dense params
    (``fold_bn_mlp_params``).  Returns (pooled [B, M, feats[-1]] in
    ``dtype``, idx int32 [B, M, K]).

    A CPU tensor takes ``sa_ball_mlp_pool_plain``; a CUDA tensor launches
    the kernel (counted in ``sa_ball_mlp_pool.launches``) or raises.  The
    kernel is for inference: its outputs carry no gradient."""
    if xyz.device.type == "cpu":
        return sa_ball_mlp_pool_plain(
            radius, nsample, xyz, new_xyz, src_feats, weights, biases,
            use_xyz, xyz_first, dtype,
        )
    if xyz.device.type != "cuda":
        raise ValueError(f"sa_ball_mlp_pool: unsupported device {xyz.device}")
    if not 1 <= nsample <= MAX_NSAMPLE:
        raise ValueError(f"sa_ball_mlp_pool: kernel takes 1 <= K <= {MAX_NSAMPLE}, got {nsample}")
    if not 1 <= len(weights) == len(biases) <= MAX_LAYERS:
        raise ValueError(
            f"sa_ball_mlp_pool: kernel takes 1 to {MAX_LAYERS} layers with one bias each, "
            f"got {len(weights)} weights and {len(biases)} biases"
        )
    p = _prepare(src_feats, weights, biases, use_xyz, xyz_first, dtype)
    dev = xyz.device
    b, n = xyz.shape[0], xyz.shape[1]
    m = new_xyz.shape[1]
    _check_cuda("xyz", xyz, torch.float32, (b, n, 3), dev)
    _check_cuda("new_xyz", new_xyz, torch.float32, (b, m, 3), dev)
    cs = 0 if p.src is None else p.src.shape[-1]
    if p.src is not None:
        _check_cuda("src_feats", p.src, p.cdtype, (b, n, cs), dev)
    widths = [int(w.shape[-1]) for w in weights]
    # The kernel indexes every weight by these widths: check each shape.
    if p.w0x is not None:
        _check_cuda("W0 xyz rows", p.w0x, p.cdtype, (3, widths[0]), dev)
    if p.w0f is not None:
        _check_cuda("W0 feature rows", p.w0f, p.cdtype, (cs, widths[0]), dev)
    for i, (w, bb) in enumerate(p.layers):
        if i > 0:
            _check_cuda(f"weights[{i}]", w, p.cdtype, (widths[i - 1], widths[i]), dev)
        _check_cuda(f"biases[{i}]", bb, torch.float32, (widths[i],), dev)

    pooled = torch.empty(b, m, widths[-1], dtype=p.cdtype, device=dev)
    idx = torch.empty(b, m, nsample, dtype=torch.int32, device=dev)
    n_layers = len(widths)
    c_widths = (ctypes.c_int * n_layers)(*widths)
    c_weights = (ctypes.c_void_p * n_layers)(
        *[None if w is None else w.data_ptr() for w, _ in p.layers]
    )
    c_biases = (ctypes.c_void_p * n_layers)(*[bb.data_ptr() for _, bb in p.layers])
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.safused_launch(
            xyz.data_ptr(), new_xyz.data_ptr(),
            None if p.src is None else p.src.data_ptr(),
            b, n, m, cs, nsample, radius * radius,
            None if p.w0x is None else p.w0x.data_ptr(),
            None if p.w0f is None else p.w0f.data_ptr(),
            int(p.prelifted), int(p.cdtype == torch.bfloat16),
            n_layers, ctypes.addressof(c_widths), ctypes.addressof(c_weights),
            ctypes.addressof(c_biases), pooled.data_ptr(), idx.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "sa_ball_mlp_pool")
    sa_ball_mlp_pool.launches += 1
    return pooled, idx


sa_ball_mlp_pool.launches = 0
