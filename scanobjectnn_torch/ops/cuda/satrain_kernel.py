"""Backward of the fused SA training tail: the CUDA kernel
(``csrc/satrain_bwd.cu``) beside its plain PyTorch version, and the forward
chain both recompute.

Replaces ``scanobjectnn_tpu/ops/pallas/satrain_bwd.py``: ``bwd_pallas``
(``pl.pallas_call`` per pass), the VJP of ``satrain_kernel.
grouped_bn_mlp_pool``; the plain version ports its oracle ``_bwd_xla``.

The tail is BN0 -> relu -> (Dense_i -> BN_i -> relu)* -> max over the
neighbour axis (-2) of z1 [B, M, K, C0], the layer-0 pre-activations, in
the compute dtype.  ``fwd_chain`` is JAX's ``_fwd_chain``: matmul operands
and each layer's h and y rounded to the compute dtype, f32 sums, BN in f32
with eps 1e-3, biased batch variance ``max(E[h²] - E[h]², 0)`` (or the
given statistics); pool mode "1" keeps the last layer's h and y in f32.

The backward, with R = B·M·K rows, u_i = zhat_i·gamma_i + beta_i and
du_i = dy_i·(u_i > 0):

    dy_{L-1} = (y == pooled) / cnt · d_pooled     (ties split evenly)
    S1_i = Σ du_i = dbeta_i,  S2_i = Σ du_i·zhat_i = dgamma_i
    dz_i = r_i·gamma_i·((du_i - S1_i/R) - zhat_i·S2_i/R)
    dW_i = y_{i-1}ᵀ dz_i,  db_i = Σ dz_i,  dy_{i-1} = dz_i W_iᵀ   (f32)

and dz1 = dz_0 rounded to the compute dtype.  db_i is the true sum: 0 up to
rounding, since it feeds a training BN.

Under a process ``group`` (the BatchNorms', ``nn.layers.configure_parallel``)
the chain is the global batch's: ``fwd_chain`` averages each layer's E[h]
and E[h²] over the group before its variance, and the backward sums each
layer's S1_i, S2_i over the group for dz_i, over R times the world size;
dgamma_i and dbeta_i stay this rank's sums, as dW_i and db_i do (the
``Trainer`` averages every gradient over the ranks).  The kernel then runs
its passes one call each and, between them, rewrites the layer's S1/R and
S2/R in its constants table from the group's sums; a group of one rank
gives the no-group bits.

``grouped_bn_mlp_pool_bwd`` on a CUDA tensor launches the kernel: a pass
per layer's sums and a final pass for dz1, each recomputing the chain from
z1 (register-tiled f32 FMA products, W staged in shared memory), plus a
pool pass for the kernel's own winners only where a chunk cannot hold whole
groups; block sums reduced in a fixed order (no float atomics).  ``plan``
lays the launch out (chunk rows, the pool in the pass or not, blocks a
pass, the dW's place and slices, scratch) and the kernel refuses a plan it
cannot run.  The result is not bit-equal to the plain version: its
products sum in another order than cuBLAS's, so a relu gate or a pool
winner within f32 rounding of a tie may flip; two calls give the same bits.
Scratch: the block sums at most ``PARTIAL_BYTES`` (64 MiB), which bounds a
pass's blocks, plus ``[groups, C_{L-1}]`` twice and the constants table.

What bounds it on the H100: operations (each pass recomputes the forward
chain on the CUDA cores in f32).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from scanobjectnn_torch.ops.cuda import _build, takes_plain
from scanobjectnn_torch.parallel.mesh import sum_parts

__all__ = [
    "EPS",
    "PARTIAL_BYTES",
    "Plan",
    "fwd_chain",
    "grouped_bn_mlp_pool_bwd",
    "grouped_bn_mlp_pool_bwd_plain",
    "kernel_info",
    "plan",
    "sm_count",
]

EPS = 1e-3
PARTIAL_BYTES = 64 * 1024 * 1024
MAX_LAYERS, MAX_WIDTH = 4, 1024  # kMaxLayers, kMaxWidth in csrc/satrain_bwd.cu
# The kernel's layout constants (csrc/satrain_bwd.cu) and Hopper's shared
# memory: at most 227 KB a block, 228 KB an SM, 1 KB of it reserved a block.
_ROWS = (64, 32, 16, 8, 4)  # chunk rows it is built for
_SLICE, _CONSTS, _DW_SIDE = 2048, 7, 64  # kSlice, kConsts, kDwSide
_SMEM_MAX, _SM_SMEM, _BLOCK_RESERVED = 227 * 1024, 228 * 1024, 1024


@dataclass(frozen=True)
class PassPlan:
    """One walk pass: the layer whose S1, S2 it sums (-1: dz1), its row
    blocks (``blocks_x``, each ``chunks_per_block`` chunks), the dW's tile
    slices (blockIdx.y), whether the dW sums in shared memory, a block's
    partial floats and its dynamic shared bytes."""

    target: int
    blocks_x: int
    chunks_per_block: int
    slices: int
    dw_smem: bool
    stride: int
    smem_bytes: int

    @property
    def blocks(self) -> int:
        return self.blocks_x * self.slices


@dataclass(frozen=True)
class Plan:
    """A launch of the kernel (``plan``): chunk rows of the tile (``rows``)
    and of a chunk's data (``chunk_rows``: whole groups when the pool is in
    the pass), the pool pass's segments a group, rows a segment and blocks
    (when it runs), where the constants live, the blocks an SM every
    launch is built for (the kernel checks it), the walk passes, and the
    partial buffer's floats."""

    rows: int
    chunk_rows: int
    pool_in_pass: bool
    pool_segs: int
    pool_seg_rows: int
    pool_blocks: int
    consts_smem: bool
    blocks_per_sm: int
    passes: tuple
    partial_floats: int

    @property
    def scratch_bytes(self) -> int:
        """The block sums' scratch (held to ``PARTIAL_BYTES``)."""
        return 4 * self.partial_floats

    def ints(self) -> list:
        """The plan as ``satrain_bwd_launch`` reads it."""
        head = [self.rows, self.chunk_rows, int(self.pool_in_pass), self.pool_segs, self.pool_seg_rows,
                self.pool_blocks, int(self.consts_smem), self.blocks_per_sm]
        return head + [v for p in self.passes for v in (p.blocks_x, p.chunks_per_block, p.slices, int(p.dw_smem))]


def _smem_bytes(rows: int, widths: Sequence[int], dw_floats: int, consts_smem: bool) -> int:
    """csrc/satrain_bwd.cu's smem_floats, in bytes: the W ring (ring_stages:
    two slices at 32 and 64 rows, four below), h_i (i >= 1; h_0 when L ==
    1), the even and odd layers' buffers, the dW, the constants."""
    stages = 2 if rows >= 32 else 4
    n = len(widths)
    hsum = widths[0] if n == 1 else sum(widths[1:])
    b0 = max([widths[i] for i in range(0, n - 1, 2)], default=0)
    b1 = max([widths[i] for i in range(1, n - 1, 2)], default=0)
    floats = stages * _SLICE + (rows + 4) * (hsum + b0 + b1) + dw_floats + (_CONSTS * sum(widths) if consts_smem else 0)
    return 4 * floats


def _blocks_per_sm(rows: int, smem: int) -> int:
    """Blocks an SM holds at ``smem`` bytes: the kernels are built for two
    at 32 and 64 rows a chunk where two fit (min_blocks, which the kernel
    holds the plan to), else for one."""
    return 2 if rows >= 32 and 2 * (smem + _BLOCK_RESERVED) <= _SM_SMEM else 1


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """The SMs of the card ``device`` names (``plan``'s ``sms``), read once
    a device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def plan(groups: int, k: int, widths: Sequence[int], sms: int) -> Plan:
    """The launch of the kernel on ``groups`` groups of ``k`` rows through
    layers of these widths, on a card of ``sms`` SMs.

    Chunk rows (64, 32, 16, 8, 4) and the constants' place: the most blocks
    an SM, then the most rows, then the constants in shared memory, that fit
    (two blocks at 32 rows beat one at 64 with the pool in the pass at SSG's
    SA2 on an H100, 6.27 ms against 6.74).  The pool is in the pass where a
    chunk holds whole groups (K <= rows, their maxima in half the W ring);
    else the pool pass splits each group into segments of whole chunks when
    there are too few groups to fill the card.  A pass that sums dW_{t+1}
    takes the fewest dW slices (blockIdx.y) with which the partial buffer
    holds a slice for a wave of blocks (or one tile a slice); its dW sums in
    shared memory where that keeps the blocks an SM.  Every pass takes the
    chunks a block that need the fewest waves times chunks, then fill the
    card's SMs, then the most chunks."""
    return _plan(groups, k, tuple(int(w) for w in widths), sms)


@functools.lru_cache(maxsize=256)
def _plan(groups, k, widths, sms, rows=None, pool_in_pass=None, consts_smem=None) -> Plan:
    """``plan``; ``rows``, ``pool_in_pass`` and ``consts_smem`` force a
    choice (the tests and ``studies/satrain_fma.py`` launch such plans by
    patching ``plan``)."""
    n = len(widths)
    partial_cap = PARTIAL_BYTES // 4
    fits = [(_blocks_per_sm(r, smem), r, c) for r in _ROWS for c in (True, False)
            for smem in [_smem_bytes(r, widths, 0, c)]
            if smem <= _SMEM_MAX and r == (rows or r) and c == (c if consts_smem is None else consts_smem)]
    if not fits:
        raise ValueError(f"satrain plan: widths {list(widths)} fit no chunk in shared memory")
    _, rows, consts_smem = max(fits)
    # The pool in the pass: whole groups a chunk, their (max, share) in half the ring.
    in_pass = k <= rows and rows // k * widths[-1] <= _SLICE // 2 and pool_in_pass is not False
    chunk_rows = rows // k * k if in_pass else rows
    chunks = _ceil(groups * k, chunk_rows)
    base = _smem_bytes(rows, widths, 0, consts_smem)
    per_sm = _blocks_per_sm(rows, base)
    wave = sms * per_sm
    segs = seg_rows = pool_blocks = partial = 0
    if not in_pass:
        group_chunks = _ceil(k, rows)
        segs = min(group_chunks, max(1, _ceil(8 * sms, groups)))
        if groups * segs * 2 * widths[-1] > partial_cap:
            segs = 1
        seg_rows = _ceil(group_chunks, segs) * rows
        segs = _ceil(k, seg_rows)
        pool_blocks = min(groups * segs, 8 * sms)
        if segs > 1:
            partial = groups * segs * 2 * widths[-1]
    passes = []
    for target in range(n - 1, -2, -1):
        ct = widths[target] if target >= 0 else 0
        with_dw = 0 <= target < n - 1
        ce = widths[target + 1] if with_dw else 0
        tiles = _ceil(ct, _DW_SIDE) * _ceil(ce, _DW_SIDE)
        for want in range(1, max(tiles, 1) + 1):
            tps = _ceil(tiles, want)
            slices = _ceil(tiles, tps) if with_dw else 1
            stride = 2 * ct + tps * _DW_SIDE ** 2 + ce
            cap = min(chunks, partial_cap // (stride * slices)) if stride else chunks
            if not with_dw or cap * slices >= wave:
                break
        if not cap:
            raise ValueError(f"satrain plan: one block's sums ({stride} floats) exceed the scratch")

        def cost(cpb):
            blocks = _ceil(chunks, cpb) * slices
            return _ceil(blocks, wave) * cpb, blocks < sms, -cpb

        cpb = min(range(_ceil(chunks, cap), chunks + 1), key=cost)
        bx = _ceil(chunks, cpb)
        dw_floats = tps * _DW_SIDE ** 2 if with_dw else 0
        with_smem = _smem_bytes(rows, widths, dw_floats, consts_smem)
        smem_dw = with_dw and with_smem <= _SMEM_MAX and _blocks_per_sm(rows, with_smem) == per_sm
        passes.append(PassPlan(target, bx, cpb, slices, smem_dw, stride, with_smem if smem_dw else base))
        partial = max(partial, bx * slices * stride)
    return Plan(rows, chunk_rows, in_pass, segs, seg_rows, pool_blocks, consts_smem, per_sm, tuple(passes),
                max(partial, 1))


def _acc(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the type the chain sums in: f32 (float64 stays float64)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` on the operands' values in the summing type (a bf16 product
    is exact in f32)."""
    return torch.matmul(_acc(a), _acc(b))


def _stats(h: torch.Tensor, group=None) -> tuple[torch.Tensor, torch.Tensor]:
    axes = tuple(range(h.dim() - 1))
    hf = _acc(h)
    mean, mean2 = hf.mean(dim=axes), torch.square(hf).mean(dim=axes)
    if group is not None:
        mean, mean2 = (t / dist.get_world_size(group) for t in sum_parts((mean, mean2), group))
    return mean, torch.clamp(mean2 - torch.square(mean), min=0.0)


def fwd_chain(
    z1: torch.Tensor,
    gammas: Sequence[torch.Tensor],
    betas: Sequence[torch.Tensor],
    ws: Sequence[torch.Tensor],
    bs: Sequence[torch.Tensor],
    pool_mode: str = "0",
    means: Sequence[torch.Tensor] | None = None,
    variances: Sequence[torch.Tensor] | None = None,
    group=None,
):
    """The tail's forward (module doc): (zhats, ys, pooled, means, vars),
    per layer, with the batch statistics (over ``group``) or the given
    ones."""
    cdtype = z1.dtype
    n_layers = len(gammas)
    f32_last = pool_mode == "1"
    zhats, ys, out_means, out_vars = [], [], [], []
    h = z1
    for i in range(n_layers):
        keep_f32 = i == n_layers - 1 and f32_last
        if i > 0:
            h = _mm(ys[-1], ws[i - 1].to(cdtype)) + bs[i - 1]
            if not keep_f32:
                h = h.to(cdtype)
        mean, var = _stats(h, group) if means is None else (means[i], variances[i])
        out_means.append(mean)
        out_vars.append(var)
        zhat = (_acc(h) - mean) * torch.rsqrt(var + EPS)
        y = torch.relu(zhat * gammas[i] + betas[i])
        zhats.append(zhat)
        ys.append(y if keep_f32 else y.to(cdtype))
    return zhats, ys, ys[-1].amax(-2), out_means, out_vars


def grouped_bn_mlp_pool_bwd_plain(
    z1: torch.Tensor,
    gammas: Sequence[torch.Tensor],
    betas: Sequence[torch.Tensor],
    ws: Sequence[torch.Tensor],
    bs: Sequence[torch.Tensor],
    means: Sequence[torch.Tensor],
    variances: Sequence[torch.Tensor],
    d_pooled: torch.Tensor,
    pool_mode: str = "0",
    group=None,
):
    """Plain PyTorch backward (module doc; JAX ``_bwd_xla``): (dz1,
    dgammas, dbetas, dws, dbs), the tuples in layer order; S1, S2 over
    ``group``."""
    n_layers = len(gammas)
    zhats, ys, pooled, _, _ = fwd_chain(z1, gammas, betas, ws, bs, pool_mode, means, variances)
    r_count = float(z1.shape[0] * z1.shape[1] * z1.shape[2])
    if group is not None:
        r_count *= dist.get_world_size(group)
    axes = tuple(range(z1.dim() - 1))
    eq = _acc(ys[-1] == pooled.unsqueeze(-2))
    cnt = eq.sum(-2, keepdim=True)
    dy = eq / cnt * _acc(d_pooled).unsqueeze(-2)
    dgammas, dbetas, dws, dbs = [], [], [], []
    dz = None
    for i in range(n_layers - 1, -1, -1):
        du = dy * (zhats[i] * gammas[i] + betas[i] > 0.0)
        s1 = du.sum(dim=axes)
        s2 = (du * zhats[i]).sum(dim=axes)
        dgammas.append(s2)
        dbetas.append(s1)
        if group is not None:
            s1, s2 = sum_parts((s1, s2), group)
        r = torch.rsqrt(variances[i] + EPS)
        dz = r * gammas[i] * (du - s1 / r_count - zhats[i] * (s2 / r_count))
        if i > 0:
            c_in, c_out = ys[i - 1].shape[-1], dz.shape[-1]
            dws.append(_mm(ys[i - 1].reshape(-1, c_in).t(), dz.reshape(-1, c_out)))
            dbs.append(dz.sum(dim=axes))
            dy = _mm(dz, ws[i - 1].t())
    return (
        dz.to(z1.dtype),
        tuple(reversed(dgammas)),
        tuple(reversed(dbetas)),
        tuple(reversed(dws)),
        tuple(reversed(dbs)),
    )


def _f32(name: str, t: torch.Tensor, shape: tuple, device) -> torch.Tensor:
    if t.device != device or tuple(t.shape) != shape:
        raise ValueError(
            f"grouped_bn_mlp_pool_bwd: {name} must be {shape} on {device}, got {tuple(t.shape)} on {t.device}"
        )
    return t.detach().float().contiguous()


def grouped_bn_mlp_pool_bwd(
    z1: torch.Tensor,
    gammas: Sequence[torch.Tensor],
    betas: Sequence[torch.Tensor],
    ws: Sequence[torch.Tensor],
    bs: Sequence[torch.Tensor],
    means: Sequence[torch.Tensor],
    variances: Sequence[torch.Tensor],
    d_pooled: torch.Tensor,
    pool_mode: str = "0",
    group=None,
):
    """The tail's backward (module doc): (dz1, dgammas, dbetas, dws, dbs);
    S1, S2 over ``group``.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (counted once a call in ``grouped_bn_mlp_pool_bwd.launches``) on
    ``plan``'s layout, or raises."""
    if takes_plain(z1):
        return grouped_bn_mlp_pool_bwd_plain(z1, gammas, betas, ws, bs, means, variances, d_pooled, pool_mode, group)
    fn = "grouped_bn_mlp_pool_bwd"
    if z1.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {z1.device}")
    if z1.dim() != 4 or z1.dtype not in (torch.float32, torch.bfloat16) or not z1.is_contiguous():
        raise ValueError(f"{fn}: z1 must be a contiguous f32 or bf16 [B, M, K, C0], got {z1.dtype} {tuple(z1.shape)}")
    if pool_mode not in ("0", "1"):
        raise ValueError(f"{fn}: pool modes '0' and '1' only, got {pool_mode!r}")
    b, m, k, c0 = z1.shape
    widths = [int(g.shape[0]) for g in gammas]
    n_layers = len(widths)
    if not 1 <= n_layers <= MAX_LAYERS or max(widths) > MAX_WIDTH or widths[0] != c0:
        raise ValueError(f"{fn}: kernel takes 1 to {MAX_LAYERS} layers of at most {MAX_WIDTH} channels "
                         f"starting at C0 = {c0}, got {widths}")
    if not (len(betas) == len(means) == len(variances) == n_layers and len(ws) == len(bs) == n_layers - 1):
        raise ValueError(f"{fn}: {n_layers} layers need as many BN parameters and stats and {n_layers - 1} Dense")
    dev = z1.device
    groups = b * m
    keep = []  # every tensor the launch reads, alive until it is enqueued

    def ptr(t: torch.Tensor) -> int:
        keep.append(t)
        return t.data_ptr()

    dgammas = [torch.empty(c, device=dev) for c in widths]
    dbetas = [torch.empty(c, device=dev) for c in widths]
    dws = [torch.empty(widths[i - 1], widths[i], device=dev) for i in range(1, n_layers)]
    dbs = [torch.empty(widths[i], device=dev) for i in range(1, n_layers)]
    table_ptrs = []
    for i, c in enumerate(widths):
        var = _f32(f"variances[{i}]", variances[i], (c,), dev)
        table_ptrs += [ptr(_f32(f"means[{i}]", means[i], (c,), dev)), ptr(torch.rsqrt(var + EPS)),
                  ptr(_f32(f"gammas[{i}]", gammas[i], (c,), dev)), ptr(_f32(f"betas[{i}]", betas[i], (c,), dev)),
                  ptr(dbetas[i]), ptr(dgammas[i])]
    for i in range(1, n_layers):
        w = _f32(f"ws[{i - 1}]", ws[i - 1], (widths[i - 1], widths[i]), dev)
        table_ptrs += [ptr(w.to(z1.dtype).float().contiguous()), ptr(w.t().contiguous()),
                  ptr(_f32(f"bs[{i - 1}]", bs[i - 1], (widths[i],), dev)), ptr(dws[i - 1]), ptr(dbs[i - 1])]
    dp = _f32("d_pooled", d_pooled, (b, m, widths[-1]), dev)
    layout = plan(groups, k, widths, sm_count(dev))
    if layout.scratch_bytes > PARTIAL_BYTES:
        raise ValueError(f"{fn}: the plan's scratch ({layout.scratch_bytes} bytes) exceeds {PARTIAL_BYTES}")
    partial = torch.empty(layout.partial_floats, device=dev)
    pooled = torch.empty(groups, widths[-1], device=dev)
    share = torch.empty(groups, widths[-1], device=dev)
    table = torch.empty(7 * sum(widths), device=dev)
    dz1 = torch.empty_like(z1)
    c_widths = (ctypes.c_int * n_layers)(*widths)
    c_ptrs = (ctypes.c_void_p * len(table_ptrs))(*table_ptrs)
    ints = layout.ints()
    c_plan = (ctypes.c_int * len(ints))(*ints)
    lib = _build.library()

    def launch(begin: int, end: int) -> None:
        with torch.cuda.device(dev):
            err = lib.satrain_bwd_launch(
                z1.data_ptr(), dp.data_ptr(), groups, k, int(z1.dtype == torch.bfloat16), int(pool_mode == "1"),
                n_layers, ctypes.addressof(c_widths), ctypes.addressof(c_ptrs), ctypes.addressof(c_plan), len(ints),
                pooled.data_ptr(), share.data_ptr(), table.data_ptr(), partial.data_ptr(), layout.partial_floats,
                dz1.data_ptr(), begin, end, torch.cuda.current_stream().cuda_stream,
            )
        _build.check(err, fn)

    if group is None:
        launch(0, n_layers + 1)
    else:
        # A pass a call; after pass j, layer L-1-j's S1/R and S2/R in the
        # table (rows 5 and 6 of [7, sum_c]) are the group's sums over its
        # rows, divided as the kernel divides (module doc).
        rows = table.view(7, sum(widths))
        count = torch.tensor(np.float32(groups * k * dist.get_world_size(group)), device=dev)
        for j in range(n_layers + 1):
            launch(j, j + 1)
            t = n_layers - 1 - j
            if t >= 0:
                s1, s2 = sum_parts((dbetas[t], dgammas[t]), group)
                lo = sum(widths[:t])
                rows[5, lo:lo + widths[t]] = s1 / count
                rows[6, lo:lo + widths[t]] = s2 / count
    grouped_bn_mlp_pool_bwd.launches += 1
    return dz1, tuple(dgammas), tuple(dbetas), tuple(dws), tuple(dbs)


grouped_bn_mlp_pool_bwd.launches = 0


def kernel_info(groups: int, k: int, widths: Sequence[int], walk: bool = True) -> dict:
    """The walk kernel (or the pool kernel) at its plan's chunk rows and the
    shared memory of its largest pass: registers and local-memory bytes a
    thread, dynamic shared bytes a block, resident blocks per SM, from
    ``cudaFuncGetAttributes`` and the occupancy API (on the card)."""
    layout = plan(groups, k, widths, sm_count(torch.cuda.current_device()))
    dw_floats = max((_ceil(_ceil(widths[p.target], _DW_SIDE) * _ceil(widths[p.target + 1], _DW_SIDE), p.slices)
                     * _DW_SIDE ** 2 for p in layout.passes if p.dw_smem), default=0)
    info = (ctypes.c_int * 4)()
    c_widths = (ctypes.c_int * len(widths))(*widths)
    err = _build.library().satrain_info(layout.rows, len(widths), ctypes.addressof(c_widths), dw_floats,
                                        int(layout.consts_smem), int(walk), ctypes.addressof(info))
    _build.check(err, "satrain kernel_info")
    return dict(zip(("registers", "local_bytes", "smem_bytes", "blocks_per_sm"), info))
