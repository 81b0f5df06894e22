"""Spatially bucketed fused eval-time SA layer: ball select over windows of
points sorted by key + gather + folded-BN MLP + max-pool, as a CUDA kernel
(``csrc/sabucket.cu``) beside its plain PyTorch version, and the dispatch
rule that sends a layer to it.

Replaces ``scanobjectnn_tpu/ops/pallas/sabucket_kernel.py``:
``sa_ball_mlp_pool_bucketed`` -> ``_bucketed_pallas`` (``pl.pallas_call``),
with and without point features (prelifted too), f32 and bf16, K <= 64.

Contract (the JAX function's): the pooled output of the fused layer
(``safused_kernel.sa_ball_mlp_pool``, #3) bit for bit, and no ``idx``
(``(pooled, None)``).  The wrapper's prep is JAX's:
  * the sort key is each cloud's coordinate along its widest axis (the
    largest max - min; a tie goes to the first axis);
  * ``rank_sort_points`` (#5) sorts the points and the queries by key;
  * tile ``j`` holds sorted queries ``[j·T, (j+1)·T)``; with ``lo``/``hi``
    its first/last query key -/+ ``pad_r = r·(1 + 1e-5) + 1e-6`` (absorbing
    the rounding between d2 and the key bound), ``start``/``end`` the
    numbers of sorted point keys ``< lo`` / ``<= hi``, its window is the
    sorted points ``[c0·G, c0·G + W)`` with ``c0 = clip(start // G, 0,
    N/G - W/G)``, and it overflows when ``end > c0·G + W``.
JAX tests the overflow once for the batch (``lax.cond``) and runs the full
kernel if any tile overflows; here each tile that overflows scans the whole
cloud, inside the kernel, so no flag comes back to the host.  A tile whose
``lo`` or ``hi`` is NaN (a NaN query key) counts as overflowing, where JAX
would count no point up to it.  The result is the same by the contract: a
tile that fits holds every hit of its queries, and its selection is the
ball scan of #3 (the first K hits in point order, padded with the first
hit, original point 0 where there is none).  The kernel writes each tile's
flag into ``sa_ball_mlp_pool_bucketed.last_overflow`` ([B, M/T] int32 on the
card), which a caller reads back outside any timed region.

JAX re-ranks hits by original index with a matmul when a row has more than
K, and un-permutes the pooled rows with a one-hot gather (#6).  Here the
window is put back in original point order before the scan, and each pooled
row is written at its query's original index.

The setting: ``"auto"`` looks the layer's (N, M) up in ``AUTO_BUCKET`` (JAX's
per-shape table), ``"off"`` never buckets; ``(W, T, G)`` tuples are for
tests.  ``bucket_eligible`` is JAX's rule.

What bounds it on the H100: the MLP's FLOPs on the CUDA cores, as #3; the
window shortens only the ball scan, and the two sorts add their time.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from scanobjectnn_torch.ops.cuda import _build, takes_plain
from scanobjectnn_torch.ops.cuda.ballgroup_kernel import ball_query_plain
from scanobjectnn_torch.ops.cuda.gather_kernel import _check_cuda
from scanobjectnn_torch.ops.cuda.ranksort_kernel import rank_sort_points, rank_sort_points_plain
from scanobjectnn_torch.ops.cuda.safused_kernel import (
    IDX_MAX_NSAMPLE, check_layer_count, layer_table, mlp_pool_plain, prepare,
)

__all__ = [
    "AUTO_BUCKET",
    "SA_BUCKET_SETTINGS",
    "bucket_eligible",
    "bucket_gate_plain",
    "resolve_bucket_config",
    "sa_ball_mlp_pool_bucketed",
    "sa_ball_mlp_pool_bucketed_plain",
]

# (N, M) -> (window W, query tile T, block granularity G) under "auto": JAX's
# table (its TPU measurements chose it; kept so the same layers take the path).
AUTO_BUCKET = {(2048, 512): (896, 64, 128)}
SA_BUCKET_SETTINGS = ("auto", "off")


def resolve_bucket_config(cfg, n: int, m: int):
    """"auto" -> the table's (W, T, G) for (n, m), or None; "off" and None ->
    None; a (W, T, G) tuple passes through."""
    if cfg == "auto":
        return AUTO_BUCKET.get((n, m))
    if cfg in ("off", None):
        return None
    return tuple(cfg)


def bucket_eligible(cfg, n: int, m: int, nsample: int, has_src: bool, use_xyz: bool, need_idx: bool) -> bool:
    """JAX's static rule for the bucketed path: a resolved (W, T, G), a
    use_xyz layer that needs no idx, K <= 64, and a window that divides:
    ``W % 128 == 0``, ``W % G == 0``, ``N % G == 0``, ``N >= W + G`` (no
    window gain below) and ``M % T == 0``.  ``has_src`` does not matter."""
    del has_src
    cfg = resolve_bucket_config(cfg, n, m)
    if cfg is None or not use_xyz or need_idx:
        return False
    w, t, g = cfg
    return nsample <= 64 and w % 128 == 0 and w % g == 0 and n % g == 0 and n >= w + g and m % t == 0


def _pad_r(radius: float) -> float:
    return radius * (1.0 + 1e-5) + 1e-6


def sort_keys(xyz: torch.Tensor, new_xyz: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(axis [B] int64, key [B, N], qkey [B, M]): each cloud's widest axis
    and the points' and queries' coordinates along it."""
    axis = (xyz.amax(1) - xyz.amin(1)).argmax(-1)
    key = torch.gather(xyz, 2, axis[:, None, None].expand(-1, xyz.shape[1], 1))[..., 0]
    qkey = torch.gather(new_xyz, 2, axis[:, None, None].expand(-1, new_xyz.shape[1], 1))[..., 0]
    return axis, key.contiguous(), qkey.contiguous()


def bucket_gate_plain(
    radius: float, xyz_s: torch.Tensor, q_s: torch.Tensor, axis: torch.Tensor, window: int, qtile: int, gblk: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-tile gate (module doc) on sorted points and queries: (c0
    [B, M/T] int64 in G units, overflow [B, M/T] bool)."""
    b, n, _ = xyz_s.shape
    m = q_s.shape[1]
    pick = axis[:, None, None]
    key_s = torch.gather(xyz_s, 2, pick.expand(-1, n, 1))[..., 0]
    qk = torch.gather(q_s, 2, pick.expand(-1, m, 1))[..., 0].reshape(b, m // qtile, qtile)
    pad = torch.tensor(_pad_r(radius), dtype=torch.float32)
    lo, hi = qk[..., 0] - pad, qk[..., -1] + pad
    start = (key_s[:, None, :] < lo[..., None]).sum(-1)
    end = (key_s[:, None, :] <= hi[..., None]).sum(-1)
    c0 = torch.clamp(start // gblk, 0, n // gblk - window // gblk)
    return c0, (end > c0 * gblk + window) | torch.isnan(lo) | torch.isnan(hi)


def _bucketed_idx_plain(radius, nsample, xyz, new_xyz, window, qtile, gblk):
    """The bucketed selection in plain PyTorch: (idx int64 [B, M, K] in
    original query order, overflow [B, M/T] bool)."""
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    axis, key, qkey = sort_keys(xyz, new_xyz)
    xyz_s, ids, _, _ = rank_sort_points_plain(key, xyz)
    q_s, qids, _, _ = rank_sort_points_plain(qkey, new_xyz)
    c0, ov = bucket_gate_plain(radius, xyz_s, q_s, axis, window, qtile, gblk)
    mt = m // qtile
    # Each tile's window, put back in original point order.
    slots = c0[..., None] * gblk + torch.arange(window, device=xyz.device)  # [B, MT, W]
    win = torch.sort(torch.gather(ids.long(), 1, slots.reshape(b, -1)).reshape(b, mt, window), dim=-1).values
    wxyz = torch.gather(xyz, 1, win.reshape(b, -1, 1).expand(-1, -1, 3)).reshape(b * mt, window, 3)
    qorig = qids.long()  # [B, M]: sorted position -> original query
    qxyz = torch.gather(new_xyz, 1, qorig[..., None].expand(-1, -1, 3)).reshape(b * mt, qtile, 3)
    pos, cnt = ball_query_plain(radius, nsample, wxyz, qxyz)  # window positions [B*MT, T, K]
    sel = torch.gather(win.reshape(b * mt, 1, window).expand(-1, qtile, -1), 2, pos)
    sel = torch.where(cnt[..., None] > 0, sel, 0).reshape(b, m, nsample)  # no hit: original point 0
    idx = torch.empty_like(sel).scatter_(1, qorig[..., None].expand(-1, -1, nsample), sel)
    if bool(ov.any()):
        full, _ = ball_query_plain(radius, nsample, xyz, new_xyz)
        ov_q = torch.empty_like(qorig).scatter_(1, qorig, ov.repeat_interleave(qtile, dim=1).long())
        idx = torch.where(ov_q[..., None].bool(), full, idx)
    return idx, ov


def _bucketed_plain(radius, nsample, xyz, new_xyz, src_feats, weights, biases, use_xyz, xyz_first, dtype,
                    window, qtile, gblk) -> tuple[torch.Tensor, torch.Tensor]:
    """(pooled, overflow [B, M/T] bool) in plain PyTorch: the rows and the
    MLP are ``sa_ball_mlp_pool_plain``'s, over the bucketed selection."""
    p = prepare(src_feats, weights, biases, use_xyz, xyz_first, dtype)
    idx, ov = _bucketed_idx_plain(radius, nsample, xyz.float(), new_xyz.float(), window, qtile, gblk)
    rows = torch.arange(xyz.shape[0], device=xyz.device)[:, None, None]
    c3 = xyz.float()[rows, idx] - new_xyz.float()[:, :, None, :]
    g = None if p.src is None else p.src[rows, idx]
    return mlp_pool_plain(p, c3, g), ov


def sa_ball_mlp_pool_bucketed_plain(
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
    *,
    window: int,
    qtile: int,
    gblk: int,
) -> tuple[torch.Tensor, None]:
    """Plain PyTorch version (module doc): (pooled [B, M, Cout] in the
    compute dtype, None)."""
    pooled, _ = _bucketed_plain(
        radius, nsample, xyz, new_xyz, src_feats, weights, biases, use_xyz, xyz_first, dtype, window, qtile, gblk
    )
    return pooled, None


def _check_window(fn: str, n: int, m: int, nsample: int, window: int, qtile: int, gblk: int) -> None:
    if not 1 <= nsample <= IDX_MAX_NSAMPLE:
        raise ValueError(f"{fn}: the bucketed layer takes 1 <= K <= {IDX_MAX_NSAMPLE}, got {nsample}")
    if min(window, qtile, gblk) < 1 or window % gblk or n % gblk or window > n or m % qtile:
        raise ValueError(
            f"{fn}: (W, T, G) = ({window}, {qtile}, {gblk}) needs W % G == 0, N % G == 0, W <= N and "
            f"M % T == 0 (N={n}, M={m})"
        )


def sa_ball_mlp_pool_bucketed(
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
    *,
    window: int,
    qtile: int,
    gblk: int,
) -> tuple[torch.Tensor, None]:
    """Bucketed fused SA layer (module doc): arguments as
    ``sa_ball_mlp_pool`` plus the window (W, T, G); returns (pooled, None).

    A CPU tensor takes ``sa_ball_mlp_pool_bucketed_plain``; a CUDA tensor
    launches #5 twice and the kernel once (counted in
    ``sa_ball_mlp_pool_bucketed.launches``) or raises.  For inference: the
    output carries no gradient."""
    if takes_plain(xyz):
        pooled, ov = _bucketed_plain(
            radius, nsample, xyz, new_xyz, src_feats, weights, biases, use_xyz, xyz_first, dtype,
            window, qtile, gblk,
        )
        sa_ball_mlp_pool_bucketed.last_overflow = ov.int()
        return pooled, None
    fn = "sa_ball_mlp_pool_bucketed"
    if xyz.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {xyz.device}")
    dev = xyz.device
    b, n = xyz.shape[0], xyz.shape[1]
    m = new_xyz.shape[1]
    _check_cuda(fn, "xyz", xyz, torch.float32, (b, n, 3), dev)
    _check_cuda(fn, "new_xyz", new_xyz, torch.float32, (b, m, 3), dev)
    _check_window(fn, n, m, nsample, window, qtile, gblk)
    check_layer_count(fn, weights, biases)
    p = prepare(src_feats, weights, biases, use_xyz, xyz_first, dtype)
    cs = 0 if p.src is None else p.src.shape[-1]
    if p.src is not None:
        _check_cuda(fn, "src_feats", p.src, p.cdtype, (b, n, cs), dev)
    widths, c_widths, c_weights, c_biases = layer_table(fn, p, weights, cs, dev)

    axis, key, qkey = sort_keys(xyz, new_xyz)
    xyz_s, ids, _, _ = rank_sort_points(key, xyz)
    q_s, qids, _, _ = rank_sort_points(qkey, new_xyz)
    axis = axis.to(torch.int32)
    pooled = torch.empty(b, m, widths[-1], dtype=p.cdtype, device=dev)
    overflow = torch.empty(b, m // qtile, dtype=torch.int32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.sabucket_launch(
            xyz.data_ptr(), new_xyz.data_ptr(), None if p.src is None else p.src.data_ptr(),
            xyz_s.data_ptr(), ids.data_ptr(), q_s.data_ptr(), qids.data_ptr(), axis.data_ptr(),
            b, n, m, cs, nsample, radius * radius, window, qtile, gblk, _pad_r(radius),
            None if p.w0x is None else p.w0x.data_ptr(),
            None if p.w0f is None else p.w0f.data_ptr(),
            int(p.prelifted), int(p.cdtype == torch.bfloat16),
            len(widths), ctypes.addressof(c_widths), ctypes.addressof(c_weights),
            ctypes.addressof(c_biases), pooled.data_ptr(), overflow.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, fn)
    sa_ball_mlp_pool_bucketed.launches += 1
    sa_ball_mlp_pool_bucketed.last_overflow = overflow
    return pooled, None


sa_ball_mlp_pool_bucketed.launches = 0
sa_ball_mlp_pool_bucketed.last_overflow = None  # [B, M/T] int32 of the last call
