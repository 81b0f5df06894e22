"""PointNet++ set abstraction and feature propagation (counterpart of
``scanobjectnn_tpu/nn/pointnet_modules.py``).

Ported: ``_fused_ball_scale``, ``sample_and_group`` (ball or kNN
grouping, with or without xyz), ``sample_and_group_all``, ``SAModule``
(max pooling: the fused eval branches, the unfused branch and the
group-all branch), ``SAModuleMSG``, ``GroupMLPPool``, ``LiftedGroupMLP``
and ``FPModule`` (3-NN through the kNN kernel, inverse-distance
interpolation through the gather kernel, then a unit MLP).

At eval, as in JAX, a layer whose ``npoint`` and point count are multiples
of 8 takes a fused branch (anything else the unfused one, with the
running-stat BN): FPS with coordinates (one kernel), then
  * ``SAModule`` without ``knn`` at K <= 64, and every ``SAModuleMSG``
    scale with K <= 64 or K a multiple of 16: the fused ball select + MLP +
    max-pool kernel (``sa_ball_mlp_pool``);
  * ``SAModule`` with ``knn`` (the kNN kernel, then a plain gather of the
    coordinates) or with K > 64 (the ball group kernel): the MLP + max-pool
    over that grouping (``sa_mlp_pool``).
In training a ball-grouped layer runs FPS (indices only), the ball group,
the neighbour gather (whose backward is the scatter-add kernel) and the
MLP with batch-statistics BN.  An MSG scale whose input is wider than its
first layer (``C + 3 > mlp[0]``) runs ``LiftedGroupMLP``: Dense 0 per
point before the gather.  Each ``GroupMLPPool`` / ``LiftedGroupMLP`` ends
in ``nn/layers.mlp_final_max`` and carries the training settings that
``configure_training`` gives it (the ``Trainer`` does, per model; nothing
is process-global):
  * ``pool_mode``: "0" (native), "1" (the last layer f32 across the pool)
    or "keys" (exact-key pooling, the bf16 default: the last layer is
    ``ops.exactpool.dense_bn_exactkey_pool``, #18 on the card);
  * ``fused_sa_train``: under modes "0" and "1", the layers after Dense 0
    run as ``ops.satrain.grouped_bn_mlp_pool`` (``_fused_train_tail``),
    whose backward recomputes them from Dense 0's output (#17 on the card);
    its statistics are those of the BatchNorms' group
    (``nn.layers.configure_parallel``), reduced inside the op.
Eval ignores both; it reads ``fused_sa_eval`` and ``sa_bucket``, which
``configure_eval`` gives (JAX's kernelconfig settings, per model here).
``fused_sa_eval`` "on" (the default) runs an eval SA layer whose ``npoint``
and point count are multiples of 8 fused (FPS with coordinates, then #3,
#4 or #10); "off" sends every eval SA layer through the unfused branch
(``sample_and_group`` and the MLP with the running-stat BN).  JAX's
"interpret" is a Pallas mode and is not ported.  ``sa_bucket`` "auto" (the default)
sends a fused ball-grouped scale whose (N, M) is in the bucketed kernel's
table (``ops/cuda/sabucket_kernel.AUTO_BUCKET``: (2048, 512)) and that
``bucket_eligible`` takes to ``sa_ball_mlp_pool_bucketed`` (#4, with #5
sorting its points and queries), whose pooled output is #3's bit for bit;
"off" keeps #3.  The parameter tree stays ``dense_i``/``bn_i`` on every
path: the fused ops own no parameters.

Not ported: pooling modes other than max, ``mlp2``, ``bn=False`` and MSG's
``remat_scales`` (it changes no value and was measured slower).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from scanobjectnn_torch import ops
from scanobjectnn_torch.nn.layers import MLP, MaxPoolMLP, matmul_f32, mlp_final_max
from scanobjectnn_torch.ops.cuda.gather_kernel import gather_neighbors
from scanobjectnn_torch.ops.cuda.sabucket_kernel import (
    SA_BUCKET_SETTINGS, bucket_eligible, resolve_bucket_config, sa_ball_mlp_pool_bucketed,
)
from scanobjectnn_torch.ops.cuda.safused_kernel import fusable_nsample, sa_ball_mlp_pool
from scanobjectnn_torch.ops.cuda.samlp_kernel import fold_bn_mlp_params, sa_mlp_pool
from scanobjectnn_torch.ops.satrain import grouped_bn_mlp_pool

__all__ = [
    "configure_eval",
    "configure_training",
    "sample_and_group",
    "sample_and_group_all",
    "FPModule",
    "SAModule",
    "SAModuleMSG",
    "GroupMLPPool",
    "LiftedGroupMLP",
]


POOL_MODES = ("0", "1", "keys")
FUSED_SA_EVAL_SETTINGS = ("on", "off")


class _PooledMLP(MLP):
    """A shared MLP that ends in a max-pool over the neighbour axis, with
    the training settings of the module doc (defaults: mode "0", unfused)
    and the eval settings ``fused_sa_eval`` (default "on") and
    ``sa_bucket`` (default "auto")."""

    pool_mode = "0"
    fused_sa_train = False
    fused_sa_eval = "on"
    sa_bucket = "auto"

    def fused_tail(self) -> bool:
        """JAX's gate of the fused training tail: training, the setting on,
        and a mode the tail implements ("0" or "1")."""
        return self.training and self.fused_sa_train and self.pool_mode != "keys"

    def folded(self) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
        """Eval-mode BN folded into the Dense params (f32)."""
        n = len(self.features)
        dense = [(getattr(self, f"dense_{i}").kernel, getattr(self, f"dense_{i}").bias) for i in range(n)]
        bn = [getattr(self, f"bn_{i}") for i in range(n)]
        return fold_bn_mlp_params(dense, [(m.scale, m.bias, m.mean, m.var) for m in bn])


def configure_training(model: nn.Module, pool_mode: str, fused_sa_train: bool) -> nn.Module:
    """Give every grouped MLP of ``model`` its training settings (module
    doc): ``pool_mode`` "0", "1" or "keys" (JAX's pool_f32 modes), and
    whether the fused tail runs.  A ``MaxPoolMLP`` (PointNet's global
    pools) takes the pool mode; it has no fused tail."""
    if pool_mode not in POOL_MODES:
        raise ValueError(f"pool_mode must be one of {POOL_MODES}, got {pool_mode!r}")
    for sub in model.modules():
        if isinstance(sub, _PooledMLP):
            sub.pool_mode, sub.fused_sa_train = pool_mode, bool(fused_sa_train)
        elif isinstance(sub, MaxPoolMLP):
            sub.pool_mode = pool_mode
    return model


def configure_eval(model: nn.Module, sa_bucket: str, fused_sa_eval: str = "on") -> nn.Module:
    """Give every grouped MLP of ``model`` its eval settings (module doc):
    ``sa_bucket`` "auto" (JAX's default: the bucketed kernel where
    ``AUTO_BUCKET`` has the layer's shape) or "off", and ``fused_sa_eval``
    "on" or "off"."""
    if sa_bucket not in SA_BUCKET_SETTINGS:
        raise ValueError(f"sa_bucket must be one of {SA_BUCKET_SETTINGS}, got {sa_bucket!r}")
    if fused_sa_eval not in FUSED_SA_EVAL_SETTINGS:
        raise ValueError(f"fused_sa_eval must be one of {FUSED_SA_EVAL_SETTINGS}, got {fused_sa_eval!r}")
    for sub in model.modules():
        if isinstance(sub, _PooledMLP):
            sub.sa_bucket, sub.fused_sa_eval = sa_bucket, fused_sa_eval
    return model


def _fused_train_tail(mdl: _PooledMLP, z1: torch.Tensor, bn_momentum: float | None) -> torch.Tensor:
    """BN0 -> relu -> (Dense -> BN -> relu)* -> max over K as one op
    (``ops.satrain.grouped_bn_mlp_pool``) on ``mdl``'s own parameters, its
    BatchNorms taking the op's batch statistics (over their group) into
    their running ones."""
    n = len(mdl.features)
    bns = [getattr(mdl, f"bn_{i}") for i in range(n)]
    denses = [getattr(mdl, f"dense_{i}") for i in range(1, n)]
    pooled, means, variances = grouped_bn_mlp_pool(
        z1, [m.scale for m in bns], [m.bias for m in bns], [d.kernel for d in denses], [d.bias for d in denses],
        mdl.pool_mode, bns[0].group,
    )
    for m, mean, var in zip(bns, means, variances):
        m.update_running(mean, var, bn_momentum)
    return pooled


class GroupMLPPool(_PooledMLP):
    """Grouped shared MLP + max-pool over the neighbour axis (dim 2).  Same
    children as ``MLP`` (``dense_i``/``bn_i``), so the eval BN fold reads
    them directly.  Training runs the chain with batch-statistics BN, the
    last layer through ``mlp_final_max`` (its pool mode), or Dense 0 and
    then the fused tail."""

    def forward(self, x: torch.Tensor, bn_momentum: float | None = None) -> torch.Tensor:
        if self.fused_tail():
            return _fused_train_tail(self, self.dense_0(x), bn_momentum)
        n = len(self.features)
        for i in range(n - 1):
            x = self.layer(i, x, bn_momentum)
        return mlp_final_max(self, x, n - 1, 2, bn_momentum)


class LiftedGroupMLP(_PooledMLP):
    """Shared MLP over grouped neighbourhoods with the first Dense lifted to
    per point, applied before the neighbour gather: an exact linear
    refactoring of ``Dense([f_j, p_j - q])``,

        [f_j, p_j - q]·W + b  =  ([f_j, p_j]·W + b)  -  [0, q]·W,

    so layer 0 runs over the N points instead of the M·K edges and the
    gather (#6, backward #7) moves ``mlp[0]`` channels instead of C + 3.  Then
    BN, relu, the remaining layers and the max-pool over the neighbours, as
    ``GroupMLPPool`` (the pool runs inside the module: JAX's ``pool=True``,
    the only way MSG calls it).  Children ``dense_i``/``bn_i`` as in
    ``MLP``, so JAX checkpoints load strictly and the eval BN fold reads
    them.

    Dense 0 multiplies the xyz rows of W0 in f32 (``Dense.highest_cols``)
    and keeps its output f32: ``p·W - q·W`` cancels, so bf16 operands there
    would carry the rounding of the uncentred ``|p·W|``.  The per-edge
    pre-activation ``x32 = gather(pointwise) - (qfull - b)`` (``qfull =
    q·W_xyz + b``, JAX's Dense 0 of ``[0, q]``) is rounded to the compute
    dtype only after the subtraction; in keys mode ``x32`` keys a one-layer
    pool."""

    def __init__(
        self, in_features: int, features: Sequence[int], xyz_first: bool = False, dtype: torch.dtype | None = None
    ):
        super().__init__(in_features, features, dtype)
        self.xyz_first = xyz_first
        self.dense_0.highest_cols = (0, 3) if xyz_first else (in_features - 3, in_features)

    def forward(
        self,
        point_feats: torch.Tensor | None,
        xyz: torch.Tensor,
        query_xyz: torch.Tensor,
        idx: torch.Tensor,
        bn_momentum: float | None = None,
    ) -> torch.Tensor:
        """point_feats [B, N, C] or None, xyz [B, N, 3], query_xyz [B, M, 3],
        idx int32 [B, M, K] -> pooled [B, M, mlp[-1]]."""
        d0 = self.dense_0
        if point_feats is None:
            pointwise = d0(xyz)
        else:
            parts = [xyz, point_feats] if self.xyz_first else [point_feats, xyz]
            pointwise = d0(torch.cat(parts, dim=-1))
        # JAX's qfull, Dense 0 of [0, q], is q·W_xyz + b bit for bit (the
        # zero rows add exact zeros); its bias comes back off before the
        # subtraction, as there.
        a, c = d0.highest_cols
        qfull = matmul_f32(query_xyz, d0.kernel[a:c]) + d0.bias
        x32 = gather_neighbors(pointwise.contiguous(), idx) - (qfull - d0.bias)[:, :, None, :]
        x = x32.to(self.dtype) if self.dtype is not None else x32
        if self.fused_tail():
            return _fused_train_tail(self, x, bn_momentum)
        n = len(self.features)
        if n == 1:
            return mlp_final_max(self, x, 0, 2, bn_momentum, skip_dense=True, x32=x32)
        x = torch.relu(self.bn_0(x, bn_momentum))
        for i in range(1, n - 1):
            x = self.layer(i, x, bn_momentum)
        return mlp_final_max(self, x, n - 1, 2, bn_momentum)


def _group_width(in_channels: int, use_xyz: bool) -> int:
    """Width of a grouped row: the centred coordinates (``use_xyz``, or a
    layer without point features) and the ``in_channels`` features."""
    return 3 if in_channels == 0 else in_channels + 3 * use_xyz


def _gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Neighbour rows [B, M, K, C] of ``points`` in its dtype.  The gather
    kernel moves f32 rows, so a bf16 source (an unfused eval layer) is
    gathered as f32, which is exact, and cast back."""
    return gather_neighbors(points.float().contiguous(), idx).to(points.dtype)


def _fused_eval(mlp: _PooledMLP, npoint: int, xyz: torch.Tensor) -> bool:
    """The JAX gate of the fused eval branches: ``fused_sa_eval`` "on" and
    ``npoint`` and the point count multiples of 8."""
    return mlp.fused_sa_eval == "on" and npoint % 8 == 0 and xyz.shape[1] % 8 == 0


def _fused_ball_scale(
    mlp: GroupMLPPool | LiftedGroupMLP,
    radius: float,
    nsample: int,
    xyz: torch.Tensor,
    new_xyz: torch.Tensor,
    points: torch.Tensor | None,
    use_xyz: bool,
    xyz_first: bool,
    dtype: torch.dtype,
) -> torch.Tensor:
    """One fused eval-time ball-grouped SA scale, shared by ``SAModule``
    (SSG order [xyz, feats], ``xyz_first=True``) and ``SAModuleMSG`` (MSG
    order [feats, xyz]): fold the eval BN into the Dense weights, then ball
    select + gather + MLP + max-pool in one kernel: the bucketed one
    (``sa_ball_mlp_pool_bucketed``) where ``mlp.sa_bucket`` resolves to a
    window for the layer's (N, M) and JAX's ``bucket_eligible`` holds (no
    caller here reads the layer's idx), else ``sa_ball_mlp_pool``.  Returns
    pooled [B, M, C]."""
    weights, biases = mlp.folded()
    xyz, new_xyz = xyz.float().contiguous(), new_xyz.float().contiguous()
    n, m = xyz.shape[1], new_xyz.shape[1]
    bucket = resolve_bucket_config(mlp.sa_bucket, n, m)
    if bucket_eligible(bucket, n, m, nsample, points is not None, use_xyz, need_idx=False):
        window, qtile, gblk = bucket
        pooled, _ = sa_ball_mlp_pool_bucketed(
            radius, nsample, xyz, new_xyz, points, weights, biases, use_xyz=use_xyz, xyz_first=xyz_first,
            dtype=dtype, window=window, qtile=qtile, gblk=gblk,
        )
        return pooled
    pooled, _ = sa_ball_mlp_pool(
        radius, nsample, xyz, new_xyz, points, weights, biases, use_xyz=use_xyz, xyz_first=xyz_first, dtype=dtype,
    )
    return pooled


def sample_and_group(
    npoint: int,
    radius: float,
    nsample: int,
    xyz: torch.Tensor,
    points: torch.Tensor | None,
    knn: bool = False,
    use_xyz: bool = True,
):
    """FPS → neighbourhood (ball query with centred grouping, or kNN and a
    gather of the coordinates minus the centroid) → feature gather →
    concat [xyz, feats] (coordinates first; ``use_xyz=False`` keeps the
    features alone).  Returns (new_xyz [B,np,3], new_points
    [B,np,ns,C']); the JAX function also returns the indices and the
    grouped coordinates, which no caller here reads."""
    fps_idx = ops.farthest_point_sample(xyz, npoint)
    new_xyz = ops.gather_point(xyz, fps_idx)
    if knn:
        _, idx = ops.knn_point(nsample, xyz, new_xyz)
        grouped_xyz = ops.group_point(xyz, idx) - new_xyz[:, :, None, :]
    else:
        grouped_xyz, idx, _ = ops.query_ball_group(radius, nsample, xyz, new_xyz)
    if points is None:
        return new_xyz, grouped_xyz
    grouped = _gather_points(points, idx)
    return new_xyz, torch.cat([grouped_xyz, grouped], dim=-1) if use_xyz else grouped


def sample_and_group_all(xyz: torch.Tensor, points: torch.Tensor | None, use_xyz: bool = True):
    """Single group holding every point, centroid (0, 0, 0), coordinates
    concatenated before the features (``use_xyz``).  Returns (new_xyz
    [B,1,3], new_points [B,1,N,C'])."""
    new_xyz = xyz.new_zeros(xyz.shape[0], 1, 3)
    if points is None:
        return new_xyz, xyz[:, None]
    return new_xyz, (torch.cat([xyz, points], dim=-1) if use_xyz else points)[:, None]


class SAModule(nn.Module):
    """PointNet set abstraction with max pooling.

    ``in_channels`` is the width of ``points`` (0 when there are none); the
    MLP's input adds the 3 centred coordinates when ``use_xyz`` or when
    there are no points.  ``knn`` groups the ``nsample`` nearest points
    instead of a ball (``radius`` unused)."""

    def __init__(
        self,
        npoint: int | None,
        radius: float | None,
        nsample: int | None,
        mlp: Sequence[int],
        in_channels: int = 0,
        group_all: bool = False,
        knn: bool = False,
        use_xyz: bool = True,
        dtype: torch.dtype | None = None,
    ):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.group_all, self.knn, self.use_xyz, self.dtype = group_all, knn, use_xyz, dtype
        self.mlp = GroupMLPPool(_group_width(in_channels, use_xyz), mlp, dtype=dtype)

    def forward(self, xyz: torch.Tensor, points: torch.Tensor | None, bn_momentum: float | None = None):
        """Returns (new_xyz [B, npoint, 3], pooled [B, npoint, C]).
        ``bn_momentum`` is required in training."""
        if self.group_all:
            new_xyz, new_points = sample_and_group_all(xyz, points, self.use_xyz)
            return new_xyz, self.mlp(new_points, bn_momentum)
        if self.training or not _fused_eval(self.mlp, self.npoint, xyz):
            new_xyz, new_points = sample_and_group(
                self.npoint, self.radius, self.nsample, xyz, points, self.knn, self.use_xyz
            )
            return new_xyz, self.mlp(new_points, bn_momentum)
        # idx + centroid coordinates in one FPS kernel pass.
        _, new_xyz = ops.farthest_point_sample_with_coords(xyz, self.npoint)
        dtype = self.dtype or xyz.dtype
        if not self.knn and self.nsample <= 64:
            pooled = _fused_ball_scale(
                self.mlp, self.radius, self.nsample, xyz, new_xyz, points, self.use_xyz, True, dtype
            )
            return new_xyz, pooled
        if self.knn:
            _, idx = ops.knn_point(self.nsample, xyz, new_xyz)
            grouped_xyz = ops.group_point(xyz.float(), idx) - new_xyz.float()[:, :, None, :]
        else:
            grouped_xyz, idx, _ = ops.query_ball_group(self.radius, self.nsample, xyz, new_xyz)
        weights, biases = self.mlp.folded()
        pooled = sa_mlp_pool(
            grouped_xyz if self.use_xyz or points is None else None,
            idx if points is not None else None,
            points, weights, biases, dtype=dtype,
        )
        return new_xyz, pooled


class SAModuleMSG(nn.Module):
    """Multi-scale grouping SA (ref pointnet_util.py:156-196): one FPS, a
    ball query + MLP + max-pool per radius, concatenated over the scales.
    The grouped rows are [feats, xyz] (features first, unlike SSG).

    ``in_channels`` is the width of ``points`` (0 when there are none).  A
    scale is lifted (``mlp_scale{i}`` a ``LiftedGroupMLP``) when it has
    point features, ``use_xyz``, and ``in_channels + 3 > mlp[0]``; else it
    is a ``GroupMLPPool`` over the grouped rows.  At eval (module doc) every
    scale with K <= 64 or K a multiple of 16 runs the fused kernel; any
    other K runs the unfused chain with the running-stat BN."""

    def __init__(
        self,
        npoint: int,
        radius_list: Sequence[float],
        nsample_list: Sequence[int],
        mlp_list: Sequence[Sequence[int]],
        in_channels: int = 0,
        use_xyz: bool = True,
        dtype: torch.dtype | None = None,
    ):
        super().__init__()
        self.npoint, self.radius_list, self.nsample_list = npoint, tuple(radius_list), tuple(nsample_list)
        self.use_xyz, self.dtype = use_xyz, dtype
        width = _group_width(in_channels, use_xyz)
        for i, mlp in enumerate(mlp_list):
            if in_channels and use_xyz and in_channels + 3 > mlp[0]:
                scale = LiftedGroupMLP(width, mlp, xyz_first=False, dtype=dtype)
            else:
                scale = GroupMLPPool(width, mlp, dtype=dtype)
            self.add_module(f"mlp_scale{i}", scale)

    def forward(self, xyz: torch.Tensor, points: torch.Tensor | None, bn_momentum: float | None = None):
        """Returns (new_xyz [B, npoint, 3], [B, npoint, sum of mlp[-1]])."""
        fused = not self.training and _fused_eval(self.mlp_scale0, self.npoint, xyz)
        if fused:
            _, new_xyz = ops.farthest_point_sample_with_coords(xyz, self.npoint)
        else:
            new_xyz = ops.gather_point(xyz, ops.farthest_point_sample(xyz, self.npoint))
        dtype = self.dtype or xyz.dtype
        pooled = []
        for i, (radius, nsample) in enumerate(zip(self.radius_list, self.nsample_list)):
            mlp = getattr(self, f"mlp_scale{i}")
            if fused and fusable_nsample(nsample):
                pooled.append(_fused_ball_scale(mlp, radius, nsample, xyz, new_xyz, points, self.use_xyz, False, dtype))
                continue
            grouped_xyz, idx, _ = ops.query_ball_group(radius, nsample, xyz, new_xyz)
            if isinstance(mlp, LiftedGroupMLP):
                pooled.append(mlp(points, xyz, new_xyz, idx, bn_momentum))
                continue
            grouped = grouped_xyz
            if points is not None:
                grouped = _gather_points(points, idx)
                if self.use_xyz:
                    grouped = torch.cat([grouped, grouped_xyz], dim=-1)
            pooled.append(mlp(grouped, bn_momentum))
        return new_xyz, torch.cat(pooled, dim=-1)


class FPModule(nn.Module):
    """Feature propagation: 3-NN inverse-distance upsampling of ``points2``
    from ``xyz2`` to ``xyz1``, concatenated with ``points1`` when given,
    then a unit MLP (Dense→BN→relu per layer; ref pointnet_util.py:199-229).
    ``in_channels`` is the width of ``points2`` plus that of ``points1``."""

    def __init__(self, mlp: Sequence[int], in_channels: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.mlp = MLP(in_channels, mlp, dtype=dtype)

    def forward(
        self,
        xyz1: torch.Tensor,
        xyz2: torch.Tensor,
        points1: torch.Tensor | None,
        points2: torch.Tensor,
        bn_momentum: float | None = None,
    ) -> torch.Tensor:
        """xyz1 [B, N, 3], xyz2 [B, M, 3], points1 [B, N, C1] or None,
        points2 [B, M, C2] -> [B, N, mlp[-1]]."""
        dist, idx = ops.three_nn(xyz1, xyz2)
        interpolated = ops.three_interpolate(points2, idx, ops.three_interpolate_weights(dist))
        if points1 is not None:
            interpolated = torch.cat([interpolated, points1], dim=-1)
        return self.mlp(interpolated, bn_momentum)
