"""X-Conv, PointCNN's learned-transform point convolution, and its geometry
helpers (counterpart of ``scanobjectnn_tpu/nn/xconv.py``).  References:
PointCNN/pointcnn.py:10-52 (xconv) and PointCNN/pointfly.py:122-347 (the
unique kNN, point sorting, inverse-density sampling, and the dense → ELU →
BN layer wrappers).

  * ``knn_indices_general(queries, points, k, unique)``: on a CUDA tensor
    with k <= 64 it takes the kernel branch: the duplicate mask (#12,
    ``ops/cuda/dupmask_kernel``) times ``big = 4·max|q|² + 4·max|p|² + 1``
    (above any squared distance) is the key bias of the kNN kernel (#13,
    ``ops/cuda/knn_kernel``).  Every other call, on any device, takes the
    plain branch: the full distance matrix plus ``max(d2)`` over the whole
    [B, P, N] tensor on the duplicate columns, then a stable ascending
    top-k.  The branches choose the same neighbours unless suppressed
    duplicates themselves reach the top k (fewer than k unique points), as
    in the JAX package.  Both read detached inputs; only ``idx`` is used.
    The JAX dispatch also asks for Q % 8 == 0 and Q·N >= 256·1024, a TPU
    tiling rule and a TPU crossover; on an H100 the kernel branch was
    about twice as fast as the plain one even at PointCNN's smallest call
    (Q 128 × N 128, k = 48), so the port drops both.
  * ``sort_points`` orders each neighbourhood with a stable argsort
    (``jnp.argsort`` is stable).  ``inverse_density_sample`` draws from an
    explicit ``torch.Generator`` (``torch.multinomial``): its logits are the
    JAX package's, its random bits are not.
  * ``EluDense``, ``_WindowConv``, ``_DepthwiseWindowConv`` and
    ``_SeparableWindowConv`` keep the reference's order dense → ELU → BN,
    with BN momentum fixed at 0.99 whatever the trainer's schedule says.
    Operands are cast to the compute dtype, products summed in f32
    (``matmul_f32``), the result cast once.  ``EluDense(with_bn=False)``
    adds an f32 bias to that cast product, so in bf16 its output is f32, as
    by JAX's promotion.  The depthwise output is channel-major
    (``bpkc,kcm->bpcm``, reshaped to c·m).
  * ``XConv`` takes the dilated kNN (K·D neighbours, every D-th kept),
    groups the points, lifts them with two ``EluDense``, gathers the previous
    layer's features with ``gather_neighbors`` (the gather kernel #6, whose
    backward is the scatter-add #7), applies the learned K×K X-transform
    with f32 sums, then the separable window conv, and with ``with_global``
    two ``EluDense`` on the query positions.

Kernels are Glorot-normal, flax's ``glorot_normal`` (variance scaling 1,
fan_avg, a normal truncated at 2σ): for a 3-D kernel (K, C, M) the fans are
K·C and K·M.  Parameter and buffer names follow the JAX tree
(``X_0.kernel``, ``fts_conv.depthwise``, ``nn_fts_from_pts_0.bn.mean``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from scanobjectnn_torch import ops
from scanobjectnn_torch.nn.layers import BatchNorm, matmul_f32
from scanobjectnn_torch.ops.cuda.dupmask_kernel import duplicate_mask_kernel, duplicate_mask_plain
from scanobjectnn_torch.ops.cuda.gather_kernel import gather_neighbors
from scanobjectnn_torch.ops.cuda.knn_kernel import MAX_K, knn_point_kernel, squared_distance_plain
from scanobjectnn_torch.parallel.mesh import draw_rows

__all__ = [
    "PCNN_BN_MOMENTUM",
    "EluDense",
    "XConv",
    "glorot_normal_",
    "inverse_density_logits",
    "inverse_density_sample",
    "knn_indices_general",
    "sort_points",
]

# PointCNN's BN is tf.layers.batch_normalization(momentum=0.99)
# (pointfly.py:299-303): fixed, not the scheduled bn_decay.
PCNN_BN_MOMENTUM = 0.99


def glorot_normal_(tensor: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
    """flax ``glorot_normal`` in place: a normal truncated at ±2σ with
    ``σ = sqrt(2 / (fan_in + fan_out)) / 0.8796...``, fans counted over the
    last two axes times the others (module doc)."""
    receptive = math.prod(tensor.shape[:-2])
    fan_in, fan_out = tensor.shape[-2] * receptive, tensor.shape[-1] * receptive
    std = math.sqrt(2.0 / (fan_in + fan_out)) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(tensor, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def _duplicate_bias_plain(d2: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """``d2 + max(d2)·dup``: the plain branch's suppression of duplicates."""
    return d2 + d2.max() * duplicate_mask_plain(points)[:, None, :]


def _knn_indices_kernel(
    queries: torch.Tensor, points: torch.Tensor, k: int, unique: bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel branch (module doc): the duplicate mask times a norm bound
    as the key bias of the kNN kernel.  On a CPU tensor the two wrappers run
    their plain versions."""
    q, p = queries.detach().float().contiguous(), points.detach().float().contiguous()
    bias = None
    if unique:
        big = 4.0 * (q * q).sum(-1).max() + 4.0 * (p * p).sum(-1).max() + 1.0
        bias = duplicate_mask_kernel(p) * big
    return knn_point_kernel(q, p, k, bias)


def _knn_indices_plain(
    queries: torch.Tensor, points: torch.Tensor, k: int, unique: bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain branch (module doc): a stable sort of the full distance
    matrix, duplicates pushed back by the global ``max(d2)``."""
    q, p = queries.detach().float(), points.detach().float()
    d2 = squared_distance_plain(q, p)
    if unique:
        d2 = _duplicate_bias_plain(d2, p)
    vals, order = torch.sort(d2, dim=-1, stable=True)
    return vals[..., :k], order[..., :k].to(torch.int32)


def knn_indices_general(
    queries: torch.Tensor, points: torch.Tensor, k: int, unique: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """k nearest points per query, duplicates of earlier points suppressed
    when ``unique`` (module doc): (d2 [B, P, k] f32, idx [B, P, k] int32)."""
    if queries.device.type == "cuda" and k <= MAX_K:
        return _knn_indices_kernel(queries, points, k, unique)
    return _knn_indices_plain(queries, points, k, unique)


def sort_points(points: torch.Tensor, idx: torch.Tensor, method: str) -> torch.Tensor:
    """Reorder each neighbourhood (pointfly.py:179-217): ``l2`` by distance
    to the neighbourhood mean, ``c<permutation of xyz>`` lexicographically
    by 100^k-scaled normalised coordinates with slot 0 (the query) kept
    first.  A stable argsort breaks ties by slot."""
    b, p, _ = idx.shape
    nn_pts = ops.group_point(points, idx).float()  # [B, P, K, 3]
    if method.startswith("c"):
        if "".join(sorted(method[1:])) != "xyz":
            raise ValueError(f"unknown sorting method {method!r}")
        mn = nn_pts.amin(dim=2, keepdim=True)
        mx = nn_pts.amax(dim=2, keepdim=True)
        normalized = (nn_pts - mn) / (mx - mn + 1e-8)
        scaling = [math.pow(100.0, 3 - method.find(axis)) for axis in "xyz"]
        key = (normalized[..., 0] * scaling[0] + normalized[..., 1] * scaling[1]) + normalized[..., 2] * scaling[2]
        key = torch.cat([key.new_zeros(b, p, 1), key[:, :, 1:]], dim=-1)
    elif method == "l2":
        d = nn_pts - nn_pts.mean(dim=2, keepdim=True)
        key = torch.sqrt((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2])
    else:
        raise ValueError(f"unknown sorting method {method!r}")
    return torch.gather(idx, -1, torch.argsort(key, dim=-1, stable=True))


def inverse_density_logits(points: torch.Tensor, k: int) -> torch.Tensor:
    """log of each point's mean squared distance to its k nearest points
    (itself included), plus 1e-8: [B, N, 3] -> [B, N]."""
    d2 = squared_distance_plain(points, points)
    nearest = torch.sort(d2, dim=-1, stable=True)[0][..., :k]
    return torch.log(torch.abs(nearest.mean(dim=-1)) + 1e-8)


def inverse_density_sample(
    generator: torch.Generator | None, points: torch.Tensor, k: int, sample_num: int
) -> torch.Tensor:
    """``sample_num`` indices per cloud, drawn with replacement with
    probability proportional to the mean kNN distance (pointfly.py:284-296):
    [B, N, 3] -> int32 [B, sample_num].  Inside ``parallel.global_batch``
    the draw is the global batch's (``parallel.draw_rows``): the other
    ranks' clouds stand in as uniform rows, whose probabilities do not move
    the draws of this rank's rows (``torch.multinomial`` takes each row's
    uniforms by its position, not by its values)."""
    probs = torch.softmax(inverse_density_logits(points.detach().float(), k), dim=-1)

    def draw(rows: int, mine: slice) -> torch.Tensor:
        full = probs.new_ones((rows, probs.shape[1]))
        full[mine] = probs
        return torch.multinomial(full, sample_num, replacement=True, generator=generator)

    return draw_rows(draw, probs.shape[0]).to(torch.int32)


class _Layer(nn.Module):
    """A kernel of Glorot-normal init, then (optionally) ELU and BN(0.99)."""

    def __init__(self, bn_features: int | None, dtype: torch.dtype | None):
        super().__init__()
        self.dtype = dtype
        if bn_features is not None:
            self.bn = BatchNorm(bn_features, dtype)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for name, param in self.named_parameters(recurse=False):
            if name == "bias":
                with torch.no_grad():
                    param.zero_()
            else:
                glorot_normal_(param, generator)

    def _finish(self, y: torch.Tensor, activation: bool) -> torch.Tensor:
        if activation:
            y = F.elu(y)
        return self.bn(y, PCNN_BN_MOMENTUM)


class EluDense(_Layer):
    """PointCNN's dense (pointfly.py:343-347): no bias, ELU, BN(0.99);
    ``with_bn=False`` is a plain dense with an f32 bias (module doc)."""

    def __init__(
        self, in_features: int, features: int, with_bn: bool = True, activation: bool = True,
        dtype: torch.dtype | None = None,
    ):
        super().__init__(features if with_bn else None, dtype)
        self.with_bn, self.activation = with_bn, activation
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        if not with_bn:
            self.bias = nn.Parameter(torch.zeros(features))
        self.reset_parameters()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype or x.dtype
        y = matmul_f32(x.to(dtype), self.kernel.to(dtype)).to(dtype)
        if self.with_bn:
            return self._finish(y, self.activation)
        y = y + self.bias  # bf16 + f32 -> f32, as in JAX
        return F.elu(y) if self.activation else y


class _WindowConv(_Layer):
    """conv2d with kernel (1, K) over [B, P, K, C] -> [B, P, features]: one
    dense over the flattened K·C axis, ELU, BN (pointfly.py:333-341)."""

    def __init__(self, window: int, channels: int, features: int, activation: bool = True, dtype=None):
        super().__init__(features, dtype)
        self.activation = activation
        self.kernel = nn.Parameter(torch.empty(window * channels, features))
        self.reset_parameters()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, p, k, c = x.shape
        dtype = self.dtype or x.dtype
        y = matmul_f32(x.reshape(b, p, k * c).to(dtype), self.kernel.to(dtype)).to(dtype)
        return self._finish(y, self.activation)


def _depthwise(x: torch.Tensor, kernel: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``einsum("bpkc,kcm->bpcm")`` of the operands cast to ``dtype``, in f32,
    reshaped to [B, P, C·M] (channel-major)."""
    b, p, _, c = x.shape
    y = torch.einsum("bpkc,kcm->bpcm", x.to(dtype).float(), kernel.to(dtype).float())
    return y.reshape(b, p, c * kernel.shape[-1])


class _DepthwiseWindowConv(_Layer):
    """Depthwise conv with kernel (1, K) and channel multiplier M over
    [B, P, K, C] -> [B, P, C·M], optional ELU, BN (pointfly.py:319-331)."""

    def __init__(self, window: int, channels: int, multiplier: int, activation: bool = True, dtype=None):
        super().__init__(channels * multiplier, dtype)
        self.activation = activation
        self.kernel = nn.Parameter(torch.empty(window, channels, multiplier))
        self.reset_parameters()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype or x.dtype
        return self._finish(_depthwise(x, self.kernel, dtype).to(dtype), self.activation)


class _SeparableWindowConv(_Layer):
    """separable_conv2d with kernel (1, K): depthwise (multiplier dm), then
    pointwise to ``features``, ELU, BN (pointfly.py:306-317)."""

    def __init__(self, window: int, channels: int, features: int, depth_multiplier: int = 1, dtype=None):
        super().__init__(features, dtype)
        self.depthwise = nn.Parameter(torch.empty(window, channels, depth_multiplier))
        self.pointwise = nn.Parameter(torch.empty(channels * depth_multiplier, features))
        self.reset_parameters()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype or x.dtype
        y = _depthwise(x, self.depthwise, dtype)
        y = matmul_f32(y.to(dtype), self.pointwise.to(dtype)).to(dtype)
        return self._finish(y, True)


class XConv(nn.Module):
    """One X-Conv layer (pointcnn.py:10-52).  ``forward(pts [B, N, 3], fts
    [B, N, C_fts] or None, qrs [B, P, 3])`` -> [B, P, C (+ C // 4 with
    ``with_global``)].  ``c_fts`` is the width of ``fts`` (0 for None)."""

    def __init__(
        self, K: int, D: int, C: int, C_pts_fts: int, depth_multiplier: int, c_fts: int,
        with_X_transformation: bool = True, with_global: bool = False, sorting_method: str | None = None,
        dtype: torch.dtype | None = None,
    ):
        super().__init__()
        self.K, self.D, self.with_global, self.sorting_method = K, D, with_global, sorting_method
        self.with_X_transformation = with_X_transformation
        self.nn_fts_from_pts_0 = EluDense(3, C_pts_fts, dtype=dtype)
        self.nn_fts_from_pts = EluDense(C_pts_fts, C_pts_fts, dtype=dtype)
        if with_X_transformation:
            self.X_0 = _WindowConv(K, 3, K * K, dtype=dtype)
            self.X_1 = _DepthwiseWindowConv(K, K, K, dtype=dtype)
            self.X_2 = _DepthwiseWindowConv(K, K, K, activation=False, dtype=dtype)
        self.fts_conv = _SeparableWindowConv(K, C_pts_fts + c_fts, C, depth_multiplier, dtype=dtype)
        if with_global:
            self.fts_global_0 = EluDense(3, C // 4, dtype=dtype)
            self.fts_global = EluDense(C // 4, C // 4, dtype=dtype)

    def forward(self, pts: torch.Tensor, fts: torch.Tensor | None, qrs: torch.Tensor) -> torch.Tensor:
        _, idx_dilated = knn_indices_general(qrs, pts, self.K * self.D, unique=True)
        idx = idx_dilated[:, :, :: self.D].contiguous()
        if self.sorting_method is not None:
            idx = sort_points(pts, idx, self.sorting_method)

        nn_pts_local = ops.group_point(pts, idx) - qrs[:, :, None, :]  # [B, P, K, 3]
        nn_fts = self.nn_fts_from_pts(self.nn_fts_from_pts_0(nn_pts_local))
        if fts is not None:
            prev = gather_neighbors(fts.float().contiguous(), idx).to(fts.dtype)
            nn_fts = torch.cat([nn_fts, prev], dim=-1)

        if self.with_X_transformation:
            b, p, k = idx.shape
            x = self.X_0(nn_pts_local).reshape(b, p, k, k)
            x = self.X_1(x).reshape(b, p, k, k)
            x = self.X_2(x).reshape(b, p, k, k)
            nn_fts = torch.matmul(x.float(), nn_fts.float()).to(nn_fts.dtype)  # bpij,bpjc->bpic

        out = self.fts_conv(nn_fts)  # [B, P, C]
        if self.with_global:
            g = self.fts_global(self.fts_global_0(qrs))
            return torch.cat([g, out], dim=-1)
        return out
