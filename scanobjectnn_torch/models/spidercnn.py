"""SpiderCNN (counterpart of ``scanobjectnn_tpu/models/spidercnn.py``).
References: SpiderCNN/models/spidercnn_cls_xyz.py:20-79 (one kNN, k=20, on
xyz, reused by four SpiderConvs 32, 64, 128, 256; the concat of all four;
top-2 pooling per channel; FC 1024, 512 with dropout keep 0.3; 15 classes)
and SpiderCNN/utils/tf_util.py:127-236 (spiderConv: a degree-3 Taylor
family g(δ) per edge, its outer product with the neighbour's features, a
[1, K] convolution to the output channels) and :363-377 (topk_pool).

The model forms the 20 monomials of each edge's offset δ = x_j - x_i once a
forward (``taylor_basis``); a SpiderConv weighs them into T Taylor channels
g = basis · w and computes ``out[b, n, o] = Σ_{k,c,t} feat[b, idx[b,n,k], c] · g[b,n,k,t] ·
W[(k·C + c)·T + t, o]`` plus a bias, then GroupNorm (G=16, eps 1e-5) and
relu.  ``fused=True`` (the default, as the JAX registry's) runs that
contraction through ``ops/cuda/spider_kernel.spider_conv`` in f32 (on the
card the kernel #16; the [B, N, K·C·T] product is never built);
``fused=False`` is the JAX unfused dataflow, with operands in the compute
dtype and f32 sums, kept as the port's own oracle.  Both share one
parameter tree.  The kNN graph and the neighbours' xyz come from
``edge_gather_knn`` (on the card the graph kernel #11 and the gather #6).

Parameter and buffer names follow the JAX tree (``conv1.taylor_weights``,
``conv1.conv.kernel``, ``conv1.GroupNorm_0.scale``, ``bn1.mean``, ...), so
``convert.load_jax_variables`` loads a JAX ``variables`` tree unchanged.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from scanobjectnn_torch import ops
from scanobjectnn_torch.models import losses
from scanobjectnn_torch.models.pointnet2 import dropout
from scanobjectnn_torch.nn.layers import BatchNorm, Dense, GroupNorm, matmul_f32
from scanobjectnn_torch.ops.cuda.edge_kernel import edge_gather_knn
from scanobjectnn_torch.ops.cuda.spider_kernel import spider_conv

__all__ = ["SpiderCNNCls", "SpiderConv", "taylor_basis", "topk_pool"]

SPIDER_WIDTHS = (32, 64, 128, 256)  # conv1-4
NUM_MONOMIALS = 20


def taylor_basis(delta: torch.Tensor) -> torch.Tensor:
    """The 20 monomials of (x, y, z) up to degree 3, in the reference's
    order (tf_util.py:216-222): x, y, z, xyz, xy, yz, xz, 1, x², y², z², x²y,
    xy², x²z, xz², y²z, yz², x³, y³, z³.  [..., 3] -> [..., 20]."""
    x, y, z = delta[..., 0], delta[..., 1], delta[..., 2]
    return torch.stack(
        [
            x, y, z, x * y * z,
            x * y, y * z, x * z, torch.ones_like(x),
            x * x, y * y, z * z,
            x * x * y, x * y * y, x * x * z,
            x * z * z, y * y * z, y * z * z,
            x * x * x, y * y * y, z * z * z,
        ],
        dim=-1,
    )


class SpiderConv(nn.Module):
    """One SpiderConv layer, [B, N, C] -> [B, N, features_out] (module
    doc): ``taylor_weights`` [20, T], ``conv`` (a Dense over the flattened
    (k, c, t) axis, K·C·T -> O), ``GroupNorm_0``."""

    def __init__(
        self, in_features: int, features_out: int, k: int, taylor_channels: int = 5, num_groups: int = 16,
        fused: bool = True, dtype: torch.dtype | None = None,
    ):
        super().__init__()
        self.fused, self.dtype = fused, dtype
        self.taylor_weights = nn.Parameter(torch.empty(NUM_MONOMIALS, taylor_channels))
        self.conv = Dense(k * in_features * taylor_channels, features_out, dtype)
        self.GroupNorm_0 = GroupNorm(features_out, num_groups, 1e-5, dtype)
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """``taylor_weights`` Glorot-uniform over (20, T), as flax's
        ``default_kernel_init``; the children reset themselves."""
        fan_in, fan_out = self.taylor_weights.shape
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        with torch.no_grad():
            self.taylor_weights.uniform_(-limit, limit, generator=generator)

    def forward(self, feat: torch.Tensor, idx: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
        """feat [B, N, C], idx [B, N, K], basis [B, N, K, 20] f32: the
        ``taylor_basis`` of the edge offsets (the JAX layer takes the offsets
        and forms it in every layer; the port forms it once a forward)."""
        b, n, k = idx.shape
        dtype = self.dtype or feat.dtype
        if self.fused:
            g = matmul_f32(basis, self.taylor_weights)  # [B, N, K, T] f32
            out = spider_conv(feat.float(), idx, g, self.conv.kernel)
            out = (out + self.conv.bias).to(dtype)
        else:
            grouped = ops.group_point(feat, idx)  # [B, N, K, C]
            g = matmul_f32(basis.to(dtype), self.taylor_weights.to(dtype))
            prod = grouped.to(dtype)[..., :, None] * g.to(dtype)[..., None, :]  # [B, N, K, C, T]
            out = self.conv(prod.reshape(b, n, -1))
        return torch.relu(self.GroupNorm_0(out))


def topk_pool(feat: torch.Tensor, k: int = 2) -> torch.Tensor:
    """The top ``k`` values of each channel over the points
    (tf_util.py:363-377): [B, N, C] -> [B, C, k], largest first.

    ``k`` rounds of ``torch.argmax`` (the first occurrence on ties) on a
    detached copy, each masking its pick with -inf, so a value that ties
    the maximum (relu zeros) is returned again; ``torch.gather`` then
    routes the gradient to the picked positions.  ``torch.topk`` is not
    used: its order among ties is not specified."""
    x = feat.transpose(1, 2)  # [B, C, N]
    xs = x.detach()
    picks = []
    for _ in range(k):
        am = torch.argmax(xs, dim=-1, keepdim=True)  # [B, C, 1]
        picks.append(am)
        xs = xs.scatter(-1, am, float("-inf"))
    return torch.gather(x, -1, torch.cat(picks, dim=-1))


class SpiderCNNCls(nn.Module):
    """SpiderCNN classifier (spidercnn_cls_xyz.py:20-70).  ``forward(points
    [B, N, 3])`` returns ``{"logits": [B, num_classes], "end_points": {}}``."""

    kind = "cls"
    FC_DIMS = (1024, 512)

    def __init__(
        self, num_classes: int = 15, nsample: int = 20, taylor_channels: int = 5, num_groups: int = 16,
        dropout_keep: float = 0.3, fused: bool = True, dtype: torch.dtype | None = None,
    ):
        super().__init__()
        self.nsample, self.dropout_keep = nsample, dropout_keep
        channels = 3
        for i, f in enumerate(SPIDER_WIDTHS):
            self.add_module(
                f"conv{i + 1}", SpiderConv(channels, f, nsample, taylor_channels, num_groups, fused, dtype)
            )
            channels = f
        channels = 2 * sum(SPIDER_WIDTHS)  # top-2 of the 480 concatenated channels
        for i, f in enumerate(self.FC_DIMS):
            self.add_module(f"fc{i + 1}", Dense(channels, f, dtype))
            self.add_module(f"bn{i + 1}", BatchNorm(f, dtype))
            channels = f
        self.fc3 = Dense(channels, num_classes, dtype)

    def forward(
        self, points: torch.Tensor, bn_momentum: float = 0.9, generator: torch.Generator | None = None
    ) -> dict:
        b = points.shape[0]
        # One kNN on xyz, self included, reused by every layer.
        grouped_xyz, idx = edge_gather_knn(points, points, self.nsample)
        basis = taylor_basis((grouped_xyz - points[:, :, None, :]).float())  # [B, N, K, 20]
        feats, x = [], points
        for i in range(len(SPIDER_WIDTHS)):
            x = getattr(self, f"conv{i + 1}")(x, idx, basis)
            feats.append(x)
        h = topk_pool(torch.cat(feats, dim=-1), k=2).reshape(b, -1)  # [B, 960]
        for i in range(len(self.FC_DIMS)):
            h = torch.relu(getattr(self, f"bn{i + 1}")(getattr(self, f"fc{i + 1}")(h), bn_momentum))
            h = dropout(h, self.dropout_keep, self.training, generator)
        return {"logits": self.fc3(h), "end_points": {}}

    @staticmethod
    def loss(outputs: dict, batch: dict) -> tuple[torch.Tensor, dict]:
        """Softmax cross-entropy: (loss, {"loss", "classify_loss"})."""
        loss = losses.softmax_cross_entropy(outputs["logits"], batch["labels"])
        return loss, {"loss": loss, "classify_loss": loss}
