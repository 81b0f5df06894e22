"""Dynamic Graph CNN and its BGA variant (counterpart of
``scanobjectnn_tpu/models/dgcnn.py``).  References: dgcnn/models/dgcnn.py:24-111
(EdgeConv trunk 64, 64, 64, 128 → 1024 agg → FC head, label-smoothed CE
0.2), dgcnn/models/dgcnn_bga.py:27-153 (the class vector, the global max
and the per-layer features concatenated into the seg branch) and
dgcnn/models/transform_nets.py:10-55 (the edge-feature input transform).

Every layer recomputes a kNN graph in feature space, self edge included
(``ops.knn_graph``), and an edge feature is concat(x_i, x_j − x_i).

The fused EdgeConv (the default) never builds the [B, N, k, 2C] edge
tensors.  Its Dense on an edge is ``e_ij = a_i + c2_j`` with ``c1 =
dense(x‖0)``, ``c2 = dense(0‖x)`` and ``a = c1 − c2`` (both carry the bias,
so ``a`` does not); bn∘relu is monotone per channel, increasing where γ ≥ 0,
so max_j relu(bn(e_ij)) = relu(bn(a_i + M_i)) with M the neighbour max of
``c2`` where γ ≥ 0 and the min elsewhere.  ``_PairBN`` reconstructs the
batch statistics of all B·N·k edges from the neighbour sums ``s`` and
``q2``: Σe = k·Σa + Σs and Σe² = Σ(k·a² + 2·a·s + q2).
``ops/cuda/edge_kernel.edge_reduce`` computes the graph and the reductions
(on the card: the kNN graph kernel, then the reduce kernel; its backward is
a kernel too).  ``EdgeConv(fused=False)`` is the direct dataflow (edge
tensor → Dense → BN → relu → max over k), kept as the port's own oracle;
both share one parameter tree.  The T-Net's first layer takes the same A+B
form and gathers ``c2``'s neighbour rows (``edge_gather_knn``); its second
layer needs per-edge inputs.

Parameter and buffer names follow the JAX tree
(``trunk.edgeconv1.mlp.dense_0.kernel``, ``trunk.tnet.mlp1.bn_0.mean``,
``trunk.tnet.transform.kernel``, ...), so ``convert.load_jax_variables``
loads a JAX ``variables`` tree unchanged.
"""

from __future__ import annotations

import torch
from torch import nn

from scanobjectnn_torch import ops
from scanobjectnn_torch.models import losses
from scanobjectnn_torch.models.pointnet2 import dropout
from scanobjectnn_torch.nn.layers import MLP, BatchNorm, Dense
from scanobjectnn_torch.ops.cuda.edge_kernel import edge_gather_knn, edge_reduce

__all__ = ["DGCNN", "DGCNNBGA", "EdgeConv", "EdgeTransformNet", "edge_feature"]

EDGE_WIDTHS = (64, 64, 64, 128)  # EdgeConv 1-4
AGG_WIDTH = 1024


def edge_feature(x: torch.Tensor, k: int) -> torch.Tensor:
    """EdgeConv input: [B, N, C] -> [B, N, k, 2C] of concat(x_i, x_j - x_i)
    over the feature-space kNN graph (self included)."""
    idx = ops.knn_graph(x, k)
    neighbors = ops.group_point(x, idx)  # [B, N, k, C]
    central = x[:, :, None, :].expand_as(neighbors)
    return torch.cat([central, neighbors - central], dim=-1)


def _split_dense(dense: Dense, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(a, c2) of the A+B form: c1 = dense(x‖0), c2 = dense(0‖x), a = c1 − c2."""
    zeros = torch.zeros_like(x)
    c1 = dense(torch.cat([x, zeros], dim=-1))
    c2 = dense(torch.cat([zeros, x], dim=-1))
    return c1 - c2, c2


class _PairBN(BatchNorm):
    """A ``BatchNorm`` (same parameters and buffers) that can also normalise
    the never-built edge population from neighbour reductions (``pair``).
    Its ``forward`` is the plain BatchNorm, which the unfused EdgeConv uses."""

    def pair(self, a: torch.Tensor, red: dict, k: int, bn_momentum: float | None = None) -> torch.Tensor:
        """bn of the max-selected edge pre-activation ``a + M`` (module
        doc); in training the statistics are those of all B·N·k edges,
        ``count = B·N·k`` and ``var = max(E[e²] − E[e]², 0)``.  Under a
        group (``configure_parallel``) E[e] and E[e²] are averaged over it
        before the variance; the count stays this rank's, since the mean of
        equal shards' means is the global mean."""
        af = a.float()
        if self.training:
            if bn_momentum is None:
                raise ValueError("training-mode BatchNorm needs the call-time bn_momentum")
            count = af.shape[0] * af.shape[1] * k
            mean = (k * af.sum(dim=(0, 1)) + red["s"].sum(dim=(0, 1))) / count
            mean2 = (k * torch.square(af) + 2.0 * af * red["s"] + red["q2"]).sum(dim=(0, 1)) / count
            mean, mean2 = self.global_moments(mean, mean2)
            var = torch.clamp(mean2 - torch.square(mean), min=0.0)
            self.update_running(mean, var, bn_momentum)
        else:
            mean, var = self.mean, self.var
        m_sel = torch.where(self.scale >= 0, red["mmax"], red["mmin"])
        y = (af + m_sel - mean) * torch.rsqrt(var + self.epsilon)
        y = y * self.scale + self.bias
        return y.to(self.dtype or a.dtype)


class _FusedEdgeMLP(MLP):
    """``MLP((features,))`` on the 2C-wide edge features, whose ``fused``
    computes Dense → BN → relu → max over k without building them."""

    def __init__(self, in_features: int, features: int, k: int, dtype: torch.dtype | None = None):
        super().__init__(2 * in_features, (features,), dtype)
        self.bn_0 = _PairBN(features, dtype)
        self.k = k

    def fused(self, x: torch.Tensor, bn_momentum: float | None = None) -> torch.Tensor:
        a, c2 = _split_dense(self.dense_0, x)
        red = edge_reduce(x, c2, self.k)
        return torch.relu(self.bn_0.pair(a, red, self.k, bn_momentum))


class EdgeConv(nn.Module):
    """One EdgeConv block: edge features → Dense + BN + relu → max over k,
    [B, N, C] -> [B, N, features].  ``fused`` (default) takes the A+B form;
    ``fused=False`` builds the edge tensor (module doc)."""

    def __init__(
        self, in_features: int, features: int, k: int = 20, fused: bool = True, dtype: torch.dtype | None = None
    ):
        super().__init__()
        self.k, self.fused = k, fused
        self.mlp = _FusedEdgeMLP(in_features, features, k, dtype)

    def forward(self, x: torch.Tensor, bn_momentum: float | None = None) -> torch.Tensor:
        if self.fused:
            return self.mlp.fused(x, bn_momentum)
        return torch.amax(self.mlp(edge_feature(x, self.k), bn_momentum), dim=2)


class _TnetEdgeMLP(MLP):
    """The T-Net's per-edge ``MLP((64, 128))`` on [B, N, k, 6] edge
    features; ``fused`` takes its first Dense in A+B form and gathers
    ``c2``'s neighbour rows instead of the edge tensor."""

    def __init__(self, k: int, dtype: torch.dtype | None = None):
        super().__init__(6, (64, 128), dtype)
        self.k = k

    def fused(self, points: torch.Tensor, bn_momentum: float | None = None) -> torch.Tensor:
        a, c2 = _split_dense(self.dense_0, points)
        bj, _ = edge_gather_knn(points, c2, self.k)  # [B, N, k, 64], c2's dtype
        e1 = torch.relu(self.bn_0(a[:, :, None, :] + bj, bn_momentum))
        return self.layer(1, e1, bn_momentum)


class EdgeTransformNet(nn.Module):
    """DGCNN's input transform on edge features (transform_nets.py:10-55):
    conv 64, 128 → max over k → conv 1024 → max over N → fc 512, 256 → 3x3,
    starting at the identity (``transform`` is zero-initialised)."""

    def __init__(self, k: int = 20, fused: bool = True, dtype: torch.dtype | None = None):
        super().__init__()
        self.k, self.fused = k, fused
        self.mlp1 = _TnetEdgeMLP(k, dtype)
        self.mlp2 = MLP(128, (1024,), dtype)
        self.fc = MLP(1024, (512, 256), dtype)
        self.transform = Dense(256, 9, dtype, zero_init=True)

    def forward(self, points: torch.Tensor, bn_momentum: float | None = None) -> torch.Tensor:
        if self.fused:
            e = self.mlp1.fused(points, bn_momentum)
        else:
            e = self.mlp1(edge_feature(points, self.k), bn_momentum)
        e = torch.amax(e, dim=2)  # [B, N, 128]
        h = torch.amax(self.mlp2(e, bn_momentum), dim=1)  # [B, 1024]
        out = self.transform(self.fc(h, bn_momentum))
        eye = torch.eye(3, dtype=out.dtype, device=out.device).flatten()
        return (out + eye).reshape(points.shape[0], 3, 3)


class _DGCNNTrunk(nn.Module):
    """Shared trunk: transform → EdgeConv 64, 64, 64, 128 → concat → Dense
    1024.  Returns (agg [B, N, 1024], [net1, ..., net4])."""

    def __init__(self, k: int = 20, dtype: torch.dtype | None = None):
        super().__init__()
        self.tnet = EdgeTransformNet(k, dtype=dtype)
        channels = 3
        for i, f in enumerate(EDGE_WIDTHS):
            self.add_module(f"edgeconv{i + 1}", EdgeConv(channels, f, k, dtype=dtype))
            channels = f
        self.agg = MLP(sum(EDGE_WIDTHS), (AGG_WIDTH,), dtype)

    def forward(self, points: torch.Tensor, bn_momentum: float | None = None):
        t = self.tnet(points, bn_momentum)
        # f32 points against t in the compute dtype, promoted to f32, as the
        # JAX einsum; TF32 is off for f32 matmuls on the card.
        x = torch.matmul(points.float(), t.float())
        feats = []
        for i in range(len(EDGE_WIDTHS)):
            x = getattr(self, f"edgeconv{i + 1}")(x, bn_momentum)
            feats.append(x)
        return self.agg(torch.cat(feats, dim=-1), bn_momentum), feats


class DGCNN(nn.Module):
    """DGCNN classifier (dgcnn.py:24-104): the trunk → max over N → fc1 512
    → fc2 256 (each BN, relu, dropout keep 0.5) → fc3.  ``forward(points [B,
    N, 3])`` returns ``{"logits": [B, num_classes], "end_points": {}}``."""

    kind = "cls"
    FC_DIMS = (512, 256)

    def __init__(self, num_classes: int = 15, k: int = 20, dtype: torch.dtype | None = None):
        super().__init__()
        self.dropout_keep = 0.5
        self.trunk = _DGCNNTrunk(k, dtype)
        channels = AGG_WIDTH
        for i, f in enumerate(self.FC_DIMS):
            self.add_module(f"fc{i + 1}", Dense(channels, f, dtype))
            self.add_module(f"bn{i + 1}", BatchNorm(f, dtype))
            channels = f
        self.fc3 = Dense(channels, num_classes, dtype)

    def forward(
        self, points: torch.Tensor, bn_momentum: float = 0.9, generator: torch.Generator | None = None
    ) -> dict:
        agg, _ = self.trunk(points, bn_momentum)
        h = torch.amax(agg, dim=1)  # [B, 1024]
        for i in range(len(self.FC_DIMS)):
            h = torch.relu(getattr(self, f"bn{i + 1}")(getattr(self, f"fc{i + 1}")(h), bn_momentum))
            h = dropout(h, self.dropout_keep, self.training, generator)
        return {"logits": self.fc3(h), "end_points": {}}

    @staticmethod
    def loss(outputs: dict, batch: dict, smoothing: float = 0.2) -> tuple[torch.Tensor, dict]:
        """Label-smoothed CE: (loss, {"loss", "classify_loss"})."""
        loss = losses.label_smoothed_cross_entropy(outputs["logits"], batch["labels"], smoothing)
        return loss, {"loss": loss, "classify_loss": loss}


class DGCNNBGA(nn.Module):
    """BGA DGCNN (dgcnn_bga.py:27-139): the class branch (fc1 512, fc2 256,
    fc3) gives a 256-d class vector (after bn2/relu, before the second
    dropout); the seg branch takes concat(class vector, global max of agg,
    net1..net4) per point → 512, 256 → dropout keep 0.7 → 2-way mask.
    ``forward`` returns ``{"logits", "seg_logits", "end_points"}``."""

    kind = "seg"
    FC_DIMS = (512, 256)
    SEG_DIMS = (512, 256)

    def __init__(self, num_classes: int = 15, seg_classes: int = 2, k: int = 20, dtype: torch.dtype | None = None):
        super().__init__()
        self.dropout_keep, self.seg_dropout_keep = 0.5, 0.7
        self.trunk = _DGCNNTrunk(k, dtype)
        channels = AGG_WIDTH
        for i, f in enumerate(self.FC_DIMS):
            self.add_module(f"fc{i + 1}", Dense(channels, f, dtype))
            self.add_module(f"bn{i + 1}", BatchNorm(f, dtype))
            channels = f
        self.fc3 = Dense(channels, num_classes, dtype)
        self.seg_mlp = MLP(channels + AGG_WIDTH + sum(EDGE_WIDTHS), self.SEG_DIMS, dtype)
        self.seg_out = Dense(self.SEG_DIMS[-1], seg_classes, dtype)

    def forward(
        self, points: torch.Tensor, bn_momentum: float = 0.9, generator: torch.Generator | None = None
    ) -> dict:
        b, n, _ = points.shape
        agg, feats = self.trunk(points, bn_momentum)
        global_max = torch.amax(agg, dim=1)  # [B, 1024]
        h = torch.relu(self.bn1(self.fc1(global_max), bn_momentum))
        h = dropout(h, self.dropout_keep, self.training, generator)
        class_vector = torch.relu(self.bn2(self.fc2(h), bn_momentum))  # [B, 256]
        h = dropout(class_vector, self.dropout_keep, self.training, generator)
        logits = self.fc3(h)
        seg = torch.cat(
            [class_vector[:, None, :].expand(b, n, -1), global_max[:, None, :].expand(b, n, -1), *feats], dim=-1
        )
        seg = dropout(self.seg_mlp(seg, bn_momentum), self.seg_dropout_keep, self.training, generator)
        return {"logits": logits, "seg_logits": self.seg_out(seg), "end_points": {}}

    @staticmethod
    def loss(outputs: dict, batch: dict, seg_weight: float = 0.5) -> tuple[torch.Tensor, dict]:
        """(1 - w)·CE_cls + w·CE_seg, no smoothing: (loss, {"loss",
        "classify_loss", "seg_loss"})."""
        total, classify, seg = losses.joint_cls_seg_loss(
            outputs["logits"], outputs["seg_logits"], batch["labels"], batch["masks"], seg_weight
        )
        return total, {"loss": total, "classify_loss": classify, "seg_loss": seg}
