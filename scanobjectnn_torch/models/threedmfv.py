"""3DmFV-Net (counterpart of ``scanobjectnn_tpu/models/threedmfv.py``): grid
GMM Fisher vectors and a 3D Inception CNN classifier.  References:
3DmFV-Net/models/3dmfv_net_cls.py:29-102 (the FV grid [B, r, r, r, 20] →
inception 64, 128, 256 → max-pool /2 → inception 256, 512 → max-pool /2 →
fc 1024, 256, 128 → classes, dropout keep 0.7) and its inception_module
(:86-102: 1³ conv n ‖ 3³ conv n/2 and 5³ conv n/2 on the 1³ output ‖ a 3³
average pool then a 1³ conv n, concatenated to 3n channels).

Layout.  Activations are channels last, [B, D, H, W, C], as in flax; each
convolution and pool takes the channels-first view of that memory
(``channels_last_3d``), so no copy is made.  Conv kernels keep flax's
``[kd, kh, kw, in, out]`` layout (``inceptionI.convJ.Conv_0.kernel``; the BN
beside it is ``BatchNorm_0``) and are permuted in ``forward``, as ``Dense``
keeps ``[in, out]``: ``convert.load_jax_variables`` stays a renaming.  The
init is Glorot-uniform over the receptive field (fan_in = in·k³, fan_out =
out·k³) and zero biases.  Padding is flax's "SAME": the convolutions pad
(k-1)/2 a side; the 3³ average pool pads with zeros and counts the padding
(flax's ``count_include_pad``); the 2³ max-pool pads an odd side with -inf
at its high end only (5 → 3 → 2).  ``fc1`` reads the channels-last flatten (d, h, w, c).

The f32 convolutions never run in TF32 and always take cuDNN's
deterministic algorithms: each call, forward and backward, holds
``torch.backends.cudnn.allow_tf32`` False and
``torch.backends.cudnn.deterministic`` True while it runs on the card and
puts the caller's values back (``_Conv3dExact``), whatever the global
flags; ``cudnn.benchmark`` is left as it is.  The average pool's backward
is the same pool applied to the incoming gradient (``_AvgPoolSame``: the
zero-padded stride-1 pool of an odd window is self-adjoint), so it sums
without atomics by construction, where PyTorch's backward is one that
``torch.use_deterministic_algorithms`` refuses on the card.  So two equal
training steps on the card give equal bits.

GMM: the static grid GMM (``nn.fisher.get_3d_grid_gmm``) lives in
non-persistent buffers (not in the ``state_dict``, as it is not in the JAX
tree); with ``learnable_gmm`` the parameters ``gmm_w_logits`` (softmax:
the weights), ``gmm_mu`` and ``gmm_sigma_raw`` (softplus: the stddevs)
start at log(w), the means and log(expm1(σ)).

In bf16 (``dtype=torch.bfloat16``, the JAX ``dtype``) the Fisher vector is
computed in f32 and the grid cast to bf16, as JAX does (``models/threedmfv.py``
there casts the grid to the compute dtype); each convolution takes bf16
operands and bias (flax's ``promote_dtype``) and returns bf16 from cuDNN's
deterministic algorithms in the same scope; the BatchNorms, the fc layers
and the logits are bf16 as ``nn.layers``' are.  The average pool sums its
window in f32 and rounds once (``_pool_same``), where JAX's ``nn.avg_pool``
on the XLA CPU adds the 27 bf16 values one at a time in bf16 and divides
in bf16 (``tests/test_torch_mixed_threedmfv_train.py`` pins both): the
f32 sum is the more exact of the two, as the EdgeConv VJPs' f32 sums are.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from scanobjectnn_torch.models import losses
from scanobjectnn_torch.models.pointnet2 import dropout
from scanobjectnn_torch.nn.fisher import FV_FEATURES, fisher_vector, get_3d_grid_gmm
from scanobjectnn_torch.nn.layers import BatchNorm, Dense

__all__ = ["ThreeDmFVNet"]

FC_DIMS = (1024, 256, 128)
INCEPTION_WIDTHS = (64, 128, 256, 256, 512)  # a max-pool after the third and the fifth


@contextmanager
def _cudnn_exact(on_card: bool):
    """cuDNN's ``allow_tf32`` False and ``deterministic`` True inside, the
    caller's values after, also when the body raises (nothing changes off
    the card)."""
    if not on_card:
        yield
        return
    cudnn = torch.backends.cudnn
    before = cudnn.allow_tf32, cudnn.deterministic
    cudnn.allow_tf32, cudnn.deterministic = False, True
    try:
        yield
    finally:
        cudnn.allow_tf32, cudnn.deterministic = before


class _Conv3dExact(torch.autograd.Function):
    """``F.conv3d(x, w, b, padding=p)`` (stride 1) whose forward and
    backward both run under ``_cudnn_exact``."""

    @staticmethod
    def forward(ctx, x, w, b, padding: int):
        ctx.save_for_backward(x, w)
        ctx.padding = padding
        with _cudnn_exact(x.is_cuda):
            return F.conv3d(x, w, b, padding=padding)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        p = ctx.padding
        with _cudnn_exact(x.is_cuda):
            dx, dw, db = torch.ops.aten.convolution_backward(
                dy, x, w, [w.shape[0]], [1, 1, 1], [p, p, p], [1, 1, 1], False, [0, 0, 0], 1,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], ctx.needs_input_grad[2]],
            )
        return dx, dw, db, None


def _channels_first(x: torch.Tensor) -> torch.Tensor:
    """[B, D, H, W, C] -> the [B, C, D, H, W] view of the same memory."""
    return x.permute(0, 4, 1, 2, 3)


def _channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1)


class _Conv(nn.Module):
    """flax ``nn.Conv(features, (k, k, k), padding="SAME", dtype=dtype)``:
    ``kernel`` [k, k, k, in, out], ``bias`` [out]."""

    def __init__(self, in_features: int, features: int, k: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(k, k, k, in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        k, _, _, fan_in, fan_out = self.kernel.shape
        field = k ** 3
        limit = math.sqrt(6.0 / (fan_in * field + fan_out * field))  # flax glorot_uniform
        with torch.no_grad():
            self.kernel.uniform_(-limit, limit, generator=generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Channels last in and out, in the compute dtype (else x's)."""
        dtype = self.dtype or x.dtype
        w = self.kernel.permute(4, 3, 0, 1, 2).to(dtype)
        y = _Conv3dExact.apply(_channels_first(x.to(dtype)), w, self.bias.to(dtype), self.kernel.shape[0] // 2)
        return _channels_last(y)


class _Conv3D(nn.Module):
    """Conv → BN → relu (3dmfv_net_cls.py's conv3d with bn), children
    ``Conv_0`` and ``BatchNorm_0`` as flax names them."""

    def __init__(self, in_features: int, features: int, k: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.Conv_0 = _Conv(in_features, features, k, dtype)
        self.BatchNorm_0 = BatchNorm(features, dtype)

    def forward(self, x: torch.Tensor, bn_momentum: float | None = None) -> torch.Tensor:
        return torch.relu(self.BatchNorm_0(self.Conv_0(x), bn_momentum))


class _Inception(nn.Module):
    """1³ ‖ 3³ (of the 1³) ‖ 5³ (of the 1³) ‖ avg-pool 3³ + 1³, concatenated:
    n + n/2 + n/2 + n = 3n channels."""

    def __init__(
        self, in_features: int, n: int, kernel_sizes: tuple[int, int] = (3, 5), dtype: torch.dtype | None = None
    ):
        super().__init__()
        k1, k2 = kernel_sizes
        self.pool_size = k1
        self.conv1 = _Conv3D(in_features, n, 1, dtype)
        self.conv2 = _Conv3D(n, n // 2, k1, dtype)
        self.conv3 = _Conv3D(n, n // 2, k2, dtype)
        self.conv4 = _Conv3D(in_features, n, 1, dtype)

    def forward(self, x: torch.Tensor, bn_momentum: float | None = None) -> torch.Tensor:
        one = self.conv1(x, bn_momentum)
        three = self.conv2(one, bn_momentum)
        five = self.conv3(one, bn_momentum)
        pooled = self.conv4(_avg_pool_same(x, self.pool_size), bn_momentum)
        return torch.cat([one, three, five, pooled], dim=-1)


def _pool_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """Channels first: the k³ average pool at stride 1 over x zero-padded by
    k // 2 a side, the padding counted in every window; each window summed
    and divided in f32 and rounded once to x's dtype (module doc)."""
    p = k // 2
    return F.avg_pool3d(F.pad(x.float(), (p, p) * 3), k, stride=1).to(x.dtype)


class _AvgPoolSame(torch.autograd.Function):
    """``_pool_same`` whose backward is ``_pool_same`` of the gradient: for
    an odd k, output cell i averages the input cells within k // 2 of i
    along each axis, so input cell j receives 1/k³ of the gradient of every
    output cell within k // 2 of j, which is the same pool.  No atomics."""

    @staticmethod
    def forward(ctx, x, k: int):
        ctx.k = k
        return _pool_same(x, k)

    @staticmethod
    def backward(ctx, dy):
        return _pool_same(dy, ctx.k), None


def _avg_pool_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """flax ``nn.avg_pool(x, (k, k, k), (1, 1, 1), "SAME")``, channels last,
    for an odd k: zero padding of (k-1)/2 a side, counted in every window's
    k³."""
    if k % 2 != 1:
        raise ValueError(f"_avg_pool_same takes an odd window, got {k}")
    return _channels_last(_AvgPoolSame.apply(_channels_first(x), k))


def _max_pool2(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.max_pool(x, (2, 2, 2), (2, 2, 2), "SAME")``, channels last:
    an odd side padded with -inf at its high end."""
    d, h, w = x.shape[1:4]
    padded = F.pad(_channels_first(x), (0, w % 2, 0, h % 2, 0, d % 2), value=float("-inf"))
    return _channels_last(F.max_pool3d(padded, 2, 2))


class ThreeDmFVNet(nn.Module):
    """3DmFV-Net classifier.  ``forward(points [B, N, 3])`` returns
    ``{"logits": [B, num_classes], "end_points": {}}``."""

    kind = "cls"

    def __init__(
        self,
        num_classes: int = 15,
        subdivisions: tuple[int, int, int] = (5, 5, 5),
        variance: float = 0.04,
        learnable_gmm: bool = False,
        dtype: torch.dtype | None = None,
    ):
        super().__init__()
        self.dtype = dtype
        self.subdivisions, self.learnable_gmm = tuple(subdivisions), learnable_gmm
        self.dropout_keep = 0.7
        self.gmm = get_3d_grid_gmm(self.subdivisions, variance)
        n_g = self.gmm.n_gaussians
        if learnable_gmm:
            self.gmm_w_logits = nn.Parameter(torch.empty(n_g))
            self.gmm_mu = nn.Parameter(torch.empty(n_g, 3))
            self.gmm_sigma_raw = nn.Parameter(torch.empty(n_g, 3))
        else:
            for name, arr in (("gmm_w", self.gmm.weights), ("gmm_mu", self.gmm.means),
                              ("gmm_sigma", self.gmm.stddevs)):
                self.register_buffer(name, torch.tensor(arr, dtype=torch.float32), persistent=False)
        channels = FV_FEATURES
        for i, n in enumerate(INCEPTION_WIDTHS):
            self.add_module(f"inception{i + 1}", _Inception(channels, n, dtype=dtype))
            channels = 3 * n
        channels *= int(np.prod([math.ceil(math.ceil(s / 2) / 2) for s in self.subdivisions]))  # two pools
        for i, f in enumerate(FC_DIMS):
            self.add_module(f"fc{i + 1}", Dense(channels, f, dtype))
            self.add_module(f"bn{i + 1}", BatchNorm(f, dtype))
            channels = f
        self.fc4 = Dense(channels, num_classes, dtype)
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """The learnable GMM's start (module doc); no draw."""
        if not self.learnable_gmm:
            return
        with torch.no_grad():
            self.gmm_w_logits.copy_(torch.log(torch.tensor(self.gmm.weights, dtype=torch.float32)))
            self.gmm_mu.copy_(torch.tensor(self.gmm.means, dtype=torch.float32))
            self.gmm_sigma_raw.copy_(torch.log(torch.expm1(torch.tensor(self.gmm.stddevs, dtype=torch.float32))))

    def gmm_params(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(weights [G], means [G, 3], stddevs [G, 3]) in f32."""
        if self.learnable_gmm:
            return torch.softmax(self.gmm_w_logits, dim=0), self.gmm_mu, F.softplus(self.gmm_sigma_raw)
        return self.gmm_w, self.gmm_mu, self.gmm_sigma

    def forward(
        self, points: torch.Tensor, bn_momentum: float = 0.9, generator: torch.Generator | None = None
    ) -> dict:
        b = points.shape[0]
        fv = fisher_vector(points, *self.gmm_params()).float()  # [B, 20, G]
        net = _channels_last(fv.reshape(b, FV_FEATURES, *self.subdivisions))  # [B, r, r, r, 20]
        net = net.to(self.dtype or torch.float32)
        for i in range(len(INCEPTION_WIDTHS)):
            net = getattr(self, f"inception{i + 1}")(net, bn_momentum)
            if i in (2, 4):
                net = _max_pool2(net)
        h = net.reshape(b, -1)  # channels-last flatten (d, h, w, c)
        for i in range(len(FC_DIMS)):
            h = torch.relu(getattr(self, f"bn{i + 1}")(getattr(self, f"fc{i + 1}")(h), bn_momentum))
            h = dropout(h, self.dropout_keep, self.training, generator)
        return {"logits": self.fc4(h), "end_points": {}}

    @staticmethod
    def loss(outputs: dict, batch: dict) -> tuple[torch.Tensor, dict]:
        """CE: (loss, {"loss", "classify_loss"})."""
        loss = losses.softmax_cross_entropy(outputs["logits"], batch["labels"])
        return loss, {"loss": loss, "classify_loss": loss}
