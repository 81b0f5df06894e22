"""SpiderConv's contraction: the CUDA kernels (``csrc/spider.cu``) beside
their plain PyTorch version.

Replaces ``scanobjectnn_tpu/ops/pallas/spider_kernel.py``:
``spider_conv_pallas`` (forward ``_mix_kernel``, backward ``_dmix_kernel``
and ``_dw_kernel``, ``pl.pallas_call``), which every fused SpiderConv layer
of ``spidercnn_cls_xyz`` runs, in inference and in training.

Semantics: ``spider_conv(feat [B, N, C], idx [B, N, K] int, g [B, N, K, T],
kernel [K·C·T, O]) -> [B, N, O]`` f32 with

    out[b, n, o] = sum over k, c, t of
                   feat[b, idx[b, n, k], c] · g[b, n, k, t] · kernel[(k·C + c)·T + t, o],

differentiable in ``feat``, ``g`` and ``kernel`` (``idx`` gets no
gradient, as in the reference's grouping ops).  The row order of
``kernel`` is (k, c, t), the Dense layout of ``models/spidercnn.py``.

Precision: f32 throughout, each product ``feat · g`` rounded once, then
summed against ``kernel`` with FMA in ascending (k, c, t) order.  That is
the JAX lax path on the CPU (``spider_conv_lax``), the port's parity
reference; the TPU kernel rounds its operands to bf16 for the MXU
(``ROADMAP.md``, known quirks).  One-pass TF32 is never used.  A 3xTF32
forward on the tensor cores (each operand split into two TF32 terms, three
products) kept f32's accuracy per call but not the FMA order's bits, and
those last bits moved the SpiderCNN training step beyond its gate
(``csrc/spider.cu``), so the forward sums on the CUDA cores.

On the card the forward is ``spider_conv_fwd_kernel`` (the kernel packs
``kernel`` into a scratch buffer that the wrapper allocates, slot by slot
in tiles of columns, then stages the Taylor product chunk by chunk with a
``cp.async`` ring); the backward
(``spider_conv_bwd_kernel``) is the data backward (``spider_bwd_data``:
the gathered-row gradient [B, N, K, C] and ``dg``; it transposes ``dout``
and packs ``kernel``'s chunk slabs into a scratch buffer, then stages both
with a ``cp.async`` ring), the deterministic scatter-add #7
(``scatter_add_rows``) of the gathered-row gradient into ``dfeat``, and
the weight backward (``spider_bwd_weight``: the Taylor product formed a
stage of rows at a time from staged neighbour and basis values), whose
rows are split into a fixed number of slices summed in order: two calls
give the same bits.  The backward reads the gathered rows from ``feat``
again where the TPU saved them.

What bounds it on the H100: operations, 2·B·N·(K·C·T)·O flops for the
forward and for each half of the backward (282 GFLOP a forward of the four
layers at B=32, N=1024, k=20, T=5: 4.2 ms at 67 TFLOP/s in f32, 1.7 ms as
three TF32 products at 495).  The plain version materialises the
[B, N, K·C·T] outer product (1.68 GB in f32 at the last layer) and
multiplies it with ``matmul_f32``; autograd gives its backward.
"""

from __future__ import annotations

import torch

from scanobjectnn_torch.nn.layers import matmul_f32
from scanobjectnn_torch.ops.cuda import _build, takes_plain
from scanobjectnn_torch.ops.cuda.gather_kernel import _check_cuda, gather_rows_plain, scatter_add_rows

__all__ = [
    "MAX_T",
    "spider_bwd_data",
    "spider_bwd_weight",
    "spider_conv",
    "spider_conv_bwd_kernel",
    "spider_conv_fwd_kernel",
    "spider_conv_plain",
]

MAX_T = 64  # kMaxT in csrc/spider.cu


def spider_conv_plain(feat: torch.Tensor, idx: torch.Tensor, g: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``spider_conv`` (module doc): an indexing gather, the
    outer product in (k, c, t) order, and ``matmul_f32``; autograd gives
    its backward."""
    b, n, k = idx.shape
    c, t = feat.shape[-1], g.shape[-1]
    grouped = gather_rows_plain(feat.float(), idx.reshape(b, n * k)).reshape(b, n, k, c)
    prod = grouped[..., :, None] * g.float()[..., None, :]  # [B, N, K, C, T]
    return matmul_f32(prod.reshape(b, n, k * c * t), kernel)


def _shapes(fn: str, feat, idx, g, kernel) -> tuple[int, ...]:
    """(b, n, k, c, t, o) after checking the four inputs of a kernel."""
    if feat.device.type != "cuda" or feat.dim() != 3 or idx.dim() != 3 or g.dim() != 4 or kernel.dim() != 2:
        raise ValueError(
            f"{fn}: need CUDA feat [B, N, C], idx [B, N, K], g [B, N, K, T] and kernel [K*C*T, O], got "
            f"{tuple(feat.shape)}, {tuple(idx.shape)}, {tuple(g.shape)}, {tuple(kernel.shape)} on {feat.device}"
        )
    b, n, c = feat.shape
    k, t, o = idx.shape[-1], g.shape[-1], kernel.shape[-1]
    _check_cuda(fn, "feat", feat, torch.float32, (b, n, c), feat.device)
    _check_cuda(fn, "idx", idx, torch.int32, (b, n, k), feat.device)
    _check_cuda(fn, "g", g, torch.float32, (b, n, k, t), feat.device)
    _check_cuda(fn, "kernel", kernel, torch.float32, (k * c * t, o), feat.device)
    if min(b, n, c, k, t, o) < 1 or t > MAX_T:
        raise ValueError(f"{fn}: need non-empty inputs and T <= {MAX_T}, got B={b} N={n} C={c} K={k} T={t} O={o}")
    if b * n >= 2**31 or k * c * t >= 2**31:
        raise ValueError(f"{fn}: B*N and K*C*T must each be below 2^31")
    return b, n, k, c, t, o


def spider_conv_fwd_kernel(feat: torch.Tensor, idx: torch.Tensor, g: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """The forward on the card: feat [B, N, C] f32, idx [B, N, K] int32 in
    [0, N), g [B, N, K, T] f32, kernel [K*C*T, O] f32, all contiguous ->
    out [B, N, O] f32.  Packs ``kernel`` into a scratch buffer and runs the
    product (counted in ``spider_conv_fwd_kernel.launches``), or raises."""
    fn = "spider_conv_fwd_kernel"
    b, n, k, c, t, o = _shapes(fn, feat, idx, g, kernel)
    out = torch.empty(b, n, o, dtype=torch.float32, device=feat.device)
    lib = _build.library()
    scratch = torch.empty(lib.spider_fwd_scratch(k, c, t, o), dtype=torch.float32, device=feat.device)
    with torch.cuda.device(feat.device):
        err = lib.spider_fwd_launch(
            feat.data_ptr(), idx.data_ptr(), g.data_ptr(), kernel.data_ptr(), b, n, k, c, t, o,
            scratch.data_ptr(), out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, fn)
    spider_conv_fwd_kernel.launches += 1
    return out


def spider_bwd_data(
    feat: torch.Tensor, idx: torch.Tensor, g: torch.Tensor, kernel: torch.Tensor, dout: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The data backward's kernels on the card (``spider_conv_bwd_kernel``'s
    first half, uncounted): -> (dgath [B, N, K, C], dg [B, N, K, T]) f32."""
    fn = "spider_conv_bwd_kernel"
    b, n, k, c, t, o = _shapes(fn, feat, idx, g, kernel)
    _check_cuda(fn, "dout", dout, torch.float32, (b, n, o), feat.device)
    dev = feat.device
    dgath = torch.empty(b, n, k, c, dtype=torch.float32, device=dev)
    dg = torch.empty(b, n, k, t, dtype=torch.float32, device=dev)
    lib = _build.library()
    scratch = torch.empty(lib.spider_bwd_data_scratch(b, n, k, c, t, o), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.spider_bwd_data_launch(
            feat.data_ptr(), idx.data_ptr(), g.data_ptr(), kernel.data_ptr(), dout.data_ptr(), b, n, k, c, t, o,
            scratch.data_ptr(), dgath.data_ptr(), dg.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, fn)
    return dgath, dg


def spider_bwd_weight(
    feat: torch.Tensor, idx: torch.Tensor, g: torch.Tensor, kernel: torch.Tensor, dout: torch.Tensor
) -> torch.Tensor:
    """The weight backward's kernels on the card (``spider_conv_bwd_kernel``'s
    second half, uncounted): -> dkernel [K*C*T, O] f32."""
    fn = "spider_conv_bwd_kernel"
    b, n, k, c, t, o = _shapes(fn, feat, idx, g, kernel)
    _check_cuda(fn, "dout", dout, torch.float32, (b, n, o), feat.device)
    dev = feat.device
    dkernel = torch.empty(k * c * t, o, dtype=torch.float32, device=dev)
    lib = _build.library()
    slices = lib.spider_bwd_weight_slices(b * n, k, c, t, o)
    part = torch.empty(slices, k * c * t, o, dtype=torch.float32, device=dev) if slices > 1 else dkernel
    with torch.cuda.device(dev):
        err = lib.spider_bwd_weight_launch(
            feat.data_ptr(), idx.data_ptr(), g.data_ptr(), dout.data_ptr(), b, n, k, c, t, o, slices,
            part.data_ptr(), dkernel.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, fn)
    return dkernel


def spider_conv_bwd_kernel(
    feat: torch.Tensor, idx: torch.Tensor, g: torch.Tensor, kernel: torch.Tensor, dout: torch.Tensor,
    need_feat: bool = True,
) -> tuple[torch.Tensor | None, torch.Tensor, torch.Tensor]:
    """The backward on the card: the forward's inputs and dout [B, N, O] f32
    -> (dfeat [B, N, C] or None when not ``need_feat``, dg [B, N, K, T],
    dkernel [K*C*T, O]), f32.  Launches the data and weight backward kernels
    (counted together in ``spider_conv_bwd_kernel.launches``) and the
    scatter-add (``scatter_add_rows.launches``), or raises."""
    dgath, dg = spider_bwd_data(feat, idx, g, kernel, dout)
    dkernel = spider_bwd_weight(feat, idx, g, kernel, dout)
    spider_conv_bwd_kernel.launches += 1
    b, n, k = idx.shape
    dfeat = scatter_add_rows(idx.reshape(b, n * k), dgath.reshape(b, n * k, feat.shape[-1]), n) if need_feat else None
    return dfeat, dg, dkernel


spider_conv_fwd_kernel.launches = 0
spider_conv_bwd_kernel.launches = 0


class _SpiderConv(torch.autograd.Function):
    """Counterpart of ``spider_conv_pallas`` and its custom VJP: the forward
    kernel; the backward kernels for feat, g and kernel (none for idx)."""

    @staticmethod
    def forward(ctx, feat: torch.Tensor, idx: torch.Tensor, g: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(feat, idx, g, kernel)
        return spider_conv_fwd_kernel(feat, idx, g, kernel)

    @staticmethod
    def backward(ctx, dout: torch.Tensor):
        feat, idx, g, kernel = ctx.saved_tensors
        dfeat, dg, dkernel = spider_conv_bwd_kernel(
            feat, idx, g, kernel, dout.float().contiguous(), need_feat=ctx.needs_input_grad[0]
        )
        return dfeat, None, dg, dkernel


def spider_conv(feat: torch.Tensor, idx: torch.Tensor, g: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """SpiderConv's contraction (module doc), [B, N, O] f32.

    A CPU tensor takes ``spider_conv_plain``; a CUDA tensor launches the
    kernels (forward, and backward through autograd), or raises."""
    if takes_plain(feat):
        return spider_conv_plain(feat, idx, g, kernel)
    return _SpiderConv.apply(
        feat.float().contiguous(), idx.to(torch.int32).contiguous(), g.float().contiguous(),
        kernel.float().contiguous(),
    )
