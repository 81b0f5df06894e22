"""3xTF32 arithmetic for the SpiderConv forward, emulated in plain PyTorch
on the CPU: the numbers behind the forward kernel's choice of f32 FMA sums
(``csrc/spider.cu``).

A 3xTF32 product splits each f32 operand x into hi = rna_tf32(x) and
lo = rna_tf32(x - hi) (``cvt.rna.tf32.f32``: round to nearest, ties away
from zero, to 10 mantissa bits) and adds a_lo·b_hi + a_hi·b_lo + a_hi·b_hi
in f32.  ``rna_tf32`` below does that rounding with bit masks; the three
partial products are three f32 matrix products, added small terms first.
Such a product holds the forward's per-call gate, where one-pass TF32 does
not; the kernel still sums in f32 with FMA, because the 3xTF32 last bits
moved the SpiderCNN training step beyond its gate on the card.  The kernel
itself is held to the plain version by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.

Tolerances, and why (readings on these seeds in brackets):
  * hi has no bits below the 10th of the mantissa, and hi + lo is x to
    2^-21 of |x| (each rounding keeps 11 bits: 2^-11 · 2^-11 of |x| is
    left);
  * the three-term product against a float64 product of the same f32 p and
    W: within ``SPIDER_FWD_TOL`` x max(1, |ref|max), the card's gate, and
    within 2x the plain f32 version's own error [0.84x at C=3, 1.0x at
    C=128];
  * one-pass TF32 (a_hi·b_hi alone) misses that gate [by 31x and 33x],
    which is why no forward of the port runs it;
  * a NaN p (a neighbour index outside [0, N), or a NaN feature) gives NaN
    in every column of its output row and nowhere else, as
    ``spider_conv_plain`` does for a NaN feature.
"""

import numpy as np
import pytest
import torch

from scanobjectnn_torch.ops.cuda.spider_kernel import spider_conv_plain

SPIDER_FWD_TOL = 1e-5  # x max(1, |ref|max), the forward's gate in chip_smoke.py and tests/test_torch_cuda.py

# (b, n, k, c, t, o): SpiderCNN's conv1 (C=3, R=300) and conv4 (C=128)
# widths at k=20, T=5, O=256, on small clouds.
CASES = {"c3": (2, 64, 20, 3, 5, 256), "c128": (2, 64, 20, 128, 5, 256)}


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to 10 mantissa bits, to nearest with ties away from zero
    (``cvt.rna.tf32.f32``); NaN stays NaN."""
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isnan(x), x, rounded)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = rna_tf32(x)
    return hi, rna_tf32(x - hi)


def taylor_product(feat, idx, g) -> torch.Tensor:
    """p [B*N, K*C*T] in (k, c, t) order, each feat·g rounded once in f32;
    NaN where the neighbour index lies outside [0, N), as the kernel forms
    it."""
    b, n, k = idx.shape
    c, t = feat.shape[-1], g.shape[-1]
    bad = (idx < 0) | (idx >= n)
    grouped = feat[torch.arange(b)[:, None, None], idx.long().clamp(0, n - 1)]
    grouped = torch.where(bad[..., None], torch.full_like(grouped, float("nan")), grouped)
    return (grouped[..., :, None] * g[..., None, :]).reshape(b * n, k * c * t)


def three_tf32(p: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The 3xTF32 product in plain PyTorch: both operands split, the three
    partial products in f32, small terms first."""
    p_hi, p_lo = split_tf32(p)
    w_hi, w_lo = split_tf32(w)
    return (p_lo @ w_hi + p_hi @ w_lo) + p_hi @ w_hi


def spider_inputs(case, seed):
    b, n, k, c, t, o = CASES[case]
    rng = np.random.RandomState(seed)
    feat = rng.randn(b, n, c).astype(np.float32)
    idx = rng.randint(0, n, (b, n, k)).astype(np.int32)
    idx[..., 0] = np.arange(n)
    g = rng.randn(b, n, k, t).astype(np.float32)
    kernel = (rng.randn(k * c * t, o) * np.sqrt(2.0 / (k * c * t + o))).astype(np.float32)
    return [torch.from_numpy(a) for a in (feat, idx, g, kernel)]


@pytest.mark.parametrize("seed", [0, 1])
def test_split_keeps_21_bits(seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((rng.randn(4096) * np.exp(rng.uniform(-20, 20, 4096))).astype(np.float32))
    hi, lo = split_tf32(x)
    for part in (hi, lo):
        assert not bool((part.view(torch.int32) & 0x1FFF).any()), "a TF32 value keeps bits below its 10th"
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0**-21 * x.double().abs()).all()), float((err / x.double().abs()).max())
    # Ties go away from zero, as cvt.rna does.
    tie = torch.tensor([1.0 + 2.0**-11, -(1.0 + 2.0**-11)], dtype=torch.float32)
    assert rna_tf32(tie).tolist() == [1.0 + 2.0**-10, -(1.0 + 2.0**-10)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_term_product_holds_the_f32_gate(case):
    feat, idx, g, kernel = spider_inputs(case, seed=len(case))
    b, n = idx.shape[:2]
    p = taylor_product(feat, idx, g)
    ref = (p.double() @ kernel.double()).reshape(b, n, -1)
    scale = max(1.0, float(ref.abs().max()))
    plain_err = float((spider_conv_plain(feat, idx, g, kernel).double() - ref).abs().max())
    got = three_tf32(p, kernel).reshape(b, n, -1)
    err = float((got.double() - ref).abs().max())
    one_pass = float(((rna_tf32(p) @ rna_tf32(kernel)).reshape(b, n, -1).double() - ref).abs().max())
    print(f"{case}: 3xTF32 {err:.3e}, plain f32 {plain_err:.3e}, one-pass TF32 {one_pass:.3e}, scale {scale:.3f}")
    assert err <= SPIDER_FWD_TOL * scale, (err, scale)
    assert err <= 2.0 * plain_err, (err, plain_err)
    assert one_pass > SPIDER_FWD_TOL * scale, "one-pass TF32 would hold the gate: the test lost its point"


@pytest.mark.parametrize("how", ["bad_index", "nan_feature"])
def test_nan_product_gives_nan_rows(how):
    feat, idx, g, kernel = spider_inputs("c3", seed=5)
    b, n, k = idx.shape
    if how == "bad_index":
        idx[0, 7, 3], idx[1, 20, 0] = -1, n
    else:  # NaN features at points that only rows 7 (cloud 0) and 20 (cloud 1) reach
        feat[0, 9, 1], feat[1, 40, 2] = float("nan"), float("nan")
        idx[0][idx[0] == 9] = 0
        idx[1][idx[1] == 40] = 0
        idx[0, 7, 3], idx[1, 20, 0] = 9, 40
    bad_rows = torch.zeros(b, n, dtype=torch.bool)
    bad_rows[0, 7] = bad_rows[1, 20] = True
    got = three_tf32(taylor_product(feat, idx, g), kernel).reshape(b, n, -1)
    assert bool(torch.isnan(got[bad_rows]).all()) and bool(torch.isfinite(got[~bad_rows]).all())
    if how == "nan_feature":
        plain = spider_conv_plain(feat, idx, g, kernel)
        assert torch.equal(torch.isnan(plain), torch.isnan(got))
