"""PyTorch port, SpiderCNN's layers on the CPU against the JAX package:
the SpiderConv contraction (``spider_conv_plain``, the plain version of
``csrc/spider.cu``) against ``spider_conv_lax``, forward and VJP; the
Taylor basis; ``GroupNorm`` against ``flax.linen.GroupNorm``; and
``topk_pool`` against the JAX ``topk_pool``.

Tolerances, and why (readings on these seeds in brackets):
  * the contraction, against ``spider_conv_lax``: both form the same f32
    products feat·g and sum them against the kernel in their own order;
    within ``FWD_TOL`` x max(1, |ref|max) [at most 7.1e-7], and against a
    float64 einsum over ``kernel`` reshaped to (K, C, T, O), which pins the
    (k, c, t) row order independently of JAX, within the same bound;
  * its VJP in feat, g and kernel: the same products summed in other orders
    (the feat gradient through another scatter): within ``VJP_TOL`` x
    max(1, |ref|max) per tensor [at most 3.7e-7];
  * the Taylor basis: equal (the same products in the same order);
  * GroupNorm in f32: the group means are sums over N·C/G values in another
    order; within ``GN_TOL`` x max(1, |ref|max) [2.5e-7].  With a common
    mode (inputs 30 + N(0, s²), s from 1 to 4.9) the fast variance
    E[x²] - E[x]² cancels about 900 against s²: each side's mean of the
    1024 squares of a group rounds by up to about log2(1024) x 2^-24 x 900
    = 5.4e-4, which moves y by up to half that relative to a unit variance:
    within ``GN_COMMON_TOL`` [8.1e-5].  In bf16 the output is the f32
    result rounded once: at most one bf16 ulp of max(1, |ref|max) apart, on
    at most ``BF16_DIFFERING`` of the elements [0]; with the common mode the
    f32 results lie up to 8.1e-5 apart, so an element within that of a bf16
    rounding boundary (spacing 2^-8 relative) may round the other way, on
    up to 2 x 8.1e-5 / 2^-8 = 4% of them: ``BF16_COMMON_DIFFERING`` [0.43%].
    Where the fast variance loses every bit (a common mode of 300), the port
    still equals flax bit for bit, and torch's two-pass GroupNorm does not;
  * ``topk_pool``: values and gradients equal (the same picks, ties to the
    first occurrence).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanobjectnn_tpu.models import spidercnn as jspider
from scanobjectnn_tpu.ops.pallas import spider_kernel as jsk
from scanobjectnn_torch.models.spidercnn import taylor_basis, topk_pool
from scanobjectnn_torch.nn.layers import GroupNorm
from scanobjectnn_torch.ops.cuda.spider_kernel import spider_conv, spider_conv_plain

FWD_TOL, VJP_TOL = 2e-6, 2e-6  # module doc
GN_TOL, GN_COMMON_TOL, BF16_DIFFERING, BF16_COMMON_DIFFERING = 2e-6, 3e-4, 1e-3, 5e-2

# (b, n, k, c, t, o): conv1 (3 -> 32), conv2 (32 -> 64) at k=8, conv3 (64 ->
# 128) at k=20, conv4's widths (128 -> 256) at k=8, and a ragged one.
CASES = {
    "conv1_k8": (2, 64, 8, 3, 5, 32),
    "conv2_k8": (2, 64, 8, 32, 5, 64),
    "conv3_k20": (2, 64, 20, 64, 5, 128),
    "conv4_k8": (2, 32, 8, 128, 5, 256),
    "ragged": (3, 17, 5, 7, 3, 11),
}


def spider_inputs(case, seed=0):
    """numpy (feat, idx, g, kernel) of one case: random neighbours (repeats
    included), Taylor responses and a Glorot-scaled kernel."""
    b, n, k, c, t, o = CASES[case]
    rng = np.random.RandomState(seed)
    feat = rng.randn(b, n, c).astype(np.float32)
    idx = rng.randint(0, n, (b, n, k)).astype(np.int32)
    g = rng.randn(b, n, k, t).astype(np.float32)
    kernel = (rng.randn(k * c * t, o) * np.sqrt(2.0 / (k * c * t + o))).astype(np.float32)
    return feat, idx, g, kernel


def _assert_scaled(got, want, tol, what):
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())
    print(f"{what}: max err / scale {err / scale:.3e}")
    assert err <= tol * scale, f"{what}: {err} > {tol * scale}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_spider_conv_plain_matches_lax_and_float64(case):
    feat, idx, g, kernel = spider_inputs(case)
    b, n, k, c, t, o = CASES[case]
    got = spider_conv_plain(*(torch.from_numpy(a) for a in (feat, idx, g, kernel)))
    assert got.dtype == torch.float32 and got.shape == (b, n, o)
    ref = jsk.spider_conv_lax(*(jnp.asarray(a) for a in (feat, idx, g, kernel)))
    _assert_scaled(got.numpy(), np.asarray(ref), FWD_TOL, f"{case} forward vs lax")
    grouped = feat.astype(np.float64)[np.arange(b)[:, None, None], idx]  # [B, N, K, C]
    want = np.einsum("bnkc,bnkt,kcto->bno", grouped, g.astype(np.float64), kernel.astype(np.float64).reshape(k, c, t, o))
    _assert_scaled(got.numpy(), want, FWD_TOL, f"{case} forward vs float64 (k, c, t) order")


@pytest.mark.parametrize("case", sorted(CASES))
def test_spider_conv_vjp_matches_lax(case):
    feat, idx, g, kernel = spider_inputs(case, seed=1)
    cot = np.random.RandomState(2).randn(*CASES[case][:2], CASES[case][-1]).astype(np.float32)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (feat, g, kernel)]
    out = spider_conv(leaves[0], torch.from_numpy(idx), leaves[1], leaves[2])  # CPU: the plain version
    got = torch.autograd.grad(out, leaves, torch.from_numpy(cot))
    _, pull = jax.vjp(lambda f, gg, w: jsk.spider_conv_lax(f, jnp.asarray(idx), gg, w),
                      *(jnp.asarray(a) for a in (feat, g, kernel)))
    want = pull(jnp.asarray(cot))
    for name, a, w in zip(("dfeat", "dg", "dkernel"), got, want):
        assert a.dtype == torch.float32 and tuple(a.shape) == w.shape, name
        _assert_scaled(a.numpy(), np.asarray(w), VJP_TOL, f"{case} {name} vs lax VJP")


def test_taylor_basis_matches_jax():
    delta = np.random.RandomState(3).randn(2, 16, 8, 3).astype(np.float32)
    got = taylor_basis(torch.from_numpy(delta)).numpy()
    want = np.asarray(jspider.taylor_basis(jnp.asarray(delta)))
    assert got.shape == (2, 16, 8, 20)
    np.testing.assert_array_equal(got, want)
    x, y, z = 2.0, 3.0, 5.0  # the reference's order, by value
    order = [x, y, z, x * y * z, x * y, y * z, x * z, 1, x * x, y * y, z * z, x * x * y, x * y * y, x * x * z,
             x * z * z, y * y * z, y * z * z, x ** 3, y ** 3, z ** 3]
    np.testing.assert_array_equal(taylor_basis(torch.tensor([x, y, z])).numpy(), np.float32(order))


def _group_norm_pair(x, dtype, seed):
    """Flax GroupNorm(16, eps 1e-5) with random scale and bias on ``x``, and
    the port's GroupNorm loaded with the same parameters, applied to it."""
    c = x.shape[-1]
    rng = np.random.RandomState(seed)
    params = {"scale": (1.0 + 0.3 * rng.randn(c)).astype(np.float32), "bias": (0.2 * rng.randn(c)).astype(np.float32)}
    jdtype = None if dtype is None else jnp.bfloat16
    xin = jnp.asarray(x) if dtype is None else jnp.asarray(x).astype(jnp.bfloat16)
    want = fnn.GroupNorm(num_groups=16, epsilon=1e-5, dtype=jdtype).apply({"params": params}, xin)
    mod = GroupNorm(c, 16, 1e-5, dtype)
    with torch.no_grad():
        mod.scale.copy_(torch.from_numpy(params["scale"]))
        mod.bias.copy_(torch.from_numpy(params["bias"]))
        xt = torch.from_numpy(x) if dtype is None else torch.from_numpy(x).to(torch.bfloat16)
        got = mod(xt)
    return got, want


@pytest.mark.parametrize("common_mode", [False, True], ids=["centred", "common_mode"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_group_norm_matches_flax(dtype, common_mode):
    rng = np.random.RandomState(4)
    x = rng.randn(2, 128, 64).astype(np.float32) * (1.0 + np.arange(64, dtype=np.float32) / 16)
    if common_mode:
        x = x + np.float32(30.0)
    tdtype = None if dtype == "f32" else torch.bfloat16
    got, want = _group_norm_pair(x, tdtype, seed=5)
    assert got.dtype == (torch.float32 if dtype == "f32" else torch.bfloat16) and tuple(got.shape) == want.shape
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    if dtype == "f32":
        _assert_scaled(got, want, GN_COMMON_TOL if common_mode else GN_TOL, f"GroupNorm f32 common_mode={common_mode}")
    else:
        scale = max(1.0, float(np.abs(want).max()))
        ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
        diff = np.abs(got - want)
        differing = float((diff > 0).mean())
        print(f"GroupNorm bf16 common_mode={common_mode}: max err {diff.max():.3e} (ulp {ulp:.3e}), "
              f"{differing:.2e} of elements differ")
        assert diff.max() <= ulp and differing <= (BF16_COMMON_DIFFERING if common_mode else BF16_DIFFERING)


def test_group_norm_takes_flax_fast_variance():
    # Groups of equal values but one, at a common mode of 300: in f32, flax's
    # fast variance E[x²] - E[x]² keeps none of the true variance (2.4e-4
    # against 9e4).  The port equals flax bit for bit there; torch's
    # two-pass GroupNorm, on the same parameters, lies far from both.
    x = np.full((1, 64, 16), 300.0, np.float32)
    x[0, 0, 0] = 300.5
    got, want = _group_norm_pair(x, None, seed=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    two_pass = torch.nn.functional.group_norm(torch.from_numpy(x).permute(0, 2, 1), 16, None, None, 1e-5)
    mod = GroupNorm(16)
    with torch.no_grad():
        plain = mod(torch.from_numpy(x))
    assert float((plain - two_pass.permute(0, 2, 1)).abs().max()) > 1.0


def _pool_input(dtype):
    """relu'd features with exact ties: many zeros, and maxima repeated
    within a channel."""
    rng = np.random.RandomState(7)
    x = np.maximum(rng.randint(-4, 3, (2, 40, 12)).astype(np.float32) * 0.5, 0.0)
    x[:, :, 0] = 0.0  # a channel of zeros: every pick ties
    x[0, 3, 1] = x[0, 9, 1] = 9.0  # a repeated maximum
    return x if dtype == "f32" else np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_topk_pool_matches_jax_with_ties(dtype):
    x = _pool_input(dtype)
    tdtype, jdtype = (torch.float32, jnp.float32) if dtype == "f32" else (torch.bfloat16, jnp.bfloat16)
    xt = torch.from_numpy(x).to(tdtype).requires_grad_()
    got = topk_pool(xt, k=2)
    want, pull = jax.vjp(lambda a: jspider.topk_pool(a, k=2), jnp.asarray(x).astype(jdtype))
    assert got.dtype == tdtype and tuple(got.shape) == want.shape == (2, 12, 2)
    np.testing.assert_array_equal(got.detach().float().numpy(), np.asarray(want.astype(jnp.float32)))
    np.testing.assert_array_equal(got[0, 1].detach().float().numpy(), [9.0, 9.0])  # the tie, twice
    cot = np.random.RandomState(8).randn(2, 12, 2).astype(np.float32)
    (grad,) = torch.autograd.grad(got, xt, torch.from_numpy(cot).to(tdtype))
    (jgrad,) = pull(jnp.asarray(cot).astype(jdtype))
    np.testing.assert_array_equal(grad.float().numpy(), np.asarray(jgrad.astype(jnp.float32)))
    assert float(grad[0, 3, 1]) != 0 and float(grad[0, 9, 1]) != 0  # the first two of the tied maxima
    assert float(grad[:, 2:, 0].abs().sum()) == 0  # zeros: the first two points take the gradient
