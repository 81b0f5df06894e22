"""PyTorch port, exact-key pooling (``ops/exactpool.py``) and the plain
version of #18 (``ops/cuda/poolkey_kernel.py``), on the CPU, against the JAX
package on the same numpy inputs.

  * ``exact_key_max_pool``: values and gradients bit-equal to JAX's, with
    exact ties, the spurious bf16 tie that the f32 key breaks, and no
    gradient to the key.
  * ``bn_relu_exactkey_pool_plain`` against JAX's Pallas kernel run in
    interpret mode on the same z32 and statistics.  Not bit-equal, for two
    named causes: JAX computes ``lax.rsqrt(var + 1e-3)`` inside the kernel
    where the port takes torch's ``rsqrt`` as an input (they differ in the
    last bit on about a third of f32 inputs; neither is correctly rounded),
    and XLA on the CPU contracts the affine's ``· gamma + beta`` into one
    FMA (a quarter of the keys differ by one f32 ulp from the separately
    rounded form, none from an FMA), where the port, like #18, rounds each
    operation.  So: kmax within POOLKEY_KEY_ULPS f32 ulps of max(1, |kmax|)
    (the affine cancels against beta), cnt equal,
    pooled within one bf16 ulp of its value on at most
    POOLKEY_POOLED_SHARE of the elements.
  * ``dense_bn_exactkey_pool`` against JAX's, bf16: pooled bit-equal (at
    these seeds), the batch mean and variance within 1e-6 relative (the two
    sum in other orders); the gradients: dx within one bf16 ulp of max(1, |ref|max)
    (it is rounded to bf16 after products over the other ``r``), dw, dgamma
    and dbeta within 1e-4 x max(1, |ref|max); db, whose true value is 0
    (it feeds a training BN), below 1e-4 on both sides.
  * The statistics come from the explicitly bf16-rounded z: XLA does not
    fold JAX's ``astype(bf16).astype(f32)``, and the port rounds itself.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanobjectnn_tpu.ops import exactpool as jexactpool
from scanobjectnn_tpu.ops.pallas.poolkey_kernel import bn_relu_exactkey_pool as jax_poolkey
from scanobjectnn_torch.ops.cuda.poolkey_kernel import bn_relu_exactkey_pool, bn_relu_exactkey_pool_plain
from scanobjectnn_torch.ops.exactpool import dense_bn_exactkey_pool, exact_key_max_pool


POOLKEY_KEY_ULPS, POOLKEY_POOLED_SHARE = 4, 0.01  # module doc


def _bf16(a: np.ndarray) -> tuple[jnp.ndarray, torch.Tensor]:
    """The same bf16 values on both sides."""
    j = jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j.astype(jnp.float32))).to(torch.bfloat16)


def _np(t) -> np.ndarray:
    return np.asarray(t.float().detach().numpy() if isinstance(t, torch.Tensor) else jnp.asarray(t, jnp.float32))


@pytest.mark.parametrize("key_is_y", [False, True], ids=["f32_key", "key_is_y"])
def test_exact_key_max_pool_matches_jax(key_is_y):
    rng = np.random.RandomState(0)
    key = rng.randn(3, 5, 9, 7).astype(np.float32)
    key[:, :, 4] = key[:, :, 6]  # exact ties
    yj, yt = _bf16(key)
    kj, kt = (yj.astype(jnp.float32), yt.float()) if key_is_y else (jnp.asarray(key), torch.from_numpy(key))
    cot = rng.randn(3, 5, 7).astype(np.float32)

    pooled_j, vjp = jax.vjp(lambda y: jexactpool.exact_key_max_pool(y, kj, 2), yj)
    (grad_j,) = vjp(jnp.asarray(cot).astype(jnp.bfloat16))
    yt.requires_grad_()
    pooled_t = exact_key_max_pool(yt, kt, 2)
    pooled_t.backward(torch.from_numpy(cot).to(torch.bfloat16))
    assert pooled_t.dtype == yt.grad.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(pooled_t), _np(pooled_j))
    np.testing.assert_array_equal(_np(yt.grad), _np(grad_j))


def test_spurious_bf16_tie_broken_by_key():
    # Two rows that round to the same bf16 value but differ in f32: the key
    # gives the credit to the true winner alone (JAX's test of the same name).
    key = torch.tensor([[[1.0], [1.0 + 1e-4], [0.5]]])
    y = key.to(torch.bfloat16).requires_grad_()
    assert y[0, 0, 0] == y[0, 1, 0]
    exact_key_max_pool(y, key, 1).float().sum().backward()
    np.testing.assert_array_equal(_np(y.grad)[0, :, 0], [0.0, 1.0, 0.0])
    plain = key.to(torch.bfloat16).requires_grad_()
    torch.amax(plain, dim=1).float().sum().backward()
    np.testing.assert_array_equal(_np(plain.grad)[0, :, 0], [0.5, 0.5, 0.0])


def test_no_gradient_to_key():
    y = torch.randn(2, 4, 8, requires_grad=True)
    key = (y.detach() * 2.0).requires_grad_()
    exact_key_max_pool(y, key, 1).sum().backward()
    assert key.grad is None and y.grad is not None


def _poolkey_inputs(rng, lead, k, c):
    z = (rng.randn(*lead, k, c) * 2.0 + rng.randn(c)).astype(np.float32)
    z[..., k // 2, :] = z[..., 0, :]  # exact key ties
    zbf = np.asarray(jnp.asarray(z).astype(jnp.bfloat16).astype(jnp.float32))
    axes = tuple(range(z.ndim - 1))
    mean = zbf.mean(axis=axes, dtype=np.float64).astype(np.float32)
    var = np.maximum((zbf.astype(np.float64) ** 2).mean(axis=axes) - mean.astype(np.float64) ** 2, 0).astype(np.float32)
    gamma = (1.0 + 0.2 * rng.randn(c)).astype(np.float32)
    beta = (0.1 * rng.randn(c)).astype(np.float32)
    return z, gamma, beta, mean, var


@pytest.mark.parametrize("lead,k,c", [((2, 16), 8, 128), ((4, 8), 16, 64), ((1, 24), 32, 256)])
def test_poolkey_plain_matches_interpreted_pallas(lead, k, c):
    rng = np.random.RandomState(k + c)
    z, gamma, beta, mean, var = _poolkey_inputs(rng, lead, k, c)
    want = jax_poolkey(*(jnp.asarray(a) for a in (z, gamma, beta, mean, var)), jnp.bfloat16, True)
    r = torch.rsqrt(torch.from_numpy(var) + 1e-3)
    args = (*(torch.from_numpy(a) for a in (z, gamma, beta, mean)), r, torch.bfloat16)
    got = bn_relu_exactkey_pool_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, bn_relu_exactkey_pool(*args)))  # a CPU tensor: the plain version
    pooled, kmax, cnt = (_np(t) for t in got)
    w_pooled, w_kmax, w_cnt = (_np(t) for t in want)
    # The key chain: XLA contracts the affine's product and sum into one FMA
    # and takes its own rsqrt; the port rounds each op (as #18 does).
    assert np.all(np.abs(kmax - w_kmax) <= POOLKEY_KEY_ULPS * np.spacing(np.maximum(np.abs(w_kmax), 1.0)))
    # The value chain: those last-bit differences move a bf16 rounding of u
    # on a few elements, by one bf16 ulp.
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w_pooled), 1e-30))) - 7)
    diff = np.abs(pooled - w_pooled)
    assert np.all(diff <= ulp) and (diff > 0).mean() <= POOLKEY_POOLED_SHARE, (diff > 0).mean()
    np.testing.assert_array_equal(cnt, w_cnt)
    assert cnt.min() >= 1 and (cnt >= 2).any()  # the duplicated slot ties on every column it wins


def _dense_args(rng, b=2, m=16, k=8, cin=6, c=16):
    x = rng.randn(b, m, k, cin).astype(np.float32)
    x[:, :, 5] = x[:, :, 1]  # duplicated slots: exact ties
    w = (rng.randn(cin, c) * 0.4).astype(np.float32)
    bias = (rng.randn(c) * 0.1).astype(np.float32)
    gamma = (1.0 + 0.2 * rng.randn(c)).astype(np.float32)
    beta = (0.1 * rng.randn(c)).astype(np.float32)
    return x, w, bias, gamma, beta


@pytest.mark.parametrize("seed", [3, 4])
def test_dense_bn_exactkey_pool_matches_jax(seed):
    rng = np.random.RandomState(seed)
    x, w, bias, gamma, beta = _dense_args(rng)
    xj, xt = _bf16(x)
    cot = rng.randn(2, 16, 16).astype(np.float32)
    params_j = [jnp.asarray(a) for a in (w, bias, gamma, beta)]

    def lf(args):
        pooled, _, _ = jexactpool.dense_bn_exactkey_pool(*args, 2)
        return jnp.sum(pooled.astype(jnp.float32) * cot)

    pooled_j, mean_j, var_j = jexactpool.dense_bn_exactkey_pool(xj, *params_j, 2)
    grads_j = jax.grad(lf)((xj, *params_j))

    params_t = [torch.from_numpy(a).requires_grad_() for a in (w, bias, gamma, beta)]
    xt.requires_grad_()
    pooled_t, mean_t, var_t = dense_bn_exactkey_pool(xt, *params_t, 2)
    assert pooled_t.dtype == torch.bfloat16 and not mean_t.requires_grad and not var_t.requires_grad
    (pooled_t.float() * torch.from_numpy(cot)).sum().backward()

    np.testing.assert_array_equal(_np(pooled_t), _np(pooled_j))
    np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_j), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(var_t.numpy(), np.asarray(var_j), rtol=1e-6, atol=1e-7)
    names = ("x", "w", "b", "gamma", "beta")
    for name, want, got in zip(names, grads_j, [xt] + params_t):
        want, got = _np(want), _np(got.grad)
        scale = max(1.0, float(np.abs(want).max()))
        if name == "b":  # feeds a training BN: 0
            assert np.abs(got).max() < 1e-4 and np.abs(want).max() < 1e-4
        elif name == "x":
            assert xt.grad.dtype == torch.bfloat16
            assert np.abs(got - want).max() <= 2.0 ** (np.floor(np.log2(scale)) - 7), name
        else:
            assert np.abs(got - want).max() <= 1e-4 * scale, name


def test_dense_bn_exactkey_pool_stats_round_z_explicitly():
    # The statistics are those of bf16-rounded z (what the BatchNorm of the
    # module chain sees); the unrounded mean differs, so a fold of the round
    # trip would show.
    rng = np.random.RandomState(5)
    x, w, bias, gamma, beta = _dense_args(rng)
    _, xt = _bf16(x)
    _, mean, var = dense_bn_exactkey_pool(xt, *(torch.from_numpy(a) for a in (w, bias, gamma, beta)), 2)
    z32 = torch.matmul(xt.float(), torch.from_numpy(w).to(torch.bfloat16).float()) + torch.from_numpy(bias)
    zbf = z32.to(torch.bfloat16).float()
    axes = (0, 1, 2)
    assert torch.equal(mean, zbf.mean(dim=axes))
    assert torch.equal(var, torch.clamp(torch.square(zbf).mean(dim=axes) - torch.square(zbf.mean(dim=axes)), min=0))
    assert not torch.equal(mean, z32.mean(dim=axes))
    # JAX's jit keeps the round trip too.
    zj = jnp.asarray(z32.numpy())
    folded = jax.jit(lambda z: jnp.mean(z.astype(jnp.bfloat16).astype(jnp.float32), axis=axes))(zj)
    np.testing.assert_allclose(np.asarray(folded), mean.numpy(), rtol=1e-6, atol=1e-7)
    assert np.abs(np.asarray(folded) - z32.mean(dim=axes).numpy()).max() > 1e-5


def test_dense_bn_exactkey_pool_pools_over_k_only():
    x = torch.zeros(2, 4, 3, 5, dtype=torch.bfloat16)
    w, v = torch.zeros(5, 6), torch.zeros(6)
    with pytest.raises(ValueError, match="K axis"):
        dense_bn_exactkey_pool(x, w, v, v, v, 1)
