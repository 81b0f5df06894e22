"""PyTorch port, the mixed-precision pieces of ``nn/layers.py`` on the CPU,
against the JAX package on the same numpy inputs and weights.

  * ``Dense(..., keep_f32_output=True)``: bf16 operands, f32 sums and bias,
    no final cast; ``Dense(highest_cols=(a, b))``: rows [a, b) in f32, the
    rest bf16, f32 out.  Against flax's ``Dense`` of the JAX package: equal
    to 1e-6 relative (XLA and torch sum the few products in other orders).
  * ``BatchNorm(f32_key_input=...)``: the value in bf16 and the f32 key
    under the same batch statistics.  XLA on the CPU contracts
    ``· scale + bias`` into one FMA where the port rounds each op, so the
    key is held to 1e-6 relative (the statistics sum in other orders too)
    and the value to one bf16 ulp of max(1, |ref|max) on at most 1% of its
    elements.
  * ``mlp_final_max`` through ``GroupMLPPool`` in training, pool modes "0",
    "1" and "keys" (bf16), and "keys" in f32: pooled output and every
    gradient against the JAX module under ``SCANOBJECTNN_SA_POOL_F32``.
    The same FMA difference moves bf16 roundings inside the stack, so the
    pooled output is held to one bf16 ulp of max(1, |ref|max) on at most
    5% of its elements, each gradient to 2% of max(1, |ref|max), five bf16
    ulps (both sides round every Dense's dx to bf16, so a rounding moved
    at one layer reaches the sums below it; read up to 1.3e-2 at seeds 3,
    5, 7), the running stats to 1e-3 relative; f32 to 1e-4 of the scale.
    The Dense biases feed a training BN, so their true gradient is 0: both
    sides sum bf16-rounded cotangents there, held to 1e-2 of the layer's
    kernel gradient's scale (read up to 2.8e-3); f32 to 1e-5.
  * The keys path: the fused final layer (``dense_bn_exactkey_pool``)
    against the module chain it replaces, in the port: pooled bit-equal,
    statistics equal (JAX's ``test_forward_bit_equal_and_stats``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanobjectnn_tpu.nn import layers as jlayers
from scanobjectnn_tpu.nn.pointnet_modules import GroupMLPPool as JGroupMLPPool
from scanobjectnn_torch import convert
from scanobjectnn_torch.nn.layers import BatchNorm, Dense
from scanobjectnn_torch.nn.pointnet_modules import GroupMLPPool, configure_training
from scanobjectnn_torch.ops.exactpool import exact_key_max_pool

MOMENTUM = 0.5
BF16_OUT_SHARE, BF16_GRAD_TOL, F32_TOL = 0.05, 2e-2, 1e-4  # module doc
BF16_ZERO_TOL, F32_ZERO_TOL = 1e-2, 1e-5


def _bf16_ulp(scale: float) -> float:
    return 2.0 ** (np.floor(np.log2(max(1.0, scale))) - 7)


def _np(t) -> np.ndarray:
    return t.float().detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(jnp.asarray(t, jnp.float32))


@pytest.mark.parametrize("highest_cols", [None, (0, 3), (4, 7)], ids=["keep_f32", "xyz_first", "xyz_last"])
def test_dense_f32_paths_match_jax(highest_cols):
    rng = np.random.RandomState(1)
    x = (rng.randn(2, 5, 7) * 3.0).astype(np.float32)
    jd = jlayers.Dense(6, dtype=jnp.bfloat16, highest_cols=highest_cols, keep_f32_output=highest_cols is None)
    v = jd.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = {"params": {"kernel": v["params"]["kernel"], "bias": jnp.asarray(rng.randn(6).astype(np.float32))}}
    want = np.asarray(jd.apply(v, jnp.asarray(x)))
    td = Dense(7, 6, torch.bfloat16, highest_cols=highest_cols)
    td.load_state_dict(convert.jax_to_state_dict(v))
    got = td(torch.from_numpy(x), keep_f32_output=highest_cols is None)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-6)
    if highest_cols is not None:  # the f32 rows are not rounded to bf16
        plain = Dense(7, 6, torch.bfloat16)
        plain.load_state_dict(td.state_dict())
        assert not np.allclose(plain(torch.from_numpy(x)).float().detach().numpy(), want, rtol=1e-4, atol=1e-4)


def test_batchnorm_key_matches_jax():
    rng = np.random.RandomState(2)
    h32 = (rng.randn(4, 6, 8, 12) * 2.0 + 0.5).astype(np.float32)
    z = jnp.asarray(h32).astype(jnp.bfloat16)
    jbn = jlayers.BatchNorm(dtype=jnp.bfloat16)
    v = jbn.init(jax.random.PRNGKey(0), z, use_running_average=False)
    params = {"scale": jnp.asarray(1.0 + 0.2 * rng.randn(12), jnp.float32),
              "bias": jnp.asarray(0.1 * rng.randn(12), jnp.float32)}
    (want, want_key), mut = jbn.apply({"params": params, "batch_stats": v["batch_stats"]}, z,
                                      use_running_average=False, momentum=MOMENTUM, f32_key_input=jnp.asarray(h32),
                                      mutable=["batch_stats"])
    tbn = BatchNorm(12, torch.bfloat16).train()
    tbn.load_state_dict(convert.jax_to_state_dict({"params": params, "batch_stats": v["batch_stats"]}))
    h = torch.from_numpy(h32).requires_grad_()
    got, key = tbn(torch.from_numpy(_np(z)).to(torch.bfloat16), MOMENTUM, f32_key_input=h)
    assert got.dtype == torch.bfloat16 and key.dtype == torch.float32 and not key.requires_grad
    want, want_key = _np(want), np.asarray(want_key)
    np.testing.assert_allclose(key.numpy(), want_key, rtol=1e-6, atol=1e-6)
    diff = np.abs(_np(got) - want)
    assert diff.max() <= _bf16_ulp(float(np.abs(want).max())) and (diff > 0).mean() <= 0.01
    for name in ("mean", "var"):
        np.testing.assert_allclose(getattr(tbn, name).numpy(), np.asarray(mut["batch_stats"][name]), rtol=1e-6,
                                   atol=1e-7)


def _group_mlp_pool_step(mode: str, dtype, seed: int = 3):
    """One training call of GroupMLPPool (8, 12, 16) on [2, 16, 8, 6] rows
    on both sides: (pooled, grads, stats) for JAX and for the port."""
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 16, 8, 6).astype(np.float32)
    x[:, :, 6] = x[:, :, 2]  # duplicated slots: exact ties
    cot = rng.randn(2, 16, 16).astype(np.float32)
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    xj = jnp.asarray(x).astype(jdtype)
    jm = JGroupMLPPool((8, 12, 16), dtype=jdtype if dtype == torch.bfloat16 else None)
    v = jm.init(jax.random.PRNGKey(seed), xj, train=False)
    v = {**v, "batch_stats": jax.tree_util.tree_map(
        lambda a: jnp.asarray(0.5 + np.abs(rng.randn(*a.shape)), jnp.float32), v["batch_stats"])}

    def f(params, xx):
        y, mut = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, xx, train=True,
                          bn_momentum=MOMENTUM, mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * cot), (y, mut["batch_stats"])

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SCANOBJECTNN_SA_POOL_F32", mode)
        (gp, gx), (ref, ref_stats) = jax.grad(f, argnums=(0, 1), has_aux=True)(v["params"], xj)

    tm = configure_training(convert.load_jax_variables(GroupMLPPool(6, (8, 12, 16), dtype=dtype), v), mode, False)
    xt = torch.from_numpy(_np(xj)).to(dtype).requires_grad_()
    out = tm.train()(xt, MOMENTUM)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    want = {**dict(convert._flatten(gp)), "x": gx}
    got = {**{n: p.grad for n, p in tm.named_parameters()}, "x": xt.grad}
    stats = ({n: b for n, b in tm.named_buffers()}, dict(convert._flatten(ref_stats)))
    return (out, ref), (got, want), stats


@pytest.mark.parametrize("mode,dtype", [("0", torch.bfloat16), ("1", torch.bfloat16), ("keys", torch.bfloat16),
                                        ("keys", torch.float32)], ids=["native_bf16", "f32_bf16", "keys_bf16",
                                                                       "keys_f32"])
def test_mlp_final_max_modes_match_jax(mode, dtype):
    (out, ref), (got, want), (stats, ref_stats) = _group_mlp_pool_step(mode, dtype)
    assert out.dtype == dtype and sorted(got) == sorted(want)
    ref = _np(ref)
    diff = np.abs(_np(out) - ref)
    readings = {"pooled": (float(diff.max()), float((diff > 0).mean()))}
    bf16 = dtype == torch.bfloat16
    if bf16:
        assert diff.max() <= _bf16_ulp(float(np.abs(ref).max())) and (diff > 0).mean() <= BF16_OUT_SHARE, readings
    else:
        assert diff.max() <= F32_TOL * max(1.0, float(np.abs(ref).max())), readings
    for name, w in want.items():
        w, g = _np(w), _np(got[name])
        scale = max(1.0, float(np.abs(w).max()))
        err = float(np.abs(g - w).max()) / scale
        readings[name] = err
        if name.startswith("dense_") and name.endswith("bias"):  # feeds a training BN: 0
            kernel_scale = max(1.0, float(np.abs(_np(want[name[:-4] + "kernel"])).max()))
            readings[name] = (float(np.abs(g).max()), float(np.abs(w).max()))
            bound = (BF16_ZERO_TOL if bf16 else F32_ZERO_TOL) * kernel_scale
            assert np.abs(g).max() <= bound and np.abs(w).max() <= bound, readings
        else:
            assert err <= (BF16_GRAD_TOL if bf16 else F32_TOL), (name, readings)
    for name, w in ref_stats.items():
        np.testing.assert_allclose(stats[name].numpy(), np.asarray(w), rtol=1e-3 if bf16 else 1e-5, atol=1e-6)
    print(f"GroupMLPPool mode {mode} {dtype}: {readings}")


def test_keys_fused_layer_matches_module_chain():
    # The port's fused final layer against the keys-mode module chain it
    # replaces (the Dense's f32 sums key the pool; BN of the rounded z).
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(2, 16, 8, 6).astype(np.float32)).to(torch.bfloat16)
    mlp = configure_training(GroupMLPPool(6, (16,), dtype=torch.bfloat16), "keys", False).train()
    with torch.no_grad():
        mlp.dense_0.kernel.copy_(torch.from_numpy(rng.randn(6, 16).astype(np.float32) * 0.4))
        mlp.dense_0.bias.copy_(torch.from_numpy(rng.randn(16).astype(np.float32) * 0.1))
        mlp.bn_0.scale.copy_(torch.from_numpy(1.0 + 0.2 * rng.randn(16).astype(np.float32)))
        mlp.bn_0.bias.copy_(torch.from_numpy(0.1 * rng.randn(16).astype(np.float32)))
    chain = GroupMLPPool(6, (16,), dtype=torch.bfloat16).train()
    chain.load_state_dict(mlp.state_dict())
    fused = mlp(x, MOMENTUM)
    h32 = chain.dense_0(x, keep_f32_output=True)
    z, key = chain.bn_0(h32.to(torch.bfloat16), MOMENTUM, f32_key_input=h32)
    want = exact_key_max_pool(torch.relu(z), torch.relu(key), 2)
    assert fused.dtype == want.dtype == torch.bfloat16
    assert torch.equal(fused, want)
    for name in ("mean", "var"):
        assert torch.equal(getattr(mlp.bn_0, name), getattr(chain.bn_0, name))
