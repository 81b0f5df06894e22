"""PyTorch port, layers and weight conversion: ``scanobjectnn_torch.nn.layers``
(Dense, eval BatchNorm, MLP), the eval BN fold and ``convert.py`` against
the flax modules of ``scanobjectnn_tpu`` on the same weights.

Inputs come from numpy seeds; weights cross over through ``convert.py``.
Tolerances: f32 to rtol 2e-5 / atol 2e-6 (summation order only); bf16 to
one bf16 ulp of the output scale (2**-7 relative), since XLA and PyTorch
may round the f32 accumulation to bf16 from sums taken in another order.
"""

import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanobjectnn_tpu.nn import layers as jlayers
from scanobjectnn_tpu.ops.pallas.samlp_kernel import fold_bn_mlp_params as jax_fold
from scanobjectnn_torch import convert
from scanobjectnn_torch.nn import layers as tlayers
from scanobjectnn_torch.ops.cuda.samlp_kernel import fold_bn_mlp_params

REPO = pathlib.Path(__file__).resolve().parents[1]
DTYPES = [(jnp.float32, None), (jnp.bfloat16, torch.bfloat16)]


def _random_stats(variables, rng):
    """Positive random BN running stats in place of the init ones (mean 0,
    var 1), so the normalization is exercised."""
    stats = jax.tree_util.tree_map_with_path(
        lambda p, v: jnp.asarray(
            0.5 + 0.3 * np.abs(rng.randn(*v.shape)) if p[-1].key == "var"
            else 0.2 * rng.randn(*v.shape),
            jnp.float32,
        ),
        variables["batch_stats"],
    )
    return {**variables, "batch_stats": stats}


def _close(got, ref, tdtype):
    got = got.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    if tdtype is None:
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-6)
    else:
        scale = max(1.0, float(np.abs(ref).max()))
        assert np.abs(got - ref).max() <= 2.0**-7 * scale


@pytest.mark.parametrize("jdtype,tdtype", DTYPES)
def test_dense_matches_flax(rng, jdtype, tdtype):
    x = rng.randn(4, 7, 24).astype(np.float32)
    jm = jlayers.Dense(40, dtype=jdtype)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = {"params": {**v["params"], "bias": jnp.asarray(rng.randn(40), jnp.float32)}}
    ref = jm.apply(v, jnp.asarray(x))
    tm = convert.load_jax_variables(tlayers.Dense(24, 40, tdtype), v)
    got = tm(torch.from_numpy(x))
    assert got.dtype == (tdtype or torch.float32)
    _close(got, ref, tdtype)


@pytest.mark.parametrize("jdtype,tdtype", DTYPES)
def test_batchnorm_eval_matches_flax(rng, jdtype, tdtype):
    x = rng.randn(3, 5, 16).astype(np.float32)
    jm = jlayers.BatchNorm(dtype=jdtype)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), use_running_average=True)
    v = _random_stats(v, rng)
    v = {**v, "params": {"scale": jnp.asarray(rng.rand(16) + 0.5, jnp.float32),
                         "bias": jnp.asarray(rng.randn(16), jnp.float32)}}
    ref = jm.apply(v, jnp.asarray(x), use_running_average=True)
    tm = convert.load_jax_variables(tlayers.BatchNorm(16, tdtype), v).eval()
    _close(tm(torch.from_numpy(x)), ref, tdtype)


def test_batchnorm_training_mode_raises():
    with pytest.raises(NotImplementedError):
        tlayers.BatchNorm(4)(torch.zeros(2, 4))


@pytest.mark.parametrize("jdtype,tdtype", DTYPES)
def test_mlp_matches_flax(rng, jdtype, tdtype):
    x = rng.randn(2, 6, 8, 5).astype(np.float32)
    jm = jlayers.MLP((16, 32), dtype=jdtype)
    v = _random_stats(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)), rng)
    ref = jm.apply(v, jnp.asarray(x))
    tm = convert.load_jax_variables(tlayers.MLP(5, (16, 32), dtype=tdtype), v).eval()
    _close(tm(torch.from_numpy(x)), ref, tdtype)


def test_mlp_final_max_matches_flax(rng):
    x = rng.randn(2, 6, 8, 5).astype(np.float32)
    jm = jlayers.MLP((16, 32), final_max_axis=2)
    v = _random_stats(jm.init(jax.random.PRNGKey(2), jnp.asarray(x)), rng)
    ref = jm.apply(v, jnp.asarray(x))
    tm = convert.load_jax_variables(tlayers.MLP(5, (16, 32)), v).eval()
    h = tm.layer(0, torch.from_numpy(x))
    _close(tlayers.mlp_final_max(tm, h, 1, dim=2), ref, None)


def test_fold_bn_matches_jax(rng):
    jm = jlayers.MLP((12, 20))
    v = _random_stats(jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 7))), rng)
    jw, jb = jax_fold(v["params"], v["batch_stats"], 2)
    tm = convert.load_jax_variables(tlayers.MLP(7, (12, 20)), v)
    dense = [(tm.dense_0.kernel, tm.dense_0.bias), (tm.dense_1.kernel, tm.dense_1.bias)]
    bn = [(m.scale, m.bias, m.mean, m.var) for m in (tm.bn_0, tm.bn_1)]
    tw, tb = fold_bn_mlp_params(dense, bn)
    for got, ref in zip(tw + tb, list(jw) + list(jb)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)


def test_init_is_reference_init():
    mlp = tlayers.MLP(100, (60, 40))
    convert.init_params(mlp, torch.Generator().manual_seed(0))
    limit = np.sqrt(6.0 / (100 + 60))
    k = mlp.dense_0.kernel.detach()
    assert float(k.abs().max()) <= limit and float(k.abs().max()) > 0.9 * limit
    assert float(k.std()) == pytest.approx(limit / np.sqrt(3.0), rel=0.05)
    assert torch.count_nonzero(mlp.dense_0.bias) == 0
    assert torch.equal(mlp.bn_1.scale.detach(), torch.ones(40))
    assert torch.equal(mlp.bn_1.var, torch.ones(40)) and torch.count_nonzero(mlp.bn_1.mean) == 0
    again = convert.init_params(tlayers.MLP(100, (60, 40)), torch.Generator().manual_seed(0))
    assert torch.equal(again.dense_1.kernel, mlp.dense_1.kernel)


def test_convert_names_and_strictness(rng):
    jm = jlayers.MLP((4,))
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 3)))
    sd = convert.jax_to_state_dict(v)
    assert sorted(sd) == ["bn_0.bias", "bn_0.mean", "bn_0.scale", "bn_0.var",
                          "dense_0.bias", "dense_0.kernel"]
    assert sd["dense_0.kernel"].shape == (3, 4)  # [in, out], not transposed
    with pytest.raises(RuntimeError):  # a width mismatch is refused
        convert.load_jax_variables(tlayers.MLP(5, (4,)), v)


def test_import_leaves_jax_out():
    code = (
        "import sys, scanobjectnn_torch, scanobjectnn_torch.convert, "
        "scanobjectnn_torch.models, scanobjectnn_torch.ops.cuda.fps_kernel, "
        "scanobjectnn_torch.ops.cuda.safused_kernel, scanobjectnn_torch.ops.cuda._build, "
        "scanobjectnn_torch.data.synthetic; "
        "bad = [m for m in ('jax', 'flax', 'optax', 'orbax', 'scanobjectnn_tpu') if m in sys.modules]; "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO)
