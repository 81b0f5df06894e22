"""PyTorch port, the augmentations of ``augment/transforms.py`` that the
classification recipe and PointCNN's do not use, against the JAX module on
JAX's own draws: each JAX transform runs on a key, the draws it makes from
that key are reproduced with ``jax.random`` and fed to the port's
transform.  B=3 clouds of N=64 points.

Bounds: the transforms that add, scale, select or gather are equal bit for
bit; the rotations within 2e-6 (XLA's f32 product at HIGHEST against the
port's products written out elementwise, 1-2 ulps of values below 2).
Ties: ``starve_gaussians`` keeps the lower index first among equal scores,
as ``jax.lax.top_k``, checked on scores with ties.  Each port transform
also draws for itself from a ``torch.Generator`` (shapes and ranges).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanobjectnn_tpu.augment import transforms as jt
from scanobjectnn_tpu.nn import fisher as jfisher
from scanobjectnn_torch.augment import transforms as tt

B, N = 3, 64
ROT_ATOL = 2e-6  # module doc


@pytest.fixture(scope="module")
def points():
    return np.random.RandomState(21).uniform(-1, 1, (B, N, 3)).astype(np.float32)


def _key(i):
    return jax.random.PRNGKey(100 + i)


def _t(a):
    return torch.from_numpy(np.array(a))


def _check(got, want, exact=True):
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == torch.float32
    if exact:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ROT_ATOL)


def test_rotate_z_on_jax_draws(points):
    key = _key(0)
    angles = jax.random.uniform(key, (B,)) * 2.0 * jnp.pi
    _check(tt.rotate_point_cloud_z(_t(points), angles=_t(angles)), jt.rotate_point_cloud_z(key, points), exact=False)


@pytest.mark.parametrize("angle", [0.7, 2 * math.pi * 11 / 12, np.array(2.0)])
def test_rotate_by_angle(points, angle):
    # A host scalar: cos and sin in float64 on both sides.
    got = tt.rotate_point_cloud_by_angle(_t(points), angle)
    _check(got, jt.rotate_point_cloud_by_angle(jnp.asarray(points), angle), exact=False)
    # A device scalar: the f32 rotation matrix on both sides.
    got = tt.rotate_point_cloud_by_angle(_t(points), torch.tensor(float(angle)))
    _check(got, jt.rotate_point_cloud_by_angle(jnp.asarray(points), jnp.asarray(float(angle))), exact=False)


def test_rotate_perturbation_on_jax_draws(points):
    key = _key(1)
    normal = jax.random.normal(key, (B, 3))
    _check(tt.rotate_perturbation_point_cloud(_t(points), normal=_t(normal)),
           jt.rotate_perturbation_point_cloud(key, points), exact=False)


@pytest.mark.parametrize("name,shape,low,high,arg", [
    ("shift_point_cloud", (B, 1, 3), -0.1, 0.1, "shifts"),
    ("random_scale_point_cloud", (B, 1, 1), 0.8, 1.25, "scales"),
    ("scale_point_cloud_anisotropic", (B, 1, 3), 0.66, 1.5, "scales"),
    ("translate_point_cloud", (B, 1, 3), -0.2, 0.2, "t"),
])
def test_uniform_transforms_on_jax_draws(points, name, shape, low, high, arg):
    key = _key(2)
    draws = jax.random.uniform(key, shape, jnp.float32, low, high)
    _check(getattr(tt, name)(_t(points), **{arg: _t(draws)}), getattr(jt, name)(key, points))
    drawn = getattr(tt, name)(_t(points), torch.Generator().manual_seed(0)) - _t(points)
    assert drawn.shape == (B, N, 3)


def test_random_point_dropout_on_jax_draws(points):
    key = _key(3)
    kb, kp = jax.random.split(key)
    ratio = jax.random.uniform(kb, (B, 1)) * 0.875
    u = jax.random.uniform(kp, (B, N))
    want = jt.random_point_dropout(key, points)
    _check(tt.random_point_dropout(_t(points), ratio=_t(ratio), u=_t(u)), want)
    assert not np.array_equal(np.asarray(want), points)  # some points dropped


def test_shuffle_points_on_jax_draws(points):
    key = _key(4)
    perm = jax.random.permutation(key, N)
    _check(tt.shuffle_points(_t(points), perm=_t(perm)), jt.shuffle_points(key, points))
    drawn = tt.shuffle_points(_t(points), torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(np.sort(drawn.numpy(), axis=1), np.sort(points, axis=1))


def test_insert_outliers_on_jax_draws(points):
    key = _key(5)
    kb, kn = jax.random.split(key)
    u = jax.random.uniform(kb, (B, N))
    noise = jax.random.uniform(kn, (B, N, 3), jnp.float32, -1.0, 1.0)
    want = jt.insert_outliers_to_point_cloud(key, points, 0.2)
    _check(tt.insert_outliers_to_point_cloud(_t(points), outlier_ratio=0.2, u=_t(u), noise=_t(noise)), want)


@pytest.mark.parametrize("ratio", [0.25, 0.01])
def test_occlude_on_jax_draws(points, ratio):
    key = _key(6)
    pivot = jax.random.randint(key, (B,), 0, N)
    _check(tt.occlude_point_cloud(_t(points), occlusion_ratio=ratio, pivot=_t(pivot)),
           jt.occlude_point_cloud(key, points, ratio))


def test_starve_gaussians_on_jax_draws(points):
    key = _key(7)
    means = jfisher.get_3d_grid_gmm((3, 3, 3), 0.04).means
    k_sk, k_rx = jax.random.split(key)
    keep = jax.random.bernoulli(k_sk, 0.5, (27,))
    u = jax.random.uniform(k_rx, (B, N))
    want = jt.starve_gaussians(key, jnp.asarray(points), jnp.asarray(means, jnp.float32), 40)
    _check(tt.starve_gaussians(_t(points), means, 40, keep=_t(keep), u=_t(u)), want)
    drawn = tt.starve_gaussians(_t(points), means, 40, torch.Generator().manual_seed(0))
    assert drawn.shape == (B, 40, 3)


def test_starve_gaussians_ties_keep_the_lower_index(points):
    means = jfisher.get_3d_grid_gmm((3, 3, 3), 0.04).means
    keep = np.ones(27, bool)
    u = np.repeat(np.array([0.5, 0.25, 0.75, 0.5], np.float32), N // 4)[None].repeat(B, 0)  # many equal scores
    got = tt.starve_gaussians(_t(points), means, 40, keep=_t(keep), u=_t(u))
    _, top = jax.lax.top_k(jnp.asarray(u), 40)
    want = np.take_along_axis(points, np.asarray(top)[..., None], axis=1)
    _check(got, want)


def test_compose_applies_in_order_as_jax(points):
    key = _key(8)
    k1, k2 = jax.random.split(key, 2)
    want = jt.compose(jt.shift_point_cloud, jt.random_scale_point_cloud)(key, points)
    shifts = jax.random.uniform(k1, (B, 1, 3), jnp.float32, -0.1, 0.1)
    scales = jax.random.uniform(k2, (B, 1, 1), jnp.float32, 0.8, 1.25)
    got = tt.compose(lambda p, g: tt.shift_point_cloud(p, shifts=_t(shifts)),
                     lambda p, g: tt.random_scale_point_cloud(p, scales=_t(scales)))(_t(points))
    _check(got, want)
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    chained = tt.compose(tt.shift_point_cloud, tt.translate_point_cloud)(_t(points), g1)
    by_hand = tt.translate_point_cloud(tt.shift_point_cloud(_t(points), g2), g2)
    np.testing.assert_array_equal(chained.numpy(), by_hand.numpy())


def test_own_draws_lie_in_range(points):
    g = torch.Generator().manual_seed(1)
    p = _t(points)
    assert tt.rotate_point_cloud_z(p, g).shape == (B, N, 3)
    assert torch.allclose(tt.rotate_point_cloud_z(p, g).norm(dim=-1), p.norm(dim=-1), atol=1e-5)
    perturbed = tt.rotate_perturbation_point_cloud(p, g)
    assert torch.allclose(perturbed.norm(dim=-1), p.norm(dim=-1), atol=1e-5)
    scaled = tt.random_scale_point_cloud(p, g) / p
    assert float(scaled.min()) >= 0.8 - 1e-6 and float(scaled.max()) <= 1.25 + 1e-6
    outliers = tt.insert_outliers_to_point_cloud(p, g, outlier_ratio=1.0)
    assert float(outliers.abs().max()) <= 1.0
    assert torch.equal(tt.random_point_dropout(p, g, max_dropout_ratio=0.0), p)
    occluded = tt.occlude_point_cloud(p, g)
    assert int((occluded != p).any(-1).sum()) >= B * (N // 4) - B  # the pivot's k nearest moved (the pivot too)
