"""PyTorch port: kNN (the plain version of the ``csrc/knn.cu`` kernel) and the
FP decoder's interpolation ops, on the CPU, against the JAX package.

The JAX side runs as its own tests run it: ``knn_point_pallas`` in Pallas
interpret mode, and the lax paths (``knn_point_lax``, ``three_nn``, which on
the CPU takes the expansion and ``lax.top_k``).

Tolerances, and why:
  * kNN indices equal; squared distances within 1e-6 (both sum the
    expansion ``|q|² - 2q·k + |k|²`` of coordinates below 1 in f32, in other
    orders: a few ulps of |q|² <= 3);
  * where every key is also a query (fp3: FPS picks the coarse points from
    the fine ones), the port's fixed order gives d² exactly 0 for a query
    equal to a key and XLA's up to ``COINCIDENT_D2`` (read 4.8e-7);
  * the weights and the interpolated features are held to what those
    distance differences propagate to: the same weights and sums evaluated
    in float64 on the port's distances and on the JAX distances differ by
    P, and the results may differ by P plus f32 rounding (1e-6 for a weight,
    2e-6 of the scale for a feature).  The 1e-10 floor makes P large at a
    coincident key: the JAX weight of the other two neighbours is about
    δ/d² instead of 1e-10/d².  On the fp3 inputs P read 6.7e-5 of the
    features' scale, at 2048 coincident queries;
  * ``three_interpolate`` in bf16: bit for bit (weight cast to bf16,
    products and sums in f32, one rounding, which is XLA's rule on the CPU);
    in f32 within 1e-6 of the scale on equal weights (another summation
    order);
  * the points-gradient of ``three_interpolate`` within 1e-6 of the scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanobjectnn_tpu.ops import interpolate as jinterp
from scanobjectnn_tpu.ops.fps import farthest_point_sample as jfps
from scanobjectnn_tpu.ops.grouping import knn_point_lax, pairwise_squared_distance as jpairwise
from scanobjectnn_tpu.ops.pallas.knn_kernel import knn_point_pallas
from scanobjectnn_torch.data.synthetic import make_synthetic_dataset
from scanobjectnn_torch.ops import grouping, interpolate
from scanobjectnn_torch.ops.cuda.knn_kernel import knn_point_kernel, knn_point_plain

D2_ATOL = 1e-6
COINCIDENT_D2 = 2.0 ** -20  # bound on the XLA d² at a coincident key (read 4.8e-7)


def _cloud(rng, b, n):
    return (rng.rand(b, n, 3).astype(np.float32) * 2 - 1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _weights64(d):
    inv = 1.0 / np.maximum(np.asarray(d, np.float64), 1e-10)
    return inv / inv.sum(-1, keepdims=True)


def _interp64(d, idx, feats):
    rows = np.stack([f[j] for f, j in zip(np.asarray(feats, np.float64), np.asarray(idx))])  # [B, N, 3, C]
    return (rows * _weights64(d)[..., None]).sum(2)


def _check_propagated(d, jd, idx, feats):
    """Hold the port's weights and features, from its distances ``d``, to
    the JAX ones from ``jd``, at the float64 propagation of d - jd plus f32
    rounding (module doc); returns (max P / scale, max err / scale)."""
    w = interpolate.three_interpolate_weights(_t(d))
    jw = jinterp.three_interpolate_weights(jnp.asarray(jd))
    assert (np.abs(w.numpy() - np.asarray(jw)) <= np.abs(_weights64(d) - _weights64(jd)) + 1e-6).all()
    got = interpolate.three_interpolate(_t(feats), _t(idx), w).numpy()
    want = np.asarray(jinterp.three_interpolate(jnp.asarray(feats), jnp.asarray(idx), jw))
    scale = max(1.0, float(np.abs(want).max()))
    prop = np.abs(_interp64(d, idx, feats) - _interp64(jd, idx, feats))
    err = np.abs(got - want)
    assert (err <= prop + 2e-6 * scale).all()
    return float(prop.max()) / scale, float(err.max()) / scale


@pytest.mark.parametrize("with_bias", [False, True], ids=["plain", "bias"])
@pytest.mark.parametrize("k", [3, 5])
def test_knn_plain_matches_pallas_and_lax(k, with_bias):
    rng = np.random.RandomState(k)
    q, keys = _cloud(rng, 2, 64), _cloud(rng, 2, 96)
    bias = (0.1 * rng.rand(2, 96)).astype(np.float32) if with_bias else None
    d, i = knn_point_plain(_t(q), _t(keys), k, None if bias is None else _t(bias))
    assert d.dtype == torch.float32 and i.dtype == torch.int32 and d.shape == (2, 64, k)
    assert bool((d[..., 1:] >= d[..., :-1]).all())
    jd, ji = knn_point_pallas(jnp.asarray(q), jnp.asarray(keys), k, interpret=True,
                              bias=None if bias is None else jnp.asarray(bias))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=D2_ATOL)
    if bias is None:
        ld, li = knn_point_lax(k, jnp.asarray(keys), jnp.asarray(q))
        np.testing.assert_array_equal(i.numpy(), np.asarray(li))
        np.testing.assert_allclose(d.numpy(), np.asarray(ld), rtol=0, atol=D2_ATOL)
    # The wrapper and ops.knn_point take the plain version on a CPU tensor.
    before = knn_point_kernel.launches
    wd, wi = knn_point_kernel(_t(q), _t(keys), k, None if bias is None else _t(bias))
    assert torch.equal(wd, d) and torch.equal(wi, i) and knn_point_kernel.launches == before
    if bias is None:
        gd, gi = grouping.knn_point(k, _t(keys), _t(q))
        assert torch.equal(gd, d) and torch.equal(gi, i)


@pytest.mark.parametrize("n,k", [(16385, 65), (16385, 128), (20000, 65), (20000, 128)])
def test_knn_plain_matches_lax_past_16384_keys(n, k):
    """More keys than the card's sorted tile (16384) at k > 64, where the
    kernel merges sorted tiles: equal to the lax path.  Coordinates are
    multiples of 1/64, so every d² is exact on both sides and the many
    equal distances are compared too (lowest index first)."""
    rng = np.random.RandomState(n + k)
    keys = (rng.randint(-64, 65, (2, n, 3)) / 64.0).astype(np.float32)
    q = (rng.randint(-64, 65, (2, 4, 3)) / 64.0).astype(np.float32)
    d, i = knn_point_plain(_t(q), _t(keys), k)
    ld, li = knn_point_lax(k, jnp.asarray(keys), jnp.asarray(q))
    np.testing.assert_array_equal(i.numpy(), np.asarray(li))
    np.testing.assert_array_equal(d.numpy(), np.asarray(ld))
    assert bool((d[..., 1:] == d[..., :-1]).any())  # the lattice gives ties


def test_knn_duplicate_keys_lowest_index_wins():
    rng = np.random.RandomState(1)
    keys = _cloud(rng, 2, 64)
    keys[:, 40] = keys[:, 10]  # exact duplicates
    keys[1, 50] = keys[1, 3]
    q = keys[:, [10, 3, 20, 40]] + np.float32(1e-3)
    d, i = knn_point_plain(_t(q), _t(keys), 4)
    jd, ji = knn_point_pallas(jnp.asarray(q), jnp.asarray(keys), 4, interpret=True)
    ld, li = knn_point_lax(4, jnp.asarray(keys), jnp.asarray(q))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(i.numpy(), np.asarray(li))
    for b, query, pair in ((0, 0, (10, 40)), (1, 1, (3, 50))):
        row = i[b, query].tolist()
        assert row.index(pair[0]) + 1 == row.index(pair[1]), row  # equal d², lower index first
        assert d[b, query, row.index(pair[0])] == d[b, query, row.index(pair[1])]


def test_knn_queries_equal_to_keys_give_zero():
    rng = np.random.RandomState(2)
    keys = _cloud(rng, 2, 50)
    d, i = knn_point_plain(_t(keys), _t(keys), 2)
    assert bool((d[..., 0] == 0).all())
    np.testing.assert_array_equal(i[..., 0].numpy(), np.tile(np.arange(50), (2, 1)))


@pytest.mark.parametrize("m", [1, 2])
def test_three_nn_pads_like_jax_when_fewer_than_three_keys(m):
    rng = np.random.RandomState(m)
    xyz1, xyz2 = _cloud(rng, 2, 40), _cloud(rng, 2, m)
    d, i = interpolate.three_nn(_t(xyz1), _t(xyz2))
    jd, ji = (np.asarray(a) for a in jinterp.three_nn(jnp.asarray(xyz1), jnp.asarray(xyz2)))
    assert np.isinf(jd[..., m:]).all() and bool(torch.isinf(d[..., m:]).all())
    np.testing.assert_array_equal(i.numpy(), ji)
    np.testing.assert_allclose(d.numpy(), jd, rtol=0, atol=D2_ATOL)
    w = interpolate.three_interpolate_weights(d)
    np.testing.assert_allclose(w.numpy(), np.asarray(jinterp.three_interpolate_weights(jnp.asarray(jd))),
                               rtol=1e-6)
    assert bool((w[..., m:] == 0).all())


def test_three_nn_weights_and_interpolation_match_jax():
    rng = np.random.RandomState(3)
    xyz1, xyz2 = _cloud(rng, 2, 256), _cloud(rng, 2, 64)
    feats = rng.randn(2, 64, 24).astype(np.float32)
    d, i = interpolate.three_nn(_t(xyz1), _t(xyz2))
    jd, ji = (np.asarray(a) for a in jinterp.three_nn(jnp.asarray(xyz1), jnp.asarray(xyz2)))
    np.testing.assert_array_equal(i.numpy(), ji)
    np.testing.assert_allclose(d.numpy(), jd, rtol=0, atol=D2_ATOL)
    np.testing.assert_allclose(
        grouping.pairwise_squared_distance(_t(xyz1), _t(xyz2)).numpy(),
        np.asarray(jpairwise(jnp.asarray(xyz1), jnp.asarray(xyz2))), rtol=0, atol=D2_ATOL,
    )
    _check_propagated(d.numpy(), jd, ji, feats)
    # On equal weights only the summation order differs.
    jw = jinterp.three_interpolate_weights(jnp.asarray(jd))
    got = interpolate.three_interpolate(_t(feats), i, _t(jw)).numpy()
    want = np.asarray(jinterp.three_interpolate(jnp.asarray(feats), jnp.asarray(ji), jw))
    assert np.abs(got - want).max() <= 1e-6 * max(1.0, float(np.abs(want).max()))


def test_coincident_keys_fp3():
    data, _ = make_synthetic_dataset(num_per_class=1, num_classes=4, num_points=1024, seed=3)
    fps_idx = np.asarray(jfps(jnp.asarray(data), 512))
    keys = np.stack([c[j] for c, j in zip(data, fps_idx)])
    feats = np.random.RandomState(0).randn(4, 512, 128).astype(np.float32)
    d, i = interpolate.three_nn(_t(data), _t(keys))
    jd, ji = (np.asarray(a) for a in jinterp.three_nn(jnp.asarray(data), jnp.asarray(keys)))
    np.testing.assert_array_equal(i.numpy(), ji)
    coincident = np.zeros(d.shape[:2], bool)
    for b in range(4):
        coincident[b, fps_idx[b]] = True
    d = d.numpy()
    assert (d[..., 0][coincident] == 0).all()  # the port's fixed order: exactly 0
    diff = np.abs(d - jd)
    assert diff.max() <= COINCIDENT_D2 and diff[~coincident].max() <= D2_ATOL
    prop, err = _check_propagated(d, jd, ji, feats)
    print(f"fp3 inputs: max |d2_port - d2_jax| {diff.max():.3e}; features: propagated {prop:.3e}, "
          f"read {err:.3e} of the scale")


def test_three_interpolate_bf16_is_bit_equal_to_jax():
    rng = np.random.RandomState(4)
    xyz1, xyz2 = _cloud(rng, 2, 128), _cloud(rng, 2, 32)
    feats = jnp.asarray(rng.randn(2, 32, 40).astype(np.float32)).astype(jnp.bfloat16)
    jd, ji = jinterp.three_nn(jnp.asarray(xyz1), jnp.asarray(xyz2))
    jw = jinterp.three_interpolate_weights(jd)
    want = np.asarray(jinterp.three_interpolate(feats, ji, jw).astype(jnp.float32))
    tfeats = _t(np.asarray(feats.astype(jnp.float32))).to(torch.bfloat16)
    got = interpolate.three_interpolate(tfeats, _t(ji), _t(jw))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_three_interpolate_points_gradient_matches_jax():
    rng = np.random.RandomState(5)
    xyz1, xyz2 = _cloud(rng, 2, 128), _cloud(rng, 2, 16)
    feats = rng.randn(2, 16, 8).astype(np.float32)
    cot = rng.randn(2, 128, 8).astype(np.float32)
    jd, ji = jinterp.three_nn(jnp.asarray(xyz1), jnp.asarray(xyz2))
    jw = jinterp.three_interpolate_weights(jd)
    want = np.asarray(jax.grad(lambda p: jnp.sum(jinterp.three_interpolate(p, ji, jw) * cot))(jnp.asarray(feats)))
    points = _t(feats).requires_grad_()
    d, i = interpolate.three_nn(_t(xyz1), _t(xyz2))
    out = interpolate.three_interpolate(points, i, interpolate.three_interpolate_weights(d))
    (grad,) = torch.autograd.grad(out, points, _t(cot))
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(grad.numpy() - want).max() <= 1e-6 * scale
    assert not d.requires_grad and not i.requires_grad
