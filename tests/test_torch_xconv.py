"""PyTorch port, PointCNN's X-Conv and its helpers (``nn/xconv.py``,
``ops/cuda/dupmask_kernel.py``) on the CPU against the JAX package.

The JAX side runs as its own tests run it: the lax branch of
``knn_indices_general`` (the CPU's), and the TPU branch's glue
``_knn_indices_pallas`` and ``duplicate_mask_pallas`` in Pallas interpret
mode.  Clouds hold exact copies of earlier points, a ``-0.0``/``0.0`` pair
and, for the duplicate mask, NaN points.

Tolerances, and why:
  * the duplicate mask: equal (float ``==`` on both sides);
  * kNN indices: equal on every row whose float64 distances, duplicates
    masked, have consecutive gaps above ``MARGIN`` x (1 + d²) up to the
    (k+1)-th (JAX's d² is an einsum, the port's a sum in ascending channel
    order: they differ by a few ulps of |q|² + |p|² <= 6, under 1e-6); at
    least ``CLEAR_SHARE`` of the rows must clear it (printed).  Squared
    distances of unique neighbours within ``D2_ATOL``;
  * ``sort_points``: equal (dyadic lattice points: every key is exact, and
    ties are broken by slot on both sides);
  * ``inverse_density_sample``'s logits within 1e-6 (sums of k f32
    distances in other orders);
  * the layers and ``XConv`` in f32 within ``F32_TOL`` x max(1, |ref|max)
    (sums in other orders); in bf16 within ``BF16_ULPS`` bf16 ulps of that
    scale (both round operands and each layer's output to bf16 at the same
    points, but an f32 sum that differs in its last bit can round to the
    other bf16 neighbour, and the next layer carries that on).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanobjectnn_tpu.nn import xconv as jxconv
from scanobjectnn_tpu.ops import grouping as jgrouping
from scanobjectnn_tpu.ops.pallas.knn_kernel import duplicate_mask_pallas
from scanobjectnn_torch.convert import load_jax_variables
from scanobjectnn_torch.nn import xconv
from scanobjectnn_torch.ops.cuda.dupmask_kernel import duplicate_mask_kernel, duplicate_mask_plain

MARGIN, CLEAR_SHARE, D2_ATOL = 2e-6, 0.9, 1e-6
F32_TOL, BF16_ULPS = 1e-5, 2
DTYPES = {"f32": (jnp.float32, None), "bf16": (jnp.bfloat16, torch.bfloat16)}


def dup_cloud(seed, b, n, nan=False):
    """Points in [-1, 1)^3 with copies of earlier points (and one copy of a
    later point), a -0.0/0.0 pair and, with ``nan``, a NaN point and its
    copy."""
    rng = np.random.RandomState(seed)
    x = (rng.rand(b, n, 3) * 2 - 1).astype(np.float32)
    for c in range(b):
        src = rng.choice(n // 2, n // 16, replace=False)
        x[c, n // 2 + rng.choice(n // 2, n // 16, replace=False)] = x[c, src]
    x[:, 2] = x[:, n - 1]  # a twin that comes later: marks n - 1, not 2
    x[:, 5] = (0.0, 0.25, -0.5)
    x[:, n // 2 + 1] = (-0.0, 0.25, -0.5)
    if nan:
        x[0, 7, 2] = np.nan
        x[0, n - 3] = x[0, 7]
    return x


def fill(shapes, seed):
    """A JAX ``variables`` tree of the given shapes: Glorot-scaled normal
    kernels, BN scale about 1 and small biases, random positive running
    stats (so every BN matters)."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "var":
            v = 0.5 + np.abs(rng.randn(*s.shape))
        elif name == "mean":
            v = 0.1 * rng.randn(*s.shape)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.randn(*s.shape)
        elif name == "bias":
            v = 0.1 * rng.randn(*s.shape)
        else:
            rest = math.prod(s.shape[:-2])
            v = rng.randn(*s.shape) * math.sqrt(2.0 / (rest * (s.shape[-2] + s.shape[-1])))
        return jnp.asarray(v, jnp.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def jax_variables(module, seed, *args):
    shapes = jax.eval_shape(lambda *a: module.init(jax.random.PRNGKey(0), *a), *args)
    return fill(shapes, seed)


def masked_d2_64(queries, points):
    """float64 squared distances with earlier points' duplicates pushed
    past every unique point (the ranking both branches realise)."""
    q, p = np.asarray(queries, np.float64), np.asarray(points, np.float64)
    d2 = ((q[:, :, None, :] - p[:, None, :, :]) ** 2).sum(-1)
    dup = duplicate_mask_plain(torch.from_numpy(np.asarray(points))).numpy().astype(bool)
    return np.where(dup[:, None, :], d2 + 2.0 * d2.max() + 1.0, d2)


def clear_rows(queries, points, k):
    """Rows whose float64 ranking is clear up to the (k+1)-th (module doc)."""
    ds = np.sort(masked_d2_64(queries, points), axis=-1)[..., : k + 1]
    return (np.diff(ds, axis=-1) > MARGIN * (1.0 + ds[..., 1:])).all(-1)


def check_idx(got, want, queries, points, k, what):
    clear = clear_rows(queries, points, min(k, np.asarray(points).shape[1] - 1))
    same = (np.asarray(got) == np.asarray(want)).all(-1)
    assert same[clear].all(), f"{what}: {int((~same & clear).sum())} clear rows pick other neighbours"
    print(f"{what}: {clear.mean():.4f} of rows clear the margin, {same.mean():.4f} equal")
    assert clear.mean() >= CLEAR_SHARE
    return float(clear.mean())


class PortKnn:
    """Records every call of the port's ``knn_indices_general`` made
    through ``nn/xconv.py`` (the inputs and the indices), in call order."""

    def __init__(self, monkeypatch):
        self.calls = []
        inner = xconv.knn_indices_general

        def rec(queries, points, k, unique=True):
            d2, idx = inner(queries, points, k, unique)
            self.calls.append((queries.detach().float().numpy(), points.detach().float().numpy(), k,
                               d2.numpy(), idx.numpy()))
            return d2, idx

        monkeypatch.setattr(xconv, "knn_indices_general", rec)


def feed_jax(monkeypatch, calls):
    """Check each recorded call's indices against JAX's own
    ``knn_indices_general`` on the same points (rows that clear the
    margin), then make the JAX XConv take them, in call order.  Returns the
    shares of rows checked."""
    shares = []
    for q, p, k, _, idx in calls:
        _, own = jxconv.knn_indices_general(jnp.asarray(q), jnp.asarray(p), k)
        shares.append(check_idx(idx, own, q, p, k, f"kNN {q.shape[1]}x{p.shape[1]} k={k}"))
    order = iter(calls)

    def given(queries, points, k, unique=True):
        q, p, kk, d2, idx = next(order)
        assert kk == k and queries.shape == q.shape and points.shape == p.shape
        return jnp.asarray(d2), jnp.asarray(idx)

    monkeypatch.setattr(jxconv, "knn_indices_general", given)
    return shares


# ------------------------------------------------------------------ #12


@pytest.mark.parametrize("n", [1, 128, 129, 384, 1000])
def test_duplicate_mask_plain_matches_jax(n):
    # N = 1: a lone point is never a duplicate; N = 129, 1000: clouds off the
    # card kernel's 128-point tiles.
    x = dup_cloud(n, 3, n, nan=True) if n > 1 else np.full((3, 1, 3), 0.5, np.float32)
    got = duplicate_mask_plain(torch.from_numpy(x))
    assert torch.equal(duplicate_mask_kernel(torch.from_numpy(x)), got)  # the CPU wrapper
    want = np.asarray(jxconv._duplicate_mask(jnp.asarray(x))).astype(np.float32)
    pallas = np.asarray(duplicate_mask_pallas(jnp.asarray(x), interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), pallas)
    assert got.dtype == torch.float32 and got.shape == (3, n)
    if n == 1:
        assert (got == 0).all()
        return
    assert (got[:, n // 2 + 1] == 1).all() and (got[:, n - 1] == 1).all() and (got[:, 2] == 0).all()
    assert got[0, 7] == 0 and got[0, n - 3] == 0  # NaN equals nothing


# ------------------------------------------------------- both kNN branches


@pytest.mark.parametrize("k", [8, 24, 48, 64])
def test_kernel_branch_glue_matches_pallas(k):
    # The kernel branch's norm bound, dup bias and kNN (the wrappers' plain
    # versions on the CPU) against the TPU branch in interpret mode.
    p = dup_cloud(k, 2, 192)
    q = np.ascontiguousarray(p[:, ::3][:, :64] + np.float32(0.01))
    d2, idx = xconv._knn_indices_kernel(torch.from_numpy(q), torch.from_numpy(p), k, True)
    jd2, jidx = jxconv._knn_indices_pallas(jnp.asarray(q), jnp.asarray(p), k, True, interpret=True)
    assert idx.dtype == torch.int32 and idx.shape == (2, 64, k)
    check_idx(idx.numpy(), np.asarray(jidx), q, p, k, f"kernel branch k={k}")
    big = 4.0 * (q * q).sum(-1).max() + 4.0 * (p * p).sum(-1).max() + 1.0
    unique = d2.numpy() < big
    assert unique[..., : k // 2].all()
    np.testing.assert_allclose(d2.numpy()[unique], np.asarray(jd2)[unique], atol=D2_ATOL)


@pytest.mark.parametrize("k", [8, 24, 48, 96])
def test_plain_branch_matches_lax(k):
    # The CPU's branch: the global max(d2) on duplicate columns, a stable
    # top-k; k = 96 is above the kernel's cap in any case.
    p = dup_cloud(100 + k, 2, 256)
    q = p[:, :128]
    d2, idx = xconv.knn_indices_general(torch.from_numpy(q), torch.from_numpy(p), k)
    jd2, jidx = jxconv.knn_indices_general(jnp.asarray(q), jnp.asarray(p), k)
    assert idx.dtype == torch.int32 and idx.shape == (2, 128, k)
    check_idx(idx.numpy(), np.asarray(jidx), q, p, k, f"plain branch k={k}")
    bound = float(np.asarray(jgrouping.pairwise_squared_distance(jnp.asarray(q), jnp.asarray(p))).max())
    unique = d2.numpy() <= bound
    np.testing.assert_allclose(d2.numpy()[unique], np.asarray(jd2)[unique], atol=D2_ATOL)


def test_unique_knn_skips_duplicates():
    # The JAX package's own example (tests/test_components.py).
    pts = np.random.RandomState(0).rand(1, 8, 3).astype(np.float32)
    pts[0, 3] = pts[0, 1]
    pts[0, 6] = pts[0, 1]
    for fn in (xconv.knn_indices_general, lambda q, p, k: xconv._knn_indices_kernel(q, p, k, True)):
        _, idx = fn(torch.from_numpy(pts[:, 1:2]), torch.from_numpy(pts), 5)
        assert idx[0, 0, 0] == 1 and not {3, 6} & set(idx[0, 0].tolist())


# ------------------------------------------------------ sorting, sampling


@pytest.mark.parametrize("method", ["l2", "cxyz", "czyx"])
def test_sort_points_matches_jax(method):
    rng = np.random.RandomState(3)
    pts = (rng.randint(-4, 5, (2, 64, 3)) * 0.25).astype(np.float32)  # dyadic: exact keys, many ties
    idx = np.stack([rng.permutation(64)[:32].reshape(4, 8) for _ in range(2)]).astype(np.int32)
    idx = np.repeat(idx, 4, axis=1)  # [2, 16, 8]
    idx[:, :, 7] = idx[:, :, 6]  # a slot repeated: an exact tie
    got = xconv.sort_points(torch.from_numpy(pts), torch.from_numpy(idx), method)
    want = jxconv.sort_points(jnp.asarray(pts), jnp.asarray(idx), method)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_inverse_density_sample():
    pts = dup_cloud(7, 2, 128)
    got = xconv.inverse_density_logits(torch.from_numpy(pts), 8)
    pj = jnp.asarray(pts)
    neg, _ = jax.lax.top_k(-jgrouping.pairwise_squared_distance(pj, pj), 8)  # the JAX function's body
    want = jnp.log(jnp.abs(jnp.mean(-neg, axis=-1)) + 1e-8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    draws = [xconv.inverse_density_sample(torch.Generator().manual_seed(s), torch.from_numpy(pts), 8, 64)
             for s in (0, 0, 1)]
    assert draws[0].dtype == torch.int32 and draws[0].shape == (2, 64)
    assert torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[2])
    assert int(draws[0].min()) >= 0 and int(draws[0].max()) < 128


# ----------------------------------------------------------------- layers


def _compare(got, want, dtype, what):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert tuple(got.shape) == want.shape, what
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got.float().detach().numpy() - want).max())
    tol = F32_TOL * scale if dtype == "f32" else BF16_ULPS * 2.0 ** (math.floor(math.log2(scale)) - 7)
    print(f"{what} {dtype}: max abs err {err:.3e} (bound {tol:.3e})")
    assert err <= tol, what


# name: (JAX module, port module, input shape)
LAYERS = {
    "elu_dense": (lambda d: jxconv.EluDense(24, dtype=d), lambda d: xconv.EluDense(12, 24, dtype=d), (2, 32, 12)),
    "elu_dense_logits": (lambda d: jxconv.EluDense(5, with_bn=False, activation=False, dtype=d),
                         lambda d: xconv.EluDense(12, 5, with_bn=False, activation=False, dtype=d), (2, 32, 12)),
    "window": (lambda d: jxconv._WindowConv(36, dtype=d), lambda d: xconv._WindowConv(6, 3, 36, dtype=d),
               (2, 16, 6, 3)),
    "depthwise": (lambda d: jxconv._DepthwiseWindowConv(6, dtype=d),
                  lambda d: xconv._DepthwiseWindowConv(6, 5, 6, dtype=d), (2, 16, 6, 5)),
    "depthwise_no_elu": (lambda d: jxconv._DepthwiseWindowConv(6, activation=False, dtype=d),
                         lambda d: xconv._DepthwiseWindowConv(6, 5, 6, activation=False, dtype=d), (2, 16, 6, 5)),
    "separable": (lambda d: jxconv._SeparableWindowConv(20, depth_multiplier=3, dtype=d),
                  lambda d: xconv._SeparableWindowConv(6, 5, 20, 3, dtype=d), (2, 16, 6, 5)),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layers_match_jax(name, dtype, train):
    make_jax, make_port, shape = LAYERS[name]
    jdtype, tdtype = DTYPES[dtype]
    x = np.random.RandomState(len(name)).randn(*shape).astype(np.float32)
    jmod = make_jax(jdtype)
    variables = jax_variables(jmod, 5, jnp.asarray(x))
    port = load_jax_variables(make_port(tdtype), variables).train(train)
    got = port(torch.from_numpy(x))
    if train:
        want, mutated = jmod.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
        stats = dict(port.named_buffers())
        for key in ("mean", "var") if "bn" in mutated.get("batch_stats", {}) else ():
            ref = np.asarray(mutated["batch_stats"]["bn"][key])
            np.testing.assert_allclose(stats[f"bn.{key}"].numpy(), ref, rtol=1e-5, atol=1e-6, err_msg=key)
    else:
        want = jmod.apply(variables, jnp.asarray(x), train=False)
    # The logits layer's f32 bias promotes its bf16 product to f32, as in JAX.
    assert got.dtype == (torch.float32 if want.dtype == jnp.float32 else torch.bfloat16)
    _compare(got, want, dtype, name)


def test_bn_momentum_is_fixed():
    # BN(0.99) whatever the caller's schedule: one training call moves the
    # running mean by 1% of the batch mean.
    layer = xconv.EluDense(4, 3).train()
    x = torch.randn(64, 4, generator=torch.Generator().manual_seed(0))
    y = torch.nn.functional.elu(x @ layer.kernel)
    layer(x)
    torch.testing.assert_close(layer.bn.mean, 0.01 * y.mean(0).detach(), rtol=1e-5, atol=1e-7)


def test_glorot_normal_init_matches_flax():
    # flax's fans for a 3-D (K, C, M) kernel are K·C and K·M.
    for shape in ((16, 32, 8), (96, 48)):
        want = np.asarray(jxconv.glorot_normal(jax.random.PRNGKey(0), shape, jnp.float32)).std()
        got = xconv.glorot_normal_(torch.empty(shape), torch.Generator().manual_seed(0))
        assert abs(float(got.std()) / want - 1) < 0.05, shape
        bound = 2 * math.sqrt(2.0 / (math.prod(shape[:-2]) * (shape[-2] + shape[-1]))) / 0.87962566103423978
        assert float(got.abs().max()) <= bound


# ------------------------------------------------------------------ XConv


XCONVS = {  # name: (with_X_transformation, with_global, with previous features)
    "first_layer": (True, False, False),
    "with_features_and_global": (True, True, True),
    "no_x_transform": (False, False, True),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(XCONVS))
def test_xconv_matches_jax(monkeypatch, name, dtype):
    with_x, with_global, with_fts = XCONVS[name]
    jdtype, tdtype = DTYPES[dtype]
    pts = dup_cloud(11, 2, 128)
    qrs = pts[:, :64]
    fts = np.random.RandomState(12).randn(2, 128, 10).astype(np.float32) if with_fts else None
    kw = dict(K=8, D=2, C=16, C_pts_fts=6, depth_multiplier=2, with_X_transformation=with_x,
              with_global=with_global)
    jmod = jxconv.XConv(**kw, dtype=jdtype)
    args = [jnp.asarray(a) if a is not None else None for a in (pts, fts, qrs)]
    variables = jax_variables(jmod, 13, *args)
    port = load_jax_variables(xconv.XConv(**kw, c_fts=10 if with_fts else 0, dtype=tdtype), variables).eval()
    fts_t = None if fts is None else torch.from_numpy(fts).to(tdtype or torch.float32)
    with monkeypatch.context() as mp, torch.no_grad():
        rec = PortKnn(mp)
        got = port(torch.from_numpy(pts), fts_t, torch.from_numpy(qrs))
    assert len(rec.calls) == 1
    feed_jax(monkeypatch, rec.calls)
    want = jmod.apply(variables, args[0], None if fts is None else args[1].astype(jdtype), args[2])
    assert got.shape == (2, 64, 16 + (4 if with_global else 0)) and got.dtype == (tdtype or torch.float32)
    _compare(got, want, dtype, f"XConv {name}")
