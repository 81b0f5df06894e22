"""PyTorch port: EdgeConv's neighbour reductions (``edge_reduce``, the
plain version of ``csrc/edge.cu``) and the T-Net's neighbour gather
(``edge_gather_knn``), on the CPU, against the JAX package's
``edge_reduce_lax``, ``edge_reduce_pallas`` and ``edge_gather_knn`` (Pallas
interpret mode), forward and VJP; and the fused EdgeConv against the
unfused one and against the JAX EdgeConv.

Inputs are random clouds on which every query clears the k/(k+1) distance
margin of ``test_torch_knn_graph.py`` (asserted), so the graphs are equal;
the tie tests use dyadic lattice points, exact on both sides.

Tolerances, and why:
  * ``idx``, ``mmax``, ``mmin``, ``cntmax``, ``cntmin`` and the gathered
    rows: equal (the same neighbours, the same values);
  * ``s`` and ``q2``: the port sums in slot order, XLA in its own order;
    each is within (k-1) f32 ulps of the sum of the magnitudes of the exact
    sum, so the two within ``2·k·2^-24·Σ|terms|``, elementwise;
  * the VJP in ``vals`` against the lax VJP: within ``VJP_TOL`` x max(1,
    |ref|max) (the coefficients are the same; the scatter sums them in
    another order);
  * against the Pallas VJP: within ``PALLAS_VJP_TOL`` x max(1, |ref|max):
    its scatter sums a two-term bf16 split of the coefficients (about 17
    mantissa bits);
  * EdgeConv, fused against unfused and against JAX: outputs and BN stats
    rtol 1e-4 / atol 1e-5, gradients rtol 1e-3 / atol 1e-5 (the JAX
    package's own bounds for the same comparison: the A+B form reassociates
    the edge pre-activation); the Dense bias before the edge BN has a true
    gradient of 0 and is held to |g| <= 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanobjectnn_tpu.models import dgcnn as jdgcnn
from scanobjectnn_tpu.ops.grouping import batched_index_gather, knn_graph_lax
from scanobjectnn_tpu.ops.pallas import edge_kernel as jedge
from scanobjectnn_torch.convert import load_jax_variables
from scanobjectnn_torch.models.dgcnn import EdgeConv
from scanobjectnn_torch.ops.cuda.edge_kernel import REDUCTIONS, edge_gather_knn, edge_reduce

from tests.test_torch_knn_graph import clear_rows

VJP_TOL, PALLAS_VJP_TOL = 1e-5, 1e-4  # module doc
DIFF = ("mmax", "mmin", "s", "q2")  # the differentiable outputs


def _clouds(seed, b, n, cf, cv):
    rng = np.random.RandomState(seed)
    feats = rng.randn(b, n, cf).astype(np.float32)
    vals = rng.randn(b, n, cv).astype(np.float32)
    return feats, vals


def _lattice(seed, b, n, c, copies=4):
    """Dyadic lattice points, each repeated ``copies`` times, shuffled."""
    rng = np.random.RandomState(seed)
    base = rng.randint(-3, 4, (b, n // copies, c)).astype(np.float32) * 0.25
    return np.stack([p[rng.permutation(n)] for p in np.tile(base, (1, copies, 1))])


def _jax_reduce(fn, feats, vals, k):
    return fn(jnp.asarray(feats), jnp.asarray(vals), k)


def _assert_sums_close(got, want, g_abs, k, what):
    bound = 2 * k * 2.0 ** -24 * g_abs
    err = np.abs(got - want)
    assert (err <= bound).all(), f"{what}: max err {err.max()}, bound there {bound[err.argmax() // 1]}"


def _check_forward(feats, vals, k, ref, exact_sums=False):
    got = edge_reduce(torch.from_numpy(feats), torch.from_numpy(vals), k)
    assert sorted(got) == sorted(REDUCTIONS + ("idx",))
    np.testing.assert_array_equal(got["idx"].numpy(), np.asarray(ref["idx"]))
    for key in ("mmax", "mmin", "cntmax", "cntmin"):
        assert got[key].dtype == torch.float32
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]), err_msg=key)
    g = np.abs(vals[np.arange(vals.shape[0])[:, None, None], got["idx"].numpy()]).astype(np.float64)
    for key, mag in (("s", g.sum(2)), ("q2", (g * g).sum(2))):
        if exact_sums:
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]), err_msg=key)
        else:
            _assert_sums_close(got[key].numpy(), np.asarray(ref[key]), mag, k, key)
    return got


def _vjp_port(feats, vals, k, cot):
    v = torch.from_numpy(vals).requires_grad_()
    out = edge_reduce(torch.from_numpy(feats), v, k)
    loss = sum((out[key] * torch.from_numpy(cot[key])).sum() for key in DIFF)
    (grad,) = torch.autograd.grad(loss, v)
    return grad.numpy()


def _vjp_jax(fn, feats, vals, k, cot):
    def f(v):
        out = fn(jnp.asarray(feats), v, k)
        return tuple(out[key] for key in DIFF)

    _, pullback = jax.vjp(f, jnp.asarray(vals))
    return np.asarray(pullback(tuple(jnp.asarray(cot[key]) for key in DIFF))[0])


def _assert_scaled(got, want, tol, what):
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    print(f"{what}: max err / scale {err / scale:.3e}")
    assert err <= tol * scale, f"{what}: {err} > {tol * scale}"


# (b, n, cf, cv, k, seed): EdgeConv 1 (3 -> 64) and 2-4 (64 -> 64) at k=20,
# and the JAX package's own test shape; seeds whose clouds clear the margin.
CASES = {
    "ec1_k20": (2, 128, 3, 64, 20, 151), "ec2_k20": (2, 128, 64, 64, 20, 200), "small_k8": (2, 64, 16, 16, 8, 88),
    # k = 40: on the card the graph is the general kNN kernel's
    "ec1_k40": (2, 128, 3, 64, 40, 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_edge_reduce_matches_lax_and_pallas(case):
    b, n, cf, cv, k, seed = CASES[case]
    feats, vals = _clouds(seed, b, n, cf, cv)
    assert clear_rows(feats, k).all()
    _check_forward(feats, vals, k, _jax_reduce(jedge.edge_reduce_lax, feats, vals, k))
    _check_forward(feats, vals, k, _jax_reduce(jedge.edge_reduce_pallas, feats, vals, k))
    rng = np.random.RandomState(1)
    cot = {key: rng.randn(b, n, cv).astype(np.float32) for key in DIFF}
    got = _vjp_port(feats, vals, k, cot)
    _assert_scaled(got, _vjp_jax(jedge.edge_reduce_lax, feats, vals, k, cot), VJP_TOL, f"{case} VJP vs lax")
    _assert_scaled(got, _vjp_jax(jedge.edge_reduce_pallas, feats, vals, k, cot), PALLAS_VJP_TOL,
                   f"{case} VJP vs pallas")


def test_edge_reduce_ties_split_the_gradient():
    # Duplicated lattice points: the graph ties at d² = 0 and the gathered
    # values tie in max and min (cntmax, cntmin > 1), and the backward
    # splits dmax and dmin evenly across the tied neighbours.
    feats = _lattice(0, 2, 128, 3)
    vals = np.concatenate([_lattice(1, 2, 128, 6), np.zeros((2, 128, 2), np.float32)], -1)
    k = 20
    ref = _jax_reduce(jedge.edge_reduce_lax, feats, vals, k)
    got = _check_forward(feats, vals, k, ref, exact_sums=True)
    assert float(got["cntmax"].max()) > 1 and float(got["cntmin"].max()) > 1
    assert bool((got["cntmax"][..., -2:] == k).all())  # the zero channels tie everywhere
    rng = np.random.RandomState(2)
    cot = {key: rng.randn(*vals.shape).astype(np.float32) for key in DIFF}
    got_vjp = _vjp_port(feats, vals, k, cot)
    _assert_scaled(got_vjp, _vjp_jax(jedge.edge_reduce_lax, feats, vals, k, cot), VJP_TOL, "ties VJP vs lax")
    _assert_scaled(got_vjp, _vjp_jax(jedge.edge_reduce_pallas, feats, vals, k, cot), PALLAS_VJP_TOL,
                   "ties VJP vs pallas")


def test_edge_gather_knn_matches_jax():
    _check_edge_gather_knn(3, 20)


def test_edge_gather_knn_at_k40_matches_jax():
    # k = 40: on the card the graph is the general kNN kernel's.
    _check_edge_gather_knn(1, 40)


def _check_edge_gather_knn(seed, k):
    feats, vals = _clouds(seed, 2, 128, 3, 64)
    assert clear_rows(feats, k).all()
    v = torch.from_numpy(vals).requires_grad_()
    rows, idx = edge_gather_knn(torch.from_numpy(feats), v, k)
    jrows, jidx = jedge.edge_gather_knn(jnp.asarray(feats), jnp.asarray(vals), k)
    lax_idx = knn_graph_lax(jnp.asarray(feats), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(lax_idx))
    np.testing.assert_array_equal(rows.detach().numpy(), np.asarray(jrows))
    np.testing.assert_array_equal(rows.detach().numpy(), np.asarray(batched_index_gather(jnp.asarray(vals), lax_idx)))
    cot = np.random.RandomState(4).randn(*rows.shape).astype(np.float32)
    (grad,) = torch.autograd.grad((rows * torch.from_numpy(cot)).sum(), v)
    _, pull = jax.vjp(lambda x: batched_index_gather(x, lax_idx), jnp.asarray(vals))
    _assert_scaled(grad.numpy(), np.asarray(pull(jnp.asarray(cot))[0]), VJP_TOL, "gather VJP vs lax")
    _, pull = jax.vjp(lambda x: jedge.edge_gather_knn(jnp.asarray(feats), x, k)[0], jnp.asarray(vals))
    _assert_scaled(grad.numpy(), np.asarray(pull(jnp.asarray(cot))[0]), PALLAS_VJP_TOL, "gather VJP vs pallas")


def test_tnet_bf16_sum_follows_the_lax_path():
    # The T-Net's a + bj in bf16: the JAX lax path gathers bf16 rows and
    # rounds the sum to bf16; its Pallas kernel returns f32 rows, so there
    # the sum stays f32.  The port follows the lax path (ROADMAP.md, known
    # quirks): bit for bit, and equal to the Pallas sum rounded to bf16.
    rng = np.random.RandomState(5)
    points = rng.randn(2, 128, 3).astype(np.float32)
    c2 = jnp.asarray(rng.randn(2, 128, 64), jnp.bfloat16)
    a = jnp.asarray(rng.randn(2, 128, 64), jnp.bfloat16)
    k = 20
    assert clear_rows(points, k).all()
    lax_rows = jedge.gather_neighbors(c2, knn_graph_lax(jnp.asarray(points), k))
    pallas_rows, _ = jedge.edge_gather_knn(jnp.asarray(points), c2, k)
    assert lax_rows.dtype == jnp.bfloat16 and pallas_rows.dtype == jnp.float32
    lax_sum = np.asarray((a[:, :, None] + lax_rows).astype(jnp.float32))
    pallas_sum = a[:, :, None] + pallas_rows
    assert pallas_sum.dtype == jnp.float32
    to_t = lambda x: torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)  # noqa: E731
    rows, _ = edge_gather_knn(torch.from_numpy(points), to_t(c2), k)
    port_sum = to_t(a)[:, :, None] + rows
    assert rows.dtype == port_sum.dtype == torch.bfloat16
    np.testing.assert_array_equal(port_sum.float().numpy(), lax_sum)
    np.testing.assert_array_equal(port_sum.float().numpy(), np.asarray(pallas_sum.astype(jnp.bfloat16).astype(jnp.float32)))
    differs = float((port_sum.float().numpy() != np.asarray(pallas_sum)).mean())
    print(f"the bf16 sum differs from the Pallas path's f32 sum on {differs:.3f} of the elements")
    assert differs > 0.1


def _edgeconv_pair(seed, flip_gamma=False, features=24, k=8):
    """A JAX EdgeConv's variables (random BN running stats, optionally half
    the gammas negative), and the port's fused and unfused EdgeConv loaded
    with them."""
    x = _clouds(seed, 2, 64, 16, 1)[0]
    variables = jdgcnn.EdgeConv(features=features, k=k).init(jax.random.PRNGKey(seed), jnp.asarray(x), False, 0.9)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    rng = np.random.RandomState(seed)
    stats = variables["batch_stats"]["mlp"]["bn_0"]
    stats["mean"] = (0.1 * rng.randn(features)).astype(np.float32)
    stats["var"] = (0.5 + np.abs(rng.randn(features))).astype(np.float32)
    if flip_gamma:
        scale = variables["params"]["mlp"]["bn_0"]["scale"].copy()
        scale[::2] = -scale[::2] - 0.3
        variables["params"]["mlp"]["bn_0"]["scale"] = scale
    ports = {}
    for fused in (True, False):
        ports[fused] = load_jax_variables(EdgeConv(16, features, k, fused=fused), variables)
    return x, variables, ports


@pytest.mark.parametrize("flip_gamma", [False, True], ids=["gamma_pos", "gamma_neg"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_edgeconv_fused_matches_unfused_and_jax(train, flip_gamma):
    # With half the gammas negative, bn∘relu decreases in those channels:
    # the fused path must take the neighbour min there (the JAX
    # test_negative_gamma_uses_min).
    x, variables, ports = _edgeconv_pair(7, flip_gamma)
    assert clear_rows(x, 8).all()
    jmod = jdgcnn.EdgeConv(features=24, k=8, fused=True)
    jy, jstats = jmod.apply(variables, jnp.asarray(x), train, 0.9, mutable=["batch_stats"])
    outs = {}
    for fused, mod in ports.items():
        mod.train(train)
        with torch.no_grad():
            outs[fused] = mod(torch.from_numpy(x), 0.9).numpy()
        np.testing.assert_allclose(outs[fused], np.asarray(jy), rtol=1e-4, atol=1e-5)
        if train:
            for key in ("mean", "var"):
                np.testing.assert_allclose(getattr(mod.mlp.bn_0, key).numpy(),
                                           np.asarray(jstats["batch_stats"]["mlp"]["bn_0"][key]), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(outs[True], outs[False], rtol=1e-4, atol=1e-5)


def test_edgeconv_fused_gradients_match_unfused():
    x, _, ports = _edgeconv_pair(8, flip_gamma=True)
    grads = {}
    for fused, mod in ports.items():
        xt = torch.from_numpy(x).requires_grad_()
        y = mod.train()(xt, 0.9)
        torch.tanh(y).sum().backward()
        grads[fused] = {"x": xt.grad.numpy(), **{n: p.grad.numpy() for n, p in mod.named_parameters()}}
    for name, want in grads[False].items():
        if name == "mlp.dense_0.bias":
            continue
        np.testing.assert_allclose(grads[True][name], want, rtol=1e-3, atol=1e-5, err_msg=name)
    for fused in (True, False):
        assert float(np.abs(grads[fused]["mlp.dense_0.bias"]).max()) <= 1e-5
