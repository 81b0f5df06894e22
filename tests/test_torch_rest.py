"""PyTorch port, the last modules on the CPU, each against its JAX
counterpart on the same numpy inputs drawn from a seed:

  * ``ops.prob_sample`` (the same CDF: indices equal) and
    ``ops.prob_sample_pdf`` (each side cumsums in f32, torch and XLA in
    their own orders, up to 4.9e-4 apart at N = 4096: indices equal except
    where a scaled draw lies within twice that gap of a CDF step; the count
    of such draws is printed, 0 on these seeds);
  * ``ops.auction_match`` and ``ops.emd_loss``: on seeded clouds without
    near-ties, ``matchl`` and ``matchr`` equal (also at a round cap of 2,
    the greedy fallback), the recovered permutation of a shuffled cloud,
    the loss within 1e-6 relative (the two sides' d² expansions round
    differently) and its gradients within 1e-5;
  * ``viz.show3d.render_frame``: pixel-equal to JAX's (the native splat),
    colours out of [0, 1] and a NaN channel included;
  * ``viz.interp_check``: ``interpolated_colors`` within 1e-6 of JAX's,
    the anchors' colours reproduced, and ``main``'s three PNGs, byte-equal
    to JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanobjectnn_tpu import ops as jops
from scanobjectnn_tpu.viz import interp_check as jinterp
from scanobjectnn_tpu.viz import show3d as jshow
from scanobjectnn_torch import ops
from scanobjectnn_torch.viz import interp_check, show3d

SEED = 0
EMD_RTOL, COLOR_ATOL = 1e-6, 1e-6


def test_ops_exports_the_jax_names():
    for name in ("prob_sample", "prob_sample_pdf", "auction_match", "emd_loss"):
        assert callable(getattr(ops, name)) and callable(getattr(jops, name))


@pytest.mark.parametrize("n", [10, 1000])
def test_prob_sample_indices_equal_jax(n):
    rng = np.random.RandomState(SEED + n)
    probs = rng.rand(2, n).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    cdf = np.cumsum(probs, axis=-1)
    u = rng.rand(2, 1000).astype(np.float32)
    u[0, :3] = [0.0, cdf[0, n // 2], 0.999999]  # a draw on a step and one past the last
    got = ops.prob_sample(torch.from_numpy(cdf), torch.from_numpy(u))
    want = np.asarray(jops.prob_sample(jnp.asarray(cdf), jnp.asarray(u)))
    assert got.dtype == torch.int32 and got.shape == (2, 1000)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [10, 1000, 4096])
def test_prob_sample_pdf_indices_equal_jax(n):
    rng = np.random.RandomState(SEED + 7 * n)
    pdf = rng.rand(3, n).astype(np.float32) * 3.0  # unnormalised
    u = rng.rand(3, 500).astype(np.float32)
    got = ops.prob_sample_pdf(torch.from_numpy(pdf), torch.from_numpy(u)).numpy()
    want = np.asarray(jops.prob_sample_pdf(jnp.asarray(pdf), jnp.asarray(u)))
    cdf_t = torch.cumsum(torch.from_numpy(pdf), -1).numpy()
    gap = float(np.abs(cdf_t - np.asarray(jnp.cumsum(jnp.asarray(pdf), -1))).max())
    scaled = u * cdf_t[:, -1:]
    near = np.abs(scaled[:, :, None] - cdf_t[:, None, :]).min(-1) <= 2 * gap
    print(f"N={n}: cumsum gap {gap:.3e}, {int(near.sum())} draws near a step")
    np.testing.assert_array_equal(got[~near], want[~near])
    assert got.min() >= 0 and got.max() < n


@pytest.mark.parametrize("b,n", [(2, 24), (2, 32), (3, 64)])
def test_auction_match_equals_jax(b, n):
    rng = np.random.RandomState(SEED + n)
    a, c = rng.rand(b, n, 3).astype(np.float32), rng.rand(b, n, 3).astype(np.float32)
    ml, mr = ops.auction_match(torch.from_numpy(a), torch.from_numpy(c))
    jl, jr = jops.auction_match(jnp.asarray(a), jnp.asarray(c))
    assert ml.dtype == mr.dtype == torch.int32
    np.testing.assert_array_equal(ml.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(mr.numpy(), np.asarray(jr))
    for row in ml.numpy():
        assert len(set(row.tolist())) == n  # a true assignment
    got = float(ops.emd_loss(torch.from_numpy(a), torch.from_numpy(c)))
    want = float(jops.emd_loss(jnp.asarray(a), jnp.asarray(c)))
    np.testing.assert_allclose(got, want, rtol=EMD_RTOL)


def test_auction_recovers_a_permutation_and_the_cap_falls_back_as_jax():
    rng = np.random.RandomState(SEED)
    pts = rng.rand(2, 24, 3).astype(np.float32)
    perm = rng.permutation(24)
    ml, _ = ops.auction_match(torch.from_numpy(pts), torch.from_numpy(pts[:, perm]))
    np.testing.assert_array_equal(ml.numpy(), np.tile(np.argsort(perm)[None], (2, 1)))
    assert float(ops.emd_loss(torch.from_numpy(pts), torch.from_numpy(pts[:, perm]))) < 1e-5
    # Two rounds cannot settle 32 bidders: the greedy fallback, as JAX's.
    a, c = rng.rand(1, 32, 3).astype(np.float32), rng.rand(1, 32, 3).astype(np.float32)
    ml, mr = ops.auction_match(torch.from_numpy(a), torch.from_numpy(c), max_iters=2)
    jl, jr = jops.auction_match(jnp.asarray(a), jnp.asarray(c), 2)
    np.testing.assert_array_equal(ml.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(mr.numpy(), np.asarray(jr))
    assert (mr.numpy() == -1).any()


def test_emd_loss_gradients_match_jax():
    import jax

    rng = np.random.RandomState(SEED + 1)
    a, c = rng.rand(2, 16, 3).astype(np.float32), rng.rand(2, 16, 3).astype(np.float32)
    ta, tc = torch.from_numpy(a).requires_grad_(), torch.from_numpy(c).requires_grad_()
    ops.emd_loss(ta, tc).backward()
    ja, jc = jax.grad(lambda x, y: jops.emd_loss(x, y), argnums=(0, 1))(jnp.asarray(a), jnp.asarray(c))
    for got, want in ((ta.grad, ja), (tc.grad, jc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
        assert float(got.abs().sum()) > 0


@pytest.mark.parametrize("n,size,radius,kw", [
    (100, 400, 8, {}),
    (2048, 800, 5, {"rot_x": 0.3, "rot_y": -1.1, "zoom": 1.3}),
    (500, 200, 3, {"background": (10, 20, 30)}),
    (64, 128, 1, {"normalize": False}),
])
def test_render_frame_is_jaxs_pixel_for_pixel(n, size, radius, kw):
    rng = np.random.RandomState(SEED + n)
    pts = rng.randn(n, 3).astype(np.float32) * (0.3 if kw.get("normalize") is False else 1.0)
    cols = rng.rand(n, 3).astype(np.float32)
    cols[0] = [-0.5, 1.5, np.nan]  # clamped below and above, a NaN channel
    got = show3d.render_frame(pts, cols, size=size, radius=radius, **kw)
    want = jshow.render_frame(pts, cols, size=size, radius=radius, **kw)
    assert got.dtype == np.uint8 and got.shape == (size, size, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(show3d.render_frame(pts, size=size, radius=radius, **kw),
                                  jshow.render_frame(pts, size=size, radius=radius, **kw))


def test_showpoints_saves_one_frame_without_a_window(tmp_path):
    pts = np.random.RandomState(SEED).randn(50, 3).astype(np.float32)
    got = show3d.showpoints(pts, output_path=str(tmp_path / "t.png"), interactive=False, size=64)
    want = jshow.showpoints(pts, output_path=str(tmp_path / "j.png"), interactive=False, size=64)
    np.testing.assert_array_equal(got, want)
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()


def test_interpolated_colors_match_jax_and_main_writes_jaxs_frames(tmp_path):
    xyz2 = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 1]], np.float32)
    colors2 = np.array([[0, 0, 1], [1, 0, 0], [0, 1, 0], [1, 1, 0]], np.float32)
    np.testing.assert_allclose(interp_check.interpolated_colors(xyz2, xyz2, colors2, "cpu"), colors2,
                               atol=COLOR_ATOL)
    q = np.random.RandomState(SEED).random_sample((100, 3)).astype(np.float32)
    got = interp_check.interpolated_colors(q, xyz2, colors2, "cpu")
    np.testing.assert_allclose(got, jinterp.interpolated_colors(q, xyz2, colors2), rtol=0, atol=COLOR_ATOL)
    assert got.min() >= -COLOR_ATOL and got.max() <= 1 + COLOR_ATOL
    paths = interp_check.main(str(tmp_path / "torch"), device="cpu")
    want = jinterp.main(str(tmp_path / "jax"))
    assert [p.rsplit("/", 1)[1] for p in paths] == [p.rsplit("/", 1)[1] for p in want]
    for p, w in zip(paths, want):
        with open(p, "rb") as f, open(w, "rb") as g:
            assert f.read() == g.read()


def test_interp_check_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where no CUDA device is present")
    xyz = np.zeros((4, 3), np.float32)
    with pytest.raises((RuntimeError, AssertionError)):
        interp_check.interpolated_colors(xyz, xyz, xyz)
