"""PyTorch port, 3DmFV-Net on the CPU: the GMM builders, the Fisher vector,
``3dmfv_net_cls`` (the static 5³ grid GMM and the learnable 3³ one) and
the 3DmFV plots, against the JAX package (and the static 3³ GMM for a
step).

GMMs: ``get_3d_grid_gmm``, ``get_2d_grid_gmm``, ``get_learned_gmm`` (EM from
a seeded draw) and ``get_gmm`` equal to JAX's bit for bit on the same
inputs and seed.

Fisher vector: B=2 clouds of N=128 points (the synthetic dataset, seed
``SEED``) at the 3³ and 5³ grids, against JAX's within rtol 1e-5 and atol
``FV_ATOL`` = 2e-6 (every feature is L2-normalised over the gaussians, so
values lie in [-1, 1]; f32 exp and log differ by an ulp between the two).

The model: weights drawn with numpy on the JAX tree (as
``tests/test_torch_pointnet.py``; the learnable GMM's parameters near
their start: log(w) + 0.1·N(0, 1), the means + 0.05·N(0, 1), the raw
stddevs + 0.1·N(0, 1)).  f32 forwards (eval) at B=2 within SSG's rtol 2e-4
and atol 2e-5 x max(1, |ref|max), the classes equal; bf16 forwards
within 0.05 x max(1, |ref|max) of JAX's bf16 forward (the SSG and DGCNN
bf16 bound), the classes equal.  One f32
``Trainer.train_step`` each of the static and the learnable GMM at the 3³
grid (the same layers as the 5³ grid's, at a third of the JAX compile
time; ``chip_smoke.py`` phase 16 holds the 5³ step on the card to the CPU)
(B=4, N=128, no augmentation, dropout the identity) against the JAX step in float64 (``jnp`` read as float64 also in
``nn/fisher.py`` and ``models/threedmfv.py``), the port's BatchNorms and
its Fisher vector in float64 (``nn.fisher.COMPUTE_DTYPE``; the model casts
the vector to f32, as JAX's) and the port's relu gates fed to the
reference, by the bounds of ``tests/test_torch_pointnet.py`` (the Dense and
conv biases before a training BN have a true gradient of 0).  The Fisher
vector in f32 is held to JAX's above; in a step its power normalisation's
gradient, 0.5/sqrt(|x|), amplifies the f32 rounding of a sum feature that
cancels to near 0: with it in f32 the learnable GMM's ``gmm_mu`` gradient
read 1.3e-3 of its scale (seed 5), in float64 below 1e-4.  The Fisher vector's
``sign(x)·sqrt(|x|)`` has a NaN gradient at an exact 0 on both sides; on
this batch (seed ``SEED``) no feature is 0, which the learnable step
checks.

Plots: each function of ``viz/fvplots.py`` writes the same PNG bytes as
JAX's on the same arrays (both saved at dpi 40 instead of 300, for time),
and where matplotlib is missing writes the same note.
"""

import builtins
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from scanobjectnn_tpu import models as jzoo
from scanobjectnn_tpu.models import threedmfv as jthreedmfv
from scanobjectnn_tpu.nn import fisher as jfisher
from scanobjectnn_tpu.viz import fvplots as jfvplots
from scanobjectnn_torch import convert
from scanobjectnn_torch.data.synthetic import make_synthetic_dataset
from scanobjectnn_torch.models import ThreeDmFVNet, get_model, threedmfv
from scanobjectnn_torch.nn import fisher
from scanobjectnn_torch.nn.layers import BatchNorm
from scanobjectnn_torch.viz import fvplots

from tests import test_torch_pointnet as pn
from tests.test_torch_seg_train import _bn_forward_f64

SEED = 3
B_FWD, B, N, CLASSES = 2, 4, 128, 4
FV_RTOL, FV_ATOL = 1e-5, 2e-6  # module doc
FWD_RTOL, FWD_ATOL = 2e-4, 2e-5
BF16_FWD_TOL = 0.05  # x max(1, |ref|max): test_bf16_forward_matches_jax
NAME = "3dmfv_net_cls"
CONFIGS = {"static5": {}, "static3": {"subdivisions": (3, 3, 3)},
           "learnable3": {"subdivisions": (3, 3, 3), "learnable_gmm": True}}
STEPS = ("static3", "learnable3")  # the 5³ step is held on the card against the CPU (chip_smoke.py phase 16)


@pytest.fixture(scope="module")
def batch():
    data, labels = make_synthetic_dataset(num_per_class=1, num_classes=CLASSES, num_points=N, seed=SEED)
    return {"points": data, "labels": labels}


def _gmm_leaf(names, shape, rng):
    base = jfisher.get_3d_grid_gmm((3, 3, 3), 0.04)
    if names[-1] == "gmm_w_logits":
        return np.log(base.weights) + 0.1 * rng.randn(*shape)
    if names[-1] == "gmm_mu":
        return base.means + 0.05 * rng.randn(*shape)
    if names[-1] == "gmm_sigma_raw":
        return np.log(np.expm1(base.stddevs)) + 0.1 * rng.randn(*shape)
    return None


@pytest.fixture(scope="module")
def variables():
    return {key: pn.random_variables(jzoo.get_model(NAME, num_classes=CLASSES, **kw)[0], (B, N, 3), SEED + i,
                                     _gmm_leaf)
            for i, (key, kw) in enumerate(CONFIGS.items())}


# ---------------------------------------------------------------- the GMMs


@pytest.mark.parametrize("subdivisions,variance", [((5, 5, 5), 0.04), ((3, 3, 3), 0.04), ((2, 3, 4), 0.02)])
def test_3d_grid_gmm_equals_jax(subdivisions, variance):
    got, want = fisher.get_3d_grid_gmm(subdivisions, variance), jfisher.get_3d_grid_gmm(subdivisions, variance)
    for key in ("weights", "means", "stddevs"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key))
        assert getattr(got, key).dtype == getattr(want, key).dtype
    assert got.subdivisions == want.subdivisions and got.n_gaussians == want.n_gaussians


@pytest.mark.parametrize("subdivisions", [(5, 5), (3, 4)])
def test_2d_grid_gmm_equals_jax(subdivisions):
    got, want = fisher.get_2d_grid_gmm(subdivisions, 0.05), jfisher.get_2d_grid_gmm(subdivisions, 0.05)
    for key in ("weights", "means", "stddevs"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key))


@pytest.mark.parametrize("n_gaussians,seed", [(4, 0), (9, 5)])
def test_learned_gmm_equals_jax(n_gaussians, seed):
    points = np.random.RandomState(11).randn(400, 3)
    got = fisher.get_learned_gmm(points, n_gaussians, seed=seed)
    want = jfisher.get_learned_gmm(points, n_gaussians, seed=seed)
    for key in ("weights", "means", "stddevs"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key))
    assert got.subdivisions == want.subdivisions == (n_gaussians,)


def test_get_gmm_dispatches_as_jax():
    points = np.random.RandomState(12).randn(2, 100, 3)
    for kw in ({"n_gaussians": 4}, {"n_gaussians": 3, "d": 2}, {"n_gaussians": 5, "type": "learn"}):
        got, want = fisher.get_gmm(points, **kw), jfisher.get_gmm(points, **kw)
        np.testing.assert_array_equal(got.means, want.means)
        np.testing.assert_array_equal(got.stddevs, want.stddevs)
    for kw, match in (({"n_gaussians": 3, "d": 4}, "D=2 or D=3"), ({"n_gaussians": 3, "type": "kmeans"}, "grid"),
                      ({"n_gaussians": (2, 2), "type": "learn"}, "scalar")):
        with pytest.raises(ValueError, match=match):
            fisher.get_gmm(points, **kw)
    with pytest.raises(ValueError, match="requires"):
        fisher.get_gmm(None, 3, type="learn")


# --------------------------------------------------------- the Fisher vector


@pytest.mark.parametrize("res", [3, 5])
def test_fisher_vector_matches_jax(batch, res):
    gmm = fisher.get_3d_grid_gmm((res,) * 3, 0.04)
    points = batch["points"][:B_FWD]
    want = np.asarray(jax.jit(jfisher.fisher_vector)(jnp.asarray(points), gmm.weights, gmm.means, gmm.stddevs))
    got = fisher.fisher_vector(torch.from_numpy(points), gmm.weights, gmm.means, gmm.stddevs).numpy()
    assert got.shape == want.shape == (B_FWD, 20, res ** 3)
    np.testing.assert_allclose(got, want, rtol=FV_RTOL, atol=FV_ATOL)
    flat = fisher.fisher_vector(torch.from_numpy(points), gmm.weights, gmm.means, gmm.stddevs, flatten=True)
    np.testing.assert_array_equal(flat.numpy(), got.reshape(B_FWD, -1))


# ----------------------------------------------------------------- the model


def _port(key, variables):
    model = get_model(NAME, device="cpu", num_classes=CLASSES, **CONFIGS[key])
    return convert.load_jax_variables(model, variables[key])


@pytest.mark.parametrize("key", sorted(CONFIGS))
def test_jax_variables_load_strictly(variables, key):
    model = _port(key, variables)  # strict: every name and shape
    assert model.inception1.conv3.Conv_0.kernel.shape == (5, 5, 5, 64, 32)
    assert model.fc1.kernel.shape[0] == 1536 * (8 if key == "static5" else 1)  # the grid after two pools
    # The static GMM is in no state_dict, as in no JAX tree.
    assert any(name.startswith("gmm") for name in model.state_dict()) == (key == "learnable3")


def test_learnable_gmm_starts_at_the_grid():
    model = ThreeDmFVNet(subdivisions=(3, 3, 3), learnable_gmm=True)
    gmm = jfisher.get_3d_grid_gmm((3, 3, 3), 0.04)
    w, mu, sigma = (t.detach().numpy() for t in model.gmm_params())
    np.testing.assert_allclose(w, gmm.weights, rtol=1e-6)
    np.testing.assert_allclose(mu, gmm.means, rtol=1e-6)
    np.testing.assert_allclose(sigma, gmm.stddevs, rtol=1e-6)


@pytest.mark.parametrize("key", ["static5", "learnable3"])
def test_f32_forward_matches_jax(batch, variables, key):
    points = batch["points"][:B_FWD]
    jmodel = jzoo.get_model(NAME, num_classes=CLASSES, **CONFIGS[key])[0]
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False)["logits"])(variables[key],
                                                                                      jnp.asarray(points)))
    with torch.no_grad():
        got = _port(key, variables).eval()(torch.from_numpy(points))["logits"].numpy()
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=FWD_RTOL, atol=FWD_ATOL * scale)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def feeds_train_bn(param_name: str) -> bool:
    """A bias before a training BN: every ``Conv_0`` and fc1-fc3."""
    *_, layer, leaf = ["", *param_name.split(".")]
    return leaf == "bias" and layer in ("Conv_0", "fc1", "fc2", "fc3")


@pytest.mark.parametrize("key", STEPS)
def test_f32_step_matches_jax_f64(batch, variables, key):
    gates = pn.Gates()
    fv_zero = []
    real_fv = fisher.fisher_vector

    def fisher_vector(*args):
        fv = real_fv(*args)
        fv_zero.append(int((fv == 0).sum()))
        return fv

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(BatchNorm, "forward", _bn_forward_f64)
        mp.setattr(fisher, "COMPUTE_DTYPE", torch.float64)
        mp.setattr("scanobjectnn_torch.models.threedmfv.fisher_vector", fisher_vector)
        gates.record(mp)
        metrics, grads, stats, _ = pn._port_step(mp, NAME, batch, variables[key], model_kwargs=CONFIGS[key])
    assert fv_zero == [0]  # no exact-zero feature (module doc)
    assert all(np.isfinite(g).all() for g in grads.values())
    with pytest.MonkeyPatch.context() as mp:
        ref = pn._jax_step_f64(mp, NAME, batch, variables[key], gates, modules=(jfisher, jthreedmfv),
                               model_kw=CONFIGS[key])
    n_zero = 4 * 5 + 3  # four convolutions an inception, fc1-fc3
    pn.hold_f32_step((metrics, grads, stats), ref, n_zero, feeds=feeds_train_bn)
    if key == "learnable3":
        assert all(np.abs(grads[n]).max() > 0 for n in ("gmm_w_logits", "gmm_mu", "gmm_sigma_raw"))


# ------------------------------------------- the deterministic backward


POOL_GRAD_TOL = 1e-6  # x max(1, |ref|max): the same sums of 27 or 125 terms in another order


@pytest.mark.parametrize("grid,k", [((5, 5, 5), 3), ((3, 3, 3), 3), ((2, 2, 2), 3), ((2, 3, 4), 3), ((3, 3, 3), 5)])
def test_avg_pool_backward_is_the_pool_of_the_gradient(grid, k):
    # _AvgPoolSame's backward (the same pool applied to dy) against autograd
    # through PyTorch's own avg_pool3d backward; the forward is unchanged.
    g = torch.Generator().manual_seed(sum(grid) + k)
    x = torch.randn(2, *grid, 6, generator=g, requires_grad=True)
    dy = torch.randn(2, *grid, 6, generator=g)
    got = threedmfv._avg_pool_same(x, k)
    (dx,) = torch.autograd.grad(got, x, dy)
    ref_x = x.detach().clone().requires_grad_()
    p = k // 2
    want = F.avg_pool3d(F.pad(ref_x.permute(0, 4, 1, 2, 3), (p, p) * 3), k, stride=1).permute(0, 2, 3, 4, 1)
    (want_dx,) = torch.autograd.grad(want, ref_x, dy)
    assert torch.equal(got, want)
    torch.testing.assert_close(dx, want_dx, rtol=0, atol=POOL_GRAD_TOL * max(1.0, float(want_dx.abs().max())))


def test_avg_pool_refuses_an_even_window():
    with pytest.raises(ValueError, match="odd window"):
        threedmfv._avg_pool_same(torch.zeros(1, 3, 3, 3, 2), 2)


@pytest.mark.parametrize("fails", [None, "forward", "backward"])
def test_cudnn_scope_puts_both_flags_back(monkeypatch, fails):
    # The scope as it runs on the card, forced on here: inside the
    # convolution and its backward TF32 is off and the deterministic
    # algorithms on; after them, also when one raises, the caller's values.
    cudnn = torch.backends.cudnn
    real_scope, real_conv, real_bwd = threedmfv._cudnn_exact, F.conv3d, torch.ops.aten.convolution_backward
    seen = []

    def conv3d(*args, **kw):
        seen.append(("forward", cudnn.allow_tf32, cudnn.deterministic))
        if fails == "forward":
            raise RuntimeError("forward failed")
        return real_conv(*args, **kw)

    def convolution_backward(*args):
        seen.append(("backward", cudnn.allow_tf32, cudnn.deterministic))
        if fails == "backward":
            raise RuntimeError("backward failed")
        return real_bwd(*args)

    monkeypatch.setattr(threedmfv, "_cudnn_exact", lambda on_card: real_scope(True))
    monkeypatch.setattr(threedmfv.F, "conv3d", conv3d)
    monkeypatch.setattr(torch.ops.aten, "convolution_backward", convolution_backward)
    conv = threedmfv._Conv(4, 5, 3)
    x = torch.randn(2, 3, 3, 3, 4, requires_grad=True)
    before = cudnn.allow_tf32, cudnn.deterministic
    try:
        for flags in ((True, False), (False, True)):
            cudnn.allow_tf32, cudnn.deterministic = flags
            seen.clear()
            try:
                conv(x).sum().backward()
            except RuntimeError as err:
                assert fails is not None and str(err) == f"{fails} failed"
            else:
                assert fails is None
            assert (cudnn.allow_tf32, cudnn.deterministic) == flags
            want = ["forward"] if fails == "forward" else ["forward", "backward"]
            assert seen == [(where, False, True) for where in want]
    finally:
        cudnn.allow_tf32, cudnn.deterministic = before
    assert x.grad is None or fails is None


def test_cudnn_scope_changes_nothing_off_the_card():
    cudnn = torch.backends.cudnn
    before = cudnn.allow_tf32, cudnn.deterministic
    with threedmfv._cudnn_exact(False):
        assert (cudnn.allow_tf32, cudnn.deterministic) == before


def test_bf16_is_refused_naming_the_roadmap_item():
    # The model once refused bf16; it now builds in bf16 (parameters f32)
    # and answers bf16 logits (held to JAX's by test_bf16_forward_matches_jax).
    model = ThreeDmFVNet(subdivisions=(3, 3, 3), num_classes=CLASSES, dtype=torch.bfloat16).eval()
    with torch.no_grad():
        logits = model(torch.rand(2, 64, 3) - 0.5)["logits"]
    assert logits.dtype == torch.bfloat16 and logits.shape == (2, CLASSES) and bool(torch.isfinite(logits).all())
    assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.mark.parametrize("key", ["static5", "learnable3"])
def test_bf16_forward_matches_jax(batch, variables, key):
    # The bf16 forward (eval) against JAX's bf16 forward on the same weights:
    # both round at their layers' outputs, in other orders (cuDNN / oneDNN
    # against XLA; the average pool's window sum in f32 against XLA's bf16
    # adds, tests/test_torch_mixed_threedmfv_train.py): within BF16_FWD_TOL
    # x max(1, |ref|max), the bf16 bound of the SSG, BGA and DGCNN
    # forwards, and the same classes.
    points = batch["points"][:B_FWD]
    jmodel = jzoo.get_model(NAME, num_classes=CLASSES, dtype=jnp.bfloat16, **CONFIGS[key])[0]
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False)["logits"])(variables[key], jnp.asarray(points))
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    model = convert.load_jax_variables(get_model(NAME, device="cpu", num_classes=CLASSES, dtype=torch.bfloat16,
                                                 **CONFIGS[key]), variables[key]).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(points))["logits"]
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    err = float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))
    print(f"3dmfv {key} bf16 logits: max err / scale {err:.3e}")
    assert err <= BF16_FWD_TOL
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


# ----------------------------------------------------------------- the plots


def _plot_calls(root: str, prefix: str):
    gmm = fisher.get_3d_grid_gmm((2, 2, 2), 0.04)
    rng = np.random.RandomState(4)
    fv = rng.uniform(-1, 1, (2, 20, 27)).astype(np.float32)
    pts = rng.randn(64, 3).astype(np.float32)
    seg = rng.randint(0, 3, 64)
    return [
        ("visualize_fv", (fv, os.path.join(root, prefix + "fv.png")), {"labels": ["a", "b"]}),
        ("visualize_fv", (fv[0].reshape(-1), os.path.join(root, prefix + "fv1.png")), {"normalization": False}),
        ("draw_gaussians", (gmm, os.path.join(root, prefix + "gmm.png")), {"points": pts}),
        ("visualize_pc", (pts, os.path.join(root, prefix + "pc.png")), {"title": "t"}),
        ("visualize_pc_seg", (pts, seg, [[1, 0, 0], [0, 1, 0], [0, 0, 1]], os.path.join(root, prefix + "seg.png")), {}),
        ("visualize_pc_seg_diff", (pts, seg, np.roll(seg, 1), os.path.join(root, prefix + "diff.png")), {}),
    ]


def test_plots_write_the_jax_modules_bytes(tmp_path, monkeypatch):
    matplotlib = pytest.importorskip("matplotlib")
    import matplotlib.figure

    # Both modules save at dpi 300; rendered at 40 here, for time, on both sides.
    real_savefig = matplotlib.figure.Figure.savefig
    monkeypatch.setattr(matplotlib.figure.Figure, "savefig", lambda self, path, **kw: real_savefig(
        self, path, **{**kw, "dpi": 40}))
    assert fvplots.MINMAX_DERIVATIVE_LABELS == jfvplots.MINMAX_DERIVATIVE_LABELS
    for module, prefix in ((jfvplots, "jax_"), (fvplots, "port_")):
        for fn, args, kw in _plot_calls(str(tmp_path), prefix):
            getattr(module, fn)(*args, **kw)
    for fn, args, _ in _plot_calls(str(tmp_path), "port_"):
        path = [a for a in args if isinstance(a, str)][0]
        with open(path, "rb") as f, open(path.replace("port_", "jax_"), "rb") as g:
            assert f.read() == g.read(), fn


def test_plots_without_matplotlib_write_a_note(tmp_path, monkeypatch):
    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kw):
        if name.startswith("matplotlib"):
            raise ImportError(name)
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    for module, prefix in ((jfvplots, "jax_"), (fvplots, "port_")):
        for fn, args, kw in _plot_calls(str(tmp_path), prefix):
            getattr(module, fn)(*args, **kw)
    port = sorted(p for p in os.listdir(tmp_path) if p.startswith("port_"))
    assert len(port) == 6 and all(p.endswith(".unavailable.txt") for p in port)
    for p in port:
        assert (tmp_path / p).read_bytes() == (tmp_path / p.replace("port_", "jax_")).read_bytes()
