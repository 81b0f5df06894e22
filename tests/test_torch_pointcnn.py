"""PyTorch port, the PointCNN slice: full-width ``pointcnn_cls``
(``modelnet_x3_l4``) and ``pointcnn_seg`` (``object_dataset_x3``) forwards
on the CPU at B=2, N=512 against the JAX models on the same weights, in f32
and bf16; the weights carried across; narrow settings with FPS and
inverse-density sampling; the registry, recipes and losses.

The JAX side is jitted ``model.apply(train=False)``, which takes the lax
paths (the CPU default).  Its variables are the shapes of its own init
filled from a seed (``test_torch_xconv.fill``), with random positive BN
running stats, loaded into the port with ``load_jax_variables``.

Neighbours.  Every kNN of PointCNN runs on input points (the cloud or a
prefix of it), the same bits on both sides, but JAX's squared distances
come from an einsum and the port's from sums in ascending channel order: a
near-tie can rank two points apart, and the rest of the model would then
differ by far more than rounding.  So each of the port's kNN calls (four in
``pointcnn_cls``, nine in ``pointcnn_seg``) is checked against JAX's own
``knn_indices_general`` on the rows that clear the float64 margin of
``test_torch_xconv.check_idx``, and the JAX model is fed the port's indices
(``scanobjectnn_tpu.nn.xconv.knn_indices_general`` patched in the test
only).  The cloud holds copies of earlier points (from the fourth layer's
384 points on) and a -0.0/0.0 pair.

Tolerances: ``logits``, ``point_logits`` and ``seg_logits`` in f32 within
``F32_TOL`` x max(1, |ref|max) (sums in other orders); in bf16, where both
sides round at the same points, within ``BF16_ULPS`` bf16 ulps of that
scale.  The predicted classes equal, and ``SEG_AGREEMENT`` of the per-point
argmaxes.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanobjectnn_tpu import models as jzoo
from scanobjectnn_tpu.models import pointcnn as jpointcnn
from scanobjectnn_torch.convert import load_jax_variables
from scanobjectnn_torch.models import MODEL_REGISTRY, get_model, get_recipe, pointcnn

from tests.test_torch_xconv import DTYPES, PortKnn, dup_cloud, feed_jax, fill

B, N, CLASSES = 2, 512, 15
F32_TOL, BF16_ULPS, SEG_AGREEMENT = 1e-5, 2, 0.99
MODELS = ("pointcnn_cls", "pointcnn_seg")


@pytest.fixture(scope="module")
def points():
    return dup_cloud(21, B, N)


def jax_model(name, dtype=jnp.float32, setting=None):
    kw = {} if setting is None else {"setting": setting}
    return jzoo.get_model(name, dtype=dtype, **kw)[0]


def jax_variables(model, x, seed):
    return fill(jax.eval_shape(lambda a: model.init(jax.random.PRNGKey(0), a, train=False), x), seed)


@pytest.fixture(scope="module")
def variables(points):
    return {name: jax_variables(jax_model(name), jnp.asarray(points), 1 + i) for i, name in enumerate(MODELS)}


def _check_outputs(got, ref, dtype, what):
    assert sorted(got) == sorted(ref)
    for key in ("logits", "point_logits", "seg_logits"):
        if key not in ref:
            continue
        want = np.asarray(ref[key], np.float32)
        out = got[key]
        # The logits layers add an f32 bias: f32 outputs in bf16 too.
        assert out.shape == want.shape and out.dtype == torch.float32 and ref[key].dtype == jnp.float32, key
        out = out.numpy()
        scale = max(1.0, float(np.abs(want).max()))
        assert float(np.abs(want).max()) > 0.1  # the activations did not vanish
        err = float(np.abs(out - want).max())
        tol = F32_TOL * scale if dtype == "f32" else BF16_ULPS * 2.0 ** (math.floor(math.log2(scale)) - 7)
        print(f"{what} {key}: max abs err {err:.3e} (bound {tol:.3e})")
        assert err <= tol, key
        agree = float((out.argmax(-1) == want.argmax(-1)).mean())
        assert agree >= (SEG_AGREEMENT if key == "seg_logits" else 1.0), (key, agree)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", MODELS)
def test_matches_jax_on_the_ports_neighbours(monkeypatch, points, variables, name, dtype):
    jdtype, tdtype = DTYPES[dtype]
    tmodel = load_jax_variables(get_model(name, device="cpu", dtype=tdtype), variables[name]).eval()
    with monkeypatch.context() as mp, torch.no_grad():
        rec = PortKnn(mp)
        got = tmodel(torch.from_numpy(points))
    ks = [call[2] for call in rec.calls]
    # K·D per layer: xconv_1-4 (8, 24, 32, 48), then xdconv_1-5 (96, 96, 72, 48, 32).
    assert ks == ([8, 24, 32, 48] + ([96, 96, 72, 48, 32] if name == "pointcnn_seg" else []))
    shares = feed_jax(monkeypatch, rec.calls)
    print(f"{name} {dtype}: shares of rows checked per kNN {[round(s, 4) for s in shares]}")
    model = jax_model(name, jdtype)
    ref = jax.jit(lambda v, x: model.apply(v, x, train=False))(variables[name], jnp.asarray(points))
    _check_outputs(got, ref, dtype, f"{name} {dtype}")


def test_state_dict_names_match_jax_tree(variables):
    for name in MODELS:
        tmodel = load_jax_variables(get_model(name, device="cpu"), variables[name])  # strict
        params, buffers = dict(tmodel.named_parameters()), dict(tmodel.named_buffers())
        assert params["backbone.xconv_1.X_0.kernel"].shape == (8 * 3, 8 * 8)
        assert params["backbone.xconv_1.X_1.kernel"].shape == (8, 8, 8)  # 3-D depthwise kernels
        assert params["backbone.xconv_2.fts_conv.depthwise"].shape == (12, 12 + 48, 2)
        assert params["backbone.xconv_4.fts_global.kernel"].shape == (96, 96)
        assert "backbone.xconv_3.X_2.bn.var" in buffers
        if name == "pointcnn_cls":
            assert params["head.fc0.kernel"].shape == (384 + 96, 384)
            assert params["head.fc_logits.bias"].shape == (CLASSES,)
        else:
            assert params["cls_head.fc_class__logits.kernel"].shape == (192, CLASSES)
            assert params["seg_head.fc_seg__logits.kernel"].shape == (96, 2)
            assert params["backbone.xdconv_1_fuse.kernel"].shape == (384 + 480, 384)
            assert params["backbone.xdconv_4.fts_conv.depthwise"].shape == (8, 24 + 96, 1)


# A narrow setting for the sampling paths (x = 1, N = 128).
def narrow(module, sampling, seg=False):
    xconv = (module.XConvParam(8, 1, -1, 16), module.XConvParam(12, 2, 64, 32),
             module.XConvParam(8, 2, 32, 64, links=(1,)), module.XConvParam(8, 3, 32, 64))
    heads = dict(fc_params_classification=(module.FCParam(32, 0.0), module.FCParam(16, 0.5)),
                 fc_params_segmentation=(module.FCParam(16, 0.0),),
                 xdconv_params=(module.XDConvParam(8, 2, 3, 2), module.XDConvParam(8, 2, 2, 0))) if seg else \
        dict(fc_params=(module.FCParam(32, 0.0), module.FCParam(16, 0.8)))
    return module.PointCNNSetting(xconv_params=xconv, sampling=sampling, **heads)


def test_fps_sampling_matches_jax(monkeypatch):
    # FPS is deterministic: the port's sampled queries are JAX's; links
    # concatenate an earlier layer's features; the decoder runs on them.
    x = dup_cloud(31, B, 128)
    name, seg = "pointcnn_seg", True
    model = jax_model(name, setting=narrow(jpointcnn, "fps", seg))
    v = jax_variables(model, jnp.asarray(x), 5)
    tmodel = load_jax_variables(get_model(name, device="cpu", setting=narrow(pointcnn, "fps", seg)), v).eval()
    with monkeypatch.context() as mp, torch.no_grad():
        rec = PortKnn(mp)
        got = tmodel(torch.from_numpy(x))
    feed_jax(monkeypatch, rec.calls)
    ref = jax.jit(lambda vv, a: model.apply(vv, a, train=False))(v, jnp.asarray(x))
    _check_outputs(got, ref, "f32", f"{name} fps")


def test_inverse_density_sampling_draws_from_the_generator():
    model = get_model("pointcnn_cls", device="cpu", setting=narrow(pointcnn, "ids")).eval()
    x = torch.from_numpy(dup_cloud(32, B, 128))
    with torch.no_grad():
        runs = [model(x, generator=torch.Generator().manual_seed(s))["logits"] for s in (0, 0, 1)]
        # Without one, each sampling layer draws from a generator seeded 0,
        # as each JAX layer from PRNGKey(0).
        default = [model(x)["logits"] for _ in range(2)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    assert torch.equal(*default) and runs[0].shape == (B, CLASSES)


def test_dropout_rate_zero_draws_nothing():
    head = pointcnn._FCHead(8, (pointcnn.FCParam(6, 0.0), pointcnn.FCParam(4, 0.0)), 3).train()
    g = torch.Generator().manual_seed(0)
    state = g.get_state()
    head(torch.randn(5, 7, 8), g)
    assert torch.equal(g.get_state(), state)
    head.rates = (0.0, 0.8)
    out = head(torch.randn(5, 7, 8), g)
    assert not torch.equal(g.get_state(), state) and out.shape == (5, 7, 3)


def test_registry_recipes_and_losses():
    for name in MODELS:
        assert MODEL_REGISTRY[name].kind == jzoo.MODEL_REGISTRY[name].kind
        # The port's recipe is the step LR and the PointCNN augmentation;
        # every field the Trainer reads equals JAX's.
        got, want = get_recipe(name), jzoo.get_recipe(name)
        assert (want.lr_mode, want.augment) == ("steps", "pointcnn")
        for field in dataclasses.fields(got):
            assert getattr(got, field.name) == getattr(want, field.name), field.name
    assert get_recipe("dgcnn") is None and jzoo.get_recipe("dgcnn") is None
    rng = np.random.RandomState(0)
    outs = {"point_logits": rng.randn(4, 6, CLASSES).astype(np.float32),
            "seg_logits": rng.randn(4, 32, 2).astype(np.float32)}
    batch = {"labels": rng.randint(0, CLASSES, 4), "masks": rng.randint(0, 2, (4, 32))}
    for name in MODELS:
        got = MODEL_REGISTRY[name].loss({k: torch.from_numpy(v) for k, v in outs.items()},
                                        {k: torch.from_numpy(v) for k, v in batch.items()})[1]
        want = jzoo.get_model(name)[1]({k: jnp.asarray(v) for k, v in outs.items()},
                                       {k: jnp.asarray(v) for k, v in batch.items()})[1]
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-6, err_msg=f"{name} {key}")
