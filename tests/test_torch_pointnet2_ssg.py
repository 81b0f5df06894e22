"""PyTorch port, the whole slice: full-width ``pointnet2_cls_ssg`` inference
on the CPU at B=2, N=1024 against the JAX model on the same weights.

The JAX side runs ``model.apply(train=False)`` with the fused SA eval kernel
in Pallas interpret mode and without spatial bucketing
(``SCANOBJECTNN_FUSED_SA_EVAL=interpret``, ``SCANOBJECTNN_SA_BUCKET=off``):
the same hit rule and BN fold as the port, FPS through lax.  Random
positive BN running stats make the fold matter.  Tolerances: logits in f32
to rtol 2e-4 / atol 2e-5 x max(1, |ref|max); in bf16 to 0.05 x max(1,
|ref|max); predicted classes equal.

A second leg holds the port against the unfused JAX path in f32.  That
path's lax ball query tests ``sqrt`` of the EXPANDED distance, so a point
within rounding of a ball's boundary could flip; the inputs are pinned
instead of loosening the bound: the test asserts that no (centroid, point)
pair of SA1 or SA2 has |d2 - r2| < 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanobjectnn_tpu import models as jzoo
from scanobjectnn_torch.convert import load_jax_variables
from scanobjectnn_torch.data.synthetic import make_synthetic_dataset
from scanobjectnn_torch.models import PointNet2ClsSSG, get_model

DTYPES = {"f32": (jnp.float32, None), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def points():
    data, _ = make_synthetic_dataset(num_per_class=1, num_classes=2, num_points=1024, seed=3)
    return data.astype(np.float32)


@pytest.fixture(scope="module")
def variables(points):
    """JAX variables (the same tree for f32 and bf16 models): the reference
    init with random positive BN running stats."""
    model, _, _ = jzoo.get_model("pointnet2_cls_ssg")
    key = jax.random.PRNGKey(0)
    v = model.init({"params": key, "dropout": key}, jnp.asarray(points[:, :128]), train=False)
    rng = np.random.RandomState(1)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(
            0.1 + 0.1 * np.abs(rng.randn(*a.shape)) if p[-1].key == "var"
            else 0.05 * np.abs(rng.randn(*a.shape)),
            jnp.float32,
        ),
        v["batch_stats"],
    )
    return {**v, "batch_stats": stats}


def _jax_model(dtype):
    return jzoo.get_model("pointnet2_cls_ssg", dtype=dtype)[0]


def _torch_model(variables, tdtype):
    model = get_model("pointnet2_cls_ssg", device="cpu", dtype=tdtype)
    return load_jax_variables(model, variables).eval()


def _logits(model, pts):
    with torch.no_grad():
        return model(torch.from_numpy(pts))["logits"]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ssg_matches_jax_fused_interpret(monkeypatch, points, variables, dtype):
    jdtype, tdtype = DTYPES[dtype]
    jmodel = _jax_model(jdtype)
    monkeypatch.setenv("SCANOBJECTNN_FUSED_SA_EVAL", "interpret")
    monkeypatch.setenv("SCANOBJECTNN_SA_BUCKET", "off")
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(points), train=False)["logits"], np.float32)
    got = _logits(_torch_model(variables, tdtype), points)
    assert got.shape == (2, 15) and got.dtype == (tdtype or torch.float32)
    got = got.float().numpy()
    scale = max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(ref).max()) > 0.1  # the activations did not vanish
    if dtype == "f32":
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5 * scale)
    else:
        assert np.abs(got - ref).max() <= 0.05 * scale
    np.testing.assert_array_equal(got.argmax(1), ref.argmax(1))


def test_ssg_matches_jax_unfused_f32(monkeypatch, points, variables):
    jmodel = _jax_model(jnp.float32)
    tmodel = _torch_model(variables, None)
    # Pin the inputs: no pair within 1e-6 of a ball boundary (module doc).
    with torch.no_grad():
        xyz1, feats1 = tmodel.sa1(torch.from_numpy(points), None)
        xyz2, _ = tmodel.sa2(xyz1, feats1)
    for (_, radius, *_), pts, queries in zip(
        PointNet2ClsSSG.SA_CONFIGS, (points, xyz1.numpy()), (xyz1.numpy(), xyz2.numpy())
    ):
        d2 = ((queries[:, :, None, :].astype(np.float64) - pts[:, None, :, :]) ** 2).sum(-1)
        assert np.abs(d2 - radius * radius).min() > 1e-6
    monkeypatch.setenv("SCANOBJECTNN_FUSED_SA_EVAL", "off")
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(points), train=False)["logits"], np.float32)
    got = _logits(tmodel, points).numpy()
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5 * scale)
    np.testing.assert_array_equal(got.argmax(1), ref.argmax(1))


def test_state_dict_names_match_jax_tree(variables):
    tmodel = get_model("pointnet2_cls_ssg", device="cpu")
    load_jax_variables(tmodel, variables)  # strict: every name and shape matches
    assert tmodel.sa2.mlp.dense_0.kernel.shape == (131, 128)


def test_get_model_refuses_unknown_names():
    with pytest.raises(KeyError, match="unknown model 'pointnet3'; available"):
        get_model("pointnet3", device="cpu")


def test_training_mode_raises(points):
    # Training draws the dropout mask from an explicit generator
    # (test_torch_train_step.py holds the training forward).
    model = get_model("pointnet2_cls_ssg", device="cpu")
    with pytest.raises(ValueError, match="Generator"):
        model(torch.from_numpy(points[:1, :128]))
