"""PyTorch port, the BGA and part segmentation inference slice: full-width
``pointnet2_cls_bga`` and ``pointnet2_cls_partseg`` forwards on the CPU at
B=2, N=1024 against the JAX models on the same weights.

The JAX side runs ``model.apply(train=False)`` with the fused SA eval kernel
in Pallas interpret mode and without spatial bucketing
(``SCANOBJECTNN_FUSED_SA_EVAL=interpret``, ``SCANOBJECTNN_SA_BUCKET=off``),
as ``test_torch_pointnet2_ssg.py`` does; its FP decoder takes the lax
``three_nn``.  Random positive BN running stats make the BN fold matter.

Tolerances, and why.  ``logits`` in f32: rtol 2e-4 / atol 2e-5 x max(1,
|ref|max), the SSG bound (the same SA trunk).  ``seg_logits`` in f32: 1e-4
x max(1, |ref|max).  Every fp3 query that FPS picked is also a key; there the
port's d² is exactly 0 and XLA's up to 4.8e-7, which the 1e-10 floor turns
into interpolated features up to 6.7e-5 of their scale apart
(``test_torch_knn.py``), carried by the fp3 MLP, seg_fc1 and seg_fc2; the
largest difference read 1.9e-6 (BGA) and 1.2e-5 (partseg) of the scale.
In bf16 both within 0.05 x
max(1, |ref|max), as SSG's bf16 bound (bf16 rounds at other points in the two
frameworks).  In both dtypes the predicted classes must be equal, and at
least 99% of the per-point argmaxes of ``seg_logits``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanobjectnn_tpu import models as jzoo
from scanobjectnn_torch.convert import load_jax_variables
from scanobjectnn_torch.data.synthetic import make_synthetic_dataset
from scanobjectnn_torch.models import MODEL_REGISTRY, get_model

DTYPES = {"f32": (jnp.float32, None), "bf16": (jnp.bfloat16, torch.bfloat16)}
MODELS = {"pointnet2_cls_bga": {}, "pointnet2_cls_partseg": {"num_parts": 4}}
LOGIT_RTOL, LOGIT_ATOL, SEG_TOL, BF16_TOL, SEG_AGREEMENT = 2e-4, 2e-5, 1e-4, 0.05, 0.99


@pytest.fixture(scope="module")
def points():
    data, _ = make_synthetic_dataset(num_per_class=1, num_classes=2, num_points=1024, seed=5, with_mask=True)[:2]
    return data.astype(np.float32)


@pytest.fixture(scope="module")
def variables(points):
    """JAX variables per model: the reference init with random positive BN
    running stats."""
    out = {}
    for name, kw in MODELS.items():
        model, _, _ = jzoo.get_model(name, **kw)
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
        out[name] = {**v, "batch_stats": stats}
    return out


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(MODELS))
def test_matches_jax_fused_interpret(monkeypatch, points, variables, name, dtype):
    jdtype, tdtype = DTYPES[dtype]
    monkeypatch.setenv("SCANOBJECTNN_FUSED_SA_EVAL", "interpret")
    monkeypatch.setenv("SCANOBJECTNN_SA_BUCKET", "off")
    jmodel = jzoo.get_model(name, dtype=jdtype, **MODELS[name])[0]
    ref = jmodel.apply(variables[name], jnp.asarray(points), train=False)
    tmodel = load_jax_variables(get_model(name, device="cpu", dtype=tdtype, **MODELS[name]), variables[name])
    with torch.no_grad():
        got = tmodel.eval()(torch.from_numpy(points))
    assert sorted(got) == sorted(ref)
    for key in ("logits", "seg_logits"):
        if key not in ref:
            continue
        want = np.asarray(ref[key], np.float32)
        out = got[key]
        assert out.shape == want.shape and out.dtype == (tdtype or torch.float32), key
        out = out.float().numpy()
        scale = max(1.0, float(np.abs(want).max()))
        assert float(np.abs(want).max()) > 0.1  # the activations did not vanish
        err = float(np.abs(out - want).max()) / scale
        print(f"{name} {dtype} {key}: max err / scale {err:.3e}")
        if dtype == "bf16":
            assert err <= BF16_TOL
        elif key == "logits":
            np.testing.assert_allclose(out, want, rtol=LOGIT_RTOL, atol=LOGIT_ATOL * scale)
        else:
            assert err <= SEG_TOL
        agree = float((out.argmax(-1) == want.argmax(-1)).mean())
        if key == "logits":
            assert agree == 1.0
        else:
            print(f"{name} {dtype}: per-point argmax agreement {agree:.4f}")
            assert agree >= SEG_AGREEMENT


@pytest.mark.parametrize("name", sorted(MODELS))
def test_state_dict_names_match_jax_tree(variables, name):
    tmodel = get_model(name, device="cpu", **MODELS[name])
    load_jax_variables(tmodel, variables[name])  # strict: every name and shape matches
    assert tmodel.fp1.mlp.dense_0.kernel.shape == ((256 + 256, 256) if name.endswith("bga") else (1024 + 256, 256))
    assert tmodel.sa1.nsample == 64 and tmodel.seg_fc1.dense_0.kernel.shape == (128, 128)


def test_registry_kinds():
    assert {n: c.kind for n, c in MODEL_REGISTRY.items()} == {
        "pointnet2_cls_ssg": "cls", "pointnet2_cls_msg": "cls", "pointnet2_cls_bga": "seg",
        "pointnet2_cls_partseg": "partseg",
        "dgcnn": "cls", "dgcnn_bga": "seg", "spidercnn_cls_xyz": "cls",
        "pointcnn_cls": "cls", "pointcnn_seg": "seg",
        "pointnet_cls": "cls", "pointnet_cls_basic": "cls", "pointnet_seg": "seg", "pointnet_partseg": "partseg",
        "3dmfv_net_cls": "cls",
    }
    for name, cls in MODEL_REGISTRY.items():
        assert jzoo.MODEL_REGISTRY[name].kind == cls.kind


def test_get_model_defaults_to_the_card():
    # The module is built on the CPU and then moved: on a machine without a
    # card, the default device fails at the move, which shows the default.
    if torch.cuda.is_available():
        assert next(get_model("pointnet2_cls_bga").parameters()).is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            get_model("pointnet2_cls_bga")
    assert next(get_model("pointnet2_cls_bga", device="cpu").parameters()).device.type == "cpu"
