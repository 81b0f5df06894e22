"""PyTorch port, the models of the synthetic-hard harness's out-of-band rows
at its shapes (N=128 clouds of its own data), against the JAX package on
the CPU.

At ``--num_point 128`` SA1 of the PointNet++ family takes 512 centroids
from 128 points (every point once, then the first point 384 times more),
and ``pointcnn_cls``'s second X-Conv asks for 384 representative points of
128 (a prefix slice: all of them).  Held here:

- full-width ``pointnet2_cls_bga`` at B=2 against the JAX model's unfused
  path on the same weights (``test_torch_synth_hard.draw_variables``), the
  inputs pinned off the ball boundaries (``assert_pinned``); the bounds of
  ``tests/test_torch_pointnet2_bga.py``;
- full-width ``pointcnn_cls`` at B=2 against the JAX model on the port's
  neighbours (``tests/test_torch_pointcnn.py``'s weights, kNN check and
  bounds);
- the BGA and part segmentation training steps at B=4 (narrowed widths, the
  real point counts, radii and K) against the float64 JAX step, with
  ``tests/test_torch_seg_train.py``'s set-up and bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanobjectnn_torch.convert import load_jax_variables
from scanobjectnn_torch.models import PointNet2BGA, get_model
from scanobjectnn_torch.train import synth_hard
from tests.test_torch_pointcnn import _check_outputs, jax_model, jax_variables
from tests.test_torch_pointnet2_bga import LOGIT_ATOL, LOGIT_RTOL, SEG_AGREEMENT, SEG_TOL
from tests.test_torch_seg_train import (  # noqa: F401  (fixtures, on this module's batch)
    NarrowBGA, check_train_step, fp_neighbours, levels, reference, variables,
)
from tests.test_torch_synth_hard import assert_pinned, draw_variables, harness_points
from tests.test_torch_xconv import PortKnn, feed_jax


def test_bga_forward_at_harness_shape_matches_jax(monkeypatch):
    from scanobjectnn_tpu import models as jzoo

    monkeypatch.setenv("SCANOBJECTNN_FUSED_SA_EVAL", "off")
    points = harness_points()
    jmodel = jzoo.get_model("pointnet2_cls_bga", num_classes=6)[0]
    v = draw_variables(jmodel, points)
    ref = jax.jit(lambda variables, x: jmodel.apply(variables, x, train=False))(v, jnp.asarray(points))
    tmodel = load_jax_variables(get_model("pointnet2_cls_bga", device="cpu", num_classes=6), v).eval()
    with torch.no_grad():
        levels = [xyz.numpy() for xyz, _ in tmodel._trunk(torch.from_numpy(points), 0.9)]
        got = tmodel(torch.from_numpy(points))
    assert [lv.shape[1] for lv in levels] == [128, 512, 128, 1]
    assert_pinned(PointNet2BGA.SA_CONFIGS, levels)
    for key in ("logits", "seg_logits"):
        want, out = np.asarray(ref[key], np.float32), got[key].numpy()
        scale = max(1.0, float(np.abs(want).max()))
        assert out.shape == want.shape and float(np.abs(want).max()) > 0.1, key
        if key == "logits":
            np.testing.assert_allclose(out, want, rtol=LOGIT_RTOL, atol=LOGIT_ATOL * scale)
            np.testing.assert_array_equal(out.argmax(-1), want.argmax(-1))
        else:
            err = float(np.abs(out - want).max()) / scale
            print(f"BGA N=128 seg_logits: max err / scale {err:.3e}")
            assert err <= SEG_TOL
            assert float((out.argmax(-1) == want.argmax(-1)).mean()) >= SEG_AGREEMENT


def test_pointcnn_cls_forward_at_harness_shape_matches_jax(monkeypatch):
    points = harness_points()
    model = jax_model("pointcnn_cls")
    v = jax_variables(model, jnp.asarray(points), 1)
    tmodel = load_jax_variables(get_model("pointcnn_cls", device="cpu"), v).eval()
    with monkeypatch.context() as mp, torch.no_grad():
        rec = PortKnn(mp)
        got = tmodel(torch.from_numpy(points))
    # xconv_1-4: K·D 8, 24, 32, 48; P = -1, 384, 128, 128: every layer's
    # queries are all 128 points (the second layer's a prefix slice).
    assert [(call[2], call[0].shape[1], call[1].shape[1]) for call in rec.calls] == [
        (8, 128, 128), (24, 128, 128), (32, 128, 128), (48, 128, 128)]
    feed_jax(monkeypatch, rec.calls)
    ref = jax.jit(lambda variables, x: model.apply(variables, x, train=False))(v, jnp.asarray(points))
    _check_outputs(got, ref, "f32", "pointcnn_cls N=128")


@pytest.fixture(scope="module")
def batch():
    """B=4 training clouds of the harness's data at N=128, of classes 0, 1,
    2 and 0 (the set-up's 3 classes), with their binary masks and parts."""
    train = synth_hard.build_data(256)[0]
    pick = [0, 100, 200, 50]
    out = {k: train[k][pick][:, :128] for k in ("points", "masks", "parts")}
    out["labels"] = train["labels"][pick]
    assert list(out["labels"]) == [0, 1, 2, 0]
    return {**out, "masks": out["masks"].astype(np.int64)}


@pytest.mark.parametrize(
    "name,bn", [("pointnet2_cls_bga", "f32"), ("pointnet2_cls_bga", "f64"), ("pointnet2_cls_partseg", "f32")]
)
def test_train_step_at_harness_shape_matches_jax(monkeypatch, batch, levels, variables, reference, name, bn):
    assert [lv.shape[1] for lv in levels] == [128, 512, 128, 1]
    assert_pinned(NarrowBGA.SA_CONFIGS, [lv.numpy() for lv in levels])
    check_train_step(monkeypatch, batch, variables, reference, name, bn)
