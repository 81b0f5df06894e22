"""PyTorch port, the bf16 training steps of BGA and part segmentation on
the CPU, against the JAX package: the rule of
``tests/test_torch_mixed_train.py`` (each step no farther from the JAX
step evaluated in float64 than JAX's own bf16 step is), on the f32 seg
tests' set-up (``test_torch_seg_train.py``: seed 19, B=4, N=1024, narrow
MLPs, the JAX side fed the port's FP neighbours and ball groups).
"""

import jax.numpy as jnp
import pytest

from scanobjectnn_tpu import ops as jops
from tests import test_torch_seg_train as seg
from tests.test_torch_mixed_train import MOMENTUM, _hold_bf16_step, _jax_bf16_step, _port_step


@pytest.mark.parametrize("name", ["pointnet2_cls_bga", "pointnet2_cls_partseg"])
def test_seg_bf16_step_matches_jax(monkeypatch, name):
    # One seed (19, the f32 seg tests' batch), the JAX side fed the port's
    # FP neighbours.
    batch = seg.batch.__wrapped__()
    levels = seg.levels.__wrapped__(batch)
    neighbours = seg.fp_neighbours.__wrapped__(levels)
    variables = seg.variables.__wrapped__(batch)[name]
    targets = {k: jnp.asarray(batch[k], jnp.int32) for k in ("labels", "masks", "parts")}
    with pytest.MonkeyPatch.context() as mp:
        metrics, grads, stats = seg._jax_step_f64(mp, name, batch, variables, MOMENTUM, neighbours)
    exact = (metrics["loss"], grads, stats)
    with pytest.MonkeyPatch.context() as mp:
        seg._narrow_jax_layers(mp)
        mp.setattr(jops, "three_nn", lambda xyz1, xyz2: tuple(
            jnp.asarray(a) for a in neighbours[(xyz1.shape[1], xyz2.shape[1])]))
        jax_bf16 = _jax_bf16_step(mp, seg._jax_model(name, jnp.bfloat16), variables, batch, targets)
    *port, _ = _port_step(monkeypatch, name + "_narrow", seg.PORT[name], batch, variables, num_classes=seg.CLASSES,
                          dtype="bfloat16")
    _hold_bf16_step(port, jax_bf16, exact)
