"""PyTorch port, 3DmFV-Net in bf16 on the CPU: the average pool's bf16
rounding against JAX's ``nn.avg_pool``, and one bf16 ``Trainer`` step of
``3dmfv_net_cls`` (the static and the learnable GMM on the 3³ grid)
against the JAX steps.  Its bf16 forward is held to JAX's in
``tests/test_torch_threedmfv.py``.

The pool.  JAX's ``nn.avg_pool`` on a bf16 grid is a ``reduce_window`` add
in bf16 and a division in bf16; on the XLA CPU it adds the window's values
one at a time in bf16, in row-major window order, the zero padding
included, each sum rounded (pinned here bit for bit against that
transcription).  The port's ``_avg_pool_same`` sums each window in f32 and
divides, then rounds once (pinned bit for bit against ``F.avg_pool3d`` on
the f32 values rounded to bf16): the more exact of the two, by the same
choice as the EdgeConv VJPs' f32 sums.  Both are held to the float64 pool:
the port within one bf16 ulp, and its largest error no larger than
JAX's (both printed).  No TPU kernel runs here; cuDNN computes the bf16
convolutions on the card (``models/threedmfv.py``).

The step (set-up of ``tests/test_torch_threedmfv.py``: its batch of B=4
clouds of N=128 points, its JAX variables, the 3³ grid as its f32 step
tests take it, no augmentation, dropout the identity): the port's bf16
step of the learnable GMM, with the Fisher vector in f32 (as JAX computes
it) and its bf16 convolutions, BatchNorms and fc layers, against JAX's
bf16 step and its step in float64 (``jnp`` read as float64 also in
``nn/fisher.py`` and ``models/threedmfv.py``), by
``tests/test_torch_mixed_train.py``'s rule (mean ratio at most 1, each at
most 3).  No Fisher vector feature is exactly 0 on this batch (the
learnable GMM's sign·sqrt would give a NaN gradient, in JAX as here),
which the step checks.

The static GMM's step on the same batch, held by the rule, met it in every
gradient and statistic but not in the loss: the head's three BatchNorms
normalise over the 4 clouds and amplify the bf16 roundings that reach them
chaotically (``tests/test_torch_mixed_train.py`` reads the same of
PointNet++'s head), so that JAX's bf16 loss happened to land nearer the
float64 loss than the port's while its logits lay farther away (printed
below: fc4).  Its training forward is held layer by layer
instead: against JAX's f32 forward (the port's f32 forward within 1e-3 of
the scale of it), each trunk output (inception 1-5 and fc1, before the
first BatchNorm over the clouds) of the port's bf16 forward is no farther
than JAX's bf16 forward's (read 0.37-0.72 of JAX's distance); the head's
outputs are printed (at bn2 the port read 0.290 of the scale, JAX 0.265:
the head's readings swing with the batch and with XLA's fusion).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from scanobjectnn_tpu.models import threedmfv as jthreedmfv
from scanobjectnn_tpu.nn import fisher as jfisher
from scanobjectnn_torch.models import get_model, threedmfv
from scanobjectnn_torch.nn import fisher

from tests import test_torch_pointnet as pn
from tests.test_torch_mixed_dgcnn_train import bf16, bf16_ulp
from tests.test_torch_mixed_train import _hold_bf16_step
from tests.test_torch_threedmfv import CONFIGS, NAME, batch, variables  # noqa: F401

TRUNK = ("inception1", "inception2", "inception3", "inception4", "inception5", "fc1")  # before the head's BNs
LAYERS = TRUNK + ("bn1", "fc2", "bn2", "fc3", "bn3", "fc4")


def _sequential_bf16_pool(x: np.ndarray, k: int) -> np.ndarray:
    """JAX's bf16 ``avg_pool`` on the XLA CPU, transcribed: each window's
    values added one at a time in row-major window order (zero padding
    included), each sum rounded to bf16, then divided by k³ in bf16."""
    p = k // 2
    padded = np.pad(x, ((0, 0), (p, p), (p, p), (p, p), (0, 0)))
    d, h, w = x.shape[1:4]
    acc = np.zeros_like(x)
    for i in range(k):
        for j in range(k):
            for m in range(k):
                acc = bf16(acc + padded[:, i:i + d, j:j + h, m:m + w])
    return bf16(acc / np.float32(k ** 3))


@pytest.mark.parametrize("grid,k", [((5, 5, 5), 3), ((3, 3, 3), 3), ((2, 3, 4), 3), ((3, 3, 3), 5)])
def test_avg_pool_bf16_rounds_once_where_jax_rounds_each_sum(grid, k):
    rng = np.random.RandomState(sum(grid) + k)
    x = bf16(rng.randn(2, *grid, 8) * np.exp(2 * rng.randn(2, *grid, 8)))
    want_jax = np.asarray(fnn.avg_pool(jnp.asarray(x, jnp.bfloat16), (k,) * 3, strides=(1, 1, 1),
                                       padding="SAME").astype(jnp.float32))
    np.testing.assert_array_equal(want_jax, _sequential_bf16_pool(x, k))
    got = threedmfv._avg_pool_same(torch.from_numpy(x).to(torch.bfloat16), k)
    assert got.dtype == torch.bfloat16
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    once = F.avg_pool3d(F.pad(xt, (k // 2,) * 6), k, stride=1).permute(0, 2, 3, 4, 1).to(torch.bfloat16)
    assert torch.equal(got, once)
    x64 = torch.from_numpy(x.astype(np.float64)).permute(0, 4, 1, 2, 3)
    exact = F.avg_pool3d(F.pad(x64, (k // 2,) * 6), k, stride=1).permute(0, 2, 3, 4, 1).numpy()
    err, jax_err = np.abs(got.float().numpy() - exact), np.abs(want_jax - exact)
    assert (err <= bf16_ulp(exact)).all()
    assert err.max() <= jax_err.max()
    print(f"avg_pool bf16 grid {grid} k={k}: max |err| against float64, port {err.max():.3e}, JAX {jax_err.max():.3e}; "
          f"{float((got.float().numpy() != want_jax).mean()):.4f} of the cells differ from JAX's")


def _jax_bf16_step(mp, batch, variables, key):
    mp.setattr(fnn, "Dropout", lambda rate, deterministic: (lambda h: h))
    model = pn._jax_model(NAME, dtype=jnp.bfloat16, **CONFIGS[key])
    labels = {"labels": jnp.asarray(batch["labels"], jnp.int32)}

    def loss_fn(params):
        out, mut = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                               jnp.asarray(batch["points"]), train=True, bn_momentum=pn.MOMENTUM,
                               mutable=["batch_stats"])
        return model.loss(out, labels)[0], mut["batch_stats"]

    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    return float(loss), *({k: np.asarray(jnp.asarray(v, jnp.float32)) for k, v in pn.convert._flatten(t)}
                          for t in (grads, stats))


def test_bf16_step_no_farther_from_f64_than_jax_bf16(batch, variables):
    key = "learnable3"
    fv_zero = []
    real_fv = fisher.fisher_vector

    def fisher_vector(*args):
        fv = real_fv(*args)
        assert fv.dtype == torch.float32
        fv_zero.append(int((fv == 0).sum()))
        return fv

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("scanobjectnn_torch.models.threedmfv.fisher_vector", fisher_vector)
        metrics, grads, stats, trainer = pn._port_step(mp, NAME, batch, variables[key], dtype="bfloat16",
                                                       model_kwargs=CONFIGS[key])
    assert fv_zero == [0] and trainer.dtype == torch.bfloat16
    assert all(np.isfinite(g).all() for g in grads.values())
    with pytest.MonkeyPatch.context() as mp:
        jax_bf16 = _jax_bf16_step(mp, batch, variables[key], key)
    with pytest.MonkeyPatch.context() as mp:
        ref_metrics, ref_grads, ref_stats = pn._jax_step_f64(mp, NAME, batch, variables[key],
                                                             modules=(jfisher, jthreedmfv), model_kw=CONFIGS[key])
    _hold_bf16_step((metrics["loss"], grads, stats), jax_bf16, (ref_metrics["loss"], ref_grads, ref_stats))


def test_static_gmm_bf16_training_forward_no_farther_than_jax_bf16(batch, variables):
    # The static GMM's bf16 training forward, layer by layer (module doc).
    key, outs = "static3", {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn, "Dropout", lambda rate, deterministic: (lambda h: h))
        for name, jdtype, tdtype in (("f32", jnp.float32, None), ("bf16", jnp.bfloat16, torch.bfloat16)):
            model = pn._jax_model(NAME, dtype=jdtype, **CONFIGS[key])
            _, state = jax.jit(lambda v, x, model=model: model.apply(
                v, x, train=True, bn_momentum=pn.MOMENTUM, mutable=["batch_stats", "intermediates"],
                capture_intermediates=True))(variables[key], jnp.asarray(batch["points"]))
            inter = state["intermediates"]
            outs["jax", name] = {n: np.asarray(inter[n]["__call__"][0], np.float32) for n in LAYERS}
            port = pn.convert.load_jax_variables(
                get_model(NAME, device="cpu", num_classes=pn.CLASSES, dtype=tdtype, **CONFIGS[key]), variables[key])
            port.dropout_keep = 1.0
            seen = {}
            for n in LAYERS:
                getattr(port, n).register_forward_hook(lambda m, i, o, n=n: seen.__setitem__(n, o.detach().float()))
            with torch.no_grad():
                port.train()(torch.from_numpy(batch["points"]), bn_momentum=pn.MOMENTUM,
                             generator=torch.Generator().manual_seed(0))
            outs["port", name] = {n: t.numpy() for n, t in seen.items()}
    readings = []
    for n in LAYERS:
        ref = outs["jax", "f32"][n]
        scale = max(1.0, float(np.abs(ref).max()))
        err = {(side, dt): float(np.abs(outs[side, dt][n] - ref).max()) / scale
               for side, dt in (("port", "f32"), ("port", "bf16"), ("jax", "bf16"))}
        assert err["port", "f32"] <= 1e-3 <= err["port", "bf16"], (n, err)
        readings.append((n, err["port", "bf16"], err["jax", "bf16"], err["port", "f32"]))
    print("static GMM bf16 training forward, error / scale against JAX's f32 (port bf16, JAX bf16, port f32): "
          + ", ".join(f"{n} {p:.3e} {j:.3e} {f:.1e}" for n, p, j, f in readings))
    assert all(p <= j for n, p, j, _ in readings if n in TRUNK), readings
