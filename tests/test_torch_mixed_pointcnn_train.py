"""PyTorch port, PointCNN in bf16 training on the CPU: ``gather_neighbors``
(#6, backward the scatter-add #7) as X-Conv runs it in bf16, held against
JAX's; one bf16 ``Trainer`` step of ``pointcnn_cls`` and of
``pointcnn_seg`` against the JAX steps; and the wrappers' card route
rehearsed in a bf16 step.

The gather.  X-Conv hands ``gather_neighbors`` its bf16 features cast to
f32 and casts the rows back (exact copies); the rows' cotangent is bf16.
The port's rows equal JAX's interpreted ``gather_neighbors_pallas`` (the
bf16 single-pass one-hot gather) and its lax gather (``batched_index_gather``,
the CPU path of its ``gather_neighbors``).  The VJP: the port sums each
point's incoming row cotangents in f32 and casts once, as
``gather_neighbors_pallas``'s VJP (``_gn_bwd``: an f32 scatter, then
``astype(vals.dtype)``); the lax VJP scatter-adds in bf16.  The port is
held to the float64 VJP of the same bf16 cotangents: every element within
one bf16 ulp plus the f32 summation bound ``2·k·2^-24·Σ|terms|``
(``hold_bf16_vjp`` of ``tests/test_torch_mixed_dgcnn_train.py``), and its
largest distance no larger than either JAX VJP's (printed).

The steps (set-up of ``tests/test_torch_pointcnn_train.py``: its narrow
settings, batch of B=4 clouds of N=128 points with duplicates, JAX
variables and recipe; no augmentation; dropout rate 0): the port's bf16
step against JAX's bf16 step and its step in float64, all three on the
port's kNN indices (the kNN runs on the f32 points, as in f32, and is
checked as the f32 step test checks it), by ``tests/
test_torch_mixed_train.py``'s rule (mean ratio at most 1, each at most 3).

The card route (``KernelRoute``): a bf16 ``pointcnn_cls`` step (the narrow
setting, B=2, N=128) hands the gather and the scatter-add f32 contiguous
tensors (at ``xconv_2``-``4``: ``xconv_1``'s features come from its points
alone) and is held to the plain step by ``chip_smoke.py``'s bf16 step
bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanobjectnn_tpu import models as jzoo
from scanobjectnn_tpu.models import pointcnn as jpointcnn
from scanobjectnn_tpu.ops.grouping import batched_index_gather
from scanobjectnn_tpu.ops.pallas import edge_kernel as jedge
from scanobjectnn_torch import convert
from scanobjectnn_torch.models import get_model, pointcnn
from scanobjectnn_torch.ops.cuda.gather_kernel import gather_neighbors
from scanobjectnn_torch.train import trainer as trainer_module
from scanobjectnn_torch.train.trainer import Trainer, TrainerConfig

from tests.test_torch_mixed_dgcnn_train import bf16, hold_bf16_vjp, route_step, scatter_exact
from tests.test_torch_mixed_train import _hold_bf16_step
from tests.test_torch_pointcnn_train import B, CLASSES, MODELS, _jax_step_f64, batch, narrow, variables  # noqa: F401
from tests.test_torch_xconv import PortKnn, dup_cloud, feed_jax


@pytest.mark.parametrize("case", [(2, 128, 64, 16, 8), (2, 64, 32, 48, 12)], ids=["xconv2", "xconv3"])
def test_gather_neighbors_in_a_bf16_layer_matches_jax(case):
    b, n, m, c, k = case
    rng = np.random.RandomState(k)
    vals = bf16(rng.randn(b, n, c))
    idx = rng.randint(0, n, (b, m, k)).astype(np.int32)
    idx[:, :, k // 2:] = idx[:, :, :1]  # repeated neighbours, as duplicate points give
    cot = bf16(rng.randn(b, m, k, c))
    v = torch.from_numpy(vals).to(torch.bfloat16).requires_grad_()
    rows = gather_neighbors(v.float().contiguous(), torch.from_numpy(idx)).to(torch.bfloat16)  # as X-Conv runs it
    (grad,) = torch.autograd.grad(rows, v, torch.from_numpy(cot).to(torch.bfloat16))
    assert grad.dtype == torch.bfloat16
    jv, jidx = jnp.asarray(vals, jnp.bfloat16), jnp.asarray(idx)
    vjps = {}
    for name, fn in (("Pallas", jedge.gather_neighbors_pallas), ("lax", batched_index_gather)):
        out, pull = jax.vjp(lambda x, fn=fn: fn(x, jidx), jv)
        assert out.dtype == jnp.bfloat16
        np.testing.assert_array_equal(rows.detach().float().numpy(), np.asarray(out.astype(jnp.float32)))
        vjps[name] = pull(jnp.asarray(cot, jnp.bfloat16))[0]
        assert vjps[name].dtype == jnp.bfloat16
    exact, mag = scatter_exact(idx, cot, n)
    hold_bf16_vjp(grad.float().numpy(), exact, mag, m * k, *(np.asarray(vjps[key].astype(jnp.float32))
                                                              for key in ("Pallas", "lax")),
                  f"gather_neighbors bf16 [{b}, {n}, {c}] -> [{m}, {k}]")


def _port_bf16_step(mp, name, batch, variables):
    mp.setattr(trainer_module, "pointcnn_augment", lambda points, *args: points)
    trainer = Trainer(TrainerConfig(model=name, num_classes=CLASSES, batch_size=B, dtype="bfloat16", device="cpu"))
    state = trainer.init_state()
    state.model = convert.load_jax_variables(
        get_model(name, device="cpu", num_classes=CLASSES, setting=narrow(pointcnn, name), dtype=torch.bfloat16),
        variables)
    state.optimizer = trainer.make_optimizer(state.model.parameters())
    with mp.context() as inner:
        rec = PortKnn(inner)
        state, metrics = trainer.train_step(state, batch)
    grads = {n: p.grad.float().numpy() for n, p in state.model.named_parameters()}
    stats = {n: b.numpy() for n, b in state.model.named_buffers()}
    return (float(metrics["loss"]), grads, stats), rec.calls


def _jax_bf16_step(mp, name, batch, variables, calls):
    feed_jax(mp, calls)
    model = jzoo.get_model(name, num_classes=CLASSES, setting=narrow(jpointcnn, name), dtype=jnp.bfloat16)[0]
    targets = {k: jnp.asarray(batch[k], jnp.int32) for k in ("labels", "masks")}

    def loss_fn(params):
        out, mut = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                               jnp.asarray(batch["points"]), train=True, mutable=["batch_stats"])
        return model.loss(out, targets)[0], mut["batch_stats"]

    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    return float(loss), *({k: np.asarray(jnp.asarray(v, jnp.float32)) for k, v in convert._flatten(t)}
                          for t in (grads, stats))


@pytest.mark.parametrize("name", MODELS)
def test_bf16_step_no_farther_from_f64_than_jax_bf16(monkeypatch, batch, variables, name):
    port, calls = _port_bf16_step(monkeypatch, name, batch, variables[name])
    assert len(calls) == (4 if name == "pointcnn_cls" else 7)
    with pytest.MonkeyPatch.context() as mp:
        jax_bf16 = _jax_bf16_step(mp, name, batch, variables[name], calls)
    with pytest.MonkeyPatch.context() as mp:
        metrics, grads, stats = _jax_step_f64(mp, name, batch, variables[name], calls)
    _hold_bf16_step(port, jax_bf16, (metrics["loss"], grads, stats))


def test_pointcnn_bf16_step_on_the_card_route_hands_its_kernels_f32():
    rng = np.random.RandomState(3)
    step_batch = {"points": dup_cloud(9, 2, 128), "labels": rng.randint(0, CLASSES, 2)}
    rec = route_step("pointcnn_cls", step_batch, num_classes=CLASSES, batch_size=2,
                     model_kwargs={"setting": narrow(pointcnn, "pointcnn_cls")})
    # xconv_2-4 gather their input features (xconv_1's come from its points alone)
    assert rec.calls["gather_rows"] == rec.calls["scatter_add_rows"] == 3
