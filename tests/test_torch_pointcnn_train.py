"""PyTorch port, PointCNN training on the CPU: one f32 ``Trainer`` step of
``pointcnn_cls`` and of ``pointcnn_seg`` (narrow settings, B=4 clouds of
N=128 points) against the JAX step on the same batch and weights, evaluated
in float64; the recipe's Adam update against optax; the step LR schedule;
``pointcnn_xforms``' composition and ``pointcnn_augment`` against JAX; the
``Trainer``'s use of the recipe.

Set-up of the step, as ``test_torch_dgcnn_train.py``: no augmentation (the
trainer's ``pointcnn_augment`` patched out); dropout rate 0 in the narrow
settings, so neither side draws; random BN running stats, so the 0.99
momentum update shows.  The reference is the JAX step in float64
(``jax.enable_x64``, ``dtype=float64``, and a ``jnp`` that reads ``float32``
as float64 bound into ``nn/layers.py``, ``models/losses.py``,
``nn/xconv.py`` and ``models/pointcnn.py``), fed the port's kNN indices
(recorded from the port's training forward and checked first against
JAX's own, as ``test_torch_pointcnn.py`` does).

The port runs its own f32 BatchNorms.  The earlier step tests ran them in
float64, because a training BN over a few rows (B clouds) amplifies f32
rounding; every PointCNN BN normalises over at least B·P = 128 rows, and
the port's f32 step reads 2.2e-7 of the gradients' scale off the float64
reference (CPU).

Bounds, those of the earlier whole-step tests: the losses to rtol 1e-5,
every gradient to 1e-4 x max(1, max|ref|) per tensor, the BN running stats
to 1e-5 x max(1, max|ref|).  PointCNN's only Dense biases are its logits
layers', which feed no BN, so no gradient is held to 0.
"""

import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from scanobjectnn_tpu import augment as jaug
from scanobjectnn_tpu import models as jzoo
from scanobjectnn_tpu.models import losses as jlosses
from scanobjectnn_tpu.models import pointcnn as jpointcnn
from scanobjectnn_tpu.nn import layers as jlayers
from scanobjectnn_tpu.nn import xconv as jxconv
from scanobjectnn_tpu.train import schedules as jschedules
from scanobjectnn_torch import convert
from scanobjectnn_torch.augment import transforms
from scanobjectnn_torch.models import get_model, pointcnn
from scanobjectnn_torch.train import schedules
from scanobjectnn_torch.train import trainer as trainer_module
from scanobjectnn_torch.train.trainer import Trainer, TrainerConfig

from tests.test_torch_xconv import PortKnn, dup_cloud, feed_jax, fill

B, N, CLASSES = 4, 128, 3
LOSS_RTOL, GRAD_TOL, STATS_TOL = 1e-5, 1e-4, 1e-5  # module doc
MODELS = ("pointcnn_cls", "pointcnn_seg")


class _Jnp64(types.ModuleType):
    """``jax.numpy`` with ``float32`` read as float64."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def narrow(module, name):
    """x = 1 widths, P = 64 and 32, dropout rate 0 (no draws on either side)."""
    xconv = (module.XConvParam(8, 1, -1, 16), module.XConvParam(12, 2, 64, 32),
             module.XConvParam(8, 2, 32, 64), module.XConvParam(8, 3, 32, 64))
    if name == "pointcnn_cls":
        return module.PointCNNSetting(xconv_params=xconv, fc_params=(module.FCParam(32, 0.0), module.FCParam(16, 0.0)))
    return module.PointCNNSetting(
        xconv_params=xconv,
        xdconv_params=(module.XDConvParam(8, 2, 3, 2), module.XDConvParam(8, 2, 2, 1),
                       module.XDConvParam(8, 4, 1, 0)),
        fc_params_classification=(module.FCParam(32, 0.0),),
        fc_params_segmentation=(module.FCParam(16, 0.0), module.FCParam(16, 0.0)),
    )


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(2)
    return {"points": dup_cloud(41, B, N), "labels": rng.randint(0, CLASSES, B), "masks": rng.randint(0, 2, (B, N))}


@pytest.fixture(scope="module")
def variables(batch):
    out = {}
    for i, name in enumerate(MODELS):
        model = jzoo.get_model(name, num_classes=CLASSES, setting=narrow(jpointcnn, name))[0]
        shapes = jax.eval_shape(lambda a, m=model: m.init(jax.random.PRNGKey(0), a, train=False),
                                jnp.asarray(batch["points"]))
        out[name] = fill(shapes, 7 + i)
    return out


def _jax_step_f64(monkeypatch, name, batch, variables, calls):
    """JAX losses, gradients and updated BN stats of one training forward in
    float64, on the port's kNN ``calls`` (module doc)."""
    feed_jax(monkeypatch, calls)
    for module in (jlayers, jlosses, jxconv, jpointcnn):
        monkeypatch.setattr(module, "jnp", _Jnp64("jnp"))
    targets = {k: jnp.asarray(batch[k], jnp.int32) for k in ("labels", "masks")}
    points = jnp.asarray(batch["points"])
    with jax.enable_x64(True):
        model = jzoo.get_model(name, num_classes=CLASSES, setting=narrow(jpointcnn, name), dtype=jnp.float64)[0]
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)), variables)

        def loss_fn(params):
            out, mut = model.apply({"params": params, "batch_stats": v64["batch_stats"]}, points, train=True,
                                   mutable=["batch_stats"])
            loss, metrics = model.loss(out, targets)
            return loss, (metrics, mut["batch_stats"])

        (_, (metrics, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v64["params"])
        grads, stats = ({k: np.asarray(v) for k, v in convert._flatten(tree)} for tree in (grads, stats))
        metrics = {k: float(v) for k, v in metrics.items()}
    assert {v.dtype for v in (*grads.values(), *stats.values())} == {np.dtype(np.float64)}
    return metrics, grads, stats


def _worst_over(got, want, bound):
    assert sorted(got) == sorted(want)
    readings = []
    for key, ref in want.items():
        scale = max(1.0, float(np.abs(ref).max()))
        err = float(np.abs(got[key] - ref).max())
        assert err <= bound * scale, f"{key}: {err} > {bound * scale}"
        readings.append((err / scale, key))
    return max(readings)


@pytest.mark.parametrize("name", MODELS)
def test_train_step_matches_jax_f64(monkeypatch, batch, variables, name):
    monkeypatch.setattr(trainer_module, "pointcnn_augment", lambda points, *args: points)
    trainer = Trainer(TrainerConfig(model=name, num_classes=CLASSES, batch_size=B, device="cpu"))
    state = trainer.init_state()
    state.model = convert.load_jax_variables(
        get_model(name, device="cpu", num_classes=CLASSES, setting=narrow(pointcnn, name)), variables[name]
    )
    state.optimizer = trainer.make_optimizer(state.model.parameters())
    with monkeypatch.context() as mp:
        rec = PortKnn(mp)
        state, metrics = trainer.train_step(state, batch)
    assert state.step == 1 and len(rec.calls) == (4 if name == "pointcnn_cls" else 7)
    ref_metrics, ref_grads, ref_stats = _jax_step_f64(monkeypatch, name, batch, variables[name], rec.calls)

    assert sorted(ref_metrics) == sorted(k for k in metrics if k in ref_metrics)
    for key, ref in ref_metrics.items():
        err = abs(float(metrics[key]) / ref - 1)
        assert err <= LOSS_RTOL, f"{key} rel err {err}"
    grads = {key: p.grad.numpy() for key, p in state.model.named_parameters()}
    grad_err, worst = _worst_over(grads, ref_grads, GRAD_TOL)
    stats = {key: b.numpy() for key, b in state.model.named_buffers()}
    stat_err, worst_stat = _worst_over(stats, ref_stats, STATS_TOL)
    print(f"{name} against the float64 reference: loss {float(metrics['loss']):.7f} vs {ref_metrics['loss']:.7f}; "
          f"largest error / scale: gradients {grad_err:.3e} ({worst}), BN stats {stat_err:.3e} ({worst_stat})")


def test_recipe_adam_matches_optax():
    # eps 1e-2 and L2 1e-5 added to the gradient before Adam:
    # optax.chain(add_decayed_weights, adam).  With eps 1e-2 a step moves a
    # parameter by up to lr = 0.01, and the two round it at the scale of the
    # parameters (about 1): within 2e-7, not a relative bound, near 0.
    trainer = Trainer(TrainerConfig(model="pointcnn_cls", device="cpu"))
    rng = np.random.RandomState(2)
    params = [rng.randn(5, 3).astype(np.float32), rng.randn(7).astype(np.float32)]
    grads = [[(rng.randn(*p.shape) * 10.0 ** rng.randint(-4, 1)).astype(np.float32) for p in params]
             for _ in range(3)]
    ours = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = trainer.make_optimizer(ours)
    schedule = jschedules.step_exponential_decay_lr(0.01, 8000, 0.5, 1e-6)
    tx = optax.chain(optax.add_decayed_weights(1e-5), optax.adam(schedule, eps=1e-2))
    theirs = [jnp.asarray(p) for p in params]
    opt_state = tx.init(theirs)
    for step, g in enumerate(grads):
        for p, gi in zip(ours, g):
            p.grad = torch.from_numpy(gi)
        trainer.optimizer_step(opt, step)
        updates, opt_state = tx.update([jnp.asarray(gi) for gi in g], opt_state, theirs)
        theirs = optax.apply_updates(theirs, updates)
        for p, q in zip(ours, theirs):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(q), rtol=1e-6, atol=2e-7)


def test_step_exponential_decay_lr_equals_jax():
    ours = schedules.step_exponential_decay_lr(0.01, 8000, 0.5, 1e-6)
    theirs = jschedules.step_exponential_decay_lr(0.01, 8000, 0.5, 1e-6)
    steps = [0, 7999, 8000, 16000, 10**6]
    assert [ours(s) for s in steps] == [float(theirs(s)) for s in steps]
    assert ours(7999) == ours(0) > ours(8000) > ours(16000) > ours(10**6) == float(np.float32(1e-6))


def test_trainer_takes_the_recipe():
    g = lambda: torch.Generator().manual_seed(4)  # noqa: E731
    x = torch.from_numpy(dup_cloud(3, 2, 64))
    trainer = Trainer(TrainerConfig(model="pointcnn_seg", device="cpu"))
    assert (trainer.adam_eps, trainer.weight_decay) == (1e-2, 1e-5)
    assert trainer.lr_schedule(8000) == float(np.float32(0.005))
    opt = trainer.make_optimizer([torch.nn.Parameter(torch.zeros(2))])
    assert opt.defaults["eps"] == 1e-2 and opt.defaults["weight_decay"] == 1e-5
    want = transforms.pointcnn_augment(x, g(), 0.0, (0.0, math.pi, 0.0, "u"), (0.1, 0.1, 0.1, "g"))
    assert torch.equal(trainer.augment(x, g()), want)
    assert Trainer(TrainerConfig(model="pointcnn_cls", weight_decay=3e-4, device="cpu")).weight_decay == 3e-4
    plain = Trainer(TrainerConfig(model="pointcnn_cls", use_model_recipe=False, device="cpu"))
    assert plain.recipe is None and (plain.adam_eps, plain.weight_decay) == (1e-8, 0.0)
    assert plain.lr_schedule(0) == float(np.float32(1e-3))
    assert torch.equal(plain.augment(x, g()), transforms.standard_train_augment(x, g()))
    assert Trainer(TrainerConfig(model="dgcnn", device="cpu")).recipe is None


def _jax_draws(key, num, rotation_range, scaling_range):
    """The angles and scales ``jaug.pointcnn_xforms`` draws from ``key``
    (its own key splits and formulas)."""
    k_rot, k_scale = jax.random.split(key)
    out = []
    for keys, ranges, offset in ((jax.random.split(k_rot, 3), rotation_range, 0.0),
                                 (jax.random.split(k_scale, 3), scaling_range, 1.0)):
        rows = []
        for i in range(3):
            bound = float(ranges[i])
            if ranges[3] == "g":
                rows.append(offset + jnp.clip(bound * jax.random.normal(keys[i], (num,)), -3 * bound, 3 * bound))
            else:
                rows.append(offset + bound * jax.random.uniform(keys[i], (num,), minval=-1.0, maxval=1.0))
        out.append(torch.from_numpy(np.asarray(jnp.stack(rows))))
    return out


@pytest.mark.parametrize("ranges", [((0.3, math.pi, 0.2, "u"), (0.1, 0.2, 0.05, "g")),
                                    ((0.2, 0.4, 0.3, "g"), (0.1, 0.1, 0.3, "u"))], ids=["u_g", "g_u"])
def test_pointcnn_xforms_composition_matches_jax(ranges):
    key = jax.random.PRNGKey(3)
    angles, scales = _jax_draws(key, 16, *ranges)
    xforms, rotations = transforms.compose_xforms(angles, scales)
    jx, jrot = jaug.pointcnn_xforms(key, 16, *ranges)
    np.testing.assert_allclose(rotations.numpy(), np.asarray(jrot), atol=1e-6)
    np.testing.assert_allclose(xforms.numpy(), np.asarray(jx), atol=1e-6)
    pts = dup_cloud(5, 16, 64)
    got = transforms.pointcnn_augment(torch.from_numpy(pts), xforms=xforms)
    want = jnp.einsum("bnc,bcd->bnd", jnp.asarray(pts), jx, precision=jax.lax.Precision.HIGHEST)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_pointcnn_xforms_draws():
    xf, rot = transforms.pointcnn_xforms(64, torch.Generator().manual_seed(0))
    assert xf.shape == rot.shape == (64, 3, 3)
    np.testing.assert_allclose(np.linalg.det(rot.double().numpy()), 1.0, atol=1e-5)
    scales = torch.linalg.norm(xf, dim=2)  # row norms of diag(s) @ R: the scales
    assert bool(((scales > 0.7 - 1e-6) & (scales < 1.3 + 1e-6)).all())
    ones = torch.ones(2, 32, 3)
    out = transforms.pointcnn_augment(ones, torch.Generator().manual_seed(1), 0.01, (0.0, 0.0, 0.0, "u"),
                                      (0.0, 0.0, 0.0, "u"))
    delta = (out - 1.0).abs()
    assert float(delta.max()) <= 0.05 + 1e-6 and float(delta.max()) > 0
