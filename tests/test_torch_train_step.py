"""PyTorch port, the SSG training step as a whole, on the CPU, against the
JAX package on the same batch and weights.

Set-up: B=4 clouds of N=1024 points (the synthetic dataset), the SSG
pyramid at its real point counts, radii and K (512/0.2/32, 128/0.4/64,
group-all) with narrower MLPs (a test-local subclass of both models; the
head keeps its widths).  No augmentation (the trainer's
``standard_train_augment`` patched out); dropout is the identity on both
sides (flax's ``Dropout`` patched inside the test, the port's head at keep
1.0).  Random BN running stats, so the momentum update shows.

The JAX side takes the lax ball query, which tests ``sqrt`` of the
EXPANDED distance, so a point within rounding of a ball's boundary could
flip.  The inputs are pinned instead of the bound loosened: the test
asserts that no (centroid, point) pair of SA1 or SA2 has |d2 - r²| < 1e-6.

The reference is the JAX model evaluated in float64: ``jax.enable_x64``,
the model at ``dtype=float64``, and the ``float32`` that ``nn/layers.py``
and ``models/losses.py`` pin read as float64 inside the test.  The
coordinates stay the f32 data on both sides (FPS, the ball query and the
centred ``grouped_xyz`` are the same f32 arithmetic), so both select the
same neighbours.  The JAX package's own f32 run is no gradient reference at
this size: against its float64 run it reads 3.5e-3 of the scale (in
sa2.mlp.dense_1.kernel; the loss 2.3e-5 relative).  Its CPU reductions
carry more rounding than PyTorch's, and the BatchNorm backward multiplies a
constant error in a mean over 32768 rows by a sum over the same rows.

Compared, one step of the port's ``Trainer`` (f32) against
``jax.value_and_grad`` of the JAX model's loss in float64 (printed):
  * the loss, to rtol 1e-5 (read 1.2e-6);
  * every parameter's gradient, to 1e-4 x max(1, max|ref|) per tensor
    (read 3.2e-5, in sa1.mlp.dense_1.kernel), except the 11 Dense biases
    that feed a training-mode BN: BN subtracts the batch mean, so their
    gradient is 0 (the reference reads about 2e-12) and the f32 step
    computes rounding noise there; they are held to |g| <= 2e-4 (read
    4.6e-5, in sa1.mlp.dense_0.bias);
  * the BN running stats after the step, to 1e-5 x max(1, max|ref|) per
    tensor (read 1.4e-6).
Gradients, not parameters after Adam: Adam's first step is about
lr·sign(g), so a tiny gradient of the other sign would move a parameter by
2·lr.  Adam is held to ``optax.adam`` on its own, on the same gradients for
3 steps, to rtol 1e-6 / atol 1e-9.
"""

import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from scanobjectnn_tpu.models import losses as jlosses
from scanobjectnn_tpu.models import pointnet2 as jpointnet2
from scanobjectnn_tpu.nn import layers as jlayers
from scanobjectnn_tpu.train import schedules as jschedules
from scanobjectnn_torch import convert, models
from scanobjectnn_torch.data.pipeline import EpochSampler
from scanobjectnn_torch.data.synthetic import make_synthetic_dataset
from scanobjectnn_torch.models import PointNet2ClsSSG
from scanobjectnn_torch.train import trainer as trainer_module
from scanobjectnn_torch.train.trainer import Trainer, TrainerConfig

NARROW = (
    (512, 0.2, 32, (16, 16, 32), False),
    (128, 0.4, 64, (32, 32, 48), False),
    (None, None, None, (64, 64, 96), True),
)
B, N, CLASSES = 4, 1024, 4
LOSS_RTOL, GRAD_TOL, ZERO_GRAD_TOL, STATS_TOL = 1e-5, 1e-4, 2e-4, 1e-5  # module doc


class _Jnp64(types.ModuleType):
    """``jax.numpy`` with ``float32`` read as float64: bound as ``jnp`` in
    the JAX modules that pin f32, for the float64 reference."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


class JaxNarrowSSG(jpointnet2.PointNet2ClsSSG):
    SA_CONFIGS = NARROW


class NarrowSSG(PointNet2ClsSSG):
    SA_CONFIGS = NARROW


@pytest.fixture(scope="module")
def batch():
    data, labels = make_synthetic_dataset(num_per_class=1, num_classes=CLASSES, num_points=N, seed=19)
    return {"points": data, "labels": labels}


@pytest.fixture(scope="module")
def variables(batch):
    model = JaxNarrowSSG(num_classes=CLASSES)
    key = jax.random.PRNGKey(0)
    v = model.init({"params": key, "dropout": key}, jnp.asarray(batch["points"][:, :128]), train=False)
    rng = np.random.RandomState(1)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(
            0.5 + np.abs(rng.randn(*a.shape)) if p[-1].key == "var" else 0.1 * rng.randn(*a.shape),
            jnp.float32,
        ),
        v["batch_stats"],
    )
    return {**v, "batch_stats": stats}


def _jax_step_f64(monkeypatch, batch, variables, momentum):
    """JAX loss, gradients and updated BN stats of one training forward,
    evaluated in float64 (module doc)."""
    monkeypatch.setattr(fnn, "Dropout", lambda rate, deterministic: (lambda h: h))
    for module in (jlayers, jlosses):
        monkeypatch.setattr(module, "jnp", _Jnp64("jnp"))
    with jax.enable_x64(True):
        model = JaxNarrowSSG(num_classes=CLASSES, dtype=jnp.float64)
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)), variables)

        def loss_fn(params):
            out, mut = model.apply(
                {"params": params, "batch_stats": v64["batch_stats"]},
                jnp.asarray(batch["points"]), train=True, bn_momentum=momentum, mutable=["batch_stats"],
            )
            loss, _ = model.loss(out, {"labels": jnp.asarray(batch["labels"], jnp.int32)})
            return loss, mut["batch_stats"]

        (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(v64["params"])
        grads, stats = (
            {k: np.asarray(v) for k, v in convert._flatten(tree)} for tree in (grads, stats)
        )
    assert {v.dtype for v in (*grads.values(), *stats.values())} == {np.dtype(np.float64)}
    return float(loss), grads, stats


def feeds_train_bn(param_name: str) -> bool:
    """A Dense bias followed by a training-mode BatchNorm: every SA MLP
    layer (``dense_i``) and the head's fc1 and fc2."""
    *_, layer, leaf = param_name.split(".")
    return leaf == "bias" and (layer.startswith("dense_") or layer in ("fc1", "fc2"))


def _trainer(monkeypatch, augment=False, **kw):
    monkeypatch.setitem(models.MODEL_REGISTRY, "ssg_narrow", NarrowSSG)
    if not augment:
        monkeypatch.setattr(trainer_module, "standard_train_augment", lambda points, generator: points)
    return Trainer(TrainerConfig(model="ssg_narrow", num_classes=CLASSES, batch_size=B, device="cpu", **kw))


def test_inputs_are_pinned_off_ball_boundaries(batch):
    model = NarrowSSG(num_classes=CLASSES).eval()
    with torch.no_grad():
        xyz1, feats1 = model.sa1(torch.from_numpy(batch["points"]), None)
        xyz2, _ = model.sa2(xyz1, feats1)
    for (_, radius, *_), pts, queries in zip(NARROW, (batch["points"], xyz1.numpy()), (xyz1.numpy(), xyz2.numpy())):
        d2 = ((queries[:, :, None, :].astype(np.float64) - pts[:, None, :, :]) ** 2).sum(-1)
        assert np.abs(d2 - radius * radius).min() > 1e-6


def test_train_step_matches_jax(monkeypatch, batch, variables):
    trainer = _trainer(monkeypatch)
    state = trainer.init_state()
    convert.load_jax_variables(state.model, variables)
    state.model.head.dropout_keep = 1.0
    momentum = trainer.bn_schedule(0)
    assert momentum == 0.5
    ref_loss, ref_grads, ref_stats = _jax_step_f64(monkeypatch, batch, variables, momentum)

    state, metrics = trainer.train_step(state, batch)
    assert state.step == 1 and int(metrics["count"]) == B
    loss_err = abs(float(metrics["loss"]) / ref_loss - 1)
    assert loss_err <= LOSS_RTOL, f"loss rel err {loss_err}"

    def worst_over(got, want, bound, skip=()):
        """Largest per-tensor max|got - want| / max(1, max|want|) and its
        tensor, each tensor held to ``bound`` of its scale."""
        assert sorted(got) == sorted(want)
        readings = []
        for name, ref in want.items():
            if name in skip:
                continue
            scale = max(1.0, float(np.abs(ref).max()))
            err = float(np.abs(got[name] - ref).max())
            assert err <= bound * scale, f"{name}: {err} > {bound * scale}"
            readings.append((err / scale, name))
        return max(readings)

    grads = {name: p.grad.numpy() for name, p in state.model.named_parameters()}
    zero = [name for name in grads if feeds_train_bn(name)]
    assert len(zero) == 11, zero
    noise, noisiest = max((float(np.abs(grads[n]).max()), n) for n in zero)
    assert max(float(np.abs(ref_grads[n]).max()) for n in zero) < 1e-9
    assert noise <= ZERO_GRAD_TOL, f"{noisiest}: |grad| {noise} > {ZERO_GRAD_TOL}"
    grad_err, worst = worst_over(grads, ref_grads, GRAD_TOL, skip=zero)
    stats = {name: b.numpy() for name, b in state.model.named_buffers()}
    stat_err, worst_stat = worst_over(stats, ref_stats, STATS_TOL)
    print(f"against the float64 reference: loss rel err {loss_err:.3e}; largest error / scale: "
          f"gradients {grad_err:.3e} ({worst}), BN stats {stat_err:.3e} ({worst_stat}); "
          f"the 11 Dense biases before a BN: max |grad| {noise:.3e} ({noisiest})")


def test_adam_matches_optax(monkeypatch):
    trainer = _trainer(monkeypatch, decay_step=B)  # the LR decays every step
    rng = np.random.RandomState(2)
    params = [rng.randn(5, 3).astype(np.float32), rng.randn(7).astype(np.float32)]
    grads = [[(rng.randn(*p.shape) * 10.0 ** rng.randint(-6, 1)).astype(np.float32) for p in params] for _ in range(3)]
    ours = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = trainer.make_optimizer(ours)
    schedule = jschedules.exponential_decay_lr(1e-3, B, B, 0.7)
    tx = optax.adam(schedule, eps=1e-8)
    theirs = [jnp.asarray(p) for p in params]
    opt_state = tx.init(theirs)
    for step, g in enumerate(grads):
        for p, gi in zip(ours, g):
            p.grad = torch.from_numpy(gi)
        trainer.optimizer_step(opt, step)
        updates, opt_state = tx.update([jnp.asarray(gi) for gi in g], opt_state, theirs)
        theirs = optax.apply_updates(theirs, updates)
        for p, q in zip(ours, theirs):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(q), rtol=1e-6, atol=1e-9)
    assert [trainer.lr_schedule(s) for s in range(3)] == [float(schedule(s)) for s in range(3)]
    assert trainer.lr_schedule(2) < trainer.lr_schedule(1) < trainer.lr_schedule(0)


def test_train_epoch_runs_and_updates(monkeypatch, batch):
    trainer = _trainer(monkeypatch, augment=True)
    state = trainer.init_state(seed=3)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    sampler = EpochSampler(np.concatenate([batch["points"]] * 2), np.concatenate([batch["labels"]] * 2),
                           num_points=512, seed=0)
    state, summary = trainer.train_epoch(state, sampler)
    assert state.step == 2 and np.isfinite(summary["mean_loss"]) and 0.0 <= summary["accuracy"] <= 1.0
    after = state.model.state_dict()
    assert all(not torch.equal(before[k], after[k]) for k in before if not k.endswith("dense_0.bias"))


def test_bf16_training_is_the_next_slice():
    # bf16 training of PointNet++ came with exact-key pooling: "auto" takes
    # keys; the other families train in bf16 too, where the pool mode reaches
    # no layer (tests/test_torch_mixed_train.py and the
    # test_torch_mixed_*_train.py files).
    trainer = Trainer(TrainerConfig(dtype="bfloat16", device="cpu"))
    assert trainer.pool_mode == "keys" and trainer.dtype == torch.bfloat16
    other = Trainer(TrainerConfig(model="dgcnn", dtype="bfloat16", device="cpu"))
    assert other.pool_mode == "keys" and other.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="dtype"):
        Trainer(TrainerConfig(dtype="float16", device="cpu"))
