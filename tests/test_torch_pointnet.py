"""PyTorch port, the PointNet family on the CPU: ``pointnet_cls``,
``pointnet_cls_basic``, ``pointnet_seg`` and ``pointnet_partseg`` at full
width against the JAX models on the same weights; and the registry.

Weights: the JAX variable tree from ``jax.eval_shape`` (no JAX init), every
leaf drawn with numpy from ``SEED`` (``random_variables``): kernels uniform
with unit-variance outputs, but the zero-initialised T-Net ``transform``
kernels at 0.05 of that, so the transforms lie near the identity, as the
orthogonality penalty keeps them in training, and are not the identity;
biases, BN scales and shifts near their init; running means 0.1·N(0, 1) and
variances 0.5 + |N(0, 1)|, so every BN matters.

Forwards (eval), B=2 clouds of N=128 points of the synthetic dataset, f32:
``logits`` and ``seg_logits`` within rtol 2e-4 and atol 2e-5 x max(1,
|ref|max) (SSG's bound), the predicted classes equal.

Steps: one f32 ``Trainer.train_step`` of ``pointnet_cls``, ``pointnet_seg``
and ``pointnet_partseg`` (B=4, N=128, no augmentation, dropout the identity
on both sides) against the JAX step evaluated in float64 (``jnp`` with
``float32`` read as float64 bound into ``nn/layers.py``, ``models/losses.py``
and ``models/pointnet.py``), with the port's BatchNorms in float64 (the
head's BNs over 4 clouds amplify f32 rounding; ``ROADMAP.md``, facts for
parity tests).  The reference is fed the port's relu gates: every port
relu records its mask (x > 0), and the JAX ``nn.relu`` of the reference
applies the mask of the same call (in call order, the two models' relus
are the same sites), so a gate whose input lies within f32 rounding of 0
cannot open on one side only and move a whole row's gradient (``ROADMAP.md``:
flips; in the seg models every row feeds the loss, and at B=4, N=128 most
batches hold such a gate).  Each gate where the two differ must lie within
``GATE_MARGIN`` x max(1, |x|max of its call) of 0 in the float64 reference
(the count is printed: 0-7 a step on seeds 7, 10, 11, 13 and 15).  Bounds,
those of the SSG step but the gradients': the losses (``loss``,
``mat_diff_loss`` and the others) to rtol 1e-5, every gradient to
``GRAD_TOL`` = 3e-4 x max(1, |ref|max) (the input T-Net's gradients read up
to 2.1e-4 of their scale, ``pointnet_seg`` on seed 10, and 1.7e-5 with the
port's products patched to float64: the f32 rounding of the products,
amplified where the transform's gradient sums points x dx over each cloud;
the other tensors read below 1e-4), the Dense biases that feed a training BN (true gradient
0) to |g| <= 2e-4, the BN running stats to 1e-5 x max(1, |ref|max).  Under
part segmentation the class head runs but feeds no loss: its parameters
have no gradient in the port (None) and an exact 0 in JAX, and its BNs'
running statistics are held as the others.

The bf16 ``pointnet_cls`` step (exact-key pooling) is held by
``tests/test_torch_mixed_train.py``'s rule: no farther from the float64
step than JAX's own bf16 step.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanobjectnn_tpu import models as jzoo
from scanobjectnn_tpu.models import losses as jlosses
from scanobjectnn_tpu.models import pointnet as jpointnet
from scanobjectnn_tpu.nn import layers as jlayers
from scanobjectnn_torch import convert, models
from scanobjectnn_torch.data.synthetic import make_synthetic_dataset
from scanobjectnn_torch.models import MODEL_REGISTRY, get_model
from scanobjectnn_torch.nn.layers import BatchNorm, MaxPoolMLP
from scanobjectnn_torch.train import trainer as trainer_module
from scanobjectnn_torch.train.trainer import Trainer, TrainerConfig

from tests.test_torch_mixed_train import _hold_bf16_step
from tests.test_torch_seg_train import _bn_forward_f64
from tests.test_torch_train_step import _Jnp64

NAMES = ("pointnet_cls", "pointnet_cls_basic", "pointnet_seg", "pointnet_partseg")
SEED = 7
B_FWD, B, N, CLASSES, PARTS = 2, 4, 128, 4, 3
FWD_RTOL, FWD_ATOL = 2e-4, 2e-5  # module doc
LOSS_RTOL, GRAD_TOL, ZERO_GRAD_TOL, STATS_TOL = 1e-5, 3e-4, 2e-4, 1e-5  # module doc
GATE_MARGIN = 1e-4  # module doc
MOMENTUM = 0.5  # the BN schedule's first value


def random_variables(model, points_shape, seed: int, leaf_init=None):
    """JAX ``variables`` of ``model`` for input ``points_shape`` (shapes by
    ``jax.eval_shape``), drawn with numpy (module doc).  ``leaf_init(path,
    shape, rng)`` may return a leaf's value (or None for the default)."""
    key = jax.random.PRNGKey(0)
    tree = jax.eval_shape(lambda: model.init({"params": key, "dropout": key}, jnp.zeros(points_shape), train=False))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        names = [p.key for p in path]
        shape = leaf.shape
        value = leaf_init(names, shape, rng) if leaf_init is not None else None
        if value is not None:
            return np.asarray(value, np.float32)
        name = names[-1]
        if names[0] == "batch_stats":
            value = 0.5 + np.abs(rng.randn(*shape)) if name == "var" else 0.1 * rng.randn(*shape)
        elif name == "kernel":
            # A T-Net's transform near the identity, as training keeps it.
            limit = np.sqrt(3.0 / np.prod(shape[:-1])) * (0.05 if names[-2] == "transform" else 1.0)
            value = rng.uniform(-limit, limit, shape)
        elif name == "scale":
            value = 1.0 + 0.1 * rng.randn(*shape)
        else:
            value = 0.1 * rng.randn(*shape)
        return np.asarray(value, np.float32)

    return jax.tree_util.tree_map_with_path(draw, dict(tree))


def _jax_model(name, **kw):
    sizes = {"num_parts": PARTS} if name == "pointnet_partseg" else {"num_classes": CLASSES}
    return jzoo.get_model(name, **sizes, **kw)[0]


@pytest.fixture(scope="module")
def batch():
    data, labels, masks, parts = make_synthetic_dataset(
        num_per_class=1, num_classes=CLASSES, num_points=N, seed=SEED, with_mask=True, with_parts=True
    )
    return {"points": data, "labels": labels, "masks": (masks >= 0).astype(np.int64), "parts": parts}


@pytest.fixture(scope="module")
def variables():
    return {name: random_variables(_jax_model(name), (B, N, 3), SEED + i) for i, name in enumerate(NAMES)}


def test_registry_has_the_jax_registrys_names_and_kinds():
    assert sorted(MODEL_REGISTRY) == sorted(jzoo.MODEL_REGISTRY)
    for name, cls in MODEL_REGISTRY.items():
        assert cls.kind == jzoo.MODEL_REGISTRY[name].kind, name


@pytest.mark.parametrize("name", sorted(jzoo.MODEL_REGISTRY))
def test_get_model_builds_every_jax_name(name):
    model = get_model(name, device="cpu")
    assert isinstance(model, MODEL_REGISTRY[name]) and all(p.device.type == "cpu" for p in model.parameters())


def test_basic_classifier_is_pointnet_cls_without_tnets():
    basic = get_model("pointnet_cls_basic", device="cpu")
    assert isinstance(basic, models.PointNetCls) and not basic.trunk.use_tnet
    assert not hasattr(basic.trunk, "input_tnet")
    assert jzoo.MODEL_REGISTRY["pointnet_cls_basic"].defaults == {"use_tnet": False}


@pytest.mark.parametrize("name", NAMES)
def test_jax_variables_load_strictly(variables, name):
    model = get_model(name, device="cpu", **({"num_parts": PARTS} if name == "pointnet_partseg" else
                                            {"num_classes": CLASSES}))
    convert.load_jax_variables(model, variables[name])  # strict: every name and shape
    pools = [m for m in model.modules() if isinstance(m, MaxPoolMLP)]
    assert len(pools) == (1 if name == "pointnet_cls_basic" else 3)
    assert all(p.dim == 1 for p in pools)


def _port_eval(name, variables):
    model = get_model(name, device="cpu", **({"num_parts": PARTS} if name == "pointnet_partseg" else
                                            {"num_classes": CLASSES}))
    return convert.load_jax_variables(model, variables).eval()


@pytest.mark.parametrize("name", NAMES)
def test_f32_forward_matches_jax(batch, variables, name):
    points = batch["points"][:B_FWD]
    jmodel = _jax_model(name)
    ref = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables[name], jnp.asarray(points))
    with torch.no_grad():
        got = _port_eval(name, variables[name])(torch.from_numpy(points))
    keys = [k for k in ("logits", "seg_logits") if k in ref]
    assert keys and sorted(keys) == sorted(k for k in got if k != "end_points")
    for key in keys:
        want = np.asarray(ref[key])
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got[key].numpy(), want, rtol=FWD_RTOL, atol=FWD_ATOL * scale, err_msg=key)
        np.testing.assert_array_equal(got[key].numpy().argmax(-1), want.argmax(-1))
    if name != "pointnet_cls_basic":
        np.testing.assert_allclose(got["end_points"]["transform"].numpy(), np.asarray(ref["end_points"]["transform"]),
                                   rtol=FWD_RTOL, atol=FWD_ATOL)


def _targets(name, batch):
    kind = MODEL_REGISTRY[name].kind
    keys = {"cls": ("labels",), "seg": ("labels", "masks"), "partseg": ("parts",)}[kind]
    return {k: batch[k] for k in keys}


class Gates:
    """The port's relu masks, recorded in call order (``record``) and fed
    to the JAX reference's ``nn.relu`` (``feed``); module doc."""

    def __init__(self):
        self.masks, self.inputs = [], []

    def record(self, mp) -> None:
        real = torch.relu

        def relu(x):
            self.masks.append((x.detach() > 0).numpy())
            return real(x)

        mp.setattr(torch, "relu", relu)

    def feed(self, mp) -> None:
        def relu(x):
            mask = self.masks[len(self.inputs)]
            assert mask.shape == x.shape, (len(self.inputs), mask.shape, x.shape)
            self.inputs.append(x)
            return jnp.where(jnp.asarray(mask), x, jnp.zeros((), x.dtype))

        mp.setattr(fnn, "relu", relu)

    def check(self, inputs) -> int:
        """Every gate where the port and the float64 reference differ lies
        within ``GATE_MARGIN`` of 0; returns their count."""
        assert len(inputs) == len(self.masks)
        flips = 0
        for mask, x in zip(self.masks, inputs):
            x = np.asarray(x)
            differ = mask != (x > 0)
            flips += int(differ.sum())
            margin = GATE_MARGIN * max(1.0, float(np.abs(x).max()))
            assert np.all(np.abs(x[differ]) <= margin), (np.abs(x[differ]).max(), margin)
        print(f"relu gates fed to the reference: {len(inputs)} calls, {flips} differing near 0")
        return flips


def _jax_step_f64(mp, name, batch, variables, gates: Gates | None = None, modules=(), model_kw=None):
    """JAX metrics, gradients and updated BN stats of one training forward
    in float64 (module doc), ``jnp`` read as float64 in ``modules`` too;
    with ``gates``, the port's relu gates fed in and checked."""
    mp.setattr(fnn, "Dropout", lambda rate, deterministic: (lambda h: h))
    for module in (jlayers, jlosses, jpointnet, *modules):
        mp.setattr(module, "jnp", _Jnp64("jnp"))
    if gates is not None:
        gates.feed(mp)
    targets = {k: jnp.asarray(v, jnp.int32) for k, v in _targets(name, batch).items()}
    with jax.enable_x64(True):
        model = _jax_model(name, dtype=jnp.float64, **(model_kw or {}))
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)), variables)

        def loss_fn(params):
            if gates is not None:
                gates.inputs.clear()
            out, mut = model.apply({"params": params, "batch_stats": v64["batch_stats"]}, jnp.asarray(batch["points"]),
                                   train=True, bn_momentum=MOMENTUM, mutable=["batch_stats"])
            loss, metrics = model.loss(out, targets)
            return loss, (metrics, mut["batch_stats"], list(gates.inputs) if gates is not None else [])

        (_, (metrics, stats, relu_inputs)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v64["params"])
        grads, stats = ({k: np.asarray(v) for k, v in convert._flatten(t)} for t in (grads, stats))
        metrics = {k: float(v) for k, v in metrics.items()}
    if gates is not None:
        gates.check(relu_inputs)
    return metrics, grads, stats


def _jax_bf16_step(mp, name, batch, variables):
    """JAX loss, gradients and updated BN stats of one bf16 training forward
    under exact-key pooling."""
    mp.setattr(fnn, "Dropout", lambda rate, deterministic: (lambda h: h))
    mp.setenv("SCANOBJECTNN_SA_POOL_F32", "keys")
    model = _jax_model(name, dtype=jnp.bfloat16)
    targets = {k: jnp.asarray(v, jnp.int32) for k, v in _targets(name, batch).items()}

    def loss_fn(params):
        out, mut = model.apply({"params": params, "batch_stats": variables["batch_stats"]}, jnp.asarray(batch["points"]),
                               train=True, bn_momentum=MOMENTUM, mutable=["batch_stats"])
        return model.loss(out, targets)[0], mut["batch_stats"]

    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    return float(loss), *({k: np.asarray(jnp.asarray(v, jnp.float32)) for k, v in convert._flatten(t)}
                          for t in (grads, stats))


def _port_step(mp, name, batch, variables, **config):
    """One port ``Trainer.train_step``: (metrics, gradients (None where a
    parameter got none), BN stats, the trainer)."""
    mp.setattr(trainer_module, "standard_train_augment", lambda points, generator: points)
    trainer = Trainer(TrainerConfig(model=name, num_classes=PARTS if name == "pointnet_partseg" else CLASSES,
                                    batch_size=B, device="cpu", **config))
    assert trainer.bn_schedule(0) == MOMENTUM
    state = trainer.init_state()
    convert.load_jax_variables(state.model, variables)
    for module in state.model.modules():  # dropout the identity
        if hasattr(module, "dropout_keep"):
            module.dropout_keep = 1.0
    state, metrics = trainer.train_step(state, {"points": batch["points"], **_targets(name, batch)})
    grads = {n: None if p.grad is None else p.grad.float().numpy() for n, p in state.model.named_parameters()}
    persistent = state.model.state_dict()
    stats = {n: b.numpy() for n, b in state.model.named_buffers() if n in persistent}
    return {k: float(v) for k, v in metrics.items()}, grads, stats, trainer


def feeds_train_bn(param_name: str) -> bool:
    """A Dense bias followed by a training-mode BatchNorm: every MLP's
    ``dense_i`` and the heads' fc1 and fc2."""
    *_, layer, leaf = param_name.split(".")
    return leaf == "bias" and (layer.startswith("dense_") or layer in ("fc1", "fc2"))


def hold_f32_step(port, ref, n_zero: int, no_grad_prefix: str | None = None, feeds=feeds_train_bn) -> None:
    """The port's f32 step (metrics, gradients, stats) against the float64
    reference's by the module doc's bounds.  Parameters under
    ``no_grad_prefix`` have no gradient in the port and 0 in JAX; ``feeds``
    names the biases before a training BN."""
    (metrics, grads, stats), (ref_metrics, ref_grads, ref_stats) = port, ref
    for key, want in ref_metrics.items():
        assert abs(metrics[key] - want) <= LOSS_RTOL * abs(want), (key, metrics[key], want)
    assert sorted(grads) == sorted(ref_grads) and sorted(stats) == sorted(ref_stats)
    skipped = [n for n in grads if no_grad_prefix and n.startswith(no_grad_prefix)]
    for n in skipped:
        assert grads[n] is None and not np.any(ref_grads[n]), n
    zero = [n for n in grads if feeds(n) and n not in skipped]
    assert len(zero) == n_zero, zero
    assert max(float(np.abs(grads[n]).max()) for n in zero) <= ZERO_GRAD_TOL
    worst = 0.0
    for name, want in ref_grads.items():
        if name in zero or name in skipped:
            continue
        scale = max(1.0, float(np.abs(want).max()))
        err = float(np.abs(grads[name] - want).max())
        assert err <= GRAD_TOL * scale, (name, err, scale)
        worst = max(worst, err / scale)
    for name, want in ref_stats.items():
        assert np.abs(stats[name] - want).max() <= STATS_TOL * max(1.0, float(np.abs(want).max())), name
    print(f"f32 step: largest gradient error / scale {worst:.3e}")


# Dense biases before a training BN: the T-Nets' mlp (3 each) and fc (2
# each), mlp1 (2), mlp2 (3), the head's fc1 and fc2, seg_mlp (4).
STEPS = {"pointnet_cls": (17, None), "pointnet_seg": (21, None), "pointnet_partseg": (19, "net.fc")}


def _f32_steps(name, batch, variables):
    """(the port's f32 step, the float64 reference fed its relu gates)."""
    gates = Gates()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(BatchNorm, "forward", _bn_forward_f64)
        gates.record(mp)
        metrics, grads, stats, _ = _port_step(mp, name, batch, variables[name])
    with pytest.MonkeyPatch.context() as mp:
        ref = _jax_step_f64(mp, name, batch, variables[name], gates)
    return (metrics, grads, stats), ref


@pytest.fixture(scope="module")
def cls_steps(batch, variables):
    return _f32_steps("pointnet_cls", batch, variables)


@pytest.mark.parametrize("name", sorted(STEPS))
def test_f32_step_matches_jax_f64(request, batch, variables, name):
    port, ref = request.getfixturevalue("cls_steps") if name == "pointnet_cls" else _f32_steps(name, batch, variables)
    metrics, grads, stats = port
    assert "mat_diff_loss" in ref[0]
    n_zero, no_grad = STEPS[name]
    hold_f32_step((metrics, grads, stats), ref, n_zero, no_grad)
    if name == "pointnet_partseg":  # the unused class head's BNs moved, as in JAX
        assert not np.allclose(stats["net.fc_bn1.mean"], variables[name]["batch_stats"]["net"]["fc_bn1"]["mean"])


def test_bf16_cls_step_no_farther_from_f64_than_jax_bf16(monkeypatch, batch, variables, cls_steps):
    name = "pointnet_cls"
    ref_metrics, ref_grads, ref_stats = cls_steps[1]  # the float64 step (the f32 step's gates: none differ)
    with pytest.MonkeyPatch.context() as mp:
        jax_bf16 = _jax_bf16_step(mp, name, batch, variables[name])
    calls = []
    from scanobjectnn_torch.ops import exactpool

    real = exactpool.bn_relu_exactkey_pool
    monkeypatch.setattr(exactpool, "bn_relu_exactkey_pool", lambda *a: calls.append(a[0].shape) or real(*a))
    metrics, grads, stats, trainer = _port_step(monkeypatch, name, batch, variables[name], dtype="bfloat16")
    assert trainer.pool_mode == "keys"
    assert calls == [torch.Size([B, N, 1024])] * 3  # the three global pools through #18's op
    _hold_bf16_step((metrics["loss"], grads, stats), jax_bf16, (ref_metrics["loss"], ref_grads, ref_stats))


def test_pointnet_refuses_nothing_in_bf16_and_3dmfv_refuses_bf16():
    # Since 3DmFV-Net's bf16 was ported, neither family refuses bf16: the
    # PointNets pool by exact keys, 3DmFV builds its layers in bf16.
    for name in NAMES:
        assert Trainer(TrainerConfig(model=name, dtype="bfloat16", device="cpu")).pool_mode == "keys"
    trainer = Trainer(TrainerConfig(model="3dmfv_net_cls", dtype="bfloat16", device="cpu",
                                    model_kwargs={"subdivisions": (2, 2, 2)}))
    model = trainer.init_state().model
    assert model.dtype == model.inception1.conv1.Conv_0.dtype == model.fc4.dtype == torch.bfloat16
    with pytest.raises(KeyError, match="unknown model"):
        Trainer(TrainerConfig(model="pointnet3", device="cpu"))


def test_eval_votes_takes_each_votes_transform_as_jax(batch, variables):
    # The orthogonality penalty reads each vote's transform: end_points are
    # split by vote as the logits (JAX trainer.py:_eval_votes_impl).
    from scanobjectnn_tpu.parallel import mesh as mesh_lib
    from scanobjectnn_tpu.train.trainer import Trainer as JaxTrainer
    from scanobjectnn_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
    from scanobjectnn_tpu.train.trainer import TrainState as JaxTrainState

    votes, name = 3, "pointnet_cls"
    cfg = dict(model=name, num_classes=CLASSES, batch_size=B_FWD, num_point=N)
    jtrainer = JaxTrainer(JaxTrainerConfig(**cfg), mesh=mesh_lib.make_mesh(devices=jax.devices()[:1]))
    v = variables[name]
    # Eval reads only the variables: a state built from them, no JAX init.
    jstate = JaxTrainState(step=0, params=jax.tree_util.tree_map(jnp.asarray, v["params"]),
                           batch_stats=jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]), opt_state=None)
    trainer = Trainer(TrainerConfig(**cfg, device="cpu"))
    state = trainer.init_state(0)
    convert.load_jax_variables(state.model, v)
    small = {"points": batch["points"][:B_FWD], "labels": batch["labels"][:B_FWD]}
    ref = jtrainer.eval_votes(jstate, small, num_votes=votes)
    got = trainer.eval_votes(state, small, num_votes=votes)
    np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]), rtol=FWD_RTOL)
    want = np.asarray(ref["logits_sum"])
    np.testing.assert_allclose(got["logits_sum"].numpy(), want, rtol=FWD_RTOL,
                               atol=FWD_ATOL * max(1.0, float(np.abs(want).max())))
