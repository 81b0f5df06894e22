"""PyTorch port, whole PointNet++ training steps in bf16 (exact-key pooling)
and with the fused SA training tail, on the CPU, against the JAX package on
the same batch, weights and draws (no augmentation; dropout the identity on
both sides).  The set-ups are those of the f32 step tests:
``tests/test_torch_train_step.py`` (SSG), ``test_torch_pointnet2_msg_train
.py`` (MSG, the JAX side fed the port's ball groups) and
``test_torch_seg_train.py`` (BGA and part segmentation, the JAX side fed
the port's FP neighbours; their bf16 steps are in
``test_torch_mixed_seg_train.py``), B=4 clouds of N=1024 points, narrow
MLPs.

bf16 steps (``TrainerConfig(dtype="bfloat16")``: pool_precision "auto" is
"keys").  A bf16 step is not held to the JAX bf16 step element by element:
the two differ by bf16 roundings that move and then grow.  XLA on the CPU
contracts BN's ``· scale + bias`` into one FMA (the port rounds each op) and
takes another rsqrt, which moves a bf16 rounding on about 0.7% of SA1's
pooled outputs (one ulp; ``test_torch_mixed_layers.py`` holds each layer);
each later layer sums dozens of those (SA2 20% of outputs, SA3 68%, at two
ulps), and the head's training BNs over 4 clouds, whose fc outputs share a
common mode (E[x²]/var reaches about 200), amplify what reaches them: the
logits differ by 13% of their scale.  JAX's own bf16 step is as far from
the exact step: at seed 19, SSG's bf16 loss reads 1.5927 on JAX and 1.5776
on the port against 1.4401 in float64, and JAX's gradients lie up to 3.4x
their scale from the float64 ones.  So each bf16 step is held to the JAX
step evaluated in float64, the exact step, no farther than JAX's own bf16
step is.  For each tensor t (every gradient and BN running stat, and the
loss) the ratio ``|port - f64| / max(|jax_bf16 - f64|, one bf16 ulp of
max(1, |f64|max))`` (max over elements) is taken; their mean over the
tensors must be at most BF16_MEAN_RATIO (1: on average no farther than
JAX's bf16 step) and each at most BF16_TENSOR_RATIO (3: two independent
bf16 roundings of one tensor).  Read at seed 19: means 0.69 (SSG), 0.62
(MSG), 0.55 (BGA), 0.56 (part segmentation); the largest single ratio 2.1
(part segmentation's sa1.mlp.bn_0.scale).  The per-layer tests hold the
semantics tightly; this one holds that the port's bf16 step is as good a
bf16 step as the reference's.

Fused-tail steps (``TrainerConfig(fused_sa_train=True)``, f32): against
the JAX step run with ``SCANOBJECTNN_FUSED_SA_TRAIN=1`` in float64 (the
``float32`` that ``ops/pallas/satrain_kernel.py`` pins read as float64 too),
at the f32 step tests' bounds: loss rtol 1e-5, every gradient 1e-4 x max(1,
|ref|max), the Dense biases that feed a training BN (true gradient 0)
|g| <= 2e-4, BN running stats 1e-5 x max(1, |ref|max).

Also: every other family (DGCNN, SpiderCNN, PointCNN, 3DmFV-Net) builds
a bf16 ``Trainer`` and takes a finite step at a tiny size (their bf16
steps are held in ``test_torch_mixed_{dgcnn,spidercnn,pointcnn,threedmfv}_
train.py``); a JAX bf16 model's variables load strictly (``convert.py``:
the fused ops own no parameters).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanobjectnn_tpu import ops as jops
from scanobjectnn_tpu.models import pointnet2 as jpointnet2
from scanobjectnn_tpu.ops.pallas import satrain_kernel as jsatrain
from scanobjectnn_torch import convert, models
from scanobjectnn_torch.models import pointcnn
from scanobjectnn_torch.data.synthetic import make_synthetic_dataset
from scanobjectnn_torch.nn.layers import BatchNorm
from scanobjectnn_torch.nn.pointnet_modules import GroupMLPPool, LiftedGroupMLP
from scanobjectnn_torch.ops.cuda.ballgroup_kernel import query_ball_group_plain
from scanobjectnn_torch.train import trainer as trainer_module
from scanobjectnn_torch.train.trainer import Trainer, TrainerConfig
from tests import test_torch_pointcnn_train as pcnn
from tests import test_torch_pointnet2_msg_train as msg
from tests import test_torch_seg_train as seg
from tests import test_torch_train_step as ssg

B, N, CLASSES, MOMENTUM = 4, 1024, 4, 0.5
BF16_MEAN_RATIO, BF16_TENSOR_RATIO = 1.0, 3.0  # module doc
LOSS_RTOL, GRAD_TOL, ZERO_GRAD_TOL, STATS_TOL = 1e-5, 1e-4, 2e-4, 1e-5


def _port_ball_group(radius, nsample, xyz, new_xyz):
    xyz, new_xyz = (torch.from_numpy(np.array(a, np.float32)) for a in (xyz, new_xyz))
    return tuple(jnp.asarray(t.numpy()) for t in query_ball_group_plain(radius, nsample, xyz, new_xyz))


def _random_stats(v):
    rng = np.random.RandomState(1)
    return {**v, "batch_stats": jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(
            0.5 + np.abs(rng.randn(*a.shape)) if p[-1].key == "var" else 0.1 * rng.randn(*a.shape), jnp.float32),
        v["batch_stats"])}


@pytest.fixture(scope="module")
def cls_batch():
    data, labels = make_synthetic_dataset(num_per_class=1, num_classes=CLASSES, num_points=N, seed=19)
    return {"points": data, "labels": labels}


@pytest.fixture(scope="module")
def ssg_variables(cls_batch):
    model = ssg.JaxNarrowSSG(num_classes=CLASSES)
    key = jax.random.PRNGKey(0)
    return _random_stats(model.init({"params": key, "dropout": key}, jnp.asarray(cls_batch["points"][:, :128]),
                                    train=False))


@pytest.fixture(scope="module")
def msg_variables():
    return msg.variables.__wrapped__()


def _jax_bf16_step(mp, model, variables, batch, targets):
    """JAX loss, gradients and updated BN stats of one bf16 training forward
    in keys mode, on the port's ball groups."""
    mp.setattr(jops, "query_ball_group", _port_ball_group)
    mp.setattr(fnn, "Dropout", lambda rate, deterministic: (lambda h: h))
    mp.setenv("SCANOBJECTNN_SA_POOL_F32", "keys")

    def loss_fn(params):
        out, mut = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                               jnp.asarray(batch["points"]), train=True, bn_momentum=MOMENTUM,
                               mutable=["batch_stats"])
        loss, _ = model.loss(out, targets)
        return loss, mut["batch_stats"]

    (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])
    return float(loss), *({k: np.asarray(jnp.asarray(v, jnp.float32)) for k, v in convert._flatten(t)}
                          for t in (grads, stats))


def _port_step(mp, name, cls, batch, variables, num_classes=CLASSES, **config):
    mp.setitem(models.MODEL_REGISTRY, name, cls)
    mp.setattr(trainer_module, "standard_train_augment", lambda points, generator: points)
    trainer = Trainer(TrainerConfig(model=name, num_classes=num_classes, batch_size=B, device="cpu", **config))
    state = trainer.init_state()
    convert.load_jax_variables(state.model, variables)
    for module in state.model.modules():  # dropout the identity
        if hasattr(module, "dropout_keep"):
            module.dropout_keep = 1.0
    assert trainer.bn_schedule(0) == MOMENTUM
    state, metrics = trainer.train_step(state, batch)
    grads = {n: p.grad.float().numpy() for n, p in state.model.named_parameters()}
    stats = {n: b.numpy() for n, b in state.model.named_buffers()}
    return float(metrics["loss"]), grads, stats, trainer


def _hold_bf16_step(port, jax_bf16, exact):
    """Each of (loss, gradients, stats) of the port's bf16 step no farther
    from the exact step than JAX's bf16 step, by the module doc's rule."""
    readings = []
    for kind, p, j, e in zip(("loss", "grad", "stat"), port, jax_bf16, exact):
        if kind == "loss":
            p, j, e = {"loss": np.float32(p)}, {"loss": np.float32(j)}, {"loss": np.float64(e)}
        assert sorted(p) == sorted(j) == sorted(e)
        for name in e:
            scale = max(1.0, float(np.abs(e[name]).max()))
            ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
            err_p, err_j = float(np.abs(p[name] - e[name]).max()), float(np.abs(j[name] - e[name]).max())
            readings.append((err_p / max(err_j, ulp), name, err_p / scale, err_j / scale))
    readings.sort(reverse=True)
    mean_ratio = float(np.mean([r[0] for r in readings]))
    print(f"bf16 step, error against float64 / JAX bf16's: largest {readings[:3]}, mean ratio {mean_ratio:.3f}")
    assert readings[0][0] <= BF16_TENSOR_RATIO, readings[:3]
    assert mean_ratio <= BF16_MEAN_RATIO, mean_ratio


def test_ssg_bf16_step_matches_jax(monkeypatch, cls_batch, ssg_variables):
    targets = {"labels": jnp.asarray(cls_batch["labels"], jnp.int32)}
    with pytest.MonkeyPatch.context() as mp:
        exact = ssg._jax_step_f64(mp, cls_batch, ssg_variables, MOMENTUM)
    with pytest.MonkeyPatch.context() as mp:
        jax_bf16 = _jax_bf16_step(mp, ssg.JaxNarrowSSG(num_classes=CLASSES, dtype=jnp.bfloat16), ssg_variables,
                                  cls_batch, targets)
    *port, trainer = _port_step(monkeypatch, "ssg_narrow", ssg.NarrowSSG, cls_batch, ssg_variables,
                                dtype="bfloat16")
    assert trainer.pool_mode == "keys"
    _hold_bf16_step(port, jax_bf16, exact)


def test_msg_bf16_step_matches_jax(monkeypatch, cls_batch, msg_variables):
    targets = {"labels": jnp.asarray(cls_batch["labels"], jnp.int32)}
    with pytest.MonkeyPatch.context() as mp:
        exact = msg._jax_step_f64(mp, cls_batch, msg_variables, MOMENTUM)
    with pytest.MonkeyPatch.context() as mp:
        msg._narrow_jax_layers(mp)
        jax_bf16 = _jax_bf16_step(mp, jpointnet2.PointNet2ClsMSG(num_classes=CLASSES, dtype=jnp.bfloat16),
                                  msg_variables, cls_batch, targets)
    *port, _ = _port_step(monkeypatch, "msg_narrow", msg.NarrowMSG, cls_batch, msg_variables, dtype="bfloat16")
    _hold_bf16_step(port, jax_bf16, exact)


def _hold_f32_step(loss, grads, stats, ref_loss, ref_grads, ref_stats, n_zero):
    assert abs(loss / ref_loss - 1) <= LOSS_RTOL
    zero = [n for n in grads if ssg.feeds_train_bn(n)]
    assert len(zero) == n_zero, zero
    assert max(float(np.abs(grads[n]).max()) for n in zero) <= ZERO_GRAD_TOL
    for name, ref in ref_grads.items():
        if name not in zero:
            assert np.abs(grads[name] - ref).max() <= GRAD_TOL * max(1.0, float(np.abs(ref).max())), name
    for name, ref in ref_stats.items():
        assert np.abs(stats[name] - ref).max() <= STATS_TOL * max(1.0, float(np.abs(ref).max())), name


def _fused_jax(mp):
    mp.setenv("SCANOBJECTNN_FUSED_SA_TRAIN", "1")
    mp.setattr(jsatrain, "jnp", ssg._Jnp64("jnp"))


def test_ssg_fused_tail_step_matches_jax(monkeypatch, cls_batch, ssg_variables):
    calls = []
    real = jsatrain.grouped_bn_mlp_pool

    def spy(*args):
        calls.append(args[0].dtype)
        return real(*args)

    with pytest.MonkeyPatch.context() as mp:
        _fused_jax(mp)
        mp.setattr(jsatrain, "grouped_bn_mlp_pool", spy)
        ref = ssg._jax_step_f64(mp, cls_batch, ssg_variables, MOMENTUM)
    assert len(calls) >= 3 and set(calls) == {np.dtype(np.float64)}  # JAX took its fused tail
    fused_calls = []
    monkeypatch.setattr(GroupMLPPool, "fused_tail", lambda self: fused_calls.append(1) or (
        self.training and self.fused_sa_train and self.pool_mode != "keys"))
    loss, grads, stats, _ = _port_step(monkeypatch, "ssg_narrow", ssg.NarrowSSG, cls_batch, ssg_variables,
                                       fused_sa_train=True)
    assert len(fused_calls) == 3
    _hold_f32_step(loss, grads, stats, *ref, n_zero=11)


def test_msg_fused_tail_step_matches_jax(monkeypatch, cls_batch, msg_variables):
    with pytest.MonkeyPatch.context() as mp:
        _fused_jax(mp)
        ref = msg._jax_step_f64(mp, cls_batch, msg_variables, MOMENTUM)
    monkeypatch.setattr(BatchNorm, "forward", seg._bn_forward_f64)  # the head's BNs over 4 clouds (msg's doc)
    taken = []
    for cls in (GroupMLPPool, LiftedGroupMLP):
        monkeypatch.setattr(cls, "fused_tail", lambda self: taken.append(type(self).__name__) or (
            self.training and self.fused_sa_train and self.pool_mode != "keys"))
    loss, grads, stats, _ = _port_step(monkeypatch, "msg_narrow", msg.NarrowMSG, cls_batch, msg_variables,
                                       fused_sa_train=True)
    assert sorted(set(taken)) == ["GroupMLPPool", "LiftedGroupMLP"] and len(taken) == 7
    _hold_f32_step(loss, grads, stats, *ref, n_zero=23)


TINY_BF16 = {"dgcnn": {"k": 8}, "dgcnn_bga": {"k": 8}, "spidercnn_cls_xyz": {"nsample": 8},
             "pointcnn_cls": {"setting": pcnn.narrow(pointcnn, "pointcnn_cls")},
             "pointcnn_seg": {"setting": pcnn.narrow(pointcnn, "pointcnn_seg")},
             "3dmfv_net_cls": {"subdivisions": (2, 2, 2)}}


@pytest.mark.parametrize("name", sorted(TINY_BF16))
def test_other_families_refuse_bf16_training(name):
    # The families that refused bf16 until their backward kernels were held
    # in bf16 (tests/test_torch_mixed_{dgcnn,spidercnn,pointcnn,threedmfv}_
    # train.py) now build a bf16 Trainer and take a finite step, at a tiny
    # size: B=2 clouds of N=128 points in the unit ball (3DmFV's Fisher
    # vector is 0/0 beyond its GMM's reach), PointCNN's narrow settings.
    trainer = Trainer(TrainerConfig(model=name, dtype="bfloat16", batch_size=2, num_classes=3, device="cpu",
                                    model_kwargs=TINY_BF16[name]))
    assert trainer.dtype == torch.bfloat16
    state = trainer.init_state()
    points = np.random.RandomState(len(name)).randn(2, 128, 3)
    points = (0.9 * points / np.linalg.norm(points, axis=-1, keepdims=True).max()).astype(np.float32)
    batch = {"points": points, "labels": np.array([0, 2]), "masks": np.random.RandomState(1).randint(0, 2, (2, 128))}
    state, metrics = trainer.train_step(state, batch)
    assert state.step == 1 and np.isfinite(float(metrics["loss"]))
    grads = [p.grad for p in state.model.parameters()]
    assert all(g is not None and g.dtype == torch.float32 and bool(torch.isfinite(g).all()) for g in grads)
    assert any(m.dtype == torch.bfloat16 for m in state.model.modules() if hasattr(m, "dtype") and m.dtype)


@pytest.mark.parametrize("pool_precision,fused,mode", [("auto", False, "keys"), ("native", True, "0"),
                                                        ("f32", True, "1"), ("keys", True, "keys")])
def test_trainer_resolves_pool_precision_per_trainer(pool_precision, fused, mode):
    trainer = Trainer(TrainerConfig(dtype="bfloat16", pool_precision=pool_precision, fused_sa_train=fused,
                                    device="cpu"))
    state = trainer.init_state()
    mlps = [m for m in state.model.modules() if isinstance(m, GroupMLPPool)]
    assert trainer.pool_mode == mode and len(mlps) == 3
    assert all(m.pool_mode == mode and m.fused_sa_train == fused and m.dtype == torch.bfloat16 for m in mlps)
    other = Trainer(TrainerConfig(device="cpu")).init_state()  # nothing process-global
    assert all(m.pool_mode == "0" and not m.fused_sa_train for m in other.model.modules()
               if isinstance(m, GroupMLPPool))
    with pytest.raises(ValueError, match="pool_precision"):
        Trainer(TrainerConfig(pool_precision="fast", device="cpu"))


def test_jax_bf16_checkpoint_loads_strictly():
    # The fused ops own no parameters: a JAX bf16 MSG's tree (dense_i / bn_i,
    # MLP names) loads into the port's bf16 model with strict=True.
    model = jpointnet2.PointNet2ClsMSG(num_classes=CLASSES, dtype=jnp.bfloat16)
    key = jax.random.PRNGKey(0)
    tree = jax.eval_shape(lambda: model.init({"params": key, "dropout": key}, jnp.zeros((2, 256, 3)), train=False))
    variables = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), dict(tree))
    port = models.get_model("pointnet2_cls_msg", device="cpu", dtype=torch.bfloat16, num_classes=CLASSES)
    convert.load_jax_variables(port, variables)
    assert all(p.dtype == torch.float32 for p in port.parameters())
