"""PyTorch port, the DGCNN training steps on the CPU: one f32 ``Trainer``
step of ``dgcnn`` and of ``dgcnn_bga`` at full width (B=4 clouds of N=128
points of the synthetic dataset with background masks, k=20) against the
JAX step on the same batch and weights, evaluated in float64.

Set-up as ``test_torch_seg_train.py``: no augmentation (the trainer's
``standard_train_augment`` patched out); dropout the identity on both sides
(flax's ``Dropout`` patched, the port's ``dropout_keep`` and
``seg_dropout_keep`` 1.0); random BN running stats, so the momentum update
shows.  The reference is the JAX step in float64: ``jax.enable_x64``,
``dtype=float64``, and a ``jnp`` that reads ``float32`` as float64 bound
into ``nn/layers.py``, ``models/losses.py``, ``models/dgcnn.py`` and
``ops/pallas/edge_kernel.py``.

Neighbours: the reference is fed the port's five graphs of the step (the
T-Net's and EdgeConv 1-4's, recorded from the port's training forward), as
``test_torch_dgcnn.py`` feeds its inference, and each graph is first checked
against JAX's own ``knn_graph_lax`` on the float64 reference's layer input,
on the rows that clear a float64 k/(k+1) gap of ``MARGIN`` x (1 +
d²_(k+1)); at least ``CLEAR_SHARE`` of the rows must (printed).

The port's BatchNorms run in float64 (patched in): every ``BatchNorm`` as
in ``test_torch_seg_train.py`` (``_bn_forward_f64``), and ``_PairBN``'s
edge statistics (``_pair_f64``).  In f32 a training BN over B=4 clouds, and
the edge statistics' ``E[e²] - E[e]²``, amplify f32 rounding: with the
port's own f32 BNs the step reads 1.1e-4 (``dgcnn``) and 8.9e-4
(``dgcnn_bga``) of the gradients' scale on seed 23, with float64 BNs 2.2e-5
and 1.3e-4.  The last is a gate flip: one ReLU input of ``seg_mlp`` lies
within f32 rounding of 0 and opens on one side only, which moves one
column of ``seg_mlp.dense_0.kernel`` by 3.4e-3.  Such a flip is a property
of the batch, as a neighbour flip is: the batch is made from ``SEED``, on
which no gate flips (read on seeds 1-6: at most 7.9e-5, on seed 1; 1.9e-5
on seed 3).

Bounds, those of the SSG step (``test_torch_train_step.py``): the losses to
rtol 1e-5; every gradient to 1e-4 x max(1, max|ref|) per tensor, except the
Dense biases that feed a training-mode BN (every ``dense_i`` of the T-Net,
EdgeConv, agg and seg MLPs and the heads' fc1 and fc2, 12 in ``dgcnn``, 14
in ``dgcnn_bga``), whose true gradient is 0: the EdgeConv and T-Net
``dense_0`` biases enter both ``c1`` and ``c2``, cancel in ``a = c1 - c2``
and reach the edge BN once, which subtracts the batch mean.  They are held
to |g| <= 2e-4.  The BN running stats to 1e-5 x max(1, max|ref|).
"""

import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanobjectnn_tpu import models as jzoo
from scanobjectnn_tpu.models import dgcnn as jdgcnn
from scanobjectnn_tpu.models import losses as jlosses
from scanobjectnn_tpu.nn import layers as jlayers
from scanobjectnn_tpu.ops.pallas import edge_kernel as jedge
from scanobjectnn_torch import convert
from scanobjectnn_torch.data import io, synthetic
from scanobjectnn_torch.models import dgcnn
from scanobjectnn_torch.nn.layers import BatchNorm
from scanobjectnn_torch.train import trainer as trainer_module
from scanobjectnn_torch.train.trainer import Trainer, TrainerConfig

from tests.test_torch_dgcnn import PortGraphs, feed_jax
from tests.test_torch_seg_train import _bn_forward_f64

B, N, CLASSES = 4, 128, 3
LOSS_RTOL, GRAD_TOL, ZERO_GRAD_TOL, STATS_TOL = 1e-5, 1e-4, 2e-4, 1e-5  # module doc
MARGIN, CLEAR_SHARE = 1e-4, 0.9
SEED = 3  # of the batch (module doc)
MOMENTUM = 0.5  # the BN schedule's first value
MODELS = {"dgcnn": 12, "dgcnn_bga": 14}  # name: Dense biases that feed a training BN


class _Jnp64(types.ModuleType):
    """``jax.numpy`` with ``float32`` read as float64."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture(scope="module")
def batch():
    data, labels, masks = synthetic.make_synthetic_dataset(
        num_per_class=2, num_classes=CLASSES, num_points=N, seed=SEED, with_mask=True
    )
    pick = [0, 2, 3, 5]
    return {"points": data[pick], "labels": labels[pick], "masks": io.convert_to_binary_mask(masks[pick]).astype(np.int64)}


@pytest.fixture(scope="module")
def variables(batch):
    """JAX variables per model, with random BN running stats."""
    out = {}
    for name in MODELS:
        model = jzoo.get_model(name, num_classes=CLASSES)[0]
        key = jax.random.PRNGKey(0)
        v = jax.jit(lambda x, m=model: m.init({"params": key, "dropout": key}, x, train=False))(
            jnp.asarray(batch["points"][:, :32])
        )
        rng = np.random.RandomState(1)
        stats = jax.tree_util.tree_map_with_path(
            lambda p, a: jnp.asarray(
                0.5 + np.abs(rng.randn(*a.shape)) if p[-1].key == "var" else 0.1 * rng.randn(*a.shape), jnp.float32
            ),
            v["batch_stats"],
        )
        out[name] = {**v, "batch_stats": stats}
    return out


def _jax_step_f64(monkeypatch, name, batch, variables, graphs, margin=MARGIN):
    """JAX losses, gradients and updated BN stats of one training forward in
    float64, on the port's ``graphs`` (module doc), each checked on the rows
    that clear ``margin``; and the shares of rows whose graph was checked."""
    monkeypatch.setattr(fnn, "Dropout", lambda rate, deterministic: (lambda h: h))
    for module in (jlayers, jlosses, jdgcnn, jedge):
        monkeypatch.setattr(module, "jnp", _Jnp64("jnp"))
    targets = {k: jnp.asarray(batch[k], jnp.int32) for k in ("labels", "masks")}
    points = jnp.asarray(batch["points"])
    shares = []
    with jax.enable_x64(True):
        model = jzoo.get_model(name, num_classes=CLASSES, dtype=jnp.float64)[0]
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)), variables)
        feed_jax(monkeypatch, graphs, margin, shares)
        model.apply(v64, points, train=True, bn_momentum=MOMENTUM, mutable=["batch_stats"])
        feed_jax(monkeypatch, graphs, margin, shares, checked=False)

        def loss_fn(params):
            out, mut = model.apply(
                {"params": params, "batch_stats": v64["batch_stats"]},
                points, train=True, bn_momentum=MOMENTUM, mutable=["batch_stats"],
            )
            loss, metrics = model.loss(out, targets)
            return loss, (metrics, mut["batch_stats"])

        (_, (metrics, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v64["params"])
        grads, stats = ({k: np.asarray(v) for k, v in convert._flatten(tree)} for tree in (grads, stats))
        metrics = {k: float(v) for k, v in metrics.items()}
    assert {v.dtype for v in (*grads.values(), *stats.values())} == {np.dtype(np.float64)}
    return metrics, grads, stats, shares


def feeds_train_bn(param_name: str) -> bool:
    """A Dense bias followed by a training-mode BatchNorm (module doc)."""
    *_, layer, leaf = param_name.split(".")
    return leaf == "bias" and (layer.startswith("dense_") or layer in ("fc1", "fc2"))


def _pair_f64(self, a, red, k, bn_momentum=None):
    """``_PairBN.pair`` evaluated in float64 (its formula and running-stat
    update), returning f32."""
    af = a.double()
    s, q2 = red["s"].double(), red["q2"].double()
    count = af.shape[0] * af.shape[1] * k
    mean = (k * af.sum(dim=(0, 1)) + s.sum(dim=(0, 1))) / count
    mean2 = (k * torch.square(af) + 2.0 * af * s + q2).sum(dim=(0, 1)) / count
    var = torch.clamp(mean2 - torch.square(mean), min=0.0)
    self.update_running(mean.float(), var.float(), bn_momentum)
    m_sel = torch.where(self.scale >= 0, red["mmax"], red["mmin"]).double()
    y = (af + m_sel - mean) * torch.rsqrt(var + self.epsilon)
    return (y * self.scale.double() + self.bias.double()).float()


def feeds_train_bn(param_name: str) -> bool:
    """A Dense bias followed by a training-mode BatchNorm (module doc)."""
    *_, layer, leaf = param_name.split(".")
    return leaf == "bias" and (layer.startswith("dense_") or layer in ("fc1", "fc2"))


def _worst_over(got, want, bound, skip=()):
    assert sorted(got) == sorted(want)
    readings = []
    for key, ref in want.items():
        if key in skip:
            continue
        scale = max(1.0, float(np.abs(ref).max()))
        err = float(np.abs(got[key] - ref).max())
        assert err <= bound * scale, f"{key}: {err} > {bound * scale}"
        readings.append((err / scale, key))
    return max(readings)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_train_step_matches_jax_f64(monkeypatch, batch, variables, name):
    monkeypatch.setattr(BatchNorm, "forward", _bn_forward_f64)
    monkeypatch.setattr(dgcnn._PairBN, "pair", _pair_f64)
    monkeypatch.setattr(trainer_module, "standard_train_augment", lambda points, generator: points)
    trainer = Trainer(TrainerConfig(model=name, num_classes=CLASSES, batch_size=B, device="cpu"))
    assert trainer.bn_schedule(0) == MOMENTUM
    state = trainer.init_state()
    convert.load_jax_variables(state.model, variables[name])
    state.model.dropout_keep = 1.0
    state.model.seg_dropout_keep = 1.0
    with monkeypatch.context() as mp:
        rec = PortGraphs(mp)
        state, metrics = trainer.train_step(state, batch)
    assert state.step == 1 and len(rec.idx) == 5
    ref_metrics, ref_grads, ref_stats, shares = _jax_step_f64(monkeypatch, name, batch, variables[name], rec.idx)
    print(f"{name}: shares of rows checked per graph {[round(s, 4) for s in shares]}")
    assert len(shares) == 5 and min(shares) >= CLEAR_SHARE

    assert sorted(ref_metrics) == sorted(k for k in metrics if k in ref_metrics)
    for key, ref in ref_metrics.items():
        err = abs(float(metrics[key]) / ref - 1)
        assert err <= LOSS_RTOL, f"{key} rel err {err}"
    grads = {key: p.grad.numpy() for key, p in state.model.named_parameters()}
    zero = [key for key in grads if feeds_train_bn(key)]
    assert len(zero) == MODELS[name], zero
    assert max(float(np.abs(ref_grads[k]).max()) for k in zero) < 1e-9
    noise, noisiest = max((float(np.abs(grads[k]).max()), k) for k in zero)
    assert noise <= ZERO_GRAD_TOL, f"{noisiest}: |grad| {noise} > {ZERO_GRAD_TOL}"
    grad_err, worst = _worst_over(grads, ref_grads, GRAD_TOL, skip=zero)
    stats = {key: b.numpy() for key, b in state.model.named_buffers()}
    stat_err, worst_stat = _worst_over(stats, ref_stats, STATS_TOL)
    print(f"{name} against the float64 reference: loss {float(metrics['loss']):.7f} vs {ref_metrics['loss']:.7f}; "
          f"largest error / scale: gradients {grad_err:.3e} ({worst}), BN stats {stat_err:.3e} ({worst_stat}); "
          f"the {len(zero)} Dense biases before a BN: max |grad| {noise:.3e} ({noisiest})")
