"""PyTorch port, the SpiderCNN training step on the CPU: one f32 ``Trainer``
step of ``spidercnn_cls_xyz`` at full width (B=4 clouds of N=128 points of
the synthetic dataset, nsample 20) against the JAX step on the same batch
and weights, evaluated in float64.

Set-up as ``test_torch_dgcnn_train.py``: no augmentation (the trainer's
``standard_train_augment`` patched out); dropout the identity on both sides
(flax's ``Dropout`` patched, the port's ``dropout_keep`` 1.0); random BN
running stats and GroupNorm scales and biases.  The reference is the JAX
step in float64: ``jax.enable_x64``, ``dtype=float64``, and a ``jnp`` that
reads ``float32`` as float64 bound into ``nn/layers.py``,
``models/losses.py``, ``models/spidercnn.py`` and
``ops/pallas/spider_kernel.py`` (flax's GroupNorm then takes its
statistics in float64 too).  The reference is fed the port's kNN graph,
checked first against JAX's own ``knn_graph_lax`` on the rows that clear a
float64 k/(k+1) gap of ``MARGIN`` x (1 + d²_(k+1)); at least
``CLEAR_SHARE`` of them must (printed).

The fc BNs run over the B=4 clouds, which amplifies f32 rounding (a
training BN over few rows; ``ROADMAP.md`` queue 3), so the port's
BatchNorms run in float64 (``_bn_forward_f64`` of
``test_torch_seg_train.py``); the GroupNorms take their statistics over
N·C/G = 256 to 2048 values of one cloud and stay f32.  With the port's own
f32 BNs the step reads up to 1.3e-4 of a gradient's scale off float64 on
seeds 1-6 (over the bound on five of them); with float64 BNs 1.7e-5 to
2.9e-5 (2.7e-5 on ``SEED``, in fc1.kernel).  ``topk_pool`` picks the same
points on both sides on these batches; a value within rounding of its
channel's second largest would route a gradient to another point, as a
gate flip does in ``test_torch_dgcnn_train.py``, so the test states its
seed.

Bounds, those of the SSG and DGCNN steps: the losses to rtol 1e-5; every
gradient to 1e-4 x max(1, max|ref|) per tensor, except the Dense biases of
fc1 and fc2, which feed a training-mode BN and whose true gradient is 0
(held to |g| <= 2e-4); the BN running stats to 1e-5 x max(1, max|ref|).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scanobjectnn_tpu import models as jzoo
from scanobjectnn_tpu import ops as jops
from scanobjectnn_tpu.models import losses as jlosses
from scanobjectnn_tpu.models import spidercnn as jspider
from scanobjectnn_tpu.nn import layers as jlayers
from scanobjectnn_tpu.ops.pallas import spider_kernel as jsk
from scanobjectnn_torch import convert
from scanobjectnn_torch.data import synthetic
from scanobjectnn_torch.models import spidercnn
from scanobjectnn_torch.nn.layers import BatchNorm
from scanobjectnn_torch.train import trainer as trainer_module
from scanobjectnn_torch.train.trainer import Trainer, TrainerConfig

from tests.test_torch_dgcnn import clear_share
from tests.test_torch_dgcnn_train import _Jnp64, _worst_over, feeds_train_bn
from tests.test_torch_seg_train import _bn_forward_f64
from tests.test_torch_spidercnn import jax_variables

B, N, CLASSES, NSAMPLE = 4, 128, 3, 20
LOSS_RTOL, GRAD_TOL, ZERO_GRAD_TOL, STATS_TOL = 1e-5, 1e-4, 2e-4, 1e-5  # module doc
MARGIN, CLEAR_SHARE = 1e-4, 0.9
SEED = 4  # of the batch (module doc)
MOMENTUM = 0.5  # the BN schedule's first value


@pytest.fixture(scope="module")
def batch():
    data, labels = synthetic.make_synthetic_dataset(num_per_class=2, num_classes=CLASSES, num_points=N, seed=SEED)
    pick = [0, 2, 3, 5]
    return {"points": data[pick], "labels": labels[pick]}


@pytest.fixture(scope="module")
def variables(batch):
    v = jax_variables(batch["points"], NSAMPLE)
    model = jzoo.get_model("spidercnn_cls_xyz", num_classes=CLASSES)[0]
    key = jax.random.PRNGKey(0)
    head = jax.jit(lambda x: model.init({"params": key, "dropout": key}, x, train=False))(
        jnp.asarray(batch["points"][:, :32])
    )
    v["params"]["fc3"] = jax.tree_util.tree_map(np.asarray, head["params"]["fc3"])  # CLASSES outputs
    return v


def _jax_step_f64(monkeypatch, batch, variables, graph):
    """JAX loss, gradients and updated BN stats of one training forward in
    float64 on the port's ``graph`` (module doc), and the share of its rows
    checked against JAX's own kNN."""
    monkeypatch.setattr(fnn, "Dropout", lambda rate, deterministic: (lambda h: h))
    for module in (jlayers, jlosses, jspider, jsk):
        monkeypatch.setattr(module, "jnp", _Jnp64("jnp"))
    monkeypatch.setattr(jops, "knn_graph", lambda feats, k: jnp.asarray(graph))
    labels = {"labels": jnp.asarray(batch["labels"], jnp.int32)}
    points = jnp.asarray(batch["points"])
    with jax.enable_x64(True):
        model = jzoo.get_model("spidercnn_cls_xyz", num_classes=CLASSES, dtype=jnp.float64)[0]
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)), variables)
        shares = [clear_share(points, graph, NSAMPLE, MARGIN)]

        def loss_fn(params):
            out, mut = model.apply(
                {"params": params, "batch_stats": v64["batch_stats"]},
                points, train=True, bn_momentum=MOMENTUM, mutable=["batch_stats"],
            )
            loss, metrics = model.loss(out, labels)
            return loss, (metrics, mut["batch_stats"])

        (_, (metrics, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v64["params"])
        grads, stats = ({k: np.asarray(v) for k, v in convert._flatten(tree)} for tree in (grads, stats))
        metrics = {k: float(v) for k, v in metrics.items()}
    assert {v.dtype for v in (*grads.values(), *stats.values())} == {np.dtype(np.float64)}
    return metrics, grads, stats, shares


def test_train_step_matches_jax_f64(monkeypatch, batch, variables):
    monkeypatch.setattr(BatchNorm, "forward", _bn_forward_f64)
    monkeypatch.setattr(trainer_module, "standard_train_augment", lambda points, generator: points)
    trainer = Trainer(TrainerConfig(model="spidercnn_cls_xyz", num_classes=CLASSES, batch_size=B, device="cpu"))
    assert trainer.bn_schedule(0) == MOMENTUM
    state = trainer.init_state()
    convert.load_jax_variables(state.model, variables)
    state.model.dropout_keep = 1.0
    graphs = []
    gather = spidercnn.edge_gather_knn

    def recorded(feats, vals, k):
        out = gather(feats, vals, k)
        graphs.append(out[1].numpy())
        return out

    with monkeypatch.context() as mp:
        mp.setattr(spidercnn, "edge_gather_knn", recorded)
        state, metrics = trainer.train_step(state, batch)
    assert state.step == 1 and len(graphs) == 1 and graphs[0].shape == (B, N, NSAMPLE)
    ref_metrics, ref_grads, ref_stats, shares = _jax_step_f64(monkeypatch, batch, variables, graphs[0])
    print(f"shares of rows checked {[round(s, 4) for s in shares]}")
    assert shares and min(shares) >= CLEAR_SHARE

    assert sorted(ref_metrics) == sorted(k for k in metrics if k in ref_metrics)
    for key, ref in ref_metrics.items():
        err = abs(float(metrics[key]) / ref - 1)
        assert err <= LOSS_RTOL, f"{key} rel err {err}"
    grads = {key: p.grad.numpy() for key, p in state.model.named_parameters()}
    zero = [key for key in grads if feeds_train_bn(key)]
    assert sorted(zero) == ["fc1.bias", "fc2.bias"]
    assert max(float(np.abs(ref_grads[k]).max()) for k in zero) < 1e-9
    noise, noisiest = max((float(np.abs(grads[k]).max()), k) for k in zero)
    assert noise <= ZERO_GRAD_TOL, f"{noisiest}: |grad| {noise} > {ZERO_GRAD_TOL}"
    grad_err, worst = _worst_over(grads, ref_grads, GRAD_TOL, skip=zero)
    stats = {key: b.numpy() for key, b in state.model.named_buffers()}
    stat_err, worst_stat = _worst_over(stats, ref_stats, STATS_TOL)
    print(f"against the float64 reference: loss {float(metrics['loss']):.7f} vs {ref_metrics['loss']:.7f}; "
          f"largest error / scale: gradients {grad_err:.3e} ({worst}), BN stats {stat_err:.3e} ({worst_stat}); "
          f"fc1/fc2 biases: max |grad| {noise:.3e} ({noisiest})")
