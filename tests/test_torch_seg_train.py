"""PyTorch port, the BGA and part segmentation training steps on the CPU,
against the JAX package on the same batch and weights, and the data they
read (masks, parts, the hard dataset, the epoch sampler).

Set-up, as ``test_torch_train_step.py`` for SSG: B=4 clouds of N=1024
points of the synthetic dataset with background masks and part ids; the
models at their real point counts, radii and K (SA1 512/0.2/64, SA2
128/0.4/64, group-all; fp1, fp2, fp3 at levels 2, 1, 0) with every hidden
width narrowed by ``NARROW`` (a test-local subclass of the port's models;
on the JAX side the layer constructors in ``models/pointnet2.py`` are
wrapped to narrow the same widths, so the JAX models' own forward runs).
No augmentation; dropout is the identity on both sides (flax's ``Dropout``
patched, the port's ``dropout_keep`` 1.0).  Random BN running stats, so the
momentum update shows.  The inputs are pinned off the ball boundaries
instead of the bound loosened (no SA1/SA2 pair with |d2 - r²| < 1e-6).

The reference is the JAX step evaluated in float64 (``_jax_step_f64`` of
``test_torch_train_step.py``: ``jax.enable_x64``, ``dtype=float64``, and a
``jnp`` that reads ``float32`` as float64 bound into ``nn/layers.py``,
``models/losses.py`` and ``models/pointnet2.py``).  The coordinates stay
f32 on both sides.

The FP decoder's 3-NN distances are the one place where the two sides'
f32 roundings move the result past these bounds: a weight is 1/d², so the
expansion's absolute rounding (about 1e-7) is 1e-3 of a d² near 1e-4, and
at a key that equals its query (fp2 and fp3: FPS picks the coarse points
from the fine ones) XLA's d² reads up to 4.8e-7 where the port's is 0.  On
these inputs that moved the SA1 gradients by 1.3e-3 (BGA) and 3.0e-3
(partseg) of their scale, against the reference with exact (float64)
distances and with XLA's f32 ones alike.  So the reference's ``three_nn``
returns the port's distances and indices on the same FPS levels, computed
beforehand; the indices are checked equal to the JAX ``three_nn``'s, and
``test_torch_knn.py`` holds the distances, weights and interpolation to the
JAX package on their own, with the tolerance those differences imply.

Bounds, those of the SSG step (``test_torch_train_step.py``): the total, classify and seg losses to rtol
1e-5; every gradient to 1e-4 x max(1, max|ref|) per tensor, except the Dense
biases that feed a training-mode BN (every ``dense_i`` of the SA and FP
MLPs and seg_fc1, and BGA's fc1 and fc2), whose true gradient is 0: those
to |g| <= 2e-4; the BN running stats to 1e-5 x max(1, max|ref|).

One exception, BGA's gradients in f32: 1e-3 x max(1, max|ref|).  Its head
normalises fc1 over the B=4 clouds, whose outputs share a common mode:
E[x²]/var reaches 194 in a bn1 channel here, and the batch variance
E[x²] - E[x]² (the JAX package's formula) loses that factor of f32
precision; the class vector carries the error into every gradient through
the seg branch (read 3.0e-4 of the scale).  The same step with the port's
BatchNorm evaluated in float64 (``_bn_forward_f64``, patched in) is held to
the SSG step's 1e-4 (read 1.4e-5), so the rest of the step is held at that bound.
"""

import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanobjectnn_tpu.data import io as jio
from scanobjectnn_tpu.data import synthetic as jsynthetic
from scanobjectnn_tpu import ops as jops
from scanobjectnn_tpu.data.pipeline import EpochSampler as JEpochSampler
from scanobjectnn_tpu.models import losses as jlosses
from scanobjectnn_tpu.models import pointnet2 as jpointnet2
from scanobjectnn_tpu.nn import layers as jlayers
from scanobjectnn_tpu.ops import interpolate as jinterp
from scanobjectnn_torch import convert, models
from scanobjectnn_torch.data import io, synthetic
from scanobjectnn_torch.data.pipeline import Batches, EpochSampler
from scanobjectnn_torch.ops import interpolate
from scanobjectnn_torch.models import PointNet2BGA, PointNet2PartSeg
from scanobjectnn_torch.nn.layers import BatchNorm
from scanobjectnn_torch.train import trainer as trainer_module
from scanobjectnn_torch.train.trainer import Trainer, TrainerConfig

NARROW = {64: 16, 128: 24, 256: 32, 512: 40, 1024: 48}
B, N, CLASSES = 4, 1024, 3
LOSS_RTOL, GRAD_TOL, ZERO_GRAD_TOL, STATS_TOL = 1e-5, 1e-4, 2e-4, 1e-5  # module doc
BGA_F32_GRAD_TOL = 1e-3  # module doc: the head BN over 4 clouds
MOMENTUM = 0.5  # the BN schedule's first value


def _narrow(widths):
    return tuple(NARROW.get(w, w) for w in widths)


class NarrowBGA(PointNet2BGA):
    SA_CONFIGS = tuple((*c[:3], _narrow(c[3]), c[4]) for c in PointNet2BGA.SA_CONFIGS)
    FP_MLPS = tuple(_narrow(m) for m in PointNet2BGA.FP_MLPS)
    SEG_FC = NARROW[PointNet2BGA.SEG_FC]
    FC_DIMS = _narrow(PointNet2BGA.FC_DIMS)


class NarrowPartSeg(PointNet2PartSeg):
    SA_CONFIGS = NarrowBGA.SA_CONFIGS
    FP_MLPS = NarrowBGA.FP_MLPS
    SEG_FC = NarrowBGA.SEG_FC


PORT = {"pointnet2_cls_bga": NarrowBGA, "pointnet2_cls_partseg": NarrowPartSeg}


def _narrow_jax_layers(monkeypatch):
    """Wrap the layer constructors that ``models/pointnet2.py`` calls so the
    JAX BGA and partseg build with the ``NARROW`` widths."""
    sa, fp, mlp, dense = jpointnet2.SAModule, jpointnet2.FPModule, jpointnet2.MLP, jpointnet2.Dense
    monkeypatch.setattr(jpointnet2, "SAModule", lambda np_, r, ns, m, **kw: sa(np_, r, ns, _narrow(m), **kw))
    monkeypatch.setattr(jpointnet2, "FPModule", lambda m, **kw: fp(_narrow(m), **kw))
    monkeypatch.setattr(jpointnet2, "MLP", lambda m, **kw: mlp(_narrow(m), **kw))
    monkeypatch.setattr(
        jpointnet2, "Dense",
        lambda f, **kw: dense(NARROW[f] if kw.get("name") in ("fc1", "fc2") else f, **kw),
    )


def _jax_model(name, dtype=jnp.float32):
    kw = {"num_parts": CLASSES} if name.endswith("partseg") else {"num_classes": CLASSES}
    return jpointnet2.PointNet2BGA(dtype=dtype, **kw) if name.endswith("bga") else jpointnet2.PointNet2PartSeg(
        dtype=dtype, **kw
    )


class _Jnp64(types.ModuleType):
    """``jax.numpy`` with ``float32`` read as float64."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture(scope="module")
def batch():
    data, labels, masks, parts = synthetic.make_synthetic_dataset(
        num_per_class=2, num_classes=CLASSES, num_points=N, seed=19, with_mask=True, with_parts=True
    )
    pick = [0, 2, 3, 5]
    return {
        "points": data[pick], "labels": labels[pick],
        "masks": io.convert_to_binary_mask(masks[pick]).astype(np.int64), "parts": parts[pick],
    }


@pytest.fixture(scope="module")
def levels(batch):
    """The coordinates of levels 0-3 (input, SA1, SA2, group-all centroid):
    FPS of the f32 input, the same on both sides."""
    with torch.no_grad():
        return [xyz for xyz, _ in NarrowBGA(num_classes=CLASSES).eval()._trunk(torch.from_numpy(batch["points"]), 0.9)]


@pytest.fixture(scope="module")
def fp_neighbours(levels):
    """The port's (d2, idx) of fp1, fp2 and fp3 by (fine, coarse) point
    counts; the indices equal the JAX ``three_nn``'s."""
    out = {}
    for fine in (2, 1, 0):
        xyz1, xyz2 = levels[fine], levels[fine + 1]
        d, i = (a.numpy() for a in interpolate.three_nn(xyz1, xyz2))
        _, ji = jinterp.three_nn(jnp.asarray(xyz1.numpy()), jnp.asarray(xyz2.numpy()))
        np.testing.assert_array_equal(i, np.asarray(ji))
        out[(xyz1.shape[1], xyz2.shape[1])] = (d, i)
    return out


@pytest.fixture(scope="module")
def variables(batch):
    """JAX variables per model (narrow), with random BN running stats."""
    mp = pytest.MonkeyPatch()
    _narrow_jax_layers(mp)
    out = {}
    try:
        for name in PORT:
            key = jax.random.PRNGKey(0)
            v = jax.jit(lambda k, x, m=_jax_model(name): m.init({"params": k, "dropout": k}, x, train=False))(
                key, jnp.asarray(batch["points"][:, :600])
            )
            rng = np.random.RandomState(1)
            stats = jax.tree_util.tree_map_with_path(
                lambda p, a: jnp.asarray(
                    0.5 + np.abs(rng.randn(*a.shape)) if p[-1].key == "var" else 0.1 * rng.randn(*a.shape),
                    jnp.float32,
                ),
                v["batch_stats"],
            )
            out[name] = {**v, "batch_stats": stats}
    finally:
        mp.undo()
    return out


@pytest.fixture(scope="module")
def reference(batch, variables, fp_neighbours):
    """Per model: the JAX step in float64 (``_jax_step_f64``)."""
    out = {}
    for name in PORT:
        with pytest.MonkeyPatch.context() as mp:
            out[name] = _jax_step_f64(mp, name, batch, variables[name], MOMENTUM, fp_neighbours)
    return out


def _bn_forward_f64(self, x, bn_momentum=None):
    """The port's training BatchNorm evaluated in float64 (its formula and
    running-stat update), returning f32."""
    xf = x.double()
    axes = tuple(range(x.dim() - 1))
    mean = xf.mean(dim=axes)
    var = torch.clamp(torch.square(xf).mean(dim=axes) - torch.square(mean), min=0.0)
    with torch.no_grad():
        self.mean.copy_(self.mean * bn_momentum + mean.float() * (1.0 - bn_momentum))
        self.var.copy_(self.var * bn_momentum + var.float() * (1.0 - bn_momentum))
    y = (xf - mean) * torch.rsqrt(var + self.epsilon)
    return (y * self.scale.double() + self.bias.double()).float()


def _jax_step_f64(monkeypatch, name, batch, variables, momentum, fp_neighbours):
    """JAX losses, gradients and updated BN stats of one training forward,
    evaluated in float64, its ``three_nn`` giving ``fp_neighbours`` (module
    doc)."""
    _narrow_jax_layers(monkeypatch)
    monkeypatch.setattr(
        jops, "three_nn",
        lambda xyz1, xyz2: tuple(jnp.asarray(a) for a in fp_neighbours[(xyz1.shape[1], xyz2.shape[1])]),
    )
    monkeypatch.setattr(fnn, "Dropout", lambda rate, deterministic: (lambda h: h))
    for module in (jlayers, jlosses, jpointnet2):
        monkeypatch.setattr(module, "jnp", _Jnp64("jnp"))
    targets = {k: jnp.asarray(batch[k], jnp.int32) for k in ("labels", "masks", "parts")}
    with jax.enable_x64(True):
        model = _jax_model(name, jnp.float64)
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)), variables)

        def loss_fn(params):
            out, mut = model.apply(
                {"params": params, "batch_stats": v64["batch_stats"]},
                jnp.asarray(batch["points"]), train=True, bn_momentum=momentum, mutable=["batch_stats"],
            )
            loss, metrics = model.loss(out, targets)
            return loss, (metrics, mut["batch_stats"])

        (_, (metrics, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v64["params"])
        grads, stats = ({k: np.asarray(v) for k, v in convert._flatten(tree)} for tree in (grads, stats))
        metrics = {k: float(v) for k, v in metrics.items()}
    assert {v.dtype for v in (*grads.values(), *stats.values())} == {np.dtype(np.float64)}
    return metrics, grads, stats


def feeds_train_bn(param_name: str) -> bool:
    """A Dense bias followed by a training-mode BatchNorm: every MLP layer
    (``dense_i``: SA, FP, seg_fc1) and BGA's fc1 and fc2."""
    *_, layer, leaf = param_name.split(".")
    return leaf == "bias" and (layer.startswith("dense_") or layer in ("fc1", "fc2"))


def _trainer(monkeypatch, name, **kw):
    monkeypatch.setitem(models.MODEL_REGISTRY, name + "_narrow", PORT[name])
    monkeypatch.setattr(trainer_module, "standard_train_augment", lambda points, generator: points)
    return Trainer(TrainerConfig(model=name + "_narrow", num_classes=CLASSES, batch_size=B, device="cpu", **kw))


def test_inputs_are_pinned_off_ball_boundaries(levels):
    for (_, radius, *_), pts, queries in zip(NarrowBGA.SA_CONFIGS[:2], levels[:2], levels[1:3]):
        d2 = ((queries.numpy()[:, :, None, :].astype(np.float64) - pts.numpy()[:, None, :, :]) ** 2).sum(-1)
        assert np.abs(d2 - radius * radius).min() > 1e-6


@pytest.mark.parametrize(
    "name,bn", [("pointnet2_cls_bga", "f32"), ("pointnet2_cls_bga", "f64"), ("pointnet2_cls_partseg", "f32")]
)
def test_train_step_matches_jax(monkeypatch, batch, variables, reference, name, bn):
    check_train_step(monkeypatch, batch, variables, reference, name, bn)


def check_train_step(monkeypatch, batch, variables, reference, name, bn):
    """One port step of ``name`` (its BN in ``bn``: "f32", or "f64" by
    ``_bn_forward_f64``) on ``batch`` from ``variables``, against the float64
    JAX step ``reference`` (module doc's bounds)."""
    trainer = _trainer(monkeypatch, name)
    assert trainer.kind == PORT[name].kind and trainer.bn_schedule(0) == MOMENTUM
    state = trainer.init_state()
    convert.load_jax_variables(state.model, variables[name])
    state.model.dropout_keep = 1.0
    ref_metrics, ref_grads, ref_stats = reference[name]
    if bn == "f64":
        monkeypatch.setattr(BatchNorm, "forward", _bn_forward_f64)

    state, metrics = trainer.train_step(state, batch)
    assert state.step == 1
    assert sorted(ref_metrics) == sorted(k for k in metrics if k in ref_metrics)
    for key, ref in ref_metrics.items():
        err = abs(float(metrics[key]) / ref - 1)
        assert err <= LOSS_RTOL, f"{key} rel err {err}"
    target = batch["masks" if name.endswith("bga") else "parts"]
    assert int(metrics["seg_count"]) == target.size and 0 <= int(metrics["seg_correct"]) <= target.size
    assert ("correct" in metrics) == name.endswith("bga")

    def worst_over(got, want, bound, skip=()):
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

    grads = {key: p.grad.numpy() for key, p in state.model.named_parameters()}
    zero = [key for key in grads if feeds_train_bn(key)]
    assert len(zero) == (19 if name.endswith("bga") else 17), zero
    noise, noisiest = max((float(np.abs(grads[k]).max()), k) for k in zero)
    assert max(float(np.abs(ref_grads[k]).max()) for k in zero) < 1e-9
    assert noise <= ZERO_GRAD_TOL, f"{noisiest}: |grad| {noise} > {ZERO_GRAD_TOL}"
    bound = BGA_F32_GRAD_TOL if (name, bn) == ("pointnet2_cls_bga", "f32") else GRAD_TOL
    grad_err, worst = worst_over(grads, ref_grads, bound, skip=zero)
    stats = {key: b.numpy() for key, b in state.model.named_buffers()}
    stat_err, worst_stat = worst_over(stats, ref_stats, STATS_TOL)
    print(f"{name}, BN in {bn}, against the float64 reference: largest error / scale: gradients {grad_err:.3e} "
          f"({worst}), BN stats {stat_err:.3e} ({worst_stat}); the {len(zero)} Dense biases before a BN: "
          f"max |grad| {noise:.3e} ({noisiest})")


def test_train_epoch_carries_masks(monkeypatch, batch):
    trainer = _trainer(monkeypatch, "pointnet2_cls_bga")
    state = trainer.init_state(seed=2)
    sampler = EpochSampler(
        np.concatenate([batch["points"]] * 2), np.concatenate([batch["labels"]] * 2),
        masks=np.concatenate([batch["masks"]] * 2), num_points=512, seed=0,
    )
    state, summary = trainer.train_epoch(state, sampler)
    assert state.step == 2 and np.isfinite(summary["mean_loss"])
    assert 0.0 <= summary["accuracy"] <= 1.0 and 0.0 <= summary["seg_accuracy"] <= 1.0


@pytest.mark.parametrize("with_mask,with_parts", [(True, False), (False, True), (True, True)])
def test_synthetic_masks_and_parts_equal_jax(with_mask, with_parts):
    kw = dict(num_per_class=3, num_classes=5, num_points=96, seed=11, with_mask=with_mask, with_parts=with_parts)
    ours, theirs = synthetic.make_synthetic_dataset(**kw), jsynthetic.make_synthetic_dataset(**kw)
    assert len(ours) == len(theirs) == 2 + with_mask + with_parts
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    if with_mask:
        assert (ours[2] == -1).sum() == 15 * (96 // 4)


@pytest.mark.parametrize("return_parts", [False, True])
def test_hard_synthetic_dataset_equals_jax(return_parts):
    kw = dict(num_per_class=4, num_classes=5, num_points=100, clutter_frac=0.4, seed=3, return_parts=return_parts)
    ours, theirs = synthetic.make_hard_synthetic_dataset(**kw), jsynthetic.make_hard_synthetic_dataset(**kw)
    assert len(ours) == len(theirs) == 3 + return_parts
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_epoch_sampler_with_masks_and_parts_in_jax_order():
    rng = np.random.RandomState(0)
    data = rng.randn(10, 40, 3).astype(np.float32)
    labels, masks, parts = np.arange(10) % 3, rng.randint(-1, 3, (10, 40)), rng.randint(0, 4, (10, 40))
    ours = EpochSampler(data, labels, masks=masks, parts=parts, num_points=32, seed=4)
    theirs = JEpochSampler(data, labels, masks=masks, parts=parts, num_points=32, seed=4)
    for _ in range(2):
        a, b = ours.epoch(), theirs.epoch()
        assert sorted(a) == sorted(b) == ["labels", "masks", "parts", "points"]
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
        assert [x["masks"].shape for x in Batches(a, 4)] == [(4, 32)] * 2


def test_convert_to_binary_mask_equals_jax():
    masks = np.array([[-1, 0, 1, 2], [3, -1, -1, 0]])
    got = io.convert_to_binary_mask(masks)
    np.testing.assert_array_equal(got, jio.convert_to_binary_mask(masks))
    assert got.dtype == np.float64 and got.tolist() == [[0, 1, 1, 1], [1, 0, 0, 1]]
