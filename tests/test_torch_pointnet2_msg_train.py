"""PyTorch port, PointNet++ MSG training (f32), on the CPU, against the JAX
package on the same inputs and weights (numpy seeds).

``LiftedGroupMLP`` in training mode (Dense 0 per point, the gather, then
BN, relu, the remaining layers and the max-pool): the pooled output, every
parameter's gradient, the gradient of the point features and the updated
BN running stats, against the JAX module (``pool=True``) at momentum 0.5;
in MSG's row order [feats, xyz], in SSG's, without point features, and
with one layer.  Bounds: pooled and stats rtol 1e-5 / atol 1e-6; each
gradient to 1e-4 x max(1, |ref|max), that of the whole step; the Dense
biases that feed a training BN (their true gradient is 0) to |g| <= 2e-4
on both sides.

One f32 ``Trainer.train_step`` of ``pointnet2_cls_msg`` at B=4, N=1024:
the MSG pyramid at its real point counts, radii and K (512; 0.1, 0.2, 0.4;
16, 32, 128, then 128; 0.2, 0.4, 0.8; 32, 64, 128) with narrower MLPs (a
test-local subclass of the port's model; the JAX layer constructors
wrapped), so SA1's scales run ``GroupMLPPool`` over the grouped
coordinates and SA2's are lifted (48 + 3 input channels against first
layers of 16).  No augmentation; dropout the identity on both sides.  The
reference is the JAX step evaluated in float64 (``_jax_step_f64`` of
``tests/test_torch_train_step.py``: ``jax.enable_x64``, ``dtype=float64``,
and the ``float32`` that ``nn/layers.py`` and ``models/losses.py`` pin read
as float64), the coordinates staying the f32 data on both sides.  The
port's BatchNorms run in float64 (``_bn_forward_f64`` of
``tests/test_torch_seg_train.py``): the head's training BNs over B=4
clouds amplify f32 rounding.  The reference takes the port's ball groups
(``query_ball_group_plain`` in place of JAX's ``ops.query_ball_group``),
as ``test_torch_seg_train.py`` feeds it the port's FP neighbours: the JAX
lax ball query tests ``sqrt`` of the EXPANDED distance, and among the 7
million (centroid, point) pairs of six radii at B=4 some lie within 1e-6
of a radius² on every seed tried (19-29), so the two rules can pick other
points; ``test_torch_ballgroup.py`` holds the rule itself.  Bounds, those
of the SSG step:
the loss to rtol 1e-5; every gradient to 1e-4 x max(1, max|ref|) per
tensor, except the 23 Dense biases that feed a training BN, held to
|g| <= 2e-4; the BN running stats to 1e-5 x max(1, max|ref|).  The batch
is made from seed 19.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanobjectnn_tpu import ops as jops
from scanobjectnn_tpu.models import losses as jlosses
from scanobjectnn_tpu.models import pointnet2 as jpointnet2
from scanobjectnn_tpu.nn import layers as jlayers
from scanobjectnn_tpu.nn.pointnet_modules import LiftedGroupMLP as JLiftedGroupMLP
from scanobjectnn_torch import convert, models
from scanobjectnn_torch.data.synthetic import make_synthetic_dataset
from scanobjectnn_torch.models import PointNet2ClsMSG
from scanobjectnn_torch.nn.layers import BatchNorm
from scanobjectnn_torch.nn.pointnet_modules import LiftedGroupMLP
from scanobjectnn_torch.ops.cuda.ballgroup_kernel import query_ball_group_plain
from scanobjectnn_torch.train import trainer as trainer_module
from scanobjectnn_torch.train.trainer import Trainer, TrainerConfig
from tests.test_torch_seg_train import _bn_forward_f64
from tests.test_torch_train_step import _Jnp64, feeds_train_bn

B, N, CLASSES, SEED = 4, 1024, 4, 19
LOSS_RTOL, GRAD_TOL, ZERO_GRAD_TOL, STATS_TOL = 1e-5, 1e-4, 2e-4, 1e-5  # module doc
NARROW = {  # full width -> test width, per MLP layer
    (32, 32, 64): (8, 8, 16), (64, 64, 128): (8, 8, 16), (64, 96, 128): (8, 12, 16),
    (128, 128, 256): (16, 16, 32), (256, 512, 1024): (32, 32, 64),
}
NARROW_SA2 = ((16, 16, 32),) * 3


def _narrow_msg(mlps, layer):
    return NARROW_SA2 if layer == 2 else tuple(NARROW[tuple(m)] for m in mlps)


class NarrowMSG(PointNet2ClsMSG):
    MSG_CONFIGS = tuple((*c[:3], _narrow_msg(c[3], i + 1)) for i, c in enumerate(PointNet2ClsMSG.MSG_CONFIGS))
    GROUP_ALL_MLP = NARROW[PointNet2ClsMSG.GROUP_ALL_MLP]


def _narrow_jax_layers(monkeypatch):
    """Wrap the layer constructors that the JAX ``PointNet2ClsMSG`` calls so
    it builds with the narrow widths."""
    msg, sa = jpointnet2.SAModuleMSG, jpointnet2.SAModule
    monkeypatch.setattr(
        jpointnet2, "SAModuleMSG",
        lambda np_, r, ns, mlps, name, **kw: msg(np_, r, ns, _narrow_msg(mlps, int(name[2:])), name=name, **kw),
    )
    monkeypatch.setattr(jpointnet2, "SAModule", lambda np_, r, ns, m, **kw: sa(np_, r, ns, NARROW[tuple(m)], **kw))


# name: (point feature channels, mlp, xyz_first)
LIFTED_CASES = {
    "msg_order": (12, (8, 16, 24), False),
    "ssg_order": (12, (8, 16, 24), True),
    "no_point_features": (0, (8, 16), False),
    "one_layer": (12, (16,), False),
}


@pytest.mark.parametrize("case", sorted(LIFTED_CASES))
def test_lifted_group_mlp_train_matches_jax(case):
    c, feats, xyz_first = LIFTED_CASES[case]
    rng = np.random.RandomState(len(case))
    b, n, m, k, momentum = 2, 64, 16, 8, 0.5
    xyz = (rng.randn(b, n, 3) * 0.5 + 0.3).astype(np.float32)
    pts = rng.randn(b, n, c).astype(np.float32) if c else None
    query = xyz[:, :m] + (0.05 * rng.randn(b, m, 3)).astype(np.float32)
    idx = rng.randint(0, n, (b, m, k)).astype(np.int32)
    idx[:, :, 1] = idx[:, :, 0]  # duplicated slots, as ball-query padding makes them: exact max ties
    cot = rng.randn(b, m, feats[-1]).astype(np.float32)

    jm = JLiftedGroupMLP(feats, xyz_first=xyz_first, pool=True)
    jargs = (None if pts is None else jnp.asarray(pts), jnp.asarray(xyz), jnp.asarray(query), jnp.asarray(idx))
    v = jm.init(jax.random.PRNGKey(0), *jargs, train=False)
    v = {**v, "batch_stats": jax.tree_util.tree_map(
        lambda a: jnp.asarray(0.5 + np.abs(rng.randn(*a.shape)), jnp.float32), v["batch_stats"])}

    def f(params, p):
        y, mut = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, p, *jargs[1:], train=True,
                          bn_momentum=momentum, mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, mut["batch_stats"])

    argnums = (0, 1) if c else 0
    grads, (ref, ref_stats) = jax.grad(f, argnums=argnums, has_aux=True)(v["params"], jargs[0])
    gp, gx = grads if c else (grads, None)

    tm = convert.load_jax_variables(LiftedGroupMLP(c + 3, feats, xyz_first=xyz_first), v).train()
    tp = None if pts is None else torch.from_numpy(pts).requires_grad_()
    out = tm(tp, torch.from_numpy(xyz), torch.from_numpy(query), torch.from_numpy(idx), momentum)
    (out * torch.from_numpy(cot)).sum().backward()

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    want = dict(convert._flatten(gp))
    if c:
        want["points"] = np.asarray(gx)
    got = {name: p.grad.numpy() for name, p in tm.named_parameters()}
    if c:
        got["points"] = tp.grad.numpy()
    assert sorted(got) == sorted(want)
    for name, ref_g in want.items():
        ref_g, g = np.asarray(ref_g), got[name]
        if name.endswith("bias") and name.startswith("dense_"):  # feeds a training BN: 0
            assert np.abs(g).max() <= ZERO_GRAD_TOL and np.abs(ref_g).max() <= ZERO_GRAD_TOL, name
            continue
        scale = max(1.0, float(np.abs(ref_g).max()))
        assert np.abs(g - ref_g).max() <= GRAD_TOL * scale, name
    for name, ref_s in convert._flatten(ref_stats):
        np.testing.assert_allclose(dict(tm.named_buffers())[name].numpy(), np.asarray(ref_s), rtol=1e-5, atol=1e-6)


def test_lifted_group_mlp_is_f32_only():
    # No longer f32 only: in bf16 Dense 0 multiplies the xyz rows in f32 and
    # keeps its output f32 (JAX Dense.highest_cols), and the layer rounds
    # after the cancellation (tests/test_torch_satrain.py holds it to JAX).
    tm = LiftedGroupMLP(15, (8,), dtype=torch.bfloat16).train()
    assert tm.dense_0.highest_cols == (12, 15)
    out = tm(torch.zeros(1, 4, 12), torch.zeros(1, 4, 3), torch.zeros(1, 2, 3), torch.zeros(1, 2, 2, dtype=torch.int32),
             0.5)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 2, 8)


@pytest.fixture(scope="module")
def batch():
    data, labels = make_synthetic_dataset(num_per_class=1, num_classes=CLASSES, num_points=N, seed=SEED)
    return {"points": data, "labels": labels}


@pytest.fixture(scope="module")
def variables():
    """The narrow JAX model's variable tree (``jax.eval_shape`` of its init,
    which compiles nothing), filled with the port's seeded reference init
    by name, and random BN running stats."""
    with pytest.MonkeyPatch.context() as mp:
        _narrow_jax_layers(mp)
        model = jpointnet2.PointNet2ClsMSG(num_classes=CLASSES)
        key = jax.random.PRNGKey(0)
        tree = jax.eval_shape(lambda: model.init({"params": key, "dropout": key}, jnp.zeros((B, 128, 3)), train=False))
    port = NarrowMSG(num_classes=CLASSES).state_dict()
    port_init = convert.init_params(NarrowMSG(num_classes=CLASSES), torch.Generator().manual_seed(0)).state_dict()
    assert sorted(port) == sorted(port_init)
    rng = np.random.RandomState(1)

    def fill(path, leaf):
        name = ".".join(p.key for p in path[1:])
        value = port_init[name].numpy()
        assert value.shape == leaf.shape, name
        if path[0].key == "batch_stats":
            value = 0.5 + np.abs(rng.randn(*leaf.shape)) if name.endswith("var") else 0.1 * rng.randn(*leaf.shape)
        return jnp.asarray(value, jnp.float32)

    return jax.tree_util.tree_map_with_path(fill, dict(tree))


def _jax_step_f64(monkeypatch, batch, variables, momentum):
    """JAX loss, gradients and updated BN stats of one training forward of
    the narrow MSG, evaluated in float64, on the port's ball groups (module
    doc)."""

    def port_ball_group(radius, nsample, xyz, new_xyz):
        xyz, new_xyz = (torch.from_numpy(np.array(a, np.float32)) for a in (xyz, new_xyz))
        return tuple(jnp.asarray(t.numpy()) for t in query_ball_group_plain(radius, nsample, xyz, new_xyz))

    _narrow_jax_layers(monkeypatch)
    monkeypatch.setattr(jops, "query_ball_group", port_ball_group)
    monkeypatch.setattr(fnn, "Dropout", lambda rate, deterministic: (lambda h: h))
    for module in (jlayers, jlosses):
        monkeypatch.setattr(module, "jnp", _Jnp64("jnp"))
    with jax.enable_x64(True):
        model = jpointnet2.PointNet2ClsMSG(num_classes=CLASSES, dtype=jnp.float64)
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)), variables)

        def loss_fn(params):
            out, mut = model.apply(
                {"params": params, "batch_stats": v64["batch_stats"]},
                jnp.asarray(batch["points"]), train=True, bn_momentum=momentum, mutable=["batch_stats"],
            )
            loss, _ = model.loss(out, {"labels": jnp.asarray(batch["labels"], jnp.int32)})
            return loss, mut["batch_stats"]

        (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(v64["params"])
        grads, stats = ({k: np.asarray(v) for k, v in convert._flatten(tree)} for tree in (grads, stats))
    assert {v.dtype for v in (*grads.values(), *stats.values())} == {np.dtype(np.float64)}
    return float(loss), grads, stats


def test_train_step_matches_jax_f64(monkeypatch, batch, variables):
    monkeypatch.setitem(models.MODEL_REGISTRY, "msg_narrow", NarrowMSG)
    monkeypatch.setattr(trainer_module, "standard_train_augment", lambda points, generator: points)
    monkeypatch.setattr(BatchNorm, "forward", _bn_forward_f64)
    trainer = Trainer(TrainerConfig(model="msg_narrow", num_classes=CLASSES, batch_size=B, device="cpu"))
    state = trainer.init_state()
    convert.load_jax_variables(state.model, variables)
    state.model.head.dropout_keep = 1.0
    momentum = trainer.bn_schedule(0)
    ref_loss, ref_grads, ref_stats = _jax_step_f64(monkeypatch, batch, variables, momentum)

    state, metrics = trainer.train_step(state, batch)
    loss_err = abs(float(metrics["loss"]) / ref_loss - 1)
    assert loss_err <= LOSS_RTOL, f"loss rel err {loss_err}"
    grads = {name: p.grad.numpy() for name, p in state.model.named_parameters()}
    assert sorted(grads) == sorted(ref_grads)
    zero = [name for name in grads if feeds_train_bn(name)]
    assert len(zero) == 23, zero
    assert max(float(np.abs(ref_grads[n]).max()) for n in zero) < 1e-9
    noise = max(float(np.abs(grads[n]).max()) for n in zero)
    assert noise <= ZERO_GRAD_TOL, noise
    readings = []
    for name, ref in ref_grads.items():
        if name in zero:
            continue
        scale = max(1.0, float(np.abs(ref).max()))
        err = float(np.abs(grads[name] - ref).max())
        assert err <= GRAD_TOL * scale, f"{name}: {err} > {GRAD_TOL * scale}"
        readings.append((err / scale, name))
    stats = {name: b.numpy() for name, b in state.model.named_buffers()}
    for name, ref in ref_stats.items():
        err, scale = float(np.abs(stats[name] - ref).max()), max(1.0, float(np.abs(ref).max()))
        assert err <= STATS_TOL * scale, f"{name}: {err}"
    print(f"MSG step against the float64 reference: loss rel err {loss_err:.3e}; largest gradient error / scale "
          f"{max(readings)}; the 23 Dense biases before a BN: max |grad| {noise:.3e}")
