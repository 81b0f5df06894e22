"""PyTorch port, the synthetic-hard harness's three rows whose results lie
outside their bands of JAX's TPU rows (``pointnet2_cls_bga``, ``dgcnn_bga``,
``pointcnn_cls``), held to the JAX package over a whole run of the harness,
on the CPU.

Each row's configuration is built the way each harness builds it (both
``run_row``s with the trainers replaced by recorders, 600 clouds, batch 24,
150 epochs: 3750 steps), and a real ``Trainer`` of each package made from
it.  Held equal at every one of the 3750 steps:

  * the learning rate and the BN momentum the schedules give, bit for bit
    (PointCNN's recipe staircase; the samples-based schedules elsewhere);
  * the BN momentum each BatchNorm layer is fed (a JAX train-mode forward
    traced with ``jax.eval_shape`` against a port forward on one cloud at
    N=128): the schedule's value, or PointCNN's fixed 0.99;
  * the optimizer: a vector of 64 weights of spread sizes, driven by the
    same gradients (numpy, seed 7) through JAX's optax transform and through
    the port's optimizer with ``optimizer_step`` for 3750 steps (the LR
    schedule, Adam's epsilon and bias corrections, the weight decay);
    and which parameters the weight decay reaches (a zero-gradient update
    of every parameter of the full-width model: JAX's ``add_decayed_weights``
    moves every leaf, the port's Adam every parameter);
  * the resident epoch, both trainers' own ``_epoch_impl`` with the step
    stubbed by a recorder, over the first 4 epochs (the same code runs every
    epoch), on clouds whose coordinates name their cloud and point: 25
    steps an epoch, numbered on from the epoch's first, every batch 24
    clouds, every cloud once an epoch, one point subset of 128 shared by
    every cloud of an epoch (the one each side's key derivation gives), masks
    on the same view, and the keys each epoch carries; and over all 150
    epochs each point's count of epochs kept (each within 5 sigma of 75);
  * the augmentation branch each row takes (PointCNN's transform with its
    rotation and no jitter; elsewhere jitter alone), with its arguments.

Held by distribution: each dropout site's rate (the JAX sites traced,
against the port's at the same sites) and a site's draws (2^17 a side: the
kept share within 5 standard errors of ``keep``, kept values scaled by
exactly 1/keep); PointCNN's transforms (2^13 a side: the mean and standard
deviation of each of the 9 entries within 5 standard errors); the jitter's
sigma and clip (2^17 values a side).  The evaluation's subsample: the host
``EpochSampler`` (``shuffle=True``, seed 0), the harness's, gives JAX's
view of the test set bit for bit.
"""

import copy
import importlib.util
import inspect
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanobjectnn_torch.data.pipeline import EpochSampler
from scanobjectnn_torch.models import dgcnn as tdgcnn, pointcnn as tpointcnn, pointnet2 as tpointnet2
from scanobjectnn_torch.nn.layers import BatchNorm
from scanobjectnn_torch.train import synth_hard
from scanobjectnn_torch.train import trainer as torch_trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = [r for r in synth_hard.ROWS if r[2] == "float32" and r[0] in ("pointnet2_cls_bga", "dgcnn_bga", "pointcnn_cls")]
IDS = [r[0] for r in ROWS]
CLOUDS, POINTS, BATCH, EPOCHS = 600, 256, 24, 150
STEPS = CLOUDS // BATCH * EPOCHS


@pytest.fixture(scope="module")
def jax_harness():
    spec = importlib.util.spec_from_file_location("synthetic_hard_bench",
                                                  os.path.join(REPO, "scripts", "synthetic_hard_bench.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _Trainers(dict):
    """Row -> (JAX Trainer, port Trainer, fit's keys), and ``states``: a
    port state a row, made once."""

    def __init__(self, rows):
        super().__init__(rows)
        self.states = {name: port.init_state() for name, (_, port, _) in rows.items()}


@pytest.fixture(scope="module")
def trainers(jax_harness):
    """Per row: (JAX Trainer, port Trainer, the dict each harness gives
    ``fit``), each made from the config its harness's ``run_row`` builds."""
    import argparse

    import scanobjectnn_tpu.train as jax_train

    out = {}
    train, test = synth_hard.build_data(16)
    mp = pytest.MonkeyPatch()
    try:
        for row in ROWS:
            record = {}

            def recorder(side, base):
                class Recorder(base):
                    def __init__(self, cfg, *a, **kw):
                        record[side] = {"config": cfg}

                    def fit(self, data, *a, **kw):
                        record[side]["fit"] = data
                        return "state"

                    def evaluate(self, *a, **kw):
                        return {"accuracy": 0.5, "seg_accuracy": 0.5}

                return Recorder

            mp.setattr(jax_train, "Trainer", recorder("jax", jax_train.Trainer))
            mp.setattr(torch_trainer, "Trainer", recorder("port", torch_trainer.Trainer))
            args = argparse.Namespace(epochs=EPOCHS, num_point=128, pool_f32=None, device="cpu")
            jax_harness.run_row(*row, train, test, args)
            synth_hard.run_row(*row, train, test, args)
            mp.undo()
            out[row[0]] = (jax_train.Trainer(record["jax"]["config"]),
                           torch_trainer.Trainer(record["port"]["config"]), sorted(record["port"]["fit"]))
            assert sorted(record["jax"]["fit"]) == out[row[0]][2]
    finally:
        mp.undo()
    # One port model a row (its init is the slow part), copied by the tests
    # that change it.
    return _Trainers(out)


@pytest.mark.parametrize("row", ROWS, ids=IDS)
def test_schedules_equal_at_every_step(trainers, row):
    jt, pt, _ = trainers[row[0]]
    assert (jt.config.max_epoch, jt.config.batch_size, pt.config.max_epoch) == (EPOCHS, BATCH, EPOCHS)
    steps = np.arange(STEPS)
    jlr, jbn = np.asarray(jt.lr_schedule(jnp.asarray(steps))), np.asarray(jt.bn_schedule(jnp.asarray(steps)))
    plr = np.array([pt.lr_schedule(int(s)) for s in steps], np.float32)
    pbn = np.array([pt.bn_schedule(int(s)) for s in steps], np.float32)
    np.testing.assert_array_equal(plr, jlr)
    np.testing.assert_array_equal(pbn, jbn)
    # What the harness's run sees: PointCNN's staircase never reaches its
    # first decay (8000 steps), the samples-based schedules never theirs
    # (200000 samples = 8333 steps).
    np.testing.assert_array_equal(np.unique(plr), np.float32([0.01 if row[0] == "pointcnn_cls" else 1e-3]))
    np.testing.assert_array_equal(np.unique(pbn), np.float32([0.5]))


def _jax_forward_sites(jt, points) -> tuple[dict, list]:
    """A JAX train-mode forward at the schedule's step-0 momentum, traced
    with ``jax.eval_shape``: the momentum each BatchNorm is called with (by
    module path) and each dropout site's rate, in call order."""
    from scanobjectnn_tpu.models import dgcnn as jdgcnn
    from scanobjectnn_tpu.nn import layers as jlayers

    momenta, rates = {}, []

    def wrap(cls):
        original = cls.__call__
        sig = inspect.signature(original)

        def call(self, *args, **kwargs):
            bound = sig.bind(self, *args, **kwargs)
            bound.apply_defaults()
            if not bound.arguments["use_running_average"]:
                momenta[".".join(self.scope.path)] = float(bound.arguments["momentum"])
            return original(self, *args, **kwargs)

        return call

    dropout = fnn.Dropout.__call__

    def dropout_call(self, x, *a, **kw):
        rates.append(float(self.rate))
        return dropout(self, x, *a, **kw)

    key, momentum = jax.random.PRNGKey(0), float(jt.bn_schedule(0))
    with pytest.MonkeyPatch.context() as mp:
        shapes = jax.eval_shape(lambda: jt.model.init({"params": key, "dropout": key}, points, train=False))
        for cls in (jlayers.BatchNorm, jdgcnn._PairBN):
            mp.setattr(cls, "__call__", wrap(cls))
        mp.setattr(fnn.Dropout, "__call__", dropout_call)
        jax.eval_shape(lambda v: jt.model.apply(v, points, train=True, bn_momentum=momentum,
                                                rngs={"dropout": key}, mutable=["batch_stats"]), shapes)
    return momenta, rates


def _port_forward_sites(pt, model, points) -> tuple[dict, list]:
    """The port's train-mode forward at the schedule's step-0 momentum: the
    momentum each BatchNorm is fed (by module name) and each dropout's
    keep, in call order."""
    momenta, keeps = {}, []
    names = {id(m): n for n, m in model.named_modules()}
    update, dropout = BatchNorm.update_running, tpointnet2.dropout

    def update_running(self, mean, var, bn_momentum):
        momenta[names[id(self)]] = float(bn_momentum)
        return update(self, mean, var, bn_momentum)

    def recorded_dropout(h, keep, training, generator):
        keeps.append(float(keep))
        return dropout(h, keep, training, generator)

    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(BatchNorm, "update_running", update_running)
        for module in (tpointnet2, tdgcnn, tpointcnn):
            mp.setattr(module, "dropout", recorded_dropout)
        model.train()(torch.from_numpy(points), bn_momentum=pt.bn_schedule(0), generator=torch.Generator())
    return momenta, keeps


@pytest.mark.parametrize("row", ROWS, ids=IDS)
def test_bn_momentum_and_dropout_sites_equal_jaxs(trainers, row):
    jt, pt, _ = trainers[row[0]]
    points = synth_hard.build_data(256)[0]["points"][:1, :128].astype(np.float32)
    want_momenta, rates = _jax_forward_sites(jt, jnp.asarray(points))
    momenta, keeps = _port_forward_sites(pt, copy.deepcopy(trainers.states[row[0]].model), points)
    assert momenta == want_momenta and len(momenta) >= 10
    assert set(momenta.values()) == {0.99 if row[0] == "pointcnn_cls" else 0.5}
    # A rate-0 site draws nothing in either package (flax returns its input).
    assert [round(1.0 - k, 6) for k in keeps] == [round(r, 6) for r in rates if r]
    assert {"pointnet2_cls_bga": [0.5, 0.5, 0.5], "dgcnn_bga": [0.5, 0.5, 0.3],
            "pointcnn_cls": [0.8]}[row[0]] == [round(r, 6) for r in rates if r]


@pytest.mark.parametrize("keep", [0.5, 0.7, 0.2])
def test_dropout_draws_equal_jaxs_by_distribution(keep):
    n = 1 << 17
    port = tpointnet2.dropout(torch.ones(n), keep, True, torch.Generator().manual_seed(3)).numpy()
    ref = np.asarray(fnn.Dropout(rate=1.0 - keep).apply({}, jnp.ones(n), deterministic=False,
                                                        rngs={"dropout": jax.random.PRNGKey(3)}))
    se = np.sqrt(keep * (1 - keep) / n)
    for values in (port, ref):
        kept = values[values != 0]
        assert abs(len(kept) / n - keep) < 5 * se
        np.testing.assert_allclose(kept, np.float32(1.0) / np.float32(keep), rtol=1e-6)


def test_optimizer_equal_over_the_run(trainers):
    """The 64 weights through 3750 steps of each row's optimizer (module
    doc), gradients from 1e-4 to 1 so Adam's epsilon shows."""
    import optax

    rng = np.random.RandomState(7)
    w0 = rng.uniform(-1, 1, 64).astype(np.float32)
    grads = (rng.randn(STEPS, 64) * np.logspace(-4, 0, 64)).astype(np.float32)
    for name, (jt, pt, _) in trainers.items():
        def step(carry, g):
            w, opt = carry
            upd, opt = jt.tx.update(g, opt, w)
            w = optax.apply_updates(w, upd)
            return (w, opt), w

        _, want = jax.jit(lambda w: jax.lax.scan(step, (w, jt.tx.init(w)), jnp.asarray(grads)))(jnp.asarray(w0))
        weights = torch.nn.Parameter(torch.from_numpy(w0.copy()))
        opt = pt.make_optimizer([weights])
        got = np.empty_like(grads)
        for s in range(STEPS):
            weights.grad = torch.from_numpy(grads[s])
            pt.optimizer_step(opt, s)
            got[s] = weights.detach().numpy()
        # 3750 f32 updates of weights up to 1.75: rounding walks them apart by
        # about 4e-6 (read); a wrong LR or epsilon moves them by 1e-3 or more.
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5, err_msg=name)
        # The recipe's epsilon and weight decay (PointCNN), else JAX's defaults.
        eps, wd = (1e-2, 1e-5) if name == "pointcnn_cls" else (1e-8, 0.0)
        assert (opt.defaults["eps"], opt.defaults["weight_decay"]) == (eps, wd), name


@pytest.mark.parametrize("row", ROWS, ids=IDS)
def test_weight_decay_reaches_every_parameter_as_in_jax(trainers, row):
    jt, pt, _ = trainers[row[0]]
    model = copy.deepcopy(trainers.states[row[0]].model)
    params = dict(model.named_parameters())
    # The JAX tree from the port's names (convert's naming), a leaf a
    # parameter: its largest |value|, so a leaf is 0 where the parameter is.
    tree = {}
    for name, p in params.items():
        node = tree
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray([float(p.detach().abs().max())], jnp.float32)
    upd, _ = jt.tx.update(jax.tree_util.tree_map(jnp.zeros_like, tree), jt.tx.init(tree), tree)
    from scanobjectnn_torch.convert import _flatten

    moved_jax = {k for k, v in _flatten(upd) if np.any(np.asarray(v) != 0)}
    before = {k: p.detach().clone() for k, p in params.items()}
    for p in params.values():
        p.grad = torch.zeros_like(p)
    optimizer = pt.make_optimizer(model.parameters())
    pt.optimizer_step(optimizer, 0)
    moved_port = {k for k, p in params.items() if not torch.equal(p.detach(), before[k])}
    assert {id(p) for g in optimizer.param_groups for p in g["params"]} == {id(p) for p in params.values()}
    assert moved_port == moved_jax
    nonzero = {k for k, p in before.items() if torch.any(p != 0)}
    assert moved_port == (nonzero if row[0] == "pointcnn_cls" else set())


def _coded_data(keys) -> dict:
    """600 clouds of 256 points whose x is the cloud's index and y the
    point's; masks and parts the code 1000·cloud + point."""
    c, j = np.meshgrid(np.arange(CLOUDS), np.arange(POINTS), indexing="ij")
    data = {"points": np.stack([c, j, np.zeros_like(c)], -1).astype(np.float32),
            "labels": (np.arange(CLOUDS) % 6).astype(np.int32)}
    for k in keys:
        if k not in data:
            data[k] = (1000 * c + j).astype(np.int32)
    return data


def _check_epoch(batches, keys, step0) -> np.ndarray:
    """One epoch's recorded batches (each {"step", key: array}) against the
    structure (module doc); returns the epoch's kept points."""
    assert len(batches) == CLOUDS // BATCH
    assert [b["step"] for b in batches] == list(range(step0, step0 + CLOUDS // BATCH))
    clouds, perm = [], None
    for b in batches:
        assert sorted(b) == sorted(keys + ["step"])
        pts = b["points"]
        assert pts.shape == (BATCH, 128, 3)
        c = pts[:, 0, 0].astype(np.int64)
        np.testing.assert_array_equal(pts[..., 0], np.broadcast_to(c[:, None], (BATCH, 128)))
        rows = pts[..., 1].astype(np.int64)
        perm = rows[0] if perm is None else perm
        np.testing.assert_array_equal(rows, np.broadcast_to(perm, (BATCH, 128)))  # one subset, every cloud
        np.testing.assert_array_equal(b["labels"], c % 6)
        for k in ("masks", "parts"):
            if k in b:
                np.testing.assert_array_equal(b[k], 1000 * c[:, None] + perm[None])
        clouds.append(c)
    assert sorted(np.concatenate(clouds).tolist()) == list(range(CLOUDS))  # every cloud once
    assert len(set(perm.tolist())) == 128
    return perm


def _jax_epochs(jt, keys, epochs):
    data = jt.upload_dataset(_coded_data(keys))
    n = CLOUDS // BATCH
    seen_keys = []

    def stub(state, batch, rng):
        seen_keys.append(sorted(batch))
        i = state.step % n
        rec = dict(state.params)
        for k, v in batch.items():
            rec[k] = rec[k].at[i].set(v)
        return state.replace(step=state.step + 1, params=rec), {"loss": jnp.zeros((), jnp.float32)}

    view_shapes = {"points": (n, BATCH, 128, 3), "labels": (n, BATCH)}
    view_shapes.update({k: (n, BATCH, 128) for k in keys if k not in view_shapes})
    from scanobjectnn_tpu.train.trainer import TrainState

    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params={k: jnp.zeros(s, data[k].dtype) for k, s in view_shapes.items()},
                       batch_stats={}, opt_state=())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jt, "_train_step_impl", stub)
        epoch = jax.jit(jt._epoch_impl)
        out = []
        for e in range(epochs):
            state, _, nb = epoch(state, data, jax.random.PRNGKey(jt.config.seed))
            assert int(nb) == n
            rec = jax.device_get(state.params)
            out.append([{"step": e * n + i, **{k: np.asarray(v[i]) for k, v in rec.items()}} for i in range(n)])
    assert all(k == sorted(view_shapes) for k in seen_keys)
    return out


def _port_epochs(pt, keys, epochs):
    data = pt.upload_dataset(_coded_data(keys))
    state = torch_trainer.TrainState(0, None, None, None)
    batches = []

    def record(state, batch):
        batches.append({"step": state.step, **{k: v.numpy() for k, v in batch.items()}})
        state.step += 1
        return state, {"loss": torch.zeros(())}

    out = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pt, "train_step", record)
        for _ in range(epochs):
            batches.clear()
            state, _, nb = pt._epoch_impl(state, data)
            assert nb == CLOUDS // BATCH
            out.append(list(batches))
    return out


def _jax_point_subset(jt, epoch: int) -> np.ndarray:
    """The points JAX's resident epoch keeps at ``epoch``, drawn from the
    keys ``_epoch_impl`` takes (the step folded into the seed's key)."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(jt.config.seed), 0xE70C),
                             epoch * (CLOUDS // BATCH))
    return np.asarray(jax.random.permutation(jax.random.split(key)[0], POINTS)[:128])


@pytest.mark.parametrize("row", ROWS, ids=IDS)
def test_resident_epochs_equal_jaxs_structure(trainers, row):
    """The first 4 epochs (steps 0-99) through each package's own
    ``_epoch_impl``; the epoch's code is the same every epoch."""
    jt, pt, keys = trainers[row[0]]
    assert keys == sorted({"points", "labels"} | ({"masks"} if row[1] is True else set()))
    keys = [k for k in keys if k != "points"] + ["points"]
    epochs = 4
    subsets = {"jax": lambda e: _jax_point_subset(jt, e),
               "port": lambda e: pt._epoch_permutations(e * (CLOUDS // BATCH), POINTS, CLOUDS)[0].numpy()}
    for side, recorded in (("jax", _jax_epochs(jt, keys, epochs)), ("port", _port_epochs(pt, keys, epochs))):
        perms = set()
        for e, batches in enumerate(recorded):
            perm = _check_epoch(batches, keys, e * (CLOUDS // BATCH))
            np.testing.assert_array_equal(perm, subsets[side](e), err_msg=side)
            perms.add(tuple(sorted(perm.tolist())))
        assert len(perms) == epochs, side  # a fresh subset every epoch


def test_resident_point_subsets_by_distribution(trainers):
    """Each point's count of the 150 epochs that keep it, on each side
    (the subsets ``_epoch_impl`` draws, as the test above holds them):
    Binomial(150, 1/2), each within 5 sigma of 75."""
    jt, pt, _ = trainers["pointnet2_cls_bga"]
    for side, subset in (("jax", lambda e: _jax_point_subset(jt, e)),
                         ("port", lambda e: pt._epoch_permutations(e * (CLOUDS // BATCH), POINTS, CLOUDS)[0].numpy())):
        counts = np.zeros(POINTS, np.int64)
        for e in range(EPOCHS):
            counts[subset(e)] += 1
        assert counts.sum() == 128 * EPOCHS
        assert np.abs(counts - 75).max() < 5 * np.sqrt(150 * 0.25), side


@pytest.mark.parametrize("row", ROWS, ids=IDS)
def test_augmentation_branch_equals_jaxs(trainers, row):
    from scanobjectnn_tpu import augment as jaug

    jt, pt, _ = trainers[row[0]]
    calls = {"jax": [], "port": []}

    def recorder(side, name, keep_args):
        def fn(*args, **kwargs):
            calls[side].append((name, tuple(keep_args(args, kwargs))))
            return args[1] if side == "jax" else args[0]

        return fn

    pts = np.zeros((2, 8, 3), np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jaug, "pointcnn_augment", recorder("jax", "pointcnn", lambda a, k: (
            k["jitter_range"], tuple(k["rotation_range"]), tuple(k["scaling_range"]))))
        mp.setattr(jaug, "rotate_point_cloud", recorder("jax", "rotate", lambda a, k: ()))
        mp.setattr(jaug, "jitter_point_cloud", recorder("jax", "jitter", lambda a, k: ()))
        mp.setattr(torch_trainer, "pointcnn_augment", recorder("port", "pointcnn", lambda a, k: (
            a[2], tuple(a[3]), tuple(a[4]))))
        mp.setattr(torch_trainer, "rotate_point_cloud", recorder("port", "rotate", lambda a, k: ()))
        mp.setattr(torch_trainer, "jitter_point_cloud", recorder("port", "jitter", lambda a, k: ()))
        mp.setattr(torch_trainer, "standard_train_augment", recorder("port", "rotate+jitter", lambda a, k: ()))
        jt._augment(jax.random.PRNGKey(0), jnp.asarray(pts))
        pt.augment(torch.from_numpy(pts), torch.Generator().manual_seed(0))
    assert calls["port"] == calls["jax"]
    if row[0] == "pointcnn_cls":  # rotation in ±π about y, scales N(1, 0.1²) clipped, no jitter
        assert calls["jax"] == [("pointcnn", (0.0, (0.0, np.pi, 0.0, "u"), (0.1, 0.1, 0.1, "g")))]
    else:
        assert calls["jax"] == [("jitter", ())]


def test_augmentation_draws_equal_jaxs_by_distribution():
    from scanobjectnn_tpu import augment as jaug
    from scanobjectnn_torch.augment import transforms

    n = 1 << 13
    rot, scale = (0.0, np.pi, 0.0, "u"), (0.1, 0.1, 0.1, "g")
    want = np.asarray(jax.jit(lambda key: jaug.pointcnn_xforms(key, n, rot, scale)[0])(jax.random.PRNGKey(5)))
    want = want.reshape(n, 9)
    got = transforms.pointcnn_xforms(n, torch.Generator().manual_seed(5), rot, scale)[0].numpy().reshape(n, 9)
    se = np.maximum(want.std(0), 1e-3) / np.sqrt(n)
    assert np.all(np.abs(got.mean(0) - want.mean(0)) < 5 * se)
    assert np.all(np.abs(got.std(0) - want.std(0)) < 5 * se)
    assert np.abs(got).max() <= 1.3 + 1e-6 and np.abs(want).max() <= 1.3 + 1e-6  # scales clipped at 1 ± 0.3
    zeros = np.zeros((n // 32, 128, 3), np.float32)
    want = np.asarray(jaug.jitter_point_cloud(jax.random.PRNGKey(6), jnp.asarray(zeros))).ravel()
    got = transforms.jitter_point_cloud(torch.from_numpy(zeros), torch.Generator().manual_seed(6)).numpy().ravel()
    for values in (got, want):
        assert np.abs(values).max() <= 0.05 and abs(values.std() - 0.01) < 5 * 0.01 / np.sqrt(2 * values.size)


def test_evaluation_subsample_equals_jaxs():
    from scanobjectnn_tpu.data.pipeline import EpochSampler as JEpochSampler

    test = synth_hard.build_data(256)[1]
    kw = dict(masks=test["masks"], num_points=128, shuffle=True, seed=0)
    got = EpochSampler(test["points"], test["labels"], **kw).epoch()
    want = JEpochSampler(test["points"], test["labels"], **kw).epoch()
    assert got.keys() == want.keys() == {"points", "labels", "masks"}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
