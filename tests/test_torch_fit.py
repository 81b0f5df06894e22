"""PyTorch port, the training loop: ``TrainerConfig``'s fields, the
optimizer and loss flags, the augmentation flags, ``utils/logging.py``,
``Trainer.fit`` and its checkpoints, ``fused_sa_eval`` and the
``ops_backend`` switch, on the CPU, against the JAX package.

``fit``'s control flow is held line for line against JAX ``Trainer.fit``
on scripted epochs: both trainers' ``train_epoch``, ``evaluate``,
``upload_dataset``, ``train_epoch_device``, ``evaluate_device``,
``init_state``, ``save``, ``restore`` and ``snapshot_sources`` are stubs
(``monkeypatch`` on each trainer object), while ``param_count``, the
sidecars and the ``Logger`` are real.  Each case runs with
``device_resident=False`` on both sides (the ``EpochSampler`` and
``evaluate``), and with ``device_resident=True`` on dense data (the
uploads, ``train_epoch_device`` and ``evaluate_device``) and on ragged
clouds (the host path again).  Equal: the log lines with the seconds
masked (the port adds one line, the kernel backend, which the test takes
out and checks), the ``metrics.jsonl`` records with ``time`` and
``eval_seconds`` masked, the sequence of ``save(best, meta)`` calls, the
uploads, the evaluations' arguments, the labels of each epoch the sampler
drew and the uploads each resident epoch took.

The momentum optimizer is held to ``optax.sgd`` behind
``add_decayed_weights`` (the JAX ``Trainer``'s ``tx``) over three steps to
1e-6 of each parameter's scale.  ``fused_sa_eval="off"`` SSG logits are
held to the JAX model under kernelconfig ``fused_sa_eval="off"`` at
``tests/test_torch_pointnet2_ssg.py``'s tolerance (rtol 2e-4, atol 2e-5 x
max(1, |ref|max)) on its pinned clouds.  A checkpoint must restore the
model, its buffers, the optimizer's moments, the step and the generator
bit for bit, and one step from the restored state must equal one from the
saved state.  The JAX process-global kernelconfig is restored after every
test that builds a JAX ``Trainer``.
"""

import dataclasses
import json
import os
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from scanobjectnn_tpu import kernelconfig
from scanobjectnn_tpu import models as jzoo
from scanobjectnn_tpu.parallel import mesh as mesh_lib
from scanobjectnn_tpu.train import trainer as jtrainer
from scanobjectnn_tpu.utils import logging as jlogging
from scanobjectnn_torch.augment import transforms
from scanobjectnn_torch.convert import load_jax_variables
from scanobjectnn_torch.data.synthetic import make_synthetic_dataset
from scanobjectnn_torch.nn import pointnet_modules
from scanobjectnn_torch.ops import cuda as cuda_ops
from scanobjectnn_torch.ops.cuda import gather_kernel
from scanobjectnn_torch.train import trainer as ttrainer
from scanobjectnn_torch.train.trainer import Trainer, TrainerConfig
from scanobjectnn_torch.utils import logging as tlogging

SSG_RTOL, SSG_ATOL = 2e-4, 2e-5  # x max(1, |ref|max): tests/test_torch_pointnet2_ssg.py
MOMENTUM_TOL = 1e-6  # x each parameter's scale
STEPS_AN_EPOCH = 4


@pytest.fixture(autouse=True)
def _restore_kernelconfig(monkeypatch):
    """A JAX ``Trainer`` writes the process-global kernelconfig."""
    monkeypatch.setattr(kernelconfig, "_active", kernelconfig.active())


def _one_device_trainer(cfg):
    return jtrainer.Trainer(cfg, mesh=mesh_lib.make_mesh(jax.devices()[:1]))


def test_config_fields_are_jaxs_plus_device():
    jax_fields = dataclasses.fields(jtrainer.TrainerConfig)
    fields = dataclasses.fields(TrainerConfig)
    assert [f.name for f in fields] == [f.name for f in jax_fields] + ["device"]
    jcfg, cfg = jtrainer.TrainerConfig(), TrainerConfig()
    for f in jax_fields:
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.device_resident is True
    assert cfg.device == "cuda"


# ---------------------------------------------------------------- fit's flow

EPOCHS = {
    # name: (model, eval results by epoch, max_epoch, checkpoint_every, resume sidecars)
    "tie": ("pointnet2_cls_ssg", [0.5, 0.5, 0.25], 3, 1, None),
    "drop": ("pointnet2_cls_ssg", [0.25, 0.75, 0.5], 3, 2, None),
    "seg_only": ("pointnet2_cls_partseg", [0.4, 0.6, 0.6], 3, 1, None),
    "resume": ("pointnet2_cls_ssg", [0.5, 0.25, 0.75], 5, 1,
               {"best.json": {"step": 8, "accuracy": 0.6, "avg_class_accuracy": 0.55},
                "last.json": {"step": 8, "epoch": 1}}),
    "no_test_data": ("pointnet2_cls_ssg", None, 2, 1, None),
}


def _scripted_eval(epoch: int, acc: float, seg_only: bool) -> dict:
    out = {"total_seen": 8, "mean_loss": 1.0 / (epoch + 2)}
    if seg_only:
        out.update(seg_accuracy=acc, per_part_accuracy=np.array([acc, -1.0]), avg_part_accuracy=acc)
    else:
        out.update(accuracy=acc, avg_class_accuracy=acc - 0.05, per_class_accuracy=np.array([acc, np.nan]),
                   predictions=np.zeros(8, np.int64), labels=np.zeros(8, np.int64))
    return out


def _stub_fit(trainer, is_jax: bool, accs, seg_only: bool, monkeypatch) -> dict:
    """Stubs on ``trainer`` (module doc); returns the record of calls."""
    rec = {"save": [], "evaluate": [], "epoch_labels": [], "snapshots": 0, "restores": 0, "uploads": [],
           "evaluate_device": [], "device_epochs": []}
    epoch_of = {"n": 0}

    def state_at(step):
        if is_jax:
            return types.SimpleNamespace(step=step, params={"w": np.zeros((3, 4)), "b": np.zeros(3)})
        return types.SimpleNamespace(step=step, model=torch.nn.Linear(4, 3))

    def summary_of_epoch(state):
        n = epoch_of["n"]
        epoch_of["n"] += 1
        summary = {"mean_loss": 2.0 / (n + 1), "accuracy": 0.125 * (n + 1)}
        if seg_only:
            summary = {"mean_loss": 2.0 / (n + 1), "seg_accuracy": 0.25 + 0.0625 * n}
        return state_at(state.step + STEPS_AN_EPOCH), summary

    def train_epoch(state, sampler, *rng):
        rec["epoch_labels"].append(sampler.epoch()["labels"].tolist())
        return summary_of_epoch(state)

    def train_epoch_device(state, device_data, *rng):
        rec["device_epochs"].append(device_data["upload"])
        return summary_of_epoch(state)

    def scripted():
        n = len(rec["evaluate"]) + len(rec["evaluate_device"])
        return _scripted_eval(n, accs[n - 1], seg_only)

    def evaluate(state, points, labels, masks=None, parts=None, num_votes=1, **kw):
        rec["evaluate"].append((state.step, len(points), masks is None, parts is None, num_votes, kw))
        return scripted()

    def upload_dataset(data):
        rec["uploads"].append((sorted(k for k, v in data.items() if v is not None), len(data["labels"])))
        return {"upload": len(rec["uploads"]) - 1}

    def evaluate_device(state, device_data, num_votes=1, **kw):
        rec["evaluate_device"].append((state.step, device_data["upload"], num_votes, kw))
        return scripted()

    def save(state, best=False, meta=None):
        rec["save"].append((state.step, best, meta))

    def restore(template, best=False):
        rec["restores"] += 1
        return state_at(8)

    def snapshot_sources():
        rec["snapshots"] += 1

    for name, fn in (("train_epoch", train_epoch), ("evaluate", evaluate), ("save", save), ("restore", restore),
                     ("snapshot_sources", snapshot_sources), ("upload_dataset", upload_dataset),
                     ("train_epoch_device", train_epoch_device), ("evaluate_device", evaluate_device)):
        monkeypatch.setattr(trainer, name, fn)
    monkeypatch.setattr(trainer, "init_state", lambda *seed: state_at(0))
    return rec


def _masked_log(log_dir):
    with open(os.path.join(log_dir, "log_train.txt")) as f:
        return [re.sub(r"\(\d+\.\ds\)$", "(Xs)", line) for line in f.read().splitlines()]


def _masked_metrics(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    for r in records:
        assert r.pop("time") > 0
        r.pop("eval_seconds", None)
    return records


# (case, data): the host path ("host", device_resident False on both sides;
# its id is the case's), and device_resident True on dense and ragged data.
FLOWS = [(case, data) for case in sorted(EPOCHS) for data in ("host", "resident", "resident_ragged")]


def _ragged(points):
    """The clouds cut to sizes of their own (an object array)."""
    clouds = np.empty(len(points), dtype=object)
    for i, pc in enumerate(points):
        clouds[i] = pc[: 70 + i % 11]
    return clouds


@pytest.mark.parametrize("case,data", FLOWS, ids=[c if d == "host" else f"{c}-{d}" for c, d in FLOWS])
def test_fit_flow_matches_jax(case, data, tmp_path, monkeypatch):
    model, accs, max_epoch, every, sidecars = EPOCHS[case]
    seg_only = model.endswith("partseg")
    rng = np.random.RandomState(5)
    train = {"points": rng.randn(12, 80, 3).astype(np.float32), "labels": rng.randint(0, 3, 12)}
    if seg_only:
        train["parts"] = rng.randint(0, 2, (12, 80))
    if data == "resident_ragged":
        train["points"] = _ragged(train["points"])
        if seg_only:
            train["parts"] = [p[:len(c)] for p, c in zip(train["parts"], train["points"])]
    test = None if accs is None else {k: v[:8] for k, v in train.items()}
    records = {}
    for side in ("jax", "port"):
        log_dir = str(tmp_path / side)
        kw = dict(model=model, num_point=64, batch_size=4, max_epoch=max_epoch, checkpoint_every=every,
                  log_dir=log_dir, seed=3, device_resident=data != "host")
        if sidecars:
            os.makedirs(log_dir)
            for name, content in sidecars.items():
                with open(os.path.join(log_dir, name), "w") as f:
                    json.dump(content, f)
        if side == "jax":
            trainer = _one_device_trainer(jtrainer.TrainerConfig(**kw))
        else:
            trainer = Trainer(TrainerConfig(device="cpu", **kw))
        rec = _stub_fit(trainer, side == "jax", accs, seg_only, monkeypatch)
        final = trainer.fit(train, test, num_votes=2, resume=sidecars is not None)
        rec["final_step"] = final.step
        rec["log"], rec["metrics"] = _masked_log(log_dir), _masked_metrics(log_dir)
        records[side] = rec
    jax_rec, rec = records["jax"], records["port"]
    backend = rec["log"].pop(1)
    assert backend == "ops_backend=auto device=cpu (the plain versions)"
    assert rec["log"] == jax_rec["log"]
    assert rec["metrics"] == jax_rec["metrics"]
    for key in ("save", "evaluate", "epoch_labels", "snapshots", "restores", "final_step", "uploads",
                "evaluate_device", "device_epochs"):
        assert rec[key] == jax_rec[key], key
    resident = data == "resident"
    assert bool(rec["uploads"]) == resident and bool(rec["device_epochs"]) == resident
    assert bool(rec["epoch_labels"]) != resident
    if accs is not None:
        assert bool(rec["evaluate_device"]) == resident and bool(rec["evaluate"]) != resident
    first = 2 if sidecars else 0
    assert [r["epoch"] for r in rec["metrics"]] == list(range(first, max_epoch))
    assert rec["log"][0] == "model=" + model + " params=15 devices=1"


# ------------------------------------------------------------- checkpoints


def _ssg_trainer(tmp_path, **kw):
    return Trainer(TrainerConfig(num_classes=4, num_point=1024, batch_size=2, log_dir=str(tmp_path / "log"),
                                 device="cpu", **kw))


def _batch(seed):
    data, labels = make_synthetic_dataset(num_per_class=1, num_classes=4, num_points=1024, seed=seed)
    return {"points": data[seed % 2::2], "labels": labels[seed % 2::2]}


def _assert_same_state(a, b):
    assert a.step == b.step
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    assert oa["state"].keys() == ob["state"].keys()
    for i in oa["state"]:
        for k, v in oa["state"][i].items():
            assert torch.equal(v, ob["state"][i][k]) and v.device == ob["state"][i][k].device, (i, k)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.mark.parametrize("optimizer", ["adam", "momentum"])
def test_checkpoint_restores_state_bit_for_bit(tmp_path, optimizer):
    trainer = _ssg_trainer(tmp_path, optimizer=optimizer)
    assert trainer.restore(trainer.init_state()) is None  # no checkpoint yet
    state = trainer.init_state()
    for seed in (0, 1):
        state, _ = trainer.train_step(state, _batch(seed))
    trainer.save(state, meta={"epoch": 0})
    with open(tmp_path / "log" / "last.json") as f:
        assert json.load(f) == {"step": 2, "epoch": 0}
    with open(tmp_path / "log" / "config.json") as f:
        assert json.load(f)["optimizer"] == optimizer
    restored = trainer.restore(trainer.init_state(seed=7))
    _assert_same_state(state, restored)
    # One more step from each: the same loss, parameters and state.
    state, m1 = trainer.train_step(state, _batch(2))
    restored, m2 = trainer.train_step(restored, _batch(2))
    assert torch.equal(m1["loss"], m2["loss"])
    _assert_same_state(state, restored)


def test_restore_keeps_the_template_generator_across_device_types(tmp_path):
    trainer = _ssg_trainer(tmp_path)
    state, _ = trainer.train_step(trainer.init_state(), _batch(0))
    trainer.save(state, best=True, meta={"accuracy": 0.5})
    path = tmp_path / "log" / "checkpoint_best" / ttrainer.CHECKPOINT_FILE
    ckpt = torch.load(path, weights_only=True)
    ckpt["generator_device"] = "cuda"
    torch.save(ckpt, path)
    template = trainer.init_state(seed=7)
    seeded = template.generator.get_state()
    restored = trainer.restore(template, best=True)
    assert torch.equal(restored.generator.get_state(), seeded)
    assert all(torch.equal(a, b) for a, b in zip(restored.model.parameters(), state.model.parameters()))
    with open(tmp_path / "log" / "log_train.txt") as f:
        assert "generator state does not apply" in f.read()


# ------------------------------------------------------ optimizer and flags


@pytest.mark.parametrize("weight_decay", [0.0, 1e-3])
def test_momentum_steps_match_optax(weight_decay):
    kw = dict(optimizer="momentum", momentum=0.8, learning_rate=0.05, batch_size=16, decay_step=16,
              weight_decay=weight_decay)
    jtx = _one_device_trainer(jtrainer.TrainerConfig(**kw)).tx
    trainer = Trainer(TrainerConfig(device="cpu", **kw))
    rng = np.random.RandomState(2)
    shapes = {"kernel": (5, 3), "bias": (3,)}
    jparams = {k: jnp.asarray(rng.randn(*s).astype(np.float32)) for k, s in shapes.items()}
    params = {k: torch.nn.Parameter(torch.from_numpy(np.asarray(v).copy())) for k, v in jparams.items()}
    opt = trainer.make_optimizer(list(params.values()))
    assert isinstance(opt, torch.optim.SGD)
    jstate = jtx.init(jparams)
    for step in range(3):
        grads = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
        updates, jstate = jtx.update({k: jnp.asarray(g) for k, g in grads.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in params.items():
            p.grad = torch.from_numpy(grads[k])
        trainer.optimizer_step(opt, step)
        for k, p in params.items():
            ref = np.asarray(jparams[k])
            assert np.abs(p.detach().numpy() - ref).max() <= MOMENTUM_TOL * np.abs(ref).max(), (step, k)


def test_trainer_refuses_what_it_does_not_run():
    for kw, match in (({"optimizer": "rmsprop"}, "unknown optimizer 'rmsprop'"),
                      ({"fused_sa_eval": "interpret"}, "not ported"),
                      ({"ops_backend": "triton"}, "ops_backend"),
                      ({"sa_bucket": "896,64,128"}, "sa_bucket")):
        with pytest.raises(ValueError, match=match):
            Trainer(TrainerConfig(device="cpu", **kw))


@pytest.mark.parametrize("model", ["pointnet2_cls_ssg", "pointnet2_cls_bga", "pointcnn_cls"])
def test_loss_flags_bind_as_jaxs(model):
    kw = dict(model=model, seg_weight=0.3, reg_weight=0.2)
    jloss = _one_device_trainer(jtrainer.TrainerConfig(**kw))._loss_fn
    loss = Trainer(TrainerConfig(device="cpu", **kw)).loss_fn
    assert getattr(loss, "keywords", {}) == getattr(jloss, "keywords", {})


def test_model_kwargs_override_the_registry_defaults():
    cfg = TrainerConfig(num_classes=4, model_kwargs={"num_classes": 7}, device="cpu")
    state = Trainer(cfg).init_state()
    with torch.no_grad():
        out = state.model.eval()(torch.from_numpy(np.random.RandomState(0).randn(1, 1024, 3).astype(np.float32)))
    assert out["logits"].shape == (1, 7)


@pytest.mark.parametrize("model", ["pointnet2_cls_ssg", "pointnet2_cls_bga", "dgcnn"])
def test_param_count_equals_jaxs(model):
    jmodel = jzoo.get_model(model, num_classes=15)[0]
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jmodel.init({"params": key, "dropout": key}, jnp.zeros((2, 1024, 3)),
                                                train=False))
    want = sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(shapes["params"]))
    trainer = Trainer(TrainerConfig(model=model, device="cpu"))
    assert trainer.param_count(trainer.init_state()) == want


@pytest.mark.parametrize("rotate,jitter", [(True, True), (True, False), (False, True), (False, False)])
def test_augment_flags(rotate, jitter):
    x = torch.from_numpy(np.random.RandomState(4).randn(3, 64, 3).astype(np.float32))
    standard = Trainer(TrainerConfig(augment_rotate=rotate, augment_jitter=jitter, device="cpu"))
    got = standard.augment(x, torch.Generator().manual_seed(9))
    g = torch.Generator().manual_seed(9)
    want = {(True, True): lambda: transforms.standard_train_augment(x, g),  # today's draws
            (True, False): lambda: transforms.rotate_point_cloud(x, g),
            (False, True): lambda: transforms.jitter_point_cloud(x, g),
            (False, False): lambda: x}[(rotate, jitter)]()
    assert torch.equal(got, want)
    pointcnn = Trainer(TrainerConfig(model="pointcnn_cls", augment_rotate=rotate, augment_jitter=jitter,
                                     device="cpu"))
    moved = not torch.equal(pointcnn.augment(x, torch.Generator().manual_seed(9)), x)
    assert moved == (rotate or jitter)


# --------------------------------------------------------------- the logger


def test_logger_files_equal_jaxs(tmp_path, capsys):
    files = {}
    for name, module in (("jax", jlogging), ("port", tlogging)):
        log_dir = str(tmp_path / name)
        logger = module.Logger(log_dir)
        logger.log("model=x params=1,234 devices=1")
        logger.scalars(7, epoch=0, train_mean_loss=np.float32(0.25), eval_accuracy=1)
        logger.log("  eval accuracy=0.5000")
        logger.scalars(8, epoch=1)
        logger.close()
        module.Logger(None).log("stderr only")
        with open(os.path.join(log_dir, "log_train.txt"), "rb") as f:
            text = f.read()
        files[name] = (text, _masked_metrics(log_dir), sorted(os.listdir(log_dir)))
    assert files["port"] == files["jax"]
    assert capsys.readouterr().err.count("stderr only") == 2


# ------------------------------------------------------- eval and kernel switch


def test_fused_sa_eval_off_matches_jax(monkeypatch):
    data, _ = make_synthetic_dataset(num_per_class=1, num_classes=2, num_points=1024, seed=3)
    points = data.astype(np.float32)  # pinned off the ball boundaries (test_torch_pointnet2_ssg.py)
    jmodel = jzoo.get_model("pointnet2_cls_ssg")[0]
    key = jax.random.PRNGKey(0)
    init = jax.jit(lambda k, x: jmodel.init({"params": k, "dropout": k}, x, train=False))  # eager: 4x slower
    variables = init(key, jnp.asarray(points[:, :128]))
    rng = np.random.RandomState(1)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(0.1 + 0.1 * np.abs(rng.randn(*a.shape)) if p[-1].key == "var"
                                 else 0.05 * np.abs(rng.randn(*a.shape)), jnp.float32),
        variables["batch_stats"],
    )
    variables = {**variables, "batch_stats": stats}
    monkeypatch.delenv("SCANOBJECTNN_FUSED_SA_EVAL", raising=False)
    kernelconfig.set_kernel_config(fused_sa_eval="off")
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(points), train=False)["logits"], np.float32)

    state = Trainer(TrainerConfig(fused_sa_eval="off", device="cpu")).init_state()
    load_jax_variables(state.model, variables)

    def fused(*args, **kw):
        raise AssertionError("an eval SA layer took the fused branch under fused_sa_eval='off'")

    monkeypatch.setattr(pointnet_modules, "_fused_ball_scale", fused)
    with torch.no_grad():
        got = state.model.eval()(torch.from_numpy(points))["logits"].numpy()
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=SSG_RTOL, atol=SSG_ATOL * scale)
    np.testing.assert_array_equal(got.argmax(1), ref.argmax(1))
    with pytest.raises(ValueError, match="fused_sa_eval"):
        pointnet_modules.configure_eval(state.model, "auto", "interpret")


@pytest.mark.parametrize("backend", ["auto", "pallas", "lax"])
def test_ops_backend_switch_is_on_only_inside_a_lax_trainers_steps(backend, monkeypatch):
    trainer = Trainer(TrainerConfig(num_classes=4, batch_size=2, ops_backend=backend, device="cpu"))
    seen = []
    loss_fn = trainer.loss_fn

    def recording_loss(*args, **kw):
        seen.append(cuda_ops._plain_depth)
        return loss_fn(*args, **kw)

    monkeypatch.setattr(trainer, "loss_fn", recording_loss)
    state = trainer.init_state()
    state, _ = trainer.train_step(state, _batch(0))
    trainer.eval_step(state, _batch(1))
    trainer.eval_votes(state, _batch(1), num_votes=2)
    assert seen == [int(backend == "lax")] * 4  # train_step, eval_step, eval_votes' two votes
    assert cuda_ops._plain_depth == 0  # nothing left set between calls


def test_plain_ops_sends_any_device_to_the_plain_version():
    vals = torch.empty(1, 5, 2, device="meta")
    idx = torch.zeros(1, 3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        gather_kernel.gather_rows(vals, idx)
    with cuda_ops.plain_ops():
        assert cuda_ops.takes_plain(vals)
        out = gather_kernel.gather_rows(vals, idx)
    assert out.shape == (1, 3, 2) and out.device.type == "meta"
    assert not cuda_ops.takes_plain(vals) and cuda_ops.takes_plain(vals.new_empty(1, device="cpu"))
    assert gather_kernel.gather_rows.launches == 0
