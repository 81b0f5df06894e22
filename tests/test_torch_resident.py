"""PyTorch port, the device-resident path (``Trainer.upload_dataset``,
``train_epoch_device``, ``evaluate_device``, ``evaluate_auto``) on the
CPU, against the JAX package and against the port's host path.

One JAX reference for the module (``jax_ref``, one CPU device): JAX's
``evaluate_device(shuffle=False)`` and two JAX ``train_epoch_device``
epochs of ``pointnet_cls_basic``, on weights and BN running statistics
drawn with numpy (``tests/test_torch_pointnet.py``'s ``random_variables``).
The ranks run ``tests/resident_ranks.py``.

  * ``evaluate_device(shuffle=False)`` on the converted weights, three
    cases: ``pointnet_cls_basic`` on 19 clouds at batch 8 and 2 votes (the
    last batch padded; class 3 unseen: NaN), ``pointnet_seg`` with masks,
    ``pointnet_partseg`` with parts (parts 4 and 5 unseen: -1).  Against
    JAX's and against the port's ``evaluate(shuffle=False)``: the same
    keys, predictions, labels and every tally equal, NaN and -1 where they
    are, ``mean_loss`` within ``LOSS_RTOL``.
  * ``shuffle=True``: one seed gives one result twice; ``seed=None`` draws
    a seed from ``np.random`` each call; ``evaluate_auto`` routes as JAX's.
  * ``train_epoch_device`` against ``train_epoch`` over the view it drew
    (``pointnet_cls_basic`` and ``pointnet_seg`` with masks, augmentation
    and dropout on): bit for bit, the parameters, BN buffers, optimizer
    state, step, generator state and summary; the view is
    ``data[order][:, pt_perm]`` of ``_epoch_permutations``, whose draws
    follow (seed, step) and never ``state.generator``.
  * Against JAX's epoch: JAX's permutations, computed with the public
    ``jax.random`` calls of its ``_epoch_impl`` (``trainer.py:443-447``),
    fed to the port's epoch; no augmentation, dropout the identity, the
    momentum optimizer (its update is linear in the gradient), two epochs:
    the mean loss within rtol 1e-4 and every parameter and BN statistic
    within rtol 1e-3 / atol 1e-5 (``tests/test_multichip.py:160-165``, a
    reordered reduction).
  * Resume: the epoch after ``restore`` equals the uninterrupted one.
  * Two gloo ranks (``tests/test_torch_parallel.py``'s configuration and
    limits): the ranks' resident epochs within those limits of one
    process's, their states equal; a planted fault, rank 1 drawing with its
    own epoch seed, fails them; two-rank ``evaluate_device`` (shuffled)
    equals one process's.
"""

import multiprocessing
import time
from unittest import mock

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanobjectnn_tpu import kernelconfig
from scanobjectnn_tpu.parallel import mesh as jmesh
from scanobjectnn_tpu.train import trainer as jtrainer_lib
from scanobjectnn_torch import convert
from scanobjectnn_torch.data.synthetic import make_synthetic_dataset
from scanobjectnn_torch.train.trainer import Trainer, TrainerConfig
from tests.resident_ranks import rank_job, run_epochs, run_evaluation
from tests.test_torch_parallel import BASIC, JAX_ATOL, JAX_LOSS_RTOL, JAX_RTOL, JOIN_TIMEOUT, WORLD
from tests.test_torch_pointnet import random_variables

LOSS_RTOL = 1e-5
STORED, NUM_POINT = 40, 32  # points a cloud holds, points an epoch or evaluation keeps
EPOCHS, EPOCH_CLOUDS = 2, 19  # the JAX and two-rank epochs: 2 batches of 8, 3 clouds dropped
SEED = 3
EVAL_CASES = {
    # name: (model, num_classes, batch, clouds, votes, target)
    "cls_padded": ("pointnet_cls_basic", 4, 8, 19, 2, None),
    "seg_masks": ("pointnet_seg", 3, 4, 10, 2, "masks"),
    "partseg_parts": ("pointnet_partseg", 6, 4, 10, 2, "parts"),
}


def _data(n: int, target: str | None, seed: int, stored: int = STORED) -> dict:
    """``n`` clouds of 3 synthetic classes, with binary masks or parts 0-3."""
    data, labels, masks = make_synthetic_dataset(num_per_class=-(-n // 3), num_classes=3, num_points=stored,
                                                 seed=seed, with_mask=True)
    order = np.random.RandomState(seed).permutation(len(data))[:n]
    out = {"points": data[order], "labels": labels[order]}
    if target == "masks":
        out["masks"] = (masks[order] >= 0).astype(np.int64)
    if target == "parts":
        out["parts"] = np.random.RandomState(seed + 1).randint(0, 4, (n, stored))
    return out


def _eval_config(name: str) -> dict:
    model, classes, batch, _, _, _ = EVAL_CASES[name]
    return dict(model=model, num_classes=classes, batch_size=batch, num_point=NUM_POINT, seed=SEED)


def _eval_data(name: str) -> dict:
    _, _, _, n, _, target = EVAL_CASES[name]
    return _data(n, target, SEED + 1)


def _epoch_config(**kw) -> dict:
    return {**BASIC, "num_point": NUM_POINT, "seed": SEED, **kw}


def _jax_state(jt, seed: int):
    """A JAX ``TrainState`` of ``random_variables`` (``tests/test_torch_pointnet.py``:
    every leaf drawn with numpy, the BN running statistics too)."""
    cfg = jt.config
    variables = random_variables(jt.model, (cfg.batch_size, cfg.num_point, 3), seed)
    variables = jax.tree_util.tree_map(jnp.asarray, variables)
    return jtrainer_lib.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                                   batch_stats=variables["batch_stats"], opt_state=jt.tx.init(variables["params"]))


def _numpy(state) -> dict:
    return jax.tree_util.tree_map(np.asarray, {"params": state.params, "batch_stats": state.batch_stats})


def _jax_permutations(seed: int, step: int, n_points: int, n_total: int):
    """JAX ``_epoch_impl``'s draws (trainer.py:443-447)."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), 0xE70C), step)
    k_pts, k_order = jax.random.split(key)
    return (np.asarray(jax.random.permutation(k_pts, n_points))[:NUM_POINT],
            np.asarray(jax.random.permutation(k_order, n_total)))


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's evaluations and epochs (module doc)."""
    out = {"eval": {}, "variables": {}}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kernelconfig, "_active", kernelconfig.active())  # a JAX Trainer writes it
        one = jmesh.make_mesh(devices=jax.devices()[:1])
        for name, (_, _, _, _, votes, _) in EVAL_CASES.items():
            cfg = _eval_config(name)
            jt = jtrainer_lib.Trainer(jtrainer_lib.TrainerConfig(**cfg), mesh=one)
            st = _jax_state(jt, SEED)
            out["eval"][name] = jt.evaluate_device(st, jt.upload_dataset(_eval_data(name)), num_votes=votes,
                                                   shuffle=False)
            out["variables"][name] = _numpy(st)
        mp.setattr(fnn, "Dropout", lambda rate, deterministic: (lambda h: h))
        jt = jtrainer_lib.Trainer(jtrainer_lib.TrainerConfig(**_epoch_config()), mesh=one)
        st = _jax_state(jt, SEED)
        init = _numpy(st)
        device_data = jt.upload_dataset(_data(EPOCH_CLOUDS, None, SEED))
        summaries = []
        for _ in range(EPOCHS):
            st, summary = jt.train_epoch_device(st, device_data, jax.random.PRNGKey(SEED))
            summaries.append(summary)
    out["epoch"] = (init, summaries, convert.jax_to_state_dict(_numpy(st)))
    return out


def _port(name: str, variables=None):
    trainer = Trainer(TrainerConfig(**_eval_config(name), device="cpu"))
    state = trainer.init_state()
    if variables is not None:
        convert.load_jax_variables(state.model, variables)
    return trainer, state


def _same_results(got: dict, want: dict, what: str) -> None:
    assert list(got) == list(want), what
    for key, value in want.items():
        if key == "mean_loss":
            np.testing.assert_allclose(got[key], value, rtol=LOSS_RTOL, err_msg=f"{what} {key}")
        elif isinstance(value, np.ndarray):
            np.testing.assert_array_equal(got[key], np.asarray(value), err_msg=f"{what} {key}")
        else:
            assert got[key] == value, f"{what} {key}"


# ------------------------------------------------------------- evaluate_device


@pytest.mark.parametrize("name", sorted(EVAL_CASES))
def test_evaluate_device_in_order_equals_jax_and_the_host_loop(jax_ref, name):
    _, _, _, n, votes, target = EVAL_CASES[name]
    trainer, state = _port(name, jax_ref["variables"][name])
    data = _eval_data(name)
    got = trainer.evaluate_device(state, trainer.upload_dataset(data), num_votes=votes, shuffle=False)
    _same_results(got, jax_ref["eval"][name], "against JAX's evaluate_device")
    host = trainer.evaluate(state, data["points"], data["labels"], masks=data.get("masks"), parts=data.get("parts"),
                            num_votes=votes, shuffle=False)
    _same_results(got, host, "against the port's evaluate")
    assert got["total_seen"] == n
    if target is None:
        assert np.isnan(got["per_class_accuracy"][3]) and not np.isnan(got["per_class_accuracy"][:3]).any()
    if target == "parts":
        assert (got["per_part_accuracy"][4:] == -1.0).all() and (got["per_part_accuracy"][:4] >= 0).all()


def test_evaluate_device_shuffled_draws_from_its_seed():
    trainer, state = _port("seg_masks")
    data = _eval_data("seg_masks")
    device_data = trainer.upload_dataset(data)
    seeds = []
    real = trainer._eval_points

    def recording(n_points, seed):
        seeds.append(seed)
        return real(n_points, seed)

    trainer._eval_points = recording
    first = trainer.evaluate_device(state, device_data, num_votes=2, seed=7)
    _same_results(trainer.evaluate_device(state, device_data, num_votes=2, seed=7), first, "seed 7 twice")
    np.random.seed(0)
    for _ in range(2):
        trainer.evaluate_device(state, device_data, seed=None)
    assert seeds[:2] == [7, 7] and seeds[2] != seeds[3] and all(isinstance(s, int) for s in seeds[2:])
    kept = real(STORED, 7)
    assert len(kept) == NUM_POINT == len(set(kept.tolist())) and not torch.equal(kept, torch.arange(NUM_POINT))
    assert torch.equal(real(STORED, None), torch.arange(NUM_POINT)) and torch.equal(real(24, 7), torch.arange(24))


@pytest.mark.parametrize("ragged,keep_points", [(False, False), (True, False), (False, True)])
def test_evaluate_auto_routes_as_jaxs(ragged, keep_points, monkeypatch):
    trainer, state = _port("seg_masks")
    data = _eval_data("seg_masks")
    points = data["points"]
    if ragged:
        points = np.empty(len(points), dtype=object)
        for i, pc in enumerate(data["points"]):
            points[i] = pc[: NUM_POINT + i % 5]
    calls = []
    monkeypatch.setattr(trainer, "evaluate", lambda *a, **kw: calls.append(("evaluate", kw)) or {})
    monkeypatch.setattr(trainer, "evaluate_device", lambda s, d, **kw: calls.append(("evaluate_device", kw)) or {})
    trainer.evaluate_auto(state, points, data["labels"], masks=data["masks"], num_votes=3, shuffle=False, seed=4,
                          keep_points=keep_points)
    if ragged or keep_points:
        assert calls == [("evaluate", dict(masks=data["masks"], parts=None, num_votes=3, shuffle=False, seed=4,
                                           keep_points=keep_points))]
    else:
        assert calls == [("evaluate_device", dict(num_votes=3, shuffle=False, seed=4))]


# ---------------------------------------------------------- train_epoch_device


def _state_of(state) -> dict:
    out = {f"model {k}": v.clone() for k, v in state.model.state_dict().items()}
    for i, st in state.optimizer.state_dict()["state"].items():
        out.update({f"optimizer {i} {k}": torch.as_tensor(v).clone() for k, v in st.items()})
    out["generator"] = state.generator.get_state()
    return out


def _assert_bit_equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("model,target", [("pointnet_cls_basic", None), ("pointnet_seg", "masks")])
def test_train_epoch_device_is_the_host_loop_over_its_view(model, target):
    trainer = Trainer(TrainerConfig(model=model, num_classes=3, num_point=NUM_POINT, batch_size=4, seed=SEED,
                                    device="cpu"))
    data = _data(EPOCH_CLOUDS, target, SEED, stored=48)
    device_data = trainer.upload_dataset(data)
    resident, host = trainer.init_state(), trainer.init_state()
    for epoch in range(2):
        step = resident.step
        pt_perm, order = trainer._epoch_permutations(step, 48, EPOCH_CLOUDS)
        view = trainer._epoch_view(step, device_data)
        for k, v in device_data.items():
            want = v[order] if k == "labels" else v[order][:, pt_perm]
            assert torch.equal(view[k], want), k
        resident, summary = trainer.train_epoch_device(resident, device_data)
        sampler = mock.Mock(epoch=lambda: {k: v.numpy() for k, v in view.items()})
        host, host_summary = trainer.train_epoch(host, sampler)
        assert resident.step == host.step == 4 * (epoch + 1)
        assert summary == host_summary
        assert set(summary) == {"mean_loss", "accuracy"} | ({"seg_accuracy"} if target else set())
        _assert_bit_equal(_state_of(resident), _state_of(host))


def test_epoch_draws_follow_seed_and_step_and_not_the_state_generator():
    trainer = Trainer(TrainerConfig(**_epoch_config(), device="cpu"))
    other_seed = Trainer(TrainerConfig(**_epoch_config(seed=SEED + 1), device="cpu"))

    def draws(t, step):
        return [p.tolist() for p in t._epoch_permutations(step, STORED, EPOCH_CLOUDS)]

    generator = torch.Generator().manual_seed(5)
    before = generator.get_state()
    pt_perm, order = trainer._epoch_permutations(0, STORED, EPOCH_CLOUDS)
    assert len(pt_perm) == NUM_POINT and len(set(pt_perm.tolist())) == NUM_POINT
    assert sorted(order.tolist()) == list(range(EPOCH_CLOUDS))
    assert draws(trainer, 4) == draws(Trainer(TrainerConfig(**_epoch_config(), device="cpu")), 4)
    assert draws(trainer, 4) != draws(trainer, 6) and draws(trainer, 4) != draws(other_seed, 4)
    assert torch.equal(generator.get_state(), before)


def test_train_epoch_device_matches_jax_given_its_permutations(jax_ref, monkeypatch):
    init, jax_summaries, jax_after = jax_ref["epoch"]
    trainer = Trainer(TrainerConfig(**_epoch_config(), device="cpu"))
    state = trainer.init_state()
    convert.load_jax_variables(state.model, init)
    for module in state.model.modules():
        if hasattr(module, "dropout_keep"):
            module.dropout_keep = 1.0
    monkeypatch.setattr(trainer, "_epoch_permutations", lambda step, n_points, n_total: tuple(
        torch.from_numpy(np.array(p)).long() for p in _jax_permutations(SEED, step, n_points, n_total)))
    device_data = trainer.upload_dataset(_data(EPOCH_CLOUDS, None, SEED))
    for want in jax_summaries:
        state, summary = trainer.train_epoch_device(state, device_data)
        np.testing.assert_allclose(summary["mean_loss"], want["mean_loss"], rtol=JAX_LOSS_RTOL)
        assert summary["accuracy"] == want["accuracy"]
    assert state.step == EPOCHS * (EPOCH_CLOUDS // BASIC["batch_size"])
    worst = 0.0
    for key, value in state.model.state_dict().items():
        ref = jax_after[key].numpy()
        np.testing.assert_allclose(value.numpy(), ref, rtol=JAX_RTOL, atol=JAX_ATOL, err_msg=key)
        worst = max(worst, float(np.abs(value.numpy() - ref).max()))
    print(f"{EPOCHS} resident epochs against JAX's: largest parameter or statistic difference {worst:.3e}")


def test_resumed_epoch_equals_the_uninterrupted_one(tmp_path):
    cfg = TrainerConfig(**dict(_epoch_config(), augment_rotate=True, augment_jitter=True), log_dir=str(tmp_path),
                        device="cpu")
    trainer = Trainer(cfg)
    device_data = trainer.upload_dataset(_data(EPOCH_CLOUDS, None, SEED))
    state, _ = trainer.train_epoch_device(trainer.init_state(), device_data)
    trainer.save(state, meta={"epoch": 0})
    state, summary = trainer.train_epoch_device(state, device_data)
    again = Trainer(cfg)
    restored = again.restore(again.init_state(seed=11))
    restored, resumed_summary = again.train_epoch_device(restored, again.upload_dataset(_data(EPOCH_CLOUDS, None,
                                                                                              SEED)))
    assert resumed_summary == summary
    _assert_bit_equal(_state_of(restored), _state_of(state))


# ------------------------------------------------------------- two gloo ranks


def _within(got: dict, want: dict) -> tuple[bool, str]:
    """The two-rank epochs against one process's, by the basic limits."""
    worst = [0.0, "nothing"]
    for g, w in zip(got["summaries"], want["summaries"]):
        err = abs(g["mean_loss"] - w["mean_loss"]) / (JAX_LOSS_RTOL * abs(w["mean_loss"]))
        if err > worst[0]:
            worst[:] = [err, f"mean_loss {g['mean_loss']} against {w['mean_loss']}"]
    for key, value in want["state"].items():
        err = float(((got["state"][key] - value).abs() / (JAX_ATOL + JAX_RTOL * value.abs())).max())
        if err > worst[0]:
            worst[:] = [err, key]
    return worst[0] <= 1.0, f"largest reading over its limit {worst[0]:.3e} ({worst[1]})"


def test_two_rank_epochs_and_evaluation_equal_one_process(jax_ref, tmp_path):
    spec = {"config": _epoch_config(), "variables": jax_ref["epoch"][0], "data": _data(EPOCH_CLOUDS, None, SEED),
            "epochs": EPOCHS, "eval_config": _eval_config("seg_masks"), "eval_data": _eval_data("seg_masks")}
    spec_path = str(tmp_path / "spec.pt")
    torch.save(spec, spec_path)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_job, args=(r, str(tmp_path / "init"), spec_path, str(tmp_path / f"out{r}.pt")))
             for r in range(WORLD)]
    t0 = time.monotonic()
    for p in procs:
        p.start()
    for p in procs:
        p.join(max(0.0, JOIN_TIMEOUT - (time.monotonic() - t0)))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    assert not hung, f"{len(hung)} rank(s) still running after {JOIN_TIMEOUT} s: killed"
    assert [p.exitcode for p in procs] == [0] * WORLD, f"rank exit codes {[p.exitcode for p in procs]}"
    ranks = [torch.load(str(tmp_path / f"out{r}.pt"), weights_only=False) for r in range(WORLD)]

    one = run_epochs(spec)
    for key, value in ranks[0]["epochs"]["state"].items():
        assert torch.equal(value, ranks[1]["epochs"]["state"][key]), key
    ok, reading = _within(ranks[0]["epochs"], one)
    print(f"two-rank resident epochs against one process: {reading}")
    assert ok, reading
    bad, reading = _within(ranks[0]["fault"], one)
    print(f"rank 1 with its own epoch seed (must fail): {reading}")
    assert not bad, f"the planted fault passes: {reading}"
    want = run_evaluation(spec)
    for r in ranks:
        got = r["eval"]
        assert list(got) == list(want)
        for key, value in want.items():
            if key == "mean_loss":
                np.testing.assert_allclose(got[key], value, rtol=1e-6)
            elif isinstance(value, np.ndarray):
                np.testing.assert_array_equal(got[key], value, err_msg=key)
            else:
                assert got[key] == value, key
