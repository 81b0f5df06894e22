"""PyTorch port, evaluation: ``Trainer.eval_step``, ``eval_votes`` and
``evaluate``, ``data.pipeline.padded_batches`` and ``train/evaluate.py``,
on the CPU, against the JAX package.

The JAX ``Trainer`` (one CPU device) and the port's evaluate the same
weights (the JAX init with random positive BN running stats, converted) on
the same synthetic clouds: ``pointnet2_cls_ssg`` (logits) and
``pointnet2_cls_bga`` (logits and per-point background masks), 3 classes,
B=4 clouds a batch of N=1024 points, six clouds, so the last batch is
partial and padded.  The JAX side runs its lax path (fused SA eval needs a
TPU); the port its plain path.  The two lax and plain ball queries test the
same d2 < r² by other roundings (the lax query the expanded distance), and
the rotations' products may round apart, so a point within rounding of a
ball's boundary can flip a neighbour: logits are held to rtol 2e-4 / atol
2e-4 x max(1, |ref|max), the loss to rtol 1e-5, and the predictions and
every tally must be equal.

The tallies of ``evaluate`` (masked padded rows, per class, seg and
per-part) are held exactly against JAX's on identical logits: both
trainers' ``eval_votes`` are replaced by one stub.  The cross-domain
protocols and the confusion matrix are held exactly against JAX's on stub
trainers, which answer ``evaluate_auto(shuffle=False)`` alone, the call
both packages' protocols make.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanobjectnn_tpu.data import pipeline as jpipeline
from scanobjectnn_tpu.parallel import mesh as mesh_lib
from scanobjectnn_tpu.train import evaluate as jevaluate
from scanobjectnn_tpu.train.trainer import Trainer as JaxTrainer
from scanobjectnn_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from scanobjectnn_torch.convert import load_jax_variables
from scanobjectnn_torch.data import io, pipeline
from scanobjectnn_torch.data.synthetic import make_synthetic_dataset
from scanobjectnn_torch.train import evaluate
from scanobjectnn_torch.train.trainer import Trainer, TrainerConfig

CLASSES, BATCH, POINTS, VOTES = 3, 4, 1024, 3
LOSS_RTOL, LOGIT_RTOL, LOGIT_ATOL = 1e-5, 2e-4, 2e-4  # module doc
MODELS = {"cls": "pointnet2_cls_ssg", "seg": "pointnet2_cls_bga"}


def _random_stats(batch_stats):
    rng = np.random.RandomState(1)
    return jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(
            0.1 + 0.1 * np.abs(rng.randn(*a.shape)) if p[-1].key == "var" else 0.05 * np.abs(rng.randn(*a.shape)),
            jnp.float32,
        ),
        batch_stats,
    )


@pytest.fixture(scope="module", params=sorted(MODELS))
def pair(request):
    """(kind, data dict, JAX trainer and state, port trainer and state)."""
    kind = request.param
    out = make_synthetic_dataset(num_per_class=2, num_classes=CLASSES, num_points=POINTS, seed=4,
                                 with_mask=kind == "seg")
    data = {"points": out[0], "labels": out[1]}
    if kind == "seg":
        data["masks"] = io.convert_to_binary_mask(out[2]).astype(np.int64)
    cfg = dict(model=MODELS[kind], num_classes=CLASSES, batch_size=BATCH, num_point=POINTS)
    jtrainer = JaxTrainer(JaxTrainerConfig(**cfg), mesh=mesh_lib.make_mesh(devices=jax.devices()[:1]))
    jstate = jtrainer.init_state(0)
    jstate = jstate.replace(batch_stats=_random_stats(jstate.batch_stats))
    trainer = Trainer(TrainerConfig(**cfg, device="cpu"))
    state = trainer.init_state(0)
    load_jax_variables(state.model, {"params": jstate.params, "batch_stats": jstate.batch_stats})
    return kind, data, (jtrainer, jstate), (trainer, state)


def _close(got, want):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, want, rtol=LOGIT_RTOL, atol=LOGIT_ATOL * max(1.0, float(np.abs(want).max())))
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def _batch(data, n=BATCH):
    return {k: v[:n] for k, v in data.items()}


def test_eval_step_matches_jax(pair):
    kind, data, (jtrainer, jstate), (trainer, state) = pair
    batch = _batch(data)
    ref = jtrainer.eval_step(jstate, batch, rotate_angle=0.7)
    got = trainer.eval_step(state, batch, rotate_angle=0.7)
    assert set(got) == set(ref)
    np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]), rtol=LOSS_RTOL)
    for key in ("logits", "seg_logits"):
        if key in ref:
            _close(got[key], ref[key])
    for key in ("correct", "count", "seg_correct", "seg_count"):
        if key in ref:
            assert int(got[key]) == int(ref[key]), key


def test_eval_votes_matches_jax_and_averages_the_per_vote_losses(pair):
    kind, data, (jtrainer, jstate), (trainer, state) = pair
    batch = _batch(data)
    ref = jtrainer.eval_votes(jstate, batch, num_votes=VOTES)
    got = trainer.eval_votes(state, batch, num_votes=VOTES)
    assert set(got) == set(ref)
    np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]), rtol=LOSS_RTOL)
    for key in ("logits_sum", "seg_logits_sum"):
        if key in ref:
            assert got[key].dtype == torch.float32
            _close(got[key], ref[key])
    # The mean of each vote's loss, not the stacked batch's (eval_step at the
    # vote angles; stacking changes no value at eval).
    angles = 2.0 * np.pi * np.arange(VOTES) / VOTES
    per_vote = [float(trainer.eval_step(state, batch, a)["loss"]) for a in angles]
    np.testing.assert_allclose(float(got["loss"]), np.mean(per_vote), rtol=1e-6)
    rots = trainer._vote_rotations(VOTES)
    np.testing.assert_array_equal(rots, np.asarray(JaxTrainer._vote_rotations(VOTES)))


@pytest.mark.parametrize("shuffle", [False, True], ids=["in_order", "shuffled"])
def test_evaluate_matches_jax_with_a_padded_last_batch(pair, shuffle):
    kind, data, (jtrainer, jstate), (trainer, state) = pair
    masks = data.get("masks")
    ref = jtrainer.evaluate(jstate, data["points"], data["labels"], masks=masks, num_votes=VOTES,
                            shuffle=shuffle, seed=7, keep_points=True)
    got = trainer.evaluate(state, data["points"], data["labels"], masks=masks, num_votes=VOTES,
                           shuffle=shuffle, seed=7, keep_points=True)
    assert set(got) == set(ref)
    assert got["total_seen"] == ref["total_seen"] == len(data["labels"])  # 6 = 4 + 2 padded to 4
    np.testing.assert_allclose(got["mean_loss"], ref["mean_loss"], rtol=LOSS_RTOL)
    for key in ("predictions", "labels", "points", "masks", "seg_predictions"):
        if key in ref:
            np.testing.assert_array_equal(got[key], np.asarray(ref[key]), err_msg=key)
    for key in ("accuracy", "avg_class_accuracy", "seg_accuracy"):
        if key in ref:
            assert got[key] == ref[key], key
    np.testing.assert_array_equal(got["per_class_accuracy"], ref["per_class_accuracy"])


def test_evaluate_matches_jax_on_ragged_clouds(pair):
    """Clouds of their own sizes (1024 to 1100 points, masks a list of rows),
    as ``io.load_data`` gives them: each subsampled by its own draw, the
    last batch padded; the same predictions, tallies and points as JAX's."""
    kind, _, (jtrainer, jstate), (trainer, state) = pair
    out = make_synthetic_dataset(num_per_class=2, num_classes=CLASSES, num_points=1100, seed=6,
                                 with_mask=kind == "seg")
    sizes = POINTS + np.random.RandomState(2).randint(0, 77, len(out[1]))
    sizes[0] = POINTS
    clouds = [pc[:n] for pc, n in zip(out[0], sizes)]
    masks = [io.convert_to_binary_mask(m[:n]).astype(np.int64) for m, n in zip(out[2], sizes)] if kind == "seg" \
        else None
    kw = dict(masks=masks, num_votes=VOTES, shuffle=True, seed=3, keep_points=True)
    ref = jtrainer.evaluate(jstate, clouds, out[1], **kw)
    got = trainer.evaluate(state, clouds, out[1], **kw)
    assert set(got) == set(ref)
    assert got["total_seen"] == ref["total_seen"] == len(clouds)
    np.testing.assert_allclose(got["mean_loss"], ref["mean_loss"], rtol=LOSS_RTOL)
    for key in ("predictions", "labels", "points", "masks", "seg_predictions"):
        if key in ref:
            np.testing.assert_array_equal(got[key], np.asarray(ref[key]), err_msg=key)
    for key in ("accuracy", "avg_class_accuracy", "seg_accuracy"):
        if key in ref:
            assert got[key] == ref[key], key


def _stub_votes(num_classes, seg_classes=None):
    """An ``eval_votes`` that both trainers can call: logits drawn from the
    batch's points (so padded rows repeat their source row)."""

    def votes(state, batch, num_votes=1):
        pts = np.asarray(batch["points"], np.float64)
        b, n, _ = pts.shape
        base = pts.sum(-1)  # [B, N]
        out = {"loss": np.float32(base.mean()), "logits_sum": np.cos(base[:, :num_classes] * 3.0).astype(np.float32)}
        if seg_classes:
            out["seg_logits_sum"] = np.cos(base[..., None] * np.arange(1, seg_classes + 1)).astype(np.float32)
        return out

    return votes


@pytest.mark.parametrize("target", ["parts", "masks"])
def test_evaluate_tallies_equal_jax_on_the_same_logits(monkeypatch, target):
    rng = np.random.RandomState(3)
    n_parts = 6
    pts = rng.randn(11, 32, 3).astype(np.float32)
    labels = rng.randint(0, CLASSES, 11)
    seg = rng.randint(0, 4, (11, 32))  # parts 4 and 5 never seen: -1.0 in the table
    cfg = dict(model="pointnet2_cls_partseg", num_classes=n_parts, batch_size=BATCH, num_point=32)
    jtrainer = JaxTrainer(JaxTrainerConfig(**cfg), mesh=mesh_lib.make_mesh(devices=jax.devices()[:1]))
    trainer = Trainer(TrainerConfig(**cfg, device="cpu"))
    stub = _stub_votes(n_parts, seg_classes=n_parts)
    monkeypatch.setattr(jtrainer, "eval_votes", stub)
    monkeypatch.setattr(trainer, "eval_votes", lambda s, b, num_votes=1: {
        k: torch.from_numpy(np.asarray(v)) for k, v in stub(s, b, num_votes).items()})
    kw = {target: seg, "num_votes": 2, "shuffle": True, "seed": 5, "keep_points": True}
    ref = jtrainer.evaluate(None, pts, labels, **kw)
    got = trainer.evaluate(None, pts, labels, **kw)
    assert set(got) == set(ref)
    for key, want in ref.items():
        if isinstance(want, np.ndarray):
            np.testing.assert_array_equal(got[key], want, err_msg=key)
        else:
            np.testing.assert_allclose(got[key], want, rtol=1e-6, err_msg=key)
    if target == "parts":
        assert (got["per_part_accuracy"][4:] == -1.0).all()


@pytest.mark.parametrize("n,bs", [(10, 4), (8, 4), (3, 4), (1, 1)])
def test_padded_batches_match_jax(n, bs):
    rng = np.random.RandomState(n)
    view = {"points": rng.randn(n, 5, 3), "labels": np.arange(n), "masks": rng.randint(0, 2, (n, 5))}
    got, ref = list(pipeline.padded_batches(view, bs)), list(jpipeline.padded_batches(view, bs))
    assert [v for _, v in got] == [v for _, v in ref]
    for (g, _), (r, _) in zip(got, ref):
        assert set(g) == set(r) and all(np.array_equal(g[k], r[k]) for k in r)
    for size in (1, 3, n, n + 2):
        np.testing.assert_array_equal(pipeline.pad_or_trim_batch(view["points"], size),
                                      jpipeline.pad_or_trim_batch(view["points"], size))


class _StubTrainer:
    """A trainer whose predictions come from the data, through
    ``evaluate_auto`` alone (the routing both packages' protocols take)."""

    def __init__(self, num_classes):
        self.num_classes = num_classes

    def evaluate_auto(self, state, data, labels, num_votes=1, shuffle=True, **kw):
        assert not shuffle and not kw
        sums = np.array([np.abs(pc).sum() for pc in data])
        preds = (sums * 7).astype(np.int64) % self.num_classes
        return {"total_seen": len(preds), "predictions": preds, "labels": np.asarray(labels),
                "accuracy": float((preds == np.asarray(labels)).mean()) if len(preds) else 0.0}


def _same(got, want):
    assert set(got) == set(want)
    for key, v in want.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[key], v, err_msg=key)
        else:
            assert got[key] == v, key


def _ragged_clouds(rng, count):
    """An object array of clouds of 16 to 23 points: JAX's protocols take
    ragged clouds so (``np.asarray`` keeps it)."""
    clouds = np.empty(count, dtype=object)
    for i in range(count):
        clouds[i] = rng.randn(16 + i % 8, 3).astype(np.float32)
    return clouds


@pytest.mark.parametrize("ragged", [False, True], ids=["rectangular", "ragged"])
def test_cross_domain_protocols_match_jax(ragged):
    rng = np.random.RandomState(0)
    data = _ragged_clouds(rng, 40) if ragged else rng.randn(40, 16, 3).astype(np.float32)
    labels = rng.randint(0, 15, 40)
    _same(evaluate.evaluate_real_trained_on_synthetic(_StubTrainer(40), None, data, labels, num_votes=2),
          jevaluate.evaluate_real_trained_on_synthetic(_StubTrainer(40), None, data, labels, num_votes=2))
    m40 = rng.randint(0, 40, 40)
    _same(evaluate.evaluate_synthetic_trained_on_real(_StubTrainer(15), None, data, m40, num_votes=2),
          jevaluate.evaluate_synthetic_trained_on_real(_StubTrainer(15), None, data, m40, num_votes=2))
    for got, want in zip(evaluate.filter_to_mappable_classes(data, labels, labels * 2),
                         jevaluate.filter_to_mappable_classes(data, labels, labels * 2)):
        assert got.dtype == want.dtype and len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_confusion_matrix_and_tables_match_jax(tmp_path):
    rng = np.random.RandomState(1)
    labels, preds = rng.randint(0, 5, 50), rng.randint(0, 5, 50)
    labels[labels == 3] = 0  # a class without samples: a row of zeros
    for normalize in (True, False):
        np.testing.assert_array_equal(evaluate.confusion_matrix(labels, preds, 5, normalize),
                                      jevaluate.confusion_matrix(labels, preds, 5, normalize))
    per_class = np.array([0.5, np.nan, 1.0])
    names = ("bag", "bin", "box")
    assert evaluate.format_per_class_table(per_class, names) == jevaluate.format_per_class_table(per_class, names)
    evaluate.write_pred_labels(tmp_path / "port.txt", [0, 2], [1, 2], names)
    jevaluate.write_pred_labels(tmp_path / "jax.txt", [0, 2], [1, 2], names)
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "jax.txt").read_text()


def test_config_fields_and_the_sa_bucket_setting():
    cfg = TrainerConfig()
    assert (cfg.num_point, cfg.sa_bucket) == (JaxTrainerConfig().num_point, JaxTrainerConfig().sa_bucket)
    state = Trainer(TrainerConfig(sa_bucket="off", device="cpu")).init_state(0)
    assert state.model.sa1.mlp.sa_bucket == "off"
    with pytest.raises(ValueError):
        Trainer(TrainerConfig(sa_bucket="896,64,128", device="cpu"))
