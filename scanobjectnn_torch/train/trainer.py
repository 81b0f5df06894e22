"""The training step and evaluation (counterpart of
``scanobjectnn_tpu/train/trainer.py``).

One ``train_step`` is augmentation (y-rotation, then jitter; PointCNN's
recipe: its per-cloud transform) → forward in
training mode (batch-statistics BN with the scheduled momentum, dropout
from the state's generator) → the model's loss → backward → Adam with the
scheduled LR → metrics ``correct``/``count`` (models with class logits)
and ``seg_correct``/``seg_count`` (models with per-point logits, against
the batch's ``masks`` or ``parts``).  The model's ``kind`` (registry) says
which targets the batch carries: "cls" labels, "seg" labels and masks,
"partseg" parts; a "partseg" model is built with ``num_parts =
num_classes``, as the JAX ``Trainer`` does.  A loss that declares
``seg_weight`` receives the config's; every other loss argument keeps its
default (``dgcnn``'s label smoothing 0.2, as in the JAX ``Trainer``).  The
BN running stats are updated during the forward.  As in optax, the LR of an
update is ``schedule(step)`` taken BEFORE the step, counting from 0; Adam
uses eps 1e-8 and no weight decay, unless the model ships a recipe.

A model's recipe (``models.get_recipe``; PointCNN's, ``models/recipes.py``)
is honoured unless ``use_model_recipe`` is False, as in the JAX ``Trainer``:
the LR decays over steps (``step_exponential_decay_lr``), Adam takes the
recipe's eps, the weight decay is the config's when not 0 and else the
recipe's, and augmentation is ``pointcnn_augment``.  Weight decay is L2
added to the gradient before Adam (``optax.add_decayed_weights`` chained
before ``adam``), which is ``torch.optim.Adam(weight_decay=...)``.

Differences from the JAX ``Trainer``, on purpose:
  * the state is mutable (the model, its optimizer and a generator), and
    ``train_step`` updates it in place;
  * the random bits come from a ``torch.Generator`` on the training device,
    seeded from ``config.seed``; they are not the JAX package's bits;
  * nothing is process-global: the JAX ``Trainer`` writes its kernel
    configuration into ``kernelconfig``; here the resolved pool mode and
    ``fused_sa_train`` go to the model the trainer builds
    (``nn.pointnet_modules.configure_training``).

Mixed precision (the JAX fields and defaults): ``dtype`` is the compute
dtype the model is built with (parameters stay f32); ``pool_precision``
"auto" resolves to "keys" (exact-key pooling) in bf16 and "native" in f32,
and "native", "f32", "keys" are the SA pool modes "0", "1", "keys";
``fused_sa_train`` runs the SA layers' fused training tail under the
native and f32 modes (never under keys).
Ported: f32 training of ``pointnet2_cls_ssg``, ``pointnet2_cls_msg``,
``pointnet2_cls_bga``, ``pointnet2_cls_partseg``, ``dgcnn``,
``dgcnn_bga`` and ``spidercnn_cls_xyz`` (no recipe: plain Adam, as the JAX
``Trainer`` gives them), and ``pointcnn_cls`` and ``pointcnn_seg`` (with
PointCNN's recipe); bf16 training of the four ``pointnet2_*`` models.  The
other families raise ``NotImplementedError`` for bf16.

Evaluation, as the JAX ``Trainer``'s (``trainer.py:314-406``, ``:736-866``):
  * ``eval_step(state, batch, rotate_angle)``: the batch turned about the
    y axis by one angle (the matrix built in float64 and cast to f32, the
    product in f32 without TF32), the model in eval mode, then the loss, the
    outputs and the metrics of ``train_step``;
  * ``eval_votes(state, batch, num_votes)``: the V vote rotations (angles
    2πv/V) stacked into one [V·B] batch for one forward; the loss taken per
    vote and averaged (not the stacked mean), the logits summed over the
    votes;
  * ``evaluate(state, data, labels, ...)``: ``config.num_point`` points a
    cloud (``EpochSampler``; rectangular or ragged clouds), ``padded_batches`` (the last batch padded,
    its padded rows kept out of every tally), ``eval_votes`` per batch,
    overall and per-class accuracy, seg and per-part accuracy, and with
    ``keep_points`` the clouds in eval order.
``sa_bucket`` ("auto", JAX's default, or "off") goes to the model's SA
layers (``nn.pointnet_modules.configure_eval``): under "auto" an eval SA
layer at (N=2048, M=512), such as SSG's SA1 at ``num_point=2048``, runs
the bucketed kernel (#4, after #5).  JAX's ``evaluate_device``,
``evaluate_auto`` and ``upload_dataset`` avoid TPU dispatch costs and are
not ported: the JAX package holds ``evaluate_device`` equal to
``evaluate(shuffle=False)``, which the cross-domain protocols call
(``train/evaluate.py``) for rectangular and ragged input alike.
Checkpoints and ``fit`` wait for the CLI slice.
"""

from __future__ import annotations

import functools
import inspect
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from scanobjectnn_torch.augment.transforms import pointcnn_augment, standard_train_augment
from scanobjectnn_torch.data.pipeline import Batches, EpochSampler, padded_batches
from scanobjectnn_torch.models import MODEL_REGISTRY, get_model, get_recipe
from scanobjectnn_torch.nn.pointnet_modules import configure_eval, configure_training
from scanobjectnn_torch.ops.cuda.sabucket_kernel import SA_BUCKET_SETTINGS
from scanobjectnn_torch.train import schedules

__all__ = ["TrainState", "Trainer", "TrainerConfig"]

ADAM_EPS = 1e-8
DTYPES = {"float32": None, "bfloat16": torch.bfloat16}  # None: the model's f32 default
POOL_MODES = {"native": "0", "f32": "1", "keys": "keys"}


@dataclass
class TrainerConfig:
    """The fields of the JAX ``TrainerConfig`` that this path reads
    (reference flags: pointnet2/train.py:25-47), and the device."""

    model: str = "pointnet2_cls_ssg"
    num_classes: int = 15
    num_point: int = 1024  # points a cloud at evaluation
    batch_size: int = 16
    learning_rate: float = 1e-3
    decay_step: int = 200_000
    decay_rate: float = 0.7
    seg_weight: float = 0.5
    weight_decay: float = 0.0
    dtype: str = "float32"
    # Honour the training recipe the model ships with (module doc).
    use_model_recipe: bool = True
    # SA pool mode, "auto" | "native" | "f32" | "keys", and the fused SA
    # training tail (module doc).
    pool_precision: str = "auto"
    fused_sa_train: bool = False
    # The bucketed eval SA kernel: "auto" | "off" (module doc).
    sa_bucket: str = "auto"
    seed: int = 0
    device: str = "cuda"


@dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator  # augmentation and dropout draws


class Trainer:
    """Builds and trains a registered model on one device."""

    def __init__(self, config: TrainerConfig):
        if config.dtype not in DTYPES:
            raise ValueError(f"dtype must be 'float32' or 'bfloat16', got {config.dtype!r}")
        if config.model not in MODEL_REGISTRY:
            raise KeyError(f"model {config.model!r} is not ported to scanobjectnn_torch yet")
        if config.dtype == "bfloat16" and not getattr(MODEL_REGISTRY[config.model], "trains_in_bf16", False):
            raise NotImplementedError(
                f"bf16 training of {config.model!r} is not ported: its backward kernels (#7, #14, #16) have not "
                "been held in bf16 (ROADMAP.md queue 1, 'bf16 training of DGCNN, SpiderCNN and PointCNN')"
            )
        pool = config.pool_precision
        if pool == "auto":
            pool = "keys" if config.dtype == "bfloat16" else "native"
        if pool not in POOL_MODES:
            raise ValueError(f"pool_precision must be 'auto' or one of {sorted(POOL_MODES)}, got {pool!r}")
        self.pool_mode, self.fused_sa_train = POOL_MODES[pool], bool(config.fused_sa_train)
        if config.sa_bucket not in SA_BUCKET_SETTINGS:
            raise ValueError(f"sa_bucket must be one of {SA_BUCKET_SETTINGS}, got {config.sa_bucket!r}")
        self.dtype = DTYPES[config.dtype]
        self.config = config
        self.device = torch.device(config.device)
        model_cls = MODEL_REGISTRY[config.model]
        self.kind = model_cls.kind
        self.loss_fn = model_cls.loss
        if "seg_weight" in inspect.signature(model_cls.loss).parameters:
            self.loss_fn = functools.partial(model_cls.loss, seg_weight=config.seg_weight)
        self.recipe = get_recipe(config.model) if config.use_model_recipe else None
        recipe = self.recipe
        self.adam_eps, self.weight_decay = ADAM_EPS, config.weight_decay
        if recipe is not None:
            self.lr_schedule = schedules.step_exponential_decay_lr(
                recipe.learning_rate_base, recipe.decay_steps, recipe.decay_rate, recipe.learning_rate_min
            )
            self.adam_eps = recipe.adam_epsilon
            self.weight_decay = self.weight_decay or recipe.weight_decay
        else:
            self.lr_schedule = schedules.exponential_decay_lr(
                config.learning_rate, config.batch_size, config.decay_step, config.decay_rate
            )
        self.bn_schedule = schedules.bn_momentum_schedule(config.batch_size, config.decay_step)

    # ------------------------------------------------------------------ setup

    def init_state(self, seed: int | None = None) -> TrainState:
        """Model in the compute dtype with the reference init drawn from
        ``seed`` (default ``config.seed``) and the trainer's SA settings
        (training and ``sa_bucket``), its Adam optimizer, and the step's
        generator."""
        seed = self.config.seed if seed is None else seed
        width = "num_parts" if self.kind == "partseg" else "num_classes"
        model = get_model(
            self.config.model, generator=torch.Generator().manual_seed(seed), device=self.device,
            dtype=self.dtype, **{width: self.config.num_classes},
        )
        configure_training(model, self.pool_mode, self.fused_sa_train)
        configure_eval(model, self.config.sa_bucket)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        return TrainState(0, model, self.make_optimizer(model.parameters()), generator)

    def make_optimizer(self, params) -> torch.optim.Optimizer:
        return torch.optim.Adam(params, lr=self.lr_schedule(0), eps=self.adam_eps, weight_decay=self.weight_decay)

    def optimizer_step(self, optimizer: torch.optim.Optimizer, step: int) -> None:
        """One Adam update at LR ``schedule(step)`` (optax's count)."""
        for group in optimizer.param_groups:
            group["lr"] = self.lr_schedule(step)
        optimizer.step()

    # ------------------------------------------------------------- train step

    def augment(self, points: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        """The step's augmentation: the recipe's PointCNN transform, or
        y-rotation then jitter."""
        recipe = self.recipe
        if recipe is not None:
            return pointcnn_augment(points, generator, recipe.jitter, recipe.rotation_range, recipe.scaling_range)
        return standard_train_augment(points, generator)

    def train_step(self, state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        """One step on ``batch`` ({"points" [B, N, 3], "labels" [B], and
        "masks" or "parts" [B, N] as the model's kind needs}, numpy or
        torch).  Updates ``state`` in place and returns it with the step's
        metrics as device tensors (the loss's terms, then ``correct`` and
        ``count`` and/or ``seg_correct`` and ``seg_count``)."""
        points, targets = self._on_device(batch)
        points = self.augment(points, state.generator)
        model = state.model.train()
        outputs = model(points, bn_momentum=self.bn_schedule(state.step), generator=state.generator)
        loss, metrics = self.loss_fn(outputs, targets)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer_step(state.optimizer, state.step)
        state.step += 1
        with torch.no_grad():
            metrics = {k: v.detach() for k, v in metrics.items()}
            metrics.update(self._metrics(outputs, targets))
        return state, metrics

    def _on_device(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """A batch's f32 points and its integer targets on the device."""
        points = torch.as_tensor(batch["points"], dtype=torch.float32, device=self.device)
        targets = {
            k: torch.as_tensor(batch[k], device=self.device).long()
            for k in ("labels", "masks", "parts") if k in batch
        }
        return points, targets

    @staticmethod
    def _metrics(outputs: dict, targets: dict) -> dict:
        """``correct``/``count`` (class logits) and ``seg_correct``/
        ``seg_count`` (per-point logits against the masks or parts), as
        device tensors."""
        metrics = {}
        if "logits" in outputs and "labels" in targets:
            labels = targets["labels"]
            metrics["correct"] = (outputs["logits"].argmax(-1) == labels).sum()
            metrics["count"] = labels.new_full((), labels.shape[0])  # no host-to-device copy
        target = targets.get("masks", targets.get("parts"))
        if "seg_logits" in outputs and target is not None:
            metrics["seg_correct"] = (outputs["seg_logits"].argmax(-1) == target).sum()
            metrics["seg_count"] = target.new_full((), target.numel())
        return metrics

    def train_epoch(self, state: TrainState, sampler: EpochSampler) -> tuple[TrainState, dict]:
        """One epoch of ``sampler`` in fixed-size batches (every key of its
        view, masks and parts included, goes to ``train_step``); returns the
        state and {"mean_loss", "accuracy", "seg_accuracy"}, each where the
        model gives it (read back once, at the end)."""
        totals: dict[str, torch.Tensor] = {}
        n_batches = 0
        for batch in Batches(sampler.epoch(), self.config.batch_size):
            state, metrics = self.train_step(state, batch)
            n_batches += 1
            for k, v in metrics.items():
                totals[k] = totals.get(k, 0) + v.float()
        totals = {k: float(v) for k, v in totals.items()}
        summary = {"mean_loss": totals.get("loss", 0.0) / max(n_batches, 1)}
        if "correct" in totals:
            summary["accuracy"] = totals["correct"] / max(totals["count"], 1.0)
        if "seg_correct" in totals:
            summary["seg_accuracy"] = totals["seg_correct"] / max(totals["seg_count"], 1.0)
        return state, summary

    # ------------------------------------------------------------- evaluation

    @staticmethod
    def _vote_rotations(num_votes: int) -> np.ndarray:
        """The voting protocol's y-rotations [V, 3, 3] f32: angles 2π·v/V
        (evaluate_scenennobjects.py:180-181), built in float64 and cast, each
        equal to ``eval_step``'s matrix for its angle."""
        angles = 2.0 * np.pi * np.arange(num_votes) / float(num_votes)
        c, s = np.cos(angles), np.sin(angles)
        zero, one = np.zeros_like(c), np.ones_like(c)
        mats = np.stack(
            [np.stack([c, zero, s], -1), np.stack([zero, one, zero], -1), np.stack([-s, zero, c], -1)], -2
        )
        return mats.astype(np.float32)

    def _rotate(self, points: torch.Tensor, rots: np.ndarray) -> torch.Tensor:
        """points [B, N, 3] times each matrix of ``rots`` [V, 3, 3]: [V, B, N,
        3], each row ``(x·R0 + y·R1) + z·R2`` in f32 (no TF32)."""
        r = torch.from_numpy(rots).to(self.device)[:, None, None]  # [V, 1, 1, 3, 3]
        p = points[None]
        return (p[..., 0:1] * r[..., 0, :] + p[..., 1:2] * r[..., 1, :]) + p[..., 2:3] * r[..., 2, :]

    def eval_step(self, state: TrainState, batch: dict, rotate_angle: float = 0.0) -> dict:
        """The model in eval mode on ``batch`` turned by ``rotate_angle``
        about the y axis: {"loss", the model's outputs but "end_points", and
        the metrics of ``train_step``}, device tensors."""
        points, targets = self._on_device(batch)
        c, s = np.cos(float(rotate_angle)), np.sin(float(rotate_angle))
        rot = np.asarray([[[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]]], np.float32)
        model = state.model.eval()
        with torch.no_grad():
            outputs = model(self._rotate(points, rot)[0])
            loss, _ = self.loss_fn(outputs, targets)
            out = {"loss": loss, **{k: v for k, v in outputs.items() if k != "end_points"}}
            out.update(self._metrics(outputs, targets))
        return out

    def eval_votes(self, state: TrainState, batch: dict, num_votes: int = 1) -> dict:
        """Every vote rotation in one forward of the [V·B] stacked batch (BN
        stats fixed at eval, so stacking changes no value): {"loss": the mean
        over votes of each vote's loss, "logits_sum" [B, classes] and/or
        "seg_logits_sum" [B, N, classes], f32 sums over the votes}."""
        points, targets = self._on_device(batch)
        b, n, _ = points.shape
        model = state.model.eval()
        with torch.no_grad():
            stacked = self._rotate(points, self._vote_rotations(num_votes)).reshape(num_votes * b, n, 3)
            outputs = {k: v for k, v in model(stacked).items() if k != "end_points"}
            per_vote = {k: v.reshape(num_votes, b, *v.shape[1:]) for k, v in outputs.items()}
            # Per vote, then averaged: a loss with a sum reduction would read
            # V times too large on the stacked batch.
            loss = torch.stack(
                [self.loss_fn({k: v[i] for k, v in per_vote.items()}, targets)[0] for i in range(num_votes)]
            ).mean()
            out = {"loss": loss}
            for key in ("logits", "seg_logits"):
                if key in per_vote:
                    out[f"{key}_sum"] = per_vote[key].float().sum(0)
        return out

    def evaluate(
        self,
        state: TrainState,
        data: np.ndarray | list,
        labels: np.ndarray,
        masks: np.ndarray | list | None = None,
        parts: np.ndarray | list | None = None,
        num_votes: int = 1,
        shuffle: bool = True,
        seed: int | None = 0,
        keep_points: bool = False,
    ) -> dict:
        """Voting evaluation (evaluate_scenennobjects.py:152-231): per batch,
        the logits summed over ``num_votes`` y-rotations, argmax, and the
        overall, per-class (and seg, per-part) tallies.  No sample is
        dropped: the last partial batch is padded and its padded rows are
        kept out of every tally, so ``total_seen == len(data)``; its loss is
        the padded batch's mean, weighted by the real rows (the loss is
        informational).  Returns the JAX ``Trainer.evaluate``'s dict:
        total_seen, mean_loss, and where the model gives them accuracy,
        avg_class_accuracy, per_class_accuracy, predictions, labels;
        seg_accuracy; per_part_accuracy (-1.0 for unseen parts) and
        avg_part_accuracy; with ``keep_points`` the points (and masks,
        seg_predictions) in eval order.  ``data`` is rectangular [B, N, 3] or
        ragged (``pipeline.is_ragged``: the clouds of ``io.load_data``, with
        ``masks`` and ``parts`` one row a cloud): ``EpochSampler`` then
        subsamples each cloud to ``config.num_point`` points by its own
        draw."""
        cfg = self.config
        sampler = EpochSampler(data, labels, masks=masks, parts=parts, num_points=cfg.num_point, shuffle=shuffle,
                               seed=seed)
        view = sampler.epoch()
        num_classes = cfg.num_classes
        total_seen = total_correct = seg_correct = seg_seen = 0
        loss_sum = 0.0
        seen_class = np.zeros(num_classes, np.int64)
        correct_class = np.zeros(num_classes, np.int64)
        part_seen = part_correct = None  # per-part-id point tallies (evaluate_partseg.py:166-185)
        all_pred, all_label, all_seg_pred = [], [], []
        for batch, valid in padded_batches(view, cfg.batch_size):
            out = self.eval_votes(state, batch, num_votes=num_votes)
            loss_sum += float(out["loss"]) * valid
            if "logits_sum" in out:
                pred = out["logits_sum"][:valid].argmax(1).cpu().numpy()
                labels_np = np.asarray(batch["labels"])[:valid]
                total_correct += int((pred == labels_np).sum())
                for p, l in zip(pred, labels_np):
                    seen_class[l] += 1
                    correct_class[l] += int(p == l)
                all_pred.append(pred)
                all_label.append(labels_np)
            if "seg_logits_sum" in out:
                seg_pred = out["seg_logits_sum"][:valid].argmax(-1).cpu().numpy()
                if keep_points:
                    all_seg_pred.append(seg_pred)
                target = batch.get("masks", batch.get("parts"))
                if target is not None:
                    target = np.asarray(target)[:valid]
                    seg_correct += int((seg_pred == target).sum())
                    seg_seen += seg_pred.size
                    if "parts" in batch:
                        num_parts = out["seg_logits_sum"].shape[-1]
                        if part_seen is None:
                            part_seen = np.zeros(num_parts, np.int64)
                            part_correct = np.zeros(num_parts, np.int64)
                        flat_t = target.reshape(-1)
                        hit = (seg_pred == target).reshape(-1)
                        part_seen += np.bincount(flat_t, minlength=num_parts)
                        part_correct += np.bincount(flat_t, weights=hit, minlength=num_parts).astype(np.int64)
            total_seen += valid

        results = {"total_seen": total_seen, "mean_loss": loss_sum / max(total_seen, 1)}
        if total_seen and seen_class.sum() > 0:
            results["accuracy"] = total_correct / total_seen
            with np.errstate(divide="ignore", invalid="ignore"):
                per_class = np.where(seen_class > 0, correct_class / np.maximum(seen_class, 1), np.nan)
            results["avg_class_accuracy"] = float(np.nanmean(per_class))
            results["per_class_accuracy"] = per_class
            results["predictions"] = np.concatenate(all_pred) if all_pred else np.array([])
            results["labels"] = np.concatenate(all_label) if all_label else np.array([])
        if seg_seen:
            results["seg_accuracy"] = seg_correct / seg_seen
        if part_seen is not None:
            with np.errstate(divide="ignore", invalid="ignore"):
                per_part = np.where(part_seen > 0, part_correct / np.maximum(part_seen, 1), -1.0)
            results["per_part_accuracy"] = per_part
            seen = part_seen > 0
            results["avg_part_accuracy"] = float(per_part[seen].mean()) if seen.any() else 0.0
        if keep_points:
            results["points"] = view["points"]
            if "masks" in view:
                results["masks"] = view["masks"]
            if all_seg_pred:
                results["seg_predictions"] = np.concatenate(all_seg_pred)
        return results
