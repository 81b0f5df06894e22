"""The training step (counterpart of ``scanobjectnn_tpu/train/trainer.py``).

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
Evaluation, checkpoints and ``fit`` wait for the CLI slice.
"""

from __future__ import annotations

import functools
import inspect
from dataclasses import dataclass

import torch
from torch import nn

from scanobjectnn_torch.augment.transforms import pointcnn_augment, standard_train_augment
from scanobjectnn_torch.data.pipeline import Batches, EpochSampler
from scanobjectnn_torch.models import MODEL_REGISTRY, get_model, get_recipe
from scanobjectnn_torch.nn.pointnet_modules import configure_training
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
        ``seed`` (default ``config.seed``) and the trainer's SA settings, its
        Adam optimizer, and the step's generator."""
        seed = self.config.seed if seed is None else seed
        width = "num_parts" if self.kind == "partseg" else "num_classes"
        model = get_model(
            self.config.model, generator=torch.Generator().manual_seed(seed), device=self.device,
            dtype=self.dtype, **{width: self.config.num_classes},
        )
        configure_training(model, self.pool_mode, self.fused_sa_train)
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
        points = torch.as_tensor(batch["points"], dtype=torch.float32, device=self.device)
        targets = {
            k: torch.as_tensor(batch[k], device=self.device).long()
            for k in ("labels", "masks", "parts") if k in batch
        }
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
            if "logits" in outputs:
                labels = targets["labels"]
                metrics["correct"] = (outputs["logits"].argmax(-1) == labels).sum()
                metrics["count"] = labels.new_full((), labels.shape[0])  # no host-to-device copy
            target = targets.get("masks", targets.get("parts"))
            if "seg_logits" in outputs and target is not None:
                metrics["seg_correct"] = (outputs["seg_logits"].argmax(-1) == target).sum()
                metrics["seg_count"] = target.new_full((), target.numel())
        return state, metrics

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
