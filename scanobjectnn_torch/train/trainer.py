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
Every registered model trains in f32 and in bf16 (PointCNN's two with its
recipe, the others plain Adam, as the JAX ``Trainer`` gives them).  The
pool mode reaches only the layers that pool through ``mlp_final_max`` (the
PointNet and PointNet++ families); DGCNN, SpiderCNN, PointCNN and 3DmFV-Net
have none, as in JAX, and their bf16 backward kernels (#14's, the
scatter-add #7, #16's) sum in f32 and cast once, as the JAX Pallas VJPs do.
The PointNet losses take the config's ``reg_weight`` (the T-Nets'
orthogonality penalty).

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
the bucketed kernel (#4, after #5).

The device-resident path, JAX's default (``device_resident``;
``trainer.py:419-734``): a dense dataset is uploaded once and no step of
an epoch or an evaluation copies from the host or reads back to it.
  * ``upload_dataset(data)``: {"points" f32, "labels", and "masks" /
    "parts" where given} as device tensors, the integer dtype of
    ``train_step``'s batches; on a mesh every rank holds the whole set.
  * ``train_epoch_device(state, device_data)``: the epoch's point
    permutation (its first ``num_point`` entries, shared by every cloud)
    and cloud order come from a generator of their own on the device,
    seeded by (``seed``, EPOCH_TAG, ``state.step``) as JAX folds
    ``0xE70C`` and the step into its key, never from ``state.generator``;
    so every rank draws the same, and a resumed run the same epoch.  The
    view ``data[order][:, pt_perm]`` (masks and parts alike) goes in
    ``n_total // batch_size`` slices through the same ``train_step``; the
    metric sums stay on the device and are read back once.  The draws on
    the card are not the CPU's (``randperm`` differs by device), as JAX's
    device draws are not its host sampler's.
  * ``evaluate_device(state, device_data, num_votes, seed, shuffle)``:
    the first ``num_point`` points (``shuffle=False``) or a permutation
    from a generator seeded by ``seed`` (None: a draw of ``np.random``),
    batches padded by repeating the last cloud, ``eval_votes``' arithmetic
    with the vote matrices uploaded once, and every tally on the device
    with padded rows masked out (the loss as the padded batch's mean times
    its valid rows); one readback, JAX's keys and conventions.
  * ``evaluate_auto``: ragged input or ``keep_points`` to ``evaluate``,
    anything else to ``evaluate_device(upload_dataset(...))``; ``fit``,
    the command line and the cross-domain protocols route through it (or
    ``fit``'s own uploads) as JAX's do.

The config's other JAX fields (``trainer.py:54-104``):
  * ``optimizer`` "adam" (above) or "momentum": ``torch.optim.SGD`` with
    ``momentum`` at the same LR schedule, the weight decay added to the
    gradient before the momentum (``optax.sgd`` behind
    ``add_decayed_weights``);
  * ``model_kwargs`` go to ``get_model`` as overrides; ``seg_weight`` and
    ``reg_weight`` go to a loss whose signature declares them;
  * ``augment_rotate`` and ``augment_jitter``: the standard recipe rotates
    and jitters only where asked, PointCNN's skips its transform when both
    are off;
  * ``ops_backend`` "auto" and "pallas" are the port's path (a CUDA tensor
    launches the kernels, a CPU tensor takes the plain versions); "lax"
    runs ``train_step``, ``eval_step`` and ``eval_votes`` inside
    ``ops.cuda.plain_ops()``, the plain versions on any device;
  * ``fused_sa_eval`` "on" or "off" goes to the model's SA layers with
    ``sa_bucket`` (``configure_eval``); "interpret" is a Pallas mode and is
    refused;
  * ``max_epoch``, ``log_dir`` and ``checkpoint_every`` drive ``fit``.

``fit`` follows the JAX ``Trainer.fit`` (``trainer.py:868-985``): the
model line, the recipe line, the sources copied into
``log_dir/src_snapshot``; with ``device_resident`` a dense training set
uploaded once and trained by ``train_epoch_device``, else an
``EpochSampler`` over the training clouds and ``train_epoch``; each
epoch's line and its evaluation's (with ``device_resident`` a dense test
set uploaded once and evaluated by ``evaluate_device``, else ``evaluate``;
both ``shuffle=True`` and ``seed=0``), the best-so-far
accuracy (``accuracy``, else ``seg_accuracy``) saved to
``checkpoint_best`` with ``best.json``, ``metrics.jsonl`` through the
``Logger``, ``checkpoint`` with ``last.json`` every ``checkpoint_every``
epochs, and with ``resume`` the sidecars read back so that no epoch trains
twice and ``checkpoint_best`` is not overwritten by a worse state.  It adds
one line, the kernel backend it runs.  A checkpoint is a directory
(JAX's names) holding one ``torch.save`` file of the model's
``state_dict`` (BN running stats included), the optimizer's, the step and
the step generator's state, beside ``config.json`` and the sidecars;
``restore`` loads it with ``weights_only=True``.  The generator's state
is restored where the checkpoint's generator lived on the same device type
(a CUDA generator's state is not a CPU generator's); elsewhere the
template's generator stays as seeded and ``restore`` logs so.  The
``EpochSampler``'s state is not saved: a resumed run's host shuffles
restart from ``seed``, as in JAX; the resident epoch's draws follow the
restored step.  JAX's orbax checkpoints are not read here;
``convert.load_jax_variables`` takes JAX weights.

Data parallelism, ``Trainer(config, mesh=parallel.make_mesh(...))``: the
step of the global batch that JAX's GSPMD runs over its ``('data',)``
mesh, on the ranks of a process group, one device each (the mesh's, whose
type must be ``config.device``'s).  Without a mesh, or on a mesh without a
group, nothing below happens and no collective is called; a group of one
rank calls every collective, each a copy, so its steps are the no-group
steps bit for bit.  ``batch_size`` is the global batch and must split
evenly over the ranks.
  * The step: every rank passes the same global batch (the same seeded
    sampler), augments all of it from its generator, which stays in step
    with the other ranks', and keeps its own contiguous rows.  Its forward
    runs inside ``parallel.global_batch``: the BatchNorms average their
    moments over the group (``nn.layers.configure_parallel``, set by
    ``init_state``; DGCNN's pair BN too), and so do the fused ops that take
    their statistics (#18's ``dense_bn_exactkey_pool`` and the fused SA
    tail with #17's backward), inside; dropout masks and PointCNN's "ids"
    sampling are this rank's rows of the global batch's draw.  After the
    backward the gradients are averaged over the ranks in one flat
    ``all_reduce`` in parameter order (a parameter without a gradient has
    none on any rank), then the optimizer steps.  A mean loss over equal
    shards averages to the global mean, so the step is the global batch's:
    the CE and per-point means, BGA's ``seg_weight`` term, PointCNN's tiled
    mean, and the weight decay, which the optimizer adds to the averaged
    gradient.  The T-Net penalty is a sum over the batch: a rank's loss
    weighs its shard's sum by ``reg_weight`` times the world size, so the
    ranks' average is the global sum's weight and gradient.
  * ``train_step``'s metrics are this rank's (its shard's loss terms and
    counts; ``mat_diff_loss`` its shard's sum); ``train_epoch`` and
    ``train_epoch_device`` sum their totals over the ranks before they read
    them, the loss terms divided by the world size.
  * Evaluation: ``eval_step`` and ``eval_votes`` take the global batch,
    run this rank's rows of the (vote-stacked) batch and gather every
    rank's outputs (``parallel.gather_rows``), so every rank computes the
    loss, sums and tallies one process computes (``evaluate_device`` too);
    eval BN reads the running statistics and needs no collective.
  * Side effects are rank 0's: its logger writes the files and prints
    (the others' log nothing), and ``save`` and ``snapshot_sources`` write
    on rank 0 only; ``restore`` loads on every rank.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import json
import os
import shutil
import time
from dataclasses import dataclass, field

import numpy as np
import torch
from torch import nn

from scanobjectnn_torch.augment.transforms import (
    jitter_point_cloud, pointcnn_augment, rotate_point_cloud, standard_train_augment,
)
from scanobjectnn_torch.data.pipeline import Batches, EpochSampler, is_ragged, padded_batches
from scanobjectnn_torch.models import MODEL_REGISTRY, get_model, get_recipe
from scanobjectnn_torch.nn.layers import configure_parallel
from scanobjectnn_torch.nn.pointnet_modules import FUSED_SA_EVAL_SETTINGS, configure_eval, configure_training
from scanobjectnn_torch.ops.cuda import plain_ops
from scanobjectnn_torch.ops.cuda.sabucket_kernel import SA_BUCKET_SETTINGS
from scanobjectnn_torch.parallel.mesh import Mesh, batch_sharding, gather_rows, global_batch
from scanobjectnn_torch.train import schedules
from scanobjectnn_torch.utils.logging import Logger

__all__ = ["TrainState", "Trainer", "TrainerConfig"]

ADAM_EPS = 1e-8
DTYPES = {"float32": None, "bfloat16": torch.bfloat16}  # None: the model's f32 default
POOL_MODES = {"native": "0", "f32": "1", "keys": "keys"}
OPTIMIZERS = ("adam", "momentum")
OPS_BACKENDS = ("auto", "pallas", "lax")
CHECKPOINT_FILE = "state.pt"  # in log_dir/checkpoint and log_dir/checkpoint_best
COUNT_METRICS = ("correct", "count", "seg_correct", "seg_count")  # summed over ranks; the rest averaged
EPOCH_TAG = 0xE70C  # the resident epoch's draws, apart from the steps' (JAX trainer.py:439-445)


@dataclass
class TrainerConfig:
    """The JAX ``TrainerConfig``'s fields in its order, then the device
    (reference flags: pointnet2/train.py:25-47)."""

    model: str = "pointnet2_cls_ssg"
    num_classes: int = 15
    num_point: int = 1024  # points a cloud at evaluation
    batch_size: int = 16
    max_epoch: int = 250
    learning_rate: float = 1e-3
    momentum: float = 0.9
    optimizer: str = "adam"  # or "momentum" (module doc)
    decay_step: int = 200_000
    decay_rate: float = 0.7
    seg_weight: float = 0.5
    reg_weight: float = 0.001
    weight_decay: float = 0.0
    dtype: str = "float32"
    seed: int = 0
    log_dir: str | None = None
    augment_rotate: bool = True
    augment_jitter: bool = True
    # Honour the training recipe the model ships with (module doc).
    use_model_recipe: bool = True
    model_kwargs: dict = field(default_factory=dict)
    checkpoint_every: int = 1
    # Keep a dense dataset on the device and run each epoch and evaluation
    # without host traffic a step (module doc).
    device_resident: bool = True
    # "auto" | "pallas" | "lax", and the fused eval SA layer "on" | "off"
    # (module doc).
    ops_backend: str = "auto"
    fused_sa_eval: str = "on"
    # The fused SA training tail, the bucketed eval SA kernel ("auto" |
    # "off") and the SA pool mode, "auto" | "native" | "f32" | "keys"
    # (module doc).
    fused_sa_train: bool = False
    sa_bucket: str = "auto"
    pool_precision: str = "auto"
    device: str = "cuda"


@dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator  # augmentation and dropout draws


class Trainer:
    """Builds, trains, evaluates and checkpoints a registered model on one
    device, or as one rank of ``mesh`` (module doc)."""

    def __init__(self, config: TrainerConfig, logger: Logger | None = None, mesh: Mesh | None = None):
        if config.dtype not in DTYPES:
            raise ValueError(f"dtype must be 'float32' or 'bfloat16', got {config.dtype!r}")
        if config.model not in MODEL_REGISTRY:
            raise KeyError(f"unknown model {config.model!r}; available: {sorted(MODEL_REGISTRY)}")
        pool = config.pool_precision
        if pool == "auto":
            pool = "keys" if config.dtype == "bfloat16" else "native"
        if pool not in POOL_MODES:
            raise ValueError(f"pool_precision must be 'auto' or one of {sorted(POOL_MODES)}, got {pool!r}")
        self.pool_mode, self.fused_sa_train = POOL_MODES[pool], bool(config.fused_sa_train)
        if config.sa_bucket not in SA_BUCKET_SETTINGS:
            raise ValueError(f"sa_bucket must be one of {SA_BUCKET_SETTINGS}, got {config.sa_bucket!r}")
        if config.fused_sa_eval == "interpret":
            raise ValueError("fused_sa_eval='interpret' is a Pallas interpret mode and is not ported: use 'on' or 'off'")
        if config.fused_sa_eval not in FUSED_SA_EVAL_SETTINGS:
            raise ValueError(f"fused_sa_eval must be one of {FUSED_SA_EVAL_SETTINGS}, got {config.fused_sa_eval!r}")
        if config.ops_backend not in OPS_BACKENDS:
            raise ValueError(f"ops_backend must be one of {OPS_BACKENDS}, got {config.ops_backend!r}")
        if config.optimizer not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {config.optimizer!r}")
        self.dtype = DTYPES[config.dtype]
        self.config = config
        self.device = torch.device(config.device)
        self.mesh = mesh
        self.world = 1 if mesh is None else mesh.size
        self.is_main = mesh is None or mesh.rank == 0
        if mesh is not None:
            if mesh.device.type != self.device.type:
                raise ValueError(f"the mesh's device {mesh.device} is not config.device {config.device!r}")
            if config.batch_size % mesh.size:
                raise ValueError(f"batch_size {config.batch_size} does not split over {mesh.size} ranks")
            self.device = mesh.device
        self.logger = logger or (Logger(config.log_dir) if self.is_main else Logger(None, echo=False))
        model_cls = MODEL_REGISTRY[config.model]
        self.kind = model_cls.kind
        # The config's loss flags reach a loss only where its signature
        # declares them (JAX trainer.py:147-155).
        loss_params = inspect.signature(model_cls.loss).parameters
        overrides = {k: getattr(config, k) for k in ("seg_weight", "reg_weight") if k in loss_params}
        self.loss_fn = functools.partial(model_cls.loss, **overrides) if overrides else model_cls.loss
        # A rank's shard's T-Net penalty weighs world times (module doc).
        self.train_loss_kw = ({"reg_weight": config.reg_weight * self.world}
                              if "reg_weight" in overrides and self.world > 1 else {})
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
        ``seed`` (default ``config.seed``), ``model_kwargs`` as overrides,
        and the trainer's SA settings (training, ``fused_sa_eval`` and
        ``sa_bucket``), its optimizer, and the step's generator."""
        cfg = self.config
        seed = cfg.seed if seed is None else seed
        kwargs = dict(cfg.model_kwargs)
        kwargs.setdefault("num_parts" if self.kind == "partseg" else "num_classes", cfg.num_classes)
        kwargs.setdefault("dtype", self.dtype)
        model = get_model(cfg.model, generator=torch.Generator().manual_seed(seed), device=self.device, **kwargs)
        configure_training(model, self.pool_mode, self.fused_sa_train)
        configure_eval(model, cfg.sa_bucket, cfg.fused_sa_eval)
        configure_parallel(model, None if self.mesh is None else self.mesh.group)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        return TrainState(0, model, self.make_optimizer(model.parameters()), generator)

    def param_count(self, state: TrainState) -> int:
        return sum(p.numel() for p in state.model.parameters())

    def make_optimizer(self, params) -> torch.optim.Optimizer:
        """Adam, or SGD with momentum (module doc), at LR ``schedule(0)``."""
        if self.config.optimizer == "momentum":
            return torch.optim.SGD(
                params, lr=self.lr_schedule(0), momentum=self.config.momentum, weight_decay=self.weight_decay
            )
        return torch.optim.Adam(params, lr=self.lr_schedule(0), eps=self.adam_eps, weight_decay=self.weight_decay)

    def optimizer_step(self, optimizer: torch.optim.Optimizer, step: int) -> None:
        """One update at LR ``schedule(step)`` (optax's count)."""
        for group in optimizer.param_groups:
            group["lr"] = self.lr_schedule(step)
        optimizer.step()

    # ------------------------------------------------------------- train step

    def augment(self, points: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        """The step's augmentation: the recipe's PointCNN transform (none
        when both flags are off), or y-rotation then jitter, each where its
        flag asks for it."""
        cfg, recipe = self.config, self.recipe
        if recipe is not None:
            if not (cfg.augment_rotate or cfg.augment_jitter):
                return points
            return pointcnn_augment(points, generator, recipe.jitter, recipe.rotation_range, recipe.scaling_range)
        if cfg.augment_rotate and cfg.augment_jitter:
            return standard_train_augment(points, generator)
        if cfg.augment_rotate:
            return rotate_point_cloud(points, generator)
        if cfg.augment_jitter:
            return jitter_point_cloud(points, generator)
        return points

    def _ops(self):
        """The kernel switch around this trainer's steps: ``plain_ops()``
        under ``ops_backend`` "lax", else nothing."""
        return plain_ops() if self.config.ops_backend == "lax" else contextlib.nullcontext()

    def train_step(self, state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        """One step on ``batch`` ({"points" [B, N, 3], "labels" [B], and
        "masks" or "parts" [B, N] as the model's kind needs}, numpy or
        torch).  Updates ``state`` in place and returns it with the step's
        metrics as device tensors (the loss's terms, then ``correct`` and
        ``count`` and/or ``seg_correct`` and ``seg_count``; on a mesh, this
        rank's: module doc)."""
        with self._ops():
            points, targets = self._on_device(batch)
            points = self.augment(points, state.generator)
            if self.mesh is not None:
                rows = self._rows(points.shape[0])
                points, targets = points[rows], {k: v[rows] for k, v in targets.items()}
            model = state.model.train()
            with global_batch(self.mesh):
                outputs = model(points, bn_momentum=self.bn_schedule(state.step), generator=state.generator)
            loss, metrics = self.loss_fn(outputs, targets, **self.train_loss_kw)
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            self._average_gradients(state.model)
            self.optimizer_step(state.optimizer, state.step)
            state.step += 1
            with torch.no_grad():
                metrics = {k: v.detach() for k, v in metrics.items()}
                metrics.update(self._metrics(outputs, targets))
        return state, metrics

    def _grouped(self) -> bool:
        return self.mesh is not None and self.mesh.group is not None

    def _rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n``."""
        return batch_sharding(self.mesh, self.mesh.axis_name).rows(n)

    def _average_gradients(self, model: nn.Module) -> None:
        """Every gradient averaged over the mesh's ranks: one flat f32
        ``all_reduce`` in parameter order, divided by the world size."""
        if not self._grouped():
            return
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        flat = torch.cat([g.reshape(-1).float() for g in grads])
        torch.distributed.all_reduce(flat, group=self.mesh.group)
        flat /= self.world
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view(g.shape))
            offset += g.numel()

    def _eval_forward(self, model: nn.Module, points: torch.Tensor) -> dict:
        """``model(points)`` in eval mode; on a mesh, this rank's rows of
        ``points`` and then every rank's outputs gathered (module doc)."""
        if not self._grouped():
            return model(points)
        with global_batch(self.mesh):
            outputs = model(points[self._rows(points.shape[0])])

        def gather(tree):
            return {k: gather(v) if isinstance(v, dict) else gather_rows(v, self.mesh) for k, v in tree.items()}

        return gather(outputs)

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
        model gives it (read back once, at the end; on a mesh, of every
        rank's rows)."""
        state, totals, n_batches = self._epoch_totals(state, Batches(sampler.epoch(), self.config.batch_size))
        return state, self._epoch_summary(totals, n_batches)

    def _epoch_totals(self, state: TrainState, batches) -> tuple[TrainState, dict, int]:
        """``train_step`` over ``batches``: the state, each metric's sum as
        a device tensor, and the number of batches."""
        totals: dict[str, torch.Tensor] = {}
        n_batches = 0
        for batch in batches:
            state, metrics = self.train_step(state, batch)
            n_batches += 1
            for k, v in metrics.items():
                totals[k] = totals.get(k, 0) + v.float()
        return state, totals, n_batches

    def _epoch_summary(self, totals: dict, n_batches: int) -> dict:
        """An epoch's summary from its metric sums (on a mesh summed over
        the ranks, the loss terms averaged): one readback."""
        keys = sorted(totals)
        values = []
        if keys:
            summed = torch.stack([totals[k] for k in keys])
            if self._grouped():
                torch.distributed.all_reduce(summed, group=self.mesh.group)
                summed = torch.stack([v if k in COUNT_METRICS else v / self.world for k, v in zip(keys, summed)])
            values = summed.tolist()  # the epoch's one readback
        totals = dict(zip(keys, values))
        summary = {"mean_loss": totals.get("loss", 0.0) / max(n_batches, 1)}
        if "correct" in totals:
            summary["accuracy"] = totals["correct"] / max(totals["count"], 1.0)
        if "seg_correct" in totals:
            summary["seg_accuracy"] = totals["seg_correct"] / max(totals["seg_count"], 1.0)
        return summary

    # ------------------------------------------------ device-resident epochs

    def upload_dataset(self, data: dict) -> dict:
        """A dense dataset on the device, once (module doc): {"points" f32,
        "labels", and "masks" / "parts" where given and not None}."""
        points, targets = self._on_device({k: v for k, v in data.items() if v is not None})
        return {"points": points, **targets}

    def _epoch_permutations(self, step: int, n_points: int, n_total: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The resident epoch at ``step``: the points kept (the first
        ``num_point`` of a permutation of ``n_points``) and the clouds'
        order, drawn from a generator of their own (module doc)."""
        seed = int(np.random.SeedSequence([self.config.seed, EPOCH_TAG, step]).generate_state(1, np.uint64)[0])
        generator = torch.Generator(device=self.device).manual_seed(seed >> 1)
        pt_perm = torch.randperm(n_points, generator=generator, device=self.device)[: self.config.num_point]
        order = torch.randperm(n_total, generator=generator, device=self.device)
        return pt_perm, order

    def _epoch_view(self, step: int, data: dict) -> dict:
        """The resident epoch's view of ``data`` (``upload_dataset``'s):
        ``data[order][:, pt_perm]``, masks and parts alike."""
        pt_perm, order = self._epoch_permutations(step, data["points"].shape[1], data["labels"].shape[0])
        view = {"points": data["points"][order][:, pt_perm], "labels": data["labels"][order]}
        for k in ("masks", "parts"):
            if k in data:
                view[k] = data[k][order][:, pt_perm]
        return view

    def _epoch_impl(self, state: TrainState, data: dict) -> tuple[TrainState, dict, int]:
        """The resident epoch up to its readback: ``train_step`` over the
        view's ``n_total // batch_size`` slices, the metric sums on the
        device."""
        return self._epoch_totals(state, Batches(self._epoch_view(state.step, data), self.config.batch_size))

    def train_epoch_device(self, state: TrainState, device_data: dict) -> tuple[TrainState, dict]:
        """One epoch over ``upload_dataset``'s tensors (module doc); returns
        the state and ``train_epoch``'s summary."""
        state, totals, n_batches = self._epoch_impl(state, device_data)
        return state, self._epoch_summary(totals, n_batches)

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

    @staticmethod
    def _rotate(points: torch.Tensor, rots: torch.Tensor) -> torch.Tensor:
        """points [B, N, 3] times each matrix of ``rots`` [V, 3, 3] (on the
        device): [V, B, N, 3], each row ``(x·R0 + y·R1) + z·R2`` in f32 (no
        TF32)."""
        r = rots[:, None, None]  # [V, 1, 1, 3, 3]
        p = points[None]
        return (p[..., 0:1] * r[..., 0, :] + p[..., 1:2] * r[..., 1, :]) + p[..., 2:3] * r[..., 2, :]

    def eval_step(self, state: TrainState, batch: dict, rotate_angle: float = 0.0) -> dict:
        """The model in eval mode on ``batch`` turned by ``rotate_angle``
        about the y axis: {"loss", the model's outputs but "end_points", and
        the metrics of ``train_step``}, device tensors."""
        points, targets = self._on_device(batch)
        c, s = np.cos(float(rotate_angle)), np.sin(float(rotate_angle))
        rot = torch.tensor([[[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]]], dtype=torch.float32, device=self.device)
        model = state.model.eval()
        with torch.no_grad(), self._ops():
            outputs = self._eval_forward(model, self._rotate(points, rot)[0])
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
        return self._votes(state, points, targets, self._rotations(num_votes))

    def _rotations(self, num_votes: int) -> torch.Tensor:
        """``_vote_rotations`` on the device."""
        return torch.from_numpy(self._vote_rotations(num_votes)).to(self.device)

    def _votes(self, state: TrainState, points: torch.Tensor, targets: dict, rots: torch.Tensor) -> dict:
        """``eval_votes`` on device tensors, the vote matrices ``rots``
        [V, 3, 3] given."""
        num_votes = rots.shape[0]
        b, n, _ = points.shape
        model = state.model.eval()
        with torch.no_grad(), self._ops():
            stacked = self._rotate(points, rots).reshape(num_votes * b, n, 3)

            def by_vote(tree):  # every tensor, end_points' too, [V·B, ...] -> [V, B, ...]
                return {k: by_vote(v) if isinstance(v, dict) else v.reshape(num_votes, b, *v.shape[1:])
                        for k, v in tree.items()}

            def vote(tree, i):
                return {k: vote(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}

            per_vote = by_vote(self._eval_forward(model, stacked))
            # Per vote, then averaged: a loss with a sum reduction (PointNet's
            # orthogonality penalty) would read V times too large on the
            # stacked batch.
            loss = torch.stack([self.loss_fn(vote(per_vote, i), targets)[0] for i in range(num_votes)]).mean()
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

        results = self._tally_results(
            total_seen, loss_sum, total_correct, seen_class, correct_class,
            np.concatenate(all_pred) if all_pred else np.array([]),
            np.concatenate(all_label) if all_label else np.array([]), seg_correct, seg_seen, part_seen, part_correct,
        )
        if keep_points:
            results["points"] = view["points"]
            if "masks" in view:
                results["masks"] = view["masks"]
            if all_seg_pred:
                results["seg_predictions"] = np.concatenate(all_seg_pred)
        return results

    def _eval_points(self, n_points: int, seed: int | None) -> torch.Tensor:
        """The points ``evaluate_device`` keeps of ``n_points``: all of
        them up to ``num_point``; else the first ``num_point`` (``seed``
        None: no shuffle) or those of a permutation drawn from ``seed``."""
        num_point = self.config.num_point
        if num_point >= n_points:
            return torch.arange(n_points, device=self.device)
        if seed is None:
            return torch.arange(num_point, device=self.device)
        generator = torch.Generator(device=self.device).manual_seed(int(seed))
        return torch.randperm(n_points, generator=generator, device=self.device)[:num_point]

    def _eval_epoch_impl(self, state: TrainState, data: dict, rots: torch.Tensor,
                         pt_perm: torch.Tensor) -> tuple[dict, int]:
        """``evaluate_device`` up to its readback: every tally, the
        predictions and the labels as device tensors, and the points
        segmented (an int the shapes give)."""
        cfg, dev = self.config, self.device
        n_total, bsz, num_classes = data["labels"].shape[0], cfg.batch_size, cfg.num_classes
        n_batches = -(-n_total // bsz)
        view = {"points": data["points"][:, pt_perm], "labels": data["labels"]}
        for k in ("masks", "parts"):
            if k in data:
                view[k] = data[k][:, pt_perm]

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.int64, device=dev)

        sums = {"loss_sum": torch.zeros((), device=dev), "correct": zeros(), "seen_class": zeros(num_classes),
                "correct_class": zeros(num_classes), "seg_correct": zeros(), "predictions": zeros(n_batches * bsz)}
        seg_count = 0
        for i in range(n_batches):
            start = i * bsz
            valid = min(bsz, n_total - start)
            take = torch.arange(start, start + bsz, device=dev).clamp_(max=n_total - 1)  # pad: the last cloud
            targets = {k: v[take] for k, v in view.items()}
            out = self._votes(state, targets.pop("points"), targets, rots)
            is_valid = torch.arange(bsz, device=dev) < valid
            sums["loss_sum"] += out["loss"].float() * valid  # the padded batch's mean x its valid rows
            if "logits_sum" in out:
                pred = out["logits_sum"].argmax(1)
                hit = (pred == targets["labels"]) & is_valid
                onehot = self._one_hot(targets["labels"], num_classes) & is_valid[:, None]
                sums["correct"] += hit.sum()
                sums["seen_class"] += onehot.sum(0)
                sums["correct_class"] += (onehot & hit[:, None]).sum(0)
                sums["predictions"][start:start + bsz] = pred
            target = targets.get("masks", targets.get("parts"))
            if "seg_logits_sum" in out and target is not None:
                seg_pred = out["seg_logits_sum"].argmax(-1)
                seg_hit = (seg_pred == target) & is_valid[:, None]
                sums["seg_correct"] += seg_hit.sum()
                seg_count += valid * target.shape[1]
                if "parts" in targets:  # per-part-id tallies at the seg head's width
                    onehot = self._one_hot(target, out["seg_logits_sum"].shape[-1]) & is_valid[:, None, None]
                    sums["part_seen"] = sums.get("part_seen", 0) + onehot.sum((0, 1))
                    sums["part_correct"] = sums.get("part_correct", 0) + (onehot & seg_hit[..., None]).sum((0, 1))
        sums["labels"] = data["labels"]
        return sums, seg_count

    @staticmethod
    def _one_hot(ids: torch.Tensor, width: int) -> torch.Tensor:
        """``ids``' one-hot rows as booleans, an id outside [0, width) a row
        of zeros (``jax.nn.one_hot``'s rule; no check that reads the ids
        back)."""
        return ids[..., None] == torch.arange(width, device=ids.device)

    def evaluate_device(
        self,
        state: TrainState,
        device_data: dict,
        num_votes: int = 1,
        seed: int | None = 0,
        shuffle: bool = True,
    ) -> dict:
        """Voting evaluation over ``upload_dataset``'s tensors (module doc):
        the dict of ``evaluate`` without ``keep_points``' keys, NaN for an
        unseen class, -1.0 for an unseen part, from one readback."""
        if shuffle and seed is None:
            seed = np.random.randint(0, 2**31 - 1)  # a fresh subsample a call, as evaluate's
        pt_perm = self._eval_points(device_data["points"].shape[1], seed if shuffle else None)
        sums, seg_count = self._eval_epoch_impl(state, device_data, self._rotations(num_votes), pt_perm)
        keys = sorted(sums)
        flat = torch.cat([sums[k].double().reshape(-1) for k in keys]).cpu().numpy()  # the one readback
        got = dict(zip(keys, np.split(flat, np.cumsum([sums[k].numel() for k in keys])[:-1])))
        n_total = int(device_data["labels"].shape[0])
        return self._tally_results(
            n_total, float(got["loss_sum"][0]), float(got["correct"][0]), got["seen_class"], got["correct_class"],
            got["predictions"][:n_total].astype(np.int64), got["labels"].astype(np.int64),
            float(got["seg_correct"][0]), seg_count, got.get("part_seen"), got.get("part_correct"),
        )

    @staticmethod
    def _tally_results(total_seen, loss_sum, correct, seen_class, correct_class, predictions, labels, seg_correct,
                       seg_seen, part_seen=None, part_correct=None) -> dict:
        """The results dict of ``evaluate`` and ``evaluate_device`` from
        their tallies (numpy per-class and per-part counts): the class keys
        where some class was seen (NaN for an unseen class), seg accuracy
        where points were, the per-part table where parts were tallied
        (-1.0 for an unseen part, the mean over the seen ones)."""
        results = {"total_seen": total_seen, "mean_loss": loss_sum / max(total_seen, 1)}
        if total_seen and seen_class.sum() > 0:
            results["accuracy"] = correct / total_seen
            with np.errstate(divide="ignore", invalid="ignore"):
                per_class = np.where(seen_class > 0, correct_class / np.maximum(seen_class, 1), np.nan)
            results["avg_class_accuracy"] = float(np.nanmean(per_class))
            results["per_class_accuracy"] = per_class
            results["predictions"] = predictions
            results["labels"] = labels
        if seg_seen:
            results["seg_accuracy"] = seg_correct / seg_seen
        if part_seen is not None:
            with np.errstate(divide="ignore", invalid="ignore"):
                per_part = np.where(part_seen > 0, part_correct / np.maximum(part_seen, 1), -1.0)
            results["per_part_accuracy"] = per_part
            seen = part_seen > 0
            results["avg_part_accuracy"] = float(per_part[seen].mean()) if seen.any() else 0.0
        return results

    def evaluate_auto(
        self,
        state: TrainState,
        data,
        labels,
        masks=None,
        parts=None,
        num_votes: int = 1,
        shuffle: bool = True,
        seed: int | None = 0,
        keep_points: bool = False,
    ) -> dict:
        """One voting evaluation, routed as JAX's (``trainer.py:702-734``):
        ragged input or ``keep_points`` to ``evaluate``, anything else to
        ``evaluate_device`` over ``upload_dataset``."""
        if keep_points or is_ragged(data):
            return self.evaluate(state, data, labels, masks=masks, parts=parts, num_votes=num_votes, shuffle=shuffle,
                                 seed=seed, keep_points=keep_points)
        device_data = self.upload_dataset({"points": data, "labels": labels, "masks": masks, "parts": parts})
        return self.evaluate_device(state, device_data, num_votes=num_votes, shuffle=shuffle, seed=seed)

    # ------------------------------------------------------------------- fit

    def fit(
        self,
        train_data: dict,
        test_data: dict | None = None,
        state: TrainState | None = None,
        num_votes: int = 1,
        resume: bool = False,
    ) -> TrainState:
        """Train ``config.max_epoch`` epochs (module doc): ``train_data``
        and ``test_data`` are {"points" (rectangular or ragged), "labels",
        and "masks" or "parts" where the model reads them}."""
        cfg = self.config
        resumed = False
        if state is None:
            state = self.init_state()
            if resume and cfg.log_dir:
                restored = self.restore(state)
                if restored is not None:
                    state, resumed = restored, True
        self.logger.log(f"model={cfg.model} params={self.param_count(state):,} devices={self.world}")
        plain = cfg.ops_backend == "lax" or self.device.type == "cpu"
        self.logger.log(f"ops_backend={cfg.ops_backend} device={self.device} "
                        f"({'the plain versions' if plain else 'the CUDA kernels'})")
        if self.recipe is not None:
            self.logger.log(f"recipe={self.recipe}")
        if cfg.log_dir:
            self.snapshot_sources()
        device_data = sampler = None
        if cfg.device_resident and not is_ragged(train_data["points"]):
            device_data = self.upload_dataset(train_data)
        else:
            sampler = EpochSampler(
                train_data["points"], train_data["labels"],
                masks=train_data.get("masks"), parts=train_data.get("parts"),
                num_points=cfg.num_point, seed=cfg.seed,
            )
        device_test = None
        if test_data is not None and cfg.device_resident and not is_ragged(test_data["points"]):
            device_test = self.upload_dataset(test_data)
        best_acc = -1.0  # best-so-far tracking (3DmFV-Net/train.py:232-237)
        best_avg_cls = -1.0
        start_epoch = 0
        if resumed:
            # The sidecars: a resumed run neither overwrites checkpoint_best
            # with a worse state nor trains a finished epoch again.
            bj = self._load_sidecar("best.json")
            best_acc = float(bj.get("accuracy", best_acc))
            best_avg_cls = float(bj.get("avg_class_accuracy", best_avg_cls))
            lj = self._load_sidecar("last.json")
            start_epoch = int(lj.get("epoch", -1)) + 1
            self.logger.log(f"resumed at epoch {start_epoch} (best_acc={best_acc:.4f})")
        for epoch in range(start_epoch, cfg.max_epoch):
            t0 = time.time()
            if sampler is None:
                state, summary = self.train_epoch_device(state, device_data)
            else:
                state, summary = self.train_epoch(state, sampler)
            msg = f"epoch {epoch:03d} " + " ".join(f"{k}={v:.4f}" for k, v in summary.items())
            self.logger.log(f"{msg} ({time.time() - t0:.1f}s)")
            scalars = {f"train_{k}": v for k, v in summary.items()}
            if test_data is not None:
                t_ev = time.time()
                if device_test is not None:
                    ev = self.evaluate_device(state, device_test, num_votes=num_votes)
                else:
                    ev = self.evaluate(
                        state, test_data["points"], test_data["labels"],
                        masks=test_data.get("masks"), parts=test_data.get("parts"), num_votes=num_votes,
                    )
                scalars["eval_seconds"] = time.time() - t_ev
                numbers = {k: v for k, v in ev.items() if isinstance(v, (int, float))}
                self.logger.log("  eval " + " ".join(f"{k}={v:.4f}" for k, v in numbers.items()))
                scalars.update({f"eval_{k}": v for k, v in numbers.items()})
                acc = ev.get("accuracy", ev.get("seg_accuracy", -1.0))
                if acc > best_acc:
                    best_acc = acc
                    best_avg_cls = ev.get("avg_class_accuracy", -1.0)
                    if cfg.log_dir:
                        self.save(state, best=True, meta={
                            "accuracy": float(best_acc), "avg_class_accuracy": float(best_avg_cls),
                        })
                scalars["best_accuracy"] = best_acc
            self.logger.scalars(int(state.step), epoch=epoch, **scalars)
            if cfg.log_dir and (epoch + 1) % cfg.checkpoint_every == 0:
                self.save(state, meta={"epoch": epoch})
        if test_data is not None:
            self.logger.log(f"Best test accuracy: {best_acc:f}")
            if best_avg_cls >= 0:  # partseg has no per-class cls accuracy
                self.logger.log(f"Best test class accuracy: {best_avg_cls:f}")
        return state

    # ------------------------------------------------------------ checkpoints

    def _ckpt_dir(self, best: bool = False) -> str:
        assert self.config.log_dir
        return os.path.join(os.path.abspath(self.config.log_dir), "checkpoint_best" if best else "checkpoint")

    def save(self, state: TrainState, best: bool = False, meta: dict | None = None) -> None:
        """``state`` into ``checkpoint`` (or ``checkpoint_best``), then
        ``config.json`` and the sidecar ``last.json`` (``best.json``):
        {"step", **meta}.  Rank 0's alone on a mesh."""
        if not self.is_main:
            return
        path = self._ckpt_dir(best=best)
        os.makedirs(path, exist_ok=True)
        payload = {
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "step": int(state.step),
            "generator": state.generator.get_state(),
            "generator_device": state.generator.device.type,
        }
        tmp = os.path.join(path, CHECKPOINT_FILE + ".tmp")
        torch.save(payload, tmp)
        os.replace(tmp, os.path.join(path, CHECKPOINT_FILE))
        with open(os.path.join(os.path.dirname(path), "config.json"), "w") as f:
            json.dump({k: v for k, v in self.config.__dict__.items() if not callable(v)}, f, default=str, indent=2)
        sidecar = "best.json" if best else "last.json"
        with open(os.path.join(os.path.dirname(path), sidecar), "w") as f:
            json.dump({"step": int(state.step), **(meta or {})}, f)

    def _load_sidecar(self, name: str) -> dict:
        path = os.path.join(os.path.abspath(self.config.log_dir), name)
        if os.path.isfile(path):
            with open(path) as f:
                return json.load(f)
        return {}

    def snapshot_sources(self) -> None:
        """Copy the model's source module and this trainer's into
        ``log_dir/src_snapshot`` (pointnet2/train.py:72-74); rank 0 alone
        on a mesh."""
        if not self.is_main:
            return
        dst = os.path.join(os.path.abspath(self.config.log_dir), "src_snapshot")
        os.makedirs(dst, exist_ok=True)
        for obj in (MODEL_REGISTRY[self.config.model], Trainer):
            src = inspect.getsourcefile(obj)
            if src and os.path.isfile(src):
                shutil.copy2(src, dst)

    def restore(self, template: TrainState, best: bool = False) -> TrainState | None:
        """The checkpoint loaded into ``template``'s model, optimizer, step
        and generator (module doc); None where there is no checkpoint."""
        path = self._ckpt_dir(best=best)
        if not os.path.isdir(path):
            return None
        ckpt = torch.load(os.path.join(path, CHECKPOINT_FILE), map_location=self.device, weights_only=True)
        template.model.load_state_dict(ckpt["model"])
        template.optimizer.load_state_dict(ckpt["optimizer"])
        for st in template.optimizer.state.values():
            if torch.is_tensor(st.get("step")):
                st["step"] = st["step"].cpu()  # where a new optimizer keeps it
        template.step = int(ckpt["step"])
        if ckpt["generator_device"] == template.generator.device.type:
            template.generator.set_state(ckpt["generator"].cpu())
        else:
            self.logger.log(
                f"restore: the checkpoint's {ckpt['generator_device']} generator state does not apply to a "
                f"{template.generator.device.type} generator; its draws restart from the template's seed"
            )
        return template
