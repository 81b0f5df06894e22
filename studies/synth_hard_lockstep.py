#!/usr/bin/env python3
"""The synthetic-hard harness's training held step by step against the JAX
package on the CPU:

    JAX_PLATFORMS=cpu python3 studies/synth_hard_lockstep.py --model pointcnn_cls --steps 50

Three trajectories of one row (``scanobjectnn_torch.train.synth_hard.ROWS``)
start from the JAX ``Trainer.init_state(0)`` weights, carried into the port
by ``convert.load_jax_variables``, and train on the same inputs:

  * the JAX step in float64, the reference: the row's model built with
    ``dtype=float64`` and a ``jnp`` that reads ``float32`` as float64 bound
    into the JAX modules the model runs (as the port's float64 step tests
    do), then the JAX ``Trainer``'s optax transform;
  * the JAX ``Trainer``'s own step in f32 (``_train_step_impl``);
  * the port's ``Trainer.train_step`` in f32 on the CPU.

Shared inputs: the harness's data (``build_data(256)``), JAX's resident
epoch (its per-epoch point permutation and cloud order, ``trainer.py``'s
``_epoch_impl`` keys) and JAX's augmented points (``Trainer._augment`` on
each step's key), fed to all three with the port's augmentation off.
Dropout is off on both sides without an edit to either model: the JAX
models take ``model_kwargs`` (``dropout_keep``, ``seg_dropout_keep``, or
a PointCNN setting whose FC rates are 0) and the port's models the same
attributes.  Everything else is the harness's configuration (batch 24,
N=128, learning rate 1e-3, seed 0, ``augment_rotate=False``; PointCNN's
recipe).

At every step it records the three losses, and for every parameter and BN
running statistic its relative distance ``|x - x64| / |x64|`` from the
float64 trajectory, for JAX f32 and the port.  A tensor is a fault where the
port's distance exceeds ``--factor`` (4) times JAX f32's at every step from
some step on to the window's end and grows over that stretch; the first such
step and tensor are reported.  Every ``--grad_every`` steps (and at the last
step) the three sides' gradients are taken at the float64 trajectory's
state (cast to f32 for the f32 sides) on that step's batch, and each f32
side's relative gradient error is reported tensor by tensor.

At the window's end the JAX f32 state is evaluated on the 360 test clouds
(``evaluate_auto``, ``shuffle=False``, one vote) by JAX and, converted, by
the port; the predictions that differ are listed with the JAX logits' top-2
margin, and the seg accuracies are compared.

Writes the per-step record as json to ``--json`` where given and prints a
summary.  It imports both packages, as the tests do; nothing in the port
imports it.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import os
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

BATCH, NUM_POINT, EPOCH_TAG = 24, 128, 0xE70C


def _dropout_off(model: str, side: str) -> dict:
    """The row's dropout-off settings: JAX ``model_kwargs`` (``side`` "jax")
    or the port's model attributes (``side`` "port")."""
    if model.startswith("pointcnn"):
        if side == "jax":
            from scanobjectnn_tpu.models import pointcnn as module
        else:
            from scanobjectnn_torch.models import pointcnn as module
        setting = (module.modelnet_x3_l4 if model == "pointcnn_cls" else module.object_dataset_x3)()
        zero = {f: tuple(module.FCParam(p.C, 0.0) for p in getattr(setting, f))
                for f in ("fc_params", "fc_params_classification", "fc_params_segmentation")}
        return {"setting": dataclasses.replace(setting, **zero)}
    out = {"dropout_keep": 1.0}
    if model == "dgcnn_bga":
        out["seg_dropout_keep"] = 1.0
    return out


def _row(model: str):
    from scanobjectnn_torch.train import synth_hard

    return next(r for r in synth_hard.ROWS if r[0] == model and r[2] == "float32")


def _config_kwargs(model: str, supervision) -> dict:
    """The fields both harnesses give the row's ``TrainerConfig``."""
    return dict(model=model, num_classes=3 if supervision == "parts" else 6, num_point=NUM_POINT,
                batch_size=BATCH, max_epoch=150, learning_rate=1e-3, seed=0, dtype="float32",
                augment_rotate=False)


def _targets(supervision) -> tuple[str, ...]:
    return ("labels", "masks") if supervision is True else ("labels", "parts") if supervision == "parts" else (
        "labels",)


class _Jnp64(types.ModuleType):
    """``jax.numpy`` with ``float32`` read as float64."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _jax_modules():
    """The JAX modules whose ``jnp.float32`` casts the float64 step reads as
    float64."""
    from scanobjectnn_tpu.models import dgcnn, losses, pointcnn, pointnet2
    from scanobjectnn_tpu.nn import layers, pointnet_modules, xconv
    from scanobjectnn_tpu.ops import grouping, interpolate
    from scanobjectnn_tpu.ops.pallas import edge_kernel

    return (dgcnn, losses, pointcnn, pointnet2, layers, pointnet_modules, xconv, grouping, interpolate, edge_kernel)


@contextlib.contextmanager
def float64():
    """x64 on, and ``_Jnp64`` bound into ``_jax_modules()`` (restored after)."""
    modules = _jax_modules()
    saved = [m.jnp for m in modules]
    try:
        for m in modules:
            m.jnp = _Jnp64("jnp")
        with jax.enable_x64(True):
            yield
    finally:
        for m, j in zip(modules, saved):
            m.jnp = j


def _flat(tree) -> dict:
    from scanobjectnn_torch.convert import _flatten

    return {k: np.asarray(v, np.float64) for k, v in _flatten(tree)}


def _measurable(ref: np.ndarray) -> bool:
    """A tensor whose float64 value is not about 0: the Dense biases that
    feed a training-mode BN have a true gradient of 0, so they stay near 0
    and a distance relative to them reads rounding noise."""
    return float(np.abs(ref).max()) > 1e-6


def _distance(a: np.ndarray, ref: np.ndarray) -> float:
    return float(np.linalg.norm((a - ref).ravel()) / max(np.linalg.norm(ref.ravel()), 1e-30))


class Lockstep:
    """The three trajectories of one row (module doc)."""

    def __init__(self, model: str):
        from scanobjectnn_tpu import models as jzoo
        from scanobjectnn_tpu.train import Trainer as JTrainer, TrainerConfig as JConfig
        from scanobjectnn_torch.convert import load_jax_variables
        from scanobjectnn_torch.train import synth_hard
        from scanobjectnn_torch.train.trainer import Trainer, TrainerConfig

        self.model = model
        _, self.supervision, _ = _row(model)
        self.keys = _targets(self.supervision)
        self.train, self.test = synth_hard.build_data(2 * NUM_POINT)
        cfg = _config_kwargs(model, self.supervision)
        self.jt = JTrainer(JConfig(**cfg, model_kwargs=_dropout_off(model, "jax")))
        self.augment = self.jt._augment  # JAX's augmentation, applied here and fed to all three
        self.jt._augment = lambda key, points: points
        self.rng = jax.random.PRNGKey(0)
        self.j32 = self.jt.init_state(self.rng)  # Trainer.fit's init_state(PRNGKey(seed))
        self._j32_step = jax.jit(self.jt._train_step_impl)

        fields = {f.name for f in dataclasses.fields(self.jt.model)}
        overrides = {k: getattr(self.jt.model, k) for k in ("num_classes", "num_parts", "seg_classes") if k in fields}
        overrides.update(_dropout_off(model, "jax"))
        with float64():
            self.model64 = jzoo.get_model(model, dtype=jnp.float64, **overrides)[0]
            cast = lambda tree: jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)), tree)
            self.p64, self.s64 = cast(self.j32.params), cast(self.j32.batch_stats)
            self.o64 = self.jt.tx.init(self.p64)
            self._j64_step = jax.jit(self._step64)
            self._j64_grad = jax.jit(self._grads(self.model64))
        self._j32_grad = jax.jit(self._grads(self.jt.model))

        port_cfg = TrainerConfig(**cfg, augment_jitter=False, device="cpu")
        self.pt = Trainer(port_cfg)
        self.port = self._port_state(load_jax_variables)
        self.probe = self._port_state(load_jax_variables)
        self.step = 0

    def _port_state(self, load):
        state = self.pt.init_state()
        for name, value in _dropout_off(self.model, "port").items():
            if name == "setting":  # the heads' rates, the setting's FC params
                for head in (m for m in state.model.modules() if hasattr(m, "rates")):
                    head.rates = tuple(0.0 for _ in head.rates)
            else:
                setattr(state.model, name, value)
        load(state.model, {"params": self.j32.params, "batch_stats": self.j32.batch_stats})
        return state

    def _grads(self, model):
        def grads(params, stats, points, targets, step):
            def loss(p):
                out, _ = model.apply({"params": p, "batch_stats": stats}, points, train=True,
                                     bn_momentum=self.jt.bn_schedule(step), mutable=["batch_stats"])
                return self.jt._loss_fn(out, targets)[0]

            return jax.grad(loss)(params)

        return grads

    def _step64(self, params, stats, opt_state, points, targets, step):
        import optax

        def loss_fn(p):
            out, mut = self.model64.apply({"params": p, "batch_stats": stats}, points, train=True,
                                          bn_momentum=self.jt.bn_schedule(step), mutable=["batch_stats"])
            loss, _ = self.jt._loss_fn(out, targets)
            return loss, mut["batch_stats"]

        (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = self.jt.tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_stats, opt_state, loss

    # ------------------------------------------------------------ the inputs

    def epoch_view(self, epoch: int) -> dict:
        """JAX's resident epoch at step ``25·epoch`` (``_epoch_impl``'s keys)."""
        n_total = self.train["labels"].shape[0]
        key = jax.random.fold_in(jax.random.fold_in(self.rng, EPOCH_TAG), epoch * (n_total // BATCH))
        k_pts, k_order = jax.random.split(key)
        pt_perm = np.asarray(jax.random.permutation(k_pts, self.train["points"].shape[1])[:NUM_POINT])
        order = np.asarray(jax.random.permutation(k_order, n_total))
        view = {"points": self.train["points"][order][:, pt_perm].astype(np.float32),
                "labels": self.train["labels"][order].astype(np.int32)}
        for k in self.keys[1:]:
            view[k] = self.train[k][order][:, pt_perm].astype(np.int32)
        return view

    def batch(self, view: dict, i: int, step: int) -> dict:
        """Batch ``i`` of ``view`` with JAX's augmentation at ``step``."""
        batch = {k: v[i * BATCH:(i + 1) * BATCH] for k, v in view.items()}
        aug_rng, _ = jax.random.split(jax.random.fold_in(self.rng, step))
        batch["points"] = np.asarray(self.augment(aug_rng, jnp.asarray(batch["points"])), np.float32)
        return batch

    # ------------------------------------------------------------ one step

    def advance(self, batch: dict) -> dict:
        """One step of each trajectory on ``batch``: the three losses."""
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        self.j32, m32 = self._j32_step(self.j32, jb, self.rng)
        with float64():
            targets = {k: jnp.asarray(batch[k]) for k in self.keys}
            self.p64, self.s64, self.o64, loss64 = self._j64_step(
                self.p64, self.s64, self.o64, jnp.asarray(batch["points"]), targets, jnp.asarray(self.step, jnp.int32))
            loss64 = float(loss64)
        self.port, mp = self.pt.train_step(self.port, {k: np.asarray(v) for k, v in batch.items()})
        self.step += 1
        return {"f64": loss64, "jax32": float(m32["loss"]), "port": float(mp["loss"])}

    def distances(self) -> tuple[dict, list]:
        """Per tensor: [JAX f32, port] relative distances from float64; and
        the same over all parameters at once."""
        ref = {**_flat(self.p64), **_flat(self.s64)}
        jax32 = {**_flat(self.j32.params), **_flat(self.j32.batch_stats)}
        port = {k: v.detach().double().numpy() for k, v in
                [*self.port.model.named_parameters(), *self.port.model.named_buffers()]}
        names = list(_flat(self.p64))
        whole = [_distance(np.concatenate([side[k].ravel() for k in names]),
                           np.concatenate([ref[k].ravel() for k in names])) for side in (jax32, port)]
        return {k: [_distance(jax32[k], r), _distance(port[k], r)] for k, r in ref.items() if _measurable(r)}, whole

    def grad_probe(self, batch: dict, step: int) -> dict:
        """Per parameter: [JAX f32, port] relative gradient error against the
        float64 gradient, all three at the float64 state on ``batch``."""
        from scanobjectnn_torch.convert import load_jax_variables

        with float64():
            targets64 = {k: jnp.asarray(batch[k]) for k in self.keys}
            g64 = _flat(self._j64_grad(self.p64, self.s64, jnp.asarray(batch["points"]), targets64,
                                       jnp.asarray(step, jnp.int32)))
            p32 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), self.p64)
            s32 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), self.s64)
        targets = {k: jnp.asarray(batch[k]) for k in self.keys}
        g32 = _flat(self._j32_grad(p32, s32, jnp.asarray(batch["points"]), targets, jnp.asarray(step, jnp.int32)))
        model = load_jax_variables(self.probe.model, {"params": p32, "batch_stats": s32}).train()
        points, tt = self.pt._on_device(batch)
        out = model(points, bn_momentum=self.pt.bn_schedule(step), generator=self.probe.generator)
        model.zero_grad(set_to_none=True)
        self.pt.loss_fn(out, tt)[0].backward()
        gp = {k: p.grad.double().numpy() for k, p in model.named_parameters()}
        return {k: [_distance(g32[k], r), _distance(gp[k], r)] for k, r in g64.items() if _measurable(r)}

    # ------------------------------------------------------------ evaluation

    def evaluate(self) -> dict:
        """The JAX f32 end state on the test set by both packages (module doc)."""
        from scanobjectnn_torch.convert import load_jax_variables

        test = self.test
        kw = {"masks": test["masks"]} if "masks" in self.keys else {"parts": test["parts"]} if "parts" in self.keys \
            else {}
        jev = self.jt.evaluate_auto(self.j32, test["points"], test["labels"], num_votes=1, shuffle=False, **kw)
        model = load_jax_variables(copy.deepcopy(self.probe.model),
                                   {"params": self.j32.params, "batch_stats": self.j32.batch_stats})
        pstate = dataclasses.replace(self.probe, model=model)
        pev = self.pt.evaluate_auto(pstate, test["points"], test["labels"], num_votes=1, shuffle=False, **kw)
        out = {k: [float(jev[k]), float(pev[k])] for k in ("accuracy", "seg_accuracy", "avg_part_accuracy")
               if k in jev}
        # Logits for the margins: both sides' eval_votes on the same batches.
        jl, pl, js, ps = [], [], [], []
        pts = test["points"][:, :NUM_POINT].astype(np.float32)
        for i in range(0, len(pts), BATCH):
            b = {"points": pts[i:i + BATCH], **{k: test[k][i:i + BATCH, :NUM_POINT] if k != "labels" else
                                                 test[k][i:i + BATCH] for k in self.keys}}
            jo = self.jt.eval_votes(self.j32, b, num_votes=1)
            po = self.pt.eval_votes(pstate, b, num_votes=1)
            if "logits_sum" in jo:
                jl.append(np.asarray(jo["logits_sum"]))
                pl.append(po["logits_sum"].numpy())
            if "seg_logits_sum" in jo:
                js.append(np.asarray(jo["seg_logits_sum"]))
                ps.append(po["seg_logits_sum"].numpy())
        if jl:
            out["cls"] = _disagreements(np.concatenate(jl), np.concatenate(pl))
        if js:
            out["seg"] = _disagreements(np.concatenate(js).reshape(-1, js[0].shape[-1]),
                                        np.concatenate(ps).reshape(-1, ps[0].shape[-1]))
        return out


def _disagreements(jax_logits: np.ndarray, port_logits: np.ndarray) -> dict:
    """Rows whose argmax differs, with the JAX logits' top-2 margin at each,
    beside the median margin of all rows."""
    top2 = np.sort(jax_logits, axis=-1)[:, -2:]
    margin = top2[:, 1] - top2[:, 0]
    differ = np.nonzero(jax_logits.argmax(-1) != port_logits.argmax(-1))[0]
    return {"rows": int(len(jax_logits)), "differ": int(len(differ)),
            "largest_margin_differing": float(margin[differ].max()) if len(differ) else 0.0,
            "median_margin": float(np.median(margin)),
            "max_abs_logit_diff": float(np.abs(jax_logits - port_logits).max())}


def find_fault(records: list, factor: float) -> dict | None:
    """The first (step, tensor) from which the port's distance exceeds
    ``factor`` times JAX f32's at every step to the end and grows; None when
    no tensor does."""
    names = records[0]["distances"].keys()
    best = None
    for name in names:
        series = [(r["step"], *r["distances"][name]) for r in records]
        start = None
        for j in range(len(series) - 1, -1, -1):
            _, dj, dp = series[j]
            if dp > factor * dj and dp > 0:
                start = j
            else:
                break
        if start is None or start == len(series) - 1 or series[-1][2] <= series[start][2]:
            continue
        cand = (series[start][0], name, series[start][1], series[start][2], series[-1][1], series[-1][2])
        if best is None or cand[0] < best[0]:
            best = cand
    if best is None:
        return None
    return dict(zip(("step", "tensor", "jax32_at_step", "port_at_step", "jax32_at_end", "port_at_end"), best))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="studies/synth_hard_lockstep.py")
    p.add_argument("--model", required=True, help="a float32 row of the harness, e.g. pointcnn_cls")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--factor", type=float, default=4.0)
    p.add_argument("--grad_every", type=int, default=10, help="gradient probes every this many steps (0: last only)")
    p.add_argument("--json", default=None, help="write the per-step record here")
    p.add_argument("--threads", type=int, default=None, help="torch's CPU threads")
    args = p.parse_args(argv)
    if args.threads:
        torch.set_num_threads(args.threads)
    t0 = time.time()
    ls = Lockstep(args.model)
    records, probes = [], []
    per_epoch = ls.train["labels"].shape[0] // BATCH
    view = None
    for step in range(args.steps):
        if step % per_epoch == 0:
            view = ls.epoch_view(step // per_epoch)
        batch = ls.batch(view, step % per_epoch, step)
        if (args.grad_every and step % args.grad_every == 0) or step == args.steps - 1:
            probe = ls.grad_probe(batch, step)
            worst = max(probe.items(), key=lambda kv: kv[1][1] / max(kv[1][0], 1e-30))
            probes.append({"step": step, "grads": probe})
            print(f"  grads at step {step}: largest port/JAX-f32 error ratio {worst[0]} "
                  f"{worst[1][1]:.3e} / {worst[1][0]:.3e}", flush=True)
        losses = ls.advance(batch)
        dist, whole = ls.distances()
        records.append({"step": step + 1, "loss": losses, "distances": dist, "params": whole})
        dj = max(v[0] for v in dist.values())
        dp = max(v[1] for v in dist.values())
        print(f"step {step + 1:3d} loss f64 {losses['f64']:.6f} jax32 {losses['jax32']:.6f} port {losses['port']:.6f}"
              f" | params jax32 {whole[0]:.3e} port {whole[1]:.3e}, worst tensor jax32 {dj:.3e} port {dp:.3e}"
              f" ({time.time() - t0:.0f}s)", flush=True)
    fault = find_fault(records, args.factor)
    ev = ls.evaluate()
    summary = {"model": args.model, "steps": args.steps, "factor": args.factor, "fault": fault, "eval": ev,
               "seconds": round(time.time() - t0, 1)}
    print(json.dumps(summary, indent=1))
    if args.json:
        with open(args.json, "w") as f:
            json.dump({**summary, "records": records, "grad_probes": probes}, f)


if __name__ == "__main__":
    main()
