"""The command line (counterpart of ``scanobjectnn_tpu/train/cli.py``).

One CLI replaces the reference's per-folder train.py / train_seg.py /
train_partseg.py / evaluate_*.py / draw_cmat.py clones:

  python -m scanobjectnn_torch.train.cli train       --model pointnet2_cls_ssg ...
  python -m scanobjectnn_torch.train.cli train_seg   --model pointnet2_cls_bga ...
  python -m scanobjectnn_torch.train.cli train_partseg --model pointnet2_cls_partseg ...
  python -m scanobjectnn_torch.train.cli evaluate    --model ... --log_dir ... --num_votes K
  python -m scanobjectnn_torch.train.cli evaluate_seg --model ...
  python -m scanobjectnn_torch.train.cli evaluate_partseg --model ...
  python -m scanobjectnn_torch.train.cli evaluate_cross_domain --direction {real_on_synthetic,synthetic_on_real} ...
  python -m scanobjectnn_torch.train.cli draw_cmat   --model ... --output cmat.pdf

The flags are the JAX CLI's, with its defaults and choices (the reference's
pointnet2/train.py:25-47 with its foot-guns fixed: real ``--no_*``
switches, a float ``--seg_weight``), and one more: ``--device`` ("cuda",
the default, or "cpu").  Nothing falls back: ``--device cuda`` without a
card raises, and so does a kernel that fails to build or launch.  The
trainer refuses ``--fused_sa_eval interpret`` and the ``W,T,G`` form of
``--sa_bucket`` (TPU settings); ``--ops_backend lax`` runs the plain
versions of the kernels on the device.  A ``.bin`` listing's file names
resolve against the working directory and are prepared cloud by cloud (the
JAX CLI's ``_prepare`` raises on them); h5 files need ``h5py``.
Checkpoints are the port's ``torch.save`` files (``Trainer.save``), not
JAX's orbax directories.  The ``evaluate*`` commands route through
``Trainer.evaluate_auto``, as JAX's do: dense input through the
device-resident evaluation, ragged input and ``--visu`` through the host
loop.

Several ranks (data parallelism, ``Trainer``'s module doc): started by
``python -m torch.distributed.run --nproc_per_node R -m
scanobjectnn_torch.train.cli ...`` (``WORLD_SIZE``, ``RANK`` and
``LOCAL_RANK`` set), each process joins the default group, NCCL on
``--device cuda`` (device ``cuda:LOCAL_RANK``) and gloo on ``--device
cpu``, and its trainer takes the mesh of that group; ``--batch_size`` is
the global batch.  Rank 0 writes the logs, checkpoints and outputs.
Without those variables nothing changes.  The JAX CLI has no such flag
either: JAX takes every local device.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

import numpy as np

COMMANDS = (
    "train", "train_seg", "train_partseg",
    "evaluate", "evaluate_seg", "evaluate_partseg",
    "evaluate_cross_domain", "draw_cmat",
)


def _add_common_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model", default="pointnet2_cls_ssg")
    p.add_argument("--log_dir", default="log/")
    p.add_argument("--with_bg", action="store_true", default=True)
    p.add_argument("--no_bg", dest="with_bg", action="store_false")
    p.add_argument("--norm", action="store_true", default=True)
    p.add_argument("--no_norm", dest="norm", action="store_false")
    p.add_argument("--center_data", action="store_true", default=True)
    p.add_argument("--no_center_data", dest="center_data", action="store_false")
    p.add_argument("--num_class", type=int, default=15)
    p.add_argument("--train_file", default="h5_files/main_split/training_objectdataset_augmentedrot_scale75.h5")
    p.add_argument("--test_file", default="h5_files/main_split/test_objectdataset_augmentedrot_scale75.h5")
    p.add_argument("--num_point", type=int, default=1024)
    p.add_argument("--max_epoch", type=int, default=250)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--learning_rate", type=float, default=0.001)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--optimizer", default="adam", choices=["adam", "momentum"])
    p.add_argument("--decay_step", type=int, default=200000)
    p.add_argument("--decay_rate", type=float, default=0.7)
    p.add_argument("--seg_weight", type=float, default=0.5)
    p.add_argument("--reg_weight", type=float, default=0.001,
                   help="T-Net orthogonality penalty weight (pointnet_cls.py:93)")
    p.add_argument("--num_votes", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--resume", action="store_true")
    p.add_argument("--no_augment", action="store_true", help="disable rotate+jitter train augmentation")
    p.add_argument(
        "--no_recipe", action="store_true",
        help="ignore the model family's training recipe (PointCNN settings-module "
        "schedule) and use the generic flags instead",
    )
    p.add_argument("--visu", action="store_true", help="dump error-case renders/PLYs (eval) and seg masks (eval_seg)")
    p.add_argument("--profile", action="store_true",
                   help="trace one train epoch with torch.profiler into <log_dir>/profile/trace.json")
    p.add_argument(
        "--ops_backend", default="auto", choices=["auto", "pallas", "lax"],
        help="'auto' and 'pallas': the CUDA kernels; 'lax': their plain PyTorch versions on the device",
    )
    p.add_argument(
        "--fused_sa_eval", default="on", choices=["on", "off", "interpret"],
        help="fused eval-time SA layer (ball select+gather+MLP+pool); 'interpret' is not ported",
    )
    p.add_argument("--fused_sa_train", action="store_true", help="the fused SA training tail (#17's backward)")
    p.add_argument(
        "--sa_bucket", default="auto",
        help="bucketed fused SA kernel: 'auto' (at N=2048, M=512) or 'off'; the 'W,T,G' form is not ported",
    )
    p.add_argument(
        "--pool_precision", default="auto",
        choices=["auto", "native", "f32", "keys"],
        help="max-pool precision for bf16 training: 'auto' = exact-key "
        "pooling ('keys') under --dtype bfloat16 (plain bf16 pooling "
        "collapses the max-pool families — SYNTH_HARD.md), 'native' "
        "elsewhere",
    )
    p.add_argument("--device", default="cuda", help="'cuda' (the card; raises without one) or 'cpu'")


def _load(path: str, with_bg: bool, num_point: int, mode: str = "cls"):
    from scanobjectnn_torch.data import io

    if path.endswith(".h5"):
        if mode == "seg":
            data, labels, masks = io.load_withmask_h5(path)
            return data, np.squeeze(labels), io.convert_to_binary_mask(masks)
        if mode == "partseg":
            data, labels, parts = io.load_parts_h5(path)
            return data, np.squeeze(labels), parts
        data, labels = io.load_h5(path)
        return data, np.squeeze(labels), None
    pcs, labels = io.load_data(path, num_point, with_bg=with_bg)
    return io.object_array(pcs), np.asarray(labels), None


def _prepare(data, args):
    """Centre and normalise each cloud; an object array of clouds (a
    ``.bin`` listing) stays one (JAX's ``_prepare`` raises on it)."""
    from scanobjectnn_torch.data import io

    if args.center_data:
        data = io.center_data(data)
    if args.norm:
        data = io.normalize_data(data)
    return data


def _mesh(args):
    """The mesh of a run started by ``torch.distributed.run`` (module doc),
    the default group joined; None without ``WORLD_SIZE``."""
    if "WORLD_SIZE" not in os.environ:
        return None
    import torch
    import torch.distributed as dist

    from scanobjectnn_torch.parallel import make_mesh

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda under torch.distributed.run, but torch.cuda.is_available() is False")
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        if device.type == "cuda":
            dist.init_process_group("nccl", device_id=device)
        else:
            dist.init_process_group("gloo")
    return make_mesh(devices=[device])


def _is_main(args) -> bool:
    """Whether this process writes the outputs: rank 0, or no group."""
    mesh = getattr(args, "mesh", None)
    return mesh is None or mesh.rank == 0


def _make_trainer(args, kind: str):
    from scanobjectnn_torch.train.trainer import Trainer, TrainerConfig

    cfg = TrainerConfig(
        model=args.model,
        num_classes=args.num_class,
        num_point=args.num_point,
        batch_size=args.batch_size,
        max_epoch=args.max_epoch,
        learning_rate=args.learning_rate,
        momentum=args.momentum,
        optimizer=args.optimizer,
        decay_step=args.decay_step,
        decay_rate=args.decay_rate,
        seg_weight=args.seg_weight,
        reg_weight=args.reg_weight,
        dtype=args.dtype,
        seed=args.seed,
        log_dir=args.log_dir,
        augment_rotate=not args.no_augment,
        augment_jitter=not args.no_augment,
        use_model_recipe=not args.no_recipe,
        ops_backend=args.ops_backend,
        fused_sa_eval=args.fused_sa_eval,
        fused_sa_train=args.fused_sa_train,
        sa_bucket=args.sa_bucket,
        pool_precision=args.pool_precision,
        device=args.device,
    )
    return Trainer(cfg, mesh=getattr(args, "mesh", None))


def _train(args, mode: str):
    trainer = _make_trainer(args, mode)
    tr_data, tr_labels, tr_extra = _load(args.train_file, args.with_bg, args.num_point, mode)
    te_data, te_labels, te_extra = _load(args.test_file, args.with_bg, args.num_point, mode)
    tr_data = _prepare(tr_data, args)
    te_data = _prepare(te_data, args)
    train_dict = {"points": tr_data, "labels": tr_labels}
    test_dict = {"points": te_data, "labels": te_labels}
    key = "masks" if mode == "seg" else "parts" if mode == "partseg" else None
    if key:
        train_dict[key] = tr_extra
        test_dict[key] = te_extra
    if args.profile and args.log_dir:
        # One warm epoch, one traced epoch, then fit from that state.
        from scanobjectnn_torch.data.pipeline import EpochSampler
        from scanobjectnn_torch.utils.profiling import trace

        state = trainer.init_state(args.seed)
        sampler = EpochSampler(
            train_dict["points"], train_dict["labels"],
            masks=train_dict.get("masks"), parts=train_dict.get("parts"),
            num_points=args.num_point, seed=args.seed,
        )
        state, _ = trainer.train_epoch(state, sampler)  # warm-up: builds the kernels
        with trace(os.path.join(args.log_dir, "profile")) if _is_main(args) else contextlib.nullcontext():
            state, _ = trainer.train_epoch(state, sampler)
        trainer.logger.log(f"profile trace written to {args.log_dir}/profile")
        trainer.fit(train_dict, test_dict, state=state, num_votes=args.num_votes)
        return
    trainer.fit(train_dict, test_dict, num_votes=args.num_votes, resume=args.resume)


def _restore_for_eval(args, mode: str):
    trainer = _make_trainer(args, mode)
    state = trainer.init_state(args.seed)
    restored = trainer.restore(state)
    if restored is None:
        print(f"warning: no checkpoint under {args.log_dir}; evaluating fresh init", file=sys.stderr)
    else:
        state = restored
    return trainer, state


def _evaluate(args, mode: str):
    from scanobjectnn_torch.data.mappings import SCANOBJECTNN_CLASSES
    from scanobjectnn_torch.train import evaluate as ev

    np.random.seed(0)  # eval seeds fixed, matching evaluate_scenennobjects.py:74
    trainer, state = _restore_for_eval(args, mode)
    data, labels, extra = _load(args.test_file, args.with_bg, args.num_point, mode)
    data = _prepare(data, args)
    kwargs = {}
    if mode == "seg":
        kwargs["masks"] = extra
        kwargs["shuffle"] = False  # evaluate_seg_scenennobjects.py:195
    if mode == "partseg":
        kwargs["parts"] = extra
    if args.visu:
        kwargs["keep_points"] = True
    results = trainer.evaluate_auto(state, data, labels, num_votes=args.num_votes, **kwargs)
    log = trainer.logger
    log.log(f"total seen: {results['total_seen']}")
    log.log(f"eval mean loss: {results['mean_loss']:.6f}")
    if "accuracy" in results:
        log.log(f"eval accuracy: {results['accuracy']:.6f}")
        log.log(f"eval avg class acc: {results['avg_class_accuracy']:.6f}")
        names = SCANOBJECTNN_CLASSES[: args.num_class]
        log.log(ev.format_per_class_table(results["per_class_accuracy"], names))
        if args.log_dir and _is_main(args):
            ev.write_pred_labels(
                os.path.join(args.log_dir, "pred_label.txt"),
                results["predictions"], results["labels"], names,
            )
    if "seg_accuracy" in results:
        log.log(f"eval seg accuracy: {results['seg_accuracy']:.6f}")
    if "per_part_accuracy" in results:
        # Per-part accuracy table (pointnet/evaluate_partseg.py:186-192).
        from scanobjectnn_torch.data.mappings import CHAIR_PART_NAMES

        log.log(f"eval avg class acc: {results['avg_part_accuracy']:.6f}")
        per_part = results["per_part_accuracy"]
        part_names = list(CHAIR_PART_NAMES)[: len(per_part)]
        part_names += [f"part_{i}" for i in range(len(part_names), len(per_part))]
        for name, acc in zip(part_names, per_part):
            log.log(f"{name:>10s}:\t{acc:0.3f}")
    if args.visu and args.log_dir and "points" in results and _is_main(args):
        dump_dir = os.path.join(args.log_dir, "dump")
        if "predictions" in results:
            n_err = ev.dump_error_cases(
                dump_dir, results["points"], results["predictions"],
                results["labels"], SCANOBJECTNN_CLASSES[: args.num_class],
            )
            log.log(f"dumped {n_err} error cases to {dump_dir}")
        if "seg_predictions" in results and "masks" in results:
            n_seg = ev.dump_seg_masks(dump_dir, results["points"], results["masks"], results["seg_predictions"])
            log.log(f"dumped {n_seg} seg mask pairs to {dump_dir}")
    return results


def _evaluate_cross_domain(args):
    from scanobjectnn_torch.train import evaluate as ev

    trainer, state = _restore_for_eval(args, "cls")
    data, labels, _ = _load(args.test_file, args.with_bg, args.num_point, "cls")
    data = _prepare(data, args)
    if args.direction == "real_on_synthetic":
        results = ev.evaluate_real_trained_on_synthetic(trainer, state, data, labels, num_votes=args.num_votes)
    else:
        results = ev.evaluate_synthetic_trained_on_real(trainer, state, data, labels, num_votes=args.num_votes)
    trainer.logger.log(f"cross-domain accuracy: {results['accuracy']:.6f}")
    trainer.logger.log(f"cross-domain avg class acc: {results['avg_class_accuracy']:.6f}")
    return results


def _draw_cmat(args):
    from scanobjectnn_torch.train import evaluate as ev
    from scanobjectnn_torch.viz.cmat import plot_confusion_matrix

    results = _evaluate(args, "cls")
    if not _is_main(args):
        return
    cm = ev.confusion_matrix(results["labels"], results["predictions"], args.num_class)
    out = args.output or os.path.join(args.log_dir or ".", "cmat.pdf")
    plot_confusion_matrix(cm, out, num_classes=args.num_class)
    print(f"wrote {out}")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="scanobjectnn_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    for cmd in COMMANDS:
        p = sub.add_parser(cmd)
        _add_common_flags(p)
        if cmd == "evaluate_cross_domain":
            p.add_argument("--direction", choices=["real_on_synthetic", "synthetic_on_real"], required=True)
        if cmd == "draw_cmat":
            p.add_argument("--output", default=None)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.mesh = _mesh(args)  # the trainer's (None: one process)
    try:
        if args.command == "train":
            _train(args, "cls")
        elif args.command == "train_seg":
            _train(args, "seg")
        elif args.command == "train_partseg":
            _train(args, "partseg")
        elif args.command == "evaluate":
            _evaluate(args, "cls")
        elif args.command == "evaluate_seg":
            _evaluate(args, "seg")
        elif args.command == "evaluate_partseg":
            _evaluate(args, "partseg")
        elif args.command == "evaluate_cross_domain":
            _evaluate_cross_domain(args)
        elif args.command == "draw_cmat":
            _draw_cmat(args)
    finally:
        if args.mesh is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    main()
