"""The synthetic-hard model-quality harness (counterpart of
``scripts/synthetic_hard_bench.py``).

Trains every registry family on ``make_hard_synthetic_dataset``: 600
training and 360 test clouds of 6 near-confusable ellipsoid classes, each
cloud sharing its frame with a wrong-class distractor body and uniform
clutter, stored at twice ``--num_point`` points and subsampled to it every
epoch.  Each row trains ``--epochs`` epochs (batch 24, Adam 1e-3, seed 0,
no rotation) through ``Trainer.fit``'s device-resident path, then is
evaluated once with one vote.  BGA rows see the fg/bg masks, part rows the
3-way part ids (fg / distractor / clutter); plain rows see the labels only.

On the card (the default), every row or some of them, each later piece
merged into the same files (the table's 21 rows are the 14 f32 rows, then
the bf16 rows under ``--pool_f32 0``, ``1`` and ``keys``; README):

    python -m scanobjectnn_torch.train.synth_hard
    python -m scanobjectnn_torch.train.synth_hard --models pointnet2_cls_ssg:bfloat16 --pool_f32 keys --merge

On the CPU: ``--device cpu``.  The rows, flags, data and markdown are the
JAX script's, with three differences: ``--device cuda|cpu``; ``--pool_f32``
sets ``TrainerConfig.pool_precision`` ("1" f32, "keys" exact keys, "0" the
native pool, which leaves the dtype untagged: the counterpart of JAX's
``SCANOBJECTNN_SA_POOL_F32=0``) in place of an environment variable; and the
outputs default to ``SYNTH_HARD_TORCH.md`` and ``synth_hard_torch.json``,
never the JAX script's ``SYNTH_HARD.md`` and ``synth_hard.json``, which hold
the reference this table is compared with.  The markdown carries one line
more than JAX's, under its title: the device the rows ran on (on the card,
``nvidia-smi``'s name and power limit), since the wall column is its time.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import subprocess
import time

# (model, supervision, dtype) rows; supervision False = labels only,
# True = labels + fg/bg masks (BGA/seg), "parts" = 3-way part ids.
ROWS = [
    ("pointnet_cls_basic", False, "float32"),
    ("pointnet_cls", False, "float32"),
    ("pointnet_seg", True, "float32"),
    ("pointnet2_cls_ssg", False, "float32"),
    ("pointnet2_cls_msg", False, "float32"),
    ("pointnet2_cls_bga", True, "float32"),
    ("dgcnn", False, "float32"),
    ("dgcnn_bga", True, "float32"),
    ("spidercnn_cls_xyz", False, "float32"),
    ("3dmfv_net_cls", False, "float32"),
    ("pointcnn_cls", False, "float32"),
    ("pointcnn_seg", True, "float32"),
    ("pointnet2_cls_partseg", "parts", "float32"),
    ("pointnet_partseg", "parts", "float32"),
    ("pointnet_cls_basic", False, "bfloat16"),
    ("pointnet2_cls_ssg", False, "bfloat16"),
    ("pointcnn_cls", False, "bfloat16"),
]

# --pool_f32 value -> (TrainerConfig.pool_precision, the dtype's tag).
POOL_SETTINGS = {None: ("auto", None), "0": ("native", None), "1": ("f32", "poolf32"), "keys": ("keys", "poolkeys")}


def build_data(num_points: int, seed_train=0, seed_test=1):
    """The training and test sets: {"points" centred and normalised,
    "labels", binary "masks", "parts"}."""
    from scanobjectnn_torch.data import io, synthetic

    sets = []
    for seed, num_per_class in ((seed_train, 100), (seed_test, 60)):
        pts, labels, masks, parts = synthetic.make_hard_synthetic_dataset(
            num_per_class=num_per_class, num_classes=6, num_points=num_points, seed=seed, return_parts=True)
        sets.append({"points": io.normalize_data(io.center_data(pts)), "labels": labels,
                     "masks": io.convert_to_binary_mask(masks), "parts": parts})
    return sets[0], sets[1]


def fit_and_evaluate(model, supervision, dtype, train, test, args, seed=0):
    """Train one row with ``fit`` (no test set: the device-resident path)
    from ``seed`` (the JAX script's 0), evaluate it once with one vote:
    (the host ``evaluate``'s dict, the seconds both took)."""
    from scanobjectnn_torch.train.trainer import Trainer, TrainerConfig

    partseg = supervision == "parts"
    cfg = TrainerConfig(
        # partseg models take num_parts via num_classes (Trainer.__init__).
        model=model, num_classes=3 if partseg else 6,
        num_point=args.num_point,
        batch_size=24, max_epoch=args.epochs, learning_rate=1e-3,
        seed=seed, dtype=dtype, augment_rotate=False,
        pool_precision=POOL_SETTINGS[args.pool_f32][0], device=args.device,
    )
    trainer = Trainer(cfg)
    tr = {"points": train["points"], "labels": train["labels"]}
    if supervision is True:
        tr["masks"] = train["masks"]
    elif partseg:
        tr["parts"] = train["parts"]
    t0 = time.time()
    state = trainer.fit(tr)
    ev = trainer.evaluate(
        state, test["points"], test["labels"],
        masks=test["masks"] if supervision is True else None,
        parts=test["parts"] if partseg else None,
        num_votes=1,
    )
    return ev, time.time() - t0


def result_row(model, supervision, dtype, ev, wall) -> dict:
    """The JAX script's result dict of a row's evaluation ``ev`` and the
    seconds ``wall`` its training and evaluation took."""
    return {
        "model": model, "dtype": dtype, "bga": supervision is True,
        # cls accuracy when the model has a cls head; partseg rows have none.
        "accuracy": round(float(ev["accuracy"]), 4) if "accuracy" in ev else None,
        "seg_accuracy": round(float(ev.get("seg_accuracy", -1.0)), 4),
        "avg_part_accuracy": round(float(ev["avg_part_accuracy"]), 4) if "avg_part_accuracy" in ev else None,
        "wall_sec": round(wall, 1),
    }


def run_row(model, supervision, dtype, train, test, args, seed=0):
    """One row of the table: ``fit_and_evaluate`` as ``result_row``."""
    return result_row(model, supervision, dtype, *fit_and_evaluate(model, supervision, dtype, train, test, args,
                                                                   seed=seed))


def device_line(device: str) -> str:
    """The markdown's device line; on the card ``nvidia-smi``'s name and
    power limit (read before any row trains)."""
    if device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
        return f"Device: {smi} (scanobjectnn_torch, CUDA kernels; wall is this card's time)."
    return f"Device: CPU, {platform.machine()} (scanobjectnn_torch, the plain versions)."


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="scanobjectnn_torch.train.synth_hard")
    # 150, not 60: the BGA models' joint loss slows their cls convergence;
    # equal long budgets are the fair comparison.
    p.add_argument("--epochs", type=int, default=150)
    p.add_argument("--num_point", type=int, default=128)
    p.add_argument("--models", default=None,
                   help="comma list filter; entries are 'model' or 'model:dtype' to select one dtype row")
    p.add_argument("--output", default="SYNTH_HARD_TORCH.md")
    p.add_argument("--json", dest="json_out", default="synth_hard_torch.json")
    p.add_argument("--merge", action="store_true",
                   help="merge the rows run now into an existing json (rewrite only those; keep the rest)")
    p.add_argument("--pool_f32", nargs="?", const="1", default=None, choices=["0", "1", "keys"],
                   help="the SA pool mode: '1' f32 final layer, 'keys' exact-key pooling (both tag the rows' "
                   "dtype so they merge as distinct entries), '0' the native pool (dtype untagged)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="'cuda' (the card; raises without one) or 'cpu'")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    tag = POOL_SETTINGS[args.pool_f32][1]
    device = device_line(args.device)

    # Clouds carry 2x the training point count (the h5 convention), each
    # subsampled to --num_point every epoch.  At num_point < 512 SA1 of the
    # PointNet++ family asks FPS for more centroids than a cloud holds.
    train, test = build_data(2 * args.num_point)
    selected = set(args.models.split(",")) if args.models else None
    results = []
    for model, supervision, dtype in ROWS:
        if selected and not {model, f"{model}:{dtype}"} & selected:
            continue
        print(f"=== {model} ({dtype}) ===", flush=True)
        r = run_row(model, supervision, dtype, train, test, args)
        if tag:
            r["dtype"] = f"{dtype}+{tag}"
        results.append(r)
        print(json.dumps(r), flush=True)

    if args.merge and os.path.isfile(args.json_out):
        with open(args.json_out) as f:
            old = {(r["model"], r["dtype"]): r for r in json.load(f)}
        old.update({(r["model"], r["dtype"]): r for r in results})
        # Re-emit in ROWS order (rows of other dtypes keep their place last).
        order = {(m, d): i for i, (m, _s, d) in enumerate(ROWS)}
        results = sorted(old.values(), key=lambda r: order.get((r["model"], r["dtype"]), 99))

    lines = [
        "# Synthetic-hard benchmark (6 confusable ellipsoid classes, "
        "wrong-class distractor + uniform clutter)",
        device,
        "",
        f"600 train / 360 test clouds, {2 * args.num_point}→{args.num_point} pts, batch 24, "
        f"{args.epochs} epochs, 1-vote eval.  BGA rows see the fg/bg mask "
        "supervision; plain rows do not.  Accuracies are the regression "
        "signal — they separate by family (unlike the easy fixture where "
        "everything hits 1.000).",
        "",
        "| Model | dtype | BGA | accuracy | seg acc | part acc | wall |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in results:
        seg = f"{r['seg_accuracy']:.3f}" if r["seg_accuracy"] >= 0 else "—"
        acc = f"{r['accuracy']:.3f}" if r.get("accuracy") is not None else "—"
        part = f"{r['avg_part_accuracy']:.3f}" if r.get("avg_part_accuracy") is not None else "—"
        lines.append(
            f"| {r['model']} | {r['dtype']} | {'yes' if r['bga'] else 'no'} "
            f"| {acc} | {seg} | {part} | {r['wall_sec']}s |"
        )
    table = "\n".join(lines) + "\n"
    # Keep hand-written analysis sections (everything from the first "## "
    # heading onward) across table rewrites.
    if os.path.isfile(args.output):
        with open(args.output) as f:
            old_md = f.read()
        cut = old_md.find("\n## ")
        if cut >= 0:
            table = table + old_md[cut:]
    with open(args.output, "w") as f:
        f.write(table)
    with open(args.json_out, "w") as f:
        json.dump(results, f, indent=2)
    print(table)
    print(f"wrote {args.output} and {args.json_out}")


if __name__ == "__main__":
    main()
