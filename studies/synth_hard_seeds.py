#!/usr/bin/env python3
"""The synthetic-hard harness's rows under other training seeds, on one
NVIDIA GPU (or the CPU with ``--device cpu``):

    python3 studies/synth_hard_seeds.py --models dgcnn_bga,pointnet2_cls_bga --seeds 1,2,3

Each selected row of ``scanobjectnn_torch.train.synth_hard.ROWS`` runs
as the harness runs it (its data, 150 epochs, batch 24, one vote), but from
each of ``--seeds`` (``synth_hard.run_row``'s ``seed``, the harness's 0):
the weights' initialisation, the epochs' draws, jitter and dropout change;
the data does not.  ``--ops_backend lax`` runs every kernel's plain
version on the card instead (``ops.cuda.plain_ops``), which tells a
kernel's part in a row from the rest of the port's.  Prints each run's row, and for a model with a cls head
its test predictions counted by true class (rows) and predicted class
(columns); then, by row, the accuracies' mean, standard deviation (n - 1), least and
largest over the seeds, with seed 0's row from ``--table`` (the harness's
json) beside them.  The spread tells whether a row's distance from the JAX
package's row (``synth_hard.json``) is larger than what training
randomness alone moves it by.  It writes nothing.

Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

METRICS = ("accuracy", "seg_accuracy", "avg_part_accuracy")


def run_seeded(row, train, test, args, seed: int) -> tuple[dict, list | None]:
    """``synth_hard.run_row`` from ``seed``, and where the model has a cls
    head the confusion counts of its test predictions: [true class][predicted
    class]."""
    import numpy as np

    from scanobjectnn_torch.train import synth_hard

    ev, wall = synth_hard.fit_and_evaluate(*row, train, test, args, seed=seed)
    result = synth_hard.result_row(*row, ev, wall)
    if "predictions" not in ev:
        return result, None
    counts = np.zeros((6, 6), np.int64)
    np.add.at(counts, (np.asarray(ev["labels"]), np.asarray(ev["predictions"])), 1)
    return result, counts.tolist()


def main(argv=None) -> None:
    from scanobjectnn_torch.ops.cuda import plain_ops
    from scanobjectnn_torch.train import synth_hard

    p = argparse.ArgumentParser(prog="studies/synth_hard_seeds.py")
    p.add_argument("--models", required=True, help="'model' or 'model:dtype' entries, as the harness's")
    p.add_argument("--seeds", default="1,2,3")
    p.add_argument("--epochs", type=int, default=150)
    p.add_argument("--num_point", type=int, default=128)
    p.add_argument("--pool_f32", default=None, choices=["0", "1", "keys"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--ops_backend", default="auto", choices=["auto", "lax"],
                   help="'lax': every kernel's plain version on the card (``ops.cuda.plain_ops``), as the CLI's flag")
    p.add_argument("--table", default=os.path.join(ROOT, "synth_hard_torch.json"))
    args = p.parse_args(argv)
    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    seeds = [int(s) for s in args.seeds.split(",")]
    selected = set(args.models.split(","))
    rows = [r for r in synth_hard.ROWS if {r[0], f"{r[0]}:{r[2]}"} & selected]
    seed0 = {}
    if os.path.isfile(args.table):
        with open(args.table) as f:
            seed0 = {(r["model"], r["dtype"]): r for r in json.load(f)}
    train, test = synth_hard.build_data(2 * args.num_point)
    for row in rows:
        runs = []
        for seed in seeds:
            with plain_ops() if args.ops_backend == "lax" else contextlib.nullcontext():
                r, confusion = run_seeded(row, train, test, args, seed)
            print(json.dumps({"seed": seed, **r}), flush=True)
            if confusion is not None:
                print(f"{row[0]} {row[2]} seed {seed}: test predictions by true class (rows) and predicted class "
                      f"(columns): {json.dumps(confusion)}", flush=True)
            runs.append(r)
        tag = {"1": "+poolf32", "keys": "+poolkeys"}.get(args.pool_f32, "")
        base = seed0.get((row[0], row[2] + tag))
        for key in METRICS:
            values = [r[key] for r in runs if r[key] is not None and r[key] >= 0]
            if not values:
                continue
            spread = statistics.stdev(values) if len(values) > 1 else 0.0
            print(f"{row[0]} {row[2]}{tag} {key}: seeds {seeds} mean {statistics.mean(values):.4f} sd {spread:.4f} "
                  f"min {min(values):.4f} max {max(values):.4f}; seed 0 (--table) "
                  f"{base[key] if base else 'not in the table'}", flush=True)


if __name__ == "__main__":
    main()
