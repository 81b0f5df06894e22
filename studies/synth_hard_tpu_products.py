#!/usr/bin/env python3
"""The synthetic-hard harness's rows on one NVIDIA GPU with every product
rounded the way a TPU's default f32 matmul rounds it:

    python3 studies/synth_hard_tpu_products.py --models pointnet2_cls_bga,pointcnn_cls,dgcnn_bga --seeds 0,1

The JAX package's ``synth_hard.json`` was trained on a TPU, where a dot of
f32 operands at the default precision takes one pass of bf16 products
summed in f32, forward and backward; the JAX package asks for full f32 only
in its distances and rotations (``Precision.HIGHEST``).  The port runs
every product in f32.  Here each row trains as the harness trains it
(``synth_hard.fit_and_evaluate``: its data, 150 epochs, batch 24, one
vote; from each of ``--seeds``) with every kernel's plain version
(``ops.cuda.plain_ops``, so no product runs inside a CUDA kernel) and with
``torch.matmul``, ``torch.einsum`` and the FP layers' interpolation
replaced, for the run, by the same product of operands rounded to bf16,
summed in f32: the forward's two operands, and in the backward the
incoming cotangent (the weights' and inputs' gradients are again such
products).  The distances, rotations, BatchNorm, losses and optimizer stay
f32, as on the TPU.  The port itself is unchanged; only this process's
``torch`` functions are replaced.

Prints the card's name and power limit, then each run's row (the harness's
dict) and, for a model with a cls head, its test predictions counted by
true class.  It writes nothing.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "studies"))


def _round(t):
    import torch

    return t.to(torch.bfloat16).to(t.dtype) if t.is_floating_point() else t


def _rounding_functions():
    """(operand, cotangent): each rounds to bf16 on one side of autograd
    and passes the other side through."""
    import torch

    class Operand(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t):
            return _round(t)

        @staticmethod
        def backward(ctx, g):
            return g

    class Cotangent(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t):
            return t.clone()

        @staticmethod
        def backward(ctx, g):
            return _round(g)

    return Operand.apply, Cotangent.apply


@contextlib.contextmanager
def tpu_products():
    """``torch.matmul``, ``torch.einsum`` and ``ops.three_interpolate``
    with bf16-rounded operands and f32 sums (module doc), restored after."""
    import torch

    from scanobjectnn_torch import ops

    operand, cotangent = _rounding_functions()
    matmul, einsum, interpolate = torch.matmul, torch.einsum, ops.three_interpolate

    def tpu_matmul(a, b):
        return cotangent(matmul(operand(a), operand(b)))

    def tpu_einsum(spec, *xs):
        return cotangent(einsum(spec, *(operand(x) for x in xs)))

    def tpu_interpolate(points, idx, weight):
        return cotangent(interpolate(operand(points), idx, operand(weight)))

    torch.matmul, torch.einsum, ops.three_interpolate = tpu_matmul, tpu_einsum, tpu_interpolate
    try:
        yield
    finally:
        torch.matmul, torch.einsum, ops.three_interpolate = matmul, einsum, interpolate


def main(argv=None) -> None:
    from synth_hard_seeds import run_seeded

    from scanobjectnn_torch.ops.cuda import plain_ops
    from scanobjectnn_torch.train import synth_hard

    p = argparse.ArgumentParser(prog="studies/synth_hard_tpu_products.py")
    p.add_argument("--models", required=True, help="'model' or 'model:dtype' entries, as the harness's")
    p.add_argument("--seeds", default="0")
    p.add_argument("--epochs", type=int, default=150)
    p.add_argument("--num_point", type=int, default=128)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    args.pool_f32 = None
    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    print("every kernel's plain version (ops.cuda.plain_ops), products on bf16-rounded operands; the "
          "Trainer's log line names its config's backend", flush=True)
    selected = set(args.models.split(","))
    rows = [r for r in synth_hard.ROWS if r[2] == "float32" and {r[0], f"{r[0]}:{r[2]}"} & selected]
    train, test = synth_hard.build_data(2 * args.num_point)
    for row in rows:
        for seed in (int(s) for s in args.seeds.split(",")):
            with plain_ops(), tpu_products():
                result, counts = run_seeded(row, train, test, args, seed)
            print(json.dumps({"seed": seed, "products": "bf16 operands, f32 sums", **result}), flush=True)
            if counts is not None:
                print(f"  predictions by true class (rows) and predicted class: {counts}", flush=True)


if __name__ == "__main__":
    main()
