#!/usr/bin/env python3
"""Profile the PyTorch port's forward, or its training step, on one NVIDIA
GPU.

    python3 profile_forward.py [--batch 128] [--num-point 2048] [--iters 5]
    python3 profile_forward.py --sa-bucket off
    python3 profile_forward.py --train [--batch 16] [--num-point 1024]
    python3 profile_forward.py --train --dtype bfloat16 [--model pointnet2_cls_msg]
    python3 profile_forward.py --train --fused-sa-train [--dtype bfloat16]
    python3 profile_forward.py --model pointnet2_cls_msg|pointnet2_cls_bga|pointnet2_cls_partseg [--train]
    python3 profile_forward.py --model dgcnn [--train [--dtype bfloat16]]
    python3 profile_forward.py --model spidercnn_cls_xyz [--train [--dtype bfloat16]]
    python3 profile_forward.py --model pointcnn_cls|pointcnn_seg [--train [--dtype bfloat16]]
    python3 profile_forward.py --model pointnet_cls [--train [--dtype bfloat16]]
    python3 profile_forward.py --model 3dmfv_net_cls [--train [--dtype bfloat16]]

``--model`` is ``pointnet2_cls_ssg`` (default), ``pointnet2_cls_msg``,
``pointnet2_cls_bga``, ``pointnet2_cls_partseg``, ``dgcnn``, ``dgcnn_bga``,
``spidercnn_cls_xyz``, ``pointcnn_cls``, ``pointcnn_seg``, ``pointnet_cls``,
``pointnet_cls_basic``, ``pointnet_seg``, ``pointnet_partseg`` or
``3dmfv_net_cls``; every one trains in f32 and in bf16.  The defaults
are each model's configurations: SSG B=128, N=2048 for the forward and
B=16, N=1024 for ``--train``; MSG and BGA B=32, N=1024 and B=16; part
segmentation B=32 and B=8, N=1024; both DGCNNs, SpiderCNN, both PointCNNs
and the four PointNets B=32, N=1024 for both; 3DmFV-Net B=32 for the
forward and B=64 for ``--train``, N=1024.
Forward: for bf16 and f32 in turn, builds the model with ``get_model``
(seed 0, on the card) and answers one batch of the 15-class synthetic
dataset (seed 0; with background points and binary masks for the models
of kind "seg", part ids for "partseg"), under ``--sa-bucket`` ("auto",
the default: an SA layer at N=2048, M=512, such as SSG's SA1, runs the
bucketed kernel #4 after two rank sorts #5; "off": the fused kernel #3).  ``--train``: a ``Trainer`` (seed 0, its default
augmentation, dropout and Adam, or the model's recipe: PointCNN's step LR,
Adam eps 1e-2, L2 1e-5 and augmentation; seg_weight 0.5) takes
``train_step``s on one such batch, in f32 or with ``--dtype bfloat16``
(exact-key pooling in the PointNet and PointNet++ models), and with
``--fused-sa-train`` the SA layers' fused training tail (pool mode native
in bf16).
Each runs a few times to warm up, then ``--iters`` runs are traced with
``torch.profiler``.  Prints, per run: host wall time, the number of device
kernels, device busy time (the union of kernel intervals), the kernel window
(first kernel start to last kernel end), the window's idle share, and
device time by kernel name.  The last line is one JSON object with the same
numbers and the card's name and power limit.  TF32 is off, as in
``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict

# model: ((forward batch, points), (training batch, points))
DEFAULTS = {
    "pointnet2_cls_ssg": ((128, 2048), (16, 1024)),
    "pointnet2_cls_msg": ((32, 1024), (16, 1024)),
    "pointnet2_cls_bga": ((32, 1024), (16, 1024)),
    "pointnet2_cls_partseg": ((32, 1024), (8, 1024)),
    "dgcnn": ((32, 1024), (32, 1024)),
    "dgcnn_bga": ((32, 1024), (32, 1024)),
    "spidercnn_cls_xyz": ((32, 1024), (32, 1024)),
    "pointcnn_cls": ((32, 1024), (32, 1024)),
    "pointcnn_seg": ((32, 1024), (32, 1024)),
    "pointnet_cls": ((32, 1024), (32, 1024)),
    "pointnet_cls_basic": ((32, 1024), (32, 1024)),
    "pointnet_seg": ((32, 1024), (32, 1024)),
    "pointnet_partseg": ((32, 1024), (32, 1024)),
    "3dmfv_net_cls": ((32, 1024), (64, 1024)),
}


def device_spans(prof) -> list[tuple[float, float, str]]:
    """(start, end, name), in µs, of every device kernel and copy that the
    ``torch.profiler`` run ``prof`` traced, in order of start.  User
    annotations on the device's timeline (``Optimizer.step#Adam.step``
    spans the optimizer's kernels and the host gaps between them) are not
    kernels and are left out; a torch whose events lack
    ``is_user_annotation`` raises rather than count them."""
    from torch.autograd import DeviceType

    return sorted(
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events() if e.device_type == DeviceType.CUDA and not e.is_user_annotation
    )


def busy_us(spans) -> float:
    """Device busy time: the length of the union of the ``spans``."""
    busy, reach = 0.0, spans[0][0]
    for start, end, _ in spans:
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    return busy


def profile_one(run, iters: int) -> dict:
    """Trace ``iters`` calls of ``run()`` after 3 warm-up calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = device_spans(prof)
    if not spans:
        raise RuntimeError("the profiler recorded no device kernel")
    busy, by_name = busy_us(spans), defaultdict(float)
    for start, end, name in spans:
        by_name[name] += end - start
    window_us = max(end for _, end, _ in spans) - spans[0][0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:20]
    return {
        "host_wall_ms": wall_ms / iters,
        "kernels": len(spans) / iters,
        "device_busy_ms": busy / 1e3 / iters,
        "kernel_window_ms": window_us / 1e3 / iters,
        "idle_share_of_window": 1.0 - busy / window_us,
        "device_ms_by_kernel": {name: us / 1e3 / iters for name, us in top},
    }


def main() -> None:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", default="pointnet2_cls_ssg", choices=sorted(DEFAULTS))
    parser.add_argument("--train", action="store_true", help="profile train_step instead of the forward")
    parser.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"), help="--train's compute dtype")
    parser.add_argument("--fused-sa-train", action="store_true", help="--train with the fused SA training tail")
    parser.add_argument("--batch", type=int, help="default: the model's configuration (module doc)")
    parser.add_argument("--num-point", type=int, help="default: the model's configuration (module doc)")
    parser.add_argument("--sa-bucket", default="auto", choices=("auto", "off"),
                        help="the forward's bucketed SA setting (module doc)")
    parser.add_argument("--iters", type=int, default=5)
    args = parser.parse_args()
    batch, num_point = DEFAULTS[args.model][args.train]
    args.batch = args.batch or batch
    args.num_point = args.num_point or num_point
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward: torch.cuda.is_available() is False; needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from scanobjectnn_torch.data.io import convert_to_binary_mask
    from scanobjectnn_torch.data.synthetic import make_synthetic_dataset
    from scanobjectnn_torch.models import MODEL_REGISTRY, get_model
    from scanobjectnn_torch.nn.pointnet_modules import configure_eval

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    kind = MODEL_REGISTRY[args.model].kind
    seg = kind == "seg"
    arrays = make_synthetic_dataset(
        num_per_class=-(-args.batch // 15), num_classes=15, num_points=args.num_point, seed=0, with_mask=seg,
        with_parts=kind == "partseg",
    )
    data, labels = arrays[:2]
    out = {"card": card, "model": args.model, "batch": args.batch, "num_point": args.num_point, "iters": args.iters,
           "sa_bucket": args.sa_bucket}
    runs = {}
    if args.train:
        from scanobjectnn_torch.train.trainer import Trainer, TrainerConfig

        pool = "native" if args.fused_sa_train else "auto"
        trainer = Trainer(TrainerConfig(model=args.model, batch_size=args.batch, dtype=args.dtype,
                                        pool_precision=pool, fused_sa_train=args.fused_sa_train))
        state = trainer.init_state(seed=0)
        batch = {"points": data[: args.batch], "labels": labels[: args.batch]}
        if seg:
            batch["masks"] = convert_to_binary_mask(arrays[2][: args.batch]).astype("int64")
        if kind == "partseg":
            batch = {"points": batch["points"], "parts": arrays[2][: args.batch]}
        name = {"float32": "train_f32", "bfloat16": "train_bf16"}[args.dtype]
        runs[name + ("_fused_tail" if args.fused_sa_train else "")] = lambda: trainer.train_step(state, batch)
    else:
        points = torch.from_numpy(data[: args.batch]).cuda()
        for name, dtype in (("bf16", torch.bfloat16), ("f32", None)):
            model = configure_eval(get_model(args.model, dtype=dtype), args.sa_bucket).eval()
            runs[name] = torch.no_grad()(lambda model=model: model(points))
    for name, run in runs.items():
        res = out[name] = profile_one(run, args.iters)
        print(f"{name}: host wall {res['host_wall_ms']:.4f} ms/run, {res['kernels']:.0f} kernels, "
              f"device busy {res['device_busy_ms']:.4f} ms, window {res['kernel_window_ms']:.4f} ms, "
              f"idle share {res['idle_share_of_window']:.4f} ({card})")
        for kname, ms in res["device_ms_by_kernel"].items():
            print(f"  {ms:9.4f} ms  {kname[:100]}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
