#!/usr/bin/env python3
"""Profile the PyTorch port's PointNet++ SSG forward on one NVIDIA GPU.

    python3 profile_forward.py [--batch 128] [--num-point 2048] [--iters 5]

For bf16 and f32 in turn: builds ``pointnet2_cls_ssg`` with ``get_model``
(seed 0), answers one batch of the 15-class synthetic dataset (seed 0) a few
times to warm up, then traces ``--iters`` forwards with ``torch.profiler``.
Prints, per forward: host wall time, the number of device kernels, device
busy time (the union of kernel intervals), the kernel window (first kernel
start to last kernel end), the window's idle share, and device time by
kernel name.  The last line is one JSON object with the same numbers and the
card's name and power limit.  TF32 is off, as in ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict


def profile_one(model, points, iters: int) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        for _ in range(3):
            model(points)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                model(points)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events() if e.device_type == DeviceType.CUDA
    )
    if not spans:
        raise RuntimeError("the profiler recorded no device kernel")
    busy_us, reach, by_name = 0.0, spans[0][0], defaultdict(float)
    for start, end, name in spans:
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
        by_name[name] += end - start
    window_us = reach - spans[0][0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {
        "host_wall_ms": wall_ms / iters,
        "kernels": len(spans) / iters,
        "device_busy_ms": busy_us / 1e3 / iters,
        "kernel_window_ms": window_us / 1e3 / iters,
        "idle_share_of_window": 1.0 - busy_us / window_us,
        "device_ms_by_kernel": {name: us / 1e3 / iters for name, us in top},
    }


def main() -> None:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--num-point", type=int, default=2048)
    parser.add_argument("--iters", type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward: torch.cuda.is_available() is False; needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from scanobjectnn_torch.data.synthetic import make_synthetic_dataset
    from scanobjectnn_torch.models import get_model

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    data, _ = make_synthetic_dataset(
        num_per_class=-(-args.batch // 15), num_classes=15, num_points=args.num_point, seed=0
    )
    points = torch.from_numpy(data[: args.batch]).cuda()
    out = {"card": card, "batch": args.batch, "num_point": args.num_point, "iters": args.iters}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", None)):
        model = get_model("pointnet2_cls_ssg", dtype=dtype).cuda().eval()
        res = out[name] = profile_one(model, points, args.iters)
        print(f"{name}: host wall {res['host_wall_ms']:.4f} ms/forward, {res['kernels']:.0f} kernels, "
              f"device busy {res['device_busy_ms']:.4f} ms, window {res['kernel_window_ms']:.4f} ms, "
              f"idle share {res['idle_share_of_window']:.4f} ({card})")
        for kname, ms in res["device_ms_by_kernel"].items():
            print(f"  {ms:9.4f} ms  {kname[:100]}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
