#!/usr/bin/env python3
"""The device-resident epoch and evaluation against the host path, on one
NVIDIA GPU:

    python3 studies/resident_epoch.py    # from the repository root

1. Epochs: ``Trainer.train_epoch`` (an ``EpochSampler`` over the host
   arrays, each batch copied to the card by its step) against
   ``train_epoch_device`` (the set uploaded once), in turns host, device,
   device, host, host, device, each epoch timed by the host clock to a
   synchronize; their medians.  Then one more epoch of each traced with
   ``torch.profiler``: the device's busy time and idle share of the
   epoch's kernel window (``profile_forward.device_spans``).  Two cases:
   ``pointnet2_cls_ssg`` f32 at B=16 and ``pointnet_cls`` f32 at B=32,
   N=1024, on CLOUDS synthetic clouds of 2048 points (15 classes).
2. Evaluation at ``chip_smoke.py`` phase 12d's configuration (SSG, 60
   clouds of N=2048, batch 32, 3 votes, random BN statistics):
   ``evaluate(shuffle=False)`` against ``evaluate_device(shuffle=False)``
   (the upload included), in turns, each three times; their medians, and
   the idle share of one traced call of each.  The results must be equal.
3. Synchronisations: after a warm epoch, one resident epoch up to its
   readback (``Trainer._epoch_impl``) of each of SYNC_CASES, and
   ``evaluate_device``'s loop (``_eval_epoch_impl``) of case 2's SSG, under
   ``torch.cuda.set_sync_debug_mode("warn")``: each synchronising call's
   Python line and message, counted (none is the aim; the mode is
   PyTorch's prototype and does not see every synchronisation).

Prints the card's name and power limit first.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CLOUDS, STORED, NUM_CLASSES = 960, 2048, 15
CASES = (("pointnet2_cls_ssg", 16), ("pointnet_cls", 32))
ORDER = ("host", "device", "device", "host", "host", "device")
# (model, dtype, batch, with masks)
SYNC_CASES = (("pointnet2_cls_ssg", "float32", 16, False), ("pointnet2_cls_bga", "bfloat16", 16, True),
              ("pointnet_cls", "float32", 32, False), ("dgcnn", "float32", 32, False))


def traced(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: host wall ms, kernels,
    device busy ms, kernel window ms and the idle share of that window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from profile_forward import busy_us, device_spans

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = device_spans(prof)
    if not spans:
        raise RuntimeError("the profiler recorded no device kernel")
    busy, window = busy_us(spans), max(end for _, end, _ in spans) - spans[0][0]
    return {"wall_ms": wall_ms, "kernels": len(spans), "busy_ms": busy / 1e3, "window_ms": window / 1e3,
            "idle_share": 1.0 - busy / window}


def wall_s(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def shown(reading: dict) -> str:
    return (f"wall {reading['wall_ms']:.4f} ms, busy {reading['busy_ms']:.4f} ms of a {reading['window_ms']:.4f} ms "
            f"window, idle {reading['idle_share']:.4f}, {reading['kernels']} kernels")


def synchronisations(fn) -> dict:
    """``fn()`` under the sync debug mode "warn": {"file:line: message":
    count} of the synchronising calls it made."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    sites: dict[str, int] = {}
    for w in caught:
        # PyTorch's one-time notice that the mode is a prototype is no sync.
        if "synchroniz" in str(w.message) and "prototype feature" not in str(w.message):
            key = f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}: {str(w.message).splitlines()[0]}"
            sites[key] = sites.get(key, 0) + 1
    return sites


def sync_audit(smi: str) -> None:
    import numpy as np
    import torch

    import chip_smoke as cs
    from scanobjectnn_torch.data.synthetic import make_synthetic_dataset
    from scanobjectnn_torch.train.trainer import Trainer, TrainerConfig

    points, labels, masks = make_synthetic_dataset(num_per_class=CLOUDS // NUM_CLASSES, num_classes=NUM_CLASSES,
                                                   num_points=STORED, seed=18, with_mask=True)
    for model, dtype, batch, with_masks in SYNC_CASES:
        trainer = Trainer(TrainerConfig(model=model, dtype=dtype, num_point=1024, batch_size=batch))
        data = {"points": points, "labels": labels}
        if with_masks:
            data["masks"] = (masks >= 0).astype(np.int64)
        device_data = trainer.upload_dataset(data)
        state, _ = trainer.train_epoch_device(trainer.init_state(), device_data)  # warm
        print(f"syncs {model} {dtype} B={batch}: one resident epoch up to its readback: "
              f"{synchronisations(lambda: trainer._epoch_impl(state, device_data)) or 'none'} ({smi})")
    data, labels = make_synthetic_dataset(num_per_class=4, num_classes=NUM_CLASSES, num_points=cs.NUM_POINT, seed=5)
    trainer = Trainer(TrainerConfig(num_point=cs.NUM_POINT, batch_size=32))
    state, device_data = trainer.init_state(0), trainer.upload_dataset({"points": data, "labels": labels})
    rots, pt_perm = trainer._rotations(3), trainer._eval_points(cs.NUM_POINT, None)
    trainer._eval_epoch_impl(state, device_data, rots, pt_perm)  # warm
    torch.cuda.synchronize()
    print(f"syncs evaluate_device pointnet2_cls_ssg N={cs.NUM_POINT}: its loop up to the readback: "
          f"{synchronisations(lambda: trainer._eval_epoch_impl(state, device_data, rots, pt_perm)) or 'none'} ({smi})")


def epochs(smi: str) -> None:
    from scanobjectnn_torch.data.pipeline import EpochSampler
    from scanobjectnn_torch.data.synthetic import make_synthetic_dataset
    from scanobjectnn_torch.train.trainer import Trainer, TrainerConfig

    points, labels = make_synthetic_dataset(num_per_class=CLOUDS // NUM_CLASSES, num_classes=NUM_CLASSES,
                                            num_points=STORED, seed=18)
    for model, batch in CASES:
        trainer = Trainer(TrainerConfig(model=model, num_point=1024, batch_size=batch))
        sampler = EpochSampler(points, labels, num_points=1024, seed=0)
        device_data = trainer.upload_dataset({"points": points, "labels": labels})
        states = {"host": trainer.init_state(), "device": trainer.init_state()}

        def run(path):
            if path == "host":
                states["host"], _ = trainer.train_epoch(states["host"], sampler)
            else:
                states["device"], _ = trainer.train_epoch_device(states["device"], device_data)

        for path in ("host", "device"):  # warm: builds and loads the kernels
            run(path)
        rounds = [(path, wall_s(lambda: run(path))) for path in ORDER]
        steps = len(labels) // batch
        host, device = (statistics.median(t for p, t in rounds if p == path) for path in ("host", "device"))
        print(f"epoch {model} f32 B={batch} N=1024 ({len(labels)} clouds of {STORED} points, {steps} steps): host "
              f"path median {host:.4f} s ({host / steps * 1e3:.4f} ms a step), device-resident median {device:.4f} s "
              f"({device / steps * 1e3:.4f} ms a step), host / resident {host / device:.4f}; rounds "
              f"{', '.join(f'{p} {t:.4f}' for p, t in rounds)} ({smi})")
        for path in ("host", "device"):
            print(f"epoch {model} f32 B={batch} {path} path, traced: {shown(traced(lambda: run(path)))} ({smi})")


def evaluation(smi: str) -> None:
    import numpy as np
    import torch

    import chip_smoke as cs
    from scanobjectnn_torch.data.synthetic import make_synthetic_dataset
    from scanobjectnn_torch.train.trainer import Trainer, TrainerConfig

    data, labels = make_synthetic_dataset(num_per_class=4, num_classes=NUM_CLASSES, num_points=cs.NUM_POINT, seed=5)
    trainer = Trainer(TrainerConfig(num_point=cs.NUM_POINT, batch_size=32))
    state = trainer.init_state(0)
    stats_rng = np.random.RandomState(23)
    with torch.no_grad():
        for key, buf in state.model.named_buffers():
            vals = stats_rng.randn(*buf.shape)
            buf.copy_(torch.from_numpy(0.1 + 0.1 * np.abs(vals) if key.endswith(".var") else 0.05 * np.abs(vals)))
    results = {}

    def run(path):
        if path == "host":
            results[path] = trainer.evaluate(state, data, labels, num_votes=3, shuffle=False)
        else:
            results[path] = trainer.evaluate_device(state, trainer.upload_dataset({"points": data, "labels": labels}),
                                                    num_votes=3, shuffle=False)

    for path in ("host", "device"):
        run(path)
    if not np.array_equal(results["host"]["predictions"], results["device"]["predictions"]):
        raise SystemExit("resident_epoch: evaluate_device's predictions differ from evaluate's")
    rounds = [(path, wall_s(lambda: run(path)) * 1e3) for path in ORDER]
    host, device = (statistics.median(t for p, t in rounds if p == path) for path in ("host", "device"))
    print(f"evaluate pointnet2_cls_ssg N={cs.NUM_POINT} ({len(labels)} clouds, batch 32, 3 votes, shuffle=False): host "
          f"median {host:.4f} ms, evaluate_device (the upload included) median {device:.4f} ms, host / resident "
          f"{host / device:.4f}; predictions equal ({smi})")
    for path in ("host", "device"):
        print(f"evaluate pointnet2_cls_ssg {path}, traced: {shown(traced(lambda: run(path)))} ({smi})")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("resident_epoch: torch.cuda.is_available() is False; needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    epochs(smi)
    evaluation(smi)
    sync_audit(smi)


if __name__ == "__main__":
    main()
