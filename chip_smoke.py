#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root, on a CUDA machine

Phases (any failure raises and the exit code is not 0):
  1. build the CUDA kernels of ``scanobjectnn_torch/csrc`` with nvcc;
  2. hold each kernel against its plain PyTorch version on the card at the
     shapes of the main path (FPS 2048->512 and 512->128; the fused SA1 and
     SA2 layers at B=128 in f32 and bf16), and time both with CUDA events;
  3. answer a few batches of a 15-class synthetic dataset (N=2048, B=128)
     with the full-width ``pointnet2_cls_ssg`` built by ``get_model`` (seeded
     weights; random positive BN running stats, so the BN fold matters,
     sized so the activations neither vanish nor blow up), in
     bf16 and f32, counting the kernels' launches; then run the same model
     on the plain path on the same card and compare the logits.

f32 products run in full f32: TF32 is switched off for matmuls and cuDNN.
Prints the card's name and power limit, the build time, per-kernel times,
a ``{"kernels": [...]}`` line, and as its last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from unittest import mock

BATCH, NUM_POINT, NUM_CLASSES = 128, 2048, 15
# Tolerances (kernel vs plain version on the same card).  f32: only the
# summation order differs.  bf16: both sum the same bf16-rounded products in
# f32 and round at the same points, so they agree bit for bit (every run on
# an H100 read 0).  Allowed: a difference of at most BF16_*_ULPS bf16 ulps
# of the scale max(1, |ref|max), on at most BF16_MAX_DIFFERING of the
# elements.  A kernel that skipped a rounding between layers differs on far
# more.
F32_RTOL, F32_ATOL = 1e-4, 1e-5
F32_LOGIT_TOL = 1e-4  # x max(1, |ref|max)
BF16_SA_ULPS, BF16_LOGIT_ULPS = 1, 2
BF16_MAX_DIFFERING = 1e-3
BF16_CLASS_AGREEMENT = 0.99


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds per call on the current stream (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def scale_of(ref) -> float:
    return max(1.0, float(ref.float().abs().max()))


def check_bf16(got, want, ulps: int, what: str) -> tuple[float, float]:
    """Hold a bf16 result to ``want`` by the bf16 rule above; returns (max
    abs error, share of elements that differ)."""
    diff = (got.float() - want.float()).abs()
    err, differing = float(diff.max()), float((diff > 0).float().mean())
    bound = ulps * 2.0 ** (math.floor(math.log2(scale_of(want))) - 7)  # bf16 keeps 8 bits
    print(f"{what}: max abs err {err:.3e} (bound {bound:.3e}), "
          f"{differing:.2e} of elements differ (bound {BF16_MAX_DIFFERING:.0e})")
    require(err <= bound and differing <= BF16_MAX_DIFFERING, f"{what} differs from the plain version")
    return err, differing


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"chip_smoke: {what}")


def check_fps(xyz, npoint, label, fps, fps_plain) -> float:
    import torch

    idx, new_xyz = fps(xyz, npoint)
    ref_idx, ref_xyz = fps_plain(xyz, npoint)
    torch.cuda.synchronize()
    require(torch.equal(idx, ref_idx), f"FPS indices differ from fps_plain ({label})")
    require(torch.equal(new_xyz, ref_xyz), f"FPS coordinates differ from fps_plain ({label})")
    print(f"fps {label}: indices and coordinates equal to fps_plain")
    return float((new_xyz - ref_xyz).abs().max())


def check_sa(args, dtype, label, sa, sa_plain) -> float:
    import torch

    pooled, idx = sa(*args, dtype=dtype)
    ref, ref_idx = sa_plain(*args, dtype=dtype)
    torch.cuda.synchronize()
    require(torch.equal(idx, ref_idx), f"SA idx differs from the plain version ({label})")
    require(pooled.dtype == ref.dtype and pooled.shape == ref.shape, f"SA output type ({label})")
    if dtype == torch.bfloat16:
        return check_bf16(pooled, ref, BF16_SA_ULPS, f"sa {label}: idx equal, pooled")[0]
    err = float((pooled - ref).abs().max())
    require(torch.allclose(pooled, ref, rtol=F32_RTOL, atol=F32_ATOL),
            f"SA pooled differs from the plain version ({label}): max abs err {err}")
    print(f"sa {label}: idx equal, pooled max abs err {err:.3e} (bound rtol {F32_RTOL} atol {F32_ATOL})")
    return err


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA GPU")
    # f32 matmuls must not run in TF32 (the plain path is the f32 reference).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import numpy as np

    from scanobjectnn_torch.data.synthetic import make_synthetic_dataset
    from scanobjectnn_torch.models import get_model
    from scanobjectnn_torch.ops import fps as ops_fps
    from scanobjectnn_torch.ops.cuda import _build
    from scanobjectnn_torch.ops.cuda.fps_kernel import fps, fps_plain
    from scanobjectnn_torch.ops.cuda.safused_kernel import sa_ball_mlp_pool, sa_ball_mlp_pool_plain
    from scanobjectnn_torch.nn import pointnet_modules

    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # 1. Build.
    t0 = time.perf_counter()
    _build.library()
    print(f"build: nvcc {_build.build_seconds if _build.build_seconds is not None else 0.0:.2f} s "
          f"(library ready after {time.perf_counter() - t0:.2f} s)")

    # Data and model.
    data, labels = make_synthetic_dataset(
        num_per_class=18, num_classes=NUM_CLASSES, num_points=NUM_POINT, seed=0
    )
    order = np.random.RandomState(0).permutation(len(data))[: 2 * BATCH]
    batches = [torch.from_numpy(data[order[i * BATCH:(i + 1) * BATCH]]).to(dev) for i in range(2)]
    stats_rng = np.random.RandomState(1)
    models = {}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", None)):
        model = get_model("pointnet2_cls_ssg", generator=torch.Generator().manual_seed(0), dtype=dtype)
        with torch.no_grad():
            for key, buf in model.named_buffers():
                vals = stats_rng.randn(*buf.shape)
                buf.copy_(torch.from_numpy(
                    0.1 + 0.1 * np.abs(vals) if key.endswith(".var") else 0.05 * np.abs(vals)
                ))
        models[name] = model.to(dev).eval()

    # 2. Kernels against their plain versions, at the main path's shapes.
    # errs: max abs error per kernel; per_forward: [kernel ms, plain ms]
    # summed over the calls one bf16 forward makes (FPS both layers, SA1+SA2).
    errs = {"fps": 0.0, "sa_ball_mlp_pool": 0.0}
    per_forward = {"fps": [0.0, 0.0], "sa_ball_mlp_pool": [0.0, 0.0]}

    def record(kname, label, ms, plain_ms, in_bf16_forward):
        print(f"time {kname} {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms ({smi})")
        if in_bf16_forward:
            per_forward[kname][0] += ms
            per_forward[kname][1] += plain_ms

    x0 = batches[0]
    _, sa1_xyz = fps_plain(x0, 512)
    _, sa2_xyz = fps_plain(sa1_xyz, 128)
    g = torch.Generator().manual_seed(2)
    lattice = torch.randint(-3, 4, (8, 256, 3), generator=g).float() * 0.25
    ties = lattice.repeat(1, 8, 1)[:, torch.randperm(2048, generator=g)].contiguous().to(dev)
    nan_cloud = x0[:2].clone()
    nan_cloud[1, 5, 1] = float("nan")
    for xyz, npoint, label in (
        (x0, 512, "B=128 2048->512"), (sa1_xyz, 128, "B=128 512->128"),
        (ties, 512, "duplicated lattice points (ties)"), (nan_cloud, 64, "cloud with a NaN point"),
    ):
        errs["fps"] = max(errs["fps"], check_fps(xyz, npoint, label, fps, fps_plain))
    for xyz, npoint, label in ((x0, 512, "2048->512"), (sa1_xyz, 128, "512->128")):
        record("fps", label, cuda_ms(lambda: fps(xyz, npoint)),
               cuda_ms(lambda: fps_plain(xyz, npoint), iters=3), True)

    for name in ("f32", "bf16"):
        model = models[name]
        dtype = torch.float32 if name == "f32" else torch.bfloat16
        with torch.no_grad():
            w1, b1 = model.sa1.mlp.folded()
            w2, b2 = model.sa2.mlp.folded()
            sa1_args = (0.2, 32, x0, sa1_xyz, None, w1, b1)
            pooled1, _ = sa_ball_mlp_pool_plain(*sa1_args, dtype=dtype)
            sa2_args = (0.4, 64, sa1_xyz, sa2_xyz, pooled1, w2, b2)
            for label, args in (("SA1", sa1_args), ("SA2", sa2_args)):
                full = f"{label} {name} B=128"
                errs["sa_ball_mlp_pool"] = max(
                    errs["sa_ball_mlp_pool"],
                    check_sa(args, dtype, full, sa_ball_mlp_pool, sa_ball_mlp_pool_plain),
                )
                record("sa_ball_mlp_pool", full,
                       cuda_ms(lambda: sa_ball_mlp_pool(*args, dtype=dtype)),
                       cuda_ms(lambda: sa_ball_mlp_pool_plain(*args, dtype=dtype), iters=3),
                       name == "bf16")

    # 3. The main path: get_model -> model(points), counting kernel launches.
    fps.launches = 0
    sa_ball_mlp_pool.launches = 0
    logits = {}
    with torch.no_grad():
        for name, model in models.items():
            logits[name] = [model(x)["logits"] for x in batches]
    torch.cuda.synchronize()
    launches = {"fps": fps.launches, "sa_ball_mlp_pool": sa_ball_mlp_pool.launches}
    print(f"main path launches: {launches}")
    require(all(n > 0 for n in launches.values()), f"a kernel of the path never launched: {launches}")

    # The same model on the plain path, same card: the wrappers swapped for
    # the plain versions inside the two modules that call them.
    def fps_plain_entry(xyz, npoint, with_coords=True):
        idx, new_xyz = fps_plain(xyz, npoint)
        return (idx, new_xyz) if with_coords else idx

    with torch.no_grad(), mock.patch.object(ops_fps, "fps", fps_plain_entry), mock.patch.object(
        pointnet_modules, "sa_ball_mlp_pool", sa_ball_mlp_pool_plain
    ):
        ref = {name: [m(x)["logits"] for x in batches] for name, m in models.items()}
        plain_fwd_ms = {name: cuda_ms(lambda: m(batches[0]), iters=3) for name, m in models.items()}
    require(fps.launches == launches["fps"] and sa_ball_mlp_pool.launches == launches["sa_ball_mlp_pool"],
            "the plain path launched a kernel")

    for name in models:
        got, want = torch.cat(logits[name]), torch.cat(ref[name])
        require(got.shape == (2 * BATCH, NUM_CLASSES), f"logits shape {tuple(got.shape)}")
        require(bool(torch.isfinite(got.float()).all()), f"non-finite logits ({name})")
        agree = float((got.float().argmax(1) == want.float().argmax(1)).float().mean())
        n_classes = int(want.float().argmax(1).unique().numel())
        if name == "bf16":
            check_bf16(got, want, BF16_LOGIT_ULPS, "model bf16: logits")
        else:
            err, tol = float((got - want).abs().max()), F32_LOGIT_TOL * scale_of(want)
            print(f"model f32: logits max abs err {err:.3e} (bound {tol:.3e})")
            require(err <= tol, f"f32 logits differ from the plain path: {err} > {tol}")
        print(f"model {name}: class agreement {agree:.4f}, {n_classes} distinct predicted classes")
        require(agree >= (BF16_CLASS_AGREEMENT if name == "bf16" else 1.0), f"{name} class agreement {agree}")

    with torch.no_grad():
        for name, m in models.items():
            ms = cuda_ms(lambda: m(batches[0]))
            print(f"time forward {name} B={BATCH} N={NUM_POINT}: kernel path {ms:.4f} ms "
                  f"({BATCH / ms * 1e3:.1f} clouds/s), plain path {plain_fwd_ms[name]:.4f} ms ({smi})")

    require(not {"jax", "scanobjectnn_tpu"} & set(sys.modules), "JAX or the JAX package was imported")

    sources = {
        "fps": ("scanobjectnn_torch/csrc/fps.cu", "scanobjectnn_tpu/ops/pallas/fps_kernel.py:151"),
        "sa_ball_mlp_pool": (
            "scanobjectnn_torch/csrc/safused.cu", "scanobjectnn_tpu/ops/pallas/safused_kernel.py:354",
        ),
    }
    kernels = [
        {"name": k, "route": "cuda", "source": src, "replaces": tpu, "launches": launches[k],
         "max_abs_err": errs[k], "ms": per_forward[k][0], "plain_ms": per_forward[k][1]}
        for k, (src, tpu) in sources.items()
    ]
    print("kernel ms / plain_ms: summed over one bf16 forward's calls at B=128 (FPS both layers, SA1+SA2)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
