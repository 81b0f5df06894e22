#!/usr/bin/env python3
"""#17, the fused SA training tail's backward (``csrc/satrain_bwd.cu``),
against the kernel of another checkout (the parent), on one NVIDIA GPU:

    python3 studies/satrain_fma.py --parent DIR    # from the repository root

Two kernel libraries are built: the package's, and the one of the checkout
at ``DIR`` (every ``DIR/scanobjectnn_torch/csrc/*.cu``, bound with that
checkout's own C signatures).  The parent's wrapper
(``DIR/scanobjectnn_torch/ops/cuda/satrain_kernel.py``) drives its library.

1. Call by call, on the inputs #17 gets in ``chip_smoke.py``'s phase-11
   f32 steps with ``fused_sa_train=True`` (B=16, N=1024, seeded weights and
   data): SSG's SA1, SA2 and group-all calls and MSG's two K = 128 calls.
   Each library's output is held to the plain backward under the
   ``FUSED_*`` gates (``chip_smoke.check_satrain_bwd``: two calls bit-equal,
   dz1's flipped share, the sums, the Dense biases' noise); CUDA-event
   times in turns parent, change, change, parent, beside the plain
   backward's, with TFLOP/s against the 3-product work
   (``chip_smoke.satrain_work``) and against the change's own passes
   (``chip_smoke.satrain_design_ops``).
2. The change under other launch plans at SSG's SA2 and group-all calls
   (``satrain_kernel._plan``'s keywords, launched by patching
   ``satrain_kernel.plan``): SA2 in 64-row chunks with the pool in every
   pass (one block an SM) against the default 32-row chunks and pool pass
   (two blocks an SM); group-all in 8-row chunks (the constants in shared
   memory) against the default 16; each held to the gates, times in turns
   default, other, other, default.
3. The f32 SSG and MSG training steps (``Trainer``, B=16) with the fused
   tail on each library and without it, host clock in turns unfused,
   parent, change, change, parent, unfused (three steps a turn).
4. Which side is closer to the exact answer where the kernel and the plain
   backward disagree beyond ``SATRAIN_TOL`` (``tests/test_torch_cuda.py``):
   on that file's inputs at widths (1, 5, 1) and (1, 5, 8) (z1 [2, 8, 16,
   1]) and four layers of 1024 (z1 [1, 2, 8, 1024]), in f32 and bf16, the
   card tests' draw and 15 others, the change, the parent and the plain
   backward (cuBLAS) are each held to the plain backward with float64 sums
   (``satrain_plain64``): the worst error / max|float64| of a cotangent
   (median and max over the draws) and the draws within the SATRAIN_*
   gates, of the result and of the magnitudes it sums
   (``satrain_magnitudes``); at four layers of 1024 also the plain
   backward summed in the kernel's order, and the change against it with
   the statistics summed that way (``satrain_in_kernel_order``).

Prints the card's name and power limit first; exits 1 if a call misses a
gate.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import glob
import importlib.util
import io
import os
import subprocess
import sys
import time
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from scanobjectnn_torch.ops import satrain  # noqa: E402
from scanobjectnn_torch.ops.cuda import _build  # noqa: E402
from scanobjectnn_torch.ops.cuda import satrain_kernel  # noqa: E402


def load_module(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def build_parent(parent: str) -> ctypes.CDLL:
    """The parent's kernels (one nvcc a source, in parallel) as one library,
    each entry point with the parent's own argument types."""
    signatures = load_module("parent_build", os.path.join(parent, "scanobjectnn_torch", "ops", "cuda", "_build.py"))
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    sources = sorted(glob.glob(os.path.join(parent, "scanobjectnn_torch", "csrc", "*.cu")))
    objects = [os.path.join(_build.BUILD_DIR, f"satrain_parent.{os.path.basename(src)}.o") for src in sources]
    nvcc = _build._nvcc()
    procs = [subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-c", src, "-o", obj]) for src, obj in zip(sources, objects)]
    if any(proc.wait() for proc in procs):
        raise RuntimeError("satrain_fma.py: nvcc failed on the parent's sources")
    lib_path = os.path.join(_build.BUILD_DIR, "libsatrain_parent.so")
    subprocess.run([nvcc, *_build.NVCC_FLAGS, "-shared", "-o", lib_path, *objects], check=True)
    lib = ctypes.CDLL(lib_path)
    for fn_name, argtypes in signatures._SIGNATURES.items():
        if hasattr(lib, fn_name):
            fn = getattr(lib, fn_name)
            fn.argtypes, fn.restype = argtypes, signatures._RESTYPES.get(fn_name, ctypes.c_int)
    lib.kernel_error_string.argtypes, lib.kernel_error_string.restype = (ctypes.c_int,), ctypes.c_char_p
    return lib


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", required=True, help="a checkout whose #17 to hold this one against")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("satrain_fma.py: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    parent = os.path.abspath(args.parent)

    from scanobjectnn_torch.data.pipeline import Batches, EpochSampler
    from scanobjectnn_torch.data.synthetic import make_synthetic_dataset
    from scanobjectnn_torch.train.trainer import Trainer, TrainerConfig

    sms = satrain_kernel.sm_count(dev)
    libs = {"change": _build.library(), "parent": build_parent(parent)}
    parent_kernel = load_module("parent_satrain_kernel",
                                os.path.join(parent, "scanobjectnn_torch", "ops", "cuda", "satrain_kernel.py"))
    fns = {"change": satrain_kernel.grouped_bn_mlp_pool_bwd, "parent": parent_kernel.grouped_bn_mlp_pool_bwd}

    def run(name, fn):
        """fn() with #17 on `name`'s wrapper and library (everywhere it is called)."""
        with mock.patch.object(_build, "_lib", libs[name]), \
                mock.patch.object(satrain, "grouped_bn_mlp_pool_bwd", fns[name]), \
                mock.patch.object(satrain_kernel, "grouped_bn_mlp_pool_bwd", fns[name]):
            return fn()

    # 4. Closeness to float64, first: it needs no step.
    card_tests = load_module("card_tests", os.path.join(ROOT, "tests", "test_torch_cuda.py"))

    def gates(got, want, dtype, scales=None):
        """(worst error / max|want| of a cotangent but the Dense biases,
        whether ``got`` holds the card tests' SATRAIN_* gates against
        ``want``, x max|want| or x the max of ``scales``' tensor)."""
        worst = max(float((got[key].double() - w.double()).abs().max()) / max(float(w.double().abs().max()), 1e-300)
                    for key, w in want.items() if not key.startswith("dbias"))
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                card_tests._check_satrain(got, {key: w if key == "dz1" else w.float() for key, w in want.items()},
                                          dtype, "", scales)
        except AssertionError:
            return worst, False
        return worst, True

    cancel_cases = {"widths_1_5_1": ((2, 8, 16, 1), (1, 5, 1)), "widths_1_5_8": ((2, 8, 16, 1), (1, 5, 8)),
                    "four_wide": ((1, 2, 8, 1024), (1024,) * 4)}
    seeds = [None, *range(15)]  # None: the card tests' draw
    for case, spec in cancel_cases.items():
        for dtype, pool_mode in ((torch.float32, "0"), (torch.bfloat16, "0"), (torch.bfloat16, "1")):
            sides = ("plain", "change", "parent") + (("order",) if case == "four_wide" else ())
            worst = {side: [] for side in sides}
            held = {side: 0 for side in sides}
            held_mag = {side: 0 for side in sides}
            order_held = 0
            for seed in seeds:
                a = card_tests.satrain_inputs(case, dtype, dev, pool_mode, spec=spec, seed=seed)
                exact = card_tests._flatten_grads(card_tests.satrain_plain64(a))
                mags = card_tests.satrain_magnitudes(a)
                got = {"plain": card_tests._flatten_grads(satrain_kernel.grouped_bn_mlp_pool_bwd_plain(*a))}
                for name in ("change", "parent"):
                    got[name] = card_tests._flatten_grads(run(name, lambda: fns[name](*a)))
                if "order" in sides:
                    with mock.patch.object(satrain_kernel, "_mm", card_tests._chain_mm):
                        got["order"] = card_tests._flatten_grads(satrain_kernel.grouped_bn_mlp_pool_bwd_plain(*a))
                    # the change against its own order, the statistics summed that way too
                    own, want = card_tests.satrain_in_kernel_order(a)
                    order_held += gates(card_tests._flatten_grads(satrain_kernel.grouped_bn_mlp_pool_bwd(*own)),
                                        card_tests._flatten_grads(want), dtype)[1]
                torch.cuda.synchronize()
                for side in sides:
                    err, ok = gates(got[side], exact, dtype)
                    worst[side].append(err)
                    held[side] += ok
                    held_mag[side] += gates(got[side], exact, dtype, mags)[1]
                if seed is None:
                    print(f"#17 {case} {spec[1]} {dtype} mode {pool_mode}, the card tests' draw, worst error / "
                          f"max|float64|: " + ", ".join(f"{side} {worst[side][0]:.3e}" for side in sides), flush=True)
            print(f"#17 {case} {spec[1]} {dtype} mode {pool_mode} over {len(seeds)} draws against float64: " + "; ".join(
                f"{side} worst error / max|float64| median {sorted(v)[len(v) // 2]:.3e}, max {max(v):.3e}, "
                f"{held[side]} of {len(seeds)} within the SATRAIN_* gates, {held_mag[side]} with the tolerance "
                f"taken of the magnitudes summed" for side, v in worst.items())
                + (f"; the change within the gates of its own order {order_held} of {len(seeds)}"
                   if "order" in sides else "") + f" ({smi})", flush=True)

    # Phase 11's data and steps.
    b, n = cs.MIXED_BATCH, cs.MIXED_POINT
    data, labels = make_synthetic_dataset(num_per_class=5, num_classes=cs.NUM_CLASSES, num_points=2 * n, seed=11)
    batches = list(Batches(EpochSampler(data, labels, num_points=n, seed=0).epoch(), b))
    selected = {"SSG": {(512, 32), (128, 64), (1, 128)}, "MSG": {(512, 128), (128, 128)}}
    failed = []
    for model in ("pointnet2_cls_ssg", "pointnet2_cls_msg"):
        short = model.split("_")[-1].upper()
        fused = Trainer(TrainerConfig(model=model, batch_size=b, pool_precision="native", fused_sa_train=True,
                                      device=str(dev)))
        state = fused.init_state(seed=0)
        calls = []

        def recorder(*a):
            calls.append(cs.clone_args(a))
            return satrain_kernel.grouped_bn_mlp_pool_bwd(*a)

        with mock.patch.object(satrain, "grouped_bn_mlp_pool_bwd", recorder):
            fused.train_step(state, batches[0])
        torch.cuda.synchronize()

        # 1. Call by call.
        for a in calls:
            z1, widths = a[0], [int(g.shape[0]) for g in a[1]]
            if tuple(z1.shape[1:3]) not in selected[short]:
                continue
            label = f"{short} f32 z1 {list(z1.shape)} widths {widths}"
            for name in ("parent", "change"):
                try:
                    run(name, lambda: cs.check_satrain_bwd(a, f"{label}, {name}"))
                except AssertionError as err:
                    print(f"#17 {label} {name}: {err}", flush=True)
                    failed.append(f"{label} {name}")
            ms = {"parent": [], "change": []}
            for name in ("parent", "change", "change", "parent"):
                ms[name].append(run(name, lambda: cs.cuda_ms(lambda: fns[name](*a), iters=5)))
            plain_ms = cs.cuda_ms(lambda: satrain_kernel.grouped_bn_mlp_pool_bwd_plain(*a), iters=3)
            mean = {name: sum(v) / len(v) for name, v in ms.items()}
            one = cs.Work()
            cs.satrain_work(one, z1, widths)
            three = one.ops_s * cs.F32_OPS_PER_S
            rows, groups = z1[..., 0].numel(), z1.shape[0] * z1.shape[1]
            layout = satrain_kernel.plan(groups, z1.shape[2], widths, sms)
            own = cs.satrain_design_ops(rows, widths, layout)
            print(f"#17 {label}: change {ms['change']} ms, parent {ms['parent']} ms (mean {mean['change']:.4f} "
                  f"against {mean['parent']:.4f}: {mean['parent'] / mean['change']:.3f}x), plain {plain_ms:.4f} ms; "
                  f"3-product work {three / 1e9:.3f} GFLOP (bound {one.record()['bound_ms']:.4f} ms): change "
                  f"{three / mean['change'] / 1e9:.2f} TFLOP/s, parent {three / mean['parent'] / 1e9:.2f}; the "
                  f"change's own {own / 1e9:.3f} GFLOP at {own / mean['change'] / 1e9:.2f} TFLOP/s (rows "
                  f"{layout.rows}, pool in the pass {layout.pool_in_pass}) ({smi})", flush=True)

        # 2. Other launch plans.
        others = {(128, 64): dict(rows=64, consts_smem=True), (1, 128): dict(rows=8)} if short == "SSG" else {}
        for a in calls:
            z1, widths = a[0], [int(g.shape[0]) for g in a[1]]
            kw = others.get(tuple(z1.shape[1:3]))
            if kw is None:
                continue
            groups, k = z1.shape[0] * z1.shape[1], z1.shape[2]
            layouts = {"default": satrain_kernel.plan(groups, k, widths, sms),
                       "other": satrain_kernel._plan(groups, k, tuple(widths), sms, **kw)}
            label = f"{short} f32 z1 {list(z1.shape)} widths {widths}"
            ms = {"default": [], "other": []}
            for name in ("default", "other", "other", "default"):
                with mock.patch.object(satrain_kernel, "plan", lambda *_, layout=layouts[name]: layout):
                    if len(ms[name]) == 0:
                        try:
                            cs.check_satrain_bwd(a, f"{label}, {name} plan")
                        except AssertionError as err:
                            print(f"#17 {label} {name} plan: {err}", flush=True)
                            failed.append(f"{label} {name} plan")
                    ms[name].append(cs.cuda_ms(lambda: satrain_kernel.grouped_bn_mlp_pool_bwd(*a), iters=5))
            print(f"#17 {label}: " + "; ".join(
                f"{name} plan (rows {lay.rows}, pool in the pass {lay.pool_in_pass}, constants in shared memory "
                f"{lay.consts_smem}, blocks {[q.blocks for q in lay.passes]}) {ms[name]} ms"
                for name, lay in layouts.items()) + f" ({smi})", flush=True)

        # 3. The steps.
        unfused = Trainer(TrainerConfig(model=model, batch_size=b, device=str(dev)))
        trainers = {"unfused": unfused, "parent": fused, "change": fused}
        states = {name: t.init_state(seed=0) for name, t in trainers.items()}

        def step_ms(name: str) -> float:
            def go():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for batch in batches[:3]:
                    trainers[name].train_step(states[name], batch)
                torch.cuda.synchronize()
                return (time.perf_counter() - t0) * 1e3 / 3
            return go() if name == "unfused" else run(name, go)

        for name in trainers:
            step_ms(name)  # warm up
        times = {name: [] for name in trainers}
        for name in ("unfused", "parent", "change", "change", "parent", "unfused"):
            times[name].append(step_ms(name))
        print(f"f32 {short} train step B={b} N={n}: " + ", ".join(
            f"{'fused tail, ' + name if name != 'unfused' else name} {sum(v) / len(v):.4f} ms (rounds "
            f"{', '.join(f'{x:.4f}' for x in v)})" for name, v in times.items()) + f" ({smi})", flush=True)
    if failed:
        sys.exit(f"satrain_fma.py: calls missed the FUSED_* gates: {failed}")


if __name__ == "__main__":
    main()
