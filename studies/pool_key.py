#!/usr/bin/env python3
"""The exact-key pool (#18, ``csrc/poolkey.cu``) and the 3DmFV step against
another checkout's (the parent), on one NVIDIA GPU:

    python3 studies/pool_key.py --parent DIR    # from the repository root

Two kernel libraries are built: the package's, and the package's with
``poolkey.cu`` taken from ``DIR/scanobjectnn_torch/csrc``
(``graph_fps.build``).  The package's wrapper runs against each in turn;
where the parent's ``poolkey_launch`` takes no plan (vec, lanes, teams),
those arguments are dropped on the way to it.

1. Call by call: the #18 calls of one bf16 keys-mode step each of
   ``pointnet_cls`` (B=32, N=1024: three global pools, rows 32, K = C =
   1024), ``pointnet2_cls_ssg`` and ``pointnet2_cls_msg`` (B=16, N=1024),
   recorded from ``Trainer.train_step``.  Every output bit-equal to the
   parent's and to the plain version; each call timed by CUDA events in
   turns parent, change, change, parent beside its bound, and each step's
   calls summed (also by device time).  On the change alone: other launch
   plans at PointNet's call and SSG's three (the column route, wider or
   narrower teams, one channel a lane), each held
   to the plain version and timed, with its build's registers and blocks
   per SM.
2. Device busy time and idle share: ``profile_forward.py --model
   3dmfv_net_cls --train`` (the f32 3DmFV step at B=64: the deterministic
   convolutions and pool backward against the parent's) and ``--model
   pointnet_cls --train --dtype bfloat16`` from both trees in turns parent,
   change, change, parent (each tree builds its own library).

With ``--sweep`` it measures the design space instead (the parent's kernel
timed beside it at each call where ``--parent`` is given):

3. #18 on the recorded calls of PointNet's global pool, SSG's three and
   MSG's SA1 K = 16 and 128 and SA2 K = 128 scales, by device time, on every
   launch plan the entry point takes (vec 1 and 4; 8 to 256 lanes; 1-32
   teams) on the package's
   build; then its six best plans and every column-route plan again on a
   "lazy" build whose slots below the running best skip their value chain,
   one loading 8 slots ahead, one whose column route's registers are not
   capped at 32 (vec 1), and one whose column route is also held to 64
   registers at vec 4.  Each output held to the plain version; each
   build's registers.
4. The 3DmFV f32 step at B=64 (``Trainer``, seed 1), with cuDNN's
   deterministic algorithms on for the whole convolution, for its weight
   gradient alone, or off, and with the pool's own backward or PyTorch's:
   whether two equal steps give equal bits in every gradient and BN
   statistic, and the step's device busy time
   (``profile_forward.profile_one``).

Prints the card's name and power limit first; exits 1 if an output differs
from the parent's or the plain version's.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import os
import subprocess
import sys
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "studies"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from edge_dup import mean, profile_runs, same_bits  # noqa: E402
from graph_fps import build  # noqa: E402
from knn_edge import PlanlessLib  # noqa: E402
from scanobjectnn_torch.ops.cuda import _build  # noqa: E402

SWAPPED = ("poolkey.cu",)
# The places of the package's poolkey_launch arguments that a parent before
# this design does not take, and the text its source then lacks.
PLAN_ARGS = {"poolkey_launch": ((9, 10, 11), "poolkey.cu", "int teams")}
# The steps whose #18 calls are recorded: (model, batch).
STEPS = (("pointnet_cls", cs.PN_BATCH), ("pointnet2_cls_ssg", cs.MIXED_BATCH), ("pointnet2_cls_msg", cs.MIXED_BATCH))
# profile_forward.py runs from both trees: (arguments, the run's key).
PROFILES = ((["--model", "3dmfv_net_cls", "--train"], "train_f32"),
            (["--model", "pointnet_cls", "--train", "--dtype", "bfloat16"], "train_bf16"))


def parent_library(parent: str):
    csrc = os.path.join(parent, "scanobjectnn_torch", "csrc")
    sources = [os.path.join(csrc, os.path.basename(src)) if os.path.basename(src) in SWAPPED else src
               for src in sorted(glob.glob(os.path.join(_build.CSRC, "*.cu")))]
    lib = build("pool_key_parent", sources)
    dropped = {}
    for name, (places, source, text) in PLAN_ARGS.items():
        with open(os.path.join(csrc, source)) as f:
            if text not in f.read():
                dropped[name] = places
    return PlanlessLib(lib, dropped) if dropped else lib


def record_calls(model: str, batch_size: int) -> list[tuple]:
    """The #18 calls of one bf16 keys-mode step of ``model``, recorded."""
    from scanobjectnn_torch.data.pipeline import Batches, EpochSampler
    from scanobjectnn_torch.data.synthetic import make_synthetic_dataset
    from scanobjectnn_torch.ops import exactpool
    from scanobjectnn_torch.ops.cuda.poolkey_kernel import bn_relu_exactkey_pool
    from scanobjectnn_torch.train.trainer import Trainer, TrainerConfig

    data, labels = make_synthetic_dataset(num_per_class=5, num_classes=cs.NUM_CLASSES, num_points=2048, seed=11)
    batch = next(iter(Batches(EpochSampler(data, labels, num_points=1024, seed=0).epoch(), batch_size)))
    trainer = Trainer(TrainerConfig(model=model, batch_size=batch_size, dtype="bfloat16", device="cuda"))
    state = trainer.init_state(seed=0)
    calls = []

    def recorder(*args):
        calls.append(cs.clone_args(args))
        return bn_relu_exactkey_pool(*args)

    with mock.patch.object(exactpool, "bn_relu_exactkey_pool", recorder):
        trainer.train_step(state, batch)
    torch.cuda.synchronize()
    return calls


# The package's slot update (every slot's value chain computed and merged),
# and a "lazy" one whose slots below the running best skip their value
# chain, for the sweep's variant builds.
EAGER = """        const float y = relu(cd<BF16>(affine(cd<BF16>(zv[q][v]), mu[v], r[v], g[v], b[v])));
        const float key = relu(affine(zv[q][v], mu[v], r[v], g[v], b[v]));
        merge(best[v], n[v], pool[v], key, 1.f, y);
        if (key != key) nan |= 1 << v;
"""
LAZY = """        const float key = relu(affine(zv[q][v], mu[v], r[v], g[v], b[v]));
        if (!(key < best[v])) {  // a NaN key too
          const float y = relu(cd<BF16>(affine(cd<BF16>(zv[q][v]), mu[v], r[v], g[v], b[v])));
          if (key != key) {
            nan |= 1 << v;
          } else {
            merge(best[v], n[v], pool[v], key, 1.f, y);
          }
        }
"""
AHEAD4, AHEAD8 = "constexpr int kAhead = 4;", "constexpr int kAhead = 8;"
PACKAGE_CAP = "constexpr int kColumnBlocks1 = 8, kColumnBlocks4 = 1;"
UNCAPPED = "constexpr int kColumnBlocks1 = 1, kColumnBlocks4 = 1;"
CAPPED = "constexpr int kColumnBlocks1 = 8, kColumnBlocks4 = 4;"  # 32 and 64 registers
VARIANTS = {
    "lazy": lambda t: t.replace(EAGER, LAZY),
    "ahead8": lambda t: t.replace(AHEAD4, AHEAD8),
    "uncapped": lambda t: t.replace(PACKAGE_CAP, UNCAPPED),
    "capped": lambda t: t.replace(PACKAGE_CAP, CAPPED),
}


def variant_library(name: str):
    """``fps.cu`` (the error strings) and ``poolkey.cu`` edited by
    ``VARIANTS[name]``, built apart."""
    with open(os.path.join(_build.CSRC, "poolkey.cu")) as f:
        text = f.read()
    edited = VARIANTS[name](text)
    if edited == text:
        raise RuntimeError(f"pool_key.py: the {name} edit matched nothing")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(_build.BUILD_DIR, f"poolkey_{name}.cu")
    with open(path, "w") as f:
        f.write(edited)
    return build(f"pool_key_{name}", [os.path.join(_build.CSRC, "fps.cu"), path])


def candidate_plans(rows: int, k: int, c: int) -> list:
    """Every plan the entry point takes for the call, within the sweep's
    ranges (module doc)."""
    from scanobjectnn_torch.ops.cuda.poolkey_kernel import Plan

    out = []
    for vec in ((1, 4) if c % 4 == 0 else (1,)):
        for lanes in (8, 16, 32, 64, 128, 256):
            if lanes * vec > 2 * c and lanes > 8:
                continue  # a tile more than twice the row
            for teams in ((1, 2, 4, 8, 16, 32) if lanes <= 32 else (1,)):
                if not 32 <= lanes * teams <= 256 or teams > k:
                    continue
                out.append(Plan(vec, lanes, teams))
    return out


def sweep(smi: str, parent: str | None) -> list[str]:
    """Sections 3 and 4 (module doc), with the parent's kernel timed at each
    call where ``parent`` is given; returns the failures."""
    from profile_forward import profile_one
    from scanobjectnn_torch.models import threedmfv
    from scanobjectnn_torch.ops.cuda import poolkey_kernel
    from scanobjectnn_torch.ops.cuda.poolkey_kernel import bn_relu_exactkey_pool, bn_relu_exactkey_pool_plain

    failed = []
    libs = {"package": _build.library(), **{name: variant_library(name) for name in VARIANTS}}
    parent_lib = parent_library(parent) if parent else None
    for name, lib in libs.items():
        for vec in (1, 4):
            for columns in (0, 1):
                info = (ctypes.c_int * 4)()
                _build.check(lib.poolkey_info(1, vec, 256, columns, ctypes.addressof(info)), "poolkey_info")
                print(f"#18 build {name}, bf16, vec {vec}, {'column' if columns else 'split'} route: registers "
                      f"{info[0]}, local bytes {info[1]}, blocks of 256 threads per SM {info[3]} ({smi})", flush=True)
    recorded = {model: record_calls(model, b) for model, b in STEPS}
    calls = {"pointnet": recorded["pointnet_cls"][0], "ssg_sa1": recorded["pointnet2_cls_ssg"][0],
             "ssg_sa2": recorded["pointnet2_cls_ssg"][1], "ssg_group_all": recorded["pointnet2_cls_ssg"][2],
             "msg_sa1_k16": recorded["pointnet2_cls_msg"][0], "msg_sa1_k128": recorded["pointnet2_cls_msg"][2],
             "msg_sa2_k128": recorded["pointnet2_cls_msg"][5]}

    def timed(lib, call, p, label):
        with mock.patch.object(_build, "_lib", lib), mock.patch.object(poolkey_kernel, "plan", lambda *a, **kw: p):
            got = bn_relu_exactkey_pool(*call)
            torch.cuda.synchronize()
            if not all(same_bits(a, b) for a, b in zip(got, bn_relu_exactkey_pool_plain(*call))):
                failed.append(f"#18 sweep {label} against the plain version")
            return cs.device_ms(lambda: bn_relu_exactkey_pool(*call))

    for shape, call in calls.items():
        z32 = call[0]
        k, c = z32.shape[-2:]
        rows = z32.numel() // (k * c)
        work = cs.Work()
        cs.poolkey_work(work, z32, call[5])
        bound = work.record()["bound_ms"]
        own = poolkey_kernel.plan(rows, k, c)
        results = {}
        for p in candidate_plans(rows, k, c):
            results[("package", p)] = timed(libs["package"], call, p, f"{shape} package {tuple(p)}")
        ranked = sorted((ms, p) for (name, p), ms in results.items() if name == "package")
        again = {p for _, p in ranked[:6]} | {p for _, p in ranked if p.teams == 1}
        for name in VARIANTS:
            for p in sorted(again):
                results[(name, p)] = timed(libs[name], call, p, f"{shape} {name} {tuple(p)}")
        parent_ms = float("nan")
        if parent_lib is not None:
            with mock.patch.object(_build, "_lib", parent_lib):
                parent_ms = cs.device_ms(lambda: bn_relu_exactkey_pool(*call))
        print(f"#18 sweep {shape} (rows {rows}, K={k}, C={c}): bound {bound:.4f} ms; plan() {tuple(own)}: package "
              f"{results.get(('package', own), float('nan')):.4f} ms; the parent's kernel {parent_ms:.4f} ms ({smi})",
              flush=True)
        for name in libs:
            mine = sorted((ms, tuple(p)) for (n, p), ms in results.items() if n == name)
            print(f"  {name}: best " + ", ".join(f"{p} {ms:.4f}" for ms, p in mine[:5])
                  + f"; worst {mine[-1][1]} {mine[-1][0]:.4f} ms ({len(mine)} plans)", flush=True)

    # 4. The 3DmFV step's determinism, by source, and its busy time.
    from scanobjectnn_torch.data.synthetic import make_synthetic_dataset
    from scanobjectnn_torch.train.trainer import Trainer, TrainerConfig

    data, labels = make_synthetic_dataset(num_per_class=5, num_classes=15, num_points=1024, seed=0)
    batch = {"points": data[:64], "labels": labels[:64]}
    cudnn = torch.backends.cudnn
    real_scope, real_pool = threedmfv._cudnn_exact, threedmfv._avg_pool_same
    real_bwd = staticmethod(threedmfv._Conv3dExact.backward)

    def scope(det):
        def make(on_card):
            ctx = real_scope(on_card)
            if det:
                return ctx

            class Off:
                def __enter__(self):
                    ctx.__enter__()
                    self.before = cudnn.deterministic
                    cudnn.deterministic = False

                def __exit__(self, *exc):
                    cudnn.deterministic = self.before
                    return ctx.__exit__(*exc)
            return Off()
        return make

    def wgrad_only_backward(ctx, dy):
        x, w = ctx.saved_tensors
        p = ctx.padding
        grads = []
        for det, mask in ((False, [ctx.needs_input_grad[0], False, False]),
                          (True, [False, ctx.needs_input_grad[1], ctx.needs_input_grad[2]])):
            with real_scope(True):
                cudnn.deterministic = det
                grads.append(torch.ops.aten.convolution_backward(
                    dy, x, w, [w.shape[0]], [1, 1, 1], [p, p, p], [1, 1, 1], False, [0, 0, 0], 1, mask))
        return grads[0][0], grads[1][1], grads[1][2], None

    def old_pool(x, k):
        pad = k // 2
        padded = torch.nn.functional.pad(threedmfv._channels_first(x), (pad, pad) * 3)
        return threedmfv._channels_last(torch.nn.functional.avg_pool3d(padded, k, stride=1))

    settings = {"deterministic, pool's own backward (the package)": (scope(True), real_pool, real_bwd),
                "deterministic off, pool's own backward": (scope(False), real_pool, real_bwd),
                "deterministic, PyTorch's pool backward": (scope(True), old_pool, real_bwd),
                "deterministic off, PyTorch's pool backward (the parent)": (scope(False), old_pool, real_bwd),
                "deterministic for the weight gradient only, pool's own backward":
                    (scope(True), real_pool, staticmethod(wgrad_only_backward))}
    for label, (scope_fn, pool_fn, bwd) in settings.items():
        with mock.patch.object(threedmfv, "_cudnn_exact", scope_fn), \
                mock.patch.object(threedmfv, "_avg_pool_same", pool_fn), \
                mock.patch.object(threedmfv._Conv3dExact, "backward", bwd):
            trainer = Trainer(TrainerConfig(model="3dmfv_net_cls", batch_size=64, device="cuda"))
            grads = []
            for _ in range(2):
                state = trainer.init_state(seed=1)
                state, metrics = trainer.train_step(state, batch)
                torch.cuda.synchronize()
                grads.append({**{n: q.grad.clone() for n, q in state.model.named_parameters()},
                              **{n: b.clone() for n, b in state.model.named_buffers()},
                              "loss": torch.tensor([float(metrics["loss"])])})
            differ = [n for n in grads[0] if not same_bits(grads[0][n], grads[1][n])]
            state = trainer.init_state(seed=1)
            res = profile_one(lambda: trainer.train_step(state, batch), 5)
        print(f"3dmfv_net_cls f32 step B=64, {label}: two equal steps "
              + ("equal bit for bit" if not differ else f"differ in {len(differ)} of {len(grads[0])} (e.g. {differ[:3]})")
              + f"; device busy {res['device_busy_ms']:.4f} ms, {res['kernels']:.0f} kernels, idle share "
              f"{res['idle_share_of_window']:.4f} ({smi})", flush=True)
    return failed


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", help="a checkout whose poolkey.cu to hold this one against")
    parser.add_argument("--sweep", action="store_true", help="the plans, builds and 3DmFV settings (module doc)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("pool_key.py: needs an NVIDIA GPU")
    if not args.sweep and not args.parent:
        sys.exit("pool_key.py: give --parent DIR, or --sweep")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.sweep:
        failed = sweep(smi, os.path.abspath(args.parent) if args.parent else None)
        if failed:
            print("FAILED: " + "; ".join(failed))
            sys.exit(1)
        print("pool_key.py --sweep: every output bit-equal to the plain version")
        return

    from scanobjectnn_torch.ops.cuda import poolkey_kernel
    from scanobjectnn_torch.ops.cuda.poolkey_kernel import Plan, bn_relu_exactkey_pool, bn_relu_exactkey_pool_plain

    parent = os.path.abspath(args.parent)
    libs = {"parent": parent_library(parent), "change": _build.library()}
    names, order = ("parent", "change"), ("parent", "change", "change", "parent")

    def run(name, fn):
        with mock.patch.object(_build, "_lib", libs[name]):
            return fn()

    def turns(fn, timer=cs.cuda_ms):
        ms = {name: [] for name in names}
        for name in order:
            ms[name].append(run(name, lambda: timer(fn)))
        return ms

    failed = []

    def check(label, call) -> bool:
        want, ok = bn_relu_exactkey_pool_plain(*call), True
        for name in names:
            got = run(name, lambda: bn_relu_exactkey_pool(*call))
            torch.cuda.synchronize()
            if not all(a.dtype == b.dtype and same_bits(a, b) for a, b in zip(got, want)):
                failed.append(f"{label}: {name} against the plain version")
                ok = False
        return ok

    # 1. The recorded calls, in turns; the sums a step.
    ssg_calls, pointnet_call = [], None
    for model, batch_size in STEPS:
        calls = record_calls(model, batch_size)
        work = cs.Work()
        sums = {name: [0.0, 0.0] for name in names}
        for i, call in enumerate(calls):
            z32 = call[0]
            label = f"#18 {model} bf16 B={batch_size} call {i} z32 {list(z32.shape)}"
            ok = check(label, call)
            one = cs.Work()
            cs.poolkey_work(one, z32, call[5])
            cs.poolkey_work(work, z32, call[5])
            ms = turns(lambda: bn_relu_exactkey_pool(*call))
            for name in names:
                sums[name] = [s + v for s, v in zip(sums[name], ms[name])]
            bound = one.record()["bound_ms"]
            print(f"{label}: {'bit-equal' if ok else 'DIFFERS'} on both trees and the plain version; "
                  + "; ".join(f"{name} {[round(v, 4) for v in ms[name]]} ms" for name in names)
                  + f"; bound {bound:.4f} ms ({one.record()['bound_by']}), change at "
                  f"{bound / mean(ms['change']):.1%} of it; plan {cs.poolkey_plan(z32)} ({smi})", flush=True)
            if model == "pointnet_cls" and pointnet_call is None:
                pointnet_call = call
            if model == "pointnet2_cls_ssg":
                ssg_calls.append(call)
        step_fn = lambda calls=calls: [bn_relu_exactkey_pool(*c) for c in calls]  # noqa: E731
        dev_ms = turns(step_fn, timer=cs.device_ms)
        bound = work.record()["bound_ms"]
        print(f"#18 {model} bf16 step's {len(calls)} calls: events " + "; ".join(
            f"{name} {[round(v, 4) for v in sums[name]]} ms" for name in names)
              + "; device " + "; ".join(f"{name} {[round(v, 4) for v in dev_ms[name]]} ms" for name in names)
              + f"; bound {bound:.4f} ms, change at {bound / (sum(sums['change']) / 2):.1%} of it (events), parent "
              f"{bound / (sum(sums['parent']) / 2):.1%} ({smi})", flush=True)

    # Other plans on the change: PointNet's call and SSG's three.
    for label, call, plans in (
            ("PointNet rows 32 K=C=1024", pointnet_call,
             [Plan(4, 8, 32), Plan(4, 8, 16), Plan(4, 16, 16), Plan(4, 16, 8), Plan(4, 32, 8), Plan(1, 32, 8)]),
            ("SSG SA1 rows 8192 K=32 C=128", ssg_calls[0],
             [Plan(4, 64, 1), Plan(4, 32, 1), Plan(1, 64, 1), Plan(1, 256, 1), Plan(4, 32, 4)]),
            ("SSG SA2 rows 2048 K=64 C=256", ssg_calls[1],
             [Plan(4, 32, 4), Plan(4, 32, 2), Plan(4, 64, 1), Plan(1, 64, 1), Plan(1, 128, 1)]),
            ("SSG group-all rows 16 K=128 C=1024", ssg_calls[2],
             [Plan(4, 8, 16), Plan(4, 16, 16), Plan(4, 8, 8), Plan(1, 32, 4)])):
        z32 = call[0]
        rows, (k, c) = z32.numel() // (z32.shape[-2] * z32.shape[-1]), z32.shape[-2:]
        own = poolkey_kernel.plan(rows, k, c)
        want = bn_relu_exactkey_pool_plain(*call)
        for p in plans:
            with mock.patch.object(poolkey_kernel, "plan", lambda *a, p=p, **kw: p):
                got = bn_relu_exactkey_pool(*call)
                torch.cuda.synchronize()
                if not all(same_bits(a, b) for a, b in zip(got, want)):
                    failed.append(f"#18 {label} plan {p} against the plain version")
                ms = cs.cuda_ms(lambda: bn_relu_exactkey_pool(*call))
                dev_ms = cs.device_ms(lambda: bn_relu_exactkey_pool(*call))
            info = (ctypes.c_int * 4)()
            _build.check(libs["change"].poolkey_info(int(call[5] == torch.bfloat16), p.vec, p.lanes * p.teams,
                                                     int(p.teams == 1), ctypes.addressof(info)),
                         "poolkey_info")
            mark = " (the plan)" if p == own else ""
            blocks = -(-rows * (c // p.vec) // p.lanes) if p.teams == 1 else \
                rows * -(-c // (p.lanes * p.vec))  # the column route, or the split route
            print(f"#18 {label} plan {p._asdict()}{mark}: events {ms:.4f} ms, device {dev_ms:.4f} ms, "
                  f"{blocks} blocks of {p.lanes * p.teams} threads, registers "
                  f"{info[0]}, local bytes {info[1]}, blocks per SM {info[3]} ({smi})", flush=True)

    # 2. profile_forward.py from both trees.
    for prof_args, key in PROFILES:
        busy = {name: [] for name in names}
        for name in order:
            busy[name].append(profile_runs(parent if name == "parent" else ROOT, prof_args, key))
        for name in names:
            print(f"profile_forward.py {' '.join(prof_args)} ({name}): busy "
                  f"{[round(r['device_busy_ms'], 4) for r in busy[name]]} ms, idle share "
                  f"{[round(r['idle_share_of_window'], 4) for r in busy[name]]}, kernels "
                  f"{[r['kernels'] for r in busy[name]]}, host wall {[round(r['host_wall_ms'], 4) for r in busy[name]]}"
                  f" ms ({smi})", flush=True)
            for r in busy[name][:1]:
                top = sorted(r["device_ms_by_kernel"].items(), key=lambda kv: -kv[1])[:8]
                for kname, ms in top:
                    print(f"  {name}: {ms:9.4f} ms  {kname[:110]}", flush=True)
    if failed:
        print("FAILED: " + "; ".join(failed))
        sys.exit(1)
    print("pool_key.py: every output bit-equal to the parent's and the plain version")


if __name__ == "__main__":
    main()
