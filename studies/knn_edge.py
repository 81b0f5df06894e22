#!/usr/bin/env python3
"""The general kNN (#13, ``csrc/knn.cu``: the list routes at k <= 64 and the
selection above) and the EdgeConv reduce's forward (#14, ``csrc/edge.cu``)
against another checkout's (the parent), on one NVIDIA GPU:

    python3 studies/knn_edge.py --parent DIR              # from the repository root
    python3 studies/knn_edge.py --parent DIR --baseline   # the parent's calls alone

Two kernel libraries are built: the package's, and the package's with
``knn.cu`` and ``edge.cu`` taken from ``DIR/scanobjectnn_torch/csrc``
(``graph_fps.build``).  The package's wrappers and models run against each
library in turn; where the parent's entry points take no plan (``knn_launch``
and ``knn_graph_launch`` without a route and group lanes,
``edge_reduce_fwd_launch`` without lanes a query), those arguments are
dropped on the way to them.

1. Call by call, on ``chip_smoke.py``'s seeded inputs: #14's forward at the
   four EdgeConv calls of an f32 ``dgcnn`` forward (B=32, N=1024, k=20, Cv =
   64, 64, 64, 128); #13 at the three FP calls of an f32 BGA forward (B=32,
   k=3), the six kernel-branch calls of an f32 ``pointcnn_seg`` forward
   with the duplicate bias (B=32, k = 8, 24, 32, 48, 48, 32), phase 11's
   two ``SAModule(knn, nsample=128)`` calls (B=32, k=128), phase 13's call
   at N=50000, k=128 (B=1, M=1024) and its self-kNN graphs at k=40 (B=32,
   N=1024, C=3 and 64).  Every output must be bit-equal to the parent's and
   to the plain version; CUDA-event and device times in turns parent,
   change, change, parent, each call beside its bound.  On the change alone
   (device time): #13 on every route a plan may give the call (the group
   route at 1 to 16 lanes a query, the warp route, the selection, the full
   sort) and #14's forward at 16 and 32 lanes a query.
2. End to end, in the same turns: the f32 ``dgcnn`` forward and the f32 BGA
   forward (logits bit-equal), the f32 ``pointcnn_seg`` forward (logits
   bit-equal), the f32 ``dgcnn`` and ``dgcnn_bga`` ``Trainer.train_step``
   at B=32 (each step's loss equal).
3. Device busy time and idle share: ``profile_forward.py`` for the f32
   ``dgcnn`` forward and step, the f32 BGA forward and the f32
   ``pointcnn_seg`` forward, run from both trees in turns parent, change,
   change, parent (each tree builds its own library).

``--baseline`` times the parent's kernels alone at the calls of 1 (CUDA
events and device time) and stops.  Prints the card's name and power limit
first; exits 1 if an output differs from the parent's or the plain
version's.
"""

from __future__ import annotations

import argparse
import glob
import os
import subprocess
import sys
import time
import types
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "studies"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from edge_dup import mean, profile_runs, same_bits  # noqa: E402
from graph_fps import build  # noqa: E402
from scanobjectnn_torch.ops.cuda import _build  # noqa: E402

SWAPPED = ("knn.cu", "edge.cu")
# The plan arguments of the package's entry points (their places), which a
# parent before the plans does not take, and the text its source then lacks.
PLAN_ARGS = {"knn_launch": ((8, 9), "knn.cu", "int route"),
             "knn_graph_launch": ((5, 6), "knn.cu", "int route"),
             "edge_reduce_fwd_launch": ((6,), "edge.cu", "int lanes")}


class PlanlessLib:
    """A library whose entry points in ``dropped`` take fewer arguments than
    the package's wrappers pass: those at the given places are dropped."""

    def __init__(self, lib, dropped: dict):
        self._lib, self._dropped = lib, dropped
        for name, places in dropped.items():
            sig = _build._SIGNATURES[name]
            getattr(lib, name).argtypes = tuple(a for i, a in enumerate(sig) if i not in places)

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name not in self._dropped:
            return fn
        places = self._dropped[name]
        return lambda *args: fn(*(a for i, a in enumerate(args) if i not in places))


def parent_library(parent: str):
    csrc = os.path.join(parent, "scanobjectnn_torch", "csrc")
    sources = [os.path.join(csrc, os.path.basename(src)) if os.path.basename(src) in SWAPPED else src
               for src in sorted(glob.glob(os.path.join(_build.CSRC, "*.cu")))]
    lib = build("knn_edge_parent", sources)
    dropped = {}
    for name, (places, source, text) in PLAN_ARGS.items():
        with open(os.path.join(csrc, source)) as f:
            if text not in f.read():
                dropped[name] = places
    return PlanlessLib(lib, dropped) if dropped else lib


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", required=True, help="a checkout whose knn.cu and edge.cu to hold these against")
    parser.add_argument("--baseline", action="store_true", help="time the parent's kernels alone and stop")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("knn_edge.py: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    from scanobjectnn_torch.data.io import convert_to_binary_mask
    from scanobjectnn_torch.data.pipeline import Batches, EpochSampler
    from scanobjectnn_torch.data.synthetic import make_synthetic_dataset
    from scanobjectnn_torch.models import dgcnn
    from scanobjectnn_torch.nn import xconv
    from scanobjectnn_torch.ops import interpolate
    from scanobjectnn_torch.ops.cuda import edge_kernel, knn_kernel
    from scanobjectnn_torch.ops.cuda.edge_kernel import edge_reduce, edge_reduce_fwd_kernel, reduce_neighbors_plain
    from scanobjectnn_torch.ops.cuda.fps_kernel import fps_plain
    from scanobjectnn_torch.ops.cuda.knn_kernel import (
        knn_graph_kernel, knn_graph_plain, knn_point_kernel, knn_point_plain, point_plan,
    )
    from scanobjectnn_torch.train.trainer import Trainer, TrainerConfig

    parent = os.path.abspath(args.parent)
    libs = {"parent": parent_library(parent)}
    if not args.baseline:
        libs["change"] = _build.library()
    names = tuple(libs)
    order = ("parent", "parent") if args.baseline else ("parent", "change", "change", "parent")

    def run(name, fn):
        with mock.patch.object(_build, "_lib", libs[name]):
            return fn()

    def turns(fn, timer=cs.cuda_ms):
        ms = {name: [] for name in names}
        for name in order:
            ms[name].append(run(name, lambda: timer(fn)))
        return ms

    failed = []

    def check(label, fn, plain):
        """fn's outputs on both libraries bit-equal to each other and to plain."""
        outs = {name: run(name, fn) for name in names}
        want = plain()
        ok = True
        for name, got in outs.items():
            got = got if isinstance(got, tuple) else (got,)
            ref = want if isinstance(want, tuple) else (want,)
            if not all(same_bits(a, b) for a, b in zip(got, ref)):
                failed.append(f"{label}: {name} against the plain version")
                ok = False
        if not args.baseline:
            pairs = zip(*(o if isinstance(o, tuple) else (o,) for o in outs.values()))
            if not all(same_bits(a, b) for a, b in pairs):
                failed.append(f"{label}: change against parent")
                ok = False
        return ok

    def report(label, fn, work, totals=None):
        ms, dev_ms = turns(fn), turns(fn, timer=cs.device_ms)
        if totals is not None:
            for name in names:
                totals["ms"][name] += mean(ms[name])
                totals["device"][name] += mean(dev_ms[name])
        bound = work.record()
        line = "; ".join(f"{name} {[round(v, 4) for v in ms[name]]} ms (device "
                         f"{[round(v, 4) for v in dev_ms[name]]})" for name in names)
        ratio = "" if args.baseline else (f" (device {mean(dev_ms['parent']) / mean(dev_ms['change']):.3f}x, "
                                          f"{bound['bound_ms'] / mean(dev_ms['change']):.3f} of the bound)")
        print(f"{label}: {line}{ratio}; bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}) ({smi})", flush=True)

    def totals_of():
        return {"ms": {name: 0.0 for name in names}, "device": {name: 0.0 for name in names}}

    def print_totals(label, tot, bound):
        print(f"sum {label}: " + "; ".join(f"{name} {tot['ms'][name]:.4f} ms (device {tot['device'][name]:.4f})"
                                           for name in names) + f"; bound {bound:.4f} ms ({smi})", flush=True)

    # Inputs as chip_smoke.py's phases 5, 6, 8, 11 and 13.
    b, n, k = cs.DGCNN_BATCH, cs.DGCNN_POINT, cs.DGCNN_K
    data, labels, masks = make_synthetic_dataset(num_per_class=9, num_classes=cs.NUM_CLASSES, num_points=2 * n,
                                                 seed=2, with_mask=True)
    view = EpochSampler(data, labels, masks=convert_to_binary_mask(masks).astype(np.int64), num_points=n,
                        seed=0).epoch()
    dgcnn_batches = list(Batches(view, b))
    xd = torch.from_numpy(dgcnn_batches[0]["points"]).to(dev)
    dgcnn_models = cs.eval_models("dgcnn", np.random.RandomState(8))
    reduce_calls = []

    def recorder(feats, vals, kk):
        reduce_calls.append((feats.detach().float().contiguous(), vals.detach().float().contiguous()))
        return edge_reduce(feats, vals, kk)

    with torch.no_grad(), mock.patch.object(dgcnn, "edge_reduce", recorder):
        dgcnn_models["f32"](xd)

    knn_calls = []  # (group, label, (queries, keys, k, bias))

    def knn_recorder(group):
        def call(q, p, kk, bias=None):
            knn_calls.append((group, f"{group} M{q.shape[1]} N{p.shape[1]} k{kk}", (q, p, kk, bias)))
            return knn_point_kernel(q, p, kk, bias)
        return call

    sdata, slabels, smasks, sparts = make_synthetic_dataset(num_per_class=5, num_classes=cs.NUM_CLASSES,
                                                            num_points=2 * cs.SEG_POINT, seed=1, with_mask=True,
                                                            with_parts=True)
    sview = EpochSampler(sdata, slabels, masks=convert_to_binary_mask(smasks).astype(np.int64), parts=sparts,
                         num_points=cs.SEG_POINT, seed=0).epoch()
    xs = torch.from_numpy(sview["points"][:cs.SEG_BATCH]).to(dev)
    bga = cs.eval_models("pointnet2_cls_bga", np.random.RandomState(7))["f32"]
    with torch.no_grad(), mock.patch.object(interpolate, "knn_kernel",
                                            types.SimpleNamespace(knn_point_kernel=knn_recorder("BGA"))):
        bga(xs)

    pb, pn = cs.PCNN_BATCH, cs.PCNN_POINT
    pdata, plabels, pmasks = make_synthetic_dataset(num_per_class=9, num_classes=cs.NUM_CLASSES, num_points=2 * pn,
                                                    seed=4, with_mask=True)
    pview = EpochSampler(pdata, plabels, masks=convert_to_binary_mask(pmasks).astype(np.int64), num_points=pn,
                         seed=0).epoch()
    xp = torch.from_numpy(cs.with_duplicates(torch.from_numpy(next(iter(Batches(pview, pb)))["points"]))
                          .numpy()).to(dev)
    seg = cs.eval_models("pointcnn_seg", np.random.RandomState(13))["f32"]
    with torch.no_grad(), mock.patch.object(xconv, "knn_point_kernel", knn_recorder("PointCNN")):
        seg(xp)

    mdata, _ = make_synthetic_dataset(num_per_class=5, num_classes=cs.NUM_CLASSES, num_points=2 * cs.MIXED_POINT,
                                      seed=11)
    xm = torch.from_numpy(mdata[np.random.RandomState(18).permutation(len(mdata))[:cs.SA_LAYER_BATCH],
                                :cs.SA_LAYER_POINT]).to(dev)
    _, q1 = fps_plain(xm, 512)
    _, q2 = fps_plain(q1, 128)
    knn_calls += [("k128", f"k128 SA1 M512 N{xm.shape[1]}", (q1.contiguous(), xm.contiguous(), 128, None)),
                  ("k128", "k128 SA2 M128 N512", (q2.contiguous(), q1.contiguous(), 128, None))]

    g = torch.Generator(device=dev).manual_seed(13)  # phase 13's draws, in its order
    fb, fnn, _ = cs.RANGE_FPS
    torch.randn(fb, fnn, 3, device=dev, generator=g)
    torch.randint(-3, 4, (2, fnn // 8, 3), device=dev, generator=g)
    torch.randperm(fnn, device=dev, generator=g)
    rb, mq, rn, rk = cs.RANGE_KNN
    keys = torch.rand(rb, rn, 3, device=dev, generator=g) * 2 - 1
    queries = keys[:, torch.randperm(rn, device=dev, generator=g)[:mq]] + 0.01
    knn_calls.append(("N50000", f"N{rn} M{mq} k{rk} B={rb}", (queries, keys, rk, None)))
    bg, ng, kg = cs.DGCNN_BATCH, cs.DGCNN_POINT, cs.RANGE_GRAPH_K
    torch.randint(-3, 4, (bg, ng // 8, 3), device=dev, generator=g)
    graphs = [(f"graph k={kg} C=3 B={bg} N={ng}", torch.randn(bg, ng, 3, device=dev, generator=g)),
              (f"graph k={kg} C=64 B={bg} N={ng}", torch.randn(bg, ng, 64, device=dev, generator=g))]

    # 1. Call by call.
    tot = totals_of()
    bound = 0.0
    for i, (feats, vals) in enumerate(reduce_calls):
        cv = vals.shape[-1]
        idx = knn_graph_kernel(feats, k)
        label = f"#14 forward EdgeConv{i + 1} B={b} N={n} k={k} Cv={cv}"
        same = check(label, lambda: edge_reduce_fwd_kernel(vals, idx),
                     lambda: tuple(reduce_neighbors_plain(vals, idx)[key] for key in edge_kernel.REDUCTIONS))
        work = cs.Work()
        work.add(7.0 * b * n * k * cv, 4 * (b * n * cv + b * n * k) + 6 * 4 * b * n * cv)
        bound += work.record()["bound_ms"]
        report(f"{label} (bit-equal: {same})", lambda: edge_reduce_fwd_kernel(vals, idx), work, tot)
        if not args.baseline:
            lanes = {}
            for count in edge_kernel.FWD_LANES:
                with mock.patch.object(edge_kernel, "fwd_lanes", lambda cc, count=count: count):
                    lanes[count] = run("change", lambda: cs.device_ms(lambda: edge_reduce_fwd_kernel(vals, idx)))
            print(f"{label}: change at 16 and 32 lanes a query (device) {lanes[16]:.4f} and {lanes[32]:.4f} ms (the "
                  f"plan's: {edge_kernel.fwd_lanes(cv)}) ({smi})", flush=True)
    print_totals("#14 forward, the four calls of a dgcnn forward", tot, bound)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for group in ("BGA", "PointCNN", "k128", "N50000"):
        tot, bound = totals_of(), 0.0
        for _, label, a in (c for c in knn_calls if c[0] == group):
            q, p, kk, bias = a
            same = check(f"#13 {label}", lambda: knn_point_kernel(*a), lambda: knn_point_plain(*a))
            work = cs.Work()
            cs.knn_work(work, q, p, kk, bias is not None)
            bound += work.record()["bound_ms"]
            plan = point_plan(q.shape[0], q.shape[1], p.shape[1], q.shape[2], kk, sms)
            report(f"#13 {label} (plan {plan}; bit-equal: {same})", lambda: knn_point_kernel(*a), work, tot)
            if not args.baseline:
                route_times(a, plan, run, cs, knn_kernel, knn_point_kernel, label, smi)
        print_totals(f"#13 {group}", tot, bound)
    for label, feats in graphs:
        same = check(f"#13 {label}", lambda: knn_graph_kernel(feats, kg), lambda: knn_graph_plain(feats, kg))
        work = cs.Work()
        cs.graph_work(work, feats, kg)
        plan = point_plan(feats.shape[0], ng, ng, feats.shape[2], kg, sms)
        report(f"#13 {label} (plan {plan}; bit-equal: {same})", lambda: knn_graph_kernel(feats, kg), work)
    if args.baseline:
        if failed:
            sys.exit(f"knn_edge.py: outputs differ: {failed}")
        return

    # 2. End to end.
    def forward(label, model, x):
        with torch.no_grad():
            same = check(label, lambda: model(x)["logits"], lambda: run("parent", lambda: model(x)["logits"]))
            ms = turns(lambda: model(x))
        print(f"{label}: logits bit-equal to the parent's: {same}; change {ms['change']} ms, parent {ms['parent']} "
              f"ms (mean {mean(ms['change']):.4f} against {mean(ms['parent']):.4f}) ({smi})", flush=True)

    def steps(label, config, batches, nsteps=3):
        trainer = Trainer(config)

        def step_ms(name):
            state = trainer.init_state(seed=0)
            losses = []
            run(name, lambda: trainer.train_step(state, batches[0]))  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for batch in batches[1:1 + nsteps]:
                losses.append(float(run(name, lambda: trainer.train_step(state, batch))[1]["loss"]))
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / nsteps, losses

        ms, losses = {"parent": [], "change": []}, {}
        for name in order:
            t, losses[name] = step_ms(name)
            ms[name].append(t)
        same = losses["parent"] == losses["change"]
        if not same:
            failed.append(label)
        print(f"{label}: losses equal to the parent's: {same} {losses['change']}; change {ms['change']} ms, parent "
              f"{ms['parent']} ms (mean {mean(ms['change']):.4f} against {mean(ms['parent']):.4f}) ({smi})",
              flush=True)

    forward(f"dgcnn f32 forward B={b} N={n}", dgcnn_models["f32"], xd)
    forward(f"BGA f32 forward B={cs.SEG_BATCH} N={cs.SEG_POINT}", bga, xs)
    forward(f"pointcnn_seg f32 forward B={pb} N={pn}", seg, xp)
    steps(f"dgcnn f32 train_step B={b}", TrainerConfig(model="dgcnn", batch_size=b, device=str(dev)), dgcnn_batches)
    steps(f"dgcnn_bga f32 train_step B={b}", TrainerConfig(model="dgcnn_bga", batch_size=b, device=str(dev)),
          dgcnn_batches)

    # 3. Device busy time, both trees.
    for prof_args, key in ((["--model", "dgcnn"], "f32"), (["--model", "dgcnn", "--train"], "train_f32"),
                           (["--model", "pointnet2_cls_bga"], "f32"), (["--model", "pointcnn_seg"], "f32")):
        res = {"parent": [], "change": []}
        for name in order:
            res[name].append(profile_runs(parent if name == "parent" else ROOT, prof_args, key))
        for name, runs in res.items():
            print(f"profile_forward.py {' '.join(prof_args)} ({key}), {name}: device busy "
                  f"{[round(r['device_busy_ms'], 4) for r in runs]} ms, host wall "
                  f"{[round(r['host_wall_ms'], 4) for r in runs]} ms, {runs[0]['kernels']:.0f} kernels, idle share "
                  f"{[round(r['idle_share_of_window'], 4) for r in runs]} ({smi})", flush=True)
    if failed:
        sys.exit(f"knn_edge.py: outputs differ: {failed}")


def route_times(a, plan, run, cs, knn_kernel, knn_point_kernel, label, smi) -> None:
    """Device time of the change's #13 on every route a plan may give this
    call: the group route at 1, 2, 4, 8 and 16 lanes a query (k <= 16), the
    warp route (k <= 64), the selection, the full sort (k > 64)."""
    q, p, kk, bias = a
    n, c = p.shape[1], q.shape[2]
    plans = [("group", g) for g in (1, 2, 4, 8, 16) if g <= n] if kk <= knn_kernel.GROUP_MAX_K else []
    if kk <= knn_kernel.MAX_K and knn_kernel.warp_tile(n, c) >= 32:
        plans.append(("warp", 1))
    if knn_kernel.select_smem_bytes(n, kk) <= knn_kernel.SMEM_MAX:
        plans.append(("select", 1))
    if kk > knn_kernel.MAX_K:
        plans.append(("sort", 1))
    times = {}
    for route in plans:
        with mock.patch.object(knn_kernel, "point_plan", lambda *x, route=route: route):
            times[route] = run("change", lambda: cs.device_ms(lambda: knn_point_kernel(*a)))
    print(f"#13 {label} routes (change, device ms): " + ", ".join(f"{r[0]}/{r[1]} {t:.4f}" for r, t in times.items())
          + f" ({smi})", flush=True)


if __name__ == "__main__":
    main()
