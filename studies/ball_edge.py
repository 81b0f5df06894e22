#!/usr/bin/env python3
"""The fused graph and gather (#15, ``csrc/knn.cu``) and the ball query
(#8/#9, ``csrc/ballgroup.cu``) against another checkout's kernels (the
parent), on one NVIDIA GPU:

    python3 studies/ball_edge.py --parent DIR    # from the repository root

Three kernel libraries are built: the package's; the package's with
``knn.cu``, ``ballgroup.cu``, ``safused.cu`` and ``sabucket.cu`` taken from
``DIR/scanobjectnn_torch/csrc`` (each with the headers beside it there:
the parent's ball scan for #3, #4 and #10 too; ``graph_fps.build``); and
the package's with ``knn.cu`` built with ``-DKNN_GATHER_STREAM=0`` (the
fused gather's rows written by plain stores, not streamed).  The package's wrappers
and models run against each library in turn.  Where the parent's entry
points take no plan (``ballgroup_launch``/``ballquery_launch`` without
queries, lanes, unroll and tile) or no gather (``knn_graph_launch``
without vals, out, Cv and element bytes), those arguments are dropped on
the way to them, and the parent's ``edge_gather_knn`` takes the graph
kernel and the gather kernel (``edge_kernel.FUSED_MAX_K`` patched to 0).

1. Call by call, on ``chip_smoke.py``'s seeded inputs: #15 at the T-Net call
   of an f32 and of a bf16 ``dgcnn`` forward (B=32, N=1024, k=20, Cv=64)
   and at SpiderCNN's call (C = Cv = 3); #11's own graphs of the f32
   forward (five); #9 at the f32 SSG step's SA1 and SA2 calls (B=16); #8 at
   phase 10c's two calls (B=32, K = 32 and 128); #3 at SSG's bf16 SA1 and
   SA2 calls (B=128, N=2048), #4 at its "auto" SA1 call, #10 at phase 10's
   SA2 K=128 call.  Every output bit-equal to the parent's and to the plain
   version; CUDA-event and device times in turns parent, change, change,
   parent, each call beside its bound.  On the change alone (device time):
   #15 with plain stores, and #8/#9 on other plans (one and two queries a
   warp at every unroll in blocks of eight warps, then two and four warps
   a block on the plan's).
2. End to end, in the same turns: the f32 and bf16 ``dgcnn`` forwards and
   the f32 ``spidercnn_cls_xyz`` forward (logits bit-equal), the f32 SSG
   and ``dgcnn`` ``Trainer.train_step`` (losses equal).
3. Device busy time and idle share: ``profile_forward.py --model dgcnn``
   and ``--train`` (the f32 SSG step) from both trees in turns parent,
   change, change, parent (each tree builds its own library).

Prints the card's name and power limit first; exits 1 if an output differs
from the parent's or the plain version's.
"""

from __future__ import annotations

import argparse
import glob
import os
import subprocess
import sys
import time
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "studies"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from edge_dup import mean, profile_runs, same_bits  # noqa: E402
from graph_fps import build  # noqa: E402
from knn_edge import PlanlessLib  # noqa: E402
from sa_fma import build as build_with_flags  # noqa: E402
from scanobjectnn_torch.ops.cuda import _build  # noqa: E402

SWAPPED = ("knn.cu", "ballgroup.cu", "safused.cu", "sabucket.cu")
# The arguments of the package's entry points (their places) that a parent
# before this design does not take, and the text its source then lacks.
NEW_ARGS = {"ballgroup_launch": ((7, 8, 9, 10), "ballgroup.cu", "int queries"),
            "ballquery_launch": ((7, 8, 9, 10), "ballgroup.cu", "int queries"),
            "knn_graph_launch": ((10, 11, 12, 13), "knn.cu", "const void* vals")}


def parent_library(parent: str):
    csrc = os.path.join(parent, "scanobjectnn_torch", "csrc")
    sources = [os.path.join(csrc, os.path.basename(src)) if os.path.basename(src) in SWAPPED else src
               for src in sorted(glob.glob(os.path.join(_build.CSRC, "*.cu")))]
    lib = build("ball_edge_parent", sources)
    dropped = {}
    for name, (places, source, text) in NEW_ARGS.items():
        with open(os.path.join(csrc, source)) as f:
            if text not in f.read():
                dropped[name] = places
    return PlanlessLib(lib, dropped) if dropped else lib


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", required=True, help="a checkout whose kernels to hold these against")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ball_edge.py: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    from scanobjectnn_torch.convert import init_params
    from scanobjectnn_torch.data.io import convert_to_binary_mask
    from scanobjectnn_torch.data.pipeline import Batches, EpochSampler
    from scanobjectnn_torch.data.synthetic import make_synthetic_dataset
    from scanobjectnn_torch.models import dgcnn
    from scanobjectnn_torch.nn import pointnet_modules
    from scanobjectnn_torch.nn.pointnet_modules import SAModule
    from scanobjectnn_torch.ops.cuda import ballgroup_kernel, edge_kernel
    from scanobjectnn_torch.ops.cuda.ballgroup_kernel import (
        ball_plan, ball_query_plain, query_ball_group, query_ball_group_plain, query_ball_point,
    )
    from scanobjectnn_torch.ops.cuda.edge_kernel import edge_gather_knn, edge_gather_knn_plain, edge_reduce
    from scanobjectnn_torch.ops.cuda.fps_kernel import fps_plain
    from scanobjectnn_torch.ops.cuda.knn_kernel import knn_graph_kernel, knn_graph_plain
    from scanobjectnn_torch.ops.cuda.sabucket_kernel import AUTO_BUCKET, sa_ball_mlp_pool_bucketed
    from scanobjectnn_torch.ops.cuda.safused_kernel import sa_ball_mlp_pool, sa_ball_mlp_pool_plain
    from scanobjectnn_torch.ops.cuda.samlp_kernel import sa_mlp_pool
    from scanobjectnn_torch.train.trainer import Trainer, TrainerConfig

    parent = os.path.abspath(args.parent)
    libs = {"parent": parent_library(parent), "change": _build.library(),
            "plain": build_with_flags("ball_edge_plain", _build.CSRC, {"knn.cu": ("-DKNN_GATHER_STREAM=0",)})}
    names, order = ("parent", "change"), ("parent", "change", "change", "parent")

    def run(name, fn):
        fused_max_k = 0 if name == "parent" else edge_kernel.FUSED_MAX_K
        with mock.patch.object(_build, "_lib", libs[name]), \
                mock.patch.object(edge_kernel, "FUSED_MAX_K", fused_max_k):
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
        want = want if isinstance(want, tuple) else (want,)
        ok = True
        for name, got in outs.items():
            got = got if isinstance(got, tuple) else (got,)
            if not all(same_bits(a, b) for a, b in zip(got, want)):
                failed.append(f"{label}: {name} against the plain version")
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
        print(f"{label}: {line} (events {mean(ms['parent']) / mean(ms['change']):.3f}x, device "
              f"{mean(dev_ms['parent']) / mean(dev_ms['change']):.3f}x; {bound['bound_ms'] / mean(ms['change']):.3f} "
              f"of the bound by events); bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}) ({smi})", flush=True)

    def totals_of():
        return {"ms": {name: 0.0 for name in names}, "device": {name: 0.0 for name in names}}

    def print_totals(label, tot):
        print(f"sum {label}: " + "; ".join(f"{name} {tot['ms'][name]:.4f} ms (device {tot['device'][name]:.4f})"
                                           for name in names) + f" ({smi})", flush=True)

    # Inputs as chip_smoke.py's phases 2, 4, 6, 7, 10 and 12.
    b, n, k = cs.DGCNN_BATCH, cs.DGCNN_POINT, cs.DGCNN_K
    data, labels, masks = make_synthetic_dataset(num_per_class=9, num_classes=cs.NUM_CLASSES, num_points=2 * n,
                                                 seed=2, with_mask=True)
    view = EpochSampler(data, labels, masks=convert_to_binary_mask(masks).astype(np.int64), num_points=n,
                        seed=0).epoch()
    dgcnn_batches = list(Batches(view, b))
    xd = torch.from_numpy(dgcnn_batches[0]["points"]).to(dev)
    dgcnn_models = cs.eval_models("dgcnn", np.random.RandomState(8))
    gather_calls, graph_feats = {}, []

    def gather_recorder(name):
        def call(feats, vals, kk):
            gather_calls[name] = (feats.detach().float().contiguous(), vals.detach().contiguous())
            if name == "f32":
                graph_feats.append(gather_calls[name][0])
            return edge_gather_knn(feats, vals, kk)
        return call

    def reduce_recorder(feats, vals, kk):
        graph_feats.append(feats.detach().float().contiguous())
        return edge_reduce(feats, vals, kk)

    with torch.no_grad():
        for name in ("f32", "bf16"):
            with mock.patch.object(dgcnn, "edge_gather_knn", gather_recorder(name)), \
                    mock.patch.object(dgcnn, "edge_reduce", reduce_recorder if name == "f32" else edge_reduce):
                dgcnn_models[name](xd)

    # 1a. #15, and #11's own graphs.
    tot = totals_of()
    calls15 = [("T-Net f32", *gather_calls["f32"]), ("T-Net bf16", *gather_calls["bf16"]),
               ("SpiderCNN C=Cv=3", gather_calls["f32"][0], gather_calls["f32"][0])]
    for label, feats, vals in calls15:
        full = f"#15 {label} B={b} N={n} k={k} Cv={vals.shape[-1]}"
        same = check(full, lambda: edge_gather_knn(feats, vals, k), lambda: edge_gather_knn_plain(feats, vals, k))
        work = cs.Work()
        cs.graph_work(work, feats, k)
        work.add(0.0, vals.element_size() * b * n * vals.shape[-1] * (1 + k))
        report(f"{full} (bit-equal: {same})", lambda: edge_gather_knn(feats, vals, k), work,
               tot if label.startswith("T-Net f32") else None)
        stores = run("plain", lambda: (cs.cuda_ms(lambda: edge_gather_knn(feats, vals, k)),
                                       cs.device_ms(lambda: edge_gather_knn(feats, vals, k))))
        again = run("plain", lambda: edge_gather_knn(feats, vals, k))
        if not same_bits(again[0], edge_gather_knn_plain(feats, vals, k)[0]):
            failed.append(f"{full}: plain stores")
        print(f"{full}: change with plain stores {stores[0]:.4f} ms (device {stores[1]:.4f}) ({smi})", flush=True)
    print_totals("#15 at the f32 dgcnn forward's T-Net call", tot)
    tot = totals_of()
    for i, feats in enumerate(graph_feats):
        full = f"#11 graph {i} of the f32 dgcnn forward C={feats.shape[-1]}"
        same = check(full, lambda: knn_graph_kernel(feats, k), lambda: knn_graph_plain(feats, k))
        work = cs.Work()
        cs.graph_work(work, feats, k)
        report(f"{full} (bit-equal: {same})", lambda: knn_graph_kernel(feats, k), work, tot)
    print_totals("#11, the five graphs of an f32 dgcnn forward", tot)

    # 1b. #9 at the SSG step's calls, #8 at phase 10c's.
    tdata, tlabels = make_synthetic_dataset(num_per_class=8, num_classes=cs.NUM_CLASSES, num_points=2 * cs.TRAIN_POINT,
                                            seed=0)
    tbatches = list(Batches(EpochSampler(tdata, tlabels, num_points=cs.TRAIN_POINT, seed=0).epoch(), cs.TRAIN_BATCH))
    xt = torch.from_numpy(tbatches[0]["points"]).to(dev)
    _, t1 = fps_plain(xt, 512)
    _, t2 = fps_plain(t1, 128)
    data10, _ = make_synthetic_dataset(num_per_class=3, num_classes=cs.NUM_CLASSES, num_points=cs.SA_LAYER_POINT,
                                       seed=6)
    x10 = torch.from_numpy(data10[np.random.RandomState(16).permutation(len(data10))[:cs.SA_LAYER_BATCH]]).to(dev)
    _, q10 = fps_plain(x10, 512)
    ball_calls = [("#9", f"SSG step SA1 B={cs.TRAIN_BATCH} N1024 M512 K32 r0.2", (0.2, 32, xt, t1)),
                  ("#9", f"SSG step SA2 B={cs.TRAIN_BATCH} N512 M128 K64 r0.4", (0.4, 64, t1, t2)),
                  ("#8", f"phase 10c B={cs.SA_LAYER_BATCH} N1024 M512 K32 r0.2", (0.2, 32, x10, q10)),
                  ("#8", f"phase 10c B={cs.SA_LAYER_BATCH} N1024 M512 K128 r0.4", (0.4, 128, x10, q10))]
    for kernel in ("#9", "#8"):
        tot = totals_of()
        for _, label, a in (c for c in ball_calls if c[0] == kernel):
            radius, kk, xyz, q = a
            if kernel == "#9":
                fn, plain = (lambda: query_ball_group(*a)), (lambda: query_ball_group_plain(*a))
            else:
                fn = lambda: query_ball_point(*a)  # noqa: E731
                plain = lambda: tuple(t.int() for t in ball_query_plain(*a))  # noqa: E731
            same = check(f"{kernel} {label}", fn, plain)
            bb, m = q.shape[:2]
            work = cs.Work()
            out_bytes = bb * m * ((16 if kernel == "#9" else 4) * kk + 4)
            work.add(9.0 * cs.scanned_points(radius, kk, xyz, q), 12 * (xyz.shape[0] * xyz.shape[1] + bb * m) + out_bytes)
            plan = ball_plan(bb, xyz.shape[1], m)
            report(f"{kernel} {label} (plan {plan}; bit-equal: {same})", fn, work, tot)
            plans = [(ballgroup_kernel.MAX_WARPS * pw, pw, u, plan[3]) for pw in ballgroup_kernel.PER_WARP
                     for u in ballgroup_kernel.UNROLLS]
            plans += [(warps * plan[1], plan[1], plan[2], plan[3]) for warps in (2, 4)]
            times = {}
            for p in plans:
                with mock.patch.object(ballgroup_kernel, "ball_plan", lambda *x, p=p: p):
                    times[p] = run("change", lambda: cs.device_ms(fn))
            best = min(times, key=times.get)
            print(f"{kernel} {label} plans (queries, a warp, unroll, tile) on the change, device ms: "
                  + ", ".join(f"{p} {t:.4f}" for p, t in times.items()) + f"; fastest {best} ({smi})", flush=True)
        print_totals(f"{kernel}, its main-path calls", tot)

    # 1c. #3, #4 and #10, whose scan's hit rule moved into ball_hit.
    sdata, _ = make_synthetic_dataset(num_per_class=18, num_classes=cs.NUM_CLASSES, num_points=cs.NUM_POINT, seed=0)
    xs = torch.from_numpy(sdata[np.random.RandomState(0).permutation(len(sdata))[:cs.BATCH]]).to(dev)
    ssg = cs.eval_models("pointnet2_cls_ssg", np.random.RandomState(1))
    _, s1 = fps_plain(xs, 512)
    _, s2 = fps_plain(s1, 128)
    window, qtile, gblk = AUTO_BUCKET[(cs.NUM_POINT, 512)]
    with torch.no_grad():
        w1, b1 = ssg["bf16"].sa1.mlp.folded()
        w2, b2 = ssg["bf16"].sa2.mlp.folded()
        a1 = (0.2, 32, xs, s1, None, w1, b1)
        a2 = (0.4, 64, s1, s2, sa_ball_mlp_pool_plain(*a1, dtype=torch.bfloat16)[0], w2, b2)
        layer = init_params(SAModule(128, 0.4, 128, (128, 128, 256), 128, False, False), torch.Generator().manual_seed(16))
        layer = layer.to(dev).eval()
        recorded = []

        def recorder(*a, dtype):
            recorded.append(a)
            return sa_mlp_pool(*a, dtype=dtype)

        feats10 = torch.randn(cs.SA_LAYER_BATCH, 512, 128, device=dev,
                              generator=torch.Generator(device=dev).manual_seed(3))
        with mock.patch.object(pointnet_modules, "sa_mlp_pool", recorder):
            layer(q10, feats10)
        sa_calls = [("#3 SSG SA1 bf16 B=128", lambda: sa_ball_mlp_pool(*a1, dtype=torch.bfloat16)[0]),
                    ("#3 SSG SA2 bf16 B=128", lambda: sa_ball_mlp_pool(*a2, dtype=torch.bfloat16)[0]),
                    (f"#4 SSG SA1 bf16 B=128 (W, T, G) = {window, qtile, gblk}",
                     lambda: sa_ball_mlp_pool_bucketed(*a1, dtype=torch.bfloat16, window=window, qtile=qtile,
                                                       gblk=gblk)[0]),
                    (f"#10 SA2 ball K128 f32 B={cs.SA_LAYER_BATCH}",
                     lambda: sa_mlp_pool(*recorded[0], dtype=torch.float32))]
        for label, fn in sa_calls:
            same = same_bits(run("parent", fn), run("change", fn))
            if not same:
                failed.append(f"{label}: change against parent")
            ms = turns(fn)
            print(f"{label}: bit-equal to the parent: {same}; change {[round(v, 4) for v in ms['change']]} ms, parent "
                  f"{[round(v, 4) for v in ms['parent']]} ms ({mean(ms['parent']) / mean(ms['change']):.3f}x) ({smi})",
                  flush=True)

    # 2. End to end.
    def forward(label, model, x):
        with torch.no_grad():
            logits = {name: run(name, lambda: model(x)["logits"]) for name in names}
            same = same_bits(logits["parent"], logits["change"])
            if not same:
                failed.append(label)
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
    forward(f"dgcnn bf16 forward B={b} N={n}", dgcnn_models["bf16"], xd)
    spider = cs.eval_models("spidercnn_cls_xyz", np.random.RandomState(11))["f32"]
    forward(f"spidercnn_cls_xyz f32 forward B={b} N={n}", spider, xd)
    steps(f"pointnet2_cls_ssg f32 train_step B={cs.TRAIN_BATCH}",
          TrainerConfig(batch_size=cs.TRAIN_BATCH, device=str(dev)), tbatches)
    steps(f"dgcnn f32 train_step B={b}", TrainerConfig(model="dgcnn", batch_size=b, device=str(dev)), dgcnn_batches)

    # 3. Device busy time, both trees.
    for prof_args, key in ((["--model", "dgcnn"], "f32"), (["--train"], "train_f32")):
        res = {"parent": [], "change": []}
        for name in order:
            res[name].append(profile_runs(parent if name == "parent" else ROOT, prof_args, key))
        for name, runs in res.items():
            print(f"profile_forward.py {' '.join(prof_args)} ({key}), {name}: device busy "
                  f"{[round(r['device_busy_ms'], 4) for r in runs]} ms, host wall "
                  f"{[round(r['host_wall_ms'], 4) for r in runs]} ms, {runs[0]['kernels']:.0f} kernels, idle share "
                  f"{[round(r['idle_share_of_window'], 4) for r in runs]} ({smi})", flush=True)
    if failed:
        sys.exit(f"ball_edge.py: outputs differ: {failed}")


if __name__ == "__main__":
    main()
