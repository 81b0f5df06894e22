#!/usr/bin/env python3
"""The EdgeConv reduce's backward (#14, ``csrc/edge.cu``) and PointCNN's
duplicate mask (#12, ``csrc/dupmask.cu``) against another checkout's (the
parent), on one NVIDIA GPU:

    python3 studies/edge_dup.py --parent DIR    # from the repository root

Two kernel libraries are built: the package's, and the package's with
``edge.cu`` and ``dupmask.cu`` taken from ``DIR/scanobjectnn_torch/csrc``.
The package's wrappers and models run against each library in turn; where
the parent's ``edge_reduce_bwd_launch`` takes no slice width (a tree before
the staged backward), the width is dropped on the way to it.

1. Call by call, on ``chip_smoke.py``'s seeded inputs: the backward at the
   four EdgeConv calls of an f32 ``dgcnn`` step (B=32, N=1024, k=20, Cv =
   64, 64, 64, 128; the layer inputs of one forward, random cotangents),
   and #12 at the six calls of an f32 ``pointcnn_seg`` forward (B=32,
   [1024|384|128, 3] clouds with duplicates injected).  Each output must be
   bit-equal to the parent's (and the backward to
   ``edge_reduce_bwd_ordered``, #12 to ``duplicate_mask_plain``); CUDA-event
   times in turns parent, change, change, parent; the backward's device
   time split into the counting sort and the sum on both libraries; #12
   beside an empty kernel of its grid.  The backward also at slice widths
   4 and 2 (``edge_kernel.bwd_slice_width`` patched: two and four blocks an
   SM, a query row no longer one conflict-free 128-byte read), which must
   give the same bits.
2. End to end, in the same turns: the f32 ``dgcnn`` and ``dgcnn_bga``
   ``Trainer.train_step`` at B=32 (host clock; each step's loss equal to
   the parent's) and the f32 ``pointcnn_seg`` forward at B=32 (CUDA events;
   logits bit-equal).
3. Device busy time: ``profile_forward.py --model dgcnn --train`` and
   ``--model pointcnn_seg`` run from both trees, in turns parent, change,
   change, parent (each tree builds its own library).

Prints the card's name and power limit first; exits 1 if an output differs
from the parent's.
"""

from __future__ import annotations

import argparse
import glob
import json
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
from graph_fps import build  # noqa: E402
from scanobjectnn_torch.ops.cuda import _build  # noqa: E402

SWAPPED = ("edge.cu", "dupmask.cu")
SLICE_ARG = 14  # the slice width's place in edge_reduce_bwd_launch's arguments


class SlicelessLib:
    """A library whose ``edge_reduce_bwd_launch`` takes no slice width, as
    the package's wrappers call it: the width is dropped."""

    def __init__(self, lib):
        self._lib = lib
        sig = _build._SIGNATURES["edge_reduce_bwd_launch"]
        lib.edge_reduce_bwd_launch.argtypes = sig[:SLICE_ARG] + sig[SLICE_ARG + 1:]

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def edge_reduce_bwd_launch(self, *args):
        return self._lib.edge_reduce_bwd_launch(*args[:SLICE_ARG], *args[SLICE_ARG + 1:])


def same_bits(a, b) -> bool:
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


def mean(v):
    return sum(v) / len(v)


def profile_runs(tree: str, args: list[str], key: str) -> dict:
    """``profile_forward.py args`` run from ``tree``: its run ``key``'s
    numbers (the script's last line)."""
    out = subprocess.run([sys.executable, os.path.join(tree, "profile_forward.py"), *args], cwd=tree,
                         capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"profile_forward.py {args} in {tree} failed:\n{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])[key]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", required=True, help="a checkout whose edge.cu and dupmask.cu to hold these against")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("edge_dup.py: needs an NVIDIA GPU")
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
    from scanobjectnn_torch.ops.cuda import edge_kernel
    from scanobjectnn_torch.ops.cuda.dupmask_kernel import duplicate_mask_kernel, duplicate_mask_plain, launch_floor
    from scanobjectnn_torch.ops.cuda.edge_kernel import edge_reduce, edge_reduce_bwd_kernel, edge_reduce_bwd_ordered
    from scanobjectnn_torch.train.trainer import Trainer, TrainerConfig

    parent = os.path.abspath(args.parent)
    parent_csrc = os.path.join(parent, "scanobjectnn_torch", "csrc")
    sources = [os.path.join(parent_csrc, os.path.basename(src)) if os.path.basename(src) in SWAPPED else src
               for src in sorted(glob.glob(os.path.join(_build.CSRC, "*.cu")))]
    parent_lib = build("edge_dup_parent", sources)
    with open(os.path.join(parent_csrc, "edge.cu")) as f:
        if "int slice" not in f.read():
            parent_lib = SlicelessLib(parent_lib)
    libs = {"change": _build.library(), "parent": parent_lib}

    def run(name, fn):
        with mock.patch.object(_build, "_lib", libs[name]):
            return fn()

    def turns(fn, timer=cs.cuda_ms):
        ms = {"parent": [], "change": []}
        for name in ("parent", "change", "change", "parent"):
            ms[name].append(run(name, lambda: timer(fn)))
        return ms

    failed = []

    def same_on_both(label, fn):
        a, b = run("parent", fn), run("change", fn)
        same = same_bits(a, b)
        if not same:
            failed.append(label)
        return same, b

    # Inputs as chip_smoke.py's phases 6 and 8.
    b, n, k = cs.DGCNN_BATCH, cs.DGCNN_POINT, cs.DGCNN_K
    data, labels, masks = make_synthetic_dataset(num_per_class=9, num_classes=cs.NUM_CLASSES, num_points=2 * n,
                                                 seed=2, with_mask=True)
    view = EpochSampler(data, labels, masks=convert_to_binary_mask(masks).astype(np.int64), num_points=n,
                        seed=0).epoch()
    dgcnn_batches = list(Batches(view, b))
    xd = torch.from_numpy(dgcnn_batches[0]["points"]).to(dev)
    reduce_calls = []

    def recorder(feats, vals, kk):
        reduce_calls.append((feats.detach().float().contiguous(), vals.detach().float().contiguous()))
        return edge_reduce(feats, vals, kk)

    with torch.no_grad(), mock.patch.object(dgcnn, "edge_reduce", recorder):
        cs.eval_models("dgcnn", np.random.RandomState(8))["f32"](xd)

    pb, pn = cs.PCNN_BATCH, cs.PCNN_POINT
    pdata, plabels, pmasks = make_synthetic_dataset(num_per_class=9, num_classes=cs.NUM_CLASSES, num_points=2 * pn,
                                                    seed=4, with_mask=True)
    pview = EpochSampler(pdata, plabels, masks=convert_to_binary_mask(pmasks).astype(np.int64), num_points=pn,
                         seed=0).epoch()
    pbatches = [{**bt, "points": cs.with_duplicates(torch.from_numpy(bt["points"])).numpy()}
                for bt in Batches(pview, pb)]
    xp = torch.from_numpy(pbatches[0]["points"]).to(dev)
    seg = cs.eval_models("pointcnn_seg", np.random.RandomState(13))["f32"]
    dup_calls = []

    def dup_recorder(xyz):
        dup_calls.append(xyz)
        return duplicate_mask_kernel(xyz)

    with torch.no_grad(), mock.patch.object(xconv, "duplicate_mask_kernel", dup_recorder):
        seg(xp)

    # 1. Call by call.
    totals = {key: {"parent": 0.0, "change": 0.0} for key in ("bwd", "dup")}
    cg = torch.Generator(device=dev).manual_seed(9)
    for i, (feats, vals) in enumerate(reduce_calls):
        cv = vals.shape[-1]
        red = edge_reduce(feats, vals, k)
        saved = (vals, red["idx"], red["mmax"], red["mmin"], red["cntmax"], red["cntmin"])
        cot = [torch.randn(b, n, cv, device=dev, generator=cg) for _ in range(4)]
        label = f"EdgeConv{i + 1} backward B={b} N={n} k={k} Cv={cv}"
        same, got = same_on_both(label, lambda: edge_reduce_bwd_kernel(*saved, *cot))
        ordered = same_bits(got, edge_reduce_bwd_ordered(*saved, *cot))
        if not ordered:
            failed.append(f"{label}: edge_reduce_bwd_ordered")
        ms = turns(lambda: edge_reduce_bwd_kernel(*saved, *cot))
        split = {name: run(name, lambda: cs.kernel_split_ms(lambda: edge_reduce_bwd_kernel(*saved, *cot),
                                                            cs.EDGE_BWD_SPLIT))
                 for name in ("parent", "change")}
        for name in ms:
            totals["bwd"][name] += mean(ms[name])
        widths, widths_same = {}, True
        for width in (4, 2):
            with mock.patch.object(edge_kernel, "bwd_slice_width", lambda n, cv, width=width: width):
                if not same_bits(got, edge_reduce_bwd_kernel(*saved, *cot)):
                    widths_same = False
                    failed.append(f"{label}: slice width {width}")
                widths[width] = cs.cuda_ms(lambda: edge_reduce_bwd_kernel(*saved, *cot))
        print(f"{label}: bit-equal to the parent: {same}, to edge_reduce_bwd_ordered: {ordered}; change "
              f"{ms['change']} ms, parent {ms['parent']} ms (mean {mean(ms['change']):.4f} against "
              f"{mean(ms['parent']):.4f}: {mean(ms['parent']) / mean(ms['change']):.3f}x); device time sort + sum: "
              f"change {split['change']['sort']:.4f} + {split['change']['sum']:.4f}, parent "
              f"{split['parent']['sort']:.4f} + {split['parent']['sum']:.4f} ms; the sum moves "
              f"{cs.edge_bwd_sum_bytes(b, n, k, cv) / 1e6:.1f} MB, the parent's loaded {32 * cv * b * n * k / 1e6:.1f} "
              f"MB; at slice widths 4 and 2 (same bits: {widths_same}) {widths[4]:.4f} and "
              f"{widths[2]:.4f} ms ({smi})", flush=True)
    for i, xyz in enumerate(dup_calls):
        label = f"duplicate mask call {i + 1} [{xyz.shape[0]},{xyz.shape[1]},3]"
        same, got = same_on_both(label, lambda: duplicate_mask_kernel(xyz))
        plain = torch.equal(got, duplicate_mask_plain(xyz))
        if not plain:
            failed.append(f"{label}: duplicate_mask_plain")
        ms = turns(lambda: duplicate_mask_kernel(xyz))
        dev_ms = turns(lambda: duplicate_mask_kernel(xyz), timer=cs.device_ms)
        floor = run("change", lambda: (cs.cuda_ms(lambda: launch_floor(xyz)), cs.device_ms(lambda: launch_floor(xyz))))
        for name in ms:
            totals["dup"][name] += mean(ms[name])
        print(f"{label}: bit-equal to the parent: {same}, to duplicate_mask_plain: {plain}; change {ms['change']} "
              f"ms, parent {ms['parent']} ms (mean {mean(ms['change']):.4f} against {mean(ms['parent']):.4f}); device "
              f"time change {mean(dev_ms['change']):.4f}, parent {mean(dev_ms['parent']):.4f} ms; an empty kernel of "
              f"the same grid {floor[0]:.4f} ms (device {floor[1]:.4f}) ({smi})", flush=True)
    print(f"sums (CUDA events): the four backward calls {totals['bwd']['change']:.4f} ms against "
          f"{totals['bwd']['parent']:.4f}; the six duplicate-mask calls {totals['dup']['change']:.4f} ms against "
          f"{totals['dup']['parent']:.4f} ({smi})", flush=True)

    # 2. End to end.
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
        for name in ("parent", "change", "change", "parent"):
            t, losses[name] = step_ms(name)
            ms[name].append(t)
        same = losses["parent"] == losses["change"]
        if not same:
            failed.append(label)
        print(f"{label}: losses equal to the parent's: {same} {losses['change']}; change {ms['change']} ms, parent "
              f"{ms['parent']} ms (mean {mean(ms['change']):.4f} against {mean(ms['parent']):.4f}) ({smi})",
              flush=True)

    steps(f"dgcnn f32 train_step B={b}", TrainerConfig(model="dgcnn", batch_size=b, device=str(dev)), dgcnn_batches)
    steps(f"dgcnn_bga f32 train_step B={b}", TrainerConfig(model="dgcnn_bga", batch_size=b, device=str(dev)),
          dgcnn_batches)
    with torch.no_grad():
        same, _ = same_on_both("pointcnn_seg logits", lambda: seg(xp)["logits"])
        ms = turns(lambda: seg(xp))
    print(f"pointcnn_seg f32 forward B={pb}: logits bit-equal to the parent's: {same}; change {ms['change']} ms, "
          f"parent {ms['parent']} ms (mean {mean(ms['change']):.4f} against {mean(ms['parent']):.4f}) ({smi})",
          flush=True)

    # 3. Device busy time, both trees.
    for prof_args, key in ((["--model", "dgcnn", "--train"], "train_f32"), (["--model", "pointcnn_seg"], "f32")):
        res = {"parent": [], "change": []}
        for name in ("parent", "change", "change", "parent"):
            res[name].append(profile_runs(parent if name == "parent" else ROOT, prof_args, key))
        for name, runs in res.items():
            print(f"profile_forward.py {' '.join(prof_args)} ({key}), {name}: device busy "
                  f"{[round(r['device_busy_ms'], 4) for r in runs]} ms, host wall "
                  f"{[round(r['host_wall_ms'], 4) for r in runs]} ms, {runs[0]['kernels']:.0f} kernels, idle share "
                  f"{[round(r['idle_share_of_window'], 4) for r in runs]} ({smi})", flush=True)
    if failed:
        sys.exit(f"edge_dup.py: outputs differ: {failed}")


if __name__ == "__main__":
    main()
