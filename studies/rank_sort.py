#!/usr/bin/env python3
"""The rank sort (#5, ``csrc/ranksort.cu``) against another checkout's
(the parent), on one NVIDIA GPU:

    python3 studies/rank_sort.py --parent DIR    # from the repository root

Three kernel libraries are built: the package's, the package's with
``ranksort.cu`` taken from ``DIR/scanobjectnn_torch/csrc``
(``graph_fps.build``), and the package's with its ``ranksort.cu`` storing
the sorted rows one row at a time (``ONE_ROW``: a row's loads, then its
stores) in place of groups of ``kRowsInFlight`` rows.  The package's wrappers and models run against each
in turn.  Where the parent's ``ranksort_launch`` takes no plan (threads and
words a thread), those arguments are dropped on the way to it.

1. Call by call, on ``chip_smoke.py``'s inputs (phase 3's batch, B=128, and
   its SA1 queries): the two SA1 calls of the bucketed prep (points, N=2048;
   queries, M=512) and phase 12a's other cases (a tie lattice with -0.0 and
   NaN keys, bf16 feature rows), plus ascending, descending, all-equal and
   all-NaN keys.  Every output bit-equal to the parent's and to the plain
   version.  The two SA1 calls timed by CUDA events and device time in turns
   parent, change, change, parent, beside their bound and
   ``torch.argsort(stable=True)``, and the one-row build in turns with the
   change (device time).  On the change alone: every plan the kernel takes
   at both calls (device time), with each build's registers, local memory
   and blocks per SM.
2. End to end, in the same turns: the bf16 SSG forward (B=128, N=2048,
   ``sa_bucket`` "auto"), logits bit-equal, by CUDA events.
3. Device busy time and idle share: ``profile_forward.py`` (the bf16 and
   f32 SSG forward under "auto") from both trees in turns parent, change,
   change, parent (each tree builds its own library).

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

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from edge_dup import mean, profile_runs, same_bits  # noqa: E402
from graph_fps import build  # noqa: E402
from knn_edge import PlanlessLib  # noqa: E402
from scanobjectnn_torch.ops.cuda import _build  # noqa: E402

SWAPPED = ("ranksort.cu",)
# The places of the package's ranksort_launch arguments that a parent before
# this design does not take, and the text its source then lacks.
PLAN_ARGS = {"ranksort_launch": ((6, 7), "ranksort.cu", "int per_thread")}


# The payload loop that ONE_ROW puts in place of the grouped loads.
ONE_ROW = """  for (int r = t; r < n; r += threads) {
    const int id = sid[r];
    const size_t dst = cloud + r;
    ids[dst] = id;
    rank[dst] = srank[r];
    xyz_s[dst * 3] = __ldg(cxyz + 3 * id);
    xyz_s[dst * 3 + 1] = __ldg(cxyz + 3 * id + 1);
    xyz_s[dst * 3 + 2] = __ldg(cxyz + 3 * id + 2);
  }
"""


def one_row_library():
    with open(os.path.join(_build.CSRC, "ranksort.cu")) as f:
        text = f.read()
    start, end = text.index("  // Rows r = t + q * threads"), text.index("  if (feats == nullptr) return;")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(_build.BUILD_DIR, "ranksort_one_row.cu")
    with open(path, "w") as f:
        f.write(text[:start] + ONE_ROW + text[end:])
    return build("rank_sort_one_row", [path if os.path.basename(src) == "ranksort.cu" else src
                                       for src in sorted(glob.glob(os.path.join(_build.CSRC, "*.cu")))])


def parent_library(parent: str):
    csrc = os.path.join(parent, "scanobjectnn_torch", "csrc")
    sources = [os.path.join(csrc, os.path.basename(src)) if os.path.basename(src) in SWAPPED else src
               for src in sorted(glob.glob(os.path.join(_build.CSRC, "*.cu")))]
    lib = build("rank_sort_parent", sources)
    dropped = {}
    for name, (places, source, text) in PLAN_ARGS.items():
        with open(os.path.join(csrc, source)) as f:
            if text not in f.read():
                dropped[name] = places
    return PlanlessLib(lib, dropped) if dropped else lib


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", required=True, help="a checkout whose ranksort.cu to hold this one against")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("rank_sort.py: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    from scanobjectnn_torch.data.synthetic import make_synthetic_dataset
    from scanobjectnn_torch.models import get_model
    from scanobjectnn_torch.nn.pointnet_modules import configure_eval
    from scanobjectnn_torch.ops.cuda import ranksort_kernel
    from scanobjectnn_torch.ops.cuda.fps_kernel import fps_plain
    from scanobjectnn_torch.ops.cuda.ranksort_kernel import (
        MAX_THREADS, PER_THREAD, rank_sort_points, rank_sort_points_plain, shared_steps, sort_plan, sort_words,
    )
    from scanobjectnn_torch.ops.cuda.sabucket_kernel import sort_keys

    parent = os.path.abspath(args.parent)
    libs = {"parent": parent_library(parent), "change": _build.library(), "one_row": one_row_library()}
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

    def check(label, fn, plain):
        """fn's outputs on both libraries bit-equal to each other and to plain."""
        want, ok = plain(), True
        for name in names:
            got = run(name, fn)
            torch.cuda.synchronize()
            if not all((a is None and b is None) or (a is not None and b is not None and a.dtype == b.dtype
                                                     and same_bits(a, b)) for a, b in zip(got, want)):
                failed.append(f"{label}: {name} against the plain version")
                ok = False
        print(f"{label}: {'bit-equal' if ok else 'DIFFERS'} on both trees and the plain version", flush=True)

    # Inputs as chip_smoke.py's phases 3 and 12a.
    data, _ = make_synthetic_dataset(num_per_class=18, num_classes=cs.NUM_CLASSES, num_points=cs.NUM_POINT, seed=0)
    order_idx = np.random.RandomState(0).permutation(len(data))[: cs.BATCH]
    x0 = torch.from_numpy(data[order_idx]).to(dev)
    _, sa1_xyz = fps_plain(x0, 512)
    _, key, qkey = sort_keys(x0, sa1_xyz)
    g = torch.Generator().manual_seed(21)
    lattice = torch.randint(-3, 4, (cs.BATCH, cs.NUM_POINT), generator=g).float() * 0.25
    lattice[:, ::9] = -0.0
    lattice[:2, 5::301] = float("nan")
    feats = torch.randn(cs.BATCH, cs.NUM_POINT, 64, generator=g).to(dev, torch.bfloat16)
    ramp = torch.arange(cs.NUM_POINT, dtype=torch.float32, device=dev).expand(cs.BATCH, -1).contiguous()
    cases = (
        ("points B=128 N=2048", key, x0, None), ("queries B=128 M=512", qkey, sa1_xyz, None),
        ("tie lattice with -0.0 and NaN keys", lattice.to(dev), x0, None),
        ("points with bf16 feature rows C=64", key, x0, feats),
        ("ascending keys", ramp, x0, None), ("descending keys", -ramp, x0, None),
        ("all keys equal", torch.zeros_like(key), x0, None),
        ("all keys NaN", torch.full_like(key, float("nan")), x0, None),
    )
    for label, k, pts, rows in cases:
        check(f"#5 {label}", lambda: rank_sort_points(k, pts, rows), lambda: rank_sort_points_plain(k, pts, rows))

    # 1. The two SA1 calls in turns, then every plan on the change.
    work = cs.Work()
    for k in (key, qkey):
        cs.rank_sort_work(work, *k.shape)
    bound = work.record()

    def sa1_sorts():
        return rank_sort_points(key, x0), rank_sort_points(qkey, sa1_xyz)

    for label, fn in (("points N=2048", lambda: rank_sort_points(key, x0)),
                      ("queries M=512", lambda: rank_sort_points(qkey, sa1_xyz)), ("both SA1 calls", sa1_sorts)):
        ms, dev_ms = turns(fn), turns(fn, timer=cs.device_ms)
        line = "; ".join(f"{name} {[round(v, 4) for v in ms[name]]} ms (device {[round(v, 4) for v in dev_ms[name]]})"
                         for name in names)
        print(f"#5 {label}: {line} (events {mean(ms['parent']) / mean(ms['change']):.3f}x, device "
              f"{mean(dev_ms['parent']) / mean(dev_ms['change']):.3f}x) ({smi})", flush=True)
    for label, fn in (("points N=2048", lambda: rank_sort_points(key, x0)),
                      ("queries M=512", lambda: rank_sort_points(qkey, sa1_xyz))):
        check(f"#5 {label} (one-row build)", lambda: run("one_row", fn), lambda: rank_sort_points_plain(*(
            (key, x0) if label.startswith("points") else (qkey, sa1_xyz))))
        dev_ms = {name: [] for name in ("change", "one_row")}
        for name in ("change", "one_row", "one_row", "change"):
            dev_ms[name].append(run(name, lambda: cs.device_ms(fn)))
        print(f"#5 {label}, the rows grouped (change) or one at a time (one_row): device " + "; ".join(
            f"{name} {[round(v, 4) for v in ms]} ms" for name, ms in dev_ms.items()) + f" ({smi})", flush=True)
    lib_ms = cs.device_ms(lambda: (torch.argsort(key, dim=1, stable=True), torch.argsort(qkey, dim=1, stable=True)))
    print(f"#5 both SA1 calls: bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}); torch.argsort(stable=True) "
          f"{lib_ms:.4f} ms of device time ({smi})", flush=True)

    for label, k, pts in (("points N=2048", key, x0), ("queries M=512", qkey, sa1_xyz)):
        n = k.shape[1]
        for per in PER_THREAD:
            threads = sort_words(n, per) // per
            if threads > MAX_THREADS:
                continue
            info = (ctypes.c_int * 4)()
            _build.check(libs["change"].ranksort_info(n, threads, per, ctypes.addressof(info)), "ranksort_info")
            with mock.patch.object(ranksort_kernel, "sort_plan", lambda _n, p=(threads, per): p):
                got = rank_sort_points(k, pts)
                ms = cs.device_ms(lambda: rank_sort_points(k, pts))
            want = rank_sort_points_plain(k, pts)
            if not all(torch.equal(a, b) for a, b in zip(got[:3], want[:3])):
                failed.append(f"#5 {label} plan ({threads}, {per}) against the plain version")
            mark = " (the plan)" if (threads, per) == sort_plan(n) else ""
            print(f"#5 {label} plan {threads} threads x {per} words{mark}: device {ms:.4f} ms, "
                  f"{shared_steps(threads)} shared-memory steps, registers {info[0]}, local bytes {info[1]}, "
                  f"shared bytes {info[2]}, blocks per SM {info[3]} ({smi})", flush=True)

    # 2. The bf16 SSG forward under "auto", logits on both trees.
    model = configure_eval(get_model("pointnet2_cls_ssg", generator=torch.Generator().manual_seed(0),
                                     dtype=torch.bfloat16), "auto").eval()
    with torch.no_grad():
        logits = {name: run(name, lambda: model(x0)["logits"]) for name in names}
        same = torch.equal(logits["parent"], logits["change"])
        if not same:
            failed.append("the bf16 SSG logits differ between the trees")
        ms = turns(lambda: model(x0))
    print(f"bf16 SSG forward B=128 N=2048 'auto': logits {'equal' if same else 'DIFFER'}; " + "; ".join(
        f"{name} {[round(v, 4) for v in ms[name]]} ms" for name in names) + f" by CUDA events ({smi})", flush=True)

    # 3. profile_forward.py from both trees.
    busy = {name: [] for name in names}
    for name in order:
        res = profile_runs(parent if name == "parent" else ROOT, [], "bf16")
        busy[name].append(res)
    for name in names:
        print(f"profile_forward.py bf16 SSG 'auto' ({name}): busy "
              f"{[round(r['device_busy_ms'], 4) for r in busy[name]]} ms, idle share "
              f"{[round(r['idle_share_of_window'], 4) for r in busy[name]]}, kernels "
              f"{[r['kernels'] for r in busy[name]]} ({smi})", flush=True)
        for r in busy[name]:
            sorts = sum(v for kname, v in r["device_ms_by_kernel"].items() if "ranksort" in kname)
            print(f"  {name}: ranksort kernels {sorts:.4f} ms of the forward's busy time", flush=True)
    if failed:
        print("FAILED: " + "; ".join(failed))
        sys.exit(1)
    print("rank_sort.py: every output bit-equal to the parent's and the plain version")


if __name__ == "__main__":
    main()
