#!/usr/bin/env python3
"""The self-kNN graph kernel (#11, ``csrc/knn.cu``) and the FPS register
kernel (#1/#2, ``csrc/fps.cu``) against another checkout's (the parent), on
one NVIDIA GPU:

    python3 studies/graph_fps.py --parent DIR    # from the repository root

Two kernel libraries are built: the package's, and the package's with
``knn.cu`` and ``fps.cu`` taken from ``DIR/scanobjectnn_torch/csrc`` (their
C entry points keep their signatures, so the package's wrappers drive both).
The package's wrappers and models run against each library in turn.

1. Call by call, on ``chip_smoke.py``'s seeded inputs: the five graphs of
   an f32 ``dgcnn`` forward at B=32, N=1024, k=20 (the T-Net's and
   EdgeConv 1-4's inputs, C = 3, 3, 64, 64, 64), and FPS at the bf16 SSG
   forward's two calls (B=128: 2048->512, 512->128) and the SSG training
   step's two (B=16: 1024->512, 512->128), with and without coordinates.
   Each output must be bit-equal to the parent's; CUDA-event times in turns
   parent, change, change, parent; the graph beside its bound and its
   no-contraction issue bound, FPS in us a step.
2. End to end, in the same turns: the f32 ``dgcnn`` forward (B=32) and its
   ``Trainer.train_step``, the f32 ``spidercnn_cls_xyz`` forward (B=32), the
   bf16 SSG forward (B=128, N=2048, ``sa_bucket`` "auto") and the f32 SSG
   ``Trainer.train_step`` (B=16, N=1024).  Logits must be bit-equal to the
   parent's, and each step's loss equal.

Prints the card's name and power limit first; exits 1 if an output differs
from the parent's.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import os
import subprocess
import sys
import time
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from scanobjectnn_torch.ops.cuda import _build  # noqa: E402

SWAPPED = ("knn.cu", "fps.cu")


def build(name: str, sources: list[str]) -> ctypes.CDLL:
    """Compile ``sources`` (one nvcc a source, in parallel) into
    ``_build/lib<name>.so`` and load it with the package's signatures, for
    the entry points it has."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(_build.BUILD_DIR, f"lib{name}.so")
    objects = [os.path.join(_build.BUILD_DIR, f"{name}.{os.path.basename(src)}.o") for src in sources]
    nvcc = _build._nvcc()
    procs = [subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-I", _build.CSRC, "-c", src, "-o", obj])
             for src, obj in zip(sources, objects)]
    if any(proc.wait() for proc in procs):
        raise RuntimeError(f"graph_fps.py: nvcc failed ({name})")
    subprocess.run([nvcc, *_build.NVCC_FLAGS, "-shared", "-o", lib_path, *objects], check=True)
    lib = ctypes.CDLL(lib_path)
    for fn_name, argtypes in _build._SIGNATURES.items():
        if hasattr(lib, fn_name):
            fn = getattr(lib, fn_name)
            fn.argtypes, fn.restype = argtypes, _build._RESTYPES.get(fn_name, ctypes.c_int)
    lib.kernel_error_string.argtypes, lib.kernel_error_string.restype = (ctypes.c_int,), ctypes.c_char_p
    return lib


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", required=True, help="a checkout whose knn.cu and fps.cu to hold these against")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("graph_fps.py: needs an NVIDIA GPU")
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
    from scanobjectnn_torch.nn.pointnet_modules import configure_eval
    from scanobjectnn_torch.ops.cuda.edge_kernel import edge_gather_knn, edge_reduce
    from scanobjectnn_torch.ops.cuda.fps_kernel import fps, fps_plain
    from scanobjectnn_torch.ops.cuda.knn_kernel import knn_graph_kernel
    from scanobjectnn_torch.train.trainer import Trainer, TrainerConfig

    parent_csrc = os.path.join(os.path.abspath(args.parent), "scanobjectnn_torch", "csrc")
    sources = [os.path.join(parent_csrc, os.path.basename(src)) if os.path.basename(src) in SWAPPED else src
               for src in sorted(glob.glob(os.path.join(_build.CSRC, "*.cu")))]
    libs = {"change": _build.library(), "parent": build("graph_fps_parent", sources)}

    def run(name, fn):
        with mock.patch.object(_build, "_lib", libs[name]):
            return fn()

    def turns(fn):
        """CUDA-event ms of ``fn`` on each library, in turns parent, change,
        change, parent."""
        ms = {"parent": [], "change": []}
        for name in ("parent", "change", "change", "parent"):
            ms[name].append(run(name, lambda: cs.cuda_ms(fn)))
        return ms

    def mean(v):
        return sum(v) / len(v)

    failed = []

    def same_on_both(label, fn, compare=torch.equal):
        a, b = run("parent", fn), run("change", fn)
        pairs = zip(a, b) if isinstance(a, tuple) else [(a, b)]
        same = all(compare(x, y) for x, y in pairs)
        if not same:
            failed.append(label)
        return same

    # Inputs as chip_smoke.py's phases 2, 4 and 6.
    b, n, k = cs.DGCNN_BATCH, cs.DGCNN_POINT, cs.DGCNN_K
    data, labels, masks = make_synthetic_dataset(num_per_class=9, num_classes=cs.NUM_CLASSES, num_points=2 * n,
                                                 seed=2, with_mask=True)
    view = EpochSampler(data, labels, masks=convert_to_binary_mask(masks).astype(np.int64), num_points=n,
                        seed=0).epoch()
    dgcnn_batches = list(Batches(view, b))
    xd = torch.from_numpy(dgcnn_batches[0]["points"]).to(dev)
    dgcnn_models = cs.eval_models("dgcnn", np.random.RandomState(8))
    graphs = []

    def recorder(fn):
        def call(feats, vals, kk):
            graphs.append(feats.detach().float().contiguous())
            return fn(feats, vals, kk)
        return call

    with torch.no_grad(), mock.patch.object(dgcnn, "edge_gather_knn", recorder(edge_gather_knn)), \
            mock.patch.object(dgcnn, "edge_reduce", recorder(edge_reduce)):
        dgcnn_models["f32"](xd)
    labels5 = ["T-Net"] + [f"EdgeConv{i}" for i in range(1, 5)]

    ssg_data, _ = make_synthetic_dataset(num_per_class=18, num_classes=cs.NUM_CLASSES, num_points=cs.NUM_POINT, seed=0)
    x128 = torch.from_numpy(ssg_data[np.random.RandomState(0).permutation(len(ssg_data))[:cs.BATCH]]).to(dev)
    _, s128 = fps_plain(x128, 512)
    tdata, tlabels = make_synthetic_dataset(num_per_class=8, num_classes=cs.NUM_CLASSES, num_points=2 * cs.TRAIN_POINT,
                                            seed=0)
    train_batches = list(Batches(EpochSampler(tdata, tlabels, num_points=cs.TRAIN_POINT, seed=0).epoch(),
                                 cs.TRAIN_BATCH))
    x16 = torch.from_numpy(train_batches[0]["points"]).to(dev)
    _, s16 = fps_plain(x16, 512)

    # 1. Call by call.
    totals = {"graph": {"parent": 0.0, "change": 0.0}, "fps": {"parent": 0.0, "change": 0.0}}
    with torch.no_grad():
        for label, feats in zip(labels5, graphs):
            same = same_on_both(f"graph {label}", lambda: knn_graph_kernel(feats, k))
            ms = turns(lambda: knn_graph_kernel(feats, k))
            call = cs.Work()
            cs.graph_work(call, feats, k)
            bound = call.record()
            for name in ms:
                totals["graph"][name] += mean(ms[name])
            print(f"graph {label} C={feats.shape[-1]} B={b} N={n} k={k}: bit-equal to the parent: {same}; change "
                  f"{ms['change']} ms, parent {ms['parent']} ms (mean {mean(ms['change']):.4f} against "
                  f"{mean(ms['parent']):.4f}: {mean(ms['parent']) / mean(ms['change']):.3f}x); bound "
                  f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}), no-contraction issue bound "
                  f"{cs.graph_issue_ms(feats):.4f} ms ({smi})", flush=True)
        for label, xyz, m in ((f"B={cs.BATCH} 2048->512", x128, 512), (f"B={cs.BATCH} 512->128", s128, 128),
                              (f"B={cs.TRAIN_BATCH} 1024->512", x16, 512), (f"B={cs.TRAIN_BATCH} 512->128", s16, 128)):
            coords = cs.BATCH == xyz.shape[0]  # the forward's calls take coordinates, the step's do not
            same = same_on_both(f"fps {label}", lambda: fps(xyz, m)) and \
                same_on_both(f"fps {label} indices only", lambda: fps(xyz, m, with_coords=False))
            ms = turns(lambda: fps(xyz, m, with_coords=coords))
            for name in ms:
                totals["fps"][name] += mean(ms[name])
            mhz = cs.sm_clock_mhz()
            steps = {name: mean(v) * 1e3 / (m - 1) for name, v in ms.items()}
            print(f"fps {label} ({'with' if coords else 'without'} coordinates): bit-equal to the parent: {same}; "
                  f"change {ms['change']} ms, parent {ms['parent']} ms; a step {steps['change']:.4f} us "
                  f"({steps['change'] * mhz:.0f} SM cycles at {mhz} MHz) against {steps['parent']:.4f} us "
                  f"({steps['parent'] * mhz:.0f}) ({smi})", flush=True)
    print(f"sums: the five graphs {totals['graph']['change']:.4f} ms against {totals['graph']['parent']:.4f}; FPS "
          f"forward + step calls {totals['fps']['change']:.4f} ms against {totals['fps']['parent']:.4f} ({smi})",
          flush=True)

    # 2. End to end.
    def forward(label, model, x):
        with torch.no_grad():
            same = same_on_both(label, lambda: model(x)["logits"])
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
        for name in ("parent", "change", "change", "parent"):
            t, losses[name] = step_ms(name)
            ms[name].append(t)
        same = losses["parent"] == losses["change"]
        if not same:
            failed.append(label)
        print(f"{label}: losses equal to the parent's: {same} {losses['change']}; change {ms['change']} ms, parent "
              f"{ms['parent']} ms (mean {mean(ms['change']):.4f} against {mean(ms['parent']):.4f}) ({smi})",
              flush=True)

    forward(f"dgcnn f32 forward B={b} N={n}", dgcnn_models["f32"], xd)
    steps(f"dgcnn f32 train_step B={b}", TrainerConfig(model="dgcnn", batch_size=b, device=str(dev)), dgcnn_batches)
    sdata, slabels = make_synthetic_dataset(num_per_class=5, num_classes=cs.NUM_CLASSES,
                                            num_points=2 * cs.SPIDER_POINT, seed=3)
    xs = torch.from_numpy(EpochSampler(sdata, slabels, num_points=cs.SPIDER_POINT, seed=0).epoch()["points"]
                          [:cs.SPIDER_BATCH]).to(dev)
    forward(f"spidercnn_cls_xyz f32 forward B={cs.SPIDER_BATCH}",
            cs.eval_models("spidercnn_cls_xyz", np.random.RandomState(11))["f32"], xs)
    ssg = cs.eval_models("pointnet2_cls_ssg", np.random.RandomState(1))["bf16"]
    configure_eval(ssg, "auto")
    forward(f"SSG bf16 forward B={cs.BATCH} N={cs.NUM_POINT} sa_bucket 'auto'", ssg, x128)
    steps(f"SSG f32 train_step B={cs.TRAIN_BATCH}", TrainerConfig(batch_size=cs.TRAIN_BATCH, device=str(dev)),
          train_batches)
    if failed:
        sys.exit(f"graph_fps.py: outputs differ from the parent's: {failed}")


if __name__ == "__main__":
    main()
