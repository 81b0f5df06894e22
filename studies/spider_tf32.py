#!/usr/bin/env python3
"""A 3xTF32 SpiderConv forward (``studies/spider_tf32.cu``) against the
port's f32 FMA forward (``csrc/spider.cu``), on one NVIDIA GPU:

    python3 studies/spider_tf32.py      # from the repository root

1. conv1-4 of ``spidercnn_cls_xyz`` at B=32, N=1024, k=20, T=5 on seeded
   inputs: each forward's max abs error against the plain version (the gate
   ``SPIDER_FWD_TOL`` x max(1, |ref|max)) and against a float64 product of
   the same f32 operands; times by CUDA events beside ``torch.matmul`` of
   the materialised outer product.
2. One SpiderCNN training step at B=32 (``chip_smoke.py``'s phase-7 batch),
   the kernel path against the plain path, once with the port's forward and
   once with the 3xTF32 forward in its place: the loss, the largest gradient
   error over its scale (the step's gate is 1e-4), and the relu gates and
   top-2 picks that flipped.

It prints the card's name and power limit first and exits 0 whatever the
readings; it fails only where a kernel does not build or launch.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from scanobjectnn_torch.ops.cuda import _build, spider_kernel  # noqa: E402


def load_tf32() -> ctypes.CDLL:
    """Build ``spider_tf32.cu`` with the package's nvcc flags and load it."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(_build.BUILD_DIR, "libspider_tf32_study.so")
    src = os.path.join(ROOT, "studies", "spider_tf32.cu")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", lib_path, src], check=True)
    lib = ctypes.CDLL(lib_path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.spider_tf32_scratch.argtypes, lib.spider_tf32_scratch.restype = (i, i, i, i), ctypes.c_longlong
    lib.spider_tf32_launch.argtypes, lib.spider_tf32_launch.restype = (p, p, p, p) + (i,) * 6 + (p, p, p), i
    return lib


def tf32_forward(lib, feat, idx, g, kernel):
    b, n, c = feat.shape
    k, t, o = idx.shape[-1], g.shape[-1], kernel.shape[-1]
    out = torch.empty(b, n, o, dtype=torch.float32, device=feat.device)
    scratch = torch.empty(lib.spider_tf32_scratch(k, c, t, o), dtype=torch.float32, device=feat.device)
    args = [x.contiguous() for x in (feat.float(), idx.to(torch.int32), g.float(), kernel.float())]
    err = lib.spider_tf32_launch(*(x.data_ptr() for x in args), b, n, k, c, t, o, scratch.data_ptr(),
                                 out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"spider_tf32_launch: cudaError_t {err}")
    return out


def layers(lib, dev) -> None:
    b, n, k, t = cs.SPIDER_BATCH, cs.SPIDER_POINT, cs.SPIDER_K, 5
    total = {"3xTF32": 0.0, "port (f32 FMA)": 0.0, "torch.matmul": 0.0}
    for c, o in ((3, 32), (32, 64), (64, 128), (128, 256)):
        rng = np.random.RandomState(c)
        feat = torch.from_numpy(rng.randn(b, n, c).astype(np.float32)).to(dev)
        idx = torch.from_numpy(rng.randint(0, n, (b, n, k)).astype(np.int32)).to(dev)
        g = torch.from_numpy(rng.randn(b, n, k, t).astype(np.float32)).to(dev)
        kernel = torch.from_numpy((rng.randn(k * c * t, o) * np.sqrt(2.0 / (k * c * t + o))).astype(np.float32))
        kernel = kernel.to(dev)
        plain = spider_kernel.spider_conv_plain(feat, idx, g, kernel)
        grouped = feat[torch.arange(b, device=dev)[:, None, None], idx.long()]
        prod = (grouped[..., :, None] * g[..., None, :]).reshape(b, n, -1)
        ref64 = torch.matmul(prod.double(), kernel.double())
        tol = cs.SPIDER_FWD_TOL * cs.scale_of(plain)
        runs = {
            "3xTF32": lambda: tf32_forward(lib, feat, idx, g, kernel),
            "port (f32 FMA)": lambda: spider_kernel.spider_conv_fwd_kernel(feat, idx, g, kernel),
            "torch.matmul": lambda: torch.matmul(prod, kernel),
        }
        line = [f"C={c} O={o}: plain vs float64 {float((plain.double() - ref64).abs().max()):.3e}"]
        for name, fn in runs.items():
            got = fn()
            ms = cs.cuda_ms(fn, iters=3 if name == "torch.matmul" else 10)
            total[name] += ms
            line.append(f"{name} {ms:.4f} ms, vs plain {float((got - plain).abs().max()):.3e} (gate {tol:.3e}), "
                        f"vs float64 {float((got.double() - ref64).abs().max()):.3e}")
        print("; ".join(line), flush=True)
        del grouped, prod, ref64
        torch.cuda.empty_cache()
    print("conv1-4 in all: " + ", ".join(f"{name} {ms:.4f} ms" for name, ms in total.items()))


def step(lib, dev) -> None:
    from scanobjectnn_torch.data.pipeline import Batches, EpochSampler
    from scanobjectnn_torch.data.synthetic import make_synthetic_dataset
    from scanobjectnn_torch.models import spidercnn
    from scanobjectnn_torch.train.trainer import Trainer, TrainerConfig

    b, n = cs.SPIDER_BATCH, cs.SPIDER_POINT
    data, labels = make_synthetic_dataset(num_per_class=9, num_classes=cs.NUM_CLASSES, num_points=2 * n, seed=3)
    batch = list(Batches(EpochSampler(data, labels, num_points=n, seed=0).epoch(), b))[cs.TRAIN_STEPS]
    trainer = Trainer(TrainerConfig(model="spidercnn_cls_xyz", batch_size=b, device=str(dev)))

    def run(plain: bool):
        seen = {"conv": [], "pool": []}
        pool = spidercnn.topk_pool

        def recorded_pool(feat, k=2):
            seen["pool"].append(feat.detach().clone())
            return pool(feat, k)

        state = trainer.init_state(seed=1)
        hooks = [m.register_forward_hook(lambda mod, inp, out: seen["conv"].append(out.detach().clone()))
                 for m in state.model.modules() if isinstance(m, spidercnn.SpiderConv)]
        with mock.patch.object(spidercnn, "topk_pool", recorded_pool):
            if plain:
                with cs.plain_path():
                    state, metrics = trainer.train_step(state, batch)
            else:
                state, metrics = trainer.train_step(state, batch)
        for h in hooks:
            h.remove()
        grads = {name: p.grad.float().clone() for name, p in state.model.named_parameters()}
        return float(metrics["loss"]), grads, seen

    def picks(feat):
        x, out = feat.transpose(1, 2), []
        for _ in range(2):
            am = torch.argmax(x, -1, keepdim=True)
            out.append(am)
            x = x.scatter(-1, am, float("-inf"))
        return torch.cat(out, -1)

    loss_p, grads_p, seen_p = run(plain=True)
    tf32 = lambda feat, idx, g, kernel: tf32_forward(lib, feat, idx, g, kernel)  # noqa: E731
    for label, patch in (("port forward (f32 FMA)", None), ("3xTF32 forward", tf32)):
        if patch is None:
            loss_k, grads_k, seen_k = run(plain=False)
        else:
            with mock.patch.object(spider_kernel, "spider_conv_fwd_kernel", patch):
                loss_k, grads_k, seen_k = run(plain=False)
        flips = [int(((a == 0) != (z == 0)).sum()) for a, z in zip(seen_k["conv"], seen_p["conv"])]
        pick_diff = int((picks(seen_k["pool"][0]) != picks(seen_p["pool"][0])).sum())
        err, worst = max((float((grads_k[name] - grads_p[name]).abs().max()) / cs.scale_of(grads_p[name]), name)
                         for name in grads_p)
        print(f"SpiderCNN step B={b}, {label} against the plain path: loss rel err "
              f"{abs(loss_k - loss_p) / abs(loss_p):.3e} (gate {cs.SPIDER_LOSS_RTOL}); largest gradient error / "
              f"scale {err:.3e} ({worst}; gate {cs.TRAIN_GRAD_TOL}); relu gates flipped in conv1-4 {flips}; "
              f"top-2 picks flipped {pick_diff}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("spider_tf32.py: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    lib = load_tf32()
    layers(lib, dev)
    step(lib, dev)


if __name__ == "__main__":
    main()
