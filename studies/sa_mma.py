#!/usr/bin/env python3
"""The fused SA layer's bf16 MLP on the tensor cores (``studies/sa_mma.cuh``)
against the package's f32 FMA version, on one NVIDIA GPU:

    python3 studies/sa_mma.py      # from the repository root

The package's kernel library is built as usual, and a second one in which
``csrc/safused.cu`` and ``csrc/sabucket.cu`` are compiled with
``sa_mma.cuh`` pre-included (the other sources as the package builds
them).  The package's wrappers then run against either library.

1. Call by call, on seeded inputs and bf16 weights of ``pointnet2_cls_ssg``
   and ``pointnet2_cls_msg``: #3 at SSG's SA1 and SA2 calls (B=128,
   N=2048), #4 at SA1 (its "auto" window), #3 at MSG SA1's K=128 scale and
   #10 over a kNN grouping (B=32, N=1024).  Each is held to its plain
   version by ``chip_smoke.py``'s SA gate (``BF16_SA_ULPS`` ulps of the
   scale on at most ``BF16_MAX_DIFFERING`` of the elements) and timed by
   CUDA events beside the FMA library (FMA, tensor cores, tensor cores,
   FMA); #4 is compared bit for bit with #3.
2. The bf16 SSG (``sa_bucket`` "auto" and "off") and MSG forwards with
   either library: the logits' distance from the plain path by the logits
   gate (``BF16_LOGIT_ULPS``), and the time of a forward.

It prints the card's name and power limit first and exits 0 whatever the
readings; it fails only where a kernel does not build or launch.
"""

from __future__ import annotations

import ctypes
import glob
import math
import os
import subprocess
import sys
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from scanobjectnn_torch.ops.cuda import _build  # noqa: E402

HEADER = os.path.join(ROOT, "studies", "sa_mma.cuh")
# The sources whose bf16 MLP the header replaces.  -maxrregcount=80 lets
# three 256-thread blocks share an SM (65536 registers / 768 threads = 85).
MMA_SOURCES = {"safused.cu", "sabucket.cu"}
MMA_FLAGS = ("-I", _build.CSRC, "--pre-include", HEADER, "-maxrregcount=80")


def load_mma() -> ctypes.CDLL:
    """Build the library with the tensor-core MLP and load it with the
    package's signatures."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(_build.BUILD_DIR, "libsa_mma_study.so")
    sources = sorted(glob.glob(os.path.join(_build.CSRC, "*.cu")))
    objects = [os.path.join(_build.BUILD_DIR, f"sa_mma_study.{os.path.basename(src)}.o") for src in sources]
    nvcc = _build._nvcc()
    procs = [subprocess.Popen([nvcc, *_build.NVCC_FLAGS,
                               *(MMA_FLAGS if os.path.basename(src) in MMA_SOURCES else ()), "-c", src, "-o", obj])
             for src, obj in zip(sources, objects)]
    if any(proc.wait() for proc in procs):
        raise RuntimeError("sa_mma.py: nvcc failed")
    subprocess.run([nvcc, *_build.NVCC_FLAGS, "-shared", "-o", lib_path, *objects], check=True)
    lib = ctypes.CDLL(lib_path)
    for name, argtypes in _build._SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, _build._RESTYPES.get(name, ctypes.c_int)
    lib.kernel_error_string.argtypes, lib.kernel_error_string.restype = (ctypes.c_int,), ctypes.c_char_p
    return lib


def gate(got, want, ulps: int) -> tuple[float, float, bool]:
    """(max difference in bf16 ulps of the scale, share of elements that
    differ, whether chip_smoke.py's bf16 gate holds)."""
    diff = (got.float() - want.float()).abs()
    ulp = 2.0 ** (math.floor(math.log2(cs.scale_of(want))) - 7)
    err, share = float(diff.max()) / ulp, float((diff > 0).float().mean())
    return err, share, err <= ulps and share <= cs.BF16_MAX_DIFFERING


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("sa_mma.py: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    from scanobjectnn_torch.data.synthetic import make_synthetic_dataset
    from scanobjectnn_torch.models import get_model
    from scanobjectnn_torch.nn.pointnet_modules import configure_eval
    from scanobjectnn_torch.ops.cuda.fps_kernel import fps_plain
    from scanobjectnn_torch.ops.cuda.knn_kernel import knn_point_plain
    from scanobjectnn_torch.ops.cuda.sabucket_kernel import AUTO_BUCKET, sa_ball_mlp_pool_bucketed
    from scanobjectnn_torch.ops.cuda.safused_kernel import sa_ball_mlp_pool, sa_ball_mlp_pool_plain
    from scanobjectnn_torch.ops.cuda.samlp_kernel import sa_mlp_pool, sa_mlp_pool_plain

    libs = {"fma": _build.library(), "mma": load_mma()}

    def run(name, fn):
        with mock.patch.object(_build, "_lib", libs[name]):
            return fn()

    bf16 = torch.bfloat16
    data, _ = make_synthetic_dataset(num_per_class=18, num_classes=cs.NUM_CLASSES, num_points=cs.NUM_POINT, seed=0)
    x = torch.from_numpy(data[np.random.RandomState(0).permutation(len(data))[:cs.BATCH]]).to(dev)
    model = get_model("pointnet2_cls_ssg", generator=torch.Generator().manual_seed(0), dtype=bf16)
    stats_rng = np.random.RandomState(1)
    with torch.no_grad():
        for key, buf in model.named_buffers():
            vals = stats_rng.randn(*buf.shape)
            buf.copy_(torch.from_numpy(0.1 + 0.1 * np.abs(vals) if key.endswith(".var") else 0.05 * np.abs(vals)))
    model.eval()
    msg = get_model("pointnet2_cls_msg", generator=torch.Generator().manual_seed(0), dtype=bf16).eval()
    _, s1 = fps_plain(x, 512)
    _, s2 = fps_plain(s1, 128)
    xm = x[:32, :1024].contiguous()
    _, c1 = fps_plain(xm, 512)
    window, qtile, gblk = AUTO_BUCKET[(cs.NUM_POINT, 512)]
    wtg = dict(window=window, qtile=qtile, gblk=gblk)
    with torch.no_grad():
        # 1. Call by call, each held to its plain version by the SA gate.
        w1, b1 = model.sa1.mlp.folded()
        w2, b2 = model.sa2.mlp.folded()
        a1 = (0.2, 32, x, s1, None, w1, b1)
        a2 = (0.4, 64, s1, s2, sa_ball_mlp_pool_plain(*a1, dtype=bf16)[0], w2, b2)
        wm, bm = msg.sa1.mlp_scale2.folded()
        am = (0.4, 128, xm, c1, None, wm, bm)
        _, nn_idx = knn_point_plain(c1, xm, 32)
        grouped = (xm[torch.arange(32, device=dev)[:, None, None], nn_idx.long()] - c1[:, :, None, :]).contiguous()
        calls = {
            "#3 SSG SA1 B=128 K=32": (lambda: sa_ball_mlp_pool(*a1, dtype=bf16)[0],
                                      lambda: sa_ball_mlp_pool_plain(*a1, dtype=bf16)[0]),
            "#3 SSG SA2 B=128 K=64": (lambda: sa_ball_mlp_pool(*a2, dtype=bf16)[0],
                                      lambda: sa_ball_mlp_pool_plain(*a2, dtype=bf16)[0]),
            f"#4 SSG SA1 B=128 (W, T, G) = {window, qtile, gblk}": (
                lambda: sa_ball_mlp_pool_bucketed(*a1, dtype=bf16, **wtg)[0],
                lambda: sa_ball_mlp_pool_plain(*a1, dtype=bf16)[0]),
            "#3 MSG SA1 scale 3 B=32 K=128": (lambda: sa_ball_mlp_pool(*am, dtype=bf16, xyz_first=False)[0],
                                              lambda: sa_ball_mlp_pool_plain(*am, dtype=bf16, xyz_first=False)[0]),
            "#10 kNN grouping SA1 B=32 K=32": (lambda: sa_mlp_pool(grouped, None, None, w1, b1, dtype=bf16),
                                               lambda: sa_mlp_pool_plain(grouped, None, None, w1, b1, dtype=bf16)),
        }
        for label, (kernel, plain) in calls.items():
            want = plain()
            ms = {"fma": [], "mma": []}
            for name in ("fma", "mma", "mma", "fma"):
                ms[name].append(run(name, lambda: cs.cuda_ms(kernel)))
            readings = {name: gate(run(name, kernel), want, cs.BF16_SA_ULPS) for name in ("fma", "mma")}
            print(f"{label}: tensor cores {ms['mma']} ms, FMA {ms['fma']} ms; against the plain version "
                  + "; ".join(f"{name} {err:.3f} ulps of the scale, {share:.3e} of elements differ, the SA gate "
                              f"{'holds' if ok else 'is missed'}" for name, (err, share, ok) in readings.items())
                  + f" ({smi})", flush=True)
        same = run("mma", lambda: torch.equal(sa_ball_mlp_pool_bucketed(*a1, dtype=bf16, **wtg)[0],
                                              sa_ball_mlp_pool(*a1, dtype=bf16)[0]))
        print(f"tensor cores: #4 bit-equal to #3 at SSG SA1: {same}", flush=True)

        # 2. The bf16 SSG and MSG forwards: the logits against the plain path
        #    by the logits gate, and the time of a forward.
        with cs.plain_path():
            refs = {"SSG": model(x)["logits"], "MSG": msg(xm)["logits"]}
        for label, net, inp in (("SSG B=128 N=2048", model, x), ("MSG B=32 N=1024", msg, xm)):
            out = {}
            for setting in (("auto", "off") if net is model else ("auto",)):
                configure_eval(net, setting)
                for name in ("fma", "mma"):
                    got = out[name, setting] = run(name, lambda: net(inp)["logits"])
                    err, share, ok = gate(got, refs[label[:3]], cs.BF16_LOGIT_ULPS)
                    ms = run(name, lambda: cs.cuda_ms(lambda: net(inp)))
                    print(f"bf16 {label} forward, {name}, sa_bucket '{setting}': {ms:.4f} ms; logits against the "
                          f"plain path {err:.3f} ulps, {share:.3e} of elements differ, the logits gate "
                          f"{'holds' if ok else 'is missed'}; classes equal "
                          f"{bool(torch.equal(got.argmax(-1), refs[label[:3]].argmax(-1)))} ({smi})", flush=True)
            configure_eval(net, "auto")
            if net is model:
                print(f"tensor cores: SSG logits under 'auto' bit-equal to 'off': "
                      f"{torch.equal(out['mma', 'auto'], out['mma', 'off'])}", flush=True)


if __name__ == "__main__":
    main()
