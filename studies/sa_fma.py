#!/usr/bin/env python3
"""The fused SA layer's register-tiled FMA MLP (``csrc/sapool.cuh``) against
the kernels of another checkout (the parent), and the share of its row
selection, on one NVIDIA GPU:

    python3 studies/sa_fma.py --parent DIR    # from the repository root

Three kernel libraries are built: the package's; the one of the checkout at
``DIR`` (every ``DIR/scanobjectnn_torch/csrc/*.cu``); and the package's with
``studies/sa_select.cuh`` pre-included into ``safused.cu`` and
``sabucket.cu``, whose blocks stop after selecting their rows.  The
package's wrappers run against each library in turn.

1. Call by call, on ``chip_smoke.py``'s seeded inputs and weights: #3 at
   SSG's SA1 and SA2 calls (B=128, N=2048) in f32 and bf16, #4 at the
   "auto" SA1 call in f32 and bf16, #3 at the two K=128 calls of a bf16
   ``pointnet2_cls_msg`` forward (B=32, N=1024), #10 at phase 10's four f32
   ``SAModule`` calls (B=32, N=1024: kNN K=32 and ball K=128 at SA1's and
   SA2's shapes).  Each call's output must be bit-equal to the parent's;
   CUDA-event times in turns parent, change, change, parent, and the
   selection alone; the call's MLP FLOPs (``chip_smoke.mlp_ops``), its f32 FMA
   bound (FLOPs over 67 TFLOP/s) and the TFLOP/s each library reached;
   the kernel's registers, local memory and blocks per SM.
2. The bf16 SSG forward at B=128, N=2048 under ``sa_bucket`` "auto" and
   "off" with the parent's and the package's library, in turns; the logits
   must be bit-equal.

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
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from scanobjectnn_torch.ops.cuda import _build  # noqa: E402

SELECT_SOURCES = {"safused.cu", "sabucket.cu"}
SELECT_FLAGS = ("-I", _build.CSRC, "--pre-include", os.path.join(ROOT, "studies", "sa_select.cuh"))


def build(name: str, csrc: str, flags_for: dict) -> ctypes.CDLL:
    """Compile every ``csrc/*.cu`` (one nvcc a source, in parallel, with
    ``flags_for[source]`` added) into ``_build/lib<name>.so`` and load it
    with the package's signatures, for the entry points it has."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(_build.BUILD_DIR, f"lib{name}.so")
    sources = sorted(glob.glob(os.path.join(csrc, "*.cu")))
    objects = [os.path.join(_build.BUILD_DIR, f"{name}.{os.path.basename(src)}.o") for src in sources]
    nvcc = _build._nvcc()
    procs = [subprocess.Popen([nvcc, *_build.NVCC_FLAGS, *flags_for.get(os.path.basename(src), ()),
                               "-c", src, "-o", obj]) for src, obj in zip(sources, objects)]
    if any(proc.wait() for proc in procs):
        raise RuntimeError(f"sa_fma.py: nvcc failed ({name})")
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
    parser.add_argument("--parent", required=True, help="a checkout whose kernels to hold this one against")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("sa_fma.py: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    from scanobjectnn_torch.convert import init_params
    from scanobjectnn_torch.data.pipeline import EpochSampler
    from scanobjectnn_torch.data.synthetic import make_synthetic_dataset
    from scanobjectnn_torch.nn import pointnet_modules
    from scanobjectnn_torch.nn.pointnet_modules import SAModule, configure_eval
    from scanobjectnn_torch.ops.cuda.fps_kernel import fps_plain
    from scanobjectnn_torch.ops.cuda.sabucket_kernel import AUTO_BUCKET, sa_ball_mlp_pool_bucketed
    from scanobjectnn_torch.ops.cuda.safused_kernel import kernel_info, sa_ball_mlp_pool, sa_ball_mlp_pool_plain
    from scanobjectnn_torch.ops.cuda.samlp_kernel import sa_mlp_pool

    libs = {"change": _build.library(),
            "parent": build("sa_fma_parent", os.path.join(os.path.abspath(args.parent), "scanobjectnn_torch", "csrc"),
                            {}),
            "select": build("sa_fma_select", _build.CSRC, {src: SELECT_FLAGS for src in SELECT_SOURCES})}

    def run(name, fn):
        with mock.patch.object(_build, "_lib", libs[name]):
            return fn()

    # Inputs and weights as chip_smoke.py's phases 2, 9, 10 and 12.
    bf16, f32 = torch.bfloat16, torch.float32
    data, _ = make_synthetic_dataset(num_per_class=18, num_classes=cs.NUM_CLASSES, num_points=cs.NUM_POINT, seed=0)
    x = torch.from_numpy(data[np.random.RandomState(0).permutation(len(data))[:cs.BATCH]]).to(dev)
    ssg = cs.eval_models("pointnet2_cls_ssg", np.random.RandomState(1))
    _, s1 = fps_plain(x, 512)
    _, s2 = fps_plain(s1, 128)
    window, qtile, gblk = AUTO_BUCKET[(cs.NUM_POINT, 512)]
    wtg = dict(window=window, qtile=qtile, gblk=gblk)
    calls = []  # (label, kernel, info shape, FLOPs)
    with torch.no_grad():
        for name, dtype in (("f32", f32), ("bf16", bf16)):
            w1, b1 = ssg[name].sa1.mlp.folded()
            w2, b2 = ssg[name].sa2.mlp.folded()
            a1 = (0.2, 32, x, s1, None, w1, b1)
            a2 = (0.4, 64, s1, s2, sa_ball_mlp_pool_plain(*a1, dtype=dtype)[0], w2, b2)
            for label, a in (("SA1", a1), ("SA2", a2)):
                calls.append((f"#3 SSG {label} {name} B=128 K={a[1]}",
                              lambda a=a, dtype=dtype: sa_ball_mlp_pool(*a, dtype=dtype)[0],
                              (a[1], 0 if a[4] is None else a[4].shape[-1], [w.shape[1] for w in a[5]], dtype, None),
                              cs.sa_flops(a)))
            calls.append((f"#4 SSG SA1 {name} B=128 (W, T, G) = {window, qtile, gblk}",
                          lambda a1=a1, dtype=dtype: sa_ball_mlp_pool_bucketed(*a1, dtype=dtype, **wtg)[0],
                          (32, 0, [w.shape[1] for w in w1], dtype, (cs.NUM_POINT, window)),
                          cs.sa_flops(a1)))

        msg = cs.eval_models("pointnet2_cls_msg", np.random.RandomState(15))["bf16"]
        mdata, mlabels = make_synthetic_dataset(num_per_class=5, num_classes=cs.NUM_CLASSES,
                                                num_points=2 * cs.MSG_POINT, seed=5)
        xm = torch.from_numpy(EpochSampler(mdata, mlabels, num_points=cs.MSG_POINT, seed=0).epoch()["points"]
                              [:cs.MSG_BATCH]).to(dev)
        recorded = []

        def recorder(*a, **kw):
            recorded.append((a, kw))
            return sa_ball_mlp_pool(*a, **kw)

        with mock.patch.object(pointnet_modules, "sa_ball_mlp_pool", recorder):
            msg(xm)
        for i, (a, kw) in enumerate(c for c in recorded if c[0][1] > 64):
            lifted = a[4] is not None and kw["use_xyz"] and a[4].shape[-1] > a[5][0].shape[1]
            cs_in = 0 if a[4] is None else (a[5][0].shape[1] if lifted else a[4].shape[-1])
            calls.append((f"#3 MSG K=128 call {i} bf16 B={cs.MSG_BATCH}",
                          lambda a=a, kw=kw: sa_ball_mlp_pool(*a, **kw)[0],
                          (a[1], cs_in, [w.shape[1] for w in a[5]], bf16, None),
                          cs.sa_flops(a, kw["use_xyz"])))

        data10, _ = make_synthetic_dataset(num_per_class=3, num_classes=cs.NUM_CLASSES, num_points=cs.SA_LAYER_POINT,
                                           seed=6)
        x10 = torch.from_numpy(data10[np.random.RandomState(16).permutation(len(data10))[:cs.SA_LAYER_BATCH]]).to(dev)
        gen, stats_rng = torch.Generator().manual_seed(16), np.random.RandomState(17)
        layers = {}
        for label, spec in (("SA1 knn K32", (512, None, 32, (64, 64, 128), 0, False, True)),
                            ("SA1 ball K128", (512, 0.2, 128, (64, 64, 128), 0, False, False)),
                            ("SA2 knn K32", (128, None, 32, (128, 128, 256), 128, False, True)),
                            ("SA2 ball K128", (128, 0.4, 128, (128, 128, 256), 128, False, False))):
            layer = init_params(SAModule(*spec), gen)
            for key, buf in layer.named_buffers():
                vals = stats_rng.randn(*buf.shape)
                buf.copy_(torch.from_numpy(0.1 + 0.1 * np.abs(vals) if key.endswith(".var") else 0.05 * np.abs(vals)))
            layers[label] = layer.to(dev).eval()
        l1_xyz, l1_points = layers["SA1 knn K32"](x10, None)
        inputs = {"SA1": (x10, None), "SA2": (l1_xyz, l1_points.contiguous())}
        recorded10 = []

        def recorder10(*a, dtype):
            recorded10.append(a)
            return sa_mlp_pool(*a, dtype=dtype)

        with mock.patch.object(pointnet_modules, "sa_mlp_pool", recorder10):
            for label, layer in layers.items():
                layer(*inputs[label[:3]])
        for label, a in zip(layers, recorded10):
            grouped, idx, src, weights, _ = a
            b, m, k = (grouped if grouped is not None else idx).shape[:3]
            calls.append((f"#10 {label} f32 B={cs.SA_LAYER_BATCH}", lambda a=a: sa_mlp_pool(*a, dtype=f32),
                          (k, 0 if src is None else src.shape[-1], [w.shape[1] for w in weights], f32, None),
                          cs.mlp_ops(weights, b * m * k)))

        # 1. Call by call.
        failed = []
        for label, kernel, (k, c_in, widths, dtype, bucket), flops in calls:
            same = torch.equal(run("parent", kernel), run("change", kernel))
            ms = {"parent": [], "change": []}
            for name in ("parent", "change", "change", "parent"):
                ms[name].append(run(name, lambda: cs.cuda_ms(kernel)))
            select_ms = run("select", lambda: cs.cuda_ms(kernel))
            info = kernel_info(k, c_in, widths, dtype, bucket)
            mean = {name: sum(v) / len(v) for name, v in ms.items()}
            bound_ms = flops / cs.F32_OPS_PER_S * 1e3
            print(f"{label}: bit-equal to the parent: {same}; change {ms['change']} ms, parent {ms['parent']} ms "
                  f"(mean {mean['change']:.4f} against {mean['parent']:.4f}: {mean['parent'] / mean['change']:.3f}x); "
                  f"selection alone {select_ms:.4f} ms ({select_ms / mean['change']:.3f} of the change's call); "
                  f"{flops / 1e9:.3f} GFLOP, f32 FMA bound {bound_ms:.4f} ms, change "
                  f"{flops / mean['change'] / 1e9:.2f} TFLOP/s, parent {flops / mean['parent'] / 1e9:.2f} TFLOP/s; "
                  f"{info['registers']} registers, {info['local_bytes']} local bytes, {info['smem_bytes']} shared "
                  f"bytes, {info['blocks_per_sm']} blocks per SM ({smi})", flush=True)
            if not same:
                failed.append(label)

        # 2. The bf16 SSG forward under "auto" and "off".
        model = ssg["bf16"]
        for setting in ("auto", "off"):
            configure_eval(model, setting)
            same = torch.equal(run("parent", lambda: model(x)["logits"]), run("change", lambda: model(x)["logits"]))
            ms = {"parent": [], "change": []}
            for name in ("parent", "change", "change", "parent"):
                ms[name].append(run(name, lambda: cs.cuda_ms(lambda: model(x))))
            print(f"bf16 SSG forward B=128 N=2048, sa_bucket '{setting}': logits bit-equal to the parent's: {same}; "
                  f"change {ms['change']} ms, parent {ms['parent']} ms ({smi})", flush=True)
            if not same:
                failed.append(f"SSG forward '{setting}'")
        configure_eval(model, "auto")
    if failed:
        sys.exit(f"sa_fma.py: outputs differ from the parent's: {failed}")


if __name__ == "__main__":
    main()
