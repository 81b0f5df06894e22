"""Build and load the package's CUDA kernels.

On first use, ``library()`` compiles every ``scanobjectnn_torch/csrc/*.cu``
with nvcc for Hopper (``sm_90a``), one nvcc process per source, all started
together, links the objects into one shared library with a plain C
interface under ``scanobjectnn_torch/_build/`` and loads it with ``ctypes``.
The file name carries a hash of the sources, headers and flags, so an
edited source never loads a stale library.  Nothing is built or loaded at
import time.

Every pointer and the stream cross the boundary as ``c_void_p`` (a bare
Python int would be cut to 32 bits); each entry point returns the
``cudaError_t`` of its launch, which ``check`` turns into an exception.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points and their argument types (see csrc/*.cu).
_SIGNATURES = {
    # xyz, b, n, m, idx, new_xyz (nullable), mind (nullable), stream
    "fps_launch": (_P, _I, _I, _I, _P, _P, _P, _P),
    # xyz, new_xyz, src, b, n, m, cs, k, r2, w0x, w0f, prelifted, bf16,
    # n_layers, widths*, weights*, biases*, pooled, idx (nullable), stream
    "safused_launch": (
        _P, _P, _P, _I, _I, _I, _I, _I, _F, _P, _P, _I, _I,
        _I, _P, _P, _P, _P, _P, _P,
    ),
    # xyz, new_xyz, src, xyz_s, ids, q_s, qids, axis, b, n, m, cs, k, r2, w, t,
    # g, pad_r, w0x, w0f, prelifted, bf16, n_layers, widths*, weights*,
    # biases*, pooled, overflow, stream
    "sabucket_launch": (
        _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I,
        _I, _F, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P,
    ),
    # key, xyz, feats, b, n, row_units, threads, per_thread, xyz_s, ids,
    # rank, feats_s, stream
    "ranksort_launch": (_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P),
    # n, threads, per_thread, info* (int[4])
    "ranksort_info": (_I, _I, _I, _P),
    # grouped, idx, src, b, n, m, cs, k, w0x, w0f, bf16, n_layers, widths*,
    # weights*, biases*, pooled, stream
    "samlp_launch": (_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _I, _I, _P, _P, _P, _P, _P),
    # bf16, k, cs, n_layers, widths*, info* (int[4])
    "safused_info": (_I, _I, _I, _I, _P, _P),
    # bf16, k, cs, n, w, n_layers, widths*, info* (int[4])
    "sabucket_info": (_I, _I, _I, _I, _I, _I, _P, _P),
    # xyz, new_xyz, b, n, m, k, r2, queries, per_warp, unroll, tile, grouped,
    # idx, cnt, stream
    "ballgroup_launch": (_P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I, _P, _P, _P, _P),
    # xyz, new_xyz, b, n, m, k, r2, queries, per_warp, unroll, tile, idx, cnt,
    # stream
    "ballquery_launch": (_P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I, _P, _P, _P),
    # queries, per_warp, unroll, tile, info* (int[4])
    "ballgroup_info": (_I, _I, _I, _I, _P),
    # vals, idx, b, n, r, c, out, stream
    "gather_launch": (_P, _P, _I, _I, _I, _I, _P, _P),
    # n, r -> tiles of the counting sort (its scratch: b * tiles * n int32)
    "count_sort_tiles_for": (_I, _I),
    # idx, b, n, r, offsets, perm, counts, stream
    "count_sort_launch": (_P, _I, _I, _I, _P, _P, _P, _P),
    # idx, upd, b, n, r, c, offsets, perm, counts, out, stream
    "scatter_add_launch": (_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P),
    # queries, keys, bias (nullable), b, m, n, c, k, route, group, dist, idx,
    # scratch (nullable), stream
    "knn_launch": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    # feats, b, n, c, k, route, group, idx, dist (k <= 32: the norms),
    # scratch (nullable), vals (nullable: the graph alone), out, cv, element
    # bytes of vals, stream
    "knn_graph_launch": (_P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _P),
    # c, gather (0: the graph alone; else the element bytes of vals), info* (int[4])
    "knn_graph_info": (_I, _I, _P),
    # route, group, n, c, k, info* (int[4])
    "knn_point_info": (_I, _I, _I, _I, _I, _P),
    # n, info* (int[5])
    "fps_info": (_I, _P),
    # xyz, b, n, dup, stream
    "dupmask_launch": (_P, _I, _I, _P, _P),
    # b, n, stream: an empty kernel at dupmask_launch's grid
    "dupmask_floor_launch": (_I, _I, _P),
    # info* (int[4])
    "dupmask_info": (_P,),
    # vals, idx, b, n, k, cv, lanes, mmax, mmin, sum, sumsq, cntmax, cntmin, stream
    "edge_reduce_fwd_launch": (_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P),
    # vals, idx, mmax, mmin, cntmax, cntmin, dmax, dmin, ds, dq2, b, n, k, cv,
    # slice, offsets, perm, counts, dvals, stream
    "edge_reduce_bwd_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P),
    # kernel, width, n, info* (int[4])
    "edge_info": (_I, _I, _I, _P),
    # k, c, t, o -> floats of the forward's scratch (long long)
    "spider_fwd_scratch": (_I, _I, _I, _I),
    # feat, idx, g, w, b, n, k, c, t, o, scratch, out, stream
    "spider_fwd_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    # b, n, k, c, t, o -> floats of the data backward's scratch (long long)
    "spider_bwd_data_scratch": (_I, _I, _I, _I, _I, _I),
    # feat, idx, g, w, dout, b, n, k, c, t, o, scratch, dgath, dg, stream
    "spider_bwd_data_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    # rows, k, c, t, o -> the weight backward's number of row slices
    "spider_bwd_weight_slices": (_I, _I, _I, _I, _I),
    # feat, idx, g, dout, b, n, k, c, t, o, slices, part, dw, stream
    "spider_bwd_weight_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    # z32, gamma, beta, mean, r, rows, k, c, bf16, vec, lanes, teams, pooled,
    # kmax, cnt, stream
    "poolkey_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    # bf16, vec, threads, columns (the column route's build), info* (int[4])
    "poolkey_info": (_I, _I, _I, _I, _P),
    # z1, d_pooled, groups, k, bf16, pool_f32, n_layers, widths*, ptrs*, plan*,
    # plan_len, pooled, share, table, partial, partial_floats, dz1, pass_begin, pass_end, stream
    "satrain_bwd_launch": (_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P, _P, _P, _P, _I, _P, _I, _I, _P),
    # rows, n_layers, widths*, dw_floats, consts_smem, walk, info* (int[4])
    "satrain_info": (_I, _I, _P, _I, _I, _I, _P),
}

# Entry points that return something other than a cudaError_t (int).
_RESTYPES = {"spider_fwd_scratch": ctypes.c_longlong, "spider_bwd_data_scratch": ctypes.c_longlong}

_lib = None
build_seconds: float | None = None  # wall time of the nvcc run, if one ran


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library() -> ctypes.CDLL:
    """The loaded kernel library, compiled on first call."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(f.read())
    lib_path = os.path.join(BUILD_DIR, f"libscanobjectnn_{digest.hexdigest()[:16]}.so")
    if not os.path.exists(lib_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        nvcc = _nvcc()
        objects = [f"{tmp}.{os.path.basename(src)}.o" for src in sources]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(sources, objects)
        ]
        logs = [proc.communicate()[0] for proc in procs]
        failed = [f"{src}:\n{log}" for src, proc, log in zip(sources, procs, logs) if proc.returncode]
        if not failed:
            link = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objects], capture_output=True, text=True,
            )
            if link.returncode:
                failed.append(f"link:\n{link.stdout}\n{link.stderr}")
        for obj in objects:
            if os.path.exists(obj):
                os.remove(obj)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        os.replace(tmp, lib_path)  # atomic: a concurrent build never loads half a file
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(lib_path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    lib.kernel_error_string.argtypes = (_I,)
    lib.kernel_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        msg = library().kernel_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: cudaError_t {err} ({msg})")
