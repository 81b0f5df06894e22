"""Build and load the package's CUDA kernels.

On first use, ``library()`` compiles every ``scanobjectnn_torch/csrc/*.cu``
with nvcc for Hopper (``sm_90a``) into one shared library with a plain C
interface under ``scanobjectnn_torch/_build/`` and loads it with ``ctypes``.
The file name carries a hash of the sources and flags, so an edited source
never loads a stale library.  Nothing is built or loaded at import time.

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
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points and their argument types (see csrc/*.cu).
_SIGNATURES = {
    # xyz, b, n, m, idx, new_xyz (nullable), stream
    "fps_launch": (_P, _I, _I, _I, _P, _P, _P),
    # xyz, new_xyz, src, b, n, m, cs, k, r2, w0x, w0f, prelifted, bf16,
    # n_layers, widths*, weights*, biases*, pooled, idx, stream
    "safused_launch": (
        _P, _P, _P, _I, _I, _I, _I, _I, _F, _P, _P, _I, _I,
        _I, _P, _P, _P, _P, _P, _P,
    ),
}

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
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib_path)  # atomic: a concurrent build never loads half a file
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(lib_path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = (_I,)
    lib.kernel_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        msg = library().kernel_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: cudaError_t {err} ({msg})")
