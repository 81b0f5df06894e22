"""Farthest point sampling: the CUDA kernel (``csrc/fps.cu``) and its plain
PyTorch version.

Replaces ``scanobjectnn_tpu/ops/pallas/fps_kernel.py``: ``fps_pallas`` and
``fps_pallas_with_coords`` (kernel body ``_fps_kernel``).  One CUDA kernel
with a ``with_coords`` flag serves both entry points.

Semantics (kept exactly, ties included):
  * the first index is 0; ``min_dist`` starts at 1e38;
  * each step ``d = ((x-x0)² + (y-y0)²) + (z-z0)²`` with no fused
    multiply-add, ``min_dist = minimum(min_dist, d)`` (NaN-propagating);
  * the next index is the argmax, ties to the LOWEST index;
  * the coordinates are copies of ``xyz[idx]`` (bit-identical to
    ``gather_point``).
NaN rows: as in the TPU kernel's two-reduce argmax, once any ``min_dist``
of a cloud is NaN the row maximum is NaN, no point equals it, and the step
returns index ``N`` (out of range) with coordinates (0, 0, 0); every later
step of that cloud does the same.  Kernel and plain version agree on this.

What bounds it on the H100: latency, not bytes.  The ``npoint - 1`` steps
are strictly serial (511 at SA1, 127 at SA2) and each one is a block-wide
argmax.  The kernel runs one block per cloud (B=128 blocks on 132 SMs),
keeps each thread's points and their ``min_dist`` in registers and the
cloud's coordinates in shared memory, and pays one ``__syncthreads`` per
step: warp-shuffle argmax, one double-buffered shared-memory exchange of
the per-warp winners, then every warp reduces those redundantly.
"""

from __future__ import annotations

import torch

from scanobjectnn_torch.ops.cuda import _build

__all__ = ["fps", "fps_plain"]

MAX_POINTS = 8 * 1024  # 8 points per thread at 1024 threads


def fps_plain(xyz: torch.Tensor, npoint: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch FPS: [B, N, 3] -> (idx int32 [B, npoint], new_xyz f32
    [B, npoint, 3]).  Same rule as the kernel (module doc)."""
    if npoint < 1:
        raise ValueError("npoint must be >= 1")
    b, n, _ = xyz.shape
    x = xyz.float()
    # Row N of the padded cloud is (0, 0, 0): what a NaN step "selects".
    padded = torch.cat([x, x.new_zeros(b, 1, 3)], dim=1)
    col = torch.arange(n, device=x.device)
    rows = torch.arange(b, device=x.device)
    min_dist = x.new_full((b, n), 1e38)
    idx = torch.zeros(b, npoint, dtype=torch.int64, device=x.device)
    last = padded[:, 0]
    for j in range(1, npoint):
        diff = x - last[:, None, :]
        sq = diff * diff
        d = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
        min_dist = torch.minimum(min_dist, d)
        m = torch.amax(min_dist, dim=1, keepdim=True)  # NaN if any is NaN
        best = torch.where(min_dist == m, col, n).amin(dim=1)
        idx[:, j] = best
        last = padded[rows, best]
    new_xyz = padded[rows[:, None], idx]
    return idx.to(torch.int32), new_xyz


def fps(xyz: torch.Tensor, npoint: int, with_coords: bool = True):
    """FPS: [B, N, 3] f32 -> idx int32 [B, npoint], and with ``with_coords``
    also new_xyz f32 [B, npoint, 3].

    A CPU tensor takes ``fps_plain``; a CUDA tensor launches the kernel
    (counted in ``fps.launches``) or raises."""
    if xyz.device.type == "cpu":
        idx, new_xyz = fps_plain(xyz, npoint)
        return (idx, new_xyz) if with_coords else idx
    if xyz.device.type != "cuda":
        raise ValueError(f"fps: unsupported device {xyz.device}")
    if xyz.dtype != torch.float32 or xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"fps: need f32 [B, N, 3], got {xyz.dtype} {tuple(xyz.shape)}")
    if not xyz.is_contiguous():
        raise ValueError("fps: xyz must be contiguous")
    b, n, _ = xyz.shape
    if npoint < 1 or not 1 <= n <= MAX_POINTS:
        raise ValueError(f"fps: need npoint >= 1 and 1 <= N <= {MAX_POINTS}; got {npoint}, {n}")
    idx = torch.empty(b, npoint, dtype=torch.int32, device=xyz.device)
    new_xyz = (
        torch.empty(b, npoint, 3, dtype=torch.float32, device=xyz.device)
        if with_coords else None
    )
    lib = _build.library()
    with torch.cuda.device(xyz.device):
        err = lib.fps_launch(
            xyz.data_ptr(), b, n, npoint, idx.data_ptr(),
            new_xyz.data_ptr() if with_coords else None,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "fps")
    fps.launches += 1
    return (idx, new_xyz) if with_coords else idx


fps.launches = 0
