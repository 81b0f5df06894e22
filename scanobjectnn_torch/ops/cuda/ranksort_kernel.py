"""Stable rank sort of point clouds by a scalar key: the CUDA kernel
(``csrc/ranksort.cu``) beside its plain PyTorch version.

Replaces ``scanobjectnn_tpu/ops/pallas/ranksort_kernel.py``:
``rank_sort_points`` (``pl.pallas_call``), the prep of the spatially
bucketed SA layer (``sabucket_kernel.py``), which sorts a layer's points and
its queries along each cloud's widest axis.

``rank_sort_points(key [B, N] f32, xyz [B, N, 3] f32, feats [B, N, C] or
None) -> (xyz_s [B, N, 3] f32, ids [B, N] int32, rank [B, N] int32, feats_s
[B, N, C] or None)``:

  * the order is the stable one, JAX's comparison rank
    ``rank(i) = #{j : key_j < key_i or (key_j == key_i and j < i)}``, so
    -0.0 and +0.0 compare equal and tie by index;
  * a NaN key sorts after every number (ties among NaNs by index), as in
    ``torch.argsort``.  JAX's rule gives a NaN key rank 0, which collides
    with the smallest key's, so its rank is no permutation there; this one
    always is;
  * ``xyz_s[b, r] = xyz[b, ids[b, r]]`` bit for bit, ``rank`` is the
    inverse permutation (``ids[b, rank[b, i]] == i``), and ``feats_s`` the
    feature rows, any dtype, carried by the same permutation.

The TPU kernel's bf16 Dekker planes, its two-term id split, its one-hot MXU
scatter and its ``[B, 8, N]`` sublane padding are TPU mechanisms: the card
moves f32 and ints exactly with plain loads.

What bounds it on the H100: bytes.  One block a cloud sorts (key bits,
index) words with a bitonic network (N <= ``MAX_N``): each thread holds
``per_thread`` words in registers, strides below 32 x that many pair lanes
of a warp by shuffles, and only the larger strides go through shared
memory (``shared_steps``).  ``sort_plan`` picks the threads and the words a
thread from N; the C entry point refuses a plan it cannot run.  The
network's shuffles and compare-and-selects, not the bytes, set its time.
"""

from __future__ import annotations

import torch

from scanobjectnn_torch.ops.cuda import _build, takes_plain
from scanobjectnn_torch.ops.cuda.gather_kernel import _check_cuda

__all__ = [
    "kernel_info", "rank_sort_points", "rank_sort_points_plain", "shared_steps", "sort_order_key",
    "sort_plan", "sort_words",
]

MAX_N = 16384  # kMaxN in csrc/ranksort.cu
MAX_THREADS = 1024  # kMaxThreads
WARP = 32  # kWarp
PER_THREAD = (1, 2, 4, 8, 16)  # the words a thread the kernel is built for
TARGET_PER_THREAD = 8  # the plan's words a thread from LARGE_WORDS on, where the threads allow it
SMALL_PER_THREAD = 4  # below LARGE_WORDS: more warps a block (M=512 on an H100: 4.4 µs against 5.3 at 8)
LARGE_WORDS = 2048


def sort_words(n: int, per_thread: int) -> int:
    """The width a cloud of ``n`` keys is padded to: the least power of two
    that holds ``n`` words and gives a block whole warps of ``per_thread``
    words a thread (``plan_words`` in the C source)."""
    p = WARP * per_thread
    while p < n:
        p *= 2
    return p


def sort_plan(n: int) -> tuple[int, int]:
    """(threads a block, words a thread) of a sort of ``n`` keys:
    ``TARGET_PER_THREAD`` words a thread from ``LARGE_WORDS`` padded words
    on, ``SMALL_PER_THREAD`` below, fewer where a warp would hold more than
    the padded cloud, more where the block would pass ``MAX_THREADS``."""
    if not 1 <= n <= MAX_N:
        raise ValueError(f"sort_plan: n must be in [1, {MAX_N}], got {n}")
    per = TARGET_PER_THREAD if sort_words(n, TARGET_PER_THREAD) >= LARGE_WORDS else SMALL_PER_THREAD
    while per > 1 and sort_words(n, per // 2) < WARP * per:  # a warp's share past the cloud: halve
        per //= 2
    while sort_words(n, per) // per > MAX_THREADS:
        per *= 2
    return sort_words(n, per) // per, per


def shared_steps(threads: int) -> int:
    """The network's steps that go through shared memory at a block of
    ``threads`` (a stride of a warp's words or more), each followed by a
    barrier."""
    levels = (threads // WARP).bit_length() - 1  # log2(P / (32 E)) = log2(threads / 32)
    return levels * (levels + 1) // 2


def kernel_info(n: int) -> dict:
    """The build a sort of ``n`` keys takes at ``sort_plan(n)``: registers and
    local-memory bytes a thread, dynamic shared bytes a block, resident
    blocks per SM, from ``cudaFuncGetAttributes`` and the occupancy API (on
    the card)."""
    import ctypes

    threads, per = sort_plan(n)
    info = (ctypes.c_int * 4)()
    _build.check(_build.library().ranksort_info(n, threads, per, ctypes.addressof(info)), "rank_sort kernel_info")
    return {**dict(zip(("registers", "local_bytes", "smem_bytes", "blocks_per_sm"), info)), "threads": threads,
            "per_thread": per}


def sort_order_key(key: torch.Tensor) -> torch.Tensor:
    """int64 keys whose order is the sort's (module doc): the f32 value's
    order, -0.0 equal to +0.0, a NaN after +inf."""
    bits = key.float().contiguous().view(torch.int32).long()
    ordered = torch.where(bits < 0, -(bits + 2**31), bits)  # -0.0 (bits -2^31) maps to 0, as +0.0
    return torch.where(torch.isnan(key), 2**31, ordered)


def rank_sort_points_plain(
    key: torch.Tensor, xyz: torch.Tensor, feats: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """Plain PyTorch version (module doc): a stable argsort and gathers."""
    order = torch.argsort(sort_order_key(key), dim=1, stable=True)
    rank = torch.empty_like(order).scatter_(1, order, torch.arange(key.shape[1], device=key.device).expand_as(order))
    xyz_s = torch.gather(xyz, 1, order[..., None].expand(-1, -1, 3))
    feats_s = None if feats is None else torch.gather(feats, 1, order[..., None].expand(-1, -1, feats.shape[-1]))
    return xyz_s, order.to(torch.int32), rank.to(torch.int32), feats_s


def rank_sort_points(
    key: torch.Tensor, xyz: torch.Tensor, feats: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """Stable sort of each cloud by ``key`` (module doc).

    A CPU tensor takes ``rank_sort_points_plain``; a CUDA tensor launches the
    kernel (counted in ``rank_sort_points.launches``) or raises."""
    if takes_plain(key):
        return rank_sort_points_plain(key, xyz, feats)
    fn = "rank_sort_points"
    if key.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {key.device}")
    if key.dim() != 2 or not 1 <= key.shape[1] <= MAX_N:
        raise ValueError(f"{fn}: key must be [B, N] with 1 <= N <= {MAX_N}, got {tuple(key.shape)}")
    dev = key.device
    b, n = key.shape
    _check_cuda(fn, "key", key, torch.float32, (b, n), dev)
    _check_cuda(fn, "xyz", xyz, torch.float32, (b, n, 3), dev)
    units = 0
    if feats is not None:
        if feats.dim() != 3 or feats.element_size() not in (2, 4):
            raise ValueError(f"{fn}: feats must be [B, N, C] of 2- or 4-byte elements, got {feats.dtype}")
        _check_cuda(fn, "feats", feats, feats.dtype, (b, n, feats.shape[-1]), dev)
        units = feats.shape[-1] * feats.element_size() // 2
    xyz_s = torch.empty_like(xyz)
    ids = torch.empty(b, n, dtype=torch.int32, device=dev)
    rank = torch.empty(b, n, dtype=torch.int32, device=dev)
    feats_s = None if feats is None else torch.empty_like(feats)
    threads, per = sort_plan(n)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.ranksort_launch(
            key.data_ptr(), xyz.data_ptr(), None if feats is None else feats.data_ptr(), b, n, units, threads, per,
            xyz_s.data_ptr(), ids.data_ptr(), rank.data_ptr(), None if feats_s is None else feats_s.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, fn)
    rank_sort_points.launches += 1
    return xyz_s, ids, rank, feats_s


rank_sort_points.launches = 0
