"""Exact-key max-pool forward: the CUDA kernel (``csrc/poolkey.cu``) beside
its plain PyTorch version.

Replaces ``scanobjectnn_tpu/ops/pallas/poolkey_kernel.py``:
``bn_relu_exactkey_pool`` (``pl.pallas_call``), the forward of the final SA
layer in bf16 training under exact-key pooling (``ops/exactpool.py``
``dense_bn_exactkey_pool``).

``bn_relu_exactkey_pool(z32 [..., K, C] f32, gamma, beta, mean, r [C] f32,
cdtype) -> (pooled [..., C] cdtype, kmax [..., C] f32, cnt [..., C] f32)``:
with ``cd`` the rounding to ``cdtype``, for every slot of the K axis

    y   = relu(cd(((cd(z32) - mean) * r) * gamma + beta))   (the value chain)
    key = relu(((z32 - mean) * r) * gamma + beta)            (f32, unrounded)

``kmax`` is the largest key of the column, ``cnt`` the number of slots
whose key equals it, and ``pooled`` the largest ``y`` among those slots.
``r = rsqrt(var + 1e-3)`` comes in as a [C] tensor that the caller computes
once, so the kernel and the plain version read the same bits: the kernel
keeps the op order above in round-to-nearest intrinsics (no FMA
contraction) and rounds to bf16 as ``Tensor.to`` does, so the two agree bit
for bit.  Any K and C.  No gradient: the op's backward recomputes its own
winners (``exactpool``).

What bounds it on the H100: bytes (z32 read once, [.., C] written).  The
kernel splits the K axis, which changes no bit: partials (best key, slots
at it, largest value among them, a NaN seen) over adjacent runs of slots
merge, the earlier first, into the serial walk's outputs
(``csrc/poolkey.cu``).  ``plan`` lays a call out: ``vec`` channels a
thread (16-byte loads where C % 4 == 0 and z32 sits on a 16-byte boundary,
else one channel); with one team the column route (a thread walks all K
slots of its flattened columns, ``lanes`` threads a block), else the split
route: ``lanes`` lanes a team reading one slot's channel tile, ``teams``
teams a block taking contiguous runs of the slots (``runs``), a block a
(row, channel tile).  The C entry point refuses a plan it cannot run.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from scanobjectnn_torch.ops.cuda import _build, takes_plain
from scanobjectnn_torch.ops.cuda.satrain_kernel import sm_count

__all__ = ["Plan", "bn_relu_exactkey_pool", "bn_relu_exactkey_pool_plain", "kernel_info", "plan", "runs"]

WARP = 32  # kWarp in csrc/poolkey.cu
MAX_THREADS = 256  # kMaxThreads
AHEAD = 4  # kAhead: the slots a thread loads before it uses them
COLUMN_MAX_K = 32  # the column route takes K up to this ...
COLUMNS_PER_SM = 256  # ... where rows x c / vec give every SM this many threads
COLUMN_THREADS = 64  # the column route's threads a block
MIN_LANES = 8  # the split route's narrowest team (128 contiguous bytes a slot at vec 4)
BLOCKS_PER_SM = 4  # the split route narrows its tile while rows x tiles give an SM fewer blocks
SPLIT_THREADS = 128  # the split route's threads a block ...
RUN = 32  # ... doubled (to MAX_THREADS) while a team would take more slots than this
H100_SMS = 132


class Plan(NamedTuple):
    """The launch of one call (module doc)."""

    vec: int
    lanes: int
    teams: int


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@functools.lru_cache(maxsize=256)
def plan(rows: int, k: int, c: int, sms: int = H100_SMS, aligned: bool = True) -> Plan:
    """The launch of a call on z32 [rows, k, c] on a card of ``sms`` SMs
    (``aligned``: z32 on a 16-byte boundary).

    ``vec`` 4 where c % 4 == 0 and aligned, else 1.  The column route (one
    team, ``COLUMN_THREADS`` threads a block) where K is short
    (``COLUMN_MAX_K``) and rows x c / vec threads give every SM
    ``COLUMNS_PER_SM``.  Else the split route: lanes enough for the row's c
    / vec words, to 32, halved down to ``MIN_LANES`` while rows x tiles give
    an SM fewer than ``BLOCKS_PER_SM`` blocks; ``SPLIT_THREADS`` threads a
    block, doubled to ``MAX_THREADS`` while a team would take more than
    ``RUN`` slots, then halved (to a warp) while a team would take fewer
    than ``AHEAD`` slots.  (The choices are ``studies/pool_key.py
    --sweep``'s readings on an H100.)  Cached: the wrapper plans every
    call."""
    if min(rows, k, c) < 1:
        raise ValueError(f"poolkey plan: empty input rows={rows}, k={k}, c={c}")
    vec = 4 if aligned and c % 4 == 0 else 1
    words = _ceil(c, vec)
    if k <= COLUMN_MAX_K and rows * words >= COLUMNS_PER_SM * sms:
        return Plan(vec, COLUMN_THREADS, 1)
    lanes = min(WARP, _pow2(words))
    while lanes > MIN_LANES and rows * _ceil(words, lanes) < BLOCKS_PER_SM * sms:
        lanes //= 2
    teams = max(1, SPLIT_THREADS // lanes)
    while teams * lanes < MAX_THREADS and k > teams * RUN:
        teams *= 2
    while teams > max(1, WARP // lanes) and teams * AHEAD > k:  # no idle teams where K is short
        teams //= 2
    return Plan(vec, lanes, teams)


def runs(k: int, teams: int) -> list[tuple[int, int]]:
    """The slots [j0, j1) of each team, in slot order (the kernel's ``j0``
    and ``j1``): a team ceil(k / teams) slots; a run may be empty."""
    per_team = _ceil(k, teams)
    return [(min(k, t * per_team), min(k, (t + 1) * per_team)) for t in range(teams)]


def kernel_info(rows: int, k: int, c: int, cdtype: torch.dtype = torch.bfloat16) -> dict:
    """The build a call takes at ``plan(rows, k, c)``: registers and
    local-memory bytes a thread, resident blocks per SM at its threads, and
    the plan (on the card)."""
    import ctypes

    p = plan(rows, k, c)
    info = (ctypes.c_int * 4)()
    columns = int(p.teams == 1)
    _build.check(_build.library().poolkey_info(int(cdtype == torch.bfloat16), p.vec, p.lanes * p.teams, columns,
                                               ctypes.addressof(info)), "bn_relu_exactkey_pool kernel_info")
    return {"registers": info[0], "local_bytes": info[1], "blocks_per_sm": info[3], **p._asdict()}


def bn_relu_exactkey_pool_plain(
    z32: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, mean: torch.Tensor, r: torch.Tensor,
    cdtype: torch.dtype,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version (module doc)."""
    zbf = z32.to(cdtype).float()
    y = torch.relu((((zbf - mean) * r) * gamma + beta).to(cdtype))
    key = torch.relu(((z32 - mean) * r) * gamma + beta)
    kmax = key.amax(-2)
    eq = key == kmax.unsqueeze(-2)
    cnt = eq.sum(-2, dtype=torch.float32)
    pooled = torch.where(eq, y, float("-inf")).amax(-2)
    return pooled, kmax, cnt


def _check(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != shape:
        raise ValueError(
            f"bn_relu_exactkey_pool: {name} must be float32 {shape} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"bn_relu_exactkey_pool: {name} must be contiguous")


def bn_relu_exactkey_pool(
    z32: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, mean: torch.Tensor, r: torch.Tensor,
    cdtype: torch.dtype = torch.bfloat16,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training BN from given statistics, relu and the exact-key max over
    axis -2 (module doc).  A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel (counted in
    ``bn_relu_exactkey_pool.launches``) or raises."""
    if takes_plain(z32):
        return bn_relu_exactkey_pool_plain(z32, gamma, beta, mean, r, cdtype)
    if z32.device.type != "cuda":
        raise ValueError(f"bn_relu_exactkey_pool: unsupported device {z32.device}")
    if z32.dim() < 2 or cdtype not in (torch.bfloat16, torch.float32):
        raise ValueError(
            f"bn_relu_exactkey_pool: need z32 [..., K, C] and a bf16 or f32 compute dtype, "
            f"got {tuple(z32.shape)}, {cdtype}"
        )
    *lead, k, c = z32.shape
    rows = 1
    for d in lead:
        rows *= d
    dev = z32.device
    _check("z32", z32, tuple(z32.shape), dev)
    for name, t in (("gamma", gamma), ("beta", beta), ("mean", mean), ("r", r)):
        _check(name, t, (c,), dev)
    if min(rows, k, c) < 1:
        raise ValueError(f"bn_relu_exactkey_pool: empty input {tuple(z32.shape)}")
    pooled = torch.empty(*lead, c, dtype=cdtype, device=dev)
    kmax = torch.empty(*lead, c, dtype=torch.float32, device=dev)
    cnt = torch.empty(*lead, c, dtype=torch.float32, device=dev)
    p = plan(rows, k, c, sm_count(dev), aligned=z32.data_ptr() % 16 == 0)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.poolkey_launch(
            z32.data_ptr(), gamma.data_ptr(), beta.data_ptr(), mean.data_ptr(), r.data_ptr(), rows, k, c,
            int(cdtype == torch.bfloat16), *p, pooled.data_ptr(), kmax.data_ptr(), cnt.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "bn_relu_exactkey_pool")
    bn_relu_exactkey_pool.launches += 1
    return pooled, kmax, cnt


bn_relu_exactkey_pool.launches = 0
