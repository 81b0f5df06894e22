"""The launch plan of the ball query (#8/#9, ``csrc/ballgroup.cu``) and the
bound of the fused graph and gather (#15, ``csrc/knn.cu``) on the CPU: the
plain functions and constants the wrappers use, held to the C sources'
constants and checks, so a plan never hands the kernels what they would
refuse."""

from __future__ import annotations

import os
import re

import pytest
import torch

from scanobjectnn_torch.ops.cuda import ballgroup_kernel, edge_kernel, knn_kernel
from scanobjectnn_torch.ops.cuda.ballgroup_kernel import (
    MAX_NSAMPLE,
    MAX_TILE,
    MAX_WARPS,
    PAIR_MIN_QUERIES,
    PER_WARP,
    UNROLLS,
    ball_plan,
    smem_bytes,
)

CSRC = os.path.join(os.path.dirname(ballgroup_kernel.__file__), os.pardir, os.pardir, "csrc")


def _source(name: str) -> str:
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _constant(name: str, source: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", _source(source))
    assert m, name
    return int(m.group(1))


def _accepted(var: str) -> tuple[int, ...]:
    """The values ``plan_ok`` in ballgroup.cu accepts for ``var``."""
    body = re.search(r"bool plan_ok\(.*?\n}", _source("ballgroup.cu"), re.S).group(0)
    line = re.search(rf"const bool {var}_ok = ([^;]+);", body).group(1)
    return tuple(int(v) for v in re.findall(rf"{var} == (\d+)", line))


def _plan_ok(queries: int, per_warp: int, unroll: int, tile: int) -> bool:
    """``plan_ok`` of ballgroup.cu, in Python."""
    return (per_warp in _accepted("per_warp") and unroll in _accepted("unroll") and queries >= 1
            and queries % per_warp == 0 and queries // per_warp <= _constant("kMaxWarps", "ballgroup.cu")
            and 1 <= tile <= _constant("kMaxTile", "ballgroup.cu"))


@pytest.mark.parametrize("py,c_name,source", [
    (MAX_NSAMPLE, "kMaxK", "ballgroup.cu"), (MAX_TILE, "kMaxTile", "ballgroup.cu"),
    (MAX_WARPS, "kMaxWarps", "ballgroup.cu"), (edge_kernel.FUSED_MAX_K, "kGraphMaxK", "knn.cu"),
])
def test_constants_mirror_the_kernel_sources(py, c_name, source):
    assert py == _constant(c_name, source)


def test_queries_a_warp_and_unrolls_mirror_the_kernel_checks():
    assert PER_WARP == _accepted("per_warp") and UNROLLS == _accepted("unroll")
    assert set(ballgroup_kernel.PLAN_UNROLL) == set(PER_WARP)
    assert set(ballgroup_kernel.PLAN_UNROLL.values()) <= set(UNROLLS)
    # The block's threads are the kernel's launch bound.
    assert re.search(r"__launch_bounds__\(kMaxWarps \* 32\)", _source("ballgroup.cu"))


def test_the_fused_bound_is_the_graph_kernels():
    assert edge_kernel.FUSED_MAX_K == knn_kernel.GRAPH_MAX_K == 32
    # The C entry copies rows of 4-byte (f32) or 2-byte (bf16) elements.
    assert re.search(r"esize != 2 && esize != 4", _source("knn.cu"))
    assert sorted(torch.empty(0, dtype=d).element_size() for d in edge_kernel.FUSED_DTYPES) == [2, 4]


# (B, N, M) -> (queries a block, queries a warp, unroll, tile) at the main
# paths' calls: the SSG step's SA1 (two queries a warp) and SA2 (one: 2048
# queries), phase 10c's two calls (B=32, N=1024, M=512), N = 40000 (tiles)
# and one query (one warp).
MAIN_PATH = {
    "ssg_sa1": ((16, 1024, 512), (16, 2, 4, 1024)),
    "ssg_sa2": ((16, 512, 128), (8, 1, 8, 512)),
    "query_b32": ((32, 1024, 512), (16, 2, 4, 1024)),
    "n40000": ((2, 40000, 128), (8, 1, 8, 3072)),
    "m1": ((3, 1024, 1), (1, 1, 8, 1024)),
}


@pytest.mark.parametrize("case", sorted(MAIN_PATH))
def test_plan_at_the_main_paths_calls(case):
    (b, n, m), want = MAIN_PATH[case]
    assert ball_plan(b, n, m) == want


@pytest.mark.parametrize("b", [1, 2, 16, 32, 128, 65535])
@pytest.mark.parametrize("n", [1, 31, 1024, 3072, 3073, 40000])
@pytest.mark.parametrize("m", [1, 7, 128, 512, 4096])
def test_every_plan_is_one_the_kernel_runs(b, n, m):
    queries, per_warp, unroll, tile = plan = ball_plan(b, n, m)
    assert _plan_ok(*plan), plan
    assert tile == min(n, MAX_TILE)
    assert per_warp == (2 if b * m >= PAIR_MIN_QUERIES else 1)
    assert unroll == ballgroup_kernel.PLAN_UNROLL[per_warp]
    assert queries == min(MAX_WARPS * per_warp, -(-m // per_warp) * per_warp)


@pytest.mark.parametrize("n", [1, 1000, 3072, 40000])
@pytest.mark.parametrize("unroll", UNROLLS)
def test_shared_bytes_at_k1024(n, unroll):
    """No rows buffer: a block's shared memory is its tile's coordinates,
    padded to whole steps, whatever K, within the 48 KB a launch takes
    without opting in."""
    tile = ball_plan(2, n, 64)[3]
    step = 32 * unroll
    assert smem_bytes(tile, unroll) == 16 * (-(-min(n, MAX_TILE) // step) * step) <= 48 * 1024
    text = _source("ballgroup.cu")
    assert "sizeof(float4) * static_cast<size_t>(padded(tile, unroll))" in text
    assert "(count + 32 * unroll - 1) / (32 * unroll) * (32 * unroll)" in text
