"""The launch plans of the general kNN (#13) and the EdgeConv forward (#14)
on the CPU: the plain functions the wrappers call to pick a route, the group
lanes a query, the selection's shared memory and the forward's lanes a
query.
Their constants are held to ``csrc/knn.cu``'s, so a plan never hands the
kernels what they would refuse."""

from __future__ import annotations

import os
import re

import pytest

from scanobjectnn_torch.ops.cuda import edge_kernel, knn_kernel
from scanobjectnn_torch.ops.cuda.knn_kernel import (
    GROUP_MAX_K,
    MAX_K,
    SMEM_MAX,
    SORT_TILE,
    group_lanes,
    point_plan,
    select_smem_bytes,
    warp_tile,
)

H100_SMS = 132
CSRC = os.path.join(os.path.dirname(knn_kernel.__file__), os.pardir, os.pardir, "csrc")


def _rows() -> int:
    with open(os.path.join(CSRC, "knn.cu")) as f:
        return int(re.search(r"constexpr int kWarpRows = (\d+);", f.read()).group(1))


def _constant(name: str, source: str = "knn.cu") -> int:
    with open(os.path.join(CSRC, source)) as f:
        text = f.read()
    m = re.search(rf"constexpr (?:int|size_t) {name} = ([^;]+);", text)
    assert m, name
    return int(eval(m.group(1).split("//")[0], {"kSortThreads": 256, "kWarpRows": _rows(), "kWarpThreads": 256}))


@pytest.mark.parametrize("py,c_name", [
    (MAX_K, "kMaxK"), (GROUP_MAX_K, "kGroupMaxK"), (SORT_TILE, "kSortTile"), (SMEM_MAX, "kSmemMax"), (knn_kernel.SMEM_FLOATS, "kSmemFloats"),
    (knn_kernel.WARP_QT, "kWarpQT"), (knn_kernel.RADIX_BINS, "kRadixBins"),
    (knn_kernel.SELECT_AUX_INTS, "kSelectAux"), (knn_kernel.GRAPH_MAX_K, "kGraphMaxK"),
])
def test_constants_mirror_the_kernel_source(py, c_name):
    assert py == _constant(c_name)


# (B, M, N, C, k) -> (route, lanes) at the main paths' calls on an H100:
# BGA's three_nn (fp3, fp2, fp1), PointCNN seg's six kNN calls with the
# duplicate bias, DGCNN's graph at k = 40 (C = 3 and 64), SAModule's two
# k = 128 calls, the kNN at N = 50000, k = 128, and k = 20000 there.
MAIN_PATH = {
    "bga_fp3": ((32, 1024, 512, 3, 3), ("group", 1)),
    "bga_fp2": ((32, 512, 128, 3, 3), ("group", 2)),
    "bga_fp1": ((32, 128, 1, 3, 3), ("group", 1)),
    "partseg_fp3_b8": ((8, 1024, 512, 3, 3), ("group", 4)),
    "pointcnn_k8": ((32, 1024, 1024, 3, 8), ("group", 1)),
    "pointcnn_k24": ((32, 384, 1024, 3, 24), ("warp", 1)),
    "pointcnn_k32": ((32, 128, 384, 3, 32), ("warp", 1)),
    "pointcnn_k48": ((32, 1024, 384, 3, 48), ("warp", 1)),
    "dgcnn_graph_k40_c3": ((32, 1024, 1024, 3, 40), ("warp", 1)),
    "dgcnn_graph_k40_c64": ((32, 1024, 1024, 64, 40), ("warp", 1)),
    "sa1_knn_k128": ((32, 512, 1024, 3, 128), ("select", 1)),
    "sa2_knn_k128": ((32, 128, 512, 3, 128), ("select", 1)),
    "n50000_k128": ((1, 1024, 50000, 3, 128), ("select", 1)),
    "n50000_k20000": ((1, 3, 50000, 3, 20000), ("sort", 1)),
}


@pytest.mark.parametrize("case", sorted(MAIN_PATH))
def test_plan_at_the_main_paths_calls(case):
    args, want = MAIN_PATH[case]
    assert point_plan(*args, H100_SMS) == want


@pytest.mark.parametrize("queries,n,want", [
    (32 * 1024, 512, 1), (32 * 512, 128, 2), (4096, 1, 1), (4096, 2, 2), (4096, 5, 4), (1, 1000, 32),
    (10**6, 1000, 1), (25344, 64, 1), (25343, 64, 2), (8 * 1024, 512, 4),
])
def test_group_lanes_fill_the_card(queries, n, want):
    # The least power of two with queries * lanes >= 192 threads an SM, at
    # most 32 and at most N.
    g = group_lanes(queries, n, H100_SMS)
    assert g == want and g & (g - 1) == 0 and 1 <= g <= 32


def test_group_lanes_follow_the_sm_count():
    assert group_lanes(16 * 1024, 512, 66) == 1 and group_lanes(16 * 1024, 512, 264) == 4


@pytest.mark.parametrize("k,route", [(1, "group"), (GROUP_MAX_K, "group"), (GROUP_MAX_K + 1, "warp"),
                                     (MAX_K, "warp"), (MAX_K + 1, "select")])
def test_plan_boundaries_in_k(k, route):
    assert point_plan(4, 100, 2000, 3, k, H100_SMS)[0] == route


@pytest.mark.parametrize("n", [SORT_TILE - 1, SORT_TILE, SORT_TILE + 1, 50000])
def test_select_bytes_at_the_tile_boundary(n):
    # Up to SORT_TILE keys a block holds all N words, above it a tile's.
    words = min(n, SORT_TILE)
    assert select_smem_bytes(n, 128) == 8 * (words + 128) + 4 * 256 + 4 * 12
    assert point_plan(1, 4, n, 3, 128, H100_SMS) == ("select", 1)


@pytest.mark.parametrize("n,k,route", [
    (SORT_TILE, 8192, "select"),  # 128 KB of words and 64 KB selected
    (SORT_TILE, 8193, "sort"),  # the selected words padded to 16384: 256 KB
    (SORT_TILE + 1, 8193, "sort"),
    (20000, 16384, "sort"),
    (12000, 4096, "select"),
    (8192, 8192, "select"),
    (14000, 14000, "sort"),
])
def test_plan_where_the_selected_words_do_not_fit(n, k, route):
    assert (select_smem_bytes(n, k) <= SMEM_MAX) == (route == "select")
    assert point_plan(1, 4, n, 3, k, H100_SMS) == (route, 1)


@pytest.mark.parametrize("n,c,want", [(1024, 3, 1024), (1, 3, 32), (50000, 3, 2208), (1024, 64, 128),
                                      (300, 7, 320), (5000, 223, 32), (5000, 224, 0)])
def test_warp_tile(n, c, want):
    assert warp_tile(n, c) == want


def test_a_width_without_a_warp_tile_takes_the_selection():
    assert point_plan(2, 64, 500, 223, 40, H100_SMS)[0] == "warp"
    assert point_plan(2, 64, 500, 224, 40, H100_SMS) == ("select", 1)
    assert point_plan(2, 64, 500, 224, 16, H100_SMS) == ("group", group_lanes(128, 500, H100_SMS))


@pytest.mark.parametrize("cv,want", [(64, 16), (128, 32), (1, 16), (24, 16), (65, 32), (256, 32)])
def test_edge_forward_lanes(cv, want):
    # DGCNN's EdgeConv 1-3 (Cv = 64): two queries a warp, 16 lanes of 4
    # floats; EdgeConv 4 (Cv = 128): a warp a query.
    assert edge_kernel.fwd_lanes(cv) == want and want in edge_kernel.FWD_LANES
