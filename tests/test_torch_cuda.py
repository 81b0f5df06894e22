"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Marked ``cuda``: every test skips where no CUDA device is present.
This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

FPS indices and coordinates must be equal, above 8192 points too (the
kernel that keeps min-distances in device memory; ties and NaN rows), at
the register kernel's block sizes and their edges, with argmax ties
between warps and the NaN rule at each block size; a second call gives
the same bits.
Fused SA (#3, K <= 64 and
the chunked K = 80, 128; and #10 over a given grouping), also at the edges
of the register tile (K = 1, 3, 7, 33, 63; M not a multiple of the queries
a block; widths not multiples of the tile; 1 and 8 layers; a 264-wide
layer): ``idx`` equal (None at K > 64); ``pooled`` in f32 to rtol 1e-4 /
atol 1e-5 (only the summation order differs).  In bf16 the kernel and the
plain version sum the same bf16-rounded products in f32, each output's sum
from 0 in ascending k as cuBLAS's, and round at the same points, so
``pooled`` must equal the plain version's bit for bit on an H100.  Every
call gives the same bits twice.

Training kernels: the ball group (``grouped``, ``idx``, ``cnt``), the ball
query alone (#8: ``idx``, ``cnt``) and the row gather must be equal to their
plain versions; the ball kernels at N off their chunks and tiles and at N =
40000 (staged in tiles), K = 1 and 1024, no hit, every point a hit, pairs
whose d2 is exactly r2 (never taken) and M = 1, at one and two queries a
warp, every unroll and on tiles of 1, 33 and 1000 points; a plan they
cannot run is refused and no build uses local memory.  The scatter-add must be
within 1e-5 x max(1, |ref|max) of ``index_add_`` on the card (both sum
exact f32, in other orders), equal bit for bit to the sequential
``index_add_`` on the CPU (``scatter_add_rows_plain``: ascending rows,
out-of-range rows dropped), and two calls on the same input must give the
same bits.  Its counting sort alone (``count_sort_kernel``): ``offsets``
and ``perm`` equal to a stable argsort's (``count_sort_plain``), so the
EdgeConv backward, which shares it, keeps its bits.

kNN: indices and squared distances equal to ``knn_point_plain`` (the same
f32 operations in the same order, and the same tie rule), at any k, on the
route the plan picks and on every route a plan may give (the group route
at 1, 4 and 32 lanes a query, the warp route, the selection, the full
sort): k = 3 to 127 (31, 32, 33, 47, 64, 65 at a list's edges), M below a
lane group and off the warp route's blocks, N below k and off the tiles,
ties that straddle the k-th distance, every distance +inf, NaN keys inside
a tie group, a bias with duplicated values, and on more than 16384 keys
tiles merged (N = 16385 to 50000, up to a k larger than a tile, where the
full sort takes over); a plan the kernels cannot run is refused, and no
route's build uses local memory;
``SAModule(knn=True, nsample=72)`` on the card against the same layer on
the CPU.  The self-kNN graph: indices equal to ``knn_graph_plain``, for the
same reason, at k <= 32 in its own kernel (k = 1, 2, 31, 32; C = 1, 65,
128; N off its 64-point tiles; ties across its 32-key chunks and tiles;
NaN and infinite rows; a cloud not on 16 bytes), twice with the same bits,
and above through the general one (k = 33 to 100, ties).  The graph and
FPS kernels use no local memory.
The duplicate mask (#12): equal to ``duplicate_mask_plain`` (float ``==``
on both sides), with ``-0.0``/``0.0`` pairs and NaN points, at N off and
on its 128-point tiles and above the 2048 points it stages at once, on one
point repeated N times and on clouds without duplicates.  PointCNN's
``knn_indices_general`` launches both at any Q and N when k <= 64 and
equals its kernel branch run on the plain versions.

DGCNN's edge reductions: every forward output equal to ``edge_reduce_plain``
(the same neighbours, max and min exact, the sums in the same slot order
without contraction), at k = 1, 7, 20, 33 and 40 and Cv = 1 to 256, at a
half-warp and a warp a query and on rows off 16 bytes, on a 58113-point
cloud, and with NaN and tied values bit for bit the slot-order rules
(tie counts included); lanes it cannot take are refused.  The backward within 1e-5 x max(1, |ref|max) of
autograd through the plain version (the same coefficients, summed in
another order), bit-stable across two calls (no float atomics) and equal
to ``edge_reduce_bwd_ordered`` (the same operations in the kernel's order),
at the staged kernel's slice widths 8, 4, 2 and 1, ragged slices, Cv = 1
to 256, N = 1 to 9685, k = 1, 20, 40, ties, and on the per-edge route at
N = 9686 (``routed_launches`` counted); with NaN values, NaN for NaN.  A
slice the kernel cannot run is refused; no build of ``edge.cu`` or of the
duplicate mask uses local memory.  The
neighbour gather ``edge_gather_knn``: rows and indices equal to the plain
version and to the graph kernel followed by the gather kernel, in f32 and
bf16, through the one fused kernel at k = 1, 20, 32 (one launch, no graph
or gather launch of its own; no local memory) and routed at k = 33 and 40,
at Cv = 1, 3, 5, 64 and 128, N off the 64-key tile, duplicated points and
NaN feature rows; its backward is the scatter-add, held as above.

SpiderConv (#16): the forward within ``SPIDER_FWD_TOL`` x max(1, |ref|max)
of ``spider_conv_plain`` (the same f32 products feat·g, summed against the
kernel with FMA in r order, where cuBLAS may take another), at conv1's
C=3, O and T not multiples of 8, T=64, O above 128 and tiles of rows cut
short; a neighbour index outside [0, N) gives a NaN row; the backward (dfeat, dg, dkernel)
within ``SPIDER_BWD_TOL`` x max(1, |ref|max) of autograd through the plain
version, per tensor, and bit-stable across two calls (fixed summation
orders, no float atomics).

Exact-key pooling (#18): pooled, kmax and cnt equal to
``bn_relu_exactkey_pool_plain`` bit for bit (the same r, the op order
without contraction, the same bf16 rounding), at the bf16 SSG step's three
SA shapes and MSG SA1's 64-wide scale, ragged widths, ties and a NaN.  The
fused tail's backward (#17): against ``grouped_bn_mlp_pool_bwd_plain`` at
SSG's SA1, SA2 and group-all, MSG SA1's K = 128 scale, small stacks and
the edges of its plan (K = 1, 33, 65, 96, 127, a last chunk of fewer
groups, widths 1, 5 and 1024, four layers), f32 and bf16, pool modes "0"
and "1", and one input as groups the chunk holds (the pool in every pass)
and reshaped into groups it cannot: bit-stable across two calls; each
cotangent at most ``SATRAIN_FLIP_SHARE`` of its elements beyond
``SATRAIN_TOL`` x max|ref| (a gate or winner flipped by the summation
order; in bf16 a rounding of h moved by one ulp); the Dense biases (true
gradient 0) within ``SATRAIN_ZERO_TOL`` x max(1, |dbeta|max) on both sides.
A one-channel bottom layer, whose sums cancel over the rows, is held under
the same gates to the plain backward with float64 sums.  A plan the kernel
cannot run (chunk rows, dW slices, scratch, blocks an SM) is refused.

The rank sort (#5): sorted coordinates, ids, rank and feature rows equal to
``rank_sort_points_plain`` (ties, -0.0/0.0, NaN keys, all keys equal or NaN,
ascending and descending keys, 2- and 4-byte feature rows, the main path's
B=128 calls, N at every boundary of ``sort_plan``), on every plan the kernel
takes, its builds without local memory, and a plan it cannot run refused.  The
bucketed SA layer (#4): ``pooled`` equal bit for bit to the #3 kernel's on
the same inputs (the same selection, the same row code), held to
``sa_ball_mlp_pool_bucketed_plain`` as #3 to its plain version, and its
per-tile overflow flags equal to the plain version's, in the sparse, dense
and overflow regimes, with and without features, prelifted, f32 and bf16;
an eval-mode SSG forward at N = 2048 launches #5 twice and #4 once under
``sa_bucket="auto"``, with logits equal to the "off" forward's.

The training loop: an ``ops_backend="auto"`` trainer's SSG ``train_step``
launches #2, #9, #6 and #7 and its ``eval_votes`` #1 and #3, a "lax"
trainer's launch nothing, and the next "auto" call launches again; a
checkpoint saved on the card restores onto the CPU and back bit for bit
(model, buffers, optimizer), the card's own restore also the generator and
the next step; ``cli.main`` with the default ``--device`` builds its model
on the card.

The PointNet family and 3DmFV-Net: #18 at PointNet's shape (the three
global pools of a bf16 step at B=32, N=1024, C=1024) equal bit for bit;
3DmFV's convolution gives the same f32 bits, forward and backward, with
cuDNN's TF32 flag off and on (the model holds it off for its convolutions)
and puts the flag back; ``pointnet_seg`` and ``3dmfv_net_cls`` on the card
against the same models on the CPU (f32 forward within 1e-4 x max(1,
|ref|max), the classes and 99% of the per-point argmaxes equal).

Data parallelism and the last modules: a ``Trainer`` on a group of one
rank (NCCL) takes two momentum steps of SSG (f32; f32 with the fused SA
tail, whose #17 backward then runs a pass a call with the table's sums
rewritten between; bf16 with #18) and of ``dgcnn_bga`` equal to the
no-group trainer's bit for bit; ``auction_match`` on the card equals its
CPU run (the same elementwise d² expansion; ``emd_loss`` within 1e-6);
``interp_check.main`` on the card launches the kNN and gather kernels and
writes the CPU run's three PNGs byte for byte.
"""

import os
from dataclasses import replace
from unittest import mock

import numpy as np
import pytest
import torch

from scanobjectnn_torch.ops.cuda import ballgroup_kernel
from scanobjectnn_torch.ops.cuda.ballgroup_kernel import (
    ball_query_plain,
    query_ball_group,
    query_ball_group_plain,
    query_ball_point,
)
from scanobjectnn_torch.ops.cuda.ballgroup_kernel import kernel_info as ball_kernel_info
from scanobjectnn_torch.ops.cuda.dupmask_kernel import duplicate_mask_kernel, duplicate_mask_plain
from scanobjectnn_torch.ops.cuda.dupmask_kernel import kernel_info as dupmask_kernel_info
from scanobjectnn_torch.ops.cuda.fps_kernel import fps, fps_plain
from scanobjectnn_torch.ops.cuda.fps_kernel import kernel_info as fps_kernel_info
from scanobjectnn_torch.nn import xconv
from scanobjectnn_torch.ops import interpolate
from scanobjectnn_torch.ops.cuda.gather_kernel import (
    count_sort_kernel,
    count_sort_plain,
    gather_neighbors,
    gather_rows,
    gather_rows_plain,
    scatter_add_rows,
    scatter_add_rows_plain,
)
from scanobjectnn_torch.ops.cuda import edge_kernel
from scanobjectnn_torch.ops.cuda.edge_kernel import kernel_info as edge_kernel_info
from scanobjectnn_torch.ops.cuda.edge_kernel import (
    REDUCTIONS,
    bwd_slice_width,
    edge_gather_knn,
    edge_gather_knn_plain,
    edge_reduce,
    edge_reduce_bwd_kernel,
    edge_reduce_bwd_ordered,
    edge_reduce_fwd_kernel,
    edge_reduce_plain,
    reduce_neighbors_plain,
)
from scanobjectnn_torch.ops.cuda import knn_kernel
from scanobjectnn_torch.ops.cuda.knn_kernel import (
    graph_kernel_info,
    knn_graph_kernel,
    knn_graph_plain,
    knn_point_kernel,
    knn_point_plain,
    point_kernel_info,
)
from scanobjectnn_torch.ops.cuda import ranksort_kernel
from scanobjectnn_torch.ops.cuda.ranksort_kernel import rank_sort_points, rank_sort_points_plain
from scanobjectnn_torch.ops.cuda.sabucket_kernel import (
    sa_ball_mlp_pool_bucketed,
    sa_ball_mlp_pool_bucketed_plain,
)
from scanobjectnn_torch.ops.cuda.safused_kernel import sa_ball_mlp_pool, sa_ball_mlp_pool_plain
from scanobjectnn_torch.ops.cuda import poolkey_kernel
from scanobjectnn_torch.ops.cuda.poolkey_kernel import Plan as PoolkeyPlan
from scanobjectnn_torch.ops.cuda.poolkey_kernel import bn_relu_exactkey_pool, bn_relu_exactkey_pool_plain
from scanobjectnn_torch.ops.cuda.poolkey_kernel import plan as poolkey_plan
from scanobjectnn_torch.ops.cuda.poolkey_kernel import runs as poolkey_runs
from scanobjectnn_torch.ops.cuda.samlp_kernel import sa_mlp_pool, sa_mlp_pool_plain
from scanobjectnn_torch.ops.cuda.satrain_kernel import (
    fwd_chain,
    grouped_bn_mlp_pool_bwd,
    grouped_bn_mlp_pool_bwd_plain,
)
from scanobjectnn_torch.ops.cuda import satrain_kernel
from scanobjectnn_torch.ops.cuda.satrain_kernel import _plan as satrain_forced_plan
from scanobjectnn_torch.ops.cuda.satrain_kernel import plan as satrain_plan
from scanobjectnn_torch.ops.cuda.satrain_kernel import sm_count
from scanobjectnn_torch.ops.cuda.spider_kernel import (
    spider_conv,
    spider_conv_bwd_kernel,
    spider_conv_fwd_kernel,
    spider_conv_plain,
)

SCATTER_TOL = 1e-5  # x max(1, |ref|max)
EDGE_BWD_TOL = 1e-5  # x max(1, |ref|max)
SPIDER_FWD_TOL, SPIDER_BWD_TOL = 1e-5, 1e-5  # x max(1, |ref|max)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize(
    "b,n,m",
    [(3, 100, 37), (2, 2048, 512), (2, 512, 128), (2, 5000, 64), (1, 8192, 16), (2, 7, 9),
     # the register kernel's block sizes and their edges: one point a thread
     # up to 512 threads, up to 8 of 512 threads, 1024 threads above 4096;
     # m up to N, m = 1, more clouds than SMs
     (2, 32, 32), (2, 33, 33), (2, 1023, 600), (2, 1025, 1025), (1, 2049, 900), (1, 4097, 300),
     (1, 8192, 8192), (3, 100, 1), (200, 64, 16),
     # above 8192 points: the kernel that keeps min_dist in device memory
     (2, 8193, 64), (2, 16384, 128), (1, 40000, 256)],
)
def test_fps_kernel_matches_plain(dev, b, n, m):
    xyz = torch.from_numpy(np.random.RandomState(n).randn(b, n, 3).astype(np.float32)).to(dev)
    before, large = fps.launches, fps.large_launches
    idx, new_xyz = fps(xyz, m)
    ref_idx, ref_xyz = fps_plain(xyz, m)
    assert torch.equal(idx, ref_idx) and torch.equal(new_xyz, ref_xyz)
    assert torch.equal(fps(xyz, m, with_coords=False), ref_idx)
    again_idx, again_xyz = fps(xyz, m)
    assert torch.equal(again_idx, idx) and torch.equal(again_xyz, new_xyz)  # the same bits twice
    assert fps.launches == before + 3
    assert fps.large_launches == large + (3 if n > 8192 else 0)


def _far_ties(rng, b, n, pairs):
    """A small cloud around the seed (index 0, at the origin) with each pair
    (i, j) of points far out at exactly the same distance from it, mirrored
    through the origin: the argmax ties between them, and i < j must win."""
    xyz = (rng.rand(b, n, 3).astype(np.float32) - 0.5) * 0.25
    xyz[:, 0] = 0.0
    for r, (i, j) in enumerate(pairs):
        v = np.zeros(3, np.float32)
        v[r % 3] = 4.0 + r
        xyz[:, i], xyz[:, j] = v, -v
    return xyz


# (n, pairs), at most three pairs (one an axis): at 512 threads a thread
# owns points tid, tid + 512, ...; the pairs sit in different warps (31/32,
# 63/64), in different warps of the second slice (543/1000) and across
# slices (5/517 are one thread's points).
FPS_TIE_CASES = {
    "n512": (512, [(31, 32), (63, 64), (100, 300)]),
    "n1024": (1024, [(31, 32), (543, 1000), (5, 517)]),
    "n2048": (2048, [(31, 32), (1500, 2047), (63, 1088)]),
}


@pytest.mark.parametrize("case", sorted(FPS_TIE_CASES))
def test_fps_kernel_ties_across_warps(dev, case):
    n, pairs = FPS_TIE_CASES[case]
    xyz = torch.from_numpy(_far_ties(np.random.RandomState(n), 3, n, pairs)).to(dev)
    idx, new_xyz = fps(xyz, 64)
    ref_idx, ref_xyz = fps_plain(xyz, 64)
    assert torch.equal(idx, ref_idx) and torch.equal(new_xyz, ref_xyz)
    assert torch.equal(fps(xyz, 64, with_coords=False), ref_idx)
    # The farthest pair first, each pair at its lower index, then its mirror.
    want = [x for i, j in reversed(pairs) for x in (i, j)]
    assert idx[:, 1:1 + len(want)].tolist() == [want] * 3


@pytest.mark.parametrize("n", [512, 2048, 5000])
def test_fps_kernel_nan_row_at_each_block_size(dev, n):
    # A NaN point poisons its cloud from step 1: index N, coordinates 0.
    xyz = np.random.RandomState(n).randn(3, n, 3).astype(np.float32)
    xyz[1, n - 7, 2] = np.nan
    xyz = torch.from_numpy(xyz).to(dev)
    idx, new_xyz = fps(xyz, 40)
    ref_idx, ref_xyz = fps_plain(xyz, 40)
    assert torch.equal(idx, ref_idx) and torch.equal(new_xyz, ref_xyz)
    assert torch.equal(fps(xyz, 40, with_coords=False), ref_idx)
    assert (idx[1, 1:] == n).all() and (new_xyz[1, 1:] == 0).all()


def test_fps_kernel_ties_and_nan(dev):
    rng = np.random.RandomState(0)
    base = rng.randint(-3, 4, (4, 128, 3)).astype(np.float32) * 0.25
    ties = np.stack([c[rng.permutation(1024)] for c in np.tile(base, (1, 8, 1))])
    ties[3, 17, 0] = np.nan
    xyz = torch.from_numpy(ties).to(dev)
    idx, new_xyz = fps(xyz, 256)
    ref_idx, ref_xyz = fps_plain(xyz, 256)
    assert torch.equal(idx, ref_idx) and torch.equal(new_xyz, ref_xyz)
    assert (idx[3, 1:] == 1024).all()


def test_fps_large_kernel_ties_and_nan(dev):
    rng = np.random.RandomState(1)
    n = 12000
    base = rng.randint(-3, 4, (3, 1500, 3)).astype(np.float32) * 0.25
    ties = np.stack([c[rng.permutation(n)] for c in np.tile(base, (1, 8, 1))])
    ties[2, 9000, 1] = np.nan
    xyz = torch.from_numpy(ties).to(dev)
    large = fps.large_launches
    idx, new_xyz = fps(xyz, 200)
    ref_idx, ref_xyz = fps_plain(xyz, 200)
    assert fps.large_launches == large + 1
    assert torch.equal(idx, ref_idx) and torch.equal(new_xyz, ref_xyz)
    assert torch.equal(fps(xyz, 200, with_coords=False), ref_idx)
    assert (idx[2, 1:] == n).all() and (new_xyz[2, 1:] == 0).all()


# (b, n, m, k, radius, src channels, mlp, use_xyz, xyz_first)
SA_CASES = {
    "sa1_like": (2, 2048, 512, 32, 0.2, 0, (64, 64, 128), True, True),
    "sa2_like": (2, 512, 128, 64, 0.4, 128, (128, 128, 256), True, True),
    "ragged_m": (2, 250, 33, 8, 0.5, 0, (16, 32), True, True),
    "k24_features": (2, 300, 40, 24, 0.5, 20, (32, 40), True, True),
    "k1": (1, 64, 16, 1, 0.5, 4, (8,), True, True),
    "sparse_rows": (2, 256, 64, 16, 0.06, 0, (16, 32), True, True),
    "msg_order": (2, 128, 32, 8, 0.6, 12, (24, 32), True, False),
    "no_xyz": (1, 128, 32, 8, 0.6, 16, (16, 16), False, True),
    "prelifted": (2, 128, 32, 8, 0.6, 40, (16, 24), True, True),
    "four_layers": (1, 200, 24, 16, 0.6, 8, (16, 24, 24, 40), True, True),
    # K > 64: one query a block, chunks of 64 slots (MSG's K = 128 scales).
    "msg_sa1_k128": (2, 1024, 128, 128, 0.4, 0, (64, 96, 128), True, False),
    "msg_sa2_k128_prelifted": (2, 512, 64, 128, 0.8, 320, (128, 128, 256), True, False),
    "k80_features_ragged": (1, 300, 40, 80, 0.6, 20, (32, 40), True, True),
    # The register tile's edges: K not a multiple of 4 (pad rows), M not a
    # multiple of QPB, widths not multiples of the tile, 1 and 8 layers,
    # a 264-wide layer (two passes of 256 columns), prelifted and not.
    "k1_one_layer_xyz_only": (2, 64, 33, 1, 0.5, 0, (72,), True, True),
    "k3_cs37": (2, 200, 50, 3, 0.4, 37, (40, 8), True, True),
    "k7_cout72": (2, 300, 37, 7, 0.5, 0, (72, 24, 72), True, True),
    "k33_cs131": (1, 400, 21, 33, 0.6, 131, (136, 24), True, True),
    "k63_prelifted_cs131": (2, 300, 17, 63, 0.6, 131, (72, 8), True, False),
    "k64_eight_layers": (1, 256, 24, 64, 0.7, 12, (24, 8, 72, 24, 264, 8, 24, 72), True, True),
    "k80_cout264": (1, 300, 19, 80, 0.6, 37, (72, 264), True, True),
    "k128_no_xyz": (1, 512, 10, 128, 0.8, 24, (8, 24), False, True),
}


def sa_inputs(spec, rng):
    """numpy inputs of one SA case ``(b, n, m, k, radius, src channels, mlp,
    use_xyz, xyz_first)``: queries are cloud points moved off the points.
    Returns ((radius, k, xyz, new_xyz, src, weights, biases), kwargs)."""
    b, n, m, k, radius, c, mlp, use_xyz, xyz_first = spec
    xyz = (rng.randn(b, n, 3) * 0.5).astype(np.float32)
    new_xyz = np.stack([x[rng.choice(n, m, replace=False)] for x in xyz])
    new_xyz += (0.05 * rng.randn(*new_xyz.shape)).astype(np.float32)
    src = rng.randn(b, n, c).astype(np.float32) if c else None
    widths = ((3 if use_xyz or not c else 0) + c,) + tuple(mlp)
    weights = [(rng.randn(i, o) / np.sqrt(i)).astype(np.float32) for i, o in zip(widths, widths[1:])]
    biases = [(0.1 * rng.randn(o)).astype(np.float32) for o in mlp]
    return (radius, k, xyz, new_xyz, src, weights, biases), dict(use_xyz=use_xyz, xyz_first=xyz_first)


def _sa_inputs(case, dev):
    spec = SA_CASES[case]
    rng = np.random.RandomState(spec[1] + spec[3])  # seeded by n + k
    (radius, k, *arrays, weights, biases), kw = sa_inputs(spec, rng)

    def t(x):
        return None if x is None else torch.from_numpy(x).to(dev)

    return (radius, k, *[t(a) for a in arrays], [t(w) for w in weights], [t(b) for b in biases]), kw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(SA_CASES))
def test_safused_kernel_matches_plain(dev, case, dtype):
    args, kw = _sa_inputs(case, dev)
    before = sa_ball_mlp_pool.launches
    pooled, idx = sa_ball_mlp_pool(*args, dtype=dtype, **kw)
    again, _ = sa_ball_mlp_pool(*args, dtype=dtype, **kw)
    ref, ref_idx = sa_ball_mlp_pool_plain(*args, dtype=dtype, **kw)
    torch.cuda.synchronize()
    assert sa_ball_mlp_pool.launches == before + 2
    if args[1] > 64:
        assert idx is None and ref_idx is None
    else:
        assert torch.equal(idx, ref_idx)
    assert torch.equal(pooled, again)
    _check_pooled(pooled, ref, dtype)


def _check_pooled(pooled, ref, dtype):
    assert pooled.dtype == ref.dtype == dtype and pooled.shape == ref.shape
    if dtype == torch.float32:
        torch.testing.assert_close(pooled, ref, rtol=1e-4, atol=1e-5)
    else:
        diff = (pooled.float() - ref.float()).abs()
        assert torch.equal(pooled, ref), (float(diff.max()), float((diff > 0).float().mean()))


def test_safused_kernel_refuses_what_it_does_not_take(dev):
    args, kw = _sa_inputs("ragged_m", dev)
    for k in (65, 72, 1040):  # K <= 64, or a multiple of 16 up to 1024
        with pytest.raises(ValueError, match="K <= 64"):
            sa_ball_mlp_pool(args[0], k, *args[2:], **kw)
    with pytest.raises(ValueError, match="contiguous"):
        sa_ball_mlp_pool(args[0], args[1], args[2].transpose(0, 1).contiguous().transpose(0, 1), *args[3:], **kw)
    with pytest.raises(ValueError, match="float32"):
        sa_ball_mlp_pool(args[0], args[1], args[2].double(), *args[3:], **kw)
    radius, k, xyz, new_xyz, src, weights, biases = args
    with pytest.raises(ValueError, match="biases"):
        sa_ball_mlp_pool(radius, k, xyz, new_xyz, src, weights, [biases[0], biases[1][:-1]], **kw)
    with pytest.raises(ValueError, match="weights"):
        sa_ball_mlp_pool(radius, k, xyz, new_xyz, src, [weights[0], weights[1][1:]], biases, **kw)


# (b, n, m, k, radius, cloud): the SSG training shapes, MSG's K=128, a ragged
# one, an empty-ball case (queries far from the cloud) and duplicated points.
# The kernel's plan: N off its steps of 32 x 8 points (1000) and off its
# 3072-point tile (5000), N = 40000 (14 tiles, a query's hits in several),
# K = 1 and 1024, no hit in any ball, every point a hit (K below and above
# N), pairs whose d2 is exactly r2 (not hits), M = 1.
BALL_CASES = {
    "sa1": (16, 1024, 512, 32, 0.2, "normal"),
    "sa2": (16, 512, 128, 64, 0.4, "normal"),
    "k128": (2, 1024, 128, 128, 0.4, "normal"),
    "ragged": (3, 100, 37, 7, 0.5, "normal"),
    "empty_balls": (2, 256, 64, 16, 0.2, "far"),
    "duplicates": (4, 1024, 256, 32, 0.3, "lattice"),
    "n_off_chunk": (3, 1000, 100, 32, 0.3, "normal"),
    "n_off_tile": (2, 5000, 64, 64, 0.2, "normal"),
    "n40000": (2, 40000, 128, 64, 0.05, "normal"),
    "k1": (4, 1024, 256, 1, 0.2, "normal"),
    "k1024": (2, 2048, 64, 1024, 0.8, "normal"),
    "no_hit": (2, 512, 64, 32, 0.2, "none"),
    "all_hits": (2, 300, 50, 128, 100.0, "normal"),
    "all_hits_k_above_n": (2, 100, 20, 128, 100.0, "normal"),
    "exact_r2": (2, 512, 64, 64, 0.5, "exact"),
    "m1": (3, 1024, 1, 32, 0.3, "normal"),
}


def ball_inputs(spec, rng):
    """numpy (xyz [b, n, 3], new_xyz [b, m, 3]) of one ball-group case: the
    queries are cloud points moved off the points; "far" moves half of them
    out of every ball and "none" all of them, "lattice" repeats each point
    of a coarse grid, "exact" takes cloud points of a grid of 1/8 as the
    queries themselves, so that many pairs lie at a d2 of exactly r2 = 0.25
    (every square and sum exact in f32)."""
    b, n, m, _, _, cloud = spec
    if cloud == "lattice":
        base = rng.randint(-3, 4, (b, n // 8, 3)).astype(np.float32) * 0.25
        xyz = np.stack([c[rng.permutation(n)] for c in np.tile(base, (1, 8, 1))])
    elif cloud == "exact":
        xyz = rng.randint(-8, 9, (b, n, 3)).astype(np.float32) * 0.125
    else:
        xyz = (rng.randn(b, n, 3) * 0.5).astype(np.float32)
    new_xyz = np.stack([x[rng.choice(n, m, replace=False)] for x in xyz])
    if cloud == "exact":
        return xyz, new_xyz
    new_xyz += (0.05 * rng.randn(*new_xyz.shape)).astype(np.float32)
    if cloud == "far":
        new_xyz[:, ::2] += 100.0
    if cloud == "none":
        new_xyz += 100.0
    return xyz, new_xyz


def _ball_case_check(case, got_idx, got_cnt, xyz, new_xyz):
    """What a case sets up holds in the kernel's output (beyond equality)."""
    b, n, m, k, radius, cloud = BALL_CASES[case]
    if cloud == "none":
        assert (got_cnt == 0).all() and (got_idx == 0).all()
    if case.startswith("all_hits"):
        assert (got_cnt == min(k, n)).all()
    if cloud == "exact":  # boundary pairs exist, and none was taken
        d2 = ((new_xyz[:, :, None, :] - xyz[:, None, :, :]) ** 2).sum(-1)
        assert bool((d2 == radius * radius).any())
        filled = torch.arange(k, device=got_idx.device) < got_cnt[..., None]
        assert bool((torch.gather(d2, 2, got_idx.long())[filled] < radius * radius).all())


@pytest.mark.parametrize("case", sorted(BALL_CASES))
def test_ballgroup_kernel_matches_plain(dev, case):
    spec = BALL_CASES[case]
    xyz, new_xyz = (torch.from_numpy(a).to(dev) for a in ball_inputs(spec, np.random.RandomState(spec[1])))
    radius, k = spec[4], spec[3]
    before = query_ball_group.launches
    got = query_ball_group(radius, k, xyz, new_xyz)
    want = query_ball_group_plain(radius, k, xyz, new_xyz)
    torch.cuda.synchronize()
    assert query_ball_group.launches == before + 1
    for name, g, w in zip(("grouped", "idx", "cnt"), got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    if case == "empty_balls":
        assert (got[2][:, ::2] == 0).all() and (got[1][:, ::2] == 0).all()
    _ball_case_check(case, got[1], got[2], xyz, new_xyz)


def test_ballgroup_kernel_refuses_what_it_does_not_take(dev):
    xyz = torch.zeros(1, 8, 3, device=dev)
    with pytest.raises(ValueError, match="K <= 1024"):
        query_ball_group(0.2, 1025, xyz, xyz)
    with pytest.raises(ValueError, match="float32"):
        query_ball_group(0.2, 4, xyz.double(), xyz)
    with pytest.raises(ValueError, match="contiguous"):
        query_ball_group(0.2, 4, torch.zeros(1, 3, 8, device=dev).transpose(1, 2), xyz)


@pytest.mark.parametrize("case", sorted(BALL_CASES))
def test_ball_query_kernel_matches_plain(dev, case):
    spec = BALL_CASES[case]
    xyz, new_xyz = (torch.from_numpy(a).to(dev) for a in ball_inputs(spec, np.random.RandomState(spec[1])))
    radius, k = spec[4], spec[3]
    before = query_ball_point.launches
    idx, cnt = query_ball_point(radius, k, xyz, new_xyz)
    want_idx, want_cnt = ball_query_plain(radius, k, xyz, new_xyz)
    torch.cuda.synchronize()
    assert query_ball_point.launches == before + 1
    assert idx.dtype == cnt.dtype == torch.int32
    assert torch.equal(idx, want_idx.int()) and torch.equal(cnt, want_cnt.int())
    _ball_case_check(case, idx, cnt, xyz, new_xyz)


# Plans the kernel takes besides ball_plan's (queries a block, queries a
# warp, unroll, tile): every queries a warp and unroll at two warps a block,
# one query a block, eight warps of two, and tiles of 1, 33 and 1000 points
# (a query's hits across many tiles, tiles off the steps).
BALL_PLANS = [(2 * pw, pw, u, 3072) for pw in (1, 2) for u in (4, 8)]
BALL_PLANS += [(1, 1, 8, 3072), (16, 2, 8, 3072), (8, 1, 8, 1), (4, 2, 4, 33), (6, 2, 4, 1000)]


@pytest.mark.parametrize("plan", BALL_PLANS, ids=["q{}_w{}_u{}_t{}".format(*p) for p in BALL_PLANS])
@pytest.mark.parametrize("case", ["ragged", "n_off_chunk", "k128", "duplicates", "all_hits_k_above_n"])
def test_ball_kernels_on_every_plan_match_plain(dev, case, plan):
    spec = BALL_CASES[case]
    xyz, new_xyz = (torch.from_numpy(a).to(dev) for a in ball_inputs(spec, np.random.RandomState(spec[1])))
    radius, k = spec[4], spec[3]
    plan = (*plan[:3], min(plan[3], spec[1]))
    with mock.patch.object(ballgroup_kernel, "ball_plan", lambda *a: plan):
        got = query_ball_group(radius, k, xyz, new_xyz)
        idx, cnt = query_ball_point(radius, k, xyz, new_xyz)
    want = query_ball_group_plain(radius, k, xyz, new_xyz)
    torch.cuda.synchronize()
    for name, g, w in zip(("grouped", "idx", "cnt"), got, want):
        assert torch.equal(g, w), name
    assert torch.equal(idx, want[1]) and torch.equal(cnt, want[2])


@pytest.mark.parametrize("plan", [(8, 3, 8, 1024), (8, 1, 3, 1024), (8, 1, 2, 1024), (9, 1, 8, 1024),
                                  (18, 2, 8, 1024), (3, 2, 8, 1024), (0, 1, 8, 1024), (8, 1, 8, 0),
                                  (8, 1, 8, 3073)])
def test_ball_kernels_refuse_a_plan_they_cannot_run(dev, plan):
    xyz = torch.zeros(1, 1024, 3, device=dev)
    with mock.patch.object(ballgroup_kernel, "ball_plan", lambda *a: plan):
        with pytest.raises(RuntimeError, match="CUDA launch failed"):
            query_ball_group(0.2, 32, xyz, xyz[:, :64].contiguous())
        with pytest.raises(RuntimeError, match="CUDA launch failed"):
            query_ball_point(0.2, 32, xyz, xyz[:, :64].contiguous())
    with pytest.raises(RuntimeError, match="kernel_info"):
        ball_kernel_info(*plan)


@pytest.mark.parametrize("unroll", ballgroup_kernel.UNROLLS)
def test_ball_and_graph_gather_kernels_use_no_local_memory(dev, unroll):
    for queries, per_warp in ((8, 1), (16, 2), (1, 1), (2, 2)):
        info = ball_kernel_info(queries, per_warp, unroll, 3072)
        assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 1, (queries, per_warp, unroll, info)
        assert info["smem_bytes"] == ballgroup_kernel.smem_bytes(3072, unroll)
    for c in (3, 64, 65):
        info = graph_kernel_info(c, gather=True)
        assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 1, (c, info)


# name: (b, n, m, k, feature channels, use the coordinates, mlp)
SAMLP_CASES = {
    "xyz_only_k32": (4, 1024, 512, 32, 0, True, (64, 64, 128)),
    "ssg_sa2_knn_like": (4, 512, 128, 32, 128, True, (128, 128, 256)),
    "features_k128": (2, 512, 128, 128, 128, True, (128, 128, 256)),
    "features_no_xyz_ragged": (3, 200, 37, 16, 24, False, (32, 40)),
    "k72": (2, 256, 40, 72, 8, True, (16, 24, 24, 40)),
    # The register tile's edges (as SA_CASES).
    "k3_cs37_one_layer": (2, 100, 33, 3, 37, True, (8,)),
    "k7_eight_layers": (1, 150, 19, 7, 5, True, (8, 24, 72, 8, 24, 72, 264, 24)),
    "k33_no_xyz": (2, 200, 13, 33, 24, False, (24, 72)),
    "k63_xyz_only": (2, 200, 21, 63, 0, True, (72, 24)),
    "k128_cs131": (1, 300, 9, 128, 131, True, (72, 136)),
}


def _samlp_inputs(case, dev):
    b, n, m, k, c, use_xyz, mlp = SAMLP_CASES[case]
    rng = np.random.RandomState(n + k)
    grouped = (rng.randn(b, m, k, 3) * 0.3).astype(np.float32) if use_xyz or not c else None
    idx = rng.randint(0, n, (b, m, k)).astype(np.int32) if c else None
    src = rng.randn(b, n, c).astype(np.float32) if c else None
    widths = ((3 if grouped is not None else 0) + c,) + tuple(mlp)
    weights = [(rng.randn(i, o) / np.sqrt(i)).astype(np.float32) for i, o in zip(widths, widths[1:])]
    biases = [(0.1 * rng.randn(o)).astype(np.float32) for o in mlp]

    def t(x):
        return None if x is None else torch.from_numpy(x).to(dev)

    return t(grouped), t(idx), t(src), [t(w) for w in weights], [t(b_) for b_ in biases]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(SAMLP_CASES))
def test_samlp_kernel_matches_plain(dev, case, dtype):
    args = _samlp_inputs(case, dev)
    before = sa_mlp_pool.launches
    pooled = sa_mlp_pool(*args, dtype=dtype)
    again = sa_mlp_pool(*args, dtype=dtype)
    ref = sa_mlp_pool_plain(*args, dtype=dtype)
    torch.cuda.synchronize()
    assert sa_mlp_pool.launches == before + 2
    assert torch.equal(pooled, again)
    _check_pooled(pooled, ref, dtype)


def test_samlp_kernel_refuses_what_it_does_not_take(dev):
    grouped, idx, src, weights, biases = _samlp_inputs("features_no_xyz_ragged", dev)
    with pytest.raises(ValueError, match="int32"):
        sa_mlp_pool(None, idx.long(), src, weights, biases)
    with pytest.raises(ValueError, match="weights"):
        sa_mlp_pool(None, idx, src, [weights[0], weights[1][1:]], biases)
    with pytest.raises(ValueError, match="K <= 1024"):
        sa_mlp_pool(torch.zeros(1, 2, 1025, 3, device=dev), None, None, [torch.zeros(3, 4, device=dev)],
                    [torch.zeros(4, device=dev)])


def test_sa_module_knn_above_k64_raises_on_the_card(dev):
    # It raised while the kNN kernel stopped at k = 64; now (any k, as JAX's
    # knn_point_pallas) the layer runs the kernels (FPS, kNN, #10) and
    # matches the same layer on the CPU, its plain versions: centroids
    # equal, pooled to rtol 1e-4 / atol 1e-5 (only the MLP's summation
    # order differs).
    from scanobjectnn_torch.convert import init_params
    from scanobjectnn_torch.nn.pointnet_modules import SAModule

    sa = init_params(SAModule(32, None, 72, (16, 32), knn=True), torch.Generator().manual_seed(0)).eval()
    xyz = torch.from_numpy(np.random.RandomState(0).randn(2, 256, 3).astype(np.float32))
    with torch.no_grad():
        want = sa(xyz, None)
        before = knn_point_kernel.launches
        got = sa.to(dev)(xyz.to(dev), None)
        torch.cuda.synchronize()
    assert knn_point_kernel.launches == before + 1
    assert torch.equal(got[0].cpu(), want[0])
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_unfused_eval_sa_layers_gather_bf16_points(dev, dtype):
    # JAX's eval gate sends npoint % 8 != 0 (SAModule) and an unfusable K
    # (SAModuleMSG, K = 72) to the unfused chain, which gathers the point
    # features: bf16 ones too.  Against the same layers on the CPU (the
    # plain versions): f32 to rtol 1e-4 / atol 1e-5, bf16 to 2e-2, about two
    # bf16 ulps at the activations' scale, since cuBLAS and the CPU sum in
    # other orders before each rounding.
    from scanobjectnn_torch.convert import init_params
    from scanobjectnn_torch.nn.pointnet_modules import SAModule, SAModuleMSG

    rng = np.random.RandomState(3)
    xyz = torch.from_numpy((rng.randn(2, 256, 3) * 0.5).astype(np.float32))
    pts = torch.from_numpy(rng.randn(2, 256, 8).astype(np.float32)).to(dtype)
    for layer in (SAModule(30, 0.4, 16, (16, 16), 8, dtype=dtype),
                  SAModuleMSG(32, (0.6,), (72,), ((16, 16),), 8, dtype=dtype)):
        init_params(layer, torch.Generator().manual_seed(0)).eval()
        with torch.no_grad():
            want = layer(xyz, pts)
            got = layer.to(dev)(xyz.to(dev), pts.to(dev))
        assert torch.equal(got[0].cpu(), want[0])
        torch.testing.assert_close(got[1].float().cpu(), want[1].float(), rtol=1e-4 if dtype == torch.float32 else 2e-2,
                                   atol=1e-5 if dtype == torch.float32 else 2e-2)


def _scatter_inputs(dev, b, n, m, k, c, seed):
    """SA2-like indices (padding repeats each row's first hit) and values."""
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, n, size=(b, m, k)).astype(np.int32)
    idx[:, :, k // 3:] = idx[:, :, :1]
    vals = torch.from_numpy(rng.randn(b, n, c).astype(np.float32)).to(dev)
    upd = torch.from_numpy(rng.randn(b, m * k, c).astype(np.float32)).to(dev)
    return vals, torch.from_numpy(idx.reshape(b, m * k)).to(dev), upd


# (b, n, m, k, c): the SSG SA2 gather, a width that is not a multiple of 4,
# and a cloud whose inverse index needs more than 48 KB of shared memory.
GATHER_CASES = {"sa2": (16, 512, 128, 64, 128), "c5": (3, 100, 20, 8, 5), "n16k": (2, 16384, 64, 32, 8)}


@pytest.mark.parametrize("case", sorted(GATHER_CASES))
def test_gather_and_scatter_kernels_match_plain(dev, case):
    b, n, m, k, c = GATHER_CASES[case]
    vals, idx, upd = _scatter_inputs(dev, b, n, m, k, c, seed=n + c)
    before = (gather_rows.launches, scatter_add_rows.launches)
    assert torch.equal(gather_rows(vals, idx), gather_rows_plain(vals, idx))
    got = scatter_add_rows(idx, upd, n)
    again = scatter_add_rows(idx, upd, n)
    want = scatter_add_rows_plain(idx, upd, n)
    torch.cuda.synchronize()
    assert (gather_rows.launches, scatter_add_rows.launches) == (before[0] + 1, before[1] + 2)
    assert torch.equal(got, again), "the scatter is not deterministic"
    assert got.dtype == torch.float32 and got.shape == (b, n, c)
    scale = max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    assert err <= SCATTER_TOL * scale, (err, scale)


def test_gather_neighbors_backward_is_the_scatter_kernel(dev):
    vals, idx, upd = _scatter_inputs(dev, 4, 512, 128, 64, 32, seed=1)
    vals.requires_grad_()
    before = (gather_rows.launches, scatter_add_rows.launches)
    out = gather_neighbors(vals, idx.reshape(4, 128, 64))
    (grad,) = torch.autograd.grad(out, vals, upd.reshape(out.shape))
    torch.cuda.synchronize()
    assert (gather_rows.launches, scatter_add_rows.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(out.detach().reshape(upd.shape), gather_rows_plain(vals.detach(), idx))
    want = scatter_add_rows_plain(idx, upd, 512)
    assert float((grad - want).abs().max()) <= SCATTER_TOL * max(1.0, float(want.abs().max()))


def _index_order_sum(idx, upd, n):
    """Each cloud's rows added into their points in ascending row order by
    the CPU's sequential ``index_add_``, rows outside [0, n) dropped."""
    idx, upd = idx.cpu().long(), upd.cpu()
    out = torch.zeros(upd.shape[0], n, upd.shape[-1])
    for b in range(upd.shape[0]):
        keep = (idx[b] >= 0) & (idx[b] < n)
        out[b].index_add_(0, idx[b][keep], upd[b][keep])
    return out


# (b, n, r, c, how): the SSG SA2 call; the SpiderCNN dfeat shape; every row
# aimed at one point; r not a multiple of the sort's tile with a width not a
# multiple of 4; n = 16384 (a tile of 16384 rows); rows outside [0, n).
SORT_CASES = {
    "sa2": (16, 512, 8192, 128, "random"),
    "spider_dfeat": (4, 1024, 20480, 32, "random"),
    "one_point": (3, 64, 5000, 16, "one_point"),
    "ragged_r": (2, 300, 3001, 5, "random"),
    "n16384": (2, 16384, 40000, 8, "random"),
    "out_of_range": (3, 200, 4100, 12, "out_of_range"),
}


def _sort_inputs(dev, case):
    b, n, r, c, how = SORT_CASES[case]
    rng = np.random.RandomState(r)
    idx = rng.randint(0, n, (b, r)).astype(np.int32)
    if how == "one_point":
        idx[:] = 17
    elif how == "out_of_range":
        idx[:, ::7] = -1
        idx[:, 3::11] = n + rng.randint(0, 3, idx[:, 3::11].shape)
    upd = rng.randn(b, r, c).astype(np.float32)
    return torch.from_numpy(idx).to(dev), torch.from_numpy(upd).to(dev), n


@pytest.mark.parametrize("case", sorted(SORT_CASES))
def test_count_sort_matches_a_stable_argsort(dev, case):
    idx, _, n = _sort_inputs(dev, case)
    before = count_sort_kernel.launches
    offsets, perm = count_sort_kernel(idx, n)
    want_offsets, want_perm = count_sort_plain(idx.cpu(), n)
    torch.cuda.synchronize()
    assert count_sort_kernel.launches == before + 1
    assert torch.equal(offsets.cpu(), want_offsets)
    for b in range(idx.shape[0]):
        used = int(want_offsets[b, n])
        assert torch.equal(perm[b, :used].cpu(), want_perm[b, :used]), b


@pytest.mark.parametrize("case", sorted(SORT_CASES))
def test_scatter_add_is_the_cpu_index_order_sum(dev, case):
    idx, upd, n = _sort_inputs(dev, case)
    got = scatter_add_rows(idx, upd, n)
    again = scatter_add_rows(idx, upd, n)
    torch.cuda.synchronize()
    assert torch.equal(got, again), "the scatter is not deterministic"
    assert torch.equal(got.cpu(), _index_order_sum(idx, upd, n))
    if SORT_CASES[case][-1] != "out_of_range":
        assert torch.equal(got.cpu(), scatter_add_rows_plain(idx.cpu(), upd.cpu(), n))


def test_gather_kernels_refuse_what_they_do_not_take(dev):
    vals, idx, upd = _scatter_inputs(dev, 2, 64, 8, 4, 8, seed=2)
    with pytest.raises(ValueError, match="int32"):
        gather_rows(vals, idx.long())
    with pytest.raises(ValueError, match="float32"):
        scatter_add_rows(idx, upd.double(), 64)
    with pytest.raises(ValueError, match="contiguous"):
        gather_rows(vals.transpose(1, 2).contiguous().transpose(1, 2), idx)


# (b, m queries, n keys, c, k, bias, cloud): the FP decoder's three_nn at
# fp1 (one key: padded slots), fp2 and fp3; PointCNN-like k=16 with a bias;
# C=64 (keys in several shared-memory tiles); k=32; ragged counts;
# duplicated keys; a NaN key; the wider lists: k = 33, 48 (PointCNN's
# xdconv_4 shape, 1024 queries on 384 keys) and 64, with and without a bias;
# fewer keys than k (padded slots) at k = 48.
KNN_CASES = {
    "fp1": (4, 128, 1, 3, 3, False, "normal"),
    "fp2": (4, 512, 128, 3, 3, False, "subset"),
    "fp3": (4, 1024, 512, 3, 3, False, "subset"),
    "k16_bias": (2, 300, 700, 3, 16, True, "normal"),
    "c64": (2, 200, 512, 64, 8, False, "normal"),
    "k32": (2, 130, 257, 5, 32, True, "normal"),
    "duplicates": (3, 256, 512, 3, 5, False, "lattice"),
    "nan_key": (2, 64, 100, 3, 4, False, "nan"),
    "k33": (2, 130, 257, 3, 33, False, "normal"),
    "k48_xdconv4": (2, 1024, 384, 3, 48, True, "subset"),
    "k48_duplicates": (2, 256, 512, 3, 48, False, "lattice"),
    "k64": (2, 200, 1500, 3, 64, False, "normal"),
    "k64_bias_c7": (2, 96, 300, 7, 64, True, "normal"),
    "k48_few_keys": (2, 64, 40, 3, 48, True, "normal"),
    # k > 64: the block-wide sort (any k; N <= 16384).
    "k65": (2, 130, 257, 3, 65, False, "normal"),
    "k128_bias": (2, 100, 1024, 3, 128, True, "normal"),
    "k72_duplicates": (2, 256, 512, 3, 72, False, "lattice"),
    "k80_c7_nan_key": (2, 64, 300, 7, 80, False, "nan"),
    "k100_few_keys": (2, 64, 80, 3, 100, False, "normal"),
    # k > 64 on clouds of more than 16384 keys: sorted tiles merged, up to a
    # k larger than a tile.
    "k65_n16385": (2, 4, 16385, 3, 65, False, "normal"),
    "k128_n20000_bias": (1, 6, 20000, 3, 128, True, "normal"),
    "k65_n50000_duplicates": (1, 8, 50000, 3, 65, False, "lattice"),
    "k128_n50000_nan_key": (2, 16, 50000, 3, 128, False, "nan"),
    "k128_n50000_c7": (1, 64, 50000, 7, 128, False, "normal"),
    "k20000_n50000": (1, 3, 50000, 3, 20000, True, "normal"),
    # The group lanes, the warp lists and the selection at their edges:
    # k = 31, 32, 33, 47, 64 (a list's last lane and register), 65 and 127;
    # M below one lane group (1 and 3 queries) and not a multiple of the
    # lanes or of the warp route's 16 queries a block; N below k, and N not
    # a multiple of the lanes or of a tile (2431 keys: two warp-route tiles
    # of 2208 at C=3, the second ragged).
    "k31": (2, 130, 257, 3, 31, False, "normal"),
    "k32_c64": (2, 70, 300, 64, 32, False, "normal"),
    "k33_bias": (2, 97, 301, 3, 33, True, "normal"),
    "k47_c5": (2, 130, 257, 5, 47, False, "normal"),
    "k64_n2431": (1, 45, 2431, 3, 64, False, "normal"),
    "k65_bias_n2431": (1, 45, 2431, 3, 65, True, "normal"),
    "k127": (2, 33, 1000, 3, 127, False, "normal"),
    "m1_k3": (3, 1, 1000, 3, 3, False, "normal"),
    "m3_k16": (2, 3, 77, 3, 16, False, "normal"),
    "m33_k40": (2, 33, 500, 3, 40, True, "normal"),
    "k8_few_keys": (2, 50, 5, 3, 8, False, "normal"),
    "k40_few_keys": (2, 50, 39, 3, 40, True, "normal"),
    "k127_few_keys": (2, 20, 100, 3, 127, False, "normal"),
    # Ties that straddle the k-th distance (keys repeated on a coarse
    # lattice), below and above k = 64; every distance +inf (an infinite
    # bias); NaN keys inside a tie group; a bias with duplicated values on
    # duplicated keys.
    "k31_lattice": (2, 256, 512, 3, 31, False, "lattice"),
    "k40_lattice": (2, 256, 512, 3, 40, False, "lattice"),
    "k64_lattice": (2, 256, 1024, 3, 64, False, "lattice"),
    "k127_lattice": (2, 256, 1024, 3, 127, False, "lattice"),
    "k8_all_inf": (2, 64, 300, 3, 8, True, "inf_bias"),
    "k40_all_inf": (2, 64, 300, 3, 40, True, "inf_bias"),
    "k100_all_inf": (2, 64, 300, 3, 100, True, "inf_bias"),
    "k8_nan_ties": (2, 128, 512, 3, 8, False, "nan_ties"),
    "k40_nan_ties": (2, 128, 512, 3, 40, False, "nan_ties"),
    "k100_nan_ties": (2, 128, 512, 3, 100, False, "nan_ties"),
    "k24_bias_duplicates": (2, 384, 1024, 3, 24, True, "bias_dup"),
    "k48_bias_duplicates": (2, 384, 1024, 3, 48, True, "bias_dup"),
    "k100_bias_duplicates": (2, 128, 1024, 3, 100, True, "bias_dup"),
}


def knn_inputs(spec, rng):
    """numpy (queries [b, m, c], keys [b, n, c], bias [b, n] or None) of one
    kNN case: "subset" keys are queries (as FPS picks them), "lattice" keys
    repeat coarse grid points, "nan" puts a NaN in one key, "inf_bias" makes
    every distance +inf, "nan_ties" puts NaN in keys of lattice tie groups,
    "bias_dup" repeats lattice keys with a bias of a few repeated values."""
    b, m, n, c, _, with_bias, cloud = spec
    if cloud in ("lattice", "nan_ties", "bias_dup"):
        keys = np.tile(rng.randint(-2, 3, (b, -(-n // 8), c)).astype(np.float32) * 0.5, (1, 8, 1))[:, :n]
        queries = keys[:, rng.choice(n, m, replace=m > n)] + np.float32(0.25)
    else:
        queries = (rng.rand(b, m, c) * 2 - 1).astype(np.float32)
        keys = queries[:, :n].copy() if cloud == "subset" else (rng.rand(b, n, c) * 2 - 1).astype(np.float32)
    if cloud == "nan":
        keys[1, 7, 0] = np.nan
    if cloud == "nan_ties":  # some copies of a lattice point, the others left as they are
        keys[:, 3::13, 1] = np.nan
    bias = (0.1 * rng.rand(b, n)).astype(np.float32) if with_bias else None
    if cloud == "inf_bias":
        bias = np.full((b, n), np.inf, np.float32)
    if cloud == "bias_dup":
        bias = rng.choice(np.float32([0.0, 0.125, 0.25]), (b, n)).astype(np.float32)
    return np.ascontiguousarray(queries), np.ascontiguousarray(keys), bias


@pytest.mark.parametrize("case", sorted(KNN_CASES))
def test_knn_kernel_matches_plain(dev, case):
    spec = KNN_CASES[case]
    q, keys, bias = (None if a is None else torch.from_numpy(a).to(dev)
                     for a in knn_inputs(spec, np.random.RandomState(spec[1] + spec[2])))
    k = spec[4]
    before, tiled = knn_point_kernel.launches, knn_point_kernel.tiled_launches
    fullsort = knn_point_kernel.fullsort_launches
    d, i = knn_point_kernel(q, keys, k, bias)
    ref_d, ref_i = knn_point_plain(q, keys, k, bias)
    torch.cuda.synchronize()
    assert knn_point_kernel.launches == before + 1
    assert knn_point_kernel.tiled_launches == tiled + (k > 64 and spec[2] > 16384)
    fits = knn_kernel.select_smem_bytes(spec[2], k) <= knn_kernel.SMEM_MAX
    assert knn_point_kernel.fullsort_launches == fullsort + (k > 64 and not fits)
    assert d.dtype == torch.float32 and i.dtype == torch.int32 and d.shape == (spec[0], spec[1], k)
    assert torch.equal(i, ref_i) and torch.equal(d, ref_d)
    if case == "fp1":
        assert bool(torch.isinf(d[..., 1:]).all()) and bool((i[..., 1:] == 0).all())
    if case == "fp3":
        assert bool((d[:, :512, 0] == 0).all())  # a query equal to a key: exactly 0
    if case == "nan_key":
        assert not bool((i[1] == 7).any())
    if case in ("k48_few_keys", "k100_few_keys"):
        n_keys = spec[2]
        assert bool(torch.isinf(d[..., n_keys:]).all()) and bool((i[..., n_keys:] == 0).all())
        assert bool(torch.isfinite(d[..., :n_keys]).all())
    if case in ("k80_c7_nan_key", "k128_n50000_nan_key"):
        assert not bool((i[1] == 7).any())
    if case.endswith("all_inf"):
        assert bool(torch.isinf(d).all()) and bool((i == 0).all())
    nan_key = torch.isnan(keys).any(-1)  # [b, n]: never selected
    assert not bool((torch.gather(nan_key, 1, i.long().flatten(1)).view_as(d) & torch.isfinite(d)).any())


# Every route a plan may give, forced at cases of each kind: the group route
# at 1, 4 and 32 lanes a query up to k = 16, the warp route up to k = 64,
# the selection at any k and the full sort above k = 64.
ROUTE_CASES = ("fp3", "k16_bias", "c64", "k31", "k32_c64", "k33_bias", "k48_duplicates", "k64_n2431",
               "m1_k3", "m3_k16", "m33_k40", "k8_few_keys", "k40_few_keys", "k31_lattice", "k64_lattice",
               "k40_all_inf", "k40_nan_ties", "k48_bias_duplicates", "k65", "k127", "k128_bias",
               "k127_few_keys", "k127_lattice", "k100_all_inf", "k100_nan_ties", "k100_bias_duplicates",
               "k65_bias_n2431", "k128_n20000_bias")


def _routes_for(k):
    if k <= 16:
        return [("group", 1), ("group", 4), ("group", 32), ("warp", 1), ("select", 1)]
    if k <= 64:
        return [("warp", 1), ("select", 1)]
    return [("select", 1), ("sort", 1)]


@pytest.mark.parametrize("case", ROUTE_CASES)
def test_knn_kernel_every_route_matches_plain(dev, case):
    spec = KNN_CASES[case]
    q, keys, bias = (None if a is None else torch.from_numpy(a).to(dev)
                     for a in knn_inputs(spec, np.random.RandomState(spec[1] + spec[2])))
    k = spec[4]
    ref_d, ref_i = knn_point_plain(q, keys, k, bias)
    for plan in _routes_for(k):
        with mock.patch.object(knn_kernel, "point_plan", lambda *a, plan=plan: plan):
            warp = knn_point_kernel.warp_launches
            d, i = knn_point_kernel(q, keys, k, bias)
            torch.cuda.synchronize()
            assert knn_point_kernel.warp_launches == warp + (plan[0] == "warp")
        assert torch.equal(i, ref_i) and torch.equal(d, ref_d), plan


def test_knn_kernel_refuses_a_plan_it_cannot_run(dev):
    # Group lanes that are no power of two or above 32; the group route
    # above k = 16 and the warp route above k = 64; the selection past a
    # block's shared memory (k = 20000 on 50000 keys: two tiles of words); a
    # route that does not exist.
    q = torch.zeros(1, 8, 3, device=dev)
    big = torch.zeros(1, 50000, 3, device=dev)
    for keys, k, plan in ((q, 3, ("group", 3)), (q, 3, ("group", 64)), (big, 17, ("group", 1)),
                          (big, 65, ("warp", 1)), (big, 20000, ("select", 1))):
        with mock.patch.object(knn_kernel, "point_plan", lambda *a, plan=plan: plan):
            with pytest.raises(RuntimeError, match="cudaError_t"):
                knn_point_kernel(q, keys, k)
    with mock.patch.object(knn_kernel, "ROUTES", knn_kernel.ROUTES + ("none",)), \
            mock.patch.object(knn_kernel, "point_plan", lambda *a: ("none", 1)):
        with pytest.raises(RuntimeError, match="cudaError_t"):
            knn_point_kernel(q, q, 3)
    torch.cuda.synchronize()  # no error left behind


@pytest.mark.parametrize("c", [3, 7, 64])
def test_knn_point_kernels_use_no_local_memory(dev, c):
    # Every list capacity of the group route, both warp lists, the selection
    # (one tile and tiled) and the full sort.
    builds = [("group", 1024, k) for k in (3, 8, 16)] + [("warp", 1024, 20), ("warp", 1024, 40)]
    builds += [("select", 1024, 128), ("select", 50000, 128), ("sort", 1024, 128), ("sort", 50000, 20000)]
    for route, n, k in builds:
        if route == "warp" and knn_kernel.warp_tile(n, c) < 32:
            continue
        info = point_kernel_info(route, n, c, k, lanes=4 if route == "group" else 1)
        assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 1, (route, n, c, k, info)


def test_three_nn_launches_the_knn_kernel(dev):
    q, keys, _ = (torch.from_numpy(a).to(dev) if a is not None else None
                  for a in knn_inputs(KNN_CASES["fp2"], np.random.RandomState(0)))
    before = knn_point_kernel.launches
    d, i = interpolate.three_nn(q, keys)
    ref_d, ref_i = knn_point_plain(q, keys, 3)
    torch.cuda.synchronize()
    assert knn_point_kernel.launches == before + 1 and torch.equal(i, ref_i) and torch.equal(d, ref_d)


def test_knn_kernel_refuses_what_it_does_not_take(dev):
    q = torch.zeros(1, 8, 3, device=dev)
    with pytest.raises(ValueError, match="k >= 1"):
        knn_point_kernel(q, q, 0)
    # k > 64 on more than 16384 keys, refused before the sorted tiles were
    # merged, now answers as the plain version does.
    big = torch.zeros(1, 16385, 3, device=dev)
    d, i = knn_point_kernel(q, big, 65)
    ref_d, ref_i = knn_point_plain(q, big, 65)
    assert torch.equal(i, ref_i) and torch.equal(d, ref_d)
    with pytest.raises(ValueError, match="float32"):
        knn_point_kernel(q.double(), q, 3)
    with pytest.raises(ValueError, match="contiguous"):
        knn_point_kernel(torch.zeros(1, 3, 8, device=dev).transpose(1, 2), q, 3)
    with pytest.raises(ValueError, match="bias"):
        knn_point_kernel(q, q, 3, torch.zeros(1, 9, device=dev))


def lattice_cloud(rng, b, n, c, copies=4):
    """Dyadic lattice points, each repeated ``copies`` times, shuffled: the
    distances tie exactly (duplicates at d² = 0)."""
    base = rng.randint(-3, 4, (b, n // copies, c)).astype(np.float32) * 0.25
    return np.stack([p[rng.permutation(n)] for p in np.tile(base, (1, copies, 1))])


def straddling_lattice(rng, b, n, c):
    """Dyadic lattice points with exact duplicates at indices 31/32, 63/64
    and 127/128: distance ties across the graph kernel's 32-key chunks and
    64-key tiles."""
    x = rng.randint(-3, 4, (b, n, c)).astype(np.float32) * 0.25
    for lo in (31, 63, 127):
        if lo + 1 < n:
            x[:, lo + 1] = x[:, lo]
    return x


def graph_cloud(rng, b, n, c, cloud):
    if cloud == "lattice":
        return lattice_cloud(rng, b, n, c)
    if cloud == "straddle":
        return straddling_lattice(rng, b, n, c)
    x = rng.randn(b, n, c).astype(np.float32)  # "normal", "line" (C = 1), "unaligned"
    if cloud in ("nan", "inf"):  # one row of cloud 1 and one of cloud 0
        x[1, n // 3, c - 1] = np.nan if cloud == "nan" else np.inf
        x[0, n - 2, 0] = np.nan if cloud == "nan" else -np.inf
    return x


# (b, n, c, k, cloud): DGCNN's graphs at C=3 (T-Net, EdgeConv 1) and C=64
# (EdgeConv 2-4) at k=20, over several shared-memory tiles at C=64; a
# generic width; k=8 and k=32; a ragged N; duplicated points.  The tiled
# kernel's edges: k = 1, 2, 31, 32; C = 1, 65 (two channel slices), 128;
# N that is not a multiple of its 64-query and 64-key tiles; ties across
# its 32-key chunks and tiles; NaN and +-inf rows (never selected).
GRAPH_CASES = {
    "c3_k1_n33": (2, 33, 3, 1, "normal"),
    "c64_k2_n65": (2, 65, 64, 2, "normal"),
    "c64_k31_n129": (2, 129, 64, 31, "normal"),
    "c3_k32_n1000": (2, 1000, 3, 32, "normal"),
    "c1_k5": (2, 300, 1, 5, "line"),  # its expansion rounds close neighbours to 0: the self edge may not lead
    "c65_k20": (2, 300, 65, 20, "normal"),
    "c128_k20_n1000": (2, 1000, 128, 20, "normal"),
    "straddle_c3_k20": (2, 160, 3, 20, "straddle"),
    "straddle_c3_k32": (2, 160, 3, 32, "straddle"),
    "straddle_c64_k20": (2, 160, 64, 20, "straddle"),
    "straddle_c64_k32": (2, 160, 64, 32, "straddle"),
    "nan_rows_c3": (2, 300, 3, 20, "nan"),
    "nan_rows_c64": (2, 300, 64, 20, "nan"),
    "inf_rows_c3": (2, 300, 3, 20, "inf"),
    "inf_rows_c64": (2, 300, 64, 20, "inf"),
    "unaligned_c64": (2, 300, 64, 20, "unaligned"),  # not on 16 bytes: the run-time width
    "c3_k20": (4, 1024, 3, 20, "normal"),
    "c64_k20": (4, 1024, 64, 20, "normal"),
    "c16_k8": (2, 300, 16, 8, "normal"),
    "c64_k32": (2, 257, 64, 32, "normal"),
    "c5_k3": (3, 37, 5, 3, "normal"),
    "duplicates_c3": (4, 1024, 3, 20, "lattice"),
    "duplicates_c64": (2, 512, 64, 20, "lattice"),
    # k > 32: the general kNN kernel with the cloud as its queries (its
    # register lists up to k = 64, the sort above).
    "c3_k33": (2, 300, 3, 33, "normal"),
    "c64_k40": (2, 1024, 64, 40, "normal"),
    "c3_k40": (4, 1024, 3, 40, "normal"),
    "c5_k64": (2, 257, 5, 64, "normal"),
    "duplicates_c3_k40": (2, 512, 3, 40, "lattice"),
    "c3_k100_sort": (2, 300, 3, 100, "normal"),
}


@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_knn_graph_kernel_matches_plain(dev, case):
    b, n, c, k, cloud = GRAPH_CASES[case]
    rng = np.random.RandomState(n + c)
    x = torch.from_numpy(graph_cloud(rng, b, n, c, cloud)).to(dev)
    if cloud == "unaligned":  # the same values one float into a larger buffer
        x = torch.cat([x.new_zeros(1), x.flatten()])[1:].view(b, n, c)
    before, routed = knn_graph_kernel.launches, knn_graph_kernel.routed_launches
    idx = knn_graph_kernel(x, k)
    want = knn_graph_plain(x, k)
    again = knn_graph_kernel(x, k)
    torch.cuda.synchronize()
    assert knn_graph_kernel.launches == before + 2
    assert knn_graph_kernel.routed_launches == routed + 2 * (k > 32)
    assert idx.dtype == torch.int32 and idx.shape == (b, n, k)
    assert torch.equal(idx, want)
    assert torch.equal(again, idx)  # the same bits twice
    if cloud == "normal":
        assert bool((idx[..., 0] == torch.arange(n, device=dev)).all())  # the self edge first


@pytest.mark.parametrize("c", [3, 64, 65])
def test_graph_and_fps_kernels_use_no_local_memory(dev, c):
    info = graph_kernel_info(c)
    assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 1, info
    for n in (512, 1024, 2048, 8192, 9000):
        info = fps_kernel_info(n)
        assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 1, (n, info)


def test_knn_graph_kernel_refuses_what_it_does_not_take(dev):
    x = torch.zeros(1, 8, 3, device=dev)
    with pytest.raises(ValueError, match="k >= 1"):
        knn_graph_kernel(x, 0)
    # k > 32, refused before the graph took the general kernel, now answers
    # as the plain version does.
    assert torch.equal(knn_graph_kernel(x, 33), knn_graph_plain(x, 33))
    with pytest.raises(ValueError, match="float32"):
        knn_graph_kernel(x.double(), 3)
    with pytest.raises(ValueError, match="contiguous"):
        knn_graph_kernel(torch.zeros(1, 3, 8, device=dev).transpose(1, 2), 3)


def _edge_inputs(dev, b, n, cf, cv, lattice, seed):
    rng = np.random.RandomState(seed)
    if lattice:
        feats = lattice_cloud(rng, b, n, cf)
        vals = np.concatenate([lattice_cloud(rng, b, n, cv - 2), np.zeros((b, n, 2), np.float32)], -1)
    else:
        feats = rng.randn(b, n, cf).astype(np.float32)
        vals = rng.randn(b, n, cv).astype(np.float32)
    return torch.from_numpy(feats).to(dev), torch.from_numpy(vals).to(dev)


# (b, n, cf, cv, k, lattice): EdgeConv 1-4's (Cf, Cv) at k=20, a width that
# takes the scalar path, and duplicated points whose values tie in max/min.
# The staged backward's plan: Cv = 1 (a one-channel slice), 8 (one slice),
# 24, 65 (a ragged last slice), 256; N = 1, 33, 300, 1025; slices of 8, 4,
# 2 and 1 channels (N = 1024, 2048, 4842, 9685) and the per-edge route
# just past them (N = 9686); k = 1, 20, 40.
EDGE_CASES = {
    "ec1": (4, 1024, 3, 64, 20, False),
    "ec2": (4, 1024, 64, 64, 20, False),
    "ec4": (4, 1024, 64, 128, 20, False),
    "cv24_k8": (2, 300, 16, 24, 8, False),
    "ties": (2, 512, 3, 34, 20, True),
    "ec2_k40": (2, 512, 64, 64, 40, False),  # the graph through the general kNN
    "cv1": (2, 300, 3, 1, 20, False),
    "cv8": (2, 300, 3, 8, 20, False),
    "cv65": (2, 300, 16, 65, 20, False),
    "cv256": (2, 1024, 64, 256, 20, False),
    "n1_k1": (3, 1, 3, 16, 1, False),
    "n33": (2, 33, 3, 64, 20, False),
    "n1025": (2, 1025, 3, 64, 20, False),
    "k1": (2, 300, 3, 64, 1, False),
    "ties_k40": (2, 512, 3, 34, 40, True),
    "slice4_n2048": (2, 2048, 3, 20, 20, False),
    "slice2_n4842": (1, 4842, 3, 12, 20, False),
    "slice1_n9685": (1, 9685, 3, 5, 20, False),
    "route_n9686": (1, 9686, 3, 5, 20, False),
    # The forward's batches and index chunks: k = 1, 7 (a ragged batch) and
    # 33 (two chunks of 32 indices; the graph through the general kNN), at
    # Cv = 1, 24, 64, 128 (4 floats a lane) and 256 (two passes).
    "k1_cv1": (2, 300, 3, 1, 1, False),
    "k1_cv24": (2, 300, 16, 24, 1, False),
    "k1_cv128": (2, 300, 3, 128, 1, False),
    "k1_cv256": (2, 300, 3, 256, 1, False),
    "k7_cv1": (2, 300, 3, 1, 7, False),
    "k7_cv24": (2, 300, 16, 24, 7, False),
    "k7_cv64": (2, 300, 3, 64, 7, False),
    "k7_cv128": (2, 300, 3, 128, 7, False),
    "k7_cv256": (2, 300, 3, 256, 7, False),
    "k33_cv1": (2, 300, 3, 1, 33, False),
    "k33_cv24": (2, 300, 16, 24, 33, False),
    "k33_cv64": (2, 300, 3, 64, 33, False),
    "k33_cv128": (2, 300, 3, 128, 33, False),
    "k33_cv256": (1, 300, 3, 256, 33, False),
}


def same_bits(a, b) -> bool:
    """Equal where not NaN, and NaN at the same places."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_edge_reduce_kernels_match_plain(dev, case):
    b, n, cf, cv, k, lattice = EDGE_CASES[case]
    feats, vals = _edge_inputs(dev, b, n, cf, cv, lattice, seed=n + cv)
    routed = edge_reduce_bwd_kernel.routed_launches
    before = (knn_graph_kernel.launches, edge_reduce_fwd_kernel.launches, edge_reduce_bwd_kernel.launches)
    v = vals.clone().requires_grad_()
    got = edge_reduce(feats, v, k)
    vp = vals.clone().requires_grad_()
    want = edge_reduce_plain(feats, vp, k)
    for key in ("idx",) + REDUCTIONS:
        assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key].detach()), key
    if lattice:
        assert float(got["cntmax"].max()) > 1 and bool((got["cntmin"][..., -2:] == k).all())
    rng = np.random.RandomState(1)
    cot = [torch.from_numpy(rng.randn(b, n, cv).astype(np.float32)).to(dev) for _ in range(4)]
    outs = [got[key] for key in ("mmax", "mmin", "s", "q2")]
    (grad,) = torch.autograd.grad(outs, v, cot)
    again = edge_reduce_bwd_kernel(vals, got["idx"], got["mmax"], got["mmin"], got["cntmax"], got["cntmin"], *cot)
    (ref,) = torch.autograd.grad([want[key] for key in ("mmax", "mmin", "s", "q2")], vp, cot)
    ordered = edge_reduce_bwd_ordered(vals, got["idx"], got["mmax"], got["mmin"], got["cntmax"], got["cntmin"], *cot)
    torch.cuda.synchronize()
    after = (knn_graph_kernel.launches, edge_reduce_fwd_kernel.launches, edge_reduce_bwd_kernel.launches)
    assert after == (before[0] + 1, before[1] + 1, before[2] + 2)
    assert (bwd_slice_width(n, cv) == 0) == (n > 9685)
    assert edge_reduce_bwd_kernel.routed_launches == routed + 2 * (n > 9685)  # the per-edge route
    assert torch.equal(grad, again), "the backward is not bit-stable"
    assert torch.equal(grad, ordered), "the backward differs from edge_reduce_bwd_ordered"
    scale = max(1.0, float(ref.abs().max()))
    assert float((grad - ref).abs().max()) <= EDGE_BWD_TOL * scale


@pytest.mark.parametrize("n", [300, 9686])
def test_edge_reduce_bwd_with_nan_values_matches_ordered(dev, n):
    # A NaN value: max and min keep it (as torch.amax does), the NaN point's
    # own sum is NaN, and g == NaN never holds, so the queries whose max is
    # NaN pass no max term on.  Autograd through amax spreads NaN there
    # instead, so the bits are held to the ordered version, NaN for NaN
    # (staged kernel at N = 300, per-edge route at N = 9686).  The forward's
    # tie counts where the max or min is NaN are the kernel's own (it counts
    # the NaN slot, the plain version's == counts nothing); the backward
    # reads them only where g equals a max or min that is not NaN.
    feats, vals = _edge_inputs(dev, 1, n, 3, 16, False, seed=5)
    vals[0, 7, 3] = float("nan")
    vals[0, n // 2, :] = float("nan")
    got = edge_reduce(feats, vals, 20)
    want = edge_reduce_plain(feats, vals, 20)
    for key in ("idx", "mmax", "mmin", "s", "q2"):
        assert same_bits(got[key], want[key]), key
    assert bool(torch.isnan(got["mmax"]).any())
    rng = np.random.RandomState(6)
    cot = [torch.from_numpy(rng.randn(1, n, 16).astype(np.float32)).to(dev) for _ in range(4)]
    saved = (vals, got["idx"], got["mmax"], got["mmin"], got["cntmax"], got["cntmin"])
    grad, again = edge_reduce_bwd_kernel(*saved, *cot), edge_reduce_bwd_kernel(*saved, *cot)
    ordered = edge_reduce_bwd_ordered(*saved, *cot)
    torch.cuda.synchronize()
    assert same_bits(grad, again) and same_bits(grad, ordered)
    assert bool(torch.isnan(grad).any()) and bool(torch.isfinite(grad).any())


def _fwd_in_slot_order(vals, idx):
    """The forward's six outputs by its rules, slot by slot: max and min
    keep a NaN, a tie count grows by one where a slot equals the running
    max (min), is reset to 1 where a slot exceeds it, and holds where a NaN
    arrives or the max is NaN; the sums in slot order."""
    rows = torch.arange(vals.shape[0], device=vals.device)[:, None, None]
    g = vals[rows, idx.long()]  # [B, N, k, Cv]
    mx = mn = s = g[:, :, 0]
    q = g[:, :, 0] * g[:, :, 0]
    cx = cn = torch.ones_like(s)
    for r in range(1, idx.shape[-1]):
        x = g[:, :, r]
        cx = torch.where(x > mx, 1.0, cx + (x == mx).float())
        mx = torch.where((x > mx) | torch.isnan(x), x, mx)
        cn = torch.where(x < mn, 1.0, cn + (x == mn).float())
        mn = torch.where((x < mn) | torch.isnan(x), x, mn)
        s = s + x
        q = q + x * x
    return mx, mn, s, q, cx, cn


@pytest.mark.parametrize("k,cv", [(7, 24), (20, 64), (33, 128), (20, 256)])
def test_edge_reduce_fwd_nan_and_ties_follow_the_slot_order(dev, k, cv):
    # Values that tie (a coarse lattice, a zero channel) with NaN in some
    # neighbours' rows: all six outputs, the NaN tie counts included, bit
    # for bit the slot-order rules.
    feats, vals = _edge_inputs(dev, 2, 300, 3, cv, True, seed=k + cv)
    vals[0, 5, : cv // 2] = float("nan")
    vals[1, 17::29, 1] = float("nan")
    idx = knn_graph_kernel(feats, k)
    got = edge_reduce_fwd_kernel(vals, idx)
    want = _fwd_in_slot_order(vals, idx)
    torch.cuda.synchronize()
    for name, a, b in zip(REDUCTIONS, got, want):
        assert same_bits(a, b), name
    assert bool(torch.isnan(got[0]).any()) and float(got[4].max()) > 1


FWD_PLAN_CASES = ("ec2", "ec4", "cv24_k8", "ties", "cv1", "cv65", "cv256", "n1_k1", "n33", "k7_cv24",
                  "k33_cv128", "k1_cv256")


@pytest.mark.parametrize("case", FWD_PLAN_CASES)
def test_edge_reduce_fwd_at_both_lane_counts_matches_plain(dev, case):
    # A half-warp and a warp a query, and rows off 16 bytes (one float a
    # lane), on the same inputs: every output equal to the plain version.
    b, n, cf, cv, k, lattice = EDGE_CASES[case]
    feats, vals = _edge_inputs(dev, b, n, cf, cv, lattice, seed=n + cv)
    idx = knn_graph_kernel(feats, k)
    want = reduce_neighbors_plain(vals, idx)
    unaligned = torch.cat([vals.new_zeros(1), vals.flatten()])[1:].view(b, n, cv)
    for lanes in (16, 32):
        with mock.patch.object(edge_kernel, "fwd_lanes", lambda cv, lanes=lanes: lanes):
            for v in (vals, unaligned):
                got = edge_reduce_fwd_kernel(v, idx)
                torch.cuda.synchronize()
                for name, a in zip(REDUCTIONS, got):
                    assert torch.equal(a, want[name]), (lanes, name)


def test_edge_reduce_fwd_on_a_large_cloud(dev):
    # 58113 points (more than one channel of a 227 KB shared slice holds)
    # on a random graph (its own kNN would take long here).
    rng = np.random.RandomState(12)
    n, k = 58113, 20
    vals = torch.from_numpy(rng.randn(1, n, 5).astype(np.float32)).to(dev)
    idx = torch.from_numpy(rng.randint(0, n, (1, n, k)).astype(np.int32)).to(dev)
    got = edge_reduce_fwd_kernel(vals, idx)
    want = reduce_neighbors_plain(vals, idx)
    torch.cuda.synchronize()
    for name, a in zip(REDUCTIONS, got):
        assert torch.equal(a, want[name]), name


def test_edge_reduce_fwd_refuses_lanes_it_cannot_run(dev):
    vals = torch.zeros(1, 8, 4, device=dev)
    idx = torch.zeros(1, 8, 3, dtype=torch.int32, device=dev)
    for lanes in (8, 24, 64):
        with mock.patch.object(edge_kernel, "fwd_lanes", lambda cv, lanes=lanes: lanes):
            with pytest.raises(RuntimeError, match="cudaError_t"):
                edge_reduce_fwd_kernel(vals, idx)
    torch.cuda.synchronize()


def test_edge_reduce_bwd_refuses_a_slice_it_cannot_run(dev):
    # Eight channels of 2048 queries need 384 KB of shared memory; a slice
    # of 3 channels is not a width the kernel has.
    feats, vals = _edge_inputs(dev, 1, 2048, 3, 16, False, seed=7)
    red = edge_reduce(feats, vals, 20)
    saved = (vals, red["idx"], red["mmax"], red["mmin"], red["cntmax"], red["cntmin"])
    cot = [torch.ones_like(vals) for _ in range(4)]
    for width in (8, 3):
        with mock.patch.object(edge_kernel, "bwd_slice_width", lambda n, cv, width=width: width):
            with pytest.raises(RuntimeError, match="cudaError_t"):
                edge_reduce_bwd_kernel(*saved, *cot)


def test_edge_and_dupmask_kernels_use_no_local_memory(dev):
    # Every build of edge.cu (the staged backward at each slice width, at the
    # largest cloud it takes; its per-edge route and the forward at 1, 2 and
    # 4 floats a lane, the forward at 16 and 32 lanes a query) and the
    # duplicate mask's.
    for width, n in ((8, 1024), (8, 1210), (4, 2048), (2, 4842), (1, 9685)):
        info = edge_kernel_info("bwd", width, n)
        assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 1, (width, n, info)
    for width in (1, 2, 4):
        info = edge_kernel_info("bwd_edge", width)
        assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 1, ("bwd_edge", width, info)
        for lanes in (16, 32):  # the forward at a half-warp and a warp a query
            info = edge_kernel_info("fwd", width, lanes=lanes)
            assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 1, ("fwd", width, lanes, info)
    info = dupmask_kernel_info()
    assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 2, info  # two 1024-thread blocks an SM


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_edge_gather_knn_matches_plain(dev, dtype):
    feats, vals = _edge_inputs(dev, 4, 1024, 3, 64, False, seed=9)
    vals = vals.to(dtype)
    before = (edge_gather_knn.launches, edge_gather_knn.fused_launches, knn_graph_kernel.launches,
              gather_rows.launches, scatter_add_rows.launches)
    v = vals.clone().requires_grad_()
    rows, idx = edge_gather_knn(feats, v, 20)
    vp = vals.clone().requires_grad_()
    want, want_idx = edge_gather_knn_plain(feats, vp, 20)
    assert rows.dtype == want.dtype == dtype and torch.equal(idx, want_idx) and torch.equal(rows, want)
    cot = torch.from_numpy(np.random.RandomState(2).randn(*rows.shape).astype(np.float32)).to(dev).to(dtype)
    (grad,) = torch.autograd.grad(rows, v, cot)
    (ref,) = torch.autograd.grad(want, vp, cot)
    torch.cuda.synchronize()
    after = (edge_gather_knn.launches, edge_gather_knn.fused_launches, knn_graph_kernel.launches,
             gather_rows.launches, scatter_add_rows.launches)
    # One fused launch (graph and gather), no graph or gather launch of their
    # own, the scatter-add once for the backward.
    assert after == (before[0] + 1, before[1] + 1, before[2], before[3], before[4] + 1)
    assert grad.dtype == dtype
    if dtype == torch.float32:
        assert float((grad - ref).abs().max()) <= SCATTER_TOL * max(1.0, float(ref.abs().max()))


def _graph_then_gather(feats, vals, k):
    """The two-kernel composition the fused kernel replaced at k <= 32: the
    graph kernel, then the gather kernel over f32 rows, in vals.dtype."""
    idx = knn_graph_kernel(feats.float().contiguous(), k)
    b, n, _ = idx.shape
    rows = gather_rows(vals.float().contiguous(), idx.reshape(b, n * k)).reshape(b, n, k, vals.shape[-1])
    return rows.to(vals.dtype), idx


# (b, n, cf, cv, k, cloud): the fused kernel at k = 1, 20 and 32 and the
# routed composition at k = 33; Cv = 1, 3 (its rows a run of words), 64
# (a float2 a lane), 128; N off the 64-key tile; duplicated points (ties);
# NaN feature rows (never a neighbour).
EDGE_GATHER_CASES = {
    "k1_cv64": (2, 300, 3, 64, 1, "normal"),
    "k20_cv1": (2, 1000, 3, 1, 20, "normal"),
    "k20_cv3_spider": (4, 1024, 3, 3, 20, "normal"),
    "k20_cv128_c64": (2, 257, 64, 128, 20, "normal"),
    "k32_cv64": (2, 1000, 3, 64, 32, "normal"),
    "k33_cv64": (2, 300, 3, 64, 33, "normal"),
    "k20_cv64_duplicates": (2, 512, 3, 64, 20, "lattice"),
    "k20_cv3_nan": (2, 300, 3, 3, 20, "nan"),
    "k32_cv5_c64_nan": (2, 300, 64, 5, 32, "nan"),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(EDGE_GATHER_CASES))
def test_edge_gather_knn_fused_and_routed_match_plain(dev, case, dtype):
    b, n, cf, cv, k, cloud = EDGE_GATHER_CASES[case]
    rng = np.random.RandomState(n + cv + k)
    feats = torch.from_numpy(graph_cloud(rng, b, n, cf, cloud)).to(dev)
    vals = torch.from_numpy(rng.randn(b, n, cv).astype(np.float32)).to(dev).to(dtype)
    before = (edge_gather_knn.fused_launches, edge_gather_knn.routed_launches, gather_rows.launches)
    v = vals.clone().requires_grad_()
    rows, idx = edge_gather_knn(feats, v, k)
    torch.cuda.synchronize()
    fused = k <= edge_kernel.FUSED_MAX_K
    after = (edge_gather_knn.fused_launches, edge_gather_knn.routed_launches, gather_rows.launches)
    assert after == (before[0] + fused, before[1] + (not fused), before[2] + (not fused))
    want, want_idx = edge_gather_knn_plain(feats, vals, k)
    two, two_idx = _graph_then_gather(feats, vals, k)
    assert rows.dtype == dtype and rows.shape == (b, n, k, cv)
    assert torch.equal(idx, want_idx) and torch.equal(idx, two_idx)
    assert torch.equal(rows, want) and torch.equal(rows, two)
    cot = torch.from_numpy(np.random.RandomState(5).randn(*rows.shape).astype(np.float32)).to(dev).to(dtype)
    (grad,) = torch.autograd.grad(rows, v, cot)
    vp = vals.clone().requires_grad_()
    (ref,) = torch.autograd.grad(edge_gather_knn_plain(feats, vp, k)[0], vp, cot)
    assert grad.dtype == dtype
    if dtype == torch.float32:
        assert float((grad - ref).abs().max()) <= SCATTER_TOL * max(1.0, float(ref.abs().max()))


def test_edge_gather_knn_fused_refuses_what_it_does_not_take(dev):
    feats = torch.zeros(1, 64, 3, device=dev)
    with pytest.raises(ValueError, match="fused kernel"):
        edge_kernel._graph_gather_kernel(feats, torch.zeros(1, 64, 8, device=dev, dtype=torch.float16), 20)
    with pytest.raises(ValueError, match="fused kernel"):
        edge_kernel._graph_gather_kernel(feats, torch.zeros(1, 64, 8, device=dev), 33)
    with pytest.raises(ValueError, match="contiguous"):
        edge_kernel._graph_gather_kernel(feats, torch.zeros(1, 8, 64, device=dev).transpose(1, 2), 20)


def test_edge_gather_knn_at_k40_matches_plain(dev):
    feats, vals = _edge_inputs(dev, 2, 1024, 3, 64, False, seed=10)
    routed = knn_graph_kernel.routed_launches
    v = vals.clone().requires_grad_()
    rows, idx = edge_gather_knn(feats, v, 40)
    vp = vals.clone().requires_grad_()
    want, want_idx = edge_gather_knn_plain(feats, vp, 40)
    assert torch.equal(idx, want_idx) and torch.equal(rows, want)
    cot = torch.from_numpy(np.random.RandomState(3).randn(*rows.shape).astype(np.float32)).to(dev)
    (grad,) = torch.autograd.grad(rows, v, cot)
    (ref,) = torch.autograd.grad(want, vp, cot)
    torch.cuda.synchronize()
    assert knn_graph_kernel.routed_launches == routed + 1
    assert float((grad - ref).abs().max()) <= SCATTER_TOL * max(1.0, float(ref.abs().max()))


def test_edge_reduce_kernels_refuse_what_they_do_not_take(dev):
    vals = torch.zeros(1, 8, 4, device=dev)
    idx = torch.zeros(1, 8, 3, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int32"):
        edge_reduce_fwd_kernel(vals, idx.long())
    with pytest.raises(ValueError, match="float32"):
        edge_reduce_fwd_kernel(vals.double(), idx)
    with pytest.raises(ValueError, match="contiguous"):
        edge_reduce_fwd_kernel(torch.zeros(1, 4, 8, device=dev).transpose(1, 2), idx)


# (b, n, k, c, t, o): SpiderCNN's conv1-4 at k=20 (conv1: C=3, R=300), a
# ragged case (rows, r and o not multiples of any tile; T=3), k=32 with a
# wide T, T=64 (a 64-deep chunk a channel), O and T not multiples of 8, and
# O above 128 (two column tiles) with a last row tile cut short.
SPIDER_CASES = {
    "conv1": (2, 1024, 20, 3, 5, 32),
    "conv2": (2, 1024, 20, 32, 5, 64),
    "conv3": (2, 1024, 20, 64, 5, 128),
    "conv4": (2, 1024, 20, 128, 5, 256),
    "ragged": (3, 77, 7, 11, 3, 70),
    "k32_t9": (1, 300, 32, 16, 9, 48),
    "t64": (2, 50, 4, 3, 64, 33),
    "odd_o_t": (1, 130, 5, 7, 7, 5),
    "o200_short_tile": (2, 129, 3, 8, 1, 200),
}


def _spider_inputs(dev, spec, seed):
    b, n, k, c, t, o = spec
    rng = np.random.RandomState(seed)
    feat = rng.randn(b, n, c).astype(np.float32)
    idx = rng.randint(0, n, (b, n, k)).astype(np.int32)
    idx[..., 0] = np.arange(n)  # the self edge, as the kNN gives it
    g = rng.randn(b, n, k, t).astype(np.float32)
    kernel = (rng.randn(k * c * t, o) * np.sqrt(2.0 / (k * c * t + o))).astype(np.float32)
    dout = rng.randn(b, n, o).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (feat, idx, g, kernel, dout)]


@pytest.mark.parametrize("case", sorted(SPIDER_CASES))
def test_spider_conv_kernels_match_plain(dev, case):
    feat, idx, g, kernel, dout = _spider_inputs(dev, SPIDER_CASES[case], seed=len(case))
    before = (spider_conv_fwd_kernel.launches, spider_conv_bwd_kernel.launches, scatter_add_rows.launches)
    leaves = [t.clone().requires_grad_() for t in (feat, g, kernel)]
    out = spider_conv(leaves[0], idx, leaves[1], leaves[2])
    grads = torch.autograd.grad(out, leaves, dout)
    again = spider_conv_bwd_kernel(feat, idx, g, kernel, dout)
    plain = [t.clone().requires_grad_() for t in (feat, g, kernel)]
    ref = spider_conv_plain(plain[0], idx, plain[1], plain[2])
    ref_grads = torch.autograd.grad(ref, plain, dout)
    torch.cuda.synchronize()
    after = (spider_conv_fwd_kernel.launches, spider_conv_bwd_kernel.launches, scatter_add_rows.launches)
    assert after == (before[0] + 1, before[1] + 2, before[2] + 2)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    scale = max(1.0, float(ref.detach().abs().max()))
    assert float((out - ref).detach().abs().max()) <= SPIDER_FWD_TOL * scale
    for name, got, twice, want in zip(("dfeat", "dg", "dkernel"), grads, again, ref_grads):
        assert got.dtype == torch.float32 and got.shape == want.shape, name
        assert torch.equal(got, twice), f"{name}: the backward is not bit-stable"
        err = float((got - want).abs().max())
        assert err <= SPIDER_BWD_TOL * max(1.0, float(want.abs().max())), (name, err)


def test_spider_conv_forward_gives_nan_rows_for_bad_indices(dev):
    feat, idx, g, kernel, _ = _spider_inputs(dev, SPIDER_CASES["o200_short_tile"], seed=6)
    b, n = idx.shape[:2]
    idx[0, 5, 1], idx[1, 9, 2] = -1, n
    bad = torch.zeros(b, n, dtype=torch.bool, device=dev)
    bad[0, 5] = bad[1, 9] = True
    got = spider_conv_fwd_kernel(feat, idx, g, kernel)
    fixed = idx.clone()
    fixed[0, 5, 1], fixed[1, 9, 2] = 0, 0
    want = spider_conv_plain(feat, fixed, g, kernel)
    torch.cuda.synchronize()
    assert bool(torch.isnan(got[bad]).all()) and bool(torch.isfinite(got[~bad]).all())
    scale = max(1.0, float(want.abs().max()))
    assert float((got[~bad] - want[~bad]).abs().max()) <= SPIDER_FWD_TOL * scale


def test_spider_conv_skips_dfeat_without_a_gradient(dev):
    feat, idx, g, kernel, dout = _spider_inputs(dev, SPIDER_CASES["ragged"], seed=3)
    kernel.requires_grad_()
    before = (spider_conv_bwd_kernel.launches, scatter_add_rows.launches)
    (grad,) = torch.autograd.grad(spider_conv(feat, idx, g, kernel), kernel, dout)
    torch.cuda.synchronize()
    assert (spider_conv_bwd_kernel.launches, scatter_add_rows.launches) == (before[0] + 1, before[1])
    assert torch.equal(grad, spider_conv_bwd_kernel(feat, idx, g, kernel.detach(), dout)[2])


def test_spider_conv_kernels_refuse_what_they_do_not_take(dev):
    feat, idx, g, kernel, dout = _spider_inputs(dev, SPIDER_CASES["ragged"], seed=4)
    with pytest.raises(ValueError, match="int32"):
        spider_conv_fwd_kernel(feat, idx.long(), g, kernel)
    with pytest.raises(ValueError, match="float32"):
        spider_conv_fwd_kernel(feat.double(), idx, g, kernel)
    with pytest.raises(ValueError, match="contiguous"):
        spider_conv_fwd_kernel(feat, idx, g, kernel.t().contiguous().t())
    with pytest.raises(ValueError, match="kernel"):
        spider_conv_fwd_kernel(feat, idx, g, kernel[1:])
    with pytest.raises(ValueError, match="T <= 64"):
        spider_conv_fwd_kernel(feat, idx, g.repeat(1, 1, 1, 22), kernel.repeat(22, 1))
    with pytest.raises(ValueError, match="dout"):
        spider_conv_bwd_kernel(feat, idx, g, kernel, dout[:, 1:])


def dup_cloud(rng, b, n):
    """Random points with exact copies of earlier (and of later) points, a
    -0.0/0.0 pair, NaN points and a NaN point's copy (clouds of more than
    four points)."""
    x = (rng.rand(b, n, 3) * 2 - 1).astype(np.float32)
    for c in range(b):
        src = rng.choice(n, n // 8, replace=False)
        dst = rng.choice(n, n // 8, replace=False)
        x[c, dst] = x[c, src]
    if n > 4:
        x[:, 3] = (0.0, 0.5, -0.25)
        x[:, n - 2] = (-0.0, 0.5, -0.25)
        x[0, 5, 1] = np.nan
        x[0, n // 2] = x[0, 5]
    return x


@pytest.mark.parametrize("b,n", [(32, 1024), (32, 384), (3, 1000), (2, 129), (1, 1),
                                 # the 128-point tiles' edges; above 2048 points the
                                 # earlier points are staged a chunk at a time
                                 (2, 2), (2, 127), (2, 128), (2, 1023), (2, 1025), (2, 4096), (1, 5000)])
def test_duplicate_mask_kernel_matches_plain(dev, b, n):
    x = torch.from_numpy(dup_cloud(np.random.RandomState(n), b, n)).to(dev)
    before = duplicate_mask_kernel.launches
    got = duplicate_mask_kernel(x)
    want = duplicate_mask_plain(x)
    torch.cuda.synchronize()
    assert duplicate_mask_kernel.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (b, n)
    assert torch.equal(got, want)
    if n > 4:
        assert float(got[:, n - 2].min()) == 1.0  # -0.0 repeats 0.0
        assert float(got[0, 5]) == 0.0 and float(got[0, n // 2]) == 0.0  # NaN never equals
        assert 0 < float(want.sum()) < b * n


@pytest.mark.parametrize("n", [1, 2, 129, 1024, 4096])
def test_duplicate_mask_kernel_on_one_point_repeated(dev, n):
    # Every point but the first repeats it (in the second cloud its x
    # alternates 0.0 and -0.0, equal under ==).
    x = torch.full((2, n, 3), 0.25, device=dev)
    x[1, :, 0] = torch.tensor([0.0, -0.0], device=dev).repeat(n)[:n]
    got = duplicate_mask_kernel(x)
    torch.cuda.synchronize()
    assert torch.equal(got, duplicate_mask_plain(x))
    assert float(got[:, 0].max()) == 0.0 and bool((got[:, 1:] == 1.0).all())


@pytest.mark.parametrize("n", [1, 2, 129, 1024, 4096])
def test_duplicate_mask_kernel_without_duplicates(dev, n):
    # Distinct points (a lattice walk, one coordinate at a time) and their
    # mirror images: no point repeats another.
    i = torch.arange(n, device=dev, dtype=torch.float32)
    x = torch.stack([i % 17, (i // 17) % 19, i // 323], -1) * 0.125
    x = torch.stack([x, -x - 1.0]).contiguous()
    got = duplicate_mask_kernel(x)
    torch.cuda.synchronize()
    assert torch.equal(got, duplicate_mask_plain(x)) and float(got.max()) == 0.0


def test_duplicate_mask_kernel_refuses_what_it_does_not_take(dev):
    x = torch.zeros(1, 8, 3, device=dev)
    with pytest.raises(ValueError, match="float32"):
        duplicate_mask_kernel(x.double())
    with pytest.raises(ValueError, match="float32"):
        duplicate_mask_kernel(torch.zeros(1, 8, 4, device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        duplicate_mask_kernel(torch.zeros(1, 3, 8, device=dev).transpose(1, 2))


@pytest.mark.parametrize("q_count,n,k", [(128, 128, 48), (5, 37, 64), (1024, 384, 48), (64, 64, 65)])
def test_knn_indices_general_takes_the_kernels_up_to_k64(dev, monkeypatch, q_count, n, k):
    # Every CUDA call with k <= 64 launches #12 and #13, whatever Q and N,
    # and picks what the kernel branch picks with the plain versions on the
    # same card; k > 64 takes the plain branch and launches nothing.
    p = torch.from_numpy(dup_cloud(np.random.RandomState(k), 2, n)).nan_to_num(0.5).to(dev)
    q = p[:, torch.arange(q_count) % n].contiguous()
    before = (duplicate_mask_kernel.launches, knn_point_kernel.launches)
    d, i = xconv.knn_indices_general(q, p, k)
    torch.cuda.synchronize()
    launched = int(k <= 64)
    assert (duplicate_mask_kernel.launches, knn_point_kernel.launches) == (before[0] + launched, before[1] + launched)
    monkeypatch.setattr(xconv, "duplicate_mask_kernel", duplicate_mask_plain)
    monkeypatch.setattr(xconv, "knn_point_kernel", knn_point_plain)
    want_d, want_i = xconv.knn_indices_general(q, p, k)
    assert torch.equal(i, want_i) and torch.equal(d, want_d)


# #18, the exact-key pool forward: (lead dims, K, C, compute dtype, inputs).
# The bf16 SSG step's three SA shapes (group-all: 16 teams of a block split
# K) and MSG SA1's scale 1 (C = 64) at B=16, then a ragged width, an f32
# compute dtype, exact ties and a NaN, PointNet's global pools (B=32 rows
# of K = N = 1024, C = 1024), also with every column's winner tied across
# the plan's run boundaries ("straddle"), a NaN key in the last slot of the
# last team's run ("nan_last"), and one row.
POOLKEY_CASES = {
    "pointnet_straddle": ((32,), 1024, 1024, torch.bfloat16, "straddle"),
    "nan_last_run": ((2, 8), 128, 64, torch.bfloat16, "nan_last"),
    "rows1": ((1,), 1024, 1024, torch.bfloat16, "straddle"),
    "rows1_k_ragged_f32": ((1,), 1023, 72, torch.float32, "straddle"),
    "ssg_sa1": ((16, 512), 32, 128, torch.bfloat16, "normal"),
    "ssg_sa2": ((16, 128), 64, 256, torch.bfloat16, "normal"),
    "ssg_group_all": ((16, 1), 128, 1024, torch.bfloat16, "normal"),
    "msg_sa1_scale1": ((16, 512), 16, 64, torch.bfloat16, "normal"),
    "ragged": ((3, 7), 5, 33, torch.bfloat16, "normal"),
    "f32": ((4, 8), 12, 40, torch.float32, "normal"),
    "ties": ((4, 16), 8, 24, torch.bfloat16, "ties"),
    "nan": ((2, 4), 6, 10, torch.bfloat16, "nan"),
    "pointnet": ((32,), 1024, 1024, torch.bfloat16, "normal"),  # each global pool of a bf16 PointNet step
}


def poolkey_inputs(case, dev):
    """z32 [.., K, C] and (gamma, beta, mean, r) as the fused keys layer
    hands them to #18: the statistics of the rounded z32, r = rsqrt(var +
    1e-3) from torch."""
    lead, k, c, cdtype, kind = POOLKEY_CASES[case]
    rng = np.random.RandomState(k * c)
    z = rng.randn(*lead, k, c).astype(np.float32) * 2.0 + rng.randn(c).astype(np.float32)
    if kind == "ties":
        z[..., k // 2:, :] = z[..., : k - k // 2, :]
    if kind == "nan":
        z[0, 1, 3, 2] = np.nan
    if kind == "nan_last":
        z[0, 0, k - 1, c - 1] = np.nan
    if kind == "straddle":  # channel ch's winner: the two slots either side of one run boundary
        p = poolkey_plan(int(np.prod(lead)), k, c)
        starts = sorted({j0 for j0, j1 in poolkey_runs(k, p.teams) if 0 < j0 < j1})
        for ch in range(c if starts else 0):
            j = starts[ch % len(starts)]
            z[..., j - 1:j + 1, ch] = z[..., :, ch].max(-1)[..., None] + 1.0
    z32 = torch.from_numpy(z).to(dev)
    zbf = z32.to(cdtype).float()
    axes = tuple(range(z32.dim() - 1))
    mean = zbf.nan_to_num(0.0).mean(dim=axes)
    var = torch.clamp(torch.square(zbf.nan_to_num(0.0)).mean(dim=axes) - torch.square(mean), min=0.0)
    gamma = torch.from_numpy((1.0 + 0.2 * rng.randn(c)).astype(np.float32)).to(dev)
    beta = torch.from_numpy((0.1 * rng.randn(c)).astype(np.float32)).to(dev)
    return z32, gamma, beta, mean, torch.rsqrt(var + 1e-3), cdtype


@pytest.mark.parametrize("case", sorted(POOLKEY_CASES))
def test_poolkey_kernel_matches_plain(dev, case):
    # Bit-equal: the same r, the same op order without contraction, the
    # same rounding to bf16.
    args = poolkey_inputs(case, dev)
    before = bn_relu_exactkey_pool.launches
    got = bn_relu_exactkey_pool(*args)
    want = bn_relu_exactkey_pool_plain(*args)
    torch.cuda.synchronize()
    assert bn_relu_exactkey_pool.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    kind = POOLKEY_CASES[case][4]
    if kind in ("ties", "straddle"):
        assert bool((got[2] >= 2).all())  # every column's winner is duplicated
    if kind == "nan":
        assert bool(torch.isnan(got[1][0, 1, 2])) and float(got[2][0, 1, 2]) == 0.0
    if kind == "nan_last":
        assert int(torch.isnan(got[1]).sum()) == 1 and bool(torch.isnan(got[1][0, 0, -1]))
        assert poolkey_plan(16, 128, 64).teams > 1


# Plans other than plan()'s own: a 128-channel tile a warp with eight
# teams, half-warp teams, one channel a lane, 32 teams of eight lanes, one
# warp of one team, and one team of 64 and of 128 lanes (each thread walks
# all of K).
POOLKEY_PLANS = [PoolkeyPlan(4, 32, 8), PoolkeyPlan(4, 16, 16), PoolkeyPlan(1, 32, 8), PoolkeyPlan(4, 8, 32),
                 PoolkeyPlan(4, 32, 1), PoolkeyPlan(4, 64, 1), PoolkeyPlan(1, 128, 1)]


@pytest.mark.parametrize("case", ["pointnet_straddle", "nan_last_run", "ssg_sa2"])
@pytest.mark.parametrize("forced", POOLKEY_PLANS, ids=lambda p: "x".join(map(str, p)))
def test_poolkey_kernel_on_every_plan_matches_plain(dev, monkeypatch, case, forced):
    args = poolkey_inputs(case, dev)
    monkeypatch.setattr(poolkey_kernel, "plan", lambda *a, **kw: forced)
    got = bn_relu_exactkey_pool(*args)
    want = bn_relu_exactkey_pool_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)


def test_poolkey_kernel_on_a_misaligned_z32_reads_a_channel_a_lane(dev):
    # z32 a view 4 bytes past a 16-byte boundary: the plan takes vec 1.
    z32, gamma, beta, mean, r, cdtype = poolkey_inputs("ssg_group_all", dev)
    buf = torch.empty(z32.numel() + 1, device=dev)
    shifted = buf[1:].view(z32.shape)
    shifted.copy_(z32)
    assert shifted.data_ptr() % 16 == 4
    got = bn_relu_exactkey_pool(shifted, gamma, beta, mean, r, cdtype)
    want = bn_relu_exactkey_pool_plain(z32, gamma, beta, mean, r, cdtype)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("case,bad", [
    ("ties", PoolkeyPlan(4, 3, 32)), ("ties", PoolkeyPlan(4, 32, 16)), ("ties", PoolkeyPlan(4, 8, 2)),
    ("ties", PoolkeyPlan(4, 8, 0)), ("ties", PoolkeyPlan(4, 0, 32)), ("ties", PoolkeyPlan(2, 8, 4)),
    ("ties", PoolkeyPlan(1, 8, 64)), ("ties", PoolkeyPlan(4, 64, 2)), ("ties", PoolkeyPlan(4, 64, 4)),
    ("ties", PoolkeyPlan(4, 16, 1)), ("ties", PoolkeyPlan(4, 512, 1)), ("nan", PoolkeyPlan(4, 8, 4)),
], ids=lambda v: v if isinstance(v, str) else "x".join(map(str, v)))
def test_poolkey_kernel_refuses_a_plan_it_cannot_run(dev, monkeypatch, case, bad):
    # On K = 8, C = 24: lanes not a power of two; 512 threads; threads not
    # whole warps; no team; no lane; vec 2; 512 threads of one channel a
    # lane; lanes above a warp with two or four teams; the column route at
    # half a warp or 512 threads a block.  On C = 10: 16-byte loads.
    z32, gamma, beta, mean, r, cdtype = poolkey_inputs(case, dev)
    monkeypatch.setattr(poolkey_kernel, "plan", lambda *a, **kw: bad)
    before = bn_relu_exactkey_pool.launches
    with pytest.raises(RuntimeError, match="cudaError_t"):
        bn_relu_exactkey_pool(z32, gamma, beta, mean, r, cdtype)
    assert bn_relu_exactkey_pool.launches == before
    torch.cuda.synchronize()  # no error left behind


def test_poolkey_kernel_refuses_what_it_does_not_take(dev):
    z32, gamma, beta, mean, r, _ = poolkey_inputs("ragged", dev)
    with pytest.raises(ValueError, match="float32"):
        bn_relu_exactkey_pool(z32.double(), gamma, beta, mean, r)
    with pytest.raises(ValueError, match="r must be"):
        bn_relu_exactkey_pool(z32, gamma, beta, mean, r[1:])
    with pytest.raises(ValueError, match="compute dtype"):
        bn_relu_exactkey_pool(z32, gamma, beta, mean, r, torch.float16)


# #17, the fused SA training tail's backward: (z1 shape [B, M, K, C0], the
# MLP widths).  SSG SA1 and SA2 at B=16, MSG SA1's K=128 scale, SSG's
# group-all at B=4, and small stacks of 1-3 layers with K and widths that
# are not multiples of 8, and duplicated slots (exact pool ties).  The
# edges of the kernel's plan (``satrain_kernel.plan``): K = 1 (k1: 64
# one-row groups a chunk, whose 64 x 32 maxima overflow half the W ring,
# so the pool pass; k1_in_pass: 64 x 12, the pool in the pass), K = 33
# (one group a chunk, the pool in the pass), K = 65, 96 and 127 (a group
# crosses chunks: the pool pass, split into segments; the ties of k96 lie
# across a chunk's and a segment's boundary), groups x K not a multiple of
# the chunk's rows (k12_ragged: five groups a chunk, 21 groups), widths 1
# and 5 (a one-channel layer between two of 5; a lone channel at the
# bottom is held to the float64 backward below), 1024 (fewer rows a
# chunk), four layers.
SATRAIN_CASES = {
    "ssg_sa1": ((16, 512, 32, 64), (64, 64, 128)),
    "ssg_sa2": ((16, 128, 64, 128), (128, 128, 256)),
    "msg_sa1_k128": ((16, 512, 128, 64), (64, 96, 128)),
    "group_all": ((4, 1, 128, 256), (256, 512, 1024)),
    "ragged": ((3, 5, 7, 12), (12, 20, 9)),
    "one_layer": ((2, 8, 10, 16), (16,)),
    "two_layers_ties": ((2, 16, 8, 24), (24, 40)),
    "k1": ((2, 64, 1, 16), (16, 24, 32)),
    "k1_in_pass": ((2, 64, 1, 16), (16, 12)),
    "k33": ((2, 9, 33, 20), (20, 36, 40)),
    "k65": ((2, 5, 65, 24), (24, 40)),
    "k96_ties": ((2, 4, 96, 16), (16, 24, 32)),
    "k127": ((1, 6, 127, 12), (12, 24, 48)),
    "k12_ragged": ((3, 7, 12, 8), (8, 16)),
    "widths_1_5": ((2, 8, 16, 5), (5, 1, 5)),
    "width_1024": ((1, 4, 16, 1024), (1024, 1024)),
    "four_layers": ((2, 16, 16, 12), (12, 20, 28, 36)),
}
# Tolerance (x the tensor's max |ref|): the kernel sums its products in
# another order than cuBLAS, so a relu gate or a pool winner within
# rounding of its threshold may flip, and in bf16 a rounding of h may move
# by one ulp: at most SATRAIN_FLIP_SHARE of a tensor's elements may lie
# beyond SATRAIN_TOL.
SATRAIN_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-5}
SATRAIN_FLIP_SHARE = {torch.float32: 1e-3, torch.bfloat16: 1e-3}
# db_i feeds a training BN, so its true value is 0: both sides' rounding
# noise is held to SATRAIN_ZERO_TOL x max(1, |dbeta_i|max).
SATRAIN_ZERO_TOL = 1e-3


def satrain_inputs(case, dtype, dev, pool_mode="0", spec=None, seed=None):
    """(z1, gammas, betas, ws, bs, means, vars, d_pooled, pool_mode), the
    statistics those of the plain forward chain on the card; ``spec`` (the
    shape and widths) for a case outside SATRAIN_CASES; ``seed`` for other
    draws of the same case."""
    shape, widths = spec or SATRAIN_CASES[case]
    rng = np.random.RandomState(sum(shape) + sum(widths) if seed is None else seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    z = rng.randn(*shape).astype(np.float32) + rng.randn(shape[-1]).astype(np.float32)
    if case.endswith("ties"):
        z[:, :, shape[2] // 2:] = z[:, :, : shape[2] - shape[2] // 2]
    z1 = t(z).to(dtype)
    gammas = [t(1.0 + 0.1 * rng.randn(c)) for c in widths]
    betas = [t(0.1 * rng.randn(c)) for c in widths]
    ws = [t(rng.randn(a, b) / np.sqrt(a)) for a, b in zip(widths, widths[1:])]
    bs = [t(0.05 * rng.randn(c)) for c in widths[1:]]
    _, _, _, means, variances = fwd_chain(z1, gammas, betas, ws, bs, pool_mode)
    d_pooled = t(rng.randn(shape[0], shape[1], widths[-1])).to(dtype)
    return z1, gammas, betas, ws, bs, means, variances, d_pooled, pool_mode


def satrain_plain64(args):
    """The plain backward with every sum, the parameters and the
    statistics in float64; the compute dtype's roundings of W, h, y and dz1
    kept (``fwd_chain``'s ``.to(cdtype)``): the exact answer the kernel and
    the f32 plain backward both round."""
    z1, gammas, betas, ws, bs, means, variances, d_pooled, pool_mode = args

    def d64(ts):
        return [t.double() for t in ts]

    with mock.patch.object(satrain_kernel, "_acc", lambda t: t.to(torch.promote_types(t.dtype, torch.float64))):
        return grouped_bn_mlp_pool_bwd_plain(z1, d64(gammas), d64(betas), d64(ws), d64(bs), d64(means),
                                             d64(variances), d_pooled.double(), pool_mode)


def _chain_mm(a, b):
    """``a @ b`` as the kernel sums it: each output an FMA chain from 0 in
    ascending k, rounded to f32 at every step (the product of two f32
    values is exact in float64)."""
    a, b = satrain_kernel._acc(a).double(), satrain_kernel._acc(b).double()
    acc = torch.zeros(*a.shape[:-1], b.shape[-1], dtype=torch.float32, device=a.device)
    for k in range(a.shape[-1]):
        acc = (a[..., k:k + 1] * b[k] + acc.double()).float()
    return acc


def satrain_in_kernel_order(args):
    """(args with the statistics of the forward chain summed in the
    kernel's order, the plain backward on them in that order)."""
    with mock.patch.object(satrain_kernel, "_mm", _chain_mm):
        _, _, _, means, variances = fwd_chain(*args[:5], args[8])
        args = (*args[:5], means, variances, *args[7:])
        return args, grouped_bn_mlp_pool_bwd_plain(*args)


def satrain_magnitudes(args):
    """Each cotangent's scale of rounding: the plain backward in float64
    with every term taken by its magnitude (a difference as the sum of its
    operands' magnitudes), so each sum is that of its terms' magnitudes.  An
    f32 evaluation in any order rounds at this scale; a sum that cancels is
    small beside it."""
    z1, gammas, betas, ws, bs, means, variances, d_pooled, pool_mode = args
    gammas, betas, ws, bs, means, variances = ([t.double() for t in ts]
                                               for ts in (gammas, betas, ws, bs, means, variances))
    with mock.patch.object(satrain_kernel, "_acc", lambda t: t.to(torch.promote_types(t.dtype, torch.float64))):
        zhats, ys, pooled, _, _ = fwd_chain(z1, gammas, betas, ws, bs, pool_mode, means, variances)
    axes, rows = (0, 1, 2), float(z1[..., 0].numel())
    eq = (ys[-1] == pooled.unsqueeze(-2)).double()
    dy = eq / eq.sum(-2, keepdim=True) * d_pooled.double().abs().unsqueeze(-2)
    out = {}
    for i in range(len(gammas) - 1, -1, -1):
        du = dy * (zhats[i] * gammas[i] + betas[i] > 0.0)
        a1, a2 = du.sum(axes), (du * zhats[i].abs()).sum(axes)
        out[f"dgamma{i}"], out[f"dbeta{i}"] = a2, a1
        dz = (torch.rsqrt(variances[i] + satrain_kernel.EPS) * gammas[i]).abs() * (
            du + a1 / rows + zhats[i].abs() * (a2 / rows))
        if i > 0:
            out[f"dw{i}"] = ys[i - 1].double().abs().reshape(-1, ys[i - 1].shape[-1]).t() @ dz.reshape(-1, dz.shape[-1])
            out[f"dbias{i}"] = dz.sum(axes)
            dy = dz @ ws[i - 1].abs().t()
    out["dz1"] = dz
    return out


def _flatten_grads(out):
    dz1, dgammas, dbetas, dws, dbs = out
    named = {"dz1": dz1}
    named.update({f"dgamma{i}": g for i, g in enumerate(dgammas)})
    named.update({f"dbeta{i}": g for i, g in enumerate(dbetas)})
    named.update({f"dw{i + 1}": g for i, g in enumerate(dws)})
    named.update({f"dbias{i + 1}": g for i, g in enumerate(dbs)})
    return named


@pytest.mark.parametrize("dtype,pool_mode", [(torch.float32, "0"), (torch.bfloat16, "0"), (torch.bfloat16, "1")],
                         ids=["f32", "bf16", "bf16_pool_f32"])
@pytest.mark.parametrize("case", sorted(SATRAIN_CASES))
def test_satrain_bwd_kernel_matches_plain(dev, case, dtype, pool_mode):
    args = satrain_inputs(case, dtype, dev, pool_mode)
    before = grouped_bn_mlp_pool_bwd.launches
    got = _flatten_grads(grouped_bn_mlp_pool_bwd(*args))
    again = _flatten_grads(grouped_bn_mlp_pool_bwd(*args))
    want = _flatten_grads(grouped_bn_mlp_pool_bwd_plain(*args))
    torch.cuda.synchronize()
    assert grouped_bn_mlp_pool_bwd.launches == before + 2
    for name, g in got.items():
        assert torch.equal(g, again[name]), f"{name} is not bit-stable"
    _check_satrain(got, want, dtype, f"{case} mode {pool_mode}")


def _check_satrain(got, want, dtype, label, scales=None):
    """Each cotangent within the SATRAIN_* gates of the plain backward's,
    x max|ref| or x the max of ``scales``' tensor (``satrain_magnitudes``)."""
    readings = []
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        diff = (g.float() - w.float()).abs()
        if name.startswith("dbias"):  # feeds a training BN: its true value is 0, both sum rounding noise
            bound = SATRAIN_ZERO_TOL * max(1.0, float(want["dbeta" + name[5:]].abs().max()))
            readings.append((name, float(g.abs().max()), float(w.abs().max()), bound))
            assert float(g.abs().max()) <= bound and float(w.abs().max()) <= bound, (name, readings)
            continue
        scale = max(float((scales[name] if scales else w.float()).abs().max()), 1e-30)
        beyond = diff > SATRAIN_TOL[dtype] * scale
        share = float(beyond.float().mean())
        rest = float(torch.where(beyond, 0.0, diff).max()) / scale
        readings.append((name, float(diff.max()) / scale, share, rest))
        assert share <= SATRAIN_FLIP_SHARE[dtype], (name, share, readings)
    print(f"#17 {label} {dtype}: {readings}")



@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_satrain_bwd_in_pass_pool_and_pool_pass(dev, dtype, monkeypatch):
    # The same z1 and parameters as 32-row groups (the pool in every pass)
    # and reshaped into 128-row groups (a group crosses chunks: the pool
    # pass); both within the gates of the plain backward.  The 32-row call
    # forced onto the pool pass chunks its rows alike, so it gives the same
    # bits as the in-pass pool.
    rng = np.random.RandomState(31)
    widths = (16, 24, 32)
    z = rng.randn(2, 32, 32, 16).astype(np.float32) + rng.randn(16).astype(np.float32)
    z[:, :, 16:] = z[:, :, :16]  # exact ties
    gammas = [torch.from_numpy((1.0 + 0.1 * rng.randn(c)).astype(np.float32)).to(dev) for c in widths]
    betas = [torch.from_numpy((0.1 * rng.randn(c)).astype(np.float32)).to(dev) for c in widths]
    ws = [torch.from_numpy((rng.randn(a, b) / np.sqrt(a)).astype(np.float32)).to(dev)
          for a, b in zip(widths, widths[1:])]
    bs = [torch.from_numpy((0.05 * rng.randn(c)).astype(np.float32)).to(dev) for c in widths[1:]]
    for shape in ((2, 32, 32, 16), (2, 8, 128, 16)):
        z1 = torch.from_numpy(z.reshape(shape)).to(dev).to(dtype)
        _, _, _, means, variances = fwd_chain(z1, gammas, betas, ws, bs)
        d_pooled = torch.from_numpy(rng.randn(shape[0], shape[1], widths[-1]).astype(np.float32)).to(dev)
        args = (z1, gammas, betas, ws, bs, means, variances, d_pooled, "0")
        layout = satrain_plan(shape[0] * shape[1], shape[2], widths, sm_count(dev))
        assert layout.pool_in_pass == (shape[2] == 32)
        got = _flatten_grads(grouped_bn_mlp_pool_bwd(*args))
        want = _flatten_grads(grouped_bn_mlp_pool_bwd_plain(*args))
        torch.cuda.synchronize()
        _check_satrain(got, want, dtype, f"z1 {shape}")
        if layout.pool_in_pass:
            forced = satrain_forced_plan(shape[0] * shape[1], shape[2], widths, sm_count(dev), pool_in_pass=False)
            assert not forced.pool_in_pass and forced.chunk_rows == layout.chunk_rows
            monkeypatch.setattr(satrain_kernel, "plan", lambda *_: forced)
            again = _flatten_grads(grouped_bn_mlp_pool_bwd(*args))
            monkeypatch.undo()
            for name, g in got.items():
                assert torch.equal(g, again[name]), name


def test_satrain_bwd_four_wide_layers_f32(dev):
    # Four layers of 1024: 4 rows a chunk, the constants in device memory.
    # bf16 is held to the kernel's own summation order below.
    args = satrain_inputs("four_wide", torch.float32, dev, spec=((1, 2, 8, 1024), (1024,) * 4))
    layout = satrain_plan(2, 8, (1024,) * 4, sm_count(dev))
    assert layout.rows == 4 and not layout.consts_smem
    got = _flatten_grads(grouped_bn_mlp_pool_bwd(*args))
    again = _flatten_grads(grouped_bn_mlp_pool_bwd(*args))
    want = _flatten_grads(grouped_bn_mlp_pool_bwd_plain(*args))
    torch.cuda.synchronize()
    for name, g in got.items():
        assert torch.equal(g, again[name]), f"{name} is not bit-stable"
    _check_satrain(got, want, torch.float32, "four_wide")


@pytest.mark.parametrize("pool_mode", ["0", "1"], ids=["bf16", "bf16_pool_f32"])
def test_satrain_bwd_four_wide_layers_bf16_in_its_sum_order(dev, pool_mode):
    # Four layers of 1024 over 16 rows in bf16: a 1024-term sum that another
    # order moves by an f32 ulp can round h to the other bf16 value, and over
    # four such layers that moves a pool winner or a relu gate, and with 16
    # rows every sum with it.  The plain backward summed in the kernel's order
    # (FMA chains from 0 in ascending k) lands up to 5e-2 of the result from
    # the one summed by cuBLAS or in float64 (PERF.md section 7), so the
    # kernel is held to it under the SATRAIN_* gates, with the statistics of
    # the forward summed that way too (the Dense biases' gradient is 0 only
    # for the statistics of the same h).
    args, want = satrain_in_kernel_order(
        satrain_inputs("four_wide", torch.bfloat16, dev, pool_mode, spec=((1, 2, 8, 1024), (1024,) * 4)))
    want = _flatten_grads(want)
    got = _flatten_grads(grouped_bn_mlp_pool_bwd(*args))
    again = _flatten_grads(grouped_bn_mlp_pool_bwd(*args))
    torch.cuda.synchronize()
    for name, g in got.items():
        assert torch.equal(g, again[name]), f"{name} is not bit-stable"
    _check_satrain(got, want, torch.bfloat16, f"four_wide mode {pool_mode} in the kernel's order")


# A lone channel at the bottom (widths 1, 5, 1 and 1, 5, 8): dgamma0 and
# dW_1 sum terms over the rows that cancel to a thousandth of their
# magnitudes, so no f32 order holds SATRAIN_TOL of the result: against the
# float64 backward cuBLAS misses it in 5 to 10 of 16 draws, the kernel in 6
# to 12 (PERF.md section 7).  The kernel is held to the float64 backward
# (``satrain_plain64``) on the card tests' draw and four others under the
# SATRAIN_* gates, each cotangent's tolerance taken of the magnitudes it
# sums (``satrain_magnitudes``), the scale at which any f32 order rounds.
SATRAIN_F64_CASES = {"widths_1_5_1": ((2, 8, 16, 1), (1, 5, 1)), "widths_1_5_8": ((2, 8, 16, 1), (1, 5, 8))}


@pytest.mark.parametrize("dtype,pool_mode", [(torch.float32, "0"), (torch.bfloat16, "0"), (torch.bfloat16, "1")],
                         ids=["f32", "bf16", "bf16_pool_f32"])
@pytest.mark.parametrize("case", sorted(SATRAIN_F64_CASES))
def test_satrain_bwd_kernel_matches_float64(dev, case, dtype, pool_mode):
    for seed in (None, 0, 1, 2, 3):
        args = satrain_inputs(case, dtype, dev, pool_mode, spec=SATRAIN_F64_CASES[case], seed=seed)
        got = _flatten_grads(grouped_bn_mlp_pool_bwd(*args))
        again = _flatten_grads(grouped_bn_mlp_pool_bwd(*args))
        want = _flatten_grads(satrain_plain64(args))
        torch.cuda.synchronize()
        for name, g in got.items():
            assert torch.equal(g, again[name]), f"{name} is not bit-stable"
        _check_satrain(got, {name: w if name == "dz1" else w.float() for name, w in want.items()}, dtype,
                       f"{case} mode {pool_mode} draw {seed} against float64", satrain_magnitudes(args))


@pytest.mark.parametrize("fault", ["chunk_rows", "slices", "scratch", "blocks_per_sm"])
def test_satrain_bwd_kernel_refuses_a_plan_it_cannot_run(dev, monkeypatch, fault):
    # The wrapper hands the kernel plan()'s layout; the C entry point checks
    # it and refuses one it cannot run before it launches anything.
    args = satrain_inputs("ssg_sa2", torch.float32, dev)
    layout = satrain_plan(16 * 128, 64, (128, 128, 256), sm_count(dev))
    dw_pass = layout.passes[1]  # sums dW_2 over 2 x 4 tiles of 64 x 64
    bad = {
        "chunk_rows": replace(layout, chunk_rows=layout.chunk_rows - 1),
        "slices": replace(layout, passes=(layout.passes[0], replace(dw_pass, slices=9), *layout.passes[2:])),
        "scratch": replace(layout, partial_floats=dw_pass.blocks * dw_pass.stride - 1),
        "blocks_per_sm": replace(layout, blocks_per_sm=3 - layout.blocks_per_sm),
    }[fault]
    monkeypatch.setattr(satrain_kernel, "plan", lambda *_: bad)
    before = grouped_bn_mlp_pool_bwd.launches
    with pytest.raises(RuntimeError, match="invalid argument"):
        grouped_bn_mlp_pool_bwd(*args)
    assert grouped_bn_mlp_pool_bwd.launches == before
    monkeypatch.undo()
    torch.cuda.synchronize()  # no error left behind
    assert all(bool(torch.isfinite(g).all()) for g in _flatten_grads(grouped_bn_mlp_pool_bwd(*args)).values())


def test_satrain_bwd_kernel_refuses_what_it_does_not_take(dev):
    args = list(satrain_inputs("ragged", torch.float32, dev))
    with pytest.raises(ValueError, match="pool modes"):
        grouped_bn_mlp_pool_bwd(*args[:8], "keys")
    with pytest.raises(ValueError, match="z1 must be"):
        grouped_bn_mlp_pool_bwd(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="1024 channels"):
        grouped_bn_mlp_pool_bwd(torch.zeros(1, 1, 2, 1025, device=dev), [torch.ones(1025, device=dev)],
                                [torch.zeros(1025, device=dev)], [], [], [torch.zeros(1025, device=dev)],
                                [torch.ones(1025, device=dev)], torch.zeros(1, 1, 1025, device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fused_tail_and_keys_layers_launch_their_kernels(dev, dtype):
    # A training step of GroupMLPPool and LiftedGroupMLP on the card: the
    # fused tail's backward is #17, the bf16 keys layer's forward #18.
    from scanobjectnn_torch.convert import init_params
    from scanobjectnn_torch.nn.pointnet_modules import GroupMLPPool, LiftedGroupMLP, configure_training

    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(2, 16, 8, 6).astype(np.float32)).to(dev)
    for mode, fused, counter in (("0", True, grouped_bn_mlp_pool_bwd), ("keys", False, bn_relu_exactkey_pool)):
        if counter is bn_relu_exactkey_pool and dtype != torch.bfloat16:
            continue
        mlp = configure_training(init_params(GroupMLPPool(6, (8, 12, 16), dtype=dtype), torch.Generator().manual_seed(0)),
                                 mode, fused).to(dev).train()
        before = counter.launches
        mlp(x, 0.5).float().sum().backward()
        torch.cuda.synchronize()
        assert counter.launches == before + 1, (mode, fused)
        assert all(p.grad is not None and bool(torch.isfinite(p.grad).all()) for p in mlp.parameters())
    lifted = configure_training(LiftedGroupMLP(15, (8, 16), dtype=dtype), "0", True).to(dev).train()
    before = grouped_bn_mlp_pool_bwd.launches
    pts = torch.from_numpy(rng.randn(2, 32, 12).astype(np.float32)).to(dev)
    xyz = torch.from_numpy(rng.randn(2, 32, 3).astype(np.float32)).to(dev)
    idx = torch.from_numpy(rng.randint(0, 32, (2, 8, 4)).astype(np.int32)).to(dev)
    lifted(pts, xyz, xyz[:, :8].contiguous(), idx, 0.5).float().sum().backward()
    torch.cuda.synchronize()
    assert grouped_bn_mlp_pool_bwd.launches == before + 1


# (b, n, feature channels, feature dtype, kind)
RANKSORT_CASES = {
    "points_2048": (4, 2048, 0, None, "random"),
    "queries_512": (4, 512, 0, None, "random"),
    "main_path_points_b128": (128, 2048, 0, None, "random"),
    "main_path_queries_b128": (128, 512, 0, None, "random"),
    "ties_and_zeros": (3, 1000, 0, None, "ties"),
    "nan_keys": (2, 777, 0, None, "nan"),
    "bf16_rows": (2, 300, 24, torch.bfloat16, "ties"),
    "bf16_odd_rows": (2, 257, 5, torch.bfloat16, "random"),
    "f32_rows": (2, 129, 5, torch.float32, "random"),
    "f32_rows_2048": (2, 2048, 7, torch.float32, "ties"),
    "one_point": (2, 1, 3, torch.float32, "random"),
    "large_n": (1, 16384, 0, None, "ties"),
    "all_equal": (3, 2048, 0, None, "equal"),
    "all_nan": (2, 512, 0, None, "allnan"),
    "ascending": (2, 2048, 0, None, "ascending"),
    "descending": (2, 2048, 0, None, "descending"),
    "signed_zeros": (3, 1500, 0, None, "zeros"),
    **{f"n_{n}": (2, n, 0, None, "ties") for n in (31, 32, 33, 257, 2047)},
    # Every boundary of sort_plan: the words a thread and the block's threads
    # change at the powers of two, the shared-memory steps from 257 on.
    **{f"plan_edge_{n}": (2, n, 0, None, "ties")
       for p in (64, 128, 256, 512, 1024, 2048, 4096, 8192) for n in (p, p + 1)},
    "plan_edge_16383": (1, 16383, 0, None, "random"),
}


def _ranksort_inputs(spec, dev):
    b, n, c, fdtype, kind = spec
    rng = np.random.RandomState(n + c)
    xyz = rng.randn(b, n, 3).astype(np.float32)
    key = xyz[..., 0].copy()
    if kind in ("ties", "nan"):
        key = np.round(key * 4.0) / 4.0  # many exact duplicates, -0.0 and 0.0 among them
        key[:, ::7] = -0.0
    if kind == "nan":
        key[:, 3::50] = np.nan
    if kind == "equal":
        key[:] = 1.5
    if kind == "allnan":
        key[:] = np.nan
    if kind in ("ascending", "descending"):
        key = np.broadcast_to(np.arange(n, dtype=np.float32) * (1.0 if kind == "ascending" else -1.0), (b, n)).copy()
    if kind == "zeros":  # only -0.0 and +0.0, with a few negatives and positives among them
        key = np.where(rng.rand(b, n) < 0.5, np.float32(-0.0), np.float32(0.0)).astype(np.float32)
        key[:, ::97] = rng.randn(b, len(key[0, ::97]))
    feats = None if not c else torch.from_numpy(rng.randn(b, n, c).astype(np.float32)).to(dev, fdtype)
    return torch.from_numpy(key).to(dev), torch.from_numpy(xyz).to(dev), feats


def _check_rank_sort(key, xyz, feats, dev):
    before = rank_sort_points.launches
    got = rank_sort_points(key, xyz, feats)
    ref = rank_sort_points_plain(key, xyz, feats)
    torch.cuda.synchronize()
    assert rank_sort_points.launches == before + 1
    for g, r in zip(got, ref):
        assert (g is None and r is None) or (g.dtype == r.dtype and torch.equal(g, r))
    ids, rank = got[1].long(), got[2].long()
    assert torch.equal(torch.gather(ids, 1, rank), torch.arange(key.shape[1], device=dev).expand_as(ids))


@pytest.mark.parametrize("case", sorted(RANKSORT_CASES))
def test_rank_sort_kernel_matches_plain(dev, case):
    _check_rank_sort(*_ranksort_inputs(RANKSORT_CASES[case], dev), dev)


@pytest.mark.parametrize("n", [1, 33, 300, 512, 2048, 5000])
def test_rank_sort_kernel_matches_plain_on_every_plan(dev, n):
    """Every (threads, words a thread) the kernel takes at n, not only
    sort_plan's, gives the plain version's bits."""
    key, xyz, feats = _ranksort_inputs((2, n, 3, torch.bfloat16, "ties"), dev)
    plans = [(ranksort_kernel.sort_words(n, e) // e, e) for e in ranksort_kernel.PER_THREAD
             if ranksort_kernel.sort_words(n, e) // e <= ranksort_kernel.MAX_THREADS]
    assert ranksort_kernel.sort_plan(n) in plans
    for plan in plans:
        with mock.patch.object(ranksort_kernel, "sort_plan", lambda _n, plan=plan: plan):
            _check_rank_sort(key, xyz, feats, dev)


def test_rank_sort_kernel_builds_use_no_local_memory(dev):
    for n in (1, 64, 512, 2048, 16384):
        info = ranksort_kernel.kernel_info(n)
        assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 1, (n, info)


def test_rank_sort_kernel_refuses_what_it_does_not_take(dev):
    key, xyz, _ = _ranksort_inputs(RANKSORT_CASES["f32_rows"], dev)
    with pytest.raises(ValueError):
        rank_sort_points(torch.zeros(1, 16385, device=dev), torch.zeros(1, 16385, 3, device=dev))
    with pytest.raises(ValueError):
        rank_sort_points(key.double(), xyz)
    with pytest.raises(ValueError):
        rank_sort_points(key, xyz, torch.zeros(*key.shape, 2, dtype=torch.uint8, device=dev))
    # The C entry point refuses a plan it cannot run: padding past the least
    # power of two, too few threads for the cloud, a block past 1024 threads,
    # a words-a-thread it is not built for.
    for plan in ((64, 8), (32, 4), (2048, 8), (32, 3)):
        with mock.patch.object(ranksort_kernel, "sort_plan", lambda _n, plan=plan: plan):
            with pytest.raises(RuntimeError):
                rank_sort_points(key, xyz)


# (b, n, m, k, radius, src channels, mlp, cloud, (W, T, G), xyz_first)
BUCKET_CASES = {
    "ssg_sa1_auto": (2, 2048, 512, 32, 0.2, 0, (64, 64, 128), "sparse", (896, 64, 128), True),
    "sparse_k16": (2, 1024, 256, 16, 0.2, 0, (16, 16, 32), "sparse", (640, 32, 128), True),
    "dense_k16": (2, 1024, 256, 16, 0.2, 0, (16, 16, 32), "dense", (640, 32, 128), True),
    "overflow_k16": (2, 1024, 256, 16, 0.2, 0, (16, 16, 32), "tight", (640, 32, 128), True),
    "features": (2, 512, 128, 16, 0.2, 8, (16, 16, 32), "sparse", (384, 32, 128), True),
    "features_msg_order": (2, 512, 128, 16, 0.3, 8, (16, 32), "dense", (384, 16, 128), False),
    "prelifted": (2, 512, 128, 16, 0.2, 24, (16, 32), "sparse", (384, 32, 128), True),
    "k64": (1, 1024, 96, 64, 0.3, 0, (32, 48), "sparse", (512, 16, 128), True),
    "k5_ragged_tile": (1, 512, 60, 5, 0.3, 4, (8, 16), "dense", (448, 20, 64), True),  # 12 queries a block
    "rows_without_hits": (2, 1024, 256, 16, 0.03, 0, (16, 32), "sparse", (640, 32, 128), True),
    # The register tile's edges (as SA_CASES): QPB not dividing T, K not a
    # multiple of 4, ragged widths, 1 and 8 layers, prelifted.
    "k1_one_layer": (2, 256, 64, 1, 0.2, 0, (24,), "sparse", (256, 16, 64), True),
    "k3_eight_layers": (1, 512, 64, 3, 0.3, 8, (8, 24, 72, 8, 24, 72, 264, 24), "dense", (384, 32, 128), True),
    "k7_cout72": (2, 512, 120, 7, 0.3, 0, (72, 8), "dense", (384, 40, 128), True),
    "k33_cs37": (1, 512, 96, 33, 0.3, 37, (72, 24), "sparse", (384, 32, 128), True),
    "k63_prelifted_cs131": (1, 512, 64, 63, 0.3, 131, (72, 264), "sparse", (384, 16, 128), False),
}


def _bucket_inputs(case, dev):
    b, n, m, k, radius, c, mlp, cloud, wtg, xyz_first = BUCKET_CASES[case]
    rng = np.random.RandomState(n + m + k + c)
    if cloud == "sparse":
        xyz = rng.randn(b, n, 3)
    elif cloud == "dense":  # clusters along x: balls with more than K hits
        centers = rng.randn(b, 16, 3) * np.array([4.0, 0.3, 0.3])
        xyz = centers[np.arange(b)[:, None], rng.randint(0, 16, (b, n))] + rng.randn(b, n, 3) * 0.05
    else:  # every tile's key range needs more than W points: overflow
        xyz = rng.randn(b, n, 3) * 0.05
    xyz = xyz.astype(np.float32)
    new_xyz = np.stack([x[rng.choice(n, m, replace=False)] for x in xyz])
    new_xyz += (0.02 * rng.randn(*new_xyz.shape)).astype(np.float32)  # off the points
    src = rng.randn(b, n, c).astype(np.float32) if c else None
    widths = (3 + c,) + tuple(mlp)
    weights = [(rng.randn(i, o) / np.sqrt(i)).astype(np.float32) for i, o in zip(widths, widths[1:])]
    biases = [(0.1 * rng.randn(o)).astype(np.float32) for o in mlp]

    def t(x):
        return None if x is None else torch.from_numpy(x).to(dev)

    args = (radius, k, t(xyz), t(new_xyz), t(src), [t(w) for w in weights], [t(v) for v in biases])
    return args, dict(xyz_first=xyz_first), dict(zip(("window", "qtile", "gblk"), wtg))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(BUCKET_CASES))
def test_sabucket_kernel_matches_safused_and_plain(dev, case, dtype):
    args, kw, wtg = _bucket_inputs(case, dev)
    before = (sa_ball_mlp_pool_bucketed.launches, rank_sort_points.launches)
    pooled, idx = sa_ball_mlp_pool_bucketed(*args, dtype=dtype, **kw, **wtg)
    torch.cuda.synchronize()
    flags = sa_ball_mlp_pool_bucketed.last_overflow.clone()
    assert idx is None
    assert (sa_ball_mlp_pool_bucketed.launches, rank_sort_points.launches) == (before[0] + 1, before[1] + 2)
    assert torch.equal(pooled, sa_ball_mlp_pool_bucketed(*args, dtype=dtype, **kw, **wtg)[0])
    full, _ = sa_ball_mlp_pool(*args, dtype=dtype, **kw)
    assert pooled.dtype == full.dtype and torch.equal(pooled, full)
    ref, _ = sa_ball_mlp_pool_bucketed_plain(*args, dtype=dtype, **kw, **wtg)
    _check_pooled(pooled, ref, dtype)
    assert torch.equal(ref, sa_ball_mlp_pool_plain(*args, dtype=dtype, **kw)[0])
    sa_ball_mlp_pool_bucketed(*[a.cpu() if torch.is_tensor(a) else a for a in args[:5]],
                              [w.cpu() for w in args[5]], [v.cpu() for v in args[6]], dtype=dtype, **kw, **wtg)
    assert torch.equal(flags.cpu(), sa_ball_mlp_pool_bucketed.last_overflow)
    assert bool(flags.any()) == (BUCKET_CASES[case][7] == "tight")


def test_sabucket_kernel_refuses_what_it_does_not_take(dev):
    args, kw, wtg = _bucket_inputs("sparse_k16", dev)
    for bad in ({**wtg, "window": 650}, {**wtg, "qtile": 60}, {**wtg, "window": 2048}):
        with pytest.raises(ValueError):
            sa_ball_mlp_pool_bucketed(*args, **kw, **bad)
    with pytest.raises(ValueError):
        sa_ball_mlp_pool_bucketed(args[0], 65, *args[2:], **kw, **wtg)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_ssg_eval_takes_the_bucketed_layer_at_2048_points(dev, dtype):
    from scanobjectnn_torch.models import get_model
    from scanobjectnn_torch.nn.pointnet_modules import configure_eval

    model = get_model("pointnet2_cls_ssg", dtype=dtype).eval()
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 2048, 3).astype(np.float32)).to(dev)
    counters = (sa_ball_mlp_pool_bucketed, rank_sort_points, sa_ball_mlp_pool)
    logits = {}
    for setting, want in (("auto", (1, 2, 1)), ("off", (0, 0, 2))):
        configure_eval(model, setting)
        before = [c.launches for c in counters]
        with torch.no_grad():
            logits[setting] = model(x)["logits"]
        torch.cuda.synchronize()
        assert tuple(c.launches - b for c, b in zip(counters, before)) == want, setting
    assert torch.equal(logits["auto"], logits["off"])


# The training loop: the trainer's kernel switch, checkpoints across
# devices and the command line on the card.

def _ssg_batch(seed, b=4, n=1024, classes=4):
    rng = np.random.RandomState(seed)
    return {"points": rng.randn(b, n, 3).astype(np.float32), "labels": rng.randint(0, classes, b)}


TRAINER_COUNTERS = {"fps": fps, "query_ball_group": query_ball_group, "gather_rows": gather_rows,
                    "scatter_add_rows": scatter_add_rows, "sa_ball_mlp_pool": sa_ball_mlp_pool}


def _counts():
    out = {k: c.launches for k, c in TRAINER_COUNTERS.items()}
    out["fps_indices"] = fps.index_launches
    return out


def _moved(before):
    torch.cuda.synchronize()
    return {k: v - before[k] for k, v in _counts().items()}


def test_trainer_launches_its_kernels_and_lax_launches_none(dev):
    from scanobjectnn_torch.train.trainer import Trainer, TrainerConfig

    trainers = {b: Trainer(TrainerConfig(num_classes=4, batch_size=4, ops_backend=b)) for b in ("auto", "lax")}
    states = {b: t.init_state() for b, t in trainers.items()}
    for round_ in range(2):  # auto, lax, then auto again: nothing left set
        before = _counts()
        trainers["auto"].train_step(states["auto"], _ssg_batch(round_))
        step = _moved(before)
        assert step["fps_indices"] == 2 and step["fps"] == 2  # #2 at SA1 and SA2, no #1
        assert step["query_ball_group"] == 2 and step["gather_rows"] > 0 and step["scatter_add_rows"] > 0
        before = _counts()
        trainers["auto"].eval_votes(states["auto"], _ssg_batch(5), num_votes=2)
        votes = _moved(before)
        assert votes["fps"] == 2 and votes["fps_indices"] == 0 and votes["sa_ball_mlp_pool"] == 2  # #1, #3
        before = _counts()
        trainers["lax"].train_step(states["lax"], _ssg_batch(round_))
        trainers["lax"].eval_votes(states["lax"], _ssg_batch(5), num_votes=2)
        assert set(_moved(before).values()) == {0}


def test_checkpoint_from_the_card_restores_on_the_cpu_and_back(dev, tmp_path):
    from scanobjectnn_torch.train.trainer import Trainer, TrainerConfig

    def trainer(device, log):
        return Trainer(TrainerConfig(num_classes=4, batch_size=4, device=device, log_dir=str(tmp_path / log)))

    card = trainer("cuda", "card")
    state = card.init_state()
    for seed in (0, 1):
        state, _ = card.train_step(state, _ssg_batch(seed))
    card.save(state)
    cpu = trainer("cpu", "card")
    on_cpu = cpu.restore(cpu.init_state(seed=3))
    for (k, a), (_, b) in zip(state.model.state_dict().items(), on_cpu.model.state_dict().items()):
        assert b.device.type == "cpu" and torch.equal(a.cpu(), b), k
    sa, sb = state.optimizer.state_dict()["state"], on_cpu.optimizer.state_dict()["state"]
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k].cpu(), sb[i][k].cpu()), (i, k)
    assert on_cpu.step == state.step == 2
    trainer("cpu", "cpu").save(on_cpu)
    back_trainer = trainer("cuda", "cpu")
    back = back_trainer.restore(back_trainer.init_state(seed=4))
    for (k, a), (_, b) in zip(state.model.state_dict().items(), back.model.state_dict().items()):
        assert b.device.type == "cuda" and torch.equal(a, b), k
    sb = back.optimizer.state_dict()["state"]
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]) and sa[i][k].device == sb[i][k].device, (i, k)
    # The generator crossed no device type on the card's own restore.
    again = card.restore(card.init_state(seed=5))
    assert torch.equal(again.generator.get_state(), state.generator.get_state())
    a, _ = card.train_step(state, _ssg_batch(2))
    b, _ = card.train_step(again, _ssg_batch(2))
    for (k, x), (_, y) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert torch.equal(x, y), k


def test_cli_device_cuda_builds_the_model_on_the_card(dev, tmp_path, monkeypatch):
    from scanobjectnn_torch.train import cli
    from scanobjectnn_torch.train.trainer import Trainer

    monkeypatch.chdir(tmp_path)
    data = _ssg_batch(0, b=8)  # no h5 file: the card's machine has no h5py
    seen = []
    init_state = Trainer.init_state

    def recording(self, *a, **kw):
        state = init_state(self, *a, **kw)
        seen.append({p.device.type for p in state.model.parameters()})
        return state

    monkeypatch.setattr(Trainer, "init_state", recording)
    monkeypatch.setattr(cli, "_load", lambda path, with_bg, num_point, mode="cls": (
        data["points"], data["labels"], None))
    cli.main(["evaluate", "--num_class", "4", "--batch_size", "4", "--log_dir", "log"])
    assert seen == [{"cuda"}]


@pytest.mark.parametrize("k,cin,cout", [(5, 256, 128), (3, 512, 256), (1, 20, 64)])
def test_3dmfv_conv_ignores_cudnn_tf32(dev, k, cin, cout):
    # 3DmFV's inception convolutions (the 5³ and 3³ of inception3 and
    # inception5, a 1³ on the Fisher vector): the same f32 bits, output and
    # both gradients, with TF32 allowed, and the caller's flag put back.
    # cuDNN's weight gradient may sum with atomics (two equal calls then
    # differ in the last bits): the test takes its deterministic algorithms.
    from scanobjectnn_torch.models.threedmfv import _Conv

    g = torch.Generator().manual_seed(k * cin)
    conv = _Conv(cin, cout, k)
    conv.reset_parameters(g)
    conv = conv.to(dev)
    x = torch.randn(8, 5, 5, 5, cin, generator=g).to(dev).requires_grad_()
    dy = torch.randn(8, 5, 5, 5, cout, generator=g).to(dev)
    runs = []
    deterministic = torch.backends.cudnn.deterministic
    for flag in (False, True, False):
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = flag, True
        try:
            y = conv(x)
            dx, dw = torch.autograd.grad(y, (x, conv.kernel), dy)
            assert torch.backends.cudnn.allow_tf32 == flag
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = False, deterministic
        runs.append((y.detach(), dx, dw))
    for a, b in zip(runs[0], runs[1]):
        assert torch.equal(a, b)
    want = torch.nn.functional.conv3d(x.detach().permute(0, 4, 1, 2, 3), conv.kernel.detach().permute(4, 3, 0, 1, 2),
                                      conv.bias.detach(), padding=k // 2)
    torch.testing.assert_close(runs[0][0].permute(0, 4, 1, 2, 3), want, rtol=0, atol=0)


@pytest.mark.parametrize("kw", [{}, {"subdivisions": (3, 3, 3), "learnable_gmm": True}], ids=["static5", "learnable3"])
def test_3dmfv_f32_steps_are_bit_stable(dev, kw):
    # Two equal f32 steps (B=8, the 5³ static and the 3³ learnable GMM):
    # the same bits in the loss, every gradient and every BN statistic
    # (cuDNN's deterministic algorithms inside the model's convolutions,
    # the average pool's backward without atomics), with the caller's cuDNN
    # flags (TF32 on, determinism off) as they were, inside and after.
    from scanobjectnn_torch.data.synthetic import make_synthetic_dataset
    from scanobjectnn_torch.models import get_model

    points, labels = make_synthetic_dataset(num_per_class=2, num_classes=4, num_points=1024, seed=5)
    x, y = torch.from_numpy(points).to(dev), torch.from_numpy(labels).to(dev)
    cudnn = torch.backends.cudnn
    before = cudnn.allow_tf32, cudnn.deterministic
    steps = []
    try:
        cudnn.allow_tf32, cudnn.deterministic = True, False
        for _ in range(2):
            model = get_model("3dmfv_net_cls", generator=torch.Generator().manual_seed(0), num_classes=4, **kw).train()
            out = model(x, bn_momentum=0.9, generator=torch.Generator(device=dev).manual_seed(1))
            loss, _ = model.loss(out, {"labels": y})
            loss.backward()
            torch.cuda.synchronize()
            assert (cudnn.allow_tf32, cudnn.deterministic) == (True, False)
            steps.append((loss.detach(), {n: q.grad for n, q in model.named_parameters()},
                          {n: b.clone() for n, b in model.named_buffers()}))
    finally:
        cudnn.allow_tf32, cudnn.deterministic = before
    (loss_a, grads_a, stats_a), (loss_b, grads_b, stats_b) = steps
    assert bool(torch.isfinite(loss_a)) and same_bits(loss_a, loss_b)
    assert all(g is not None for g in grads_a.values())
    differ = [n for n in grads_a if not same_bits(grads_a[n], grads_b[n])]
    differ += [n for n in stats_a if not same_bits(stats_a[n], stats_b[n])]
    assert not differ, differ


@pytest.mark.parametrize("name", ["pointnet_seg", "3dmfv_net_cls"])
def test_pointnet_and_3dmfv_forward_on_the_card_match_the_cpu(dev, name):
    from scanobjectnn_torch.data.synthetic import make_synthetic_dataset
    from scanobjectnn_torch.models import get_model

    points, _ = make_synthetic_dataset(num_per_class=1, num_classes=4, num_points=1024, seed=3)
    cpu = get_model(name, generator=torch.Generator().manual_seed(0), device="cpu").eval()
    rng = np.random.RandomState(1)
    with torch.no_grad():
        for key, buf in cpu.named_buffers():
            if key.endswith((".mean", ".var")):
                vals = rng.randn(*buf.shape)
                buf.copy_(torch.from_numpy(0.1 + 0.1 * np.abs(vals) if key.endswith(".var") else 0.05 * np.abs(vals)))
        card = get_model(name, device="cuda").eval()
        card.load_state_dict(cpu.state_dict())
        want = cpu(torch.from_numpy(points))
        got = card(torch.from_numpy(points).to(dev))
    for key in ("logits", "seg_logits"):
        if key not in want:
            continue
        g, w = got[key].cpu(), want[key]
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * max(1.0, float(w.abs().max())))
        agree = float((g.argmax(-1) == w.argmax(-1)).float().mean())
        assert agree >= (0.99 if key == "seg_logits" else 1.0), (key, agree)


# ------------------------------------------------- bf16 training's backward


def _bf16_cast(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 values, kept in f32."""
    return t.to(torch.bfloat16).float()


@pytest.mark.parametrize("case", ["ec2", "ec4"])
def test_edge_reduce_bwd_on_bf16_values_and_cotangents(dev, case):
    # A bf16 EdgeConv hands #14 bf16 values (cast to f32 by the wrapper)
    # and f32 cotangents of bf16-rounded products: the gradient comes back
    # in bf16, the kernel's f32 sum cast once, bit-stable and equal to
    # edge_reduce_bwd_ordered.
    b, n, cf, cv, k, lattice = EDGE_CASES[case]
    feats, vals = _edge_inputs(dev, b, n, cf, cv, lattice, seed=n + cv + 1)
    v = vals.to(torch.bfloat16).requires_grad_()
    before = edge_reduce_bwd_kernel.launches
    red = edge_reduce(_bf16_cast(feats), v, k)
    rng = np.random.RandomState(3)
    cot = [_bf16_cast(torch.from_numpy(rng.randn(b, n, cv).astype(np.float32)).to(dev)) for _ in range(4)]
    (grad,) = torch.autograd.grad([red[key] for key in ("mmax", "mmin", "s", "q2")], v, cot)
    saved = (v.detach().float(), red["idx"], red["mmax"], red["mmin"], red["cntmax"], red["cntmin"])
    again = edge_reduce_bwd_kernel(*saved, *cot)
    ordered = edge_reduce_bwd_ordered(*saved, *cot)
    torch.cuda.synchronize()
    assert edge_reduce_bwd_kernel.launches == before + 2
    assert grad.dtype == torch.bfloat16 and again.dtype == torch.float32
    assert torch.equal(again, ordered), "the backward differs from edge_reduce_bwd_ordered"
    assert torch.equal(grad, again.to(torch.bfloat16)), "the bf16 gradient is not the kernel's sum cast once"


def test_scatter_add_on_bf16_cotangents_is_the_cpu_index_order_sum(dev):
    # The T-Net's rows (#15, backward #7) and X-Conv's gather (#6, backward
    # #7) in a bf16 step: bf16 cotangents, summed in f32 by the scatter-add
    # and cast once, bit for bit the CPU's index-order sum cast, twice.
    b, n, k, cv = 4, 1024, 20, 64
    g = torch.Generator().manual_seed(5)
    points = torch.randn(b, n, 3, generator=g).to(dev)
    c2 = torch.randn(b, n, cv, generator=g).to(torch.bfloat16).to(dev)
    cot = torch.randn(b, n, k, cv, generator=g).to(torch.bfloat16).to(dev)
    for label in ("edge_gather_knn", "gather_neighbors"):
        grads = []
        for _ in range(2):
            v = c2.clone().requires_grad_()
            if label == "edge_gather_knn":
                rows, idx = edge_gather_knn(points, v, k)
            else:
                idx = knn_graph_kernel(points, k)
                rows = gather_neighbors(v.float().contiguous(), idx).to(torch.bfloat16)
            assert rows.dtype == torch.bfloat16
            (grad,) = torch.autograd.grad(rows, v, cot)
            grads.append(grad)
        torch.cuda.synchronize()
        assert grads[0].dtype == torch.bfloat16 and torch.equal(grads[0], grads[1]), label
        flat = idx.reshape(b, n * k)
        want = _index_order_sum(flat, cot.float().reshape(b, n * k, cv), n).to(torch.bfloat16)
        assert torch.equal(grads[0].cpu(), want), label


@pytest.mark.parametrize("case", ["conv2", "conv4"])
def test_spider_conv_backward_on_bf16_inputs_is_bit_stable(dev, case):
    # A bf16 SpiderConv hands #16 its bf16 layer input cast to f32 and the
    # cotangent of its f32 output cast to bf16: dfeat comes back in bf16
    # (the kernels' f32 gradient cast once), dg and dkernel in f32; two
    # calls give the same bits, within SPIDER_BWD_TOL of the plain version.
    feat, idx, g, kernel, dout = _spider_inputs(dev, SPIDER_CASES[case], seed=7)
    fb = feat.to(torch.bfloat16).requires_grad_()
    dout = _bf16_cast(dout)
    runs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_() for t in (g, kernel)]
        out = spider_conv(fb.float(), idx, leaves[0], leaves[1])
        runs.append(torch.autograd.grad(out, [fb, *leaves], dout))
    plain = [t.clone().requires_grad_() for t in (fb.detach().float(), g, kernel)]
    ref = torch.autograd.grad(spider_conv_plain(plain[0], idx, plain[1], plain[2]), plain, dout)
    torch.cuda.synchronize()
    assert runs[0][0].dtype == torch.bfloat16 and runs[0][1].dtype == runs[0][2].dtype == torch.float32
    for name, a, twice, want in zip(("dfeat", "dg", "dkernel"), runs[0], runs[1], ref):
        assert torch.equal(a, twice), f"{name}: the backward is not bit-stable"
        err = float((a.float() - want).abs().max())
        tol = SPIDER_BWD_TOL * max(1.0, float(want.abs().max()))
        if name == "dfeat":  # plus the bf16 rounding of the f32 gradient
            tol += float(want.abs().max()) * 2.0 ** -8
        assert err <= tol, (name, err)


@pytest.mark.parametrize("kw", [{}, {"subdivisions": (3, 3, 3), "learnable_gmm": True}], ids=["static5", "learnable3"])
def test_3dmfv_bf16_steps_are_bit_stable(dev, kw):
    # Two equal bf16 steps (B=8): the same bits in the loss, every gradient
    # and every BN statistic (cuDNN's deterministic bf16 algorithms inside
    # the model's convolutions), with the caller's cuDNN flags kept.
    from scanobjectnn_torch.data.synthetic import make_synthetic_dataset
    from scanobjectnn_torch.models import get_model

    points, labels = make_synthetic_dataset(num_per_class=2, num_classes=4, num_points=1024, seed=5)
    x, y = torch.from_numpy(points).to(dev), torch.from_numpy(labels).to(dev)
    cudnn = torch.backends.cudnn
    before = cudnn.allow_tf32, cudnn.deterministic
    steps = []
    try:
        cudnn.allow_tf32, cudnn.deterministic = True, False
        for _ in range(2):
            model = get_model("3dmfv_net_cls", generator=torch.Generator().manual_seed(0), num_classes=4,
                              dtype=torch.bfloat16, **kw).train()
            out = model(x, bn_momentum=0.9, generator=torch.Generator(device=dev).manual_seed(1))
            assert out["logits"].dtype == torch.bfloat16
            loss, _ = model.loss(out, {"labels": y})
            loss.backward()
            torch.cuda.synchronize()
            assert (cudnn.allow_tf32, cudnn.deterministic) == (True, False)
            steps.append((loss.detach(), {n: q.grad for n, q in model.named_parameters()},
                          {n: b.clone() for n, b in model.named_buffers()}))
    finally:
        cudnn.allow_tf32, cudnn.deterministic = before
    (loss_a, grads_a, stats_a), (loss_b, grads_b, stats_b) = steps
    assert bool(torch.isfinite(loss_a)) and same_bits(loss_a, loss_b)
    assert all(g is not None and g.dtype == torch.float32 for g in grads_a.values())
    differ = [n for n in grads_a if not same_bits(grads_a[n], grads_b[n])]
    differ += [n for n in stats_a if not same_bits(stats_a[n], stats_b[n])]
    assert not differ, differ


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("name,kw", [("pointnet2_cls_ssg", {}), ("dgcnn_bga", {}),
                                     ("pointnet2_cls_ssg", {"fused_sa_train": True}),
                                     ("pointnet2_cls_ssg", {"dtype": "bfloat16"})],
                         ids=["pointnet2_cls_ssg", "dgcnn_bga", "pointnet2_cls_ssg-fused", "pointnet2_cls_ssg-bf16"])
def test_world_one_group_steps_are_the_no_group_steps_bit_for_bit(dev, name, kw):
    # A group of one rank (NCCL) calls every collective, each a copy: two
    # momentum steps equal the no-group trainer's bit for bit, the fused
    # ops (#17's backward a pass a call, #18) included.
    import torch.distributed as dist

    from scanobjectnn_torch.data.synthetic import make_synthetic_dataset
    from scanobjectnn_torch.parallel import make_mesh
    from scanobjectnn_torch.train.trainer import Trainer, TrainerConfig

    data, labels, masks = make_synthetic_dataset(num_per_class=2, num_classes=4, num_points=1024, seed=7,
                                                 with_mask=True)
    batches = [{"points": data[i::2], "labels": labels[i::2], "masks": (masks[i::2] >= 0).astype(np.int64)}
               for i in range(2)]
    cfg = TrainerConfig(model=name, num_classes=4, batch_size=4, optimizer="momentum", **kw)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}", rank=0, world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        runs = []
        for mesh in (make_mesh(f"cuda:{torch.cuda.current_device()}"), None):
            trainer = Trainer(cfg, mesh=mesh)
            state = trainer.init_state()
            losses = [trainer.train_step(state, b)[1]["loss"] for b in batches]
            runs.append((torch.stack(losses), state.model.state_dict()))
    finally:
        dist.destroy_process_group()
    (loss_g, sd_g), (loss_1, sd_1) = runs
    assert same_bits(loss_g, loss_1)
    differ = [k for k in sd_1 if not same_bits(sd_g[k], sd_1[k])]
    assert not differ, differ


def test_auction_match_on_the_card_equals_the_cpu(dev):
    from scanobjectnn_torch import ops

    rng = np.random.RandomState(3)
    a, b = (torch.from_numpy(rng.rand(3, 64, 3).astype(np.float32)) for _ in range(2))
    cpu = ops.auction_match(a, b)
    card = ops.auction_match(a.to(dev), b.to(dev))
    for got, want in zip(card, cpu):
        assert torch.equal(got.cpu(), want)
    np.testing.assert_allclose(float(ops.emd_loss(a.to(dev), b.to(dev))), float(ops.emd_loss(a, b)), rtol=1e-6)


def test_interp_check_main_writes_its_three_frames_on_the_card(dev, tmp_path):
    # three_nn and three_interpolate through the kNN and gather kernels, equal
    # to their plain versions: the PNGs are the CPU run's byte for byte.
    from scanobjectnn_torch.ops.cuda.gather_kernel import gather_rows
    from scanobjectnn_torch.ops.cuda.knn_kernel import knn_point_kernel
    from scanobjectnn_torch.viz import interp_check

    before = knn_point_kernel.launches, gather_rows.launches
    card = interp_check.main(str(tmp_path / "card"))
    assert knn_point_kernel.launches > before[0] and gather_rows.launches > before[1]
    cpu = interp_check.main(str(tmp_path / "cpu"), device="cpu")
    assert [os.path.basename(p) for p in card] == ["interp_known.png", "interp_queries.png", "interp_all.png"]
    for p, q in zip(card, cpu):
        with open(p, "rb") as f, open(q, "rb") as g:
            assert f.read() == g.read()
