"""PyTorch port: the EdgeConv reduce's backward in the card kernel's order
(``edge_reduce_bwd_ordered``, the plain version that ``csrc/edge.cu``'s
backward must equal bit for bit) and the backward's slice plan
(``bwd_slice_width``), on the CPU.

The ordered backward is held to JAX's VJP of ``edge_reduce_lax`` and of
``edge_reduce_pallas`` (interpret mode), and to autograd through
``reduce_neighbors_plain``, at ``tests/test_torch_edge.py``'s shapes and on
its lattice ties; and bit for bit to a direct transcription of the kernel's
loop (one f32 operation at a time, per point, per edge in ascending
(query, slot) order) on small clouds with signed zeros, ties and a NaN.

Tolerances, and why: against lax and autograd within ``VJP_TOL`` x max(1,
|ref|max) (the same coefficients, summed in another order); against the
Pallas VJP within ``PALLAS_VJP_TOL`` x max(1, |ref|max) (its scatter sums a
two-term bf16 split of the coefficients); against the transcription, equal
(NaN where it has NaN).
"""

import numpy as np
import pytest
import torch

from scanobjectnn_tpu.ops.pallas import edge_kernel as jedge
from scanobjectnn_torch.ops.cuda.edge_kernel import (
    BWD_SMEM_BYTES,
    BWD_STAGED_BYTES,
    bwd_slice_width,
    edge_reduce,
    edge_reduce_bwd_ordered,
    reduce_neighbors_plain,
)

from tests.test_torch_edge import CASES, DIFF, PALLAS_VJP_TOL, VJP_TOL, _assert_scaled, _clouds, _lattice, _vjp_jax
from tests.test_torch_knn_graph import clear_rows


def _ordered_and_autograd(feats, vals, k, cot):
    """(edge_reduce_bwd_ordered, autograd through reduce_neighbors_plain)
    over the port's graph of ``feats``, as numpy arrays."""
    red = edge_reduce(torch.from_numpy(feats), torch.from_numpy(vals), k)
    cots = [torch.from_numpy(cot[key]) for key in DIFF]
    got = edge_reduce_bwd_ordered(torch.from_numpy(vals), red["idx"], red["mmax"], red["mmin"], red["cntmax"],
                                  red["cntmin"], *cots)
    v = torch.from_numpy(vals).requires_grad_()
    plain = reduce_neighbors_plain(v, red["idx"])
    (ref,) = torch.autograd.grad([plain[key] for key in DIFF], v, cots)
    assert got.dtype == torch.float32 and got.shape == vals.shape
    return got.numpy(), ref.numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_ordered_backward_matches_jax_and_autograd(case):
    b, n, cf, cv, k, seed = CASES[case]
    feats, vals = _clouds(seed, b, n, cf, cv)
    assert clear_rows(feats, k).all()
    rng = np.random.RandomState(1)
    cot = {key: rng.randn(b, n, cv).astype(np.float32) for key in DIFF}
    got, ref = _ordered_and_autograd(feats, vals, k, cot)
    _assert_scaled(got, ref, VJP_TOL, f"{case} ordered vs autograd")
    _assert_scaled(got, _vjp_jax(jedge.edge_reduce_lax, feats, vals, k, cot), VJP_TOL, f"{case} ordered vs lax")
    _assert_scaled(got, _vjp_jax(jedge.edge_reduce_pallas, feats, vals, k, cot), PALLAS_VJP_TOL,
                   f"{case} ordered vs pallas")


def test_ordered_backward_splits_ties_as_jax():
    # Duplicated lattice points: the graph ties at d² = 0 and the values tie
    # in max and min (cntmax, cntmin > 1): the quotients split dmax and dmin.
    feats = _lattice(0, 2, 128, 3)
    vals = np.concatenate([_lattice(1, 2, 128, 6), np.zeros((2, 128, 2), np.float32)], -1)
    k = 20
    red = edge_reduce(torch.from_numpy(feats), torch.from_numpy(vals), k)
    assert float(red["cntmax"].max()) > 1 and float(red["cntmin"].max()) > 1
    rng = np.random.RandomState(2)
    cot = {key: rng.randn(*vals.shape).astype(np.float32) for key in DIFF}
    got, ref = _ordered_and_autograd(feats, vals, k, cot)
    _assert_scaled(got, ref, VJP_TOL, "ties ordered vs autograd")
    _assert_scaled(got, _vjp_jax(jedge.edge_reduce_lax, feats, vals, k, cot), VJP_TOL, "ties ordered vs lax")
    _assert_scaled(got, _vjp_jax(jedge.edge_reduce_pallas, feats, vals, k, cot), PALLAS_VJP_TOL,
                   "ties ordered vs pallas")


def _kernel_loop(vals, idx, mmax, mmin, cntmax, cntmin, dmax, dmin, ds, dq2):
    """The kernel's sum transcribed: for each point and channel, its edges
    in ascending (query, slot) order, one f32 operation at a time."""
    f = np.float32
    b, n, cv = vals.shape
    k = idx.shape[-1]
    out = np.zeros_like(vals)
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        for bb in range(b):
            for j in range(n):
                edges = [e for e in range(n * k) if idx[bb].reshape(-1)[e] == j]
                for c in range(cv):
                    g = vals[bb, j, c]
                    acc = f(0.0)
                    for e in edges:
                        q = e // k
                        coeff = f(ds[bb, q, c] + f(f(f(2.0) * g) * dq2[bb, q, c]))
                        if g == mmax[bb, q, c]:
                            coeff = f(coeff + f(dmax[bb, q, c] / np.fmax(cntmax[bb, q, c], f(1.0))))
                        if g == mmin[bb, q, c]:
                            coeff = f(coeff + f(dmin[bb, q, c] / np.fmax(cntmin[bb, q, c], f(1.0))))
                        acc = f(acc + coeff)
                    out[bb, j, c] = acc
    return out


@pytest.mark.parametrize("kind", ["random", "ties_zeros_nan"])
def test_ordered_backward_is_the_kernel_loop_bit_for_bit(kind):
    rng = np.random.RandomState(3)
    b, n, cv, k = 2, 24, 5, 6
    if kind == "random":
        feats, vals = _clouds(4, b, n, 3, cv)
    else:
        feats = _lattice(5, b, n, 3)
        vals = _lattice(6, b, n, cv)
        vals[:, :, 0] = 0.0
        vals[0, 3, 1] = np.nan
        vals[1, 7, 2] = -0.0
    red = edge_reduce(torch.from_numpy(feats), torch.from_numpy(vals), k)
    cot = [rng.randn(b, n, cv).astype(np.float32) for _ in DIFF]
    if kind != "random":
        for t in cot:  # signed zeros in the cotangents: coefficients of -0.0 and +0.0
            t[:, ::3, 0] = -0.0
            t[:, 1::3, 0] = 0.0
    args = [red[key].numpy() for key in ("mmax", "mmin", "cntmax", "cntmin")]
    got = edge_reduce_bwd_ordered(torch.from_numpy(vals), red["idx"], *map(torch.from_numpy, args),
                                  *map(torch.from_numpy, cot)).numpy()
    want = _kernel_loop(vals, red["idx"].numpy(), *args, *cot)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(got[ok].view(np.int32), want[ok].view(np.int32))
    if kind != "random":
        assert np.isnan(want).any() and float(red["cntmax"].max()) > 1


def test_ordered_backward_leaves_out_indices_outside_the_cloud():
    # The counting sort drops an edge whose index is outside [0, N); so does
    # the ordered backward.
    rng = np.random.RandomState(7)
    b, n, cv, k = 1, 16, 3, 4
    vals = rng.randn(b, n, cv).astype(np.float32)
    idx = torch.from_numpy(rng.randint(0, n, (b, n, k)).astype(np.int32))
    red = reduce_neighbors_plain(torch.from_numpy(vals), idx)
    args = [red[key] for key in ("mmax", "mmin", "cntmax", "cntmin")]
    cot = [torch.from_numpy(rng.randn(b, n, cv).astype(np.float32)) for _ in DIFF]
    want = edge_reduce_bwd_ordered(torch.from_numpy(vals), idx, *args, *cot)
    bad = idx.clone()
    bad[0, 2, 1], bad[0, 9, 3] = -1, n
    got = edge_reduce_bwd_ordered(torch.from_numpy(vals), bad, *args, *cot)
    kept = torch.ones(n, dtype=torch.bool)
    kept[[int(idx[0, 2, 1]), int(idx[0, 9, 3])]] = False
    assert torch.equal(got[0, kept], want[0, kept])
    assert not torch.equal(got, want)


@pytest.mark.parametrize("n,width", [(1, 8), (1024, 8), (1210, 8), (1211, 4), (2048, 4), (4842, 2), (4843, 1),
                                     (9685, 1), (9686, 0), (50000, 0)])
def test_bwd_slice_width_at_the_shared_memory_bounds(n, width):
    # 24 bytes a (query, channel) staged; a block may hold 227 KB.
    assert bwd_slice_width(n, 64) == width
    if width:
        assert BWD_STAGED_BYTES * n * width <= BWD_SMEM_BYTES
        assert width == 8 or BWD_STAGED_BYTES * n * 2 * width > BWD_SMEM_BYTES
    else:
        assert BWD_STAGED_BYTES * n > BWD_SMEM_BYTES


@pytest.mark.parametrize("cv", [1, 2, 3, 5, 8, 24, 64, 65, 128, 256])
@pytest.mark.parametrize("n", [33, 1024, 2048, 9685])
def test_bwd_slices_cover_every_channel_once(n, cv):
    s = bwd_slice_width(n, cv)
    assert s in (1, 2, 4, 8) and (s == 1 or s // 2 < cv)  # no slice wider than the channels need
    covered = [c for c0 in range(0, cv, s) for c in range(c0, min(c0 + s, cv))]
    assert covered == list(range(cv))
