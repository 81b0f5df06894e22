"""PyTorch port, neighbour gather and its scatter-add backward: the port's
``gather_neighbors`` on CPU tensors (the CUDA kernels' plain versions)
against the JAX ``gather_neighbors_pallas`` (interpreted Pallas one-hot
gather, ``onehot.flat_gather``/``flat_scatter``) and
``batched_index_gather`` (also held against the port's plain
``ops.batched_index_gather`` and ``ops.group_point``).

The forward is an exact copy: equal to both.  The gradient is the exact
f32 scatter-add: it must match ``jax.grad`` of ``batched_index_gather``
(XLA's exact scatter) to 1e-6 x max|ref| (summation order only), and the
interpreted Pallas VJP, which sums a 2-term bf16 split of the cotangent,
within 2e-4 x max|ref|, the bound of ``tests/test_ops_parity.py``.  The CUDA
kernels are held against the plain versions by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanobjectnn_tpu.ops.grouping import batched_index_gather
from scanobjectnn_tpu.ops.pallas import edge_kernel
from scanobjectnn_torch import ops
from scanobjectnn_torch.ops.cuda import gather_kernel
from scanobjectnn_torch.ops.cuda.gather_kernel import (
    count_sort_plain,
    gather_neighbors,
    gather_rows,
    scatter_add_rows,
    scatter_add_rows_plain,
)

# (b, n, c, m, k): SA2-like (many repeats per point) and a ragged width
CASES = {"sa2_like": (2, 64, 16, 24, 8), "narrow_c": (1, 40, 5, 16, 4), "wide_c": (2, 32, 48, 8, 8)}


def _inputs(rng, b, n, c, m, k):
    vals = rng.randn(b, n, c).astype(np.float32)
    idx = rng.randint(0, n, size=(b, m, k)).astype(np.int32)
    idx[:, :, k // 2:] = idx[:, :, :1]  # padded rows repeat the first hit
    cot = rng.randn(b, m, k, c).astype(np.float32)
    return vals, idx, cot


@pytest.mark.parametrize("case", sorted(CASES))
def test_gather_neighbors_matches_jax(rng, case):
    vals, idx, cot = _inputs(rng, *CASES[case])
    v = torch.from_numpy(vals).requires_grad_()
    out = gather_neighbors(v, torch.from_numpy(idx))
    want = np.asarray(batched_index_gather(jnp.asarray(vals), jnp.asarray(idx)))
    np.testing.assert_array_equal(out.detach().numpy(), want)
    # The port's plain-indexing counterparts give the same rows.
    for fn in (ops.batched_index_gather, ops.group_point):
        np.testing.assert_array_equal(fn(torch.from_numpy(vals), torch.from_numpy(idx)).numpy(), want)
    if CASES[case][2] % 8 == 0:  # the Pallas path's channel rule (edge_kernel.gather_neighbors)
        np.testing.assert_array_equal(
            out.detach().numpy(), np.asarray(edge_kernel.gather_neighbors_pallas(jnp.asarray(vals), jnp.asarray(idx)))
        )

    (grad,) = torch.autograd.grad(out, v, torch.from_numpy(cot))
    grad = grad.numpy()

    def vjp(fn):
        _, pull = jax.vjp(lambda x: fn(x, jnp.asarray(idx)), jnp.asarray(vals))
        return np.asarray(pull(jnp.asarray(cot))[0])

    exact = vjp(batched_index_gather)
    scale = np.abs(exact).max()
    assert np.abs(grad - exact).max() <= 1e-6 * scale
    if CASES[case][2] % 8 == 0:
        split = vjp(edge_kernel.gather_neighbors_pallas)
        assert np.abs(grad - split).max() <= 2e-4 * scale


def test_scatter_add_plain_is_index_order_sum(rng):
    b, n, r, c = 2, 10, 40, 3
    idx = rng.randint(0, n, size=(b, r)).astype(np.int32)
    upd = rng.randn(b, r, c).astype(np.float32)
    want = np.zeros((b, n, c), np.float32)
    for i in range(b):
        for row in range(r):  # ascending rows, as the CUDA kernel sums
            want[i, idx[i, row]] += upd[i, row]
    got = scatter_add_rows_plain(torch.from_numpy(idx), torch.from_numpy(upd), n)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.float32


@pytest.mark.parametrize("n", [1, 10, 300])
def test_count_sort_plain_is_the_inverse_index(rng, n):
    """offsets and perm against numpy's stable argsort, out-of-range rows
    dropped; summing each point's rows through perm in order is the
    index-order scatter-add bit for bit (what the CUDA sum kernel does)."""
    b, r, c = 3, 257, 4
    idx = rng.randint(-1, n + 1, size=(b, r)).astype(np.int32)
    upd = rng.randn(b, r, c).astype(np.float32)
    offsets, perm = count_sort_plain(torch.from_numpy(idx), n)
    want = np.zeros((b, n, c), np.float32)
    for i in range(b):
        valid = (idx[i] >= 0) & (idx[i] < n)
        key = np.where(valid, idx[i], n)
        counts = np.bincount(key, minlength=n + 1)[:n]
        np.testing.assert_array_equal(offsets[i].numpy(), np.concatenate([[0], np.cumsum(counts)]))
        used = int(valid.sum())
        np.testing.assert_array_equal(perm[i, :used].numpy(), np.argsort(key, kind="stable")[:used])
        assert (perm[i, used:] == -1).all()
        for j in range(n):
            for row in perm[i, offsets[i, j]:offsets[i, j + 1]].tolist():
                want[i, j] += upd[i, row]
    kept = np.where((idx >= 0) & (idx < n), idx, 0)
    dropped = np.where(((idx >= 0) & (idx < n))[..., None], upd, 0.0).astype(np.float32)
    got = scatter_add_rows_plain(torch.from_numpy(kept), torch.from_numpy(dropped), n)
    np.testing.assert_array_equal(got.numpy(), want)


def test_backward_goes_through_the_scatter_wrapper(rng, monkeypatch):
    vals, idx, cot = _inputs(rng, *CASES["sa2_like"])
    calls = []

    def counted(i, u, n):
        calls.append((tuple(i.shape), tuple(u.shape), n))
        return scatter_add_rows(i, u, n)

    monkeypatch.setattr(gather_kernel, "scatter_add_rows", counted)
    v = torch.from_numpy(vals).requires_grad_()
    gather_neighbors(v, torch.from_numpy(idx)).backward(torch.from_numpy(cot))
    b, n, c, m, k = CASES["sa2_like"]
    assert calls == [((b, m * k), (b, m * k, c), n)]


def test_cpu_tensors_take_plain_versions_without_launch(rng):
    vals, idx, cot = _inputs(rng, *CASES["narrow_c"])
    flat = torch.from_numpy(idx.reshape(idx.shape[0], -1))
    before = (gather_rows.launches, scatter_add_rows.launches)
    got = gather_rows(torch.from_numpy(vals), flat)
    assert torch.equal(got, gather_kernel.gather_rows_plain(torch.from_numpy(vals), flat))
    upd = torch.from_numpy(cot.reshape(cot.shape[0], -1, cot.shape[-1]))
    assert torch.equal(scatter_add_rows(flat, upd, vals.shape[1]), scatter_add_rows_plain(flat, upd, vals.shape[1]))
    assert (gather_rows.launches, scatter_add_rows.launches) == before == (0, 0)


def test_wrappers_refuse_other_devices():
    with pytest.raises(ValueError):
        gather_rows(torch.zeros(1, 8, 4, device="meta"), torch.zeros(1, 3, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):
        scatter_add_rows(torch.zeros(1, 3, dtype=torch.int32, device="meta"), torch.zeros(1, 3, 4, device="meta"), 8)
