"""PyTorch port, ball query + centred grouping: the port's
``ops.query_ball_group`` on CPU tensors (the CUDA kernel's plain version)
against the JAX ``query_ball_group_pallas(..., interpret=True)`` and the
reference-CUDA golden ``tests/golden.query_ball_golden``; and the ball
query alone, ``ops.query_ball_point`` (#8's plain version,
``ball_query_plain``), against ``query_ball_pallas(..., interpret=True)``
and ``query_ball_point_lax``.

``idx`` and ``cnt`` must be equal.  ``grouped`` must be equal to the
interpreted Pallas kernel, and within atol 1e-6 of the golden gather, as
``tests/test_ops_parity.py`` allows.  Cases: an empty ball, balls with
fewer hits than K, duplicated points, and K=48 and K=96 (the Pallas
kernel's chunked slot path).  The CUDA kernel is held against the plain
version by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

The ball query alone: ``idx`` and ``cnt`` equal, on rows with no hit and
rows with more than K.  The two JAX functions test ``sqrt(d2) < radius``
(``query_ball_point_lax`` on the EXPANDED d2), the port ``d2 < radius²``
on direct differences: they agree except within rounding of a ball's
boundary, so the inputs are pinned instead of the check loosened: no
(query, point) pair has |d2 - radius²| < 1e-6 (asserted).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanobjectnn_tpu.ops.grouping import query_ball_point_lax
from scanobjectnn_tpu.ops.pallas.ballquery_kernel import query_ball_group_pallas, query_ball_pallas
from scanobjectnn_torch import ops
from scanobjectnn_torch.ops.cuda.ballgroup_kernel import (
    ball_query_plain,
    query_ball_group,
    query_ball_group_plain,
    query_ball_point,
)
from tests import golden


def _cloud(rng, b, n):
    return (rng.rand(b, n, 3).astype(np.float32) * 2 - 1)


def _duplicates(rng, b, n):
    base = (rng.randint(-3, 4, (b, n // 4, 3)) * 0.25).astype(np.float32)
    return np.stack([c[rng.permutation(n)] for c in np.tile(base, (1, 4, 1))])


# name: (make cloud, b, n, m, K, radius); queries are perturbed cloud points
CASES = {
    "normal": (_cloud, 2, 128, 32, 16, 0.4),
    "fewer_hits_than_k": (_cloud, 2, 128, 32, 16, 0.15),
    "duplicates": (_duplicates, 2, 128, 24, 16, 0.3),
    "k48": (_cloud, 2, 96, 16, 48, 0.8),
    "k96": (_cloud, 1, 256, 16, 96, 1.4),
}


def _check(radius, k, xyz, centers):
    grouped, idx, cnt = ops.query_ball_group(radius, k, torch.from_numpy(xyz), torch.from_numpy(centers))
    assert grouped.dtype == torch.float32 and idx.dtype == cnt.dtype == torch.int32
    ref_grouped, ref_idx, ref_cnt = query_ball_group_pallas(
        radius, k, jnp.asarray(xyz), jnp.asarray(centers), interpret=True
    )
    want_idx, want_cnt = golden.query_ball_golden(radius, k, xyz, centers)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(ref_cnt))
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(cnt.numpy(), want_cnt)
    np.testing.assert_array_equal(grouped.numpy(), np.asarray(ref_grouped))
    want_grouped = golden.group_point_golden(xyz, want_idx) - centers[:, :, None, :]
    np.testing.assert_allclose(grouped.numpy(), want_grouped, atol=1e-6, rtol=0)
    return cnt.numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_ball_group_matches_jax(rng, case):
    make, b, n, m, k, radius = CASES[case]
    xyz = make(rng, b, n)
    centers = xyz[:, rng.choice(n, m, replace=False)] + (0.02 * rng.randn(b, m, 3)).astype(np.float32)
    cnt = _check(radius, k, xyz, centers)
    if case == "fewer_hits_than_k":
        assert (cnt < k).mean() > 0.5 and (cnt > 0).all()
    if case == "k96":
        assert (cnt == k).any() and (cnt < k).any()


def test_empty_ball_takes_point_zero(rng):
    xyz = _cloud(rng, 2, 64)
    centers = np.concatenate([xyz[:, :4], np.full((2, 4, 3), 100.0, np.float32)], axis=1)
    cnt = _check(0.3, 8, xyz, centers)
    assert (cnt[:, 4:] == 0).all() and (cnt[:, :4] > 0).all()
    grouped, idx, _ = query_ball_group_plain(0.3, 8, torch.from_numpy(xyz), torch.from_numpy(centers))
    assert (idx[:, 4:] == 0).all()
    want = torch.from_numpy(xyz[:, :1] - centers[:, 4:])  # point 0 minus the query
    assert torch.equal(grouped[:, 4:], want[:, :, None, :].expand(-1, -1, 8, -1))


def test_nsample_above_n_pads(rng):
    xyz = _cloud(rng, 1, 24)
    _check(0.9, 40, xyz, xyz[:, :8].copy())


def test_cpu_tensor_takes_plain_version_without_launch(rng):
    xyz = torch.from_numpy(_cloud(rng, 2, 64))
    before = query_ball_group.launches
    got = query_ball_group(0.4, 8, xyz, xyz[:, :8].contiguous())
    want = query_ball_group_plain(0.4, 8, xyz, xyz[:, :8])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert query_ball_group.launches == before == 0


def test_outputs_carry_no_gradient(rng):
    xyz = torch.from_numpy(_cloud(rng, 1, 32)).requires_grad_()
    grouped, _, _ = ops.query_ball_group(0.5, 4, xyz, xyz[:, :4])
    assert not grouped.requires_grad


def test_wrapper_refuses_other_devices():
    with pytest.raises(ValueError):
        query_ball_group(0.2, 4, torch.zeros(1, 8, 3, device="meta"), torch.zeros(1, 2, 3, device="meta"))


# name: (b, n, m, K, radius); queries are perturbed cloud points, and the
# last quarter is moved out of every ball.
QUERY_CASES = {
    "k16": (2, 128, 32, 16, 0.75),
    "k48": (2, 256, 16, 48, 0.9),
    "k128": (1, 256, 16, 128, 1.3),
}


@pytest.mark.parametrize("case", sorted(QUERY_CASES))
def test_ball_query_matches_jax(rng, case):
    b, n, m, k, radius = QUERY_CASES[case]
    xyz = _cloud(rng, b, n)
    centers = xyz[:, rng.choice(n, m, replace=False)] + (0.02 * rng.randn(b, m, 3)).astype(np.float32)
    centers[:, 3 * m // 4:] += 10.0
    d2 = ((centers[:, :, None, :].astype(np.float64) - xyz[:, None, :, :]) ** 2).sum(-1)
    assert np.abs(d2 - radius * radius).min() > 1e-6  # pinned off the boundaries (module doc)
    idx, cnt = ops.query_ball_point(radius, k, torch.from_numpy(xyz), torch.from_numpy(centers))
    assert idx.dtype == cnt.dtype == torch.int32 and idx.shape == (b, m, k) and cnt.shape == (b, m)
    for ref_idx, ref_cnt in (
        query_ball_pallas(radius, k, jnp.asarray(xyz), jnp.asarray(centers), interpret=True),
        query_ball_point_lax(radius, k, jnp.asarray(xyz), jnp.asarray(centers)),
    ):
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(ref_cnt))
    hits = (d2 < radius * radius).sum(-1)
    assert (hits == 0).any() and (hits > k).any() and ((hits > 0) & (hits < k)).any()
    assert (idx.numpy()[hits == 0] == 0).all()


def test_ball_query_cpu_tensor_takes_plain_version_without_launch(rng):
    xyz = torch.from_numpy(_cloud(rng, 2, 64))
    before = query_ball_point.launches
    idx, cnt = query_ball_point(0.4, 8, xyz, xyz[:, :8].contiguous())
    want_idx, want_cnt = ball_query_plain(0.4, 8, xyz, xyz[:, :8])
    assert torch.equal(idx, want_idx.int()) and torch.equal(cnt, want_cnt.int())
    assert query_ball_point.launches == before == 0
    with pytest.raises(ValueError):
        query_ball_point(0.2, 4, torch.zeros(1, 8, 3, device="meta"), torch.zeros(1, 2, 3, device="meta"))
