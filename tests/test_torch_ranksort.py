"""PyTorch port, the rank sort (#5): ``rank_sort_points_plain`` (the CUDA
kernel's plain version, which the wrapper runs for CPU tensors) against the
JAX ``rank_sort_points(..., interpret=True)`` at ``tests/test_ranksort.py``'s
shapes (B=3 clouds of N=256), on keys with many exact ties and -0.0/0.0
pairs.  All equal: the rank, the sorted coordinates (bit for bit the JAX
kernel's planes), the original ids (the JAX split's two index terms) and
bf16 feature rows carried by the permutation.

The JAX rank gives a NaN key rank 0, colliding with the smallest key's; the
port sorts a NaN after every number, as ``torch.argsort``, and its rank is
a permutation (pinned here).  The kernel itself is held to the plain
version by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanobjectnn_tpu.ops.pallas.ranksort_kernel import rank_sort_points as jax_rank_sort
from scanobjectnn_torch.ops.cuda.ranksort_kernel import rank_sort_points, rank_sort_points_plain, sort_order_key

B, N, C = 3, 256, 16


def _key_xyz(seed: int, ties: bool):
    rng = np.random.RandomState(seed)
    xyz = rng.randn(B, N, 3).astype(np.float32)
    key = xyz[:, :, 0].copy()
    if ties:
        key = np.round(key * 4.0) / 4.0  # many exact duplicates
        key[:, ::9] = -0.0  # beside the rounding's +0.0
    return key, xyz


@pytest.fixture(scope="module", params=[False, True], ids=["unique", "ties"])
def case(request):
    """numpy inputs and the JAX kernel's outputs: (key, xyz, feats, planes_s,
    split_s, featp_s, rank)."""
    ties = request.param
    key, xyz = _key_xyz(int(ties), ties)
    feats = np.array(jnp.asarray(np.random.RandomState(4).randn(B, N, C), jnp.bfloat16).astype(jnp.float32))
    featp = jnp.asarray(np.transpose(feats, (0, 2, 1)), jnp.bfloat16)  # [B, C, N], as the JAX kernel takes
    planes_s, split_s, featp_s, rank = jax_rank_sort(
        jnp.asarray(key), jnp.asarray(np.transpose(xyz, (0, 2, 1))), featp, True, True, True
    )
    return key, xyz, feats, *(np.asarray(a, np.float32) if a.dtype == jnp.bfloat16 else np.asarray(a)
                              for a in (planes_s, split_s, featp_s, rank))


def _port(key, xyz, feats=None):
    return rank_sort_points_plain(
        torch.from_numpy(key), torch.from_numpy(xyz), None if feats is None else torch.from_numpy(feats)
    )


def test_rank_matches_jax(case):
    key, xyz, _, _, _, _, rank = case
    _, _, got, _ = _port(key, xyz)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), rank)


def test_sorted_coordinates_are_jax_planes_bit_for_bit(case):
    key, xyz, _, planes_s, _, _, _ = case
    xyz_s, _, _, _ = _port(key, xyz)
    np.testing.assert_array_equal(xyz_s.numpy().view(np.uint32), np.transpose(planes_s[:, :3], (0, 2, 1)).view(np.uint32))


def test_ids_are_jax_split_index_terms(case):
    key, xyz, _, _, split_s, _, _ = case
    _, ids, rank, _ = _port(key, xyz)
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), (split_s[..., 9] + split_s[..., 10]).astype(np.int32))
    np.testing.assert_array_equal(np.take_along_axis(ids.numpy(), rank.numpy().astype(np.int64), 1),
                                  np.broadcast_to(np.arange(N), (B, N)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_feature_rows_ride_the_permutation(case, dtype):
    key, xyz, feats, _, _, featp_s, _ = case
    _, _, _, got = rank_sort_points_plain(torch.from_numpy(key), torch.from_numpy(xyz), torch.from_numpy(feats).to(dtype))
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.float().numpy(), featp_s)


def test_nan_keys_sort_last_where_jax_ranks_collide():
    key, xyz = _key_xyz(5, False)
    key[0, [7, 100]] = np.nan
    _, _, _, jrank = jax_rank_sort(jnp.asarray(key), jnp.asarray(np.transpose(xyz, (0, 2, 1))), None, False, True, True)
    jrank = np.asarray(jrank)
    # JAX: a NaN key compares false both ways, so it takes rank 0, as does the
    # smallest key: the rank is no permutation.
    assert jrank[0, 7] == jrank[0, 100] == 0 and (jrank[0] == 0).sum() == 3
    xyz_s, ids, rank, _ = _port(key, xyz)
    assert sorted(rank[0].tolist()) == list(range(N))
    assert ids[0, -2:].tolist() == [7, 100]  # after every number, tied by index
    np.testing.assert_array_equal(rank[1:].numpy(), jrank[1:])  # clouds without NaN agree
    assert torch.equal(ids[0].long(), torch.argsort(torch.from_numpy(key[0]), stable=True))


def test_sort_order_key_is_the_float_order():
    vals = torch.tensor([0.0, -0.0, 1.0, -1.0, float("inf"), -float("inf"), 1e-45, -1e-45, 3.5, float("nan")])
    k = sort_order_key(vals)
    assert k[0] == k[1]  # -0.0 == +0.0
    finite = ~torch.isnan(vals)
    a, b = vals[finite][:, None], vals[finite][None, :]
    assert torch.equal(k[finite][:, None] < k[finite][None, :], a < b)
    assert bool((k[~finite] > k[finite]).all())  # NaN after +inf


def test_cpu_tensor_takes_plain_version_without_launch():
    key, xyz = _key_xyz(6, True)
    before = rank_sort_points.launches
    got = rank_sort_points(torch.from_numpy(key), torch.from_numpy(xyz))
    ref = _port(key, xyz)
    assert all(torch.equal(g, r) for g, r in zip(got[:3], ref[:3])) and got[3] is None
    assert rank_sort_points.launches == before


def test_wrapper_refuses_other_devices():
    with pytest.raises(ValueError):
        rank_sort_points(torch.zeros(1, 8, device="meta"), torch.zeros(1, 8, 3, device="meta"))
