"""PyTorch port, the launch plan of #18 (``ops/cuda/poolkey_kernel.py``
``plan`` and ``runs``) and the split of its K axis across a block's
teams, on the CPU.

  * ``plan(rows, k, c)`` at every call of the registry's bf16 keys-mode
    steps (PointNet's global pools, SSG's and MSG's SA layers at B=16) and
    at edge shapes (K = 1, C = 1, C = 33, rows = 1, K not a multiple of the
    teams): a plan the C entry point takes (``_blocks`` transcribes its
    checks), every slot in exactly one team's run, the runs in slot order,
    no block without a slot, and the main paths' calls filling the card's
    132 SMs, on the column route exactly where K <= 32 and the row's columns
    are many.
  * ``_split_pool`` transcribes the kernel's reduction: a partial (best
    key, slots at it, largest value among them, NaN seen) a team over its
    run, the teams of a warp merged by the shuffle tree, the warps in
    order, by the kernel's merge rule (on the column route one partial over
    all K).  On inputs whose winning ties straddle a team's boundary, and
    with a
    NaN key in the last slot only, it is bit-equal to
    ``bn_relu_exactkey_pool_plain``, and the plain version is held to JAX's
    Pallas kernel run in interpret mode by the bounds of
    ``tests/test_torch_exactpool.py`` (not bit-equal there: XLA contracts
    the affine into an FMA and takes its own rsqrt).  The JAX outputs are
    computed once for the module.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanobjectnn_tpu.ops.pallas.poolkey_kernel import bn_relu_exactkey_pool as jax_poolkey
from scanobjectnn_torch.ops.cuda import poolkey_kernel as pk
from scanobjectnn_torch.ops.cuda.poolkey_kernel import Plan, bn_relu_exactkey_pool_plain, plan, runs

from tests.test_torch_exactpool import POOLKEY_KEY_ULPS, POOLKEY_POOLED_SHARE

# (rows, K, C) of the bf16 keys-mode steps' #18 calls.
MAIN_CALLS = {
    "pointnet_global_pool": (32, 1024, 1024),
    "ssg_sa1": (8192, 32, 128),
    "ssg_sa2": (2048, 64, 256),
    "ssg_group_all": (16, 128, 1024),
    "msg_sa1_scale1": (8192, 16, 64),
    "msg_sa1_scale2": (8192, 32, 128),
    "msg_sa1_scale3": (8192, 128, 128),
    "msg_sa2_scale1": (2048, 32, 128),
    "msg_sa2_scale2": (2048, 64, 256),
    "msg_sa2_scale3": (2048, 128, 256),
}
EDGE_CALLS = {
    "k1": (64, 1, 128),
    "c1": (4, 300, 1),
    "c33": (21, 5, 33),
    "rows1_pointnet": (1, 1024, 1024),
    "rows1_k_ragged": (1, 1023, 1024),
    "rows1_k3": (1, 3, 8),
    "one_element": (1, 1, 1),
    "c10": (8, 6, 10),
    "c40": (32, 12, 40),
}


def _blocks(rows, k, c, p: Plan) -> int:
    """``plan_blocks`` of ``csrc/poolkey.cu``: the plan's blocks, 0 where
    the entry point refuses it."""
    if min(rows, k, c) < 1 or p.vec not in (1, 4) or (p.vec == 4 and c % 4):
        return 0
    if p.lanes < 1 or p.lanes & (p.lanes - 1) or p.teams < 1:
        return 0
    if p.teams == 1:  # the column route
        return -(-rows * (c // p.vec) // p.lanes) if pk.WARP <= p.lanes <= pk.MAX_THREADS else 0
    threads = p.lanes * p.teams
    if p.lanes > pk.WARP or threads % pk.WARP or threads > pk.MAX_THREADS:
        return 0
    return rows * -(-c // (p.lanes * p.vec))


@pytest.mark.parametrize("name", sorted(MAIN_CALLS) + sorted(EDGE_CALLS))
def test_plan_covers_every_slot_once(name):
    rows, k, c = MAIN_CALLS.get(name) or EDGE_CALLS[name]
    p = plan(rows, k, c)
    blocks = _blocks(rows, k, c, p)
    assert blocks > 0, p
    assert p.vec == (4 if c % 4 == 0 else 1)
    assert plan(rows, k, c, aligned=False).vec == 1
    teams = runs(k, p.teams)
    assert len(teams) == p.teams
    slots = [j for j0, j1 in teams for j in range(j0, j1)]
    assert slots == list(range(k))  # each slot once, in order
    assert teams[0][1] > teams[0][0]  # no block without a slot
    assert all(j0 <= j1 for j0, j1 in teams)
    if name in MAIN_CALLS:
        assert blocks >= pk.H100_SMS  # the card filled
        assert (p.teams == 1) == (k <= pk.COLUMN_MAX_K and rows * c // p.vec >= 256 * pk.H100_SMS)


def test_plan_narrows_the_lanes_where_rows_are_few():
    assert plan(1, 1024, 1024) == Plan(4, pk.MIN_LANES, pk.MAX_THREADS // pk.MIN_LANES)  # 256 threads a block
    assert plan(4096, 1024, 1024).lanes == pk.WARP  # rows enough: a warp a slot's 128 channels
    assert plan(1, 3, 8) == Plan(4, 2, pk.WARP // 2)  # too few slots for more teams than a warp's
    with pytest.raises(ValueError, match="empty"):
        plan(0, 4, 4)


# ---------------------------------------------------- the split's emulation


def _partial(key, y, j0, j1):
    """(best, n, pool, nan) over slots [j0, j1) of [R, K, C] keys and values:
    the largest non-NaN key (-inf if none), the slots at it, the largest
    value among them (-inf if none)."""
    kk, yy = key[:, j0:j1], y[:, j0:j1]
    nan = torch.isnan(kk).any(1)
    best = torch.where(torch.isnan(kk), float("-inf"), kk).amax(1) if j1 > j0 else \
        torch.full(key[:, 0].shape, float("-inf"))
    eq = kk == best[:, None]
    n = eq.sum(1, dtype=torch.float32)
    pool = torch.where(eq, yy, float("-inf")).amax(1) if j1 > j0 else torch.full_like(best, float("-inf"))
    return best, n, pool, nan


def _merge(a, b):
    """The kernel's ``merge``: ``a`` holds the earlier slots."""
    best, n, pool, nan = a
    b2, n2, p2, nan2 = b
    win, tie = b2 > best, b2 == best
    return (torch.where(win, b2, best), torch.where(win, n2, torch.where(tie, n + n2, n)),
            torch.where(win, p2, torch.where(tie, torch.fmax(pool, p2), pool)), nan | nan2)


def _split_pool(z32, gamma, beta, mean, r, cdtype, p: Plan):
    """The kernel's reduction over ``runs`` (module doc), the outputs as
    ``bn_relu_exactkey_pool_plain`` gives them."""
    *lead, k, c = z32.shape
    z = z32.reshape(-1, k, c)
    y = torch.relu((((z.to(cdtype).float() - mean) * r) * gamma + beta).to(cdtype)).float()
    key = torch.relu(((z - mean) * r) * gamma + beta)
    per_warp = max(1, pk.WARP // p.lanes)
    parts = [_partial(key, y, j0, j1) for j0, j1 in runs(k, p.teams)]
    warps = []
    for w in range(0, len(parts), per_warp):
        tree = parts[w:w + per_warp]
        step = 1
        while step < len(tree):  # team i absorbs team i + step
            tree = [_merge(tree[i], tree[i + step]) if i % (2 * step) == 0 and i + step < len(tree) else tree[i]
                    for i in range(len(tree))]
            step *= 2
        warps.append(tree[0])
    best, n, pool, nan = warps[0]
    for part in warps[1:]:
        best, n, pool, nan = _merge((best, n, pool, nan), part)
    best = torch.where(nan, float("nan"), best)
    n = torch.where(nan, 0.0, n)
    pool = torch.where(nan, float("-inf"), pool)
    return tuple(t.reshape(*lead, c) for t in (pool.to(cdtype), best, n))


# (lead dims, K, C, compute dtype, the plan: None for plan()'s own).
SPLIT_CASES = {
    "plan_b2_k128_c64": ((2,), 128, 64, torch.bfloat16, None),
    "teams32_k100": ((2,), 100, 32, torch.bfloat16, Plan(4, 8, 32)),
    "teams2_scalar_c33": ((1, 3), 50, 33, torch.bfloat16, Plan(1, 32, 2)),
    "teams8_lanes16_f32": ((4,), 77, 48, torch.float32, Plan(4, 16, 8)),
    "column_route": ((4, 8), 16, 64, torch.bfloat16, Plan(4, 64, 1)),
    "rows1_plan": ((1,), 128, 128, torch.bfloat16, None),
    "group_all_like_plan": ((2, 1), 128, 256, torch.bfloat16, None),
    "k1": ((4,), 1, 24, torch.bfloat16, None),
    "c1": ((3,), 20, 1, torch.bfloat16, None),
}


def _split_inputs(case):
    """z32 whose winning keys tie across the plan's run boundaries (channel
    ch at the boundary ch mod their count: the two slots either side set to
    the column's largest value + 1), a NaN in the last slot of the last
    channel of the first row, and the statistics of the rounded z32."""
    lead, k, c, cdtype, forced = SPLIT_CASES[case]
    rows = int(np.prod(lead))
    p = forced or plan(rows, k, c)
    rng = np.random.RandomState(k * 31 + c)
    z = (rng.randn(rows, k, c) * 2.0 + rng.randn(c)).astype(np.float32)
    starts = sorted({j0 for j0, j1 in runs(k, p.teams) if 0 < j0 < j1})
    for ch in range(c if starts else 0):
        j = starts[ch % len(starts)]
        z[:, j - 1:j + 1, ch] = z[:, :, ch].max(1, keepdims=True) + 1.0
    z[0, k - 1, c - 1] = np.nan
    zt = torch.from_numpy(z)
    zbf = zt.to(cdtype).float().nan_to_num(0.0)
    mean = zbf.mean(dim=(0, 1))
    var = torch.clamp(torch.square(zbf).mean(dim=(0, 1)) - torch.square(mean), min=0.0)
    gamma = torch.from_numpy((1.0 + 0.2 * rng.randn(c)).astype(np.float32))
    beta = torch.from_numpy((0.1 * rng.randn(c)).astype(np.float32))
    return (zt.reshape(*lead, k, c), gamma, beta, mean, var), cdtype, p, bool(starts)


@pytest.fixture(scope="module")
def jax_outputs():
    """JAX's interpreted Pallas kernel on every case, once."""
    out = {}
    for case in SPLIT_CASES:
        (z32, gamma, beta, mean, var), cdtype, _, _ = _split_inputs(case)
        jdtype = jnp.bfloat16 if cdtype == torch.bfloat16 else jnp.float32
        got = jax_poolkey(*(jnp.asarray(t.numpy()) for t in (z32, gamma, beta, mean, var)), jdtype, True)
        out[case] = tuple(np.asarray(jnp.asarray(t, jnp.float32)) for t in got)
    return out


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.float().nan_to_num(7.0).view(torch.int32), b.float().nan_to_num(7.0).view(torch.int32)) and \
        torch.equal(torch.isnan(a), torch.isnan(b))


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_emulation_is_the_plain_version_bit_for_bit(case, jax_outputs):
    (z32, gamma, beta, mean, var), cdtype, p, straddles = _split_inputs(case)
    r = torch.rsqrt(var + 1e-3)
    got = _split_pool(z32, gamma, beta, mean, r, cdtype, p)
    want = bn_relu_exactkey_pool_plain(z32, gamma, beta, mean, r, cdtype)
    for g, w in zip(got, want):
        assert _same_bits(g, w)
    pooled, kmax, cnt = (t.float().numpy() for t in want)
    assert np.isnan(kmax.reshape(-1, kmax.shape[-1])[0, -1]) and np.isnan(kmax).sum() == 1  # the last slot's NaN
    if straddles:
        assert (cnt[~np.isnan(kmax)] >= 2).all()  # every winner ties across a boundary

    # The plain version against JAX's interpreted kernel (module doc).
    w_pooled, w_kmax, w_cnt = jax_outputs[case]
    assert np.array_equal(np.isnan(kmax), np.isnan(w_kmax))
    ok = ~np.isnan(kmax)
    assert np.all(np.abs(kmax[ok] - w_kmax[ok]) <= POOLKEY_KEY_ULPS * np.spacing(np.maximum(np.abs(w_kmax[ok]), 1.0)))
    np.testing.assert_array_equal(cnt, w_cnt)
    assert np.array_equal(pooled[~ok], w_pooled[~ok]) and np.all(pooled[~ok] == -np.inf)
    diff = np.abs(pooled[ok] - w_pooled[ok])
    if cdtype == torch.float32:  # the value chain is the key's: its f32 ulps
        assert np.all(diff <= POOLKEY_KEY_ULPS * np.spacing(np.maximum(np.abs(w_pooled[ok]), 1.0)))
    else:
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w_pooled[ok]), 1e-30))) - 7)
        assert np.all(diff <= ulp) and (diff > 0).mean() <= POOLKEY_POOLED_SHARE, (diff > 0).mean()
