"""PyTorch port, the fused SA training tail (``ops/satrain.py``) and the
plain version of #17 (``ops/cuda/satrain_kernel.py``), on the CPU, against
the JAX package on the same numpy inputs.

  * ``grouped_bn_mlp_pool``'s forward against JAX ``_fwd_chain``: pooled
    and the batch statistics.
  * ``grouped_bn_mlp_pool_bwd_plain`` against JAX ``_bwd_xla`` and against
    ``bwd_pallas`` run in interpret mode (as ``tests/test_satrain_fused.py``
    runs it), on the same z1, parameters, statistics and cotangent.
  * f32 and bf16, pool modes "0" and "1", 1-, 2- and 3-layer stacks, K a
    multiple of 8 and not (the Pallas comparison keeps JAX's rule: K, M
    and C0 multiples of 8), duplicated slots (exact pool ties).
  * ``GroupMLPPool`` and ``LiftedGroupMLP`` with the fused tail against
    the same modules unfused, in the port: pooled, every gradient, running
    stats.
  * ``LiftedGroupMLP`` in bf16 training against the JAX module (keys and
    native modes).
  * The kernel's launch plan (``satrain_kernel.plan``) for an H100's 132
    SMs, which the CUDA entry point checks and refuses when it cannot run
    it: the pool in every pass where a chunk holds whole groups (SSG's SA1,
    MSG's K <= 32 scales), the pool pass at SSG's SA2, group-all and MSG's
    K = 64 and 128 scales, the blocks of group-all's passes on 132 SMs and
    on fewer, and every plan within its scratch and shared memory, covering
    each row once.

Tolerances, x max(1, |ref|max) per tensor.  f32: 1e-5 (sums over the rows
in other orders); the Dense biases feed a training BN, so their gradient is
0 and both sides' rounding noise is held to 1e-4.  bf16: XLA on the CPU
contracts BN's ``zhat · gamma + beta`` into one FMA where the port rounds
each op, which moves a bf16 rounding of y on a few elements; pooled within
one bf16 ulp on at most 2% of its elements, dz1 (rounded to bf16) within
one bf16 ulp of the scale, the f32 sums (dgamma, dbeta, dW) within 1e-3,
the Dense biases' noise below 1e-2 (of the layer's kernel gradient's
scale, in the modules).  The port's fused and unfused modules
run the same arithmetic up to summation order: 1e-5 in f32; in bf16 the
unfused autograd rounds each Dense's dx to bf16 where the tail's backward
walks in f32 (JAX's ``_bwd_xla`` too), so 2e-2 (five bf16 ulps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanobjectnn_tpu.nn.pointnet_modules import LiftedGroupMLP as JLiftedGroupMLP
from scanobjectnn_tpu.ops.pallas import satrain_kernel as jsatrain
from scanobjectnn_torch import convert
from scanobjectnn_torch.nn.pointnet_modules import GroupMLPPool, LiftedGroupMLP, configure_training
from scanobjectnn_torch.ops.cuda.satrain_kernel import (
    PARTIAL_BYTES,
    _plan,
    fwd_chain,
    grouped_bn_mlp_pool_bwd,
    grouped_bn_mlp_pool_bwd_plain,
    plan,
)
from scanobjectnn_torch.ops.satrain import grouped_bn_mlp_pool

F32_TOL, F32_ZERO_TOL = 1e-5, 1e-4
BF16_SUM_TOL, BF16_ZERO_TOL, BF16_POOLED_SHARE = 1e-3, 1e-2, 0.02
MODULE_BF16_TOL = 2e-2

# name: (z1 shape [B, M, K, C0], MLP widths)
CASES = {
    "three_layers": ((2, 8, 16, 8), (8, 12, 16)),
    "two_layers_k12": ((2, 5, 12, 6), (6, 10)),
    "one_layer": ((2, 8, 8, 8), (8,)),
    "three_layers_k7": ((3, 4, 7, 5), (5, 9, 11)),
}


def _np(t) -> np.ndarray:
    return t.float().detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(jnp.asarray(t, jnp.float32))


def _inputs(case: str, dtype):
    shape, widths = CASES[case]
    rng = np.random.RandomState(sum(shape) + len(widths))
    z = (rng.randn(*shape) + rng.randn(shape[-1])).astype(np.float32)
    z[:, :, shape[2] // 2] = z[:, :, 0]  # duplicated slots: exact ties
    gammas = [(1.0 + 0.1 * rng.randn(c)).astype(np.float32) for c in widths]
    betas = [(0.1 * rng.randn(c)).astype(np.float32) for c in widths]
    ws = [(rng.randn(a, b) / np.sqrt(a)).astype(np.float32) for a, b in zip(widths, widths[1:])]
    bs = [(0.05 * rng.randn(c)).astype(np.float32) for c in widths[1:]]
    dp = rng.randn(shape[0], shape[1], widths[-1]).astype(np.float32)
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    z1j = jnp.asarray(z).astype(jdtype)
    jax_args = (z1j, *[tuple(jnp.asarray(a) for a in group) for group in (gammas, betas, ws, bs)])
    t = [[torch.from_numpy(a) for a in group] for group in (gammas, betas, ws, bs)]
    return jax_args, (torch.from_numpy(_np(z1j)).to(dtype), *t), dp


def _assert_close(got, want, dtype, name, readings, zero=False):
    got, want = _np(got), _np(want)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max()) / scale
    readings[name] = err
    if zero:  # a Dense bias before a training BN: 0 up to rounding
        bound = F32_ZERO_TOL if dtype == torch.float32 else BF16_ZERO_TOL
        assert np.abs(got).max() <= bound * scale and np.abs(want).max() <= bound * scale, (name, readings)
    elif dtype == torch.float32:
        assert err <= F32_TOL, (name, readings)
    elif name == "dz1":
        assert err <= 2.0 ** (np.floor(np.log2(scale)) - 7) / scale, (name, readings)
    else:
        assert err <= BF16_SUM_TOL, (name, readings)


@pytest.mark.parametrize("pool_mode", ["0", "1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax_fwd_chain(monkeypatch, case, dtype, pool_mode):
    monkeypatch.setenv("SCANOBJECTNN_SA_POOL_F32", pool_mode)
    jax_args, args, _ = _inputs(case, dtype)
    _, _, _, want, want_means, want_vars = jsatrain._fwd_chain(*jax_args)
    pooled, means, variances = grouped_bn_mlp_pool(*args, pool_mode)
    assert pooled.dtype == dtype
    # JAX's public op casts at its boundary, after the tie structure is fixed.
    want = np.asarray(want.astype(jax_args[0].dtype).astype(jnp.float32))
    diff = np.abs(_np(pooled) - want)
    if dtype == torch.float32:
        np.testing.assert_allclose(_np(pooled), want, rtol=1e-5, atol=1e-5)
    else:
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert np.all(diff <= ulp) and (diff > 0).mean() <= BF16_POOLED_SHARE, (diff > 0).mean()
    for got_s, want_s in zip((*means, *variances), (*want_means, *want_vars)):
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5 if dtype == torch.float32 else 2e-3,
                                   atol=1e-5)


def _jax_bwd(jax_args, dp, pallas: bool):
    """JAX's backward of the same tail: ``_bwd_xla`` or the interpreted
    Pallas passes (``_use_pallas_bwd`` forced, as ``test_satrain_fused.py``
    does), through ``jax.vjp`` of the public op."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsatrain, "_use_pallas_bwd", lambda z1: pallas)
        out, vjp = jax.vjp(lambda *a: jsatrain.grouped_bn_mlp_pool(*a)[0], *jax_args)
        grads = vjp(jnp.asarray(dp).astype(out.dtype))
    res = jsatrain._gbmp_fwd(*jax_args)[1]
    return grads, res[5], res[6]


# (case, JAX backward): _bwd_xla for every case, the interpreted Pallas
# passes where JAX takes them (K, M and C0 multiples of 8).
BWD_CASES = [(case, False) for case in sorted(CASES)] + [
    (case, True) for case, (shape, _) in sorted(CASES.items()) if not (shape[1] % 8 or shape[2] % 8 or shape[3] % 8)
]


@pytest.mark.parametrize("pool_mode", ["0", "1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case,pallas", BWD_CASES,
                         ids=[f"{c}-{'bwd_pallas_interpret' if p else 'bwd_xla'}" for c, p in BWD_CASES])
def test_plain_backward_matches_jax(monkeypatch, case, pallas, dtype, pool_mode):
    shape, widths = CASES[case]
    monkeypatch.setenv("SCANOBJECTNN_SA_POOL_F32", pool_mode)
    jax_args, args, dp = _inputs(case, dtype)
    (dz1_j, dg_j, db_j, dw_j, dbias_j), means, variances = _jax_bwd(jax_args, dp, pallas)
    means = [torch.from_numpy(np.asarray(m)) for m in means]
    variances = [torch.from_numpy(np.asarray(v)) for v in variances]
    d_pooled = torch.from_numpy(dp).to(dtype)
    got = grouped_bn_mlp_pool_bwd_plain(*args, means, variances, d_pooled, pool_mode)
    on_cpu = grouped_bn_mlp_pool_bwd(*args, means, variances, d_pooled, pool_mode)  # a CPU tensor: the plain version
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(on_cpu)):
        assert torch.equal(a, b)
    dz1, dgammas, dbetas, dws, dbs = got
    assert dz1.dtype == dtype
    readings = {}
    _assert_close(dz1, dz1_j, dtype, "dz1", readings)
    for i in range(len(widths)):
        _assert_close(dgammas[i], dg_j[i], dtype, f"dgamma{i}", readings)
        _assert_close(dbetas[i], db_j[i], dtype, f"dbeta{i}", readings)
    for i in range(len(widths) - 1):
        _assert_close(dws[i], dw_j[i], dtype, f"dw{i + 1}", readings)
        _assert_close(dbs[i], dbias_j[i], dtype, f"db{i + 1}", readings, zero=True)


def test_autograd_takes_the_plain_backward_on_the_cpu():
    _, (z1, gammas, betas, ws, bs), dp = _inputs("three_layers", torch.float32)
    params = [p.clone().requires_grad_() for p in (*gammas, *betas, *ws, *bs)]
    z1 = z1.clone().requires_grad_()
    n = len(gammas)
    pooled, means, variances = grouped_bn_mlp_pool(z1, params[:n], params[n:2 * n], params[2 * n:3 * n - 1],
                                                   params[3 * n - 1:])
    assert not any(t.requires_grad for t in (*means, *variances))
    (pooled * torch.from_numpy(dp)).sum().backward()
    want = grouped_bn_mlp_pool_bwd_plain(z1.detach(), gammas, betas, ws, bs, means, variances, torch.from_numpy(dp))
    assert torch.equal(z1.grad, want[0])
    flat = [*want[1], *want[2], *want[3], *want[4]]
    assert all(torch.equal(p.grad, w) for p, w in zip(params, flat))
    with pytest.raises(ValueError, match="pool modes"):
        grouped_bn_mlp_pool(z1, params[:n], params[n:2 * n], params[2 * n:3 * n - 1], params[3 * n - 1:], "keys")


def _module_step(module, inputs, fused: bool, mode: str):
    configure_training(module, mode, fused).train()
    leaf = inputs[0].clone().requires_grad_()
    out = module(leaf, *inputs[1:], 0.5)
    cot = torch.from_numpy(np.random.RandomState(9).randn(*out.shape).astype(np.float32))
    (out.float() * cot).sum().backward()
    grads = {n: p.grad.clone() for n, p in module.named_parameters()}
    grads["input"] = leaf.grad.clone()
    for p in module.parameters():
        p.grad = None
    return out, grads, {n: b.clone() for n, b in module.named_buffers()}


@pytest.mark.parametrize("mode", ["0", "1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["group_mlp_pool", "lifted"])
def test_fused_tail_matches_unfused_modules(kind, dtype, mode):
    rng = np.random.RandomState(11)
    gen = torch.Generator().manual_seed(0)
    if kind == "group_mlp_pool":
        module = convert.init_params(GroupMLPPool(6, (8, 12, 16), dtype=dtype), gen)
        x = rng.randn(2, 16, 12, 6).astype(np.float32)
        x[:, :, 7] = x[:, :, 3]
        inputs = (torch.from_numpy(x).to(dtype),)
    else:
        module = convert.init_params(LiftedGroupMLP(15, (8, 12, 16), dtype=dtype), gen)
        xyz = torch.from_numpy((rng.randn(2, 40, 3) * 0.5 + 0.3).astype(np.float32))
        idx = torch.from_numpy(rng.randint(0, 40, (2, 10, 6)).astype(np.int32))
        idx[:, :, 1] = idx[:, :, 0]
        inputs = (torch.from_numpy(rng.randn(2, 40, 12).astype(np.float32)).to(dtype), xyz, xyz[:, :10] + 0.01, idx)
    stats0 = {n: b.clone() for n, b in module.named_buffers()}
    ref, ref_grads, ref_stats = _module_step(module, inputs, False, mode)
    for n, b in module.named_buffers():
        b.copy_(stats0[n])
    got, grads, stats = _module_step(module, inputs, True, mode)
    bf16 = dtype == torch.bfloat16
    assert got.dtype == dtype
    if bf16:
        assert torch.equal(got, ref)  # the forward is the same arithmetic
    else:
        torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)
    for n, r in ref_stats.items():
        torch.testing.assert_close(stats[n], r, rtol=1e-6, atol=1e-7)
    for n, r in ref_grads.items():
        r, g = _np(r), _np(grads[n])
        scale = max(1.0, float(np.abs(r).max()))
        if n.startswith("dense_") and n.endswith("bias"):  # feeds a training BN: 0
            kernel_scale = max(1.0, float(np.abs(_np(ref_grads[n[:-4] + "kernel"])).max()))
            assert np.abs(g).max() <= (BF16_ZERO_TOL if bf16 else F32_ZERO_TOL) * kernel_scale, n
        else:
            assert np.abs(g - r).max() <= (MODULE_BF16_TOL if bf16 else F32_TOL) * scale, n


@pytest.mark.parametrize("mode", ["keys", "0"])
def test_lifted_group_mlp_bf16_matches_jax(monkeypatch, mode):
    # JAX's bf16 LiftedGroupMLP (pool=True): W0's xyz rows in f32, x32
    # rounded after the cancellation; held as the GroupMLPPool modes of
    # tests/test_torch_mixed_layers.py: pooled within one bf16 ulp on at most
    # 5% of its elements, gradients within 2e-2 of the scale, the Dense biases
    # and the point features' gradient as stated there.
    monkeypatch.setenv("SCANOBJECTNN_SA_POOL_F32", mode)
    rng = np.random.RandomState(12)
    b, n, m, k, c, feats = 2, 48, 12, 8, 12, (8, 16)
    xyz = (rng.randn(b, n, 3) * 0.5 + 0.3).astype(np.float32)
    pts = jnp.asarray(rng.randn(b, n, c).astype(np.float32)).astype(jnp.bfloat16)
    query = xyz[:, :m] + (0.05 * rng.randn(b, m, 3)).astype(np.float32)
    idx = rng.randint(0, n, (b, m, k)).astype(np.int32)
    idx[:, :, 1] = idx[:, :, 0]
    cot = rng.randn(b, m, feats[-1]).astype(np.float32)
    jm = JLiftedGroupMLP(feats, xyz_first=False, dtype=jnp.bfloat16, pool=True)
    jargs = (pts, jnp.asarray(xyz), jnp.asarray(query), jnp.asarray(idx))
    v = jm.init(jax.random.PRNGKey(0), *jargs, train=False)
    v = {**v, "batch_stats": jax.tree_util.tree_map(
        lambda a: jnp.asarray(0.5 + np.abs(rng.randn(*a.shape)), jnp.float32), v["batch_stats"])}

    def f(params, p):
        y, mut = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, p, *jargs[1:], train=True,
                          bn_momentum=0.5, mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * cot), (y, mut["batch_stats"])

    (gp, gx), (ref, ref_stats) = jax.grad(f, argnums=(0, 1), has_aux=True)(v["params"], pts)
    tm = configure_training(convert.load_jax_variables(LiftedGroupMLP(c + 3, feats, dtype=torch.bfloat16), v),
                            mode, False).train()
    tp = torch.from_numpy(_np(pts)).to(torch.bfloat16).requires_grad_()
    out = tm(tp, torch.from_numpy(xyz), torch.from_numpy(query), torch.from_numpy(idx), 0.5)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    ref = _np(ref)
    diff = np.abs(_np(out) - ref)
    assert diff.max() <= 2.0 ** (np.floor(np.log2(max(1.0, float(np.abs(ref).max())))) - 7)
    assert (diff > 0).mean() <= 0.05
    want = {**dict(convert._flatten(gp)), "points": gx}
    got = {**{name: p.grad for name, p in tm.named_parameters()}, "points": tp.grad}
    for name, w in want.items():
        w, g = _np(w), _np(got[name])
        scale = max(1.0, float(np.abs(w).max()))
        if name.startswith("dense_") and name.endswith("bias"):
            kernel_scale = max(1.0, float(np.abs(_np(want[name[:-4] + "kernel"])).max()))
            assert np.abs(g).max() <= BF16_ZERO_TOL * kernel_scale, name
        else:
            assert np.abs(g - w).max() <= MODULE_BF16_TOL * scale, (name, np.abs(g - w).max() / scale)
    for name, w in convert._flatten(ref_stats):
        np.testing.assert_allclose(dict(tm.named_buffers())[name].numpy(), np.asarray(w), rtol=1e-3, atol=1e-6)


# The fused tail's calls of a B=16 training step (groups = B * M, K, the MLP
# widths) and whether a chunk of the kernel holds whole groups there: where
# two blocks an SM fit 64-row chunks (SA1's widths), not at SA2's, whose
# 32-row chunks at two blocks an SM beat 64 rows at one with the pool in the
# pass on an H100 (PERF.md section 6, PR 13).
H100_SMS = 132
MAIN_CALLS = {
    "ssg_sa1": (16 * 512, 32, (64, 64, 128), True),
    "ssg_sa2": (16 * 128, 64, (128, 128, 256), False),
    "ssg_group_all": (16, 128, (256, 512, 1024), False),
    "msg_sa1_k16": (16 * 512, 16, (32, 32, 64), True),
    "msg_sa1_k32": (16 * 512, 32, (64, 64, 128), True),
    "msg_sa1_k128": (16 * 512, 128, (64, 96, 128), False),
    "msg_sa2_k32": (16 * 128, 32, (64, 64, 128), True),
    "msg_sa2_k64": (16 * 128, 64, (128, 128, 256), False),
    "msg_sa2_k128": (16 * 128, 128, (128, 128, 256), False),
}
# The card tests' shapes (tests/test_torch_cuda.py SATRAIN_CASES) and the
# largest stack the kernel takes.
EDGE_CALLS = {
    "group_all_b4": (4, 128, (256, 512, 1024)),
    "ragged": (15, 7, (12, 20, 9)),
    "one_layer": (16, 10, (16,)),
    "k1": (128, 1, (16, 24, 32)),
    "k33": (18, 33, (20, 36, 40)),
    "k65": (10, 65, (24, 40)),
    "k96": (8, 96, (16, 24, 32)),
    "k127": (6, 127, (12, 24, 48)),
    "k12_ragged": (21, 12, (8, 16)),
    "widths_1_5": (16, 16, (5, 1, 5)),
    "width_1024": (4, 16, (1024, 1024)),
    "four_layers": (32, 16, (12, 20, 28, 36)),
    "four_wide": (2, 8, (1024, 1024, 1024, 1024)),
}


@pytest.mark.parametrize("name", sorted(MAIN_CALLS))
def test_plan_takes_the_pool_into_the_pass_where_a_chunk_holds_whole_groups(name):
    groups, k, widths, in_pass = MAIN_CALLS[name]
    layout = plan(groups, k, widths, H100_SMS)
    assert layout.pool_in_pass == in_pass
    if in_pass:  # whole groups a chunk; no pool pass
        assert layout.chunk_rows == layout.rows // k * k and layout.pool_blocks == 0
    else:  # a group's rows in whole chunks of the pool pass's segments
        assert layout.chunk_rows == layout.rows and layout.pool_seg_rows % layout.rows == 0
        assert layout.pool_segs * layout.pool_seg_rows >= k > (layout.pool_segs - 1) * layout.pool_seg_rows


def test_plan_fills_the_card_at_group_all():
    # SSG's group-all at B=16: 2048 rows in 16-row chunks (the widest the
    # 256-512-1024 layers leave room for, the constants in device memory),
    # so 128 chunks: a pass without a dW takes a chunk a block, 128 blocks on
    # the 132 SMs.  (8-row chunks give 256 blocks and read 1.35x slower on an
    # H100.)  The two passes that sum a dW are bounded by the partial buffer
    # (2 MiB of dW_2 a row block) and split the dW's tiles: dW_2 in 5 slices
    # x 26 row blocks, dW_1 in 2 x 64 (PERF.md section 6, PR 13).
    layout = plan(16, 128, (256, 512, 1024), H100_SMS)
    assert (layout.rows, layout.consts_smem, layout.pool_in_pass) == (16, False, False)
    assert [p.blocks for p in layout.passes] == [128, 130, 128, 128]
    assert [p.slices for p in layout.passes] == [1, 5, 2, 1]


@pytest.mark.parametrize("sms", [132, 114, 78])
def test_plan_fills_one_wave_of_the_card_it_is_given(sms):
    # The wrapper passes the card's SM count (H100 SXM 132, PCIe 114): at
    # SSG's SA1 (4096 chunks of 64 rows) every pass takes one wave of
    # blocks, and a chunk fewer a block would not fit one wave.
    layout = plan(16 * 512, 32, (64, 64, 128), sms)
    wave = layout.blocks_per_sm * sms
    assert layout.blocks_per_sm == 2 and layout.chunk_rows == 64
    for p in layout.passes:
        assert p.blocks <= wave < -(-4096 // (p.chunks_per_block - 1))


@pytest.mark.parametrize("name", sorted(MAIN_CALLS) + sorted(EDGE_CALLS))
def test_plan_stays_within_its_scratch_and_shared_memory(name):
    groups, k, widths = (MAIN_CALLS.get(name) or EDGE_CALLS[name])[:3]
    layout = plan(groups, k, widths, H100_SMS)
    assert layout.scratch_bytes <= PARTIAL_BYTES
    assert layout.rows in (4, 8, 16, 32, 64) and 1 <= layout.chunk_rows <= layout.rows
    assert len(layout.ints()) == 8 + 4 * (len(widths) + 1)
    chunks = -(-groups * k // layout.chunk_rows)
    assert [p.target for p in layout.passes] == list(range(len(widths) - 1, -2, -1))
    for p in layout.passes:
        # every chunk in one block, no block empty
        assert p.blocks_x * p.chunks_per_block >= chunks > (p.blocks_x - 1) * p.chunks_per_block
        assert p.smem_bytes <= 227 * 1024
        # every pass built for the blocks an SM the plan's waves assume (the kernel's min_blocks)
        assert layout.blocks_per_sm == (2 if layout.rows >= 32 and 2 * (p.smem_bytes + 1024) <= 228 * 1024 else 1)
        assert p.blocks_x * p.slices * p.stride <= layout.partial_floats
        if 0 <= p.target < len(widths) - 1:
            tiles = -(-widths[p.target] // 64) * -(-widths[p.target + 1] // 64)
            assert 1 <= p.slices <= tiles
        else:
            assert p.slices == 1 and not p.dw_smem


def test_plan_keywords_force_a_choice():
    # _plan's keywords (rows, pool_in_pass, consts_smem) force a choice.
    layout = _plan(16 * 512, 32, (64, 64, 128), H100_SMS, pool_in_pass=False)
    assert not layout.pool_in_pass and layout.chunk_rows == layout.rows == 64
    layout = _plan(16 * 512, 32, (64, 64, 128), H100_SMS, rows=32)
    assert layout.rows == 32 and layout.pool_in_pass and layout.chunk_rows == 32
    assert [p.dw_smem for p in layout.passes] == [False, True, True, False]
    layout = _plan(16 * 128, 64, (128, 128, 256), H100_SMS, rows=64, consts_smem=True)
    assert layout.pool_in_pass and layout.consts_smem and layout.chunk_rows == 64 and layout.blocks_per_sm == 1
