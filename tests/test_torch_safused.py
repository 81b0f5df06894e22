"""PyTorch port, fused eval SA layer: ``sa_ball_mlp_pool_plain`` (the CUDA
kernel's plain version, which the wrapper runs for CPU tensors) against the
JAX ``sa_ball_mlp_pool(..., interpret=True, need_idx=True)`` at the small
shapes of ``tests/test_samlp_fused.py``.

``idx`` must be equal.  Tolerances are that file's: f32 rtol 2e-4 /
atol 2e-5; bf16 0.035 x max(1, |ref|max) (about two bf16 ulps of the
activation scale, since the two sides sum in other orders before each
rounding).  The CUDA kernel itself is held against the plain version by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanobjectnn_tpu.ops.pallas.safused_kernel import sa_ball_mlp_pool as jax_sa
from scanobjectnn_torch.ops.cuda.safused_kernel import sa_ball_mlp_pool, sa_ball_mlp_pool_plain
from tests.test_torch_cuda import sa_inputs

# (b, n, m, k, radius, src channels, mlp, use_xyz, xyz_first)
CASES = {
    "xyz_only": (2, 256, 64, 16, 0.4, 0, (16, 16, 32), True, True),
    "sparse_rows": (2, 256, 64, 16, 0.06, 0, (16, 32), True, True),  # rows with no hit
    "features": (2, 128, 32, 8, 0.6, 24, (32, 48), True, True),
    "features_k32": (1, 256, 32, 32, 0.5, 16, (32, 32, 64), True, True),
    "msg_order": (2, 128, 32, 8, 0.6, 12, (24, 32), True, False),
    "no_xyz": (1, 128, 32, 8, 0.6, 16, (16, 16), False, True),
    "prelifted": (2, 128, 32, 8, 0.6, 40, (16, 24), True, True),  # C > feats[0]
}


def _inputs(case, rng):
    (radius, k, xyz, new_xyz, src, weights, biases), kw = sa_inputs(CASES[case], rng)
    return radius, k, xyz, new_xyz, src, weights, biases, kw["use_xyz"], kw["xyz_first"]


def _torch(x):
    return None if x is None else torch.from_numpy(x)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_interpret(rng, case, dtype):
    radius, k, xyz, new_xyz, src, weights, biases, use_xyz, xyz_first = _inputs(case, rng)
    jdtype, tdtype = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    ref, ref_idx = jax_sa(
        radius, k, jnp.asarray(xyz), jnp.asarray(new_xyz),
        None if src is None else jnp.asarray(src),
        [jnp.asarray(w) for w in weights], [jnp.asarray(b) for b in biases],
        use_xyz=use_xyz, xyz_first=xyz_first, dtype=jdtype, interpret=True, need_idx=True,
    )
    got, idx = sa_ball_mlp_pool_plain(
        radius, k, _torch(xyz), _torch(new_xyz), _torch(src),
        [_torch(w) for w in weights], [_torch(b) for b in biases],
        use_xyz=use_xyz, xyz_first=xyz_first, dtype=tdtype,
    )
    assert idx.dtype == torch.int32 and got.dtype == tdtype
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    r = np.asarray(ref, np.float32)
    g = got.float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(g, r, rtol=2e-4, atol=2e-5)
    else:
        scale = max(1.0, float(np.abs(r).max()))
        assert np.abs(g - r).max() < 0.035 * scale


def test_sparse_case_has_rows_without_hits(rng):
    radius, k, xyz, new_xyz, *_ = _inputs("sparse_rows", rng)
    d2 = ((new_xyz[:, :, None, :] - xyz[:, None, :, :]) ** 2).sum(-1)
    hits = (d2 < radius * radius).sum(-1)
    assert (hits == 0).any() and (hits > 0).any() and (hits < k).all()


def test_cpu_tensor_takes_plain_version_without_launch(rng):
    before = sa_ball_mlp_pool.launches
    args = _inputs("features", rng)
    t = [_torch(a) if isinstance(a, np.ndarray) or a is None else a for a in args[:5]]
    ws = [[_torch(w) for w in args[5]], [_torch(b) for b in args[6]]]
    got = sa_ball_mlp_pool(*t, *ws)
    ref = sa_ball_mlp_pool_plain(*t, *ws)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert sa_ball_mlp_pool.launches == before == 0


def test_wrapper_refuses_other_devices():
    z = torch.zeros(1, 8, 3, device="meta")
    with pytest.raises(ValueError):
        sa_ball_mlp_pool(0.2, 4, z, z, None, [torch.zeros(3, 4)], [torch.zeros(4)])
