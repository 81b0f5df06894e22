"""PyTorch port, the eval SA layer over a given grouping (#10):
``sa_mlp_pool_plain`` (the CUDA kernel's plain version, which the wrapper
runs for CPU tensors) against the JAX ``sa_mlp_pool(..., interpret=True)``
on the same inputs (numpy, seeded by the case).

Cases: coordinates only (a layer without point features); features with
the coordinates (layer-0 rows [xyz, feats]); features without them
(``use_xyz=False``); at K = 8 and K = 128, in f32 and bf16.  Tolerances are
those of ``test_torch_safused.py``: f32 rtol 2e-4 / atol 2e-5; bf16 0.035 x
max(1, |ref|max) (the two sides sum in other orders before each rounding).
The CUDA kernel is held against the plain version by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanobjectnn_tpu.ops.pallas.samlp_kernel import sa_mlp_pool as jax_sa_mlp_pool
from scanobjectnn_torch.ops.cuda.samlp_kernel import sa_mlp_pool, sa_mlp_pool_plain

B, N, M = 2, 64, 16
# name: (feature channels, use the coordinates, mlp)
CASES = {
    "xyz_only": (0, True, (16, 16, 32)),
    "features_and_xyz": (12, True, (24, 32)),
    "features_no_xyz": (20, False, (16, 24)),
}


def samlp_inputs(case: str, k: int, rng):
    """numpy (grouped_xyz or None, idx or None, src or None, weights, biases)."""
    c, use_xyz, mlp = CASES[case]
    grouped = (rng.randn(B, M, k, 3) * 0.3).astype(np.float32) if use_xyz or not c else None
    idx = rng.randint(0, N, (B, M, k)).astype(np.int32) if c else None
    src = rng.randn(B, N, c).astype(np.float32) if c else None
    widths = ((3 if grouped is not None else 0) + c,) + tuple(mlp)
    weights = [(rng.randn(i, o) / np.sqrt(i)).astype(np.float32) for i, o in zip(widths, widths[1:])]
    biases = [(0.1 * rng.randn(o)).astype(np.float32) for o in mlp]
    return grouped, idx, src, weights, biases


def _t(x):
    return None if x is None else torch.from_numpy(x)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("k", [8, 128])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_interpret(case, k, dtype):
    grouped, idx, src, weights, biases = samlp_inputs(case, k, np.random.RandomState(k + len(case)))
    jdtype, tdtype = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    ref = jax_sa_mlp_pool(
        None if grouped is None else jnp.asarray(grouped), None if idx is None else jnp.asarray(idx),
        None if src is None else jnp.asarray(src),
        [jnp.asarray(w) for w in weights], [jnp.asarray(b) for b in biases], dtype=jdtype, interpret=True,
    )
    got = sa_mlp_pool_plain(_t(grouped), _t(idx), _t(src), [_t(w) for w in weights], [_t(b) for b in biases],
                            dtype=tdtype)
    assert got.dtype == tdtype and got.shape == (B, M, CASES[case][2][-1])
    r, g = np.asarray(ref, np.float32), got.float().numpy()
    assert float(np.abs(r).max()) > 0.1  # the activations did not vanish
    if dtype == "f32":
        np.testing.assert_allclose(g, r, rtol=2e-4, atol=2e-5)
    else:
        assert np.abs(g - r).max() < 0.035 * max(1.0, float(np.abs(r).max()))


def test_cpu_tensor_takes_plain_version_without_launch():
    args = [_t(a) for a in samlp_inputs("features_and_xyz", 8, np.random.RandomState(0))[:3]]
    ws = [[_t(w) for w in ww] for ww in samlp_inputs("features_and_xyz", 8, np.random.RandomState(0))[3:]]
    before = sa_mlp_pool.launches
    got, want = sa_mlp_pool(*args, *ws), sa_mlp_pool_plain(*args, *ws)
    assert torch.equal(got, want) and sa_mlp_pool.launches == before == 0


def test_wrapper_refuses_other_devices_and_missing_rows():
    w, b = [torch.zeros(3, 4)], [torch.zeros(4)]
    with pytest.raises(ValueError, match="device"):
        sa_mlp_pool(torch.zeros(1, 2, 4, 3, device="meta"), None, None, w, b)
    with pytest.raises(ValueError, match="grouped_xyz"):
        sa_mlp_pool(None, None, torch.zeros(1, 8, 3), w, b)
