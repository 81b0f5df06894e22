"""PyTorch port, farthest point sampling: ``fps_plain`` (the CUDA kernel's
plain version, which the wrapper runs for CPU tensors) against the JAX
``farthest_point_sample_lax`` and the Pallas ``fps_pallas_with_coords`` in
interpret mode.  Indices must be equal and coordinates bit-equal, on clouds
with duplicated points (ties) too.  The CUDA kernel itself is held against
``fps_plain`` by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanobjectnn_tpu.ops.fps import farthest_point_sample_lax, gather_point as jax_gather_point
from scanobjectnn_tpu.ops.pallas.fps_kernel import fps_pallas, fps_pallas_with_coords
from scanobjectnn_torch import ops
from scanobjectnn_torch.ops.cuda.fps_kernel import fps, fps_plain


def _cloud(kind, rng, b=2, n=256):
    if kind == "normal":
        return (rng.randn(b, n, 3) * 0.5).astype(np.float32)
    # Duplicated lattice points: many exact distance ties at every step.
    base = (rng.randint(-3, 4, (b, -(-n // 8), 3)) * 0.25).astype(np.float32)
    cloud = np.tile(base, (1, 8, 1))[:, :n]
    return np.stack([c[rng.permutation(n)] for c in cloud])


@pytest.mark.parametrize("kind", ["normal", "duplicates"])
@pytest.mark.parametrize("n,npoint", [(256, 64), (100, 37)])
def test_fps_plain_matches_jax(rng, kind, n, npoint):
    xyz = _cloud(kind, rng, n=n)
    idx, new_xyz = fps_plain(torch.from_numpy(xyz), npoint)
    ref_lax = np.asarray(farthest_point_sample_lax(jnp.asarray(xyz), npoint))
    ref_idx, ref_xyz = fps_pallas_with_coords(jnp.asarray(xyz), npoint, True)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), ref_lax)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(new_xyz.numpy(), np.asarray(ref_xyz))
    np.testing.assert_array_equal(
        new_xyz.numpy(), np.asarray(jax_gather_point(jnp.asarray(xyz), ref_lax))
    )


def test_fps_nan_row_rule_matches_pallas(rng):
    """Pinned NaN quirk: once a cloud's min-distance row holds NaN, every
    later index is N and its coordinates are (0, 0, 0), as the TPU kernel's
    two-reduce argmax gives.  The other cloud is unaffected."""
    xyz = _cloud("normal", rng, n=128)
    xyz[1, 9, 2] = np.nan
    idx, new_xyz = fps_plain(torch.from_numpy(xyz), 16)
    ref_idx, ref_xyz = fps_pallas_with_coords(jnp.asarray(xyz), 16, True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(new_xyz.numpy(), np.asarray(ref_xyz))
    assert (idx[1, 1:] == 128).all() and (new_xyz[1, 1:] == 0).all()
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(fps_pallas(jnp.asarray(xyz[:1]), 16, True))[0])


def test_ops_entry_points(rng):
    xyz = _cloud("normal", rng)
    t = torch.from_numpy(xyz)
    idx = ops.farthest_point_sample(t, 32)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(farthest_point_sample_lax(jnp.asarray(xyz), 32)))
    idx2, new_xyz = ops.farthest_point_sample_with_coords(t, 32)
    assert torch.equal(idx, idx2)
    assert torch.equal(new_xyz, ops.gather_point(t, idx))
    feats = rng.randn(2, 256, 5).astype(np.float32)
    np.testing.assert_array_equal(
        ops.gather_point(torch.from_numpy(feats), idx).numpy(),
        np.asarray(jax_gather_point(jnp.asarray(feats), jnp.asarray(idx.numpy()))),
    )


def test_cpu_tensor_takes_plain_version_without_launch(rng):
    before = fps.launches
    t = torch.from_numpy(_cloud("normal", rng))
    idx, new_xyz = fps(t, 16)
    ref_idx, ref_xyz = fps_plain(t, 16)
    assert torch.equal(idx, ref_idx) and torch.equal(new_xyz, ref_xyz)
    assert torch.equal(fps(t, 16, with_coords=False), ref_idx)
    assert fps.launches == before == 0


def test_wrapper_refuses_other_devices():
    with pytest.raises(ValueError):
        fps(torch.zeros(1, 8, 3, device="meta"), 4)
