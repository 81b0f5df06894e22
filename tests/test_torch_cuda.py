"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Marked ``cuda``: every test skips where no CUDA device is present.
This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

FPS indices and coordinates must be equal.  Fused SA: ``idx`` equal;
``pooled`` in f32 to rtol 1e-4 / atol 1e-5 (only the summation order
differs).  In bf16 the kernel and the plain version sum the same
bf16-rounded products in f32 and round at the same points, so they agree
bit for bit on an H100: ``pooled`` may differ by at most one bf16 ulp of
max(1, |ref|max), on at most 0.1% of its elements.  A kernel that skipped a
bf16 rounding between layers differs on far more.
"""

import math

import numpy as np
import pytest
import torch

from scanobjectnn_torch.ops.cuda.fps_kernel import fps, fps_plain
from scanobjectnn_torch.ops.cuda.safused_kernel import sa_ball_mlp_pool, sa_ball_mlp_pool_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize(
    "b,n,m", [(3, 100, 37), (2, 2048, 512), (2, 512, 128), (2, 5000, 64), (1, 8192, 16), (2, 7, 9)]
)
def test_fps_kernel_matches_plain(dev, b, n, m):
    xyz = torch.from_numpy(np.random.RandomState(n).randn(b, n, 3).astype(np.float32)).to(dev)
    before = fps.launches
    idx, new_xyz = fps(xyz, m)
    ref_idx, ref_xyz = fps_plain(xyz, m)
    assert torch.equal(idx, ref_idx) and torch.equal(new_xyz, ref_xyz)
    assert torch.equal(fps(xyz, m, with_coords=False), ref_idx)
    assert fps.launches == before + 2


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
    ref, ref_idx = sa_ball_mlp_pool_plain(*args, dtype=dtype, **kw)
    torch.cuda.synchronize()
    assert sa_ball_mlp_pool.launches == before + 1
    assert torch.equal(idx, ref_idx)
    assert pooled.dtype == ref.dtype == dtype and pooled.shape == ref.shape
    if dtype == torch.float32:
        torch.testing.assert_close(pooled, ref, rtol=1e-4, atol=1e-5)
    else:
        scale = max(1.0, float(ref.float().abs().max()))
        ulp = 2.0 ** (math.floor(math.log2(scale)) - 7)  # bf16 keeps 8 significant bits
        diff = (pooled.float() - ref.float()).abs()
        err, differing = float(diff.max()), float((diff > 0).float().mean())
        assert err <= ulp and differing <= 1e-3, (err, differing)


def test_safused_kernel_refuses_what_it_does_not_take(dev):
    args, kw = _sa_inputs("ragged_m", dev)
    with pytest.raises(ValueError, match="K <= 64"):
        sa_ball_mlp_pool(args[0], 65, *args[2:], **kw)
    with pytest.raises(ValueError, match="contiguous"):
        sa_ball_mlp_pool(args[0], args[1], args[2].transpose(0, 1).contiguous().transpose(0, 1), *args[3:], **kw)
    with pytest.raises(ValueError, match="float32"):
        sa_ball_mlp_pool(args[0], args[1], args[2].double(), *args[3:], **kw)
    radius, k, xyz, new_xyz, src, weights, biases = args
    with pytest.raises(ValueError, match="biases"):
        sa_ball_mlp_pool(radius, k, xyz, new_xyz, src, weights, [biases[0], biases[1][:-1]], **kw)
    with pytest.raises(ValueError, match="weights"):
        sa_ball_mlp_pool(radius, k, xyz, new_xyz, src, [weights[0], weights[1][1:]], biases, **kw)
