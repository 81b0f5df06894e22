"""PyTorch port: DGCNN's self-kNN graph (``ops.knn_graph``, the plain
version of ``knn_graph_kernel`` in ``csrc/knn.cu``), on the CPU, against the
JAX package's ``knn_graph_lax`` and ``knn_graph_pallas`` (Pallas interpret
mode, as the JAX package's own tests run it).

Indices are compared, and how:
  * the port sums ``|q|² - 2q·k + |k|²`` in ascending channel order, JAX
    takes the inner product from an einsum at HIGHEST precision: the f32
    bits differ by rounding, so a query whose k-th and (k+1)-th distances lie
    within that rounding may pick another k-th neighbour.  Rows are compared
    where the float64 gap between the k-th and (k+1)-th distance exceeds
    ``MARGIN_ULPS`` f32 ulps of the sums involved (``_margin_bound``: the
    expansion's terms, each a sum of C products of magnitude up to
    |q|²+|k|²); every test asserts that most rows pass that bar and prints
    the share;
  * on a lattice of dyadic coordinates (multiples of 0.25) every product
    and sum is exact in f32 on both sides, so the distances tie exactly
    (duplicated points): there all rows must be equal, ties going to the
    lowest index in the port, in ``lax.top_k`` and in the TPU's argmin.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanobjectnn_tpu.ops.grouping import knn_graph_lax
from scanobjectnn_tpu.ops.pallas.knn_kernel import knn_graph_pallas
from scanobjectnn_torch import ops
from scanobjectnn_torch.ops.cuda.knn_kernel import knn_graph_kernel, knn_graph_plain, knn_point_plain

MARGIN_ULPS = 16  # module doc
CLEAR_SHARE = 0.9  # rows of random clouds that must clear the margin


def _margin_bound(x64: np.ndarray) -> np.ndarray:
    """Per query [B, N]: MARGIN_ULPS ulps of f32 of C·(|q|² + max|k|²)."""
    sq = (x64 * x64).sum(-1)
    return MARGIN_ULPS * 2.0 ** -24 * x64.shape[-1] * (sq + sq.max(-1, keepdims=True))


def clear_rows(x: np.ndarray, k: int) -> np.ndarray:
    """[B, N] bool: queries whose float64 k/(k+1) gap exceeds the bound."""
    x64 = x.astype(np.float64)
    d = ((x64[:, :, None, :] - x64[:, None, :, :]) ** 2).sum(-1)
    ds = np.sort(d, axis=-1)
    return ds[..., k] - ds[..., k - 1] > _margin_bound(x64)


def assert_graphs_agree(got: np.ndarray, want: np.ndarray, clear: np.ndarray, what: str) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype == np.int32, what
    bad = ~(got == want).all(-1) & clear
    assert not bad.any(), f"{what}: {int(bad.sum())} clear rows differ"


# (b, n, c, k): the T-Net / EdgeConv 1 width (3) and EdgeConv 2-4 (64) at
# DGCNN's k=20 and a smaller k, and a generic width.
CASES = {"c3_k20": (2, 128, 3, 20), "c64_k20": (2, 128, 64, 20), "c64_k8": (2, 96, 64, 8), "c16_k5": (3, 64, 16, 5),
         # k > 32: on the card the general kNN kernel with the cloud as its queries
         "c3_k40": (2, 128, 3, 40), "c64_k40": (2, 128, 64, 40)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_knn_graph_matches_lax_and_pallas(case):
    b, n, c, k = CASES[case]
    x = np.random.RandomState(n + c + k).randn(b, n, c).astype(np.float32)
    got = ops.knn_graph(torch.from_numpy(x), k).numpy()
    clear = clear_rows(x, k)
    print(f"{case}: {clear.mean():.4f} of the rows clear the k/(k+1) margin")
    assert clear.mean() >= CLEAR_SHARE
    assert (got[..., 0] == np.arange(n)).all()  # the self edge comes first
    assert_graphs_agree(got, np.asarray(knn_graph_lax(jnp.asarray(x), k)), clear, "knn_graph_lax")
    assert_graphs_agree(got, np.asarray(knn_graph_pallas(jnp.asarray(x), k, True)), clear, "knn_graph_pallas")


@pytest.mark.parametrize("c", [3, 8])
def test_knn_graph_ties_and_duplicates(c):
    # Dyadic lattice points, each repeated four times in shuffled order: the
    # distances are exact on both sides and tie (module doc).
    rng = np.random.RandomState(c)
    base = rng.randint(-3, 4, (2, 32, c)).astype(np.float32) * 0.25
    x = np.stack([p[rng.permutation(128)] for p in np.tile(base, (1, 4, 1))])
    k = 20
    got = ops.knn_graph(torch.from_numpy(x), k).numpy()
    everything = np.ones(x.shape[:2], bool)
    assert_graphs_agree(got, np.asarray(knn_graph_lax(jnp.asarray(x), k)), everything, "knn_graph_lax")
    assert_graphs_agree(got, np.asarray(knn_graph_pallas(jnp.asarray(x), k, True)), everything, "knn_graph_pallas")
    # Each point's first neighbour is the lowest-indexed copy of it, which
    # is itself or a twin at distance 0; its twins come in ascending index.
    twins = (x[:, :, None, :] == x[:, None, :, :]).all(-1)
    first = twins.argmax(-1)
    np.testing.assert_array_equal(got[..., 0], first)
    assert (np.diff(got[..., :4], axis=-1) > 0).all()


def test_knn_graph_k40_ties_and_duplicates():
    # As above at k = 40, which the card serves with the general kNN kernel.
    rng = np.random.RandomState(40)
    base = rng.randint(-3, 4, (2, 32, 3)).astype(np.float32) * 0.25
    x = np.stack([p[rng.permutation(128)] for p in np.tile(base, (1, 4, 1))])
    got = ops.knn_graph(torch.from_numpy(x), 40).numpy()
    everything = np.ones(x.shape[:2], bool)
    assert_graphs_agree(got, np.asarray(knn_graph_lax(jnp.asarray(x), 40)), everything, "knn_graph_lax")
    assert_graphs_agree(got, np.asarray(knn_graph_pallas(jnp.asarray(x), 40, True)), everything, "knn_graph_pallas")


def test_knn_graph_is_the_self_knn_point_and_carries_no_gradient():
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 50, 7).astype(np.float32)).requires_grad_()
    idx = ops.knn_graph(x, 6)
    assert idx.dtype == torch.int32 and not idx.requires_grad and idx.shape == (2, 50, 6)
    assert torch.equal(idx, knn_point_plain(x, x, 6)[1])
    assert torch.equal(knn_graph_kernel(x.detach(), 6), knn_graph_plain(x.detach(), 6))


def test_knn_graph_kernel_refuses_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        knn_graph_kernel(torch.zeros(1, 4, 3, device="meta"), 2)


def straddling_lattice(rng, b: int, n: int, c: int) -> np.ndarray:
    """Dyadic lattice points (exact distances on both sides) with exact
    duplicates at indices 31/32, 63/64 and 127/128: ties that straddle the
    card kernel's 32-key chunks and 64-key tiles."""
    x = rng.randint(-3, 4, (b, n, c)).astype(np.float32) * 0.25
    for lo in (31, 63, 127):
        if lo + 1 < n:
            x[:, lo + 1] = x[:, lo]
    return x


@pytest.mark.parametrize("c", [3, 64])
@pytest.mark.parametrize("k", [20, 32])
def test_knn_graph_ties_straddling_chunks_and_tiles(c, k):
    # The card kernel sorts the first 32 keys of a cloud and inserts the
    # rest 32 at a time from 64-key tiles; ties across those edges must
    # still go to the lowest index, as lax.top_k and the TPU's argmin give.
    x = straddling_lattice(np.random.RandomState(c + k), 2, 160, c)
    got = ops.knn_graph(torch.from_numpy(x), k).numpy()
    everything = np.ones(x.shape[:2], bool)
    assert_graphs_agree(got, np.asarray(knn_graph_lax(jnp.asarray(x), k)), everything, "knn_graph_lax")
    assert_graphs_agree(got, np.asarray(knn_graph_pallas(jnp.asarray(x), k, True)), everything, "knn_graph_pallas")
    twins = (x[:, :, None, :] == x[:, None, :, :]).all(-1)
    np.testing.assert_array_equal(got[..., 0], twins.argmax(-1))  # the lowest-indexed copy first
    for lo in (31, 63, 127):
        # Both copies list the pair at distance 0, in ascending index.
        for q in (lo, lo + 1):
            row = got[:, q]
            assert ((row == lo).argmax(-1) < (row == lo + 1).argmax(-1)).all()
            assert (row == lo).any(-1).all() and (row == lo + 1).any(-1).all()
