"""3D modified Fisher vectors, 3DmFV (counterpart of
``scanobjectnn_tpu/nn/fisher.py``).  References: 3DmFV-Net/utils/tf_util.py:578-650
(get_3dmfv) and 3DmFV-Net/utils/utils.py:10-119 (the GMMs).

The GMM builders are numpy and a copy of the JAX package's, so their
arrays are its bits: a uniform 3D or 2D grid of spherical gaussians on
[-1, 1]^D with uniform weights, or a diagonal GMM learned by EM (no
sklearn).  ``fisher_vector`` is plain PyTorch on [B, N, G, D] temporaries,
in the JAX function's order of operations: per-point posteriors, the
derivative features ∂π (max, sum), ∂μ and ∂σ (max, min, sum over the
points), power normalisation and an L2 normalisation of each feature over
the gaussians.  At B=64, N=1024 and G=125 each [B, N, G, 3] f32 temporary
is 98 MB.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "FV_FEATURES",
    "GridGMM",
    "fisher_vector",
    "get_2d_grid_gmm",
    "get_3d_grid_gmm",
    "get_gmm",
    "get_learned_gmm",
]

# Features a gaussian: ∂π (max, sum) 2, ∂μ (max, min, sum)·D 9, ∂σ 9.
FV_FEATURES = 20
# The dtype ``fisher_vector`` computes in, as the JAX function's
# ``jnp.float32`` (a float64 reference binds float64 here).
COMPUTE_DTYPE = torch.float32


@dataclass(frozen=True)
class GridGMM:
    weights: np.ndarray  # [G]
    means: np.ndarray  # [G, D]
    stddevs: np.ndarray  # [G, D], the square roots of the diagonal covariance
    subdivisions: tuple

    @property
    def n_gaussians(self) -> int:
        return self.weights.shape[0]


def _grid_gmm(subdivisions, variance: float) -> GridGMM:
    """Centres at the grid of cell midpoints in [-1, 1]^D (``np.mgrid``,
    row-major), spherical variance, uniform weights."""
    subdivisions = tuple(subdivisions)
    n = int(np.prod(subdivisions))
    step = [1.0 / s for s in subdivisions]
    means = np.mgrid[tuple(slice(st - 1, 1.0 - st, complex(0, s)) for st, s in zip(step, subdivisions))]
    means = means.reshape(len(subdivisions), -1).T
    return GridGMM(
        weights=np.full((n,), 1.0 / n),
        means=means.astype(np.float64),
        stddevs=np.sqrt(variance * np.ones_like(means)),
        subdivisions=subdivisions,
    )


def get_3d_grid_gmm(subdivisions: tuple[int, int, int] = (5, 5, 5), variance: float = 0.04) -> GridGMM:
    """The m³ grid GMM (utils.py:69-93)."""
    return _grid_gmm(subdivisions, variance)


def get_2d_grid_gmm(subdivisions: tuple[int, int] = (5, 5), variance: float = 0.04) -> GridGMM:
    """The m² grid GMM (utils.py:95-119)."""
    return _grid_gmm(subdivisions, variance)


def get_learned_gmm(
    points: np.ndarray, n_gaussians: int, n_iter: int = 100, tol: float = 1e-3, seed: int = 0
) -> GridGMM:
    """Diagonal GMM learned from ``points`` [M, D] by EM (utils.py:54-67,
    sklearn's ``GaussianMixture(covariance_type='diag')`` in plain numpy):
    means at distinct random points of ``np.random.RandomState(seed)``, the
    data variance shared, E and M steps to a log-likelihood change below
    ``tol``, sklearn's 1e-6 diagonal regularisation.  ``subdivisions`` is
    (n_gaussians,)."""
    pts = np.asarray(points, np.float64)
    m, d = pts.shape
    rng = np.random.RandomState(seed)
    reg = 1e-6
    means = pts[rng.choice(m, n_gaussians, replace=False)].copy()
    variances = np.tile(pts.var(axis=0) + reg, (n_gaussians, 1))
    weights = np.full(n_gaussians, 1.0 / n_gaussians)

    prev_ll = -np.inf
    for _ in range(n_iter):
        # E step: log N(x | mu_g, diag sigma_g) + log w_g.
        diff2 = (pts[:, None, :] - means[None]) ** 2 / variances[None]  # [M, G, D]
        log_p = (
            -0.5 * diff2.sum(-1)
            - 0.5 * np.log(variances).sum(-1)
            - 0.5 * d * np.log(2 * np.pi)
            + np.log(np.maximum(weights, 1e-300))
        )
        mx = log_p.max(axis=1, keepdims=True)
        log_norm = mx + np.log(np.exp(log_p - mx).sum(axis=1, keepdims=True))
        resp = np.exp(log_p - log_norm)  # [M, G]
        ll = float(log_norm.mean())

        # M step.
        nk = resp.sum(axis=0) + 10 * np.finfo(np.float64).eps
        means = (resp.T @ pts) / nk[:, None]
        diff = pts[:, None, :] - means[None]
        variances = np.einsum("mg,mgd->gd", resp, diff**2) / nk[:, None] + reg
        weights = nk / m

        if abs(ll - prev_ll) < tol:
            break
        prev_ll = ll

    return GridGMM(weights=weights, means=means, stddevs=np.sqrt(variances), subdivisions=(n_gaussians,))


def get_gmm(
    points: np.ndarray | None, n_gaussians, num_point: int | None = None, type: str = "grid",
    variance: float = 0.05, d: int = 3,
) -> GridGMM:
    """utils.get_gmm (utils.py:10-52): "grid" builds a 2D or 3D grid of
    ``n_gaussians`` a side, "learn" runs EM on ``points``."""
    if type == "grid":
        if d == 2:
            return get_2d_grid_gmm((n_gaussians, n_gaussians), variance)
        if d == 3:
            return get_3d_grid_gmm((n_gaussians,) * 3, variance)
        raise ValueError("grid GMM supports D=2 or D=3")
    if type == "learn":
        if points is None:
            raise ValueError("'learn' requires training points")
        if isinstance(n_gaussians, (list, tuple)):
            raise ValueError("non-grid n_gaussians must be a scalar")
        return get_learned_gmm(np.asarray(points).reshape(-1, d), int(n_gaussians))
    raise ValueError("GMM type must be 'grid' or 'learn'")


def _minmaxsum(x: torch.Tensor) -> torch.Tensor:
    """concat(max, min, sum) over the points: [B, N, G, D] -> [B, G, 3D]."""
    return torch.cat([x.amax(dim=1), x.amin(dim=1), x.sum(dim=1)], dim=-1)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    """Power normalisation ``sign(x)·sqrt(|x|)``, then L2 over the gaussian
    axis (floored at 1e-12).  The gradient of the first is NaN at an exact
    0, as in JAX."""
    x = torch.sign(x) * torch.sqrt(torch.abs(x))
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True), min=1e-12)


def fisher_vector(
    points: torch.Tensor, weights, means, stddevs, flatten: bool = False
) -> torch.Tensor:
    """3DmFV features of ``points`` [B, N, D] under the GMM ``weights`` [G],
    ``means`` [G, D], ``stddevs`` [G, D] (tensors or arrays; taken in
    ``COMPUTE_DTYPE``): [B, 20, G] (the grid tensor's order), or [B, G·20]
    with ``flatten``."""
    points = points.to(COMPUTE_DTYPE)
    b, n, d = points.shape
    w, mu, sigma = (torch.as_tensor(a, dtype=COMPUTE_DTYPE, device=points.device) for a in (weights, means, stddevs))

    diff = (points[:, :, None, :] - mu) / sigma  # [B, N, G, D]
    log_p = (
        -0.5 * torch.square(diff).sum(dim=-1)
        - torch.log(sigma).sum(dim=-1)
        - 0.5 * d * math.log(2.0 * math.pi)
    )
    p = torch.exp(log_p)  # [B, N, G]
    w_p = p * w
    q = w_p / w_p.sum(dim=-1, keepdim=True)  # posteriors
    sqrt_w = torch.sqrt(w)

    d_pi_all = (q - w) / (sqrt_w * n)
    d_pi = torch.stack([d_pi_all.amax(dim=1), d_pi_all.sum(dim=1)], dim=-1)  # [B, G, 2]
    q_d = q[..., None]
    d_mu = _minmaxsum(q_d * diff / sigma) / (n * sqrt_w[:, None])  # [B, G, 3D]
    d_sigma = _minmaxsum(q_d * (torch.square(diff) - 1.0)) / (n * torch.sqrt(2.0 * w)[:, None])

    fv = torch.cat([_normalize(d_pi), _normalize(d_mu), _normalize(d_sigma)], dim=2)  # [B, G, 20]
    fv = fv.transpose(1, 2)  # [B, 20, G]
    return fv.reshape(b, -1) if flatten else fv
