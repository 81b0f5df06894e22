"""3DmFV diagnostic plots (counterpart of ``scanobjectnn_tpu/viz/fvplots.py``):
Fisher-vector grids, the GMM's gaussians, point-cloud and segmentation
renders.  Reference: 3DmFV-Net/utils/visualization.py (``visualize_fv``
:129-204, ``draw_gaussians`` :65-128, ``visualize_pc``, ``visualize_pc_seg``
and ``visualize_pc_seg_diff`` :205-327).

Headless (the Agg backend), written straight to files.  ``matplotlib`` is
imported when a function is called; where it is missing the function
writes ``output_path + ".unavailable.txt"`` and returns, as the JAX module
does.  Inputs are numpy arrays (or anything ``np.asarray`` takes: call
``.cpu()`` on a card tensor first); ``draw_gaussians`` takes an
``nn.fisher.GridGMM``.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "MINMAX_DERIVATIVE_LABELS",
    "visualize_fv",
    "draw_gaussians",
    "visualize_pc",
    "visualize_pc_seg",
    "visualize_pc_seg_diff",
]

# Row labels of the [20, G] FV grid, matching nn.fisher.fisher_vector's
# layout and the reference's 'minmax' ordering (visualization.py:147-155).
MINMAX_DERIVATIVE_LABELS = (
    "d_pi_max", "d_pi_sum",
    "d_mu1_max", "d_mu2_max", "d_mu3_max",
    "d_mu1_min", "d_mu2_min", "d_mu3_min",
    "d_mu1_sum", "d_mu2_sum", "d_mu3_sum",
    "d_sig1_max", "d_sig2_max", "d_sig3_max",
    "d_sig1_min", "d_sig2_min", "d_sig3_min",
    "d_sig1_sum", "d_sig2_sum", "d_sig3_sum",
)


def _plt(output_path: str):
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except ImportError:
        with open(output_path + ".unavailable.txt", "w") as f:
            f.write("matplotlib unavailable; plot skipped\n")
        return None


def visualize_fv(
    fv: np.ndarray,
    output_path: str,
    labels=None,
    max_n_images: int = 5,
    normalization: bool = True,
) -> None:
    """FV-as-image (visualization.py:129-204): one seismic-colormap [20, G]
    grid per model, rows labeled by derivative component.

    Args:
      fv: [20, G] or [B, 20, G] (fisher_vector output) or flattened [G*20].
      output_path: file to write (extension decides format; .pdf matches
        the reference's export).
      labels: per-model title strings.
    """
    plt = _plt(output_path)
    if plt is None:
        return
    fv = np.asarray(fv)
    if fv.ndim == 1:
        fv = fv.reshape(1, len(MINMAX_DERIVATIVE_LABELS), -1)
    elif fv.ndim == 2:
        fv = fv[None]
    scale = 1.0 if normalization else 0.05
    n = min(fv.shape[0], max_n_images)
    fig, axes = plt.subplots(n, squeeze=False)
    ticks = np.arange(len(MINMAX_DERIVATIVE_LABELS))
    for i in range(n):
        ax = axes[i, 0]
        ax.imshow(fv[i], cmap="seismic", vmin=-scale, vmax=scale)
        if labels is not None:
            ax.set_title(str(labels[i]))
        ax.set_xticks([])
        ax.set_yticks(ticks)
        ax.set_yticklabels(MINMAX_DERIVATIVE_LABELS)
        ax.tick_params(labelsize=3)
    plt.subplots_adjust(hspace=0.5)
    fig.savefig(output_path, bbox_inches="tight", dpi=300)
    plt.close(fig)


def _axis_equal_3d(ax, pts) -> None:
    # visualization.py:26-33: equal aspect via max extent.
    extents = np.array([pts[:, i].max() - pts[:, i].min() for i in range(3)])
    centers = np.array([(pts[:, i].max() + pts[:, i].min()) / 2 for i in range(3)])
    r = extents.max() / 2 if extents.max() > 0 else 1.0
    ax.set_xlim(centers[0] - r, centers[0] + r)
    ax.set_ylim(centers[1] - r, centers[1] + r)
    ax.set_zlim(centers[2] - r, centers[2] + r)


def draw_gaussians(
    gmm, output_path: str, points: np.ndarray | None = None, thresh: float = 0.0
) -> None:
    """3D view of the mixture (visualization.py:65-91): one translucent
    sphere per gaussian at its mean, radius = mean stddev, skipping
    components with weight <= thresh; optionally overlays a point cloud.

    gmm: ``nn.fisher.GridGMM`` (weights, means, stddevs arrays).
    """
    plt = _plt(output_path)
    if plt is None:
        return
    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d")
    u = np.linspace(0, 2 * np.pi, 12)
    v = np.linspace(0, np.pi, 12)
    sx = np.outer(np.cos(u), np.sin(v))
    sy = np.outer(np.sin(u), np.sin(v))
    sz = np.outer(np.ones_like(u), np.cos(v))
    w = np.asarray(gmm.weights)
    means = np.asarray(gmm.means)
    stds = np.asarray(gmm.stddevs)
    for i in range(len(w)):
        if w[i] <= thresh:
            continue
        r = float(np.mean(stds[i]))
        ax.plot_surface(
            means[i, 0] + r * sx, means[i, 1] + r * sy,
            means[i, 2] + r * sz if means.shape[1] > 2 else r * sz,
            color="tab:blue", alpha=0.15, linewidth=0,
        )
    if points is not None:
        points = np.asarray(points)
        ax.scatter(points[:, 0], points[:, 1], points[:, 2], c="k", marker=".", s=2)
    _axis_equal_3d(ax, means)
    fig.savefig(output_path, bbox_inches="tight", dpi=300)
    plt.close(fig)


def _rotate_x(points: np.ndarray, angle: float) -> np.ndarray:
    # provider.rotate_x_point_cloud_by_angle(-pi/2): upright rendering.
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], points.dtype)
    return points @ rot.T


def _scatter_pc(plt, points, colors, cmap, vmin, vmax):
    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d")
    pts = _rotate_x(np.asarray(points, np.float64), -0.5 * np.pi)
    ax.scatter(
        pts[:, 0], pts[:, 1], pts[:, 2], c=colors, cmap=cmap,
        marker=".", vmin=vmin, vmax=vmax, edgecolors="none",
    )
    ax.view_init(elev=35.264, azim=45)
    _axis_equal_3d(ax, pts)
    ax.axis("off")
    return fig


def visualize_pc(points: np.ndarray, output_path: str, title=None) -> None:
    """Plain 3D scatter render (visualization.py:298-326)."""
    plt = _plt(output_path)
    if plt is None:
        return
    fig = _scatter_pc(plt, points, "b", None, None, None)
    if title:
        fig.suptitle(str(title))
    fig.savefig(output_path, bbox_inches="tight", dpi=300)
    plt.close(fig)


def visualize_pc_seg(
    points: np.ndarray, seg: np.ndarray, color_map, output_path: str
) -> None:
    """Color-coded segmentation render (visualization.py:205-229)."""
    plt = _plt(output_path)
    if plt is None:
        return
    import matplotlib.colors as mcolors

    n_colors = len(color_map)
    cmap = mcolors.LinearSegmentedColormap.from_list("seg", list(color_map), N=n_colors)
    fig = _scatter_pc(plt, points, np.asarray(seg), cmap, 0, n_colors)
    fig.savefig(output_path, bbox_inches="tight", dpi=300)
    plt.close(fig)


def visualize_pc_seg_diff(
    points: np.ndarray, seg_gt: np.ndarray, seg_pred: np.ndarray, output_path: str
) -> None:
    """Red/blue wrong/right render (visualization.py:230-254)."""
    plt = _plt(output_path)
    if plt is None:
        return
    import matplotlib.colors as mcolors

    cmap = mcolors.LinearSegmentedColormap.from_list(
        "diff", [[1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], N=2
    )
    diff = (np.asarray(seg_gt) == np.asarray(seg_pred)).astype(np.int32)
    fig = _scatter_pc(plt, points, diff, cmap, 0, 1)
    fig.savefig(output_path, bbox_inches="tight", dpi=300)
    plt.close(fig)
