"""Rendering, the confusion-matrix plot and the 3DmFV plots (counterpart of
``scanobjectnn_tpu/viz``: ``render.py``, ``cmat.py`` and ``fvplots.py``;
the viewer ``show3d.py`` and the interpolation check ``interp_check.py``
are imported by name, as in JAX)."""

from scanobjectnn_torch.viz.cmat import plot_confusion_matrix  # noqa: F401
from scanobjectnn_torch.viz.fvplots import (  # noqa: F401
    MINMAX_DERIVATIVE_LABELS,
    draw_gaussians,
    visualize_fv,
    visualize_pc,
    visualize_pc_seg,
    visualize_pc_seg_diff,
)
from scanobjectnn_torch.viz.render import (  # noqa: F401
    draw_point_cloud,
    point_cloud_three_views,
    point_cloud_to_volume,
    volume_to_point_cloud,
)
