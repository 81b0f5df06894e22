"""Rendering and the confusion-matrix plot (counterpart of
``scanobjectnn_tpu/viz``: ``render.py`` and ``cmat.py``)."""

from scanobjectnn_torch.viz.cmat import plot_confusion_matrix  # noqa: F401
from scanobjectnn_torch.viz.render import (  # noqa: F401
    draw_point_cloud,
    point_cloud_three_views,
    point_cloud_to_volume,
    volume_to_point_cloud,
)
