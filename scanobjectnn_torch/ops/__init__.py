"""Point-cloud ops (counterpart of ``scanobjectnn_tpu/ops``).  Hand-written
CUDA kernels and their plain PyTorch versions live in ``ops/cuda``."""

from scanobjectnn_torch.ops.fps import (  # noqa: F401
    farthest_point_sample,
    farthest_point_sample_with_coords,
    gather_point,
)
