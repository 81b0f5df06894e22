"""Point-cloud ops (counterpart of ``scanobjectnn_tpu/ops``).  Hand-written
CUDA kernels and their plain PyTorch versions live in ``ops/cuda``."""

from scanobjectnn_torch.ops.emd import auction_match, emd_loss  # noqa: F401
from scanobjectnn_torch.ops.fps import (  # noqa: F401
    farthest_point_sample,
    farthest_point_sample_with_coords,
    gather_point,
    prob_sample,
    prob_sample_pdf,
)
from scanobjectnn_torch.ops.grouping import (  # noqa: F401
    batched_index_gather,
    group_point,
    knn_graph,
    knn_point,
    pairwise_squared_distance,
    query_ball_group,
    query_ball_point,
)
from scanobjectnn_torch.ops.interpolate import (  # noqa: F401
    three_interpolate,
    three_interpolate_weights,
    three_nn,
)
