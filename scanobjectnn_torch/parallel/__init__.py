"""Data parallelism over ``torch.distributed`` (counterpart of
``scanobjectnn_tpu/parallel``): the mesh helpers and the cross-replica
reductions of ``mesh.py``."""

from scanobjectnn_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    all_reduce_mean,
    all_reduce_sum,
    batch_sharding,
    draw_rows,
    gather_rows,
    global_batch,
    make_mesh,
    replicated_sharding,
    shard_batch,
    sum_parts,
)
