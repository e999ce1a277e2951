"""Multi-process runtime on torch.distributed: data-parallel training
(dist), the rank mesh (mesh) and tensor-parallel matmuls (tp_overlap)."""

from .dist import (
    AllReduceSum,
    all_reduce_metrics,
    all_reduce_min,
    all_reduce_sum,
    all_reduce_sum_,
    barrier,
    data_group,
    get_rank,
    get_world_size,
    init_dist,
    is_master,
    master_only,
    master_only_print,
    shard_batch,
)
from .mesh import Mesh, make_mesh, replicate
