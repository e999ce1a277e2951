"""Multi-process runtime on torch.distributed: data-parallel training
(dist), the rank mesh and the params' tensor-parallel layout (mesh),
tensor-parallel QAT training (tp_train) and tensor-parallel matmuls
(tp_overlap)."""

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
from .mesh import (
    Mesh,
    batch_sharding,
    gather_params,
    int_param_shardings,
    make_mesh,
    param_shardings,
    replicate,
    shard_params,
)
