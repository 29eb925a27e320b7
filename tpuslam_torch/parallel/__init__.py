"""Data-parallel pretraining over a `torch.distributed` process group."""
from tpuslam_torch.parallel.mesh import (
    local_init_method,
    make_dp_train_step,
    make_process_group,
    shard_batch,
)

__all__ = ["local_init_method", "make_dp_train_step", "make_process_group", "shard_batch"]
