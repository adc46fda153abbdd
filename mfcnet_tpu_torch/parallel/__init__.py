"""Data parallelism over ``torch.distributed`` (counterpart of
``mfcnet_tpu/parallel``)."""

from mfcnet_tpu_torch.parallel.dist import (
    all_sum,
    group_rank,
    group_world,
    init_distributed,
    local_device,
    rank_rows,
)

__all__ = ["all_sum", "group_rank", "group_world", "init_distributed",
           "local_device", "rank_rows"]
