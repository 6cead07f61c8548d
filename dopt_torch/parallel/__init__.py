from dopt_torch.parallel.collectives import (UpdateShardSpec, alloc_flat,
                                             broadcast_to_workers,
                                             buckets_to_stacked, flat_buckets,
                                             flat_views,
                                             make_update_shard_spec,
                                             masked_average,
                                             mean_weight_matrix, mix_dense,
                                             stacked_to_buckets, where_mask)

__all__ = [
    "UpdateShardSpec",
    "alloc_flat",
    "broadcast_to_workers",
    "buckets_to_stacked",
    "flat_buckets",
    "flat_views",
    "make_update_shard_spec",
    "masked_average",
    "mean_weight_matrix",
    "mix_dense",
    "stacked_to_buckets",
    "where_mask",
]
