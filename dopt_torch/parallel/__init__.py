from dopt_torch.parallel.collectives import (UpdateShardSpec, alloc_flat,
                                             buckets_to_stacked, flat_buckets,
                                             flat_views,
                                             make_update_shard_spec,
                                             mix_dense, stacked_to_buckets)

__all__ = [
    "UpdateShardSpec",
    "alloc_flat",
    "buckets_to_stacked",
    "flat_buckets",
    "flat_views",
    "make_update_shard_spec",
    "mix_dense",
    "stacked_to_buckets",
]
