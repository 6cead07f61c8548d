from dopt_torch.data.datasets import Dataset, load_dataset, make_synthetic
from dopt_torch.data.partition import (assign_client_shards, holdout_split,
                                       iid_split, noniid_split,
                                       orphan_shard_adopters, partition,
                                       reassign_shards)
from dopt_torch.data.pipeline import (BatchPlan, eval_batches,
                                      gather_batches, make_batch_plan,
                                      sharded_eval_batches,
                                      stacked_eval_batches)
from dopt_torch.data.prefetch import (PrefetchStager, ready, timed_build,
                                      upload)

__all__ = [
    "Dataset",
    "load_dataset",
    "make_synthetic",
    "assign_client_shards",
    "holdout_split",
    "iid_split",
    "noniid_split",
    "orphan_shard_adopters",
    "partition",
    "reassign_shards",
    "BatchPlan",
    "eval_batches",
    "make_batch_plan",
    "gather_batches",
    "sharded_eval_batches",
    "stacked_eval_batches",
    "PrefetchStager",
    "ready",
    "timed_build",
    "upload",
]
