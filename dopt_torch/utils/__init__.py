from dopt_torch.utils.metrics import History, atomic_write_text, trimmed_stats
from dopt_torch.utils.prng import host_rng

__all__ = ["History", "atomic_write_text", "trimmed_stats", "host_rng"]
