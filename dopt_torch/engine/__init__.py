from dopt_torch.engine.federated import FederatedTrainer
from dopt_torch.engine.gossip import GossipTrainer
from dopt_torch.engine.seqlm import SeqLMTrainer

__all__ = ["FederatedTrainer", "GossipTrainer", "SeqLMTrainer"]
