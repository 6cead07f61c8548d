from dopt_torch.engine.federated import FederatedTrainer
from dopt_torch.engine.gossip import GossipTrainer

__all__ = ["FederatedTrainer", "GossipTrainer"]
