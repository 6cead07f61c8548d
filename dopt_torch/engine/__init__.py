from dopt_torch.engine.gossip import GossipTrainer

__all__ = ["GossipTrainer"]
