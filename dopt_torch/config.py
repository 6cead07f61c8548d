"""Typed, frozen experiment configuration for the PyTorch port.

Every field of ``dopt.config``'s ``DataConfig``, ``ModelConfig``,
``OptimizerConfig``, ``FederatedConfig``, ``GossipConfig`` and
``ExperimentConfig``, with the same names and defaults, so a preset, a
dopt config or a ``--set`` override means the same thing in both
packages.  Fields and sections of later slices (faults, robust,
population, comm, seqlm, the codecs' knobs, the mesh) exist with dopt's defaults: the trainers refuse any other
value, naming the slice that adds it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class DataConfig:
    """Dataset selection + partitioning (reference ``get_dataset`` args)."""

    dataset: str = "mnist"   # mnist | fmnist | cifar10 | cifar100 | a9a | synthetic
    iid: bool = True
    shards: int = 2          # non-IID shards per user
    num_users: int = 8
    data_dir: str | None = None   # directory with raw files; None -> synthetic
    synthetic_train_size: int = 2048
    synthetic_test_size: int = 512
    plan_impl: str = "numpy"  # "native" (C++ planner) arrives in a later slice
    local_holdout: float = 0.0
    # Fraction of each worker's shard held out as local validation (the
    # reference's train_val_test split: val_size = max(int(L·f), 1));
    # training runs on the rest, and every local epoch evaluates the
    # worker's val split into ``trainer.client_history``.
    holdout_mode: str = "deterministic"
    # deterministic — val = the FIRST val_size indices of the shard (P1);
    # random        — a seeded per-worker draw without replacement (P2).


@dataclass(frozen=True)
class ModelConfig:
    """Model zoo selection (reference ``args.model`` string dispatch)."""

    model: str = "model1"    # model1 | model3 | mlp | logistic
    stage_sizes: tuple[int, ...] | None = None   # ResNet-18 slice
    faithful: bool = True
    # faithful=True reproduces the reference's Softmax-head +
    # CrossEntropyLoss double-softmax; False uses the corrected logits
    # head (and post-conv ReLUs).
    num_classes: int = 10
    input_shape: tuple[int, ...] = (28, 28, 1)   # NHWC, as in dopt
    param_dtype: str = "float32"     # storage: float32 | bfloat16
    compute_dtype: str = "float32"   # forward/backward: float32 | bfloat16
    stacked_impl: str = "auto"
    # "auto": the worker-stacked grouped-conv forward, the port's only
    # one.  dopt's "vmap" (its oracle-parity mode) is refused.


@dataclass(frozen=True)
class OptimizerConfig:
    """Local SGD settings (torch momentum semantics)."""

    optimizer: str = "sgd"
    lr: float = 0.01
    momentum: float = 0.5
    weight_decay: float = 0.0
    # ℓ2 coefficient added to the local loss (λ‖θ‖²/2 as a loss term).
    rho: float = 0.1   # FedProx proximal weight / FedADMM penalty
    clip_norm: float = 0.0
    # > 0: clip each worker's gradient to this global ℓ2 norm after the
    # algorithm's edit, before the update (dopt's order).
    fused_update: bool = False
    # True sends every step's momentum-SGD update through the
    # hand-written CUDA kernel (dopt_torch.ops.fused_sgd_momentum).


@dataclass(frozen=True)
class FederatedConfig:
    """Server-coordinated path (reference P1 ``servers.py``)."""

    algorithm: str = "fedavg"   # fedavg | fedprox | fedadmm | scaffold
    frac: float = 0.1           # fraction of users sampled per round
    rounds: int = 20
    local_ep: int = 10
    local_bs: int = 50
    compact: bool | None = None
    # Train only the m sampled lanes ([m, ...] gather → local update →
    # scatter back) instead of all W lanes with the unsampled results
    # masked away.  None = auto (on when frac < 1 and the fused epilogue
    # is off).
    block_rounds: int = 1
    # > 1 runs that many rounds a block: each round replays a CUDA graph
    # of the round body, with one device→host fetch a block
    # (dopt_torch.engine.graphs); on the CPU the same block loop runs
    # the body eagerly.
    comm_dtype: str | None = None   # arrives with the codecs slice
    staleness_max: int = 0      # > 0 arrives with the network slice
    staleness_decay: float = 0.5
    update_sharding: str = "off"    # "scatter": multi-GPU slice
    update_bucket_mb: float = 4.0
    # Per-worker payload bound of one flat bucket of the fused epilogue.
    fused_update: str = "off"
    # "off" | "on".  "on" carries theta as the [W, ...] broadcast slab in
    # a flat bucket store and runs each round's masked mean + theta
    # update as ONE CUDA kernel pass per bucket,
    # θ'_b = M(mask)·disp + θ_b (kernel 2 with lr = −1);
    # fedavg/fedprox, full width only.
    prefetch: str = "off"
    # "off" | "on".  "on" builds the next block's batch plans and stages
    # them on the device on a background thread while the current block
    # runs (dopt_torch.data.prefetch); blocked runs only.
    diagnostics: str = "off"    # "on" arrives with the telemetry slice


@dataclass(frozen=True)
class GossipConfig:
    """Serverless gossip/consensus path (reference P2 ``simulators.py``)."""

    algorithm: str = "dsgd"     # dsgd | nocons | centralized | fedlcon | gossip
    topology: str = "circle"    # circle | star | complete | dynamic | random
    #                           # | torus | hierarchical | one_peer_exp
    mode: str = "stochastic"    # stochastic | double_stochastic | metropolis | uniform | ones
    rounds: int = 10
    local_ep: int = 4
    local_bs: int = 128
    eps: int = 1                # fedlcon's consensus sweeps a round
    eval_mode: str = "full"
    # full — every worker evaluates the whole test split; sharded — each
    # evaluates its round-robin 1/W shard (the in-training metric only).
    mixing: str = "sync"
    comm_impl: str = "auto"     # the single-device port always mixes dense
    block_rounds: int = 1
    # > 1: blocks of that many rounds, as FederatedConfig.block_rounds.
    prefetch: str = "off"       # "off" | "on", as FederatedConfig.prefetch
    faithful_bugs: bool = False   # fedlcon: one sweep, the reference's bug
    self_weight: bool = False   # reference mixing has a zero diagonal
    hier_groups: int = 2
    hier_period: int = 4
    # choco and its compressors: the codecs slice.
    choco_gamma: float = 1.0
    compression: str = "topk"
    compression_ratio: float = 1.0
    qsgd_levels: int = 0
    comm_dtype: str | None = None
    correction: str = "none"    # "push_sum": the faults slice
    update_sharding: str = "off"
    update_bucket_mb: float = 4.0
    # Per-worker payload bound of one flat bucket of the fused epilogue
    # (dopt_torch.parallel.collectives.make_update_shard_spec).
    fused_update: str = "off"
    # "off" | "on".  "on" carries (post-mix params q, displacement
    # fbuf) and runs the round epilogue q_t = W·q_{t-1} − fbuf_{t-1} as
    # one CUDA kernel pass per flat bucket — the D-PSGD ordering of
    # dopt's GossipConfig.fused_update.
    diagnostics: str = "off"    # "on" arrives with the telemetry slice
    dropout: float = 0.0        # dopt's alias of faults.crash: faults slice


@dataclass(frozen=True)
class ExperimentConfig:
    """Top-level experiment description (the notebook form cell, typed)."""

    name: str = "experiment"
    seed: int = 2022
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimizerConfig = field(default_factory=OptimizerConfig)
    gossip: GossipConfig | None = None
    federated: FederatedConfig | None = None
    # Sections of later slices; the trainers refuse any that is set.
    seqlm: Any = None
    faults: Any = None
    robust: Any = None
    population: Any = None
    comm: Any = None
    backend: str = "jax"
    # dopt's engine switch: "jax" is dopt's engine, which the port takes
    # to mean its own; "torch" (dopt's sequential CPU oracle) is refused.
    mesh_devices: int | None = None   # > 1: scatter and multi-GPU slice
    mesh_hosts: int | None = None

    def replace(self, **kw: Any) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)

    @property
    def num_users(self) -> int:
        return self.data.num_users
