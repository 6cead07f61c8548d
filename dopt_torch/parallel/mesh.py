"""The worker axis over ranks: the port's counterpart of the parts of
dopt/parallel/mesh.py and dopt/parallel/multihost.py that the scatter,
shift and codec collectives need.

A ``WorkerGroup`` is ``size`` ranks, this process's ``rank``, the
``lanes`` workers each rank holds, a ``torch.distributed`` process
group or None, and an optional ``meter``: a Counter to which every
collective adds the bytes it hands to ``torch.distributed``.  The workers fold onto ranks contiguously, as dopt's
``shard_worker_tree`` lays them out over a 1-D mesh: worker i lives on
rank i // lanes, lane i % lanes.

* ``group=None`` is one rank and no wire: the collectives do what dopt's
  one-device mesh compiles to, and call no ``torch.distributed``
  function.
* A process group, of any size including 1, means every collective is
  really issued (NCCL on the card, gloo on the CPU).

``init_file_group`` joins a group through a ``file://`` rendezvous under
the caller's directory (no port to pick, so parallel test workers never
collide), and ``spawn_ranks`` runs a function on each of ``world_size``
spawned processes inside such a group — the counterpart of dopt's
``pick_ephemeral_port`` / ``initialize_distributed``.  dopt's hybrid
``(hosts × ici)`` meshes are not here: dopt keeps them on the dense path.
"""

from __future__ import annotations

import collections
import dataclasses
import os
from pathlib import Path
from typing import Any, Callable

import torch

WORKER_AXIS = "workers"


@dataclasses.dataclass(frozen=True)
class WorkerGroup:
    """``size`` ranks holding ``lanes`` contiguous workers each."""

    size: int
    rank: int
    lanes: int
    group: Any = None
    meter: collections.Counter | None = dataclasses.field(default=None,
                                                          compare=False)

    @property
    def wire(self) -> bool:
        """Whether collectives go through ``torch.distributed``."""
        return self.group is not None

    def count(self, op: str, kind: str, t: torch.Tensor) -> None:
        """Add the bytes of ``t``, handed to ``torch.distributed`` by
        operation ``op``, to the meter under ``(op, kind)``."""
        if self.meter is not None:
            self.meter[(op, kind)] += t.numel() * t.element_size()

    @property
    def lane0(self) -> int:
        """The global id of this rank's first lane."""
        return self.rank * self.lanes

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global ``[W, ...]`` tensor (a view)."""
        return x[self.lane0:self.lane0 + self.lanes]


def fit_mesh_devices(num_workers: int, requested: int | None = None) -> int:
    """The largest rank count ≤ min(workers, available) that divides the
    worker count (workers fold onto ranks in equal lanes); available is
    the visible CUDA devices, at least 1, unless ``requested``."""
    avail = (max(torch.cuda.device_count(), 1) if requested is None
             else requested)
    d = min(num_workers, avail)
    while num_workers % d:
        d -= 1
    return d


def make_worker_group(num_workers: int, group: Any = None) -> WorkerGroup:
    """The ``WorkerGroup`` of ``num_workers`` over ``group``'s ranks (one
    rank and no wire for None); the workers must fold evenly."""
    if group is None:
        return WorkerGroup(size=1, rank=0, lanes=num_workers)
    import torch.distributed as dist

    size = dist.get_world_size(group)
    if num_workers % size:
        raise ValueError(f"{num_workers} workers do not fold onto {size} "
                         "ranks evenly")
    return WorkerGroup(size=size, rank=dist.get_rank(group),
                       lanes=num_workers // size, group=group)


def init_file_group(init_dir, rank: int, world_size: int, *,
                    backend: str = "gloo", num_workers: int | None = None,
                    name: str = "rendezvous") -> WorkerGroup:
    """Join the default process group through the file ``init_dir/name``
    (``file://`` rendezvous) and return its ``WorkerGroup`` for
    ``num_workers`` (one lane a rank when None).  The caller ends it with
    ``torch.distributed.destroy_process_group()``."""
    import torch.distributed as dist

    path = Path(init_dir).resolve() / name
    path.parent.mkdir(parents=True, exist_ok=True)
    dist.init_process_group(backend, init_method=f"file://{path}",
                            rank=rank, world_size=world_size)
    return make_worker_group(world_size if num_workers is None
                             else num_workers, dist.group.WORLD)


def _rank_main(rank: int, fn: Callable, world_size: int, init_dir: str,
               backend: str, num_workers: int | None, args: tuple) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    wg = init_file_group(init_dir, rank, world_size, backend=backend,
                         num_workers=num_workers)
    try:
        fn(wg, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world_size: int, init_dir, *args,
                backend: str = "gloo", num_workers: int | None = None
                ) -> None:
    """Run ``fn(worker_group, *args)`` on ``world_size`` spawned
    processes joined by a ``file://`` rendezvous under ``init_dir``;
    returns when all have ended and raises if one failed.  ``fn`` must be
    importable from a module the children can load."""
    import torch.multiprocessing as mp

    init_dir = os.fspath(Path(init_dir).resolve())
    mp.spawn(_rank_main, args=(fn, world_size, init_dir, backend,
                               num_workers, args),
             nprocs=world_size, join=True)
