"""The worker axis over ranks: the port's counterpart of
dopt/parallel/mesh.py (the engines' mesh factory ``make_worker_mesh``,
``fit_mesh_devices``, ``shard_worker_tree``) over ``torch.distributed``
ranks instead of a jax device mesh.

A ``WorkerGroup`` is ``size`` ranks, this process's ``rank``, the
``lanes`` workers each rank holds, a ``torch.distributed`` process
group or None, the group's ``backend``, the ``hosts`` the ranks split
into, and an optional ``meter``: a Counter to which every collective
adds the bytes it hands to ``torch.distributed``, keyed by operation,
kind and dtype (``meter_by_kind`` sums over the dtypes).  The workers fold onto
ranks contiguously, as dopt's ``shard_worker_tree`` lays them out over a
1-D mesh: worker i lives on rank i // lanes, lane i % lanes.  With
``hosts`` > 1 the ranks are dopt's hybrid ``(hosts × ici)`` grid, rank r
at ``(r // per_host, r % per_host)``; the fold stays contiguous over the
whole grid, as dopt's ``worker_sharding`` folds the worker axis over both
mesh axes.

* ``group=None`` is one rank and no wire: the collectives do what dopt's
  one-device mesh compiles to, and call no ``torch.distributed``
  function.
* A process group, of any size including 1, means every collective is
  really issued (NCCL, one GPU a rank; or gloo, on the CPU or for ranks
  that share one card, where the collectives stage CUDA payloads through
  pinned host memory: ``WorkerGroup.staged``).  The caller picks the
  backend when it starts the group; nothing switches it.

``make_seq_group`` is the sequence-parallel LM's group (dopt's
``make_seq_mesh``): the launched ranks, one block of the sequence each.
``engine_group`` is the engines' factory (dopt's ``make_worker_mesh``):
``mesh_devices`` ranks of the launched world, which must divide the
worker count — where dopt would quietly leave devices idle, the port
raises and names the rank count that fits.  ``shard_worker_tree`` takes
a rank's rows of a whole host tree (every rank holds the whole host
array, as dopt's ``make_array_from_callback`` placement does: no
collective) and ``gather_workers`` all-gathers the lanes back to
``[W, ...]``.  ``init_file_group`` joins a group through a ``file://``
rendezvous under the caller's directory (no port to pick, so parallel
test workers never collide), and ``spawn_ranks`` runs a function on each
of ``world_size`` spawned processes inside such a group; torchrun-style
launches go through ``dopt_torch.parallel.multihost``.
"""

from __future__ import annotations

import collections
import dataclasses
import os
from pathlib import Path
from typing import Any, Callable

import torch

WORKER_AXIS = "workers"
HOST_AXIS = "hosts"
ICI_AXIS = "ici"


@dataclasses.dataclass(frozen=True)
class WorkerGroup:
    """``size`` ranks holding ``lanes`` contiguous workers each."""

    size: int
    rank: int
    lanes: int
    group: Any = None
    meter: collections.Counter | None = dataclasses.field(default=None,
                                                          compare=False)
    hosts: int = 1
    backend: str | None = None

    @property
    def wire(self) -> bool:
        """Whether collectives go through ``torch.distributed``."""
        return self.group is not None

    def count(self, op: str, kind: str, t: torch.Tensor) -> None:
        """Add the bytes of ``t``, handed to ``torch.distributed`` by
        operation ``op``, to the meter under ``(op, kind, dtype)``, the
        dtype by its torch name (``float32``, ``uint8``)."""
        if self.meter is not None:
            dtype = str(t.dtype).removeprefix("torch.")
            self.meter[(op, kind, dtype)] += t.numel() * t.element_size()

    def staged(self, t: torch.Tensor) -> bool:
        """Whether a collective on ``t`` stages it through host memory:
        gloo takes host tensors only, so CUDA lanes of ranks that share
        a card cross it from pinned host buffers."""
        return self.backend == "gloo" and t.is_cuda

    @property
    def lane0(self) -> int:
        """The global id of this rank's first lane."""
        return self.rank * self.lanes

    @property
    def num_workers(self) -> int:
        return self.size * self.lanes

    def local(self, x):
        """This rank's rows of a global ``[W, ...]`` tensor or array (a
        view)."""
        return x[self.lane0:self.lane0 + self.lanes]

    @property
    def coords(self) -> tuple[int, int]:
        """This rank's ``(host, local)`` coordinates on the grid."""
        per = self.size // self.hosts
        return self.rank // per, self.rank % per

    @property
    def shape(self) -> collections.OrderedDict:
        """dopt's ``mesh.shape`` of the same layout (its error messages
        print it)."""
        if self.hosts > 1:
            return collections.OrderedDict(
                [(HOST_AXIS, self.hosts), (ICI_AXIS, self.size // self.hosts)])
        return collections.OrderedDict([(WORKER_AXIS, self.size)])

    @property
    def flat(self) -> bool:
        """A flat 1-D layout (dopt's ``len(mesh.axis_names) == 1``)."""
        return self.hosts == 1


def meter_by_kind(meter) -> dict[tuple[str, str], int]:
    """A meter's bytes by ``(op, kind)``, summed over the dtypes (empty
    for None: a group with no meter)."""
    out: dict[tuple[str, str], int] = {}
    for (op, kind, _), b in (meter or {}).items():
        out[(op, kind)] = out.get((op, kind), 0) + b
    return out


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


def _dist():
    import torch.distributed as dist

    return dist


def launched_world() -> int:
    """The size of the default process group, 1 where none is up."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def make_worker_group(num_workers: int, group: Any = None, *,
                      hosts: int | None = None,
                      meter: collections.Counter | None = None
                      ) -> WorkerGroup:
    """The ``WorkerGroup`` of ``num_workers`` over ``group``'s ranks (one
    rank and no wire for None); the workers must fold evenly."""
    if group is None:
        return WorkerGroup(size=1, rank=0, lanes=num_workers, meter=meter)
    dist = _dist()
    size = dist.get_world_size(group)
    if num_workers % size:
        raise ValueError(f"{num_workers} workers do not fold onto {size} "
                         "ranks evenly")
    hosts = int(hosts or 1)
    if size % hosts:
        raise ValueError(f"{size} ranks not divisible into {hosts} hosts")
    return WorkerGroup(size=size, rank=dist.get_rank(group),
                       lanes=num_workers // size, group=group, meter=meter,
                       hosts=hosts, backend=str(dist.get_backend(group)))


def _launched_ranks(mesh_devices: int | None, axis: str) -> int:
    """The ranks ``mesh_devices`` asks the ``axis`` axis to run over: 1
    where it is 1, or None without a process group; else the launched
    world, which a value > 1 must equal (the message names the launch)."""
    world = launched_world()
    if mesh_devices == 1 or (mesh_devices is None and world == 1):
        return 1
    ranks = world if mesh_devices is None else mesh_devices
    if world != ranks:
        up = ("no torch.distributed process group is initialized"
              if world == 1 else f"the process group has {world} ranks")
        raise ValueError(
            f"mesh_devices={ranks} runs the {axis} axis over {ranks} ranks, "
            f"but {up}: launch one process a GPU (python -m "
            f"torch.distributed.run --nproc-per-node {ranks} -m "
            "dopt_torch.run ...), or join the ranks from Python with "
            "dopt_torch.parallel.init_file_group / spawn_ranks")
    return ranks


def make_seq_group(mesh_devices: int | None = None) -> WorkerGroup:
    """The sequence-parallel group (dopt's ``make_seq_mesh``): the
    launched ``torch.distributed`` world, or one rank where none is up or
    ``mesh_devices=1``; a value > 1 must equal the world.  Rank r holds
    the r-th contiguous block of the sequence (one lane a rank).  A
    group of more than one rank carries a byte meter."""
    if mesh_devices is not None and (not isinstance(mesh_devices, int)
                                     or mesh_devices < 1):
        raise ValueError(f"mesh_devices={mesh_devices!r} must be a positive "
                         "int or None")
    ranks = _launched_ranks(mesh_devices, "sequence")
    if ranks == 1:
        return make_worker_group(1)
    return make_worker_group(ranks, _dist().group.WORLD,
                             meter=collections.Counter())


def fold_error(num_workers: int, ranks: int) -> str:
    """The refusal of a rank count that does not divide the workers."""
    fit = fit_mesh_devices(num_workers, ranks)
    return (f"{num_workers} workers do not fold onto {ranks} ranks in equal "
            f"lanes; dopt would run them on {fit} of its devices and leave "
            f"the rest idle, the port refuses: launch {fit} ranks "
            f"(mesh_devices={fit})")


def engine_group(num_workers: int, mesh_devices: int | None = None,
                 mesh_hosts: int | None = None) -> WorkerGroup:
    """The engines' worker group (dopt's ``make_worker_mesh``): the
    launched ``torch.distributed`` world, or one rank where none is up
    or ``mesh_devices=1``.  ``mesh_devices`` > 1 must equal the world,
    the world must divide the workers (the message names the rank count
    that fits: dopt would leave the other devices idle) and
    ``mesh_hosts`` must divide the world.  A group of more than one rank
    carries a byte meter."""
    for name, v in (("mesh_devices", mesh_devices),
                    ("mesh_hosts", mesh_hosts)):
        if v is not None and (not isinstance(v, int) or v < 1):
            raise ValueError(f"{name}={v!r} must be a positive int or None")
    ranks = _launched_ranks(mesh_devices, "worker")
    if ranks == 1:
        if mesh_hosts not in (None, 1):
            raise ValueError(
                f"no device count <= 1 folds {num_workers} workers onto "
                f"{mesh_hosts} hosts: mesh_hosts={mesh_hosts} needs a world "
                f"of {mesh_hosts}·k ranks (python -m torch.distributed.run "
                "--nproc-per-node N, or dopt_torch.parallel.init_file_group)")
        return make_worker_group(num_workers)
    if num_workers % ranks:
        raise ValueError(fold_error(num_workers, ranks))
    if mesh_hosts and ranks % mesh_hosts:
        raise ValueError(
            f"no device count <= {ranks} folds {num_workers} workers onto "
            f"{mesh_hosts} hosts: {ranks} ranks do not split into "
            f"{mesh_hosts} hosts")
    return make_worker_group(num_workers, _dist().group.WORLD,
                             hosts=mesh_hosts, meter=collections.Counter())


def shard_worker_tree(tree, group: WorkerGroup):
    """A rank's rows of a whole ``[W, ...]`` host tree (a dict, tuple or
    list, possibly nested, of numpy arrays or tensors, or one leaf; None
    passes): every rank holds the whole array and takes its own rows,
    with no collective (dopt's ``make_array_from_callback``
    placement)."""
    if isinstance(tree, dict):
        return {k: shard_worker_tree(v, group) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(shard_worker_tree(v, group) for v in tree)
    if tree is None or not group.wire:
        return tree
    if tree.shape[0] != group.num_workers:
        raise ValueError(f"worker axis {tree.shape[0]} is not the group's "
                         f"{group.num_workers} workers")
    return group.local(tree)


def gather_workers(tree, group: WorkerGroup, kind: str = "gather"):
    """Every rank's ``[L, ...]`` lanes all-gathered back to the whole
    ``[W, ...]`` in global lane order (a dict, tuple or list of them, or
    one tensor; identity on one rank).  A collective: every rank of the
    group must call it."""
    if isinstance(tree, dict):
        return {k: gather_workers(v, group, kind) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(gather_workers(v, group, kind) for v in tree)
    if tree is None or not group.wire:
        return tree
    from dopt_torch.parallel.collectives import _all_gather

    return _all_gather(tree, group, kind)


def barrier(group: WorkerGroup) -> None:
    """Wait for every rank of the group (no-op on one rank)."""
    if group.wire:
        _dist().barrier(group=group.group)


def init_file_group(init_dir, rank: int, world_size: int, *,
                    backend: str = "gloo", num_workers: int | None = None,
                    name: str = "rendezvous") -> WorkerGroup:
    """Join the default process group through the file ``init_dir/name``
    (``file://`` rendezvous) and return its ``WorkerGroup`` for
    ``num_workers`` (one lane a rank when None).  ``backend`` is the
    caller's choice: "gloo" (the CPU, or ranks sharing one card: CUDA
    payloads are staged through host memory) or "nccl" (one GPU a rank;
    set the rank's device first).  The caller ends it with
    ``torch.distributed.destroy_process_group()``."""
    dist = _dist()
    path = Path(init_dir).resolve() / name
    path.parent.mkdir(parents=True, exist_ok=True)
    dist.init_process_group(backend, init_method=f"file://{path}",
                            rank=rank, world_size=world_size)
    return make_worker_group(world_size if num_workers is None
                             else num_workers, dist.group.WORLD)


def _rank_main(rank: int, fn: Callable, world_size: int, init_dir: str,
               backend: str, num_workers: int | None, args: tuple) -> None:
    dist = _dist()
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
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
    importable from a module the children can load.  With
    ``backend="nccl"`` rank r runs on ``cuda:r``."""
    import torch.multiprocessing as mp

    init_dir = os.fspath(Path(init_dir).resolve())
    mp.spawn(_rank_main, args=(fn, world_size, init_dir, backend,
                               num_workers, args),
             nprocs=world_size, join=True)
