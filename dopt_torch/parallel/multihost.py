"""Launching the port's ranks: the counterpart of
dopt/parallel/multihost.py over ``torch.distributed``.

* ``pick_ephemeral_port``, ``write_handoff``, ``wait_handoff`` and
  ``coordinator_handoff`` are dopt's port-0 coordinator bootstrap:
  process 0 binds port 0 in its own process and publishes ``host:port``
  through an atomic handoff file; every other process waits on the file.
* ``initialize_distributed`` joins the default process group from
  torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR``/``MASTER_PORT``) where dopt reads ``JAX_*``, or from
  explicit arguments, and is a no-op without either.  The backend is
  the caller's: NCCL with one GPU a rank, or gloo (the CPU, or ranks
  that share a card).
* ``bootstrap_child_backend`` is the one fleet-child bootstrap of
  ``python -m dopt_torch.serve``: the handoff rendezvous, then the
  process group over the caller's backend.
* ``make_hybrid_mesh`` is dopt's ``(hosts × ici)`` layout as rank
  coordinates, and ``dcn_edge_count`` its diagnostic, a numpy copy.
"""

from __future__ import annotations

import json
import os
import socket
import time
from pathlib import Path

import numpy as np


def pick_ephemeral_port(host: str = "127.0.0.1") -> int:
    """Bind port 0, read back the kernel's choice, release it."""
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def write_handoff(path: str | Path, address: str) -> None:
    """Publish the coordinator address atomically (tmp + rename): a
    waiter never reads a half-written file."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps({"coordinator": address}))
    os.replace(tmp, path)


def wait_handoff(path: str | Path, *, poll_s: float = 0.05,
                 max_polls: int = 2400) -> str:
    """Poll until the handoff file appears; returns the coordinator
    address.  Bounded by poll count (about two minutes at 50 ms), so an
    orphaned waiter fails loudly instead of hanging."""
    path = Path(path)
    for _ in range(max_polls):
        if path.exists():
            try:
                return str(json.loads(path.read_text())["coordinator"])
            except (ValueError, KeyError):
                pass   # racing the rename of a stale tmp: retry
        time.sleep(poll_s)
    raise TimeoutError(
        f"no coordinator handoff at {path} after {max_polls} polls "
        "(did process 0 die before binding?)")


def coordinator_handoff(path: str | Path, process_id: int, *,
                        host: str = "127.0.0.1", poll_s: float = 0.05,
                        max_polls: int = 2400) -> str:
    """Process 0 picks an ephemeral port and publishes ``host:port``;
    the others wait for it.  Returns the address."""
    if int(process_id) == 0:
        address = f"{host}:{pick_ephemeral_port(host)}"
        write_handoff(path, address)
        return address
    return wait_handoff(path, poll_s=poll_s, max_polls=max_polls)


def launch_env() -> dict | None:
    """torchrun's rank variables (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), or None when the
    process was not started by a launcher."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    return {"rank": int(os.environ["RANK"]),
            "world_size": int(os.environ["WORLD_SIZE"]),
            "local_rank": int(os.environ.get("LOCAL_RANK", 0)),
            "master_addr": os.environ.get("MASTER_ADDR", "127.0.0.1"),
            "master_port": os.environ.get("MASTER_PORT")}


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None, *,
                           backend: str = "gloo") -> bool:
    """Join the default ``torch.distributed`` group over ``backend``.

    Explicit arguments win (``coordinator_address`` is ``host:port``);
    otherwise torchrun's variables are read.  Returns True if the group
    was (or already is) initialized, False when nothing indicates a
    multi-process job (a no-op)."""
    import torch.distributed as dist

    env = launch_env()
    if coordinator_address is None and env is not None:
        port = env["master_port"]
        coordinator_address = (None if port is None
                               else f"{env['master_addr']}:{port}")
    if num_processes is None and env is not None:
        num_processes = env["world_size"]
    if process_id is None and env is not None:
        process_id = env["rank"]
    if coordinator_address is None and num_processes is None:
        return False
    if dist.is_initialized():
        return True
    if coordinator_address is None:
        raise ValueError("a multi-process job needs the coordinator's "
                         "host:port (MASTER_ADDR/MASTER_PORT)")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        rank=int(process_id), world_size=int(num_processes))
    return True


def bootstrap_child_backend(handoff_path: str | Path, process_id: int,
                            num_processes: int, devices_per_proc: int = 1,
                            *, host: str = "127.0.0.1",
                            collectives: str = "gloo") -> str:
    """The one fleet-child bootstrap (dopt's, over ``torch.distributed``):
    rendezvous on the port-0 handoff coordinator, join the default
    process group over ``collectives`` and check the world it joined.
    Returns the coordinator address.

    A port child is one rank on one device, so ``devices_per_proc`` must
    be 1: dopt's virtual CPU devices a process have no counterpart on a
    card, and more ranks come from more processes.  ``collectives`` is
    the caller's: "gloo" (the CPU, or children that share one card,
    staged through host memory) or "nccl" (a card each: child i runs on
    ``cuda:i``); nothing switches it."""
    import torch.distributed as dist

    if int(devices_per_proc) != 1:
        raise ValueError(
            f"devices_per_proc={devices_per_proc}: a port fleet process "
            "is one torch.distributed rank on one device, so it takes "
            "devices_per_proc=1; for "
            f"{int(num_processes) * int(devices_per_proc)} ranks run "
            f"num_processes={int(num_processes) * int(devices_per_proc)}")
    if collectives not in ("gloo", "nccl"):
        raise ValueError(f"collectives={collectives!r}: one of gloo|nccl")
    if collectives == "nccl":
        import torch

        if int(process_id) >= torch.cuda.device_count():
            raise ValueError(
                f"process {process_id} has no GPU of its own "
                f"({torch.cuda.device_count()} visible): NCCL runs one "
                "process a GPU; processes that share a card take "
                "collectives='gloo'")
        torch.cuda.set_device(int(process_id))
    address = coordinator_handoff(handoff_path, process_id, host=host)
    if not initialize_distributed(address, num_processes, process_id,
                                  backend=collectives):
        raise RuntimeError(
            "initialize_distributed returned False with explicit args")
    if dist.get_world_size() != int(num_processes):
        raise RuntimeError(
            f"expected {num_processes} processes, the group has "
            f"{dist.get_world_size()}")
    return address


def make_hybrid_mesh(num_hosts: int, size: int) -> np.ndarray:
    """dopt's ``(hosts × ici)`` grid as rank ids: row h holds host h's
    ranks, so the contiguous worker fold keeps neighbouring workers on
    one host (``[num_hosts, size // num_hosts]`` int array)."""
    if num_hosts < 1 or size % num_hosts:
        raise ValueError(f"{size} devices not divisible into {num_hosts} "
                         "hosts")
    return np.arange(size).reshape(num_hosts, size // num_hosts)


def dcn_edge_count(w_matrix: np.ndarray, num_hosts: int) -> int:
    """How many nonzero mixing-matrix edges cross a host boundary under
    the contiguous worker→host fold (a ring over H hosts: 2·H·(H>1))."""
    n = w_matrix.shape[0]
    if n % num_hosts:
        raise ValueError(f"{n} workers not divisible into {num_hosts} hosts")
    per = n // num_hosts
    host_of = np.arange(n) // per
    i, j = np.nonzero(w_matrix)
    return int(np.sum(host_of[i] != host_of[j]))
