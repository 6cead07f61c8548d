"""Multi-round blocks: the round body replayed from CUDA graphs.

The counterpart of dopt's jitted ``lax.scan`` block program
(dopt/engine/gossip.py:1322-1470, dopt/engine/federated.py:1217-1265).
dopt traces the round once and scans it over a block's stacked inputs
with no host round trip inside the block; the port captures the round
body once per kind of round as a CUDA graph and replays it once a round.

``RoundGraphs`` owns:

* the **static input buffers** of one round (the engine names them: the
  mixing matrix, the plan's ``idx`` and ``bw``, the federated mask and
  selection).  A graph reads the addresses it saw at capture, so each
  round's slice of the block's staged inputs is copied into them (device
  to device) before its replay;
* the **static output slot**, the round's packed metric vector, which
  the body writes and ``run_block`` copies into a ``[k, M]`` device
  buffer after each round — one device→host fetch a block;
* one **graph per kind** of round (gossip: eval and no-eval, chosen on
  the host), all captured into one memory pool;
* the **warm-up**: the first round of each kind runs the body eagerly on
  a side stream, and the capture follows at once.  That round is a real
  round of the run, not a rehearsal; it also makes the kernels'
  first-use ``nvcc`` build, cuDNN's plans and cuBLAS's handle happen
  before the capture.  Every later round of the kind is a replay.

The body must keep every carried state in place (no rebinding of a
Python name to a new tensor, no host sync, no host→device copy): a graph
bakes in the addresses and the Python constants the body read at
capture — the optimizer constants of ``cfg.optim`` among them.  The
kernels' launch counters are Python increments, so a capture's
increments move to the graph and come back at every replay
(``dopt_torch.ops.fused_update.add_launch_counts``).

On the CPU the same object runs the body eagerly on the same static
buffers, so the CPU tests hold the staging, the order and the metric
packing even though nothing is captured there.  Across ranks
(``eager=True``: a trainer whose worker group has a wire) the card
runs the body eagerly too, bit for bit with the per-round run: a
captured graph cannot hold a collective staged through host memory
(gloo), and capture over NCCL waits for a later slice.  On CUDA a
capture error is an error: there is no eager fallback.

``run_blocked`` is both engines' block loop (after dopt's
``_blocked_loop``, dopt/engine/gossip.py:1755-1874 and
dopt/engine/federated.py:2158-2247), with its checkpoints at block
boundaries.  A restore writes every carried tensor in place, so a
trainer's captured graphs replay correctly after it.
"""

from __future__ import annotations

import ctypes
import inspect
import time
import weakref
from typing import Callable, Hashable

import torch

from dopt_torch.data.prefetch import PrefetchStager, ready
from dopt_torch.ops.fused_update import add_launch_counts, launch_counts


def graph_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """The node count of a graph captured with ``keep_graph=True``
    (the driver's ``cuGraphGetNodes``)."""
    cuda = ctypes.CDLL("libcuda.so.1")
    cuda.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_size_t)]
    cuda.cuGraphGetNodes.restype = ctypes.c_int
    count = ctypes.c_size_t(0)
    code = cuda.cuGraphGetNodes(graph.raw_cuda_graph(), None,
                                ctypes.byref(count))
    if code != 0:
        raise RuntimeError(f"cuGraphGetNodes failed with CUresult {code}")
    return count.value


class RoundGraphs:
    """A round body over static buffers, eager on the CPU, captured and
    replayed on CUDA.  ``body(statics, kind)`` runs one round reading
    its inputs from ``statics`` and writing its metrics into ``slot``;
    the static buffers are allocated by the first block, one round's
    slice of each of its inputs.
    ``captures`` holds, per kind, the capture and instantiate times in
    seconds and the graph's node count.  A bound-method body is held
    weakly: the trainer owns its ``RoundGraphs``, and a cycle back to
    it would keep a finished trainer's state and graph pool on the
    device until the garbage collector ran."""

    def __init__(self, body: Callable[[dict, Hashable], None],
                 slot: torch.Tensor, *, eager: bool = False):
        self._body = (weakref.WeakMethod(body) if inspect.ismethod(body)
                      else lambda: body)
        self.statics: dict[str, torch.Tensor] | None = None
        self.slot = slot
        self.device = slot.device
        self.eager = eager
        self.captures: dict[Hashable, dict[str, float]] = {}
        self._graphs: dict[Hashable, tuple] = {}
        self._pool = None

    def run_block(self, inputs: dict[str, torch.Tensor],
                  kinds: list) -> torch.Tensor:
        """Run ``len(kinds)`` rounds, round j reading slice j of each
        ``[k, ...]`` tensor of ``inputs``; returns the rounds' metric
        vectors as a ``[k, M]`` device tensor (nothing is fetched)."""
        if self.statics is None:
            self.statics = {n: torch.zeros_like(v[0])
                            for n, v in inputs.items()}
        out = torch.empty(len(kinds), self.slot.numel(), device=self.device)
        for j, kind in enumerate(kinds):
            for name, src in inputs.items():
                self.statics[name].copy_(src[j])
            self._round(kind)
            out[j].copy_(self.slot)
        return out

    def body(self, statics: dict, kind: Hashable) -> None:
        self._body()(statics, kind)

    def _round(self, kind: Hashable) -> None:
        if self.device.type != "cuda" or self.eager:
            self.body(self.statics, kind)
            return
        entry = self._graphs.get(kind)
        if entry is None:
            self._warm_up(kind)
            self._capture(kind)
            return
        graph, delta = entry
        graph.replay()
        add_launch_counts(delta)

    def _warm_up(self, kind: Hashable) -> None:
        """The kind's first round, eagerly, on a side stream."""
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self.body(self.statics, kind)
        current.wait_stream(side)

    def _capture(self, kind: Hashable) -> None:
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        before = launch_counts()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        t0 = time.perf_counter()  # dopt: allow-wallclock -- capture and instantiate wall meter (captures), reporting only
        with torch.cuda.graph(graph, pool=self._pool):
            self.body(self.statics, kind)
        t1 = time.perf_counter()  # dopt: allow-wallclock -- capture and instantiate wall meter (captures), reporting only
        graph.instantiate()
        torch.cuda.synchronize(self.device)
        t2 = time.perf_counter()  # dopt: allow-wallclock -- capture and instantiate wall meter (captures), reporting only
        after = launch_counts()
        delta = {k: after[k] - before[k] for k in after}
        add_launch_counts({k: -v for k, v in delta.items()})
        self._graphs[kind] = (graph, delta)
        self.captures[kind] = {"capture_s": t1 - t0,
                               "instantiate_s": t2 - t1,
                               "nodes": graph_nodes(graph)}


def run_blocked(trainer, rounds: int, block: int, *, prefetch: bool,
                checkpoint_every: int = 0, checkpoint_path=None) -> None:
    """Run ``rounds`` rounds of ``trainer`` in blocks of up to ``block``:
    stage a block (``trainer._draw_block(ts)`` on this thread, in block
    order; ``trainer._build_block(meta)``, pure, which uploads
    ``meta["dev"]``; the draw or the build sets ``meta["kinds"]``), call
    ``trainer._block_start()`` where the trainer has one (the federated
    engine loads its host mirrors into its device counters there), run
    the block's rounds through ``trainer.graphs`` with the kinds
    ``meta["kinds"]``, make ONE device→host fetch, and hand the
    ``[k, M]`` metrics to ``trainer._record_block(meta, vals)``, which
    writes the rows (and the telemetry) in round order and advances
    ``trainer.round``.  ``trainer.timers`` times the staging
    (``host_batch_plan``) and the block up to its fetch
    (``round_step``).  With
    ``prefetch`` the loop runs dispatch → stage-next → fetch: the next
    block is drawn here and built on the stager's thread while this
    block's rounds run.

    ``checkpoint_every=K`` saves (``trainer.save(checkpoint_path)``) at
    the first block boundary at or past each multiple of K, as dopt's
    ``_blocked_loop`` does.  Nothing is staged past the end of the call
    or across a scheduled save: the federated draw advances the
    client-sampling stream, and a draw made ahead of a save would write
    a stream one block ahead of the committed rounds."""
    next_ckpt = ((trainer.round // checkpoint_every + 1) * checkpoint_every
                 if checkpoint_every else None)
    start = getattr(trainer, "_block_start", None)
    timers = trainer.timers
    stager = PrefetchStager() if prefetch else None
    try:
        done = 0
        while done < rounds:
            k = min(block, rounds - done)
            ts = [trainer.round + j for j in range(k)]
            meta = stager.take(ts[0]) if stager is not None else None
            if meta is None:
                with timers.phase("host_batch_plan"):
                    meta = trainer._build_block(trainer._draw_block(ts))
            if start is not None:
                start()
            with timers.phase("round_step"):
                out = trainer.graphs.run_block(ready(*meta["dev"]),
                                               meta["kinds"])
                left = rounds - done - k
                end = ts[-1] + 1
                if (stager is not None and left
                        and (next_ckpt is None or end < next_ckpt)):
                    nts = [end + j for j in range(min(block, left))]
                    with timers.phase("host_batch_plan"):
                        drawn = trainer._draw_block(nts)
                    stager.stage(nts[0], trainer._build_block, drawn)
                vals = out.cpu().numpy()
            trainer._record_block(meta, vals)
            done += k
            if next_ckpt is not None and trainer.round >= next_ckpt:
                trainer.save(checkpoint_path)
                next_ckpt = ((trainer.round // checkpoint_every + 1)
                             * checkpoint_every)
    finally:
        if stager is not None:
            stager.discard()
