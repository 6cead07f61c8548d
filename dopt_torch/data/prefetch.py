"""Prefetched host staging: build the next block's inputs while the
current block runs on the device.

The port's copy of ``dopt.data.prefetch``.  A blocked run's host work —
the batch plans of k rounds, their ``np.stack`` and their upload — is
stateless in ``(seed, round)``, so block b+1's payload can be built and
staged while block b's rounds replay.  The engines' loops then run
dispatch → stage-next → fetch instead of build → dispatch → fetch.

The ordering contract that keeps prefetch-on runs bit-identical to
prefetch-off (History, client rows, the sampling stream):

* **draw vs build.**  Each block's staging splits into a cheap, possibly
  stateful *draw* (the federated client-sampling stream, the mixing
  matrices) and an expensive, *pure* build (``make_batch_plan`` over the
  drawn keys, ``np.stack``, the upload).  Draws run on the caller's
  thread, in block order — the sequence positions the unprefetched loop
  consumes them at — so stateful streams advance identically.  Only the
  pure build runs on the background thread.
* **no staging across a commit point.**  Nothing is staged past the end
  of a ``run`` call or past a scheduled checkpoint round
  (``run_blocked``'s ``checkpoint_every``, as dopt's ``_blocked_loop``):
  what a trainer holds between calls, and what a checkpoint writes,
  reflects exactly the committed rounds — the block after a checkpoint
  is drawn and built inline from the committed state.

The queue is bounded at depth 2: the block being consumed plus at most
one staged successor.  ``take()`` of an unstaged key returns None and
the caller builds inline (the first block of every run), which is the
unprefetched code path.

``upload`` is the build's last step on either path: on CUDA it copies
the host arrays from pinned memory with ``non_blocking=True`` on a side
stream and records an event; ``ready`` makes the consumer's stream wait
on that event before it reads the tensors.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch


def timed_build(build, timers):
    """Wrap a pure block ``build`` so its runtime adds to ``timers``'
    ``host_batch_plan`` totals from the stager's background thread
    (dopt's ``timed_build``: the ``PhaseTimers`` spans are not for
    concurrent use across threads, so the totals are added directly)."""

    def wrapped(meta):
        t0 = time.perf_counter()  # dopt: allow-wallclock -- span timing only, never training math
        out = build(meta)
        timers.totals["host_batch_plan"] += time.perf_counter() - t0  # dopt: allow-wallclock -- span timing only, never training math
        timers.counts["host_batch_plan"] += 1
        return out

    return wrapped


class _Staged:
    """One in-flight background build (a bare thread per block: builds
    are long relative to thread spawn, and a pool would outlive the
    trainer)."""

    __slots__ = ("_out", "_err", "_thread")

    def __init__(self, build, meta):
        self._out = None
        self._err: BaseException | None = None
        self._thread = threading.Thread(
            target=self._run, args=(build, meta),
            name="dopt-torch-prefetch", daemon=True)
        self._thread.start()

    def _run(self, build, meta) -> None:
        try:
            self._out = build(meta)
        except BaseException as e:  # surfaced at take()
            self._err = e

    def wait(self):
        self._thread.join()
        if self._err is not None:
            raise self._err
        out, self._out = self._out, None
        return out

    def wait_quiet(self) -> None:
        """Join and drop the result (the discard path): a failed
        discarded build is not an error, its payload was never used."""
        self._thread.join()
        self._out = self._err = None


class PrefetchStager:
    """Bounded background staging queue for the blocked run loops.

    ``stage(key, build, meta)`` starts ``build(meta)`` on a background
    thread; ``take(key)`` joins and returns its payload, or ``None``
    when nothing was staged under that key (the caller builds inline).
    ``build`` MUST be pure — every stateful draw belongs in the
    caller-side code that produced ``meta`` (see the module docstring).
    """

    def __init__(self, *, depth: int = 2):
        if depth < 2:
            raise ValueError(f"PrefetchStager depth={depth} must be >= 2 "
                             "(the consumed block plus one staged)")
        self.depth = int(depth)
        self._pending: dict = {}

    def __len__(self) -> int:
        return len(self._pending)

    def stage(self, key, build, meta) -> None:
        """Begin building ``key``'s payload in the background."""
        if key in self._pending:
            raise RuntimeError(f"block {key!r} is already staged")
        if len(self._pending) >= self.depth - 1:
            raise RuntimeError(
                f"staging queue full ({len(self._pending)} pending, "
                f"depth {self.depth}): take() the oldest block first")
        self._pending[key] = _Staged(build, meta)

    def take(self, key):
        """The staged payload for ``key`` (blocking on its build), or
        ``None`` when it was never staged.  Any *other* pending keys are
        discarded: a key miss means the run's cursor moved, and stale
        payloads must not leak into later takes."""
        staged = self._pending.pop(key, None)
        if self._pending:
            self.discard()
        if staged is None:
            return None
        return staged.wait()

    def discard(self) -> None:
        """Drop every pending payload (loop teardown).  Joins the
        background builds first so no thread outlives the state it
        captured."""
        pending, self._pending = self._pending, {}
        for staged in pending.values():
            staged.wait_quiet()


def upload(arrays: dict[str, np.ndarray], device: torch.device
           ) -> tuple[dict[str, torch.Tensor], torch.cuda.Event | None]:
    """Host arrays → device tensors, and the event the consumer waits on
    (None on the CPU, where the tensors share the arrays' memory).  On
    CUDA each array goes through pinned memory and ``non_blocking=True``
    onto a side stream, so the copy overlaps whatever the device runs."""
    if device.type != "cuda":
        return {k: torch.from_numpy(v) for k, v in arrays.items()}, None
    stream = torch.cuda.Stream(device)
    with torch.cuda.stream(stream):
        out = {k: torch.from_numpy(v).pin_memory().to(device,
                                                     non_blocking=True)
               for k, v in arrays.items()}
        event = torch.cuda.Event()
        event.record(stream)
    return out, event


def ready(tensors: dict[str, torch.Tensor],
          event: torch.cuda.Event | None) -> dict[str, torch.Tensor]:
    """Order the current stream after ``upload``'s copies and tell the
    allocator the tensors are used there; returns ``tensors``."""
    if event is not None:
        stream = torch.cuda.current_stream(
            next(iter(tensors.values())).device)
        stream.wait_event(event)
        for t in tensors.values():
            t.record_stream(stream)
    return tensors
