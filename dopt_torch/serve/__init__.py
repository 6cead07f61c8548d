"""dopt_torch.serve — the resident elastic trainer with a live control
plane: the port's copy of dopt's ``dopt.serve``.

One long-lived elastic run instead of N scripted rounds.
``python -m dopt_torch.serve --preset baseline1 --state-dir run/`` owns a
training loop until told otherwise, and everything that happens to it
mid-flight — membership join/leave, whitelisted config changes,
checkpoints, admission pauses, drains — arrives through a versioned
command queue, applies at a round boundary, and is ledgered (fault-ledger
``control`` rows and the deterministic ``control`` telemetry kind), so a
served run stays a pure function of (base config, applied-command
ledger): interruptible, resumable, and bit-reproducible.

Layers (one module each):

* ``dopt_torch.serve.control`` — command schema, append-only JSONL
  queue, applied-command ledger (the replay source), config whitelist;
* ``dopt_torch.serve.daemon``  — ``ServeDaemon``: the round-boundary
  controller behind the engines' ``run_served`` entry, streaming
  checkpoints, the in-process ``HealthMonitor`` (alerts feed back:
  drop_rate-critical auto-pauses admission), SIGTERM → drain →
  checkpoint → re-exec → bit-exact resume, and the leader/follower
  directive barrier for multi-process fleets;
* ``dopt_torch.serve.admin``   — the stdlib HTTP surface: ``/admin/*``
  command endpoints plus the in-process ``/metrics`` and ``/healthz``;
* ``dopt_torch.serve.__main__`` — the CLI: single-process daemon,
  self-re-exec on SIGTERM, the SPMD fleet supervisor (one
  ``torch.distributed`` rank a process) and the decoupled fleet.

The served trainers run on CUDA unless the caller names the CPU
(``--device cpu``, ``device="cpu"``).
"""

from __future__ import annotations

from dopt_torch.serve.control import (COMMANDS, CONFIG_WHITELIST,
                                      CommandQueue, ControlLedger,
                                      make_command, validate_command)
from dopt_torch.serve.daemon import (EX_RESTART, ServeDaemon,
                                     build_serve_trainer, serve_rules)

__all__ = [
    "COMMANDS", "CONFIG_WHITELIST", "CommandQueue", "ControlLedger",
    "EX_RESTART", "ServeDaemon", "build_serve_trainer", "make_command",
    "serve_rules", "validate_command",
]
