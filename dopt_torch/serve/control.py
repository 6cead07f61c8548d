"""Control plane for the resident trainer (``python -m dopt_torch.serve``),
the port's copy of dopt's ``dopt.serve.control``.

A served run is driven by three small, file-backed pieces:

* **Command queue** (``<state>/commands.jsonl``) — the append-only
  inbound channel.  One versioned JSON command per line; the admin
  endpoint appends here, scripts can pre-seed it, and the daemon
  ingests new complete lines at every round boundary (byte-offset
  tail, so a million-round run never re-parses the file).
* **Applied ledger** (``<state>/applied.jsonl``) — the durable record
  of what the daemon DID with each command: ``status`` applied or
  rejected, the boundary ``round`` it took effect, and the full
  command payload.  This is the replay source: a restarted daemon
  reconstructs its effective config, membership overlay and admission
  state by replaying this file, which is what makes a served run
  resumable AND bit-reproducible — the run is a pure function of
  (base config, applied ledger).
* **Ledgered control rows** — every applied command also lands in the
  trainer's fault ledger (``kind="control"``) and the telemetry stream
  (the deterministic ``control`` event kind), at the boundary round,
  so the run's own artifacts carry the replay script.

Command schema (v1), one object per line::

    {"v": 1, "cmd": "config",     "key": "optim.lr", "value": 0.05,
     "at_round": 12, "id": "lr-decay"}
    {"v": 1, "cmd": "membership", "worker": 3, "action": "leave"}
    {"v": 1, "cmd": "checkpoint"}
    {"v": 1, "cmd": "drain", "restart": false}
    {"v": 1, "cmd": "pause"}   /   {"v": 1, "cmd": "resume"}

``at_round`` pins the FIRST eligible boundary (the command applies at
the first boundary whose round is >= at_round); without it the command
applies at the next boundary after ingestion.  ``id`` defaults to the
queue position (``q<N>``), so re-scans after a restart recognise
already-processed commands.

Config changes are WHITELISTED: only keys whose mid-run mutation has
well-defined checkpoint/rebuild/restore semantics are accepted —
everything else is rejected (recorded, never ledgered).  Membership
commands ride ``dopt_torch.faults.MembershipLog`` → the existing churn /
shard-reassignment machinery.

Stdlib-only (no torch): the control plane must be drivable from any
operator laptop.
"""

from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path
from typing import Any, Iterable

COMMAND_VERSION = 1


def _terminate_torn_tail(f) -> None:
    """Append-side hygiene for the control-plane JSONL files: if a
    hard-killed writer left the file without a trailing newline,
    terminate the torn line BEFORE appending — gluing a new record
    onto partial bytes would merge them into one malformed line and
    silently lose the new record.  The terminated torn line itself is
    handled downstream (queue poll → reject record; ledger replay →
    skipped, so its command reprocesses from the queue)."""
    f.seek(0, os.SEEK_END)
    if f.tell() == 0:
        return
    f.seek(f.tell() - 1)
    if f.read(1) != "\n":
        f.write("\n")

COMMANDS = ("config", "membership", "checkpoint", "drain", "pause",
            "resume")

# The whitelisted mid-run config surface.  "optim.lr" and
# "population.cohort" apply via checkpoint → rebuild → restore (the
# trainer is reconstructed under the new config and restored from the
# boundary checkpoint — the same bit-exact path a kill-and-resume
# takes); "checkpoint_every" is daemon-level state (the streaming
# checkpoint cadence) and applies in place.
CONFIG_WHITELIST = {
    "optim.lr": float,
    "population.cohort": int,
    "checkpoint_every": int,
}

MEMBERSHIP_ACTIONS = ("join", "leave")


def make_command(cmd: str, **fields: Any) -> dict[str, Any]:
    """Build one schema-stamped command (None fields dropped)."""
    obj: dict[str, Any] = {"v": COMMAND_VERSION, "cmd": cmd}
    obj.update({k: v for k, v in fields.items() if v is not None})
    return validate_command(obj)


def _fail(msg: str, obj: Any) -> None:
    raise ValueError(f"{msg}: {obj!r}")


def validate_command(obj: Any) -> dict[str, Any]:
    """Validate one command against the v1 schema; returns it, raises
    ``ValueError`` otherwise.  Whitelist membership of config keys is
    checked here too — a bad key fails at submission time with a clean
    message instead of at the boundary."""
    if not isinstance(obj, dict):
        _fail("command is not an object", obj)
    if obj.get("v") != COMMAND_VERSION:
        _fail(f"unknown command version (want v={COMMAND_VERSION})", obj)
    cmd = obj.get("cmd")
    if cmd not in COMMANDS:
        _fail(f"unknown command (want one of {COMMANDS})", obj)
    if "id" in obj and (not isinstance(obj["id"], str) or not obj["id"]):
        _fail("command id must be a non-empty string", obj)
    if "at_round" in obj:
        r = obj["at_round"]
        if not isinstance(r, int) or isinstance(r, bool) or r < 0:
            _fail("at_round must be an int >= 0", obj)
    if "ts" in obj:
        # The enqueue wall-clock stamp (CommandQueue.submit adds it):
        # the start point of the command_apply SLO latency.  Advisory
        # metadata, never replay data.
        t = obj["ts"]
        if isinstance(t, bool) or not isinstance(t, (int, float)) \
                or t < 0:
            _fail("ts must be a number >= 0", obj)
    if cmd == "config":
        key = obj.get("key")
        if key not in CONFIG_WHITELIST:
            _fail(f"config key not whitelisted (serve accepts "
                  f"{sorted(CONFIG_WHITELIST)})", obj)
        v = obj.get("value")
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            _fail("config value must be numeric", obj)
        if CONFIG_WHITELIST[key] is int and int(v) != v:
            _fail(f"config key {key!r} takes an integer", obj)
        if key == "checkpoint_every" and int(v) < 0:
            _fail("checkpoint_every must be >= 0 (0 disables the "
                  "cadence)", obj)
        if key == "optim.lr" and not float(v) > 0:
            _fail("optim.lr must be > 0", obj)
        if key == "population.cohort" and int(v) < 1:
            _fail("population.cohort must be >= 1", obj)
    elif cmd == "membership":
        w = obj.get("worker")
        if not isinstance(w, int) or isinstance(w, bool) or w < 0:
            _fail("membership command needs int worker >= 0", obj)
        if obj.get("action") not in MEMBERSHIP_ACTIONS:
            _fail(f"membership action must be one of "
                  f"{MEMBERSHIP_ACTIONS}", obj)
    elif cmd == "drain":
        if "restart" in obj and not isinstance(obj["restart"], bool):
            _fail("drain restart must be a bool", obj)
    return obj


class CommandQueue:
    """Append-only JSONL inbound queue with an incremental tail.

    ``submit`` appends one validated command (thread-safe within the
    process; whole-line ``O_APPEND`` writes keep concurrent external
    writers line-atomic).  ``poll`` returns the complete lines appended
    since the last poll as ``(commands, rejects)`` — a malformed line
    becomes a reject record instead of desynchronizing the daemon (the
    queue is operator input, not trusted telemetry).  ``ids`` are
    assigned from the queue position (``q<N>``) when absent, so a
    restarted daemon re-scanning from offset 0 derives the same ids."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.offset = 0
        self._lines_seen = 0
        self._lock = threading.Lock()

    def submit(self, command: dict[str, Any]) -> dict[str, Any]:
        command = validate_command(dict(command))
        # Enqueue stamp for the command_apply SLO latency (enqueue ts →
        # applied ts); pre-stamped commands (a replayed script) keep
        # their own.
        command.setdefault("ts", round(time.time(), 6))  # dopt: allow-wallclock -- command_apply SLO latency enqueue stamp, advisory metadata
        with self._lock:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            with open(self.path, "a+", encoding="utf-8") as f:
                # flock makes the count-assign-append atomic ACROSS
                # processes too (the admin endpoint and an external
                # pre-seeding script share this file): two writers must
                # never mint the same queue-position id — the applied
                # ledger's last-record-per-id replay would silently
                # drop one command's effect on resume.
                import fcntl

                fcntl.flock(f.fileno(), fcntl.LOCK_EX)
                try:
                    _terminate_torn_tail(f)
                    if "id" not in command:
                        f.seek(0)
                        n = sum(1 for _ in f)
                        command["id"] = f"q{n + 1}"
                    f.seek(0, os.SEEK_END)
                    f.write(json.dumps(command, sort_keys=True) + "\n")
                    f.flush()
                    os.fsync(f.fileno())
                finally:
                    fcntl.flock(f.fileno(), fcntl.LOCK_UN)
        return command

    def poll(self) -> tuple[list[dict[str, Any]], list[dict[str, Any]]]:
        if not self.path.exists():
            return [], []
        with self._lock, open(self.path, "rb") as f:
            f.seek(0, 2)
            size = f.tell()
            if size < self.offset:
                self.offset = size   # truncated externally: clamp
            f.seek(self.offset)
            chunk = f.read()
        if not chunk:
            return [], []
        end = chunk.rfind(b"\n")
        if end < 0:
            return [], []
        commands: list[dict[str, Any]] = []
        rejects: list[dict[str, Any]] = []
        for raw in chunk[:end + 1].splitlines():
            raw = raw.strip()
            if not raw:
                continue
            self._lines_seen += 1
            qid = f"q{self._lines_seen}"
            try:
                obj = json.loads(raw)
            except ValueError:
                rejects.append({"id": qid, "cmd": None,
                                "reason": f"not JSON: {raw[:80]!r}"})
                continue
            try:
                obj = validate_command(obj)
            except ValueError as e:
                rejects.append({"id": (obj.get("id") if isinstance(obj, dict)
                                       else None) or qid,
                                "cmd": (obj.get("cmd") if isinstance(obj, dict)
                                        else None),
                                "reason": str(e)})
                continue
            obj.setdefault("id", qid)
            commands.append(obj)
        self.offset += end + 1
        return commands, rejects


class ControlLedger:
    """The applied-command ledger (``applied.jsonl``): one line-flushed
    record per terminal command decision.  ``replay`` returns the
    records in order — with the LAST record per command id winning, so
    a re-applied command (a crash between apply and checkpoint)
    supersedes its stale first record."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._fh = None

    def append(self, record: dict[str, Any]) -> dict[str, Any]:
        if self._fh is None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.path, "a+", encoding="utf-8")
            # A hard kill mid-append can leave a torn final line;
            # terminate it so the records this process writes stay
            # parseable (replay skips the torn one and the queue
            # re-supplies its command).
            _terminate_torn_tail(self._fh)
        self._fh.write(json.dumps(record, sort_keys=True) + "\n")
        self._fh.flush()
        os.fsync(self._fh.fileno())
        return record

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    @classmethod
    def replay(cls, path: str | Path) -> list[dict[str, Any]]:
        path = Path(path)
        if not path.exists():
            return []
        by_id: dict[str, dict[str, Any]] = {}
        order: list[str] = []
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    # A torn record from a hard kill (terminated by the
                    # next writer): SKIP it — its effect died with the
                    # writer's memory and the command, still absent
                    # from the processed set, reprocesses from the
                    # queue.  Breaking here would also discard every
                    # later (valid) record.
                    continue
                rid = str(rec.get("id"))
                if rid not in by_id:
                    order.append(rid)
                by_id[rid] = rec
        return [by_id[rid] for rid in order]


def applied_record(command: dict[str, Any], *, status: str, round_idx: int,
                   reason: str | None = None,
                   auto: bool = False) -> dict[str, Any]:
    rec = dict(command)
    rec["status"] = status
    rec["round"] = int(round_idx)
    if reason:
        rec["reason"] = reason
    if auto:
        rec["auto"] = True
    return rec


def apply_config_change(cfg, key: str, value) -> Any:
    """Return ``cfg`` with the whitelisted dotted ``key`` replaced —
    the same coercion/validation path as the CLI's ``--set`` (so the
    control plane cannot set anything the CLI could not)."""
    if key not in CONFIG_WHITELIST:
        raise ValueError(f"config key {key!r} not whitelisted "
                         f"(serve accepts {sorted(CONFIG_WHITELIST)})")
    from dopt_torch.run import apply_override

    want = CONFIG_WHITELIST[key]
    rendered = repr(want(value)) if want is float else str(int(value))
    return apply_override(cfg, f"{key}={rendered}")


def control_ledger_row(command: dict[str, Any],
                       round_idx: int) -> dict[str, Any]:
    """The fault-ledger row for one APPLIED command: worker is the
    membership target (fleet-level commands use -1), the action string
    encodes the payload — together with the base config this makes the
    ledger a complete replay script for the served run."""
    cmd = command["cmd"]
    worker = -1
    if cmd == "config":
        action = (f"applied_config_{command['key']}="
                  f"{command['value']}")
    elif cmd == "membership":
        worker = int(command["worker"])
        action = f"applied_membership_{command['action']}"
    elif cmd == "drain":
        action = ("applied_drain_restart" if command.get("restart")
                  else "applied_drain")
    else:
        action = f"applied_{cmd}"
    return {"round": int(round_idx), "worker": worker, "kind": "control",
            "action": action}


def control_event_fields(command: dict[str, Any], round_idx: int, *,
                         auto: bool = False) -> dict[str, Any]:
    """The telemetry ``control`` event payload for one applied
    command (None fields are dropped by ``make_event``)."""
    return {
        "round": int(round_idx),
        "cmd": str(command["cmd"]),
        "id": command.get("id"),
        "key": command.get("key"),
        "value": command.get("value"),
        "worker": command.get("worker"),
        "action": command.get("action"),
        "auto": True if auto else None,
    }


def replay_effects(records: Iterable[dict[str, Any]], *,
                   up_to_round: int) -> dict[str, Any]:
    """Fold the applied ledger into the daemon's resumable state:
    config overrides (in order), membership directives, the cadence
    override, admission-pause state, and the set of terminally
    processed command ids.  Records with ``round > up_to_round`` were
    applied at a boundary the checkpoint never reached (a hard kill
    between apply and save): they are EXCLUDED — the daemon re-ingests
    them from the queue and re-applies at the next boundary."""
    out: dict[str, Any] = {"config": [], "membership": [],
                           "checkpoint_every": None, "paused": False,
                           "processed": set(), "drained": False}
    for rec in records:
        if rec.get("status") == "rejected":
            out["processed"].add(str(rec.get("id")))
            continue
        if rec.get("status") != "applied":
            continue
        r = int(rec.get("round", 0))
        if r > up_to_round:
            continue
        out["processed"].add(str(rec.get("id")))
        cmd = rec.get("cmd")
        if cmd == "config":
            if rec["key"] == "checkpoint_every":
                out["checkpoint_every"] = int(rec["value"])
            else:
                out["config"].append((r, rec["key"], rec["value"]))
        elif cmd == "membership":
            out["membership"].append(
                (r, int(rec["worker"]), rec["action"] == "join"))
        elif cmd == "pause":
            out["paused"] = True
        elif cmd == "resume":
            out["paused"] = False
        elif cmd == "drain":
            out["drained"] = True
    # Ledger order is first-seen COMMAND order, but a crash-window
    # re-apply can move a command's effective round PAST a later
    # command's (its superseding record keeps its original position):
    # MembershipLog.add requires nondecreasing rounds, so sort by
    # round (stable — same-round directives keep ledger order).
    out["membership"].sort(key=lambda e: e[0])
    return out
