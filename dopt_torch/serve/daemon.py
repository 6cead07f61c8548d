"""The resident trainer daemon (``python -m dopt_torch.serve``): the
port's copy of dopt's ``dopt.serve.daemon``.

``ServeDaemon`` owns a training loop indefinitely instead of for
``--rounds N``: the engines' ``run_served`` entry calls back into
``boundary()`` before every round, where the daemon

1. **ingests** new control-plane commands (``dopt_torch.serve.control``) and
   applies the due ones — membership join/leave through the
   ``MembershipLog`` → churn/shard-reassignment machinery, whitelisted
   config changes through checkpoint → rebuild → restore, cadence /
   pause / drain in place — each application ledgered as a
   ``control`` fault-ledger row AND a deterministic ``control``
   telemetry event at the boundary round;
2. **checkpoints** on a round cadence (and at every boundary that
   applied a command, so the applied ledger never gets ahead of the
   training state) through the existing atomic size-manifest format;
3. **watches itself**: the ``HealthMonitor`` rides the telemetry
   fan-out IN-PROCESS (no file tailing), its state checkpointed next
   to the trainer so a restarted daemon resumes the rule windows
   mid-stream, and a ``drop_rate``-critical alert auto-pauses
   admission (join commands are rejected until a ``resume``);
4. **survives restarts**: SIGTERM → drain to the boundary →
   checkpoint → hand back for re-exec → bit-exact resume.  The run is
   a pure function of (base config, applied-command ledger), so an
   interrupted-and-resumed serve produces History, fault ledger and
   canonical telemetry identical to an uninterrupted one.

Multi-process fleets (one ``torch.distributed`` rank a process: gloo
when the processes share a card or run on the CPU, NCCL with a card
each; the caller names the backend) run one daemon per process:
process 0 is the **leader** (owns the queue, telemetry, admin
endpoint, checkpoint writes), followers replay the leader's published
per-boundary directive so every process applies the same commands at
the same round — the coordinator-led config/epoch barrier.  Fleet
checkpoints cross-process-allgather the sharded state (a collective
every process joins) with a single writer.  A SIGTERM to ANY process
requests a rolling restart: the fleet quiesces at the next boundary,
checkpoints once, every process re-execs, and training resumes
bit-exactly on a fresh coordinator — SPMD collectives make per-host
independence cooperative, so "one host at a time" means the run
survives each host's restart in turn, not that collectives proceed
through it.

**Decoupled fleets** (``--decoupled``) kill that round barrier: each
process is an independent single-host daemon (its own state subdir,
queue, ledger, checkpoints — its own leader), and NO collective spans
processes, so a departing peer cannot quiesce anyone.  Liveness rides
per-process heartbeat files (``liveness-p<rank>.json`` in the shared
fleet dir, refreshed at every boundary and stamped ``draining``/
``restarting`` on the way out): each daemon folds peer liveness into
its OWN ``MembershipLog`` at each boundary — a peer gone (stale
heartbeat or an explicit drain stamp) auto-``leave``s that peer's lane
range, the existing churn repair degrades those mixing rows to
identity (with ``topology='one_peer_exp'`` + ``mixing='async'`` the
survivors' mix is pure self-weight — no wire to the missing peer),
and a fresh heartbeat auto-``join``s the lanes back.  A SIGTERM'd
peer drains to its boundary, checkpoints, exits ``EX_RESTART``; the
supervisor respawns ONLY that child and it resumes bit-exactly —
survivors never stop ticking: a rolling restart with zero paused
rounds.  The liveness-driven auto rows are wall-clock-scheduled
(WHICH boundary sees a peer away depends on timing), so unlike every
other ledger row they are not bit-reproducible across runs; each
process's canonical stream remains self-consistent and replayable
(the rows land in the ledger like any commanded transition).  Each
daemon still simulates the full lane fleet locally (peers' lanes are
frozen by the away mask, not computed remotely) — decoupled mode is
the control-plane half of decentralization; cross-host lane exchange
stays with the SPMD fleet path.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
from pathlib import Path
from typing import Any

from dopt_torch.serve.control import (CommandQueue, ControlLedger,
                                apply_config_change, applied_record,
                                control_event_fields, control_ledger_row,
                                make_command, replay_effects)

# Exit code meaning "re-exec me" (BSD EX_TEMPFAIL — the conventional
# try-again code): the supervisor (or the shell loop in the README)
# respawns the daemon with the same state dir and it resumes.
EX_RESTART = 75

_STATUS_FILE = "serve.json"
_FINAL_FILE = "final.json"
_MONITOR_FILE = "monitor.json"
_COMMANDS_FILE = "commands.jsonl"
_APPLIED_FILE = "applied.jsonl"
_METRICS_FILE = "metrics.jsonl"
_CKPT_DIR = "ckpt"
_EPOCH_DIR = "epoch"
_RESTART_FLAG = "restart-requested"
_LIVENESS_PREFIX = "liveness-p"


def build_serve_trainer(cfg, membership, device=None):
    """Construct the engine for a served run with the membership
    overlay armed (the elastic round is built up front — a later
    join/leave changes only the round's inputs).  ``device`` is the
    trainers' own: CUDA unless the caller names the CPU.  dopt's
    refusals, in its words: the torch oracle and the seqlm engine have
    no serve entry."""
    if cfg.backend != "jax" or cfg.seqlm is not None:
        raise ValueError(
            "dopt serve drives the federated/gossip jax engines only "
            "(the torch oracle and the seqlm engine have no serve "
            "entry)")
    from dopt_torch.engine import FederatedTrainer, GossipTrainer

    if cfg.federated is not None:
        return FederatedTrainer(cfg, membership=membership, device=device)
    return GossipTrainer(cfg, membership=membership, device=device)


class _LockedPrometheusSink:
    """PrometheusSink behind an RLock: the admin thread renders while
    the training thread emits."""

    def __init__(self):
        from dopt_torch.obs.sinks import PrometheusSink

        self._prom = PrometheusSink()
        self._lock = threading.RLock()

    def emit(self, event):
        with self._lock:
            self._prom.emit(event)

    def emit_many(self, events):
        with self._lock:
            for ev in events:
                self._prom.emit(ev)

    def render(self) -> str:
        with self._lock:
            return self._prom.render()

    def close(self):
        pass


def serve_rules(extra_drop_rate: float = 0.5, specs=None):
    """The daemon's monitor rule set: ``default_rules()`` — or, with
    ``specs`` (the ``build_rules`` list shape a ``--rules-file`` JSON
    carries), the operator's declarative set instead — plus an
    ESCALATED drop-rate instance at critical severity, ALWAYS appended:
    that is the signal the admission auto-pause keys on, and a rule
    swap must not silently disarm it.  The escalation threshold (lost
    contributions per participant-round) is far above anything a
    healthy fleet produces, so the clean-run false-positive gate still
    holds."""
    from dopt_torch.obs.rules import DropRateRule, build_rules, default_rules

    rules = build_rules(specs) if specs is not None else default_rules()
    esc = DropRateRule(max_rate=float(extra_drop_rate), window=4,
                       min_rounds=2)
    esc.name = "drop_rate_critical"
    esc.severity = "critical"
    rules.append(esc)
    return rules


class ServeDaemon:
    """One resident trainer + its control plane.  ``start()`` builds
    (or resumes) everything, ``serve()`` runs until drained or told to
    restart; the instance itself is the ``run_served`` controller."""

    def __init__(self, cfg, state_dir, *, checkpoint_every: int = 8,
                 max_rounds: int | None = None, on_term: str = "restart",
                 admin_host: str = "127.0.0.1",
                 admin_port: int | None = None,
                 rules=None, process_id: int = 0, num_processes: int = 1,
                 directive_poll_s: float = 0.05,
                 directive_max_polls: int = 12000,
                 fleet_rank: int = 0, fleet_size: int = 1,
                 fleet_dir=None, peer_timeout_s: float = 10.0,
                 device=None):
        if on_term not in ("restart", "drain"):
            raise ValueError(
                f"on_term must be 'restart' or 'drain', got {on_term!r}")
        if int(fleet_size) > 1 and int(num_processes) > 1:
            raise ValueError(
                "a decoupled fleet (fleet_size > 1) and an SPMD fleet "
                "(num_processes > 1) are mutually exclusive: decoupled "
                "daemons are independent single-process leaders")
        self.base_cfg = cfg
        self.cfg = cfg
        self.device = device
        self.state_dir = Path(state_dir)
        self.checkpoint_every = int(checkpoint_every)
        self.max_rounds = max_rounds
        self.on_term = on_term
        self.admin_host = admin_host
        self.admin_port = admin_port
        self.process_id = int(process_id)
        self.num_processes = int(num_processes)
        self.is_leader = self.process_id == 0
        self._rules = rules
        self._directive_poll_s = float(directive_poll_s)
        self._directive_max_polls = int(directive_max_polls)
        # Decoupled-fleet identity: rank within the fleet of
        # independent daemons, and the SHARED parent dir carrying every
        # process's liveness heartbeat.  SPMD fleets share state_dir,
        # so the default fleet_dir covers them too (the leader's
        # heartbeat is what _await_directive's timeout reports).
        self.fleet_rank = int(fleet_rank)
        self.fleet_size = int(fleet_size)
        self.fleet_dir = (Path(fleet_dir) if fleet_dir is not None
                          else self.state_dir)
        self.peer_timeout_s = float(peer_timeout_s)
        self._decoupled = self.fleet_size > 1
        self._liveness_rank = (self.fleet_rank if self._decoupled
                               else self.process_id)

        self.queue = CommandQueue(self.state_dir / _COMMANDS_FILE)
        self.ledger = ControlLedger(self.state_dir / _APPLIED_FILE)
        self.ckpt_path = self.state_dir / _CKPT_DIR
        # EVERY process streams telemetry: the leader to metrics.jsonl,
        # followers to metrics-p<i>.jsonl — followers replay the
        # leader's directives, so the deterministic kinds of all N
        # streams must be bit-identical, which is exactly what the
        # fleet aggregator (dopt_torch.obs.aggregate) verifies.
        self.metrics_path = self.state_dir / (
            _METRICS_FILE if self.process_id == 0
            else f"metrics-p{self.process_id}.jsonl")

        self.trainer = None
        self.telemetry = None
        self.monitor = None
        self.prom = None
        self.admin = None
        self.membership = None
        self.paused = False
        self.restarts = 0
        self.status = "starting"
        self._pending: list[dict[str, Any]] = []
        self._processed: set[str] = set()
        self._term = False
        self._term_signal: str | None = None
        self._last_ckpt = -1
        self._alerts_seen = 0
        self._resumed = False
        # On-demand live profiling (POST /admin/profile): an armed
        # request captures a torch.profiler trace for the next K rounds
        # and writes a Chrome-trace artifact merged with the host
        # spans.  Pure observability — no ledger row, no telemetry
        # event, no training-state effect: arming it leaves History,
        # fault ledger and canonical stream bit-identical.
        self._profile_pending = 0
        self._profile: dict[str, Any] | None = None
        self._profile_artifacts: list[str] = []
        # Guards the armed/active transitions: POSTs arrive on the
        # admin's ThreadingHTTPServer threads while the serve thread
        # consumes the arm at boundaries — without it two concurrent
        # POSTs could both pass the already-armed check and both 202.
        self._profile_lock = threading.Lock()
        # Per-process boundary visit counter: a config-change rebuild
        # REVISITS the same round boundary, so directives are keyed by
        # (visit sequence, round), never round alone — SPMD lockstep
        # means every process counts visits identically, and the
        # supervisor wipes the directive dir between generations.
        self._boundary_seq = 0

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "ServeDaemon":
        self.state_dir.mkdir(parents=True, exist_ok=True)
        resume_round = self._peek_checkpoint_round()
        records = ControlLedger.replay(self.state_dir / _APPLIED_FILE)
        effects = replay_effects(
            records, up_to_round=resume_round if resume_round is not None
            else -1)
        from dopt_torch.faults import MembershipLog

        self.membership = MembershipLog(effects["membership"])
        cfg = self.base_cfg
        for _, key, value in effects["config"]:
            cfg = apply_config_change(cfg, key, value)
        self.cfg = cfg
        if effects["checkpoint_every"] is not None:
            self.checkpoint_every = int(effects["checkpoint_every"])
        self.paused = bool(effects["paused"])
        self._processed = set(effects["processed"])
        self.restarts = int(self._read_status_field("restarts", 0))

        self.trainer = build_serve_trainer(self.cfg, self.membership,
                                           self.device)
        if not self.is_leader:
            self.trainer.checkpoint_writer = False
        restore_s: float | None = None
        if resume_round is not None:
            t0 = time.perf_counter()
            self.trainer.restore(self.ckpt_path)
            restore_s = time.perf_counter() - t0
            self._resumed = True
            self.restarts += 1
        self._last_ckpt = int(self.trainer.round) if self._resumed else -1

        from dopt_torch.obs import HealthMonitor, Telemetry, attach

        self.telemetry = Telemetry.to_jsonl(self.metrics_path,
                                            resume=True)
        stream_watermark = self.telemetry.watermark
        if self.is_leader:
            self.prom = _LockedPrometheusSink()
            self.telemetry.sinks.append(self.prom)
            mon_state = None
            mpath = self.state_dir / _MONITOR_FILE
            if self._resumed and mpath.exists():
                try:
                    mon_state = json.loads(mpath.read_text())
                except ValueError:
                    mon_state = None   # torn by a hard kill: start fresh
            self.monitor = HealthMonitor(
                self._rules if self._rules is not None else serve_rules(),
                workers=self.trainer.num_workers, state=mon_state)
            self.monitor.attach(self.telemetry)
            self._alerts_seen = len(self.monitor.alerts)
        attach(self.trainer, self.telemetry,
               checkpoint_every=self.checkpoint_every or None)
        if restore_s is not None:
            self._observe_latency("checkpoint_restore", restore_s,
                                  int(self.trainer.round))
        if self._resumed and stream_watermark <= int(self.trainer.round):
            # Commands applied at EXACTLY the resume boundary may
            # have lost their control events: the event trails the
            # last sealed round, so repair_tail can drop it on
            # reopen (and a kill window can lose it outright) —
            # while one shielded by a later non-droppable event
            # (e.g. the boundary's `checkpoint`) survives.  Re-emit
            # exactly the MISSING ones, by id, so the resumed
            # stream carries each applied command once.
            r = int(self.trainer.round)
            present = self._stream_control_ids(r)
            for rec in records:
                if rec.get("status") == "applied" \
                        and int(rec.get("round", -1)) == r \
                        and str(rec.get("id")) not in present:
                    self.telemetry.emit(
                        "control",
                        **control_event_fields(
                            rec, r, auto=bool(rec.get("auto"))))
        if self.is_leader and self.admin_port is not None:
            from dopt_torch.serve.admin import AdminServer

            self.admin = AdminServer(self, host=self.admin_host,
                                     port=self.admin_port).start()
        self._install_signals()
        self.status = "serving"
        self._write_status()
        self._write_liveness(int(self.trainer.round))
        return self

    def _stream_control_ids(self, round_idx: int) -> set[str]:
        """Ids of ``control`` events at ``round_idx`` already in the
        metrics stream (post ``repair_tail``).  One linear scan at
        startup; the substring pre-filter keeps it cheap on long
        streams."""
        ids: set[str] = set()
        if not self.metrics_path.exists():
            return ids
        with open(self.metrics_path, encoding="utf-8") as f:
            for line in f:
                if '"control"' not in line:
                    continue
                try:
                    ev = json.loads(line)
                except ValueError:
                    continue
                if ev.get("kind") == "control" \
                        and ev.get("round") == round_idx:
                    ids.add(str(ev.get("id")))
        return ids

    def _peek_checkpoint_round(self) -> int | None:
        """The complete checkpoint's round, or None when starting
        fresh — read via the same completeness/fallback logic a
        restore would use."""
        from dopt_torch.utils.checkpoint import (IncompleteCheckpointError,
                                           load_checkpoint)

        if not self.ckpt_path.exists() and not self.ckpt_path.with_name(
                self.ckpt_path.name + ".old").exists():
            return None
        try:
            _, meta = load_checkpoint(self.ckpt_path)
        except IncompleteCheckpointError:
            return None
        return int(meta["round"])

    def _read_status_field(self, key: str, default):
        p = self.state_dir / _STATUS_FILE
        if not p.exists():
            return default
        try:
            return json.loads(p.read_text()).get(key, default)
        except ValueError:
            return default

    def _install_signals(self) -> None:
        def _term(signum, frame):
            self._term = True
            self._term_signal = ("drain" if signum == signal.SIGINT
                                 else self.on_term)
            if not self.is_leader:
                # A follower cannot decide for the fleet: it files a
                # stop request (carrying WHICH stop — SIGINT drains,
                # SIGTERM follows --on-term) that the leader folds
                # into the next boundary's directive.
                try:
                    (self.state_dir / _RESTART_FLAG).write_text(
                        self._term_signal)
                except OSError:
                    pass

        signal.signal(signal.SIGTERM, _term)
        signal.signal(signal.SIGINT, _term)

    # -- the run_served controller ------------------------------------
    def boundary(self, trainer) -> str:
        tick0 = time.perf_counter()
        t = int(trainer.round)
        self._boundary_seq += 1
        if self.num_processes > 1 and not self.is_leader:
            directive = self._await_directive(self._boundary_seq, t)
        else:
            directive = self._decide(t, trainer)
            if self.num_processes > 1:
                self._publish_directive(self._boundary_seq, directive)
        verdict = self._execute(directive, trainer)
        # boundary_tick measures the CONTROL-PLANE work (ingest,
        # directive, apply, checkpoint decision) — the profile tick
        # runs after the meter so a capture's artifact write never
        # skews the SLO.
        self._observe_latency(
            "boundary_tick",
            time.perf_counter() - tick0, t)
        self._write_liveness(t)
        self._profile_tick(t, verdict)
        return verdict

    def _observe_latency(self, name: str, seconds: float,
                         round_idx: int) -> None:
        """Stream one SLO latency observation (``dopt_torch.obs.latency``):
        a non-deterministic v1 ``latency`` event — wall durations, so
        like resource/compile it stays outside the canonical
        comparison; the in-process monitor folds it into the histogram
        the HealthReport and ``final.json`` summarize."""
        if self.telemetry is None:
            return
        self.telemetry.emit(
            "latency", round=max(int(round_idx), 0), name=str(name),
            seconds=round(max(float(seconds), 0.0), 6))

    def _decide(self, t: int, trainer) -> dict[str, Any]:
        """Leader: resolve this boundary completely (what applies, what
        is rejected, whether to checkpoint/stop/rebuild) so followers
        can replay the decision verbatim."""
        commands, malformed = self.queue.poll()
        for rej in malformed:
            if rej["id"] in self._processed:
                continue
            self._processed.add(rej["id"])
            self.ledger.append({"v": 1, "id": rej["id"],
                                "cmd": rej.get("cmd"),
                                "status": "rejected", "round": t,
                                "reason": rej["reason"]})
        for c in commands:
            if c["id"] not in self._processed:
                self._pending.append(c)

        due = [c for c in self._pending
               if c.get("at_round") is None or int(c["at_round"]) <= t]
        applied: list[dict[str, Any]] = []
        rejected: list[dict[str, Any]] = []
        auto_ids: list[str] = []
        stop: str | None = None
        paused = self.paused
        for c in due:
            cmd = c["cmd"]
            if cmd == "membership":
                if int(c["worker"]) >= trainer.num_workers:
                    rejected.append(applied_record(
                        c, status="rejected", round_idx=t,
                        reason=f"worker {c['worker']} outside the "
                               f"provisioned {trainer.num_workers}-lane "
                               "fleet"))
                    continue
                if c["action"] == "join" and paused:
                    rejected.append(applied_record(
                        c, status="rejected", round_idx=t,
                        reason="admission paused (resume to re-open)"))
                    continue
            if cmd == "drain":
                stop = "restart" if c.get("restart") else "drain"
            if cmd == "pause":
                paused = True
            if cmd == "resume":
                paused = False
            applied.append(c)

        # drop_rate-critical auto-pause: the monitor's alerts are
        # deterministic over the stream, so the pause lands at the same
        # boundary in an interrupted and an uninterrupted run.
        if self.monitor is not None and not paused:
            fresh = self.monitor.alerts[self._alerts_seen:]
            if any(a.get("severity") == "critical"
                   and str(a.get("rule", "")).startswith("drop_rate")
                   for a in fresh):
                c = make_command("pause", id=f"auto-pause-{t}")
                applied.append(c)
                auto_ids.append(c["id"])
        if self.monitor is not None:
            self._alerts_seen = len(self.monitor.alerts)

        # Decoupled fleets: peer liveness becomes membership here.
        # Appended AFTER the queue sweep (operator commands win the
        # boundary) and unconditionally on pause — a liveness rejoin
        # restores a provisioned peer, it does not admit a new one.
        if self._decoupled:
            for c in self._peer_transitions(t):
                applied.append(c)
                auto_ids.append(c["id"])

        if self._term:
            stop = stop or self._term_signal or self.on_term
        flag = self.state_dir / _RESTART_FLAG
        if flag.exists():
            try:
                requested = flag.read_text().strip()
            except OSError:
                requested = "restart"
            stop = stop or (requested if requested in ("restart", "drain")
                            else "restart")
        if stop is None and self.max_rounds is not None \
                and t >= int(self.max_rounds):
            stop = "drain"

        rebuild = any(c["cmd"] == "config" and c["key"] != "checkpoint_every"
                      for c in applied)
        cadence = (self.checkpoint_every and t > 0
                   and t % self.checkpoint_every == 0
                   and t != self._last_ckpt)
        checkpoint = bool(applied) or bool(cadence) or stop is not None \
            or rebuild
        if t == 0 and not applied and stop is None:
            checkpoint = False   # nothing to persist before round 0
        return {"round": t, "apply": applied, "rejected": rejected,
                "auto": auto_ids, "stop": stop, "rebuild": rebuild,
                "checkpoint": checkpoint}

    def _execute(self, directive: dict[str, Any], trainer) -> str:
        t = int(directive["round"])
        done_ids = set()
        if self.is_leader:
            for rec in directive["rejected"]:
                self.ledger.append(rec)
                self._processed.add(str(rec.get("id")))
                done_ids.add(str(rec.get("id")))
        for c in directive["apply"]:
            auto = c.get("id") in directive.get("auto", ())
            trainer.history.faults.append(control_ledger_row(c, t))
            self._install_effect(c, t)
            if self.is_leader:
                self.ledger.append(applied_record(c, status="applied",
                                                  round_idx=t, auto=auto))
                self._processed.add(str(c["id"]))
            if self.telemetry is not None:
                # EVERY process's stream carries the deterministic
                # control event (followers replay the directive, so
                # leader and follower streams must agree — the fleet
                # aggregator's consistency check).
                self.telemetry.emit(
                    "control", **control_event_fields(c, t, auto=auto))
            ets = c.get("ts")
            if isinstance(ets, (int, float)):
                # enqueue → applied: the latency an operator actually
                # waits on a command (the queue stamps `ts` at submit).
                self._observe_latency(
                    "command_apply",
                    time.time() - float(ets), t)
            done_ids.add(str(c.get("id")))
        if done_ids:
            self._pending = [c for c in self._pending
                             if str(c.get("id")) not in done_ids]

        if directive["checkpoint"]:
            self._checkpoint(trainer, t)
        stop = directive["stop"]
        if stop is not None:
            self.status = ("draining" if stop == "drain" else "restarting")
        self._write_status(round_=t)
        if stop is not None:
            return stop
        if directive["rebuild"]:
            return "rebuild"
        return "run"

    def _install_effect(self, c: dict[str, Any], t: int) -> None:
        cmd = c["cmd"]
        if cmd == "config":
            if c["key"] == "checkpoint_every":
                self.checkpoint_every = int(c["value"])
            else:
                self.cfg = apply_config_change(self.cfg, c["key"],
                                               c["value"])
        elif cmd == "membership":
            self.membership.add(t, int(c["worker"]),
                                c["action"] == "join")
        elif cmd == "pause":
            self.paused = True
        elif cmd == "resume":
            self.paused = False
        # checkpoint/drain effects are carried by the directive itself.

    def _checkpoint(self, trainer, t: int) -> None:
        t0 = time.perf_counter()
        trainer.save(self.ckpt_path)
        if self.num_processes > 1:
            # The save's gather is collective; the barrier on the
            # engine's group keeps followers from racing ahead (a
            # rebuild's restore must not read a checkpoint the leader
            # is still writing).
            from dopt_torch.parallel.mesh import barrier

            barrier(trainer.group)
        self._observe_latency(
            "checkpoint_save",
            time.perf_counter() - t0, t)
        if self.is_leader and self.monitor is not None:
            from dopt_torch.utils.metrics import atomic_write_text

            atomic_write_text(self.state_dir / _MONITOR_FILE,
                              json.dumps(self.monitor.state()))
        self._last_ckpt = t

    def _write_status(self, round_: int | None = None) -> None:
        if not self.is_leader:
            return
        from dopt_torch.utils.metrics import atomic_write_text

        atomic_write_text(self.state_dir / _STATUS_FILE, json.dumps({
            "pid": os.getpid(),
            "round": int(round_ if round_ is not None
                         else getattr(self.trainer, "round", 0)),
            "status": self.status,
            "paused": self.paused,
            "checkpoint_every": self.checkpoint_every,
            "restarts": self.restarts,
            "admin_port": self.admin.port if self.admin else None,
            "num_processes": self.num_processes,
            "metrics": str(self.metrics_path),
        }, indent=2))

    # -- liveness heartbeats & decoupled membership --------------------
    def _liveness_path(self, rank: int) -> Path:
        return self.fleet_dir / f"{_LIVENESS_PREFIX}{int(rank)}.json"

    def _write_liveness(self, round_: int) -> None:
        """Refresh this process's heartbeat file.  Operational state
        only (like ``serve.json``): never a telemetry event, never
        replay data — a lost heartbeat costs at worst one spurious
        peer-side leave/join cycle."""
        from dopt_torch.utils.metrics import atomic_write_text

        try:
            atomic_write_text(self._liveness_path(self._liveness_rank),
                              json.dumps({
                                  "pid": os.getpid(),
                                  "rank": self._liveness_rank,
                                  "round": int(round_),
                                  "status": self.status,
                                  "ts": time.time(),
                              }))
        except OSError:
            pass   # a missed heartbeat is survivable; a crash here is not

    @staticmethod
    def lanes_of(rank: int, fleet_size: int, num_workers: int) -> range:
        """The lane range decoupled process ``rank`` is authoritative
        for: the same even W//N split the SPMD mesh shards."""
        rank, n = int(rank), int(fleet_size)
        w = int(num_workers)
        return range(rank * w // n, (rank + 1) * w // n)

    def _peer_state(self, rank: int) -> str:
        """'live', 'gone', or 'unknown' (never started / torn write —
        no transition either way) from the peer's heartbeat file."""
        try:
            info = json.loads(self._liveness_path(rank).read_text())
        except (OSError, ValueError):
            return "unknown"
        if str(info.get("status")) in ("draining", "drained",
                                       "restarting"):
            return "gone"   # explicit departure stamp: no timeout wait
        age = time.time() - float(info.get("ts", 0.0))
        return "gone" if age > self.peer_timeout_s else "live"

    def _peer_transitions(self, t: int) -> list[dict[str, Any]]:
        """Decoupled fleets: fold peer liveness into auto membership
        commands for THIS boundary.  A gone peer's lanes leave (the
        churn repair turns their mixing rows to identity, so the round
        proceeds without them); a returned peer's lanes join back.
        Wall-clock-scheduled by construction — the rows are ledgered
        ``auto`` like the drop_rate auto-pause, and WHICH boundary
        carries them varies run to run (documented in the module
        docstring); everything downstream of the ledger stays
        deterministic."""
        w = int(self.trainer.num_workers)
        away = self.membership.away_at(t, w)
        out: list[dict[str, Any]] = []
        for rank in range(self.fleet_size):
            if rank == self.fleet_rank:
                continue
            state = self._peer_state(rank)
            if state == "unknown":
                continue
            for i in self.lanes_of(rank, self.fleet_size, w):
                if state == "gone" and not away[i]:
                    out.append(make_command(
                        "membership", worker=int(i), action="leave",
                        id=f"auto-liveness-leave-r{t}-w{i}"))
                elif state == "live" and away[i]:
                    out.append(make_command(
                        "membership", worker=int(i), action="join",
                        id=f"auto-liveness-join-r{t}-w{i}"))
        return out

    # -- multi-process directives --------------------------------------
    def _directive_path(self, seq: int, t: int) -> Path:
        # Keyed by (visit sequence, round): a rebuild revisits the same
        # round, and a round-only key would let a follower re-read the
        # stale pre-rebuild directive and double-apply it.
        return self.state_dir / _EPOCH_DIR / f"{seq:06d}-{t}.json"

    def _publish_directive(self, seq: int,
                           directive: dict[str, Any]) -> None:
        from dopt_torch.utils.metrics import atomic_write_text

        atomic_write_text(self._directive_path(seq, directive["round"]),
                          json.dumps(directive))

    def _await_directive(self, seq: int, t: int) -> dict[str, Any]:
        # Capped exponential backoff, not a fixed-cadence spin: the
        # first polls catch a prompt leader within ~poll_s, the 1s cap
        # bounds the latency a slow boundary pays, and the total wall
        # budget matches the old poll_s × max_polls product so tuned
        # deployments keep their timeout.
        path = self._directive_path(seq, t)
        budget = self._directive_poll_s * self._directive_max_polls
        deadline = time.monotonic() + budget
        delay = self._directive_poll_s
        while True:
            if path.exists():
                try:
                    return json.loads(path.read_text())
                except ValueError:
                    pass   # racing the rename: retry
            left = deadline - time.monotonic()
            if left <= 0:
                break
            time.sleep(min(delay, left))
            delay = min(delay * 2.0, max(self._directive_poll_s, 1.0))
        raise RuntimeError(
            f"process {self.process_id}: no boundary directive for round "
            f"{t} (visit {seq}) after {budget:.0f}s; leader liveness: "
            f"{self._leader_liveness_age()}; last directive published: "
            f"{self._last_directive_seen()}.  A fresh liveness file "
            "means the leader is alive but slow (raise "
            "directive_poll_s/directive_max_polls); a stale or missing "
            "one means the leader is gone (restart the fleet)")

    def _leader_liveness_age(self) -> str:
        """The leader heartbeat's age, rendered for the directive
        timeout — the one bit that tells a dead leader from a slow
        one."""
        p = self._liveness_path(0)
        try:
            info = json.loads(p.read_text())
            age = time.time() - float(info["ts"])
        except (OSError, ValueError, KeyError, TypeError):
            return f"no heartbeat file at {p}"
        return (f"heartbeat {age:.1f}s old "
                f"(status {info.get('status')!r}, "
                f"round {info.get('round')}, pid {info.get('pid')})")

    def _last_directive_seen(self) -> str:
        """The newest directive seq present in the epoch dir (timeout
        diagnostics: 'leader stopped publishing after seq K')."""
        try:
            names = sorted(p.name for p in
                           (self.state_dir / _EPOCH_DIR).glob("*.json"))
        except OSError:
            names = []
        return names[-1].rsplit(".", 1)[0] if names else "none"

    # -- on-demand live profiling (POST /admin/profile) ----------------
    def request_profile(self, rounds: int) -> dict[str, Any]:
        """Arm a ``torch.profiler`` trace capture for the next ``rounds``
        training rounds (admin thread; takes effect at the next
        boundary).  Observability only: no ledger row, no telemetry
        event, no training-state effect — arming it leaves History,
        fault ledger and canonical stream bit-identical to an
        unprofiled run."""
        rounds = int(rounds)
        if not 1 <= rounds <= 10_000:
            raise ValueError(
                f"profile rounds must be in [1, 10000], got {rounds}")
        with self._profile_lock:
            if self._profile is not None or self._profile_pending:
                raise ValueError(
                    "a profile capture is already armed or active "
                    f"({self.profile_status()})")
            self._profile_pending = rounds
        return self.profile_status()

    def profile_status(self) -> dict[str, Any]:
        prof = self._profile
        return {
            "pending_rounds": self._profile_pending,
            "active": None if prof is None else {
                "start_round": prof["start"], "rounds": prof["rounds"]},
            "artifacts": list(self._profile_artifacts),
        }

    def _profile_tick(self, t: int, verdict: str) -> None:
        """Boundary hook: stop a capture whose window elapsed (or whose
        run is stopping), then start an armed one.  Runs strictly
        outside the round dispatch — the capture wraps whole rounds."""
        prof = self._profile
        if prof is not None and (verdict != "run"
                                 or t >= prof["start"] + prof["rounds"]):
            self._profile_stop(t)
        with self._profile_lock:
            if verdict == "run" and self._profile_pending \
                    and self._profile is None:
                rounds, self._profile_pending = self._profile_pending, 0
                self._profile_start(t, rounds)

    def _profile_start(self, t: int, rounds: int) -> None:
        from torch.profiler import ProfilerActivity, profile

        trace_dir = self.state_dir / "profile" / f"r{t}"
        trace_dir.mkdir(parents=True, exist_ok=True)
        dev = getattr(self.trainer, "device", None)
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA]
            if dev is not None and dev.type == "cuda" else [])
        try:
            prof = profile(activities=acts)
            prof.start()
        except Exception as e:   # a profiler already active, no CUPTI
            print(f"dopt serve: profile capture failed to start: {e}",
                  file=sys.stderr, flush=True)
            return
        self._profile = {"start": t, "rounds": int(rounds),
                         "dir": str(trace_dir), "prof": prof}
        print(f"dopt serve: profiling armed for {rounds} round(s) "
              f"from round {t}", file=sys.stderr, flush=True)

    def _profile_stop(self, t: int) -> None:
        prof, self._profile = self._profile, None
        if prof is None:
            return
        try:
            prof["prof"].stop()
            prof["prof"].export_chrome_trace(
                str(Path(prof["dir"]) / "torch.trace.json"))
        except Exception as e:
            print(f"dopt serve: profile capture failed to stop: {e}",
                  file=sys.stderr, flush=True)
            return
        try:
            artifact = self._write_profile_artifact(prof, t)
        except (OSError, ValueError) as e:
            print(f"dopt serve: profile artifact failed: {e}",
                  file=sys.stderr, flush=True)
            return
        self._profile_artifacts.append(str(artifact))
        print(f"dopt serve: profile artifact {artifact} "
              f"(rounds {prof['start']}..{t})", file=sys.stderr,
              flush=True)

    def _write_profile_artifact(self, prof: dict[str, Any],
                                t: int) -> Path:
        """Merge the trace the profiler exported with the telemetry
        span tracer's host spans into ONE loadable Chrome trace: the
        profiler's events keep their pids, host spans ride a dedicated
        synthetic process track."""
        from dopt_torch.utils.metrics import atomic_write_text

        events: list[dict[str, Any]] = []
        for path in sorted(Path(prof["dir"]).glob("*.trace.json")):
            data = json.loads(path.read_text())
            events.extend(data.get("traceEvents", []))
        host_pid = 900_000 + self.process_id
        if self.telemetry is not None:
            spans = self.telemetry.tracer.to_chrome()
            if spans:
                events.append({"name": "process_name", "ph": "M",
                               "pid": host_pid,
                               "args": {"name": "dopt host spans"}})
                events.extend({**s, "pid": host_pid} for s in spans)
        out = (self.state_dir / "profile"
               / f"profile-r{prof['start']}-r{t}.trace.json")
        atomic_write_text(out, json.dumps(
            {"traceEvents": events, "displayTimeUnit": "ms"}))
        return out

    # -- the serve loop ------------------------------------------------
    def serve(self) -> int:
        """Run until drained (returns 0) or told to restart (returns
        ``EX_RESTART`` — the caller re-execs or the supervisor
        respawns)."""
        while True:
            verdict = self.trainer.run_served(self)
            if verdict == "rebuild":
                self._rebuild()
                continue
            if verdict == "drain":
                self._finalize("drained")
                return 0
            self._finalize("restarting")
            return EX_RESTART

    def _rebuild(self) -> None:
        """Config change took effect: reconstruct the trainer under the
        updated config and restore the boundary checkpoint — the same
        bit-exact save/restore path a kill-and-resume takes, minus the
        process exit."""
        trainer = build_serve_trainer(self.cfg, self.membership,
                                      self.device)
        if not self.is_leader:
            trainer.checkpoint_writer = False
        t0 = time.perf_counter()
        trainer.restore(self.ckpt_path)
        restore_s = time.perf_counter() - t0
        if self.telemetry is not None:
            from dopt_torch.obs import attach

            attach(trainer, self.telemetry,
                   checkpoint_every=self.checkpoint_every or None)
        self.trainer = trainer
        self._observe_latency("checkpoint_restore", restore_s,
                              int(trainer.round))

    def _finalize(self, status: str) -> None:
        self.status = status
        if self._profile is not None:
            # A drain/restart landed mid-capture: close the trace and
            # write the (partial) artifact rather than leaking an
            # active profiler session into process exit.
            self._profile_stop(int(getattr(self.trainer, "round", 0)))
        if self.is_leader:
            # Consume any follower stop request on the way out — a
            # stale flag would stop the next serve of this state dir
            # at its first boundary.
            try:
                (self.state_dir / _RESTART_FLAG).unlink(missing_ok=True)
            except OSError:
                pass
            if status == "drained":
                from dopt_torch.utils.metrics import atomic_write_text

                report = (self.monitor.report().to_dict()
                          if self.monitor is not None else None)
                # The SLO latency summary (p50/p95/p99 per name): the
                # monitor's histograms accumulate from the latency
                # events and are checkpointed with its state, so a
                # restarted run's drain still summarizes the whole
                # run's latencies.
                slo = (report or {}).get("latency") or {}
                atomic_write_text(self.state_dir / _FINAL_FILE, json.dumps({
                    "round": int(self.trainer.round),
                    "history": self.trainer.history.rows,
                    "fault_ledger": self.trainer.history.faults,
                    "restarts": self.restarts,
                    "report": report,
                    "slo": slo,
                    "profiles": list(self._profile_artifacts),
                }, indent=2))
        if self.admin is not None:
            self.admin.shutdown()
            self.admin = None
        if self.telemetry is not None:
            self.telemetry.close()
            self.telemetry = None
        self.ledger.close()
        self._write_status()
        # The departure stamp: peers reading "draining"/"restarting"
        # leave this process's lanes WITHOUT waiting out the staleness
        # timeout — the fast half of the decoupled drain protocol.
        self._write_liveness(int(getattr(self.trainer, "round", 0)))

    # -- admin-facing helpers ------------------------------------------
    def submit(self, command: dict[str, Any]) -> dict[str, Any]:
        """Queue one command (validated); applied at a round boundary."""
        return self.queue.submit(command)

    def snapshot(self) -> dict[str, Any]:
        """Status for ``GET /admin/status``."""
        trainer = self.trainer
        return {
            "status": self.status,
            "round": int(getattr(trainer, "round", 0)),
            "paused": self.paused,
            "checkpoint_every": self.checkpoint_every,
            "last_checkpoint_round": self._last_ckpt,
            "restarts": self.restarts,
            "pending_commands": [c.get("id") for c in self._pending],
            "workers": getattr(trainer, "num_workers", None),
            "engine": getattr(trainer, "engine_kind", None),
            "max_rounds": self.max_rounds,
            "num_processes": self.num_processes,
            "fleet_rank": self.fleet_rank,
            "fleet_size": self.fleet_size,
            "profile": self.profile_status(),
        }

    def membership_snapshot(self) -> dict[str, Any]:
        import numpy as np

        trainer = self.trainer
        w = getattr(trainer, "num_workers", 0)
        away = (self.membership.away_at(int(trainer.round), w)
                if self.membership is not None and w
                else np.zeros(0, bool))
        return {"workers": int(w),
                "present": [int(i) for i in np.nonzero(~away)[0]],
                "away": [int(i) for i in np.nonzero(away)[0]],
                "log": self.membership.to_json()
                if self.membership is not None else []}

    def config_snapshot(self) -> dict[str, Any]:
        cfg = self.cfg
        out: dict[str, Any] = {"checkpoint_every": self.checkpoint_every,
                               "paused": self.paused}
        if cfg.optim is not None:
            out["optim.lr"] = cfg.optim.lr
        if cfg.population is not None:
            out["population.cohort"] = cfg.population.cohort
        return out
