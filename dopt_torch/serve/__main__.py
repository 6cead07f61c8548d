"""CLI entry for the resident trainer: ``python -m dopt_torch.serve``, the
port's copy of dopt's ``python -m dopt.serve`` with every flag of it,
plus ``--device`` (the trainers run on CUDA unless it names the CPU, as
``python -m dopt_torch.run``'s do) and ``--collectives`` (the backend of
an SPMD fleet's process group).

Single process (the default)::

    python -m dopt_torch.serve --preset baseline1 --state-dir run/ \\
        --checkpoint-every 8

runs forever (or to ``--max-rounds``), serving the admin endpoint on
an ephemeral port (read it from ``run/serve.json``).  SIGTERM drains
to the next round boundary, checkpoints, and — with the default
``--on-term restart`` — re-execs in place and resumes bit-exactly;
``--on-term drain`` exits 0 instead.  Re-running the same command
against the same ``--state-dir`` always resumes.

Multi-process fleet (one ``torch.distributed`` rank a process, over
``--collectives gloo`` — the CPU, or children that share one card — or
``nccl``, a card each; ``--devices-per-proc`` stays 1, since a port
process is one rank on one device)::

    python -m dopt_torch.serve --preset baseline1 --state-dir run/ \\
        --num-processes 2

spawns one daemon per process under a supervisor: process 0 leads
(queue, telemetry, admin, checkpoint writes), followers replay its
per-boundary directives.  SIGTERM any CHILD for a rolling restart (the
fleet quiesces at the boundary, checkpoints once, every process
re-execs on a fresh port-0 coordinator, training resumes bit-exactly);
SIGTERM the SUPERVISOR to drain the whole run gracefully (it files a
``drain`` command and waits).

Decoupled fleet (no cross-process collectives — the zero-paused-rounds
rolling restart, built for ``gossip.topology=one_peer_exp`` +
``gossip.mixing=async``)::

    python -m dopt_torch.serve --preset baseline1 --state-dir run/ \\
        --num-processes 2 --decoupled \\
        --set gossip.topology=one_peer_exp --set gossip.mixing=async

spawns N INDEPENDENT single-process daemons (child i leads its own
``run/p<i>/`` state subdir), linked only by per-process liveness
heartbeat files in ``run/``: a peer that drains or goes stale is
auto-``leave``d from each survivor's membership (identity mixing rows
— the round proceeds without it) and auto-``join``ed back when its
heartbeat returns.  SIGTERM a CHILD and only THAT child drains,
checkpoints and is respawned — the survivors' round watermark never
pauses; SIGTERM the SUPERVISOR to drain every child gracefully.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from dopt_torch.serve.daemon import EX_RESTART, ServeDaemon


def build_cfg(args):
    from dopt_torch.presets import get_preset
    from dopt_torch.run import apply_override

    cfg = get_preset(args.preset)
    for spec in args.overrides:
        cfg = apply_override(cfg, spec)
    import dataclasses

    if args.num_users is not None:
        cfg = cfg.replace(data=dataclasses.replace(
            cfg.data, num_users=args.num_users))
    if args.synthetic_scale is not None:
        cfg = cfg.replace(data=dataclasses.replace(
            cfg.data,
            synthetic_train_size=max(int(cfg.data.synthetic_train_size
                                         * args.synthetic_scale),
                                     cfg.data.num_users * 8),
            synthetic_test_size=max(int(cfg.data.synthetic_test_size
                                        * args.synthetic_scale), 64),
        ))
    if args.num_processes > 1:
        cfg = cfg.replace(mesh_hosts=args.num_processes)
    return cfg


def run_daemon(args, argv: list[str]) -> int:
    if args.process_id is not None:
        # Fleet child: the shared bootstrap (dopt_torch.parallel.multihost)
        # rendezvous on the port-0 handoff coordinator — no fixed ports,
        # no parent-probed TOCTOU window — and joins the process group
        # over the named backend.
        from dopt_torch.parallel.multihost import bootstrap_child_backend

        bootstrap_child_backend(args.handoff, args.process_id,
                                args.num_processes,
                                args.devices_per_proc,
                                collectives=args.collectives)
    cfg = build_cfg(args)
    rules = None
    if args.rules_file:
        from dopt_torch.serve.daemon import serve_rules

        specs = json.loads(Path(args.rules_file).read_text())
        if not isinstance(specs, list):
            raise SystemExit(f"--rules-file {args.rules_file}: expected "
                             "a JSON list of rule specs "
                             '([{"rule": <name>, ...}, ...])')
        rules = serve_rules(specs=specs)
    daemon = ServeDaemon(
        cfg, args.state_dir,
        checkpoint_every=args.checkpoint_every,
        max_rounds=args.max_rounds,
        on_term=args.on_term,
        admin_host=args.admin_host,
        admin_port=None if args.no_admin else args.admin_port,
        process_id=args.process_id or 0,
        num_processes=args.num_processes,
        rules=rules,
        fleet_rank=args.fleet_rank or 0,
        fleet_size=args.fleet_size or 1,
        fleet_dir=args.fleet_dir,
        peer_timeout_s=args.peer_timeout,
        device=args.device,
    ).start()
    if daemon.is_leader and daemon.admin is not None:
        print(f"dopt serve: admin on http://{args.admin_host}:"
              f"{daemon.admin.port} (state {args.state_dir})",
              file=sys.stderr, flush=True)
    rc = daemon.serve()
    if rc == EX_RESTART and args.process_id is None \
            and args.fleet_rank is None:
        # Self-managed single process: the drain checkpointed, now
        # become a fresh process image and resume — the rolling
        # restart with a fleet of one.  Supervised children return the
        # code instead and the parent respawns the generation.
        print("dopt serve: re-exec for rolling restart", file=sys.stderr,
              flush=True)
        sys.stderr.flush()
        sys.stdout.flush()
        os.execv(sys.executable,
                 [sys.executable, "-m", "dopt_torch.serve", *argv])
    return rc


def run_supervisor(args, argv: list[str]) -> int:
    """Parent of a multi-process fleet: spawn one child per process,
    respawn the whole generation when any child asks for a restart
    (exit ``EX_RESTART``), stop when the fleet drains."""
    state = Path(args.state_dir)
    state.mkdir(parents=True, exist_ok=True)
    term = {"fired": False}

    def _term(signum, frame):
        # Graceful whole-run drain: file a drain command; the leader
        # applies it at the next boundary and the fleet exits 0.  The
        # id is unique per invocation — a reused fixed id would sit in
        # the resumed daemon's processed set (prior run's applied
        # ledger) and a SECOND drain of the same state dir would be
        # silently ignored.
        if not term["fired"]:
            term["fired"] = True
            import uuid

            from dopt_torch.serve.control import CommandQueue, make_command

            CommandQueue(state / "commands.jsonl").submit(
                make_command("drain",
                             id=f"supervisor-term-{uuid.uuid4().hex[:8]}"))

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)

    # The ONE fleet observability surface: every process streams its
    # own metrics file; the supervisor mounts the merged + verified
    # view (dopt_torch.obs.aggregate) as /metrics + /healthz, port announced
    # in <state>/fleet.json.  Stdlib-only — the supervisor never
    # imports torch.
    fleet_server = None
    if not args.no_admin:
        from dopt_torch.obs.aggregate import FleetMetricsServer
        from dopt_torch.utils.metrics import atomic_write_text

        fleet_server = FleetMetricsServer(
            state, num_processes=args.num_processes,
            host=args.admin_host, port=args.fleet_port).start()
        atomic_write_text(state / "fleet.json", json.dumps(
            {"host": args.admin_host, "port": fleet_server.port,
             "pid": os.getpid(),
             "num_processes": args.num_processes}, indent=2))
        print(f"dopt serve: fleet metrics on http://{args.admin_host}:"
              f"{fleet_server.port} (/metrics, /healthz)",
              file=sys.stderr, flush=True)

    try:
        return _supervise(args, argv, state)
    finally:
        if fleet_server is not None:
            fleet_server.shutdown()
            (state / "fleet.json").unlink(missing_ok=True)


def _supervise(args, argv: list[str], state: Path) -> int:
    log_dir = state / "logs"
    log_dir.mkdir(parents=True, exist_ok=True)
    generation = 0
    transport_retries = 0
    while True:
        # Directives are per-generation: a resumed fleet revisits the
        # same round indices, and a follower must never replay the
        # PREVIOUS generation's boundary decisions (the stale restart
        # directive would make it exit while the new leader waits in a
        # collective).  Children only spawn after the sweep, so there
        # is no reader to race.
        import shutil

        shutil.rmtree(state / "epoch", ignore_errors=True)
        (state / "restart-requested").unlink(missing_ok=True)
        handoff = Path(tempfile.mkdtemp(prefix="dopt-serve-")) / \
            f"coordinator-{generation}.json"
        procs, logs = [], []
        for i in range(args.num_processes):
            child_argv = [a for a in argv]
            child_argv += ["--process-id", str(i),
                           "--handoff", str(handoff)]
            log = open(log_dir / f"gen{generation}-p{i}.log", "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "dopt_torch.serve", *child_argv],
                stdout=log, stderr=subprocess.STDOUT))
        rcs = [p.wait() for p in procs]
        for log in logs:
            log.close()
        if all(rc == 0 for rc in rcs):
            print(f"dopt serve: fleet drained (generation {generation})",
                  file=sys.stderr)
            return 0
        if all(rc in (0, EX_RESTART) for rc in rcs):
            generation += 1
            transport_retries = 0
            print(f"dopt serve: rolling restart -> generation "
                  f"{generation}", file=sys.stderr)
            continue
        if _gloo_transport_flake(log_dir, generation) \
                and transport_retries < 3:
            # gloo's tcp transport occasionally interleaves two
            # collectives' messages on one pair under host load
            # (preamble/buffer length mismatch -> SIGABRT) — the same
            # narrowly-matched race multiprocess_demo retries.  State
            # is durable (checkpoint + applied ledger + stream
            # watermark), so respawning the generation resumes
            # bit-exactly; matched on the specific signature only, so
            # deterministic failures still fail.
            transport_retries += 1
            generation += 1
            print(f"dopt serve: gloo transport race, retry "
                  f"{transport_retries}/3 -> generation {generation}",
                  file=sys.stderr)
            continue
        print(f"dopt serve: fleet failed, child exit codes {rcs} "
              f"(logs in {log_dir})", file=sys.stderr)
        return 1


def run_decoupled_supervisor(args, argv: list[str]) -> int:
    """Parent of a DECOUPLED fleet: N independent single-process
    daemons, each leading its own ``<state>/p<i>/`` subdir, linked only
    by liveness heartbeats in ``<state>/``.  Respawn ONLY the child
    that asked (exit ``EX_RESTART``) — the survivors keep ticking
    through it: the zero-paused-rounds rolling restart."""
    state = Path(args.state_dir)
    state.mkdir(parents=True, exist_ok=True)
    term = {"fired": False}

    def _term(signum, frame):
        # Whole-run drain: one drain command PER child queue (each
        # daemon is its own leader — there is no fleet queue).  Unique
        # ids for the same reason run_supervisor's handler uses them.
        if not term["fired"]:
            term["fired"] = True
            import uuid

            from dopt_torch.serve.control import CommandQueue, make_command

            for i in range(args.num_processes):
                sub = state / f"p{i}"
                sub.mkdir(parents=True, exist_ok=True)
                CommandQueue(sub / "commands.jsonl").submit(
                    make_command(
                        "drain",
                        id=f"supervisor-term-{uuid.uuid4().hex[:8]}"))

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    return _supervise_decoupled(args, argv, state, term)


def _supervise_decoupled(args, argv: list[str], state: Path,
                         term: dict) -> int:
    log_dir = state / "logs"
    log_dir.mkdir(parents=True, exist_ok=True)
    base = _strip_decoupled_flags(argv)
    gens = [0] * args.num_processes

    def spawn(i: int):
        child_argv = base + [
            "--state-dir", str(state / f"p{i}"),
            "--fleet-rank", str(i),
            "--fleet-size", str(args.num_processes),
            "--fleet-dir", str(state)]
        log = open(log_dir / f"p{i}-gen{gens[i]}.log", "w")
        proc = subprocess.Popen(
            [sys.executable, "-m", "dopt_torch.serve", *child_argv],
            stdout=log, stderr=subprocess.STDOUT)
        return [proc, log]

    procs = {i: spawn(i) for i in range(args.num_processes)}
    failed = False
    while procs:
        time.sleep(0.2)
        for i in list(procs):
            proc, log = procs[i]
            rc = proc.poll()
            if rc is None:
                continue
            log.close()
            del procs[i]
            if rc == EX_RESTART and not failed:
                gens[i] += 1
                print(f"dopt serve: process {i} rolling restart -> "
                      f"gen {gens[i]} (peers keep ticking)",
                      file=sys.stderr, flush=True)
                procs[i] = spawn(i)
            elif rc not in (0, EX_RESTART):
                # One child failed hard: drain the survivors (SIGINT
                # always drains) rather than training a degraded fleet
                # forever under an absent supervisor verdict.
                failed = True
                print(f"dopt serve: process {i} failed (exit {rc}, "
                      f"log {log_dir / f'p{i}-gen{gens[i]}.log'}); "
                      "draining survivors", file=sys.stderr, flush=True)
                for other, _ in procs.values():
                    try:
                        other.send_signal(signal.SIGINT)
                    except OSError:
                        pass
    if failed:
        return 1
    print("dopt serve: decoupled fleet drained", file=sys.stderr)
    return 0


def _strip_decoupled_flags(argv: list[str]) -> list[str]:
    """Child argv for a decoupled spawn: drop the supervisor-level
    flags (the spawn appends the per-child ones)."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
            continue
        if a in ("--state-dir", "--num-processes", "--fleet-port",
                 "--fleet-rank", "--fleet-size", "--fleet-dir"):
            skip = True
            continue
        if a == "--decoupled":
            continue
        out.append(a)
    return out


def _gloo_transport_flake(log_dir: Path, generation: int) -> bool:
    for log in log_dir.glob(f"gen{generation}-p*.log"):
        try:
            if "op.preamble.length" in log.read_text(errors="replace"):
                return True
        except OSError:
            continue
    return False


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(prog="python -m dopt_torch.serve",
                                 description=__doc__)
    ap.add_argument("--preset", required=True,
                    help="preset name (dopt_torch.presets); federated/gossip "
                         "engines only")
    ap.add_argument("--state-dir", required=True,
                    help="the daemon's durable state: command queue, "
                         "applied ledger, metrics stream, checkpoints, "
                         "status file — re-running with the same dir "
                         "RESUMES")
    ap.add_argument("--set", action="append", default=[],
                    metavar="PATH=VAL", dest="overrides",
                    help="config override by dotted path (same semantics "
                         "as dopt_torch.run --set)")
    ap.add_argument("--num-users", type=int, default=None)
    ap.add_argument("--synthetic-scale", type=float, default=None)
    ap.add_argument("--checkpoint-every", type=int, default=8, metavar="K",
                    help="streaming atomic checkpoint cadence in rounds "
                         "(0 disables; boundaries that apply commands "
                         "checkpoint regardless); changeable live via "
                         "the control plane")
    ap.add_argument("--max-rounds", type=int, default=None,
                    help="drain after this many rounds (default: run "
                         "until a drain command or signal)")
    ap.add_argument("--on-term", choices=("restart", "drain"),
                    default="restart",
                    help="SIGTERM behavior: drain-checkpoint then "
                         "re-exec and resume (restart, default) or exit "
                         "0 (drain); SIGINT always drains")
    ap.add_argument("--admin-host", default="127.0.0.1")
    ap.add_argument("--admin-port", type=int, default=0,
                    help="admin/metrics endpoint port (default 0 = "
                         "ephemeral; the bound port lands in "
                         "<state>/serve.json)")
    ap.add_argument("--no-admin", action="store_true",
                    help="run without the HTTP endpoints (file-queue "
                         "control only; also disables the supervisor's "
                         "fleet metrics endpoint)")
    ap.add_argument("--fleet-port", type=int, default=0,
                    help="multi-process supervisor's fleet /metrics + "
                         "/healthz port (default 0 = ephemeral; the "
                         "bound port lands in <state>/fleet.json)")
    ap.add_argument("--rules-file", default=None, metavar="PATH",
                    help="JSON list of monitor rule specs "
                         '([{"rule": <name>, ...}]; dopt_torch.obs.rules.'
                         "build_rules shape) REPLACING the stock rule "
                         "set — the escalated drop_rate_critical "
                         "auto-pause rule is always appended")
    ap.add_argument("--device", default=None,
                    help="torch device of the trainers; default cuda "
                         "(raises without one)")
    ap.add_argument("--num-processes", type=int, default=1,
                    help="multi-process fleet size (one torch.distributed "
                         "rank a process)")
    ap.add_argument("--collectives", choices=("gloo", "nccl"),
                    default="gloo",
                    help="the SPMD fleet's process-group backend: gloo "
                         "(the CPU, or processes sharing one card) or "
                         "nccl (a card each)")
    ap.add_argument("--decoupled", action="store_true",
                    help="with --num-processes N: run N INDEPENDENT "
                         "single-process daemons (child i leads "
                         "<state>/p<i>/) linked only by liveness "
                         "heartbeats — no cross-process collectives, so "
                         "a peer's restart never pauses the survivors; "
                         "built for gossip.topology=one_peer_exp + "
                         "gossip.mixing=async")
    ap.add_argument("--peer-timeout", type=float, default=10.0,
                    metavar="SECONDS",
                    help="decoupled fleets: a peer whose liveness "
                         "heartbeat is older than this is auto-left "
                         "from the membership until it returns")
    ap.add_argument("--devices-per-proc", type=int, default=1,
                    help="devices per fleet process: 1, since a port "
                         "process is one torch.distributed rank on one "
                         "device (more ranks come from --num-processes)")
    ap.add_argument("--process-id", type=int, default=None,
                    help="(internal) run as fleet child with this id")
    ap.add_argument("--handoff", default=None,
                    help="(internal) coordinator handoff file path")
    ap.add_argument("--fleet-rank", type=int, default=None,
                    help="(internal) run as decoupled-fleet child with "
                         "this rank")
    ap.add_argument("--fleet-size", type=int, default=None,
                    help="(internal) decoupled-fleet size")
    ap.add_argument("--fleet-dir", default=None,
                    help="(internal) shared liveness-heartbeat dir")
    args = ap.parse_args(argv)

    if args.devices_per_proc != 1:
        n = args.num_processes * args.devices_per_proc
        ap.error(f"--devices-per-proc {args.devices_per_proc}: a port "
                 "fleet process is one torch.distributed rank on one "
                 "device, so it takes --devices-per-proc 1; for "
                 f"{n} ranks run --num-processes {n}")
    if args.collectives == "nccl" and args.device is not None \
            and args.device.startswith("cpu"):
        ap.error("--collectives nccl runs on GPUs; --device cpu takes "
                 "--collectives gloo")
    if args.decoupled and args.process_id is not None:
        ap.error("--decoupled and --process-id are mutually exclusive")
    if args.decoupled and args.fleet_rank is None:
        if args.num_processes < 2:
            ap.error("--decoupled requires --num-processes >= 2")
        return run_decoupled_supervisor(args, argv)
    if args.num_processes > 1 and args.process_id is None:
        return run_supervisor(args, argv)
    if args.process_id is not None and args.handoff is None:
        ap.error("--process-id requires --handoff")
    # Strip the internal child flags from the re-exec argv: a restarted
    # child gets fresh ones from the next generation's supervisor.
    return run_daemon(args, _strip_child_flags(argv))


def _strip_child_flags(argv: list[str]) -> list[str]:
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
            continue
        if a in ("--process-id", "--handoff"):
            skip = True
            continue
        out.append(a)
    return out


def status_of(state_dir) -> dict:
    """Read the daemon's status file (operator convenience)."""
    return json.loads((Path(state_dir) / "serve.json").read_text())


if __name__ == "__main__":
    raise SystemExit(main())
