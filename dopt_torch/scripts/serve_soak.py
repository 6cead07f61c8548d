"""Serve soak: the resident trainer, end-to-end, with invariants.

The ``dopt_torch.serve`` acceptance harness — a scripted single-host
resident run (real daemon subprocesses, real signals) that survives

* a live **membership change** (leave + later rejoin through the
  control plane → the churn/shard-reassignment machinery),
* a live **config change** (an ``optim.lr`` step applied at a round
  boundary via checkpoint → rebuild → restore),
* a **SIGTERM rolling restart** (drain to the boundary → checkpoint →
  re-exec in place → resume),

and asserts the four things a resident trainer owes you:

1. **Bit-exact elasticity** — the interrupted leg's History, fault
   ledger (``control`` + ``churn`` rows included) and canonical
   telemetry stream are IDENTICAL to an uninterrupted leg driven by
   the same command schedule: zero non-ledgered divergence.
2. **Ledgered control** — every applied command appears once in the
   ledger and once as a deterministic ``control`` event, at the same
   boundary round in both legs.
3. **Stream integrity** — both metrics streams pass
   ``dopt_torch.obs.check`` (schema + gapless duplicate-free rounds
   across the restart's segment headers).
4. **Zero false positives** — the STOCK rule set raises no alert on
   either leg, and the daemon's own in-process monitor (stock set +
   the escalated drop-rate rule) reports healthy.

Stream equality is asserted through ``dopt_torch.obs.diff`` (the
first-divergence differ), so a red run names the exact diverging event
instead of "streams differ".

Two further modes:

* ``--fleet`` — a REAL 2-process ``torch.distributed`` fleet leg (gloo,
  4 lanes on each of 2 ranks) with a live membership + config change
  and a SIGTERM rolling restart of a follower; every process streams
  its own telemetry, and the ``dopt_torch.obs.aggregate`` fleet
  aggregator must verify cross-process DETERMINISTIC_KINDS consistency
  through the restart, produce a merged stream that passes
  ``dopt_torch.obs.check``, and yield an SLO report with finite p50/p99
  for boundary-tick, command-apply, checkpoint-save/restore and alert
  latency (a sensitized drop-rate rule turns the membership churn into
  a real measured alert).  ``--fleet`` then runs the DECOUPLED
  async/one-peer leg on top: two independent daemons on
  ``gossip.topology=one_peer_exp`` + ``gossip.mixing=async``, a mid-run
  SIGTERM of the rank-1 child, and the zero-paused-rounds assertion —
  the survivor's round watermark strictly increases through the whole
  restart window while the liveness protocol ledgers the peer's lanes
  leaving and rejoining.
* ``--minutes N`` — the LONG soak: a resident run kept alive for N
  wall minutes under seeded randomized live churn (membership
  leave/join, lr and checkpoint-cadence config churn, SIGTERM rolling
  restarts on a timer), drained at the deadline, with the SLO latency
  report (p50/p99 per name) written to ``--slo-out``.

Every daemon runs on the GPU unless ``--device cpu`` is given (a CUDA
request without a GPU raises before any leg starts); on one card the
fleet's two processes share it.

    python -m dopt_torch.scripts.serve_soak --rounds 48 --min-seconds 60
    python -m dopt_torch.scripts.serve_soak --engine federated --rounds 24
    python -m dopt_torch.scripts.serve_soak --fleet --rounds 40 --slo-out slo.json
    python -m dopt_torch.scripts.serve_soak --minutes 20 --slo-out slo.json
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

from dopt_torch.serve.control import CommandQueue, make_command

# Reuse the chaos soak's ledger-invariant checker (the serve ledger
# adds fleet-level control rows, which it accepts).
from dopt_torch.scripts.chaos_soak import check_ledger

# The directory that holds the dopt_torch package: every daemon starts
# there with ``-m``, so it imports this tree's port.
REPO = Path(__file__).resolve().parents[2]


def serve_args(engine: str, rounds: int, seed: int,
               checkpoint_every: int) -> list[str]:
    """The CLI argv for one soak leg (tiny synthetic workload — the
    soak exercises the runtime, not the model); the caller adds
    ``--device``."""
    preset = "baseline1" if engine == "gossip" else "baseline3"
    args = ["--preset", preset, "--num-users", "8",
            "--max-rounds", str(rounds),
            "--checkpoint-every", str(checkpoint_every),
            "--set", "seed=%d" % seed,
            "--set", "data.dataset=synthetic",
            "--set", "data.synthetic_train_size=256",
            "--set", "data.synthetic_test_size=64",
            "--set", "model.model=mlp",
            "--set", "model.faithful=false"]
    if engine == "gossip":
        args += ["--set", "gossip.local_ep=1", "--set", "gossip.local_bs=32"]
    else:
        args += ["--set", "federated.local_ep=1",
                 "--set", "federated.local_bs=32"]
    return args


def seed_commands(state_dir: Path, rounds: int) -> dict[str, int]:
    """The scripted command schedule, pinned to round boundaries so
    both legs apply identically: leave at ~N/4, lr step at ~N/2,
    rejoin at ~5N/8."""
    marks = {"leave": max(rounds // 4, 1),
             "lr": max(rounds // 2, 2),
             "join": max(5 * rounds // 8, 3)}
    q = CommandQueue(state_dir / "commands.jsonl")
    q.submit(make_command("membership", worker=3, action="leave",
                          at_round=marks["leave"], id="soak-leave"))
    q.submit(make_command("config", key="optim.lr", value=0.05,
                          at_round=marks["lr"], id="soak-lr"))
    q.submit(make_command("membership", worker=3, action="join",
                          at_round=marks["join"], id="soak-join"))
    return marks


def run_leg(name: str, state_dir: Path, argv: list[str], *,
            on_term: str, kill_at: int | None = None,
            timeout_s: float = 900.0) -> dict:
    """Run one daemon subprocess to drain; with ``kill_at``, SIGTERM it
    once the status file reports that round (the daemon drains to the
    boundary, checkpoints, re-execs IN PLACE — same pid — and resumes
    to the configured max).  The SIGTERM skips a round within two
    boundaries of a scheduled command (a rebuild reports its boundary
    again, and a fast round may pass between the read and the signal):
    a restart drained at the lr step's rebuild boundary shares that
    boundary's segment header, and ``check_streams`` could not tell the
    restart happened."""
    state_dir.mkdir(parents=True, exist_ok=True)
    cmd = [sys.executable, "-m", "dopt_torch.serve", *argv,
           "--state-dir", str(state_dir), "--on-term", on_term]
    marks = set()
    queue = state_dir / "commands.jsonl"
    if queue.exists():
        marks = {json.loads(line).get("at_round")
                 for line in queue.read_text().splitlines() if line}
    t0 = time.time()  # dopt: allow-wallclock -- the leg's timeout and wall, reporting only
    proc = subprocess.Popen(cmd, cwd=REPO)
    status_path = state_dir / "serve.json"
    killed = False
    while True:
        try:
            rc = proc.wait(timeout=0.02)
            break
        except subprocess.TimeoutExpired:
            pass
        if time.time() - t0 > timeout_s:  # dopt: allow-wallclock -- the leg's timeout
            proc.kill()
            raise AssertionError(f"[{name}] leg timed out after "
                                 f"{timeout_s:.0f}s")
        if kill_at is not None and not killed and status_path.exists():
            try:
                st = json.loads(status_path.read_text())
            except ValueError:
                continue
            if st.get("status") == "serving" and st.get("round", 0) \
                    >= kill_at and not marks & set(
                        range(st["round"], st["round"] + 3)):
                print(f"[{name}] SIGTERM at round {st['round']} "
                      f"(pid {proc.pid}) -> rolling restart", flush=True)
                os.kill(proc.pid, signal.SIGTERM)
                killed = True
    elapsed = time.time() - t0  # dopt: allow-wallclock -- the leg's wall, reporting only
    assert rc == 0, f"[{name}] daemon exited rc={rc}"
    if kill_at is not None:
        assert killed, (f"[{name}] never reached round {kill_at} to "
                        "deliver the SIGTERM")
    final = json.loads((state_dir / "final.json").read_text())
    if kill_at is not None:
        assert final.get("restarts", 0) >= 1, \
            f"[{name}] daemon drained without surviving a restart"
    print(f"[{name}] drained at round {final['round']} in {elapsed:.1f}s "
          f"(restarts={final.get('restarts', 0)})", flush=True)
    final["_elapsed_s"] = elapsed
    return final


def check_streams(path_a: Path, path_b: Path, rounds: int) -> None:
    from dopt_torch.obs import HealthMonitor, JsonlSink, canonical, check_stream
    from dopt_torch.obs.diff import diverge_canonical, format_divergence

    ev_a = JsonlSink.read(path_a)
    ev_b = JsonlSink.read(path_b)
    sa, sb = check_stream(ev_a), check_stream(ev_b)
    assert sa["rounds"] == sb["rounds"] == rounds, (sa, sb)
    assert sb["segments"] >= sa["segments"] + 1, \
        "restarted leg should carry at least one extra segment header"
    # The first-divergence differ IS the equality assert now: a red
    # run names the exact diverging canonical event.  The CLI form
    # (`python -m dopt_torch.obs.diff A B`) is the same code path.
    ca = canonical(ev_a)
    div = diverge_canonical(ca, canonical(ev_b))
    assert div is None, "canonical streams diverged between legs:\n" \
        + format_divergence(str(path_a), str(path_b), div)
    n_ctl = sum(1 for e in ca if e["kind"] == "control")
    assert n_ctl == 3, f"expected 3 applied control events, saw {n_ctl}"
    print(f"[streams] canonical equality ok: {sa['events']} vs "
          f"{sb['events']} events, {n_ctl} control events each", flush=True)
    # Zero false positives under the STOCK rule set, on both legs.
    for name, evs in (("uninterrupted", ev_a), ("restarted", ev_b)):
        mon = HealthMonitor()
        mon.feed(evs)
        rep = mon.report()
        assert rep.alerts == 0 and rep.verdict == "healthy", \
            (f"false-positive gate: {name} leg raised {rep.alerts} "
             f"alerts: {mon.canonical_alerts()}")
    print("[streams] zero stock-rule alerts on both legs", flush=True)


# Sensitized monitor rule set for the latency-measuring legs: a
# drop-rate instance tight enough that the scripted membership churn
# fires a REAL warn alert through the real in-process path — which is
# what makes `alert_latency` a measured number instead of an empty
# histogram.  (The daemon always appends its escalated
# drop_rate_critical auto-pause rule on top; 0.02 << 0.5 never
# triggers the pause.)
SENSITIZED_RULES = [{"rule": "drop_rate", "max_rate": 0.02,
                     "window": 4, "min_rounds": 2}]

# The SLO names the fleet/long legs must report finite p50/p99 for
# (dopt_torch.obs.latency.SLO_LATENCIES, restated here so the soak fails
# loudly if the contract drifts).
SLO_CORE = ("boundary_tick", "command_apply", "checkpoint_save",
            "checkpoint_restore")


def write_slo_report(path: str, payload: dict) -> None:
    from dopt_torch.utils.metrics import atomic_write_text

    atomic_write_text(path, json.dumps(payload, indent=2))
    print(f"wrote SLO report to {path}", flush=True)
    for name, s in sorted(payload.get("slo", {}).items()):
        print(f"[slo] {name}: n={s['count']} p50={s['p50']}s "
              f"p99={s['p99']}s max={s['max']}s", flush=True)


def assert_slo(slo: dict, names) -> None:
    for name in names:
        s = slo.get(name)
        assert s and s["count"] >= 1, \
            f"SLO report misses latency {name!r}: {sorted(slo)}"
        for q in ("p50", "p99"):
            v = s.get(q)
            assert isinstance(v, (int, float)), \
                f"SLO {name}.{q} not finite: {s}"


def sigterm_child(state_dir: Path, process_id: int) -> bool:
    """SIGTERM one fleet child by its --process-id (the rolling-restart
    trigger).  No leading dashes in the pgrep pattern — it would parse
    them as its own options."""
    out = subprocess.run(
        ["pgrep", "-f", f"state-dir {state_dir}.*process-id "
                        f"{process_id}"],
        capture_output=True, text=True)
    pids = [int(p) for p in out.stdout.split()]
    if not pids:
        return False
    os.kill(pids[0], signal.SIGTERM)
    return True


def run_fleet_soak(args, root: Path) -> int:
    """The 2-process fleet leg: real ``torch.distributed`` + gloo, live
    membership + config change, SIGTERM rolling restart of a follower —
    then the fleet aggregator must verify cross-process consistency,
    its merged stream must pass ``dopt_torch.obs.check``, and the SLO report
    must carry finite p50/p99 for every core latency plus
    alert_latency."""
    from dopt_torch.obs import JsonlSink, summarize_latency_events
    from dopt_torch.utils.metrics import atomic_write_text

    state = root / "fleet"
    if state.exists():
        import shutil

        shutil.rmtree(state)
    state.mkdir(parents=True)
    rounds = args.rounds
    marks = seed_commands(state, rounds)
    kill_at = max(3 * rounds // 8, 2)
    rules_file = root / "fleet-rules.json"
    atomic_write_text(rules_file, json.dumps(SENSITIZED_RULES))

    cmd = [sys.executable, "-m", "dopt_torch.serve",
           *serve_args(args.engine, rounds, args.seed,
                       args.checkpoint_every),
           "--state-dir", str(state), "--rules-file", str(rules_file),
           "--num-processes", "2", "--devices-per-proc", "1",
           "--collectives", "gloo", "--device", args.device]
    print(f"[fleet] engine={args.engine} rounds={rounds} commands at "
          f"{marks}, follower SIGTERM at >= {kill_at}", flush=True)
    t0 = time.time()  # dopt: allow-wallclock -- the fleet's timeout and wall, reporting only
    sup = subprocess.Popen(cmd, cwd=REPO)
    status_path = state / "serve.json"
    killed = False
    timeout_s = 1500.0
    while sup.poll() is None:
        time.sleep(0.2)
        if time.time() - t0 > timeout_s:  # dopt: allow-wallclock -- the fleet's timeout
            sup.kill()
            raise AssertionError(f"[fleet] timed out after {timeout_s}s")
        if killed or not status_path.exists():
            continue
        try:
            st = json.loads(status_path.read_text())
        except ValueError:
            continue
        if st.get("status") == "serving" \
                and kill_at <= st.get("round", 0) <= rounds - 4:
            killed = sigterm_child(state, 1)
            if killed:
                print(f"[fleet] SIGTERM follower at round {st['round']} "
                      "-> rolling restart", flush=True)
    rc = sup.wait()
    assert rc == 0, f"[fleet] supervisor exited rc={rc} " \
                    f"(logs in {state / 'logs'})"
    assert killed, f"[fleet] never caught the fleet inside the " \
                   f"SIGTERM window (>= {kill_at})"
    final = json.loads((state / "final.json").read_text())
    assert final["round"] == rounds and final.get("restarts", 0) >= 1, \
        {k: final.get(k) for k in ("round", "restarts")}
    rep = final.get("report") or {}
    assert rep.get("verdict") in ("healthy", "warn"), rep
    assert rep.get("alerts", 0) >= 1, \
        "sensitized drop_rate rule never fired — alert_latency " \
        "unmeasured"

    # Cross-process DETERMINISTIC_KINDS consistency through the
    # rolling restart, via the product's own aggregator CLI.
    merged_path = state / "merged.jsonl"
    rc = subprocess.run(
        [sys.executable, "-m", "dopt_torch.obs.aggregate",
         "--state-dir", str(state), "--processes", "2",
         "--merged-out", str(merged_path)], cwd=REPO).returncode
    assert rc == 0, "fleet aggregator found cross-process divergence"
    rc = subprocess.run(
        [sys.executable, "-m", "dopt_torch.obs.check", str(merged_path),
         "--state-dir", str(state)], cwd=REPO).returncode
    assert rc == 0, "merged / per-process streams failed dopt_torch.obs.check"
    print("[fleet] aggregator consistency + merged stream check ok",
          flush=True)

    merged = JsonlSink.read(merged_path)
    procs = {e.get("process") for e in merged if e.get("kind") == "latency"}
    assert procs == {0, 1}, \
        f"expected latency events from both processes, saw {procs}"
    slo = summarize_latency_events(merged)
    assert_slo(slo, SLO_CORE + ("alert_latency",))
    payload = {"mode": "fleet", "engine": args.engine, "rounds": rounds,
               "restarts": final.get("restarts"),
               "alerts": rep.get("alerts"), "verdict": rep.get("verdict"),
               "elapsed_s": round(time.time() - t0, 1),  # dopt: allow-wallclock -- reported wall
               "slo": slo,
               "final_slo": final.get("slo")}
    if args.slo_out:
        write_slo_report(args.slo_out, payload)
    print("fleet soak passed: 2-process fleet with rolling restart, "
          "cross-process deterministic consistency verified, merged "
          "stream checked, SLO p50/p99 finite for "
          f"{', '.join(SLO_CORE + ('alert_latency',))}", flush=True)
    return 0


def sigterm_decoupled_child(state_dir: Path, rank: int) -> bool:
    """SIGTERM one decoupled-fleet child by its state subdir (no
    leading dashes in the pgrep pattern)."""
    out = subprocess.run(
        ["pgrep", "-f", f"state-dir {state_dir}/p{rank} "],
        capture_output=True, text=True)
    pids = [int(p) for p in out.stdout.split()]
    if not pids:
        return False
    os.kill(pids[0], signal.SIGTERM)
    return True


def run_decoupled_soak(args, root: Path) -> int:
    """The async/one-peer DECOUPLED fleet leg (``--fleet`` runs it
    after the SPMD leg): two independent daemons on
    ``gossip.topology=one_peer_exp`` + ``gossip.mixing=async``, SIGTERM
    the rank-1 child mid-run, and assert the tentpole property — ZERO
    PAUSED ROUNDS: the survivor's round watermark strictly increases
    through the entire SIGTERM → re-exec → resume window (an SPMD
    fleet's survivor freezes in a collective there until the whole
    generation respawns).  Also asserts the restarted child resumed
    (restarts >= 1, stream passes ``dopt_torch.obs.check``) and that the
    liveness protocol ledgered the peer's leave AND rejoin on the
    survivor before the drain."""
    state = root / "decoupled"
    if state.exists():
        import shutil

        shutil.rmtree(state)
    state.mkdir(parents=True)
    # Event-driven, not round-budgeted: the restarted child pays a
    # fresh python + torch import (and CUDA init) before its heartbeat returns, and on
    # slow CI that can outlast any fixed round count.  So the fleet
    # runs with an effectively unbounded round cap, the harness waits
    # for each phase (restart window closed, rejoin ledgered on the
    # survivor) and then drains everyone by SIGTERM — the 1500s
    # ceiling is the only clock.
    kill_at = 8
    base = serve_args("gossip", 100000, args.seed,
                      args.checkpoint_every)
    cmd = [sys.executable, "-m", "dopt_torch.serve", *base,
           "--set", "gossip.topology=one_peer_exp",
           "--set", "gossip.mixing=async",
           "--state-dir", str(state), "--no-admin",
           "--num-processes", "2", "--decoupled", "--peer-timeout", "5",
           "--device", args.device]
    print(f"[decoupled] one_peer_exp+async, rank-1 SIGTERM at >= "
          f"{kill_at}, drain once the rejoin lands", flush=True)
    t0 = time.time()  # dopt: allow-wallclock -- the 1,500 s ceiling and the wall, reporting only
    sup = subprocess.Popen(cmd, cwd=REPO)
    status_path = state / "p0" / "serve.json"

    def watermark() -> int | None:
        try:
            st = json.loads(status_path.read_text())
        except (OSError, ValueError):
            return None
        return (int(st["round"])
                if st.get("status") == "serving" else None)

    def peer_live() -> dict:
        try:
            return json.loads((state / "liveness-p1.json").read_text())
        except (OSError, ValueError):
            return {}

    def ledgered(action: str) -> set[int]:
        workers = set()
        try:
            lines = (state / "p0" / "applied.jsonl").read_text()
        except OSError:
            return workers
        for line in lines.splitlines():
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if rec.get("status") == "applied" \
                    and rec.get("cmd") == "membership" \
                    and rec.get("action") == action:
                workers.add(int(rec.get("worker", -1)))
        return workers

    killed = False
    killed_pid = None
    samples: list[int] = []
    window_open = False
    drained = False
    timeout_s = 1500.0
    while sup.poll() is None:
        time.sleep(0.1)
        if time.time() - t0 > timeout_s:  # dopt: allow-wallclock -- the 1,500 s ceiling
            sup.kill()
            raise AssertionError(f"[decoupled] timed out after "
                                 f"{timeout_s}s")
        w = watermark()
        if not killed:
            # Rank 1 itself must be serving at kill_at (its SIGTERM
            # handler installed, its own rounds past kill_at): the ranks
            # advance independently, and a child still importing torch
            # dies of the signal instead.
            live = peer_live()
            if w is not None and w >= kill_at \
                    and live.get("status") == "serving" \
                    and int(live.get("round", 0)) >= kill_at:
                killed_pid = live.get("pid")
                killed = sigterm_decoupled_child(state, 1)
                if killed:
                    window_open = True
                    print(f"[decoupled] SIGTERM rank 1 (pid "
                          f"{killed_pid}) at survivor round {w}",
                          flush=True)
            continue
        if window_open:
            if w is not None and (not samples or w != samples[-1]):
                samples.append(w)
            live = peer_live()
            # The window spans SIGTERM → drain → respawn → re-init:
            # closed only when a DIFFERENT pid heartbeats "serving"
            # (the old pid keeps a stale "serving" stamp until its
            # drain boundary rewrites it).
            if live.get("status") == "serving" \
                    and live.get("pid") not in (None, killed_pid) \
                    and samples:
                window_open = False
                print(f"[decoupled] rank 1 back (pid {live.get('pid')},"
                      f" round {live.get('round')}); survivor "
                      f"watermark through the window: {samples}",
                      flush=True)
            continue
        if not drained and ledgered("join") == {4, 5, 6, 7}:
            # Rejoin ledgered on the survivor: the protocol completed
            # a full leave → restart → rejoin cycle; drain everyone.
            drained = True
            print("[decoupled] rejoin ledgered on survivor; draining "
                  "fleet", flush=True)
            os.kill(sup.pid, signal.SIGTERM)
    rc = sup.wait()
    assert rc == 0, f"[decoupled] supervisor exited rc={rc} " \
                    f"(logs in {state / 'logs'})"
    assert killed, "[decoupled] fleet never reached the SIGTERM round"
    assert not window_open, \
        "[decoupled] rank 1 never came back serving before the fleet " \
        "drained"
    assert drained, \
        "[decoupled] rank 1's lanes never rejoined on the survivor " \
        f"(applied joins: {sorted(ledgered('join'))})"
    assert all(b > a for a, b in zip(samples, samples[1:])), \
        f"[decoupled] survivor watermark went backwards: {samples}"
    assert len(samples) >= 3, \
        f"[decoupled] survivor advanced only {samples} while rank 1 " \
        "was down — the restart PAUSED the fleet"
    assert ledgered("leave") == {4, 5, 6, 7}, \
        "[decoupled] survivor never ledgered rank 1's lanes away"

    finals = {}
    for rank in (0, 1):
        finals[rank] = json.loads(
            (state / f"p{rank}" / "final.json").read_text())
        assert finals[rank]["round"] >= kill_at, \
            (rank, finals[rank]["round"])
        crc = subprocess.run(
            [sys.executable, "-m", "dopt_torch.obs.check",
             str(state / f"p{rank}" / "metrics.jsonl"),
             "--state-dir", str(state / f"p{rank}")],
            cwd=REPO).returncode
        assert crc == 0, f"[decoupled] p{rank} stream failed " \
                         "dopt_torch.obs.check"
    assert finals[1].get("restarts", 0) >= 1, finals[1].get("restarts")
    assert finals[0].get("restarts", 0) == 0, finals[0].get("restarts")
    from dopt_torch.utils.metrics import atomic_write_text

    atomic_write_text(state / "decoupled-report.json", json.dumps({
        "mode": "decoupled",
        "survivor_watermark": samples,
        "final_rounds": {r: finals[r]["round"] for r in (0, 1)},
        "restarts_p1": finals[1].get("restarts"),
        "elapsed_s": round(time.time() - t0, 1)}, indent=2))  # dopt: allow-wallclock -- reported wall
    print("decoupled soak passed: one_peer_exp+async fleet trained "
          "straight through a peer's SIGTERM restart — survivor "
          f"watermark {samples} (zero paused rounds), peer resumed "
          f"after {finals[1].get('restarts')} restart(s), lanes left "
          "and rejoined via liveness", flush=True)
    return 0


def run_long_soak(args, root: Path) -> int:
    """``--minutes N``: the ROADMAP long soak.  One resident daemon
    kept alive for N wall minutes under seeded randomized churn —
    membership leave/join, lr + checkpoint-cadence config churn,
    SIGTERM rolling restarts — then drained; the SLO latency report
    (p50/p99 per name) is the artifact."""
    import random

    from dopt_torch.obs import JsonlSink, check_stream, summarize_latency_events
    from dopt_torch.utils.metrics import atomic_write_text

    rng = random.Random(args.seed)
    state = root / "long"
    if state.exists():
        import shutil

        shutil.rmtree(state)
    state.mkdir(parents=True)
    rules_file = root / "long-rules.json"
    atomic_write_text(rules_file, json.dumps(SENSITIZED_RULES))
    cmd = [sys.executable, "-m", "dopt_torch.serve",
           *serve_args(args.engine, 10**9, args.seed,
                       args.checkpoint_every),
           "--state-dir", str(state), "--rules-file", str(rules_file),
           "--on-term", "restart", "--no-admin", "--device", args.device]
    # serve_args pins --max-rounds; strip it — the long soak runs on
    # wall time and drains through the control plane.
    i = cmd.index("--max-rounds")
    del cmd[i:i + 2]
    deadline = time.time() + args.minutes * 60.0  # dopt: allow-wallclock -- the long soak runs on wall time by design
    t0 = time.time()  # dopt: allow-wallclock -- the long soak's reported wall
    proc = subprocess.Popen(cmd, cwd=REPO)
    q = CommandQueue(state / "commands.jsonl")
    away: set[int] = set()
    n_cmd = n_restart = 0
    next_cmd = time.time() + args.churn_period  # dopt: allow-wallclock -- churn schedule on wall time by design
    next_restart = time.time() + max(args.churn_period * 3, 30.0)  # dopt: allow-wallclock -- restart schedule on wall time by design
    status_path = state / "serve.json"
    print(f"[long] {args.minutes:.1f} min of randomized churn "
          f"(seed {args.seed}, command every ~{args.churn_period:.0f}s)",
          flush=True)
    try:
        while time.time() < deadline:  # dopt: allow-wallclock -- the long soak's deadline
            if proc.poll() is not None:
                raise AssertionError(
                    f"[long] daemon exited rc={proc.returncode} "
                    "mid-soak")
            time.sleep(1.0)
            now = time.time()  # dopt: allow-wallclock -- the churn and restart schedule
            if now >= next_cmd:
                next_cmd = now + args.churn_period * (0.5 + rng.random())
                kind = rng.choice(("membership", "lr", "cadence",
                                   "checkpoint"))
                n_cmd += 1
                cid = f"churn-{n_cmd}"
                if kind == "membership":
                    if away and (len(away) >= 3 or rng.random() < 0.5):
                        w = rng.choice(sorted(away))
                        away.discard(w)
                        q.submit(make_command("membership", worker=w,
                                              action="join", id=cid))
                    else:
                        w = rng.choice([i for i in range(1, 8)
                                        if i not in away])
                        away.add(w)
                        q.submit(make_command("membership", worker=w,
                                              action="leave", id=cid))
                elif kind == "lr":
                    q.submit(make_command(
                        "config", key="optim.lr",
                        value=round(0.05 + 0.1 * rng.random(), 4),
                        id=cid))
                elif kind == "cadence":
                    q.submit(make_command(
                        "config", key="checkpoint_every",
                        value=rng.choice((4, 8, 12)), id=cid))
                else:
                    q.submit(make_command("checkpoint", id=cid))
            if now >= next_restart and status_path.exists() \
                    and deadline - now > 45.0:
                # Leave headroom before the drain: a SIGTERM racing the
                # deadline would lose its boundary to the drain command
                # and count a restart that never happened.
                next_restart = now + max(args.churn_period * 3, 30.0)
                try:
                    st = json.loads(status_path.read_text())
                except ValueError:
                    continue
                if st.get("status") == "serving" and st.get("pid"):
                    n_restart += 1
                    print(f"[long] SIGTERM at round {st.get('round')} "
                          f"(restart {n_restart})", flush=True)
                    try:
                        os.kill(int(st["pid"]), signal.SIGTERM)
                    except OSError:
                        pass
        q.submit(make_command("drain", id="long-drain"))
        rc = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert rc == 0, f"[long] daemon exited rc={rc}"
    elapsed = time.time() - t0  # dopt: allow-wallclock -- the long soak's reported wall
    final = json.loads((state / "final.json").read_text())
    rep = final.get("report") or {}
    assert rep.get("verdict") in ("healthy", "warn"), rep
    events = JsonlSink.read(state / "metrics.jsonl")
    summary = check_stream(events)
    print(f"[long] drained at round {final['round']} after "
          f"{elapsed / 60:.1f} min: {n_cmd} commands, {n_restart} "
          f"SIGTERM restarts (survived {final.get('restarts')}), "
          f"{summary['segments']} stream segments, verdict "
          f"{rep.get('verdict')}", flush=True)
    assert final.get("restarts", 0) >= min(n_restart, 1), final.get(
        "restarts")
    slo = summarize_latency_events(events)
    core = [n for n in SLO_CORE
            if n != "checkpoint_restore" or n_restart > 0
            or "checkpoint_restore" in slo]
    assert_slo(slo, core)
    if rep.get("alerts", 0) >= 1:
        assert_slo(slo, ("alert_latency",))
    payload = {"mode": "long", "engine": args.engine,
               "minutes": args.minutes, "rounds": final["round"],
               "commands": n_cmd, "sigterm_restarts": n_restart,
               "restarts": final.get("restarts"),
               "alerts": rep.get("alerts"),
               "verdict": rep.get("verdict"),
               "segments": summary["segments"],
               "elapsed_s": round(elapsed, 1), "slo": slo,
               "final_slo": final.get("slo")}
    if args.slo_out:
        write_slo_report(args.slo_out, payload)
    print("long soak passed: resident through randomized live + config "
          "churn, stream integrity intact, SLO latencies measured",
          flush=True)
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m dopt_torch.scripts."
                                      "serve_soak", description=__doc__)
    ap.add_argument("--rounds", type=int, default=48)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--engine", choices=("gossip", "federated"),
                    default="gossip")
    ap.add_argument("--checkpoint-every", type=int, default=8)
    ap.add_argument("--min-seconds", type=float, default=0.0,
                    help="assert the restarted leg stayed resident at "
                         "least this long (the ROADMAP's >=60s soak bar)")
    ap.add_argument("--fleet", action="store_true",
                    help="run the 2-process fleet leg instead: rolling "
                         "restart + aggregator consistency + merged-"
                         "stream check + SLO report")
    ap.add_argument("--minutes", type=float, default=None, metavar="N",
                    help="LONG-soak mode: keep one resident run alive "
                         "for N wall minutes under seeded randomized "
                         "live churn + config churn, then drain and "
                         "report SLO latencies (the ROADMAP 1-hour "
                         "soak is --minutes 60)")
    ap.add_argument("--churn-period", type=float, default=20.0,
                    help="long-soak mean seconds between randomized "
                         "commands (restarts fire every ~4 periods)")
    ap.add_argument("--slo-out", default=None, metavar="PATH",
                    help="write the SLO latency report (p50/p99 per "
                         "latency name) here (fleet/long modes)")
    ap.add_argument("--state-root", default=None,
                    help="scratch root (default: a temp dir)")
    ap.add_argument("--report-out", default=None, metavar="PATH",
                    help="write both legs' final reports as one JSON "
                         "artifact here")
    ap.add_argument("--device", default=None,
                    help="torch device of every daemon; default cuda "
                         "(raises without one), 'cpu' for the CPU")
    args = ap.parse_args(argv)
    # The port's device rule, here and not in the first daemon: a CUDA
    # request on a machine without one raises before any leg starts.
    from dopt_torch.engine.gossip import resolve_device

    args.device = str(resolve_device(args.device))

    import tempfile

    # Resolved: the daemon subprocess runs with cwd=REPO, so a relative
    # --state-root would otherwise name a different directory for the
    # harness and the daemon.
    root = Path(args.state_root
                or tempfile.mkdtemp(prefix="dopt-soak-")).resolve()
    if args.minutes is not None:
        return run_long_soak(args, root)
    if args.fleet:
        rc = run_fleet_soak(args, root)
        if rc == 0:
            # The zero-paused-rounds leg rides the same flag: the SPMD
            # fleet proves bit-exact quiesce-and-resume, the decoupled
            # fleet proves training THROUGH the restart.
            rc = run_decoupled_soak(args, root)
        return rc
    rounds = args.rounds
    attempt = 0
    dir_a = root / "uninterrupted"
    while True:
        base = serve_args(args.engine, rounds, args.seed,
                          args.checkpoint_every) + ["--device", args.device]
        kill_at = max(3 * rounds // 8, 2)
        if dir_a.exists():
            import shutil

            shutil.rmtree(dir_a)
        marks_a = seed_commands(dir_a, rounds)
        print(f"[soak] engine={args.engine} rounds={rounds} "
              f"commands at {marks_a}, SIGTERM at >= {kill_at}", flush=True)
        final_a = run_leg("uninterrupted", dir_a, base, on_term="drain")
        # Self-calibration: round throughput varies 10x across CI
        # hardware, and the bar is RESIDENT SECONDS, not rounds —
        # rescale and redo the reference leg until it clears the bar
        # with margin (the restarted leg only ever runs longer: it
        # pays the re-exec warmup on top).
        if args.min_seconds <= 0 \
                or final_a["_elapsed_s"] >= args.min_seconds * 1.1:
            break
        scale = max(2, int(args.min_seconds * 1.3
                           // max(final_a["_elapsed_s"], 1.0)) + 1)
        rounds *= scale
        attempt += 1
        assert attempt <= 3, "soak calibration did not converge"
        print(f"[soak] {final_a['_elapsed_s']:.1f}s < "
              f"{args.min_seconds:.0f}s bar: rescaling to {rounds} "
              "rounds", flush=True)

    dir_b = root / "restarted"
    if dir_b.exists():
        # A persistent --state-root may hold a previous invocation's
        # leg: resuming its drained state would end immediately and
        # fail the comparison with a misleading message.
        import shutil

        shutil.rmtree(dir_b)
    marks_b = seed_commands(dir_b, rounds)
    assert marks_a == marks_b
    final_b = run_leg("restarted", dir_b, base, on_term="restart",
                      kill_at=kill_at)

    assert final_b["history"] == final_a["history"], \
        "History diverged between uninterrupted and restarted legs"
    assert final_b["fault_ledger"] == final_a["fault_ledger"], \
        "fault ledger diverged between uninterrupted and restarted legs"
    rows = final_a["fault_ledger"]
    # check_ledger wants a History-shaped object.
    n = check_ledger(SimpleNamespace(faults=rows), rounds, 8)
    kinds = sorted({r["kind"] for r in rows})
    assert "control" in kinds and "churn" in kinds, kinds
    print(f"[ledger] {n} rows identical across legs, kinds {kinds}",
          flush=True)

    check_streams(dir_a / "metrics.jsonl", dir_b / "metrics.jsonl",
                  rounds)

    for name, final in (("uninterrupted", final_a), ("restarted", final_b)):
        rep = final.get("report") or {}
        assert rep.get("verdict") == "healthy", \
            f"{name} leg's in-process monitor: {rep}"
    print("[monitor] in-process verdicts healthy on both legs", flush=True)

    if args.min_seconds > 0:
        assert final_b["_elapsed_s"] >= args.min_seconds, \
            (f"restarted leg stayed resident only "
             f"{final_b['_elapsed_s']:.1f}s < {args.min_seconds:.0f}s — "
             "raise --rounds")

    if args.report_out:
        from dopt_torch.utils.metrics import atomic_write_text

        atomic_write_text(args.report_out, json.dumps({
            "engine": args.engine, "rounds": rounds,
            "commands": marks_a, "kill_at": kill_at,
            "uninterrupted": {k: v for k, v in final_a.items()
                              if k not in ("history", "fault_ledger")},
            "restarted": {k: v for k, v in final_b.items()
                          if k not in ("history", "fault_ledger")},
        }, indent=2))
        print(f"wrote soak report to {args.report_out}", flush=True)

    print("serve soak passed: live membership + config change + SIGTERM "
          "rolling restart with bit-exact resume, zero non-ledgered "
          "divergence, zero false-positive alerts", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
