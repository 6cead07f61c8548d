"""Chaos soak: a randomized fault cocktail, end-to-end, with invariants.

Runs both engines through crash + corrupt + straggler + msg_drop +
msg_delay + churn simultaneously (the full degraded-network regime from
``dopt_torch.faults``) on a small synthetic workload — plus a third leg,
``gossip-async`` (one-peer exponential topology + staleness-1 async
mixing) under the process-fault storm those modes compose with, and a
fourth, ``gossip-codec`` (scatter + the per-bucket qsgd codec) — and
asserts the things a robust trainer owes you:

1. **Convergence to tolerance** — the fleet still learns: final train
   loss beats the first round's by a margin, and every logged metric is
   finite (the defenses keep poison out of theta).
2. **Ledger invariants** — every fault row is schema-complete
   ({round, worker, kind, action}, kind in ``dopt_torch.faults.KINDS``,
   ids in range), and a rerun of the identical config reproduces the
   ledger row-for-row (the stateless-draw determinism contract).
3. **Blocked-execution parity** — the blocked loop (on the card, one
   CUDA graph a round kind, replayed; quarantine streaks, staleness
   buffers, push-sum mass and the codec's residuals are carried state
   written in place) replays the per-round trace bit-identically, so
   chaos runs at clean-run dispatch cost is a free speedup, not a
   different experiment.
4. **Checkpoint invariants** — a run killed mid-soak and resumed from
   its latest auto-checkpoint is bit-identical (History rows AND fault
   ledger) to the continuous run.  ``--kill`` does this the honest way:
   it spawns a child process, SIGKILLs it mid-round-loop, and resumes
   from whatever checkpoint survived; the default does the same
   in-process (deterministic, CI-friendly).
5. **Monitor invariants** (dopt_torch.obs.monitor) — the streaming
   ``HealthMonitor``'s alert sequence is identical across per-round,
   blocked and killed-and-resumed execution of the same seed (the
   canonical-stream guarantee lifted to alerts); the stock rule set
   raises ZERO alerts on clean baseline1/baseline3-shaped runs (the
   false-positive gate); and a deliberately injected divergence — a
   corrupt scale bomb against ``aggregator='mean'`` — MUST fire the
   ``loss_divergence`` rule before the run ends.  ``--report-out``
   writes the legs' HealthReports as one JSON artifact for CI.

The cocktail's knobs are drawn from seeded ranges (``--seed``), so
``--seed N`` gives N distinct-but-reproducible storms, the same storms
as dopt's ``scripts/chaos_soak.py`` draws.  The trainers run on the GPU
unless ``--device cpu`` is given (a CUDA request without a GPU raises).

    python -m dopt_torch.scripts.chaos_soak --rounds 8 --seed 0
    python -m dopt_torch.scripts.chaos_soak --rounds 8 --engine gossip --kill
    python -m dopt_torch.scripts.chaos_soak --rounds 8 --device cpu
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from dopt_torch.config import (CommConfig, DataConfig, ExperimentConfig,
                               FaultConfig, FederatedConfig, GossipConfig,
                               ModelConfig, OptimizerConfig)
from dopt_torch.faults import KINDS

# The directory that holds the dopt_torch package: the SIGKILL child is
# started there with ``-m``, so it imports this tree's port.
_ROOT = Path(__file__).resolve().parents[2]

_DATA = DataConfig(dataset="synthetic", num_users=8, iid=True,
                   synthetic_train_size=512, synthetic_test_size=128)
_MODEL = ModelConfig(model="mlp", input_shape=(28, 28, 1), faithful=False)
_OPTIM = OptimizerConfig(lr=0.1, momentum=0.5)


def cocktail(seed: int) -> tuple[FaultConfig, FaultConfig, FaultConfig,
                                 FaultConfig]:
    """Seeded random draw of the round's fault cocktail: (gossip
    cocktail, federated cocktail, async-gossip cocktail, codec-gossip
    cocktail).  The federated one adds the Byzantine nan liar (screened
    by the always-on non-finite guard) and the heavy straggler deadline
    that staleness-aware aggregation buffers; the gossip one leans on
    the link model + push-sum.  The async one draws only the process
    faults (crash + straggler + churn) at HIGHER rates: link faults
    and push-sum are rejected by ``mixing='async'`` by design (the
    [D+1, n, n] staleness stack already subsumes staleness-1), so the
    storm concentrates on the repairs the diag/off-diag split must
    survive.  The codec one likewise draws only process faults — the
    ``msg_*`` knobs run the per-staleness link engine, which keeps the
    dense wire the bucket codec replaces — so the compression-armed leg
    storms exactly the faults the scatter+codec path composes with.
    The draw order is dopt's, so each storm is dopt's bit for bit."""
    rng = np.random.default_rng([0xC0C7A11, seed])

    def u(lo, hi):
        return float(rng.uniform(lo, hi))

    gossip = FaultConfig(
        crash=u(0.03, 0.1), straggle=u(0.1, 0.3), straggle_frac=0.5,
        msg_drop=u(0.1, 0.25), msg_delay=u(0.1, 0.35), msg_delay_max=2,
        churn=u(0.02, 0.08), churn_span=int(rng.integers(2, 4)))
    fed = FaultConfig(
        crash=u(0.03, 0.1), straggle=u(0.3, 0.6), straggle_frac=0.5,
        straggler_policy="drop", over_select=0.3,
        corrupt=u(0.05, 0.15), corrupt_mode="nan",
        msg_drop=u(0.05, 0.15), msg_delay=u(0.1, 0.3), msg_delay_max=3,
        churn=u(0.02, 0.08), churn_span=int(rng.integers(2, 4)))
    asynk = FaultConfig(
        crash=u(0.08, 0.18), straggle=u(0.1, 0.3), straggle_frac=0.5,
        churn=u(0.05, 0.12), churn_span=int(rng.integers(2, 4)))
    codec = FaultConfig(
        crash=u(0.03, 0.1), straggle=u(0.1, 0.3), straggle_frac=0.5,
        churn=u(0.02, 0.08), churn_span=int(rng.integers(2, 4)))
    return gossip, fed, asynk, codec


def build_cfg(engine: str, seed: int, rounds: int,
              prefetch: bool = False) -> ExperimentConfig:
    # diagnostics="on" everywhere: the soak's canonical-stream equality
    # invariants (per-round vs blocked vs killed-and-resumed) thereby
    # pin the per-round convergence gauges too.
    pf = "on" if prefetch else "off"
    gossip_fc, fed_fc, async_fc, codec_fc = cocktail(seed)
    if engine == "gossip":
        return ExperimentConfig(
            name=f"chaos-gossip-{seed}", seed=100 + seed, data=_DATA,
            model=_MODEL, optim=_OPTIM,
            gossip=GossipConfig(algorithm="dsgd", topology="circle",
                                mode="metropolis", rounds=rounds,
                                local_ep=1, local_bs=32,
                                correction="push_sum", prefetch=pf,
                                diagnostics="on"),
            faults=gossip_fc)
    if engine == "gossip-async":
        # The one-peer exponential schedule + staleness-1 mixing, under
        # the process-fault storm.  Every soak invariant (blocked /
        # prefetched / resumed bit-identity, ledger replay, canonical
        # stream + alert parity) applies unchanged.
        return ExperimentConfig(
            name=f"chaos-gossip-async-{seed}", seed=100 + seed,
            data=_DATA, model=_MODEL, optim=_OPTIM,
            gossip=GossipConfig(algorithm="dsgd",
                                topology="one_peer_exp",
                                mode="metropolis", rounds=rounds,
                                local_ep=1, local_bs=32,
                                mixing="async", prefetch=pf,
                                diagnostics="on"),
            faults=async_fc)
    if engine == "gossip-codec":
        # The compression-armed leg: scatter substrate + the per-bucket
        # qsgd codec (error feedback carried across rounds), under the
        # process-fault storm it composes with.  Blocked-vs-per-round
        # bit-identity pins the codec's fold-in key stream + residual
        # carry, and the kill-and-resume leg exercises the
        # 'comm_residual' checkpoint payload end to end.
        return ExperimentConfig(
            name=f"chaos-gossip-codec-{seed}", seed=100 + seed,
            data=_DATA, model=_MODEL, optim=_OPTIM,
            gossip=GossipConfig(algorithm="dsgd", topology="circle",
                                mode="metropolis", rounds=rounds,
                                local_ep=1, local_bs=32,
                                update_sharding="scatter", prefetch=pf,
                                diagnostics="on"),
            comm=CommConfig(codec="qsgd", chunk=64, min_codec_bytes=256),
            faults=codec_fc)
    return ExperimentConfig(
        name=f"chaos-fed-{seed}", seed=100 + seed, data=_DATA,
        model=_MODEL, optim=_OPTIM,
        federated=FederatedConfig(algorithm="fedavg", frac=0.5,
                                  rounds=rounds, local_ep=1, local_bs=32,
                                  staleness_max=3, staleness_decay=0.5,
                                  prefetch=pf, diagnostics="on"),
        faults=fed_fc)


def build_trainer(engine: str, seed: int, rounds: int,
                  prefetch: bool = False, device=None):
    from dopt_torch.engine import FederatedTrainer, GossipTrainer

    cfg = build_cfg(engine, seed, rounds, prefetch=prefetch)
    return (GossipTrainer(cfg, device=device) if engine.startswith("gossip")
            else FederatedTrainer(cfg, device=device))


def cocktail_rules():
    """The monitor rule set for the cocktail legs: the stock set with
    the drop-rate SLO tightened far below the storm's actual loss rate,
    so the soak's alert-sequence-equality invariant compares real
    firings, not three empty lists."""
    from dopt_torch.obs.rules import default_rules

    return default_rules(drop_rate={"max_rate": 0.05, "window": 4,
                                    "min_rounds": 2})


def check_ledger(history, rounds: int, workers: int) -> int:
    """Schema + range invariants over every fault-ledger row.  Shared
    with the serve soak (dopt_torch.scripts.serve_soak), whose ledgers
    carry fleet-level rows — control-plane config/drain/pause
    applications and population cohort audits use ``worker == -1``."""
    for row in history.faults:
        assert set(row) == {"round", "worker", "kind", "action"}, row
        assert row["kind"] in KINDS, row
        assert 0 <= row["round"] < rounds, row
        assert -1 <= row["worker"] < workers, row
        if row["worker"] == -1:
            assert row["kind"] in ("control", "cohort"), row
        assert isinstance(row["action"], str) and row["action"], row
    return len(history.faults)


def loss_key(history) -> str:
    return ("avg_train_loss" if "avg_train_loss" in history.rows[0]
            else "train_loss")


def check_convergence(history, tol: float) -> tuple[float, float]:
    k = loss_key(history)
    losses = [r[k] for r in history.rows if k in r]
    assert all(np.isfinite(v) for r in history.rows for v in r.values()), \
        "non-finite metric leaked into History"
    first, last = float(losses[0]), float(losses[-1])
    assert last < first + tol, \
        f"no learning under the cocktail: first={first:.4f} last={last:.4f}"
    return first, last


def soak_one(engine: str, seed: int, rounds: int, tol: float,
             ckpt_dir: str, kill: bool, metrics_sink=None,
             prefetch: bool = False, device=None):
    from dopt_torch.obs import (HealthMonitor, JsonlSink, MemorySink,
                                Telemetry, attach, canonical, check_stream)

    w = _DATA.num_users
    print(f"[{engine}] cocktail seed={seed}: continuous run ...")
    cont = build_trainer(engine, seed, rounds, device=device)
    mem = MemorySink()
    sinks = [mem] + ([metrics_sink] if metrics_sink is not None else [])
    tele_c = Telemetry(sinks)
    # The streaming monitor rides the continuous run IN-PROCESS (sink
    # attachment): alerts fire while it trains and are forwarded into
    # the stream.
    mon_c = HealthMonitor(cocktail_rules()).attach(tele_c)
    attach(cont, tele_c, fresh=True)
    hc = cont.run(rounds=rounds)
    first, last = check_convergence(hc, tol)
    n_rows = check_ledger(hc, rounds, w)
    print(f"[{engine}] loss {first:.4f} -> {last:.4f}, "
          f"{n_rows} ledger rows, kinds "
          f"{sorted(set(r['kind'] for r in hc.faults))}")

    # Telemetry-stream invariants (dopt_torch.obs): every event is
    # schema-valid and the round sequence is gapless and
    # duplicate-free; the typed fault events mirror the ledger 1:1.
    summary = check_stream(mem.events)
    assert summary["rounds"] == rounds, summary
    assert summary["kinds"].get("fault", 0) == n_rows, summary
    # Diagnostics invariants (diagnostics="on"): every round bundle
    # carries the convergence gauges — their cross-path equality is
    # pinned by the canonical-stream asserts below — and the
    # non-deterministic resource channel sampled at least once.
    from dopt_torch.obs.events import DIAG_GAUGES

    gauge_names = {e["name"] for e in mem.events if e["kind"] == "gauge"}
    want = set(DIAG_GAUGES) | {"consensus_distance"
                               if engine.startswith("gossip")
                               else "lane_dispersion"}
    assert want <= gauge_names, \
        f"diagnostic gauges missing from the stream: {want - gauge_names}"
    assert summary["kinds"].get("resource", 0) >= 1, summary
    print(f"[{engine}] telemetry stream ok: {summary['events']} events "
          f"({summary['kinds']}; diagnostics gauges present)")

    # Determinism: the identical config replays the identical storm.
    rerun = build_trainer(engine, seed, rounds, device=device)
    hr = rerun.run(rounds=rounds)
    assert hr.rows == hc.rows and hr.faults == hc.faults, \
        "rerun diverged from the first run (stateless-draw contract broken)"
    print(f"[{engine}] deterministic replay ok")

    # Blocked-execution parity: the blocked loop (push-sum mass /
    # staleness buffers / quarantine streaks as carried state) must
    # replay the identical trace — History rows AND ledger, content and
    # order — at chaos-cocktail settings.  Bit-identity is what makes
    # the blocked speedup free.
    # With --prefetch, the blocked trainer runs the staged host
    # pipeline (dispatch → stage-next → fetch): the assertion then pins
    # prefetched-blocked against unprefetched-per-round.
    blk = build_trainer(engine, seed, rounds, prefetch=prefetch,
                        device=device)
    mem_b = MemorySink()
    tele_b = Telemetry([mem_b])
    mon_b = HealthMonitor(cocktail_rules()).attach(tele_b)
    attach(blk, tele_b, fresh=True)
    hb = blk.run(rounds=rounds, block=max(rounds // 2, 2))
    assert hb.rows == hc.rows, \
        f"blocked History diverged from per-round ({engine})"
    assert hb.faults == hc.faults, \
        f"blocked fault ledger diverged from per-round ({engine})"
    assert canonical(mem_b.events) == canonical(mem.events), \
        f"blocked telemetry stream diverged from per-round ({engine})"
    assert mon_b.canonical_alerts() == mon_c.canonical_alerts(), \
        f"blocked-run alert sequence diverged from per-round ({engine})"
    print(f"[{engine}] fused-block execution bit-identical ok "
          f"(History + ledger + event stream + {len(mon_c.alerts)} "
          f"alerts{', prefetch armed' if prefetch else ''})")

    # Kill-and-resume bit-identity, including the telemetry stream's
    # monotonic round watermark: the resumed run APPENDS to the dead
    # run's JSONL and the merged file must carry every round exactly
    # once.
    path = os.path.join(ckpt_dir, f"{engine}-{seed}")
    mpath = os.path.join(ckpt_dir, f"{engine}-{seed}-metrics.jsonl")
    # A persistent --ckpt-dir may hold a previous invocation's stream;
    # the child opens it resume=True and a stale watermark would
    # suppress this run's emission entirely — start from a clean file.
    if os.path.exists(mpath):
        os.unlink(mpath)
    kill_at = max(rounds // 2, 1)
    if kill:
        _sigkill_child(engine, seed, rounds, kill_at, path, mpath,
                       device=device)
    else:
        part = build_trainer(engine, seed, rounds, device=device)
        tele_p = Telemetry.to_jsonl(mpath)
        attach(part, tele_p)
        part.run(rounds=kill_at, checkpoint_every=1, checkpoint_path=path)
        tele_p.close()
    res = build_trainer(engine, seed, rounds, device=device)
    res.restore(path)
    assert res.round >= 1, "no checkpoint survived the kill"
    tele_r = Telemetry.to_jsonl(mpath, resume=True)
    attach(res, tele_r)
    hk = res.run(rounds=rounds - res.round)
    tele_r.close()
    assert hk.rows == hc.rows, \
        f"resumed History diverged from continuous ({engine})"
    assert hk.faults == hc.faults, \
        f"resumed fault ledger diverged from continuous ({engine})"
    merged = JsonlSink.read(mpath)
    check_stream(merged)
    got = [e["round"] for e in merged if e["kind"] == "round"]
    assert got == list(range(rounds)), \
        f"resumed stream rounds {got} != 0..{rounds - 1} ({engine})"
    assert (canonical(merged, kinds=("round", "fault"))
            == canonical(mem.events, kinds=("round", "fault"))), \
        f"resumed telemetry stream diverged from continuous ({engine})"
    # The monitor over the MERGED killed-and-resumed stream (the resume
    # header keeps the rule windows) fires the same alert sequence the
    # continuous in-process monitor did.
    mon_r = HealthMonitor(cocktail_rules())
    mon_r.feed(merged)
    assert mon_r.canonical_alerts() == mon_c.canonical_alerts(), \
        f"resumed-stream alert sequence diverged from continuous ({engine})"
    print(f"[{engine}] {'SIGKILL' if kill else 'in-process kill'}"
          f"-and-resume bit-identical ok (stream watermark gapless, "
          f"alert sequence identical)")
    return mon_c.report()


def clean_baseline_gate(rounds: int, device=None):
    """False-positive gate: the STOCK rule set must raise zero alerts
    on clean baseline1/baseline3-shaped runs (the preset's algorithm /
    topology / optimizer, soak-scale synthetic data, and the mlp model,
    as dopt's gate runs them).  A monitor that cries wolf on a healthy
    run is worse than no monitor.  Returns {preset_name: HealthReport}."""
    import dataclasses

    from dopt_torch.obs import HealthMonitor, MemorySink, Telemetry, attach
    from dopt_torch.presets import PRESETS

    reports = {}
    for name in ("baseline1", "baseline3"):
        cfg = PRESETS[name]()
        cfg = dataclasses.replace(
            cfg,
            data=dataclasses.replace(
                cfg.data, synthetic_train_size=_DATA.synthetic_train_size,
                synthetic_test_size=_DATA.synthetic_test_size),
            model=_MODEL)
        if cfg.gossip is not None:
            cfg = dataclasses.replace(
                cfg, gossip=dataclasses.replace(
                    cfg.gossip, rounds=rounds, local_ep=1, local_bs=32))
            from dopt_torch.engine import GossipTrainer as Trainer
        else:
            cfg = dataclasses.replace(
                cfg, federated=dataclasses.replace(
                    cfg.federated, rounds=rounds, local_ep=1, local_bs=32))
            from dopt_torch.engine import FederatedTrainer as Trainer
        print(f"[clean] {name}: {rounds} rounds, stock rule set ...")
        trainer = Trainer(cfg, device=device)
        tele = Telemetry([MemorySink()])
        mon = HealthMonitor().attach(tele)   # stock default_rules()
        attach(trainer, tele, fresh=True)
        trainer.run(rounds=rounds)
        rep = mon.report()
        assert rep.alerts == 0 and rep.verdict == "healthy", \
            (f"false-positive gate: clean {name} run raised "
             f"{rep.alerts} alerts: {mon.canonical_alerts()}")
        print(f"[clean] {name}: verdict={rep.verdict}, 0 alerts ok")
        reports[name] = rep
    return reports


def divergence_gate(rounds: int, device=None):
    """Detection gate: a corrupt scale bomb (persistent adversaries
    blowing their update up 30x) against the UNDEFENDED mean
    aggregator must diverge the fleet — and the monitor's
    loss_divergence rule MUST fire before the run ends.  30x is the
    PROGRESSIVE regime: the loss rises finitely for a few rounds
    before overflowing, so the divergence rule (which needs a finite
    trailing median) catches it before the NaN does — a bigger bomb
    (1e3) jumps straight to non-finite and only loss_nonfinite can
    see it.  Returns the HealthReport."""
    from dopt_torch.engine import FederatedTrainer
    from dopt_torch.obs import HealthMonitor, MemorySink, Telemetry, attach

    cfg = ExperimentConfig(
        name="chaos-divergence-bomb", seed=7, data=_DATA, model=_MODEL,
        optim=_OPTIM,
        federated=FederatedConfig(algorithm="fedavg", frac=0.5,
                                  rounds=rounds, local_ep=1, local_bs=32),
        faults=FaultConfig(corrupt=1.0, corrupt_max=2,
                           corrupt_mode="scale", corrupt_scale=30.0))
    print(f"[divergence] scale bomb vs aggregator='mean': {rounds} "
          "rounds ...")
    trainer = FederatedTrainer(cfg, device=device)
    tele = Telemetry([MemorySink()])
    mon = HealthMonitor().attach(tele)
    attach(trainer, tele, fresh=True)
    trainer.run(rounds=rounds)
    rep = mon.report()
    fired = {a["rule"] for a in mon.alerts}
    assert "loss_divergence" in fired, \
        (f"divergence gate: the scale bomb did not fire loss_divergence "
         f"(fired: {sorted(fired)}; report {rep.to_dict()})")
    assert not rep.ok, f"divergence must be CRITICAL: {rep.to_dict()}"
    print(f"[divergence] fired {sorted(fired)} -> verdict "
          f"{rep.verdict} ok")
    return rep


def _sigkill_child(engine: str, seed: int, rounds: int, kill_at: int,
                   path: str, metrics_path: str | None = None,
                   device=None) -> None:
    """Spawn this module as a child running the soak config with
    per-round auto-checkpoints, SIGKILL it once it reports ``kill_at``
    completed rounds, and leave its latest checkpoint (and telemetry
    stream prefix — the JSONL sink flushes per event, so the kill
    leaves a complete prefix) for the caller."""
    cmd = [sys.executable, "-m", "dopt_torch.scripts.chaos_soak",
           "--child", engine, "--seed", str(seed), "--rounds", str(rounds),
           "--ckpt", os.path.abspath(path)]
    if metrics_path:
        cmd += ["--child-metrics", os.path.abspath(metrics_path)]
    if device is not None:
        cmd += ["--device", str(device)]
    child = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True,
                             cwd=_ROOT)
    try:
        for line in child.stdout:
            if line.startswith("ROUND "):
                done = int(line.split()[1]) + 1
                if done >= kill_at:
                    os.kill(child.pid, signal.SIGKILL)
                    break
    finally:
        child.stdout.close()
        child.wait()
    # Give the filesystem a beat; the checkpoint write itself is atomic
    # (temp dir + rename), so whatever is at `path` is complete.
    time.sleep(0.2)


def child_main(engine: str, seed: int, rounds: int, path: str,
               metrics_path: str | None = None, device=None) -> int:
    trainer = build_trainer(engine, seed, rounds, device=device)
    if metrics_path:
        from dopt_torch.obs import Telemetry, attach

        # resume=True: a fresh file starts at watermark 0, a restarted
        # child appends past what it already streamed.
        attach(trainer, Telemetry.to_jsonl(metrics_path, resume=True))
    for _ in range(rounds):
        trainer.run(rounds=1, checkpoint_every=1, checkpoint_path=path)
        print(f"ROUND {trainer.round - 1}", flush=True)
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m dopt_torch.scripts."
                                      "chaos_soak", description=__doc__)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0,
                    help="cocktail seed (each seed is a different storm)")
    ap.add_argument("--engine",
                    choices=["all", "both", "gossip", "gossip-async",
                             "gossip-codec", "federated"],
                    default="all",
                    help="'all' runs the sync-gossip, async-gossip, "
                         "codec-gossip and federated legs; 'both' is "
                         "the legacy sync-gossip + federated pair")
    ap.add_argument("--tol", type=float, default=0.0,
                    help="slack added to the final-loss-beats-first check")
    ap.add_argument("--kill", action="store_true",
                    help="kill-and-resume via a real SIGKILLed subprocess "
                         "instead of the in-process stop")
    ap.add_argument("--prefetch", action="store_true",
                    help="arm the prefetched host pipeline "
                         "(GossipConfig/FederatedConfig.prefetch='on') "
                         "on the blocked-parity trainer, so the soak's "
                         "bit-identity invariant exercises the staged "
                         "dispatch → stage-next → fetch path against "
                         "the unprefetched per-round trace")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint scratch dir (default: a temp dir)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="stream the continuous soak runs' telemetry "
                         "(dopt_torch.obs JSONL, one segment per engine) "
                         "here — the CI artifact; validate with "
                         "'python -m dopt_torch.obs.check PATH'")
    ap.add_argument("--report-out", default=None, metavar="PATH",
                    help="write the legs' HealthReports (cocktail "
                         "monitors + clean false-positive gate + "
                         "divergence gate) as one JSON artifact here")
    ap.add_argument("--skip-gates", action="store_true",
                    help="run only the cocktail legs (skip the clean "
                         "false-positive and divergence-detection "
                         "monitor gates)")
    ap.add_argument("--device", default=None,
                    help="torch device of every trainer (and of the "
                         "SIGKILL child); default cuda (raises without "
                         "one), 'cpu' for the CPU")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--ckpt", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--child-metrics", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.child:
        return child_main(args.child, args.seed, args.rounds, args.ckpt,
                          args.child_metrics, device=args.device)

    import tempfile

    engines = {"all": ["gossip", "gossip-async", "gossip-codec",
                       "federated"],
               "both": ["gossip", "federated"]}.get(args.engine,
                                                    [args.engine])
    metrics_sink = None
    if args.metrics_out:
        from dopt_torch.obs import JsonlSink

        metrics_sink = JsonlSink(args.metrics_out)
    reports = {}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt_dir = args.ckpt_dir or tmp
        for engine in engines:
            reports[f"cocktail_{engine}"] = soak_one(
                engine, args.seed, args.rounds, args.tol, ckpt_dir,
                args.kill, metrics_sink=metrics_sink,
                prefetch=args.prefetch, device=args.device)
    if not args.skip_gates:
        for name, rep in clean_baseline_gate(args.rounds,
                                             device=args.device).items():
            reports[f"clean_{name}"] = rep
        reports["divergence_bomb"] = divergence_gate(args.rounds,
                                                     device=args.device)
    if metrics_sink is not None:
        metrics_sink.close()
        print(f"wrote telemetry stream to {args.metrics_out}")
    if args.report_out:
        import json

        from dopt_torch.utils.metrics import atomic_write_text

        atomic_write_text(args.report_out, json.dumps(
            {k: r.to_dict() for k, r in reports.items()}, indent=2))
        print(f"wrote health reports to {args.report_out}")
    print("chaos soak passed: convergence + ledger + checkpoint + "
          "telemetry-stream + monitor invariants hold under the full "
          "cocktail")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
