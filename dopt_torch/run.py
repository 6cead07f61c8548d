"""CLI runner for the port: ``python -m dopt_torch.run --preset P``.

Picks a preset, applies ``--set path.to.field=value`` overrides, trains
it with ``SeqLMTrainer`` when the preset has a ``seqlm`` section (``--rounds``
then counts steps, default ``seqlm.steps``), with ``FederatedTrainer``
when it has a ``federated`` section and with ``GossipTrainer`` otherwise,
on the GPU (or on the CPU with
``--device cpu``), in blocks of the section's ``block_rounds``, prints
one JSON history row per round and optionally writes the History CSV in
the reference's results layout.  ``--checkpoint``, ``--checkpoint-every``
and ``--resume`` save and restore the whole training state (dopt's
flags): a run killed at any point and restarted with ``--resume`` is the
continuous run bit for bit.  ``--faults`` and ``--corrupt`` install a
fault config (dopt's spec syntax, ``dopt_torch.faults.parse_fault_spec``
and ``parse_corrupt_spec``), on either engine, and ``--faults-json`` writes
the run's fault ledger; ``--aggregator`` sets the federated server's
robust aggregator (dopt's flag: it installs a robust section before the
``--set`` overrides apply).  ``--metrics-out`` streams the run's telemetry
(``dopt_torch.obs``) as JSONL, appending from its round watermark under
``--resume``; ``--trace-out`` writes the host spans as a Chrome trace;
``--diagnostics on|off`` sets the section's on-card diagnostics; ``--trace
DIR`` writes a torch.profiler trace of the run (the counterpart of dopt's
XLA trace).  Async mixing is ``--set gossip.mixing=async``, as in dopt.
``--num-users`` and ``--synthetic-scale`` resize the fleet and the
synthetic sets after the overrides (dopt's order and floors), and
``--timers`` prints the phase-timer report.  ``--clients``, ``--cohort``
and ``--cohort-seed`` install or resize the client population (dopt's
flags and refusals).  The config goes to stderr first as dopt's
``exp_details`` writes it.  seqlm refuses ``--faults``, ``--clients``,
``--diagnostics``, ``--metrics-out``/``--trace-out`` and
``--checkpoint-every`` in dopt's words: its engine carries none of them.
``--set backend=torch`` trains the preset on the sequential reference
oracle (``dopt_torch.engine.torch_backend``), which refuses
``--faults``, ``--clients``, ``--metrics-out``/``--trace-out`` and
``--checkpoint-every`` in dopt's words, and ``--checkpoint`` raises
(the oracle does not save).

Across GPUs, one process a GPU under torchrun::

    python -m torch.distributed.run --nproc-per-node N -m dopt_torch.run \
        --preset P --set mesh_devices=N

(for seqlm the launched world is the sequence group: drop the
``mesh_devices`` override or set it to N).  Each process joins the NCCL
group from torchrun's variables
(``dopt_torch.parallel.multihost.initialize_distributed``) on
``cuda:LOCAL_RANK`` and holds W/N workers; with ``--device cpu`` the
ranks join over gloo on the CPU.  A ``LOCAL_RANK`` with no GPU of its own
raises: ranks that share one card run from Python over gloo
(``dopt_torch.parallel.init_file_group(..., backend="gloo")``).  Rank 0
alone prints the rows and writes the CSV, the ledger, the telemetry
stream and the traces; every rank takes part in a checkpoint (rank 0
writes it).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import pathlib
import re
import sys


def apply_override(cfg, spec: str):
    """``--set path.to.field=value``: frozen-dataclass field override by
    dotted path, the value coerced from the field's annotation (bool,
    int, float or str; 'none'/'null' for optional fields)."""
    path, eq, raw = spec.partition("=")
    if not eq:
        raise SystemExit(f"--set expects PATH=VALUE, got {spec!r}")
    parts = path.split(".")
    objs = [cfg]
    for p in parts[:-1]:
        nxt = getattr(objs[-1], p, None)
        if p not in {f.name for f in dataclasses.fields(objs[-1])} or \
                not dataclasses.is_dataclass(nxt):
            raise SystemExit(f"--set: {path!r} is not a field of this preset")
        objs.append(nxt)
    fields = {f.name: f for f in dataclasses.fields(objs[-1])}
    leaf = parts[-1]
    if leaf not in fields:
        raise SystemExit(f"--set: {path!r} is not a field of this preset")
    ann = str(fields[leaf].type)
    m = re.match(r"[A-Za-z_]+", ann.strip())
    primary = m.group(0) if m else ann
    if primary not in ("bool", "int", "float", "str"):
        raise SystemExit(f"--set: field {path!r} of type {ann!r} is not "
                         "settable from the CLI")
    try:
        if raw.lower() in ("none", "null") and "None" in ann:
            val = None
        elif primary == "bool":
            val = {"1": True, "true": True, "yes": True, "0": False,
                   "false": False, "no": False}[raw.lower()]
        else:
            val = {"int": int, "float": float, "str": str}[primary](raw)
    except (KeyError, ValueError):
        raise SystemExit(f"--set: {path!r} expects a {primary}, got {raw!r}")
    new = dataclasses.replace(objs[-1], **{leaf: val})
    for obj, name in zip(reversed(objs[:-1]), reversed(parts[:-1])):
        new = dataclasses.replace(obj, **{name: new})
    return new


def build_trainer(cfg, device=None):
    """The engine ``cfg`` asks for (dopt's ``build_trainer``), on
    ``device`` (the GPU when None): with ``backend="torch"`` the
    sequential reference oracle (``dopt_torch.engine.torch_backend``),
    else ``SeqLMTrainer`` when it has a ``seqlm`` section,
    ``FederatedTrainer`` when it has a ``federated`` one and
    ``GossipTrainer`` otherwise."""
    if cfg.backend not in ("jax", "torch"):
        raise ValueError(
            f"unknown backend {cfg.backend!r}; 'jax' (TPU/mesh engines) or "
            "'torch' (the sequential reference oracle)")
    if cfg.backend == "torch":
        from dopt_torch.engine.torch_backend import build_torch_trainer

        return build_torch_trainer(cfg, device=device)
    from dopt_torch.engine import FederatedTrainer, GossipTrainer, SeqLMTrainer

    if cfg.seqlm is not None:
        return SeqLMTrainer(cfg, device=device)
    if cfg.federated is not None:
        return FederatedTrainer(cfg, device=device)
    return GossipTrainer(cfg, device=device)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--preset", required=True,
                    help="preset name (see dopt_torch.presets) or 'list'")
    ap.add_argument("--rounds", type=int, default=None,
                    help="override the round count (default: the preset's "
                         "gossip.rounds or federated.rounds; seqlm: its "
                         "steps)")
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (raises without one)")
    ap.add_argument("--num-users", type=int, default=None)
    ap.add_argument("--synthetic-scale", type=float, default=None,
                    help="scale synthetic dataset sizes (e.g. 0.1 for "
                         "smoke); the train size stays at least 8 a "
                         "worker and the test size at least 64")
    ap.add_argument("--set", action="append", default=[], metavar="PATH=VAL",
                    dest="overrides",
                    help="override a config field by dotted path, e.g. "
                         "--set optim.lr=0.05")
    ap.add_argument("--csv", default=None, help="write the history CSV here")
    ap.add_argument("--checkpoint", default=None,
                    help="save a checkpoint here after the run")
    ap.add_argument("--checkpoint-every", type=int, default=0, metavar="K",
                    help="auto-checkpoint to --checkpoint every K rounds "
                         "during the run (crash-exact: a run killed at any "
                         "point and restarted with --resume is bit-identical "
                         "to a continuous run)")
    ap.add_argument("--resume", default=None,
                    help="restore this checkpoint before running (pair with "
                         "--checkpoint-every for kill-and-resume workflows)")
    ap.add_argument("--faults", default=None, metavar="SPEC",
                    help="inject deterministic faults: comma-separated "
                         "FaultConfig fields, e.g. 'crash=0.1,straggle=0.2,"
                         "straggle_frac=0.5,partition=0.05' or the lossy-"
                         "link/elastic knobs 'msg_drop=0.1,msg_delay=0.2,"
                         "msg_delay_max=2,churn=0.02,churn_span=4'; pair "
                         "asymmetric msg_drop with --set "
                         "gossip.correction=push_sum")
    ap.add_argument("--corrupt", default=None, metavar="SPEC",
                    help="inject Byzantine corruption (workers that lie): "
                         "'p=0.25,mode=signflip,scale=50,max=2' or a bare "
                         "probability; merges onto --faults.  Modes: "
                         "nan|inf|scale|signflip, and stale (federated "
                         "only: replay the previous update)")
    ap.add_argument("--aggregator", default=None,
                    choices=["mean", "trimmed_mean", "median", "krum",
                             "multi_krum"],
                    help="Byzantine-robust aggregation: how the federated "
                         "server combines the surviving updates (default "
                         "mean); tune with --set robust.trim_frac=... etc.  "
                         "The gossip engine's defense is clipped gossip: "
                         "'--aggregator mean --set robust.clip_radius=R' "
                         "(the flag installs the robust section)")
    ap.add_argument("--clients", type=int, default=None, metavar="N",
                    help="client population registry: sample each round's "
                         "cohort from N host-side client records instead "
                         "of equating workers with lanes; the federated "
                         "cohort trains in ceil(cohort/lanes) waves with "
                         "one bucketed reduce a round.  Pair with "
                         "--cohort/--cohort-seed; the lane width is --set "
                         "population.lanes=W on a population preset")
    ap.add_argument("--cohort", type=int, default=None, metavar="M",
                    help="clients sampled per round (default 64; requires "
                         "--clients or a population preset)")
    ap.add_argument("--cohort-seed", type=int, default=None, metavar="S",
                    help="cohort-sampler seed (default: the experiment "
                         "seed); draws are stateless per (seed, round)")
    ap.add_argument("--faults-json", default=None, metavar="PATH",
                    help="write the run's fault ledger here as JSON")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="stream telemetry (dopt_torch.obs) to this JSONL "
                         "file: per-round 'round' events (the history row), "
                         "typed 'fault' events (the ledger), 'gauge' events "
                         "(quarantine/staleness state, the diagnostics, the "
                         "end-of-run consensus distance).  With --resume the "
                         "stream appends from its round watermark; check it "
                         "with 'python -m dopt_torch.obs.check PATH'")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome-trace/Perfetto JSON of the host "
                         "spans (batch planning, the round or block up to "
                         "its fetch, checkpoint writes) here")
    ap.add_argument("--diagnostics", choices=("off", "on"), default=None,
                    help="per-round on-card diagnostics (the section's "
                         "diagnostics): 'on' emits update/grad/param norms, "
                         "the lane-loss mean and spread and the consensus "
                         "distance / lane dispersion as gauges, plus "
                         "device-memory 'resource' and graph-capture "
                         "'compile' events, into --metrics-out; default "
                         "keeps the preset's setting")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the run into DIR "
                         "(trace.json; Perfetto or chrome://tracing)")
    ap.add_argument("--timers", action="store_true",
                    help="print the phase-timer report (dopt's columns)")
    args = ap.parse_args(argv)

    from dopt_torch.config import exp_details
    from dopt_torch.presets import PRESETS, get_preset

    if args.preset == "list":
        for name in sorted(PRESETS):
            print(name)
        return 0
    if args.checkpoint_every and not args.checkpoint:
        raise SystemExit("--checkpoint-every requires --checkpoint PATH")
    cfg = get_preset(args.preset)
    if args.aggregator:
        # Installed before --set, so '--aggregator krum --set
        # robust.krum_f=2' works on a preset without a robust section.
        from dopt_torch.config import RobustConfig

        cfg = cfg.replace(robust=dataclasses.replace(
            cfg.robust or RobustConfig(), aggregator=args.aggregator))
    for spec in args.overrides:
        cfg = apply_override(cfg, spec)
    if args.faults:
        from dopt_torch.faults import parse_fault_spec

        try:
            cfg = cfg.replace(faults=parse_fault_spec(args.faults))
        except ValueError as e:
            raise SystemExit(str(e))
    if args.corrupt:
        from dopt_torch.faults import parse_corrupt_spec

        try:
            cfg = cfg.replace(
                faults=parse_corrupt_spec(args.corrupt, base=cfg.faults))
        except ValueError as e:
            raise SystemExit(str(e))
    if cfg.faults is not None and (cfg.seqlm is not None
                                   or cfg.backend == "torch"):
        # dopt's words: the oracle and the seqlm engine never read
        # cfg.faults.
        raise SystemExit("fault injection is supported by the "
                         "federated/gossip jax engines only")
    if (args.clients is not None or args.cohort is not None
            or args.cohort_seed is not None):
        from dopt_torch.config import PopulationConfig
        from dopt_torch.population import validate_population_config

        base_pop = cfg.population
        if args.clients is None and base_pop is None:
            raise SystemExit("--cohort/--cohort-seed need --clients N (or "
                             "a preset with a population section)")
        pop_kw = {}
        if args.clients is not None:
            pop_kw["clients"] = args.clients
        if args.cohort is not None:
            pop_kw["cohort"] = args.cohort
        if args.cohort_seed is not None:
            pop_kw["seed"] = args.cohort_seed
        pop = dataclasses.replace(base_pop or PopulationConfig(), **pop_kw)
        try:
            validate_population_config(pop)
        except ValueError as e:
            raise SystemExit(str(e))
        cfg = cfg.replace(population=pop)
    if cfg.population is not None and (cfg.seqlm is not None
                                       or cfg.backend == "torch"):
        raise SystemExit("the client population registry is supported by "
                         "the federated/gossip jax engines only")
    if args.diagnostics is not None:
        name = ("federated" if cfg.federated is not None else
                "gossip" if cfg.gossip is not None else None)
        if name is None:
            raise SystemExit("--diagnostics is supported by the "
                             "federated/gossip jax engines only")
        cfg = cfg.replace(**{name: dataclasses.replace(
            getattr(cfg, name), diagnostics=args.diagnostics)})
    if args.num_users is not None:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data,
                                                   num_users=args.num_users))
    if args.synthetic_scale is not None:
        d = cfg.data
        cfg = cfg.replace(data=dataclasses.replace(
            d, synthetic_train_size=max(
                int(d.synthetic_train_size * args.synthetic_scale),
                d.num_users * 8),
            synthetic_test_size=max(
                int(d.synthetic_test_size * args.synthetic_scale), 64)))
    device, rank = _join_launch(args.device)
    lead = rank in (None, 0)
    if lead:
        print(exp_details(cfg), file=sys.stderr)
    try:
        return _train(args, cfg, device, lead)
    finally:
        if rank is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


def _join_launch(device: str | None) -> tuple[str | None, int | None]:
    """Under torchrun, join the default process group — NCCL on
    ``cuda:LOCAL_RANK``, or gloo with ``--device cpu`` — and return
    (this rank's device, its rank); otherwise (device, None)."""
    from dopt_torch.parallel.multihost import (initialize_distributed,
                                               launch_env)

    env = launch_env()
    if env is None or env["world_size"] <= 1:
        return device, None
    import torch

    on_cpu = device is not None and torch.device(device).type == "cpu"
    if not on_cpu:
        visible = torch.cuda.device_count()
        if env["local_rank"] >= visible:
            raise ValueError(
                f"LOCAL_RANK={env['local_rank']} has no GPU of its own "
                f"({visible} visible): NCCL runs one rank a GPU.  Ranks "
                "that share a card run from Python over gloo: "
                "dopt_torch.parallel.init_file_group(dir, rank, world, "
                "backend='gloo', num_workers=W) in each process, or "
                "dopt_torch.parallel.spawn_ranks(fn, world, dir)")
        torch.cuda.set_device(env["local_rank"])
        device = f"cuda:{env['local_rank']}"
    initialize_distributed(backend="gloo" if on_cpu else "nccl")
    return device, env["rank"]


def _train(args, cfg, device, lead: bool) -> int:
    # Rank 0 alone reports.
    say = (functools.partial(print, file=sys.stderr) if lead
           else lambda *a, **k: None)
    if cfg.backend == "torch" and cfg.seqlm is None:
        # dopt's refusals: the oracle carries no telemetry and no
        # in-run checkpoints.
        if args.metrics_out or args.trace_out:
            raise SystemExit("--metrics-out/--trace-out are supported by "
                             "the federated/gossip jax engines only")
        if args.checkpoint_every:
            raise SystemExit("--checkpoint-every is supported by the "
                             "federated/gossip jax engines only")
        trainer = build_trainer(cfg, device)
        section = cfg.federated or cfg.gossip
        rounds = section.rounds if args.rounds is None else args.rounds
        say(f"{cfg.name}: {type(trainer).__name__} (backend='torch', the "
            f"sequential reference oracle) on {trainer.device}, "
            f"{trainer.num_workers} workers, {rounds} rounds")
        run = functools.partial(trainer.run, rounds=rounds)
    elif cfg.seqlm is not None:
        # dopt's refusals: its seqlm engine carries no telemetry and no
        # in-run checkpoints.
        if args.metrics_out or args.trace_out:
            raise SystemExit("--metrics-out/--trace-out are supported by "
                             "the federated/gossip jax engines only")
        if args.checkpoint_every:
            raise SystemExit("--checkpoint-every is supported by the "
                             "federated/gossip jax engines only")
        trainer = build_trainer(cfg, device)
        s = cfg.seqlm
        rounds = s.steps if args.rounds is None else args.rounds
        say(f"{cfg.name}: SeqLMTrainer on {trainer.device}, "
            f"{trainer.param_count} params, {s.attn} attention over "
            f"{trainer.group.size} rank(s) of {trainer.block} positions, "
            f"compute {cfg.model.compute_dtype}, {rounds} steps of "
            f"{s.batch}×{s.seq_len} tokens")
        run = functools.partial(trainer.run, rounds=rounds)
    else:
        trainer = build_trainer(cfg, device)
        section = cfg.federated or cfg.gossip
        rounds = section.rounds if args.rounds is None else args.rounds
        say(f"{cfg.name}: {type(trainer).__name__} on {trainer.device}, "
            f"compute {cfg.model.compute_dtype}, storage "
            f"{cfg.model.param_dtype}, clip_norm {cfg.optim.clip_norm}, "
            f"{rounds} rounds in blocks of {max(section.block_rounds, 1)}, "
            f"prefetch {section.prefetch}, {trainer.group.size} rank(s) of "
            f"{trainer.lanes} lanes")
        run = functools.partial(trainer.run, rounds=rounds,
                                checkpoint_every=args.checkpoint_every,
                                checkpoint_path=args.checkpoint)
    if args.resume:
        trainer.restore(args.resume)
        say(f"resumed at round {trainer.round}")
    before = len(trainer.history.rows)
    tele = None
    if args.metrics_out or args.trace_out:
        from dopt_torch.obs import Telemetry, attach

        # Every rank emits (the stream's gauges may gather across ranks);
        # rank 0 alone writes.
        tele = (Telemetry.to_jsonl(args.metrics_out,
                                   resume=bool(args.resume))
                if args.metrics_out and lead else Telemetry())
        attach(trainer, tele,
               checkpoint_every=args.checkpoint_every or None)
    if args.trace:
        from dopt_torch.utils.profiling import trace

        # Rank 0 alone traces.
        with trace(args.trace) if lead else contextlib.nullcontext():
            run()
        if lead:
            say(f"wrote torch.profiler trace to "
                f"{pathlib.Path(args.trace) / 'trace.json'}")
    else:
        run()
    if lead:
        for row in trainer.history.rows[before:]:
            print(json.dumps(row))
    say(f"device={trainer.device} total_time_s={trainer.total_time:.2f}")
    if args.timers and lead:
        say(trainer.timers.report())
    if args.csv and lead:
        trainer.history.to_csv(args.csv)
        say(f"wrote {args.csv}")
    if args.faults_json and lead:
        trainer.history.faults_to_json(args.faults_json)
        say(f"wrote {len(trainer.history.faults)} fault-ledger rows to "
            f"{args.faults_json}")
    if args.checkpoint:
        trainer.save(args.checkpoint)
        say(f"checkpointed to {args.checkpoint}")
    if tele is not None:
        # Closed after the last save: a save emits a checkpoint event.
        tele.close()
        if args.metrics_out and lead:
            say(f"wrote telemetry stream to {args.metrics_out}")
        if args.trace_out and lead:
            tele.write_trace(args.trace_out)
            say(f"wrote host span trace to {args.trace_out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
