"""Program-fingerprint gate: ``python -m dopt_torch.analysis.fingerprint``.

The port's copy of dopt's gate (dopt/analysis/fingerprint.py).  Every
default-off knob ships with the same promise: "off runs the exact
pre-change program".  dopt pins its programs by hashing the lowered
StableHLO of each canonical round; the port's program is the stream of
ATen operators a round dispatches.  This gate runs one round of each
config of dopt's canonical matrix — both engines, dopt's tiny CPU sizes,
``baseline1-tiny``, ``baseline3-tiny-full`` and
``baseline3-tiny-compact`` — under a ``TorchDispatchMode`` that records
each op as its overload, the dtypes and shapes of its tensor arguments
and results, and its other arguments (numbers, dtypes, devices; no
tensor values and no addresses), one line an op; it hashes the stream
(sha256) and diffs the hashes against the committed
``dopt_torch/analysis/program_fingerprints.json``.

* A change that does not touch the default path leaves every hash
  intact.
* A change to what the default round runs (a new op, a knob that leaks
  into the off path, a changed constant such as the learning rate)
  flips a hash and FAILS until it is blessed: ``--bless --reason "<why
  the default program legitimately changed>"`` rewrites the registry
  with the reason recorded.

The stream depends on the environment (torch's version, the device,
the thread count), so the registry records the environment it was
blessed under; on a mismatch the gate SKIPS (exit 0, reported) unless
``--strict``.

Exit codes: 0 clean/skipped, 1 drift, 2 usage error; ``--json`` prints
the machine-readable report.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import sys
from pathlib import Path
from typing import Any, Callable, Mapping

from dopt_torch.analysis.common import (EXIT_CLEAN, EXIT_USAGE, Finding,
                                        emit_report)

DEFAULT_REGISTRY = "dopt_torch/analysis/program_fingerprints.json"

# dopt's tiny-shape overrides: the fingerprint pins the program's
# structure (ops, routing, constants the config bakes in), not the
# workload's scale.
_TINY_TRAIN, _TINY_TEST = 256, 64


def _tiny(cfg):
    return cfg.replace(data=dataclasses.replace(
        cfg.data, dataset="synthetic", data_dir=None,
        synthetic_train_size=_TINY_TRAIN, synthetic_test_size=_TINY_TEST))


def canonical_matrix() -> dict[str, Callable[[], Any]]:
    """dopt's default-off config matrix, name → config builder:
    baseline1 runs the gossip dense consensus round, baseline3 the
    federated engine on both of its paths (frac=1 → the full-width
    round; its preset's frac=0.5 → the compact round)."""
    from dopt_torch.presets import (baseline_1_ring_mnist_mlp,
                                    baseline_3_fedavg_noniid)

    def b1():
        return _tiny(baseline_1_ring_mnist_mlp())

    def b3_full():
        cfg = _tiny(baseline_3_fedavg_noniid())
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, num_users=4))
        return cfg.replace(federated=dataclasses.replace(cfg.federated,
                                                         frac=1.0))

    def b3_compact():
        cfg = _tiny(baseline_3_fedavg_noniid())
        return cfg.replace(data=dataclasses.replace(cfg.data, num_users=4))

    return {"baseline1-tiny": b1,
            "baseline3-tiny-full": b3_full,
            "baseline3-tiny-compact": b3_compact}


def _arg(x) -> str:
    """One op argument as it enters the fingerprint: a tensor by dtype
    and shape, a number, string, dtype, device or layout by value, a
    sequence element by element, anything else by its type's name."""
    import torch

    if isinstance(x, torch.Tensor):
        return f"{str(x.dtype).removeprefix('torch.')}{list(x.shape)}"
    if isinstance(x, (list, tuple)):
        return "(" + ",".join(_arg(v) for v in x) + ")"
    if x is None or isinstance(x, (bool, int, float, str)):
        return repr(x)
    if isinstance(x, (torch.dtype, torch.device, torch.layout,
                      torch.memory_format)):
        return str(x)
    return type(x).__name__


def op_stream(fn: Callable[[], Any]) -> list[str]:
    """The ATen ops ``fn()`` dispatches, one canonical line each:
    ``overload(args; kwargs) -> results``."""
    from torch.utils._python_dispatch import TorchDispatchMode

    lines: list[str] = []

    class _Recorder(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            kw = ",".join(f"{k}={_arg(v)}" for k, v in sorted(kwargs.items()))
            lines.append(f"{func}({','.join(_arg(a) for a in args)};{kw})"
                         f"->{_arg(out)}")
            return out

    with _Recorder():
        fn()
    return lines


def current_env() -> dict[str, Any]:
    """The fingerprint's environment key: torch's version, the device
    the rounds run on and torch's intra-op thread count."""
    import torch

    return {"torch": torch.__version__, "device": "cpu",
            "threads": torch.get_num_threads()}


def _round_program(cfg) -> tuple[str, str, Callable[[], Any]]:
    """(engine, the kind of round, a callable running round 0) of a
    fresh trainer on the CPU."""
    if cfg.gossip is not None:
        from dopt_torch.engine.gossip import GossipTrainer

        tr = GossipTrainer(cfg, device="cpu")
        return "gossip", "round", lambda: tr.run(rounds=1)
    from dopt_torch.engine.federated import FederatedTrainer

    tr = FederatedTrainer(cfg, device="cpu")
    kind = "compact" if tr._use_compact() else "full"
    return "federated", kind, lambda: tr.run(rounds=1)


def compute_fingerprints(
        configs: Mapping[str, Callable[[], Any]] | None = None,
) -> dict[str, dict[str, Any]]:
    """Run round 0 of each config on a fresh trainer and hash its
    canonical op stream."""
    configs = canonical_matrix() if configs is None else configs
    out: dict[str, dict[str, Any]] = {}
    for name in sorted(configs):
        engine, kind, run = _round_program(configs[name]())
        text = "\n".join(op_stream(run)) + "\n"
        out[name] = {
            "engine": engine,
            "fn": kind,
            "sha256": hashlib.sha256(text.encode()).hexdigest(),
            "ops": text.count("\n"),
        }
    return out


def diff(current: Mapping[str, dict], committed: Mapping[str, dict],
         registry_path: str) -> list[Finding]:
    findings: list[Finding] = []
    for name in sorted(set(current) - set(committed)):
        findings.append(Finding(
            "fingerprint-new", registry_path, 0,
            f"{name}: canonical program not in the registry — bless it "
            f"(--bless --reason ...)"))
    for name in sorted(set(committed) - set(current)):
        findings.append(Finding(
            "fingerprint-removed", registry_path, 0,
            f"{name}: registered program no longer in the canonical "
            f"matrix — bless the removal"))
    for name in sorted(set(current) & set(committed)):
        cur, old = current[name], committed[name]
        if cur["sha256"] != old["sha256"]:
            findings.append(Finding(
                "fingerprint-mismatch", registry_path, 0,
                f"{name} ({cur['engine']}/{cur['fn']}): the DEFAULT "
                f"round program changed — {old['sha256'][:12]} → "
                f"{cur['sha256'][:12]} ({old['ops']} → {cur['ops']} "
                f"ops).  If intended, re-bless with --bless --reason "
                f"'<why>'"))
        elif (cur["fn"], cur["engine"]) != (old["fn"], old["engine"]):
            findings.append(Finding(
                "fingerprint-mismatch", registry_path, 0,
                f"{name}: dispatch routing changed "
                f"({old['engine']}/{old['fn']} → "
                f"{cur['engine']}/{cur['fn']})"))
    return findings


def load_registry(path: str | Path) -> dict[str, Any] | None:
    try:
        return json.loads(Path(path).read_text())
    except (OSError, ValueError):
        return None


def write_registry(path: str | Path, fingerprints: Mapping[str, dict],
                   env: Mapping[str, Any], reason: str) -> None:
    doc = {"v": 1, "env": dict(env), "bless": {"reason": reason},
           "fingerprints": {k: dict(v)
                            for k, v in sorted(fingerprints.items())}}
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dopt_torch.analysis.fingerprint",
        description="Off-path program-fingerprint gate for the port's "
                    "canonical default rounds.")
    ap.add_argument("names", nargs="*", metavar="NAME",
                    help="subset of canonical programs to check "
                         "(default: all)")
    ap.add_argument("--registry", default=DEFAULT_REGISTRY,
                    help=f"committed registry (default: "
                         f"{DEFAULT_REGISTRY})")
    ap.add_argument("--bless", action="store_true",
                    help="regenerate the registry from the current "
                         "tree (requires --reason)")
    ap.add_argument("--reason", default="",
                    help="justification recorded with --bless — why "
                         "the default programs legitimately changed")
    ap.add_argument("--strict", action="store_true",
                    help="fail (instead of skip) on environment "
                         "mismatch with the blessed registry")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
    args = ap.parse_args(argv)
    if args.bless and not args.reason.strip():
        print("--bless requires --reason '<why the default programs "
              "changed>'", file=sys.stderr)
        return EXIT_USAGE
    matrix = canonical_matrix()
    if args.names:
        unknown = set(args.names) - set(matrix)
        if unknown:
            print(f"unknown program(s): {', '.join(sorted(unknown))}; "
                  f"canonical: {', '.join(sorted(matrix))}",
                  file=sys.stderr)
            return EXIT_USAGE
        matrix = {k: matrix[k] for k in args.names}

    env = current_env()
    if args.bless:
        if set(matrix) != set(canonical_matrix()):
            # Partial bless: merge over the committed registry — sound
            # only when its entries were blessed under THIS environment.
            old = load_registry(args.registry) or {"fingerprints": {}}
            if old.get("fingerprints") and old.get("env") != env:
                print(
                    f"partial bless refused: {args.registry} is "
                    f"blessed under {old.get('env')}, this is {env} — "
                    "merging would stamp stale hashes with the wrong "
                    "env.  Bless the full matrix instead (no NAME "
                    "args).", file=sys.stderr)
                return EXIT_USAGE
            fps = dict(old.get("fingerprints", {}))
            fps.update(compute_fingerprints(matrix))
        else:
            fps = compute_fingerprints(matrix)
        write_registry(args.registry, fps, env, args.reason.strip())
        print(f"blessed {len(fps)} fingerprint(s) into "
              f"{args.registry} (reason: {args.reason.strip()})")
        return EXIT_CLEAN

    committed = load_registry(args.registry)
    tool = "dopt_torch.analysis.fingerprint"
    if committed is None:
        return emit_report(
            [Finding("registry-missing", args.registry, 0,
                     "no committed fingerprint registry — run "
                     "`python -m dopt_torch.analysis.fingerprint --bless "
                     "--reason 'initial registry'`")],
            as_json=args.json, tool=tool, checked=0, unit="program")
    if committed.get("env") != env:
        skip = {"status": "skipped", "reason": "environment mismatch",
                "blessed_env": committed.get("env"), "current_env": env}
        if args.strict:
            return emit_report(
                [Finding("environment-mismatch", args.registry, 0,
                         f"registry blessed under "
                         f"{committed.get('env')}, running under "
                         f"{env}")],
                as_json=args.json, tool=tool, checked=0, unit="program",
                extra=skip)
        if args.json:
            return emit_report([], as_json=True, tool=tool, checked=0,
                               unit="program", extra=skip)
        print(f"{tool}: SKIPPED — environment mismatch (registry blessed "
              f"under {committed.get('env')}, running under {env}); 0 "
              "programs compared.  Use --strict to fail instead.")
        return EXIT_CLEAN
    fps = compute_fingerprints(matrix)
    committed_fps = committed.get("fingerprints", {})
    if args.names:
        committed_fps = {k: v for k, v in committed_fps.items()
                         if k in args.names}
    return emit_report(diff(fps, committed_fps, args.registry),
                       as_json=args.json, tool=tool, checked=len(fps),
                       unit="program", extra={"fingerprints": fps})


if __name__ == "__main__":
    raise SystemExit(main())
