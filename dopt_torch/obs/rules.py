"""Declarative health rules over the telemetry event stream.

A rule is a small pure state machine: it consumes one event at a time
(``update(event, ctx)``) and returns zero or more alert payloads.  All
mutable rule state lives in ``rule.s`` — a plain JSON-able dict — so a
monitor can checkpoint and resume mid-stream (``HealthMonitor.state``)
and a resumed tail replays to the exact same alert sequence.

Determinism contract: rules read only the deterministic event kinds
(``round``/``gauge``/``fault``), the ``run`` segment headers, and the
(non-deterministic but cadence-only) ``checkpoint`` markers.  Because
per-round, fused-blocked and killed-and-resumed execution emit
bit-identical deterministic streams (dopt_torch.obs), the alert sequence a
rule set produces is identical across execution paths of the same run
— pinned by tests/test_monitor.py and the chaos soak.

Firing is EDGE-TRIGGERED: a rule alerts when its condition first
becomes true and re-arms once the condition clears, so a 10k-round run
sitting in one bad regime yields one alert per episode, not 10k.

The rule set is declarative: ``build_rules([{"rule": "loss_divergence",
"factor": 2.0}, ...])`` instantiates from the ``RULES`` registry, and
``default_rules()`` is the conservative stock set (tuned to stay silent
on clean baseline runs — the chaos soak's false-positive gate).

Stdlib-only (no torch/numpy): the monitor must run anywhere the checker
does — laptops tailing a scp'd metrics file included.
"""

from __future__ import annotations

import statistics
from typing import Any

# Loss-key detection order: gossip rows carry avg_train_loss every
# round; federated rows carry train_loss (P1 schema); local_loss/loss
# are fallbacks for producer events outside the engines.
LOSS_KEYS = ("avg_train_loss", "train_loss", "local_loss", "loss")

SEVERITIES = ("warn", "critical")

# Fault-ledger kinds that mean "this worker's round contribution was
# lost" — the numerator of the drop-rate SLO.  Screening/quarantine
# rows are defenses doing their job, not losses, and get their own rule.
DROP_KINDS = ("crash", "straggle", "msg_drop", "partition", "churn")


def loss_of(metrics: dict) -> tuple[str | None, Any]:
    """(key, value) of the first known loss key present; value None
    means the producer sanitized a non-finite loss into null."""
    for k in LOSS_KEYS:
        if k in metrics:
            return k, metrics[k]
    return None, None


class RunContext:
    """What the monitor knows about the run segment being consumed:
    filled from ``run`` headers and denominator gauges, read by rules
    that need fleet-size denominators."""

    def __init__(self, workers: int | None = None):
        self.engine: str | None = None
        self.workers = workers
        self.cohort: float | None = None       # population cohort_size gauge
        self.population: float | None = None   # population_size gauge
        self.participating: float | None = None  # participating_lanes gauge
        # Configured checkpoint cadence in rounds: stamped on the run
        # header (serve daemons and --checkpoint-every runs) and
        # updated live by control events that change it — the
        # checkpoint_cadence rule's expected-cadence source.
        self.checkpoint_every: int | None = None
        self.round: int = -1

    def denominator(self) -> float | None:
        """Per-round participant denominator: the cohort size when a
        population registry is driving sampling, else the LIVE
        participating-lane count (lanes minus quarantined — the
        engines emit it every round), else the static lane count."""
        if self.cohort:
            return float(self.cohort)
        if self.participating:
            return float(self.participating)
        return float(self.workers) if self.workers else None


class Rule:
    """Base rule: subclasses set ``name``/``severity``, keep ALL
    mutable state in ``self.s`` (JSON-able), and implement
    ``update``."""

    name = "rule"
    severity = "warn"

    def __init__(self) -> None:
        self.s: dict[str, Any] = {}
        self.reset()

    def reset(self) -> None:
        """New logical run segment: drop windowed state, re-arm."""
        self.s = {"armed": True}

    def edge(self, violated: bool) -> bool:
        """Edge-trigger helper: True exactly once per violation
        episode; re-arms when the condition clears."""
        if violated and self.s.get("armed", True):
            self.s["armed"] = False
            return True
        if not violated:
            self.s["armed"] = True
        return False

    def update(self, ev: dict, ctx: RunContext) -> list[dict]:
        raise NotImplementedError  # pragma: no cover


class NonFiniteLossRule(Rule):
    """Loss went NaN/Inf (the producer sanitizes non-finite metrics to
    null, so a null loss after any finite one IS the NaN signal)."""

    name = "loss_nonfinite"
    severity = "critical"

    def update(self, ev: dict, ctx: RunContext) -> list[dict]:
        if ev.get("kind") != "round":
            return []
        key, v = loss_of(ev.get("metrics", {}))
        if key is None:
            return []
        if v is not None:
            self.s["seen_finite"] = True
        bad = v is None and self.s.get("seen_finite", False)
        if self.edge(bad):
            return [{"round": ev["round"],
                     "message": f"{key} is non-finite at round "
                                f"{ev['round']} (training diverged)"}]
        return []


class LossDivergenceRule(Rule):
    """Loss blew past ``factor`` × the trailing-window median (plus an
    absolute ``min_delta`` guard so near-zero-loss jitter cannot trip
    the ratio).  A non-finite loss counts as divergence too — +inf is
    past every threshold."""

    name = "loss_divergence"
    severity = "critical"

    def __init__(self, window: int = 8, factor: float = 3.0,
                 min_delta: float = 0.5, min_history: int = 3):
        self.window = int(window)
        self.factor = float(factor)
        self.min_delta = float(min_delta)
        self.min_history = int(min_history)
        super().__init__()

    def reset(self) -> None:
        self.s = {"armed": True, "hist": []}

    def update(self, ev: dict, ctx: RunContext) -> list[dict]:
        if ev.get("kind") != "round":
            return []
        key, v = loss_of(ev.get("metrics", {}))
        if key is None:
            return []
        hist = self.s["hist"]
        out: list[dict] = []
        if len(hist) >= self.min_history:
            med = statistics.median(hist)
            bar = self.factor * med + self.min_delta
            cur = float("inf") if v is None else float(v)
            if self.edge(cur > bar):
                shown = "inf" if v is None else f"{cur:.4g}"
                out.append({"round": ev["round"], "value": None if v is None
                            else cur,
                            "message": f"{key}={shown} at round "
                                       f"{ev['round']} exceeds "
                                       f"{self.factor}x trailing median "
                                       f"({med:.4g})"})
        if v is not None:
            hist.append(float(v))
            del hist[:-self.window]
        return out


class ConsensusStallRule(Rule):
    """The fleet-disagreement meter (``consensus_distance``) is RISING
    across ``patience``+1 consecutive observations by more than ``tol``
    relative — mixing is not contracting (partitioned topology,
    mis-weighted matrix, or adversaries pulling the fleet apart).

    Observation sources: the ``consensus_distance`` gauge — with
    ``diagnostics="on"`` the gossip engine emits a TRUE per-round one
    inside every round bundle (the rule finally gets more than one
    observation per ``run()`` call), otherwise the engines emit one
    per ``run()`` call — the federated engine's per-round
    ``lane_dispersion`` gauge (its diagnostics-mode dispersion meter;
    a stream carries one of the two names, never both) — and, with
    ``use_checkpoints=True`` — the ``consensus_distance`` field each
    ``checkpoint`` event carries (one per save, so a long soak with
    ``--checkpoint-every K`` observes every K rounds).  The checkpoint
    source is OPT-IN because checkpoint timing is call-pattern state:
    rules reading it trade the cross-execution-path alert-identity
    guarantee for cadence, exactly like ``checkpoint_cadence``."""

    name = "consensus_stall"
    severity = "warn"

    def __init__(self, patience: int = 3, tol: float = 0.25,
                 use_checkpoints: bool = False):
        self.patience = int(patience)
        self.tol = float(tol)
        self.use_checkpoints = bool(use_checkpoints)
        super().__init__()

    def reset(self) -> None:
        self.s = {"armed": True, "hist": []}

    def update(self, ev: dict, ctx: RunContext) -> list[dict]:
        kind = ev.get("kind")
        # lane_dispersion is the federated engine's dispersion meter
        # (mean_i ||p_i - theta||, diagnostics="on") — the same
        # is-the-fleet-contracting signal under another name; a stream
        # only ever carries one of the two, so one window serves both.
        if kind == "gauge" and ev.get("name") in ("consensus_distance",
                                                  "lane_dispersion"):
            v = ev["value"]
        elif (kind == "checkpoint" and self.use_checkpoints
              and isinstance(ev.get("consensus_distance"), (int, float))):
            v = ev["consensus_distance"]
        else:
            return []
        hist = self.s["hist"]
        hist.append(float(v))
        del hist[:-(self.patience + 1)]
        rising = (len(hist) == self.patience + 1
                  and all(b >= a for a, b in zip(hist, hist[1:]))
                  and hist[-1] > hist[0] * (1.0 + self.tol))
        if self.edge(rising):
            return [{"round": ev["round"], "value": hist[-1],
                     "message": f"consensus_distance rose "
                                f"{hist[0]:.4g} -> {hist[-1]:.4g} over "
                                f"{self.patience + 1} observations "
                                "(mixing is not contracting)"}]
        return []


class GradExplosionRule(Rule):
    """A convergence-diagnostic norm gauge (``grad_norm`` — the carried
    momentum/velocity — or ``update_norm``, the round's parameter
    displacement; both emitted per round by ``diagnostics="on"``) blew
    past ``factor`` × its trailing-window median plus the absolute
    ``min_delta`` guard: gradients are exploding, usually rounds before
    the loss shows it (the loss_divergence rule's trailing median needs
    the damage to reach the objective first).  Reads only ``gauge``
    events — deterministic, so the alert sequence stays identical
    across execution paths.  Each watched gauge keeps its own window
    and edge state."""

    name = "grad_explosion"
    severity = "critical"

    def __init__(self, window: int = 8, factor: float = 10.0,
                 min_delta: float = 1.0, min_history: int = 3,
                 gauges: tuple[str, ...] = ("grad_norm", "update_norm")):
        self.window = int(window)
        self.factor = float(factor)
        self.min_delta = float(min_delta)
        self.min_history = int(min_history)
        self.gauges = tuple(gauges)
        super().__init__()

    def reset(self) -> None:
        self.s = {"armed": {}, "hist": {}}

    def _edge_key(self, key: str, violated: bool) -> bool:
        armed = self.s["armed"]
        if violated and armed.get(key, True):
            armed[key] = False
            return True
        if not violated:
            armed[key] = True
        return False

    def update(self, ev: dict, ctx: RunContext) -> list[dict]:
        if ev.get("kind") != "gauge" or ev.get("name") not in self.gauges:
            return []
        name = str(ev["name"])
        v = float(ev["value"])
        hist = self.s["hist"].setdefault(name, [])
        out: list[dict] = []
        if len(hist) >= self.min_history:
            med = statistics.median(hist)
            bar = self.factor * med + self.min_delta
            if self._edge_key(name, v > bar):
                out.append({"round": ev["round"], "value": v,
                            "message": f"{name}={v:.4g} at round "
                                       f"{ev['round']} exceeds "
                                       f"{self.factor}x trailing median "
                                       f"({med:.4g}) — gradient "
                                       "explosion"})
        hist.append(v)
        del hist[:-self.window]
        return out


class RetraceStormRule(Rule):
    """The compiled round functions are retracing as the run goes: a
    ``compile`` event (``diagnostics="on"`` emits one whenever a round
    function's trace cache grew) landed at more than ``max_rounds``
    DISTINCT rounds inside the trailing ``window`` rounds.  Healthy
    runs compile each round program once at warmup (1-2 distinct
    rounds); a compile per round means a shape/dtype is leaking into
    the trace (survivor counts as shapes, a drifting remainder block)
    and every round pays a recapture.  ``compile`` is a
    NON-deterministic kind, so like checkpoint_cadence this rule trades
    the hard cross-execution-path alert-identity guarantee for the
    signal; to keep healthy paths IDENTICAL in practice the window is
    SEGMENT-scoped — every ``run`` header (resume continuations
    included) clears it, so a killed-and-resumed run's second warmup
    reads as a fresh segment's warmup, not as half a storm."""

    name = "retrace_storm"
    severity = "warn"

    def __init__(self, window: int = 8, max_rounds: int = 3):
        self.window = int(window)
        self.max_rounds = int(max_rounds)
        super().__init__()

    def reset(self) -> None:
        self.s = {"armed": True, "rounds": []}

    def update(self, ev: dict, ctx: RunContext) -> list[dict]:
        if ev.get("kind") == "run":
            # The monitor only resets rules on round-0 headers; this
            # rule's window is meaningless across a process restart, so
            # it also clears on resume CONTINUATION headers.
            self.reset()
            return []
        if ev.get("kind") != "compile":
            return []
        t = int(ev["round"])
        rounds = self.s["rounds"]
        if t not in rounds:
            rounds.append(t)
        self.s["rounds"] = rounds = [r for r in rounds
                                     if r > t - self.window]
        if self.edge(len(rounds) > self.max_rounds):
            return [{"round": t, "value": float(len(rounds)),
                     "message": f"compiled round functions retraced at "
                                f"{len(rounds)} distinct rounds within "
                                f"the last {self.window} (fn "
                                f"{ev.get('fn')!r}) — a shape/dtype is "
                                "leaking into the trace"}]
        return []


class HbmGrowthRule(Rule):
    """Device (or host-RSS fallback) LIVE memory is rising across
    ``patience``+1 consecutive ``resource`` samples by more than
    ``tol`` relative AND ``min_bytes`` absolute — the leak shape: a
    per-block allocation that never frees (e.g. an accumulating host
    mirror, an unbounded trace cache).  Warmup allocation noise does
    not satisfy strictly-monotonic growth over five samples plus both
    margins.  ``resource`` is a NON-deterministic kind (per-block
    sampling cadence), so like retrace_storm this rule is outside the
    hard alert-identity guarantee; its window is likewise
    SEGMENT-scoped (any ``run`` header clears it — occupancy samples
    are not comparable across a process restart), keeping healthy
    paths identical in practice."""

    name = "hbm_growth"
    severity = "warn"

    def __init__(self, patience: int = 4, tol: float = 0.5,
                 min_bytes: int = 64 << 20):
        self.patience = int(patience)
        self.tol = float(tol)
        self.min_bytes = int(min_bytes)
        super().__init__()

    def reset(self) -> None:
        self.s = {"armed": True, "hist": []}

    def update(self, ev: dict, ctx: RunContext) -> list[dict]:
        if ev.get("kind") == "run":
            self.reset()
            return []
        if ev.get("kind") != "resource":
            return []
        v = ev.get("live_bytes", ev.get("peak_bytes"))
        if not isinstance(v, (int, float)):
            return []
        hist = self.s["hist"]
        hist.append(float(v))
        del hist[:-(self.patience + 1)]
        rising = (len(hist) == self.patience + 1
                  and all(b > a for a, b in zip(hist, hist[1:]))
                  and hist[-1] > hist[0] * (1.0 + self.tol)
                  and hist[-1] - hist[0] > self.min_bytes)
        if self.edge(rising):
            return [{"round": ev["round"], "value": hist[-1],
                     "message": f"live device memory rose "
                                f"{hist[0] / 2**20:.0f} -> "
                                f"{hist[-1] / 2**20:.0f} MiB over "
                                f"{self.patience + 1} consecutive "
                                "samples (leak shape)"}]
        return []


class QuarantineStormRule(Rule):
    """More than ``frac`` of a quarantine universe is out at once: the
    detector is eating the fleet (threshold too tight, or a genuinely
    majority-Byzantine regime where robust aggregation's breakdown
    point is gone either way).  Two universes, each with its MATCHING
    denominator — ``quarantine_active`` counts LANES (vs the static
    lane count), ``population_quarantined`` counts CLIENTS (vs the
    ``population_size`` gauge the registry emits) — with independent
    edge state, so a lane storm and a client storm each alert once."""

    name = "quarantine_storm"
    severity = "warn"

    def __init__(self, frac: float = 0.5):
        self.frac = float(frac)
        super().__init__()

    def reset(self) -> None:
        self.s = {"armed": {}}

    def _edge_key(self, key: str, violated: bool) -> bool:
        armed = self.s["armed"]
        if violated and armed.get(key, True):
            armed[key] = False
            return True
        if not violated:
            armed[key] = True
        return False

    def update(self, ev: dict, ctx: RunContext) -> list[dict]:
        if ev.get("kind") != "gauge":
            return []
        name = ev.get("name")
        if name == "quarantine_active":
            denom, what = ctx.workers, "workers"
        elif name == "population_quarantined":
            denom, what = ctx.population, "clients"
        else:
            return []
        if not denom:
            return []
        v = float(ev["value"])
        if self._edge_key(name, v >= self.frac * float(denom)):
            return [{"round": ev["round"], "value": v,
                     "message": f"{int(v)}/{int(denom)} {what} "
                                f"quarantined (>= {self.frac:.0%} of the "
                                "fleet)"}]
        return []


class DropRateRule(Rule):
    """Rolling lost-contribution rate (crash/straggle/msg_drop/
    partition/churn ledger rows per round, per participant) exceeded
    the SLO over a ``window``-round trailing mean.  Fault events
    precede their round event in every bundle, so the round event is
    the commit point that seals a round's count."""

    name = "drop_rate"
    severity = "warn"

    def __init__(self, max_rate: float = 1.0, window: int = 8,
                 min_rounds: int = 4):
        self.max_rate = float(max_rate)
        self.window = int(window)
        self.min_rounds = int(min_rounds)
        super().__init__()

    def reset(self) -> None:
        self.s = {"armed": True, "pending": 0, "counts": []}

    def update(self, ev: dict, ctx: RunContext) -> list[dict]:
        kind = ev.get("kind")
        if kind == "fault" and ev.get("fault") in DROP_KINDS:
            self.s["pending"] += 1
            return []
        if kind != "round":
            return []
        counts = self.s["counts"]
        counts.append(self.s["pending"])
        self.s["pending"] = 0
        del counts[:-self.window]
        denom = ctx.denominator()
        if not denom or len(counts) < self.min_rounds:
            return []
        rate = sum(counts) / len(counts) / denom
        if self.edge(rate >= self.max_rate):
            return [{"round": ev["round"], "value": rate,
                     "message": f"drop rate {rate:.2f} faults/participant/"
                                f"round over the last {len(counts)} rounds "
                                f"(SLO {self.max_rate:.2f})"}]
        return []


class StalenessSaturationRule(Rule):
    """The one-slot late-update buffer is (nearly) full fleet-wide:
    ``stale_pending`` ≥ ``frac`` × workers means every further late
    update overwrites a buffered one — the admission window is too
    small for the observed lag."""

    name = "staleness_saturation"
    severity = "warn"

    def __init__(self, frac: float = 0.9):
        self.frac = float(frac)
        super().__init__()

    def update(self, ev: dict, ctx: RunContext) -> list[dict]:
        if ev.get("kind") != "gauge" or ev.get("name") != "stale_pending":
            return []
        denom = ctx.workers
        if not denom:
            return []
        v = float(ev["value"])
        if self.edge(v >= self.frac * denom):
            return [{"round": ev["round"], "value": v,
                     "message": f"staleness buffer saturated: {int(v)}/"
                                f"{denom} slots pending"}]
        return []


class HostGapRule(Rule):
    """The host pipeline is eating wall-clock: a ``host_gap_pct``
    gauge (a benchmark emits it per measured leg) above ``max_pct`` —
    the regime the prefetch overlap exists to prevent."""

    name = "host_gap"
    severity = "warn"

    def __init__(self, max_pct: float = 25.0):
        self.max_pct = float(max_pct)
        super().__init__()

    def update(self, ev: dict, ctx: RunContext) -> list[dict]:
        if ev.get("kind") != "gauge" or ev.get("name") != "host_gap_pct":
            return []
        v = float(ev["value"])
        if self.edge(v > self.max_pct):
            return [{"round": ev["round"], "value": v,
                     "message": f"host_gap_pct={v:.1f} exceeds "
                                f"{self.max_pct:.1f}% (host pipeline on "
                                "the critical path)"}]
        return []


class CheckpointCadenceRule(Rule):
    """A run configured to checkpoint every K rounds went K +
    ``slack`` rounds without a ``checkpoint`` event — the crash-exact
    resume guarantee is silently eroding.

    The expected cadence comes from the RUN ITSELF: the ``run``
    segment header's ``checkpoint_every`` field (serve daemons and
    ``--checkpoint-every`` CLI runs stamp it) or a ``control`` event
    that changes it mid-run, both tracked in ``ctx.checkpoint_every``.
    An explicit ``every=`` construction kwarg overrides the stream's
    claim (the operator knows better); with neither, the rule is
    inactive — checkpoint timing is call-pattern state, not something
    a default rule can guess."""

    name = "checkpoint_cadence"
    severity = "warn"

    def __init__(self, every: int | None = None, slack: int = 1):
        self.every = None if every is None else int(every)
        self.slack = int(slack)
        super().__init__()

    def reset(self) -> None:
        self.s = {"armed": True, "last": None, "start": None}

    def update(self, ev: dict, ctx: RunContext) -> list[dict]:
        every = self.every if self.every is not None \
            else ctx.checkpoint_every
        if not every:
            return []
        kind = ev.get("kind")
        if kind == "checkpoint":
            self.s["last"] = int(ev["round"])
            return []
        if kind != "round":
            return []
        t = int(ev["round"])
        if self.s["start"] is None:
            self.s["start"] = t
        anchor = self.s["last"] if self.s["last"] is not None \
            else self.s["start"] - 1
        overdue = t - anchor > every + self.slack
        if self.edge(overdue):
            return [{"round": t,
                     "message": f"no checkpoint for {t - anchor} rounds "
                                f"(expected every {every})"}]
        return []


RULES: dict[str, type[Rule]] = {
    cls.name: cls for cls in (
        NonFiniteLossRule, LossDivergenceRule, ConsensusStallRule,
        GradExplosionRule, RetraceStormRule, HbmGrowthRule,
        QuarantineStormRule, DropRateRule, StalenessSaturationRule,
        HostGapRule, CheckpointCadenceRule,
    )
}


def default_rules(**overrides: dict) -> list[Rule]:
    """The stock rule set with conservative defaults (silent on clean
    baseline runs).  ``overrides`` maps rule name -> kwargs dict, e.g.
    ``default_rules(loss_divergence={"factor": 2.0})``; an override of
    ``None`` drops that rule."""
    rules: list[Rule] = []
    for name, cls in RULES.items():
        kw = overrides.get(name, {})
        if kw is None:
            continue
        rules.append(cls(**kw))
    return rules


def build_rules(specs: list[dict]) -> list[Rule]:
    """Declarative construction: each spec is ``{"rule": <name>,
    **params}`` (the shape a JSON config file carries)."""
    rules = []
    for spec in specs:
        spec = dict(spec)
        name = spec.pop("rule", None)
        if name not in RULES:
            raise ValueError(f"unknown rule {name!r} "
                             f"(known: {sorted(RULES)})")
        rules.append(RULES[name](**spec))
    return rules
