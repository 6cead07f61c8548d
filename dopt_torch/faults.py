"""Fault injection for the port: the host-side fault plan and the
Byzantine sends.

The port's copy of ``dopt.faults`` (numpy only, so every draw is dopt's
bit for bit): ``FaultPlan`` draws each round's crashes, stragglers,
partitions, Byzantine liars, per-edge link drops and delays, and churn
(elastic membership) statelessly from ``(seed, kind, round)`` — no
state is carried between rounds, so per-round, blocked and
killed-and-resumed runs see the same faults, and a whole block's fault
inputs can be drawn before it runs.  ``churn_ledger_rows`` writes the
membership transitions into the fault ledger (``History.faults``), one
row per (round, worker, kind, action).  ``corrupt_update`` is the lie
itself on the device: what a Byzantine worker broadcasts (gossip) or
reports (federated), in torch.  Both engines consume the plan
(dopt_torch/engine/gossip.py, dopt_torch/engine/federated.py).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Iterable

import numpy as np

import torch

from dopt_torch.config import FaultConfig
from dopt_torch.optim import rounded
from dopt_torch.utils.prng import host_rng

# Salt namespace for the fault streams (distinct from the engines'
# sampling/matching salts so enabling faults never perturbs them).
_FAULT_SALT = 0xFA010
_CRASH, _STRAGGLE, _PARTITION, _CORRUPT = 1, 2, 3, 4
_LINK, _UPLINK, _CHURN, _STALE = 5, 6, 7, 8

KINDS = ("crash", "straggler", "partition", "overselect", "corrupt",
         "quarantine", "msg_drop", "msg_delay", "churn", "staleness",
         "cohort", "control")
# "control" (dopt.serve): one row per APPLIED control-plane command —
# {round, worker (-1 for fleet-level config/drain/pause rows, the
# worker id for membership rows), kind: "control", action:
# "applied_<cmd>_<details>"} — appended at the round boundary the
# command took effect, BEFORE that round's fault rows, so a served
# run's ledger is a complete replay script: re-running the base config
# plus the ledgered commands at their ledgered rounds reproduces the
# run bit-exactly.
# "cohort" (dopt.population): one row per population-sampled round —
# {round, worker: -1, kind: "cohort", action:
# "sampled_{m}_of_{P}_digest_{crc32}_waves_{K}"} — so which clients a
# round drew is auditable (and replayable via the digest) exactly like
# every injected fault.  FaultPlan itself is population-size agnostic:
# the registry constructs it with num_workers = P so every stateless
# per-round draw (crash/corrupt/churn/uplink/...) is keyed by CLIENT
# id, which is what makes corrupt_max-pinned adversaries persist
# across cohorts instead of being reshuffled with the lane binding.
CORRUPT_MODES = ("nan", "inf", "scale", "signflip", "stale")

# The GossipConfig.dropout alias predates FaultPlan; warn once per
# construction that FaultConfig(crash=p) is the spelling that survives.
# crash=p is the degenerate all-links-down case of the per-edge link
# model (a down worker = every in/out edge dropped + no local work);
# tests/test_faults.py pins that routing equivalence.
_DROPOUT_DEPRECATION = (
    "GossipConfig.dropout is deprecated: set "
    "ExperimentConfig.faults=FaultConfig(crash=p) instead (identical "
    "fault trace; dropout will be REMOVED in release 0.2.0)")


@dataclass(frozen=True)
class RoundFaults:
    """One round's fault state, as plain host arrays.

    ``crashed``/``straggler`` are bool [W]; ``epoch_frac`` is float32
    [W] (1.0 for healthy workers, ``straggle_frac`` for stragglers);
    ``partition`` is an int32 [W] group-id vector, or None when no
    partition is active this round; ``corrupt`` is bool [W] (the
    round's Byzantine liars — None on plans predating the field)."""

    round: int
    crashed: np.ndarray
    straggler: np.ndarray
    epoch_frac: np.ndarray
    partition: np.ndarray | None
    corrupt: np.ndarray | None = None

    @property
    def any_fault(self) -> bool:
        return (bool(self.crashed.any()) or bool(self.straggler.any())
                or self.partition is not None
                or (self.corrupt is not None and bool(self.corrupt.any())))


class MembershipLog:
    """Control-plane membership overlay (``dopt.serve``): an ordered
    log of ``(round, worker, present)`` directives.

    Unlike ``FaultConfig.churn`` — whose leave/join events are random
    draws — these are COMMANDED transitions: the serve daemon appends
    one entry per applied ``membership`` command at the round boundary
    it took effect.  ``away_at(t)`` is a pure function of the log and
    the round index (the last directive with ``round <= t`` wins per
    worker), so membership is stateless-per-round exactly like every
    FaultPlan draw: per-round, blocked, and killed-and-resumed
    execution see the identical fleet, and a resumed daemon rebuilds
    the overlay by replaying its applied-command ledger.

    The log rides the EXISTING churn machinery end to end: a departed
    worker's mixing row is repaired to identity (gossip), it is
    excluded from sampling (federated), its data shards are
    deterministically reassigned to the next-alive adopter
    (``dopt_torch.data.partition.reassign_shards``), and the leave/rejoin/
    shard-adoption transitions land in the fault ledger as ``churn``
    rows."""

    def __init__(self, events: Iterable[tuple[int, int, bool]] = ()):
        self.events: list[tuple[int, int, bool]] = []
        for r, w, p in events:
            self.add(r, w, p)

    def add(self, round_idx: int, worker: int, present: bool) -> None:
        """Append one directive.  Rounds must be nondecreasing — the
        serve daemon applies commands at successive round boundaries,
        and a backdated directive would rewrite already-executed
        rounds' membership."""
        r, w = int(round_idx), int(worker)
        if r < 0 or w < 0:
            raise ValueError(
                f"membership directive needs round >= 0 and worker >= 0 "
                f"(got round={r}, worker={w})")
        if self.events and r < self.events[-1][0]:
            raise ValueError(
                f"membership directives must be appended in round order: "
                f"round {r} after round {self.events[-1][0]}")
        self.events.append((r, w, bool(present)))

    def away_at(self, t: int, num_workers: int) -> np.ndarray:
        """[W] bool: workers commanded away as of round ``t``."""
        away = np.zeros(int(num_workers), bool)
        for r, w, present in self.events:
            if r > int(t):
                break
            if w < num_workers:
                away[w] = not present
        return away

    def to_json(self) -> list[list]:
        return [[int(r), int(w), bool(p)] for r, w, p in self.events]

    @classmethod
    def from_json(cls, obj: Iterable) -> "MembershipLog":
        return cls((int(r), int(w), bool(p)) for r, w, p in obj)

    def __len__(self) -> int:
        return len(self.events)


class FaultPlan:
    """Deterministic per-round fault-trace generator for one fleet.

    ``cfg=None`` (with ``dropout=0``) is the explicit fault-free plan:
    ``for_round`` returns all-alive states and the engines compile the
    exact pre-fault program.  ``dropout`` is the back-compat alias for
    ``GossipConfig.dropout`` — it synthesizes ``FaultConfig(crash=p)``.

    ``membership`` (``dopt.serve``) arms the commanded-membership
    overlay: ``away_for_round`` ORs the log's directives into the churn
    ``away`` set, which flips ``has_churn``/``affects_matrix`` on at
    construction so the engines compile the elastic program up front —
    a join/leave command later never retraces.  ``membership=None``
    (every scripted run) leaves every flag and draw untouched.
    """

    def __init__(self, num_workers: int, cfg: FaultConfig | None = None, *,
                 seed: int = 0, dropout: float = 0.0,
                 membership: MembershipLog | None = None):
        if cfg is not None and dropout > 0.0:
            raise ValueError(
                "set faults via FaultConfig OR the legacy "
                "GossipConfig.dropout alias, not both")
        if cfg is None and dropout > 0.0:
            import warnings

            warnings.warn(_DROPOUT_DEPRECATION, DeprecationWarning,
                          stacklevel=2)
            cfg = FaultConfig(crash=float(dropout))
        if cfg is not None:
            validate_fault_config(cfg)
        self.cfg = cfg
        self.num_workers = int(num_workers)
        self.seed = (int(cfg.seed) if cfg is not None and cfg.seed is not None
                     else int(seed))
        self.membership = membership
        if membership is not None and self.cfg is None:
            # Arming the overlay makes the plan ACTIVE (departed lanes
            # must freeze via the fault machinery); an all-zero config
            # keeps every stochastic draw off — for_round gates each
            # kind on its probability, so no RNG stream is consumed.
            self.cfg = FaultConfig()

    # -- capability flags (engines key compiled-program shape on these,
    # -- so the fault-free path stays bit-identical to the pre-fault one)
    @property
    def active(self) -> bool:
        if self.membership is not None:
            return True
        c = self.cfg
        return c is not None and (c.crash > 0 or c.straggle > 0
                                  or c.partition > 0 or c.corrupt > 0
                                  or c.msg_drop > 0 or c.msg_delay > 0
                                  or c.churn > 0)

    @property
    def may_straggle(self) -> bool:
        return self.active and self.cfg.straggle > 0

    @property
    def has_corrupt(self) -> bool:
        """Byzantine corruption possible (keys the engines' compiled
        corrupt-injection inputs, like may_straggle keys the limits)."""
        return self.active and self.cfg.corrupt > 0

    @property
    def has_membership(self) -> bool:
        """Commanded-membership overlay armed (dopt.serve): leave/join
        directives may repair the matrix / exclude workers at any round
        boundary, so the elastic machinery compiles in up front."""
        return self.membership is not None

    @property
    def affects_matrix(self) -> bool:
        """Crash, partition or churn repair can add identity rows to the
        mixing matrix (the shift path must compile shift 0 into its
        set)."""
        return self.has_membership or (
            self.active and (self.cfg.crash > 0 or self.cfg.partition > 0
                             or self.cfg.churn > 0))

    @property
    def has_link(self) -> bool:
        """Per-edge link faults possible (msg_drop / msg_delay): the
        gossip engine then routes through the link-matrix consensus path
        (dense, per-round) and the federated engine draws uplink
        faults."""
        return self.active and (self.cfg.msg_drop > 0
                                or self.cfg.msg_delay > 0)

    @property
    def has_churn(self) -> bool:
        """Elastic-membership leave/join events possible — random
        (``FaultConfig.churn`` draws) or commanded (the dopt.serve
        ``MembershipLog`` overlay); both ride the same away/repair/
        shard-reassignment machinery."""
        return self.has_membership or (self.active and self.cfg.churn > 0)

    @property
    def delay_max(self) -> int:
        """Compiled staleness-buffer depth D: msg_delay_max when delays
        are possible, else 0 (no buffer)."""
        return (int(self.cfg.msg_delay_max)
                if self.active and self.cfg.msg_delay > 0 else 0)

    # ------------------------------------------------------------------
    def _rng(self, kind: int, t: int) -> np.random.Generator:
        return host_rng(self.seed, _FAULT_SALT, kind, int(t))

    def for_round(self, t: int) -> RoundFaults:
        w = self.num_workers
        none = np.zeros(w, bool)
        if not self.active:
            return RoundFaults(int(t), none, none, np.ones(w, np.float32),
                               None, none)
        c = self.cfg
        crashed = (self._rng(_CRASH, t).random(w) < c.crash
                   if c.crash > 0 else none)
        straggler = (self._rng(_STRAGGLE, t).random(w) < c.straggle
                     if c.straggle > 0 else none)
        straggler = straggler & ~crashed   # a crashed worker cannot straggle
        frac = np.where(straggler, np.float32(c.straggle_frac),
                        np.float32(1.0)).astype(np.float32)
        corrupt = none
        if c.corrupt > 0:
            corrupt = self._rng(_CORRUPT, t).random(w) < c.corrupt
            corrupt &= ~crashed   # a down worker sends nothing to corrupt
            if c.corrupt_max > 0 and int(corrupt.sum()) > c.corrupt_max:
                # Cap keeps the LOWEST-INDEXED liars, so corrupt=1.0 +
                # corrupt_max=f pins workers 0..f-1 as the persistent
                # adversary set (the fixed-f Byzantine setting).
                keep = np.nonzero(corrupt)[0][:c.corrupt_max]
                corrupt = np.zeros(w, bool)
                corrupt[keep] = True
        return RoundFaults(int(t), crashed, straggler, frac,
                           self._partition_for_round(t), corrupt)

    def _partition_for_round(self, t: int) -> np.ndarray | None:
        """Partition active at t ⇔ one started at some s ∈ (t−span, t];
        the most recent start wins.  Start draws and group assignments
        are keyed by the START round, so a partition's membership is
        stable over its whole span."""
        c = self.cfg
        if c is None or c.partition <= 0:
            return None
        for s in range(int(t), max(int(t) - c.partition_span, -1), -1):
            r = self._rng(_PARTITION, s)
            if r.random() < c.partition:
                groups = r.integers(0, c.partition_groups,
                                    size=self.num_workers)
                return groups.astype(np.int32)
        return None

    # -- link faults (per-(round, directed edge) stateless draws) ------
    def link_for_round(self, t: int) -> tuple[np.ndarray, np.ndarray]:
        """(keep, delay) for round t's directed edges.

        ``keep`` is bool [W, W]: keep[i, j] = the message j -> i
        survives this round (diagonal always True — a worker never
        drops its own state).  ``delay`` is int32 [W, W]: rounds of
        staleness on edge j -> i, in {0..msg_delay_max} (0 on the
        diagonal and on dropped edges — a dropped message never
        arrives, late or otherwise).  Both directions of a link draw
        independently, so loss/delay is asymmetric in general.  Draws
        are keyed by (seed, _LINK, round) only — bit-reproducible,
        blocked-exact and resume-exact like every other fault kind."""
        w = self.num_workers
        eye = np.eye(w, dtype=bool)
        if not self.has_link:
            return np.ones((w, w), bool), np.zeros((w, w), np.int32)
        c = self.cfg
        r = self._rng(_LINK, t)
        # One fixed draw layout regardless of which knobs are on, so
        # enabling msg_delay never perturbs the msg_drop trace.
        u_drop = r.random((w, w))
        u_del = r.random((w, w))
        d_val = r.integers(1, max(c.msg_delay_max, 1) + 1, size=(w, w))
        keep = ~((u_drop < c.msg_drop) & ~eye)
        delayed = (u_del < c.msg_delay) & ~eye & keep
        delay = np.where(delayed, d_val, 0).astype(np.int32)
        return keep, delay

    def uplink_for_round(self, t: int) -> tuple[np.ndarray, np.ndarray]:
        """Federated worker -> server link faults for round t:
        (dropped, delay) as [W] bool / int32 arrays.  ``dropped[i]``
        loses worker i's update for the round; ``delay[i]`` > 0 means
        the update arrives that many rounds late (admitted via the
        staleness buffer when ``FederatedConfig.staleness_max`` allows,
        dropped otherwise).  Drops win ties.  Separate salt from the
        gossip edge draws so the two engines' traces are independent."""
        w = self.num_workers
        if not self.has_link:
            return np.zeros(w, bool), np.zeros(w, np.int32)
        c = self.cfg
        r = self._rng(_UPLINK, t)
        u_drop = r.random(w)
        u_del = r.random(w)
        d_val = r.integers(1, max(c.msg_delay_max, 1) + 1, size=w)
        dropped = u_drop < c.msg_drop
        delayed = (u_del < c.msg_delay) & ~dropped
        return dropped, np.where(delayed, d_val, 0).astype(np.int32)

    def straggler_lateness(self, t: int, max_late: int) -> np.ndarray:
        """[W] int32 lateness draws in 1..max_late: how many rounds
        after its deadline a buffered straggler's update arrives.  The
        bound is the CALLER's admission window (federated
        ``staleness_max``), not ``msg_delay_max`` — straggler lateness
        is an aggregation-policy property, independent of whether the
        message-delay fault is configured.  Keyed (seed, _STALE, round)
        — stateless."""
        w = self.num_workers
        hi = max(int(max_late), 1)
        return self._rng(_STALE, t).integers(1, hi + 1,
                                             size=w).astype(np.int32)

    # -- churn (elastic membership) ------------------------------------
    def away_for_round(self, t: int) -> np.ndarray:
        """[W] bool: workers away (departed) at round t.  Worker i is
        away at t iff a leave event keyed at some round s in
        (t - churn_span, t] fired for it — the same span-scan scheme as
        partitions, so membership is a pure function of the round index
        (stateless, resume-exact) and every leave lasts exactly
        ``churn_span`` rounds before the rejoin."""
        w = self.num_workers
        away = np.zeros(w, bool)
        if self.membership is not None:
            away |= self.membership.away_at(t, w)
        if not (self.active and self.cfg.churn > 0):
            return away
        c = self.cfg
        for s in range(int(t), max(int(t) - c.churn_span, -1), -1):
            away |= self._rng(_CHURN, s).random(w) < c.churn
        return away

    def plan_matrix_for(self, t: int,
                        train_matrix: np.ndarray) -> np.ndarray:
        """Round t's batch-plan index matrix: ``train_matrix`` with
        departed workers' shards deterministically reassigned to their
        adopters while churn keeps them away (the engines' shared
        shard-reassignment hook; a no-op without churn)."""
        if not self.has_churn:
            return train_matrix
        from dopt_torch.data.partition import reassign_shards

        away = self.away_for_round(t)
        return reassign_shards(train_matrix, self.adopters_for(away))

    @staticmethod
    def adopters_for(away: np.ndarray) -> dict[int, int]:
        """Deterministic shard-reassignment map for a round's departed
        set: each away worker i is adopted by the first alive worker at
        (i+1, i+2, ...) mod W.  Empty when everyone (or no one) is
        away."""
        w = len(away)
        if not away.any() or away.all():
            return {}
        out: dict[int, int] = {}
        for i in np.nonzero(away)[0]:
            j = (int(i) + 1) % w
            while away[j]:
                j = (j + 1) % w
            out[int(i)] = j
        return out

    # ------------------------------------------------------------------
    @staticmethod
    def limits_for(rf: RoundFaults, total_units: int) -> np.ndarray:
        """Per-worker work limits in the engine's granularity (epochs
        under the holdout's epoch loop, SGD steps on the flat path):
        healthy workers get ``total_units``, stragglers
        ``ceil(frac · total_units)`` (≥ 1 for frac > 0)."""
        lim = np.ceil(rf.epoch_frac * float(total_units))
        return np.clip(lim, 0, total_units).astype(np.int32)


def churn_ledger_rows(plan: FaultPlan, t: int,
                      away: np.ndarray) -> list[dict]:
    """Elastic-membership ledger rows for round t: leave/rejoin
    transitions and shard-adoption changes, recomputed statelessly from
    the round index alone (so per-round, blocked and killed-and-resumed
    execution log the identical trace).  Shared by both engines."""
    rows: list[dict] = []
    prev = (plan.away_for_round(t - 1) if t > 0
            else np.zeros_like(away))
    for i in np.nonzero(away & ~prev)[0]:
        rows.append({"round": int(t), "worker": int(i), "kind": "churn",
                     "action": "left"})
    for i in np.nonzero(prev & ~away)[0]:
        rows.append({"round": int(t), "worker": int(i), "kind": "churn",
                     "action": "rejoined"})
    adopters = plan.adopters_for(away)
    prev_adopters = plan.adopters_for(prev)
    for i, a in sorted(adopters.items()):
        if prev_adopters.get(i) != a:
            rows.append({"round": int(t), "worker": int(i), "kind": "churn",
                         "action": f"shard_adopted_by_{a}"})
    return rows


def validate_fault_config(cfg: FaultConfig) -> None:
    """Range/enum checks shared by ``FaultPlan`` and the CLI parser (so
    a bad ``--faults`` value fails at parse time with a clean message,
    not as a traceback from trainer construction)."""
    for f in ("crash", "straggle", "partition"):
        v = getattr(cfg, f)
        if not 0.0 <= v <= 1.0:
            raise ValueError(f"FaultConfig.{f}={v} must be in [0, 1]")
    if not 0.0 <= cfg.straggle_frac <= 1.0:
        raise ValueError(
            f"FaultConfig.straggle_frac={cfg.straggle_frac} must be "
            "in [0, 1]")
    if cfg.straggle > 0 and cfg.straggle_frac <= 0.0:
        # A zero-step straggler would leave p_t == theta, which corrupts
        # SCAFFOLD's control refresh (c_i drifts by -c_global every time
        # the worker is sampled).  Zero work for the round IS a crash —
        # model it with `crash` instead.
        raise ValueError(
            "FaultConfig.straggle_frac must be > 0 when straggle > 0 "
            "(a straggler always finishes SOME work; use crash for "
            "workers that do none)")
    if cfg.straggler_policy not in ("partial", "drop"):
        raise ValueError(
            f"unknown straggler_policy {cfg.straggler_policy!r}; "
            "one of partial|drop")
    if cfg.over_select < 0.0:
        raise ValueError("FaultConfig.over_select must be >= 0")
    if cfg.partition_span < 1:
        raise ValueError("FaultConfig.partition_span must be >= 1")
    if cfg.partition_groups < 2:
        raise ValueError("FaultConfig.partition_groups must be >= 2")
    if not 0.0 <= cfg.corrupt <= 1.0:
        raise ValueError(
            f"FaultConfig.corrupt={cfg.corrupt} must be in [0, 1]")
    if cfg.corrupt_mode not in CORRUPT_MODES:
        raise ValueError(
            f"unknown corrupt_mode {cfg.corrupt_mode!r}; one of "
            f"{CORRUPT_MODES}")
    if not np.isfinite(cfg.corrupt_scale) or cfg.corrupt_scale == 0.0:
        raise ValueError(
            f"FaultConfig.corrupt_scale={cfg.corrupt_scale} must be a "
            "finite nonzero factor (use corrupt_mode='inf' for "
            "non-finite poison)")
    if cfg.corrupt_max < 0:
        raise ValueError("FaultConfig.corrupt_max must be >= 0")
    for f in ("msg_drop", "msg_delay", "churn"):
        v = getattr(cfg, f)
        if not 0.0 <= v <= 1.0:
            raise ValueError(f"FaultConfig.{f}={v} must be in [0, 1]")
    if cfg.msg_drop == 1.0:
        # msg_drop=1.0 cuts EVERY off-diagonal edge every round — no
        # message ever arrives, which is 'nocons', not a lossy link.
        raise ValueError(
            "FaultConfig.msg_drop must be < 1 (dropping every message "
            "every round leaves no communication to degrade; use "
            "algorithm='nocons' for no-communication runs)")
    if cfg.msg_delay_max < 1:
        raise ValueError("FaultConfig.msg_delay_max must be >= 1")
    if cfg.churn_span < 1:
        raise ValueError("FaultConfig.churn_span must be >= 1")


def parse_fault_spec(spec: str) -> FaultConfig:
    """CLI ``--faults`` spec → FaultConfig.

    e.g. ``--faults "crash=0.1,straggle=0.2,straggle_frac=0.5,partition=0.05"``
    — keys are FaultConfig field names, values coerced to the field's
    annotated type, unknown keys rejected loudly."""
    fields = {f.name: f for f in dataclasses.fields(FaultConfig)}
    kw: dict[str, object] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        key, eq, raw = part.partition("=")
        key = key.strip()
        if not eq or key not in fields:
            raise ValueError(
                f"--faults: unknown field {key!r}; one of {sorted(fields)}")
        ann = str(fields[key].type)
        try:
            if ann.startswith("int"):
                kw[key] = int(raw)
            elif ann.startswith("float"):
                kw[key] = float(raw)
            else:
                kw[key] = raw.strip()
        except ValueError:
            raise ValueError(
                f"--faults: field {key!r} expects {ann}, got {raw!r}")
    cfg = FaultConfig(**kw)
    validate_fault_config(cfg)
    return cfg


# CLI --corrupt shorthand: short keys -> FaultConfig field names.
_CORRUPT_KEYS = {"p": "corrupt", "mode": "corrupt_mode",
                 "scale": "corrupt_scale", "max": "corrupt_max"}


def parse_corrupt_spec(spec: str,
                       base: FaultConfig | None = None) -> FaultConfig:
    """CLI ``--corrupt`` spec, merged onto an existing FaultConfig.

    e.g. ``--corrupt "p=0.25,mode=signflip,scale=50,max=2"`` or the bare
    probability ``--corrupt 0.25``.  Keys map onto the FaultConfig
    corrupt_* fields, so crash/straggler faults from ``--faults``
    compose with the Byzantine knobs."""
    kw: dict[str, object] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        key, eq, raw = part.partition("=")
        if not eq:
            try:
                kw["corrupt"] = float(part)
                continue
            except ValueError:
                raise ValueError(
                    f"--corrupt: expected a probability or key=value, "
                    f"got {part!r}")
        key = key.strip()
        if key not in _CORRUPT_KEYS:
            raise ValueError(
                f"--corrupt: unknown field {key!r}; one of "
                f"{sorted(_CORRUPT_KEYS)}")
        field = _CORRUPT_KEYS[key]
        try:
            if field == "corrupt_mode":
                kw[field] = raw.strip()
            elif field == "corrupt_max":
                kw[field] = int(raw)
            else:
                kw[field] = float(raw)
        except ValueError:
            raise ValueError(f"--corrupt: bad value {raw!r} for {key!r}")
    if "corrupt" not in kw and (base is None or base.corrupt == 0.0):
        kw.setdefault("corrupt", 1.0)   # --corrupt "mode=nan" means "lie"
    cfg = dataclasses.replace(base or FaultConfig(), **kw)
    validate_fault_config(cfg)
    return cfg


def corrupt_update(update: dict[str, torch.Tensor], cmask: torch.Tensor,
                   mode: str, scale: float, ref=None,
                   prev=None) -> dict[str, torch.Tensor]:
    """Inject the round's Byzantine corruption into a stacked
    ``[W, ...]`` dict: what each worker broadcasts in gossip, or the
    update a client reports to the federated server.  ``cmask`` is the
    [W] 0/1 corrupt mask (data, so a graph replays it with new masks).
    ``ref`` is the point updates are measured from (theta, without the
    worker axis, in the federated engine; None = the origin, the gossip
    case) and ``prev`` the lanes' previous state for mode 'stale'.

    Modes: 'nan'/'inf' poison the lanes outright; 'scale' blows the
    update up by ``scale`` around ``ref`` (r + s·(x − r); the factor
    rounded to the tensor's dtype, as dopt's ``jnp.asarray(scale,
    x.dtype)``); 'signflip' reflects it through ``ref`` (2r − x);
    'stale' replays ``prev``, which only the federated engine has: the
    gossip engine passes none and refuses the mode."""
    out = {}
    for k, x in update.items():
        r = None if ref is None else ref[k]
        if mode == "nan":
            bad = torch.full_like(x, float("nan"))
        elif mode == "inf":
            bad = torch.full_like(x, float("inf"))
        elif mode == "scale":
            # The factor as a host scalar rounded to the dtype (no
            # host-to-device copy inside a captured round); the product
            # of two bf16 values is exact in f32, so this rounds once, as
            # dopt's bf16-by-bf16 product does.
            s = rounded(scale, x.dtype)
            bad = x * s if r is None else r + (x - r) * s
        elif mode == "signflip":
            bad = -x if r is None else (2 * r - x).to(x.dtype)
        elif mode == "stale":
            if prev is None:
                raise ValueError("corrupt_mode='stale' needs the previous "
                                 "update, which only the federated engine "
                                 "carries")
            bad = prev[k]
        else:
            raise ValueError(f"unknown corrupt_mode {mode!r}; one of "
                             f"{CORRUPT_MODES}")
        m = cmask.reshape((-1,) + (1,) * (x.dim() - 1)).bool()
        out[k] = torch.where(m, bad, x)
    return out
