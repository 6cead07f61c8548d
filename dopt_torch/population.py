"""The client population: cohorts sampled from a registry of clients.

The port's copy of ``dopt.population``, host numpy throughout and equal
to dopt's bit for bit.  Both engines otherwise equate a worker with a
lane; here the population (1k-10k clients) is a host-side state object
apart from the fixed-width lanes:

* **registry** — per-client arrays keyed by client id: the data shard
  (``assign_client_shards``), participation counts, the round each was
  last sampled (the staleness signal), the non-finite screen streaks
  and the quarantine sentences.  It owns a client-keyed ``FaultPlan``
  (``num_workers = P``), so every per-round fault draw is a ``[P]``
  vector gathered at the cohort's ids and a ``corrupt_max``-pinned liar
  lies in every cohort that samples it;
* **sampler** — stateless: round t's cohort is a function of (seed, t,
  the eligible set) alone (``host_rng(seed, 0xC0407, t)``, drawn without
  replacement from the clients neither quarantined nor churned away),
  so blocked and resumed runs draw what a continuous run draws;
* **binding** — the round's survivors, sorted, fill ceil(cohort/lanes)
  waves of lanes, padded by wrapping around, with a 0/1 validity mask
  as data (``CohortBinding``);
* the federated engine trains the waves, accumulates each lane's f32
  partial sum across them and reduces once
  (``masked_average_scatter`` with the cohort-weight denominator); the
  gossip engine binds a cohort of ``num_users`` onto its lanes.

Every sampled round writes one ``cohort`` ledger row (worker −1,
action ``sampled_{m}_of_{P}_digest_{crc32}_waves_{K}``).
"""

from __future__ import annotations

import zlib

import numpy as np

from dopt_torch.config import FaultConfig, PopulationConfig, RobustConfig
from dopt_torch.data.partition import (assign_client_shards,
                                       orphan_shard_adopters, reassign_shards)
from dopt_torch.faults import FaultPlan
from dopt_torch.robust import quarantine_step
from dopt_torch.utils.prng import host_rng

# The cohort draws' salt: a stream of their own, so arming the
# population moves no fault or lane-sampling stream.
_COHORT_SALT = 0xC0407


def validate_population_config(cfg: PopulationConfig) -> None:
    if cfg.clients < 1:
        raise ValueError(
            f"PopulationConfig.clients={cfg.clients} must be >= 1")
    if not 1 <= cfg.cohort <= cfg.clients:
        raise ValueError(
            f"PopulationConfig.cohort={cfg.cohort} must be in "
            f"[1, clients={cfg.clients}]")
    if cfg.lanes is not None and cfg.lanes < 1:
        raise ValueError(
            f"PopulationConfig.lanes={cfg.lanes} must be >= 1")


def cohort_digest(ids: np.ndarray) -> str:
    """The 8-hex-digit CRC32 of the cohort's sorted int64 client ids: the
    ledger's order-free audit key of a round's draw."""
    ids = np.sort(np.asarray(ids, np.int64))
    return f"{zlib.crc32(ids.tobytes()) & 0xFFFFFFFF:08x}"


class CohortBinding:
    """One round's cohort on the lane grid: ``lane_ids`` the
    ``[waves, lanes]`` int32 client ids (survivors first, in the order
    given — sorted by ``ClientRegistry.bind`` — then padding that wraps
    around the survivors), ``valid`` the matching 0/1 f32 mask.  Both
    are data, so every cohort size, none included, runs one round
    body."""

    def __init__(self, round_: int, cohort: np.ndarray,
                 survivors: np.ndarray, lanes: int, waves: int):
        self.round = int(round_)
        self.cohort = np.asarray(cohort, np.int64)
        self.survivors = np.asarray(survivors, np.int64)
        self.lanes = int(lanes)
        self.waves = int(waves)
        slots = self.waves * self.lanes
        n = len(self.survivors)
        if n > slots:
            raise ValueError(
                f"{n} survivors exceed the {self.waves}x{self.lanes} "
                "lane grid")
        if n:
            pad = self.survivors[np.arange(n, slots) % n]
            grid = np.concatenate([self.survivors, pad])
        else:
            grid = np.zeros(slots, np.int64)
        self.lane_ids = grid.reshape(self.waves, self.lanes).astype(np.int32)
        valid = np.zeros(slots, np.float32)
        valid[:n] = 1.0
        self.valid = valid.reshape(self.waves, self.lanes)

    @property
    def digest(self) -> str:
        return cohort_digest(self.cohort)

    def ledger_row(self, population: int) -> dict:
        """The round's ``cohort`` row (worker −1: the fleet's event)."""
        return {"round": self.round, "worker": -1, "kind": "cohort",
                "action": (f"sampled_{len(self.cohort)}_of_{population}"
                           f"_digest_{self.digest}_waves_{self.waves}")}


class ClientRegistry:
    """Host-side per-client state of a population of P clients, keyed by
    client id.  Sampling is stateless; what ``state_dict`` holds is the
    only state carried from round to round.  The federated engine drives
    the whole participate → train → screen cycle, the gossip engine the
    sampler and the shard binding."""

    def __init__(self, cfg: PopulationConfig, *, num_shards: int,
                 seed: int, faults: FaultConfig | None = None,
                 robust: RobustConfig | None = None,
                 lanes: int | None = None):
        validate_population_config(cfg)
        self.cfg = cfg
        self.clients = int(cfg.clients)
        self.cohort_size = int(cfg.cohort)
        self.num_shards = int(num_shards)
        self.seed = int(cfg.seed) if cfg.seed is not None else int(seed)
        self.lanes = int(lanes if lanes is not None
                         else (cfg.lanes or num_shards))
        if self.lanes < 1:
            raise ValueError(f"lane width {self.lanes} must be >= 1")
        # The grid always holds the whole configured cohort; a short one
        # (quarantine, churn) rides the validity mask.
        self.waves = -(-self.cohort_size // self.lanes)
        self.shard_of = assign_client_shards(self.clients, self.num_shards,
                                             seed=self.seed)
        # The client-keyed fault streams (the experiment seed, as dopt's).
        self.faults = FaultPlan(self.clients, faults, seed=seed)
        self._quarantine_after = (int(robust.quarantine_after)
                                  if robust is not None else 0)
        self._quarantine_rounds = (int(robust.quarantine_rounds)
                                   if robust is not None else 0)
        self.participation = np.zeros(self.clients, np.int64)
        self.last_sampled = np.full(self.clients, -1, np.int64)
        self.screen_streak = np.zeros(self.clients, np.int64)
        self.quarantine_until = np.zeros(self.clients, np.int64)

    # -- eligibility and sampling -----------------------------------------
    def staleness(self, t: int) -> np.ndarray:
        """[P] rounds since each client last took part (t + 1 for the
        never-sampled)."""
        return np.where(self.last_sampled < 0, int(t) + 1,
                        int(t) - self.last_sampled)

    def begin_round(self, t: int) -> list[dict]:
        """Expire the sentences due at round t; returns their
        ``readmitted`` rows."""
        rows: list[dict] = []
        expired = (self.quarantine_until != 0) & (t >= self.quarantine_until)
        for i in np.nonzero(expired)[0]:
            rows.append({"round": int(t), "worker": int(i),
                         "kind": "quarantine", "action": "readmitted"})
            self.quarantine_until[i] = 0
            self.screen_streak[i] = 0
        return rows

    def eligible(self, t: int) -> np.ndarray:
        """[P] bool: the clients neither serving a sentence nor churned
        away at round t."""
        ok = ~(self.quarantine_until > t)
        away = self.faults.away_for_round(t)
        return ok & ~away

    def sample_cohort(self, t: int, *, n_draw: int | None = None,
                      eligible: np.ndarray | None = None) -> np.ndarray:
        """Round t's draw in DRAW order (the over-selection surplus is
        released from it; sorting happens at ``bind``): min(n_draw,
        #eligible) ids, none being a valid, empty round."""
        if eligible is None:
            eligible = self.eligible(t)
        ids = np.nonzero(eligible)[0]
        n = min(int(n_draw if n_draw is not None else self.cohort_size),
                len(ids))
        if n == 0:
            return np.zeros(0, np.int64)
        rng = host_rng(self.seed, _COHORT_SALT, int(t))
        return np.asarray(rng.choice(ids, n, replace=False), np.int64)

    def bind(self, t: int, cohort: np.ndarray,
             survivors: np.ndarray) -> CohortBinding:
        """The round's survivors, sorted, on the lane grid."""
        return CohortBinding(t, cohort, np.sort(np.asarray(survivors)),
                             self.lanes, self.waves)

    def churn_ledger_rows(self, t: int, away: np.ndarray) -> list[dict]:
        """Round t's churn rows at population scale: each client's
        leave and rejoin, then each shard whose adopter changed
        (``orphan_shard_adopters``, worker −1: a shard is the fleet's).
        Stateless in t."""
        rows: list[dict] = []
        prev = (self.faults.away_for_round(t - 1) if t > 0
                else np.zeros_like(away))
        for i in np.nonzero(away & ~prev)[0]:
            rows.append({"round": int(t), "worker": int(i),
                         "kind": "churn", "action": "left"})
        for i in np.nonzero(prev & ~away)[0]:
            rows.append({"round": int(t), "worker": int(i),
                         "kind": "churn", "action": "rejoined"})
        cur = orphan_shard_adopters(self.shard_of, ~away, self.num_shards)
        prv = orphan_shard_adopters(self.shard_of, ~prev, self.num_shards)
        for s, a in sorted(cur.items()):
            if prv.get(s) != a:
                rows.append({"round": int(t), "worker": -1,
                             "kind": "churn",
                             "action": f"shard_{s}_adopted_by_{a}"})
        return rows

    # -- data binding ------------------------------------------------------
    def plan_matrix_for(self, t: int,
                        train_matrix: np.ndarray) -> np.ndarray:
        """Round t's plan matrix: an orphaned shard's rows interleaved
        into its adopter's (``reassign_shards``)."""
        if not self.faults.has_churn:
            return train_matrix
        alive = ~self.faults.away_for_round(t)
        adopters = orphan_shard_adopters(self.shard_of, alive,
                                         self.num_shards)
        return reassign_shards(train_matrix, adopters)

    # -- feedback ----------------------------------------------------------
    def record_participation(self, t: int, ids: np.ndarray) -> None:
        ids = np.asarray(ids, np.int64)
        self.participation[ids] += 1
        self.last_sampled[ids] = int(t)

    def apply_screen_feedback(self, t: int, ids: np.ndarray,
                              flags: np.ndarray, rows: list) -> None:
        """The round's non-finite-screen ``flags`` (aligned with ``ids``,
        its surviving clients) into the ledger and the client-keyed
        streaks and sentences (``quarantine_step``)."""
        for j, cid in enumerate(np.asarray(ids).reshape(-1)):
            if float(flags[j]) > 0.5:
                rows.append({"round": int(t), "worker": int(cid),
                             "kind": "corrupt",
                             "action": "screened_nonfinite"})
        sentenced = quarantine_step(
            self.screen_streak, self.quarantine_until, ids, flags, t,
            after=self._quarantine_after, rounds=self._quarantine_rounds)
        for cid, until in sentenced:
            rows.append({"round": int(t), "worker": int(cid),
                         "kind": "quarantine",
                         "action": f"quarantined_until_{until}"})

    # -- checkpoint --------------------------------------------------------
    def state_dict(self) -> dict:
        """The registry's JSON-able state, dopt's keys; ``shard_of`` rides
        along as an integrity check."""
        return {
            "clients": self.clients,
            "cohort": self.cohort_size,
            "lanes": self.lanes,
            "participation": self.participation.tolist(),
            "last_sampled": self.last_sampled.tolist(),
            "screen_streak": self.screen_streak.tolist(),
            "quarantine_until": self.quarantine_until.tolist(),
            "shard_of": self.shard_of.tolist(),
        }

    def load_state(self, state: dict) -> None:
        for key, expect in (("clients", self.clients),
                            ("cohort", self.cohort_size),
                            ("lanes", self.lanes)):
            got = state.get(key)
            if got is not None and int(got) != expect:
                raise ValueError(
                    f"checkpoint registry {key}={got} does not match the "
                    f"trainer's {key}={expect}")
        p = self.clients
        self.participation = np.asarray(
            state.get("participation", [0] * p), np.int64)
        self.last_sampled = np.asarray(
            state.get("last_sampled", [-1] * p), np.int64)
        self.screen_streak = np.asarray(
            state.get("screen_streak", [0] * p), np.int64)
        self.quarantine_until = np.asarray(
            state.get("quarantine_until", [0] * p), np.int64)
        saved = state.get("shard_of")
        if saved is not None and not np.array_equal(
                np.asarray(saved, np.int32), self.shard_of):
            raise ValueError(
                "checkpoint registry shard assignment differs from this "
                "trainer's (population/shards/seed mismatch) — resuming "
                "would train different data per client")


def population_gauges(reg: ClientRegistry, t: int, gauges: dict) -> None:
    """Both engines' population gauges after round t (dopt's): the cohort
    and population sizes, the clients serving a sentence and the clients
    ever sampled."""
    gauges["cohort_size"] = float(reg.cohort_size)
    gauges["population_size"] = float(reg.clients)
    gauges["population_quarantined"] = float(
        (reg.quarantine_until > t).sum())
    gauges["population_sampled_total"] = float(
        (reg.participation > 0).sum())


def restore_registry(reg: ClientRegistry, meta: dict) -> None:
    """A restore's registry state (``population_registry``), refused in
    dopt's words when the checkpoint has none."""
    state = meta.get("population_registry")
    if state is None:
        raise ValueError(
            "population-mode trainer requires its registry state "
            "('population_registry') in the checkpoint — this "
            "checkpoint is from a lane-engine run")
    reg.load_state(state)
