"""``backend="torch"``: the sequential reference oracle as trainers.

The port's copy of dopt/engine/torch_backend.py.  It runs the
reference's execution model — N torch workers stepped one after the
other in one process, communication as state-dict passing — behind the
engines' trainer surface (``run``, ``history``, ``client_history``,
``evaluate``), on ``device`` (the GPU when None, as every entry point of
the port).  It shares with the stacked engines everything that defines
the experiment — the dataset, the partition, the 90/10 local holdout,
the batch plans, the mixing schedules, the client-sampling stream and
the init (``gossip.initial_params``: dopt's flax tree through
``init_params``, or the seeded draw) — so the two consume the same
inputs and their trajectories compare directly.  Nothing of it launches
a hand kernel: each worker steps with ``torch.optim.SGD`` and mixes by
state-dict sums (``dopt_torch.engine.oracle``).

On CUDA ``run`` and ``evaluate`` run in full f32 and the deterministic
mode (``dopt_torch.models.zoo``); the twins' convs are the library's
(cuDNN) convs, not the stacked engines' ``_RoundedConv``.  On the CPU
the flags stay torch's defaults, as dopt's oracle runs.

Scope, as dopt's: the reference CNNs, the MLP and the logistic model;
gossip dsgd, nocons, centralized and fedlcon; federated fedavg,
fedprox, fedadmm and scaffold.  The extras with no reference execution
model — dropout fault injection, the other gossip algorithms, ResNet-18
and the sequence model — are refused in dopt's words, and ``save`` and
``restore`` raise: the oracle is a validation backend."""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from dopt_torch.config import ExperimentConfig
from dopt_torch.convert import params_to_jax
from dopt_torch.data import (eval_batches, holdout_split, load_dataset,
                             make_batch_plan, partition, stacked_eval_batches)
from dopt_torch.engine.gossip import initial_params, resolve_device
from dopt_torch.engine.local import validate_optimizer
from dopt_torch.engine.oracle import (OracleWorker, consensus, nhwc_to_nchw,
                                      port_to_twin, torch_logistic, torch_mlp,
                                      torch_reference_cnn, twin_to_port)
from dopt_torch.models.zoo import deterministic, full_f32
from dopt_torch.topology import build_mixing_matrices
from dopt_torch.utils.metrics import History
from dopt_torch.utils.profiling import PhaseTimers
from dopt_torch.utils.prng import host_rng


def _twin_factory(model_cfg, device):
    """A callable building one worker's torch twin of the zoo model on
    ``device`` (parameters zero until a state is loaded)."""
    name = model_cfg.model.lower()
    shape = model_cfg.input_shape
    ncls = model_cfg.num_classes
    if name in ("model1", "model3"):
        spatial, in_ch = shape[0], shape[-1]
        hidden = 512 if name == "model1" else 256
        return lambda: torch_reference_cnn(in_ch, spatial, hidden,
                                           num_classes=ncls,
                                           faithful=model_cfg.faithful,
                                           device=device)
    if name in ("mlp", "logistic"):
        if len(shape) > 1 and shape[-1] != 1:
            raise ValueError(
                f"torch backend {name} supports flat or single-channel "
                f"inputs only (NCHW/NHWC flatten orders differ for "
                f"C={shape[-1]})")
        flat = math.prod(shape)
        if name == "mlp":
            return lambda: torch_mlp(flat, num_classes=ncls,
                                     faithful=model_cfg.faithful,
                                     device=device)
        return lambda: torch_logistic(flat, num_classes=ncls,
                                      faithful=model_cfg.faithful,
                                      device=device)
    raise ValueError(
        f"model {name!r} has no torch reference twin (the faithful backend "
        "covers the reference surface: model1|model3|mlp|logistic)")


def _layout_converter(model_cfg):
    """NHWC → NCHW for image models, the identity for flat features
    (keyed off the model's input shape: a gathered flat-feature stack
    is 4-D too)."""
    if len(model_cfg.input_shape) >= 3:
        return nhwc_to_nchw
    return lambda x: x


class _TorchTrainerBase:
    """Shared setup: data, partition, holdout, eval stacks and the fleet
    of twins, every one loaded with the engines' init."""

    def __init__(self, cfg: ExperimentConfig, section, *, device=None,
                 init_params=None):
        validate_optimizer(cfg)
        self.device = dev = resolve_device(device)
        self.cfg = cfg
        self.round = 0
        self.history = History(cfg.name)
        self.client_history = History(cfg.name + "-clients")
        self.timers = PhaseTimers()
        self.total_time = 0.0
        w = cfg.data.num_users
        self.num_workers = w

        self.dataset = load_dataset(
            cfg.data.dataset, data_dir=cfg.data.data_dir,
            train_size=cfg.data.synthetic_train_size,
            test_size=cfg.data.synthetic_test_size, seed=cfg.seed,
            input_shape=cfg.model.input_shape,
            num_classes=cfg.model.num_classes)
        _, self.index_matrix = partition(
            self.dataset.train_y, w, iid=cfg.data.iid,
            shards_per_user=cfg.data.shards, seed=cfg.seed)
        self._to_nchw = _layout_converter(cfg.model)
        self._holdout = cfg.data.local_holdout > 0.0
        if self._holdout:
            self._train_matrix, val_matrix = holdout_split(
                self.index_matrix, fraction=cfg.data.local_holdout,
                mode=cfg.data.holdout_mode, seed=cfg.seed)
            vi, vw = stacked_eval_batches(val_matrix,
                                          batch_size=section.local_bs)
            self._val_x = self._to_nchw(self.dataset.train_x[vi])
            self._val_y = self.dataset.train_y[vi]
            self._val_w = vw
        else:
            self._train_matrix = self.index_matrix
        ex, ey, ew = eval_batches(self.dataset.test_x, self.dataset.test_y,
                                  batch_size=max(section.local_bs, 256))
        self._eval = (self._to_nchw(ex), ey, ew)

        # The stacked engines' init: dopt's flax tree, or the seeded draw.
        make = _twin_factory(cfg.model, dev)
        self._init_state = port_to_twin(
            {k: v.float() for k, v in initial_params(cfg, init_params).items()},
            dev)
        self.workers: list[OracleWorker] = []
        for _ in range(w):
            m = make()
            m.load_state_dict(self._init_state)
            self.workers.append(OracleWorker(
                m, lr=cfg.optim.lr, momentum=cfg.optim.momentum,
                rho=cfg.optim.rho, l2=cfg.optim.weight_decay,
                algorithm=self._worker_algorithm()))

    def _worker_algorithm(self) -> str:
        return "sgd"

    def _flags(self):
        """Full f32 and the deterministic mode on CUDA; torch's default
        flags on the CPU (dopt's oracle sets none)."""
        import contextlib

        if self.device.type != "cuda":
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(full_f32(self.device))
        stack.enter_context(deterministic(self.device))
        return stack

    def _round_batches(self, t: int, worker_ids=None):
        """NCHW [m, S, B, ...] batch stacks for round t: the engines'
        plan (same seed keying, same ``plan_impl``)."""
        s = self._section()
        plan = make_batch_plan(
            self._train_matrix, batch_size=s.local_bs, local_ep=s.local_ep,
            seed=self.cfg.seed, round_idx=t, impl=self.cfg.data.plan_impl,
            workers=worker_ids)
        bx = self._to_nchw(self.dataset.train_x[plan.idx])
        by = self.dataset.train_y[plan.idx]
        return bx, by, plan.weight

    def _local_round(self, i: int, bx, by, bw, t: int, *, theta=None,
                     c_global=None, schema: str = "p2"
                     ) -> tuple[float, float]:
        """One worker's local epochs: (mean loss, train accuracy); with
        the holdout on, the per-epoch client-history rows too."""
        wk = self.workers[i]
        s = self._section()
        if self._holdout:
            e = s.local_ep
            sp = bx.shape[0] // e
            rows = wk.local_update_epochs(
                bx.reshape(e, sp, *bx.shape[1:]),
                by.reshape(e, sp, *by.shape[1:]),
                bw.reshape(e, sp, *bw.shape[1:]),
                self._val_x[i], self._val_y[i], self._val_w[i],
                theta=theta, c_global=c_global,
                val_flavor="sum" if schema == "p1" else "mean")
            for r in rows:
                if schema == "p1":
                    self.client_history.append(
                        global_round=t, epoch=r["epoch"], worker=i,
                        train_loss=r["train_loss"], train_acc=r["train_acc"],
                        val_acc=r["val_acc"], val_loss=r["val_loss"])
                else:
                    self.client_history.append(
                        round=t, iter=r["epoch"], worker=i,
                        train_loss=r["train_loss"], train_acc=r["train_acc"],
                        val_acc=r["val_acc"], val_loss=r["val_loss"])
            return (float(np.mean([r["train_loss"] for r in rows])),
                    float(np.mean([r["train_acc"] for r in rows])))
        losses: list[float] = []
        ct = [0.0, 0.0]
        wk._epoch_steps(bx, by, bw, theta, c_global, losses, ct)
        return float(np.mean(losses)), ct[0] / max(ct[1], 1.0)

    def save(self, path) -> None:
        raise ValueError(
            "backend='torch' is the validation oracle and does not "
            "checkpoint; use backend='jax' for resumable training")

    restore = save

    def worker_params(self) -> dict[str, np.ndarray]:
        """Every worker's parameters in the port's layout, stacked
        ``[W, ...]`` (the stacked engines' ``worker_params``)."""
        states = [twin_to_port(wk.model.state_dict()) for wk in self.workers]
        return {k: np.stack([s[k] for s in states]) for k in states[0]}

    def params_as_flax(self) -> dict:
        """The fleet's parameters as dopt's stacked ``[W, ...]`` flax tree
        (numpy leaves), the cross-package comparison hook."""
        return params_to_jax(self.worker_params(),
                             input_shape=self.cfg.model.input_shape)


class OracleGossipTrainer(_TorchTrainerBase):
    """The reference's project-2 execution: sequential workers, a
    two-phase synchronous consensus, then each client's eval, then its
    local update."""

    def __init__(self, cfg: ExperimentConfig, *, device=None,
                 init_params=None):
        g = cfg.gossip
        if g is None:
            raise ValueError("cfg.gossip must be set")
        if g.algorithm not in ("dsgd", "nocons", "centralized", "fedlcon"):
            raise ValueError(
                f"torch backend supports gossip dsgd|nocons|centralized|"
                f"fedlcon (the reference surface), not {g.algorithm!r}")
        if g.dropout > 0:
            raise ValueError("dropout fault injection is a jax-backend "
                             "feature (the reference has no failures)")
        if g.algorithm == "centralized":
            # The engines' frozen-config rewrite.
            cfg = cfg.replace(
                data=dataclasses.replace(cfg.data, num_users=1, iid=True),
                gossip=dataclasses.replace(g, local_ep=1,
                                           algorithm="nocons"))
            g = cfg.gossip
        super().__init__(cfg, g, device=device, init_params=init_params)
        self.mixing = (build_mixing_matrices(
            g.topology, g.mode, self.num_workers, seed=cfg.seed,
            self_weight=g.self_weight, groups=g.hier_groups,
            period=g.hier_period)
            if g.algorithm in ("dsgd", "fedlcon") else None)

    def _section(self):
        return self.cfg.gossip

    def run(self, rounds: int | None = None, eps: int | None = None,
            **_) -> History:
        g = self.cfg.gossip
        rounds = g.rounds if rounds is None else rounds
        if eps is not None and eps != g.eps and g.algorithm == "fedlcon":
            raise ValueError("set eps in GossipConfig (static for the "
                             "jax engine's compilation; kept consistent "
                             "here)")
        eps = g.eps if (g.algorithm == "fedlcon"
                        and not g.faithful_bugs) else 1
        t0 = time.perf_counter()  # dopt: allow-wallclock -- total_time wall meter, reporting only
        with self._flags():
            for _ in range(rounds):
                self._round(self.round, eps)
                self.round += 1
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.total_time = time.perf_counter() - t0  # dopt: allow-wallclock -- total_time wall meter, reporting only
        return self.history

    def _round(self, t: int, eps: int) -> None:
        w = self.num_workers
        if self.mixing is not None:
            w_t = self.mixing.for_round(t)
            for _sweep in range(eps):
                states = [wk.state() for wk in self.workers]
                new = [consensus([(float(w_t[i, j]), states[j])
                                  for j in range(w) if w_t[i, j] > 0])
                       for i in range(w)]
                for wk, st in zip(self.workers, new):
                    wk.load(st)
        accs, losses_m = [], []
        for wk in self.workers:
            a, _s, m = wk.inference(*self._eval)
            accs.append(a)
            losses_m.append(m)
        bx, by, bw = self._round_batches(t)
        tl, ta = [], []
        for i in range(w):
            loss, acc = self._local_round(i, bx[i], by[i], bw[i], t,
                                          schema="p2")
            tl.append(loss)
            ta.append(acc)
        self.history.append(
            round=t, avg_train_loss=float(np.mean(tl)),
            avg_train_acc=float(np.mean(ta)),
            avg_test_acc=float(np.mean(accs)),
            avg_test_loss=float(np.mean(losses_m)))

    def evaluate(self) -> dict[str, np.ndarray]:
        with self._flags():
            out = [wk.inference(*self._eval) for wk in self.workers]
        return {"acc": np.array([o[0] for o in out]),
                "loss_sum": np.array([o[1] for o in out]),
                "loss_mean": np.array([o[2] for o in out])}


class OracleFederatedTrainer(_TorchTrainerBase):
    """The reference's project-1 execution: a server round that samples
    clients from the engines' stream, trains the sampled clients one
    after the other and averages them uniformly."""

    def __init__(self, cfg: ExperimentConfig, *, device=None,
                 init_params=None):
        f = cfg.federated
        if f is None:
            raise ValueError("cfg.federated must be set")
        if f.algorithm not in ("fedavg", "fedprox", "fedadmm", "scaffold"):
            raise ValueError(f"unknown federated algorithm {f.algorithm!r}")
        super().__init__(cfg, f, device=device, init_params=init_params)
        self.theta = {k: v.clone() for k, v in self._init_state.items()}
        self.c_global = ({k: torch.zeros_like(v)
                          for k, v in self._init_state.items()}
                         if f.algorithm == "scaffold" else None)
        self._sample_rng = host_rng(cfg.seed, 314159)
        # Per-worker train-split eval stacks (avg_trainig_calculator).
        ti, tw = stacked_eval_batches(self._train_matrix,
                                      batch_size=max(f.local_bs, 256))
        self._train_eval = (self._to_nchw(self.dataset.train_x[ti]),
                            self.dataset.train_y[ti], tw)

    def _section(self):
        return self.cfg.federated

    def _worker_algorithm(self) -> str:
        return {"fedavg": "sgd"}.get(self.cfg.federated.algorithm,
                                     self.cfg.federated.algorithm)

    def run(self, frac: float | None = None, rounds: int | None = None,
            **_) -> History:
        f = self.cfg.federated
        frac = f.frac if frac is None else frac
        rounds = f.rounds if rounds is None else rounds
        t0 = time.perf_counter()  # dopt: allow-wallclock -- total_time wall meter, reporting only
        with self._flags():
            for _ in range(rounds):
                self._round(self.round, frac)
                self.round += 1
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.total_time = time.perf_counter() - t0  # dopt: allow-wallclock -- total_time wall meter, reporting only
        return self.history

    def _round(self, t: int, frac: float) -> None:
        algo = self.cfg.federated.algorithm
        m = max(int(frac * self.num_workers), 1)
        sel = np.sort(self._sample_rng.choice(self.num_workers, m,
                                              replace=False))
        bx, by, bw = self._round_batches(t, worker_ids=sel)
        local_losses = []
        theta_named = dict(self.theta)
        # Every sampled worker trains against (and refreshes its control
        # from) the round-start server control; the deltas land once
        # after the loop, as the engines' control_delta.
        c_round = ({k: v.clone() for k, v in self.c_global.items()}
                   if algo == "scaffold" else None)
        for j, i in enumerate(sel):
            wk = self.workers[i]
            wk.load(self.theta)
            if algo == "scaffold":
                # Fresh momentum each round: theta − y reflects only
                # this round's gradients.
                wk.optimizer.state.clear()
            needs_theta = algo in ("fedprox", "fedadmm")
            loss, _acc = self._local_round(
                int(i), bx[j], by[j], bw[j], t,
                theta=theta_named if needs_theta else None,
                c_global=c_round, schema="p1")
            local_losses.append(loss)
            if algo == "fedadmm":
                wk.update_duals(theta_named)
            elif algo == "scaffold":
                steps = bw.shape[1]
                lr_eff = self.cfg.optim.lr / max(
                    1.0 - self.cfg.optim.momentum, 1e-8)
                delta = wk.update_controls(theta_named, c_round, lr_eff,
                                           steps)
                with torch.no_grad():
                    for k in self.c_global:
                        self.c_global[k] += delta[k] / self.num_workers
        with torch.no_grad():
            states = [self.workers[i].state() for i in sel]
            self.theta = {k: sum(st[k] for st in states) / len(states)
                          for k in self.theta}
        acc, loss_sum, _lm = self._probe(*self._eval)
        tl, ta = [], []
        for i, wk in enumerate(self.workers):
            a, _s, lm = wk.inference(self._train_eval[0][i],
                                     self._train_eval[1][i],
                                     self._train_eval[2][i])
            tl.append(lm)
            ta.append(a)
        self.history.append(
            round=t, test_acc=float(acc), test_loss=float(loss_sum),
            train_loss=float(np.mean(tl)), train_acc=float(np.mean(ta)),
            local_loss=float(np.mean(local_losses)))

    def _probe(self, bx, by, bw) -> tuple[float, float, float]:
        """theta's metrics on a stack, through worker 0's model (its own
        state put back after)."""
        probe = self.workers[0]
        saved = probe.state()
        probe.load(self.theta)
        out = probe.inference(bx, by, bw)
        probe.load(saved)
        return out

    def global_params(self) -> dict[str, np.ndarray]:
        """theta in the port's layout (the stacked engine's
        ``global_params``)."""
        return twin_to_port(self.theta)

    def theta_as_flax(self) -> dict:
        """theta as dopt's flax tree (numpy leaves)."""
        return params_to_jax(self.global_params(),
                             input_shape=self.cfg.model.input_shape)

    def evaluate_global(self) -> dict[str, float]:
        with self._flags():
            acc, loss_sum, loss_mean = self._probe(*self._eval)
        return {"acc": acc, "loss_sum": loss_sum, "loss_mean": loss_mean}


def build_torch_trainer(cfg: ExperimentConfig, device=None,
                        init_params=None):
    """The ``backend='torch'`` factory (``dopt_torch.run.build_trainer``
    routes here), on ``device`` (the GPU when None)."""
    if cfg.seqlm is not None:
        raise ValueError("seqlm has no torch reference backend (the "
                         "reference has no sequence axis)")
    if cfg.federated is not None:
        return OracleFederatedTrainer(cfg, device=device,
                                      init_params=init_params)
    return OracleGossipTrainer(cfg, device=device, init_params=init_params)
