"""Sequence-parallel LM training: dopt's ``SeqLMTrainer``
(dopt/engine/seqlm.py) on PyTorch.

``python -m dopt_torch.run --preset seqlm`` trains a decoder-only
``TransformerLM`` with the SEQUENCE axis split over the launched ranks
(``make_seq_group``; one rank runs a one-block ring).  Rank r holds
positions [r·L/R, (r+1)·L/R) of every window; the position-wise layers
run on that block with no communication, and only attention crosses
ranks, through ``ring_attention`` or ``ulysses_attention``
(``dopt_torch.parallel.sequence``).

Data is dopt's: the synthetic order-1 Markov token stream
(``markov_token_stream``, bit for bit) sliced into ``[B, L]`` windows by
a per-step plan from ``SeedSequence([seed, 777_001])``.  Every rank
draws the same plan and uploads the whole host batch, so a rank's
targets need no halo exchange: position p's target is token p + 1, and
only the global last position has none.

One step: each rank sums the NLL of its positions (f32 ``log_softmax``
of the logits), differentiates that sum over B·(L−1), and the gradients
of the replicated parameters — with the NLL sums riding along — are
all-gathered and summed in rank order (``lane_sum``'s rule), so runs
repeat bit for bit and NCCL gives gloo's bits.  The global loss is the
rank-order sum of the NLL sums over B·(L−1), dopt's mean.  The update is
the port's plain ``optim.sgd_step`` (dopt's unfused ``sgd_step``):
neither CUDA kernel runs on this path.  Losses stay on the device until
the run ends.  The run sits in ``deterministic`` and ``full_f32``, as
the engines' rounds do.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from dopt_torch.config import ExperimentConfig
from dopt_torch.convert import params_to_jax, port_layout
from dopt_torch.engine.gossip import DTYPES, resolve_device
from dopt_torch.engine.local import validate_optimizer
from dopt_torch.models.zoo import (TransformerLM, count_params, deterministic,
                                   full_f32, init_transformer_params,
                                   transformer_shapes)
from dopt_torch.optim import sgd_step
from dopt_torch.parallel.collectives import _all_gather
from dopt_torch.parallel.mesh import make_seq_group
from dopt_torch.parallel.sequence import ring_attention, ulysses_attention
from dopt_torch.utils.checkpoint import (copy_into, load_checkpoint,
                                         save_rank_checkpoint)
from dopt_torch.utils.metrics import History
from dopt_torch.utils.profiling import PhaseTimers

ATTN = ("ring", "ulysses", "dense")


def markov_token_stream(vocab: int, n_tokens: int, *, seed: int,
                        branching: int = 4) -> np.ndarray:
    """dopt's synthetic corpus, bit for bit: an order-1 Markov chain in
    which each token has ``branching`` permitted successors (seeded
    uniform choice among them).  Perfect next-token prediction reaches
    ``log(branching)`` nats; an untrained model sits at ``log(vocab)``."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 94_227]))
    table = np.stack([rng.choice(vocab, branching, replace=False)
                      for _ in range(vocab)])
    out = np.empty(n_tokens, np.int32)
    out[0] = rng.integers(vocab)
    draws = rng.integers(branching, size=n_tokens)
    for t in range(1, n_tokens):
        out[t] = table[out[t - 1], draws[t]]
    return out


class SeqLMTrainer:
    """Train ``TransformerLM`` with sequence-parallel attention.

    ``mesh_devices`` (default ``cfg.mesh_devices``) is the rank count the
    sequence splits over: the launched world, or 1.  ``device`` is CUDA
    unless ``"cpu"`` (a CUDA request without a GPU raises).
    ``init_params`` takes dopt's flax params tree (numpy leaves) in place
    of the port's own init, which draws flax's distributions from a
    ``torch.Generator`` seeded with ``cfg.seed``."""

    def __init__(self, cfg: ExperimentConfig, *,
                 mesh_devices: int | None = None, device=None,
                 init_params=None):
        if cfg.seqlm is None:
            raise ValueError("cfg.seqlm must be set for SeqLMTrainer")
        s = cfg.seqlm
        if s.attn not in ATTN:
            raise ValueError(
                f"unknown attn {s.attn!r}; one of ring|ulysses|dense")
        validate_optimizer(cfg)
        if cfg.model.compute_dtype not in DTYPES:
            raise ValueError(f"unknown model.compute_dtype "
                             f"{cfg.model.compute_dtype!r}; one of "
                             f"{'|'.join(DTYPES)}")
        self.cfg = cfg
        self.step = 0
        self.total_time = 0.0
        self.history = History(cfg.name)
        self.timers = PhaseTimers()
        self.device = resolve_device(device)

        n = mesh_devices if mesh_devices is not None else cfg.mesh_devices
        self.group = make_seq_group(n)
        d = self.group.size
        if s.attn == "dense" and d != 1:
            raise ValueError(
                "attn='dense' is the single-device path; use ring/ulysses "
                f"on a {d}-device mesh")
        if s.seq_len % d:
            raise ValueError(f"seq_len {s.seq_len} not divisible by the "
                             f"{d}-device mesh")
        if s.attn == "ulysses" and s.heads % d:
            raise ValueError(f"ulysses needs heads ({s.heads}) divisible by "
                             f"the mesh size ({d})")
        if s.kv_chunk and s.attn != "ring":
            raise ValueError("kv_chunk only applies to attn='ring'")
        if s.dim % s.heads:
            raise ValueError(f"dim {s.dim} not divisible by heads {s.heads}")
        self.block = s.seq_len // d
        kv_chunk = s.kv_chunk or None
        if kv_chunk is not None and (kv_chunk <= 0 or self.block % kv_chunk):
            raise ValueError(f"kv_chunk {kv_chunk} must divide the "
                             f"per-device block {self.block}")
        group = self.group
        if s.attn == "ring":
            self._attn = lambda q, k, v: ring_attention(
                q, k, v, group, causal=True, kv_chunk=kv_chunk)
        elif s.attn == "ulysses":
            self._attn = lambda q, k, v: ulysses_attention(q, k, v, group,
                                                           causal=True)
        else:
            self._attn = None   # the model's dense causal attention

        # The stream stays on the host: a step's batch is host slicing
        # and one upload.
        self._stream = markov_token_stream(
            s.vocab, max(s.batch * s.seq_len * 8, 65_536), seed=cfg.seed)
        self._n_windows = len(self._stream) - s.seq_len - 1
        self._rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, 777_001]))

        want = transformer_shapes(vocab=s.vocab, dim=s.dim, depth=s.depth,
                                  max_len=s.seq_len)
        if init_params is None:
            p0 = init_transformer_params(
                vocab=s.vocab, dim=s.dim, depth=s.depth, max_len=s.seq_len,
                generator=torch.Generator().manual_seed(cfg.seed))
        else:
            p0 = {k: torch.from_numpy(np.asarray(v, np.float32))
                  for k, v in port_layout(init_params).items()}
            got = {k: tuple(v.shape) for k, v in p0.items()}
            if got != want:
                raise ValueError(f"init_params shapes {got} do not match "
                                 f"the transformer's {want}")
        self.param_count = count_params(p0)
        self.model = TransformerLM(
            {k: v.to(self.device) for k, v in p0.items()}, heads=s.heads,
            dtype=DTYPES[cfg.model.compute_dtype])
        self.params = dict(self.model.named_parameters())
        self.momentum = {k: torch.zeros_like(v, requires_grad=False)
                         for k, v in self.params.items()}
        self._lr, self._mu = cfg.optim.lr, cfg.optim.momentum

    @property
    def round(self) -> int:   # the CLI's surface
        return self.step

    def _batch(self) -> torch.Tensor:
        """The next ``[B, L]`` host batch from the plan, on the device
        (every rank draws the same plan)."""
        s = self.cfg.seqlm
        starts = self._rng.integers(self._n_windows, size=s.batch)
        toks = np.stack([self._stream[a:a + s.seq_len] for a in starts])
        return torch.from_numpy(toks.astype(np.int64)).to(self.device)

    def _nll_sum(self, tokens: torch.Tensor) -> torch.Tensor:
        """This rank's summed NLL: its block of positions against the next
        token of the whole host batch."""
        s, g = self.cfg.seqlm, self.group
        lo = g.rank * self.block
        logits = self.model(tokens[:, lo:lo + self.block], self._attn,
                            offset=lo)
        n = min(self.block, s.seq_len - 1 - lo)   # positions with a target
        logp = torch.log_softmax(logits[:, :n].float(), dim=-1)
        tgt = tokens[:, lo + 1:lo + 1 + n]
        # The target's log-probability as a one-hot product: elementwise
        # in both directions, where a gather's (or nll_loss's) backward
        # scatters into the logits' gradient — an op the deterministic
        # mode refuses or serialises on CUDA.
        hot = tgt[..., None] == torch.arange(s.vocab, device=tgt.device)
        return -(logp * hot).sum()

    def _train_step(self, tokens: torch.Tensor) -> torch.Tensor:
        """One SGD step in place; returns the global mean loss (on the
        device)."""
        s, g = self.cfg.seqlm, self.group
        count = s.batch * (s.seq_len - 1)
        names = list(self.params)
        nll = self._nll_sum(tokens)
        grads = torch.autograd.grad(nll / count,
                                    [self.params[k] for k in names])
        if g.wire:
            flat = torch.cat([x.reshape(-1) for x in grads]
                             + [nll.detach().reshape(1)])
            flat = _all_gather(flat[None], g, "grad").sum(0)
            grads = [t.view_as(x) for t, x in zip(
                flat[:-1].split([x.numel() for x in grads]), grads)]
            nll = flat[-1]
        sgd_step([self.params[k] for k in names],
                 [self.momentum[k] for k in names], grads, lr=self._lr,
                 momentum=self._mu)
        return nll.detach() / count

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, rounds: int | None = None, steps: int | None = None
            ) -> History:
        """Train ``steps`` steps (``rounds`` is an alias, so the CLI's
        --rounds works unchanged; default ``seqlm.steps``).  A loss row
        every ``log_every`` steps and one at the run's last step."""
        s = self.cfg.seqlm
        n = steps if steps is not None else (rounds if rounds is not None
                                             else s.steps)
        t0 = time.perf_counter()  # dopt: allow-wallclock -- total_time wall meter, reporting only
        logged: list[tuple[int, torch.Tensor]] = []
        with deterministic(self.device), full_f32(self.device):
            for i in range(n):
                with self.timers.phase("host_batch_plan"):
                    toks = self._batch()
                with self.timers.phase("round_step"):
                    loss = self._train_step(toks)
                    self._sync()
                # i (run-relative) decides the always-log-the-last-step
                # rule, so resumed runs close with a loss row too.
                if self.step % s.log_every == 0 or i == n - 1:
                    logged.append((self.step, loss))
                self.step += 1
        self._sync()
        self.total_time = time.perf_counter() - t0  # dopt: allow-wallclock -- total_time wall meter, reporting only
        if logged:
            vals = torch.stack([v for _, v in logged]).cpu().numpy()
            for (st, _), v in zip(logged, vals):
                self.history.append(round=st, step=st, loss=float(v))
        return self.history

    def save(self, path) -> None:
        """dopt's checkpoint: params and momentum as flax trees, the
        step, the History and the batch plan's numpy state.  The
        parameters are the same on every rank: rank 0 writes, every rank
        waits."""
        save_rank_checkpoint(
            self.group, path,
            arrays={"params": params_to_jax(self.params),
                    "momentum": params_to_jax(self.momentum)},
            meta={"round": self.step, "name": self.cfg.name,
                  "algorithm": "seqlm", "history": self.history.rows,
                  "data_rng_state": self._rng.bit_generator.state},
            replicated=("params", "momentum"))

    def restore(self, path) -> None:
        """Load a checkpoint of either package (dopt's flax layout or
        the port's) into this trainer, in place."""
        arrays, meta = load_checkpoint(path)
        if meta.get("algorithm") != "seqlm":
            raise ValueError(
                f"checkpoint is for {meta.get('algorithm')!r}, not seqlm")
        copy_into(self.params, port_layout(arrays["params"]), what="params")
        copy_into(self.momentum, port_layout(arrays["momentum"]),
                  what="momentum")
        self.step = int(meta["round"])
        self.history.rows = list(meta.get("history", []))
        if meta.get("data_rng_state"):
            self._rng.bit_generator.state = meta["data_rng_state"]
