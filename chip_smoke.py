#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (dopt_torch) on one CUDA GPU.

    python3 chip_smoke.py        # from the repo root; one GPU, nvcc
    python3 chip_smoke.py --conv-ab   # only the rounded-layer A/B
    python3 chip_smoke.py --resnet-ab DIR  # ResNet-18's f32 step, this
                                           # tree against DIR's

Phases, each printing its own lines; any failure exits non-zero before
the final line:

1. environment — nvidia-smi name and power limit, torch/CUDA versions;
2. build — nvcc builds dopt_torch/csrc into build/ (timed) and ptxas
   reports each kernel's registers, stack frame and spills; the phase
   fails if any instantiation of kernel 2 (its narrow and ring kernels,
   f32 and bf16) has a stack frame or spills (the spill guard);
3. kernels — each CUDA kernel against its plain PyTorch version on the
   card at both main paths' shapes, in f32 and in bf16 storage (plus
   odd and strided cases),
   with the tolerance stated, and CUDA-event median times (cold L2) of
   the kernel, the plain version and one library call computing the
   same function, beside the bound (bytes over 3.35 TB/s, operations
   over the f32 peak): gossip (6 workers, kernel 2 at lr = 1) and
   federated (16 lanes, kernel 2 at lr = −1 with M = mask/Σmask), a
   sweep of kernel 2 at n = 6, 12, 16 and 32 over the federated bucket
   widths, and kernel 2's two kernels (narrow, ring) timed in turns at
   n = 6, the A/B behind the wrapper sending n <= 8 to the narrow one;
4. small-input agreement — tiny runs on the GPU against the same runs
   on the CPU (the kernels' plain versions), same init: gossip with both
   fused switches, federated fedavg with both fused switches, and
   federated fedadmm on the compact path with the 10% holdout; then in
   bf16, each beside the same run's GPU f32 leg: gossip idiomatic bf16
   (clip 1.0, fused on), and federated fedprox on the compact path with
   bf16 storage, clip 1.0 and the 10% holdout;
5. gossip main path — the headline-dsgd-model1 preset (6 workers,
   Model1 at full width, 60,000/10,000 samples, both fused switches on)
   for two rounds through GossipTrainer; checks finite metrics and that
   every kernel launched exactly as often as the round structure
   implies;
5b. federated main path — the headline-fedavg-model1 preset (16
   clients, 8 sampled a round, full width, Model1, 60,000/10,000, both
   fused switches on) for two rounds through FederatedTrainer, with the
   same checks;
5c. the federated path users run — baseline3 as typed (compact: only
   the 8 sampled lanes train; plain SGD update, so no kernel of the
   port runs) for one round, timed beside 5b;
5d/5e. the JAX bench's fast legs — headline-dsgd-model1-bf16 (two
   rounds) and headline-dsgd-model1-idiomatic-bf16 (one) (bf16 compute,
   f32 storage), rounds/s against phase 5's f32 headline;
5f. bf16 storage — headline-fedavg-model1 (one round) and
   headline-dsgd-model1 (two) with bf16 compute and storage, with the
   launch counts and the dtype every kernel launch received;
6. profile — one more round of the gossip path under
   ``dopt_torch.utils.profiling.device_stats_of`` (torch.profiler, the
   device activity): device time by kernel and by phase (conv, comm,
   update, other, from the kernel names alone), every kernel that fell
   to other, busy time, idle share; each hand kernel's occurrences in
   the trace equal its launches in the round (316 and 2);
7a. determinism — the trainers run in the deterministic mode on the card
   (dopt_torch.models.deterministic; the flags are printed):
   headline-dsgd-model1 runs two rounds again and must equal phase 5's
   run bit for bit (History, final params, momentum, the fused carry),
   and a tiny fedadmm run with the 10% holdout runs twice, bit-identical;
7b. blocks — blocked runs replay a CUDA graph of the round
   (dopt_torch.engine.graphs) and must equal the per-round runs bit for
   bit, launch counts included: headline-dsgd-model1, block 2, against
   phase 5; headline-dsgd-model1-bf16, block 2, against 5d;
   headline-fedavg-model1, block 2, with prefetch off and on, against
   5b; then tiny blocked runs (3 rounds in blocks of 2) against their
   own per-round runs: gossip with both fused switches, gossip with bf16
   storage and clip 1.0, fedprox compact with bf16 storage, clip and the
   holdout, fedadmm compact with the holdout, scaffold at full width;
7c. rates — per-round (one round after a warm-up round) against
   blocked (one block of 2 after a warm-up block) on
   headline-dsgd-model1-bf16 and headline-dsgd-model1
   with eval_every beyond the run (dopt bench's shape): rounds/s, peak
   memory, each graph's capture and instantiate time and node count,
   and one blocked f32 round under the profiler, as phase 6 (the
   kernels of a graph replay, named and counted one by one);
8. checkpoint and resume — 8a/8b/8c: headline-dsgd-model1 (f32),
   headline-fedavg-model1 and headline-dsgd-model1 with bf16 compute and
   storage: a trainer runs round 0 with checkpoint_every=1 (the kill), a
   fresh trainer restores the checkpoint and runs round 1; the pair must
   equal phase 5's, 5b's and 5f's 2-round runs bit for bit (History,
   params, momentum, the fused carry, theta, the client sample of round
   1 and the sampling stream), with the same kernel launches; prints the
   checkpoint's bytes on disk and the save and restore seconds.  8d:
   tiny configurations, 5 rounds in blocks of 2 with prefetch and
   checkpoint_every=2: resumed from the round-2 and the round-4
   checkpoints, and the round-2 checkpoint restored into a trainer whose
   graphs were already captured, each equal to the continuous run bit
   for bit (gossip with both fused switches, fedavg fused, fedadmm
   compact with the holdout, scaffold at full width); a fused gossip
   checkpoint restored into an unfused trainer must raise.  The
   checkpoints go to a temporary directory, removed at the end;
9. the paths of the dense models and the gossip algorithms at full width
   (dopt's presets, one round each but 9c's two, finite metrics, launch
   counts as the round structure implies, rounds/s and peak memory): 9a
   reference-gossip with both fused switches (Model1, 6 workers, a
   matching drawn each round into kernel 2); 9b baseline2 with both
   switches (Model3 on CIFAR-10-shaped data, 50,000/10,000, 16 workers,
   kernel 2's ring kernel at lr +1); 9c baseline1 with both switches
   (MLP, 4 workers); 9d baseline4 with optim.fused_update (logistic
   fedadmm on a9a-shaped data, 16 lanes); 9e reference-fedlcon (5
   sweeps), reference-nocons-noniid and reference-centralized (one
   round) with optim.fused_update.  9f: the matching path at
   6,000/1,000 samples and one local epoch, 3 rounds, twice, blocked
   (blocks of 2, prefetch on) and killed after round 1 and resumed, each
   bit for bit the per-round run (the matching stream included); and
   9c's baseline1 blocked against per-round; 9g times baseline1
   per-round against blocked (as 7c; 2 timed rounds each).

Phase 3 also holds both kernels at this slice's call sites (3b): kernel
1 over the MLP (4 workers), Model3 (16 lanes, 32×32×3), logistic (16
lanes) and single-worker Model1 steps; kernel 2 over the MLP store at
n = 4 (the metropolis ring), Model3's at n = 16 with a dense doubly
stochastic W at lr +1 and Model1's at n = 6 with a matching, plus
baseline2's ring schedule and a matching at n = 5 (an identity row).
Phase 4 also runs the MLP dsgd, the logistic fedadmm, matching, fedlcon
(eps 3) and the sharded eval small on the GPU against the CPU.

10. the gossip fault model at full width (MNIST-sized synthetic sets):
   10a bench-chaos-baseline1-lossy as typed (bench.py's chaos cocktail:
   4-worker MLP, bf16 compute, native plans, lossy links, stragglers,
   scale lies, quarantine armed), 2 rounds per-round and then as one
   block of 2 (CUDA-graph replays): History, ledger (content and order) and
   final state bit-identical, the ledger equal to the one the host
   stage computes with no device run, rounds/s, peak memory and the
   idle share of a profiled blocked round and the steady rate of 2
   replayed rounds; 10b the same (unprofiled) with optim.fused_update (kernel 1 gated by the straggler budget, one
   launch a step); 10c baseline1-faulty with both fused switches
   (kernel 2 on crash- and partition-repaired matrices, one round),
   baseline1-byzantine for 9 rounds in blocks of 3 (the quarantine
   fires at round 2 and readmits at round 8) and baseline1-lossy
   (push-sum: node mass plus in-flight mass is 4, one round); 10d
   headline-dsgd-model1-faulty (Model1, 6 workers, both kernels),
   killed after round 0 and resumed, bit-identical to the continuous
   run; 10e the new call sites timed as 3b times the others: kernel 1
   gated (bit-identical to torch.where over the plain step) at the MLP
   and Model1 widths, kernel 2 on repaired matrices at n = 4 and n = 6.
Phase 2 builds the native planner (g++) beside the kernels, and phase 4
also runs two small faulty configurations on the GPU against the CPU.

11. the federated fault model at full width (MNIST-sized synthetic
   sets; ``phase11``): 11a headline-fedavg-model1-faulty (16 lanes,
   crash, partial stragglers, over-selection, partitions; kernel 1 gated
   by the straggler budget, kernel 2 on the survivors' mask), 2 rounds
   with the launch counts the rounds imply and the ledger equal to the
   host stage's, killed after round 0 and resumed, and in blocks of 2,
   each bit for bit; 11b baseline3-faulty as typed (compact, fixed-width
   lanes, no kernel), 2 rounds per-round and in one block; 11c
   baseline3-byzantine (signflip liars, trimmed mean) at 15,000/2,500
   samples one round, then one
   round each under the mean, median, Krum, multi-Krum and the mean with
   clip_radius 1.0, and each aggregation call timed alone on 8 Model1
   lanes with its peak memory (the five one-round runs at one local
   epoch, the preset's five in the trimmed-mean run); 11d baseline3-elastic (drop stragglers,
   lossy and delayed uplinks, churn, the staleness buffer) at
   15,000/2,500 samples 3 rounds
   per-round and in blocks of 2 through the chaos round (History,
   ledger, theta, the buffer and the counters bit for bit); 11e baseline3 with two
   pinned nan liars and the quarantine (after 2, for 3 rounds) at
   6,000/1,000 samples, 6 rounds per-round and in blocks of 3, the
   quarantine benching worker 0 at round 1 and readmitting it at 5;
   11f the two new kernel sites timed as 3b times the others.

12. async and one-peer mixing, telemetry and on-card diagnostics
   (``phase12``): 12a bench.py's topology-modes legs as the presets
   bench-topo-complete-sync, -one_peer_exp-sync and -one_peer_exp-async
   (32 workers, the MLP in bf16 compute, 16,384/2,048 samples): per-round
   4 rounds against blocks of 2 bit for bit, then blocked as bench.py
   times them (eval only in round 0, a warm-up block, three timed blocks
   of 8 replayed rounds), a profiled block's idle share and the peak
   memory, and async round 0 bit for bit sync round 0; 12b the one-peer
   leg with both fused switches: kernel 2's ring kernel at n = 32 and
   kernel 1 at 32 MLP lanes timed as 3b, the ring kernel's ptxas line
   (no stack frame, no spills), the launch counts of 2 rounds, blocks of
   2 against per-round, and the blocked rate; 12c both f32 headlines, 2
   rounds with diagnostics on and a MemorySink: state and launches equal
   to phase 5's runs (diagnostics off), the blocked stream canonically
   equal to the per-round one, the gossip headline killed after round 0
   and resumed into one JSONL stream that ``obs.check`` accepts, every
   ``resource`` event's peak the card's ``max_memory_allocated``, and the
   six reductions timed alone on the gossip headline's state.

13. dopt's GroupNorm ResNet-18 and baseline5 at full width (32 workers,
   11,173,962 params a worker in 62 tensors, CIFAR-10-sized synthetic
   sets, ``phase13``): 13a both fused switches, rounds 1-2 per-round
   (no f32 eval: it took 42 s a call; each round's wall, the peak,
   kernel 1 at 4 launches a step, kernel 2 at 11 a round); 13b both
   kernels at 13a's shapes against their plain versions, their bounds and their
   library calls; 13c 13a in blocks of 2, bit for bit, with the graphs'
   memory; 13d bf16 compute, round 1 (no eval); 13e baseline5 as typed,
   one round with no eval and no kernel; 13g a killed-and-resumed run at
   stage sizes (1, 1, 1, 1), 8 workers and 3,000/500 samples, blocks of 2 with prefetch
   and checkpoint_every=2, bit for bit the continuous run.  Phase 4 also runs
   a baseline5-shaped gossip and a fedavg ResNet-18 (stage sizes (1, 1),
   8×8×3) on the GPU against the CPU.

14. choco and the narrowed wire (``phase14``), f32 under the
   deterministic mode unless said: 14a headline-dsgd-model1 with choco
   (γ = 0.1; top-k 0.1, rand-k 0.1, QSGD 16 levels), kernel 1 on and the
   fused epilogue off, rand-k 2 rounds, top-k and QSGD one, with eval
   in round 0 (round walls,
   the exchange's time, rates beside phase 5's dsgd, the peak, kernel 1
   every step and kernel 2 never); 14b dopt's keyed draws on the card
   against the CPU — uniform at [6, 1,663,370] and the top-k and rand-k
   results bit for bit, QSGD within one level on at most 1e-4 of the
   elements — and a tiny choco run on the GPU against the CPU; 14c
   14a's rand-k run in blocks of 2 and killed and resumed, bit for bit
   with x_hat; 14d ``comm_dtype="bfloat16"`` on both headlines (fused
   epilogue off), one round, beside the f32 wire's (two rounds of the
   gossip headline, one of the federated); 14e baseline5 with choco rand-k
   0.01 in bf16 compute, one round (the exchange's share, the peak);
   14f the compressors' pieces (draw, select, scatter) and whole calls
   timed at 14a's and 14e's shapes beside their bytes bounds.

15. scatter, shift and the bucket codec (``phase15``), f32 under the
   deterministic mode unless said, kernel 1 on and the fused epilogue
   off (dopt refuses it with scatter): 15a headline-dsgd-model1 with
   ``update_sharding="scatter"`` (2 buckets), 2 rounds per-round and a
   blocked run of 2 bit for bit, its History within the multi-round
   bound of 14d's dense f32 run (one mix of the same inputs within 1e-6
   of the dense mix; 15c and 15d likewise); 15b the q8 codec with no
   budget (2 rounds) and the 6-worker lossy-link budget (q4 everywhere,
   one round), the exchange's time and share and the plan's bytes; 15c
   the explicit shift path with scatter, one round against 15a's round
   0; 15d headline-fedavg-model1 at full width with the scatter reduce,
   one round each, f32 (against 14d's one-round f32 run) and
   ``comm.wire_dtype="bfloat16"``; 15e
   baseline5
   with scatter and q8 in bf16 compute, one round (11 buckets, the
   exchange's share, the peak); 15f the collectives on a world-size-1
   NCCL group (``init_file_group``) equal to their group-None forms bit
   for bit, the card's encodes equal to the CPU's, and the draw,
   ``qint_encode`` and ``qint_decode`` timed against their bytes bound;
   15g the q8 run blocked and killed-and-resumed, bit for bit with the
   residuals.  Kernel 2 launches on no phase-15 path.

16. the client population (``phase16``), f32 under the deterministic
   mode, kernel 1 on and the fused epilogue off (dopt refuses it in
   population mode): 16a ``baseline3-xclients`` at full width (1,000
   clients, cohorts of 64, 16 lanes, 4 waves of 375 Model1 steps), 2
   per-round rounds (walls, rate, peak, kernel 1 at 3,000 launches and
   kernel 2 at none, the ``cohort`` rows); 16b the same with prefetch on
   in a fresh trainer that restores 16a's round-0 checkpoint and runs
   round 1: theta, the History, the ledger and the registry bit for bit
   16a's, and round 2's inputs staged on the stager's thread equal to
   the inline build; 16c a
   host-only ``ClientRegistry`` draws 16a's cohorts (rows and state);
   16d a faulted cohort of 16 (crash, over-selection, nan liars with the
   client quarantine, churn), 2 rounds, its ledger and registry equal to
   the host's recomputation and no benched client sampled in round 1;
   16e the gossip binding on ``headline-dsgd-model1`` (600 clients,
   cohorts of 6), per-round against one block of 2, bit for bit; 16f
   the host side at 10,000 clients and cohorts of 256 (16 waves):
   sample and bind, and the 16 wave plans, in ms.

17. the multi-GPU engines (``phase17``): the worker axis over 2 ranks,
   spawned once (``phase17_rank``), f32 under the deterministic mode,
   kernel 1 on and the fused epilogue off (dopt refuses it on a
   multi-device mesh).  On one card the ranks share it over host-staged
   gloo: 17a ``headline-dsgd-model1`` (3 lanes a rank; dopt's 'auto'
   rule takes the shift path), 2 rounds, and 17b
   ``headline-fedavg-model1`` (8 lanes a rank, full width), one round
   (cut from 2 for the budget), with eval each round: walls,
   rates, per-rank peaks, kernel 1 every step on each rank and kernel 2
   never, the History equal on both ranks, the bytes each rank handed to
   the consensus wire (the meter) equal to the plan's, round 0 within
   the multi-round bound of 14d's one-rank f32 runs (17a's round 1 and
   the params printed); 17m one mix (dense and shift) and one f32 masked
   average at 2 ranks within 1e-6 of one rank; 17c 17a killed after
   round 0 and resumed at 2 ranks, bit for bit with 17a, and rank 0's
   checkpoint resumed at one rank for round 1 within the bound; 17d
   with two cards or more, 17a and 17b over NCCL (one rank a card) bit
   for bit the gloo runs, else one line saying so.  The kernel-1 sites
   at rank width (3 and 8 Model1 lanes) are timed as phase 3 times them.
   17s: dopt's ``seqlm`` preset (ring, and Ulysses) over the 2 ranks of
   the same spawn: one step within 1e-5 relative L2 of one rank's, the
   ring twice bit for bit, the History equal on both ranks, no kernel,
   the bytes a rank hands to torch.distributed a step, the 60-step
   losses; with two cards also over NCCL, bit for bit the gloo runs.

18. dopt's sequence-parallel LM on one rank (``phase18``): the ``seqlm``
   preset (TransformerLM, 469,504 params, 60 steps of 8 × 512 tokens,
   ring attention as a one-block ring) — 18a timed (tokens/s, the peak,
   the losses, dopt's learning signal: the first loss above 3.0, the
   last below it less 1.0); 18b one step on the card within 1e-5 of the
   port's CPU step (the loss, every parameter's relative L2); 18c dense
   and Ulysses one step within 1e-5 relative L2 of the ring's, and their
   60-step losses; 18d two runs bit for bit, and a run killed at step 30
   and resumed bit for bit; 18e seq_len 4096 with ``kv_chunk=512``
   against without, the chunked peak at least one [8, 4096, 4, 4096] f32
   score block lower; 18f neither kernel launches on the path (the plain
   ``sgd_step``).

19. the resident serve daemon (``phase19``, ``dopt_torch.serve``): 19a
   an in-process ``ServeDaemon`` on ``headline-dsgd-model1`` as typed
   (6 workers, Model1, both fused switches, full width), 4 rounds with
   checkpoint_every 2 and the commands leave worker 3 at round 1,
   ``optim.lr`` at 2 (the rebuild: checkpoint, new trainer, restore)
   and join at 3: the control and churn rows, a clean ``check_stream``,
   ``final.json`` healthy, kernel 1 at 316 and kernel 2 at 2 launches a
   round; the served round walls against phase 5's scripted round, the
   save and restore seconds, the peak over held; 19b 19a's state dir as
   it stood after boundary 3 (what a stop there leaves) resumed in a
   fresh daemon: History, fault ledger and canonical stream bit for bit
   19a's; 19c ``headline-fedavg-model1`` served in-process (a leave at
   1, 2 rounds, the launches), then ``python -m dopt_torch.serve
   --preset headline-fedavg-model1 --synthetic-scale 0.1`` (full width,
   6,000/1,000 rows) as a subprocess with the admin on port 0 (GET
   /healthz and /metrics, POST a leave, a real SIGTERM once it applied,
   the re-exec in place, resume, drain at round 3); 19d a 2-process fleet
   sharing the card over gloo (``baseline1 --synthetic-scale 0.05``,
   drains at round 3, the two processes' deterministic streams equal);
   19e CUDA graphs under ``run_served``: ``baseline1`` served in blocks
   of 2 with a leave and a join, each kind captured once and replayed,
   bit for bit the per-round served run.  19c's CLI leg, 19d and 19e
   run at once, after every phase-19 number is taken, beside phase 20d's
   wire probe and phase 23's window part (23a-23d, ``phase23_window``);
   phase 20c's watch runs over 19a's and 19d's state dirs.

20. the meters and the stream tools (``phase20``): 20a the headlines'
   MFU — ``train_flops_per_sample`` of Model1 (dopt's convention, counted
   on the CPU) times phase 5's and 5b's samples a round (lanes × steps ×
   batch) over their round walls, and over phase 6's busy time, against
   ``device_peak_flops()`` (the card's bf16 dense peak; fails on None),
   beside the card's name and power limit; 20b ``first_divergence``
   between phase 5's per-round and 7b's blocked headline streams (None),
   and one gauge changed is reported at its index, kind and round; 20c
   ``python -m dopt_torch.obs.watch --once`` over 19a's served stream and
   19d's fleet dir (exit 0, the gauges and the fleet columns rendered),
   and ``obs.regress`` on a copy of results/bench_history.jsonl: the
   card's entries keyed apart from the TPU rows (no baseline until
   three), then a seeded 20% slowdown flagged; 20d ``python -m
   dopt_torch.analysis.comm_bytes --ranks 2 --device cuda`` (gloo, the
   ranks sharing the card) equal in every field to the CPU's 2-rank
   figures (``WIRE_2_RANKS``): q4 at 112,068 bytes a lane,
   wire_compression 7.109.

21. ``backend="torch"`` and ``stacked_impl="vmap"`` (``phase21``), in
   the deterministic mode: 21a ``baseline1`` as typed (MLP, 4 workers,
   dopt's full synthetic sizes) one round on the sequential oracle
   (``build_trainer`` with ``backend="torch"``: no hand kernel) and one
   round of ``GossipTrainer`` with both fused switches (kernel 1 every
   step, kernel 2 once a round), from one init, held to dopt's bars for
   its engine against the oracle (test accuracy 1e-4, train loss 1e-3,
   params 1e-4 max-relative), both rates and the launches printed; 21b
   ``headline-dsgd-model1`` one round on the oracle: finite, its seconds
   a round beside phase 5's and its distance from phase 5's round 0
   held to 1e-3 train loss and 1e-4 test accuracy; 21c
   one full-width step of the gossip headline's model (6 lanes, batch
   128, f32), ``"vmap"`` against ``"auto"``, every tensor within 1e-5
   relative L2.  The kernels line gains 21a's launches.

22. dopt's library surface (``phase22``), f32 under the deterministic mode and
   ``full_f32``: 22b (first) ResNet-18's step at ``baseline5``'s full
   size — 32 lanes, batch 128 a lane, 32×32×3 — on the card against the
   port's CPU step of lane 0 alone (taken in phase 23), as 4c holds
   Model1's: lane 0's 62
   gradients and 62 updated parameters within 1e-5 relative L2 (max-rel
   printed), the card's step twice bit for bit, its conv kernels named
   from the profiler, and on a miss each side's distance from lane 0's
   f64 gradients; 22a each zoo model at its preset's width and input
   (Model1 28×28×1, Model3 32×32×3, the MLP, the logistic model on 123
   features, ResNet-18 32×32×3), batch 128: ``build_model`` on the card,
   3 steps of ``cross_entropy``, autograd and
   ``fused_sgd_momentum_tree`` (kernel 1, a launch per 16 tensors a
   step), bit for bit the same steps through its plain version, the
   first step within 1e-5 relative L2 of ``build_model``'s CPU step
   (ResNet-18's: 22b's CPU lane) and ``accuracy`` after it equal; 22c
   kernel 1 through the tree wrapper at each model's one-worker site,
   bit for bit its plain version, timed on the device alone
   (``event_ms(..., device_only=True)``: the wrapper's Python runs while
   a sleep kernel holds the card).  The kernels line gains 22a's
   launches.

23. dopt's acceptance harnesses (``phase23``, ``dopt_torch.scripts``)
   at dopt's settings (both fused switches off): 23a
   ``chaos_soak.main(["--rounds", "8", "--seed", "0", ...])``
   in-process, the four cocktail legs (push-sum gossip under link
   faults, async one-peer gossip, scatter with the qsgd bucket codec,
   federated with the staleness buffer; each run continuous, again,
   blocked and killed-and-resumed, bit for bit) and both monitor gates,
   then ``python -m dopt_torch.obs.check`` on its stream: each leg's
   wall, ledger rows and alerts, and both kernels at 0 launches; 23b
   ``chaos_soak.main(["--rounds", "8", "--engine", "gossip", "--kill",
   "--skip-gates"])`` (a real SIGKILLed child, resumed bit for bit);
   23c each leg's 8-round continuous run on the card against the port's
   CPU run of the same leg (the ledger row for row, History within
   LOSS_TOL / ACC_TOL, the worst distance printed); 23d ``python -m
   dopt_torch.scripts.serve_soak --rounds 24`` (real daemons on the
   card, a SIGTERM re-exec, bit for bit the uninterrupted leg; dopt's
   README runs 48 rounds, cut to 24 for the budget with the same
   schedule).  All but 23d's collection run in phase 19's shared window
   (``phase23_window``: 23d started as a subprocess, then 23a, 23c and
   23b on the main thread, beside 19c's CLI leg, 19d's fleet and 20d's
   probe, where nothing is timed; their walls are printed as taken
   there); ``phase23``, after phase 20 and before 21, takes phase 22b's
   CPU step while 23d finishes, then collects 23d, so no phase's timed
   number shares the card with it.  The serve soak's federated, fleet,
   decoupled and long modes run on the CPU only
   (``tests/test_torch_soak.py``).

Phase 4c holds one full-size Model1 step (headline-dsgd-model1's model:
28×28×1, batch 128 a lane, f32, deterministic, ``full_f32``) at 6 and at
3 lanes on the card against the port's CPU step at 6 lanes (lanes 0-2
for 3): every gradient and updated tensor within 1e-5 relative L2
(max-rel printed), with the conv kernels each lane count ran, by the
profiler's names.

Every profile records the device activity only (phase 6's
``profile_round`` over ``device_stats_of``), and every synthetic set is made once and shared by
the trainers that ask for it (from phase 4 on).  Every phase prints the
script's elapsed time as it starts.

The line before the last is a JSON object {"kernels": [...]} with one
entry per kernel and path; the last is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# NVIDIA H100 SXM data sheet: HBM3 rate and the f32 peak outside the
# tensor cores (both kernels are f32 FMA/elementwise work).
MEM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
REPS = 25
T0 = 0.0   # the script's start (main), for the per-phase elapsed lines
# ``python -m dopt_torch.analysis.comm_bytes --ranks 2 --device cpu``
# (tests/test_torch_obs_tools.py holds the CLI to these).  At 2 ranks the
# MLP's 199,210 f32 a lane need no pad (796,840 dense bytes, a 69,113-byte
# budget), where 4 pad to 199,212 (796,848 and 69,114, dopt's figures);
# the round's metrics ride the all-gather, 256 bytes.
WIRE_2_RANKS = {
    "budget_bytes": 69_113, "plan_kinds": ["q4"], "plan_chunk": 64,
    "plan_dense_bytes": 796_840, "plan_wire_bytes": 112_068,
    "wire_compression": 7.109,
    "dense": {"all-gather": 6_374_976, "all-reduce": 0, "reduce-scatter": 0,
              "collective-permute": 0, "all-to-all": 0, "total": 6_374_976,
              "by_dtype": {"f32": 6_374_976},
              "by_op_dtype": {"all-gather": {"f32": 6_374_976}},
              "by_kind": {"all_gather/dense": 6_374_720,
                          "all_gather/metrics": 256}},
    "scatter": {"all-gather": 256, "all-reduce": 0,
                "reduce-scatter": 3_187_360, "collective-permute": 0,
                "all-to-all": 0, "total": 3_187_616,
                "by_dtype": {"f32": 3_187_616},
                "by_op_dtype": {"all-gather": {"f32": 256},
                                "reduce-scatter": {"f32": 3_187_360}},
                "by_kind": {"all_gather/metrics": 256,
                            "reduce_scatter/raw": 3_187_360}},
    "codec": {"all-gather": 896_800, "all-reduce": 0, "reduce-scatter": 0,
              "collective-permute": 0, "all-to-all": 0, "total": 896_800,
              "by_dtype": {"f32": 99_872, "u8": 796_928},
              "by_op_dtype": {"all-gather": {"f32": 99_872, "u8": 796_928}},
              "by_kind": {"all_gather/metrics": 256,
                          "all_gather/q4": 796_928,
                          "all_gather/q4-scale": 99_616}},
}

# The port's own agreement limits (tests/test_torch_*.py, PARITY.md:90).
LOSS_TOL, ACC_TOL, PARAM_REL_TOL = 1e-3, 1e-4, 1e-4


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    raise SystemExit(1)


def nvidia_smi() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them,
    printed; fails first where torch sees no card."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}")
    return smi


# A sleep kernel of this many clock cycles (about 10 ms at the H100's
# 1.98 GHz) holds the card while a timed call's Python runs.
HOLD_CYCLES = 20_000_000


def event_ms(fn, flush, device_only: bool = False) -> float:
    """CUDA-event time of one call of ``fn``, the L2 flushed (``flush``
    zeroed) before each: the median of ``REPS`` calls after dropping the
    fastest and the slowest, after 3 warm-up calls.  With
    ``device_only`` a sleep kernel (``HOLD_CYCLES``) is queued before the
    first event, so the call's host work (a wrapper's checks, its
    launches) runs while the card sleeps and the events enclose the
    device's work alone."""
    import torch

    from dopt_torch.utils.metrics import trimmed_stats

    for _ in range(3):
        fn()
    evs = []
    for _ in range(REPS):
        flush.zero_()
        if device_only:
            torch.cuda._sleep(HOLD_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        evs.append((a, b))
    torch.cuda.synchronize()
    return trimmed_stats([a.elapsed_time(b) for a, b in evs])[0]


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, to = nbytes / MEM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return 1e3 * max(tb, to), ("bytes" if tb >= to else "operations")


def max_rel(want: dict, got: dict) -> float:
    import numpy as np

    return max(float(np.abs(got[k] - v).max() / max(np.abs(v).max(), 1e-12))
               for k, v in want.items())


def state(tr) -> dict:
    """Everything a trainer's run leaves behind, as host values: History
    and client rows, each worker's params, momentum, the fused carry
    (gossip q and fbuf, the federated theta slab), theta, duals,
    controls, and the client-sampling and matching streams' states."""
    def host(tree):
        items = enumerate(tree) if isinstance(tree, list) else tree.items()
        return {str(k): v.detach().float().cpu().numpy().copy()
                for k, v in items}

    out = {"rows": [dict(r) for r in tr.history.rows],
           "client rows": [dict(r) for r in tr.client_history.rows],
           "params": {k: v.copy() for k, v in tr.worker_params().items()},
           "momentum": host(tr.momentum)}
    for name in ("_q", "_fbuf", "_theta_flat"):
        if hasattr(tr, name):
            out[name] = {"": getattr(tr, name).float().cpu().numpy().copy()}
    for name in ("theta", "duals", "c_global", "_async_prev"):
        if getattr(tr, name, None) is not None:
            out[name] = host(getattr(tr, name))
    if hasattr(tr, "_sample_rng"):
        out["sampling stream"] = [tr._sample_rng.bit_generator.state]
    if hasattr(tr, "_matching_rng"):
        out["matching stream"] = [tr._matching_rng.bit_generator.state]
    return out


def same_state(label: str, want: dict, got: dict) -> None:
    """Fail unless two runs left the same state, bit for bit."""
    import numpy as np

    for key, w in want.items():
        g = got[key]
        if isinstance(w, list):
            if w != g:
                fail(f"{label}: {key} differ: {w} vs {g}")
            continue
        for k, a in w.items():
            if not np.array_equal(a, g[k], equal_nan=True):
                fail(f"{label}: {key} {k} differs by up to "
                     f"{np.abs(a - g[k]).max():.3e}")
    print(f"{label}: bit-identical ({', '.join(want)})")


def timed_saves(tr, seconds: list) -> None:
    """Time every ``tr.save`` (the checkpoints ``run`` writes too) from a
    synchronized device to the promoted directory."""
    import torch

    save = tr.save

    def timed(path):
        torch.cuda.synchronize()
        t = time.perf_counter()
        save(path)
        seconds.append(time.perf_counter() - t)
    tr.save = timed


def resume_check(label: str, cls, cfg, want_state: dict, want_launch: dict,
                 ckdir: Path, dev) -> dict:
    """Phase 8a-8c: trainer B runs round 0 with checkpoint_every=1 and
    stops (the kill); a fresh trainer C restores the checkpoint and runs
    round 1.  C must leave ``want_state`` (the continuous 2-round run's)
    bit for bit, and B + C must launch the kernels as often as the
    continuous run did.  On the federated engine C's round-1 client
    sample must be the second draw of a fresh sampling stream."""
    import numpy as np
    import torch

    from dopt_torch.ops.fused_update import (fused_mix_sgd,
                                             fused_sgd_momentum,
                                             launch_counts)
    from dopt_torch.utils import host_rng

    path = ckdir / label.split()[0]
    saves: list[float] = []
    fused_sgd_momentum.launches = 0
    fused_mix_sgd.launches = 0
    b = cls(cfg, device=dev)
    timed_saves(b, saves)
    b.run(rounds=1, checkpoint_every=1, checkpoint_path=path)
    torch.cuda.synchronize()
    del b
    c = cls(cfg, device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    c.restore(path)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    drawn = []
    if hasattr(c, "_round_participation"):
        draw = c._round_participation

        def record(t, chosen=None):
            out = draw(t, chosen)
            drawn.append(out[0])
            return out
        c._round_participation = record
    c.run(rounds=1)
    torch.cuda.synchronize()
    launches = launch_counts()
    same_state(f"8 {label}, killed after round 0 and resumed, against the "
               "continuous run", want_state, state(c))
    if drawn:
        rng = host_rng(cfg.seed, 314159)
        m = c._sampled_count()
        want = [np.sort(rng.choice(c.num_workers, m, replace=False))
                for _ in range(2)][1]
        print(f"8 {label}: round-1 client sample {drawn[0].tolist()} (a "
              f"fresh stream's second draw {want.tolist()})")
        if drawn[0].tolist() != want.tolist():
            fail(f"{label}: the resumed run drew another client sample")
    files = {f.name: f.stat().st_size for f in sorted(path.iterdir())}
    nbytes = sum(files.values())
    print(f"8 {label}: checkpoint {nbytes} B on disk {files}; save "
          f"{saves[0]:.4f} s, restore {restore_s:.4f} s; launches "
          f"{launches} (continuous {want_launch})")
    if len(saves) != 1:
        fail(f"{label}: {len(saves)} checkpoints written, expected 1")
    if launches != want_launch:
        fail(f"{label}: launch counts {launches} != continuous "
             f"{want_launch}")
    del c
    return {"bytes": nbytes, "save_s": saves[0], "restore_s": restore_s,
            "launches": launches}


def resume_tiny(label: str, cls, cfg, ckdir: Path, dev) -> dict:
    """Phase 8d: 5 rounds in blocks of 2 with checkpoint_every=2 (saves
    at rounds 2 and 4, each kept); resumed from either, and the round-2
    checkpoint restored into a trainer that already ran (and captured
    its graphs), each equal to the continuous run bit for bit.  Returns
    the kept checkpoints."""
    import shutil

    import torch

    cont = cls(cfg, device=dev)
    cont.run(rounds=5, block=2)
    want = state(cont)
    del cont
    slug = label.split()[0]
    kept: dict[int, Path] = {}
    v = cls(cfg, device=dev)
    save = v.save

    def keep(path):
        save(path)
        kept[v.round] = Path(shutil.copytree(path, ckdir / f"{slug}-r{v.round}"))
    v.save = keep
    v.run(rounds=5, block=2, checkpoint_every=2,
          checkpoint_path=ckdir / slug)
    torch.cuda.synchronize()
    if sorted(kept) != [2, 4]:
        fail(f"8d {label}: checkpoints at rounds {sorted(kept)}, expected "
             "[2, 4]")
    same_state(f"8d {label}, with checkpoints, against without", want,
               state(v))
    del v
    for r in (2, 4):
        c = cls(cfg, device=dev)
        c.restore(kept[r])
        c.run(rounds=5 - r, block=2)
        same_state(f"8d {label}, resumed from round {r}", want, state(c))
        del c
    u = cls(cfg, device=dev)
    u.run(rounds=4, block=2)
    if not u.graphs.captures:
        fail(f"8d {label}: the blocked run captured no graph")
    u.restore(kept[2])
    u.run(rounds=3, block=2)
    same_state(f"8d {label}, round-2 checkpoint restored into a trainer "
               "with captured graphs", want, state(u))
    return kept


def fed_state(tr) -> dict:
    """``state`` plus the federated fault model's carried state: the
    ledger, the quarantine and staleness mirrors and the staleness
    buffer (History rows as JSON text, so NaN compares equal to NaN)."""
    out = state(tr)
    out["rows"] = [json.dumps(r) for r in out["rows"]]
    out["ledger"] = [dict(r) for r in tr.history.faults]
    out["mirrors"] = [tr._screen_streak.tolist(),
                      tr._quarantine_until.tolist(),
                      tr._stale_admit_round.tolist(),
                      tr._stale_weight.tolist(), tr._stale_origin.tolist()]
    if tr._stale_p is not None:
        out["stale_p"] = {k: v.float().cpu().numpy().copy()
                          for k, v in tr._stale_p.items()}
    return out


def fed_host_ledger(cfg, n_rounds: int) -> tuple[list, list]:
    """The ledger the federated host stage writes for ``cfg`` with no
    device run: participation round by round, the screen's flags taken
    as the poisoning liars (nan/inf lies are screened, finite lies and
    honest updates pass), fed back as the engine feeds them.  Returns
    the rows and each round's surviving sample."""
    import numpy as np

    from dopt_torch.engine import FederatedTrainer

    tr = FederatedTrainer(cfg, device="cpu", eval_train=False)
    poison = (cfg.faults is not None
              and cfg.faults.corrupt_mode in ("nan", "inf"))
    rows, sels = [], []
    for t in range(n_rounds):
        sel, _, cmask, part_rows, _, _ = tr._round_participation(t)
        flags = cmask[sel] if poison else np.zeros(len(sel), np.float32)
        tr._apply_screen_feedback(t, sel, flags, part_rows)
        rows += part_rows
        sels.append(sel)
    del tr
    return rows, sels


def phase11(dev, smi: str, get_preset, kit) -> dict:
    """Phase 11, the federated fault model at full width (MNIST-sized
    synthetic sets, the deterministic mode).  ``kit`` holds phase 3's
    and 10e's timers (``time_ms``, ``k2_site``, ``gated_site``) and
    phase 6's ``profile_round``.  Returns the launch counts of the main
    path run (11a), its kernel rows (11f) and the rates."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from dopt_torch import robust
    from dopt_torch.config import FaultConfig, RobustConfig
    from dopt_torch.engine import FederatedTrainer
    from dopt_torch.models.zoo import param_shapes
    from dopt_torch.ops.fused_update import (fused_mix_sgd,
                                             fused_sgd_momentum,
                                             launch_counts)
    from dopt_torch.parallel.collectives import (masked_average,
                                                 mean_weight_matrix)

    t11 = time.perf_counter()
    rates = {}

    def fed_run(label, cfg, n_rounds, block, want=None, want_launch=None,
                finite=True, prof=False, tr=None):
        """A fresh trainer (or ``tr``) on the card: n rounds in blocks of
        ``block``, the kernel counts set to 0 just before and read just
        after; finite losses and accuracies in range; against
        ``want``/``want_launch`` bit for bit when given."""
        base = torch.cuda.memory_allocated()
        tr = FederatedTrainer(cfg, device=dev) if tr is None else tr
        fused_sgd_momentum.launches = 0
        fused_mix_sgd.launches = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        tr.run(rounds=n_rounds, block=block)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        got = launch_counts()
        peak = torch.cuda.max_memory_allocated() - base
        st = fed_state(tr)
        for row in tr.history.rows[-n_rounds:]:
            if finite and not all(math.isfinite(row[k]) for k in (
                    "train_loss", "test_loss", "local_loss")):
                fail(f"11 {label}: non-finite loss in {row}")
            if not all(0.0 <= row[k] <= 1.0 for k in ("train_acc",
                                                      "test_acc")):
                fail(f"11 {label}: accuracy out of range in {row}")
        print(f"11 {label}: {n_rounds} rounds, block {block}: "
              f"{n_rounds / wall:.4f} rounds/s, peak {peak} B over what was "
              f"allocated before, launches {got}, {len(st['ledger'])} "
              f"ledger rows; {smi}")
        if want is not None:
            same_state(f"11 {label}, against per-round", want, st)
            if want_launch is not None and got != want_launch:
                fail(f"11 {label}: launches {got} != {want_launch}")
        if block > 1:
            # The engine checked its device counters against the host
            # replay after every round; they must equal the mirrors now.
            for d, h in zip(tr._counters(), tr._host_counters()):
                if not np.array_equal(d.cpu().numpy(), h):
                    fail(f"11 {label}: device counters differ from the "
                         "host mirrors")
        idle = (kit.profile_round(f"11 {label}", functools.partial(
            tr.run, rounds=1, block=block), model=tr.cfg.model.model)
                if prof else None)
        rates[label] = (n_rounds / wall, peak, idle)
        return tr, st, got

    def check_ledger(label, got, cfg, n_rounds):
        want, sels = fed_host_ledger(cfg, n_rounds)
        if got != want:
            fail(f"11 {label}: the card's ledger differs from the host "
                 f"stage's: {got} vs {want}")
        kinds = sorted({r["kind"] for r in got})
        print(f"11 {label}: ledger of {len(got)} rows ({kinds}) equal to "
              "the host stage's with no device run")
        return sels

    rounds = 2
    # -- 11a. the faulty federated headline: both kernels, killed and
    # resumed, blocked.
    fhead = get_preset("headline-fedavg-model1-faulty")
    tr, fh_state, fh_launch = fed_run(
        "11a headline-fedavg-model1-faulty (both fused switches)", fhead,
        rounds, 1, prof=False)
    want = {"fused_sgd_momentum": rounds * tr.steps_per_round,
            "fused_mix_sgd": rounds * tr.fused_spec.num_buckets}
    print(f"11a launches {fh_launch} (expected {want}: kernel 1 gated, one "
          "launch a step; kernel 2 once a bucket a round)")
    if fh_launch != want:
        fail(f"11a: launches {fh_launch} != {want}")
    # The sites 11f times: round 0's survivors' mask and stragglers.
    sel0 = check_ledger("11a", fh_state["ledger"], fhead, rounds)[0]
    if not any(r["kind"] == "straggler" for r in fh_state["ledger"]):
        fail("11a: no straggler in the faulty headline's two rounds")
    rf0 = tr.faults.for_round(0)
    del tr
    torch.cuda.empty_cache()
    ckdir = Path(tempfile.mkdtemp(prefix="dopt-torch-ckpt-"))
    try:
        fused_sgd_momentum.launches = 0
        fused_mix_sgd.launches = 0
        victim = FederatedTrainer(fhead, device=dev)
        victim.run(rounds=1, checkpoint_every=1, checkpoint_path=ckdir / "f")
        del victim
        resumed = FederatedTrainer(fhead, device=dev)
        resumed.restore(ckdir / "f")
        resumed.run(rounds=rounds - 1)
        torch.cuda.synchronize()
        same_state("11a headline-fedavg-model1-faulty, killed after round 0 "
                   "and resumed, against the continuous run", fh_state,
                   fed_state(resumed))
        if launch_counts() != fh_launch:
            fail(f"11a resume: launches {launch_counts()} != {fh_launch}")
        del resumed
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    tr, _, _ = fed_run("11a headline-fedavg-model1-faulty blocked", fhead,
                       rounds, 2, fh_state, fh_launch)
    print(f"11a graphs {tr.graphs.captures}")
    del tr
    torch.cuda.empty_cache()

    # -- 11b. baseline3-faulty as typed: compact, fixed-width lanes.
    b3f = get_preset("baseline3-faulty")
    tr, b3f_state, got = fed_run("11b baseline3-faulty per-round", b3f,
                                 rounds, 1)
    if not tr._use_compact() or any(got.values()):
        fail(f"11b: baseline3-faulty must run compact with no kernel: "
             f"{got}")
    del tr
    check_ledger("11b", b3f_state["ledger"], b3f, rounds)
    tr, _, _ = fed_run("11b baseline3-faulty, one block", b3f, rounds,
                       rounds, b3f_state, got)
    del tr
    torch.cuda.empty_cache()

    # -- 11c. baseline3-byzantine: signflip liars against each defense.
    # 11c and 11d at a quarter of MNIST's rows (their liars, faults and
    # admissions are host draws, independent of the data's size).
    def quarter(cfg):
        return cfg.replace(data=dataclasses.replace(
            cfg.data, synthetic_train_size=15_000,
            synthetic_test_size=2_500))

    # The trimmed-mean run one round (cut from 2 for the budget: round
    # 0 samples liars 0 and 2).
    byz = quarter(get_preset("baseline3-byzantine"))
    tr, byz_state, _ = fed_run("11c baseline3-byzantine (trimmed mean)", byz,
                               1, 1)
    check_ledger("11c", byz_state["ledger"], byz, 1)
    liars = sorted({r["worker"] for r in byz_state["ledger"]
                    if r["action"] == "injected_signflip"})
    print(f"11c liars sampled: {liars}")
    if not liars or not set(liars) <= {0, 1, 2}:
        fail(f"11c: the pinned liars are workers 0-2, got {liars}")
    del tr
    per_round = {}
    for name, rc in (
            ("mean", dataclasses.replace(byz.robust, aggregator="mean")),
            ("median", dataclasses.replace(byz.robust, aggregator="median")),
            ("krum", dataclasses.replace(byz.robust, aggregator="krum")),
            ("multi_krum", dataclasses.replace(byz.robust,
                                               aggregator="multi_krum")),
            ("mean, clip_radius 1.0", dataclasses.replace(
                byz.robust, aggregator="mean", clip_radius=1.0))):
        # One local epoch (the preset's 5 in the trimmed-mean run above):
        # these runs drive each aggregator through the engine.
        _, _, _ = fed_run(f"11c baseline3-byzantine, {name}, 1 local epoch",
                          byz.replace(robust=rc, federated=dataclasses.replace(
                              byz.federated, local_ep=1)), 1, 1,
                          finite=name != "mean")
        per_round[name] = rates[
            f"11c baseline3-byzantine, {name}, 1 local epoch"][0]
    per_round["trimmed_mean"] = rates[
        "11c baseline3-byzantine (trimmed mean)"][0]
    # The aggregation calls alone on the round's 8 Model1 lanes.
    shapes = param_shapes("model1")
    gen = torch.Generator(device=dev).manual_seed(11)
    lanes = {k: torch.randn(8, *s, device=dev, generator=gen)
             for k, s in shapes.items()}
    center = {k: v[0].clone() for k, v in lanes.items()}
    mask = torch.ones(8, device=dev)
    mask[3] = 0.0
    calls = {"mean": lambda: masked_average(lanes, mask),
             "clip_to_ball 1.0": lambda: robust.clip_to_ball(lanes, center,
                                                             1.0)}
    for name in ("trimmed_mean", "median", "krum", "multi_krum"):
        calls[name] = functools.partial(robust.make_aggregator(
            name, trim_frac=0.25, krum_f=byz.robust.krum_f,
            multi_krum_m=byz.robust.multi_krum_m), lanes, mask)
    agg_ms = {}
    for name, fn in calls.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        agg_ms[name] = (kit.time_ms(fn), peak)
    for name, r in per_round.items():
        print(f"11c aggregator {name}: {r:.4f} rounds/s (1 round, compact, "
              f"8 lanes; local_ep {5 if name == 'trimmed_mean' else 1}); "
              f"{smi}")
    for name, (ms, peak) in agg_ms.items():
        print(f"11c aggregation call {name} over 8 Model1 lanes "
              f"(1,663,370 f32 each), 7 alive: {ms:.4f} ms, peak {peak} B "
              f"over what was allocated; {smi}")
    del lanes, center
    torch.cuda.empty_cache()

    # -- 11d. baseline3-elastic: drop stragglers and delayed uplinks
    # through the staleness buffer, per-round and through the chaos block.
    # 3 rounds (cut from 4 for the budget: rounds 1 and 2 admit late
    # updates after 1 and 2 rounds), the blocked run in a block of 2 and
    # a block of 1.
    el = quarter(get_preset("baseline3-elastic"))
    tr, el_state, got = fed_run("11d baseline3-elastic per-round", el, 3, 1)
    if tr._use_compact() or not tr._has_stale:
        fail("11d: baseline3-elastic must run full width with the buffer")
    kinds = {r["kind"] for r in el_state["ledger"]}
    actions = [r["action"] for r in el_state["ledger"]]
    print(f"11d ledger kinds {sorted(kinds)}; admissions "
          f"{[a for a in actions if a.startswith('admitted')]}")
    if not any(a.startswith("admitted_after") for a in actions):
        fail("11d: no late update was admitted in 3 rounds")
    del tr
    check_ledger("11d", el_state["ledger"], el, 3)
    tr, _, _ = fed_run("11d baseline3-elastic, blocks of 2 (chaos round)",
                       el, 3, 2, el_state, got)
    print(f"11d baseline3-elastic: graphs {tr.graphs.captures}; {smi}")
    del tr
    torch.cuda.empty_cache()

    # -- 11e. the federated quarantine: nan liars benched after two
    # screened participations for three rounds, per-round and in blocks
    # of 3 through the chaos round.
    b3 = get_preset("baseline3")
    quar = b3.replace(
        name="baseline3-quarantine",
        data=dataclasses.replace(b3.data, synthetic_train_size=6_000,
                                 synthetic_test_size=1_000),
        federated=dataclasses.replace(b3.federated, local_ep=1,
                                      compact=False),
        faults=FaultConfig(corrupt=1.0, corrupt_max=2, corrupt_mode="nan"),
        robust=RobustConfig(quarantine_after=2, quarantine_rounds=3))
    tr, q_state, got = fed_run("11e baseline3 + nan liars + quarantine "
                               "per-round", quar, 6, 1)
    del tr
    check_ledger("11e", q_state["ledger"], quar, 6)
    q_rows = [(r["round"], r["worker"], r["action"])
              for r in q_state["ledger"] if r["kind"] == "quarantine"]
    print(f"11e quarantine rows {q_rows}")
    benched = [(r, w, a) for r, w, a in q_rows
               if a.startswith("quarantined_until_")]
    if not benched or not any(a == "readmitted" for _, _, a in q_rows):
        fail(f"11e: the quarantine must fire and readmit in 6 rounds: "
             f"{q_rows}")
    for r, w, a in benched:
        until = int(a.rsplit("_", 1)[1])
        if until != r + 4 or (until < 6
                              and (until, w, "readmitted") not in q_rows):
            fail(f"11e: worker {w} benched at {r} with {a}: {q_rows}")
    tr, _, _ = fed_run("11e the same, blocks of 3 (chaos round)", quar, 6,
                       3, q_state, got)
    del tr
    torch.cuda.empty_cache()

    # -- 11f. the two new kernel sites, timed as 3b.
    shapes = param_shapes("model1")
    on = {w for w in range(16) if not rf0.straggler[w]}
    site = {"k1": kit.gated_site(
        f"faulty federated headline model1 W=16, {len(on)} lanes on "
        "(round 0's stragglers off)", shapes, 16, on)}
    mask0 = np.zeros(16, np.float32)
    mask0[sel0] = 1.0
    site["k2"] = kit.k2_site(
        f"faulty federated headline model1 n=16, survivors "
        f"{np.nonzero(mask0)[0].tolist()}, lr -1", shapes,
        mean_weight_matrix(torch.tensor(mask0, device=dev)), -1.0)
    for key, (rate, peak, idle) in rates.items():
        print(f"11 rates {key}: {rate:.4f} rounds/s; peak {peak} B; idle "
              f"{idle}; {smi}")
    for name, (ms, peak) in agg_ms.items():
        print(f"11 aggregation {name}: {ms:.4f} ms, peak {peak} B; {smi}")
    print(f"11: phase 11 in {time.perf_counter() - t11:.1f} s")
    return {"launch": fh_launch, "site": site}


def phase12(dev, smi: str, get_preset, kit) -> dict:
    """Phase 12, async and one-peer mixing and the telemetry stream with
    on-card diagnostics.  ``kit`` holds phase 3's timers (``time_ms``,
    ``k1_site``, ``k2_site``), phase 6's ``profile_round`` and phase 5's
    2-round headline runs (``g_state``/``glaunch``, ``f_state``/
    ``flaunch``).  Returns the launch counts of 12b's and 12c's main-path
    runs, the kernel rows of 12b's sites, and the rates."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from dopt_torch.engine import FederatedTrainer, GossipTrainer
    from dopt_torch.engine.gossip import round_diag
    from dopt_torch.models.zoo import param_shapes
    from dopt_torch.obs import (JsonlSink, MemorySink, Telemetry, attach,
                                canonical, check_stream)
    from dopt_torch.obs.check import main as check_main
    from dopt_torch.ops import _build
    from dopt_torch.ops.fused_update import (fused_mix_sgd,
                                             fused_sgd_momentum,
                                             launch_counts)
    from dopt_torch.topology import build_mixing_matrices

    t12 = time.perf_counter()
    rates: dict[str, tuple] = {}
    out: dict = {"launch": {}}

    def zero_counts() -> None:
        fused_sgd_momentum.launches = 0
        fused_mix_sgd.launches = 0

    def timed_run(tr, n, block) -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        tr.run(rounds=n, block=block)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    # -- 12a. bench.py's topology-modes legs (32 workers, the MLP in bf16
    # compute): blocked as bench times them (eval beyond the run, a warm-up
    # block, then timed blocks), per-round beside them, blocked ≡
    # per-round, and async ≡ sync in round 0.
    legs = ("bench-topo-complete-sync", "bench-topo-one_peer_exp-sync",
            "bench-topo-one_peer_exp-async")
    block, reps, never = 8, 3, 10 ** 6
    r0 = {}
    for name in legs:
        cfg = get_preset(name)
        base = torch.cuda.memory_allocated()
        per = GossipTrainer(cfg, device=dev, eval_every=never)
        wall = timed_run(per, 4, 1)
        per_rate = 4 / wall
        blk = GossipTrainer(cfg, device=dev, eval_every=never)
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        blk.run(rounds=4, block=2)
        same_state(f"12a {name}, blocks of 2, against per-round",
                   state(per), state(blk))
        if any(launch_counts().values()):
            fail(f"12a {name}: kernels launched with both switches off")
        del per, blk
        tr = GossipTrainer(cfg, device=dev, eval_every=never)
        timed_run(tr, block, block)            # warm-up: round 0 and captures
        samples = [block / timed_run(tr, block, block) for _ in range(reps)]
        peak = torch.cuda.max_memory_allocated() - base
        # The first leg's block only is profiled (the one-peer legs' cost
        # ~7 s each on a slow host).
        idle = (kit.profile_round(f"12a {name}, {block} replayed rounds",
                                  functools.partial(tr.run, rounds=block,
                                                    block=block),
                                  model=tr.cfg.model.model)
                if name == legs[0] else None)
        rate = float(np.median(samples))
        rates[f"12a {name}"] = (per_rate, rate, idle, peak)
        print(f"12a {name}: per-round {per_rate:.4f} rounds/s; blocked "
              f"{rate:.4f} rounds/s (median of {reps} blocks of {block} "
              f"replayed rounds: {[round(s, 4) for s in samples]}); idle "
              + (f"{100 * idle:.1f}% of a profiled block"
                 if idle is not None else "not profiled")
              + f"; peak {peak} B over "
              f"what was allocated before; graphs {tr.graphs.captures}; "
              f"{smi}")
        del tr
        torch.cuda.empty_cache()
        if "one_peer" in name:
            one = GossipTrainer(cfg, device=dev)
            one.run(rounds=1)
            r0[cfg.gossip.mixing] = state(one)
            del one
    same_state("12a one-peer async round 0 against sync round 0",
               {k: v for k, v in r0["sync"].items()},
               {k: v for k, v in r0["async"].items() if k in r0["sync"]})

    # -- 12b. the one-peer sync leg with both fused switches: kernel 2's
    # ring kernel at n = 32 and kernel 1 at 32 MLP lanes.
    report = _build.parse_ptxas(_build.resource_report())
    for k, r in report.items():
        if "mix_sgd_ring_kernel" in k:
            print(f"12b n = 32 build: {k[:60]}: {r['registers']} registers, "
                  f"{r['stack_frame']} B stack frame, {r['spill_stores']} B "
                  f"spill stores, {r['spill_loads']} B spill loads")
            if r["stack_frame"] or r["spill_stores"] or r["spill_loads"]:
                fail(f"12b: the ring kernel spills at n = 32: {r}")
    onep = get_preset("bench-topo-one_peer_exp-sync")
    fused = onep.replace(
        name=onep.name + "-fused",
        optim=dataclasses.replace(onep.optim, fused_update=True),
        gossip=dataclasses.replace(onep.gossip, fused_update="on"))
    mlp_s = param_shapes("mlp")
    w0 = build_mixing_matrices("one_peer_exp", "metropolis", 32,
                               seed=onep.seed).for_round(0)
    site = {"k1": kit.k1_site("bench-topo one-peer mlp W=32", mlp_s, 32),
            "k2": kit.k2_site("bench-topo one-peer mlp n=32, W_0 = (I + "
                              "P_1)/2, lr 1", mlp_s, torch.tensor(
                                  np.asarray(w0, np.float32), device=dev),
                              1.0)}
    out["site"] = site
    per = GossipTrainer(fused, device=dev)
    zero_counts()
    per.run(rounds=2)
    torch.cuda.synchronize()
    got = launch_counts()
    want = {"fused_sgd_momentum": 2 * per.steps_per_round,
            "fused_mix_sgd": 2 * per.fused_spec.num_buckets}
    print(f"12b {fused.name}: launches {got} (expected {want}: kernel 1 "
          "once a step over 32 lanes, kernel 2 once a bucket a round at "
          "n = 32)")
    if got != want:
        fail(f"12b: launches {got} != {want}")
    out["launch"]["bench-topo-one_peer_exp-sync"] = got
    for row in per.history.rows:
        if not (math.isfinite(row["avg_train_loss"])
                and 0.0 <= row["avg_test_acc"] <= 1.0):
            fail(f"12b: bad row {row}")
    blk = GossipTrainer(fused, device=dev)
    zero_counts()
    blk.run(rounds=2, block=2)
    same_state("12b one-peer fused, blocks of 2, against per-round",
               state(per), state(blk))
    if launch_counts() != got:
        fail(f"12b blocked: launches {launch_counts()} != {got}")
    del per, blk
    tr = GossipTrainer(fused, device=dev, eval_every=never)
    timed_run(tr, block, block)
    samples = [block / timed_run(tr, block, block) for _ in range(reps)]
    rates["12b one-peer fused"] = (None, float(np.median(samples)), None,
                                   None)
    print(f"12b {fused.name}: blocked {np.median(samples):.4f} rounds/s "
          f"({samples}); {smi}")
    del tr
    torch.cuda.empty_cache()

    # -- 12c. both f32 headlines with diagnostics on and a telemetry
    # stream: the params and launches of phase 5's runs, per-round ≡
    # blocked streams, a killed-and-resumed JSONL stream, resource events.
    def diag_run(label, cls, cfg, n, block, want, want_launch):
        """A fresh trainer with a MemorySink: n rounds in blocks of
        ``block``, the state and launches against ``want`` and
        ``want_launch`` (the diagnostics-off run's), every ``resource``
        event's peak against the card's allocator."""
        base = torch.cuda.memory_allocated()
        tr = cls(cfg, device=dev)
        mem = MemorySink()
        attach(tr, Telemetry([mem]))
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        wall = timed_run(tr, n, block)
        peak = torch.cuda.max_memory_allocated()
        got = launch_counts()
        events = mem.events
        check_stream(events)
        res = [e for e in events if e["kind"] == "resource"]
        if not res or any(e["source"] != "device" or e["peak_bytes"] > peak
                          or e["live_bytes"] > e["peak_bytes"]
                          for e in res) or res[-1]["peak_bytes"] != peak:
            fail(f"12c {label}: resource events {res} against the card's "
                 f"peak {peak} B")
        print(f"12c {label}: {n} rounds in {wall:.3f} s ({n / wall:.4f} "
              f"rounds/s), launches {got}, {len(events)} events "
              f"({sorted({e['kind'] for e in events})}), resource peak "
              f"{res[-1]['peak_bytes']} B = the card's max_memory_allocated "
              f"({peak - base} B over what was allocated before the "
              f"trainer); {smi}")
        same_state(f"12c {label}, against the run with diagnostics off",
                   want, state(tr))
        if got != want_launch:
            fail(f"12c {label}: launches {got} != {want_launch}")
        return tr, events, got, wall

    ghead = get_preset("headline-dsgd-model1")
    gdiag = ghead.replace(gossip=dataclasses.replace(ghead.gossip,
                                                     diagnostics="on"))
    fhead = get_preset("headline-fedavg-model1")
    fdiag = fhead.replace(federated=dataclasses.replace(fhead.federated,
                                                        diagnostics="on"))
    tr, g_events, g_got, g_wall = diag_run(
        "headline-dsgd-model1, diagnostics on", GossipTrainer, gdiag, 2, 1,
        kit.g_state, kit.glaunch)
    # The six reductions alone, on the run's final state, timed as 3b.
    params = tr._param_dict()
    moms = dict(zip(tr._names, tr.momentum))
    start = {k: v.clone() for k, v in params.items()}
    losses = torch.rand(tr.num_workers, tr.steps_per_round, device=dev)
    ones = torch.ones(tr.num_workers, device=dev)
    diag_ms = kit.time_ms(lambda: round_diag(params, moms, start, losses,
                                             ones))
    print(f"12c gossip round_diag on 6 Model1 lanes: {diag_ms:.4f} ms a "
          f"round against the diagnosed round's {1e3 * g_wall / 2:.1f} ms "
          f"wall; {smi}")
    del tr, params, moms, start
    _, gb_events, gb_got, _ = diag_run(
        "headline-dsgd-model1, diagnostics on, blocks of 2", GossipTrainer,
        gdiag, 2, 2, kit.g_state, kit.glaunch)
    if canonical(gb_events) != canonical(g_events):
        fail("12c: the blocked gossip stream differs from the per-round one")
    print("12c headline-dsgd-model1: blocked stream = per-round stream "
          f"({len(canonical(g_events))} canonical events, gauges included)")
    ckdir = Path(tempfile.mkdtemp(prefix="dopt-torch-obs-"))
    try:
        mpath = ckdir / "metrics.jsonl"
        victim = GossipTrainer(gdiag, device=dev)
        t1 = Telemetry.to_jsonl(mpath)
        attach(victim, t1)
        zero_counts()
        victim.run(rounds=1, checkpoint_every=1,
                   checkpoint_path=ckdir / "ck")
        t1.close()
        del victim
        resumed = GossipTrainer(gdiag, device=dev)
        resumed.restore(ckdir / "ck")
        t2 = Telemetry.to_jsonl(mpath, resume=True)
        attach(resumed, t2)
        resumed.run(rounds=1)
        t2.close()
        same_state("12c headline-dsgd-model1, diagnostics on, killed after "
                   "round 0 and resumed, against phase 5", kit.g_state,
                   state(resumed))
        if launch_counts() != kit.glaunch:
            fail(f"12c resume: launches {launch_counts()} != "
                 f"{kit.glaunch}")
        if check_main([str(mpath)]) != 0:
            fail("12c: obs.check refused the killed-and-resumed stream")
        merged = JsonlSink.read(mpath)
        if canonical(merged) != canonical(g_events):
            fail("12c: the killed-and-resumed stream differs from the "
                 "continuous one")
        print(f"12c killed-and-resumed JSONL stream: {len(merged)} events, "
              "passes obs.check, canonically equal to the continuous run")
        del resumed
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    torch.cuda.empty_cache()
    _, f_events, f_got, f_wall = diag_run(
        "headline-fedavg-model1, diagnostics on", FederatedTrainer, fdiag,
        2, 1, kit.f_state, kit.flaunch)
    _, fb_events, _, _ = diag_run(
        "headline-fedavg-model1, diagnostics on, blocks of 2",
        FederatedTrainer, fdiag, 2, 2, kit.f_state, kit.flaunch)
    if canonical(fb_events) != canonical(f_events):
        fail("12c: the blocked federated stream differs from the per-round "
             "one")
    print("12c headline-fedavg-model1: blocked stream = per-round stream "
          f"({len(canonical(f_events))} canonical events, gauges included)")
    for label, events in (("gossip", g_events), ("federated", f_events)):
        gauges = {e["name"]: round(e["value"], 6) for e in events
                  if e["kind"] == "gauge" and e["round"] == 1}
        print(f"12c {label} headline round-1 gauges {gauges}")
    out["launch"]["headline-dsgd-model1-diagnostics"] = g_got
    out["launch"]["headline-fedavg-model1-diagnostics"] = f_got
    rates["12c gossip diagnosed"] = (2 / g_wall, None, None, None)
    rates["12c federated diagnosed"] = (2 / f_wall, None, None, None)
    out["diag_ms"] = diag_ms
    torch.cuda.empty_cache()
    for key, (per_rate, rate, idle, peak) in rates.items():
        print(f"12 rates {key}: per-round {per_rate}, blocked {rate} "
              f"rounds/s; idle {idle}; peak {peak} B; {smi}")
    out["rates"] = rates
    print(f"12: phase 12 in {time.perf_counter() - t12:.1f} s")
    return out


def phase13(dev, smi: str, get_preset, kit, ckdir: Path) -> dict:
    """Phase 13, dopt's GroupNorm ResNet-18 and ``baseline5`` at full
    width on the card: 32 workers, 11,173,962 parameters a worker (62
    tensors), CIFAR-10's sizes (50,000/10,000 synthetic samples), f32
    under the deterministic mode unless said.  ``kit`` holds phase 3's
    timers (``time_ms``, ``k1_site``, ``k2_site``); ``ckdir`` takes
    13g's checkpoints.  Returns the
    launch counts of 13a's main-path run and the kernel rows of 13b."""
    import numpy as np
    import torch

    from dopt_torch.engine import GossipTrainer
    from dopt_torch.models.zoo import param_shapes
    from dopt_torch.ops.fused_update import (fused_mix_sgd,
                                             fused_sgd_momentum,
                                             launch_counts)
    from dopt_torch.topology import build_mixing_matrices

    t13 = time.perf_counter()
    b5 = get_preset("baseline5")
    fused = b5.replace(
        optim=dataclasses.replace(b5.optim, fused_update=True),
        gossip=dataclasses.replace(b5.gossip, fused_update="on"))
    round0_only = 10 ** 9   # eval_every: the test-set eval in round 0 only
    rates: dict[str, tuple] = {}

    def zero_counts() -> None:
        fused_sgd_momentum.launches = 0
        fused_mix_sgd.launches = 0

    def check_rows(label, tr) -> None:
        for row in tr.history.rows:
            if not all(math.isfinite(row[k]) for k in row
                       if k.endswith("loss")):
                fail(f"13 {label}: non-finite loss in {row}")
            if not all(0.0 <= row[k] <= 1.0 for k in row
                       if k.endswith("acc")):
                fail(f"13 {label}: accuracy out of range in {row}")

    def check_params(label, tr) -> None:
        want = param_shapes("resnet18", input_shape=(32, 32, 3))
        final = tr.worker_params()
        if final.keys() != want.keys() or tr.param_count != 11_173_962:
            fail(f"13 {label}: {tr.param_count} params a worker in "
                 f"{len(final)} tensors, expected 11,173,962 in 62")
        for k, shp in want.items():
            if final[k].shape != (32, *shp) or not np.isfinite(
                    final[k]).all():
                fail(f"13 {label}: {k} has shape {final[k].shape} or is "
                     "non-finite")

    def rounds_timed(label, cfg, n, *, block=1, tr=None, start=0):
        """A fresh trainer (or ``tr``) runs n rounds per-round, each timed
        alone with the in-round eval split out, or (block > 1) in one
        timed call; the counts set to 0 just before and read just after,
        the peak over what was allocated before the trainer.  A fresh
        trainer starting at round ``start`` = 1 skips the eval (which
        eval_every runs in round 0 only)."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        t = time.perf_counter()
        if tr is None:
            tr = GossipTrainer(cfg, device=dev, eval_every=round0_only)
            tr.round = start
        built = time.perf_counter() - t
        evals: list[float] = []
        evaluate = tr._evaluate_round

        def timed_eval():
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = evaluate()
            torch.cuda.synchronize()
            evals.append(time.perf_counter() - t)
            return out
        if block == 1:   # a capture may not synchronize
            tr._evaluate_round = timed_eval
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(n if block == 1 else 1):
            torch.cuda.synchronize()
            t = time.perf_counter()
            tr.run(rounds=1 if block == 1 else n, block=block)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        tr.__dict__.pop("_evaluate_round", None)
        got = launch_counts()
        peak = torch.cuda.max_memory_allocated() - base
        check_rows(label, tr)
        print(f"13 {label}: built in {built:.2f} s; "
              f"{'per-round walls' if block == 1 else f'blocks of {block}'}"
              f" {[round(w, 3) for w in walls]} s, eval {[round(e, 3) for e in evals]}"
              f" s; {n / sum(walls):.4f} rounds/s; peak {peak} B over what "
              f"was allocated before; launches {got}; {smi}")
        rates[label] = (n / sum(walls), walls, evals, peak)
        return tr, got, peak

    # -- 13a. both fused switches, 2 rounds per-round, rounds 1-2: no
    # f32 eval (~42 s a call on the H100; 13d evaluates, in bf16 compute).
    n = 2
    tr, a_launch, _ = rounds_timed("13a baseline5, both fused switches "
                                   "(rounds 1-2)", fused, n, start=1)
    steps, buckets = tr.steps_per_round, tr.fused_spec.num_buckets
    want = {"fused_sgd_momentum": 4 * steps * n, "fused_mix_sgd": 11 * n}
    print(f"13a {steps} steps a round, {buckets} buckets "
          f"{[b - a for a, b in zip(tr.fused_spec.bounds, tr.fused_spec.bounds[1:])]}"
          f", launches {a_launch} (expected {want}: kernel 1 four chunks of "
          "at most 16 of the 62 tensors a step, kernel 2 once a bucket)")
    if steps != 13 or buckets != 11 or a_launch != want:
        fail(f"13a: {steps} steps, {buckets} buckets, launches {a_launch}, "
             f"expected 13, 11 and {want}")
    check_params("13a", tr)
    a_state = state(tr)
    del tr
    gc.collect()
    torch.cuda.empty_cache()

    # -- 13b. both kernels at 13a's shapes against their plain versions,
    # their bound and their library calls.
    shapes = param_shapes("resnet18", input_shape=(32, 32, 3))
    site = {"k1": kit.k1_site("baseline5 resnet18 W=32, 62 tensors",
                              shapes, 32)}
    torch.cuda.empty_cache()
    w0 = torch.tensor(np.asarray(build_mixing_matrices(
        "random", "metropolis", 32, seed=b5.seed).for_round(0), np.float32),
        device=dev)
    site["k2"] = kit.k2_site("baseline5 resnet18 n=32, random metropolis W, "
                             "lr 1", shapes, w0, 1.0)
    for key, row in site.items():
        print(f"13b {key}: kernel {1e3 * row['ms']:.1f} us, plain "
              f"{1e3 * row['plain_ms']:.1f} us, library "
              f"{row['library_ms'] and round(1e3 * row['library_ms'], 1)} us,"
              f" bound {1e3 * row['bound_ms']:.1f} us "
              f"({100 * row['bound_ms'] / row['ms']:.1f}% of the bound); "
              f"{smi}")
    torch.cuda.empty_cache()

    # -- 13c. 13a blocked, in blocks of 2: bit for bit.
    tr, c_launch, c_peak = rounds_timed(
        "13c baseline5, both fused switches, blocks of 2 (rounds 1-2)",
        fused, n, block=2, start=1)
    same_state("13c baseline5 blocked, against 13a", a_state, state(tr))
    if c_launch != a_launch:
        fail(f"13c: launches {c_launch} != 13a's {a_launch}")
    print(f"13c graphs {tr.graphs.captures}; reserved "
          f"{torch.cuda.memory_reserved()} B with the graphs held, peak "
          f"{c_peak} B over what was allocated before; {smi}")
    del tr, a_state
    gc.collect()
    torch.cuda.empty_cache()

    # -- 13d. bf16 compute, both fused switches, round 1 (no eval).
    bf16 = fused.replace(model=dataclasses.replace(
        fused.model, compute_dtype="bfloat16"))
    tr, d_launch, _ = rounds_timed("13d baseline5, bf16 compute, both fused "
                                   "switches (round 1)", bf16, 1, start=1)
    if d_launch != {k: v // n for k, v in a_launch.items()}:
        fail(f"13d: launches {d_launch} != one round of 13a's {a_launch}")
    check_params("13d", tr)
    del tr
    gc.collect()
    torch.cuda.empty_cache()

    # -- 13e. baseline5 as typed: one round, no eval (it starts at round
    # 1, which eval_every skips), no kernel.
    tr, e_launch, _ = rounds_timed("13e baseline5 as typed (round 1)", b5, 1,
                                   start=1)
    if any(e_launch.values()) or "avg_test_acc" in tr.history.rows[0]:
        fail(f"13e: baseline5 as typed launched {e_launch} or evaluated")
    check_params("13e", tr)
    del tr
    gc.collect()
    torch.cuda.empty_cache()

    # -- 13g. kill and resume at reduced depth: stage sizes (1, 1, 1, 1),
    # 8 workers, 3,000/500 samples, 4 rounds in blocks of 2 with
    # prefetch and checkpoint_every=2, killed right after the round-2
    # save; a fresh trainer restores it and runs rounds 2-3.
    small = fused.replace(
        data=dataclasses.replace(fused.data, num_users=8,
                                 synthetic_train_size=3_000,
                                 synthetic_test_size=500),
        model=dataclasses.replace(fused.model, stage_sizes=(1, 1, 1, 1)),
        gossip=dataclasses.replace(fused.gossip, prefetch="on"))
    t = time.perf_counter()
    cont = GossipTrainer(small, device=dev)
    cont.run(rounds=4, block=2)
    want = state(cont)
    del cont
    print(f"13g continuous run: {time.perf_counter() - t:.1f} s")

    class Killed(Exception):
        pass

    victim = GossipTrainer(small, device=dev)
    save = victim.save

    def save_and_die(path):
        save(path)
        raise Killed(f"killed after the round-{victim.round} checkpoint")
    victim.save = save_and_die
    try:
        victim.run(rounds=4, block=2, checkpoint_every=2,
                   checkpoint_path=ckdir / "resnet")
    except Killed as e:
        print(f"13g {e}")
    else:
        fail("13g: the victim run was not killed at its checkpoint")
    del victim
    resumed = GossipTrainer(small, device=dev)
    resumed.restore(ckdir / "resnet")
    if resumed.round != 2:
        fail(f"13g: restored at round {resumed.round}, expected 2")
    resumed.run(rounds=2, block=2)
    print(f"13g victim and resumed runs: {time.perf_counter() - t:.1f} s "
          "since the continuous run began")
    same_state("13g baseline5 at stage sizes (1, 1, 1, 1), 8 workers, both "
               "fused switches, blocks of 2, killed after round 1's "
               "checkpoint and resumed, against the continuous run", want,
               state(resumed))
    del resumed
    for key, (rate, walls, evals, peak) in rates.items():
        print(f"13 rates {key}: {rate} rounds/s; walls {walls} s; evals "
              f"{evals} s; peak {peak} B; {smi}")
    print(f"13: phase 13 in {time.perf_counter() - t13:.1f} s")
    return {"launch": a_launch, "site": site, "rates": rates}


def phase14(dev, smi: str, get_preset, kit, ckdir: Path) -> dict:
    """Phase 14, choco and the narrowed wire on the card: f32 under the
    deterministic mode unless said.  ``kit`` holds phase 3's ``flush``
    buffer and phase 5's headline walls (``gwall``, ``fwall`` for
    ``rounds`` rounds); ``ckdir`` takes 14c's checkpoint.  Returns each
    path's launch counts (``launch``) for the kernels line."""
    import numpy as np
    import torch

    from dopt_torch.convert import dopt_flat_order
    from dopt_torch.engine import FederatedTrainer, GossipTrainer
    from dopt_torch.models.zoo import param_shapes
    from dopt_torch.ops import compression as C
    from dopt_torch.ops.fused_update import (MAX_TENSORS, fused_mix_sgd,
                                             fused_sgd_momentum,
                                             launch_counts)
    from dopt_torch.utils import prng

    t14 = time.perf_counter()
    rep = dataclasses.replace
    head = get_preset("headline-dsgd-model1")
    fhead = get_preset("headline-fedavg-model1")
    round0_only = 10 ** 9
    g_rate = kit.rounds / kit.gwall
    f_rate = kit.rounds / kit.fwall
    launch: dict[str, dict] = {}

    def choco(base, compression, ratio=0.1, levels=0, gamma=0.1):
        """``base`` with choco, kernel 1 on and the fused epilogue off
        (dopt refuses it with choco)."""
        return base.replace(
            optim=rep(base.optim, fused_update=True),
            gossip=rep(base.gossip, fused_update="off", algorithm="choco",
                       compression=compression, compression_ratio=ratio,
                       qsgd_levels=levels, choco_gamma=gamma))

    def choco_state(tr) -> dict:
        out = state(tr)
        out["x_hat"] = {k: v.float().cpu().numpy().copy()
                        for k, v in tr.x_hat.items()}
        return out

    def run14(label, cls, cfg, n, *, block=1, tr=None, skip_eval=False,
              after_round=None):
        """A fresh trainer (or ``tr``) runs n rounds, per-round (each
        timed alone, choco's exchange timed inside it, then
        ``after_round(tr)`` outside the timing) or in one blocked call;
        eval in round 0 only (none with ``skip_eval``: the run starts at
        round 1).  The counts are set to 0 just before the run and read
        just after; the peak is over what was allocated before the
        trainer."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        t = time.perf_counter()
        if tr is None:
            tr = (GossipTrainer(cfg, device=dev, eval_every=round0_only)
                  if cls is GossipTrainer else cls(cfg, device=dev))
            if skip_eval:
                tr.round = 1
        built = time.perf_counter() - t
        mix_s: list[float] = []
        if block == 1 and getattr(tr, "_choco", False):
            mix = tr._choco_mix

            def timed_mix(*a):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = mix(*a)
                torch.cuda.synchronize()
                mix_s.append(time.perf_counter() - t)
                return out
            tr._choco_mix = timed_mix
        fused_sgd_momentum.launches = 0
        fused_mix_sgd.launches = 0
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(n if block == 1 else 1):
            torch.cuda.synchronize()
            t = time.perf_counter()
            tr.run(rounds=1 if block == 1 else n, block=block)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            if after_round is not None:
                after_round(tr)
        got = launch_counts()
        tr.__dict__.pop("_choco_mix", None)
        peak = torch.cuda.max_memory_allocated() - base
        for row in tr.history.rows:
            if not all(math.isfinite(v) for k, v in row.items()
                       if k.endswith("loss")):
                fail(f"14 {label}: non-finite loss in {row}")
        tensors = len(getattr(tr, "_names", None) or tr.params)
        want = {"fused_sgd_momentum": n * tr.steps_per_round
                * -(-tensors // MAX_TENSORS), "fused_mix_sgd": 0}
        if got != want:
            fail(f"14 {label}: launches {got}, expected {want} (kernel 1 "
                 "every step, kernel 2 never)")
        print(f"14 {label}: built in {built:.2f} s; walls "
              f"{[round(w, 4) for w in walls]} s; {n / sum(walls):.4f} "
              f"rounds/s; choco exchange {[round(s, 4) for s in mix_s]} s "
              f"a round; peak {peak} B over what was allocated before; "
              f"launches {got}; {smi}")
        return tr, got, walls, peak, mix_s

    # -- 14a. choco on the gossip headline: top-k 0.1, rand-k 0.1 and
    # QSGD with 16 levels, γ = 0.1; rand-k 2 rounds (14c holds them
    # blocked and resumed), top-k and QSGD one round each (cut from 2
    # for the budget).
    cfgs = {"topk": choco(head, "topk"), "randk": choco(head, "randk"),
            "qsgd": choco(head, "qsgd", levels=16)}
    a_state = {}
    for name, cfg in cfgs.items():
        n = 2 if name == "randk" else 1
        tr, got, walls, peak, mix_s = run14(f"14a choco {name}", GossipTrainer,
                                            cfg, n)
        launch[f"headline-dsgd-model1-choco-{name}"] = got
        print(f"14a choco {name}: {n / sum(walls):.4f} rounds/s against "
              f"phase 5's dsgd {g_rate:.4f} (both fused switches); the "
              f"exchange takes {100 * sum(mix_s) / sum(walls):.2f}% of the "
              f"walls; {smi}")
        if name == "randk":
            a_state = choco_state(tr)
            a_launch = got
        del tr
        gc.collect()
        torch.cuda.empty_cache()

    # -- 14b. the draws, masks and QSGD on the card against the CPU.
    w = 6
    shapes = param_shapes("model1")
    key = prng.fold_in(prng.jax_key(head.seed ^ 0x0C0C0), 1)
    u_cpu = prng.uniform(key, (w, 1_663_370))
    u_gpu = prng.uniform(key.to(dev), (w, 1_663_370)).cpu()
    if not torch.equal(u_cpu.view(torch.int32), u_gpu.view(torch.int32)):
        fail("14b: uniform on the card differs from the CPU's")
    print(f"14b uniform [{w}, 1663370]: the card's bits equal the CPU's")
    gen = torch.Generator().manual_seed(14)
    tree = {k: torch.randn(w, *s, generator=gen) for k, s in shapes.items()}
    fwd = dopt_flat_order(shapes, input_shape=(28, 28, 1))
    order_c = C.device_order(fwd)
    order_g = C.device_order(fwd, dev)
    tree_g = {k: v.to(dev) for k, v in tree.items()}
    key_g = key.to(dev)
    for name, fn in (("top_k", lambda t, o, k: C.top_k_compress(
            t, 0.1, order=o)), ("rand_k", lambda t, o, k: C.rand_k_compress(
                t, 0.1, k, order=o))):
        a, b = fn(tree, order_c, key), fn(tree_g, order_g, key_g)
        for k in tree:
            if not torch.equal(a[k].view(torch.int32),
                               b[k].cpu().view(torch.int32)):
                fail(f"14b {name}: the card's {k} differs from the CPU's")
        print(f"14b {name} 0.1 at Model1's shapes (W = {w}): the card's "
              "result equals the CPU's bit for bit")
    a = C.qsgd_compress(tree, 0.1, key, levels=16, order=order_c)
    b = C.qsgd_compress(tree_g, 0.1, key_g, levels=16, order=order_g)
    off = total = 0
    for k, x in tree.items():
        qa, qb = a[k].reshape(w, -1).numpy(), b[k].cpu().reshape(w, -1).numpy()
        d = np.abs(qa - qb)
        bad = d > 1e-6 * np.abs(qa)
        total += qa.size
        if not bad.any():
            continue
        off += int(bad.sum())
        xd = x.reshape(w, -1).double().numpy()
        if fwd[k] is not None:
            xd = xd[:, fwd[k]]
            d, bad = d[:, fwd[k]], bad[:, fwd[k]]
        m = xd.shape[1]
        bsz = min(2048, m)
        xd = np.pad(xd, ((0, 0), (0, -(-m // bsz) * bsz - m)))
        step = np.repeat(np.sqrt((xd ** 2).reshape(w, -1, bsz).sum(2)), bsz,
                         axis=1)[:, :m] / 16
        if not (np.abs(d - step) <= 1e-5 * step)[bad].all():
            fail(f"14b qsgd: {k} differs by other than one level")
    if off > 1e-4 * total:
        fail(f"14b qsgd: {off} of {total} elements a level away")
    print(f"14b qsgd 16 levels: the card's result within 1e-6 relative of "
          f"the CPU's on all but {off} of {total} elements, each one level "
          "away (bound: 1e-4 of them)")
    del u_cpu, u_gpu, tree_g, a, b
    tiny = choco(head.replace(
        data=rep(head.data, dataset="synthetic", num_users=4,
                 synthetic_train_size=128, synthetic_test_size=32),
        model=rep(head.model, input_shape=(8, 8, 1)),
        gossip=rep(head.gossip, local_ep=1, local_bs=16)), "randk",
        ratio=0.25, gamma=0.2)
    runs = {}
    for d in ("cuda", "cpu"):
        tr = GossipTrainer(tiny, device=d)
        tr.run(rounds=2)
        runs[d] = tr
    for ra, rb in zip(runs["cuda"].history.rows, runs["cpu"].history.rows,
                      strict=True):
        if (abs(ra["avg_train_loss"] - rb["avg_train_loss"]) > LOSS_TOL
                or abs(ra["avg_test_acc"] - rb["avg_test_acc"]) > ACC_TOL):
            fail(f"14b tiny choco: cuda {ra} vs cpu {rb}")
    rel = max(max_rel(runs["cpu"].worker_params(),
                      runs["cuda"].worker_params()),
              max_rel({k: v.float().numpy() for k, v in
                       runs["cpu"].x_hat.items()},
                      {k: v.float().cpu().numpy() for k, v in
                       runs["cuda"].x_hat.items()}))
    if not rel <= PARAM_REL_TOL:
        fail(f"14b tiny choco: params or x_hat differ by {rel:.3e}")
    print(f"14b tiny choco rand-k 0.25 (Model1 at 8x8, 4 workers, "
          f"128/32, 2 rounds): cuda vs cpu History within {LOSS_TOL}/{ACC_TOL}, params "
          f"and x_hat max-rel {rel:.3e} (limit {PARAM_REL_TOL})")
    del runs, tr

    # -- 14c. 14a's rand-k run in blocks of 2, and killed and resumed.
    tr, got, _, c_peak, _ = run14("14c choco randk, blocks of 2",
                                  GossipTrainer, cfgs["randk"], 2, block=2)
    same_state("14c choco randk blocked, against 14a", a_state,
               choco_state(tr))
    if got != a_launch:
        fail(f"14c: launches {got} != 14a's {a_launch}")
    print(f"14c graphs {tr.graphs.captures}; peak {c_peak} B; {smi}")
    del tr
    fused_sgd_momentum.launches = 0
    fused_mix_sgd.launches = 0
    victim = GossipTrainer(cfgs["randk"], device=dev, eval_every=round0_only)
    victim.run(rounds=1, checkpoint_every=1, checkpoint_path=ckdir / "choco")
    del victim
    resumed = GossipTrainer(cfgs["randk"], device=dev, eval_every=round0_only)
    resumed.restore(ckdir / "choco")
    resumed.run(rounds=1)
    torch.cuda.synchronize()
    same_state("14c choco randk killed after round 0 and resumed, against "
               "14a", a_state, choco_state(resumed))
    if launch_counts() != a_launch:
        fail(f"14c resume: launches {launch_counts()} != {a_launch}")
    del resumed, a_state
    gc.collect()
    torch.cuda.empty_cache()

    # -- 14d. the narrowed wire on both headlines, beside the f32 wire:
    # the gossip f32 wire 2 rounds (15a and 17a hold their 2 rounds
    # against it), the federated f32 wire one (cut from 2 for the budget;
    # 15d and 17b hold their one round against it), the bf16 wire one
    # (cut from 2 for the budget), held against the f32 wire's round 0:
    # the gossip workers' params (the wire carries round 0's mix) and the
    # federated theta (the wire carries round 0's aggregation; the lanes'
    # params are the same after it).
    f32_rounds = {"gossip": 2, "federated": 1}

    def wired(tr):
        return (tr.global_params() if isinstance(tr, FederatedTrainer)
                else tr.worker_params())

    f32wire: dict[str, dict] = {}
    g32 = head.replace(gossip=rep(head.gossip, fused_update="off"))
    f32 = fhead.replace(federated=rep(fhead.federated, fused_update="off",
                                      compact=False))
    for label, cls, cfg in (("gossip", GossipTrainer, g32),
                            ("federated", FederatedTrainer, f32)):
        res = {}
        for wire in (None, "bfloat16"):
            sec = "gossip" if cls is GossipTrainer else "federated"
            c = cfg.replace(**{sec: rep(getattr(cfg, sec), comm_dtype=wire)})
            round0 = []
            tr, got, walls, peak, _ = run14(
                f"14d {label} headline, fused epilogue off, wire "
                f"{wire or 'float32'}", cls, c,
                f32_rounds[label] if wire is None else 1,
                after_round=lambda t: round0.append(wired(t))
                if not round0 else None)
            if cls is FederatedTrainer and tr._use_compact():
                fail("14d: the federated run left the full width")
            res[wire] = (round0[0], len(walls) / sum(walls))
            if wire is None:
                # Phases 15 and 17 hold their runs against this one.
                f32wire[label] = {
                    "rate": len(walls) / sum(walls),
                    "rows": [dict(r) for r in tr.history.rows],
                    "params": wired(tr)}
            if wire:
                launch[f"headline-{'dsgd' if sec == 'gossip' else 'fedavg'}"
                       f"-model1-wire-bf16"] = got
            del tr
            gc.collect()
            torch.cuda.empty_cache()
        rel = max_rel(res[None][0], res["bfloat16"][0])
        base_rate = g_rate if cls is GossipTrainer else f_rate
        print(f"14d {label}: bf16 wire {res['bfloat16'][1]:.4f} against f32 "
              f"wire {res[None][1]:.4f} rounds/s "
              f"({res['bfloat16'][1] / res[None][1]:.4f}x; phase 5's fused "
              f"headline {base_rate:.4f}); "
              f"{'theta' if cls is FederatedTrainer else 'params'} max-rel "
              f"distance from the f32 wire after round 0 {rel:.3e}; {smi}")
        if not (rel > 0 and math.isfinite(rel)):
            fail(f"14d {label}: the bf16 wire moved params by {rel}")

    # -- 14e. the compressors at their largest site: baseline5 (32
    # workers, ResNet-18, 62 tensors), choco rand-k 0.01, bf16 compute,
    # one round with no eval.
    b5 = get_preset("baseline5")
    b5c = choco(b5.replace(model=rep(b5.model, compute_dtype="bfloat16")),
                "randk", ratio=0.01)
    tr, got, walls, peak, mix_s = run14("14e baseline5 choco randk 0.01, "
                                        "bf16 compute (round 1)",
                                        GossipTrainer, b5c, 1, skip_eval=True)
    launch["baseline5-choco-randk"] = got
    print(f"14e baseline5 choco: round {walls[0]:.3f} s, exchange "
          f"{mix_s[0]:.3f} s = {100 * mix_s[0] / walls[0]:.1f}% of it; peak "
          f"{peak} B; {smi}")
    x_shapes = {k: tuple(v.shape) for k, v in tr.x_hat.items()}
    del tr
    gc.collect()
    torch.cuda.empty_cache()

    # -- 14f. the compressors' pieces, CUDA-event medians of cold-L2
    # calls, at 14a's and 14e's shapes, each beside its bytes bound.
    def time_calls(fn, reps) -> float:
        fn()
        evs = []
        for _ in range(reps):
            kit.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            evs.append((a, b))
        torch.cuda.synchronize()
        return float(np.median([a.elapsed_time(b) for a, b in evs]))

    rows14 = {}
    for site, leaf_shapes, inp, reps in (
            ("model1 W=6", {k: (6, *s) for k, s in shapes.items()},
             (28, 28, 1), 11),
            ("resnet18 W=32", x_shapes, (32, 32, 3), 3)):
        g = torch.Generator(device=dev).manual_seed(5)
        x = {k: torch.randn(*s, device=dev, generator=g)
             for k, s in leaf_shapes.items()}
        order = C.device_order(dopt_flat_order(
            {k: s[1:] for k, s in leaf_shapes.items()}, input_shape=inp),
            dev)
        elems = sum(v.numel() for v in x.values())
        ratio = 0.1 if site.startswith("model1") else 0.01
        names = sorted(x)
        scores = [prng.uniform(prng.fold_in(key_g, i), (s[0], math.prod(
            s[1:]))) for i, s in enumerate(leaf_shapes[k] for k in names)]
        keeps = [C.top_k_mask(sc, max(math.ceil(ratio * sc.shape[1]), 1))
                 for sc in scores]

        def draw():
            for i, k in enumerate(names):
                s = leaf_shapes[k]
                prng.uniform(prng.fold_in(key_g, i),
                             (s[0], math.prod(s[1:])))

        def select():
            for sc in scores:
                C.top_k_mask(sc, max(math.ceil(ratio * sc.shape[1]), 1))

        def scatter():
            for k, keep in zip(names, keeps):
                maps = order[k]
                m = keep if maps is None else keep.index_select(1, maps[1])
                x[k].reshape(keep.shape) * m.to(torch.float32) * 10.0

        pieces = {
            "uniform": (draw, 4 * elems),
            "rand_k select": (select, 5 * elems),
            "rand_k scatter": (scatter, 9 * elems),
            "rand_k_compress": (lambda: C.rand_k_compress(
                x, ratio, key_g, order=order), 8 * elems),
            "top_k_compress": (lambda: C.top_k_compress(
                x, ratio, order=order), 8 * elems),
            "qsgd_compress": (lambda: C.qsgd_compress(
                x, ratio, key_g, levels=16, order=order), 8 * elems)}
        for piece, (fn, nbytes) in pieces.items():
            ms = time_calls(fn, reps)
            bound = 1e3 * nbytes / MEM_BYTES_PER_S
            rows14[f"{site} {piece}"] = (ms, bound)
            print(f"14f {piece} at {site} ({elems} f32 elements, ratio "
                  f"{ratio}): {ms:.3f} ms (median of {reps} cold-L2 calls), "
                  f"bytes bound {bound:.3f} ms ({nbytes} B at 3.35 TB/s; "
                  f"{100 * bound / ms:.1f}% of it); {smi}")
        del x, scores, keeps, order
        gc.collect()
        torch.cuda.empty_cache()
    print(f"14: phase 14 in {time.perf_counter() - t14:.1f} s")
    return {"launch": launch, "rows": rows14, "f32wire": f32wire}


def phase15(dev, smi: str, get_preset, kit, ckdir: Path) -> dict:
    """Phase 15, the scatter path, the shift path and the bucket codec on
    the card: f32 under the deterministic mode unless said.  ``kit`` holds
    phase 3's ``flush`` buffer and phase 14d's f32-wire runs of both
    headlines (``f32wire``: rate, History rows and params), which 15a and
    15d are held against; ``ckdir`` takes 15g's checkpoint.  Returns each
    path's launch counts (``launch``) for the kernels line."""
    import collections

    import numpy as np
    import torch
    import torch.distributed as dist

    from dopt_torch.analysis.comm_bytes import lossy_budget_bytes, plan_bytes
    from dopt_torch.config import CommConfig
    from dopt_torch.engine import FederatedTrainer, GossipTrainer
    from dopt_torch.models.zoo import param_shapes
    from dopt_torch.ops import compression as C
    from dopt_torch.ops.fused_update import (MAX_TENSORS, fused_mix_sgd,
                                             fused_sgd_momentum,
                                             launch_counts)
    from dopt_torch.parallel import collectives as P
    from dopt_torch.parallel.mesh import (WorkerGroup, init_file_group,
                                          meter_by_kind)
    from dopt_torch.topology import (build_mixing_matrices, coeffs_for_matrix,
                                     schedule_shift_decomposition)
    from dopt_torch.utils import prng

    t15 = time.perf_counter()
    rep = dataclasses.replace
    head = get_preset("headline-dsgd-model1")
    fhead = get_preset("headline-fedavg-model1")
    round0_only = 10 ** 9
    launch: dict[str, dict] = {}
    n = 2

    def scatter(base, comm=None, **g):
        """``base`` with the scatter path, kernel 1 on and the fused
        epilogue off (dopt refuses it with scatter)."""
        return base.replace(
            optim=rep(base.optim, fused_update=True), comm=comm,
            gossip=rep(base.gossip, fused_update="off",
                       update_sharding="scatter", **g))

    def full_state(tr) -> dict:
        out = state(tr)
        out["comm_residual"] = {str(i): r.cpu().numpy().copy()
                                for i, r in enumerate(tr._comm_res)}
        return out

    def run15(label, cls, cfg, n, *, block=1, tr=None, skip_eval=False,
              first=None):
        """A fresh trainer (or ``tr``) runs n rounds, per-round (each
        timed alone, the codec exchange timed inside it) or in one
        blocked call, eval in round 0 only (none with ``skip_eval``: the
        run starts at round 1).  The counts are set to 0 just before the
        run and read just after; kernel 1 must launch every step and
        kernel 2 never; the peak is over what was allocated before the
        trainer.  ``first`` (a dict) takes the state after the first
        per-round round, outside the timed walls."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        t = time.perf_counter()
        if tr is None:
            tr = (GossipTrainer(cfg, device=dev, eval_every=round0_only)
                  if cls is GossipTrainer else cls(cfg, device=dev))
            if skip_eval:
                tr.round = 1
        built = time.perf_counter() - t
        mix_s: list[float] = []
        if block == 1 and getattr(tr, "_codec_on", False):
            mix = tr._codec_mix

            def timed_mix(*a):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = mix(*a)
                torch.cuda.synchronize()
                mix_s.append(time.perf_counter() - t)
                return out
            tr._codec_mix = timed_mix
        fused_sgd_momentum.launches = 0
        fused_mix_sgd.launches = 0
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(n if block == 1 else 1):
            torch.cuda.synchronize()
            t = time.perf_counter()
            tr.run(rounds=1 if block == 1 else n, block=block)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            if first is not None and not first:
                first.update(state(tr))
        got = launch_counts()
        tr.__dict__.pop("_codec_mix", None)
        peak = torch.cuda.max_memory_allocated() - base
        for row in tr.history.rows:
            if not all(math.isfinite(v) for k, v in row.items()
                       if k.endswith("loss")):
                fail(f"15 {label}: non-finite loss in {row}")
        tensors = len(getattr(tr, "_names", None) or tr.params)
        want = {"fused_sgd_momentum": n * tr.steps_per_round
                * -(-tensors // MAX_TENSORS), "fused_mix_sgd": 0}
        if got != want:
            fail(f"15 {label}: launches {got}, expected {want} (kernel 1 "
                 "every step, kernel 2 never)")
        print(f"15 {label}: built in {built:.2f} s; walls "
              f"{[round(w, 4) for w in walls]} s; {n / sum(walls):.4f} "
              f"rounds/s; codec exchange {[round(s, 4) for s in mix_s]} s "
              f"a round; peak {peak} B over what was allocated before; "
              f"launches {got}; {smi}")
        return tr, got, walls, peak, mix_s

    def bounded(label, want_rows, want_params, tr, keys, acc,
                rounds=n) -> float:
        """The multi-round History bound (slice 1: LOSS_TOL, ACC_TOL) and
        the params' max-relative distance after the run, printed: over
        a full-width round's 316 steps a reassociated sum grows past
        PARAM_REL_TOL (the one-mix checks hold the paths themselves)."""
        for ra, rb in zip(want_rows, tr.history.rows, strict=True):
            for k in keys:
                if k in ra and abs(ra[k] - rb[k]) > LOSS_TOL:
                    fail(f"{label}: {k} {ra[k]} vs {rb[k]}")
            if acc in ra and abs(ra[acc] - rb[acc]) > ACC_TOL:
                fail(f"{label}: {acc} {ra[acc]} vs {rb[acc]}")
        got = (tr.global_params() if isinstance(tr, FederatedTrainer)
               else tr.worker_params())
        rel = max_rel(want_params, got)
        if not math.isfinite(rel):
            fail(f"{label}: params distance {rel}")
        print(f"{label}: History within {LOSS_TOL}/{ACC_TOL}; params "
              f"max-rel distance {rel:.3e} after {rounds} full-width "
              "rounds")
        return rel

    def one_mix(label, want, got) -> None:
        """One mix of the same inputs on the card, two paths: within
        1e-6 relative (f32 sums in another order)."""
        rel = max(float((got[k].float() - v.float()).abs().max()
                        / v.float().abs().max().clamp_min(1e-12))
                  for k, v in want.items())
        if not rel <= 1e-6:
            fail(f"{label}: one mix differs by {rel:.3e} (limit 1e-6)")
        print(f"{label}: one mix on the card within {rel:.3e} relative "
              "(limit 1e-6)")

    gen = torch.Generator(device=dev).manual_seed(15)
    x6 = {k: torch.randn(6, *s, device=dev, generator=gen)
          for k, s in param_shapes("model1").items()}
    w6 = torch.from_numpy(build_mixing_matrices(
        "circle", "stochastic", 6, seed=head.seed).for_round(0).astype(
            np.float32)).to(dev)
    spec6 = P.make_update_shard_spec(x6)
    ids6 = schedule_shift_decomposition(build_mixing_matrices(
        "circle", "stochastic", 6, seed=head.seed))
    c6 = torch.from_numpy(coeffs_for_matrix(w6.cpu().numpy(), ids6)).to(dev)
    dense6 = P.mix_dense(x6, w6)
    one_mix("15a scatter against the dense mix", dense6,
            P.mix_update_scatter(x6, w6, None, spec6))
    one_mix(f"15c scatter over shifts {ids6} against the dense mix", dense6,
            P.mix_update_scatter(x6, c6, None, spec6, shift_ids=ids6))
    x16 = {k: torch.randn(16, *s, device=dev, generator=gen)
           for k, s in param_shapes("model1").items()}
    m16 = (torch.arange(16, device=dev) % 2 == 0).float()
    one_mix("15d scatter mean against the dense masked mean",
            P.masked_average(x16, m16), P.masked_average_scatter(
                x16, m16, None, P.make_update_shard_spec(x16)))
    del x6, x16, dense6

    def time_calls(fn, reps) -> float:
        """CUDA-event median of ``reps`` cold-L2 calls (phase 14f's)."""
        fn()
        evs = []
        for _ in range(reps):
            kit.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            evs.append((a, b))
        torch.cuda.synchronize()
        return float(np.median([a.elapsed_time(b) for a, b in evs]))

    gkeys = ("avg_train_loss", "avg_test_loss")
    fkeys = ("test_loss", "train_loss", "local_loss")
    g14, f14 = kit.f32wire["gossip"], kit.f32wire["federated"]

    # -- 15a. scatter on the gossip headline: 2 buckets, per-round and
    # blocked, held against 14d's dense unfused f32 run.
    a_cfg = scatter(head)
    a_first: dict = {}
    tr, got, walls, peak, _ = run15("15a headline scatter", GossipTrainer,
                                    a_cfg, n, first=a_first)
    widths = [b - a for a, b in zip(tr.scatter_spec.bounds,
                                    tr.scatter_spec.bounds[1:])]
    if widths != [1_048_576, 614_794]:
        fail(f"15a: buckets {widths}, expected [1048576, 614794]")
    launch["headline-dsgd-model1-scatter"] = got
    a_rate = n / sum(walls)
    bounded("15a scatter against 14d's dense unfused f32 run", g14["rows"],
            g14["params"], tr, gkeys, "avg_test_acc")
    print(f"15a scatter: {a_rate:.4f} rounds/s against 14d's dense f32 wire "
          f"{g14['rate']:.4f} ({a_rate / g14['rate']:.4f}x); buckets "
          f"{widths}; peak {peak} B; {smi}")
    a_state = state(tr)
    del tr
    tr, got_b, walls_b, _, _ = run15("15a headline scatter, blocks of 2",
                                     GossipTrainer, a_cfg, n, block=2)
    same_state("15a scatter blocked, against per-round", a_state, state(tr))
    if got_b != got:
        fail(f"15a blocked launches {got_b} != per-round {got}")
    print(f"15a blocked graphs {tr.graphs.captures}; "
          f"{n / sum(walls_b):.4f} rounds/s")
    del tr
    gc.collect()
    torch.cuda.empty_cache()

    # -- 15b. the bucket codec on the headline: q8 with no budget, and
    # the lossy-link budget of 6 workers (unreachable: q4 everywhere).
    dense = 4 * 1_663_370
    budget = lossy_budget_bytes(dense, 6)
    codec_cfgs = {
        "q8": scatter(head, CommConfig(codec="qsgd")),
        "q4": scatter(head, CommConfig(codec="qsgd",
                                       byte_budget_mb=budget / (1 << 20)))}
    b_res = {}
    for name, cfg in codec_cfgs.items():
        # q4 one round (cut from 2 for the budget); 15g holds q8's two.
        tr, got, walls, peak, mix_s = run15(f"15b codec {name}",
                                            GossipTrainer, cfg,
                                            n if name == "q8" else 1)
        plan = tr.codec_plan
        if plan.kinds != (name, name):
            fail(f"15b {name}: plan {plan.kinds}")
        pb = plan_bytes(plan, tr.scatter_spec)
        launch[f"headline-dsgd-model1-scatter-{name}"] = got
        rate = len(walls) / sum(walls)
        share = 100 * sum(mix_s) / sum(walls)
        print(f"15b codec {name}: plan {pb['kinds']}, {pb['wire_bytes']} "
              f"wire B a lane a round against {pb['dense_bytes']} dense "
              f"({pb['compression']:.2f}x; budget "
              f"{budget if name == 'q4' else 'none'} B); exchange "
              f"{[round(s, 4) for s in mix_s]} s a round = {share:.2f}% of "
              f"the walls; {rate:.4f} rounds/s against 15a's {a_rate:.4f}; "
              "on one GPU no byte crosses a wire; " + smi)
        b_res[name] = (full_state(tr), got, rate, share)
        del tr
        gc.collect()
        torch.cuda.empty_cache()

    # -- 15c. the explicit shift path with scatter, one round (cut from 2
    # for the budget), against 15a's round 0.
    tr, got, walls, peak, _ = run15("15c headline scatter + shift",
                                    GossipTrainer,
                                    scatter(head, comm_impl="shift"), 1)
    if tr._shift_ids is None:
        fail("15c: comm_impl='shift' did not take the shift path")
    launch["headline-dsgd-model1-scatter-shift"] = got
    bounded(f"15c shift {tr._shift_ids} against 15a's round 0",
            a_first["rows"], a_first["params"], tr, gkeys, "avg_test_acc",
            rounds=1)
    print(f"15c shift: {1 / sum(walls):.4f} rounds/s against 15a's "
          f"{a_rate:.4f}; {smi}")
    del tr, a_state, a_first
    gc.collect()
    torch.cuda.empty_cache()

    # -- 15d. the federated headline at full width with the scatter
    # reduce, f32 and with comm.wire_dtype bfloat16.
    fs = fhead.replace(federated=rep(fhead.federated, fused_update="off",
                                     compact=False,
                                     update_sharding="scatter"))
    for wire in (None, "bfloat16"):
        cfg = fs.replace(comm=None if wire is None
                         else CommConfig(wire_dtype=wire))
        # One round each (cut from 2 for the budget): the f32 wire held
        # against 14d's one-round f32 run, the bf16 wire's rate.
        tr, got, walls, peak, _ = run15(
            f"15d fedavg headline scatter, wire {wire or 'float32'}",
            FederatedTrainer, cfg, 1)
        if tr._use_compact():
            fail("15d: the federated scatter run left the full width")
        launch["headline-fedavg-model1-scatter"
               + ("" if wire is None else "-wire-bf16")] = got
        rate = len(walls) / sum(walls)
        if wire is None:
            bounded("15d fedavg scatter against 14d's f32 run", f14["rows"],
                    f14["params"], tr, fkeys, "test_acc", rounds=1)
        print(f"15d fedavg scatter wire {wire or 'float32'}: {rate:.4f} "
              f"rounds/s against 14d's f32 wire {f14['rate']:.4f} "
              f"({rate / f14['rate']:.4f}x); peak {peak} B; {smi}")
        del tr
        gc.collect()
        torch.cuda.empty_cache()

    # -- 15e. the codec at its largest site: baseline5 (32 workers,
    # ResNet-18, 11 buckets), q8, bf16 compute, one round with no eval.
    b5 = get_preset("baseline5")
    b5c = scatter(b5.replace(model=rep(b5.model, compute_dtype="bfloat16")),
                  CommConfig(codec="qsgd"))
    tr, got, walls, peak, mix_s = run15("15e baseline5 scatter q8, bf16 "
                                        "compute (round 1)", GossipTrainer,
                                        b5c, 1, skip_eval=True)
    e_widths = [b - a for a, b in zip(tr.scatter_spec.bounds,
                                      tr.scatter_spec.bounds[1:])]
    if e_widths != [1_048_576] * 10 + [688_202]:
        fail(f"15e: buckets {e_widths}")
    launch["baseline5-scatter-q8"] = got
    res_bytes = sum(r.numel() * 4 for r in tr._comm_res)
    pb = plan_bytes(tr.codec_plan, tr.scatter_spec)
    print(f"15e baseline5 codec: round {walls[0]:.3f} s, exchange "
          f"{mix_s[0]:.3f} s = {100 * mix_s[0] / walls[0]:.1f}% of it; "
          f"{len(e_widths)} buckets x {tr.num_workers} lanes = "
          f"{tr.num_workers * sum(e_widths)} "
          f"entries; residuals {res_bytes} B; plan {pb['wire_bytes']} B a "
          f"lane against {pb['dense_bytes']} ({pb['compression']:.2f}x); "
          f"peak {peak} B; {smi}")
    del tr
    gc.collect()
    torch.cuda.empty_cache()

    # -- 15f. the collectives alone: a world-size-1 NCCL group issues
    # every collective, equal to the group-None forms bit for bit; the
    # codec pieces timed against their bytes bound.
    wg = init_file_group(ckdir, 0, 1, backend="nccl", num_workers=6)
    try:
        gen = torch.Generator(device=dev).manual_seed(15)
        for site, lanes, wd in (("15b", 6, (1_048_576, 614_794)),
                                ("15e", 32, (1_048_576, 688_202))):
            meter = collections.Counter()
            wgs = WorkerGroup(size=1, rank=0, lanes=lanes, group=wg.group,
                              meter=meter)
            bk = [torch.randn(lanes, x, device=dev, generator=gen)
                  for x in wd]
            res = [0.01 * torch.randn_like(b) for b in bk]
            w = torch.rand(lanes, lanes, device=dev, generator=gen)
            w = w / w.sum(1, keepdim=True)
            mask = (torch.arange(lanes, device=dev) % 3 != 1).float()
            mix = build_mixing_matrices("circle", "stochastic", lanes)
            ids = schedule_shift_decomposition(mix)
            coeffs = torch.from_numpy(coeffs_for_matrix(
                mix.for_round(0).astype(np.float32), ids)).to(dev)
            spec = P.make_update_shard_spec({"x": torch.cat(bk, 1)},
                                            bucket_bytes=4 << 20)
            tree = {"x": torch.cat(bk, 1)}
            plan = P.BucketCodecPlan(kinds=("q8", "q4"), chunk=1024,
                                     dense_bytes=0, wire_bytes=0)
            key = prng.fold_in(prng.jax_key(head.seed ^ 0xC0DEC,
                                            device=dev), 1)
            pairs = {
                "mix_dense_scatter": (
                    P.mix_dense_scatter(bk, w, wgs),
                    P.mix_dense_scatter(bk, w, None)),
                "mix_dense_scatter bf16": (
                    P.mix_dense_scatter(bk, w, wgs, torch.bfloat16),
                    P.mix_dense_scatter(bk, w, None, torch.bfloat16)),
                "masked_average_scatter": (
                    list(P.masked_average_scatter(
                        tree, mask, wgs, spec).values()),
                    list(P.masked_average_scatter(
                        tree, mask, None, spec).values())),
                "mix_shifts": (P.mix_shifts(bk, ids, coeffs, wgs),
                               P.mix_shifts(bk, ids, coeffs, None)),
                "mix_codec_gather": tuple(
                    [*m, *r] for m, r in (
                        P.mix_codec_gather(bk, res, w, wgs, plan, key),
                        P.mix_codec_gather(bk, res, w, None, plan,
                                           key)))}
            for name, (a, b) in pairs.items():
                for x, y in zip(a, b, strict=True):
                    if not torch.equal(x, y):
                        fail(f"15f {site} {name}: the NCCL group's result "
                             "differs from the group-None form")
            print(f"15f {site} ({lanes} lanes, buckets {list(wd)}): "
                  f"{', '.join(pairs)} on a world-size-1 NCCL group equal "
                  f"the group-None forms bit for bit; bytes handed to "
                  f"torch.distributed {dict(sorted(meter_by_kind(meter).items()))}")
            # The card's encodes against the CPU's on two lanes.
            v = bk[0][:2] + res[0][:2]
            for bits in (8, 4):
                pg, sg = C.qint_encode(v, torch.arange(2, device=dev), key,
                                       bits=bits)
                pc, sc = C.qint_encode(v.cpu(), torch.arange(2), key.cpu(),
                                       bits=bits)
                if not (torch.equal(pg.cpu(), pc)
                        and torch.equal(sg.cpu(), sc)):
                    fail(f"15f {site}: the card's q{bits} encode differs "
                         "from the CPU's")
            print(f"15f {site}: the card's q8 and q4 encodes of two lanes "
                  "equal the CPU's bit for bit")
            for b, e in zip(bk, res):
                elems = b.numel()
                ids_ = torch.arange(lanes, device=dev)
                nc = -(-b.shape[1] // 1024)
                for bits in (8, 4):
                    payload, scale = C.qint_encode(b + e, ids_, key,
                                                   bits=bits)
                    pieces = {
                        "draw": (lambda: prng.uniform_many(
                            C.lane_fold_keys(key, ids_), (nc, 1024)),
                            4 * lanes * nc * 1024),
                        "qint_encode": (lambda: C.qint_encode(
                            b, ids_, key, bits=bits),
                            elems * (4 + bits / 8) + 4 * lanes * nc),
                        "qint_decode": (lambda: C.qint_decode(
                            payload, scale, b.shape[1], bits=bits),
                            elems * (4 + bits / 8) + 4 * lanes * nc)}
                    for piece, (fn, nbytes) in pieces.items():
                        if piece == "draw" and bits == 4:
                            continue
                        ms = time_calls(fn, 5)
                        bound = 1e3 * nbytes / MEM_BYTES_PER_S
                        print(f"15f {site} {piece}"
                              f"{'' if piece == 'draw' else f' q{bits}'} at "
                              f"[{lanes}, {b.shape[1]}]: {ms:.3f} ms (median "
                              f"of 5 cold-L2 calls), bytes bound "
                              f"{bound:.3f} ms ({int(nbytes)} B at 3.35 "
                              f"TB/s; {100 * bound / ms:.1f}% of it); {smi}")
            del bk, res, pairs
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    # -- 15g. the codec headline: blocked and killed-and-resumed against
    # 15b's per-round q8 run, bit for bit, residuals included.
    want, want_launch = b_res["q8"][0], b_res["q8"][1]
    tr, got, _, _, _ = run15("15g codec q8, blocks of 2", GossipTrainer,
                             codec_cfgs["q8"], n, block=2)
    same_state("15g codec q8 blocked, against 15b", want, full_state(tr))
    if got != want_launch:
        fail(f"15g blocked launches {got} != {want_launch}")
    del tr
    fused_sgd_momentum.launches = 0
    fused_mix_sgd.launches = 0
    victim = GossipTrainer(codec_cfgs["q8"], device=dev,
                           eval_every=round0_only)
    victim.run(rounds=1, checkpoint_every=1, checkpoint_path=ckdir / "codec")
    del victim
    resumed = GossipTrainer(codec_cfgs["q8"], device=dev,
                            eval_every=round0_only)
    resumed.restore(ckdir / "codec")
    resumed.run(rounds=1)
    torch.cuda.synchronize()
    same_state("15g codec q8 killed after round 0 and resumed, against 15b",
               want, full_state(resumed))
    if launch_counts() != want_launch:
        fail(f"15g resume: launches {launch_counts()} != {want_launch}")
    del resumed, b_res
    gc.collect()
    torch.cuda.empty_cache()
    print(f"15: phase 15 in {time.perf_counter() - t15:.1f} s")
    return {"launch": launch}


def phase16(dev, smi: str, get_preset, ckdir: Path) -> dict:
    """Phase 16, the client population on the card: f32 under the
    deterministic mode, kernel 1 on, the fused epilogue off (dopt
    refuses it in population mode).  No kernel is timed alone: the
    kernels line takes phase 3's federated and gossip sites, whose
    shapes these paths give kernel 1.  ``ckdir`` takes 16b's checkpoint.
    Returns each path's launch counts (``launch``) for the kernels
    line."""
    import numpy as np
    import torch

    from dopt_torch.config import FaultConfig, PopulationConfig, RobustConfig
    from dopt_torch.data import PrefetchStager, ready
    from dopt_torch.engine import FederatedTrainer, GossipTrainer
    from dopt_torch.ops.fused_update import (MAX_TENSORS, fused_mix_sgd,
                                             fused_sgd_momentum,
                                             launch_counts)
    from dopt_torch.population import ClientRegistry

    t16 = time.perf_counter()
    rep = dataclasses.replace
    launch: dict[str, dict] = {}
    n = 2
    xc = get_preset("baseline3-xclients")
    xc = xc.replace(optim=rep(xc.optim, fused_update=True))

    def pop_state(tr) -> dict:
        """What a population run leaves behind, as host values: theta,
        the History rows, the ledger (content and order) and the
        registry's state."""
        return {"theta": {k: v.copy() for k, v in
                          tr.global_params().items()},
                "rows": [dict(r) for r in tr.history.rows],
                "ledger": [dict(r) for r in tr.history.faults],
                "registry": [tr._registry.state_dict()]}

    def k1_per_round(tr) -> int:
        tensors = len(tr.params) if hasattr(tr, "params") else len(tr._names)
        waves = tr._registry.waves if isinstance(tr, FederatedTrainer) else 1
        return waves * tr.steps_per_round * -(-tensors // MAX_TENSORS)

    def check_launches(label, tr, rounds) -> dict:
        got = launch_counts()
        want = {"fused_sgd_momentum": rounds * k1_per_round(tr),
                "fused_mix_sgd": 0}
        if got != want:
            fail(f"16 {label}: launches {got}, expected {want} (kernel 1 "
                 "every step of every wave, kernel 2 never)")
        return got

    # -- 16a. baseline3-xclients at full width: 1,000 clients, cohort 64,
    # 16 lanes, 4 waves of 375 steps of Model1, 2 per-round rounds.
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t = time.perf_counter()
    tr = FederatedTrainer(xc, device=dev)
    built = time.perf_counter() - t
    reg = tr._registry
    if (reg.clients, reg.cohort_size, reg.lanes, reg.waves) != (1000, 64,
                                                                16, 4):
        fail(f"16a: registry {reg.clients}/{reg.cohort_size}/{reg.lanes}/"
             f"{reg.waves}, expected 1000/64/16/4")
    fused_sgd_momentum.launches = 0
    fused_mix_sgd.launches = 0
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for r in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        tr.run(rounds=1)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        if r == 0:
            tr.save(ckdir / "pop")   # for 16b, outside the timed round
    got = check_launches("16a baseline3-xclients", tr, n)
    if got["fused_sgd_momentum"] != 3000:
        fail(f"16a: kernel 1 launched {got['fused_sgd_momentum']} times, "
             "expected 3,000 (2 rounds x 4 waves x 375 steps)")
    launch["baseline3-xclients"] = got
    peak = torch.cuda.max_memory_allocated() - base
    for row in tr.history.rows:
        if not all(math.isfinite(v) for v in row.values()):
            fail(f"16a: non-finite History row {row}")
        if row["cohort"] != 64 or row["population"] != 1000:
            fail(f"16a: row {row} is not a full cohort of 64 of 1000")
    cohort_rows = [r for r in tr.history.faults if r["kind"] == "cohort"]
    if len(cohort_rows) != n or len(tr.history.faults) != n:
        fail(f"16a: ledger {tr.history.faults}, expected one cohort row a "
             "round")
    want = pop_state(tr)
    rate = n / sum(walls)
    print(f"16a baseline3-xclients (1,000 clients, cohort 64, 16 lanes, 4 "
          f"waves, Model1 f32): built in {built:.2f} s; round walls "
          f"{[round(w, 3) for w in walls]} s; {rate:.4f} rounds/s; peak "
          f"{peak} B over what was allocated before; launches {got}; "
          f"{smi}")
    print(f"16a cohort rows {cohort_rows}")
    print(f"16a History {tr.history.rows}")
    print(f"16a timers: {tr.timers.report()}")
    del tr
    gc.collect()
    torch.cuda.empty_cache()

    # -- 16b. prefetch on and resumed: a fresh trainer with prefetch on
    # restores 16a's checkpoint of round 0 and runs round 1, bit for bit
    # 16a; then round 2's inputs staged on the stager's thread (the side
    # stream's upload) equal the inline build.
    pcfg = xc.replace(federated=rep(xc.federated, prefetch="on"))
    fused_sgd_momentum.launches = 0
    fused_mix_sgd.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    resumed = FederatedTrainer(pcfg, device=dev)
    resumed.restore(ckdir / "pop")
    if resumed.round != 1:
        fail(f"16b: resumed at round {resumed.round}")
    resumed.run(rounds=1)
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t
    same_state("16b prefetch on, restored from 16a's round-0 checkpoint, "
               "round 1, against 16a", want, pop_state(resumed))
    got_b = launch_counts()
    if got_b != {"fused_sgd_momentum": k1_per_round(resumed),
                 "fused_mix_sgd": 0}:
        fail(f"16b: launches {got_b} for one round")
    stager = PrefetchStager()
    stager.stage(2, resumed._build_pop_round, resumed._draw_pop_round(2))
    staged = ready(*stager.take(2)["dev"])
    inline = ready(*resumed._build_pop_round(
        resumed._draw_pop_round(2))["dev"])
    for k, v in inline.items():
        if not torch.equal(v, staged[k]):
            fail(f"16b: round 2's staged {k} differs from the inline build")
    print(f"16b: {wall_b:.2f} s for the restore and round 1; round 2's "
          f"staged inputs ({', '.join(sorted(inline))}) equal the inline "
          f"build; launches {got_b}; {smi}")
    del resumed, staged, inline
    gc.collect()
    torch.cuda.empty_cache()

    # -- 16c. the ledger against the host: a registry alone (no trainer)
    # draws 16a's cohorts.
    host = ClientRegistry(xc.population, num_shards=xc.data.num_users,
                          seed=xc.seed)
    rows = []
    for t in range(n):
        cohort = host.sample_cohort(t)
        b = host.bind(t, cohort, cohort)
        host.record_participation(t, b.survivors)
        host.apply_screen_feedback(t, b.survivors,
                                   np.zeros(len(b.survivors)), rows)
        rows.append(b.ledger_row(host.clients))
        if not (rows[-1]["action"].startswith("sampled_64_of_1000_")
                and rows[-1]["action"].endswith("_waves_4")):
            fail(f"16c: host row {rows[-1]}")
    if rows != want["ledger"] or [host.state_dict()] != want["registry"]:
        fail(f"16c: the host registry's rows {rows} or state differ from "
             f"16a's {want['ledger']}")
    print(f"16c: a host-only ClientRegistry draws 16a's cohorts: digests "
          f"{[r['action'].split('_digest_')[1][:8] for r in rows]}; the "
          "registry state equal")

    # -- 16d. a faulted population round at cohort 16 (one wave): crash,
    # over-selection, nan liars caught by the screen and quarantined,
    # churn; then a second round that must not sample them.
    fcfg = xc.replace(
        population=PopulationConfig(clients=1000, cohort=16),
        faults=FaultConfig(crash=0.1, over_select=0.5, corrupt=0.25,
                           corrupt_mode="nan", churn=0.05, churn_span=2),
        robust=RobustConfig(quarantine_after=1, quarantine_rounds=3))
    fused_sgd_momentum.launches = 0
    fused_mix_sgd.launches = 0
    tr = FederatedTrainer(fcfg, device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    tr.run(rounds=1)
    reg = tr._registry
    benched = np.nonzero(reg.quarantine_until > 1)[0]
    tr.run(rounds=1)
    torch.cuda.synchronize()
    wall_d = time.perf_counter() - t
    got_d = check_launches("16d faulted cohort 16", tr, n)
    if not len(benched):
        fail("16d: no liar was screened and quarantined in round 0")
    if (reg.last_sampled[benched] == 1).any():
        fail(f"16d: quarantined clients {benched} were sampled in round 1")
    for row in tr.history.rows:
        if not all(math.isfinite(v) for v in row.values()):
            fail(f"16d: non-finite History row {row}")
    # The host recomputation: the chain and the screen on the CPU side
    # alone — a nan lie is always screened.
    hostf = FederatedTrainer(fcfg, device="cpu")
    ledger = []
    for t in range(n):
        b, _, _, r = hostf._cohort_participation(t)
        hostf._registry.record_participation(t, b.survivors)
        rf = hostf._registry.faults.for_round(t)
        flags = rf.corrupt[b.survivors].astype(np.float32)
        hostf._registry.apply_screen_feedback(t, b.survivors, flags, r)
        ledger += r
    if ledger != tr.history.faults:
        fail(f"16d: ledger {tr.history.faults} != the host's {ledger}")
    if hostf._registry.state_dict() != reg.state_dict():
        fail("16d: the registry differs from the host's")
    kinds = sorted({r["kind"] for r in ledger})
    print(f"16d faulted cohort 16: {wall_d:.2f} s for 2 rounds; ledger of "
          f"{len(ledger)} rows ({kinds}) equal to the host's; quarantined "
          f"after round 0: {benched.tolist()}, none sampled in round 1; "
          f"cohorts {[r['cohort'] for r in tr.history.rows]}; launches "
          f"{got_d}; {smi}")
    del tr, hostf
    gc.collect()
    torch.cuda.empty_cache()

    # -- 16e. the gossip binding on the gossip headline (fused epilogue
    # off): 600 clients, cohorts of 6, per-round against one block of 2.
    head = get_preset("headline-dsgd-model1")
    gcfg = head.replace(
        optim=rep(head.optim, fused_update=True),
        gossip=rep(head.gossip, fused_update="off"),
        population=PopulationConfig(clients=600, cohort=6))
    g_res = {}
    for block in (1, 2):
        fused_sgd_momentum.launches = 0
        fused_mix_sgd.launches = 0
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        tr = GossipTrainer(gcfg, device=dev, eval_every=10 ** 9)
        walls = []
        for _ in range(n if block == 1 else 1):
            torch.cuda.synchronize()
            t = time.perf_counter()
            tr.run(rounds=1 if block == 1 else n, block=block)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        got = check_launches(f"16e gossip population block {block}", tr, n)
        peak = torch.cuda.max_memory_allocated() - base
        s = state(tr)
        s["ledger"] = [dict(r) for r in tr.history.faults]
        s["registry"] = [tr._registry.state_dict()]
        g_res[block] = s
        print(f"16e headline-dsgd-model1 + population 600/6, block {block}: "
              f"walls {[round(w, 3) for w in walls]} s; "
              f"{n / sum(walls):.4f} rounds/s; peak {peak} B; launches "
              f"{got}; graphs {tr.graphs.captures}; cohort rows "
              f"{s['ledger']}; {smi}")
        launch["headline-dsgd-model1-population"] = got
        del tr
        gc.collect()
        torch.cuda.empty_cache()
    same_state("16e gossip population blocked, against per-round", g_res[1],
               g_res[2])
    del g_res

    # -- 16f. the host side at dopt's scale flag (--clients 10000 --cohort
    # 256, 16 lanes): sample, bind and build the 16 wave plans of a round.
    big = xc.replace(population=PopulationConfig(clients=10_000, cohort=256))
    hostb = FederatedTrainer(big, device="cpu")
    draws, builds = [], []
    for t in range(3):
        t0 = time.perf_counter()
        meta = hostb._draw_pop_round(t)
        t1 = time.perf_counter()
        meta = hostb._build_pop_round(meta)
        builds.append(1e3 * (time.perf_counter() - t1))
        draws.append(1e3 * (t1 - t0))
    shape = tuple(meta["dev"][0]["idx"].shape)
    if shape != (16, 16, hostb.steps_per_round, 50):
        fail(f"16f: plans {shape}")
    print(f"16f host side at 10,000 clients, cohort 256, 16 lanes (16 "
          f"waves, plans {shape}): sample + bind "
          f"{[round(x, 2) for x in draws]} ms, the 16 wave plans "
          f"{[round(x, 1) for x in builds]} ms a round (rounds 0-2; median "
          f"{np.median(draws) + np.median(builds):.1f} ms); {smi}")
    del hostb
    gc.collect()
    print(f"16: phase 16 in {time.perf_counter() - t16:.1f} s")
    return {"launch": launch}


def _rel_l2(want, got) -> float:
    import numpy as np

    return float(np.linalg.norm((got - want).ravel())
                 / max(np.linalg.norm(want.ravel()), 1e-30))


def _elem_rel(want, got) -> float:
    """The largest elementwise |got − want| / |want| over want ≠ 0:
    near-zero elements drive it."""
    import numpy as np

    nz = want != 0
    return float((np.abs(got - want)[nz] / np.abs(want[nz])).max()
                 if nz.any() else 0.0)


def _model1_grads_f64(p0: dict, x, y, *, faithful: bool) -> dict:
    """The Model1 fleet's per-tensor gradients of the summed per-worker
    mean cross-entropy, in float64 on the CPU, written out apart from the
    port's forward: the reference the f32 steps are read against."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    w, b, h, wd, c = x.shape
    p = {k: v.double().expand(w, *v.shape).clone().requires_grad_()
         for k, v in p0.items()}

    def conv(z, name):
        k = p[f"{name}.weight"]
        return F.conv2d(z, k.reshape(-1, *k.shape[2:]),
                        p[f"{name}.bias"].reshape(-1),
                        padding=k.shape[-1] // 2, groups=w)

    z = x.double().permute(1, 0, 4, 2, 3).reshape(b, w * c, h, wd)
    for name in ("conv1", "conv2"):
        z = conv(z, name)
        z = F.max_pool2d(z if faithful else F.relu(z), 2)
    z = z.reshape(b, w, -1).transpose(0, 1)                 # [W, B, F]
    z = F.relu(torch.baddbmm(p["fc1.bias"][:, None], z,
                             p["fc1.weight"].transpose(1, 2)))
    z = torch.baddbmm(p["fc2.bias"][:, None], z,
                      p["fc2.weight"].transpose(1, 2))
    if faithful:
        z = torch.softmax(z, -1)
    nll = -torch.log_softmax(z, -1).gather(-1, y[..., None]).squeeze(-1)
    grads = torch.autograd.grad(nll.mean(1).sum(), list(p.values()))
    return {k: g.numpy().astype(np.float64) for k, g in zip(p, grads)}


def conv_ab() -> None:
    """``python3 chip_smoke.py --conv-ab``: the card's rounded training
    layers against the library's f32 ones in one call.  The convs:
    ``_RoundedConv`` (f64 GEMMs rounded once) against the library's f32
    conv on the cells whose training convs it takes — the gossip and
    fedavg Model1 headlines, ``baseline3`` as typed (Model1, compact)
    and ``baseline2`` (Model3) — where no dense layer is rounded (each
    run fails if ``_RoundedLinear`` is called).  The MLP's hidden
    layers: ``_RoundedLinear`` (the f64 ``baddbmm`` rounded once)
    against the library's f32 ``baddbmm`` on ``baseline1`` as typed and
    with both fused switches (phase 21a's cell).  Each cell runs
    library, rounded, rounded, library, each a fresh trainer's 2 rounds
    with its eval (phase 5's rate) and its peak over what was held
    before it; the eval forwards take the library layers in both arms.
    Prints the rates, the peaks and each cell's rounded/library time
    ratio, with the card's name and power limit."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from dopt_torch.engine import FederatedTrainer, GossipTrainer
    from dopt_torch.engine import gossip as gossip_engine
    from dopt_torch.models import zoo
    from dopt_torch.ops import _build
    from dopt_torch.presets import get_preset

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this A/B needs a GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}")
    _build.build()
    _build.load_library()
    gossip_engine.load_dataset = functools.lru_cache(maxsize=4)(
        gossip_engine.load_dataset)
    rounded_conv, rounded_linear = zoo._RoundedConv, zoo._RoundedLinear
    calls = {"library": 0, "rounded": 0, "library linear": 0,
             "rounded linear": 0}

    class LibraryConv:   # _grouped_conv's CUDA arm on the library conv
        Fn = rounded_conv.Fn

        @staticmethod
        def apply(z, w, b, pad, groups):
            calls["library"] += 1
            return F.conv2d(z, w, b, padding=pad, groups=groups)

    class CountedConv:
        Fn = rounded_conv.Fn   # the real apply reads zoo._RoundedConv.Fn

        @staticmethod
        def apply(*args):
            calls["rounded"] += 1
            return rounded_conv.apply(*args)

    class LibraryLinear:   # _mlp_hidden's CUDA arm on the library GEMM
        @staticmethod
        def apply(bias, weight, zt):
            calls["library linear"] += 1
            return torch.baddbmm(bias.unsqueeze(2), weight, zt)

    class CountedLinear:
        @staticmethod
        def apply(*args):
            calls["rounded linear"] += 1
            return rounded_linear.apply(*args)

    # Each arm: (the conv, the dense layer) it patches in.
    arms = {"library": (LibraryConv, CountedLinear),
            "rounded": (CountedConv, CountedLinear),
            "library linear": (CountedConv, LibraryLinear),
            "rounded linear": (CountedConv, CountedLinear)}
    fused = get_preset("baseline1")
    fused = fused.replace(
        gossip=dataclasses.replace(fused.gossip, fused_update="on"),
        optim=dataclasses.replace(fused.optim, fused_update=True))
    cells = (("headline-dsgd-model1", GossipTrainer, "conv"),
             ("headline-fedavg-model1", FederatedTrainer, "conv"),
             ("baseline3", FederatedTrainer, "conv"),
             ("baseline2", GossipTrainer, "conv"),
             ("baseline1", GossipTrainer, "linear"),
             ("baseline1, both fused switches", GossipTrainer, "linear"))

    def once(name, cls, arm):
        zoo._RoundedConv, zoo._RoundedLinear = arms[arm]
        before = dict(calls)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        cfg = fused if name.endswith("switches") else get_preset(name)
        tr = cls(cfg, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        tr.run(rounds=2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated() - held
        ran = {k for k in calls if calls[k] != before[k]}
        if ran != {arm}:
            fail(f"rounding A/B {name}: the {arm} arm ran {ran} ({calls}, "
                 f"before {before})")
        loss = [v for r in tr.history.rows for k, v in r.items()
                if k.endswith("train_loss")]
        if not loss or not np.isfinite(loss).all():
            fail(f"rounding A/B {name} {arm}: train losses {loss}")
        del tr
        print(f"rounding A/B {name} {arm}: 2 rounds in {wall:.3f} s = "
              f"{2 / wall:.4f} rounds/s; peak {peak} B over what was held; "
              f"{smi}", flush=True)
        return wall, peak

    t0 = time.perf_counter()
    for arm in ("library", "rounded"):   # warm both convs once, untimed
        once("baseline2", GossipTrainer, arm)
    try:
        for name, cls, layer in cells:
            lib, rnd = (("library", "rounded") if layer == "conv"
                        else ("library linear", "rounded linear"))
            got = {lib: [], rnd: []}
            for arm in (lib, rnd, rnd, lib):
                got[arm].append(once(name, cls, arm))
            ratio = (sum(w for w, _ in got[rnd])
                     / sum(w for w, _ in got[lib]))
            rates = {a: [round(2 / w, 4) for w, _ in v]
                     for a, v in got.items()}
            peaks = {a: [p for _, p in v] for a, v in got.items()}
            print(f"rounding A/B {name} ({layer}): rounded/library time "
                  f"{ratio:.4f} (rounds/s {rates}; peaks {peaks} B); {smi}",
                  flush=True)
    finally:
        zoo._RoundedConv, zoo._RoundedLinear = rounded_conv, rounded_linear
    print(f"rounding A/B in {time.perf_counter() - t0:.1f} s")


def phase4c(dev, smi: str, get_preset) -> None:
    """Phase 4c, one full-size Model1 step on the card against the port's
    CPU step: ``headline-dsgd-model1``'s model at its real sizes (Model1,
    28×28×1, batch 128 a lane, f32, the faithful head) through the
    engines' ``stacked_step`` with the plain update, under the
    deterministic mode and ``full_f32``, at 6 and at 3 lanes, from one
    init and one batch (the first 128 training samples a lane).  The CPU
    step runs once, at 6 lanes; the 3-lane card step is held against its
    lanes 0-2 (on the CPU the 3-lane step equals them bit for bit,
    tests/test_torch_seqlm.py).  Per tensor, for the gradient (the
    momentum after a first step from zero is the gradient exactly) and
    the updated value: relative L2, held to 1e-5, and the elementwise
    max-rel, printed.  The conv kernels each lane count ran are named
    from the profiler."""
    import contextlib

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dopt_torch.engine import gossip as gossip_engine
    from dopt_torch.engine.local import stacked_step
    from dopt_torch.models.zoo import (deterministic, full_f32,
                                       init_worker_params, stacked_forward)

    t4c = time.perf_counter()
    cfg = get_preset("headline-dsgd-model1")
    mc, d = cfg.model, cfg.data
    lanes, bs = d.num_users, cfg.gossip.local_bs
    # The engines' own call, so the set is the one phase 5 uses (cached).
    ds = gossip_engine.load_dataset(
        d.dataset, data_dir=d.data_dir, train_size=d.synthetic_train_size,
        test_size=d.synthetic_test_size, seed=cfg.seed,
        input_shape=mc.input_shape, num_classes=mc.num_classes)
    x = torch.from_numpy(ds.train_x[:lanes * bs]).view(lanes, bs,
                                                       *mc.input_shape)
    y = torch.from_numpy(ds.train_y[:lanes * bs].astype(np.int64)).view(
        lanes, bs)
    p0 = init_worker_params("model1", input_shape=mc.input_shape,
                            generator=torch.Generator().manual_seed(
                                cfg.seed))

    def step(device, n, prof=False):
        device = torch.device(device)
        params = {k: v.expand(n, *v.shape).contiguous().to(device)
                  .requires_grad_() for k, v in p0.items()}
        moms = {k: torch.zeros_like(v) for k, v in params.items()}
        args = (x[:n].to(device), y[:n].to(device),
                torch.ones(n, bs, device=device))
        ctx = (profile(activities=[ProfilerActivity.CUDA]) if prof
               else contextlib.nullcontext())
        with deterministic(device), full_f32(device), ctx as p:
            stacked_step(lambda z: stacked_forward(
                "model1", params, z, faithful=mc.faithful), params, moms,
                *args, lr=cfg.optim.lr, momentum=cfg.optim.momentum,
                fused=False)
            if device.type == "cuda":
                torch.cuda.synchronize()
        out = {**{f"grad {k}": m.cpu().numpy() for k, m in moms.items()},
               **{f"param {k}": v.detach().cpu().numpy()
                  for k, v in params.items()}}
        return out, (_conv_kernels(p) if prof else [])

    t = time.perf_counter()
    cpu, _ = step("cpu", lanes)
    cpu_s = time.perf_counter() - t
    f64 = _model1_grads_f64(p0, x, y, faithful=mc.faithful)
    print(f"4c the CPU step at {lanes} lanes (Model1, {mc.input_shape}, "
          f"batch {bs} a lane): {cpu_s:.1f} s; the f64 gradients beside "
          f"it: {time.perf_counter() - t - cpu_s:.1f} s")
    worst, bad = {}, []
    for n in (lanes, lanes // 2):
        card, _ = step(dev, n)
        again, names = step(dev, n, prof=True)
        if any(not np.array_equal(card[k], again[k]) for k in card):
            fail(f"4c: two card steps at {n} lanes differ")
        for key in card:
            want, got = cpu[key][:n], card[key]
            l2, er = _rel_l2(want, got), _elem_rel(want, got)
            kind, name = key.split()
            worst[(n, kind)] = max(worst.get((n, kind), 0.0), l2)
            ref = ""
            if kind == "grad":
                r = f64[name][:n]
                ref = (f"; against f64: card {_rel_l2(r, got):.3e}, CPU "
                       f"{_rel_l2(r, want):.3e}")
            print(f"4c {n} lanes, {key}: relative L2 {l2:.3e}, max-rel "
                  f"{er:.3e}{ref}")
            if not l2 <= 1e-5:
                bad.append(f"{key} at {n} lanes {l2:.3e}")
        print(f"4c {n} lanes: the conv and GEMM kernels the card ran:")
        for name in names:
            print(f"    {name}")
    print(f"4c one Model1 step, card against the CPU: worst relative L2 "
          f"{ {f'{n} lanes {k}': f'{v:.3e}' for (n, k), v in worst.items()} }"
          f" (limit 1e-5); phase 4c in {time.perf_counter() - t4c:.1f} s; "
          f"{smi}")
    if bad:
        fail(f"4c: the card's step is beyond 1e-5 relative L2 of the CPU's: "
             f"{bad}")


def _seqlm_cfg(**kw):
    """dopt's ``seqlm`` preset with ``seqlm`` fields replaced."""
    from dopt_torch.presets import get_preset

    base = get_preset("seqlm")
    return base.replace(seqlm=dataclasses.replace(base.seqlm, **kw))


def _seqlm_state(tr) -> dict:
    """A SeqLMTrainer's params and momentum on the host."""
    return {**{f"p.{k}": v.detach().cpu().numpy().copy()
               for k, v in tr.params.items()},
            **{f"m.{k}": v.cpu().numpy().copy()
               for k, v in tr.momentum.items()}}


def phase18(dev, smi: str) -> dict:
    """Phase 18, dopt's sequence-parallel LM on one rank (a one-block
    ring): the ``seqlm`` preset at full width (TransformerLM, vocab 64,
    dim 128, depth 2, 4 heads, 469,504 params; 60 steps of 8 × 512
    tokens, lr 0.3, momentum 0.9).  18a the ring preset timed (tokens/s
    over the host wall ended by a synchronize, the peak), with dopt's
    learning signal; 18b one step against the port's CPU step from the
    same init and batch (the loss within 1e-5 relative, every parameter
    within 1e-5 relative L2); 18c dense and Ulysses one step within 1e-5
    relative L2 of the ring's, and their 60-step losses; 18d two runs
    bit for bit, and a run killed at step 30 and resumed from its
    checkpoint bit for bit 18a; 18e seq_len 4096, batch 8, 3 steps, the
    ring with ``kv_chunk=512`` against without: the chunked peak below
    the unchunked one by at least one [8, 4096, 4, 4096] f32 score block;
    18f neither kernel launches on any phase-18 path.  Returns the
    launch counts of 18a's run."""
    import tempfile

    import numpy as np
    import torch

    from dopt_torch.engine import SeqLMTrainer
    from dopt_torch.ops.fused_update import (fused_mix_sgd,
                                             fused_sgd_momentum,
                                             launch_counts)

    t18 = time.perf_counter()
    launched = {}

    def drive(label, cfg, steps=None, tr=None, device=None):
        """``steps`` steps (the preset's by default) through a fresh
        trainer (or ``tr``): the wall from just before the run to a
        synchronize after it, the peak over what was allocated before
        the trainer, the launch counts set to 0 just before the run and
        read just after."""
        device = dev if device is None else device
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        tr = tr or SeqLMTrainer(cfg, device=device)
        fused_sgd_momentum.launches = 0
        fused_mix_sgd.launches = 0
        t = time.perf_counter()
        tr.run(steps=steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launched[label] = launch_counts()
        return tr, wall, torch.cuda.max_memory_allocated() - base

    def losses(tr) -> list:
        return [(r["step"], round(r["loss"], 4)) for r in tr.history.rows]

    # -- 18a. the ring preset, 60 steps.
    s = _seqlm_cfg().seqlm
    tra, wall, peak = drive("18a", _seqlm_cfg())
    rows = tra.history.rows
    first, last = rows[0]["loss"], rows[-1]["loss"]
    print(f"18a seqlm (ring, 1 rank, {tra.param_count} params): {s.steps} "
          f"steps of {s.batch}x{s.seq_len} tokens in {wall:.3f} s = "
          f"{s.steps * s.batch * s.seq_len / wall:.0f} tokens/s; peak "
          f"{peak} B over what was allocated before; losses {losses(tra)}; "
          f"{smi}")
    if not (math.isfinite(first) and first > 3.0 and last < first - 1.0):
        fail(f"18a: losses {losses(tra)}: dopt's learning signal is a first "
             "loss above 3.0 and a last below the first less 1.0")
    want = _seqlm_state(tra)

    # -- 18b. one step on the card against the CPU's, same init and batch.
    one = []
    for device in (dev, "cpu"):
        tr = SeqLMTrainer(_seqlm_cfg(), device=device)
        tr.run(steps=1)
        one.append((tr.history.rows[0]["loss"], {
            k: v.detach().cpu().numpy() for k, v in tr.params.items()}))
    (lc, pc), (lh, ph) = one
    worst = max((_rel_l2(ph[k], pc[k]), k) for k in ph)
    print(f"18b one step, card against the CPU: loss {lc} against {lh} "
          f"({abs(lc - lh) / abs(lh):.3e} relative), worst parameter "
          f"{worst[1]} at {worst[0]:.3e} relative L2 (limits 1e-5); {smi}")
    if not (abs(lc - lh) <= 1e-5 * abs(lh) and worst[0] <= 1e-5):
        fail(f"18b: one step on the card is {abs(lc - lh) / abs(lh):.3e} "
             f"(loss) and {worst[0]:.3e} ({worst[1]}) from the CPU's")

    # -- 18c. dense and Ulysses against the ring: one step, then 60.
    for attn in ("dense", "ulysses"):
        cfg = _seqlm_cfg(attn=attn)
        tr, _, _ = drive(f"18c {attn}", cfg, steps=1)
        rel = max((_rel_l2(pc[k], v.detach().cpu().numpy()), k)
                  for k, v in tr.params.items())
        if not rel[0] <= 1e-5:
            fail(f"18c: one {attn} step is {rel[0]:.3e} ({rel[1]}) from "
                 "the ring's (relative L2, limit 1e-5)")
        tr, wall, _ = drive(f"18c {attn} rest", cfg, steps=s.steps - 1,
                            tr=tr)
        print(f"18c {attn}: one step within {rel[0]:.3e} relative L2 of the "
              f"ring's (limit 1e-5); {s.steps} steps, the last {s.steps - 1} "
              f"in {wall:.3f} s; losses {losses(tr)} (ring "
              f"{losses(tra)}); {smi}")
        del tr

    # -- 18d. two runs, and killed at step 30 and resumed.
    trd, _, _ = drive("18d again", _seqlm_cfg())
    got = _seqlm_state(trd)
    if trd.history.rows != rows or any(
            not np.array_equal(v, got[k]) for k, v in want.items()):
        fail("18d: two runs of 18a differ")
    with tempfile.TemporaryDirectory(prefix="dopt-torch-seqlm-") as ck:
        half = s.steps // 2
        killed, _, _ = drive("18d killed", _seqlm_cfg(), steps=half)
        killed.save(Path(ck) / "ck")
        resumed = SeqLMTrainer(_seqlm_cfg(), device=dev)
        resumed.restore(Path(ck) / "ck")
        drive("18d resumed", _seqlm_cfg(), steps=s.steps - half, tr=resumed)
    got = _seqlm_state(resumed)
    # The killed run closes with its own row at step 29 (dopt's
    # always-log-the-last-step rule); every other row is 18a's.
    if ([r for r in resumed.history.rows if r["step"] != half - 1] != rows
            or any(not np.array_equal(v, got[k]) for k, v in want.items())):
        fail("18d: killed at step 30 and resumed differs from 18a")
    print(f"18d two runs of 18a: bit for bit (params, momentum, History); "
          f"killed at step {half} and resumed from its checkpoint: bit for "
          "bit 18a (params, momentum, History but the killed run's closing "
          f"row); {smi}")
    del trd, killed, resumed

    # -- 18e. long context: the ring with and without kv_chunk.
    peaks = {}
    for chunk in (512, 0):
        cfg = _seqlm_cfg(seq_len=4096, steps=3, kv_chunk=chunk)
        tr, wall, peaks[chunk] = drive(f"18e kv_chunk {chunk}", cfg)
        print(f"18e seq_len 4096, batch 8, ring, kv_chunk {chunk}: 3 steps "
              f"in {wall:.3f} s, peak {peaks[chunk]} B over what was "
              f"allocated before; losses {losses(tr)}; {smi}")
        del tr
        torch.cuda.empty_cache()
    block = 8 * 4096 * 4 * 4096 * 4
    if not peaks[0] - peaks[512] >= block:
        fail(f"18e: the chunked peak {peaks[512]} B is not below the "
             f"unchunked {peaks[0]} B by one score block ({block} B)")
    print(f"18e kv_chunk 512 saves {peaks[0] - peaks[512]} B of peak against "
          f"the unchunked ring ({(peaks[0] - peaks[512]) / block:.2f} score "
          f"blocks of {block} B); {smi}")

    # -- 18f. neither kernel on any phase-18 path.
    bad = {k: v for k, v in launched.items() if any(v.values())}
    if bad:
        fail(f"18f: a kernel launched on the seqlm path: {bad}")
    print(f"18f launches on every phase-18 path: "
          f"{sorted(set(map(str, launched.values())))} (plain sgd_step: "
          "neither kernel)")
    print(f"18: phase 18 in {time.perf_counter() - t18:.1f} s")
    del tra
    gc.collect()
    torch.cuda.empty_cache()
    return launched["18a"]


def _phase17_seqlm(wg, out: Path, dev) -> dict:
    """Phase 17's seqlm parts on one rank: the preset's ring and Ulysses
    over the ranks, each a first step (its params saved by rank 0) and
    the other 59, the bytes the rank hands to ``torch.distributed`` in a
    step (the meter), the launches and the History; the ring run again
    from scratch, which must equal it bit for bit on every rank."""
    import numpy as np
    import torch

    from dopt_torch.engine import SeqLMTrainer
    from dopt_torch.ops.fused_update import (fused_mix_sgd,
                                             fused_sgd_momentum,
                                             launch_counts)
    from dopt_torch.parallel.mesh import meter_by_kind

    rec = {}
    for attn in ("ring", "ulysses"):
        cfg = _seqlm_cfg(attn=attn)
        tr = SeqLMTrainer(cfg, device=dev)
        fused_sgd_momentum.launches = 0
        fused_mix_sgd.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        tr.run(steps=1)
        step_bytes = {f"{op}.{kind}": n for (op, kind), n
                      in meter_by_kind(tr.group.meter).items()}
        first = {k: v.detach().cpu().numpy().copy()
                 for k, v in tr.params.items()}
        tr.run(steps=cfg.seqlm.steps - 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        end = _seqlm_state(tr)
        if wg.rank == 0:
            np.savez(out / f"17s-{attn}.npz",
                     **{f"one.{k}": v for k, v in first.items()}, **end)
        rec[attn] = {"rows": tr.history.rows, "wall": wall,
                     "step_bytes": step_bytes, "launch": launch_counts(),
                     "backend": tr.group.backend, "ranks": tr.group.size}
        if attn == "ring":
            again = SeqLMTrainer(cfg, device=dev)
            again.run()
            got = _seqlm_state(again)
            rec[attn]["same"] = (again.history.rows == tr.history.rows
                                 and all(np.array_equal(v, got[k])
                                         for k, v in end.items()))
            del again
        del tr
    return rec


def _phase17_configs(ranks: int):
    """Phase 17's two headlines at ``ranks`` ranks: kernel 1 on, the fused
    epilogue off (dopt refuses it on a multi-device mesh), the federated
    one at full width (compact is off across ranks, as in dopt)."""
    from dopt_torch.presets import get_preset

    rep = dataclasses.replace
    head = get_preset("headline-dsgd-model1")
    fhead = get_preset("headline-fedavg-model1")
    return {
        "a": ("gossip", head.replace(
            optim=rep(head.optim, fused_update=True), mesh_devices=ranks,
            gossip=rep(head.gossip, fused_update="off"))),
        "b": ("federated", fhead.replace(
            optim=rep(fhead.optim, fused_update=True), mesh_devices=ranks,
            federated=rep(fhead.federated, fused_update="off",
                          compact=False)))}


def _phase17_inputs(dev) -> dict:
    """Seeded Model1-shaped stacks for one mix (6 workers) and one masked
    average (16), the same in every process on the card."""
    import torch

    from dopt_torch.models.zoo import param_shapes

    gen = torch.Generator(device=dev).manual_seed(17)
    shapes = param_shapes("model1")
    return {name: {k: torch.randn(n, *s, device=dev, generator=gen)
                   for k, s in shapes.items()}
            for name, n in (("x6", 6), ("x16", 16))}


def _phase17_mixing(dev):
    """The gossip headline's round-0 matrix (6-ring), its shift set and
    coefficients, and a 16-lane mask of 8."""
    import numpy as np
    import torch

    from dopt_torch.presets import get_preset
    from dopt_torch.topology import (build_mixing_matrices, coeffs_for_matrix,
                                     schedule_shift_decomposition)

    g = get_preset("headline-dsgd-model1").gossip
    sched = build_mixing_matrices(g.topology, g.mode, 6, seed=get_preset(
        "headline-dsgd-model1").seed)
    w = sched.for_round(0).astype(np.float32)
    ids = schedule_shift_decomposition(sched)
    return (torch.from_numpy(w).to(dev), ids,
            torch.from_numpy(coeffs_for_matrix(w, ids)).to(dev),
            (torch.arange(16, device=dev) % 2 == 0).float())


def phase17_rank(wg, out_dir: str, parts: tuple, rounds: int) -> None:
    """One spawned rank of phase 17: the sub-phases ``parts`` of
    ``_phase17_configs``' runs on this rank's lanes, through the
    trainers a user calls.  Per run: the walls of each round, the
    launch counts (set to 0 just before the run, read just after), the
    byte meter, the peak and the History; rank 0 also saves the gathered
    worker params and theta.  17a saves its state after round 0 (what a
    run killed then leaves); 17c resumes it at the same ranks, bit for
    bit with 17a's rank-local state, and the parent restores rank 0's
    file at one rank."""
    import numpy as np
    import torch

    from dopt_torch.engine import FederatedTrainer, GossipTrainer
    from dopt_torch.ops.fused_update import (MAX_TENSORS, fused_mix_sgd,
                                             fused_sgd_momentum,
                                             launch_counts)
    from dopt_torch.parallel.collectives import (masked_average, mix_dense,
                                                 mix_shifts, shift_comm_lanes)
    from dopt_torch.parallel.mesh import (gather_workers, make_worker_group,
                                          meter_by_kind)

    from dopt_torch.engine import gossip as gossip_engine

    out = Path(out_dir)
    dev = torch.device("cuda", torch.cuda.current_device())
    cfgs = _phase17_configs(wg.size)
    # Each synthetic set is made once a process, as in main.
    gossip_engine.load_dataset = functools.lru_cache(maxsize=4)(
        gossip_engine.load_dataset)
    rec: dict = {}

    def local_state(tr) -> dict:
        moms = (tr.momentum if isinstance(tr.momentum, dict)
                else dict(zip(tr._names, tr.momentum)))
        params = (tr.params if isinstance(tr, FederatedTrainer)
                  else dict(zip(tr._names, tr._params)))
        return {**{f"p.{k}": v.detach().clone() for k, v in params.items()},
                **{f"m.{k}": v.clone() for k, v in moms.items()}}

    def wire_bytes(tr) -> tuple[str, int] | None:
        """The meter key and the bytes a round the consensus wire must
        hand over: the shift plan's shipped lanes (dopt's 'auto' rule
        takes the shift path where it ships fewer lanes than the dense
        all-gather) or the all-gather of the rank's L lanes."""
        ids = getattr(tr, "_shift_ids", None)
        if not hasattr(tr, "_shift_ids"):
            return None
        p4 = tr.param_count * 4
        if ids is None:
            return "all_gather.dense", tr.lanes * p4
        return "send.shift", shift_comm_lanes(ids, tr.lanes,
                                              tr.group.size) * p4

    def drive(label, cls, cfg, n, tr=None, ck=None):
        """n timed rounds; with ``ck`` the state after round 0 is saved
        there, outside the walls (what a run killed then leaves)."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        tr = tr or cls(cfg, device=dev)
        built = time.perf_counter() - t
        tr.group.meter.clear()
        fused_sgd_momentum.launches = 0
        fused_mix_sgd.launches = 0
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            tr.run(rounds=1)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            if ck is not None and len(walls) == 1:
                tr.save(ck)
        got = launch_counts()
        tensors = len(getattr(tr, "_names", None) or tr.params)
        rec[label] = {
            "walls": walls, "built": built, "launch": got,
            "want": {"fused_sgd_momentum": n * tr.steps_per_round
                     * -(-tensors // MAX_TENSORS), "fused_mix_sgd": 0},
            "meter": {f"{op}.{kind}": b for (op, kind), b
                      in meter_by_kind(tr.group.meter).items()},
            "gather_bytes": tr.lanes * tr.param_count * 4,
            "wire": wire_bytes(tr),
            "peak": torch.cuda.max_memory_allocated(),
            "rows": tr.history.rows, "lanes": tr.lanes,
            "backend": tr.group.backend}
        return tr

    states = {}
    for part in (p for p in parts if p in cfgs):
        engine, cfg = cfgs[part]
        cls = GossipTrainer if engine == "gossip" else FederatedTrainer
        # 17b one round (cut from 2 for the budget, as 14d's federated f32
        # run it is held against).
        tr = drive(part, cls, cfg, 1 if part == "b" else rounds,
                   ck=out / "17c.ck" if part == "a" and "c" in parts
                   else None)
        if part == "a":
            states["a"] = local_state(tr)
        full = {f"p.{k}": v for k, v in tr.worker_params().items()}
        if cls is FederatedTrainer:
            full.update({f"theta.{k}": v
                         for k, v in tr.global_params().items()})
        if wg.rank == 0:
            np.savez(out / f"17{part}.npz", **full)
        del tr, full
        gc.collect()
        torch.cuda.empty_cache()
    if "m" in parts:
        # One mix and one masked average of the same inputs, across the
        # ranks: the dense all-gather, the shift path and the f32 masked
        # mean's partial sums (the parent holds them against one rank).
        mix = {}
        for name, x in _phase17_inputs(dev).items():
            lanes = next(iter(x.values())).shape[0]
            g = make_worker_group(lanes, wg.group)
            mine = {k: g.local(v).contiguous() for k, v in x.items()}
            w6, ids, coeffs, m16 = _phase17_mixing(dev)
            if name == "x6":
                got = {"dense": mix_dense(mine, w6, group=g),
                       "shift": mix_shifts(mine, ids, coeffs, g)}
                got = {f"{how}.{k}": v for how, tree in got.items()
                       for k, v in gather_workers(tree, g).items()}
            else:
                got = {f"mean.{k}": v for k, v in
                       masked_average(mine, m16, None, g).items()}
            mix.update({k: v.cpu().numpy() for k, v in got.items()})
        if wg.rank == 0:
            np.savez(out / "17m.npz", **mix)
    if "s" in parts:
        rec["s"] = _phase17_seqlm(wg, out, dev)
    if "c" in parts:
        _, cfg = cfgs["a"]
        resumed = GossipTrainer(cfg, device=dev)
        resumed.restore(out / "17c.ck")
        drive("c", GossipTrainer, cfg, rounds - 1, tr=resumed)
        got = local_state(resumed)
        rec["c"]["same"] = (rec["c"]["rows"] == rec["a"]["rows"] and all(
            torch.equal(got[k], v) for k, v in states["a"].items()))
        del resumed
    (out / f"17.r{wg.rank}.json").write_text(json.dumps(rec))


def _spawn17(out: Path, ranks: int, backend: str, parts: tuple,
             rounds: int, deadline_s: float) -> list[dict]:
    """Spawn ``ranks`` processes of ``phase17_rank`` joined by a
    ``file://`` rendezvous over ``backend`` and wait for them at most
    ``deadline_s`` (a stuck rank is killed and the phase fails); returns
    each rank's record."""
    import torch.multiprocessing as mp

    from dopt_torch.parallel.mesh import _rank_main

    out.mkdir(parents=True, exist_ok=True)
    ctx = mp.start_processes(
        _rank_main, args=(phase17_rank, ranks, str(out / "rendezvous"),
                          backend, None, (str(out), parts, rounds)),
        nprocs=ranks, join=False, start_method="spawn")
    end = time.perf_counter() + deadline_s
    try:
        while not ctx.join(timeout=1.0):
            if time.perf_counter() > end:
                fail(f"17: {ranks} {backend} ranks still running after "
                     f"{deadline_s:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    return [json.loads((out / f"17.r{r}.json").read_text())
            for r in range(ranks)]


def _seqlm_tokens(recs: list[dict], attn: str) -> float:
    """The slowest rank's tokens/s over the preset's steps."""
    s = _seqlm_cfg().seqlm
    return s.steps * s.batch * s.seq_len / max(r["s"][attn]["wall"]
                                               for r in recs)


def seqlm_check(recs: list[dict], out: Path, dev, smi: str) -> None:
    """Phase 17's seqlm parts, held: the History equal on every rank, no
    kernel launched, the ring's two runs bit for bit, and one step at the
    ranks within 1e-5 relative L2 of one rank's (the loss within 1e-5
    relative)."""
    import numpy as np

    from dopt_torch.engine import SeqLMTrainer

    ref = SeqLMTrainer(_seqlm_cfg(), device=dev)
    ref.run(steps=1)
    loss1 = ref.history.rows[0]["loss"]
    base = {k: v.detach().cpu().numpy() for k, v in ref.params.items()}
    del ref
    for attn in ("ring", "ulysses"):
        r0 = recs[0]["s"][attn]
        for r, rec in enumerate(recs):
            got = rec["s"][attn]
            if got["rows"] != r0["rows"]:
                fail(f"17s {attn}: rank {r}'s History differs from rank 0's")
            if any(got["launch"].values()):
                fail(f"17s {attn} rank {r}: launches {got['launch']}")
            if attn == "ring" and not got["same"]:
                fail(f"17s ring rank {r}: two runs differ")
        arrays = dict(np.load(out / f"17s-{attn}.npz"))
        worst = max((_rel_l2(v, arrays[f"one.{k}"]), k)
                    for k, v in base.items())
        dl = abs(r0["rows"][0]["loss"] - loss1) / abs(loss1)
        if not (worst[0] <= 1e-5 and dl <= 1e-5):
            fail(f"17s {attn}: one step at {r0['ranks']} ranks is "
                 f"{worst[0]:.3e} ({worst[1]}) and {dl:.3e} (loss) from one "
                 "rank's (limit 1e-5)")
        losses = [(row["step"], round(row["loss"], 4)) for row in r0["rows"]]
        print(f"17s seqlm {attn} at {r0['ranks']} ranks sharing the card over "
              f"host-staged {r0['backend']}: one step within {worst[0]:.3e} "
              f"relative L2 ({worst[1]}) and {dl:.3e} (loss) of one rank's "
              f"(limit 1e-5); {'two runs bit for bit; ' if attn == 'ring' else ''}"
              f"History equal on every rank; bytes handed to "
              f"torch.distributed a step a rank "
              f"{[rec['s'][attn]['step_bytes'] for rec in recs]}; "
              f"{_seqlm_tokens(recs, attn):.0f} tokens/s; launches "
              f"{r0['launch']}; losses {losses}; {smi}")


def phase17(dev, smi: str, get_preset, kit, ckdir: Path) -> dict:
    """Phase 17, the multi-GPU engines on the card: the worker axis over
    2 ranks.  On one card the ranks share it over host-staged gloo (CUDA
    lanes, host-staged collectives); with two cards or more 17d runs one
    rank a card over NCCL.  ``kit`` holds phase 3's ``k1_site`` and 14d's
    one-rank f32-wire runs (``f32wire``); ``ckdir`` takes the ranks'
    files.  Returns the launch counts (``launch``) and the rank-width
    kernel-1 sites (``site``) for the kernels line."""
    import numpy as np
    import torch

    from dopt_torch.engine import GossipTrainer
    from dopt_torch.models.zoo import param_shapes
    from dopt_torch.parallel import collectives as P

    t17 = time.perf_counter()
    ranks, n = 2, 2
    shapes = param_shapes("model1")
    # Kernel 1 at rank width, timed as phase 3 times it (25 cold-L2
    # calls): 3 of the gossip headline's 6 lanes, 8 of the federated 16.
    site = {"a": kit.k1_site("headline-dsgd-model1 at 2 ranks, L=3",
                             shapes, 3),
            "b": kit.k1_site("headline-fedavg-model1 at 2 ranks, L=8",
                             shapes, 8)}
    torch.cuda.synchronize()
    t = time.perf_counter()
    recs = _spawn17(ckdir / "gloo", ranks, "gloo",
                    ("a", "b", "m", "s", "c"), n, 240)
    spawn_s = time.perf_counter() - t
    keys = {"a": ("avg_train_loss", "avg_test_loss", "avg_test_acc"),
            "b": ("test_loss", "train_loss", "local_loss", "test_acc")}
    launch = {}
    for part, label, base in (("a", "17a headline-dsgd-model1", "gossip"),
                              ("b", "17b headline-fedavg-model1",
                               "federated")):
        r0 = recs[0][part]
        for r, rec in enumerate(recs):
            got = rec[part]
            if got["rows"] != r0["rows"]:
                fail(f"{label}: rank {r}'s History differs from rank 0's")
            if got["launch"] != got["want"]:
                fail(f"{label} rank {r}: launches {got['launch']}, "
                     f"expected {got['want']} (kernel 1 every step, "
                     "kernel 2 never)")
            if part == "a":
                key, want = got["wire"]
                sent = got["meter"].get(key, 0) / n
                if sent != want:
                    fail(f"{label} rank {r}: {sent} B a round handed to "
                         f"{key}, expected {want} (the dense all-gather "
                         f"would hand {got['gather_bytes']}, L·P·4)")
        launch[f"headline-{'dsgd' if part == 'a' else 'fedavg'}-model1-"
               "ranks2"] = r0["launch"]
        one = kit.f32wire[base]
        # Round 0 (one round from the same init) within slice 1's limits;
        # round 1 printed, not bounded: each lane's step is within 1e-6 of
        # the CPU's at 3 and at 6 lanes (phase 4c), but the ranks' sums
        # (the shift mix, the masked mean's partials, cuDNN's input
        # gradient by group count) round otherwise, and a max-pool
        # near-tie in a later step turns such a difference into a jump
        # (PERF.md §6).
        later = {}
        for t, (ra, rb) in enumerate(zip(one["rows"], r0["rows"],
                                         strict=True)):
            for k in keys[part]:
                if k not in ra:
                    continue
                tol = ACC_TOL if "acc" in k else LOSS_TOL
                if t == 0 and abs(ra[k] - rb[k]) > tol:
                    fail(f"{label}: round 0 {k} {ra[k]} at 2 ranks "
                         f"{rb[k]} (limit {tol})")
                if t > 0:
                    later[k] = round(abs(ra[k] - rb[k]), 6)
        arrays = dict(np.load(ckdir / "gloo" / f"17{part}.npz"))
        prefix = "theta." if part == "b" else "p."
        rel = max_rel(one["params"], {k[len(prefix):]: v
                                      for k, v in arrays.items()
                                      if k.startswith(prefix)})
        walls = [[round(w, 4) for w in rec[part]["walls"]] for rec in recs]
        rates = [len(rec[part]["walls"]) / sum(rec[part]["walls"])
                 for rec in recs]
        wire = ("" if part == "b" else
                f"consensus over {r0['wire'][0]} ({r0['wire'][1]} B a round "
                f"a rank; the dense all-gather's {r0['gather_bytes']}); ")
        print(f"{label} at {ranks} ranks sharing the card over host-staged "
              f"gloo ({r0['lanes']} lanes a rank): {wire}walls {walls} s, "
              f"{min(rates):.4f} rounds/s (one rank, 14d: "
              f"{one['rate']:.4f}); round 0 within {LOSS_TOL}/{ACC_TOL} of "
              f"14d's one-rank f32 run, later rounds off by {later}, "
              f"{'theta' if part == 'b' else 'params'} max-rel {rel:.3e} "
              f"(both printed, not bounded); launches a rank "
              f"{[rec[part]['launch'] for rec in recs]}; bytes handed to "
              "torch.distributed a rank "
              f"{[rec[part]['meter'] for rec in recs]}; peak a rank "
              f"{[rec[part]['peak'] for rec in recs]} B; {smi}")
    mixed = dict(np.load(ckdir / "gloo" / "17m.npz"))
    x = _phase17_inputs(dev)
    w6, ids, coeffs, m16 = _phase17_mixing(dev)
    want = {**{f"dense.{k}": v for k, v in P.mix_dense(x["x6"], w6).items()},
            **{f"shift.{k}": v for k, v in P.mix_dense(x["x6"], w6).items()},
            **{f"mean.{k}": v for k, v in P.masked_average(x["x16"],
                                                         m16).items()}}
    worst = {}
    for k, v in want.items():
        v = v.cpu().numpy()
        how = k.split(".")[0]
        worst[how] = max(worst.get(how, 0.0), float(
            np.abs(mixed[k] - v).max() / max(np.abs(v).max(), 1e-12)))
    if not max(worst.values()) <= 1e-6:
        fail(f"17m: one mix / masked average at 2 ranks against one rank: "
             f"{worst} (limit 1e-6)")
    print(f"17m one mix at 2 ranks (dense all-gather; shift {tuple(ids)}) "
          f"and one f32 masked average (partial sums gathered) against one "
          f"rank: max-rel {worst} (limit 1e-6); {smi}")
    del x, want
    c = [rec["c"] for rec in recs]
    if not all(x["same"] for x in c):
        fail("17c: 17a killed after round 0 and resumed at 2 ranks differs "
             "from 17a")
    if any(x["launch"] != x["want"] for x in c):
        fail(f"17c: launches {[x['launch'] for x in c]}")
    one = GossipTrainer(_phase17_configs(1)["a"][1], device=dev)
    one.restore(ckdir / "gloo" / "17c.ck")
    one.run(rounds=1)
    for ra, rb in zip(recs[0]["a"]["rows"], one.history.rows, strict=True):
        for k in keys["a"]:
            tol = ACC_TOL if "acc" in k else LOSS_TOL
            if k in ra and abs(ra[k] - rb[k]) > tol:
                fail(f"17c: rank 0's checkpoint resumed at 1 rank: {k} "
                     f"{rb[k]} against 17a's {ra[k]}")
    print(f"17c 17a killed after round 0 and resumed at 2 ranks: bit for bit "
          f"17a (History, params, momentum on every rank); rank 0's "
          f"checkpoint resumed at 1 rank for round 1 within {LOSS_TOL}/"
          f"{ACC_TOL} of 17a; {smi}")
    del one
    gc.collect()
    torch.cuda.empty_cache()
    seqlm_check(recs, ckdir / "gloo", dev, smi)
    cards = torch.cuda.device_count()
    if cards >= 2:
        nrecs = _spawn17(ckdir / "nccl", ranks, "nccl", ("a", "b", "s"), n,
                         240)
        for attn in ("ring", "ulysses"):
            want = dict(np.load(ckdir / "gloo" / f"17s-{attn}.npz"))
            got = dict(np.load(ckdir / "nccl" / f"17s-{attn}.npz"))
            if nrecs[0]["s"][attn]["rows"] != recs[0]["s"][attn]["rows"] or any(
                    not np.array_equal(want[k], got[k]) for k in want):
                fail(f"17s {attn}: NCCL differs from gloo")
            print(f"17s {attn} over NCCL, one rank a card: bit for bit the "
                  f"gloo run; {_seqlm_tokens(nrecs, attn):.0f} tokens/s; "
                  f"{smi}")
        for part in ("a", "b"):
            want = dict(np.load(ckdir / "gloo" / f"17{part}.npz"))
            got = dict(np.load(ckdir / "nccl" / f"17{part}.npz"))
            if nrecs[0][part]["rows"] != recs[0][part]["rows"] or any(
                    not np.array_equal(want[k], got[k]) for k in want):
                fail(f"17d {part}: NCCL differs from gloo")
            launch[f"headline-{'dsgd' if part == 'a' else 'fedavg'}-model1-"
                   "ranks2-nccl"] = nrecs[0][part]["launch"]
            rates = [len(rec[part]["walls"]) / sum(rec[part]["walls"])
                     for rec in nrecs]
            print(f"17d {part} over NCCL, one rank a card: bit for bit the "
                  f"gloo run; {min(rates):.4f} rounds/s; walls "
                  f"{[rec[part]['walls'] for rec in nrecs]}; {smi}")
    else:
        print(f"17d: {cards} GPU visible: NCCL across cards (one rank a "
              "card) not run")
    print(f"17: phase 17 in {time.perf_counter() - t17:.1f} s (the spawn of "
          f"17a-17c {spawn_s:.1f} s)")
    return {"launch": launch, "site": site}


def _serve_schedule(state: Path, at: dict) -> None:
    """Phase 19's commands, queued before the daemon starts: worker 3
    leaves at ``at["leave"]``, ``optim.lr`` changes at ``at["lr"]`` (the
    rebuild) and worker 3 joins at ``at["join"]`` (keys left out are not
    queued)."""
    from dopt_torch.serve import CommandQueue, make_command

    q = CommandQueue(state / "commands.jsonl")
    if "leave" in at:
        q.submit(make_command("membership", worker=3, action="leave",
                              at_round=at["leave"], id="leave"))
    if "lr" in at:
        q.submit(make_command("config", key="optim.lr", value=0.005,
                              at_round=at["lr"], id="lr"))
    if "join" in at:
        q.submit(make_command("membership", worker=3, action="join",
                              at_round=at["join"], id="join"))


def _timed_daemon(cls):
    """``cls`` (a ``ServeDaemon``) recording each boundary visit's
    entry and exit on the host clock after a device synchronize: a
    served round's wall is the gap from one round's boundary exit to the
    next round's entry.  ``snapshot_at`` copies the state dir as it
    stands right after that boundary (its checkpoint written): what a
    process stopped there leaves on disk."""
    import shutil

    import torch

    class Timed(cls):
        def __init__(self, *a, snapshot_at=None, snapshot_dir=None, **kw):
            super().__init__(*a, **kw)
            self.visits: list[tuple[int, float, float, str]] = []
            self._snap = (snapshot_at, snapshot_dir)

        def boundary(self, trainer):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            verdict = super().boundary(trainer)
            torch.cuda.synchronize()
            self.visits.append((int(trainer.round), t0,
                                time.perf_counter(), verdict))
            at, dst = self._snap
            if at is not None and int(trainer.round) == at \
                    and verdict == "run" and not dst.exists():
                shutil.copytree(self.state_dir, dst)
            return verdict

        def round_walls(self) -> list[float]:
            out = []
            for (r0, _, e0, v0), (r1, s1, _, _) in zip(self.visits,
                                                      self.visits[1:]):
                if v0 == "run" and r1 == r0 + 1:
                    out.append(s1 - e0)
            return out
    return Timed


def _served_latency(events, name: str) -> list[float]:
    return [e["seconds"] for e in events
            if e["kind"] == "latency" and e["name"] == name]


def phase19(dev, smi: str, get_preset, kit) -> dict:
    """Phase 19, the resident serve daemon (``dopt_torch.serve``) on the
    card.  ``kit`` holds phase 3's ``k2_site``, phase 5's scripted walls
    (``rounds``, ``gwall``, ``fwall``) and ``beside``, the work that
    shares the window once 19c's CLI leg, 19d and 20d's probe are
    started (phase 23's ``phase23_window``).  Returns the served paths'
    launch counts (``launch``) and the served gossip kernel-2 site on the
    churn-repaired matrix (``site``) for the kernels line."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from dopt_torch.models.zoo import param_shapes
    from dopt_torch.obs import JsonlSink, canonical, check_stream
    from dopt_torch.ops.fused_update import (fused_mix_sgd,
                                             fused_sgd_momentum)
    from dopt_torch.serve import ServeDaemon
    from dopt_torch.topology import build_mixing_matrices, repair_for_dropout

    t19 = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="dopt-torch-serve-"))
    launch: dict[str, dict] = {}
    Timed = _timed_daemon(ServeDaemon)

    def counts() -> dict:
        return {"fused_sgd_momentum": fused_sgd_momentum.launches,
                "fused_mix_sgd": fused_mix_sgd.launches}

    def zero() -> None:
        fused_sgd_momentum.launches = 0
        fused_mix_sgd.launches = 0

    def rows_of(d: Path) -> tuple[list, list, list]:
        final = json.loads((d / "final.json").read_text())
        return final, JsonlSink.read(d / "metrics.jsonl"), \
            final["fault_ledger"]

    try:
        # -- 19a: the gossip headline served, as typed --------------------
        cfg = get_preset("headline-dsgd-model1")
        d_a = root / "a"
        _serve_schedule(d_a, {"leave": 1, "lr": 2, "join": 3})
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        da = Timed(cfg, d_a, checkpoint_every=2, max_rounds=4,
                   admin_port=None, snapshot_at=3,
                   snapshot_dir=root / "b").start()
        built = time.perf_counter() - t
        torch.cuda.synchronize()
        zero()
        t = time.perf_counter()
        rc = da.serve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launch["served-gossip"] = counts()
        peak = torch.cuda.max_memory_allocated() - base
        if rc != 0:
            fail(f"19a: the daemon returned {rc}, expected a drain (0)")
        final, ev_a, ledger = rows_of(d_a)
        ctl = [(r["round"], r["action"]) for r in ledger
               if r["kind"] == "control"]
        churn = [(r["round"], r["worker"], r["action"]) for r in ledger
                 if r["kind"] == "churn"]
        want_ctl = [(1, "applied_membership_leave"),
                    (2, "applied_config_optim.lr=0.005"),
                    (3, "applied_membership_join")]
        if ctl != want_ctl:
            fail(f"19a: control rows {ctl}, expected {want_ctl}")
        if churn[0] != (1, 3, "left") or churn[-1] != (3, 3, "rejoined") \
                or not any(a.startswith("shard_adopted") for _, _, a in churn):
            fail(f"19a: churn rows {churn}")
        summary = check_stream(ev_a)
        if summary["rounds"] != 4 or summary["kinds"].get("control") != 3:
            fail(f"19a: stream summary {summary}")
        if final["report"]["verdict"] != "healthy" or final["round"] != 4:
            fail(f"19a: final.json verdict {final['report']['verdict']}, "
                 f"round {final['round']}")
        if da.trainer.cfg.optim.lr != 0.005:
            fail("19a: the rebuild did not take optim.lr")
        steps = da.trainer.steps_per_round
        spec = da.trainer.fused_spec
        want = {"fused_sgd_momentum": 4 * steps,
                "fused_mix_sgd": 4 * spec.num_buckets}
        if launch["served-gossip"] != want:
            fail(f"19a: launches {launch['served-gossip']}, expected {want}")
        for row in final["history"]:
            for k in ("avg_train_loss", "avg_test_loss", "avg_test_acc"):
                if not math.isfinite(row[k]):
                    fail(f"19a: non-finite {k} in {row}")
        walls = da.round_walls()
        saves = _served_latency(ev_a, "checkpoint_save")
        restores = _served_latency(ev_a, "checkpoint_restore")
        ticks = _served_latency(ev_a, "boundary_tick")
        scripted = kit.gwall / kit.rounds
        print(f"19a served headline-dsgd-model1: built in {built:.2f} s, 4 "
              f"rounds (leave w3 @1, optim.lr 0.005 @2 by rebuild, join w3 "
              f"@3, checkpoint_every 2) in {wall:.3f} s; round walls "
              f"{[round(w, 4) for w in walls]} s (round 2 after the "
              f"rebuild's restore); scripted round {scripted:.4f} s (phase "
              f"5): served/scripted {np.median(walls) / scripted:.4f} "
              f"(median); saves {saves} s; restore {restores} s; boundary "
              f"ticks {ticks} s; peak {peak} B over the {base} B held; "
              f"launches {launch['served-gossip']} ({steps} + "
              f"{spec.num_buckets} a round); {smi}")
        for row in final["history"]:
            print(f"19a history {json.dumps(row)}")

        # -- 19b: stopped at boundary 3, resumed in a fresh daemon --------
        d_b = root / "b"
        if not (d_b / "ckpt").exists():
            fail("19b: no snapshot of 19a's state after boundary 3")
        t = time.perf_counter()
        db = ServeDaemon(cfg, d_b, checkpoint_every=2, max_rounds=4,
                         admin_port=None).start()
        resume_s = time.perf_counter() - t
        if not db._resumed or db.trainer.round != 3 \
                or db.trainer.cfg.optim.lr != 0.005:
            fail(f"19b: resumed {db._resumed} at round {db.trainer.round}, "
                 f"lr {db.trainer.cfg.optim.lr}")
        zero()
        t = time.perf_counter()
        if db.serve() != 0:
            fail("19b: the resumed daemon did not drain")
        torch.cuda.synchronize()
        resumed_wall = time.perf_counter() - t
        launch["served-gossip-resumed"] = counts()
        final_b, ev_b, ledger_b = rows_of(d_b)
        if final_b["history"] != final["history"]:
            fail("19b: the resumed History differs from 19a's")
        if ledger_b != ledger:
            fail("19b: the resumed fault ledger differs from 19a's")
        if canonical(ev_b) != canonical(ev_a):
            fail("19b: the resumed canonical stream differs from 19a's")
        check_stream(ev_b)
        if final_b["restarts"] != 1:
            fail(f"19b: restarts {final_b['restarts']}")
        if launch["served-gossip-resumed"] != {
                "fused_sgd_momentum": steps,
                "fused_mix_sgd": spec.num_buckets}:
            fail(f"19b: launches {launch['served-gossip-resumed']}")
        print(f"19b resumed at boundary 3 in a fresh daemon: start "
              f"(build + restore) {resume_s:.2f} s, restore "
              f"{_served_latency(ev_b, 'checkpoint_restore')[-1]} s, round "
              f"3 + drain {resumed_wall:.3f} s; History, fault ledger and "
              f"canonical stream bit for bit 19a's; {smi}")
        del da, db
        gc.collect()
        torch.cuda.empty_cache()

        # -- 19c: the federated headline, in-process and by the CLI ------
        fcfg = get_preset("headline-fedavg-model1")
        d_f = root / "f"
        _serve_schedule(d_f, {"leave": 1})
        df = Timed(fcfg, d_f, checkpoint_every=0, max_rounds=2,
                   admin_port=None).start()
        zero()
        t = time.perf_counter()
        if df.serve() != 0:
            fail("19c: the federated daemon did not drain")
        torch.cuda.synchronize()
        fwall = time.perf_counter() - t
        launch["served-fedavg"] = counts()
        fsteps = df.trainer.steps_per_round
        want = {"fused_sgd_momentum": 2 * fsteps,
                "fused_mix_sgd": 2 * df.trainer.fused_spec.num_buckets}
        if launch["served-fedavg"] != want:
            fail(f"19c: launches {launch['served-fedavg']}, expected {want}")
        ffinal, _, fledger = rows_of(d_f)
        if [(r["round"], r["worker"], r["action"]) for r in fledger
                if r["kind"] in ("control", "churn")][:2] != [
                (1, 3, "applied_membership_leave"), (1, 3, "left")]:
            fail(f"19c: ledger {fledger}")
        if ffinal["report"]["verdict"] != "healthy":
            fail(f"19c: verdict {ffinal['report']['verdict']}")
        print(f"19c served headline-fedavg-model1 in-process: 2 rounds "
              f"(leave w3 @1) in {fwall:.3f} s, round walls "
              f"{[round(w, 4) for w in df.round_walls()]} s against the "
              f"scripted {kit.fwall / kit.rounds:.4f} s; launches "
              f"{launch['served-fedavg']}; {smi}")
        del df
        gc.collect()
        torch.cuda.empty_cache()

        # The served gossip kernel-2 site: the churn-repaired matrix of
        # rounds 1-2 (worker 3 away), timed before anything else shares
        # the card.
        w = build_mixing_matrices("circle", "stochastic", 6,
                                  seed=2028).for_round(1)
        alive = np.ones(6, np.float32)
        alive[3] = 0.0
        site = kit.k2_site(
            "served headline model1 n=6, churn-repaired W (w3 away), lr 1",
            param_shapes("model1"),
            torch.tensor(repair_for_dropout(w, alive).astype(np.float32),
                         device=dev), 1.0)

        # -- 19c's CLI leg and 19d's fleet, at once: their processes
        # share the card with each other and with 19e (no phase-19 time
        # or kernel row is measured from here on).
        fleet = root / "fleet"
        # Phase 20d's wire probe: 2 gloo ranks sharing the card, beside
        # the CLI leg and the fleet.
        t_comm = time.perf_counter()
        comm_procs = {"cuda": subprocess.Popen(
            [sys.executable, "-m", "dopt_torch.analysis.comm_bytes",
             "--ranks", "2", "--device", "cuda"], cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)}
        t = time.perf_counter()
        fleet_proc = subprocess.Popen(
            [sys.executable, "-m", "dopt_torch.serve", "--preset",
             "baseline1", "--synthetic-scale", "0.05", "--state-dir",
             str(fleet), "--max-rounds", "3", "--checkpoint-every", "2",
             "--num-processes", "2", "--collectives", "gloo",
             "--fleet-port", "0"],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        cli = _CliLeg(root / "cli", smi)
        cli.start()
        try:
            # Phase 23's legs that share this window (``kit.beside``).
            kit.beside()
            graphs_under_serve(root, get_preset)
            try:
                out = fleet_proc.communicate(timeout=300)[0]
            except subprocess.TimeoutExpired:
                fail("19d: the fleet still runs after 300 s")
            fleet_s = time.perf_counter() - t
            cli.join(timeout=max(330 - fleet_s, 1))
            comm = {}
            for dev_, proc in comm_procs.items():
                try:
                    out_, err_ = proc.communicate(timeout=300)
                except subprocess.TimeoutExpired:
                    fail(f"20d: comm_bytes --device {dev_} still runs")
                comm[dev_] = (proc.returncode, out_, err_)
            print(f"20d: the wire probe was collected "
                  f"{time.perf_counter() - t_comm:.1f} s after it started, "
                  f"beside 19c's CLI leg, 19d and 19e")
        finally:
            for proc in (fleet_proc, *comm_procs.values()):
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
        if cli.is_alive() or not cli.ok:
            fail("19c CLI: the leg failed or did not end (above)")
        if fleet_proc.returncode != 0:
            logs = "".join(p.read_text()[-2000:]
                           for p in sorted((fleet / "logs").glob("*.log")))
            fail(f"19d: the fleet exited {fleet_proc.returncode}: "
                 f"{out[-2000:]}\n{logs}")
        ff = json.loads((fleet / "final.json").read_text())
        from dopt_torch.obs.aggregate import FleetAggregator

        agg = FleetAggregator(fleet)
        agg.poll()
        agg.flush_trailing()
        if agg.divergence is not None or agg.processes != [0, 1] \
                or ff["round"] != 3 or ff["report"]["verdict"] != "healthy":
            fail(f"19d: fleet final {ff['round']} "
                 f"{ff['report']['verdict']}, processes {agg.processes}, "
                 f"divergence {agg.divergence}")
        print(f"19d 2-process fleet (baseline1 at 0.05 scale, gloo, one "
              f"card): drained at round 3 in {fleet_s:.1f} s of command "
              f"time (beside 19c's CLI leg and 19e), {agg.rounds_merged} "
              f"rounds verified equal across the two streams; {smi}")
        # Phase 20c's watch, over 19a's served stream and 19d's fleet,
        # before the state dirs go.
        watch_procs = {label: subprocess.Popen(
            [sys.executable, "-m", "dopt_torch.obs.watch", *args, "--once"],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for label, args in (
                ("19a", [str(d_a / "metrics.jsonl")]),
                ("19d", ["--state-dir", str(fleet)]))}
        watch = {}
        for label, proc in watch_procs.items():
            try:
                watch[label] = (proc.communicate(timeout=120)[0],
                                proc.returncode)
            except subprocess.TimeoutExpired:
                proc.kill()
                fail(f"20c: the watch over {label} did not end")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"19: phase 19 in {time.perf_counter() - t19:.1f} s")
    return {"launch": launch, "site": site, "comm": comm, "watch": watch}


def phase20(dev, smi: str, kit) -> None:
    """Phase 20, the meters and the stream tools on the card.  ``kit``
    holds phase 5's walls and samples a round, 5d's bf16 wall, phase 6's
    profiled round (``prof6``), the telemetry streams of phase 5's and
    7b's headline runs, and phase 19's results (the wire probe's and the
    watch's outputs, run there beside the CLI leg and over its state
    dirs)."""
    import shutil
    import tempfile

    import torch

    from dopt_torch.models.zoo import init_worker_params, stacked_forward
    from dopt_torch.obs import canonical, first_divergence
    from dopt_torch.obs.regress import (append_entry, check_regression,
                                        format_report, read_ledger)
    from dopt_torch.utils.metrics import trimmed_stats
    from dopt_torch.utils.profiling import (device_peak_flops,
                                            train_flops_per_sample)

    # -- 20a. MFU of the headlines from phase 5's walls ------------------
    kind, peak = device_peak_flops()
    if kind != torch.cuda.get_device_name(0) or peak is None:
        fail(f"20a: device_peak_flops() gave ({kind!r}, {peak}) on the card")
    params = {k: v[None] for k, v in init_worker_params(
        "model1", generator=torch.Generator().manual_seed(0)).items()}
    t = time.perf_counter()
    flops = train_flops_per_sample(
        lambda p, x: stacked_forward("model1", p, x[None], faithful=True),
        params, (28, 28, 1))
    count_s = time.perf_counter() - t
    if not math.isfinite(flops) or flops <= 0:
        fail(f"20a: train_flops_per_sample(Model1) gave {flops}")
    print(f"20a Model1: {flops:.0f} train FLOPs a sample (3 × forward, "
          f"dopt's convention, counted on the CPU in {count_s:.2f} s); "
          f"peak {peak / 1e12:.0f} TFLOP/s (bf16 dense) for {kind}")
    for label, wall in (("gossip", kit.gwall), ("federated", kit.fwall)):
        per_round = wall / kit.rounds
        rate = flops * kit.samples[label] / per_round
        print(f"20a MFU {label} headline (phase {'5' if label == 'gossip' else '5b'}, "
              f"f32, eval every round): {kit.samples[label]} samples a round "
              f"(lanes × steps × batch) in {per_round:.4f} s a round = "
              f"{rate / 1e12:.4f} model TFLOP/s, mfu_vs_bf16_peak "
              f"{rate / peak:.6f}; {smi}")
    st = kit.prof6["stats"]
    busy = st["device_busy_us"] * 1e-6
    rate = flops * kit.samples["gossip"] / busy
    print(f"20a MFU gossip headline on the device basis (phase 6's "
          f"profiled round, {busy:.4f} s busy): {rate / 1e12:.4f} model "
          f"TFLOP/s, mfu_vs_bf16_peak {rate / peak:.6f}; {smi}")

    # -- 20b. the stream differ on two full-width runs -------------------
    a, b = kit.g_events, kit.b_events
    ca = canonical(a)
    if sum(e["kind"] == "round" for e in ca) != kit.rounds or not any(
            e["kind"] == "gauge" for e in ca):
        fail(f"20b: phase 5's stream holds {[e['kind'] for e in ca]}")
    div = first_divergence(a, b)
    if div is not None:
        fail(f"20b: phase 5's per-round stream and 7b's blocked stream "
             f"diverge: {div}")
    nth = 1
    gauge_at = [i for i, e in enumerate(ca) if e["kind"] == "gauge"][nth]
    mut = json.loads(json.dumps(b))
    [e for e in mut if e["kind"] == "gauge"][nth]["value"] += 1.0
    div = first_divergence(a, mut)
    if div is None or (div["index"], div["kind"], div["round"]) != (
            gauge_at, "gauge", ca[gauge_at]["round"]):
        fail(f"20b: the mutated gauge (canonical event {gauge_at}) was "
             f"reported as {div}")
    print(f"20b first_divergence: phase 5's per-round and 7b's blocked "
          f"headline-dsgd-model1 streams ({len(ca)} canonical events) "
          f"equal; one gauge changed is reported at canonical event "
          f"{div['index']} ({div['kind']} {div['a']['name']}, round "
          f"{div['round']})")

    # -- 20c. watch over 19a's stream and 19d's fleet; the ledger --------
    for label, (out, rc) in kit.res19["watch"].items():
        want = (("gauges  ", "dopt_torch watch") if label == "19a"
                else ("p0", "p1", "consistency ok"))
        if rc != 0 or not all(w in out for w in want):
            fail(f"20c: python -m dopt_torch.obs.watch --once over {label} "
                 f"exited {rc} with:\n{out[-2000:]}")
        print(f"20c watch --once over {label}: exit 0")
        for line in out.strip().splitlines():
            print(f"  {line}")
    tmp = Path(tempfile.mkdtemp(prefix="dopt-torch-ledger-"))
    try:
        led = tmp / "bench_history.jsonl"
        shutil.copy(ROOT / "results" / "bench_history.jsonl", led)
        card = torch.cuda.get_device_name(0)
        gmetric = "gossip_rounds_per_sec_dsgd_mnist_6workers_model1_bf16"
        tpu_rows = sum(e["bench"].get("metric") == gmetric
                       for e in read_ledger(led))
        gossip = {"metric": gmetric,
                  "value": kit.rounds / kit.bf16_wall, "unit": "rounds/sec",
                  "faithful_f32_rounds_per_sec": kit.rounds / kit.gwall,
                  "device_kind": card}
        fed = {"metric": "fedavg_rounds_per_sec_mnist_16lanes_model1",
               "value": kit.rounds / kit.fwall, "unit": "rounds/sec",
               "device_kind": card}
        for i, head in enumerate((gossip, fed)):
            append_entry(led, head, run_id=f"chip-smoke-{i}", sha=None)
            res = check_regression(read_ledger(led))
            if res["status"] != "no_baseline" or res["key"] != [
                    head["metric"], card] or res["n_baseline"] != 0:
                fail(f"20c: the card's first {head['metric']} entry was "
                     f"judged: {res}")
        for i in range(2):
            append_entry(led, gossip, run_id=f"chip-smoke-again-{i}",
                         sha=None)
        base = [e["bench"]["value"] for e in read_ledger(led)
                if e["bench"].get("metric") == gmetric
                and e["device_kind"] == card]
        slow = dict(gossip, value=0.8 * trimmed_stats(base)[0])
        append_entry(led, slow, run_id="chip-smoke-slow", sha=None)
        res = check_regression(read_ledger(led))
        if res["status"] != "regression" or res["checks"][0][
                "n_baseline"] != 3:
            fail(f"20c: the seeded 20% slowdown was not flagged: {res}")
        print(f"20c regress: the card's entries keyed ({gmetric!r}, "
              f"{card!r}) apart from the {tpu_rows} TPU rows of that metric "
              f"(no_baseline until three), then the seeded -20% entry:")
        for line in format_report(res).splitlines():
            print(f"  {line}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # -- 20d. the wire probe on the card against the CPU's figures --------
    rc, out, err = kit.res19["comm"]["cuda"]
    if rc != 0:
        fail(f"20d: comm_bytes --ranks 2 --device cuda exited {rc}:\n"
             f"{err[-3000:]}")
    got = json.loads(out.strip().splitlines()[-1])
    diff = {k: (got[k], v) for k, v in WIRE_2_RANKS.items() if got[k] != v}
    if diff or got["device"] == "cpu" or got["ranks"] != 2:
        fail(f"20d: the card's wire probe differs from the CPU's figures "
             f"(got, want): {diff} (device {got['device']}, ranks "
             f"{got['ranks']})")
    print(f"20d comm_bytes --ranks 2 --device cuda ({got['backend']}, "
          f"{got['device']}): equal to the CPU's 2-rank figures; plan "
          f"{got['plan_kinds']} chunk {got['plan_chunk']}, "
          f"{got['plan_dense_bytes']} dense / {got['plan_wire_bytes']} "
          f"wire B a lane, budget {got['budget_bytes']} B; all-gather "
          f"dense {got['dense']['all-gather']} B, codec "
          f"{got['codec']['by_op_dtype']['all-gather']}, scatter "
          f"reduce-scatter {got['scatter']['reduce-scatter']} B; "
          f"wire_compression {got['wire_compression']}")


def phase21(dev, smi: str, get_preset, kit) -> dict:
    """Phase 21, ``backend="torch"`` and ``stacked_impl="vmap"`` on the
    card, in the deterministic mode.  ``kit`` holds phase 5's headline
    wall and rounds and its gossip headline's History rows.  21a:
    ``baseline1`` as typed (MLP, 4 workers, dopt's full synthetic sizes)
    one round through ``build_trainer`` with ``backend="torch"`` (the
    sequential oracle: ``torch.optim.SGD`` a worker, state-dict
    consensus, no hand kernel) and one round of ``GossipTrainer`` with
    both fused switches (kernel 1 every step, kernel 2 once a round),
    from one init: History within 1e-4 test accuracy and 1e-3 train loss
    and the params within 1e-4 max-relative (dopt's own bar for its
    engine against this oracle).  21b: ``headline-dsgd-model1`` one round
    on the oracle: finite metrics, its seconds a round beside phase 5's
    and its distance from phase 5's round 0, held to the trajectory
    bound (1e-3 train loss, 1e-4 test accuracy).  21c: one full-width step of
    the gossip headline's model (6 lanes, batch 128, f32), ``"vmap"``
    against ``"auto"``: every gradient and updated tensor within 1e-5
    relative L2.  Returns 21a's stacked launches."""
    import numpy as np
    import torch

    from dopt_torch.engine import GossipTrainer
    from dopt_torch.engine import gossip as gossip_engine
    from dopt_torch.engine.local import stacked_step
    from dopt_torch.models.zoo import (deterministic, full_f32,
                                       init_worker_params, stacked_forward)
    from dopt_torch.ops.fused_update import (fused_mix_sgd,
                                             fused_sgd_momentum)
    from dopt_torch.run import build_trainer

    t21 = time.perf_counter()

    def counts() -> dict:
        return {"fused_sgd_momentum": fused_sgd_momentum.launches,
                "fused_mix_sgd": fused_mix_sgd.launches}

    def timed(tr, rounds=1) -> tuple[float, dict]:
        fused_sgd_momentum.launches = 0
        fused_mix_sgd.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        tr.run(rounds=rounds)
        torch.cuda.synchronize()
        return time.perf_counter() - t, counts()

    # -- 21a. the oracle against the stacked engine on baseline1 ---------
    cfg = get_preset("baseline1")
    oracle = build_trainer(cfg.replace(backend="torch"), device="cuda")
    if type(oracle).__name__ != "OracleGossipTrainer" or \
            oracle.device.type != "cuda":
        fail(f"21a: build_trainer(backend='torch') gave "
             f"{type(oracle).__name__} on {oracle.device}")
    owall, olaunch = timed(oracle)
    stacked = GossipTrainer(cfg.replace(
        optim=dataclasses.replace(cfg.optim, fused_update=True),
        gossip=dataclasses.replace(cfg.gossip, fused_update="on")),
        device="cuda")
    swall, launch = timed(stacked)
    want = {"fused_sgd_momentum": stacked.steps_per_round,
            "fused_mix_sgd": stacked.fused_spec.num_buckets}
    print(f"21a launches: oracle {olaunch} (expected none), stacked "
          f"{launch} (expected {want}: one kernel-1 launch a step over "
          f"{stacked.steps_per_round} steps of 4 lanes, one kernel-2 "
          f"launch a bucket a round)")
    if olaunch != {k: 0 for k in olaunch} or launch != want:
        fail(f"21a: launches oracle {olaunch}, stacked {launch} != {want}")
    (orow,), (srow,) = oracle.history.rows, stacked.history.rows
    gaps = {k: abs(orow[k] - srow[k]) for k in orow if k != "round"}
    rel = max_rel(oracle.worker_params(), stacked.worker_params())
    print(f"21a baseline1 round 0: oracle {json.dumps(orow)}; stacked "
          f"{json.dumps(srow)}; gaps {gaps}; params max-rel {rel:.3e} "
          f"(limits: test acc {ACC_TOL}, train loss {LOSS_TOL}, params "
          f"{PARAM_REL_TOL})")
    print(f"21a rates: oracle {1 / owall:.4f} rounds/s ({owall:.3f} s a "
          f"round, {len(oracle.workers)} workers stepped one after the "
          f"other), stacked {1 / swall:.4f} rounds/s ({swall:.3f} s, its "
          f"first round); {smi}")
    if not (gaps["avg_test_acc"] <= ACC_TOL
            and gaps["avg_train_loss"] <= LOSS_TOL
            and rel <= PARAM_REL_TOL):
        fail(f"21a: the oracle and the stacked engine differ: {gaps}, "
             f"params {rel:.3e}")
    del oracle, stacked

    # -- 21b. the oracle on the Model1 headline --------------------------
    cfg = get_preset("headline-dsgd-model1")
    oracle = build_trainer(cfg.replace(backend="torch"), device="cuda")
    owall, olaunch = timed(oracle)
    (orow,) = oracle.history.rows
    if any(not math.isfinite(v) for v in orow.values()) or any(
            olaunch.values()):
        fail(f"21b: {orow}, launches {olaunch}")
    ref = kit.g_rows[0]
    dist = {k: abs(orow[k] - ref[k]) for k in orow if k != "round"}
    print(f"21b headline-dsgd-model1 on the oracle: {json.dumps(orow)}; "
          f"{owall:.3f} s a round against phase 5's "
          f"{kit.gwall / kit.rounds:.3f} (both fused switches, 2 rounds); "
          f"distance from phase 5's round 0 {dist} (limits: train loss "
          f"{LOSS_TOL}, test accuracy {ACC_TOL}); {smi}")
    if not (dist["avg_train_loss"] <= LOSS_TOL
            and dist["avg_test_acc"] <= ACC_TOL):
        fail(f"21b: the oracle's round is beyond the trajectory bound of "
             f"phase 5's round 0: {dist}")
    del oracle

    # -- 21c. stacked_impl vmap against auto, one full-width step --------
    mc, d = cfg.model, cfg.data
    lanes, bs = d.num_users, cfg.gossip.local_bs
    ds = gossip_engine.load_dataset(
        d.dataset, data_dir=d.data_dir, train_size=d.synthetic_train_size,
        test_size=d.synthetic_test_size, seed=cfg.seed,
        input_shape=mc.input_shape, num_classes=mc.num_classes)
    x = torch.from_numpy(ds.train_x[:lanes * bs]).view(
        lanes, bs, *mc.input_shape).to(dev)
    y = torch.from_numpy(ds.train_y[:lanes * bs].astype(np.int64)).view(
        lanes, bs).to(dev)
    p0 = init_worker_params("model1", input_shape=mc.input_shape,
                            generator=torch.Generator().manual_seed(
                                cfg.seed))
    out = {}
    for impl in ("auto", "vmap"):
        params = {k: v.expand(lanes, *v.shape).contiguous().to(dev)
                  .requires_grad_() for k, v in p0.items()}
        moms = {k: torch.zeros_like(v) for k, v in params.items()}
        with deterministic(dev), full_f32(dev):
            stacked_step(lambda z: stacked_forward(
                "model1", params, z, faithful=mc.faithful, impl=impl),
                params, moms, x, y, torch.ones(lanes, bs, device=dev),
                lr=cfg.optim.lr, momentum=cfg.optim.momentum, fused=False)
        torch.cuda.synchronize()
        out[impl] = {**{f"grad {k}": m.cpu().numpy()
                        for k, m in moms.items()},
                     **{f"param {k}": v.detach().cpu().numpy()
                        for k, v in params.items()}}
    worst = {k: _rel_l2(out["auto"][k], out["vmap"][k]) for k in out["auto"]}
    top = max(worst.values())
    print(f"21c one Model1 step at {lanes} lanes, batch {bs}, f32: vmap "
          f"against auto, worst relative L2 {top:.3e} (limit 1e-5; "
          f"bit-identical tensors "
          f"{sum(np.array_equal(out['auto'][k], out['vmap'][k]) for k in worst)}"
          f" of {len(worst)}); {smi}")
    if not top <= 1e-5:
        fail(f"21c: vmap is beyond 1e-5 relative L2 of auto: {worst}")
    print(f"21: phase 21 in {time.perf_counter() - t21:.1f} s")
    return launch


def graphs_under_serve(root: Path, get_preset) -> None:
    """19e, CUDA graphs under ``run_served``: ``baseline1`` at 3,000/500
    samples served in blocks of 2 (a served round is ``run(rounds=1)``,
    so one round through the captured graph) with a leave at 1 and a
    join at 3: each kind is captured once and replayed after the leave
    and the join (the lane mask is data), and History and ledger equal
    the per-round served run's bit for bit."""
    from dopt_torch.serve import ServeDaemon

    gb = get_preset("baseline1")
    gb = gb.replace(data=dataclasses.replace(
        gb.data, synthetic_train_size=3000, synthetic_test_size=500))
    legs = {}
    for block in (2, 1):
        d_g = root / f"graphs{block}"
        _serve_schedule(d_g, {"leave": 1, "join": 3})
        c = gb.replace(gossip=dataclasses.replace(gb.gossip,
                                                  block_rounds=block))
        dg = ServeDaemon(c, d_g, checkpoint_every=0, max_rounds=4,
                         admin_port=None).start()
        captures = []
        cap = dg.trainer.graphs._capture

        def counted(kind, cap=cap, captures=captures):
            captures.append(kind)
            cap(kind)
        dg.trainer.graphs._capture = counted
        if dg.serve() != 0:
            fail(f"19e: block {block} did not drain")
        legs[block] = (json.loads((d_g / "final.json").read_text()),
                       captures)
    (g2, caps), (g1, caps1) = legs[2], legs[1]
    if sorted(caps) != sorted(set(caps)) or not caps or caps1:
        fail(f"19e: captures {caps} (blocked), {caps1} (per-round)")
    if g2["history"] != g1["history"] \
            or g2["fault_ledger"] != g1["fault_ledger"]:
        fail("19e: the served blocked run differs from the per-round")
    print(f"19e baseline1 (3,000/500) served in blocks of 2 (leave w3 @1, "
          f"join @3, 4 rounds): {len(caps)} capture(s) {caps}, each kind "
          "once, replayed after the leave and the join; History and "
          "ledger bit for bit the per-round served run")


class _CliLeg(threading.Thread):
    """``cli_serve`` on a thread: ``ok`` is False when it failed (its
    message printed by ``fail``)."""

    def __init__(self, state: Path, smi: str):
        super().__init__(daemon=True)
        self.args = (state, smi)
        self.ok = False

    def run(self) -> None:
        try:
            cli_serve(*self.args)
            self.ok = True
        except SystemExit:
            pass
        except Exception as e:   # reported; the phase fails on ``ok``
            print(f"FAIL: 19c CLI: {type(e).__name__}: {e}",
                  file=sys.stderr)


def cli_serve(state: Path, smi: str) -> None:
    """19c's CLI leg: ``python -m dopt_torch.serve --preset
    headline-fedavg-model1 --synthetic-scale 0.1`` on the card (full
    width, 6,000/1,000 rows: the process's control plane is under test,
    19c's in-process run serves the preset at its size) with the admin
    on port 0: GET /healthz and /metrics, POST a leave, a real SIGTERM
    once the leave is applied (the daemon drains to the next boundary,
    checkpoints and re-execs in place), the resumed process trains on
    and drains at --max-rounds."""
    import signal
    import urllib.request

    from dopt_torch.obs import JsonlSink, check_stream
    from dopt_torch.serve import ControlLedger

    def applied_leave(deadline) -> int:
        while time.perf_counter() < deadline:
            if proc.poll() is not None:
                fail(f"19c CLI: exited {proc.returncode}: "
                     f"{proc.communicate()[0][-3000:]}")
            for rec in ControlLedger.replay(state / "applied.jsonl"):
                if rec.get("cmd") == "membership" \
                        and rec.get("status") == "applied":
                    return int(rec["round"])
            time.sleep(0.05)
        fail("19c CLI: the leave was never applied")

    def status(pred, deadline):
        while time.perf_counter() < deadline:
            if proc.poll() is not None:
                fail(f"19c CLI: exited {proc.returncode}: "
                     f"{proc.communicate()[0][-3000:]}")
            try:
                st = json.loads((state / "serve.json").read_text())
                if pred(st):
                    return st
            except (OSError, ValueError):
                pass
            time.sleep(0.05)
        fail("19c CLI: timed out")

    def http(path, body=None):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}",
            data=None if body is None else json.dumps(body).encode(),
            method="GET" if body is None else "POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read().decode()

    t = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "dopt_torch.serve", "--preset",
         "headline-fedavg-model1", "--synthetic-scale", "0.1",
         "--state-dir", str(state), "--admin-port", "0", "--max-rounds", "3",
         "--checkpoint-every", "0"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        deadline = time.perf_counter() + 300
        st = status(lambda s: s["status"] == "serving"
                    and s["admin_port"], deadline)
        up = time.perf_counter() - t
        port = st["admin_port"]
        code, body = http("/healthz")
        if code != 200:
            fail(f"19c CLI: /healthz {code} {body}")
        code, _ = http("/metrics")
        if code != 200:
            fail(f"19c CLI: /metrics {code}")
        code, body = http("/admin/membership",
                          {"worker": 5, "action": "leave"})
        if code != 202:
            fail(f"19c CLI: POST leave {code} {body}")
        leave_round = applied_leave(deadline)
        pid = st["pid"]
        t_term = time.perf_counter()
        os.kill(pid, signal.SIGTERM)
        st = status(lambda s: s["restarts"] == 1
                    and s["status"] == "serving", deadline)
        back = time.perf_counter() - t_term
        if st["pid"] != pid:
            fail(f"19c CLI: re-exec changed the pid {pid} -> {st['pid']}")
        port = st["admin_port"]
        code, body = http("/healthz")
        if code != 200:
            fail(f"19c CLI: /healthz after the re-exec {code} {body}")
        out = proc.communicate(timeout=max(deadline - time.perf_counter(),
                                           1))[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    if proc.returncode != 0 or "re-exec for rolling restart" not in out:
        fail(f"19c CLI: exit {proc.returncode}: {out[-3000:]}")
    final = json.loads((state / "final.json").read_text())
    events = JsonlSink.read(state / "metrics.jsonl")
    summary = check_stream(events)
    ctl = [r for r in final["fault_ledger"] if r["kind"] == "control"]
    if final["restarts"] != 1 or final["round"] != 3 \
            or final["report"]["verdict"] != "healthy" \
            or [(r["worker"], r["action"]) for r in ctl] != [
                (5, "applied_membership_leave")] \
            or summary["rounds"] != 3:
        fail(f"19c CLI: final {final['round']} restarts "
             f"{final['restarts']}, control {ctl}, stream {summary}")
    for row in final["history"]:
        if not math.isfinite(row["train_loss"]):
            fail(f"19c CLI: non-finite loss {row}")
    print(f"19c CLI python -m dopt_torch.serve --preset "
          f"headline-fedavg-model1 --synthetic-scale 0.1: serving in "
          f"{up:.1f} s, leave over POST applied at round {leave_round}, "
          f"SIGTERM then -> re-exec (same pid) serving again in "
          f"{back:.1f} s, drained at round 3 (restarts 1, healthy, "
          f"{summary['rounds']} rounds in a clean stream) in "
          f"{time.perf_counter() - t:.1f} s; {smi}")


def _resnet_grads_f64(p0: dict, x, y) -> dict:
    """One worker's ResNet-18 gradients of the mean cross-entropy over
    ``x`` ([B, H, W, C]) in float64 on the CPU, written out apart from
    the port's forward (flax's GroupNorm: eps 1e-6, biased variance;
    XLA's 'SAME' padding, (0, 1) for a stride-2 3×3 conv of an even
    axis): the reference the f32 steps are read against."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    p = {k: v.double().clone().requires_grad_() for k, v in p0.items()}

    def conv(z, name, stride=1):
        k = p[name]
        size, kk = z.shape[-1], k.shape[-1]
        total = max((-(-size // stride) - 1) * stride + kk - size, 0)
        lo, hi = total // 2, total - total // 2
        return F.conv2d(F.pad(z, (lo, hi, lo, hi)), k, stride=stride)

    def gn(z, prefix):
        b, c = z.shape[:2]
        zg = z.reshape(b, min(32, c), -1)
        mean = zg.mean(-1, keepdim=True)
        var = ((zg - mean) ** 2).mean(-1, keepdim=True)
        z = ((zg - mean) / torch.sqrt(var + 1e-6)).reshape(z.shape)
        return (z * p[f"{prefix}.scale"].view(1, c, 1, 1)
                + p[f"{prefix}.bias"].view(1, c, 1, 1))

    z = F.relu(gn(conv(x.double().permute(0, 3, 1, 2), "Conv_0.weight"),
                  "GroupNorm_0"))
    k = 0
    while f"ResidualBlock_{k}.Conv_0.weight" in p:
        blk = f"ResidualBlock_{k}"
        proj = f"{blk}.Conv_2.weight" in p
        s = 2 if proj else 1
        h = F.relu(gn(conv(z, f"{blk}.Conv_0.weight", s),
                      f"{blk}.GroupNorm_0"))
        h = gn(conv(h, f"{blk}.Conv_1.weight"), f"{blk}.GroupNorm_1")
        if proj:
            z = gn(conv(z, f"{blk}.Conv_2.weight", s), f"{blk}.GroupNorm_2")
        z = F.relu(h + z)
        k += 1
    logits = F.linear(z.mean((2, 3)), p["head.weight"], p["head.bias"])
    nll = -torch.log_softmax(logits, -1).gather(-1, y[:, None]).squeeze(-1)
    grads = torch.autograd.grad(nll.mean(), list(p.values()))
    return {k: g.numpy().astype(np.float64) for k, g in zip(p, grads)}


def _conv_kernels(prof) -> list[str]:
    """The conv and GEMM kernels of a profiler window, by device time."""
    evs = [e for e in prof.key_averages()
           if getattr(e, "device_time_total", 0) > 0]
    return [f"{e.key[:110]} ({e.count}x, {e.device_time_total / 1e3:.3f} ms)"
            for e in sorted(evs, key=lambda e: -e.device_time_total)
            if re.search(r"conv|xmma|cudnn|cutlass|winograd|implicit|gemm|"
                         r"Transpose|dgrad|wgrad", e.key)]


def _resnet_b5_inputs(get_preset) -> dict:
    """ResNet-18's f32 step at ``baseline5``'s full size: 32 lanes, batch
    128 a lane, 32×32×3, the corrected head, lr 0.1 and momentum 0.9,
    from one init (``init_worker_params`` seeded with the preset's seed,
    every lane the same) and one batch (the first 32×128 training
    samples; lane 0 takes the first 128)."""
    import numpy as np
    import torch

    from dopt_torch.engine import gossip as gossip_engine
    from dopt_torch.models.zoo import init_worker_params

    cfg = get_preset("baseline5")
    mc, d = cfg.model, cfg.data
    lanes, bs = d.num_users, cfg.gossip.local_bs
    ds = gossip_engine.load_dataset(
        d.dataset, data_dir=d.data_dir, train_size=d.synthetic_train_size,
        test_size=d.synthetic_test_size, seed=cfg.seed,
        input_shape=mc.input_shape, num_classes=mc.num_classes)
    x = torch.from_numpy(ds.train_x[:lanes * bs]).view(lanes, bs,
                                                       *mc.input_shape)
    y = torch.from_numpy(ds.train_y[:lanes * bs].astype(np.int64)).view(
        lanes, bs)
    p0 = init_worker_params("resnet18", input_shape=mc.input_shape,
                            generator=torch.Generator().manual_seed(
                                cfg.seed))
    return {"cfg": cfg, "lanes": lanes, "bs": bs, "p0": p0, "x": x, "y": y}


def _resnet_b5_step(inp: dict, device, n: int, prof: bool = False):
    """One step of ``_resnet_b5_inputs``' lanes 0..n-1 on ``device``
    through ``stacked_step`` with the plain update under the
    deterministic mode and ``full_f32``.  Returns lane 0's gradients (the
    momentum after one step from zero) and updated values, and with
    ``prof`` the conv kernels the profiler saw."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    from dopt_torch.engine.local import stacked_step
    from dopt_torch.models.zoo import deterministic, full_f32, stacked_forward

    cfg, p0, x, y, bs = (inp[k] for k in ("cfg", "p0", "x", "y", "bs"))
    device = torch.device(device)
    # A copy even at one lane, where expand().contiguous() would be a view
    # of p0 that the step updates in place.
    params = {k: v.expand(n, *v.shape).clone(
        memory_format=torch.contiguous_format).to(device).requires_grad_()
        for k, v in p0.items()}
    moms = {k: torch.zeros_like(v) for k, v in params.items()}
    args = (x[:n].to(device), y[:n].to(device),
            torch.ones(n, bs, device=device))
    ctx = (profile(activities=[ProfilerActivity.CUDA]) if prof
           else contextlib.nullcontext())
    with deterministic(device), full_f32(device), ctx as p:
        stacked_step(lambda z: stacked_forward(
            "resnet18", params, z, faithful=cfg.model.faithful), params,
            moms, *args, lr=cfg.optim.lr, momentum=cfg.optim.momentum,
            fused=False)
        if device.type == "cuda":
            torch.cuda.synchronize()
    out = {**{f"grad {k}": m[0].cpu().numpy() for k, m in moms.items()},
           **{f"param {k}": v[0].detach().cpu().numpy()
              for k, v in params.items()}}
    return out, (_conv_kernels(p) if prof else [])


def _resnet_b5_cpu(get_preset) -> dict:
    """``_resnet_b5_inputs`` and the CPU's step of lane 0 alone, with its
    seconds (``cpu``, ``cpu_s``)."""
    inp = _resnet_b5_inputs(get_preset)
    t = time.perf_counter()
    inp["cpu"], _ = _resnet_b5_step(inp, "cpu", 1)
    inp["cpu_s"] = time.perf_counter() - t
    return inp


def _resnet_b5_steps(dev, get_preset, cpu: dict | None = None) -> dict:
    """ResNet-18's f32 step at ``baseline5``'s full size on the card and
    on the CPU (``_resnet_b5_inputs``): the CPU steps lane 0 alone (or
    ``cpu``, ``_resnet_b5_cpu``'s result, is taken as it), the card
    steps 32 lanes twice, the second under the profiler.  Returns lane
    0's gradients and updated values on each side, the profiler's conv
    kernels, the init and the batch."""
    r = dict(cpu or _resnet_b5_cpu(get_preset))
    t = time.perf_counter()
    r["card"], _ = _resnet_b5_step(r, dev, r["lanes"])
    r["card_s"] = time.perf_counter() - t
    r["again"], r["names"] = _resnet_b5_step(r, dev, r["lanes"], prof=True)
    return r


def phase22b(dev, smi: str, get_preset, pre: dict | None = None) -> dict:
    """Phase 22b, ResNet-18's f32 step at ``baseline5``'s full size on
    the card against the port's CPU step, as 4c holds Model1's
    (``_resnet_b5_steps``; on the CPU one lane equals lane 0 of many bit
    for bit, tests/test_torch_library.py).  The card's two 32-lane steps
    must be bit-identical; lane 0's 62 gradients and 62 updated
    parameters are each held to 1e-5 relative L2 of the CPU's (max-rel
    printed), and the conv kernels the card ran are named from the
    profiler.  A miss prints each side's distance from lane 0's f64
    gradients.  ``pre`` is the CPU step phase 23 took while its
    subprocess legs ran (``_resnet_b5_cpu``).  Returns
    ``_resnet_b5_steps``' result for 22a."""
    import numpy as np

    t22 = time.perf_counter()
    r = _resnet_b5_steps(dev, get_preset, pre)
    cpu, card, lanes = r["cpu"], r["card"], r["lanes"]
    print(f"22b the CPU step at 1 lane (ResNet-18, "
          f"{r['cfg'].model.input_shape}, batch {r['bs']}): "
          f"{r['cpu_s']:.1f} s"
          + (" (taken in phase 23, beside its subprocess legs)" if pre
             else ""))
    if any(not np.array_equal(card[k], r["again"][k]) for k in card):
        fail(f"22b: two card steps at {lanes} lanes differ")
    print(f"22b the card's step at {lanes} lanes: {r['card_s']:.2f} s; run "
          "twice, bit-identical")
    worst, bad = {}, []
    for key in card:
        want, got = cpu[key], card[key]
        l2 = _rel_l2(want, got)
        kind = key.split()[0]
        worst[kind] = max(worst.get(kind, 0.0), l2)
        print(f"22b lane 0 of {lanes}, {key}: relative L2 {l2:.3e}, max-rel "
              f"{_elem_rel(want, got):.3e}")
        if not l2 <= 1e-5:
            bad.append(f"{key} {l2:.3e}")
    print(f"22b the conv and GEMM kernels the card ran at {lanes} lanes:")
    for name in r["names"]:
        print(f"    {name}")
    if bad:
        f64 = _resnet_grads_f64(r["p0"], r["x"][0], r["y"][0])
        for key in card:
            kind, name = key.split()
            if kind == "grad":
                print(f"22b against f64, {name}: card "
                      f"{_rel_l2(f64[name], card[key]):.3e}, CPU "
                      f"{_rel_l2(f64[name], cpu[key]):.3e}")
    print(f"22b ResNet-18's step at baseline5's size, lane 0 of the card's "
          f"{lanes} against the CPU's 1 lane: worst relative L2 "
          f"{ {k: f'{v:.3e}' for k, v in worst.items()} } (limit 1e-5) on "
          f"{len(card)} tensors; 22b in {time.perf_counter() - t22:.1f} s; "
          f"{smi}")
    if bad:
        fail(f"22b: the card's step is beyond 1e-5 relative L2 of the "
             f"CPU's: {bad}")
    return r


# One arm of ``--resnet-ab``: ``python3 -c _AB_ARM TREE SCRIPT LABEL
# STEPS`` imports ``dopt_torch`` from TREE, then this script's
# functions, and runs ``resnet_ab_arm``.
_AB_ARM = """
import importlib.util, sys
tree, script, label, steps = sys.argv[1:]
sys.path.insert(0, tree)
import dopt_torch
spec = importlib.util.spec_from_file_location("chip_smoke_ab", script)
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
mod.resnet_ab_arm(label, tree, steps == "1")
"""


def resnet_ab(parent: str) -> None:
    """``python3 chip_smoke.py --resnet-ab DIR``: ResNet-18's f32 training
    arithmetic in this tree against DIR's, a checkout of the parent
    commit (``git archive`` unpacked into a directory that .gitignore
    lists), on one card in one call.  Each arm is a process of its own
    that imports its tree's ``dopt_torch`` (``resnet_ab_arm``), in the
    order DIR, this tree, this tree, DIR; the first arm of each tree also
    takes phase 22b's steps.  Prints each tree's mean second round of
    ``baseline5`` with both fused switches and the ratio of this tree's
    to DIR's."""
    here = ROOT / "chip_smoke.py"
    smi = nvidia_smi()
    walls: dict = {"parent": [], "this": []}
    for i, (label, tree) in enumerate((("parent", parent), ("this", ROOT),
                                       ("this", ROOT), ("parent", parent))):
        r = subprocess.run(
            [sys.executable, "-c", _AB_ARM, str(Path(tree).resolve()),
             str(here), label, "1" if i < 2 else "0"],
            cwd=tree, capture_output=True, text=True, timeout=900)
        print(r.stdout, end="", flush=True)
        if r.returncode:
            print(r.stderr[-4000:], file=sys.stderr)
            fail(f"resnet-ab: the {label} arm exited {r.returncode}")
        walls[label].append(json.loads(r.stdout.splitlines()[-1])["walls"])
    # Each arm's second round (its first takes the arm's first calls).
    this = sum(w[1] for w in walls["this"]) / 2
    base = sum(w[1] for w in walls["parent"]) / 2
    print(f"resnet-ab baseline5 f32 round: this tree {this:.3f} s, parent "
          f"{base:.3f} s, this/parent {this / base:.4f}; {smi}")


def resnet_ab_arm(label: str, tree: str, steps: bool) -> None:
    """One arm of ``--resnet-ab``, in a process whose ``dopt_torch`` is
    ``tree``'s.  With ``steps``: phase 22b's steps (``_resnet_b5_steps``)
    and the card's lane 0 and the CPU's against each other and against
    lane 0's f64 gradients (the worst tensor, the tensors beyond 1e-5,
    each conv's weight gradient).  Then a fresh ``baseline5`` trainer
    with both fused switches takes rounds 1 and 2 (no eval, as 13a),
    timed, with the peak over what was held before it.  The last line is
    ``{"walls": [...]}``."""
    import dopt_torch
    import torch

    from dopt_torch.engine import GossipTrainer
    from dopt_torch.ops import _build
    from dopt_torch.presets import get_preset

    if not Path(dopt_torch.__file__).resolve().is_relative_to(
            Path(tree).resolve()):
        fail(f"resnet-ab {label}: dopt_torch is {dopt_torch.__file__}, "
             f"not {tree}'s")
    smi = nvidia_smi()
    dev = torch.device("cuda")
    _build.build()
    _build.load_library()
    if steps:
        r = _resnet_b5_steps(dev, get_preset)
        f64 = _resnet_grads_f64(r["p0"], r["x"][0], r["y"][0])
        grads = [k for k in r["card"] if k.startswith("grad")]
        for side in ("card", "cpu"):
            worst = max(_rel_l2(f64[k.split()[1]], r[side][k]) for k in grads)
            print(f"resnet-ab {label}: {side} against f64, worst gradient "
                  f"relative L2 {worst:.3e}")
        l2 = {k: _rel_l2(r["cpu"][k], r["card"][k]) for k in r["card"]}
        over = sorted(k for k, v in l2.items() if v > 1e-5)
        print(f"resnet-ab {label}: card vs CPU at {r['lanes']} lanes, worst "
              f"relative L2 {max(l2.values()):.3e}; {len(over)} of "
              f"{len(l2)} tensors beyond 1e-5: {over}; card step "
              f"{r['card_s']:.2f} s; {smi}")
        print(f"resnet-ab {label}: conv weight gradients, card vs CPU: "
              + ", ".join(f"{k.split()[1]} {v:.3e}" for k, v in l2.items()
                          if k.startswith("grad") and "Conv" in k))
        print(f"resnet-ab {label}: the conv and GEMM kernels of the card's "
              f"step at {r['lanes']} lanes:")
        for name in r["names"]:
            print(f"    {name}")
        del r
    b5 = get_preset("baseline5")
    cfg = b5.replace(optim=dataclasses.replace(b5.optim, fused_update=True),
                     gossip=dataclasses.replace(b5.gossip,
                                                fused_update="on"))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tr = GossipTrainer(cfg, device=dev, eval_every=10 ** 9)
    tr.round = 1
    got = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        tr.run(rounds=1)
        torch.cuda.synchronize()
        got.append(time.perf_counter() - t)
    print(f"resnet-ab baseline5 f32, both fused switches, {label}: round "
          f"walls {got} s; peak "
          f"{torch.cuda.max_memory_allocated() - base} B over what was "
          f"held; {smi}")
    print(json.dumps({"walls": got}))


# Phase 22a's models: each at its preset's width and input.
LIBRARY_PRESETS = {"model1": "headline-dsgd-model1", "model3": "baseline2",
                   "mlp": "baseline1", "logistic": "baseline4",
                   "resnet18": "baseline5"}


def phase22(dev, smi: str, get_preset, kit) -> dict:
    """Phase 22, dopt's library surface on the card.  22b first
    (``phase22b``).  22a: for each zoo model at its preset's width and
    input (``LIBRARY_PRESETS``), batch 128, f32 under the deterministic
    mode and ``full_f32``: ``build_model`` on the card, three SGD steps
    of ``cross_entropy`` → autograd → ``fused_sgd_momentum_tree`` (kernel
    1, its launches counted: a launch per 16 tensors a step), bit for bit
    the same steps through kernel 1's plain version on the card; the
    first step held to 1e-5 relative L2 a tensor (gradient and updated
    value) of ``build_model``'s CPU step on the same init and batch
    (ResNet-18's: 22b's CPU lane, 22b's init and lane-0 batch, so this
    is also 22b's one-worker library check), and ``accuracy`` after it
    equal on both.  Inputs are normal draws from a seed (ResNet-18's:
    22b's batches).  22c: kernel 1 at the new call site, the tree wrapper
    over one model's tensors, against its plain version, bit for bit, and
    timed on the device alone (``event_ms``'s ``device_only``: cold L2,
    the median of 25) beside the plain version, ``SGD(fused=True).step``
    and the bytes bound.  ``kit`` holds the L2 flush buffer and phase
    23's CPU step for 22b (``resnet_cpu``).  Returns each model's
    launches and timing row."""
    import numpy as np
    import torch

    import dopt_torch
    from dopt_torch.models import accuracy, cross_entropy
    from dopt_torch.models.zoo import deterministic, full_f32
    from dopt_torch.ops.fused_update import (fused_mix_sgd,
                                             fused_sgd_momentum,
                                             fused_sgd_momentum_tree,
                                             sgd_momentum_reference)
    from dopt_torch.optim import init_sgd

    t22 = time.perf_counter()
    res22b = phase22b(dev, smi, get_preset, kit.resnet_cpu)
    cpu_dev = torch.device("cpu")
    rng = np.random.default_rng(22)

    def run(name, cfg, device, batches, steps, fused):
        """``steps`` library steps of zoo model ``name`` on ``device``
        from the seeded init (ResNet-18: 22b's); returns the first
        step's gradients and values, its accuracy and the final state."""
        mc = cfg.model
        model = dopt_torch.build_model(
            name, num_classes=mc.num_classes, faithful=mc.faithful,
            input_shape=mc.input_shape, device=device,
            generator=torch.Generator().manual_seed(cfg.seed))
        params = dict(model.named_parameters())
        if name == "resnet18":
            with torch.no_grad():
                for k, v in params.items():
                    v.copy_(res22b["p0"][k])
        moms = init_sgd(params).momentum
        first = None
        with deterministic(device), full_f32(device):
            for t, (x, y) in enumerate(batches[:steps]):
                x, y = x.to(device), y.to(device)
                loss = cross_entropy(model(x), y)
                grads = dict(zip(params, torch.autograd.grad(
                    loss, list(params.values()))))
                if fused:
                    fused_sgd_momentum_tree(params, moms, grads,
                                            lr=cfg.optim.lr,
                                            mu=cfg.optim.momentum)
                else:
                    sgd_momentum_reference(
                        list(params.values()), [moms[k] for k in params],
                        [grads[k] for k in params], lr=cfg.optim.lr,
                        momentum=cfg.optim.momentum)
                if t == 0:
                    with torch.no_grad():
                        acc = float(accuracy(model(x), y))
                    first = {**{f"grad {k}": g.cpu().numpy()
                                for k, g in grads.items()},
                             **{f"param {k}": v.detach().cpu().numpy()
                                for k, v in params.items()}}
        if device.type == "cuda":
            torch.cuda.synchronize()
        final = {**{f"mom {k}": m.cpu().numpy() for k, m in moms.items()},
                 **{f"param {k}": v.detach().cpu().numpy()
                    for k, v in params.items()}}
        return first, acc, final, len(params)

    # -- 22a. the library path at full width ------------------------------
    out: dict = {}
    for name, preset in LIBRARY_PRESETS.items():
        t = time.perf_counter()
        cfg = get_preset(preset)
        mc = cfg.model
        if name == "resnet18":
            batches = [(res22b["x"][i], res22b["y"][i]) for i in range(3)]
        else:
            batches = [(torch.from_numpy(rng.standard_normal(
                (128, *mc.input_shape), dtype=np.float32)),
                torch.from_numpy(rng.integers(0, mc.num_classes, 128)))
                for _ in range(3)]
        fused_sgd_momentum.launches = 0
        fused_mix_sgd.launches = 0
        first, acc, final, n = run(name, cfg, dev, batches, 3, True)
        launches = {"fused_sgd_momentum": fused_sgd_momentum.launches,
                    "fused_mix_sgd": fused_mix_sgd.launches}
        want = {"fused_sgd_momentum": 3 * -(-n // 16), "fused_mix_sgd": 0}
        if launches != want:
            fail(f"22a {name}: launches {launches}, expected {want} (3 steps "
                 f"over {n} tensors)")
        _, plain_acc, plain, _ = run(name, cfg, dev, batches, 3, False)
        if any(not np.array_equal(final[k], plain[k]) for k in final) or \
                plain_acc != acc:
            fail(f"22a {name}: the kernel's 3 steps differ from the plain "
                 "update's")
        if name == "resnet18":
            cpu = res22b["cpu"]
            model = dopt_torch.build_model(name, input_shape=mc.input_shape,
                                           device=cpu_dev)
            with torch.no_grad(), full_f32(cpu_dev):
                for k, v in model.named_parameters():
                    v.copy_(torch.from_numpy(cpu[f"param {k}"]))
                cpu_acc = float(accuracy(model(batches[0][0]),
                                         batches[0][1]))
            del model
        else:
            cpu, cpu_acc, _, _ = run(name, cfg, cpu_dev, batches, 1, False)
        worst = {k: _rel_l2(cpu[k], first[k]) for k in first}
        top = max(worst.values())
        label = ("22a resnet18 (and 22b's one-worker library step)"
                 if name == "resnet18" else f"22a {name}")
        print(f"{label} at {preset}'s width, {mc.input_shape}, batch 128: "
              f"3 steps, kernel 1 {launches['fused_sgd_momentum']} launches "
              f"over {n} tensors, bit for bit the plain update's; step 1 "
              f"against the CPU's: worst relative L2 {top:.3e} (limit 1e-5; "
              f"max-rel {max(_elem_rel(cpu[k], first[k]) for k in first):.3e}"
              f"); accuracy after it: card {acc}, CPU {cpu_acc}; "
              f"{time.perf_counter() - t:.1f} s")
        if not top <= 1e-5:
            fail(f"22a {name}: step 1 beyond 1e-5 of the CPU's: "
                 f"{ {k: v for k, v in worst.items() if v > 1e-5} }")
        if abs(cpu_acc - acc) > ACC_TOL:
            fail(f"22a {name}: accuracy {acc} on the card, {cpu_acc} on the "
                 "CPU")
        out[name] = {"launches": launches, "tensors": n}

    # -- 22c. kernel 1 at the new call site, timed ------------------------
    gen = torch.Generator(device=dev).manual_seed(22)
    lr1, mu1 = 0.01, 0.5

    def device_ms(fn) -> float:
        return event_ms(fn, kit.flush, device_only=True)

    for name, preset in LIBRARY_PRESETS.items():
        mc = get_preset(preset).model
        model = dopt_torch.build_model(name, num_classes=mc.num_classes,
                                       input_shape=mc.input_shape, device=dev)
        shapes = {k: v.shape for k, v in model.named_parameters()}
        del model

        def draw():
            return {k: torch.randn(s, device=dev, generator=gen)
                    for k, s in shapes.items()}

        p, m, g = draw(), draw(), draw()
        pk = {k: v.clone() for k, v in p.items()}
        mk = {k: v.clone() for k, v in m.items()}
        fused_sgd_momentum_tree(pk, mk, g, lr=lr1, mu=mu1)
        pr = [v.clone() for v in p.values()]
        mr = [v.clone() for v in m.values()]
        sgd_momentum_reference(pr, mr, list(g.values()), lr=lr1,
                               momentum=mu1)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max())
                  for a, b in zip(list(pk.values()) + list(mk.values()),
                                  pr + mr))
        if err != 0.0:
            fail(f"22c {name}: the tree wrapper differs from the plain "
                 f"version by {err:.3e}")
        row = {"ms": device_ms(lambda: fused_sgd_momentum_tree(
                   p, m, g, lr=lr1, mu=mu1)),
               "plain_ms": device_ms(lambda: sgd_momentum_reference(
                   list(p.values()), list(m.values()), list(g.values()),
                   lr=lr1, momentum=mu1)),
               "max_abs_err": err}
        lp = [v.clone().requires_grad_() for v in p.values()]
        for v, gr in zip(lp, g.values()):
            v.grad = gr.clone()
        opt = torch.optim.SGD(lp, lr=lr1, momentum=mu1, fused=True)
        row["library_ms"] = device_ms(opt.step)
        elems = sum(v.numel() for v in p.values())
        row["bound_ms"], row["bound_by"] = bound_ms(20 * elems, 4 * elems)
        out[name]["row"] = row
        print(f"22c time fused_sgd_momentum_tree {name} (one model, "
              f"{len(shapes)} tensors, {elems} f32): kernel "
              f"{1e3 * row['ms']:.1f} us, plain {1e3 * row['plain_ms']:.1f} "
              f"us, SGD(fused=True) {1e3 * row['library_ms']:.1f} us (device "
              f"time alone, each), bound {1e3 * row['bound_ms']:.1f} us "
              f"({row['bound_by']}); bit-identical to the plain version; "
              f"{smi}")
    print(f"22: phase 22 in {time.perf_counter() - t22:.1f} s")
    return out


# Phase 23d's serve soak: dopt's single-host acceptance leg at half its
# README's 48 rounds (cut for the budget; the same leave, SIGTERM, lr
# rebuild and join, at rounds 6, 9, 12 and 15).
SERVE_SOAK_ROUNDS = 24


def phase23_window(dev, smi: str) -> dict:
    """Phase 23's part in phase 19's shared window, where no phase's timed
    number is taken (phase 19 calls it once its own subprocesses run):
    23d ``python -m dopt_torch.scripts.serve_soak --rounds 24`` started as
    a subprocess logging to a file (``phase23`` collects it; a process
    still running when the script exits is killed); then, on this thread,
    23a ``chaos_soak.main(["--rounds", "8", "--seed", "0", ...])``, the
    four cocktail legs and both monitor gates, and ``python -m
    dopt_torch.obs.check`` on its ``--metrics-out``; 23c each leg's
    8-round continuous run on the card against the port's CPU run of the
    same leg (ledger row for row, History within LOSS_TOL/ACC_TOL); 23b
    ``chaos_soak.main(["--rounds", "8", "--engine", "gossip", "--kill",
    "--skip-gates"])`` (a real SIGKILLed child, the only new
    interpreter).  Every wall here is taken beside the window's
    subprocesses.  The soaks run at dopt's settings (both fused switches
    off), so kernel 1 and kernel 2 must launch 0 times.  Returns what
    ``phase23`` collects and the walls."""
    import atexit
    import tempfile

    import torch

    from dopt_torch.ops.fused_update import (fused_mix_sgd,
                                             fused_sgd_momentum,
                                             launch_counts)
    from dopt_torch.scripts import chaos_soak as cs

    out = Path(tempfile.mkdtemp(prefix="dopt-torch-soak-"))
    log = open(out / "23d.log", "w")
    t_d = time.perf_counter()
    serve = subprocess.Popen(
        [sys.executable, "-m", "dopt_torch.scripts.serve_soak", "--rounds",
         str(SERVE_SOAK_ROUNDS), "--state-root", str(out / "serve"),
         "--report-out", str(out / "serve-report.json")],
        cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    ends: dict = {}

    def waiter() -> None:
        serve.wait()
        ends["23d"] = time.perf_counter()

    threading.Thread(target=waiter, daemon=True).start()

    def stop() -> None:
        if serve.poll() is None:
            serve.kill()
            serve.wait()

    atexit.register(stop)
    t23 = time.perf_counter()

    # -- 23a. the chaos soak in-process: every leg's wall and its
    # continuous trainer (the first one the leg builds) recorded.
    walls: dict[str, float] = {}
    reports: dict = {}
    conts: dict = {}
    soak_one, build_trainer = cs.soak_one, cs.build_trainer

    def timed_soak(engine, *args, **kw):
        t = time.perf_counter()
        reports[engine] = soak_one(engine, *args, **kw)
        walls[engine] = time.perf_counter() - t
        return reports[engine]

    def first_trainer(engine, *args, **kw):
        tr = build_trainer(engine, *args, **kw)
        conts.setdefault(engine, tr)
        return tr

    cs.soak_one, cs.build_trainer = timed_soak, first_trainer
    metrics, report = out / "chaos-metrics.jsonl", out / "chaos.json"
    fused_sgd_momentum.launches = 0
    fused_mix_sgd.launches = 0
    t = time.perf_counter()
    try:
        rc = cs.main(["--rounds", "8", "--seed", "0",
                      "--metrics-out", str(metrics),
                      "--report-out", str(report)])
    except AssertionError as e:
        fail(f"23a: the chaos soak failed: {e}")
    finally:
        cs.soak_one, cs.build_trainer = soak_one, build_trainer
    torch.cuda.synchronize()
    wall_a = time.perf_counter() - t
    got = launch_counts()
    if rc != 0:
        fail(f"23a: chaos_soak.main returned {rc}")
    if got != {"fused_sgd_momentum": 0, "fused_mix_sgd": 0}:
        fail(f"23a: launches {got}; the soaks run both fused switches "
             "off, so neither kernel may launch")
    for leg, tr in conts.items():
        if tr.device.type != "cuda":
            fail(f"23a {leg}: the soak ran on {tr.device}")
        print(f"23a chaos soak {leg}: {walls[leg]:.2f} s (continuous, "
              f"rerun, blocked in blocks of 4, killed after round 4 "
              f"and resumed: 8 rounds each); {len(tr.history.faults)} "
              f"ledger rows; {reports[leg].alerts} alerts, verdict "
              f"{reports[leg].verdict}; {smi}")
    print(f"23a chaos soak: 4 legs and both gates in {wall_a:.2f} s "
          f"(the gates {wall_a - sum(walls.values()):.2f} s); launches "
          f"{got}; every 23a-23c wall taken in phase 19's shared window, "
          f"beside its subprocesses; {smi}")
    check = subprocess.Popen(
        [sys.executable, "-m", "dopt_torch.obs.check", str(metrics)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)

    # -- 23c. each leg's continuous run on the card against the port's
    # CPU run of the same leg.
    for leg, tr in conts.items():
        t = time.perf_counter()
        cpu = build_trainer(leg, 0, 8, device="cpu")
        cpu.run(rounds=8)
        cpu_s = time.perf_counter() - t
        if cpu.history.faults != tr.history.faults:
            fail(f"23c {leg}: the card's fault ledger differs from the "
                 "CPU's")
        key = cs.loss_key(tr.history)
        acc = ("avg_test_acc" if "avg_test_acc" in tr.history.rows[0]
               else "test_acc")
        dl = da = 0.0
        for a, b in zip(cpu.history.rows, tr.history.rows, strict=True):
            dl = max(dl, abs(a[key] - b[key]))
            da = max(da, abs(a[acc] - b[acc]))
        if not (dl <= LOSS_TOL and da <= ACC_TOL):
            fail(f"23c {leg}: History {key} {dl:.3e} / {acc} "
                 f"{da:.3e} from the CPU's (limits {LOSS_TOL} / "
                 f"{ACC_TOL})")
        print(f"23c {leg}: 8 rounds on the card against the CPU "
              f"({cpu_s:.2f} s there): {len(tr.history.faults)} ledger "
              f"rows equal; worst {key} {dl:.3e}, {acc} {da:.3e} "
              f"(limits {LOSS_TOL} / {ACC_TOL}); {smi}")
    del conts, reports

    # -- 23b. the real SIGKILL: the gossip leg's kill-and-resume through
    # a SIGKILLed child process.
    (out / "kill").mkdir()
    t = time.perf_counter()
    try:
        rc = cs.main(["--rounds", "8", "--engine", "gossip", "--kill",
                      "--skip-gates", "--ckpt-dir", str(out / "kill")])
    except AssertionError as e:
        fail(f"23b: the SIGKILL leg failed: {e}")
    wall_b = time.perf_counter() - t
    if rc != 0:
        fail(f"23b: chaos_soak.main returned {rc}")
    if launch_counts() != got:
        fail(f"23b-23c: launches {launch_counts()}, expected {got}")
    print(f"23b SIGKILL leg: {wall_b:.2f} s (the leg's runs and a child "
          f"started, SIGKILLed after round 4 and resumed); launches "
          f"{launch_counts()}; {smi}")
    cout, _ = check.communicate(timeout=120)
    if check.returncode != 0:
        fail(f"23a: dopt_torch.obs.check on the soak's stream exited "
             f"{check.returncode}: {cout}")
    print(f"23a obs.check: {cout.strip().splitlines()[-1]}")
    return {"out": out, "serve": (serve, log, t_d), "ends": ends,
            "walls": {"23a": wall_a, "23b": wall_b, "legs": walls,
                      "window": time.perf_counter() - t23}}


def phase23(dev, smi: str, get_preset, w: dict) -> dict:
    """Phase 23, after phase 20: dopt's acceptance harnesses' part that
    ``phase23_window`` left running.  While 23d (``python -m
    dopt_torch.scripts.serve_soak``: real daemons on the card, a SIGTERM
    re-exec, bit for bit the uninterrupted leg) finishes, phase 22b's
    CPU step (``_resnet_b5_cpu``); then 23d is collected.  Returns the
    walls and 22b's CPU step (``resnet_cpu``)."""
    import shutil

    t23 = time.perf_counter()
    out, (serve, log, t_d) = w["out"], w["serve"]
    try:
        beside = "23d" if serve.poll() is None else "none"
        t = time.perf_counter()
        resnet_cpu = _resnet_b5_cpu(get_preset)
        cpu_s = time.perf_counter() - t
        print(f"23: phase 22b's inputs and CPU step (ResNet-18 at "
              f"baseline5's size, lane 0) in {cpu_s:.1f} s (the step "
              f"{resnet_cpu['cpu_s']:.1f} s), begun beside the subprocess "
              f"legs {beside}")
        try:
            rc = serve.wait(timeout=max(30.0, 600 - (time.perf_counter()
                                                     - t_d)))
        except subprocess.TimeoutExpired:
            serve.kill()
            serve.wait()
            rc = "timeout"
        log.close()
        wall_d = w["ends"].get("23d", time.perf_counter()) - t_d
        # The harness's own lines (the daemons' logs go there too).
        text = (out / "23d.log").read_text(errors="replace")
        lines = [line for line in text.splitlines()
                 if line.startswith(("[", "serve soak"))]
        for line in lines:
            print(f"23d | {line}")
        if rc != 0 or not any(line.startswith("serve soak passed")
                              for line in lines):
            print(text[-4000:], file=sys.stderr)
            fail(f"23d: python -m dopt_torch.scripts.serve_soak exited {rc}")
        serve_report = json.loads((out / "serve-report.json").read_text())
        print(f"23d serve soak: {serve_report['rounds']} rounds, SIGTERM at "
              f">= {serve_report['kill_at']}, uninterrupted leg "
              f"{serve_report['uninterrupted']['_elapsed_s']:.2f} s, "
              f"restarted leg {serve_report['restarted']['_elapsed_s']:.2f} "
              f"s (restarts {serve_report['restarted'].get('restarts')}); "
              f"exit 0 in {wall_d:.2f} s from its start "
              f"({max(t23 - t_d, 0.0):.2f} s of it before phase 23 began); "
              f"{smi}")
    finally:
        if serve.poll() is None:
            serve.kill()
            serve.wait()
        log.close()
        shutil.rmtree(out, ignore_errors=True)
    wall = time.perf_counter() - t23
    ww = w["walls"]
    print(f"23: phase 23 in {wall:.1f} s in series (22b's inputs and CPU "
          f"step {cpu_s:.1f} s of it); in phase 19's window 23a "
          f"{ww['23a']:.1f} s, 23c and 23b {ww['window'] - ww['23a']:.1f} "
          f"s (23b {ww['23b']:.1f} s); 23d {wall_d:.1f} s from its start; "
          f"{smi}")
    return {"wall": wall, "side": wall_d, "cpu22b": cpu_s, **ww,
            "resnet_cpu": resnet_cpu}


def main() -> None:
    global T0
    T0 = time.perf_counter()
    try:
        import numpy as np
        import torch

        from dopt_torch.config import (DataConfig, FederatedConfig,
                                       GossipConfig, ModelConfig)
        from dopt_torch.engine import FederatedTrainer, GossipTrainer
        from dopt_torch.models.zoo import deterministic, param_shapes
        from dopt_torch.ops import _build
        from dopt_torch.ops.fused_update import (fused_mix_sgd,
                                                 fused_sgd_momentum,
                                                 launch_counts, launch_mix,
                                                 mix_plan, mix_sgd_reference,
                                                 sgd_momentum_reference)
        from dopt_torch.parallel.collectives import (alloc_flat,
                                                     flat_buckets,
                                                     make_update_shard_spec,
                                                     mean_weight_matrix)
        from dopt_torch.presets import get_preset
        from dopt_torch.topology import (build_mixing_matrices,
                                         random_matching_matrix)
        from dopt_torch.obs import MemorySink, Telemetry, attach
        from dopt_torch.utils.profiling import device_stats_of
    except ImportError as e:
        fail(f"cannot import the port (run from a checkout of the repo): {e}")
    # -- 1. environment ---------------------------------------------------
    smi = nvidia_smi()
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]} device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")

    print(f"elapsed {time.perf_counter() - T0:.1f} s at phase 2")
    # -- 2. build ---------------------------------------------------------
    # The kernels (nvcc) and the native planner (g++) build at once, one
    # compiler process each.
    import threading

    from dopt_torch import native

    t = time.perf_counter()
    planner: dict = {}

    def build_planner():
        try:
            planner["path"] = native.build()
            planner["s"] = time.perf_counter() - t
        except Exception as e:   # reported, and the phase fails, below
            planner["error"] = e

    side = threading.Thread(target=build_planner)
    side.start()
    lib_path = _build.build()
    _build.load_library()
    print(f"build: {lib_path.relative_to(ROOT)} in "
          f"{time.perf_counter() - t:.2f} s")
    side.join()
    if "error" in planner:
        fail(f"the native planner did not build: {planner['error']}")
    native.load_native()
    print(f"build: {planner['path'].relative_to(ROOT)} (g++, the native "
          f"planner) in {planner['s']:.2f} s")
    report = _build.resource_report()
    for line in report.splitlines():
        if line.strip():
            print(f"ptxas: {line.strip()}")
    # Spill guard: kernel 2 must hold nothing per thread in local memory
    # (the looped design it replaced spilled its hoisted mixing matrix).
    # Both of its kernels (narrow, n <= 8; ring, n > 8), f32 and bf16.
    seen = set()
    for k, r in _build.parse_ptxas(report).items():
        m = re.search(r"(mix_sgd_\w*?kernel)I", k)
        if not m:
            continue
        kind = (m.group(1), "bf16" if "bfloat16" in k else "f32")
        seen.add(kind)
        print(f"spill guard: {kind[0]} {kind[1]}: {r['registers']} "
              f"registers, {r['stack_frame']} B stack frame, "
              f"{r['spill_stores']} B spill stores, {r['spill_loads']} B "
              "spill loads")
        if r["stack_frame"] or r["spill_stores"] or r["spill_loads"]:
            fail(f"{kind[0]} {kind[1]} has a stack frame or spills: {r}")
    want = {(t, d) for t in ("mix_sgd_narrow_kernel", "mix_sgd_ring_kernel")
            for d in ("f32", "bf16")}
    if seen != want:
        fail(f"ptxas reported kernel 2 instantiations {sorted(seen)}, "
             f"expected {sorted(want)}")

    print(f"elapsed {time.perf_counter() - T0:.1f} s at phase 3")
    # -- 3. kernels against their plain versions --------------------------
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, device=dev, generator=gen).to(dtype)

    def time_ms(fn) -> float:
        return event_ms(fn, flush)

    def within(got, want, rtol, atol) -> float:
        err = (got.float() - want.float()).abs()
        bad = err > atol + rtol * want.float().abs()
        if bool(bad.any()):
            fail(f"kernel disagrees with its plain version: max abs err "
                 f"{err.max().item():.3e} (rtol {rtol}, atol {atol})")
        return float(err.max().item())

    shapes = param_shapes("model1")
    lr1, mu1 = 0.01, 0.5

    def sgd_case(label, sizes, dtype, offset=0):
        """Kernel 1 over tensors of ``sizes`` (flat views at ``offset``
        elements into their buffers, to reach the unaligned path)."""
        def mk():
            return [randn(s + offset, dtype=dtype)[offset:] for s in sizes]
        p, m, g = mk(), mk(), mk()
        pk, mk_ = mk(), mk()
        for dst, src in zip(pk + mk_, p + m):
            dst.copy_(src)
        ptrs = [t.data_ptr() for t in pk + mk_]
        fused_sgd_momentum(pk, mk_, g, lr=lr1, mu=mu1)
        pr, mr = [t.clone() for t in p], [t.clone() for t in m]
        sgd_momentum_reference(pr, mr, g, lr=lr1, momentum=mu1)
        torch.cuda.synchronize()
        if [t.data_ptr() for t in pk + mk_] != ptrs:
            fail("fused_sgd_momentum moved its outputs")
        # Bit-identical in both dtypes: the kernel rounds each f32 op as
        # its plain version does, and stores once.
        rtol, atol = 0.0, 0.0
        err = max(within(a, b, rtol, atol) for a, b in zip(pk + mk_, pr + mr))
        print(f"kernel fused_sgd_momentum {label}: {len(sizes)} tensors, "
              f"{sum(sizes)} elements, {dtype}: max abs err {err:.3e} "
              f"(tolerance rtol {rtol} atol {atol})")
        return p, m, g, err

    def time_sgd(label, p, m, g) -> dict:
        """Kernel 1, its plain version and torch's fused SGD on one
        step's tensors."""
        out = {"ms": time_ms(lambda: fused_sgd_momentum(p, m, g, lr=lr1,
                                                        mu=mu1)),
               "plain_ms": time_ms(lambda: sgd_momentum_reference(
                   p, m, g, lr=lr1, momentum=mu1)),
               "library_ms": None}
        try:
            lp = [t.clone().requires_grad_() for t in p]
            for t, gr in zip(lp, g):
                t.grad = gr.clone()
            opt = torch.optim.SGD(lp, lr=lr1, momentum=mu1, fused=True)
        except (TypeError, ValueError, RuntimeError) as e:
            print(f"library: torch.optim.SGD(fused=True) unavailable here "
                  f"({e})")
        else:
            out["library_ms"] = time_ms(opt.step)
        elems = sum(t.numel() for t in p)
        out["bound_ms"], out["bound_by"] = bound_ms(
            5 * p[0].element_size() * elems, 4 * elems)
        lib = out["library_ms"]
        print(f"time fused_sgd_momentum {label} (one step, {elems} "
              f"{p[0].dtype} elements): kernel {out['ms']:.4f} ms, plain "
              f"{out['plain_ms']:.4f} ms, library "
              f"{lib if lib is None else round(lib, 4)} ms, bound "
              f"{out['bound_ms']:.4f} ms ({out['bound_by']})")
        return out

    def mix_case(label, p_, b_, w, lr, times=None):
        """Kernel 2 on a copy of ``p_`` with the same strides; with
        ``times`` (a list) also time kernel, plain version and
        ``torch.addmm`` on this bucket and append them."""
        out = torch.empty_strided(p_.shape, p_.stride(), dtype=p_.dtype,
                                  device=dev).copy_(p_)
        ref = p_.clone()
        fused_mix_sgd(out, b_, w, lr=lr)
        mix_sgd_reference(ref, b_, w, lr=lr)
        torch.cuda.synchronize()
        rtol = 0.0 if p_.dtype == torch.float32 else 2 ** -7
        err = within(out, ref, rtol, 1e-5)
        n, f = p_.shape
        print(f"kernel fused_mix_sgd {label} [{n}, {f}] {p_.dtype} lr {lr} "
              f"row stride {p_.stride(0)}: max abs err {err:.3e} (tolerance "
              f"rtol {rtol} atol 1e-5)")
        if times is not None:
            km = time_ms(lambda: fused_mix_sgd(p_, b_, w, lr=lr))
            pm = time_ms(lambda: mix_sgd_reference(p_, b_, w, lr=lr))
            w_lib = w.to(p_.dtype)   # addmm takes one dtype
            lm = time_ms(lambda: torch.addmm(b_, w_lib, p_, beta=-lr))
            nbytes = 3 * p_.element_size() * n * f + 4 * n * n
            flops = (2 * n + 2) * n * f
            bd, _ = bound_ms(nbytes, flops)
            times.append((km, pm, lm, nbytes, flops, err))
            print(f"time fused_mix_sgd [{n}, {f}] {p_.dtype} lr {lr}: kernel "
                  f"{km:.4f} ms, plain {pm:.4f} ms, library (addmm) "
                  f"{lm:.4f} ms, bound {bd:.4f} ms")

    def ring_ab(p_, b_, w, lr) -> tuple[float, float]:
        """Kernel 2's ring kernel on a bucket the wrapper sends to the
        narrow kernel (n <= 8): its agreement with the plain version, then
        both kernels timed in turns (narrow, ring, ring, narrow) on a copy
        of ``p_`` with the same strides, so ``p_`` keeps its values."""
        tile = mix_plan(p_.shape[0], p_.element_size()).tile_cols
        out = torch.empty_strided(p_.shape, p_.stride(), dtype=p_.dtype,
                                  device=dev).copy_(p_)
        ref = p_.clone()
        launch_mix(out, b_, w, lr=lr, tile_cols=tile)
        mix_sgd_reference(ref, b_, w, lr=lr)
        torch.cuda.synchronize()
        within(out, ref, 0.0, 1e-5)
        narrow = functools.partial(launch_mix, out, b_, w, lr=lr, tile_cols=0)
        ring = functools.partial(launch_mix, out, b_, w, lr=lr, tile_cols=tile)
        t = [time_ms(fn) for fn in (narrow, ring, ring, narrow)]
        return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2

    def epilogue(times) -> dict:
        """One round's epilogue: its buckets' times summed."""
        km, pm, lm, nbytes, flops = (sum(t[i] for t in times)
                                     for i in range(5))
        bd, by = bound_ms(nbytes, flops)
        return {"ms": km, "plain_ms": pm, "library_ms": lm, "bound_ms": bd,
                "bound_by": by, "max_abs_err": max(t[5] for t in times)}

    def stochastic(n):
        w = torch.rand(n, n, device=dev, generator=gen)
        return (w / w.sum(1, keepdim=True)).contiguous()

    def stores(workers, dtype, model_shapes=None):
        """The trainers' flat [W, padded] stores, as they build them
        (Model1's unless ``model_shapes`` names another model's)."""
        spec = make_update_shard_spec(
            {k: torch.empty(workers, *s, dtype=dtype)
             for k, s in (model_shapes or shapes).items()},
            bucket_bytes=4 << 20)
        return spec, alloc_flat(workers, spec, dev), alloc_flat(workers,
                                                                spec, dev)

    # Gossip: 6 workers, kernel 2 at lr = 1 with a stochastic matrix.
    gw = 6
    leaf6 = [gw * math.prod(s) for s in shapes.values()]
    p, m, g, err1 = sgd_case("model1 W=6 leaves", leaf6, torch.float32)
    sgd_case("odd length, unaligned", [1_000_003], torch.float32, offset=1)
    sgd_case("odd length, unaligned", [1_000_003], torch.bfloat16, offset=1)
    k1 = {**time_sgd("gossip W=6", p, m, g), "max_abs_err": err1}
    p, m, g, err1 = sgd_case("model1 W=6 leaves", leaf6, torch.bfloat16)
    k1b = {**time_sgd("gossip W=6 bf16", p, m, g), "max_abs_err": err1}
    w6 = stochastic(gw)
    gossip_times, gossip_times_bf16 = [], []
    for dtype in (torch.float32, torch.bfloat16):
        spec, fp, fb = stores(gw, dtype)
        fp.copy_(randn(*fp.shape))
        fb.copy_(randn(*fb.shape))
        if dtype == torch.float32:   # before mix_case times in place
            ab = [ring_ab(pb, bb, w6, 1.0) for pb, bb in
                  zip(flat_buckets(fp, spec), flat_buckets(fb, spec))]
            print(f"A/B kernel 2 at n = 6 (gossip buckets, f32, in turns): "
                  f"narrow kernel {1e3 * sum(a for a, _ in ab):.1f} us, ring "
                  f"kernel {1e3 * sum(b for _, b in ab):.1f} us")
        for pb, bb in zip(flat_buckets(fp, spec), flat_buckets(fb, spec)):
            mix_case("gossip bucket", pb, bb, w6, 1.0,
                     gossip_times if dtype == torch.float32
                     else gossip_times_bf16)
        for n in (5, 12, 32):
            mix_case(f"{n} workers", randn(n, 65_537, dtype=dtype),
                     randn(n, 65_537, dtype=dtype), stochastic(n), 0.5)
    k2, k2b = epilogue(gossip_times), epilogue(gossip_times_bf16)

    # Federated: 16 lanes; kernel 2 at lr = −1 runs θ'_b = M·disp + θ_b
    # with M = mask/Σmask for an 8-of-16 sample, the displacement store
    # as p (masked rows zero) and the θ slab as buf.
    fw = 16
    leaf16 = [fw * math.prod(s) for s in shapes.values()]
    p, m, g, err1f = sgd_case("model1 W=16 leaves", leaf16, torch.float32)
    k1f = {**time_sgd("federated W=16", p, m, g), "max_abs_err": err1f}
    p, m, g, err1f = sgd_case("model1 W=16 leaves", leaf16, torch.bfloat16)
    k1fb = {**time_sgd("federated W=16 bf16", p, m, g), "max_abs_err": err1f}
    mask = torch.zeros(fw, device=dev)
    mask[torch.randperm(fw, device=dev, generator=gen)[:fw // 2]] = 1.0
    mean_w = mean_weight_matrix(mask)
    fed_times, fed_times_bf16 = [], []
    for dtype in (torch.float32, torch.bfloat16):
        spec, disp, slab = stores(fw, dtype)
        disp.copy_(randn(*disp.shape) * mask[:, None])
        slab.copy_(randn(1, slab.shape[1]).expand_as(slab))
        for db, sb in zip(flat_buckets(disp, spec), flat_buckets(slab, spec)):
            mix_case("federated bucket", db, sb, mean_w, -1.0,
                     fed_times if dtype == torch.float32 else fed_times_bf16)
    k2f, k2fb = epilogue(fed_times), epilogue(fed_times_bf16)
    # Sweep: kernel 2 over the federated bucket widths at n = 12 and 32
    # (n = 6 and 16 are the two call sites above), f32 timed, bf16 checked.
    sweep = {6: k2, 16: k2f}
    for n in (12, 32):
        w_n, n_times = stochastic(n), []
        for dtype in (torch.float32, torch.bfloat16):
            spec, sp, sb = stores(n, dtype)
            sp.copy_(randn(*sp.shape))
            sb.copy_(randn(*sb.shape))
            for pb, bb in zip(flat_buckets(sp, spec), flat_buckets(sb, spec)):
                mix_case(f"sweep n={n} bucket", pb, bb, w_n, 0.5,
                         n_times if dtype == torch.float32 else None)
            del spec, sp, sb
        sweep[n] = epilogue(n_times)
    for n, t in sorted(sweep.items()):
        print(f"sweep fused_mix_sgd n={n} [{n}, 1048576] + [{n}, 614794] "
              f"f32: kernel {1e3 * t['ms']:.1f} us, plain "
              f"{1e3 * t['plain_ms']:.1f} us, addmm "
              f"{1e3 * t['library_ms']:.1f} us, bound "
              f"{1e3 * t['bound_ms']:.1f} us ({t['bound_by']}): "
              f"{100 * t['bound_ms'] / t['ms']:.0f}% of the bound")
    for label, t in (("fused_sgd_momentum gossip W=6", k1b),
                     ("fused_sgd_momentum federated W=16", k1fb),
                     ("fused_mix_sgd gossip n=6 lr=1", k2b),
                     ("fused_mix_sgd federated n=16 lr=-1", k2fb)):
        lib = (None if t["library_ms"] is None
               else round(1e3 * t["library_ms"], 1))
        print(f"bf16 call site {label}: kernel {1e3 * t['ms']:.1f} us, plain "
              f"{1e3 * t['plain_ms']:.1f} us, library {lib} us, bound "
              f"{1e3 * t['bound_ms']:.1f} us ({t['bound_by']}): "
              f"{100 * t['bound_ms'] / t['ms']:.0f}% of the bound, max abs "
              f"err {t['max_abs_err']:.3e}")
    # Empty work launches nothing, so the counters count real launches.
    before = (fused_sgd_momentum.launches, fused_mix_sgd.launches)
    empty = torch.empty(0, device=dev)
    fused_sgd_momentum([empty], [empty.clone()], [empty.clone()],
                       lr=lr1, mu=mu1)
    e2 = torch.empty(gw, 0, device=dev)
    fused_mix_sgd(e2, e2.clone(), w6, lr=1.0)
    if (fused_sgd_momentum.launches, fused_mix_sgd.launches) != before:
        fail("an empty call counted a kernel launch")
    print("empty work: no launch counted")

    print(f"elapsed {time.perf_counter() - T0:.1f} s at phase 3b")
    # -- 3b. the call sites of the dense models and the gossip algorithms -
    # Each kernel at the shapes phase 9's paths give it, f32, against its
    # plain version (kernel 1 bit-identical, kernel 2 within the f32
    # tolerance above), timed beside its bound and the library call.
    mlp_s = param_shapes("mlp")
    model3_s = param_shapes("model3", input_shape=(32, 32, 3))
    logistic_s = param_shapes("logistic", num_classes=2, input_shape=(123,))

    def k1_site(label, leaf_shapes, workers) -> dict:
        sizes = [workers * math.prod(s) for s in leaf_shapes.values()]
        p_, m_, g_, err = sgd_case(label, sizes, torch.float32)
        return {**time_sgd(label, p_, m_, g_), "max_abs_err": err}

    def k2_site(label, leaf_shapes, w, lr) -> dict:
        spec, sp, sb = stores(w.shape[0], torch.float32, leaf_shapes)
        sp.copy_(randn(*sp.shape))
        sb.copy_(randn(*sb.shape))
        times = []
        for pb, bb in zip(flat_buckets(sp, spec), flat_buckets(sb, spec)):
            mix_case(label, pb, bb, w, lr, times)
        out = epilogue(times)
        print(f"call site fused_mix_sgd {label}: "
              f"{' + '.join(str(list(b.shape)) for b in flat_buckets(sp, spec))}"
              f" f32: kernel {1e3 * out['ms']:.1f} us, plain "
              f"{1e3 * out['plain_ms']:.1f} us, addmm "
              f"{1e3 * out['library_ms']:.1f} us, bound "
              f"{1e3 * out['bound_ms']:.1f} us ({out['bound_by']})")
        return out

    def as_w(a) -> torch.Tensor:
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    def doubly_stochastic(n) -> torch.Tensor:
        """A dense doubly-stochastic matrix (Sinkhorn on uniform draws)."""
        w = torch.rand(n, n, device=dev, generator=gen, dtype=torch.float64)
        for _ in range(500):
            w = w / w.sum(1, keepdim=True)
            w = w / w.sum(0, keepdim=True)
        return w.float().contiguous()

    site = {
        "k1 baseline1": k1_site("baseline1 mlp W=4", mlp_s, 4),
        "k1 baseline2": k1_site("baseline2 model3 W=16", model3_s, 16),
        "k1 baseline4": k1_site("baseline4 logistic W=16", logistic_s, 16),
        "k1 centralized": k1_site("reference-centralized model1 W=1",
                                  shapes, 1),
        "k2 baseline1": k2_site(
            "baseline1 mlp n=4, metropolis ring, lr 1", mlp_s,
            as_w(build_mixing_matrices("circle", "metropolis", 4,
                                       seed=2028).for_round(0)), 1.0),
        "k2 baseline2": k2_site(
            "baseline2 model3 n=16, dense doubly-stochastic, lr +1",
            model3_s, doubly_stochastic(16), 1.0),
        "k2 gossip": k2_site(
            "reference-gossip model1 n=6, a matching, lr 1", shapes,
            as_w(random_matching_matrix(6, np.random.default_rng(0))),
            1.0)}
    # The schedules the paths run: baseline2's ring matrix (n = 16, three
    # nonzeros a row) and a matching at odd n, whose unmatched worker's
    # row is the identity's.
    mix_case("baseline2's ring schedule n=16", randn(16, 65_537),
             randn(16, 65_537), as_w(build_mixing_matrices(
                 "circle", "double_stochastic", 16, seed=1).for_round(0)),
             1.0)
    w5 = random_matching_matrix(5, np.random.default_rng(3))
    if sorted(np.diag(w5).tolist()) != [0.5] * 4 + [1.0]:
        fail(f"a matching at n = 5 has no identity row: {w5}")
    mix_case("matching n=5, identity row", randn(5, 65_537),
             randn(5, 65_537), as_w(w5), 1.0)
    print(f"call site fused_sgd_momentum baseline4: "
          f"{1e3 * site['k1 baseline4']['ms']:.1f} us against a "
          f"{1e3 * site['k1 baseline4']['bound_ms']:.3f} us bound: "
          "launch-bound")
    del flush, p, m, g

    # Every trainer below makes its synthetic set from (dataset, sizes,
    # seed, shape, classes); each set is made once and shared read-only
    # (the trainers copy it to the card, and read it on the CPU).
    from dopt_torch.engine import gossip as gossip_engine
    from dopt_torch.engine import torch_backend as oracle_backend

    gossip_engine.load_dataset = functools.lru_cache(maxsize=4)(
        gossip_engine.load_dataset)
    oracle_backend.load_dataset = gossip_engine.load_dataset

    print(f"elapsed {time.perf_counter() - T0:.1f} s at phase 4")
    # -- 4. small-input agreement: GPU runs vs CPU runs --------------------
    tiny_data = DataConfig(dataset="synthetic", num_users=4, iid=False,
                           shards=2, synthetic_train_size=128,
                           synthetic_test_size=32)
    tiny_model = ModelConfig(model="model1", input_shape=(8, 8, 1))

    def agree(label, cls, cfg, loss_keys, acc_key, states):
        runs = {}
        for d in ("cuda", "cpu"):
            tr = cls(cfg, device=d)
            tr.run(rounds=2)
            runs[d] = (tr, tr.history.rows)
        for a, b in zip(runs["cuda"][1], runs["cpu"][1], strict=True):
            if (any(abs(a[k] - b[k]) > LOSS_TOL for k in loss_keys)
                    or abs(a[acc_key] - b[acc_key]) > ACC_TOL):
                fail(f"small-input {label} disagrees: cuda {a} vs cpu {b}")
        rel = max(max_rel(getattr(runs["cpu"][0], s)(),
                          getattr(runs["cuda"][0], s)()) for s in states)
        if not rel <= PARAM_REL_TOL:
            fail(f"small-input {label}: final params differ by {rel:.3e} "
                 "(max-relative)")
        print(f"small-input check {label} ({cfg.model.model} at "
              f"{cfg.model.input_shape}, {cfg.data.num_users} workers, 2 "
              f"rounds): cuda vs cpu {'/'.join(loss_keys)} within {LOSS_TOL}, "
              f"{acc_key} within {ACC_TOL}, params max-rel {rel:.3e} "
              f"(limit {PARAM_REL_TOL})")
        return runs["cuda"][0]

    gossip_tiny = get_preset("headline-dsgd-model1").replace(
        data=tiny_data, model=tiny_model,
        gossip=GossipConfig(local_ep=1, local_bs=16, fused_update="on"))
    agree("gossip, both fused switches", GossipTrainer, gossip_tiny,
          ("avg_train_loss",), "avg_test_acc", ("worker_params",))
    fed_tiny = get_preset("headline-fedavg-model1").replace(
        data=tiny_data, model=tiny_model,
        federated=FederatedConfig(frac=0.5, local_ep=1, local_bs=16,
                                  fused_update="on"))
    agree("federated fedavg, both fused switches", FederatedTrainer,
          fed_tiny, ("train_loss", "local_loss"), "test_acc",
          ("worker_params", "global_params"))
    admm_tiny = fed_tiny.replace(
        data=dataclasses.replace(tiny_data, local_holdout=0.1),
        federated=FederatedConfig(algorithm="fedadmm", frac=0.5, local_ep=2,
                                  local_bs=16))
    admm = agree(
        "federated fedadmm, compact, 10% holdout", FederatedTrainer,
        admm_tiny, ("train_loss", "local_loss"), "test_acc",
        ("worker_params", "global_params"))
    if not admm._use_compact() or len(admm.client_history.rows) != 8:
        fail("the fedadmm small-input run did not take the compact path "
             "with per-epoch client rows")
    # This slice's paths, small: the MLP (baseline1's shape), the
    # logistic model on the a9a fallback (baseline4's), and the gossip
    # algorithms.
    gkeys = (("avg_train_loss",), "avg_test_acc", ("worker_params",))
    b1 = get_preset("baseline1")
    agree("baseline1-shaped MLP dsgd, metropolis, both fused switches",
          GossipTrainer, b1.replace(
              data=tiny_data, model=dataclasses.replace(
                  b1.model, input_shape=(8, 8, 1)),
              optim=dataclasses.replace(b1.optim, fused_update=True),
              gossip=dataclasses.replace(b1.gossip, local_ep=2, local_bs=16,
                                         fused_update="on")), *gkeys)
    b4 = get_preset("baseline4")
    agree("logistic fedadmm on the a9a fallback, kernel 1", FederatedTrainer,
          b4.replace(data=dataclasses.replace(
              b4.data, num_users=4, synthetic_train_size=128,
              synthetic_test_size=32),
              optim=dataclasses.replace(b4.optim, fused_update=True),
              federated=dataclasses.replace(b4.federated, local_bs=16)),
          ("train_loss", "local_loss"), "test_acc",
          ("worker_params", "global_params"))
    for label, g in (
            ("gossip matching, both fused switches",
             GossipConfig(algorithm="gossip", local_ep=1, local_bs=16,
                          fused_update="on")),
            ("fedlcon, eps 3", GossipConfig(algorithm="fedlcon", eps=3,
                                            local_ep=1, local_bs=16)),
            ("dsgd, sharded eval, both fused switches",
             GossipConfig(local_ep=1, local_bs=16, eval_mode="sharded",
                          fused_update="on"))):
        agree(label, GossipTrainer, gossip_tiny.replace(gossip=g), *gkeys)

    # The ResNet-18 slice's paths, small: stage sizes (1, 1), 4 workers,
    # 8×8×3 synthetic data, both fused switches, in each engine.
    resnet_tiny = ModelConfig(model="resnet18", faithful=False,
                              stage_sizes=(1, 1), input_shape=(8, 8, 3))
    b5 = get_preset("baseline5")
    agree("ResNet-18 baseline5-shaped gossip (lr 0.1, momentum 0.9, random "
          "metropolis graphs), both fused switches", GossipTrainer,
          b5.replace(data=tiny_data, model=resnet_tiny,
                     optim=dataclasses.replace(b5.optim, fused_update=True),
                     gossip=dataclasses.replace(b5.gossip, local_bs=16,
                                                fused_update="on")), *gkeys)
    agree("ResNet-18 federated fedavg, both fused switches",
          FederatedTrainer, fed_tiny.replace(model=resnet_tiny),
          ("train_loss", "local_loss"), "test_acc",
          ("worker_params", "global_params"))

    # The fault model, small: crash, straggle and partition with both
    # fused switches (kernel 1 gated, kernel 2 on repaired matrices), and
    # the chaos cocktail's link path with corrupt sends and quarantine.
    from dopt_torch.config import FaultConfig, RobustConfig

    agree("faults: crash, straggle, partition, both fused switches",
          GossipTrainer, gossip_tiny.replace(
              gossip=GossipConfig(local_ep=2, local_bs=16,
                                  fused_update="on"),
              faults=FaultConfig(crash=0.3, straggle=0.5, straggle_frac=0.5,
                                 partition=0.3)), *gkeys)
    agree("faults: lossy links, push-sum, scale lies, quarantine, kernel 1",
          GossipTrainer, gossip_tiny.replace(
              gossip=GossipConfig(topology="circle", mode="metropolis",
                                  local_ep=1, local_bs=16,
                                  correction="push_sum"),
              faults=FaultConfig(msg_drop=0.2, msg_delay=0.3, straggle=0.4,
                                 corrupt=0.3, corrupt_mode="scale",
                                 corrupt_scale=2.0),
              robust=RobustConfig(quarantine_after=2)), *gkeys)

    def rel_l2(want: dict, got: dict) -> float:
        a = np.concatenate([want[k].ravel() for k in sorted(want)])
        b = np.concatenate([got[k].ravel() for k in sorted(want)])
        return float(np.linalg.norm(b - a) / np.linalg.norm(a))

    def agree_bf16(label, cls, cfg, loss_keys, acc_key, states):
        """The bf16 run on the GPU and on the CPU from one init, beside
        the same run's GPU f32 leg: the GPU-vs-CPU distance in each
        metric (max over rounds; params relative L2) is at most the GPU
        bf16-vs-f32 distance, the losses at most that or LOSS_TOL and
        the test accuracy at most that or one test sample, whichever is
        larger (tests/test_torch_bf16.py holds the port to dopt by the
        same rule on the CPU, where runs repeat bit for bit; the card's
        do not, PERF.md §7, so one flipped prediction of the 32 may come
        and go between runs)."""
        f32 = cfg.replace(model=dataclasses.replace(
            cfg.model, compute_dtype="float32", param_dtype="float32"))
        runs = {}
        for leg, c, d in (("gpu16", cfg, "cuda"), ("gpu32", f32, "cuda"),
                          ("cpu16", cfg, "cpu")):
            tr = cls(c, device=d)
            tr.run(rounds=2)
            runs[leg] = (tr.history.rows, [getattr(tr, s)() for s in states])

        def dist(a, b):
            (ra, pa), (rb, pb) = runs[a], runs[b]
            out = {k: max(abs(x[k] - y[k]) for x, y in zip(ra, rb,
                                                           strict=True))
                   for k in (*loss_keys, acc_key)}
            out["params"] = max(rel_l2(x, y) for x, y in zip(pa, pb))
            return out

        got, ref = dist("cpu16", "gpu16"), dist("gpu16", "gpu32")
        for k in got:
            print(f"small-input bf16 {label}: {k} cuda vs cpu {got[k]:.3e}, "
                  f"cuda bf16 vs f32 {ref[k]:.3e} (ratio "
                  f"{got[k] / ref[k] if ref[k] else float('nan'):.3f})")
        one_sample = 1.0 / cfg.data.synthetic_test_size
        bad = [k for k in loss_keys if got[k] > max(ref[k], LOSS_TOL)]
        bad += [k for k in (acc_key, "params")
                if got[k] > max(ref[k], one_sample if k == acc_key else 0.0)]
        if bad:
            fail(f"small-input bf16 {label}: {bad} beyond the bound")
        return runs

    agree_bf16("gossip idiomatic bf16, clip 1.0, fused", GossipTrainer,
               get_preset("headline-dsgd-model1-idiomatic-bf16").replace(
                   data=tiny_data, model=dataclasses.replace(
                       tiny_model, faithful=False, compute_dtype="bfloat16"),
                   gossip=GossipConfig(local_ep=1, local_bs=16,
                                       fused_update="on")),
               ("avg_train_loss",), "avg_test_acc", ("worker_params",))
    prox_tiny = fed_tiny.replace(
        data=dataclasses.replace(tiny_data, local_holdout=0.1),
        model=dataclasses.replace(tiny_model, compute_dtype="bfloat16",
                                  param_dtype="bfloat16"),
        optim=dataclasses.replace(fed_tiny.optim, clip_norm=1.0),
        federated=FederatedConfig(algorithm="fedprox", frac=0.5, local_ep=2,
                                  local_bs=16))
    agree_bf16("federated fedprox, compact, bf16 storage, clip 1.0, 10% "
               "holdout", FederatedTrainer, prox_tiny,
               ("train_loss", "local_loss"), "test_acc",
               ("worker_params", "global_params"))

    print(f"elapsed {time.perf_counter() - T0:.1f} s at phase 4c")
    # -- 4c. one full-size Model1 step, the card against the CPU ----------
    phase4c(dev, smi, get_preset)

    print(f"elapsed {time.perf_counter() - T0:.1f} s at phase 5")
    # -- 5. main paths ----------------------------------------------------
    def main_path(name, cls, rounds, loss_keys, acc_keys, workers, cfg=None,
                  tele=None):
        cfg = get_preset(name) if cfg is None else cfg
        base = torch.cuda.memory_allocated()
        t = time.perf_counter()
        trainer = cls(cfg, device="cuda")
        print(f"main path: {cfg.name}, {trainer.num_workers} workers, "
              f"{trainer.param_count} params a worker, "
              f"{len(trainer.dataset.train_y)}/{len(trainer.dataset.test_y)} "
              f"samples, built in {time.perf_counter() - t:.2f} s")
        if tele is not None:
            attach(trainer, tele)
        fused_sgd_momentum.launches = 0
        fused_mix_sgd.launches = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        trainer.run(rounds=rounds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = {"fused_sgd_momentum": fused_sgd_momentum.launches,
                    "fused_mix_sgd": fused_mix_sgd.launches}
        for row in trainer.history.rows:
            print(f"history {json.dumps(row)}")
        print(f"main path {name}: {rounds} rounds in {wall:.3f} s = "
              f"{rounds / wall:.4f} rounds/s; max_memory_allocated "
              f"{torch.cuda.max_memory_allocated()} B ({base} B of it "
              "allocated before the trainer was built)")
        spec = trainer.fused_spec
        want = {"fused_sgd_momentum": (rounds * trainer.steps_per_round
                                       if cfg.optim.fused_update else 0),
                "fused_mix_sgd": rounds * spec.num_buckets if spec else 0}
        print(f"kernel launches on {name}: {launches} (expected {want})")
        if launches != want:
            fail(f"kernel launch counts {launches} != expected {want}")
        for row in trainer.history.rows:
            for k in loss_keys:
                if not math.isfinite(row[k]):
                    fail(f"non-finite {k} in {row}")
            for k in acc_keys:
                if not 0.0 <= row[k] <= 1.0:
                    fail(f"{k} out of range in {row}")
        final = trainer.worker_params()
        mc = cfg.model
        want_shapes = param_shapes(mc.model.lower(),
                                   num_classes=mc.num_classes,
                                   input_shape=mc.input_shape)
        if trainer.num_workers != workers or final.keys() != want_shapes.keys():
            fail(f"{name}: {trainer.num_workers} workers with params "
                 f"{sorted(final)}, expected {workers} with "
                 f"{sorted(want_shapes)}")
        for k, s in want_shapes.items():
            if final[k].shape != (workers, *s) or not np.isfinite(
                    final[k]).all():
                fail(f"final params {k}: shape {final[k].shape} or "
                     "non-finite")
        return trainer, launches, wall

    rounds = 2
    # Phase 20b holds this run's telemetry stream against 7b's blocked run.
    g_stream = MemorySink()
    gtr, glaunch, gwall = main_path(
        "headline-dsgd-model1", GossipTrainer, rounds,
        ("avg_train_loss", "avg_test_loss"),
        ("avg_train_acc", "avg_test_acc"), gw, tele=Telemetry([g_stream]))
    g_state = state(gtr)
    # The stream of these 2 rounds (phase 6 runs this trainer once more).
    g_events = g_stream.events
    # Phase 20a's samples a round: lanes × steps × batch.
    samples = {"gossip": (gtr.num_workers * gtr.steps_per_round
                          * gtr.cfg.gossip.local_bs)}
    share = (k1["ms"] * glaunch["fused_sgd_momentum"]
             + k2["ms"] * rounds) / (1e3 * gwall)
    print(f"kernel share of the gossip main path's wall time (event times "
          f"x launches): {100 * share:.2f}%")
    ftr, flaunch, fwall = main_path(
        "headline-fedavg-model1", FederatedTrainer, rounds,
        ("train_loss", "test_loss", "local_loss"),
        ("train_acc", "test_acc"), fw)
    if ftr._use_compact():
        fail("the federated main path must run at full width")
    f_state = state(ftr)
    samples["federated"] = (ftr.lanes * ftr.steps_per_round
                            * ftr.cfg.federated.local_bs)
    theta = ftr.global_params()
    for k, s in shapes.items():
        if theta[k].shape != s or not np.isfinite(theta[k]).all():
            fail(f"final theta {k}: shape {theta[k].shape} or non-finite")
    share = (k1f["ms"] * flaunch["fused_sgd_momentum"]
             + k2f["ms"] * rounds) / (1e3 * fwall)
    print(f"kernel share of the federated main path's wall time (event "
          f"times x launches): {100 * share:.2f}%")
    # One round (cut from 2 for the budget): its rate beside 5b's.
    btr, _, bwall = main_path(
        "baseline3", FederatedTrainer, 1,
        ("train_loss", "test_loss", "local_loss"),
        ("train_acc", "test_acc"), fw)
    if not btr._use_compact():
        fail("baseline3 as typed must take the compact path")
    print(f"baseline3 as typed ({btr._sampled_count()} of {fw} lanes train, "
          f"unfused): {1 / bwall:.4f} rounds/s (round 0); "
          f"headline-fedavg-model1 (all {fw} lanes, both fused switches): "
          f"{rounds / fwall:.4f} rounds/s; the fused full-width path takes "
          f"{fwall / rounds / bwall:.3f}x the time a round")
    del btr

    print(f"elapsed {time.perf_counter() - T0:.1f} s at phase 5d/5e")
    # -- 5d/5e. the JAX bench's fast legs: bf16 compute, f32 storage -----
    fast, fast_walls = {}, {}
    # The idiomatic leg one round (cut from 2 for the budget): only its
    # rate is read; 7b holds the fast leg's 2 rounds blocked.
    for name, n_rounds in (("headline-dsgd-model1-bf16", rounds),
                           ("headline-dsgd-model1-idiomatic-bf16", 1)):
        tr, launch, wall = main_path(
            name, GossipTrainer, n_rounds, ("avg_train_loss",
                                            "avg_test_loss"),
            ("avg_train_acc", "avg_test_acc"), gw)
        print(f"{name}: {n_rounds / wall:.4f} rounds/s against the f32 "
              f"headline's {rounds / gwall:.4f} in this run: "
              f"{gwall / rounds / (wall / n_rounds):.3f}x")
        fast[name] = (tr, launch, state(tr))
        fast_walls[name] = wall
        del tr
    btr_bf16, b_launch, b_state = fast.pop("headline-dsgd-model1-bf16")
    del fast

    print(f"elapsed {time.perf_counter() - T0:.1f} s at phase 5f")
    # -- 5f. bf16 storage in both engines --------------------------------
    # The wrappers' C entry points are wrapped for these runs to record
    # the dtype code (0 f32, 1 bf16) of every launch.
    lib = _build.load_library()
    codes = {"dopt_fused_sgd_momentum": (5, set()),
             "dopt_fused_mix_sgd": (7, set())}
    originals = {fn: getattr(lib, fn) for fn in codes}

    def recording(fn):
        idx, seen = codes[fn]

        def call(*args):
            seen.add(args[idx])
            return originals[fn](*args)
        return call

    bf16_launch, bf16_state = {}, {}
    for label, preset, cls, keys, accs in (
            ("federated", "headline-fedavg-model1", FederatedTrainer,
             ("train_loss", "test_loss", "local_loss"),
             ("train_acc", "test_acc")),
            ("gossip", "headline-dsgd-model1", GossipTrainer,
             ("avg_train_loss", "avg_test_loss"),
             ("avg_train_acc", "avg_test_acc"))):
        cfg = get_preset(preset)
        cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, compute_dtype="bfloat16", param_dtype="bfloat16"))
        for fn, (_, seen) in codes.items():
            seen.clear()
            setattr(lib, fn, recording(fn))
        # The federated run one round (cut from 2 for the budget); 8c
        # resumes the gossip run's 2 rounds.
        try:
            tr, bf16_launch[label], _ = main_path(
                f"{preset} (bf16 compute and storage)", cls,
                1 if label == "federated" else rounds, keys,
                accs, fw if label == "federated" else gw, cfg=cfg)
        finally:
            for fn, orig in originals.items():
                setattr(lib, fn, orig)
        got = {fn: sorted(seen) for fn, (_, seen) in codes.items()}
        print(f"dtype codes launched on {preset} with bf16 storage: {got}")
        if any(v != [1] for v in got.values()):
            fail(f"a kernel received non-bf16 tensors on the bf16 storage "
                 f"run of {preset}: {got}")
        bf16_state[label] = state(tr)
        del tr

    print(f"elapsed {time.perf_counter() - T0:.1f} s at phase 6")
    # -- 6. profile one more round of each path ---------------------------
    def profile_round(label, run_round, stats_out=None, model=None) -> float:
        """One round under ``device_stats_of`` (the device activity only:
        recording the host ops too doubled the profiler's own cost after
        the round, 23.2 s against 10.8 s on a headline round, and moved
        the idle share by 0.7 points): device time by kernel and by
        phase (conv, comm, update, other, from the kernel names alone),
        busy time and idle share of the profiled wall; returns the share.
        Fails on a degraded profile, and unless each hand kernel's
        occurrences in the trace equal its wrapper's launches in the
        round (a graph replay's kernels too).  ``stats_out`` (a dict)
        receives the stats, the wall and the launches; ``model`` (the zoo
        model the round trains) files its f64 kernels by its rounded
        layer (``device_stats_of``)."""
        before = launch_counts()
        wall = {}

        def timed():
            t = time.perf_counter()
            run_round()
            torch.cuda.synchronize()
            wall["s"] = time.perf_counter() - t

        st = device_stats_of(timed, model=model)
        if "warning" in st or not math.isfinite(st["device_self_time_us"]):
            fail(f"profile ({label}): the profiler degraded: "
                 f"{st.get('warning')}")
        launched = {k: v - before[k] for k, v in launch_counts().items()}
        cats = st["device_categories"]
        seen = {"fused_sgd_momentum": sum(
            c["occurrences"] for c in cats
            if "sgd_momentum_kernel" in c["op_type"]),
            "fused_mix_sgd": sum(c["occurrences"] for c in cats
                                 if "mix_sgd_" in c["op_type"])}
        if seen != launched:
            fail(f"profile ({label}): the trace holds the hand kernels "
                 f"{seen} times, the wrappers launched them {launched}")
        total, busy = st["device_self_time_us"], st["device_busy_us"]
        idle = max(0.0, 1 - busy / (wall["s"] * 1e6))
        print(f"profile ({label}, 1 round, {wall['s'] * 1e3:.1f} ms wall "
              f"under the profiler): device kernel time {total / 1e3:.1f} "
              f"ms summed over {len(cats)} kernel names, {busy / 1e3:.1f} "
              f"ms busy (union of the device intervals), idle share "
              f"{100 * idle:.1f}% of the profiled wall; hand kernels in the "
              f"trace {seen} = launches; guard records kept (start, end) "
              f"{st['guard_records']}")
        ph, pb = st["device_phases"], st["device_phases_busy"]
        print(f"profile ({label}) phases, summed basis (kernel time, share "
              f"of {total / 1e3:.1f} ms summed): " + ", ".join(
                  f"{k} {ph[k + '_us'] / 1e3:.1f} ms "
                  f"({ph[k + '_fraction']:.4f})"
                  for k in ("conv", "comm", "update", "other")))
        print(f"profile ({label}) phases, busy basis (each phase's union "
              f"of intervals, share of {busy / 1e3:.1f} ms busy): "
              + ", ".join(f"{k} {pb[k + '_us'] / 1e3:.1f} ms "
                          f"({pb[k + '_fraction']:.4f})"
                          for k in ("conv", "comm", "update", "other")))
        ov = st["device_overlap"]
        print(f"profile ({label}) overlap, summed − busy "
              f"{ov['overlap_us'] / 1e3:.1f} ms: "
              f"{ov['same_stream_us'] / 1e3:.1f} ms within a stream, "
              f"{ov['streams']} streams, {ov['duplicate_records']} duplicate "
              f"records; by the later kernel's phase " + ", ".join(
                  f"{k} {v / 1e3:.1f} ms"
                  for k, v in ov["by_phase_us"].items()))
        for name, us in ov["top_names"]:
            print(f"  overlap {us / 1e3:9.3f} ms  {name[:160]}")
        for c in cats[:12]:
            print(f"  {c['self_time_us'] / 1e3:9.2f} ms  "
                  f"{c['occurrences']:6d}x  {c['phase']:6s} "
                  f"{c['op_type'][:90]}")
        others = [c for c in cats if c["phase"] == "other"]
        print(f"profile ({label}): {len(others)} kernel names fell to other "
              f"({sum(c['self_time_us'] for c in others) / 1e3:.1f} ms):")
        for c in others:
            print(f"  other {c['self_time_us'] / 1e3:9.3f} ms  "
                  f"{c['occurrences']:6d}x  {c['op_type'][:160]}")
        if stats_out is not None:
            stats_out.update(stats=st, wall=wall["s"], launches=launched,
                             idle=idle)
        return idle

    # The gossip headline only: 7c profiles the bf16 and f32 gossip
    # rounds as graph replays, and 11b a federated Model1 round.
    prof6: dict = {}
    profile_round("gossip", functools.partial(gtr.run, rounds=1), prof6,
                  model=gtr.cfg.model.model)
    want = {"fused_sgd_momentum": gtr.steps_per_round,
            "fused_mix_sgd": gtr.fused_spec.num_buckets}
    if prof6["launches"] != want:
        fail(f"6: the profiled round launched {prof6['launches']}, "
             f"expected {want}")
    del gtr, ftr, btr_bf16
    torch.cuda.empty_cache()

    print(f"elapsed {time.perf_counter() - T0:.1f} s at phase 7a")
    # -- 7a. determinism: the same run twice, bit for bit ------------------
    cudnn = torch.backends.cudnn
    with deterministic(dev):
        import torch.utils.deterministic as det
        print(f"deterministic mode: cudnn.deterministic "
              f"{cudnn.deterministic}, cudnn.benchmark {cudnn.benchmark}, "
              f"use_deterministic_algorithms "
              f"{torch.are_deterministic_algorithms_enabled()}, "
              f"fill_uninitialized_memory {det.fill_uninitialized_memory}, "
              f"CUBLAS_WORKSPACE_CONFIG "
              f"{os.environ.get('CUBLAS_WORKSPACE_CONFIG')}")

    def counted_run(cls, cfg, rounds, block, tele=None, **kw):
        """A fresh trainer's run on the card, with the launch counts of
        that run alone; ``tele`` is attached before it runs."""
        tr = cls(cfg, device="cuda", **kw)
        if tele is not None:
            attach(tr, tele)
        fused_sgd_momentum.launches = 0
        fused_mix_sgd.launches = 0
        tr.run(rounds=rounds, block=block)
        torch.cuda.synchronize()
        return tr, launch_counts()

    tr, _ = counted_run(GossipTrainer, get_preset("headline-dsgd-model1"),
                        rounds, 1)
    same_state("7a headline-dsgd-model1, 2 rounds, again", g_state, state(tr))
    del tr
    runs = [state(counted_run(FederatedTrainer, admm_tiny, 2, 1)[0])
            for _ in range(2)]
    same_state("7a tiny fedadmm, compact, 10% holdout, twice", *runs)

    print(f"elapsed {time.perf_counter() - T0:.1f} s at phase 7b")
    # -- 7b. blocked (CUDA-graph replays) against per-round ----------------
    def blocked(label, cls, cfg, want_state, want_launch, n, block,
                phase="7b", tele=None, **kw):
        tr, got = counted_run(cls, cfg, n, block, tele, **kw)
        caps = tr.graphs.captures
        if not caps:
            fail(f"{label}: the blocked run captured no graph")
        same_state(f"{phase} {label}, blocks of {block}, against per-round",
                   want_state, state(tr))
        print(f"{phase} {label}: launches {got} (per-round {want_launch}); "
              f"graphs {caps}")
        if got != want_launch:
            fail(f"{label}: blocked launch counts {got} != per-round "
                 f"{want_launch}")

    b_stream = MemorySink()
    blocked("headline-dsgd-model1", GossipTrainer,
            get_preset("headline-dsgd-model1"), g_state, glaunch, rounds, 2,
            tele=Telemetry([b_stream]))
    blocked("headline-dsgd-model1-bf16", GossipTrainer,
            get_preset("headline-dsgd-model1-bf16"), b_state, b_launch,
            rounds, 2)
    fcfg = get_preset("headline-fedavg-model1")
    for pf in ("off", "on"):
        blocked(f"headline-fedavg-model1, prefetch {pf}", FederatedTrainer,
                fcfg.replace(federated=dataclasses.replace(
                    fcfg.federated, prefetch=pf)),
                f_state, flaunch, rounds, 2)
    bf16_store = dataclasses.replace(tiny_model, compute_dtype="bfloat16",
                                     param_dtype="bfloat16")
    for label, cls, cfg in (
            ("tiny gossip, both fused switches", GossipTrainer, gossip_tiny),
            ("tiny gossip, bf16 storage, clip 1.0", GossipTrainer,
             gossip_tiny.replace(model=bf16_store, optim=dataclasses.replace(
                 gossip_tiny.optim, clip_norm=1.0))),
            ("tiny fedprox, compact, bf16 storage, clip 1.0, 10% holdout",
             FederatedTrainer, prox_tiny),
            ("tiny fedadmm, compact, 10% holdout", FederatedTrainer,
             admm_tiny),
            ("tiny scaffold, full width", FederatedTrainer, fed_tiny.replace(
                federated=FederatedConfig(algorithm="scaffold", frac=0.5,
                                          local_ep=1, local_bs=16,
                                          compact=False)))):
        tr, launch = counted_run(cls, cfg, 3, 1)
        blocked(label, cls, cfg, state(tr), launch, 3, 2)
        del tr

    print(f"elapsed {time.perf_counter() - T0:.1f} s at phase 7c")
    # -- 7c. rates: per-round against blocked -----------------------------
    every = 10 ** 6   # eval_every beyond the run: only round 0 evaluates
    prof7c: dict = {}
    for name in ("headline-dsgd-model1-bf16", "headline-dsgd-model1"):
        got = {}
        for mode, block in (("per-round", 1), ("blocked", 2)):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            tr = GossipTrainer(get_preset(name), device="cuda",
                               eval_every=every)
            # Warm-up: round 0 (the eval round); blocked, one block of 2,
            # which captures the eval and the no-eval graph.
            tr.run(rounds=block, block=block)
            # Timed: one block of 2 rounds, or one round per-round (cut
            # from 2 for the budget).
            timed = block
            torch.cuda.synchronize()
            t = time.perf_counter()
            tr.run(rounds=timed, block=block)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            got[mode] = timed / wall
            if not all(math.isfinite(r["avg_train_loss"])
                       for r in tr.history.rows):
                fail(f"{name} {mode}: non-finite train loss")
            caps = {("eval" if k else "no-eval"): v
                    for k, v in tr.graphs.captures.items()}
            print(f"7c {name} {mode}: {timed} rounds in {wall:.3f} s = "
                  f"{got[mode]:.4f} rounds/s; max_memory_allocated "
                  f"{torch.cuda.max_memory_allocated()} B, "
                  f"max_memory_reserved {torch.cuda.max_memory_reserved()} "
                  f"B (from before the trainer's construction); graphs "
                  f"{caps}")
            if mode == "blocked" and not name.endswith("bf16"):
                # One more round through the eval-free graph: the
                # kernels of a replay, named and counted from the trace
                # (the f32 headline's; the bf16 replay is not profiled).
                prof7c[name] = {}
                profile_round(f"{name}, one blocked round (graph replay)",
                              functools.partial(tr.run, rounds=1, block=2),
                              prof7c[name], model=tr.cfg.model.model)
                spec = tr.fused_spec
                want = {"fused_sgd_momentum": (tr.steps_per_round
                                               if tr.cfg.optim.fused_update
                                               else 0),
                        "fused_mix_sgd": spec.num_buckets if spec else 0}
                if prof7c[name]["launches"] != want:
                    fail(f"7c {name}: the profiled replay launched "
                         f"{prof7c[name]['launches']}, expected {want}")
            del tr
        print(f"7c {name}: blocked {got['blocked']:.4f} against per-round "
              f"{got['per-round']:.4f} rounds/s: "
              f"{got['blocked'] / got['per-round']:.3f}x")

    print(f"elapsed {time.perf_counter() - T0:.1f} s at phase 8")
    # -- 8. checkpoint and resume on the card -----------------------------
    import shutil
    import tempfile

    ckdir = Path(tempfile.mkdtemp(prefix="dopt-torch-ckpt-"))
    try:
        bf16_gossip = get_preset("headline-dsgd-model1")
        bf16_gossip = bf16_gossip.replace(model=dataclasses.replace(
            bf16_gossip.model, compute_dtype="bfloat16",
            param_dtype="bfloat16"))
        resume = {
            "gossip": resume_check(
                "8a headline-dsgd-model1", GossipTrainer,
                get_preset("headline-dsgd-model1"), g_state, glaunch, ckdir,
                dev),
            "federated": resume_check(
                "8b headline-fedavg-model1", FederatedTrainer, fcfg, f_state,
                flaunch, ckdir, dev),
            "gossip-bf16": resume_check(
                "8c headline-dsgd-model1 (bf16 compute and storage)",
                GossipTrainer, bf16_gossip, bf16_state["gossip"],
                bf16_launch["gossip"], ckdir, dev)}
        torch.cuda.empty_cache()

        def prefetched(cfg):
            sec = "gossip" if cfg.gossip is not None else "federated"
            return cfg.replace(**{sec: dataclasses.replace(
                getattr(cfg, sec), prefetch="on")})

        kept = resume_tiny("8d-gossip tiny gossip, both fused switches",
                           GossipTrainer, prefetched(gossip_tiny), ckdir, dev)
        unfused = prefetched(gossip_tiny.replace(gossip=dataclasses.replace(
            gossip_tiny.gossip, fused_update="off")))
        try:
            GossipTrainer(unfused, device=dev).restore(kept[2])
        except ValueError as e:
            if "fused_buf" not in str(e):
                raise
            print(f"8d fused gossip checkpoint into an unfused trainer: "
                  f"refused ({str(e)[:72]}...)")
        else:
            fail("a fused gossip checkpoint restored into an unfused trainer")
        for label, cfg in (
                ("8d-fedavg tiny fedavg, both fused switches", fed_tiny),
                ("8d-fedadmm tiny fedadmm, compact, 10% holdout", admm_tiny),
                ("8d-scaffold tiny scaffold, full width", fed_tiny.replace(
                    federated=FederatedConfig(algorithm="scaffold", frac=0.5,
                                              local_ep=1, local_bs=16,
                                              compact=False)))):
            resume_tiny(label, FederatedTrainer, prefetched(cfg), ckdir, dev)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    for key, r in resume.items():
        print(f"8 checkpoint {key}: {r['bytes']} B, save {r['save_s']:.4f} s "
              f"({r['bytes'] / r['save_s'] / 1e9:.3f} GB/s), restore "
              f"{r['restore_s']:.4f} s ({r['bytes'] / r['restore_s'] / 1e9:.3f}"
              f" GB/s); {smi}")

    print(f"elapsed {time.perf_counter() - T0:.1f} s at phase 9")
    # -- 9. this slice's paths at full width -------------------------------
    t9 = time.perf_counter()
    held = torch.cuda.memory_allocated()
    gc.collect()
    print(f"9: {held} B allocated on the card after phase 8, "
          f"{torch.cuda.memory_allocated()} B after a garbage collection")

    def switched(cfg, both=True):
        """``cfg`` with ``optim.fused_update`` and (``both``) its gossip
        section's ``fused_update`` on."""
        out = cfg.replace(optim=dataclasses.replace(cfg.optim,
                                                    fused_update=True))
        if both:
            out = out.replace(gossip=dataclasses.replace(
                cfg.gossip, fused_update="on"))
        return out

    gossip_keys = (("avg_train_loss", "avg_test_loss"),
                   ("avg_train_acc", "avg_test_acc"))
    fed_keys = (("train_loss", "test_loss", "local_loss"),
                ("train_acc", "test_acc"))
    slice_launch, slice_rate = {}, {}
    # One round each (cut from 2 for the budget) but 9c's, which 9f holds
    # blocked.
    for key, preset, cls, both, keys, workers, n_rounds in (
            ("9a", "reference-gossip", GossipTrainer, True, gossip_keys, 6,
             1),
            ("9b", "baseline2", GossipTrainer, True, gossip_keys, 16, 1),
            ("9c", "baseline1", GossipTrainer, True, gossip_keys, 4, rounds),
            ("9d", "baseline4", FederatedTrainer, False, fed_keys, 16, 1),
            ("9e", "reference-fedlcon", GossipTrainer, False, gossip_keys, 6,
             1),
            ("9e", "reference-nocons-noniid", GossipTrainer, False,
             gossip_keys, 6, 1),
            ("9e", "reference-centralized", GossipTrainer, False,
             gossip_keys, 1, 1)):
        cfg = switched(get_preset(preset), both)
        switches = "both fused switches" if both else "optim.fused_update"
        base = torch.cuda.memory_allocated()
        tr, slice_launch[preset], wall = main_path(
            f"{key} {preset} ({switches})", cls, n_rounds, *keys, workers,
            cfg=cfg)
        slice_rate[preset] = (n_rounds / wall,
                              torch.cuda.max_memory_allocated() - base)
        if preset == "baseline1":
            b1_cfg, b1_state = cfg, state(tr)
        del tr
        torch.cuda.empty_cache()
    for preset, (rate, peak) in slice_rate.items():
        print(f"9 {preset}: {rate:.4f} rounds/s, peak allocated {peak} B "
              f"over what was allocated before the trainer, launches "
              f"{slice_launch[preset]}; {smi}")

    print(f"elapsed {time.perf_counter() - T0:.1f} s at phase 9f")
    # -- 9f. the matching path, bit for bit ------------------------------
    gossip9 = switched(get_preset("reference-gossip"))
    small9 = gossip9.replace(
        data=dataclasses.replace(gossip9.data, synthetic_train_size=6_000,
                                 synthetic_test_size=1_000),
        gossip=dataclasses.replace(gossip9.gossip, local_ep=1))
    ref_tr, ref_launch = counted_run(GossipTrainer, small9, 3, 1)
    ref9 = state(ref_tr)
    del ref_tr
    if ref_launch["fused_mix_sgd"] == 0:
        fail("9f: the matching path launched no kernel 2")
    again, again_launch = counted_run(GossipTrainer, small9, 3, 1)
    same_state("9f reference-gossip (6,000/1,000, local_ep 1), two runs",
               ref9, state(again))
    if again_launch != ref_launch:
        fail(f"9f: launches {again_launch} != {ref_launch}")
    del again
    blocked("reference-gossip (6,000/1,000, local_ep 1), prefetch on",
            GossipTrainer, prefetched(small9), ref9, ref_launch, 3, 2,
            phase="9f")
    ckdir9 = Path(tempfile.mkdtemp(prefix="dopt-torch-ckpt-"))
    try:
        fused_sgd_momentum.launches = 0
        fused_mix_sgd.launches = 0
        victim = GossipTrainer(small9, device=dev)
        victim.run(rounds=2, checkpoint_every=1,
                   checkpoint_path=ckdir9 / "g")
        del victim
        resumed = GossipTrainer(small9, device=dev)
        resumed.restore(ckdir9 / "g")
        if resumed.round != 2:
            fail(f"9f: restored at round {resumed.round}, expected 2")
        resumed.run(rounds=1)
        torch.cuda.synchronize()
        same_state("9f reference-gossip, killed after round 1 and resumed, "
                   "against the continuous run", ref9, state(resumed))
        if launch_counts() != ref_launch:
            fail(f"9f resume: launches {launch_counts()} != {ref_launch}")
        del resumed
    finally:
        shutil.rmtree(ckdir9, ignore_errors=True)
    blocked("baseline1 (both fused switches)", GossipTrainer, b1_cfg,
            b1_state, slice_launch["baseline1"], rounds, 2, phase="9f")
    # 9g: baseline1's per-round round is host-bound (470 eager steps of a
    # small MLP); its rate per-round against blocked, as 7c (eval only in
    # round 0, one warm-up block, 2 timed rounds: cut from 4 for the
    # budget).
    b1_rate = {}
    for mode, block in (("per-round", 1), ("blocked", 2)):
        tr = GossipTrainer(b1_cfg, device=dev, eval_every=10 ** 6)
        tr.run(rounds=block, block=block)
        torch.cuda.synchronize()
        t = time.perf_counter()
        tr.run(rounds=2, block=block)
        torch.cuda.synchronize()
        b1_rate[mode] = 2 / (time.perf_counter() - t)
        if not all(math.isfinite(r["avg_train_loss"])
                   for r in tr.history.rows):
            fail(f"9g baseline1 {mode}: non-finite train loss")
        del tr
    print(f"9g baseline1: blocked {b1_rate['blocked']:.4f} against per-round "
          f"{b1_rate['per-round']:.4f} rounds/s: "
          f"{b1_rate['blocked'] / b1_rate['per-round']:.3f}x; {smi}")
    print(f"9: phases 9a-9f in {time.perf_counter() - t9:.1f} s")

    print(f"elapsed {time.perf_counter() - T0:.1f} s at phase 10")
    # -- 10. the gossip fault model ----------------------------------------
    t10 = time.perf_counter()
    from dopt_torch.faults import FaultPlan

    def fault_state(tr) -> dict:
        """``state`` plus the fault model's carried state: the ledger,
        the quarantine's host mirrors, push-sum's mass and the staleness
        buffers."""
        out = state(tr)
        # Rows as JSON text, so NaN (an undefended lie's loss) compares
        # equal to NaN.
        out["rows"] = [json.dumps(r) for r in out["rows"]]
        out["ledger"] = [dict(r) for r in tr.history.faults]
        out["mirrors"] = [tr._screen_streak.tolist(),
                          tr._quarantine_until.tolist()]
        for name in ("_mass", "_link_buf_mass"):
            if getattr(tr, name, None) is not None:
                out[name] = {"": getattr(tr, name).cpu().numpy().copy()}
        if getattr(tr, "_link_buf", None) is not None:
            out["_link_buf"] = {k: v.float().cpu().numpy().copy()
                                for k, v in tr._link_buf.items()}
        return out

    def host_ledger(cfg, n_rounds) -> list:
        """The ledger dopt_torch.faults and the engine's host stage write
        for ``cfg`` with no device run (on a config whose screen never
        fires: the link path screens nothing)."""
        tr = GossipTrainer(cfg, device="cpu")
        rows = []
        for t in range(n_rounds):
            out = tr._round_inputs(t, tr._matrix_for_round(t))
            rows += out[4]
        del tr
        return rows

    def fault_run(label, cfg, n_rounds, block, want=None, want_launch=None,
                  prof=False, finite=True):
        """A fresh trainer on the card: n rounds in blocks of ``block``,
        finite train losses (unless ``finite`` is off), rounds/s and peak
        memory; against ``want``/``want_launch`` bit for bit when
        given."""
        base = torch.cuda.memory_allocated()
        tr = GossipTrainer(cfg, device="cuda")
        fused_sgd_momentum.launches = 0
        fused_mix_sgd.launches = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        tr.run(rounds=n_rounds, block=block)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        got = launch_counts()
        st = fault_state(tr)
        peak = torch.cuda.max_memory_allocated() - base
        if finite and not all(math.isfinite(r["avg_train_loss"])
                              for r in tr.history.rows):
            fail(f"10 {label}: non-finite train loss {st['rows']}")
        print(f"10 {label}: {n_rounds} rounds, block {block}: "
              f"{n_rounds / wall:.4f} rounds/s, peak {peak} B over what was "
              f"allocated before, launches {got}, {len(st['ledger'])} ledger "
              f"rows; {smi}")
        if want is not None:
            same_state(f"10 {label}, against per-round", want, st)
            if got != want_launch:
                fail(f"10 {label}: launches {got} != {want_launch}")
        idle = (profile_round(f"10 {label}", functools.partial(
            tr.run, rounds=1, block=block), model=tr.cfg.model.model)
                if prof else None)
        return tr, st, got, n_rounds / wall, peak, idle

    # 10a/10b: the chaos cocktail as typed, then with kernel 1 (gated).
    chaos = get_preset("bench-chaos-baseline1-lossy")
    chaos_rows = host_ledger(chaos, 2)
    fault_rate, fault_launch = {}, {}
    # The cocktail's scale lies reach the receivers undefended (the link
    # path screens nothing, in dopt as here), so its losses may grow past
    # the finite range within a few rounds; what holds it is the ledger
    # and the bit-identity of its per-round and blocked runs.
    for key, cfg in (("10a", chaos),
                     ("10b", chaos.replace(optim=dataclasses.replace(
                         chaos.optim, fused_update=True)))):
        # 2 rounds (one block), cut from 4 for the budget.
        tr, ref, got, rate, peak, _ = fault_run(
            f"{key} {cfg.name} per-round", cfg, 2, 1, finite=False)
        steps_chaos = 2 * tr.steps_per_round
        del tr
        if ref["ledger"] != chaos_rows:
            fail(f"{key}: the card's ledger differs from the host's: "
                 f"{ref['ledger']} vs {chaos_rows}")
        kinds = sorted({r["kind"] for r in ref["ledger"]})
        print(f"{key} ledger: {len(chaos_rows)} rows ({kinds}) equal to "
              "the host's dopt_torch.faults ledger")
        tr, _, _, brate, bpeak, idle = fault_run(
            f"{key} {cfg.name} blocked", cfg, 2, 2, ref, got,
            prof=key == "10a", finite=False)
        steady = None
        if key == "10a":
            # The timed blocked run above includes round 0's eager
            # warm-up and the capture; the steady rate is that of 2
            # replayed rounds, one block (cut from 4 for the budget;
            # 10b's shape is 10a's with kernel 1).
            torch.cuda.synchronize()
            t = time.perf_counter()
            tr.run(rounds=2, block=2)
            torch.cuda.synchronize()
            steady = 2 / (time.perf_counter() - t)
            print(f"{key} {cfg.name}: steady blocked rate {steady:.4f} "
                  f"rounds/s (2 replayed rounds, one block of 2, eval each "
                  f"round); graphs {tr.graphs.captures}")
        losses = [r["avg_train_loss"] for r in tr.history.rows]
        print(f"{key} train losses {losses}")
        del tr
        fault_rate[key] = (rate, brate, peak, bpeak, idle, steady)
        fault_launch[{"10a": "bench-chaos-baseline1-lossy",
                      "10b": "bench-chaos-baseline1-lossy-gated"}[key]] = got
        extra = ("" if steady is None else
                 f" (steady {steady:.4f}, {steady / rate:.3f}x per-round; "
                 f"idle share of a profiled blocked round "
                 f"{100 * idle:.1f}%)")
        print(f"{key} {cfg.name}: per-round {rate:.4f}, blocked {brate:.4f} "
              f"rounds/s{extra}; peak {peak} / {bpeak} B; {smi}")
        torch.cuda.empty_cache()
    if fault_launch["bench-chaos-baseline1-lossy"]["fused_sgd_momentum"]:
        fail("10a: kernel 1 launched on a run with optim.fused_update off")
    got = fault_launch["bench-chaos-baseline1-lossy-gated"]
    if got["fused_sgd_momentum"] != steps_chaos:
        fail(f"10b: {got} launches of kernel 1, expected {steps_chaos} (one "
             "a step)")

    # 10c: dopt's three gossip fault presets at full width.
    # baseline1-faulty and baseline1-lossy one round each (cut from 2 for
    # the budget).
    b1f = switched(get_preset("baseline1-faulty"))
    tr, _, got, rate, peak, _ = fault_run("10c baseline1-faulty (both fused "
                                          "switches)", b1f, 1, 1)
    fault_launch["baseline1-faulty"] = got
    fault_rate["10c baseline1-faulty"] = (rate, None, peak, None, None, None)
    if got["fused_mix_sgd"] != 1 or not got["fused_sgd_momentum"]:
        fail(f"10c baseline1-faulty: launches {got}")
    del tr
    byz = get_preset("baseline1-byzantine")
    tr, st, got, rate, peak, _ = fault_run("10c baseline1-byzantine", byz, 9,
                                           3)
    fault_rate["10c baseline1-byzantine"] = (None, rate, None, peak, None,
                                             None)
    # The schedule (quarantine_after 3, quarantine_rounds 5): the pinned
    # liar (worker 0) is screened in rounds 0-2 and benched at round 2
    # until round 8; every sentence passed at round r runs to r + 6,
    # the benched worker is neither screened nor a liar meanwhile, and
    # it is readmitted at its sentence's end.
    quar = [(r["round"], r["worker"], r["action"]) for r in st["ledger"]
            if r["kind"] == "quarantine"]
    print(f"10c baseline1-byzantine quarantine rows: {quar}")
    if (2, 0, "quarantined_until_8") not in quar:
        fail(f"10c: the liar was not benched at round 2 until 8: {quar}")
    for r, w, action in quar:
        if not action.startswith("quarantined_until_"):
            continue
        until = int(action.rsplit("_", 1)[1])
        if until != r + 6:
            fail(f"10c: sentence {action} at round {r}")
        if until <= 8 and (until, w, "readmitted") not in quar:
            fail(f"10c: worker {w} not readmitted at round {until}: {quar}")
        if any(x["worker"] == w and r < x["round"] < until
               and x["kind"] == "corrupt" for x in st["ledger"]):
            fail(f"10c: worker {w} lied or was screened while benched")
    del tr
    lossy = get_preset("baseline1-lossy")
    tr, st, got, rate, peak, _ = fault_run("10c baseline1-lossy", lossy, 1,
                                           1)
    fault_rate["10c baseline1-lossy"] = (rate, None, peak, None, None, None)
    total = float(tr._mass.double().sum()
                  + tr._link_buf_mass.double().sum())
    print(f"10c baseline1-lossy: mass {tr._mass.tolist()} + in flight "
          f"{tr._link_buf_mass.sum().item():.6f} = {total:.6f} (n = 4)")
    if abs(total - 4.0) > 1e-4:
        fail(f"10c: push-sum lost mass: {total}")
    del tr
    torch.cuda.empty_cache()

    # 10d: the faulty headline, killed after round 1 and resumed.
    fhead = get_preset("headline-dsgd-model1-faulty")
    tr, fh_state, fh_launch, rate, peak, idle = fault_run(
        "10d headline-dsgd-model1-faulty", fhead, rounds, 1, prof=False)
    fault_rate["10d"] = (rate, None, peak, None, None, None)
    fault_launch["headline-dsgd-model1-faulty"] = fh_launch
    straggles = [r for r in fh_state["ledger"] if r["kind"] == "straggler"]
    print(f"10d ledger {fh_state['ledger']}; stragglers {len(straggles)}")
    if fh_launch["fused_mix_sgd"] != rounds * tr.fused_spec.num_buckets:
        fail(f"10d: kernel 2 launches {fh_launch}")
    del tr
    ckdir10 = Path(tempfile.mkdtemp(prefix="dopt-torch-ckpt-"))
    try:
        fused_sgd_momentum.launches = 0
        fused_mix_sgd.launches = 0
        victim = GossipTrainer(fhead, device=dev)
        victim.run(rounds=1, checkpoint_every=1,
                   checkpoint_path=ckdir10 / "h")
        del victim
        resumed = GossipTrainer(fhead, device=dev)
        resumed.restore(ckdir10 / "h")
        resumed.run(rounds=rounds - 1)
        torch.cuda.synchronize()
        same_state("10d headline-dsgd-model1-faulty, killed after round 0 "
                   "and resumed, against the continuous run", fh_state,
                   fault_state(resumed))
        if launch_counts() != fh_launch:
            fail(f"10d resume: launches {launch_counts()} != {fh_launch}")
        del resumed
    finally:
        shutil.rmtree(ckdir10, ignore_errors=True)
    torch.cuda.empty_cache()

    # 10e: the new kernel sites against their plain versions, timed.
    from dopt_torch.ops.fused_update import gated_sgd_momentum_reference
    from dopt_torch.topology import repair_for_dropout, repair_for_partition

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def gated_site(label, leaf_shapes, workers, on) -> dict:
        """Kernel 1 gated: lanes ``on`` update (step 0 < limit), the
        rest skip; bit-identical to torch.where over the ungated plain
        step; its bound moves only the lanes that update."""
        limit = torch.tensor([1 if w in on else 0 for w in range(workers)],
                             dtype=torch.int32, device=dev)
        sizes = [workers * math.prod(s) for s in leaf_shapes.values()]
        p_, m_, g_ = ([randn(workers, *s) for s in leaf_shapes.values()]
                      for _ in range(3))
        pk, mk_ = [t.clone() for t in p_], [t.clone() for t in m_]
        pr, mr = [t.clone() for t in p_], [t.clone() for t in m_]
        fused_sgd_momentum(pk, mk_, g_, lr=lr1, mu=mu1, limit=limit, step=0)
        gated_sgd_momentum_reference(pr, mr, g_, lr=lr1, momentum=mu1,
                                     limit=limit, step=0)
        torch.cuda.synchronize()
        err = max(within(a, b, 0.0, 0.0) for a, b in zip(pk + mk_, pr + mr))
        off = [w for w in range(workers) if w not in on]
        for a, b in zip(pk + mk_, p_ + m_):
            if off and not torch.equal(a[off], b[off]):
                fail(f"gated kernel 1 {label}: a gated-off lane changed")
        out = {"ms": time_ms(lambda: fused_sgd_momentum(
                   pk, mk_, g_, lr=lr1, mu=mu1, limit=limit, step=0)),
               "plain_ms": time_ms(lambda: gated_sgd_momentum_reference(
                   pr, mr, g_, lr=lr1, momentum=mu1, limit=limit, step=0)),
               "library_ms": None, "max_abs_err": err}
        lp = [t.clone().requires_grad_() for t in p_]
        for t_, gr in zip(lp, g_):
            t_.grad = gr.clone()
        ungated = time_ms(torch.optim.SGD(lp, lr=lr1, momentum=mu1,
                                          fused=True).step)
        elems = sum(sizes) * len(on) // workers
        out["bound_ms"], out["bound_by"] = bound_ms(20 * elems + 4 * workers,
                                                    4 * elems)
        print(f"kernel fused_sgd_momentum gated {label}: {len(on)} of "
              f"{workers} lanes on, {sum(sizes)} f32 elements, max abs err "
              f"{err:.3e} (bit-identical required); kernel {out['ms']:.4f} "
              f"ms, plain {out['plain_ms']:.4f} ms, SGD(fused=True) "
              f"ungated {ungated:.4f} ms, bound {out['bound_ms']:.4f} ms "
              f"({out['bound_by']})")
        return out

    site["k1 chaos gated"] = gated_site("chaos mlp W=4", mlp_s, 4, {0, 1, 2})
    site["k1 headline gated"] = gated_site("faulty headline model1 W=6",
                                           shapes, 6, {0, 1, 2, 3, 5})
    w4 = build_mixing_matrices("circle", "metropolis", 4,
                               seed=2028).for_round(0)
    w4 = repair_for_dropout(w4, np.array([1, 0, 1, 1], np.float32))
    site["k2 baseline1-faulty"] = k2_site(
        "baseline1-faulty mlp n=4, crash-repaired metropolis ring, lr 1",
        mlp_s, as_w(w4), 1.0)
    w6 = build_mixing_matrices("circle", "stochastic", 6,
                               seed=2028).for_round(0)
    w6 = repair_for_partition(w6, np.array([0, 0, 1, 1, 1, 0]))
    w6 = repair_for_dropout(w6, np.array([1, 1, 1, 0, 1, 1], np.float32))
    site["k2 headline-faulty"] = k2_site(
        "faulty headline model1 n=6, partition- and crash-repaired, lr 1",
        shapes, as_w(w6), 1.0)
    del flush
    for key, (rate, brate, peak, bpeak, idle, steady) in fault_rate.items():
        print(f"10 rates {key}: per-round {rate}, blocked {brate} (steady "
              f"{steady}) rounds/s; peaks {peak} / {bpeak} B; idle {idle}; "
              f"{smi}")
    print(f"10: phase 10 in {time.perf_counter() - t10:.1f} s")

    print(f"elapsed {time.perf_counter() - T0:.1f} s at phase 11")
    # -- 11. the federated fault model ------------------------------------
    import types

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    fed11 = phase11(dev, smi, get_preset, types.SimpleNamespace(
        time_ms=time_ms, k2_site=k2_site, gated_site=gated_site,
        profile_round=profile_round))
    print(f"elapsed {time.perf_counter() - T0:.1f} s at phase 12")

    # -- 12. async and one-peer mixing, telemetry and diagnostics --------
    obs12 = phase12(dev, smi, get_preset, types.SimpleNamespace(
        time_ms=time_ms, k1_site=k1_site, k2_site=k2_site,
        profile_round=profile_round, g_state=g_state, glaunch=glaunch,
        f_state=f_state, flaunch=flaunch))
    print(f"elapsed {time.perf_counter() - T0:.1f} s at phase 13")

    # -- 13. ResNet-18 and baseline5 at full width ------------------------
    ckdir = Path(tempfile.mkdtemp(prefix="dopt-torch-ckpt-"))
    try:
        res13 = phase13(dev, smi, get_preset, types.SimpleNamespace(
            time_ms=time_ms, k1_site=k1_site, k2_site=k2_site), ckdir)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    print(f"elapsed {time.perf_counter() - T0:.1f} s at phase 14")

    # -- 14. choco and the narrowed wire ----------------------------------
    ckdir = Path(tempfile.mkdtemp(prefix="dopt-torch-ckpt-"))
    try:
        res14 = phase14(dev, smi, get_preset, types.SimpleNamespace(
            flush=flush, rounds=rounds, gwall=gwall, fwall=fwall), ckdir)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    print(f"elapsed {time.perf_counter() - T0:.1f} s at phase 15")

    # -- 15. scatter, shift and the bucket codec --------------------------
    ckdir = Path(tempfile.mkdtemp(prefix="dopt-torch-ckpt-"))
    try:
        res15 = phase15(dev, smi, get_preset, types.SimpleNamespace(
            flush=flush, f32wire=res14["f32wire"]), ckdir)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    print(f"elapsed {time.perf_counter() - T0:.1f} s at phase 16")

    # -- 16. the client population ----------------------------------------
    ckdir = Path(tempfile.mkdtemp(prefix="dopt-torch-ckpt-"))
    try:
        res16 = phase16(dev, smi, get_preset, ckdir)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    print(f"elapsed {time.perf_counter() - T0:.1f} s at phase 17")

    # -- 17. the multi-GPU engines ----------------------------------------
    ckdir = Path(tempfile.mkdtemp(prefix="dopt-torch-ckpt-"))
    try:
        res17 = phase17(dev, smi, get_preset, types.SimpleNamespace(
            k1_site=k1_site, f32wire=res14["f32wire"]), ckdir)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    del flush
    print(f"elapsed {time.perf_counter() - T0:.1f} s at phase 18")

    # -- 18. the sequence-parallel LM --------------------------------------
    phase18(dev, smi)
    print(f"elapsed {time.perf_counter() - T0:.1f} s at phase 19")

    # -- 19. the resident serve daemon -------------------------------------
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    window23: dict = {}
    res19 = phase19(dev, smi, get_preset, types.SimpleNamespace(
        k2_site=k2_site, rounds=rounds, gwall=gwall, fwall=fwall,
        beside=lambda: window23.update(phase23_window(dev, smi))))
    del flush
    print(f"elapsed {time.perf_counter() - T0:.1f} s at phase 20")

    # -- 20. the meters and the stream tools -------------------------------
    phase20(dev, smi, types.SimpleNamespace(
        rounds=rounds, gwall=gwall, fwall=fwall,
        bf16_wall=fast_walls["headline-dsgd-model1-bf16"], samples=samples,
        prof6=prof6, g_events=g_events, b_events=b_stream.events,
        res19=res19))
    print(f"elapsed {time.perf_counter() - T0:.1f} s at phase 23")

    # -- 23. dopt's acceptance harnesses (begun in phase 19's shared
    # window; nothing is timed from there to here) ------------------------
    res23 = phase23(dev, smi, get_preset, window23)
    print(f"elapsed {time.perf_counter() - T0:.1f} s at phase 21")

    # -- 21. backend="torch" and stacked_impl="vmap" -----------------------
    launch21 = phase21(dev, smi, get_preset, types.SimpleNamespace(
        rounds=rounds, gwall=gwall, g_rows=g_state["rows"]))
    print(f"elapsed {time.perf_counter() - T0:.1f} s at phase 22")

    # -- 22. dopt's library surface ----------------------------------------
    res22 = phase22(dev, smi, get_preset, types.SimpleNamespace(
        flush=torch.empty(256 << 20, dtype=torch.uint8, device=dev),
        resnet_cpu=res23["resnet_cpu"]))
    print(f"elapsed {time.perf_counter() - T0:.1f} s at the kernels line "
          f"(this host: the gossip headline at {gwall / rounds:.3f} s a "
          f"round in phase 5); {smi}")

    source = "dopt_torch/csrc/fused_update.cu"
    kernels = []
    for suffix, path, launched, t1, t2 in (
            ("", "gossip", glaunch, k1, k2),
            (":federated", "federated", flaunch, k1f, k2f),
            (":gossip-bf16", "gossip, bf16 storage", bf16_launch["gossip"],
             k1b, k2b),
            (":federated-bf16", "federated, bf16 storage",
             bf16_launch["federated"], k1fb, k2fb),
            (":gossip-resume", "gossip, killed and resumed",
             resume["gossip"]["launches"], k1, k2),
            (":federated-resume", "federated, killed and resumed",
             resume["federated"]["launches"], k1f, k2f),
            (":gossip-bf16-resume", "gossip, bf16 storage, killed and "
             "resumed", resume["gossip-bf16"]["launches"], k1b, k2b),
            (":gossip-profiled", "gossip, one round under the profiler "
             "(phase 6)", prof6["launches"], k1, k2),
            (":gossip-profiled-replay", "gossip, one blocked round (graph "
             "replay) under the profiler (7c)",
             prof7c["headline-dsgd-model1"]["launches"], k1, k2)):
        kernels.append({"name": "fused_sgd_momentum" + suffix, "path": path,
                        "route": "cuda", "source": source,
                        "replaces": "dopt/ops/fused_update.py:57",
                        "launches": launched["fused_sgd_momentum"], **t1})
        kernels.append({"name": "fused_mix_sgd" + suffix, "path": path,
                        "route": "cuda", "source": source,
                        "replaces": "dopt/ops/fused_update.py:134",
                        "launches": launched["fused_mix_sgd"], **t2})
    for preset, path, t1, t2 in (
            ("reference-gossip", "reference-gossip: Model1, 6 workers, a "
             "matching a round", k1, site["k2 gossip"]),
            ("baseline2", "baseline2: Model3 on CIFAR-10 shapes, 16 workers, "
             "kernel 2's ring at lr +1", site["k1 baseline2"],
             site["k2 baseline2"]),
            ("baseline1", "baseline1: MLP, 4 workers", site["k1 baseline1"],
             site["k2 baseline1"]),
            ("baseline1-oracle-check", "21a: baseline1 as typed with both "
             "fused switches, one round from the oracle's init and held "
             "to backend='torch': MLP, 4 workers, kernel 1 every step, "
             "kernel 2 once a round", site["k1 baseline1"],
             site["k2 baseline1"]),
            ("baseline4", "baseline4: logistic fedadmm, 16 lanes",
             site["k1 baseline4"], None),
            ("reference-fedlcon", "reference-fedlcon: Model1, 6 workers, 5 "
             "sweeps", k1, None),
            ("reference-nocons-noniid", "reference-nocons-noniid: Model1, 6 "
             "workers", k1, None),
            ("reference-centralized", "reference-centralized: Model1, one "
             "worker", site["k1 centralized"], None),
            ("bench-chaos-baseline1-lossy-gated", "bench-chaos-baseline1-"
             "lossy with optim.fused_update: MLP, 4 workers, kernel 1 gated "
             "by the straggler budget", site["k1 chaos gated"], None),
            ("baseline1-faulty", "baseline1-faulty: MLP, 4 workers, kernel "
             "1 gated, kernel 2 on the crash/partition-repaired W",
             site["k1 chaos gated"], site["k2 baseline1-faulty"]),
            ("headline-dsgd-model1-faulty", "headline-dsgd-model1-faulty: "
             "Model1, 6 workers, kernel 1 gated, kernel 2 on the repaired W",
             site["k1 headline gated"], site["k2 headline-faulty"]),
            ("headline-fedavg-model1-faulty", "headline-fedavg-model1-"
             "faulty: Model1, 16 lanes, kernel 1 gated by the partial "
             "stragglers' budget, kernel 2 on the survivors' mask at lr -1",
             fed11["site"]["k1"], fed11["site"]["k2"]),
            ("bench-topo-one_peer_exp-sync", "bench-topo-one_peer_exp-sync "
             "with both fused switches: MLP, 32 workers, kernel 1 over 32 "
             "lanes, kernel 2's ring kernel at n = 32",
             obs12["site"]["k1"], obs12["site"]["k2"]),
            ("headline-dsgd-model1-diagnostics", "headline-dsgd-model1 with "
             "diagnostics on and a telemetry stream", k1, k2),
            ("headline-fedavg-model1-diagnostics", "headline-fedavg-model1 "
             "with diagnostics on and a telemetry stream", k1f, k2f),
            ("baseline5", "baseline5 with both fused switches: ResNet-18, "
             "32 workers, kernel 1 in 4 launches over 62 tensors a step, "
             "kernel 2's ring kernel at n = 32 over 11 buckets",
             res13["site"]["k1"], res13["site"]["k2"]),
            *((f"headline-dsgd-model1-choco-{c}", "headline-dsgd-model1 "
               f"with choco {c} (γ = 0.1) and the fused epilogue off: "
               "Model1, 6 workers, kernel 1 every step, kernel 2 never",
               k1, None) for c in ("topk", "randk", "qsgd")),
            ("headline-dsgd-model1-wire-bf16", "headline-dsgd-model1 with "
             "comm_dtype bfloat16 and the fused epilogue off: kernel 1 every "
             "step, kernel 2 never", k1, None),
            ("headline-fedavg-model1-wire-bf16", "headline-fedavg-model1 "
             "with comm_dtype bfloat16 and the fused epilogue off: 16 lanes, "
             "kernel 1 every step, kernel 2 never", k1f, None),
            ("baseline5-choco-randk", "baseline5 with choco rand-k 0.01, bf16 "
             "compute, the fused epilogue off: kernel 1 in 4 launches over "
             "62 tensors a step, kernel 2 never", res13["site"]["k1"], None),
            *((f"headline-dsgd-model1-scatter{s}", "headline-dsgd-model1 "
               f"with update_sharding scatter{d} and the fused epilogue "
               "off: kernel 1 every step, kernel 2 never", k1, None)
              for s, d in (("", ""), ("-q8", ", the q8 bucket codec"),
                           ("-q4", ", the q4 bucket codec (lossy-link "
                            "budget)"), ("-shift", ", comm_impl shift"))),
            *((f"headline-fedavg-model1-scatter{s}", "headline-fedavg-"
               f"model1 with the scatter reduce{d} and the fused epilogue "
               "off: 16 lanes, kernel 1 every step, kernel 2 never", k1f,
               None) for s, d in (("", ""), ("-wire-bf16",
                                             ", comm.wire_dtype bfloat16"))),
            ("baseline5-scatter-q8", "baseline5 with scatter and the q8 "
             "bucket codec, bf16 compute, the fused epilogue off: kernel 1 "
             "in 4 launches over 62 tensors a step, kernel 2 never",
             res13["site"]["k1"], None),
            ("baseline3-xclients", "baseline3-xclients with kernel 1: 1,000 "
             "clients, cohorts of 64 in 4 waves of 16 Model1 lanes, kernel 1 "
             "every step of every wave (the federated site's shapes), kernel "
             "2 never (dopt refuses the fused epilogue in population mode)",
             k1f, None),
            ("headline-dsgd-model1-population", "headline-dsgd-model1 with "
             "600 clients and cohorts of 6 bound onto its lanes, the fused "
             "epilogue off: kernel 1 every step, kernel 2 never", k1,
             None),
            ("served-headline-dsgd-model1", "headline-dsgd-model1 served by "
             "dopt_torch.serve (19a: leave w3 @1, optim.lr by rebuild @2, "
             "join @3; 4 rounds): Model1, 6 workers, kernel 2 on the "
             "churn-repaired W", k1, res19["site"]),
            ("served-headline-dsgd-model1-resumed", "19b: 19a's state after "
             "boundary 3 resumed in a fresh daemon (round 3)", k1,
             res19["site"]),
            ("served-headline-fedavg-model1", "headline-fedavg-model1 served "
             "(19c: leave w3 @1; 2 rounds): 16 lanes, kernel 2 at lr -1 over "
             "the present sampled lanes", k1f, k2f),
            *((f"headline-{e}-model1-ranks2{s}", f"headline-{e}-model1 at 2 "
               f"ranks{d}, kernel 1 on and the fused epilogue off (dopt "
               f"refuses it across devices): {lanes} lanes a rank, kernel 1 "
               "every step on each rank (launches: rank 0's), kernel 2 never",
               res17["site"][part], None)
              for e, part, lanes in (("dsgd", "a", 3), ("fedavg", "b", 8))
              for s, d in (("", " sharing the card over host-staged gloo"),
                           ("-nccl", " over NCCL, one rank a card"))
              if f"headline-{e}-model1-ranks2{s}" in res17["launch"])):
        launched = {**slice_launch, **fault_launch,
                    "headline-fedavg-model1-faulty": fed11["launch"],
                    **obs12["launch"], "baseline5": res13["launch"],
                    **res14["launch"], **res15["launch"],
                    **res16["launch"], **res17["launch"],
                    "served-headline-dsgd-model1":
                        res19["launch"]["served-gossip"],
                    "served-headline-dsgd-model1-resumed":
                        res19["launch"]["served-gossip-resumed"],
                    "served-headline-fedavg-model1":
                        res19["launch"]["served-fedavg"],
                    "baseline1-oracle-check": launch21}[preset]
        kernels.append({"name": "fused_sgd_momentum:" + preset, "path": path,
                        "route": "cuda", "source": source,
                        "replaces": "dopt/ops/fused_update.py:57",
                        "launches": launched["fused_sgd_momentum"], **t1})
        if t2 is not None:
            kernels.append({"name": "fused_mix_sgd:" + preset, "path": path,
                            "route": "cuda", "source": source,
                            "replaces": "dopt/ops/fused_update.py:134",
                            "launches": launched["fused_mix_sgd"], **t2})
    for name, preset in LIBRARY_PRESETS.items():
        kernels.append({
            "name": f"fused_sgd_momentum:library-{name}",
            "path": f"22a: build_model('{name}') at {preset}'s width, one "
                    "worker, batch 128, 3 steps of cross_entropy, autograd "
                    "and fused_sgd_momentum_tree (a launch per 16 tensors a "
                    "step); timed at the same site (22c)",
            "route": "cuda", "source": source,
            "replaces": "dopt/ops/fused_update.py:57",
            "launches": res22[name]["launches"]["fused_sgd_momentum"],
            **res22[name]["row"]})
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:] == ["--conv-ab"]:
        conv_ab()
    elif sys.argv[1:2] == ["--resnet-ab"] and len(sys.argv) == 3:
        resnet_ab(sys.argv[2])
    else:
        main()
