#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (dopt_torch) on one CUDA GPU.

    python3 chip_smoke.py        # from the repo root; one GPU, nvcc

Phases, each printing its own lines; any failure exits non-zero before
the final line:

1. environment — nvidia-smi name and power limit, torch/CUDA versions;
2. build — nvcc builds dopt_torch/csrc into build/ (timed);
3. kernels — each CUDA kernel against its plain PyTorch version on the
   card at the main path's shapes (plus odd, strided and bf16 cases),
   with the tolerance stated, and CUDA-event median times (cold L2) of
   the kernel, the plain version and one library call computing the
   same function, beside the bound (bytes over 3.35 TB/s, operations
   over the f32 peak);
4. small-input agreement — a tiny run on the GPU against the same run
   on the CPU (the kernels' plain versions), same init;
5. main path — the headline-dsgd-model1 preset (6 workers, Model1 at
   full width, 60,000/10,000 samples, both fused switches on) for two
   rounds through GossipTrainer; checks finite metrics and that every
   kernel launched exactly as often as the round structure implies;
6. profile — one more round under torch.profiler: device time by kernel.

The line before the last is a JSON object {"kernels": [...]}; the last
is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# NVIDIA H100 SXM data sheet: HBM3 rate and the f32 peak outside the
# tensor cores (both kernels are f32 FMA/elementwise work).
MEM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
REPS = 25


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    raise SystemExit(1)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, to = nbytes / MEM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return 1e3 * max(tb, to), ("bytes" if tb >= to else "operations")


def main() -> None:
    try:
        import numpy as np
        import torch

        from dopt_torch.config import DataConfig, GossipConfig, ModelConfig
        from dopt_torch.engine import GossipTrainer
        from dopt_torch.models.zoo import param_shapes
        from dopt_torch.ops import _build
        from dopt_torch.ops.fused_update import (fused_mix_sgd,
                                                 fused_sgd_momentum,
                                                 mix_sgd_reference,
                                                 sgd_momentum_reference)
        from dopt_torch.parallel.collectives import (alloc_flat,
                                                     flat_buckets,
                                                     make_update_shard_spec)
        from dopt_torch.presets import get_preset
        from dopt_torch.utils.metrics import trimmed_stats
    except ImportError as e:
        fail(f"cannot import the port (run from a checkout of the repo): {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # -- 1. environment ---------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]} device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")

    # -- 2. build ---------------------------------------------------------
    t = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    print(f"build: {lib_path.relative_to(ROOT)} in "
          f"{time.perf_counter() - t:.2f} s")

    # -- 3. kernels against their plain versions --------------------------
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, device=dev, generator=gen).to(dtype)

    def time_ms(fn) -> float:
        """CUDA-event time of one call, L2 flushed before each: the
        median after dropping the fastest and the slowest call."""
        for _ in range(3):
            fn()
        evs = []
        for _ in range(REPS):
            flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            evs.append((a, b))
        torch.cuda.synchronize()
        return trimmed_stats([a.elapsed_time(b) for a, b in evs])[0]

    def within(got, want, rtol, atol) -> float:
        err = (got.float() - want.float()).abs()
        bad = err > atol + rtol * want.float().abs()
        if bool(bad.any()):
            fail(f"kernel disagrees with its plain version: max abs err "
                 f"{err.max().item():.3e} (rtol {rtol}, atol {atol})")
        return float(err.max().item())

    workers = 6
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
        rtol, atol = (0.0, 1e-6) if dtype == torch.float32 else (2 ** -7, 1e-6)
        err = max(within(a, b, rtol, atol) for a, b in zip(pk + mk_, pr + mr))
        print(f"kernel fused_sgd_momentum {label}: {len(sizes)} tensors, "
              f"{sum(sizes)} elements, {dtype}: max abs err {err:.3e} "
              f"(tolerance rtol {rtol} atol {atol})")
        return p, m, g, err

    leaf_sizes = [workers * math.prod(s) for s in shapes.values()]
    p, m, g, err1 = sgd_case("model1 W=6 leaves", leaf_sizes, torch.float32)
    sgd_case("odd length, unaligned", [1_000_003], torch.float32, offset=1)
    sgd_case("model1 W=6 leaves", leaf_sizes, torch.bfloat16)

    k1_ms = time_ms(lambda: fused_sgd_momentum(p, m, g, lr=lr1, mu=mu1))
    k1_plain = time_ms(
        lambda: sgd_momentum_reference(p, m, g, lr=lr1, momentum=mu1))
    k1_lib = None
    try:
        lp = [t.clone().requires_grad_() for t in p]
        for t, gr in zip(lp, g):
            t.grad = gr.clone()
        opt = torch.optim.SGD(lp, lr=lr1, momentum=mu1, fused=True)
    except (TypeError, ValueError, RuntimeError) as e:
        print(f"library: torch.optim.SGD(fused=True) unavailable here ({e})")
    else:
        k1_lib = time_ms(opt.step)
    elems = sum(leaf_sizes)
    k1_bound, k1_by = bound_ms(20 * elems, 4 * elems)
    print(f"time fused_sgd_momentum (one step, {elems} f32 elements): kernel "
          f"{k1_ms:.4f} ms, plain {k1_plain:.4f} ms, library "
          f"{k1_lib if k1_lib is None else round(k1_lib, 4)} ms, bound "
          f"{k1_bound:.4f} ms ({k1_by})")

    mix_err = 0.0
    mix_times = []   # main-path buckets: (kernel, plain, library, bytes, ops)

    def mix_case(label, p_, b_, w, lr, main_path):
        """Kernel 2 on a copy of ``p_`` with the same strides."""
        out = torch.empty_strided(p_.shape, p_.stride(), dtype=p_.dtype,
                                  device=dev).copy_(p_)
        ref = p_.clone()
        fused_mix_sgd(out, b_, w, lr=lr)
        mix_sgd_reference(ref, b_, w, lr=lr)
        torch.cuda.synchronize()
        rtol = 0.0 if p_.dtype == torch.float32 else 2 ** -7
        err = within(out, ref, rtol, 1e-5)
        n, f = p_.shape
        print(f"kernel fused_mix_sgd {label} [{n}, {f}] {p_.dtype} row stride "
              f"{p_.stride(0)}: max abs err {err:.3e} (tolerance rtol {rtol} "
              f"atol 1e-5)")
        if main_path:
            nonlocal mix_err
            mix_err = max(mix_err, err)
            km = time_ms(lambda: fused_mix_sgd(p_, b_, w, lr=lr))
            pm = time_ms(lambda: mix_sgd_reference(p_, b_, w, lr=lr))
            lm = time_ms(lambda: torch.addmm(b_, w, p_, beta=-lr))
            nbytes, flops = 12 * n * f + 4 * n * n, (2 * n + 2) * n * f
            bd, _ = bound_ms(nbytes, flops)
            mix_times.append((km, pm, lm, nbytes, flops))
            print(f"time fused_mix_sgd [{n}, {f}]: kernel {km:.4f} ms, plain "
                  f"{pm:.4f} ms, library (addmm) {lm:.4f} ms, bound "
                  f"{bd:.4f} ms")

    def stochastic(n):
        w = torch.rand(n, n, device=dev, generator=gen)
        return (w / w.sum(1, keepdim=True)).contiguous()

    w6 = stochastic(workers)
    for dtype in (torch.float32, torch.bfloat16):
        # The trainer's flat [W, padded] bucket stores, as it builds them.
        spec = make_update_shard_spec(
            {k: torch.empty(workers, *s, dtype=dtype)
             for k, s in shapes.items()}, bucket_bytes=4 << 20)
        fp, fb = alloc_flat(workers, spec, dev), alloc_flat(workers, spec, dev)
        fp.copy_(randn(*fp.shape))
        fb.copy_(randn(*fb.shape))
        for pb, bb in zip(flat_buckets(fp, spec), flat_buckets(fb, spec)):
            mix_case("main-path bucket", pb, bb, w6, 1.0,
                     dtype == torch.float32)
        for n in (12, 32):
            mix_case(f"{n} workers", randn(n, 65_537, dtype=dtype),
                     randn(n, 65_537, dtype=dtype), stochastic(n), 0.5, False)
    # Empty work launches nothing, so the counters count real launches.
    before = (fused_sgd_momentum.launches, fused_mix_sgd.launches)
    empty = torch.empty(0, device=dev)
    fused_sgd_momentum([empty], [empty.clone()], [empty.clone()],
                       lr=lr1, mu=mu1)
    e2 = torch.empty(workers, 0, device=dev)
    fused_mix_sgd(e2, e2.clone(), w6, lr=1.0)
    if (fused_sgd_momentum.launches, fused_mix_sgd.launches) != before:
        fail("an empty call counted a kernel launch")
    print("empty work: no launch counted")
    # One round's epilogue: the two main-path buckets together.
    k2_ms, k2_plain, k2_lib, k2_bytes, k2_ops = (sum(t[i] for t in mix_times)
                                                 for i in range(5))
    k2_bound, k2_by = bound_ms(k2_bytes, k2_ops)

    # -- 4. small-input agreement: GPU run vs CPU run ----------------------
    tiny = get_preset("headline-dsgd-model1").replace(
        data=DataConfig(dataset="synthetic", num_users=4, iid=False, shards=2,
                        synthetic_train_size=128, synthetic_test_size=32),
        model=ModelConfig(model="model1", input_shape=(8, 8, 1)),
        gossip=GossipConfig(local_ep=1, local_bs=16, fused_update="on"))
    runs = {}
    for d in ("cuda", "cpu"):
        tr = GossipTrainer(tiny, device=d)
        tr.run(rounds=2)
        runs[d] = (tr.history.rows, tr.worker_params())
    for a, b in zip(runs["cuda"][0], runs["cpu"][0]):
        if (abs(a["avg_train_loss"] - b["avg_train_loss"]) > 1e-3
                or abs(a["avg_test_acc"] - b["avg_test_acc"]) > 1e-4):
            fail(f"small-input run disagrees: cuda {a} vs cpu {b}")
    rel = max(float(np.abs(runs["cuda"][1][k] - v).max() / np.abs(v).max())
              for k, v in runs["cpu"][1].items())
    if not rel <= 1e-4:
        fail(f"small-input final params differ by {rel:.3e} (max-relative)")
    print(f"small-input check (8x8 Model1, 4 workers, 2 rounds, both fused "
          f"switches): cuda vs cpu train-loss within 1e-3, params max-rel "
          f"{rel:.3e} (limit 1e-4)")

    # -- 5. main path -----------------------------------------------------
    cfg = get_preset("headline-dsgd-model1")
    t = time.perf_counter()
    trainer = GossipTrainer(cfg, device="cuda")
    print(f"main path: {cfg.name}, {trainer.num_workers} workers, "
          f"{trainer.param_count} params a worker, "
          f"{len(trainer.dataset.train_y)}/{len(trainer.dataset.test_y)} "
          f"samples, built in {time.perf_counter() - t:.2f} s")
    rounds = 2
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
    print(f"main path: {rounds} rounds in {wall:.3f} s = "
          f"{rounds / wall:.4f} rounds/s; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} B")
    want = {"fused_sgd_momentum": rounds * trainer.steps_per_round,
            "fused_mix_sgd": rounds * trainer.fused_spec.num_buckets}
    print(f"kernel launches on the main path: {launches} (expected {want})")
    if launches != want:
        fail(f"kernel launch counts {launches} != expected {want}")
    for row in trainer.history.rows:
        for k in ("avg_train_loss", "avg_test_loss"):
            if not math.isfinite(row[k]):
                fail(f"non-finite {k} in {row}")
        for k in ("avg_train_acc", "avg_test_acc"):
            if not 0.0 <= row[k] <= 1.0:
                fail(f"{k} out of range in {row}")
    final = trainer.worker_params()
    for k, s in shapes.items():
        if final[k].shape != (workers, *s) or not np.isfinite(final[k]).all():
            fail(f"final params {k}: shape {final[k].shape} or non-finite")
    share = (k1_ms * launches["fused_sgd_momentum"]
             + k2_ms * rounds) / (1e3 * wall)
    print(f"kernel share of the main path's wall time (event times x "
          f"launches): {100 * share:.2f}%")

    # -- 6. profile one more round ----------------------------------------
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.run(rounds=1)
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if getattr(e, "device_time_total", 0) > 0
           and e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in evs)
    print(f"profile (1 round): device kernel time {busy / 1e3:.1f} ms over "
          f"{len(evs)} kernel names")
    for e in sorted(evs, key=lambda e: -e.device_time_total)[:12]:
        print(f"  {e.device_time_total / 1e3:9.2f} ms  {e.count:6d}x  "
              f"{e.key[:90]}")

    kernels = [
        {"name": "fused_sgd_momentum", "route": "cuda",
         "source": "dopt_torch/csrc/fused_update.cu",
         "replaces": "dopt/ops/fused_update.py:57",
         "launches": launches["fused_sgd_momentum"], "max_abs_err": err1,
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": k1_lib},
        {"name": "fused_mix_sgd", "route": "cuda",
         "source": "dopt_torch/csrc/fused_update.cu",
         "replaces": "dopt/ops/fused_update.py:134",
         "launches": launches["fused_mix_sgd"], "max_abs_err": mix_err,
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": k2_lib},
    ]
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
