"""The port's device-time and FLOP meters (dopt_torch.utils.profiling)
against dopt's (dopt.utils.profiling), on the CPU.

* ``classify_phase``/``phase_totals``: dopt's rows
  (tests/test_update_sharding.py) classify the same in both packages,
  and the card's kernel names (both hand kernels, NCCL, cuDNN, the f64
  GEMMs of the rounded layers, the plain update's foreach kernels) get
  the phases the port's rules state.  The f64 kernels file under the
  phase of the layer the window's model rounds
  (``models.zoo.ROUNDED_F64``): conv for the convs and ResNet-18's
  GroupNorms, and a scan of the package's code fails on f64 work
  anywhere else.
* ``profiler_op_stats``: the guards left out, and where the summed
  device time exceeds the busy time (overlap within and across streams,
  duplicates), with each phase on the busy basis.
* ``device_stats_of``: dopt's degrade contract (tests/test_obs.py) with
  ``torch.profiler`` stubbed — NaN, empty breakdowns, a ``warning`` field
  and event, ``fn()``'s errors propagate — and dopt's keys on a tiny CPU
  run; ``PhaseTimers.measure`` counts, times and spans; ``trace`` writes
  ``trace.json``, also through ``python -m dopt_torch.run --trace``.
* ``device_peak_flops``: None on the CPU; the table names the H100 SXM
  by its exact name only.
* FLOPs: ``fwd_flops_per_sample`` of each zoo model within 1% of dopt's
  (XLA's cost analysis) on the same shapes, ``train_flops_per_sample``
  exactly 3×, and Model1 within dopt's own 0.6-1.6× band of its analytic
  2 × 12,273,152 (tests/test_aux.py).
"""

from __future__ import annotations

import ast
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dopt.utils.profiling as JP
import dopt_torch.utils.profiling as TP
from dopt_torch.models.zoo import stacked_forward
from dopt_torch.obs import MemorySink, SpanTracer, Telemetry

# tests/test_update_sharding.py's rows (dopt's XLA names and scopes).
DOPT_ROWS = [
    (("convolution", "jit(f)/conv_general"), "conv"),
    (("convert", "jit(f)/convert.5"), "other"),
    (("all-gather", None), "comm"),
    (("fusion", "jit(f)/dopt_mix/dot_general"), "comm"),
    (("fusion", "jit(f)/dopt_update/sub"), "update"),
    (("fusion", "jit(f)/dopt_mix/dopt_update/div"), "update"),
    (("fusion", "jit(f)/add"), "other"),
]

# Kernel names as torch.profiler reports them on the card.
CARD_KERNELS = [
    ("void (anonymous namespace)::sgd_momentum_kernel<float, 4, false>"
     "((anonymous namespace)::SgdArgs)", "update"),
    ("void (anonymous namespace)::mix_sgd_narrow_kernel<float, 6>(float*)",
     "comm"),
    ("void (anonymous namespace)::mix_sgd_ring_kernel<__nv_bfloat16, 32>"
     "(__nv_bfloat16*)", "comm"),
    ("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
     "comm"),
    ("void at::native::multi_tensor_apply_kernel<at::native::"
     "TensorListMetadata<3>, at::native::FusedSgdMathFunctor<float, 3> >",
     "update"),
    ("void cudnn::engines_precompiled::genericTranspose_kernel<float, float, "
     "float, true, (cudnnKernelDataType_t)0>(", "conv"),
    ("sm80_xmma_dgrad_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_tilesize"
     "32x32x8_stage3_warpsize1x2x1_g1_ffma_aligna4", "conv"),
    ("void cudnn::detail::dgrad2d_alg1_1<float, 0, 6, 7, 5, 4, 5, false, "
     "true>(int, int)", "conv"),
    ("void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816wgrad_"
     "optimized_bf16_64x128_64x3_nhwc_align8>", "conv"),
    ("void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816fprop_"
     "optimized_bf16_256x64_32x3_nhwc_align8>", "conv"),
    ("void cudnn::winograd_nonfused::winogradForwardData4x4<float, float>",
     "conv"),
    ("void at::native::(anonymous namespace)::conv_depthwise2d_grad_weight_"
     "kernel<c10::BFloat16, float, int>", "conv"),
    ("void fft2d_r2c_32x32<float, false, 1u, false>(float2*, float const*, "
     "int, int)", "conv"),
    ("sm80_xmma_gemm_cf32cf32_f32f32_cf32_tn_n_tilesize64x64x8_stage3_"
     "warpsize2x2x1_ffma_aligna8_alignc8_execute_kernel__5x_cublas", "conv"),
    ("void flip_filter<float, float>(float*, float const*, int, int, int, "
     "int)", "conv"),
    ("void at::native::vectorized_elementwise_kernel<2, at::native::"
     "FillFunctor<double>, std::array<char*, 1ul> >", "conv"),
    ("sm90_xmma_gemm_f64f64_f64f64_f64_nn_n_tilesize64x32x32_stage3_warpsize"
     "2x2x1_tensor16x8x16_execute_kernel__5x_cublas", "conv"),
    ("void cutlass::Kernel2<cutlass_80_tensorop_d884gemm_64x32_16x4_nn_"
     "align1>(cutlass_80_tensorop_d884gemm_64x32_16x4_nn_align1::Params)",
     "conv"),
    ("void at::native::reduce_kernel<128, 4, at::native::ReduceOp<double, "
     "at::native::func_wrapper_t<double, at::native::sum_functor<double, "
     "double, double>::operator()>", "conv"),
    ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl"
     "_nocast<at::native::direct_copy_kernel_cuda(at::TensorIteratorBase&)::"
     "{lambda()#3}::operator()() const::{lambda()#7}::operator()() const::"
     "{lambda(double)#1}>", "conv"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize32x32x8_stage3_warpsize"
     "1x2x1_ffma_aligna4_alignc4_execute_kernel", "other"),
    ("void at::native::vectorized_elementwise_kernel<8, at::native::"
     "bfloat16_copy_kernel_cuda(at::TensorIteratorBase&)", "other"),
    ("void at::native::(anonymous namespace)::max_pool_backward_nchw<float, "
     "float, int>(float const*)", "other"),
    ("Memcpy DtoD (Device -> Device)", "other"),
]


@pytest.mark.parametrize("row,phase", DOPT_ROWS)
def test_classify_phase_equals_dopts(row, phase):
    assert TP.classify_phase(*row) == JP.classify_phase(*row) == phase


@pytest.mark.parametrize("name,phase", CARD_KERNELS)
def test_classify_card_kernel_names(name, phase):
    assert TP.classify_phase("kernel", name) == phase


def _f64_sites(tree: ast.AST):
    """The f64 tensor work in a module: ``x.double()`` calls and
    ``torch.float64``/``torch.double``, or ``"float64"``/``"double"``
    given as a ``dtype``; each as (line, the top-level class or function
    that holds it)."""
    owner = {}
    for top in tree.body:
        for node in ast.walk(top):
            owner[node] = getattr(top, "name", None)
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "double"):
            yield node.lineno, owner.get(node)
        elif (isinstance(node, ast.Attribute)
              and node.attr in ("float64", "double")
              and isinstance(node.value, ast.Name)
              and node.value.id == "torch"):
            yield node.lineno, owner.get(node)
        elif (isinstance(node, ast.keyword) and node.arg == "dtype"
              and isinstance(node.value, ast.Constant)
              and node.value.value in ("float64", "double")):
            yield node.value.lineno, owner.get(node)


def test_f64_tensor_work_is_only_rounded_conv():
    """``classify_phase`` files an f64 kernel (``dgemm``, ``f64``,
    ``double``) by the rounded layer of the window's model
    (``models.zoo.ROUNDED_F64``), since a name cannot tell a conv's f64
    GEMM from a dense layer's: under conv only where that layer is
    a rounded conv or ResNet-18's GroupNorm, rounded with its convs.  Any
    f64 site in the package outside the table's layers would be filed
    with no sign: this fails first."""
    from dopt_torch.models.zoo import ROUNDED_F64

    pkg = Path(TP.__file__).resolve().parent.parent
    owners = {}
    for path in sorted(pkg.rglob("*.py")):
        for line, owner in _f64_sites(ast.parse(path.read_text())):
            owners.setdefault((path.relative_to(pkg).as_posix(), owner),
                              []).append(line)
    assert set(owners) == {("models/zoo.py", layer)
                           for layers, _ in ROUNDED_F64.values()
                           for layer in layers}, owners
    assert {layer for layers, phase in ROUNDED_F64.values()
            if phase == "conv" for layer in layers} == {
        "_RoundedConv", "_RoundedResNetConv", "_RoundedGroupNorm"}


F64_KERNELS = [n for n, _ in CARD_KERNELS if TP._F64_KERNELS.search(n.lower())
               and not TP._CONV_KERNELS.search(n.lower())]


@pytest.mark.parametrize("model,phase", [
    ("model1", "conv"), ("model3", "conv"), ("mlp", "other"),
    ("resnet18", "conv"), (None, "conv")])
def test_f64_kernels_file_by_the_models_rounded_layer(model, phase):
    """The MLP's f64 kernels (``_RoundedLinear``'s) are dense-layer work
    and file under other, the CNNs' (``_RoundedConv``'s) under conv, in
    ``classify_phase`` and in ``profiler_op_stats``; cuDNN's kernels
    stay conv whatever the model."""
    assert len(F64_KERNELS) >= 4
    got = TP.f64_phase_of(model)
    assert got == phase
    for name in F64_KERNELS:
        assert TP.classify_phase("kernel", name, got) == phase
    cudnn = CARD_KERNELS[6][0]
    assert TP.classify_phase("kernel", cudnn, got) == "conv"
    rows = [(F64_KERNELS[0], 0, 40), (cudnn, 50, 60)]
    st = TP.profiler_op_stats(_fake_profile(rows), got)
    want = {"conv": 10.0, "other": 0.0}
    want[phase] += 40.0
    ph = st["device_phases"]
    assert (ph["conv_us"], ph["other_us"]) == (want["conv"], want["other"])
    assert {c["op_type"]: c["phase"] for c in st["device_categories"]} == {
        F64_KERNELS[0]: phase, cudnn: "conv"}


def test_phase_totals_equals_dopts():
    rng = np.random.default_rng(0)
    rows = [(*r, float(rng.uniform(1, 100))) for r, _ in DOPT_ROWS]
    assert TP.phase_totals(rows) == JP.phase_totals(rows)
    assert TP.PHASES == JP.PHASES
    got = TP.phase_totals([("convolution", "conv", 60.0),
                           ("all-gather", "ag", 20.0),
                           ("fusion", "x/dopt_update/sub", 20.0)])
    assert got["conv_fraction"] == pytest.approx(0.6)
    assert got["other_us"] == 0.0
    assert TP.phase_totals([])["conv_fraction"] == 0.0


class _StubProfile:
    """torch.profiler.profile with no profiler behind it."""

    def __init__(self, *a, **k):
        pass

    def start(self):
        pass

    def stop(self):
        pass


def test_device_stats_degrade_returns_warning(monkeypatch):
    """dopt's degrade contract (tests/test_obs.py), the profiler stubbed:
    a failed reduction, then a profiler that cannot start."""
    monkeypatch.setattr(torch.profiler, "profile", _StubProfile)

    def boom(*_):
        raise RuntimeError("no reduction here")

    monkeypatch.setattr(TP, "profiler_op_stats", boom)
    mem = MemorySink()
    ran = []
    stats = TP.device_stats_of(lambda: ran.append(1),
                               telemetry=Telemetry([mem]))
    assert ran == [1]
    assert "no reduction here" in stats["warning"]
    assert math.isnan(stats["device_self_time_us"])
    assert math.isnan(stats["host_self_time_us"])
    assert stats["device_phases"] == {} and stats["top_device_ops"] == []
    warns = [e for e in mem.events if e["kind"] == "warning"]
    assert warns and warns[0]["source"] == "device_stats_of"
    assert math.isnan(TP.device_time_of(lambda: None))

    class DeadStart(_StubProfile):
        def start(self):
            raise RuntimeError("profiler busy")

    monkeypatch.setattr(torch.profiler, "profile", DeadStart)
    stats = TP.device_stats_of(lambda: ran.append(2))
    assert "profiler busy" in stats["warning"] and ran == [1, 2]
    with pytest.raises(ZeroDivisionError):
        TP.device_stats_of(lambda: 1 / 0)

    class DeadStop(_StubProfile):
        def stop(self):
            raise RuntimeError("stop failed")

    monkeypatch.setattr(torch.profiler, "profile", DeadStop)
    assert "stop failed" in TP.device_stats_of(lambda: None)["warning"]


def _fake_profile(rows):
    """A stopped profile's two views over ``(name, start_us, end_us[,
    stream])`` CUDA rows (stream 7 when not given): ``events()`` one by
    one, ``key_averages()`` by name."""
    from types import SimpleNamespace as NS

    cuda = torch.autograd.DeviceType.CUDA
    rows = [(*r, 7)[:4] for r in rows]
    evs = [NS(device_type=cuda, name=n, time_range=NS(start=a, end=b),
              device_resource_id=s, thread=0) for n, a, b, s in rows]
    avg = {}
    for n, a, b, _ in rows:
        e = avg.setdefault(n, NS(device_type=cuda, key=n, count=0,
                                 self_device_time_total=0.0))
        e.count += 1
        e.self_device_time_total += b - a
    return NS(events=lambda: evs, key_averages=lambda: list(avg.values()))


def test_profiler_op_stats_drops_guards_and_counts_kernels():
    guard = "void at::native::vectorized_elementwise_kernel<4, at::native::" \
        "FillFunctor<short>, std::array<char*, 1ul> >"
    sgd = CARD_KERNELS[0][0]
    mix = CARD_KERNELS[1][0]
    conv = CARD_KERNELS[6][0]
    rows = ([(guard, t, t + 1) for t in range(0, 30, 2)]
            + [(conv, 100, 160), (sgd, 150, 170), (sgd, 170, 180),
               (mix, 200, 205)]
            + [(guard, t, t + 1) for t in range(300, 340, 2)])
    st = TP.profiler_op_stats(_fake_profile(rows))
    assert st["guard_records"] == [15, 20]
    assert st["device_self_time_us"] == 95.0
    assert st["device_busy_us"] == 85.0        # conv and sgd overlap 10 µs
    by = {c["op_type"]: c for c in st["device_categories"]}
    assert set(by) == {sgd, mix, conv}
    assert (by[sgd]["occurrences"], by[sgd]["phase"]) == (2, "update")
    assert (by[mix]["phase"], by[conv]["phase"]) == ("comm", "conv")
    ph = st["device_phases"]
    assert (ph["conv_us"], ph["update_us"], ph["comm_us"]) == (60.0, 30.0, 5.0)
    assert st["top_device_ops"][0]["operation"] == conv
    # On the busy basis each phase is its own union; the 10 µs overlap
    # is the later kernel's (sgd's), on one stream.
    pb = st["device_phases_busy"]
    assert (pb["conv_us"], pb["update_us"], pb["comm_us"]) == (60.0, 30.0, 5.0)
    assert pb["conv_fraction"] == round(60 / 85, 4)
    ov = st["device_overlap"]
    assert (ov["overlap_us"], ov["same_stream_us"], ov["streams"],
            ov["duplicate_records"]) == (10.0, 10.0, 1, 0)
    assert ov["by_phase_us"] == {"conv": 0.0, "comm": 0.0, "update": 10.0,
                                 "other": 0.0}
    assert ov["top_names"] == [[sgd, 10.0]]


def test_profiler_op_stats_overlap_across_streams_and_duplicates():
    """Summed − busy splits into the overlap within a stream and across
    streams, by the later record's phase; a record repeated in name,
    stream and interval is counted as a duplicate."""
    sgd, mix, conv = (CARD_KERNELS[i][0] for i in (0, 1, 6))
    rows = [(conv, 0, 100, 1), (conv, 0, 100, 1),     # a duplicate
            (mix, 50, 70, 2),                         # across streams
            (sgd, 90, 120, 1), (conv, 200, 210, 1)]
    st = TP.profiler_op_stats(_fake_profile(rows))
    assert st["device_self_time_us"] == 260.0
    assert st["device_busy_us"] == 130.0
    ov = st["device_overlap"]
    assert ov["overlap_us"] == 130.0 == (st["device_self_time_us"]
                                         - st["device_busy_us"])
    assert (ov["same_stream_us"], ov["streams"],
            ov["duplicate_records"]) == (110.0, 2, 1)
    assert ov["by_phase_us"] == {"conv": 100.0, "comm": 20.0,
                                 "update": 10.0, "other": 0.0}
    pb = st["device_phases_busy"]
    assert (pb["conv_us"], pb["comm_us"], pb["update_us"]) == (
        110.0, 20.0, 30.0)
    assert pb["conv_fraction"] + pb["comm_fraction"] + pb[
        "update_fraction"] > 1      # the phases overlap one another


def test_device_stats_of_cpu_run_has_dopts_keys():
    a = torch.randn(32, 32)
    stats = TP.device_stats_of(lambda: [a @ a for _ in range(4)])
    assert "warning" not in stats
    assert {"device_self_time_us", "host_self_time_us", "device_categories",
            "device_phases", "top_device_ops"} <= stats.keys()
    # No CUDA device here: no device rows, the host ops' time.
    assert stats["device_self_time_us"] == 0.0
    assert stats["host_self_time_us"] > 0.0
    assert set(stats["device_phases"]) == {
        f"{p}_{s}" for p in JP.PHASES for s in ("us", "fraction")}


def test_phase_timers_measure_counts_times_and_spans():
    timers = TP.PhaseTimers(tracer=SpanTracer())
    out = timers.measure("mm", torch.mm, torch.ones(4, 4), torch.ones(4, 4))
    timers.measure("mm", lambda: {"x": [torch.zeros(2)]})
    assert torch.equal(out, torch.full((4, 4), 4.0))
    s = timers.summary()["mm"]
    assert s["count"] == 2 and s["total_s"] >= 0.0
    assert [sp["name"] for sp in timers.tracer.spans] == ["mm", "mm"]
    assert TP.block_until_ready(out) is out


def test_trace_writes_chrome_json(tmp_path):
    with TP.trace(tmp_path / "tr"):
        torch.ones(8) @ torch.ones(8)
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert events["traceEvents"]


def test_run_cli_trace_goes_through_profiling_trace(tmp_path, monkeypatch):
    from dopt_torch.run import main

    opened = []
    real = TP.trace

    def spy(log_dir):
        opened.append(log_dir)
        return real(log_dir)

    monkeypatch.setattr(TP, "trace", spy)
    assert main(["--preset", "baseline1", "--rounds", "1", "--device", "cpu",
                 "--set", "data.num_users=2",
                 "--set", "data.synthetic_train_size=40",
                 "--set", "data.synthetic_test_size=8",
                 "--set", "gossip.local_ep=1", "--set", "gossip.local_bs=20",
                 "--trace", str(tmp_path / "t")]) == 0
    assert opened == [str(tmp_path / "t")]
    assert (tmp_path / "t" / "trace.json").exists()


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 989e12),
    ("NVIDIA H100 PCIe", None),
    ("NVIDIA H100 NVL", None),
    ("NVIDIA H100", None),
    ("NVIDIA A100-SXM4-80GB", None)])
def test_device_peak_flops_exact_names(name, peak, monkeypatch):
    assert TP.device_peak_flops() == ("cpu", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: name)
    assert TP.device_peak_flops() == (name, peak)


# (model, input shape, faithful); num_classes 10 as dopt's build_model.
ZOO = [("model1", (28, 28, 1), True), ("model3", (32, 32, 3), True),
       ("mlp", (28, 28, 1), False), ("logistic", (123,), False),
       ("resnet18", (32, 32, 3), False)]


def _dopt_fwd_flops(name, shape, faithful):
    from dopt.models import build_model

    model = build_model(name, faithful=faithful)
    params = model.init(jax.random.key(0), jnp.zeros((1, *shape)))["params"]
    return JP.fwd_flops_per_sample(
        lambda p, x: model.apply({"params": p}, x), params, shape)


@pytest.mark.parametrize("name,shape,faithful", ZOO)
def test_fwd_flops_within_one_percent_of_dopts(name, shape, faithful):
    from dopt_torch.models.zoo import init_worker_params

    gen = torch.Generator().manual_seed(0)
    params = {k: v[None] for k, v in init_worker_params(
        name, input_shape=shape, generator=gen).items()}

    def fn(p, x):
        return stacked_forward(name, p, x[None], faithful=faithful)

    got = TP.fwd_flops_per_sample(fn, params, shape)
    want = _dopt_fwd_flops(name, shape, faithful)
    assert abs(got - want) <= 0.01 * want, (got, want)
    assert TP.train_flops_per_sample(fn, params, shape) == 3.0 * got
    if name == "model1":
        analytic = 2 * 12_273_152
        assert 0.6 * analytic < got < 1.6 * analytic, got


def test_fwd_flops_nan_when_nothing_counts():
    assert math.isnan(TP.fwd_flops_per_sample(
        lambda p, x: x + p["b"], {"b": torch.ones(4)}, (4,)))
