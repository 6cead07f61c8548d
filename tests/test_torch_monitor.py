"""The port's health monitor, rules, SLO latency, fleet aggregation,
scrape server and stream checker against dopt's (``dopt.obs``).

Every module here is stdlib host code in both packages, so the same
input must give the same output exactly: the same event streams
(synthetic ones of every kind, and both packages' own chaos runs, which
fire rules) through ``HealthMonitor`` give equal ``canonical_alerts()``,
``report()`` and ``state()`` JSON; the same observations give equal
histograms, quantiles and Prometheus text; the same fleet dirs give
equal merges, divergence reports, ``/metrics`` text, ``/healthz`` bodies
and ``check --state-dir`` reports.  Wall-clock fields (a lag measured
against "now", the tool's own name) are left out of the comparison.
"""

from __future__ import annotations

import json
import math
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import dopt.obs as J
import dopt_torch.obs as T
from dopt.obs import aggregate as jagg
from dopt.obs import check as jcheck
from dopt.obs import latency as jlat
from dopt.obs import rules as jrules
from dopt.obs import serve as jserve
from dopt_torch.obs import aggregate as tagg
from dopt_torch.obs import check as tcheck
from dopt_torch.obs import latency as tlat
from dopt_torch.obs import rules as trules
from dopt_torch.obs import serve as tserve

# Fields measured against the wall clock of the call, or naming the
# package: equal in meaning, never in value.
WALL = ("lag_seconds", "tool")

SENSITIVE = [
    {"rule": "loss_nonfinite"},
    {"rule": "loss_divergence", "factor": 1.5, "window": 3,
     "min_delta": 0.01},
    {"rule": "consensus_stall", "patience": 2, "tol": 0.05,
     "use_checkpoints": True},
    {"rule": "grad_explosion", "factor": 2.0, "window": 3},
    {"rule": "retrace_storm", "max_rounds": 1, "window": 4},
    {"rule": "hbm_growth", "patience": 2, "tol": 0.01, "min_bytes": 1},
    {"rule": "quarantine_storm", "frac": 0.3},
    {"rule": "drop_rate", "max_rate": 0.2, "window": 3, "min_rounds": 2},
    {"rule": "staleness_saturation", "frac": 0.6},
    {"rule": "host_gap", "max_pct": 10.0},
    {"rule": "checkpoint_cadence", "every": 2},
]


def _strip(obj):
    """``obj`` without the wall-clock fields, recursively."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in WALL}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _json(obj):
    """JSON round trip: NaN and int/float keys compare as the file
    holds them."""
    return json.loads(json.dumps(obj))


def fuzz_stream(seed: int, rounds: int = 40) -> list[dict]:
    """A seeded stream of every kind the rules read: segment headers
    (a resume and a fresh segment), round events with spikes and NaNs,
    the gauges, fault rows, checkpoints, control cadence changes,
    latency, compile and resource samples."""
    rng = np.random.default_rng(seed)
    ev = J.make_event
    engine = ("gossip", "federated")[seed % 2]
    out = [ev("run", engine=engine, name="fuzz", round=0, workers=8,
              checkpoint_every=int(rng.integers(1, 5)))]
    loss = 1.0
    live = 8 << 20
    for t in range(rounds):
        if t == rounds // 2:
            # A resumed segment, then later a fresh one.
            out.append(ev("run", engine=engine, name="fuzz", round=t,
                          workers=8))
        if t == 3 * rounds // 4:
            out.append(ev("control", round=t, cmd="config",
                          key="checkpoint_every", value=1, id=f"c{t}"))
        for _ in range(int(rng.poisson(1.5))):
            out.append(ev("fault", round=t, worker=int(rng.integers(8)),
                          fault=str(rng.choice(["crash", "straggle",
                                                "msg_drop", "churn",
                                                "corrupt", "partition"])),
                          action="x"))
        for name, val in (
                ("participating_lanes", float(rng.integers(4, 9))),
                ("quarantine_active", float(rng.integers(0, 5))),
                ("consensus_distance", float(rng.uniform(0.1, 2.0) * (1 + t / 10))),
                ("grad_norm", float(rng.uniform(1, 2) * (50 if rng.random() < 0.1 else 1))),
                ("update_norm", float(rng.uniform(1, 2))),
                ("stale_pending", float(rng.integers(0, 9))),
                ("host_gap_pct", float(rng.uniform(0, 30)))):
            if rng.random() < 0.8:
                out.append(ev("gauge", round=t, name=name, value=val,
                              engine=engine))
        r = rng.random()
        loss = (float("nan") if r < 0.05 else
                loss * (8.0 if r < 0.12 else float(rng.uniform(0.9, 1.02))))
        metrics = {"avg_train_loss": loss,
                   "avg_test_acc": float(rng.uniform(0, 1))}
        if rng.random() < 0.3:
            metrics = {"loss": loss}
        out.append(ev("round", round=t, engine=engine, metrics=metrics))
        if rng.random() < 0.3:
            out.append(ev("checkpoint", round=t,
                          consensus_distance=float(rng.uniform(0, 2))))
        if rng.random() < 0.4:
            out.append(ev("latency", round=t,
                          name=str(rng.choice(list(J.SLO_LATENCIES))),
                          seconds=float(rng.exponential(0.2))))
        if rng.random() < 0.3:
            out.append(ev("compile", round=t, fn="round_fn", count=1,
                          total=t + 1, seconds=0.5))
        live += int(rng.integers(0, 3 << 20))
        out.append(ev("resource", round=t, peak_bytes=live + (1 << 20),
                      live_bytes=live, source="device"))
    return _json(out)


def _monitors(rules_of, stream, *, chunks=1, **kw):
    """dopt's and the port's monitor fed ``stream``, in ``chunks``
    pieces with a state round trip between pieces (a restarted monitor
    resumes from ``state()``); each one's ``alerts`` holds every piece's
    alerts."""
    out = []
    for pkg in (J, T):
        mon, fired = None, []
        for i, part in enumerate(np.array_split(np.arange(len(stream)),
                                                chunks)):
            mon = pkg.HealthMonitor(
                rules_of(pkg), state=None if mon is None
                else _json(mon.state()), **kw)
            fired += mon.feed([stream[i] for i in part])
        mon.alerts = fired
        out.append(mon)
    return out


def _rules(specs):
    def make(pkg):
        return (pkg.default_rules() if specs is None
                else pkg.build_rules(specs))
    return make


@pytest.mark.parametrize("chunks", [1, 3])
@pytest.mark.parametrize("specs", [None, SENSITIVE],
                         ids=["default", "sensitive"])
@pytest.mark.parametrize("seed", range(4))
def test_monitor_fuzz_streams_equal(seed, specs, chunks):
    stream = fuzz_stream(seed)
    jm, tm = _monitors(_rules(specs), stream, chunks=chunks, workers=8)
    assert tm.canonical_alerts() == jm.canonical_alerts()
    assert _json(tm.report().to_dict()) == _json(jm.report().to_dict())
    assert _json(tm.state()) == _json(jm.state())
    if specs is not None:
        # The sensitized set fires: the comparison is not of two empty
        # lists.
        assert len({a["rule"] for a in jm.alerts}) >= 5


def test_rule_registry_and_defaults_equal():
    assert list(trules.RULES) == list(jrules.RULES)
    for name in jrules.RULES:
        j, t = jrules.RULES[name](), trules.RULES[name]()
        assert (t.name, t.severity) == (j.name, j.severity)
        assert _json(t.s) == _json(j.s)
    assert [r.name for r in trules.default_rules(drop_rate=None)] == \
        [r.name for r in jrules.default_rules(drop_rate=None)]
    for m in ({"avg_train_loss": 1.5}, {"loss": 2.0}, {"acc": 1.0}, {}):
        assert trules.loss_of(m) == jrules.loss_of(m)
    with pytest.raises(ValueError) as je:
        jrules.build_rules([{"rule": "nope"}])
    with pytest.raises(ValueError) as te:
        trules.build_rules([{"rule": "nope"}])
    assert str(te.value) == str(je.value)


def test_monitor_attach_forwards_alerts_equal():
    """In-process mode (the serve daemon's): the monitor rides a
    Telemetry fan-out and forwards its alerts to the other sinks, in
    stream order, with the measured alert latency event beside each."""
    stream = [e for e in fuzz_stream(7, rounds=24)
              if e["kind"] in ("run", "round", "gauge", "fault")]
    out = []
    for pkg in (J, T):
        mem = pkg.MemorySink()
        tele = pkg.Telemetry([mem])
        mon = pkg.HealthMonitor(pkg.build_rules(SENSITIVE), workers=8)
        mon.attach(tele)
        for ev in stream:
            tele.emit(ev["kind"], **{k: v for k, v in ev.items()
                                     if k not in ("v", "kind", "ts")})
        kinds = [e["kind"] for e in mem.events]
        out.append((mon.canonical_alerts(), kinds,
                    sorted(mon.latency), mon.report().verdict))
    assert out[1] == out[0]
    assert out[0][0] and "alert_latency" in out[0][2]


def test_jsonl_tail_equal(tmp_path):
    path = tmp_path / "m.jsonl"
    stream = fuzz_stream(3, rounds=6)
    text = "".join(json.dumps(e) + "\n" for e in stream)
    cut = len(text) // 2
    path.write_text(text[:cut])
    jt, tt = J.JsonlTail(path), T.JsonlTail(path)
    assert tt.poll() == jt.poll()
    assert tt.offset == jt.offset
    path.write_text(text)
    assert tt.poll() == jt.poll()
    assert tt.offset == jt.offset == len(text.encode())


# ------------------------------------------------------------- latency

@pytest.mark.parametrize("seed", range(3))
def test_latency_histogram_equal(seed):
    rng = np.random.default_rng(seed)
    obs = list(rng.exponential(0.5, size=int(rng.integers(1, 200))))
    obs += [0.0, 1e-6, 0.001, 120.0, 500.0]
    hj, ht = jlat.LatencyHistogram(), tlat.LatencyHistogram()
    for x in obs:
        hj.observe(float(x))
        ht.observe(float(x))
    assert _json(ht.state()) == _json(hj.state())
    assert _json(ht.summary()) == _json(hj.summary())
    for q in (0.0, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert ht.quantile(q) == hj.quantile(q)
    assert ht.exposition("dopt_latency_seconds", 'name="x"') == \
        hj.exposition("dopt_latency_seconds", 'name="x"')
    mj = jlat.LatencyHistogram.from_state(hj.state()).merge(hj)
    mt = tlat.LatencyHistogram.from_state(ht.state()).merge(ht)
    assert _json(mt.state()) == _json(mj.state())
    assert tlat.SLO_LATENCIES == jlat.SLO_LATENCIES
    assert tlat.DEFAULT_BUCKETS == jlat.DEFAULT_BUCKETS


def test_summarize_latency_events_equal():
    evs = [e for s in range(3) for e in fuzz_stream(s, rounds=20)]
    evs += [{"kind": "latency", "name": "x", "seconds": "bad"},
            {"kind": "latency", "seconds": 1.0}, {"kind": "round"}]
    assert _json(tlat.summarize_latency_events(evs)) == \
        _json(jlat.summarize_latency_events(evs))


@pytest.mark.parametrize("seed", range(2))
def test_prometheus_render_equal(seed):
    stream = fuzz_stream(seed, rounds=20)
    jm = J.HealthMonitor(J.build_rules(SENSITIVE), workers=8)
    jm.feed(stream)
    stream = stream + jm.alerts
    jp, tp = J.PrometheusSink(), T.PrometheusSink()
    for ev in stream:
        jp.emit(ev)
        tp.emit(ev)
    assert tp.render() == jp.render()


# ------------------------------------------------------- fleet aggregate

def _bundle(t, *, lanes=8.0, latency=None):
    evs = [J.make_event("gauge", round=t, name="participating_lanes",
                        value=lanes, engine="gossip"),
           J.make_event("round", round=t, engine="gossip",
                        metrics={"avg_train_loss": 1.0 - 0.01 * t})]
    if latency is not None:
        evs.append(J.make_event("latency", round=t, name="boundary_tick",
                                seconds=latency))
    return evs


def _write(path: Path, events, torn: str = "") -> None:
    path.write_text("".join(json.dumps(e) + "\n" for e in events) + torn)


def _fleet(root: Path, case: str) -> Path:
    """One fleet dir per case: consistent, diverged, skewed (one
    process a round behind), torn (a partial last line), three
    processes with an alert."""
    d = root / case
    d.mkdir()
    hdr = J.make_event("run", engine="gossip", name="t", round=0,
                       workers=8)
    procs = 3 if case == "three" else 2
    for p in range(procs):
        rounds = 4 if case == "skewed" and p == 1 else 5
        evs = [hdr] + [e for t in range(rounds)
                       for e in _bundle(t, latency=0.01 * (p + 1))]
        if case == "diverged" and p == 1:
            evs[5]["value"] = 7.0
        if case == "three" and p == 2:
            evs.append(J.make_event("alert", round=4, rule="drop_rate",
                                    severity="warn", message="m"))
        torn = '{"v": 1, "kind": "ro' if case == "torn" and p == 1 else ""
        _write(d / ("metrics.jsonl" if p == 0 else f"metrics-p{p}.jsonl"),
               evs, torn)
    return d


CASES = ("consistent", "diverged", "skewed", "torn", "three")


@pytest.mark.parametrize("case", CASES)
def test_fleet_aggregator_equal(tmp_path, case):
    d = _fleet(tmp_path, case)
    out = []
    for agg in (jagg, tagg):
        a = agg.FleetAggregator(d)
        a.poll()
        a.flush_trailing()
        out.append(_json({"merged": a.merged, "div": a.divergence,
                          "alerts": a.alerts(),
                          "stats": _strip(a.stats(now=2e9)),
                          "procs": a.processes,
                          "paths": {k: str(v) for k, v in
                                    agg.fleet_metric_paths(d).items()}}))
    assert out[1] == out[0]
    if case == "diverged":
        assert out[0]["div"] is not None
        assert tagg.format_fleet_divergence(out[1]["div"]) == \
            jagg.format_fleet_divergence(out[0]["div"])


@pytest.mark.parametrize("case", CASES)
def test_fleet_cli_and_check_state_dir_equal(tmp_path, case, capsys):
    d = _fleet(tmp_path, case)
    outs = []
    for agg, chk in ((jagg, jcheck), (tagg, tcheck)):
        rc = agg.main(["--state-dir", str(d), "--json"])
        rep = json.loads(capsys.readouterr().out)
        rc2 = chk.main(["--state-dir", str(d), "--json", "--summary"])
        rep2 = json.loads(capsys.readouterr().out)
        outs.append((rc, _strip(rep), rc2, _strip(rep2),
                     chk.fleet_stream_paths(str(tmp_path))))
    assert outs[1] == outs[0]


@pytest.mark.parametrize("case", ["consistent", "diverged", "three"])
def test_fleet_metrics_server_equal(tmp_path, case):
    d = _fleet(tmp_path, case)
    out = []
    for agg in (jagg, tagg):
        srv = agg.FleetMetricsServer(d, num_processes=None).start()
        try:
            url = f"http://127.0.0.1:{srv.port}"
            with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
                # The lag gauges are wall-clock readings.
                metrics = [line for line in r.read().decode().splitlines()
                           if not line.startswith("dopt_fleet_lag_seconds{")]
            try:
                with urllib.request.urlopen(url + "/healthz",
                                            timeout=10) as r:
                    code, body = r.status, r.read()
                    retry = r.headers.get("Retry-After")
            except urllib.error.HTTPError as e:
                code, body = e.code, e.read()
                retry = e.headers.get("Retry-After")
        finally:
            srv.shutdown()
        health = _strip(json.loads(body))
        health.pop("state_dir")
        out.append((metrics, code, retry, health))
    assert out[1] == out[0]


def test_obs_serve_metrics_server_equal(tmp_path):
    path = tmp_path / "m.jsonl"
    stream = fuzz_stream(5, rounds=16)
    _write(path, stream)
    out = []
    for srv_mod in (jserve, tserve):
        rules = (jrules if srv_mod is jserve else trules).build_rules(
            SENSITIVE)
        srv = srv_mod.MetricsServer(path, rules=rules, workers=8).start()
        try:
            metrics = srv.render_metrics()
            code, body = srv.render_health()
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}/metrics",
                    timeout=10) as r:
                assert r.read().decode() == metrics
        finally:
            srv.shutdown()
        out.append((metrics, code, _strip(json.loads(body))))
    assert out[1] == out[0]
    assert out[0][1] == 503   # a critical rule fired


# ----------------------------------------------------------- chaos runs

def _chaos_cfg(mod):
    return mod.ExperimentConfig(
        name="chaos", seed=3,
        data=mod.DataConfig(dataset="synthetic", num_users=4, iid=True,
                            synthetic_train_size=128,
                            synthetic_test_size=32),
        model=mod.ModelConfig(model="mlp", input_shape=(8, 8, 1),
                              faithful=False),
        optim=mod.OptimizerConfig(lr=0.05, momentum=0.5),
        gossip=mod.GossipConfig(algorithm="dsgd", topology="circle",
                                mode="metropolis", rounds=6, local_ep=1,
                                local_bs=16),
        faults=mod.FaultConfig(crash=0.5, churn=0.3, churn_span=2,
                               straggle=0.3, straggle_frac=0.5))


@pytest.fixture(scope="module")
def chaos_streams():
    """dopt's and the port's chaos run, from dopt's init, each streaming
    into memory: 6 rounds of crash, churn and stragglers on 4 workers."""
    import dopt.config as JC
    import dopt_torch.config as TC
    from dopt.engine import GossipTrainer as JG
    from dopt_torch.engine import GossipTrainer as TG

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        jt = JG(_chaos_cfg(JC).replace(mesh_devices=1))
        init = jax.device_get(jax.tree.map(lambda x: x[0], jt.params))
        tt = TG(_chaos_cfg(TC), device="cpu", init_params=init)
        streams = []
        for pkg, tr in ((J, jt), (T, tt)):
            mem = pkg.MemorySink()
            pkg.attach(tr, pkg.Telemetry([mem]), checkpoint_every=2)
            tr.run(rounds=6)
            streams.append(_json(mem.events))
    finally:
        torch.set_num_threads(n)
    return streams


@pytest.mark.parametrize("source", ["dopt", "port"])
def test_monitor_on_chaos_runs_equal(chaos_streams, source):
    """Each package's own chaos stream through both monitors: equal
    alerts, report and state; the drop-rate and checkpoint-cadence rules
    fire."""
    stream = chaos_streams[0 if source == "dopt" else 1]
    jm, tm = _monitors(_rules(SENSITIVE), stream, chunks=2, workers=4)
    assert tm.canonical_alerts() == jm.canonical_alerts()
    assert _json(tm.report().to_dict()) == _json(jm.report().to_dict())
    assert _json(tm.state()) == _json(jm.state())
    fired = {a["rule"] for a in jm.alerts}
    assert {"drop_rate", "checkpoint_cadence"} <= fired


def test_chaos_streams_give_equal_ledger_alerts(chaos_streams):
    """The rules that read only the ledger and the headers fire alike on
    dopt's stream and on the port's (their fault rows are equal)."""
    det = [{"rule": "drop_rate", "max_rate": 0.2, "window": 3,
            "min_rounds": 2}, {"rule": "checkpoint_cadence", "every": 2}]
    alerts = []
    for stream in chaos_streams:
        mon = T.HealthMonitor(T.build_rules(det), workers=4)
        mon.feed(stream)
        alerts.append(mon.canonical_alerts())
    assert alerts[1] == alerts[0] and alerts[0]
    faults = [[e for e in s if e["kind"] == "fault"] for s in chaos_streams]
    assert [_strip({**e, "ts": 0}) for e in faults[1]] == \
        [_strip({**e, "ts": 0}) for e in faults[0]]
    assert math.isfinite(chaos_streams[1][-1].get("value", 0.0))
