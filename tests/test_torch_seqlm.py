"""dopt's sequence-parallel LM on the port, against dopt on the CPU.

* Host data: ``markov_token_stream`` and the trainer's batch plan equal
  dopt's bit for bit (three seeds); ``SeqLMConfig`` and the ``seqlm``
  preset are dopt's.
* The model: ``TransformerLM`` from a converted dopt init gives dopt's
  logits (dense attention) within 1e-5 relative; in bf16 within dopt's
  own bf16-vs-f32 distance on the same input.  The conversion round
  trip is bit-exact and ``count_params`` is dopt's.
* Attention: ``dense_attention``, ``_block_attn`` with ``_combine``,
  ``_block_attn_chunked`` and the ring at one rank against dopt's
  functions, causal and not, forward and gradients within 1e-5 of the
  largest element.
* The trainer: ``SeqLMTrainer`` (seq_len 32, batch 2, dim 32, heads 4,
  vocab 16, 3 steps) from dopt's init against dopt's
  ``SeqLMTrainer(mesh_devices=1)``: loss rows within 1e-4, params
  within 1e-4 max-relative (dopt's own ring-vs-dense distance over the
  same steps is ~1e-6, below that bound).
* The port's promises: validation messages in dopt's words, save and
  restore bit for bit, a dopt checkpoint restored, kill-and-resume ≡
  continuous, the CLI's refusals in dopt's words, and the port's
  3-lane Model1 step equal to lanes 0-2 of its 6-lane step bit for bit;
  the card's f32 conv (``_RoundedConv``) is the f64 conv rounded once,
  and the engines' Model1 and Model3 steps through it are the library
  conv's within 1e-5 relative L2.

Across 2 and 4 ranks the seqlm configs run in tests/test_torch_multigpu.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dopt.config as J
import dopt_torch.config as T
from dopt.engine import SeqLMTrainer as JaxSeqLMTrainer
from dopt.engine.seqlm import markov_token_stream as jax_stream
from dopt.parallel import sequence as JS
from dopt.presets import get_preset as jax_preset
from dopt_torch.convert import params_from_jax, params_to_jax
from dopt_torch.engine import SeqLMTrainer
from dopt_torch.engine.seqlm import markov_token_stream
from dopt_torch.models.zoo import TransformerLM, count_params
from dopt_torch.parallel import sequence as TS
from dopt_torch.presets import get_preset

F32_TOL = 1e-5
STEP_TOL = 1e-4
TINY = dict(seq_len=32, batch=2, dim=32, heads=4, vocab=16, steps=3,
            log_every=1)


def _cfg(get, **kw):
    cfg = get("seqlm")
    fields = {**TINY, **kw}
    return cfg.replace(seqlm=dataclasses.replace(cfg.seqlm, **fields))


def _jax_params(tr) -> dict:
    return jax.device_get(tr.params)


def _rel(want: np.ndarray, got: np.ndarray) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("seed", [0, 7, 2022])
def test_markov_stream_and_batch_plan_bit_identical(seed):
    for vocab, n in ((16, 4096), (64, 4096)):
        np.testing.assert_array_equal(markov_token_stream(vocab, n, seed=seed),
                                      jax_stream(vocab, n, seed=seed))
    jt = JaxSeqLMTrainer(_cfg(jax_preset, dim=8).replace(seed=seed),
                         mesh_devices=1)
    tr = SeqLMTrainer(_cfg(get_preset, dim=8).replace(seed=seed),
                      device="cpu")
    np.testing.assert_array_equal(tr._stream, jt._stream)
    for _ in range(4):
        np.testing.assert_array_equal(tr._batch().numpy(),
                                      np.asarray(jt._batch()))


def test_seqlm_config_and_preset_are_dopts():
    jf = {f.name: f.default for f in dataclasses.fields(J.SeqLMConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(T.SeqLMConfig)}
    assert tf == jf
    t, j = get_preset("seqlm"), jax_preset("seqlm")
    assert dataclasses.asdict(t.seqlm) == dataclasses.asdict(j.seqlm)
    for sec in ("model", "optim"):
        a = dataclasses.asdict(getattr(t, sec))
        b = dataclasses.asdict(getattr(j, sec))
        assert a == {k: b[k] for k in a}, sec
    assert (t.name, t.seed, t.gossip, t.federated) == (j.name, j.seed, None,
                                                       None)


def _dopt_model(s, dtype=jnp.float32):
    from dopt.models import build_model

    return build_model("transformer", num_classes=s["vocab"],
                       dtype=dtype).clone(dim=s["dim"], depth=2,
                                          heads=s["heads"],
                                          max_len=s["seq_len"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transformer_forward_matches_dopt(dtype):
    """f32: dopt's logits within 1e-5 of the largest.  bf16: the port's
    distance to dopt's bf16 logits at most dopt's own bf16-vs-f32
    distance on the same input."""
    from dopt.models import count_params as jax_count

    s = dict(vocab=16, dim=32, heads=4, seq_len=32)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, s["vocab"], (2, s["seq_len"]))
    jm = _dopt_model(s)
    tree = jax.device_get(jm.init(jax.random.key(5), jnp.asarray(tokens))[
        "params"])
    port = params_from_jax(tree)
    for k, v in params_from_jax(params_to_jax(port)).items():
        np.testing.assert_array_equal(v, port[k], err_msg=k)
    assert count_params(port) == jax_count(tree) == count_params(tree)
    f32 = np.asarray(jm.apply({"params": tree}, jnp.asarray(tokens)),
                     np.float32)
    model = TransformerLM({k: torch.from_numpy(v) for k, v in port.items()},
                          heads=s["heads"], dtype=getattr(torch, dtype))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens)).float().numpy()
    if dtype == "float32":
        assert _rel(f32, got) <= F32_TOL
        return
    jb = np.asarray(_dopt_model(s, jnp.bfloat16).apply(
        {"params": tree}, jnp.asarray(tokens)), np.float32)
    assert np.abs(got - jb).max() <= np.abs(jb - f32).max()


def _qkv(seed=0, b=2, l=32, h=4, d=8):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, l, h, d)).astype(np.float32)
            for _ in range(3)]


def _attn_pair(name, causal):
    """(dopt's function, the port's) of (q, k, v) → output."""
    if name == "dense":
        return (lambda q, k, v: JS.dense_attention(q, k, v, causal=causal),
                lambda q, k, v: TS.dense_attention(q, k, v, causal=causal))
    if name == "ring":
        mesh = JS.make_seq_mesh(1)
        return (lambda q, k, v: JS.ring_attention(q, k, v, mesh,
                                                  causal=causal),
                lambda q, k, v: TS.ring_attention(q, k, v, causal=causal))
    l = 32
    pos = np.arange(l)
    if name == "combine":
        def blocks(mod, block, combine, q, k, v, lib):
            scale = 1.0 / np.sqrt(np.float32(q.shape[-1]))
            parts = []
            for j in range(2):
                mask = None
                if causal:
                    m = pos[:, None] >= pos[j * 16:(j + 1) * 16][None, :]
                    mask = lib(m[None, :, None, :])
                parts.append(block(q, k[:, j * 16:(j + 1) * 16],
                                   v[:, j * 16:(j + 1) * 16],
                                   scale=np.float32(scale), mask=mask))
            num, den, _ = combine(*parts[0], *parts[1])
            return num / den[..., None]

        return (lambda q, k, v: blocks(JS, JS._block_attn, JS._combine, q, k,
                                       v, jnp.asarray),
                lambda q, k, v: blocks(TS, TS._block_attn, TS._combine, q, k,
                                       v, torch.from_numpy))

    def chunked(fn, q, k, v, arange):
        scale = 1.0 / np.sqrt(np.float32(q.shape[-1]))
        num, den, _ = fn(q, k, v, scale=np.float32(scale),
                         q_pos=arange(l) if causal else None, k_pos0=0,
                         chunk=8)
        return num / den[..., None]

    return (lambda q, k, v: chunked(JS._block_attn_chunked, q, k, v,
                                    jnp.arange),
            lambda q, k, v: chunked(TS._block_attn_chunked, q, k, v,
                                    torch.arange))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name", ["dense", "combine", "chunked", "ring"])
def test_attention_matches_dopt(name, causal):
    """Forward and the gradients of Σ out² in q, k and v within 1e-5 of
    the largest element, against dopt's function."""
    jfn, tfn = _attn_pair(name, causal)
    q, k, v = _qkv()
    want, jvjp = jax.vjp(jax.jit(jfn), *(jnp.asarray(x) for x in (q, k, v)))
    jg = jvjp(2 * want)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = tfn(tq, tk, tv)
    (got * got).sum().backward()
    assert _rel(np.asarray(want), got.detach().numpy()) <= F32_TOL
    for a, b in zip(jg, (tq.grad, tk.grad, tv.grad)):
        assert _rel(np.asarray(a), b.numpy()) <= F32_TOL


@pytest.mark.parametrize("attn,kw", [("ring", {}), ("ring", {"kv_chunk": 8}),
                                     ("dense", {}), ("ulysses", {})],
                         ids=["ring", "ring-kv8", "dense", "ulysses"])
def test_trainer_matches_dopt(attn, kw):
    jt = JaxSeqLMTrainer(_cfg(jax_preset, attn=attn, **kw), mesh_devices=1)
    tr = SeqLMTrainer(_cfg(get_preset, attn=attn, **kw), device="cpu",
                      init_params=_jax_params(jt))
    assert tr.param_count == jt.param_count
    jt.run()
    tr.run()
    assert [r["step"] for r in tr.history] == [0, 1, 2]
    for a, b in zip(jt.history.rows, tr.history.rows, strict=True):
        assert a.keys() == b.keys() and a["step"] == b["step"]
        assert abs(a["loss"] - b["loss"]) <= STEP_TOL, (a, b)
    want = params_from_jax(_jax_params(jt))
    for k, v in tr.params.items():
        assert _rel(want[k], v.detach().numpy()) <= STEP_TOL, k


def test_one_step_within_the_single_step_standard():
    """One step from dopt's init: the loss and every updated parameter
    within 1e-5 (relative)."""
    jt = JaxSeqLMTrainer(_cfg(jax_preset, steps=1), mesh_devices=1)
    tr = SeqLMTrainer(_cfg(get_preset, steps=1), device="cpu",
                      init_params=_jax_params(jt))
    a, b = jt.run().rows[0]["loss"], tr.run().rows[0]["loss"]
    assert abs(a - b) <= F32_TOL * abs(a)
    want = params_from_jax(_jax_params(jt))
    for k, v in tr.params.items():
        assert _rel(want[k], v.detach().numpy()) <= F32_TOL, k


VALIDATION = [
    dict(attn="flash"),
    dict(attn="ulysses", kv_chunk=4),
    dict(kv_chunk=3),
    dict(dim=30),
    "optimizer",
    "no-seqlm",
]


@pytest.mark.parametrize("case", VALIDATION, ids=lambda c: str(c))
def test_validation_messages_are_dopts(case):
    """dopt's refusals at one rank, message for message (the rank-count
    ones run across ranks in tests/test_torch_multigpu.py)."""
    def make(get, mod):
        if case == "optimizer":
            cfg = _cfg(get)
            return cfg.replace(optim=dataclasses.replace(cfg.optim,
                                                         optimizer="adam"))
        if case == "no-seqlm":
            return mod.ExperimentConfig()
        return _cfg(get, **case)

    with pytest.raises(ValueError) as want:
        JaxSeqLMTrainer(make(jax_preset, J), mesh_devices=1)
    with pytest.raises(ValueError) as got:
        SeqLMTrainer(make(get_preset, T), device="cpu")
    assert str(got.value) == str(want.value)


def _state(tr) -> dict:
    return {**{f"p.{k}": v.detach().clone() for k, v in tr.params.items()},
            **{f"m.{k}": v.clone() for k, v in tr.momentum.items()}}


def test_save_restore_and_resume_bit_for_bit(tmp_path):
    """Killed after 2 of 5 steps and resumed ≡ the continuous run (params,
    momentum, the loss rows; the killed run adds its closing row at step
    1, dopt's always-log-the-last-step rule); a checkpoint restores into
    a used trainer; a foreign algorithm is refused in dopt's words."""
    cfg = _cfg(get_preset, steps=5, log_every=2)
    full = SeqLMTrainer(cfg, device="cpu")
    full.run()
    a = SeqLMTrainer(cfg, device="cpu")
    a.run(steps=2)
    a.save(tmp_path / "ck")
    b = SeqLMTrainer(cfg, device="cpu")
    b.run(steps=1)
    b.restore(tmp_path / "ck")
    assert b.round == 2
    b.run(steps=3)
    want, got = _state(full), _state(b)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    assert [r["step"] for r in b.history] == [0, 1, 2, 4]
    assert [r for r in b.history if r["step"] != 1] == full.history.rows
    from dopt_torch.utils.checkpoint import save_checkpoint

    save_checkpoint(tmp_path / "other", arrays={"params": {}},
                    meta={"round": 0, "algorithm": "dsgd"})
    with pytest.raises(ValueError, match="checkpoint is for 'dsgd', not "
                       "seqlm"):
        SeqLMTrainer(cfg, device="cpu").restore(tmp_path / "other")


def test_dopt_checkpoint_restores_into_the_port(tmp_path, monkeypatch):
    """dopt's npz checkpoint after 2 steps restores into the port, whose
    next step is within 1e-5 of dopt's."""
    from dopt.utils import checkpoint as jckpt

    monkeypatch.setattr(jckpt, "HAVE_ORBAX", False)
    jt = JaxSeqLMTrainer(_cfg(jax_preset), mesh_devices=1)
    jt.run(steps=2)
    jt.save(tmp_path / "ck")
    tr = SeqLMTrainer(_cfg(get_preset), device="cpu")
    tr.restore(tmp_path / "ck")
    assert tr.round == 2 and tr.history.rows == jt.history.rows
    want = params_from_jax(_jax_params(jt))
    for k, v in tr.params.items():
        np.testing.assert_array_equal(v.detach().numpy(), want[k])
    jt.run(steps=1)
    tr.run(steps=1)
    assert abs(jt.history.last()["loss"] - tr.history.last()["loss"]) <= (
        F32_TOL * abs(jt.history.last()["loss"]))


REFUSED_FLAGS = [["--faults", "crash=0.1"], ["--clients", "100"],
                 ["--diagnostics", "on"], ["--metrics-out", "m.jsonl"],
                 ["--trace-out", "t.json"],
                 ["--checkpoint", "ck", "--checkpoint-every", "1"]]


@pytest.mark.parametrize("flags", REFUSED_FLAGS, ids=lambda f: f[0])
def test_cli_refusals_are_dopts(flags, tmp_path, monkeypatch):
    from dopt.run import main as jax_main
    from dopt_torch.run import main

    monkeypatch.chdir(tmp_path)
    argv = ["--preset", "seqlm", "--rounds", "1", *flags]
    with pytest.raises(SystemExit) as want:
        jax_main(argv)
    with pytest.raises(SystemExit) as got:
        main([*argv, "--device", "cpu"])
    assert "jax engines only" in str(want.value)
    assert str(got.value) == str(want.value)


def test_cli_trains_the_preset(capsys):
    """``python -m dopt_torch.run --preset seqlm --device cpu --rounds 2``
    at the preset's full width: two loss rows, the first near
    log(vocab)."""
    import json

    from dopt_torch.run import main

    assert main(["--preset", "seqlm", "--device", "cpu", "--rounds",
                 "2"]) == 0
    out, err = capsys.readouterr()
    rows = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    assert [r["step"] for r in rows] == [0, 1]
    assert 3.0 < rows[0]["loss"] < 5.0
    assert "SeqLMTrainer on cpu, 469504 params, ring attention" in err


def test_three_lanes_equal_six_lanes_first_three_bit_for_bit():
    """The port's Model1 step (the engines' ``stacked_step``, plain
    update) at 3 lanes equals lanes 0-2 of its 6-lane step bit for bit
    on the CPU — params and momentum, which after a first step from
    zero is the gradient — so a card's 3-lane step may be held against
    the CPU's 6-lane one."""
    from dopt_torch.engine.local import stacked_step
    from dopt_torch.models.zoo import (full_f32, init_worker_params,
                                       stacked_forward)

    shape = (8, 8, 1)
    p0 = init_worker_params("model1", input_shape=shape,
                            generator=torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    x = torch.rand(6, 16, *shape, generator=gen)
    y = torch.randint(0, 10, (6, 16), generator=gen)
    w = torch.ones(6, 16)
    out = {}
    for lanes in (6, 3):
        params = {k: v.expand(lanes, *v.shape).clone().requires_grad_()
                  for k, v in p0.items()}
        moms = {k: torch.zeros_like(v) for k, v in params.items()}
        with full_f32(torch.device("cpu")):
            stacked_step(lambda z: stacked_forward("model1", params, z,
                                                   faithful=True),
                         params, moms, x[:lanes], y[:lanes], w[:lanes],
                         lr=0.01, momentum=0.5, fused=False)
        out[lanes] = {**{f"p.{k}": v.detach() for k, v in params.items()},
                      **{f"g.{k}": v for k, v in moms.items()}}
    for k, v in out[3].items():
        torch.testing.assert_close(v, out[6][k][:3], rtol=0, atol=0)


@pytest.mark.parametrize("cin,groups", [(3, 2), (1, 6)],
                         ids=["grouped", "depthwise"])
def test_rounded_conv_is_the_f64_conv_rounded_once(cin, groups):
    """The card's f32 grouped conv (``_RoundedConv``, run here on CPU
    tensors), grouped and depthwise: its output is the f64 conv rounded
    once to f32, bit for bit, and its input, weight and bias gradients
    are the f64 ones within 1e-6 (relative L2)."""
    import torch.nn.functional as F

    from dopt_torch.models.zoo import _RoundedConv

    gen = torch.Generator().manual_seed(4)
    z = torch.randn(8, cin * groups, 12, 12, generator=gen)
    w = torch.randn(4 * groups, cin, 5, 5, generator=gen)
    b = torch.randn(4 * groups, generator=gen)
    g = torch.randn(8, 4 * groups, 12, 12, generator=gen)
    args = [t.clone().requires_grad_() for t in (z, w, b)]
    out = _RoundedConv.apply(*args, 2, groups)
    grads = torch.autograd.grad((out * g).sum(), args)
    ref = [t.double().requires_grad_() for t in (z, w, b)]
    want = F.conv2d(*ref, padding=2, groups=groups)
    torch.testing.assert_close(out, want.float(), rtol=0, atol=0)
    for got, exp in zip(grads, torch.autograd.grad((want * g.double()).sum(),
                                                    ref)):
        assert (got.double() - exp).norm() <= 1e-6 * exp.norm()


@pytest.mark.parametrize("name,shape", [("model1", (12, 12, 1)),
                                        ("model3", (12, 12, 3))])
def test_rounded_conv_step_equals_library_conv_step(name, shape,
                                                    monkeypatch):
    """The engines' ``stacked_step`` with every conv routed through
    ``_RoundedConv`` (the card's differentiated f32 conv, here on CPU
    tensors) against the same step on the library conv, from one init
    and batch: each param and gradient within 1e-5 relative L2, the
    single-step bar phase 4c holds the card to."""
    from dopt_torch.engine.local import stacked_step
    from dopt_torch.models import zoo

    calls = []

    def rounded(z, weight, bias, groups, dtype):   # _grouped_conv's CUDA arm
        calls.append(groups)
        w = weight.reshape(-1, *weight.shape[2:]).to(dtype)
        assert dtype == torch.float32 and torch.is_grad_enabled()
        return zoo._RoundedConv.apply(z, w, bias.reshape(-1).to(dtype),
                                      weight.shape[-1] // 2, groups)

    p0 = zoo.init_worker_params(name, input_shape=shape,
                                generator=torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(6)
    x = torch.rand(4, 16, *shape, generator=gen)
    y = torch.randint(0, 10, (4, 16), generator=gen)
    w = torch.ones(4, 16)
    out = {}
    for conv in ("library", "rounded"):
        if conv == "rounded":
            monkeypatch.setattr(zoo, "_grouped_conv", rounded)
        params = {k: v.expand(4, *v.shape).clone().requires_grad_()
                  for k, v in p0.items()}
        moms = {k: torch.zeros_like(v) for k, v in params.items()}
        with zoo.full_f32(torch.device("cpu")):
            stacked_step(lambda z: zoo.stacked_forward(name, params, z,
                                                       faithful=True),
                         params, moms, x, y, w, lr=0.01, momentum=0.5,
                         fused=False)
        out[conv] = {**{f"p.{k}": v.detach() for k, v in params.items()},
                     **{f"g.{k}": v for k, v in moms.items()}}
    assert calls == [4, 4]   # both convs of the step's one forward
    for k, want in out["library"].items():
        got = out["rounded"][k]
        assert (got - want).norm() <= 1e-5 * want.norm(), k


def test_history_methods_and_plots_are_dopts(tmp_path):
    from dopt.utils.metrics import History as JH
    from dopt_torch.utils.metrics import History as TH
    from dopt_torch.utils.plotting import client_grid_plot, compare_histories

    rows = [dict(round=0, avg_test_acc=0.5, avg_train_loss=1.25),
            dict(round=1, avg_train_loss=0.75, note="x")]
    j, t = JH("h"), TH("h")
    for r in rows:
        j.append(**r)
        t.append(**r)
    j.log_fault(round=1, worker=2, kind="crash", action="masked")
    t.log_fault(round=1, worker=2, kind="crash", action="masked")
    assert len(t) == len(j) == 2 and list(t) == list(j)
    assert t["avg_train_loss"] == j["avg_train_loss"] and t.last() == j.last()
    assert TH().last() == JH().last() == {}
    t.to_json(tmp_path / "t.json")
    j.to_json(tmp_path / "j.json")
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json"
                                                 ).read_text()
    t.to_csv(tmp_path / "h.csv")
    assert TH.from_csv(tmp_path / "h.csv").rows == JH.from_csv(
        tmp_path / "h.csv").rows == rows
    t.faults_to_json(tmp_path / "f.json")
    assert TH.faults_from_json(tmp_path / "f.json") == j.faults == t.faults
    (tmp_path / "bad.json").write_text("{}")
    with pytest.raises(ValueError, match="not a fault-ledger export"):
        TH.faults_from_json(tmp_path / "bad.json")
    assert compare_histories({"a": t}, metrics=("avg_train_loss",),
                             save=tmp_path / "c.png").stat().st_size > 0
    clients = TH()
    for e in range(2):
        clients.append(worker=0, train_loss=1.0, val_loss=1.0,
                       train_acc=0.5, val_acc=0.5, epoch=e)
    assert client_grid_plot(clients, save=tmp_path / "g.png").exists()
    with pytest.raises(ValueError, match="client_history is empty"):
        client_grid_plot(TH())
