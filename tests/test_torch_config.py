"""The port's config against dopt's: every field, every default, and a
refusal naming its slice for every value the port does not run.

The North star's promise: the port takes dopt's configs with dopt's
field names and defaults, and refuses an option it has not ported by
name, with the ROADMAP queue 1 slice that adds it — never with a
``TypeError`` at construction or "not a field" at the CLI.
"""

import dataclasses

import pytest

import dopt.config as J
import dopt_torch.config as T
from dopt_torch.engine import FederatedTrainer, GossipTrainer

CLASSES = ["DataConfig", "ModelConfig", "OptimizerConfig", "GossipConfig",
           "FederatedConfig", "FaultConfig", "RobustConfig", "SeqLMConfig",
           "ExperimentConfig"]


def _default(f):
    if f.default_factory is not dataclasses.MISSING:
        return f.default_factory()
    return f.default


@pytest.mark.parametrize("cls", CLASSES)
def test_field_sets_and_defaults_equal_dopt(cls):
    """Both directions: no dopt field is missing from the port, and each
    default is dopt's (sections compare as dopt-default sections)."""
    jf = {f.name: f for f in dataclasses.fields(getattr(J, cls))}
    tf = {f.name: f for f in dataclasses.fields(getattr(T, cls))}
    assert sorted(tf) == sorted(jf), cls
    for name, f in tf.items():
        want, got = _default(jf[name]), _default(f)
        if dataclasses.is_dataclass(want):
            assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        else:
            assert got == want, f"{cls}.{name}"


def _gossip(**kw):
    return T.ExperimentConfig(
        data=T.DataConfig(dataset="synthetic", num_users=2,
                          synthetic_train_size=32, synthetic_test_size=8),
        model=T.ModelConfig(input_shape=(8, 8, 1)),
        gossip=T.GossipConfig(local_ep=1, local_bs=16), **kw)


def _fed(**kw):
    return _gossip(**kw).replace(gossip=None, federated=T.FederatedConfig(
        frac=0.5, local_ep=1, local_bs=16))


def _set(cfg, section, **kw):
    return cfg.replace(**{section: dataclasses.replace(
        getattr(cfg, section), **kw)})


# (section or None for the top level, field, a non-default value, slice)
GOSSIP_ONLY = [
    # Lifted by the codecs slice: choco's knobs run, and dsgd ignores
    # them as dopt does (slice None).
    ("gossip", "choco_gamma", 0.5, None),
    ("gossip", "compression", "qsgd", None),
    ("gossip", "compression_ratio", 0.25, None),
    ("gossip", "qsgd_levels", 16, None),
    # Lifted by the telemetry slice: the value now runs (slice None).
    ("gossip", "diagnostics", "on", None),
]
BOTH = [
    # Lifted by the ResNet-18 slice: refused on another model in dopt's
    # words (slice "dopt"), and the value runs on resnet18.
    ("model", "stage_sizes", (1, 1, 1, 1), "dopt"),
    # Since the seqlm slice the section trains with SeqLMTrainer, and the
    # gossip and federated engines refuse it naming that trainer.
    (None, "seqlm", T.SeqLMConfig(), "SeqLMTrainer"),
    # Lifted by the multi-GPU engines slice: the worker axis runs over
    # the launched ranks; without a process group the value names the
    # launch it needs (slice "launch"; tests/test_torch_multigpu.py runs
    # it over gloo ranks).
    (None, "mesh_devices", 4, "launch"),
    (None, "mesh_hosts", 2, "launch"),
]


def _with(base, section, field, value):
    if section is None:
        return base.replace(**{field: value})
    return _set(base, section, **{field: value})


@pytest.mark.parametrize("section,field,value,slice_name", GOSSIP_ONLY + [
    ("both", *row[1:]) for row in BOTH],
    ids=[f"{r[0]}.{r[1]}" for r in GOSSIP_ONLY] + [r[1] for r in BOTH])
def test_unported_values_refused_naming_their_slice(section, field, value,
                                                    slice_name):
    engines = [(GossipTrainer, _gossip())]
    sec = section
    if section == "both":
        engines.append((FederatedTrainer, _fed()))
        sec = next(r[0] for r in BOTH if r[1] == field)
    for cls, base in engines:
        cfg = _with(base, sec, field, value)
        if slice_name is None:
            assert len(cls(cfg, device="cpu").run(rounds=1).rows) == 1
            continue
        if slice_name == "dopt":
            with pytest.raises(ValueError,
                               match="stage_sizes applies to resnet18 only"):
                cls(cfg, device="cpu")
            cfg = _set(cfg, "model", model="resnet18")
            assert len(cls(cfg, device="cpu").run(rounds=1).rows) == 1
            continue
        if slice_name == "SeqLMTrainer":
            with pytest.raises(ValueError, match="trains with dopt_torch."
                               "engine.SeqLMTrainer"):
                cls(cfg, device="cpu")
            continue
        if slice_name == "launch":
            with pytest.raises(ValueError, match="torch.distributed.run "
                               "--nproc-per-node"):
                cls(cfg, device="cpu")
            continue
        with pytest.raises(ValueError, match=f"'{slice_name}' slice"):
            cls(cfg, device="cpu")


@pytest.mark.parametrize("field,value", [("eps", 2), ("faithful_bugs", True)])
def test_gossip_algorithm_knobs_accepted(field, value):
    """fedlcon's knobs, refused until the gossip algorithms slice, are
    accepted on every algorithm, as dopt accepts them (dsgd ignores
    them), and a fedlcon trainer takes them."""
    for algorithm in ("dsgd", "fedlcon"):
        cfg = _set(_gossip(), "gossip", algorithm=algorithm,
                   **{field: value})
        tr = GossipTrainer(cfg, device="cpu")
        assert getattr(tr.cfg.gossip, field) == value


@pytest.mark.parametrize("section,field,value,why", [
    ("model", "stacked_impl", "vmap", "unknown stacked_impl"),
    (None, "backend", "torch", "unknown backend"),
])
def test_dopt_oracle_modes_refused_for_good(section, field, value, why):
    """dopt's oracle modes, once refused, run since the slice that ported
    them: both engines take ``stacked_impl="vmap"`` (the vmapped
    per-worker forward) and ``backend="torch"`` (which picks the oracle
    in ``build_trainer``; an engine built directly runs itself, as
    dopt's), and a value dopt does not know is still refused in its
    words, naming no slice."""
    for cls, base in ((GossipTrainer, _gossip()), (FederatedTrainer, _fed())):
        tr = cls(_with(base, section, field, value), device="cpu")
        assert getattr(tr.cfg if section is None else
                       getattr(tr.cfg, section), field) == value
        with pytest.raises(ValueError, match=why) as err:
            cls(_with(base, section, field, value + "x"), device="cpu")
        assert "slice" not in str(err.value)


def test_defaults_and_one_device_mesh_run():
    """dopt's defaults, ``backend='jax'`` (dopt's engine, here the
    port's own) and a one-device mesh construct."""
    GossipTrainer(_gossip(backend="jax", mesh_devices=1, mesh_hosts=1),
                  device="cpu")
    FederatedTrainer(_fed(mesh_devices=1), device="cpu")


def test_cli_set_of_an_unported_field_names_its_slice():
    """``--set gossip.diagnostics=on`` is a field of the preset, and since
    the telemetry slice it runs; an unported field's value is refused
    naming its slice, not "not a field"."""
    from dopt_torch.run import apply_override, main
    from dopt_torch.presets import get_preset

    cfg = apply_override(get_preset("baseline1"), "gossip.diagnostics=on")
    assert cfg.gossip.diagnostics == "on"
    assert main(["--preset", "baseline1", "--device", "cpu", "--rounds",
                 "1", "--set", "gossip.diagnostics=on", "--set",
                 "data.synthetic_train_size=160", "--set",
                 "data.synthetic_test_size=16"]) == 0
    # Since the scatter slice --set gossip.update_sharding=scatter runs
    # too; since the multi-GPU engines slice a mesh of more than one GPU
    # runs over launched ranks, and without them names the launch.
    assert main(["--preset", "baseline1", "--device", "cpu", "--rounds",
                 "1", "--set", "gossip.update_sharding=scatter", "--set",
                 "data.synthetic_train_size=160", "--set",
                 "data.synthetic_test_size=16"]) == 0
    with pytest.raises(ValueError, match="torch.distributed.run "
                       "--nproc-per-node 2"):
        main(["--preset", "headline-dsgd-model1", "--device", "cpu",
              "--set", "mesh_devices=2"])
