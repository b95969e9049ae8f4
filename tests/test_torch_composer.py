"""The experiment mode's configs: the port's composer against the JAX package's.

- the port's YAML reader gives what JAX's pyyaml loader gives, for every
  file of both config trees and a table of override values, and refuses
  what lies outside its subset, naming the file and line;
- the port's tree is the JAX tree with the ``_target_`` prefix swapped, and
  every one of its ``_target_``s instantiates;
- ``compose`` gives JAX's configs (prefix swapped) for train/eval × the four
  models × the four split datamodules, and for the extraction and inference
  roots; interpolation, required groups and the validators behave as JAX's;
- the CLI's dataclass recipes agree with the composed YAML;
- every experiment's sweep grid, and ``--list-sweep``'s lines, are JAX's.
"""

import dataclasses
import math
import subprocess
import sys
from pathlib import Path

import pytest

import cryovit_tpu.composer as jax_composer
import cryovit_tpu.config as jax_config
from cryovit_tpu_torch import composer
from cryovit_tpu_torch import config as port_config
from cryovit_tpu_torch.composer import ConfigError, instantiate, to_plain

JAX_TREE = Path(jax_composer.__file__).parent / "configs"
PORT_TREE = Path(composer.__file__).parent / "configs"
REPO = PORT_TREE.parents[1]
MODELS = ("cryovit", "unet3d", "sam2", "medsam")
DATAMODULES = ("single", "multi", "fractional", "fractional_loo")
EXPERIMENTS = sorted(p.stem for p in (JAX_TREE / "experiments").glob("*.yaml"))


def _swap(obj):
    """A JAX config with its ``_target_`` prefix swapped to the port's."""
    if isinstance(obj, dict):
        return {k: _swap(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_swap(v) for v in obj]
    if isinstance(obj, str) and obj.startswith("cryovit_tpu."):
        return "cryovit_tpu_torch." + obj[len("cryovit_tpu."):]
    return obj


def _same(a, b) -> bool:
    """Equal, and of the same types all the way down (1 is not 1.0 nor True)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


# ---- the YAML reader -------------------------------------------------------

@pytest.mark.parametrize("tree", [JAX_TREE, PORT_TREE], ids=["jax_tree", "port_tree"])
def test_reader_matches_pyyaml_on_every_config_file(tree):
    files = sorted(tree.rglob("*.yaml"))
    assert len(files) == 60
    for path in files:
        text = path.read_text()
        assert _same(composer._yaml_load(text, str(path)), jax_composer._yaml_load(text)), path


def test_port_tree_is_the_jax_tree_with_the_target_prefix_swapped():
    jax_files = sorted(p.relative_to(JAX_TREE) for p in JAX_TREE.rglob("*.yaml"))
    port_files = sorted(p.relative_to(PORT_TREE) for p in PORT_TREE.rglob("*.yaml"))
    assert jax_files == port_files and len(jax_files) == 60
    targets = 0
    for rel in jax_files:
        jax_lines = (JAX_TREE / rel).read_text().splitlines()
        port_lines = (PORT_TREE / rel).read_text().splitlines()
        assert len(jax_lines) == len(port_lines), rel
        for a, b in zip(jax_lines, port_lines):
            if a != b:
                assert a.replace("_target_: cryovit_tpu.", "_target_: cryovit_tpu_torch.") == b, rel
                targets += 1
            assert "cryovit_tpu." not in b or "cryovit_tpu_torch." in b, rel
    assert targets == 22


OVERRIDE_VALUES = [
    # floats: YAML 1.2's rule (1e-4) and YAML 1.1's (1.5e+3, .5, sexagesimal)
    "1e-4", "5e-5", "1E4", "1.5e3", "1.0e+4", "3.14", ".5", "1.", "-.inf", ".inf", ".nan",
    "190:20:30.15", "0.8",
    # ints: decimal, underscores, octal, hex, binary, sexagesimal, signs
    "0", "-0", "42", "+3", "-1", "1_000", "010", "0x1F", "0b101", "1:30", "08", "0_1",
    # booleans and nulls of YAML 1.1
    "true", "True", "TRUE", "yes", "off", "On", "no", "y", "n", "null", "Null", "~", "",
    # strings, quoting, comments, interpolations
    "AD", "AD Abeta", "single_hd_mito", "'quoted'", "'it''s'", '"tab\\there"', "a:b",
    "http://host/x", "foo # comment", "#x", "${paths.data_dir}/x", "${env:X,/tmp/a}", "nan",
    # collections
    "[AD, Young]", "[1e-4, 5e-5, 1e-5]", "[True, False]", "[0, 1, 2, 3]", "[]", "{}",
    "[a, [b, c]]", "{a: 1, b: [x, y]}", "[a:b]", "- a", "a: b",
    # comma lists (one override value per item)
    "a,b,1e-4", "1,2,3", "cryovit, unet3d",
]


@pytest.mark.parametrize("text", OVERRIDE_VALUES)
def test_override_values_parse_as_jax_parses_them(text):
    want, got = jax_composer._parse_value(text), composer._parse_value(text)
    assert _same(want, got), (want, got)


@pytest.mark.parametrize("text, what, line", [
    ("key: &anchor value", "anchors", 1),
    ("a: 1\nb: *anchor", "aliases", 2),
    ("key: !!str 5", "tags", 1),
    ("key: |\n  one\n  two", "block scalars", 1),
    ("key: >\n  folded", "block scalars", 1),
    ("key:\n  first\n  second", "multi-line scalar", 3),
    ("key: [a, b", "does not close", 1),
    ("a: 1\nkey: 'open", "does not close", 2),
    ("key: a: b", "text after a value", 1),
    ("---\nkey: 1", "document markers", 1),
    ("%YAML 1.1\nkey: 1", "directives", 1),
    ("a: 1\nwhen: 2001-12-14", "timestamp", 2),
    ("<<: {a: 1}", "merge keys", 1),
    ("a:\n\tb: 1", "tab", 2),
    ("a: 1\n  b: 2", "multi-line scalar", 2),
])
def test_constructs_outside_the_subset_raise_naming_file_and_line(text, what, line):
    with pytest.raises(ConfigError, match=what) as info:
        composer._yaml_load(text, "exp.yaml")
    assert f"exp.yaml:{line}:" in str(info.value)


def test_config_file_errors_name_the_file(tmp_path):
    (tmp_path / "bad.yaml").write_text("name: ok\nlist: [a, b\n")
    with pytest.raises(ConfigError, match=r"bad\.yaml:2:"):
        composer.compose("bad", config_dir=tmp_path)


# ---- composition -------------------------------------------------------------

COMPOSITIONS = (
    [(root, [f"model={m}", f"datamodule={d}", "label_key=mito"])
     for root in ("train_model", "eval_model") for m in MODELS for d in DATAMODULES]
    + [("dino_features", []), ("sam_features", []),
       ("dino_features", ["sample=AD", "batch_size=16"])]
    + [("infer_model", [f"model={m}", "label_key=mito"]) for m in MODELS]
    + [("train_model", ["model=cryovit", "+experiments=single_hd_mito"]),
       ("train_model", ["model=sam2", "+experiments=sam2_hparams", "datamodule=single"]),
       ("eval_model", ["model=unet3d", "+experiments=fractional_mito",
                       "datamodule.sample=[AD, Young]", "datamodule.test_sample=3",
                       "datamodule.split_id=2", "model.lr=5e-4", "logger={}"])]
)


@pytest.mark.parametrize("root, overrides", COMPOSITIONS,
                         ids=[f"{r}-{'-'.join(o)}" for r, o in COMPOSITIONS])
def test_compose_matches_jax(root, overrides):
    want = _swap(to_plain(jax_config.compose(root, overrides)))
    got = to_plain(port_config.compose(root, overrides))
    assert _same(got, want), (got, want)


def test_env_interpolation(monkeypatch):
    monkeypatch.setenv("CRYOVIT_DATA_DIR", "/data/xyz")
    monkeypatch.delenv("CRYOVIT_MODEL_DIR", raising=False)
    cfg = port_config.compose("dino_features")
    assert cfg.paths.data_dir == "/data/xyz"
    assert cfg.paths.exp_dir == "/data/xyz/results"
    assert cfg.model_dir == "/data/xyz/foundation_models/DINOv2"
    assert _same(to_plain(cfg), _swap(to_plain(jax_config.compose("dino_features"))))


def test_required_group_and_bad_override_raise():
    for compose in (port_config.compose, jax_config.compose):
        with pytest.raises(Exception, match="required"):
            compose("train_model", ["datamodule=single", "label_key=mito"])
    with pytest.raises(ConfigError, match="expected key=value"):
        port_config.compose("train_model", ["model"])
    with pytest.raises(ConfigError, match="interpolation key not found"):
        port_config.compose("dino_features", ["model_dir=${paths.nowhere}"])


def test_validators_accept_and_reject_as_jax_does():
    ok = ["model=cryovit", "datamodule=single", "label_key=mito", "datamodule.sample=AD"]
    for overrides, error in [
        (ok, None),
        (ok + ["datamodule.test_sample=Young"], None),
        (["model=cryovit", "datamodule=fractional", "label_key=mito", "datamodule.sample=AD",
          "datamodule.test_sample=3"], None),
        (ok[:-1] + ["datamodule.sample=NotASample"], "invalid sample"),
        (ok + ["datamodule.test_sample=[Young, Nope]"], "invalid sample"),
        (["model=cryovit", "datamodule=single", "datamodule.sample=AD"], "missing"),
    ]:
        for cfg_mod in (port_config, jax_config):
            cfg = cfg_mod.compose("train_model", overrides)
            if error is None:
                cfg_mod.validate_experiment_config(cfg)
            else:
                with pytest.raises(Exception, match=error):
                    cfg_mod.validate_experiment_config(cfg)
    port_config.validate_dino_config(port_config.compose("dino_features", ["sample=Young"]))
    with pytest.raises(ConfigError, match="invalid sample"):
        port_config.validate_dino_config(port_config.compose("dino_features", ["sample=Old"]))
    assert port_config.samples == jax_config.samples
    assert port_config.tomogram_exts == jax_config.tomogram_exts


# ---- instantiation -------------------------------------------------------------

def _targets(node, out):
    if isinstance(node, dict):
        if "_target_" in node:
            out[node["_target_"]] = node
        for v in node.values():
            _targets(v, out)
    elif isinstance(node, list):
        for v in node:
            _targets(v, out)
    return out


def test_every_target_of_the_tree_instantiates(monkeypatch, tmp_path):
    """Each of the 22 ``_target_``s, with the keys its YAML passes, makes an
    object of the port (wandb made unimportable: WandbLogger then logs
    nothing; the split datamodules read a 12-row splits CSV)."""
    monkeypatch.setitem(sys.modules, "wandb", None)
    monkeypatch.setenv("CRYOVIT_DATA_DIR", str(tmp_path))
    monkeypatch.delenv("CRYOVIT_EXP_DIR", raising=False)
    split_file = tmp_path / "splits.csv"
    split_file.write_text("sample,tomo_name,split_id\n" + "".join(
        f"{s},t{i}.hdf,{i % 3}\n" for s in ("AD", "Young") for i in range(6)))
    found: dict = {}
    for root, overrides in COMPOSITIONS + [
        ("train_model", ["model=cryovit", "datamodule=file", "label_key=mito",
                         "logger=wandb", "model/losses=focal_loss"]),
    ]:
        _targets(to_plain(port_config.compose(root, overrides)), found)
    assert len(found) == 22, sorted(found)
    for target, node in sorted(found.items()):
        assert target.startswith("cryovit_tpu_torch."), target
        if target.endswith("SampleDataModule") or target.endswith(".FractionalDataModule"):
            fractional = target.endswith(".FractionalDataModule")
            node = {**node, "sample": "AD", "test_sample": 0 if fractional else "Young"}
            obj = instantiate(node, split_file=split_file, dataset_fn=None, dataloader_fn=None)
        else:
            obj = instantiate(node)
        if node.get("_partial_"):
            assert callable(obj), target
        else:
            assert type(obj).__name__ == target.rsplit(".", 1)[1], target


def test_instantiate_partial_nested_and_refuses_the_jax_package():
    fn = instantiate({"_target_": "collections.OrderedDict", "_partial_": True})
    assert fn() == {}
    nested = instantiate({"a": {"_target_": "fractions.Fraction", "numerator": 1,
                                "denominator": 2}, "b": 3})
    assert nested.a == 0.5 and nested.b == 3
    with pytest.raises(ConfigError, match="cryovit_tpu_torch.models.CryoVIT"):
        instantiate({"_target_": "cryovit_tpu.models.CryoVIT"})
    with pytest.raises(ConfigError, match="no attribute"):
        instantiate({"_target_": "cryovit_tpu_torch.models.NoSuchModel"})


# ---- the CLI's dataclass recipes against the composed YAML --------------------

@pytest.mark.parametrize("model", MODELS)
def test_cli_recipes_agree_with_the_composed_yaml(model):
    cfg = port_config.compose("train_model", [f"model={model}", "datamodule=file",
                                              "label_key=mito"])
    recipe = port_config.TrainConfig.for_model(model, "mito")
    m = recipe.model
    assert (m.model_type, m.name, m.input_key, m.lr, m.weight_decay) == (
        model, cfg.model.name, cfg.model.input_key, cfg.model.lr, cfg.model.weight_decay)
    assert list(m.losses) == list(cfg.model.losses)
    assert list(m.metrics) == list(cfg.model.metrics)
    assert m.metric_threshold == cfg.model.metrics.dice_metric.threshold
    custom = {k: list(v) if isinstance(v, tuple) else v for k, v in m.custom_kwargs}
    assert custom == (cfg.model.custom_kwargs or {})
    trainer = dataclasses.asdict(recipe.trainer)
    assert trainer == {k: cfg.trainer[k] for k in trainer}
    assert recipe.random_seed == cfg.random_seed
    swa = cfg.callbacks.stochastic_weight_average
    assert recipe.swa.swa_epoch_start == swa.swa_epoch_start
    assert swa.swa_lrs == cfg.model.lr and swa.annealing_epochs == 0
    dl = dataclasses.asdict(recipe.dataloader)
    assert dl == {k: cfg.datamodule.dataloader[k] for k in dl}
    assert recipe.sam_name == cfg.paths.sam_name
    # evaluation: trainer/eval.yaml; max_epochs and the gradient clip
    # (trainer_model/sam2.yaml) take no part in a test pass
    ev = port_config.compose("eval_model", [f"model={model}", "datamodule=file",
                                            "label_key=mito"])
    eval_trainer = dataclasses.asdict(port_config.EvalConfig("mito", "x").trainer)
    unused = ("max_epochs", "gradient_clip_val", "gradient_clip_algorithm")
    assert {k: v for k, v in eval_trainer.items() if k not in unused} == {
        k: ev.trainer[k] for k in eval_trainer if k not in unused}
    assert list(ev.callbacks) == ["progress_bar", "test_pred_writer", "csv_writer"]


# ---- sweeps ------------------------------------------------------------------------

@pytest.mark.parametrize("experiment", EXPERIMENTS)
def test_sweep_grids_match_jax(experiment):
    got = composer.expand_sweep_file(experiment)
    assert got == jax_composer.expand_sweep_file(experiment)
    cfg = port_config.compose("train_model", ["model=cryovit", "datamodule=single",
                                              f"+experiments={experiment}"])
    assert composer.expand_sweep(cfg) == got


@pytest.mark.parametrize("module, overrides", [
    ("train_model", ["model=cryovit", "+experiments=single_hd_mito"]),
    ("eval_model", ["model=unet3d", "+experiments=test_experiment"]),
    ("train_model", ["model=cryovit", "datamodule=single", "label_key=mito"]),
])
def test_list_sweep_prints_the_jax_lines(module, overrides):
    lines = []
    for package in ("cryovit_tpu_torch", "cryovit_tpu"):
        out = subprocess.run(
            [sys.executable, "-m", f"{package}.training.{module}", *overrides, "--list-sweep"],
            capture_output=True, text=True, cwd=REPO, timeout=120,
            env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO)},
        )
        assert out.returncode == 0, out.stderr[-2000:]
        lines.append(out.stdout)
    assert lines[0] == lines[1] and lines[0].strip()
