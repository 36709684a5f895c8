"""The train command's grammar, its config tree and its run layout against
the JAX package's (``sdfstudio_tpu/scripts/train.py``,
``sdfstudio_tpu/configs/base.py``), on the CPU.

- A list of overrides (nested model, datamanager, trainer and optimizer
  paths; a tuple; a bool; a ``None``-typed field; the dataparser's flags)
  gives the port's config tree JAX's values: every field the port's tree
  carries equals the same field of JAX's ``parse_args`` tree (``to_dict``,
  the module paths of ``__dataclass__`` / ``__class__`` aside), for every
  registered method.
- JAX's parity argv (``train_segment``, parity.py:135-176) is taken as it
  is and gives JAX's tree.
- ``--output-dir`` is the root of ``<experiment>/<method>/<timestamp>/``, as
  JAX lays a run out; ``config.yml`` round-trips and is YAML.
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import yaml

from sdfstudio_tpu.scripts import train as jtrain

from sdfstudio_tpu_torch.configs.base import Config, override_nested
from sdfstudio_tpu_torch.configs.methods import method_configs
from sdfstudio_tpu_torch.data.synthetic import generate_sphere_dataset
from sdfstudio_tpu_torch.engine.trainer import Trainer, TrainerConfig
from sdfstudio_tpu_torch.scripts import train as train_script

REPO = pathlib.Path(__file__).resolve().parents[1]
SCENE = REPO / ".parity" / "dtu_like"
FACTO = ("neus-facto", "neus-facto-tpu", "neus-facto-tpu-p4", "neus-facto-tpu-p8", "neus-facto-bigmlp")

COMMON = ["--experiment-name", "e1", "--output-dir", "runs/x", "--timestamp", "ts", "--vis", "none",
          "--seed", "7",
          "--pipeline.model.sdf-field.inside-outside", "True",  # a bool, nested
          "--pipeline.model.eikonal-loss-mult", "0.05",
          "--model.sdf-field.hidden-dim", "128",
          "--pipeline.datamanager.train-num-rays-per-batch", "512",
          "--trainer.max-num-iterations", "300",
          "--trainer.steps-per-eval-image", "7",
          "--trainer.load-step", "5",  # a None-typed field
          "--trainer.load-dir", "some/dir",
          "--trainer.final-eval-gt", "sphere",
          "--trainer.accumulate-grad-steps", "2",
          "--optimizers.field.optimizer.lr", "0.002",
          "--optimizers.field.scheduler.max-steps", "3000"]
PARSER = ["sdfstudio-data", "--data", str(SCENE), "--skip-every-for-val-split", "8",
          "--train-val-no-overlap", "True", "--include-mono-prior", "False"]


def _argv(method):
    extra = []
    if method in FACTO:
        extra = ["--model.num-proposal-samples-per-ray", "(128,64)",  # a tuple
                 "--datamanager.train-num-rays-per-batch", "256",
                 "--optimizers.proposal-networks.scheduler.max-steps", "4000"]
    return [method] + COMMON + extra + PARSER


def _strip(tree):
    """A ``to_dict`` tree without the module paths, which name the package."""
    if isinstance(tree, dict):
        return {k: _strip(v) for k, v in tree.items() if k not in ("__dataclass__", "__class__")}
    if isinstance(tree, list):
        return [_strip(v) for v in tree]
    return tree


def _held(port, ref, path=""):
    """Every field of the port's tree equals JAX's (the port's is a subset)."""
    n = 0
    if isinstance(port, dict):
        assert isinstance(ref, dict), path
        for k, v in port.items():
            assert k in ref, f"{path}.{k}: not a field of JAX's config"
            n += _held(v, ref[k], f"{path}.{k}")
        return n
    if isinstance(port, list):
        assert isinstance(ref, list) and len(port) == len(ref), path
        return sum(_held(a, b, f"{path}[{i}]") for i, (a, b) in enumerate(zip(port, ref)))
    assert port == ref and type(port) is type(ref), f"{path}: {port!r} != {ref!r}"
    return 1


def _jax_tree(argv):
    return _strip(jtrain.parse_args(argv).to_dict())


@pytest.mark.parametrize("method", sorted(method_configs))
def test_overrides_give_jax_config_tree(method):
    argv = _argv(method)
    config, port = train_script.parse_args(argv)
    assert port == {"device": None, "deterministic": False}
    n = _held(_strip(config.to_dict()), _jax_tree(argv))
    assert n > 60
    # the overrides took: each differs from the registry's value
    t = config.trainer
    assert (t.max_num_iterations, t.steps_per_eval_image, t.load_step, t.load_dir) == (300, 7, 5, "some/dir")
    assert config.model.sdf_field.inside_outside is True and config.model.sdf_field.hidden_dim == 128
    assert config.optimizers["field"].optimizer.lr == 0.002
    assert (config.dataparser.skip_every_for_val_split, config.dataparser.train_val_no_overlap) == (8, True)
    assert (config.seed, config.timestamp, config.get_base_dir()) == (
        7, "ts", pathlib.Path("runs/x/e1") / method / "ts")
    if method in FACTO:
        assert config.model.num_proposal_samples_per_ray == (128, 64)
        assert config.datamanager.train_num_rays_per_batch == 256


def test_jax_parity_argv_is_taken_as_it_is(monkeypatch):
    """JAX's ``train_segment`` builds its argv for a subprocess; captured
    there, the port's ``parse_args`` takes it unchanged."""
    from sdfstudio_tpu.scripts.benchmarking import parity as jparity

    seen = []
    monkeypatch.setattr(jparity, "run_with_stall_guard", lambda args, env: seen.append(args) or 0)
    monkeypatch.setattr(jparity, "latest_step", lambda method: 15000)
    jparity.train_segment("neus-facto-tpu", 20000, resume=True, final_eval=True)
    args = seen[0]
    assert args[1:3] == ["-m", "sdfstudio_tpu.scripts.train"]
    argv = args[3:]
    config, _ = train_script.parse_args(argv)
    _held(_strip(config.to_dict()), _jax_tree(argv))
    t = config.trainer
    assert t.defer_heavy_ops and t.steps_per_eval_image == 0 and t.max_num_iterations == 20000
    assert t.final_eval_gt == "dtu-like" and t.load_step == 15000
    assert config.get_base_dir() == jparity.RUNS_DIR / "parity" / "neus-facto-tpu" / "parity"
    # the port's own parity arm builds the same argv (its own runs directory aside)
    from sdfstudio_tpu_torch.scripts.benchmarking import parity as tparity

    monkeypatch.setattr(tparity, "latest_step", lambda method: 15000)
    mine = tparity.train_argv("neus-facto-tpu", 20000, True, True)
    swap = {str(jparity.RUNS_DIR): str(tparity.RUNS_DIR), str(jparity.DATA_DIR): str(tparity.DATA_DIR)}
    assert mine == [swap.get(a, a.replace(str(jparity.RUNS_DIR), str(tparity.RUNS_DIR)))
                    for a in argv]


def test_help_lists_the_methods(capsys):
    with pytest.raises(SystemExit) as e:
        train_script.parse_args(["-h"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    for name in method_configs:
        assert name in out
    assert "neus-facto with a TPU-optimized hash layout (8x4)." in out


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="item 14"):
        train_script.parse_args(["neus-facto", "blender-data", "--data", "x"])
    with pytest.raises(NotImplementedError, match="item 13"):
        train_script.parse_args(["neus-facto", "--machine.num-devices", "2"])
    with pytest.raises(ValueError, match="unknown flag"):
        train_script.parse_args(["neus-facto", "--model.not-a-field", "1"])
    with pytest.raises(NotImplementedError, match="viewer"):
        train_script.main(["neus-facto", "--vis", "viewer"])
    config, _ = train_script.parse_args(["neus-facto", "--trainer.dynamic-batch", "True"])
    with pytest.raises(NotImplementedError, match="dynamic_batch"):
        Trainer(config.trainer, None, None, {})
    with pytest.raises(NotImplementedError, match="mixed_precision"):
        Trainer(TrainerConfig(mixed_precision=True), None, None, {})
    config, _ = train_script.parse_args(["neus-facto", "sdfstudio-data", "--data", str(SCENE),
                                         "--include-mono-prior", "True"])
    from sdfstudio_tpu_torch.engine.setup import setup_trainer

    with pytest.raises(NotImplementedError, match="include_mono_prior"):
        setup_trainer(config, device="cpu")


def test_override_nested_conversions_match_jax():
    from sdfstudio_tpu.configs.base import override_nested as joverride

    tree = {"a": TrainerConfig()}
    for path, raw in [("a.load_step", "12"), ("a.load_dir", "x/y"), ("a.defer_heavy_ops", "yes"),
                      ("a.final_eval_gt", "sphere"), ("a.max_num_iterations", "9")]:
        port, ref = override_nested(tree, path, raw), joverride(tree, path, raw)
        assert getattr(port["a"], path[2:]) == getattr(ref["a"], path[2:])


def test_output_dir_is_the_root_of_the_run_layout(tmp_path):
    """``--output-dir D --experiment-name x --timestamp t`` puts the run in
    ``D/x/<method>/t/``: ``config.yml`` (written before training; JSON text,
    which is YAML, and JAX's tree) and the checkpoints. The parent took
    ``--output-dir`` as the run's own directory and refused the other
    flags."""
    scene = generate_sphere_dataset(tmp_path / "sphere", num_images=4, width=16, height=16)
    out = tmp_path / "D"
    argv = ["neus-facto-tpu", "--experiment-name", "x", "--output-dir", str(out), "--timestamp", "t",
            "--vis", "none", "--trainer.max-num-iterations", "1", "--trainer.steps-per-eval-image",
            "0", "--datamanager.train-num-rays-per-batch", "16",
            "--model.num-proposal-samples-per-ray", "(16,8)", "--model.num-neus-samples-per-ray",
            "8", "--device", "cpu", "sdfstudio-data", "--data", str(scene)]
    assert train_script.main(argv) == 0
    run = out / "x" / "neus-facto-tpu" / "t"
    assert sorted(p.name for p in out.iterdir()) == ["x"]
    assert (run / "sdfstudio_models" / "step-000000001" / "step.txt").read_text() == "1"
    text = (run / "config.yml").read_text()
    assert yaml.safe_load(text) == json.loads(text)
    loaded = Config.load_config(run / "config.yml")
    assert loaded.get_base_dir() == run and loaded.dataparser.data == scene
    # JAX's tree of the same argv, with the scene set on its parser as JAX's setup does
    jcfg = jtrain.parse_args([a for a in argv if a not in ("--device", "cpu")])
    jcfg.dataparser.data = jcfg.data
    _held(_strip(json.loads(text)), _strip(jcfg.to_dict()))
    # a round trip gives the same config: every field, the model class and the
    # tuples (a relative path comes back relative to the repository, as in JAX)
    config, _ = train_script.parse_args(argv)
    config.output_dir = tmp_path / "E"
    config.dataparser = dataclasses.replace(config.dataparser, data=scene)
    config.save_config()
    assert Config.load_config(config.get_base_dir() / "config.yml") == config


def test_port_flag_spellings_still_work(tmp_path):
    """The flags the port's callers spelled before JAX's grammar: the
    ``--data`` before the method's overrides, the trainer's flags without
    their prefix, ``--device`` and ``--deterministic``."""
    config, port = train_script.parse_args(
        ["neus-facto", "--data", str(SCENE), "--steps-per-save", "3", "--load-step", "4",
         "--final-eval-output", "m.json", "--final-eval-resolution", "64", "--device", "cpu",
         "--deterministic", "--datamanager.train-num-rays-per-batch", "16"])
    assert port == {"device": "cpu", "deterministic": True}
    t = config.trainer
    assert (t.steps_per_save, t.load_step, t.final_eval_output, t.final_eval_resolution) == (
        3, 4, "m.json", 64)
    assert config.data == SCENE and config.datamanager.train_num_rays_per_batch == 16
    assert np.isclose(config.optimizers["field"].optimizer.lr, 5e-4)
