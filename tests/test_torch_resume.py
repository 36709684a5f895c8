"""Save, load and resume in the port's trainer, on the CPU.

Four straight steps of each full-width method (``neus-facto-tpu-p8`` and
``neus-facto``) at 64 rays on the committed scene equal two steps, a save,
a fresh trainer's load and two more steps, bit for bit: the parameters,
every group's Adam moments and count, the step, the metrics of the last step
and the generator's state. The tolerance is 0. PyTorch's CPU
``index_put_`` with accumulation (the backward of p8's table gather) adds
with parallel atomics, in an order that changes from run to run, unless
deterministic algorithms are on; with them on, the CPU repeats a step bit
for bit, so the module turns them on. (The hash grid's table gradient is an
``index_add_`` on the CPU.)
"""
import dataclasses
import pathlib

import pytest
import torch

from sdfstudio_tpu_torch.configs.methods import build_model, get_method_config
from sdfstudio_tpu_torch.data.datamanager import VanillaDataManager
from sdfstudio_tpu_torch.data.dataparsers.sdfstudio import parse
from sdfstudio_tpu_torch.engine.trainer import CHECKPOINT_FILE, Trainer

SCENE = pathlib.Path(__file__).resolve().parents[1] / ".parity" / "dtu_like"
RAYS = 64


@pytest.fixture(autouse=True)
def deterministic():
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


@pytest.fixture(scope="module")
def data():
    """The scene on the CPU, decoded once and shared by every trainer here."""
    if not (SCENE / "meta_data.json").is_file():
        pytest.fail(f"the committed scene is missing: {SCENE}")
    cfg = get_method_config("neus-facto-tpu-p8")
    outputs = parse(SCENE)
    dm_cfg = dataclasses.replace(cfg.datamanager, train_num_rays_per_batch=RAYS)
    return outputs.scene_box, VanillaDataManager(dm_cfg, outputs, device="cpu")


def _setup(data, output_dir=None, method="neus-facto-tpu-p8", **fields):
    """A set-up trainer as ``scripts/train.py::setup_method_trainer`` builds it."""
    scene_box, dm = data
    cfg = get_method_config(method)
    model = build_model(cfg, scene_box, num_train_data=dm.num_train_images, seed=0,
                        device="cpu").train()
    trainer = Trainer(dataclasses.replace(cfg.trainer, **fields), model, dm, cfg.optimizers,
                      base_dir=output_dir)
    trainer.setup()
    return trainer


def _state(trainer):
    out = {f"param/{n}": p.detach() for n, p in trainer.model.named_parameters()}
    for g, opt in trainer.optimizers.items():
        out.update({f"mu/{g}/{n}": t for n, t in zip(opt.names, opt.mu)})
        out.update({f"nu/{g}/{n}": t for n, t in zip(opt.names, opt.nu)})
        out[f"count/{g}"] = torch.tensor(opt.count)
    out["step"] = torch.tensor(trainer.step)
    out["generator"] = trainer.generator.get_state()
    return out


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("method", ["neus-facto-tpu-p8", "neus-facto"])
def test_resume_repeats_the_straight_run_bit_for_bit(data, tmp_path, method):
    straight = _setup(data, method=method)
    rows = [straight.train_step() for _ in range(4)]

    first = _setup(data, output_dir=tmp_path, method=method, steps_per_save=2)
    first.train(2)  # saves at its end
    ckpt_dir = tmp_path / "sdfstudio_models"
    assert sorted(p.name for p in ckpt_dir.iterdir()) == ["step-000000002"]
    saved = _state(first)

    resumed = _setup(data, load_dir=ckpt_dir, method=method)  # the newest complete checkpoint
    _assert_same(_state(resumed), saved)
    resumed_rows = [resumed.train_step() for _ in range(2)]
    assert torch.equal(resumed_rows[-1], rows[-1])
    _assert_same(_state(resumed), _state(straight))


def test_checkpoint_directories(data, tmp_path):
    """Only the newest step directory stays; a directory without
    ``step.txt`` (a save that did not finish) is never loaded."""
    trainer = _setup(data, output_dir=tmp_path, steps_per_save=1)
    trainer.train(2)
    ckpt_dir = tmp_path / "sdfstudio_models"
    assert sorted(p.name for p in ckpt_dir.iterdir()) == ["step-000000002"]
    assert (ckpt_dir / "step-000000002" / "step.txt").read_text() == "2"
    partial = ckpt_dir / "step-000000003"
    partial.mkdir()
    (partial / CHECKPOINT_FILE).write_bytes(b"")
    assert _setup(data, load_dir=ckpt_dir).step == 2
    with pytest.raises(FileNotFoundError, match="no complete checkpoint"):
        _setup(data, load_dir=ckpt_dir, load_step=3)
    with pytest.raises(FileNotFoundError, match="no complete checkpoint"):
        _setup(data, load_dir=tmp_path / "nothing")
