"""The train command's ``--deterministic`` switch: it turns on
``torch.use_deterministic_algorithms`` (with cuBLAS's workspace setting,
``CUBLAS_WORKSPACE_CONFIG=:4096:8``, unless the caller set one), and two
runs of ``neus-facto`` (hash grids, whose table gradient then takes the
deterministic path on the card) save the same parameters bit for bit. Each
run lies in JAX's layout, ``<output-dir>/<experiment>/<method>/<timestamp>/``."""
import os
import pathlib

import torch

from sdfstudio_tpu_torch.scripts import train as train_script
from tests.test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

SCENE = pathlib.Path(__file__).resolve().parents[1] / ".parity" / "dtu_like"


def test_train_cli_deterministic_flag_repeats_a_run(tmp_path, monkeypatch):
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    saved = []
    try:
        for run in ("a", "b"):
            assert train_script.main(["neus-facto", "--data", str(SCENE), "--device", "cpu",
                                      "--trainer.max-num-iterations", "1",
                                      "--datamanager.train-num-rays-per-batch", "16",
                                      "--output-dir", str(tmp_path / run),
                                      "--experiment-name", "x", "--timestamp", "t", "--vis", "none",
                                      "--trainer.steps-per-save", "1", "--deterministic"]) == 0
            assert torch.are_deterministic_algorithms_enabled()
            assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
            run_dir = tmp_path / run / "x" / "neus-facto" / "t"
            assert (run_dir / "config.yml").is_file()
            ckpt = sorted((run_dir / "sdfstudio_models").glob("step-*"))[-1]
            saved.append(torch.load(next(ckpt.glob("*.pt")), map_location="cpu",
                                    weights_only=True)["model"])
    finally:
        torch.use_deterministic_algorithms(False)
    assert saved[0].keys() == saved[1].keys()
    assert all(torch.equal(saved[0][k], saved[1][k]) for k in saved[0])
