"""One arm of the quality-parity protocol on the card (counterpart of
``sdfstudio_tpu/scripts/benchmarking/parity.py``; ``docs/parity-protocol.md``):

    python -m sdfstudio_tpu_torch.scripts.benchmarking.parity \\
        [--method neus-facto-tpu-p8|neus-facto|neus-facto-tpu|neusW] [--segment 5000] \\
        [--budget-seconds S] [--device cuda|cpu] [--seed N]

Trains the method (default ``neus-facto-tpu-p8``, the preset) for 20,000
steps of 2048 rays on the committed scene ``.parity/dtu_like`` (never
regenerated; every view trains and every view is evaluated, ``holdout`` 0,
as ``PARITY.json`` was made) through the train command
(``scripts/train.py::main``), with the argv JAX's ``train_segment`` builds
(parity.py:135-176): ``--experiment-name parity --output-dir
.parity/cuda_runs --timestamp parity --vis none``, deferred heavy
operations, no eval images, and on the last segment the trainer's final
evaluation (eval-split PSNR and SSIM, Chamfer-L1 of the 256^3 mesh against
the analytic surface). Then it writes its arm into ``PARITY_CUDA.json``,
judged against ``PARITY.json``'s control with the same criteria: PSNR at
most 0.3 dB below it, Chamfer-L1 at most 10% above. The preset's arm fills
``PARITY.json``'s schema (``method``, ``pass``, ``preset``, ``control``,
...); ``neus-facto``, the control method itself trained by the port, goes
under ``control_cuda``, and ``neus-facto-tpu`` under ``neus_facto_tpu_cuda``
beside JAX's TPU score of the same method
(``.parity/runs/parity/neus-facto-tpu/parity/parity_metrics.json``).

``neusW`` trains on the second protocol scene, the committed
``.parity/heritage_like`` (``docs/parity-protocol.md``, "Second scene"),
through ``heritage-data`` with JAX's run config
(``.parity/runs/heritage/neusW/parity/config.yml``: the same flags, seed 42,
checkpoints every 5,000 steps), and ends in the heritage judge over the
parser's 10 eval views. Its arm goes under ``heritage_neusW_cuda``, judged
against JAX's one TPU run
(``.parity/runs/heritage/neusW/parity/heritage_metrics.json``) by the
first-scene rule: PSNR at least JAX's less 0.3 dB, Chamfer-L1 at most
JAX's plus 10%. ``--seed`` (the batch and jitter generator's, default 42 as
JAX's run) other than 42 runs the arm again beside it, under
``heritage_neusW_cuda_seed<N>``, to show the spread. Each arm leaves the
other arms' keys as they are.

Each segment of ``--segment`` steps is one call of the train command in
this process, ending in a checkpoint under
``.parity/cuda_runs/parity/<method>/parity/``; the next resumes from it,
and so does a new invocation. ``--budget-seconds`` stops before a segment
that would start after that much wall time, so one call of bounded length
makes progress.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import List, Optional, Sequence

from sdfstudio_tpu_torch.scripts import train as train_script

REPO = Path(__file__).resolve().parents[3]
PARITY_DIR = REPO / ".parity"
DATA_DIR = PARITY_DIR / "dtu_like"
RUNS_DIR = PARITY_DIR / "cuda_runs"
CONTROL = REPO / "PARITY.json"
ATTESTATION = REPO / "PARITY_CUDA.json"
METHODS = ("neus-facto-tpu-p8", "neus-facto", "neus-facto-tpu", "neusW")
# each arm's scene, parser subcommand and judge (neusW: the second protocol scene)
SCENES = {"neusW": (PARITY_DIR / "heritage_like", "heritage-data", "heritage-like")}
HERITAGE_JAX = PARITY_DIR / "runs" / "heritage" / "neusW" / "parity" / "heritage_metrics.json"
# JAX's 20k TPU scores of the arms the port trains beside them
JAX_RUNS = PARITY_DIR / "runs" / "parity"
ITERS = 20000
NUM_RAYS = 2048
PSNR_TOL_DB = 0.3  # parity.py:57-58
CHAMFER_TOL = 0.10
GEO_RES = 256
SEED = 42  # Config.seed's default, the seed of JAX's runs


def timestamp(seed: int = SEED) -> str:
    """The run's timestamp: ``parity``, and ``parity_seed<N>`` for another seed."""
    return "parity" if seed == SEED else f"parity_seed{seed}"


# the run's timestamp directory; main sets it from --seed
TIMESTAMP = timestamp()


def arm_base_dir(method: str) -> Path:
    """The JAX layout: output/experiment/method/timestamp (parity.py:72-74)."""
    return RUNS_DIR / "parity" / method / TIMESTAMP


def scene(method: str):
    """(scene directory, parser subcommand, judge) of ``method``'s arm."""
    return SCENES.get(method, (DATA_DIR, "sdfstudio-data", "dtu-like"))


def latest_step(method: str) -> int:
    ckpt_dir = arm_base_dir(method) / "sdfstudio_models"
    steps = [int(p.name.split("-")[1]) for p in ckpt_dir.glob("step-*") if (p / "step.txt").exists()]
    return max(steps, default=0)


def train_argv(method: str, end: int, resume: bool, final_eval: bool,
               device: Optional[str] = None, seed: int = SEED) -> List[str]:
    """The argv of JAX's ``train_segment`` (parity.py:135-176), with the
    port's ``--device``, and ``--seed`` when it is not the default."""
    args = [method, "--experiment-name", "parity", "--output-dir", str(RUNS_DIR),
            "--timestamp", TIMESTAMP, "--vis", "none",
            "--trainer.max-num-iterations", str(end),
            "--trainer.defer-heavy-ops", "True",
            "--trainer.steps-per-eval-image", "0",
            "--datamanager.train-num-rays-per-batch", str(NUM_RAYS)]
    data_dir, parser, judge = scene(method)
    if final_eval:
        base = arm_base_dir(method)
        args += ["--trainer.final-eval-gt", judge,
                 "--trainer.final-eval-output", str(base / "parity_metrics.json"),
                 "--trainer.final-eval-mesh", str(base / "mesh.ply"),
                 "--trainer.final-eval-resolution", str(GEO_RES)]
    if resume:
        args += ["--trainer.load-dir", str(arm_base_dir(method) / "sdfstudio_models"),
                 "--trainer.load-step", str(latest_step(method))]
    if device:
        args += ["--device", device]
    if seed != SEED:
        args += ["--seed", str(seed)]
    return args + [parser, "--data", str(data_dir)]


def write_attestation(arm: dict, control: dict, seed: int = SEED) -> dict:
    """``PARITY.json``'s schema and pass rule (parity.py:247-267) for the
    preset's arm; ``control_cuda`` for ``neus-facto``'s, and
    ``neus_facto_tpu_cuda`` for ``neus-facto-tpu``'s with JAX's TPU score
    beside it. The other arms' keys in ``PARITY_CUDA.json`` stay as they
    are."""
    ok = bool(arm["psnr"] >= control["psnr"] - PSNR_TOL_DB
              and arm["chamfer_l1"] <= control["chamfer_l1"] * (1 + CHAMFER_TOL))
    scores = {"psnr": arm["psnr"], "chamfer_l1": arm["chamfer_l1"], "iters": arm["iters"]}
    rec = json.loads(ATTESTATION.read_text()) if ATTESTATION.exists() else {}
    if arm["method"] == "neusW":
        jax = json.loads(HERITAGE_JAX.read_text())
        bar = {"psnr_min": jax["psnr"] - PSNR_TOL_DB,
               "chamfer_l1_max": jax["chamfer_l1"] * (1 + CHAMFER_TOL)}
        ok = bool(arm["psnr"] >= bar["psnr_min"] and arm["chamfer_l1"] is not None
                  and arm["chamfer_l1"] <= bar["chamfer_l1_max"])
        key = "heritage_neusW_cuda" + ("" if seed == SEED else f"_seed{seed}")
        rec[key] = {
            **scores, "ssim": arm["ssim"], "num_images": arm["num_images"], "pass": ok,
            "bar": bar, "scene": "heritage_like", "seed": seed,
            "jax_tpu": {k: jax[k] for k in ("psnr", "ssim", "chamfer_l1", "iters", "eval_backend")},
        }
    elif arm["method"] == "neus-facto":
        rec["control_cuda"] = {**scores, "pass": ok}
    elif arm["method"] == "neus-facto-tpu":
        jax_file = JAX_RUNS / arm["method"] / "parity" / "parity_metrics.json"
        jax = json.loads(jax_file.read_text())
        rec["neus_facto_tpu_cuda"] = {
            **scores, "ssim": arm["ssim"], "pass": ok,
            "jax_tpu": {k: jax[k] for k in ("psnr", "ssim", "chamfer_l1", "iters", "eval_backend")},
        }
    else:
        rec.update({
            "method": arm["method"],
            "pass": ok,
            "preset": scores,
            "control": {"psnr": control["psnr"], "chamfer_l1": control["chamfer_l1"],
                        "iters": control["iters"]},
            "scene": "dtu_like",
            "holdout": 0,
            "criteria": {"psnr_tol_db": PSNR_TOL_DB, "chamfer_tol": CHAMFER_TOL},
        })
    ATTESTATION.write_text(json.dumps(rec, indent=2) + "\n")
    print(f"[parity] {arm['method']} -> {ATTESTATION}: pass={ok}", flush=True)
    return rec


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sdfstudio_tpu_torch.scripts.benchmarking.parity")
    ap.add_argument("--method", default=METHODS[0], choices=METHODS)
    ap.add_argument("--segment", type=int, default=5000, help="steps per checkpointed segment")
    ap.add_argument("--budget-seconds", type=float, default=None,
                    help="start no segment after this much wall time (re-run to resume)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=SEED,
                    help="the batch and jitter generator's seed (neusW's arm only)")
    args = ap.parse_args(argv)
    t_start = time.time()
    data_dir = scene(args.method)[0]
    if not data_dir.is_dir():
        raise FileNotFoundError(f"the committed parity scene is missing: {data_dir}")
    control = json.loads(CONTROL.read_text())["control"]
    method = args.method
    global TIMESTAMP
    TIMESTAMP = timestamp(args.seed)
    metrics = arm_base_dir(method) / "parity_metrics.json"
    start = latest_step(method)
    if not (metrics.exists() and start >= ITERS
            and json.loads(metrics.read_text())["iters"] == start):
        metrics.unlink(missing_ok=True)
        while not (start >= ITERS and metrics.exists()):
            if args.budget_seconds and time.time() - t_start > args.budget_seconds:
                print(f"[parity] budget spent at step {start}; re-run to resume", flush=True)
                return 0
            end = min(start + args.segment, ITERS)
            t0 = time.time()
            # at ITERS the trainer also runs the final evaluation
            train_script.main(train_argv(method, end, start > 0, end >= ITERS, args.device,
                                         args.seed))
            print(f"[parity] {method}: segment -> {end} done in {time.time() - t0:.0f}s", flush=True)
            start = latest_step(method)
    rec = json.loads(metrics.read_text())
    print(f"[parity] {method}: {json.dumps(rec)}", flush=True)
    write_attestation(rec, control, args.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
