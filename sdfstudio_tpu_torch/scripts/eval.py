"""Average eval-image metrics of a trained run (counterpart of
``sdfstudio_tpu/scripts/eval.py``, ``sst-eval``):

    python -m sdfstudio_tpu_torch.scripts.eval --load-config <run>/config.yml \\
        [--output-path output.json] [--device cuda|cpu]

Rebuilds the run from its ``config.yml`` with its newest complete
checkpoint (``engine/setup.py::eval_setup``), scores every eval image as
the training loop does (PSNR, SSIM, and LPIPS when ``SST_LPIPS_WEIGHTS``
is set) and writes JAX's JSON: ``experiment_name``, ``method_name``,
``checkpoint``, ``results`` (the means), ``num_images``, ``seconds``. It
runs on ``cuda`` unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from sdfstudio_tpu_torch.engine.setup import eval_setup


def run(load_config: Path, output_path: Path, device: Optional[str] = None) -> dict:
    """eval.py:18-45."""
    config, trainer = eval_setup(load_config, device=device)
    n = trainer.datamanager.num_eval_images
    metrics = []
    t0 = time.time()
    for i in range(n):
        m = trainer.eval_image_metrics(i)
        metrics.append(m)
        print(f"image {i}: psnr={m['psnr']:.2f} ssim={m['ssim']:.4f}", flush=True)
    avg = {k: float(np.mean([m[k] for m in metrics])) for k in metrics[0]}
    result = {
        "experiment_name": config.experiment_name,
        "method_name": config.method_name,
        "checkpoint": str(config.get_checkpoint_dir()),
        "results": avg,
        "num_images": n,
        "seconds": time.time() - t0,
    }
    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    output_path.write_text(json.dumps(result, indent=2))
    print(json.dumps(avg), flush=True)
    return result


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="python -m sdfstudio_tpu_torch.scripts.eval")
    p.add_argument("--load-config", type=Path, required=True)
    p.add_argument("--output-path", type=Path, default=Path("output.json"))
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = p.parse_args(argv)
    run(a.load_config, a.output_path, a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
