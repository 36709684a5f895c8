"""Write a deterministic, non-canonical LPIPS weights file (counterpart of
``sdfstudio_tpu/scripts/make_lpips_weights.py``):

    python -m sdfstudio_tpu_torch.scripts.make_lpips_weights out.npz [--seed 0]
    SST_LPIPS_WEIGHTS=out.npz python -m sdfstudio_tpu_torch.scripts.eval ...

VGG16's convolutions He-initialised from a fixed numpy seed and uniform (1 /
C) heads, stamped ``canonical=0``, so that every consumer reports the
column as ``lpips_rand`` and never as ``lpips``. The same numpy draws as
JAX's ``make_weights`` (make_lpips_weights.py:33-52): from the same seed the
two write the same arrays.
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from sdfstudio_tpu_torch.utils.metrics import _VGG16_PLAN


def make_weights(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    out: dict = {"canonical": np.int32(0), "seed": np.int32(seed)}
    cin = 3
    stage_cout = {}
    for i, (cout, stage) in enumerate(_VGG16_PLAN):
        fan_in = 3 * 3 * cin
        out[f"conv{i}_w"] = rng.normal(0.0, np.sqrt(2.0 / fan_in),
                                       size=(3, 3, cin, cout)).astype(np.float32)
        out[f"conv{i}_b"] = np.zeros(cout, np.float32)
        stage_cout[stage] = cout
        cin = cout
    for s in range(5):
        c = stage_cout[s]
        out[f"lin{s}"] = np.full(c, 1.0 / c, np.float32)
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sdfstudio_tpu_torch.scripts.make_lpips_weights")
    ap.add_argument("out", type=Path)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    weights = make_weights(args.seed)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(args.out, **weights)
    n_params = sum(v.size for v in weights.values())
    print(f"wrote {args.out} ({n_params:,} params, seed={args.seed}, canonical=0 -> metric "
          "column 'lpips_rand')")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
