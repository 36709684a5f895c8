"""Time a method's training loop and one render on the card, for one checkout.

    python sdfstudio_tpu_torch/scripts/benchmarking/step_time.py [--root DIR]
        [--method neus-facto] [--steps 40] [--label NAME]

Run as a file, not with ``-m``: ``--root DIR`` (default: this checkout)
puts ``DIR`` first on ``sys.path``, so the port that runs is ``DIR``'s,
and another checkout (the parent of a change, unpacked by ``git archive``)
is timed by the same script. Two checkouts are compared in one call, each
in its own process and in turns (parent, change, change, parent), since
the card's host varies from machine to machine.

It trains ``--method`` from seed 0 on the committed scene
(``.parity/dtu_like`` of this checkout) at 2048 rays a step: the first 12
steps one at a time (the kernels build on the first), then the rest
through ``Trainer.train``, the loop a user runs, timed by the host clock
from the first step to one synchronise at the end (``chip_smoke.py``'s
window). Then a seeded model of the method renders one 384x384 view in
1024-ray chunks, three times warm, timed each. Prints one JSON line with
the ``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO, help="the checkout whose port to time")
    ap.add_argument("--method", default="neus-facto")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--label", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("step_time: needs a CUDA card", file=sys.stderr)
        return 2
    from sdfstudio_tpu_torch.cameras.cameras import Cameras
    from sdfstudio_tpu_torch.configs.methods import build_model
    from sdfstudio_tpu_torch.core.scene_box import SceneBox
    from sdfstudio_tpu_torch.engine.final_eval import render_image, set_fp32_precision
    from sdfstudio_tpu_torch.scripts import train as train_script

    import sdfstudio_tpu_torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    set_fp32_precision()
    # a checkout from before the helper took its name calls it setup_trainer
    setup = getattr(train_script, "setup_method_trainer", None) or train_script.setup_trainer
    trainer = setup(args.method, os.path.join(REPO, ".parity", "dtu_like"),
                    max_num_iterations=args.steps, num_rays=2048, device="cuda")
    first = 12
    for _ in range(first):
        trainer.train_step()
    torch.cuda.synchronize()
    t = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3 / (args.steps - first)
    del trainer
    torch.cuda.empty_cache()

    scene_box = SceneBox(aabb=np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], np.float32),
                         near=0.8, far=4.0, radius=1.0, collider_type="near_far")
    model = build_model(args.method, scene_box, num_train_data=1, seed=0, device="cuda")
    c2w = np.eye(4)[:3].copy()
    c2w[2, 3] = 2.0
    cams = Cameras.create(c2w, 422.4, 422.4, 192.0, 192.0, 384, 384, device="cuda")
    render_image(model, cams, 0, chunk=1024)
    image_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        render_image(model, cams, 0, chunk=1024)
        torch.cuda.synchronize()
        image_ms.append((time.perf_counter() - t) * 1e3)
    print(json.dumps({"label": args.label, "root": args.root,
                      "package": os.path.dirname(sdfstudio_tpu_torch.__file__),
                      "method": args.method, "steps": args.steps, "loop_step_ms": step_ms,
                      "rays_per_s": 2048 / step_ms * 1e3, "image_ms": image_ms,
                      "image_ms_median": float(np.median(image_ms)), "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
