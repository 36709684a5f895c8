"""Metrics and logging writer (counterpart of ``sdfstudio_tpu/utils/writer.py``):
JAX's event names, running averages over the last ``max_buffer_size``
values, the ETA and the printed row (writer.py:24-140).

tensorboardX and wandb are optional backends, used only when they can be
imported (neither is on the card's machine); images go to
``<log_dir>/images/*.png`` through the port's own PNG writer, where JAX
uses imageio.
"""
from __future__ import annotations

import time
from collections import defaultdict, deque
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from sdfstudio_tpu_torch.data.png import write_png

# event names (writer.py:17-21)
ITER_TRAIN_TIME = "Train Iter (time)"
TRAIN_RAYS_PER_SEC = "Train Rays / Sec"
TEST_RAYS_PER_SEC = "Test Rays / Sec"
ETA = "ETA (time)"


class Writer:
    """Scalar and image writer with running averages and an ETA."""

    def __init__(
        self,
        log_dir: Optional[Path] = None,
        use_tensorboard: bool = False,
        max_buffer_size: int = 20,
        banner: str = "",
        use_wandb: bool = False,
        wandb_project: str = "sdfstudio-tpu",
        experiment_name: str = "",
    ):
        self.log_dir = Path(log_dir) if log_dir else None
        self.buffers = defaultdict(lambda: deque(maxlen=max_buffer_size))
        self.tb = None
        self.wandb = None
        if use_tensorboard and self.log_dir is not None:
            try:
                from tensorboardX import SummaryWriter

                self.tb = SummaryWriter(str(self.log_dir))
            except Exception:  # not installed: no tensorboard events, as JAX
                self.tb = None
        if use_wandb:
            try:
                import wandb

                wandb.init(project=wandb_project, name=experiment_name or None,
                           dir=str(self.log_dir) if self.log_dir else None)
                self.wandb = wandb
            except Exception:
                self.wandb = None
        self.start_time = time.time()
        if banner:
            print(banner, flush=True)

    def put_scalar(self, name: str, value: float, step: int) -> None:
        self.buffers[name].append(float(value))
        if self.tb is not None:
            self.tb.add_scalar(name, float(value), step)
        if self.wandb is not None:
            self.wandb.log({name: float(value)}, step=step)

    def put_dict(self, values: Dict[str, float], step: int, prefix: str = "") -> None:
        for k, v in values.items():
            try:
                self.put_scalar(prefix + k, float(v), step)
            except (TypeError, ValueError):
                pass

    def put_image(self, name: str, image: np.ndarray, step: int) -> Optional[Path]:
        """``image`` [H, W, 3] in [0, 1]; returns the PNG's path, if one was written."""
        img = np.clip(np.asarray(image, np.float32), 0, 1)
        if self.tb is not None:
            self.tb.add_image(name, img, step, dataformats="HWC")
        if self.wandb is not None:
            self.wandb.log({name: self.wandb.Image(img)}, step=step)
        if self.log_dir is None:
            return None
        out = self.log_dir / "images"
        out.mkdir(parents=True, exist_ok=True)
        path = out / f"{name.replace('/', '_')}_{step:09d}.png"
        write_png(path, (img * 255).astype(np.uint8))
        return path

    def avg(self, name: str) -> float:
        buf = self.buffers.get(name)
        return float(np.mean(buf)) if buf else 0.0

    def eta(self, step: int, max_steps: int) -> str:
        remain = self.avg(ITER_TRAIN_TIME) * (max_steps - step)
        return time.strftime("%H:%M:%S", time.gmtime(remain))

    def print_row(self, step: int, max_steps: int, metrics: Dict[str, float]) -> None:
        parts = [f"step {step}/{max_steps}"]
        parts += [f"{k}={v:.4g}" for k, v in metrics.items()]
        rps = self.avg(TRAIN_RAYS_PER_SEC)
        if rps:
            parts.append(f"rays/s={rps:,.0f}")
        parts.append(f"eta={self.eta(step, max_steps)}")
        print("  ".join(parts), flush=True)

    def close(self) -> None:
        if self.tb is not None:
            self.tb.close()
        if self.wandb is not None:
            self.wandb.finish()
