"""Image rendering and PSNR (counterpart of ``sdfstudio_tpu/engine/final_eval.py``).

``render_image`` is the serving entry: one camera's rays in chunks of
``eval_num_rays_per_chunk`` through ``get_outputs(train=False)``, the last
chunk padded by repeating its last ray as ``_chunked`` does
(final_eval.py:37-51), so every chunk has the same shapes.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import torch

from sdfstudio_tpu_torch.cameras.cameras import Cameras
from sdfstudio_tpu_torch.core.rays import RayBundle


def set_fp32_precision() -> None:
    """Full-f32 products, as the JAX kernel runs at Precision.HIGHEST
    (pallas_mlp.py:62-66): no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _chunked(bundle: RayBundle, chunk: int) -> Iterator[Tuple[RayBundle, int]]:
    """Yield (chunk bundle of exactly ``chunk`` rays, number of real rays)."""
    n = bundle.num_rays
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        pad = chunk - (stop - start)

        def take(x):
            x = x[start:stop]
            if pad:
                x = torch.cat([x, x[-1:].expand(pad, *x.shape[1:])], dim=0)
            return x

        yield bundle.map(take), stop - start


def psnr(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """utils/metrics.py:14-16."""
    mse = torch.mean((pred - target) ** 2)
    return 10.0 * torch.log10(data_range**2 / torch.clamp(mse, min=1e-12))


# the step a render takes without a trained one, as the reference renders
# with no trainer state (trainer.py:516-520)
UNTRAINED_STEP = 1e9
IMAGE_KEYS = ("rgb", "depth", "accumulation", "normal")


@torch.no_grad()
def render_image(model, cameras: Cameras, index: int, chunk: Optional[int] = None,
                 step: Optional[float] = None) -> Dict[str, torch.Tensor]:
    """Render camera ``index`` to ``{key: [H, W, C]}`` (trainer.py:477-530 with
    final_eval.py:54-68), with the schedules at ``step``: the trained step
    of the parameters (the reference passes ``state.step``), or
    ``UNTRAINED_STEP`` when there is none."""
    set_fp32_precision()
    chunk = chunk or model.config.eval_num_rays_per_chunk
    device = next(model.parameters()).device
    if cameras.device != device:
        raise ValueError(f"cameras on {cameras.device}, model on {device}")
    h, w = int(cameras.height[index]), int(cameras.width[index])
    bundle = cameras.generate_image_rays(index)
    sched = model.schedules(UNTRAINED_STEP if step is None else step)
    outs = {k: [] for k in IMAGE_KEYS}
    for rb, n_real in _chunked(bundle, chunk):
        out = model.get_outputs(rb, sched=sched, train=False)
        for k in IMAGE_KEYS:
            outs[k].append(out[k][:n_real])
    return {k: torch.cat(v, 0).reshape(h, w, -1) for k, v in outs.items()}

