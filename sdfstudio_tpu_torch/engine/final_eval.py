"""Image rendering and the end-of-training evaluation (counterpart of
``sdfstudio_tpu/engine/final_eval.py``).

``render_image`` is the serving entry: one camera's rays in chunks of
``eval_num_rays_per_chunk`` through ``get_outputs(train=False)``, the last
chunk padded by repeating its last ray as ``_chunked`` does
(final_eval.py:37-51), so every chunk has the same shapes.

``run_final_eval`` is the parity protocol's evaluation
(``docs/parity-protocol.md``, final_eval.py:70-198): PSNR and SSIM over
the eval split rendered at the trained step (``eval_all_images``, all of
its images or an even spread of ``final_eval_max_images``), and Chamfer-L1
of the mesh extracted from the SDF against the analytic surface of the
DTU-like scene or of the sphere scene (``eval_geometry``; the mesh is
written to ``final_eval_mesh`` when that is set), written in
``parity_metrics.json``'s schema.
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from sdfstudio_tpu_torch.cameras.cameras import Cameras
from sdfstudio_tpu_torch.core.rays import RayBundle
from sdfstudio_tpu_torch.data.synthetic_dtu import chamfer_l1_to_gt
from sdfstudio_tpu_torch.scripts.benchmarking.eval_geometry import chamfer_l1_to_sphere
from sdfstudio_tpu_torch.utils.marching_cubes import get_surface_sliding
from sdfstudio_tpu_torch.utils.metrics import psnr, ssim  # psnr: callers import it from here


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


EVAL_CHUNK = 8192  # the final eval's smallest chunk (final_eval.py:80)


def eval_all_images(trainer, max_images: int = 0) -> Dict:
    """PSNR and SSIM of every eval image, or of an even spread of
    ``max_images`` of them, rendered at the trained step in chunks of
    ``max(eval_num_rays_per_chunk, 8192)`` (final_eval.py:70-111). The
    per-image values stay on the device and are read back once. Returns the
    means, ``num_images``, the views and ``per_image`` [(psnr, ssim)]."""
    dm, model = trainer.datamanager, trainer.model
    n_imgs = dm.num_eval_images
    if 0 < max_images < n_imgs:
        idxs = np.unique(np.linspace(0, n_imgs - 1, max_images).astype(int))
    else:
        idxs = np.arange(n_imgs)
    chunk = max(model.config.eval_num_rays_per_chunk, EVAL_CHUNK)
    per_image = []
    t0 = time.perf_counter()
    for i in idxs:
        gt = dm.eval_image_data(int(i))["image"][..., :3]
        rgb = render_image(model, dm.eval_cameras if dm.eval_cameras is not None else dm.train_cameras,
                           int(i), chunk=chunk, step=float(trainer.step))["rgb"]
        per_image.append(torch.stack([psnr(rgb, gt), ssim(rgb, gt)]))
    vals = torch.stack(per_image).cpu().numpy().astype(np.float64)  # one read back: [N, 2]
    dt = time.perf_counter() - t0
    print(f"[final-eval] {len(idxs)} images in {dt:.1f}s ({dt / max(len(idxs), 1):.2f}s/image)",
          flush=True)
    return {
        "psnr": float(vals[:, 0].mean()),
        "ssim": float(vals[:, 1].mean()),
        "num_images": int(len(idxs)),
        "views": [int(i) for i in idxs],
        "per_image": [(float(p), float(s)) for p, s in vals],
        "seconds": dt,
    }


def eval_geometry(trainer, gt: str = "dtu-like", resolution: int = 256,
                  mesh_path: Optional[Path] = None) -> Dict:
    """Mesh of the trained SDF on a ``resolution^3`` grid over ``[-1, 1]^3``
    and its Chamfer-L1 against the analytic surface (final_eval.py:114-166):
    the DTU-like scene's (``gt="dtu-like"``) or the sphere of radius 0.5
    (``"sphere"``); the heritage judge comes with ``neusW`` (ROADMAP queue 1
    item 12). The mesh is written to ``mesh_path`` when one is given.
    Returns the metrics, ``num_vertices`` and the seconds of each part."""
    if gt not in ("dtu-like", "sphere"):
        raise NotImplementedError(f"final-eval judge {gt!r} is not ported (ROADMAP queue 1 item 12, "
                                  "with neusW)")
    device = next(trainer.model.parameters()).device
    seconds = {}
    t0 = time.perf_counter()
    mesh = get_surface_sliding(trainer.model.field.sdf, device, resolution=resolution,
                               bounding_box_min=(-1.0,) * 3, bounding_box_max=(1.0,) * 3,
                               seconds=seconds)
    t1 = time.perf_counter()
    if mesh_path is not None and len(mesh.vertices):
        Path(mesh_path).parent.mkdir(parents=True, exist_ok=True)
        mesh.export(mesh_path)
    if len(mesh.vertices) == 0:
        print("[final-eval] no surface found", flush=True)
        return {"chamfer_l1": None, "num_vertices": 0, "seconds": seconds}
    verts = np.asarray(mesh.vertices)
    m = chamfer_l1_to_gt(verts) if gt == "dtu-like" else chamfer_l1_to_sphere(verts, radius=0.5)
    seconds["judge"] = time.perf_counter() - t1
    print(f"[final-eval] geometry: verts={len(mesh.vertices)} chamfer_l1={m['chamfer_l1']:.4f} "
          f"(res={resolution}, {time.perf_counter() - t0:.1f}s)", flush=True)
    return {
        "chamfer_l1": float(m["chamfer_l1"]),
        "chamfer_accuracy": float(m["accuracy"]),
        "chamfer_completeness": float(m["completeness"]),
        "mc_resolution": resolution,
        "num_vertices": int(len(mesh.vertices)),
        "seconds": seconds,
    }


def run_final_eval(trainer, method_name: str, reached_step: int) -> Tuple[Dict, Dict]:
    """The protocol's evaluation at the trained step, by the trainer's
    ``final_eval_*`` settings (final_eval.py:169-198): writes
    ``final_eval_output`` in ``parity_metrics.json``'s schema (``method``,
    ``iters``, ``psnr``, ``ssim``, ``num_images``, ``chamfer_l1``,
    ``chamfer_accuracy``, ``chamfer_completeness``, ``mc_resolution``,
    ``eval_seconds``, ``eval_backend``, ``source``) and returns (that record,
    the details of ``eval_all_images`` and ``eval_geometry``)."""
    cfg = trainer.config
    t0 = time.time()
    images = eval_all_images(trainer, max_images=cfg.final_eval_max_images)
    geometry = eval_geometry(trainer, gt=cfg.final_eval_gt, resolution=cfg.final_eval_resolution,
                             mesh_path=Path(cfg.final_eval_mesh) if cfg.final_eval_mesh else None)
    rec = {"method": method_name, "iters": reached_step}
    rec.update({k: images[k] for k in ("psnr", "ssim", "num_images")})
    rec.update({k: geometry.get(k) for k in ("chamfer_l1", "chamfer_accuracy",
                                             "chamfer_completeness", "mc_resolution")})
    rec["eval_seconds"] = round(time.time() - t0, 1)
    rec["eval_backend"] = next(trainer.model.parameters()).device.type
    rec["source"] = "trainer-final-eval"
    output = Path(cfg.final_eval_output)
    output.parent.mkdir(parents=True, exist_ok=True)
    output.write_text(json.dumps(rec, indent=2))
    print(f"[final-eval] {json.dumps(rec)}", flush=True)
    return rec, {"images": images, "geometry": geometry}
