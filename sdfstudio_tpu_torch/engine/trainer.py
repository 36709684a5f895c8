"""Trainer (counterpart of ``sdfstudio_tpu/engine/trainer.py``): the training
step of ``_train_step_impl`` (trainer.py:309-436), the loop around it
(``train``, ``_train_windows``, trainer.py:574-742), the in-loop eval image
(``eval_image_metrics``, :550-571), checkpoints and the final evaluation.

One step: the schedules at the step before it increments, a uniform pixel
batch from the device-resident image stack, rays, the model forward with
jitter from the trainer's ``torch.Generator``, the loss dict and its sum,
the gradient of every parameter group, and each group's Adam. On a frozen
proposal step (``train_proposal`` False) the proposal nets get zero
gradients, their Adam moments decay and count advances, and their
parameters stay as they are (trainer.py:403-418). With
``accumulate_grad_steps = A`` the step draws ``A x R`` rays and runs them
as ``A`` sub-batches in order, each from the same generator state (JAX's
scan hands every sub-batch the same ``rng_model``), then averages the
gradients and the loss and reports the last sub-batch's loss dict
(trainer.py:329-401).

The loop keeps JAX's cadences, each a crossing of a multiple in the
window just run (``crossed``): every ``steps_per_log`` the last step's
metrics vector is read back and goes to the writer with the iteration
time, the rays a second and each group's learning rate, and a row is
printed; every ``steps_per_eval_image`` one eval image,
``np.random.RandomState(step).randint(num_eval_images)``, is rendered and
scored (PSNR, SSIM, and LPIPS when ``SST_LPIPS_WEIGHTS`` names a weights
file); every ``steps_per_save`` and at the end a checkpoint. A ctrl+c
stops the loop at the last completed step and checkpoints it
(trainer.py:650-666). ``defer_heavy_ops`` defers both to the end of the
run: one checkpoint and one eval image. A run that reaches
``max_num_iterations`` with ``final_eval_gt`` and ``final_eval_output``
set ends with the final evaluation in the same process (trainer.py:632-647).
``steps_per_eval_batch`` and ``steps_per_eval_all_images`` are carried and
not read, as in JAX's loop; ``steps_per_call`` (a K-step ``lax.scan`` on
the TPU) is taken and has no effect here: its counterpart is CUDA-graph
capture (ROADMAP queue 1 item 17).

Checkpoints (trainer.py:736-805) lie as JAX lays them out,
``<base_dir>/sdfstudio_models/step-{step:09d}/`` with ``step.txt`` written
last; the port's own format is one ``torch.save`` file holding the model's
``state_dict``, every group's Adam state, the step and the generator's
state, so a resumed run takes the same steps as a straight one. The loader
also reads a JAX packed checkpoint (``packed.npz``) through
``utils/convert.py::load_jax_checkpoint``; JAX's PRNG key has no
counterpart, so the generator then keeps its seed.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from sdfstudio_tpu_torch.data.datamanager import VanillaDataManager
from sdfstudio_tpu_torch.engine.final_eval import render_image, run_final_eval, set_fp32_precision
from sdfstudio_tpu_torch.engine.optimizers import GroupAdam, OptimizerGroupConfig, build_optimizers
from sdfstudio_tpu_torch.samplers.spaced import Rng
from sdfstudio_tpu_torch.utils import writer as writer_lib
from sdfstudio_tpu_torch.utils.convert import load_jax_checkpoint
from sdfstudio_tpu_torch.utils.metrics import lpips, lpips_metric_name, psnr, ssim

PROPOSAL_GROUP = "proposal_networks"
SEED = 42  # the batch and jitter generator's seed (trainer.py:162, PRNGKey(42))
CHECKPOINT_FILE = "checkpoint.pt"  # the port's format, in a step directory


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """JAX's ``TrainerConfig`` (trainer.py:37-107): every field, with JAX's
    defaults. ``dynamic_batch`` (``instant-ngp``'s power-of-two ray buckets,
    ROADMAP queue 1 item 12) and ``mixed_precision`` (every registered
    surface method trains in f32) raise when set; ``target_num_samples`` and
    ``dynamic_update_every`` belong to the first. The final evaluation's
    judges are ``"dtu-like"`` and ``"sphere"`` (``"heritage-like"`` comes
    with ``neusW``)."""

    steps_per_save: int = 1000
    steps_per_eval_batch: int = 500
    steps_per_eval_image: int = 500
    steps_per_eval_all_images: int = 1000000
    max_num_iterations: int = 1000000
    steps_per_log: int = 10
    mixed_precision: bool = False
    save_only_latest_checkpoint: bool = True
    load_dir: Optional[Path] = None
    load_step: Optional[int] = None
    accumulate_grad_steps: int = 1
    defer_heavy_ops: bool = False
    dynamic_batch: bool = False
    target_num_samples: int = 1 << 18
    dynamic_update_every: int = 50
    steps_per_call: int = 0
    final_eval_gt: str = ""
    final_eval_output: str = ""
    final_eval_resolution: int = 256
    final_eval_mesh: str = ""
    final_eval_max_images: int = 0


def crossed(cadence: int, lo: int, hi: int) -> bool:
    """Does (lo, hi] hold a multiple of ``cadence`` (trainer.py:602-604)?"""
    return cadence > 0 and hi // cadence > lo // cadence


def eval_image_index(step: int, num_eval_images: int) -> int:
    """The eval image the loop scores at ``step`` (trainer.py:733)."""
    return int(np.random.RandomState(step).randint(num_eval_images))


def loss_and_metrics(
    model, ray_bundle, batch: Dict[str, torch.Tensor], sched: Dict, rng: Rng = None
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """``loss_fn`` of trainer.py:352-364: (total loss, loss dict, metrics)."""
    outputs = model.get_outputs(ray_bundle, sched=sched, train=True, rng=rng)
    loss_dict = model.get_loss_dict(outputs, batch, sched, rng)
    total = sum(loss_dict.values())
    return total, loss_dict, model.get_metrics_dict(outputs, batch)


def group_grads(
    total: torch.Tensor, optimizers: Dict[str, GroupAdam]
) -> Dict[str, List[Optional[torch.Tensor]]]:
    """d total / d params for every group; None where a parameter took no
    part (a frozen proposal step, the unused appearance embedding)."""
    names = list(optimizers)
    flat = [p for n in names for p in optimizers[n].params]
    grads = torch.autograd.grad(total, flat, allow_unused=True)
    out, i = {}, 0
    for n in names:
        k = len(optimizers[n].params)
        out[n] = list(grads[i:i + k])
        i += k
    return out


def _add(a: Optional[torch.Tensor], b: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Two sub-batches' gradients of a parameter; None (no part in the
    loss) counts as zero."""
    return b if a is None else a if b is None else a + b


def apply_grads(
    optimizers: Dict[str, GroupAdam], grads: Dict[str, List[Optional[torch.Tensor]]], sched: Dict
) -> None:
    """Every group's Adam step (trainer.py:403-418). A None gradient counts
    as zero; on a frozen proposal step (``train_proposal`` False) the
    proposal group's moments and count advance and its parameters stay."""
    frozen = not sched.get("train_proposal", True)
    for name, opt in optimizers.items():
        opt.step(grads[name], apply=not (frozen and name == PROPOSAL_GROUP))


class Trainer:
    """Owns the model's optimizers, the step count, the batch generator, the
    writer and the checkpoints under ``base_dir`` (none are written without
    one)."""

    def __init__(
        self,
        config: TrainerConfig,
        model: torch.nn.Module,
        datamanager: VanillaDataManager,
        optimizer_groups: Dict[str, OptimizerGroupConfig],
        base_dir: Optional[Path] = None,
        method_name: str = "",
        writer: Optional[writer_lib.Writer] = None,
        seed: int = SEED,
    ):
        if config.dynamic_batch:
            raise NotImplementedError("dynamic_batch=True is not ported (ROADMAP queue 1 item 12, "
                                      "with instant-ngp)")
        if config.mixed_precision:
            raise NotImplementedError("mixed_precision=True is not ported: the port trains in f32")
        self.config = config
        self.model = model
        self.datamanager = datamanager
        self.optimizer_groups = optimizer_groups
        self.base_dir = Path(base_dir) if base_dir is not None else None
        self.ckpt_dir = self.base_dir / "sdfstudio_models" if base_dir is not None else None
        self.method_name = method_name
        self.writer = writer or writer_lib.Writer(self.base_dir)
        self.seed = seed
        self.optimizers: Dict[str, GroupAdam] = {}
        self.step = 0
        self.generator: Optional[torch.Generator] = None
        self.metric_keys: Sequence[str] = ()
        self.eval_history: List[Dict] = []  # the loop's eval images: step, image, metrics, seconds
        self.interrupted_step: Optional[int] = None

    def setup(self) -> None:
        set_fp32_precision()
        self.optimizers = build_optimizers(self.optimizer_groups, self.model)
        self.generator = torch.Generator(device=self.datamanager.device).manual_seed(self.seed)
        self.step = 0
        if self.config.load_dir is not None:
            self.load_checkpoint(self.config.load_dir, self.config.load_step)

    def train_step(self) -> torch.Tensor:
        """One step; returns its metrics as one device vector (``metric_keys``)."""
        model, dm, gen = self.model, self.datamanager, self.generator
        sched = model.schedules(self.step)
        accum = max(self.config.accumulate_grad_steps, 1)
        R = dm.config.train_num_rays_per_batch
        with record_function("sst/train_batch"):
            ray_indices, batch = dm.sample_train_batch(gen, num_rays=R * accum)
        if accum == 1:
            with record_function("sst/train_forward"):
                total, loss_dict, metrics = loss_and_metrics(
                    model, dm.generate_rays(ray_indices), batch, sched, gen)
            with record_function("sst/train_backward"):
                grads = group_grads(total, self.optimizers)
        else:
            # the sub-batches in order, each from the same generator state
            state, grads, total = gen.get_state(), None, 0.0
            for a in range(accum):
                gen.set_state(state)
                sl = slice(a * R, (a + 1) * R)
                with record_function("sst/train_forward"):
                    sub, loss_dict, metrics = loss_and_metrics(
                        model, dm.generate_rays(ray_indices[sl]), {k: v[sl] for k, v in batch.items()},
                        sched, gen)
                with record_function("sst/train_backward"):
                    g = group_grads(sub, self.optimizers)
                grads = g if grads is None else {n: [_add(x, y) for x, y in zip(grads[n], g[n])]
                                                 for n in grads}
                total = total + sub.detach()
            grads = {n: [None if x is None else x / accum for x in gs] for n, gs in grads.items()}
            total = total / accum
        with record_function("sst/train_optimizer"):
            apply_grads(self.optimizers, grads, sched)
        self.step += 1
        out = {"loss": total.detach(), **{k: v.detach() for k, v in loss_dict.items()}, **metrics}
        self.metric_keys = sorted(out)
        return torch.stack([out[k].reshape(()).to(torch.float32) for k in self.metric_keys])

    @torch.no_grad()
    def eval_image_metrics(self, camera_index: int) -> Dict[str, float]:
        """PSNR and SSIM of one eval image rendered at the trained step, and
        LPIPS under its metric name when ``SST_LPIPS_WEIGHTS`` is set
        (trainer.py:550-571)."""
        dm = self.datamanager
        cams = dm.eval_cameras if dm.eval_cameras is not None else dm.train_cameras
        rgb = render_image(self.model, cams, camera_index, step=float(self.step))["rgb"]
        gt = dm.eval_image_data(camera_index)["image"][..., :3]
        m = {"psnr": float(psnr(rgb, gt)), "ssim": float(ssim(rgb, gt))}
        lp = lpips(rgb, gt)
        if lp is not None:
            m[lpips_metric_name(os.environ["SST_LPIPS_WEIGHTS"])] = float(lp)
        return m

    def _eval_image(self, step: int, log_step: int, label: str) -> Dict[str, float]:
        idx = eval_image_index(step, self.datamanager.num_eval_images)
        t0 = time.perf_counter()
        m = self.eval_image_metrics(idx)
        seconds = time.perf_counter() - t0
        self.writer.put_dict(m, log_step, prefix="eval/")
        self.eval_history.append({"step": step, "image": idx, **m, "seconds": seconds})
        print(f"[{label} {idx}] psnr={m['psnr']:.2f} ssim={m['ssim']:.4f} ({seconds:.2f} s)",
              flush=True)
        return m

    def train(self, num_iterations: Optional[int] = None) -> Dict[str, float]:
        """Run to ``num_iterations`` (default ``max_num_iterations``) steps
        with JAX's cadences (trainer.py:574-666); then, at
        ``max_num_iterations``, the final evaluation if ``final_eval_gt`` and
        ``final_eval_output`` are set. Returns the last metrics row read."""
        cfg = self.config
        max_iters = num_iterations or cfg.max_num_iterations
        start = self.step
        self.interrupted_step = None
        last: Dict[str, float] = {}
        try:
            self._train_windows(max_iters, last)
        except KeyboardInterrupt:
            # a ctrl+c: stop at the last completed step and checkpoint it (trainer.py:650-666)
            self.interrupted_step = self.step
            print(f"[trainer] interrupted at step {self.step}; checkpointing before exit", flush=True)
            max_iters = self.step
        if max_iters > start and (cfg.defer_heavy_ops or self.interrupted_step is not None):
            if self.ckpt_dir is not None:
                self.save_checkpoint(max_iters)
            if (cfg.defer_heavy_ops and cfg.steps_per_eval_image > 0
                    and self.datamanager.num_eval_images):
                self._eval_image(max_iters, max_iters, "segment-end eval image")
        if (cfg.final_eval_gt and cfg.final_eval_output and max_iters >= cfg.max_num_iterations
                and self.interrupted_step is None):
            run_final_eval(self, self.method_name, max_iters)
        return last

    def _train_windows(self, max_iters: int, last: Dict[str, float]) -> None:
        """The loop of trainer.py:668-742, one step a window."""
        cfg, dm = self.config, self.datamanager
        window_t0, window_steps = time.perf_counter(), 0
        rays = dm.config.train_num_rays_per_batch * max(cfg.accumulate_grad_steps, 1)
        while self.step < max_iters:
            lo = self.step
            vec = self.train_step()
            step = self.step
            window_steps += 1
            if crossed(cfg.steps_per_log, lo, step) or step >= max_iters:
                # the interval's last metrics, read back once (JAX keeps the same row)
                last.clear()
                last.update(zip(self.metric_keys, vec.tolist()))
                dt = (time.perf_counter() - window_t0) / window_steps
                window_t0, window_steps = time.perf_counter(), 0
                self.writer.put_dict(last, step - 1)
                self.writer.put_scalar(writer_lib.ITER_TRAIN_TIME, dt, step - 1)
                self.writer.put_scalar(writer_lib.TRAIN_RAYS_PER_SEC, rays / dt, step - 1)
                for name, opt in self.optimizers.items():
                    self.writer.put_scalar(f"learning_rate/{name}", opt.lr_at(step - 1), step - 1)
                self.writer.print_row(step, max_iters, last)
            if not cfg.defer_heavy_ops and crossed(cfg.steps_per_eval_image, lo, step):
                self._eval_image(step, step - 1, "eval image")
            if (not cfg.defer_heavy_ops and self.ckpt_dir is not None
                    and (crossed(cfg.steps_per_save, lo, step) or step >= max_iters)):
                self.save_checkpoint(step)

    def save_checkpoint(self, step: int) -> Path:
        """Write ``step-{step:09d}/`` under ``ckpt_dir``, ``step.txt`` last;
        with ``save_only_latest_checkpoint`` the older step directories go
        (trainer.py:736-759)."""
        path = self.ckpt_dir / f"step-{step:09d}"
        path.mkdir(parents=True, exist_ok=True)
        torch.save({
            "step": step,
            "model": self.model.state_dict(),
            "optimizers": {name: opt.state() for name, opt in self.optimizers.items()},
            "generator": self.generator.get_state(),
        }, path / CHECKPOINT_FILE)
        (path / "step.txt").write_text(str(step))
        if self.config.save_only_latest_checkpoint:
            for p in sorted(self.ckpt_dir.glob("step-*")):
                if p != path:
                    shutil.rmtree(p)
        print(f"saved checkpoint {path}", flush=True)
        return path

    def load_checkpoint(self, load_dir, load_step: Optional[int] = None) -> None:
        """Resume from ``load_dir/step-{load_step:09d}/``, by default the
        newest step directory that has its ``step.txt`` (a directory without
        one is a save that did not finish; trainer.py:770-805). Reads the
        port's format or a JAX packed checkpoint."""
        load_dir = Path(load_dir)
        if load_step is None:
            steps = sorted(int(p.name.split("-")[1]) for p in load_dir.glob("step-*")
                           if (p / "step.txt").exists())
            if not steps:
                raise FileNotFoundError(f"no complete checkpoint under {load_dir}")
            load_step = steps[-1]
        path = load_dir / f"step-{load_step:09d}"
        if not (path / "step.txt").exists():
            raise FileNotFoundError(f"no complete checkpoint at {path}")
        if (path / "packed.npz").exists():
            step = load_jax_checkpoint(self.model, self.optimizers, path)
        else:
            ckpt = torch.load(path / CHECKPOINT_FILE, map_location="cpu", weights_only=True)
            if set(ckpt["optimizers"]) != set(self.optimizers):
                raise ValueError(f"{path}: optimizer groups {sorted(ckpt['optimizers'])}, "
                                 f"expected {sorted(self.optimizers)}")
            self.model.load_state_dict(ckpt["model"])
            for name, opt in self.optimizers.items():
                opt.load_state(**ckpt["optimizers"][name])
            self.generator.set_state(ckpt["generator"])
            step = ckpt["step"]
        if step != load_step:
            raise ValueError(f"{path} holds step {step}")
        self.step = step
        print(f"loaded checkpoint from {path} at step {step}", flush=True)
