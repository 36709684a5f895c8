"""Data manager with the image stack resident on the device (counterpart of
``sdfstudio_tpu/data/datamanager.py::VanillaDataManager``).

Every training image is decoded once, stacked and moved to the device
(datamanager.py:128-152); a training batch is a uniform draw of
(camera, y, x) from a ``torch.Generator`` on that device, gathered there
(datamanager.py:190-234), and rays are generated at the pixel centres
(datamanager.py:236-253). The eval split's images and cameras sit on the
device beside them (datamanager.py:255-275); without an eval split, or
with one of the same frames (the parser's default), the training images and
cameras serve. The parser's cues sit beside the images (``depth``,
``normal``, ``sensor_depth``, ``fg_mask``) and a batch gathers them too.
``FlexibleDataManager`` (datamanager.py:287-332, the Geo-NeuS methods) draws
a batch from one reference image and hands its source views along.

Images of different sizes are zero-padded to the largest H x W
(``_pad_stack``, datamanager.py:46-62); each image's own extent
(``image_heights`` / ``image_widths``) bounds a training draw
(datamanager.py:215-227: ``min(floor(u * h), h - 1)`` with ``u`` uniform),
and an eval image is cropped to ``[:h, :w]`` (:255-266). The flexible data
manager, as JAX's, draws in the padded extent (:321-322). With
``train_num_images_to_sample_from`` below the number of training images
only a subset of the stack lives on the device (the subset image cache,
datamanager.py:85-91, 154-185): the whole stack stays on the host, the
subset's images are drawn without replacement by ``np.random.default_rng(
303)``, and every ``train_num_times_to_repeat_images`` steps the trainer's
``maybe_resample(step)`` swaps in a fresh subset of the same shape. A batch
then draws a slot of the subset and reports the slot's global camera id
(``_global_ids``), because the cameras, the camera optimizer and the
extents are indexed globally. The
data manager's ``camera_optimizer`` (``cameras/camera_optimizers.py``)
corrects the training rays' poses where its mode is not ``"off"`` (the
density methods' ``SO3xR3``; datamanager.py:111-112, 236-253); eval rays
take the poses as parsed. Its ``pose_adjustment`` is trained as the
``camera_opt`` group: ``engine/setup.py`` hangs the module on the model as
``model.camera_opt``, so that the model's parameters, checkpoints and JAX
trees hold it as JAX's ``params["camera_opt"]`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from sdfstudio_tpu_torch.cameras.camera_optimizers import CameraOptimizer, CameraOptimizerConfig
from sdfstudio_tpu_torch.core.rays import RayBundle
from sdfstudio_tpu_torch.data.dataparsers.sdfstudio import DataparserOutputs
from sdfstudio_tpu_torch.data.png import load_image
from sdfstudio_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataManagerConfig:
    """The fields of ``DataManagerConfig`` (datamanager.py:29-44) this port
    reads: ``kind`` is ``vanilla`` or ``flexible`` (``engine/setup.py``
    builds the data manager it names); ``neighbors_num`` cuts a flexible
    batch's sources to that many. ``eval_num_rays_per_batch`` is carried
    and read by no code, in JAX either."""

    train_num_rays_per_batch: int = 1024
    eval_num_rays_per_batch: int = 1024
    camera_optimizer: CameraOptimizerConfig = CameraOptimizerConfig()
    kind: str = "vanilla"
    neighbors_num: Optional[int] = None
    train_num_images_to_sample_from: int = -1  # -1: every image on the device
    train_num_times_to_repeat_images: int = -1  # -1: never resample the subset


SUBSET_SEED = 303  # the subset cache's generator (datamanager.py:89)


def _pad_stack(arrays) -> np.ndarray:
    """Per-image arrays stacked, zero-padded to the largest (H, W) where
    their sizes differ (datamanager.py:46-62)."""
    arrays = [np.asarray(a) for a in arrays]
    if len({a.shape for a in arrays}) == 1:
        return np.stack(arrays)
    h = max(a.shape[0] for a in arrays)
    w = max(a.shape[1] for a in arrays)
    out = np.zeros((len(arrays), h, w) + arrays[0].shape[2:], arrays[0].dtype)
    for i, a in enumerate(arrays):
        out[i, : a.shape[0], : a.shape[1]] = a
    return out


def stack_images(outputs: DataparserOutputs) -> Dict[str, np.ndarray]:
    """Host stacks as datamanager.py:128-152 builds them, each padded to
    the largest H x W (``_pad_stack``): images [N, H, W, 3] (RGBA composited over the parser's ``alpha_color``, white without
    one), and the parser's cues where it read
    them: ``depth`` and ``sensor_depth`` [N, H, W], ``normal`` [N, H, W, 3],
    ``fg_mask`` [N, H, W, 1]."""
    bg = outputs.alpha_color if outputs.alpha_color is not None else np.ones(3, np.float32)

    def load(f):
        img = load_image(f)
        if img.shape[-1] == 4:
            img = img[..., :3] * img[..., 3:] + bg * (1.0 - img[..., 3:])
        return img[..., :3]

    data = {"image": _pad_stack([load(f) for f in outputs.image_filenames])}
    for key, cues in (("depth", outputs.depths), ("normal", outputs.normals),
                      ("sensor_depth", outputs.sensor_depths), ("fg_mask", outputs.fg_masks)):
        if cues:
            data[key] = _pad_stack(list(cues))
    return data


class VanillaDataManager:
    """Device-resident dataset tensors and the batch sampler."""

    def __init__(
        self,
        config: DataManagerConfig,
        train_outputs: DataparserOutputs,
        eval_outputs: Optional[DataparserOutputs] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.config = config
        self.device = resolve_device(device)

        def on_device(stack):
            return {k: torch.from_numpy(v).to(self.device) for k, v in stack.items()}

        self.train_cameras = train_outputs.cameras.to(self.device)
        full = stack_images(train_outputs)
        self.num_train_images, self.image_height, self.image_width = full["image"].shape[:3]
        n_sub = config.train_num_images_to_sample_from
        self.subset_mode = 0 < n_sub < self.num_train_images
        self._host_train_data = None
        if self.subset_mode:
            # the whole stack on the host, a subset of it on the device
            self._host_train_data = full
            self._subset_rng = np.random.default_rng(SUBSET_SEED)
            self._last_resample_step = 0
            self.train_data = self._make_subset()
        else:
            self.train_data = on_device(full)
        if eval_outputs is not None and eval_outputs.image_filenames == train_outputs.image_filenames:
            eval_outputs = None  # the eval split is the training views: share their tensors
        self.eval_cameras = eval_outputs.cameras.to(self.device) if eval_outputs is not None else None
        self.eval_data = on_device(stack_images(eval_outputs)) if eval_outputs is not None else None
        # each training image's own extent in the padded stack (datamanager.py:102-109)
        hs, ws = train_outputs.cameras.height.cpu(), train_outputs.cameras.width.cpu()
        self.variable_res = bool((hs != hs[0]).any() or (ws != ws[0]).any())
        self.image_heights, self.image_widths = hs.to(self.device), ws.to(self.device)
        self.camera_optimizer = CameraOptimizer(self.num_train_images,
                                                config.camera_optimizer).to(self.device)

    def _make_subset(self) -> Dict[str, torch.Tensor]:
        """A fresh subset of the host stack on the device, with its images'
        global ids as ``_global_ids`` (datamanager.py:154-169); its shapes
        never change."""
        ids = self._subset_rng.choice(self.num_train_images,
                                      size=self.config.train_num_images_to_sample_from,
                                      replace=False).astype(np.int64)
        data = {k: torch.from_numpy(v[ids]).to(self.device) for k, v in self._host_train_data.items()}
        data["_global_ids"] = torch.from_numpy(ids).to(self.device)
        return data

    def maybe_resample(self, step: int) -> None:
        """Swap in a fresh subset when ``train_num_times_to_repeat_images``
        steps have passed since the last one (datamanager.py:171-185); a
        no-op without the subset cache."""
        repeat = self.config.train_num_times_to_repeat_images
        if not self.subset_mode or repeat <= 0:
            return
        if step - self._last_resample_step >= repeat:
            self._last_resample_step = step
            self.train_data = self._make_subset()

    def sample_train_batch(
        self, generator: torch.Generator, num_rays: Optional[int] = None
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Uniform (camera, y, x) indices [R, 3] and the pixels there; R is
        ``num_rays``, by default ``train_num_rays_per_batch`` (datamanager.py:
        190-234). Images of different sizes: uniform in each drawn image's
        own extent. The subset cache: a slot of the cached subset, reported
        as its global camera id."""
        R = num_rays or self.config.train_num_rays_per_batch
        kw = dict(generator=generator, device=self.device)
        gids = self.train_data.get("_global_ids")
        if gids is not None:
            slot = torch.randint(0, gids.shape[0], (R,), **kw)
            cam = gids[slot]
        else:
            slot = cam = torch.randint(0, self.num_train_images, (R,), **kw)
        if self.variable_res:
            h, w = self.image_heights[cam], self.image_widths[cam]
            y = torch.minimum((torch.rand((R,), **kw) * h.to(torch.float32)).to(torch.int64), h - 1)
            x = torch.minimum((torch.rand((R,), **kw) * w.to(torch.float32)).to(torch.int64), w - 1)
        else:
            y = torch.randint(0, self.image_height, (R,), **kw)
            x = torch.randint(0, self.image_width, (R,), **kw)
        batch = {k: v[slot, y, x] for k, v in self.train_data.items() if k != "_global_ids"}
        return torch.stack([cam, y, x], dim=-1), batch

    def generate_rays(self, ray_indices: torch.Tensor, train: bool = True) -> RayBundle:
        """(cam, y, x) -> rays through the pixel centres of the training
        cameras, their poses corrected by the camera optimizer in training
        (datamanager.py:236-253)."""
        cam = ray_indices[:, 0]
        coords = ray_indices[:, 1:].to(torch.float32) + 0.5
        correction = None
        if train and self.config.camera_optimizer.mode != "off":
            correction = self.camera_optimizer(cam)
        return self.train_cameras.generate_rays(cam, coords, camera_opt_to_camera=correction)

    def eval_image_data(self, image_index: int) -> Dict[str, torch.Tensor]:
        """Eval image ``image_index``'s tensors, [H, W, C] each, cropped to
        the image's own size (datamanager.py:255-266); with the subset cache
        and no eval split, from the host stack."""
        cams = self.eval_cameras if self.eval_data is not None else self.train_cameras
        h, w = int(cams.height[image_index]), int(cams.width[image_index])
        if self.eval_data is not None:
            return {k: v[image_index][:h, :w] for k, v in self.eval_data.items()}
        if self.subset_mode:
            return {k: torch.from_numpy(v[image_index][:h, :w]).to(self.device)
                    for k, v in self._host_train_data.items()}
        return {k: v[image_index][:h, :w] for k, v in self.train_data.items()}

    def eval_image_rays(self, image_index: int) -> RayBundle:
        cams = self.eval_cameras if self.eval_cameras is not None else self.train_cameras
        return cams.generate_image_rays(image_index)

    @property
    def num_eval_images(self) -> int:
        if self.eval_data is not None:
            return self.eval_data["image"].shape[0]
        return self.num_train_images


class FlexibleDataManager(VanillaDataManager):
    """The patch-warping data manager (datamanager.py:287-332): a batch's
    rays all come from one reference image, and the batch carries that
    image's row of ``pairs_srcs`` (the reference, then its sources), cut to
    ``neighbors_num + 1``, with those views' images and cameras."""

    def __init__(
        self,
        config: DataManagerConfig,
        train_outputs: DataparserOutputs,
        eval_outputs: Optional[DataparserOutputs] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__(config, train_outputs, eval_outputs, device)
        if self.subset_mode:  # datamanager.py:296: the source views must stay on the device
            raise ValueError("the subset image cache does not go with the flexible data manager")
        if train_outputs.pairs_srcs is None:
            raise ValueError("the flexible data manager needs pairs.txt (sdfstudio-data "
                             "--load-pairs True)")
        pairs = np.asarray(train_outputs.pairs_srcs)
        if config.neighbors_num is not None:
            pairs = pairs[:, : config.neighbors_num + 1]
        self.pairs_srcs = torch.as_tensor(pairs, dtype=torch.int64, device=self.device)

    def sample_train_batch_flexible(
        self, generator: torch.Generator, num_rays: Optional[int] = None
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict]:
        """One uniform reference image and R uniform pixels in it
        (datamanager.py:304-332): ``flexible_batch`` of the draw."""
        R = num_rays or self.config.train_num_rays_per_batch
        kw = dict(generator=generator, device=self.device)
        ref = torch.randint(0, self.num_train_images, (), **kw)
        y = torch.randint(0, self.image_height, (R,), **kw)
        x = torch.randint(0, self.image_width, (R,), **kw)
        return self.flexible_batch(ref, y, x)

    def flexible_batch(
        self, ref: torch.Tensor, y: torch.Tensor, x: torch.Tensor
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict]:
        """(ray indices [R, 3], the pixels' batch, the additional inputs:
        ``uv`` [R, 2] as (y, x), ``src_idxs`` [1 + S], ``src_imgs`` [1 + S,
        H, W, 3], ``src_cameras``) of reference image ``ref`` (0-dim) at
        pixels (y, x)."""
        cam = ref.expand(y.shape[0])
        batch = {k: v[cam, y, x] for k, v in self.train_data.items()}
        # index_select: indexing by a 0-dim tensor would read it back to the host
        src_idxs = torch.index_select(self.pairs_srcs, 0, ref.reshape(1))[0]
        additional = {
            "uv": torch.stack([y, x], dim=-1),
            "src_idxs": src_idxs,
            "src_imgs": self.train_data["image"][src_idxs],
            "src_cameras": self.train_cameras[src_idxs],
        }
        return torch.stack([cam, y, x], dim=-1), batch, additional
