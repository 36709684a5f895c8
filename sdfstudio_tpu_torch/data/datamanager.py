"""Data manager with the image stack resident on the device (counterpart of
``sdfstudio_tpu/data/datamanager.py::VanillaDataManager``).

Every training image is decoded once, stacked and moved to the device
(datamanager.py:128-152); a training batch is a uniform draw of
(camera, y, x) from a ``torch.Generator`` on that device, gathered there
(datamanager.py:190-234), and rays are generated at the pixel centres
(datamanager.py:236-253). The eval split's images and cameras sit on the
device beside them (datamanager.py:255-275); without an eval split, or
with one of the same frames (the parser's default), the training images and
cameras serve. The camera optimizer is not ported:
``neus-facto-tpu-p8`` sets ``mode="off"`` (ROADMAP queue 1 item 12).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from sdfstudio_tpu_torch.core.rays import RayBundle
from sdfstudio_tpu_torch.data.dataparsers.sdfstudio import DataparserOutputs
from sdfstudio_tpu_torch.data.png import load_image
from sdfstudio_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataManagerConfig:
    """The fields of ``DataManagerConfig`` (datamanager.py:29-44) this port reads."""

    train_num_rays_per_batch: int = 1024


def stack_images(outputs: DataparserOutputs) -> Dict[str, np.ndarray]:
    """Host image stack [N, H, W, 3] as datamanager.py:128-152 builds it:
    RGBA composited over white."""
    def load(f):
        img = load_image(f)
        if img.shape[-1] == 4:
            img = img[..., :3] * img[..., 3:] + np.ones(3, np.float32) * (1.0 - img[..., 3:])
        return img[..., :3]

    images = [load(f) for f in outputs.image_filenames]
    if len({im.shape for im in images}) != 1:
        raise NotImplementedError("images of different sizes are not ported (_pad_stack)")
    return {"image": np.stack(images)}


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

        def on_device(outputs):
            return {k: torch.from_numpy(v).to(self.device) for k, v in stack_images(outputs).items()}

        self.train_cameras = train_outputs.cameras.to(self.device)
        self.train_data = on_device(train_outputs)
        self.num_train_images, self.image_height, self.image_width = self.train_data["image"].shape[:3]
        if eval_outputs is not None and eval_outputs.image_filenames == train_outputs.image_filenames:
            eval_outputs = None  # the eval split is the training views: share their tensors
        self.eval_cameras = eval_outputs.cameras.to(self.device) if eval_outputs is not None else None
        self.eval_data = on_device(eval_outputs) if eval_outputs is not None else None

    def sample_train_batch(
        self, generator: torch.Generator, num_rays: Optional[int] = None
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Uniform (camera, y, x) indices [R, 3] and the pixels there; R is
        ``num_rays``, by default ``train_num_rays_per_batch``."""
        R = num_rays or self.config.train_num_rays_per_batch
        kw = dict(generator=generator, device=self.device)
        cam = torch.randint(0, self.num_train_images, (R,), **kw)
        y = torch.randint(0, self.image_height, (R,), **kw)
        x = torch.randint(0, self.image_width, (R,), **kw)
        batch = {k: v[cam, y, x] for k, v in self.train_data.items()}
        return torch.stack([cam, y, x], dim=-1), batch

    def generate_rays(self, ray_indices: torch.Tensor) -> RayBundle:
        """(cam, y, x) -> rays through the pixel centres."""
        coords = ray_indices[:, 1:].to(torch.float32) + 0.5
        return self.train_cameras.generate_rays(ray_indices[:, 0], coords)

    def eval_image_data(self, image_index: int) -> Dict[str, torch.Tensor]:
        """Eval image ``image_index``'s tensors, [H, W, C] each."""
        data = self.eval_data if self.eval_data is not None else self.train_data
        return {k: v[image_index] for k, v in data.items()}

    def eval_image_rays(self, image_index: int) -> RayBundle:
        cams = self.eval_cameras if self.eval_cameras is not None else self.train_cameras
        return cams.generate_image_rays(image_index)

    @property
    def num_eval_images(self) -> int:
        data = self.eval_data if self.eval_data is not None else self.train_data
        return data["image"].shape[0]
