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
a batch from one reference image and hands its source views along. The
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


def _stack(arrays, what: str) -> np.ndarray:
    if len({a.shape for a in arrays}) != 1:
        raise NotImplementedError(f"{what} of different sizes are not ported (_pad_stack)")
    return np.stack(arrays)


def stack_images(outputs: DataparserOutputs) -> Dict[str, np.ndarray]:
    """Host stacks as datamanager.py:128-152 builds them: images [N, H, W,
    3] (RGBA composited over the parser's ``alpha_color``, white without
    one), and the parser's cues where it read
    them: ``depth`` and ``sensor_depth`` [N, H, W], ``normal`` [N, H, W, 3],
    ``fg_mask`` [N, H, W, 1]."""
    bg = outputs.alpha_color if outputs.alpha_color is not None else np.ones(3, np.float32)

    def load(f):
        img = load_image(f)
        if img.shape[-1] == 4:
            img = img[..., :3] * img[..., 3:] + bg * (1.0 - img[..., 3:])
        return img[..., :3]

    data = {"image": _stack([load(f) for f in outputs.image_filenames], "images")}
    for key, cues in (("depth", outputs.depths), ("normal", outputs.normals),
                      ("sensor_depth", outputs.sensor_depths), ("fg_mask", outputs.fg_masks)):
        if cues:
            data[key] = _stack(list(cues), key)
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

        def on_device(outputs):
            return {k: torch.from_numpy(v).to(self.device) for k, v in stack_images(outputs).items()}

        self.train_cameras = train_outputs.cameras.to(self.device)
        self.train_data = on_device(train_outputs)
        self.num_train_images, self.image_height, self.image_width = self.train_data["image"].shape[:3]
        if eval_outputs is not None and eval_outputs.image_filenames == train_outputs.image_filenames:
            eval_outputs = None  # the eval split is the training views: share their tensors
        self.eval_cameras = eval_outputs.cameras.to(self.device) if eval_outputs is not None else None
        self.eval_data = on_device(eval_outputs) if eval_outputs is not None else None
        self.camera_optimizer = CameraOptimizer(self.num_train_images,
                                                config.camera_optimizer).to(self.device)

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
