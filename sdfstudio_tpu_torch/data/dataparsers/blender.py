"""The Blender-synthetic parser (counterpart of
``sdfstudio_tpu/data/dataparsers/blender.py``): ``transforms_{split}.json``
with ``camera_angle_x`` and one ``transform_matrix`` a frame.

The poses are OpenGL's (x right, y up, z back), which the port's cameras
take as they are; their translations are scaled by ``scale_factor``. The
focal length is ``0.5 W / tan(0.5 camera_angle_x)`` at the first image's
size, read with the port's PNG reader; the principal point is the image
centre. The scene box is [-1.5, 1.5]^3 with the ``near_far`` collider at
2 and 6, and the RGBA images are composited over ``alpha_color`` (white or
black). A split without its ``transforms_<split>.json`` raises
``FileNotFoundError``, which ``engine/setup.py`` takes as no eval split,
as JAX's setup does.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from sdfstudio_tpu_torch.cameras.cameras import Cameras
from sdfstudio_tpu_torch.core.scene_box import SceneBox
from sdfstudio_tpu_torch.data.dataparsers.sdfstudio import DataparserOutputs
from sdfstudio_tpu_torch.data.png import read_png


@dataclasses.dataclass(frozen=True)
class BlenderDataParserConfig:
    """blender.py:24-28."""

    data: Path = Path("data/blender/lego")
    scale_factor: float = 1.0
    alpha_color: str = "white"


def parse_blender(config: BlenderDataParserConfig, split: str = "train") -> DataparserOutputs:
    """The split's frames (blender.py:34-82)."""
    data = Path(config.data)
    meta = json.loads((data / f"transforms_{split}.json").read_text())
    files, poses = [], []
    for frame in meta["frames"]:
        files.append(data / Path(frame["file_path"].replace("./", "") + ".png"))
        poses.append(np.asarray(frame["transform_matrix"], np.float32))
    poses = np.stack(poses)
    poses[:, :3, 3] *= config.scale_factor
    height, width = read_png(files[0]).shape[:2]
    focal = 0.5 * width / np.tan(0.5 * float(meta["camera_angle_x"]))
    cameras = Cameras.create(camera_to_worlds=poses[:, :3, :4], fx=focal, fy=focal,
                             cx=width / 2.0, cy=height / 2.0, width=width, height=height,
                             device="cpu")
    scene_box = SceneBox(aabb=np.asarray([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]], np.float32),
                         near=2.0, far=6.0, collider_type="near_far")
    alpha = np.ones(3, np.float32) if config.alpha_color == "white" else np.zeros(3, np.float32)
    return DataparserOutputs(files, cameras, scene_box, alpha_color=alpha,
                             metadata={"height": height, "width": width})
