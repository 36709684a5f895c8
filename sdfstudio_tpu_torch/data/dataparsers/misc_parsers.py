"""The D-NeRF and Friends parsers (counterpart of
``sdfstudio_tpu/data/dataparsers/misc_parsers.py``, ``DNeRF`` :87-131 and
``Friends`` :202-249).

D-NeRF is the Blender layout (``transforms_{split}.json``, ``camera_angle_x``,
one ``transform_matrix`` and a ``time`` a frame, 0 where a frame has none)
with the poses' translations scaled by ``scale_factor``, the focal length
``0.5 W / tan(0.5 camera_angle_x)`` at the first image's size, the scene box
[-1.5, 1.5]^3 with the ``near_far`` collider at 2 and 6, and the RGBA
images composited over ``alpha_color``; its cameras carry the frames' times,
which their rays carry on (``RayBundle.times``), so ``dnerf``'s temporal
distortion runs.

Friends reads ``cameras.json``: each frame's ``file_path``, ``camtoworld``
(OpenCV, whose columns 1 and 2 are negated into OpenGL's) and intrinsics.
Every frame is in both splits, ``downscale_factor`` is carried and not
read, the scene box is ``[-1, 1]^3 * scene_scale`` with near 0.05 and far
20, and with ``include_semantics`` the ``metadata`` names each frame's
``segmentations/thing/<stem>.png`` where that directory exists (None
otherwise), as JAX's parser does; the data manager reads none of them, in
JAX either. Both parsers read the images' size with the port's PNG reader.
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
class DNeRFDataParserConfig:
    """misc_parsers.py:80-84."""

    data: Path = Path("data/dnerf/lego")
    scale_factor: float = 1.0
    alpha_color: str = "white"


def parse_dnerf(config: DNeRFDataParserConfig, split: str = "train") -> DataparserOutputs:
    """The split's frames with their times (misc_parsers.py:93-131)."""
    data = Path(config.data)
    meta = json.loads((data / f"transforms_{split}.json").read_text())
    files, poses, times = [], [], []
    for frame in meta["frames"]:
        files.append(data / Path(frame["file_path"].replace("./", "") + ".png"))
        poses.append(np.asarray(frame["transform_matrix"], np.float32))
        times.append(frame.get("time", 0.0))
    poses = np.stack(poses)
    poses[:, :3, 3] *= config.scale_factor
    height, width = read_png(files[0]).shape[:2]
    focal = 0.5 * width / np.tan(0.5 * float(meta["camera_angle_x"]))
    cameras = Cameras.create(camera_to_worlds=poses[:, :3, :4], fx=focal, fy=focal,
                             cx=width / 2.0, cy=height / 2.0, width=width, height=height,
                             device="cpu", times=np.asarray(times, np.float32))
    scene_box = SceneBox(aabb=np.asarray([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]], np.float32),
                         near=2.0, far=6.0, collider_type="near_far")
    alpha = np.ones(3, np.float32) if config.alpha_color == "white" else np.zeros(3, np.float32)
    return DataparserOutputs(files, cameras, scene_box, alpha_color=alpha,
                             metadata={"height": height, "width": width})


@dataclasses.dataclass(frozen=True)
class FriendsDataParserConfig:
    """misc_parsers.py:194-199."""

    data: Path = Path("data/friends/TBBT-big_living_room")
    include_semantics: bool = True
    downscale_factor: int = 4
    scene_scale: float = 2.0


def parse_friends(config: FriendsDataParserConfig, split: str = "train") -> DataparserOutputs:
    """Every frame of ``cameras.json``, whatever the split (misc_parsers.py:208-249)."""
    data = Path(config.data)
    frames = json.loads((data / "cameras.json").read_text())["frames"]
    files, poses, fx, fy, cx, cy = [], [], [], [], [], []
    for frame in frames:
        files.append(data / frame["file_path"])
        poses.append(np.asarray(frame["camtoworld"], np.float32))
        intr = np.asarray(frame["intrinsics"], np.float32)
        fx.append(intr[0, 0])
        fy.append(intr[1, 1])
        cx.append(intr[0, 2])
        cy.append(intr[1, 2])
    poses = np.stack(poses)
    poses[:, 0:3, 1:3] *= -1
    height, width = read_png(files[0]).shape[:2]
    cameras = Cameras.create(camera_to_worlds=poses[:, :3, :4], fx=np.asarray(fx), fy=np.asarray(fy),
                             cx=np.asarray(cx), cy=np.asarray(cy), width=width, height=height,
                             device="cpu")
    scene_box = SceneBox(aabb=np.asarray([[-1, -1, -1], [1, 1, 1]], np.float32) * config.scene_scale,
                         near=0.05, far=20.0, collider_type="near_far")
    semantics = None
    sem_dir = data / "segmentations" / "thing"
    if config.include_semantics and sem_dir.exists():
        semantics = [sem_dir / (Path(f).stem + ".png") for f in files]
    return DataparserOutputs(files, cameras, scene_box, metadata={"semantics": semantics})
