"""The nerfstudio-format parser (counterpart of
``sdfstudio_tpu/data/dataparsers/nerfstudio_parser.py``): ``transforms.json``
with one ``file_path`` and ``transform_matrix`` a frame.

- Intrinsics (``fl_x``, ``fl_y``, ``cx``, ``cy``, ``w``, ``h``) and
  distortion (``k1``-``k4``, ``p1``, ``p2``; 0 where absent) are read from
  the frame, or from the file's top level where the frame has none (:49-73).
- A frame's file that does not exist under ``data`` is looked for under
  ``data/images/`` by its name (:52-54).
- The poses are oriented and centred over every frame
  (``auto_orient_and_center_poses``) and scaled by the largest absolute
  translation (``auto_scale_poses``) times ``scale_factor`` (:82-90).
- The train split is ``ceil(n * train_split_percentage)`` frames spread by
  ``linspace``, the eval split the rest, and every frame where that is
  empty (:75-81).
- The scene box is ``[-scene_scale, scene_scale]^3`` under the
  ``near_far`` collider at 0.05 and 1000; the camera model is
  ``camera_model`` through ``CAMERA_MODEL_TO_TYPE`` (perspective where the
  name is unknown, OPENCV where absent).
- ``downscale_factor`` is carried and read by no code, as in JAX.
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Optional

import numpy as np

from sdfstudio_tpu_torch.cameras.camera_utils import (auto_orient_and_center_poses,
                                                      get_distortion_params)
from sdfstudio_tpu_torch.cameras.cameras import CAMERA_MODEL_TO_TYPE, Cameras, CameraType
from sdfstudio_tpu_torch.core.scene_box import SceneBox
from sdfstudio_tpu_torch.data.dataparsers.sdfstudio import DataparserOutputs


@dataclasses.dataclass(frozen=True)
class NerfstudioDataParserConfig:
    """nerfstudio_parser.py:28-37."""

    data: Path = Path("data/nerfstudio/poster")
    scale_factor: float = 1.0
    downscale_factor: Optional[int] = None
    scene_scale: float = 1.0
    orientation_method: str = "up"  # up | pca | none
    center_poses: bool = True
    auto_scale_poses: bool = True
    train_split_percentage: float = 0.9


def parse_nerfstudio(config: NerfstudioDataParserConfig, split: str = "train") -> DataparserOutputs:
    """The split's frames of ``transforms.json`` (nerfstudio_parser.py:43-124)."""
    cfg = config
    data = Path(cfg.data)
    meta = json.loads((data / "transforms.json").read_text())
    files, poses = [], []
    fx, fy, cx, cy, height, width, distort = [], [], [], [], [], [], []

    def get(frame, key):
        return frame.get(key, meta.get(key))

    for frame in meta["frames"]:
        fname = data / Path(frame["file_path"])
        fallback = data / "images" / Path(frame["file_path"]).name
        if not fname.exists() and fallback.exists():
            fname = fallback
        files.append(fname)
        poses.append(np.asarray(frame["transform_matrix"], np.float32))
        fx.append(float(get(frame, "fl_x")))
        fy.append(float(get(frame, "fl_y")))
        cx.append(float(get(frame, "cx")))
        cy.append(float(get(frame, "cy")))
        height.append(int(get(frame, "h")))
        width.append(int(get(frame, "w")))
        distort.append(get_distortion_params(**{k: float(get(frame, k) or 0)
                                                for k in ("k1", "k2", "k3", "k4", "p1", "p2")}))

    n = len(files)
    i_all = np.arange(n)
    i_train = np.linspace(0, n - 1, math.ceil(n * cfg.train_split_percentage), dtype=int)
    i_eval = np.setdiff1d(i_all, i_train)
    indices = i_train if split == "train" else i_eval
    if len(indices) == 0:
        indices = i_all

    oriented, transform = auto_orient_and_center_poses(np.stack(poses), method=cfg.orientation_method,
                                                       center_poses=cfg.center_poses)
    scale = 1.0
    if cfg.auto_scale_poses:
        scale /= float(np.max(np.abs(oriented[:, :3, 3])))
    scale *= cfg.scale_factor
    oriented[:, :3, 3] *= scale

    s = cfg.scene_scale
    scene_box = SceneBox(aabb=np.asarray([[-s] * 3, [s] * 3], np.float32), near=0.05, far=1000.0,
                         collider_type="near_far")
    cam_type = CAMERA_MODEL_TO_TYPE.get(meta.get("camera_model", "OPENCV"), CameraType.PERSPECTIVE)
    sel = np.asarray(indices)
    cameras = Cameras.create(
        camera_to_worlds=oriented[sel, :3, :4], fx=np.asarray(fx, np.float32)[sel],
        fy=np.asarray(fy, np.float32)[sel], cx=np.asarray(cx, np.float32)[sel],
        cy=np.asarray(cy, np.float32)[sel], width=np.asarray(width, np.int32)[sel],
        height=np.asarray(height, np.int32)[sel], distortion_params=np.stack(distort)[sel],
        camera_type=cam_type, device="cpu")
    return DataparserOutputs([files[i] for i in indices], cameras, scene_box,
                             metadata={"transform": transform, "scale_factor": scale})
