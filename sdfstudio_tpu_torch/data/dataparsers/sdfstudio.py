"""SDFStudio-format dataparser (counterpart of
``sdfstudio_tpu/data/dataparsers/sdfstudio.py``): ``meta_data.json`` with
``scene_box`` and per-frame ``rgb_path`` / ``camtoworld`` / ``intrinsics``.

Ported: what the parity protocol's training of ``neus-facto-tpu-p8`` reads
(sdfstudio.py:53-182 with the parser's defaults: every frame, no masks, no
priors, poses as given). The other options of the JAX parser (mono
priors, sensor depth, foreground masks, SfM points, pairs, validation
splits, pose re-orientation and re-scaling) are not ported.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List

import numpy as np

from sdfstudio_tpu_torch.cameras.cameras import Cameras
from sdfstudio_tpu_torch.core.scene_box import SceneBox


@dataclasses.dataclass
class DataparserOutputs:
    """Parsed dataset on the host (base.py:19-34): cameras on the CPU."""

    image_filenames: List[Path]
    cameras: Cameras
    scene_box: SceneBox


def parse(data: Path) -> DataparserOutputs:
    """The frames of ``data/meta_data.json``, its scene box and its cameras."""
    data = Path(data)
    meta_path = data / "meta_data.json"
    if not meta_path.is_file():
        raise FileNotFoundError(f"no meta_data.json under {data}")
    meta = json.loads(meta_path.read_text())
    if meta.get("camera_model", "OPENCV") != "OPENCV":
        raise NotImplementedError(f"camera model {meta['camera_model']} is not ported")
    frames = meta["frames"]
    intr = np.stack([np.asarray(f["intrinsics"], np.float32) for f in frames])
    c2ws = np.stack([np.asarray(f["camtoworld"], np.float32) for f in frames])
    # OpenCV -> nerfstudio camera convention (sdfstudio.py:120-121)
    c2ws[:, 0:3, 1:3] *= -1
    msb = meta["scene_box"]
    scene_box = SceneBox(
        aabb=np.asarray(msb["aabb"], np.float32),
        near=msb["near"],
        far=msb["far"],
        radius=msb["radius"],
        collider_type=msb["collider_type"],
    )
    cameras = Cameras.create(
        camera_to_worlds=c2ws[:, :3, :4],
        fx=intr[:, 0, 0],
        fy=intr[:, 1, 1],
        cx=intr[:, 0, 2],
        cy=intr[:, 1, 2],
        width=meta["width"],
        height=meta["height"],
        device="cpu",
    )
    return DataparserOutputs([data / f["rgb_path"] for f in frames], cameras, scene_box)
