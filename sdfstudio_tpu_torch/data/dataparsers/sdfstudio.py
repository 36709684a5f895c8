"""SDFStudio-format dataparser (counterpart of
``sdfstudio_tpu/data/dataparsers/sdfstudio.py``): ``meta_data.json`` with
``scene_box`` and per-frame ``rgb_path`` / ``camtoworld`` / ``intrinsics``.

Ported: what the parity protocol's training and evaluation of
``neus-facto-tpu-p8`` read (sdfstudio.py:53-182 with the parser's defaults:
no masks, no priors, poses as given) and the train / eval split of
sdfstudio.py:53-62 (``skip_every_for_val_split``, ``train_val_no_overlap``).
With the defaults both splits hold every frame: the eval split is the
training views, as in the reference (and ``PARITY.json``'s ``holdout`` 0).
The other options of the JAX parser (mono priors, sensor depth, foreground
masks, SfM points, pairs, pose re-orientation and re-scaling) are not
ported; ``SDFStudioDataParserConfig`` carries all of JAX's options
(sdfstudio.py:29-47) for the command line's ``sdfstudio-data`` flags, and
``parse_config`` raises on any of those set away from its default.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List, Optional

import numpy as np

from sdfstudio_tpu_torch.cameras.cameras import Cameras
from sdfstudio_tpu_torch.core.scene_box import SceneBox


@dataclasses.dataclass
class DataparserOutputs:
    """Parsed dataset on the host (base.py:19-34): cameras on the CPU."""

    image_filenames: List[Path]
    cameras: Cameras
    scene_box: SceneBox


@dataclasses.dataclass(frozen=True)
class SDFStudioDataParserConfig:
    """JAX's ``SDFStudioDataParserConfig`` (sdfstudio.py:29-47), its fields
    and defaults. The port reads ``data``, ``skip_every_for_val_split`` and
    ``train_val_no_overlap``; ``PORTED`` lists them."""

    data: Path = Path("data/DTU/scan65")
    include_mono_prior: bool = False
    include_sensor_depth: bool = False
    include_foreground_mask: bool = False
    include_sfm_points: bool = False
    scale_factor: float = 1.0
    orientation_method: str = "up"
    center_poses: bool = False
    auto_scale_poses: bool = False
    load_pairs: bool = False
    neighbors_num: Optional[int] = None
    neighbors_shuffle: bool = False
    pairs_sorted_ascending: bool = True
    skip_every_for_val_split: int = 1
    train_val_no_overlap: bool = False
    auto_orient: bool = False


PORTED = ("data", "skip_every_for_val_split", "train_val_no_overlap")


def parse_config(config: SDFStudioDataParserConfig, split: str = "train") -> DataparserOutputs:
    """``parse`` with the options of ``config``; an option the port does
    not read, set away from its default, raises (ROADMAP queue 1 item 12:
    priors, masks, pairs and pose re-orientation come with the mono-* and
    geo-* methods)."""
    default = SDFStudioDataParserConfig()
    off = [f.name for f in dataclasses.fields(config)
           if f.name not in PORTED and getattr(config, f.name) != getattr(default, f.name)]
    if off:
        raise NotImplementedError(f"sdfstudio-data options {off} are not ported (ROADMAP queue 1 "
                                  "item 12)")
    return parse(Path(config.data), split, config.skip_every_for_val_split,
                 config.train_val_no_overlap)


def split_indices(num_frames: int, split: str, skip_every_for_val_split: int = 1,
                  train_val_no_overlap: bool = False) -> List[int]:
    """The frames of ``split`` (sdfstudio.py:56-60): an eval split takes
    every ``skip_every_for_val_split``-th frame; the train split takes them
    all, or with ``train_val_no_overlap`` all but those."""
    indices = list(range(num_frames))
    if split != "train" and skip_every_for_val_split >= 1:
        indices = indices[::skip_every_for_val_split]
    elif train_val_no_overlap:
        indices = [i for i in indices if i % skip_every_for_val_split != 0]
    return indices


def parse(data: Path, split: str = "train", skip_every_for_val_split: int = 1,
          train_val_no_overlap: bool = False) -> DataparserOutputs:
    """The frames of ``split`` in ``data/meta_data.json``, its scene box and
    their cameras."""
    data = Path(data)
    meta_path = data / "meta_data.json"
    if not meta_path.is_file():
        raise FileNotFoundError(f"no meta_data.json under {data}")
    meta = json.loads(meta_path.read_text())
    if meta.get("camera_model", "OPENCV") != "OPENCV":
        raise NotImplementedError(f"camera model {meta['camera_model']} is not ported")
    sel = split_indices(len(meta["frames"]), split, skip_every_for_val_split, train_val_no_overlap)
    frames = [meta["frames"][i] for i in sel]
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
