"""SDFStudio-format dataparser (counterpart of
``sdfstudio_tpu/data/dataparsers/sdfstudio.py``): ``meta_data.json`` with
``scene_box`` and per-frame ``rgb_path`` / ``camtoworld`` / ``intrinsics``,
and every option of JAX's parser (sdfstudio.py:29-182):

- ``include_mono_prior``: each frame's monocular depth [H, W] and normals,
  stored [3, H, W] in [0, 1], mapped to [-1, 1], normalised and rotated to
  the world by the frame's OpenCV ``camtoworld`` (before the axis flip),
  [H, W, 3] (:73-82);
- ``include_sensor_depth`` (a depth map a frame), ``include_foreground_mask``
  (channel 0 of the PNG, [H, W, 1]), ``include_sfm_points`` (``np.loadtxt``
  a frame, [P_i, 3]);
- ``auto_orient`` (``meta["orientation_override"]`` or
  ``orientation_method``, with ``center_poses``; the normals turn with the
  poses), ``auto_scale_poses`` and ``scale_factor``, over every frame before
  the split is taken;
- ``load_pairs``: ``pairs.txt``, one line a frame, ``ref src1 src2 ...``;
  with ``pairs_sorted_ascending`` each line becomes ``[ref] + arr[:1:-1]``,
  which reverses the sources and drops the first of them. That is JAX's
  line (:163-164) and the port keeps it.

``neighbors_num`` and ``neighbors_shuffle`` are carried and not read, as in
JAX's parser (the flexible data manager reads its own ``neighbors_num``). The
train / eval split is sdfstudio.py:56-60: with the defaults both splits hold
every frame. ``meta["camera_model"]`` is not read: every frame is a
perspective camera without distortion, whatever the file names, as JAX's
parser builds it (sdfstudio.py:68-153).
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from sdfstudio_tpu_torch.cameras import camera_utils
from sdfstudio_tpu_torch.cameras.cameras import Cameras
from sdfstudio_tpu_torch.core.scene_box import SceneBox
from sdfstudio_tpu_torch.data.png import load_image


@dataclasses.dataclass
class DataparserOutputs:
    """Parsed dataset on the host (base.py:19-34): cameras on the CPU, the
    cues of the split's frames in numpy (None when not read)."""

    image_filenames: List[Path]
    cameras: Cameras
    scene_box: SceneBox
    depths: Optional[List[np.ndarray]] = None  # mono depth [H, W]
    normals: Optional[List[np.ndarray]] = None  # mono normals in the world [H, W, 3]
    sensor_depths: Optional[List[np.ndarray]] = None  # [H, W]
    fg_masks: Optional[List[np.ndarray]] = None  # [H, W, 1] in [0, 1]
    sparse_sfm_points: Optional[List[np.ndarray]] = None  # [P_i, 3] a frame
    pairs_srcs: Optional[np.ndarray] = None  # [N, 1 + sources]: the patch warp's views
    metadata: Optional[Dict] = None  # the mipnerf360 parser's {transform, scale}
    alpha_color: Optional[np.ndarray] = None  # [3] the RGBA images' background; white if None


@dataclasses.dataclass(frozen=True)
class SDFStudioDataParserConfig:
    """JAX's ``SDFStudioDataParserConfig`` (sdfstudio.py:29-47), its fields
    and defaults."""

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


def _require(meta: dict, flag: str, option: str) -> None:
    """JAX asserts the scene's flag before it reads a cue (sdfstudio.py:72-99)."""
    if not meta.get(flag, False):
        raise ValueError(f"{option}=True needs a scene with {flag}: its meta_data.json says "
                         f"{meta.get(flag)!r}")


def read_pairs(path: Path, sorted_ascending: bool = True) -> np.ndarray:
    """``pairs.txt`` as [N, 1 + sources] frame numbers (sdfstudio.py:158-166)."""
    rows = []
    for line in path.read_text().splitlines():
        arr = [int(name.split(".")[0]) for name in line.split(" ")]
        if sorted_ascending:
            arr = [arr[0]] + arr[:1:-1]  # JAX's line: the sources reversed, the first dropped
        rows.append(arr)
    return np.asarray(rows)


def parse_config(config: SDFStudioDataParserConfig, split: str = "train") -> DataparserOutputs:
    """The frames of ``split`` under ``config.data`` with every option of
    ``config`` (sdfstudio.py:53-182)."""
    cfg = config
    data = Path(cfg.data)
    meta_path = data / "meta_data.json"
    if not meta_path.is_file():
        raise FileNotFoundError(f"no meta_data.json under {data}")
    meta = json.loads(meta_path.read_text())
    frames = meta["frames"]
    indices = split_indices(len(frames), split, cfg.skip_every_for_val_split,
                            cfg.train_val_no_overlap)
    for option, flag in (("include_mono_prior", "has_mono_prior"),
                         ("include_sensor_depth", "has_sensor_depth"),
                         ("include_foreground_mask", "has_foreground_mask"),
                         ("include_sfm_points", "has_sparse_sfm_points")):
        if getattr(cfg, option):
            _require(meta, flag, option)

    c2ws = np.stack([np.asarray(f["camtoworld"], np.float32) for f in frames])
    intr = np.stack([np.asarray(f["intrinsics"], np.float32) for f in frames])
    depths, normals, sensor_depths, fg_masks, sfm_points = [], [], [], [], []
    for i in indices:
        frame = frames[i]
        if cfg.include_mono_prior:
            depths.append(np.load(data / frame["mono_depth_path"]).astype(np.float32))
            normal = np.load(data / frame["mono_normal_path"]).astype(np.float32)
            # omnidata's [0, 1] to [-1, 1], then to the world (sdfstudio.py:73-82)
            normal = normal * 2.0 - 1.0
            nm = normal.reshape(3, -1)
            nm = nm / np.maximum(np.linalg.norm(nm, axis=0, keepdims=True), 1e-12)
            nm = c2ws[i][:3, :3] @ nm
            normals.append(nm.T.reshape(*normal.shape[1:], 3))
        if cfg.include_sensor_depth:
            sensor_depths.append(np.load(data / frame["sensor_depth_path"]).astype(np.float32))
        if cfg.include_foreground_mask:
            fg_masks.append(load_image(data / frame["foreground_mask"])[..., :1])
        if cfg.include_sfm_points:
            sfm_points.append(np.loadtxt(data / frame["sfm_sparse_points_view"]).astype(np.float32))

    # OpenCV -> nerfstudio camera convention (sdfstudio.py:120-121)
    c2ws[:, 0:3, 1:3] *= -1
    if cfg.auto_orient:
        method = meta.get("orientation_override", cfg.orientation_method)
        oriented, transform = camera_utils.auto_orient_and_center_poses(
            c2ws, method=method, center_poses=cfg.center_poses)
        c2ws = np.concatenate(
            [oriented, np.tile(np.asarray([[[0, 0, 0, 1.0]]], np.float32), (len(oriented), 1, 1))],
            axis=1)
        normals = [(transform[:3, :3] @ n.reshape(-1, 3).T).T.reshape(n.shape) for n in normals]
    scale = 1.0
    if cfg.auto_scale_poses:
        scale /= float(np.max(np.abs(c2ws[:, :3, 3])))
    scale *= cfg.scale_factor
    c2ws[:, :3, 3] *= scale

    msb = meta["scene_box"]
    scene_box = SceneBox(
        aabb=np.asarray(msb["aabb"], np.float32),
        near=msb["near"],
        far=msb["far"],
        radius=msb["radius"],
        collider_type=msb["collider_type"],
    )
    sel = np.asarray(indices)
    cameras = Cameras.create(
        camera_to_worlds=c2ws[sel, :3, :4],
        fx=intr[sel, 0, 0],
        fy=intr[sel, 1, 1],
        cx=intr[sel, 0, 2],
        cy=intr[sel, 1, 2],
        width=meta["width"],
        height=meta["height"],
        device="cpu",
    )
    pairs_path = data / "pairs.txt"
    pairs_srcs = (read_pairs(pairs_path, cfg.pairs_sorted_ascending)
                  if cfg.load_pairs and split == "train" and pairs_path.exists() else None)
    return DataparserOutputs(
        [data / frames[i]["rgb_path"] for i in indices], cameras, scene_box,
        depths=depths or None, normals=normals or None, sensor_depths=sensor_depths or None,
        fg_masks=fg_masks or None, sparse_sfm_points=sfm_points or None, pairs_srcs=pairs_srcs,
    )


def parse(data: Path, split: str = "train", skip_every_for_val_split: int = 1,
          train_val_no_overlap: bool = False) -> DataparserOutputs:
    """The frames of ``split`` in ``data/meta_data.json`` at the parser's
    defaults: its scene box and their cameras."""
    return parse_config(SDFStudioDataParserConfig(
        data=Path(data), skip_every_for_val_split=skip_every_for_val_split,
        train_val_no_overlap=train_val_no_overlap), split)
