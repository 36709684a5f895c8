"""The instant-ngp, D-NeRF, Record3D and Friends parsers (counterpart of
``sdfstudio_tpu/data/dataparsers/misc_parsers.py``, ``InstantNGP`` :25-85,
``DNeRF`` :87-131, ``Record3D`` :134-193 and ``Friends`` :202-249).

instant-ngp reads ``transforms.json`` with shared intrinsics (``fl_x``,
``fl_y``, ``cx``, ``cy``, ``w``, ``h``) and shared k1, k2, p1, p2; each pose's
rows are permuted to ``[1, 0, 2]`` and its row 2 negated (ngp's axes to
nerfstudio's), the scene box is ``[-aabb_scale, aabb_scale]^3`` under the
``near_far`` collider at 0.05 and 1000, and both splits hold every frame.
``scene_scale`` is carried and read by no code, as in JAX.

Record3D reads ``metadata`` (``poses`` [N, 7] as quaternion x, y, z, w then
translation; ``K`` column-major; ``w``) and the images under ``rgb/`` (JPG,
then PNG; the port reads PNG). Beyond ``max_dataset_size`` frames it keeps
``round(linspace(0, n - 1, max_dataset_size))``; the poses' columns 1 and 2
are negated (OpenCV to OpenGL); the intrinsics are scaled by the image's
width over ``meta["w"]``; train is every frame but each ``val_skip``-th,
eval each ``val_skip``-th; the scene box is ``[-aabb_scale, aabb_scale]^3``
under the ``near_far`` collider at 0.05 and 100.

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

from sdfstudio_tpu_torch.cameras.camera_utils import get_distortion_params
from sdfstudio_tpu_torch.cameras.cameras import Cameras
from sdfstudio_tpu_torch.core.scene_box import SceneBox
from sdfstudio_tpu_torch.data.dataparsers.sdfstudio import DataparserOutputs
from sdfstudio_tpu_torch.data.png import png_size, read_png
from sdfstudio_tpu_torch.data.utils.colmap_utils import qvec2rotmat


@dataclasses.dataclass(frozen=True)
class InstantNGPDataParserConfig:
    """misc_parsers.py:25-28."""

    data: Path = Path("data/ours/posterv2")
    scene_scale: float = 0.33


def parse_instant_ngp(config: InstantNGPDataParserConfig, split: str = "train") -> DataparserOutputs:
    """Every frame of an instant-ngp ``transforms.json``, whatever the
    split (misc_parsers.py:37-85)."""
    data = Path(config.data)
    meta = json.loads((data / "transforms.json").read_text())
    files = [data / Path(frame["file_path"]) for frame in meta["frames"]]
    poses = np.stack([np.asarray(frame["transform_matrix"], np.float32) for frame in meta["frames"]])
    c2w = poses[:, :3][:, np.array([1, 0, 2]), :]
    c2w[:, 2, :] *= -1
    s = meta.get("aabb_scale", 1)
    scene_box = SceneBox(aabb=np.asarray([[-s, -s, -s], [s, s, s]], np.float32), near=0.05,
                         far=1000.0, collider_type="near_far")
    k = get_distortion_params(k1=float(meta.get("k1", 0)), k2=float(meta.get("k2", 0)),
                              p1=float(meta.get("p1", 0)), p2=float(meta.get("p2", 0)))
    cameras = Cameras.create(camera_to_worlds=c2w, fx=float(meta["fl_x"]), fy=float(meta["fl_y"]),
                             cx=float(meta["cx"]), cy=float(meta["cy"]), width=int(meta["w"]),
                             height=int(meta["h"]), distortion_params=np.tile(k, (len(files), 1)),
                             device="cpu")
    return DataparserOutputs(files, cameras, scene_box,
                             metadata={"height": int(meta["h"]), "width": int(meta["w"])})


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
class Record3DDataParserConfig:
    """misc_parsers.py:134-139."""

    data: Path = Path("data/record3d/capture")
    val_skip: int = 8
    aabb_scale: float = 4.0
    max_dataset_size: int = 150


def parse_record3d(config: Record3DDataParserConfig, split: str = "train") -> DataparserOutputs:
    """The split's frames of a Record3D capture (misc_parsers.py:148-193)."""
    cfg = config
    data = Path(cfg.data)
    image_dir = data / "rgb"
    files = sorted(image_dir.glob("*.jpg")) + sorted(image_dir.glob("*.png"))
    meta = json.loads((data / "metadata").read_text())
    poses_data = np.asarray(meta["poses"], np.float32)  # [N, 7]: x, y, z, w, tx, ty, tz
    if len(files) > cfg.max_dataset_size:
        idx = np.round(np.linspace(0, len(files) - 1, cfg.max_dataset_size)).astype(int)
        files = [files[i] for i in idx]
        poses_data = poses_data[idx]
    c2ws = np.tile(np.eye(4, dtype=np.float32), (len(poses_data), 1, 1))
    for c2w, (x, y, z, w_, tx, ty, tz) in zip(c2ws, poses_data):
        c2w[:3, :3] = qvec2rotmat(np.array([w_, x, y, z]))
        c2w[:3, 3] = [tx, ty, tz]
    c2ws[:, 0:3, 1:3] *= -1
    K = np.asarray(meta["K"], np.float32).reshape(3, 3).T
    height, width = png_size(files[0])
    scale = width / meta.get("w", width)
    idx_all = np.arange(len(files))
    sel = idx_all[idx_all % cfg.val_skip != 0] if split == "train" else idx_all[:: cfg.val_skip]
    cameras = Cameras.create(camera_to_worlds=c2ws[sel, :3, :4], fx=K[0, 0] * scale,
                             fy=K[1, 1] * scale, cx=K[0, 2] * scale, cy=K[1, 2] * scale,
                             width=width, height=height, device="cpu")
    s = cfg.aabb_scale
    scene_box = SceneBox(aabb=np.asarray([[-s, -s, -s], [s, s, s]], np.float32), near=0.05, far=100.0,
                         collider_type="near_far")
    return DataparserOutputs([files[i] for i in sel], cameras, scene_box)


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
