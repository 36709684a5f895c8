"""COLMAP-based dataparsers (counterpart of
``sdfstudio_tpu/data/dataparsers/colmap_family.py``): the cameras of a
COLMAP sparse model (``load_colmap_cameras``, :28-89), the ``mipnerf360``
parser of the BakedSDF family (``Mipnerf360``, :92-142) and the ``heritage``
parser of ``neusW`` (``Heritage``, :157-237).

The mipnerf360 parser orients the poses "up" and centres them
(``cameras/camera_utils.py::auto_orient_and_center_poses``), scales them by
the largest absolute camera translation, and splits train and eval by
``linspace``: ``ceil(0.9 n)`` train images evenly spread, the rest eval
(every image when none is left). Its scene box is ``[-1, 1]^3 *
scene_scale`` with near 0.05 and far 1000 under the ``near_far`` collider;
its ``metadata`` holds the transform and the scale.

The heritage parser keeps the sparse points seen by at least
``min_track_length`` images, normalises the scene by their 2nd / 98th
percentile box (centre, and half its largest side times ``1 +
voxel_margin``), marks the points' cells of a ``coarse_grid_resolution``^3
grid over ``[-1, 1]^3`` and dilates it by one cell along each axis (with
``np.roll``'s wrap, as JAX), and reads ``masks/<stem>.png`` where every
image has one. Train is every image; eval is the first 10. The
``phototourism`` parser is the mipnerf360 parser under another default
scene (colmap_family.py:145-155). All three keep each image's own size and
its camera's distortion (SIMPLE_RADIAL's and RADIAL's k1, k2; OPENCV's k1,
k2, p1, p2), as JAX's do.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from sdfstudio_tpu_torch.cameras.camera_utils import auto_orient_and_center_poses
from sdfstudio_tpu_torch.cameras.cameras import Cameras
from sdfstudio_tpu_torch.core.scene_box import SceneBox
from sdfstudio_tpu_torch.data.dataparsers.sdfstudio import DataparserOutputs
from sdfstudio_tpu_torch.data.png import load_image
from sdfstudio_tpu_torch.data.utils import colmap_utils

HERITAGE_EVAL_IMAGES = 10  # colmap_family.py:208


def load_colmap_cameras(data: Path, images_path: str = "images"):
    """The images of the first sparse model found, sorted by name: (files,
    poses [N, 4, 4] camera-to-world in the nerfstudio convention, fx, fy,
    cx, cy, widths, heights, distortion [N, 6], points or None)
    (colmap_family.py:28-89)."""
    candidates = [data / "sparse" / "0", data / "sparse", data / "colmap" / "sparse" / "0",
                  data / "dense" / "sparse"]
    sparse = next((p for p in candidates if p.exists()), None)
    if sparse is None:
        raise FileNotFoundError(f"no COLMAP sparse model under {data}")
    cams, imgs, pts = colmap_utils.read_model(sparse)
    files, poses = [], []
    fx, fy, cx, cy, widths, heights, distorts = [], [], [], [], [], [], []
    for img in sorted(imgs.values(), key=lambda im: im.name):
        cam = cams[img.camera_id]
        w2c = np.concatenate([np.concatenate([img.qvec2rotmat(), img.tvec.reshape(3, 1)], 1),
                              np.array([[0, 0, 0, 1.0]])], 0)
        c2w = np.linalg.inv(w2c)
        c2w[0:3, 1:3] *= -1  # OpenCV -> nerfstudio
        poses.append(c2w.astype(np.float32))
        files.append(data / images_path / img.name)
        k = np.zeros(6)
        p = cam.params
        if cam.model == "SIMPLE_PINHOLE":
            fx_, fy_, cx_, cy_ = p[0], p[0], p[1], p[2]
        elif cam.model == "PINHOLE":
            fx_, fy_, cx_, cy_ = p[0], p[1], p[2], p[3]
        elif cam.model in ("SIMPLE_RADIAL", "RADIAL"):
            fx_, fy_, cx_, cy_ = p[0], p[0], p[1], p[2]
            k[0] = p[3]
            if cam.model == "RADIAL":
                k[1] = p[4]
        elif cam.model == "OPENCV":
            fx_, fy_, cx_, cy_ = p[0], p[1], p[2], p[3]
            k[0], k[1], k[4], k[5] = p[4:8]
        else:
            raise ValueError(f"unsupported COLMAP camera model {cam.model}")
        fx.append(fx_), fy.append(fy_), cx.append(cx_), cy.append(cy_)
        widths.append(cam.width), heights.append(cam.height)
        distorts.append(k.astype(np.float32))
    return (files, np.stack(poses), np.asarray(fx, np.float32), np.asarray(fy, np.float32),
            np.asarray(cx, np.float32), np.asarray(cy, np.float32), np.asarray(widths, np.int32),
            np.asarray(heights, np.int32), np.stack(distorts), pts)


@dataclasses.dataclass(frozen=True)
class Mipnerf360DataParserConfig:
    """JAX's ``Mipnerf360DataParserConfig`` (colmap_family.py:92-101).
    ``downscale_factor`` is read by no code, in JAX either."""

    data: Path = Path("data/mipnerf360/garden")
    downscale_factor: int = 1
    scene_scale: float = 1.0
    orientation_method: str = "up"
    center_poses: bool = True
    auto_scale_poses: bool = True
    train_split_percentage: float = 0.9
    images_path: str = "images"


def parse_mipnerf360(config: Mipnerf360DataParserConfig, split: str = "train") -> DataparserOutputs:
    """The split's images of a mip-NeRF 360 capture (colmap_family.py:107-142)."""
    cfg = config
    files, poses, fx, fy, cx, cy, w, h, distorts, _ = load_colmap_cameras(Path(cfg.data),
                                                                           cfg.images_path)
    oriented, transform = auto_orient_and_center_poses(poses, method=cfg.orientation_method,
                                                       center_poses=cfg.center_poses)
    scale = 1.0
    if cfg.auto_scale_poses:
        scale /= float(np.max(np.abs(oriented[:, :3, 3])))
    oriented[:, :3, 3] *= scale
    n = len(files)
    i_train = np.linspace(0, n - 1, int(np.ceil(n * cfg.train_split_percentage)), dtype=int)
    i_eval = np.setdiff1d(np.arange(n), i_train)
    sel = i_train if split == "train" else (i_eval if len(i_eval) else np.arange(n))
    cameras = Cameras.create(camera_to_worlds=oriented[sel, :3, :4], fx=fx[sel], fy=fy[sel],
                             cx=cx[sel], cy=cy[sel], width=w[sel], height=h[sel],
                             distortion_params=distorts[sel], device="cpu")
    scene_box = SceneBox(aabb=np.asarray([[-1, -1, -1], [1, 1, 1]], np.float32) * cfg.scene_scale,
                         near=0.05, far=1000.0, collider_type="near_far")
    return DataparserOutputs([files[i] for i in sel], cameras, scene_box,
                             metadata={"transform": transform, "scale": scale})


@dataclasses.dataclass(frozen=True)
class PhototourismDataParserConfig(Mipnerf360DataParserConfig):
    """colmap_family.py:145-147: parsed by :func:`parse_mipnerf360`."""

    data: Path = Path("data/phototourism/brandenburg-gate")


@dataclasses.dataclass(frozen=True)
class HeritageDataParserConfig:
    """JAX's ``HeritageDataParserConfig`` (colmap_family.py:147-154)."""

    data: Path = Path("data/heritage/brandenburg_gate")
    images_path: str = "images"
    coarse_grid_resolution: int = 32
    min_track_length: int = 3
    voxel_margin: float = 0.05


def heritage_normalization(xyz: np.ndarray, track_len: np.ndarray, min_track_length: int,
                           voxel_margin: float):
    """(kept points, centre, radius) of the parser's normalisation
    (colmap_family.py:174-184)."""
    xyz = xyz[track_len >= min_track_length]
    lo, hi = np.percentile(xyz, 2, axis=0), np.percentile(xyz, 98, axis=0)
    center = (lo + hi) / 2.0
    radius = float(np.max(hi - lo)) / 2.0 * (1 + voxel_margin)
    return xyz, center, radius


def coarse_binary_grid(xyz: np.ndarray, res: int) -> np.ndarray:
    """The normalised points' cells of a ``res``^3 grid over [-1, 1]^3,
    dilated by one cell along each axis, wrapping at the edges
    (colmap_family.py:186-199)."""
    ijk = np.clip(((xyz + 1.0) / 2.0 * res).astype(int), 0, res - 1)
    grid = np.zeros((res, res, res), bool)
    grid[ijk[:, 0], ijk[:, 1], ijk[:, 2]] = True
    dil = grid.copy()
    for ax in range(3):
        dil |= np.roll(grid, 1, axis=ax) | np.roll(grid, -1, axis=ax)
    return dil


def parse_heritage(config: HeritageDataParserConfig, split: str = "train") -> DataparserOutputs:
    """The split's images of a heritage capture (colmap_family.py:163-237)."""
    cfg = config
    data = Path(cfg.data)
    files, poses, fx, fy, cx, cy, w, h, distorts, pts = load_colmap_cameras(data, cfg.images_path)
    if pts is None:
        raise ValueError(f"the heritage parser needs points3D in the sparse model under {data}")
    xyz = np.stack([p.xyz for p in pts.values()])
    track_len = np.asarray([len(p.image_ids) for p in pts.values()])
    xyz, center, radius = heritage_normalization(xyz, track_len, cfg.min_track_length,
                                                 cfg.voxel_margin)
    poses[:, :3, 3] = (poses[:, :3, 3] - center) / radius
    xyz = (xyz - center) / radius
    scene_box = SceneBox(aabb=np.asarray([[-1, -1, -1], [1, 1, 1]], np.float32), near=0.01, far=4.0,
                         radius=1.0, collider_type="sphere",
                         coarse_binary_grid=coarse_binary_grid(xyz, cfg.coarse_grid_resolution))
    n = len(files)
    sel = np.arange(n) if split == "train" else np.arange(min(n, HERITAGE_EVAL_IMAGES))
    masks = None
    mask_dir = data / "masks"
    if mask_dir.exists():
        paths = [mask_dir / (Path(files[i]).stem + ".png") for i in sel]
        if all(p.exists() for p in paths):
            masks = [load_image(p)[..., :1] for p in paths]
    cameras = Cameras.create(camera_to_worlds=poses[sel, :3, :4], fx=fx[sel], fy=fy[sel], cx=cx[sel],
                             cy=cy[sel], width=w[sel], height=h[sel], distortion_params=distorts[sel],
                             device="cpu")
    return DataparserOutputs([files[i] for i in sel], cameras, scene_box, fg_masks=masks)
