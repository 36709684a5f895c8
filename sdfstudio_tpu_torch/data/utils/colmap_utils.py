"""COLMAP sparse-model readers (counterpart of
``sdfstudio_tpu/data/utils/colmap_utils.py``): cameras, images and 3D points
in COLMAP's binary (:95-160) and text (:161-222) formats, and ``read_model``
(:223-243), which takes the binary model where ``cameras.bin`` exists and
the text one otherwise. numpy alone."""
from __future__ import annotations

import dataclasses
import struct
from pathlib import Path
from typing import Dict

import numpy as np

CAMERA_MODEL_IDS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


@dataclasses.dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclasses.dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray  # [w, x, y, z]
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray
    point3D_ids: np.ndarray

    def qvec2rotmat(self) -> np.ndarray:
        return qvec2rotmat(self.qvec)


@dataclasses.dataclass
class ColmapPoint3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2D_idxs: np.ndarray


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    """The rotation of a unit quaternion [w, x, y, z] (colmap_utils.py:62-71)."""
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y**2 - 2 * z**2, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x**2 - 2 * z**2, 2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x**2 - 2 * y**2],
    ])


def _read_next_bytes(fid, num_bytes, fmt, endian="<"):
    return struct.unpack(endian + fmt, fid.read(num_bytes))


def read_cameras_binary(path: Path) -> Dict[int, ColmapCamera]:
    cameras = {}
    with open(path, "rb") as f:
        num = _read_next_bytes(f, 8, "Q")[0]
        for _ in range(num):
            cam_id, model_id, w, h = _read_next_bytes(f, 24, "iiQQ")
            name, n_params = CAMERA_MODEL_IDS[model_id]
            params = np.array(_read_next_bytes(f, 8 * n_params, "d" * n_params))
            cameras[cam_id] = ColmapCamera(cam_id, name, w, h, params)
    return cameras


def read_images_binary(path: Path) -> Dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        num = _read_next_bytes(f, 8, "Q")[0]
        for _ in range(num):
            vals = _read_next_bytes(f, 64, "idddddddi")
            img_id, qvec, tvec, cam_id = vals[0], np.array(vals[1:5]), np.array(vals[5:8]), vals[8]
            name = b""
            c = f.read(1)
            while c != b"\x00":
                name += c
                c = f.read(1)
            n_pts = _read_next_bytes(f, 8, "Q")[0]
            data = np.array(_read_next_bytes(f, 24 * n_pts, "ddq" * n_pts)).reshape(-1, 3)
            xys = data[:, :2] if n_pts else np.zeros((0, 2))
            ids = data[:, 2].astype(np.int64) if n_pts else np.zeros(0, np.int64)
            images[img_id] = ColmapImage(img_id, qvec, tvec, cam_id, name.decode(), xys, ids)
    return images


def read_points3d_binary(path: Path) -> Dict[int, ColmapPoint3D]:
    points = {}
    with open(path, "rb") as f:
        num = _read_next_bytes(f, 8, "Q")[0]
        for _ in range(num):
            vals = _read_next_bytes(f, 43, "QdddBBBd")
            track_len = _read_next_bytes(f, 8, "Q")[0]
            track = _read_next_bytes(f, 8 * track_len, "ii" * track_len)
            points[vals[0]] = ColmapPoint3D(vals[0], np.array(vals[1:4]), np.array(vals[4:7]),
                                            vals[7], np.array(track[0::2]), np.array(track[1::2]))
    return points


def read_cameras_text(path: Path) -> Dict[int, ColmapCamera]:
    cameras = {}
    for line in Path(path).read_text().splitlines():
        if line.startswith("#") or not line.strip():
            continue
        elems = line.split()
        cam_id = int(elems[0])
        cameras[cam_id] = ColmapCamera(cam_id, elems[1], int(elems[2]), int(elems[3]),
                                       np.array(elems[4:], float))
    return cameras


def read_images_text(path: Path) -> Dict[int, ColmapImage]:
    """Two lines an image; an image without observations has a blank
    second line, which is kept so that the pairs stay in step
    (colmap_utils.py:175-204)."""
    images = {}
    raw = [l for l in Path(path).read_text().splitlines() if not l.startswith("#")]
    lines, expecting_points = [], False
    for l in raw:
        if not l.strip() and not expecting_points:
            continue  # a stray blank between records
        lines.append(l)
        expecting_points = not expecting_points
    if expecting_points:
        lines.append("")  # a last image without its points line
    for meta_line, pts_line in zip(lines[0::2], lines[1::2]):
        elems = meta_line.split()
        img_id = int(elems[0])
        pts = (np.array(pts_line.split(), float).reshape(-1, 3) if pts_line.split()
               else np.zeros((0, 3)))
        images[img_id] = ColmapImage(img_id, np.array(elems[1:5], float), np.array(elems[5:8], float),
                                     int(elems[8]), elems[9], pts[:, :2], pts[:, 2].astype(np.int64))
    return images


def read_points3d_text(path: Path) -> Dict[int, ColmapPoint3D]:
    """POINT3D_ID X Y Z R G B ERROR (IMAGE_ID POINT2D_IDX)* (colmap_utils.py:207-222)."""
    points = {}
    for line in Path(path).read_text().splitlines():
        if line.startswith("#") or not line.strip():
            continue
        elems = line.split()
        pid = int(elems[0])
        track = np.array(elems[8:], dtype=np.int64).reshape(-1, 2)
        points[pid] = ColmapPoint3D(pid, np.array(elems[1:4], float), np.array(elems[4:7], float),
                                    float(elems[7]), track[:, 0], track[:, 1])
    return points


def read_model(sparse_dir: Path):
    """(cameras, images, points or None) of a binary or text model (colmap_utils.py:223-243)."""
    sparse_dir = Path(sparse_dir)
    binary = (sparse_dir / "cameras.bin").exists()
    ext = "bin" if binary else "txt"
    cams = (read_cameras_binary if binary else read_cameras_text)(sparse_dir / f"cameras.{ext}")
    imgs = (read_images_binary if binary else read_images_text)(sparse_dir / f"images.{ext}")
    pts_path = sparse_dir / f"points3D.{ext}"
    pts = ((read_points3d_binary if binary else read_points3d_text)(pts_path)
           if pts_path.exists() else None)
    return cams, imgs, pts
