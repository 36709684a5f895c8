"""The MonoSDF-format parser (counterpart of
``sdfstudio_tpu/data/dataparsers/monosdf.py``): ``cameras.npz`` with
``world_mat_<i>`` and ``scale_mat_<i>``, images ``*_rgb.png`` and, with
``include_mono_prior``, monocular depths ``*_depth.npy`` [H, W] and normals
``*_normal.npy`` [3, H, W] in [0, 1].

- ``P = (world_mat @ scale_mat)[:3, :4]`` in float32 is decomposed into
  intrinsics and a pose as ``cv2.decomposeProjectionMatrix`` does
  (``decompose_projection``: an RQ decomposition by three Givens rotations
  with OpenCV's choice of signs, the camera centre from the null space of
  ``P``), ``K / K[2, 2]`` (monosdf.py:25-38).
- The center-crop types shift ``cx`` by half the cropped width and scale
  the first two rows of the intrinsics: ``center_crop_for_replica`` (680 of
  1200 to 384), ``_for_tnt`` (540 of 960), ``_for_dtu`` (1200 of 1600); any
  other value crops nothing (:63-79).
- The poses' columns 1 and 2 are negated (OpenCV to nerfstudio, :82-84).
- The normals are mapped to [-1, 1], normalised and rotated to the world by
  the OpenCV pose (:94-103).
- Train is every frame; eval every ``skip_every_for_val_split``-th (:105-108).
- ``pairs.txt`` with ``load_pairs``, each line ``[ref] + arr[:1:-1]`` with
  ``pairs_sorted_ascending`` (:129-140), in the train split only.
- The image size is the first PNG's (its header); the scene box is
  ``[-1, 1]^3 * scene_scale / 2`` under the ``near_far`` collider at 0.05
  and 2.5 with radius 1. ``downscale_factor`` and ``neighbors_num`` are
  carried and read by no code, as in JAX.
"""
from __future__ import annotations

import dataclasses
from glob import glob
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from sdfstudio_tpu_torch.cameras.cameras import Cameras
from sdfstudio_tpu_torch.core.scene_box import SceneBox
from sdfstudio_tpu_torch.data.dataparsers.sdfstudio import DataparserOutputs, read_pairs
from sdfstudio_tpu_torch.data.png import png_size

# monosdf.py:63-79: (cropped width / full width to 384, the horizontal offset)
CENTER_CROPS = {"center_crop_for_replica": (384 / 680, (1200 - 680) * 0.5),
                "center_crop_for_tnt": (384 / 540, (960 - 540) * 0.5),
                "center_crop_for_dtu": (384 / 1200, (1600 - 1200) * 0.5)}
_EPS = np.finfo(np.float64).eps


def _givens(a: float, b: float) -> Tuple[float, float]:
    z = 1.0 / np.sqrt(a * a + b * b + _EPS)
    return a * z, b * z


def rq_decomposition(M: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``M = R @ Q`` with ``R`` upper triangular and ``Q`` orthogonal, by
    OpenCV's Givens rotations about x, y, z and its rule for the diagonal's
    signs (``RQDecomp3x3``): ``R[0, 0]`` and ``R[1, 1]`` come out
    non-negative, by a rotation of 180 degrees about y where needed (with
    OpenCV's transpose of the z rotation); ``R[2, 2]`` keeps its sign. In
    float64."""
    A = np.asarray(M, np.float64)
    c, s = _givens(A[2, 2], A[2, 1])
    Qx = np.array([[1, 0, 0], [0, c, s], [0, -s, c]])
    Mx = A @ Qx
    c, s = _givens(Mx[2, 2], -Mx[2, 0])
    Qy = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])
    N = Mx @ Qy
    c, s = _givens(N[1, 1], N[1, 0])
    Qz = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])
    R = N @ Qz
    # R[1, 1] = hypot(N[1, 0], N[1, 1]) >= 0 by the z rotation's choice, so
    # of OpenCV's three cases only its 180 degrees about y can arise
    if R[0, 0] < 0:
        R[0, 0] *= -1
        R[0, 2] *= -1
        R[1, 2] *= -1
        R[2, 2] *= -1
        Qz = Qz.T
        Qy[0, 0] *= -1
        Qy[0, 2] *= -1
        Qy[2, 0] *= -1
        Qy[2, 2] *= -1
    Q = Qz.T @ Qy.T @ Qx.T
    return R, Q


def decompose_projection(P: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``cv2.decomposeProjectionMatrix(P)[:3]`` for a float32 ``P`` [3, 4]:
    the intrinsics ``K``, the rotation and the camera centre in homogeneous
    coordinates [4, 1] (the null space of ``P``), each in float32."""
    K, R = rq_decomposition(np.asarray(P, np.float64)[:, :3])
    _, _, vt = np.linalg.svd(np.asarray(P, np.float64))
    return K.astype(np.float32), R.astype(np.float32), vt[-1].reshape(4, 1).astype(np.float32)


def load_K_Rt_from_P(P: np.ndarray):
    """(intrinsics [4, 4], camera-to-world [4, 4] in OpenCV's convention)
    of a projection (monosdf.py:25-38)."""
    K, R, t = decompose_projection(P)
    K = K / K[2, 2]
    intrinsics = np.eye(4)
    intrinsics[:3, :3] = K
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = R.T
    pose[:3, 3] = (t[:3] / t[3])[:, 0]
    return intrinsics, pose


@dataclasses.dataclass(frozen=True)
class MonoSDFDataParserConfig:
    """monosdf.py:41-51."""

    data: Path = Path("data/DTU/scan65")
    include_mono_prior: bool = False
    downscale_factor: int = 1
    scene_scale: float = 2.0
    center_crop_type: str = "center_crop_for_dtu"
    load_pairs: bool = False
    neighbors_num: Optional[int] = None
    pairs_sorted_ascending: bool = True
    skip_every_for_val_split: int = 1


def parse_monosdf(config: MonoSDFDataParserConfig, split: str = "train") -> DataparserOutputs:
    """The split's frames of a MonoSDF scene (monosdf.py:57-154)."""
    cfg = config
    data = Path(cfg.data)
    image_paths = sorted(glob(str(data / "*_rgb.png")))
    depth_paths = sorted(glob(str(data / "*_depth.npy")))
    normal_paths = sorted(glob(str(data / "*_normal.npy")))
    n = len(image_paths)
    cams = np.load(data / "cameras.npz")
    scale, offset = CENTER_CROPS.get(cfg.center_crop_type, (1.0, 0.0))
    intr, c2ws = [], []
    for i in range(n):
        P = (cams[f"world_mat_{i}"].astype(np.float32) @ cams[f"scale_mat_{i}"].astype(np.float32))[:3, :4]
        K, pose = load_K_Rt_from_P(P)
        K = K.copy()
        K[0, 2] -= offset
        K[:2, :] *= scale
        intr.append(K)
        c2ws.append(pose)
    intr = np.stack(intr).astype(np.float32)
    c2ws = np.stack(c2ws)
    c2ws[:, 0:3, 1:3] *= -1  # OpenCV -> nerfstudio
    height, width = png_size(image_paths[0])

    depths = normals = None
    if cfg.include_mono_prior:
        depths = [np.load(p).astype(np.float32) for p in depth_paths]
        normals = []
        for p, c2w in zip(normal_paths, c2ws):
            nrm = np.load(p).astype(np.float32) * 2.0 - 1.0
            rot = c2w[:3, :3].copy()
            rot[:, 1:3] *= -1  # the OpenCV rotation
            nm = nrm.reshape(3, -1)
            nm = nm / np.maximum(np.linalg.norm(nm, axis=0, keepdims=True), 1e-12)
            normals.append((rot @ nm).T.reshape(*nrm.shape[1:], 3))

    indices = list(range(n))
    if split != "train" and cfg.skip_every_for_val_split >= 1:
        indices = indices[:: cfg.skip_every_for_val_split]
    sel = np.asarray(indices)
    cameras = Cameras.create(camera_to_worlds=c2ws[sel, :3, :4], fx=intr[sel, 0, 0], fy=intr[sel, 1, 1],
                             cx=intr[sel, 0, 2], cy=intr[sel, 1, 2], width=width, height=height,
                             device="cpu")
    scene_box = SceneBox(aabb=np.asarray([[-1, -1, -1], [1, 1, 1]], np.float32) * cfg.scene_scale / 2.0,
                         near=0.05, far=2.5, radius=1.0, collider_type="near_far")
    pairs = None
    pairs_path = data / "pairs.txt"
    if pairs_path.exists() and split == "train" and cfg.load_pairs:
        pairs = read_pairs(pairs_path, cfg.pairs_sorted_ascending)

    def pick(lst):
        return [lst[i] for i in indices] if lst else None

    return DataparserOutputs([Path(image_paths[i]) for i in indices], cameras, scene_box,
                             depths=pick(depths), normals=pick(normals), pairs_srcs=pairs,
                             metadata={"height": height, "width": width})
