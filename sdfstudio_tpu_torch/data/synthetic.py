"""A ray-cast coloured sphere in SDFStudio format (counterpart of
``sdfstudio_tpu/data/synthetic.py::generate_sphere_dataset``, :30-170):
``meta_data.json``, the images, and optionally the monocular depth and
normal cues, the foreground masks and ``pairs.txt``, computed in numpy as
JAX computes them; the PNGs are written by the port's own writer
(``data/png.py``) where JAX uses PIL, with the same pixels. The verify
recipes train on it, and ``final_eval_gt="sphere"`` judges its mesh.

The same sphere in two more layouts, which the NeRF baselines read (the
JAX package has no generator for them): ``generate_blender_sphere_dataset``
writes RGBA views and ``transforms_{train,val}.json`` (Blender's layout,
``blender-data``; with ``times`` each frame's ``time`` and a sphere that
moves with it, D-NeRF's layout, ``dnerf-data``), and
``generate_friends_sphere_dataset`` writes ``cameras.json``, the views
and their segmentations (``segmentations/thing/<stem>.png``: 1 on the
sphere, 0 elsewhere), the Friends layout (``friends-data``).

And in the layouts of real captures: ``generate_nerfstudio_sphere_dataset``
(``transforms.json`` with per-frame intrinsics, shared OpenCV distortion and
views of two sizes, ``nerfstudio-data``), ``generate_ngp_sphere_dataset``
(instant-ngp's ``transforms.json`` in its own axes with distortion,
``instant-ngp-data``) and ``generate_record3d_sphere_dataset``
(``metadata`` with quaternion poses and column-major ``K`` at twice the
images' resolution, ``record3d-data``). The distorted views are rendered
through the port's own ray generation (``cameras/cameras.py``), so the
images agree with the rays that training draws. ``write_monosdf_layout``
rewrites an SDFStudio scene with cues in MonoSDF's layout
(``cameras.npz`` of ``world_mat_<i>`` and ``scale_mat_<i>``, and links to
its ``*_rgb.png``, ``*_depth.npy`` and ``*_normal.npy``, ``monosdf-data``).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np

from sdfstudio_tpu_torch.data.png import write_png

CAPTURE_DISTORTION = {"k1": -0.12, "k2": 0.03, "p1": 0.0015, "p2": -0.001}


def _sphere_trace(origins, dirs, center, radius):
    """Ray / sphere intersection: (t, hit)."""
    oc = origins - center
    b = np.sum(oc * dirs, axis=-1)
    c = np.sum(oc * oc, axis=-1) - radius**2
    disc = b * b - c
    hit = disc > 0
    t = -b - np.sqrt(np.maximum(disc, 0))
    hit &= t > 0
    return t, hit


def generate_sphere_dataset(
    out_dir: Path,
    num_images: int = 16,
    width: int = 64,
    height: int = 64,
    radius: float = 0.5,
    cam_radius: float = 2.0,
    with_mono_prior: bool = True,
    with_fg_mask: bool = True,
    with_pairs: bool = False,
    num_pair_srcs: int = 4,
    seed: int = 0,
) -> Path:
    """Write the sphere scene under ``out_dir``; returns it. ``seed`` is
    kept for JAX's signature: nothing here is random."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    fx = fy = 0.8 * width
    cx, cy = width / 2.0, height / 2.0
    intrinsics = np.array([[fx, 0, cx, 0], [0, fy, cy, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float64)
    center = np.zeros(3)
    frames = []
    for i in range(num_images):
        # cameras on a tilted ring, OpenCV convention (x right, y down, z forward)
        phi = 2 * np.pi * i / num_images
        elev = 0.35 + 0.25 * np.sin(3 * phi)
        pos = cam_radius * np.array(
            [np.cos(phi) * np.cos(elev), np.sin(phi) * np.cos(elev), np.sin(elev)])
        forward = center - pos
        forward /= np.linalg.norm(forward)
        right = np.cross(forward, np.array([0.0, 0.0, 1.0]))
        right /= np.linalg.norm(right)
        down = np.cross(forward, right)
        R = np.stack([right, down, forward], axis=1)  # columns
        c2w = np.eye(4)
        c2w[:3, :3] = R
        c2w[:3, 3] = pos

        ys, xs = np.meshgrid(np.arange(height) + 0.5, np.arange(width) + 0.5, indexing="ij")
        d_cam = np.stack([(xs - cx) / fx, (ys - cy) / fy, np.ones_like(xs)], axis=-1)
        d_cam /= np.linalg.norm(d_cam, axis=-1, keepdims=True)
        d_world = d_cam @ R.T
        o_world = np.broadcast_to(pos, d_world.shape)
        t, hit = _sphere_trace(o_world, d_world, center, radius)
        pts = o_world + t[..., None] * d_world
        normals = (pts - center) / radius

        # lambertian shading under three coloured lights
        lights = np.array([[1, 1, 1], [-1, 0.5, 0.8], [0.2, -1, 0.5]], np.float64)
        lights /= np.linalg.norm(lights, axis=-1, keepdims=True)
        light_colors = np.array([[0.9, 0.3, 0.2], [0.2, 0.8, 0.3], [0.25, 0.3, 0.9]])
        shade = np.zeros((*hit.shape, 3))
        for L, c in zip(lights, light_colors):
            shade += np.clip(normals @ L, 0, 1)[..., None] * c
        albedo = 0.6 + 0.4 * np.stack(
            [np.cos(4 * pts[..., 0]), np.cos(4 * pts[..., 1]), np.cos(4 * pts[..., 2])], axis=-1)
        rgb_fg = np.clip(0.15 + shade * albedo, 0, 1)
        bg = np.stack([0.8 + 0.2 * d_world[..., 2], 0.85 * np.ones_like(t),
                       0.9 - 0.1 * d_world[..., 2]], axis=-1)
        img = np.where(hit[..., None], rgb_fg, np.clip(bg, 0, 1))
        name = f"{i:06d}_rgb.png"
        write_png(out_dir / name, (img * 255).astype(np.uint8))
        frame = {"rgb_path": name, "camtoworld": c2w.tolist(), "intrinsics": intrinsics.tolist()}

        if with_mono_prior:
            # camera-frame z depth, and camera-frame normals in omnidata's layout
            z_depth = np.where(hit, t * (d_cam[..., 2]), 0.0).astype(np.float32)
            np.save(out_dir / f"{i:06d}_depth.npy", z_depth)
            n_cam = np.einsum("ij,hwj->hwi", R.T, normals)
            n_cam = np.where(hit[..., None], n_cam, np.array([0, 0, -1.0]))
            np.save(out_dir / f"{i:06d}_normal.npy",
                    ((np.moveaxis(n_cam, -1, 0) + 1.0) / 2.0).astype(np.float32))
            frame["mono_depth_path"] = f"{i:06d}_depth.npy"
            frame["mono_normal_path"] = f"{i:06d}_normal.npy"
        if with_fg_mask:
            mname = f"{i:06d}_foreground_mask.png"
            write_png(out_dir / mname, (hit * 255).astype(np.uint8))
            frame["foreground_mask"] = mname
        frames.append(frame)

    if with_pairs:
        # each image's source views by ring adjacency
        lines = []
        for i in range(num_images):
            srcs = []
            for d in range(1, num_pair_srcs // 2 + 1):
                srcs += [(i - d) % num_images, (i + d) % num_images]
            lines.append(" ".join([f"{i:06d}.png"] + [f"{s:06d}.png" for s in srcs[:num_pair_srcs]]))
        (out_dir / "pairs.txt").write_text("\n".join(lines) + "\n")

    meta = {
        "camera_model": "OPENCV",
        "height": height,
        "width": width,
        "has_mono_prior": with_mono_prior,
        "has_sensor_depth": False,
        "has_foreground_mask": with_fg_mask,
        "has_sparse_sfm_points": False,
        "worldtogt": np.eye(4).tolist(),
        "scene_box": {"aabb": [[-1, -1, -1], [1, 1, 1]], "near": 0.5, "far": 4.5, "radius": 1.0,
                      "collider_type": "near_far"},
        "frames": frames,
    }
    (out_dir / "meta_data.json").write_text(json.dumps(meta, indent=1))
    return out_dir


def _ring_pose(i: int, n: int, cam_radius: float) -> np.ndarray:
    """Camera ``i`` of ``n`` on a tilted ring around the origin, looking at
    it: camera-to-world [4, 4] in OpenCV's axes (x right, y down, z forward)."""
    phi = 2 * np.pi * i / n
    elev = 0.35 + 0.25 * np.sin(3 * phi)
    pos = cam_radius * np.array([np.cos(phi) * np.cos(elev), np.sin(phi) * np.cos(elev),
                                 np.sin(elev)])
    forward = -pos / np.linalg.norm(pos)
    right = np.cross(forward, np.array([0.0, 0.0, 1.0]))
    right /= np.linalg.norm(right)
    c2w = np.eye(4)
    c2w[:3, :3] = np.stack([right, np.cross(forward, right), forward], axis=1)
    c2w[:3, 3] = pos
    return c2w


def _sphere_view(c2w: np.ndarray, focal: float, width: int, height: int, center: np.ndarray,
                 radius: float):
    """(rgb [H, W, 3] in [0, 1] over black, hit [H, W]) of the shaded sphere
    seen by an OpenCV camera ``c2w`` with pixel centres at +0.5."""
    ys, xs = np.meshgrid(np.arange(height) + 0.5, np.arange(width) + 0.5, indexing="ij")
    d_cam = np.stack([(xs - width / 2.0) / focal, (ys - height / 2.0) / focal, np.ones_like(xs)], -1)
    d_world = (d_cam / np.linalg.norm(d_cam, axis=-1, keepdims=True)) @ c2w[:3, :3].T
    o_world = np.broadcast_to(c2w[:3, 3], d_world.shape)
    t, hit = _sphere_trace(o_world, d_world, center, radius)
    pts = o_world + t[..., None] * d_world
    normals = (pts - center) / radius
    light = np.array([1.0, 1.0, 1.0]) / np.sqrt(3.0)
    shade = 0.2 + 0.8 * np.clip(normals @ light, 0, 1)
    albedo = 0.6 + 0.4 * np.stack([np.cos(4 * pts[..., 0]), np.cos(4 * pts[..., 1]),
                                   np.cos(4 * pts[..., 2])], axis=-1)
    return np.where(hit[..., None], np.clip(shade[..., None] * albedo, 0, 1), 0.0), hit


def generate_blender_sphere_dataset(out_dir: Path, num_images: int = 16, width: int = 64,
                                    height: int = 64, radius: float = 1.0, cam_radius: float = 4.0,
                                    times: bool = False, val_every: int = 8) -> Path:
    """The sphere in Blender's layout under ``out_dir``: RGBA views
    ``train/r_<i>.png`` (alpha 1 on the sphere) and ``transforms_train.json``
    / ``transforms_val.json`` (every ``val_every``-th view) with
    ``camera_angle_x`` and OpenGL camera-to-world matrices, the cameras on a
    ring of ``cam_radius`` (4 by default: the sphere lies between the NeRF
    models' near and far planes at 2 and 6), at a focal length of 1.2
    widths. With ``times`` each frame has
    ``time = i / (n - 1)`` and the sphere's centre moves along x by ``0.2
    time``. Returns ``out_dir``."""
    out_dir = Path(out_dir)
    (out_dir / "train").mkdir(parents=True, exist_ok=True)
    focal = 1.2 * width
    splits = {"train": [], "val": []}
    for i in range(num_images):
        c2w = _ring_pose(i, num_images, cam_radius)
        time = i / max(num_images - 1, 1)
        center = np.array([0.2 * time, 0.0, 0.0]) if times else np.zeros(3)
        rgb, hit = _sphere_view(c2w, focal, width, height, center, radius)
        rgba = np.concatenate([rgb, hit[..., None].astype(np.float64)], -1)
        write_png(out_dir / "train" / f"r_{i}.png", np.round(rgba * 255).astype(np.uint8))
        gl = c2w.copy()
        gl[:3, 1:3] *= -1  # OpenCV's y down, z forward -> OpenGL's y up, z back
        frame = {"file_path": f"./train/r_{i}", "transform_matrix": gl.tolist()}
        if times:
            frame["time"] = time
        splits["val" if i % val_every == 0 else "train"].append(frame)
    for split, frames in splits.items():
        (out_dir / f"transforms_{split}.json").write_text(json.dumps(
            {"camera_angle_x": float(2 * np.arctan(0.5 * width / focal)), "frames": frames}))
    return out_dir


def generate_friends_sphere_dataset(out_dir: Path, num_images: int = 8, width: int = 64,
                                    height: int = 48, radius: float = 0.5,
                                    cam_radius: float = 2.5) -> Path:
    """The sphere in the Friends layout under ``out_dir``: ``cameras.json``
    (a ``file_path``, OpenCV ``camtoworld`` and 3 x 3 ``intrinsics`` a
    frame), ``images/<i>.png`` (the sphere over a grey background) and
    ``segmentations/thing/<i>.png`` (class 1 on the sphere). Returns ``out_dir``."""
    out_dir = Path(out_dir)
    for d in ("images", "segmentations/thing"):
        (out_dir / d).mkdir(parents=True, exist_ok=True)
    focal = 0.8 * width
    frames = []
    for i in range(num_images):
        c2w = _ring_pose(i, num_images, cam_radius)
        rgb, hit = _sphere_view(c2w, focal, width, height, np.zeros(3), radius)
        rgb = np.where(hit[..., None], rgb, 0.5)
        write_png(out_dir / "images" / f"{i:05d}.png", np.round(rgb * 255).astype(np.uint8))
        write_png(out_dir / "segmentations" / "thing" / f"{i:05d}.png", hit.astype(np.uint8))
        intr = [[focal, 0.0, width / 2.0], [0.0, focal, height / 2.0], [0.0, 0.0, 1.0]]
        frames.append({"file_path": f"images/{i:05d}.png", "camtoworld": c2w.tolist(),
                       "intrinsics": intr})
    (out_dir / "cameras.json").write_text(json.dumps({"frames": frames}))
    return out_dir


def _opengl_ring_pose(i: int, n: int, cam_radius: float) -> np.ndarray:
    gl = _ring_pose(i, n, cam_radius)
    gl[:3, 1:3] *= -1  # OpenCV's y down, z forward -> OpenGL's y up, z back
    return gl


def _render_through(gl_c2w: np.ndarray, fx: float, fy: float, cx: float, cy: float, width: int,
                    height: int, distortion: dict, radius: float) -> np.ndarray:
    """The shaded sphere at the origin over a grey background, [H, W, 3]
    uint8, along the rays the port's cameras generate at the pixel centres
    (OpenGL pose, the distortion undone as in training)."""
    import torch

    from sdfstudio_tpu_torch.cameras.camera_utils import get_distortion_params
    from sdfstudio_tpu_torch.cameras.cameras import Cameras

    cams = Cameras.create(camera_to_worlds=gl_c2w[None, :3, :4], fx=fx, fy=fy, cx=cx, cy=cy,
                          width=width, height=height,
                          distortion_params=get_distortion_params(**distortion)[None], device="cpu")
    with torch.no_grad():
        rays = cams.generate_image_rays(0)
    d = rays.directions.numpy().astype(np.float64).reshape(height, width, 3)
    o = np.broadcast_to(gl_c2w[:3, 3], d.shape)
    t, hit = _sphere_trace(o, d, np.zeros(3), radius)
    pts = o + t[..., None] * d
    light = np.array([1.0, 1.0, 1.0]) / np.sqrt(3.0)
    shade = 0.2 + 0.8 * np.clip((pts / radius) @ light, 0, 1)
    albedo = 0.6 + 0.4 * np.cos(4 * pts)
    rgb = np.where(hit[..., None], np.clip(shade[..., None] * albedo, 0, 1), 0.5)
    return np.round(rgb * 255).astype(np.uint8)


def generate_nerfstudio_sphere_dataset(out_dir: Path, num_images: int = 8,
                                       sizes=((48, 36), (40, 30)), radius: float = 0.5,
                                       cam_radius: float = 2.0,
                                       distortion: Optional[dict] = None) -> Path:
    """The sphere in nerfstudio's layout under ``out_dir``: ``images/<i>.png``
    and ``transforms.json`` with an OPENCV camera model, ``k1``, ``k2``,
    ``p1``, ``p2`` at the top level (``CAPTURE_DISTORTION`` by default) and
    each frame's own ``w``, ``h``, ``fl_x``, ``fl_y``, ``cx``, ``cy``: frame
    ``i`` takes ``sizes[i % len(sizes)]`` (W, H), a focal length of 0.8 W.
    Odd frames name their file without ``images/`` (the parser's fallback).
    Returns ``out_dir``."""
    out_dir = Path(out_dir)
    (out_dir / "images").mkdir(parents=True, exist_ok=True)
    dist = dict(CAPTURE_DISTORTION if distortion is None else distortion)
    frames = []
    for i in range(num_images):
        w, h = sizes[i % len(sizes)]
        fx, fy, cx, cy = 0.8 * w, 0.8 * w, w / 2.0 + 0.5, h / 2.0 - 0.25
        gl = _opengl_ring_pose(i, num_images, cam_radius)
        name = f"frame_{i:05d}.png"
        write_png(out_dir / "images" / name, _render_through(gl, fx, fy, cx, cy, w, h, dist, radius))
        frames.append({"file_path": f"images/{name}" if i % 2 == 0 else f"./{name}",
                       "transform_matrix": gl.tolist(), "w": w, "h": h, "fl_x": fx, "fl_y": fy,
                       "cx": cx, "cy": cy})
    (out_dir / "transforms.json").write_text(json.dumps(
        {"camera_model": "OPENCV", **dist, "frames": frames}, indent=1))
    return out_dir


def generate_ngp_sphere_dataset(out_dir: Path, num_images: int = 8, width: int = 48,
                                height: int = 36, radius: float = 0.5, cam_radius: float = 2.0,
                                distortion: Optional[dict] = None) -> Path:
    """The sphere in instant-ngp's layout under ``out_dir``: ``images/<i>.png``
    and ``transforms.json`` with shared intrinsics, ``k1``, ``k2``, ``p1``,
    ``p2`` (``CAPTURE_DISTORTION`` by default), ``aabb_scale`` 1 and each
    pose in ngp's axes (the parser's rows ``[1, 0, 2]`` with row 2 negated
    give back the OpenGL pose). Returns ``out_dir``."""
    out_dir = Path(out_dir)
    (out_dir / "images").mkdir(parents=True, exist_ok=True)
    dist = dict(CAPTURE_DISTORTION if distortion is None else distortion)
    fx = fy = 0.8 * width
    cx, cy = width / 2.0, height / 2.0
    frames = []
    for i in range(num_images):
        gl = _opengl_ring_pose(i, num_images, cam_radius)
        name = f"images/{i:04d}.png"
        write_png(out_dir / name, _render_through(gl, fx, fy, cx, cy, width, height, dist, radius))
        ngp = np.eye(4)
        ngp[0], ngp[1], ngp[2, :4] = gl[1], gl[0], -gl[2]
        frames.append({"file_path": name, "transform_matrix": ngp.tolist()})
    (out_dir / "transforms.json").write_text(json.dumps(
        {"fl_x": fx, "fl_y": fy, "cx": cx, "cy": cy, "w": width, "h": height, "aabb_scale": 1,
         **dist, "frames": frames}, indent=1))
    return out_dir


def _quat_xyzw(R: np.ndarray) -> np.ndarray:
    """The unit quaternion (x, y, z, w) of a rotation matrix, w >= 0."""
    w = np.sqrt(max(1.0 + R[0, 0] + R[1, 1] + R[2, 2], 1e-12)) / 2.0
    if w > 1e-3:
        x, y, z = (R[2, 1] - R[1, 2]) / (4 * w), (R[0, 2] - R[2, 0]) / (4 * w), (R[1, 0] - R[0, 1]) / (4 * w)
    else:  # a half turn: the axis from the largest diagonal entry
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        q = np.zeros(4)
        q[i] = np.sqrt(max(1.0 + R[i, i] - R[j, j] - R[k, k], 1e-12)) / 2.0
        q[j] = (R[j, i] + R[i, j]) / (4 * q[i])
        q[k] = (R[k, i] + R[i, k]) / (4 * q[i])
        q[3] = (R[k, j] - R[j, k]) / (4 * q[i])
        return q * np.sign(q[3] or 1.0)
    return np.array([x, y, z, w])


def generate_record3d_sphere_dataset(out_dir: Path, num_images: int = 12, width: int = 48,
                                     height: int = 36, radius: float = 0.5,
                                     cam_radius: float = 2.0) -> Path:
    """The sphere in Record3D's layout under ``out_dir``: ``rgb/<i>.png`` and
    ``metadata`` (JSON: ``poses`` [N, 7] as quaternion x, y, z, w and
    translation of the OpenCV pose, ``K`` flattened column-major at twice
    the images' resolution, ``w`` and ``h`` of that resolution). Returns
    ``out_dir``."""
    out_dir = Path(out_dir)
    (out_dir / "rgb").mkdir(parents=True, exist_ok=True)
    f = 0.8 * width
    poses = []
    for i in range(num_images):
        gl = _opengl_ring_pose(i, num_images, cam_radius)
        write_png(out_dir / "rgb" / f"{i}.png",
                  _render_through(gl, f, f, width / 2.0, height / 2.0, width, height, {}, radius))
        cv = gl.copy()
        cv[:3, 1:3] *= -1  # the parser negates these columns back
        poses.append([*_quat_xyzw(cv[:3, :3]), *cv[:3, 3]])
    K = np.array([[2 * f, 0.0, width], [0.0, 2 * f, height], [0.0, 0.0, 1.0]])
    (out_dir / "metadata").write_text(json.dumps(
        {"poses": poses, "K": K.T.reshape(-1).tolist(), "w": 2 * width, "h": 2 * height}))
    return out_dir


def write_monosdf_layout(sdfstudio_dir: Path, out_dir: Path, scale: float = 1.5) -> Path:
    """An SDFStudio scene with cues rewritten in MonoSDF's layout under
    ``out_dir``: ``cameras.npz`` with ``world_mat_<i> = [K 0; 0 1] @
    inv(camtoworld)`` and ``scale_mat_<i> = diag(scale, scale, scale, 1)``
    (the normalised scene is the world shrunk by ``scale``), and symbolic
    links to the frames' ``<i>_rgb.png``, ``<i>_depth.npy`` and
    ``<i>_normal.npy`` and to ``pairs.txt``. Returns ``out_dir``."""
    sdfstudio_dir, out_dir = Path(sdfstudio_dir), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    meta = json.loads((sdfstudio_dir / "meta_data.json").read_text())
    mats = {}
    for i, frame in enumerate(meta["frames"]):
        K = np.asarray(frame["intrinsics"], np.float64)
        mats[f"world_mat_{i}"] = K @ np.linalg.inv(np.asarray(frame["camtoworld"], np.float64))
        mats[f"scale_mat_{i}"] = np.diag([scale, scale, scale, 1.0])
        for key, suffix in (("rgb_path", "rgb.png"), ("mono_depth_path", "depth.npy"),
                            ("mono_normal_path", "normal.npy")):
            link = out_dir / f"{i:06d}_{suffix}"
            if key in frame and not link.exists():
                link.symlink_to((sdfstudio_dir / frame[key]).resolve())
    pairs = sdfstudio_dir / "pairs.txt"
    if pairs.exists() and not (out_dir / "pairs.txt").exists():
        (out_dir / "pairs.txt").symlink_to(pairs.resolve())
    np.savez(out_dir / "cameras.npz", **mats)
    return out_dir
