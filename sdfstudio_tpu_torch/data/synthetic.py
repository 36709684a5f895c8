"""A ray-cast coloured sphere in SDFStudio format (counterpart of
``sdfstudio_tpu/data/synthetic.py::generate_sphere_dataset``, :30-170):
``meta_data.json``, the images, and optionally the monocular depth and
normal cues, the foreground masks and ``pairs.txt``, computed in numpy as
JAX computes them; the PNGs are written by the port's own writer
(``data/png.py``) where JAX uses PIL, with the same pixels. The verify
recipes train on it, and ``final_eval_gt="sphere"`` judges its mesh.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from sdfstudio_tpu_torch.data.png import write_png


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
