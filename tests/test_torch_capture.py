"""Real captures in the port against the JAX package, on the CPU: camera
distortion and the three camera models, the four real-capture parsers
(``nerfstudio-data``, ``instant-ngp-data``, ``record3d-data``,
``monosdf-data``), the COLMAP parsers with distortion and images of
different sizes, the padded image stack, per-image sampling, the eval crop,
the subset image cache, and one ``nerfacto`` train step through
``nerfstudio-data`` on distorted views of two sizes.

- The Newton undistortion and ``generate_rays`` for perspective, fisheye,
  equirectangular and mixed cameras, with and without distortion: float64
  to 1e-10 and float32 to 1e-5 of the normalised coordinate (the pixel
  area to that fraction of a pixel's side).
- Each parser on a small written scene (``data/synthetic.py``): file lists,
  splits and scene boxes exact, cameras to 1e-6 relative; nerfstudio with
  per-frame intrinsics and the ``images/`` fallback under each orientation
  method and camera model; monosdf with each crop type, its cues and
  pairs, and the projection decomposition against ``cv2`` on a ``P`` with
  negative focal signs and one with skew; record3d with subsampling.
- The data manager: ``_pad_stack``, draws inside each image's own extent,
  the eval crop, and the subset cache's ids and swap steps against JAX's.
- One step of the shrunk ``nerfacto`` (``test_torch_density_methods.py``'s
  models) on the parsed cameras at injected pixels: losses to 1e-4,
  gradients to 5e-4 of scale in float32.
"""
import json
import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdfstudio_tpu.cameras import camera_utils as JU
from sdfstudio_tpu.cameras import cameras as JC
from sdfstudio_tpu.data import datamanager as JDM
from sdfstudio_tpu.data.dataparsers import colmap_family as JCF
from sdfstudio_tpu.data.dataparsers import misc_parsers as JM
from sdfstudio_tpu.data.dataparsers import monosdf as JMo
from sdfstudio_tpu.data.dataparsers import nerfstudio_parser as JN
from sdfstudio_tpu.data.dataparsers import sdfstudio as JS

from sdfstudio_tpu_torch.cameras import camera_utils as TU
from sdfstudio_tpu_torch.cameras import cameras as TC
from sdfstudio_tpu_torch.data import datamanager as TDM
from sdfstudio_tpu_torch.data import synthetic
from sdfstudio_tpu_torch.data.dataparsers import colmap_family as TCF
from sdfstudio_tpu_torch.data.dataparsers import misc_parsers as TM
from sdfstudio_tpu_torch.data.dataparsers import monosdf as TMo
from sdfstudio_tpu_torch.data.dataparsers import nerfstudio_parser as TN
from sdfstudio_tpu_torch.data.dataparsers import sdfstudio as TS
from sdfstudio_tpu_torch.data.png import read_png
from tests.test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = {np.float64: 1e-10, np.float32: 1e-5}


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("captures")
    sphere = synthetic.generate_sphere_dataset(root / "sdfstudio", num_images=6, width=16, height=16,
                                               with_mono_prior=True, with_pairs=True, num_pair_srcs=2)
    return {"nerfstudio": synthetic.generate_nerfstudio_sphere_dataset(root / "nerfstudio",
                                                                       num_images=8),
            "ngp": synthetic.generate_ngp_sphere_dataset(root / "ngp", num_images=4, width=20, height=15),
            "record3d": synthetic.generate_record3d_sphere_dataset(root / "record3d", num_images=11,
                                                                   width=20, height=15),
            "sdfstudio": sphere,
            "monosdf": synthetic.write_monosdf_layout(sphere, root / "monosdf")}


# --- undistortion and the three camera models -------------------------------------------


def _dist(rng, n):
    return np.stack([TU.get_distortion_params(k1=rng.uniform(-0.4, 0.4), k2=rng.uniform(-0.1, 0.1),
                                              k3=rng.uniform(-0.02, 0.02), k4=rng.uniform(-0.01, 0.01),
                                              p1=rng.uniform(-0.01, 0.01), p2=rng.uniform(-0.01, 0.01))
                     for _ in range(n)])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_undistort_matches_jax(dtype):
    rng = np.random.default_rng(0)
    coords = rng.uniform(-0.8, 0.8, (3, 500, 2)).astype(dtype)  # out to the corners of a wide lens
    params = _dist(rng, 500).astype(dtype)
    assert np.all(TU.get_distortion_params(1, 2, 3, 4, 5, 6) == JU.get_distortion_params(1, 2, 3, 4, 5, 6))
    with jax.enable_x64(dtype == np.float64):
        ref = np.asarray(JU.radial_and_tangential_undistort(jnp.asarray(coords), jnp.asarray(params)[None]))
    got = TU.radial_and_tangential_undistort(torch.from_numpy(coords), torch.from_numpy(params)[None])
    assert got.dtype == torch.from_numpy(coords).dtype
    assert np.abs(got.numpy() - ref).max() <= TOL[dtype]
    assert np.abs(ref - coords).max() > 0.01  # the distortion moves the points


MODELS = {"perspective": [1] * 6, "fisheye": [2] * 6, "equirectangular": [3] * 6,
          "mixed": [1, 2, 3, 1, 2, 3]}


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("distorted", [True, False])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_generate_rays_matches_jax(model, distorted, dtype):
    rng = np.random.default_rng(1)
    n, R = 6, 400
    c2w = rng.normal(size=(n, 3, 4))
    fx = rng.uniform(30, 60, n)
    fy, cx, cy = 1.1 * fx, rng.uniform(20, 30, n), rng.uniform(15, 20, n)
    dist = _dist(rng, n) if distorted else None
    idx = rng.integers(0, n, R)
    coords = np.stack([rng.uniform(0, 40, R), rng.uniform(0, 50, R)], -1)
    ctype = np.asarray(MODELS[model])
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    with jax.enable_x64(dtype == np.float64):
        jc = JC.Cameras(camera_to_worlds=jnp.asarray(c2w, dtype), fx=jnp.asarray(fx, dtype),
                        fy=jnp.asarray(fy, dtype), cx=jnp.asarray(cx, dtype), cy=jnp.asarray(cy, dtype),
                        width=jnp.full(n, 50), height=jnp.full(n, 40),
                        distortion_params=None if dist is None else jnp.asarray(dist, dtype),
                        camera_type=jnp.asarray(ctype, jnp.int32))
        ref = jc.generate_rays(jnp.asarray(idx), jnp.asarray(coords, dtype))
        ref = {k: np.asarray(getattr(ref, k)) for k in ("origins", "directions", "pixel_area",
                                                        "directions_norm")}
    tc = TC.Cameras.create(c2w, fx, fy, cx, cy, 50, 40, camera_type=ctype, distortion_params=dist,
                           device="cpu")
    # the port's cameras in the case's dtype, from the same values as JAX's
    tc = TC.Cameras(**{**{k: getattr(tc, k) for k in ("width", "height", "camera_type", "times",
                                                      "non_perspective", "distorted")},
                       **{k: torch.as_tensor(v, dtype=tdt) for k, v in
                          (("camera_to_worlds", c2w), ("fx", fx), ("fy", fy), ("cx", cx), ("cy", cy))},
                       "distortion_params": None if dist is None else torch.as_tensor(dist, dtype=tdt)})
    assert tc.distorted == distorted and tc.non_perspective == (model != "perspective")
    got = tc.generate_rays(torch.as_tensor(idx), torch.as_tensor(coords, dtype=tdt))
    tol = TOL[dtype]
    for k in ("origins", "directions", "directions_norm"):
        assert getattr(got, k).dtype == tdt
        assert np.abs(getattr(got, k).numpy() - ref[k]).max() <= tol * max(1.0, np.abs(ref[k]).max()), k
    side = np.sqrt(ref["pixel_area"]).max()  # the area to the tolerance times a pixel's side
    assert np.abs(got.pixel_area.numpy() - ref["pixel_area"]).max() <= tol * side
    if model == "equirectangular" and distorted:  # equirectangular rays skip the undistortion
        plain = tc.generate_rays(torch.as_tensor(idx), torch.as_tensor(coords, dtype=tdt),
                                 disable_distortion=True)
        assert torch.equal(plain.directions, got.directions)


def test_rescale_and_image_rays_match_jax():
    rng = np.random.default_rng(2)
    c2w = rng.normal(size=(2, 3, 4)).astype(np.float32)
    dist = _dist(rng, 2)
    kw = dict(fx=[30.0, 31.0], fy=[32.0, 33.0], cx=[10.0, 11.0], cy=[7.0, 8.0], width=[21, 19],
              height=[15, 13])
    jc = JC.Cameras.create(c2w, **kw, distortion_params=dist, camera_type=2).rescale_output_resolution(0.5)
    tc = TC.Cameras.create(c2w, **kw, distortion_params=dist, camera_type=2,
                           device="cpu").rescale_output_resolution(0.5)
    for k in ("fx", "fy", "cx", "cy", "width", "height"):
        np.testing.assert_array_equal(getattr(tc, k).numpy(), np.asarray(getattr(jc, k)))
    for h, w in ((None, None), (6, 9)):
        ref = jc.generate_image_rays(1, height=h, width=w)
        got = tc.generate_image_rays(1, height=h, width=w)
        assert got.directions.shape == ref.directions.shape == ((h or 6) * (w or 9), 3)
        assert np.abs(got.directions.numpy() - np.asarray(ref.directions)).max() <= 1e-5


# --- the parsers ----------------------------------------------------------------------


def _held(j, t):
    """A JAX parser's outputs against the port's: files, cameras, scene box."""
    assert [str(f) for f in t.image_filenames] == [str(f) for f in j.image_filenames]
    jc, tc = j.cameras, t.cameras
    for k in ("camera_to_worlds", "fx", "fy", "cx", "cy", "width", "height", "distortion_params",
              "camera_type", "times"):
        a, b = getattr(jc, k), getattr(tc, k)
        if k == "camera_type" and a is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
            continue
        assert (a is None) == (b is None), k
        if a is not None:
            a = np.asarray(a, np.float64)
            np.testing.assert_allclose(b.numpy().astype(np.float64), a, rtol=1e-6,
                                       atol=1e-6 * max(1.0, np.abs(a).max()), err_msg=k)
    jb, tb = j.scene_box, t.scene_box
    np.testing.assert_array_equal(tb.aabb, np.asarray(jb.aabb))
    assert (tb.near, tb.far, tb.radius, tb.collider_type) == (jb.near, jb.far, jb.radius,
                                                              jb.collider_type)
    for k in ("depths", "normals"):
        a, b = getattr(j, k), getattr(t, k)
        assert (a is None) == (b is None), k
        for x, y in zip(a or [], b or []):
            np.testing.assert_allclose(y, x, rtol=1e-6, atol=1e-6, err_msg=k)
    assert (j.pairs_srcs is None) == (t.pairs_srcs is None)
    if j.pairs_srcs is not None:
        np.testing.assert_array_equal(t.pairs_srcs, j.pairs_srcs)


@pytest.mark.parametrize("orientation", ["up", "pca", "none"])
@pytest.mark.parametrize("camera_model", ["OPENCV", "OPENCV_FISHEYE", "EQUIRECTANGULAR"])
@pytest.mark.parametrize("split_share", [0.9, 0.75])
def test_nerfstudio_parser_matches_jax(scenes, tmp_path, orientation, camera_model, split_share):
    data = tmp_path / "scene"
    shutil.copytree(scenes["nerfstudio"], data)
    meta = json.loads((data / "transforms.json").read_text())
    meta["camera_model"] = camera_model
    (data / "transforms.json").write_text(json.dumps(meta))
    kw = dict(data=data, orientation_method=orientation, train_split_percentage=split_share)
    for split in ("train", "val"):
        j = JN.Nerfstudio(JN.NerfstudioDataParserConfig(**kw)).get_dataparser_outputs(split)
        t = TN.parse_nerfstudio(TN.NerfstudioDataParserConfig(**kw), split)
        _held(j, t)
        np.testing.assert_allclose(t.metadata["transform"], j.metadata["transform"], atol=1e-6)
        assert t.metadata["scale_factor"] == pytest.approx(j.metadata["scale_factor"], rel=1e-6)
        # per-frame sizes, and the odd frames found under images/ by name
        assert len(set(t.cameras.width.tolist())) == 2
        assert all(f.parent.name == "images" and f.exists() for f in t.image_filenames)
    assert "./" in json.dumps(meta["frames"][1]["file_path"])
    n_val = len(TN.parse_nerfstudio(TN.NerfstudioDataParserConfig(**kw), "val").image_filenames)
    assert n_val == (8 if split_share == 0.9 else 2)  # an empty eval split falls back to every frame


@pytest.mark.parametrize("split", ["train", "val"])
def test_instant_ngp_parser_matches_jax(scenes, split):
    j = JM.InstantNGP(JM.InstantNGPDataParserConfig(data=scenes["ngp"])).get_dataparser_outputs(split)
    t = TM.parse_instant_ngp(TM.InstantNGPDataParserConfig(data=scenes["ngp"]), split)
    _held(j, t)
    assert t.metadata == j.metadata
    # the permutation and the negated row give back the OpenGL poses the scene was drawn with
    ring = synthetic._opengl_ring_pose(2, 4, 2.0)[:3]
    np.testing.assert_allclose(t.cameras.camera_to_worlds[2].numpy(), ring, atol=1e-6)
    assert t.cameras.distorted


@pytest.mark.parametrize("max_size", [150, 7])
@pytest.mark.parametrize("split", ["train", "val"])
def test_record3d_parser_matches_jax(scenes, max_size, split):
    kw = dict(data=scenes["record3d"], max_dataset_size=max_size, val_skip=3)
    j = JM.Record3D(JM.Record3DDataParserConfig(**kw)).get_dataparser_outputs(split)
    t = TM.parse_record3d(TM.Record3DDataParserConfig(**kw), split)
    _held(j, t)
    assert float(t.cameras.fx[0]) == pytest.approx(0.8 * 20)  # K at twice the size, rescaled
    names = np.asarray(sorted(f"{i}.png" for i in range(11)))  # the glob's order
    kept = names[np.round(np.linspace(0, 10, 7)).astype(int)] if max_size == 7 else names
    pos = np.arange(len(kept))
    want = kept[pos % 3 != 0] if split == "train" else kept[::3]
    assert [f.name for f in t.image_filenames] == want.tolist()


@pytest.mark.parametrize("crop", ["center_crop_for_dtu", "center_crop_for_tnt",
                                  "center_crop_for_replica", "no_crop"])
@pytest.mark.parametrize("split", ["train", "val"])
def test_monosdf_parser_matches_jax(scenes, crop, split):
    kw = dict(data=scenes["monosdf"], center_crop_type=crop, include_mono_prior=True,
              load_pairs=True, skip_every_for_val_split=4)
    j = JMo.MonoSDFScene(JMo.MonoSDFDataParserConfig(**kw)).get_dataparser_outputs(split)
    t = TMo.parse_monosdf(TMo.MonoSDFDataParserConfig(**kw), split)
    _held(j, t)
    assert t.metadata == j.metadata
    assert len(t.image_filenames) == (6 if split == "train" else 2)
    assert (t.pairs_srcs is not None) == (split == "train")
    if crop == "no_crop":  # the scale matrix shrinks the world by 1.5
        meta = json.loads((scenes["sdfstudio"] / "meta_data.json").read_text())
        pose = np.asarray(meta["frames"][0]["camtoworld"])
        np.testing.assert_allclose(t.cameras.camera_to_worlds[0, :, 3].numpy(), pose[:3, 3] / 1.5,
                                   atol=1e-5)


def _projections():
    """Projections with positive, negative and mixed focal signs, skew, and
    a negative K[2, 2], and two of no camera at all."""
    rng = np.random.default_rng(3)
    out = []
    for sx, sy, s22, skew in ((1, 1, 1, 0), (-1, 1, 1, 0), (1, -1, 1, 0), (-1, -1, 1, 0),
                              (1, 1, -1, 0), (1, 1, 1, 7.5), (-1, 1, 1, -4.0)):
        K = np.array([[sx * 500.0, skew, 320], [0, sy * 480.0, 240], [0, 0, s22]])
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        R = q * np.sign(np.linalg.det(q))
        C = rng.normal(size=3) * 2
        out.append((K @ np.concatenate([R, -R @ C[:, None]], 1)).astype(np.float32))
    out += [rng.normal(size=(3, 4)).astype(np.float32) for _ in range(2)]
    return out


@pytest.mark.parametrize("i", range(9))
def test_projection_decomposition_matches_cv2_and_jax(i):
    import cv2

    P = _projections()[i]
    K, R, t = cv2.decomposeProjectionMatrix(P)[:3]
    k2, r2, t2 = TMo.decompose_projection(P)
    assert k2.dtype == r2.dtype == t2.dtype == np.float32
    np.testing.assert_allclose(k2, K, rtol=1e-5, atol=1e-5 * np.abs(K).max())
    np.testing.assert_allclose(r2, R, atol=1e-5)
    np.testing.assert_allclose((t2[:3] / t2[3]), (t[:3] / t[3]), rtol=1e-5, atol=1e-5)
    (ji, jp), (ti, tp) = JMo.load_K_Rt_from_P(P), TMo.load_K_Rt_from_P(P)
    np.testing.assert_allclose(ti, ji, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tp, jp, rtol=1e-6, atol=1e-5)
    assert np.all(np.diag(K)[:2] >= 0)  # cv2's signs: a positive focal diagonal


def test_sdfstudio_parser_reads_any_camera_model(scenes, tmp_path):
    data = tmp_path / "scene"
    shutil.copytree(scenes["sdfstudio"], data)
    meta = json.loads((data / "meta_data.json").read_text())
    meta["camera_model"] = "PINHOLE"
    (data / "meta_data.json").write_text(json.dumps(meta))
    for split in ("train", "val"):
        j = JS.SDFStudio(JS.SDFStudioDataParserConfig(data=data)).get_dataparser_outputs(split)
        t = TS.parse_config(TS.SDFStudioDataParserConfig(data=data), split)
        _held(j, t)
        assert t.cameras.distortion_params is None and not t.cameras.non_perspective


def _write_colmap(root: pathlib.Path) -> pathlib.Path:
    """A COLMAP text model of 6 images under two OPENCV cameras of different
    sizes and a SIMPLE_RADIAL one, with points seen by 3-4 images each."""
    sparse = root / "sparse" / "0"
    sparse.mkdir(parents=True)
    (sparse / "cameras.txt").write_text(
        "# cameras\n1 OPENCV 40 30 32 33 20 15 -0.1 0.02 0.001 -0.002\n"
        "2 OPENCV 48 36 38 37 24 18 -0.05 0.01 0.0 0.001\n3 SIMPLE_RADIAL 44 33 30 22 16 0.04\n")
    rng = np.random.default_rng(4)
    lines = []
    for i in range(6):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        t = rng.normal(size=3)
        lines.append(f"{i + 1} {' '.join(map(str, q))} {' '.join(map(str, t))} {i % 3 + 1} img_{i:02d}.png")
        lines.append("")
    (sparse / "images.txt").write_text("\n".join(lines) + "\n")
    pts = [f"{p + 1} {' '.join(map(str, rng.normal(size=3)))} 10 20 30 0.5 "
           + " ".join(f"{(p + k) % 6 + 1} 0" for k in range(3 + p % 2)) for p in range(40)]
    (sparse / "points3D.txt").write_text("\n".join(pts) + "\n")
    return root


@pytest.mark.parametrize("parser", ["mipnerf360", "heritage"])
def test_colmap_parsers_keep_distortion_and_sizes_as_jax(tmp_path, parser):
    data = _write_colmap(tmp_path / "colmap")
    for split in ("train", "val"):
        if parser == "mipnerf360":
            j = JCF.Mipnerf360(JCF.Mipnerf360DataParserConfig(data=data)).get_dataparser_outputs(split)
            t = TCF.parse_mipnerf360(TCF.Mipnerf360DataParserConfig(data=data), split)
        else:
            j = JCF.Heritage(JCF.HeritageDataParserConfig(data=data)).get_dataparser_outputs(split)
            t = TCF.parse_heritage(TCF.HeritageDataParserConfig(data=data), split)
            np.testing.assert_array_equal(t.scene_box.coarse_binary_grid,
                                          np.asarray(j.scene_box.coarse_binary_grid))
        _held(j, t)
        assert t.cameras.distorted and len(set(t.cameras.width.tolist())) > 1


# --- the data manager -----------------------------------------------------------------


def test_pad_stack_matches_jax():
    rng = np.random.default_rng(5)
    for shapes in ([(3, 4, 3), (5, 2, 3), (4, 4, 3)], [(3, 4), (5, 2)], [(2, 2, 1)] * 3):
        arrays = [rng.uniform(size=s).astype(np.float32) for s in shapes]
        np.testing.assert_array_equal(TDM._pad_stack(arrays), JDM._pad_stack(arrays))


def _outputs(scenes):
    cfg = dict(data=scenes["nerfstudio"], train_split_percentage=0.75)
    return (JN.Nerfstudio(JN.NerfstudioDataParserConfig(**cfg)),
            lambda split: TN.parse_nerfstudio(TN.NerfstudioDataParserConfig(**cfg), split))


def test_draws_stay_in_each_image_and_eval_crops_match_jax(scenes):
    jparser, tparse = _outputs(scenes)
    jdm = JDM.VanillaDataManager(JDM.DataManagerConfig(), jparser.get_dataparser_outputs("train"),
                                 jparser.get_dataparser_outputs("val"))
    tdm = TDM.VanillaDataManager(TDM.DataManagerConfig(), tparse("train"), tparse("val"), device="cpu")
    assert tdm.variable_res and jdm.variable_res
    assert (tdm.image_height, tdm.image_width) == (jdm.image_height, jdm.image_width) == (36, 48)
    np.testing.assert_array_equal(tdm.train_data["image"].numpy(), np.asarray(jdm.train_data["image"]))
    idx, batch = tdm.sample_train_batch(torch.Generator().manual_seed(0), num_rays=20000)
    cam, y, x = idx.unbind(-1)
    h, w = tdm.image_heights[cam], tdm.image_widths[cam]
    assert bool(((y < h) & (x < w)).all()) and bool(((y == h - 1) & (h == 30)).any())
    assert bool(((x == w - 1) & (w == 48)).any())
    np.testing.assert_array_equal(batch["image"].numpy(), tdm.train_data["image"][cam, y, x].numpy())
    for i in range(tdm.num_eval_images):
        got, ref = tdm.eval_image_data(i)["image"].numpy(), np.asarray(jdm.eval_image_data(i)["image"])
        np.testing.assert_array_equal(got, ref)
        f = tparse("val").image_filenames[i]
        np.testing.assert_array_equal(got, read_png(f)[..., :3].astype(np.float32) / 255.0)


def test_subset_cache_matches_jax(scenes):
    jparser, tparse = _outputs(scenes)
    jcfg = JDM.DataManagerConfig(train_num_images_to_sample_from=3, train_num_times_to_repeat_images=2)
    tcfg = TDM.DataManagerConfig(train_num_images_to_sample_from=3, train_num_times_to_repeat_images=2)
    jdm = JDM.VanillaDataManager(jcfg, jparser.get_dataparser_outputs("train"))
    tdm = TDM.VanillaDataManager(tcfg, tparse("train"), device="cpu")
    assert tdm.subset_mode and tdm.num_train_images == 6 and tdm.num_eval_images == 6
    shapes = {k: tuple(v.shape) for k, v in tdm.train_data.items()}
    swaps = []
    for step in range(0, 10):
        if step:
            tdm.maybe_resample(step)
            jdm.maybe_resample(step)
        ids = tdm.train_data["_global_ids"].tolist()
        assert ids == np.asarray(jdm.train_data["_global_ids"]).tolist(), step
        if not swaps or swaps[-1][1] != ids:
            swaps.append((step, ids))
        assert {k: tuple(v.shape) for k, v in tdm.train_data.items()} == shapes
        np.testing.assert_array_equal(tdm.train_data["image"].numpy(), np.asarray(jdm.train_data["image"]))
        idx, batch = tdm.sample_train_batch(torch.Generator().manual_seed(step), num_rays=512)
        assert set(idx[:, 0].tolist()) <= set(ids)  # global camera ids, not slots
        slot = torch.as_tensor([ids.index(c) for c in idx[:, 0].tolist()])
        np.testing.assert_array_equal(batch["image"].numpy(),
                                      tdm.train_data["image"][slot, idx[:, 1], idx[:, 2]].numpy())
    assert [s for s, _ in swaps] == [0, 2, 4, 6, 8]
    # without an eval split, the eval images come from the whole stack on the host
    for i in (0, 5):
        np.testing.assert_array_equal(tdm.eval_image_data(i)["image"].numpy(),
                                      np.asarray(jdm.eval_image_data(i)["image"]))
    with pytest.raises(ValueError, match="subset"):
        TDM.FlexibleDataManager(tcfg, tparse("train"), device="cpu")


# --- one nerfacto step through nerfstudio-data -----------------------------------------


def test_nerfacto_step_on_distorted_views_of_two_sizes_matches_jax(tmp_path):
    from sdfstudio_tpu_torch.configs.methods import get_method_config
    from sdfstudio_tpu_torch.engine.optimizers import build_optimizers
    from sdfstudio_tpu_torch.engine.setup import optimizer_groups
    from sdfstudio_tpu_torch.engine.trainer import group_grads, loss_and_metrics
    from tests.test_torch_density_methods import (NUM_IMAGES, SMALL, STEP, _jax_step, _models,
                                                  _port_rays)
    from tests.test_torch_train import _close, _port_tree, _t

    data = synthetic.generate_nerfstudio_sphere_dataset(tmp_path / "ns", num_images=NUM_IMAGES,
                                                        sizes=((16, 12), (20, 15)), cam_radius=2.5)
    jout = JN.Nerfstudio(JN.NerfstudioDataParserConfig(data=data)).get_dataparser_outputs("train")
    tout = TN.parse_nerfstudio(TN.NerfstudioDataParserConfig(data=data), "train")
    jcams, tcams = jout.cameras, tout.cameras
    assert tcams.distorted and len(set(tcams.width.tolist())) == 2
    jmodel, np_params, tmodel = _models("nerfacto", SMALL)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    # pixels inside each view's own size; the colours from the padded stacks of both packages
    rng = np.random.default_rng(6)
    R = 24
    cam = rng.integers(0, NUM_IMAGES, R).astype(np.int32)
    hs, ws = tcams.height.numpy()[cam], tcams.width.numpy()[cam]
    yx = np.stack([np.floor(rng.uniform(size=R) * hs), np.floor(rng.uniform(size=R) * ws)], -1)
    stack = TDM.stack_images(tout)["image"]
    np.testing.assert_array_equal(stack, JDM.VanillaDataManager._stack(jout)["image"])
    yi, xi = yx.astype(int).T
    batch = {"image": stack[cam, yi, xi]}
    coords = yx.astype(np.float32)
    (ref_total, ref_ld), jg = _jax_step(jmodel, jparams, jcams, cam, coords, batch, jnp.float32)
    opts = build_optimizers(optimizer_groups(get_method_config("nerfacto")), tmodel)
    tsched = tmodel.schedules(STEP)
    total, ld, _ = loss_and_metrics(tmodel, _port_rays(tmodel, tcams, cam, coords),
                                    {k: _t(v) for k, v in batch.items()}, tsched)
    assert sorted(ld) == sorted(ref_ld)
    for k in ld:
        _close(ld[k].detach(), ref_ld[k], rtol=1e-4, atol=0)
    _close(total.detach(), ref_total, rtol=1e-4, atol=0)
    grads = group_grads(total, opts)
    ref_g = _port_tree({g: jg[g] for g in opts})
    seen = 0
    for group, opt in opts.items():
        for name, g in zip(opt.names, grads[group]):
            ref = ref_g[name]
            if g is None:
                assert not np.any(ref), name
                continue
            scale = float(np.abs(ref).max())
            assert scale > 0, name
            assert float(np.abs(g.numpy() - ref).max()) <= 5e-4 * scale, name
            seen += 1
    assert "camera_opt.pose_adjustment" in opts["camera_opt"].names and seen >= 12


@pytest.mark.parametrize("method,parser,flag", [
    ("nerfacto", "nerfstudio-data", ["--downscale-factor", "2"]),
    ("instant-ngp", "instant-ngp-data", ["--scene-scale", "0.5"]),
    ("monosdf", "monosdf-data", ["--center-crop-type", "no_crop", "--include-mono-prior", "True"]),
    ("nerfacto", "record3d-data", ["--val-skip", "4"])])
def test_capture_argv_gives_jax_config_tree(method, parser, flag):
    from sdfstudio_tpu_torch.scripts import train as train_script
    from tests.test_torch_cli import _held, _jax_tree, _strip

    argv = [method, "--pipeline.datamanager.train-num-images-to-sample-from", "4",
            "--pipeline.datamanager.train-num-times-to-repeat-images", "8", "--vis", "none",
            parser, "--data", "some/scene", *flag]
    config, _ = train_script.parse_args(argv)
    assert type(config.dataparser) is train_script.DATAPARSERS[parser]
    assert (config.datamanager.train_num_images_to_sample_from,
            config.datamanager.train_num_times_to_repeat_images) == (4, 8)
    ref = _jax_tree(argv)
    fields = len(__import__("dataclasses").fields(config.dataparser))
    assert _held(_strip(config.to_dict())["dataparser"], ref["dataparser"]) >= fields
    assert _held(_strip(config.to_dict())["datamanager"], ref["datamanager"]) >= 6


def test_train_and_eval_commands_on_views_of_two_sizes(tmp_path):
    """``nerfacto nerfstudio-data`` through the port's command line on
    distorted views of two sizes with the subset cache, then ``eval.py``:
    each eval view rendered at its own size against its cropped image."""
    from sdfstudio_tpu_torch.engine.final_eval import render_image
    from sdfstudio_tpu_torch.engine.setup import eval_setup
    from sdfstudio_tpu_torch.scripts import eval as eval_script
    from sdfstudio_tpu_torch.scripts import train as train_script

    data = synthetic.generate_nerfstudio_sphere_dataset(tmp_path / "ns", num_images=4,
                                                        sizes=((16, 12), (20, 15)))
    argv = ["nerfacto", "--device", "cpu", "--vis", "none", "--output-dir", str(tmp_path),
            "--experiment-name", "x", "--timestamp", "t", "--trainer.max-num-iterations", "3",
            "--trainer.steps-per-eval-image", "2", "--datamanager.train-num-rays-per-batch", "32",
            "--pipeline.model.num-proposal-samples-per-ray", "(16,8)",
            "--pipeline.model.num-nerf-samples-per-ray", "4",
            "--pipeline.model.eval-num-rays-per-chunk", "256",
            "--pipeline.datamanager.train-num-images-to-sample-from", "1",
            "--pipeline.datamanager.train-num-times-to-repeat-images", "1",
            "nerfstudio-data", "--data", str(data), "--train-split-percentage", "0.5"]
    assert train_script.main(argv) == 0
    config = tmp_path / "x" / "nerfacto" / "t" / "config.yml"
    assert eval_script.main(["--load-config", str(config), "--output-path",
                             str(tmp_path / "e.json"), "--device", "cpu"]) == 0
    ev = json.loads((tmp_path / "e.json").read_text())
    assert ev["num_images"] == 2 and all(np.isfinite(v) for v in ev["results"].values())
    _, trainer = eval_setup(config, device="cpu")
    dm = trainer.datamanager
    assert dm.subset_mode and dm.variable_res and dm.train_cameras.distorted
    for i in range(dm.num_eval_images):
        h, w = int(dm.eval_cameras.height[i]), int(dm.eval_cameras.width[i])
        rgb = render_image(trainer.model, dm.eval_cameras, i, step=trainer.step)["rgb"]
        assert tuple(rgb.shape) == (h, w, 3) == tuple(dm.eval_image_data(i)["image"].shape)
    assert {int(dm.eval_cameras.width[i]) for i in range(2)} == {16, 20}
