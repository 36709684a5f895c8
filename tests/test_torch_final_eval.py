"""The port's final evaluation against the JAX package's.

- ``psnr`` and ``ssim`` (utils/metrics.py) against JAX's on seeded images of
  384x384 and 17x23: f32 on both sides, 1e-6.
- Marching tetrahedra (``csrc/marching_tets.cc`` through the port's g++
  loader) against JAX's ``marching_tetrahedra`` on a seeded 33^3 grid of
  the scene's analytic SDF: both run the same C++, so the welded vertices
  and faces are the same bits; and a grid with no crossing.
- ``evaluate_sdf_grid`` of the small model of tests/test_torch_model.py
  against JAX's at 24^3: the field's SDF tolerance, 1e-5.
- The Chamfer judge against ``synthetic_dtu.chamfer_l1_to_gt`` on the same
  vertices: the same float64 numpy and scipy, 1e-12 relative.
- ``eval_all_images`` against JAX's on the small model for 2 views
  (``max_images=2``) at the trained step: PSNR to 1e-3 dB, SSIM to 1e-5.
- The eval split against JAX's parser for the split options.

The generator at the end (``slow``) writes the JAX CPU reference that
``chip_smoke.py`` holds the card's eval to.
"""
import json
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdfstudio_tpu.data.dataparsers.sdfstudio import SDFStudio as JSDFStudio
from sdfstudio_tpu.data.dataparsers.sdfstudio import SDFStudioDataParserConfig as JParserConfig
from sdfstudio_tpu.data import synthetic_dtu as jdtu
from sdfstudio_tpu.engine import final_eval as jfe
from sdfstudio_tpu.engine.trainer import Trainer as JTrainer
from sdfstudio_tpu.utils import marching_cubes as jmc
from sdfstudio_tpu.utils import metrics as jmetrics

from sdfstudio_tpu_torch.data import synthetic_dtu as tdtu
from sdfstudio_tpu_torch.data.dataparsers.sdfstudio import parse
from sdfstudio_tpu_torch.engine import final_eval as tfe
from sdfstudio_tpu_torch.utils import marching_cubes as tmc
from sdfstudio_tpu_torch.utils import metrics as tmetrics
from sdfstudio_tpu_torch.utils.mesh_io import TriMesh

from test_torch_model import _cameras, _small_models

REPO = pathlib.Path(__file__).resolve().parents[1]
SCENE = REPO / ".parity" / "dtu_like"
P8_RUN = REPO / ".parity/runs/parity/neus-facto-tpu-p8/parity/sdfstudio_models"
STEP = 20000
REFERENCE = REPO / "sdfstudio_tpu_torch" / "engine" / "jax_cpu_eval_p8_20k.json"
REFERENCE_VIEWS = (0, 24, 48)  # JAX's even spread for max_images=3: linspace(0, 48, 3)


@pytest.mark.parametrize("hw", [(384, 384), (17, 23)])
def test_psnr_and_ssim_match_jax(hw):
    rng = np.random.default_rng(hw[0])
    gt = rng.uniform(0, 1, (*hw, 3)).astype(np.float32)
    pred = np.clip(gt + rng.normal(0, 0.05, gt.shape), 0, 1).astype(np.float32)
    for fn in ("psnr", "ssim"):
        ref = float(getattr(jmetrics, fn)(jnp.asarray(pred), jnp.asarray(gt)))
        out = float(getattr(tmetrics, fn)(torch.from_numpy(pred), torch.from_numpy(gt)))
        assert abs(out - ref) <= 1e-6 * max(1.0, abs(ref)), (fn, out, ref)
    assert tfe.psnr is tmetrics.psnr  # the re-export callers import


def _gt_grid(n=33, lo=-0.75, hi=0.75):
    """The scene's SDF on an n^3 grid, jittered from a seed so that no value
    sits exactly on a tie."""
    ax = np.linspace(lo, hi, n)
    p = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1)
    jitter = np.random.default_rng(0).uniform(-1e-3, 1e-3, p.shape[:3])
    return (tdtu.gt_sdf(p) + jitter).astype(np.float32), lo, (hi - lo) / (n - 1)


def test_marching_tetrahedra_matches_jax_bit_for_bit():
    grid, lo, h = _gt_grid()
    kw = dict(level=0.0, origin=(lo,) * 3, spacing=(h,) * 3)
    ref = jmc.marching_tetrahedra(grid, **kw).merge_close_vertices()
    out = tmc.marching_tetrahedra(grid, **kw).merge_close_vertices()
    assert len(out.vertices) > 1000 and len(out.faces) > 2000
    assert out.vertices.dtype == np.asarray(ref.vertices).dtype
    assert np.array_equal(out.vertices, ref.vertices)
    assert np.array_equal(out.faces, ref.faces)
    # no crossing: an all-positive grid gives an empty mesh in both
    empty = tmc.marching_tetrahedra(np.abs(grid) + 1.0, **kw)
    assert len(empty.vertices) == 0 and len(empty.faces) == 0
    assert len(jmc.marching_tetrahedra(np.abs(grid) + 1.0, **kw).vertices) == 0


def test_mesh_export_writes_binary_ply(tmp_path):
    from sdfstudio_tpu.utils.mesh_io import read_ply

    grid, lo, h = _gt_grid(17)
    mesh = tmc.marching_tetrahedra(grid, 0.0, (lo,) * 3, (h,) * 3).merge_close_vertices()
    mesh.export(tmp_path / "m.ply")
    back = read_ply(tmp_path / "m.ply")
    assert np.array_equal(np.asarray(back.vertices, np.float32), mesh.vertices.astype(np.float32))
    assert np.array_equal(np.asarray(back.faces), mesh.faces)


@pytest.fixture(scope="module", params=["neus-facto-tpu-p8", "neus-facto"])
def models(request):
    return _small_models(request.param)


def test_evaluate_sdf_grid_matches_jax(models):
    jmodel, jparams, _, tmodel = models
    lo, hi = np.full(3, -1.0, np.float32), np.full(3, 1.0, np.float32)
    ref = jmc.evaluate_sdf_grid(jmodel.field.sdf_fn(jparams["field"]), 24, lo, hi, chunk=4096)
    out = tmc.evaluate_sdf_grid(tmodel.field.sdf, 24, lo, hi, "cpu", chunk=4096)
    assert out.shape == ref.shape == (24, 24, 24) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    assert out.min() < 0 < out.max()  # the grid holds a surface


def test_surface_sliding_matches_jax(models):
    """The whole extraction at 32^3 in two blocks a side: the two grids
    agree to 1e-5, so the meshes agree in vertex count to 1%, 99% of the
    vertices to 1e-4 and every vertex to a cell."""
    jmodel, jparams, _, tmodel = models
    kw = dict(resolution=32, block_res=16, bounding_box_min=(-1.0,) * 3, bounding_box_max=(1.0,) * 3)
    ref = jmc.get_surface_sliding(jmodel.field.sdf_fn(jparams["field"]), **kw)
    seconds = {}
    out = tmc.get_surface_sliding(tmodel.field.sdf, "cpu", seconds=seconds, **kw)
    assert set(seconds) == {"grid", "marching_tets", "merge"}
    assert len(ref.vertices) > 100
    assert abs(len(out.vertices) - len(ref.vertices)) <= 0.01 * len(ref.vertices)
    from scipy.spatial import cKDTree

    d, _ = cKDTree(ref.vertices).query(out.vertices)
    assert np.quantile(d, 0.99) < 1e-4 and d.max() < 2.0 / 31


def test_chamfer_judge_matches_jax():
    grid, lo, h = _gt_grid(49, -0.8, 0.8)
    verts = tmc.marching_tetrahedra(grid, 0.0, (lo,) * 3, (h,) * 3).merge_close_vertices().vertices
    ref = jdtu.chamfer_l1_to_gt(verts)
    out = tdtu.chamfer_l1_to_gt(verts)
    assert out["n_pred_cropped"] == ref["n_pred_cropped"] > 1000
    for k in ("accuracy", "completeness", "chamfer_l1"):
        assert abs(out[k] - ref[k]) <= 1e-12 * abs(ref[k]), (k, out[k], ref[k])
    assert ref["chamfer_l1"] < 0.02  # a 49^3 mesh of the true surface is close to it
    assert np.isinf(tdtu.chamfer_l1_to_gt(np.full((4, 3), 0.9, np.float32))["chamfer_l1"])


def test_eval_all_images_matches_jax(models):
    """Two views of the small model at the trained step, against JAX's
    ``eval_all_images`` (8192-ray chunks, PSNR and SSIM on the device)."""
    jmodel, jparams, _, tmodel = models
    from sdfstudio_tpu.cameras.cameras import Cameras as JCameras
    from sdfstudio_tpu_torch.cameras.cameras import Cameras as TCameras

    c2w = np.concatenate([np.asarray(_cameras(facing=f)[0].camera_to_worlds).reshape(1, 3, 4)
                          for f in (True, False)])
    # 16x20 views: SSIM's 11x11 window needs at least 11 pixels a side
    kw = dict(fx=22.0, fy=23.0, cx=10.0, cy=8.0, width=20, height=16)
    jcams, tcams = JCameras.create(c2w, **kw), TCameras.create(c2w, device="cpu", **kw)
    rng = np.random.default_rng(5)
    gts = rng.uniform(0, 1, (2, 16, 20, 3)).astype(np.float32)

    jtrainer = types.SimpleNamespace(
        model=jmodel,
        state=types.SimpleNamespace(step=jnp.asarray(STEP, jnp.int32), params=jparams, model_state=None),
        datamanager=types.SimpleNamespace(
            num_eval_images=2, eval_image_rays=jcams.generate_image_rays,
            eval_image_data=lambda i: {"image": jnp.asarray(gts[i])}),
    )
    jtrainer._render_chunk_impl = types.MethodType(JTrainer._render_chunk_impl, jtrainer)
    ref = jfe.eval_all_images(jtrainer, max_images=2)
    ttrainer = types.SimpleNamespace(
        model=tmodel, step=STEP,
        datamanager=types.SimpleNamespace(
            num_eval_images=2, eval_cameras=tcams, train_cameras=tcams,
            eval_image_data=lambda i: {"image": torch.from_numpy(gts[i])}),
    )
    out = tfe.eval_all_images(ttrainer, max_images=2)
    assert out["num_images"] == ref["num_images"] == 2 and out["views"] == [0, 1]
    assert abs(out["psnr"] - ref["psnr"]) <= 1e-3
    assert abs(out["ssim"] - ref["ssim"]) <= 1e-5
    assert len(out["per_image"]) == 2
    assert abs(np.mean([p for p, _ in out["per_image"]]) - out["psnr"]) < 1e-9


@pytest.mark.parametrize("skip,no_overlap", [(1, False), (8, False), (8, True)])
def test_eval_split_matches_jax(skip, no_overlap):
    cfg = JParserConfig(data=SCENE, skip_every_for_val_split=skip, train_val_no_overlap=no_overlap)
    for split in ("train", "val"):
        ref = JSDFStudio(cfg).get_dataparser_outputs(split)
        out = parse(SCENE, split, skip, no_overlap)
        assert [p.name for p in out.image_filenames] == [p.name for p in ref.image_filenames]
        np.testing.assert_array_equal(out.cameras.camera_to_worlds.numpy(),
                                      np.asarray(ref.cameras.camera_to_worlds))
        np.testing.assert_array_equal(out.cameras.fx.numpy(), np.asarray(ref.cameras.fx).reshape(-1))
    n_val = len(parse(SCENE, "val", skip, no_overlap).image_filenames)
    assert n_val == {1: 49, 8: 7}[skip]


def test_datamanager_eval_images_and_rays():
    """The eval split's images and rays on the port's data manager."""
    from sdfstudio_tpu_torch.data.datamanager import DataManagerConfig, VanillaDataManager

    dm = VanillaDataManager(DataManagerConfig(), parse(SCENE, "train", 8, True),
                            parse(SCENE, "val", 8, True), device="cpu")
    assert dm.num_train_images == 42 and dm.num_eval_images == 7
    val = parse(SCENE, "val", 8, True)
    from sdfstudio_tpu_torch.data.png import load_image

    img = dm.eval_image_data(2)["image"]
    assert torch.equal(img, torch.from_numpy(load_image(val.image_filenames[2])[..., :3]))
    rays = dm.eval_image_rays(2)
    ref = val.cameras.generate_image_rays(2)
    assert torch.equal(rays.origins, ref.origins) and torch.equal(rays.directions, ref.directions)


@pytest.mark.slow
def test_write_jax_cpu_eval_reference(tmp_path):
    """Generator of ``sdfstudio_tpu_torch/engine/jax_cpu_eval_p8_20k.json``:
    JAX's per-image PSNR and SSIM of views 0, 24 and 48 of the committed
    20k ``neus-facto-tpu-p8`` checkpoint, rendered in f32 on the CPU through
    the program ``eval_all_images`` builds (``_build_image_metrics_fn`` at
    the trained step), in the model's 1024-ray chunks: at the eval's 8192
    XLA's CPU program passed 20 GB of host memory, and no ray's render
    depends on the chunk it is in. Run it with

        python -m pytest tests/test_torch_final_eval.py -m slow -k jax_cpu_eval_reference -p no:xdist

    (a few minutes and a few GB of host memory)."""
    from sdfstudio_tpu.configs.methods import get_method_config
    from sdfstudio_tpu.engine import final_eval as jfe
    from sdfstudio_tpu.engine.setup import setup_trainer

    assert jax.default_backend() == "cpu"
    config = get_method_config("neus-facto-tpu-p8")
    config.data = SCENE
    config.output_dir = tmp_path
    trainer = setup_trainer(config, test_mode=True)
    trainer.setup()
    trainer._load_checkpoint(P8_RUN, STEP)
    dm = trainer.datamanager
    chunk = trainer.model.config.eval_num_rays_per_chunk
    idxs = np.unique(np.linspace(0, dm.num_eval_images - 1, 3).astype(int))
    assert tuple(idxs) == REFERENCE_VIEWS
    step = trainer.state.step.astype(jnp.float32)
    psnr, ssim = [], []
    for i in REFERENCE_VIEWS:
        gt = dm.eval_image_data(i)["image"][..., :3]
        h, w = int(gt.shape[0]), int(gt.shape[1])
        fn = jfe._build_image_metrics_fn(trainer, h, w, chunk)
        bundle = jfe._chunked(dm.eval_image_rays(i), h * w, chunk)
        p, s = fn(trainer.state.params, bundle, gt, step, trainer.state.model_state)
        psnr.append(float(p))
        ssim.append(float(s))
    rec = {
        "what": "JAX per-image eval of the committed 20k neus-facto-tpu-p8 checkpoint, f32 on the CPU",
        "checkpoint": str((P8_RUN / f"step-{STEP:09d}").relative_to(REPO)),
        "step": STEP,
        "chunk": chunk,
        "jax": jax.__version__,
        "command": "python -m pytest tests/test_torch_final_eval.py -m slow -k jax_cpu_eval_reference -p no:xdist",
        "views": list(REFERENCE_VIEWS),
        "psnr": psnr,
        "ssim": ssim,
    }
    REFERENCE.write_text(json.dumps(rec, indent=1) + "\n")
    assert all(np.isfinite(psnr)) and all(20.0 < p < 60.0 for p in psnr)
