"""The port's data path and trainer against the JAX package, on the
committed DTU-like scene (``.parity/dtu_like``).

- The PNG reader is bit-exact against the JAX ``load_image`` (PIL) on every
  PNG of the scene: it decodes the same bytes.
- The dataparser's cameras and scene box against the JAX parser's: the same
  f32 values, so 0 tolerance on the poses and intrinsics.
- Rays from the data manager for a batch of (camera, y, x) indices across
  many cameras against the JAX data manager's: f32 camera math, 1e-5.
- The trainer on the CPU through the train entry point: the proposal nets
  move on an update step and stay bit-for-bit on a frozen one.
"""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdfstudio_tpu.data.datamanager import DataManagerConfig as JDataManagerConfig
from sdfstudio_tpu.data.datamanager import VanillaDataManager as JVanillaDataManager
from sdfstudio_tpu.data.dataparsers.base import load_image as jload_image
from sdfstudio_tpu.data.dataparsers.sdfstudio import SDFStudio as JSDFStudio
from sdfstudio_tpu.data.dataparsers.sdfstudio import SDFStudioDataParserConfig as JParserConfig

from sdfstudio_tpu_torch.data import png
from sdfstudio_tpu_torch.data.datamanager import DataManagerConfig, VanillaDataManager
from sdfstudio_tpu_torch.data.dataparsers.sdfstudio import parse
from sdfstudio_tpu_torch.scripts import train as train_script
from tests.test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

SCENE = pathlib.Path(__file__).resolve().parents[1] / ".parity" / "dtu_like"


@pytest.fixture(scope="module")
def parsed():
    if not (SCENE / "meta_data.json").is_file():
        pytest.fail(f"the committed scene is missing: {SCENE}")
    return (JSDFStudio(JParserConfig(data=SCENE)).get_dataparser_outputs("train"),
            parse(SCENE))


def test_png_reader_is_bit_exact_on_every_scene_png():
    files = sorted(SCENE.glob("*.png"))
    assert len(files) == 98  # 49 views, an RGB image and a mask each
    for f in files:
        ours, ref = png.load_image(f), jload_image(f)
        assert ours.dtype == ref.dtype and ours.shape == ref.shape, f.name
        assert np.array_equal(ours, ref), f.name


def test_png_reader_refuses_what_it_cannot_read(tmp_path):
    data = bytearray((SCENE / "000000_foreground_mask.png").read_bytes())
    data[24] = 16  # IHDR bit depth -> 16
    (tmp_path / "deep.png").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="bit depth 16"):
        png.read_png(tmp_path / "deep.png")
    (tmp_path / "not.png").write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        png.read_png(tmp_path / "not.png")


def test_dataparser_matches_jax(parsed):
    jout, tout = parsed
    assert [p.name for p in tout.image_filenames] == [p.name for p in jout.image_filenames]
    jc, tc = jout.cameras, tout.cameras
    np.testing.assert_array_equal(tc.camera_to_worlds.numpy(), np.asarray(jc.camera_to_worlds))
    for k in ("fx", "fy", "cx", "cy", "width", "height"):
        np.testing.assert_array_equal(getattr(tc, k).numpy(), np.asarray(getattr(jc, k)).reshape(-1))
    np.testing.assert_array_equal(tout.scene_box.aabb, np.asarray(jout.scene_box.aabb))
    for k in ("near", "far", "radius", "collider_type"):
        assert getattr(tout.scene_box, k) == getattr(jout.scene_box, k)


def test_datamanager_rays_and_pixels_match_jax(parsed):
    jout, tout = parsed
    jdm = JVanillaDataManager(JDataManagerConfig(train_num_rays_per_batch=64), jout)
    tdm = VanillaDataManager(DataManagerConfig(train_num_rays_per_batch=64), tout, device="cpu")
    assert tuple(tdm.train_data["image"].shape) == (49, 384, 384, 3)
    np.testing.assert_array_equal(tdm.train_data["image"].numpy(), np.asarray(jdm.train_data["image"]))
    idx, batch = tdm.sample_train_batch(torch.Generator().manual_seed(0))
    assert idx.shape == (64, 3) and len(set(idx[:, 0].tolist())) > 10  # many cameras at once
    cam, y, x = idx.unbind(-1)
    np.testing.assert_array_equal(batch["image"].numpy(),
                                  np.asarray(jdm.train_data["image"])[cam.numpy(), y.numpy(), x.numpy()])
    jrb = jdm.generate_rays(None, jnp.asarray(idx.numpy().astype(np.int32)), train=True)
    trb = tdm.generate_rays(idx)
    for k in ("origins", "directions", "pixel_area", "directions_norm"):
        np.testing.assert_allclose(getattr(trb, k).numpy(), np.asarray(getattr(jrb, k)),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("method", ["neus-facto-tpu-p8", "neus-facto"])
def test_train_entry_point_and_frozen_proposal_step(method, tmp_path):
    """Twelve steps at 16 rays on the CPU: step 10 (index 10, an update)
    moves the proposal nets, step 11 (frozen) leaves them bit-for-bit."""
    assert train_script.main([method, "--data", str(SCENE), "--device", "cpu",
                              "--output-dir", str(tmp_path), "--vis", "none",
                              "--trainer.max-num-iterations", "2",
                              "--datamanager.train-num-rays-per-batch", "16"]) == 0
    trainer = train_script.setup_method_trainer(method, SCENE, num_rays=16, device="cpu")
    prop = trainer.optimizers["proposal_networks"]
    moved = []
    for step in range(12):
        before = [p.detach().clone() for p in prop.params]
        metrics = trainer.train_step()
        assert bool(torch.isfinite(metrics).all())
        moved.append(any(not torch.equal(a, b) for a, b in zip(before, prop.params)))
    assert moved[10] and not moved[11]
    assert trainer.step == 12 and prop.count == 12
    assert set(trainer.metric_keys) >= {"loss", "rgb_loss", "eikonal_loss", "interlevel_loss", "psnr"}
