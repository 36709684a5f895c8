"""The committed 20k ``neus-facto-tpu-p8`` checkpoint, rendered by JAX and by the port.

The JAX side builds its trainer from the method config, with the parity
scene resolved against the repository root (the run's ``config.yml`` holds
absolute paths of the machine that trained it), and restores the packed
train state through the trainer's own loader. The port takes the restored
``params`` through ``params_from_jax``. Both render the same 16 rays of eval
view 0 at the checkpoint's step. Nothing is written into the tree: the
trainer's output directory is the test's temporary directory.

Tolerance: the slice tolerance of tests/test_torch_model.py (3e-4 on rgb,
accumulation and normal; depth compared weighted by accumulation), for the
same reason: sample positions agree to a few f32 ulps of the ray distance,
not to the bit, and NeuS alpha scales a position change by inv_s |grad sdf|.
"""
import pathlib

import jax
import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
RUN = REPO / ".parity/runs/parity/neus-facto-tpu-p8/parity/sdfstudio_models"
STEP = 20000
TOL = 3e-4


@pytest.fixture(scope="module")
def restored(tmp_path_factory):
    if not (RUN / f"step-{STEP:09d}" / "packed.npz").exists():
        pytest.fail(f"committed checkpoint missing under {RUN}")
    from sdfstudio_tpu.configs.methods import get_method_config
    from sdfstudio_tpu.engine.setup import setup_trainer

    config = get_method_config("neus-facto-tpu-p8")
    config.data = REPO / ".parity" / "dtu_like"
    config.output_dir = tmp_path_factory.mktemp("p8_ckpt")
    trainer = setup_trainer(config, test_mode=True)
    trainer.setup()
    trainer._load_checkpoint(RUN, STEP)
    return trainer


def test_checkpoint_renders_the_same_in_jax_and_the_port(restored):
    from sdfstudio_tpu_torch.configs.methods import build_model
    from sdfstudio_tpu_torch.core.rays import RayBundle
    from sdfstudio_tpu_torch.core.scene_box import SceneBox
    from sdfstudio_tpu_torch.utils.convert import params_from_jax

    trainer = restored
    assert int(trainer.state.step) == STEP
    bundle = trainer.datamanager.eval_image_rays(0)
    # 16 pixels across the centre row of the 384x384 view
    sel = 192 * 384 + np.arange(0, 384, 24)
    jb = jax.tree_util.tree_map(
        lambda x: x[sel] if hasattr(x, "ndim") and x.ndim >= 1 and x.shape[0] == 384 * 384 else x,
        bundle,
    )
    ref = trainer._render_chunk(trainer.state.params, jb, float(STEP), None)

    sb = trainer.model.scene_box
    model = build_model(
        "neus-facto-tpu-p8",
        SceneBox(aabb=np.asarray(sb.aabb), near=sb.near, far=sb.far, radius=sb.radius,
                 collider_type=sb.collider_type),
        num_train_data=trainer.datamanager.num_train_images,
        device="cpu",
    )
    params_from_jax(model, jax.tree_util.tree_map(np.asarray, trainer.state.params))

    def t(x):
        return torch.from_numpy(np.array(x))

    tb = RayBundle(
        origins=t(jb.origins), directions=t(jb.directions), pixel_area=t(jb.pixel_area),
        camera_indices=t(jb.camera_indices).long(), directions_norm=t(jb.directions_norm),
    )
    out = model.get_outputs(tb, sched=model.schedules(STEP))

    acc = np.asarray(ref["accumulation"])
    assert acc.max() > 0.9, "the rays should hit the scene"
    for k in ("rgb", "accumulation"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=0, atol=TOL, err_msg=k)
    np.testing.assert_allclose(out["depth"].numpy() * out["accumulation"].numpy(),
                               np.asarray(ref["depth"]) * acc, rtol=0, atol=4.0 * TOL)
    # The analytic gradient of the piecewise-linear encode jumps at simplex
    # faces (cells of 1/512 of the box at the finest level): a sample that
    # sits within the ~6e-6 position disagreement of a face takes the other
    # side's jacobian, which moves that sample's normal by the jump times its
    # weight. Normals are therefore held to 2e-3 end to end, and to the
    # field's own 1e-4 on identical samples below.
    np.testing.assert_allclose(out["normal"].numpy(), np.asarray(ref["normal"]), rtol=0, atol=2e-3)

    jm = trainer.model
    sched = jm.schedules(float(STEP))

    @jax.jit
    def jax_field(params, rb):
        s = jm.sample_and_forward_field(params, jm.apply_collider(rb, train=False), None, sched,
                                        False)
        return s["ray_samples"].starts, s["ray_samples"].ends, s["field_outputs"]

    starts, ends, jf = jax_field(trainer.state.params, jb)
    ts = tb.get_ray_samples(t(np.concatenate([np.asarray(starts), np.asarray(ends)[:, -1:]], -1)))
    with torch.no_grad():
        tf = model.field.get_outputs(ts, cos_anneal_ratio=float(sched["cos_anneal_ratio"]),
                                     return_alphas=True)
    for k in ("sdf", "rgb", "gradient", "normal", "alpha"):
        np.testing.assert_allclose(tf[k].numpy(), np.asarray(jf[k]), rtol=1e-4, atol=1e-4, err_msg=k)
