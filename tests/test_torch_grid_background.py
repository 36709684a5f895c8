"""The ``"grid"`` background, the appearance embeddings, ``neus-facto-angelo``
and the trainer's model state against the JAX package, on the CPU.

- SH components at levels 1-5: 1e-6; ``SHEncoding`` takes no gradient.
- ``NerfactoField`` at its full width (hash L16 x F2 at 2^19 rows, max_res
  1024, ``mlp_base`` [32 -> 64 -> 16], ``mlp_head`` [63 -> 64 -> 64 -> 3]
  with a sigmoid, 4 appearance rows) on JAX's perturbed parameters, in
  training (each sample its camera's row), at eval (zeros) and at eval with
  ``use_average_appearance_embedding`` (the mean row): density and rgb to
  1e-5, every parameter's gradient of a weighted sum of both to 1e-4 of its
  scale (max |JAX grad|).
- The SDF field's appearance embedding (``use_appearance_embedding=True``):
  rgb in training and at eval with the mean row to 1e-5, and the
  embedding's gradient (only the batch's camera rows non-zero) to 1e-4 of
  its scale.
- ``neus-facto-angelo``: JAX's registry values and full-size tree, the
  schedules (inv_s override, numerical delta, hash mask, curvature factor)
  at steps from 0 to 1.2M to 1e-6 relative (f32 on both sides), and one
  shrunk step (F = 8 over 6 levels of a 2^10 table, a partial mask, 16 + 8
  proposal samples + 8, the grid background at full width with 4 outside
  samples) held as ``tests/test_torch_occupancy.py`` holds ``neusW``:
  losses to 1e-4, every gradient to 5e-4 of its scale in float32.
- The model state: a JAX packed tree holding an ``OccupancyGrid`` reads
  back leaf for leaf; ``neus-acc`` (its 16^3 grid refreshed every 2 steps,
  jittered by the trainer's generator) resumes bit for bit: 2 steps, save,
  load, 2 steps equal 4 straight steps in the parameters, the grid and the
  generator, under deterministic algorithms.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdfstudio_tpu.core.math import components_from_spherical_harmonics as jsh
from sdfstudio_tpu.core.scene_box import SceneBox as JSceneBox
from sdfstudio_tpu.fields.nerfacto_field import NerfactoField as JNerfactoField
from sdfstudio_tpu.fields.sdf_field import SDFField as JSDFField
from sdfstudio_tpu.fields.sdf_field import SDFFieldConfig as JSDFFieldConfig
from sdfstudio_tpu.samplers import spaced as jspaced

from sdfstudio_tpu_torch.configs.methods import get_method_config
from sdfstudio_tpu_torch.core.math import components_from_spherical_harmonics as tsh
from sdfstudio_tpu_torch.core.scene_box import SceneBox as TSceneBox
from sdfstudio_tpu_torch.fields.nerfacto_field import NerfactoField as TNerfactoField
from sdfstudio_tpu_torch.fields.sdf_field import SDFField as TSDFField
from sdfstudio_tpu_torch.fields.sdf_field import SDFFieldConfig as TSDFFieldConfig
from sdfstudio_tpu_torch.ops.encodings import SHEncoding
from sdfstudio_tpu_torch.samplers import spaced as tspaced
from sdfstudio_tpu_torch.utils.convert import _flatten, _port_key, params_from_jax
from tests.test_torch_background import _bundle, _perturbed
from tests.test_torch_occupancy import _compare_step, _small_models
from tests.test_torch_presets import _full_tree_matches
from tests.test_torch_train import _close, _t
from tests.test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

NUM_CAMS = 4


def _grad_close(port_grads, ref_tree, rtol, prefix=""):
    ref = {_port_key(prefix + k): np.asarray(v) for k, v in _flatten(ref_tree).items()}
    assert set(port_grads) == set(ref)
    for name, g in port_grads.items():
        scale = float(np.abs(ref[name]).max())
        got = np.zeros_like(ref[name]) if g is None else g.numpy()
        assert float(np.abs(got - ref[name]).max()) <= rtol * max(scale, 1e-30), name


def test_sh_components_match_jax():
    d = np.random.default_rng(0).standard_normal((64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    for levels in range(1, 6):
        _close(tsh(levels, _t(d)).numpy(), np.asarray(jsh(levels, jnp.asarray(d))), rtol=1e-6,
               atol=1e-6)
    x = _t(d).requires_grad_(True)
    assert not SHEncoding(4)(x).requires_grad and SHEncoding(4).out_dim == 16


@pytest.fixture(scope="module")
def nerfacto_fields():
    jf = JNerfactoField(spatial_distortion="inf", num_images=NUM_CAMS)
    params = _perturbed(jax.jit(jf.init)(jax.random.PRNGKey(0)), 1)
    rng = np.random.default_rng(2)
    params["encoding"]["hash_table"] = rng.uniform(-0.1, 0.1, params["encoding"]["hash_table"].shape
                                                   ).astype(np.float32)
    tf = TNerfactoField(num_images=NUM_CAMS)
    params_from_jax(tf, params)
    return params, tf


@pytest.mark.parametrize("mode", ["train", "eval", "average"])
def test_nerfacto_field_outputs_and_grads_match_jax(nerfacto_fields, mode):
    params, tf = nerfacto_fields
    average = mode == "average"
    jf = JNerfactoField(spatial_distortion="inf", num_images=NUM_CAMS,
                        use_average_appearance_embedding=average)
    tf.use_average_appearance_embedding = average
    jb, tb = _bundle(R=16, seed=3)
    cams = np.random.default_rng(4).integers(0, NUM_CAMS, 16)
    jb = jb.replace(camera_indices=jnp.asarray(cams, jnp.int32))
    tb = tb.replace(camera_indices=torch.from_numpy(cams))
    js, ts = jspaced.linear_disparity_sampler(jb.replace(fars=jb.fars * 50), 8), \
        tspaced.linear_disparity_sampler(tb.replace(fars=tb.fars * 50), 8)
    w = np.random.default_rng(5).uniform(0, 1, (16, 8, 4)).astype(np.float32)
    train = mode == "train"

    def jloss(p):
        out = jf.get_outputs(p, js, train=train)
        return jnp.sum(out["rgb"] * w[..., :3]) + jnp.sum(out["density"] * w[..., 3]), out

    (_, ref), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params))
    out = tf.get_outputs(ts, train=train)
    for k in ("density", "rgb"):
        _close(out[k].detach(), ref[k])
    assert float(np.asarray(ref["density"]).std()) > 1e-3
    loss = (out["rgb"] * _t(w[..., :3])).sum() + (out["density"] * _t(w[..., 3])).sum()
    names = [n for n, _ in tf.named_parameters()]
    grads = torch.autograd.grad(loss, list(tf.parameters()), allow_unused=True)
    _grad_close(dict(zip(names, grads)), jg, 1e-4)
    emb = dict(zip(names, grads))["embedding_appearance.embedding"]
    assert (emb is not None and float(emb.abs().sum()) > 0) == (mode != "eval")  # the mean row too


def test_sdf_field_appearance_embedding_matches_jax():
    small = dict(num_layers=2, hidden_dim=32, geo_feat_dim=16, num_layers_color=2,
                 hidden_dim_color=32, use_appearance_embedding=True)
    jfield = JSDFField(JSDFFieldConfig(**small), num_images=NUM_CAMS, spatial_distortion="inf",
                       use_average_appearance_embedding=True)
    params = _perturbed(jax.jit(jfield.init)(jax.random.PRNGKey(6)), 7)
    tfield = TSDFField(TSDFFieldConfig(**small), num_images=NUM_CAMS, spatial_distortion="inf",
                       use_average_appearance_embedding=True)
    params_from_jax(tfield, params)
    jb, tb = _bundle(R=12, seed=8)
    cams = np.array([0, 2] * 6)
    jb = jb.replace(camera_indices=jnp.asarray(cams, jnp.int32))
    tb = tb.replace(camera_indices=torch.from_numpy(cams))
    js, ts = jspaced.uniform_sampler(jb, 6), tspaced.uniform_sampler(tb, 6)
    w = np.random.default_rng(9).uniform(0, 1, (12, 6, 3)).astype(np.float32)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)

    def jloss(p):
        rgb = jfield.get_outputs(p, js, train=True)["rgb"]
        # at eval the mean row, no gradient: the forward alone, in the same program
        return jnp.sum(rgb * w), (rgb, jfield.get_outputs(p, js, train=False)["rgb"])

    (_, (ref, ref_eval)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)
    rgb = tfield.get_outputs(ts, train=True)["rgb"]
    _close(rgb.detach(), ref)
    (g,) = torch.autograd.grad((rgb * _t(w)).sum(), [tfield.embedding_appearance.embedding])
    ref_g = np.asarray(jg["embedding_appearance"]["embedding"])
    assert np.all(ref_g[[1, 3]] == 0) and np.all(ref_g[[0, 2]] != 0)
    _close(g.numpy(), ref_g, rtol=0, atol=1e-4 * float(np.abs(ref_g).max()))
    _close(tfield.get_outputs(ts, train=False)["rgb"].detach(), ref_eval)


# --- neus-facto-angelo -----------------------------------------------------------


def test_neus_facto_angelo_tree_and_schedules_match_jax():
    from sdfstudio_tpu.configs.methods import get_method_config as jget_method_config

    port = _full_tree_matches("neus-facto-angelo")
    assert port["field.encoding.hash_table"][1] == 8
    assert port["field_background.mlp_base.layers.0.kernel"] == (32, 64)
    assert port["field_background.mlp_head.layers.0.kernel"] == (63, 64)
    assert port["field.embedding_appearance.embedding"] == (3, 32)
    cfg = get_method_config("neus-facto-angelo")
    assert cfg.optimizers["field_background"].optimizer.kind == "adamw"
    # the schedules read the field's levels and resolutions, not its table: a 2^10 table here
    jcfg = jget_method_config("neus-facto-angelo").model
    jcfg = dataclasses.replace(jcfg, sdf_field=dataclasses.replace(jcfg.sdf_field,
                                                                   log2_hashmap_size=10))
    jmodel = jget_method_config("neus-facto-angelo").model_class(jcfg, JSceneBox(), 3)
    tcfg = dataclasses.replace(cfg.model, sdf_field=dataclasses.replace(cfg.model.sdf_field,
                                                                        log2_hashmap_size=10))
    tmodel = cfg.model_class(tcfg, TSceneBox(), 3)
    for step in [0, 1, 999, 5000, 19999, 20000, 20001, 35000, 80000, 150000, 500000, 1_200_000]:
        js = jmodel.schedules(jnp.asarray(float(step), jnp.float32))
        ts = tmodel.schedules(step)
        for k in ("inv_s_override", "numerical_delta", "curvature_factor", "cos_anneal_ratio"):
            _close(ts[k], js[k], rtol=1e-6, atol=0)
        assert np.array_equal(ts["hash_mask"].numpy(), np.asarray(js["hash_mask"])), step


def test_neus_facto_angelo_shrunk_step_matches_jax():
    kw = dict(near=0.05, far=4.0, radius=1.0, collider_type="near_far")
    sdf = dict(hidden_dim=32, geo_feat_dim=32, hidden_dim_color=32, num_levels=6, base_res=4,
               max_res=64, log2_hashmap_size=10)
    props = ({"hidden_dim": 16, "log2_hashmap_size": 10, "num_levels": 3, "max_res": 64},
             {"hidden_dim": 16, "log2_hashmap_size": 10, "num_levels": 3, "max_res": 256})
    model = dict(num_proposal_samples_per_ray=(16, 8), num_neus_samples_per_ray=8,
                 num_samples_outside=4, proposal_net_args_list=props, level_init=2,
                 steps_per_level=10, curvature_loss_warmup_steps=60, beta_anneal_max_num_iters=100)
    jmodel, np_params, tmodel = _small_models("neus-facto-angelo", JSceneBox(**kw), TSceneBox(**kw),
                                              model, sdf_kw=sdf)
    sched = tmodel.schedules(30)
    assert 0 < float(sched["hash_mask"].sum()) < 48 and 0 < sched["curvature_factor"] < 1
    assert tmodel.field.config.hash_features_per_level == 8
    _compare_step("neus-facto-angelo", jmodel, np_params, tmodel, None, None, 30)


# --- the model state ----------------------------------------------------------------


def test_jax_packed_model_state_reads_back(tmp_path):
    from sdfstudio_tpu.samplers.grid import OccupancyGrid as JGrid
    from sdfstudio_tpu.utils.fast_checkpoint import save_packed

    from sdfstudio_tpu_torch.samplers.grid import OccupancyGrid
    from sdfstudio_tpu_torch.utils.convert import model_state_from_jax
    from sdfstudio_tpu_torch.utils.jax_checkpoint import read_packed

    rng = np.random.default_rng(0)
    grid = JGrid.create(np.array([[-1, -1, -1], [1, 1, 1]], np.float32), 8).replace(
        occs=jnp.asarray(rng.uniform(0, 1, 512).astype(np.float32)),
        binary=jnp.asarray(rng.uniform(0, 1, (8, 8, 8)) < 0.3))
    save_packed(tmp_path, {"params": {"a": jnp.ones(3)}, "model_state": grid,
                           "rng": jax.random.PRNGKey(1)})
    tree, _ = read_packed(tmp_path)
    state = OccupancyGrid.from_state(model_state_from_jax(tree["model_state"]))
    assert state.resolution == 8
    assert np.array_equal(state.binary.numpy(), np.asarray(grid.binary))
    assert np.array_equal(state.occs.numpy(), np.asarray(grid.occs))
    assert np.array_equal(state.aabb.numpy(), np.asarray(grid.aabb))


@pytest.fixture
def deterministic():
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def test_model_state_checkpoint_and_resume_bit_for_bit(tmp_path, deterministic):
    from sdfstudio_tpu_torch.configs.methods import build_model
    from sdfstudio_tpu_torch.data.datamanager import VanillaDataManager
    from sdfstudio_tpu_torch.data.dataparsers.sdfstudio import parse
    from sdfstudio_tpu_torch.data.synthetic import generate_sphere_dataset
    from sdfstudio_tpu_torch.engine.trainer import Trainer

    scene = generate_sphere_dataset(tmp_path / "sphere", num_images=3, width=16, height=16)
    outputs = parse(scene)
    cfg = get_method_config("neus-acc")
    cfg.model = dataclasses.replace(
        cfg.model, grid_resolution=16, grid_update_every=2, num_samples_acc=16, num_samples_outside=4,
        sdf_field=dataclasses.replace(cfg.model.sdf_field, num_layers=2, hidden_dim=32,
                                      geo_feat_dim=16, num_layers_color=2, hidden_dim_color=16))
    dm = VanillaDataManager(dataclasses.replace(cfg.datamanager, train_num_rays_per_batch=16),
                            outputs, device="cpu")

    def setup(out=None):
        model = build_model(cfg, outputs.scene_box, num_train_data=dm.num_train_images,
                            device="cpu").train()
        with torch.no_grad():  # inv_s = e^6 rather than e^3, so that the refresh prunes
            model.field.deviation.fill_(0.6)
        t = Trainer(dataclasses.replace(cfg.trainer, steps_per_log=1000), model, dm, cfg.optimizers,
                    base_dir=out)
        t.setup()
        return t

    def state(t):
        out = {n: p.detach().clone() for n, p in t.model.named_parameters()}
        out.update(occs=t.model_state.occs, binary=t.model_state.binary,
                   generator=t.generator.get_state(), step=torch.tensor(t.step))
        return out

    straight = setup()
    assert straight.model_state.binary.all()  # fully occupied before the first refresh
    for _ in range(4):
        straight.train_step()
    assert not straight.model_state.binary.all()
    first = setup(tmp_path / "run")
    first.train_step(), first.train_step()
    path = first.save_checkpoint(2)
    saved = torch.load(path / "checkpoint.pt", weights_only=True)["model_state"]
    assert torch.equal(saved["binary"], first.model_state.binary) and saved["resolution"] == 16
    resumed = setup()
    resumed.load_checkpoint(tmp_path / "run" / "sdfstudio_models")
    assert torch.equal(resumed.model_state.occs, first.model_state.occs)
    resumed.train_step(), resumed.train_step()
    a, b = state(straight), state(resumed)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
