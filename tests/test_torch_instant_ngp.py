"""``instant-ngp`` against the JAX package, on the CPU, and its dynamic
batch through the port's command line.

- The occupancy refresh (the grid's EMA at the field's densities) on the
  same uniforms: JAX's ``jax.random.uniform`` draws from its key, handed to
  the port as a callable. ``occs`` to 1e-5 of scale; ``binary`` exactly,
  but for cells within 1e-5 of the threshold.
- Shrunk (a 16^3 grid, 24 steps of 0.1 a ray, 4 hash levels), JAX's
  parameters (perturbed) carried in by ``params_from_jax``, on JAX's
  refreshed grid: at eval the rgb, accumulation, depth and samples a ray;
  in training, with the jitter and the random background drawn from JAX's
  key and handed to the port, the loss dict to 1e-4 relative and every
  gradient to 5e-4 of its scale in float32 and 1e-4 in float64.
- ``instant-ngp ... sdfstudio-data`` trains on the CPU through the port's
  command line: the bucket starts at ``target_num_samples /
  max_num_samples_per_ray``, moves on the measured samples, and a deferred
  run writes ``dynamic_batch.txt``, which the next run of that directory
  starts from.
"""
import copy
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdfstudio_tpu.configs.methods import get_method_config as jget_method_config
from sdfstudio_tpu.core.rays import RayBundle as JRayBundle
from sdfstudio_tpu.core.scene_box import SceneBox as JSceneBox

from sdfstudio_tpu_torch.configs.methods import MethodConfig, build_model, get_method_config
from sdfstudio_tpu_torch.core.rays import RayBundle as TRayBundle
from sdfstudio_tpu_torch.core.scene_box import SceneBox as TSceneBox
from sdfstudio_tpu_torch.engine.optimizers import build_optimizers
from sdfstudio_tpu_torch.engine.trainer import group_grads, loss_and_metrics
from sdfstudio_tpu_torch.scripts import train as train_script
from sdfstudio_tpu_torch.utils.convert import params_from_jax
from tests.test_torch_occupancy import _jax_state_to_port
from tests.test_torch_train import _close, _port_tree, _t
from tests.test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = pathlib.Path(__file__).resolve().parents[1]
SCENE = REPO / ".parity" / "dtu_like"
NUM_IMAGES = 4
AABB = np.asarray([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]], np.float32)
SMALL = dict(grid_resolution=16, max_num_samples_per_ray=24, render_step_size=0.1)


def _models(seed=0):
    jcfg = jget_method_config("instant-ngp")
    jmc = dataclasses.replace(jcfg.model, **SMALL)
    jmodel = jcfg.model_class(jmc, JSceneBox(aabb=AABB), NUM_IMAGES)
    # 4 hash levels: the field's sizes are the registered ones otherwise
    jmodel.field = dataclasses.replace(jmodel.field, num_levels=4, max_res=64, log2_hashmap_size=10)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        a = np.asarray(a)
        if "hash_table" in jax.tree_util.keystr(path):
            return rng.uniform(-2.0, 2.0, a.shape).astype(np.float32)
        return (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32)

    np_params = jax.tree_util.tree_map_with_path(perturb, params)
    # sparse density: some cells fall below the opacity threshold
    np_params["field"]["mlp_base"]["layer_1"]["bias"][0] -= 3.0
    tcfg = dataclasses.replace(get_method_config("instant-ngp").model, **SMALL)
    tmodel = build_model(MethodConfig("small-instant-ngp", get_method_config("instant-ngp").model_class,
                                      tcfg), TSceneBox(aabb=AABB), NUM_IMAGES, device="cpu")
    from sdfstudio_tpu_torch.fields.nerfacto_field import NerfactoField

    tmodel.field = NerfactoField(aabb=AABB, spatial_distortion=None, num_images=NUM_IMAGES,
                                 use_appearance_embedding=False, num_levels=4, max_res=64,
                                 log2_hashmap_size=10)
    params_from_jax(tmodel, np_params)
    return jmodel, np_params, tmodel


def _given(*arrays):
    """The port's ``rng``: JAX's draws, handed over by shape."""
    by_shape = {tuple(a.shape): torch.from_numpy(np.array(a)) for a in arrays}
    return lambda shape: by_shape[tuple(shape)]


@pytest.fixture(scope="module")
def refreshed():
    """Both models and both grids after one refresh from JAX's key."""
    jmodel, np_params, tmodel = _models()
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    key = jax.random.PRNGKey(11)
    jgrid = jax.jit(lambda p: jmodel.update_model_state(p, jmodel.init_model_state(), 0, key))(jparams)
    u = np.asarray(jax.random.uniform(key, (16**3, 3)))  # grid.py:47-48
    tgrid = tmodel.update_model_state(tmodel.init_model_state(), 0, _given(u))
    return jmodel, np_params, tmodel, jgrid, tgrid


def test_occupancy_refresh_matches_jax(refreshed):
    _, _, _, jgrid, tgrid = refreshed
    occs, ref = tgrid.occs.numpy(), np.asarray(jgrid.occs)
    assert float(np.abs(occs - ref).max()) <= 1e-5 * float(np.abs(ref).max())
    thresh = min(0.01, float(ref.mean()))
    clear = np.abs(ref - thresh) > 1e-5
    assert np.array_equal(tgrid.binary.numpy().reshape(-1)[clear],
                          np.asarray(jgrid.binary).reshape(-1)[clear])
    assert 0.1 < float(np.asarray(jgrid.binary).mean()) < 0.9  # a grid with holes


def _rays(R=24, seed=6):
    rng = np.random.default_rng(seed)
    o = rng.standard_normal((R, 3))
    o = (1.2 * o / np.linalg.norm(o, axis=-1, keepdims=True)).astype(np.float32)
    d = rng.uniform(-0.3, 0.3, (R, 3)) - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    pa = np.full((R, 1), 1e-5, np.float32)
    ci = rng.integers(0, NUM_IMAGES, R).astype(np.int32)
    jb = JRayBundle(jnp.asarray(o), jnp.asarray(d), jnp.asarray(pa), camera_indices=jnp.asarray(ci))
    tb = TRayBundle(_t(o), _t(d), _t(pa), camera_indices=torch.from_numpy(ci.astype(np.int64)))
    return jb, tb, {"image": rng.uniform(0, 1, (R, 3)).astype(np.float32)}


def _jax_step(jmodel, params, jb, batch, grid, key):
    @jax.jit
    def jloss(params):
        out = jmodel.get_outputs(params, jb, rng=key, sched={}, train=True, model_state=grid)
        ld = jmodel.get_loss_dict(params, out, {k: jnp.asarray(v) for k, v in batch.items()}, {}, None)
        return sum(ld.values()), (ld, jmodel.get_metrics_dict(params, out,
                                                              {k: jnp.asarray(v) for k, v in
                                                               batch.items()}))

    return jax.value_and_grad(jloss, has_aux=True)(params)


def test_eval_outputs_and_train_step_match_jax(refreshed, monkeypatch):
    from sdfstudio_tpu.ops import mlp as jmlp

    from tests.test_torch_cue_methods import _F64Dot, _f64, _port_f64

    jmodel, np_params, tmodel, jgrid, tgrid = refreshed
    tgrid = _jax_state_to_port(jgrid, tgrid)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    jb, tb, batch = _rays()
    ref = jax.jit(lambda p: jmodel.get_outputs(p, jb, rng=None, train=False, model_state=jgrid))(jparams)
    out = tmodel.get_outputs(tb, train=False, model_state=tgrid)
    for k in ("rgb", "accumulation", "depth"):
        scale = float(np.abs(np.asarray(ref[k])).max())
        assert float(np.abs(out[k].numpy() - np.asarray(ref[k])).max()) <= 1e-5 * scale, k
    assert np.array_equal(out["num_samples_per_ray"].numpy(), np.asarray(ref["num_samples_per_ray"]))
    n = np.asarray(ref["num_samples_per_ray"])
    assert 0 < n.min() and n.max() < 24  # rays through occupied and empty cells
    # one training step: the jitter and the background from JAX's key (instant_ngp.py:96-113)
    key = jax.random.PRNGKey(12)
    k0, k1 = jax.random.split(key, 2)
    R = tb.origins.shape[0]
    uniforms = (np.asarray(jax.random.uniform(k0, (R, 1))), np.asarray(jax.random.uniform(k1, (R, 3))))
    (ref_total, (ref_ld, ref_m)), jg = _jax_step(jmodel, jparams, jb, batch, jgrid, key)
    opts = build_optimizers(get_method_config("instant-ngp").optimizers, tmodel)
    total, ld, metrics = loss_and_metrics(tmodel, tb, {k: _t(v) for k, v in batch.items()}, {},
                                          rng=_given(*uniforms), model_state=tgrid)
    assert sorted(ld) == sorted(ref_ld) == ["rgb_loss"]
    _close(total.detach(), ref_total, rtol=1e-4, atol=0)
    assert float(metrics["num_samples_per_batch"]) == float(ref_m["num_samples_per_batch"])
    grads = group_grads(total, opts)
    ref_g = _port_tree({"field": jg["field"]})
    monkeypatch.setenv("SST_MLP_DTYPE", "float64")
    monkeypatch.setattr(jmlp, "jnp", _F64Dot())
    with jax.enable_x64():
        g64grid = jgrid.replace(occs=_f64(jgrid.occs), aabb=_f64(jgrid.aabb))
        _, jg64 = _jax_step(jmodel, jax.tree_util.tree_map(_f64, np_params),
                            jax.tree_util.tree_map(_f64, jb), {k: _f64(v) for k, v in batch.items()},
                            g64grid, key)
        # under x64 the key draws float64 uniforms, other numbers than float32's
        uniforms64 = (np.asarray(jax.random.uniform(k0, (R, 1))),
                      np.asarray(jax.random.uniform(k1, (R, 3))))
    assert uniforms64[0].dtype == np.float64
    ref_g64 = _port_tree({"field": jg64["field"]})
    m64 = copy.deepcopy(tmodel).double()
    total64, _, _ = loss_and_metrics(m64, _port_f64(tb), {k: _t(v).double() for k, v in batch.items()},
                                     {}, rng=_given(*uniforms64),
                                     model_state=_port_f64(tgrid))
    names = [n for n, _ in m64.named_parameters()]
    g64 = dict(zip(names, torch.autograd.grad(total64, list(m64.parameters()), allow_unused=True)))
    seen = 0
    for name, g in zip(opts["field"].names, grads["field"]):
        scale, scale64 = float(np.abs(ref_g[name]).max()), float(np.abs(ref_g64[name]).max())
        assert scale > 0, name
        assert float(np.abs(g.numpy() - ref_g[name]).max()) <= 5e-4 * scale, name
        assert float(np.abs(g64[name].numpy() - ref_g64[name]).max()) <= 1e-4 * scale64, name
        seen += 1
    assert seen == 11  # the table, mlp_base's two layers and mlp_head's three, kernels and biases


def test_cli_dynamic_batch_on_the_cpu(tmp_path, capsys):
    """Two runs of one directory: the first moves its bucket every step on
    the measured samples; the second, deferred, writes
    ``dynamic_batch.txt``; a third starts from it."""
    base = ["instant-ngp", "--device", "cpu", "--vis", "none", "--output-dir", str(tmp_path),
            "--experiment-name", "x", "--timestamp", "t", "--trainer.steps-per-log", "1",
            "--trainer.steps-per-eval-image", "0", "--trainer.dynamic-update-every", "1",
            "--trainer.target-num-samples", "8192", "--pipeline.model.grid-resolution", "16",
            "--pipeline.model.max-num-samples-per-ray", "16"]
    parser = ["sdfstudio-data", "--data", str(SCENE)]
    assert train_script.main(base + ["--trainer.max-num-iterations", "2"] + parser) == 0
    out = capsys.readouterr().out
    assert "num_rays_per_batch=512" in out  # 8192 / 16
    assert "[dynamic-batch] rays/batch 512 ->" in out  # the grid leaves rays short of 16 samples
    run = tmp_path / "x" / "instant-ngp" / "t"
    assert (run / "config.yml").exists()
    deferred = base + ["--trainer.max-num-iterations", "4", "--trainer.defer-heavy-ops", "True",
                       "--trainer.load-dir", str(run / "sdfstudio_models")]
    assert train_script.main(deferred + parser) == 0
    saved = int((run / "sdfstudio_models" / "dynamic_batch.txt").read_text())
    assert saved in {256 * 2**k for k in range(10)}
    config, _ = train_script.parse_args(base + ["--trainer.max-num-iterations", "4"] + parser)
    from sdfstudio_tpu_torch.engine.setup import setup_trainer

    trainer = setup_trainer(config, device="cpu")
    trainer.setup()
    assert trainer.dyn_num_rays == saved and trainer.num_rays_per_batch() == saved
