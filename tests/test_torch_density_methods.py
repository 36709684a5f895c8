"""The density methods ``nerfacto`` and ``phototourism`` against the JAX
package, on the CPU, and the registered trees of all three density methods.

- The registered entries (``instant-ngp``, ``nerfacto``, ``phototourism``):
  every model, trainer and data-manager field and every optimizer group
  against JAX's, the full-size parameter shapes against JAX's
  ``eval_shape`` (the port's model on the ``meta`` device), and JAX's argv
  with a parser subcommand and a camera-optimizer override parsed to JAX's
  config tree.
- ``nerfacto`` shrunk (4 hash levels, 16 + 8 proposal samples and 8 field
  samples, 2-level proposal grids), with ``predict_normals`` off and on and
  with ``use_same_proposal_network``, and ``phototourism`` on the
  phototourism parser's cameras: JAX's parameters (perturbed) carried in by
  ``params_from_jax``, the pose table set off the identity on both sides,
  rays from the same cameras through each package's camera optimizer, no
  jitter (``rng=None``). At eval the rendered rgb, accumulation and depths
  to 1e-5 of scale, the normals (a normalised derivative) to 1e-4; one training step's loss dict to 1e-4
  relative, and every gradient, ``camera_opt.pose_adjustment`` included,
  to 5e-4 of its scale (max |JAX grad|) in float32 and to 1e-4 in float64
  (JAX under ``jax.enable_x64`` with its dense layers in float64).
- A JAX packed checkpoint of ``nerfacto`` with its ``camera_opt`` group
  (two optax updates) loads leaf for leaf, Adam's state too.
"""
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sdfstudio_tpu.cameras.camera_optimizers import CameraOptimizer as JCameraOptimizer
from sdfstudio_tpu.cameras.camera_optimizers import CameraOptimizerConfig as JCOConfig
from sdfstudio_tpu.cameras.cameras import Cameras as JCameras
from sdfstudio_tpu.configs.methods import get_method_config as jget_method_config
from sdfstudio_tpu.core.scene_box import SceneBox as JSceneBox

from sdfstudio_tpu_torch.cameras.camera_optimizers import CameraOptimizer, CameraOptimizerConfig
from sdfstudio_tpu_torch.cameras.cameras import Cameras
from sdfstudio_tpu_torch.configs.methods import (MethodConfig, build_model, get_method_config,
                                                 method_configs)
from sdfstudio_tpu_torch.core.scene_box import SceneBox as TSceneBox
from sdfstudio_tpu_torch.engine.optimizers import build_optimizers
from sdfstudio_tpu_torch.engine.setup import CAMERA_OPT_GROUP, optimizer_groups
from sdfstudio_tpu_torch.engine.trainer import group_grads, loss_and_metrics
from sdfstudio_tpu_torch.scripts import train as train_script
from sdfstudio_tpu_torch.utils.convert import load_jax_checkpoint, params_from_jax
from tests.test_torch_train import _close, _port_tree, _t
from tests.test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = pathlib.Path(__file__).resolve().parents[1]
HERITAGE = REPO / ".parity" / "heritage_like"
DENSITY = ("instant-ngp", "nerfacto", "phototourism")
NUM_IMAGES = 4
STEP = 30  # the proposals train on this step: thr = 1, period 2
AABB = np.asarray([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]], np.float32)
SMALL = dict(num_levels=4, max_res=64, log2_hashmap_size=10, num_proposal_samples_per_ray=(16, 8),
             num_nerf_samples_per_ray=8,
             proposal_net_args_list=({"hidden_dim": 16, "log2_hashmap_size": 8, "num_levels": 2,
                                      "max_res": 32},
                                     {"hidden_dim": 16, "log2_hashmap_size": 8, "num_levels": 2,
                                      "max_res": 64}))


# --- the registered entries -----------------------------------------------------------


@pytest.mark.parametrize("method", DENSITY)
def test_registered_entry_matches_jax(method):
    jcfg, tcfg = jget_method_config(method), get_method_config(method)
    for f in dataclasses.fields(tcfg.model):
        assert getattr(tcfg.model, f.name) == getattr(jcfg.model, f.name), f.name
    for f in dataclasses.fields(tcfg.trainer):
        assert getattr(tcfg.trainer, f.name) == getattr(jcfg.trainer, f.name), f.name
    for k in ("train_num_rays_per_batch", "eval_num_rays_per_batch", "kind"):
        assert getattr(tcfg.datamanager, k) == getattr(jcfg.datamanager, k), k
    assert tcfg.datamanager.camera_optimizer.mode == jcfg.datamanager.camera_optimizer.mode
    assert type(tcfg.dataparser).__name__ == type(jcfg.dataparser).__name__
    assert set(tcfg.optimizers) == set(jcfg.optimizers)
    for g, og in tcfg.optimizers.items():
        jo = jcfg.optimizers[g]
        for k in ("kind", "lr", "eps", "weight_decay"):
            assert getattr(og.optimizer, k) == getattr(jo.optimizer, k), (g, k)
        assert (og.scheduler is None) == (jo.scheduler is None)
        if og.scheduler is not None:
            assert (og.scheduler.kind, og.scheduler.max_steps) == (jo.scheduler.kind,
                                                                   jo.scheduler.max_steps)
    groups = optimizer_groups(tcfg)
    assert ("camera_opt" in groups) == (method != "instant-ngp")
    if method != "instant-ngp":  # setup.py:57-64
        o = groups["camera_opt"].optimizer
        assert groups["camera_opt"] is CAMERA_OPT_GROUP and groups["camera_opt"].scheduler is None
        assert (o.kind, o.lr, o.eps, o.weight_decay) == ("adam", 6e-4, 1e-8, 1e-2)
    jmodel = jcfg.model_class(jcfg.model, JSceneBox(aabb=AABB), NUM_IMAGES)
    abstract = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    views = jax.tree_util.tree_map(lambda a: np.broadcast_to(np.zeros((), a.dtype), a.shape), abstract)
    shapes = {k: v.shape for k, v in _port_tree(views).items()}
    with torch.device("meta"):
        tmodel = tcfg.model_class(tcfg.model, TSceneBox(aabb=AABB), NUM_IMAGES)
    assert {n: tuple(p.shape) for n, p in tmodel.named_parameters()} == shapes
    assert len(method_configs) == 30


@pytest.mark.parametrize("method,parser", [("instant-ngp", "blender-data"), ("nerfacto", "blender-data"),
                                           ("phototourism", "phototourism-data"),
                                           ("nerfacto", "sdfstudio-data")])
def test_argv_gives_jax_config_tree(method, parser):
    from tests.test_torch_cli import _held, _jax_tree, _strip

    argv = [method, "--experiment-name", "e1", "--vis", "none", "--timestamp", "ts",
            "--pipeline.datamanager.camera-optimizer.mode", "SE3",
            "--pipeline.model.eval-num-rays-per-chunk", "512",
            "--trainer.max-num-iterations", "300", "--trainer.dynamic-update-every", "7",
            parser, "--data", "some/scene"]
    config, port = train_script.parse_args(argv)
    assert port == {"device": None, "deterministic": False}
    assert _held(_strip(config.to_dict()), _jax_tree(argv)) > 40
    assert config.datamanager.camera_optimizer.mode == "SE3"
    assert type(config.dataparser) is train_script.DATAPARSERS[parser]


# --- one step of nerfacto and phototourism ---------------------------------------------


def _look_at(n, radius, seed):
    """Camera-to-world poses [n, 3, 4] on a sphere of ``radius``, each
    looking (down its -z) at a point near the origin."""
    rng = np.random.default_rng(seed)
    c2w = np.zeros((n, 3, 4), np.float32)
    for i in range(n):
        eye = rng.standard_normal(3)
        eye = radius * eye / np.linalg.norm(eye)
        z = eye - rng.uniform(-0.2, 0.2, 3)
        z /= np.linalg.norm(z)
        x = np.cross([0.0, 0.0, 1.0], z)
        x /= np.linalg.norm(x)
        c2w[i] = np.stack([x, np.cross(z, x), z, eye], axis=1)
    return c2w


def _cameras(method):
    """Both packages' cameras: the phototourism parser's first views for
    ``phototourism``, four cameras around the origin otherwise."""
    if method == "phototourism":
        from sdfstudio_tpu_torch.data.dataparsers.colmap_family import (PhototourismDataParserConfig,
                                                                        parse_mipnerf360)

        cams = parse_mipnerf360(PhototourismDataParserConfig(data=HERITAGE)).cameras[
            torch.arange(NUM_IMAGES)]
        kw = {k: getattr(cams, k).numpy() for k in ("fx", "fy", "cx", "cy", "width", "height")}
        c2w = cams.camera_to_worlds.numpy()
    else:
        c2w = _look_at(NUM_IMAGES, 2.5, 7)
        kw = dict(fx=np.full(NUM_IMAGES, 20.0, np.float32), fy=np.full(NUM_IMAGES, 21.0, np.float32),
                  cx=np.full(NUM_IMAGES, 8.0, np.float32), cy=np.full(NUM_IMAGES, 6.0, np.float32),
                  width=16, height=12)
    return JCameras.create(camera_to_worlds=c2w, **kw), Cameras.create(camera_to_worlds=c2w,
                                                                       device="cpu", **kw)


def _models(method, model_kw, seed=0):
    """JAX's and the port's shrunk ``method``, the port's parameters (with
    the camera optimizer's pose table, off the identity) carried from
    JAX's perturbed ones."""
    jcfg = jget_method_config(method)
    jmc = dataclasses.replace(jcfg.model, **model_kw)
    jmodel = jcfg.model_class(jmc, JSceneBox(aabb=AABB), NUM_IMAGES)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        a = np.asarray(a)
        if "hash_table" in jax.tree_util.keystr(path):
            return rng.uniform(-0.5, 0.5, a.shape).astype(np.float32)
        return (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32)

    np_params = jax.tree_util.tree_map_with_path(perturb, params)
    adj = np.concatenate([0.02 * rng.standard_normal((NUM_IMAGES, 3)),
                          0.03 * rng.standard_normal((NUM_IMAGES, 3))], -1).astype(np.float32)
    adj[0] = 0.0  # a camera at the identity, where the exp map takes its Taylor branch
    np_params["camera_opt"] = {"pose_adjustment": adj}
    tcls = type(get_method_config(method).model)
    tcfg = tcls(**{f.name: getattr(jmc, f.name) for f in dataclasses.fields(tcls)})
    tmodel = build_model(MethodConfig(f"small-{method}", get_method_config(method).model_class, tcfg),
                         TSceneBox(aabb=AABB), NUM_IMAGES, device="cpu")
    tmodel.camera_opt = CameraOptimizer(NUM_IMAGES, CameraOptimizerConfig(mode="SO3xR3"))
    params_from_jax(tmodel, np_params)
    return jmodel, np_params, tmodel


def _pixels(R=24, seed=5):
    rng = np.random.default_rng(seed)
    cam = rng.integers(0, NUM_IMAGES, R).astype(np.int32)
    coords = np.stack([rng.uniform(0, 12, R), rng.uniform(0, 16, R)], -1).astype(np.float32)
    batch = {"image": rng.uniform(0, 1, (R, 3)).astype(np.float32)}
    return cam, coords, batch


def _jax_step(jmodel, params, jcams, cam, coords, batch, dtype):
    """JAX's (total, loss dict, gradients) of one step without jitter, the
    rays through the camera optimizer (datamanager.py:236-253)."""
    jco = JCameraOptimizer(num_cameras=NUM_IMAGES, config=JCOConfig(mode="SO3xR3"))
    jsched = jmodel.schedules(jnp.asarray(float(STEP), dtype))

    @jax.jit
    def jloss(params):
        corr = jco.apply({"params": params["camera_opt"]}, jnp.asarray(cam))
        rb = jcams.generate_rays(jnp.asarray(cam), jnp.asarray(coords, dtype) + 0.5, corr)
        out = jmodel.get_outputs(params, rb, rng=None, sched=jsched, train=True)
        ld = jmodel.get_loss_dict(params, out, {k: jnp.asarray(v, dtype) for k, v in batch.items()},
                                  jsched, None)
        return sum(ld.values()), ld

    return jax.value_and_grad(jloss, has_aux=True)(params)


def _port_rays(tmodel, tcams, cam, coords, dtype=torch.float32):
    camt = torch.from_numpy(cam.astype(np.int64))
    return tcams.generate_rays(camt, torch.from_numpy(coords).to(dtype) + 0.5,
                               camera_opt_to_camera=tmodel.camera_opt(camt))


CASES = {
    "nerfacto": ("nerfacto", {}),
    "nerfacto-normals": ("nerfacto", {"predict_normals": True}),
    "nerfacto-same": ("nerfacto", {"use_same_proposal_network": True}),
    "phototourism": ("phototourism", {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_eval_outputs_and_train_step_match_jax(case, monkeypatch):
    from sdfstudio_tpu.ops import mlp as jmlp

    from tests.test_torch_cue_methods import _F64Dot, _f64, _port_f64

    method, kw = CASES[case]
    jmodel, np_params, tmodel = _models(method, {**SMALL, **kw})
    jcams, tcams = _cameras(method)
    cam, coords, batch = _pixels()
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    # eval: the corrected rays of the training views, no schedules' step
    jco = JCameraOptimizer(num_cameras=NUM_IMAGES, config=JCOConfig(mode="SO3xR3"))
    jrb = jcams.generate_rays(jnp.asarray(cam), jnp.asarray(coords) + 0.5,
                              jco.apply({"params": jparams["camera_opt"]}, jnp.asarray(cam)))
    ref = jax.jit(lambda p: jmodel.get_outputs(p, jrb, rng=None, train=False))(jparams)
    with torch.no_grad():
        out = tmodel.get_outputs(_port_rays(tmodel, tcams, cam, coords), train=False)
    keys = ["rgb", "accumulation", "depth", "prop_depth_0", "prop_depth_1"]
    keys += ["normals", "pred_normals"] if kw.get("predict_normals") else []
    for k in keys:
        # a normal is a normalised derivative, whose f32 rounding is ~10x the values'
        tol = 1e-4 if "normals" in k else 1e-5
        scale = float(np.abs(np.asarray(ref[k])).max())
        assert float(np.abs(out[k].numpy() - np.asarray(ref[k])).max()) <= tol * scale, k
    assert 0.05 < float(np.asarray(ref["accumulation"]).mean()) < 0.999
    # one training step
    (ref_total, ref_ld), jg = _jax_step(jmodel, jparams, jcams, cam, coords, batch, jnp.float32)
    cfg = get_method_config(method)
    opts = build_optimizers(optimizer_groups(cfg), tmodel)
    tsched = tmodel.schedules(STEP)
    assert tsched["train_proposal"]
    total, ld, metrics = loss_and_metrics(tmodel, _port_rays(tmodel, tcams, cam, coords),
                                          {k: _t(v) for k, v in batch.items()}, tsched)
    assert sorted(ld) == sorted(ref_ld)
    for k in ld:
        _close(ld[k].detach(), ref_ld[k], rtol=1e-4, atol=0)
        assert float(ref_ld[k]) > 0, k
    _close(total.detach(), ref_total, rtol=1e-4, atol=0)
    assert set(metrics) == {"psnr", "distortion"}
    grads = group_grads(total, opts)
    ref_g = _port_tree({g: jg[g] for g in opts})
    # float64: both packages' parameters, rays and losses in double
    monkeypatch.setenv("SST_MLP_DTYPE", "float64")
    monkeypatch.setattr(jmlp, "jnp", _F64Dot())
    with jax.enable_x64():
        jcams64 = jax.tree_util.tree_map(lambda a: _f64(a) if a.dtype == jnp.float32 else a, jcams)
        _, jg64 = _jax_step(jmodel, jax.tree_util.tree_map(_f64, np_params), jcams64, cam, coords,
                            batch, jnp.float64)
    ref_g64 = _port_tree(jg64)
    m64 = __import__("copy").deepcopy(tmodel).double()
    total64, _, _ = loss_and_metrics(m64, _port_rays(m64, _port_f64(tcams), cam, coords, torch.float64),
                                     {k: _t(v).double() for k, v in batch.items()}, tsched)
    names = [n for n, _ in m64.named_parameters()]
    g64 = dict(zip(names, torch.autograd.grad(total64, list(m64.parameters()), allow_unused=True)))
    seen = 0
    for group, opt in opts.items():
        for name, g in zip(opt.names, grads[group]):
            ref = ref_g[name]
            if g is None:  # no part in the loss: JAX's gradient is exactly zero
                assert not np.any(ref) and g64[name] is None, name
                continue
            scale, scale64 = float(np.abs(ref).max()), float(np.abs(ref_g64[name]).max())
            assert scale > 0, name
            assert float(np.abs(g.numpy() - ref).max()) <= 5e-4 * scale, name
            assert float(np.abs(g64[name].numpy() - ref_g64[name]).max()) <= 1e-4 * scale64, name
            seen += 1
    assert "camera_opt.pose_adjustment" in opts["camera_opt"].names and seen >= 12
    if kw.get("use_same_proposal_network"):
        assert len(tmodel.proposal_networks) == 1
    if kw.get("predict_normals"):
        assert {"orientation_loss", "pred_normal_loss"} <= set(ld)


def test_jax_checkpoint_with_camera_opt_loads_leaf_for_leaf(tmp_path):
    from sdfstudio_tpu.engine.optimizers import build_optimizer as jbuild_optimizer
    from sdfstudio_tpu.engine.setup import OptimizerConfig as JOC
    from sdfstudio_tpu.engine.setup import OptimizerGroupConfig as JOGC
    from sdfstudio_tpu.utils.fast_checkpoint import save_packed

    jmodel, np_params, tmodel = _models("nerfacto", SMALL)
    jcfg = jget_method_config("nerfacto")
    groups = {**jcfg.optimizers, "camera_opt": JOGC(JOC(lr=6e-4, eps=1e-8, weight_decay=1e-2))}
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    tx = jbuild_optimizer(groups, jp)
    state = tx.init(jp)
    rng = np.random.default_rng(3)
    for _ in range(2):
        g = jax.tree_util.tree_map(lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype), jp)
        upd, state = jax.jit(tx.update)(g, state, jp)
        jp = optax.apply_updates(jp, upd)
    path = tmp_path / "step-000000002"
    save_packed(path, {"params": jp, "opt_state": state, "model_state": None,
                       "rng": jax.random.PRNGKey(1)})
    (path / "step.txt").write_text("2")
    fresh = _models("nerfacto", SMALL, seed=1)[2]
    opts = build_optimizers(optimizer_groups(get_method_config("nerfacto")), fresh)
    step, model_state = load_jax_checkpoint(fresh, opts, path)
    assert step == 2 and model_state is None
    flat = _port_tree(jax.tree_util.tree_map(np.asarray, jp))
    assert set(flat) == {n for n, _ in fresh.named_parameters()}
    for n, p in fresh.named_parameters():
        assert np.array_equal(p.detach().numpy(), flat[n]), n
    assert opts["camera_opt"].count == 2 and float(opts["camera_opt"].nu[0].abs().sum()) > 0
