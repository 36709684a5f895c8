"""The NeRF baselines ``vanilla-nerf``, ``dnerf``, ``mipnerf``, ``tensorf`` and
``semantic-nerfw`` against the JAX package, on the CPU.

- The registered entries: every model, trainer and data-manager field and
  every optimizer group (its scheduler's fields too) against JAX's, the
  full-size parameter shapes against JAX's ``eval_shape`` (the port's model
  on the ``meta`` device), the optimizers the port builds (``vanilla-nerf``'s
  ``temporal_distortion`` group holds nothing, as under JAX's
  ``multi_transform``), and JAX's argv with the method's parser parsed to
  JAX's config tree. The port's registry now holds JAX's 30 methods.
- One step of each method shrunk (fewer samples; TensoRF's planes at 16;
  nerfacto's grids as ``tests/test_torch_density_methods.py`` shrinks them),
  ``dnerf`` with the rays' times (the distortion runs) and without them
  (the Blender parser's: its parameters take no gradient, JAX's take
  zeros): JAX's parameters (perturbed) carried in by ``params_from_jax``,
  rays from four cameras around the origin at radius 4 (the near and far
  planes at 2 and 6 reach past TensoRF's aabb), no jitter (``rng=None``).
  At eval the rendered outputs to 1e-5 of scale (``semantic-nerfw``'s
  ``semantics`` too, and its ``semantics_labels`` equal where JAX's two best
  logits part by more than 1e-4); one training step's loss dict to 1e-4
  relative and every gradient to 5e-4 of its scale (max |JAX grad|) in
  float32, and to 1e-4 in float64 (JAX under ``jax.enable_x64`` with its
  dense layers in float64); ``dnerf``'s step with times is ill-conditioned
  in float32 on JAX's side too, and is held by the rule at
  ``F32_ILL_CONDITIONED``.
- A JAX packed checkpoint of ``dnerf`` (RAdam on both groups, two optax
  updates) loads leaf for leaf, its optimizer state too.
- ``dnerf-data`` and ``friends-data`` through ``train.main``, two steps each.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sdfstudio_tpu.cameras.cameras import Cameras as JCameras
from sdfstudio_tpu.configs.methods import get_method_config as jget_method_config
from sdfstudio_tpu.configs.methods import method_configs as jmethod_configs
from sdfstudio_tpu.core.scene_box import SceneBox as JSceneBox

from sdfstudio_tpu_torch.cameras.cameras import Cameras
from sdfstudio_tpu_torch.configs.methods import (MethodConfig, build_model, get_method_config,
                                                 method_configs)
from sdfstudio_tpu_torch.core.scene_box import SceneBox as TSceneBox
from sdfstudio_tpu_torch.engine.optimizers import build_optimizers
from sdfstudio_tpu_torch.engine.setup import optimizer_groups
from sdfstudio_tpu_torch.engine.trainer import group_grads, loss_and_metrics
from sdfstudio_tpu_torch.scripts import train as train_script
from sdfstudio_tpu_torch.utils.convert import load_jax_checkpoint, params_from_jax
from tests.test_torch_train import _close, _port_tree, _t
from tests.test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

NERF = ("vanilla-nerf", "dnerf", "mipnerf", "tensorf", "semantic-nerfw")
PARSER = {"vanilla-nerf": "blender-data", "dnerf": "dnerf-data", "mipnerf": "blender-data",
          "tensorf": "blender-data", "semantic-nerfw": "friends-data"}
NUM_IMAGES = 4
STEP = 30  # semantic-nerfw's proposals train on this step
AABB = np.asarray([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]], np.float32)
# the NeRF fields' 10-frequency PE at |x| up to ~6 (the registered planes at 2 and 6 with
# cameras at 4) makes their float32 step ill-conditioned in either package (JAX's own float32
# gradients part from its float64 ones by up to 3.6e-2 of scale): these cases look at a scene
# a tenth that size (cameras at 0.4, planes at 0.2 and 0.6), where float32 is well posed
_SAMPLES = dict(num_coarse_samples=8, num_importance_samples=8, collider_near=0.2,
                collider_far=0.6)
SMALL = {
    "vanilla-nerf": _SAMPLES, "dnerf": _SAMPLES, "mipnerf": _SAMPLES,
    "tensorf": dict(final_resolution=16, num_uniform_samples=24, num_samples=8),
    "semantic-nerfw": dict(num_levels=4, max_res=64, log2_hashmap_size=10,
                           num_proposal_samples_per_ray=(16, 8), num_nerf_samples_per_ray=8,
                           proposal_net_args_list=(
                               {"hidden_dim": 16, "log2_hashmap_size": 8, "num_levels": 2,
                                "max_res": 32},
                               {"hidden_dim": 16, "log2_hashmap_size": 8, "num_levels": 2,
                                "max_res": 64})),
}


# --- the registered entries -----------------------------------------------------------


@pytest.mark.parametrize("method", NERF)
def test_registered_entry_matches_jax(method):
    jcfg, tcfg = jget_method_config(method), get_method_config(method)
    for part in ("model", "trainer"):
        for f in dataclasses.fields(getattr(tcfg, part)):
            assert getattr(getattr(tcfg, part), f.name) == getattr(getattr(jcfg, part), f.name), f.name
    for k in ("train_num_rays_per_batch", "eval_num_rays_per_batch", "kind"):
        assert getattr(tcfg.datamanager, k) == getattr(jcfg.datamanager, k), k
    assert tcfg.datamanager.camera_optimizer.mode == jcfg.datamanager.camera_optimizer.mode == "off"
    assert type(tcfg.dataparser).__name__ == type(jcfg.dataparser).__name__
    assert set(tcfg.optimizers) == set(jcfg.optimizers)
    for g, og in tcfg.optimizers.items():
        jo = jcfg.optimizers[g]
        for k in ("kind", "lr", "eps", "weight_decay"):
            assert getattr(og.optimizer, k) == getattr(jo.optimizer, k), (g, k)
        assert (og.scheduler is None) == (jo.scheduler is None)
        if og.scheduler is not None:
            for f in dataclasses.fields(og.scheduler):
                assert getattr(og.scheduler, f.name) == getattr(jo.scheduler, f.name), (g, f.name)
    jmodel = jcfg.model_class(jcfg.model, JSceneBox(aabb=AABB), NUM_IMAGES)
    abstract = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    views = jax.tree_util.tree_map(lambda a: np.broadcast_to(np.zeros((), a.dtype), a.shape), abstract)
    shapes = {k: v.shape for k, v in _port_tree(views).items()}
    with torch.device("meta"):
        tmodel = tcfg.model_class(tcfg.model, TSceneBox(aabb=AABB), NUM_IMAGES)
        opts = build_optimizers(optimizer_groups(tcfg), tmodel)
    assert {n: tuple(p.shape) for n, p in tmodel.named_parameters()} == shapes
    assert set(opts) == set(abstract)  # no group without parameters (vanilla-nerf's distortion)
    assert len(method_configs) == 30 and set(method_configs) == set(jmethod_configs)


@pytest.mark.parametrize("method", NERF)
def test_argv_gives_jax_config_tree(method):
    from tests.test_torch_cli import _held, _jax_tree, _strip

    argv = [method, "--experiment-name", "e1", "--vis", "none", "--timestamp", "ts",
            "--pipeline.model.eval-num-rays-per-chunk", "512", "--trainer.max-num-iterations", "300",
            PARSER[method], "--data", "some/scene"]
    config, port = train_script.parse_args(argv)
    assert port == {"device": None, "deterministic": False}
    assert _held(_strip(config.to_dict()), _jax_tree(argv)) > 40
    assert type(config.dataparser) is train_script.DATAPARSERS[PARSER[method]]
    assert config.model.eval_num_rays_per_chunk == 512


# --- one step of each method ----------------------------------------------------------


def _cameras(times: bool, radius: float = 4.0):
    """Both packages' four cameras on a sphere of ``radius``, each looking at a
    point near the origin, with times in [0, 1] if asked."""
    from tests.test_torch_density_methods import _look_at

    c2w = _look_at(NUM_IMAGES, 1.0, 7)
    c2w[:, :, 3] *= radius
    kw = dict(fx=np.full(NUM_IMAGES, 20.0, np.float32), fy=np.full(NUM_IMAGES, 21.0, np.float32),
              cx=np.full(NUM_IMAGES, 8.0, np.float32), cy=np.full(NUM_IMAGES, 6.0, np.float32),
              width=16, height=12)
    t = np.linspace(0.0, 1.0, NUM_IMAGES).astype(np.float32) if times else None
    return (JCameras.create(camera_to_worlds=c2w, times=t, **kw),
            Cameras.create(camera_to_worlds=c2w, device="cpu", times=t, **kw))


def _models(method, seed=0):
    """JAX's and the port's shrunk ``method``, the port's parameters carried
    from JAX's perturbed ones."""
    jcfg = jget_method_config(method)
    jmc = dataclasses.replace(jcfg.model, **SMALL[method])
    jmodel = jcfg.model_class(jmc, JSceneBox(aabb=AABB), NUM_IMAGES)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        a = np.asarray(a)
        if "hash_table" in jax.tree_util.keystr(path):
            return rng.uniform(-0.5, 0.5, a.shape).astype(np.float32)
        return (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32)

    np_params = jax.tree_util.tree_map_with_path(perturb, params)
    if "temporal_distortion" in np_params:  # offsets of a few thousandths, within the small scene
        last = np_params["temporal_distortion"]["MLP_0"]["layer_3"]
        last["kernel"], last["bias"] = 0.01 * last["kernel"], 0.01 * last["bias"]
    tcls = type(get_method_config(method).model)
    tcfg = tcls(**{f.name: getattr(jmc, f.name) for f in dataclasses.fields(tcls)})
    tmodel = build_model(MethodConfig(f"small-{method}", get_method_config(method).model_class, tcfg),
                         TSceneBox(aabb=AABB), NUM_IMAGES, device="cpu")
    params_from_jax(tmodel, np_params)
    return jmodel, np_params, tmodel


def _pixels(R=24, seed=5):
    rng = np.random.default_rng(seed)
    cam = rng.integers(0, NUM_IMAGES, R).astype(np.int32)
    coords = np.stack([rng.uniform(0, 12, R), rng.uniform(0, 16, R)], -1).astype(np.float32)
    return cam, coords, {"image": rng.uniform(0, 1, (R, 3)).astype(np.float32)}


def _jax_step(jmodel, params, jcams, cam, coords, batch, dtype):
    jsched = jmodel.schedules(jnp.asarray(float(STEP), dtype))

    @jax.jit
    def jloss(params):
        rb = jcams.generate_rays(jnp.asarray(cam), jnp.asarray(coords, dtype) + 0.5)
        out = jmodel.get_outputs(params, rb, rng=None, sched=jsched, train=True)
        ld = jmodel.get_loss_dict(params, out, {k: jnp.asarray(v, dtype) for k, v in batch.items()},
                                  jsched, None)
        return sum(ld.values()), ld

    return jax.value_and_grad(jloss, has_aux=True)(params)


def _port_rays(tcams, cam, coords, dtype=torch.float32):
    return tcams.generate_rays(torch.from_numpy(cam.astype(np.int64)),
                               torch.from_numpy(coords).to(dtype) + 0.5)


CASES = {"vanilla-nerf": ("vanilla-nerf", False), "dnerf-times": ("dnerf", True),
         "dnerf-no-times": ("dnerf", False), "mipnerf": ("mipnerf", False),
         "tensorf": ("tensorf", False), "semantic-nerfw": ("semantic-nerfw", False)}
EVAL_KEYS = {"vanilla-nerf": ["rgb", "accumulation", "depth", "rgb_coarse", "accumulation_coarse",
                              "depth_coarse"],
             "tensorf": ["rgb", "accumulation", "depth"],
             "semantic-nerfw": ["rgb", "accumulation", "depth", "prop_depth_0", "prop_depth_1",
                                "semantics"]}

# the eval outputs' float32 tolerance where JAX's own float32 outputs part
# from its float64 ones by more than 1e-5 of scale (the port's float64 step
# equals JAX's; the gradients below are held as everywhere): TensoRF's random
# tri-planes at 16 cells are rough, and the PDF resampling moves its 50
# samples with the uniform pass's weights (JAX's own gap 9e-6 of scale);
# D-NeRF's time PE and offsets add their float32 noise to the positions
# before the 10-frequency PE (2.9e-5 in the accumulation)
EVAL_TOL = {"tensorf": 3e-5, "dnerf-times": 1e-4}
# D-NeRF's step with times is ill-conditioned in float32 in either package:
# JAX's own float32 gradients of the distortion MLP part from its float64
# ones by 3e-3 to 5e-2 of their scale. There, as in
# tests/test_torch_occupancy.py (neus-acc), a float32 gradient is held to
# 5e-4 wherever each side's float32 gradient lies within 2.5e-4 of its own
# float64 one, and every float64 gradient to 1e-4
F32_ILL_CONDITIONED = {"dnerf-times"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_eval_outputs_and_train_step_match_jax(case, monkeypatch):
    from sdfstudio_tpu.ops import mlp as jmlp

    from tests.test_torch_cue_methods import _F64Dot, _f64, _port_f64

    method, times = CASES[case]
    jmodel, np_params, tmodel = _models(method)
    jcams, tcams = _cameras(times, 0.4 if method in ("vanilla-nerf", "dnerf", "mipnerf") else 4.0)
    cam, coords, batch = _pixels()
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    # eval
    jrb = jcams.generate_rays(jnp.asarray(cam), jnp.asarray(coords) + 0.5)
    ref = jax.jit(lambda p: jmodel.get_outputs(p, jrb, rng=None, train=False))(jparams)
    with torch.no_grad():
        out = tmodel.get_outputs(_port_rays(tcams, cam, coords), train=False)
    for k in EVAL_KEYS.get(method, EVAL_KEYS["vanilla-nerf"]):
        scale = float(np.abs(np.asarray(ref[k])).max())
        tol = EVAL_TOL.get(case, EVAL_TOL.get(method, 1e-5))
        assert float(np.abs(out[k].numpy() - np.asarray(ref[k])).max()) <= tol * scale, k
    assert 0.02 < float(np.asarray(ref["accumulation"]).mean()) < 0.999
    if method == "semantic-nerfw":
        logits = np.sort(np.asarray(ref["semantics"]), -1)
        clear = (logits[:, -1] - logits[:, -2]) > 1e-4 * np.abs(logits).max()
        assert clear.mean() > 0.9 and out["semantics_labels"].shape == (24,)
        np.testing.assert_array_equal(out["semantics_labels"].numpy()[clear],
                                      np.asarray(ref["semantics_labels"])[clear])
    # one training step
    (ref_total, ref_ld), jg = _jax_step(jmodel, jparams, jcams, cam, coords, batch, jnp.float32)
    opts = build_optimizers(optimizer_groups(get_method_config(method)), tmodel)
    tsched = tmodel.schedules(STEP)
    total, ld, metrics = loss_and_metrics(tmodel, _port_rays(tcams, cam, coords),
                                          {k: _t(v) for k, v in batch.items()}, tsched)
    assert sorted(ld) == sorted(ref_ld)
    for k in ld:
        _close(ld[k].detach(), ref_ld[k], rtol=1e-4, atol=0)
        assert float(ref_ld[k]) > 0, k
    _close(total.detach(), ref_total, rtol=1e-4, atol=0)
    assert "psnr" in metrics
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
    m64 = copy.deepcopy(tmodel).double()
    total64, _, _ = loss_and_metrics(m64, _port_rays(_port_f64(tcams), cam, coords, torch.float64),
                                     {k: _t(v).double() for k, v in batch.items()}, tsched)
    names = [n for n, _ in m64.named_parameters()]
    g64 = dict(zip(names, torch.autograd.grad(total64, list(m64.parameters()), allow_unused=True)))
    seen, f32_held, unused = 0, 0, []
    for group, opt in opts.items():
        for name, g in zip(opt.names, grads[group]):
            ref = ref_g[name]
            if g is None:  # no part in the loss: JAX's gradient is exactly zero
                assert not np.any(ref) and g64[name] is None, name
                unused.append(name)
                continue
            scale, scale64 = float(np.abs(ref).max()), float(np.abs(ref_g64[name]).max())
            assert scale > 0, name
            assert float(np.abs(g64[name].numpy() - ref_g64[name]).max()) <= 1e-4 * scale64, name
            seen += 1
            if case in F32_ILL_CONDITIONED:
                own = max(float(np.abs(g.numpy() - g64[name].numpy()).max()),
                          float(np.abs(ref - ref_g64[name]).max()))
                if own > 2.5e-4 * scale64:
                    continue
            assert float(np.abs(g.numpy() - ref).max()) <= 5e-4 * scale, name
            f32_held += 1
    distortion = opts["temporal_distortion"].names if "temporal_distortion" in opts else []
    if case == "dnerf-no-times":
        assert unused == distortion and len(distortion) == 8
    elif method == "semantic-nerfw":  # the semantic head: no labels, no loss
        assert all("semantics" in n for n in unused) and len(unused) == 6
        assert {"uncertainty_loss", "density_loss"} <= set(ld)
    else:
        assert not unused
    assert seen >= 6 and f32_held >= (seen // 3 if case in F32_ILL_CONDITIONED else seen)


# --- a JAX checkpoint, and the command line ------------------------------------------------


def test_jax_dnerf_checkpoint_loads_leaf_for_leaf(tmp_path):
    from sdfstudio_tpu.engine.optimizers import build_optimizer as jbuild_optimizer
    from sdfstudio_tpu.utils.fast_checkpoint import save_packed

    jmodel, np_params, _ = _models("dnerf")
    jcfg = jget_method_config("dnerf")
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    tx = jbuild_optimizer(jcfg.optimizers, jp)
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
    fresh = _models("dnerf", seed=1)[2]
    opts = build_optimizers(optimizer_groups(get_method_config("dnerf")), fresh)
    assert {o.kind for o in opts.values()} == {"radam"}
    step, model_state = load_jax_checkpoint(fresh, opts, path)
    assert step == 2 and model_state is None
    flat = _port_tree(jax.tree_util.tree_map(np.asarray, jp))
    assert set(flat) == {n for n, _ in fresh.named_parameters()}
    for n, p in fresh.named_parameters():
        assert np.array_equal(p.detach().numpy(), flat[n]), n
    assert "temporal_distortion.mlp.layers.3.kernel" in flat
    for name, opt in opts.items():
        assert opt.count == 2 and float(opt.nu[0].abs().sum()) > 0, name


@pytest.mark.parametrize("method", ["dnerf", "semantic-nerfw"])
def test_parser_argv_trains_two_steps(tmp_path, method):
    """``dnerf dnerf-data`` (the times reach the rays: the distortion's
    parameters move) and ``semantic-nerfw friends-data`` (the segmentations
    are written and never read) through ``train.main``, two steps."""
    from sdfstudio_tpu_torch.data.synthetic import (generate_blender_sphere_dataset,
                                                    generate_friends_sphere_dataset)
    from sdfstudio_tpu_torch.engine import setup as setup_lib

    if method == "dnerf":
        scene = generate_blender_sphere_dataset(tmp_path / "scene", num_images=6, width=16,
                                                height=16, times=True, val_every=3)
        model_args = ["--pipeline.model.num-coarse-samples", "8",
                      "--pipeline.model.num-importance-samples", "8"]
    else:
        scene = generate_friends_sphere_dataset(tmp_path / "scene", num_images=3, width=16,
                                                height=12)
        model_args = ["--pipeline.model.num-proposal-samples-per-ray", "(16,8)",
                      "--pipeline.model.num-nerf-samples-per-ray", "8", "--pipeline.model.num-levels",
                      "4", "--pipeline.model.eval-num-rays-per-chunk", "64"]
    made = []
    setup = setup_lib.setup_trainer

    def keep(*a, **kw):
        made.append(setup(*a, **kw))
        return made[-1]

    argv = [method, "--output-dir", str(tmp_path / "runs"), "--vis", "none", "--device", "cpu",
            "--trainer.max-num-iterations", "2", "--trainer.steps-per-eval-image", "0",
            "--datamanager.train-num-rays-per-batch", "32", *model_args,
            PARSER[method], "--data", str(scene)]
    setup_lib.setup_trainer = keep
    try:
        assert train_script.main(argv) == 0
    finally:
        setup_lib.setup_trainer = setup
    trainer = made[0]
    assert trainer.step == 2
    if method == "dnerf":
        assert trainer.datamanager.train_cameras.times is not None
        assert trainer.optimizers["temporal_distortion"].count == 2
        assert float(trainer.optimizers["temporal_distortion"].nu[0].abs().sum()) > 0
    else:
        assert set(trainer.datamanager.train_data) == {"image"}
        assert (scene / "segmentations" / "thing" / "00000.png").exists()
