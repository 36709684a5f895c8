"""The occupancy-grid family -- ``neusW``, ``dto`` and ``neus-acc`` -- and the
heritage regime against the JAX package, on the CPU.

The scene is JAX's heritage-like generator at 8 views of 64 x 64 (800
sparse points; made once a session, as JAX's ``tests/test_heritage_scene.py``
makes it). On it:

- the heritage parser: file names, poses, intrinsics, the coarse grid and
  the masks equal JAX's (poses to 1e-6; the rest exactly), both splits;
- ``heritage-data`` parses JAX's argv into JAX's config tree, leaf for
  leaf, and two steps train through the command line;
- the heritage judge on a fixed vertex set: 1e-9, with both sides'
  surface samples cut from 150,000 to 3,000 (patched in this process; the
  samples themselves equal JAX's at that size);
- the grid primitives: ``occupied_at``, ``grid_near_far`` with and without
  the shell, ``occupancy_grid_sampler`` without jitter and
  ``update_occupancy_grid`` at the cell centres, exactly (decisions) and to
  1e-6 (positions, values);
- ``voxel_surface_guided_samples`` without jitter, disarmed and armed: the
  bins to 1e-5 of their scale;
- the fine grid's refresh: the binary equals JAX's except at voxels whose
  |sdf| < 1e-5, where f32 rounding may put the two sides apart;
- one train step of ``neusW`` and ``dto`` on the armed fine grid and of
  ``neus-acc`` on its pruned grid, each shrunk (geometry 5 x 64, colour
  2 x 32; the ``"grid"`` background at its fixed full width), JAX's
  parameters carried in by ``params_from_jax``, the same rays without
  jitter: each loss to 1e-4 relative, each gradient to 5e-4 of its scale
  (max |JAX grad|) in float32.

``neus-acc`` keeps the ``"mlp"`` background, whose float32 gradient is
ill-conditioned on these rays in either package: JAX's own float32
gradients of ``mlp_base`` differ from its float64 ones by up to 1.4e-2 of
their scale (the background's share is the last transmittance, a product
of ``1 - alpha`` over 32 samples). Its step therefore also runs in float64
on both sides (JAX under ``jax.enable_x64`` with its dense layers in
float64, ``_F64Dot``, as ``tests/test_torch_cue_methods.py`` does), where
every gradient is held to 1e-4 of its scale, and in float32 each gradient
is held to 5e-4 wherever each side's float32 gradient lies within 2.5e-4
of its own float64 one (the cue tests' rule).

The step's grid is JAX's (the port's own refresh is held to it above), so
that the step does not hang on a voxel at the edge of the decision.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdfstudio_tpu.configs.methods import get_method_config as jget_method_config
from sdfstudio_tpu.core.rays import RayBundle as JRayBundle
from sdfstudio_tpu.data.dataparsers.colmap_family import Heritage, HeritageDataParserConfig as JHPC
from sdfstudio_tpu.data.synthetic_heritage import generate_heritage_like_dataset
from sdfstudio_tpu.samplers import grid as jgrid
from sdfstudio_tpu.samplers.surface_guided import voxel_surface_guided_samples as jvsg

from sdfstudio_tpu_torch.configs.methods import MethodConfig, build_model, get_method_config
from sdfstudio_tpu_torch.core.rays import RayBundle as TRayBundle
from sdfstudio_tpu_torch.data.dataparsers.colmap_family import (
    HeritageDataParserConfig,
    parse_heritage,
)
from sdfstudio_tpu_torch.engine.optimizers import build_optimizers
from sdfstudio_tpu_torch.engine.trainer import group_grads, loss_and_metrics
from sdfstudio_tpu_torch.fields.sdf_field import SDFFieldConfig as TSDFFieldConfig
from sdfstudio_tpu_torch.samplers import grid as tgrid
from sdfstudio_tpu_torch.samplers.surface_guided import voxel_surface_guided_samples as tvsg
from sdfstudio_tpu_torch.scripts import train as train_script
from sdfstudio_tpu_torch.utils.convert import params_from_jax
from tests.test_torch_train import _close, _port_tree, _t
from tests.test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

NUM_IMAGES = 8
# the skip re-enters the 47-wide input (xyz, 36 PE, 8 zero grid features) at layer 4
SMALL_SDF = dict(num_layers=5, hidden_dim=64, geo_feat_dim=32, num_layers_color=2,
                 hidden_dim_color=32, num_levels=4)
STEP = 30


@pytest.fixture(scope="session")
def heritage_scene(tmp_path_factory):
    out = tmp_path_factory.mktemp("heritage") / "heritage_like"
    generate_heritage_like_dataset(out, num_images=NUM_IMAGES, width=64, height=64, num_points=800,
                                   seed=0)
    return out


@pytest.fixture(scope="session")
def parsed(heritage_scene):
    jout = {s: Heritage(JHPC(data=heritage_scene)).get_dataparser_outputs(s) for s in ("train", "val")}
    tout = {s: parse_heritage(HeritageDataParserConfig(data=heritage_scene), s)
            for s in ("train", "val")}
    return jout, tout


def test_heritage_parser_matches_jax(parsed):
    jout, tout = parsed
    for split in ("train", "val"):
        j, t = jout[split], tout[split]
        assert [str(p) for p in t.image_filenames] == [str(p) for p in j.image_filenames]
        jc, tc = j.cameras, t.cameras
        _close(tc.camera_to_worlds.numpy(), np.asarray(jc.camera_to_worlds), rtol=0, atol=1e-6)
        for k in ("fx", "fy", "cx", "cy"):
            assert np.array_equal(getattr(tc, k).numpy(), np.asarray(getattr(jc, k)).reshape(-1)), k
        assert np.array_equal(tc.width.numpy(), np.asarray(jc.width).reshape(-1))
        assert np.array_equal(t.scene_box.coarse_binary_grid, j.scene_box.coarse_binary_grid)
        assert t.scene_box.coarse_binary_grid.any() and not t.scene_box.coarse_binary_grid.all()
        for k in ("near", "far", "radius", "collider_type"):
            assert getattr(t.scene_box, k) == getattr(j.scene_box, k), k
        assert len(t.fg_masks) == len(j.fg_masks) == len(t.image_filenames)
        for a, b in zip(t.fg_masks, j.fg_masks):
            assert np.array_equal(a, b)
    assert len(tout["val"].image_filenames) == NUM_IMAGES  # min(n, 10)


def test_heritage_data_argv_and_cli_train(heritage_scene, tmp_path, capsys):
    """JAX's ``heritage-data`` argv, then two steps through the command line
    on a shrunk field and a 32^3 fine grid (the coarse grid's resolution, the
    least it takes), armed at step 0."""
    from tests.test_torch_cli import _held, _jax_tree, _strip

    jax_argv = ["neusW", "--vis", "none", "--output-dir", str(tmp_path), "--timestamp", "t",
                "--trainer.max-num-iterations", "2", "--trainer.steps-per-log", "1",
                "--datamanager.train-num-rays-per-batch", "16",
                "--pipeline.model.grid-resolution", "32", "--pipeline.model.fine-grid-warmup", "0",
                "--pipeline.model.sdf-field.num-layers", "2",
                "--pipeline.model.sdf-field.hidden-dim", "32",
                "heritage-data", "--data", str(heritage_scene), "--min-track-length", "2"]
    argv = jax_argv[:-5] + ["--device", "cpu"] + jax_argv[-5:]
    config, port = train_script.parse_args(argv)
    assert _held(_strip(config.to_dict()), _jax_tree(jax_argv)) > 60
    assert isinstance(config.dataparser, HeritageDataParserConfig)
    assert config.dataparser.min_track_length == 2 and port["device"] == "cpu"
    assert str(config.data) == str(heritage_scene)
    assert train_script.main(argv) == 0
    out = capsys.readouterr().out
    assert "step 2/2" in out
    assert (tmp_path / "experiment" / "neusW" / "t" / "config.yml").exists()


def test_heritage_judge_matches_jax(heritage_scene, monkeypatch):
    from sdfstudio_tpu.data import synthetic_heritage as jher

    from sdfstudio_tpu_torch.data import synthetic_heritage as ther

    assert np.array_equal(ther.gt_surface_samples(3000), jher.gt_surface_samples(3000))
    for mod in (jher, ther):
        monkeypatch.setattr(mod, "gt_surface_samples", lambda f=mod.gt_surface_samples: f(3000))
    v = np.random.default_rng(0).uniform(-0.6, 0.6, (500, 3))
    ref, got = jher.chamfer_l1_to_gt(v, heritage_scene), ther.chamfer_l1_to_gt(v, heritage_scene)
    for k in ("accuracy", "completeness", "chamfer_l1", "n_pred_cropped"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-9, atol=0)


# --- the grid primitives ------------------------------------------------------


def _grids(res=16, seed=0, density=0.3):
    rng = np.random.default_rng(seed)
    binary = rng.uniform(0, 1, (res,) * 3) < density
    aabb = np.array([[-1.0, -0.9, -1.1], [1.0, 1.1, 0.9]], np.float32)
    jg = jgrid.OccupancyGrid.create(aabb, res).replace(binary=jnp.asarray(binary))
    tg = tgrid.OccupancyGrid.create(aabb, res).replace(binary=torch.from_numpy(binary))
    return jg, tg


def _bundles(R=24, seed=1):
    rng = np.random.default_rng(seed)
    o = rng.standard_normal((R, 3))
    o = (2.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)).astype(np.float32)
    d = rng.uniform(-0.5, 0.5, (R, 3)) - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    nears = rng.uniform(0.3, 0.8, (R, 1)).astype(np.float32)
    fars = (nears + rng.uniform(1.5, 3.0, (R, 1))).astype(np.float32)
    pa = np.full((R, 1), 1e-5, np.float32)
    jb = JRayBundle(jnp.asarray(o), jnp.asarray(d), jnp.asarray(pa), nears=jnp.asarray(nears),
                    fars=jnp.asarray(fars))
    tb = TRayBundle(_t(o), _t(d), _t(pa), nears=_t(nears), fars=_t(fars))
    return jb, tb


def test_grid_primitives_match_jax():
    jg, tg = _grids(density=0.01)
    pts = np.random.default_rng(2).uniform(-1.3, 1.3, (4000, 3)).astype(np.float32)
    assert np.array_equal(tg.occupied_at(_t(pts)).numpy(), np.asarray(jg.occupied_at(jnp.asarray(pts))))
    _close(tg.cell_positions().numpy(), np.asarray(jg.cell_positions()), rtol=0, atol=1e-6)
    jb, tb = _bundles()
    for shell in (None, 0.03):
        jn, jf, jh = jax.jit(lambda b: jgrid.grid_near_far(
            b, jg, num_probes=64, margin=0.01 if shell is None else 0.0, first_hit_shell=shell))(jb)
        tn, tf, th = tgrid.grid_near_far(tb, tg, num_probes=64, margin=0.01 if shell is None else 0.0,
                                         first_hit_shell=shell)
        assert np.array_equal(th.numpy(), np.asarray(jh)) and th.any() and not th.all()
        _close(tn.numpy(), np.asarray(jn), rtol=0, atol=1e-6)
        _close(tf.numpy(), np.asarray(jf), rtol=0, atol=1e-6)
    js, jv = jax.jit(lambda b: jgrid.occupancy_grid_sampler(b, jg, num_samples=32, rng=None))(jb)
    ts, tv = tgrid.occupancy_grid_sampler(tb, tg, num_samples=32, rng=None)
    assert np.array_equal(tv.numpy(), np.asarray(jv)) and tv.any() and not tv.all()
    _close(ts.starts.numpy(), np.asarray(js.starts), rtol=0, atol=1e-6)
    _close(ts.ends.numpy(), np.asarray(js.ends), rtol=0, atol=1e-6)
    # the EMA update at the cell centres, from a density of the positions
    dens = lambda x, xp: 50.0 * xp.exp(-8.0 * xp.sum(x * x, axis=-1))  # noqa: E731
    jg2 = jgrid.update_occupancy_grid(jg.replace(occs=jnp.full_like(jg.occs, 0.004)),
                                      lambda x: dens(x, jnp), None)
    tg2 = tgrid.update_occupancy_grid(tg.replace(occs=torch.full_like(tg.occs, 0.004)),
                                      lambda x: dens(x, torch), None)
    _close(tg2.occs.numpy(), np.asarray(jg2.occs), rtol=1e-6, atol=1e-7)
    assert np.array_equal(tg2.binary.numpy(), np.asarray(jg2.binary))
    assert tg2.binary.any() and not tg2.binary.all()


@pytest.mark.parametrize("armed", [False, True])
def test_surface_guided_samples_match_jax(armed):
    coarse_j, coarse_t = _grids(res=8, seed=3, density=0.5)
    fine_j, fine_t = _grids(res=32, seed=4, density=0.2 if armed else 0.0)
    jb, tb = _bundles(R=20, seed=5)

    def sdf(xp):
        def fn(samples):
            p = samples.get_start_positions()
            return xp.sqrt(xp.sum(p * p, axis=-1)) - 0.6
        return fn

    js = jax.jit(lambda b: jvsg(b, coarse_j, fine_j, sdf(jnp), rng=None))(jb)
    ts = tvsg(tb, coarse_t, fine_t, sdf(torch), rng=None)
    assert ts.starts.shape == (20, 34)
    scale = float(np.abs(np.asarray(js.ends)).max())
    _close(ts.starts.numpy(), np.asarray(js.starts), rtol=0, atol=1e-5 * scale)
    _close(ts.ends.numpy(), np.asarray(js.ends), rtol=0, atol=1e-5 * scale)


# --- the models -----------------------------------------------------------------


def _small_models(method, j_scene_box, t_scene_box, model_kw, seed=0, sdf_kw=None):
    """JAX's and the port's shrunk ``method`` on the scene's boxes, the
    port's parameters carried from JAX's perturbed ones."""
    jcfg = jget_method_config(method).model
    jsdf = dataclasses.replace(jcfg.sdf_field, **(SMALL_SDF if sdf_kw is None else sdf_kw))
    jcfg = dataclasses.replace(jcfg, sdf_field=jsdf, **model_kw)
    tsdf = TSDFFieldConfig(**{f.name: getattr(jsdf, f.name) for f in dataclasses.fields(TSDFFieldConfig)})
    tcls = type(get_method_config(method).model)
    tcfg = tcls(**{f.name: tsdf if f.name == "sdf_field" else getattr(jcfg, f.name)
                   for f in dataclasses.fields(tcls)})
    jmodel = jget_method_config(method).model_class(jcfg, j_scene_box, NUM_IMAGES)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        name = jax.tree_util.keystr(path)
        a = np.asarray(a)
        if "hash_table" in name:
            return rng.uniform(-0.05, 0.05, a.shape).astype(np.float32)
        if "deviation" in name or "laplace_beta" in name:
            return a
        return (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32)

    np_params = jax.tree_util.tree_map_with_path(perturb, params)
    tmodel = build_model(MethodConfig(f"small-{method}", get_method_config(method).model_class, tcfg),
                         t_scene_box, NUM_IMAGES, device="cpu")
    params_from_jax(tmodel, np_params)
    return jmodel, np_params, tmodel


def _scene_rays(R=24, seed=6):
    rng = np.random.default_rng(seed)
    o = rng.standard_normal((R, 3))
    o = (1.8 * o / np.linalg.norm(o, axis=-1, keepdims=True)).astype(np.float32)
    d = rng.uniform(-0.4, 0.4, (R, 3)) - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    pa = np.full((R, 1), 1e-5, np.float32)
    dn = rng.uniform(1.0, 1.2, (R, 1)).astype(np.float32)
    ci = rng.integers(0, NUM_IMAGES, R).astype(np.int32)
    jb = JRayBundle(jnp.asarray(o), jnp.asarray(d), jnp.asarray(pa), camera_indices=jnp.asarray(ci),
                    directions_norm=jnp.asarray(dn))
    tb = TRayBundle(_t(o), _t(d), _t(pa), camera_indices=torch.from_numpy(ci.astype(np.int64)),
                    directions_norm=_t(dn))
    batch = {"image": rng.uniform(0, 1, (R, 3)).astype(np.float32),
             "fg_mask": (rng.uniform(0, 1, (R, 1)) > 0.5).astype(np.float32)}
    return jb, tb, batch


def _jax_state_to_port(jms, tms):
    return tms.replace(occs=torch.from_numpy(np.asarray(jms.occs).copy()),
                       binary=torch.from_numpy(np.asarray(jms.binary).copy()))


def _jax_grads(jmodel, params, jb, batch, jms, dtype):
    """JAX's (total, loss dict, gradients) of one step without jitter."""
    jsched = jmodel.schedules(jnp.asarray(float(STEP), dtype))

    @jax.jit
    def jloss(params):
        out = jmodel.get_outputs(params, jb, rng=None, sched=jsched, train=True, model_state=jms)
        ld = jmodel.get_loss_dict(params, out, {k: jnp.asarray(v) for k, v in batch.items()}, jsched,
                                  None)
        return sum(ld.values()), ld

    return jax.value_and_grad(jloss, has_aux=True)(params)


def _f64_grads(jmodel, np_params, tmodel, jms, tms, jb, tb, batch, monkeypatch):
    """JAX's and the port's gradients of the same step in float64."""
    from sdfstudio_tpu.ops import mlp as jmlp

    from tests.test_torch_cue_methods import _F64Dot, _f64, _port_f64

    monkeypatch.setenv("SST_MLP_DTYPE", "float64")
    monkeypatch.setattr(jmlp, "jnp", _F64Dot())
    with jax.enable_x64():
        _, jg = _jax_grads(jmodel, jax.tree_util.tree_map(_f64, np_params),
                           jax.tree_util.tree_map(_f64, jb), {k: _f64(v) for k, v in batch.items()},
                           None if jms is None else jms.replace(occs=_f64(jms.occs),
                                                                aabb=_f64(jms.aabb)), jnp.float64)
    m64 = copy.deepcopy(tmodel).double()
    total, _, _ = loss_and_metrics(m64, _port_f64(tb), {k: _t(v).double() for k, v in batch.items()},
                                   tmodel.schedules(STEP), model_state=_port_f64(tms))
    names = [n for n, _ in m64.named_parameters()]
    grads = torch.autograd.grad(total, list(m64.parameters()), allow_unused=True)
    return _port_tree(jg), {n: g for n, g in zip(names, grads) if g is not None}


def _compare_step(method, jmodel, np_params, tmodel, jms, tms, min_seen, monkeypatch=None):
    """One step on both sides (see the module docstring); with
    ``monkeypatch`` also in float64, and float32 held where it is
    well-conditioned."""
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    jb, tb, batch = _scene_rays()
    tsched = tmodel.schedules(STEP)
    (ref_total, ref_ld), jg = _jax_grads(jmodel, jparams, jb, batch, jms, jnp.float32)
    opts = build_optimizers(get_method_config(method).optimizers, tmodel)
    total, ld, _ = loss_and_metrics(tmodel, tb, {k: _t(v) for k, v in batch.items()}, tsched,
                                    model_state=tms)
    assert sorted(ld) == sorted(ref_ld)
    for k in ld:
        _close(ld[k].detach(), ref_ld[k], rtol=1e-4, atol=0)
    _close(total.detach(), ref_total, rtol=1e-4, atol=0)
    grads = group_grads(total, opts)
    ref_g = _port_tree({g: jg[g] for g in opts})
    if monkeypatch is not None:
        ref_g64, g64 = _f64_grads(jmodel, np_params, tmodel, jms, tms, jb, tb, batch, monkeypatch)
    seen = f32_held = 0
    for group, opt in opts.items():
        for name, g in zip(opt.names, grads[group]):
            ref = ref_g[name]
            if g is None:  # no part in the loss: JAX's gradient is exactly zero
                assert not np.any(ref), name
                continue
            scale = float(np.abs(ref).max())
            assert scale > 0, name
            well_conditioned = True
            if monkeypatch is not None:
                ref64, got64 = ref_g64[name], g64[name].numpy()
                scale64 = float(np.abs(ref64).max())
                assert float(np.abs(got64 - ref64).max()) <= 1e-4 * scale64, name
                own = max(float(np.abs(ref - ref64).max()), float(np.abs(g.numpy() - got64).max()))
                well_conditioned = own <= 2.5e-4 * scale64
            if well_conditioned:
                assert float(np.abs(g.numpy() - ref).max()) <= 5e-4 * scale, name
                f32_held += 1
            seen += 1
    assert seen >= min_seen and f32_held >= min_seen // 2, (seen, f32_held)
    return tmodel


@pytest.mark.parametrize("method", ["neusW", "dto"])
def test_surface_guided_method_refresh_and_step_match_jax(method, parsed):
    jout, tout = parsed
    fine = "grid_resolution" if method == "neusW" else "fine_grid_resolution"
    jmodel, np_params, tmodel = _small_models(
        method, jout["train"].scene_box, tout["train"].scene_box, {fine: 32, "fine_grid_warmup": 10})
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    # the refresh: disarmed before the warm-up (empty), armed from it on (JAX's binary)
    assert not tmodel.update_model_state(tmodel.init_model_state(), 0).binary.any()
    jms = jax.jit(lambda p, s: jmodel.update_model_state(p, jmodel.init_model_state(), s, None))(
        jparams, jnp.asarray(STEP))
    tms = tmodel.update_model_state(tmodel.init_model_state(), STEP)
    jbin, tbin = np.asarray(jms.binary), tms.binary.numpy()
    sdf = tmodel.field.sdf(tms.cell_positions()).reshape(tbin.shape).numpy()
    assert tbin.any() and np.array_equal(tbin[np.abs(sdf) >= 1e-5], jbin[np.abs(sdf) >= 1e-5])
    assert tmodel.field_background is not None and type(tmodel.field_background).__name__ == "NerfactoField"
    _compare_step(method, jmodel, np_params, tmodel, jms, _jax_state_to_port(jms, tms), 20)


def test_neus_acc_refresh_and_step_match_jax(monkeypatch):
    from sdfstudio_tpu.core.scene_box import SceneBox as JSceneBox

    from sdfstudio_tpu_torch.core.scene_box import SceneBox as TSceneBox

    kw = dict(near=0.05, far=4.0, radius=1.0, collider_type="sphere")
    jmodel, np_params, tmodel = _small_models(
        "neus-acc", JSceneBox(**kw), TSceneBox(**kw), {"grid_resolution": 16, "num_samples_acc": 32})
    # the refresh at a sharper NeuS opacity (inv_s = e^6) than the initial e^3, so that it
    # prunes; the step then runs at the initial one on that grid
    deviation = np_params["field"]["deviation"]
    np_params["field"]["deviation"] = np.full((1,), 0.6, np.float32)
    params_from_jax(tmodel, np_params)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    jms = jmodel.update_model_state(jparams, jmodel.init_model_state(), jnp.asarray(0), None)
    tms = tmodel.update_model_state(tmodel.init_model_state(), 0, None)
    _close(tms.occs.numpy(), np.asarray(jms.occs), rtol=1e-4, atol=1e-6)
    assert tms.binary.any() and not tms.binary.all()
    np_params["field"]["deviation"] = deviation
    params_from_jax(tmodel, np_params)
    _compare_step("neus-acc", jmodel, np_params, tmodel, jms, _jax_state_to_port(jms, tms), 20,
                  monkeypatch)
