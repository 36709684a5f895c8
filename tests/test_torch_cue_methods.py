"""The six cue-supervised entries -- ``monosdf``, ``mono-neus``,
``mono-unisurf`` (MonoSDF's monocular depth and normal losses) and
``geo-neus``, ``geo-volsdf``, ``geo-unisurf`` (Geo-NeuS's patch warping,
with the flexible data manager) -- against the JAX package, on the CPU.

Each entry carries JAX's registry values (model, SDF field, parser,
data manager, trainer, optimizer groups and schedules) and builds JAX's
full-size parameter tree, and one shrunk train step holds JAX's: a 2-layer
field of 32 (outward-facing, ``inside_outside=False``: from the registered
inward init no ray from outside the object crosses from + to -, so the
geo term would be empty), each sampler's counts cut to a few, the NeRF
background at its fixed width with 4 samples a ray, patch 3 and top-k 2 as
JAX's own ``test_flexible_datamanager_geo_neus``. The scene is the DTU-like
object (textured: a 3x3 patch of a smooth sphere falls below
``min_patch_variance``) in 12 views of 40 x 40 with monocular cues,
``pairs.txt`` of 4 ring neighbours and SfM point files
(``data/synthetic_dtu.py``),
parsed by each package with the entry's own parser options. 32 rays drawn
from a numpy seed on the object's silhouette (for the geo entries in one
reference image, with its sources as JAX's flexible sampler hands them
over); both data managers give the same batch, and both models take the
same rays, without jitter; UniSurf's smoothness noise is JAX's
(``PRNGKey(0)``), handed to the port.

Tolerances: the loss dict to 1e-4 relative in float32, as
``tests/test_torch_surface_methods.py`` holds the classic methods' steps;
every gradient in float64 to 1e-4 of its scale (max |JAX grad|), JAX under
``jax.enable_x64`` with its dense layers kept in float64 (``_F64Dot``:
they otherwise round each layer to float32); and in float32 to 5e-4 of
its scale wherever each side's float32 gradient lies within 2.5e-4 of its
own float64 one. Elsewhere the float32 step is ill-conditioned in either
package, and a comparison would test rounding: on rays that all hit the
object the background's share is the last transmittance, a product of
``1 - alpha`` near 0, and the depth term solves a 2x2 system whose
determinant cancels. JAX's own float32 gradients there differ from its
float64 ones by up to 1.9e-2 of their scale. At least 10 parameters of
every step are held in float32 (10 of 43 for ``geo-volsdf``, 42 of 43 for
``monosdf``). The rays lie on the object: on a ray
that misses it the rendered normal and depth are ~0 and their
normalisation has no precision left in float32 (up to 4e-2 of scale
between JAX's own steps), and it warps no patch. In float32 the warp's
hard decisions are first checked clear of rounding
(``tests/test_torch_cues.py::_margins``) and the validity masks held equal.
Each geo case first asserts that the patch term is not vacuous: enough
rays with a crossing and a fully valid source patch, and a patch loss
above 0.
"""
import copy
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from sdfstudio_tpu.configs.methods import get_method_config as jget_method_config
from sdfstudio_tpu.data.datamanager import DataManagerConfig as JDataManagerConfig
from sdfstudio_tpu.data.datamanager import FlexibleDataManager as JFlexibleDataManager
from sdfstudio_tpu.data.datamanager import VanillaDataManager as JVanillaDataManager
from sdfstudio_tpu.data.datamanager import gather_cameras
from sdfstudio_tpu.data.dataparsers.sdfstudio import SDFStudio as JSDFStudio
from sdfstudio_tpu.ops import mlp as jmlp

from sdfstudio_tpu_torch.configs.methods import MethodConfig, build_model, get_method_config
from sdfstudio_tpu_torch.core.rays import RayBundle as TRayBundle
from sdfstudio_tpu_torch.core.scene_box import SceneBox as TSceneBox
from sdfstudio_tpu_torch.data import png
from sdfstudio_tpu_torch.data.datamanager import DataManagerConfig, FlexibleDataManager
from sdfstudio_tpu_torch.data.dataparsers.sdfstudio import parse_config
from sdfstudio_tpu_torch.data.synthetic_dtu import generate_dtu_like_dataset, write_pairs_and_sfm_points
from sdfstudio_tpu_torch.engine.optimizers import build_optimizers
from sdfstudio_tpu_torch.engine.trainer import group_grads, loss_and_metrics
from sdfstudio_tpu_torch.fields.sdf_field import SDFFieldConfig as TSDFFieldConfig
from sdfstudio_tpu_torch.models import base_surface_model
from sdfstudio_tpu_torch.scripts import train as train_script
from sdfstudio_tpu_torch.utils.convert import params_from_jax
from tests.test_torch_cues import _margins
from tests.test_torch_presets import _full_tree_matches
from tests.test_torch_surface_methods import _given, _port_tree, _t
from tests.test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

METHODS = ["monosdf", "mono-neus", "mono-unisurf", "geo-neus", "geo-volsdf", "geo-unisurf"]
BASE = {"monosdf": "volsdf", "mono-neus": "neus", "mono-unisurf": "unisurf", "geo-neus": "neus",
        "geo-volsdf": "volsdf", "geo-unisurf": "unisurf"}
CUTS = {
    "neus": dict(num_samples=8, num_samples_importance=8, num_up_sample_steps=2),
    "volsdf": dict(num_samples=8, num_samples_eval=8, num_samples_extra=4, max_total_iters=3),
    "unisurf": dict(num_samples_interval=8, num_samples_importance=4, num_marching_steps=16),
}
SMALL_FIELD = dict(num_layers=2, hidden_dim=32, geo_feat_dim=16, num_layers_color=2,
                   hidden_dim_color=32, num_levels=4, inside_outside=False)
RAYS = 32
STEP = 1000
VIEWS = 12  # 30 degrees apart: the pairs' sources (+2, -2, +1 after the parser's quirk) see the object


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("cue_methods") / "dtu_like"
    generate_dtu_like_dataset(d, num_images=VIEWS, width=40, height=40, with_mono_prior=True)
    return write_pairs_and_sfm_points(d, num_pair_srcs=4, points_per_view=16)


@pytest.mark.parametrize("method", METHODS)
def test_registered_entry_matches_jax(method):
    """JAX's registry values at every path, the full-size tree leaf for leaf."""
    port = _full_tree_matches(method)
    jcfg, tcfg = jget_method_config(method), get_method_config(method)
    for f in dataclasses.fields(tcfg.dataparser):
        assert getattr(tcfg.dataparser, f.name) == getattr(jcfg.dataparser, f.name), f.name
    for f in dataclasses.fields(tcfg.datamanager):
        got, ref = getattr(tcfg.datamanager, f.name), getattr(jcfg.datamanager, f.name)
        if dataclasses.is_dataclass(got):  # the camera optimizer's config, field for field
            got, ref = dataclasses.asdict(got), dataclasses.asdict(ref)
        assert got == ref, f.name
    assert tcfg.model_class.__name__ == jcfg.model_class.__name__
    assert set(tcfg.optimizers) == set(jcfg.optimizers) == {"field", "field_background"}
    assert port["field.glin8.kernel"] == (256, 257) and "field_background.mlp_head.layers.0.kernel" in port
    mono, geo = method.startswith("mono") or method == "monosdf", method.startswith("geo")
    assert tcfg.dataparser.include_mono_prior == mono and tcfg.dataparser.load_pairs == geo
    assert (tcfg.datamanager.kind == "flexible") == geo
    assert (tcfg.model.patch_warp_loss_mult, tcfg.model.mono_depth_loss_mult,
            tcfg.model.mono_normal_loss_mult) == ((0.1, 0.0, 0.0) if geo else (0.0, 0.1, 0.05))


def _models(method, seed=0):
    jcfg = jget_method_config(method).model
    jsdf = dataclasses.replace(jcfg.sdf_field, **SMALL_FIELD)
    extra = dict(patch_size=3, topk=2) if method.startswith("geo") else {}
    jcfg = dataclasses.replace(jcfg, sdf_field=jsdf, num_samples_outside=4, **CUTS[BASE[method]],
                               **extra)
    tsdf = TSDFFieldConfig(**{f.name: getattr(jsdf, f.name) for f in dataclasses.fields(TSDFFieldConfig)})
    tcls = type(get_method_config(method).model)
    tcfg = tcls(**{f.name: tsdf if f.name == "sdf_field" else getattr(jcfg, f.name)
                   for f in dataclasses.fields(tcls)})
    return jcfg, tcfg, seed


def _data(method, scene):
    """JAX's and the port's parse of ``scene`` with the entry's parser, JAX's
    draw of a batch, and the port's batch at the same indices."""
    jcfg, tcfg = jget_method_config(method), get_method_config(method)
    jpc = dataclasses.replace(jcfg.dataparser, data=scene)
    jout = JSDFStudio(jpc).get_dataparser_outputs("train")
    tout = parse_config(dataclasses.replace(tcfg.dataparser, data=scene))
    jdmc = JDataManagerConfig(train_num_rays_per_batch=RAYS, kind=jcfg.datamanager.kind)
    tdmc = DataManagerConfig(train_num_rays_per_batch=RAYS, kind=tcfg.datamanager.kind)
    # pixels on the object: on a ray that misses it the rendered normal and
    # depth are ~0 and their normalisation is ill-conditioned in either
    # package, and it warps no patch (see the module's docstring)
    rng = np.random.default_rng(5)
    on = np.argwhere(np.stack([png.read_png(scene / f"{i:06d}_foreground_mask.png") > 0
                               for i in range(VIEWS)]))
    if method.startswith("geo"):
        jdm = JFlexibleDataManager(jdmc, jout)
        tdm = FlexibleDataManager(tdmc, tout, device="cpu")
        on = on[on[:, 0] == rng.integers(VIEWS)]
        idx = on[rng.choice(len(on), RAYS, replace=False)].astype(np.int32)
        ref = int(idx[0, 0])
        # JAX's sample_train_batch_flexible (datamanager.py:304-332) at these pixels
        src = jdm.pairs_srcs[ref]
        jadd = {"uv": jnp.asarray(idx[:, 1:]), "src_idxs": src, "src_imgs": jdm.train_data["image"][src],
                "src_cameras": gather_cameras(jdm.train_cameras, src)}
        jbatch = {k: v[idx[:, 0], idx[:, 1], idx[:, 2]] for k, v in jdm.train_data.items()}
        tidx, tbatch, tadd = tdm.flexible_batch(torch.tensor(ref), torch.from_numpy(idx[:, 1]).long(),
                                                torch.from_numpy(idx[:, 2]).long())
        assert np.array_equal(tidx.numpy(), idx)
        for k in ("uv", "src_idxs", "src_imgs"):
            np.testing.assert_array_equal(tadd[k].numpy(), np.asarray(jadd[k]))
    else:
        jdm = JVanillaDataManager(jdmc, jout)
        idx = on[rng.choice(len(on), RAYS, replace=False)].astype(np.int32)
        jbatch = {k: v[idx[:, 0], idx[:, 1], idx[:, 2]] for k, v in jdm.train_data.items()}
        tdata = {k: torch.from_numpy(np.asarray(v)) for k, v in jdm.train_data.items()}
        tbatch = {k: v[idx[:, 0], idx[:, 1], idx[:, 2]] for k, v in tdata.items()}
        jadd = tadd = None
    assert sorted(tbatch) == sorted(jbatch) == (["image"] if method.startswith("geo") else
                                                ["depth", "image", "normal"])
    for k in jbatch:
        np.testing.assert_array_equal(tbatch[k].numpy(), np.asarray(jbatch[k]))
    jb = jdm.generate_rays(None, jnp.asarray(idx), train=True)
    tb = TRayBundle(*[_t(getattr(jb, k)) for k in ("origins", "directions", "pixel_area")],
                    camera_indices=torch.from_numpy(idx[:, 0]).long(),
                    directions_norm=_t(jb.directions_norm))
    return jout.scene_box, jb, {k: np.asarray(v) for k, v in jbatch.items()}, jadd, tb, tadd


class _F64Dot:
    """``jax.numpy`` for ``sdfstudio_tpu/ops/mlp.py`` in the float64 step:
    its dense layers ask for a float32 result (``preferred_element_type``,
    mlp.py:86, 237-242), which under ``jax.enable_x64`` rounds every layer
    to float32; here a float64 product stays float64."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def dot(a, b, preferred_element_type=None, **kw):
        if preferred_element_type is not None and jnp.result_type(a, b) == jnp.float64:
            preferred_element_type = jnp.float64
        return jnp.dot(a, b, preferred_element_type=preferred_element_type, **kw)


def _f64(a):
    a = np.asarray(a)
    return jnp.asarray(a.astype(np.float64) if a.dtype == np.float32 else a)


def _port_f64(x):
    if torch.is_tensor(x):
        return x.double() if x.is_floating_point() else x
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: _port_f64(getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: _port_f64(v) for k, v in x.items()}
    return x


def _jax_step(jmodel, params, jb, batch, jadd, dtype, terms=None):
    sched = jmodel.schedules(jnp.asarray(float(STEP), dtype))

    def loss(p):
        if jadd is not None:
            out = jmodel.get_outputs_flexible(p, jb, jadd, rng=None, sched=sched, train=True)
        else:
            out = jmodel.get_outputs(p, jb, rng=None, sched=sched, train=True)
        ld = jmodel.get_loss_dict(p, out, batch, sched, None)
        return sum(v for k, v in ld.items() if terms is None or terms(k)), (ld, out.get("patches_valid_mask"))

    (total, (ld, valid)), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return total, ld, valid, _port_tree(g)


def _port_step(tmodel, tb, batch, tadd, sched, method, noise):
    """(total, loss dict, outputs) of the port's step without jitter."""
    if BASE[method] == "unisurf":
        if tadd is not None:
            out = tmodel.get_outputs_flexible(tb, tadd, sched=sched, train=True, rng=None)
        else:
            out = tmodel.get_outputs(tb, sched=sched, train=True, rng=None)
        ld = tmodel.get_loss_dict(out, batch, sched, rng=_given(noise))
        return sum(ld.values()), ld, out
    captured = {}
    attr = "get_outputs_flexible" if tadd is not None else "get_outputs"
    orig = getattr(tmodel, attr)

    def capture(*a, **kw):
        captured.update(orig(*a, **kw))
        return captured

    setattr(tmodel, attr, capture)
    try:
        total, ld, _ = loss_and_metrics(tmodel, tb, batch, sched, None, tadd)
    finally:
        delattr(tmodel, attr)
    return total, ld, captured


@pytest.mark.parametrize("method", METHODS)
def test_shrunk_train_step_matches_jax(method, scene, monkeypatch):
    jcfg, tcfg, seed = _models(method)
    scene_box, jb, batch, jadd, tb, tadd = _data(method, scene)
    jmodel = jget_method_config(method).model_class(jcfg, scene_box, VIEWS)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        name = jax.tree_util.keystr(path)
        a = np.asarray(a)
        if "deviation" in name or "laplace_beta" in name:
            return a
        return (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32)

    np_params = jax.tree_util.tree_map_with_path(perturb, params)
    tsb = TSceneBox(aabb=np.asarray(scene_box.aabb), near=scene_box.near, far=scene_box.far,
                    radius=scene_box.radius, collider_type=scene_box.collider_type)
    tmodel = build_model(MethodConfig(f"small-{method}", get_method_config(method).model_class, tcfg),
                         tsb, VIEWS, device="cpu")
    params_from_jax(tmodel, np_params)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: _t(v) for k, v in batch.items()}
    noise = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (RAYS, 3)))
    tsched = tmodel.schedules(STEP)

    warp_args = []
    real_warp = base_surface_model.patch_warping
    monkeypatch.setattr(base_surface_model, "patch_warping",
                        lambda *a, **kw: warp_args.append(a) or real_warp(*a, **kw))
    ref_total, ref_ld, ref_valid, ref_g = _jax_step(jmodel, jax.tree_util.tree_map(jnp.asarray, np_params),
                                                    jb, jbatch, jadd, jnp.float32)
    total, ld, out = _port_step(tmodel, tb, tbatch, tadd, tsched, method, noise)
    if method.startswith("geo"):
        samples, sdf, normal, _, _, pix = warp_args[0]
        m = _margins(samples, sdf.detach(), normal.detach(), tadd["src_cameras"], pix, size=3,
                     hw=tuple(tadd["src_imgs"].shape[1:3]))
        assert min(m.values()) > 1e-5, f"a warp decision lies within f32 rounding: {m}"
        valid = out["patches_valid_mask"]
        assert np.array_equal(valid.numpy(), np.asarray(ref_valid))
        counted = int((valid[1:].all(dim=2).any(dim=0)).sum())  # rays with a fully valid source patch
        assert counted >= 8 and float(ref_ld["patch_loss"]) > 0, counted

    else:
        assert float(ref_ld["normal_loss"]) > 0 and float(ref_ld["depth_loss"]) > 0
    assert sorted(ld) == sorted(ref_ld)
    for k in ld:
        np.testing.assert_allclose(ld[k].detach().numpy(), np.asarray(ref_ld[k]), rtol=1e-4, atol=0)
    np.testing.assert_allclose(total.detach().numpy(), np.asarray(ref_total), rtol=1e-4, atol=0)

    opts = build_optimizers(get_method_config(method).optimizers, tmodel)
    grads = group_grads(total, opts)
    # the same step in float64 on both sides, JAX's dense layers in float64 too
    monkeypatch.setenv("SST_MLP_DTYPE", "float64")
    monkeypatch.setattr(jmlp, "jnp", _F64Dot())
    with jax.enable_x64():
        jadd64 = None if jadd is None else jax.tree_util.tree_map(_f64, jadd)
        _, _, _, ref_g64 = _jax_step(jmodel, jax.tree_util.tree_map(_f64, np_params),
                                     jax.tree_util.tree_map(_f64, jb),
                                     {k: _f64(v) for k, v in batch.items()}, jadd64, jnp.float64)
        noise64 = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (RAYS, 3)))
    m64 = copy.deepcopy(tmodel).double()
    total64, _, _ = _port_step(m64, _port_f64(tb), _port_f64(tbatch), _port_f64(tadd), tsched,
                               method, noise64)
    names = [n for n, _ in m64.named_parameters()]
    g64 = dict(zip(names, torch.autograd.grad(total64, list(m64.parameters()), allow_unused=True)))
    seen = f32_held = 0
    for group, opt in opts.items():
        for name, g in zip(opt.names, grads[group]):
            ref, ref64 = ref_g[name], ref_g64[name]
            if g is None:
                assert not np.any(ref) and g64[name] is None, name
                continue
            scale, scale64 = float(np.abs(ref).max()), float(np.abs(ref64).max())
            assert scale > 0 and scale64 > 0, name
            assert float(np.abs(g64[name].numpy() - ref64).max()) <= 1e-4 * scale64, name
            # float32 where each side's float32 step is within half the
            # tolerance of its own float64 one; elsewhere it would test rounding
            own = max(float(np.abs(ref - ref64).max()),
                      float(np.abs(g.numpy() - g64[name].numpy()).max()))
            if own <= 2.5e-4 * scale64:
                assert float(np.abs(g.numpy() - ref).max()) <= 5e-4 * scale, name
                f32_held += 1
            seen += 1
    assert seen >= 40 and f32_held >= 10, (seen, f32_held)


@pytest.mark.parametrize("method,extra", [
    ("monosdf", []),
    ("geo-neus", ["--pipeline.model.patch-size", "3", "--pipeline.model.sdf-field.inside-outside",
                  "False"]),
])
def test_train_command_runs_the_entry_and_writes_jax_layout(method, extra, scene, tmp_path):
    """``scripts/train.py <method>`` at full width on the CPU, 16 rays, 2
    steps, with the entry's registered parser (geo-neus reads the pairs and
    the SfM files): the run's ``config.yml`` and its checkpoint directory."""
    out = tmp_path / "runs"
    argv = [method, "--experiment-name", "x", "--output-dir", str(out), "--timestamp", "t",
            "--vis", "none", "--device", "cpu", "--trainer.max-num-iterations", "2",
            "--pipeline.datamanager.train-num-rays-per-batch", "16", *extra,
            "sdfstudio-data", "--data", str(scene)]
    assert train_script.main(argv) == 0
    run = out / "x" / method / "t"
    assert (run / "sdfstudio_models" / "step-000000002" / "step.txt").read_text() == "2"
    tree = yaml.safe_load((run / "config.yml").read_text())
    assert tree == json.loads((run / "config.yml").read_text())
    assert tree["method_name"] == method and tree["datamanager"]["kind"] == (
        "flexible" if method == "geo-neus" else "vanilla")
    assert tree["dataparser"]["include_mono_prior"] == (method == "monosdf")
    if method == "geo-neus":
        assert tree["model"]["patch_size"] == 3 and tree["dataparser"]["include_sfm_points"]


def test_flexible_step_takes_one_batch_without_accumulation(scene):
    """With the flexible data manager a step draws ``train_num_rays_per_batch``
    rays from one reference image and takes one gradient, whatever
    ``accumulate_grad_steps`` says: JAX's accumulation scan runs only
    without the flexible inputs (trainer.py:330-336, 366)."""
    trainer = train_script.setup_method_trainer("geo-neus", scene, num_rays=16, device="cpu",
                                                accumulate_grad_steps=2)
    dm = trainer.datamanager
    draws = []
    sample = dm.sample_train_batch_flexible
    dm.sample_train_batch_flexible = lambda gen: draws.append(sample(gen)) or draws[-1]
    vec = trainer.train_step()
    assert trainer.rays_multiple() == 1 and len(draws) == 1
    idx, batch, additional = draws[0]
    assert idx.shape == (16, 3) and len(set(idx[:, 0].tolist())) == 1
    # the 4 ring neighbours of pairs.txt leave 3 sources after the parser's quirk
    assert additional["src_idxs"][0] == idx[0, 0] and additional["src_imgs"].shape[0] == 4
    assert "patch_loss" in trainer.metric_keys and bool(torch.isfinite(vec).all())
