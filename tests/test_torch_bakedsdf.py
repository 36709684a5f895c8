"""The BakedSDF family -- ``bakedsdf``, ``bakedsdf-mlp`` and ``bakedangelo``
-- and its parts against the JAX package, on the CPU.

- The off-axis positional encoding (the icosahedron's 21 directions):
  values to 1e-10 and ``out_dim`` in float64.
- ``SDFField.colors`` against JAX's ``SDFFieldNet.colors`` with the default
  options and with BakedSDF's (diffuse colour, specular tint, reflections,
  n.d, off-axis), at small widths on JAX's perturbed parameters: 1e-6 in
  float32 (with the heads' and the first colour layer's gradients to 1e-5
  of their scale) and 1e-12 in float64.
- The three entries' schedules (proposal anneal, beta, eikonal weight,
  numerical delta, hash mask, curvature factor) at steps from 0 to 1M,
  exactly in float32 (``bakedsdf``'s with ``use_anneal_eikonal_weight``
  too, which no entry sets).
- The loss dict on given outputs: the spatially varying eikonal loss on
  points inside and outside the unit ball, the mean one times the annealed
  weight, and mip-NeRF 360's interlevel loss, 1e-6.
- The mipnerf360 parser on ``.parity/heritage_like``: file names, poses,
  intrinsics, both splits, the scene box, the transform and the scale, to
  1e-6.
- One train step of each entry, shrunk (a few hash levels, widths of
  16-64, a 2-layer colour net, 16 + 8 proposal samples and 8 field
  samples; ``bakedangelo``'s F = 8 grid with a partial mask and the
  ``"grid"`` background at its fixed full width), JAX's parameters carried
  in by ``params_from_jax``, the same rays without jitter: each loss to
  1e-4 relative and every gradient to 5e-4 of its scale (max |JAX grad|)
  in float32, and to 1e-4 in float64 (JAX under ``jax.enable_x64`` with
  its dense layers in float64).
- The registered trees against JAX's, field for field, at full size.
- ``bakedsdf mipnerf360-data --data <scene>`` parses to JAX's config tree,
  and two steps train at JAX's ``test_bakedsdf_on_heritage_colmap`` sizes.
- A JAX-initialised full-size ``bakedsdf`` tree loads leaf for leaf and
  renders a few rays within 1e-5 of JAX.
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
from sdfstudio_tpu.core.rays import RaySamples as JRaySamples
from sdfstudio_tpu.core.scene_box import SceneBox as JSceneBox
from sdfstudio_tpu.data.dataparsers.colmap_family import (
    Mipnerf360 as JMipnerf360,
    Mipnerf360DataParserConfig as JMPC,
)
from sdfstudio_tpu.fields.sdf_field import SDFField as JSDFField
from sdfstudio_tpu.fields.sdf_field import SDFFieldConfig as JSDFFieldConfig
from sdfstudio_tpu.fields.sdf_field import SDFFieldNet
from sdfstudio_tpu.ops.encodings import nerf_encoding as jnerf_encoding
from sdfstudio_tpu.ops.encodings import nerf_encoding_dim

from sdfstudio_tpu_torch.configs.methods import get_method_config, method_configs
from sdfstudio_tpu_torch.core.rays import RaySamples as TRaySamples
from sdfstudio_tpu_torch.core.scene_box import SceneBox as TSceneBox
from sdfstudio_tpu_torch.data.dataparsers.colmap_family import (
    Mipnerf360DataParserConfig,
    parse_mipnerf360,
)
from sdfstudio_tpu_torch.engine.optimizers import build_optimizers
from sdfstudio_tpu_torch.engine.trainer import group_grads, loss_and_metrics
from sdfstudio_tpu_torch.fields.sdf_field import SDFField as TSDFField
from sdfstudio_tpu_torch.fields.sdf_field import SDFFieldConfig as TSDFFieldConfig
from sdfstudio_tpu_torch.ops.encodings import NeRFEncoding
from sdfstudio_tpu_torch.scripts import train as train_script
from sdfstudio_tpu_torch.utils.convert import params_from_jax
from tests.test_torch_background import _perturbed
from tests.test_torch_occupancy import STEP, _f64_grads, _jax_grads, _scene_rays, _small_models
from tests.test_torch_presets import _full_tree_matches
from tests.test_torch_train import _close, _port_tree, _t
from tests.test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

SCENE = pathlib.Path(__file__).resolve().parents[1] / ".parity" / "heritage_like"
BAKED = ("bakedsdf", "bakedsdf-mlp", "bakedangelo")
REF_NERF = dict(use_diffuse_color=True, use_specular_tint=True, use_reflections=True,
                use_n_dot_v=True, off_axis=True)
SCHED_STEPS = (0, 1, 500, 999, 1000, 5000, 20000, 250000, 1000000)
KW = dict(near=0.05, far=4.0, radius=1.0, collider_type="near_far")
PROPS = ({"hidden_dim": 16, "log2_hashmap_size": 10, "num_levels": 3, "max_res": 64},
         {"hidden_dim": 16, "log2_hashmap_size": 10, "num_levels": 3, "max_res": 256})
SAMPLES = dict(num_proposal_samples_per_ray=(16, 8), num_neus_samples_per_ray=8,
               proposal_net_args_list=PROPS)
# each entry shrunk: bakedsdf-mlp keeps its skip at layer 4 (53-wide input: xyz, 42 off-axis PE
# of degree 1, 8 zero grid features); bakedangelo's F = 8 grid over 6 levels with a partial mask
SMALL = {
    "bakedsdf": (dict(num_layers=2, hidden_dim=32, geo_feat_dim=16, hidden_dim_color=32,
                      num_levels=4, max_res=64, log2_hashmap_size=10,
                      position_encoding_max_degree=3), {}),
    "bakedsdf-mlp": (dict(num_layers=5, hidden_dim=64, geo_feat_dim=16, hidden_dim_color=32,
                          num_levels=4, position_encoding_max_degree=1), {}),
    "bakedangelo": (dict(hidden_dim=32, geo_feat_dim=32, hidden_dim_color=32, num_levels=6,
                         base_res=4, max_res=64, log2_hashmap_size=10, num_layers_color=2),
                    dict(level_init=2, steps_per_level=10, curvature_loss_warmup_steps=60,
                         beta_anneal_max_num_iters=100, num_samples_outside=4)),
}


def _f64(a):
    a = np.asarray(a)
    return jnp.asarray(a.astype(np.float64) if a.dtype == np.float32 else a)


@pytest.mark.parametrize("include_input", [False, True])
def test_off_axis_encoding_matches_jax(include_input):
    x = np.random.default_rng(0).uniform(-2.0, 2.0, (64, 3))
    enc = NeRFEncoding(3, 8, 0.0, 7.0, include_input, off_axis=True)
    with jax.enable_x64():
        ref = np.asarray(jnerf_encoding(jnp.asarray(x), 8, 0.0, 7.0, include_input, off_axis=True))
    got = enc(torch.from_numpy(x)).numpy()
    assert enc.out_dim == nerf_encoding_dim(3, 8, include_input, True) == got.shape[-1]
    assert enc.out_dim == 336 + 3 * include_input
    _close(got, ref, rtol=0, atol=1e-10)
    # the projection is x @ P, P [3, 21] as JAX stores it; the frequency axis is minor
    from sdfstudio_tpu.ops.encodings import OFF_AXIS_P

    _close(got[:, :8], np.sin((x @ OFF_AXIS_P.astype(np.float64))[:, :1] * 2.0 ** np.arange(8)),
           rtol=0, atol=1e-10)


def _colour_inputs(n=48, seed=3, geo=16, cams=4):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (rng.uniform(-1.5, 1.5, (n, 3)), d, rng.standard_normal((n, 3)),
            rng.standard_normal((n, geo)), rng.integers(0, cams, n).astype(np.int32))


@pytest.mark.parametrize("options", ["default", "bakedsdf"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_colors_match_jax(options, dtype, monkeypatch):
    """The colour head on the same inputs and parameters; the diffuse
    colour's clip and the tint both take part (some outputs clip)."""
    small = dict(num_layers=2, hidden_dim=32, geo_feat_dim=16, num_layers_color=2,
                 hidden_dim_color=32, position_encoding_max_degree=3, use_appearance_embedding=True,
                 **(REF_NERF if options == "bakedsdf" else {}))
    jfield = JSDFField(JSDFFieldConfig(**small), num_images=4, spatial_distortion="inf")
    params = _perturbed(jax.jit(jfield.init)(jax.random.PRNGKey(5)), 6)
    tfield = TSDFField(TSDFFieldConfig(**small), num_images=4, spatial_distortion="inf")
    params_from_jax(tfield, params)
    if options == "bakedsdf":
        assert tfield.cdims[0] == 27 + 16 + 32 + 1
        assert tuple(tfield.diffuse_color_pred.kernel.shape) == (16, 3)
    else:
        assert tfield.diffuse_color_pred is None and tfield.cdims[0] == 3 + 27 + 3 + 16 + 32
    pts, d, g, geo, cams = _colour_inputs()

    def jcolors(p, *a):
        return jfield.module.apply({"params": p}, *a, True, False, method=SDFFieldNet.colors)

    if dtype == "float64":
        from sdfstudio_tpu.ops import mlp as jmlp

        from tests.test_torch_cue_methods import _F64Dot

        monkeypatch.setenv("SST_MLP_DTYPE", "float64")
        monkeypatch.setattr(jmlp, "jnp", _F64Dot())
        with jax.enable_x64():
            ref = np.asarray(jcolors(jax.tree_util.tree_map(_f64, params), *map(_f64, (pts, d, g, geo)),
                                     jnp.asarray(cams)))
        tf = copy.deepcopy(tfield).double()
        got = tf.colors(*(torch.from_numpy(a) for a in (pts, d, g, geo)),
                        torch.from_numpy(cams).long(), train=True).detach().numpy()
        assert got.dtype == ref.dtype == np.float64
        _close(got, ref, rtol=0, atol=1e-12)
        return
    w = np.random.default_rng(8).uniform(0, 1, (48, 3)).astype(np.float32)
    f32 = [a.astype(np.float32) for a in (pts, d, g, geo)]

    def jloss(p):
        rgb = jcolors(p, *map(jnp.asarray, f32), jnp.asarray(cams))
        return jnp.sum(rgb * w), rgb

    (_, ref), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params))
    rgb = tfield.colors(*map(_t, f32), torch.from_numpy(cams).long(), train=True)
    _close(rgb.detach().numpy(), ref, rtol=0, atol=1e-6)
    if options == "bakedsdf":  # the clip is active on some outputs
        raw = np.asarray(ref)
        assert np.any(raw <= -0.001 + 1e-7) or np.any(raw >= 1.001 - 1e-7)
    named = dict(tfield.named_parameters())
    names = ["clin0.kernel", "clin0.g"] + ([f"{h}.{k}" for h in ("diffuse_color_pred",
                                                                    "specular_tint_pred")
                                            for k in ("kernel", "bias")]
                                           if options == "bakedsdf" else [])
    grads = torch.autograd.grad((rgb * _t(w)).sum(), [named[n] for n in names])
    ref_g = _port_tree(jg)
    for n, gr in zip(names, grads):
        scale = float(np.abs(ref_g[n]).max())
        assert scale > 0 and float(np.abs(gr.numpy() - ref_g[n]).max()) <= 1e-5 * scale, n


def _models_at(method, sdf_kw=None, model_kw=None):
    """JAX's and the port's ``method`` (its schedules read the field's
    levels and resolutions, not its table: a 2^10 table here)."""
    jcfg = jget_method_config(method).model
    jcfg = dataclasses.replace(jcfg, sdf_field=dataclasses.replace(
        jcfg.sdf_field, log2_hashmap_size=10, hidden_dim=min(jcfg.sdf_field.hidden_dim, 256),
        **(sdf_kw or {})), **(model_kw or {}))
    tcls = type(get_method_config(method).model)
    tsdf = TSDFFieldConfig(**{f.name: getattr(jcfg.sdf_field, f.name)
                              for f in dataclasses.fields(TSDFFieldConfig)})
    tcfg = tcls(**{f.name: tsdf if f.name == "sdf_field" else getattr(jcfg, f.name)
                   for f in dataclasses.fields(tcls)})
    return (jget_method_config(method).model_class(jcfg, JSceneBox(), 3),
            get_method_config(method).model_class(tcfg, TSceneBox(), 3))


@pytest.mark.parametrize("method,model_kw", [("bakedsdf", {}), ("bakedsdf-mlp", {}),
                                             ("bakedangelo", {}),
                                             ("bakedsdf", {"use_anneal_eikonal_weight": True})])
def test_schedules_match_jax(method, model_kw):
    """Every scheduled value exactly, in float32 on both sides."""
    jmodel, tmodel = _models_at(method, {"num_layers": 2} if method == "bakedsdf-mlp" else None,
                                model_kw)
    keys = {"cos_anneal_ratio", "proposal_anneal", "beta_override"}
    if model_kw:
        keys.add("eikonal_mult")
    if method == "bakedangelo":
        keys |= {"numerical_delta", "hash_mask", "curvature_factor"}
    for step in SCHED_STEPS:
        js = jmodel.schedules(jnp.asarray(float(step), jnp.float32))
        ts = tmodel.schedules(step)
        assert set(ts) == set(js) == keys, step  # no train_proposal: the nets train every step
        for k in keys - {"hash_mask"}:
            assert np.float32(ts[k]) == np.asarray(js[k], np.float32), (step, k, ts[k], js[k])
        if method == "bakedangelo":
            assert np.array_equal(ts["hash_mask"].numpy(), np.asarray(js["hash_mask"])), step
    if method == "bakedangelo":  # the mask grows, the delta shrinks, the warmup ends
        s0, s1 = tmodel.schedules(0), tmodel.schedules(1_000_000)
        assert s0["hash_mask"].sum() < s1["hash_mask"].sum() == 128
        assert s0["numerical_delta"] > s1["numerical_delta"] == pytest.approx(4 / (4 * 4096))
        assert s0["curvature_factor"] == 0.0 < tmodel.schedules(20000)["curvature_factor"]


def _samples(R, n, seed, lo, hi):
    """The same random bins on both sides, as JAX's and the port's RaySamples."""
    rng = np.random.default_rng(seed)
    edges = np.sort(rng.uniform(lo, hi, (R, n + 1)), axis=-1).astype(np.float32)
    kw = dict(pixel_area=np.full((R, 1), 1e-5, np.float32), starts=edges[:, :-1],
              ends=edges[:, 1:], spacing_starts=edges[:, :-1], spacing_ends=edges[:, 1:])
    o = np.zeros((R, 3), np.float32)
    d = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (R, 1))
    j = JRaySamples(jnp.asarray(o), jnp.asarray(d), **{k: jnp.asarray(v) for k, v in kw.items()})
    t = TRaySamples(_t(o), _t(d), **{k: _t(v) for k, v in kw.items()})
    return j, t


@pytest.mark.parametrize("method,model_kw", [
    ("bakedsdf-mlp", {}),  # the spatially varying eikonal loss
    ("bakedsdf", {"use_anneal_eikonal_weight": True}),  # the annealed weight
    ("bakedsdf", {"interlevel_loss_mult": 0.5}),  # the configured weight
])
def test_loss_dict_matches_jax(method, model_kw):
    """The loss dict on given outputs: rgb L1, the eikonal loss over points
    inside the unit ball and outside it up to the contraction's corner
    (|p| = 2 sqrt 3), and the interlevel loss of two proposal levels."""
    jmodel, tmodel = _models_at(method, {"num_layers": 2}, model_kw)
    rng = np.random.default_rng(11)
    R, S = 16, 8
    grad = rng.standard_normal((R, S, 3)).astype(np.float32)
    norm = rng.uniform(0.0, 2 * np.sqrt(3), (R, S)).astype(np.float32)
    assert (norm < 1).any() and (norm > 2).any()
    samples = [_samples(R, n, 20 + i, 0.0, 1.0) for i, n in enumerate((16, 12, S))]
    weights = [rng.uniform(0, 1, (R, n)).astype(np.float32) / n for n in (16, 12, S)]
    rgb, image = rng.uniform(0, 1, (2, R, 3)).astype(np.float32)
    jout = {"rgb": jnp.asarray(rgb), "eik_grad": jnp.asarray(grad), "points_norm": jnp.asarray(norm),
            "weights_list": [jnp.asarray(w) for w in weights],
            "ray_samples_list": [j for j, _ in samples]}
    tout = {"rgb": _t(rgb), "eik_grad": _t(grad), "points_norm": _t(norm),
            "weights_list": [_t(w) for w in weights], "ray_samples_list": [t for _, t in samples]}
    step = 123_456
    ref = jmodel.get_loss_dict(None, jout, {"image": jnp.asarray(image)},
                               jmodel.schedules(jnp.asarray(float(step), jnp.float32)), None)
    got = tmodel.get_loss_dict(tout, {"image": _t(image)}, tmodel.schedules(step), None)
    assert set(got) == set(ref) == {"rgb_loss", "eikonal_loss", "interlevel_loss"}
    for k in got:
        _close(got[k], ref[k], rtol=1e-6, atol=0)
        assert float(ref[k]) > 0, k


def test_mipnerf360_parser_matches_jax():
    for split in ("train", "val"):
        j = JMipnerf360(JMPC(data=SCENE)).get_dataparser_outputs(split)
        t = parse_mipnerf360(Mipnerf360DataParserConfig(data=SCENE), split)
        assert [str(p) for p in t.image_filenames] == [str(p) for p in j.image_filenames]
        jc, tc = j.cameras, t.cameras
        _close(tc.camera_to_worlds.numpy(), np.asarray(jc.camera_to_worlds), rtol=0, atol=1e-6)
        for k in ("fx", "fy", "cx", "cy", "width", "height"):
            assert np.array_equal(getattr(tc, k).numpy(), np.asarray(getattr(jc, k)).reshape(-1)), k
        _close(t.scene_box.aabb, np.asarray(j.scene_box.aabb), rtol=0, atol=0)
        for k in ("near", "far", "collider_type"):
            assert getattr(t.scene_box, k) == getattr(j.scene_box, k), k
        _close(t.metadata["transform"], np.asarray(j.metadata["transform"]), rtol=0, atol=1e-6)
        assert abs(t.metadata["scale"] - j.metadata["scale"]) <= 1e-6 * j.metadata["scale"]
    n_train = len(parse_mipnerf360(Mipnerf360DataParserConfig(data=SCENE), "train").image_filenames)
    assert (n_train, len(t.image_filenames)) == (33, 3)  # ceil(0.9 * 36) by linspace, the rest
    # the poses fill [-1, 1] along their largest translation
    poses = parse_mipnerf360(Mipnerf360DataParserConfig(data=SCENE, scene_scale=2.0), "train")
    assert float(poses.cameras.camera_to_worlds[:, :, 3].abs().max()) <= 1.0 + 1e-6
    assert np.array_equal(poses.scene_box.aabb, 2.0 * t.scene_box.aabb)


def _surface_at(field_params, radius, inward=False):
    """JAX's geometric init (sdf ~ |x| - bias, or bias - |x| ``inward``)
    made an outward-facing sphere of ``radius``: the SDF head's column of
    the kernel (its sign) and its bias."""
    last = max((k for k in field_params if k.startswith("glin")), key=lambda k: int(k[4:]))
    layer = field_params[last]
    if inward:
        kernel = np.array(layer["kernel"])
        kernel[:, 0] = -kernel[:, 0]
        layer["kernel"] = kernel
    bias = np.array(layer["bias"])
    bias[0] = -radius
    layer["bias"] = bias


def _held_step(method, monkeypatch):
    """One shrunk step of ``method`` on both sides: the losses to 1e-4,
    every gradient to 5e-4 of its scale in float32 and to 1e-4 in float64.
    The proposal densities are scaled by e^-3 and the SDF made an
    outward-facing sphere of radius 0.5 (both packages' parameters), so that
    the rays cross the surface inside the unit ball, where the SDF field
    (not ``bakedangelo``'s background) renders, and the field's weights
    exceed the proposals' mass in some bins: the interlevel loss is not 0."""
    sdf_kw, model_kw = SMALL[method]
    jmodel, np_params, tmodel = _small_models(method, JSceneBox(**KW), TSceneBox(**KW),
                                              {**SAMPLES, **model_kw}, sdf_kw=sdf_kw)
    for net in np_params["proposal_networks"].values():
        net["MLP_0"]["layer_1"]["bias"] = net["MLP_0"]["layer_1"]["bias"] - np.float32(3.0)
    _surface_at(np_params["field"], 0.5, tmodel.field.config.inside_outside)
    params_from_jax(tmodel, np_params)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    jb, tb, batch = _scene_rays()
    (ref_total, ref_ld), jg = _jax_grads(jmodel, jparams, jb, batch, None, jnp.float32)
    opts = build_optimizers(get_method_config(method).optimizers, tmodel)
    tsched = tmodel.schedules(STEP)
    total, ld, _ = loss_and_metrics(tmodel, tb, {k: _t(v) for k, v in batch.items()}, tsched)
    assert sorted(ld) == sorted(ref_ld)
    for k in ld:
        _close(ld[k].detach(), ref_ld[k], rtol=1e-4, atol=0)
        assert float(ref_ld[k]) > 0, k
    _close(total.detach(), ref_total, rtol=1e-4, atol=0)
    grads = group_grads(total, opts)
    ref_g = _port_tree({g: jg[g] for g in opts})
    ref_g64, g64 = _f64_grads(jmodel, np_params, tmodel, None, None, jb, tb, batch, monkeypatch)
    seen = 0
    for group, opt in opts.items():
        for name, g in zip(opt.names, grads[group]):
            ref = ref_g[name]
            if g is None:  # no part in the loss: JAX's gradient is exactly zero
                assert not np.any(ref) and not np.any(ref_g64[name]), name
                continue
            scale, scale64 = float(np.abs(ref).max()), float(np.abs(ref_g64[name]).max())
            assert scale > 0, name
            assert float(np.abs(g.numpy() - ref).max()) <= 5e-4 * scale, name
            assert float(np.abs(g64[name].numpy() - ref_g64[name]).max()) <= 1e-4 * scale64, name
            seen += 1
    return tmodel, tsched, ld, seen


def test_bakedsdf_step_matches_jax(monkeypatch):
    tmodel, _, ld, seen = _held_step("bakedsdf", monkeypatch)
    assert set(ld) == {"rgb_loss", "eikonal_loss", "interlevel_loss"}
    assert tmodel.field.diffuse_color_pred is not None and tmodel.field.position_encoding.off_axis
    assert seen >= 20


def test_bakedsdf_mlp_step_matches_jax(monkeypatch):
    tmodel, _, _, seen = _held_step("bakedsdf-mlp", monkeypatch)
    assert tmodel.config.use_spatial_varying_eikonal_loss and tmodel.field.skip_in == (4,)
    assert tmodel.field.encoding is None and seen >= 25


def test_bakedangelo_step_matches_jax(monkeypatch):
    tmodel, sched, ld, seen = _held_step("bakedangelo", monkeypatch)
    assert 0 < float(sched["hash_mask"].sum()) < 48 and 0 < sched["curvature_factor"] < 1
    assert tmodel.field.config.hash_features_per_level == 8 and "curvature_loss" in ld
    assert type(tmodel.field_background).__name__ == "NerfactoField" and seen >= 20


@pytest.mark.parametrize("method", BAKED)
def test_registered_tree_matches_jax(method):
    port = _full_tree_matches(method)
    cfg = get_method_config(method)
    assert cfg.datamanager.train_num_rays_per_batch == {"bakedsdf": 8192, "bakedsdf-mlp": 4096,
                                                        "bakedangelo": 8192}[method]
    assert type(cfg.dataparser).__name__ == "SDFStudioDataParserConfig"
    if method == "bakedangelo":
        assert port["field.encoding.hash_table"][1] == 8
        assert cfg.optimizers["field"].optimizer.kind == "adamw"
        assert cfg.optimizers["field"].optimizer.weight_decay == 1e-2
    else:
        assert port["field.glin0.kernel"][0] == 371 and port["field.clin0.kernel"][0] == 316
        assert port["field.diffuse_color_pred.kernel"] == (256, 3)
    assert len(method_configs) == 30


def test_mipnerf360_argv_and_two_steps(tmp_path):
    """JAX's ``bakedsdf mipnerf360-data`` argv gives JAX's tree; two steps
    train on the CPU at JAX's ``test_bakedsdf_on_heritage_colmap`` sizes."""
    from sdfstudio_tpu.scripts.train import parse_args as jparse_args

    from sdfstudio_tpu_torch.engine.setup import setup_trainer
    from tests.test_torch_cli import _held, _jax_tree, _strip

    argv = ["bakedsdf", "--vis", "none", "mipnerf360-data", "--data", str(SCENE),
            "--scene-scale", "1.5"]
    config, _ = train_script.parse_args(argv)
    assert _held(_strip(config.to_dict()), _jax_tree(argv)) > 60
    assert isinstance(config.dataparser, Mipnerf360DataParserConfig)
    assert config.dataparser.scene_scale == jparse_args(argv).dataparser.scene_scale == 1.5
    config.trainer = dataclasses.replace(config.trainer, max_num_iterations=2, steps_per_save=100,
                                         steps_per_eval_image=0, steps_per_log=1)
    config.datamanager = dataclasses.replace(config.datamanager, train_num_rays_per_batch=32)
    sdf = dataclasses.replace(config.model.sdf_field, num_layers=2, hidden_dim=32, geo_feat_dim=15,
                              num_layers_color=2, hidden_dim_color=32, num_levels=4, max_res=64,
                              base_res=16, log2_hashmap_size=10)
    config.model = dataclasses.replace(
        config.model, sdf_field=sdf, eval_num_rays_per_chunk=64, num_proposal_samples_per_ray=(16, 8),
        proposal_net_args_list=({"hidden_dim": 8, "log2_hashmap_size": 9, "num_levels": 2,
                                 "max_res": 32},) * 2)
    trainer = setup_trainer(config, test_mode=True, device="cpu", checkpoints=False)
    assert trainer.datamanager.num_train_images == 33
    trainer.setup()
    last = trainer.train(2)
    assert trainer.step == 2 and all(np.isfinite(v) for v in last.values())
    assert set(last) >= {"rgb_loss", "eikonal_loss", "interlevel_loss"}


def test_jax_init_tree_renders_as_jax():
    """JAX's full-size ``bakedsdf`` init, converted leaf for leaf, renders
    eight rays (256 + 96 proposal and 48 field samples each) at eval as
    JAX does. The init's surface (a sphere of radius 0.05, which the
    proposal samples miss: every weight lies in f32's rounding of the
    Laplace density) is moved out to radius 0.5, one leaf of the tree, and
    the rays aim within 0.3 of the centre."""
    from sdfstudio_tpu.core.rays import RayBundle as JRayBundle

    from sdfstudio_tpu_torch.core.rays import RayBundle as TRayBundle

    jcfg = jget_method_config("bakedsdf")
    jmodel = jcfg.model_class(jcfg.model, JSceneBox(**KW), 3)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(3)))
    _surface_at(params["field"], 0.5)
    tmodel = get_method_config("bakedsdf").model_class(get_method_config("bakedsdf").model,
                                                      TSceneBox(**KW), 3)
    params_from_jax(tmodel, params)
    flat = _port_tree(params)
    assert set(flat) == {n for n, _ in tmodel.named_parameters()}
    for n, p in tmodel.named_parameters():
        assert np.array_equal(p.detach().numpy(), flat[n]), n
    rng = np.random.default_rng(4)
    o = rng.standard_normal((8, 3))
    o = (1.8 * o / np.linalg.norm(o, axis=-1, keepdims=True)).astype(np.float32)
    d = rng.uniform(-0.3, 0.3, (8, 3)) - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    pa = np.full((8, 1), 1e-5, np.float32)
    jb = JRayBundle(jnp.asarray(o), jnp.asarray(d), jnp.asarray(pa))
    tb = TRayBundle(_t(o), _t(d), _t(pa))
    step = 5000
    ref = jax.jit(lambda p, rb: jmodel.get_outputs(p, rb, rng=None, sched=jmodel.schedules(
        jnp.asarray(float(step), jnp.float32)), train=False))(
            jax.tree_util.tree_map(jnp.asarray, params), jb)
    out = tmodel.eval().get_outputs(tb, sched=tmodel.schedules(step), train=False)
    for k in ("rgb", "accumulation", "depth", "normal", "prop_depth_0", "prop_depth_1"):
        _close(out[k].numpy(), ref[k], rtol=0, atol=1e-5)
    assert float(np.asarray(ref["accumulation"]).min()) > 0.99
