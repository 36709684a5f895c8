"""The port's fields, model and render entry against the JAX package.

A small model of each ported method is initialised by JAX, its parameters
are perturbed from a numpy seed (so the grid feature, the encode jacobian
and every bias matter), carried into the port by ``params_from_jax``, and
the same rays go through both: ``neus-facto-tpu-p8`` (permuto L2xF2, MLP
proposal fields) and ``neus-facto`` (hash grid L4 of 2^10 rows at
resolutions 4-32, two dense levels and two hashed, with smoothstep; hash
proposal fields L3 of 2^13 rows), both hidden 32, proposal samples (16, 8),
8 NeuS samples, 64 rays.

Tolerances: the proposal densities and the color net are f32 MLP chains,
1e-5. The SDF gradient chains the permutohedral jacobian (residuals scaled
by the level resolution, up to 512) into an autograd pass: 1e-4. The whole
slice resamples twice; XLA's cumsum adds in a tree order and PyTorch's in
sequence, and ``searchsorted`` can take the neighbouring bin where a u value
sits within an ulp of a cdf knot, so the final sample positions agree to
~6e-6, not to the ulp. NeuS turns a position change dx into an alpha change
of about inv_s * |grad sdf| * dx (20 * 3 * 6e-6 ~ 4e-4 at worst on this
perturbed field): rgb, accumulation and normal are held to 3e-4 absolute.
Expected depth is a ratio sum(w t) / sum(w); on rays that barely hit (sum(w)
~ 1e-4) it amplifies the same error by 1/sum(w), so it is compared as
depth * accumulation, the weighted sum the renderer divides, whose error is
the weight error times distances up to far = 4: 1.2e-3.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdfstudio_tpu.cameras.cameras import Cameras as JCameras
from sdfstudio_tpu.configs.methods import get_method_config as jget_method_config
from sdfstudio_tpu.core.rays import RayBundle as JRayBundle
from sdfstudio_tpu.core.scene_box import SceneBox as JSceneBox
from sdfstudio_tpu.fields.sdf_field import SDFFieldConfig as JSDFFieldConfig
from sdfstudio_tpu.models.neus_facto import NeuSFactoModel as JNeuSFactoModel
from sdfstudio_tpu.models.neus_facto import NeuSFactoModelConfig as JNeuSFactoModelConfig

from sdfstudio_tpu_torch.cameras.cameras import Cameras as TCameras
from sdfstudio_tpu_torch.configs.methods import MethodConfig, build_model, get_method_config
from sdfstudio_tpu_torch.core.rays import RayBundle as TRayBundle
from sdfstudio_tpu_torch.core.scene_box import SceneBox as TSceneBox
from sdfstudio_tpu_torch.engine.final_eval import psnr, render_image
from sdfstudio_tpu_torch.fields.sdf_field import SDFFieldConfig as TSDFFieldConfig
from sdfstudio_tpu_torch.models.neus_facto import NeuSFactoModel as TNeuSFactoModel
from sdfstudio_tpu_torch.models.neus_facto import NeuSFactoModelConfig as TNeuSFactoModelConfig
from sdfstudio_tpu_torch.utils.convert import params_from_jax
from tests.test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

SLICE_TOL = dict(rtol=0, atol=3e-4)
NUM_IMAGES = 3


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), **(tol or dict(rtol=1e-5, atol=1e-5)))


def _scene_boxes():
    kw = dict(near=0.8, far=4.0, radius=1.0, collider_type="near_far")
    return JSceneBox(**kw), TSceneBox(**kw)


METHODS = ["neus-facto-tpu-p8", "neus-facto"]
# each method's grid and proposal fields, cut to a small size
SMALL = {
    "neus-facto-tpu-p8": (
        dict(num_levels=2, hash_features_per_level=2, log2_hashmap_size=12),
        ({"field_type": "mlp", "hidden_dim": 32, "max_res": 64},
         {"field_type": "mlp", "hidden_dim": 32, "max_res": 256}),
    ),
    "neus-facto": (
        dict(num_levels=4, base_res=4, max_res=32, log2_hashmap_size=10),
        ({"hidden_dim": 16, "log2_hashmap_size": 13, "num_levels": 3, "max_res": 64},
         {"hidden_dim": 16, "log2_hashmap_size": 13, "num_levels": 3, "max_res": 256}),
    ),
}


def _small_models(method, seed=0):
    grid, proposal_args = SMALL[method]
    jcfg = jget_method_config(method).model
    jsdf = dataclasses.replace(
        jcfg.sdf_field, hidden_dim=32, geo_feat_dim=32, hidden_dim_color=32, **grid,
    )
    jcfg = dataclasses.replace(
        jcfg, sdf_field=jsdf, num_proposal_samples_per_ray=(16, 8), num_neus_samples_per_ray=8,
        proposal_net_args_list=proposal_args,
    )
    tsdf = TSDFFieldConfig(**{f.name: getattr(jsdf, f.name) for f in dataclasses.fields(TSDFFieldConfig)})
    tcfg = TNeuSFactoModelConfig(**{
        f.name: tsdf if f.name == "sdf_field" else getattr(jcfg, f.name)
        for f in dataclasses.fields(TNeuSFactoModelConfig)
    })
    jsb, tsb = _scene_boxes()
    jmodel = jget_method_config(method).model_class(jcfg, jsb, NUM_IMAGES)
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
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    tmodel = build_model(MethodConfig(f"small-{method}", TNeuSFactoModel, tcfg), tsb, NUM_IMAGES,
                         device="cpu")
    params_from_jax(tmodel, np_params)
    return jmodel, jparams, np_params, tmodel


@pytest.fixture(scope="module", params=METHODS)
def models(request):
    return _small_models(request.param)


def _rays(R=64, seed=1):
    rng = np.random.default_rng(seed)
    o = rng.standard_normal((R, 3))
    o = (2.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)).astype(np.float32)
    target = rng.uniform(-0.6, 0.6, (R, 3))
    d = target - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    pa = np.full((R, 1), 1e-5, np.float32)
    dn = rng.uniform(1.0, 1.2, (R, 1)).astype(np.float32)
    ci = np.zeros((R,), np.int32)
    jb = JRayBundle(jnp.asarray(o), jnp.asarray(d), jnp.asarray(pa), camera_indices=jnp.asarray(ci),
                    directions_norm=jnp.asarray(dn))
    tb = TRayBundle(_t(o), _t(d), _t(pa), camera_indices=torch.from_numpy(ci.astype(np.int64)),
                    directions_norm=_t(dn))
    return jb, tb


def test_density_fields_match_jax(models):
    jmodel, jparams, _, tmodel = models
    pos = np.random.default_rng(2).uniform(-2.5, 2.5, (5, 77, 3)).astype(np.float32)
    for i in range(2):
        ref = jmodel.proposal_networks[i].density_fn(jparams["proposal_networks"][str(i)])(jnp.asarray(pos))
        with torch.no_grad():
            out = tmodel.proposal_networks[i](_t(pos))
        assert out.shape == (5, 77)
        _close(out, ref, rtol=1e-5, atol=1e-6)


def test_sdf_field_outputs_match_jax(models):
    jmodel, jparams, _, tmodel = models
    jb, tb = _rays()
    rng = np.random.default_rng(3)
    bins = np.sort(rng.uniform(0.8, 4.0, (64, 13)), -1).astype(np.float32)
    jrs = jb.get_ray_samples(jnp.asarray(bins))
    trs = tb.get_ray_samples(_t(bins))
    ref = jax.jit(
        lambda p, rs: jmodel.field.get_outputs(p, rs, cos_anneal_ratio=0.4, return_alphas=True,
                                               train=False)
    )(jparams["field"], jrs)
    with torch.no_grad():
        out = tmodel.field.get_outputs(trs, cos_anneal_ratio=0.4, return_alphas=True)
    for k in ("sdf", "rgb", "density", "points_norm"):
        _close(out[k], ref[k])
    for k in ("gradient", "normal", "alpha"):
        _close(out[k], ref[k], rtol=1e-4, atol=1e-4)
    assert float(np.abs(np.asarray(ref["gradient"])).max()) > 0.1  # the gradient is not trivial


@pytest.mark.parametrize("step", [20_000, 1_000_000])
def test_slice_get_outputs_matches_jax(models, step):
    """The whole eval forward: collider, proposal sampling, SDF field, NeuS
    compositing and the renderers (cos anneal 0.4 at step 20000, 1 at 1e6)."""
    jmodel, jparams, _, tmodel = models
    jb, tb = _rays()
    ref = jax.jit(
        lambda p, rb: jmodel.get_outputs(p, rb, rng=None, sched=jmodel.schedules(float(step)),
                                         train=False)
    )(jparams, jb)
    out = tmodel.get_outputs(tb, sched=tmodel.schedules(step))
    for k in ("rgb", "depth", "accumulation", "normal", "prop_depth_0", "prop_depth_1"):
        assert out[k].shape == ref[k].shape, k
    _same_render(out, ref)
    assert float(np.asarray(ref["accumulation"]).max()) > 0.5  # some rays hit the surface


def _same_render(out, ref):
    for k in ("rgb", "accumulation", "normal", "prop_depth_0", "prop_depth_1"):
        if k in out:
            _close(out[k].reshape(ref[k].shape), ref[k], **SLICE_TOL)
    acc = np.asarray(ref["accumulation"])
    _close(out["depth"].reshape(acc.shape) * out["accumulation"].reshape(acc.shape),
           np.asarray(ref["depth"]) * acc, rtol=0, atol=4.0 * SLICE_TOL["atol"])


def _cameras(h=8, w=10, facing=False):
    c2w = np.array([[0.0, 0.5384, -0.8427, 1.8761], [1.0, 0.0, 0.0, 0.0],
                    [0.0, -0.8427, -0.5384, 1.1988]], np.float32)
    if facing:  # turned about its x axis to look at the origin, where the surface is
        c2w[:, 1:3] *= -1.0
    kw = dict(fx=11.0, fy=11.5, cx=w / 2, cy=h / 2, width=w, height=h)
    return JCameras.create(c2w[None], **kw), TCameras.create(c2w[None], device="cpu", **kw)


def test_cameras_generate_image_rays_match_jax():
    jc, tc = _cameras()
    ref, out = jc.generate_image_rays(0), tc.generate_image_rays(0)
    for k in ("origins", "directions", "pixel_area", "directions_norm"):
        _close(getattr(out, k), getattr(ref, k))


def test_render_image_matches_jax(models):
    """80 rays in chunks of 32: the last chunk is padded by repeating its last ray."""
    jmodel, jparams, _, tmodel = models
    jc, tc = _cameras()
    ref = jax.jit(
        lambda p, rb: jmodel.get_outputs(p, rb, rng=None, sched=jmodel.schedules(1e9), train=False)
    )(jparams, jc.generate_image_rays(0))
    out = render_image(tmodel, tc, 0, chunk=32)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    for k in ("rgb", "depth", "accumulation", "normal"):
        assert out[k].shape == (8, 10, ref[k].shape[-1])
    _same_render(out, ref)
    gt = torch.rand(8, 10, 3, generator=torch.Generator().manual_seed(0))
    ref_psnr = -10.0 * np.log10(np.mean((np.asarray(ref["rgb"]).reshape(8, 10, 3) - gt.numpy()) ** 2))
    assert abs(float(psnr(out["rgb"], gt)) - ref_psnr) < 1e-3


def test_render_image_renders_at_the_trained_step(models):
    """``render_image(step=20_000)`` renders with the schedules of step
    20,000 (cos anneal 0.4 for anneal_end 50,000), as the reference's
    ``Trainer.render_image`` renders at ``state.step``; the same view at the
    untrained default (1e9, cos anneal 1) differs."""
    jmodel, jparams, _, tmodel = models
    jc, tc = _cameras(facing=True)
    ref = jax.jit(
        lambda p, rb: jmodel.get_outputs(p, rb, rng=None, sched=jmodel.schedules(20_000.0),
                                         train=False)
    )(jparams, jc.generate_image_rays(0))
    out = render_image(tmodel, tc, 0, chunk=32, step=20_000)
    _same_render(out, ref)
    assert float(np.asarray(ref["accumulation"]).max()) > 0.5  # the view sees the surface
    late = render_image(tmodel, tc, 0, chunk=32)
    assert float((out["rgb"] - late["rgb"]).abs().max()) > 1e-2


def test_params_from_jax_rejects_missing_extra_and_misshaped(models):
    _, _, np_params, tmodel = models
    tree = jax.tree_util.tree_map(np.asarray, np_params)
    missing = {**tree, "field": {k: v for k, v in tree["field"].items() if k != "deviation"}}
    with pytest.raises(ValueError, match="missing port params.*field.deviation"):
        params_from_jax(tmodel, missing)
    extra = {**tree, "field": {**tree["field"], "bogus": np.zeros(2, np.float32)}}
    with pytest.raises(ValueError, match="extra JAX leaves.*field.bogus"):
        params_from_jax(tmodel, extra)
    bad = {**tree, "field": {**tree["field"], "glin0": {**tree["field"]["glin0"],
                                                       "g": np.zeros(3, np.float32)}}}
    with pytest.raises(ValueError, match="field.glin0.g has shape"):
        params_from_jax(tmodel, bad)


def _same_tree(jmodel_cfg, tmodel_cfg):
    """The JAX and port models of these configs have the same parameter
    tree, leaf for leaf and shape for shape (``params_from_jax`` raises on
    any missing, extra or mis-shaped leaf)."""
    jsb, tsb = _scene_boxes()
    shapes = jax.eval_shape(lambda k: JNeuSFactoModel(jmodel_cfg, jsb, NUM_IMAGES).init(k),
                            jax.random.PRNGKey(0))
    tmodel = TNeuSFactoModel(tmodel_cfg, tsb, NUM_IMAGES)
    params_from_jax(tmodel, jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes))
    return tmodel


@pytest.mark.parametrize("method", METHODS)
def test_full_width_config_matches_jax_parameter_tree(method):
    """The registered port config builds the same parameter tree, leaf for
    leaf and shape for shape, as the JAX method at full width."""
    tmodel = _same_tree(jget_method_config(method).model, get_method_config(method).model)
    encoding = tmodel.field.encoding
    assert type(encoding).__name__ == {"neus-facto": "HashEncoding",
                                       "neus-facto-tpu-p8": "PermutoEncoding"}[method]


@pytest.mark.parametrize("grid_feature", [True, False])
def test_default_configs_build_the_jax_default_tree(grid_feature):
    """The port's default ``SDFFieldConfig`` and ``NeuSFactoModelConfig``
    build JAX's defaults: the hash grid (L16 x F2 of 2^19 rows, 6,098,925
    rows with smoothstep) and the two hash proposal fields (278,256 and
    434,066 rows). Both sides take the two settings every ported method
    has, the grid feature on and no background field; with JAX's default
    ``use_grid_feature=False`` both trees hold no grid table at all (Flax
    creates no parameters for the encoding it never calls)."""
    jcfg = JNeuSFactoModelConfig(sdf_field=JSDFFieldConfig(use_grid_feature=grid_feature),
                                 background_model="none")
    tcfg = TNeuSFactoModelConfig(sdf_field=TSDFFieldConfig(use_grid_feature=grid_feature),
                                 background_model="none")
    assert TNeuSFactoModelConfig().sdf_field == TSDFFieldConfig()
    assert not TSDFFieldConfig().use_grid_feature
    tmodel = _same_tree(jcfg, tcfg)
    if grid_feature:
        assert tmodel.field.encoding.total_rows == 6_098_925
        assert tmodel.field.encoding.spec.smoothstep
    else:
        assert tmodel.field.encoding is None
        assert not any("hash_table" in n for n, _ in tmodel.field.named_parameters())
    assert tmodel.field.geo_in_dim == 3 + 36 + 32  # the zero feature still feeds the MLP
    props = [net.encoding for net in tmodel.proposal_networks]
    assert [e.total_rows for e in props] == [278_256, 434_066]
    assert not any(e.spec.smoothstep for e in props)


def test_entry_points_default_to_cuda():
    """Without ``device`` the entry points take the card, and raise where there is none."""
    _, tsb = _scene_boxes()
    if torch.cuda.is_available():
        assert next(build_model("neus-facto-tpu-p8", tsb).parameters()).is_cuda
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model("neus-facto-tpu-p8", tsb)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TCameras.create(np.eye(4)[:3], 1.0, 1.0, 1.0, 1.0, 2, 2)
