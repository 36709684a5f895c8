"""NeuS, VolSDF and UniSurf in the port against the JAX package, on the CPU.

A small model of each method (5 geometry layers of 64, so that the skip at
layer 4 exists; 2 colour layers of 32; the NeRF background at JAX's fixed
full width, 4 samples a ray; each sampler's counts cut to a few) is
initialised by JAX, perturbed from a numpy seed, carried into the port by
``params_from_jax``, and the same rays go through both. The samplers run at
eval (no jitter); UniSurf's smoothness-loss noise is the uniforms JAX draws
(``PRNGKey(0)`` without an rng), handed to the port.

Ties. Two samplers take discrete decisions: VolSDF's bisection on beta
(``error <= eps``) and UniSurf's sign-change search (the sign of the SDF at
each marching sample). Where a decision's input sits within rounding of its
threshold, f32 rounding in another order may take the other branch, and the
comparison would then test rounding, not the port. So each sampler test
first records every decision's margin on these inputs (|error - eps| / eps,
|sdf|) and requires it to stay clear of rounding (1e-4, 1e-5); the samples
are then held to JAX's, and with them the decisions JAX made. A case that
breaks the margin fails with that message; it is not reseeded.

Tolerances, with their reasons:
- sampler positions, starts and ends at eval: 1e-5 (atol and rtol); the
  PDF steps' cumulative sums add in another order in XLA (tree) and
  PyTorch (sequence).
- the 8-layer field at the default depth: sdf and geometry features 1e-5,
  the gradient (one reverse pass through 8 layers) 1e-4 of its scale, the
  colour 1e-5.
- one train step: the loss dict to 1e-4 relative, every gradient to 5e-4
  of its scale (max |JAX grad|), as tests/test_torch_train.py holds the
  ``neus-facto`` step: the double backward of the geometry MLP and the
  resampling move each by a few 1e-6. The same step then runs in float64
  on both sides (JAX under ``jax.enable_x64``, the port's model in double,
  UniSurf's noise as JAX draws it in float64), and every gradient is held
  to 1e-4 of its scale there: JAX's Pallas MLP chains keep float32 inside
  (pallas_mlp.py:273), which leaves ~1e-5 of scale between the two float64
  steps, while a relu pre-activation or a sampler decision that f32
  rounding could tip no longer sits at a tie.
- render_image: rgb, accumulation and normal to 1e-4 absolute; depth as
  depth * accumulation (the weighted sum the renderer divides by the
  accumulation, which amplifies rounding on rays that barely hit), 4e-4.
"""
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdfstudio_tpu.cameras.cameras import Cameras as JCameras
from sdfstudio_tpu.configs.methods import get_method_config as jget_method_config
from sdfstudio_tpu.core.rays import RayBundle as JRayBundle
from sdfstudio_tpu.core.scene_box import SceneBox as JSceneBox
from sdfstudio_tpu.engine.optimizers import build_optimizer as jbuild_optimizer
from sdfstudio_tpu.engine.schedulers import SchedulerConfig as JSchedulerConfig
from sdfstudio_tpu.fields.sdf_field import SDFField as JSDFField
from sdfstudio_tpu.fields.sdf_field import SDFFieldConfig as JSDFFieldConfig
from sdfstudio_tpu.ops import density as jdensity
from sdfstudio_tpu.samplers import unisurf as junisurf

from sdfstudio_tpu_torch.cameras.cameras import Cameras as TCameras
from sdfstudio_tpu_torch.configs.methods import MethodConfig, build_model, get_method_config
from sdfstudio_tpu_torch.core.rays import RayBundle as TRayBundle
from sdfstudio_tpu_torch.core.scene_box import SceneBox as TSceneBox
from sdfstudio_tpu_torch.engine.final_eval import render_image
from sdfstudio_tpu_torch.engine.optimizers import build_optimizers
from sdfstudio_tpu_torch.engine.schedulers import SchedulerConfig as TSchedulerConfig
from sdfstudio_tpu_torch.engine.trainer import CHECKPOINT_FILE, Trainer, group_grads, loss_and_metrics
from sdfstudio_tpu_torch.fields.sdf_field import SDFField as TSDFField
from sdfstudio_tpu_torch.fields.sdf_field import SDFFieldConfig as TSDFFieldConfig
from sdfstudio_tpu_torch.ops import density as tdensity
from sdfstudio_tpu_torch.samplers import error_bounded as terror_bounded
from sdfstudio_tpu_torch.samplers import unisurf as tunisurf
from sdfstudio_tpu_torch.scripts import train as train_script
from sdfstudio_tpu_torch.utils.convert import _flatten, _port_key, opt_state_from_jax, params_from_jax

METHODS = ["neus", "volsdf", "unisurf"]
NUM_IMAGES = 3
SCENE = pathlib.Path(__file__).resolve().parents[1] / ".parity" / "dtu_like"
F32 = dict(rtol=1e-5, atol=1e-5)
# each method's sampler counts, cut to a few (and the background's)
CUTS = {
    "neus": dict(num_samples=8, num_samples_importance=8, num_up_sample_steps=2),
    "volsdf": dict(num_samples=8, num_samples_eval=8, num_samples_extra=4, max_total_iters=3),
    "unisurf": dict(num_samples_interval=8, num_samples_importance=4, num_marching_steps=16),
}
# the skip re-enters the 47-wide input (xyz, 36 PE, 8 zero grid features) at
# layer 4, so the layer before it is hidden_dim - 47 wide: 64 leaves 17
SMALL_FIELD = dict(num_layers=5, hidden_dim=64, geo_feat_dim=32, num_layers_color=2,
                   hidden_dim_color=32, num_levels=4)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port.detach() if torch.is_tensor(port) else port),
                               np.asarray(ref), **(tol or F32))


def _given(u):
    """A port rng that hands out the uniforms JAX drew."""
    def rng(shape):
        assert tuple(shape) == u.shape
        return _t(u)

    return rng


def _port_tree(tree):
    return {_port_key(k): np.asarray(v) for k, v in _flatten(tree).items()}


def _scene_boxes():
    kw = dict(near=0.8, far=4.0, radius=1.0, collider_type="near_far")
    return JSceneBox(**kw), TSceneBox(**kw)


def _small_models(method, seed=0):
    """JAX's and the port's model of ``method`` at the test's size, the same
    perturbed parameters. UniSurf's field faces outwards
    (``inside_outside=False``, an SDF of ~|x| - 0.8): rays from outside then
    meet a + to - sign change, so its surface points and smoothness loss
    are exercised."""
    jcfg = jget_method_config(method).model
    jsdf = dataclasses.replace(jcfg.sdf_field, **SMALL_FIELD,
                               inside_outside=method != "unisurf")
    jcfg = dataclasses.replace(jcfg, sdf_field=jsdf, num_samples_outside=4, **CUTS[method])
    tcfg_cls = type(get_method_config(method).model)
    tsdf = TSDFFieldConfig(**{f.name: getattr(jsdf, f.name) for f in dataclasses.fields(TSDFFieldConfig)})
    tcfg = tcfg_cls(**{f.name: tsdf if f.name == "sdf_field" else getattr(jcfg, f.name)
                       for f in dataclasses.fields(tcfg_cls)})
    jsb, tsb = _scene_boxes()
    jmodel = jget_method_config(method).model_class(jcfg, jsb, NUM_IMAGES)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        name = jax.tree_util.keystr(path)
        a = np.asarray(a)
        if "deviation" in name or "laplace_beta" in name:
            return a
        return (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32)

    np_params = jax.tree_util.tree_map_with_path(perturb, params)
    tmodel = build_model(MethodConfig(f"small-{method}", get_method_config(method).model_class, tcfg),
                         tsb, NUM_IMAGES, device="cpu")
    params_from_jax(tmodel, np_params)
    return jmodel, jax.tree_util.tree_map(jnp.asarray, np_params), np_params, tmodel, method


_MODELS = {}


def _model(method):
    """The small models of ``method``, built once a test process."""
    if method not in _MODELS:
        _MODELS[method] = _small_models(method)
    return _MODELS[method]


@pytest.fixture(params=METHODS)
def models(request):
    return _model(request.param)


def _rays(R=12, seed=1):
    """Rays from distance 2 with their near / far bounds, and a batch of
    pixels: the first half aimed within 0.4 of the origin, at the init's
    sphere, the second half passing it at distance 1.3, so that the NeRF
    background takes a share of the colour and of the gradient (behind the
    sphere its transmittance is ~e^-20 on VolSDF)."""
    rng = np.random.default_rng(seed)
    o = rng.standard_normal((R, 3))
    o = 2.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    target = rng.uniform(-0.4, 0.4, (R, 3))
    side = np.cross(o, rng.standard_normal((R, 3)))
    miss = np.arange(R) >= R // 2
    target[miss] = 1.3 * (side / np.linalg.norm(side, axis=-1, keepdims=True))[miss]
    d = target - o
    o = o.astype(np.float32)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    pa = np.full((R, 1), 1e-5, np.float32)
    dn = rng.uniform(1.0, 1.2, (R, 1)).astype(np.float32)
    ci = rng.integers(0, NUM_IMAGES, R).astype(np.int32)
    nears, fars = np.full((R, 1), 0.8, np.float32), np.full((R, 1), 4.0, np.float32)
    jb = JRayBundle(jnp.asarray(o), jnp.asarray(d), jnp.asarray(pa), nears=jnp.asarray(nears),
                    fars=jnp.asarray(fars), camera_indices=jnp.asarray(ci),
                    directions_norm=jnp.asarray(dn))
    tb = TRayBundle(_t(o), _t(d), _t(pa), nears=_t(nears), fars=_t(fars),
                    camera_indices=torch.from_numpy(ci.astype(np.int64)), directions_norm=_t(dn))
    batch = {"image": rng.uniform(0, 1, (R, 3)).astype(np.float32)}
    return jb, tb, batch


def _jsdf_fn(jmodel, jparams):
    raw = jmodel.field.sdf_fn(jparams["field"])
    return lambda s: raw(s.get_start_positions().reshape(-1, 3)).reshape(s.starts.shape)


# --- ops ----------------------------------------------------------------------


def test_density_ops_match_jax():
    rng = np.random.default_rng(0)
    sdf = rng.uniform(-0.5, 0.5, (6, 9)).astype(np.float32)
    deltas = rng.uniform(0.01, 0.2, (6, 8)).astype(np.float32)
    _close(tdensity.neus_alpha_fixed_inv_s(_t(sdf), _t(deltas), 64.0 * 4),
           jdensity.neus_alpha_fixed_inv_s(jnp.asarray(sdf), jnp.asarray(deltas), 64.0 * 4))
    _close(tdensity.unisurf_occupancy(_t(sdf)), jdensity.unisurf_occupancy(jnp.asarray(sdf)))
    beta = np.float32(0.1)
    _close(tdensity.sigmoid_density(_t(sdf), torch.tensor(beta)),
           jdensity.sigmoid_density(jnp.asarray(sdf), beta))


@pytest.mark.parametrize("kind,kw", [("exponential", dict(decay_rate=0.1, max_steps=100000)),
                                     ("neus", dict(warm_up_end=5000, max_steps=300000))])
def test_schedules_match_jax(kind, kw):
    """The schedules as the optimizer evaluates them, traced at an int32
    count (an eager call with a concrete int takes another power routine)."""
    js = jax.jit(JSchedulerConfig(kind=kind, **kw).build(5e-4))
    ts = TSchedulerConfig(kind=kind, **kw).build()
    for step in [0, 1, 10, 4999, 5000, 5001, 20000, 90328, 99999, 100000]:
        _close(ts(step), js(jnp.asarray(step, jnp.int32)), rtol=1e-6, atol=1e-9)
    for step in [0, 100, 5000, 50000, 1e6]:
        _close(tunisurf.unisurf_interval_delta(step), junisurf.unisurf_interval_delta(step),
               rtol=1e-6, atol=0)


# --- the samplers at eval -----------------------------------------------------


def test_neus_sampler_matches_jax():
    jmodel, jparams, _, tmodel, _ = _model("neus")
    from sdfstudio_tpu.samplers.neus import neus_sampler as jneus_sampler
    from sdfstudio_tpu_torch.samplers.neus import neus_sampler as tneus_sampler

    jb, tb, _ = _rays()
    kw = dict(num_samples=8, num_samples_importance=8, num_upsample_steps=2, base_variance=64.0)
    js = jax.jit(lambda p, b: jneus_sampler(b, _jsdf_fn(jmodel, p), rng=None, **kw))(jparams, jb)
    ts = tneus_sampler(tb, tmodel.sdf_at_starts, rng=None, **kw)
    assert ts.num_samples == js.num_samples == 16
    for k in ("starts", "ends"):
        _close(getattr(ts, k), getattr(js, k))
    _close(ts.get_positions(), js.get_positions())


def test_error_bounded_sampler_matches_jax(monkeypatch):
    jmodel, jparams, _, tmodel, _ = _model("volsdf")
    from sdfstudio_tpu.samplers.error_bounded import error_bounded_sampler as jebs

    eps = 0.1
    margins = []
    bound = terror_bounded._error_bound

    def recording(*a):
        err = bound(*a)
        margins.append(float((torch.abs(err - eps) / eps).min()))
        return err

    monkeypatch.setattr(terror_bounded, "_error_bound", recording)
    jb, tb, _ = _rays()
    beta0 = float(np.asarray(jmodel.field.get_beta(jparams["field"]))[0])
    kw = dict(num_samples=8, num_samples_eval=8, num_samples_extra=4, max_total_iters=3, eps=eps)
    js, jeik = jax.jit(lambda p, b: jebs(b, jdensity.laplace_density, _jsdf_fn(jmodel, p),
                                         jnp.asarray(beta0), rng=None, **kw))(jparams, jb)
    ts, teik = terror_bounded.error_bounded_sampler(
        tb, tdensity.laplace_density, tmodel.sdf_at_starts, torch.tensor(beta0), rng=None, **kw)
    # 3 rounds of (1 + 10) bisection checks
    assert len(margins) == 3 * 11 and min(margins) > 1e-4, \
        f"a bisection decision lies within rounding of eps: margin {min(margins)}"
    assert ts.num_samples == js.num_samples == 12
    for k in ("starts", "ends"):
        _close(getattr(ts, k), getattr(js, k))
    _close(ts.get_positions(), js.get_positions())
    assert teik.shape == jeik.shape == (12 * 10, 3)
    _close(teik, jeik)


def test_unisurf_sampler_matches_jax(monkeypatch):
    jmodel, jparams, _, tmodel, _ = _model("unisurf")
    jb, tb, _ = _rays()
    sdfs = []
    monkeypatch.setattr(tmodel, "sdf_at_starts",
                        lambda s, f=tmodel.sdf_at_starts: sdfs.append(f(s)) or sdfs[-1])
    kw = dict(num_samples_interval=8, num_samples_outside=4, num_samples_importance=4,
              num_marching_steps=16)
    delta = junisurf.unisurf_interval_delta(1000.0)
    js, jsurf = jax.jit(lambda p, b: junisurf.unisurf_sampler(
        b, jdensity.unisurf_occupancy, _jsdf_fn(jmodel, p), delta=delta, rng=None, **kw))(jparams, jb)
    ts, tsurf = tunisurf.unisurf_sampler(tb, tdensity.unisurf_occupancy, tmodel.sdf_at_starts,
                                         delta=float(delta), rng=None, **kw)
    margin = float(sdfs[0].abs().min())
    assert margin > 1e-5, f"a marching sample lies within rounding of the surface: |sdf| {margin}"
    mask = np.asarray(jsurf.mask)
    assert np.array_equal(tsurf.mask.numpy(), mask) and 0 < mask.sum() < mask.size
    # a ray without a sign change takes 0 / 0 for its root (clamped into its
    # range, masked everywhere after): compare the rays that found one
    _close(tsurf.depth[mask], np.asarray(jsurf.depth)[mask])
    _close(tsurf.points[mask], np.asarray(jsurf.points)[mask])
    assert ts.num_samples == js.num_samples == 16
    for k in ("starts", "ends"):
        _close(getattr(ts, k), getattr(js, k))


# --- the 8-layer field at the default depth ----------------------------------


@pytest.fixture(scope="module")
def default_fields():
    """JAX's default SDF field (8 geometry layers of 256, the skip at 4, the
    geometric init; 4 colour layers of 256) and the port's, the JAX tree
    carried across."""
    jf = JSDFField(JSDFFieldConfig(), num_images=NUM_IMAGES, spatial_distortion="inf")
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jf.init)(jax.random.PRNGKey(2)))
    tf = TSDFField(TSDFFieldConfig(), num_images=NUM_IMAGES, spatial_distortion="inf")
    params_from_jax(tf, params)
    return jf, params, tf


def test_default_field_geometric_init_statistics_match_jax(default_fields):
    """The port's seeded init draws from JAX's distributions, layer by
    layer: the first layer reads xyz only, the skip layer zeroes the
    re-entering encoding, the last layer is the sphere's (mean
    -sqrt(pi / fan_in), spread 1e-4, bias +0.8), the others N(0, 2 /
    fan_out). Each side's nonzero weights are held to the distribution's
    mean and standard deviation within 5 standard errors of n draws."""
    _, params, tf = default_fields
    port = TSDFField(TSDFFieldConfig(), num_images=NUM_IMAGES)
    port.reset_parameters(torch.Generator().manual_seed(0))
    assert tf.n_glayers == 9 and tf.skip_in == (4,)
    for l in range(9):
        jk = params[f"glin{l}"]["kernel"]
        tk = port.glayer(l).kernel.detach().numpy()
        assert jk.shape == tk.shape
        assert np.array_equal(jk == 0, tk == 0), l  # zero blocks at the same places
        fan_in, fan_out = jk.shape
        mean, std = ((-np.sqrt(np.pi) / np.sqrt(fan_in), 1e-4) if l == 8
                     else (0.0, np.sqrt(2.0 / fan_out)))
        for k in (jk, tk):
            w = k[k != 0].astype(np.float64)
            assert abs(w.mean() - mean) < 5 * std / np.sqrt(w.size), l
            assert abs(w.std() / std - 1.0) < 5 / np.sqrt(2 * w.size), l
        np.testing.assert_array_equal(port.glayer(l).bias.detach().numpy(), params[f"glin{l}"]["bias"])
        # weight norm starts at the raw kernel: g holds its column norms
        _close(port.glayer(l).g, np.linalg.norm(tk, axis=0), rtol=1e-6, atol=0)
    assert params["glin3"]["kernel"].shape == (256, 256 - 71)  # the layer before the skip
    assert params["glin4"]["kernel"].shape == (256, 256)
    assert float(params["glin8"]["bias"][0]) == pytest.approx(0.8)
    assert [tf.clayer(l).kernel.shape for l in range(5)] == [
        (321, 256), (256, 256), (256, 256), (256, 256), (256, 3)]


def test_default_field_sdf_gradient_and_outputs_match_jax(default_fields):
    jf, params, tf = default_fields
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    rng = np.random.default_rng(3)
    x = rng.uniform(-1.2, 1.2, (40, 3)).astype(np.float32)
    h_ref, g_ref, gc_ref = jax.jit(lambda p, x: (
        jf.geonetwork_fn(p)(x), jf.gradient(p, x, skip_spatial_distortion=True),
        jf.gradient(p, x)))(jparams, jnp.asarray(x))
    h, g = tf.geonetwork_with_gradient(_t(x))
    _close(h, h_ref)
    scale = float(np.abs(np.asarray(g_ref)).max())
    assert float(np.abs(g.numpy() - np.asarray(g_ref)).max()) <= 1e-4 * scale
    _close(tf.sdf(_t(x)), np.asarray(h_ref)[:, 0])
    _close(tf.gradient(_t(x)).detach(), gc_ref, rtol=1e-4, atol=1e-4 * scale)
    jb, tb, _ = _rays(R=4, seed=4)
    from sdfstudio_tpu.samplers.spaced import uniform_sampler as ju
    from sdfstudio_tpu_torch.samplers.spaced import uniform_sampler as tu

    ref = jax.jit(lambda p, b: jf.get_outputs(p, ju(b, 6), return_alphas=True, return_occupancy=True,
                                              train=False))(jparams, jb)
    out = tf.get_outputs(tu(tb, 6), return_alphas=True, return_occupancy=True)
    for k in ("sdf", "rgb", "density", "alpha", "occupancy", "points_norm"):
        _close(out[k], ref[k], rtol=1e-4, atol=1e-5)
    _close(out["normal"], ref["normal"], rtol=1e-4, atol=1e-4)


# --- one train step, the render, the parameter tree ---------------------------


def _step(tmodel, tb, batch, sched, method, noise=None):
    """(loss dict, total) of one step of the port without jitter; UniSurf's
    smoothness noise is given."""
    if method == "unisurf":
        outputs = tmodel.get_outputs(tb, sched=sched, train=True, rng=None)
        ld = tmodel.get_loss_dict(outputs, batch, sched, rng=_given(noise))
        return ld, sum(ld.values()), outputs
    total, ld, metrics = loss_and_metrics(tmodel, tb, batch, sched)
    return ld, total, metrics


def _f64_grads(tmodel, tb, batch, sched, method, noise):
    """Every parameter's gradient of the same step run in float64."""
    import copy

    m64 = copy.deepcopy(tmodel).double()
    f64 = lambda x: x.double() if torch.is_tensor(x) and x.is_floating_point() else x  # noqa: E731
    _, total, _ = _step(m64, tb.map(f64), {k: f64(v) for k, v in batch.items()}, sched, method,
                        None if noise is None else noise.astype(np.float64))
    names = [n for n, _ in m64.named_parameters()]
    grads = torch.autograd.grad(total, list(m64.parameters()), allow_unused=True)
    return {n: g for n, g in zip(names, grads) if g is not None}


def _jax_step(jmodel, params, jb, batch, step, dtype):
    """JAX's (total, loss dict, surface mask, gradients by the port's names)
    of one step without jitter: ``jax.value_and_grad`` of
    ``get_outputs(train=True)`` + ``get_loss_dict``."""
    sched = jmodel.schedules(jnp.asarray(float(step), dtype))

    def loss(p):
        out = jmodel.get_outputs(p, jb, rng=None, sched=sched, train=True)
        ld = jmodel.get_loss_dict(p, out, batch, sched, None)
        return sum(ld.values()), (ld, out.get("surface_points_mask"))

    (total, (ld, mask)), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return total, ld, mask, _port_tree(g)


def _jax_step_f64(jmodel, np_params, jb, batch, step, method):
    """The same step in float64 (``jax.enable_x64``): its gradients, and
    the smoothness noise JAX draws there (``PRNGKey(0)`` in float64)."""
    def f64(a):
        a = np.asarray(a)
        return jnp.asarray(a.astype(np.float64) if a.dtype == np.float32 else a)

    with jax.enable_x64():
        _, _, _, g = _jax_step(jmodel, jax.tree_util.tree_map(f64, np_params),
                               jax.tree_util.tree_map(f64, jb),
                               {k: f64(v) for k, v in batch.items()}, step, jnp.float64)
        noise = (np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (12, 3)))
                 if method == "unisurf" else None)
    assert all(v.dtype == np.float64 for v in g.values())
    return g, noise


def test_train_step_loss_and_grads_match_jax(models):
    """One step's losses and the gradient of every parameter (the NeRF
    background's included) against JAX's, in float32 and in float64."""
    jmodel, jparams, np_params, tmodel, method = models
    jb, tb, batch = _rays()
    step = 1000
    tsched = tmodel.schedules(step)
    ref_total, ref_ld, ref_mask, ref_g = _jax_step(
        jmodel, jparams, jb, {k: jnp.asarray(v) for k, v in batch.items()}, step, jnp.float32)
    tbatch = {k: _t(v) for k, v in batch.items()}
    noise = None
    if method == "unisurf":
        # the port's model forward without jitter, its loss with JAX's noise
        noise = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (12, 3)))
        ld, total, outputs = _step(tmodel, tb, tbatch, tsched, method, noise)
        assert np.array_equal(outputs["surface_points_mask"].numpy(), np.asarray(ref_mask))
        assert 0 < int(np.asarray(ref_mask).sum()) < 12
        assert float(ref_ld["normal_smoothness_loss"]) > 0
    else:
        ld, total, metrics = _step(tmodel, tb, tbatch, tsched, method)
        assert set(metrics) == {"neus": {"psnr", "s_val", "inv_s"},
                                "volsdf": {"psnr", "beta", "alpha"}}[method]
    expected = {"rgb_loss", "normal_smoothness_loss"} if method == "unisurf" else {"rgb_loss",
                                                                                  "eikonal_loss"}
    assert set(ld) == set(ref_ld) == expected
    for k in ld:
        _close(ld[k], ref_ld[k], rtol=1e-4, atol=0)
    _close(total, ref_total, rtol=1e-4, atol=0)
    opts = build_optimizers(get_method_config(method).optimizers, tmodel)
    assert set(opts) == {"field", "field_background"}
    grads = group_grads(total, opts)
    ref_g64, noise64 = _jax_step_f64(jmodel, np_params, jb, batch, step, method)
    g64 = _f64_grads(tmodel, tb, tbatch, tsched, method, noise64)
    seen = 0
    for group, opt in opts.items():
        for name, g in zip(opt.names, grads[group]):
            ref = ref_g[name]
            if g is None:  # no part in the loss: JAX's gradient is exactly zero
                assert not np.any(ref), name
                assert name not in g64 and not np.any(ref_g64[name]), name
                continue
            scale = float(np.abs(ref).max())
            assert scale > 0, name
            assert float(np.abs(g.numpy() - ref).max()) <= 5e-4 * scale, name
            scale64 = float(np.abs(ref_g64[name]).max())
            assert float(np.abs(g64[name].numpy() - ref_g64[name]).max()) <= 1e-4 * scale64, name
            seen += 1
    assert any(n.startswith("field_background.mlp_head") for n in opts["field_background"].names)
    assert seen >= 40


def _cameras(h=4, w=5):
    c2w = np.array([[0.0, 0.5384, -0.8427, 1.8761], [1.0, 0.0, 0.0, 0.0],
                    [0.0, -0.8427, -0.5384, 1.1988]], np.float32)
    c2w[:, 1:3] *= -1.0  # looking at the origin
    kw = dict(fx=4.0, fy=4.2, cx=w / 2, cy=h / 2, width=w, height=h)
    return JCameras.create(c2w[None], **kw), TCameras.create(c2w[None], device="cpu", **kw)


def test_render_image_matches_jax(models):
    """20 rays in chunks of 8, the last padded, at step 20,000."""
    jmodel, jparams, _, tmodel, _ = models
    jc, tc = _cameras()
    ref = jax.jit(lambda p, rb: jmodel.get_outputs(p, rb, rng=None, sched=jmodel.schedules(20_000.0),
                                                   train=False))(jparams, jc.generate_image_rays(0))
    out = render_image(tmodel, tc, 0, chunk=8, step=20_000)
    for k in ("rgb", "accumulation", "normal"):
        assert out[k].shape == (4, 5, ref[k].shape[-1])
        _close(out[k].reshape(ref[k].shape), ref[k], rtol=0, atol=1e-4)
    acc = np.asarray(ref["accumulation"])
    _close(out["depth"].reshape(acc.shape) * out["accumulation"].reshape(acc.shape),
           np.asarray(ref["depth"]) * acc, rtol=0, atol=4e-4)
    assert float(acc.max()) > 0.3  # the view sees the surface


@pytest.mark.parametrize("method", METHODS)
def test_jax_initialised_tree_loads_leaf_for_leaf(method, tmp_path):
    """The JAX-initialised full-width tree of each method, ``field_background``
    (the NeRF field) included, loads into the registered port model leaf for
    leaf, and so does optax's Adam state of both groups; a save and a load
    by the port's trainer then give the same bits."""
    jcfg = jget_method_config(method)
    jsb, tsb = _scene_boxes()
    jmodel = jcfg.model_class(jcfg.model, jsb, NUM_IMAGES)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(1))
    tx = jbuild_optimizer(jcfg.optimizers, params)
    rng = np.random.default_rng(2)
    state = tx.init(params)
    grads = jax.tree_util.tree_map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
    _, state = jax.jit(tx.update)(grads, state, params)  # moments that are not zero
    tmodel = build_model(method, tsb, NUM_IMAGES, device="cpu")
    flat = _port_tree(jax.tree_util.tree_map(np.asarray, params))
    assert any(k.startswith("field_background.mlp_base.layers.7") for k in flat)
    params_from_jax(tmodel, jax.tree_util.tree_map(np.asarray, params))
    for n, p in tmodel.named_parameters():
        assert np.array_equal(p.detach().numpy(), flat[n]), n
    assert set(flat) == {n for n, _ in tmodel.named_parameters()}

    class _Data:  # what Trainer.setup reads of a data manager
        device = torch.device("cpu")

    cfg = get_method_config(method)
    trainer = Trainer(cfg.trainer, tmodel, _Data(), cfg.optimizers, base_dir=tmp_path)
    trainer.setup()
    opt_state_from_jax(trainer.optimizers, state)
    assert set(trainer.optimizers) == {"field", "field_background"}
    for group, opt in trainer.optimizers.items():
        adam = state.inner_states[group].inner_state[0]
        mu = _port_tree({group: jax.tree_util.tree_map(np.asarray, adam.mu[group])})
        assert opt.count == 1
        for n, m in zip(opt.names, opt.mu):
            assert np.array_equal(m.numpy(), mu[n]), n
    trainer.step = 7
    path = trainer.save_checkpoint(7)
    assert (path / CHECKPOINT_FILE).is_file()
    fresh = Trainer(cfg.trainer, build_model(method, tsb, NUM_IMAGES, seed=5, device="cpu"), _Data(),
                    cfg.optimizers, base_dir=tmp_path)
    fresh.setup()
    fresh.load_checkpoint(tmp_path / "sdfstudio_models")
    assert fresh.step == 7
    named = dict(tmodel.named_parameters())
    for n, p in fresh.model.named_parameters():
        assert torch.equal(p, named[n]), n
    for group, opt in fresh.optimizers.items():
        ref = trainer.optimizers[group]
        assert opt.count == ref.count
        assert all(torch.equal(a, b) for a, b in zip(opt.mu + opt.nu, ref.mu + ref.nu)), group


@pytest.mark.parametrize("method", METHODS)
def test_registered_config_matches_jax(method):
    """The registered method carries JAX's values: model config, optimizer
    groups, schedules, iterations and rays."""
    jcfg, tcfg = jget_method_config(method), get_method_config(method)
    for f in dataclasses.fields(tcfg.model):
        if f.name != "sdf_field":
            assert getattr(tcfg.model, f.name) == getattr(jcfg.model, f.name), f.name
    for f in dataclasses.fields(TSDFFieldConfig):
        assert getattr(tcfg.model.sdf_field, f.name) == getattr(jcfg.model.sdf_field, f.name), f.name
    assert tcfg.model.background_model == "mlp"
    assert set(tcfg.optimizers) == set(jcfg.optimizers) == {"field", "field_background"}
    for g, og in tcfg.optimizers.items():
        jo = jcfg.optimizers[g]
        assert og.optimizer.lr == jo.optimizer.lr and og.optimizer.eps == jo.optimizer.eps
        sched, jsched = og.scheduler.build(), jax.jit(jo.scheduler.build(jo.optimizer.lr))
        for step in [0, 2500, 5000, 50000, 99999]:
            _close(sched(step), jsched(jnp.asarray(step, jnp.int32)), rtol=1e-6, atol=1e-9)
    assert tcfg.trainer.max_num_iterations == jcfg.trainer.max_num_iterations == 100000
    assert tcfg.datamanager.train_num_rays_per_batch == jcfg.datamanager.train_num_rays_per_batch == 1024
    assert tcfg.model.eval_num_rays_per_chunk == 1024


def test_train_entry_point_takes_a_few_steps_of_neus(capsys, tmp_path):
    """``scripts/train.py neus --device cpu`` at full width, 16 rays, 3 steps
    on the committed scene: the loop runs and its losses are finite (the
    row also carries the rays a second and the ETA, JAX's ``print_row``)."""
    assert train_script.main(["neus", "--data", str(SCENE), "--device", "cpu",
                              "--output-dir", str(tmp_path), "--vis", "none",
                              "--trainer.max-num-iterations", "3",
                              "--datamanager.train-num-rays-per-batch", "16"]) == 0
    line = [l for l in capsys.readouterr().out.splitlines() if l.startswith("step 3/3")]
    assert len(line) == 1
    vals = dict(kv.split("=") for kv in line[0].split()[2:] if "=" in kv)
    assert {"loss", "rgb_loss", "eikonal_loss", "psnr", "s_val"} <= set(vals)
    assert all(np.isfinite(float(v)) for k, v in vals.items() if k not in ("rays/s", "eta"))
