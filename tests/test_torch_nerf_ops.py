"""The parts of the NeRF baselines against the JAX package, on the CPU: RAdam,
the jaxnerf exponential-decay schedules, mip-NeRF's conical-frustum
Gaussians and integrated encoding, TensoRF's tri-plane and line encodings
(and the tri-plane as the SDF field's grid feature), NeRF-W's uncertainty
renderer, and the D-NeRF and Friends parsers.

Tolerances, with their reasons:
- RAdam against ``optax.radam`` over 14 steps (both sides of rho_t = 5),
  parameters and state: 1e-6 (as Adam's, ``tests/test_torch_train.py``);
- the schedules: 1e-6 relative (the same float32 formulas; XLA's and
  numpy's float32 ``exp`` and ``sin`` may part by an ulp);
- the Gaussians, ``expected_sin`` and the IPE in float64, with their
  gradients: 1e-10;
- the tri-plane and line encodings in float32: 1e-6 of scale for values and
  gradients (the same products; a plane row's gradient sums its corners in
  another order), the SDF field's output 1e-5 and its gradient 1e-4 (as
  ``tests/test_torch_sdf_field_switches.py``);
- ``render_uncertainty``: 1e-6;
- the parsers: exact for names, sizes, times and the scene box, 1e-6 for
  poses and focal lengths, exact for the composited pixels.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdfstudio_tpu.core import math as jmath
from sdfstudio_tpu.engine.optimizers import OptimizerConfig as JOptimizerConfig
from sdfstudio_tpu.engine.optimizers import OptimizerGroupConfig as JOptimizerGroupConfig
from sdfstudio_tpu.engine.optimizers import build_optimizer as jbuild_optimizer
from sdfstudio_tpu.engine.schedulers import SchedulerConfig as JSchedulerConfig
from sdfstudio_tpu.ops import encodings as jenc
from sdfstudio_tpu.ops import render as jR

from sdfstudio_tpu_torch.core import math as tmath
from sdfstudio_tpu_torch.engine.optimizers import (GroupAdam, OptimizerConfig, OptimizerGroupConfig,
                                                   radam_rectifier)
from sdfstudio_tpu_torch.engine.schedulers import SchedulerConfig
from sdfstudio_tpu_torch.ops import encodings as tenc
from sdfstudio_tpu_torch.ops import render as tR
from sdfstudio_tpu_torch.utils.convert import opt_state_from_jax
from tests.test_torch_train import _close, _t
from tests.test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

# --- RAdam --------------------------------------------------------------------------------

RADAM_STEPS = 14


def test_radam_matches_optax_over_both_branches():
    """``radam`` with tensorf-style ``exponential_decay`` (a delay too)
    against ``optax.radam`` over 14 steps: steps 1-5 take the plain first
    moment, steps 6 on the rectified update. Group ``td`` gets no gradient
    on the port's side (None) and zeros on JAX's, as ``dnerf``'s distortion
    does on rays without times: its moments and count advance as optax's.
    The state read back through ``opt_state_from_jax`` equals the port's."""
    assert radam_rectifier(5) == 0.0 < radam_rectifier(6) < radam_rectifier(RADAM_STEPS) < 1.0
    rng = np.random.default_rng(0)
    params = {"field": {"a": rng.standard_normal((4, 3)).astype(np.float32),
                        "b": rng.standard_normal((5,)).astype(np.float32)},
              "td": {"c": rng.standard_normal((2, 2)).astype(np.float32)}}
    sched = dict(kind="exponential_decay", lr_final=5e-3, max_steps=10, lr_delay_steps=4,
                 lr_delay_mult=0.1)
    jgroups = {g: JOptimizerGroupConfig(JOptimizerConfig(kind="radam", lr=2e-2, eps=1e-8),
                                        JSchedulerConfig(**sched)) for g in params}
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tx = jbuild_optimizer(jgroups, jp)
    state = tx.init(jp)
    tgroup = OptimizerGroupConfig(OptimizerConfig(lr=2e-2, eps=1e-8, kind="radam"),
                                  SchedulerConfig(**sched))
    opts = {g: GroupAdam([_t(v) for v in params[g].values()], [f"{g}.{k}" for k in params[g]],
                         tgroup) for g in params}
    update = jax.jit(tx.update)
    for _ in range(RADAM_STEPS):
        g = {"field": {k: jnp.asarray(rng.standard_normal(v.shape), jnp.float32)
                       for k, v in params["field"].items()},
             "td": {"c": jnp.zeros((2, 2), jnp.float32)}}
        upd, state = update(g, state, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, upd)
        opts["field"].step([_t(v) for v in g["field"].values()], apply=True)
        opts["td"].step([None], apply=True)
    for g, opt in opts.items():
        assert opt.count == RADAM_STEPS
        for n, p in zip(opt.names, opt.params):
            _close(p, jp[g][n.split(".")[1]], rtol=1e-6, atol=1e-6)
    assert not np.allclose(np.asarray(jp["field"]["a"]), params["field"]["a"])
    np.testing.assert_array_equal(np.asarray(jp["td"]["c"]), params["td"]["c"])
    fresh = {g: GroupAdam([_t(v) for v in params[g].values()], opt.names, tgroup)
             for g, opt in opts.items()}
    opt_state_from_jax(fresh, state)
    for g, opt in opts.items():
        assert fresh[g].count == opt.count
        for a, b in zip(fresh[g].mu + fresh[g].nu, opt.mu + opt.nu):
            _close(a, b, rtol=1e-6, atol=1e-9)
    assert float(opts["field"].nu[0].abs().sum()) > 0 and float(opts["td"].nu[0].abs().sum()) == 0


@pytest.mark.parametrize("kw,lr", [
    (dict(kind="exponential_decay", lr_final=1e-4, max_steps=30000), 1e-3),  # tensorf's field
    (dict(kind="exponential_decay", lr_final=2e-3, max_steps=30000, lr_delay_steps=2500,
          lr_delay_mult=0.01), 2e-2),
    (dict(kind="delayed_exponential", lr_final=1e-4, max_steps=3000, warm_up_end=100), 5e-4),
])
def test_exponential_decay_schedules_match_jax(kw, lr):
    jsched = jax.jit(JSchedulerConfig(**kw).build(lr))
    tsched = SchedulerConfig(**kw).build(lr)
    steps = [0, 1, 99, 100, 101, 1250, 2500, 15000, kw["max_steps"], kw["max_steps"] + 777, 10**6]
    for s in steps:
        ref = float(jsched(jnp.asarray(s, jnp.int32)))
        assert abs(tsched(s) - ref) <= 1e-6 * max(abs(ref), 1e-30), (s, tsched(s), ref)
    assert tsched(10**6) > 0 and SchedulerConfig(kind="none").build(lr)(5) == 1.0


# --- mip-NeRF's Gaussians and integrated encoding ------------------------------------------


def _f64(a):
    return jnp.asarray(np.asarray(a, np.float64))


def test_conical_frustum_gaussian_and_ipe_match_jax_in_f64():
    """The frustum's Gaussian, ``expected_sin`` and the integrated PE, and the
    gradient of a weighted sum of the encoding in every input, in float64."""
    rng = np.random.default_rng(1)
    R, S = 6, 5
    o = rng.standard_normal((R, 1, 3))
    d = rng.standard_normal((R, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.sort(rng.uniform(2.0, 6.0, (R, S + 1)), -1)
    starts, ends = t[:, :-1, None], t[:, 1:, None]
    radius = rng.uniform(1e-3, 1e-2, (R, 1, 1))
    w = rng.standard_normal((R, S, 3 * 10 * 2 + 3))
    freqs = tenc.frequencies(10, 0.0, 9.0).double()
    inputs = [o, d, starts, ends, radius]

    def jfn(o, d, s, e, r):
        g = jmath.conical_frustum_to_gaussian(o, d, s, e, r)
        enc = jenc.nerf_encoding(g.mean, 10, 0.0, 9.0, True, covs=g.cov)
        return jnp.sum(enc * w), (g.mean, g.cov, enc)

    def tfn(o, d, s, e, r):
        g = tmath.conical_frustum_to_gaussian(o, d, s, e, r)
        enc = tenc.nerf_encoding(g.mean, freqs, True, None, g.cov)
        return torch.sum(enc * torch.from_numpy(w)), (g.mean, g.cov, enc)

    with jax.enable_x64():
        (ref, ref_aux), ref_g = jax.value_and_grad(jfn, argnums=(0, 1, 2, 3, 4), has_aux=True)(
            *[_f64(a) for a in inputs])
        ref_es = jmath.expected_sin(_f64(starts), _f64(radius * 100))
        ref_g, ref_aux = [np.asarray(g) for g in ref_g], [np.asarray(a) for a in ref_aux]
        ref_es = np.asarray(ref_es)
    xs = [torch.from_numpy(np.array(a)).requires_grad_(True) for a in inputs]
    val, aux = tfn(*xs)
    grads = torch.autograd.grad(val, xs)
    assert aux[2].shape == (R, S, 63) and float(np.abs(ref_aux[2]).max()) > 0.1
    for got, want in zip(list(aux) + list(grads), ref_aux + ref_g):
        scale = max(float(np.abs(want).max()), 1.0)
        assert float(np.abs(got.detach().numpy() - want).max()) <= 1e-10 * scale
    es = tmath.expected_sin(torch.from_numpy(starts), torch.from_numpy(radius * 100))
    assert float(np.abs(es.numpy() - ref_es).max()) <= 1e-12
    # the covariance's eigenvalues: one along the ray and, twice, the one across it
    ev = np.linalg.eigvalsh(ref_aux[1])
    pair = np.isclose(ev[..., 0], ev[..., 1], rtol=1e-8) | np.isclose(ev[..., 1], ev[..., 2], rtol=1e-8)
    assert pair.all() and ev.min() > 0


# --- TensoRF's encodings -----------------------------------------------------------------


def _points(n=120, seed=2):
    """Points in and beyond [0, 1]^3 (TensoRF's samples reach past the aabb),
    with some on the faces, edges and corners."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.3, 1.3, (n, 3)).astype(np.float32)
    x[:6] = [[0, 0, 0], [1, 1, 1], [0.5, 1, 0], [1, 0.25, 0.75], [0, 1, 0.5], [1, 0, 1]]
    x[6:12] = rng.uniform(0, 1, (6, 3)).round(1)  # on grid lines at res 10
    return x


def _grads_close(got, want, tol):
    scale = float(np.abs(want).max())
    assert scale > 0
    assert float(np.abs(got - want).max()) <= tol * scale


@pytest.mark.parametrize("smoothstep", [False, True])
def test_tensor_vm_encoding_matches_jax(smoothstep):
    """Values, the planes' gradient and x's (through the offsets only) of a
    weighted sum, and the jacobian against JAX's jvp (sdf_field.py:294-303)."""
    res, C = 10, 5
    x = _points()
    jm = jenc.TensorVMEncoding(resolution=res, num_components=C, smoothstep=smoothstep)
    jp = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    w = np.random.default_rng(3).standard_normal((x.shape[0], 3 * C)).astype(np.float32)
    (ref, (gp, gx)) = jax.jit(lambda p, y: (jm.apply(p, y), jax.grad(
        lambda p_, y_: jnp.sum(jm.apply(p_, y_) * w), argnums=(0, 1))(p, y)))(jp, jnp.asarray(x))
    jac_ref = np.stack([np.asarray(jax.jvp(lambda y: jm.apply(jp, y), (jnp.asarray(x),),
                                           (jnp.zeros_like(jnp.asarray(x)).at[:, a].set(1.0),))[1])
                        for a in range(3)], -1)
    tm = tenc.TensorVMEncoding(res, C, smoothstep=smoothstep)
    with torch.no_grad():
        tm.plane_coef.copy_(_t(jp["params"]["plane_coef"]))
    xt = _t(x).requires_grad_(True)
    out, jac = tm(xt, want_jac=True)
    assert out.shape == (x.shape[0], 3 * C) == tm(xt).shape and jac.shape == (x.shape[0], 3 * C, 3)
    _grads_close(out.detach().numpy(), np.asarray(ref), 1e-6)
    tgp, tgx = torch.autograd.grad(torch.sum(out * _t(w)), [tm.plane_coef, xt])
    _grads_close(tgp.numpy(), np.asarray(gp["params"]["plane_coef"]), 1e-6)
    _grads_close(tgx.numpy(), np.asarray(gx), 1e-6)
    _grads_close(jac.detach().numpy(), jac_ref, 1e-6)


def test_tensor_cp_encoding_matches_jax():
    """Values and the lines' gradient; the coordinates are clipped and take no gradient."""
    res, C = 12, 4
    x = _points(seed=4)
    jm = jenc.TensorCPEncoding(resolution=res, num_components=C)
    jp = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    w = np.random.default_rng(5).standard_normal((x.shape[0], C)).astype(np.float32)
    ref, gp = jax.jit(lambda p, y: (jm.apply(p, y), jax.grad(
        lambda p_: jnp.sum(jm.apply(p_, y) * w))(p)))(jp, jnp.asarray(x))
    tm = tenc.TensorCPEncoding(res, C)
    with torch.no_grad():
        tm.line_coef.copy_(_t(jp["params"]["line_coef"]))
    xt = _t(x).requires_grad_(True)
    out = tm(xt)
    assert out.shape == (x.shape[0], C) and out.requires_grad
    _grads_close(out.detach().numpy(), np.asarray(ref), 1e-6)
    (tgp,) = torch.autograd.grad(torch.sum(out * _t(w)), [tm.line_coef])
    _grads_close(tgp.numpy(), np.asarray(gp["params"]["line_coef"]), 1e-6)
    assert torch.autograd.grad(torch.sum(tm(xt)), xt, allow_unused=True)[0] is None


def test_sdf_field_tensorf_vm_matches_jax():
    """``encoding_type="tensorf_vm"`` (sdf_field.py:152-153: 3 x 24 features at
    128, smoothstep weights): the geometry output and d sdf/dx at eval, and
    in training the planes' gradient of a loss on both."""
    from sdfstudio_tpu.fields.sdf_field import SDFField as JSDFField
    from sdfstudio_tpu.fields.sdf_field import SDFFieldConfig as JSDFFieldConfig
    from sdfstudio_tpu.fields.sdf_field import SDFFieldNet as JSDFFieldNet

    from sdfstudio_tpu_torch.fields.sdf_field import SDFField, SDFFieldConfig
    from sdfstudio_tpu_torch.utils.convert import params_from_jax

    kw = dict(encoding_type="tensorf_vm", use_grid_feature=True, hash_smoothstep=True,
              num_layers=2, hidden_dim=32, num_layers_color=2, hidden_dim_color=32)
    jfield = JSDFField(config=JSDFFieldConfig(**kw), num_images=2)
    params = jfield.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(6)
    np_params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a))).astype(np.float32), params)
    tfield = SDFField(SDFFieldConfig(**kw), num_images=2)
    assert tfield.grid_dim == 72 and tfield.encode_range == "sst/tensorvm_encode"
    params_from_jax(tfield, np_params)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    x = rng.uniform(-1.9, 1.9, (64, 3)).astype(np.float32)
    wh = rng.standard_normal((64, 257)).astype(np.float32)

    def jgeo(p, y):
        return jfield.module.apply({"params": p}, y, method=JSDFFieldNet.geonetwork_with_gradient)

    def jloss(p, y):
        h, g = jgeo(p, y)
        return jnp.sum(h * wh) + jnp.sum(g ** 2)

    (ref_h, ref_g), ref_grad = jax.jit(lambda p, y: (jgeo(p, y), jax.grad(jloss)(p, y)))(
        jparams, jnp.asarray(x))
    h, g = tfield.geonetwork_with_gradient(_t(x))
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(ref_g), rtol=1e-4, atol=1e-4)
    h, g = tfield.geonetwork_with_gradient(_t(x), train=True)
    (gp,) = torch.autograd.grad(torch.sum(h * _t(wh)) + torch.sum(g ** 2), [tfield.encoding.plane_coef])
    _grads_close(gp.numpy(), np.asarray(ref_grad["encoding"]["plane_coef"]), 1e-4)


# --- NeRF-W's uncertainty ------------------------------------------------------------------


def test_render_uncertainty_matches_jax():
    rng = np.random.default_rng(7)
    betas, weights = rng.uniform(0, 2, (9, 11)), rng.uniform(0, 0.2, (9, 11))
    ref = jR.render_uncertainty(jnp.asarray(betas, jnp.float32), jnp.asarray(weights, jnp.float32))
    out = tR.render_uncertainty(_t(betas), _t(weights))
    assert out.shape == (9, 1)
    _close(out, ref, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="render_uncertainty"):
        tR.render_uncertainty(_t(betas), _t(weights[:, :5]))


# --- the D-NeRF and Friends parsers ----------------------------------------------------


def _port_cameras_match(t, j):
    _close(t.cameras.camera_to_worlds.numpy(), np.asarray(j.cameras.camera_to_worlds), rtol=0,
           atol=1e-6)
    for k in ("fx", "fy", "cx", "cy", "width", "height"):
        _close(getattr(t.cameras, k).numpy(), np.asarray(getattr(j.cameras, k)).reshape(-1),
               rtol=1e-6, atol=0)
    assert [str(p) for p in t.image_filenames] == [str(p) for p in j.image_filenames]
    assert np.array_equal(t.scene_box.aabb, np.asarray(j.scene_box.aabb))
    assert (t.scene_box.near, t.scene_box.far, t.scene_box.collider_type) == (
        j.scene_box.near, j.scene_box.far, j.scene_box.collider_type)


def test_dnerf_parser_matches_jax(tmp_path):
    """Both splits of a D-NeRF scene (one frame without a time: 0), the
    times on the cameras and on their rays, the composited pixels."""
    from sdfstudio_tpu.data.dataparsers.misc_parsers import DNeRF as JDNeRF
    from sdfstudio_tpu.data.dataparsers.misc_parsers import DNeRFDataParserConfig as JDC
    from sdfstudio_tpu.data.datamanager import VanillaDataManager as JDM

    from sdfstudio_tpu_torch.data.datamanager import stack_images
    from sdfstudio_tpu_torch.data.dataparsers.misc_parsers import DNeRFDataParserConfig, parse_dnerf
    from sdfstudio_tpu_torch.data.synthetic import generate_blender_sphere_dataset

    generate_blender_sphere_dataset(tmp_path, num_images=6, width=12, height=10, times=True,
                                    val_every=3)
    meta = json.loads((tmp_path / "transforms_train.json").read_text())
    del meta["frames"][1]["time"]
    (tmp_path / "transforms_train.json").write_text(json.dumps(meta))
    for split in ("train", "val"):
        j = JDNeRF(JDC(data=tmp_path, scale_factor=0.7, alpha_color="black")).get_dataparser_outputs(
            split)
        t = parse_dnerf(DNeRFDataParserConfig(data=tmp_path, scale_factor=0.7, alpha_color="black"),
                        split)
        _port_cameras_match(t, j)
        np.testing.assert_array_equal(t.cameras.times.numpy(), np.asarray(j.cameras.times))
        assert t.metadata == j.metadata == {"height": 10, "width": 12}
        assert np.array_equal(t.alpha_color, np.asarray(j.alpha_color))
        np.testing.assert_array_equal(stack_images(t)["image"], np.asarray(JDM._stack(j)["image"]))
        idx = np.array([0, 1, 1], np.int32)
        coords = np.array([[2.5, 3.5], [0.5, 0.5], [9.5, 11.5]], np.float32)
        jr = j.cameras.generate_rays(jnp.asarray(idx), jnp.asarray(coords))
        tr = t.cameras.generate_rays(torch.from_numpy(idx.astype(np.int64)), _t(coords))
        np.testing.assert_array_equal(tr.times.numpy(), np.asarray(jr.times))
        samples = tr.get_ray_samples(torch.linspace(2, 6, 5).expand(3, 5).contiguous())
        assert samples.times is tr.times
    assert float(t.cameras.times.max()) > 0 and parse_dnerf(
        DNeRFDataParserConfig(data=tmp_path)).cameras.times[1] == 0.0


def test_friends_parser_matches_jax(tmp_path):
    """The poses' columns 1:3 negated, per-frame intrinsics, both splits the
    same frames, ``downscale_factor`` unread, the segmentations named in the
    metadata (and None without them or with ``include_semantics`` off), and
    the data manager reading the images only."""
    from sdfstudio_tpu.data.dataparsers.misc_parsers import Friends as JFriends
    from sdfstudio_tpu.data.dataparsers.misc_parsers import FriendsDataParserConfig as JFC

    from sdfstudio_tpu_torch.data.datamanager import DataManagerConfig, VanillaDataManager
    from sdfstudio_tpu_torch.data.dataparsers.misc_parsers import (FriendsDataParserConfig,
                                                                   parse_friends)
    from sdfstudio_tpu_torch.data.synthetic import generate_friends_sphere_dataset

    generate_friends_sphere_dataset(tmp_path, num_images=3, width=12, height=9)
    for kw in ({}, {"include_semantics": False, "downscale_factor": 2, "scene_scale": 1.5}):
        j = JFriends(JFC(data=tmp_path, **kw))
        t_train = parse_friends(FriendsDataParserConfig(data=tmp_path, **kw), "train")
        t_val = parse_friends(FriendsDataParserConfig(data=tmp_path, **kw), "val")
        for split, t in (("train", t_train), ("val", t_val)):
            jo = j.get_dataparser_outputs(split)
            _port_cameras_match(t, jo)
            sem = jo.metadata["semantics"]
            assert t.metadata["semantics"] == sem
            assert (sem is None) == ("include_semantics" in kw)
    assert t_train.image_filenames == t_val.image_filenames
    t = parse_friends(FriendsDataParserConfig(data=tmp_path))
    dm = VanillaDataManager(DataManagerConfig(), t, t, device="cpu")
    assert set(dm.train_data) == {"image"} and dm.eval_data is None
    assert all(p.exists() for p in t.metadata["semantics"])
