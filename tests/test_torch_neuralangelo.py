"""Neuralangelo in the port against the JAX package, on the CPU.

The test size: a hash grid of 4 levels x 8 features (``log2_hashmap_size``
12, resolutions 8 to 64, linear weights: level 0 dense, levels 1-3 hashed),
a 1-layer geometry MLP of 32 and 2 colour layers of 32, no positional
encoding (zeros in its place), numerical gradients, the NeRF background at
JAX's fixed width with 4 samples a ray, and NeuS sampling of 8 + 2 x 4
samples on 16 rays. ``level_init`` is 2, so that the progressive mask
switches levels off on this 4-level grid. JAX initialises, a numpy seed
perturbs, ``params_from_jax`` carries the tree into the port, and the same
inputs go through both.

Tolerances, with their reasons:
- the F = 8 encode with linear weights and the mask: out 1e-6 (eight
  products a level, summed in another order); the table gradient from
  ``g_out`` 1e-5 (a row's updates added in another order).
- the numerical gradient is ``0.5 (sdf(+) - sdf(-)) / delta``: an sdf held
  to rounding r (a few ulp of its size, ~2e-7 here) gives a gradient held to
  about r / delta. At step 0's delta (2 / base_res = 1/4 here) that is
  ~1e-6, so the taps' SDF and the gradient are held to 1e-5 in float32. At
  the late delta (2 / max_res = 1/32) f32 rounding alone moves the gradient
  by ~1e-5 and the curvature, ``(a + b - 2 sdf) / delta^2``, by ~1e-3 of its
  size: those cases run in float64 on both sides, where the same bound r /
  delta is ~1e-13, and are held to 1e-5.
- schedules: the mask exactly, delta and the curvature factor to 1e-7.
- AdamW against ``optax.adamw`` over 3 steps: 1e-6.
- one train step: the loss dict to 1e-4 relative and every gradient to 5e-4
  of its scale in float32 (as tests/test_torch_train.py), 1e-4 in float64.
  JAX's dense layers round their products to f32 even under
  ``jax.enable_x64`` (``WNLinear``, ops/mlp.py:83-87: ``preferred_element_type
  =float32``), so its float64 step keeps f32 rounding in every layer output
  (its losses sit ~1e-8 from the port's). On the SDF field that is far
  below 1e-4, delta's amplification included. The NeRF background's 11
  layers carry it into gradients whose scale here is ~1e-4 of the SDF
  table's, sums with cancellation, where it reaches a few 1e-4: the
  ``field_background`` group is held to the float32 bound, 5e-4, in float64
  too.
"""
import contextlib
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sdfstudio_tpu.configs.methods import get_method_config as jget_method_config
from sdfstudio_tpu.core.rays import RayBundle as JRayBundle
from sdfstudio_tpu.core.scene_box import SceneBox as JSceneBox
from sdfstudio_tpu.components import losses as jlosses
from sdfstudio_tpu.engine.optimizers import build_optimizer as jbuild_optimizer
from sdfstudio_tpu.engine.schedulers import SchedulerConfig as JSchedulerConfig
from sdfstudio_tpu.fields.sdf_field import SDFField as JSDFField
from sdfstudio_tpu.ops.encodings import HashEncoding as JHashEncoding
from sdfstudio_tpu.utils.fast_checkpoint import save_packed

from sdfstudio_tpu_torch.components import losses as tlosses
from sdfstudio_tpu_torch.configs.methods import MethodConfig, build_model, get_method_config
from sdfstudio_tpu_torch.core.rays import RayBundle as TRayBundle
from sdfstudio_tpu_torch.core.scene_box import SceneBox as TSceneBox
from sdfstudio_tpu_torch.engine.optimizers import (GroupAdam, OptimizerConfig, OptimizerGroupConfig,
                                                   build_optimizers)
from sdfstudio_tpu_torch.engine.schedulers import SchedulerConfig as TSchedulerConfig
from sdfstudio_tpu_torch.engine.trainer import Trainer, group_grads, loss_and_metrics
from sdfstudio_tpu_torch.fields.sdf_field import SDFField as TSDFField
from sdfstudio_tpu_torch.fields.sdf_field import SDFFieldConfig as TSDFFieldConfig
from sdfstudio_tpu_torch.ops.encodings import HashEncoding as THashEncoding
from sdfstudio_tpu_torch.scripts import train as train_script
from sdfstudio_tpu_torch.utils.convert import _flatten, _port_key, load_jax_checkpoint, params_from_jax
from tests.test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

NUM_IMAGES = 3
SCENE = pathlib.Path(__file__).resolve().parents[1] / ".parity" / "dtu_like"
GRID = dict(num_levels=4, base_res=8, max_res=64, log2_hashmap_size=12, hash_features_per_level=8)
SMALL_FIELD = dict(**GRID, hidden_dim=32, geo_feat_dim=32, hidden_dim_color=32, num_layers_color=2)
SMALL_MODEL = dict(num_samples=8, num_samples_importance=8, num_up_sample_steps=2,
                   num_samples_outside=4, level_init=2)


def _t(a, dtype=np.float32):
    return torch.from_numpy(np.array(a, dtype=dtype))


def _close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port.detach() if torch.is_tensor(port) else port),
                               np.asarray(ref), **tol)


def _port_tree(tree):
    return {_port_key(k): np.asarray(v) for k, v in _flatten(tree).items()}


def _f64(a):
    a = np.asarray(a)
    return jnp.asarray(a.astype(np.float64) if a.dtype == np.float32 else a)


def _configs(**field):
    """JAX's registered Neuralangelo, cut to the test size, and the port's
    config with the same values."""
    jcfg = jget_method_config("neuralangelo").model
    jcfg = dataclasses.replace(jcfg, sdf_field=dataclasses.replace(jcfg.sdf_field, **SMALL_FIELD,
                                                                   **field), **SMALL_MODEL)
    tcfg = get_method_config("neuralangelo").model
    tcfg = dataclasses.replace(tcfg, sdf_field=dataclasses.replace(tcfg.sdf_field, **SMALL_FIELD,
                                                                   **field), **SMALL_MODEL)
    return jcfg, tcfg


def _scene_boxes():
    kw = dict(near=0.8, far=4.0, radius=1.0, collider_type="near_far")
    return JSceneBox(**kw), TSceneBox(**kw)


_MODELS = {}


def _models():
    """JAX's and the port's small Neuralangelo, the same perturbed parameters."""
    if not _MODELS:
        jcfg, tcfg = _configs()
        jsb, tsb = _scene_boxes()
        jmodel = jget_method_config("neuralangelo").model_class(jcfg, jsb, NUM_IMAGES)
        params = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
        rng = np.random.default_rng(0)

        def perturb(path, a):
            name, a = jax.tree_util.keystr(path), np.asarray(a)
            if "deviation" in name or "laplace_beta" in name:
                return a
            scale = 0.5 if "hash_table" in name else 0.05  # a table far from its 1e-4 init
            return (a + scale * rng.standard_normal(a.shape)).astype(np.float32)

        np_params = jax.tree_util.tree_map_with_path(perturb, params)
        tmodel = build_model(MethodConfig("small-neuralangelo",
                                          get_method_config("neuralangelo").model_class, tcfg),
                             tsb, NUM_IMAGES, device="cpu")
        params_from_jax(tmodel, np_params)
        _MODELS.update(jmodel=jmodel, np_params=np_params, tmodel=tmodel)
    return _MODELS["jmodel"], _MODELS["np_params"], _MODELS["tmodel"]


# --- the encode at F = 8 -------------------------------------------------------


def _face_points(rng, n, delta):
    """Points in [0, 1]^3, a third of them within ``delta`` of a face (below
    0.5 delta from 0 or 1 on one axis), with their six taps at +-delta: the
    taps past a face leave the cube, below 0 on the dense level 0 (a
    negative int32 index, read from the table's end) and past 1."""
    x = rng.uniform(0.0, 1.0, (n, 3))
    near = np.arange(n) % 3 == 0
    axis = rng.integers(0, 3, n)
    side = rng.integers(0, 2, n)
    off = rng.uniform(0.0, 0.5 * delta, n)
    x[near, axis[near]] = np.where(side[near] == 0, off[near], 1.0 - off[near])
    taps = np.concatenate([x + s * delta * np.eye(3)[a] for a in range(3) for s in (1.0, -1.0)])
    return np.concatenate([x, taps]).astype(np.float32)


def test_hash_encoding_f8_linear_masked_matches_jax():
    """HashEncoding at F = 8 with linear weights and a 2-of-4-level mask:
    out (and the jacobian) 1e-6, the table gradient from ``g_out`` 1e-5, on
    points near the faces and their taps outside the cube."""
    kw = dict(num_levels=4, min_res=8, max_res=64, log2_hashmap_size=12, features_per_level=8,
              smoothstep=False)
    jenc, tenc = JHashEncoding(**kw), THashEncoding(**kw)
    assert tenc.total_rows == jenc.total_rows == 729 + 3 * 4096
    rng = np.random.default_rng(0)
    table = rng.uniform(-1.0, 1.0, (tenc.total_rows, 8)).astype(np.float32)
    x = _face_points(rng, 300, 1.0 / 32)
    assert (x < 0).any() and (x > 1).any()
    mask = (np.arange(32) // 8 < 2).astype(np.float32)
    g = rng.standard_normal((x.shape[0], 32)).astype(np.float32)
    jp = {"params": {"hash_table": jnp.asarray(table)}}

    def jloss(t):
        out = jenc.apply({"params": {"hash_table": t}}, jnp.asarray(x)) * mask
        return jnp.sum(out * g), out

    (_, ref_out), ref_grad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jnp.asarray(table))
    _, ref_jac = jax.jit(lambda p: jenc.apply(p, jnp.asarray(x), want_jac=True))(jp)
    with torch.no_grad():
        tenc.hash_table.copy_(_t(table))
    out = tenc(_t(x)) * _t(mask)
    torch.sum(out * _t(g)).backward()
    assert not np.isnan(np.asarray(ref_out)).any()
    _close(out, ref_out, rtol=1e-6, atol=1e-6)
    with torch.no_grad():
        _, jac = tenc(_t(x), want_jac=True)
    _close(jac, ref_jac, rtol=1e-6, atol=1e-6 * float(np.abs(np.asarray(ref_jac)).max()))
    ref_grad = np.asarray(ref_grad)
    grad = tenc.hash_table.grad.numpy()
    assert float(np.abs(grad - ref_grad).max()) <= 1e-5 * float(np.abs(ref_grad).max())
    # the masked levels' corners take no gradient: every row that takes one
    # is a corner row of levels 0-1, and some of level 0's are negative
    # indices, wrapped to the table's end (level 3's rows)
    from sdfstudio_tpu_torch.ops.hash_grid import corner_indices, table_rows

    idx = table_rows(corner_indices(_t(x), tenc.spec)[0][:, :2], tenc.total_rows)
    reached = np.zeros(tenc.total_rows, bool)
    reached[idx.reshape(-1).numpy()] = True
    assert not grad[~reached].any() and grad[reached].any()
    assert reached[729 + 2 * 4096:].any()


# --- the numerical gradient, the curvature loss, the schedules ----------------


def _fields(dtype):
    """JAX's SDF field at the test size and the port's, the same parameters."""
    jmodel, np_params, tmodel = _models()
    tf = tmodel.field
    jparams = jax.tree_util.tree_map(jnp.asarray if dtype == np.float32 else _f64,
                                     np_params["field"])
    if dtype == np.float64:
        import copy

        tf = copy.deepcopy(tf).double()
    return jmodel.field, jparams, tf


@pytest.mark.parametrize("case", ["step0_f32", "late_f64"])
def test_numerical_gradient_and_sampled_sdf_match_jax(case):
    """The six taps' SDF and the central-difference gradient at step 0's
    delta in float32 (1e-5) and at the late delta in float64 (1e-5), with a
    mask of 2 levels at step 0 and of all 4 late."""
    dtype = np.float32 if case == "step0_f32" else np.float64
    delta, levels = (2.0 / 8, 2) if case == "step0_f32" else (2.0 / 64, 4)
    jf, jparams, tf = _fields(dtype)
    mask = (np.arange(32) // 8 < levels).astype(dtype)
    x = np.random.default_rng(1).uniform(-1.2, 1.2, (64, 3)).astype(dtype)
    with jax.enable_x64() if dtype == np.float64 else contextlib.nullcontext():
        ref_g, ref_s = jax.jit(lambda p, x: jf.gradient(
            p, x, hash_mask=jnp.asarray(mask), numerical_delta=jnp.asarray(delta, dtype),
            skip_spatial_distortion=True, return_sampled_sdf=True))(jparams, jnp.asarray(x))
        ref_h = jax.jit(lambda p, x: jf.geonetwork_fn(p, jnp.asarray(mask))(x))(jparams, jnp.asarray(x))
        assert np.asarray(ref_g).dtype == dtype
    with torch.no_grad():
        h, g, s = tf.numerical_gradient(_t(x, dtype), delta, _t(mask, dtype), with_centre=True)
    assert s.shape == (64, 6)
    _close(s, ref_s, rtol=1e-5, atol=1e-5)
    _close(h, ref_h, rtol=1e-5, atol=1e-5)
    _close(g, ref_g, rtol=1e-5, atol=1e-5)
    # the field's own entry point, on points inside |x| <= 1 (where the
    # contraction is the identity): the taps alone, the same values
    xi = _t(x[:8] * 0.5, dtype)
    with torch.no_grad():
        g2, s2 = tf.gradient(xi, _t(mask, dtype), delta, return_sampled_sdf=True)
        h_in, g_in, s_in = tf.numerical_gradient(xi, delta, _t(mask, dtype))
    assert h_in is None
    _close(g2, g_in, rtol=1e-6, atol=1e-6)
    _close(s2, s_in, rtol=1e-6, atol=1e-6)


def test_curvature_loss_matches_jax():
    rng = np.random.default_rng(2)
    sampled = rng.standard_normal((5, 7, 6)).astype(np.float32)
    sdf = rng.standard_normal((5, 7)).astype(np.float32)
    for delta in (2.0 / 64, 2.0 / 4096):
        ref = jlosses.curvature_loss(jnp.asarray(sampled), jnp.asarray(sdf), jnp.asarray(delta, jnp.float32))
        _close(tlosses.curvature_loss(_t(sampled), _t(sdf), delta), ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("step", [0, 4999, 5000, 12345, 80000])
def test_schedules_match_jax(step):
    """The registered schedule at the full grid's levels and resolutions (a
    small table: the schedules read only levels, resolutions and features)
    at a float32 step, as JAX's train step evaluates them: the mask exactly,
    delta and the curvature factor to 1e-7."""
    jcfg = jget_method_config("neuralangelo").model
    jcfg = dataclasses.replace(jcfg, sdf_field=dataclasses.replace(jcfg.sdf_field, log2_hashmap_size=8))
    jsb, tsb = _scene_boxes()
    jmodel = jget_method_config("neuralangelo").model_class(jcfg, jsb, 1)
    ref = jax.jit(jmodel.schedules)(jnp.asarray(step, jnp.float32))
    tcfg = get_method_config("neuralangelo")
    tcfg = dataclasses.replace(tcfg, model=dataclasses.replace(
        tcfg.model, sdf_field=dataclasses.replace(tcfg.model.sdf_field, log2_hashmap_size=8)))
    with torch.device("meta"):  # the schedules read the config only; no table is allocated
        tmodel = tcfg.model_class(tcfg.model, tsb, 1)
    tmodel.field.laplace_beta = torch.nn.Parameter(torch.zeros(1))  # a CPU tensor to place the mask
    sched = tmodel.schedules(step)
    mask = sched["hash_mask"].numpy()
    assert mask.shape == (128,) and np.array_equal(mask, np.asarray(ref["hash_mask"]))
    assert int(mask.sum()) // 8 == {0: 4, 4999: 4, 5000: 4, 12345: 4, 80000: 16}[step]
    for k in ("numerical_delta", "curvature_factor", "cos_anneal_ratio"):
        _close(sched[k], ref[k], rtol=1e-7, atol=1e-7)


def test_multistep_warmup_schedule_matches_jax():
    kw = dict(warm_up_end=5000, milestones=(300000, 400000), gamma=0.1)
    js = jax.jit(JSchedulerConfig(kind="multistep_warmup", **kw).build(1e-3))
    ts = TSchedulerConfig(kind="multistep_warmup", **kw).build()
    for step in [0, 1, 2500, 4999, 5000, 5001, 299999, 300000, 350000, 400000, 500000]:
        _close(ts(step), js(jnp.asarray(step, jnp.int32)), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("weight_decay", [0.01, 0.3])
def test_adamw_matches_optax(weight_decay):
    """Three AdamW steps (the registered ``weight_decay=0.01``, and 0.3, at
    which a decay 1% off moves a parameter by 1.5e-5, past the tolerance;
    the warmup schedule) against optax's ``adamw`` through JAX's
    ``build_optimizer``: 1e-6."""
    from sdfstudio_tpu.engine.optimizers import OptimizerConfig as JOptimizerConfig
    from sdfstudio_tpu.engine.optimizers import OptimizerGroupConfig as JOptimizerGroupConfig

    rng = np.random.default_rng(4)
    params = {"field": {"a": rng.standard_normal((5, 3)).astype(np.float32),
                        "b": rng.standard_normal((7,)).astype(np.float32)}}
    grads = [{"field": {k: rng.standard_normal(v.shape).astype(np.float32)
                        for k, v in params["field"].items()}} for _ in range(3)]
    sched = dict(warm_up_end=2, milestones=(2,), gamma=0.5)
    jtx = jbuild_optimizer({"field": JOptimizerGroupConfig(
        JOptimizerConfig(kind="adamw", lr=1e-2, eps=1e-15, weight_decay=weight_decay),
        JSchedulerConfig(kind="multistep_warmup", **sched))}, params)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = jtx.init(jp)
    names = ["a", "b"]
    tp = [_t(params["field"][n]) for n in names]
    opt = GroupAdam(tp, names, OptimizerGroupConfig(
        OptimizerConfig(lr=1e-2, eps=1e-15, kind="adamw", weight_decay=weight_decay),
        TSchedulerConfig(kind="multistep_warmup", **sched)))
    for g in grads:
        upd, state = jax.jit(jtx.update)(g, state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([_t(g["field"][n]) for n in names], apply=True)
    for n, p in zip(names, tp):
        _close(p, jp["field"][n], rtol=1e-6, atol=1e-6)
        assert not np.allclose(np.asarray(jp["field"][n]), params["field"][n])
    # radam is ported (tests/test_torch_nerf_ops.py); sgd, which no method sets, is not
    with pytest.raises(NotImplementedError, match="sgd"):
        OptimizerConfig(lr=1.0, eps=1.0, kind="sgd")


# --- one train step ---------------------------------------------------------------


def _rays(R=16, seed=1):
    """Rays from distance 2, half aimed at the init's sphere and half past
    it (the background takes a share), with a pixel batch."""
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
    return jb, tb, {"image": rng.uniform(0, 1, (R, 3)).astype(np.float32)}


def _jax_step(jmodel, params, jb, batch, step, dtype):
    sched = jmodel.schedules(jnp.asarray(float(step), dtype))

    def loss(p):
        out = jmodel.get_outputs(p, jb, rng=None, sched=sched, train=True)
        ld = jmodel.get_loss_dict(p, out, batch, sched, None)
        return sum(ld.values()), ld

    (total, ld), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return total, ld, _port_tree(g)


def _port_step(tmodel, tb, batch, step):
    sched = tmodel.schedules(step)
    total, ld, metrics = loss_and_metrics(tmodel, tb, {k: _t(v) for k, v in batch.items()}, sched)
    names = [n for n, _ in tmodel.named_parameters()]
    grads = torch.autograd.grad(total, list(tmodel.parameters()), allow_unused=True)
    return total, ld, metrics, {n: g for n, g in zip(names, grads)}


def _hold(grads, ref, tol, tol_background=None):
    seen = 0
    for name, r in ref.items():
        t = tol_background if tol_background and name.startswith("field_background.") else tol
        g = grads[name]
        if g is None:  # no part in the loss: JAX's gradient is exactly zero
            assert not np.any(r), name
            continue
        scale = float(np.abs(r).max())
        assert scale > 0, name
        assert float(np.abs(g.detach().numpy() - r).max()) <= t * scale, name
        seen += 1
    return seen


@pytest.mark.parametrize("step,dtypes", [(1000, ("f32",)), (80000, ("f64",))])
def test_train_step_loss_and_grads_match_jax(step, dtypes):
    """One step at step 1,000 (2 of 4 levels, an early delta, the curvature
    term in its warmup) in float32, and at step 80,000 (every level, the
    late delta 2 / max_res, where f32 rounding alone moves the curvature
    term) in float64: the losses and every parameter's gradient against
    JAX's. The masked levels' table rows take exactly zero gradient on both
    sides."""
    jmodel, np_params, tmodel = _models()
    jb, tb, batch = _rays()
    if "f32" in dtypes:
        ref_total, ref_ld, ref_g = _jax_step(jmodel, jax.tree_util.tree_map(jnp.asarray, np_params),
                                             jb, {k: jnp.asarray(v) for k, v in batch.items()},
                                             step, jnp.float32)
        total, ld, metrics, grads = _port_step(tmodel, tb, batch, step)
        assert set(ld) == set(ref_ld) == {"rgb_loss", "eikonal_loss", "curvature_loss"}
        assert float(ld["curvature_loss"].detach()) > 0
        for k in ld:
            _close(ld[k], ref_ld[k], rtol=1e-4, atol=0)
        _close(total, ref_total, rtol=1e-4, atol=0)
        assert _hold(grads, ref_g, 5e-4) >= 20
        assert {"psnr", "s_val", "inv_s"} <= set(metrics)
        enc = tmodel.field.encoding
        masked = int(enc.level_offsets[2])  # levels 2 and 3 are off at step 1,000
        table_g = grads["field.encoding.hash_table"].numpy()
        assert not table_g[masked:].any() and not ref_g["field.encoding.hash_table"][masked:].any()
        assert table_g[:masked].any()
    if "f64" in dtypes:
        import copy

        with jax.enable_x64():
            _, ref_ld64, ref_g64 = _jax_step(jmodel, jax.tree_util.tree_map(_f64, np_params),
                                             jax.tree_util.tree_map(_f64, jb),
                                             {k: _f64(v) for k, v in batch.items()}, step,
                                             jnp.float64)
        m64 = copy.deepcopy(tmodel).double()
        f64 = lambda x: x.double() if torch.is_tensor(x) and x.is_floating_point() else x  # noqa: E731
        _, ld64, _, grads64 = _port_step(m64, tb.map(f64), {k: v.astype(np.float64)
                                                             for k, v in batch.items()}, step)
        assert float(ld64["curvature_loss"].detach()) > 0
        for k in ld64:
            _close(ld64[k], ref_ld64[k], rtol=1e-4, atol=0)
        assert _hold(grads64, ref_g64, 1e-4, tol_background=5e-4) >= 20


# --- the registered configuration and its trees ------------------------------------


def test_registered_config_and_full_size_tree_match_jax():
    """``neuralangelo`` carries JAX's values, and its full-size tree (the
    55,867,118 x 8 table) matches JAX's in names and shapes, compared
    through ``jax.eval_shape`` and a ``meta``-device model: nothing is
    allocated."""
    jcfg, tcfg = jget_method_config("neuralangelo"), get_method_config("neuralangelo")
    for f in dataclasses.fields(tcfg.model):
        if f.name != "sdf_field":
            assert getattr(tcfg.model, f.name) == getattr(jcfg.model, f.name), f.name
    for f in dataclasses.fields(TSDFFieldConfig):
        assert getattr(tcfg.model.sdf_field, f.name) == getattr(jcfg.model.sdf_field, f.name), f.name
    assert set(tcfg.optimizers) == set(jcfg.optimizers) == {"field", "field_background"}
    for g, og in tcfg.optimizers.items():
        jo = jcfg.optimizers[g]
        for k in ("kind", "lr", "eps", "weight_decay"):
            assert getattr(og.optimizer, k) == getattr(jo.optimizer, k), (g, k)
        sched, jsched = og.scheduler.build(), jax.jit(jo.scheduler.build(jo.optimizer.lr))
        for step in [0, 2500, 5000, 300000, 400000]:
            _close(sched(step), jsched(jnp.asarray(step, jnp.int32)), rtol=1e-6, atol=1e-9)
    assert tcfg.optimizers["field"].optimizer.weight_decay == 0.01
    assert tcfg.trainer.max_num_iterations == jcfg.trainer.max_num_iterations == 500001
    assert tcfg.datamanager.train_num_rays_per_batch == jcfg.datamanager.train_num_rays_per_batch == 512
    jsb, tsb = _scene_boxes()
    jmodel = jcfg.model_class(jcfg.model, jsb, NUM_IMAGES)
    abstract = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    # zero-strided views of one scalar: the names and shapes, no memory
    views = jax.tree_util.tree_map(lambda a: np.broadcast_to(np.zeros((), a.dtype), a.shape), abstract)
    shapes = {k: v.shape for k, v in _port_tree(views).items()}
    with torch.device("meta"):
        tmodel = tcfg.model_class(tcfg.model, tsb, NUM_IMAGES)
    port = {n: tuple(p.shape) for n, p in tmodel.named_parameters()}
    assert port == shapes
    assert port["field.encoding.hash_table"] == (55_867_118, 8)
    assert port["field.glin0.kernel"] == (167, 256) and port["field.glin1.kernel"] == (256, 257)
    assert sum(int(np.prod(s)) for s in port.values()) > 447_000_000


def _shrunk_method(name):
    """The registered entry with only its sizes cut to the test size."""
    cfg = get_method_config(name)
    if name == "neuralangelo":
        _, tcfg = _configs()
        cfg = dataclasses.replace(cfg, model=tcfg)
    return cfg


def test_trainer_takes_a_step_of_the_shrunk_registered_method(monkeypatch, tmp_path, capsys):
    """``scripts/train.py``'s ``setup_method_trainer`` on the committed scene with
    the registered ``neuralangelo`` shrunk to the test size: three steps
    through ``Trainer.train`` (AdamW on both groups), finite losses with the
    curvature term, and a save. The geometric init gives the grid feature
    zero weight in the first layer and the warmup a zero learning rate at
    step 0, so the table first takes a gradient on step 2."""
    monkeypatch.setattr(train_script, "get_method_config", _shrunk_method)
    trainer = train_script.setup_method_trainer("neuralangelo", SCENE, max_num_iterations=3,
                                                num_rays=16, device="cpu", output_dir=tmp_path)
    assert {g: o.kind for g, o in trainer.optimizers.items()} == {"field": "adamw",
                                                                 "field_background": "adamw"}
    table = trainer.model.field.encoding.hash_table
    before = table.detach().clone()
    last = trainer.train()
    assert trainer.step == 3 and {"loss", "rgb_loss", "eikonal_loss", "curvature_loss"} <= set(last)
    assert all(np.isfinite(v) for v in last.values())
    assert not torch.equal(before, table.detach())
    assert trainer.ckpt_dir.parent.parent.parent.parent == tmp_path
    assert (trainer.ckpt_dir / "step-000000003" / "step.txt").exists()


def test_jax_checkpoint_with_adamw_state_loads_leaf_for_leaf(tmp_path):
    """A tiny JAX Neuralangelo checkpoint, written by JAX's packed writer with
    its AdamW state after one update, loads into the port leaf for leaf."""
    jmodel, np_params, _ = _models()
    jcfg = jget_method_config("neuralangelo")
    params = jax.tree_util.tree_map(jnp.asarray, np_params)
    tx = jbuild_optimizer(jcfg.optimizers, params)
    state = tx.init(params)
    rng = np.random.default_rng(5)
    grads = jax.tree_util.tree_map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
    _, state = jax.jit(tx.update)(grads, state, params)
    path = tmp_path / "step-000000007"
    save_packed(path, {"params": params, "opt_state": state, "model_state": None,
                       "rng": jax.random.PRNGKey(3)})
    (path / "step.txt").write_text("7")
    jsb, tsb = _scene_boxes()
    _, tcfg = _configs()
    tmodel = build_model(MethodConfig("small-neuralangelo",
                                      get_method_config("neuralangelo").model_class, tcfg),
                         tsb, NUM_IMAGES, seed=9, device="cpu")
    opts = build_optimizers(get_method_config("neuralangelo").optimizers, tmodel)
    assert load_jax_checkpoint(tmodel, opts, path)[0] == 7
    flat = _port_tree(np_params)
    for n, p in tmodel.named_parameters():
        assert np.array_equal(p.detach().numpy(), flat[n]), n
    for group, opt in opts.items():
        adam = state.inner_states[group].inner_state[0]
        mu = _port_tree({group: jax.tree_util.tree_map(np.asarray, adam.mu[group])})
        nu = _port_tree({group: jax.tree_util.tree_map(np.asarray, adam.nu[group])})
        assert opt.count == 1 and opt.kind == "adamw"
        for n, m, v in zip(opt.names, opt.mu, opt.nu):
            assert np.array_equal(m.numpy(), mu[n]) and np.array_equal(v.numpy(), nu[n]), n
