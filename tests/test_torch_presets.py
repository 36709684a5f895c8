"""The three remaining ``neus-facto`` presets -- ``neus-facto-tpu`` (hash
L8 x F4 at 2^19 rows, PE+MLP proposals at 128), ``neus-facto-tpu-p4``
(permutohedral L4 x F4, PE+MLP proposals at 64) and ``neus-facto-bigmlp``
(JAX's default field at 8 x 512 with the 4-layer colour net, hash
proposals and the NeRF background) -- against the JAX package, on the CPU.

Each preset carries JAX's registry values (model, optimizer groups and
schedules, trainer, data manager), builds JAX's full-size parameter tree
leaf for leaf (names and shapes through ``jax.eval_shape`` and a
``meta``-device model), and one train step of a shrunk copy holds JAX's.
Each preset has its own small case, so that the earlier cross-checks are
not parametrised again.

The shrunk step: JAX's model at the preset's structure with its widths cut
(geometry hidden 32 or 64, colour 32, the grid to a few levels of a 2^10
table, proposal samples (16, 8) + 8; the NeRF background at its fixed full
width, 4 samples a ray), initialised by JAX and perturbed from a numpy
seed, carried into the port by ``params_from_jax``; the same rays through
both, without jitter, at step 20 (an update step inside the proposal
weights' anneal). Tolerances, as ``tests/test_torch_train.py`` holds the
``neus-facto`` step and for its reasons: each loss to 1e-4 relative, each
parameter's gradient to 5e-4 of its own scale (max |JAX grad|).

The background's merge is a decision: a sample takes the background
field's alpha and colour where its start lies outside the unit sphere. On
``neus-facto-bigmlp``'s rays one of the 384 samples starts 2.4e-6 from that
sphere, within the f32 rounding of the two sides' sample positions (~6e-6),
so the two f32 steps may put it on either side. That step therefore also
runs in float64 on both sides (JAX under ``jax.enable_x64``, as
``tests/test_torch_surface_methods.py`` does), where every gradient is held
to 1e-4 of its scale; in float32 the background group is held only where
every sample is clear of the sphere by more than that rounding (1e-5).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sdfstudio_tpu.configs.methods import get_method_config as jget_method_config
from sdfstudio_tpu.core.scene_box import SceneBox as JSceneBox

from sdfstudio_tpu_torch.configs.methods import MethodConfig, build_model, get_method_config
from sdfstudio_tpu_torch.core.scene_box import SceneBox as TSceneBox
from sdfstudio_tpu_torch.engine.optimizers import build_optimizers
from sdfstudio_tpu_torch.engine.trainer import group_grads, loss_and_metrics
from sdfstudio_tpu_torch.fields.sdf_field import SDFFieldConfig as TSDFFieldConfig
from sdfstudio_tpu_torch.utils.convert import params_from_jax
from tests.test_torch_surface_methods import _f64_grads, _jax_step_f64
from tests.test_torch_train import _close, _port_tree, _rays, _t
from tests.test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

NUM_IMAGES = 3
KW = dict(near=0.8, far=4.0, radius=1.0, collider_type="near_far")
STEP = 20


def _full_tree_matches(method):
    """The registered entry's values against JAX's, and its full-size tree."""
    jcfg, tcfg = jget_method_config(method), get_method_config(method)
    for f in dataclasses.fields(tcfg.model):
        if f.name != "sdf_field":
            assert getattr(tcfg.model, f.name) == getattr(jcfg.model, f.name), f.name
    for f in dataclasses.fields(TSDFFieldConfig):
        assert getattr(tcfg.model.sdf_field, f.name) == getattr(jcfg.model.sdf_field, f.name), f.name
    for f in dataclasses.fields(tcfg.trainer):
        assert getattr(tcfg.trainer, f.name) == getattr(jcfg.trainer, f.name), f.name
    assert tcfg.datamanager.train_num_rays_per_batch == jcfg.datamanager.train_num_rays_per_batch
    for g, og in tcfg.optimizers.items():
        jo = jcfg.optimizers[g]
        for k in ("kind", "lr", "eps", "weight_decay"):
            assert getattr(og.optimizer, k) == getattr(jo.optimizer, k), (g, k)
        sched, jsched = og.scheduler.build(), jax.jit(jo.scheduler.build(jo.optimizer.lr))
        # JAX evaluates the cosine in f32: ~2e-6 of rounding half-way through 20,000 steps
        for step in [0, 250, 500, 10000, 50000, 99999]:
            _close(sched(step), jsched(jnp.asarray(step, jnp.int32)), rtol=1e-5, atol=1e-9)
    jmodel = jcfg.model_class(jcfg.model, JSceneBox(**KW), NUM_IMAGES)
    abstract = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    views = jax.tree_util.tree_map(lambda a: np.broadcast_to(np.zeros((), a.dtype), a.shape), abstract)
    shapes = {k: v.shape for k, v in _port_tree(views).items()}
    with torch.device("meta"):
        tmodel = tcfg.model_class(tcfg.model, TSceneBox(**KW), NUM_IMAGES)
    port = {n: tuple(p.shape) for n, p in tmodel.named_parameters()}
    assert port == shapes
    # every JAX group with parameters is a port group (JAX's placeholder
    # "field_background" of a method without a background has none)
    assert {g for g in jcfg.optimizers if any(k.startswith(g + ".") for k in shapes)} == set(tcfg.optimizers)
    return port


def _small_step(method, sdf_kw, model_kw, seed=0):
    """One shrunk train step of ``method`` on both sides (see the module docstring)."""
    jcfg = jget_method_config(method).model
    jsdf = dataclasses.replace(jcfg.sdf_field, **sdf_kw)
    jcfg = dataclasses.replace(jcfg, sdf_field=jsdf, num_proposal_samples_per_ray=(16, 8),
                               num_neus_samples_per_ray=8, **model_kw)
    tsdf = TSDFFieldConfig(**{f.name: getattr(jsdf, f.name) for f in dataclasses.fields(TSDFFieldConfig)})
    tcls = type(get_method_config(method).model)
    tcfg = tcls(**{f.name: tsdf if f.name == "sdf_field" else getattr(jcfg, f.name)
                   for f in dataclasses.fields(tcls)})
    jmodel = jget_method_config(method).model_class(jcfg, JSceneBox(**KW), NUM_IMAGES)
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
    tmodel = build_model(MethodConfig(f"small-{method}", get_method_config(method).model_class, tcfg),
                         TSceneBox(**KW), NUM_IMAGES, device="cpu")
    params_from_jax(tmodel, np_params)

    jb, tb, batch = _rays()
    jsched = jmodel.schedules(jnp.asarray(float(STEP), jnp.float32))
    tsched = tmodel.schedules(STEP)
    assert tsched["train_proposal"]

    @jax.jit
    def jloss(params):
        out = jmodel.get_outputs(params, jb, rng=None, sched=jsched, train=True)
        ld = jmodel.get_loss_dict(params, out, {k: jnp.asarray(v) for k, v in batch.items()}, jsched, None)
        return sum(ld.values()), ld

    (ref_total, ref_ld), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
    opts = build_optimizers(get_method_config(method).optimizers, tmodel)
    total, ld, _ = loss_and_metrics(tmodel, tb, {k: _t(v) for k, v in batch.items()}, tsched)
    assert sorted(ld) == sorted(ref_ld)
    for k in ld:
        _close(ld[k].detach(), ref_ld[k], rtol=1e-4, atol=0)
    _close(total.detach(), ref_total, rtol=1e-4, atol=0)
    grads = group_grads(total, opts)
    ref_g = _port_tree({g: jg[g] for g in opts})
    f32_groups = set(opts)
    if tmodel.field_background is not None:
        out = tmodel.sample_and_forward_field(tmodel.apply_collider(tb, train=True), tsched,
                                              train=True)
        radius = torch.linalg.vector_norm(out["ray_samples"].get_start_positions(), dim=-1)
        margin = float((radius - 1.0).abs().min())
        if margin <= 1e-5:
            f32_groups.discard("field_background")
        ref_g64, _ = _jax_step_f64(jmodel, np_params, jb, batch, STEP, method)
        g64 = _f64_grads(tmodel, tb, {k: _t(v) for k, v in batch.items()}, tsched, method, None)
    seen = 0
    for group, opt in opts.items():
        for name, g in zip(opt.names, grads[group]):
            ref = ref_g[name]
            if g is None:  # no part in the loss: JAX's gradient is exactly zero
                assert not np.any(ref), name
                continue
            scale = float(np.abs(ref).max())
            assert scale > 0, name
            if group in f32_groups:
                assert float(np.abs(g.numpy() - ref).max()) <= 5e-4 * scale, name
            if tmodel.field_background is not None:
                scale64 = float(np.abs(ref_g64[name]).max())
                assert float(np.abs(g64[name].numpy() - ref_g64[name]).max()) <= 1e-4 * scale64, name
            seen += 1
    return tmodel, opts, seen


def test_neus_facto_tpu_tree_and_step_match_jax():
    port = _full_tree_matches("neus-facto-tpu")
    assert port["field.encoding.hash_table"][1] == 4  # F = 4 rows
    assert port["proposal_networks.0.mlp.layers.0.kernel"] == (39, 128)
    tmodel, opts, seen = _small_step(
        "neus-facto-tpu", dict(hidden_dim=32, geo_feat_dim=32, hidden_dim_color=32, num_levels=4,
                               base_res=4, max_res=32, log2_hashmap_size=10), {})
    assert tmodel.field.encoding.hash_table.shape[1] == 4
    assert set(opts) == {"field", "proposal_networks"} and seen >= 15


def test_neus_facto_tpu_p4_tree_and_step_match_jax():
    port = _full_tree_matches("neus-facto-tpu-p4")
    # the proposal chains at hidden 64: [39 -> 64 -> 64 -> 1] and [51 -> 64 -> 64 -> 1]
    assert port["proposal_networks.0.mlp.layers.0.kernel"] == (39, 64)
    assert port["proposal_networks.1.mlp.layers.0.kernel"] == (51, 64)
    tmodel, opts, seen = _small_step(
        "neus-facto-tpu-p4", dict(hidden_dim=32, geo_feat_dim=32, hidden_dim_color=32,
                                  log2_hashmap_size=10), {})
    assert type(tmodel.field.encoding).__name__ == "PermutoEncoding"
    assert set(opts) == {"field", "proposal_networks"} and seen >= 15


def test_neus_facto_bigmlp_tree_and_step_match_jax():
    port = _full_tree_matches("neus-facto-bigmlp")
    assert "field.encoding.hash_table" not in port  # JAX's default field: no grid feature
    assert port["field.glin0.kernel"] == (71, 512) and port["field.glin3.kernel"] == (512, 441)
    assert port["field.glin8.kernel"] == (512, 257)
    # the 4-layer colour net [321 -> 256 x4 -> 3]
    assert port["field.clin0.kernel"] == (321, 256) and port["field.clin4.kernel"] == (256, 3)
    tmodel, opts, seen = _small_step(
        "neus-facto-bigmlp", dict(hidden_dim=64, geo_feat_dim=32, hidden_dim_color=32, num_levels=4),
        dict(num_samples_outside=4,
             proposal_net_args_list=({"hidden_dim": 16, "log2_hashmap_size": 10, "num_levels": 3,
                                      "max_res": 64},
                                     {"hidden_dim": 16, "log2_hashmap_size": 10, "num_levels": 3,
                                      "max_res": 256})))
    assert tmodel.field_background is not None and tmodel.field.n_glayers == 9
    assert set(opts) == {"field", "field_background", "proposal_networks"} and seen >= 30
