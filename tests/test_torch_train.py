"""The port's training path against the JAX package, on the same numpy inputs.

Covers the fused MLP under autograd (against ``jax.vjp`` of
``pallas_mlp.fused_mlp(..., interpret=True)``), the losses, the jittered
samplers, the proposal gradient gate, one whole training step of a small
model of each ported method, ``neus-facto-tpu-p8`` and ``neus-facto`` (loss
dict and the gradient of every parameter, the hash tables' through the
encode's autograd node), and Adam with the schedules over a frozen proposal
step from a carried-over optax state.

Tolerances, with their reasons:
- fused MLP gradients: 1e-5 relative to each output's scale (max |JAX| + 1).
  Both sides are f32; dW and db sum over up to 300 rows in orders that
  differ between XLA and PyTorch. The inputs keep pre-activations away from
  the relu's jump (biases in +-[0.5, 1.5]), where a one-ulp difference of
  the two forwards would flip the derivative.
- losses: 1e-5 (atol and rtol), f32 elementwise math and short cumulative
  sums. The interlevel gradient divides the bound violation, a difference
  of two cumulative sums, by (w + 1e-5): XLA's tree-order cumsum and
  PyTorch's sequential one differ by ~1e-7 there, which reaches the
  gradient as ~1e-7 / w, so it is held to 2e-3 of its own scale.
- jittered samplers: 1e-5, as the eval-mode sampler tests.
- one training step: each loss to 1e-4 relative, each parameter's gradient
  to 5e-4 of its own scale (max |JAX grad|); measured 2e-5 and 7e-5. The
  step resamples twice and runs a double backward through the geometry MLP;
  sample positions agree to ~6e-6 (tests/test_torch_model.py), NeuS turns
  that into alpha changes of ~4e-4 on this perturbed field, and the BCE and
  interlevel terms divide by weights near their clip. It is taken at step
  20 (an update step inside the proposal-weight anneal, where the card's
  smoke run trains) and 1001 (a frozen step past it).
- Adam: 1e-6 relative on parameters and moments over 5 steps; optax and the
  port do the same f32 operations in a slightly different order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sdfstudio_tpu.components import losses as jL
from sdfstudio_tpu.configs.methods import get_method_config as jget_method_config
from sdfstudio_tpu.core.rays import RayBundle as JRayBundle
from sdfstudio_tpu.core.scene_box import SceneBox as JSceneBox
from sdfstudio_tpu.engine.optimizers import build_optimizer as jbuild_optimizer
from sdfstudio_tpu.ops.pallas_mlp import fused_mlp as jfused_mlp
from sdfstudio_tpu.samplers import pdf as jpdf
from sdfstudio_tpu.samplers import proposal as jprop
from sdfstudio_tpu.samplers import spaced as jspaced

from sdfstudio_tpu_torch.components import losses as tL
from sdfstudio_tpu_torch.configs.methods import MethodConfig, build_model, get_method_config
from sdfstudio_tpu_torch.core.rays import RayBundle as TRayBundle
from sdfstudio_tpu_torch.core.scene_box import SceneBox as TSceneBox
from sdfstudio_tpu_torch.engine.optimizers import build_optimizers
from sdfstudio_tpu_torch.engine.trainer import PROPOSAL_GROUP, apply_grads, group_grads, loss_and_metrics
from sdfstudio_tpu_torch.fields.sdf_field import SDFFieldConfig as TSDFFieldConfig
from sdfstudio_tpu_torch.models.neus_facto import NeuSFactoModel as TNeuSFactoModel
from sdfstudio_tpu_torch.models.neus_facto import NeuSFactoModelConfig as TNeuSFactoModelConfig
from sdfstudio_tpu_torch.ops import fused_mlp as tfm
from sdfstudio_tpu_torch.samplers import pdf as tpdf
from sdfstudio_tpu_torch.samplers import proposal as tprop
from sdfstudio_tpu_torch.samplers import spaced as tspaced
from sdfstudio_tpu_torch.utils.convert import _flatten, _port_key, opt_state_from_jax, params_from_jax
from tests.test_torch_model import METHODS, SMALL
from tests.test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

F32 = dict(rtol=1e-5, atol=1e-5)
NUM_IMAGES = 3


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), **(tol or F32))


def _port_tree(tree, prefix=""):
    """A JAX tree's leaves keyed by the port's parameter names."""
    return {_port_key(prefix + k): np.asarray(v) for k, v in _flatten(tree).items()
            if "dummy" not in k}


# --- fused MLP under autograd -------------------------------------------------


@pytest.mark.parametrize(
    "dims,act,out_act",
    [
        ([13, 32, 1], "relu", "none"),  # a proposal-like net with a width-1 head
        ([21, 16, 24, 3], "softplus100", "relu"),  # three layers, a width-3 head
        ([9, 3], "none", "softplus100"),  # one layer
        ([40, 24, 24, 3], "relu", "none"),  # a color-like net
    ],
)
def test_fused_mlp_grads_match_jax_pallas_interpret(dims, act, out_act):
    rng = np.random.default_rng(len(dims))
    n = 301  # not a multiple of any row block
    x = rng.standard_normal((n, dims[0])).astype(np.float32)
    ws = [(0.1 * rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32)
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [(rng.choice([-1.0, 1.0], b) * rng.uniform(0.5, 1.5, b)).astype(np.float32) for b in dims[1:]]
    g = rng.standard_normal((n, dims[-1])).astype(np.float32)

    def f(x, ws, bs):
        return jfused_mlp(x, ws, bs, activation=act, out_activation=out_act, interpret=True)

    y, vjp = jax.vjp(f, jnp.asarray(x), [jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs])
    rdx, rdws, rdbs = vjp(jnp.asarray(g))

    params = [_t(a).requires_grad_(True) for a in (x, *ws, *bs)]
    L = len(ws)
    before = dict(tfm.LAUNCHES)
    out = tfm.fused_mlp(params[0], params[1:1 + L], params[1 + L:], act, out_act)
    grads = torch.autograd.grad(out, params, grad_outputs=_t(g))
    assert tfm.LAUNCHES == before, "the CPU path launches no kernel"
    assert out.shape == y.shape
    for got, ref in zip(grads, [rdx, *rdws, *rdbs]):
        ref = np.asarray(ref)
        assert got.shape == ref.shape
        assert float(np.abs(got.numpy() - ref).max()) / (float(np.abs(ref).max()) + 1.0) <= 1e-5


def test_fused_mlp_bwd_plain_skips_dx():
    rng = np.random.default_rng(0)
    x, g = _t(rng.standard_normal((7, 5))), _t(rng.standard_normal((7, 2)))
    ws, bs = [_t(rng.standard_normal((5, 4))), _t(rng.standard_normal((4, 2)))], [_t(np.ones(4)), _t(np.ones(2))]
    dx, dws, dbs = tfm.fused_mlp_bwd_plain(x, ws, bs, g, "relu", "none", need_dx=False)
    assert dx is None and [d.shape for d in dws] == [(5, 4), (4, 2)] and [d.shape for d in dbs] == [(4,), (2,)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfm.fused_mlp_bwd(x, ws, bs, g)


# --- losses -----------------------------------------------------------------


def _bundle(R=16, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.5, 1.5, (R, 3)).astype(np.float32)
    d = rng.standard_normal((R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pa = np.full((R, 1), 1e-4, np.float32)
    nears, fars = np.full((R, 1), 0.8, np.float32), np.full((R, 1), 4.0, np.float32)
    jb = JRayBundle(jnp.asarray(o), jnp.asarray(d), jnp.asarray(pa), nears=jnp.asarray(nears),
                    fars=jnp.asarray(fars))
    tb = TRayBundle(_t(o), _t(d), _t(pa), nears=_t(nears), fars=_t(fars))
    return jb, tb


def _sample_sets(jb, tb, sizes, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        s = np.sort(rng.uniform(0.0, 1.0, (jb.origins.shape[0], n + 1)), -1).astype(np.float32)
        s[:, 0], s[:, -1] = 0.0, 1.0
        e = 0.8 + 3.2 * s
        out.append((jb.get_ray_samples(jnp.asarray(e), spacing_bins=jnp.asarray(s)),
                    tb.get_ray_samples(_t(e), spacing_bins=_t(s))))
    return out


def test_simple_losses_match_jax():
    rng = np.random.default_rng(2)
    a, b = rng.uniform(0, 1, (64, 3)).astype(np.float32), rng.uniform(0, 1, (64, 3)).astype(np.float32)
    grads = rng.standard_normal((8, 16, 3)).astype(np.float32)
    mask = (rng.uniform(0, 1, (64, 1)) > 0.5).astype(np.float32)
    pred = rng.uniform(0, 1, (64, 1)).astype(np.float32)
    pred[:3] = [[0.0], [1.0], [0.0005]]  # the clip at eps
    _close(tL.l1_loss(_t(a), _t(b)), jL.l1_loss(jnp.asarray(a), jnp.asarray(b)))
    _close(tL.eikonal_loss(_t(grads)), jL.eikonal_loss(jnp.asarray(grads)))
    _close(tL.binary_cross_entropy(_t(pred), _t(mask)),
           jL.binary_cross_entropy(jnp.asarray(pred), jnp.asarray(mask)))
    tg = _t(grads).requires_grad_(True)
    _close(torch.autograd.grad(tL.eikonal_loss(tg), tg)[0],
           jax.grad(jL.eikonal_loss)(jnp.asarray(grads)))


@pytest.mark.parametrize("r", [0.03, 0.003])
def test_blur_stepfun_matches_jax(r):
    rng = np.random.default_rng(3)
    x = np.sort(rng.uniform(0, 1, (12, 21)), -1).astype(np.float32)
    y = rng.exponential(1.0, (12, 20)).astype(np.float32)
    jx, jy = jL.blur_stepfun(jnp.asarray(x), jnp.asarray(y), r)
    tx, ty = tL.blur_stepfun(_t(x), _t(y), r)
    _close(tx, jx)
    _close(ty, jy, rtol=1e-5, atol=1e-4)  # a running sum of ~40 terms of size up to 1/(2r)


def test_interlevel_loss_zip_and_its_gradient_match_jax():
    jb, tb = _bundle()
    sets = _sample_sets(jb, tb, (24, 12, 8))
    rng = np.random.default_rng(4)
    ws = [rng.dirichlet(np.ones(n), 16).astype(np.float32) * 0.9 for n in (24, 12, 8)]
    for (js, ts) in sets:
        _close(tL.ray_samples_to_sdist(ts), jL.ray_samples_to_sdist(js))

    def jloss(w0, w1):
        return jL.interlevel_loss_zip([w0, w1, jnp.asarray(ws[2])], [s[0] for s in sets])

    ref, (g0, g1) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(jnp.asarray(ws[0]),
                                                                        jnp.asarray(ws[1]))
    tw = [_t(w).requires_grad_(True) for w in ws]
    out = tL.interlevel_loss_zip(tw, [s[1] for s in sets])
    t0, t1, t2 = torch.autograd.grad(out, tw, allow_unused=True)
    _close(out.detach(), ref)
    assert float(ref) > 1e-4  # the bound is violated somewhere: the loss is not trivially 0
    for got, ref in ((t0, g0), (t1, g1)):
        ref = np.asarray(ref)
        assert float(np.abs(got.numpy() - ref).max()) <= 2e-3 * float(np.abs(ref).max())
    assert t2 is None  # the final weights are stopped


# --- jittered samplers -------------------------------------------------------


def _given(u):
    """A port rng that hands out the uniforms JAX drew."""
    def rng(shape):
        assert tuple(shape) == u.shape
        return _t(u)

    return rng


@pytest.mark.parametrize("single_jitter", [True, False])
def test_jittered_spaced_sampler_matches_jax(single_jitter):
    jb, tb = _bundle(seed=5)
    key = jax.random.PRNGKey(7)
    shape = (16, 1) if single_jitter else (16, 33)
    u = np.asarray(jax.random.uniform(key, shape))
    js = jspaced.uniform_lindisp_piecewise_sampler(jb, 32, rng=key, single_jitter=single_jitter)
    ts = tspaced.uniform_lindisp_piecewise_sampler(tb, 32, rng=_given(u), single_jitter=single_jitter)
    for k in ("starts", "ends", "spacing_starts", "spacing_ends"):
        _close(getattr(ts, k), getattr(js, k))
    gen = torch.Generator().manual_seed(0)
    g1 = tspaced.uniform_lindisp_piecewise_sampler(tb, 32, rng=gen, single_jitter=single_jitter)
    assert not torch.equal(g1.spacing_starts, tspaced.uniform_lindisp_piecewise_sampler(tb, 32).spacing_starts)


@pytest.mark.parametrize("single_jitter", [True, False])
def test_jittered_pdf_sampler_matches_jax(single_jitter):
    jb, tb = _bundle(seed=6)
    (js, ts), = _sample_sets(jb, tb, (32,), seed=8)
    w = np.random.default_rng(9).exponential(1.0, (16, 32)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    u = np.asarray(jax.random.uniform(key, (16, 1) if single_jitter else (16, 17)))
    jr = jpdf.pdf_sampler(jb, js, jnp.asarray(w), 16, rng=key, single_jitter=single_jitter,
                          include_original=False)
    tr = tpdf.pdf_sampler(tb, ts, _t(w), 16, rng=_given(u), single_jitter=single_jitter,
                          include_original=False)
    for k in ("starts", "ends", "spacing_starts", "spacing_ends"):
        _close(getattr(tr, k), getattr(jr, k))


# --- small models of both methods (tests/test_torch_model.py's sizes) --------


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
    kw = dict(near=0.8, far=4.0, radius=1.0, collider_type="near_far")
    jmodel = jget_method_config(method).model_class(jcfg, JSceneBox(**kw), NUM_IMAGES)
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
    tmodel = build_model(MethodConfig(f"small-{method}", TNeuSFactoModel, tcfg), TSceneBox(**kw),
                         NUM_IMAGES, device="cpu")
    params_from_jax(tmodel, np_params)
    return jmodel, jax.tree_util.tree_map(jnp.asarray, np_params), np_params, tmodel, method


@pytest.fixture(scope="module", params=METHODS)
def models(request):
    return _small_models(request.param)


def _rays(R=48, seed=1):
    rng = np.random.default_rng(seed)
    o = rng.standard_normal((R, 3))
    o = (2.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)).astype(np.float32)
    d = rng.uniform(-0.6, 0.6, (R, 3)) - o
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


def test_schedules_match_jax(models):
    jmodel, _, _, tmodel, _ = models
    for step in [0, 5, 9, 10, 11, 12, 13, 500, 999, 1000, 1001, 2500, 2501, 2502, 4000, 4003, 5000, 5005, 20000]:
        js, ts = jmodel.schedules(jnp.asarray(float(step), jnp.float32)), tmodel.schedules(step)
        assert bool(js["train_proposal"]) == ts["train_proposal"], step
        for k in ("proposal_anneal", "cos_anneal_ratio"):
            _close(ts[k], js[k], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("train_proposal", [True, False])
def test_proposal_gate_gradients_match_jax(models, train_proposal):
    """The proposal nets' gradient through the sampler and the interlevel
    loss: the same on an update step, zero (None in the port) on a frozen one."""
    jmodel, jparams, _, tmodel, _ = models
    jb, tb = _bundle(R=24, seed=10)
    w_final = np.random.default_rng(11).dirichlet(np.ones(8), 24).astype(np.float32)

    def jloss(pp):
        fns = [net.density_fn(pp[str(i)]) for i, net in enumerate(jmodel.proposal_networks)]
        rs, ws, lst = jprop.proposal_network_sampler(
            jb, fns, rng=None, num_proposal_samples_per_ray=(16, 8), num_nerf_samples_per_ray=8,
            num_proposal_network_iterations=2, single_jitter=True, anneal=1.0,
            train_proposal=train_proposal, grad_gate="where")
        return jL.interlevel_loss_zip(list(ws) + [jnp.asarray(w_final)], list(lst) + [rs])

    ref, jg = jax.jit(jax.value_and_grad(jloss))(jparams["proposal_networks"])
    rs, ws, lst = tprop.proposal_network_sampler(
        tb, list(tmodel.proposal_networks), rng=None, num_proposal_samples_per_ray=(16, 8),
        num_nerf_samples_per_ray=8, num_proposal_network_iterations=2, single_jitter=True,
        anneal=1.0, train_proposal=train_proposal)
    out = tL.interlevel_loss_zip(list(ws) + [_t(w_final)], list(lst) + [rs])
    _close(out.detach(), ref)
    names = [n for n, _ in tmodel.proposal_networks.named_parameters()]
    params = list(tmodel.proposal_networks.parameters())
    grads = torch.autograd.grad(out, params, allow_unused=True) if out.requires_grad else [None] * len(params)
    ref_g = _port_tree(jg)
    for n, g in zip(names, grads):
        if train_proposal:
            assert float(np.abs(ref_g[n]).max()) > 0
            _close(g, ref_g[n], rtol=1e-4, atol=1e-6)
        else:
            assert g is None and not np.any(ref_g[n])


@pytest.mark.parametrize("step", [20, 1001])
def test_train_step_loss_and_grads_match_jax(models, step):
    """One step's losses and the gradient of every parameter group (the
    grid table included) against ``jax.value_and_grad`` of
    ``get_outputs(train=True)`` + ``get_loss_dict``, with no jitter."""
    jmodel, jparams, _, tmodel, method = models
    jb, tb, batch = _rays()
    jsched = jmodel.schedules(jnp.asarray(float(step), jnp.float32))
    tsched = tmodel.schedules(step)
    assert tsched["train_proposal"] == (step % 2 == 0)

    @jax.jit
    def jloss(params):
        out = jmodel.get_outputs(params, jb, rng=None, sched=jsched, train=True)
        ld = jmodel.get_loss_dict(params, out, {k: jnp.asarray(v) for k, v in batch.items()}, jsched, None)
        return sum(ld.values()), ld

    (ref_total, ref_ld), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
    opts = build_optimizers(get_method_config(method).optimizers, tmodel)
    total, ld, metrics = loss_and_metrics(tmodel, tb, {k: _t(v) for k, v in batch.items()}, tsched)
    assert sorted(ld) == sorted(ref_ld) == ["eikonal_loss", "fg_mask_loss", "interlevel_loss", "rgb_loss"]
    for k in ld:
        _close(ld[k].detach(), ref_ld[k], rtol=1e-4, atol=0)
    _close(total.detach(), ref_total, rtol=1e-4, atol=0)
    assert set(metrics) == {"psnr", "s_val", "inv_s"}
    grads = group_grads(total, opts)
    ref_g = _port_tree({"field": jg["field"], "proposal_networks": jg["proposal_networks"]})
    seen = 0
    for group, opt in opts.items():
        for name, g in zip(opt.names, grads[group]):
            ref = ref_g[name]
            if g is None:  # no part in the loss: JAX's gradient is exactly zero
                assert not np.any(ref), name
                continue
            scale = float(np.abs(ref).max())
            assert scale > 0, name
            assert float(np.abs(g.numpy() - ref).max()) <= 5e-4 * scale, name
            seen += 1
    assert seen >= 20
    assert (grads[PROPOSAL_GROUP][0] is None) == (step % 2 == 1)
    assert "field.encoding.hash_table" in opts["field"].names


def test_adam_and_schedules_match_optax_over_a_frozen_step(models):
    """Three optax steps, then the state carried over by ``opt_state_from_jax``
    and five more on both sides (steps 10-14, frozen at 11 and 13), on the
    same random gradients. The port side is the trainer's own update,
    ``apply_grads``; the JAX side is ``_train_step_impl``'s update
    (trainer.py:405-418). On a frozen step the proposal nets' gradient is
    zero in JAX (the gate stops it) and None in the port (no graph reaches
    them)."""
    jmodel, jparams, _, tmodel, method = models
    groups = jget_method_config(method).optimizers
    tx = jbuild_optimizer(groups, jparams)
    rng = np.random.default_rng(12)

    def rand_grads():
        return jax.tree_util.tree_map(lambda p: rng.standard_normal(p.shape).astype(np.float32), jparams)

    update = jax.jit(tx.update)

    def jstep(params, state, grads, step):
        updates, state = update(jax.tree_util.tree_map(jnp.asarray, grads), state, params)
        tp = jmodel.schedules(jnp.asarray(float(step)))["train_proposal"]
        updates = dict(updates)
        updates["proposal_networks"] = jax.tree_util.tree_map(
            lambda u: jnp.where(tp, u, jnp.zeros_like(u)), updates["proposal_networks"])
        return optax.apply_updates(params, updates), state

    params, state = jparams, tx.init(jparams)
    for step in range(7, 10):
        params, state = jstep(params, state, rand_grads(), step)
    params_from_jax(tmodel, jax.tree_util.tree_map(np.asarray, params))
    opts = build_optimizers(get_method_config(method).optimizers, tmodel)
    opt_state_from_jax(opts, state)
    assert all(o.count == 3 for o in opts.values())
    named = dict(tmodel.named_parameters())
    for step in range(10, 15):
        grads = rand_grads()
        sched = tmodel.schedules(step)
        frozen = not sched["train_proposal"]
        if frozen:
            grads["proposal_networks"] = jax.tree_util.tree_map(np.zeros_like, grads["proposal_networks"])
        flat = _port_tree({"field": grads["field"], "proposal_networks": grads["proposal_networks"]})
        tgrads = {g: [None if frozen and g == PROPOSAL_GROUP else _t(flat[n]) for n in opt.names]
                  for g, opt in opts.items()}
        before = [p.detach().clone() for p in opts[PROPOSAL_GROUP].params]
        apply_grads(opts, tgrads, sched)
        params, state = jstep(params, state, grads, step)
        after = opts[PROPOSAL_GROUP].params
        assert all(torch.equal(a, b) for a, b in zip(before, after)) == frozen
        ref = _port_tree({"field": params["field"], "proposal_networks": params["proposal_networks"]})
        for n, p in named.items():
            _close(p.detach(), ref[n], rtol=1e-6, atol=1e-8)
    for group, opt in opts.items():
        adam = state.inner_states[group].inner_state[0]
        assert opt.count == int(adam.count) == 8
        mu, nu = _port_tree(adam.mu[group], group + "."), _port_tree(adam.nu[group], group + ".")
        for n, m, v in zip(opt.names, opt.mu, opt.nu):
            _close(m, mu[n], rtol=1e-6, atol=1e-9)
            _close(v, nu[n], rtol=1e-6, atol=1e-12)
    lrs = {g: o.lr_at(c) for g, o in opts.items() for c in [0]}
    assert lrs == {"field": 0.0, "proposal_networks": 1e-2}  # neus warmup starts at 0
