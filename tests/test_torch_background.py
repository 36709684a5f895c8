"""The port's skip MLP, the NeRF background field, the spaced samplers the
background uses and the background merge against the JAX package, on the
same numpy inputs and JAX-initialised parameters carried across by
``params_from_jax``.

Tolerances, with their reasons:
- MLPs and the NeRF field: 1e-5 (atol and rtol). Both sides are f32 chains
  of a few products; XLA and PyTorch sum each product's terms in other
  orders, which moves outputs of order 1 by a few 1e-7.
- spaced samplers: 1e-5, as the eval-mode sampler tests
  (tests/test_torch_samplers.py); disparity spacing divides by distances up
  to 1000 and back.
- the background merge: 1e-5 on alpha and rgb, which are the NeRF field's
  outputs and the foreground's blended by an exact 0/1 mask.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdfstudio_tpu.core.rays import RayBundle as JRayBundle
from sdfstudio_tpu.core.scene_box import SceneBox as JSceneBox
from sdfstudio_tpu.fields.sdf_field import SDFFieldConfig as JSDFFieldConfig
from sdfstudio_tpu.fields.vanilla_nerf_field import NeRFField as JNeRFField
from sdfstudio_tpu.models.neus import NeuSModel as JNeuSModel
from sdfstudio_tpu.models.neus import NeuSModelConfig as JNeuSModelConfig
from sdfstudio_tpu.ops.mlp import MLP as JMLP
from sdfstudio_tpu.samplers import spaced as jspaced

from sdfstudio_tpu_torch.core.rays import RayBundle as TRayBundle
from sdfstudio_tpu_torch.core.scene_box import SceneBox as TSceneBox
from sdfstudio_tpu_torch.fields.sdf_field import SDFFieldConfig as TSDFFieldConfig
from sdfstudio_tpu_torch.fields.vanilla_nerf_field import NeRFField as TNeRFField
from sdfstudio_tpu_torch.models.neus import NeuSModel as TNeuSModel
from sdfstudio_tpu_torch.models.neus import NeuSModelConfig as TNeuSModelConfig
from sdfstudio_tpu_torch.ops import fused_mlp as tfm
from sdfstudio_tpu_torch.ops import mlp as tmlp
from sdfstudio_tpu_torch.ops.mlp import MLP as TMLP
from sdfstudio_tpu_torch.samplers import spaced as tspaced
from sdfstudio_tpu_torch.utils.convert import params_from_jax
from tests.test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

F32 = dict(rtol=1e-5, atol=1e-5)
ACTS = {"relu": jax.nn.relu, "none": None}


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port.detach() if torch.is_tensor(port) else port),
                               np.asarray(ref), **(tol or F32))


def _perturbed(params, seed):
    """JAX's initial parameters plus noise from a numpy seed, so that every
    bias and every input column matters."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a))).astype(np.float32), params)


@pytest.mark.parametrize(
    "num_layers,width,out_dim,skips,out_act",
    [
        (5, 32, 7, (2,), "relu"),  # one skip, a relu output
        (8, 24, None, (4,), "relu"),  # the NeRF base's shape, narrowed
        (6, 16, 3, (2, 4), "none"),  # two skips
        (3, 16, 3, (), "relu"),  # skip-free: the fused path (its plain version on the CPU)
    ],
)
def test_skip_mlp_matches_jax(num_layers, width, out_dim, skips, out_act, monkeypatch):
    rng = np.random.default_rng(num_layers)
    x = rng.standard_normal((37, 11)).astype(np.float32)
    jm = JMLP(num_layers=num_layers, layer_width=width, out_dim=out_dim, skip_connections=skips,
              out_activation=ACTS[out_act])
    params = _perturbed(jm.init(jax.random.PRNGKey(num_layers), jnp.asarray(x))["params"], 1)
    ref = jm.apply({"params": params}, jnp.asarray(x))
    tm = TMLP(11, num_layers, width, out_dim=out_dim, skip_connections=skips, out_activation=out_act)
    assert [f"layer_{i}" for i in range(num_layers)] == sorted(params, key=lambda k: int(k[6:]))
    assert {n for n, _ in tm.named_parameters()} == {
        f"layers.{i}.{leaf}" for i in range(num_layers) for leaf in ("kernel", "bias")}
    params_from_jax(tm, params)
    before = dict(tfm.LAUNCHES)
    _close(tm(_t(x)), ref)
    assert tfm.LAUNCHES == before  # the CPU runs the plain versions
    # an MLP with skips never reaches the fused kernel; a skip-free one does
    calls = []
    monkeypatch.setattr(tmlp, "fused_mlp", lambda *a: calls.append(1) or tfm.fused_mlp(*a))
    tm(_t(x))
    assert len(calls) == (0 if skips else 1)


def test_mlp_rejects_an_unknown_activation():
    with pytest.raises(ValueError, match="unsupported activation"):
        TMLP(3, 2, 4, activation="tanh")


@pytest.fixture(scope="module")
def nerf_fields():
    """JAX's ``NeRFField`` at full width (8 x 256 base with the skip at 4,
    [283 -> 128 -> 128] head) and the port's, same parameters."""
    jf = JNeRFField(spatial_distortion="inf")
    params = _perturbed(jf.init(jax.random.PRNGKey(3)), 4)
    tf = TNeRFField(spatial_distortion="inf")
    params_from_jax(tf, params)
    return jf, jax.tree_util.tree_map(jnp.asarray, params), tf


def test_nerf_field_density_and_rgb_match_jax(nerf_fields):
    jf, jparams, tf = nerf_fields
    rng = np.random.default_rng(5)
    pos = rng.uniform(-3.0, 3.0, (96, 3)).astype(np.float32)  # beyond the unit cube too
    dirs = rng.standard_normal((96, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    p = jf.contract_positions(jnp.asarray(pos))
    ref = jf.module.apply({"params": jparams}, p, jnp.asarray(dirs))
    out = tf(tf.contract_positions(_t(pos)), _t(dirs))
    for k in ("density", "rgb"):
        assert out[k].shape == ref[k].shape
        _close(out[k], ref[k])
    assert tf.mlp_head.layers[0].kernel.shape == (283, 128)
    assert float(np.asarray(ref["density"]).std()) > 1e-3  # not a constant field
    ref_d = jf.density_fn(jparams)(jnp.asarray(pos))
    _close(tf.density(tf.contract_positions(_t(pos)))[0], ref_d)


def _bundle(R=12, seed=0, far=None):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.5, 1.5, (R, 3)).astype(np.float32)
    d = rng.standard_normal((R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pa = np.full((R, 1), 1e-4, np.float32)
    nears = rng.uniform(0.5, 1.0, (R, 1)).astype(np.float32)
    fars = np.full((R, 1), far, np.float32) if far else rng.uniform(2.0, 4.0, (R, 1)).astype(np.float32)
    jb = JRayBundle(jnp.asarray(o), jnp.asarray(d), jnp.asarray(pa), nears=jnp.asarray(nears),
                    fars=jnp.asarray(fars))
    tb = TRayBundle(_t(o), _t(d), _t(pa), nears=_t(nears), fars=_t(fars))
    return jb, tb


@pytest.mark.parametrize("kind,far", [("uniform", None), ("linear_disparity", None),
                                      ("linear_disparity", 1000.0)])
def test_spaced_samplers_match_jax(kind, far):
    jb, tb = _bundle(far=far)
    js = getattr(jspaced, f"{kind}_sampler")(jb, 16)
    ts = getattr(tspaced, f"{kind}_sampler")(tb, 16)
    assert ts.spacing_kind == js.spacing_kind
    for k in ("starts", "ends", "spacing_starts", "spacing_ends"):
        _close(getattr(ts, k), getattr(js, k))
    _close(ts.get_positions(), js.get_positions(), rtol=1e-5, atol=1e-3 if far else 1e-5)


def test_background_merge_matches_jax(nerf_fields):
    """``forward_background_field_and_merge``: the foreground inside the
    unit sphere, the NeRF field's alpha and rgb outside it."""
    jf, jparams, tf = nerf_fields
    kw = dict(near=0.8, far=4.0, radius=1.0, collider_type="near_far")
    small = dict(num_layers=2, hidden_dim=16, geo_feat_dim=16, num_layers_color=2, hidden_dim_color=16)
    jmodel = JNeuSModel(JNeuSModelConfig(sdf_field=JSDFFieldConfig(**small)), JSceneBox(**kw), 1)
    tmodel = TNeuSModel(TNeuSModelConfig(sdf_field=TSDFFieldConfig(**small)), TSceneBox(**kw), 1)
    tmodel.field_background.load_state_dict(tf.state_dict())
    jb, tb = _bundle(R=10, seed=6)
    js, ts = jspaced.uniform_sampler(jb, 8), tspaced.uniform_sampler(tb, 8)
    rng = np.random.default_rng(7)
    fo = {"alpha": rng.uniform(0, 1, (10, 8)).astype(np.float32),
          "rgb": rng.uniform(0, 1, (10, 8, 3)).astype(np.float32)}
    inside = np.asarray(jmodel.get_foreground_mask(js))
    assert 0 < inside.sum() < inside.size  # samples on both sides of the sphere
    ref = jmodel.forward_background_field_and_merge(
        {"field_background": jparams}, js, {k: jnp.asarray(v) for k, v in fo.items()}, train=False)
    out = tmodel.forward_background_field_and_merge(ts, {k: _t(v) for k, v in fo.items()})
    _close(tmodel.get_foreground_mask(ts), inside, rtol=0, atol=0)
    for k in ("alpha", "rgb"):
        _close(out[k], ref[k])
