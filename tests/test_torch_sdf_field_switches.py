"""The SDF field's ``use_grid_feature`` and ``use_appearance_embedding``
switches against the JAX package.

JAX's default ``SDFFieldConfig`` has the grid feature off
(``sdfstudio_tpu/fields/sdf_field.py:78``): its geometry MLP takes zeros in
place of the encode and its jacobian (``_grid_feature``, :287-289), and its
parameter tree has no grid table. The port's default field is held to
JAX's at the default sizes (an 8-layer geometry MLP with the skip at layer
4, a 4-layer color net), its parameters taken from JAX's init and
perturbed from a numpy seed, on the same ray samples: the geometry output
(sdf and features), the SDF gradient and the field outputs.

Tolerances, as ``tests/test_torch_model.py`` holds the field: f32 MLP
chains 1e-5; the gradient, one reverse pass through the 8 layers, 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdfstudio_tpu.core.rays import RayBundle as JRayBundle
from sdfstudio_tpu.fields.sdf_field import SDFField as JSDFField
from sdfstudio_tpu.fields.sdf_field import SDFFieldConfig as JSDFFieldConfig
from sdfstudio_tpu.fields.sdf_field import SDFFieldNet as JSDFFieldNet

from sdfstudio_tpu_torch.core.rays import RayBundle as TRayBundle
from sdfstudio_tpu_torch.fields.sdf_field import SDFField, SDFFieldConfig
from sdfstudio_tpu_torch.utils.convert import params_from_jax

NUM_IMAGES = 3


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.fixture(scope="module")
def default_fields():
    """JAX's and the port's fields of the default config, the same parameters."""
    jfield = JSDFField(config=JSDFFieldConfig(), num_images=NUM_IMAGES, spatial_distortion="inf")
    params = jfield.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def perturb(path, a):
        a = np.asarray(a)
        name = jax.tree_util.keystr(path)
        if "deviation" in name or "laplace_beta" in name:
            return a
        return (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32)

    np_params = jax.tree_util.tree_map_with_path(perturb, params)
    tfield = SDFField(SDFFieldConfig(), num_images=NUM_IMAGES, spatial_distortion="inf")
    params_from_jax(tfield, np_params)
    return jfield, jax.tree_util.tree_map(jnp.asarray, np_params), tfield


def _points(n=200, seed=1):
    return np.random.default_rng(seed).uniform(-1.9, 1.9, (n, 3)).astype(np.float32)


def test_default_field_has_no_grid_table():
    """JAX's default tree holds no ``encoding``; neither does the port's field."""
    jfield = JSDFField(config=JSDFFieldConfig(), num_images=NUM_IMAGES)
    shapes = jax.eval_shape(jfield.init, jax.random.PRNGKey(0))
    assert "encoding" not in shapes
    tfield = SDFField(SDFFieldConfig(), num_images=NUM_IMAGES)
    assert tfield.encoding is None and tfield.grid_dim == 32
    assert sorted(n.split(".")[0] for n, _ in tfield.named_parameters()) == sorted(
        k for k in shapes for _ in jax.tree_util.tree_leaves(shapes[k]))


def test_default_field_geometry_and_gradient_match_jax(default_fields):
    """sdf and geometry features, and d sdf/dx, of the default field (grid
    feature off) against JAX's ``geonetwork_with_gradient``."""
    jfield, jparams, tfield = default_fields
    x = _points()
    ref_h, ref_g = jax.jit(lambda p, x: jfield.module.apply(
        {"params": p}, x, method=JSDFFieldNet.geonetwork_with_gradient))(jparams, jnp.asarray(x))
    h, g = tfield.geonetwork_with_gradient(_t(x))
    assert h.shape == (200, 257) and g.shape == (200, 3)
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(ref_g), rtol=1e-4, atol=1e-4)
    assert float(np.abs(np.asarray(ref_g)).max()) > 0.1  # the gradient is not trivial
    with torch.no_grad():
        np.testing.assert_allclose(tfield.sdf(_t(x)).numpy(), np.asarray(ref_h)[:, 0],
                                   rtol=1e-5, atol=1e-5)


def test_default_field_outputs_match_jax(default_fields):
    """The field outputs over ray samples (sdf, rgb, density, gradient,
    normal, alpha) of the default field against JAX's."""
    jfield, jparams, tfield = default_fields
    rng = np.random.default_rng(2)
    R = 16
    o = rng.standard_normal((R, 3))
    o = (2.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)).astype(np.float32)
    d = rng.uniform(-0.6, 0.6, (R, 3)) - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    pa = np.full((R, 1), 1e-5, np.float32)
    ci = np.zeros((R,), np.int32)
    jb = JRayBundle(jnp.asarray(o), jnp.asarray(d), jnp.asarray(pa), camera_indices=jnp.asarray(ci))
    tb = TRayBundle(_t(o), _t(d), _t(pa), camera_indices=torch.from_numpy(ci.astype(np.int64)))
    bins = np.sort(rng.uniform(0.8, 4.0, (R, 9)), -1).astype(np.float32)
    jrs, trs = jb.get_ray_samples(jnp.asarray(bins)), tb.get_ray_samples(_t(bins))
    ref = jax.jit(lambda p, rs: jfield.get_outputs(p, rs, cos_anneal_ratio=0.4, return_alphas=True,
                                                   train=False))(jparams, jrs)
    with torch.no_grad():
        out = tfield.get_outputs(trs, cos_anneal_ratio=0.4, return_alphas=True)
    for k in ("sdf", "rgb", "density", "points_norm"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-5, atol=1e-5)
    for k in ("gradient", "normal", "alpha"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-4, atol=1e-4)


def test_default_field_trains_through_the_zero_feature(default_fields):
    """In training (``create_graph``) the gradient equals the eval one, and
    the eikonal term reaches the geometry MLP's first layer."""
    _, _, tfield = default_fields
    x = _t(_points(50, seed=3))
    _, g_eval = tfield.geonetwork_with_gradient(x)
    h, g = tfield.geonetwork_with_gradient(x, train=True)
    torch.testing.assert_close(g.detach(), g_eval, rtol=1e-6, atol=1e-6)
    ((g.norm(dim=-1) - 1.0) ** 2).mean().backward()
    assert float(tfield.glayer(0).kernel.grad.abs().max()) > 0.0


def test_appearance_embedding_raises():
    with pytest.raises(NotImplementedError, match="use_appearance_embedding"):
        SDFField(dataclasses.replace(SDFFieldConfig(), use_appearance_embedding=True))
