"""The port's ops against the JAX package, on the same numpy inputs.

Covers ``ops/encodings.py::NeRFEncoding``, ``ops/permuto.py::PermutoEncoding``
(feature and analytic jacobian), the fused-MLP wrapper and its plain
version against JAX ``fused_mlp(..., interpret=True)`` and the unfused JAX
``MLP``, the density / render math, contraction, colliders and
``searchsorted_right``.

Tolerances: plain f32 elementwise math and short reductions agree to ~1e-6,
so they are held to 1e-5 (atol and rtol). The MLP chains sum up to a few
hundred products per output in an order that differs between XLA and
PyTorch: 1e-5 relative to the output scale. The permutohedral jacobian
scales the lattice residuals by the level resolution (up to 512 here), which
multiplies f32 rounding of the elevated coordinates: 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdfstudio_tpu.components import colliders as jcol
from sdfstudio_tpu.core import math as jmath
from sdfstudio_tpu.core.rays import RayBundle as JRayBundle
from sdfstudio_tpu.core.scene_box import SceneBox as JSceneBox
from sdfstudio_tpu.ops import contraction as jcontract
from sdfstudio_tpu.ops import density as jdens
from sdfstudio_tpu.ops import render as jrender
from sdfstudio_tpu.ops.encodings import NeRFEncoding as JNeRFEncoding
from sdfstudio_tpu.ops.mlp import MLP as JMLP
from sdfstudio_tpu.ops.pallas_mlp import fused_mlp as jfused_mlp
from sdfstudio_tpu.ops.permuto import PermutoEncoding as JPermuto

from sdfstudio_tpu_torch.components import colliders as tcol
from sdfstudio_tpu_torch.core import math as tmath
from sdfstudio_tpu_torch.core.rays import RayBundle as TRayBundle
from sdfstudio_tpu_torch.core.scene_box import SceneBox as TSceneBox
from sdfstudio_tpu_torch.ops import contraction as tcontract
from sdfstudio_tpu_torch.ops import density as tdens
from sdfstudio_tpu_torch.ops import fused_mlp as tfm
from sdfstudio_tpu_torch.ops import render as trender
from sdfstudio_tpu_torch.ops.encodings import NeRFEncoding as TNeRFEncoding
from sdfstudio_tpu_torch.ops.mlp import MLP as TMLP
from sdfstudio_tpu_torch.ops.permuto import PermutoEncoding as TPermuto

F32 = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), **(tol or F32))


# --- encodings --------------------------------------------------------------


@pytest.mark.parametrize(
    "nf,max_exp,include_input", [(6, 5.0, False), (4, 3.0, True), (6, 5.0, True), (8, 7.0, True)]
)
def test_nerf_encoding_matches_jax(nf, max_exp, include_input):
    """The SDF position (6, no input), direction (4, input) and proposal
    (6 and 8, input) encodings of the p8 path."""
    x = np.random.default_rng(0).uniform(-1.5, 1.5, (97, 3)).astype(np.float32)
    ref = JNeRFEncoding(3, nf, 0.0, max_exp, include_input).apply({}, jnp.asarray(x))
    enc = TNeRFEncoding(3, nf, 0.0, max_exp, include_input)
    out = enc(_t(x))
    assert out.shape[-1] == enc.out_dim == ref.shape[-1]
    # sin of arguments up to 2^7 * 1.5 rad: f32 argument reduction differs by ulps
    _close(out, ref, rtol=1e-5, atol=2e-5)


def _permuto_pair(levels=2, feats=2, max_res=512, log2=12, seed=0):
    jenc = JPermuto(num_levels=levels, min_res=16, max_res=max_res,
                    log2_hashmap_size=log2, features_per_level=feats)
    tenc = TPermuto(num_levels=levels, min_res=16, max_res=max_res,
                    log2_hashmap_size=log2, features_per_level=feats)
    table = np.random.default_rng(seed).uniform(-1, 1, (tenc.total_rows, feats)).astype(np.float32)
    assert tenc.total_rows == jenc.total_rows
    with torch.no_grad():
        tenc.hash_table.copy_(_t(table))
    return jenc, {"params": {"hash_table": jnp.asarray(table)}}, tenc


@pytest.mark.parametrize("levels,feats,max_res", [(2, 2, 512), (8, 4, 512)])
def test_permuto_corner_data_matches_jax(levels, feats, max_res):
    jenc, _, tenc = _permuto_pair(levels, feats, max_res)
    x = np.random.default_rng(1).uniform(0, 1, (211, 3)).astype(np.float32)
    jidx, jw, jdw = jenc.corner_data(jnp.asarray(x))
    tidx, tw, tdw = tenc.corner_data(_t(x))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    _close(tw, jw)
    _close(tdw, jdw, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("levels,feats", [(2, 2), (8, 4)])
def test_permuto_feature_and_jacobian_match_jax(levels, feats):
    jenc, jparams, tenc = _permuto_pair(levels, feats)
    x = np.random.default_rng(2).uniform(0, 1, (257, 3)).astype(np.float32)
    jout, jjac = jenc.apply(jparams, jnp.asarray(x), want_jac=True)
    with torch.no_grad():
        tout, tjac = tenc(_t(x), want_jac=True)
    assert tout.shape == (257, levels * feats) and tjac.shape == (257, levels * feats, 3)
    _close(tout, jout)
    _close(tjac, jjac, rtol=1e-4, atol=1e-4)


def test_permuto_hash_wraps_like_uint32():
    """Negative lattice coordinates and large primes: the int64 split
    multiply must wrap exactly as JAX's uint32 arithmetic."""
    jenc, _, tenc = _permuto_pair(2, 2, log2=19)
    x = np.random.default_rng(3).uniform(-40, 40, (64, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tenc.corner_data(_t(x))[0].numpy(), np.asarray(jenc.corner_data(jnp.asarray(x))[0])
    )


# --- fused MLP ---------------------------------------------------------------


def _mlp_case(dims, seed=0, n=133):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, dims[0])).astype(np.float32)
    ws = [(rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32)
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [(0.1 * rng.standard_normal(b)).astype(np.float32) for b in dims[1:]]
    return x, ws, bs


@pytest.mark.parametrize(
    "dims,act,out_act",
    [
        ([39, 128, 128, 1], "relu", "none"),  # proposal 0
        ([51, 128, 128, 1], "relu", "none"),  # proposal 1
        ([97, 32, 32, 3], "relu", "none"),  # small color net
        ([19, 64, 5], "softplus100", "relu"),
        ([7, 9], "none", "softplus100"),
    ],
)
def test_fused_mlp_plain_matches_jax_pallas_interpret(dims, act, out_act):
    x, ws, bs = _mlp_case(dims)
    ref = jfused_mlp(jnp.asarray(x), [jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs],
                     activation=act, out_activation=out_act, interpret=True)
    out = tfm.fused_mlp(_t(x), [_t(w) for w in ws], [_t(b) for b in bs], act, out_act)
    scale = float(np.abs(np.asarray(ref)).max()) + 1.0
    assert float(np.abs(out.numpy() - np.asarray(ref)).max()) / scale <= 1e-5


def test_fused_mlp_matches_jax_unfused_mlp():
    """The port's MLP module (through fused_mlp) against the JAX unfused MLP
    on the same parameter tree."""
    x = np.random.default_rng(4).standard_normal((50, 39)).astype(np.float32)
    jm = JMLP(num_layers=3, layer_width=128, out_dim=1, fused=False)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = jm.apply(params, jnp.asarray(x))
    tm = TMLP(39, num_layers=3, layer_width=128, out_dim=1)
    with torch.no_grad():
        for j, layer in enumerate(tm.layers):
            layer.kernel.copy_(_t(params["params"][f"layer_{j}"]["kernel"]))
            layer.bias.copy_(_t(params["params"][f"layer_{j}"]["bias"]))
        out = tm(_t(x))
    scale = float(np.abs(np.asarray(ref)).max()) + 1.0
    assert float(np.abs(out.numpy() - np.asarray(ref)).max()) / scale <= 1e-5


def test_fused_mlp_wrapper_contract():
    x, ws, bs = _mlp_case([8, 16, 2], n=5)
    tx, tws, tbs = _t(x), [_t(w) for w in ws], [_t(b) for b in bs]
    before = dict(tfm.LAUNCHES)
    out = tfm.fused_mlp(tx, tws, tbs)
    assert tfm.LAUNCHES == before, "the CPU path launches no kernel and counts nothing"
    torch.testing.assert_close(out, tfm.fused_mlp_plain(tx, tws, tbs), rtol=0, atol=0)
    with pytest.raises(ValueError, match="activation"):
        tfm.fused_mlp(tx, tws, tbs, activation="gelu")
    with pytest.raises(ValueError, match="does not take width"):
        tfm.fused_mlp(tx[:, :7], tws, tbs)
    with pytest.raises(ValueError, match="bias"):
        tfm.fused_mlp(tx, tws, [tbs[0][:3], tbs[1]])
    # under autograd the CPU path backpropagates through fused_mlp_bwd_plain
    # and still launches and counts nothing
    xg = tx.clone().requires_grad_(True)
    (gx,) = torch.autograd.grad(tfm.fused_mlp(xg, tws, tbs).sum(), xg)
    assert gx.shape == tx.shape and tfm.LAUNCHES == before
    with pytest.raises(ValueError, match="unsupported device"):
        tfm.fused_mlp(tx.to("meta"), [w.to("meta") for w in tws], [b.to("meta") for b in tbs])


def test_cuda_build_is_lazy_and_needs_nvcc(monkeypatch):
    from sdfstudio_tpu_torch.utils import cuda_build

    assert cuda_build._lib is None or torch.cuda.is_available()
    h = cuda_build.sources_hash()
    assert h == cuda_build.sources_hash() and len(h) == 64
    assert [p.name for p in cuda_build._sources()] == ["fused_mlp_bwd.cu", "fused_mlp_fwd.cu",
                                                       "hash_grid.cu", "row_gather.cu",
                                                       "fused_mlp_chain.cuh", "tf32_mma.cuh"]
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr(cuda_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build(force=True)


# --- density, render, contraction, colliders ---------------------------------


def test_density_math_matches_jax():
    rng = np.random.default_rng(5)
    R, S = 16, 12
    sdf = rng.uniform(-0.3, 0.3, (R, S)).astype(np.float32)
    grads = rng.standard_normal((R, S, 3)).astype(np.float32)
    dirs = rng.standard_normal((R, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    deltas = rng.uniform(0.001, 0.05, (R, S)).astype(np.float32)
    for ratio in (0.4, 1.0):
        ref = jdens.neus_alpha(jnp.asarray(sdf), jnp.asarray(grads), jnp.asarray(dirs),
                               jnp.asarray(deltas), jnp.asarray(20.0), jnp.asarray(ratio))
        out = tdens.neus_alpha(_t(sdf), _t(grads), _t(dirs), _t(deltas), torch.tensor(20.0), ratio)
        _close(out, ref)
    _close(tdens.variance_inv_s(torch.tensor([0.3])), jdens.variance_inv_s(jnp.asarray([0.3])))
    _close(tdens.laplace_density(_t(sdf), torch.tensor(0.1)),
           jdens.laplace_density(jnp.asarray(sdf), jnp.asarray(0.1)))
    _close(tdens.trunc_exp(_t(sdf * 10)), jdens.trunc_exp(jnp.asarray(sdf * 10)))


def test_render_math_matches_jax():
    rng = np.random.default_rng(6)
    R, S = 9, 17
    alphas = rng.uniform(0, 0.6, (R, S)).astype(np.float32)
    dens = rng.uniform(0, 5, (R, S)).astype(np.float32)
    starts = np.sort(rng.uniform(0.5, 4, (R, S)), -1).astype(np.float32)
    ends = starts + rng.uniform(0.01, 0.1, (R, S)).astype(np.float32)
    rgb = rng.uniform(0, 1, (R, S, 3)).astype(np.float32)
    jw, jt = jrender.weights_and_transmittance_from_alphas(jnp.asarray(alphas))
    tw, tt = trender.weights_and_transmittance_from_alphas(_t(alphas))
    _close(tw, jw)
    _close(tt, jt)
    _close(trender.weights_from_densities(_t(ends - starts), _t(dens)),
           jrender.weights_from_densities(jnp.asarray(ends - starts), jnp.asarray(dens)))
    for bg in ("black", "white"):
        _close(trender.render_rgb(_t(rgb), tw, bg), jrender.render_rgb(jnp.asarray(rgb), jw, bg))
    _close(trender.render_accumulation(tw), jrender.render_accumulation(jw))
    _close(trender.render_depth_expected(tw, _t(starts), _t(ends)),
           jrender.render_depth_expected(jw, jnp.asarray(starts), jnp.asarray(ends)))
    _close(trender.render_semantics(_t(rgb), tw), jrender.render_semantics(jnp.asarray(rgb), jw))
    with pytest.raises(ValueError, match="values must be"):
        trender.render_rgb(_t(rgb[:, :1]), tw)


@pytest.mark.parametrize("order", [None, np.inf])
def test_contraction_matches_jax(order):
    x = np.random.default_rng(7).uniform(-3, 3, (300, 3)).astype(np.float32)
    _close(tcontract.contract(_t(x), order=order), jcontract.contract(jnp.asarray(x), order=order))


def _bundles(R=32, seed=8):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2.5, 2.5, (R, 3)).astype(np.float32)
    d = rng.standard_normal((R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pa = np.full((R, 1), 1e-4, np.float32)
    return (JRayBundle(jnp.asarray(o), jnp.asarray(d), jnp.asarray(pa)),
            TRayBundle(_t(o), _t(d), _t(pa)))


@pytest.mark.parametrize("kind", ["near_far", "box", "sphere"])
def test_colliders_match_jax(kind):
    jb, tb = _bundles()
    jsb = JSceneBox(near=0.8, far=4.0, radius=1.0, collider_type=kind)
    tsb = TSceneBox(near=0.8, far=4.0, radius=1.0, collider_type=kind)
    for soft in (False, True):
        jr = jcol.apply_collider(jb, jsb, kind, 0.8, 4.0, 1.0, soft, training=False)
        tr = tcol.apply_collider(tb, tsb, kind, 0.8, 4.0, 1.0, soft, training=False)
        _close(tr.nears, jr.nears)
        _close(tr.fars, jr.fars)


def test_searchsorted_right_matches_jax_with_ties():
    rng = np.random.default_rng(9)
    a = np.sort(rng.integers(0, 20, (11, 33)).astype(np.float32) / 20, -1)
    v = rng.integers(0, 21, (11, 17)).astype(np.float32) / 20  # many exact ties
    np.testing.assert_array_equal(
        tmath.searchsorted_right(_t(a), _t(v)).numpy(),
        np.asarray(jmath.searchsorted_right(jnp.asarray(a), jnp.asarray(v))),
    )
    x = rng.standard_normal((40, 3)).astype(np.float32)
    x[0] = 0.0
    _close(tmath.safe_normalize(_t(x)), jmath.safe_normalize(jnp.asarray(x)))
