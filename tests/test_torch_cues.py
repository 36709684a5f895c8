"""The parts of the MonoSDF and Geo-NeuS methods in the port against the JAX
package, on the CPU: the losses, the patch warp, the SDFStudio parser's
options, the data managers and the DTU-like scene's generator.

The same inputs, made from a numpy seed, go through both packages.
Tolerances, with their reasons:

- losses in float32: values 1e-5 relative (sums in another order), their
  gradients 1e-5 of their scale;
- ``multi_view_loss`` picks the k smallest NCC scores with ``jax.lax.top_k``,
  which puts the lower index first on ties. Ties are common: every patch
  below ``min_patch_variance`` scores exactly 0. The tie case mixes valid
  and invalid zero-score sources, so that the pick decides which count;
- the patch warp's forward in float32: masks equal and patches to 1e-5,
  after each hard decision's margin (the crossing's SDF sign, ``|n.d| >
  0.1``, the view angle, ``z > 0.01``, the warped depth ``>= 0.2``, the
  image bounds) is checked clear of f32 rounding (1e-4), as
  ``tests/test_torch_surface_methods.py`` does for the samplers; its
  gradient in float64 (JAX under ``jax.enable_x64``), 1e-6 relative;
- the parser and the data managers: exact (the same numpy on the same
  bytes), the world normals to 1e-6.

JAX's warp gives a ray without an SDF crossing a NaN homography (a zero
normal, a plane through the camera). Jitted, as JAX trains, XLA turns the
product with the validity mask into a select, and that ray's patches and
gradients come out 0; run op by op, the NaN would reach every gradient.
The port gives that ray a finite plane (``components/patch_warping.py``),
and the cases hold it to JAX's jitted results on rays with and without a
crossing.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdfstudio_tpu.cameras.cameras import Cameras as JCameras
from sdfstudio_tpu.components import losses as JL
from sdfstudio_tpu.components import patch_warping as jpw
from sdfstudio_tpu.core.rays import RaySamples as JRaySamples
from sdfstudio_tpu.data import synthetic_dtu as jdtu
from sdfstudio_tpu.data.datamanager import DataManagerConfig as JDataManagerConfig
from sdfstudio_tpu.data.datamanager import FlexibleDataManager as JFlexibleDataManager
from sdfstudio_tpu.data.datamanager import VanillaDataManager as JVanillaDataManager
from sdfstudio_tpu.data.dataparsers.sdfstudio import SDFStudio as JSDFStudio
from sdfstudio_tpu.data.dataparsers.sdfstudio import SDFStudioDataParserConfig as JParserConfig
from sdfstudio_tpu.models.base_surface_model import SurfaceModel as JSurfaceModel
from sdfstudio_tpu.models.base_surface_model import SurfaceModelConfig as JSurfaceModelConfig

from sdfstudio_tpu_torch.cameras.cameras import Cameras as TCameras
from sdfstudio_tpu_torch.components import losses as TL
from sdfstudio_tpu_torch.components import patch_warping as tpw
from sdfstudio_tpu_torch.core.rays import RaySamples as TRaySamples
from sdfstudio_tpu_torch.data import png
from sdfstudio_tpu_torch.data import synthetic_dtu as tdtu
from sdfstudio_tpu_torch.data.datamanager import DataManagerConfig, FlexibleDataManager, VanillaDataManager
from sdfstudio_tpu_torch.data.dataparsers.sdfstudio import SDFStudioDataParserConfig, parse_config
from sdfstudio_tpu_torch.data.synthetic import generate_sphere_dataset
from sdfstudio_tpu_torch.models.base_surface_model import SurfaceModel as TSurfaceModel
from sdfstudio_tpu_torch.models.base_surface_model import SurfaceModelConfig as TSurfaceModelConfig
from tests.test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

F32 = dict(rtol=1e-5, atol=1e-6)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port.detach() if torch.is_tensor(port) else port),
                               np.asarray(ref), **(tol or F32))


def _grad_close(port, ref, rel):
    ref = np.asarray(ref)
    scale = float(np.abs(ref).max())
    assert scale > 0
    assert float(np.abs(port.detach().numpy() - ref).max()) <= rel * scale


# --- the losses ---------------------------------------------------------------


def test_mono_losses_and_their_gradients_match_jax():
    rng = np.random.default_rng(0)
    pred = rng.standard_normal((40, 3)).astype(np.float32)
    gt = rng.standard_normal((40, 3)).astype(np.float32)
    ref, jg = jax.jit(jax.value_and_grad(JL.monosdf_normal_loss))(jnp.asarray(pred), jnp.asarray(gt))
    tp = _t(pred).requires_grad_()
    out = TL.monosdf_normal_loss(tp, _t(gt))
    out.backward()
    _close(out, ref)
    _grad_close(tp.grad, jg, 1e-5)

    # three images: a full mask, a sparse one and an empty one (a singular system)
    p = rng.uniform(0.5, 2.0, (3, 8, 12)).astype(np.float32)
    t = (1.7 * p + 0.3 + 0.05 * rng.standard_normal(p.shape)).astype(np.float32)
    m = np.ones_like(p)
    m[1] = rng.uniform(size=p[1].shape) > 0.5
    m[2] = 0.0
    js, jsh = jax.jit(JL.compute_scale_and_shift)(jnp.asarray(p), jnp.asarray(t), jnp.asarray(m))
    ts, tsh = TL.compute_scale_and_shift(_t(p), _t(t), _t(m))
    # the 2x2 determinant cancels (a_00 a_11 ~ a_01^2 over a narrow depth
    # range): f32 rounding in another order moves the solve by ~3e-5
    _close(ts, js, rtol=1e-4, atol=0)
    _close(tsh, jsh, rtol=1e-4, atol=0)
    assert float(ts[2]) == 0.0 and float(tsh[2]) == 0.0
    for scales in (1, 4):
        f = lambda x: JL.scale_and_shift_invariant_loss(x, jnp.asarray(t), jnp.asarray(m),  # noqa: E731
                                                        alpha=0.5, scales=scales)
        ref, jg = jax.jit(jax.value_and_grad(f))(jnp.asarray(p))
        tp = _t(p).requires_grad_()
        out = TL.scale_and_shift_invariant_loss(tp, _t(t), _t(m), alpha=0.5, scales=scales)
        out.backward()
        _close(out, ref)
        _grad_close(tp.grad, jg, 1e-5)


def test_sensor_depth_loss_and_its_gradient_match_jax():
    rng = np.random.default_rng(1)
    R, S = 24, 16
    starts = np.sort(rng.uniform(0.5, 3.0, (R, S)), -1).astype(np.float32)
    dn = rng.uniform(1.0, 1.2, (R, 1)).astype(np.float32)
    gt = rng.uniform(1.0, 2.5, (R, 1)).astype(np.float32)
    gt[::5] = 0.0  # rays without a sensor depth
    depth = (gt + 0.1 * rng.standard_normal((R, 1))).astype(np.float32)
    sdf = rng.uniform(-0.05, 0.05, (R, S)).astype(np.float32)

    def jloss(depth, sdf):
        return sum(JL.sensor_depth_loss(depth, jnp.asarray(gt), jnp.asarray(starts), sdf,
                                        jnp.asarray(dn), truncation=0.05))

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(depth), jnp.asarray(sdf))
    jterms = JL.sensor_depth_loss(jnp.asarray(depth), jnp.asarray(gt), jnp.asarray(starts),
                                  jnp.asarray(sdf), jnp.asarray(dn), truncation=0.05)
    td, tsdf = _t(depth).requires_grad_(), _t(sdf).requires_grad_()
    terms = TL.sensor_depth_loss(td, _t(gt), _t(starts), tsdf, _t(dn), truncation=0.05)
    sum(terms).backward()
    for a, b in zip(terms, jterms):
        _close(a, b)
    assert all(float(b) > 0 for b in jterms)
    _grad_close(td.grad, jg[0], 1e-5)
    _grad_close(tsdf.grad, jg[1], 1e-5)


def test_s3im_with_jax_permutations_matches_jax():
    """S3IM takes its shuffles as an argument here: JAX's, drawn from its key."""
    rng = np.random.default_rng(2)
    n, repeat, height = 64, 10, 32
    src = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    tar = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    keys = jax.random.split(key, repeat - 1)
    perms = np.stack([np.asarray(jax.random.permutation(keys[i], n)) for i in range(repeat - 1)])
    ref, jg = jax.value_and_grad(lambda s: JL.s3im_loss(s, jnp.asarray(tar), key, repeat_time=repeat,
                                                        patch_height=height))(jnp.asarray(src))
    ts = _t(src).requires_grad_()
    out = TL.s3im_loss(ts, _t(tar), repeat_time=repeat, patch_height=height,
                       perms=torch.from_numpy(perms))
    out.backward()
    _close(out, ref)
    _grad_close(ts.grad, jg, 1e-5)
    # shuffles drawn from a generator: the loss is 0 on identical colours, and above 0 otherwise
    gen = torch.Generator().manual_seed(0)
    assert float(TL.s3im_loss(_t(src), _t(src), gen, patch_height=height)) < 1e-6
    assert float(TL.s3im_loss(_t(src), _t(tar), gen, patch_height=height)) > 0.1


def _tie_patches():
    """5 views (the reference and 4 sources) of 6 rays' 3x3 patches: on
    rays 0-2 sources 1 and 3 are flat (score exactly 0), source 1 invalid
    and source 3 valid or the other way; sources 2 and 4 carry the same
    patch (a tie at a score above 0); rays 3-5 random."""
    rng = np.random.default_rng(3)
    N, R, P = 5, 6, 3
    patches = rng.uniform(0, 1, (N, R, P * P, 3)).astype(np.float32)
    valid = np.ones((N, R, P * P, 1), bool)
    for r in range(3):
        patches[1, r] = 0.4
        patches[3, r] = 0.6
        patches[4, r] = patches[2, r]
        valid[1 if r != 1 else 3, r, r] = False
    valid[2, 4, 0] = False
    return patches, valid


@pytest.mark.parametrize("topk", [1, 2, 3])
def test_multi_view_loss_picks_ties_as_jax_and_its_gradient_matches(topk):
    patches, valid = _tie_patches()
    f = lambda p: JL.multi_view_loss(p, jnp.asarray(valid), patch_size=3, topk=topk)  # noqa: E731
    ref, jg = jax.jit(jax.value_and_grad(f))(jnp.asarray(patches))
    tp = _t(patches).requires_grad_()
    out = TL.multi_view_loss(tp, torch.from_numpy(valid), patch_size=3, topk=topk)
    out.backward()
    _close(out, ref)
    _grad_close(tp.grad, jg, 1e-5)
    # the stable pick: on a tie the lower source index comes first, as lax.top_k's
    score = np.array([[0.0, 0.5, 0.0, 0.5], [0.3, 0.3, 0.3, 0.1]], np.float32)
    vals, idx = TL.smallest_k(_t(score), 3)
    jv, ji = jax.lax.top_k(-jnp.asarray(score), 3)
    assert idx.tolist() == np.asarray(ji).tolist() == [[0, 2, 1], [3, 0, 1]]
    _close(vals, -np.asarray(jv))


def test_loss_dict_takes_every_cue_term_as_jax():
    """``get_loss_dict``'s assembly on given outputs: rgb, eikonal, the mask
    BCE, the mono normal and depth terms (40 rays: the depth's (1, 32, -1)
    layout padded with 24 masked zeros), the three sensor terms and the
    patch NCC, against JAX's ``SurfaceModel.get_loss_dict``."""
    rng = np.random.default_rng(4)
    R, S, N, P = 40, 12, 4, 3
    mults = dict(fg_mask_loss_mult=0.01, mono_normal_loss_mult=0.05, mono_depth_loss_mult=0.1,
                 sensor_depth_l1_loss_mult=0.3, sensor_depth_freespace_loss_mult=0.2,
                 sensor_depth_sdf_loss_mult=0.4, patch_warp_loss_mult=0.1, patch_size=P, topk=2)
    starts = np.sort(rng.uniform(0.5, 3.0, (R, S)), -1).astype(np.float32)
    arrays = {
        "rgb": rng.uniform(0, 1, (R, 3)), "eik_grad": rng.standard_normal((R, S, 3)),
        "weights": rng.uniform(0, 0.1, (R, S)), "normal": rng.standard_normal((R, 3)),
        "depth": rng.uniform(1, 3, (R, 1)), "directions_norm": rng.uniform(1, 1.2, (R, 1)),
        "sdf": rng.uniform(-0.1, 0.1, (R, S)),
        "patches": rng.uniform(0, 1, (N, R, P * P, 3)),
    }
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    pvalid = rng.uniform(size=(N, R, P * P, 1)) > 0.1
    batch = {"image": rng.uniform(0, 1, (R, 3)), "fg_mask": (rng.uniform(size=(R, 1)) > 0.5) * 1.0,
             "normal": rng.standard_normal((R, 3)), "depth": rng.uniform(0.02, 0.05, (R,)),
             "sensor_depth": np.where(rng.uniform(size=R) > 0.2, rng.uniform(1, 3, R), 0.0)}
    batch = {k: v.astype(np.float32) for k, v in batch.items()}

    def outputs(conv, samples):
        out = {k: conv(v) for k, v in arrays.items() if k not in ("sdf", "patches")}
        out.update(ray_samples=samples, field_outputs={"sdf": conv(arrays["sdf"])},
                   patches=conv(arrays["patches"]), patches_valid_mask=conv(pvalid))
        return out

    zeros3 = np.zeros((R, 3), np.float32)
    jself = type("J", (), {"config": JSurfaceModelConfig(**mults)})()
    jsamples = JRaySamples(jnp.asarray(zeros3), jnp.asarray(zeros3), jnp.ones((R, 1)),
                           jnp.asarray(starts), jnp.asarray(starts + 0.1))
    ref = JSurfaceModel.get_loss_dict(jself, None, outputs(jnp.asarray, jsamples),
                                      {k: jnp.asarray(v) for k, v in batch.items()}, {}, None)
    tself = type("T", (), {"config": TSurfaceModelConfig(**mults),
                           "mono_depth_loss": TSurfaceModel.mono_depth_loss})()
    tsamples = TRaySamples(_t(zeros3), _t(zeros3), torch.ones(R, 1), _t(starts), _t(starts + 0.1))
    out = TSurfaceModel.get_loss_dict(tself, outputs(lambda v: torch.from_numpy(np.asarray(v)), tsamples),
                                      {k: _t(v) for k, v in batch.items()}, {}, None)
    assert sorted(out) == sorted(ref) == sorted([
        "rgb_loss", "eikonal_loss", "fg_mask_loss", "normal_loss", "depth_loss", "sensor_l1_loss",
        "sensor_freespace_loss", "sensor_sdf_loss", "patch_loss"])
    for k in ref:
        assert float(ref[k]) != 0.0, k
        _close(out[k], ref[k], rtol=1e-5, atol=0)


def test_periodic_tv_raises():
    with pytest.raises(NotImplementedError, match="item 3"):
        TSurfaceModel(TSurfaceModelConfig(periodic_tvl_mult=0.1, background_model="none"), None, 1)


# --- the patch warp -------------------------------------------------------------

W = H = 24
PATCH = 5


def _warp_inputs(dtype=np.float32, seed=5):
    """A reference camera on +z at 2.2 looking at the origin and three
    source cameras turned about y, a sphere of radius 0.6 with a small
    ripple sampled along 30 reference rays (a few pass the sphere by, so
    they have no crossing), its normals with noise, random source images."""
    rng = np.random.default_rng(seed)
    c2ws = []
    for ang in (0.0, 0.3, -0.35, 0.6):
        c, s = np.cos(ang), np.sin(ang)
        rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        c2ws.append(np.concatenate([rot, (rot @ np.array([0, 0, 2.2]))[:, None]], 1))
    c2ws = np.stack(c2ws).astype(np.float32)
    intr = dict(fx=26.0, fy=25.0, cx=W / 2, cy=H / 2, width=W, height=H)
    R, S = 30, 24
    pix = rng.integers(7, H - 7, (R, 2))
    pix[:3] = [[2, 2], [3, 20], [21, 4]]  # corners: rays past the sphere
    y, x = pix[:, 0] + 0.5, pix[:, 1] + 0.5
    d = np.stack([(x - intr["cx"]) / intr["fx"], -(y - intr["cy"]) / intr["fy"], -np.ones(R)], -1)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.tile(c2ws[0, :, 3], (R, 1))
    starts = np.sort(rng.uniform(1.0, 3.0, (R, S)), -1)
    pts = o[:, None] + d[:, None] * starts[..., None]

    def sdf_fn(p):
        return (np.linalg.norm(p, axis=-1) - 0.6 + 0.03 * np.sin(5 * p[..., 0]) * np.sin(4 * p[..., 1]))

    sdf = sdf_fn(pts)
    normal = pts / np.linalg.norm(pts, axis=-1, keepdims=True) + 0.1 * rng.standard_normal(pts.shape)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    images = rng.uniform(0, 1, (4, H, W, 3))
    cast = lambda a: np.asarray(a, dtype)  # noqa: E731
    return dict(o=cast(o), d=cast(d), starts=cast(starts), sdf=cast(sdf), normal=cast(normal),
                images=cast(images), c2ws=c2ws.astype(dtype), intr=intr, pix=pix.astype(np.int32))


def _jax_warp(inp, rays=slice(None)):
    cams = JCameras.create(inp["c2ws"], **inp["intr"])
    dt = inp["sdf"].dtype
    cams = cams.replace(camera_to_worlds=jnp.asarray(inp["c2ws"]),
                        **{k: getattr(cams, k).astype(dt) for k in ("fx", "fy", "cx", "cy")})
    samples = JRaySamples(jnp.asarray(inp["o"][rays]), jnp.asarray(inp["d"][rays]),
                          jnp.ones((len(inp["o"][rays]), 1), dt), jnp.asarray(inp["starts"][rays]),
                          jnp.asarray(inp["starts"][rays] + 0.01))

    def loss(sdf, normal):
        p, v = jpw.patch_warping(samples, sdf, normal, cams, jnp.asarray(inp["images"]),
                                 jnp.asarray(inp["pix"][rays]), patch_size=PATCH)
        return JL.multi_view_loss(p, v, patch_size=PATCH, topk=2), (p, v)

    return jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(inp["sdf"][rays]), jnp.asarray(inp["normal"][rays]))


def _port_warp(inp):
    dt = torch.float64 if inp["sdf"].dtype == np.float64 else torch.float32
    cams = TCameras.create(inp["c2ws"], device="cpu", **inp["intr"])
    cams = dataclasses.replace(cams, **{k: getattr(cams, k).to(dt) for k in
                                        ("camera_to_worlds", "fx", "fy", "cx", "cy")})
    samples = TRaySamples(_t(inp["o"], dt), _t(inp["d"], dt), torch.ones(len(inp["o"]), 1, dtype=dt),
                          _t(inp["starts"], dt), _t(inp["starts"] + 0.01, dt))
    sdf = _t(inp["sdf"], dt).requires_grad_()
    normal = _t(inp["normal"], dt).requires_grad_()
    p, v = tpw.patch_warping(samples, sdf, normal, cams, _t(inp["images"], dt),
                             torch.from_numpy(inp["pix"]).long(), patch_size=PATCH)
    loss = TL.multi_view_loss(p, v, patch_size=PATCH, topk=2)
    loss.backward()
    return loss, p, v, sdf.grad, normal.grad, (samples, sdf.detach(), normal.detach(), cams)


def _margins(samples, sdf, normal, cams, pix, size=PATCH, hw=(H, W)):
    """The smallest distance of each hard decision of the warp of
    ``size``^2 patches in images of ``hw`` pixels from its threshold,
    recomputed in float64 from the port's pieces."""
    f64 = lambda t: t.double()  # noqa: E731
    samples = dataclasses.replace(samples, **{k: f64(getattr(samples, k)) for k in
                                              ("origins", "directions", "starts", "ends")})
    cams = dataclasses.replace(cams, **{k: f64(getattr(cams, k)) for k in
                                        ("camera_to_worlds", "fx", "fy", "cx", "cy")})
    sdf, normal = f64(sdf), f64(normal)
    inside = torch.ones(len(pix), dtype=torch.bool)
    pts, pn, mask = tpw.get_intersection_points(samples, sdf, normal, inside)
    pn = torch.where(mask[:, None], pn, -samples.directions)
    out = {"sdf": float(sdf.abs().min()),
           "normal": float((torch.sum(pn * samples.directions, -1).abs() - 0.1)[mask].abs().min())}
    c2w = cams.camera_to_worlds
    c2w = torch.cat([c2w[:, :3, :1], -c2w[:, :3, 1:3], c2w[:, :3, 3:]], -1)
    dir_src = c2w[:, None, :, 3] - pts[None]
    dir_src = dir_src / dir_src.norm(dim=-1, keepdim=True)
    out["angle"] = float((torch.sum(dir_src * pn[None], -1) - 0.3)[:, mask].abs().min())
    p_src = c2w[:, :3, :3].transpose(1, 2) @ (pts.T[None] - c2w[:, :3, 3:])
    out["z"] = float((p_src[:, 2] - 0.01)[:, mask].abs().min())
    Hm, _ = tpw.get_homography(pts, pn, cams, 0.3)
    half = size // 2
    offs = torch.arange(-half, half + 1, dtype=torch.float64)
    yy, xx = torch.meshgrid(offs, offs, indexing="ij")
    base = torch.flip(pix, dims=[-1]).double() + 0.5
    coords = base[:, None] + torch.stack([xx, yy], -1).reshape(-1, 2)[None]
    hom = torch.cat([coords, torch.ones_like(coords[..., :1])], -1)
    warped = torch.einsum("nrij,rpj->nrpi", Hm, hom)[:, mask]
    out["depth"] = float((warped[..., 2] - 0.2).abs().min())
    uv = warped[..., :2] / warped[..., 2:]
    g = torch.stack([uv[..., 0] / (hw[1] - 1), uv[..., 1] / (hw[0] - 1)], -1) * 2 - 1
    out["bounds"] = float((g.abs() - 1).abs().min())
    return out


def test_patch_warping_forward_matches_jax_in_float32():
    inp = _warp_inputs()
    (ref, (jp, jv)), _ = _jax_warp(inp)
    loss, p, v, _, _, pieces = _port_warp(inp)
    m = _margins(*pieces, torch.from_numpy(inp["pix"]).long())
    assert m.pop("sdf") > 1e-5 and min(m.values()) > 1e-4, \
        f"a warp decision lies within f32 rounding of its threshold: {m}"
    jv = np.asarray(jv)
    assert np.array_equal(v.numpy(), jv)
    ray_valid = jv.any(axis=(0, 2, 3))
    assert 10 <= ray_valid.sum() < len(ray_valid)  # not vacuous, and some rays masked
    assert jv[1:].all(axis=(2, 3)).sum() >= 10  # all-valid source patches: what the loss counts
    _close(p, jp, rtol=0, atol=1e-5)
    assert not p.detach()[~v.expand_as(p)].any()
    _close(loss, ref, rtol=1e-5, atol=0)


def test_patch_loss_gradient_matches_jax_in_float64():
    """d patch_loss / d sdf and d normal (the crossing depth, the
    interpolated normal, the homography and the bilinear weights) against
    JAX's jitted gradient, on rays with and without a crossing."""
    inp = _warp_inputs(np.float64)
    crossing = np.any(inp["sdf"][:, :-1] * inp["sdf"][:, 1:] < 0, axis=-1)
    assert 0 < (~crossing).sum() <= 5
    loss, _, _, g_sdf, g_normal, _ = _port_warp(inp)
    with jax.enable_x64():
        (ref, _), jg = _jax_warp(inp)
    _close(loss, ref, rtol=1e-6, atol=0)
    assert float(ref) > 0
    for port, jax_g in zip((g_sdf, g_normal), jg):
        jax_g = np.asarray(jax_g)
        assert not port[torch.from_numpy(~crossing)].any() and not jax_g[~crossing].any()
        scale = float(np.abs(jax_g).max())
        assert scale > 0
        assert float(np.abs(port.numpy() - jax_g).max()) <= 1e-6 * scale


def test_bilinear_sample_matches_jax_with_coordinates_outside():
    rng = np.random.default_rng(6)
    images = rng.uniform(0, 1, (2, 7, 9, 3)).astype(np.float32)
    coords = rng.uniform(-1.3, 1.3, (2, 50, 2)).astype(np.float32)
    coords[0, :4] = [[-1, -1], [1, 1], [1, -1], [np.nan, 0]]
    ref = np.asarray(jpw.bilinear_sample(jnp.asarray(images), jnp.asarray(coords)))
    out = tpw.bilinear_sample(_t(images), _t(coords)).numpy()
    assert np.array_equal(np.isnan(out), np.isnan(ref)) and np.isnan(ref).any()
    _close(out[~np.isnan(ref)], ref[~np.isnan(ref)])


# --- the parser, the data managers, the generator ----------------------------------


@pytest.fixture(scope="module")
def cue_scene(tmp_path_factory):
    """A 6-view 20x20 sphere scene with monocular cues, foreground masks,
    pairs of 4 sources (before the parser's quirk), SfM point files, and the
    mono depth written again as sensor depth."""
    d = tmp_path_factory.mktemp("cues") / "sphere"
    generate_sphere_dataset(d, num_images=6, width=20, height=20, with_pairs=True)
    tdtu.write_pairs_and_sfm_points(d, num_pair_srcs=4, points_per_view=12)
    meta = json.loads((d / "meta_data.json").read_text())
    for i, frame in enumerate(meta["frames"]):
        frame["sensor_depth_path"] = frame["mono_depth_path"]
    meta["has_sensor_depth"] = True
    (d / "meta_data.json").write_text(json.dumps(meta))
    return d


FULL = dict(include_mono_prior=True, include_sensor_depth=True, include_foreground_mask=True,
            include_sfm_points=True, load_pairs=True)


@pytest.mark.parametrize("options", [
    dict(FULL),
    dict(FULL, auto_orient=True, orientation_method="pca", center_poses=True),
    dict(FULL, auto_orient=True, orientation_method="up", auto_scale_poses=True, scale_factor=0.5),
    dict(FULL, auto_orient=True, orientation_method="none", center_poses=True,
         pairs_sorted_ascending=False, skip_every_for_val_split=2, train_val_no_overlap=True),
    dict(include_mono_prior=True, auto_orient=True, neighbors_num=2, neighbors_shuffle=True),
])
def test_parser_matches_jax(cue_scene, options):
    train = parse_config(SDFStudioDataParserConfig(data=cue_scene, **options), "train")
    for split in ("train", "val"):
        j = JSDFStudio(JParserConfig(data=cue_scene, **options)).get_dataparser_outputs(split)
        t = parse_config(SDFStudioDataParserConfig(data=cue_scene, **options), split)
        assert t.image_filenames == j.image_filenames
        np.testing.assert_array_equal(t.cameras.camera_to_worlds.numpy(),
                                      np.asarray(j.cameras.camera_to_worlds))
        for k in ("fx", "fy", "cx", "cy", "width", "height"):
            np.testing.assert_array_equal(getattr(t.cameras, k).numpy(),
                                          np.asarray(getattr(j.cameras, k)).reshape(-1))
        for k in ("depths", "sensor_depths", "fg_masks", "sparse_sfm_points"):
            a, b = getattr(t, k), getattr(j, k)
            assert (a is None) == (b is None), k
            for x, y in zip(a or [], b or []):
                np.testing.assert_array_equal(x, y)
        assert (t.normals is None) == (j.normals is None)
        for x, y in zip(t.normals or [], j.normals or []):
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-6)
        if split == "train" and options.get("load_pairs"):
            np.testing.assert_array_equal(t.pairs_srcs, j.pairs_srcs)
        else:
            assert t.pairs_srcs is None and j.pairs_srcs is None
    if options.get("pairs_sorted_ascending", True) and options.get("load_pairs"):
        # JAX's quirk: "0 5 1 4 2" -> [0, 2, 4, 1] (the sources reversed, the first dropped)
        assert train.pairs_srcs.shape == (6, 4) and list(train.pairs_srcs[0]) == [0, 2, 4, 1]


def test_parser_orientation_override_and_missing_cues(cue_scene, tmp_path):
    import shutil

    d = tmp_path / "override"
    shutil.copytree(cue_scene, d)
    meta = json.loads((d / "meta_data.json").read_text())
    meta["orientation_override"] = "pca"
    meta["has_mono_prior"] = False
    (d / "meta_data.json").write_text(json.dumps(meta))
    opts = dict(auto_orient=True, orientation_method="up", center_poses=True)
    j = JSDFStudio(JParserConfig(data=d, **opts)).get_dataparser_outputs("train")
    t = parse_config(SDFStudioDataParserConfig(data=d, **opts))
    np.testing.assert_array_equal(t.cameras.camera_to_worlds.numpy(), np.asarray(j.cameras.camera_to_worlds))
    with pytest.raises(AssertionError):
        JSDFStudio(JParserConfig(data=d, include_mono_prior=True)).get_dataparser_outputs("train")
    with pytest.raises(ValueError, match="has_mono_prior"):
        parse_config(SDFStudioDataParserConfig(data=d, include_mono_prior=True))


def test_data_managers_stack_the_cues_and_draw_flexible_batches_as_jax(cue_scene):
    opts = dict(FULL, include_sensor_depth=True)
    jout = JSDFStudio(JParserConfig(data=cue_scene, **opts)).get_dataparser_outputs("train")
    tout = parse_config(SDFStudioDataParserConfig(data=cue_scene, **opts))
    jdm = JVanillaDataManager(JDataManagerConfig(train_num_rays_per_batch=16), jout)
    tdm = VanillaDataManager(DataManagerConfig(train_num_rays_per_batch=16), tout, device="cpu")
    assert sorted(tdm.train_data) == sorted(jdm.train_data) == [
        "depth", "fg_mask", "image", "normal", "sensor_depth"]
    for k, v in tdm.train_data.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jdm.train_data[k]))
    idx, batch = tdm.sample_train_batch(torch.Generator().manual_seed(0))
    cam, y, x = idx.unbind(-1)
    for k, v in batch.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jdm.train_data[k])[cam, y, x])

    for neighbors in (None, 2):
        jfm = JFlexibleDataManager(JDataManagerConfig(train_num_rays_per_batch=16, kind="flexible"),
                                   jout, neighbors_num=neighbors)
        tfm = FlexibleDataManager(DataManagerConfig(train_num_rays_per_batch=16, kind="flexible",
                                                    neighbors_num=neighbors), tout, device="cpu")
        jidx, jbatch, jadd = jfm.sample_train_batch_flexible(jax.random.PRNGKey(3))
        jidx = np.asarray(jidx)
        assert len(set(jidx[:, 0])) == 1
        ref, ys, xs = torch.tensor(int(jidx[0, 0])), torch.from_numpy(jidx[:, 1]).long(), \
            torch.from_numpy(jidx[:, 2]).long()
        tidx, tbatch, tadd = tfm.flexible_batch(ref, ys, xs)
        np.testing.assert_array_equal(tidx.numpy(), jidx)
        for k in jbatch:
            np.testing.assert_array_equal(tbatch[k].numpy(), np.asarray(jbatch[k]))
        for k in ("uv", "src_idxs", "src_imgs"):
            np.testing.assert_array_equal(tadd[k].numpy(), np.asarray(jadd[k]))
        assert len(tadd["src_idxs"]) == (4 if neighbors is None else 3)
        jc, tc = jadd["src_cameras"], tadd["src_cameras"]
        np.testing.assert_array_equal(tc.camera_to_worlds.numpy(), np.asarray(jc.camera_to_worlds))
        np.testing.assert_array_equal(tc.get_intrinsics_matrices().numpy(),
                                      np.asarray(jc.get_intrinsics_matrices()))
        for k in ("width", "height"):
            np.testing.assert_array_equal(getattr(tc, k).numpy(), np.asarray(getattr(jc, k)).reshape(-1))
        # a draw from the generator: one reference image, its row of pairs
        gidx, _, gadd = tfm.sample_train_batch_flexible(torch.Generator().manual_seed(1))
        assert len(set(gidx[:, 0].tolist())) == 1 and gidx.shape == (16, 3)
        assert gadd["src_idxs"].tolist() == tfm.pairs_srcs[gidx[0, 0]].tolist()
    with pytest.raises(ValueError, match="pairs.txt"):
        FlexibleDataManager(DataManagerConfig(kind="flexible"), parse_config(
            SDFStudioDataParserConfig(data=cue_scene)), device="cpu")


def test_dtu_like_generator_matches_jax(tmp_path):
    """3 views of 32x32 with the cues: the same pixels (the port writes its
    own PNGs, JAX PIL's), the same depth and normal files, the same meta."""
    kw = dict(num_images=3, width=32, height=32, with_mono_prior=True)
    jdtu.generate_dtu_like_dataset(tmp_path / "j", **kw)
    tdtu.generate_dtu_like_dataset(tmp_path / "t", **kw)
    assert json.loads((tmp_path / "t" / "meta_data.json").read_text()) == json.loads(
        (tmp_path / "j" / "meta_data.json").read_text())
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir()) and len(names) == 13
    hits = 0
    for n in names:
        a, b = tmp_path / "t" / n, tmp_path / "j" / n
        if n.endswith(".png"):
            assert np.array_equal(png.read_png(a), png.read_png(b)), n
            hits += int(n.endswith("mask.png") and png.read_png(a).any())
        elif n.endswith(".npy"):
            np.testing.assert_allclose(np.load(a), np.load(b), rtol=0, atol=1e-6)
    assert hits == 3  # every view sees the object
