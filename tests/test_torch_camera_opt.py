"""The parts of the density methods against the JAX package, on the CPU:
the camera optimizer and its exp maps, Adam with ``weight_decay``, the
renderers and losses of nerfacto, the hash encode's gradient in ``x``, the
dynamic batch's buckets, and the Blender and Phototourism parsers.

Tolerances, with their reasons:
- the exp maps in float64: 1e-12 (the same formulas; both branches of the
  small-angle switch are hit), their gradients 1e-10;
- the corrections and the corrected rays in float32: 1e-6 absolute (a few
  products of unit-scale numbers), the rays' gradient in the pose table
  1e-5 of its scale;
- Adam against optax over five steps: 1e-6 (as ``tests/test_torch_train.py``);
- the renderers and losses: 1e-6 relative for the values, 1e-5 of scale
  for the gradients (sums over 16 samples in another order);
- the hash encode's gradient in ``x``: 1e-5 of its scale (the blend's
  products reduced in another order), its double backward into the table
  1e-5 of scale;
- the parsers: exact for names, sizes and the scene box, 1e-6 for poses and
  focal lengths, exact for the composited pixels (the same float32
  products of the same bytes).
"""
import json
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sdfstudio_tpu.cameras import lie_groups as jlie
from sdfstudio_tpu.cameras.camera_optimizers import CameraOptimizer as JCameraOptimizer
from sdfstudio_tpu.cameras.camera_optimizers import CameraOptimizerConfig as JCOConfig
from sdfstudio_tpu.cameras.cameras import Cameras as JCameras
from sdfstudio_tpu.components import losses as jL
from sdfstudio_tpu.engine.optimizers import OptimizerConfig as JOptimizerConfig
from sdfstudio_tpu.engine.optimizers import OptimizerGroupConfig as JOptimizerGroupConfig
from sdfstudio_tpu.engine.optimizers import build_optimizer as jbuild_optimizer
from sdfstudio_tpu.engine.trainer import Trainer as JTrainer
from sdfstudio_tpu.ops import render as jR
from sdfstudio_tpu.ops.encodings import HashEncoding as JHashEncoding

from sdfstudio_tpu_torch.cameras import lie_groups as tlie
from sdfstudio_tpu_torch.cameras.camera_optimizers import CameraOptimizer, CameraOptimizerConfig
from sdfstudio_tpu_torch.cameras.cameras import Cameras
from sdfstudio_tpu_torch.components import losses as tL
from sdfstudio_tpu_torch.engine.optimizers import (OptimizerConfig, OptimizerGroupConfig,
                                                   build_optimizers)
from sdfstudio_tpu_torch.engine.trainer import Trainer, TrainerConfig, to_bucket
from sdfstudio_tpu_torch.ops import render as tR
from sdfstudio_tpu_torch.ops.encodings import HashEncoding
from sdfstudio_tpu_torch.utils.convert import opt_state_from_jax
from tests.test_torch_train import _close, _t
from tests.test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = pathlib.Path(__file__).resolve().parents[1]
HERITAGE = REPO / ".parity" / "heritage_like"


def _tangents(n=40, seed=0, angles=(0.0, 1e-6, 1e-3, 5e-3, 9.9e-3, 1.01e-2, 0.3, 1.5, 3.0)):
    """[n, 6] tangents whose rotation angles span both sides of eps = 1e-2."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, 6))
    axis = v[:, 3:] / np.linalg.norm(v[:, 3:], axis=-1, keepdims=True)
    angles = np.concatenate([angles, rng.uniform(0, 2.0, n - len(angles))])
    v[:, 3:] = axis * angles[:, None]
    return v


@pytest.mark.parametrize("name", ["exp_map_SO3xR3", "exp_map_SE3"])
def test_exp_maps_match_jax_in_float64(name):
    tangent = _tangents()
    w = np.random.default_rng(1).standard_normal((len(tangent), 3, 4))
    with jax.enable_x64():
        jfn = getattr(jlie, name)
        ref = np.asarray(jfn(jnp.asarray(tangent)))
        ref_g = np.asarray(jax.grad(lambda t: jnp.sum(jfn(t) * w))(jnp.asarray(tangent)))
    t = torch.from_numpy(tangent).requires_grad_(True)
    out = getattr(tlie, name)(t)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=1e-12)
    (g,) = torch.autograd.grad((out * torch.from_numpy(w)).sum(), t)
    np.testing.assert_allclose(g.numpy(), ref_g, rtol=0, atol=1e-10)
    assert np.isfinite(ref_g).all() and float(np.abs(ref_g[0]).max()) > 0  # the identity too


def _cameras(n=4, H=12, W=16, seed=2):
    rng = np.random.default_rng(seed)
    c2w = np.zeros((n, 3, 4), np.float32)
    for i in range(n):
        q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        c2w[i, :, :3] = q * np.sign(np.linalg.det(q))
        c2w[i, :, 3] = rng.uniform(-2, 2, 3)
    kw = dict(fx=rng.uniform(10, 14, n).astype(np.float32), fy=rng.uniform(10, 14, n).astype(np.float32),
              cx=np.full(n, W / 2, np.float32), cy=np.full(n, H / 2, np.float32), width=W, height=H)
    return JCameras.create(camera_to_worlds=c2w, **kw), Cameras.create(camera_to_worlds=c2w, device="cpu",
                                                                       **kw)


@pytest.mark.parametrize("mode,noise", [("SO3xR3", False), ("SO3xR3", True), ("SE3", True)])
def test_camera_optimizer_and_rays_match_jax(mode, noise):
    n, R = 4, 32
    std = dict(position_noise_std=0.05, orientation_noise_std=0.02) if noise else {}
    jco = JCameraOptimizer(num_cameras=n, config=JCOConfig(mode=mode, **std))
    variables = jco.init(jax.random.PRNGKey(0), jnp.zeros((1,), jnp.int32))
    adj = _tangents(n, seed=3, angles=(0.0, 5e-3, 2e-2, 0.2)).astype(np.float32)
    adj[:, :3] *= 0.01
    variables = {**variables, "params": {"pose_adjustment": jnp.asarray(adj)}}
    tco = CameraOptimizer(n, CameraOptimizerConfig(mode=mode, **std))
    with torch.no_grad():
        tco.pose_adjustment.copy_(_t(adj))
    if noise:
        assert tco.has_noise and tuple(tco.pose_noise.shape) == (n, 3, 4)
        tco.load_pose_noise(np.asarray(variables["constants"]["pose_noise"]))
    rng = np.random.default_rng(4)
    cam = rng.integers(0, n, R)
    coords = np.stack([rng.uniform(0, 12, R), rng.uniform(0, 16, R)], -1).astype(np.float32)
    w = rng.standard_normal((R, 3)).astype(np.float32)
    jcams, tcams = _cameras(n)

    def jrays(params):
        corr = jco.apply({**variables, "params": params}, jnp.asarray(cam, jnp.int32))
        rb = jcams.generate_rays(jnp.asarray(cam, jnp.int32), jnp.asarray(coords), corr)
        return jnp.sum((rb.origins + 2.0 * rb.directions) * w), (corr, rb)

    (_, (ref_corr, ref_rb)), ref_g = jax.value_and_grad(jrays, has_aux=True)(variables["params"])
    corr = tco(torch.from_numpy(cam))
    _close(corr.detach(), ref_corr, rtol=0, atol=1e-6)
    rb = tcams.generate_rays(torch.from_numpy(cam), _t(coords), camera_opt_to_camera=corr)
    for k in ("origins", "directions", "pixel_area", "directions_norm"):
        _close(getattr(rb, k).detach(), getattr(ref_rb, k), rtol=0, atol=1e-6)
    (g,) = torch.autograd.grad(((rb.origins + 2.0 * rb.directions) * _t(w)).sum(), tco.pose_adjustment)
    ref = np.asarray(ref_g["pose_adjustment"])
    assert float(np.abs(g.numpy() - ref).max()) <= 1e-5 * float(np.abs(ref).max())
    off = CameraOptimizer(n)(torch.from_numpy(cam))  # mode "off": the identity, no parameters
    assert torch.equal(off, torch.eye(3, 4).expand(R, 3, 4)) and not list(CameraOptimizer(n).parameters())


def test_adam_weight_decay_matches_optax():
    """``adam`` with ``weight_decay`` (the camera optimizer's group,
    optimizers.py:30-35): five steps, one with no gradient, and optax's
    state carried across from a ``multi_transform`` beside a plain group."""
    rng = np.random.default_rng(5)
    params = {"camera_opt": {"pose_adjustment": rng.standard_normal((4, 6)).astype(np.float32) * 0.1},
              "field": {"w": rng.standard_normal((3, 2)).astype(np.float32)}}
    groups = {"camera_opt": (6e-4, 1e-8, 1e-2), "field": (1e-2, 1e-15, 0.0)}
    jtx = jbuild_optimizer({g: JOptimizerGroupConfig(JOptimizerConfig(lr=lr, eps=eps, weight_decay=wd))
                            for g, (lr, eps, wd) in groups.items()}, params)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = jtx.init(jp)
    module = torch.nn.Module()
    module.camera_opt = torch.nn.Module()
    module.camera_opt.pose_adjustment = torch.nn.Parameter(_t(params["camera_opt"]["pose_adjustment"]))
    module.field = torch.nn.Module()
    module.field.w = torch.nn.Parameter(_t(params["field"]["w"]))
    opts = build_optimizers({g: OptimizerGroupConfig(OptimizerConfig(lr=lr, eps=eps, weight_decay=wd))
                             for g, (lr, eps, wd) in groups.items()}, module)
    assert opts["camera_opt"].grad_decay == 1e-2 and opts["camera_opt"].weight_decay == 0.0
    for step in range(5):
        g = jax.tree_util.tree_map(lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
        if step == 2:
            g["camera_opt"]["pose_adjustment"] = np.zeros((4, 6), np.float32)
        upd, state = jax.jit(jtx.update)(g, state, jp)
        jp = optax.apply_updates(jp, upd)
        opts["camera_opt"].step([None if step == 2 else _t(g["camera_opt"]["pose_adjustment"])],
                                apply=True)
        opts["field"].step([_t(g["field"]["w"])], apply=True)
    _close(module.camera_opt.pose_adjustment.detach(), jp["camera_opt"]["pose_adjustment"], rtol=1e-6,
           atol=1e-6)
    _close(module.field.w.detach(), jp["field"]["w"], rtol=1e-6, atol=1e-6)
    # optax's nested (EmptyState, (ScaleByAdamState, ScaleByScheduleState)) chain reads back
    fresh = build_optimizers({g: OptimizerGroupConfig(OptimizerConfig(lr=lr, eps=eps, weight_decay=wd))
                              for g, (lr, eps, wd) in groups.items()}, module)
    opt_state_from_jax(fresh, jax.tree_util.tree_map(np.asarray, state))
    for g in groups:
        assert fresh[g].count == opts[g].count == 5
        for a, b in zip(fresh[g].mu + fresh[g].nu, opts[g].mu + opts[g].nu):
            _close(a, b, rtol=1e-6, atol=1e-9)


def _render_inputs(R=6, S=16, seed=6):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0, 1, (R, S)).astype(np.float32)
    w = w / w.sum(-1, keepdims=True) * rng.uniform(0.3, 0.95, (R, 1)).astype(np.float32)
    rgb = rng.uniform(0, 1, (R, S, 3)).astype(np.float32)
    edges = np.sort(rng.uniform(0.1, 4.0, (R, S + 1)), -1).astype(np.float32)
    n = rng.standard_normal((R, S, 3)).astype(np.float32)
    n2 = rng.standard_normal((R, S, 3)).astype(np.float32)
    d = rng.standard_normal((R, 3)).astype(np.float32)
    bg = rng.uniform(0, 1, (R, 3)).astype(np.float32)
    return w, rgb, edges, n / np.linalg.norm(n, axis=-1, keepdims=True), n2, d, bg


class _Samples:
    """The bin edges as ray samples on both sides (``ray_samples_to_sdist``
    reads the spacing bins)."""

    def __init__(self, edges):
        self.spacing_starts, self.spacing_ends = edges[..., :-1], edges[..., 1:]


PARTS = {
    # name: (module, fn of the module and (weights, rgb, edges, normals, normals2, dirs, bg))
    "last_sample": ("render", lambda m, w, c, e, n, n2, d, bg: m.render_rgb(c, w, "last_sample")),
    "background_rgb": ("render", lambda m, w, c, e, n, n2, d, bg: m.render_rgb(c, w, background_rgb=bg)),
    "depth_median": ("render", lambda m, w, c, e, n, n2, d, bg: m.render_depth_median(w, e[..., :-1],
                                                                                     e[..., 1:])),
    "normals": ("render", lambda m, w, c, e, n, n2, d, bg: m.render_normals(n2, w, normalize=True)),
    "distortion": ("losses", lambda m, w, c, e, n, n2, d, bg: m.distortion_loss([w], [_Samples(e)])),
    "orientation": ("losses", lambda m, w, c, e, n, n2, d, bg: m.orientation_loss(w, n, d)),
    "pred_normal": ("losses", lambda m, w, c, e, n, n2, d, bg: m.pred_normal_loss(w, n, n2)),
}


@pytest.mark.parametrize("part", sorted(PARTS))
def test_render_and_loss_parts_match_jax(part):
    """Each of nerfacto's renderers and losses, and its gradient in every
    float input, against JAX's."""
    kind, fn = PARTS[part]
    inputs = _render_inputs()
    jm, tm = (jR, tR) if kind == "render" else (jL, tL)
    ref = fn(jm, *map(jnp.asarray, inputs))
    wts = np.random.default_rng(7).standard_normal(np.shape(ref)).astype(np.float32)
    floats = (0, 1, 2, 3, 4, 5, 6)

    def jloss(*args):
        full = list(map(jnp.asarray, inputs))
        for i, a in zip(floats, args):
            full[i] = a
        return jnp.sum(fn(jm, *full) * wts)

    ref_g = jax.grad(jloss, argnums=tuple(range(len(floats))))(*[jnp.asarray(inputs[i]) for i in floats])
    tin = [_t(a).requires_grad_(i in floats) for i, a in enumerate(inputs)]
    out = fn(tm, *tin)
    _close(out.detach(), ref, rtol=1e-6, atol=1e-7)
    grads = torch.autograd.grad((out * _t(wts)).sum(), [tin[i] for i in floats], allow_unused=True)
    seen = 0
    for g, r in zip(grads, ref_g):
        r = np.asarray(r)
        if g is None:
            assert not np.any(r)
            continue
        scale = float(np.abs(r).max())
        assert float(np.abs(g.numpy() - r).max()) <= 1e-5 * max(scale, 1e-30)
        seen += scale > 0
    assert seen >= 1


@pytest.mark.parametrize("F,want_jac", [(2, False), (4, False), (2, True), (4, True)])
def test_hash_grad_x_matches_jax(F, want_jac):
    """The encode's gradient in ``x`` against ``jax.grad`` through JAX's
    ``HashEncoding`` (its plain ``jnp`` blend), with the jacobian's
    cotangent where the caller takes it; and a loss on that gradient
    (nerfacto's orientation loss is one) differentiated into the table."""
    kw = dict(num_levels=4, min_res=4, max_res=32, log2_hashmap_size=10, features_per_level=F)
    j, t = JHashEncoding(**kw), HashEncoding(**kw)
    rng = np.random.default_rng(8)
    table = rng.uniform(-1.0, 1.0, (t.total_rows, F)).astype(np.float32)
    with torch.no_grad():
        t.hash_table.copy_(_t(table))
    x = rng.uniform(0.02, 0.98, (200, 3)).astype(np.float32)
    w_out = rng.standard_normal((200, 4 * F)).astype(np.float32)
    w_jac = rng.standard_normal((200, 4 * F, 3)).astype(np.float32)

    def jsum(p, xx):
        if want_jac:
            out, jac = j.apply({"params": p}, xx, want_jac=True)
            return jnp.sum(out * w_out) + jnp.sum(jac * w_jac)
        return jnp.sum(j.apply({"params": p}, xx) * w_out)

    p = {"hash_table": jnp.asarray(table)}
    ref = np.asarray(jax.grad(jsum, argnums=1)(p, jnp.asarray(x)))
    xt = _t(x).requires_grad_(True)
    res = t(xt, want_jac=want_jac)
    total = ((res[0] * _t(w_out)).sum() + (res[1] * _t(w_jac)).sum()) if want_jac \
        else (res * _t(w_out)).sum()
    (gx,) = torch.autograd.grad(total, xt, create_graph=not want_jac)
    assert float(np.abs(gx.detach().numpy() - ref).max()) <= 1e-5 * float(np.abs(ref).max())
    if want_jac:
        return
    ref_gt = np.asarray(jax.grad(lambda p: jnp.sum(jax.grad(jsum, argnums=1)(p, jnp.asarray(x)) ** 2))(p)
                        ["hash_table"])
    (gt,) = torch.autograd.grad((gx**2).sum(), t.hash_table)
    assert float(np.abs(ref_gt).max()) > 0
    assert float(np.abs(gt.numpy() - ref_gt).max()) <= 1e-5 * float(np.abs(ref_gt).max())


# --- the dynamic batch ------------------------------------------------------------------


def test_buckets_match_jax(tmp_path):
    """``_to_bucket``'s cases (JAX's ``tests/test_dynamic_batch.py:16-20``)
    and more, the initial bucket, one move on a measured sample count, and
    the saved ``dynamic_batch.txt``."""
    for n in (1000, 1, 10_000_000, 3000, 255.9, 362, 363, 131072 * 1.5, 0.0):
        assert to_bucket(n) == JTrainer._to_bucket(n), n
    assert (to_bucket(1000), to_bucket(1), to_bucket(10_000_000), to_bucket(3000)) == (
        1024, 256, 131072, 4096)
    model = types.SimpleNamespace(config=types.SimpleNamespace(max_num_samples_per_ray=256))
    config = TrainerConfig(dynamic_batch=True, target_num_samples=1 << 18, dynamic_update_every=5)
    trainer = Trainer(config, model, None, {})
    trainer.dyn_num_rays = trainer.initial_bucket()
    assert trainer.dyn_num_rays == 1024  # 2^18 / 256
    jstub = types.SimpleNamespace(config=config, _dyn_num_rays=1024, _to_bucket=JTrainer._to_bucket)
    for samples in (2.0e5, 3.1e4, 9.0e5):
        JTrainer._update_dynamic_batch(jstub, samples)
        trainer.update_dynamic_batch(samples)
        assert trainer.dyn_num_rays == jstub._dyn_num_rays
    assert trainer.dyn_num_rays != 1024
    saved = Trainer(config, model, None, {}, base_dir=tmp_path)
    saved.ckpt_dir.mkdir(parents=True)
    (saved.ckpt_dir / "dynamic_batch.txt").write_text("4096")
    assert saved.initial_bucket() == 4096


# --- the parsers ------------------------------------------------------------------------


def _blender_scene(root: pathlib.Path):
    """Two RGBA views of 10 x 14 and their transforms, in Blender's layout."""
    from sdfstudio_tpu_torch.data.png import write_png

    rng = np.random.default_rng(9)
    (root / "train").mkdir(parents=True)
    frames = []
    for i in range(2):
        img = rng.integers(0, 256, (10, 14, 4), dtype=np.uint8)
        write_png(root / "train" / f"r_{i}.png", img)
        pose = np.eye(4)
        pose[:3, :3], _ = np.linalg.qr(rng.standard_normal((3, 3)))
        pose[:3, 3] = rng.uniform(-3, 3, 3)
        frames.append({"file_path": f"./train/r_{i}", "transform_matrix": pose.tolist()})
    (root / "transforms_train.json").write_text(json.dumps({"camera_angle_x": 0.69, "frames": frames}))


@pytest.mark.parametrize("alpha_color", ["white", "black"])
def test_blender_parser_matches_jax(tmp_path, alpha_color):
    from sdfstudio_tpu.data.dataparsers.blender import Blender as JBlender
    from sdfstudio_tpu.data.dataparsers.blender import BlenderDataParserConfig as JBDC
    from sdfstudio_tpu.data.datamanager import VanillaDataManager as JDM

    from sdfstudio_tpu_torch.data.datamanager import stack_images
    from sdfstudio_tpu_torch.data.dataparsers.blender import BlenderDataParserConfig, parse_blender

    _blender_scene(tmp_path)
    j = JBlender(JBDC(data=tmp_path, scale_factor=0.5, alpha_color=alpha_color)).get_dataparser_outputs(
        "train")
    t = parse_blender(BlenderDataParserConfig(data=tmp_path, scale_factor=0.5, alpha_color=alpha_color))
    assert [str(p) for p in t.image_filenames] == [str(p) for p in j.image_filenames]
    jc, tc = j.cameras, t.cameras
    _close(tc.camera_to_worlds.numpy(), np.asarray(jc.camera_to_worlds), rtol=0, atol=1e-6)
    for k in ("fx", "fy", "cx", "cy", "width", "height"):
        _close(getattr(tc, k).numpy(), np.asarray(getattr(jc, k)).reshape(-1), rtol=1e-6, atol=0)
    assert t.metadata == {"height": 10, "width": 14} == j.metadata
    assert np.array_equal(t.scene_box.aabb, np.asarray(j.scene_box.aabb))
    assert (t.scene_box.near, t.scene_box.far, t.scene_box.collider_type) == (2.0, 6.0, "near_far")
    assert np.array_equal(t.alpha_color, np.asarray(j.alpha_color))
    np.testing.assert_array_equal(stack_images(t)["image"], np.asarray(JDM._stack(j)["image"]))
    with pytest.raises(FileNotFoundError):
        parse_blender(BlenderDataParserConfig(data=tmp_path), "val")


def test_phototourism_parser_matches_jax():
    from sdfstudio_tpu.data.dataparsers.colmap_family import Phototourism as JPhototourism
    from sdfstudio_tpu.data.dataparsers.colmap_family import PhototourismDataParserConfig as JPDC

    from sdfstudio_tpu_torch.data.dataparsers.colmap_family import (Mipnerf360DataParserConfig,
                                                                    PhototourismDataParserConfig,
                                                                    parse_mipnerf360)

    assert issubclass(PhototourismDataParserConfig, Mipnerf360DataParserConfig)
    assert str(PhototourismDataParserConfig().data) == str(JPDC().data)
    for split in ("train", "val"):
        j = JPhototourism(JPDC(data=HERITAGE)).get_dataparser_outputs(split)
        t = parse_mipnerf360(PhototourismDataParserConfig(data=HERITAGE), split)
        assert [str(p) for p in t.image_filenames] == [str(p) for p in j.image_filenames]
        _close(t.cameras.camera_to_worlds.numpy(), np.asarray(j.cameras.camera_to_worlds), rtol=0,
               atol=1e-6)
        for k in ("fx", "fy", "cx", "cy", "width", "height"):
            assert np.array_equal(getattr(t.cameras, k).numpy(),
                                  np.asarray(getattr(j.cameras, k)).reshape(-1)), k
        assert np.array_equal(t.scene_box.aabb, np.asarray(j.scene_box.aabb))
        assert abs(t.metadata["scale"] - j.metadata["scale"]) <= 1e-6 * j.metadata["scale"]
