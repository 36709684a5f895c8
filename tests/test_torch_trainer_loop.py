"""The trainer's loop, its accumulated step, the in-loop and final
evaluation's pieces and the eval / extract-mesh scripts against the JAX
package, on the CPU.

- Cadences: JAX's ``Trainer.train`` (its ``_train_windows`` and its
  ``crossed``) and the port's, each driven with a stand-in step that only
  counts, take their log rows, eval images (``RandomState(step)``'s index),
  checkpoints, deferred end-of-run work and ctrl+c checkpoint at the same
  steps.
- ``accumulate_grad_steps = 2``: one step of a small ``neus-facto-tpu-p8``
  through JAX's ``_train_step_impl`` (its ``lax.scan`` over the two
  sub-batches) and through the port's ``Trainer.train_step``, on the same
  rays and without jitter; JAX's optimizer is replaced by ``scale(1000)``,
  so that its update returns the gradient, and the port's update is
  recorded. Losses to 1e-4 relative, every gradient to 5e-4 of its scale,
  as ``tests/test_torch_train.py`` holds one step.
- LPIPS on the same images and the same weights file: 1e-5; the port's
  ``make_weights`` writes JAX's arrays bit for bit.
- ``final_eval_max_images``: the views JAX's ``eval_all_images`` scores.
- The sphere judge on the same vertices: 1e-6. The sphere scene: the same
  pixels, cues and ``meta_data.json`` as JAX's generator writes.
- ``scripts/eval.py`` writes JAX's JSON keys (with ``lpips_rand`` under
  ``SST_LPIPS_WEIGHTS``); ``scripts/extract_mesh.py``'s PLY holds the
  vertices of the port's marching tetrahedra on the same grid.
"""
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sdfstudio_tpu.engine.trainer import Trainer as JTrainer
from sdfstudio_tpu.engine.trainer import TrainState
from sdfstudio_tpu.engine.trainer import TrainerConfig as JTrainerConfig

from sdfstudio_tpu_torch.data.png import read_png
from sdfstudio_tpu_torch.data.synthetic import generate_sphere_dataset
from sdfstudio_tpu_torch.engine import final_eval as tfinal
from sdfstudio_tpu_torch.engine import trainer as ttrainer
from sdfstudio_tpu_torch.engine.trainer import Trainer, TrainerConfig
from sdfstudio_tpu_torch.scripts import eval as eval_script
from sdfstudio_tpu_torch.scripts import extract_mesh as mesh_script
from sdfstudio_tpu_torch.scripts import train as train_script
from sdfstudio_tpu_torch.scripts.benchmarking.eval_geometry import chamfer_l1_to_sphere
from sdfstudio_tpu_torch.scripts.make_lpips_weights import make_weights
from sdfstudio_tpu_torch.utils import writer as writer_lib
from sdfstudio_tpu_torch.utils.metrics import lpips, lpips_metric_name
from tests.test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

NUM_EVAL = 7


# --- the loop's cadences --------------------------------------------------------


def _jax_crossed():
    """JAX's ``crossed``, a function local to ``Trainer.train`` (trainer.py:602)."""
    code = next(c for c in JTrainer.train.__code__.co_consts
                if isinstance(c, types.CodeType) and c.co_name == "crossed")
    return types.FunctionType(code, {})


class _Writer(writer_lib.Writer):
    def __init__(self, events):
        super().__init__(None)
        self.events = events

    def put_scalar(self, name, value, step):
        super().put_scalar(name, value, step)
        if name == writer_lib.ITER_TRAIN_TIME:
            self.events.append(("log", step))


class _JaxLoop(JTrainer):
    """JAX's loop with a stand-in step (it only counts) and recorded evals and saves."""

    def __init__(self, config, start, events, stop_at=None):
        self.config, self.events, self.stop_at = config, events, stop_at
        self.state = types.SimpleNamespace(params=jnp.zeros(()))
        self._host_step = self._count = start
        self._dyn_num_rays, self.viewer_state, self.optimizer_groups = None, None, {}
        self._metric_keys = ["loss"]
        self.datamanager = types.SimpleNamespace(
            num_eval_images=NUM_EVAL, maybe_resample=lambda step: None,
            config=types.SimpleNamespace(train_num_rays_per_batch=64))
        self.writer = _Writer(events)

    def _train_step(self, state, rng=None):
        if self._count == self.stop_at:
            raise KeyboardInterrupt
        self._count += 1
        return state, np.zeros(1, np.float32)

    def eval_image_metrics(self, camera_index):
        self.events.append(("eval", self._count, camera_index))
        return {"psnr": 1.0, "ssim": 1.0}

    def save_checkpoint(self, step):
        self.events.append(("save", step))


class _PortLoop(Trainer):
    def __init__(self, config, start, events, base_dir, stop_at=None):
        # the loop rotates the subset image cache after each step, as JAX's stand-in allows
        dm = types.SimpleNamespace(num_eval_images=NUM_EVAL, maybe_resample=lambda step: None,
                                   config=types.SimpleNamespace(train_num_rays_per_batch=64))
        super().__init__(config, None, dm, {}, base_dir=base_dir, writer=_Writer(events))
        self.step, self.events, self.stop_at = start, events, stop_at
        self.metric_keys = ["loss"]

    def train_step(self):
        if self.step == self.stop_at:
            raise KeyboardInterrupt
        self.step += 1
        return torch.zeros(1)

    def eval_image_metrics(self, camera_index):
        self.events.append(("eval", self.step, camera_index))
        return {"psnr": 1.0, "ssim": 1.0}

    def save_checkpoint(self, step):
        self.events.append(("save", step))


# (steps_per_log, steps_per_eval_image, steps_per_save, start, max_num_iterations, defer, ctrl+c at)
CADENCES = [
    (3, 4, 5, 0, 17, False, None),
    (10, 5000, 20000, 0, 40, False, None),  # the presets' cadences over the smoke's 40 steps
    (2, 3, 7, 6, 20, False, None),  # a resumed run
    (4, 5, 6, 0, 13, True, None),  # deferred: one checkpoint and one eval image at the end
    (5, 0, 4, 3, 11, False, None),  # no eval images
    (3, 4, 5, 0, 17, False, 9),  # ctrl+c before step 10: the last completed step is saved
]


@pytest.mark.parametrize("log,ev,save,start,end,defer,stop", CADENCES)
def test_loop_cadences_match_jax(log, ev, save, start, end, defer, stop, tmp_path):
    kw = dict(steps_per_log=log, steps_per_eval_image=ev, steps_per_save=save,
              max_num_iterations=end, defer_heavy_ops=defer)
    ref, got = [], []
    _JaxLoop(JTrainerConfig(**kw), start, ref, stop).train()
    port = _PortLoop(TrainerConfig(**kw), start, got, tmp_path, stop)
    port.train()
    assert got == ref and ref
    assert crossed_matches()
    assert port.interrupted_step == stop
    evals = [e for e in got if e[0] == "eval"]
    assert all(i == ttrainer.eval_image_index(s, NUM_EVAL) for _, s, i in evals)


def crossed_matches():
    crossed = _jax_crossed()
    return all(ttrainer.crossed(c, lo, hi) == crossed(c, lo, hi)
               for c in (0, 1, 3, 10, 5000) for lo in range(0, 30, 3) for hi in range(lo, lo + 12))


# --- gradient accumulation ------------------------------------------------------


def test_accumulated_step_matches_jax_scan(tmp_path, monkeypatch):
    from sdfstudio_tpu.data.datamanager import DataManagerConfig as JDataManagerConfig
    from sdfstudio_tpu.data.datamanager import VanillaDataManager as JVanillaDataManager
    from sdfstudio_tpu.data.dataparsers.sdfstudio import SDFStudio, SDFStudioDataParserConfig
    from sdfstudio_tpu.parallel import mesh as mesh_lib

    from sdfstudio_tpu_torch.configs.methods import get_method_config
    from sdfstudio_tpu_torch.data.datamanager import DataManagerConfig, VanillaDataManager
    from sdfstudio_tpu_torch.data.dataparsers.sdfstudio import parse
    from tests.test_torch_train import NUM_IMAGES, _port_tree, _small_models

    R, A = 16, 2
    jmodel, jparams, np_params, tmodel, method = _small_models("neus-facto-tpu-p8")
    scene = generate_sphere_dataset(tmp_path / "sphere", num_images=NUM_IMAGES, width=12, height=10)
    rng = np.random.default_rng(3)
    idx = np.stack([rng.integers(0, NUM_IMAGES, R * A), rng.integers(0, 10, R * A),
                    rng.integers(0, 12, R * A)], -1)

    # JAX: _train_step_impl with its scan over the sub-batches, no jitter
    jdm = JVanillaDataManager(JDataManagerConfig(train_num_rays_per_batch=R),
                              SDFStudio(SDFStudioDataParserConfig(data=scene)).get_dataparser_outputs())
    jdm.sample_train_batch = lambda rng, num_rays=None, data=None: (
        jnp.asarray(idx, jnp.int32), {k: v[idx[:, 0], idx[:, 1], idx[:, 2]] for k, v in data.items()})
    get_outputs, get_loss_dict = jmodel.get_outputs, jmodel.get_loss_dict
    jmodel.get_outputs = lambda p, rb, rng=None, **kw: get_outputs(p, rb, rng=None, **kw)
    jmodel.get_loss_dict = lambda p, out, batch, sched, rng=None: get_loss_dict(p, out, batch, sched, None)
    jt = JTrainer(JTrainerConfig(accumulate_grad_steps=A), jmodel, jdm, {}, tmp_path / "jax",
                  mesh=mesh_lib.create_mesh(jax.devices()[:1]))
    jt.tx = optax.scale(1000.0)  # the update is 1000 x the gradient
    params = jparams
    state = TrainState(step=jnp.asarray(0, jnp.int32), params=params, opt_state=jt.tx.init(params),
                       rng=jax.random.PRNGKey(0))
    new_state, vec = jax.jit(jt._train_step_impl)(state, jdm.train_data, jdm.train_cameras)
    ref_g = _port_tree(jax.tree_util.tree_map(lambda a, b: (np.asarray(a) - np.asarray(b)) / 1000.0,
                                              new_state.params, params))
    ref = dict(zip(jt._metric_keys, np.asarray(vec)))

    # the port: Trainer.train_step with accumulate_grad_steps = 2, no jitter
    tdm = VanillaDataManager(DataManagerConfig(train_num_rays_per_batch=R), parse(scene), device="cpu")
    tidx = torch.from_numpy(idx)
    tdm.sample_train_batch = lambda gen, num_rays=None: (
        tidx, {k: v[tidx[:, 0], tidx[:, 1], tidx[:, 2]] for k, v in tdm.train_data.items()})
    states = []
    t_outputs = tmodel.get_outputs

    def outputs(rb, sched=None, train=False, rng=None, **kw):
        states.append(rng.get_state().clone())
        return t_outputs(rb, sched=sched, train=train, rng=None, **kw)

    monkeypatch.setattr(tmodel, "get_outputs", outputs)
    monkeypatch.setattr(tmodel, "get_loss_dict",
                        lambda out, batch, sched, rng=None: type(tmodel).get_loss_dict(tmodel, out, batch, sched, None))
    seen = {}
    monkeypatch.setattr(ttrainer, "apply_grads", lambda opts, grads, sched: seen.update(grads))
    tt = Trainer(TrainerConfig(accumulate_grad_steps=A), tmodel, tdm,
                 get_method_config(method).optimizers)
    tt.setup()
    vec_t = tt.train_step()
    got = dict(zip(tt.metric_keys, vec_t.tolist()))
    assert len(states) == A and torch.equal(states[0], states[1])  # one generator state a sub-batch
    for k in ("loss", "rgb_loss", "eikonal_loss", "interlevel_loss"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=0)
    n = 0
    for group, opt in tt.optimizers.items():
        for name, g in zip(opt.names, seen[group]):
            r = ref_g[name]
            if g is None:  # no part in the loss: JAX's gradient is exactly zero
                assert not np.any(r), name
                continue
            scale = float(np.abs(r).max())
            assert scale > 0, name
            assert float(np.abs(g.numpy() - r).max()) <= 5e-4 * scale, name
            n += 1
    assert n >= 20


# --- LPIPS, the final eval's spread, the sphere judge and scene ---------------------


def test_lpips_matches_jax(tmp_path):
    from sdfstudio_tpu.scripts.make_lpips_weights import make_weights as jmake_weights
    from sdfstudio_tpu.utils import metrics as jmetrics

    mine, ref = make_weights(0), jmake_weights(0)
    assert mine.keys() == ref.keys()
    for k in ref:
        assert np.asarray(mine[k]).dtype == np.asarray(ref[k]).dtype and np.array_equal(mine[k], ref[k]), k
    path = tmp_path / "lpips.npz"
    np.savez(path, **mine)
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (40, 56, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1).astype(np.float32)
    expected = float(jmetrics.lpips(jnp.asarray(a), jnp.asarray(b), weights_path=str(path)))
    got = float(lpips(torch.from_numpy(a), torch.from_numpy(b), weights_path=str(path)))
    assert expected > 0 and abs(got - expected) <= 1e-5
    assert lpips_metric_name(path) == jmetrics.lpips_metric_name(path) == "lpips_rand"
    assert lpips(torch.from_numpy(a), torch.from_numpy(b)) is None  # no weights: no metric


def test_final_eval_max_images_takes_jax_views(monkeypatch):
    from sdfstudio_tpu.engine import final_eval as jfinal

    def stub(n, record):
        dm = types.SimpleNamespace(num_eval_images=n, eval_cameras=None, train_cameras=None)
        dm.eval_image_data = lambda i: record.append(i) or {"image": np.zeros((12, 12, 3), np.float32)}
        dm.eval_image_rays = lambda i: jnp.zeros((144, 3))
        return dm

    monkeypatch.setattr(tfinal, "render_image",
                        lambda model, cams, i, chunk=None, step=None, **kw: {"rgb": torch.zeros(12, 12, 3)})
    for n, k in [(49, 3), (49, 0), (7, 10), (10, 4), (5, 1), (49, 49)]:
        ref, got = [], []
        jt = types.SimpleNamespace(
            datamanager=stub(n, ref), model=types.SimpleNamespace(
                config=types.SimpleNamespace(eval_num_rays_per_chunk=1024)),
            state=types.SimpleNamespace(step=jnp.asarray(5), params={}, model_state=None),
            _render_chunk_impl=lambda p, rb, step, ms: {"rgb": jnp.zeros((rb.shape[0], 3))})
        jout = jfinal.eval_all_images(jt, max_images=k)
        dm = stub(n, got)
        dm.eval_image_data = (lambda rec: lambda i: rec.append(i) or {"image": torch.zeros(12, 12, 3)})(got)
        tt = types.SimpleNamespace(datamanager=dm, step=5, model=types.SimpleNamespace(
            config=types.SimpleNamespace(eval_num_rays_per_chunk=1024)))
        tout = tfinal.eval_all_images(tt, max_images=k)
        assert got == ref and tout["num_images"] == jout["num_images"] == len(ref), (n, k)


def test_sphere_judge_matches_jax():
    from sdfstudio_tpu.scripts.benchmarking.eval_geometry import chamfer_l1_to_sphere as jjudge

    rng = np.random.default_rng(0)
    v = rng.standard_normal((3000, 3))
    v = v / np.linalg.norm(v, axis=1, keepdims=True) * (0.5 + 0.02 * rng.standard_normal((3000, 1)))
    ref, got = jjudge(v, radius=0.5), chamfer_l1_to_sphere(v, radius=0.5)
    assert got.keys() == ref.keys()
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-6, k


def test_sphere_scene_matches_jax(tmp_path):
    from PIL import Image

    from sdfstudio_tpu.data.synthetic import generate_sphere_dataset as jgenerate

    kw = dict(num_images=3, width=24, height=20, with_pairs=True)
    jdir, tdir = jgenerate(tmp_path / "jax", **kw), generate_sphere_dataset(tmp_path / "port", **kw)
    assert json.loads((jdir / "meta_data.json").read_text()) == json.loads(
        (tdir / "meta_data.json").read_text())
    assert (jdir / "pairs.txt").read_text() == (tdir / "pairs.txt").read_text()
    names = sorted(p.name for p in jdir.iterdir())
    assert names == sorted(p.name for p in tdir.iterdir())
    for name in names:
        if name.endswith(".png"):
            ref = np.asarray(Image.open(jdir / name))
            assert np.array_equal(read_png(tdir / name), ref), name
            assert np.array_equal(np.asarray(Image.open(tdir / name)), ref), name
        elif name.endswith(".npy"):
            assert np.array_equal(np.load(tdir / name), np.load(jdir / name)), name


def test_writer_put_image_and_row(tmp_path, capsys):
    w = writer_lib.Writer(tmp_path)
    img = np.random.default_rng(0).uniform(-0.2, 1.2, (6, 5, 3))
    path = w.put_image("eval/rgb", img, 7)
    assert path == tmp_path / "images" / "eval_rgb_000000007.png"
    assert np.array_equal(read_png(path), (np.clip(img, 0, 1) * 255).astype(np.uint8))
    w.put_scalar(writer_lib.ITER_TRAIN_TIME, 2.0, 1)
    w.put_scalar(writer_lib.TRAIN_RAYS_PER_SEC, 1024.0, 1)
    w.print_row(2, 5, {"loss": 0.5})
    assert capsys.readouterr().out.strip() == "step 2/5  loss=0.5  rays/s=1,024  eta=00:00:06"


# --- the scripts on a trained run ----------------------------------------------------


def test_eval_and_extract_mesh_scripts(tmp_path, monkeypatch):
    from sdfstudio_tpu_torch.engine.setup import eval_setup
    from sdfstudio_tpu_torch.utils.marching_cubes import evaluate_sdf_grid, marching_tetrahedra

    scene = generate_sphere_dataset(tmp_path / "sphere", num_images=4, width=16, height=16)
    assert train_script.main(
        ["neus-facto-tpu-p4", "--experiment-name", "x", "--output-dir", str(tmp_path / "D"),
         "--timestamp", "t", "--vis", "none", "--trainer.max-num-iterations", "2",
         "--datamanager.train-num-rays-per-batch", "16", "--model.num-proposal-samples-per-ray",
         "(16,8)", "--model.num-neus-samples-per-ray", "8", "--device", "cpu", "sdfstudio-data",
         "--data", str(scene), "--skip-every-for-val-split", "2"]) == 0
    config = tmp_path / "D" / "x" / "neus-facto-tpu-p4" / "t" / "config.yml"
    weights = tmp_path / "lpips.npz"
    np.savez(weights, **make_weights(0))
    monkeypatch.setenv("SST_LPIPS_WEIGHTS", str(weights))
    assert eval_script.main(["--load-config", str(config), "--output-path", str(tmp_path / "e.json"),
                             "--device", "cpu"]) == 0
    rec = json.loads((tmp_path / "e.json").read_text())
    # sdfstudio_tpu/scripts/eval.py:34-41
    assert set(rec) == {"experiment_name", "method_name", "checkpoint", "results", "num_images",
                        "seconds"}
    assert set(rec["results"]) == {"psnr", "ssim", "lpips_rand"} and rec["num_images"] == 2
    assert (rec["experiment_name"], rec["method_name"]) == ("x", "neus-facto-tpu-p4")
    monkeypatch.delenv("SST_LPIPS_WEIGHTS")

    res = 16
    assert mesh_script.main(["--load-config", str(config), "--output-path", str(tmp_path / "m.ply"),
                             "--resolution", str(res), "--device", "cpu"]) == 0
    header = (tmp_path / "m.ply").read_bytes().split(b"end_header")[0].decode()
    n_vertices = int(header.split("element vertex ")[1].split()[0])
    _, trainer = eval_setup(config, device="cpu")
    lo, hi = np.full(3, -1.0, np.float32), np.full(3, 1.0, np.float32)
    grid = evaluate_sdf_grid(trainer.model.field.sdf, res, lo, hi, "cpu")
    expected = marching_tetrahedra(grid, 0.0, origin=lo, spacing=(hi - lo) / (res - 1))
    assert n_vertices == len(expected.merge_close_vertices().vertices) > 0
    with pytest.raises(NotImplementedError, match="item 14"):
        mesh_script.main(["--load-config", str(config), "--use-contraction", "--device", "cpu"])
