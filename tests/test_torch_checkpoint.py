"""The committed 20k checkpoints, read and rendered by JAX and by the port.

The JAX side builds its trainer from the method config, with the parity
scene resolved against the repository root (the run's ``config.yml`` holds
absolute paths of the machine that trained it), and restores the packed
train state through the trainer's own loader. The port takes the restored
``params`` through ``params_from_jax``. Both render the same 16 rays of eval
view 0 at the checkpoint's step. Nothing is written into the tree: the
trainer's output directory is the test's temporary directory.

Tolerance: for p8 the slice tolerance of tests/test_torch_model.py (3e-4
on rgb, accumulation and normal; depth compared weighted by accumulation),
for the same reason: sample positions agree to a few f32 ulps of the ray
distance, not to the bit, and NeuS alpha scales a position change by inv_s
|grad sdf|. ``neus-facto``'s smoothstep hash grid has a continuous
jacobian and renders these rays within ~1e-5 of JAX, so it is held to
1e-4 throughout.

The port's numpy reader of packed checkpoints (``utils/jax_checkpoint.py``)
is held to the JAX trainer's restore of both committed 20k checkpoints (the
p8 carrier and the ``neus-facto`` control) leaf for leaf: the same paths in
the same order and the same bits. A port trainer resumed from each directory
(``Trainer.load_checkpoint``, through ``load_jax_checkpoint``) renders the
same rays as JAX, and its Adam state is bit for bit what
``opt_state_from_jax`` makes of JAX's own restore.
"""
import json
import pathlib

import jax
import numpy as np
import pytest
import torch
from tests.test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = pathlib.Path(__file__).resolve().parents[1]
SCENE = REPO / ".parity" / "dtu_like"
RUNS = {m: REPO / f".parity/runs/parity/{m}/parity/sdfstudio_models"
        for m in ("neus-facto-tpu-p8", "neus-facto")}
RUN = RUNS["neus-facto-tpu-p8"]
STEP = 20000
TOL = 3e-4


def _jax_restore(method, out_dir):
    """The JAX trainer of ``method``, restored from its committed 20k checkpoint."""
    if not (RUNS[method] / f"step-{STEP:09d}" / "packed.npz").exists():
        pytest.fail(f"committed checkpoint missing under {RUNS[method]}")
    from sdfstudio_tpu.configs.methods import get_method_config
    from sdfstudio_tpu.engine.setup import setup_trainer

    config = get_method_config(method)
    config.data = SCENE
    config.output_dir = out_dir
    trainer = setup_trainer(config, test_mode=True)
    trainer.setup()
    trainer._load_checkpoint(RUNS[method], STEP)
    return trainer


@pytest.fixture(scope="module")
def jax_restored(tmp_path_factory):
    """``method`` -> the JAX trainer restored from its committed checkpoint, made once."""
    cache = {}

    def get(method):
        if method not in cache:
            cache[method] = _jax_restore(method, tmp_path_factory.mktemp("ckpt"))
        return cache[method]

    return get


@pytest.fixture(scope="module")
def port_resumed():
    """``method`` -> the port's trainer on the CPU resumed from the JAX
    checkpoint, made once."""
    from sdfstudio_tpu_torch.scripts.train import setup_method_trainer

    cache = {}

    def get(method):
        if method not in cache:
            cache[method] = setup_method_trainer(method, SCENE, num_rays=64, device="cpu",
                                                 load_dir=RUNS[method], load_step=STEP)
        return cache[method]

    return get


def _state(trainer):
    return {"params": trainer.state.params, "opt_state": trainer.state.opt_state,
            "model_state": trainer.state.model_state, "rng": trainer.state.rng}


@pytest.mark.parametrize("method", sorted(RUNS))
def test_packed_reader_matches_the_jax_loader_leaf_for_leaf(method, jax_restored):
    """``read_packed`` (numpy only) against the JAX trainer's restore: the
    same leaf paths in flatten order, and each leaf's dtype, shape and bits."""
    from sdfstudio_tpu_torch.utils.jax_checkpoint import read_packed

    trainer = jax_restored(method)
    ref = jax.tree_util.tree_flatten_with_path(_state(trainer))[0]
    tree, leaves = read_packed(RUNS[method] / f"step-{STEP:09d}")
    assert [p for p, _ in leaves] == [jax.tree_util.keystr(p) for p, _ in ref]
    assert len(leaves) == {"neus-facto-tpu-p8": 112, "neus-facto": 106}[method]
    for (path, ours), (_, theirs) in zip(leaves, ref):
        theirs = np.asarray(theirs)
        assert ours.dtype == theirs.dtype and ours.shape == theirs.shape, path
        assert ours.tobytes() == theirs.tobytes(), path
    # the tree is rebuilt with optax's field names
    chain = tree["opt_state"].inner_states["field"].inner_state
    assert int(chain[0].count) == int(chain[1].count) == STEP
    masked = tree["opt_state"].inner_states["field_background"].inner_state[0].mu["field"]
    assert type(masked["deviation"]).__name__ == "MaskedNode"


def test_packed_reader_refuses_what_it_does_not_know(tmp_path):
    import shutil

    from sdfstudio_tpu_torch.utils.jax_checkpoint import parse_treedef, read_packed

    with pytest.raises(ValueError, match="unknown node type OtherState"):
        parse_treedef("PyTreeDef({'a': CustomNode(namedtuple[OtherState], [*])})")
    src = RUN / f"step-{STEP:09d}"
    dst = tmp_path / "step"
    dst.mkdir()
    shutil.copy(src / "packed.npz", dst / "packed.npz")
    meta = json.loads((src / "structure.json").read_text())
    meta["leaves"][3]["shape"] = [meta["leaves"][3]["shape"][0] + 1]
    (dst / "structure.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="floats holds|float_idx holds"):
        read_packed(dst)
    meta = json.loads((src / "structure.json").read_text())
    meta["treedef"] = meta["treedef"].replace("'rng': *", "'rng': None")
    (dst / "structure.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="treedef has 111 leaves"):
        read_packed(dst)


@pytest.mark.parametrize("method", sorted(RUNS))
def test_port_resumes_from_the_jax_checkpoint_with_its_adam_state(method, jax_restored,
                                                                  port_resumed):
    from sdfstudio_tpu_torch.engine.optimizers import build_optimizers
    from sdfstudio_tpu_torch.utils.convert import opt_state_from_jax

    restored, port_resumed = jax_restored(method), port_resumed(method)
    assert port_resumed.step == STEP
    ref = build_optimizers(port_resumed.optimizer_groups, port_resumed.model)
    opt_state_from_jax(ref, jax.tree_util.tree_map(np.asarray, restored.state.opt_state))
    for name, opt in port_resumed.optimizers.items():
        assert opt.count == ref[name].count == STEP
        for a, b in zip(opt.mu + opt.nu, ref[name].mu + ref[name].nu):
            assert torch.equal(a, b), name
    params = dict(port_resumed.model.named_parameters())
    table = np.asarray(restored.state.params["field"]["encoding"]["hash_table"])
    assert np.array_equal(params["field.encoding.hash_table"].detach().numpy(), table)
    if method == "neus-facto":  # the hash proposal fields' tables
        for i in ("0", "1"):
            ref = restored.state.params["proposal_networks"][i]["HashEncoding_0"]["hash_table"]
            got = params[f"proposal_networks.{i}.encoding.hash_table"].detach().numpy()
            assert np.array_equal(got, np.asarray(ref))


@pytest.mark.parametrize("method", sorted(RUNS))
def test_checkpoint_renders_the_same_in_jax_and_the_port(method, jax_restored, port_resumed):
    from sdfstudio_tpu_torch.core.rays import RayBundle

    trainer, port_resumed = jax_restored(method), port_resumed(method)
    assert int(trainer.state.step) == STEP
    bundle = trainer.datamanager.eval_image_rays(0)
    # 16 pixels across the centre row of the 384x384 view
    sel = 192 * 384 + np.arange(0, 384, 24)
    jb = jax.tree_util.tree_map(
        lambda x: x[sel] if hasattr(x, "ndim") and x.ndim >= 1 and x.shape[0] == 384 * 384 else x,
        bundle,
    )
    ref = trainer._render_chunk(trainer.state.params, jb, float(STEP), None)

    # the port's model, loaded through load_jax_checkpoint by the trainer's resume
    model = port_resumed.model

    def t(x):
        return torch.from_numpy(np.array(x))

    tb = RayBundle(
        origins=t(jb.origins), directions=t(jb.directions), pixel_area=t(jb.pixel_area),
        camera_indices=t(jb.camera_indices).long(), directions_norm=t(jb.directions_norm),
    )
    with torch.no_grad():
        out = model.get_outputs(tb, sched=model.schedules(port_resumed.step))

    tol = TOL if method == "neus-facto-tpu-p8" else 1e-4
    acc = np.asarray(ref["accumulation"])
    assert acc.max() > 0.9, "the rays should hit the scene"
    for k in ("rgb", "accumulation"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=0, atol=tol, err_msg=k)
    np.testing.assert_allclose(out["depth"].numpy() * out["accumulation"].numpy(),
                               np.asarray(ref["depth"]) * acc, rtol=0, atol=4.0 * tol)
    # The analytic gradient of p8's piecewise-linear encode jumps at simplex
    # faces (cells of 1/512 of the box at the finest level): a sample that
    # sits within the ~6e-6 position disagreement of a face takes the other
    # side's jacobian, which moves that sample's normal by the jump times its
    # weight. Normals are therefore held to 2e-3 end to end, and to the
    # field's own 1e-4 on identical samples below. The hash grid's
    # smoothstep jacobian is continuous: neus-facto's normals take 1e-4.
    np.testing.assert_allclose(out["normal"].numpy(), np.asarray(ref["normal"]), rtol=0,
                               atol=2e-3 if method == "neus-facto-tpu-p8" else tol)

    jm = trainer.model
    sched = jm.schedules(float(STEP))

    @jax.jit
    def jax_field(params, rb):
        s = jm.sample_and_forward_field(params, jm.apply_collider(rb, train=False), None, sched,
                                        False)
        return s["ray_samples"].starts, s["ray_samples"].ends, s["field_outputs"]

    starts, ends, jf = jax_field(trainer.state.params, jb)
    ts = tb.get_ray_samples(t(np.concatenate([np.asarray(starts), np.asarray(ends)[:, -1:]], -1)))
    with torch.no_grad():
        tf = model.field.get_outputs(ts, cos_anneal_ratio=float(sched["cos_anneal_ratio"]),
                                     return_alphas=True)
    for k in ("sdf", "rgb", "gradient", "normal", "alpha"):
        np.testing.assert_allclose(tf[k].numpy(), np.asarray(jf[k]), rtol=1e-4, atol=1e-4, err_msg=k)
