"""The port's hash-grid encode (``ops/hash_grid.py``, ``HashEncoding``) and
hash proposal field against the JAX package, on the same numpy inputs.

JAX runs on the CPU, where ``table_gather``'s backward is its scatter-add
(encodings.py:235-237). The grids are small: 4 levels of 2^10 rows at
resolutions 4-32 (two dense levels, two hashed), and an all-dense grid whose
far corner at x = 1.0 reads past the table. Points include 0, exactly 1.0
and cell faces.

Four features a level (``neus-facto-tpu``'s grid) have their own small
cases.

Tolerances, with their reasons:
- corner indices, level sizes and offsets: exact (integer arithmetic; the
  scaled position and its floor are the same f32 operations);
- feature and jacobian: 1e-6 of max |JAX| (the blend adds 8 products a
  level, in another order than XLA's reduction);
- table gradient: 1e-5 relative to max |JAX|; the scatter adds a row's
  updates in another order;
- the proposal field: 1e-5 relative, 1e-6 absolute, as the MLP proposal
  field's test in tests/test_torch_model.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdfstudio_tpu.fields.density_field import HashMLPDensityField as JHashMLPDensityField
from sdfstudio_tpu.ops.encodings import HashEncoding as JHashEncoding

from sdfstudio_tpu_torch.fields.density_field import HashMLPDensityField
from sdfstudio_tpu_torch.ops import hash_grid as hg
from sdfstudio_tpu_torch.ops.encodings import HashEncoding
from sdfstudio_tpu_torch.utils.convert import params_from_jax
from tests.test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

GRIDS = {
    "mixed": dict(num_levels=4, min_res=4, max_res=32, log2_hashmap_size=10),
    "dense": dict(num_levels=3, min_res=2, max_res=8, log2_hashmap_size=10),
}


def _points(n=300, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    x[:6] = [[0, 0, 0], [1, 1, 1], [1, 0.5, 0.25], [0.125, 1, 0.5], [0.25, 0.75, 0.0625],
             [1 / 32, 3 / 16, 1]]  # 0, 1.0, and faces of cells at every level
    return x


def _pair(grid, smoothstep, seed=0, F=2):
    kw = dict(GRIDS[grid], features_per_level=F)
    j, t = JHashEncoding(smoothstep=smoothstep, **kw), HashEncoding(smoothstep=smoothstep, **kw)
    table = np.random.default_rng(seed).uniform(-1.0, 1.0, (t.total_rows, F)).astype(np.float32)
    with torch.no_grad():
        t.hash_table.copy_(torch.from_numpy(table))
    return j, t, table


def _rel_max(port, ref):
    port, ref = np.asarray(port), np.asarray(ref)
    return float(np.abs(port - ref).max()) / float(np.abs(ref).max())


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_corner_indices_and_level_tables_match_jax_exactly(grid):
    j, t, _ = _pair(grid, False)
    np.testing.assert_array_equal(t.level_sizes, j.level_sizes)
    np.testing.assert_array_equal(t.level_offsets, j.level_offsets)
    assert t.total_rows == j.total_rows
    x = _points()
    ref_idx, ref_off = j.corner_indices(jnp.asarray(x))
    idx, off = hg.corner_indices(torch.from_numpy(x), t.spec)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(off.numpy(), np.asarray(ref_off))
    # at x = 1.0 the dense far corner runs past its level into the next one's rows
    far = idx[1, :, 7].numpy()
    dense_levels = [i for i, d in enumerate(t.spec.dense) if d]
    assert dense_levels and all(far[i] >= t.level_offsets[i + 1] for i in dense_levels)


@pytest.mark.parametrize("smoothstep", [True, False])
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_feature_and_jacobian_match_jax(grid, smoothstep):
    j, t, table = _pair(grid, smoothstep)
    x = _points()
    ref_out, ref_jac = j.apply({"params": {"hash_table": jnp.asarray(table)}}, jnp.asarray(x),
                               want_jac=True)
    with torch.no_grad():
        out, jac = t(torch.from_numpy(x), want_jac=True)
        out_only = t(torch.from_numpy(x))
    assert out.shape == (300, 2 * t.num_levels) and jac.shape == (300, 2 * t.num_levels, 3)
    # the all-dense grid's far corner at x = 1.0 reads past the table: NaN, as jnp.take fills
    np.testing.assert_array_equal(np.isnan(out.numpy()), np.isnan(np.asarray(ref_out)))
    np.testing.assert_array_equal(np.isnan(jac.numpy()), np.isnan(np.asarray(ref_jac)))
    assert bool(np.isnan(np.asarray(ref_out)).any()) == (grid == "dense")
    ok = ~np.isnan(np.asarray(ref_out)).any(-1)
    assert _rel_max(out.numpy()[ok], np.asarray(ref_out)[ok]) <= 1e-6
    assert _rel_max(jac.numpy()[ok], np.asarray(ref_jac)[ok]) <= 1e-6
    assert torch.equal(out_only, out) or bool(torch.isnan(out).any())
    if smoothstep:  # d smoothstep / d offset is 0 on a cell face: x = 0 has no jacobian
        assert float(jac[0].abs().max()) == 0.0


@pytest.mark.parametrize("want_jac", [True, False])
@pytest.mark.parametrize("smoothstep", [True, False])
def test_table_gradient_matches_jax_vjp(smoothstep, want_jac):
    """The plain backward from ``(g_out, g_jac)`` against ``jax.vjp`` of
    ``HashEncoding.apply`` over its params."""
    j, t, table = _pair("mixed", smoothstep)
    x = _points()
    rng = np.random.default_rng(5)
    L = t.num_levels
    g_out = rng.standard_normal((300, 2 * L)).astype(np.float32)
    g_jac = rng.standard_normal((300, 2 * L, 3)).astype(np.float32) if want_jac else None

    def fn(p):
        return j.apply({"params": p}, jnp.asarray(x), want_jac=want_jac)

    _, vjp = jax.vjp(fn, {"hash_table": jnp.asarray(table)})
    cot = (jnp.asarray(g_out), jnp.asarray(g_jac)) if want_jac else jnp.asarray(g_out)
    ref = np.asarray(vjp(cot)[0]["hash_table"])
    grad = hg.hash_encode_bwd_plain(torch.from_numpy(x), torch.from_numpy(g_out),
                                    torch.from_numpy(g_jac) if want_jac else None, t.spec,
                                    t.total_rows)
    assert grad.shape == ref.shape and float(np.abs(ref).max()) > 0
    assert _rel_max(grad.numpy(), ref) <= 1e-5


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_f4_indices_feature_and_jacobian_match_jax(grid):
    """Four features a level (neus-facto-tpu's L8xF4 grid, at a small size):
    the same corner indices exactly, feature and jacobian to 1e-6 of max."""
    j, t, table = _pair(grid, True, seed=2, F=4)
    x = _points()
    ref_idx, _ = j.corner_indices(jnp.asarray(x))
    idx, _ = hg.corner_indices(torch.from_numpy(x), t.spec)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    ref_out, ref_jac = j.apply({"params": {"hash_table": jnp.asarray(table)}}, jnp.asarray(x),
                               want_jac=True)
    with torch.no_grad():
        out, jac = t(torch.from_numpy(x), want_jac=True)
    assert out.shape == (300, 4 * t.num_levels) and jac.shape == (300, 4 * t.num_levels, 3)
    np.testing.assert_array_equal(np.isnan(out.numpy()), np.isnan(np.asarray(ref_out)))
    ok = ~np.isnan(np.asarray(ref_out)).any(-1)
    assert _rel_max(out.numpy()[ok], np.asarray(ref_out)[ok]) <= 1e-6
    assert _rel_max(jac.numpy()[ok], np.asarray(ref_jac)[ok]) <= 1e-6


def test_f4_table_gradient_matches_jax_vjp():
    """The plain backward at F = 4 from ``(g_out, g_jac)`` against
    ``jax.vjp`` of ``HashEncoding.apply``: 1e-5 of max."""
    j, t, table = _pair("mixed", True, seed=4, F=4)
    x = _points()
    rng = np.random.default_rng(6)
    L = t.num_levels
    g_out = rng.standard_normal((300, 4 * L)).astype(np.float32)
    g_jac = rng.standard_normal((300, 4 * L, 3)).astype(np.float32)
    _, vjp = jax.vjp(lambda p: j.apply({"params": p}, jnp.asarray(x), want_jac=True),
                     {"hash_table": jnp.asarray(table)})
    ref = np.asarray(vjp((jnp.asarray(g_out), jnp.asarray(g_jac)))[0]["hash_table"])
    grad = hg.hash_encode_bwd_plain(torch.from_numpy(x), torch.from_numpy(g_out),
                                    torch.from_numpy(g_jac), t.spec, t.total_rows)
    assert grad.shape == ref.shape == (t.total_rows, 4)
    assert _rel_max(grad.numpy(), ref) <= 1e-5


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_autograd_function_matches_autograd_through_the_plain_version(grid):
    """The autograd node on the CPU (forward and backward plain versions)
    against torch autograd through ``hash_encode_plain``'s indexing; gradient
    updates past the table's end are dropped by both."""
    _, t, table = _pair(grid, True)
    x = torch.from_numpy(_points())
    rng = np.random.default_rng(7)
    L = t.num_levels
    g_out = torch.from_numpy(rng.standard_normal((300, 2 * L)).astype(np.float32))
    g_jac = torch.from_numpy(rng.standard_normal((300, 2 * L, 3)).astype(np.float32))
    ref_table = torch.from_numpy(table).requires_grad_(True)
    out_r, jac_r = hg.hash_encode_plain(x, ref_table, t.spec, True)
    ok = ~torch.isnan(out_r).any(-1)  # rows that read past the table carry NaN
    loss_r = (out_r[ok] * g_out[ok]).sum() + (jac_r[ok] * g_jac[ok]).sum()
    (ref,) = torch.autograd.grad(loss_r, ref_table)
    out, jac = t(x, want_jac=True)
    loss = (out[ok] * g_out[ok]).sum() + (jac[ok] * g_jac[ok]).sum()
    (grad,) = torch.autograd.grad(loss, t.hash_table)
    assert torch.equal(out[ok], out_r[ok].detach()) and torch.equal(jac[ok], jac_r[ok].detach())
    assert float((grad - ref).abs().max()) <= 1e-6 * float(ref.abs().max())
    # only the feature's cotangent (a proposal field's case)
    (g1,) = torch.autograd.grad((t(x[ok]) * g_out[ok]).sum(), t.hash_table)
    ref1 = hg.hash_encode_bwd_plain(x[ok], g_out[ok], None, t.spec, t.total_rows)
    assert float((g1 - ref1).abs().max()) <= 1e-6 * float(ref1.abs().max())


def test_encode_refuses_an_x_that_requires_a_gradient_and_a_bad_table():
    """An x that requires a gradient now gets one (held to JAX's in
    ``tests/test_torch_camera_opt.py``); a bad table or x is still refused."""
    _, t, _ = _pair("mixed", True)
    x = torch.from_numpy(_points()).requires_grad_(True)
    out, jac = t(x, want_jac=True)
    (gx,) = torch.autograd.grad(out.sum() + jac.sum(), x)
    assert gx.shape == (300, 3) and bool(torch.isfinite(gx).all())
    with torch.no_grad():  # no graph
        assert t(x).shape == (300, 8)
    with pytest.raises(ValueError, match="float32"):
        hg.hash_encode(x.detach().double(), t.hash_table, t.spec)
    with pytest.raises(ValueError, match=r"x \[\.\.\., 3\]"):
        hg.hash_encode(x.detach()[:, :2], t.hash_table, t.spec)
    # the backward kernel's wrapper takes CUDA tensors only
    with pytest.raises(ValueError, match="CUDA"):
        hg.hash_encode_bwd(x.detach(), torch.zeros(300, 8), None, t.spec, t.total_rows)


@pytest.mark.parametrize("max_res", [64, 256])
def test_hash_proposal_field_matches_jax(max_res):
    """``HashMLPDensityField`` (hash grid without smoothstep, [10, 16, 1]
    MLP, trunc_exp) against JAX's, at the neus-facto proposal arguments with
    a smaller table, on contracted positions."""
    args = dict(hidden_dim=16, log2_hashmap_size=12, num_levels=5, max_res=max_res)
    aabb = np.array([[-1, -1, -1], [1, 1, 1]], np.float32)
    jf = JHashMLPDensityField(aabb=jnp.asarray(aabb), spatial_distortion="inf", **args)
    tf = HashMLPDensityField(aabb=aabb, spatial_distortion="inf", **args)
    assert not tf.encoding.spec.smoothstep
    params = jf.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    np_params = jax.tree_util.tree_map(
        lambda a: rng.uniform(-0.5, 0.5, np.shape(a)).astype(np.float32), params)
    params_from_jax(tf, np_params)
    pos = rng.uniform(-2.5, 2.5, (4, 91, 3)).astype(np.float32)
    ref = jf.density_fn(jax.tree_util.tree_map(jnp.asarray, np_params))(jnp.asarray(pos))
    with torch.no_grad():
        out = tf(torch.from_numpy(pos))
    assert out.shape == (4, 91)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
