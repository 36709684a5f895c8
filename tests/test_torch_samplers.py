"""The port's samplers against the JAX package in eval mode (``rng=None``).

Tolerances: bin edges are f32 interpolations of a cumulative sum, 1e-5.
``searchsorted_right`` decides integer bins; where a u value falls within an
ulp of a cdf knot the two frameworks may land on neighbouring bins, but the
interpolated edge is continuous across a knot, so the edge still agrees to
1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdfstudio_tpu.core.rays import RayBundle as JRayBundle
from sdfstudio_tpu.samplers import pdf as jpdf
from sdfstudio_tpu.samplers import proposal as jprop
from sdfstudio_tpu.samplers import spaced as jspaced

from sdfstudio_tpu_torch.core.rays import RayBundle as TRayBundle
from sdfstudio_tpu_torch.samplers import pdf as tpdf
from sdfstudio_tpu_torch.samplers import proposal as tprop
from sdfstudio_tpu_torch.samplers import spaced as tspaced
from tests.test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

F32 = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), **(tol or F32))


def _bundles(R=24, seed=0, near=0.8, far=4.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2.5, 2.5, (R, 3)).astype(np.float32)
    d = rng.standard_normal((R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pa = np.full((R, 1), 1e-4, np.float32)
    nears = np.full((R, 1), near, np.float32)
    fars = np.full((R, 1), far, np.float32)
    jb = JRayBundle(jnp.asarray(o), jnp.asarray(d), jnp.asarray(pa),
                    nears=jnp.asarray(nears), fars=jnp.asarray(fars))
    tb = TRayBundle(_t(o), _t(d), _t(pa), nears=_t(nears), fars=_t(fars))
    return jb, tb


def _same_samples(ts, js):
    for k in ("starts", "ends", "spacing_starts", "spacing_ends", "s_near", "s_far"):
        _close(getattr(ts, k), getattr(js, k))
    assert ts.spacing_kind == js.spacing_kind
    _close(ts.get_positions(), js.get_positions())
    _close(ts.get_start_positions(), js.get_start_positions())


@pytest.mark.parametrize("n", [16, 256])
def test_piecewise_sampler_matches_jax(n):
    jb, tb = _bundles()
    _same_samples(tspaced.uniform_lindisp_piecewise_sampler(tb, n),
                  jspaced.uniform_lindisp_piecewise_sampler(jb, n))


@pytest.mark.parametrize("num_samples,include_original", [(8, False), (96, False), (12, True)])
def test_sample_pdf_bins_matches_jax(num_samples, include_original):
    rng = np.random.default_rng(1)
    R, N = 24, 32
    bins = np.sort(rng.uniform(0, 1, (R, N + 1)), -1).astype(np.float32)
    w = rng.exponential(1.0, (R, N)).astype(np.float32)
    w[:4] = 0.0  # all-zero rows take the padding branch
    w[5, 10:] = 0.0
    ref = jpdf.sample_pdf_bins(jnp.asarray(bins), jnp.asarray(w), num_samples,
                               include_original=include_original)
    out = tpdf.sample_pdf_bins(_t(bins), _t(w), num_samples, include_original=include_original)
    _close(out, ref)


def test_pdf_sampler_and_merge_match_jax():
    jb, tb = _bundles(seed=2)
    js = jspaced.uniform_lindisp_piecewise_sampler(jb, 32)
    ts = tspaced.uniform_lindisp_piecewise_sampler(tb, 32)
    w = np.random.default_rng(3).exponential(1.0, (24, 32)).astype(np.float32)
    js2 = jpdf.pdf_sampler(jb, js, jnp.asarray(w), 16, include_original=False)
    ts2 = tpdf.pdf_sampler(tb, ts, _t(w), 16, include_original=False)
    _same_samples(ts2, js2)
    jm, jidx = jpdf.merge_ray_samples(jb, js, js2)
    tm, tidx = tpdf.merge_ray_samples(tb, ts, ts2)
    _same_samples(tm, jm)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))


@pytest.mark.parametrize("anneal", [1.0, 0.4545])
def test_proposal_sampler_matches_jax(anneal):
    """Two proposal rounds over an analytic density (a soft ball), eval mode."""
    jb, tb = _bundles(seed=4)

    def jdens(p):
        return 20.0 * jax.nn.sigmoid(20.0 * (0.5 - jnp.linalg.norm(p, axis=-1)))

    def tdens(p):
        return 20.0 * torch.sigmoid(20.0 * (0.5 - torch.linalg.vector_norm(p, dim=-1)))

    jrs, jws, jlist = jprop.proposal_network_sampler(
        jb, [jdens, jdens], rng=None, num_proposal_samples_per_ray=(64, 32),
        num_nerf_samples_per_ray=16, num_proposal_network_iterations=2, anneal=anneal,
        train_proposal=False, grad_gate="where",
    )
    trs, tws, tlist = tprop.proposal_network_sampler(
        tb, [tdens, tdens], num_proposal_samples_per_ray=(64, 32),
        num_nerf_samples_per_ray=16, num_proposal_network_iterations=2, anneal=anneal,
    )
    assert len(tws) == len(jws) == 2
    for tw, jw in zip(tws, jws):
        _close(tw, jw)
    for ts, js in zip(tlist, jlist):
        _same_samples(ts, js)
    if anneal == 1.0:
        _same_samples(trs, jrs)
    else:
        # weights = (1 - exp(-sigma delta)) T are quantised to multiples of
        # 2^-24 near zero, and XLA's and PyTorch's exp differ by an ulp there;
        # w ** 0.45 turns that one-ulp step (6e-8 vs 1.2e-7) into 5e-4 vs 7e-4
        # of histogram mass, which moves the last round's edges by up to ~1e-3
        # after the piecewise warp. The render path runs at anneal 1 (any step
        # past proposal_weights_anneal_max_num_iters).
        for k in ("starts", "ends", "spacing_starts", "spacing_ends"):
            _close(getattr(trs, k), getattr(jrs, k), rtol=0, atol=2e-3)
