"""The port's gather-probe slice against the JAX probes, on the CPU.

The JAX probes are used as they are. In this file only, ``pallas_call`` is
wrapped so that it builds its kernel in interpret mode and records the
callable it builds, and ``probe_gather2._scan_rate`` runs the probe's body
once: that builds ``probe_pallas_take`` / ``probe_pallas_loop``'s kernel,
which the tests then feed a random table and indices that include R. The
port's ``take`` / ``loop`` (their plain versions on the CPU) must match
bit for bit, NaN rows included: a gather is a copy.

``sorted_segment_add`` is held to JAX's at 1e-6 of the largest prefix sum
of the sorted updates (JAX takes each row as a difference of two prefix
sums, the port adds row by row; the two orders round differently). The
segment-add and sort probes, with their indices injected (JAX's PRNG and
torch's differ), must leave the same carry exactly: with updates and
payloads of ones every sum is an integer. Each port ``main`` runs at a small size on the CPU and its
printed lines are checked.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from sdfstudio_tpu.ops.scatter import sorted_segment_add as jsorted_segment_add
from sdfstudio_tpu.scripts.benchmarking import probe_gather2 as jprobe_gather2
from sdfstudio_tpu.scripts.benchmarking import probe_prims as jprobe_prims

from sdfstudio_tpu_torch.ops import row_gather as rg
from sdfstudio_tpu_torch.ops.launches import LAUNCHES
from sdfstudio_tpu_torch.ops.scatter import sorted_segment_add
from sdfstudio_tpu_torch.scripts.benchmarking import probe_gather2, probe_prims


@pytest.fixture
def pallas_kernels(monkeypatch):
    """The callables the JAX probes build with ``pallas_call``, interpreted."""
    built = []
    orig = pl.pallas_call

    def interpreted(*args, **kwargs):
        fn = orig(*args, **{**kwargs, "interpret": True})
        built.append(fn)
        return fn

    monkeypatch.setattr(pl, "pallas_call", interpreted)
    monkeypatch.setattr(jprobe_gather2, "_scan_rate",
                        lambda body, K, work, label: body(jnp.asarray(0.0)))
    return built


def _gather_inputs(M, R, F, seed):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((R, F)).astype(np.float32)
    idx = rng.integers(0, R + 1, M).astype(np.int32)  # the contract's range, R included
    idx[:3] = [R, 0, R - 1]
    return table, idx


@pytest.mark.parametrize("kind,M,R,F", [
    ("take", 4096, 64, 2),  # two grid steps of 2048 rows
    ("take", 2048, 128, 4),
    ("loop", 2048, 64, 2),  # two grid steps of 1024 rows
    ("loop", 1024, 32, 1),
])
def test_row_gather_matches_pallas_kernel_bit_for_bit(pallas_kernels, kind, M, R, F):
    probe = jprobe_gather2.probe_pallas_take if kind == "take" else jprobe_gather2.probe_pallas_loop
    probe(M, R, F, 1)
    assert len(pallas_kernels) == 1
    table, idx = _gather_inputs(M, R, F, seed=M + R + F)
    ref = np.asarray(pallas_kernels[0](jnp.asarray(idx), jnp.asarray(table)))
    before = dict(LAUNCHES)
    port = (rg.take if kind == "take" else rg.loop)(torch.from_numpy(table), torch.from_numpy(idx))
    assert LAUNCHES == before, "the CPU path launches no kernel and counts nothing"
    assert port.shape == ref.shape == (M, F) and port.dtype == torch.float32
    np.testing.assert_array_equal(port.numpy(), ref)  # NaN where NaN
    at_r = idx == R
    if kind == "take":
        assert np.isnan(ref[at_r]).all() and not np.isnan(ref[~at_r]).any()
    else:
        assert not np.isnan(ref).any()
        np.testing.assert_array_equal(ref[at_r], np.broadcast_to(table[R - 1], ref[at_r].shape))


def test_row_gather_wrappers_refuse_what_the_kernels_cannot_take():
    table, idx = torch.zeros(8, 2), torch.zeros(4, dtype=torch.int32)
    for fn in (rg.take, rg.loop):
        with pytest.raises(ValueError, match="float32 table and int32"):
            fn(table.double(), idx)
        with pytest.raises(ValueError, match="float32 table and int32"):
            fn(table, idx.long())
        with pytest.raises(ValueError, match="contiguous"):
            fn(torch.zeros(2, 8).t(), idx)
        with pytest.raises(ValueError, match="table \\[R, F\\] and idx \\[M\\]"):
            fn(table.reshape(-1), idx)
        with pytest.raises(ValueError, match="unsupported device"):
            fn(table.to("meta"), idx.to("meta"))
        assert fn(table, idx[:0]).shape == (0, 2)


@pytest.mark.parametrize("M,R,F", [(1000, 37, 2), (4096, 512, 3)])
def test_sorted_segment_add_matches_jax(M, R, F):
    """Indices in [0, R]: an update at R is dropped by both. JAX takes each
    row as a difference of two prefix sums of the sorted updates, so its
    rounding scales with the largest prefix sum, not with the row: 1e-6 of
    that (measured 5.5e-8 and 1.4e-7)."""
    rng = np.random.default_rng(M)
    idx = rng.integers(0, R + 1, M).astype(np.int32)
    upd = rng.standard_normal((M, F)).astype(np.float32)
    ref = np.asarray(jsorted_segment_add(jnp.asarray(idx), jnp.asarray(upd), R))
    out = sorted_segment_add(torch.from_numpy(idx), torch.from_numpy(upd), R)
    assert out.shape == (R, F) and out.dtype == torch.float32
    prefix = np.abs(np.cumsum(upd[np.argsort(idx, kind="stable")].astype(np.float64), 0)).max()
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6 * prefix)
    dropped = np.zeros((R + 1, F))
    np.add.at(dropped, idx, upd.astype(np.float64))
    assert (idx == R).any()
    np.testing.assert_allclose(out.numpy(), dropped[:R], rtol=0, atol=1e-6 * prefix)


def _recording_slope_time(results, key):
    def slope_time(fn, n_calls=7):
        results[key] = fn()
        return 1.0, "[0..0]"

    return slope_time


@pytest.mark.parametrize("kind", ["sorted", "native"])
def test_segment_add_probe_leaves_the_jax_carry(monkeypatch, kind):
    """Row 0's count feeds the carry, whose parity moves the indices, up to R."""
    M, R, F, K = 3000, 8, 2, 5
    idx = np.random.default_rng(2).integers(0, R, M).astype(np.int32)
    s, at_r = 0, 0
    for _ in range(K):  # the carry in numpy: these indices reach R
        at_r += int((idx + s % 2 == R).sum())
        s += int((idx + s % 2 == 0).sum())
    assert at_r > 0
    got = {}
    monkeypatch.setattr(jax.random, "randint", lambda *a, **k: jnp.asarray(idx))
    monkeypatch.setattr(jprobe_prims, "slope_time", _recording_slope_time(got, "jax"))
    monkeypatch.setattr(probe_prims, "slope_time", _recording_slope_time(got, "port"))
    jprobe_prims.probe_segment_add(M, R, F, K, kind)
    probe_prims.probe_segment_add(M, R, F, K, kind, device="cpu", idx=torch.from_numpy(idx))
    assert got["port"] == got["jax"] == s


def test_sort_probe_leaves_the_jax_carry(monkeypatch):
    M, K = 4096, 4
    keys = np.random.default_rng(5).integers(0, 1 << 20, M).astype(np.int32)
    got = {}
    monkeypatch.setattr(jax.random, "randint", lambda *a, **k: jnp.asarray(keys))
    monkeypatch.setattr(jprobe_prims, "slope_time", _recording_slope_time(got, "jax"))
    monkeypatch.setattr(probe_prims, "slope_time", _recording_slope_time(got, "port"))
    jprobe_prims.probe_sort(M, 3, K)
    probe_prims.probe_sort(M, 3, K, device="cpu", keys=torch.from_numpy(keys))
    assert got["port"] == got["jax"] > 0


_RATE = r"\d+M (rows|upd|keys)/s \(\d+(\.\d)? ms/call \[\d+\.\.\d+\], K=\d+\)"


def _lines(capsys):
    return capsys.readouterr().out.strip().splitlines()


def test_probe_gather2_main_on_the_cpu(capsys):
    before = dict(LAUNCHES)
    assert probe_gather2.main(["--device", "cpu", "--quick", "--shrink", "12"]) == 0
    assert LAUNCHES == before
    lines = _lines(capsys)
    assert lines[0].startswith("device=cpu")
    names = [line.split(" ")[0] for line in lines[1:]]
    assert names == ["xla1"] * 4 + ["pair[2]", "pair[4]", "pair[2]", "pair[2]"] + ["onehot"] * 3 + \
        ["pl-take"] * 2 + ["pl-loop"]
    for line in lines[1:]:
        assert re.fullmatch(r"\S+ M=\d+\.\dM R=2\^\d+ F=\d+.*: " + _RATE, line), line
    assert "pl-take M=0.0M R=2^4 F=2" in lines[-3] and "pl-loop M=0.0M R=2^4 F=2" in lines[-1]
    assert probe_gather2.main(["--device", "cpu", "--quick", "--shrink", "12",
                               "--only", "pl-take,pl-loop"]) == 0
    assert [line.split(" ")[0] for line in _lines(capsys)[1:]] == ["pl-take"] * 2 + ["pl-loop"]
    with pytest.raises(SystemExit):
        probe_gather2.main(["--device", "cpu", "--only", "xla-soa"])


def test_probe_prims_main_on_the_cpu(capsys):
    assert probe_prims.main(["--device", "cpu", "--shrink", "12"]) == 0
    lines = _lines(capsys)
    assert lines[0].startswith("device=cpu")
    names = [line.split(" ")[0] for line in lines[1:]]
    assert names == ["gather"] * 12 + ["segadd[sorted]"] * 2 + ["segadd[native]"] + ["sort"] * 3
    for line in lines[1:]:
        assert re.fullmatch(r"\S+ M=\d+\.\dM .*: " + _RATE, line), line
    assert "axis=1" in lines[9] and "bfloat16" in lines[7]
    assert probe_prims.main(["--device", "cpu", "--quick", "--shrink", "12", "--only", "segadd"]) == 0
    assert [line.split(" ")[0] for line in _lines(capsys)[1:]] == ["segadd[sorted]"] * 2


def test_gather_probes_refuse_an_odd_row_count():
    """With an odd M the carry's parity would move an index to R."""
    with pytest.raises(ValueError, match="must be even"):
        probe_gather2.probe_xla1(1001, 64, 2, 1, device="cpu")
    with pytest.raises(ValueError, match="must be even"):
        probe_prims.probe_gather(1001, 64, 2, torch.float32, 1, axis=0, device="cpu")


def test_probe_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("with a card the default device exists")
    for main in (probe_gather2.main, probe_prims.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["--quick", "--shrink", "12"])
