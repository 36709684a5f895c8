"""The port's CPU path computes float32 transcendental functions at full
accuracy from the first call of a process.

PyTorch's CPU builds run float32 ``sin``, ``exp`` and others through MKL's
VML, in chunks of >= 2048 elements spread over OpenMP threads. When several
threads make the process's first VML call at once, a thread may compute its
chunk at VML's enhanced-performance accuracy: ``sin`` off by ~1.5e-4 where
it is otherwise within ~4e-8, enough to move a positional encoding at 2^5
past the cross-checks' tolerances. ``sdfstudio_tpu_torch`` makes one small
single-threaded VML call at import, so the first threaded call is accurate.

Each case starts a fresh process, imports the package, and makes the
process's first threaded float32 ``sin`` and ``exp`` calls (7 chunks over 8
threads), then holds every chunk to 1e-6 of float64 numpy: accurate chunks
err by at most ~4e-8 (absolute, sin) and ~6e-8 (relative, exp); a chunk at
the reduced accuracy errs by ~1e-4. The race does not show in every process,
so a run without the import-time call can pass; the cases make it likely to
show.
"""
import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
CHILD = r"""
import json

import sdfstudio_tpu_torch  # noqa: F401  (the import-time VML call)
import numpy as np
import torch

torch.set_num_threads(8)
rng = np.random.default_rng(0)
worst = {}
for name, lo, hi in (("sin", -40.0, 40.0), ("exp", -20.0, 20.0)):
    a = rng.uniform(lo, hi, (385, 36)).astype(np.float32)
    out = getattr(torch, name)(torch.from_numpy(a)).numpy().astype(np.float64)
    ref = getattr(np, name)(a.astype(np.float64))
    err = np.abs(out - ref) / (np.abs(ref) if name == "exp" else 1.0)
    worst[name] = float(err.max())
print(json.dumps(worst))
"""


@pytest.mark.parametrize("case", range(6))
def test_first_threaded_vml_calls_are_accurate(case):
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=ROOT, capture_output=True,
                          text=True, timeout=120, check=True)
    worst = json.loads(proc.stdout.strip().splitlines()[-1])
    assert worst["sin"] < 1e-6 and worst["exp"] < 1e-6, worst
