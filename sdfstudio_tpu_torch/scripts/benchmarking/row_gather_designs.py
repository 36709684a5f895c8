"""Time the row-gather kernel ``take`` at other design points beside the
library's, and both row gathers beside an older build of them, on the card.

    python -m sdfstudio_tpu_torch.scripts.benchmarking.row_gather_designs \\
        [--parent DIR] [--out PATH]

``row_gather_designs.cu`` (beside this file) builds ``take`` of
``csrc/row_gather.cu`` with 4, 8 or 16 rows a thread, with the table staged
in shared memory or read through L1 and L2, and under other cache policies
of the table reads and of the index and output streams. ``--parent DIR``
also builds ``DIR/sdfstudio_tpu_torch/csrc/row_gather.cu`` (another
checkout's kernels, with the same C entry points) and times it in the same
turns. Two floors of the library's walk show what holds it: the index and
table reads alone, and the index and output streams alone.

Cases: the probes' shapes (``take`` at R = 2^14 and 2^19, F = 2, M =
4,194,304; ``loop`` at R = 2^14, F = 2, M = 2^20) and p8's table (``take``
at R = 2,841,000, F = 4, M = 3,145,728). Every design is first held to the
plain version bit for bit, NaN rows included, on indices that include R and
-1 (the floors excepted, which are not the function); then every design
is timed in three rounds, in turns (forward, backward, forward), each the
mean of 50 back-to-back launches by CUDA events (as ``chip_smoke.py``
times the gathers), and reported by the median round. Prints one JSON
line per design and case, and the ``nvidia-smi`` line; ``--out`` writes
all of them as one JSON file. Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path
from typing import Optional, Sequence

import torch

from sdfstudio_tpu_torch.ops import row_gather as rg
from sdfstudio_tpu_torch.utils import cuda_build

HERE = Path(__file__).resolve().parent
HBM_RATE = 3.35e12  # bytes/s, H100 SXM
REPS = 50
CASES = [("take", 1 << 14, 2, 4_194_304), ("take", 1 << 19, 2, 4_194_304),
         ("take", 2_841_000, 4, 3_145_728), ("loop", 1 << 14, 2, 1 << 20)]
# (label, batch, staged, policy, a floor) of sst_design_take: the table
# staged in shared memory (where it fits); the cache policies (0 the
# library's: streams evict-first, the table default; 1 the default
# everywhere; 2 streams evict-first and the table evict_last; 3 table
# evict_last only; 4 streams evict-first and the table past L1; 5 the table
# past L1 only); and the two floors of the library's walk, which are not the
# function and are not compared with it
POLICIES = {0: "streams EF", 1: "default", 2: "streams EF, table EL", 3: "table EL",
            4: "streams EF, table past L1", 5: "table past L1"}
DESIGNS = ([(f"B{b} staged", b, 1, 0, False) for b in (4, 8, 16)]
           + [(f"B{b} {POLICIES[p]}", b, 0, p, False) for p in (0, 1) for b in (4, 8, 16)]
           + [(f"B{b} {POLICIES[p]}", b, 0, p, False) for p in (2, 3, 4, 5) for b in (4, 8)]
           + [(f"B{b} floor: reads only", b, 0, 6, True) for b in (4, 8)]
           + [(f"B{b} floor: streams only", b, 0, 7, True) for b in (4, 8)])
ROUNDS = 3  # every design timed in turns: forward, backward, forward


def _build(src: Path, lib: Path) -> subprocess.Popen:
    lib.parent.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-shared", str(src),
                             "-o", str(lib)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _bind(path: Path, names: Sequence[str], extra: int = 0) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name in names:
        getattr(lib, name).argtypes = [vp, vp, vp, ci, ci, ll, vp] + [ci] * extra
        getattr(lib, name).restype = ci
    return lib


def time_many_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Mean time of ``fn()`` over ``reps`` back-to-back launches, by CUDA
    events around the whole run, after the card sleeps while the host queues
    them (``chip_smoke.py``'s ``cuda_time_many_ms``)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _c_gather(fn, *extra):
    def run(table, idx):
        R, F = table.shape
        out = torch.empty((idx.shape[0], F), dtype=torch.float32, device=table.device)
        err = fn(table.data_ptr(), idx.data_ptr(), out.data_ptr(), R, F, idx.shape[0],
                 torch.cuda.current_stream().cuda_stream, *extra)
        if err != 0:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return out
    return run


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None, help="a checkout whose row gathers to time alongside")
    ap.add_argument("--out", default=None, help="write every result to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("row_gather_designs: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    work = cuda_build.BUILD_DIR / "designs"
    jobs = [("designs", _build(HERE / "row_gather_designs.cu", work / "libsst_designs.so"))]
    if args.parent:
        src = Path(args.parent) / "sdfstudio_tpu_torch" / "csrc" / "row_gather.cu"
        jobs.append(("parent", _build(src, work / "libsst_parent.so")))
    cuda_build.load_library()
    for name, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} library:\n{out}")
    designs = _bind(work / "libsst_designs.so", ["sst_design_take"], extra=3)
    parent = (_bind(work / "libsst_parent.so", ["sst_row_gather_take", "sst_row_gather_loop"])
              if args.parent else None)
    smem_limit = cuda_build.load_library().sst_row_gather_smem_limit()

    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    for kind, R, F, M in CASES:
        table = torch.randn((R, F), generator=gen, device="cuda")
        idx = torch.randint(0, R, (M,), generator=gen, device="cuda", dtype=torch.int32)
        edge = idx.clone()
        edge[::997] = R
        edge[1::1009] = -1
        plain = rg.take_plain if kind == "take" else rg.loop_plain
        want = plain(table, edge)
        nan_want = torch.isnan(want)
        library = rg.take if kind == "take" else rg.loop
        runs = [("library", library, False)]
        if parent is not None:
            runs.insert(0, ("parent", _c_gather(getattr(parent, f"sst_row_gather_{kind}")), False))
        if kind == "take":
            staged_fits = 16 + R * F * 4 <= smem_limit
            runs += [(label, _c_gather(designs.sst_design_take, b, s, p), floor)
                     for label, b, s, p, floor in DESIGNS if staged_fits or not s]
        for label, fn, floor in runs:
            got = fn(table, edge)
            torch.cuda.synchronize()
            same_nan = torch.equal(torch.isnan(got), nan_want)
            exact = same_nan and torch.equal(torch.where(nan_want, 0.0, got),
                                             torch.where(nan_want, 0.0, want))
            if not (exact or floor):
                raise AssertionError(f"{kind} R={R} {label}: differs from the plain version")
        times = {}
        for rnd in range(ROUNDS):
            for label, fn, _ in (runs if rnd % 2 == 0 else runs[::-1]):
                times.setdefault(label, []).append(time_many_ms(lambda: fn(table, idx)))
        nbytes = 4.0 * (M + R * F + M * F)
        index_select_ms = time_many_ms(lambda: torch.index_select(table, 0, idx))
        for label, ts in times.items():
            med = sorted(ts)[len(ts) // 2]
            rec = {"kernel": kind, "R": R, "F": F, "M": M, "design": label, "ms": med,
                   "ms_rounds": ts, "bound_ms": nbytes / HBM_RATE * 1e3,
                   "index_select_ms": index_select_ms, "bound_share": nbytes / HBM_RATE * 1e3 / med}
            results.append(rec)
            print(json.dumps(rec), flush=True)
        del table, idx, edge, want
    print(smi)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"nvidia_smi": smi, "results": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
