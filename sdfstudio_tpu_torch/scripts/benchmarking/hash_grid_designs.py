"""Time the hash-grid kernels at other design points beside the library's,
and beside their first design, on the card, on a real train step's inputs.

    python -m sdfstudio_tpu_torch.scripts.benchmarking.hash_grid_designs \\
        [--parent DIR] [--out PATH]

``hash_grid_designs.cu`` (beside this file) builds other forwards than the
library's (``csrc/hash_grid.cu``): over the backward's level-major tiles,
with paired 16-byte x-corner loads, with the weights rebuilt after the
loads, two levels a thread, register caps; the library's backward with
each move switched off (the paired float4 reductions, the warp
aggregation); three floors of the walk (the forward's table reads alone,
its streams alone, the backward's reductions alone); and keeps the first
design of the pair verbatim (``baseline``: a thread per point and level, one
float2 reduction a corner) as the baseline. ``--parent DIR`` also builds
``DIR/sdfstudio_tpu_torch/csrc/hash_grid.cu`` (another checkout's kernels,
with the same C entry points) and times it in the same turns.

Inputs: ``neus-facto`` at full width from seed 0 trains ``CHECK_STEPS``
steps of 2048 rays on ``.parity/dtu_like``; then one more step's forward
and backward is captured (not applied): the three encodes (the SDF grid at
98,304 points with the jacobian, the proposal grids at 524,288 and 196,608
points without), their ``x`` and the cotangents autograd hands the
backward. Each call also runs on uniform points with seeded normal
cotangents, and the F = 4 grid of ``neus-facto-tpu`` (L8xF4, 2^19 rows, max
resolution 512) on the SDF call's captured points. The tables identify
their rows (a corner read from a wrong row is off by O(1)). Every design is
first held to the plain version (forward 1e-6 of max, backward 1e-5 in
relative Frobenius norm), then timed in three rounds in turns, each the
mean of 20 back-to-back launches by CUDA events (as ``chip_smoke.py`` times
them), and reported by the median round, beside the bytes bound, the
sector bound (each distinct 32-byte sector of the table the call touches,
read once) and the L2 requests of each design's loads (the distinct
sectors of each warp-wide load instruction, counted on the host from the
corner rows). Prints one JSON line per design and case and the
``nvidia-smi`` line; ``--out`` writes all of them as one JSON file. Needs a
CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import subprocess
import sys
from pathlib import Path
from typing import Optional, Sequence

import torch

from sdfstudio_tpu_torch.ops import hash_grid as hg
from sdfstudio_tpu_torch.utils import cuda_build

HERE = Path(__file__).resolve().parent
REPO = HERE.parents[2]
SCENE = REPO / ".parity" / "dtu_like"
HBM_RATE = 3.35e12  # bytes/s, H100 SXM
REPS = 20
ROUNDS = 3  # every design timed in turns: forward, backward, forward
CHECK_STEPS = 12  # chip_smoke.py: steps before the captured one
HASH_FWD_TOL = 1e-6  # chip_smoke.py
HASH_BWD_TOL = 1e-5  # chip_smoke.py
# neus-facto-tpu's SDF grid (sdfstudio_tpu/configs/methods.py:270-312): L8 x F4, 2^19, 16-512
F4_GRID = dict(num_levels=8, min_res=16, max_res=512, log2_hashmap_size=19, features_per_level=4,
               smoothstep=True)
# (label, variant) of sst_design_hash_fwd (hash_grid_designs.cu design_fwd),
# and (label, pair, agg) of sst_design_hash_bwd: the paired float4
# reductions (F = 2) and the warp aggregation
FWD_DESIGNS = [("tiles", 0), ("tiles, paired", 1), ("tiles, item a warp", 2),
               ("tiles, <=42 regs", 3), ("weights rebuilt", 4), ("<=42 regs", 5),
               ("level pairs", 6), ("level pairs, hashed past L1", 7), ("x-pairs", 8)]
BWD_DESIGNS = [("aggregated", 0, 1), ("paired", 1, 0), ("neither", 0, 0)]
# the designs whose warps take 32 consecutive points at one level (their L2
# requests counted as such), and those whose x-corner pairs are paired
LEVEL_MAJOR = {"tiles", "tiles, paired", "tiles, item a warp", "tiles, <=42 regs", "aggregated",
               "paired", "neither"}
PAIRED = {"tiles, paired", "paired", "x-pairs"}


@contextlib.contextmanager
def capture_hash_calls(records: list):
    """Record every hash-grid kernel call the model makes: ``x``, the spec,
    the table's shape and whether it wants the jacobian, and for a call
    under autograd the cotangents its backward receives (``g_out``,
    ``g_jac``), each as a detached copy. The calls still run the kernels."""
    fwd, bwd = hg.hash_encode_fwd, hg.hash_encode_bwd

    def rec_fwd(x, table, spec, want_jac=False):
        records.append({"x": x.detach().clone(), "spec": spec, "rows": table.shape[0],
                        "F": table.shape[1], "want_jac": want_jac})
        return fwd(x, table, spec, want_jac)

    def rec_bwd(x, g_out, g_jac, spec, rows):
        for r in records:
            if "g_out" not in r and r["spec"] == spec and r["x"].shape == x.shape \
                    and torch.equal(r["x"], x):
                r["g_out"] = g_out.detach().clone() if g_out is not None else None
                r["g_jac"] = g_jac.detach().clone() if g_jac is not None else None
                break
        return bwd(x, g_out, g_jac, spec, rows)

    hg.hash_encode_fwd, hg.hash_encode_bwd = rec_fwd, rec_bwd
    try:
        yield
    finally:
        hg.hash_encode_fwd, hg.hash_encode_bwd = fwd, bwd


def row_table(rows: int, F: int, device="cuda") -> torch.Tensor:
    """A table whose values identify their row (chip_smoke.py's)."""
    k = torch.arange(rows * F, dtype=torch.int64, device=device)
    return (((k * 2654435761) % (1 << 24)).to(torch.float32) / (1 << 23) - 1.0).reshape(rows, F)


def sector_stats(x: torch.Tensor, spec: hg.HashGridSpec, rows: int, F: int, pair: bool) -> dict:
    """What the table reads of one call touch, from its corner rows:
    ``unique_rows``, ``unique_sectors`` (distinct 32-byte sectors of the
    table), and the L2 requests of a design's loads: for each warp-wide load
    instruction (32 consecutive points at one level, one corner or, paired,
    one x-neighbour pair) its distinct sectors, summed; ``requests_per_row``
    the same for the first design's mapping (a warp = 2 points x 16 levels: every lane
    its own request; paired, one for both rows of an aligned pair)."""
    idx, _ = hg.corner_indices(x, spec)  # [N, L, 8]
    idx = torch.where(idx < rows, idx, rows)
    N, L = idx.shape[:2]
    sector = idx * (4 * F) // 32
    warp = (torch.arange(N, device=x.device) // 32)[:, None, None]
    lvl = torch.arange(L, device=x.device)[None, :, None]
    slot = torch.arange(8, device=x.device)[None, None, :]
    n_paired = 0
    if pair and F == 2:
        a, b = idx[..., 0::2], idx[..., 1::2]
        paired = ((a ^ b) == 1) & ((a | 1) < rows)
        n_paired = int(paired.sum())
        slot = torch.where(paired.repeat_interleave(2, -1), slot // 2 * 2, slot)
    key = ((warp * L + lvl) * 8 + slot) * (1 << 26) + sector
    return {"unique_rows": int(torch.unique(idx).numel()),
            "unique_sectors": int(torch.unique(sector).numel()),
            "requests": int(torch.unique(key).numel()),
            "requests_per_row": int(idx.numel()) - n_paired}


def bounds(x, spec, rows, F, want_jac, stats) -> dict:
    """Bytes and sector bounds of one call, ms at the HBM rate: the forward
    reads x and the table rows the call touches (bytes: 4F a row; sectors:
    32 a distinct sector) and writes out (and jac); the backward reads x and
    the cotangents and writes the whole gradient table once (its every
    sector: the two bounds agree)."""
    n, L = x.shape[0], spec.num_levels
    streams = 12.0 * n + 4.0 * n * L * F * (4 if want_jac else 1)
    fb = streams + 4.0 * F * stats["unique_rows"]
    fs = streams + 32.0 * stats["unique_sectors"]
    bb = streams + 4.0 * F * rows
    ms = lambda b: b / HBM_RATE * 1e3  # noqa: E731
    return {"fwd_bytes": fb, "fwd_bound_ms": ms(fb), "fwd_sector_bound_ms": ms(fs),
            "bwd_bytes": bb, "bwd_bound_ms": ms(bb), "bwd_sector_bound_ms": ms(bb)}


def time_many_ms(fn, reps: int = REPS, warmup: int = 2) -> float:
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


def rel_fro(a, b) -> float:
    num, den = float(torch.linalg.vector_norm(a - b)), float(torch.linalg.vector_norm(b))
    return num / den if den > 0 else num


def fwd_err(got, want) -> float:
    """max |got - want| / max |want| over out (and jac); NaN in the same places."""
    err = 0.0
    for a, b in zip(got, want):
        if not torch.equal(torch.isnan(a), torch.isnan(b)):
            return float("inf")
        a, b = torch.nan_to_num(a), torch.nan_to_num(b)
        err = max(err, float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30))
    return err


def _bind(path: Path, names, extra: int) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    ints, u32s = ctypes.POINTER(ci), ctypes.POINTER(ctypes.c_uint32)
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = [vp, vp, vp, vp, ll, ll, ci, ci, ints, u32s, ints, ci, ci, vp] + [ci] * extra
        fn.restype = ci
    return lib


def build_designs(parent: Optional[str] = None, baseline_only: bool = False):
    """Start nvcc on the designs library (and a parent checkout's kernels):
    returns a function that waits for the builds and binds the libraries,
    {"designs": lib, "parent": lib or None, "registers": {kernel: n}} (ptxas's
    registers for each hash kernel of the designs library). With
    ``baseline_only`` the designs library holds the first design alone."""
    work = cuda_build.BUILD_DIR / "designs"
    work.mkdir(parents=True, exist_ok=True)
    name = "baseline" if baseline_only else "designs"
    srcs = [(name, HERE / "hash_grid_designs.cu",
             ["-DSST_HASH_BASELINE_ONLY"] if baseline_only else [])]
    if parent:
        srcs.append(("parent", Path(parent) / "sdfstudio_tpu_torch" / "csrc" / "hash_grid.cu", []))
    procs = [(lib_name, work / f"libsst_hash_{lib_name}.so", subprocess.Popen(
        [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, *defs, "-Xptxas=-v", "-shared", str(src),
         "-o", str(work / f"libsst_hash_{lib_name}.so")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)) for lib_name, src, defs in srcs]

    def finish() -> dict:
        libs = {"parent": None, "registers": {}}
        for lib_name, path, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on the {lib_name} hash-grid library:\n{out}")
            kernel = None
            for line in out.splitlines():
                if "Compiling entry function" in line:
                    kernel = line.split("'")[1] if "'" in line else None
                elif kernel and "Used" in line and "registers" in line and "hash" in kernel:
                    regs = int(line.split("Used")[1].split("registers")[0])
                    libs["registers"][f"{lib_name}:{kernel}"] = regs
        for lib_name, path, _ in procs:
            if lib_name == "parent":
                libs["parent"] = _bind(path, ["sst_hash_encode_fwd", "sst_hash_encode_bwd"], 0)
                continue
            lib = _bind(path, ["sst_baseline_hash_encode_fwd", "sst_baseline_hash_encode_bwd"], 0)
            if not baseline_only:
                _bind_design(lib)
            libs["designs"] = lib
        return libs

    return finish


def _bind_design(lib: ctypes.CDLL) -> None:
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    ints, u32s = ctypes.POINTER(ci), ctypes.POINTER(ctypes.c_uint32)
    base = [vp, vp, vp, vp, ll, ll, ci, ci, ints, u32s, ints, ci, ci, vp]
    lib.sst_design_hash_fwd.argtypes = base + [ci]
    lib.sst_design_hash_fwd.restype = ci
    lib.sst_design_hash_bwd.argtypes = base + [ci, ci]
    lib.sst_design_hash_bwd.restype = ci
    lib.sst_design_hash_floor.argtypes = base + [ci]
    lib.sst_design_hash_floor.restype = ci
    lib.sst_design_hash_bwd.restype = ci


def c_fwd(fn, *extra):
    """A forward through C entry point ``fn`` with the library's arguments."""
    def run(x, table, spec, want_jac):
        N, (R, F), L = x.shape[0], table.shape, spec.num_levels
        out = torch.empty((N, L * F), dtype=torch.float32, device=x.device)
        jac = torch.empty((N, L * F, 3), dtype=torch.float32, device=x.device) if want_jac else None
        res, offs, dense = hg._level_args(spec)
        err = fn(x.data_ptr(), table.data_ptr(), out.data_ptr(), jac.data_ptr() if want_jac else None,
                 N, R, F, L, res, offs, dense, spec.log2_hashmap_size, int(spec.smoothstep),
                 torch.cuda.current_stream().cuda_stream, *extra)
        if err != 0:
            raise RuntimeError(f"hash forward design launch failed: cudaError {err}")
        return (out, jac) if want_jac else (out,)
    return run


def c_bwd(fn, *extra):
    def run(x, g_out, g_jac, spec, rows):
        g = g_out if g_out is not None else g_jac
        N, L = x.shape[0], spec.num_levels
        F = g.shape[1] // L
        grad = torch.zeros((rows, F), dtype=torch.float32, device=x.device)
        res, offs, dense = hg._level_args(spec)
        err = fn(x.data_ptr(), g_out.data_ptr() if g_out is not None else None,
                 g_jac.data_ptr() if g_jac is not None else None, grad.data_ptr(), N, rows, F, L,
                 res, offs, dense, spec.log2_hashmap_size, int(spec.smoothstep),
                 torch.cuda.current_stream().cuda_stream, *extra)
        if err != 0:
            raise RuntimeError(f"hash backward design launch failed: cudaError {err}")
        return grad
    return run


def c_floor(fn, floor: int, want_jac: bool, grad_rows: Optional[int] = None):
    """A floor of sst_design_hash_floor: ``floor`` 0 the forward's table
    reads, 1 its streams (with the jacobian's where ``want_jac``), 2 the
    backward's reductions into a zeroed ``[grad_rows, F]``."""
    def run(x, table, spec, _want_jac):
        N, (R, F), L = x.shape[0], table.shape, spec.num_levels
        if floor == 2:
            out, jac = torch.zeros((grad_rows, F), device=x.device), None
        else:
            out = torch.empty((N, L * F), device=x.device)
            jac = torch.empty((N, L * F, 3), device=x.device) if want_jac else None
        res, offs, dense = hg._level_args(spec)
        err = fn(x.data_ptr(), table.data_ptr(), out.data_ptr(), jac.data_ptr() if jac is not None
                 else None, N, R if floor != 2 else grad_rows, F, L, res, offs, dense,
                 spec.log2_hashmap_size, int(spec.smoothstep), torch.cuda.current_stream().cuda_stream,
                 floor)
        if err != 0:
            raise RuntimeError(f"hash floor {floor} launch failed: cudaError {err}")
        return out
    return run


def capture_step(method: str = "neus-facto", steps: int = CHECK_STEPS, num_rays: int = 2048):
    """Train ``method`` ``steps`` steps on the committed scene, then capture
    one more step's hash calls (forward and backward, not applied). Returns
    (records, the model's encodings by call name)."""
    from sdfstudio_tpu_torch.engine.trainer import group_grads, loss_and_metrics
    from sdfstudio_tpu_torch.scripts.train import setup_method_trainer

    trainer = setup_method_trainer(method, str(SCENE), max_num_iterations=steps + 1,
                                   num_rays=num_rays, device="cuda")
    for _ in range(steps):
        trainer.train_step()
    model, dm = trainer.model, trainer.datamanager
    sched = model.schedules(trainer.step)
    gen = torch.Generator(device="cuda").manual_seed(777)
    idx, batch = dm.sample_train_batch(gen)
    records: list = []
    with capture_hash_calls(records):
        total, _, _ = loss_and_metrics(model, dm.generate_rays(idx), batch, sched, gen)
        group_grads(total, trainer.optimizers)
    torch.cuda.synchronize()
    encs = {"sdf": model.field.encoding, "proposal_0": model.proposal_networks[0].encoding,
            "proposal_1": model.proposal_networks[1].encoding}
    named = {}
    for name, enc in encs.items():
        mine = [r for r in records if r["spec"] == enc.spec and "g_out" in r]
        if len(mine) != 1:
            raise AssertionError(f"captured {len(mine)} {name} calls with a backward")
        named[name] = mine[0]
    return named, trainer


def cases(captured: dict, gen: torch.Generator):
    """(label, x, spec, rows, F, want_jac, g_out, g_jac): each call on its
    captured inputs and on uniform points, and the F = 4 grid on the SDF
    call's captured points and on uniform ones."""
    from sdfstudio_tpu_torch.ops.encodings import HashEncoding

    out = []
    for name, r in captured.items():
        for which in ("captured", "uniform"):
            if which == "captured":
                x, g_out, g_jac = r["x"], r["g_out"], r["g_jac"]
            else:
                x = torch.rand(r["x"].shape, generator=gen, device="cuda")
                x[0], x[1], x[2, 0] = 0.0, 1.0, 1.0
                g_out = torch.randn(r["g_out"].shape, generator=gen, device="cuda") \
                    if r["g_out"] is not None else None
                g_jac = torch.randn(r["g_jac"].shape, generator=gen, device="cuda") \
                    if r["g_jac"] is not None else None
            out.append((f"{name} {which}", x, r["spec"], r["rows"], r["F"], r["want_jac"], g_out,
                        g_jac))
    enc4 = HashEncoding(**F4_GRID)
    x_sdf = captured["sdf"]["x"]
    for which in ("captured", "uniform"):
        x = x_sdf if which == "captured" else torch.rand(x_sdf.shape, generator=gen, device="cuda")
        n, LF = x.shape[0], enc4.out_dim
        out.append((f"F4 {which}", x, enc4.spec, enc4.total_rows, 4, True,
                    torch.randn((n, LF), generator=gen, device="cuda"),
                    torch.randn((n, LF, 3), generator=gen, device="cuda")))
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None, help="a checkout whose hash-grid kernels to time alongside")
    ap.add_argument("--out", default=None, help="write every result to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("hash_grid_designs: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    finish = build_designs(args.parent)
    from sdfstudio_tpu_torch.engine.final_eval import set_fp32_precision

    set_fp32_precision()
    cuda_build.load_library()
    libs = finish()
    print(json.dumps({"registers": libs["registers"]}), flush=True)
    captured, trainer = capture_step()
    del trainer
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(0)
    d = libs["designs"]
    results = []
    for label, x, spec, rows, F, want_jac, g_out, g_jac in cases(captured, gen):
        table = row_table(rows, F)
        fwds = [("library", lambda *a: (lambda r: r if isinstance(r, tuple) else (r,))(
            hg.hash_encode_fwd(*a)))]
        bwds = [("library", hg.hash_encode_bwd)]
        fwds += [(lbl, c_fwd(d.sst_design_hash_fwd, v)) for lbl, v in FWD_DESIGNS
                 if F == 2 or lbl not in PAIRED]
        bwds += [(lbl, c_bwd(d.sst_design_hash_bwd, p, a)) for lbl, p, a in BWD_DESIGNS
                 if F == 2 or not p]
        if F == 2:
            fwds.append(("baseline", c_fwd(d.sst_baseline_hash_encode_fwd)))
            bwds.append(("baseline", c_bwd(d.sst_baseline_hash_encode_bwd)))
            if libs["parent"] is not None:
                fwds.append(("parent", c_fwd(libs["parent"].sst_hash_encode_fwd)))
                bwds.append(("parent", c_bwd(libs["parent"].sst_hash_encode_bwd)))
        bwds.append(("deterministic", hg.hash_encode_bwd_det))
        # the floors: not the function, timed beside it
        floors = [("fwd", "floor: table reads", c_floor(d.sst_design_hash_floor, 0, False)),
                  ("fwd", "floor: streams", c_floor(d.sst_design_hash_floor, 1, want_jac)),
                  ("bwd", "floor: reductions", c_floor(d.sst_design_hash_floor, 2, False, rows)),
                  ("bwd", "floor: zero fill", lambda *a: torch.zeros((rows, F), device="cuda"))]
        want = hg.hash_encode_plain(x, table, spec, want_jac)
        want = want if want_jac else (want,)
        ref = hg.hash_encode_bwd_plain(x, g_out, g_jac, spec, rows)
        for lbl, fn in fwds:
            e = fwd_err(fn(x, table, spec, want_jac), want)
            if not e <= HASH_FWD_TOL:
                raise AssertionError(f"{label} forward {lbl}: {e} > {HASH_FWD_TOL}")
        for lbl, fn in bwds:
            e = rel_fro(fn(x, g_out, g_jac, spec, rows), ref)
            if not e <= HASH_BWD_TOL:
                raise AssertionError(f"{label} backward {lbl}: {e} > {HASH_BWD_TOL}")
        del want, ref
        times = {}
        runs = [("fwd", lbl, (lambda fn=fn: fn(x, table, spec, want_jac))) for lbl, fn in fwds]
        runs += [("bwd", lbl, (lambda fn=fn: fn(x, g_out, g_jac, spec, rows))) for lbl, fn in bwds]
        runs += [(which, lbl, (lambda fn=fn: fn(x, table, spec, want_jac))) for which, lbl, fn in floors]
        for rnd in range(ROUNDS):
            for which, lbl, fn in (runs if rnd % 2 == 0 else runs[::-1]):
                times.setdefault((which, lbl), []).append(time_many_ms(fn))
        stats = {p: sector_stats(x, spec, rows, F, p) for p in (True, False)}
        b = bounds(x, spec, rows, F, want_jac, stats[True])
        def requests(which, lbl):
            """The L2 requests of a design's table loads or reductions: for the
            level-major ones a distinct sector of a warp-wide instruction, for
            the rest (the library's forward, the first design, the floors) one a row."""
            if lbl == "library" and which == "bwd":
                return stats[F == 2]["requests"]  # paired at F = 2
            if lbl in LEVEL_MAJOR:
                return stats[lbl in PAIRED and F == 2]["requests"]
            return stats[lbl in PAIRED and F == 2]["requests_per_row"]

        for (which, lbl), ts in times.items():
            med = sorted(ts)[len(ts) // 2]
            rec = {"case": label, "kernel": which, "design": lbl, "points": x.shape[0],
                   "levels": spec.num_levels, "F": F, "rows": rows, "ms": med, "ms_rounds": ts,
                   "bound_ms": b[f"{which}_bound_ms"], "sector_bound_ms": b[f"{which}_sector_bound_ms"],
                   "bound_share": b[f"{which}_bound_ms"] / med,
                   "l2_requests": requests(which, lbl),
                   **{k: v for k, v in stats[True].items() if k.startswith("unique")}}
            results.append(rec)
            print(json.dumps(rec), flush=True)
        del table
        torch.cuda.empty_cache()
    print(smi)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"nvidia_smi": smi, "results": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
