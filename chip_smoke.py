#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own line with wall-clock seconds:

1. device: ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``;
2. build: the CUDA kernels from a clean ``sdfstudio_tpu_torch/_build/``,
   with ptxas's registers and spills per kernel and, from ``cuobjdump
   -sass`` of the built library, each kernel's count of tensor-core
   instructions (``HGMMA``, Hopper's warpgroup MMA);
3. slice: a full-width ``neus-facto-tpu-p8`` model from the port's seeded
   initialiser renders one 384x384 view through ``render_image`` in
   1024-ray chunks. Geometric init makes the SDF close to a sphere; the
   image is checked against that sphere (accumulation inside / outside,
   depth), and 256 of its rays are rendered again on the CPU through the
   plain PyTorch versions and compared. One more render runs under
   ``torch.profiler``: its wall time, the device's busy time and idle share,
   and the time of each ``sst/*`` range of the model;
4. kernel against plain: the inputs of the three ``fused_mlp`` calls of one
   chunk are captured, the kernel and ``fused_mlp_plain`` run on them on the
   card, and the two are compared and timed;
5. train: the committed DTU-like scene (``.parity/dtu_like``) is parsed by
   the port's dataparser, its image stack goes to the card, and the trainer
   of ``scripts/train.py`` takes ``TRAIN_STEPS`` steps of 2048 rays on a
   full-width ``neus-facto-tpu-p8`` from seed 0, past frozen proposal
   steps: the first ``CHECK_STEPS`` one at a time through ``train_step``,
   the rest through ``Trainer.train``, the loop a user runs, timed as one
   window. Checked: finite losses, the proposal nets still on a frozen step
   and moving on an update step, and a lower rgb L1 on a fixed probe batch.
   One step is then taken twice from the same state, batch and seed, with
   the kernels and with ``fused_mlp`` swapped for its plain versions, and
   the losses and every group's gradient compared; the three backward calls
   of that step are captured and the backward kernel is compared with
   ``fused_mlp_bwd_plain`` and timed, and run twice more on the color call,
   whose results must be the same bits; one step runs under
   ``torch.profiler``;
6. probe: the gather-probe entry points, ``probe_gather2`` and
   ``probe_prims``, run in process with ``--quick`` at the reference's
   shapes and print their lines; their launches of the two row-gather
   kernels are counted. Each kernel is then held to its plain version on
   random tables at the probe's shapes (``take`` at R = 2^14 and 2^19,
   ``loop`` at 2^14) and at p8's own table (the gathers of one train step),
   on indices that include R and -1: a gather is a copy, so the two must
   agree exactly, NaN rows included. Kernel, plain version and
   ``index_select`` are timed with CUDA events over many warm launches, and
   the kernel's device time per launch is read from ``torch.profiler``
   beside it (the gap between the two is the launch's); each case reports
   its share of the bytes bound and the design the kernel took;
7. the ``kernels`` JSON line, the ``nvidia-smi`` line, and the result line.

It imports torch, numpy, the standard library and ``sdfstudio_tpu_torch``
only, and reads no checkpoint. Any failed check raises, so the exit code is
not 0 and no result line is printed. Without CUDA it exits with code 2; it
fails with a message when the scene is missing.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

T0 = time.perf_counter()
SEED = 0
IMAGE = 384  # the parity scene's image size (.parity/dtu_like/meta_data.json)
FOCAL = 422.4  # its intrinsics
CAM_DIST = 2.0
KERNEL_TOL = 1e-4  # max |kernel - plain| / (max |plain| + 1)
SLICE_TOL = 1e-3  # card path against the CPU path, on rgb / accumulation / depth
SCENE = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".parity", "dtu_like")
TRAIN_RAYS = 2048  # the parity protocol's rays per batch (parity.py NUM_RAYS)
TRAIN_STEPS = 40  # steps 10-39 update the proposal nets on even steps only
CHECK_STEPS = 12  # steps taken one at a time; update step 10 and frozen step 11 are checked
# backward kernel against fused_mlp_bwd_plain, both at f32 accuracy on the
# card (the plain side in f32 with TF32 off, the kernel in 3xTF32): the
# relative Frobenius error ||kernel - plain|| / ||plain|| of dx, each dW and
# each db. dW sums up to 524,288 rows in other orders, and where a
# pre-activation lies within rounding of 0 the two forwards may take the
# relu's two sides, which moves that row's delta by its full value. Measured
# at most 5.2e-7 for the FP32-core kernels (NVIDIA H100 80GB HBM3, 700 W);
# the bound keeps room for such rows: 1e-4.
BWD_TOL = 1e-4
# the kernel step against the plain step (losses, relative; each group's
# gradient, relative Frobenius): the proposal densities differ by rounding
# and ``weights ** anneal`` can magnify that in nearly empty bins before the
# resampled positions reach the field. Measured 2.1e-7 and 3.7e-7: 1e-4.
STEP_LOSS_TOL = 1e-4
STEP_GRAD_TOL = 1e-4
FP32_PEAK = 67e12  # H100 SXM, FLOP/s outside the tensor cores (data sheet)
TF32_TC_PEAK = 495e12  # H100 SXM, dense TF32 FLOP/s of the tensor cores (data sheet)
HBM_RATE = 3.35e12  # bytes/s
# the gather probes' kernel shapes (probe_gather2.py main): (kernel, R, F, M)
PROBE_GATHERS = [("take", 1 << 14, 2, 4_194_304), ("take", 1 << 19, 2, 4_194_304),
                 ("loop", 1 << 14, 2, 1 << 20)]
# the permutohedral encode of one p8 train step: 98,304 points x 8 levels x
# 4 corners of a 2,841,000 x 4 table
P8_GATHER = ("take", 2_841_000, 4, 98_304 * 8 * 4)
GATHER_REPS = 50  # warm launches per CUDA-event timing of a gather


def log(phase: str, msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.2f}s] {phase}: {msg}", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def ptxas_report(build_log: str) -> dict:
    """``-Xptxas=-v`` output as {kernel: {"registers": n, "spill_stores": bytes,
    "spill_loads": bytes}}, the kernel named by its demangled-looking stem
    (``fused_mlp_fwd_kernel<4>``)."""
    out, name = {}, None
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1] if "'" in line else line
            stem = next((k for k in ("fused_mlp_fwd_kernel", "fused_mlp_bwd_rows_kernel",
                                     "fused_mlp_bwd_fix_kernel", "fused_mlp_bwd_dw_narrow_kernel",
                                     "fused_mlp_bwd_dw_kernel", "fused_mlp_bwd_reduce_kernel",
                                     "split_kernel", "take", "loop") if k in mangled), mangled[-40:])
            tmpl = mangled.split("ILi")[1].split("E")[0] if "ILi" in mangled else ""
            name = f"{stem}<{tmpl}>" if tmpl else stem
            while name in out:
                name += "'"
            out[name] = {}
        elif name is not None and "spill stores" in line:
            parts = line.split(",")
            out[name]["spill_stores"] = int(parts[1].split()[0])
            out[name]["spill_loads"] = int(parts[2].split()[0])
        elif name is not None and "Used" in line and "registers" in line:
            out[name]["registers"] = int(line.split("Used")[1].split("registers")[0])
    return out


def sass_counts(lib_path) -> dict:
    """Per kernel of the built library, from ``cuobjdump -sass`` (beside
    ``nvcc``): its tensor-core instructions, {"HGMMA": n, "HMMA": n}, and
    under "mem" each form of its global loads and stores and bulk copies
    with its count ({"STG.E.EF.128": n, ...}): a cache hint shows in the
    form (EF: evict-first)."""
    from sdfstudio_tpu_torch.utils.cuda_build import find_nvcc

    cuobjdump = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", str(lib_path)], check=True, capture_output=True,
                         text=True, timeout=300).stdout
    counts, name = {}, None
    for line in out.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            counts[name] = {"HGMMA": 0, "HMMA": 0, "mem": {}}
        elif name is not None:
            for op in ("HGMMA", "HMMA"):
                if f" {op}." in line:
                    counts[name][op] += 1
            m = re.search(r"\b((?:LDG|STG|UBLKCP)[\w.]*)", line)
            if m:
                mem = counts[name]["mem"]
                mem[m.group(1)] = mem.get(m.group(1), 0) + 1
    return counts


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    check(len(out) >= 1, "nvidia-smi printed nothing")
    return out[0].strip()


def cuda_time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()``."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


@contextlib.contextmanager
def swap_fused_mlp(fn):
    """Route every ``fused_mlp`` call of the model through ``fn``."""
    from sdfstudio_tpu_torch.fields import sdf_field
    from sdfstudio_tpu_torch.ops import mlp

    orig = mlp.fused_mlp
    mlp.fused_mlp = sdf_field.fused_mlp = fn
    try:
        yield orig
    finally:
        mlp.fused_mlp = sdf_field.fused_mlp = orig


@contextlib.contextmanager
def capture_fused_mlp_calls(calls: list):
    """Record the arguments of every ``fused_mlp`` call the model makes and,
    for a call under autograd, the cotangent its backward receives (as the
    dict's ``"g"``)."""
    from sdfstudio_tpu_torch.ops.fused_mlp import fused_mlp

    def recording(x, weights, biases, activation="relu", out_activation="none"):
        rec = {"x": x.detach().clone(), "ws": [w.detach().clone() for w in weights],
               "bs": [b.detach().clone() for b in biases], "act": activation,
               "out_act": out_activation, "need_dx": x.requires_grad}
        calls.append(rec)
        y = fused_mlp(x, weights, biases, activation, out_activation)
        if y.requires_grad:
            y.register_hook(lambda g: rec.__setitem__("g", g.detach().clone()))
        return y

    with swap_fused_mlp(recording):
        yield


def mlp_work(x, weights):
    """(FLOP, bytes) one call must do: each input read once, the output written once."""
    n = x.numel() // x.shape[-1]
    dims = [x.shape[-1]] + [w.shape[1] for w in weights]
    flop = 2.0 * n * sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    nbytes = 4.0 * (n * dims[0] + n * dims[-1] + sum(a * b + b for a, b in zip(dims[:-1], dims[1:])))
    return flop, nbytes, dims, n


def mlp_bwd_work(x, weights, need_dx):
    """(FLOP, bytes, scratch bytes) of one backward call: the forward that
    rebuilds the activations (they are not inputs), every dW, the delta chain
    through each layer after the first, and dx when it is needed; the bytes
    are the function's own: x, g, W, b read once, dx, dW, db written once.
    The scratch bytes are the design's Z / D traffic (each hidden
    pre-activation and every delta, csrc/fused_mlp_bwd.cu, written once and
    read once): the function does not need them, so they stay out of the
    bound and are reported beside it."""
    n = x.shape[0]
    dims = [x.shape[-1]] + [w.shape[1] for w in weights]
    prods = [a * b for a, b in zip(dims[:-1], dims[1:])]
    flop = 2.0 * n * (2 * sum(prods) + sum(prods[1:]) + (prods[0] if need_dx else 0))
    params = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    scratch = 2 * 4.0 * n * (sum(dims[1:-1]) + sum(dims[1:]))
    nbytes = 4.0 * (n * dims[0] * (2 if need_dx else 1) + n * dims[-1] + 2 * params)
    return flop, nbytes, scratch, dims, n


def bounds(flop, nbytes):
    """The least time on the card: at the reference's f32 accuracy the
    tensor cores take three tf32 passes (3xTF32), and the FP32 cores one;
    bytes at the HBM rate. (bound_ms, bound_ms_fp32, bound_by) in ms."""
    tc, fp32, mem = 3 * flop / TF32_TC_PEAK, flop / FP32_PEAK, nbytes / HBM_RATE
    return max(tc, mem) * 1e3, max(fp32, mem) * 1e3, "operations" if tc >= mem else "bytes"


def _union_us(intervals) -> float:
    """Total length of a union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for a, b in sorted(intervals):
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def render_breakdown(events, wall_ms: float, windows=()) -> dict:
    """From one traced render or train step that took ``wall_ms``: the
    device's busy time (union of its kernel intervals) and idle share, for
    each ``sst/*`` range of the model (proposal sampler, permutohedral
    encode, geometry MLP with its gradient, color MLP, the train step's
    phases) its host span, its span on the device timeline and the kernel
    time inside that span, and the kernels that took most. Each window
    ``(label, after, before)`` adds the kernel time between the end of range
    ``after`` and the start of range ``before`` on the device: the autograd
    engine launches the backward from its own thread, outside the caller's
    ranges."""
    cuda = torch.autograd.DeviceType.CUDA
    kernels, dev_ranges, host_ranges = [], {}, {}
    for e in events:
        iv = (e.time_range.start, e.time_range.end)
        if e.name.startswith("sst/"):
            (dev_ranges if e.device_type == cuda else host_ranges).setdefault(e.name, []).append(iv)
        elif e.device_type == cuda:
            kernels.append((iv, e.name))
    kernels.sort()
    starts = [iv[0] for iv, _ in kernels]
    busy_ms = _union_us([iv for iv, _ in kernels]) / 1e3
    check(0.0 < busy_ms <= wall_ms, f"device busy {busy_ms} ms in a {wall_ms} ms render")
    per_range = {}
    for name in sorted(set(dev_ranges) | set(host_ranges)):
        inside = []
        for ra, rb in dev_ranges.get(name, []):
            i = max(bisect.bisect_left(starts, ra) - 1, 0)
            while i < len(kernels) and kernels[i][0][0] < rb:
                a, b = kernels[i][0]
                if b > ra:
                    inside.append((max(a, ra), min(b, rb)))
                i += 1
        per_range[name] = {
            "host_span_ms": _union_us(host_ranges.get(name, [])) / 1e3,
            "device_span_ms": _union_us(dev_ranges.get(name, [])) / 1e3,
            "kernel_ms": _union_us(inside) / 1e3,
            "calls": len(host_ranges.get(name, [])),
        }
    for label, after, before in windows:
        check(after in dev_ranges and before in dev_ranges,
              f"no device span for {after} or {before}: {sorted(dev_ranges)}")
        lo = max(b for _, b in dev_ranges[after])
        hi = min(a for a, _ in dev_ranges[before])
        per_range[label] = {"kernel_ms": _union_us(
            [(max(a, lo), min(b, hi)) for (a, b), _ in kernels if b > lo and a < hi]) / 1e3}
    by_name = {}
    for (a, b), name in kernels:
        t, n = by_name.get(name, (0.0, 0))
        by_name[name] = (t + (b - a) / 1e3, n + 1)
    return {
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "kernel_launches": len(kernels),
        "ranges": per_range,
        "top_kernels": [{"name": k[:100], "ms": t, "calls": n}
                        for k, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]],
    }


def cuda_time_many_ms(fn, reps: int = GATHER_REPS, warmup: int = 3) -> float:
    """Mean time of ``fn()`` over ``reps`` back-to-back launches, by CUDA
    events around the whole run. The card first sleeps ~10 ms while the host
    queues every launch, so the events time the device and not the rate at
    which the host issues work (tens of microseconds a call against gathers
    of tens of microseconds)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)  # clock cycles
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def profiled_device_ms(fn, kernel: str, reps: int = 20):
    """Mean device time of one launch of ``fn()``'s kernel, whose name holds
    ``kernel``, over ``reps`` launches traced by ``torch.profiler``, and the
    number of launches the trace holds (it can miss the first few): beside
    the events' mean of back-to-back launches it shows the gap between
    launches."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    durs = [e.time_range.end - e.time_range.start for e in prof.events()
            if e.device_type == cuda and kernel in e.name]
    check(reps // 2 <= len(durs) <= reps,
          f"the profiler saw {len(durs)} {kernel} launches of {reps}")
    return sum(durs) / len(durs) / 1e3, len(durs)


def probe_phase() -> dict:
    """Run the gather-probe entry points, count their kernel launches, and
    hold each row-gather kernel to its plain version; time kernel (by events
    and by the profiler's device time), plain version and ``index_select``.
    Returns what the ``kernels`` line reports."""
    from sdfstudio_tpu_torch.ops import row_gather as rg
    from sdfstudio_tpu_torch.ops.launches import LAUNCHES, reset_launch_counts
    from sdfstudio_tpu_torch.scripts.benchmarking import probe_gather2, probe_prims
    from sdfstudio_tpu_torch.utils.cuda_build import load_library

    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    reset_launch_counts()
    t = time.perf_counter()
    probe_gather2.main(["--quick"])
    probe_prims.main(["--quick"])
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    log("probe", f"probe_gather2 and probe_prims --quick in {time.perf_counter() - t:.2f} s; "
        f"launches {launches}")
    # probe_gather2 --quick: 2 pl-take probes of K=4 and one pl-loop probe of
    # K=2, each called 2 + 7 times (probe_prims.slope_time)
    check(launches["row_gather_take"] == 2 * 4 * 9 and launches["row_gather_loop"] == 2 * 9,
          f"expected 72 take and 18 loop launches, got {launches}")
    check(launches["fused_mlp_fwd"] == 0 and launches["fused_mlp_bwd"] == 0,
          f"the probes launched a fused-MLP kernel: {launches}")

    lib = load_library()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    recs = []
    for which, (kind, R, F, M) in [("probe", c) for c in PROBE_GATHERS] + [("p8", P8_GATHER)]:
        kern, plain = (rg.take, rg.take_plain) if kind == "take" else (rg.loop, rg.loop_plain)
        table = torch.randn((R, F), generator=gen, device="cuda")
        idx = torch.randint(0, R, (M,), generator=gen, device="cuda", dtype=torch.int32)
        edge = idx.clone()
        edge[::997] = R  # one past the table: NaN for take, row R-1 for loop
        edge[5::1009] = -1  # row R-1 for both
        edge[1], edge[2] = 0, R - 1
        got, want = kern(table, edge), plain(table, edge)
        torch.cuda.synchronize()
        nan_k, nan_p = torch.isnan(got), torch.isnan(want)
        same_nan = torch.equal(nan_k, nan_p)
        max_abs = float(torch.where(nan_p, 0.0, (got - want).abs()).max())
        nan_rows = int(nan_p.any(-1).sum())
        expected_nan = int((edge == R).sum()) if kind == "take" else 0
        ms = cuda_time_many_ms(lambda: kern(table, idx))
        device_ms, traced = profiled_device_ms(lambda: kern(table, idx), f"{kind}_kernel")
        plain_ms = cuda_time_many_ms(lambda: plain(table, idx))
        library_ms = cuda_time_many_ms(lambda: torch.index_select(table, 0, idx))
        nbytes = 4.0 * (M + R * F + M * F)  # idx and table read once, out written once
        bound_ms = nbytes / HBM_RATE * 1e3
        # take reads every table through L1 and L2; loop stages the table
        # and each round's indices in shared memory
        design = ({"staged": False, "rows_per_thread": lib.sst_row_gather_take_rows(F)}
                  if kind == "take" else {"staged": True})
        rec = {"kernel": kind, "case": which, "R": R, "F": F, "M": M, **design,
               "max_abs_err": max_abs, "nan_rows": nan_rows, "same_nan": same_nan, "ms": ms,
               "device_ms": device_ms, "traced_launches": traced, "launch_gap_ms": ms - device_ms,
               "plain_ms": plain_ms, "library_ms": library_ms, "bytes": nbytes,
               "bound_ms": bound_ms, "bound_by": "bytes", "bound_share": bound_ms / ms,
               "rows_per_s": M / ms * 1e3, "library_rows_per_s": M / library_ms * 1e3}
        recs.append(rec)
        log("probe", json.dumps(rec))
        check(same_nan and nan_rows == expected_nan,
              f"{kind} R={R}: NaN rows {nan_rows}, expected {expected_nan}, same places {same_nan}")
        check(max_abs == 0.0, f"{kind} R={R}: kernel and plain version differ by {max_abs}")
        del table, idx, edge, got, want
    LAUNCHES.update(launches)  # comparison launches are not the probe's
    return {"launches": launches, "cases": recs}


def rel_fro(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| (0 when both are 0)."""
    num, den = float(torch.linalg.vector_norm(a - b)), float(torch.linalg.vector_norm(b))
    return num / den if den > 0 else num


def grads_of(trainer, total):
    """Every group's gradient as one flat vector (zeros where unused)."""
    from sdfstudio_tpu_torch.engine.trainer import group_grads

    g = group_grads(total, trainer.optimizers)
    return {name: torch.cat([(t if t is not None else torch.zeros_like(p)).reshape(-1)
                             for t, p in zip(g[name], opt.params)])
            for name, opt in trainer.optimizers.items()}


def train_phase(fm) -> dict:
    """Train p8 on the committed scene, check it, compare the kernel step with
    the plain one and the backward kernel with its plain version, profile one
    step. Returns what the ``kernels`` line reports."""
    from sdfstudio_tpu_torch.engine.trainer import loss_and_metrics
    from sdfstudio_tpu_torch.scripts.train import setup_trainer

    if not os.path.isfile(os.path.join(SCENE, "meta_data.json")):
        raise FileNotFoundError(
            f"the committed DTU-like scene is missing: {SCENE} (the train phase needs "
            ".parity/dtu_like in the checkout)")
    t = time.perf_counter()
    trainer = setup_trainer("neus-facto-tpu-p8", SCENE, max_num_iterations=TRAIN_STEPS,
                            num_rays=TRAIN_RAYS, device="cuda")
    torch.cuda.synchronize()
    dm, model = trainer.datamanager, trainer.model
    log("train", f"scene {tuple(dm.train_data['image'].shape)} on the card, model and trainer set up "
        f"in {time.perf_counter() - t:.2f} s; {sum(p.numel() for p in model.parameters())} parameters")

    # a fixed probe batch, rendered without jitter before and after training
    probe_gen = torch.Generator(device="cuda").manual_seed(123)
    probe_idx, probe = dm.sample_train_batch(probe_gen)
    probe_rb = dm.generate_rays(probe_idx)
    probe_sched = model.schedules(TRAIN_STEPS)

    def probe_l1():
        out = model.get_outputs(probe_rb, sched=probe_sched, train=False)
        return float(torch.mean(torch.abs(out["rgb"] - probe["image"])))

    l1_before = probe_l1()

    prop = trainer.optimizers["proposal_networks"].params
    moved, step_ms, rows = {}, [], []
    torch.cuda.synchronize()
    fm.reset_launch_counts()
    # steps 0-11 one at a time, each synchronised, for the checks of steps
    # 10 and 11 and the per-step times (a side statistic)
    for i in range(CHECK_STEPS):
        before = [p.detach().clone() for p in prop] if i in (10, 11) else None
        t = time.perf_counter()
        rows.append(trainer.train_step())
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        if before is not None:
            moved[i] = any(not torch.equal(a, b) for a, b in zip(before, prop))
    # the remaining steps as a user runs them: Trainer.train, which reads the
    # metrics back once per log interval, with one synchronise at the end
    t = time.perf_counter()
    last = trainer.train()
    torch.cuda.synchronize()
    window_ms = (time.perf_counter() - t) * 1e3
    launches = dict(fm.LAUNCHES)
    check(trainer.step == TRAIN_STEPS, f"Trainer.train stopped at step {trainer.step}")
    metrics = torch.stack(rows).cpu()
    keys = list(trainer.metric_keys)
    log("train", f"{TRAIN_STEPS} steps of {TRAIN_RAYS} rays; launches {launches}; first step "
        f"{step_ms[0]:.1f} ms; losses at 0 / {TRAIN_STEPS - 1}: "
        + " ".join(f"{k}={metrics[0, j]:.5g}/{last[k]:.5g}" for j, k in enumerate(keys)))
    check(bool(torch.isfinite(metrics).all()) and all(math.isfinite(v) for v in last.values()),
          "a training loss or metric is not finite")
    check(launches["fused_mlp_fwd"] > 0 and launches["fused_mlp_bwd"] > 0,
          f"the training steps did not launch both kernels: {launches}")
    n_frozen = sum(not model.schedules(i)["train_proposal"] for i in range(TRAIN_STEPS))
    # 3 forward calls a step; 3 backward calls on an update step, the color net's alone on a frozen one
    check(launches["fused_mlp_fwd"] == 3 * TRAIN_STEPS
          and launches["fused_mlp_bwd"] == 3 * TRAIN_STEPS - 2 * n_frozen,
          f"expected {3 * TRAIN_STEPS} forward and {3 * TRAIN_STEPS - 2 * n_frozen} backward launches")
    check(model.schedules(10)["train_proposal"] and moved[10], "the proposal nets did not move on step 10")
    check(not model.schedules(11)["train_proposal"] and not moved[11],
          "the proposal nets moved on frozen step 11")
    l1_after = probe_l1()
    log("train", f"probe batch rgb L1 before {l1_before:.6f}, after {l1_after:.6f}; proposal nets "
        f"moved on update step 10: {moved[10]}, on frozen step 11: {moved[11]}")
    check(l1_after < l1_before, f"probe rgb L1 did not fall: {l1_before} -> {l1_after}")
    n_window = TRAIN_STEPS - CHECK_STEPS
    train_ms = window_ms / n_window
    warm = step_ms[3:]
    log("train", f"Trainer.train, steps {CHECK_STEPS}-{TRAIN_STEPS - 1}: {window_ms:.2f} ms, "
        f"{train_ms:.2f} ms a step, {TRAIN_RAYS / train_ms * 1e3:.0f} rays/s; steps 3-{CHECK_STEPS - 1} "
        f"one at a time, each synchronised: median {float(np.median(warm)):.2f} ms "
        f"(min {min(warm):.2f}, max {max(warm):.2f})")

    # one step twice from the same state: the kernels, then the plain versions
    sched = model.schedules(trainer.step)
    check(sched["train_proposal"], f"step {trainer.step} is not an update step")

    def one_step(capture=None):
        gen = torch.Generator(device="cuda").manual_seed(777)
        idx, batch = dm.sample_train_batch(gen)
        total, ld, _ = loss_and_metrics(model, dm.generate_rays(idx), batch, sched, gen)
        return {k: float(v.detach()) for k, v in ld.items()}, grads_of(trainer, total)

    calls: list = []
    with capture_fused_mlp_calls(calls):
        k_loss, k_grads = one_step()
    with swap_fused_mlp(fm.fused_mlp_plain):
        p_loss, p_grads = one_step()
    loss_err = {k: abs(k_loss[k] - p_loss[k]) / max(abs(p_loss[k]), 1e-12) for k in p_loss}
    grad_err = {g: rel_fro(k_grads[g], p_grads[g]) for g in p_grads}
    log("train", f"kernel step vs plain step: loss rel err {loss_err} (tol {STEP_LOSS_TOL}); "
        f"gradient rel err {grad_err} (tol {STEP_GRAD_TOL})")
    for k, e in loss_err.items():
        check(e <= STEP_LOSS_TOL, f"{k}: kernel step and plain step differ by {e}")
    for g, e in grad_err.items():
        check(e <= STEP_GRAD_TOL, f"{g} gradient: kernel step and plain step differ by {e}")

    # the backward kernel against fused_mlp_bwd_plain on the three captured calls
    check(len(calls) == 3 and all("g" in c for c in calls),
          f"expected 3 fused_mlp calls with a backward, captured {len(calls)}")
    before = dict(fm.LAUNCHES)
    names = ["proposal_0", "proposal_1", "color"]
    bwd_calls, fwd_calls = [], []
    for name, c in zip(names, calls):
        x = c["x"].reshape(-1, c["x"].shape[-1])
        g = c["g"].reshape(-1, c["g"].shape[-1]).contiguous()
        ws, bs, act, out_act, need_dx = c["ws"], c["bs"], c["act"], c["out_act"], c["need_dx"]
        with torch.no_grad():
            kern = fm.fused_mlp_bwd(x, ws, bs, g, act, out_act, need_dx)
            plain = fm.fused_mlp_bwd_plain(x, ws, bs, g, act, out_act, need_dx)
            torch.cuda.synchronize()
            pairs = [(f"dW{i}", a, b) for i, (a, b) in enumerate(zip(kern[1], plain[1]))]
            pairs += [(f"db{i}", a, b) for i, (a, b) in enumerate(zip(kern[2], plain[2]))]
            if need_dx:
                pairs.append(("dx", kern[0], plain[0]))
            rel = {n: rel_fro(a, b) for n, a, b in pairs}
            max_abs = max(float((a - b).abs().max()) for _, a, b in pairs)
            reps = 10
            k_ms = cuda_time_ms(lambda: fm.fused_mlp_bwd(x, ws, bs, g, act, out_act, need_dx), reps)
            p_ms = cuda_time_ms(lambda: fm.fused_mlp_bwd_plain(x, ws, bs, g, act, out_act, need_dx), reps)
            fk_ms = cuda_time_ms(lambda: fm.fused_mlp(x, ws, bs, act, out_act), reps)
            fp_ms = cuda_time_ms(lambda: fm.fused_mlp_plain(x, ws, bs, act, out_act), reps)
            if name == "color":
                # the fixed split count and reduction order make the kernel
                # repeat itself bit for bit
                again = [fm.fused_mlp_bwd(x, ws, bs, g, act, out_act, need_dx) for _ in range(2)]
                torch.cuda.synchronize()
                flat = [[t for t in ([r[0]] if need_dx else []) + list(r[1]) + list(r[2])]
                        for r in [kern] + again]
                same_bits = all(torch.equal(a_, b_) for other in flat[1:]
                                for a_, b_ in zip(flat[0], other))
                log("kernel", f"backward kernel on the color call three times: bitwise equal "
                    f"dx, dW, db: {same_bits}")
                check(same_bits, "the backward kernel gave different bits on the same inputs")
        flop, nbytes, scratch, dims, n = mlp_bwd_work(x, ws, need_dx)
        bound_ms, bound_fp32, bound_by = bounds(flop, nbytes)
        rec = {"call": name, "rows": n, "dims": dims, "act": act, "need_dx": need_dx, "flop": flop,
               "bytes": nbytes, "scratch_bytes": scratch, "max_abs_err": max_abs, "rel_err": rel,
               "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms, "bound_ms_fp32": bound_fp32,
               "bound_by": bound_by, "bound_ms_with_scratch": bounds(flop, nbytes + scratch)[0]}
        bwd_calls.append(rec)
        log("kernel", json.dumps(rec))
        for n_, e in rel.items():
            check(e <= BWD_TOL, f"{name} {n_}: backward kernel vs plain rel error {e} > {BWD_TOL}")
        fflop, fbytes, _, _ = mlp_work(x, ws)
        fb, fb32, _ = bounds(fflop, fbytes)
        fwd_calls.append({"call": name, "rows": n, "ms": fk_ms, "plain_ms": fp_ms,
                          "bound_ms": fb, "bound_ms_fp32": fb32})
    fm.LAUNCHES.update(before)  # comparison launches are not the main path's

    # where a step's time goes: one traced step (an update step)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        trainer.train_step()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t) * 1e3
    profile = {"step": trainer.step - 1, "traced_wall_ms": traced_ms, **render_breakdown(
        prof.events(), traced_ms,
        windows=[("backward (between forward and optimizer)", "sst/train_forward", "sst/train_optimizer")])}
    log("train_profile", json.dumps(profile))
    return {"launches": launches, "step_ms": train_ms, "rays_per_s": TRAIN_RAYS / train_ms * 1e3,
            "synced_step_median_ms": float(np.median(warm)),
            "bwd_calls": bwd_calls, "fwd_calls": fwd_calls, "profile": profile,
            "probe_l1": [l1_before, l1_after], "step_loss_err": loss_err, "step_grad_err": grad_err}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from sdfstudio_tpu_torch.cameras.cameras import Cameras
    from sdfstudio_tpu_torch.configs.methods import build_model
    from sdfstudio_tpu_torch.core.scene_box import SceneBox
    from sdfstudio_tpu_torch.engine.final_eval import UNTRAINED_STEP, render_image, set_fp32_precision
    from sdfstudio_tpu_torch.ops import fused_mlp as fm
    from sdfstudio_tpu_torch.utils import cuda_build

    # 1. device -------------------------------------------------------------
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log("device", f"nvidia-smi: {smi} | torch: {kind} | count {torch.cuda.device_count()} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    set_fp32_precision()

    # 2. build --------------------------------------------------------------
    shutil.rmtree(cuda_build.BUILD_DIR, ignore_errors=True)
    t = time.perf_counter()
    _, build_log = cuda_build.build(force=True, verbose=True)
    build_s = time.perf_counter() - t
    ptxas = ptxas_report(build_log)
    log("build", f"ptxas (registers, spill stores and loads in bytes, per kernel): {json.dumps(ptxas)}")
    log("build", f"nvcc built {cuda_build.LIB_PATH.name} in {build_s:.2f} s")
    sass = {}
    sass_counts_all = sass_counts(cuda_build.LIB_PATH)
    for fn_name, c in sass_counts_all.items():
        for kernel in ("fused_mlp_fwd", "fused_mlp_bwd", "row_gather", "split_kernel"):
            if kernel in fn_name:
                tot = sass.setdefault(kernel, {"HGMMA": 0, "HMMA": 0, "functions": 0})
                tot["HGMMA"] += c["HGMMA"]
                tot["HMMA"] += c["HMMA"]
                tot["functions"] += 1
    log("build", f"tensor-core instructions in the SASS (cuobjdump -sass): {json.dumps(sass)}")
    check(sass.get("fused_mlp_fwd", {}).get("HGMMA", 0) > 0
          and sass.get("fused_mlp_bwd", {}).get("HGMMA", 0) > 0,
          f"the fused-MLP kernels issue no wgmma: {sass}")
    # the row gathers' memory instructions with their cache hints
    gather_mem = {}
    for fn_name, c in sass_counts_all.items():
        for kernel in ("take_kernel", "loop_kernel"):
            if kernel in fn_name:
                tot = gather_mem.setdefault(kernel, {})
                for form, n in c["mem"].items():
                    tot[form] = tot.get(form, 0) + n
    log("build", f"row-gather global loads, stores and bulk copies by form (cuobjdump -sass): "
        f"{json.dumps(gather_mem)}")
    for kernel, forms in gather_mem.items():
        stores = {f: n for f, n in forms.items() if f.startswith("STG")}
        check(stores and all(".EF" in f for f in stores),
              f"{kernel}: a store without the evict-first hint: {stores}")
    check(any(f.startswith("LDG") and ".EF" in f for f in gather_mem.get("take_kernel", {})),
          f"take_kernel loads no index evict-first: {gather_mem.get('take_kernel')}")
    check(any(f.startswith("UBLKCP") for f in gather_mem.get("loop_kernel", {})),
          f"loop_kernel stages nothing by bulk copy: {gather_mem.get('loop_kernel')}")
    cuda_build.load_library()

    # 3. slice --------------------------------------------------------------
    scene_box = SceneBox(
        aabb=np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], np.float32),
        near=0.8, far=4.0, radius=1.0, collider_type="near_far",
    )
    t = time.perf_counter()
    model = build_model("neus-facto-tpu-p8", scene_box, num_train_data=1, seed=SEED, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    log("slice", f"neus-facto-tpu-p8 at full width, seed {SEED}: {n_params} parameters "
        f"({time.perf_counter() - t:.2f} s)")

    # radius of the init's near-sphere: bisect the SDF along the six axis directions
    axes = torch.tensor([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1.0]],
                        device="cuda")
    lo, hi = torch.zeros(6, device="cuda"), torch.ones(6, device="cuda")

    def sdf(p):
        with torch.no_grad():
            return model.field.geonetwork_with_gradient(model.field.contract_positions(p))[0][..., 0]

    check(bool(sdf(torch.zeros(1, 3, device="cuda")) < 0) and bool((sdf(axes) > 0).all()),
          "init SDF does not bracket a surface between the origin and the unit axes")
    for _ in range(40):
        mid = (lo + hi) / 2
        inside = sdf(axes * mid[:, None]) < 0
        lo, hi = torch.where(inside, mid, lo), torch.where(inside, hi, mid)
    radii = lo.cpu().numpy()
    radius = float(radii.mean())
    log("slice", f"init SDF zero crossing along +-x,+-y,+-z: {np.round(radii, 4).tolist()}, "
        f"mean radius {radius:.4f}")

    c2w = np.eye(4)[:3].copy()
    c2w[2, 3] = CAM_DIST  # at (0, 0, 2), looking down -z at the origin
    cams = Cameras.create(c2w, FOCAL, FOCAL, IMAGE / 2, IMAGE / 2, IMAGE, IMAGE, device="cuda")

    torch.cuda.synchronize()
    fm.reset_launch_counts()
    t = time.perf_counter()
    out = render_image(model, cams, 0, chunk=1024)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    launches = dict(fm.LAUNCHES)
    n_chunks = math.ceil(IMAGE * IMAGE / 1024)
    log("slice", f"rendered {IMAGE}x{IMAGE} in {n_chunks} chunks, first call {first_s * 1e3:.1f} ms; "
        f"launches {launches}")
    check(launches["fused_mlp_fwd"] > 0, "the render launched no fused_mlp_fwd kernel")
    check(launches["fused_mlp_fwd"] == 3 * n_chunks,
          f"expected 3 fused_mlp_fwd launches per chunk, got {launches['fused_mlp_fwd']}")

    for k, v in out.items():
        check(bool(torch.isfinite(v).all()), f"{k} has non-finite values")
    rb = cams.generate_image_rays(0)
    o, d = rb.origins, rb.directions
    p = torch.linalg.vector_norm(torch.cross(o, d, dim=-1), dim=-1).reshape(IMAGE, IMAGE)
    acc = out["accumulation"][..., 0]
    inner, outer = p < 0.5 * radius, p > 1.5 * radius
    acc_in, acc_out = float(acc[inner].min()), float(acc[outer].max())
    log("slice", f"accumulation: min {acc_in:.4f} on {int(inner.sum())} rays within 0.5 r, "
        f"max {acc_out:.4f} on {int(outer.sum())} rays beyond 1.5 r")
    check(acc_in > 0.9, f"accumulation {acc_in} <= 0.9 inside the sphere")
    check(acc_out < 0.1, f"accumulation {acc_out} >= 0.1 outside the sphere")
    # analytic sphere depth on the hits, in the renderer's convention (distance / ||d_cam||)
    b = -(o * d).sum(-1).reshape(IMAGE, IMAGE)
    t_hit = b - torch.sqrt(torch.clamp(radius**2 - p**2, min=0.0))
    dn = rb.directions_norm.reshape(IMAGE, IMAGE)
    depth_err = float((out["depth"][..., 0] - t_hit / dn)[inner].abs().max())
    # the init surface lies between the smallest and largest axis radius, and
    # the soft NeuS transition at inv_s = exp(3) ~ 20 blurs it by ~0.05
    depth_tol = float(radii.max() - radii.min()) + 0.05
    log("slice", f"depth vs analytic sphere on the hits: max |err| {depth_err:.4f} (tol {depth_tol:.4f})")
    check(depth_err < depth_tol, f"depth error {depth_err} >= {depth_tol}")

    t = time.perf_counter()
    render_image(model, cams, 0, chunk=1024)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t) * 1e3
    log("slice", f"warm render: {warm_ms:.1f} ms per {IMAGE}x{IMAGE} image")

    # where the time goes: wall, busy and idle share all from one traced
    # render (the profiler's host cost stretches that wall beyond warm_ms)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        render_image(model, cams, 0, chunk=1024)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t) * 1e3
    profile = {"traced_wall_ms": traced_ms, **render_breakdown(prof.events(), traced_ms)}
    log("profile", json.dumps(profile))

    # the card path against the CPU path (plain versions) on 256 rays of the view
    sel = torch.arange(IMAGE // 2 * IMAGE, IMAGE // 2 * IMAGE + 256, device="cuda")
    sub = rb.map(lambda x: x[sel])
    with torch.no_grad():
        gpu_out = model.get_outputs(sub, sched=model.schedules(UNTRAINED_STEP))
        model_cpu = build_model("neus-facto-tpu-p8", scene_box, num_train_data=1, seed=SEED,
                                device="cpu")
        cpu_out = model_cpu.get_outputs(sub.map(lambda x: x.cpu()),
                                        sched=model_cpu.schedules(UNTRAINED_STEP))
    slice_err = {k: float((gpu_out[k].cpu() - cpu_out[k]).abs().max())
                 for k in ("rgb", "accumulation", "depth", "normal")}
    log("slice", f"card vs CPU plain path on 256 rays, max |diff|: {slice_err} (tol {SLICE_TOL})")
    for k, e in slice_err.items():
        check(e < SLICE_TOL, f"{k}: card and CPU paths differ by {e}")

    # 4. kernel against plain ---------------------------------------------
    calls: list = []
    chunk_rb = rb.map(lambda x: x[:1024])
    with capture_fused_mlp_calls(calls), torch.no_grad():
        model.get_outputs(chunk_rb, sched=model.schedules(UNTRAINED_STEP))
    check(len(calls) == 3, f"expected 3 fused_mlp calls per chunk, captured {len(calls)}")
    names = ["proposal_0", "proposal_1", "color"]
    per_call = []
    before = fm.LAUNCHES["fused_mlp_fwd"]
    for name, c in zip(names, calls):
        x, ws, bs, act, out_act = c["x"], c["ws"], c["bs"], c["act"], c["out_act"]
        with torch.no_grad():
            y_k = fm.fused_mlp(x, ws, bs, act, out_act)
            y_p = fm.fused_mlp_plain(x, ws, bs, act, out_act)
            torch.cuda.synchronize()
            err = float((y_k - y_p).abs().max())
            scale = float(y_p.abs().max()) + 1.0
            k_ms = cuda_time_ms(lambda: fm.fused_mlp(x, ws, bs, act, out_act))
            p_ms = cuda_time_ms(lambda: fm.fused_mlp_plain(x, ws, bs, act, out_act))
        flop, nbytes, dims, n = mlp_work(x, ws)
        bound_ms, bound_fp32, bound_by = bounds(flop, nbytes)
        rec = {"call": name, "rows": n, "dims": dims, "act": act, "flop": flop, "bytes": nbytes,
               "max_abs_err": err, "rel_err": err / scale, "ms": k_ms, "plain_ms": p_ms,
               "bound_ms": bound_ms, "bound_ms_fp32": bound_fp32, "bound_by": bound_by}
        per_call.append(rec)
        log("kernel", json.dumps(rec))
        # f32 accuracy on both sides (the plain side with TF32 off, the
        # kernel in 3xTF32, whose products keep ~21 bits of each operand):
        # the error stays within a few K * 2^-22 of the output scale
        check(err / scale <= KERNEL_TOL, f"{name}: kernel vs plain error {err / scale} > {KERNEL_TOL}")
    fm.LAUNCHES["fused_mlp_fwd"] = before  # comparison launches are not the main path's

    # 5. train --------------------------------------------------------------
    train = train_phase(fm)

    # 6. probe ---------------------------------------------------------------
    probe = probe_phase()

    # 7. results ------------------------------------------------------------
    bwd = train["bwd_calls"]

    def gather_entry(kind: str, replaces: str) -> dict:
        name = f"row_gather_{kind}"
        mine = [r for r in probe["cases"] if r["kernel"] == kind]
        at_probe = [r for r in mine if r["case"] == "probe"]
        return {
            "name": name,
            "route": "cuda",
            "source": "sdfstudio_tpu_torch/csrc/row_gather.cu",
            "replaces": replaces,
            "launches": probe["launches"][name],
            "launches_render": launches[name],
            "launches_train": train["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": sum(r["ms"] for r in at_probe),
            "device_ms": sum(r["device_ms"] for r in at_probe),
            "plain_ms": sum(r["plain_ms"] for r in at_probe),
            "bound_ms": sum(r["bound_ms"] for r in at_probe),
            "bound_share": sum(r["bound_ms"] for r in at_probe) / sum(r["ms"] for r in at_probe),
            "bound_by": "bytes",
            "library_ms": sum(r["library_ms"] for r in at_probe),
            "per_shape": mine,
        }

    kernels = {"kernels": [{
        "name": "fused_mlp_fwd",
        "route": "cuda",
        "source": "sdfstudio_tpu_torch/csrc/fused_mlp_fwd.cu",
        "replaces": "sdfstudio_tpu/ops/pallas_mlp.py:94",
        "launches": launches["fused_mlp_fwd"] + train["launches"]["fused_mlp_fwd"],
        "launches_render": launches["fused_mlp_fwd"],
        "launches_train": train["launches"]["fused_mlp_fwd"],
        "max_abs_err": max(r["max_abs_err"] for r in per_call),
        "ms": sum(r["ms"] for r in per_call),
        "plain_ms": sum(r["plain_ms"] for r in per_call),
        "bound_ms": sum(r["bound_ms"] for r in per_call),
        "bound_ms_fp32": sum(r["bound_ms_fp32"] for r in per_call),
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in per_call) else "bytes",
        "library_ms": None,
        "per_chunk_calls": per_call,
        "image_ms": warm_ms,
        "image_device_idle_share_traced": profile["device_idle_share"],
        "build_s": build_s,
        "sass": sass.get("fused_mlp_fwd"),
        "ptxas": {k: v for k, v in ptxas.items() if k.startswith(("fused_mlp_fwd", "split"))},
        "train_step_calls": train["fwd_calls"],
    }, {
        "name": "fused_mlp_bwd",
        "route": "cuda",
        "source": "sdfstudio_tpu_torch/csrc/fused_mlp_bwd.cu",
        "replaces": "sdfstudio_tpu/ops/pallas_mlp.py:151",
        "launches": train["launches"]["fused_mlp_bwd"],
        "max_abs_err": max(r["max_abs_err"] for r in bwd),
        "ms": sum(r["ms"] for r in bwd),
        "plain_ms": sum(r["plain_ms"] for r in bwd),
        "bound_ms": sum(r["bound_ms"] for r in bwd),
        "bound_ms_fp32": sum(r["bound_ms_fp32"] for r in bwd),
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in bwd) else "bytes",
        "bound_ms_with_scratch": sum(r["bound_ms_with_scratch"] for r in bwd),
        "library_ms": None,
        "per_step_calls": bwd,
        "sass": sass.get("fused_mlp_bwd"),
        "ptxas": {k: v for k, v in ptxas.items() if k.startswith("fused_mlp_bwd")},
        "train_step_ms": train["step_ms"],
        "train_rays_per_s": train["rays_per_s"],
        "train_synced_step_median_ms": train["synced_step_median_ms"],
        "train_step_device_idle_share_traced": train["profile"]["device_idle_share"],
    }, gather_entry("take", "sdfstudio_tpu/scripts/benchmarking/probe_gather2.py:117"),
        gather_entry("loop", "sdfstudio_tpu/scripts/benchmarking/probe_gather2.py:149")]}
    log("done", f"total {time.perf_counter() - T0:.1f} s")
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
