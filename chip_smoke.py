#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training and evaluation paths once on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own line with wall-clock seconds:

1. device: ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``;
2. build: the CUDA kernels from a clean ``sdfstudio_tpu_torch/_build/``,
   with ptxas's registers and spills per kernel and, from ``cuobjdump
   -sass`` of the built library, each kernel's count of tensor-core
   instructions (``HGMMA``, Hopper's warpgroup MMA) and the row gathers' and
   hash-grid kernels' memory instructions by form (evict-first stores,
   atomic reductions, the float4 reduction of a corner pair); beside it
   nvcc builds ``scripts/benchmarking/hash_grid_designs.cu``, which keeps
   the first design of the hash-grid kernels as a baseline;
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
   the kernels and with every kernel swapped for its plain version, and
   the losses and every group's gradient compared; the three fused-MLP
   calls of that step are captured, each kernel is compared with its plain
   version (``fused_mlp_bwd_plain``, ``fused_mlp_plain``) and timed, and
   the backward runs twice more on the color call, whose results must be
   the same bits; one step runs under ``torch.profiler``;
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
   beside it (the gap between the two is the launch's; a trace that misses
   more than half the launches is taken again, up to three times, and the
   device time is then reported as null: the launches are counted by the
   port's own counters); each case reports its share of the bytes bound and
   the design the kernel took;
7. final_eval: the JAX package's committed 20k ``neus-facto-tpu-p8``
   checkpoint (its size and the sha256 of ``packed.npz`` printed) is loaded
   by the port's numpy reader through the trainer's resume; on one 8192-ray
   chunk of view 0 at the trained step the fused forward kernel is held to
   its plain version per call, and the rendered rays of the kernel path to
   those of the plain path (beside the plain path's own CPU run); then
   ``run_final_eval`` scores it at full size (49 views in
   8192-ray chunks, the 256^3 mesh, Chamfer-L1): held to the
   ``parity_metrics.json`` JAX wrote beside the checkpoint within
   ``EVAL_TOL``, and views 0, 24 and 48 to JAX's f32 CPU render of them
   (``engine/jax_cpu_eval_p8_20k.json``) within ``EVAL_REF_PSNR_TOL``;
8. resume: p8 trains 4 steps and saves, a fresh trainer loads the save
   (every parameter, Adam moment, count, step and the generator state equal
   the saved ones bit for bit) and trains 4 more, against 8 straight steps:
   bit for bit if the card repeats a step bit for bit, else within the
   train-step tolerance;
9. neus_facto: a full-width seeded ``neus-facto`` (hash grids) renders the
   view and is checked as in phase 3; one 1024-ray chunk of it runs again
   with every kernel swapped for its plain version on the card (and 256 of
   its rays on the CPU), and one render is traced. Then phase 5 runs for
   ``neus-facto`` (40 train steps, with the hash kernels' launch counts:
   the atomic table gradient on this path, never the deterministic one);
   its kernel step against the plain step captures the step's three hash
   calls (the SDF grid at 98,304 points with the jacobian, the proposal
   grids at 524,288 and 196,608 without): ``x`` and the cotangents autograd
   hands the backward. Both hash-grid kernels, and the deterministic table
   gradient's two kernels, are held to their plain versions on those
   inputs, on uniform points, and at F = 4 on ``neus-facto-tpu``'s grid
   (L8xF4, 2^19 rows, max resolution 512), on a table whose values identify
   their row, and timed beside the first design, their plain versions,
   ``index_select`` of the corner rows and ``index_add_`` of the corner
   updates, with each call's bytes and sector bounds. Then phase 8 runs for
   ``neus-facto`` with ``torch.use_deterministic_algorithms(True)``: the
   table gradients take the sorted segment sum, and the resumed run must
   equal the straight one bit for bit, parameters included;
10. surface: ``neus``, ``volsdf`` and ``unisurf`` (``surface[<method>]``)
   at full width from the seeded initialiser on the committed scene, with
   the NeRF background field: 40 steps of 1024 rays through
   ``Trainer.train`` (ms a step over steps 12-39, losses at steps 1 and 40),
   one step with the kernels against one with the plain versions (losses
   and gradients, 1e-4), both fused-MLP chains these methods add (the SDF
   field's colour net [321 -> 256 x4 -> 3] and the background's head [283
   -> 128 -> 128] with a relu output) captured from that step and held and
   timed alone (kernel, plain version, cuBLAS layer by layer, 3xTF32 and
   FP32 bounds), one traced step, and the scene's 384x384 view rendered with
   the kernels (its ms an image, warm after the training steps) and with
   the plain versions (the 0.999 quantile of rays held to 1e-3), and its
   first 12 chunks traced. Counted by chain, each must take a forward and
   a backward launch a step and a forward a chunk; each captured
   cotangent, each group's gradient and, on ``unisurf``, the count of rays
   with a surface point must not be zero. ``unisurf`` starts from the
   outward-facing init (``outward_sdf_init``): from the registered inward
   one every ray saturates at its first sample;
11. neuralangelo (``surface[neuralangelo]``): JAX's registered entry at
   full width (the 55,867,118 x 8 hash table at F = 8, numerical gradients,
   the progressive hash mask, the curvature loss, AdamW) from the seeded
   initialiser: 40 steps of its 512 rays through ``Trainer.train`` (the
   curvature term 0 at step 0 and positive from step 1), five hash forwards
   and one atomic backward a step; the kernel step against the plain step
   (hash-grid and fused-MLP kernels swapped) at step 0's schedule (4 of 16
   levels, delta 1/32) and step 75,000's (16 levels, delta 2/4096), with
   tolerances scaled by delta (``angelo_tols``) and the table's gradient
   exactly zero on the masked levels; the F = 8 kernels (forward, atomic
   backward, the deterministic pair) against their plain versions on the
   step's captured calls (``hash_case``) and timed beside the plain
   versions, ``index_select`` / ``index_add_`` and their bounds; both
   fused-MLP chains alone; two deterministic steps that must give the same
   bits; one traced step (encode, numerical gradient, geometry MLP, colour,
   background, the backward's hash kernels, AdamW); the view rendered with
   the kernels and without;
12. cli (``cli[<preset>]``): ``neus-facto-tpu``, ``neus-facto-tpu-p4`` and
   ``neus-facto-bigmlp`` (JAX's registered entries at full width; bigmlp
   from the outward-facing init, ``CLI_EXTRA``) through the train command
   with JAX's grammar: ``scripts/train.py::main`` with ``--experiment-name``,
   ``--output-dir``, ``--timestamp``, ``--vis none``, 40 steps, an eval
   image every 20 steps, the final evaluation (3 of the 7 eval views, the
   128^3 mesh) and ``sdfstudio-data --data .parity/dtu_like
   --skip-every-for-val-split 8``; the run's layout (``config.yml``, the
   step directory with ``step.txt``, the metrics, the mesh), the step-20
   eval image by JAX's index rule, the ms a step over steps 12-39 (the eval
   image taken out); launches counted exactly by kernel and by chain in the
   train steps (a step's captured calls times the steps, backwards on
   update steps only for the proposal nets), in each eval image, the final
   evaluation, ``scripts/eval.py`` and ``scripts/extract_mesh.py
   --resolution 128`` run on the written ``config.yml``; one kernel step
   against one plain step (losses and every group's gradient); p4's
   hidden-64 chains [39 / 51 -> 64 -> 64 -> 1] alone (a forward and a
   backward an update step); ``neus-facto-tpu``'s F = 4 hash kernels on the
   step's captured SDF call (``hash_case``);
13. the ``kernels`` JSON line (twelve kernels: the hash-grid four again at
   F = 8; the fused-MLP entries carry the surface chains' and p4's rows, the
   hash entries the cli phases' launches and the F = 4 captured call), the
   ``nvidia-smi`` line, and the result line.

``CUBLAS_WORKSPACE_CONFIG`` is set to ``:4096:8`` before the first CUDA
call (unless the caller set it), so that cuBLAS accepts the deterministic
mode of phase 9.

It imports torch, numpy, the standard library and ``sdfstudio_tpu_torch``
only (the judge imports scipy). Any failed check raises, so the exit code
is not 0 and no result line is printed. Without CUDA it exits with code 2;
it fails with a message when the scene or the checkpoint is missing.
"""
from __future__ import annotations

import bisect
import concurrent.futures
import contextlib
import copy
import dataclasses
import hashlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

# cuBLAS reads this when it starts: phase 9's deterministic mode needs it
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

T0 = time.perf_counter()
SEED = 0
IMAGE = 384  # the parity scene's image size (.parity/dtu_like/meta_data.json)
FOCAL = 422.4  # its intrinsics
CAM_DIST = 2.0
KERNEL_TOL = 1e-4  # max |kernel - plain| / (max |plain| + 1)
SLICE_TOL = 1e-3  # card path against the CPU path, on rgb / accumulation / depth
SCENE = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".parity", "dtu_like")
# the JAX package's scored 20k run of p8, checkpoint and parity_metrics.json
JAX_P8_RUN = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".parity", "runs", "parity",
                          "neus-facto-tpu-p8", "parity")
JAX_P8_STEP = 20000
# the port's card eval against the scores JAX wrote on the TPU, whose f32
# matmuls run at bf16 precision by default: the low end of the protocol's
# measured seed noise (0.14-0.2 dB, ~3% Chamfer; docs/parity-protocol.md)
EVAL_TOL = {"psnr": 0.15, "ssim": 0.002, "chamfer_l1_rel": 0.03}
EVAL_REF_PSNR_TOL = 0.02  # dB, views 0, 24, 48 against JAX's f32 render on the CPU
EVAL_CHUNK = 8192  # final_eval.py:80
# The trained render is held to SLICE_TOL on all but 0.1% of the rays of an
# 8192-ray chunk: at step 20,000 a few rays amplify rounding (a sample in a
# nearly empty bin of the PDF resampling, NeuS alpha at a sharp surface), and
# the plain f32 path alone, on the card and on the CPU, differs by up to
# 3.8e-3 in accumulation and 1.7e-2 in normal on 4-18 of 8192 rays (NVIDIA
# H100 80GB HBM3, 700 W); the fused forward itself is held per call.
RENDER_QUANTILE = 0.999
RESUME_STEPS = 4  # steps before the save, and after the load
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
# the hash-grid kernels against their plain versions on a table whose values
# identify their row: forward max |kernel - plain| / max |plain| (8 products
# a level summed in another order than the plain batched product); backward
# in relative Frobenius norm (atomics add a coarse row's ~10^5 updates in a
# run-dependent order, and so does the plain index_add_ on the card)
HASH_FWD_TOL = 1e-6
HASH_BWD_TOL = 1e-5
# neus-facto's encodes of one train step (2048 rays): the SDF grid at the
# 98,304 NeuS samples with the jacobian, the proposal grids at 256 and 96
# samples a ray without
HASH_STEP_POINTS = {"sdf": 98_304, "proposal_0": 2048 * 256, "proposal_1": 2048 * 96}
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
SURFACE_METHODS = ("neus", "volsdf", "unisurf")  # phase 10, at their registered 1024 rays a step
# phase 10's fused-MLP chains by their widths: the SDF field's colour net, the NeRF background's head
SURFACE_CHAINS = {"321-256-256-256-256-3": "color", "283-128-128": "background_head"}
# phase 11: Neuralangelo at its registered 512 rays a step. A step's encodes:
# one a round of the NeuS sampler (4 rounds, 64 + 3 x 16 points a ray,
# without a gradient) and one over the field's centre and six taps (7 x 512
# x 128 = 458,752 points) with the table's gradient; a render chunk the same
# without the gradient
ANGELO_FWD_PER_STEP = 5
ANGELO_FIELD_POINTS = 7 * 512 * 128
ANGELO_TABLE = (55_867_118, 8)  # 16 levels at 64-4096, 2^22 rows a hashed level
# the kernel step is held to the plain step at step 0 (4 of 16 levels, delta
# 2/64) and at step 75,000 (16 levels, delta 2/4096, as from then on)
ANGELO_SCHED_STEPS = (0, 75_000)
# The numerical gradient divides a difference of two taps' SDF by 2 delta and
# the curvature a second difference by delta^2, so a rounding difference e
# in the SDF between the two paths (their encodes add 8 products a level in
# another order) reaches the gradient as e / delta and the curvature as 4 e /
# delta^2. At delta_0 = 1/32 (step 0) every term is held to STEP_LOSS_TOL /
# STEP_GRAD_TOL, as the analytic methods are; at a smaller delta the terms
# first order in the gradient (rgb, eikonal, and the gradients of their sum)
# are held to that tolerance times delta_0 / delta, and the curvature loss and
# its gradient to it times (delta_0 / delta)^2.
ANGELO_DELTA0 = 1.0 / 32
# phase 12: the remaining neus-facto presets through JAX's command line
CLI_PRESETS = ("neus-facto-tpu", "neus-facto-tpu-p4", "neus-facto-bigmlp")
CLI_EVAL_STEP = 20  # --trainer.steps-per-eval-image
CLI_EVAL_SPLIT = 8  # --skip-every-for-val-split: 7 eval views
CLI_MESH_RES = 128  # --trainer.final-eval-resolution, extract_mesh.py --resolution
CLI_FINAL_IMAGES = 3  # --trainer.final-eval-max-images
# neus-facto-bigmlp is JAX's default field, whose init faces inwards (a camera
# inside the scene): on the object-centred parity scene its SDF turns negative
# over the whole cube within 40 steps and the final eval finds no surface (on
# the CPU at 256 rays: min / max -1.61 / -0.049 over a 33^3 grid at step 40),
# so it runs from the outward-facing init, set through JAX's grammar
CLI_EXTRA = {"neus-facto-bigmlp": ["--pipeline.model.sdf-field.inside-outside", "False"]}


def angelo_tols(delta: float):
    """(first-order, curvature) tolerance of the kernel step at ``delta``."""
    a = max(1.0, ANGELO_DELTA0 / delta)
    return STEP_LOSS_TOL * a, STEP_LOSS_TOL * a * a


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
                                     "split_kernel", "hash_fwd_kernel", "hash_bwd_kernel",
                                     "hash_corner_rows_kernel", "hash_segment_sum_kernel",
                                     "take", "loop") if k in mangled), mangled[-40:])
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
    with its count ({"STG.E.EF.128": n, ...}), atomics included (RED, ATOMG):
    a cache hint shows in the form (EF: evict-first)."""
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
            m = re.search(r"\b((?:LDG|STG|UBLKCP|RED|ATOMG)[\w.]*)", line)
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
def swap_hash_plain():
    """Route the hash-grid encode's forward and backward through their plain
    versions (on the card), as ``swap_fused_mlp`` routes the MLP."""
    from sdfstudio_tpu_torch.ops import hash_grid as hg

    orig = hg.hash_encode_fwd, hg.hash_encode_bwd
    hg.hash_encode_fwd, hg.hash_encode_bwd = hg.hash_encode_plain, hg.hash_encode_bwd_plain
    try:
        yield
    finally:
        hg.hash_encode_fwd, hg.hash_encode_bwd = orig


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
    each ``sst/*`` range of the model (proposal sampler, grid encode,
    geometry MLP with its gradient, color MLP, the train step's
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


def profiled_device_ms(fn, kernel: str, reps: int = 20, traces: int = 3):
    """Mean device time of one launch of ``fn()``'s kernel, whose name holds
    ``kernel``, over ``reps`` launches traced by ``torch.profiler``, and the
    number of launches the trace holds (it can miss the first few): beside
    the events' mean of back-to-back launches it shows the gap between
    launches. A trace that holds fewer than half the launches is taken
    again, up to ``traces`` times; if every one is short, the device time is
    None beside the count of the last. It is a measurement: the launches
    themselves are counted by the port's own counters."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    cuda = torch.autograd.DeviceType.CUDA
    durs = []
    for _ in range(traces):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        durs = [e.time_range.end - e.time_range.start for e in prof.events()
                if e.device_type == cuda and kernel in e.name]
        check(len(durs) <= reps, f"the profiler saw {len(durs)} {kernel} launches of {reps}")
        if len(durs) >= reps // 2:
            return sum(durs) / len(durs) / 1e3, len(durs)
    return None, len(durs)


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
               "device_ms": device_ms, "traced_launches": traced,
               "launch_gap_ms": None if device_ms is None else ms - device_ms,
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


def render_init_view(model, cams, fm, phase: str):
    """Render the seeded model's view through ``render_image`` in 1024-ray
    chunks and check it against the near-sphere of the geometric init:
    finite outputs, accumulation inside / outside the sphere, depth on the
    hits. Returns the launches of the render."""
    from sdfstudio_tpu_torch.engine.final_eval import render_image

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
    log(phase, f"init SDF zero crossing along +-x,+-y,+-z: {np.round(radii, 4).tolist()}, "
        f"mean radius {radius:.4f}")

    torch.cuda.synchronize()
    fm.reset_launch_counts()
    t = time.perf_counter()
    out = render_image(model, cams, 0, chunk=1024)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    launches = dict(fm.LAUNCHES)
    n_chunks = math.ceil(IMAGE * IMAGE / 1024)
    log(phase, f"rendered {IMAGE}x{IMAGE} in {n_chunks} chunks, first call {first_s * 1e3:.1f} ms; "
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
    log(phase, f"accumulation: min {acc_in:.4f} on {int(inner.sum())} rays within 0.5 r, "
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
    log(phase, f"depth vs analytic sphere on the hits: max |err| {depth_err:.4f} (tol {depth_tol:.4f})")
    check(depth_err < depth_tol, f"depth error {depth_err} >= {depth_tol}")
    return launches


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


def train_phase(fm, method: str = "neus-facto-tpu-p8") -> dict:
    """Train ``method`` on the committed scene, check it, compare the kernel
    step with the plain one (every kernel swapped for its plain version) and
    the fused kernels, forward and backward, with their plain versions at
    the step's shapes, profile one step.
    Returns what the ``kernels`` line reports."""
    from sdfstudio_tpu_torch.engine.trainer import loss_and_metrics
    from sdfstudio_tpu_torch.scripts.train import setup_method_trainer

    if not os.path.isfile(os.path.join(SCENE, "meta_data.json")):
        raise FileNotFoundError(
            f"the committed DTU-like scene is missing: {SCENE} (the train phase needs "
            ".parity/dtu_like in the checkout)")
    t = time.perf_counter()
    trainer = setup_method_trainer(method, SCENE, max_num_iterations=TRAIN_STEPS,
                                   num_rays=TRAIN_RAYS, device="cuda")
    torch.cuda.synchronize()
    dm, model = trainer.datamanager, trainer.model
    phase = "train" if method == "neus-facto-tpu-p8" else f"train[{method}]"
    log(phase, f"scene {tuple(dm.train_data['image'].shape)} on the card, model and trainer set up "
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
    log(phase, f"{TRAIN_STEPS} steps of {TRAIN_RAYS} rays; launches {launches}; first step "
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
    if model.field.config.encoding_type == "hash":
        # the SDF grid's encode once a step, each hash proposal field's on every
        # step and its backward on an update step only
        n_update = TRAIN_STEPS - n_frozen
        check(launches["hash_encode_fwd"] == 3 * TRAIN_STEPS
              and launches["hash_encode_bwd"] == TRAIN_STEPS + 2 * n_update,
              f"expected {3 * TRAIN_STEPS} hash forward and {TRAIN_STEPS + 2 * n_update} backward "
              f"launches, got {launches}")
    check(launches["hash_encode_bwd_det"] == 0 and launches["hash_segment_sum"] == 0,
          f"the deterministic table gradient ran with deterministic algorithms off: {launches}")
    check(model.schedules(10)["train_proposal"] and moved[10], "the proposal nets did not move on step 10")
    check(not model.schedules(11)["train_proposal"] and not moved[11],
          "the proposal nets moved on frozen step 11")
    l1_after = probe_l1()
    log(phase, f"probe batch rgb L1 before {l1_before:.6f}, after {l1_after:.6f}; proposal nets "
        f"moved on update step 10: {moved[10]}, on frozen step 11: {moved[11]}")
    check(l1_after < l1_before, f"probe rgb L1 did not fall: {l1_before} -> {l1_after}")
    n_window = TRAIN_STEPS - CHECK_STEPS
    train_ms = window_ms / n_window
    warm = step_ms[3:]
    log(phase, f"Trainer.train, steps {CHECK_STEPS}-{TRAIN_STEPS - 1}: {window_ms:.2f} ms, "
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

    from sdfstudio_tpu_torch.scripts.benchmarking.hash_grid_designs import capture_hash_calls

    calls: list = []
    hash_calls: list = []  # the step's hash-grid calls: x and the cotangents of their backward
    with capture_fused_mlp_calls(calls), capture_hash_calls(hash_calls):
        k_loss, k_grads = one_step()
    with swap_fused_mlp(fm.fused_mlp_plain), swap_hash_plain():
        p_loss, p_grads = one_step()
    loss_err = {k: abs(k_loss[k] - p_loss[k]) / max(abs(p_loss[k]), 1e-12) for k in p_loss}
    grad_err = {g: rel_fro(k_grads[g], p_grads[g]) for g in p_grads}
    log(phase, f"kernel step vs plain step: loss rel err {loss_err} (tol {STEP_LOSS_TOL}); "
        f"gradient rel err {grad_err} (tol {STEP_GRAD_TOL})")
    for k, e in loss_err.items():
        check(e <= STEP_LOSS_TOL, f"{k}: kernel step and plain step differ by {e}")
    for g, e in grad_err.items():
        check(e <= STEP_GRAD_TOL, f"{g} gradient: kernel step and plain step differ by {e}")

    # the forward and backward kernels against their plain versions on the three captured calls
    check(len(calls) == 3 and all("g" in c for c in calls),
          f"expected 3 fused_mlp calls with a backward, captured {len(calls)}")
    chains = chain_checks(fm, calls, ["proposal_0", "proposal_1", "color"], phase, method)
    same_bits = bwd_repeats_bitwise(fm, calls[2])
    log("kernel", f"backward kernel on the color call three times: bitwise equal dx, dW, db: {same_bits}")
    check(same_bits, "the backward kernel gave different bits on the same inputs")
    head = ("method", "call", "rows", "dims", "act", "need_dx")
    bwd_calls = [{**{k: c[k] for k in head}, **c["bwd"]} for c in chains]
    fwd_calls = [{**{k: c[k] for k in head}, **c["fwd"]} for c in chains]

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
    log(phase.replace("train", "train_profile"), json.dumps(profile))
    captured = {}
    if model.field.config.encoding_type == "hash":
        encs = {"sdf": model.field.encoding, "proposal_0": model.proposal_networks[0].encoding,
                "proposal_1": model.proposal_networks[1].encoding}
        for name, enc in encs.items():
            mine = [r for r in hash_calls if r["spec"] == enc.spec and "g_out" in r]
            check(len(mine) == 1, f"captured {len(mine)} {name} hash calls with a backward")
            check(mine[0]["x"].shape[0] == HASH_STEP_POINTS[name],
                  f"{name}: captured {mine[0]['x'].shape[0]} points, expected {HASH_STEP_POINTS[name]}")
            captured[name] = mine[0]
    return {"launches": launches, "step_ms": train_ms, "rays_per_s": TRAIN_RAYS / train_ms * 1e3,
            "synced_step_median_ms": float(np.median(warm)), "hash_captured": captured,
            "bwd_calls": bwd_calls, "fwd_calls": fwd_calls, "profile": profile,
            "probe_l1": [l1_before, l1_after], "step_loss_err": loss_err, "step_grad_err": grad_err}


def time_pair_ms(a, b, reps: int = 20):
    """Two functions timed in turns (a, b, b, a), each the mean of ``reps``
    back-to-back launches: their means."""
    ta = [cuda_time_many_ms(a, reps)]
    tb = [cuda_time_many_ms(b, reps), cuda_time_many_ms(b, reps)]
    ta.append(cuda_time_many_ms(a, reps))
    return sum(ta) / 2, sum(tb) / 2


def hash_case(phase: str, name: str, which: str, x, spec, R: int, F: int, want_jac: bool,
              g_out, g_jac, base=None) -> dict:
    """One hash-grid call's kernels against their plain versions on a
    row-identifying table, and timed: the forward; with a cotangent the
    atomic backward and the deterministic pair (corner rows exactly, the
    segment sum bit for bit across two runs). ``base`` (the first design's
    forward and backward, F = 2) is held and timed in turns beside the
    kernels. Timed by CUDA events beside the plain versions, the nearest
    library calls (the corner rows as one ``index_select``, the corner
    updates as one ``index_add_``, both precomputed), with the call's bytes
    and sector bounds. Fails on a disagreement."""
    from sdfstudio_tpu_torch.ops import hash_grid as hg
    from sdfstudio_tpu_torch.ops.scatter import sorted_segment_add
    from sdfstudio_tpu_torch.scripts.benchmarking import hash_grid_designs as hgd

    n, L = x.shape[0], spec.num_levels
    bwd = g_out is not None or g_jac is not None
    table = hgd.row_table(R, F)
    got = hg.hash_encode_fwd(x, table, spec, want_jac)
    want = hg.hash_encode_plain(x, table, spec, want_jac)
    got, want = (got, want) if want_jac else ((got,), (want,))
    fwd_err = hgd.fwd_err(got, want)
    fwd_abs = max(float((torch.nan_to_num(a) - torch.nan_to_num(b)).abs().max()) for a, b in zip(got, want))
    baseline_err = None
    if base is not None:
        baseline_err = hgd.fwd_err(base[0](x, table, spec, want_jac), want)
    del got, want
    stats = hgd.sector_stats(x, spec, R, F, pair=True)
    bnd = hgd.bounds(x, spec, R, F, want_jac, stats)
    corner = hg.table_rows(hg.corner_indices(x, spec)[0].reshape(-1), R)
    corner = torch.where(corner < R, corner, 0)
    if base is not None:
        f_ms, f_base_ms = time_pair_ms(lambda: hg.hash_encode_fwd(x, table, spec, want_jac),
                                       lambda: base[0](x, table, spec, want_jac))
    else:
        f_ms, f_base_ms = cuda_time_many_ms(lambda: hg.hash_encode_fwd(x, table, spec, want_jac), 20), None
    rec = {
        "call": name, "inputs": which, "points": n, "levels": L, "F": F, "rows": R,
        "jacobian": want_jac, "corner_reads": n * L * 8, **stats,
        "fwd": {"max_abs_err": fwd_abs, "rel_err": fwd_err, "ms": f_ms, "baseline_ms": f_base_ms,
                "plain_ms": cuda_time_ms(lambda: hg.hash_encode_plain(x, table, spec, want_jac), 3, 1),
                "library_ms": cuda_time_many_ms(lambda: table.index_select(0, corner), 20),
                "bytes": bnd["fwd_bytes"], "bound_ms": bnd["fwd_bound_ms"],
                "sector_bound_ms": bnd["fwd_sector_bound_ms"]},
        "baseline_err": baseline_err,
    }
    tag = f"{name} ({which})"
    check(fwd_err <= HASH_FWD_TOL, f"{tag}: hash forward kernel vs plain {fwd_err} > {HASH_FWD_TOL}")
    if bwd:
        grad = hg.hash_encode_bwd(x, g_out, g_jac, spec, R)
        ref = hg.hash_encode_bwd_plain(x, g_out, g_jac, spec, R)
        det = [hg.hash_encode_bwd_det(x, g_out, g_jac, spec, R) for _ in range(2)]
        keys, upd = hg.hash_corner_rows(x, g_out, g_jac, spec, R)
        rows_p, upd_p = hg.corner_updates(x, g_out, g_jac, spec)
        rows_p = hg.table_rows(rows_p, R)
        torch.cuda.synchronize()
        bwd_err, bwd_abs = rel_fro(grad, ref), float((grad - ref).abs().max())
        det_err, det_same = rel_fro(det[0], ref), torch.equal(det[0], det[1])
        det_abs = float((det[0] - ref).abs().max())
        keys_same = torch.equal(keys.long(), torch.where(rows_p < R, rows_p, R))
        upd_abs = float((upd - upd_p).abs().max())
        upd_err = upd_abs / max(float(upd_p.abs().max()), 1e-30)
        if base is not None:
            baseline_err = max(baseline_err, rel_fro(base[1](x, g_out, g_jac, spec, R), ref))
            rec["baseline_err"] = baseline_err
        del grad, det, rows_p, upd_p
        sorted_keys, perm = torch.sort(keys, stable=True)
        if base is not None:
            b_ms, b_base_ms = time_pair_ms(lambda: hg.hash_encode_bwd(x, g_out, g_jac, spec, R),
                                           lambda: base[1](x, g_out, g_jac, spec, R))
        else:
            b_ms = cuda_time_many_ms(lambda: hg.hash_encode_bwd(x, g_out, g_jac, spec, R), 20)
            b_base_ms = None
        rec["bwd"] = {
            "max_abs_err": bwd_abs, "rel_fro_err": bwd_err, "ms": b_ms, "baseline_ms": b_base_ms,
            "plain_ms": cuda_time_ms(lambda: hg.hash_encode_bwd_plain(x, g_out, g_jac, spec, R), 3, 1),
            "library_ms": cuda_time_many_ms(
                lambda: torch.zeros((R, F), device="cuda").index_add_(0, corner, upd), 20),
            "bytes": bnd["bwd_bytes"], "bound_ms": bnd["bwd_bound_ms"],
            "sector_bound_ms": bnd["bwd_sector_bound_ms"]}
        rec["det"] = {
            "rel_fro_err": det_err, "repeats_bitwise": det_same, "keys_exact": keys_same,
            "upd_rel_err": upd_err, "corner_rows_max_abs_err": upd_abs,
            "segment_sum_max_abs_err": det_abs,
            "ms": cuda_time_many_ms(lambda: hg.hash_encode_bwd_det(x, g_out, g_jac, spec, R), 10),
            "corner_rows_ms": cuda_time_many_ms(lambda: hg.hash_corner_rows(x, g_out, g_jac, spec, R), 10),
            "corner_rows_plain_ms": cuda_time_ms(lambda: hg.corner_updates(x, g_out, g_jac, spec), 3, 1),
            "corner_rows_bytes": bnd["bwd_bytes"] - 4.0 * F * R + 4.0 * (1 + F) * n * L * 8,
            "sort_ms": cuda_time_many_ms(lambda: torch.sort(keys, stable=True), 10),
            "segment_sum_ms": cuda_time_many_ms(lambda: hg.hash_segment_sum(sorted_keys, perm, upd, R), 10),
            "segment_sum_plain_ms": cuda_time_ms(lambda: sorted_segment_add(keys.long(), upd, R), 3, 1),
            "segment_sum_library_ms": cuda_time_many_ms(
                lambda: torch.zeros((R + 1, F), device="cuda").index_add_(0, keys.long(), upd), 10),
            "segment_sum_bytes": 4.0 * (3 + F) * n * L * 8 + 4.0 * F * R}
        for k in ("corner_rows", "segment_sum"):
            rec["det"][f"{k}_bound_ms"] = rec["det"][f"{k}_bytes"] / HBM_RATE * 1e3
        check(bwd_err <= HASH_BWD_TOL, f"{tag}: hash backward kernel vs plain {bwd_err} > {HASH_BWD_TOL}")
        check(det_err <= HASH_BWD_TOL and det_same,
              f"{tag}: deterministic backward vs plain {det_err}, repeats bit for bit: {det_same}")
        check(keys_same and upd_err <= HASH_FWD_TOL,
              f"{tag}: corner rows exact {keys_same}, updates vs plain {upd_err}")
        del keys, upd, sorted_keys, perm
    check(baseline_err is None or baseline_err <= HASH_BWD_TOL, f"{tag}: the first design vs plain {baseline_err}")
    log(phase, json.dumps(rec))
    del x, table, g_out, g_jac, corner
    torch.cuda.empty_cache()
    return rec


def hash_kernel_checks(captured: dict, designs) -> list:
    """Both hash-grid kernels, and the deterministic table gradient's two
    kernels, against their plain versions (``hash_case``): on the captured
    inputs of a ``neus-facto`` train step's three calls, on uniform points
    with 0 and 1.0 among them, and at F = 4 on ``neus-facto-tpu``'s grid
    (on the SDF call's captured points and on uniform ones); the F = 2 cases
    beside the first design, timed in turns."""
    from sdfstudio_tpu_torch.ops.encodings import HashEncoding
    from sdfstudio_tpu_torch.ops.launches import LAUNCHES
    from sdfstudio_tpu_torch.scripts.benchmarking import hash_grid_designs as hgd

    before = dict(LAUNCHES)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    base = (hgd.c_fwd(designs.sst_baseline_hash_encode_fwd),
            hgd.c_bwd(designs.sst_baseline_hash_encode_bwd))
    enc4 = HashEncoding(**hgd.F4_GRID)
    cases = []
    for name, r in captured.items():
        g_out, g_jac = r["g_out"], r["g_jac"]
        cases.append((name, "captured", r["x"], r["spec"], r["rows"], r["F"], r["want_jac"], g_out,
                      g_jac))
        x = torch.rand(r["x"].shape, generator=gen, device="cuda")
        x[0], x[1], x[2, 0] = 0.0, 1.0, 1.0
        rnd = [torch.randn(g.shape, generator=gen, device="cuda") if g is not None else None
               for g in (g_out, g_jac)]
        cases.append((name, "uniform", x, r["spec"], r["rows"], r["F"], r["want_jac"], *rnd))
    x_sdf, LF4 = captured["sdf"]["x"], enc4.out_dim
    for which in ("captured", "uniform"):
        x = x_sdf if which == "captured" else torch.rand(x_sdf.shape, generator=gen, device="cuda")
        n = x.shape[0]
        cases.append(("F4", which, x, enc4.spec, enc4.total_rows, 4, True,
                      torch.randn((n, LF4), generator=gen, device="cuda"),
                      torch.randn((n, LF4, 3), generator=gen, device="cuda")))
    recs = [hash_case("neus_facto", *c, base=base if c[5] == 2 else None) for c in cases]
    LAUNCHES.update(before)  # comparison launches are not the main path's
    return recs


def neus_facto_phase(fm, smi: str, cams, scene_box, designs) -> dict:
    """``neus-facto`` at full width: a seeded render of the view checked like
    p8's, one chunk of it against the plain path on the card and 256 rays
    against the CPU, a traced render, both hash-grid kernels against their
    plain versions at a train step's shapes, 40 train steps through
    ``train_phase`` and a save / load / resume through ``resume_phase``."""
    from sdfstudio_tpu_torch.configs.methods import build_model
    from sdfstudio_tpu_torch.engine.final_eval import UNTRAINED_STEP, render_image

    method = "neus-facto"
    t = time.perf_counter()
    model = build_model(method, scene_box, num_train_data=1, seed=SEED, device="cuda")
    log("neus_facto", f"{method} at full width, seed {SEED}: "
        f"{sum(p.numel() for p in model.parameters())} parameters, hash tables of "
        f"{model.field.encoding.total_rows} / "
        f"{[n.encoding.total_rows for n in model.proposal_networks]} rows "
        f"({time.perf_counter() - t:.2f} s)")
    launches = render_init_view(model, cams, fm, "neus_facto")
    n_chunks = math.ceil(IMAGE * IMAGE / 1024)
    check(launches["hash_encode_fwd"] == 3 * n_chunks and launches["hash_encode_bwd"] == 0,
          f"expected 3 hash_encode_fwd launches per chunk and no backward: {launches}")
    t = time.perf_counter()
    render_image(model, cams, 0, chunk=1024)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        render_image(model, cams, 0, chunk=1024)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t) * 1e3
    profile = {"warm_ms": warm_ms, "traced_wall_ms": traced_ms,
               **render_breakdown(prof.events(), traced_ms)}
    log("neus_facto_profile", json.dumps(profile))

    # one 1024-ray chunk across the centre of the view: the kernel path
    # against the plain path on the card; 256 of its rays against the CPU
    rb = cams.generate_image_rays(0)
    sel = torch.arange(IMAGE // 2 * IMAGE - 512, IMAGE // 2 * IMAGE + 512, device="cuda")
    sub = rb.map(lambda x: x[sel])
    sched = model.schedules(UNTRAINED_STEP)
    before = dict(fm.LAUNCHES)
    with torch.no_grad():
        k_out = model.get_outputs(sub, sched=sched)
        with swap_fused_mlp(fm.fused_mlp_plain), swap_hash_plain():
            p_out = model.get_outputs(sub, sched=sched)
        cpu_model = build_model(method, scene_box, num_train_data=1, seed=SEED, device="cpu")
        c_out = cpu_model.get_outputs(sub.map(lambda x: x[:256].cpu()),
                                      sched=cpu_model.schedules(UNTRAINED_STEP))
        del cpu_model
    torch.cuda.synchronize()
    fm.LAUNCHES.update(before)
    keys = ("rgb", "accumulation", "depth", "normal")
    chunk_err = {k: float((k_out[k] - p_out[k]).abs().max()) for k in keys}
    cpu_err = {k: float((k_out[k][:256].cpu() - c_out[k]).abs().max()) for k in keys}
    log("neus_facto", f"1024-ray chunk, kernel path vs plain path on the card, max |diff|: "
        f"{chunk_err}; 256 of its rays, card vs CPU plain path: {cpu_err} (tol {SLICE_TOL}); "
        f"max accumulation {float(k_out['accumulation'].max()):.4f}")
    for k in keys:
        check(chunk_err[k] < SLICE_TOL, f"{k}: kernel and plain paths differ by {chunk_err[k]}")
        check(cpu_err[k] < SLICE_TOL, f"{k}: card and CPU paths differ by {cpu_err[k]}")
    check(float(k_out["accumulation"].max()) > 0.9, "the compared chunk does not hit the surface")

    del model, k_out, p_out, c_out
    torch.cuda.empty_cache()
    train = train_phase(fm, method)
    hash_calls = hash_kernel_checks(train.pop("hash_captured"), designs)
    torch.use_deterministic_algorithms(True)
    try:
        resume = resume_phase(fm, smi, method)
    finally:
        torch.use_deterministic_algorithms(False)
    return {"render_launches": launches, "profile": profile, "chunk_err": chunk_err,
            "cpu_err": cpu_err, "hash_calls": hash_calls, "train": train, "resume": resume}


@contextlib.contextmanager
def uncounted(fm):
    """Launches made to compare a kernel with its plain version are not the
    main path's: every count, by kernel and by chain, is put back."""
    before, chains = dict(fm.LAUNCHES), dict(fm.CHAIN_LAUNCHES)
    try:
        yield
    finally:
        fm.LAUNCHES.update(before)
        fm.CHAIN_LAUNCHES.clear()
        fm.CHAIN_LAUNCHES.update(chains)


def chain_counts(fm, which: str) -> dict:
    """This run's launches of ``fused_mlp_{which}`` by chain (the widths joined by '-')."""
    return {"-".join(map(str, dims)): n for (k, dims), n in fm.CHAIN_LAUNCHES.items()
            if k == f"fused_mlp_{which}"}


def bwd_repeats_bitwise(fm, c) -> bool:
    """The backward kernel three times on one captured call: the fixed split
    count and reduction order make it repeat itself bit for bit."""
    x = c["x"].reshape(-1, c["x"].shape[-1])
    g = c["g"].reshape(-1, c["g"].shape[-1]).contiguous()
    with uncounted(fm), torch.no_grad():
        runs = [fm.fused_mlp_bwd(x, c["ws"], c["bs"], g, c["act"], c["out_act"], c["need_dx"])
                for _ in range(3)]
        torch.cuda.synchronize()
    flat = [([r[0]] if c["need_dx"] else []) + list(r[1]) + list(r[2]) for r in runs]
    return all(torch.equal(a, b) for other in flat[1:] for a, b in zip(flat[0], other))


def chain_checks(fm, calls: list, names: list, phase: str, method: str) -> list:
    """Each captured fused-MLP call of a train step alone: the forward and
    backward kernels against their plain versions (``KERNEL_TOL``,
    ``BWD_TOL``) and timed beside the plain versions, cuBLAS layer by layer
    (``torch.addmm`` with the activation in place, and PyTorch's autograd
    through it for the backward) and the 3xTF32 and FP32 bounds. The
    captured cotangent must not be zero: a chain whose backward takes zeros
    checks nothing."""
    recs = []
    for name, c in zip(names, calls):
        x = c["x"].reshape(-1, c["x"].shape[-1])
        g = c["g"].reshape(-1, c["g"].shape[-1]).contiguous()
        ws, bs, act, out_act, need_dx = c["ws"], c["bs"], c["act"], c["out_act"], c["need_dx"]
        acts = [act] * (len(ws) - 1) + [out_act]
        check(bool((g != 0).any()), f"{phase} {name}: the backward's captured cotangent is all zero")

        def cublas(x_):
            h = x_
            for w, b, a in zip(ws, bs, acts):
                h = torch.addmm(b, h, w)
                h = torch.relu_(h) if a == "relu" else fm._act(h, a)
            return h

        xr = x.detach().requires_grad_(need_dx)
        wr = [w.detach().requires_grad_(True) for w in ws]
        br = [b.detach().requires_grad_(True) for b in bs]

        def cublas_bwd():
            h = xr
            for w, b, a in zip(wr, br, acts):
                h = fm._act(torch.addmm(b, h, w), a)
            return torch.autograd.grad(h, ([xr] if need_dx else []) + wr + br, g)

        with uncounted(fm), torch.no_grad():
            y_k, y_p = fm.fused_mlp(x, ws, bs, act, out_act), fm.fused_mlp_plain(x, ws, bs, act, out_act)
            kern = fm.fused_mlp_bwd(x, ws, bs, g, act, out_act, need_dx)
            plain = fm.fused_mlp_bwd_plain(x, ws, bs, g, act, out_act, need_dx)
            torch.cuda.synchronize()
            f_err = float((y_k - y_p).abs().max())
            f_rel = f_err / (float(y_p.abs().max()) + 1.0)
            pairs = [(f"dW{i}", a, b) for i, (a, b) in enumerate(zip(kern[1], plain[1]))]
            pairs += [(f"db{i}", a, b) for i, (a, b) in enumerate(zip(kern[2], plain[2]))]
            if need_dx:
                pairs.append(("dx", kern[0], plain[0]))
            rel = {n: rel_fro(a, b) for n, a, b in pairs}
            b_abs = max(float((a - b).abs().max()) for _, a, b in pairs)
            reps = 10
            fk = cuda_time_ms(lambda: fm.fused_mlp(x, ws, bs, act, out_act), reps)
            fp = cuda_time_ms(lambda: fm.fused_mlp_plain(x, ws, bs, act, out_act), reps)
            fl = cuda_time_ms(lambda: cublas(x), reps)
            bk = cuda_time_ms(lambda: fm.fused_mlp_bwd(x, ws, bs, g, act, out_act, need_dx), reps)
            bp = cuda_time_ms(lambda: fm.fused_mlp_bwd_plain(x, ws, bs, g, act, out_act, need_dx), reps)
        with torch.enable_grad():
            bl = cuda_time_ms(cublas_bwd, reps)
        fflop, fbytes, dims, n = mlp_work(x, ws)
        bflop, bbytes, scratch, _, _ = mlp_bwd_work(x, ws, need_dx)
        fb, fb32, fby = bounds(fflop, fbytes)
        bb, bb32, bby = bounds(bflop, bbytes)
        rec = {"method": method, "call": name, "rows": n, "dims": dims, "act": act, "out_act": out_act,
               "need_dx": need_dx,
               "fwd": {"max_abs_err": f_err, "rel_err": f_rel, "ms": fk, "plain_ms": fp,
                       "cublas_ms": fl, "flop": fflop, "bytes": fbytes, "bound_ms": fb,
                       "bound_ms_fp32": fb32, "bound_by": fby},
               "bwd": {"max_abs_err": b_abs, "rel_err": rel, "ms": bk, "plain_ms": bp,
                       "cublas_ms": bl, "flop": bflop, "bytes": bbytes, "scratch_bytes": scratch,
                       "bound_ms": bb, "bound_ms_fp32": bb32, "bound_by": bby,
                       "bound_ms_with_scratch": bounds(bflop, bbytes + scratch)[0]}}
        recs.append(rec)
        log(phase, json.dumps(rec))
        check(f_rel <= KERNEL_TOL, f"{name}: forward kernel vs plain error {f_rel} > {KERNEL_TOL}")
        for n_, e in rel.items():
            check(e <= BWD_TOL, f"{name} {n_}: backward kernel vs plain rel error {e} > {BWD_TOL}")
        del xr, wr, br
    return recs


@contextlib.contextmanager
def outward_sdf_init():
    """Build the trainer's model with the SDF's outward-facing sphere init
    (``inside_outside=False``, sdf ~ |x| - 0.8). The registered field faces
    inwards, the init of a camera inside the scene: UniSurf's occupancy then
    saturates at every ray's first sample, so its surface search, its
    smoothness loss and its background would take no part in the step."""
    from sdfstudio_tpu_torch.scripts import train as train_script

    registered = train_script.get_method_config

    def outward(name):
        cfg = registered(name)
        sdf = dataclasses.replace(cfg.model.sdf_field, inside_outside=False)
        return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, sdf_field=sdf))

    train_script.get_method_config = outward
    try:
        yield
    finally:
        train_script.get_method_config = registered


def render_view(fm, model, cams, step: int, phase: str, plain_swap, chunk_chains: dict) -> dict:
    """The scene's 384x384 view 0 rendered with the kernels (warm: the
    training steps ran the same kernels and products), its launches counted
    by kernel and by chain (``chunk_chains``: each chain's forward launches
    a chunk; no backward), rendered again under ``plain_swap()`` (every
    kernel swapped for its plain version, its launches not counted), the
    0.999 quantile of rays held to ``SLICE_TOL``, and its first 12 chunks
    traced. Every pixel must be finite."""
    from sdfstudio_tpu_torch.engine.final_eval import render_image

    check(int(cams.height[0]) == IMAGE and int(cams.width[0]) == IMAGE,
          f"the scene's view is not {IMAGE}x{IMAGE}")
    n_chunks = math.ceil(IMAGE * IMAGE / 1024)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    fm.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = render_image(model, cams, 0, chunk=1024, step=step)
    torch.cuda.synchronize()
    image_ms = (time.perf_counter() - t) * 1e3
    render_launches = dict(fm.LAUNCHES)
    render_chains = {w: chain_counts(fm, w) for w in ("fwd", "bwd")}
    want = {"fwd": {chain: k * n_chunks for chain, k in chunk_chains.items()}, "bwd": {}}
    check(render_chains == want, f"expected {want} launches by chain in the render: {render_chains}")
    with plain_swap():
        plain_out = render_image(model, cams, 0, chunk=1024, step=step)
    torch.cuda.synchronize()
    fm.LAUNCHES.update(render_launches)
    for k, v in out.items():
        check(bool(torch.isfinite(v).all()), f"{k} has non-finite values")
    ray_err = {k: (out[k] - plain_out[k]).abs().reshape(IMAGE * IMAGE, -1).amax(-1) for k in out}
    render_err = {k: float(e.max()) for k, e in ray_err.items()}
    render_q = {k: float(torch.quantile(e, RENDER_QUANTILE)) for k, e in ray_err.items()}
    # the first 12 chunks of the view traced: the device's idle share
    rb = cams.generate_image_rays(0)
    sched_r = model.schedules(step)
    traced_chunks = min(12, n_chunks)
    with torch.profiler.profile(activities=acts) as prof, torch.no_grad():
        t = time.perf_counter()
        for i in range(traced_chunks):
            model.get_outputs(rb.map(lambda x: x[i * 1024:(i + 1) * 1024]), sched=sched_r)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t) * 1e3
    render_profile = {"chunks": traced_chunks, "traced_wall_ms": traced_ms,
                      **render_breakdown(prof.events(), traced_ms)}
    log(phase.replace("surface", "surface_profile"), json.dumps({"render_chunks": render_profile}))
    acc = out["accumulation"]
    log(phase, f"rendered {IMAGE}x{IMAGE} in {n_chunks} chunks: {image_ms:.1f} ms an image; launches "
        f"{render_launches}, by chain {render_chains}; kernel path vs plain path, max "
        f"|diff| {render_err}, {RENDER_QUANTILE} quantile of rays {render_q} (tol {SLICE_TOL}); "
        f"accumulation min {float(acc.min()):.4f} max {float(acc.max()):.4f}")
    for k in out:
        check(render_q[k] < SLICE_TOL, f"{k}: kernel and plain renders differ by {render_q[k]} on "
              f"more than {1 - RENDER_QUANTILE:.1%} of the rays")
    del out, plain_out
    return {"launches": render_launches, "chains": render_chains, "image_ms": image_ms,
            "err": render_err, "quantile_err": render_q, "profile": render_profile}


def surface_phase(fm, smi: str, method: str) -> dict:
    """A classic surface method (``neus``, ``volsdf``, ``unisurf``) at full
    width from the seeded initialiser on the committed scene: 40 train steps
    through ``Trainer.train`` (ms a step over steps 12-39), one step with the
    kernels against one with the plain versions, both new fused-MLP chains
    (the SDF field's 4-layer colour net and the NeRF background's head)
    alone, and one 384x384 view rendered with the kernels against the plain
    versions. Both fused kernels must run on both chains in every training
    step and the forward on both in every render chunk; UniSurf starts from
    the outward-facing init (``outward_sdf_init``). Returns what the
    ``kernels`` line reports."""
    from sdfstudio_tpu_torch.scripts.train import setup_method_trainer

    phase = f"surface[{method}]"
    torch.cuda.empty_cache()
    t = time.perf_counter()
    with outward_sdf_init() if method == "unisurf" else contextlib.nullcontext():
        trainer = setup_method_trainer(method, SCENE, max_num_iterations=TRAIN_STEPS,
                                       device="cuda")
    dm, model = trainer.datamanager, trainer.model
    rays = dm.config.train_num_rays_per_batch
    torch.cuda.synchronize()
    log(phase, f"{sum(p.numel() for p in model.parameters())} parameters, groups "
        f"{sorted(trainer.optimizers)}, {rays} rays a step; set up in {time.perf_counter() - t:.2f} s")
    fm.reset_launch_counts()
    row = trainer.train_step()
    first = dict(zip(trainer.metric_keys, row.cpu().tolist()))
    trainer.train(CHECK_STEPS)
    torch.cuda.synchronize()
    t = time.perf_counter()
    last = trainer.train(TRAIN_STEPS)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3 / (TRAIN_STEPS - CHECK_STEPS)
    train_launches = dict(fm.LAUNCHES)
    train_chains = {w: chain_counts(fm, w) for w in ("fwd", "bwd")}
    log(phase, f"Trainer.train, steps {CHECK_STEPS}-{TRAIN_STEPS - 1}: {step_ms:.2f} ms a step, "
        f"{rays / step_ms * 1e3:.0f} rays/s; launches {train_launches}, by chain {train_chains}; losses at step 1 / "
        f"{TRAIN_STEPS}: " + " ".join(f"{k}={first[k]:.5g}/{last[k]:.5g}" for k in trainer.metric_keys))
    check(trainer.step == TRAIN_STEPS, f"Trainer.train stopped at step {trainer.step}")
    check(all(math.isfinite(v) for v in list(first.values()) + list(last.values())),
          "a training loss or metric is not finite")
    # the colour net and the background head: a forward and a backward each, every step
    every_step = {chain: TRAIN_STEPS for chain in SURFACE_CHAINS}
    check(train_chains == {"fwd": every_step, "bwd": every_step},
          f"expected a forward and a backward launch a step on each chain: {train_chains}")

    # one step twice from the same state: the kernels, then the plain versions
    sched = model.schedules(trainer.step)

    def one_step():
        gen = torch.Generator(device=dm.device).manual_seed(777)
        idx, batch = dm.sample_train_batch(gen)
        outputs = model.get_outputs(dm.generate_rays(idx), sched=sched, train=True, rng=gen)
        ld = model.get_loss_dict(outputs, batch, sched, gen)
        mask = outputs.get("surface_points_mask")
        return ({k: float(v.detach()) for k, v in ld.items()}, grads_of(trainer, sum(ld.values())),
                None if mask is None else int(mask.sum()))

    calls: list = []
    with capture_fused_mlp_calls(calls):
        k_loss, k_grads, surface_rays = one_step()
    with swap_fused_mlp(fm.fused_mlp_plain):
        p_loss, p_grads, _ = one_step()
    grad_norm = {g: float(torch.linalg.vector_norm(v)) for g, v in k_grads.items()}
    log(phase, f"the step's gradient norms {grad_norm}; rays with a surface point {surface_rays} of {rays}")
    for g, v in grad_norm.items():
        check(v > 0, f"the {g} group's gradient is zero: it took no part in the step")
    if method == "unisurf":
        check(0 < surface_rays and k_loss["normal_smoothness_loss"] > 0,
              f"UniSurf's surface search found {surface_rays} rays, smoothness loss "
              f"{k_loss['normal_smoothness_loss']}")
    loss_err = {k: abs(k_loss[k] - p_loss[k]) / max(abs(p_loss[k]), 1e-12) for k in p_loss}
    grad_err = {g: rel_fro(k_grads[g], p_grads[g]) for g in p_grads}
    log(phase, f"kernel step vs plain step: loss rel err {loss_err} (tol {STEP_LOSS_TOL}); "
        f"gradient rel err {grad_err} (tol {STEP_GRAD_TOL})")
    for k, e in loss_err.items():
        check(e <= STEP_LOSS_TOL, f"{k}: kernel step and plain step differ by {e}")
    for g, e in grad_err.items():
        check(e <= STEP_GRAD_TOL, f"{g} gradient: kernel step and plain step differ by {e}")
    widths = ["-".join(str(d) for d in [c["x"].shape[-1]] + [w.shape[1] for w in c["ws"]])
              for c in calls]
    check(sorted(widths) == sorted(SURFACE_CHAINS) and all("g" in c for c in calls),
          f"expected a call with a backward on each chain, captured {widths}")
    chains = chain_checks(fm, calls, [SURFACE_CHAINS[w] for w in widths], phase, method)
    del calls, k_grads, p_grads

    # one traced update step: where its time goes
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        trainer.train_step()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t) * 1e3
    step_profile = {"traced_wall_ms": traced_ms, **render_breakdown(prof.events(), traced_ms)}
    log(phase.replace("surface", "surface_profile"), json.dumps({"train_step": step_profile}))

    render = render_view(fm, model, dm.train_cameras, trainer.step, phase,
                         lambda: swap_fused_mlp(fm.fused_mlp_plain),
                         {chain: 1 for chain in SURFACE_CHAINS})
    del trainer, model
    torch.cuda.empty_cache()
    return {"method": method, "rays": rays, "step_ms": step_ms, "rays_per_s": rays / step_ms * 1e3,
            "loss_first": first, "loss_last": last, "train_launches": train_launches,
            "render_launches": render["launches"], "image_ms": render["image_ms"],
            "chain_launches": {name: {"fwd": train_chains["fwd"][w] + render["chains"]["fwd"][w],
                                      "bwd": train_chains["bwd"][w]}
                               for w, name in SURFACE_CHAINS.items()},
            "surface_rays": surface_rays, "grad_norm": grad_norm,
            "step_loss_err": loss_err, "step_grad_err": grad_err, "render_err": render["err"],
            "render_quantile_err": render["quantile_err"], "chains": chains,
            "train_step_idle_share": step_profile["device_idle_share"],
            "render_idle_share": render["profile"]["device_idle_share"]}


def neuralangelo_phase(fm, smi: str) -> dict:
    """``neuralangelo`` at full width (the 55,867,118 x 8 table, AdamW) from
    the seeded initialiser on the committed scene: 40 train steps through
    ``Trainer.train`` (steps 0 and 1 alone: the curvature term is 0 at step 0,
    its factor ``step / 5000``, and positive from step 1), the kernel step
    against the plain step (hash-grid and fused-MLP kernels swapped for their
    plain versions) at step 0's and step 75,000's schedules, the table's
    gradient zero on the masked levels at step 0, the F = 8 hash-grid kernels
    against their plain versions on the step's captured calls, both fused-MLP
    chains alone, two deterministic steps (the corner-rows and segment-sum
    kernels) that must repeat bit for bit, one traced step, and the view
    rendered with the kernels against the plain versions. Returns what the
    ``kernels`` line reports, in ``surface_phase``'s keys and more."""
    from sdfstudio_tpu_torch.ops.launches import LAUNCHES
    from sdfstudio_tpu_torch.scripts.benchmarking.hash_grid_designs import capture_hash_calls
    from sdfstudio_tpu_torch.scripts.train import setup_method_trainer

    method, phase = "neuralangelo", "surface[neuralangelo]"
    torch.cuda.empty_cache()
    t = time.perf_counter()
    trainer = setup_method_trainer(method, SCENE, max_num_iterations=TRAIN_STEPS, device="cuda")
    dm, model = trainer.datamanager, trainer.model
    enc = model.field.encoding
    rays = dm.config.train_num_rays_per_batch
    torch.cuda.synchronize()
    log(phase, f"{sum(p.numel() for p in model.parameters())} parameters, hash table "
        f"{tuple(enc.hash_table.shape)}, groups {sorted(trainer.optimizers)} "
        f"({ {g: o.kind for g, o in trainer.optimizers.items()} }), {rays} rays a step; set up in "
        f"{time.perf_counter() - t:.2f} s; {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    check(tuple(enc.hash_table.shape) == ANGELO_TABLE, f"the table is {tuple(enc.hash_table.shape)}")
    L = enc.num_levels

    fm.reset_launch_counts()
    rows = [trainer.train_step() for _ in range(2)]
    keys = list(trainer.metric_keys)
    first = [dict(zip(keys, r.cpu().tolist())) for r in rows]
    trainer.train(CHECK_STEPS)
    torch.cuda.synchronize()
    t = time.perf_counter()
    last = trainer.train(TRAIN_STEPS)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3 / (TRAIN_STEPS - CHECK_STEPS)
    train_launches = dict(fm.LAUNCHES)
    train_chains = {w: chain_counts(fm, w) for w in ("fwd", "bwd")}
    log(phase, f"Trainer.train, steps {CHECK_STEPS}-{TRAIN_STEPS - 1}: {step_ms:.2f} ms a step, "
        f"{rays / step_ms * 1e3:.0f} rays/s; launches {train_launches}, by chain {train_chains}; "
        f"losses at steps 1, 2 / {TRAIN_STEPS}: " + " ".join(
            f"{k}={first[0][k]:.5g},{first[1][k]:.5g}/{last[k]:.5g}" for k in keys)
        + f"; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated")
    check(trainer.step == TRAIN_STEPS, f"Trainer.train stopped at step {trainer.step}")
    check(all(math.isfinite(v) for r in first + [last] for v in r.values()),
          "a training loss or metric is not finite")
    check(first[0]["curvature_loss"] == 0.0 and first[1]["curvature_loss"] > 0
          and last["curvature_loss"] > 0,
          f"the curvature term is not 0 at step 0 and positive from step 1: "
          f"{first[0]['curvature_loss']}, {first[1]['curvature_loss']}, {last['curvature_loss']}")
    every_step = {chain: TRAIN_STEPS for chain in SURFACE_CHAINS}
    check(train_chains == {"fwd": every_step, "bwd": every_step},
          f"expected a forward and a backward launch a step on each chain: {train_chains}")
    check(train_launches["hash_encode_fwd"] == ANGELO_FWD_PER_STEP * TRAIN_STEPS
          and train_launches["hash_encode_bwd"] == TRAIN_STEPS
          and train_launches["hash_encode_bwd_det"] == train_launches["hash_segment_sum"] == 0,
          f"expected {ANGELO_FWD_PER_STEP} hash forward launches and one atomic backward a step: "
          f"{train_launches}")

    # one step from the same state at two schedules: the kernels, then the plain versions
    opt_f = trainer.optimizers["field"]
    table_i = opt_f.names.index("field.encoding.hash_table")

    def one_step(sched):
        """Losses, each group's gradient of the first-order terms and of the
        curvature term (flat), and the table's gradient of their sum."""
        gen = torch.Generator(device=dm.device).manual_seed(777)
        idx, batch = dm.sample_train_batch(gen)
        outputs = model.get_outputs(dm.generate_rays(idx), sched=sched, train=True, rng=gen)
        ld = model.get_loss_dict(outputs, batch, sched, gen)
        del outputs
        first_order = sum(v for k, v in ld.items() if k != "curvature_loss")
        names = list(trainer.optimizers)
        params = [p for n in names for p in trainer.optimizers[n].params]
        at_table = sum(len(trainer.optimizers[n].params) for n in names[:names.index("field")])
        flat, table = {}, 0.0
        for part, total in (("first_order", first_order), ("curvature", ld["curvature_loss"])):
            grads = torch.autograd.grad(total, params, allow_unused=True,
                                        retain_graph=part == "first_order")
            g = [t if t is not None else torch.zeros_like(p) for t, p in zip(grads, params)]
            table = table + g[at_table + table_i]
            i = 0
            flat[part] = {}
            for n in names:
                k = len(trainer.optimizers[n].params)
                flat[part][n] = torch.cat([t.reshape(-1) for t in g[i:i + k]])
                i += k
            del grads, g
        return {k: float(v.detach()) for k, v in ld.items()}, flat, table

    steps, calls, hash_calls = {}, [], []
    for s_step in ANGELO_SCHED_STEPS:
        sched = model.schedules(s_step)
        delta, levels = sched["numerical_delta"], int(sched["hash_mask"].sum()) // enc.features_per_level
        tol1, tol2 = angelo_tols(delta)
        capture = s_step == ANGELO_SCHED_STEPS[0]
        with (capture_fused_mlp_calls(calls) if capture else contextlib.nullcontext()), \
                (capture_hash_calls(hash_calls) if capture else contextlib.nullcontext()):
            k_loss, k_grads, k_table = one_step(sched)
        with swap_fused_mlp(fm.fused_mlp_plain), swap_hash_plain():
            p_loss, p_grads, p_table = one_step(sched)
        loss_err = {k: abs(k_loss[k] - p_loss[k]) / max(abs(p_loss[k]), 1e-12) for k in p_loss}
        grad_err = {f"{part}:{g}": rel_fro(k_grads[part][g], p_grads[part][g])
                    for part in k_grads for g in k_grads[part]}
        grad_norm = {f"{part}:{g}": float(torch.linalg.vector_norm(v))
                     for part in k_grads for g, v in k_grads[part].items()}
        masked_rows = int(enc.level_offsets[levels])
        masked = {"kernel": float(k_table[masked_rows:].abs().max()) if levels < L else None,
                  "plain": float(p_table[masked_rows:].abs().max()) if levels < L else None,
                  "unmasked_kernel": float(k_table[:masked_rows].abs().max())}
        steps[s_step] = {"delta": delta, "levels": levels, "tol_first_order": tol1,
                         "tol_curvature": tol2, "loss_kernel": k_loss, "loss_plain": p_loss,
                         "loss_err": loss_err, "grad_err": grad_err, "grad_norm": grad_norm,
                         "table_grad_max_abs": masked}
        log(phase, f"kernel step vs plain step at step {s_step}'s schedule (delta {delta:.6g}, "
            f"{levels} levels): {json.dumps(steps[s_step])}")
        for k, e in loss_err.items():
            tol = tol2 if k == "curvature_loss" else tol1
            check(e <= tol, f"step {s_step} {k}: kernel step and plain step differ by {e} > {tol}")
        for k, e in grad_err.items():
            tol = tol2 if k.startswith("curvature") else tol1
            check(e <= tol, f"step {s_step} {k} gradient: kernel and plain steps differ by {e} > {tol}")
        for g in trainer.optimizers:
            check(grad_norm[f"first_order:{g}"] > 0, f"step {s_step}: the {g} group's gradient is zero")
        if levels < L:
            check(masked["kernel"] == 0.0 and masked["plain"] == 0.0 and masked["unmasked_kernel"] > 0,
                  f"step {s_step}: the table's gradient on the {L - levels} masked levels is not zero, "
                  f"or zero on the others: {masked}")
        if s_step > 0:  # the curvature factor is 0 at step 0 only
            check(k_loss["curvature_loss"] > 0, f"step {s_step}: no curvature term")
        del k_grads, p_grads, k_table, p_table
        torch.cuda.empty_cache()

    # both fused-MLP chains alone, on the step-0 calls
    widths = ["-".join(str(d) for d in [c["x"].shape[-1]] + [w.shape[1] for w in c["ws"]])
              for c in calls]
    check(sorted(widths) == sorted(SURFACE_CHAINS) and all("g" in c for c in calls),
          f"expected a call with a backward on each chain, captured {widths}")
    chains = chain_checks(fm, calls, [SURFACE_CHAINS[w] for w in widths], phase, method)
    del calls

    # the F = 8 kernels on the step's captured calls: the field's (with the
    # table's gradient), the sampler's rounds (forward only), and uniform
    # points with seeded cotangents at the field call's size
    field = [r for r in hash_calls if "g_out" in r]
    sampler = [r for r in hash_calls if "g_out" not in r]
    check(len(field) == 1 and field[0]["x"].shape[0] == ANGELO_FIELD_POINTS and field[0]["F"] == 8
          and len(sampler) == ANGELO_FWD_PER_STEP - 1,
          f"captured {[(r['x'].shape[0], 'g_out' in r) for r in hash_calls]} hash calls")
    before = dict(LAUNCHES)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    r = field[0]
    cases = [("field", "captured", r["x"], r["spec"], r["rows"], 8, False, r["g_out"], None)]
    cases += [(f"sampler_{i}", "captured", c["x"], c["spec"], c["rows"], 8, False, None, None)
              for i, c in enumerate(sampler)]
    xu = torch.rand(r["x"].shape, generator=gen, device="cuda")
    xu[0], xu[1], xu[2, 0] = 0.0, 1.0, 1.0
    cases.append(("field", "uniform", xu, r["spec"], r["rows"], 8, False,
                  torch.randn(r["g_out"].shape, generator=gen, device="cuda"), None))
    # what the mask costs at step 0: the field call's kernels over every
    # level (as the path runs them: the masked levels encoded, their zero
    # cotangents added) against the same call over the unmasked levels alone
    from sdfstudio_tpu_torch.ops import hash_grid as hg
    from sdfstudio_tpu_torch.scripts.benchmarking import hash_grid_designs as hgd

    on = steps[ANGELO_SCHED_STEPS[0]]["levels"]
    spec, R = r["spec"], r["rows"]
    spec_on = dataclasses.replace(spec, resolutions=spec.resolutions[:on], offsets=spec.offsets[:on],
                                  dense=spec.dense[:on])
    table = hgd.row_table(R, 8)
    g_on = r["g_out"][:, :on * 8].contiguous()
    check(not bool(r["g_out"][:, on * 8:].any()), "the masked levels' cotangents are not zero")
    mask_cost = {
        "levels": L, "unmasked_levels": on,
        "fwd_ms": cuda_time_many_ms(lambda: hg.hash_encode_fwd(r["x"], table, spec), 20),
        "fwd_unmasked_ms": cuda_time_many_ms(lambda: hg.hash_encode_fwd(r["x"], table, spec_on), 20),
        "bwd_ms": cuda_time_many_ms(lambda: hg.hash_encode_bwd(r["x"], r["g_out"], None, spec, R), 20),
        "bwd_unmasked_ms": cuda_time_many_ms(lambda: hg.hash_encode_bwd(r["x"], g_on, None, spec_on, R),
                                             20)}
    log(phase, f"the step-0 mask's cost: {json.dumps(mask_cost)}")
    del table, g_on, hash_calls, field, sampler, r
    torch.cuda.empty_cache()
    hash_recs = [hash_case(phase, *c) for c in cases]
    del cases, xu
    LAUNCHES.update(before)  # comparison launches are not the main path's

    # two steps' gradients under torch.use_deterministic_algorithms: the
    # table's gradient by the corner-rows and segment-sum kernels, the same bits twice
    sched = model.schedules(trainer.step)
    torch.cuda.synchronize()
    fm.reset_launch_counts()
    def det_step():
        gen = torch.Generator(device=dm.device).manual_seed(777)
        idx, batch = dm.sample_train_batch(gen)
        outputs = model.get_outputs(dm.generate_rays(idx), sched=sched, train=True, rng=gen)
        return grads_of(trainer, sum(model.get_loss_dict(outputs, batch, sched, gen).values()))

    torch.use_deterministic_algorithms(True)
    try:
        det = [det_step() for _ in range(2)]
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    det_launches = dict(fm.LAUNCHES)
    det_same = all(torch.equal(det[0][g], det[1][g]) for g in det[0])
    log(phase, f"two deterministic steps: launches {det_launches}; every gradient the same bits: {det_same}")
    check(det_launches["hash_encode_bwd_det"] == det_launches["hash_segment_sum"] == 2
          and det_launches["hash_encode_bwd"] == 0,
          f"expected the deterministic pair once a step and no atomic backward: {det_launches}")
    check(det_same, "two deterministic steps from the same state gave different gradients")
    del det
    torch.cuda.empty_cache()

    # one traced update step: where its time goes
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    fm.reset_launch_counts()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        trainer.train_step()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t) * 1e3
    step_profile = {"traced_wall_ms": traced_ms, **render_breakdown(
        prof.events(), traced_ms,
        windows=[("backward (between forward and optimizer)", "sst/train_forward", "sst/train_optimizer")])}
    log(phase.replace("surface", "surface_profile"), json.dumps({"train_step": step_profile}))
    traced_launches = dict(fm.LAUNCHES)
    del prof

    render = render_view(fm, model, dm.train_cameras, trainer.step, phase,
                         lambda: _both_plain(fm), {chain: 1 for chain in SURFACE_CHAINS})
    n_chunks = math.ceil(IMAGE * IMAGE / 1024)
    check(render["launches"]["hash_encode_fwd"] == ANGELO_FWD_PER_STEP * n_chunks
          and render["launches"]["hash_encode_bwd"] == 0,
          f"expected {ANGELO_FWD_PER_STEP} hash forward launches a chunk: {render['launches']}")
    del trainer, model, enc
    torch.cuda.empty_cache()
    train_all = {k: train_launches[k] + traced_launches[k] for k in train_launches}
    return {"method": method, "rays": rays, "step_ms": step_ms, "rays_per_s": rays / step_ms * 1e3,
            "loss_first": first[0], "loss_step_1": first[1], "loss_last": last,
            "train_launches": train_all, "det_launches": det_launches,
            "render_launches": render["launches"], "image_ms": render["image_ms"],
            "chain_launches": {name: {"fwd": train_chains["fwd"][w] + render["chains"]["fwd"][w],
                                      "bwd": train_chains["bwd"][w]}
                               for w, name in SURFACE_CHAINS.items()},
            "sched_steps": steps, "mask_cost": mask_cost, "render_err": render["err"],
            "render_quantile_err": render["quantile_err"], "chains": chains, "hash_calls": hash_recs,
            "train_step_profile": step_profile,
            "train_step_idle_share": step_profile["device_idle_share"],
            "render_idle_share": render["profile"]["device_idle_share"]}


@contextlib.contextmanager
def _both_plain(fm):
    """Every kernel of the path swapped for its plain version: the fused MLP and the hash grid."""
    with swap_fused_mlp(fm.fused_mlp_plain), swap_hash_plain():
        yield


def final_eval_phase(fm, smi: str) -> dict:
    """Score JAX's committed 20k p8 checkpoint with the port on the card and
    hold it to the scores JAX wrote; hold the kernel path to the plain path
    on one 8192-ray chunk at the trained step. Returns the launch counts of
    ``run_final_eval`` and what the phase printed."""
    from sdfstudio_tpu_torch.engine.final_eval import run_final_eval
    from sdfstudio_tpu_torch.scripts.train import setup_method_trainer

    ckpt = os.path.join(JAX_P8_RUN, "sdfstudio_models", f"step-{JAX_P8_STEP:09d}")
    packed = os.path.join(ckpt, "packed.npz")
    if not os.path.isfile(packed):
        raise FileNotFoundError(f"the committed JAX checkpoint is missing: {packed}")
    with open(packed, "rb") as f:
        sha = hashlib.sha256(f.read()).hexdigest()
    log("final_eval", f"{os.path.relpath(packed)}: {os.path.getsize(packed)} bytes, sha256 {sha}")
    torch.cuda.empty_cache()
    t = time.perf_counter()
    trainer = setup_method_trainer("neus-facto-tpu-p8", SCENE, device="cuda",
                                   load_dir=os.path.dirname(ckpt), load_step=JAX_P8_STEP)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    check(trainer.step == JAX_P8_STEP, f"loaded step {trainer.step}, expected {JAX_P8_STEP}")
    dm, model = trainer.datamanager, trainer.model
    log("final_eval", f"loaded at step {trainer.step} with the scene's train and eval splits "
        f"({dm.num_train_images} / {dm.num_eval_images} views) in {load_s:.2f} s")

    # the kernel path against the plain path on the render's 9th chunk of
    # view 0: the fused forward at its largest shapes (2,097,152 x 39,
    # 786,432 x 51 and 393,216 x 321 rows) against its plain version, and
    # the rendered rays of both paths, beside the plain path's own run on
    # the CPU (the f32 reproducibility of this render)
    rb = dm.eval_image_rays(0)
    sel = torch.arange(8 * EVAL_CHUNK, 9 * EVAL_CHUNK, device="cuda")
    sub = rb.map(lambda x: x[sel])
    before = dict(fm.LAUNCHES)
    sched = model.schedules(trainer.step)
    calls: list = []
    with torch.no_grad():
        with capture_fused_mlp_calls(calls):
            k_out = model.get_outputs(sub, sched=sched)
        with swap_fused_mlp(fm.fused_mlp_plain):
            p_out = model.get_outputs(sub, sched=sched)
        per_call = []
        for c in calls:
            y_k = fm.fused_mlp(c["x"], c["ws"], c["bs"], c["act"], c["out_act"])
            y_p = fm.fused_mlp_plain(c["x"], c["ws"], c["bs"], c["act"], c["out_act"])
            err = float((y_k - y_p).abs().max())
            per_call.append({"rows": c["x"].numel() // c["x"].shape[-1], "in": c["x"].shape[-1],
                             "max_abs_err": err, "rel_err": err / (float(y_p.abs().max()) + 1.0)})
        del calls, y_k, y_p
        cpu_model = copy.deepcopy(model).to("cpu")
        c_out = cpu_model.get_outputs(sub.map(lambda x: x.cpu()), sched=sched)
        del cpu_model
    torch.cuda.synchronize()
    fm.LAUNCHES.update(before)  # comparison launches are not the main path's

    def ray_err(a, b):
        d = (a.cpu() - b.cpu()).abs().reshape(a.shape[0], -1).amax(-1)
        return {"max": float(d.max()), "p99.9": float(torch.quantile(d, RENDER_QUANTILE)),
                "rays_over_tol": int((d > SLICE_TOL).sum())}

    keys = ("rgb", "accumulation", "depth", "normal")
    chunk_err = {k: ray_err(k_out[k], p_out[k]) for k in keys}
    plain_cpu_err = {k: ray_err(p_out[k], c_out[k]) for k in keys}
    acc_max = float(p_out["accumulation"].max())
    log("final_eval", f"rays {8 * EVAL_CHUNK}-{9 * EVAL_CHUNK - 1} of view 0 at step {trainer.step}: "
        f"fused forward kernel vs plain per call {json.dumps(per_call)} (tol {KERNEL_TOL}); "
        f"render, kernel path vs plain path, per-ray max |diff|: {json.dumps(chunk_err)} "
        f"(tol {SLICE_TOL} at the {RENDER_QUANTILE} quantile of rays); the plain path on the card "
        f"vs on the CPU: {json.dumps(plain_cpu_err)}; max accumulation {acc_max:.4f}")
    for c in per_call:
        check(c["rel_err"] <= KERNEL_TOL, f"fused forward at {c['rows']} rows: kernel vs plain {c}")
    for k, e in chunk_err.items():
        check(e["p99.9"] <= SLICE_TOL, f"{k}: kernel and plain paths differ by {e} on an 8192-ray chunk")
    check(acc_max > 0.9, f"the compared chunk does not hit the surface (accumulation {acc_max})")
    del k_out, p_out, c_out

    torch.cuda.synchronize()
    fm.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        trainer.config = dataclasses.replace(
            trainer.config, final_eval_gt="dtu-like", final_eval_resolution=256,
            final_eval_output=str(Path(tmp) / "parity_metrics.json"))
        rec, details = run_final_eval(trainer, "neus-facto-tpu-p8", trainer.step)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t
    launches = dict(fm.LAUNCHES)
    images, geometry = details["images"], details["geometry"]
    with open(os.path.join(JAX_P8_RUN, "parity_metrics.json")) as f:
        ref = json.load(f)
    diff = {"psnr": rec["psnr"] - ref["psnr"], "ssim": rec["ssim"] - ref["ssim"],
            "chamfer_l1_rel": rec["chamfer_l1"] / ref["chamfer_l1"] - 1.0}
    n_img = images["num_images"]
    per_chunk = math.ceil(IMAGE * IMAGE / EVAL_CHUNK)
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "sdfstudio_tpu_torch",
                           "engine", "jax_cpu_eval_p8_20k.json")) as f:
        cpu_ref = json.load(f)
    views = {v: images["per_image"][images["views"].index(v)] for v in cpu_ref["views"]}
    view_diff = {v: views[v][0] - p for v, p in zip(cpu_ref["views"], cpu_ref["psnr"])}
    out = {
        "card": smi, "step": trainer.step, "packed_bytes": os.path.getsize(packed),
        "packed_sha256": sha, "record": rec, "jax_record": ref, "diff": diff, "tol": EVAL_TOL,
        "load_s": load_s, "eval_s": eval_s, "images_s": images["seconds"],
        "s_per_image": images["seconds"] / n_img, "geometry_s": geometry["seconds"],
        "num_vertices": geometry["num_vertices"], "launches": launches,
        "expected_fwd_launches": 3 * per_chunk * n_img, "chunk_err": chunk_err,
        "views_psnr_ssim": views, "views_psnr_minus_jax_cpu": view_diff,
        "views_tol": EVAL_REF_PSNR_TOL,
    }
    log("final_eval", json.dumps(out))
    check(rec["iters"] == JAX_P8_STEP and n_img == 49 and rec["mc_resolution"] == 256,
          f"unexpected eval record {rec}")
    check(launches["fused_mlp_fwd"] == 3 * per_chunk * n_img,
          f"expected {3 * per_chunk * n_img} fused_mlp_fwd launches in the eval, got {launches}")
    for k, tol in EVAL_TOL.items():
        check(abs(diff[k]) <= tol, f"{k}: the port's eval is {diff[k]} off JAX's (tol {tol})")
    for v, d in view_diff.items():
        check(abs(d) <= EVAL_REF_PSNR_TOL,
              f"view {v}: PSNR {views[v][0]} is {d} dB off JAX's f32 CPU render "
              f"(tol {EVAL_REF_PSNR_TOL})")
    del trainer, dm, model
    torch.cuda.empty_cache()
    return out


def resume_phase(fm, smi: str, method: str = "neus-facto-tpu-p8") -> dict:
    """Train, save, load into a fresh trainer and train on; hold the loaded
    state to the saved one bit for bit and the resumed run to a straight
    one, bit for bit, parameters included. p8's step repeats as it is.
    ``neus-facto``'s table gradients add with atomics, in an order that
    changes from run to run, unless deterministic algorithms are on: the
    caller turns them on for it, and its hash tables then take the sorted
    segment sum (whose launches are checked, and the atomic kernel's
    absence)."""
    from sdfstudio_tpu_torch.engine.trainer import CHECKPOINT_FILE
    from sdfstudio_tpu_torch.scripts.train import setup_method_trainer

    def setup(**kw):
        return setup_method_trainer(method, SCENE, num_rays=TRAIN_RAYS, device="cuda", **kw)

    def params(trainer):
        return {n: p.detach().clone() for n, p in trainer.model.named_parameters()}

    torch.cuda.synchronize()
    fm.reset_launch_counts()
    straight = setup()
    rows = [straight.train_step() for _ in range(RESUME_STEPS)]
    at_save = params(straight)
    rows += [straight.train_step() for _ in range(RESUME_STEPS)]
    with tempfile.TemporaryDirectory() as tmp:
        first = setup(output_dir=tmp, steps_per_save=RESUME_STEPS)
        first.train(RESUME_STEPS)
        path = first.ckpt_dir / f"step-{RESUME_STEPS:09d}"
        saved = torch.load(path / CHECKPOINT_FILE, map_location="cpu", weights_only=True)
        resumed = setup(load_dir=first.ckpt_dir)
        loaded = {n: p.detach().cpu() for n, p in resumed.model.named_parameters()}
        adam = saved["optimizers"]
        same = {
            "params": all(torch.equal(loaded[n], saved["model"][n]) for n in loaded),
            "adam": all(opt.count == adam[g]["count"]
                        and all(torch.equal(a.cpu(), b)
                                for a, b in zip(opt.mu + opt.nu, adam[g]["mu"] + adam[g]["nu"]))
                        for g, opt in resumed.optimizers.items()),
            "step": resumed.step == saved["step"] == RESUME_STEPS,
            "generator": torch.equal(resumed.generator.get_state(), saved["generator"]),
        }
        first_bitwise = all(torch.equal(p.detach(), at_save[n])
                            for n, p in first.model.named_parameters())
        del first
        resumed_rows = [resumed.train_step() for _ in range(RESUME_STEPS)]
    torch.cuda.synchronize()
    launches = dict(fm.LAUNCHES)
    keys = list(straight.metric_keys)
    a, b = resumed_rows[-1].cpu(), rows[-1].cpu()
    p_res, p_str = params(resumed), params(straight)
    bitwise = torch.equal(a, b) and all(torch.equal(p_res[n], p_str[n]) for n in p_str)
    loss_err = {k: abs(float(a[i]) - float(b[i])) / max(abs(float(b[i])), 1e-12)
                for i, k in enumerate(keys) if k.endswith("loss")}
    param_err = {g: rel_fro(torch.cat([p_res[n].reshape(-1) for n in opt.names]),
                            torch.cat([p_str[n].reshape(-1) for n in opt.names]))
                 for g, opt in straight.optimizers.items()}
    deterministic = torch.are_deterministic_algorithms_enabled()
    out = {"card": smi, "method": method, "deterministic_algorithms": deterministic,
           "loaded_equals_saved": same, "steps_1_4_repeat_bitwise": first_bitwise,
           "step_8_bitwise": bitwise, "loss_rel_err": loss_err, "param_rel_err": param_err,
           "launches": launches}
    log("resume" if method == "neus-facto-tpu-p8" else f"resume[{method}]", json.dumps(out))
    check(all(same.values()), f"the loaded state differs from the saved one: {same}")
    check(launches["fused_mlp_fwd"] == 3 * 4 * RESUME_STEPS and launches["fused_mlp_bwd"] > 0,
          f"unexpected launches in the resume phase: {launches}")
    if straight.model.field.config.encoding_type == "hash":
        check(deterministic, f"{method}'s resume needs deterministic algorithms on")
        check(launches["hash_encode_bwd"] == 0 and launches["hash_encode_bwd_det"] > 0
              and launches["hash_segment_sum"] == launches["hash_encode_bwd_det"],
              f"the table gradient did not take the deterministic path: {launches}")
    check(bitwise and first_bitwise,
          f"the resumed run differs from the straight one (step 8 bit for bit: {bitwise}, steps "
          f"1-4: {first_bitwise}; losses {loss_err}, parameters {param_err})")
    del straight, resumed
    torch.cuda.empty_cache()
    return out


def _counts(fm) -> tuple:
    return dict(fm.LAUNCHES), dict(fm.CHAIN_LAUNCHES)


def _minus(a: tuple, b: tuple) -> tuple:
    """Launches by kernel and by chain of ``a`` less ``b``."""
    return ({k: a[0][k] - b[0].get(k, 0) for k in a[0]},
            {k: n - b[1].get(k, 0) for k, n in a[1].items() if n - b[1].get(k, 0)})


def cli_phase(fm, smi: str, method: str) -> dict:
    """A remaining ``neus-facto`` preset through JAX's command line at full
    width on the committed scene: ``scripts/train.py::main`` with JAX's
    grammar (40 steps, an eval image every 20, the final evaluation of 3
    views and the 128^3 mesh, the eval split every 8th view); the run's
    layout; the eval image of step 20 by JAX's index rule; the ms a step over
    steps 12-39 (the eval image's time taken out); launches by kernel and by
    chain, exact, in the training steps (from one captured step's calls),
    the eval images, the final evaluation, ``scripts/eval.py`` and
    ``scripts/extract_mesh.py`` (both run on the written ``config.yml``);
    one kernel step against one plain step (losses and every group's
    gradient); for ``neus-facto-tpu`` the F = 4 hash kernels on the step's
    captured SDF call, for ``neus-facto-tpu-p4`` its hidden-64 chains alone.
    Returns what the ``kernels`` line reports."""
    from sdfstudio_tpu_torch.engine import trainer as trainer_mod
    from sdfstudio_tpu_torch.engine.trainer import eval_image_index, loss_and_metrics
    from sdfstudio_tpu_torch.scripts import eval as eval_script
    from sdfstudio_tpu_torch.scripts import extract_mesh as mesh_script
    from sdfstudio_tpu_torch.scripts import train as train_script
    from sdfstudio_tpu_torch.scripts.benchmarking.hash_grid_designs import capture_hash_calls

    phase = f"cli[{method}]"
    torch.cuda.empty_cache()
    made, marks, evals, finals = [], {}, [], []
    setup, final = train_script.setup_lib.setup_trainer, trainer_mod.run_final_eval

    def keep(*args, **kw):
        """The trainer ``main`` builds, its steps 12 and 40 marked and its
        eval images timed and counted apart."""
        t = setup(*args, **kw)
        step, eval_image = t.train_step, t._eval_image

        def marked_step():
            if t.step == CHECK_STEPS:
                torch.cuda.synchronize()
                marks["t0"] = time.perf_counter()
            out = step()
            if t.step == TRAIN_STEPS:
                torch.cuda.synchronize()
                marks["t1"] = time.perf_counter()
            return out

        def timed_eval(*a):
            torch.cuda.synchronize()
            c0, s0 = _counts(fm), time.perf_counter()
            m = eval_image(*a)
            torch.cuda.synchronize()
            evals.append({"step": a[0], "seconds": time.perf_counter() - s0,
                          "launches": _minus(_counts(fm), c0)})
            return m

        t.train_step, t._eval_image = marked_step, timed_eval
        made.append(t)
        return t

    def counted_final(*a):
        c0, s0 = _counts(fm), time.perf_counter()
        out = final(*a)
        torch.cuda.synchronize()
        finals.append({"seconds": time.perf_counter() - s0, "launches": _minus(_counts(fm), c0)})
        return out

    with tempfile.TemporaryDirectory() as tmp:
        argv = [method, *CLI_EXTRA.get(method, ()), "--experiment-name", "smoke", "--output-dir", tmp,
                "--timestamp", "t", "--vis", "none", "--trainer.max-num-iterations", str(TRAIN_STEPS),
                "--trainer.steps-per-eval-image", str(CLI_EVAL_STEP),
                "--trainer.final-eval-gt", "dtu-like",
                "--trainer.final-eval-output", f"{tmp}/metrics.json",
                "--trainer.final-eval-mesh", f"{tmp}/mesh.ply",
                "--trainer.final-eval-resolution", str(CLI_MESH_RES),
                "--trainer.final-eval-max-images", str(CLI_FINAL_IMAGES),
                "sdfstudio-data", "--data", SCENE, "--skip-every-for-val-split", str(CLI_EVAL_SPLIT)]
        torch.cuda.synchronize()
        fm.reset_launch_counts()
        train_script.setup_lib.setup_trainer, trainer_mod.run_final_eval = keep, counted_final
        t = time.perf_counter()
        try:
            check(train_script.main(argv) == 0, f"{phase}: the train command failed")
        finally:
            train_script.setup_lib.setup_trainer, trainer_mod.run_final_eval = setup, final
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t
        total = _counts(fm)
        trainer = made[0]
        dm, model = trainer.datamanager, trainer.model
        run = Path(tmp) / "smoke" / method / "t"
        ckpt = run / "sdfstudio_models" / f"step-{TRAIN_STEPS:09d}"
        layout = {"config.yml": (run / "config.yml").is_file(),
                  "step.txt": (ckpt / "step.txt").is_file() and (ckpt / "step.txt").read_text() == str(TRAIN_STEPS),
                  "metrics": (Path(tmp) / "metrics.json").is_file(),
                  "mesh": (Path(tmp) / "mesh.ply").is_file()}
        check(all(layout.values()), f"{phase}: the run's layout is incomplete: {layout}")
        metrics = json.loads((Path(tmp) / "metrics.json").read_text())
        saved = json.loads((run / "config.yml").read_text())
        # every preset runs from the outward-facing init (bigmlp's through its override)
        check(saved["model"]["sdf_field"]["inside_outside"] is False
              and model.field.config.inside_outside is False,
              f"{phase}: the run's sdf_field.inside_outside is not False")
        n_eval = dm.num_eval_images
        check(n_eval == math.ceil(49 / CLI_EVAL_SPLIT), f"{phase}: {n_eval} eval views")
        history = [{k: v for k, v in e.items() if k != "launches"} for e in trainer.eval_history]
        at20 = [e for e in trainer.eval_history if e["step"] == CLI_EVAL_STEP]
        check(len(at20) == 1 and at20[0]["image"] == eval_image_index(CLI_EVAL_STEP, n_eval)
              and math.isfinite(at20[0]["psnr"]),
              f"{phase}: the eval image of step {CLI_EVAL_STEP}: {history}")
        check([e["step"] for e in evals] == [CLI_EVAL_STEP, TRAIN_STEPS] and len(finals) == 1,
              f"{phase}: eval images at {[e['step'] for e in evals]}, {len(finals)} final evals")
        eval_ms = evals[0]["seconds"] * 1e3
        step_ms = (marks["t1"] - marks["t0"] - evals[0]["seconds"]) * 1e3 / (TRAIN_STEPS - CHECK_STEPS)
        rays = dm.config.train_num_rays_per_batch
        check(all(math.isfinite(metrics[k]) for k in ("psnr", "ssim", "chamfer_l1"))
              and metrics["num_images"] == CLI_FINAL_IMAGES,
              f"{phase}: final evaluation {metrics}")

        # eval.py and extract_mesh.py on the written config.yml
        c0, t = _counts(fm), time.perf_counter()
        check(eval_script.main(["--load-config", str(run / "config.yml"),
                                "--output-path", f"{tmp}/eval.json"]) == 0, f"{phase}: eval.py failed")
        torch.cuda.synchronize()
        eval_s, eval_launches = time.perf_counter() - t, _minus(_counts(fm), c0)
        ev = json.loads((Path(tmp) / "eval.json").read_text())
        check(set(ev) == {"experiment_name", "method_name", "checkpoint", "results", "num_images",
                          "seconds"} and ev["num_images"] == n_eval
              and all(math.isfinite(v) for v in ev["results"].values()), f"{phase}: eval.py wrote {ev}")
        c0, t = _counts(fm), time.perf_counter()
        check(mesh_script.main(["--load-config", str(run / "config.yml"), "--output-path",
                                f"{tmp}/extracted.ply", "--resolution", str(CLI_MESH_RES)]) == 0,
              f"{phase}: extract_mesh.py failed")
        torch.cuda.synchronize()
        mesh_s, mesh_launches = time.perf_counter() - t, _minus(_counts(fm), c0)
        header = (Path(tmp) / "extracted.ply").read_bytes()[:400].split(b"end_header")[0].decode()
        mesh_vertices = int(header.split("element vertex ")[1].split()[0])
        check(mesh_vertices > 0, f"{phase}: extract_mesh.py wrote an empty mesh")
    train_launches = _minus(total, _counts_sum([e["launches"] for e in evals + finals]))
    log(phase, f"main: {main_s:.1f} s; {TRAIN_STEPS} steps of {rays} rays, steps {CHECK_STEPS}-"
        f"{TRAIN_STEPS - 1}: {step_ms:.2f} ms a step, {rays / step_ms * 1e3:.0f} rays/s; eval images "
        f"{history} ({eval_ms:.1f} ms the step-{CLI_EVAL_STEP} image, 384x384 in 1024-ray chunks); final "
        f"eval {json.dumps(metrics)}; eval.py {eval_s:.1f} s {json.dumps(ev['results'])}; "
        f"extract_mesh.py {mesh_s:.1f} s, {mesh_vertices} vertices; layout {layout}")

    # one step twice from the same state: the kernels, then the plain versions
    sched = model.schedules(trainer.step)
    check(sched["train_proposal"], f"step {trainer.step} is not an update step")

    def one_step():
        gen = torch.Generator(device=dm.device).manual_seed(777)
        idx, batch = dm.sample_train_batch(gen)
        total, ld, _ = loss_and_metrics(model, dm.generate_rays(idx), batch, sched, gen)
        return {k: float(v.detach()) for k, v in ld.items()}, grads_of(trainer, total)

    calls, hash_calls = [], []
    with uncounted(fm):
        with capture_fused_mlp_calls(calls), capture_hash_calls(hash_calls):
            k_loss, k_grads = one_step()
        with swap_fused_mlp(fm.fused_mlp_plain), swap_hash_plain():
            p_loss, p_grads = one_step()
        torch.cuda.synchronize()
    loss_err = {k: abs(k_loss[k] - p_loss[k]) / max(abs(p_loss[k]), 1e-12) for k in p_loss}
    grad_err = {g: rel_fro(k_grads[g], p_grads[g]) for g in p_grads}
    grad_norm = {g: float(torch.linalg.vector_norm(v)) for g, v in k_grads.items()}
    log(phase, f"kernel step vs plain step: loss rel err {loss_err} (tol {STEP_LOSS_TOL}); gradient "
        f"rel err {grad_err} (tol {STEP_GRAD_TOL}); gradient norms {grad_norm}")
    for k, e in loss_err.items():
        check(e <= STEP_LOSS_TOL, f"{phase} {k}: kernel step and plain step differ by {e}")
    for g, e in grad_err.items():
        check(e <= STEP_GRAD_TOL and grad_norm[g] > 0,
              f"{phase} {g} gradient: kernel step and plain step differ by {e} (norm {grad_norm[g]})")

    # exact launches: a step's calls (captured) times the steps, each render chunk a step's forwards
    def widths(c):
        return tuple([c["x"].shape[-1]] + [w.shape[1] for w in c["ws"]])

    proposal_chains = {tuple([net.mlp.layers[0].kernel.shape[0]]
                             + [l.kernel.shape[1] for l in net.mlp.layers])
                       for net in model.proposal_networks}
    proposal_specs = [net.encoding.spec for net in model.proposal_networks
                      if net.field_type == "hash"]
    n_update = sum(bool(model.schedules(i)["train_proposal"]) for i in range(TRAIN_STEPS))
    per_step = {}
    for c in calls:
        f, b = per_step.get(widths(c), (0, 0))
        per_step[widths(c)] = (f + 1, b + ("g" in c))
    hash_fwd = len(hash_calls)
    hash_bwd = sum(("g_out" in r) * (n_update if r["spec"] in proposal_specs else TRAIN_STEPS)
                   for r in hash_calls)
    sdf_hash = model.field.encoding is not None and model.field.config.encoding_type == "hash"
    image_chunks = math.ceil(IMAGE * IMAGE / 1024)
    final_chunks = CLI_FINAL_IMAGES * math.ceil(IMAGE * IMAGE / EVAL_CHUNK)
    mesh_chunks = math.ceil(CLI_MESH_RES ** 3 / 131072) if sdf_hash else 0

    def want(steps: int, chunks: int, mesh: int) -> tuple:
        """Launches by kernel and by chain of ``steps`` train steps and ``chunks`` render chunks."""
        chains = {}
        for w, (f, b) in per_step.items():
            chains[("fused_mlp_fwd", w)] = f * (steps + chunks)
            if steps and b:
                chains[("fused_mlp_bwd", w)] = b * (n_update if w in proposal_chains else steps)
        kernels = {"fused_mlp_fwd": sum(n for (k, _), n in chains.items() if k == "fused_mlp_fwd"),
                   "fused_mlp_bwd": sum(n for (k, _), n in chains.items() if k == "fused_mlp_bwd"),
                   "hash_encode_fwd": hash_fwd * (steps + chunks) + mesh,
                   "hash_encode_bwd": hash_bwd if steps else 0}
        return kernels, {k: n for k, n in chains.items() if n}

    def held(name: str, got: tuple, expected: tuple) -> dict:
        kernels = {k: got[0].get(k, 0) for k in expected[0]}
        others = {k: n for k, n in got[0].items() if k not in expected[0] and n}
        check(kernels == expected[0] and not others and got[1] == expected[1],
              f"{phase} {name}: launches {got}, expected {expected}")
        return {"kernels": kernels, "chains": {f"{k}:{'-'.join(map(str, w))}": n
                                               for (k, w), n in got[1].items()}}

    launches = {
        "train": held("train", train_launches, want(TRAIN_STEPS, 0, 0)),
        "eval_images": [held(f"eval image {e['step']}", e["launches"], want(0, image_chunks, 0))
                        for e in evals],
        "final_eval": held("final eval", finals[0]["launches"], want(0, final_chunks, mesh_chunks)),
        "eval_py": held("eval.py", eval_launches, want(0, n_eval * image_chunks, 0)),
        "extract_mesh": held("extract_mesh.py", mesh_launches, want(0, 0, mesh_chunks)),
    }
    log(phase, f"launches, exact: {json.dumps(launches)}")
    if method == "neus-facto-tpu-p4":
        for w in ((39, 64, 64, 1), (51, 64, 64, 1)):
            check(launches["train"]["chains"].get(f"fused_mlp_fwd:{'-'.join(map(str, w))}") == TRAIN_STEPS
                  and launches["train"]["chains"].get(f"fused_mlp_bwd:{'-'.join(map(str, w))}") == n_update,
                  f"{phase}: the hidden-64 chain {w} took {launches['train']['chains']}")

    out = {"method": method, "rays": rays, "step_ms": step_ms, "rays_per_s": rays / step_ms * 1e3,
           "eval_image_ms": eval_ms, "main_s": main_s, "eval_py_s": eval_s, "extract_mesh_s": mesh_s,
           "final_eval": metrics, "eval_py": ev["results"], "mesh_vertices": mesh_vertices,
           "eval_history": history, "launches": launches, "total_launches": total[0],
           "step_loss_err": loss_err, "step_grad_err": grad_err, "n_update": n_update,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}
    if method == "neus-facto-tpu-p4":
        names = [("proposal_0" if i == 0 else "proposal_1" if i == 1 else "color") for i in range(len(calls))]
        out["chains"] = chain_checks(fm, calls, names, phase, method)
    if method == "neus-facto-tpu":
        sdf = [r for r in hash_calls if r["spec"] == model.field.encoding.spec and "g_out" in r]
        check(len(sdf) == 1 and sdf[0]["F"] == 4 and sdf[0]["want_jac"],
              f"{phase}: captured {len(sdf)} F = 4 SDF calls with a backward")
        r = sdf[0]
        with uncounted(fm):
            out["hash_f4"] = hash_case(phase, "sdf", "captured", r["x"], r["spec"], r["rows"], 4,
                                       True, r["g_out"], r["g_jac"])
    del trainer, model, made, calls, hash_calls, k_grads, p_grads
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return out


def _counts_sum(parts: list) -> tuple:
    kernels, chains = {}, {}
    for k, c in parts:
        for name, n in k.items():
            kernels[name] = kernels.get(name, 0) + n
        for name, n in c.items():
            chains[name] = chains.get(name, 0) + n
    return kernels, chains


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
    from sdfstudio_tpu_torch.scripts.benchmarking import hash_grid_designs as hgd
    from sdfstudio_tpu_torch.utils import cuda_build, host_build

    # 1. device -------------------------------------------------------------
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log("device", f"nvidia-smi: {smi} | torch: {kind} | count {torch.cuda.device_count()} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    set_fp32_precision()

    # 2. build --------------------------------------------------------------
    shutil.rmtree(cuda_build.BUILD_DIR, ignore_errors=True)
    t = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        # the host marching-tetrahedra library and the hash-grid designs
        # library (the first design's kernels, the baseline) build beside the nvcc processes
        host = pool.submit(host_build.build, force=True)
        finish_designs = hgd.build_designs(baseline_only=True)
        _, build_log = cuda_build.build(force=True, verbose=True)
        host.result()
        designs = finish_designs()["designs"]
    build_s = time.perf_counter() - t
    ptxas = ptxas_report(build_log)
    log("build", f"ptxas (registers, spill stores and loads in bytes, per kernel): {json.dumps(ptxas)}")
    log("build", f"nvcc built {cuda_build.LIB_PATH.name} and g++ {host_build.LIB_PATH.name} "
        f"in {build_s:.2f} s")
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
    # the hash-grid kernels' memory instructions: streams evict-first, the
    # backward's adds as reductions, a corner pair's as one float4 reduction
    hash_mem = {}
    for fn_name, c in sass_counts_all.items():
        for kernel in ("hash_fwd_kernel", "hash_bwd_kernel", "hash_corner_rows_kernel",
                       "hash_segment_sum_kernel"):
            if kernel in fn_name:
                tot = hash_mem.setdefault(kernel, {})
                for form, n in c["mem"].items():
                    tot[form] = tot.get(form, 0) + n
    log("build", f"hash-grid global loads, stores and atomics by form (cuobjdump -sass): "
        f"{json.dumps(hash_mem)}")
    for kernel in ("hash_fwd_kernel", "hash_corner_rows_kernel"):
        stores = {f: n for f, n in hash_mem.get(kernel, {}).items() if f.startswith("STG")}
        check(stores and all(".EF" in f for f in stores),
              f"{kernel}: a store without the evict-first hint: {stores}")
    bwd_red = [f for f in hash_mem.get("hash_bwd_kernel", {}) if f.startswith(("RED", "ATOMG"))]
    check(bwd_red and not any(f.startswith("STG") for f in hash_mem["hash_bwd_kernel"]),
          f"hash_bwd_kernel adds nothing atomically, or stores: {hash_mem.get('hash_bwd_kernel')}")
    check(any("x4" in f for f in bwd_red),
          f"hash_bwd_kernel has no float4 reduction (a corner pair, an F = 4 row): {bwd_red}")
    check(not any(f.startswith(("RED", "ATOMG")) for f in hash_mem.get("hash_segment_sum_kernel", {})),
          f"the deterministic segment sum adds atomically: {hash_mem.get('hash_segment_sum_kernel')}")
    cuda_build.load_library()
    host_build.load_library()

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

    c2w = np.eye(4)[:3].copy()
    c2w[2, 3] = CAM_DIST  # at (0, 0, 2), looking down -z at the origin
    cams = Cameras.create(c2w, FOCAL, FOCAL, IMAGE / 2, IMAGE / 2, IMAGE, IMAGE, device="cuda")
    launches = render_init_view(model, cams, fm, "slice")
    rb = cams.generate_image_rays(0)

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

    # 7. final eval of JAX's 20k checkpoint ---------------------------------
    final = final_eval_phase(fm, smi)

    # 8. resume -------------------------------------------------------------
    resume = resume_phase(fm, smi)

    # 9. neus-facto ---------------------------------------------------------
    nf = neus_facto_phase(fm, smi, cams, scene_box, designs)

    # 10. neus, volsdf, unisurf ----------------------------------------------
    surface = {m: surface_phase(fm, smi, m) for m in SURFACE_METHODS}

    # 11. neuralangelo --------------------------------------------------------
    angelo = neuralangelo_phase(fm, smi)
    surface["neuralangelo"] = angelo  # its two fused-MLP chains are the surface methods'

    # 12. the remaining neus-facto presets through JAX's command line ---------
    cli = {m: cli_phase(fm, smi, m) for m in CLI_PRESETS}

    # 13. results -----------------------------------------------------------
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
            "device_ms": (None if any(r["device_ms"] is None for r in at_probe)
                          else sum(r["device_ms"] for r in at_probe)),
            "plain_ms": sum(r["plain_ms"] for r in at_probe),
            "bound_ms": sum(r["bound_ms"] for r in at_probe),
            "bound_share": sum(r["bound_ms"] for r in at_probe) / sum(r["ms"] for r in at_probe),
            "bound_by": "bytes",
            "library_ms": sum(r["library_ms"] for r in at_probe),
            "per_shape": mine,
        }

    def surface_launches(name: str) -> int:
        return sum(r["train_launches"][name] + r["render_launches"][name] for r in surface.values())

    def cli_launches(name: str) -> int:
        return sum(r["total_launches"][name] for r in cli.values())

    def cli_chain_rows(which: str) -> list:
        """p4's chains alone, at a captured step's inputs."""
        rows = []
        for c in cli["neus-facto-tpu-p4"]["chains"]:
            d = c[which]
            key = f"fused_mlp_{which}:{'-'.join(map(str, c['dims']))}"
            rows.append({"method": c["method"], "call": c["call"], "rows": c["rows"], "dims": c["dims"],
                         "launches": cli["neus-facto-tpu-p4"]["launches"]["train"]["chains"].get(key, 0),
                         **{k: d[k] for k in ("max_abs_err", "ms", "plain_ms", "cublas_ms",
                                              "bound_ms", "bound_ms_fp32", "bound_by")}})
        return rows

    def surface_chains(which: str) -> list:
        """The new chains of phase 10, one row per method and call, each
        with its launches on that method's path, counted by chain."""
        rows = []
        for m, r in surface.items():
            for c in r["chains"]:
                d = c[which]
                rows.append({"method": m, "call": c["call"], "rows": c["rows"], "dims": c["dims"],
                             "out_act": c["out_act"],
                             "launches": r["chain_launches"][c["call"]][which],
                             **{k: d[k] for k in ("max_abs_err", "ms", "plain_ms", "cublas_ms",
                                                  "bound_ms", "bound_ms_fp32", "bound_by")}})
        return rows

    nf_launches = {k: nf["render_launches"][k] + nf["train"]["launches"][k]
                   + nf["resume"]["launches"][k] for k in nf["render_launches"]}
    nf_train = nf["train"]

    def hash_sum(which: str, key: str, inputs: str = "captured") -> Optional[float]:
        """``key`` of ``which`` summed over the step's three calls on ``inputs``."""
        vals = [c[which][key] for c in nf["hash_calls"] if c["call"] != "F4" and c["inputs"] == inputs]
        return None if any(v is None for v in vals) else sum(vals)

    def hash_entry(which: str, replaces: str) -> dict:
        name = f"hash_encode_{which}"
        calls = [c for c in nf["hash_calls"]]
        return {
            "name": name,
            "route": "cuda",
            "source": "sdfstudio_tpu_torch/csrc/hash_grid.cu",
            "replaces": replaces,
            "launches": nf_launches[name] + cli_launches(name),
            "launches_render": nf["render_launches"][name],
            "launches_train": nf_train["launches"][name],
            "launches_resume": nf["resume"]["launches"][name],
            "launches_cli": {m: r["total_launches"][name] for m, r in cli.items()},
            # neus-facto-tpu's F = 4 SDF grid on a CLI train step's captured call
            "F4_step_captured": cli["neus-facto-tpu"]["hash_f4"].get(which),
            "max_abs_err": max([c[which]["max_abs_err"] for c in calls]
                               + [cli["neus-facto-tpu"]["hash_f4"][which]["max_abs_err"]]),
            # one train step's three calls on their captured inputs
            "ms": hash_sum(which, "ms"),
            "plain_ms": hash_sum(which, "plain_ms"),
            "bound_ms": hash_sum(which, "bound_ms"),
            "sector_bound_ms": hash_sum(which, "sector_bound_ms"),
            "bound_by": "bytes",
            "library_ms": hash_sum(which, "library_ms"),
            "baseline_ms": hash_sum(which, "baseline_ms"),
            "uniform_ms": hash_sum(which, "ms", "uniform"),
            "uniform_baseline_ms": hash_sum(which, "baseline_ms", "uniform"),
            "per_call": [{"call": c["call"], "inputs": c["inputs"], "points": c["points"], "F": c["F"],
                          **c[which]} for c in calls],
            "ptxas": {k: v for k, v in ptxas.items() if k.startswith(f"hash_{which}")},
            "sass_mem": {k: v for k, v in hash_mem.items() if f"hash_{which}" in k},
            "neus_facto_train_step_ms": nf_train["step_ms"],
            "neus_facto_train_rays_per_s": nf_train["rays_per_s"],
            "neus_facto_train_step_device_idle_share_traced": nf_train["profile"]["device_idle_share"],
            "neus_facto_image_ms": nf["profile"]["warm_ms"],
        }

    def det_entry(name: str, part: str, replaces: str, library: bool) -> dict:
        calls = [c for c in nf["hash_calls"] if c["call"] != "F4" and c["inputs"] == "captured"]
        return {
            "name": name,
            "route": "cuda",
            "source": "sdfstudio_tpu_torch/csrc/hash_grid.cu",
            "replaces": replaces,
            # the deterministic resume run's launches (the atomic kernel's path runs none)
            "launches": nf["resume"]["launches"][name],
            "launches_train": nf_train["launches"][name],
            "max_abs_err": max(c["det"][f"{part}_max_abs_err"] for c in nf["hash_calls"]),
            "ms": sum(c["det"][f"{part}_ms"] for c in calls),
            "plain_ms": sum(c["det"][f"{part}_plain_ms"] for c in calls),
            "bound_ms": sum(c["det"][f"{part}_bound_ms"] for c in calls),
            "bound_by": "bytes",
            "library_ms": sum(c["det"][f"{part}_library_ms"] for c in calls) if library else None,
            "deterministic_backward_ms": sum(c["det"]["ms"] for c in calls),
            "sort_ms": sum(c["det"]["sort_ms"] for c in calls),
            "repeats_bitwise": all(c["det"]["repeats_bitwise"] for c in nf["hash_calls"]),
            "ptxas": {k: v for k, v in ptxas.items() if k.startswith(f"hash_{part}")},
            "sass_mem": {k: v for k, v in hash_mem.items() if f"hash_{part}" in k},
        }

    def angelo_hash_entry(which: str, replaces: str) -> dict:
        """The F = 8 hash-grid kernel ``which`` on Neuralangelo's path: one
        train step's calls on their captured inputs (the field's five
        forwards; its one backward), launches on the path's train steps and
        render (the deterministic pair: its two deterministic steps)."""
        det = which in ("corner_rows", "segment_sum")
        name = {"corner_rows": "hash_encode_bwd_det", "segment_sum": "hash_segment_sum"}.get(
            which, f"hash_encode_{which}")
        part = "det" if det else which
        calls = [c for c in angelo["hash_calls"] if c["inputs"] == "captured" and part in c]
        key = (lambda k: f"{which}_{k}") if det else (lambda k: k)
        launches = (angelo["det_launches"][name] if det
                    else angelo["train_launches"][name] + angelo["render_launches"][name])
        return {
            "name": f"{name}[F=8]",
            "route": "cuda",
            "source": "sdfstudio_tpu_torch/csrc/hash_grid.cu",
            "replaces": replaces,
            "launches": launches,
            "launches_train": angelo["train_launches"][name],
            "launches_render": angelo["render_launches"][name],
            "launches_deterministic": angelo["det_launches"][name],
            "max_abs_err": max(c[part][key("max_abs_err")] for c in angelo["hash_calls"] if part in c),
            "ms": sum(c[part][key("ms")] for c in calls),
            "plain_ms": sum(c[part][key("plain_ms")] for c in calls),
            "bound_ms": sum(c[part][key("bound_ms")] for c in calls),
            "sector_bound_ms": None if det else sum(c[part]["sector_bound_ms"] for c in calls),
            "bound_by": "bytes",
            "library_ms": (None if which == "corner_rows" else
                           sum(c[part][key("library_ms")] for c in calls)),
            "per_call": [{"call": c["call"], "inputs": c["inputs"], "points": c["points"],
                          "unique_rows": c["unique_rows"], "unique_sectors": c["unique_sectors"],
                          **c[part]} for c in angelo["hash_calls"] if part in c],
            "ptxas": {k: v for k, v in ptxas.items()
                      if k.startswith(f"hash_{'corner_rows' if which == 'corner_rows' else which}")},
            "neuralangelo_train_step_ms": angelo["step_ms"],
            "neuralangelo_image_ms": angelo["image_ms"],
        }

    kernels = {"kernels": [{
        "name": "fused_mlp_fwd",
        "route": "cuda",
        "source": "sdfstudio_tpu_torch/csrc/fused_mlp_fwd.cu",
        "replaces": "sdfstudio_tpu/ops/pallas_mlp.py:94",
        "launches": (launches["fused_mlp_fwd"] + train["launches"]["fused_mlp_fwd"]
                     + final["launches"]["fused_mlp_fwd"] + resume["launches"]["fused_mlp_fwd"]
                     + nf_launches["fused_mlp_fwd"] + surface_launches("fused_mlp_fwd")
                     + cli_launches("fused_mlp_fwd")),
        "launches_cli": {m: r["total_launches"]["fused_mlp_fwd"] for m, r in cli.items()},
        "cli_chains": cli_chain_rows("fwd"),
        "launches_neus_facto": nf_launches["fused_mlp_fwd"],
        "launches_surface": {m: {"train": r["train_launches"]["fused_mlp_fwd"],
                                 "render": r["render_launches"]["fused_mlp_fwd"]}
                             for m, r in surface.items()},
        "surface_chains": surface_chains("fwd"),
        "launches_render": launches["fused_mlp_fwd"],
        "launches_train": train["launches"]["fused_mlp_fwd"],
        "launches_final_eval": final["launches"]["fused_mlp_fwd"],
        "launches_resume": resume["launches"]["fused_mlp_fwd"],
        "max_abs_err": max([r["max_abs_err"] for r in per_call]
                           + [c["max_abs_err"] for c in surface_chains("fwd") + cli_chain_rows("fwd")]),
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
        "train_step_calls": train["fwd_calls"] + nf["train"]["fwd_calls"],
    }, {
        "name": "fused_mlp_bwd",
        "route": "cuda",
        "source": "sdfstudio_tpu_torch/csrc/fused_mlp_bwd.cu",
        "replaces": "sdfstudio_tpu/ops/pallas_mlp.py:151",
        "launches": (train["launches"]["fused_mlp_bwd"] + resume["launches"]["fused_mlp_bwd"]
                     + nf_launches["fused_mlp_bwd"] + surface_launches("fused_mlp_bwd")
                     + cli_launches("fused_mlp_bwd")),
        "launches_cli": {m: r["total_launches"]["fused_mlp_bwd"] for m, r in cli.items()},
        "cli_chains": cli_chain_rows("bwd"),
        "launches_neus_facto": nf_launches["fused_mlp_bwd"],
        "launches_surface": {m: r["train_launches"]["fused_mlp_bwd"] for m, r in surface.items()},
        "surface_chains": surface_chains("bwd"),
        "launches_train": train["launches"]["fused_mlp_bwd"],
        "launches_resume": resume["launches"]["fused_mlp_bwd"],
        "max_abs_err": max([r["max_abs_err"] for r in bwd]
                           + [c["max_abs_err"] for c in surface_chains("bwd") + cli_chain_rows("bwd")]),
        "ms": sum(r["ms"] for r in bwd),
        "plain_ms": sum(r["plain_ms"] for r in bwd),
        "bound_ms": sum(r["bound_ms"] for r in bwd),
        "bound_ms_fp32": sum(r["bound_ms_fp32"] for r in bwd),
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in bwd) else "bytes",
        "bound_ms_with_scratch": sum(r["bound_ms_with_scratch"] for r in bwd),
        "library_ms": None,
        "per_step_calls": bwd,
        "neus_facto_step_calls": nf["train"]["bwd_calls"],
        "sass": sass.get("fused_mlp_bwd"),
        "ptxas": {k: v for k, v in ptxas.items() if k.startswith("fused_mlp_bwd")},
        "train_step_ms": train["step_ms"],
        "train_rays_per_s": train["rays_per_s"],
        "train_synced_step_median_ms": train["synced_step_median_ms"],
        "train_step_device_idle_share_traced": train["profile"]["device_idle_share"],
    }, gather_entry("take", "sdfstudio_tpu/scripts/benchmarking/probe_gather2.py:117"),
        gather_entry("loop", "sdfstudio_tpu/scripts/benchmarking/probe_gather2.py:149"),
        hash_entry("fwd", "sdfstudio_tpu/ops/encodings.py:358 (HashEncoding.__call__, XLA code)"),
        hash_entry("bwd", "sdfstudio_tpu/ops/encodings.py:224 (table_gather's VJP, XLA code)"),
        det_entry("hash_encode_bwd_det", "corner_rows",
                  "sdfstudio_tpu/ops/encodings.py:224 (table_gather's VJP: the corner updates, XLA "
                  "code)", library=False),
        det_entry("hash_segment_sum", "segment_sum",
                  "sdfstudio_tpu/ops/scatter.py:28 (sorted_segment_add, XLA code)", library=True),
        angelo_hash_entry("fwd", "sdfstudio_tpu/ops/encodings.py:358 (HashEncoding.__call__ at F = 8, "
                          "XLA code)"),
        angelo_hash_entry("bwd", "sdfstudio_tpu/ops/encodings.py:224 (table_gather's VJP at F = 8, "
                          "XLA code)"),
        angelo_hash_entry("corner_rows", "sdfstudio_tpu/ops/encodings.py:224 (table_gather's VJP: the "
                          "corner updates at F = 8, XLA code)"),
        angelo_hash_entry("segment_sum", "sdfstudio_tpu/ops/scatter.py:28 (sorted_segment_add at F = 8, "
                          "XLA code)")]}
    log("neuralangelo", json.dumps({k: angelo[k] for k in ("rays", "step_ms", "rays_per_s", "image_ms",
                                                            "sched_steps", "mask_cost",
                                                            "train_step_idle_share",
                                                            "render_idle_share", "loss_first",
                                                            "loss_step_1", "loss_last")}))
    log("surface", json.dumps({m: {k: r[k] for k in ("rays", "step_ms", "rays_per_s", "image_ms",
                                                      "train_step_idle_share", "render_idle_share",
                                                      "loss_first", "loss_last")}
                                for m, r in surface.items()}))
    log("cli", json.dumps({m: {k: r[k] for k in ("rays", "step_ms", "rays_per_s", "eval_image_ms",
                                                  "main_s", "eval_py_s", "extract_mesh_s",
                                                  "final_eval", "eval_py", "step_loss_err",
                                                  "step_grad_err", "peak_memory_gib")}
                            for m, r in cli.items()}))
    log("done", f"total {time.perf_counter() - T0:.1f} s")
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
