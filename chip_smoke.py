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
   plain PyTorch versions and compared. The view's first 6 chunks run
   again under ``torch.profiler``: their wall time, the device's busy time
   and idle share, and the time of each ``sst/*`` range of the model;
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
   the kernels (its ms an image, warm after the training steps), its 48
   middle rows again with the plain versions (the 0.999 quantile of those
   rays held to 1e-3), and its first 6 chunks traced. Counted by chain, each must take a forward and
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
   image every 20 steps, the final evaluation (the first eval view, the
   64^3 mesh) and ``sdfstudio-data --data .parity/dtu_like
   --skip-every-for-val-split 25``; the run's layout (``config.yml``, the
   step directory with ``step.txt``, the metrics, the mesh), the step-20
   eval image by JAX's index rule, the ms a step over steps 12-39 (the eval
   image taken out); launches counted exactly by kernel and by chain in the
   train steps (a step's captured calls times the steps, backwards on
   update steps only for the proposal nets), in each eval image, the final
   evaluation, ``scripts/eval.py`` and ``scripts/extract_mesh.py
   --resolution 128`` run on the written ``config.yml``; one kernel step
   against one plain step (losses and every group's gradient), and against
   the plain step on the kernel step's PDF resamplings
   (``shared_samples``), with where the two paths' resamplings part
   (``samples_parted``; for ``neus-facto-bigmlp`` on ``DIVERGENCE_SEEDS``
   more batches); p4's
   hidden-64 chains [39 / 51 -> 64 -> 64 -> 1] alone (a forward and a
   backward an update step); ``neus-facto-tpu``'s F = 4 hash kernels on the
   step's captured SDF call (``hash_case``);
13. cue (``cue[<method>]``): ``monosdf``, ``mono-neus``, ``mono-unisurf``,
   ``geo-neus``, ``geo-volsdf`` and ``geo-unisurf`` (JAX's registered
   entries at full width and 1024 rays, from the outward-facing init set
   through JAX's grammar) on the DTU-like scene with its monocular depth
   and normals, generated at run time by the port's copy of JAX's generator
   at its defaults (49 views, 384 x 384) in a process started with the
   smoke, beside ``pairs.txt`` (8 ring neighbours) and SfM point files; the
   generated images must equal the committed ``.parity/dtu_like`` pixel for
   pixel. Each entry trains ``CUE_STEPS`` steps (ms a step, rays/s; launches
   by chain exactly), holds a kernel step to a plain one (every loss term and
   group), checks its new terms (``normal_loss`` and ``depth_loss`` above 0,
   or ``patch_loss`` above 0 with more than ``CUE_VALID_SHARE`` of the rays
   warping a fully valid source patch), and traces one step
   (``sst/patch_warping``, ``sst/cue_losses``, the idle share);
14. grid: ``surface[neus-facto-angelo]`` (JAX's registered entry at full
   width: the F = 8 field with the appearance embedding live in the colour
   chain, the F = 2 hash proposals, the ``"grid"`` background under AdamW)
   trains 40 steps of 2048 rays, holds its kernel step to the plain step
   (``angelo_tols``), counts launches by kernel and by chain exactly (the
   background's [32 -> 64 -> 16] chain twice a step, the F = 8 and F = 2
   hash calls apart), holds its colour and background chains alone, traces
   a step and renders the view with kernels and without; then
   ``heritage[neusW]`` and ``heritage[dto]`` on the committed
   ``.parity/heritage_like`` through ``heritage-data`` (the fine grid
   refreshed and armed at ``GRID_REFRESH`` through the config's own
   fields: empty before it, occupied from it on, a batch's rays inside the
   shell) and ``surface[neus-acc]`` on the DTU-like scene (its grid
   refreshed every 16 steps) run 40 steps of 2048 rays through the train
   command (``grid_phase``): exact launches in the steps and in the final
   eval (2 views, the 64^3 mesh through the heritage or DTU-like judge),
   the kernel step against the plain step (1e-4), both chains alone, the
   background's F = 2 hash call (``hash_case``), the refresh timed and one
   traced step;
15. baked (``baked[<method>]``, ``baked_phase``): ``bakedsdf``,
   ``bakedsdf-mlp`` and ``bakedangelo`` at their registered values and
   full width through ``<method> mipnerf360-data --data
   .parity/heritage_like --train-split-percentage 0.97``: 14 steps at the
   registered rays (ms a step over steps 6-13; ``bakedsdf-mlp`` at the
   largest power of two up to 4096 that fits, the cut printed), ``eval.py``
   on the one eval view and
   ``extract_mesh.py`` at 64^3 (the mesh empty exactly when the SDF keeps
   one sign on the grid), the kernel step against the plain step on the
   kernel step's resamplings (1e-4; ``bakedangelo`` by ``angelo_tols``) and
   against the plain step's own resamplings where that is well posed,
   launches by kernel and by chain exact (every step trains the proposal
   nets, as in JAX), every chain of the step alone, ``bakedangelo``'s F = 8
   hash kernels on the step's 2,752,512 captured points, one traced step,
   the peak memory, and the view rendered with and without the kernels
   (``bakedsdf``, ``bakedangelo``);
16. density (``density[<method>]``, ``density_phase``): ``instant-ngp`` and
   ``nerfacto`` through ``sdfstudio-data`` on the DTU-like scene,
   ``phototourism`` through ``phototourism-data`` on the heritage-like
   scene, at their registered values and full width through JAX's command
   line: ``nerfacto`` and ``phototourism`` 20 steps of 4096 rays with the
   SO3xR3 camera optimizer, ``instant-ngp`` 30 steps of its dynamic batch
   (every bucket, each refresh's occupied cells and the samples a ray
   printed, each move held to the rule); ms a step over steps 10 on,
   rays/s, peak memory; one kernel step against one plain step (and on the
   kernel step's resamplings), ``camera_opt``'s gradient included; exact
   launches by kernel and by chain in the steps and ``eval.py``'s views;
   ``extract_mesh.py`` refusing ``nerfacto``; every chain of the step alone;
   the hash node's gradient in ``x`` on ``nerfacto``'s captured field call
   at F = 2 and 4 (``hash_grad_x_case``, 1e-5), timed beside the hash
   backward; one traced step;
17. nerf (``nerf[<method>]``, ``nerf_phase``): ``vanilla-nerf``,
   ``mipnerf`` and ``tensorf`` through ``blender-data``, ``dnerf`` through
   ``dnerf-data`` (its cameras' times reach the rays: the distortion trains)
   and for 2 steps through ``blender-data`` (no times: the distortion's
   parameters unmoved, its RAdam count advanced, none of its launches), and
   ``semantic-nerfw`` through ``friends-data``, on scenes written on a host
   thread from the smoke's start (``write_nerf_scenes``: the sphere in
   Blender's layout, with a time a frame, and in the Friends layout with
   segmentations that nothing reads), at their registered values and full
   width: 12 steps (ms a step over steps 4-11, rays/s, peak memory),
   ``eval.py``, the kernel step against the plain step on the kernel
   step's resamplings (``dnerf``'s groups against twice the plain float32
   step's own distance from a float64 step, ``f32_conditioning``) and the
   free comparison where well posed, launches exact by kernel and by chain,
   every chain alone (``chain_checks``), ``tensorf``'s tri-plane encodes
   timed against their bytes bounds (``tensorvm_cases``), one traced step;
18. capture (``capture[<name>]``, ``capture_phase``): real-capture layouts
   of the sphere, written on a host thread from the smoke's start
   (``write_capture_scenes``), through JAX's command line at the registered
   rays and full width: ``nerfacto nerfstudio-data`` (OPENCV distortion,
   views of 400 x 300 and 480 x 360 padded into one stack, the subset image
   cache at half the views, swapped every 4 steps), ``instant-ngp
   instant-ngp-data`` (distortion, the dynamic batch), ``monosdf
   monosdf-data --include-mono-prior True`` on the cue scene rewritten in
   MonoSDF's layout, and ``nerfacto record3d-data``: 12 steps (ms a step,
   rays/s, peak memory, the padded stack's bytes, the subset's swaps and
   global camera ids, no draw in the padding), the undistortion alone and
   in a traced step (``sst/undistort``) against its bound, the kernel step
   against the plain step, every chain alone, exact launches in the steps
   and in ``eval.py`` (each eval view at its own size), and before them
   the rays of the three camera models with distortion, card against CPU
   (``camera_models_case``);
19. the ``kernels`` JSON line (twelve kernels: the hash-grid four again at
   F = 8; the fused-MLP entries carry the surface chains', p4's and phases
   14 to 18's rows, the hash entries the cli, grid, baked, density, nerf
   and capture phases' launches, the F = 4 captured call, the background's
   F = 2 call, ``bakedangelo``'s F = 8 call and ``nerfacto``'s gradient in
   ``x``; the cue phases' launches), the ``nvidia-smi`` line, and the
   result line.

``cli[neus-facto-bigmlp]`` holds its kernel step to the plain step with the
kernel step's discrete choices carried over (``discrete_choices``): an rgb
L1 residual's sign, or a final sample's side of the merge sphere, where
both paths' values lie within rounding of the choice's boundary. Two
correct float32 paths part there by ~1e-3 of the field's gradient (one
sign flip in 60 batches on an NVIDIA H100, ``--probe-bigmlp``); the free comparison is
reported with its flips.

``python3 chip_smoke.py --probe-bigmlp N [--probe-out FILE]`` runs only
``bigmlp_probe``: where the bigmlp phase's kernel and plain steps part, over
N batches from its trained state.

The BakedSDF, occupancy-grid and ``surface[neus-facto-angelo]`` phases (an
rgb L1 loss, a background merge) carry the same discrete choices: on an
NVIDIA H100 one ``baked[bakedsdf]`` run parted its field gradient by
1.03e-4 on the kernel step's resamplings (six others ~6.2e-7), and one
``heritage[neusW]`` run its background's by 5.06e-4 (thirteen others
~2.4e-7).

The phases with a camera optimizer (``density[nerfacto]``,
``density[phototourism]``, ``capture[*]`` on the proposal sampler) hold the
step on the kernel step's resamplings with the kernel step's relu sides
carried over (``relu_choices``): a hidden unit whose pre-activation lies
within the two paths' rounding of 0 is on in one and off in the other, and
one such unit of a proposal net moved the pose table's gradient, whose
norm is ~2e-4, by up to 2.7e-4 of itself on an NVIDIA H100; a
float64-accumulated plain path parts from cuBLAS's by as much. The step
without the carry is reported with the flips.
``python3 chip_smoke.py --probe-density N [--probe-out FILE]`` runs only
``density_probe``: where ``density[nerfacto]``'s steps part, over N batches.

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
PLAIN_RAYS = 32 * IMAGE  # a method's view rendered again by the plain versions: its 32 middle rows
TRACED_CHUNKS = 6  # the first chunks of a view rendered under the profiler
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
# the grid background's chain beside the colour net (neusW, dto, neus-facto-angelo)
GRID_CHAINS = {"321-256-256-256-256-3": "color", "32-64-16": "background_base"}
GRID_METHODS = ("neusW", "dto", "neus-acc")  # the occupancy-grid family, at its registered 2048 rays
GRID_REFRESH = TRAIN_STEPS // 2  # the heritage phases' fine_grid_update_every and fine_grid_warmup
# the BakedSDF family through mipnerf360-data on the heritage-like scene (phase 15)
BAKED_METHODS = ("bakedsdf", "bakedsdf-mlp", "bakedangelo")
BAKED_STEPS = 14
# the mipnerf360 parser's split: ceil(0.97 x 36) = 35 train views and 1 eval view (eval.py's;
# the registered 0.9 holds out 3, cut to save the smoke's time)
BAKED_TRAIN_SPLIT = 0.97
BAKED_EVAL_VIEWS = 1
BAKED_TIMED = 6  # steps 6-13 timed
# the view rendered with and without kernels; bakedsdf-mlp's takes ~9 s a render, and the
# smoke's time is short: its eval.py renders the eval view with the kernels
BAKED_RENDER = ("bakedsdf", "bakedangelo")
BAKED_CHAINS = {"316-256-256-3": "color", "321-256-256-256-256-3": "color", "10-16-1": "proposal",
                "32-64-16": "background_base"}
HERITAGE_SCENE = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".parity", "heritage_like")
# phase 16: the density methods through JAX's command line at their registered values
DENSITY_METHODS = ("instant-ngp", "nerfacto", "phototourism")
DENSITY_STEPS = {"instant-ngp": 30, "nerfacto": 20, "phototourism": 20}
DENSITY_TIMED = 10  # steps 10 to the last timed
DENSITY_PROBE_FULL = 120  # --probe-density: the batches whose paths are also compared in full
NGP_UPDATE_EVERY = 5  # instant-ngp's --trainer.dynamic-update-every and --trainer.steps-per-log
DENSITY_CHAINS = {"10-16-1": "proposal", "32-64-16": "base"}
GRAD_X_TOL = 1e-5  # the hash node's gradient in x against the plain encode's under autograd
# phase 17: the NeRF baselines through JAX's command line at their registered values, on
# scenes the smoke writes beside the card's work (write_nerf_scenes): the sphere in Blender's
# layout (vanilla-nerf, mipnerf, tensorf; dnerf's short run without times), with a time a frame
# (dnerf through dnerf-data) and in the Friends layout (semantic-nerfw through friends-data)
NERF_METHODS = ("vanilla-nerf", "mipnerf", "dnerf", "tensorf", "semantic-nerfw")
NERF_STEPS = 12
NERF_TIMED = 4  # steps 4 to 11 timed
NERF_IMAGE = 128  # the Blender-layout views, NERF_VIEWS of them, every 8th an eval view
NERF_VIEWS = 16
FRIENDS_VIEWS = 4  # every Friends frame is in both splits: eval.py renders them all
NERF_PARSERS = {"dnerf": ("dnerf-data", "dnerf"), "semantic-nerfw": ("friends-data", "friends")}
NERF_CHAINS = {"283-128-128": "mlp_head", "84-256-256-256-3": "temporal_distortion",
               "150-128-128": "mlp_head", "10-16-1": "proposal", "32-64-16": "base",
               "31-64-64": "transient", "15-64-64": "semantics"}
_NERF_SCENES = {}  # the scenes' directory and the writer's thread, removed at exit
# the phases whose kernel step is held to the plain float32 step's own distance from float64
# (f32_conditioning): D-NeRF's distortion gradient is ill-conditioned in float32 in either
# package (tests/test_torch_nerf_methods.py, F32_ILL_CONDITIONED)
NERF_F32_CONDITIONED = ("dnerf",)
# phase 18: real-capture layouts, each a phase of CAPTURE_STEPS steps at the method's registered
# rays: (method, dataparser, scene, flags before the dataparser, the dataparser's flags)
CAPTURE_STEPS = 12
CAPTURE_TIMED = 4  # steps 4-11 timed
CAPTURE_VIEWS = 8  # the nerfstudio scene: even views CAPTURE_SIZES[0], odd views [1] (W, H)
CAPTURE_SIZES = ((400, 300), (480, 360))
CAPTURE_SPLIT = "0.875"  # --train-split-percentage: views 0-5 and 7 train, view 6 (400 x 300) eval
CAPTURE_SUBSET = CAPTURE_VIEWS // 2  # --pipeline.datamanager.train-num-images-to-sample-from
CAPTURE_REPEAT = 4  # --pipeline.datamanager.train-num-times-to-repeat-images: swaps after 4, 8, 12
NGP_CAPTURE = (4, 320, 240)  # views, W, H: every view is in both splits
RECORD3D_CAPTURE = (12, 192, 144)  # frames, W, H; eval every 8th (frames 0 and 8)
CAPTURE_PHASES = {
    "nerfacto": ("nerfacto", "nerfstudio-data", "nerfstudio",
                 ["--pipeline.datamanager.train-num-images-to-sample-from", str(CAPTURE_SUBSET),
                  "--pipeline.datamanager.train-num-times-to-repeat-images", str(CAPTURE_REPEAT)],
                 ["--train-split-percentage", CAPTURE_SPLIT]),
    "instant-ngp": ("instant-ngp", "instant-ngp-data", "ngp",
                    ["--trainer.steps-per-log", str(NGP_UPDATE_EVERY),
                     "--trainer.dynamic-update-every", str(NGP_UPDATE_EVERY)], []),
    "monosdf": ("monosdf", "monosdf-data", "monosdf", ["--pipeline.model.sdf-field.inside-outside",
                                                        "False"],
                ["--include-mono-prior", "True", "--center-crop-type", "no_crop",
                 "--skip-every-for-val-split", "49"]),
    "record3d": ("nerfacto", "record3d-data", "record3d", [], []),
}
CAPTURE_CHAINS = {"10-16-1": "proposal", "32-64-16": "base", "321-256-256-256-256-3": "color",
                  "283-128-128": "background_head"}
CAPTURE_BUDGET_S = 75.0  # the four phases together (reported against, not a check)
RAYS_TOL = 1e-5  # the card's rays of the three camera models against the CPU's, absolute
UNDISTORT_FLOP = 60  # per coordinate and Newton step: the residual, its jacobian and the update
_CAPTURE_SCENES = {}  # the scenes' directory and the writer's thread, removed at exit
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
CLI_EVAL_SPLIT = 49  # --skip-every-for-val-split: 1 eval view (view 0)
CLI_MESH_RES = 64  # --trainer.final-eval-resolution, extract_mesh.py --resolution
CLI_FINAL_IMAGES = 1  # --trainer.final-eval-max-images
# neus-facto-bigmlp is JAX's default field, whose init faces inwards (a camera
# inside the scene). On the object-centred parity scene a 40-step run from that
# init keeps or loses the surface depending on the seed, in JAX and in the port
# alike: on the CPU at 256 rays the largest SDF over a 33^3 grid at step 40 was
# -0.049, +0.039, +0.497, +0.547 for the port's seeds 0-3 (JAX's: +0.493,
# -0.024, +0.073, +0.562). The port's seed 0, the smoke's, is one that loses
# it (min / max -1.61 / -0.049), and the final eval then finds no surface; so
# the phase runs from the outward-facing init, set through JAX's grammar
CLI_EXTRA = {"neus-facto-bigmlp": ["--pipeline.model.sdf-field.inside-outside", "False"]}
DIVERGENCE_SEEDS = tuple(range(1000, 1003))  # neus-facto-bigmlp's extra kernel-vs-plain batches
# phase 13: the MonoSDF and Geo-NeuS entries at their registered 1024 rays on the DTU-like scene
# with its monocular cues, made at run time (JAX's generator at its defaults: 49 views, 384 x 384)
CUE_METHODS = ("monosdf", "mono-neus", "mono-unisurf", "geo-neus", "geo-volsdf", "geo-unisurf")
CUE_STEPS = 12
CUE_RAYS = 1024  # the six entries' registered rays a step
CUE_PAIRS = 8  # pairs.txt: +-1..+-4 around the ring, 7 sources after the parser's quirk
CUE_SFM_POINTS = 500  # GT surface points a view (geo-neus's parser reads them; no loss does)
CUE_VALID_SHARE = 0.10  # geo: rays with a crossing and a fully valid source patch, at least
# the scene's generator runs in a process of its own from the start (~60-80 s of numpy);
# it also holds the generated images to the committed ones
CUE_SCENE_CHILD = r"""
import json, sys, time
from pathlib import Path
import numpy as np
from sdfstudio_tpu_torch.data import png, synthetic_dtu
out, committed, pairs, points = Path(sys.argv[1]), Path(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
t = time.perf_counter()
synthetic_dtu.generate_dtu_like_dataset(out, with_mono_prior=True)
generate_s = time.perf_counter() - t
synthetic_dtu.write_pairs_and_sfm_points(out, num_pair_srcs=pairs, points_per_view=points)
diff, n = 0, 0
for f in sorted(committed.glob("*.png")):
    a, b = png.read_png(out / f.name), png.read_png(f)
    d = int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max()) if a.shape == b.shape else 255
    diff, n = max(diff, d), n + 1
print(json.dumps({"generate_s": generate_s, "total_s": time.perf_counter() - t, "pngs_compared": n,
                  "max_pixel_diff": diff, "files": len(list(out.iterdir())),
                  "bytes": sum(p.stat().st_size for p in out.iterdir())}))
"""
_CUE_SCENE = {}  # the generator's process and directory, stopped and removed at exit


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

    def one_step():
        gen = torch.Generator(device="cuda").manual_seed(777)
        idx, batch = dm.sample_train_batch(gen)
        total, ld, _ = loss_and_metrics(model, dm.generate_rays(idx), batch, sched, gen)
        return {k: float(v.detach()) for k, v in ld.items()}, grads_of(trainer, total)

    step = step_vs_plain(fm, phase, one_step)
    calls, hash_calls = step["calls"], step["hash_calls"]

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
    profile = traced_step(trainer, windows=[("backward (between forward and optimizer)",
                                              "sst/train_forward", "sst/train_optimizer")])
    profile = {"step": trainer.step - 1, **profile}
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
            "probe_l1": [l1_before, l1_after], "step_loss_err": step["loss_err"],
            "step_grad_err": step["grad_err"]}


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
    profile = {"warm_ms": warm_ms, **traced_chunks(model, cams, model.schedules(UNTRAINED_STEP))}
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
    before, chains, widths = dict(fm.LAUNCHES), dict(fm.CHAIN_LAUNCHES), dict(fm.WIDTH_LAUNCHES)
    try:
        yield
    finally:
        fm.LAUNCHES.update(before)
        for counter, kept in ((fm.CHAIN_LAUNCHES, chains), (fm.WIDTH_LAUNCHES, widths)):
            counter.clear()
            counter.update(kept)


def width_counts(fm) -> dict:
    """This run's launches of the hash-grid kernels by feature width, as
    ``"<kernel>[F=<F>]"`` -> count."""
    return {f"{k}[F={f}]": n for (k, f), n in fm.WIDTH_LAUNCHES.items() if n}


@contextlib.contextmanager
def pdf_samples(record: list, replay: bool = False):
    """The proposal sampler's PDF resamplings
    (``samplers/proposal.py::pdf_sampler``): each one's samples and the
    weights it resampled from appended to ``record``, or, with ``replay``,
    ``record``'s samples handed back in order in place of resampling."""
    from sdfstudio_tpu_torch.models import tensorf, vanilla_nerf
    from sdfstudio_tpu_torch.samplers import proposal as prop

    # the proposal sampler's, and the NeRF models' one resampling (each module's own name)
    modules = (prop, vanilla_nerf, tensorf)
    reals, given = [m.pdf_sampler for m in modules], iter(list(record))

    def wrap(real):
        def sampler(ray_bundle, samples, weights, *a, **kw):
            if replay:  # the recorded bins on this step's rays (their graph: the camera optimizer's)
                return dataclasses.replace(next(given)[0], origins=ray_bundle.origins,
                                           directions=ray_bundle.directions,
                                           pixel_area=ray_bundle.pixel_area,
                                           camera_indices=ray_bundle.camera_indices)
            out = real(ray_bundle, samples, weights, *a, **kw)
            record.append((out, weights.detach()))
            return out

        return sampler

    for m, real in zip(modules, reals):
        m.pdf_sampler = wrap(real)
    try:
        yield
    finally:
        for m, real in zip(modules, reals):
            m.pdf_sampler = real


def _finest(encoding) -> float:
    """The finest resolution of a hash grid or permutohedral lattice, or the
    highest frequency of a positional encoding, in its input's units."""
    if hasattr(encoding, "spec"):
        return float(encoding.spec.resolutions[-1])
    if hasattr(encoding, "freqs"):
        return float(encoding.freqs.max())
    return float(encoding.max_res)


def finest_cells(model, level: int, positions: torch.Tensor) -> torch.Tensor:
    """``positions`` [..., 3] of resampling ``level`` (1 to the proposal
    iterations) in units of the finest feature of the network that takes
    them: a proposal net's or the SDF field's finest grid cell in its [0, 1]
    input, or, for a positional encoding, the period over 2 pi of its
    highest frequency (on a PE+MLP proposal's [-1, 1] input, or on the
    field's contracted positions when it has no grid). The NeRF models'
    one resampling: TensoRF's plane cell, or the NeRF field's PE. Where two samples are
    a fraction f of such a unit apart, the gradient of that network's
    parameters at them differs by up to ~f of itself (a hash table's
    trilinear weights change by 1 / cell per unit of position)."""
    nets = list(getattr(model, "proposal_networks", []))
    if not nets and hasattr(model, "encodings"):  # TensoRF's tri-planes over the aabb
        return model.normalize(positions) * model.encodings.color_encoding.resolution
    if not nets and hasattr(model, "fine_field"):  # a NeRF field's PE on its own positions
        field = model.fine_field
        return field.contract_positions(positions) * _finest(field.position_encoding)
    if level < len(nets):
        net = nets[level]
        scale = 1.0 if net.field_type == "hash" else 2.0
        return net.normalize(positions) * (scale * _finest(net.encoding))
    field = model.field
    if not hasattr(field, "contract_positions"):  # the density methods' nerfacto field
        return field.normalize(positions) * _finest(field.encoding)
    x = field.contract_positions(positions)
    if field.encoding is not None:
        return (x + 2.0) / 4.0 * _finest(field.encoding)
    return x * _finest(field.position_encoding)


def samples_parted(k_rec: list, p_rec: list, merge_radius: Optional[float], model=None) -> dict:
    """Where the kernel step's and the plain step's PDF resamplings part,
    level by level: the largest difference of the weights each resampled
    from (the proposal densities' transmittance products) and of the
    resampled bins (in the sampler's [0, 1] spacing), the bin's position
    and its weight; with ``model`` the samples' largest displacement in
    units of the finest feature that takes them (``finest_cells``); and,
    where a background takes the samples beyond ``merge_radius`` (the unit
    sphere), the final samples that changed side of it, a discrete choice
    of the merge (``forward_background_field_and_merge``)."""
    check(len(k_rec) == len(p_rec), f"{len(k_rec)} and {len(p_rec)} PDF resamplings")
    out = {"weights_max_abs_diff": [], "bins_max_abs_diff": [], "cells_max_abs_diff": [], "at": [],
           "final_samples": int(k_rec[-1][0].starts.numel()) if k_rec else 0, "side_flips": 0}
    for level, ((ks, kw), (ps, pw)) in enumerate(zip(k_rec, p_rec), start=1):
        if model is not None:
            with torch.no_grad():
                cells = [finest_cells(model, level, r.get_positions()) for r in (ks, ps)]
            out["cells_max_abs_diff"].append(float((cells[0] - cells[1]).abs().max()))
        d = (ks.spacing_starts - ps.spacing_starts).abs()
        i = int(d.reshape(-1).argmax())
        ray, b = divmod(i, d.shape[-1])
        out["weights_max_abs_diff"].append(float((kw - pw).abs().max()))
        out["bins_max_abs_diff"].append(float(d.reshape(-1)[i]))
        out["at"].append({"ray": ray, "bin": b, "spacing": float(ks.spacing_starts[ray, b]),
                          "t": float(ks.starts[ray, b]),
                          "ray_weight_max": float(kw[ray].max()), "ray_weight_sum": float(kw[ray].sum())})
    if k_rec and merge_radius is not None:
        inside = [torch.linalg.vector_norm(r[0].get_start_positions(), dim=-1) < merge_radius
                  for r in (k_rec[-1], p_rec[-1])]
        out["side_flips"] = int((inside[0] != inside[1]).sum())
    return out


# two correct float32 paths may part at a discrete choice where a value lies
# within their rounding of it: an rgb residual's sign (the L1 loss's
# gradient is sign(r)) or a final sample's side of the background merge's
# unit sphere (a mask). Each is carried from the kernel step to the plain
# step only where both paths' values lie within these distances of the
# choice's boundary; a real error moves the residuals or the samples further.
L1_ROUNDING = 1e-5  # |r| in rgb units, on both paths
SIDE_ROUNDING = 1e-5  # | |x| - 1 | in the scene's units, on both paths


@contextlib.contextmanager
def discrete_choices(model, record: list, carry: Optional[list] = None):
    """Record one step's discrete choices, in call order, into ``record``:
    each rgb L1 loss's residuals (``("l1", r)``, ``components/losses.py::
    l1_loss``) and each background merge's sides (``("side", inside, | |x|
    - 1 |)``, ``model.get_foreground_mask``). With ``carry`` (the kernel
    step's record) a residual whose sign differs from the carried one, both
    within ``L1_ROUNDING`` of 0, takes the carried sign (its loss term
    ``r * sign(r_carried)``: the same value to within the rounding, the
    carried gradient), and a sample whose side differs, both within
    ``SIDE_ROUNDING`` of the sphere, takes the carried side. What is
    recorded is the step's own choice, before any carry."""
    from sdfstudio_tpu_torch.components import losses

    real_l1, calls = losses.l1_loss, iter(range(1 << 30))
    real_mask = model.get_foreground_mask if hasattr(model, "get_foreground_mask") else None

    def carried(kind: str):
        if carry is None:
            return None
        i = next(calls)
        check(i < len(carry) and carry[i][0] == kind,
              f"the carried step's choice {i} is not a {kind} choice")
        return carry[i]

    def l1_loss(pred, target):
        r = pred - target
        record.append(("l1", r.detach()))
        k = carried("l1")
        if k is None:
            return real_l1(pred, target)
        kr = k[1]
        flip = ((torch.sign(r) != torch.sign(kr)) & (r.abs() <= L1_ROUNDING)
                & (kr.abs() <= L1_ROUNDING))
        return torch.mean(torch.where(flip, r * torch.sign(kr), r.abs()))

    def get_foreground_mask(ray_samples):
        mask = real_mask(ray_samples)
        dist = (torch.linalg.vector_norm(ray_samples.get_start_positions(), dim=-1) - 1.0).abs()
        record.append(("side", mask.detach(), dist.detach()))
        k = carried("side")
        if k is None:
            return mask
        flip = (mask != k[1]) & (dist <= SIDE_ROUNDING) & (k[2] <= SIDE_ROUNDING)
        return torch.where(flip, k[1], mask)

    losses.l1_loss = l1_loss
    if real_mask is not None:
        model.get_foreground_mask = get_foreground_mask
    try:
        yield
    finally:
        losses.l1_loss = real_l1
        if real_mask is not None:
            del model.get_foreground_mask


def choices_parted(k_rec: list, p_rec: list) -> dict:
    """Where two steps' discrete choices (``discrete_choices``) part: rgb
    residuals of opposite signs and samples on opposite sides of the merge
    sphere, all of them and those within the rounding distances (which
    ``discrete_choices`` carries), with the largest residual or distance at
    a flip."""
    check([c[0] for c in k_rec] == [c[0] for c in p_rec],
          f"the steps' choices differ in kind: {[c[0] for c in k_rec]}, {[c[0] for c in p_rec]}")
    out = {"l1_sign_flips": 0, "l1_flips_within_rounding": 0, "l1_flip_max_abs_residual": 0.0,
           "side_flips": 0, "side_flips_within_rounding": 0, "side_flip_max_distance": 0.0}
    for k, p in zip(k_rec, p_rec):
        if k[0] == "l1":
            flip = torch.sign(k[1]) != torch.sign(p[1])
            near = flip & (k[1].abs() <= L1_ROUNDING) & (p[1].abs() <= L1_ROUNDING)
            size = torch.maximum(k[1].abs(), p[1].abs())[flip]
            key = "l1"
        else:
            flip = k[1] != p[1]
            near = flip & (k[2] <= SIDE_ROUNDING) & (p[2] <= SIDE_ROUNDING)
            size = torch.maximum(k[2], p[2])[flip]
            key = "side"
        out[f"{key}_sign_flips" if key == "l1" else "side_flips"] += int(flip.sum())
        out[f"{key}_flips_within_rounding"] += int(near.sum())
        if size.numel():
            m = "l1_flip_max_abs_residual" if key == "l1" else "side_flip_max_distance"
            out[m] = max(out[m], float(size.max()))
    return out


# a relu's side is a discrete choice too: a hidden unit whose pre-activation lies within the
# two paths' rounding of 0 (the kernel's 3xTF32 products or its exact k-ordered FMA chain,
# cuBLAS's own order) may be on or off in either, and its share of the gradient is all or
# nothing. One such unit of a proposal net moved a camera row by ~1e-4 of the camera
# optimizer's gradient (--probe-density). The distance allowed is each path's rounding of
# every term of the sum (RELU_ROUNDING of |x| |w|, and of |b|) plus the inputs' own difference
# through |w|; a real error moves a pre-activation further.
RELU_ROUNDING = 2.0 ** -20


def relu_band(x_a: torch.Tensor, x_b: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """How far apart two float32 paths may put the pre-activations ``x @ w +
    b`` of the same units (``RELU_ROUNDING``): [rows, units]."""
    aw = w.abs()
    return (x_a - x_b).abs() @ aw + RELU_ROUNDING * (w.shape[0] + 1) * (x_b.abs() @ aw + b.abs())


@contextlib.contextmanager
def relu_choices(fm, record: list, carry: Optional[list] = None):
    """Record one step's relu choices, in call order, into ``record``: each
    fused-MLP call's input, weights and (once its backward ran) cotangent,
    and each plain MLP's (``ops/mlp.py::MLP.forward_plain``) relu layers'
    inputs and pre-activations. With ``carry`` (the kernel step's record) a
    relu unit whose side differs from the kernel step's, both pre-activations
    within ``relu_band`` of 0, takes the kernel step's side, and what is
    recorded is each call's count of such flips. A fused chain's side is the
    backward kernel's own: the rows with a unit within the band are run
    through ``fm.fused_mlp_bwd`` one at a time on the kernel step's input and
    cotangent, where a unit's ``db`` is 0 exactly when it is off (or takes no
    gradient, and then its side does not matter), and its pre-activation is
    the forward kernel's on the chain up to it."""
    from sdfstudio_tpu_torch.ops import mlp

    prev_chain, prev_plain = mlp.fused_mlp, mlp.MLP.forward_plain
    kernel = iter(carry or [])

    def kernel_call(kind: str, dims: tuple) -> dict:
        k = next(kernel, None)
        check(k is not None and k["kind"] == kind and k["dims"] == dims,
              f"the carried step's relu call is not a {kind} of {dims}")
        return k

    def flipped(st: dict, flip: torch.Tensor, pre_a: torch.Tensor, pre_b: torch.Tensor) -> None:
        if bool(flip.any()):
            st["flips"] += int(flip.sum())
            st["max_abs_pre"] = max(st["max_abs_pre"],
                                    float(torch.maximum(pre_a.abs(), pre_b.abs())[flip].max()))

    def recorded_chain(x, weights, biases, activation="relu", out_activation="none"):
        dims = (x.shape[-1], *(w.shape[1] for w in weights))
        rec = {"kind": "chain", "dims": dims, "x": x.detach().reshape(-1, dims[0]).contiguous().clone(),
               "ws": [w.detach() for w in weights], "bs": [b.detach() for b in biases]}
        record.append(rec)
        y = prev_chain(x, weights, biases, activation, out_activation)
        if y.requires_grad:
            y.register_hook(lambda g: rec.__setitem__("g", g.detach().reshape(-1, dims[-1]).contiguous()))
        return y

    def carried_chain(x, weights, biases, activation="relu", out_activation="none"):
        dims = (x.shape[-1], *(w.shape[1] for w in weights))
        k, n = kernel_call("chain", dims), len(weights)
        st = {"kind": "chain", "dims": dims, "rows_queried": 0, "flips": 0, "max_abs_pre": 0.0}
        record.append(st)
        ws, bs, g, sides = k["ws"], k["bs"], k.get("g"), {}

        def kernel_sides(r: int) -> list:
            """Row ``r``'s relu sides in the backward kernel, and where they matter."""
            if r not in sides:
                st["rows_queried"] += 1
                _, _, dbs = fm.fused_mlp_bwd(k["x"][r:r + 1], ws, bs, g[r:r + 1], activation,
                                             out_activation, need_dx=False)
                sides[r] = [(dbs[i] != 0, (dbs[i + 1] @ ws[i + 1].T != 0) if i < n - 1 else g[r] != 0)
                            for i in range(n)]
            return sides[r]

        if g is None or "relu" not in (activation, out_activation):  # no relu takes a gradient
            return prev_chain(x, weights, biases, activation, out_activation)
        h, kin = x.reshape(-1, dims[0]), k["x"]
        for i, (w, b) in enumerate(zip(weights, biases)):
            pre = torch.matmul(h, w) + b
            act = activation if i < n - 1 else out_activation
            with torch.no_grad():  # the forward kernel's pre-activation and its layer's output
                pre_k = fm.fused_mlp(k["x"], ws[:i + 1], bs[:i + 1], activation, "none")
                kin_next = fm._act(pre_k, act)
            if act != "relu":
                h, kin = fm._act(pre, act), kin_next
                continue
            with torch.no_grad():
                band = relu_band(kin, h.detach(), w.detach(), b.detach())
                p = pre.detach()
                near = (p.abs() <= band) & (pre_k.abs() <= band)
                mask = p > 0
                for r in torch.nonzero(near.any(dim=-1)).flatten().tolist():
                    side, known = kernel_sides(r)[i]
                    flip = near[r] & known & (side != mask[r])
                    flipped(st, flip, p[r], pre_k[r])
                    mask[r] = torch.where(flip, side, mask[r])
            h, kin = pre * mask.to(pre.dtype), kin_next
        return h.reshape(*x.shape[:-1], dims[-1])

    def plain_mlp(self, x):
        """``MLP.forward_plain`` step by step, its relu layers recorded or carried."""
        dims = tuple(tuple(layer.kernel.shape) for layer in self.layers)
        if carry is None:
            layers = []
            record.append({"kind": "mlp", "dims": dims, "layers": layers})
        else:
            k, j = kernel_call("mlp", dims), 0
            st = {"kind": "mlp", "dims": dims, "rows_queried": 0, "flips": 0, "max_abs_pre": 0.0}
            record.append(st)
        inputs = h = x
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            if i in self.skips:
                h = torch.cat([inputs, h], dim=-1)
            pre = torch.matmul(h, layer.kernel) + layer.bias
            if i == n - 1:
                h = torch.sigmoid(pre) if self.out_activation == "sigmoid" else fm._act(pre, self.out_activation)
            elif self.activation != "relu":
                h = fm._act(pre, self.activation)
            elif carry is None:
                layers.append((h.detach(), pre.detach()))
                h = torch.relu(pre)
            else:
                with torch.no_grad():
                    h_k, pre_k = k["layers"][j]
                    j += 1
                    p = pre.detach()
                    band = relu_band(h_k, h.detach(), layer.kernel.detach(), layer.bias.detach())
                    flip = (p.abs() <= band) & (pre_k.abs() <= band) & ((p > 0) != (pre_k > 0))
                    flipped(st, flip, p, pre_k)
                    mask = torch.where(flip, pre_k > 0, p > 0)
                h = pre * mask.to(pre.dtype)
        return h

    mlp.MLP.forward_plain = plain_mlp
    try:
        with swap_fused_mlp(recorded_chain if carry is None else carried_chain):
            yield
    finally:
        mlp.MLP.forward_plain = prev_plain


def relu_parted(record: list) -> dict:
    """A carried step's relu flips (``relu_choices``): by fused chain and by
    plain MLP, the rows whose backward-kernel sides were read, and the
    largest |pre-activation| at a flip."""
    out = {"chain_flips": 0, "mlp_flips": 0, "rows_queried": 0, "max_abs_pre": 0.0}
    for st in record:
        out[f"{st['kind']}_flips"] += st["flips"]
        out["rows_queried"] += st["rows_queried"]
        out["max_abs_pre"] = max(out["max_abs_pre"], st["max_abs_pre"])
    return out


def step_vs_plain(fm, phase: str, one_step, plain_hash: bool = True, loss_tol=STEP_LOSS_TOL,
                  grad_tol: float = STEP_GRAD_TOL, shared_samples: bool = False,
                  merge_radius: Optional[float] = None, only_well_posed: bool = False,
                  model=None, group_tols: Optional[dict] = None,
                  carry_choices: bool = False, carry_relu: bool = False) -> dict:
    """One step twice from the same state and batch, its launches not
    counted: with the kernels (their fused-MLP and hash-grid calls
    captured), then with their plain versions (the fused MLP's and, with
    ``plain_hash``, the hash grid's). ``one_step()`` returns the losses,
    each group's gradient, and anything else (the kernel step's is kept as
    ``extra``). Each loss is held to ``loss_tol`` (a number, or a function
    of the loss's name), each gradient to ``grad_tol`` relative, and no
    group's gradient may be zero.

    With ``shared_samples`` (a model on the proposal sampler) the plain
    versions take a third step on the kernel step's PDF resamplings
    (``pdf_samples``): the proposal densities, the field and the losses at
    the same samples, held as above on every call, and where the two paths'
    resamplings part is reported (``samples_parted``). The step on the
    plain path's own resamplings is held too; with ``only_well_posed`` only
    where that comparison is well posed: where no resampled sample moved by
    more than ``grad_tol`` of the finest feature of the ``model``'s network
    that takes it (``finest_cells``) and no final sample changed side of
    ``merge_radius``. Elsewhere the two steps differentiate the networks at
    samples that differ, to the gradient, by more than the tolerance (or
    the background merge's discrete choice differs), and that comparison is
    reported, not held. ``group_tols`` gives a group a gradient tolerance of
    its own in place of ``grad_tol`` (``f32_conditioning``).

    With ``carry_choices`` the steps' discrete choices are recorded
    (``discrete_choices``: the rgb L1 signs and the merge's sides of the
    ``model``): the step on the kernel step's resamplings is held with the
    kernel step's choices carried over, and where the plain step's own
    choices part from the kernel step's (``choices_parted``), the plain
    step with the kernel step's choices carried over is held in place of
    the free one, which is then reported with its count of flips. The step
    on the kernel step's resamplings without the carry is reported beside
    them.

    With ``carry_relu`` (and ``shared_samples``) the step on the kernel
    step's resamplings is held with the kernel step's relu sides carried
    over too (``relu_choices``): there the two paths compute every
    pre-activation from the same samples, and a unit within their rounding
    of 0 is the same discrete choice. Its flips (``relu_parted``) and the
    step without any carry are reported."""
    from sdfstudio_tpu_torch.scripts.benchmarking.hash_grid_designs import capture_hash_calls

    calls, hash_calls, k_rec, p_rec = [], [], [], []
    k_ch, p_ch, s_ch, k_relu, s_relu = [], [], [], [], []
    record = pdf_samples if shared_samples else (lambda rec: contextlib.nullcontext())
    carry_relu = carry_relu and shared_samples

    def choices(rec, carry=None):
        return discrete_choices(model, rec, carry) if carry_choices else contextlib.nullcontext()

    def relus(rec, carry=None):
        return relu_choices(fm, rec, carry) if carry_relu else contextlib.nullcontext()

    def plain():
        return _both_plain(fm) if plain_hash else swap_fused_mlp(fm.fused_mlp_plain)

    with uncounted(fm):
        with capture_fused_mlp_calls(calls), capture_hash_calls(hash_calls), record(k_rec), \
                choices(k_ch), relus(k_relu):
            k_loss, k_grads, *extra = one_step()
        with plain(), record(p_rec), choices(p_ch):
            p_loss, p_grads, *_ = one_step()
        shared = shared_free = carried = None
        if shared_samples:
            with plain(), pdf_samples(k_rec, replay=True), choices(s_ch, carry=k_ch), \
                    relus(s_relu, carry=k_relu):
                shared = one_step()[:2]
        del k_relu
        flips = choices_parted(k_ch, p_ch) if carry_choices else None
        if (carry_choices or carry_relu) and shared_samples:  # reported: the same samples, no carry
            with plain(), pdf_samples(k_rec, replay=True):
                shared_free = one_step()[:2]
        if carry_choices and (flips["l1_sign_flips"] or flips["side_flips"]):
            with plain(), choices([], carry=k_ch):
                carried = one_step()[:2]
        torch.cuda.synchronize()
    tol_of = loss_tol if callable(loss_tol) else (lambda k: loss_tol)
    grad_norm = {g: float(torch.linalg.vector_norm(v)) for g, v in k_grads.items()}

    def errors(ref_loss, ref_grads):
        return ({k: abs(k_loss[k] - ref_loss[k]) / max(abs(ref_loss[k]), 1e-12) for k in ref_loss},
                {g: rel_fro(k_grads[g], ref_grads[g]) for g in ref_grads})

    def held(what, loss_err, grad_err):
        for k, e in loss_err.items():
            check(e <= tol_of(k), f"{phase} {k}: kernel step and {what} differ by {e}")
        for g, e in grad_err.items():
            tol = (group_tols or {}).get(g, grad_tol)
            check(e <= tol and grad_norm[g] > 0,
                  f"{phase} {g} gradient: kernel step and {what} differ by {e} (tol {tol}, norm "
                  f"{grad_norm[g]})")

    loss_err, grad_err = errors(p_loss, p_grads)
    out = {"loss": k_loss, "loss_err": loss_err, "grad_err": grad_err, "grad_norm": grad_norm,
           "calls": calls, "hash_calls": hash_calls, "extra": extra}
    free_held = True
    if shared is not None:
        parted = samples_parted(k_rec, p_rec, merge_radius, model)
        well_posed = (parted["side_flips"] == 0 and model is not None
                      and max(parted["cells_max_abs_diff"]) <= grad_tol)
        free_held = well_posed or not only_well_posed
        s_loss_err, s_grad_err = errors(*shared)
        out.update({"shared_loss_err": s_loss_err, "shared_grad_err": s_grad_err, "parted": parted,
                    "well_posed": well_posed, "free_held": free_held})
    log(phase, f"the step's losses {k_loss}; kernel step vs plain step: loss rel err {loss_err} "
        f"(tol {tol_of('rgb_loss')}); gradient rel err {grad_err} (tol {grad_tol}); gradient norms "
        f"{grad_norm}" + ("" if shared is None else
                          f"; the resamplings parted {json.dumps(out['parted'])}: "
                          f"{'well posed' if well_posed else 'ill-posed'}, "
                          f"{'held' if free_held else 'NOT held'}; "
                          f"on the kernel step's resamplings: loss rel err {out['shared_loss_err']}, "
                          f"gradient rel err {out['shared_grad_err']}"))
    if carry_choices:
        out["choices"] = {"free": flips, "shared": choices_parted(k_ch, s_ch) if s_ch else None}
    if carry_relu:
        out["relu_flips"] = relu_parted(s_relu)
    if shared_free is not None:
        out["shared_uncarried_loss_err"], out["shared_uncarried_grad_err"] = errors(*shared_free)
    if carried is not None:
        out["carried_loss_err"], out["carried_grad_err"] = errors(*carried)
    if carry_choices or carry_relu:
        log(phase, "; ".join(
            ([f"discrete choices parted {json.dumps(out['choices'])}"] if carry_choices else [])
            + ([f"relu sides carried on the kernel step's resamplings {json.dumps(out['relu_flips'])}"]
               if carry_relu else [])
            + ([] if shared_free is None else
               [f"on the kernel step's resamplings without the carry: gradient rel err "
                f"{out['shared_uncarried_grad_err']}"])
            + ([] if carried is None else
               [f"the plain step with the kernel step's choices carried over: loss rel err "
                f"{out['carried_loss_err']}, gradient rel err {out['carried_grad_err']} (held in "
                f"place of the free step)"])))
    if shared is not None:
        held("plain step on its resamplings", out["shared_loss_err"], out["shared_grad_err"])
    if free_held and carried is not None:
        held("plain step with the kernel step's choices carried over", out["carried_loss_err"],
             out["carried_grad_err"])
    elif free_held:
        held("plain step", loss_err, grad_err)
    return out


def traced_step(trainer, windows=()) -> dict:
    """One train step under the profiler: its wall time and where its
    device time goes (``render_breakdown``)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        trainer.train_step()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t) * 1e3
    return {"traced_wall_ms": traced_ms, **render_breakdown(prof.events(), traced_ms, windows=windows)}


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


def traced_chunks(model, cams, sched, n: int = TRACED_CHUNKS) -> dict:
    """The first ``n`` 1024-ray chunks of view 0 rendered under the
    profiler: the wall time, the device's busy time and idle share, and the
    ``sst/*`` ranges (``render_breakdown``)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    rb = cams.generate_image_rays(0)
    n = min(n, math.ceil(rb.origins.shape[0] / 1024))
    with torch.profiler.profile(activities=acts) as prof, torch.no_grad():
        t = time.perf_counter()
        for i in range(n):
            model.get_outputs(rb.map(lambda x: x[i * 1024:(i + 1) * 1024]), sched=sched)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t) * 1e3
    return {"chunks": n, "traced_wall_ms": traced_ms, **render_breakdown(prof.events(), traced_ms)}


def render_view(fm, model, cams, step: int, phase: str, plain_swap, chunk_chains: dict) -> dict:
    """The scene's 384x384 view 0 rendered with the kernels (warm: the
    training steps ran the same kernels and products), its launches counted
    by kernel and by chain (``chunk_chains``: each chain's forward launches
    a chunk; no backward), its ``PLAIN_RAYS`` middle rays rendered again
    under ``plain_swap()`` (every kernel swapped for its plain version, its
    launches not counted), the 0.999 quantile of them held to ``SLICE_TOL``,
    and its first chunks traced (``traced_chunks``). Every pixel must be
    finite."""
    from sdfstudio_tpu_torch.engine.final_eval import IMAGE_KEYS, render_image

    check(int(cams.height[0]) == IMAGE and int(cams.width[0]) == IMAGE,
          f"the scene's view is not {IMAGE}x{IMAGE}")
    n_chunks = math.ceil(IMAGE * IMAGE / 1024)
    fm.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = render_image(model, cams, 0, chunk=1024, step=step)
    torch.cuda.synchronize()
    image_ms = (time.perf_counter() - t) * 1e3
    render_launches, render_widths = dict(fm.LAUNCHES), width_counts(fm)
    render_chains = {w: chain_counts(fm, w) for w in ("fwd", "bwd")}
    want = {"fwd": {chain: k * n_chunks for chain, k in chunk_chains.items()}, "bwd": {}}
    check(render_chains == want, f"expected {want} launches by chain in the render: {render_chains}")
    # the middle rows of the view (the object) through the plain versions
    rb = cams.generate_image_rays(0)
    sched_r = model.schedules(step)
    mid = slice(IMAGE * IMAGE // 2 - PLAIN_RAYS // 2, IMAGE * IMAGE // 2 + PLAIN_RAYS // 2)
    sub = rb.map(lambda x: x[mid])
    plain_out = {k: [] for k in IMAGE_KEYS}
    with plain_swap(), torch.no_grad():
        for i in range(0, PLAIN_RAYS, 1024):
            o = model.get_outputs(sub.map(lambda x: x[i:i + 1024]), sched=sched_r)
            for k in IMAGE_KEYS:
                plain_out[k].append(o[k])
    torch.cuda.synchronize()
    fm.LAUNCHES.update(render_launches)
    for k, v in out.items():
        check(bool(torch.isfinite(v).all()), f"{k} has non-finite values")
    ray_err = {k: (out[k].reshape(IMAGE * IMAGE, -1)[mid] - torch.cat(plain_out[k])).abs().amax(-1)
               for k in IMAGE_KEYS}
    render_err = {k: float(e.max()) for k, e in ray_err.items()}
    render_q = {k: float(torch.quantile(e, RENDER_QUANTILE)) for k, e in ray_err.items()}
    render_profile = traced_chunks(model, cams, sched_r)
    log(phase.replace("surface", "surface_profile"), json.dumps({"render_chunks": render_profile}))
    acc = out["accumulation"]
    log(phase, f"rendered {IMAGE}x{IMAGE} in {n_chunks} chunks: {image_ms:.1f} ms an image; launches "
        f"{render_launches}, by chain {render_chains}; kernel path vs plain path on the "
        f"{PLAIN_RAYS} middle rays, max |diff| {render_err}, {RENDER_QUANTILE} quantile of rays "
        f"{render_q} (tol {SLICE_TOL}); "
        f"accumulation min {float(acc.min()):.4f} max {float(acc.max()):.4f}")
    for k in IMAGE_KEYS:
        check(render_q[k] < SLICE_TOL, f"{k}: kernel and plain renders differ by {render_q[k]} on "
              f"more than {1 - RENDER_QUANTILE:.1%} of the rays")
    del out, plain_out
    return {"launches": render_launches, "chains": render_chains, "widths": render_widths,
            "image_ms": image_ms, "err": render_err, "quantile_err": render_q, "profile": render_profile}


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

    step = step_vs_plain(fm, phase, one_step, plain_hash=False)
    k_loss, grad_norm, (surface_rays,) = step["loss"], step["grad_norm"], step["extra"]
    loss_err, grad_err = step["loss_err"], step["grad_err"]
    log(phase, f"rays with a surface point {surface_rays} of {rays}")
    if method == "unisurf":
        check(0 < surface_rays and k_loss["normal_smoothness_loss"] > 0,
              f"UniSurf's surface search found {surface_rays} rays, smoothness loss "
              f"{k_loss['normal_smoothness_loss']}")
    calls = step["calls"]
    widths = [_chain_key(c) for c in calls]
    check(sorted(widths) == sorted(SURFACE_CHAINS) and all("g" in c for c in calls),
          f"expected a call with a backward on each chain, captured {widths}")
    chains = chain_checks(fm, calls, [SURFACE_CHAINS[w] for w in widths], phase, method)
    del calls, step

    # one traced update step: where its time goes
    step_profile = traced_step(trainer)
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
    views and the 64^3 mesh, the eval split every 8th view); the run's
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

    def one_step(seed: int = 777):
        gen = torch.Generator(device=dm.device).manual_seed(seed)
        idx, batch = dm.sample_train_batch(gen)
        total, ld, _ = loss_and_metrics(model, dm.generate_rays(idx), batch, sched, gen)
        return {k: float(v.detach()) for k, v in ld.items()}, grads_of(trainer, total)

    # bigmlp's NeRF background takes the samples beyond the unit sphere
    merge = 1.0 if model.field_background is not None else None
    # bigmlp's L1 signs and merge sides are carried from the kernel step (discrete_choices)
    carry = merge is not None
    step = step_vs_plain(fm, phase, one_step, shared_samples=True, merge_radius=merge, model=model,
                         carry_choices=carry)
    calls, hash_calls = step["calls"], step["hash_calls"]
    loss_err, grad_err = step["loss_err"], step["grad_err"]

    def batch_record(seed, r):
        return {"seed": seed, "grad_err": r["grad_err"], "shared_grad_err": r["shared_grad_err"],
                **{k: r[k] for k in ("choices", "carried_grad_err", "shared_uncarried_grad_err")
                   if k in r}, **r["parted"]}

    parted = [batch_record(777, step)]
    if merge is not None:
        # more batches from the same state: where the kernel and plain steps part (ROADMAP queue 3)
        for seed in DIVERGENCE_SEEDS:
            r = step_vs_plain(fm, f"{phase} batch {seed}", lambda: one_step(seed), shared_samples=True,
                              merge_radius=merge, model=model, carry_choices=True)
            parted.append(batch_record(seed, r))
            del r
        log(phase, f"kernel vs plain steps by batch, with the final samples that changed side of the "
            f"unit sphere: {json.dumps(parted)}")

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

    launches = {
        "train": launches_held(phase, "train", train_launches, want(TRAIN_STEPS, 0, 0)),
        "eval_images": [launches_held(phase, f"eval image {e['step']}", e["launches"],
                                      want(0, image_chunks, 0))
                        for e in evals],
        "final_eval": launches_held(phase, "final eval", finals[0]["launches"],
                                    want(0, final_chunks, mesh_chunks)),
        "eval_py": launches_held(phase, "eval.py", eval_launches, want(0, n_eval * image_chunks, 0)),
        "extract_mesh": launches_held(phase, "extract_mesh.py", mesh_launches, want(0, 0, mesh_chunks)),
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
           "step_parted": parted, "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}
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
    del trainer, model, made, calls, hash_calls, step
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return out


def start_cue_scene() -> None:
    """Start the DTU-like scene's generator (with its monocular cues, pairs
    and SfM points) in a process of its own, into a temporary directory."""
    out = tempfile.mkdtemp(prefix="sst_cue_scene_")
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1")
    _CUE_SCENE["dir"] = out
    _CUE_SCENE["t0"] = time.perf_counter()
    _CUE_SCENE["proc"] = subprocess.Popen(
        [sys.executable, "-c", CUE_SCENE_CHILD, out, SCENE, str(CUE_PAIRS), str(CUE_SFM_POINTS)],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish_cue_scene() -> dict:
    """Wait for the generator; its images must equal the committed scene's
    pixel for pixel (JAX's generator at its defaults wrote them)."""
    proc = _CUE_SCENE["proc"]
    out, err = proc.communicate(timeout=600)
    check(proc.returncode == 0, f"the cue scene's generator failed: {err[-2000:]}")
    info = json.loads(out.strip().splitlines()[-1])
    info["waited_s"] = time.perf_counter() - _CUE_SCENE["t0"]
    log("cue", f"generated {_CUE_SCENE['dir']}: {json.dumps(info)}")
    check(info["pngs_compared"] == 98 and info["max_pixel_diff"] == 0,
          f"the generated scene differs from the committed one: {info}")
    return info


def stop_cue_scene() -> None:
    proc = _CUE_SCENE.get("proc")
    if proc is not None and proc.poll() is None:
        proc.kill()
        proc.wait()
    if "dir" in _CUE_SCENE:
        shutil.rmtree(_CUE_SCENE["dir"], ignore_errors=True)


def cue_phase(fm, smi: str, method: str, scene: str) -> dict:
    """A MonoSDF or Geo-NeuS entry (``cue[<method>]``) at its registered
    width and 1024 rays, built through JAX's grammar from the outward-facing
    init (``--pipeline.model.sdf-field.inside-outside False``, as
    SDFStudio's DTU commands run: from the registered inward one no ray from
    outside the object crosses from + to -, and the geo term would be empty)
    on the generated scene with its cues: ``CUE_STEPS`` steps through
    ``Trainer.train`` (ms a step over steps 2 onwards), launches counted by
    chain exactly (a forward and a backward a step on the colour net and the
    background head), one step with the kernels against one with the plain
    versions (every loss term, every group's gradient), the new terms
    (``normal_loss`` and ``depth_loss``, or ``patch_loss`` with the share of
    rays that have a crossing and a fully valid source patch), and one
    traced step (``sst/patch_warping``, ``sst/cue_losses``, the idle
    share). Returns what the ``kernels`` line reports."""
    from sdfstudio_tpu_torch.engine.setup import setup_trainer
    from sdfstudio_tpu_torch.scripts import train as train_script

    phase = f"cue[{method}]"
    geo = method.startswith("geo")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    argv = [method, "--pipeline.model.sdf-field.inside-outside", "False", "--vis", "none",
            "--trainer.max-num-iterations", str(CUE_STEPS),
            "--pipeline.datamanager.train-num-rays-per-batch", str(CUE_RAYS),
            "sdfstudio-data", "--data", scene]
    config, _ = train_script.parse_args(argv)
    t = time.perf_counter()
    trainer = setup_trainer(config, device="cuda", checkpoints=False)
    trainer.setup()
    dm, model = trainer.datamanager, trainer.model
    rays = dm.config.train_num_rays_per_batch
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t
    check(rays == CUE_RAYS and (type(dm).__name__ == "FlexibleDataManager") == geo,
          f"{phase}: {type(dm).__name__} at {rays} rays")
    check(sorted(dm.train_data) == (["image"] if geo else ["depth", "image", "normal"]),
          f"{phase}: the image stack holds {sorted(dm.train_data)}")
    log(phase, f"{sum(p.numel() for p in model.parameters())} parameters, {type(dm).__name__}, "
        f"parser {config.dataparser}, {rays} rays a step"
        + (f", sources a view {tuple(dm.pairs_srcs.shape)}" if geo else "")
        + f"; set up in {setup_s:.2f} s")
    rows = []
    step_fn = trainer.train_step
    trainer.train_step = lambda: rows.append(step_fn()) or rows[-1]  # every step's metrics, read later
    fm.reset_launch_counts()
    trainer.train_step()
    trainer.train_step()
    torch.cuda.synchronize()
    t = time.perf_counter()
    last = trainer.train(CUE_STEPS)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3 / (CUE_STEPS - 2)
    train_launches = dict(fm.LAUNCHES)
    train_chains = {w: chain_counts(fm, w) for w in ("fwd", "bwd")}
    trainer.train_step = step_fn
    per_step = {k: torch.stack(rows)[:, i].cpu().tolist() for i, k in enumerate(trainer.metric_keys)}
    first = {k: v[0] for k, v in per_step.items()}
    log(phase, f"Trainer.train, steps 2-{CUE_STEPS - 1}: {step_ms:.2f} ms a step, "
        f"{rays / step_ms * 1e3:.0f} rays/s; launches {train_launches}, by chain {train_chains}; "
        f"losses at step 1 / {CUE_STEPS}: "
        + " ".join(f"{k}={first[k]:.5g}/{last[k]:.5g}" for k in trainer.metric_keys))
    check(trainer.step == CUE_STEPS, f"{phase}: Trainer.train stopped at step {trainer.step}")
    check(all(math.isfinite(v) for v in list(first.values()) + list(last.values())),
          f"{phase}: a training loss or metric is not finite")
    every_step = {chain: CUE_STEPS for chain in SURFACE_CHAINS}
    check(train_chains == {"fwd": every_step, "bwd": every_step},
          f"{phase}: expected a forward and a backward launch a step on each chain: {train_chains}")
    check(train_launches["fused_mlp_fwd"] == train_launches["fused_mlp_bwd"] == 2 * CUE_STEPS,
          f"{phase}: fused-MLP launches {train_launches}")
    new_terms = ("patch_loss",) if geo else ("normal_loss", "depth_loss")
    # a batch's patch term is 0 where no ray has fewer than topk invalid or flat source
    # patches (they score exactly 0 and rank first): the term is held over the run's steps
    term_mean = {k: sum(per_step[k]) / len(per_step[k]) for k in new_terms}
    log(phase, f"new terms over the {CUE_STEPS} steps: " + "; ".join(
        f"{k} mean {term_mean[k]:.5g}, above 0 on {sum(v > 0 for v in per_step[k])} steps"
        for k in new_terms))
    for k in new_terms:
        check(term_mean[k] > 0, f"{phase}: {k} is 0 on every step: {per_step[k]}")

    # one step twice from the same state and batch: the kernels, then the plain versions
    sched = model.schedules(trainer.step)

    def one_step():
        gen = torch.Generator(device=dm.device).manual_seed(777)
        if geo:
            idx, batch, additional = dm.sample_train_batch_flexible(gen)
            outputs = model.get_outputs_flexible(dm.generate_rays(idx), additional, sched=sched,
                                                 train=True, rng=gen)
        else:
            idx, batch = dm.sample_train_batch(gen)
            outputs = model.get_outputs(dm.generate_rays(idx), sched=sched, train=True, rng=gen)
        ld = model.get_loss_dict(outputs, batch, sched, gen)
        share = None
        if geo:
            valid = outputs["patches_valid_mask"]
            share = float(valid[1:].all(dim=2).any(dim=0).float().mean())
        return ({k: float(v.detach()) for k, v in ld.items()}, grads_of(trainer, sum(ld.values())),
                share)

    step = step_vs_plain(fm, phase, one_step, plain_hash=False)
    k_loss, (share,) = step["loss"], step["extra"]
    loss_err, grad_err = step["loss_err"], step["grad_err"]
    del step
    patch_bytes = None
    if geo:
        n_views = int(dm.pairs_srcs.shape[1])
        patch_bytes = n_views * rays * model.config.patch_size ** 2 * 3 * 4
    if geo:
        log(phase, f"rays with a crossing and a fully valid source patch {share:.4f} (at least "
            f"{CUE_VALID_SHARE}); warped colours {n_views} views x {rays} rays x "
            f"{model.config.patch_size ** 2} pixels, {patch_bytes / 2**20:.1f} MiB")
        check(share > CUE_VALID_SHARE, f"{phase}: only {share} of the rays warp a valid patch")
    for k in new_terms:
        check(k in k_loss and math.isfinite(k_loss[k]), f"{phase}: {k} is {k_loss.get(k)}")

    # one step under the sync debug mode: the host's waits for the device inside a step
    import warnings

    with uncounted(fm), warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            trainer.train_step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message).splitlines()[0][:120] for w in caught if "synchroniz" in str(w.message)]
    log(phase, f"host waits in one step (sync debug mode): {len(syncs)} {sorted(set(syncs))[:6]}")

    # one traced update step: the patch warp's and the cue losses' device time, the idle share
    with uncounted(fm):
        profile = traced_step(trainer)
    traced_ms, ranges = profile["traced_wall_ms"], profile["ranges"]
    check("sst/cue_losses" in ranges and (not geo or "sst/patch_warping" in ranges),
          f"{phase}: the traced step has no sst/cue_losses or sst/patch_warping range: {sorted(ranges)}")
    warp_ms = ranges.get("sst/patch_warping", {}).get("kernel_ms")
    cue_ms = ranges["sst/cue_losses"]["kernel_ms"]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(phase.replace("cue", "cue_profile"), json.dumps({"train_step": profile}))
    log(phase, f"traced step: {traced_ms:.2f} ms wall, device busy {profile['device_busy_ms']:.2f} ms, "
        f"idle share {profile['device_idle_share']:.3f}; sst/patch_warping {warp_ms} ms, "
        f"sst/cue_losses {cue_ms:.3f} ms of kernels; peak memory {peak_gib:.2f} GiB")
    del trainer, model
    torch.cuda.empty_cache()
    return {"method": method, "rays": rays, "setup_s": setup_s, "step_ms": step_ms,
            "rays_per_s": rays / step_ms * 1e3, "loss_first": first, "loss_last": last,
            "train_launches": train_launches, "chains": train_chains, "step_loss": k_loss,
            "step_loss_err": loss_err, "step_grad_err": grad_err, "valid_share": share,
            "patch_bytes": patch_bytes, "patch_warping_ms": warp_ms, "cue_losses_ms": cue_ms,
            "term_mean": term_mean, "syncs": len(syncs),
            "train_step_idle_share": profile["device_idle_share"],
            "traced_step_ms": traced_ms, "device_busy_ms": profile["device_busy_ms"],
            "peak_memory_gib": peak_gib}


def _chain_key(c) -> str:
    return "-".join(str(d) for d in [c["x"].shape[-1]] + [w.shape[1] for w in c["ws"]])


def expected_launches(calls: list, hash_calls: list, steps: int, n_update: int, chunks: int,
                      proposal_chains=frozenset(), proposal_specs=()) -> tuple:
    """Launches by kernel and by chain of ``steps`` train steps (a step's
    captured ``calls`` and ``hash_calls`` each; a proposal net's backward on
    the ``n_update`` update steps only) and ``chunks`` render chunks (each
    call's forward once, no backward)."""
    chains = {}
    for c in calls:
        key = ("fused_mlp_fwd", tuple(int(d) for d in _chain_key(c).split("-")))
        chains[key] = chains.get(key, 0) + steps + chunks
        if steps and "g" in c:
            bkey = ("fused_mlp_bwd", key[1])
            chains[bkey] = chains.get(bkey, 0) + (n_update if key[1] in proposal_chains else steps)
    hash_bwd = sum(("g_out" in r) * (n_update if r["spec"] in proposal_specs else steps)
                   for r in hash_calls)
    kernels = {"fused_mlp_fwd": sum(n for (k, _), n in chains.items() if k == "fused_mlp_fwd"),
               "fused_mlp_bwd": sum(n for (k, _), n in chains.items() if k == "fused_mlp_bwd"),
               "hash_encode_fwd": len(hash_calls) * (steps + chunks),
               "hash_encode_bwd": hash_bwd if steps else 0}
    return kernels, chains


def launches_held(phase: str, name: str, got: tuple, expected: tuple) -> dict:
    """``got`` (launches by kernel, by chain) equal to ``expected``, exactly."""
    kernels = {k: got[0].get(k, 0) for k in expected[0]}
    others = {k: n for k, n in got[0].items() if k not in expected[0] and n}
    check(kernels == expected[0] and not others and got[1] == expected[1],
          f"{phase} {name}: launches {got}, expected {expected}")
    return {"kernels": kernels, "chains": {f"{k}:{'-'.join(map(str, w))}": n
                                           for (k, w), n in got[1].items()}}


def grid_phase(fm, smi: str, method: str) -> dict:
    """An occupancy-grid entry at full width through JAX's command line:
    ``neusW`` and ``dto`` (``heritage[<method>]``) on the committed
    heritage-like scene through ``heritage-data``, their fine grid refreshed
    and armed at ``GRID_REFRESH`` through the config's own fields
    (``fine_grid_update_every``, ``fine_grid_warmup``); ``neus-acc``
    (``surface[neus-acc]``) on the DTU-like scene, refreshed at its own 16.
    ``TRAIN_STEPS`` steps at the registered 2048 rays (ms a step over steps
    12-39), the grid's occupied cells after every step (the fine grid empty
    before ``GRID_REFRESH`` and not after it; neus-acc's binary the
    threshold of its cells' opacity, refreshed from step 0 on), the share of
    rays inside the fine shell, the refresh timed; one
    kernel step against one plain step (1e-4; the kernels of the colour
    net, the background's chain and, for the grid background, the F = 2
    hash grid, swapped for their plain versions); launches by kernel and by
    chain exact in the steps (a captured step's calls times the steps) and
    the final evaluation (1 view, the 64^3 mesh through the heritage or
    DTU-like judge); both chains alone (``chain_checks``); the background's
    F = 2 hash call (``hash_case``, ``neusW`` only); one traced step.
    Returns what the ``kernels`` line reports."""
    from sdfstudio_tpu_torch.engine import trainer as trainer_mod
    from sdfstudio_tpu_torch.engine.trainer import loss_and_metrics
    from sdfstudio_tpu_torch.samplers.grid import grid_near_far
    from sdfstudio_tpu_torch.scripts import train as train_script

    heritage = method in ("neusW", "dto")
    phase = f"{'heritage' if heritage else 'surface'}[{method}]"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    made, marks, occupied, finals = [], {}, [], []
    setup, final = train_script.setup_lib.setup_trainer, trainer_mod.run_final_eval

    def keep(*args, **kw):
        """The trainer ``main`` builds: steps 12 and 40 marked, the grid's
        occupied cells kept after every step (on the device, read later)."""
        t = setup(*args, **kw)
        step = t.train_step

        def marked_step():
            if t.step == CHECK_STEPS:
                torch.cuda.synchronize()
                marks["t0"] = time.perf_counter()
            out = step()
            occupied.append(t.model_state.binary.sum())
            if t.step == TRAIN_STEPS:
                torch.cuda.synchronize()
                marks["t1"] = time.perf_counter()
            return out

        t.train_step = marked_step
        made.append(t)
        return t

    def counted_final(*a):
        c0, s0 = _counts(fm), time.perf_counter()
        out = final(*a)
        torch.cuda.synchronize()
        finals.append({"seconds": time.perf_counter() - s0, "launches": _minus(_counts(fm), c0)})
        return out

    with tempfile.TemporaryDirectory() as tmp:
        argv = [method, "--experiment-name", "smoke", "--output-dir", tmp, "--timestamp", "t",
                "--vis", "none", "--trainer.max-num-iterations", str(TRAIN_STEPS),
                "--trainer.steps-per-eval-image", "0",
                "--trainer.final-eval-gt", "heritage-like" if heritage else "dtu-like",
                "--trainer.final-eval-output", f"{tmp}/metrics.json",
                "--trainer.final-eval-resolution", str(CLI_MESH_RES),
                "--trainer.final-eval-max-images", str(CLI_FINAL_IMAGES)]
        if heritage:
            argv += ["--pipeline.model.fine-grid-update-every", str(GRID_REFRESH),
                     "--pipeline.model.fine-grid-warmup", str(GRID_REFRESH),
                     "heritage-data", "--data", HERITAGE_SCENE]
        else:
            argv += ["sdfstudio-data", "--data", SCENE, "--skip-every-for-val-split",
                     str(CLI_EVAL_SPLIT)]
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
        metrics = json.loads((Path(tmp) / "metrics.json").read_text())
    trainer = made[0]
    dm, model = trainer.datamanager, trainer.model
    rays = dm.config.train_num_rays_per_batch
    step_ms = (marks["t1"] - marks["t0"]) * 1e3 / (TRAIN_STEPS - CHECK_STEPS)
    cells = torch.stack(occupied).cpu().tolist()
    res = trainer.model_state.resolution
    check(rays == TRAIN_RAYS and len(cells) == TRAIN_STEPS, f"{phase}: {rays} rays, {len(cells)} steps")
    if heritage:
        check(all(c == 0 for c in cells[:GRID_REFRESH]) and all(c > 0 for c in cells[GRID_REFRESH:]),
              f"{phase}: the fine grid is not empty before step {GRID_REFRESH} and occupied from it "
              f"on: {cells}")
    else:
        # refreshed every 16 steps from step 0: the cells' opacity is held, and the binary is its
        # threshold (at the initial inv_s of e every cell's crossing opacity exceeds it)
        st = trainer.model_state
        check(float(st.occs.max()) > 0 and all(c > 0 for c in cells)
              and torch.equal(st.binary.reshape(-1), st.occs > model.config.alpha_sample_thre),
              f"{phase}: the grid was not refreshed from the cells' opacity: {cells}")
    check(all(math.isfinite(metrics[k]) for k in ("psnr", "ssim", "chamfer_l1"))
          and metrics["num_images"] == CLI_FINAL_IMAGES, f"{phase}: final evaluation {metrics}")
    log(phase, f"main: {main_s:.1f} s; {TRAIN_STEPS} steps of {rays} rays, steps {CHECK_STEPS}-"
        f"{TRAIN_STEPS - 1}: {step_ms:.2f} ms a step, {rays / step_ms * 1e3:.0f} rays/s; the grid's "
        f"occupied cells of {res}^3 after each step {cells}, inv_s "
        f"{float(model.field.get_inv_s()):.4g}; final eval {json.dumps(metrics)} "
        f"({finals[0]['seconds']:.1f} s)")

    # the refresh alone, and the share of a batch's rays that the armed fine grid shells
    state = trainer.model_state
    refresh_ms = cuda_time_ms(lambda: model.update_model_state(state, trainer.step,
                                                               trainer.generator), 1, 0)
    gen = torch.Generator(device=dm.device).manual_seed(777)
    idx, _ = dm.sample_train_batch(gen)
    bundle = model.apply_collider(dm.generate_rays(idx), train=True)
    shell_share = None
    if heritage:
        coarse = model.coarse_grid()
        nears, fars, _ = grid_near_far(bundle, coarse, num_probes=model.config.coarse_probe_steps)
        _, _, hit = grid_near_far(bundle.replace(nears=nears, fars=fars), state,
                                  num_probes=model.config.coarse_probe_steps,
                                  first_hit_shell=model.config.fine_shell_margin)
        shell_share = float(hit.float().mean())
        check(shell_share > 0, f"{phase}: no ray of a batch enters the armed fine grid's shell")
    log(phase, f"the refresh of the {res}^3 grid: {refresh_ms:.2f} ms; rays in the fine shell "
        f"{shell_share}")

    # one step twice from the same state and batch: the kernels, then the plain versions.
    # neus-acc's grid is held full at this inv_s; the step runs on a grid refreshed at
    # inv_s = e^6 instead, which prunes, so that ``alpha *= valid`` masks samples
    sched = model.schedules(trainer.step)
    step_state, pruned = trainer.model_state, None
    if not heritage:
        deviation = model.field.deviation.detach().clone()
        with uncounted(fm), torch.no_grad():
            model.field.deviation.fill_(0.6)
            step_state = model.update_model_state(step_state, trainer.step, None)
            model.field.deviation.copy_(deviation)
        pruned = int(step_state.binary.sum())
        log(phase, f"the grid refreshed at inv_s = e^6 for the step: {pruned} of {res ** 3} cells")
        check(0 < pruned < res ** 3, f"{phase}: the sharper refresh occupies {pruned} of {res ** 3} cells")

    def one_step():
        g = torch.Generator(device=dm.device).manual_seed(777)
        i, b = dm.sample_train_batch(g)
        total_, ld, _ = loss_and_metrics(model, dm.generate_rays(i), b, sched, g,
                                         model_state=step_state)
        return {k: float(v.detach()) for k, v in ld.items()}, grads_of(trainer, total_)

    step = step_vs_plain(fm, phase, one_step, model=model, carry_choices=True)
    calls, hash_calls = step["calls"], step["hash_calls"]
    loss_err, grad_err = step["loss_err"], step["grad_err"]
    del step, step_state
    names = GRID_CHAINS if heritage else SURFACE_CHAINS
    widths = [_chain_key(c) for c in calls]
    check(sorted(widths) == sorted(names) and all("g" in c for c in calls),
          f"{phase}: expected a call with a backward on each chain {sorted(names)}, captured {widths}")
    check(len(hash_calls) == (1 if heritage else 0)
          and all(r["F"] == 2 and not r["want_jac"] and "g_out" in r for r in hash_calls),
          f"{phase}: captured hash calls {[(r['F'], r['x'].shape[0]) for r in hash_calls]}")

    # exact launches: the steps (the refreshes launch none: the SDF has no grid feature), the final eval
    final_chunks = CLI_FINAL_IMAGES * math.ceil(IMAGE * IMAGE / EVAL_CHUNK)
    train_launches = _minus(total, finals[0]["launches"])
    launches = {
        "train": launches_held(phase, "train", train_launches,
                               expected_launches(calls, hash_calls, TRAIN_STEPS, 0, 0)),
        "final_eval": launches_held(phase, "final eval", finals[0]["launches"],
                                    expected_launches(calls, hash_calls, 0, 0, final_chunks)),
    }
    log(phase, f"launches, exact: {json.dumps(launches)}")
    chains = chain_checks(fm, calls, [names[w] for w in widths], phase, method)
    hash_rec = None
    if method == "neusW":
        r = hash_calls[0]
        with uncounted(fm):
            hash_rec = hash_case(phase, "background", "captured", r["x"], r["spec"], r["rows"], 2,
                                 False, r["g_out"], None)
    del calls, hash_calls

    # one traced step without a refresh (timed above): the sampler's host span
    # against its kernels, the idle share
    with uncounted(fm):
        while trainer.step % model.model_state_update_every == 0:
            trainer.train_step()
        profile = traced_step(trainer)
    traced_ms = profile["traced_wall_ms"]
    log(phase.replace("[", "_profile["), json.dumps({"train_step": profile}))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    del trainer, model, made
    torch.cuda.empty_cache()
    return {"method": method, "rays": rays, "step_ms": step_ms, "rays_per_s": rays / step_ms * 1e3,
            "main_s": main_s, "final_eval": metrics, "final_eval_s": finals[0]["seconds"],
            "occupied_cells": cells, "grid_resolution": res, "step_grid_cells": pruned,
            "refresh_ms": refresh_ms,
            "shell_share": shell_share, "launches": launches, "total_launches": total[0],
            "step_loss_err": loss_err, "step_grad_err": grad_err, "chains": chains,
            "chain_names": names, "hash_background": hash_rec,
            "train_step_idle_share": profile["device_idle_share"], "traced_step_ms": traced_ms,
            "device_busy_ms": profile["device_busy_ms"], "ranges": profile["ranges"],
            "peak_memory_gib": peak_gib}


def facto_angelo_phase(fm, smi: str) -> dict:
    """``neus-facto-angelo`` (``surface[neus-facto-angelo]``) at full width:
    the F = 8 SDF grid over 2^22 rows a level with numerical gradients, the
    appearance embedding live in the colour chain, the hash proposals at F =
    2, and the ``"grid"`` background (F = 2, its ``mlp_base`` chain [32 -> 64
    -> 16] on the 48 in-sphere samples' merge and the 32 outside samples), at
    its 2048 rays on the committed scene: ``TRAIN_STEPS`` steps through
    ``Trainer.train``; the kernel step against the plain step (fused-MLP and
    hash-grid kernels swapped) with ``angelo_tols`` at the step's delta;
    launches by kernel and by chain exact (from the captured step; a
    proposal net's backward on update steps only), and the hash kernels'
    by width (F = 8 and F = 2) as counted; the colour and background chains alone; one traced step;
    and the 384x384 view rendered with the kernels and without. Returns
    what the ``kernels`` line reports."""
    from sdfstudio_tpu_torch.engine.trainer import loss_and_metrics
    from sdfstudio_tpu_torch.scripts.train import setup_method_trainer

    method, phase = "neus-facto-angelo", "surface[neus-facto-angelo]"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    trainer = setup_method_trainer(method, SCENE, max_num_iterations=TRAIN_STEPS, device="cuda")
    dm, model = trainer.datamanager, trainer.model
    rays = dm.config.train_num_rays_per_batch
    torch.cuda.synchronize()
    log(phase, f"{sum(p.numel() for p in model.parameters())} parameters, table "
        f"{tuple(model.field.encoding.hash_table.shape)}, groups "
        f"{ {g: o.kind for g, o in trainer.optimizers.items()} }, {rays} rays a step; set up in "
        f"{time.perf_counter() - t:.2f} s")
    check(rays == TRAIN_RAYS and type(model.field_background).__name__ == "NerfactoField"
          and model.field.config.use_appearance_embedding, f"{phase}: not the registered entry")
    fm.reset_launch_counts()
    trainer.train(CHECK_STEPS)
    torch.cuda.synchronize()
    t = time.perf_counter()
    last = trainer.train(TRAIN_STEPS)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3 / (TRAIN_STEPS - CHECK_STEPS)
    train_total, train_widths = _counts(fm), width_counts(fm)
    check(trainer.step == TRAIN_STEPS and all(math.isfinite(v) for v in last.values()),
          f"{phase}: step {trainer.step}, losses {last}")
    check(last["curvature_loss"] > 0, f"{phase}: no curvature term at step {TRAIN_STEPS}")

    sched = model.schedules(trainer.step)
    delta = sched["numerical_delta"]
    tol1, tol2 = angelo_tols(delta)

    def one_step():
        g = torch.Generator(device=dm.device).manual_seed(777)
        i, b = dm.sample_train_batch(g)
        total_, ld, _ = loss_and_metrics(model, dm.generate_rays(i), b, sched, g)
        return {k: float(v.detach()) for k, v in ld.items()}, grads_of(trainer, total_)

    log(phase, f"the kernel step vs the plain step at step {trainer.step}: delta {delta:.6g}, "
        f"tol {tol1:.3g} / {tol2:.3g} (the curvature loss and the gradients)")
    step = step_vs_plain(fm, phase, one_step, loss_tol=lambda k: tol2 if k == "curvature_loss" else tol1,
                         grad_tol=tol2, shared_samples=True, merge_radius=1.0, model=model,
                         carry_choices=True)
    calls, hash_calls = step["calls"], step["hash_calls"]
    loss_err, grad_err = step["loss_err"], step["grad_err"]
    del step
    by_F = {}
    for r in hash_calls:
        by_F.setdefault(r["F"], []).append(r)
    check(len(by_F.get(8, [])) == 1 and len(by_F.get(2, [])) == 4,
          f"{phase}: captured hash calls {[(r['F'], r['x'].shape[0]) for r in hash_calls]}")

    proposal_chains = frozenset(tuple([net.mlp.layers[0].kernel.shape[0]]
                                      + [l.kernel.shape[1] for l in net.mlp.layers])
                                for net in model.proposal_networks)
    proposal_specs = [net.encoding.spec for net in model.proposal_networks]
    n_update = sum(bool(model.schedules(i)["train_proposal"]) for i in range(TRAIN_STEPS))
    train_want = expected_launches(calls, hash_calls, TRAIN_STEPS, n_update, 0, proposal_chains,
                                   proposal_specs)
    launches = {"train": launches_held(phase, "train", train_total, train_want)}
    # by width, as counted: the SDF's F = 8 call a step with its backward, the rest at F = 2
    f8_want = {"hash_encode_fwd[F=8]": TRAIN_STEPS, "hash_encode_bwd[F=8]": TRAIN_STEPS}
    f2_want = {f"hash_encode_{w}[F=2]": train_want[0][f"hash_encode_{w}"] - TRAIN_STEPS
               for w in ("fwd", "bwd")}
    check(train_widths == {**f8_want, **f2_want},
          f"{phase}: hash launches by width {train_widths}, expected {f8_want} and {f2_want}")
    log(phase, f"Trainer.train, steps {CHECK_STEPS}-{TRAIN_STEPS - 1}: {step_ms:.2f} ms a step, "
        f"{rays / step_ms * 1e3:.0f} rays/s; losses at step {TRAIN_STEPS}: {json.dumps(last)}; "
        f"launches, exact: {json.dumps(launches)}; hash launches by width {json.dumps(train_widths)}, "
        f"{n_update} update steps")
    # the colour chain and the background's two calls: first the merge on the
    # in-sphere samples (neus_facto.py:216-219), then the 32 samples beyond far
    mine = [c for c in calls if GRID_CHAINS.get(_chain_key(c))]
    names = [GRID_CHAINS[_chain_key(c)] for c in mine]
    check(sorted(names) == ["background_base", "background_base", "color"] and all("g" in c for c in mine),
          f"{phase}: captured chains {[_chain_key(c) for c in calls]}")
    names[names.index("background_base")] = "background_base_merge"
    chains = chain_checks(fm, mine, names, phase, method)
    chunk_chains = {}
    for c in calls:
        chunk_chains[_chain_key(c)] = chunk_chains.get(_chain_key(c), 0) + 1
    del calls, hash_calls
    torch.cuda.empty_cache()

    with uncounted(fm):
        profile = traced_step(trainer)
    traced_ms = profile["traced_wall_ms"]
    log(phase.replace("surface", "surface_profile"), json.dumps({"train_step": profile}))
    render = render_view(fm, model, dm.train_cameras, trainer.step, phase, lambda: _both_plain(fm),
                         chunk_chains)
    n_chunks = math.ceil(IMAGE * IMAGE / 1024)
    check(render["widths"] == {"hash_encode_fwd[F=8]": n_chunks, "hash_encode_fwd[F=2]": 4 * n_chunks},
          f"{phase}: expected 5 hash forwards a chunk (the SDF's at F = 8; two proposals' and two "
          f"background's at F = 2): {render['widths']}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    del trainer, model
    torch.cuda.empty_cache()
    return {"method": method, "rays": rays, "step_ms": step_ms, "rays_per_s": rays / step_ms * 1e3,
            "loss_last": last, "launches": launches, "train_launches": train_total[0],
            "render_launches": render["launches"], "render_chains": render["chains"],
            "image_ms": render["image_ms"],
            "hash_launches_by_width": {"train": train_widths, "render": render["widths"]},
            "step_loss_err": loss_err, "step_grad_err": grad_err, "delta": delta, "tols": [tol1, tol2],
            "chains": chains, "render_err": render["err"],
            "render_quantile_err": render["quantile_err"],
            "train_step_idle_share": profile["device_idle_share"], "traced_step_ms": traced_ms,
            "device_busy_ms": profile["device_busy_ms"], "ranges": profile["ranges"],
            "render_idle_share": render["profile"]["device_idle_share"], "peak_memory_gib": peak_gib}


def baked_phase(fm, smi: str, method: str) -> dict:
    """A BakedSDF entry (``baked[<method>]``) at its registered values and
    full width through JAX's command line, ``<method> mipnerf360-data --data
    .parity/heritage_like --train-split-percentage 0.97`` (one eval view),
    from seed 0: ``BAKED_STEPS`` steps at the registered rays (ms a step over steps ``BAKED_TIMED``-19, host clock
    ended by one synchronise; ``bakedsdf-mlp`` at the largest power of two
    up to its 4096 that fits the card, the cut printed); one kernel step
    against one plain step, and the plain step on the kernel step's
    resamplings (``step_vs_plain``; ``bakedangelo``'s tolerances scaled by
    delta, ``angelo_tols``); launches by kernel and by chain exact in the
    steps (every step trains the proposal nets, as in JAX), ``eval.py``'s
    view and ``extract_mesh.py``'s 64^3 grid; every chain of the step
    alone (``chain_checks``); one traced step; the peak device memory; the
    train view rendered with and without the kernels; finite PSNR and SSIM
    and a non-empty mesh (no Chamfer: the heritage judge works in the
    heritage parser's frame, not this parser's). Returns what the
    ``kernels`` line reports."""
    from sdfstudio_tpu_torch.engine.trainer import loss_and_metrics
    from sdfstudio_tpu_torch.scripts import eval as eval_script
    from sdfstudio_tpu_torch.scripts import extract_mesh as mesh_script
    from sdfstudio_tpu_torch.scripts import train as train_script
    from sdfstudio_tpu_torch.utils.marching_cubes import evaluate_sdf_grid

    phase = f"baked[{method}]"
    registered = train_script.get_method_config(method).datamanager.train_num_rays_per_batch
    setup = train_script.setup_lib.setup_trainer
    made, marks = [], {}

    def keep(*args, **kw):
        """The trainer ``main`` builds, its steps ``BAKED_TIMED`` and ``BAKED_STEPS`` marked."""
        t = setup(*args, **kw)
        step = t.train_step

        def marked_step():
            if t.step == BAKED_TIMED:
                torch.cuda.synchronize()
                marks["t0"] = time.perf_counter()
            out = step()
            if t.step == BAKED_STEPS:
                torch.cuda.synchronize()
                marks["t1"] = time.perf_counter()
            return out

        t.train_step = marked_step
        made.append(t)
        return t

    with tempfile.TemporaryDirectory() as tmp:
        rays, cut = registered, None
        while True:
            argv = [method, "--experiment-name", "smoke", "--output-dir", tmp, "--timestamp", "t",
                    "--vis", "none", "--trainer.max-num-iterations", str(BAKED_STEPS),
                    "--trainer.steps-per-eval-image", "0",
                    "--datamanager.train-num-rays-per-batch", str(rays),
                    "mipnerf360-data", "--data", HERITAGE_SCENE,
                    "--train-split-percentage", str(BAKED_TRAIN_SPLIT)]
            made.clear()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            fm.reset_launch_counts()
            train_script.setup_lib.setup_trainer = keep
            t = time.perf_counter()
            try:
                check(train_script.main(argv) == 0, f"{phase}: the train command failed")
                break
            except torch.cuda.OutOfMemoryError as e:
                # the registered batch must not be cut silently: the cut is printed and reported
                check(method == "bakedsdf-mlp" and rays > 512, f"{phase}: out of memory at {rays} rays")
                cut = {"registered": registered, "out_of_memory_at": rays, "error": str(e)[:200]}
                rays //= 2
                log(phase, f"CUT: {registered} rays a step do not fit the card; trying {rays}")
            finally:
                train_script.setup_lib.setup_trainer = setup
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t
        train_total, train_widths = _counts(fm), width_counts(fm)
        trainer = made[0]
        dm, model = trainer.datamanager, trainer.model
        check(dm.config.train_num_rays_per_batch == rays and trainer.step == BAKED_STEPS,
              f"{phase}: {dm.config.train_num_rays_per_batch} rays, step {trainer.step}")
        check(model.scene_box.collider_type == "near_far" and model.scene_box.far == 1000.0
              and dm.num_eval_images == BAKED_EVAL_VIEWS,
              f"{phase}: not the mipnerf360 parser's scene and split")
        step_ms = (marks["t1"] - marks["t0"]) * 1e3 / (BAKED_STEPS - BAKED_TIMED)
        run = Path(tmp) / "smoke" / method / "t"
        w0, c0, t = width_counts(fm), _counts(fm), time.perf_counter()
        check(eval_script.main(["--load-config", str(run / "config.yml"),
                                "--output-path", f"{tmp}/eval.json"]) == 0, f"{phase}: eval.py failed")
        torch.cuda.synchronize()
        eval_s, eval_launches = time.perf_counter() - t, _minus(_counts(fm), c0)
        ev = json.loads((Path(tmp) / "eval.json").read_text())
        check(ev["num_images"] == BAKED_EVAL_VIEWS
              and all(math.isfinite(ev["results"][k]) for k in ("psnr", "ssim")),
              f"{phase}: eval.py wrote {ev}")
        c0, t = _counts(fm), time.perf_counter()
        check(mesh_script.main(["--load-config", str(run / "config.yml"), "--output-path",
                                f"{tmp}/mesh.ply", "--resolution", str(CLI_MESH_RES)]) == 0,
              f"{phase}: extract_mesh.py failed")
        torch.cuda.synchronize()
        mesh_s, mesh_launches = time.perf_counter() - t, _minus(_counts(fm), c0)
        header = (Path(tmp) / "mesh.ply").read_bytes()[:400].split(b"end_header")[0].decode()
        mesh_vertices = int(header.split("element vertex ")[1].split()[0])
        w1 = width_counts(fm)
        # the trained SDF on extract_mesh.py's grid: the mesh is empty exactly when it keeps one sign
        with uncounted(fm):
            grid = evaluate_sdf_grid(lambda p: model.field.sdf(model.field.contract_positions(p)),
                                     CLI_MESH_RES, np.full(3, -1.0), np.full(3, 1.0), dm.device)
        sdf_range = (float(grid.min()), float(grid.max()))
        del grid
        check((mesh_vertices > 0) == (sdf_range[0] < 0.0 < sdf_range[1]),
              f"{phase}: extract_mesh.py wrote {mesh_vertices} vertices of an SDF in {sdf_range}")
        eval_mesh_widths = {k: n - w0.get(k, 0) for k, n in w1.items() if n - w0.get(k, 0)}
    log(phase, f"main: {main_s:.1f} s; {BAKED_STEPS} steps of {rays} rays (registered {registered}"
        f"{'' if cut is None else ', CUT: ' + json.dumps(cut)}), steps {BAKED_TIMED}-{BAKED_STEPS - 1}: "
        f"{step_ms:.2f} ms a step, {rays / step_ms * 1e3:.0f} rays/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; eval.py {eval_s:.1f} s "
        f"{json.dumps(ev['results'])}; extract_mesh.py {mesh_s:.1f} s, {mesh_vertices} vertices of "
        f"the SDF in {sdf_range} on its {CLI_MESH_RES}^3 grid")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    # one step twice from the same state and batch, and once more on the kernel step's resamplings
    sched = model.schedules(trainer.step)
    tols = {}
    if "numerical_delta" in sched:
        tol1, tol2 = angelo_tols(sched["numerical_delta"])
        tols = {"loss_tol": lambda k: tol2 if k == "curvature_loss" else tol1, "grad_tol": tol2}

    def one_step():
        g = torch.Generator(device=dm.device).manual_seed(777)
        i, b = dm.sample_train_batch(g)
        total_, ld, _ = loss_and_metrics(model, dm.generate_rays(i), b, sched, g)
        return {k: float(v.detach()) for k, v in ld.items()}, grads_of(trainer, total_)

    merge = 1.0 if model.field_background is not None else None
    step = step_vs_plain(fm, phase, one_step, shared_samples=True, merge_radius=merge,
                         only_well_posed=True, model=model, carry_choices=True, **tols)
    calls, hash_calls = step["calls"], step["hash_calls"]
    errs = {k: step[k] for k in ("loss_err", "grad_err", "shared_loss_err", "shared_grad_err",
                                 "parted", "well_posed", "free_held")}
    del step
    widths = [_chain_key(c) for c in calls]
    check(all(w in BAKED_CHAINS for w in widths) and all("g" in c for c in calls)
          and widths.count("10-16-1") == 2,
          f"{phase}: captured chains {widths}, each with a backward")
    by_F = {}
    for r in hash_calls:
        by_F.setdefault(r["F"], []).append(r)
    want_F = {"bakedsdf": {2: 3}, "bakedsdf-mlp": {2: 2}, "bakedangelo": {8: 1, 2: 4}}[method]
    check({F: len(v) for F, v in by_F.items()} == want_F,
          f"{phase}: captured hash calls {[(r['F'], r['x'].shape[0]) for r in hash_calls]}")

    # exact launches: every step trains the proposal nets (JAX's BakedSDF has no cadence)
    image_chunks = math.ceil(IMAGE * IMAGE / 1024)
    sdf_hash = model.field.encoding is not None
    mesh_chunks = math.ceil(CLI_MESH_RES ** 3 / 131072) if sdf_hash else 0
    eval_want = expected_launches(calls, hash_calls, 0, 0, BAKED_EVAL_VIEWS * image_chunks)
    mesh_want = ({"fused_mlp_fwd": 0, "fused_mlp_bwd": 0, "hash_encode_fwd": mesh_chunks,
                  "hash_encode_bwd": 0}, {})
    launches = {
        "train": launches_held(phase, "train", train_total,
                               expected_launches(calls, hash_calls, BAKED_STEPS, BAKED_STEPS, 0)),
        "eval_py": launches_held(phase, "eval.py", eval_launches, eval_want),
        "extract_mesh": launches_held(phase, "extract_mesh.py", mesh_launches, mesh_want),
    }
    if method == "bakedangelo":
        f8 = {"hash_encode_fwd[F=8]": BAKED_STEPS, "hash_encode_bwd[F=8]": BAKED_STEPS}
        f2 = {f"hash_encode_{w}[F=2]": launches["train"]["kernels"][f"hash_encode_{w}"] - BAKED_STEPS
              for w in ("fwd", "bwd")}
        check(train_widths == {**f8, **f2}, f"{phase}: hash launches by width {train_widths}")
    log(phase, f"launches, exact: {json.dumps(launches)}; hash launches by width "
        f"{json.dumps(train_widths)}")
    names = [BAKED_CHAINS[w] for w in widths]
    for i in [i for i, n in enumerate(names) if n == "proposal"][:2]:
        names[i] = f"proposal_{sum(1 for n in names[:i] if n.startswith('proposal'))}"
    if names.count("background_base") == 2:
        names[names.index("background_base")] = "background_base_merge"
    chains = chain_checks(fm, calls, names, phase, method)
    chunk_chains = {}
    for w in widths:
        chunk_chains[w] = chunk_chains.get(w, 0) + 1
    f8_call = by_F[8][0] if method == "bakedangelo" else None
    del calls, hash_calls, by_F
    torch.cuda.empty_cache()

    with uncounted(fm):
        profile = traced_step(trainer)
    log(phase.replace("[", "_profile["), json.dumps({"train_step": profile}))
    render = None
    if method in BAKED_RENDER:
        render = render_view(fm, model, dm.train_cameras, trainer.step, phase,
                             lambda: _both_plain(fm), chunk_chains)
    del trainer, model, made, dm
    torch.cuda.empty_cache()
    sdf_hash_rec = None
    if f8_call is not None:
        # the F = 8 kernels at 2.75M points, as a step takes them, once the trainer's ~10 GB
        # are free: the plain backward and the deterministic pair need ~50 GB here
        r = f8_call
        with uncounted(fm):
            sdf_hash_rec = hash_case(phase, "sdf", "captured", r["x"], r["spec"], r["rows"], 8,
                                     r["want_jac"], r.get("g_out"), r.get("g_jac"))
        del r, f8_call
    return {"method": method, "rays": rays, "registered_rays": registered, "cut": cut,
            "step_ms": step_ms, "rays_per_s": rays / step_ms * 1e3, "main_s": main_s,
            "eval_py_s": eval_s, "eval_py": ev["results"], "extract_mesh_s": mesh_s,
            "mesh_vertices": mesh_vertices, "sdf_range": sdf_range, "launches": launches,
            "train_launches": train_total[0],
            "eval_launches": eval_launches[0], "mesh_launches": mesh_launches[0],
            "hash_launches_by_width": {"train": train_widths, "eval_and_mesh": eval_mesh_widths,
                                       "render": {} if render is None else render["widths"]},
            "chains": chains, "sdf_hash": sdf_hash_rec,
            **{f"step_{k}": v for k, v in errs.items()},
            "train_step_idle_share": profile["device_idle_share"],
            "traced_step_ms": profile["traced_wall_ms"], "device_busy_ms": profile["device_busy_ms"],
            "ranges": profile["ranges"], "peak_memory_gib": peak_gib,
            "image_ms": None if render is None else render["image_ms"],
            "render_launches": None if render is None else render["launches"],
            "render_chains_fwd": {} if render is None else render["chains"]["fwd"],
            "render_quantile_err": None if render is None else render["quantile_err"],
            "render_idle_share": None if render is None else render["profile"]["device_idle_share"]}


def hash_grad_x_case(phase: str, name: str, x, table, spec, g_out) -> dict:
    """The hash encode's gradient in ``x`` on one captured call: the kernel
    node (the forward kernel with its jacobian, then ``g_out . jac``)
    against the plain encode under autograd, held to ``GRAD_X_TOL`` of the
    plain gradient's largest entry; timed beside the call's forward (with
    and without the jacobian) and its table backward, the contraction
    alone with its bytes bound."""
    from sdfstudio_tpu_torch.ops import hash_grid as hg

    n, LF = x.shape[0], g_out.shape[1]
    R = table.shape[0]
    xg = x.detach().requires_grad_(True)

    def kernel():
        return torch.autograd.grad(hg.hash_encode(xg, table, spec), xg, g_out)[0]

    def plain():
        return torch.autograd.grad(hg.hash_encode_plain(xg, table, spec), xg, g_out)[0]

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)
    jac = hg.hash_encode_fwd(x, table, spec, True)[1]
    g3 = g_out.reshape(n, 1, LF)
    contraction_bytes = 4.0 * n * (LF * 3 + LF + 3)
    rec = {"call": name, "points": n, "F": table.shape[1], "levels": spec.num_levels,
           "max_rel_err": err, "rel_fro_err": rel_fro(got, want),
           "ms": cuda_time_ms(kernel, 10), "plain_ms": cuda_time_ms(plain, 3, 1),
           "contraction_ms": cuda_time_many_ms(lambda: torch.bmm(g3, jac)[:, 0], 20),
           "contraction_bound_ms": contraction_bytes / HBM_RATE * 1e3,
           "fwd_ms": cuda_time_many_ms(lambda: hg.hash_encode_fwd(x, table, spec, False), 20),
           "fwd_jac_ms": cuda_time_many_ms(lambda: hg.hash_encode_fwd(x, table, spec, True), 20),
           "table_bwd_ms": cuda_time_many_ms(lambda: hg.hash_encode_bwd(x, g_out, None, spec, R), 20)}
    log(phase, f"grad_x {json.dumps(rec)}")
    check(err <= GRAD_X_TOL, f"{phase} {name}: the hash node's grad_x vs plain {err} > {GRAD_X_TOL}")
    del xg, got, want, jac, g3
    torch.cuda.empty_cache()
    return rec


def density_phase(fm, smi: str, method: str) -> dict:
    """A density method (``density[<method>]``) at its registered values
    and full width through JAX's command line: ``instant-ngp`` and
    ``nerfacto`` on the committed DTU-like scene through ``sdfstudio-data``
    (the eval split every ``CLI_EVAL_SPLIT``-th view), ``phototourism``
    through ``phototourism-data`` on the heritage-like scene, from seed 0.
    ``nerfacto`` and ``phototourism`` train 20 steps of 4096 rays with the
    ``SO3xR3`` camera optimizer (the sample positions take a gradient in the
    pose table through the hash encode); ``instant-ngp`` 30 steps of its
    dynamic batch (from ``2^18 / 256`` rays, moved every
    ``NGP_UPDATE_EVERY`` steps on the measured samples; every bucket, each
    refresh's occupied cells and the samples a ray printed, and each move
    held to the rule). The ms a step over steps ``DENSITY_TIMED`` to the
    last (host clock ended by one synchronise), rays/s, the peak device
    memory; one kernel step against one plain step (for the proposal
    methods also on the kernel step's resamplings, ``step_vs_plain(
    shared_samples=True)``, the free comparison held where it is well
    posed, as in the baked phases), ``camera_opt``'s gradient included; launches
    by kernel and by chain exact in the steps (the proposal nets'
    backward on their update steps only; the grid refreshes' chunks) and
    in ``eval.py``'s views; ``extract_mesh.py`` refusing a density model
    (``nerfacto``); every chain of the step alone (``chain_checks``); for
    ``nerfacto`` the hash node's gradient in ``x`` on the step's captured
    field call at F = 2 and on an F = 4 table (``hash_grad_x_case``); one
    traced step. Returns what the ``kernels`` line reports."""
    from sdfstudio_tpu_torch.engine.trainer import loss_and_metrics, to_bucket
    from sdfstudio_tpu_torch.models.neuralreconW import REFRESH_CHUNK
    from sdfstudio_tpu_torch.scripts import eval as eval_script
    from sdfstudio_tpu_torch.scripts import extract_mesh as mesh_script
    from sdfstudio_tpu_torch.scripts import train as train_script
    from sdfstudio_tpu_torch.scripts.benchmarking import hash_grid_designs as hgd

    phase = f"density[{method}]"
    ngp, steps = method == "instant-ngp", DENSITY_STEPS[method]
    setup = train_script.setup_lib.setup_trainer
    made, marks, vecs, buckets, refreshes = [], {}, [], [], []

    def keep(*args, **kw):
        """The trainer ``main`` builds: each step's bucket and metrics kept,
        steps ``DENSITY_TIMED`` and the last marked, each refresh's occupied
        cells kept (device scalars, read after the run)."""
        t = setup(*args, **kw)
        step = t.train_step

        def marked_step():
            if t.step == DENSITY_TIMED:
                torch.cuda.synchronize()
                marks["t0"] = time.perf_counter()
            buckets.append(t.num_rays_per_batch())
            vecs.append(step())
            if t.step == steps:
                torch.cuda.synchronize()
                marks["t1"] = time.perf_counter()
            return vecs[-1]

        t.train_step = marked_step
        if ngp:
            update = t.model.update_model_state

            def counted_update(state, step_, rng=None):
                new = update(state, step_, rng)
                refreshes.append((step_, new.binary.sum()))
                return new

            t.model.update_model_state = counted_update
        made.append(t)
        return t

    with tempfile.TemporaryDirectory() as tmp:
        argv = [method, "--experiment-name", "smoke", "--output-dir", tmp, "--timestamp", "t",
                "--vis", "none", "--trainer.max-num-iterations", str(steps),
                "--trainer.steps-per-eval-image", "0"]
        if ngp:
            argv += ["--trainer.steps-per-log", str(NGP_UPDATE_EVERY),
                     "--trainer.dynamic-update-every", str(NGP_UPDATE_EVERY)]
        argv += (["phototourism-data", "--data", HERITAGE_SCENE] if method == "phototourism" else
                 ["sdfstudio-data", "--data", SCENE, "--skip-every-for-val-split", str(CLI_EVAL_SPLIT)])
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        fm.reset_launch_counts()
        train_script.setup_lib.setup_trainer = keep
        t = time.perf_counter()
        try:
            check(train_script.main(argv) == 0, f"{phase}: the train command failed")
        finally:
            train_script.setup_lib.setup_trainer = setup
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t
        train_total, train_widths = _counts(fm), width_counts(fm)
        trainer = made[0]
        dm, model = trainer.datamanager, trainer.model
        check(trainer.step == steps and len(vecs) == steps, f"{phase}: step {trainer.step}")
        step_ms = (marks["t1"] - marks["t0"]) * 1e3 / (steps - DENSITY_TIMED)
        rays_timed = sum(buckets[DENSITY_TIMED:])
        rays_per_s = rays_timed / (marks["t1"] - marks["t0"])
        rows = [dict(zip(trainer.metric_keys, v.tolist())) for v in vecs]
        check(all(math.isfinite(r["loss"]) for r in rows), f"{phase}: losses {[r['loss'] for r in rows]}")
        ngp_rec = {}
        if ngp:
            samples = [r["num_samples_per_batch"] for r in rows]
            check(buckets[0] == to_bucket((1 << 18) // 256)
                  and all(r["num_rays_per_batch"] == b for r, b in zip(rows, buckets)),
                  f"{phase}: buckets {buckets}")
            for s in range(1, steps):  # a move at a log row that crosses a multiple of the cadence
                if s % NGP_UPDATE_EVERY == 0:
                    want = to_bucket(buckets[s - 1] * (1 << 18) / max(samples[s - 1], 1.0))
                    check(buckets[s] == want, f"{phase}: step {s} bucket {buckets[s]}, the rule gives "
                          f"{want} at {samples[s - 1]} samples")
                else:
                    check(buckets[s] == buckets[s - 1], f"{phase}: bucket moved at step {s}")
            res = model.config.grid_resolution
            ngp_rec = {"buckets": buckets, "bucket_moved": len(set(buckets)) > 1,
                       "samples_per_batch": samples,
                       "samples_per_ray": [s_ / b for s_, b in zip(samples, buckets)],
                       "refreshes": [{"step": s_, "occupied": int(n), "cells": res ** 3}
                                     for s_, n in refreshes]}
            check([s_ for s_, _ in refreshes] == list(range(0, steps, 16)),
                  f"{phase}: refreshes at {[s_ for s_, _ in refreshes]}")
            log(phase, f"dynamic batch: {json.dumps(ngp_rec)}")
        else:
            pose = model.camera_opt.pose_adjustment.detach()
            check(float(pose.abs().max()) > 0, f"{phase}: the camera optimizer's table did not move")
            ngp_rec = {"pose_adjustment_max_abs": float(pose.abs().max())}
        run = Path(tmp) / "smoke" / method / "t"
        c0, t = _counts(fm), time.perf_counter()
        check(eval_script.main(["--load-config", str(run / "config.yml"),
                                "--output-path", f"{tmp}/eval.json"]) == 0, f"{phase}: eval.py failed")
        torch.cuda.synchronize()
        eval_s, eval_launches = time.perf_counter() - t, _minus(_counts(fm), c0)
        ev = json.loads((Path(tmp) / "eval.json").read_text())
        check(ev["num_images"] == dm.num_eval_images
              and all(math.isfinite(ev["results"][k]) for k in ("psnr", "ssim")),
              f"{phase}: eval.py wrote {ev}")
        refused = None
        if method == "nerfacto":  # JAX's extract_mesh reads field.sdf_fn, which a density field lacks
            try:
                mesh_script.main(["--load-config", str(run / "config.yml"), "--output-path",
                                  f"{tmp}/mesh.ply", "--resolution", "32"])
            except ValueError as e:
                refused = str(e)
            check(refused is not None and not (Path(tmp) / "mesh.ply").exists(),
                  f"{phase}: extract_mesh.py did not refuse a density model")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(phase, f"main: {main_s:.1f} s; {steps} steps (rays {sorted(set(buckets))}), steps "
        f"{DENSITY_TIMED}-{steps - 1}: {step_ms:.2f} ms a step, {rays_per_s:.0f} rays/s; peak memory "
        f"{peak_gib:.2f} GiB; eval.py {eval_s:.1f} s over {ev['num_images']} views "
        f"{json.dumps(ev['results'])}; losses first {rows[0]['loss']:.5f} last {rows[-1]['loss']:.5f}"
        + ("" if refused is None else f"; extract_mesh.py refused: {refused}"))

    # one step twice from the same state and batch (and once on the kernel step's resamplings)
    sched = model.schedules(trainer.step)

    def one_step():
        g = torch.Generator(device=dm.device).manual_seed(777)
        i, b = dm.sample_train_batch(g, num_rays=trainer.num_rays_per_batch())
        total_, ld, _ = loss_and_metrics(model, dm.generate_rays(i), b, sched, g,
                                         model_state=trainer.model_state)
        return {k: float(v.detach()) for k, v in ld.items()}, grads_of(trainer, total_)

    step = step_vs_plain(fm, phase, one_step, shared_samples=not ngp, only_well_posed=not ngp,
                         model=None if ngp else model, carry_relu=True)
    calls, hash_calls = step["calls"], step["hash_calls"]
    errs = {k: step.get(k) for k in ("loss_err", "grad_err", "shared_loss_err", "shared_grad_err",
                                     "parted")}
    check(ngp or step["grad_norm"]["camera_opt"] > 0, f"{phase}: no gradient in the pose table")
    del step
    widths = [_chain_key(c) for c in calls]
    check(widths == (["32-64-16"] if ngp else ["10-16-1", "10-16-1", "32-64-16"])
          and all("g" in c for c in calls), f"{phase}: captured chains {widths}, each with a backward")
    check([r["F"] for r in hash_calls] == [2] * len(widths) and all("g_out" in r for r in hash_calls),
          f"{phase}: captured hash calls {[(r['F'], r['x'].shape[0]) for r in hash_calls]}")

    # exact launches: the proposal nets' backward on their update steps; the refreshes' chunks
    n_update = sum(bool(model.schedules(s).get("train_proposal", True)) for s in range(steps))
    proposal_specs = [net.encoding.spec for net in getattr(model, "proposal_networks", [])]
    refresh_chunks = len(refreshes) * math.ceil(model.config.grid_resolution ** 3 / REFRESH_CHUNK) if ngp \
        else 0
    train_want = expected_launches(calls, hash_calls, steps, n_update, refresh_chunks,
                                   proposal_chains={(10, 16, 1)}, proposal_specs=proposal_specs)
    cams = dm.eval_cameras if dm.eval_cameras is not None else dm.train_cameras
    chunk = model.config.eval_num_rays_per_chunk
    eval_chunks = sum(math.ceil(int(cams.height[i]) * int(cams.width[i]) / chunk)
                      for i in range(dm.num_eval_images))
    launches = {
        "train": launches_held(phase, "train", train_total, train_want),
        "eval_py": launches_held(phase, "eval.py", eval_launches,
                                 expected_launches(calls, hash_calls, 0, 0, eval_chunks)),
    }
    check(set(train_widths) <= {"hash_encode_fwd[F=2]", "hash_encode_bwd[F=2]"},
          f"{phase}: hash launches by width {train_widths}")
    log(phase, f"launches, exact: {json.dumps(launches)}; proposal update steps {n_update} of {steps}; "
        f"refresh chunks {refresh_chunks}; eval chunks {eval_chunks}")
    names = [DENSITY_CHAINS[w] for w in widths]
    if names.count("proposal") == 2:
        names[:2] = ["proposal_0", "proposal_1"]
    chains = chain_checks(fm, calls, names, phase, method)
    grad_x = []
    if method == "nerfacto":
        field = hash_calls[-1]
        table = model.field.encoding.hash_table.detach()
        check(field["spec"] == model.field.encoding.spec, f"{phase}: the last hash call is not the field's")
        with uncounted(fm):
            grad_x.append(hash_grad_x_case(phase, "field", field["x"], table, field["spec"],
                                           field["g_out"]))
            g4 = torch.randn((field["x"].shape[0], field["spec"].num_levels * 4), device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(4))
            grad_x.append(hash_grad_x_case(phase, "field_F4", field["x"],
                                           hgd.row_table(table.shape[0], 4), field["spec"], g4))
            del g4
    del calls, hash_calls
    torch.cuda.empty_cache()
    with uncounted(fm):
        profile = traced_step(trainer)
    log(phase.replace("[", "_profile["), json.dumps({"train_step": profile}))
    del trainer, model, made, dm
    torch.cuda.empty_cache()
    return {"method": method, "steps": steps, "rays": sorted(set(buckets)), "step_ms": step_ms,
            "rays_per_s": rays_per_s, "main_s": main_s, "eval_py_s": eval_s, "eval_py": ev["results"],
            "eval_views": ev["num_images"], "launches": launches, "train_launches": train_total[0],
            "eval_launches": eval_launches[0], "hash_launches_by_width": train_widths,
            "chains": chains, "grad_x": grad_x, "extract_mesh_refused": refused,
            **{f"step_{k}": v for k, v in errs.items()}, **ngp_rec,
            "loss_first": rows[0]["loss"], "loss_last": rows[-1]["loss"],
            "train_step_idle_share": profile["device_idle_share"],
            "traced_step_ms": profile["traced_wall_ms"], "device_busy_ms": profile["device_busy_ms"],
            "ranges": profile["ranges"], "peak_memory_gib": peak_gib}


def write_nerf_scenes() -> None:
    """Start writing phase 17's scenes into a temporary directory, on a
    thread of the host while the card runs the earlier phases: the sphere in
    Blender's layout, the same with a time a frame (D-NeRF's), and in the
    Friends layout with its segmentations (``data/synthetic.py``)."""
    from sdfstudio_tpu_torch.data import synthetic

    out = Path(tempfile.mkdtemp(prefix="sst_nerf_scenes_"))

    def write() -> dict:
        t = time.perf_counter()
        kw = dict(num_images=NERF_VIEWS, width=NERF_IMAGE, height=NERF_IMAGE)
        dirs = {"blender": synthetic.generate_blender_sphere_dataset(out / "blender", **kw),
                "dnerf": synthetic.generate_blender_sphere_dataset(out / "dnerf", times=True, **kw),
                "friends": synthetic.generate_friends_sphere_dataset(
                    out / "friends", num_images=FRIENDS_VIEWS, width=NERF_IMAGE,
                    height=NERF_IMAGE * 3 // 4)}
        return {"seconds": time.perf_counter() - t, **{k: str(v) for k, v in dirs.items()}}

    pool = concurrent.futures.ThreadPoolExecutor(1)
    _NERF_SCENES.update(dir=out, pool=pool, future=pool.submit(write))


def finish_nerf_scenes() -> dict:
    info = _NERF_SCENES["future"].result(timeout=600)
    log("nerf", f"scenes written beside the card's work: {json.dumps(info)}")
    return info


def remove_nerf_scenes() -> None:
    if "pool" in _NERF_SCENES:
        _NERF_SCENES["pool"].shutdown(wait=True)
        shutil.rmtree(_NERF_SCENES["dir"], ignore_errors=True)


def tensorvm_cases(phase: str, model, one_step) -> list:
    """TensoRF's tri-plane encodes (plain PyTorch, ``sst/tensorvm_encode``)
    on one train step's inputs, recorded by running ``one_step`` once: each
    call's forward, and the backward into its planes from a seeded
    cotangent, timed with CUDA events beside the bytes bound of each (each
    input read once, each output written once: the points and the planes in,
    the features out; the backward the points and the cotangent in, the
    planes' gradient out)."""
    from sdfstudio_tpu_torch.ops import encodings as enc_ops

    calls, real = [], enc_ops.TensorVMEncoding.forward

    def recording(self, x, want_jac=False):
        calls.append((self, x.detach().clone(), torch.is_grad_enabled()))
        return real(self, x, want_jac)

    enc_ops.TensorVMEncoding.forward = recording
    try:
        one_step()
    finally:
        enc_ops.TensorVMEncoding.forward = real
    names = {id(model.encodings.density_encoding): "density", id(model.encodings.color_encoding): "color"}
    recs = []
    for enc, x, grad in calls:
        n, C, res = x.shape[0], enc.num_components, enc.resolution
        table = 4.0 * 3 * res * res * C
        g = torch.randn((n, 3 * C), device=x.device,
                        generator=torch.Generator(device=x.device).manual_seed(3))
        out = enc(x)
        fwd_ms = cuda_time_ms(lambda: enc(x), 10)
        # the uniform pass runs without a graph: no backward on the path
        bwd_ms = cuda_time_ms(lambda: torch.autograd.grad(out, enc.plane_coef, g, retain_graph=True),
                              10) if grad else None
        nbytes = 4.0 * (3 * n + 3 * C * n) + table  # the backward's: x and g in, the planes' gradient out
        flop = 3.0 * n * C * 9  # three bilinear blends of C features a plane
        rec = {"encoding": names[id(enc)], "pass": "fine" if grad else "uniform (no grad)", "points": n,
               "components": C, "resolution": res, "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
               "fwd_bound_ms": max(nbytes / HBM_RATE, flop / FP32_PEAK) * 1e3,
               "bwd_bound_ms": max(nbytes / HBM_RATE, 2 * flop / FP32_PEAK) * 1e3 if grad else None,
               "bound_by": "bytes"}
        recs.append(rec)
        log(phase, f"tensorvm_encode {json.dumps(rec)}")
        del out, g
    check([(r["encoding"], r["pass"]) for r in recs] == [("density", "uniform (no grad)"),
                                                         ("density", "fine"), ("color", "fine")],
          f"{phase}: the step's tri-plane calls {[(r['encoding'], r['pass']) for r in recs]}")
    torch.cuda.empty_cache()
    return recs


def f32_conditioning(fm, model, one_batch, sched) -> dict:
    """How far float32 itself carries one plain step: the plain versions'
    float32 step against a float64 step of a copy of the model on the same
    batch and the same PDF resamplings (``pdf_samples`` replayed), each
    group's gradient as the relative Frobenius distance, and each loss's
    relative distance. ``one_batch()`` gives the step's (rays, batch,
    generator) from a fixed seed."""
    from sdfstudio_tpu_torch.engine.trainer import loss_and_metrics

    rec = []

    def step(m, dtype):
        rb, b, g = one_batch()
        rb = rb.map(lambda t: t.to(dtype) if t.is_floating_point() else t)
        total, ld, _ = loss_and_metrics(m, rb, {k: v.to(dtype) for k, v in b.items()}, sched, g)
        names, params = zip(*m.named_parameters())
        grads = torch.autograd.grad(total, params, allow_unused=True)
        groups = {}
        for n, p, gr in zip(names, params, grads):
            groups.setdefault(n.split(".")[0], []).append(
                (gr if gr is not None else torch.zeros_like(p)).reshape(-1).double())
        return ({k: float(v) for k, v in ld.items()},
                {k: torch.cat(v) for k, v in groups.items()})

    with uncounted(fm), swap_fused_mlp(fm.fused_mlp_plain):
        with pdf_samples(rec):
            l32, g32 = step(model, torch.float32)
        m64 = copy.deepcopy(model).double()
        with pdf_samples(rec, replay=True):
            l64, g64 = step(m64, torch.float64)
    del m64
    torch.cuda.empty_cache()
    return {"grad": {k: rel_fro(g32[k], g64[k]) for k in g64},
            "loss": {k: abs(l32[k] - l64[k]) / max(abs(l64[k]), 1e-12) for k in l64}}


def nerf_phase(fm, smi: str, method: str, scenes: dict) -> dict:
    """A NeRF baseline (``nerf[<method>]``) at its registered values and full
    width through JAX's command line, from seed 0: ``vanilla-nerf``,
    ``mipnerf`` and ``tensorf`` through ``blender-data`` on the written
    sphere scene, ``dnerf`` through ``dnerf-data`` on its timed copy (the
    distortion runs; then 2 steps through ``blender-data``, where the rays
    carry no times: the distortion's launches none, its parameters unmoved,
    its RAdam count advanced), ``semantic-nerfw`` through ``friends-data``
    (4,096 rays; the segmentations written and never read). ``NERF_STEPS``
    steps at the registered rays: the ms a step over steps ``NERF_TIMED`` on
    (host clock ended by one synchronise), rays/s, the peak memory; one
    ``eval.py`` pass over the eval views; the kernel step against the plain
    step on the kernel step's resamplings (and the free comparison where it
    is well posed, ``step_vs_plain``); launches exact by kernel and by
    chain (semantic-nerfw's transient chain in training only, its
    proposals' backward on their update steps); every chain of the step
    alone (``chain_checks``; the semantic chain, which no loss reaches
    without labels, on a seeded cotangent); for ``tensorf`` the tri-plane
    encodes alone (``tensorvm_cases``); one traced step."""
    from sdfstudio_tpu_torch.engine.trainer import loss_and_metrics
    from sdfstudio_tpu_torch.scripts import eval as eval_script
    from sdfstudio_tpu_torch.scripts import train as train_script

    phase = f"nerf[{method}]"
    parser, scene_key = NERF_PARSERS.get(method, ("blender-data", "blender"))
    setup = train_script.setup_lib.setup_trainer
    made, marks, vecs, initial = [], {}, [], []

    def keep(*args, **kw):
        """The trainer ``main`` builds, steps ``NERF_TIMED`` and the last
        marked, the distortion's parameters kept as they start."""
        t = setup(*args, **kw)
        initial.append({n: p.detach().clone() for n, p in t.model.named_parameters()
                        if n.startswith("temporal_distortion")})
        step = t.train_step

        def marked_step():
            if t.step == NERF_TIMED:
                torch.cuda.synchronize()
                marks["t0"] = time.perf_counter()
            vecs.append(step())
            if t.step == NERF_STEPS:
                torch.cuda.synchronize()
                marks["t1"] = time.perf_counter()
            return vecs[-1]

        t.train_step = marked_step
        made.append(t)
        return t

    def run(argv):
        train_script.setup_lib.setup_trainer = keep
        try:
            check(train_script.main(argv) == 0, f"{phase}: the train command failed: {argv}")
        finally:
            train_script.setup_lib.setup_trainer = setup

    with tempfile.TemporaryDirectory() as tmp:
        argv = [method, "--experiment-name", "smoke", "--output-dir", tmp, "--timestamp", "t",
                "--vis", "none", "--trainer.max-num-iterations", str(NERF_STEPS),
                "--trainer.steps-per-eval-image", "0", parser, "--data", scenes[scene_key]]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        fm.reset_launch_counts()
        t = time.perf_counter()
        run(argv)
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t
        train_total, train_widths = _counts(fm), width_counts(fm)
        trainer = made[0]
        dm, model = trainer.datamanager, trainer.model
        rays = dm.config.train_num_rays_per_batch
        check(trainer.step == NERF_STEPS and len(vecs) == NERF_STEPS, f"{phase}: step {trainer.step}")
        step_ms = (marks["t1"] - marks["t0"]) * 1e3 / (NERF_STEPS - NERF_TIMED)
        rays_per_s = rays * (NERF_STEPS - NERF_TIMED) / (marks["t1"] - marks["t0"])
        rows = [dict(zip(trainer.metric_keys, v.tolist())) for v in vecs]
        check(all(math.isfinite(r["loss"]) for r in rows), f"{phase}: losses {[r['loss'] for r in rows]}")
        extra = {}
        if method == "dnerf":  # dnerf-data: the times reach the rays, the distortion trains
            moved = [n for n, p in model.named_parameters()
                     if n in initial[0] and not torch.equal(p, initial[0][n])]
            check(dm.train_cameras.times is not None and dm.eval_cameras.times is not None
                  and len(moved) == len(initial[0]) == 8,
                  f"{phase}: dnerf-data's times or the distortion's training ({moved})")
        if method == "semantic-nerfw":  # JAX's data manager reads no segmentation, nor does the port's
            sem = Path(scenes["friends"]) / "segmentations" / "thing"
            check(set(dm.train_data) == {"image"} and len(list(sem.glob("*.png"))) == FRIENDS_VIEWS,
                  f"{phase}: the batch keys {sorted(dm.train_data)}")
            extra["segmentations_written_unread"] = len(list(sem.glob("*.png")))
        run_dir = Path(tmp) / "smoke" / method / "t"
        c0, t = _counts(fm), time.perf_counter()
        check(eval_script.main(["--load-config", str(run_dir / "config.yml"),
                                "--output-path", f"{tmp}/eval.json"]) == 0, f"{phase}: eval.py failed")
        torch.cuda.synchronize()
        eval_s, eval_launches = time.perf_counter() - t, _minus(_counts(fm), c0)
        ev = json.loads((Path(tmp) / "eval.json").read_text())
        check(ev["num_images"] == dm.num_eval_images
              and all(math.isfinite(ev["results"][k]) for k in ("psnr", "ssim")),
              f"{phase}: eval.py wrote {ev}")
        if method == "dnerf":  # the registered blender-data: no times, the distortion skipped
            c0 = _counts(fm)
            run([method, "--output-dir", tmp, "--timestamp", "blender", "--vis", "none",
                 "--trainer.max-num-iterations", "2", "--trainer.steps-per-eval-image", "0",
                 "blender-data", "--data", scenes["blender"]])
            blender = made.pop()
            blender_launches = _minus(_counts(fm), c0)
            td = blender.optimizers["temporal_distortion"]
            unmoved = all(torch.equal(p, initial[1][n]) for n, p in blender.model.named_parameters()
                          if n in initial[1])
            check(blender.datamanager.train_cameras.times is None and td.count == 2 and unmoved
                  and float(sum(v.abs().sum() for v in td.nu)) == 0.0,
                  f"{phase}: blender-data's distortion moved or its RAdam count is {td.count}")
            extra["blender_data"] = {"launches": blender_launches, "distortion_count": td.count,
                                     "distortion_unmoved": unmoved}
            del blender
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(phase, f"main: {main_s:.1f} s; {NERF_STEPS} steps of {rays} rays, steps "
        f"{NERF_TIMED}-{NERF_STEPS - 1}: {step_ms:.2f} ms a step, {rays_per_s:.0f} rays/s; peak memory "
        f"{peak_gib:.2f} GiB ({smi}); eval.py {eval_s:.1f} s over {ev['num_images']} views "
        f"{json.dumps(ev['results'])}; losses first {rows[0]['loss']:.5f} last {rows[-1]['loss']:.5f}")

    sched = model.schedules(trainer.step)

    def one_batch():
        g = torch.Generator(device=dm.device).manual_seed(777)
        i, b = dm.sample_train_batch(g, num_rays=rays)
        return dm.generate_rays(i), b, g

    def one_step():
        rb, b, g = one_batch()
        total_, ld, _ = loss_and_metrics(model, rb, b, sched, g)
        return {k: float(v.detach()) for k, v in ld.items()}, grads_of(trainer, total_)

    # where float32 itself moves a group's gradient by more than the tolerance (D-NeRF's
    # distortion: its gradient comes through the field's 512-frequency PE, a sum with heavy
    # cancellation), the kernel step is held to twice the plain float32 step's own distance
    # from float64 on the same samples
    cond = f32_conditioning(fm, model, one_batch, sched) if method in NERF_F32_CONDITIONED else None
    group_tols = (None if cond is None else
                  {g: max(STEP_GRAD_TOL, 2.0 * e) for g, e in cond["grad"].items()})
    if cond is not None:
        log(phase, f"float32's own distance from float64 on one plain step (the same samples): "
            f"{json.dumps(cond)}; the kernel step's gradient tolerances {json.dumps(group_tols)}")
    step = step_vs_plain(fm, phase, one_step, shared_samples=True, only_well_posed=True, model=model,
                         group_tols=group_tols)
    calls, hash_calls = step["calls"], step["hash_calls"]
    errs = {k: step.get(k) for k in ("loss_err", "grad_err", "shared_loss_err", "shared_grad_err",
                                     "parted", "well_posed")}
    del step
    widths = [_chain_key(c) for c in calls]
    want = {"vanilla-nerf": ["283-128-128"] * 2, "mipnerf": ["283-128-128"] * 2,
            "dnerf": ["84-256-256-256-3", "283-128-128"] * 2, "tensorf": ["150-128-128"],
            "semantic-nerfw": ["10-16-1", "10-16-1", "32-64-16", "31-64-64", "15-64-64"]}[method]
    # every chain takes a backward but the semantic one, which no loss reaches without labels
    check(widths == want and all(("g" in c) == (k != "15-64-64") for c, k in zip(calls, widths)),
          f"{phase}: captured chains {widths}, with a backward {[('g' in c) for c in calls]}")
    check([r["F"] for r in hash_calls] == ([2, 2, 2] if method == "semantic-nerfw" else []),
          f"{phase}: captured hash calls {[(r['F'], r['x'].shape[0]) for r in hash_calls]}")

    # exact launches: the proposal nets' backward on their update steps; no transient chain at eval
    n_update = sum(bool(model.schedules(s).get("train_proposal", True)) for s in range(NERF_STEPS))
    proposal_specs = [net.encoding.spec for net in getattr(model, "proposal_networks", [])]
    train_want = expected_launches(calls, hash_calls, NERF_STEPS, n_update, 0,
                                   proposal_chains={(10, 16, 1)}, proposal_specs=proposal_specs)
    cams = dm.eval_cameras if dm.eval_cameras is not None else dm.train_cameras
    chunk = model.config.eval_num_rays_per_chunk
    eval_chunks = sum(math.ceil(int(cams.height[i]) * int(cams.width[i]) / chunk)
                      for i in range(dm.num_eval_images))
    eval_calls = [c for c, k in zip(calls, widths) if k != "31-64-64"]
    launches = {
        "train": launches_held(phase, "train", train_total, train_want),
        "eval_py": launches_held(phase, "eval.py", eval_launches,
                                 expected_launches(eval_calls, hash_calls, 0, 0, eval_chunks)),
    }
    if method == "dnerf":
        heads = [c for c, k in zip(calls, widths) if k == "283-128-128"]
        launches["blender_data"] = launches_held(phase, "blender-data", extra["blender_data"]["launches"],
                                                 expected_launches(heads, [], 2, 2, 0))
        extra["blender_data"]["launches"] = launches["blender_data"]
    check(set(train_widths) <= {"hash_encode_fwd[F=2]", "hash_encode_bwd[F=2]"},
          f"{phase}: hash launches by width {train_widths}")
    log(phase, f"launches, exact: {json.dumps(launches)}; proposal update steps {n_update} of "
        f"{NERF_STEPS}; eval chunks {eval_chunks}")
    names = [NERF_CHAINS[w] for w in widths]
    if names.count("proposal") == 2:
        names[:2] = ["proposal_0", "proposal_1"]
    if method in ("vanilla-nerf", "mipnerf", "dnerf"):  # the coarse pass's calls, then the fine's
        half = len(names) // 2
        names = [f"{n}_{'coarse' if i < half else 'fine'}" for i, n in enumerate(names)]
    for c in calls:  # the semantic chain: a seeded cotangent, for its backward held alone
        if "g" not in c:
            c["g"] = torch.randn((c["x"].shape[0], c["ws"][-1].shape[1]), device=c["x"].device,
                                 generator=torch.Generator(device=c["x"].device).manual_seed(5))
            c["g_seeded"] = True
    chains = chain_checks(fm, calls, names, phase, method)
    for rec, c in zip(chains, calls):
        rec["g_seeded"] = c.get("g_seeded", False)
    del calls, hash_calls
    tensorvm = tensorvm_cases(phase, model, one_step) if method == "tensorf" else None
    torch.cuda.empty_cache()
    with uncounted(fm):
        profile = traced_step(trainer)
    log(phase.replace("[", "_profile["), json.dumps({"train_step": profile}))
    check(method != "tensorf" or "sst/tensorvm_encode" in profile["ranges"],
          f"{phase}: no sst/tensorvm_encode range in the traced step: {sorted(profile['ranges'])}")
    del trainer, model, made, dm
    torch.cuda.empty_cache()
    return {"method": method, "parser": parser, "steps": NERF_STEPS, "rays": rays, "step_ms": step_ms,
            "f32_conditioning": cond, "group_tols": group_tols,
            "rays_per_s": rays_per_s, "main_s": main_s, "eval_py_s": eval_s, "eval_py": ev["results"],
            "eval_views": ev["num_images"], "launches": launches, "train_launches": train_total[0],
            "eval_launches": eval_launches[0], "hash_launches_by_width": train_widths,
            "chains": chains, "tensorvm": tensorvm, **extra,
            **{f"step_{k}": v for k, v in errs.items()},
            "loss_first": rows[0]["loss"], "loss_last": rows[-1]["loss"],
            "train_step_idle_share": profile["device_idle_share"],
            "traced_step_ms": profile["traced_wall_ms"], "device_busy_ms": profile["device_busy_ms"],
            "ranges": profile["ranges"], "peak_memory_gib": peak_gib}


def write_capture_scenes() -> None:
    """Start writing phase 18's scenes into a temporary directory on a host
    thread while the card runs the earlier phases (``data/synthetic.py``):
    the sphere in nerfstudio's layout (OPENCV distortion, views of two
    sizes), in instant-ngp's (distortion) and in Record3D's. The MonoSDF
    layout of the cue scene is written when phase 18 starts
    (``finish_capture_scenes``)."""
    from sdfstudio_tpu_torch.data import synthetic

    out = Path(tempfile.mkdtemp(prefix="sst_capture_scenes_"))

    def write() -> dict:
        t = time.perf_counter()
        dirs = {"nerfstudio": synthetic.generate_nerfstudio_sphere_dataset(
                    out / "nerfstudio", num_images=CAPTURE_VIEWS, sizes=CAPTURE_SIZES),
                "ngp": synthetic.generate_ngp_sphere_dataset(
                    out / "ngp", num_images=NGP_CAPTURE[0], width=NGP_CAPTURE[1],
                    height=NGP_CAPTURE[2]),
                "record3d": synthetic.generate_record3d_sphere_dataset(
                    out / "record3d", num_images=RECORD3D_CAPTURE[0], width=RECORD3D_CAPTURE[1],
                    height=RECORD3D_CAPTURE[2])}
        return {"seconds": time.perf_counter() - t, **{k: str(v) for k, v in dirs.items()}}

    pool = concurrent.futures.ThreadPoolExecutor(1)
    _CAPTURE_SCENES.update(dir=out, pool=pool, future=pool.submit(write))


def finish_capture_scenes(cue_scene: str) -> dict:
    from sdfstudio_tpu_torch.data import synthetic

    info = _CAPTURE_SCENES["future"].result(timeout=600)
    info["monosdf"] = str(synthetic.write_monosdf_layout(Path(cue_scene), _CAPTURE_SCENES["dir"] / "monosdf"))
    log("capture", f"scenes written beside the card's work: {json.dumps(info)}")
    return info


def remove_capture_scenes() -> None:
    if "pool" in _CAPTURE_SCENES:
        _CAPTURE_SCENES["pool"].shutdown(wait=True)
        shutil.rmtree(_CAPTURE_SCENES["dir"], ignore_errors=True)


def camera_models_case(smi: str, device: str = "cuda") -> dict:
    """The rays of perspective, fisheye and equirectangular cameras with
    OpenCV distortion generated on the card and on the CPU from the same
    cameras and pixels (``Cameras.generate_rays``): origins, directions,
    pixel areas and direction norms held to ``RAYS_TOL``."""
    from sdfstudio_tpu_torch.cameras.camera_utils import get_distortion_params
    from sdfstudio_tpu_torch.cameras.cameras import Cameras, CameraType

    g = np.random.default_rng(21)
    n, R = 6, 65536
    c2w = np.concatenate([np.linalg.qr(g.normal(size=(n, 3, 3)))[0], g.normal(size=(n, 3, 1))], -1)
    dist = np.stack([get_distortion_params(k1=g.uniform(-0.3, 0.3), k2=g.uniform(-0.1, 0.1), k3=0.01,
                                           k4=-0.005, p1=g.uniform(-0.01, 0.01),
                                           p2=g.uniform(-0.01, 0.01)) for _ in range(n)])
    ctype = np.array([CameraType.PERSPECTIVE, CameraType.FISHEYE, CameraType.EQUIRECTANGULAR] * 2)
    fx = g.uniform(300, 400, n)
    idx = torch.as_tensor(g.integers(0, n, R))
    coords = torch.as_tensor(np.stack([g.uniform(0, 300, R), g.uniform(0, 400, R)], -1), dtype=torch.float32)
    rays = {}
    for dev in (device, "cpu"):
        cams = Cameras.create(c2w, fx, 1.1 * fx, 200.0, 150.0, 400, 300, camera_type=ctype,
                              distortion_params=dist, device=dev)
        rays[dev] = cams.generate_rays(idx.to(dev), coords.to(dev))
    errs = {k: float((getattr(rays[device], k).cpu() - getattr(rays["cpu"], k)).abs().max())
            for k in ("origins", "directions", "pixel_area", "directions_norm")}
    log("capture", f"rays of the three camera models with distortion, card vs CPU, max |diff| "
        f"{json.dumps(errs)} (tol {RAYS_TOL}) over {R} rays ({smi})")
    check(all(e <= RAYS_TOL for e in errs.values()), f"camera models: the card's rays differ {errs}")
    return {"rays": R, "max_abs_err": errs}


def undistort_case(cams, ray_indices) -> dict:
    """The Newton undistortion (``camera_utils.radial_and_tangential_undistort``,
    plain PyTorch, range ``sst/undistort``) alone on a batch's base and
    offset coordinates [3, R, 2], timed with CUDA events, beside its bound:
    the coordinates and the rays' parameters read once and the result
    written once, or ``UNDISTORT_FLOP`` operations a coordinate and step in
    FP32, whichever is longer."""
    from sdfstudio_tpu_torch.cameras.camera_utils import radial_and_tangential_undistort

    idx = ray_indices[:, 0]
    y, x = ray_indices[:, 1].to(torch.float32) + 0.5, ray_indices[:, 2].to(torch.float32) + 0.5
    fx, fy, cx, cy = cams.fx[idx], cams.fy[idx], cams.cx[idx], cams.cy[idx]
    cs = torch.stack([torch.stack([(x - cx) / fx, -(y - cy) / fy], -1),
                      torch.stack([(x - cx + 1) / fx, -(y - cy) / fy], -1),
                      torch.stack([(x - cx) / fx, -(y - cy + 1) / fy], -1)], 0)
    dist = cams.distortion_params[idx][None]
    R = idx.shape[0]
    ms = cuda_time_ms(lambda: radial_and_tangential_undistort(cs, dist), reps=20)
    nbytes = 4.0 * (3 * R * 2 + R * 6 + 3 * R * 2)
    flop = float(UNDISTORT_FLOP * 10 * 3 * R)
    bound, by = max(nbytes / HBM_RATE, flop / 67e12) * 1e3, ("bytes" if nbytes / HBM_RATE >= flop / 67e12
                                                             else "operations")
    return {"rays": R, "ms": ms, "bytes": nbytes, "flop": flop, "bound_ms": bound, "bound_by": by}


def capture_phase(fm, smi: str, name: str, scenes: dict) -> dict:
    """A real-capture layout (``capture[<name>]``) through JAX's command line
    at the method's registered values and full width, from seed 0:
    ``nerfacto nerfstudio-data`` on the nerfstudio-layout sphere (OPENCV
    distortion, views of 400 x 300 and 480 x 360 padded into one stack, the
    SO3xR3 camera optimizer, the subset image cache at half the views,
    swapped every ``CAPTURE_REPEAT`` steps), ``instant-ngp instant-ngp-data``
    (distortion, its dynamic batch), ``monosdf monosdf-data
    --include-mono-prior True`` on the cue scene in MonoSDF's layout (no
    crop) and ``nerfacto record3d-data``. ``CAPTURE_STEPS`` steps: ms a step
    over steps ``CAPTURE_TIMED`` on, rays/s, peak memory, the padded stack's
    bytes; the undistortion's time alone (``undistort_case``) and in a
    traced step (``sst/undistort``); one kernel step against one plain step
    (``step_vs_plain``; on shared resamplings for the proposal methods);
    every chain alone (``chain_checks``); launches exact by kernel and by
    chain in the train steps and in ``eval.py``, which renders each eval
    view at its own size (nerfacto's at 400 x 300, below the stack's 480 x
    360). The subset cache: its swaps, their host time, global camera ids
    (the camera optimizer's moved rows are the cameras of the subsets the
    steps drew from), no draw in the padding."""
    from sdfstudio_tpu_torch.engine.trainer import loss_and_metrics, to_bucket
    from sdfstudio_tpu_torch.models.neuralreconW import REFRESH_CHUNK
    from sdfstudio_tpu_torch.scripts import eval as eval_script
    from sdfstudio_tpu_torch.scripts import train as train_script

    phase = f"capture[{name}]"
    method, parser, scene_key, extra, pflags = CAPTURE_PHASES[name]
    ngp, surface = method == "instant-ngp", method == "monosdf"
    setup = train_script.setup_lib.setup_trainer
    made, marks, vecs, buckets, swaps, subsets = [], {}, [], [], [], []
    t_phase = time.perf_counter()

    def keep(*args, **kw):
        """The trainer ``main`` builds: steps ``CAPTURE_TIMED`` and the last
        marked, each step's bucket and metrics and the subset it drew from
        kept, each swap of the subset timed."""
        t = setup(*args, **kw)
        step, dm_, resample = t.train_step, t.datamanager, t.datamanager.maybe_resample

        def marked_step():
            if t.step == CAPTURE_TIMED:
                torch.cuda.synchronize()
                marks["t0"] = time.perf_counter()
            buckets.append(t.num_rays_per_batch())
            if dm_.subset_mode:
                subsets.append(dm_.train_data["_global_ids"])
            vecs.append(step())
            if t.step == CAPTURE_STEPS:
                torch.cuda.synchronize()
                marks["t1"] = time.perf_counter()
            return vecs[-1]

        def timed_resample(s_):
            before = dm_.train_data.get("_global_ids")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            resample(s_)
            torch.cuda.synchronize()
            if dm_.train_data.get("_global_ids") is not before:
                swaps.append({"step": s_, "ms": (time.perf_counter() - t0) * 1e3,
                              "ids": dm_.train_data["_global_ids"].tolist()})

        t.train_step, dm_.maybe_resample = marked_step, timed_resample
        made.append(t)
        return t

    with tempfile.TemporaryDirectory() as tmp:
        argv = [method, *extra, "--experiment-name", "smoke", "--output-dir", tmp, "--timestamp", "t",
                "--vis", "none", "--trainer.max-num-iterations", str(CAPTURE_STEPS),
                "--trainer.steps-per-eval-image", "0", parser, "--data", scenes[scene_key], *pflags]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        fm.reset_launch_counts()
        train_script.setup_lib.setup_trainer = keep
        t = time.perf_counter()
        try:
            check(train_script.main(argv) == 0, f"{phase}: the train command failed")
        finally:
            train_script.setup_lib.setup_trainer = setup
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t
        train_total, train_widths = _counts(fm), width_counts(fm)
        trainer = made[0]
        dm, model = trainer.datamanager, trainer.model
        check(trainer.step == CAPTURE_STEPS and len(vecs) == CAPTURE_STEPS, f"{phase}: step {trainer.step}")
        step_ms = (marks["t1"] - marks["t0"]) * 1e3 / (CAPTURE_STEPS - CAPTURE_TIMED)
        rays_per_s = sum(buckets[CAPTURE_TIMED:]) / (marks["t1"] - marks["t0"])
        rows = [dict(zip(trainer.metric_keys, v.tolist())) for v in vecs]
        check(all(math.isfinite(r["loss"]) for r in rows), f"{phase}: losses {[r['loss'] for r in rows]}")
        cams = dm.train_cameras
        n_imgs = dm.num_train_images
        full = dm._host_train_data if dm.subset_mode else dm.train_data
        stack = {"images": n_imgs, "padded_hw": [dm.image_height, dm.image_width],
                 "sizes": sorted({(int(h), int(w)) for h, w in zip(cams.height.tolist(),
                                                                   cams.width.tolist())}),
                 # N x max H x max W of every channel: on the host with the subset cache
                 "bytes": int(sum(v.nbytes if isinstance(v, np.ndarray) else v.numel() * v.element_size()
                                  for k, v in full.items() if k != "_global_ids")),
                 "device_bytes": int(sum(v.numel() * v.element_size() for v in dm.train_data.values())),
                 "variable_res": dm.variable_res, "distorted": cams.distorted}
        extra_rec = {"stack": stack}
        # draws stay inside each image's own extent (the padding is never read)
        g = torch.Generator(device=dm.device).manual_seed(5)
        idx, _ = dm.sample_train_batch(g, num_rays=1 << 16)
        inside = bool(((idx[:, 1] < dm.image_heights[idx[:, 0]]) & (idx[:, 2] < dm.image_widths[idx[:, 0]])).all())
        check(inside, f"{phase}: a draw fell in an image's padding")
        if name == "nerfacto":
            check(dm.subset_mode and dm.variable_res and cams.distorted and len(stack["sizes"]) == 2,
                  f"{phase}: the stack {stack}, subset mode {dm.subset_mode}")
            check([s_["step"] for s_ in swaps] == list(range(CAPTURE_REPEAT, CAPTURE_STEPS + 1, CAPTURE_REPEAT))
                  and all(len(s_["ids"]) == CAPTURE_SUBSET for s_ in swaps),
                  f"{phase}: subset swaps {swaps}")
            drawn = sorted({int(i) for ids in subsets for i in ids.tolist()})
            pose = model.camera_opt.pose_adjustment.detach()
            moved = sorted(int(i) for i in torch.nonzero(pose.abs().amax(dim=1) > 0).reshape(-1).tolist())
            check(moved == drawn, f"{phase}: the camera optimizer moved rows {moved}, the subsets held {drawn}")
            extra_rec["subset"] = {"swaps": swaps, "cameras_drawn": drawn, "rows_moved": moved,
                                   "subset_bytes": stack["device_bytes"]}
        if ngp:
            extra_rec["buckets"] = buckets
            check(buckets[0] == to_bucket(trainer.config.target_num_samples
                                          // model.config.max_num_samples_per_ray), f"{phase}: buckets {buckets}")
        run = Path(tmp) / "smoke" / method / "t"
        c0, t = _counts(fm), time.perf_counter()
        check(eval_script.main(["--load-config", str(run / "config.yml"),
                                "--output-path", f"{tmp}/eval.json"]) == 0, f"{phase}: eval.py failed")
        torch.cuda.synchronize()
        eval_s, eval_launches = time.perf_counter() - t, _minus(_counts(fm), c0)
        ev = json.loads((Path(tmp) / "eval.json").read_text())
        check(ev["num_images"] == dm.num_eval_images
              and all(math.isfinite(ev["results"][k]) for k in ("psnr", "ssim")),
              f"{phase}: eval.py wrote {ev}")
    ecams = dm.eval_cameras if dm.eval_cameras is not None else dm.train_cameras
    eval_sizes = [(int(ecams.height[i]), int(ecams.width[i])) for i in range(dm.num_eval_images)]
    if name == "nerfacto":
        check(eval_sizes == [CAPTURE_SIZES[0][::-1]] and tuple(stack["padded_hw"]) == CAPTURE_SIZES[1][::-1],
              f"{phase}: eval views {eval_sizes} against the stack's {stack['padded_hw']}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(phase, f"main: {main_s:.1f} s; {CAPTURE_STEPS} steps (rays {sorted(set(buckets))}), steps "
        f"{CAPTURE_TIMED}-{CAPTURE_STEPS - 1}: {step_ms:.2f} ms a step, {rays_per_s:.0f} rays/s; peak "
        f"memory {peak_gib:.2f} GiB ({smi}); stack {json.dumps(stack)}; eval.py {eval_s:.1f} s over "
        f"views {eval_sizes} {json.dumps(ev['results'])}; losses first {rows[0]['loss']:.5f} last "
        f"{rows[-1]['loss']:.5f}" + (f"; subset {json.dumps(extra_rec['subset'])}"
                                     if "subset" in extra_rec else ""))

    undistort = None
    if cams.distorted:
        g = torch.Generator(device=dm.device).manual_seed(777)
        idx, _ = dm.sample_train_batch(g, num_rays=trainer.num_rays_per_batch())
        undistort = undistort_case(cams, idx)

    # one step twice from the same state and batch (and once on the kernel step's resamplings)
    sched = model.schedules(trainer.step)

    def one_step():
        g_ = torch.Generator(device=dm.device).manual_seed(777)
        i, b = dm.sample_train_batch(g_, num_rays=trainer.num_rays_per_batch())
        total_, ld, _ = loss_and_metrics(model, dm.generate_rays(i), b, sched, g_,
                                         model_state=trainer.model_state)
        return {k: float(v.detach()) for k, v in ld.items()}, grads_of(trainer, total_)

    proposals = bool(getattr(model, "proposal_networks", None))
    step = step_vs_plain(fm, phase, one_step, plain_hash=not surface, shared_samples=proposals,
                         only_well_posed=proposals, model=model if proposals else None, carry_relu=True)
    calls, hash_calls = step["calls"], step["hash_calls"]
    errs = {k: step.get(k) for k in ("loss_err", "grad_err", "shared_loss_err", "shared_grad_err",
                                     "parted")}
    check(surface or ngp or step["grad_norm"]["camera_opt"] > 0, f"{phase}: no gradient in the pose table")
    del step
    widths = [_chain_key(c) for c in calls]
    want = {"nerfacto": ["10-16-1", "10-16-1", "32-64-16"], "instant-ngp": ["32-64-16"],
            "monosdf": ["321-256-256-256-256-3", "283-128-128"]}[method]
    check(widths == want and all("g" in c for c in calls),
          f"{phase}: captured chains {widths}, each with a backward")
    check([r["F"] for r in hash_calls] == ([] if surface else [2] * len(widths)),
          f"{phase}: captured hash calls {[(r['F'], r['x'].shape[0]) for r in hash_calls]}")

    # exact launches: proposal backwards on update steps, refresh chunks, each eval view's chunks
    n_update = sum(bool(model.schedules(s_).get("train_proposal", True)) for s_ in range(CAPTURE_STEPS))
    proposal_specs = [net.encoding.spec for net in getattr(model, "proposal_networks", [])]
    refreshes = len(range(0, CAPTURE_STEPS, model.model_state_update_every)) if ngp else 0
    refresh_chunks = refreshes * math.ceil(model.config.grid_resolution ** 3 / REFRESH_CHUNK) if ngp else 0
    train_want = expected_launches(calls, hash_calls, CAPTURE_STEPS, n_update, refresh_chunks,
                                   proposal_chains={(10, 16, 1)}, proposal_specs=proposal_specs)
    chunk = model.config.eval_num_rays_per_chunk
    eval_chunks = sum(math.ceil(h * w / chunk) for h, w in eval_sizes)
    launches = {
        "train": launches_held(phase, "train", train_total, train_want),
        "eval_py": launches_held(phase, "eval.py", eval_launches,
                                 expected_launches(calls, hash_calls, 0, 0, eval_chunks)),
    }
    check(set(train_widths) <= {"hash_encode_fwd[F=2]", "hash_encode_bwd[F=2]"},
          f"{phase}: hash launches by width {train_widths}")
    log(phase, f"launches, exact: {json.dumps(launches)}; proposal update steps {n_update} of "
        f"{CAPTURE_STEPS}; refresh chunks {refresh_chunks}; eval chunks {eval_chunks}")
    names = [CAPTURE_CHAINS[w] for w in widths]
    if names.count("proposal") == 2:
        names[:2] = ["proposal_0", "proposal_1"]
    chains = chain_checks(fm, calls, names, phase, name)
    del calls, hash_calls
    torch.cuda.empty_cache()
    with uncounted(fm):
        profile = traced_step(trainer)
    log(phase.replace("[", "_profile["), json.dumps({"train_step": profile}))
    in_step = profile["ranges"].get("sst/undistort")
    check(not cams.distorted or in_step is not None,
          f"{phase}: no sst/undistort range in the traced step: {sorted(profile['ranges'])}")
    if undistort is not None:
        undistort["in_step"] = in_step
        log(phase, f"undistortion alone on {undistort['rays']} rays x 3 coordinates: "
            f"{undistort['ms']:.4f} ms (bound {undistort['bound_ms']:.5f} ms, {undistort['bound_by']}); "
            f"in the traced step {json.dumps(in_step)} ({smi})")
    phase_s = time.perf_counter() - t_phase
    del trainer, model, made, dm
    torch.cuda.empty_cache()
    return {"method": method, "parser": parser, "steps": CAPTURE_STEPS, "rays": sorted(set(buckets)),
            "step_ms": step_ms, "rays_per_s": rays_per_s, "main_s": main_s, "eval_py_s": eval_s,
            "eval_py": ev["results"], "eval_views": eval_sizes, "launches": launches,
            "train_launches": train_total[0], "eval_launches": eval_launches[0],
            "hash_launches_by_width": train_widths, "chains": chains, "undistort": undistort,
            **extra_rec, **{f"step_{k}": v for k, v in errs.items()},
            "loss_first": rows[0]["loss"], "loss_last": rows[-1]["loss"],
            "train_step_idle_share": profile["device_idle_share"],
            "traced_step_ms": profile["traced_wall_ms"], "device_busy_ms": profile["device_busy_ms"],
            "ranges": profile["ranges"], "peak_memory_gib": peak_gib, "phase_s": phase_s}


def _counts_sum(parts: list) -> tuple:
    kernels, chains = {}, {}
    for k, c in parts:
        for name, n in k.items():
            kernels[name] = kernels.get(name, 0) + n
        for name, n in c.items():
            chains[name] = chains.get(name, 0) + n
    return kernels, chains


def bigmlp_probe(fm, smi: str, batches: int, out_path: Optional[str] = None) -> dict:
    """Where ``cli[neus-facto-bigmlp]``'s kernel and plain steps part, over
    ``batches`` batches (seeds 2000 on) from the phase's trained state:
    ``neus-facto-bigmlp`` through JAX's command line as the phase runs it
    (its 40 steps; no eval images, final eval or mesh), then for each batch
    ``step_vs_plain(carry_choices=True)``: the final samples that changed
    side of the merge sphere and the resamplings' displacement
    (``samples_parted``), the rgb residuals whose signs differ
    (``choices_parted``), and the gradient errors of the free step, of the
    free step with the kernel step's choices carried over, and of the step
    on the kernel step's resamplings with and without the carry. A batch
    the check does not hold is recorded with its message, not raised.
    ``python3 chip_smoke.py --probe-bigmlp N [--probe-out FILE]``."""
    from sdfstudio_tpu_torch.engine.trainer import loss_and_metrics
    from sdfstudio_tpu_torch.scripts import train as train_script

    method, setup, made = "neus-facto-bigmlp", train_script.setup_lib.setup_trainer, []

    def keep(*args, **kw):
        made.append(setup(*args, **kw))
        return made[-1]

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        argv = [method, *CLI_EXTRA[method], "--experiment-name", "probe", "--output-dir", tmp,
                "--timestamp", "t", "--vis", "none", "--trainer.max-num-iterations", str(TRAIN_STEPS),
                "--trainer.steps-per-eval-image", "0", "sdfstudio-data", "--data", SCENE,
                "--skip-every-for-val-split", str(CLI_EVAL_SPLIT)]
        train_script.setup_lib.setup_trainer = keep
        try:
            check(train_script.main(argv) == 0, "the probe's train command failed")
        finally:
            train_script.setup_lib.setup_trainer = setup
    trainer = made[0]
    dm, model = trainer.datamanager, trainer.model
    sched = model.schedules(trainer.step)
    train_s = time.perf_counter() - t0

    def one_step(seed: int):
        gen = torch.Generator(device=dm.device).manual_seed(seed)
        idx, batch = dm.sample_train_batch(gen)
        total, ld, _ = loss_and_metrics(model, dm.generate_rays(idx), batch, sched, gen)
        return {k: float(v.detach()) for k, v in ld.items()}, grads_of(trainer, total)

    def worst(errs):
        return None if errs is None else max(errs.values())

    rows = []
    for b in range(batches):
        seed = 2000 + b
        try:
            r, held, msg = step_vs_plain(fm, f"probe batch {seed}", lambda: one_step(seed),
                                         shared_samples=True, merge_radius=1.0, model=model,
                                         carry_choices=True), True, None
        except AssertionError as e:
            r, held, msg = None, False, str(e)
        if r is None:  # the failed comparison again, reported without the check
            rows.append({"seed": seed, "held": False, "message": msg})
            continue
        ch = r["choices"]
        rows.append({"seed": seed, "held": held, "side_flips": r["parted"]["side_flips"],
                     "cells_max_abs_diff": r["parted"]["cells_max_abs_diff"],
                     "l1_sign_flips_free": ch["free"]["l1_sign_flips"],
                     "l1_flips_within_rounding_free": ch["free"]["l1_flips_within_rounding"],
                     "l1_sign_flips_shared": ch["shared"]["l1_sign_flips"],
                     "side_flips_within_rounding": ch["free"]["side_flips_within_rounding"],
                     "free_grad_err": worst(r["grad_err"]),
                     "carried_grad_err": worst(r.get("carried_grad_err")),
                     "shared_grad_err": worst(r["shared_grad_err"]),
                     "shared_uncarried_grad_err": worst(r.get("shared_uncarried_grad_err")),
                     "field_free_grad_err": r["grad_err"].get("field"),
                     "choices": ch})
        del r
    ok = [x for x in rows if x["held"]]

    def count(pred):
        return sum(1 for x in ok if pred(x))

    summary = {
        "batches": batches, "held": len(ok), "not_held": [x for x in rows if not x["held"]],
        "train_s": train_s, "smi": smi,
        "free_over_tol": count(lambda x: x["free_grad_err"] > STEP_GRAD_TOL),
        "free_over_tol_with_l1_flip": count(lambda x: x["free_grad_err"] > STEP_GRAD_TOL
                                            and x["l1_sign_flips_free"] > 0),
        "free_over_tol_with_side_flip": count(lambda x: x["free_grad_err"] > STEP_GRAD_TOL
                                              and x["side_flips"] > 0),
        "shared_uncarried_over_tol": count(lambda x: (x["shared_uncarried_grad_err"] or 0) > STEP_GRAD_TOL),
        "shared_uncarried_over_tol_with_l1_flip": count(
            lambda x: (x["shared_uncarried_grad_err"] or 0) > STEP_GRAD_TOL and x["l1_sign_flips_shared"] > 0),
        "batches_with_l1_flip_free": count(lambda x: x["l1_sign_flips_free"] > 0),
        "batches_with_l1_flip_shared": count(lambda x: x["l1_sign_flips_shared"] > 0),
        "batches_with_side_flip": count(lambda x: x["side_flips"] > 0),
        "l1_flips_free_total": sum(x["l1_sign_flips_free"] for x in ok),
        "l1_flips_free_beyond_rounding": sum(x["l1_sign_flips_free"] - x["l1_flips_within_rounding_free"]
                                             for x in ok),
        "side_flips_total": sum(x["side_flips"] for x in ok),
        "max_free_grad_err": max((x["free_grad_err"] for x in ok), default=None),
        "max_carried_or_free_grad_err": max(((x["carried_grad_err"] or x["free_grad_err"]) for x in ok),
                                            default=None),
        "max_shared_grad_err": max((x["shared_grad_err"] for x in ok), default=None),
        "max_shared_uncarried_grad_err": max((x["shared_uncarried_grad_err"] or 0 for x in ok),
                                             default=None),
        "max_cells_displacement": max((max(x["cells_max_abs_diff"]) for x in ok), default=None),
    }
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(json.dumps({"summary": summary, "batches": rows}, default=str))
    log("bigmlp_probe", json.dumps(summary, default=str))
    return summary


def _relu_sides_parted(pre_a: torch.Tensor, pre_b: torch.Tensor) -> dict:
    """Where two paths' pre-activations of one relu layer lie on opposite
    sides of 0: how many, and the largest |pre-activation| at a flip."""
    flip = (pre_a > 0) != (pre_b > 0)
    size = torch.maximum(pre_a.abs(), pre_b.abs())[flip]
    return {"flips": int(flip.sum()), "max_abs_pre": float(size.max()) if size.numel() else 0.0}


def density_probe(fm, smi: str, batches: int, out_path: Optional[str] = None) -> dict:
    """Where ``density[nerfacto]``'s kernel step and the plain step on its
    resamplings part, over ``batches`` batches (the phase's seed 777, then
    seeds 3000 on) from the phase's trained state: ``nerfacto`` through
    ``sdfstudio-data`` as the phase runs it (its 20 steps; no eval or
    mesh), then for each batch the phase's check (``step_vs_plain(
    carry_relu=True)``: the step on the kernel step's resamplings with and
    without the relu sides carried over, and the flips), and for the first
    ``DENSITY_PROBE_FULL``, all on the kernel step's resamplings: the
    kernel step twice and the plain step twice (each path against itself),
    the plain step with the fused chains, and then also the colour head,
    computed in float64 and rounded to float32 at each layer (another
    correct float32 path), each group's gradient error against the kernel
    step and the plain step; the relu sides that part between the paths
    (the chains' first layer as the forward kernel computes it on its
    captured input against the plain product on the plain step's, the
    head's layers on each path's own input); and where the camera table's
    error lies (the largest camera row's share of it).
    ``python3 chip_smoke.py --probe-density N [--probe-out FILE]``."""
    from sdfstudio_tpu_torch.engine.trainer import loss_and_metrics
    from sdfstudio_tpu_torch.scripts import train as train_script

    method, setup, made = "nerfacto", train_script.setup_lib.setup_trainer, []

    def keep(*args, **kw):
        made.append(setup(*args, **kw))
        return made[-1]

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        argv = [method, "--experiment-name", "probe", "--output-dir", tmp, "--timestamp", "t",
                "--vis", "none", "--trainer.max-num-iterations", str(DENSITY_STEPS[method]),
                "--trainer.steps-per-eval-image", "0", "sdfstudio-data", "--data", SCENE,
                "--skip-every-for-val-split", str(CLI_EVAL_SPLIT)]
        train_script.setup_lib.setup_trainer = keep
        try:
            check(train_script.main(argv) == 0, "the probe's train command failed")
        finally:
            train_script.setup_lib.setup_trainer = setup
    trainer = made[0]
    dm, model = trainer.datamanager, trainer.model
    head = model.field.mlp_head
    sched = model.schedules(trainer.step)
    train_s = time.perf_counter() - t0

    def one_step(seed: int):
        gen = torch.Generator(device=dm.device).manual_seed(seed)
        idx, batch = dm.sample_train_batch(gen, num_rays=trainer.num_rays_per_batch())
        total, ld, _ = loss_and_metrics(model, dm.generate_rays(idx), batch, sched, gen,
                                        model_state=trainer.model_state)
        return {k: float(v.detach()) for k, v in ld.items()}, grads_of(trainer, total)

    def rounded_chain(x, weights, biases, activation="relu", out_activation="none"):
        h, n = x, len(weights)
        for i, (w, b) in enumerate(zip(weights, biases)):
            h = (torch.matmul(h.double(), w.double()) + b.double()).float()
            h = fm._act(h, activation if i < n - 1 else out_activation)
        return h

    def rounded_head(x):
        h, n = x, len(head.layers)
        for i, layer in enumerate(head.layers):
            h = (torch.matmul(h.double(), layer.kernel.double()) + layer.bias.double()).float()
            h = fm._act(h, head.activation) if i < n - 1 else torch.sigmoid(h)
        return h

    @contextlib.contextmanager
    def head_inputs(rec):
        hook = head.register_forward_hook(lambda mod, inp, out: rec.append(inp[0].detach().clone()))
        try:
            yield
        finally:
            hook.remove()

    @contextlib.contextmanager
    def plain_calls(rec):
        def recording(x, weights, biases, activation="relu", out_activation="none"):
            rec.append({"x": x.detach().clone(), "ws": [w.detach() for w in weights],
                        "bs": [b.detach() for b in biases]})
            return fm.fused_mlp_plain(x, weights, biases, activation, out_activation)

        with swap_fused_mlp(recording):
            yield

    def head_pres(x):
        pres, h = [], x
        for layer in list(head.layers)[:-1]:
            pre = torch.matmul(h, layer.kernel.detach()) + layer.bias.detach()
            pres.append(pre)
            h = torch.relu(pre)
        return pres

    def errs(a, b):
        return {g: rel_fro(a[g], b[g]) for g in b}

    n_cams = model.camera_opt.pose_adjustment.shape[0]

    def density_probe_batch(seed: int) -> dict:
        """One batch's paths against each other on the kernel step's resamplings."""
        k_rec, k_calls, p_calls, k_head, p_head = [], [], [], [], []

        def shared_step():
            with pdf_samples(k_rec, replay=True):
                return one_step(seed)

        with uncounted(fm):
            with capture_fused_mlp_calls(k_calls), pdf_samples(k_rec), head_inputs(k_head):
                k_loss, k = one_step(seed)
            _, k2 = shared_step()
            with _both_plain(fm):
                with plain_calls(p_calls), head_inputs(p_head):
                    s_loss, s = shared_step()
                _, s2 = shared_step()
                with swap_fused_mlp(rounded_chain):
                    _, r = shared_step()
                    head.forward_plain = rounded_head
                    try:
                        _, r2 = shared_step()
                    finally:
                        del head.forward_plain
            with torch.no_grad():
                chains = []
                for kc, pc in zip(k_calls, p_calls):
                    xk = kc["x"].reshape(-1, kc["x"].shape[-1])
                    xp = pc["x"].reshape(-1, pc["x"].shape[-1])
                    pre_p = torch.matmul(xp, pc["ws"][0]) + pc["bs"][0]
                    pre_k = fm.fused_mlp(xk, kc["ws"][:1], kc["bs"][:1], "relu", "none")
                    chains.append({"dims": _chain_key(kc), "x_max_abs_diff": float((xk - xp).abs().max()),
                                   **_relu_sides_parted(pre_k, pre_p)})
                heads = [_relu_sides_parted(a, c) for hk, hp in zip(k_head, p_head)
                         for a, c in zip(head_pres(hk), head_pres(hp))]
                head_x_diff = max(float((hk - hp).abs().max()) for hk, hp in zip(k_head, p_head))
            torch.cuda.synchronize()
        cam_diff = (k["camera_opt"] - s["camera_opt"]).reshape(n_cams, -1)
        row_norms = torch.linalg.vector_norm(cam_diff, dim=-1)
        top = int(torch.argmax(row_norms))
        out = {"loss": k_loss,
               "loss_err": {n_: abs(k_loss[n_] - s_loss[n_]) / max(abs(s_loss[n_]), 1e-12) for n_ in s_loss},
               "grad_norm": {g: float(torch.linalg.vector_norm(v)) for g, v in k.items()},
               "shared": errs(k, s), "kernel_repeat": errs(k2, k), "plain_repeat": errs(s2, s),
               "rounded_chains_vs_plain": errs(r, s), "rounded_all_vs_plain": errs(r2, s),
               "kernel_vs_rounded_all": errs(k, r2),
               "camera_top_row": top, "camera_top_row_share": float(row_norms[top] / row_norms.norm()),
               "chains": chains, "head": heads, "head_x_max_abs_diff": head_x_diff}
        log("density_probe", f"batch {seed}: shared {out['shared']}; rounded vs plain "
            f"{out['rounded_all_vs_plain']}; kernel repeat {out['kernel_repeat']}")
        return out

    rows = []
    for b in range(batches):
        seed = 777 if b == 0 else 3000 + b
        try:  # the phase's check, the relu sides carried
            chk = step_vs_plain(fm, f"probe batch {seed}", lambda: one_step(seed), shared_samples=True,
                                only_well_posed=True, model=model, carry_relu=True)
            check_rec = {"held": True, "carried": chk["shared_grad_err"],
                         "uncarried": chk["shared_uncarried_grad_err"], "relu_flips": chk["relu_flips"]}
            del chk
        except AssertionError as e:
            check_rec = {"held": False, "message": str(e)}
        rows.append({"seed": seed, "check": check_rec})
        if b < DENSITY_PROBE_FULL:
            rows[-1].update(density_probe_batch(seed))

    full = [x for x in rows if "shared" in x]

    def top_of(key, g="camera_opt", n=5):
        return sorted((x[key][g] for x in full), reverse=True)[:n]

    def over(key, g="camera_opt"):
        return sum(1 for x in full if x[key][g] > STEP_GRAD_TOL)

    keys = ("shared", "kernel_repeat", "plain_repeat", "rounded_chains_vs_plain",
            "rounded_all_vs_plain", "kernel_vs_rounded_all")
    groups = list(full[0]["shared"])
    checked = [dict(x["check"], seed=x["seed"]) for x in rows if x["check"]["held"]]
    summary = {
        "batches": batches, "batches_compared_in_full": len(full), "train_s": train_s, "smi": smi,
        "check_not_held": [{"seed": x["seed"], **x["check"]} for x in rows if not x["check"]["held"]],
        "check_carried_max": {g: max((c["carried"][g] for c in checked), default=None) for g in groups},
        "check_uncarried_max": {g: max((c["uncarried"][g] for c in checked), default=None) for g in groups},
        "check_uncarried_over_tol": sum(1 for c in checked if max(c["uncarried"].values()) > STEP_GRAD_TOL),
        "check_batches_with_relu_flips": sum(1 for c in checked
                                             if c["relu_flips"]["chain_flips"] + c["relu_flips"]["mlp_flips"]),
        "check_relu_flips": {k_: sum(c["relu_flips"][k_] for c in checked)
                             for k_ in ("chain_flips", "mlp_flips", "rows_queried")},
        # the batches whose uncarried comparison parted by more than 1e-5: what the carry made of them
        "check_parted": [c for c in checked if max(c["uncarried"].values()) > 0.1 * STEP_GRAD_TOL],
        "over_tol": {key: {g: over(key, g) for g in groups} for key in keys},
        "camera_top5": {key: top_of(key) for key in keys},
        "field_max": {key: max(x[key]["field"] for x in full) for key in keys},
        "camera_grad_norm": [min(x["grad_norm"]["camera_opt"] for x in full),
                             max(x["grad_norm"]["camera_opt"] for x in full)],
        "chain_flips_total": sum(c["flips"] for x in full for c in x["chains"]),
        "head_flips_total": sum(h["flips"] for x in full for h in x["head"]),
        "batches_over_tol_shared": [
            {"seed": x["seed"], "shared": x["shared"]["camera_opt"],
             "rounded_all_vs_plain": x["rounded_all_vs_plain"]["camera_opt"],
             "kernel_repeat": x["kernel_repeat"]["camera_opt"],
             "chain_flips": [c["flips"] for c in x["chains"]], "head_flips": [h["flips"] for h in x["head"]],
             "top_row_share": x["camera_top_row_share"]}
            for x in full if x["shared"]["camera_opt"] > STEP_GRAD_TOL],
    }
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(json.dumps({"summary": summary, "batches": rows}, default=str))
    log("density_probe", json.dumps(summary, default=str))
    return summary


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

    # the cue phases' scene and the NeRF phases' scenes, generated on the host while the card works
    start_cue_scene()
    write_nerf_scenes()
    write_capture_scenes()

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

    # where the time goes: wall, busy and idle share all from the view's first
    # chunks traced (the profiler's host cost stretches that wall)
    profile = traced_chunks(model, cams, model.schedules(UNTRAINED_STEP))
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

    # 13. the MonoSDF and Geo-NeuS entries on the generated scene with its cues
    cue_scene = finish_cue_scene()
    cue = {m: cue_phase(fm, smi, m, _CUE_SCENE["dir"]) for m in CUE_METHODS}

    # 14. the "grid" background: neus-facto-angelo, and the occupancy-grid family
    facto_angelo = facto_angelo_phase(fm, smi)
    grid = {m: grid_phase(fm, smi, m) for m in GRID_METHODS}

    # 15. the BakedSDF family through mipnerf360-data on the heritage-like scene
    baked = {m: baked_phase(fm, smi, m) for m in BAKED_METHODS}
    # 16. the density methods through JAX's command line ------------------------
    density = {m: density_phase(fm, smi, m) for m in DENSITY_METHODS}
    # 17. the NeRF baselines through JAX's command line on the written scenes
    nerf_scenes = finish_nerf_scenes()
    nerf = {m: nerf_phase(fm, smi, m, nerf_scenes) for m in NERF_METHODS}
    # 18. real-capture layouts through JAX's command line: distortion, camera models, image sizes
    capture_scenes = finish_capture_scenes(_CUE_SCENE["dir"])
    camera_models = camera_models_case(smi)
    capture = {n: capture_phase(fm, smi, n, capture_scenes) for n in CAPTURE_PHASES}
    capture_s = sum(r["phase_s"] for r in capture.values())
    log("capture", f"the four phases took {capture_s:.1f} s (budget {CAPTURE_BUDGET_S} s)")

    # 19. results -----------------------------------------------------------
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

    def cue_launches(name: str) -> int:
        return sum(r["train_launches"][name] for r in cue.values())

    def density_launches(name: str) -> int:
        """Phase 16's launches of kernel ``name`` (train steps and eval.py)."""
        return sum(r["train_launches"].get(name, 0) + r["eval_launches"].get(name, 0)
                   for r in density.values())

    def density_chain_rows(which: str) -> list:
        """Phase 16's chains alone at a step's captured inputs, with each
        chain's launches on that method's path (train steps, eval.py)."""
        rows = []
        for m, r in density.items():
            for c in r["chains"]:
                d = c[which]
                key = f"fused_mlp_{which}:{'-'.join(map(str, c['dims']))}"
                rows.append({"method": m, "call": c["call"], "rows": c["rows"], "dims": c["dims"],
                             "out_act": c["out_act"],
                             "launches": sum(part["chains"].get(key, 0)
                                             for part in r["launches"].values()),
                             **{k: d[k] for k in ("max_abs_err", "ms", "plain_ms", "cublas_ms",
                                                  "bound_ms", "bound_ms_fp32", "bound_by")}})
        return rows

    def nerf_launches(name: str) -> int:
        """Phase 17's launches of kernel ``name`` (train steps, eval.py, dnerf's blender-data run)."""
        return sum(r["train_launches"].get(name, 0) + r["eval_launches"].get(name, 0)
                   + (r["launches"].get("blender_data") or {"kernels": {}})["kernels"].get(name, 0)
                   for r in nerf.values())

    def nerf_chain_rows(which: str) -> list:
        """Phase 17's chains alone at a step's captured inputs, with each
        chain's launches on that method's path."""
        rows = []
        for m, r in nerf.items():
            for c in r["chains"]:
                d = c[which]
                key = f"fused_mlp_{which}:{'-'.join(map(str, c['dims']))}"
                rows.append({"method": m, "call": c["call"], "rows": c["rows"], "dims": c["dims"],
                             "out_act": c["out_act"], "g_seeded": c["g_seeded"],
                             "launches": sum(part["chains"].get(key, 0)
                                             for part in r["launches"].values()),
                             **{k: d[k] for k in ("max_abs_err", "ms", "plain_ms", "cublas_ms",
                                                  "bound_ms", "bound_ms_fp32", "bound_by")}})
        return rows

    def capture_launches(name: str) -> int:
        """Phase 18's launches of kernel ``name`` (train steps and eval.py)."""
        return sum(r["train_launches"].get(name, 0) + r["eval_launches"].get(name, 0)
                   for r in capture.values())

    def capture_chain_rows(which: str) -> list:
        """Phase 18's chains alone at a step's captured inputs, with each
        chain's launches on that phase's path (train steps, eval.py)."""
        rows = []
        for n, r in capture.items():
            for c in r["chains"]:
                d = c[which]
                key = f"fused_mlp_{which}:{'-'.join(map(str, c['dims']))}"
                rows.append({"phase": n, "call": c["call"], "rows": c["rows"], "dims": c["dims"],
                             "out_act": c["out_act"],
                             "launches": sum(part["chains"].get(key, 0)
                                             for part in r["launches"].values()),
                             **{k: d[k] for k in ("max_abs_err", "ms", "plain_ms", "cublas_ms",
                                                  "bound_ms", "bound_ms_fp32", "bound_by")}})
        return rows

    def facto_hash(name: str, F: int) -> int:
        """neus-facto-angelo's launches of hash kernel ``name`` at width ``F``, as counted."""
        return sum(part.get(f"{name}[F={F}]", 0)
                   for part in facto_angelo["hash_launches_by_width"].values())

    def grid_launches(name: str) -> int:
        """Phase 14's launches of kernel ``name``, neus-facto-angelo's F = 8 calls apart
        (they are the F = 8 entries')."""
        a = facto_angelo
        n = sum(r["total_launches"][name] for r in grid.values())
        return n + a["train_launches"][name] + a["render_launches"][name] - facto_hash(name, 8)

    def baked_launches(name: str) -> int:
        """Phase 15's launches of kernel ``name``, the F = 8 ones apart (they are the F = 8 entries')."""
        n = 0
        for r in baked.values():
            n += r["train_launches"][name] + r["eval_launches"][name] + r["mesh_launches"][name]
            n += (r["render_launches"] or {}).get(name, 0) - baked_hash(r, name, 8)
        return n

    def baked_hash(r: dict, name: str, F: int) -> int:
        """A phase 15 method's launches of hash kernel ``name`` at width ``F``, as counted."""
        return sum(part.get(f"{name}[F={F}]", 0) for part in r["hash_launches_by_width"].values())

    def baked_chain_rows(which: str) -> list:
        """Phase 15's chains alone at a step's captured inputs, with each
        chain's launches on that method's path (train steps, eval.py, the
        render)."""
        rows = []
        for m, r in baked.items():
            for c in r["chains"]:
                d = c[which]
                key = f"fused_mlp_{which}:{'-'.join(map(str, c['dims']))}"
                n = sum(part["chains"].get(key, 0) for part in r["launches"].values())
                if which == "fwd" and r["render_launches"] is not None:
                    n += r["render_chains_fwd"].get("-".join(map(str, c["dims"])), 0)
                rows.append({"method": m, "call": c["call"], "rows": c["rows"], "dims": c["dims"],
                             "out_act": c["out_act"], "launches": n,
                             **{k: d[k] for k in ("max_abs_err", "ms", "plain_ms", "cublas_ms",
                                                  "bound_ms", "bound_ms_fp32", "bound_by")}})
        return rows

    def grid_chain_rows(which: str) -> list:
        """Phase 14's chains alone (the colour net with a live embedding, the
        grid background's base, neus-acc's background head), one row per
        method and call, with the chain's launches on that method's path."""
        rows = []
        for m, r in [*grid.items(), ("neus-facto-angelo", facto_angelo)]:
            for c in r["chains"]:
                d = c[which]
                key = f"fused_mlp_{which}:{'-'.join(map(str, c['dims']))}"
                n = sum(part["chains"].get(key, 0) for part in r["launches"].values())
                if which == "fwd" and "render_chains" in r:
                    n += r["render_chains"]["fwd"].get("-".join(map(str, c["dims"])), 0)
                rows.append({"method": m, "call": c["call"], "rows": c["rows"], "dims": c["dims"],
                             "out_act": c["out_act"], "launches": n,
                             **{k: d[k] for k in ("max_abs_err", "ms", "plain_ms", "cublas_ms",
                                                  "bound_ms", "bound_ms_fp32", "bound_by")}})
        return rows

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
            "launches": nf_launches[name] + cli_launches(name) + grid_launches(name)
            + baked_launches(name) + density_launches(name) + nerf_launches(name)
            + capture_launches(name),
            "launches_capture": {n: r["train_launches"].get(name, 0) + r["eval_launches"].get(name, 0)
                                 for n, r in capture.items()},
            "launches_nerf": {m: r["train_launches"].get(name, 0) + r["eval_launches"].get(name, 0)
                              for m, r in nerf.items()},
            "launches_density": {m: r["train_launches"][name] + r["eval_launches"][name]
                                 for m, r in density.items()},
            # nerfacto's field call (L16, 2^19 rows, 4096 x 48 points) with the camera optimizer:
            # the gradient in x (F = 2, and an F = 4 table on the same points) beside this kernel
            "grad_x_nerfacto": density["nerfacto"]["grad_x"],
            "launches_grid": {m: r["total_launches"][name] for m, r in grid.items()},
            "launches_baked_F2": {m: baked_hash(r, name, 2) for m, r in baked.items()},
            "launches_neus_facto_angelo_F2": facto_hash(name, 2),
            # the grid background's F = 2 call (L16, 2^19 rows, no jacobian) of a neusW step
            "background_captured": grid["neusW"]["hash_background"].get(which),
            "launches_render": nf["render_launches"][name],
            "launches_train": nf_train["launches"][name],
            "launches_resume": nf["resume"]["launches"][name],
            "launches_cli": {m: r["total_launches"][name] for m, r in cli.items()},
            # neus-facto-tpu's F = 4 SDF grid on a CLI train step's captured call
            "F4_step_captured": cli["neus-facto-tpu"]["hash_f4"].get(which),
            "max_abs_err": max([c[which]["max_abs_err"] for c in calls]
                               + [cli["neus-facto-tpu"]["hash_f4"][which]["max_abs_err"],
                                  grid["neusW"]["hash_background"][which]["max_abs_err"]]),
            "grad_x_max_rel_err": max(g["max_rel_err"] for g in density["nerfacto"]["grad_x"]),
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
        facto_f8 = facto_hash(name, 8)
        baked_f8 = baked_hash(baked["bakedangelo"], name, 8)
        launches = (angelo["det_launches"][name] if det
                    else angelo["train_launches"][name] + angelo["render_launches"][name] + facto_f8
                    + baked_f8)
        return {
            "name": f"{name}[F=8]",
            "route": "cuda",
            "source": "sdfstudio_tpu_torch/csrc/hash_grid.cu",
            "replaces": replaces,
            "launches": launches,
            "launches_train": angelo["train_launches"][name],
            "launches_render": angelo["render_launches"][name],
            "launches_deterministic": angelo["det_launches"][name],
            "launches_neus_facto_angelo": facto_f8,
            "launches_bakedangelo": baked_f8,
            # bakedangelo's SDF call: 8192 rays x 48 samples x 7 points
            "bakedangelo_step_captured": (baked["bakedangelo"]["sdf_hash"] or {}).get(
                {"corner_rows": "det", "segment_sum": "det"}.get(which, which)),
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
                     + cli_launches("fused_mlp_fwd") + cue_launches("fused_mlp_fwd")
                     + grid_launches("fused_mlp_fwd") + baked_launches("fused_mlp_fwd")
                     + density_launches("fused_mlp_fwd") + nerf_launches("fused_mlp_fwd")
                     + capture_launches("fused_mlp_fwd")),
        "launches_capture": {n: r["train_launches"]["fused_mlp_fwd"] + r["eval_launches"]["fused_mlp_fwd"]
                             for n, r in capture.items()},
        "capture_chains": capture_chain_rows("fwd"),
        "launches_nerf": {m: r["train_launches"]["fused_mlp_fwd"] + r["eval_launches"]["fused_mlp_fwd"]
                          for m, r in nerf.items()},
        "nerf_chains": nerf_chain_rows("fwd"),
        "launches_density": {m: r["train_launches"]["fused_mlp_fwd"]
                             + r["eval_launches"]["fused_mlp_fwd"] for m, r in density.items()},
        "density_chains": density_chain_rows("fwd"),
        "launches_baked": {m: r["train_launches"]["fused_mlp_fwd"] + r["eval_launches"]["fused_mlp_fwd"]
                           + (r["render_launches"] or {}).get("fused_mlp_fwd", 0)
                           for m, r in baked.items()},
        "baked_chains": baked_chain_rows("fwd"),
        "launches_grid": {m: r["total_launches"]["fused_mlp_fwd"] for m, r in grid.items()},
        "launches_neus_facto_angelo": (facto_angelo["train_launches"]["fused_mlp_fwd"]
                                       + facto_angelo["render_launches"]["fused_mlp_fwd"]),
        "grid_chains": grid_chain_rows("fwd"),
        "launches_cli": {m: r["total_launches"]["fused_mlp_fwd"] for m, r in cli.items()},
        "launches_cue": {m: r["train_launches"]["fused_mlp_fwd"] for m, r in cue.items()},
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
                           + [c["max_abs_err"] for c in surface_chains("fwd") + cli_chain_rows("fwd")
                              + grid_chain_rows("fwd") + baked_chain_rows("fwd")
                              + density_chain_rows("fwd") + nerf_chain_rows("fwd")
                              + capture_chain_rows("fwd")]),
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
                     + cli_launches("fused_mlp_bwd") + cue_launches("fused_mlp_bwd")
                     + grid_launches("fused_mlp_bwd") + baked_launches("fused_mlp_bwd")
                     + density_launches("fused_mlp_bwd") + nerf_launches("fused_mlp_bwd")
                     + capture_launches("fused_mlp_bwd")),
        "launches_capture": {n: r["train_launches"]["fused_mlp_bwd"] for n, r in capture.items()},
        "capture_chains": capture_chain_rows("bwd"),
        "launches_nerf": {m: r["train_launches"]["fused_mlp_bwd"] for m, r in nerf.items()},
        "nerf_chains": nerf_chain_rows("bwd"),
        "launches_density": {m: r["train_launches"]["fused_mlp_bwd"] for m, r in density.items()},
        "density_chains": density_chain_rows("bwd"),
        "launches_baked": {m: r["train_launches"]["fused_mlp_bwd"] for m, r in baked.items()},
        "baked_chains": baked_chain_rows("bwd"),
        "launches_grid": {m: r["total_launches"]["fused_mlp_bwd"] for m, r in grid.items()},
        "launches_neus_facto_angelo": facto_angelo["train_launches"]["fused_mlp_bwd"],
        "grid_chains": grid_chain_rows("bwd"),
        "launches_cli": {m: r["total_launches"]["fused_mlp_bwd"] for m, r in cli.items()},
        "launches_cue": {m: r["train_launches"]["fused_mlp_bwd"] for m, r in cue.items()},
        "cli_chains": cli_chain_rows("bwd"),
        "launches_neus_facto": nf_launches["fused_mlp_bwd"],
        "launches_surface": {m: r["train_launches"]["fused_mlp_bwd"] for m, r in surface.items()},
        "surface_chains": surface_chains("bwd"),
        "launches_train": train["launches"]["fused_mlp_bwd"],
        "launches_resume": resume["launches"]["fused_mlp_bwd"],
        "max_abs_err": max([r["max_abs_err"] for r in bwd]
                           + [c["max_abs_err"] for c in surface_chains("bwd") + cli_chain_rows("bwd")
                              + grid_chain_rows("bwd") + baked_chain_rows("bwd")
                              + density_chain_rows("bwd") + nerf_chain_rows("bwd")
                              + capture_chain_rows("bwd")]),
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
    log("cue", json.dumps({"scene": cue_scene, **{
        m: {k: r[k] for k in ("rays", "setup_s", "step_ms", "rays_per_s", "step_loss", "valid_share",
                              "term_mean", "syncs",
                              "patch_bytes", "patch_warping_ms", "cue_losses_ms",
                              "train_step_idle_share", "step_loss_err", "step_grad_err",
                              "peak_memory_gib")}
        for m, r in cue.items()}}))
    grid_summary = {m: {k: r[k] for k in ("rays", "step_ms", "rays_per_s", "final_eval", "refresh_ms",
                                           "shell_share", "grid_resolution", "train_step_idle_share",
                                           "traced_step_ms", "device_busy_ms", "step_loss_err",
                                           "step_grad_err", "peak_memory_gib")}
                    for m, r in grid.items()}
    grid_summary["neus-facto-angelo"] = {k: facto_angelo[k] for k in (
        "rays", "step_ms", "rays_per_s", "image_ms", "train_step_idle_share", "render_idle_share",
        "traced_step_ms", "device_busy_ms", "step_loss_err", "step_grad_err", "peak_memory_gib")}
    log("grid", json.dumps(grid_summary))
    log("baked", json.dumps({m: {k: r[k] for k in (
        "rays", "registered_rays", "cut", "step_ms", "rays_per_s", "main_s", "eval_py", "eval_py_s",
        "extract_mesh_s", "mesh_vertices", "sdf_range", "image_ms", "train_step_idle_share",
        "traced_step_ms",
        "device_busy_ms", "render_idle_share", "step_loss_err", "step_grad_err",
        "step_shared_grad_err", "step_parted", "peak_memory_gib")} for m, r in baked.items()}))
    log("density", json.dumps({m: {k: r.get(k) for k in (
        "steps", "rays", "step_ms", "rays_per_s", "main_s", "eval_py", "eval_py_s", "eval_views",
        "train_step_idle_share", "traced_step_ms", "device_busy_ms", "peak_memory_gib",
        "step_loss_err", "step_grad_err", "step_shared_grad_err", "loss_first", "loss_last",
        "buckets", "bucket_moved", "refreshes", "pose_adjustment_max_abs", "extract_mesh_refused")}
        for m, r in density.items()}))
    log("nerf", json.dumps({m: {k: r.get(k) for k in (
        "parser", "steps", "rays", "step_ms", "rays_per_s", "main_s", "eval_py", "eval_py_s",
        "eval_views", "train_step_idle_share", "traced_step_ms", "device_busy_ms", "peak_memory_gib",
        "step_loss_err", "step_grad_err", "step_shared_loss_err", "step_shared_grad_err",
        "step_well_posed", "f32_conditioning", "group_tols", "loss_first", "loss_last", "tensorvm",
        "blender_data",
        "segmentations_written_unread")} | {"tensorvm_encode_range": r["ranges"].get("sst/tensorvm_encode")}
        for m, r in nerf.items()}, default=str))
    log("capture", json.dumps({"camera_models": camera_models, "seconds": capture_s, **{
        n: {k: r.get(k) for k in (
            "method", "parser", "steps", "rays", "step_ms", "rays_per_s", "main_s", "eval_py",
            "eval_py_s", "eval_views", "train_step_idle_share", "traced_step_ms", "device_busy_ms",
            "peak_memory_gib", "stack", "subset", "buckets", "undistort", "step_loss_err",
            "step_grad_err", "step_shared_grad_err", "loss_first", "loss_last", "phase_s")}
        for n, r in capture.items()}}, default=str))
    log("done", f"total {time.perf_counter() - T0:.1f} s")
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def probe_main(argv) -> int:
    """``--probe-bigmlp N`` or ``--probe-density N`` ``[--probe-out FILE]``:
    the kernels built, then ``bigmlp_probe`` or ``density_probe`` alone."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from sdfstudio_tpu_torch.engine.final_eval import set_fp32_precision
    from sdfstudio_tpu_torch.ops import fused_mlp as fm
    from sdfstudio_tpu_torch.utils import cuda_build

    flag = "--probe-bigmlp" if "--probe-bigmlp" in argv else "--probe-density"
    n = int(argv[argv.index(flag) + 1])
    out = argv[argv.index("--probe-out") + 1] if "--probe-out" in argv else None
    set_fp32_precision()
    cuda_build.build(force=True)
    cuda_build.load_library()
    probe = bigmlp_probe if flag == "--probe-bigmlp" else density_probe
    summary = probe(fm, nvidia_smi_line(), n, out)
    print(json.dumps(summary, default=str))
    return 0


if __name__ == "__main__":
    if "--probe-bigmlp" in sys.argv or "--probe-density" in sys.argv:
        sys.exit(probe_main(sys.argv))
    try:
        code = main()
    finally:
        stop_cue_scene()
        remove_nerf_scenes()
        remove_capture_scenes()
    sys.exit(code)
