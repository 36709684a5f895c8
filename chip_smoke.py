#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own line with wall-clock seconds:

1. device: ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``;
2. build: the CUDA kernels from a clean ``sdfstudio_tpu_torch/_build/``;
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
5. the ``kernels`` JSON line, the ``nvidia-smi`` line, and the result line.

It imports torch, numpy, the standard library and ``sdfstudio_tpu_torch``
only, and reads no checkpoint. Any failed check raises, so the exit code is
not 0 and no result line is printed. Without CUDA it exits with code 2.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import math
import os
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
FP32_PEAK = 67e12  # H100 SXM, FLOP/s outside the tensor cores (data sheet)
HBM_RATE = 3.35e12  # bytes/s


def log(phase: str, msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.2f}s] {phase}: {msg}", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


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
def capture_fused_mlp_calls(calls: list):
    """Record the arguments of every ``fused_mlp`` call the model makes."""
    from sdfstudio_tpu_torch.fields import sdf_field
    from sdfstudio_tpu_torch.ops import mlp

    orig = mlp.fused_mlp

    def recording(x, weights, biases, activation="relu", out_activation="none"):
        calls.append((x.clone(), [w.clone() for w in weights], [b.clone() for b in biases],
                      activation, out_activation))
        return orig(x, weights, biases, activation, out_activation)

    mlp.fused_mlp = sdf_field.fused_mlp = recording
    try:
        yield
    finally:
        mlp.fused_mlp = sdf_field.fused_mlp = orig


def mlp_work(x, weights):
    """(FLOP, bytes) one call must do: each input read once, the output written once."""
    n = x.numel() // x.shape[-1]
    dims = [x.shape[-1]] + [w.shape[1] for w in weights]
    flop = 2.0 * n * sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    nbytes = 4.0 * (n * dims[0] + n * dims[-1] + sum(a * b + b for a, b in zip(dims[:-1], dims[1:])))
    return flop, nbytes, dims, n


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


def render_breakdown(events, wall_ms: float) -> dict:
    """From one traced render that took ``wall_ms``: the device's busy time
    (union of its kernel intervals) and idle share, for each ``sst/*`` range
    of the model (proposal sampler, permutohedral encode, geometry MLP with
    its gradient, color MLP) its host span, its span on the device timeline
    and the kernel time inside that span, and the kernels that took most."""
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from sdfstudio_tpu_torch.cameras.cameras import Cameras
    from sdfstudio_tpu_torch.configs.methods import build_model
    from sdfstudio_tpu_torch.core.scene_box import SceneBox
    from sdfstudio_tpu_torch.engine.final_eval import EVAL_STEP, render_image, set_fp32_precision
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
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log("build", line.strip())
    log("build", f"nvcc built {cuda_build.LIB_PATH.name} in {build_s:.2f} s")
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
        gpu_out = model.get_outputs(sub, sched=model.schedules(EVAL_STEP))
        model_cpu = build_model("neus-facto-tpu-p8", scene_box, num_train_data=1, seed=SEED,
                                device="cpu")
        cpu_out = model_cpu.get_outputs(sub.map(lambda x: x.cpu()),
                                        sched=model_cpu.schedules(EVAL_STEP))
    slice_err = {k: float((gpu_out[k].cpu() - cpu_out[k]).abs().max())
                 for k in ("rgb", "accumulation", "depth", "normal")}
    log("slice", f"card vs CPU plain path on 256 rays, max |diff|: {slice_err} (tol {SLICE_TOL})")
    for k, e in slice_err.items():
        check(e < SLICE_TOL, f"{k}: card and CPU paths differ by {e}")

    # 4. kernel against plain ---------------------------------------------
    calls: list = []
    chunk_rb = rb.map(lambda x: x[:1024])
    with capture_fused_mlp_calls(calls), torch.no_grad():
        model.get_outputs(chunk_rb, sched=model.schedules(EVAL_STEP))
    check(len(calls) == 3, f"expected 3 fused_mlp calls per chunk, captured {len(calls)}")
    names = ["proposal_0", "proposal_1", "color"]
    per_call = []
    before = fm.LAUNCHES["fused_mlp_fwd"]
    for name, (x, ws, bs, act, out_act) in zip(names, calls):
        with torch.no_grad():
            y_k = fm.fused_mlp(x, ws, bs, act, out_act)
            y_p = fm.fused_mlp_plain(x, ws, bs, act, out_act)
            torch.cuda.synchronize()
            err = float((y_k - y_p).abs().max())
            scale = float(y_p.abs().max()) + 1.0
            k_ms = cuda_time_ms(lambda: fm.fused_mlp(x, ws, bs, act, out_act))
            p_ms = cuda_time_ms(lambda: fm.fused_mlp_plain(x, ws, bs, act, out_act))
        flop, nbytes, dims, n = mlp_work(x, ws)
        bound_ms = max(flop / FP32_PEAK, nbytes / HBM_RATE) * 1e3
        rec = {"call": name, "rows": n, "dims": dims, "act": act, "flop": flop, "bytes": nbytes,
               "max_abs_err": err, "rel_err": err / scale, "ms": k_ms, "plain_ms": p_ms,
               "bound_ms": bound_ms,
               "bound_by": "operations" if flop / FP32_PEAK >= nbytes / HBM_RATE else "bytes"}
        per_call.append(rec)
        log("kernel", json.dumps(rec))
        # f32 on both sides (no TF32): only the summation order differs, so
        # the error stays within a few K * 2^-24 of the output scale
        check(err / scale <= KERNEL_TOL, f"{name}: kernel vs plain error {err / scale} > {KERNEL_TOL}")
    fm.LAUNCHES["fused_mlp_fwd"] = before  # comparison launches are not the main path's

    # 5. results ------------------------------------------------------------
    kernels = {"kernels": [{
        "name": "fused_mlp_fwd",
        "route": "cuda",
        "source": "sdfstudio_tpu_torch/csrc/fused_mlp_fwd.cu",
        "replaces": "sdfstudio_tpu/ops/pallas_mlp.py:94",
        "launches": launches["fused_mlp_fwd"],
        "max_abs_err": max(r["max_abs_err"] for r in per_call),
        "ms": sum(r["ms"] for r in per_call),
        "plain_ms": sum(r["plain_ms"] for r in per_call),
        "bound_ms": sum(r["bound_ms"] for r in per_call),
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in per_call) else "bytes",
        "library_ms": None,
        "per_chunk_calls": per_call,
        "image_ms": warm_ms,
        "image_device_idle_share_traced": profile["device_idle_share"],
        "build_s": build_s,
    }]}
    log("done", f"total {time.perf_counter() - T0:.1f} s")
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
