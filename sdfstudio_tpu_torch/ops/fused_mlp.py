"""Fully-fused MLP: the hand-written CUDA kernels, forward and backward, and
their plain versions.

Replaces the Pallas TPU kernels of ``sdfstudio_tpu/ops/pallas_mlp.py``:
``_fwd_kernel`` (launched by ``_fused_mlp_padded_fwd``, public entry
``fused_mlp`` at pallas_mlp.py:238) and ``_fused_mlp_padded_bwd`` (its custom
VJP, pallas_mlp.py:151-235). The forward computes, in f32,

    y = out_act(act(... act(x @ W0 + b0) ...) @ Wn + bn)

with ``act`` in relu | softplus100 | none and weights in the JAX layout
``W_i [d_i, d_{i+1}]``; the backward gives ``dx``, every ``dW_i`` and every
``db_i`` from the cotangent of ``y``.

Design. Both kernels run on Hopper's tensor cores: ``wgmma`` m64nNk8 in
tf32, with every product taken as three tf32 passes (``lo*hi + hi*lo +
hi*hi`` of each operand split into tf32 ``hi`` and ``lo``, 3xTF32), which
keeps the TPU kernel's Precision.HIGHEST: f32 accuracy. Per call, a
pre-pass kernel splits the weights once into a scratch in the tensor cores'
shared-memory layout; a block of 128 rows then keeps its activations in
shared memory across the whole chain while a producer warp streams the
weight slices in with bulk copies (the TMA unit) through a ring of 2-8
stages under mbarriers (``csrc/fused_mlp_chain.cuh``). The forward
(``csrc/fused_mlp_fwd.cu``) is that chain; the backward
(``csrc/fused_mlp_bwd.cu``) rebuilds the forward the same way, runs the
delta chain back through ``W^T``, and sums dW / db over the rows as a
split-K product on the tensor cores, reduced in a fixed order, so its
results repeat bit for bit. Where a rebuilt pre-activation lies too close
to 0 for 3xTF32 to be sure which side of the relu the f32 reference takes,
its row's forward is recomputed exactly in f32 on the CUDA cores first.
The dW of a head (at most 8 columns) stays on the FP32 cores.

Bound. Both are bound by arithmetic: at the slice's shapes they do
140..900 FLOP per byte of HBM traffic. At f32 accuracy the least time is
``3 * FLOP / 495 TFLOP/s`` (three dense tf32 passes on an H100), the
FP32-core bound ``FLOP / 67 TFLOP/s`` is 2.5x that; the backward also
writes and reads back its Z / D scratch.

Limits: at most 16 layers; hidden widths up to 320 (five 64-column tiles
of accumulators per warpgroup); and the widest layer's activations for 128
rows plus two ring stages must fit the 227 KB of shared memory a block may
use (input widths up to about 430). The wrapper raises on anything else.

``fused_mlp`` takes the plain version for tensors on the CPU, launches the
kernels for CUDA tensors, and raises on anything else. Under autograd it is
one ``torch.autograd.Function`` whose backward is the backward kernel (or,
on the CPU, :func:`fused_mlp_bwd_plain`); like the JAX custom VJP it has no
double backward.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable
from torch.profiler import record_function

from sdfstudio_tpu_torch.ops.launches import (  # noqa: F401
    CHAIN_LAUNCHES, LAUNCHES, WIDTH_LAUNCHES, reset_launch_counts)

ACTIVATIONS = {"none": 0, "relu": 1, "softplus100": 2}


def _act(x: torch.Tensor, name: str) -> torch.Tensor:
    if name == "relu":
        return torch.relu(x)
    if name == "softplus100":
        # softplus(100 x) * 0.01 as pallas_mlp.py:70-71 writes it
        t = 100.0 * x
        return (torch.clamp(t, min=0.0) + torch.log1p(torch.exp(-torch.abs(t)))) * 0.01
    return x


def _act_grad(pre: torch.Tensor, name: str) -> torch.Tensor:
    """The activation's derivative from its pre-activation (pallas_mlp.py:74-79)."""
    if name == "relu":
        return (pre > 0).to(pre.dtype)
    if name == "softplus100":
        return torch.sigmoid(100.0 * pre)
    return torch.ones_like(pre)


def fused_mlp_plain(
    x: torch.Tensor,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    activation: str = "relu",
    out_activation: str = "none",
) -> torch.Tensor:
    """The plain PyTorch version of the forward kernel: the same function, layer by layer."""
    h = x
    n = len(weights)
    for i, (w, b) in enumerate(zip(weights, biases)):
        h = torch.matmul(h, w) + b
        h = _act(h, activation if i < n - 1 else out_activation)
    return h


def fused_mlp_bwd_plain(
    x: torch.Tensor,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    g: torch.Tensor,
    activation: str = "relu",
    out_activation: str = "none",
    need_dx: bool = True,
) -> Tuple[Optional[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]:
    """The plain PyTorch version of the backward kernel, the algebra of
    pallas_mlp.py:158-197 written out: recompute the forward, then
    ``d = g * out_act'(pre)``, ``dW_i = a_i^T d``, ``db_i = sum d``,
    ``d <- (d W_i^T) * act'(pre_{i-1})``, ``dx = d W_0^T``.
    ``x [n, d0]`` and ``g [n, dL]`` are 2-D. Returns (dx or None, dWs, dbs)."""
    n_layers = len(weights)
    acts, pres = [x], []
    h = x
    for i, (w, b) in enumerate(zip(weights, biases)):
        pre = torch.matmul(h, w) + b
        pres.append(pre)
        if i < n_layers - 1:
            h = _act(pre, activation)
            acts.append(h)
    d = g * _act_grad(pres[-1], out_activation)
    dws: List[Optional[torch.Tensor]] = [None] * n_layers
    dbs: List[Optional[torch.Tensor]] = [None] * n_layers
    for i in range(n_layers - 1, -1, -1):
        dws[i] = torch.matmul(acts[i].t(), d)
        dbs[i] = torch.sum(d, dim=0)
        if i > 0:
            d = torch.matmul(d, weights[i].t()) * _act_grad(pres[i - 1], activation)
    dx = torch.matmul(d, weights[0].t()) if need_dx else None
    return dx, dws, dbs


def _check(x, weights, biases, activation, out_activation):
    if activation not in ACTIVATIONS or out_activation not in ACTIVATIONS:
        raise ValueError(f"unsupported activation {activation}/{out_activation}")
    if len(weights) != len(biases) or not weights:
        raise ValueError("fused_mlp needs one bias per weight and at least one layer")
    d = x.shape[-1]
    for i, (w, b) in enumerate(zip(weights, biases)):
        if w.ndim != 2 or w.shape[0] != d:
            raise ValueError(f"fused_mlp layer {i}: kernel {tuple(w.shape)} does not take width {d}")
        if tuple(b.shape) != (w.shape[1],):
            raise ValueError(f"fused_mlp layer {i}: bias {tuple(b.shape)} != ({w.shape[1]},)")
        d = w.shape[1]


class _FusedMLP(torch.autograd.Function):
    """One autograd node for the whole chain (the JAX ``_fused_mlp_padded``
    custom VJP): the residuals are (x, W, b), as on the TPU, and the
    backward recomputes the forward inside its kernel."""

    @staticmethod
    def forward(ctx, x2, activation, out_activation, n_layers, *params):
        weights, biases = params[:n_layers], params[n_layers:]
        ctx.save_for_backward(x2, *params)
        ctx.acts = (activation, out_activation, n_layers)
        if x2.device.type == "cpu":
            return fused_mlp_plain(x2, weights, biases, activation, out_activation)
        return _launch(x2, weights, biases, activation, out_activation)

    @staticmethod
    @once_differentiable
    def backward(ctx, gy):
        activation, out_activation, n_layers = ctx.acts
        x2, *params = ctx.saved_tensors
        weights, biases = params[:n_layers], params[n_layers:]
        need_dx = ctx.needs_input_grad[0]
        gy = gy.contiguous()
        if x2.device.type == "cpu":
            dx, dws, dbs = fused_mlp_bwd_plain(x2, weights, biases, gy, activation,
                                               out_activation, need_dx)
        else:
            # the autograd engine runs this on its own thread, outside the
            # caller's profiler ranges: name the kernel's range here
            with record_function("sst/fused_mlp_bwd"):
                dx, dws, dbs = fused_mlp_bwd(x2, weights, biases, gy, activation, out_activation,
                                             need_dx)
        return (dx, None, None, None, *dws, *dbs)


def fused_mlp(
    x: torch.Tensor,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    activation: str = "relu",
    out_activation: str = "none",
) -> torch.Tensor:
    """``x [..., d_in] -> [..., d_out]`` through the whole chain in one kernel
    (pallas_mlp.py:238-302), differentiable in reverse mode. CPU tensors take
    :func:`fused_mlp_plain` and :func:`fused_mlp_bwd_plain`."""
    _check(x, weights, biases, activation, out_activation)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_mlp: unsupported device {x.device}")
    batch = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in (x2, *weights, *biases))):
        if x.device.type == "cpu":
            y = fused_mlp_plain(x2, weights, biases, activation, out_activation)
        else:
            y = _launch(x2, weights, biases, activation, out_activation)
    else:
        y = _FusedMLP.apply(x2, activation, out_activation, len(weights), *weights, *biases)
    return y.reshape(*batch, weights[-1].shape[1])


def _check_cuda(named: Sequence[Tuple[str, torch.Tensor]], device: torch.device, what: str) -> None:
    for name, t in named:
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, x on {device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def _layer_args(weights, biases, d_in):
    n_layers = len(weights)
    dims = (ctypes.c_int * (n_layers + 1))(d_in, *[w.shape[1] for w in weights])
    w_ptrs = (ctypes.c_uint64 * n_layers)(*[w.data_ptr() for w in weights])
    b_ptrs = (ctypes.c_uint64 * n_layers)(*[b.data_ptr() for b in biases])
    return dims, w_ptrs, b_ptrs


def _vp(a) -> ctypes.c_void_p:
    return ctypes.cast(a, ctypes.c_void_p)


def _refuse(what: str, lib, dims, status: int, smem: int, limit_fn) -> None:
    """Raise on what the kernels' tiling cannot take (the workspace status)."""
    if status == 1:
        raise ValueError(f"{what}: {len(dims) - 1} layers exceed the kernel's limit of "
                         f"{lib.sst_fused_mlp_fwd_max_layers()}")
    if status == 2:
        raise ValueError(f"{what}: widths {list(dims)} have a hidden width above the kernel's "
                         f"limit of {lib.sst_fused_mlp_fwd_max_width()}")
    if smem > limit_fn():
        raise ValueError(f"{what}: widths {list(dims)} need {smem} B of shared memory per block, "
                         f"above the card's {limit_fn()} B")


def _launch(x, weights, biases, activation, out_activation) -> torch.Tensor:
    """The forward kernel on 2-D ``x [n, d_in]``."""
    _check_cuda([("x", x)] + [(f"W{i}", w) for i, w in enumerate(weights)]
                + [(f"b{i}", b) for i, b in enumerate(biases)], x.device, "fused_mlp")
    from sdfstudio_tpu_torch.utils.cuda_build import load_library

    lib = load_library()
    n = x.shape[0]
    d_out = weights[-1].shape[1]
    y = torch.empty((n, d_out), dtype=torch.float32, device=x.device)
    if n == 0:
        return y
    n_layers = len(weights)
    dims, w_ptrs, b_ptrs = _layer_args(weights, biases, x.shape[1])
    ws = (ctypes.c_int64 * 3)()
    lib.sst_fused_mlp_fwd_workspace(_vp(dims), n_layers, _vp(ws))
    split_n, smem, status = (int(v) for v in ws)
    _refuse("fused_mlp", lib, dims, status, smem, lib.sst_fused_mlp_fwd_smem_limit)
    split = torch.empty(max(split_n, 1), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.sst_fused_mlp_fwd(
            x.data_ptr(), y.data_ptr(), _vp(w_ptrs), _vp(b_ptrs), split.data_ptr(), _vp(dims),
            n_layers, n, ACTIVATIONS[activation], ACTIVATIONS[out_activation], stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_mlp_fwd kernel launch failed: cudaError {err}")
    LAUNCHES["fused_mlp_fwd"] += 1
    CHAIN_LAUNCHES["fused_mlp_fwd", tuple(dims)] += 1
    return y


def fused_mlp_bwd(
    x: torch.Tensor,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    g: torch.Tensor,
    activation: str = "relu",
    out_activation: str = "none",
    need_dx: bool = True,
) -> Tuple[Optional[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]:
    """The backward kernel on CUDA tensors ``x [n, d0]``, ``g [n, dL]``:
    (dx or None, dWs, dbs), as :func:`fused_mlp_bwd_plain` returns them."""
    _check(x, weights, biases, activation, out_activation)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_bwd: the kernel takes CUDA tensors, got {x.device}")
    if x.ndim != 2 or tuple(g.shape) != (x.shape[0], weights[-1].shape[1]):
        raise ValueError(f"fused_mlp_bwd: x {tuple(x.shape)} and g {tuple(g.shape)} do not match")
    _check_cuda([("x", x), ("g", g)] + [(f"W{i}", w) for i, w in enumerate(weights)]
                + [(f"b{i}", b) for i, b in enumerate(biases)], x.device, "fused_mlp_bwd")
    from sdfstudio_tpu_torch.utils.cuda_build import load_library

    lib = load_library()
    n, n_layers = x.shape[0], len(weights)
    dims, w_ptrs, b_ptrs = _layer_args(weights, biases, x.shape[1])
    ws = (ctypes.c_int64 * 6)()
    lib.sst_fused_mlp_bwd_workspace(_vp(dims), n_layers, max(n, 1), int(need_dx), _vp(ws))
    splits, total, scratch_n, smem, split_n, status = (int(v) for v in ws)
    _refuse("fused_mlp_bwd", lib, dims, status, smem, lib.sst_fused_mlp_bwd_smem_limit)
    dev = x.device
    flat = torch.empty(total, dtype=torch.float32, device=dev)
    dx = torch.empty_like(x) if need_dx else None
    if n == 0:
        flat.zero_()
    else:
        split = torch.empty(max(split_n, 1), dtype=torch.float32, device=dev)
        scratch = torch.empty(scratch_n, dtype=torch.float32, device=dev)
        partial = torch.empty(splits * total, dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.sst_fused_mlp_bwd(
                x.data_ptr(), g.data_ptr(), dx.data_ptr() if need_dx else None,
                _vp(w_ptrs), _vp(b_ptrs), split.data_ptr(), scratch.data_ptr(),
                partial.data_ptr(), flat.data_ptr(), _vp(dims), n_layers, n,
                ACTIVATIONS[activation], ACTIVATIONS[out_activation], stream,
            )
        if err != 0:
            raise RuntimeError(f"fused_mlp_bwd kernel launch failed: cudaError {err}")
        LAUNCHES["fused_mlp_bwd"] += 1
        CHAIN_LAUNCHES["fused_mlp_bwd", tuple(dims)] += 1
    # flat holds dW_0, db_0, dW_1, db_1, ... (csrc/fused_mlp_bwd.cu, plan_dw())
    dws, dbs, off = [], [], 0
    for w in weights:
        k, m = w.shape
        dws.append(flat[off:off + k * m].view(k, m))
        dbs.append(flat[off + k * m:off + k * m + m])
        off += k * m + m
    return dx, dws, dbs
