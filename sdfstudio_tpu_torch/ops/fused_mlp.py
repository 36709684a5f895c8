"""Fully-fused MLP forward: the hand-written CUDA kernel and its plain version.

Replaces the Pallas TPU kernel ``sdfstudio_tpu/ops/pallas_mlp.py::_fwd_kernel``
(launched by ``_fused_mlp_padded_fwd``, public entry ``fused_mlp`` at
pallas_mlp.py:238). It computes, in f32,

    y = out_act(act(... act(x @ W0 + b0) ...) @ Wn + bn)

with ``act`` in relu | softplus100 | none and weights in the JAX layout
``W_i [d_i, d_{i+1}]``.

On this card the function is bound by arithmetic, not bytes: at the render
path's shapes it does 140..900 FLOP per byte of HBM traffic, far above the
FP32 ridge of an H100 (67 TFLOP/s over 3.35 TB/s). The kernel
(``csrc/fused_mlp_fwd.cu``) therefore keeps each 64-row block's activations
in shared memory across the whole chain, streams each layer's weights
through shared memory in K slices (the color net's 580 KB of f32 weights do
not fit a block, unlike the TPU's VMEM), and accumulates on the FP32 cores,
matching the TPU kernel's Precision.HIGHEST. Tensor cores are later work.

``fused_mlp`` takes the plain version for a tensor on the CPU, launches the
kernel for a CUDA tensor, and raises on anything else. There is no backward
kernel yet (pallas_mlp.py:151 ``_fused_mlp_padded_bwd`` is the training
slice's work), so it raises on inputs that require grad.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import torch

ACTIVATIONS = {"none": 0, "relu": 1, "softplus100": 2}

# Launches of each kernel wrapper, counted where the kernel is enqueued.
LAUNCHES: Dict[str, int] = {"fused_mlp_fwd": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _act(x: torch.Tensor, name: str) -> torch.Tensor:
    if name == "relu":
        return torch.relu(x)
    if name == "softplus100":
        # softplus(100 x) * 0.01 as pallas_mlp.py:70-71 writes it
        t = 100.0 * x
        return (torch.clamp(t, min=0.0) + torch.log1p(torch.exp(-torch.abs(t)))) * 0.01
    return x


def fused_mlp_plain(
    x: torch.Tensor,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    activation: str = "relu",
    out_activation: str = "none",
) -> torch.Tensor:
    """The plain PyTorch version of the kernel: the same function, layer by layer."""
    h = x
    n = len(weights)
    for i, (w, b) in enumerate(zip(weights, biases)):
        h = torch.matmul(h, w) + b
        h = _act(h, activation if i < n - 1 else out_activation)
    return h


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
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, *weights, *biases)
    ):
        raise RuntimeError(
            "fused_mlp has no backward kernel yet (the fused-MLP backward is the "
            "training slice's work); call it under torch.no_grad()"
        )


def fused_mlp(
    x: torch.Tensor,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    activation: str = "relu",
    out_activation: str = "none",
) -> torch.Tensor:
    """``x [..., d_in] -> [..., d_out]`` through the whole chain in one kernel
    (pallas_mlp.py:238-302). CPU tensors take :func:`fused_mlp_plain`."""
    _check(x, weights, biases, activation, out_activation)
    if x.device.type == "cpu":
        return fused_mlp_plain(x, weights, biases, activation, out_activation)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp: unsupported device {x.device}")
    return _launch(x, weights, biases, activation, out_activation)


def _launch(x, weights, biases, activation, out_activation) -> torch.Tensor:
    for name, t in [("x", x)] + [(f"W{i}", w) for i, w in enumerate(weights)] + [
        (f"b{i}", b) for i, b in enumerate(biases)
    ]:
        if t.device != x.device:
            raise ValueError(f"fused_mlp: {name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"fused_mlp: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"fused_mlp: {name} must be contiguous")
    from sdfstudio_tpu_torch.utils.cuda_build import load_library

    lib = load_library()
    batch = x.shape[:-1]
    n = x.numel() // x.shape[-1] if x.shape[-1] else 0
    d_out = weights[-1].shape[1]
    y = torch.empty((*batch, d_out), dtype=torch.float32, device=x.device)
    if n == 0:
        return y
    n_layers = len(weights)
    if n_layers > lib.sst_fused_mlp_fwd_max_layers():
        raise ValueError(f"fused_mlp: {n_layers} layers exceed the kernel's limit")
    dims = (ctypes.c_int * (n_layers + 1))(x.shape[-1], *[w.shape[1] for w in weights])
    smem = lib.sst_fused_mlp_fwd_smem_bytes(ctypes.cast(dims, ctypes.c_void_p), n_layers)
    if smem > lib.sst_fused_mlp_fwd_smem_limit():
        raise ValueError(
            f"fused_mlp: widths {list(dims)} need {smem} B of shared memory per block, "
            f"above the card's {lib.sst_fused_mlp_fwd_smem_limit()} B"
        )
    w_ptrs = (ctypes.c_uint64 * n_layers)(*[w.data_ptr() for w in weights])
    b_ptrs = (ctypes.c_uint64 * n_layers)(*[b.data_ptr() for b in biases])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.sst_fused_mlp_fwd(
            x.data_ptr(), y.data_ptr(),
            ctypes.cast(w_ptrs, ctypes.c_void_p), ctypes.cast(b_ptrs, ctypes.c_void_p),
            ctypes.cast(dims, ctypes.c_void_p), n_layers, n,
            ACTIVATIONS[activation], ACTIVATIONS[out_activation], stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_mlp_fwd kernel launch failed: cudaError {err}")
    LAUNCHES["fused_mlp_fwd"] += 1
    return y
