"""Row gathers: the hand-written CUDA kernels ``take`` and ``loop``, and their
plain versions.

Replaces the Pallas TPU kernels of
``sdfstudio_tpu/scripts/benchmarking/probe_gather2.py``: ``probe_pallas_take``
(:117, ``jnp.take`` of a table held on chip) and ``probe_pallas_loop`` (:149,
a scalar loop of single-row reads). Both compute, for an f32 table
``[R, F]`` and int32 indices ``[M]``,

    out[r, :] = table[idx[r], :]

and differ only at an index of R, one past the table, which the probes can
make (``idx + s % 2``): ``take`` gives a row of NaN there (``jnp.take``'s
fill mode), ``loop`` gives row R-1 (its ref read clamps). Both read -1 as row
R-1. The contract is indices in [0, R].

On this card both are bound by the latency of random row reads, not by
arithmetic; ``csrc/row_gather.cu`` says how each kernel is laid out. The
wrappers take the plain version for tensors on the CPU, launch the kernel
for CUDA tensors, and raise on anything else.
"""
from __future__ import annotations

import torch

from sdfstudio_tpu_torch.ops.launches import LAUNCHES


def take_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plain version of the ``take`` kernel: NaN rows at index R."""
    R = table.shape[0]
    rows = table[idx.clamp(max=R - 1)]
    return torch.where((idx < R).unsqueeze(-1), rows, float("nan"))


def loop_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plain version of the ``loop`` kernel: index R reads row R-1."""
    return table[idx.clamp(max=table.shape[0] - 1)]


def _check(table: torch.Tensor, idx: torch.Tensor, what: str) -> None:
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {table.device}")
    if idx.device != table.device:
        raise ValueError(f"{what}: idx is on {idx.device}, table on {table.device}")
    if table.dtype != torch.float32 or idx.dtype != torch.int32:
        raise ValueError(f"{what}: needs a float32 table and int32 indices, got "
                         f"{table.dtype} and {idx.dtype}")
    if table.ndim != 2 or idx.ndim != 1 or table.shape[0] < 1 or table.shape[1] < 1:
        raise ValueError(f"{what}: needs table [R, F] and idx [M], got {tuple(table.shape)} "
                         f"and {tuple(idx.shape)}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{what}: table and idx must be contiguous")


def _launch(name: str, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    from sdfstudio_tpu_torch.utils.cuda_build import load_library

    lib = load_library()
    (R, F), M = table.shape, idx.shape[0]
    out = torch.empty((M, F), dtype=torch.float32, device=table.device)
    if M == 0:
        return out
    with torch.cuda.device(table.device):
        if name == "row_gather_loop":
            need, limit = lib.sst_row_gather_loop_smem_bytes(R, F), lib.sst_row_gather_smem_limit()
            if need > limit:
                raise ValueError(f"loop: a table of {R} x {F} floats needs {need} B of shared "
                                 f"memory, above the card's {limit} B per block")
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = getattr(lib, f"sst_{name}")(table.data_ptr(), idx.data_ptr(), out.data_ptr(), R, F, M,
                                          stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    LAUNCHES[name] += 1
    return out


def take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out [M, F]``: row ``idx[r]`` of ``table [R, F]`` for idx in [0, R),
    a row of NaN for R (probe_gather2.py:123)."""
    _check(table, idx, "take")
    if table.device.type == "cpu":
        return take_plain(table, idx)
    return _launch("row_gather_take", table, idx)


def loop(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out [M, F]``: row ``idx[r]`` of ``table [R, F]`` for idx in [0, R),
    row R-1 for R (probe_gather2.py:155). On the card the table must fit a
    block's shared memory."""
    _check(table, idx, "loop")
    if table.device.type == "cpu":
        return loop_plain(table, idx)
    return _launch("row_gather_loop", table, idx)
