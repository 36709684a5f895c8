"""Launch counts of the port's CUDA kernels.

Each kernel wrapper adds one to its entry where it enqueues its kernel, and
nowhere else, so a run can show which kernels its path went through.
"""
from __future__ import annotations

from typing import Dict

LAUNCHES: Dict[str, int] = {
    "fused_mlp_fwd": 0,
    "fused_mlp_bwd": 0,
    "row_gather_take": 0,
    "row_gather_loop": 0,
    "hash_encode_fwd": 0,
    "hash_encode_bwd": 0,
    "hash_encode_bwd_det": 0,
    "hash_segment_sum": 0,
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
