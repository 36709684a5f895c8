"""Launch counts of the port's CUDA kernels.

Each kernel wrapper adds one to its entry where it enqueues its kernel, and
nowhere else, so a run can show which kernels its path went through.
"""
from __future__ import annotations

import collections
from typing import Dict, Tuple

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

# the fused-MLP kernels' launches by chain: (kernel, layer widths) -> count,
# added to at the same place as LAUNCHES
CHAIN_LAUNCHES: Dict[Tuple[str, Tuple[int, ...]], int] = collections.Counter()

# the hash-grid kernels' launches by feature width: (kernel, F) -> count,
# added to at the same place as LAUNCHES
WIDTH_LAUNCHES: Dict[Tuple[str, int], int] = collections.Counter()


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    CHAIN_LAUNCHES.clear()
    WIDTH_LAUNCHES.clear()
