"""Gather-strategy probes on the card (counterpart of
``sdfstudio_tpu/scripts/benchmarking/probe_gather2.py``): what does a random
row gather cost, and which way of doing it is fastest?

Candidates, each timed as ``probe_prims.slope_time`` times a call (K
iterations of the body on a carry that stays on the device, then one
readback):

  xla1      single-row gather of an [R, F] table, ``index_select`` on axis 0
  pair      slices of 2 consecutive rows at random starts (the additive-x
            hash makes the two x-corners consecutive rows, so 8 corners are
            4 two-row slices): half the random accesses, twice the bytes each
  quad      the same with slices of 4 rows (``pair[4]``)
  onehot    ``onehot(idx) @ table`` in bf16 for small tables: M*R*F
            multiply-adds and an [M, R] one-hot matrix (about 26 GB at
            M = 2^20, R = 2^13)
  pl-take   the hand-written ``take`` kernel (``ops/row_gather.py``): the
            table staged in shared memory where it fits, else read through L2
  pl-loop   the hand-written ``loop`` kernel: a serial walk over each 1024-row
            tile's indices, table in shared memory

The case names are the reference's, so its lines and these compare by name.

Usage: python -m sdfstudio_tpu_torch.scripts.benchmarking.probe_gather2 \\
          [--only xla1,pair,...] [--quick] [--device cuda|cpu] [--shrink LOG2]

It runs on ``cuda`` unless given ``--device cpu``. A probe that fails
raises. ``--shrink`` divides every row count by 2**LOG2, for a quick run on
the CPU.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from sdfstudio_tpu_torch.ops import row_gather
from sdfstudio_tpu_torch.scripts.benchmarking.probe_prims import (
    device_line,
    dtype_name,
    log2_label,
    need_even,
    parity,
    randint,
    scan_call,
    shrinker,
    slope_time,
)
from sdfstudio_tpu_torch.utils.device import resolve_device


def _scan_rate(body, K, work, label, device):
    """body: carry -> carry. Prints and returns rate = work * K / time."""
    dt, spread = slope_time(scan_call(body, K, device))
    rate = work * K / dt
    print(f"{label}: {rate / 1e6:.0f}M rows/s ({dt * 1e3:.1f} ms/call {spread}, K={K})",
          flush=True)
    return rate


def probe_xla1(M, R, F, K, dtype=torch.float32, device=None):
    dev = resolve_device(device)
    need_even(M)
    idx = randint(R, M, dev, 0)
    table = torch.ones((R, F), dtype=dtype, device=dev)

    def body(s):
        g = table.index_select(0, idx + parity(s))
        return s + g[:, 0].to(torch.float32).sum()

    label = f"xla1 M={M / 1e6:.1f}M R={log2_label(R)} F={F} {dtype_name(dtype)}"
    return _scan_rate(body, K, M, label, dev)


def probe_pair(M, R, F, K, slice_rows=2, dtype=torch.float32, device=None):
    """Slices of ``slice_rows`` consecutive rows at random starts, the
    starts clamped to [0, R - slice_rows] as lax.gather's CLIP mode does."""
    dev = resolve_device(device)
    n_slices = M // slice_rows
    starts = randint(R - slice_rows, n_slices, dev, 0)
    table = torch.ones((R, F), dtype=dtype, device=dev)
    windows = table.unfold(0, slice_rows, 1)  # [R - slice_rows + 1, F, slice_rows], a view

    def body(s):
        st = (starts + parity(s)).clamp(0, R - slice_rows)
        g = windows.index_select(0, st)  # [n_slices, F, slice_rows]
        return s + g[:, 0, 0].to(torch.float32).sum()

    return _scan_rate(
        body, K, M,
        f"pair[{slice_rows}] M={M / 1e6:.1f}M R={log2_label(R)} F={F} "
        f"{dtype_name(dtype)} ({n_slices / 1e6:.1f}M slices)",
        dev,
    )


def probe_onehot(M, R, F, K, dtype=torch.bfloat16, device=None):
    """Gather as a one-hot matmul; the rows come out exact (one 1 per row)."""
    dev = resolve_device(device)
    idx = randint(R, M, dev, 0)
    table = torch.ones((R, F), dtype=dtype, device=dev)
    cols = torch.arange(R, dtype=torch.int32, device=dev)

    def body(s):
        i = idx + parity(s)
        oh = (i[:, None] == cols[None, :]).to(dtype)  # [M, R]
        g = torch.matmul(oh, table).to(torch.float32)  # [M, F]
        return s + g[:, 0].sum()

    return _scan_rate(body, K, M, f"onehot M={M / 1e6:.1f}M R={log2_label(R)} F={F}", dev)


def probe_pallas_take(M, R, F, K, device=None):
    dev = resolve_device(device)
    idx = randint(R, M, dev, 0)
    table = torch.ones((R, F), dtype=torch.float32, device=dev)

    def body(s):
        g = row_gather.take(table, idx + parity(s))
        return s + g[:, 0].sum()

    return _scan_rate(body, K, M, f"pl-take M={M / 1e6:.1f}M R={log2_label(R)} F={F}", dev)


def probe_pallas_loop(M, R, F, K, device=None):
    dev = resolve_device(device)
    idx = randint(R, M, dev, 0)
    table = torch.ones((R, F), dtype=torch.float32, device=dev)

    def body(s):
        g = row_gather.loop(table, idx + parity(s))
        return s + g[:, 0].sum()

    return _scan_rate(body, K, M, f"pl-loop M={M / 1e6:.1f}M R={log2_label(R)} F={F}", dev)


CASES = ("xla1", "pair", "onehot", "pl-take", "pl-loop")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None, help="comma-separated of " + ",".join(CASES))
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--shrink", type=int, default=0, metavar="LOG2",
                    help="divide every row count by 2**LOG2")
    args = ap.parse_args(argv)
    only = args.only.split(",") if args.only else None
    unknown = sorted(set(only or ()) - set(CASES))
    if unknown:
        ap.error(f"unknown cases {unknown}; choose from {list(CASES)}")
    dev = resolve_device(args.device)
    rows = shrinker(args.shrink)
    print(device_line(dev), flush=True)

    M = rows(4_194_304)
    K = 4 if args.quick else 8

    def want(name):
        return only is None or name in only

    if want("xla1"):
        probe_xla1(M, rows(1 << 19), 2, K, device=dev)
        probe_xla1(M, rows(1 << 14), 2, K, device=dev)  # a table that fits shared memory
        probe_xla1(M, rows(1 << 19), 4, K, device=dev)
        probe_xla1(M, rows(1 << 19), 8, K, device=dev)
    if want("pair"):
        probe_pair(M, rows(1 << 19), 2, K, slice_rows=2, device=dev)
        probe_pair(M, rows(1 << 19), 2, K, slice_rows=4, device=dev)
        probe_pair(M, rows(1 << 19), 4, K, slice_rows=2, device=dev)
        probe_pair(M, rows(1 << 19), 2, K, slice_rows=2, dtype=torch.bfloat16, device=dev)
    if want("onehot"):
        probe_onehot(M // 4, rows(1 << 11), 2, max(K // 2, 2), device=dev)
        probe_onehot(M // 4, rows(1 << 12), 2, max(K // 2, 2), device=dev)
        probe_onehot(M // 4, rows(1 << 13), 2, 2, device=dev)
    if want("pl-take"):
        probe_pallas_take(M, rows(1 << 14), 2, K, device=dev)
        probe_pallas_take(M, rows(1 << 19), 2, K, device=dev)
    if want("pl-loop"):
        probe_pallas_loop(rows(1 << 20), rows(1 << 14), 2, 2, device=dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
