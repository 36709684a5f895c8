"""Slope-probe the card's rates for the primitives the grid encode and its
backward are built from (counterpart of
``sdfstudio_tpu/scripts/benchmarking/probe_prims.py``):

* row gather rate against row width, dtype, table size and layout
  (``index_select`` on ``[R, F]``, and on the SOA layout ``[F, R]``),
* segment-add: the port's ``ops/scatter.py`` (``sorted``) against
  ``index_put_(..., accumulate=True)`` (``native``),
* a stable key sort plus the gathers of its payloads.

Each case runs as a Python loop of K iterations whose carry, a 0-dim tensor
on the device, consumes each result, so no iteration can be skipped; nothing
is read back inside the loop, and the call ends in one readback
(``.item()``). The time of a call is the median over 7 calls after 2 warm
ones; rate = work * K / that time.

Usage:  python -m sdfstudio_tpu_torch.scripts.benchmarking.probe_prims \\
            [--only gather|segadd|sort] [--quick] [--device cuda|cpu] [--shrink LOG2]

It runs on ``cuda`` unless given ``--device cpu``. ``--shrink`` divides every
row count by 2**LOG2, for a quick run on the CPU.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from sdfstudio_tpu_torch.ops.scatter import sorted_segment_add
from sdfstudio_tpu_torch.utils.device import resolve_device


def slope_time(fn: Callable[[], float], n_calls: int = 7):
    """Median time of ``n_calls`` calls of ``fn`` after two warm ones, and
    their min..max in ms; ``fn`` must end with a device-to-host readback."""
    fn()
    fn()
    times = []
    for _ in range(n_calls):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    spread = f"[{min(times) * 1e3:.0f}..{max(times) * 1e3:.0f}]"
    return max(med, 1e-9), spread


def scan_call(body: Callable[[torch.Tensor], torch.Tensor], K: int, device: torch.device):
    """One call: ``K`` iterations of ``body`` on a carry that starts at 0 on
    ``device``, then one readback (the reference's ``lax.scan``)."""

    def call() -> float:
        s = torch.zeros((), dtype=torch.float32, device=device)
        for _ in range(K):
            s = body(s)
        return s.item()

    return call


def parity(s: torch.Tensor) -> torch.Tensor:
    """``s.astype(int32) % 2`` of the carry: the offset each iteration adds to
    its indices, so that every iteration depends on the last."""
    return s.to(torch.int32) % 2


def need_even(M: int) -> None:
    """A gather of M rows of ones adds M to the carry. With M even the
    offset ``parity(s)`` stays 0 and an index never reaches R, which
    ``index_select`` would refuse."""
    if M % 2:
        raise ValueError(f"M={M} must be even: with an odd M the carry's parity "
                         "moves an index to R")


def randint(high: int, n: int, device: torch.device, seed: int) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, high, (n,), generator=gen, device=device, dtype=torch.int32)


def log2_label(R: int) -> str:
    return f"2^{int(np.log2(R))}"


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[-1]


def probe_gather(M, R, F, dtype, K, axis, seed=0, device=None):
    dev = resolve_device(device)
    need_even(M)
    idx = randint(R, M, dev, seed)
    if axis == 0:
        table = torch.ones((R, F), dtype=dtype, device=dev)

        def body(s):
            g = table.index_select(0, idx + parity(s))
            return s + g[:, 0].to(torch.float32).sum()

    else:
        table = torch.ones((F, R), dtype=dtype, device=dev)

        def body(s):
            g = table.index_select(1, idx + parity(s))
            return s + g[0].to(torch.float32).sum()

    dt, spread = slope_time(scan_call(body, K, dev))
    rate = M * K / dt
    print(
        f"gather M={M / 1e6:.1f}M R={log2_label(R)} F={F} {dtype_name(dtype)}"
        f" axis={axis}: {rate / 1e6:.0f}M rows/s ({dt * 1e3:.0f} ms/call {spread}, K={K})",
        flush=True,
    )
    return rate


def probe_segment_add(M, R, F, K, kind, device=None, idx: Optional[torch.Tensor] = None):
    """``idx`` replaces the seeded indices. The carry adds the count that
    lands on row 0, so its parity can move an index to R; both kinds add
    into one spare row there and drop it, as the reference drops an update
    out of range."""
    dev = resolve_device(device)
    idx = randint(R, M, dev, 1) if idx is None else idx
    upd = torch.ones((M, F), dtype=torch.float32, device=dev)

    if kind == "sorted":
        def body(s):
            out = sorted_segment_add(idx + parity(s), upd, R)
            return s + out[0, 0]
    else:
        def body(s):
            out = torch.zeros((R + 1, F), dtype=torch.float32, device=dev)
            out.index_put_((idx + parity(s),), upd, accumulate=True)
            return s + out[0, 0]

    dt, spread = slope_time(scan_call(body, K, dev))
    print(
        f"segadd[{kind}] M={M / 1e6:.1f}M R={log2_label(R)} F={F}: "
        f"{M * K / dt / 1e6:.0f}M upd/s ({dt * 1e3:.0f} ms/call {spread}, K={K})",
        flush=True,
    )


def probe_sort(M, n_payload, K, device=None, keys: Optional[torch.Tensor] = None):
    """``keys`` replaces the seeded keys. Every payload is gathered by the
    sort's order, as the reference's multi-operand ``lax.sort`` moves them."""
    dev = resolve_device(device)
    keys0 = randint(1 << 20, M, dev, 2) if keys is None else keys
    payloads = [torch.ones((M,), dtype=torch.float32, device=dev) for _ in range(n_payload)]

    def body(s):
        k, order = torch.sort(keys0 + parity(s), stable=True)
        moved = [p.index_select(0, order) for p in payloads]
        return s + moved[0][0] + k[0].to(torch.float32)

    dt, spread = slope_time(scan_call(body, K, dev))
    print(
        f"sort M={M / 1e6:.1f}M payloads={n_payload}: {M * K / dt / 1e6:.0f}M keys/s "
        f"({dt * 1e3:.0f} ms/call {spread}, K={K})",
        flush=True,
    )


def device_line(dev: torch.device) -> str:
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return f"device={dev} ({name}) torch {torch.__version__}"


def shrinker(log2: int) -> Callable[[int], int]:
    """Row counts divided by 2**log2, at least 16."""
    if log2 < 0:
        raise ValueError(f"--shrink {log2} must be >= 0")
    return lambda rows: max(rows >> log2, 16)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--only", default=None, choices=["gather", "segadd", "sort"])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--shrink", type=int, default=0, metavar="LOG2",
                    help="divide every row count by 2**LOG2")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rows = shrinker(args.shrink)
    print(device_line(dev), flush=True)

    M = rows(4_194_304)  # 4M queries
    K = 8 if not args.quick else 4

    if args.only in (None, "gather"):
        R = rows(1 << 23)  # 8.4M rows (the stacked L16 2^19 table)
        for F in (1, 2, 4, 8, 16, 32):
            probe_gather(M, R, F, torch.float32, K, axis=0, device=dev)
        probe_gather(M, R, 2, torch.bfloat16, K, axis=0, device=dev)
        probe_gather(M, R, 16, torch.bfloat16, K, axis=0, device=dev)
        probe_gather(M, R, 2, torch.float32, K, axis=1, device=dev)  # SOA (the JAX layout)
        probe_gather(M, rows(1 << 17), 2, torch.float32, K, axis=0, device=dev)  # small table
        # a table that fits shared memory
        probe_gather(M, rows(1 << 14), 2, torch.float32, K, axis=0, device=dev)
        probe_gather(M, rows(1 << 19), 8, torch.float32, K, axis=0, device=dev)  # plane-ish
    if args.only in (None, "segadd"):
        probe_segment_add(M, rows(1 << 23), 2, max(K // 2, 2), "sorted", device=dev)
        probe_segment_add(M, rows(1 << 19), 2, max(K // 2, 2), "sorted", device=dev)
        if not args.quick:
            probe_segment_add(M, rows(1 << 19), 2, 2, "native", device=dev)
    if args.only in (None, "sort"):
        probe_sort(M, 1, K, device=dev)
        probe_sort(M, 3, K, device=dev)
        probe_sort(rows(12_582_912), 3, max(K // 2, 2), device=dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
