"""Multi-resolution hash-grid encode: the hand-written CUDA kernels, forward
and table gradient, and their plain versions.

This replaces XLA code of the JAX package, not a Pallas kernel: the encode
of ``HashEncoding.__call__`` (``sdfstudio_tpu/ops/encodings.py:349-434``:
corner indices, smoothstep weights, the gather, the trilinear blend and the
analytic jacobian) and the custom VJP of ``table_gather``
(encodings.py:206-242: the corner cotangents scattered into an f32 table
gradient). For positions ``x [N, 3]`` in ``[0, 1]`` and a table
``[R, F]``, level ``l`` at resolution ``r_l`` gives

    out[n, l*F + f]        = sum_c w_c(x) * table[idx_c(x), f]
    jac[n, l*F + f, a]     = sum_c dw_c/dx_a(x) * table[idx_c(x), f]
    dtable[idx_c(x), f]   += w_c g_out[n, l*F + f] + sum_a dw_c/dx_a g_jac[n, l*F + f, a]

over the 8 corners ``c`` of the cell of ``x * r_l``: bit ``b`` of ``c``
takes the ceiling on axis ``b``. A level whose ``(r+1)^3`` fits
``2^log2_hashmap_size`` rows is indexed densely, the others by the xor-prime
hash in ``uint32`` arithmetic; each level's rows start at its offset in the
stacked table. Dense indices are not reduced mod the level size: at ``x =
1.0`` the far corner reads the next level's rows, with weight 0, as in JAX.
JAX adds the level offset in int32, and ``jnp.take`` reads a negative index
from the table's end: a dense corner at -1 (a position just below 0, such as
a numerical-gradient tap past a face) wraps to a large uint32 ``i``, which
reads row ``i + R`` (mod 2^32) here as there (:func:`table_rows`). An index
that is still at or past ``R`` reads a row of NaN (``jnp.take``'s fill mode)
and its gradient is dropped.

On the card both kernels (``csrc/hash_grid.cu``) take F = 2, 4 and 8.
They are bound by the memory system: the forward by its 8 random table
reads a level (a 32-byte L2 sector for a row of 8, 16 or 32 bytes) and its
``out`` / ``jac`` streams; the backward by the rate of the atomic units.
The forward runs a thread per point and level. The backward takes tiles
of points whose warps take 32 consecutive points (a ray's neighbouring
samples) at one level, so that lanes in one coarse cell add their sum
with one reduction, and x-neighbouring rows that form an aligned pair
take one float4 reduction. Under ``torch.use_deterministic_algorithms(True)``
the table gradient takes a path whose result repeats bit for bit
(:func:`hash_encode_bwd_det`): a kernel writes every corner's row and
update, ``torch.sort(stable=True)`` orders them (the sort gives the order
only), and a segment-sum kernel adds each row's run in an order fixed by
the sorted rows.

``hash_encode`` takes the plain versions for tensors on the CPU, launches
the kernels for CUDA tensors, and raises on anything else. Under autograd
the encode is one ``torch.autograd.Function`` whose backward gives the
table's gradient from the cotangents of ``out`` and ``jac``. An ``x`` that
requires a gradient gets the one JAX takes through its plain ``jnp`` blend
(encodings.py:370-399): the density methods' sample positions depend on
the camera optimizer's pose table. The forward kernel then writes ``jac``
too, and a second node contracts ``grad_x[n, a] = sum_k g_out[n, k]
jac[n, k, a]`` in plain PyTorch (XLA code in JAX, under the profiler range
``sst/hash_grad_x``); a cotangent of ``jac`` (a caller that takes it, or a
loss on a gradient in ``x``, as nerfacto's ``predict_normals`` has) adds the
weights' second derivative (:func:`hash_jac_vjp_x`, plain PyTorch).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable
from torch.profiler import record_function

from sdfstudio_tpu_torch.ops.launches import LAUNCHES, WIDTH_LAUNCHES
from sdfstudio_tpu_torch.ops.permuto import _MASK32, _mul_u32
from sdfstudio_tpu_torch.ops.encodings import HASH_PRIMES

KERNEL_FEATURES = (2, 4, 8)  # features per level the kernels take
MAX_LEVELS = 32  # csrc/hash_grid.cu kMaxLevels

# corner c takes the ceiling on axis b where bit b of c is set (encodings.py:375-378)
_CORNER_BITS = [[(c >> b) & 1 for b in range(3)] for c in range(8)]


@dataclasses.dataclass(frozen=True)
class HashGridSpec:
    """The level table of one hash grid (``HashEncoding``'s sizes,
    encodings.py:306-326): per level its resolution, whether it is indexed
    densely, and the offset of its rows in the stacked table."""

    resolutions: Tuple[int, ...]
    offsets: Tuple[int, ...]
    dense: Tuple[bool, ...]
    log2_hashmap_size: int
    smoothstep: bool

    @property
    def num_levels(self) -> int:
        return len(self.resolutions)


def corner_indices(x: torch.Tensor, spec: HashGridSpec):
    """(idx [N, L, 8] int64 holding the uint32 row index, offset [N, L, 3])
    for ``x [N, 3]`` (encodings.py:328-370); int64 arithmetic masked to 32
    bits wraps as JAX's ``uint32`` does."""
    dev = x.device
    res = torch.tensor(spec.resolutions, dtype=x.dtype, device=dev)
    scaled = x[:, None, :] * res[:, None]  # [N, L, 3]
    floor = torch.floor(scaled)
    offset = scaled - floor
    bits = torch.tensor(_CORNER_BITS, dtype=torch.int64, device=dev)  # [8, 3]
    u = (floor.to(torch.int64)[:, :, None, :] + bits) & _MASK32  # [N, L, 8, 3]
    hashed = (_mul_u32(u[..., 0], HASH_PRIMES[0]) ^ _mul_u32(u[..., 1], HASH_PRIMES[1])
              ^ _mul_u32(u[..., 2], HASH_PRIMES[2])) % (1 << spec.log2_hashmap_size)
    stride = torch.tensor(spec.resolutions, dtype=torch.int64, device=dev)[:, None] + 1  # [L, 1]
    dense = u[..., 0] + u[..., 1] * stride + u[..., 2] * stride * stride
    is_dense = torch.tensor(spec.dense, dtype=torch.bool, device=dev)[:, None]
    level_offset = torch.tensor(spec.offsets, dtype=torch.int64, device=dev)[:, None]
    idx = (torch.where(is_dense, dense, hashed) + level_offset) & _MASK32
    return idx, offset


def corner_weights(offset: torch.Tensor, spec: HashGridSpec, want_jac: bool):
    """(weights [N, L, 8], d weights / dx [N, L, 8, 3] or None) from the
    in-cell offsets (encodings.py:372-430): smoothstep or linear per axis,
    the product over the axes, and for the jacobian the exclusive products
    (no division: a factor can be 0)."""
    o = offset
    if spec.smoothstep:
        w = o * o * (3.0 - 2.0 * o)
        dw = 6.0 * o * (1.0 - o)
    else:
        w = o
        dw = torch.ones_like(o)
    bits = torch.tensor(_CORNER_BITS, dtype=torch.bool, device=o.device)  # [8, 3]
    cw = torch.where(bits, w[..., None, :], 1.0 - w[..., None, :])  # [N, L, 8, 3]
    weights = cw[..., 0] * cw[..., 1] * cw[..., 2]
    if not want_jac:
        return weights, None
    res = torch.tensor(spec.resolutions, dtype=o.dtype, device=o.device)
    sign = bits.to(o.dtype) * 2.0 - 1.0
    pexcl = torch.stack([cw[..., 1] * cw[..., 2], cw[..., 0] * cw[..., 2],
                         cw[..., 0] * cw[..., 1]], dim=-1)
    dweights = sign * dw[..., None, :] * pexcl * res[:, None, None]
    return weights, dweights


def table_rows(idx: torch.Tensor, rows: int) -> torch.Tensor:
    """The table row each uint32 corner index reads, as ``jnp.take`` reads
    JAX's int32 index: a negative one (bit 31 set) from the table's end;
    a result at or past ``rows`` reads NaN. ``rows`` is below 2^31."""
    return torch.where(idx < rows, idx, (idx + rows) & _MASK32)


def _gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` (negative int32 indices from the end) with a row of NaN
    at an index still at or past the table's end."""
    R = table.shape[0]
    idx = table_rows(idx, R)
    rows = table[idx.clamp(max=R - 1)]
    return torch.where((idx < R)[..., None], rows, float("nan"))


def hash_encode_plain(x: torch.Tensor, table: torch.Tensor, spec: HashGridSpec,
                      want_jac: bool = False):
    """The plain version of the forward kernel: ``x [N, 3]`` -> ``out [N, L*F]``
    and, with ``want_jac``, ``jac [N, L*F, 3]`` (encodings.py:349-434)."""
    N, LF = x.shape[0], spec.num_levels * table.shape[1]
    idx, offset = corner_indices(x, spec)
    weights, dweights = corner_weights(offset, spec, want_jac)
    feats = _gather_rows(table, idx)  # [N, L, 8, F]
    out = torch.einsum("nlc,nlcf->nlf", weights, feats).reshape(N, LF)
    if not want_jac:
        return out
    jac = torch.einsum("nlca,nlcf->nlfa", dweights, feats).reshape(N, LF, 3)
    return out, jac


def corner_updates(x: torch.Tensor, g_out: Optional[torch.Tensor],
                   g_jac: Optional[torch.Tensor], spec: HashGridSpec):
    """(rows [N*L*8] int64, updates [N*L*8, F]): each corner's row and the
    cotangent it adds there, ``w_c g_out + sum_a dw_c/dx_a g_jac[..., a]``,
    from ``g_out [N, L*F]`` and ``g_jac [N, L*F, 3]`` (either may be None)."""
    N, L = x.shape[0], spec.num_levels
    g = g_out if g_out is not None else g_jac
    F = g.shape[1] // L
    idx, offset = corner_indices(x, spec)
    weights, dweights = corner_weights(offset, spec, g_jac is not None)
    upd = torch.zeros((N, L, 8, F), dtype=g.dtype, device=x.device)
    if g_out is not None:
        upd = upd + weights[..., None] * g_out.reshape(N, L, 1, F)
    if g_jac is not None:
        upd = upd + torch.einsum("nlca,nlfa->nlcf", dweights, g_jac.reshape(N, L, F, 3))
    return idx.reshape(-1), upd.reshape(-1, F)


def hash_encode_bwd_plain(x: torch.Tensor, g_out: Optional[torch.Tensor],
                          g_jac: Optional[torch.Tensor], spec: HashGridSpec,
                          rows: int) -> torch.Tensor:
    """The plain version of the backward kernel: the f32 table gradient
    ``[rows, F]`` from the cotangents ``g_out [N, L*F]`` and ``g_jac
    [N, L*F, 3]`` (either may be None), summed with ``sorted_segment_add``
    (f32 ``index_add_``; encodings.py:220-240). A negative int32 index adds
    to the row it reads (:func:`table_rows`); updates at a row still at or
    past ``rows`` are dropped."""
    from sdfstudio_tpu_torch.ops.scatter import sorted_segment_add

    idx, upd = corner_updates(x, g_out, g_jac, spec)
    idx = table_rows(idx, rows)
    return sorted_segment_add(torch.where(idx < rows, idx, rows), upd, rows)


# ---- the kernels --------------------------------------------------------------


def _check(x: torch.Tensor, table: torch.Tensor, spec: HashGridSpec) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"hash_encode: unsupported device {x.device}")
    if table.device != x.device:
        raise ValueError(f"hash_encode: x is on {x.device}, the table on {table.device}")
    dtypes = (torch.float32, torch.float64) if x.device.type == "cpu" else (torch.float32,)
    if x.dtype != table.dtype or x.dtype not in dtypes:
        raise ValueError(f"hash_encode: needs float32 x and table (or float64 both, on the CPU), "
                         f"got {x.dtype} and {table.dtype}")
    if x.shape[-1] != 3 or table.ndim != 2 or table.shape[0] < 1:
        raise ValueError(f"hash_encode: needs x [..., 3] and a table [R, F], got {tuple(x.shape)} "
                         f"and {tuple(table.shape)}")
    if table.shape[0] >= 2**31:
        raise ValueError(f"hash_encode: {table.shape[0]} rows; JAX indexes the table in int32")
    if not 1 <= spec.num_levels <= MAX_LEVELS:
        raise ValueError(f"hash_encode: {spec.num_levels} levels, the kernels take 1-{MAX_LEVELS}")


def _level_args(spec: HashGridSpec):
    L = spec.num_levels
    return ((ctypes.c_int * L)(*spec.resolutions), (ctypes.c_uint32 * L)(*spec.offsets),
            (ctypes.c_int * L)(*[int(d) for d in spec.dense]))


def _check_cuda(what: str, tensors, F: int) -> None:
    """Every tensor a contiguous f32 CUDA tensor; all but ``x`` (read as
    floats) 16-byte aligned, since the kernels move a pair of F = 2 rows,
    an F = 4 row, each half of an F = 8 row and the tiles of the cotangents
    as 16-byte vectors."""
    if F not in KERNEL_FEATURES:
        raise ValueError(f"{what}: the kernels take {KERNEL_FEATURES} features per level, got {F}")
    for name, t in tensors:
        if t is None:
            continue
        if t.device.type != "cuda" or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous float32 CUDA tensor, got "
                             f"{t.dtype} on {t.device}")
        if name != "x" and t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")


def hash_encode_fwd(x: torch.Tensor, table: torch.Tensor, spec: HashGridSpec,
                    want_jac: bool = False):
    """The forward kernel on CUDA tensors ``x [N, 3]``, ``table [R, F]``:
    ``out [N, L*F]`` and, with ``want_jac``, ``jac [N, L*F, 3]``, as
    :func:`hash_encode_plain` returns them."""
    from sdfstudio_tpu_torch.utils.cuda_build import load_library

    N, (R, F), L = x.shape[0], table.shape, spec.num_levels
    _check_cuda("hash_encode_fwd", [("x", x), ("table", table)], F)
    out = torch.empty((N, L * F), dtype=torch.float32, device=x.device)
    jac = torch.empty((N, L * F, 3), dtype=torch.float32, device=x.device) if want_jac else None
    if N > 0:
        lib = load_library()
        res, offs, dense = _level_args(spec)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = lib.sst_hash_encode_fwd(
                x.data_ptr(), table.data_ptr(), out.data_ptr(),
                jac.data_ptr() if want_jac else None, N, R, F, L, res, offs, dense,
                spec.log2_hashmap_size, int(spec.smoothstep), stream)
        if err != 0:
            raise RuntimeError(f"hash_encode_fwd kernel launch failed: cudaError {err}")
        LAUNCHES["hash_encode_fwd"] += 1
        WIDTH_LAUNCHES["hash_encode_fwd", F] += 1
    return (out, jac) if want_jac else out


def hash_encode_bwd(x: torch.Tensor, g_out: Optional[torch.Tensor], g_jac: Optional[torch.Tensor],
                    spec: HashGridSpec, rows: int) -> torch.Tensor:
    """The backward kernel on CUDA tensors: the f32 table gradient
    ``[rows, F]``, as :func:`hash_encode_bwd_plain` returns it. The atomics
    add in an order that changes from run to run; under
    ``torch.use_deterministic_algorithms(True)`` this takes
    :func:`hash_encode_bwd_det` instead, whose result repeats bit for bit."""
    if torch.are_deterministic_algorithms_enabled():
        return hash_encode_bwd_det(x, g_out, g_jac, spec, rows)
    from sdfstudio_tpu_torch.utils.cuda_build import load_library

    g = g_out if g_out is not None else g_jac
    N, L = x.shape[0], spec.num_levels
    F = g.shape[1] // L
    _check_cuda("hash_encode_bwd", [("x", x), ("g_out", g_out), ("g_jac", g_jac)], F)
    grad = torch.zeros((rows, F), dtype=torch.float32, device=x.device)
    if N > 0:
        lib = load_library()
        res, offs, dense = _level_args(spec)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = lib.sst_hash_encode_bwd(
                x.data_ptr(), g_out.data_ptr() if g_out is not None else None,
                g_jac.data_ptr() if g_jac is not None else None, grad.data_ptr(), N, rows, F, L,
                res, offs, dense, spec.log2_hashmap_size, int(spec.smoothstep), stream)
        if err != 0:
            raise RuntimeError(f"hash_encode_bwd kernel launch failed: cudaError {err}")
        LAUNCHES["hash_encode_bwd"] += 1
        WIDTH_LAUNCHES["hash_encode_bwd", F] += 1
    return grad


def hash_corner_rows(x: torch.Tensor, g_out: Optional[torch.Tensor],
                     g_jac: Optional[torch.Tensor], spec: HashGridSpec, rows: int):
    """The corner-rows kernel on CUDA tensors: (keys [N*L*8] int32, upd
    [N*L*8, F]), each corner's row (:func:`table_rows` of its index, and
    ``rows`` for one still past the table) and the cotangent it adds there,
    at entry ``(p L + l) 8 + c``, as :func:`corner_updates` gives them."""
    from sdfstudio_tpu_torch.utils.cuda_build import load_library

    g = g_out if g_out is not None else g_jac
    N, L = x.shape[0], spec.num_levels
    F = g.shape[1] // L
    _check_cuda("hash_corner_rows", [("x", x), ("g_out", g_out), ("g_jac", g_jac)], F)
    if rows >= 2**31 - 1:
        raise ValueError(f"hash_corner_rows: {rows} rows, the sort keys are int32")
    M = N * L * 8
    keys = torch.empty(M, dtype=torch.int32, device=x.device)
    upd = torch.empty((M, F), dtype=torch.float32, device=x.device)
    if N > 0:
        lib = load_library()
        res, offs, dense = _level_args(spec)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = lib.sst_hash_corner_rows(
                x.data_ptr(), g_out.data_ptr() if g_out is not None else None,
                g_jac.data_ptr() if g_jac is not None else None, keys.data_ptr(), upd.data_ptr(),
                N, rows, F, L, res, offs, dense, spec.log2_hashmap_size, int(spec.smoothstep),
                stream)
        if err != 0:
            raise RuntimeError(f"hash_corner_rows kernel launch failed: cudaError {err}")
        LAUNCHES["hash_encode_bwd_det"] += 1
        WIDTH_LAUNCHES["hash_encode_bwd_det", F] += 1
    return keys, upd


def hash_segment_sum(sorted_keys: torch.Tensor, perm: torch.Tensor, upd: torch.Tensor,
                     rows: int) -> torch.Tensor:
    """The segment-sum kernel on CUDA tensors: ``[rows, F]`` whose row r is
    the sum, in sorted order, of ``upd[perm[j]]`` over the run of
    ``sorted_keys[j] == r``; keys of ``rows`` are dropped. The sum's order
    is fixed, so the result repeats bit for bit."""
    from sdfstudio_tpu_torch.utils.cuda_build import load_library

    M, F = upd.shape
    _check_cuda("hash_segment_sum", [("upd", upd)], F)
    if sorted_keys.dtype != torch.int32 or perm.dtype != torch.int64 or sorted_keys.shape != (M,) \
            or perm.shape != (M,) or not (sorted_keys.is_contiguous() and perm.is_contiguous()):
        raise ValueError("hash_segment_sum: needs contiguous int32 keys and int64 perm of "
                         f"{M} entries, got {sorted_keys.dtype} {tuple(sorted_keys.shape)} and "
                         f"{perm.dtype} {tuple(perm.shape)}")
    grad = torch.zeros((rows, F), dtype=torch.float32, device=upd.device)
    if M > 0:
        lib = load_library()
        with torch.cuda.device(upd.device):
            stream = torch.cuda.current_stream(upd.device).cuda_stream
            err = lib.sst_hash_segment_sum(sorted_keys.data_ptr(), perm.data_ptr(), upd.data_ptr(),
                                           grad.data_ptr(), M, rows, F, stream)
        if err != 0:
            raise RuntimeError(f"hash_segment_sum kernel launch failed: cudaError {err}")
        LAUNCHES["hash_segment_sum"] += 1
        WIDTH_LAUNCHES["hash_segment_sum", F] += 1
    return grad


def hash_encode_bwd_det(x: torch.Tensor, g_out: Optional[torch.Tensor],
                        g_jac: Optional[torch.Tensor], spec: HashGridSpec,
                        rows: int) -> torch.Tensor:
    """The table gradient on CUDA tensors in an order that does not change
    from run to run: :func:`hash_corner_rows`, a stable ``torch.sort`` of
    the rows (it gives their order only), and :func:`hash_segment_sum`,
    which adds each row's run in that order (the corners' own)."""
    keys, upd = hash_corner_rows(x, g_out, g_jac, spec, rows)
    sorted_keys, perm = torch.sort(keys, stable=True)
    return hash_segment_sum(sorted_keys, perm, upd, rows)


def _aligned(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``t`` contiguous and 16-byte aligned (a copy where it is not)."""
    if t is None:
        return None
    t = t.contiguous()
    return t if t.device.type == "cpu" or t.data_ptr() % 16 == 0 else t.clone()


def hash_jac_vjp_x(x: torch.Tensor, table: torch.Tensor, spec: HashGridSpec,
                   g_jac: torch.Tensor) -> torch.Tensor:
    """``sum_{k,a} g_jac[n, k, a] d jac[n, k, a] / dx`` [N, 3]: the part of
    the gradient in ``x`` that the jacobian's cotangent carries, through the
    weights' second derivatives (the floor and the corner rows are
    constant in ``x``, as in JAX). Plain PyTorch on either device: only a
    loss on a gradient in ``x`` (nerfacto's ``predict_normals``) or a caller
    that takes ``jac`` and a gradient in ``x`` at once reaches it; it takes
    no further derivative."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        idx, offset = corner_indices(xg, spec)
        _, dweights = corner_weights(offset, spec, True)
        feats = _gather_rows(table.detach(), idx)
        jac = torch.einsum("nlca,nlcf->nlfa", dweights, feats)
        return torch.autograd.grad(jac, xg, g_jac.detach().reshape(jac.shape))[0]


class _HashEncode(torch.autograd.Function):
    """One autograd node for the encode (the JAX custom VJP of
    ``table_gather`` with the blend around it): the residual is ``x``, from
    which the backward rebuilds the corners and weights. Its gradient in
    ``x`` is the jacobian cotangent's part only (:func:`hash_jac_vjp_x`);
    :class:`_HashGradX` adds the ``out`` cotangent's."""

    @staticmethod
    def forward(ctx, x, table, spec, want_jac):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, table)
        ctx.spec, ctx.rows = spec, table.shape[0]
        if x.device.type == "cpu":
            return hash_encode_plain(x, table.detach(), spec, want_jac)
        return hash_encode_fwd(x, table.detach(), spec, want_jac)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_out, g_jac=None):
        x, table = ctx.saved_tensors
        if g_out is None and g_jac is None:
            return None, None, None, None
        grad = grad_x = None
        if ctx.needs_input_grad[1]:
            ga, gj = _aligned(g_out), _aligned(g_jac)
            if x.device.type == "cpu":
                grad = hash_encode_bwd_plain(x, ga, gj, ctx.spec, ctx.rows)
            else:
                # the autograd engine runs this on its own thread, outside the
                # caller's profiler ranges: name the kernel's range here
                with record_function("sst/hash_encode_bwd"):
                    grad = hash_encode_bwd(x, ga, gj, ctx.spec, ctx.rows)
        if ctx.needs_input_grad[0] and g_jac is not None:
            grad_x = hash_jac_vjp_x(x, table, ctx.spec, g_jac)
        return grad_x, grad, None, None


class _HashGradX(torch.autograd.Function):
    """The encode's gradient in ``x`` through ``out``, as a node of its own
    after the encode: it passes ``out`` (and ``jac``) through unchanged, and
    its backward adds ``grad_x = sum_k g_out[:, k] jac[:, k, :]``. The
    contraction is plain PyTorch on ``jac``, an output of the encode node,
    so that a double backward (a loss on a gradient in ``x``, as nerfacto's
    orientation loss is) reaches the table and ``x`` again through the
    encode's ``jac`` cotangent, and whatever came before through
    ``g_out``."""

    @staticmethod
    def forward(ctx, out, jac, x, want_jac):
        # x is an input only so that autograd routes grad_x to it
        ctx.save_for_backward(jac)
        ctx.want_jac = want_jac
        return (out.view_as(out), jac.view_as(jac)) if want_jac else out.view_as(out)

    @staticmethod
    def backward(ctx, g_out, g_jac=None):
        (jac,) = ctx.saved_tensors
        grad_x = None
        if g_out is not None:
            with record_function("sst/hash_grad_x"):
                grad_x = torch.bmm(g_out.reshape(jac.shape[0], 1, -1), jac)[:, 0]
        return g_out, g_jac if ctx.want_jac else None, grad_x, None


def hash_encode(x: torch.Tensor, table: torch.Tensor, spec: HashGridSpec, want_jac: bool = False):
    """``x [..., 3]`` in [0, 1] -> ``out [..., L*F]`` and, with ``want_jac``,
    ``jac [..., L*F, 3]``; differentiable in the table and in ``x``. CPU
    tensors take :func:`hash_encode_plain` and :func:`hash_encode_bwd_plain`."""
    _check(x, table, spec)
    batch, F = x.shape[:-1], table.shape[1]
    x2 = x.reshape(-1, 3).contiguous()
    grad_x = torch.is_grad_enabled() and x.requires_grad
    fwd_jac = want_jac or grad_x  # the gradient in x reads the forward's jacobian
    if torch.is_grad_enabled() and (table.requires_grad or grad_x):
        res = _HashEncode.apply(x2, table, spec, fwd_jac)
    elif x.device.type == "cpu":
        res = hash_encode_plain(x2, table, spec, fwd_jac)
    else:
        res = hash_encode_fwd(x2, table, spec, fwd_jac)
    if grad_x:
        res = _HashGradX.apply(*res, x2, want_jac)
    L = spec.num_levels
    if not want_jac:
        return res.reshape(*batch, L * F)
    out, jac = res
    return out.reshape(*batch, L * F), jac.reshape(*batch, L * F, 3)
