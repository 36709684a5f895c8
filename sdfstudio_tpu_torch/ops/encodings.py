"""Input encodings (counterpart of ``sdfstudio_tpu/ops/encodings.py``).

The sinusoidal ``NeRFEncoding`` (encodings.py:61-131) with mip-NeRF 360's
off-axis projection onto the icosahedron's 21 directions (``OFF_AXIS_P``,
encodings.py:30-56) and mip-NeRF's integrated encoding of a Gaussian
(``covs``, :82-92), TensoRF's tri-plane ``TensorVMEncoding`` (:512-571) and
line ``TensorCPEncoding`` (:574-606), the level-resolution
and hash-prime constants that ``PermutoEncoding`` shares with the hash grid
(encodings.py:191-202), the spherical-harmonics ``SHEncoding``
(encodings.py:172-184), and the multi-resolution ``HashEncoding``
(encodings.py:247-434), whose encode is ``ops/hash_grid.py``.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from sdfstudio_tpu_torch.core.math import components_from_spherical_harmonics, expected_sin

HASH_PRIMES = (1, 2654435761, 805459861)  # encodings.py:191 (uint32)

# the icosahedron projection of the off-axis encoding, stored [3, 21] as JAX
# stores it (encodings.py:30-56)
OFF_AXIS_P = np.array(
    [
        [0.8506508, 0, 0.5257311],
        [0.809017, 0.5, 0.309017],
        [0.5257311, 0.8506508, 0],
        [1, 0, 0],
        [0.809017, 0.5, -0.309017],
        [0.8506508, 0, -0.5257311],
        [0.309017, 0.809017, -0.5],
        [0, 0.5257311, -0.8506508],
        [0.5, 0.309017, -0.809017],
        [0, 1, 0],
        [-0.5257311, 0.8506508, 0],
        [-0.309017, 0.809017, -0.5],
        [0, 0.5257311, 0.8506508],
        [-0.309017, 0.809017, 0.5],
        [0.309017, 0.809017, 0.5],
        [0.5, 0.309017, 0.809017],
        [0.5, -0.309017, 0.809017],
        [0, 0, 1],
        [-0.5, 0.309017, 0.809017],
        [-0.809017, 0.5, 0.309017],
        [-0.809017, 0.5, -0.309017],
    ],
    dtype=np.float32,
).T


def level_resolutions(num_levels: int, min_res: int, max_res: int) -> np.ndarray:
    """floor(min_res * growth**level) (encodings.py:194-202), in float64 on
    the host exactly as the JAX package computes it."""
    if num_levels > 1:
        growth = math.exp((math.log(max_res) - math.log(min_res)) / (num_levels - 1))
    else:
        growth = 1.0
    levels = np.arange(num_levels)
    return np.floor(min_res * growth**levels).astype(np.int32)


def frequencies(num_frequencies: int, min_freq_exp: float, max_freq_exp: float) -> torch.Tensor:
    """2^linspace(min, max, n) (encodings.py:74), in float64 on the host so
    the integer exponents of every configured encoding give exact powers of
    two."""
    return torch.tensor(2.0 ** np.linspace(min_freq_exp, max_freq_exp, num_frequencies),
                        dtype=torch.float32)


def nerf_encoding(x: torch.Tensor, freqs: torch.Tensor, include_input: bool = False,
                  proj: Optional[torch.Tensor] = None,
                  covs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sinusoidal positional encoding (encodings.py:61-96):
    [sin(p * 2^f), sin(p * 2^f + pi/2)] with the frequency axis minor, where
    p is ``x`` or, off-axis, ``x @ proj`` ([3, 21]); with the covariances
    ``covs [..., 3, 3]`` of Gaussians centred at ``x``, mip-NeRF's integrated
    encoding: each sine's expectation, ``exp(-var / 2) sin(mean)``, at the
    variance ``diag(cov) * 4^f`` (:82-92)."""
    p = x if proj is None else x @ proj
    scaled = (p[..., None] * freqs).reshape(*p.shape[:-1], -1)  # [..., D*F]
    if covs is None:
        encoded = torch.sin(torch.cat([scaled, scaled + math.pi / 2.0], dim=-1))
    else:
        var = torch.diagonal(covs, dim1=-2, dim2=-1)[..., :, None] * freqs[None, :] ** 2
        var = var.reshape(*var.shape[:-2], -1)
        encoded = expected_sin(torch.cat([scaled, scaled + math.pi / 2.0], dim=-1),
                               torch.cat([var, var], dim=-1))
    if include_input:
        encoded = torch.cat([encoded, x], dim=-1)
    return encoded


class NeRFEncoding(nn.Module):
    """Module wrapper for :func:`nerf_encoding` (encodings.py:107-131)."""

    def __init__(
        self,
        in_dim: int = 3,
        num_frequencies: int = 6,
        min_freq_exp: float = 0.0,
        max_freq_exp: float = 5.0,
        include_input: bool = False,
        off_axis: bool = False,
    ):
        super().__init__()
        self.in_dim = in_dim
        self.off_axis = off_axis
        self.num_frequencies = num_frequencies
        self.min_freq_exp = min_freq_exp
        self.max_freq_exp = max_freq_exp
        self.include_input = include_input
        self.register_buffer(
            "freqs", frequencies(num_frequencies, min_freq_exp, max_freq_exp), persistent=False
        )
        self.register_buffer("proj", torch.from_numpy(OFF_AXIS_P.copy()) if off_axis else None,
                             persistent=False)

    @property
    def out_dim(self) -> int:
        """``nerf_encoding_dim`` (encodings.py:99-103): 21 projected inputs off-axis."""
        d = OFF_AXIS_P.shape[1] if self.off_axis else self.in_dim
        return d * self.num_frequencies * 2 + (self.in_dim if self.include_input else 0)

    def forward(self, x: torch.Tensor, covs: Optional[torch.Tensor] = None) -> torch.Tensor:
        proj = None if self.proj is None else self.proj.to(x.dtype)
        return nerf_encoding(x, self.freqs, self.include_input, proj, covs)


class SHEncoding(nn.Module):
    """Spherical harmonics of a direction (encodings.py:172-184): ``levels**2``
    components, without a gradient (JAX's ``stop_gradient``)."""

    def __init__(self, levels: int = 4):
        super().__init__()
        self.levels = levels

    @property
    def out_dim(self) -> int:
        return self.levels**2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return components_from_spherical_harmonics(self.levels, x.detach())


class HashEncoding(nn.Module):
    """Instant-NGP multi-resolution hash grid (encodings.py:247-434): the
    table ``hash_table [total_rows, F]`` in the JAX layout, the levels
    stacked with compact sizes, and the encode of ``ops/hash_grid.py``
    (kernels on the card, plain versions on the CPU)."""

    def __init__(
        self,
        num_levels: int = 16,
        min_res: int = 16,
        max_res: int = 2048,
        log2_hashmap_size: int = 19,
        features_per_level: int = 2,
        smoothstep: bool = False,
    ):
        super().__init__()
        from sdfstudio_tpu_torch.ops.hash_grid import HashGridSpec

        self.num_levels = num_levels
        self.features_per_level = features_per_level
        res = level_resolutions(num_levels, min_res, max_res)
        dense = (res.astype(np.int64) + 1) ** 3
        self.level_sizes = np.minimum(dense, 2**log2_hashmap_size).astype(np.int64)
        self.level_offsets = np.concatenate([[0], np.cumsum(self.level_sizes)])
        self.total_rows = int(self.level_offsets[-1])
        self.spec = HashGridSpec(
            resolutions=tuple(int(r) for r in res),
            offsets=tuple(int(o) for o in self.level_offsets[:-1]),
            dense=tuple(bool(d) for d in dense <= 2**log2_hashmap_size),
            log2_hashmap_size=log2_hashmap_size,
            smoothstep=smoothstep,
        )
        self.hash_table = nn.Parameter(torch.zeros(self.total_rows, features_per_level))

    @property
    def out_dim(self) -> int:
        return self.num_levels * self.features_per_level

    def reset_parameters(self, generator: torch.Generator) -> None:
        """uniform(-1, 1) * 1e-4, the JAX initialiser's distribution
        (``hash_init_scale``, encodings.py:355-360)."""
        with torch.no_grad():
            t = torch.rand(self.hash_table.shape, generator=generator, device=self.hash_table.device)
            self.hash_table.copy_((t * 2.0 - 1.0) * 1e-4)

    def forward(self, x: torch.Tensor, want_jac: bool = False):
        """``x [..., 3]`` in [0, 1] -> ``[..., L*F]`` (F minor), and with
        ``want_jac`` also d(out)/dx ``[..., L*F, 3]``."""
        from sdfstudio_tpu_torch.ops.hash_grid import hash_encode

        return hash_encode(x, self.hash_table, self.spec, want_jac)


# the planes of TensorVMEncoding and the pairs of coordinates they take (encodings.py:553)
VM_PLANES = ((0, 1), (0, 2), (1, 2))


class TensorVMEncoding(nn.Module):
    """TensoRF's tri-plane encoding (encodings.py:512-571; the vector
    factors off, as the reference has them): ``plane_coef [3, res, res, C]``
    on the planes (x, y), (x, z) and (y, z), each sampled bilinearly at
    ``coords * res`` (not ``res - 1``) with both corners clipped to
    ``[0, res - 1]``, row ``y * res + x`` of a plane's flat table, and the
    weights the offsets from the unclipped floor (optionally through a
    smoothstep). Inputs are in [0, 1]^3, and points outside take the
    clipped corners at their own offsets, as JAX computes them; ``x`` takes
    a gradient only through the offsets. The output is ``[..., 3, C]``
    flattened, plane-major. Plain PyTorch: the JAX package writes it in
    XLA. With ``want_jac`` also d(out)/dx ``[..., 3 C, 3]``, the offsets'
    derivative ``res`` (times the smoothstep's) through the bilinear form,
    which is what JAX's jvp gives (sdf_field.py:294-303)."""

    def __init__(self, resolution: int = 128, num_components: int = 24, init_scale: float = 0.1,
                 smoothstep: bool = False):
        super().__init__()
        self.resolution = resolution
        self.num_components = num_components
        self.init_scale = init_scale
        self.smoothstep = smoothstep
        self.plane_coef = nn.Parameter(torch.zeros(3, resolution, resolution, num_components))

    @property
    def out_dim(self) -> int:
        return self.num_components * 3

    def reset_parameters(self, generator: torch.Generator) -> None:
        """``init_scale`` times a standard normal (encodings.py:533-537)."""
        with torch.no_grad():
            t = torch.randn(self.plane_coef.shape, generator=generator)
            self.plane_coef.copy_(self.init_scale * t)

    def forward(self, x: torch.Tensor, want_jac: bool = False):
        res, C = self.resolution, self.num_components
        batch = x.shape[:-1]
        x2 = x.reshape(-1, 3)
        coords = torch.stack([x2[:, [a, b]] for a, b in VM_PLANES], 0)  # [3, N, 2]
        scaled = coords * res
        floor = torch.floor(scaled)
        offset = scaled - floor
        d_offset = None
        if self.smoothstep:
            if want_jac:
                d_offset = 6.0 * offset * (1.0 - offset)
            offset = offset * offset * (3.0 - 2.0 * offset)
        f = torch.clamp(floor.to(torch.int64), 0, res - 1)
        c = torch.clamp(f + 1, 0, res - 1)
        base = (torch.arange(3, device=x.device) * (res * res))[:, None]
        table = self.plane_coef.reshape(3 * res * res, C)
        f00 = table[base + f[..., 1] * res + f[..., 0]]  # [3, N, C]
        f01 = table[base + f[..., 1] * res + c[..., 0]]
        f10 = table[base + c[..., 1] * res + f[..., 0]]
        f11 = table[base + c[..., 1] * res + c[..., 0]]
        wx, wy = offset[..., 0:1], offset[..., 1:2]
        fx0 = f00 * (1 - wx) + f01 * wx
        fx1 = f10 * (1 - wx) + f11 * wx
        feat = fx0 * (1 - wy) + fx1 * wy  # [3, N, C]
        out = feat.permute(1, 0, 2).reshape(*batch, 3 * C)
        if not want_jac:
            return out
        # d feat / d (offset x, offset y) of each plane, then onto the plane's two axes
        dwx = (f01 - f00) * (1 - wy) + (f11 - f10) * wy
        dwy = fx1 - fx0
        gx, gy = dwx * res, dwy * res
        if d_offset is not None:
            gx, gy = gx * d_offset[..., 0:1], gy * d_offset[..., 1:2]
        zero = torch.zeros_like(gx[0])
        planes = []
        for p, (a, b) in enumerate(VM_PLANES):
            axes = [zero, zero, zero]
            axes[a], axes[b] = gx[p], gy[p]
            planes.append(torch.stack(axes, -1))  # [N, C, 3]
        return out, torch.stack(planes, 1).reshape(*batch, 3 * C, 3)


class TensorCPEncoding(nn.Module):
    """TensoRF's CP line encoding (encodings.py:574-606): ``line_coef [3,
    res, C]`` along z, y and x, sampled linearly at the coordinates clipped
    to [0, 1] and scaled by ``res - 1``, without a gradient in ``x``, and
    the three lines' features multiplied. Plain PyTorch, as JAX's is XLA."""

    def __init__(self, resolution: int = 256, num_components: int = 24, init_scale: float = 0.1):
        super().__init__()
        self.resolution = resolution
        self.num_components = num_components
        self.init_scale = init_scale
        self.line_coef = nn.Parameter(torch.zeros(3, resolution, num_components))

    @property
    def out_dim(self) -> int:
        return self.num_components

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            t = torch.randn(self.line_coef.shape, generator=generator)
            self.line_coef.copy_(self.init_scale * t)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = self.resolution
        coords = torch.stack([x[..., 2], x[..., 1], x[..., 0]], 0).detach()  # [3, ...]
        scaled = torch.clamp(coords, 0.0, 1.0) * (res - 1)
        f = torch.floor(scaled).to(torch.int64)
        c = torch.clamp(f + 1, 0, res - 1)
        w = (scaled - f)[..., None]
        base = torch.arange(3, device=x.device).reshape(3, *([1] * (x.dim() - 1))) * res
        table = self.line_coef.reshape(3 * res, self.num_components)
        feats = table[base + f] * (1 - w) + table[base + c] * w  # [3, ..., C]
        return feats[0] * feats[1] * feats[2]
