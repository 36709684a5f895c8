"""Input encodings (counterpart of ``sdfstudio_tpu/ops/encodings.py``).

The sinusoidal ``NeRFEncoding`` (encodings.py:61-131) with mip-NeRF 360's
off-axis projection onto the icosahedron's 21 directions (``OFF_AXIS_P``,
encodings.py:30-56), the level-resolution
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

from sdfstudio_tpu_torch.core.math import components_from_spherical_harmonics

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
                  proj: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sinusoidal positional encoding (encodings.py:61-96, no IPE):
    [sin(p * 2^f), sin(p * 2^f + pi/2)] with the frequency axis minor, where
    p is ``x`` or, off-axis, ``x @ proj`` ([3, 21])."""
    p = x if proj is None else x @ proj
    scaled = (p[..., None] * freqs).reshape(*p.shape[:-1], -1)  # [..., D*F]
    encoded = torch.sin(torch.cat([scaled, scaled + math.pi / 2.0], dim=-1))
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        proj = None if self.proj is None else self.proj.to(x.dtype)
        return nerf_encoding(x, self.freqs, self.include_input, proj)


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
