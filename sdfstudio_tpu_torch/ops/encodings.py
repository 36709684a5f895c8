"""Input encodings (counterpart of ``sdfstudio_tpu/ops/encodings.py``).

Slice 1 needs the sinusoidal ``NeRFEncoding`` (encodings.py:61-131) and the
level-resolution and hash-prime constants that ``PermutoEncoding`` shares
with the hash grid (encodings.py:191-202).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

HASH_PRIMES = (1, 2654435761, 805459861)  # encodings.py:191 (uint32)


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


def nerf_encoding(x: torch.Tensor, freqs: torch.Tensor, include_input: bool = False) -> torch.Tensor:
    """Sinusoidal positional encoding (encodings.py:61-96, no IPE, no off-axis):
    [sin(x * 2^f), sin(x * 2^f + pi/2)] with the frequency axis minor."""
    scaled = (x[..., None] * freqs).reshape(*x.shape[:-1], -1)  # [..., D*F]
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
    ):
        super().__init__()
        self.in_dim = in_dim
        self.num_frequencies = num_frequencies
        self.min_freq_exp = min_freq_exp
        self.max_freq_exp = max_freq_exp
        self.include_input = include_input
        self.register_buffer(
            "freqs", frequencies(num_frequencies, min_freq_exp, max_freq_exp), persistent=False
        )

    @property
    def out_dim(self) -> int:
        return self.in_dim * self.num_frequencies * 2 + (self.in_dim if self.include_input else 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nerf_encoding(x, self.freqs, self.include_input)
