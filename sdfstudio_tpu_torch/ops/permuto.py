"""Permutohedral-lattice hash encoding (counterpart of ``sdfstudio_tpu/ops/permuto.py``).

Plain PyTorch, as the JAX version is plain XLA: elevate the scaled position
onto the sum-zero hyperplane of R^4, round to the nearest remainder-0
lattice point, rank the residuals, take the barycentric weights of the 4
simplex corners, hash 3 coordinates of each corner into the level's table
slice, blend, and return the analytic d(feature)/dx beside the feature
(permuto.py:117-225). A hand kernel for this encode is queued in ROADMAP.md.

The hash is the JAX uint32 arithmetic done in int64: each product is split
into 16-bit halves so that no intermediate leaves int64, then masked to
32 bits, which wraps exactly as ``uint32`` does (permuto.py:190-196).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from sdfstudio_tpu_torch.ops.encodings import HASH_PRIMES, level_resolutions

D = 3
_S = [(D + 1) * math.sqrt(2.0 / 3.0) / math.sqrt((i + 1) * (i + 2)) for i in range(D)]
ELEVATE = np.array(
    [
        [_S[0], _S[1], _S[2]],
        [-_S[0], _S[1], _S[2]],
        [0.0, -2.0 * _S[1], _S[2]],
        [0.0, 0.0, -3.0 * _S[2]],
    ],
    dtype=np.float32,
)  # [4, 3] (permuto.py:46-54)

_MASK32 = 0xFFFFFFFF


def _mul_u32(u: torch.Tensor, p: int) -> torch.Tensor:
    """(u * p) mod 2^32 for int64 ``u`` in [0, 2^32) and a uint32 prime."""
    lo = (u & 0xFFFF) * p
    hi = ((u >> 16) * p) & 0xFFFF
    return (lo + (hi << 16)) & _MASK32


def _simplex(elev: torch.Tensor):
    """(rem0, rank, w) for elevated points [..., 4] (permuto.py:57-95)."""
    v = elev / (D + 1.0)
    rd = torch.round(v) * (D + 1.0)
    resid = elev - rd
    ii = torch.arange(D + 1, device=elev.device)
    greater = (resid[..., None, :] > resid[..., :, None]) | (
        (resid[..., None, :] == resid[..., :, None]) & (ii[None, :] < ii[:, None])
    )
    rank = torch.sum(greater, dim=-1).to(torch.int64)
    h = (torch.sum(rd, dim=-1) / (D + 1.0)).to(torch.int64)  # truncates toward 0, like astype
    rank = rank + h[..., None]
    under = rank < 0
    over = rank > D
    rank = rank + (D + 1) * under.to(torch.int64) - (D + 1) * over.to(torch.int64)
    rd = rd + (D + 1.0) * under.to(elev.dtype) - (D + 1.0) * over.to(elev.dtype)

    v2 = (elev - rd) / (D + 1.0)
    oh1 = torch.nn.functional.one_hot(D - rank, D + 2).to(elev.dtype)  # [..., 4, 5]
    oh2 = torch.nn.functional.one_hot(D + 1 - rank, D + 2).to(elev.dtype)
    b = torch.sum((oh1 - oh2) * v2[..., None], dim=-2)  # [..., 5]
    w = b[..., : D + 1].clone()
    w[..., 0] += 1.0 + b[..., D + 1]
    return rd, rank, w


def _simplex_M(rank: torch.Tensor, dtype) -> torch.Tensor:
    """dW_k/d(elev_i) within a simplex, [..., 4i, 4k] (permuto.py:100-107)."""
    oh1 = torch.nn.functional.one_hot(D - rank, D + 2).to(dtype)
    oh2 = torch.nn.functional.one_hot(D + 1 - rank, D + 2).to(dtype)
    M = (oh1 - oh2)[..., : D + 1].clone()
    M[..., 0] += -oh2[..., D + 1]
    return M / (D + 1.0)


class PermutoEncoding(nn.Module):
    """Multi-resolution permutohedral hash encoding (permuto.py:117-225).

    The table keeps the JAX layout ``hash_table [total_rows, F]``."""

    def __init__(
        self,
        num_levels: int = 8,
        min_res: int = 16,
        max_res: int = 512,
        log2_hashmap_size: int = 19,
        features_per_level: int = 2,
    ):
        super().__init__()
        self.num_levels = num_levels
        self.min_res = min_res
        self.max_res = max_res
        self.log2_hashmap_size = log2_hashmap_size
        self.features_per_level = features_per_level
        res = level_resolutions(num_levels, min_res, max_res)
        sizes = np.minimum(2 * (res.astype(np.int64) + 1) ** 3, 2**log2_hashmap_size)
        offsets = np.concatenate([[0], np.cumsum(sizes)])
        self.total_rows = int(offsets[-1])
        self.register_buffer("res", torch.tensor(res, dtype=torch.float32), persistent=False)
        self.register_buffer("sizes", torch.tensor(sizes, dtype=torch.int64), persistent=False)
        self.register_buffer(
            "offsets", torch.tensor(offsets[:-1], dtype=torch.int64), persistent=False
        )
        self.register_buffer("elevate", torch.tensor(ELEVATE), persistent=False)
        self.hash_table = nn.Parameter(torch.zeros(self.total_rows, features_per_level))

    @property
    def out_dim(self) -> int:
        return self.num_levels * self.features_per_level

    def reset_parameters(self, generator: torch.Generator) -> None:
        """uniform(-1, 1) * 1e-4, the JAX initialiser's distribution (permuto.py:199-204)."""
        with torch.no_grad():
            t = torch.rand(self.hash_table.shape, generator=generator, device=self.hash_table.device)
            self.hash_table.copy_((t * 2.0 - 1.0) * 1e-4)

    def corner_data(self, x: torch.Tensor):
        """idx [..., L, 4] int64, w [..., L, 4], dw_dx [..., L, 4, 3] (permuto.py:166-197)."""
        scaled = x[..., None, :] * self.res[:, None]  # [..., L, 3]
        E = self.elevate
        # elevated = scaled @ E.T, summed in input order as XLA does, so the
        # f32 rounding (an ulp is 6e-5 at res 512) matches the JAX encode
        elev = scaled[..., 0:1] * E[:, 0] + scaled[..., 1:2] * E[:, 1] + scaled[..., 2:3] * E[:, 2]
        rem0, rank, w = _simplex(elev)

        ks = torch.arange(D + 1, device=x.device)
        shift = torch.where(
            rank[..., None, :] >= (D + 1) - ks[:, None], ks[:, None] - (D + 1), ks[:, None]
        )  # [..., L, 4k, 4i]
        coords = rem0.to(torch.int64)[..., None, :] + shift
        u = coords & _MASK32
        key = (
            _mul_u32(u[..., 0], HASH_PRIMES[0])
            ^ _mul_u32(u[..., 1], HASH_PRIMES[1])
            ^ _mul_u32(u[..., 2], HASH_PRIMES[2])
        )  # [..., L, 4k]
        idx = key % self.sizes[:, None] + self.offsets[:, None]

        M = _simplex_M(rank, x.dtype)  # [..., L, 4i, 4k]
        dw_dx = torch.einsum("...ik,ia->...ka", M, E) * self.res[:, None, None]
        return idx, w, dw_dx

    def forward(self, x: torch.Tensor, want_jac: bool = False):
        """[..., 3] -> feature [..., L*F] (level-major), and with ``want_jac``
        its jacobian [..., L*F, 3] (permuto.py:199-225)."""
        idx, w, dw_dx = self.corner_data(x)
        feats = self.hash_table[idx]  # [..., L, 4, F]
        batch = x.shape[:-1]
        out = torch.einsum("...lk,...lkf->...lf", w, feats).reshape(*batch, self.out_dim)
        if not want_jac:
            return out
        jac = torch.einsum("...lka,...lkf->...lfa", dw_dx, feats).reshape(*batch, self.out_dim, 3)
        return out, jac
