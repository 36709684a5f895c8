"""Ray containers (counterpart of ``sdfstudio_tpu/core/rays.py``).

Two flat dataclasses of tensors: ``RayBundle`` ([R, ...] per ray) and
``RaySamples`` ([R, S] per sample). As in the JAX package, the spacing warp
is a ``spacing_kind`` string plus the warped ``s_near``/``s_far``
(rays.py:1-20), so ``euclidean = inv_warp(x * s_far + (1 - x) * s_near)``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from sdfstudio_tpu_torch.utils import checks

SPACING_UNIFORM = "uniform"
SPACING_LINDISP = "lindisp"
SPACING_SQRT = "sqrt"
SPACING_LOG = "log"
SPACING_PIECEWISE = "piecewise"
SPACING_EUCLIDEAN = "euclidean"


def spacing_fn(kind: str, x: torch.Tensor) -> torch.Tensor:
    """Euclidean distance -> spacing coordinates (rays.py:44-57)."""
    if kind in (SPACING_UNIFORM, SPACING_EUCLIDEAN):
        return x
    if kind == SPACING_LINDISP:
        return 1.0 / x
    if kind == SPACING_SQRT:
        return torch.sqrt(x)
    if kind == SPACING_LOG:
        return torch.log(x)
    if kind == SPACING_PIECEWISE:
        return torch.where(x < 1, x / 2, 1 - 1 / (2 * x))
    raise ValueError(f"unknown spacing kind: {kind}")


def spacing_fn_inv(kind: str, x: torch.Tensor) -> torch.Tensor:
    """Spacing coordinates -> euclidean distance (rays.py:60-73)."""
    if kind in (SPACING_UNIFORM, SPACING_EUCLIDEAN):
        return x
    if kind == SPACING_LINDISP:
        return 1.0 / x
    if kind == SPACING_SQRT:
        return x**2
    if kind == SPACING_LOG:
        return torch.exp(x)
    if kind == SPACING_PIECEWISE:
        return torch.where(x < 0.5, 2 * x, 1 / (2 - 2 * x))
    raise ValueError(f"unknown spacing kind: {kind}")


@dataclasses.dataclass
class RayBundle:
    """A batch of rays, leading shape [R] (rays.py:76-128)."""

    origins: torch.Tensor  # [R, 3]
    directions: torch.Tensor  # [R, 3] unit
    pixel_area: torch.Tensor  # [R, 1]
    nears: Optional[torch.Tensor] = None  # [R, 1]
    fars: Optional[torch.Tensor] = None  # [R, 1]
    camera_indices: Optional[torch.Tensor] = None  # [R] int
    directions_norm: Optional[torch.Tensor] = None  # [R, 1]
    times: Optional[torch.Tensor] = None  # [R, 1], the camera's time (rays.py:87)

    @property
    def num_rays(self) -> int:
        return self.origins.shape[0]

    def replace(self, **kw) -> "RayBundle":
        return dataclasses.replace(self, **kw)

    def map(self, fn) -> "RayBundle":
        """Apply ``fn`` to every tensor field (chunking, padding, device moves)."""
        return dataclasses.replace(
            self,
            **{
                f.name: (None if getattr(self, f.name) is None else fn(getattr(self, f.name)))
                for f in dataclasses.fields(self)
            },
        )

    def get_ray_samples(
        self,
        euclidean_bins: torch.Tensor,  # [R, S+1]
        spacing_bins: Optional[torch.Tensor] = None,
        spacing_kind: str = SPACING_EUCLIDEAN,
        s_near: Optional[torch.Tensor] = None,
        s_far: Optional[torch.Tensor] = None,
    ) -> "RaySamples":
        """RaySamples from bin edges (rays.py:98-128)."""
        if spacing_bins is None:
            spacing_bins = euclidean_bins
        checks.check_ray_bundle(self)
        samples = RaySamples(
            origins=self.origins,
            directions=self.directions,
            pixel_area=self.pixel_area,
            camera_indices=self.camera_indices,
            starts=euclidean_bins[..., :-1],
            ends=euclidean_bins[..., 1:],
            spacing_starts=spacing_bins[..., :-1],
            spacing_ends=spacing_bins[..., 1:],
            s_near=s_near,
            s_far=s_far,
            spacing_kind=spacing_kind,
            times=self.times,
        )
        checks.check_ray_samples(samples)
        return samples


@dataclasses.dataclass
class RaySamples:
    """Samples along rays, per-sample arrays [R, S] (rays.py:131-187)."""

    origins: torch.Tensor  # [R, 3]
    directions: torch.Tensor  # [R, 3]
    pixel_area: torch.Tensor  # [R, 1]
    starts: torch.Tensor  # [R, S]
    ends: torch.Tensor  # [R, S]
    spacing_starts: Optional[torch.Tensor] = None
    spacing_ends: Optional[torch.Tensor] = None
    s_near: Optional[torch.Tensor] = None  # [R, 1]
    s_far: Optional[torch.Tensor] = None  # [R, 1]
    camera_indices: Optional[torch.Tensor] = None
    spacing_kind: str = SPACING_EUCLIDEAN
    times: Optional[torch.Tensor] = None  # [R, 1], the rays' (rays.py:142)

    @property
    def num_rays(self) -> int:
        return self.starts.shape[0]

    @property
    def num_samples(self) -> int:
        return self.starts.shape[-1]

    @property
    def deltas(self) -> torch.Tensor:
        return self.ends - self.starts

    def get_positions(self) -> torch.Tensor:
        """Frustum centres [R, S, 3] (rays.py:161-164)."""
        mids = (self.starts + self.ends) * 0.5
        return self.origins[..., None, :] + self.directions[..., None, :] * mids[..., None]

    def get_start_positions(self) -> torch.Tensor:
        """Bin starts [R, S, 3] (rays.py:166-171)."""
        return self.origins[..., None, :] + self.directions[..., None, :] * self.starts[..., None]

    def spacing_to_euclidean(self, x: torch.Tensor) -> torch.Tensor:
        """Normalised spacing coords -> euclidean distance (rays.py:173-179)."""
        if self.spacing_kind == SPACING_EUCLIDEAN or self.s_near is None:
            return x
        s = x * self.s_far + (1.0 - x) * self.s_near
        return spacing_fn_inv(self.spacing_kind, s)
