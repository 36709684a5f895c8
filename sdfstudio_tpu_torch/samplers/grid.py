"""Occupancy grid and fixed-step masked ray marching (counterpart of
``sdfstudio_tpu/samplers/grid.py``).

The grid is a dense ``[res^3]`` occupancy value array and its ``[res, res,
res]`` binary over an aabb (nerfacc's ``OccupancyGrid`` in the reference).
The shapes stay static, as in JAX: a march probes a fixed number of points
a ray and a sampler takes a fixed number of samples with a validity mask;
nothing is compacted. These are XLA code in JAX and plain PyTorch here,
under the profiler range ``sst/occupancy_grid`` (ROADMAP: a hand kernel
waits for a profile that asks for one).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
from torch.profiler import record_function

from sdfstudio_tpu_torch.core.rays import RayBundle, RaySamples
from sdfstudio_tpu_torch.samplers.spaced import Rng, uniform


def linspace01(n: int, device) -> torch.Tensor:
    """``jnp.linspace(0, 1, n)`` in float32 bit for bit: ``i * f32(1 / (n -
    1))`` with the last point at 1 (``torch.linspace`` rounds some points
    one ulp apart)."""
    if n == 1:
        return torch.zeros(1, device=device)
    t = torch.arange(n, dtype=torch.float32, device=device) * torch.tensor(
        1.0 / (n - 1), dtype=torch.float32)
    t[-1] = 1.0
    return t


@dataclasses.dataclass
class OccupancyGrid:
    """Dense occupancy state over an aabb (grid.py:24-58): ``occs`` [res^3]
    float32 (the EMA values), ``binary`` [res, res, res] bool, ``aabb``
    [2, 3]."""

    occs: torch.Tensor
    binary: torch.Tensor
    aabb: torch.Tensor
    resolution: int = 128

    @classmethod
    def create(cls, aabb, resolution: int = 128, device=None) -> "OccupancyGrid":
        """A fully occupied grid with zero values (grid.py:32-38)."""
        aabb = torch.as_tensor(aabb, dtype=torch.float32, device=device)
        return cls(occs=torch.zeros(resolution**3, dtype=torch.float32, device=aabb.device),
                   binary=torch.ones((resolution,) * 3, dtype=torch.bool, device=aabb.device),
                   aabb=aabb, resolution=resolution)

    def replace(self, **kw) -> "OccupancyGrid":
        return dataclasses.replace(self, **kw)

    def state(self) -> dict:
        """The checkpoint's ``model_state`` leaves (JAX's pytree fields)."""
        return {"occs": self.occs, "binary": self.binary, "aabb": self.aabb,
                "resolution": self.resolution}

    @classmethod
    def from_state(cls, state: dict, device=None) -> "OccupancyGrid":
        return cls(occs=state["occs"].to(device), binary=state["binary"].to(device),
                   aabb=state["aabb"].to(device), resolution=int(state["resolution"]))

    def cell_positions(self, rng: Rng = None) -> torch.Tensor:
        """Centres of all cells, jittered within the cell with an ``rng``,
        [res^3, 3] in x-major order (grid.py:40-48)."""
        res = self.resolution
        idx = torch.arange(res**3, device=self.aabb.device)
        ijk = torch.stack([idx // (res * res), (idx // res) % res, idx % res], dim=-1)
        frac = (ijk.to(torch.float32) + 0.5) / res
        if rng is not None:
            frac = frac + (uniform(rng, frac.shape, frac.device) - 0.5) / res
        return self.aabb[0] + frac * (self.aabb[1] - self.aabb[0])

    def occupied_at(self, positions: torch.Tensor) -> torch.Tensor:
        """Occupancy of world positions [..., 3] -> bool [...]: the binary
        at the containing cell, False outside the aabb (grid.py:50-58)."""
        res = self.resolution
        frac = (positions - self.aabb[0]) / (self.aabb[1] - self.aabb[0])
        inside = torch.all((frac >= 0.0) & (frac < 1.0), dim=-1)
        ijk = torch.clamp((frac * res).to(torch.int64), 0, res - 1)
        flat = (ijk[..., 0] * res + ijk[..., 1]) * res + ijk[..., 2]
        return self.binary.reshape(-1)[flat] & inside


@torch.no_grad()
def update_occupancy_grid(
    grid: OccupancyGrid,
    density_fn: Callable[[torch.Tensor], torch.Tensor],
    rng: Rng,
    occ_threshold: float = 0.01,
    ema_decay: float = 0.95,
    render_step_size: float = 0.01,
) -> OccupancyGrid:
    """The EMA update (grid.py:61-79): each cell's opacity over one step,
    ``1 - exp(-density dt)`` at its (jittered) centre; ``occs = max(occs
    decay, alpha)``, ``binary = occs > min(threshold, mean(occs))``."""
    with record_function("sst/occupancy_grid"):
        density = density_fn(grid.cell_positions(rng))
        alpha = 1.0 - torch.exp(-density * render_step_size)
        occs = torch.maximum(grid.occs * ema_decay, alpha)
        thresh = torch.clamp(torch.mean(occs), max=occ_threshold)
        res = grid.resolution
        return grid.replace(occs=occs, binary=(occs > thresh).reshape(res, res, res))


@torch.no_grad()
def grid_near_far(
    ray_bundle: RayBundle,
    grid: OccupancyGrid,
    num_probes: int = 64,
    margin: float = 0.0,
    first_hit_shell: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each ray's [near, far] tightened against the binary grid
    (grid.py:82-116): ``num_probes`` points evenly from near to far (the
    first at near, the last at far); a ray that hits occupied cells gets
    ``[t_first - margin, t_last + margin]``, or with ``first_hit_shell``
    the shell ``t_first +- shell``, clamped into its old bounds (far at
    least near + 1e-4). Rays that hit nothing keep their bounds. Returns
    (nears [R, 1], fars [R, 1], hit [R, 1])."""
    with record_function("sst/occupancy_grid"):
        t = linspace01(num_probes, ray_bundle.origins.device)[None]
        ts = ray_bundle.nears + (ray_bundle.fars - ray_bundle.nears) * t  # [R, P]
        pts = ray_bundle.origins[:, None] + ray_bundle.directions[:, None] * ts[..., None]
        occ = grid.occupied_at(pts)
        hit = torch.any(occ, dim=-1, keepdim=True)
        inf = torch.full_like(ts, float("inf"))
        t_first = torch.amin(torch.where(occ, ts, inf), dim=-1, keepdim=True)
        t_last = torch.amax(torch.where(occ, ts, -inf), dim=-1, keepdim=True)
        if first_hit_shell is not None:
            new_nears, new_fars = t_first - first_hit_shell, t_first + first_hit_shell
        else:
            new_nears, new_fars = t_first - margin, t_last + margin
        nears = torch.where(hit, torch.maximum(new_nears, ray_bundle.nears), ray_bundle.nears)
        fars = torch.where(hit, torch.minimum(torch.maximum(new_fars, nears + 1e-4), ray_bundle.fars),
                           ray_bundle.fars)
        return nears, fars, hit


def occupancy_grid_sampler(
    ray_bundle: RayBundle,
    grid: OccupancyGrid,
    num_samples: int,
    rng: Rng = None,
    render_step_size: Optional[float] = None,
) -> Tuple[RaySamples, torch.Tensor]:
    """Fixed-step marching through the grid (grid.py:119-149): ``num_samples``
    bins evenly over each ray's [near, far], or with ``render_step_size``
    (``instant-ngp``) bins of that length from each ray's near; every bin
    start but the last moved by one draw a ray times its width with an
    ``rng``. A sample is valid where its centre lies in an occupied cell
    and it starts before far. Returns (samples, valid [R, S])."""
    with record_function("sst/occupancy_grid"):
        R = ray_bundle.num_rays
        dev = ray_bundle.origins.device
        nears, fars = ray_bundle.nears, ray_bundle.fars
        if render_step_size is not None:
            steps = torch.arange(num_samples + 1, dtype=nears.dtype, device=dev) * render_step_size
            edges = (nears + steps[None]).expand(R, num_samples + 1)
        else:
            edges = nears + (fars - nears) * linspace01(num_samples + 1, dev).to(nears.dtype)[None]
        if rng is not None:
            jitter = uniform(rng, (R, 1), dev).to(nears.dtype)
            step = edges[:, 1:] - edges[:, :-1]
            edges = torch.cat([edges[:, :-1] + jitter * step, edges[:, -1:]], dim=-1)
        ray_samples = ray_bundle.get_ray_samples(euclidean_bins=edges)
        valid = grid.occupied_at(ray_samples.get_positions()) & (ray_samples.starts < fars)
        return ray_samples, valid
