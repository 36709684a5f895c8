"""Marching-cubes mesh of a trained run's SDF (counterpart of
``sdfstudio_tpu/scripts/extract_mesh.py``, ``sst-extract-mesh``):

    python -m sdfstudio_tpu_torch.scripts.extract_mesh --load-config <run>/config.yml \\
        [--output-path mesh.ply] [--resolution 512] [--bounding-box-min -1 -1 -1] \\
        [--bounding-box-max 1 1 1] [--chunk 131072] [--is-occupancy] [--device cuda|cpu]

Rebuilds the run from its ``config.yml`` with its newest complete
checkpoint, evaluates the SDF (of contracted positions, as JAX's bounded
branch does) on a ``resolution^3`` grid over the box in blocks of up to
256 cells, or UniSurf's occupancy ``sigmoid(-10 sdf)`` at level 0.5 with
``--is-occupancy``, and writes the welded mesh as a binary PLY
(extract_mesh.py:15-110). ``--use-contraction``,
``--create-visibility-mask`` and ``--simplify-mesh`` raise (ROADMAP queue 1
item 14). It runs on ``cuda`` unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import math
from pathlib import Path
from typing import Optional, Sequence

import torch

from sdfstudio_tpu_torch.engine.setup import eval_setup
from sdfstudio_tpu_torch.ops.contraction import contract
from sdfstudio_tpu_torch.ops.density import unisurf_occupancy
from sdfstudio_tpu_torch.utils.marching_cubes import get_surface_sliding
from sdfstudio_tpu_torch.utils.mesh_io import TriMesh


def run(load_config: Path, output_path: Path, resolution: int = 512,
        bounding_box_min=(-1.0, -1.0, -1.0), bounding_box_max=(1.0, 1.0, 1.0),
        is_occupancy: bool = False, use_contraction: bool = False,
        create_visibility_mask: bool = False, chunk: int = 131072, simplify_mesh: bool = False,
        device: Optional[str] = None) -> TriMesh:
    """extract_mesh.py:15-110, the bounded and occupancy branches."""
    for flag, on in (("--use-contraction", use_contraction),
                     ("--create-visibility-mask", create_visibility_mask),
                     ("--simplify-mesh", simplify_mesh)):
        if on:
            raise NotImplementedError(f"{flag} is not ported (ROADMAP queue 1 item 14)")
    _, trainer = eval_setup(load_config, device=device)
    field = trainer.model.field
    if not hasattr(field, "sdf"):
        # a density method's field has no SDF; JAX's reads ``field.sdf_fn`` and fails there too
        raise ValueError(f"{type(trainer.model).__name__} has no SDF field: extract_mesh takes the "
                         "surface methods")
    dev = next(trainer.model.parameters()).device

    def positions(pts: torch.Tensor) -> torch.Tensor:
        if field.spatial_distortion == "inf":
            return contract(pts, order=math.inf)
        if field.spatial_distortion == "l2":
            return contract(pts, order=None)
        return pts

    if is_occupancy:
        # get_surface_occupancy (marching_cubes.py:246-262): the raw positions, level 0.5
        lo, hi, level = (-1.0,) * 3, (1.0,) * 3, 0.5
        fn = lambda pts: unisurf_occupancy(field.sdf(pts))  # noqa: E731
    else:
        lo, hi, level = tuple(bounding_box_min), tuple(bounding_box_max), 0.0
        fn = lambda pts: field.sdf(positions(pts))  # noqa: E731
    mesh = get_surface_sliding(fn, dev, resolution=resolution, bounding_box_min=lo,
                               bounding_box_max=hi, block_res=min(resolution, 256), level=level,
                               chunk=chunk)
    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    mesh.export(output_path)
    print(f"wrote {output_path}: {len(mesh.vertices)} vertices, {len(mesh.faces)} faces", flush=True)
    return mesh


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="python -m sdfstudio_tpu_torch.scripts.extract_mesh")
    p.add_argument("--load-config", type=Path, required=True)
    p.add_argument("--output-path", type=Path, default=Path("mesh.ply"))
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--bounding-box-min", type=float, nargs=3, default=(-1.0, -1.0, -1.0))
    p.add_argument("--bounding-box-max", type=float, nargs=3, default=(1.0, 1.0, 1.0))
    p.add_argument("--is-occupancy", action="store_true")
    p.add_argument("--use-contraction", action="store_true")
    p.add_argument("--create-visibility-mask", action="store_true")
    p.add_argument("--chunk", type=int, default=131072)
    p.add_argument("--simplify-mesh", action="store_true")
    p.add_argument("--num-target-faces", type=int, default=1_000_000,
                   help="taken with --simplify-mesh, which is not ported")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = p.parse_args(argv)
    run(a.load_config, a.output_path, a.resolution, a.bounding_box_min, a.bounding_box_max,
        a.is_occupancy, a.use_contraction, a.create_visibility_mask, a.chunk, a.simplify_mesh,
        a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
