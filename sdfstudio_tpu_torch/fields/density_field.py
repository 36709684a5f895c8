"""Proposal density field, ``field_type="mlp"`` (counterpart of
``sdfstudio_tpu/fields/density_field.py:68-92, 114-157``): positional
encoding + a relu MLP through the fused kernel + ``trunc_exp``."""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from sdfstudio_tpu_torch.core.scene_box import SceneBox
from sdfstudio_tpu_torch.ops.contraction import contract
from sdfstudio_tpu_torch.ops.density import trunc_exp
from sdfstudio_tpu_torch.ops.encodings import NeRFEncoding
from sdfstudio_tpu_torch.ops.mlp import MLP


class MLPDensityField(nn.Module):
    """Gather-free proposal density (density_field.py:68-92 + 114-157).

    Arguments are those of ``HashMLPDensityField`` with ``field_type="mlp"``;
    the sizes derive from them as density_field.py:128-137 does."""

    def __init__(
        self,
        aabb: Optional[np.ndarray] = None,
        spatial_distortion: Optional[str] = None,
        num_layers: int = 2,
        hidden_dim: int = 64,
        max_res: int = 1024,
        field_type: str = "mlp",
        **hash_args,  # HashMLPDensityField's grid arguments; the mlp type has no grid
    ):
        super().__init__()
        if field_type != "mlp":
            raise NotImplementedError("only field_type='mlp' proposal fields are ported")
        self.spatial_distortion = spatial_distortion
        self.register_buffer(
            "aabb",
            torch.as_tensor(aabb if aabb is not None else SceneBox().aabb, dtype=torch.float32),
            persistent=False,
        )
        num_frequencies = max(4, min(int(math.log2(max_res)), 9))
        self.encoding = NeRFEncoding(
            in_dim=3,
            num_frequencies=num_frequencies,
            min_freq_exp=0.0,
            max_freq_exp=float(num_frequencies - 1),
            include_input=True,
        )
        self.mlp = MLP(
            self.encoding.out_dim,
            num_layers=max(num_layers, 3),
            layer_width=max(hidden_dim, 64),
            out_dim=1,
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.mlp.reset_parameters(generator)

    def normalize(self, positions: torch.Tensor) -> torch.Tensor:
        """Positions -> [0, 1]^3 (density_field.py:142-147)."""
        if self.spatial_distortion == "inf":
            return (contract(positions, order=math.inf) + 2.0) / 4.0
        if self.spatial_distortion == "l2":
            return (contract(positions, order=None) + 2.0) / 4.0
        return SceneBox.get_normalized_positions(positions, self.aabb)

    def forward(self, positions: torch.Tensor) -> torch.Tensor:
        """positions [..., 3] -> density [...] (density_field.py:149-157)."""
        x = self.normalize(positions) * 2.0 - 1.0
        raw = self.mlp(self.encoding(x))
        return trunc_exp(raw[..., 0])
