"""Proposal density field (counterpart of
``sdfstudio_tpu/fields/density_field.py``): ``field_type="hash"``, a hash
grid + a small relu MLP through the fused kernel + ``trunc_exp``
(density_field.py:37-66), and ``field_type="mlp"``, positional encoding + a
relu MLP + ``trunc_exp`` (density_field.py:68-92)."""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from sdfstudio_tpu_torch.core.scene_box import SceneBox
from sdfstudio_tpu_torch.ops.contraction import contract
from sdfstudio_tpu_torch.ops.density import trunc_exp
from sdfstudio_tpu_torch.ops.encodings import HashEncoding, NeRFEncoding
from sdfstudio_tpu_torch.ops.mlp import MLP


class HashMLPDensityField(nn.Module):
    """Density-only proposal field (density_field.py:96-157); the sizes of
    each ``field_type`` derive from the arguments as density_field.py:114-137
    does. The hash type's grid has no smoothstep (JAX passes none)."""

    def __init__(
        self,
        aabb: Optional[np.ndarray] = None,
        spatial_distortion: Optional[str] = None,
        num_layers: int = 2,
        hidden_dim: int = 64,
        num_levels: int = 8,
        max_res: int = 1024,
        base_res: int = 16,
        log2_hashmap_size: int = 18,
        features_per_level: int = 2,
        field_type: str = "hash",
    ):
        super().__init__()
        self.field_type = field_type
        self.spatial_distortion = spatial_distortion
        self.register_buffer(
            "aabb",
            torch.as_tensor(aabb if aabb is not None else SceneBox().aabb, dtype=torch.float32),
            persistent=False,
        )
        if field_type == "hash":
            self.encoding = HashEncoding(
                num_levels=num_levels,
                min_res=base_res,
                max_res=max_res,
                log2_hashmap_size=log2_hashmap_size,
                features_per_level=features_per_level,
            )
            self.mlp = MLP(self.encoding.out_dim, num_layers=num_layers, layer_width=hidden_dim,
                           out_dim=1)
        elif field_type == "mlp":
            num_frequencies = max(4, min(int(math.log2(max_res)), 9))
            self.encoding = NeRFEncoding(
                in_dim=3,
                num_frequencies=num_frequencies,
                min_freq_exp=0.0,
                max_freq_exp=float(num_frequencies - 1),
                include_input=True,
            )
            # the grid carries a hash field's capacity; here the MLP is the field
            self.mlp = MLP(self.encoding.out_dim, num_layers=max(num_layers, 3),
                           layer_width=max(hidden_dim, 64), out_dim=1)
        else:
            raise NotImplementedError(f"proposal field_type={field_type!r} is not ported")

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.field_type == "hash":
            self.encoding.reset_parameters(generator)
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
        p01 = self.normalize(positions)
        if self.field_type == "hash":
            raw = self.mlp(self.encoding(p01))
        else:
            raw = self.mlp(self.encoding(p01 * 2.0 - 1.0))
        return trunc_exp(raw[..., 0])
