"""The classic NeRF field, PE and MLPs (counterpart of
``sdfstudio_tpu/fields/vanilla_nerf_field.py``): the surface methods'
``"mlp"`` background and the field of ``vanilla-nerf``, ``dnerf`` and
``mipnerf``. With ``use_integrated_encoding`` (mip-NeRF) a sample is the
Gaussian of its conical frustum, at a radius of ``sqrt(pixel_area / pi)``:
its mean (contracted where the field contracts) and its covariance go into
the integrated positional encoding (vanilla_nerf_field.py:117-135).

``mlp_base`` (8 x 256, the input re-entering at layer 4, a relu output)
takes the plain product, as JAX's skip MLP does; ``mlp_head`` ([283 -> 128
-> 128] with a relu output) is skip-free and runs as one fused kernel."""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from sdfstudio_tpu_torch.core.math import conical_frustum_to_gaussian
from sdfstudio_tpu_torch.core.rays import RaySamples
from sdfstudio_tpu_torch.ops.contraction import contract
from sdfstudio_tpu_torch.ops.encodings import NeRFEncoding
from sdfstudio_tpu_torch.ops.mlp import MLP, DenseLayer, lecun_normal_


# JAX's defaults, which every caller there keeps (NeRFFieldNet, :26-32).
POSITION_FREQUENCIES = 10
DIRECTION_FREQUENCIES = 4
BASE_MLP_NUM_LAYERS = 8
BASE_MLP_LAYER_WIDTH = 256
HEAD_MLP_NUM_LAYERS = 2
HEAD_MLP_LAYER_WIDTH = 128
SKIP_CONNECTIONS = (4,)


class NeRFField(nn.Module):
    """``NeRFFieldNet`` (vanilla_nerf_field.py:23-80) with the ``NeRFField``
    wrapper's contraction and ray-sample evaluation (:83-145). Parameters
    carry JAX's names: ``mlp_base.layers.i`` (``mlp_base/layer_i``),
    ``mlp_head.layers.i``, ``density_head`` and ``rgb_head``."""

    def __init__(self, spatial_distortion: Optional[str] = None,  # None | "inf" | "l2"
                 use_integrated_encoding: bool = False):
        super().__init__()
        self.spatial_distortion = spatial_distortion
        self.use_integrated_encoding = use_integrated_encoding
        self.position_encoding = NeRFEncoding(3, POSITION_FREQUENCIES, 0.0,
                                              POSITION_FREQUENCIES - 1.0, True)
        self.direction_encoding = NeRFEncoding(3, DIRECTION_FREQUENCIES, 0.0,
                                               DIRECTION_FREQUENCIES - 1.0, True)
        self.mlp_base = MLP(self.position_encoding.out_dim, BASE_MLP_NUM_LAYERS,
                            BASE_MLP_LAYER_WIDTH, skip_connections=SKIP_CONNECTIONS,
                            out_activation="relu")
        self.mlp_head = MLP(self.direction_encoding.out_dim + BASE_MLP_LAYER_WIDTH,
                            HEAD_MLP_NUM_LAYERS, HEAD_MLP_LAYER_WIDTH, out_activation="relu")
        self.density_head = DenseLayer(BASE_MLP_LAYER_WIDTH, 1)
        self.rgb_head = DenseLayer(HEAD_MLP_LAYER_WIDTH, 3)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initialisers: lecun normal kernels, zero biases."""
        self.mlp_base.reset_parameters(generator)
        self.mlp_head.reset_parameters(generator)
        for head in (self.density_head, self.rgb_head):
            lecun_normal_(head.kernel, generator)
            head.bias.zero_()

    def contract_positions(self, x: torch.Tensor) -> torch.Tensor:
        """vanilla_nerf_field.py:110-115."""
        if self.spatial_distortion == "inf":
            return contract(x, order=math.inf)
        if self.spatial_distortion == "l2":
            return contract(x, order=None)
        return x

    def density(self, positions: torch.Tensor, covs: Optional[torch.Tensor] = None):
        """(density, base features) at contracted positions, integrated
        over Gaussians of covariance ``covs`` where given (vanilla_nerf_field.py:63-67)."""
        base = self.mlp_base(self.position_encoding(positions, covs))
        h = torch.matmul(base, self.density_head.kernel) + self.density_head.bias
        return torch.nn.functional.softplus(h)[..., 0], base

    def forward(self, positions: torch.Tensor, directions: torch.Tensor,
                covs: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """vanilla_nerf_field.py:69-80."""
        density, base = self.density(positions, covs)
        head = self.mlp_head(torch.cat([self.direction_encoding(directions), base], -1))
        rgb = torch.sigmoid(torch.matmul(head, self.rgb_head.kernel) + self.rgb_head.bias)
        return {"density": density, "rgb": rgb}

    def get_outputs(self, ray_samples: RaySamples, train: bool = False) -> Dict[str, torch.Tensor]:
        """Density [R, S] and rgb [R, S, 3] at the frustum centres, or with
        the integrated encoding over the frustums' Gaussians
        (vanilla_nerf_field.py:117-135); ``train`` changes nothing here (no
        embedding)."""
        R, S = ray_samples.num_rays, ray_samples.num_samples
        dirs = ray_samples.directions[:, None, :].expand(R, S, 3).reshape(-1, 3)
        if self.use_integrated_encoding:
            radius = torch.sqrt(ray_samples.pixel_area) / 1.7724538509055159
            g = conical_frustum_to_gaussian(
                ray_samples.origins[:, None, :], ray_samples.directions[:, None, :],
                ray_samples.starts[..., None], ray_samples.ends[..., None], radius[:, None, :])
            out = self(self.contract_positions(g.mean).reshape(-1, 3), dirs, g.cov.reshape(-1, 3, 3))
        else:
            pts = self.contract_positions(ray_samples.get_positions()).reshape(-1, 3)
            out = self(pts, dirs)
        return {k: v.reshape(R, S, *v.shape[1:]) for k, v in out.items()}
