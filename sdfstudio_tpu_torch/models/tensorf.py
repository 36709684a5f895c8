"""TensoRF (counterpart of ``sdfstudio_tpu/models/tensorf.py``).

The field: a density tri-plane (``TensorVMEncoding``, 16 components) whose
summed features through a relu are the density, a colour tri-plane (48
components) projected by ``B`` (no bias) to 27 appearance features, and
``mlp_head`` [150 -> 128 -> 128] with a relu output (one fused kernel) on
the features, the direction and their 2-frequency PEs, then a sigmoid rgb
head; at the final resolution of 300 from step 0 (JAX does not upsample,
tensorf.py:5-8, nor does the port). The model: the collider at 2 and 6, 200
uniform samples whose densities alone (no gradient: the PDF resampling
takes their weights detached) give 50 PDF samples (the uniform ones not
kept), composited over white, the expected depth; the rgb MSE and, with
``regularization="tv"``, the mean absolute differences of both plane sets
along each plane axis. The tri-planes sit in their own ``encodings`` group
(a higher learning rate), the rest in ``field``. The encode is plain
PyTorch (XLA code in JAX), under the profiler range ``sst/tensorvm_encode``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch import nn
from torch.profiler import record_function

from sdfstudio_tpu_torch.core.rays import RayBundle
from sdfstudio_tpu_torch.core.scene_box import SceneBox
from sdfstudio_tpu_torch.models.base_model import Model, ModelConfig
from sdfstudio_tpu_torch.ops import render as R
from sdfstudio_tpu_torch.ops.encodings import NeRFEncoding, TensorVMEncoding
from sdfstudio_tpu_torch.ops.mlp import MLP, DenseLayer, lecun_normal_
from sdfstudio_tpu_torch.samplers.pdf import pdf_sampler
from sdfstudio_tpu_torch.samplers.spaced import Rng, uniform_sampler


@dataclasses.dataclass(frozen=True)
class TensoRFModelConfig(ModelConfig):
    """tensorf.py:68-84."""

    init_resolution: int = 128
    final_resolution: int = 300
    num_den_components: int = 16
    num_color_components: int = 48
    appearance_dim: int = 27
    num_uniform_samples: int = 200
    num_samples: int = 50
    regularization: str = "tv"  # none | l1 | tv
    l1_mult: float = 8e-5
    tv_reg_density: float = 1e-3
    tv_reg_color: float = 1e-4
    background_color: str = "white"
    collider_near: float = 2.0
    collider_far: float = 6.0
    eval_num_rays_per_chunk: int = 4096


class TensoRFModel(Model):
    """tensorf.py:87-160, with ``TensoRFFieldNet`` (:27-65) as ``field`` and
    ``encodings``: JAX's ``field/{B, mlp_head, rgb_head}`` and
    ``encodings/{density_encoding, color_encoding}/plane_coef``."""

    def __init__(self, config: TensoRFModelConfig, scene_box: SceneBox, num_train_data: int):
        super().__init__(config, scene_box, num_train_data)
        c = config
        self.encodings = nn.Module()
        self.encodings.density_encoding = TensorVMEncoding(c.final_resolution, c.num_den_components)
        self.encodings.color_encoding = TensorVMEncoding(c.final_resolution, c.num_color_components)
        self.feature_encoding = NeRFEncoding(c.appearance_dim, 2, 0.0, 1.0)
        self.direction_encoding = NeRFEncoding(3, 2, 0.0, 1.0)
        self.field = nn.Module()
        self.field.B = nn.Module()
        self.field.B.kernel = nn.Parameter(
            torch.zeros(self.encodings.color_encoding.out_dim, c.appearance_dim))
        head_in = (c.appearance_dim + 3 + self.feature_encoding.out_dim
                   + self.direction_encoding.out_dim)
        self.field.mlp_head = MLP(head_in, 2, 128, out_activation="relu")
        self.field.rgb_head = DenseLayer(128, 3)
        self.register_buffer("aabb", torch.as_tensor(scene_box.aabb, dtype=torch.float32),
                             persistent=False)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initialisers: the planes 0.1 times a normal, lecun normal kernels, zero biases."""
        self.encodings.density_encoding.reset_parameters(generator)
        self.encodings.color_encoding.reset_parameters(generator)
        lecun_normal_(self.field.B.kernel, generator)
        self.field.mlp_head.reset_parameters(generator)
        lecun_normal_(self.field.rgb_head.kernel, generator)
        self.field.rgb_head.bias.zero_()

    def density(self, positions01: torch.Tensor) -> torch.Tensor:
        """relu of the density planes' summed features (tensorf.py:51-54)."""
        with record_function("sst/tensorvm_encode"):
            enc = self.encodings.density_encoding(positions01)
        return torch.relu(torch.sum(enc, dim=-1))

    def forward(self, positions01: torch.Tensor, directions: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Density and rgb at positions in [0, 1]^3 (tensorf.py:56-64)."""
        density = self.density(positions01)
        with record_function("sst/tensorvm_encode"):
            color = self.encodings.color_encoding(positions01)
        rgb_features = torch.matmul(color, self.field.B.kernel)
        h = torch.cat([rgb_features, directions, self.feature_encoding(rgb_features),
                       self.direction_encoding(directions)], dim=-1)
        h = self.field.mlp_head(h)
        rgb = torch.sigmoid(torch.matmul(h, self.field.rgb_head.kernel) + self.field.rgb_head.bias)
        return {"density": density, "rgb": rgb}

    def normalize(self, positions: torch.Tensor) -> torch.Tensor:
        """World positions to the aabb's [0, 1]^3 (tensorf.py:113)."""
        return SceneBox.get_normalized_positions(positions, self.aabb.to(positions.dtype))

    def _outputs(self, ray_bundle: RayBundle, sched, train: bool, rng: Rng, model_state=None) -> Dict:
        """tensorf.py:104-140. The uniform pass computes its densities alone
        and without a graph: only their detached weights are read."""
        cfg = self.config
        ray_bundle = self.apply_collider(ray_bundle, train)
        rs_uniform = uniform_sampler(ray_bundle, cfg.num_uniform_samples, rng=rng)
        with torch.no_grad():
            density = self.density(self.normalize(rs_uniform.get_positions()).reshape(-1, 3))
            weights_coarse = R.weights_from_densities(rs_uniform.deltas,
                                                      density.reshape(rs_uniform.starts.shape))
        rs_pdf = pdf_sampler(ray_bundle, rs_uniform, weights_coarse, num_samples=cfg.num_samples,
                             rng=rng, include_original=False)
        Rn, S = rs_pdf.starts.shape
        dirs = rs_pdf.directions[:, None, :].expand(Rn, S, 3).reshape(-1, 3)
        fine = self(self.normalize(rs_pdf.get_positions()).reshape(-1, 3), dirs)
        weights = R.weights_from_densities(rs_pdf.deltas, fine["density"].reshape(Rn, S))
        return {"rgb": R.render_rgb(fine["rgb"].reshape(Rn, S, 3), weights, cfg.background_color),
                "accumulation": R.render_accumulation(weights),
                "depth": R.render_depth_expected(weights, rs_pdf.starts, rs_pdf.ends)}

    def get_loss_dict(self, outputs: Dict, batch: Dict, sched: Dict,
                      rng: Rng = None) -> Dict[str, torch.Tensor]:
        """The rgb MSE and the planes' regulariser (tensorf.py:142-160)."""
        cfg = self.config
        loss_dict = {"rgb_loss": torch.mean((batch["image"] - outputs["rgb"]) ** 2)}
        planes_d = self.encodings.density_encoding.plane_coef
        planes_c = self.encodings.color_encoding.plane_coef
        if cfg.regularization == "l1":
            loss_dict["l1_reg"] = cfg.l1_mult * torch.mean(torch.abs(planes_d))
        elif cfg.regularization == "tv":
            def tv(p):
                return (torch.mean(torch.abs(torch.diff(p, dim=1)))
                        + torch.mean(torch.abs(torch.diff(p, dim=2))))

            loss_dict["tv_reg_density"] = cfg.tv_reg_density * tv(planes_d)
            loss_dict["tv_reg_color"] = cfg.tv_reg_color * tv(planes_c)
        return loss_dict
