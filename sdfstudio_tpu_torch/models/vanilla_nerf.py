"""Vanilla NeRF, D-NeRF and mip-NeRF (counterpart of
``sdfstudio_tpu/models/vanilla_nerf.py``).

``NeRFModel`` (``vanilla-nerf``, ``dnerf``): a coarse and a fine NeRF field
(``fields/vanilla_nerf_field.py``: the 8 x 256 base with its skip on the
plain product, the head [283 -> 128 -> 128] with a relu output as one fused
kernel), 64 uniform samples between the collider's planes at 2 and 6, then
128 PDF samples merged with the uniform ones, each set composited over
white; the fine field's median depth. With ``enable_temporal_distortion``
(``dnerf``) a ``DNeRFDistortion`` MLP [84 -> 256 -> 256 -> 256 -> 3] (one
fused kernel, no output activation) maps each sample's position and its
ray's time to an offset, and the field takes the shifted positions as they
are: no contraction, no integrated encoding (vanilla_nerf.py:145-156).
Rays without times (the Blender parser's) skip it, and its parameters then
take no gradient. ``MipNerfModel`` (``mipnerf``): one field shared by both
passes, 128 + 128 samples, the integrated positional encoding of each
frustum's Gaussian, and the rgb losses weighted 0.1 (coarse) and 1.0
(fine). JAX's parameters: ``field/coarse`` (and ``field/fine``), and
``temporal_distortion/MLP_0`` (the port's ``temporal_distortion.mlp``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.profiler import record_function

from sdfstudio_tpu_torch.core.rays import RayBundle, RaySamples
from sdfstudio_tpu_torch.fields.vanilla_nerf_field import NeRFField
from sdfstudio_tpu_torch.models.base_model import Model, ModelConfig
from sdfstudio_tpu_torch.ops import render as R
from sdfstudio_tpu_torch.ops.encodings import NeRFEncoding
from sdfstudio_tpu_torch.ops.mlp import MLP
from sdfstudio_tpu_torch.samplers.pdf import pdf_sampler
from sdfstudio_tpu_torch.samplers.spaced import Rng, uniform_sampler


class DNeRFDistortion(nn.Module):
    """D-NeRF's deformation (vanilla_nerf.py:27-49): the 10-frequency PEs of
    the position and of the time (both with their inputs, 63 + 21 wide) into
    a 4-layer 256-wide MLP to a 3-vector offset."""

    def __init__(self, position_frequencies: int = 10, temporal_frequencies: int = 10,
                 mlp_num_layers: int = 4, mlp_layer_width: int = 256):
        super().__init__()
        self.position_encoding = NeRFEncoding(3, position_frequencies, 0.0,
                                              position_frequencies - 1.0, True)
        self.temporal_encoding = NeRFEncoding(1, temporal_frequencies, 0.0,
                                              temporal_frequencies - 1.0, True)
        self.mlp = MLP(self.position_encoding.out_dim + self.temporal_encoding.out_dim,
                       mlp_num_layers, mlp_layer_width, out_dim=3)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.mlp.reset_parameters(generator)

    def forward(self, positions: torch.Tensor, times: torch.Tensor) -> torch.Tensor:
        h = torch.cat([self.position_encoding(positions), self.temporal_encoding(times)], dim=-1)
        return self.mlp(h)


@dataclasses.dataclass(frozen=True)
class VanillaModelConfig(ModelConfig):
    """vanilla_nerf.py:52-57."""

    num_coarse_samples: int = 64
    num_importance_samples: int = 128
    enable_temporal_distortion: bool = False
    background_color: str = "white"


class NeRFModel(Model):
    """Coarse and fine vanilla NeRF (vanilla_nerf.py:60-168)."""

    use_integrated_encoding = False
    share_field = False

    def __init__(self, config: VanillaModelConfig, scene_box, num_train_data: int):
        super().__init__(config, scene_box, num_train_data)
        self.field = nn.Module()
        self.field.coarse = NeRFField(use_integrated_encoding=self.use_integrated_encoding)
        if not self.share_field:
            self.field.fine = NeRFField(use_integrated_encoding=self.use_integrated_encoding)
        self.temporal_distortion = (DNeRFDistortion() if config.enable_temporal_distortion
                                    else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.field.coarse.reset_parameters(generator)
        if not self.share_field:
            self.field.fine.reset_parameters(generator)
        if self.temporal_distortion is not None:
            self.temporal_distortion.reset_parameters(generator)

    @property
    def fine_field(self) -> NeRFField:
        return self.field.coarse if self.share_field else self.field.fine

    def _offsets(self, ray_samples: RaySamples) -> Optional[torch.Tensor]:
        """The samples' temporal offsets [R, S, 3], or None without a
        distortion or times (vanilla_nerf.py:93-100)."""
        if self.temporal_distortion is None or ray_samples.times is None:
            return None
        pts = ray_samples.get_positions()
        R_, S = pts.shape[:2]
        times = ray_samples.times[:, None, :].expand(R_, S, 1)
        with record_function("sst/temporal_distortion"):
            return self.temporal_distortion(pts.reshape(-1, 3), times.reshape(-1, 1)).reshape(R_, S, 3)

    def _field_outputs(self, field: NeRFField, ray_samples: RaySamples, train: bool
                       ) -> Dict[str, torch.Tensor]:
        """The field at the samples, at their shifted positions where the
        distortion runs (vanilla_nerf.py:145-156)."""
        offset = self._offsets(ray_samples)
        if offset is None:
            return field.get_outputs(ray_samples, train=train)
        R_, S = ray_samples.starts.shape
        pts = ray_samples.get_positions() + offset
        dirs = ray_samples.directions[:, None, :].expand(R_, S, 3).reshape(-1, 3)
        out = field(pts.reshape(-1, 3), dirs)
        return {k: v.reshape(R_, S, *v.shape[1:]) for k, v in out.items()}

    def _render(self, fo: Dict, rs: RaySamples) -> Tuple[torch.Tensor, ...]:
        weights = R.weights_from_densities(rs.deltas, fo["density"])
        return (weights, R.render_rgb(fo["rgb"], weights, self.config.background_color),
                R.render_accumulation(weights), R.render_depth_median(weights, rs.starts, rs.ends))

    def _outputs(self, ray_bundle: RayBundle, sched, train: bool, rng: Rng, model_state=None) -> Dict:
        """vanilla_nerf.py:102-135."""
        cfg = self.config
        ray_bundle = self.apply_collider(ray_bundle, train)
        rs_uniform = uniform_sampler(ray_bundle, cfg.num_coarse_samples, rng=rng)
        with record_function("sst/field_coarse"):
            fo_coarse = self._field_outputs(self.field.coarse, rs_uniform, train)
        weights_coarse, rgb_coarse, acc_coarse, depth_coarse = self._render(fo_coarse, rs_uniform)
        rs_pdf = pdf_sampler(ray_bundle, rs_uniform, weights_coarse,
                             num_samples=cfg.num_importance_samples, rng=rng)
        with record_function("sst/field_fine"):
            fo_fine = self._field_outputs(self.fine_field, rs_pdf, train)
        _, rgb_fine, acc_fine, depth_fine = self._render(fo_fine, rs_pdf)
        return {"rgb": rgb_fine, "rgb_coarse": rgb_coarse, "rgb_fine": rgb_fine,
                "accumulation": acc_fine, "accumulation_coarse": acc_coarse,
                "depth": depth_fine, "depth_coarse": depth_coarse}

    def get_loss_dict(self, outputs: Dict, batch: Dict, sched: Dict,
                      rng: Rng = None) -> Dict[str, torch.Tensor]:
        """Both passes' rgb MSE, weighted by ``loss_coefficients`` (vanilla_nerf.py:158-164)."""
        image = batch["image"]
        return self.scale_losses({
            "rgb_loss_coarse": torch.mean((image - outputs["rgb_coarse"]) ** 2),
            "rgb_loss_fine": torch.mean((image - outputs["rgb_fine"]) ** 2),
        })


@dataclasses.dataclass(frozen=True)
class MipNerfModelConfig(VanillaModelConfig):
    """vanilla_nerf.py:167-171."""

    num_coarse_samples: int = 128
    num_importance_samples: int = 128
    loss_coefficients: Tuple[Tuple[str, float], ...] = (("rgb_loss_coarse", 0.1),
                                                        ("rgb_loss_fine", 1.0))


class MipNerfModel(NeRFModel):
    """mip-NeRF: one shared field with the integrated encoding (vanilla_nerf.py:174-181)."""

    use_integrated_encoding = True
    share_field = True
