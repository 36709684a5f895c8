"""Semantic NeRF-W (counterpart of ``sdfstudio_tpu/models/semantic_nerfw.py``):
``nerfacto`` with NeRF-W's transient head and a semantic head
(``fields/nerfacto_field.py``).

In training the static and transient densities are summed, and both
colours render with the summed density's weights and no background; the
uncertainty renders with the transient density's own weights, plus
``uncertainty_min``; the rgb loss becomes the channel-summed squared error
over the uncertainty squared, beside ``3 + mean(log beta)`` and 0.01 times
the mean transient density (semantic_nerfw.py:50-112). The semantic logits
render with the static weights, detached unless
``pass_semantic_gradients``; at eval their argmax is ``semantics_labels``.
The cross-entropy ``semantics_loss`` runs only for a batch that carries
``semantics`` labels: JAX's data manager loads none (the Friends parser
names the segmentations and nothing reads them), so through the command
line it never runs, in JAX or here.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from sdfstudio_tpu_torch.fields.nerfacto_field import NerfactoField
from sdfstudio_tpu_torch.models.nerfacto import NerfactoModel, NerfactoModelConfig
from sdfstudio_tpu_torch.ops import render as R
from sdfstudio_tpu_torch.samplers.spaced import Rng


@dataclasses.dataclass(frozen=True)
class SemanticNerfWModelConfig(NerfactoModelConfig):
    """semantic_nerfw.py:19-25."""

    num_semantic_classes: int = 100
    use_transient_embedding: bool = True
    semantic_loss_weight: float = 1.0
    pass_semantic_gradients: bool = False
    uncertainty_min: float = 0.03


class SemanticNerfWModel(NerfactoModel):
    """semantic_nerfw.py:28-112."""

    keep_field_outputs = True

    def __init__(self, config: SemanticNerfWModelConfig, scene_box, num_train_data: int):
        super().__init__(config, scene_box, num_train_data)
        self.field = NerfactoField(
            spatial_distortion="inf", num_images=num_train_data,
            use_average_appearance_embedding=config.use_average_appearance_embedding,
            num_levels=config.num_levels, max_res=config.max_res,
            log2_hashmap_size=config.log2_hashmap_size,
            use_transient_embedding=config.use_transient_embedding, use_semantics=True,
            num_semantic_classes=config.num_semantic_classes)

    def _outputs(self, ray_bundle, sched, train: bool, rng: Rng, model_state=None) -> Dict:
        cfg = self.config
        outputs = super()._outputs(ray_bundle, sched, train, rng, model_state)
        ray_samples = outputs.pop("ray_samples")
        fo = outputs.pop("field_outputs")
        weights_static = outputs["weights_list"][-1]
        if train and cfg.use_transient_embedding and "transient_density" in fo:
            weights = R.weights_from_densities(ray_samples.deltas,
                                               fo["density"] + fo["transient_density"])
            outputs["rgb"] = (torch.sum(weights[..., None] * fo["rgb"], dim=-2)
                              + torch.sum(weights[..., None] * fo["transient_rgb"], dim=-2))
            weights_transient = R.weights_from_densities(ray_samples.deltas, fo["transient_density"])
            outputs["uncertainty"] = (R.render_uncertainty(fo["transient_uncertainty"],
                                                           weights_transient)
                                      + cfg.uncertainty_min)
            outputs["transient_density"] = fo["transient_density"]
        sem_w = weights_static if cfg.pass_semantic_gradients else weights_static.detach()
        outputs["semantics"] = R.render_semantics(fo["semantics"], sem_w)
        if not train:
            outputs["semantics_labels"] = torch.argmax(outputs["semantics"], dim=-1)
        return outputs

    def get_loss_dict(self, outputs: Dict, batch: Dict, sched: Dict,
                      rng: Rng = None) -> Dict[str, torch.Tensor]:
        cfg = self.config
        loss_dict = super().get_loss_dict(outputs, batch, sched, rng)
        if "uncertainty" in outputs:
            beta = outputs["uncertainty"]
            loss_dict["rgb_loss"] = torch.mean(
                torch.sum((batch["image"] - outputs["rgb"]) ** 2, dim=-1) / beta[..., 0] ** 2)
            loss_dict["uncertainty_loss"] = 3.0 + torch.mean(torch.log(beta))
            loss_dict["density_loss"] = 0.01 * torch.mean(outputs["transient_density"])
        if "semantics" in batch:
            labels = batch["semantics"].to(torch.int64)
            logits = outputs["semantics"]
            loss_dict["semantics_loss"] = cfg.semantic_loss_weight * torch.mean(
                -torch.log_softmax(logits, dim=-1)[torch.arange(labels.shape[0],
                                                                device=labels.device), labels])
        return loss_dict
