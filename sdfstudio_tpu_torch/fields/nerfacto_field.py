"""Nerfacto-style grid field (counterpart of
``sdfstudio_tpu/fields/nerfacto_field.py``): the surface methods' ``"grid"``
background and the field of ``nerfacto``, ``phototourism`` and
``instant-ngp``.

A hash grid (L16 x F2, 2^19 rows a level, resolutions 16 to 1024) over the
contracted positions mapped to [0, 1]^3 (or the aabb's box without a
contraction, ``instant-ngp``), ``mlp_base`` [32 -> 64 -> 16] (relu hidden,
no output activation; one fused kernel), ``trunc_exp`` of its first output
as the density, the SH encoding of the direction (levels 4, 16
components), a 32-wide appearance embedding, and ``mlp_head`` [63 -> 64
-> 64 -> 3] with a sigmoid output, which stays on the plain product as in
JAX (its fused kernel takes no sigmoid, ``ops/mlp.py``). The positions
keep their gradient, as in JAX (no ``stop_gradient`` there): with the
camera optimizer on they depend on the pose table, and the encode gives
the gradient in ``x`` (``ops/hash_grid.py``). With ``use_pred_normals``
(nerfacto's ``predict_normals``) a head predicts normals from the geometry
features and a 2-frequency positional encoding (:49, :88-90, :136-141).
``semantic-nerfw``'s heads (:75-87, 127-135): with
``use_transient_embedding`` a 16-wide transient embedding of the camera
joins the geometry features into ``mlp_transient`` [31 -> 64 -> 64] (one
fused kernel), whose uncertainty (softplus), rgb (sigmoid) and density
(``trunc_exp``) heads run in training only; with ``use_semantics``
``mlp_semantics`` [15 -> 64 -> 64] (fused) on the detached geometry
features and a ``num_semantic_classes``-wide head give the class logits.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from sdfstudio_tpu_torch.core.rays import RaySamples
from sdfstudio_tpu_torch.core.scene_box import SceneBox
from sdfstudio_tpu_torch.ops.contraction import contract
from sdfstudio_tpu_torch.ops.density import trunc_exp
from sdfstudio_tpu_torch.ops.encodings import HashEncoding, NeRFEncoding, SHEncoding
from sdfstudio_tpu_torch.ops.mlp import MLP, DenseLayer, lecun_normal_

# NerfactoFieldNet's widths (nerfacto_field.py:30-42), which every surface caller keeps
NUM_LAYERS = 2
HIDDEN_DIM = 64
GEO_FEAT_DIM = 15
BASE_RES = 16
FEATURES_PER_LEVEL = 2
NUM_LAYERS_COLOR = 3
HIDDEN_DIM_COLOR = 64
APPEARANCE_EMBEDDING_DIM = 32
TRANSIENT_EMBEDDING_DIM = 16  # nerfacto_field.py:43-46
NUM_LAYERS_TRANSIENT = 2
HIDDEN_DIM_TRANSIENT = 64
SEMANTIC_WIDTH = 64  # mlp_semantics, nerfacto_field.py:85


def _dense(x: torch.Tensor, layer: DenseLayer) -> torch.Tensor:
    return torch.matmul(x, layer.kernel) + layer.bias


class NerfactoField(nn.Module):
    """``NerfactoFieldNet`` (nerfacto_field.py:27-147) with the
    ``NerfactoField`` wrapper's normalisation and ray-sample evaluation
    (:150-221). Parameters carry JAX's names: ``encoding.hash_table``,
    ``mlp_base.layers.i``, ``embedding_appearance.embedding`` and
    ``mlp_head.layers.i`` (and ``embedding_transient.embedding``,
    ``mlp_transient``, ``head_transient_{uncertainty,rgb,density}``,
    ``mlp_semantics`` and ``head_semantics`` with the heads).

    The appearance rows follow JAX (:109-121): in training each sample
    takes its camera's row (and the table its gradient); at eval zeros, or
    with ``use_average_appearance_embedding`` the mean row; zeros in both
    modes without ``use_appearance_embedding``."""

    def __init__(
        self,
        aabb: Optional[np.ndarray] = None,
        spatial_distortion: Optional[str] = "inf",  # None | "inf" | "l2"
        num_images: int = 1,
        use_average_appearance_embedding: bool = False,
        num_levels: int = 16,
        max_res: int = 1024,
        log2_hashmap_size: int = 19,
        use_appearance_embedding: bool = True,
        use_transient_embedding: bool = False,
        use_semantics: bool = False,
        num_semantic_classes: int = 100,
        use_pred_normals: bool = False,
    ):
        super().__init__()
        self.spatial_distortion = spatial_distortion
        self.use_average_appearance_embedding = use_average_appearance_embedding
        self.use_appearance_embedding = use_appearance_embedding
        self.register_buffer(
            "aabb", torch.as_tensor(aabb if aabb is not None else SceneBox().aabb,
                                    dtype=torch.float32), persistent=False)
        self.encoding = HashEncoding(num_levels=num_levels, min_res=BASE_RES, max_res=max_res,
                                     log2_hashmap_size=log2_hashmap_size,
                                     features_per_level=FEATURES_PER_LEVEL)
        self.mlp_base = MLP(self.encoding.out_dim, NUM_LAYERS, HIDDEN_DIM, out_dim=1 + GEO_FEAT_DIM)
        self.direction_encoding = SHEncoding(levels=4)
        if use_appearance_embedding:  # flax makes no table that is never read
            self.embedding_appearance = nn.Module()
            self.embedding_appearance.embedding = nn.Parameter(
                torch.zeros(num_images, APPEARANCE_EMBEDDING_DIM))
        self.mlp_head = MLP(self.direction_encoding.out_dim + GEO_FEAT_DIM + APPEARANCE_EMBEDDING_DIM,
                            NUM_LAYERS_COLOR, HIDDEN_DIM_COLOR, out_dim=3, out_activation="sigmoid")
        self.use_pred_normals = use_pred_normals
        if use_pred_normals:  # nerfacto_field.py:62-64, 88-90
            self.position_encoding = NeRFEncoding(in_dim=3, num_frequencies=2, min_freq_exp=0.0,
                                                  max_freq_exp=1.0)
            self.mlp_pred_normals = MLP(GEO_FEAT_DIM + self.position_encoding.out_dim, 3, 64,
                                        out_dim=64)
            self.head_pred_normals = DenseLayer(64, 3)
        self.use_transient_embedding = use_transient_embedding
        if use_transient_embedding:  # nerfacto_field.py:75-82
            self.embedding_transient = nn.Module()
            self.embedding_transient.embedding = nn.Parameter(
                torch.zeros(num_images, TRANSIENT_EMBEDDING_DIM))
            self.mlp_transient = MLP(GEO_FEAT_DIM + TRANSIENT_EMBEDDING_DIM, NUM_LAYERS_TRANSIENT,
                                     HIDDEN_DIM_TRANSIENT, out_dim=HIDDEN_DIM_TRANSIENT)
            self.head_transient_uncertainty = DenseLayer(HIDDEN_DIM_TRANSIENT, 1)
            self.head_transient_rgb = DenseLayer(HIDDEN_DIM_TRANSIENT, 3)
            self.head_transient_density = DenseLayer(HIDDEN_DIM_TRANSIENT, 1)
        self.use_semantics = use_semantics
        if use_semantics:  # nerfacto_field.py:83-85
            self.mlp_semantics = MLP(GEO_FEAT_DIM, 2, SEMANTIC_WIDTH, out_dim=SEMANTIC_WIDTH)
            self.head_semantics = DenseLayer(SEMANTIC_WIDTH, num_semantic_classes)

    def heads(self):
        """The plain dense heads this field holds."""
        names = ["head_pred_normals", "head_transient_uncertainty", "head_transient_rgb",
                 "head_transient_density", "head_semantics"]
        return [getattr(self, n) for n in names if hasattr(self, n)]

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initialisers: the table uniform in +-1e-4, lecun normal
        kernels with zero biases, and ``nn.Embed``'s truncated normal of
        variance 1 / rows (fan in along the rows)."""
        self.encoding.reset_parameters(generator)
        self.mlp_base.reset_parameters(generator)
        self.mlp_head.reset_parameters(generator)
        for mlp in ("mlp_pred_normals", "mlp_transient", "mlp_semantics"):
            if hasattr(self, mlp):
                getattr(self, mlp).reset_parameters(generator)
        for head in self.heads():
            lecun_normal_(head.kernel, generator)
            head.bias.zero_()
        for emb in ("embedding_appearance", "embedding_transient"):
            if hasattr(self, emb):
                table = getattr(self, emb).embedding
                std = math.sqrt(1.0 / table.shape[0]) / 0.87962566103423978
                nn.init.trunc_normal_(table, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)

    def normalize(self, positions: torch.Tensor) -> torch.Tensor:
        """Contract, then map to [0, 1] (nerfacto_field.py:186-192)."""
        if self.spatial_distortion == "inf":
            return (contract(positions, order=math.inf) + 2.0) / 4.0
        if self.spatial_distortion == "l2":
            return (contract(positions, order=None) + 2.0) / 4.0
        return SceneBox.get_normalized_positions(positions, self.aabb)

    def density_raw(self, positions01: torch.Tensor, plain: bool = False):
        """(raw density, geometry features [.., 15]) at normalised positions
        (:94-97); with ``plain`` ``mlp_base`` takes the plain product, whose
        backward a second backward can take."""
        with record_function("sst/hash_encode"):
            feature = self.encoding(positions01)
        h = self.mlp_base.forward_plain(feature) if plain else self.mlp_base(feature)
        return h[..., 0], h[..., 1:]

    def density_fn(self, positions: torch.Tensor) -> torch.Tensor:
        """Density at world positions [..., 3] (nerfacto_field.py:194-202)."""
        raw, _ = self.density_raw(self.normalize(positions.reshape(-1, 3)))
        return trunc_exp(raw).reshape(positions.shape[:-1])

    def appearance(self, camera_indices: torch.Tensor, train: bool) -> torch.Tensor:
        """The embedding rows of the samples (nerfacto_field.py:109-121), [N, 32]."""
        n = camera_indices.shape[0]
        if not self.use_appearance_embedding:
            return self.encoding.hash_table.new_zeros((n, APPEARANCE_EMBEDDING_DIM))
        table = self.embedding_appearance.embedding
        if train:
            return table[camera_indices]
        if self.use_average_appearance_embedding:
            return table.mean(0).expand(n, -1)
        return table.new_zeros((n, table.shape[1]))

    def forward(self, positions01: torch.Tensor, directions: torch.Tensor,
                camera_indices: torch.Tensor, train: bool = False) -> Dict[str, torch.Tensor]:
        """Density and rgb at normalised positions (nerfacto_field.py:99-147)."""
        raw, geo_feat = self.density_raw(positions01)
        d = self.direction_encoding(directions)
        emb = self.appearance(camera_indices, train)
        rgb = self.mlp_head(torch.cat([d, geo_feat, emb], dim=-1))
        out = {"density": trunc_exp(raw), "rgb": rgb}
        if self.use_pred_normals:  # nerfacto_field.py:136-141
            pe = self.position_encoding(positions01)
            n = self.mlp_pred_normals(torch.cat([geo_feat, pe], dim=-1))
            pred = _dense(n, self.head_pred_normals)
            out["pred_normals"] = pred / torch.clamp(
                torch.linalg.vector_norm(pred, dim=-1, keepdim=True), min=1e-10)
        if self.use_transient_embedding and train:  # nerfacto_field.py:127-132
            temb = self.embedding_transient.embedding[camera_indices]
            t = self.mlp_transient(torch.cat([geo_feat, temb], dim=-1))
            out["transient_uncertainty"] = nn.functional.softplus(
                _dense(t, self.head_transient_uncertainty))[..., 0]
            out["transient_rgb"] = torch.sigmoid(_dense(t, self.head_transient_rgb))
            out["transient_density"] = trunc_exp(_dense(t, self.head_transient_density))[..., 0]
        if self.use_semantics:  # nerfacto_field.py:133-135
            out["semantics"] = _dense(self.mlp_semantics(geo_feat.detach()), self.head_semantics)
        return out

    def get_outputs(self, ray_samples: RaySamples, train: bool = False) -> Dict[str, torch.Tensor]:
        """Density [R, S] and rgb [R, S, 3] at the frustum centres (:204-221);
        camera 0 where the samples carry no camera indices."""
        R, S = ray_samples.num_rays, ray_samples.num_samples
        p01 = self.normalize(ray_samples.get_positions().reshape(-1, 3))
        dirs = ray_samples.directions[:, None, :].expand(R, S, 3).reshape(-1, 3)
        if ray_samples.camera_indices is not None:
            cam = ray_samples.camera_indices.reshape(R, 1).expand(R, S).reshape(-1)
        else:
            cam = torch.zeros(R * S, dtype=torch.long, device=p01.device)
        out = self(p01, dirs, cam, train)
        return {k: v.reshape(R, S, *v.shape[1:]) for k, v in out.items()}
