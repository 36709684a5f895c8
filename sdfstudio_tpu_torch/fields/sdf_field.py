"""SDF field (counterpart of ``sdfstudio_tpu/fields/sdf_field.py``), eval
and training forward.

Ported: the hash-grid or permutohedral grid feature with its analytic
jacobian (or, with ``use_grid_feature=False``, JAX's zeros in its place), the
weight-normed geometry MLP with the ``"vjp"`` gradient
(``geonetwork_with_gradient``, sdf_field.py:323-368), the color net through
the fused kernel (``colors``, sdf_field.py:387-473) and ``get_outputs``
(sdf_field.py:642-765) for the configuration options ``neus-facto`` and
``neus-facto-tpu-p8`` use. Other options raise.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from sdfstudio_tpu_torch.core.math import safe_normalize
from sdfstudio_tpu_torch.core.rays import RaySamples
from sdfstudio_tpu_torch.ops import density as density_ops
from sdfstudio_tpu_torch.ops.contraction import contract
from sdfstudio_tpu_torch.ops.encodings import HashEncoding, NeRFEncoding
from sdfstudio_tpu_torch.ops.fused_mlp import fused_mlp
from sdfstudio_tpu_torch.ops.mlp import (
    WNLinear,
    geometric_init,
    kaiming_uniform,
    softplus_beta100,
)
from sdfstudio_tpu_torch.ops.permuto import PermutoEncoding
from sdfstudio_tpu_torch.utils import checks


@dataclasses.dataclass(frozen=True)
class SDFFieldConfig:
    """The sizes and values of ``SDFFieldConfig`` (sdf_field.py:63-108) that
    the port reads, with JAX's defaults. The port implements the options
    ``neus-facto`` and ``neus-facto-tpu-p8`` set and JAX's defaults: the
    hash-grid (``encoding_type="hash"``, f32 tables) or permutohedral
    (``"permuto"``) grid feature, on or off (``use_grid_feature``),
    positional encoding, geometric init, weight norm, no appearance
    embedding, and the analytic ``"vjp"`` gradient; other encodings,
    ``"bfloat16"`` tables and ``use_appearance_embedding=True`` raise."""

    num_layers: int = 8
    hidden_dim: int = 256
    geo_feat_dim: int = 256
    num_layers_color: int = 4
    hidden_dim_color: int = 256
    appearance_embedding_dim: int = 32
    use_appearance_embedding: bool = False  # sdf_field.py:73; True is not ported yet
    bias: float = 0.8
    inside_outside: bool = True
    use_grid_feature: bool = False
    """sdf_field.py:78: off, the geometry MLP takes zeros in place of the
    grid feature and its jacobian (``_grid_feature``, :287-289), and the
    field has no grid table (Flax never creates the unused encoding's)."""
    beta_init: float = 0.1
    position_encoding_max_degree: int = 6
    rgb_padding: float = 0.001
    num_levels: int = 16
    max_res: int = 2048
    base_res: int = 16
    log2_hashmap_size: int = 19
    hash_features_per_level: int = 2
    encoding_type: str = "hash"  # hash | permuto
    hash_smoothstep: bool = True
    hash_table_dtype: str = "float32"


class SDFField(nn.Module):
    """Networks and eval forward of the SDF field (sdf_field.py:111-258, 518-765)."""

    def __init__(
        self,
        config: SDFFieldConfig,
        num_images: int = 1,
        spatial_distortion: Optional[str] = None,
    ):
        super().__init__()
        cfg = self.config = config
        self.spatial_distortion = spatial_distortion
        if cfg.hash_table_dtype != "float32":
            raise NotImplementedError(f"hash_table_dtype={cfg.hash_table_dtype!r} is not ported")
        if cfg.use_appearance_embedding:
            raise NotImplementedError("use_appearance_embedding=True is not ported yet")
        if cfg.encoding_type not in ("hash", "permuto"):
            raise NotImplementedError(f"encoding_type={cfg.encoding_type!r} is not ported")
        grid = dict(num_levels=cfg.num_levels, min_res=cfg.base_res, max_res=cfg.max_res,
                    log2_hashmap_size=cfg.log2_hashmap_size,
                    features_per_level=cfg.hash_features_per_level)
        # both grids give L*F features; without the grid feature there is no table
        self.encoding = None
        if cfg.use_grid_feature and cfg.encoding_type == "hash":
            self.encoding = HashEncoding(smoothstep=cfg.hash_smoothstep, **grid)
        elif cfg.use_grid_feature:
            self.encoding = PermutoEncoding(**grid)
        self.encode_range = f"sst/{cfg.encoding_type}_encode"  # the profiler range of the encode
        self.grid_dim = cfg.num_levels * cfg.hash_features_per_level
        self.position_encoding = NeRFEncoding(
            3, cfg.position_encoding_max_degree, 0.0, cfg.position_encoding_max_degree - 1, False
        )
        self.direction_encoding = NeRFEncoding(3, 4, 0.0, 3.0, True)

        # geometry MLP (sdf_field.py:171-207)
        in_dim0 = 3 + self.position_encoding.out_dim + self.grid_dim
        dims = [in_dim0] + [cfg.hidden_dim] * cfg.num_layers + [1 + cfg.geo_feat_dim]
        n_glayers = len(dims) - 1
        self.skip_in = tuple(s for s in (4,) if s < n_glayers)
        self.geo_in_dim = in_dim0
        self.gdims = []
        for l in range(n_glayers):
            out_dim = dims[l + 1] - dims[0] if l + 1 in self.skip_in else dims[l + 1]
            self.gdims.append((dims[l], out_dim))
            self.add_module(f"glin{l}", WNLinear(dims[l], out_dim))
        self.n_glayers = n_glayers

        # color MLP (sdf_field.py:209-240)
        color_in = (
            3 + self.direction_encoding.out_dim + 3 + cfg.geo_feat_dim
            + cfg.appearance_embedding_dim
        )
        cdims = [color_in] + [cfg.hidden_dim_color] * cfg.num_layers_color + [3]
        self.cdims = cdims
        for l in range(len(cdims) - 1):
            self.add_module(f"clin{l}", WNLinear(cdims[l], cdims[l + 1]))
        self.n_clayers = len(cdims) - 1

        self.embedding_appearance = nn.Module()
        self.embedding_appearance.embedding = nn.Parameter(
            torch.zeros(num_images, cfg.appearance_embedding_dim)
        )
        self.laplace_beta = nn.Parameter(torch.full((1,), cfg.beta_init))
        self.deviation = nn.Parameter(torch.full((1,), cfg.beta_init))

    def glayer(self, l: int) -> WNLinear:
        return getattr(self, f"glin{l}")

    def clayer(self, l: int) -> WNLinear:
        return getattr(self, f"clin{l}")

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init with the JAX initialisers' distributions (sdf_field.py:183-257)."""
        cfg = self.config
        if self.encoding is not None:
            self.encoding.reset_parameters(generator)
        for l, shape in enumerate(self.gdims):
            k, b = geometric_init(
                l, self.n_glayers - 1, self.geo_in_dim, shape, cfg.bias, cfg.inside_outside,
                self.skip_in, generator,
            )
            self.glayer(l).set_init(k, b)
        for l in range(self.n_clayers):
            shape = (self.cdims[l], self.cdims[l + 1])
            self.clayer(l).set_init(kaiming_uniform(shape, generator), torch.zeros(shape[1]))
        emb = self.embedding_appearance.embedding
        emb.copy_(torch.randn(emb.shape, generator=generator) / math.sqrt(emb.shape[-1]))
        self.laplace_beta.fill_(cfg.beta_init)
        self.deviation.fill_(cfg.beta_init)

    # ------------------------------------------------------------------
    def contract_positions(self, x: torch.Tensor) -> torch.Tensor:
        """sdf_field.py:559-564."""
        if self.spatial_distortion == "inf":
            return contract(x, order=math.inf)
        if self.spatial_distortion == "l2":
            return contract(x, order=None)
        return x

    def grid_feature(self, x: torch.Tensor, want_jac: bool = True):
        """Feature and its jacobian wrt x (or None) at positions in [-2, 2]
        (``_grid_feature``, sdf_field.py:281-311); zeros without the grid
        feature (:287-289)."""
        if self.encoding is None:
            z = torch.zeros((*x.shape[:-1], self.grid_dim), dtype=x.dtype, device=x.device)
            return z, (torch.zeros((*z.shape, 3), dtype=x.dtype, device=x.device)
                       if want_jac else None)
        if not want_jac:
            return self.encoding((x + 2.0) / 4.0, want_jac=False), None
        feature, jac = self.encoding((x + 2.0) / 4.0, want_jac=True)
        return feature, jac / 4.0

    def geo_mlp(self, x: torch.Tensor, feature: torch.Tensor, layers) -> torch.Tensor:
        """Geometry MLP on (x, grid feature) (sdf_field.py:260-279), with the
        effective ``layers`` [(kernel, bias)] passed in."""
        inputs = torch.cat([x, self.position_encoding(x), feature], dim=-1)
        h = inputs
        n = len(layers)
        for l, (k, b) in enumerate(layers):
            if l in self.skip_in:
                h = torch.cat([h, inputs], dim=-1) / np.sqrt(2)
            h = torch.matmul(h, k) + b
            if l < n - 1:
                h = softplus_beta100(h)
        return h

    @torch.no_grad()
    def sdf(self, x: torch.Tensor) -> torch.Tensor:
        """The SDF at positions ``x`` [..., 3] in [-2, 2] (``sdf_fn``,
        sdf_field.py:549-556, through ``geonetwork`` :305-313): the encode
        without its jacobian and the geometry MLP, no gradient. Mesh
        extraction evaluates it on every point of its grid."""
        checks.check_positions(x, "SDFField.geonetwork positions")
        feature, _ = self.grid_feature(x, want_jac=False)
        layers = [self.glayer(l).effective() for l in range(self.n_glayers)]
        return self.geo_mlp(x, feature, layers)[..., 0]

    def geonetwork_with_gradient(self, x: torch.Tensor, train: bool = False):
        """(geonetwork output, d sdf/dx) from one encode (sdf_field.py:323-362,
        ``"vjp"``): one reverse pass through the MLP, whose input gradient wrt
        the feature is chained onto the analytic encode jacobian,
        d sdf/dx = d sdf/dx|direct + jac^T . d sdf/d feature.

        The geometry MLP stays on ``torch.matmul``: the eikonal loss
        differentiates d sdf/dx again, and the fused kernel has no double
        backward. With ``train`` the encode, its jacobian and the reverse
        pass stay in the graph (``create_graph``), so the table takes
        gradients through both the feature and the jacobian and the eikonal
        loss reaches every parameter (sdf_field.py:173-193). Without it the
        render runs under ``no_grad`` and this step turns grad on for
        itself only."""
        checks.check_positions(x, "SDFField.geonetwork positions")
        if train:
            with record_function(self.encode_range):
                feature, fjac = self.grid_feature(x)
            layers = [self.glayer(l).effective() for l in range(self.n_glayers)]
            with record_function("sst/geo_mlp_and_grad"):
                xg = x.detach().requires_grad_(True)
                h = self.geo_mlp(xg, feature, layers)
                if self.encoding is None:  # a zero feature and jacobian add nothing
                    (grad,) = torch.autograd.grad(h[..., 0].sum(), xg, create_graph=True)
                    return h, grad
                dx, dfeat = torch.autograd.grad(h[..., 0].sum(), (xg, feature), create_graph=True)
                grad = dx + torch.einsum("...f,...fa->...a", dfeat, fjac)
            return h, grad
        with torch.no_grad(), record_function(self.encode_range):
            feature, fjac = self.grid_feature(x)
        with torch.no_grad():
            layers = [self.glayer(l).effective() for l in range(self.n_glayers)]
        with torch.enable_grad(), record_function("sst/geo_mlp_and_grad"):
            xg = x.detach().requires_grad_(True)
            fg = feature.detach().requires_grad_(True)
            h = self.geo_mlp(xg, fg, layers)
            dx, dfeat = torch.autograd.grad(h[..., 0].sum(), (xg, fg))
            grad = dx + torch.einsum("...f,...fa->...a", dfeat, fjac)
        return h.detach(), grad

    def colors(
        self,
        points: torch.Tensor,
        directions: torch.Tensor,
        gradients: torch.Tensor,
        geo_features: torch.Tensor,
    ) -> torch.Tensor:
        """View-dependent colour (sdf_field.py:387-473), the whole chain in
        the fused kernel. Neither ported method has an appearance embedding
        in training either (``use_appearance_embedding=False`` zeroes it), so
        the embedding input is zero in both modes. In training the kernel's
        input gradient reaches ``gradients`` and the geometry features."""
        cfg = self.config
        d = self.direction_encoding(directions)
        emb = torch.zeros(
            (*directions.shape[:-1], cfg.appearance_embedding_dim),
            dtype=directions.dtype, device=directions.device,
        )
        h = torch.cat([points, d, gradients, geo_features, emb], dim=-1)
        kbs = [self.clayer(l).effective() for l in range(self.n_clayers)]
        with record_function("sst/color_mlp"):
            h = fused_mlp(h.contiguous(), [k.contiguous() for k, _ in kbs], [b for _, b in kbs],
                          activation="relu")
        rgb = torch.sigmoid(h)
        return rgb * (1 + 2 * cfg.rgb_padding) - cfg.rgb_padding

    def get_inv_s(self) -> torch.Tensor:
        return density_ops.variance_inv_s(self.deviation)

    def get_outputs(
        self,
        ray_samples: RaySamples,
        cos_anneal_ratio: float = 1.0,
        return_alphas: bool = False,
        train: bool = False,
    ) -> Dict[str, torch.Tensor]:
        """Field forward over ray samples (sdf_field.py:642-765)."""
        R, S = ray_samples.num_rays, ray_samples.num_samples
        inputs = ray_samples.get_start_positions().reshape(-1, 3)
        directions = ray_samples.directions[..., None, :].expand(R, S, 3).reshape(-1, 3)
        inputs = self.contract_positions(inputs)
        points_norm = torch.linalg.vector_norm(inputs, dim=-1)

        h, gradients = self.geonetwork_with_gradient(inputs, train=train)
        sdf, geo_feat = h[..., :1], h[..., 1:]
        rgb = self.colors(inputs, directions, gradients, geo_feat)
        beta = density_ops.effective_beta(self.laplace_beta)
        outputs = {
            "rgb": rgb.reshape(R, S, 3),
            "density": density_ops.laplace_density(sdf[..., 0], beta).reshape(R, S),
            "sdf": sdf.reshape(R, S),
            "gradient": gradients.reshape(R, S, 3),
            "normal": safe_normalize(gradients).reshape(R, S, 3),
            "points_norm": points_norm.reshape(R, S),
        }
        if return_alphas:
            outputs["alpha"] = density_ops.neus_alpha(
                outputs["sdf"], outputs["gradient"], ray_samples.directions,
                ray_samples.deltas, self.get_inv_s(), cos_anneal_ratio,
            )
        return outputs
