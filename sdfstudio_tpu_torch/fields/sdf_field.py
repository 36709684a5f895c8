"""SDF field (counterpart of ``sdfstudio_tpu/fields/sdf_field.py``), eval
and training forward.

Ported: the hash-grid or permutohedral grid feature with its analytic
jacobian (or, with ``use_grid_feature=False``, JAX's zeros in its place), the
weight-normed geometry MLP with the ``"vjp"`` gradient
(``geonetwork_with_gradient``, sdf_field.py:323-368), the color net through
the fused kernel with the appearance embedding's rows and ref-NeRF's
options -- the reflected view direction, n.d, the diffuse colour and the
specular tint heads (``colors``, sdf_field.py:387-473) --, ``get_outputs``
(sdf_field.py:642-765) with NeuS alpha, UniSurf occupancy and a scheduled
Laplace beta, and
``gradient`` (sdf_field.py:578-648), analytic or numerical (Neuralangelo's
six taps, with their SDF values for the curvature loss), for the
configuration options the registered methods use, from ``neus-facto``'s
2-layer MLPs to JAX's default 8 geometry layers with the skip at layer 4.
The progressive ``hash_mask`` multiplies the grid feature (and its
jacobian) wherever the field evaluates the SDF. Other options raise.
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
from sdfstudio_tpu_torch.ops.encodings import HashEncoding, NeRFEncoding, TensorVMEncoding
from sdfstudio_tpu_torch.ops.fused_mlp import fused_mlp
from sdfstudio_tpu_torch.ops.mlp import (
    DenseLayer,
    WNLinear,
    geometric_init,
    kaiming_uniform,
    lecun_normal_,
    softplus_beta100,
)
from sdfstudio_tpu_torch.ops.permuto import PermutoEncoding
from sdfstudio_tpu_torch.utils import checks


@dataclasses.dataclass(frozen=True)
class SDFFieldConfig:
    """The sizes and values of ``SDFFieldConfig`` (sdf_field.py:63-108) that
    the port reads, with JAX's defaults. The port implements the options
    the registered methods set and JAX's defaults: the
    hash-grid (``encoding_type="hash"``, f32 tables), permutohedral
    (``"permuto"``) or tri-plane (``"tensorf_vm"``: 3 x 24 features at
    resolution 128, ``hash_smoothstep`` for its weights) grid feature, on
    or off (``use_grid_feature``),
    positional encoding (or zeros in its place), geometric init, weight
    norm, the appearance embedding on or off, the ref-NeRF colour options
    (off-axis positional encoding, reflections, n.d, diffuse colour,
    specular tint), and the analytic ``"vjp"`` gradient or the numerical
    one; the periodic encoding and ``"bfloat16"`` tables raise."""

    num_layers: int = 8
    hidden_dim: int = 256
    geo_feat_dim: int = 256
    num_layers_color: int = 4
    hidden_dim_color: int = 256
    appearance_embedding_dim: int = 32
    use_appearance_embedding: bool = False  # sdf_field.py:73
    bias: float = 0.8
    inside_outside: bool = True
    use_grid_feature: bool = False
    """sdf_field.py:78: off, the geometry MLP takes zeros in place of the
    grid feature and its jacobian (``_grid_feature``, :287-289), and the
    field has no grid table (Flax never creates the unused encoding's)."""
    beta_init: float = 0.1
    position_encoding_max_degree: int = 6
    use_diffuse_color: bool = False
    """sdf_field.py:87: the colour net takes [dir_enc, geo_feat, emb] and its
    sigmoid is the specular part, added to ``sigmoid(diffuse_color_pred(geo_feat)
    - ln 3)`` (:209-226, :462-471)."""
    use_specular_tint: bool = False  # :88, the specular part times sigmoid(specular_tint_pred)
    use_reflections: bool = False  # :89, the direction encoding takes 2 (n.(-d)) n + d
    use_n_dot_v: bool = False  # :90, n.d is the colour net's last input
    rgb_padding: float = 0.001
    off_axis: bool = False  # :92, the positional encoding's off-axis projection (21 x F x 2)
    num_levels: int = 16
    max_res: int = 2048
    base_res: int = 16
    log2_hashmap_size: int = 19
    hash_features_per_level: int = 2
    encoding_type: str = "hash"  # hash | permuto | tensorf_vm
    hash_smoothstep: bool = True
    hash_table_dtype: str = "float32"
    use_numerical_gradients: bool = False
    """sdf_field.py:93: the SDF gradient by central differences over six
    taps at +-delta on each axis (:598-619) in place of the analytic
    jacobian; ``get_outputs`` then also returns the taps' SDF
    (``sampled_sdf``, [R, S, 6]) for the curvature loss."""
    use_position_encoding: bool = True
    """sdf_field.py:101: off, zeros take the positional encoding's place
    (:266-268), so the geometry MLP keeps its input width."""


# the numerical gradient's taps, in JAX's order (sdf_field.py:600-610)
_TAPS = ((1.0, 0.0, 0.0), (-1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, -1.0, 0.0), (0.0, 0.0, 1.0),
         (0.0, 0.0, -1.0))


class SDFField(nn.Module):
    """Networks and eval forward of the SDF field (sdf_field.py:111-258, 518-765)."""

    def __init__(
        self,
        config: SDFFieldConfig,
        num_images: int = 1,
        spatial_distortion: Optional[str] = None,
        use_average_appearance_embedding: bool = False,
    ):
        super().__init__()
        cfg = self.config = config
        self.spatial_distortion = spatial_distortion
        self.use_average_appearance_embedding = use_average_appearance_embedding
        if cfg.hash_table_dtype != "float32":
            raise NotImplementedError(f"hash_table_dtype={cfg.hash_table_dtype!r} is not ported")
        if cfg.encoding_type not in ("hash", "permuto", "tensorf_vm"):
            raise NotImplementedError(f"encoding_type={cfg.encoding_type!r} is not ported")
        grid = dict(num_levels=cfg.num_levels, min_res=cfg.base_res, max_res=cfg.max_res,
                    log2_hashmap_size=cfg.log2_hashmap_size,
                    features_per_level=cfg.hash_features_per_level)
        # both grids give L*F features; without the grid feature there is no table
        self.encoding = None
        self.grid_dim = cfg.num_levels * cfg.hash_features_per_level
        if cfg.encoding_type == "tensorf_vm":  # sdf_field.py:152-153, 72 features
            self.grid_dim = 3 * 24
            if cfg.use_grid_feature:
                self.encoding = TensorVMEncoding(128, 24, smoothstep=cfg.hash_smoothstep)
        elif cfg.use_grid_feature and cfg.encoding_type == "hash":
            self.encoding = HashEncoding(smoothstep=cfg.hash_smoothstep, **grid)
        elif cfg.use_grid_feature:
            self.encoding = PermutoEncoding(**grid)
        # the profiler range of the encode
        self.encode_range = ("sst/tensorvm_encode" if cfg.encoding_type == "tensorf_vm"
                             else f"sst/{cfg.encoding_type}_encode")
        self.position_encoding = NeRFEncoding(
            3, cfg.position_encoding_max_degree, 0.0, cfg.position_encoding_max_degree - 1, False,
            off_axis=cfg.off_axis,
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
            self.direction_encoding.out_dim + cfg.geo_feat_dim + cfg.appearance_embedding_dim
            + (0 if cfg.use_diffuse_color else 6) + (1 if cfg.use_n_dot_v else 0)
        )
        cdims = [color_in] + [cfg.hidden_dim_color] * cfg.num_layers_color + [3]
        self.cdims = cdims
        for l in range(len(cdims) - 1):
            self.add_module(f"clin{l}", WNLinear(cdims[l], cdims[l + 1]))
        self.n_clayers = len(cdims) - 1
        # the ref-NeRF heads on the geometry feature, plain dense layers (sdf_field.py:242-245)
        self.diffuse_color_pred = (DenseLayer(cfg.geo_feat_dim, 3) if cfg.use_diffuse_color
                                   else None)
        self.specular_tint_pred = (DenseLayer(cfg.geo_feat_dim, 3) if cfg.use_specular_tint
                                   else None)

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
        for head in (self.diffuse_color_pred, self.specular_tint_pred):
            if head is not None:  # flax Dense: lecun_normal kernel, zero bias
                lecun_normal_(head.kernel, generator)
                head.bias.zero_()
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

    def grid_feature(self, x: torch.Tensor, want_jac: bool = True,
                     hash_mask: Optional[torch.Tensor] = None):
        """Feature and its jacobian wrt x (or None) at positions in [-2, 2]
        (``_grid_feature``, sdf_field.py:281-311), both multiplied by
        ``hash_mask`` [L*F] where one is given (:306-310); zeros without the
        grid feature (:287-289)."""
        if self.encoding is None:
            z = torch.zeros((*x.shape[:-1], self.grid_dim), dtype=x.dtype, device=x.device)
            return z, (torch.zeros((*z.shape, 3), dtype=x.dtype, device=x.device)
                       if want_jac else None)
        if not want_jac:
            feature = self.encoding((x + 2.0) / 4.0, want_jac=False)
            return (feature if hash_mask is None else feature * hash_mask), None
        feature, jac = self.encoding((x + 2.0) / 4.0, want_jac=True)
        jac = jac / 4.0
        if hash_mask is not None:
            feature, jac = feature * hash_mask, jac * hash_mask[..., None]
        return feature, jac

    def geo_mlp(self, x: torch.Tensor, feature: torch.Tensor, layers) -> torch.Tensor:
        """Geometry MLP on (x, grid feature) (sdf_field.py:260-279), with the
        effective ``layers`` [(kernel, bias)] passed in."""
        if self.config.use_position_encoding:
            pe = self.position_encoding(x)
        else:  # zeros in its place (sdf_field.py:266-268)
            pe = x.new_zeros((*x.shape[:-1], self.position_encoding.out_dim))
        inputs = torch.cat([x, pe, feature], dim=-1)
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
    def sdf(self, x: torch.Tensor, hash_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The SDF at positions ``x`` [..., 3] in [-2, 2] (``sdf_fn``,
        sdf_field.py:549-556, through ``geonetwork`` :305-313): the encode
        without its jacobian and the geometry MLP, no gradient. Mesh
        extraction evaluates it on every point of its grid, without a mask
        (as JAX's ``eval_geometry``); the samplers pass the step's."""
        checks.check_positions(x, "SDFField.geonetwork positions")
        return self.geonetwork(x, hash_mask)[..., 0]

    def geonetwork(self, x: torch.Tensor, hash_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """SDF and geometric feature [..., 1 + geo_feat_dim] at positions
        ``x`` (``geonetwork``, sdf_field.py:313-321): the encode without its
        jacobian, then the geometry MLP, each under its profiler range; in
        the graph when grad is enabled."""
        with record_function(self.encode_range):
            feature, _ = self.grid_feature(x, want_jac=False, hash_mask=hash_mask)
        layers = [self.glayer(l).effective() for l in range(self.n_glayers)]
        with record_function("sst/geo_mlp"):
            return self.geo_mlp(x, feature, layers)

    def numerical_gradient(self, x: torch.Tensor, delta: float,
                           hash_mask: Optional[torch.Tensor] = None, with_centre: bool = False):
        """(geonetwork output at ``x`` or None, d sdf/dx [N, 3], the taps'
        SDF [N, 6]) by central differences (sdf_field.py:598-622): the six
        taps ``x +- delta e_a`` in JAX's order (+x, -x, +y, -y, +z, -z) and
        the gradient ``0.5 (sdf(+) - sdf(-)) / delta`` on each axis. With
        ``with_centre`` the centre and the taps go through one encode and
        one geometry MLP of 7N points (``get_outputs``' seven evaluations,
        :686-696); each row's value is the same function of its point."""
        n = x.shape[0]
        with record_function("sst/numerical_gradient"):
            offsets = torch.tensor(_TAPS, dtype=x.dtype, device=x.device)
            pts = x[None, ...] + delta * offsets[:, None, :]  # [6, N, 3]
            if with_centre:
                pts = torch.cat([x[None], pts])
        h = self.geonetwork(pts.reshape(-1, 3), hash_mask)
        with record_function("sst/numerical_gradient"):
            sdf6 = h[-6 * n:, 0].reshape(6, n)
            grads = torch.stack([0.5 * (sdf6[2 * a] - sdf6[2 * a + 1]) / delta for a in range(3)],
                                dim=-1)
        return (h[:n] if with_centre else None), grads, sdf6.T

    def geonetwork_with_gradient(self, x: torch.Tensor, train: bool = False,
                                 hash_mask: Optional[torch.Tensor] = None):
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
                feature, fjac = self.grid_feature(x, hash_mask=hash_mask)
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
            feature, fjac = self.grid_feature(x, hash_mask=hash_mask)
        with torch.no_grad():
            layers = [self.glayer(l).effective() for l in range(self.n_glayers)]
        with torch.enable_grad(), record_function("sst/geo_mlp_and_grad"):
            xg = x.detach().requires_grad_(True)
            fg = feature.detach().requires_grad_(True)
            h = self.geo_mlp(xg, fg, layers)
            dx, dfeat = torch.autograd.grad(h[..., 0].sum(), (xg, fg))
            grad = dx + torch.einsum("...f,...fa->...a", dfeat, fjac)
        return h.detach(), grad

    def appearance(self, camera_indices: Optional[torch.Tensor], n: int, train: bool,
                   like: torch.Tensor) -> torch.Tensor:
        """The appearance rows of ``n`` samples (sdf_field.py:409-422): in
        training each sample's camera row when ``use_appearance_embedding``
        is set (zeros otherwise); at eval the mean row with
        ``use_average_appearance_embedding``, zeros without it (JAX reads
        only the wrapper's flag there)."""
        table = self.embedding_appearance.embedding
        if train and self.config.use_appearance_embedding:
            if camera_indices is None:
                camera_indices = torch.zeros(n, dtype=torch.long, device=like.device)
            return table[camera_indices]
        if not train and self.use_average_appearance_embedding:
            return table.mean(0).to(like.dtype).expand(n, -1)
        return like.new_zeros((n, table.shape[1]))

    def colors(
        self,
        points: torch.Tensor,
        directions: torch.Tensor,
        gradients: torch.Tensor,
        geo_features: torch.Tensor,
        camera_indices: Optional[torch.Tensor] = None,
        train: bool = False,
    ) -> torch.Tensor:
        """View-dependent colour (sdf_field.py:387-473), the whole chain in
        the fused kernel, with the samples' appearance rows (``appearance``)
        after the geometry feature. In training the kernel's input gradient
        reaches ``gradients``, the geometry features and the embedding's
        rows. The ref-NeRF options: ``use_reflections`` encodes the view
        direction reflected about the normal, ``2 (n.(-d)) n + d``;
        ``use_diffuse_color`` drops the points and gradients from the input
        and adds ``sigmoid(diffuse - ln 3)`` to the specular part, the
        chain's sigmoid times ``sigmoid(tint)`` (``use_specular_tint``) or
        0.5, clipped to [0, 1]; ``use_n_dot_v`` appends n.d. The two heads
        are plain dense layers on the geometry feature, outside the kernel
        as in JAX. The padding comes last (:473)."""
        cfg = self.config
        normals = safe_normalize(gradients) if cfg.use_reflections or cfg.use_n_dot_v else None
        if cfg.use_reflections:
            d = self.direction_encoding(
                2.0 * torch.sum(normals * -directions, dim=-1, keepdim=True) * normals + directions)
        else:
            d = self.direction_encoding(directions)
        emb = self.appearance(camera_indices, directions.shape[0], train, directions)
        h = [d, geo_features, emb] if cfg.use_diffuse_color else [points, d, gradients,
                                                                   geo_features, emb]
        if cfg.use_n_dot_v:
            h.append(torch.sum(normals * directions, dim=-1, keepdim=True))
        h = torch.cat(h, dim=-1)
        kbs = [self.clayer(l).effective() for l in range(self.n_clayers)]
        with record_function("sst/color_mlp"):
            h = fused_mlp(h.contiguous(), [k.contiguous() for k, _ in kbs], [b for _, b in kbs],
                          activation="relu")
        rgb = torch.sigmoid(h)
        if cfg.use_diffuse_color:
            head = self.diffuse_color_pred
            diffuse = torch.sigmoid(geo_features @ head.kernel + head.bias - math.log(3.0))
            if cfg.use_specular_tint:
                tint = self.specular_tint_pred
                rgb = torch.sigmoid(geo_features @ tint.kernel + tint.bias) * rgb
            else:
                rgb = 0.5 * rgb
            rgb = torch.clamp(rgb + diffuse, 0.0, 1.0)
        return rgb * (1 + 2 * cfg.rgb_padding) - cfg.rgb_padding

    def get_inv_s(self) -> torch.Tensor:
        return density_ops.variance_inv_s(self.deviation)

    def get_beta(self) -> torch.Tensor:
        return density_ops.effective_beta(self.laplace_beta)

    def gradient(self, x: torch.Tensor, hash_mask: Optional[torch.Tensor] = None,
                 numerical_delta: Optional[float] = None, return_sampled_sdf: bool = False):
        """d sdf / dx at positions ``x`` [N, 3], contracted first
        (``SDFField.gradient``, sdf_field.py:578-648): analytic, or with
        ``use_numerical_gradients`` by central differences at
        ``numerical_delta`` (default 1e-4, :599), with the taps' SDF [N, 6]
        under ``return_sampled_sdf`` (None in the analytic mode). It stays
        in the graph, so a loss on it reaches the parameters (UniSurf's
        smoothness loss)."""
        x = self.contract_positions(x)
        if self.config.use_numerical_gradients:
            delta = 1e-4 if numerical_delta is None else numerical_delta
            _, grads, sampled = self.numerical_gradient(x, delta, hash_mask)
        else:
            grads, sampled = self.geonetwork_with_gradient(x, train=True, hash_mask=hash_mask)[1], None
        return (grads, sampled) if return_sampled_sdf else grads

    def get_outputs(
        self,
        ray_samples: RaySamples,
        cos_anneal_ratio: float = 1.0,
        return_alphas: bool = False,
        return_occupancy: bool = False,
        train: bool = False,
        hash_mask: Optional[torch.Tensor] = None,
        numerical_delta: Optional[float] = None,
        inv_s_override: Optional[float] = None,
        beta_override: Optional[float] = None,
    ) -> Dict[str, torch.Tensor]:
        """Field forward over ray samples (sdf_field.py:642-765), with the
        step's ``hash_mask`` and, in the numerical mode, its
        ``numerical_delta`` (default 1e-4, :675-677) and the taps' SDF as
        ``sampled_sdf`` [R, S, 6]; ``inv_s_override`` (the annealed beta's
        1 / beta) takes the learned deviation's place in the NeuS alpha
        (:747-750), and ``beta_override`` (BakedSDF's annealed beta) the
        learned ``laplace_beta``'s place in the Laplace density (:736-738).
        Each sample carries its ray's camera index (camera 0
        without one) to the appearance embedding."""
        R, S = ray_samples.num_rays, ray_samples.num_samples
        inputs = ray_samples.get_start_positions().reshape(-1, 3)
        directions = ray_samples.directions[..., None, :].expand(R, S, 3).reshape(-1, 3)
        camera_indices = None
        if ray_samples.camera_indices is not None:
            camera_indices = ray_samples.camera_indices.reshape(R, 1).expand(R, S).reshape(-1)
        inputs = self.contract_positions(inputs)
        points_norm = torch.linalg.vector_norm(inputs, dim=-1)

        sampled_sdf = None
        if self.config.use_numerical_gradients:
            delta = 1e-4 if numerical_delta is None else numerical_delta
            h, gradients, sampled_sdf = self.numerical_gradient(inputs, delta, hash_mask,
                                                                with_centre=True)
        else:
            h, gradients = self.geonetwork_with_gradient(inputs, train=train, hash_mask=hash_mask)
        sdf, geo_feat = h[..., :1], h[..., 1:]
        rgb = self.colors(inputs, directions, gradients, geo_feat, camera_indices, train)
        beta = self.get_beta() if beta_override is None else beta_override
        outputs = {
            "rgb": rgb.reshape(R, S, 3),
            "density": density_ops.laplace_density(sdf[..., 0], beta).reshape(R, S),
            "sdf": sdf.reshape(R, S),
            "gradient": gradients.reshape(R, S, 3),
            "normal": safe_normalize(gradients).reshape(R, S, 3),
            "points_norm": points_norm.reshape(R, S),
        }
        if sampled_sdf is not None:
            outputs["sampled_sdf"] = sampled_sdf.reshape(R, S, 6)
        if return_alphas:
            outputs["alpha"] = density_ops.neus_alpha(
                outputs["sdf"], outputs["gradient"], ray_samples.directions,
                ray_samples.deltas,
                self.get_inv_s() if inv_s_override is None else inv_s_override, cos_anneal_ratio,
            )
        if return_occupancy:
            outputs["occupancy"] = density_ops.unisurf_occupancy(outputs["sdf"])
        return outputs
