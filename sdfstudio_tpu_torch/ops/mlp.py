"""MLP building blocks (counterpart of ``sdfstudio_tpu/ops/mlp.py``).

Kernels keep the JAX layout ``[in, out]`` so the fused kernel and the
converter take them as they are. Initialisers draw from the same
distributions as the JAX ones (not the same numbers: a ``torch.Generator``
is not a JAX key), so a seeded port model is a valid fresh model of the
configuration.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from sdfstudio_tpu_torch.ops.fused_mlp import ACTIVATIONS, _act, fused_mlp


def softplus_beta100(x: torch.Tensor) -> torch.Tensor:
    """softplus(100 x) / 100 (mlp.py:23-26), in the numerically stable
    max(t, 0) + log1p(exp(-|t|)) form that ``jax.nn.softplus`` uses."""
    t = 100.0 * x
    return (torch.clamp(t, min=0.0) + torch.log1p(torch.exp(-torch.abs(t)))) / 100.0


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax ``lecun_normal``: truncated normal (+-2 sigma), variance 1/fan_in,
    fan_in = w.shape[0] in the [in, out] layout."""
    std = math.sqrt(1.0 / w.shape[0]) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class WNLinear(nn.Module):
    """Weight-normalised linear layer (mlp.py:49-88): the effective kernel is
    ``g * V / ||V||`` with the norm over the input axis, ``V [in, out]``."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_dim, out_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim))
        self.g = nn.Parameter(torch.ones(out_dim))

    def effective(self):
        """(kernel, bias) as the layer applies them (mlp.py:72-82)."""
        norm = torch.linalg.vector_norm(self.kernel, dim=0, keepdim=True)
        return self.kernel * (self.g / torch.clamp(norm, min=1e-12)), self.bias

    @torch.no_grad()
    def set_init(self, kernel: torch.Tensor, bias: torch.Tensor) -> None:
        """Raw init; ``g`` starts at the column norms so the effective kernel
        equals the raw one (torch weight_norm semantics, mlp.py:67-71)."""
        self.kernel.copy_(kernel)
        self.bias.copy_(bias)
        self.g.copy_(torch.linalg.vector_norm(kernel, dim=0))


def geometric_init(
    layer: int,
    num_hidden_layers: int,
    in_dim0: int,
    shape: Sequence[int],
    bias: float,
    inside_outside: bool,
    skip_in: Sequence[int],
    generator: torch.Generator,
):
    """(kernel, bias) of the SDF geometry MLP's layer ``layer`` (mlp.py:91-131):
    the sphere init, so that sdf(x) starts near |x| - bias."""
    fan_in, fan_out = shape
    last = num_hidden_layers

    def normal(s):
        return torch.randn(s, generator=generator)

    if layer == last:
        mean = math.sqrt(math.pi) / math.sqrt(fan_in)
        if inside_outside:
            mean = -mean
        k = mean + 1e-4 * normal(shape)
        b = torch.full((fan_out,), bias if inside_outside else -bias)
        return k, b
    if layer == 0:
        k = torch.zeros(shape)
        k[:3, :] = normal((3, fan_out)) * (math.sqrt(2) / math.sqrt(fan_out))
    else:
        k = normal(shape) * (math.sqrt(2) / math.sqrt(fan_out))
        if layer in skip_in:
            k[-(in_dim0 - 3):, :] = 0.0
    return k, torch.zeros(fan_out)


def kaiming_uniform(shape: Sequence[int], generator: torch.Generator) -> torch.Tensor:
    """U(-sqrt(6/fan_in), sqrt(6/fan_in)), fan_in = shape[0] (mlp.py:134-139)."""
    bound = math.sqrt(6.0 / shape[0])
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


class DenseLayer(nn.Module):
    """``kernel [in, out]`` and ``bias [out]``, as ``_DenseParams`` holds them (mlp.py:142-155)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_dim, out_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim))


class MLP(nn.Module):
    """Generic MLP with skip connections (mlp.py:187-245), parameters
    ``layers.i`` (JAX's ``layer_i``). A skip-free MLP whose activations are
    relu, softplus100 or none runs as one fused kernel; an MLP with skips,
    or with a ``"sigmoid"`` output (which JAX's fused kernel does not take
    either, mlp.py:156-167), takes the plain product layer by layer
    (``torch.matmul``, cuBLAS on the card), as JAX does (mlp.py:224-245):
    layer ``i`` in ``skip_connections`` (``i > 0``) takes ``[inputs, h]``."""

    def __init__(
        self,
        in_dim: int,
        num_layers: int,
        layer_width: int,
        out_dim: Optional[int] = None,
        skip_connections: Sequence[int] = (),
        activation: str = "relu",
        out_activation: str = "none",
    ):
        super().__init__()
        if activation not in ACTIVATIONS or out_activation not in (*ACTIVATIONS, "sigmoid"):
            raise ValueError(f"unsupported activation {activation!r} / {out_activation!r}; one of "
                             f"{sorted(ACTIVATIONS)} (and 'sigmoid' for the output)")
        self.skips = frozenset(s for s in skip_connections if s > 0)
        self.fused = not self.skips and out_activation in ACTIVATIONS
        dims = []
        d = in_dim
        for i in range(num_layers):
            if i in self.skips:
                d = in_dim + layer_width
            width = layer_width if i < num_layers - 1 else (out_dim or layer_width)
            dims.append((d, width))
            d = width
        self.layers = nn.ModuleList(DenseLayer(a, b) for a, b in dims)
        self.activation = activation
        self.out_activation = out_activation

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in self.layers:
            lecun_normal_(layer.kernel, generator)
            layer.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused:
            return fused_mlp(
                x.contiguous(),
                [layer.kernel for layer in self.layers],
                [layer.bias for layer in self.layers],
                self.activation,
                self.out_activation,
            )
        return self.forward_plain(x)

    def forward_plain(self, x: torch.Tensor) -> torch.Tensor:
        """The plain product layer by layer, which a double backward can
        take (the fused kernel's backward is differentiable once)."""
        inputs = h = x
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            if i in self.skips:
                h = torch.cat([inputs, h], dim=-1)
            h = torch.matmul(h, layer.kernel) + layer.bias
            if i < n - 1:
                h = _act(h, self.activation)
            else:
                h = torch.sigmoid(h) if self.out_activation == "sigmoid" else _act(h, self.out_activation)
        return h
