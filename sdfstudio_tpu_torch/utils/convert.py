"""Carry a JAX model's parameters into the port.

``params_from_jax(model, tree)`` takes the JAX model's ``params`` as nested
dicts of numpy arrays (``{"field": {...}, "proposal_networks": {"0": ...}}``)
and copies each leaf into the port model's parameter of the same path:

* Flax ``WNLinear`` (``kernel [in, out]``, ``g [out]``, ``bias``) and
  ``_DenseParams`` (``kernel [in, out]``, ``bias``) keep their layout: the
  port's layers use ``[in, out]`` kernels too (ops/mlp.py:49-88, 142-155);
* the permutohedral ``hash_table [rows, F]`` keeps its layout;
* ``MLP_0/layer_j`` becomes ``mlp.layers.j``.

It raises on any missing, extra or mis-shaped leaf. The JAX tree's
``field_background/dummy`` (a placeholder group, base_surface_model.py:104)
is the one leaf that has no counterpart and is accepted as such.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_PLACEHOLDERS = {"field_background.dummy"}


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = np.asarray(v)
    return out


def _port_key(jax_key: str) -> str:
    key = jax_key.replace("MLP_0.", "mlp.")
    return re.sub(r"layer_(\d+)", r"layers.\1", key)


def params_from_jax(model: torch.nn.Module, tree: Mapping) -> torch.nn.Module:
    """Load the JAX ``params`` tree into ``model`` in place; returns ``model``."""
    flat = _flatten(tree)
    params = dict(model.named_parameters())
    mapped = {}
    extra = []
    for jk, arr in flat.items():
        if jk in _PLACEHOLDERS:
            continue
        pk = _port_key(jk)
        if pk not in params:
            extra.append(jk)
        else:
            mapped[pk] = (jk, arr)
    missing = sorted(set(params) - set(mapped))
    if extra or missing:
        raise ValueError(f"params_from_jax: extra JAX leaves {extra}; missing port params {missing}")
    for pk, (jk, arr) in mapped.items():
        p = params[pk]
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(
                f"params_from_jax: {jk} has shape {tuple(arr.shape)}, port {pk} has {tuple(p.shape)}"
            )
    with torch.no_grad():
        for pk, (_, arr) in mapped.items():
            params[pk].copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))
    return model
