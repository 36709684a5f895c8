"""Carry a JAX model's parameters into the port.

``params_from_jax(model, tree)`` takes the JAX model's ``params`` as nested
dicts of numpy arrays (``{"field": {...}, "proposal_networks": {"0": ...}}``)
and copies each leaf into the port model's parameter of the same path:

* Flax ``WNLinear`` (``kernel [in, out]``, ``g [out]``, ``bias``) and
  ``_DenseParams`` (``kernel [in, out]``, ``bias``) keep their layout: the
  port's layers use ``[in, out]`` kernels too (ops/mlp.py:49-88, 142-155);
* the hash-grid and permutohedral ``hash_table [rows, F]`` keep their layout;
* a proposal field's ``MLP_0/layer_j`` becomes ``mlp.layers.j``, and its
  ``HashEncoding_0/hash_table`` becomes ``encoding.hash_table``.

It raises on any missing, extra or mis-shaped leaf. The JAX tree's
``field_background/dummy`` (a placeholder group, base_surface_model.py:104)
is the one leaf that has no counterpart and is accepted as such.

``opt_state_from_jax(optimizers, opt_state)`` carries optax's state into
the port's per-group Adam (engine/optimizers.py): for each group, the
``ScaleByAdamState`` (count, mu, nu) inside ``multi_transform``'s
``MaskedState`` chain, whose moment trees map leaf for leaf like the
parameters. The chain's ``ScaleByScheduleState`` count must equal Adam's,
because the port reads the schedule at Adam's count. The optax objects are
read by their attributes, so this module imports nothing of JAX.

``load_jax_checkpoint(model, optimizers, path)`` does both from a JAX
packed checkpoint directory (``step-XXXXXXXXX/``, written by the JAX
trainer's ``save_checkpoint``, trainer.py:744-767), read by
``utils/jax_checkpoint.py`` with numpy alone, and returns its step.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Mapping

import numpy as np
import torch

from sdfstudio_tpu_torch.utils.jax_checkpoint import read_packed

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
    key = jax_key.replace("MLP_0.", "mlp.").replace("HashEncoding_0.", "encoding.")
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


def _map_tree(tree: Mapping, prefix: str, names) -> Dict[str, np.ndarray]:
    """Leaves of ``tree`` keyed by the port parameter name, checked against ``names``."""
    flat = {_port_key(f"{prefix}{k}"): v for k, v in _flatten(tree).items()}
    missing, extra = sorted(set(names) - set(flat)), sorted(set(flat) - set(names))
    if missing or extra:
        raise ValueError(f"opt_state_from_jax: extra JAX leaves {extra}; missing port params {missing}")
    return flat


def opt_state_from_jax(optimizers: Mapping, opt_state) -> None:
    """Load optax's per-group Adam state into ``optimizers`` ({group: GroupAdam}) in place."""
    inner = opt_state.inner_states
    for group, opt in optimizers.items():
        chain = getattr(inner[group], "inner_state", inner[group])
        adam = [s for s in chain if hasattr(s, "mu") and hasattr(s, "nu")]
        if len(adam) != 1:
            raise ValueError(f"opt_state_from_jax: group {group} has no single Adam state")
        count = int(np.asarray(adam[0].count))
        others = [int(np.asarray(s.count)) for s in chain if hasattr(s, "count") and not hasattr(s, "mu")]
        if any(c != count for c in others):
            raise ValueError(f"opt_state_from_jax: group {group} schedule counts {others} != Adam count {count}")
        mu = _map_tree(adam[0].mu[group], f"{group}.", opt.names)
        nu = _map_tree(adam[0].nu[group], f"{group}.", opt.names)
        dev = opt.params[0].device if opt.params else "cpu"

        def tensors(flat):
            return [torch.from_numpy(np.array(flat[n], dtype=np.float32)).to(dev) for n in opt.names]

        opt.load_state(count, tensors(mu), tensors(nu))


def load_jax_checkpoint(model: torch.nn.Module, optimizers: Mapping, path) -> int:
    """Load a JAX packed checkpoint directory into ``model`` and
    ``optimizers`` ({group: GroupAdam}) in place; returns its step
    (``step.txt``). Its ``rng`` key is dropped (utils/jax_checkpoint.py)."""
    path = Path(path)
    step = int((path / "step.txt").read_text())
    tree, _ = read_packed(path)
    params_from_jax(model, tree["params"])
    opt_state_from_jax(optimizers, tree["opt_state"])
    return step
