"""Read the JAX package's packed checkpoints with numpy alone.

A packed checkpoint (``sdfstudio_tpu/utils/fast_checkpoint.py:29-78``, saved
by ``engine/trainer.py:744-767``) is a directory with

* ``packed.npz``: ``floats`` (every floating leaf, cast to f32, flattened and
  concatenated) and ``others`` (every other leaf, cast to int32);
* ``structure.json``: ``treedef`` (``str`` of the ``PyTreeDef`` of
  ``{params, opt_state, model_state, rng}``), ``num_leaves``, ``float_idx``,
  ``other_idx`` and ``leaves`` (shape and dtype of each leaf, in flatten
  order).

The leaf paths are only in the ``treedef`` string, whose grammar is small:

    PyTreeDef(node)
    node := '*' | 'None' | '{' [key ':' node {',' key ':' node}] '}'
          | '(' [node {',' node} [',']] ')' | '[' [node {',' node}] ']'
          | 'CustomNode(namedtuple[' Name '], [' [node {',' node}] '])'

``read_packed`` parses it by recursive descent, walks the tree in flatten
order (dict children in the order printed, which is JAX's sorted-key
order) and gives each leaf its path (written as ``jax.tree_util.keystr``
writes it), shape and dtype from ``leaves``. The optax states come back as
small named tuples with optax's field names (``PartitionState``,
``MaskedState``, ``ScaleByAdamState``, ``ScaleByScheduleState``,
``MaskedNode``), so ``utils/convert.py::opt_state_from_jax`` reads them as
it reads optax's own. A node name it does not know, a leaf count or a
packed size that disagrees, or a leaf dtype other than f32 / int32 /
uint32 raises: nothing is guessed.

The ``rng`` leaf (a uint32 key stored as int32) is read and dropped by
``load_jax_checkpoint``: JAX's PRNG and torch's generators never produce
the same numbers, so it has no counterpart in the port.
"""
from __future__ import annotations

import collections
import json
from pathlib import Path
from typing import Any, Dict, List, Tuple

import numpy as np

# optax's state types by name, with their fields in flatten order
NAMEDTUPLES = {
    name: collections.namedtuple(name, fields)
    for name, fields in (
        ("PartitionState", ("inner_states",)),
        ("MaskedState", ("inner_state",)),
        ("ScaleByAdamState", ("count", "mu", "nu")),
        ("ScaleByScheduleState", ("count",)),
        ("MaskedNode", ()),
    )
}
DTYPES = ("float32", "int32", "uint32")


class _Leaf:
    """A ``*`` of the treedef: filled with its array in flatten order."""


class _Parser:
    def __init__(self, text: str):
        self.s, self.i = text, 0

    def error(self, what: str) -> ValueError:
        return ValueError(f"treedef: {what} at offset {self.i}: {self.s[self.i:self.i + 40]!r}")

    def skip(self) -> None:
        while self.i < len(self.s) and self.s[self.i] == " ":
            self.i += 1

    def peek(self, tok: str) -> bool:
        self.skip()
        return self.s.startswith(tok, self.i)

    def eat(self, tok: str) -> None:
        if not self.peek(tok):
            raise self.error(f"expected {tok!r}")
        self.i += len(tok)

    def name(self) -> str:
        self.skip()
        j = self.i
        while j < len(self.s) and (self.s[j].isalnum() or self.s[j] == "_"):
            j += 1
        if j == self.i:
            raise self.error("expected a name")
        out, self.i = self.s[self.i:j], j
        return out

    def key(self):
        self.skip()
        q = self.s[self.i] if self.i < len(self.s) else ""
        if q in "'\"":
            j = self.s.index(q, self.i + 1)
            out, self.i = self.s[self.i + 1:j], j + 1
            return out
        tok = self.name()
        if tok.lstrip("-").isdigit():
            return int(tok)
        raise self.error("expected a string or integer dict key")

    def items(self, close: str, item) -> list:
        """``item``s separated by commas up to ``close`` (a trailing comma
        allowed, as in a 1-tuple)."""
        out = []
        while not self.peek(close):
            out.append(item())
            if not self.peek(","):
                break
            self.eat(",")
        self.eat(close)
        return out

    def node(self):
        if self.peek("*"):
            self.eat("*")
            return _Leaf()
        if self.peek("None"):
            self.eat("None")
            return None
        if self.peek("{"):
            self.eat("{")

            def entry():
                k = self.key()
                self.eat(":")
                return k, self.node()

            return dict(self.items("}", entry))
        if self.peek("("):
            self.eat("(")
            return tuple(self.items(")", self.node))
        if self.peek("["):
            self.eat("[")
            return self.items("]", self.node)
        if self.peek("CustomNode("):
            self.eat("CustomNode(")
            self.eat("namedtuple[")
            name = self.name()
            self.eat("]")
            self.eat(",")
            self.eat("[")
            children = self.items("]", self.node)
            self.eat(")")
            if name not in NAMEDTUPLES:
                raise self.error(f"unknown node type {name}")
            cls = NAMEDTUPLES[name]
            if len(children) != len(cls._fields):
                raise self.error(f"{name} has {len(children)} children, expected {len(cls._fields)}")
            return cls(*children)
        raise self.error("unknown node")


def parse_treedef(text: str):
    """The tree of a ``str(PyTreeDef)`` with a ``_Leaf`` at every ``*``."""
    p = _Parser(text)
    p.eat("PyTreeDef(")
    tree = p.node()
    p.eat(")")
    p.skip()
    if p.i != len(text):
        raise p.error("trailing text")
    return tree


def _walk(tree, path: str, out: List[Tuple[str, Any]]) -> None:
    """(path, leaf) in JAX's flatten order; paths as ``jax.tree_util.keystr``."""
    if isinstance(tree, _Leaf):
        out.append((path, tree))
    elif tree is None:
        return
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _walk(v, f"{path}[{k!r}]", out)
    elif hasattr(tree, "_fields"):
        for f in tree._fields:
            _walk(getattr(tree, f), f"{path}.{f}", out)
    else:  # tuple or list
        for i, v in enumerate(tree):
            _walk(v, f"{path}[{i}]", out)


def _fill(tree, values: Dict[int, np.ndarray]):
    """The tree with each ``_Leaf`` replaced by its array."""
    if isinstance(tree, _Leaf):
        return values[id(tree)]
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _fill(v, values) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*[_fill(getattr(tree, f), values) for f in tree._fields])
    return type(tree)(_fill(v, values) for v in tree)


def read_packed(path) -> Tuple[Dict[str, Any], List[Tuple[str, np.ndarray]]]:
    """(tree, [(path, array)] in flatten order) of the packed checkpoint in
    directory ``path``: the tree is ``{params, opt_state, model_state, rng}``
    with numpy arrays at the leaves."""
    path = Path(path)
    meta = json.loads((path / "structure.json").read_text())
    tree = parse_treedef(meta["treedef"])
    slots: List[Tuple[str, Any]] = []
    _walk(tree, "", slots)
    leaves = meta["leaves"]
    n = meta["num_leaves"]
    if not len(slots) == len(leaves) == n:
        raise ValueError(f"{path}: treedef has {len(slots)} leaves, leaves {len(leaves)}, "
                         f"num_leaves {n}")
    if sorted(meta["float_idx"] + meta["other_idx"]) != list(range(n)):
        raise ValueError(f"{path}: float_idx and other_idx do not partition the {n} leaves")
    with np.load(path / "packed.npz") as data:
        packs = {"float_idx": np.asarray(data["floats"]), "other_idx": np.asarray(data["others"])}
    if packs["float_idx"].dtype != np.float32 or packs["other_idx"].dtype != np.int32:
        raise ValueError(f"{path}: packed dtypes {packs['float_idx'].dtype}, {packs['other_idx'].dtype}")
    arrays: List[np.ndarray] = [None] * n
    for which, flat in packs.items():
        off = 0
        for i in meta[which]:
            shape, dtype = tuple(leaves[i]["shape"]), leaves[i]["dtype"]
            if dtype not in DTYPES or (which == "float_idx") != (dtype == "float32"):
                raise ValueError(f"{path}: leaf {slots[i][0]} has dtype {dtype} in {which}")
            size = int(np.prod(shape, dtype=np.int64))
            if off + size > flat.size:
                raise ValueError(f"{path}: {which} holds {flat.size} values, leaf {slots[i][0]} "
                                 f"ends at {off + size}")
            chunk = flat[off:off + size].reshape(shape)
            # a uint32 leaf was stored as int32: the same bits
            arrays[i] = chunk.view(np.uint32) if dtype == "uint32" else chunk.copy()
            off += size
        if off != flat.size:
            raise ValueError(f"{path}: {which} holds {flat.size} values, the leaves take {off}")
    filled = _fill(tree, {id(leaf): a for (_, leaf), a in zip(slots, arrays)})
    return filled, [(p, a) for (p, _), a in zip(slots, arrays)]
