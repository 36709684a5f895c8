"""Top-level experiment configuration (counterpart of
``sdfstudio_tpu/configs/base.py``): ``Config`` (base.py:32-140) and the
command line's ``override_nested`` (base.py:145-192).

A run lives in ``<output_dir>/<experiment_name>/<method_name>/<timestamp>/``
(``get_base_dir``), its checkpoints in ``sdfstudio_models/`` under it. The
run's ``config.yml`` holds JAX's ``to_dict`` tree written as JSON text,
which is valid YAML (a float in exponent form carries a decimal point, as
YAML 1.1 needs): the card's machine has no ``yaml``, so ``load_config``
reads it with ``json``. Only the module paths of ``__dataclass__`` and
``__class__`` differ from JAX's; JAX's block-style YAML files are not read
(ROADMAP queue 1 item 14). Lists in the file come back as tuples: every
sequence in the port's config tree is a tuple.
"""
from __future__ import annotations

import dataclasses
import datetime
import importlib
import json
import re
from pathlib import Path
from typing import Any, Dict, Optional

from sdfstudio_tpu_torch.data.datamanager import DataManagerConfig
from sdfstudio_tpu_torch.engine.optimizers import OptimizerGroupConfig
from sdfstudio_tpu_torch.engine.trainer import TrainerConfig

# repo root: configs/base.py -> sdfstudio_tpu_torch -> repo
_REPO_ROOT = Path(__file__).resolve().parents[2]
_PACKAGE = "sdfstudio_tpu_torch"


@dataclasses.dataclass
class Config:
    """A whole experiment (base.py:32-61): JAX's fields and defaults. The
    multi-host ``machine`` (ROADMAP queue 1 item 13), the profiler switch
    and the TPU matmul precision have no counterpart: the port computes in
    f32 on one card. ``seed`` seeds the trainer's batch and jitter
    generator; the model's initialiser keeps its own seed
    (``engine/setup.py::MODEL_SEED``)."""

    method_name: str = "neus"
    experiment_name: str = "experiment"
    timestamp: str = "{timestamp}"
    output_dir: Path = Path("outputs")
    vis: str = "tensorboard"  # tensorboard | wandb | none
    data: Optional[Path] = None
    trainer: TrainerConfig = dataclasses.field(default_factory=TrainerConfig)
    datamanager: DataManagerConfig = dataclasses.field(default_factory=DataManagerConfig)
    model: Any = None  # a *ModelConfig dataclass
    model_class: Optional[type] = None
    dataparser: Any = None  # a *DataParserConfig dataclass
    optimizers: Dict[str, OptimizerGroupConfig] = dataclasses.field(default_factory=dict)
    seed: int = 42

    def get_base_dir(self) -> Path:
        return Path(self.output_dir) / self.experiment_name / self.method_name / self.timestamp

    def get_checkpoint_dir(self) -> Path:
        return self.get_base_dir() / "sdfstudio_models"

    def set_timestamp(self) -> None:
        if self.timestamp == "{timestamp}":
            self.timestamp = datetime.datetime.now().strftime("%Y-%m-%d_%H%M%S")

    # -- serialization (base.py:68-140) ---------------------------------------
    def to_dict(self) -> Dict:
        def ser(obj):
            if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
                d = {"__dataclass__": type(obj).__module__ + ":" + type(obj).__qualname__}
                for f in dataclasses.fields(obj):
                    d[f.name] = ser(getattr(obj, f.name))
                return d
            if isinstance(obj, Path):
                # repo-relative, so that a run survives a checkout mounted elsewhere
                try:
                    return {"__path__": str(Path(obj).resolve().relative_to(_REPO_ROOT))}
                except ValueError:
                    return {"__path__": str(obj)}
            if isinstance(obj, dict):
                return {k: ser(v) for k, v in obj.items()}
            if isinstance(obj, (list, tuple)):
                return [ser(v) for v in obj]
            if isinstance(obj, type):
                return {"__class__": obj.__module__ + ":" + obj.__qualname__}
            return obj

        return ser(self)

    @staticmethod
    def from_dict(data: Dict) -> "Config":
        def resolve(spec: str):
            mod, qual = spec.split(":")
            if mod != _PACKAGE and not mod.startswith(_PACKAGE + "."):
                raise ValueError(f"{spec}: not a class of {_PACKAGE}")
            obj = importlib.import_module(mod)
            for part in qual.split("."):
                obj = getattr(obj, part)
            return obj

        def de(obj):
            if isinstance(obj, dict):
                if "__dataclass__" in obj:
                    cls = resolve(obj["__dataclass__"])
                    names = {f.name for f in dataclasses.fields(cls)}
                    # a field the class no longer has is dropped, as JAX does
                    return cls(**{k: de(v) for k, v in obj.items() if k in names})
                if "__path__" in obj:
                    p = Path(obj["__path__"])
                    return p if p.is_absolute() else _REPO_ROOT / p
                if "__class__" in obj:
                    return resolve(obj["__class__"])
                return {k: de(v) for k, v in obj.items()}
            if isinstance(obj, list):
                return tuple(de(v) for v in obj)
            return obj

        return de(data)

    def save_config(self) -> Path:
        """Write ``config.yml`` to the run's directory (base.py:128-134)."""
        base = self.get_base_dir()
        base.mkdir(parents=True, exist_ok=True)
        path = base / "config.yml"
        path.write_text(_yaml_safe_json(self.to_dict()) + "\n")
        return path

    @staticmethod
    def load_config(path: Path) -> "Config":
        return Config.from_dict(json.loads(Path(path).read_text()))


_JSON_STRING = re.compile(r'"(?:[^"\\]|\\.)*"')
_BARE_EXPONENT = re.compile(r"(?<![\w.])(-?\d+)([eE][-+]?\d+)")


def _yaml_safe_json(tree) -> str:
    """``json.dumps`` text that YAML 1.1 readers (PyYAML) read to the same
    values: a float in exponent form gets a decimal point (``1e-15`` ->
    ``1.0e-15``), which YAML 1.1 needs to read it as a float."""
    text = json.dumps(tree, indent=2, allow_nan=False)
    out, pos = [], 0
    for m in _JSON_STRING.finditer(text):
        out.append(_BARE_EXPONENT.sub(r"\1.0\2", text[pos:m.start()]))
        out.append(m.group(0))
        pos = m.end()
    out.append(_BARE_EXPONENT.sub(r"\1.0\2", text[pos:]))
    return "".join(out)


def override_nested(obj: Any, dotted_path: str, raw_value: str):
    """Apply a ``--a.b.c value`` override onto a nested tree of (frozen)
    dataclasses and dicts, with JAX's conversions by the current value's
    type (base.py:145-192): bool, int, float, Path, tuple, and a literal
    parse where the current value is None."""
    parts = dotted_path.replace("-", "_").split(".")

    def convert(current, raw: str):
        if isinstance(current, bool):
            return raw.lower() in ("true", "1", "yes")
        if isinstance(current, int):
            return int(raw)
        if isinstance(current, float):
            return float(raw)
        if isinstance(current, Path):
            return Path(raw)
        if isinstance(current, tuple):
            vals = [v for v in raw.replace("(", "").replace(")", "").split(",") if v]
            elem = current[0] if current else 0
            return tuple(type(elem)(v) for v in vals)
        if current is None:
            for cast in (int, float):
                try:
                    return cast(raw)
                except ValueError:
                    pass
            if raw.lower() in ("true", "false"):
                return raw.lower() == "true"
            return raw
        return type(current)(raw)

    def rec(o, parts):
        name = parts[0]
        if isinstance(o, dict):
            sub = o[name]
            out = dict(o)
            out[name] = convert(sub, raw_value) if len(parts) == 1 else rec(sub, parts[1:])
            return out
        current = getattr(o, name)
        new = convert(current, raw_value) if len(parts) == 1 else rec(current, parts[1:])
        return dataclasses.replace(o, **{name: new})

    return rec(obj, parts)
