"""The port and ``chip_smoke.py`` run on a machine without JAX.

The card's machine has torch, numpy, scipy and the standard library, but no
``jax``, ``flax``, ``yaml``, ``PIL`` or the JAX package. A subprocess whose
import system refuses those names imports every module of
``sdfstudio_tpu_torch`` and compiles ``chip_smoke.py``; an AST scan checks
that ``chip_smoke.py`` and the package import nothing else.
"""
import ast
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "sdfstudio_tpu_torch"
ALLOWED_TOP = {"torch", "numpy", "scipy", "sdfstudio_tpu_torch"}
# the writer's optional backends, as in JAX's writer: imported inside a
# ``try`` at first use, in that file only; neither is on the card's machine
OPTIONAL = {"sdfstudio_tpu_torch/utils/writer.py": {"tensorboardX", "wandb"}}

_CHILD = r"""
import importlib, importlib.abc, pkgutil, sys

REFUSED = ("jax", "jaxlib", "flax", "optax", "yaml", "PIL", "sdfstudio_tpu", "tests", "conftest")

def refused(name):
    # the exact module or its submodules: ``sdfstudio_tpu_torch`` is not ``sdfstudio_tpu``
    return any(name == r or name.startswith(r + ".") for r in REFUSED)

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if refused(name):
            raise ImportError(f"refused import of {name}")
        return None

for name in list(sys.modules):
    if refused(name):
        del sys.modules[name]
sys.meta_path.insert(0, Refuse())

import sdfstudio_tpu_torch
names = [m.name for m in pkgutil.walk_packages(sdfstudio_tpu_torch.__path__, "sdfstudio_tpu_torch.")]
for n in names:
    importlib.import_module(n)
compile(open("chip_smoke.py").read(), "chip_smoke.py", "exec")
bad = sorted(n for n in sys.modules if refused(n))
assert not bad, bad
print("IMPORTED", len(names))
"""


def test_port_imports_without_jax_and_friends():
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD], cwd=REPO, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO)},
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n = int(proc.stdout.split("IMPORTED")[1])
    assert n >= 25, f"only {n} modules found under sdfstudio_tpu_torch"


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _optional_imports(path: pathlib.Path):
    """The modules ``path`` imports inside a ``try`` block."""
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Try):
            for stmt in node.body:
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.Import):
                        yield from (a.name for a in sub.names)
                    elif isinstance(sub, ast.ImportFrom) and sub.level == 0:
                        yield sub.module


def _is_allowed(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ALLOWED_TOP or top in sys.stdlib_module_names


def test_chip_smoke_and_port_import_only_torch_numpy_stdlib():
    files = [REPO / "chip_smoke.py", *sorted(PKG.rglob("*.py"))]

    def optional(f, m):
        rel = str(f.relative_to(REPO))
        return m in OPTIONAL.get(rel, ()) and m in set(_optional_imports(f))

    bad = {f"{f.relative_to(REPO)}: {m}" for f in files for m in _imports(f)
           if not (_is_allowed(m) or optional(f, m))}
    assert not bad, sorted(bad)
    # the card-side test file runs with --noconftest where there is no JAX
    card_tests = REPO / "tests" / "test_torch_kernel_cuda.py"
    bad = {m for m in _imports(card_tests) if not (_is_allowed(m) or m == "pytest")}
    assert not bad, sorted(bad)
    # the prefix trap: the JAX package's name is a prefix of the port's
    assert not _is_allowed("sdfstudio_tpu.ops.mlp") and _is_allowed("sdfstudio_tpu_torch.ops.mlp")


def test_chip_smoke_fails_without_cuda_and_prints_no_result(tmp_path):
    """Alone in a directory, or on a machine without CUDA, it exits non-zero
    and prints no result line."""
    import torch

    (tmp_path / "chip_smoke.py").write_text((REPO / "chip_smoke.py").read_text())
    # with a card, the run from the repo root is the real smoke, not this check
    for cwd in (tmp_path,) if torch.cuda.is_available() else (tmp_path, REPO):
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                              text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
