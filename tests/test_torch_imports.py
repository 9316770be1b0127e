"""The PyTorch port never imports JAX (or Triton) or anything of the JAX
package, and chip_smoke.py refuses to run without CUDA or outside the
repository."""

import ast
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import fastsmc_tpu_torch
mods = ["fastsmc_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
    fastsmc_tpu_torch.__path__, "fastsmc_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "triton"))
print(len(mods), bad)
assert len(mods) >= 9, mods
assert not bad, bad
"""


_IMPORT_ALL_NO_JAX_PACKAGE = _IMPORT_ALL.replace(
    '("jax", "jaxlib", "triton")',
    '("fastsmc_tpu", "scripts", "jax", "jaxlib", "triton")')


def _clean_env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA", "FASTSMC", "PYTHON"))}
    env["PYTHONPATH"] = REPO
    return env


def test_port_imports_no_jax():
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                       env=_clean_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_port_imports_nothing_of_the_jax_package():
    """Every port module, imported in a clean interpreter, leaves no module
    of the JAX package (top-level name ``fastsmc_tpu``) or of ``scripts``
    loaded, nor JAX, jaxlib or Triton."""
    assert _IMPORT_ALL_NO_JAX_PACKAGE != _IMPORT_ALL
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL_NO_JAX_PACKAGE],
                       cwd=REPO, env=_clean_env(), capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def _imported_packages(path):
    """Top-level names of every import in the file at ``path``, at any
    depth (also inside functions); relative imports give ``"."``."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add("." if node.level else node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("where", ["fastsmc_tpu_torch", "chip_smoke.py",
                                   "tests/test_torch_cuda.py"])
def test_no_source_imports_the_jax_package(where):
    """No file of the port, chip_smoke.py or the card-only tests imports
    ``fastsmc_tpu`` or ``scripts`` (an AST scan of every import)."""
    root = os.path.join(REPO, where)
    files = [root] if where.endswith(".py") else [
        os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
        if f.endswith(".py")]
    assert files
    bad = {f: sorted(_imported_packages(f) & {"fastsmc_tpu", "scripts"})
           for f in files}
    assert not any(bad.values()), bad


def test_chip_smoke_fails_without_cuda_or_repo(tmp_path):
    """In a directory holding only the script, and in the repository on a
    machine without CUDA, chip_smoke.py exits non-zero and prints no
    result."""
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), lone)
    env = _clean_env()
    env.pop("PYTHONPATH")
    runs = [subprocess.run([sys.executable, str(lone)], cwd=str(tmp_path),
                           env=env, capture_output=True, text=True,
                           timeout=300)]
    import torch
    if not torch.cuda.is_available():
        runs.append(subprocess.run(
            [sys.executable, "chip_smoke.py"], cwd=REPO, env=_clean_env(),
            capture_output=True, text=True, timeout=300))
    for r in runs:
        assert r.returncode != 0, r.stdout
        assert '"ok"' not in r.stdout, r.stdout
