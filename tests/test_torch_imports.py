"""The PyTorch port never imports JAX (or Triton), and chip_smoke.py refuses
to run without CUDA or outside the repository."""

import os
import shutil
import subprocess
import sys

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
