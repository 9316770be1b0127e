"""What an installed wheel of the port holds: every file of
``fastsmc_tpu_torch/`` that is not Python source must be named by one of
``pyproject.toml``'s package-data globs, or the installed package lacks it.
The files are matched against the globs as setuptools matches them
(relative to the package's directory); no wheel is built. And where the
native source is absent, ``native.get_lib()`` returns None, so the Python
fallbacks run."""

import tomllib
from pathlib import Path

import numpy as np

from fastsmc_tpu_torch import native

REPO = Path(__file__).resolve().parent.parent
PKG = "fastsmc_tpu_torch"


def _shipped() -> set:
    """Files the package-data globs name under the port's package."""
    with open(REPO / "pyproject.toml", "rb") as fh:
        data = tomllib.load(fh)["tool"]["setuptools"]["package-data"]
    files = set()
    for package, globs in data.items():
        if package != PKG and not package.startswith(PKG + "."):
            continue
        base = REPO.joinpath(*package.split("."))
        for pattern in globs:
            files.update(p for p in base.glob(pattern) if p.is_file())
    return files


def test_every_non_python_file_is_package_data():
    root = REPO / PKG
    data = [p for p in root.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts and p.suffix != ".py"]
    assert data, "the port has no non-Python files?"
    missing = sorted(str(p.relative_to(REPO)) for p in data
                     if p not in _shipped())
    assert not missing, f"left out of the wheel: {missing}"


def test_native_library_is_none_without_its_source(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_SRC", tmp_path / "fastsmc_native.cpp")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert native.get_lib() is None
    # and the callers take their Python fallbacks
    assert native.undistinguished_counts(
        np.zeros(4, np.int32), np.full(4, 10, np.int32), 6, True, 1) is None
