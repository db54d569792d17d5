"""The port as an installed package: its data files and console scripts.

A wheel holds only the files pyproject.toml's package-data globs name, so
every file the port opens from its own package directory at run time must
match one of them: the CUDA sources kernels.py builds, the IPC library's
C++ source (runtime/ipc.SOURCE) and the staircase heightfield. Each
console script must name a callable that exists.
"""

import fnmatch
import importlib
import os
import tomllib

import pytest

import qrw_tpu_torch
from qrw_tpu_torch import kernels
from qrw_tpu_torch.runtime import ipc
from qrw_tpu_torch.sim import terrain
from tests.torch_threads import single_thread

single_thread()

PKG = os.path.dirname(os.path.abspath(qrw_tpu_torch.__file__))
ROOT = os.path.dirname(PKG)

with open(os.path.join(ROOT, "pyproject.toml"), "rb") as _f:
    PROJECT = tomllib.load(_f)


def _runtime_files():
    """Every file the port reads from its package directory at run
    time."""
    cu = kernels.sources()
    assert cu, "no CUDA sources"
    return cu + [ipc.SOURCE, terrain.STAIRS_HF]


@pytest.mark.parametrize("path", [os.path.relpath(p, PKG)
                                  for p in _runtime_files()])
def test_runtime_file_is_package_data(path):
    globs = PROJECT["tool"]["setuptools"]["package-data"]["qrw_tpu_torch"]
    assert os.path.isfile(os.path.join(PKG, path)), path
    assert not path.startswith(".."), path
    assert any(fnmatch.fnmatch(path, g) for g in globs), (path, globs)


@pytest.mark.parametrize("name,target", [
    ("qrw-tpu-torch", "qrw_tpu_torch.runtime.main:main"),
    ("qrw-tpu-torch-analyze", "qrw_tpu_torch.eval.analyze:main")])
def test_console_script(name, target):
    assert PROJECT["project"]["scripts"][name] == target
    mod, fn = target.split(":")
    assert callable(getattr(importlib.import_module(mod), fn))
