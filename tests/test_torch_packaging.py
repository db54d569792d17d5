"""The port as an installed package: its data files, console scripts and
the seam to its kernels.

A wheel holds only the files pyproject.toml's package-data globs name, so
every file the port opens from its own package directory at run time must
match one of them: the CUDA sources and headers kernels.py builds, the
IPC library's C++ source (runtime/ipc.SOURCE) and the staircase
heightfield. Each console script must name a callable that exists.
kernels.SIGNATURES must type every function the CUDA sources export as
they declare it, and kernels.check must refuse a bad argument without
loading the library.
"""

import fnmatch
import importlib
import os
import re
import tomllib

import pytest
import torch

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
    return cu + kernels.headers() + [ipc.SOURCE, terrain.STAIRS_HF]


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


def _kind(param):
    param = param.strip()
    if "*" in param:
        return "p"
    return {"int": "i", "float": "f"}.get(param.split()[0], "?")


def _exported():
    """{name: argument kinds} of every `int qrw_*(...)` inside the
    extern "C" blocks of csrc/*.cu."""
    out = {}
    for path in kernels.sources():
        with open(path) as f:
            text = f.read()
        for block in re.findall(r'^extern "C" \{(.*?)^\}  // extern "C"',
                                text, re.S | re.M):
            for name, params in re.findall(r"^int (qrw_\w+)\(([^)]*)\)",
                                           block, re.M):
                out[name] = "".join(_kind(p) for p in params.split(",")
                                    if p.strip())
    return out


EXPORTED = _exported()


@pytest.mark.parametrize("name", sorted(set(EXPORTED)
                                        | set(kernels.SIGNATURES)))
def test_signature_matches_the_declaration(name):
    assert name in EXPORTED, f"{name} is declared by no csrc/*.cu"
    assert kernels.SIGNATURES.get(name) == EXPORTED[name], name


_T = torch.zeros(2, 3)


@pytest.mark.parametrize("t,error,words", [
    (_T.numpy(), TypeError, "expected a tensor"),
    (torch.zeros(2, 3, device="meta"), ValueError, "on meta, expected cpu"),
    (_T.double(), TypeError, "dtype torch.float64, expected torch.float32"),
    (torch.zeros(3, 2), ValueError, r"shape \(3, 2\), expected \(2, 3\)"),
    (torch.zeros(3, 2).t(), ValueError, "not contiguous")],
    ids=["tensor", "device", "dtype", "shape", "contiguity"])
def test_check_refuses_without_loading(monkeypatch, t, error, words):
    def no_library():
        raise AssertionError("check loaded the library")
    monkeypatch.setattr(kernels, "library", no_library)
    kernels.check("K", _T, (2, 3), torch.float32, torch.device("cpu"))
    with pytest.raises(error, match="K: " + words):
        kernels.check("K", t, (2, 3), torch.float32, torch.device("cpu"))


def test_launch_counts_and_query_reads(monkeypatch):
    """A launch that returns 0 is counted under (function, key), one that
    returns an error raises and is not; a query returns what it stored."""
    class Lib:
        def qrw_kinv(self, *args):
            return args[-1]

        def qrw_qp_phase_geometry(self, cap, tile, out):
            out[:] = [cap, tile, 3, 4]
            return 0

    lib = Lib()
    monkeypatch.setattr(kernels, "library", lambda: lib)
    monkeypatch.setattr(kernels, "LAUNCHES", kernels.LAUNCHES.copy())
    kernels.reset_launches()
    kernels.launch("qrw_kinv", 0, key=96)
    kernels.launch("qrw_kinv", 0, key=96)
    with pytest.raises(RuntimeError, match="qrw_kinv failed: CUDA error 2"):
        kernels.launch("qrw_kinv", 2, key=144)
    assert kernels.launches() == {("qrw_kinv", 96): 2}
    assert kernels.launches("qrw_kinv") == {96: 2}
    assert kernels.query("qrw_qp_phase_geometry", 32, 512,
                         n_out=4) == (32, 512, 3, 4)
