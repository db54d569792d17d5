"""Build and load the port's hand-written CUDA kernels.

Every `qrw_tpu_torch/csrc/*.cu` file is compiled by `nvcc` for Hopper
(`-gencode arch=compute_90a,code=sm_90a`), one nvcc process per source,
all started together, and the objects are linked into ONE shared library
with a plain C interface, at first use, into `qrw_tpu_torch/_build/`
(listed in .gitignore). The library name carries a hash of the sources
and the flags, so an edited source is rebuilt and an unchanged one is
loaded from the cache. The library is loaded with ctypes; the wrappers
in the ops modules set `argtypes` and launch on PyTorch's current
stream.

Nothing here runs at import time: the CPU-only test host has no nvcc.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIB = None
BUILD_SECONDS = None      # wall time of the build (None: loaded cached)
BUILD_LOG = ""            # nvcc's output (ptxas register/spill report)


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are built from "
            "qrw_tpu_torch/csrc at first use and need the CUDA toolkit")
    return path


def sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB, BUILD_SECONDS, BUILD_LOG
    if _LIB is not None:
        return _LIB
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"libqrw_kernels_{h.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
        t0 = time.perf_counter()
        objs = [os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
                for src in srcs]
        procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", obj,
                                   src], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(srcs, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        BUILD_LOG = "".join(logs)
        failed = [src for src, proc in zip(srcs, procs) if proc.returncode]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{BUILD_LOG}")
        tmp = so + f".{os.getpid()}.tmp"
        proc = subprocess.run([_nvcc(), "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        BUILD_LOG += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{BUILD_LOG}")
        for obj in objs:
            os.remove(obj)
        os.replace(tmp, so)
        BUILD_SECONDS = time.perf_counter() - t0
    _LIB = ctypes.CDLL(so)
    return _LIB
