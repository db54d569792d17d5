"""Build and load the port's hand-written CUDA kernels.

Every `qrw_tpu_torch/csrc/*.cu` file is compiled by `nvcc` for Hopper
(`-gencode arch=compute_90a,code=sm_90a`), one nvcc process per source,
all started together, and the objects are linked into ONE shared library
with a plain C interface, at first use, into `qrw_tpu_torch/_build/`
(listed in .gitignore). The library name carries a hash of the sources
and the flags, so an edited source is rebuilt and an unchanged one is
loaded from the cache.

This module is also the one seam between Python and a kernel. The
library is loaded with ctypes and typed from `SIGNATURES`, one entry for
every function the sources export. A launcher in the ops modules checks
its tensors with `check` (which loads nothing, so a refusal never needs
nvcc), then calls `launch` on PyTorch's current stream; `launch` raises
on a CUDA error and counts the launch in `LAUNCHES`, which every reader
of launch counts reads through `launches()`. `query` calls an occupancy
or geometry query through the same error check, uncounted. Adding a
kernel takes its .cu file, its entry in `SIGNATURES` and its launcher.

Nothing here runs at import time: the CPU-only test host has no nvcc.
"""

from __future__ import annotations

import collections
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Every function csrc/*.cu exports, with the kinds of its arguments in
# order (p: a pointer, i: an int, f: a float). Each returns an int.
SIGNATURES = {
    # qp_phase.cu (K1)
    "qrw_qp_phase_geometry": "iip",
    "qrw_qp_phase_max_active_clusters": "iiip",
    "qrw_qp_phase_solve": "p" * 15 + "i" * 7 + "f" * 9 + "p",
    # qp_admm.cu (K2)
    "qrw_qp_admm_stages_A": "ii",
    "qrw_qp_admm_smem_bytes": "ii",
    "qrw_qp_admm_max_smem_bytes": "",
    "qrw_qp_admm_solve": "p" * 16 + "i" * 4 + "f" + "p",
    "qrw_qp_admm_cone_smem_bytes": "iiii",
    "qrw_qp_admm_cone_solve": "if" + "p" * 14 + "i" * 4 + "f" + "p",
    # qp_ns_refine.cu and qp_ns_refine_tc.cu (K3)
    "qrw_ns_refine": "p" * 5 + "i" * 3 + "p",
    "qrw_ns_refine_tc_max_active_clusters": "p",
    "qrw_ns_refine_tc": "p" * 4 + "i" * 3 + "p",
    # qp_kinv.cu (K^-1)
    "qrw_kinv_blocks_per_sm": "ip",
    "qrw_kinv": "p" * 3 + "i" * 2 + "p",
    # ddp_derivs.cu (the DDP derivatives)
    "qrw_ddp_derivs_blocks": "ip",
    "qrw_ddp_derivs": "ipi" + "p" * 18 + "i" * 3 + "p",
    # ddp_linesearch.cu (the DDP line search and accept)
    "qrw_ddp_linesearch": "ipipi" + "p" * 20 + "i" * 4 + "p",
}
_CTYPE = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}

# Launches since the last reset_launches(), by (function, key); the key is
# the launcher's: (cap, tile) for K1, n for K2, K3 and K^-1, the itemsize
# for the DDP derivatives and line search.
LAUNCHES = collections.Counter()

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


def headers():
    """The headers the sources include (part of the build's hash)."""
    return sorted(glob.glob(os.path.join(CSRC, "*.cuh")))


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB, BUILD_SECONDS, BUILD_LOG
    if _LIB is not None:
        return _LIB
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + headers():
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
    lib = ctypes.CDLL(so)
    for name, kinds in SIGNATURES.items():
        if not hasattr(lib, name):
            raise RuntimeError(f"{so} exports no {name}")
        fn = getattr(lib, name)
        fn.argtypes = [_CTYPE[k] for k in kinds]
        fn.restype = ctypes.c_int
    _LIB = lib
    return _LIB


def check(name, t, shape, dtype, device):
    """Refuse `t` as the kernel argument `name` unless it is a tensor on
    `device` of `dtype` and `shape`, contiguous: TypeError for what is
    not a tensor or has another dtype, ValueError otherwise. Loads
    nothing."""
    if not torch.is_tensor(t):
        raise TypeError(f"{name}: expected a tensor")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _call(fn, args):
    err = getattr(library(), fn)(*args)
    if err != 0:
        raise RuntimeError(f"{fn} failed: CUDA error {err}")


def launch(fn, *args, key):
    """Call the library's `fn` with `args` and count the launch under
    (fn, key); RuntimeError where it returns an error."""
    _call(fn, args)
    LAUNCHES[fn, key] += 1


def query(fn, *args, n_out: int = 1):
    """Call the query `fn` with `args` and a last argument through which
    it stores `n_out` ints; return them (an int where n_out is 1).
    RuntimeError where it returns an error."""
    out = (ctypes.c_int * n_out)()
    _call(fn, args + (out,))
    return out[0] if n_out == 1 else tuple(out)


def launches(fn=None) -> collections.Counter:
    """A copy of LAUNCHES; with `fn`, that function's launches by key."""
    if fn is None:
        return collections.Counter(LAUNCHES)
    return collections.Counter({k: v for (f, k), v in LAUNCHES.items()
                                if f == fn})


def reset_launches():
    LAUNCHES.clear()
