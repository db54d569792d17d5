"""ctypes bindings for the host IPC runtime: seqlock mailboxes and pacer.

Port of qrw_tpu/runtime/ipc.py. The port keeps its own copy of the
C++ source, `qrw_tpu_torch/csrc/qrw_ipc.cpp` (byte-equal to
native/qrw_ipc.cpp; tests/test_torch_import.py holds it so), and
builds it at first use with the host C++ compiler and the flags of
native/Makefile into `qrw_tpu_torch/_build/` (git-ignored), under a
name that carries a hash of the source and the flags. The mailbox
layout is the same as the JAX package's, so a port `Mailbox` reads what
a qrw_tpu `Mailbox` wrote under the same name. This is host code, not a
kernel: nothing here touches the card.

    Mailbox(name, shape)   latest-value f64 mailbox (seqlock: a writer
                           never blocks; read() is None when nothing new
                           arrived since the last read)
    Pacer(period_s)        absolute-deadline clock_nanosleep + spin tail;
                           wait() returns the lateness, overruns counts
                           periods missed by more than one period
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "qrw_ipc.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
# native/Makefile's CXXFLAGS and LDFLAGS
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra"]
LD_FLAGS = ["-shared", "-lrt", "-lpthread"]

_lib = None
BUILD_SECONDS = None      # wall time of the g++ build (None: loaded cached)


def _cxx() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler (g++) to build "
                           f"{SOURCE}")
    return cxx


def _build_lib() -> str:
    """Path of the built library, compiled now if this source and these
    flags were not built before. A failed build raises."""
    global BUILD_SECONDS
    with open(SOURCE, "rb") as f:
        src = f.read()
    h = hashlib.sha256(" ".join(CXX_FLAGS + LD_FLAGS).encode() + src)
    so = os.path.join(BUILD_DIR, f"libqrw_ipc_{h.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        t0 = time.perf_counter()
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.run([_cxx(), *CXX_FLAGS, SOURCE, "-o", tmp,
                               *LD_FLAGS], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building {SOURCE} failed "
                               f"({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so)     # atomic: concurrent builds agree
        BUILD_SECONDS = time.perf_counter() - t0
    return so


def load_library() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(_build_lib())
    lib.qrw_mailbox_create.restype = ctypes.c_void_p
    lib.qrw_mailbox_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                       ctypes.c_int]
    lib.qrw_mailbox_destroy.restype = None
    lib.qrw_mailbox_destroy.argtypes = [ctypes.c_void_p]
    lib.qrw_mailbox_write.restype = ctypes.c_uint64
    lib.qrw_mailbox_write.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_uint64]
    lib.qrw_mailbox_read.restype = ctypes.c_uint64
    lib.qrw_mailbox_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_uint64, ctypes.c_uint64]
    lib.qrw_mailbox_seq.restype = ctypes.c_uint64
    lib.qrw_mailbox_seq.argtypes = [ctypes.c_void_p]
    lib.qrw_pacer_create.restype = ctypes.c_void_p
    lib.qrw_pacer_create.argtypes = [ctypes.c_long, ctypes.c_long]
    lib.qrw_pacer_destroy.restype = None
    lib.qrw_pacer_destroy.argtypes = [ctypes.c_void_p]
    lib.qrw_pacer_wait.restype = ctypes.c_long
    lib.qrw_pacer_wait.argtypes = [ctypes.c_void_p]
    lib.qrw_pacer_overruns.restype = ctypes.c_uint64
    lib.qrw_pacer_overruns.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


class Mailbox:
    """Latest-value shared-memory mailbox for a fixed-shape f64 array.

    Writers publish whole arrays (seqlock: never blocks); readers poll
    `read()`, which returns the newest consistent snapshot, or None when
    nothing new arrived since the last read. The creator unlinks the
    shared-memory object on close."""

    def __init__(self, name: str, shape, create: bool = True):
        self._lib = load_library()
        self.shape = tuple(shape)
        self.nbytes = int(np.prod(self.shape)) * 8
        self._buf = np.zeros(self.shape, np.float64)
        self._h = self._lib.qrw_mailbox_create(
            name.encode(), self.nbytes, 1 if create else 0)
        if not self._h:
            raise OSError(f"mailbox {name!r} create failed")
        self._seen = 0

    def write(self, arr) -> int:
        a = np.ascontiguousarray(arr, np.float64)
        if a.shape != self.shape:
            raise ValueError(f"mailbox of shape {self.shape} given "
                             f"{a.shape}")
        return int(self._lib.qrw_mailbox_write(
            self._h, a.ctypes.data_as(ctypes.c_void_p), self.nbytes))

    def read(self) -> Optional[np.ndarray]:
        seq = int(self._lib.qrw_mailbox_read(
            self._h, self._buf.ctypes.data_as(ctypes.c_void_p),
            self.nbytes, self._seen))
        if seq == self._seen:
            return None
        self._seen = seq
        return self._buf.copy()

    @property
    def seq(self) -> int:
        return int(self._lib.qrw_mailbox_seq(self._h))

    def close(self):
        if self._h:
            self._lib.qrw_mailbox_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class Pacer:
    """Absolute-deadline real-time pacer (clock_nanosleep + spin tail)."""

    def __init__(self, period_s: float, spin_s: float = 100e-6):
        self._lib = load_library()
        self._h = self._lib.qrw_pacer_create(int(period_s * 1e9),
                                             int(spin_s * 1e9))

    def wait(self) -> float:
        """Block until the next period boundary; returns lateness [s]."""
        return self._lib.qrw_pacer_wait(self._h) * 1e-9

    @property
    def overruns(self) -> int:
        return int(self._lib.qrw_pacer_overruns(self._h))

    def close(self):
        if self._h:
            self._lib.qrw_pacer_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
