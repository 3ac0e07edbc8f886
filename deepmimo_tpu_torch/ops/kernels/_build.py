"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` launcher. At first
use it is compiled for Hopper (``sm_90a``) into ``build/kernels/`` beside
the package, under a file name keyed by a hash of the source, the shared
headers ``csrc/*.cuh`` and the flags, so an edit rebuilds and an
unchanged source is reused. The
compiler's ``-Xptxas -v`` report (registers, shared memory, spills) is kept
beside the library; :func:`build_log` returns it.

Building needs ``nvcc`` (on ``PATH``, or under ``/usr/local/cuda/bin``);
nothing here runs when a module is imported.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (needed to build the CUDA "
                           "kernels in " + CSRC_DIR + ")")
    return path


def _paths(name: str):
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src] + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(f.read())
    stem = os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}")
    return src, stem + ".so", stem + ".log"


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless already built; returns the .so."""
    src, lib, log = _paths(name)
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    with open(log, "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, lib)        # atomic: no process loads a partial file
    return lib


def build_log(name: str) -> str:
    """The nvcc/ptxas report of the current build of ``name``."""
    _, _, log = _paths(name)
    with open(log) as f:
        return f.read()


def launcher(name: str, n_ptr: int, n_int: int, n_float: int = 0):
    """``<name>_launch`` of ``csrc/<name>.cu`` with its argument types:
    ``n_ptr`` pointers, ``n_int`` ints, ``n_float`` floats, then the
    stream; returns an int (the launch's cudaError_t)."""
    fn = getattr(load_library(name), f"{name}_launch")
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + \
        [ctypes.c_float] * n_float + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def load_library(name: str) -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/<name>.cu``; cached."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _LIBS[name] = lib
    return lib
