"""Native (C++) accelerators, loaded via ctypes.

Currently: a fast .paths.p2m parser (the InSite converter's hot CPU loop),
``p2m_parser.cpp`` beside this file, a copy of the JAX package's. At first
use it is compiled with g++ into ``build/native/`` beside the package,
under a file name keyed by a hash of the source and the flags, and
replaced atomically, as ``ops/kernels/_build.py`` does for the CUDA
sources; nothing is built into the package directory. If the toolchain is
unavailable the callers fall back to pure Python (a message is printed).

``NATIVE_PARSES`` counts the files parsed by the native route, so a caller
can tell that a conversion really went through it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict, Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "p2m_parser.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "native")
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

NATIVE_PARSES = 0         # files parsed by the native route

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def library_path() -> str:
    """The shared library's path, keyed by the source and the flags."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libp2m_parser-{digest.hexdigest()[:16]}.so")


def _build(lib: str) -> bool:
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = ["g++", *CXX_FLAGS, "-o", tmp, _SRC]
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        print(f"[deepmimo_tpu_torch.native] p2m parser build failed: {e}; "
              "falling back to the Python parser")
        return False
    os.replace(tmp, lib)        # atomic: no process loads a partial file
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        path = library_path()
        if not os.path.exists(path) and not _build(path):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            print(f"[deepmimo_tpu_torch.native] load failed: {e}")
            _build_failed = True
            return None
        lib.p2m_count_rxs.argtypes = [ctypes.c_char_p]
        lib.p2m_count_rxs.restype = ctypes.c_int
        fptr = ctypes.POINTER(ctypes.c_float)
        lib.p2m_parse_paths.argtypes = [ctypes.c_char_p] + \
            [ctypes.c_int] * 3 + [fptr] * 9
        lib.p2m_parse_paths.restype = ctypes.c_int
        _lib = lib
        return _lib


class p2m_native:
    """Namespace wrapper used by the converter."""

    @staticmethod
    def available() -> bool:
        return _load() is not None

    @staticmethod
    def parse_paths(path: str, max_paths: int,
                    max_inter: int) -> Optional[Dict[str, np.ndarray]]:
        global NATIVE_PARSES
        from .. import consts as c

        lib = _load()
        if lib is None:
            return None
        n_rxs = lib.p2m_count_rxs(path.encode())
        if n_rxs < 0:
            return None

        def buf(shape):
            return np.full(shape, np.nan, dtype=np.float32)

        mats = {key: buf((n_rxs, max_paths)) for key in (
            c.POWER_PARAM_NAME, c.PHASE_PARAM_NAME, c.DELAY_PARAM_NAME,
            c.AOA_EL_PARAM_NAME, c.AOA_AZ_PARAM_NAME,
            c.AOD_EL_PARAM_NAME, c.AOD_AZ_PARAM_NAME,
            c.INTERACTIONS_PARAM_NAME)}
        inter_pos = buf((n_rxs, max_paths, max_inter, 3))

        def ptr(arr):
            return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

        rc = lib.p2m_parse_paths(
            path.encode(), n_rxs, max_paths, max_inter,
            ptr(mats[c.POWER_PARAM_NAME]), ptr(mats[c.PHASE_PARAM_NAME]),
            ptr(mats[c.DELAY_PARAM_NAME]),
            ptr(mats[c.AOA_EL_PARAM_NAME]), ptr(mats[c.AOA_AZ_PARAM_NAME]),
            ptr(mats[c.AOD_EL_PARAM_NAME]), ptr(mats[c.AOD_AZ_PARAM_NAME]),
            ptr(mats[c.INTERACTIONS_PARAM_NAME]), ptr(inter_pos))
        if rc != 0:
            print(f"[deepmimo_tpu_torch.native] p2m parse error {rc}; "
                  "falling back to Python parser")
            return None
        mats[c.INTERACTIONS_POS_PARAM_NAME] = inter_pos
        with _lock:
            NATIVE_PARSES += 1
        return mats
