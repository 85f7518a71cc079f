"""ctypes binding to the native CPU oracle (csrc/cspm_oracle.cc).

The oracle is the measured-CPU-baseline and end-to-end accuracy reference
for the JAX engine (the upstream project is a Windows/VS2010 build that
cannot run here and publishes no numbers).  The shared
library is built on demand with g++ -O3 -fopenmp.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "csrc")
_SRC = os.path.join(_CSRC, "cspm_oracle.cc")
_LIB = os.path.join(_CSRC, "libcspm_oracle.so")

_lib: Optional[ctypes.CDLL] = None


def build(force: bool = False) -> str:
    """Compile the oracle shared library if missing or stale."""
    if (not force and os.path.exists(_LIB)
            and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC)):
        return _LIB
    cmd = ["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
           "-std=c++17", "-o", _LIB, _SRC]
    subprocess.run(cmd, check=True, capture_output=True)
    return _LIB


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.cspm_oracle_run.argtypes = [
            u8p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_uint, u8p]
        lib.cspm_oracle_run.restype = ctypes.c_int
        lib.cspm_oracle_volume.argtypes = [
            u8p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_double)]
        lib.cspm_oracle_volume.restype = ctypes.c_int
        _lib = lib
    return _lib


def run_pair(left_bgr: np.ndarray, right_bgr: np.ndarray, *, max_dis: int,
             dis_scale: int, cc_name: str = "GRD", use_cs: bool = False,
             use_pp: bool = False, reg_lambda: float = 0.0,
             max_iter: int = 3, wnd_size: int = 35, scale_num: int = 5,
             seed: int = 0) -> np.ndarray:
    """Run the sequential CPU pipeline; returns u8[2, H, W] disparity maps."""
    lib = _load()
    l = np.ascontiguousarray(left_bgr, np.uint8)
    r = np.ascontiguousarray(right_bgr, np.uint8)
    h, w, _ = l.shape
    out = np.zeros((2, h, w), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    rc = lib.cspm_oracle_run(
        l.ctypes.data_as(u8p), r.ctypes.data_as(u8p), h, w, max_dis,
        dis_scale, 1 if cc_name.upper() == "GRD" else 0, int(use_cs),
        int(use_pp), reg_lambda, max_iter, wnd_size, scale_num, seed,
        out.ctypes.data_as(u8p))
    if rc != 0:
        raise RuntimeError(f"oracle returned {rc}")
    return out


def cost_volume(left_bgr: np.ndarray, right_bgr: np.ndarray, *, max_dis: int,
                cc_name: str = "GRD", right: bool = False) -> np.ndarray:
    """Native cost volume, f64[D+1, H, W] (op-level cross-check)."""
    lib = _load()
    l = np.ascontiguousarray(left_bgr, np.uint8)
    r = np.ascontiguousarray(right_bgr, np.uint8)
    h, w, _ = l.shape
    out = np.zeros((max_dis + 1, h, w), np.float64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    rc = lib.cspm_oracle_volume(
        l.ctypes.data_as(u8p), r.ctypes.data_as(u8p), h, w, max_dis,
        1 if cc_name.upper() == "GRD" else 0, int(right),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if rc != 0:
        raise RuntimeError(f"oracle returned {rc}")
    return out
