"""ctypes binding of the native C++ min-snap optimizer.

Counterpart of ``mpc_quad_ros_tpu/traj/native_minsnap.py``.  The port keeps
its own copy of the source, ``traj/native/minsnap.cpp``; g++ builds it into
``build/minsnap/<content-hash>/libminsnap.so`` beside the package at the
first use.  ``native_min_snap_trajectory`` has the signature and result of
the numpy ``min_snap_trajectory``, its oracle in the tests.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

import numpy as np

from .polynomial import PiecewisePolynomial4D

SOURCE = pathlib.Path(__file__).resolve().parent / "native" / "minsnap.cpp"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[2] / "build" / "minsnap"
FLAGS = ("-O2", "-Wall", "-fPIC", "-std=c++17", "-shared")
_DP = ctypes.POINTER(ctypes.c_double)


class NativeUnavailable(RuntimeError):
    """g++ is absent or could not build the library."""


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    """Build the library if this source has not been built yet, and load it."""
    digest = hashlib.sha256(" ".join(FLAGS).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    lib_path = BUILD_ROOT / digest / "libminsnap.so"
    if not lib_path.exists():
        cxx = shutil.which("g++")
        if cxx is None:
            raise NativeUnavailable("g++ not found on PATH")
        lib_path.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"libminsnap.so.{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True,
                              text=True, timeout=120)
        if proc.returncode != 0:
            raise NativeUnavailable(f"g++ failed on {SOURCE.name}:\n{proc.stderr[-4000:]}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    lib.minsnap_solve.restype = ctypes.c_int
    lib.minsnap_solve.argtypes = [_DP, ctypes.c_int, ctypes.c_double, ctypes.c_double,
                                  ctypes.c_int, _DP, _DP]
    return lib


def native_available() -> bool:
    """Whether the library builds and loads here."""
    try:
        _load()
    except NativeUnavailable:
        return False
    return True


def native_min_snap_trajectory(waypoints: np.ndarray, v_max: float, a_max: float,
                               max_scaling_iters: int = 12) -> PiecewisePolynomial4D:
    lib = _load()
    wp = np.ascontiguousarray(np.asarray(waypoints, dtype=np.float64)[:, :3])
    K = wp.shape[0] - 1
    durations = np.zeros(K, dtype=np.float64)
    coeffs = np.zeros((K, 4, 8), dtype=np.float64)
    rc = lib.minsnap_solve(wp.ctypes.data_as(_DP), wp.shape[0], float(v_max), float(a_max),
                           int(max_scaling_iters), durations.ctypes.data_as(_DP),
                           coeffs.ctypes.data_as(_DP))
    if rc != 0:
        raise RuntimeError(f"minsnap_solve failed with code {rc}")
    return PiecewisePolynomial4D(durations, coeffs)
