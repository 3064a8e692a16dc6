"""ctypes binding of the native C++ min-snap optimizer.

Counterpart of ``mpc_quad_ros_tpu/traj/native_minsnap.py``.  The port keeps
its own copy of the source, ``traj/native/minsnap.cpp``; g++ builds it into
``build/minsnap/<content-hash>/libminsnap.so`` beside the package at the
first use.  ``native_min_snap_trajectory`` has the signature and result of
the numpy ``min_snap_trajectory``, its oracle in the tests.

``gen_trajectory_path()`` builds, at its first use, the ``gen_trajectory``
command line (``traj/native/gen_trajectory.cpp`` with the same
``minsnap.cpp``, the reference genTrajectory's flag contract) into
``build/minsnap/<content-hash>/gen_trajectory`` and returns its path:

    gen_trajectory -i waypoints.csv -o polynomial.csv --v_max V --a_max A

(exit code 2 on bad arguments, 1 on fewer than two waypoints).
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
CLI_SOURCE = SOURCE.with_name("gen_trajectory.cpp")
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[2] / "build" / "minsnap"
FLAGS = ("-O2", "-Wall", "-fPIC", "-std=c++17", "-shared")
CLI_FLAGS = ("-O2", "-Wall", "-std=c++17")
_DP = ctypes.POINTER(ctypes.c_double)


class NativeUnavailable(RuntimeError):
    """g++ is absent or could not build the library."""


def _build(sources: tuple, flags: tuple, name: str) -> pathlib.Path:
    """g++ `sources` with `flags` into build/minsnap/<hash>/`name`, unless
    these sources and flags were built already."""
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(src.read_bytes())
    out = BUILD_ROOT / h.hexdigest()[:16] / name
    if not out.exists():
        cxx = shutil.which("g++")
        if cxx is None:
            raise NativeUnavailable("g++ not found on PATH")
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{name}.{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *flags, "-o", str(tmp), *map(str, sources)],
                              capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            raise NativeUnavailable(f"g++ failed on {[s.name for s in sources]}:\n"
                                    f"{proc.stderr[-4000:]}")
        os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    """Build the library if this source has not been built yet, and load it."""
    lib_path = _build((SOURCE,), FLAGS, "libminsnap.so")
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


@functools.lru_cache(maxsize=None)
def gen_trajectory_path() -> pathlib.Path:
    """The ``gen_trajectory`` binary, built at the first call."""
    return _build((CLI_SOURCE, SOURCE), CLI_FLAGS, "gen_trajectory")
