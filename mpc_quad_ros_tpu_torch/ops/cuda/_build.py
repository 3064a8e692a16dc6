"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``mpc_quad_ros_tpu_torch/csrc/*.cu`` into one shared
library with a plain C interface, ``build/torch_kernels/<content-hash>/
libmpcq_kernels.so`` beside the package, at the first launch on a CUDA
tensor; ``ctypes`` loads it.  The hash covers the sources and the flags, so
an edit rebuilds and an unchanged tree reuses the library.

The same sources also compile with g++ (``-x c++``) into a host library whose
double-precision entry points run the kernels' own code on the CPU; the CPU
tests hold that build against the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

CSRC = pathlib.Path(__file__).resolve().parents[2] / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
LIB_NAME = "libmpcq_kernels.so"

# No --use_fast_math: expf / rsqrtf keep their IEEE-accurate forms.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_FLAGS = ("-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC")

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# C entry points and their argument types (pointers and the stream as
# c_void_p, so no pointer is cut to 32 bits)
DEVICE_ENTRIES = {
    "mpcq_lin": [_P] * 6 + [_I, _P, _P, _I64, _I, _P, _P],
    "mpcq_sqp_fused": [_P] * 11 + [_I64, _I, _I, _P],
}
HOST_ENTRIES = {
    "mpcq_lin_host_f64": [_P] * 6 + [_I, _P, _P, _I64, _I, _P],
    "mpcq_sqp_fused_host_f64": [_P] * 11 + [_I64, _I, _I],
}

_device_lib = None


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _content_hash(flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            candidates.append(os.path.join(root, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (looked on PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def _compile(cmd_prefix, flags, out_dir: pathlib.Path) -> pathlib.Path:
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [*cmd_prefix, *flags, "-o", str(tmp), *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / "build.log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"kernel build failed ({proc.returncode}):\n{proc.stderr[-6000:]}")
    os.replace(tmp, lib)
    return lib


def build() -> pathlib.Path:
    """Compile the CUDA library if this source tree has not been built yet."""
    return _compile([find_nvcc()], NVCC_FLAGS, BUILD_ROOT / _content_hash(NVCC_FLAGS))


def _declare(lib: ctypes.CDLL, entries: dict) -> ctypes.CDLL:
    for name, argtypes in entries.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def load_library() -> ctypes.CDLL:
    """The CUDA library, built on first use."""
    global _device_lib
    if _device_lib is None:
        _device_lib = _declare(ctypes.CDLL(str(build())), DEVICE_ENTRIES)
    return _device_lib


def load_host_library(out_dir: pathlib.Path) -> ctypes.CDLL:
    """The host (g++) build of the same sources, into `out_dir`."""
    lib = _compile(["g++"], HOST_FLAGS, pathlib.Path(out_dir) / _content_hash(HOST_FLAGS))
    return _declare(ctypes.CDLL(str(lib)), HOST_ENTRIES)


def check_cuda_inputs(name: str, tensors: dict, shapes: dict) -> None:
    """Raise unless every tensor is f32, contiguous, of its expected shape
    and on one sm_90 device."""
    device = None
    for key, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32 on CUDA, got {t.dtype}")
        if not t.is_cuda:
            raise ValueError(f"{name}: {key} is on {t.device}, expected a CUDA tensor")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if tuple(t.shape) != tuple(shapes[key]):
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, expected {tuple(shapes[key])}")
    cap = torch.cuda.get_device_capability(device)
    if cap != (9, 0):
        raise RuntimeError(f"{name}: the kernels are built for sm_90a, device {device} is sm_{cap[0]}{cap[1]}")


def check_status(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def host_floats(values) -> torch.Tensor:
    """A CPU float32 tensor of scalars passed to a C entry by pointer."""
    return torch.tensor([float(v) for v in values], dtype=torch.float32)
