"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``mpc_quad_ros_tpu_torch/csrc/*.cu`` (one process per
source, all at once) and links them into one shared library with a plain C
interface, ``build/torch_kernels/<content-hash>/libmpcq_kernels.so`` beside
the package, at the first launch on a CUDA tensor; ``ctypes`` loads it.  The hash covers the sources and the flags, so
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

# Compile flags of one source; the objects are then linked with -shared.
# No --use_fast_math: expf / rsqrtf keep their IEEE-accurate forms.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# The host build is C++20 for std::barrier (the 32-thread team of common.cuh).
HOST_FLAGS = ("-x", "c++", "-std=c++20", "-O2", "-fPIC", "-pthread")
# Flags of the link step, by compiler.
LINK_FLAGS = {"g++": ("-pthread",)}

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# C entry points and their argument types (pointers and the stream as
# c_void_p, so no pointer is cut to 32 bits)
WS_ENTRIES = ("mpcq_lin_ws_bytes", "mpcq_sqp_ws_bytes", "mpcq_sqp_step_ws_bytes",
              "mpcq_condense_ws_bytes", "mpcq_box_qp_ws_bytes", "mpcq_riccati_ws_bytes",
              "mpcq_riccati_scratch_bytes", "mpcq_transpose_ws_bytes")
DEVICE_ENTRIES = {
    "mpcq_lin": [_P] * 6 + [_I, _P, _P, _I64, _I, _P, _P],
    "mpcq_sqp_fused": [_P] * 15 + [_I64, _I, _I, _P],
    "mpcq_sqp_step": [_P] * 6 + [_I] + [_P] * 14 + [_I64, _I, _I, _P],
    "mpcq_condense": [_P] * 9 + [_I64, _I, _P],
    "mpcq_condense_ab": [_P] * 10 + [_I64, _I, _P],
    "mpcq_box_qp": [_P] * 9 + [_I64, _I, _I, _P],
    "mpcq_riccati_ipm": [_P] * 12 + [_I64, _I, _I, _P],
    "mpcq_fma": [_P, _P, _I64, _I, _I, _I, _P],
    "mpcq_mirror": [_P, _P, _I64, _I, _I, _P],
    "mpcq_elem": [_P, _P, _I64, _I, _I, _P],
    "mpcq_sqp_occupancy": [_I, _I],
    "mpcq_box_qp_occupancy": [_I],
    "mpcq_lin_occupancy": [_I],
    "mpcq_riccati_occupancy": [_I],
    "mpcq_condense_occupancy": [_I],
    "mpcq_condense_ab_occupancy": [_I],
    "mpcq_condense_ab_threads": [],
    "mpcq_transpose_block_warps": [_I],
    "mpcq_transpose_occupancy": [_I, _I],
    **{name: [_I] for name in WS_ENTRIES},
}
HOST_ENTRIES = {
    "mpcq_lin_host_f64": [_P] * 6 + [_I, _P, _P, _I64, _I, _P],
    "mpcq_sqp_fused_host_f64": [_P] * 15 + [_I64, _I, _I],
    "mpcq_sqp_fused_host32_f64": [_P] * 15 + [_I64, _I, _I],
    "mpcq_sqp_step_host_f64": [_P] * 6 + [_I] + [_P] * 14 + [_I64, _I, _I],
    "mpcq_sqp_step_host32_f64": [_P] * 6 + [_I] + [_P] * 14 + [_I64, _I, _I],
    "mpcq_condense_host_f64": [_P] * 9 + [_I64, _I],
    "mpcq_condense_host32_f64": [_P] * 9 + [_I64, _I],
    "mpcq_condense_ab_host_f64": [_P] * 10 + [_I64, _I],
    "mpcq_condense_ab_host256_f64": [_P] * 10 + [_I64, _I],
    "mpcq_box_qp_host_f64": [_P] * 9 + [_I64, _I, _I],
    "mpcq_box_qp_host32_f64": [_P] * 9 + [_I64, _I, _I],
    "mpcq_riccati_ipm_host_f64": [_P] * 11 + [_I64, _I, _I],
    "mpcq_riccati_ipm_host32_f64": [_P] * 11 + [_I64, _I, _I],
    "mpcq_fma_host_f64": [_P, _P, _I64, _I, _I, _I],
    "mpcq_mirror_host_f64": [_P, _P, _I64, _I, _I],
    "mpcq_elem_host_f64": [_P, _P, _I64, _I, _I],
    "mpcq_mirror_host32_f64": [_P, _P, _I64, _I, _I],
    "mpcq_elem_host32_f64": [_P, _P, _I64, _I, _I],
    **{name: [_I] for name in WS_ENTRIES},
}
# entries that return something other than a CUDA status (int)
RESTYPES = {name: _I64 for name in WS_ENTRIES}

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
    """One compiler process per source, all started together, then one link."""
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    objs = [out_dir / f"{src.stem}.{tag}.o" for src in sources()]
    cmds = [[*cmd_prefix, *flags, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources(), objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs = [proc.communicate()[0] for proc in procs]
    tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
    link = [*cmd_prefix, "-shared", *LINK_FLAGS.get(cmd_prefix[0], ()), "-o", str(tmp),
            *map(str, objs)]
    failed = [(cmd, log) for cmd, log, proc in zip(cmds, logs, procs) if proc.returncode != 0]
    if not failed:
        proc = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        cmds, logs = cmds + [link], logs + [proc.stdout]
        if proc.returncode != 0:
            failed = [(link, proc.stdout)]
    (out_dir / "build.log").write_text("".join(" ".join(c) + "\n" + log for c, log in zip(cmds, logs)))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"kernel build failed: {' '.join(failed[0][0])}\n{failed[0][1][-6000:]}")
    os.replace(tmp, lib)
    return lib


def build() -> pathlib.Path:
    """Compile the CUDA library if this source tree has not been built yet."""
    return _compile([find_nvcc()], NVCC_FLAGS, BUILD_ROOT / _content_hash(NVCC_FLAGS))


def _declare(lib: ctypes.CDLL, entries: dict) -> ctypes.CDLL:
    for name, argtypes in entries.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = RESTYPES.get(name, ctypes.c_int)
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
