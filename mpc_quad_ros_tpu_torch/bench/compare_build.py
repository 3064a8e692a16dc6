"""Kernels A-J of this checkout against another checkout's, on one card, in
one process, on the same inputs.

    python -m mpc_quad_ros_tpu_torch.bench.compare_build --other PATH [--B 65536]
        [--solves split,hybrid]

PATH is another checkout of this repository (an earlier commit, unpacked).
Its ``ops/cuda/_build.py`` builds its own ``csrc/`` into its own ``build/``,
and its C entry points ``mpcq_lin``, ``mpcq_sqp_fused``, ``mpcq_riccati_ipm``,
``mpcq_condense``, ``mpcq_box_qp``, ``mpcq_sqp_step`` and
``mpcq_condense_ab`` are called directly with this checkout's tensors: the
solve cell's next Gauss-Newton step at B scenarios, N=10 (kernel A on the
trajectory, kernels B and D fed kernel A's J, kernel E on kernel D's QP,
kernel F on the trajectory; B, E and F cold and warm-started from the first
solve's duals; kernel J on the A and B blocks of the first 1 and 127
scenarios' J), and kernel C at N=40 on kernel A's J of the same cell's step
at that horizon.  Kernel C's entry takes a device scratch where the library
has ``mpcq_riccati_scratch_bytes`` (its other arguments are the same).
Kernels G, H and I (``mpcq_fma``, ``mpcq_mirror``, ``mpcq_elem``) run at the
bench's shapes, whatever B: G at ``phases.REGISTER_SHAPE`` and
``STREAMING_SHAPE`` on ``phases.fma_input``, H and I on the transpose
probe's tiles (``probe_hybrid.probe_input``: B=16384, nz=40) at reps = 4
and 32.  One JSON line per kernel and start: whether the two libraries'
outputs are bitwise equal, their largest difference, and each library's
CUDA-event time, taken in turns (other, this, this, other); the rows of
kernels H, I and J add each library's device time of one launch from
``torch.profiler`` (200 launches).  The launch counters of this
checkout's wrappers are not touched: the calls go to the C entries.

``--solves`` adds the end-to-end view: for each pipeline named, each
checkout's own package in a process of its own (other, this, this, other)
runs the solve cell's 20 chained warm-started solves at B scenarios, three
times (``bench/phases.py::time_solves``), and its one-scenario latency
through the small-batch step (``bench/headline.py::one_scenario_latency``).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import subprocess
import sys

import torch

from ..models import fold_drag
from ..ops.cuda import _build, condense_kernel, lin_kernel
from ..ops.cuda.condense_common import split_AB
from ..ops.cuda.lin_kernel import model_constants
from . import phases
from .operating_point import operating_point
from .phases import card, device_seconds, kernel_device_ms
from .probe_hybrid import probe_input


def other_library(path: pathlib.Path):
    """The CUDA library of the checkout at `path`, built by its own
    ``_build.py``."""
    src = pathlib.Path(path) / "mpc_quad_ros_tpu_torch" / "ops" / "cuda" / "_build.py"
    spec = importlib.util.spec_from_file_location("other_build", src)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.load_library()


def step_inputs(B: int, device) -> dict:
    """The solve cell's step after one warm-up solve with warm duals on:
    kernel B's, E's and F's arguments as the pipelines form them."""
    solver, carry, x0, y_ref, rgp = operating_point(B, device, mu_scale=0.3,
                                                    warm_start_duals=True)
    carry, _ = solver.solve_batch(carry, x0, y_ref, y_ref[:, -1], rgp)
    cfg = solver.cfg
    aug = fold_drag(rgp).map(lambda a: a.contiguous())
    xp, J = lin_kernel.linearize(carry.X, carry.U, aug, solver.f, cfg.dt)
    args = [J, *solver.qp_inputs(carry.X, carry.U, x0, y_ref, y_ref[:, -1], xp)]
    q, p, rw = cfg.weight_tuples()
    H, g, _, _ = condense_kernel.condense_cost_from_J(*args[:4], q, p, rw)
    return {"args": args, "box": (H, (g + args[4]).contiguous(), args[5], args[6]),
            "X": carry.X, "U": carry.U, "aug": aug, "duals": (carry.zl, carry.zu),
            "weights": _build.host_floats(list(q) + list(p) + list(rw)),
            "consts": _build.host_floats(model_constants(solver.f.params, cfg.dt)),
            "iters": cfg.qp_iters, "N": cfg.n_nodes, "f": solver.f, "dt": cfg.dt}


def ab_inputs(step: dict, B: int) -> dict:
    """Kernel J's arguments: the A and B blocks of the first B scenarios of
    the step's J, and their r, dx0, ex0."""
    J, *tail = (a[:B].contiguous() for a in step["args"][:4])
    return {"args": [*(a.contiguous() for a in split_AB(J)), *tail],
            "weights": step["weights"], "N": step["N"]}


def riccati_step_inputs(B: int, device, N: int = 40) -> dict:
    """Kernel C's arguments at the solve cell's next step at horizon N (one
    warm-up solve through kernels A and C): kernel A's J, then the glue."""
    solver, carry, x0, y_ref, rgp = operating_point(B, device, mu_scale=0.3, N=N,
                                                    qp_method="riccati")
    carry, _ = solver.solve_batch(carry, x0, y_ref, y_ref[:, -1], rgp)
    cfg = solver.cfg
    aug = fold_drag(rgp).map(lambda a: a.contiguous())
    xp, J = lin_kernel.linearize(carry.X, carry.U, aug, solver.f, cfg.dt)
    args = [J, *solver.riccati_inputs(carry.X, carry.U, x0, y_ref, y_ref[:, -1], xp)]
    return {"args": args, "weights": _build.host_floats([v for w in cfg.weight_tuples() for v in w]),
            "iters": cfg.qp_iters, "N": N}


def _ptrs(tensors):
    return [None if t is None else t.data_ptr() for t in tensors]


def run_a(lib, inp, _duals):
    X, U, aug = inp["X"], inp["U"], inp["aug"]
    B, N = U.shape[:2]
    out = [torch.empty((B, N, 13), device=X.device), torch.empty((B, N, 17, 13), device=X.device)]
    rc = lib.mpcq_lin(X.data_ptr(), U.data_ptr(), *_ptrs((aug.X, aug.w, aug.L, aug.sigma_f)),
                      aug.X.shape[-1], *_ptrs(out), B, N, inp["consts"].data_ptr(),
                      torch.cuda.current_stream().cuda_stream)
    _build.check_status("compare_build kernel A", rc)
    return out


def run_c(lib, inp, _duals):
    J = inp["args"][0]
    B, N = J.shape[:2]
    out = [torch.empty((B, N, 4), device=J.device), torch.empty((B, N + 1, 13), device=J.device)]
    scratch = ([torch.empty((B, lib.mpcq_riccati_scratch_bytes(N) // 4), device=J.device)]
               if hasattr(lib, "mpcq_riccati_scratch_bytes") else [])
    rc = lib.mpcq_riccati_ipm(*_ptrs(inp["args"]), inp["weights"].data_ptr(), *_ptrs(out),
                              *_ptrs(scratch), B, N, inp["iters"],
                              torch.cuda.current_stream().cuda_stream)
    _build.check_status("compare_build kernel C", rc)
    return out


def run_b(lib, inp, duals):
    J = inp["args"][0]
    B, N = J.shape[:2]
    out = [torch.empty((B, 4 * N), device=J.device), torch.empty((B, N + 1, 13), device=J.device),
           torch.empty((B,), device=J.device), torch.empty((B, 4 * N), device=J.device),
           torch.empty((B, 4 * N), device=J.device)]
    rc = lib.mpcq_sqp_fused(*_ptrs(inp["args"]), *_ptrs(duals), inp["weights"].data_ptr(),
                            *_ptrs(out), B, N, inp["iters"], torch.cuda.current_stream().cuda_stream)
    _build.check_status("compare_build kernel B", rc)
    return out


def _condense_out(B, N, device):
    nz = 4 * N
    return [torch.empty(shape, device=device)
            for shape in ((B, nz, nz), (B, nz), (B, N + 1, 13, nz), (B, N + 1, 13))]


def run_d(lib, inp, _duals):
    J = inp["args"][0]
    B, N = J.shape[:2]
    out = _condense_out(B, N, J.device)
    rc = lib.mpcq_condense(*_ptrs(inp["args"][:4]), inp["weights"].data_ptr(), *_ptrs(out), B, N,
                           torch.cuda.current_stream().cuda_stream)
    _build.check_status("compare_build kernel D", rc)
    return out


def run_j(lib, inp, _duals):
    A = inp["args"][0]
    B, N = A.shape[:2]
    out = _condense_out(B, N, A.device)
    rc = lib.mpcq_condense_ab(*_ptrs(inp["args"]), inp["weights"].data_ptr(), *_ptrs(out), B, N,
                              torch.cuda.current_stream().cuda_stream)
    _build.check_status("compare_build kernel J", rc)
    return out


def run_e(lib, inp, duals):
    H, g, lb, ub = inp["box"]
    B, nz = g.shape
    out = [torch.empty((B, nz), device=g.device) for _ in range(3)]
    rc = lib.mpcq_box_qp(*_ptrs((H, g, lb, ub)), *_ptrs(duals), *_ptrs(out), B, nz, inp["iters"],
                         torch.cuda.current_stream().cuda_stream)
    _build.check_status("compare_build kernel E", rc)
    return out


def run_f(lib, inp, duals):
    X, U, aug = inp["X"], inp["U"], inp["aug"]
    B, N = U.shape[:2]
    out = [torch.empty((B, 4 * N), device=X.device), torch.empty((B, N + 1, 13), device=X.device),
           torch.empty((B,), device=X.device), torch.empty((B, 4 * N), device=X.device),
           torch.empty((B, 4 * N), device=X.device)]
    rc = lib.mpcq_sqp_step(X.data_ptr(), U.data_ptr(), *_ptrs((aug.X, aug.w, aug.L, aug.sigma_f)),
                           aug.X.shape[-1], *_ptrs(inp["args"][2:]), *_ptrs(duals),
                           inp["consts"].data_ptr(), inp["weights"].data_ptr(), *_ptrs(out), B, N,
                           inp["iters"], torch.cuda.current_stream().cuda_stream)
    _build.check_status("compare_build kernel F", rc)
    return out


def run_g(lib, inp, _duals):
    x = inp["args"][0]
    out = torch.empty_like(x)
    rc = lib.mpcq_fma(x.data_ptr(), out.data_ptr(), x.numel(), inp["chains"], inp["steps"],
                      int(inp["resident"]), torch.cuda.current_stream().cuda_stream)
    _build.check_status("compare_build kernel G", rc)
    return [out]


def _run_probe(entry: str):
    def run(lib, inp, _duals):
        x = inp["args"][0]
        out = torch.empty_like(x)
        rc = getattr(lib, entry)(x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[-1],
                                 inp["reps"], torch.cuda.current_stream().cuda_stream)
        _build.check_status(f"compare_build {entry}", rc)
        return [out]
    return run


def fma_inputs(shape, resident: bool, device) -> dict:
    """Kernel G's arguments at one of the bench's shapes."""
    sublanes, chains, steps, grid = shape
    return {"args": [phases.fma_input(sublanes, grid, device)], "N": None, "chains": chains,
            "steps": steps, "resident": resident}


# (kernel, its run, whether it takes warm duals, its inputs: the N=10 step,
# kernel J's blocks of its first 1 or 127 scenarios, the N=40 step, kernel
# G's shapes, the probe's tiles at reps = 4 or 32)
KERNELS = (("A", run_a, False, "step"), ("B", run_b, True, "step"),
           ("C", run_c, False, "riccati"), ("D", run_d, False, "step"),
           ("E", run_e, True, "step"), ("F", run_f, True, "step"),
           ("J", run_j, False, "ab1"), ("J", run_j, False, "ab127"),
           ("G", run_g, False, "fma_registers"), ("G", run_g, False, "fma_smem"),
           ("H", _run_probe("mpcq_mirror"), False, "probe4"),
           ("H", _run_probe("mpcq_mirror"), False, "probe32"),
           ("I", _run_probe("mpcq_elem"), False, "probe4"),
           ("I", _run_probe("mpcq_elem"), False, "probe32"))
# the kernel names the profiler's rows are matched on, by kernel
PROFILED = {"H": "mirror_kernel", "I": "elem_kernel", "J": "condense_ab"}
# profiler launches per library and profiled row
PROFILE_REPS = 200
# the transpose probe's batch and width
PROBE_B, PROBE_NZ = 16384, 40


def make_inputs(key: str, B: int, inputs: dict, device) -> dict:
    """The inputs named `key`, made on first use (the step's at B)."""
    if key in inputs:
        return inputs[key]
    if key == "step":
        inp = step_inputs(B, device)
    elif key.startswith("ab"):
        inp = ab_inputs(make_inputs("step", B, inputs, device), int(key[2:]))
    elif key == "riccati":
        inp = riccati_step_inputs(B, device)
    elif key.startswith("fma_"):
        reg = key == "fma_registers"
        inp = fma_inputs(phases.REGISTER_SHAPE if reg else phases.STREAMING_SHAPE, reg, device)
    else:
        inp = {"args": [probe_input(PROBE_B, PROBE_NZ, device)], "N": None,
               "reps": int(key[len("probe"):])}
    inputs[key] = inp
    return inp


def compare(other: pathlib.Path, B: int = 65536, reps: int = 5) -> list[dict]:
    dev = torch.device("cuda", 0)
    libs = {"other": other_library(other), "this": _build.load_library()}
    inputs, rows = {}, []
    for name, run, warm, key in KERNELS:
        inp = make_inputs(key, B, inputs, dev)
        starts = (("cold", (None, None)),) + ((("warm", inp["duals"]),) if warm else ())
        for start, duals in starts:
            outs = {k: run(lib, inp, duals) for k, lib in libs.items()}
            torch.cuda.synchronize()
            row = {"kernel": name, "start": start if warm else "-",
                   "B": inp["args"][0].shape[0], "N": inp["N"],
                   **{k: inp[k] for k in ("reps", "chains", "steps", "resident") if k in inp},
                   "bitwise": all(torch.equal(a, b) for a, b in zip(outs["this"], outs["other"])),
                   "max_abs_diff": max((a - b).abs().max().item()
                                       for a, b in zip(outs["this"], outs["other"])),
                   "finite": all(bool(torch.isfinite(a).all()) for a in outs["this"])}
            del outs
            ms = {k: [] for k in libs}
            for k in ("other", "this", "this", "other"):
                ms[k].append(device_seconds(lambda: run(libs[k], inp, duals), reps, dev) * 1e3)
            row.update({f"{k}_ms": v for k, v in ms.items()})
            if name in PROFILED:
                row.update({f"{k}_device_ms": kernel_device_ms(
                    lambda: run(libs[k], inp, duals), PROFILED[name], PROFILE_REPS)
                    for k in ("other", "this")})
            rows.append(row)
    return rows


# One checkout's solves, run from its root with its own package: solves/s of
# the solve cell's chained solves through a pipeline, and the one-scenario
# latency (p50, largest ms).  Only entry points both checkouts have.
SOLVES = """
import json, torch
from mpc_quad_ros_tpu_torch.bench.headline import one_scenario_latency
from mpc_quad_ros_tpu_torch.bench.operating_point import operating_point
from mpc_quad_ros_tpu_torch.bench.phases import time_solves
dev = torch.device("cuda", 0)
solver, carry, x0, y_ref, rgp = operating_point({B}, dev, pipeline="{pipeline}")
times, _ = time_solves(solver, carry, x0, y_ref, rgp, 20, dev, 3)
p50, top = one_scenario_latency(solver, carry, x0, y_ref, rgp, dev)
print(json.dumps([{B} * len(times) / sum(times), p50, top]))
"""


def solve_rates(other: pathlib.Path, pipeline: str, B: int) -> dict:
    """Each checkout's solves/s and one-scenario latency through `pipeline`,
    in turns (other, this, this, other), one process a run."""
    roots = {"other": pathlib.Path(other).resolve(),
             "this": pathlib.Path(__file__).resolve().parents[2]}
    row = {"pipeline": pipeline, "B": B, "chained_solves": 20, "runs": 3}
    for k in ("other", "this", "this", "other"):
        out = subprocess.run([sys.executable, "-c", SOLVES.format(B=B, pipeline=pipeline)],
                             cwd=roots[k], capture_output=True, text=True, check=True)
        rate, p50, top = json.loads(out.stdout.strip().splitlines()[-1])
        for key, v in (("solves_per_s", rate), ("latency_p50_ms", p50), ("latency_max_ms", top)):
            row.setdefault(f"{k}_{key}", []).append(v)
    return row


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=pathlib.Path, required=True)
    ap.add_argument("--B", type=int, default=65536)
    ap.add_argument("--solves", default="", help="pipelines to run end to end, comma-separated")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare_build: needs a CUDA device")
    print(card(), flush=True)
    for row in compare(args.other, args.B):
        print(json.dumps(row), flush=True)
    for pipeline in filter(None, args.solves.split(",")):
        print(json.dumps(solve_rates(args.other, pipeline, args.B)), flush=True)


if __name__ == "__main__":
    main()
