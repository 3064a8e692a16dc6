"""Kernels A-J of this checkout against another checkout's, on one card, in
one process, on the same inputs.

    python -m mpc_quad_ros_tpu_torch.bench.compare_build --other PATH [--B 65536]
        [--solves split,hybrid] [--riccati] [--kernels ABCDEFGHIJ]

PATH is another checkout of this repository (an earlier commit, unpacked).
Its ``ops/cuda/_build.py`` builds its own ``csrc/`` into its own ``build/``,
and its C entry points ``mpcq_lin``, ``mpcq_sqp_fused``, ``mpcq_riccati_ipm``,
``mpcq_condense``, ``mpcq_box_qp``, ``mpcq_sqp_step`` and
``mpcq_condense_ab`` are called directly with this checkout's tensors: the
solve cell's next Gauss-Newton step at B scenarios, N=10 (kernel A on the
trajectory, kernels B and D fed kernel A's J, kernel E on kernel D's QP,
kernel F on the trajectory; B, E and F cold and warm-started from the first
solve's duals; kernel J on the A and B blocks of the first 1 and 127
scenarios' J), kernel A again at the horizons, batches and basis sizes of
``LIN_STEPS`` (each after one solve of its own), kernel B again on the same
cell's step at the horizons and batches of ``B_STEPS``, cold and warm,
kernel E again at the horizons and batches of ``E_STEPS`` (the first
scenarios of the N=10 step, or a step of its own), cold and warm, and at
the shapes of ``E_SCHEDULES`` with this checkout's schedule of 16 or 32
lanes a scenario taken whatever the batch (``mpcq_box_qp_sched``, where the
library has it), kernel F again at the inputs of ``F_STEPS`` and, with a
schedule forced, ``F_SCHEDULES`` (``mpcq_sqp_step_sched``, where the library
has it), cold and warm, and kernel C on kernel A's J of the same cell's
step at the horizons and batches of ``RICCATI_STEPS``.
Kernel C's entry takes a device scratch where the library has
``mpcq_riccati_scratch_bytes``, and kernel F's where it has
``mpcq_sqp_step_grid`` (their other arguments are the same).
Kernels G, H and I (``mpcq_fma``, ``mpcq_mirror``, ``mpcq_elem``) run at the
bench's shapes, whatever B: G at ``phases.REGISTER_SHAPE`` and
``STREAMING_SHAPE`` on ``phases.fma_input``, H and I on the transpose
probe's tiles (``probe_hybrid.probe_input``: B=16384, nz=40) at reps = 4
and 32.  One JSON line per kernel and start: whether the two libraries'
outputs are bitwise equal (their bit patterns, so a NaN where both have it
agrees), their largest difference, and each library's CUDA-event time,
taken in turns (other, this, this, other); kernel C's rows add the largest
|du| and |dX| differences between the two libraries and of each against
the f64 plain version on the same inputs; the rows of
kernels A, H, I and J add each library's device time of one launch from
``torch.profiler`` (200 launches).  The launch counters of this
checkout's wrappers are not touched: the calls go to the C entries.

``--solves`` adds the end-to-end view: for each pipeline named, each
checkout's own package in a process of its own (other, this, this, other)
runs the solve cell's 20 chained warm-started solves at B scenarios, three
times (``bench/phases.py::time_solves``), and its one-scenario latency
through the small-batch step (``bench/headline.py::one_scenario_latency``).
``--riccati`` adds, the same way, each checkout's ``probe_hybrid.
riccati_profile`` (kernel C alone at B=1024, N = 10, 20, 40, its time a
line in the IPM iterations) and ``riccati_breakdown`` (one Gauss-Newton
step of the Riccati slice at B=65536, N=40 by part).
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
from ..ops.cuda import _build, condense_kernel, lin_kernel, riccati_kernel
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


def step_inputs(B: int, device, N: int = 10) -> dict:
    """The solve cell's step at horizon N after one warm-up solve with warm
    duals on: kernel B's, E's and F's arguments as the pipelines form them."""
    solver, carry, x0, y_ref, rgp = operating_point(B, device, mu_scale=0.3, N=N,
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


def first_steps(step: dict, b: int) -> dict:
    """Kernel F's inputs and warm duals of the first b scenarios of a step."""
    cut = lambda a: a[:b].contiguous()
    return dict(step, X=cut(step["X"]), U=cut(step["U"]), aug=step["aug"].map(cut),
                args=[cut(a) for a in step["args"]], duals=tuple(map(cut, step["duals"])))


def first_scenarios(step: dict, b: int) -> dict:
    """Kernel E's QPs and warm duals of the first b scenarios of a step."""
    return dict(step, box=tuple(a[:b].contiguous() for a in step["box"]),
                duals=tuple(d[:b].contiguous() for d in step["duals"]),
                args=[a[:b].contiguous() for a in step["args"][:1]])


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
            "weight_tuples": cfg.weight_tuples(), "iters": cfg.qp_iters, "N": N}


def lin_inputs(B: int, device, N: int, nb: int) -> dict:
    """Kernel A's arguments at the solve cell's next step at horizon N with
    nb RGP basis vectors an axis (0: no drag), after one warm-up solve (the
    Riccati backend past the dense kernels' horizons)."""
    solver, carry, x0, y_ref, rgp = operating_point(
        B, device, mu_scale=0.3, N=N, n_basis=max(nb, 1),
        qp_method="riccati" if N > 16 else "pdip")
    carry, _ = solver.solve_batch(carry, x0, y_ref, y_ref[:, -1], rgp if nb else None)
    cfg = solver.cfg
    return {"args": [carry.X], "X": carry.X, "U": carry.U, "N": N, "nb": nb,
            "aug": fold_drag(rgp).map(lambda a: a.contiguous()) if nb else None,
            "consts": _build.host_floats(model_constants(solver.f.params, cfg.dt))}


def _ptrs(tensors):
    return [None if t is None else t.data_ptr() for t in tensors]


def run_a(lib, inp, _duals):
    X, U, aug = inp["X"], inp["U"], inp["aug"]
    B, N = U.shape[:2]
    _, _, aug_ptrs, nb = lin_kernel.drag_args(aug, B)
    out = [torch.empty((B, N, 13), device=X.device), torch.empty((B, N, 17, 13), device=X.device)]
    rc = lib.mpcq_lin(X.data_ptr(), U.data_ptr(), *aug_ptrs, nb, *_ptrs(out), B, N,
                      inp["consts"].data_ptr(), torch.cuda.current_stream().cuda_stream)
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
    args = [*_ptrs((H, g, lb, ub)), *_ptrs(duals), *_ptrs(out), B, nz, inp["iters"]]
    stream = torch.cuda.current_stream().cuda_stream
    if inp.get("lanes") and hasattr(lib, "mpcq_box_qp_sched"):
        rc = lib.mpcq_box_qp_sched(*args, inp["lanes"], stream)
    else:
        rc = lib.mpcq_box_qp(*args, stream)
    _build.check_status("compare_build kernel E", rc)
    return out


def run_f(lib, inp, duals):
    X, U, aug = inp["X"], inp["U"], inp["aug"]
    B, N = U.shape[:2]
    out = [torch.empty((B, 4 * N), device=X.device), torch.empty((B, N + 1, 13), device=X.device),
           torch.empty((B,), device=X.device), torch.empty((B, 4 * N), device=X.device),
           torch.empty((B, 4 * N), device=X.device)]
    args = [X.data_ptr(), U.data_ptr(), *_ptrs((aug.X, aug.w, aug.L, aug.sigma_f)),
            aug.X.shape[-1], *_ptrs(inp["args"][2:]), *_ptrs(duals), inp["consts"].data_ptr(),
            inp["weights"].data_ptr(), *_ptrs(out)]
    stream = torch.cuda.current_stream().cuda_stream
    if hasattr(lib, "mpcq_sqp_step_grid"):
        lanes = inp.get("lanes") or lib.mpcq_sqp_step_lanes(B, N)
        blocks = lib.mpcq_sqp_step_grid(B, N, lanes)
        scratch = torch.empty(max(blocks, 0) * lib.mpcq_sqp_step_scratch_bytes(lanes, N) // 4,
                              device=X.device)
        rc = lib.mpcq_sqp_step_sched(*args, scratch.data_ptr(), blocks, B, N, inp["iters"], lanes,
                                     stream)
    else:
        rc = lib.mpcq_sqp_step(*args, B, N, inp["iters"], stream)
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


# Kernel B's steps beside the N=10 step at B, as (N, scenarios): at 128
# scenarios, fewer than two of its two-warp blocks an SM; at N=17 and 20, one
# warp a block (R = 3), at the cell's batch and at 128; at N=40, 4096
# scenarios, since a block of 131 KB resides once an SM and 4096 already
# fill the card 31 times over at a sixteenth of the cell's memory.
B_STEPS = ((10, 128), (17, 65536), (17, 128), (20, 65536), (20, 128), (40, 4096))

# Kernel E's QPs beside the N=10 step at B, as (N, scenarios): the
# small-batch step's (1 and 127, the first scenarios of the N=10 step), a
# quarter of the cell's batch, the other horizons of the condensed pipelines
# (nz = 20, 68) at the cell's batch and N=40 (nz = 160) at 8192 scenarios
# (its condensing maps at 65536 would take 22 GB).
E_STEPS = ((10, 1), (10, 127), (10, 16384), (5, 65536), (17, 65536), (40, 8192))
# Kernel E's inputs run again with one schedule taken whatever the batch, as
# (inputs, lanes a scenario): each schedule on the other's batches at N=10.
E_SCHEDULES = (("step", 32), ("e10x16384", 32), ("e10x16384", 16), ("e10x1", 16),
               ("e10x127", 16))

# Kernel F's steps beside the N=10 step at B, as inputs: N=10 at 128 (a warp
# a scenario) and at 16384 (the first scenarios of the N=10 step), N=17 and
# 20 at the cell's batch (a warp a scenario) and N=40 at 8192 (kernel E's
# step there).
F_STEPS = ("step10x128", "f10x16384", "step17x65536", "step20x65536", "e40x8192")
# Kernel F's inputs run again with one schedule taken whatever the batch, as
# (inputs, lanes a scenario): each schedule on the other's batches at N=10,
# and both about the batch where the wrapper switches (STEP_PAIR_MIN_B).
F_SCHEDULES = (("step", 32), ("f10x16384", 32), ("f10x16384", 16), ("step10x128", 16),
               *((f"f10x{b}", lanes) for b in (1024, 2048, 4096, 8192) for lanes in (16, 32)))

# Kernel C's steps, as (N, scenarios): the Riccati slice's horizon and two
# on either side of it at the cell's batch, and N=40 at a batch that leaves
# the card's SMs a few blocks each.
RICCATI_STEPS = ((20, 65536), (40, 65536), (80, 65536), (40, 1024))

# Kernel A's launches beside the N=10 step at B, as (N, scenarios, basis
# vectors an axis): the small-batch step and the ROS node (B=1 at N=10 and at
# N=5 with 20), the closed loop (16384), the model without drag, a ragged
# last tile (10,000 columns: tiles of 32, the last of 16), and the Riccati
# slice (N=40).
LIN_STEPS = ((10, 1, 10), (5, 1, 20), (10, 16384, 10), (10, 65536, 0), (10, 1000, 10),
             (40, 65536, 10))

# (kernel, its run, whether it takes warm duals, its inputs: the N=10 step,
# kernel A's steps "lin{N}x{scenarios}nb{nb}", kernel B's steps
# "step{N}x{scenarios}", kernel J's blocks of its first 1 or 127 scenarios,
# kernel C's steps "riccati{N}x{scenarios}", kernel G's shapes, the probe's tiles at reps = 4 or
# 32)
KERNELS = (("A", run_a, False, "step"),
           *(("A", run_a, False, f"lin{n}x{b}nb{nb}") for n, b, nb in LIN_STEPS),
           ("B", run_b, True, "step"),
           *(("B", run_b, True, f"step{n}x{b}") for n, b in B_STEPS),
           *(("C", run_c, False, f"riccati{n}x{b}") for n, b in RICCATI_STEPS),
           ("D", run_d, False, "step"),
           ("E", run_e, True, "step"),
           *(("E", run_e, True, f"e{n}x{b}") for n, b in E_STEPS),
           *(("E", run_e, True, f"{key}@{lanes}") for key, lanes in E_SCHEDULES),
           ("F", run_f, True, "step"),
           *(("F", run_f, True, key) for key in F_STEPS),
           *(("F", run_f, True, f"{key}@{lanes}") for key, lanes in F_SCHEDULES),
           ("J", run_j, False, "ab1"), ("J", run_j, False, "ab127"),
           ("G", run_g, False, "fma_registers"), ("G", run_g, False, "fma_smem"),
           ("H", _run_probe("mpcq_mirror"), False, "probe4"),
           ("H", _run_probe("mpcq_mirror"), False, "probe32"),
           ("I", _run_probe("mpcq_elem"), False, "probe4"),
           ("I", _run_probe("mpcq_elem"), False, "probe32"))
# the kernel names the profiler's rows are matched on, by kernel
PROFILED = {"A": "mpcq_lin_kernel", "H": "mirror_kernel", "I": "elem_kernel",
            "J": "condense_ab"}
# profiler launches per library and profiled row
PROFILE_REPS = 200
# the transpose probe's batch and width
PROBE_B, PROBE_NZ = 16384, 40


def make_inputs(key: str, B: int, inputs: dict, device) -> dict:
    """The inputs named `key`, made on first use (the N=10 step's at B)."""
    if key in inputs:
        return inputs[key]
    if "@" in key:
        base, lanes = key.split("@")
        inp = dict(make_inputs(base, B, inputs, device), lanes=int(lanes))
    elif key.startswith("e10x"):
        inp = first_scenarios(make_inputs("step", B, inputs, device), int(key[len("e10x"):]))
    elif key.startswith("f10x"):
        inp = first_steps(make_inputs("step", B, inputs, device), int(key[len("f10x"):]))
    elif key.startswith("e"):
        n, b = map(int, key[1:].split("x"))
        inp = step_inputs(b, device, N=n)
    elif key == "step":
        inp = step_inputs(B, device)
    elif key.startswith("lin"):
        n, b, nb = map(int, key[len("lin"):].replace("nb", "x").split("x"))
        inp = lin_inputs(b, device, n, nb)
    elif key.startswith("step"):
        n, b = map(int, key[len("step"):].split("x"))
        inp = step_inputs(b, device, N=n)
    elif key.startswith("ab"):
        inp = ab_inputs(make_inputs("step", B, inputs, device), int(key[2:]))
    elif key.startswith("riccati"):
        n, b = map(int, key[len("riccati"):].split("x"))
        inp = riccati_step_inputs(b, device, N=n)
    elif key.startswith("fma_"):
        reg = key == "fma_registers"
        inp = fma_inputs(phases.REGISTER_SHAPE if reg else phases.STREAMING_SHAPE, reg, device)
    else:
        inp = {"args": [probe_input(PROBE_B, PROBE_NZ, device)], "N": None,
               "reps": int(key[len("probe"):])}
    inputs[key] = inp
    return inp


def riccati_diffs(inp: dict, outs: dict) -> dict:
    """Kernel C's largest |du| and |dX| differences: this library against
    the other, and each against the f64 plain version on the same inputs."""
    args64 = [a.double() for a in inp["args"]]
    ref = riccati_kernel.solve_ocp_box_riccati_ipm_plain(*args64, *inp["weight_tuples"],
                                                         inp["iters"])
    del args64
    diff = lambda a, b: (a.double() - b.double()).abs().max().item()
    row = {}
    for i, v in enumerate(("du", "dX")):
        row[f"{v}_this_vs_other"] = diff(outs["this"][i], outs["other"][i])
        for k in ("this", "other"):
            row[f"{v}_{k}_vs_f64"] = diff(outs[k][i], ref[i])
    return row


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit patterns (NaNs included) of two f32 tensors."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def compare(other: pathlib.Path, B: int = 65536, reps: int = 5, kernels: str = "") -> list[dict]:
    dev = torch.device("cuda", 0)
    libs = {"other": other_library(other), "this": _build.load_library()}
    inputs, rows = {}, []
    for name, run, warm, key in KERNELS:
        if kernels and name not in kernels:
            continue
        inp = make_inputs(key, B, inputs, dev)
        starts = (("cold", (None, None)),) + ((("warm", inp["duals"]),) if warm else ())
        for start, duals in starts:
            outs = {k: run(lib, inp, duals) for k, lib in libs.items()}
            torch.cuda.synchronize()
            row = {"kernel": name, "start": start if warm else "-",
                   "B": inp["args"][0].shape[0], "N": inp["N"],
                   **{k: inp[k] for k in ("nb", "reps", "chains", "steps", "resident", "lanes")
                      if k in inp},
                   "bitwise": all(same_bits(a, b) for a, b in zip(outs["this"], outs["other"])),
                   "max_abs_diff": max((a - b).abs().max().item()
                                       for a, b in zip(outs["this"], outs["other"])),
                   "finite": all(bool(torch.isfinite(a).all()) for a in outs["this"])}
            if name == "C":
                row.update(riccati_diffs(inp, outs))
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


# One checkout's kernel C profile and Riccati-step breakdown, run from its
# root with its own package.
RICCATI = """
import json
from mpc_quad_ros_tpu_torch.bench.probe_hybrid import riccati_breakdown, riccati_profile
print(json.dumps({"profile": riccati_profile(), "breakdown": riccati_breakdown(65536, 40)}))
"""


def riccati_rates(other: pathlib.Path) -> list[dict]:
    """Each checkout's ``riccati_profile`` and ``riccati_breakdown`` in turns
    (other, this, this, other), one process a run."""
    roots = {"other": pathlib.Path(other).resolve(),
             "this": pathlib.Path(__file__).resolve().parents[2]}
    rows = []
    for k in ("other", "this", "this", "other"):
        out = subprocess.run([sys.executable, "-c", RICCATI], cwd=roots[k], capture_output=True,
                             text=True, check=True)
        rows.append({"riccati_of": k, **json.loads(out.stdout.strip().splitlines()[-1])})
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=pathlib.Path, required=True)
    ap.add_argument("--B", type=int, default=65536)
    ap.add_argument("--solves", default="", help="pipelines to run end to end, comma-separated")
    ap.add_argument("--riccati", action="store_true",
                    help="each checkout's kernel C profile and Riccati-step breakdown")
    ap.add_argument("--kernels", default="", help="only these kernels' rows (letters, e.g. EF)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare_build: needs a CUDA device")
    print(card(), flush=True)
    for row in compare(args.other, args.B, kernels=args.kernels):
        print(json.dumps(row), flush=True)
    for pipeline in filter(None, args.solves.split(",")):
        print(json.dumps(solve_rates(args.other, pipeline, args.B)), flush=True)
    if args.riccati:
        for row in riccati_rates(args.other):
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
