"""Tracing and profiling.  Counterpart of ``mpc_quad_ros_tpu/io/profiling.py``:

- ``Stopwatch`` and ``timed``: phase timers that synchronize the card (the
  JAX package's ``block_until_ready``); ``timed`` takes CUDA events where
  its arguments lie on the card, the host clock otherwise;
- ``trace``: ``torch.profiler`` around a block, written as a Chrome trace;
- ``profile_solver_phases``: one batched solve by phase: kernel A (the
  linearisation), kernel D (condensing), kernel E (the standalone box-QP
  IPM) and the whole ``solve_batch`` (kernels A and B at B >= 128).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch

from ..utils.containers import Tensors


def _on_card(objs) -> bool:
    """Whether any tensor among objs (tensors, records, tuples) lies on the
    card."""
    for a in objs:
        if isinstance(a, torch.Tensor) and a.is_cuda:
            return True
        if isinstance(a, Tensors) and _on_card(a.fields().values()):
            return True
        if isinstance(a, (tuple, list)) and _on_card(a):
            return True
    return False


class Stopwatch:
    """Accumulating named phase timer (host clock)."""

    def __init__(self):
        self.phases: dict = {}

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        """Time the block; with `block_on` (tensors on the card), up to the
        card's end of the work."""
        t0 = time.perf_counter()
        yield
        if block_on is not None and _on_card([block_on]):
            torch.cuda.synchronize()
        self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        total = sum(self.phases.values())
        lines = [f"total {total * 1e3:.2f} ms"]
        for k, v in sorted(self.phases.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {k:24s} {v * 1e3:8.2f} ms  {100 * v / total:5.1f}%")
        return "\n".join(lines)


def timed(fn: Callable, *args, iters: int = 10, warmup: bool = True) -> float:
    """Seconds a call of fn(*args) over `iters` calls, after one untimed
    call with `warmup`: CUDA events where an argument lies on the card,
    else the host clock."""
    if warmup:
        fn(*args)
    if not _on_card(args):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block (the CPU, and the card where there
    is one); the trace goes to `log_dir`/trace.json (Chrome / Perfetto)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def profile_solver_phases(solver, carry, x0, y_ref, aug=None, iters: int = 10) -> dict:
    """Seconds a call of each phase of one batched solve (inputs batch-major,
    leading B): kernel A along the carry (`linearize_s`), kernel D on its J
    (`assemble_s`), kernel E on that QP (`qp_s`) and ``solve_batch`` whole
    (`full_solve_s`).

    The keys are the JAX package's.  `assemble_s` times other work there:
    the whole vmapped assembly (linearisation, condensing and the QP's
    bounds), here condensing alone on a J made beforehand, so it is not
    comparable across the packages.  `qp_s` is the same box-QP kernel in
    both (kernel E ports its Pallas kernel); the hybrid ``solve_batch``
    behind `full_solve_s` runs kernel B and not E, so `qp_s` is no part of
    `full_solve_s` here."""
    from ..models.augmented import fold_drag
    from ..ops.cuda.condense_kernel import condense_cost_from_J
    from ..ops.cuda.qp_kernel import solve_box_qp_pdip_batch

    cfg = solver.cfg
    folded = fold_drag(aug)
    if folded is not None:
        folded = folded.map(lambda a: a.contiguous())
    X, U = carry.X.contiguous(), carry.U.contiguous()
    x0, y_ref = x0.contiguous(), y_ref.contiguous()
    y_ref_N = y_ref[:, -1].contiguous()
    w = cfg.weight_tuples()

    xp, J = solver._linearize(X, U, folded)
    r, dx0, ex0, gu, lb, ub = solver.qp_inputs(X, U, x0, y_ref, y_ref_N, xp)
    H, g, _, _ = condense_cost_from_J(J, r, dx0, ex0, *w)
    g = g + gu
    res = {
        "linearize_s": timed(solver._linearize, X, U, folded, iters=iters),
        "assemble_s": timed(lambda *a: condense_cost_from_J(*a, *w), J, r, dx0, ex0,
                            iters=iters),
        "qp_s": timed(lambda *a: solve_box_qp_pdip_batch(*a, cfg.qp_iters), H, g, lb, ub,
                      iters=iters),
        "full_solve_s": timed(lambda c, x, yr: solver.solve_batch(c, x, yr, yr[:, -1], aug),
                              carry, x0, y_ref, iters=iters),
        "batch": x0.shape[0],
    }
    res["solves_per_s"] = res["batch"] / res["full_solve_s"]
    return res
