"""Where the time of kernel F goes, on one card.

    python -m mpc_quad_ros_tpu_torch.bench.step_parts [--B 65536] [--tree DIR] [--split]

Kernel F (``mpcq_sqp_step_kernel`` in ``csrc/sqp_fused_kernel.cu``) of the
checkout DIR (this one unless given; another commit unpacked under
``build/`` to measure it) on the solve cell's next Gauss-Newton step
(``compare_build.step_inputs``: N=10, 10 RGP basis vectors an axis, 12 IPM
iterations), cold, through its C entry (``compare_build.run_f``):

1. Parts emptied: copies of DIR's package under ``build/step_parts/`` whose
   kernel skips one part (a loop that runs no time, or a call behind a
   condition that never holds): the linearisation, the condensing, the
   interior point, or the tail (the KKT residual and the dX recurrence).
   The edits follow the design DIR's source holds (``DESIGNS``: one warp a
   scenario with J staged in shared memory, the earlier design, or teams of
   kernel E's schedule with J in a device scratch); each must match its
   source exactly once, so a change of the kernel stops the script instead
   of timing something else.
   An emptied variant computes nothing useful: only its time is read, and
   a part's share is the full kernel's time less its variant's.  The
   copies are timed with CUDA events in turns (in order, then reversed).
2. The full copy's ``-Xptxas -v`` lines for kernel F, and its shared
   memory, scenarios a block and resident blocks an SM at N=10 (the
   occupancy API).

``--split`` adds DIR's ``bench/phases.py::fused_phase_split`` at --B (the
"fused" pipeline's time a solve as a line in the IPM iterations 4, 8, 12),
run from DIR's root with its own package.  One JSON line per variant, then
the residency line, then the split.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import torch

from ..ops.cuda import _build
from .compare_build import other_library, run_f, step_inputs
from .ipm_parts import PACKAGE, variant_checkout
from .phases import card, device_seconds

SOURCE = "sqp_fused_kernel.cu"
NEVER = "if (N < 0) "          # a condition the compiler cannot drop
# design -> (a text only its source holds, {variant: edits of csrc/SOURCE})
DESIGNS = {
    "warp_staged_j": ("for (int t = tm.lane; t < N * ST; t += Team::size) {", {
        "no_lin": [("for (int t = tm.lane; t < N * ST; t += Team::size) {",
                    "for (int t = tm.lane + N * ST; t < N * ST; t += Team::size) {")],
        "no_condense": [("  condense_packed(tm, N, wt, J, w.Mb, db, A, g, rg, dx0, ex0);",
                         f"  {NEVER}condense_packed(tm, N, wt, J, w.Mb, db, A, g, rg, dx0, ex0);")],
        "no_ipm": [("  ipm_box_solve<R>(tm, nz, iters,", f"  {NEVER}ipm_box_solve<R>(tm, nz, iters,")],
        "no_tail": [("  for (int i = ln; i < nz; i += NL) {\n    T Hz",
                     "  for (int i = ln + nz; i < nz; i += NL) {\n    T Hz"),
                    ("for (int k = 0; k < N; ++k, Jk += J_STAGE) {",
                     "for (int k = N; k < N; ++k, Jk += J_STAGE) {")],
    }),
    "teams_scratch_j": ("sqp_step_lin(tm, N, c, X, U, drag, w, Jg, rg);", {
        "no_lin": [("  sqp_step_lin(tm, N, c, X, U, drag, w, Jg, rg);",
                    f"  {NEVER}sqp_step_lin(tm, N, c, X, U, drag, w, Jg, rg);")],
        "no_condense": [("  condense_packed(tm, N, ld, wt,", f"  {NEVER}condense_packed(tm, N, ld, wt,")],
        "no_ipm": [("  box_qp_solve<R>(tm, nz, iters, tbl,", f"  {NEVER}box_qp_solve<R>(tm, nz, iters, tbl,")],
        "no_tail": [("  sqp_step_tail(tm, N,", f"  {NEVER}sqp_step_tail(tm, N,")],
    }),
}

SPLIT = """
import json
from mpc_quad_ros_tpu_torch.bench.phases import fused_phase_split
print(json.dumps(fused_phase_split({B})))
"""


def design_of(package: pathlib.Path) -> tuple[str, dict]:
    src = (package / "csrc" / SOURCE).read_text()
    for name, (marker, variants) in DESIGNS.items():
        if marker in src:
            return name, variants
    raise SystemExit(f"step_parts: {package}/csrc/{SOURCE} holds none of the known designs")


def ptxas_lines(root: pathlib.Path) -> list[str]:
    """A copy's -Xptxas -v lines of kernel F's instantiations."""
    out, keep = [], False
    for log in sorted(root.glob("build/torch_kernels/*/build.log")):
        for line in log.read_text().splitlines():
            if "Compiling entry function" in line or "Function properties for" in line:
                keep = "sqp_step_kernel" in line
            if keep and (line.startswith("ptxas") or "spill" in line):
                out.append(line.strip())
    return out


def residency(lib, N: int) -> dict:
    """Kernel F's block at N for the large batches' schedule: its shared
    bytes, scenarios, and resident blocks an SM (the occupancy API)."""
    per_block = (lib.mpcq_sqp_step_block_scenarios(lib.mpcq_sqp_step_lanes(1 << 30, N), N)
                 if hasattr(lib, "mpcq_sqp_step_block_scenarios") else 1)
    blocks = lib.mpcq_sqp_occupancy(1, N)
    return {"N": N, "smem_bytes": lib.mpcq_sqp_step_ws_bytes(N), "scenarios_per_block": per_block,
            "resident_blocks_per_sm": blocks, "resident_scenarios_per_sm": blocks * per_block}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--B", type=int, default=65536)
    ap.add_argument("--tree", type=pathlib.Path, default=None,
                    help="another checkout whose kernel F to take apart")
    ap.add_argument("--split", action="store_true", help="also the tree's fused_phase_split")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("step_parts: needs a CUDA device")
    dev = torch.device("cuda", 0)
    print(card(), flush=True)
    package = (args.tree.resolve() / PACKAGE.name) if args.tree else PACKAGE
    design, variants = design_of(package)
    root = _build.BUILD_ROOT.parent / "step_parts"
    copy = lambda name, edits: variant_checkout(name, edits, root, SOURCE, package)
    roots = {"full": copy("full", [])}
    roots.update({name: copy(name, edits) for name, edits in variants.items()})
    libs = {name: other_library(r) for name, r in roots.items()}
    inp = step_inputs(args.B, dev)
    rows = {}
    names = list(libs)
    cold = (None, None)
    for name in names + names[::-1]:
        row = rows.setdefault(name, {"design": design, "variant": name, "B": args.B,
                                     "N": inp["N"], "iters": inp["iters"], "ms": []})
        row["ms"].append(device_seconds(lambda: run_f(libs[name], inp, cold), 5, dev) * 1e3)
    for row in rows.values():
        print(json.dumps(row), flush=True)
    print(json.dumps({"design": design, **residency(libs["full"], inp["N"]),
                      "ptxas": ptxas_lines(roots["full"])}), flush=True)
    if args.split:
        tree = package.parent
        out = subprocess.run([sys.executable, "-c", SPLIT.format(B=args.B)], cwd=tree,
                             capture_output=True, text=True, check=True)
        print(json.dumps({"design": design, "fused_phase_split":
                          json.loads(out.stdout.strip().splitlines()[-1])}), flush=True)


if __name__ == "__main__":
    main()
