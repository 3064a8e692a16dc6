"""Where the time of kernels B and E goes, on one card.

    python -m mpc_quad_ros_tpu_torch.bench.ipm_parts [--B 65536]

1. Kernels A, B, E and F of this checkout on the solve cell's next
   Gauss-Newton step (``compare_build.step_inputs``: N=10, 12 IPM
   iterations) at the batch sizes the main paths launch them at, B = 1,
   1024, 4096, 16384 and --B: CUDA events around the wrappers' C entries
   (kernel A's wrapper for A), so at small B a time may include the host's
   launch.
2. The IPM with one part taken out: copies of this package under
   ``build/ipm_parts/<variant>/`` with one loop emptied, each built by its
   own ``_build.py``: kernel B's in ``csrc/ipm_box.cuh`` (the Cholesky's
   trailing updates, its panel steps' row updates, the two substitutions,
   H z, the fill of the factor's lower triangle from H), or its Cholesky's
   panel width changed; kernel E's in ``csrc/box_qp.cuh`` (``E_SOURCE``;
   ``csrc/qp_kernel.cu`` before kernel F ran it too: the trailing
   updates, the panels' rows past the panel, the two substitutions, H z past
   its first quad, the fill).
   Kernel B or E at --B, 12 iterations, against the unchanged source in the
   same process.  An emptied variant computes nothing useful: only its
   time is read, and a part's share is the full kernel's time less its
   variant's.  Each edit must match the source exactly once, so a change of
   the source stops the script instead of timing something else.

One JSON line per shape and per variant.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import shutil

import torch

from ..ops.cuda import _build, lin_kernel
from .compare_build import other_library, run_b, run_e, run_f, step_inputs
from .phases import card, device_seconds

PACKAGE = pathlib.Path(__file__).resolve().parents[1]
SHAPES = (1, 1024, 4096, 16384)
COLD = (None, None)
# variant -> edits of csrc/ipm_box.cuh (each old text must occur once)
VARIANTS = {
    "no_trailing_update": [("for (int e = ln; e < total; e += NL) {\n        const int code = tri[e], a",
                            "for (int e = ln + total; e < total; e += NL) {\n        const int code = tri[e], a")],
    "no_panel_steps": [("for (int i = j + 1 + ln; i < nz; i += NL) {\n          const T lij",
                        "for (int i = nz + ln; i < nz; i += NL) {\n          const T lij")],
    "no_substitutions": [("for (int jl = 0; jl < NL; ++jl) {", "for (int jl = NL; jl < NL; ++jl) {"),
                         ("for (int jl = NL - 1; jl >= 0; --jl) {", "for (int jl = -1; jl >= 0; --jl) {")],
    "no_hz": [("for (int j = 1; j < nz; ++j) {\n      const T sj",
               "for (int j = nz; j < nz; ++j) {\n      const T sj")],
    "no_fill": [("for (int e = ln; e < total; e += NL) {\n        const int code = tri[e], i",
                 "for (int e = ln + total; e < total; e += NL) {\n        const int code = tri[e], i")],
    "chol_panel_2": [("constexpr int CHOL_PANEL = 4;", "constexpr int CHOL_PANEL = 2;")],
    "chol_panel_8": [("constexpr int CHOL_PANEL = 4;", "constexpr int CHOL_PANEL = 8;")],
}
# kernel E's variant -> edits of csrc/E_SOURCE
E_SOURCE = "box_qp.cuh"
E_VARIANTS = {
    "e_no_trailing_update": [("for (int e = e0 + lane; e < e1; e += nl) {",
                              "for (int e = e1 + lane; e < e1; e += nl) {")],
    "e_no_panel_rows": [("for (int i = pe + ln; i < nz; i += NL) {",
                         "for (int i = nz + ln; i < nz; i += NL) {")],
    "e_no_substitutions": [("for (int jq = 0; jq < NL; jq += 4) {", "for (int jq = NL; jq < NL; jq += 4) {"),
                           ("for (int jl = NL - 1; jl >= 0; --jl) {", "for (int jl = -1; jl >= 0; --jl) {")],
    "e_no_hz": [("for (int q = 1; q < Q; ++q) hz_quad", "for (int q = Q; q < Q; ++q) hz_quad")],
    "e_no_fill": [("for (int e = ln, n = box_qp_strips(nz, 0);",
                   "for (int e = ln + nz * nz, n = box_qp_strips(nz, 0);")],
}


def variant_checkout(name: str, edits, root: pathlib.Path, source: str = "ipm_box.cuh",
                     package: pathlib.Path = PACKAGE) -> pathlib.Path:
    """A copy of `package` (this one unless given) under root/name with the
    edits applied to csrc/<source>."""
    dst = root / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(package, dst / package.name, ignore=shutil.ignore_patterns("__pycache__"))
    header = dst / package.name / "csrc" / source
    src = header.read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"{name}: {old!r} does not occur exactly once in {source}")
        src = src.replace(old, new)
    header.write_text(src)
    return dst


def sliced(inp: dict, b: int) -> dict:
    """The first b scenarios of step_inputs' batch."""
    return dict(inp, args=[a[:b].contiguous() for a in inp["args"]],
                box=tuple(a[:b].contiguous() for a in inp["box"]),
                X=inp["X"][:b].contiguous(), U=inp["U"][:b].contiguous(),
                aug=inp["aug"].map(lambda a: a[:b].contiguous()))


def ms(fn, dev, reps: int = 5) -> float:
    return device_seconds(fn, reps, dev) * 1e3


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--B", type=int, default=65536)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ipm_parts: needs a CUDA device")
    dev = torch.device("cuda", 0)
    print(card(), flush=True)
    lib = _build.load_library()
    inp = step_inputs(args.B, dev)
    for b in SHAPES + (args.B,):
        s = sliced(inp, b)
        row = {"B": b, "N": inp["N"], "iters": inp["iters"],
               "A_ms": ms(lambda: lin_kernel.linearize(s["X"], s["U"], s["aug"], s["f"], s["dt"]), dev),
               "B_ms": ms(lambda: run_b(lib, s, COLD), dev),
               "E_ms": ms(lambda: run_e(lib, s, COLD), dev),
               "F_ms": ms(lambda: run_f(lib, s, COLD), dev)}
        print(json.dumps(row), flush=True)
    root = _build.BUILD_ROOT.parent / "ipm_parts"
    print(json.dumps({"variant": "full", "B": args.B, "iters": inp["iters"],
                      "B_ms": ms(lambda: run_b(lib, inp, COLD), dev, 3),
                      "E_ms": ms(lambda: run_e(lib, inp, COLD), dev, 3)}), flush=True)
    for source, variants, kernel, run in (("ipm_box.cuh", VARIANTS, "B", run_b),
                                          (E_SOURCE, E_VARIANTS, "E", run_e)):
        for name, edits in variants.items():
            vlib = other_library(variant_checkout(name, edits, root, source))
            print(json.dumps({"variant": name, "B": args.B, "iters": inp["iters"],
                              f"{kernel}_ms": ms(lambda: run(vlib, inp, COLD), dev, 3),
                              "full_ms": ms(lambda: run(lib, inp, COLD), dev, 3)}), flush=True)


if __name__ == "__main__":
    main()
