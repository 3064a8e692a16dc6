"""Where the time of kernel C goes, on one card.

    python -m mpc_quad_ros_tpu_torch.bench.riccati_parts [--B 65536]
        [--warps 8,12,16,22] [--min-blocks 16,23]

Kernel C (``csrc/riccati_ipm.cu``) of this checkout on the Riccati slice's
next Gauss-Newton step at N=40 (``compare_build.riccati_step_inputs``),
through its C entry ``mpcq_riccati_ipm``:

1. Its time against the IPM iteration count (0, 2, 6, 12): the slope is
   one iteration (the sweep, the forward pass and the update), the
   intercept the cold start and the two rollouts.
2. Parts emptied: copies of the package under ``build/riccati_parts/``
   whose kernel skips one part behind a condition that never holds (the
   compiler keeps the code, the card never runs it): the sweep's two tile
   products, the 4x4 solves (and p), the update of P, or the forward pass.
   Each edit must match the source exactly once, so a change of the kernel
   stops the script instead of timing something else.  An emptied variant
   computes nothing useful: only its time is read, and a part's share is
   the full kernel's time less its variant's.
3. The time against resident warps per SM: a copy whose
   ``mpcq_riccati_ws_bytes`` adds ``$MPCQ_SMEM_PAD`` bytes to the block
   (the launcher and the occupancy query both read it), at the least pad
   that admits no more blocks than each target; its outputs are held
   bitwise to the unpadded run's.

``--min-blocks`` adds, for each M given, a copy whose launch bound asks
ptxas for M resident blocks (``MIN_BLOCKS``): what another register fit
costs, with its outputs held bitwise to the full kernel's.

All copies are built by their own ``_build.py`` and timed with CUDA events
in turns (the variants in order, then reversed).  One JSON line per
iteration count, variant and target, then the copies' ``-Xptxas -v`` lines
for kernel C.
"""

from __future__ import annotations

import argparse
import json
import re

import torch

from ..ops.cuda import _build
from .compare_build import other_library, riccati_step_inputs, run_c
from .ipm_parts import PACKAGE, variant_checkout
from .phases import card, device_seconds
from .residency_slope import set_pad

SOURCE = "riccati_ipm.cu"
NEVER = "if (N < 0) "          # a condition the compiler cannot drop
VARIANTS = {
    "no_products": [("      // W = J [P | p]: W^T and J p\n      for (",
                     f"      // W = J [P | p]: W^T and J p\n      {NEVER}for ("),
                    ("      // M = J W^T: A^T P A (rows 0-12), S and G (rows 13-16) where J_k was\n"
                     "      for (",
                     "      // M = J W^T: A^T P A (rows 0-12), S and G (rows 13-16) where J_k was\n"
                     f"      {NEVER}for (")],
    "no_solve": [("      // (m = 13) solved by lane m; p by lanes 0-12\n      {",
                  f"      // (m = 13) solved by lane m; p by lanes 0-12\n      {NEVER}{{")],
    "no_p_update": [("      // P = diag(q) + sym(A^T P A) - sym(S^T K), both halves of each entry\n"
                     "      MPCQ_UNROLL\n      for (",
                     "      // P = diag(q) + sym(A^T P A) - sym(S^T K), both halves of each entry\n"
                     f"      MPCQ_UNROLL\n      {NEVER}for (")],
    "no_forward": [("    for (int k = 0, sk = 0, sn = 2; k < N; ++k, sk = next_slot<3>(sk), sn = next_slot<3>(sn)) {\n"
                    "      jks.wait(",
                    f"    {NEVER}for (int k = 0, sk = 0, sn = 2; k < N; ++k, sk = next_slot<3>(sk), sn = next_slot<3>(sn)) {{\n"
                    "      jks.wait(")],
}
SIGNATURE = 'extern "C" int64_t mpcq_riccati_ws_bytes(int N) {'
PADDED = f"""#include <cstdlib>
extern "C" int64_t mpcq_riccati_ws_bytes_unpadded(int N);
extern "C" int64_t mpcq_riccati_ws_bytes(int N) {{
  const char* pad = std::getenv("MPCQ_SMEM_PAD");
  return mpcq_riccati_ws_bytes_unpadded(N) + (pad ? std::atoll(pad) : 0);
}}
"""
MIN_BLOCKS = re.compile(r"constexpr int MIN_BLOCKS = \d+;")
ITERS = (0, 2, 6, 12)
PAD_STEP, PAD_MAX = 128, 232_448


def pad_for(lib, N: int, blocks: int) -> int:
    """The least pad at which at most `blocks` blocks of kernel C reside."""
    def resident(p):
        set_pad(p)
        return lib.mpcq_riccati_occupancy(N)
    if resident(0) <= blocks:
        return 0
    lo, hi = 0, PAD_MAX // PAD_STEP          # resident(lo) > blocks >= resident(hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if resident(mid * PAD_STEP) > blocks:
            lo = mid
        else:
            hi = mid
    return hi * PAD_STEP


def ptxas_lines(root) -> list[str]:
    """A copy's -Xptxas -v lines of kernel C."""
    out, keep = [], False
    for log in sorted(root.glob("build/torch_kernels/*/build.log")):
        for line in log.read_text().splitlines():
            if "Compiling entry function" in line or "Function properties for" in line:
                keep = "mpcq_riccati_kernel" in line
            if keep and (line.startswith("ptxas") or "spill" in line):
                out.append(line.strip())
    return out


def bitwise(a, b) -> bool:
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(a, b))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--B", type=int, default=65536)
    ap.add_argument("--warps", default="8,12,16,22", help="targets of resident warps per SM")
    ap.add_argument("--min-blocks", default="", help="resident blocks to fit registers to")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("riccati_parts: needs a CUDA device")
    dev = torch.device("cuda", 0)
    print(card(), flush=True)
    root = _build.BUILD_ROOT.parent / "riccati_parts"
    copy = lambda name, edits: variant_checkout(name, edits, root, SOURCE, PACKAGE)
    roots = {"full": copy("full", [])}
    roots.update({name: copy(name, edits) for name, edits in VARIANTS.items()})
    src = (PACKAGE / "csrc" / SOURCE).read_text()
    (bound,) = MIN_BLOCKS.findall(src)
    for m in filter(None, args.min_blocks.split(",")):
        roots[f"min_blocks_{m}"] = copy(f"min_blocks_{m}",
                                        [(bound, f"constexpr int MIN_BLOCKS = {m};")])
    roots["padded"] = copy("padded", [(SIGNATURE, PADDED + SIGNATURE.replace(
        "ws_bytes(", "ws_bytes_unpadded("))])
    libs = {name: other_library(r) for name, r in roots.items()}
    inp = riccati_step_inputs(args.B, dev, N=40)
    B, N = inp["args"][0].shape[:2]
    set_pad(0)
    ref = run_c(libs["full"], inp, None)

    rows = {}
    for it in ITERS + ITERS[::-1]:
        row = rows.setdefault(it, {"variant": "full", "B": B, "N": N, "iters": it, "ms": []})
        run = lambda: run_c(libs["full"], dict(inp, iters=it), None)
        row["ms"].append(device_seconds(run, 3, dev) * 1e3)
    for row in rows.values():
        print(json.dumps(row), flush=True)

    rows = {}
    names = [n for n in libs if n != "padded"]
    for name in names + names[::-1]:
        row = rows.setdefault(name, {"variant": name, "B": B, "N": N, "iters": inp["iters"],
                                     "ms": []})
        if name.startswith("min_blocks") and "bitwise" not in row:
            row["bitwise"] = bitwise(run_c(libs[name], inp, None), ref)
        row["ms"].append(device_seconds(lambda: run_c(libs[name], inp, None), 3, dev) * 1e3)
    for row in rows.values():
        print(json.dumps(row), flush=True)

    lib = libs["padded"]
    targets = [int(w) for w in args.warps.split(",")]
    rows = {}
    for w in targets + targets[::-1]:
        pad = pad_for(lib, N, w)
        set_pad(pad)
        row = rows.setdefault(w, {"target_warps": w, "B": B, "N": N, "pad_bytes": pad,
                                  "smem_bytes": lib.mpcq_riccati_ws_bytes(N),
                                  "resident_warps_per_sm": lib.mpcq_riccati_occupancy(N),
                                  "bitwise": True, "ms": []})
        row["bitwise"] &= bitwise(run_c(lib, inp, None), ref)
        row["ms"].append(device_seconds(lambda: run_c(lib, inp, None), 3, dev) * 1e3)
    set_pad(0)
    for row in rows.values():
        print(json.dumps(row), flush=True)
    for name, r in roots.items():
        if name == "full" or name.startswith("min_blocks"):
            print(json.dumps({"copy": name, "ptxas": ptxas_lines(r)}), flush=True)


if __name__ == "__main__":
    main()
