"""Where the time of kernel A goes, on one card.

    python -m mpc_quad_ros_tpu_torch.bench.lin_parts [--B 65536] [--tree DIR]
        [--warps 4,8,12,16] [--min-blocks 4,6]

Kernel A (``csrc/lin_kernel.cu``) of the checkout DIR (this one unless
given; another commit unpacked under ``build/`` to measure it) on the solve
cell's next Gauss-Newton step (``compare_build.step_inputs``: N=10, 10 RGP
basis vectors an axis), through its C entry ``mpcq_lin``:

1. Phases emptied: copies of DIR's package under ``build/lin_parts/`` whose
   kernel skips one phase behind a condition that never holds (the
   compiler keeps the code, the card never runs it): the primal pass (the
   drag's moments, and the primal the tangents read, taken as given), the
   tangent pass, or the stores of J and x+ to device memory.  The edits
   follow the design DIR's source holds (``DESIGNS``: the blocks of 32
   columns of PR 6, or the tiles of 128 columns since); each must match
   the source exactly once, so a change of the kernel stops the script
   instead of timing something else.  An emptied variant computes nothing
   useful: only its time is read, and a phase's share is the full kernel's
   time less its variant's.
2. The time against resident warps per SM: a copy whose
   ``mpcq_lin_ws_bytes`` adds ``$MPCQ_SMEM_PAD`` bytes to the block (the
   launcher and the occupancy query both read it), at the least pad that
   admits no more blocks than each target needs; its outputs are held
   bitwise to the unpadded run's.

``--min-blocks`` adds, for each M given, a copy whose launch bound asks
ptxas for M resident blocks (``MIN_BLOCKS``: ptxas fits the registers to
it), timed beside the variants: what another register fit costs.

All copies are built by their own ``_build.py`` and timed with CUDA events
in turns (the variants in order, then reversed).  One JSON line per variant
and per target, then the copies' ``-Xptxas -v`` lines for kernel A.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re

import torch

from ..ops.cuda import _build
from .compare_build import other_library, run_a, step_inputs
from .ipm_parts import PACKAGE, variant_checkout
from .phases import card, device_seconds
from .residency_slope import PAD_ENV, PAD_MAX, PAD_STEP, set_pad

SOURCE = "lin_kernel.cu"
NEVER = "if (a.B < 0) "        # a condition the compiler cannot drop
# design -> (a text only its source holds, {variant: edits of csrc/lin_kernel.cu})
DESIGNS = {
    "blocks32_pr6": ("constexpr int COLS = 32, THREADS = 128;", {
        "no_primal": [("  blk.primal(threadIdx.x, blockDim.x);",
                       f"  {NEVER}blk.primal(threadIdx.x, blockDim.x);")],
        "no_tangents": [("  blk.tangents(threadIdx.x, blockDim.x);",
                         f"  {NEVER}blk.tangents(threadIdx.x, blockDim.x);")],
        "no_stores": [("  blk.store(threadIdx.x, blockDim.x);",
                       f"  {NEVER}blk.store(threadIdx.x, blockDim.x);")],
    }),
    "tiles128": ("constexpr int TILE = 128, THREADS = 128;", {
        "no_primal": [("  tile.primal(threadIdx.x);", f"  {NEVER}tile.primal(threadIdx.x);")],
        "no_tangents": [("    if (it < tile.items()) tile.tangent(it, w);",
                         f"    {NEVER}if (it < tile.items()) tile.tangent(it, w);")],
        "no_stores": [("    tile.store_rows(q, w, lane);", f"    {NEVER}tile.store_rows(q, w, lane);"),
                      ("  tile.store_xp(threadIdx.x);", f"  {NEVER}tile.store_xp(threadIdx.x);")],
    }),
}
# the entry's first line, with its parameter named or not
SIGNATURES = ('extern "C" int64_t mpcq_lin_ws_bytes(int N) {',
              'extern "C" int64_t mpcq_lin_ws_bytes(int) {')
PADDED = f"""#include <cstdlib>
extern "C" int64_t mpcq_lin_ws_bytes_unpadded(int N);
extern "C" int64_t mpcq_lin_ws_bytes(int N) {{
  const char* pad = std::getenv("{PAD_ENV}");
  return mpcq_lin_ws_bytes_unpadded(N) + (pad ? std::atoll(pad) : 0);
}}
"""
WARPS_PER_BLOCK = 4          # both designs launch blocks of 128 threads
MIN_BLOCKS = re.compile(r"constexpr int MIN_BLOCKS = \d+;")


def design_of(package: pathlib.Path) -> tuple[str, dict]:
    src = (package / "csrc" / SOURCE).read_text()
    for name, (marker, variants) in DESIGNS.items():
        if marker in src:
            return name, variants
    raise SystemExit(f"lin_parts: {package}/csrc/{SOURCE} holds none of the known designs")


def pad_for(lib, N: int, blocks: int) -> int:
    """The least pad at which at most `blocks` blocks of kernel A reside."""
    def resident(p):
        set_pad(p)
        return lib.mpcq_lin_occupancy(N)
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


def ptxas_lines(root: pathlib.Path) -> list[str]:
    """A copy's -Xptxas -v lines of kernel A."""
    out, keep = [], False
    for log in sorted(root.glob("build/torch_kernels/*/build.log")):
        for line in log.read_text().splitlines():
            if "Compiling entry function" in line or "Function properties for" in line:
                keep = "mpcq_lin_kernel" in line
            if keep and (line.startswith("ptxas") or "spill" in line):
                out.append(line.strip())
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--B", type=int, default=65536)
    ap.add_argument("--tree", type=pathlib.Path, default=None,
                    help="another checkout whose kernel A to take apart")
    ap.add_argument("--warps", default="4,8,12,16", help="targets of resident warps per SM")
    ap.add_argument("--min-blocks", default="", help="resident blocks to fit registers to")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("lin_parts: needs a CUDA device")
    dev = torch.device("cuda", 0)
    print(card(), flush=True)
    package = (args.tree.resolve() / PACKAGE.name) if args.tree else PACKAGE
    design, variants = design_of(package)
    root = _build.BUILD_ROOT.parent / "lin_parts"
    copy = lambda name, edits: variant_checkout(name, edits, root, SOURCE, package)
    roots = {"full": copy("full", [])}
    roots.update({name: copy(name, edits) for name, edits in variants.items()})
    src = (package / "csrc" / SOURCE).read_text()
    (bound,) = MIN_BLOCKS.findall(src)
    for m in filter(None, args.min_blocks.split(",")):
        roots[f"min_blocks_{m}"] = copy(f"min_blocks_{m}",
                                        [(bound, f"constexpr int MIN_BLOCKS = {m};")])
    sig = next(s for s in SIGNATURES if s in src)
    roots["padded"] = copy("padded", [(sig, PADDED + sig.replace("ws_bytes(", "ws_bytes_unpadded("))])
    libs = {name: other_library(r) for name, r in roots.items()}
    inp = step_inputs(args.B, dev)
    N, B = inp["N"], inp["X"].shape[0]
    set_pad(0)
    ref = run_a(libs["full"], inp, None)
    rows = {}
    names = [n for n in libs if n != "padded"]
    for name in names + names[::-1]:
        row = rows.setdefault(name, {"design": design, "variant": name, "B": B, "N": N,
                                     "nb": inp["aug"].X.shape[-1], "ms": []})
        if name.startswith("min_blocks") and "bitwise" not in row:
            row["bitwise"] = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                                 for a, b in zip(run_a(libs[name], inp, None), ref))
        row["ms"].append(device_seconds(lambda: run_a(libs[name], inp, None), 5, dev) * 1e3)
    for row in rows.values():
        print(json.dumps(row), flush=True)
    lib = libs["padded"]
    targets = [int(w) for w in args.warps.split(",")]
    rows = {}
    for w in targets + targets[::-1]:
        pad = pad_for(lib, N, -(-w // WARPS_PER_BLOCK))
        set_pad(pad)
        blocks = lib.mpcq_lin_occupancy(N)
        row = rows.setdefault(w, {"design": design, "target_warps": w, "B": B, "N": N,
                                  "pad_bytes": pad, "smem_bytes": lib.mpcq_lin_ws_bytes(N),
                                  "resident_warps_per_sm": blocks * WARPS_PER_BLOCK,
                                  "bitwise": True, "ms": []})
        out = run_a(lib, inp, None)
        row["bitwise"] &= all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                              for a, b in zip(out, ref))
        row["ms"].append(device_seconds(lambda: run_a(lib, inp, None), 5, dev) * 1e3)
    set_pad(0)
    for row in rows.values():
        print(json.dumps(row), flush=True)
    for name, r in roots.items():
        if name == "full" or name.startswith("min_blocks"):
            print(json.dumps({"design": design, "copy": name, "ptxas": ptxas_lines(r)}), flush=True)


if __name__ == "__main__":
    main()
