"""Kernel B's time against its resident warps per SM, on one card.

    python -m mpc_quad_ros_tpu_torch.bench.residency_slope [--B 65536] [--warps 8,12,16]

A copy of this package under ``build/residency_slope/`` whose
``mpcq_sqp_ws_bytes`` adds ``$MPCQ_SMEM_PAD`` bytes to kernel B's block (the
launcher and the occupancy query both read it), built by its own
``_build.py``.  For each target of resident warps per SM the script finds
the least pad at which the occupancy API admits no more blocks than the
target needs (blocks of ``mpcq_sqp_block_warps`` warps), then times kernel B's C entry on the solve cell's next
Gauss-Newton step (``compare_build.step_inputs``: N=10, 12 IPM iterations),
cold and warm-started, with CUDA events, in turns (the targets in order,
then reversed).  A pad changes where the block ends, never what it
computes: each run's outputs are held bitwise to the unpadded run's.  The
copy's ``-Xptxas -v`` lines for kernel B close the output.  One JSON line
per target.

``--min-blocks M`` and ``--block-warps K`` add a second copy whose kernel B
asks ptxas for M resident blocks at R <= 2 (``SQP_MIN_BLOCKS``: ptxas fits
the registers to it) and holds K scenarios a block there (``SQP_BLOCK_WARPS``;
without --min-blocks, M keeps the source's warps an SM, SQP_MIN_BLOCKS x
SQP_BLOCK_WARPS / K), timed unpadded in the same turns, with its resident
warps and its ``-Xptxas -v`` lines: what a register cap or another block
shape costs the kernel, spills included.
"""

from __future__ import annotations

import argparse
import json
import os
import re

import torch

from ..ops.cuda import _build
from .compare_build import other_library, run_b, step_inputs
from .ipm_parts import variant_checkout
from .phases import card, device_seconds

PAD_ENV = "MPCQ_SMEM_PAD"
SIGNATURE = 'extern "C" int64_t mpcq_sqp_ws_bytes(int N) {'
PADDED = f"""#include <cstdlib>
extern "C" int64_t mpcq_sqp_ws_bytes_unpadded(int N);
{SIGNATURE}
  const char* pad = std::getenv("{PAD_ENV}");
  return mpcq_sqp_ws_bytes_unpadded(N) + (pad ? std::atoll(pad) : 0);
}}
extern "C" int64_t mpcq_sqp_ws_bytes_unpadded(int N) {{"""
MIN_BLOCKS = re.compile(r"constexpr int SQP_MIN_BLOCKS = \d+;")
BLOCK_WARPS = re.compile(r"constexpr int SQP_BLOCK_WARPS = \d+;")
# pads are searched in steps of the SM's shared-memory allocation unit
PAD_STEP, PAD_MAX = 128, 232_448


def set_pad(nbytes: int) -> None:
    os.environ[PAD_ENV] = str(nbytes)


def pad_for(lib, N: int, blocks: int) -> int:
    """The least pad at which at most `blocks` blocks of kernel B reside."""
    def resident(p):
        set_pad(p)
        return lib.mpcq_sqp_occupancy(0, N)
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
    """The copy's -Xptxas -v lines of kernel B's instantiations."""
    out, keep = [], False
    for log in sorted(root.glob("build/torch_kernels/*/build.log")):
        for line in log.read_text().splitlines():
            if "Compiling entry function" in line or "Function properties for" in line:
                keep = "sqp_fused_kernel" in line
            if keep and (line.startswith("ptxas") or "spill" in line):
                out.append(line.strip())
    return out


def shaped_checkout(min_blocks: int, block_warps: int, root):
    """A copy of this package whose kernel B asks for `min_blocks` resident
    blocks and holds `block_warps` scenarios a block at R <= 2 (either 0:
    the source's, or with `block_warps` its warps an SM)."""
    src = (_build.CSRC / "sqp_fused_kernel.cu").read_text()
    (warps,), (blocks,) = BLOCK_WARPS.findall(src), MIN_BLOCKS.findall(src)
    value = lambda m: int(m.split("=")[1].strip(" ;"))
    if block_warps and not min_blocks:
        min_blocks = value(blocks) * value(warps) // block_warps
    edits = []
    if block_warps:
        edits.append((warps, f"constexpr int SQP_BLOCK_WARPS = {block_warps};"))
    if min_blocks:
        edits.append((blocks, f"constexpr int SQP_MIN_BLOCKS = {min_blocks};"))
    return variant_checkout(f"shaped_{min_blocks}_{block_warps}", edits, root,
                            "sqp_fused_kernel.cu")


def timed(lib, inp, dev, row, ref) -> None:
    """Kernel B cold and warm: bitwise against ref, ms appended to row."""
    for start, duals in (("cold", (None, None)), ("warm", inp["duals"])):
        out = run_b(lib, inp, duals)
        row.setdefault(f"{start}_bitwise", True)
        row[f"{start}_bitwise"] &= all(torch.equal(a, b) for a, b in zip(out, ref[start]))
        row.setdefault(f"{start}_ms", []).append(
            device_seconds(lambda: run_b(lib, inp, duals), 5, dev) * 1e3)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--B", type=int, default=65536)
    ap.add_argument("--warps", default="8,12,16", help="targets of resident warps per SM")
    ap.add_argument("--min-blocks", type=int, default=0,
                    help="also time a copy whose kernel B asks for these resident blocks")
    ap.add_argument("--block-warps", type=int, default=0,
                    help="also time a copy whose kernel B holds these scenarios a block")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("residency_slope: needs a CUDA device")
    dev = torch.device("cuda", 0)
    print(card(), flush=True)
    where = _build.BUILD_ROOT.parent / "residency_slope"
    root = variant_checkout("padded", [(SIGNATURE, PADDED)], where, "sqp_fused_kernel.cu")
    lib = other_library(root)
    shaped = (shaped_checkout(args.min_blocks, args.block_warps, where)
              if args.min_blocks or args.block_warps else None)
    slib = other_library(shaped) if shaped else None
    inp = step_inputs(args.B, dev)
    N = inp["N"]
    block_warps = lib.mpcq_sqp_block_warps(N)
    set_pad(0)
    ref = {s: run_b(lib, inp, d) for s, d in (("cold", (None, None)), ("warm", inp["duals"]))}
    targets = [int(w) for w in args.warps.split(",")]
    rows = {}
    for w in targets + targets[::-1]:
        blocks = -(-w // block_warps)
        pad = pad_for(lib, N, blocks)
        set_pad(pad)
        row = rows.setdefault(w, {"target_warps": w, "B": args.B, "N": N, "iters": inp["iters"],
                                  "block_warps": block_warps, "pad_bytes": pad,
                                  "smem_bytes": lib.mpcq_sqp_ws_bytes(N),
                                  "resident_blocks_per_sm": lib.mpcq_sqp_occupancy(0, N)})
        row["resident_warps_per_sm"] = row["resident_blocks_per_sm"] * block_warps
        timed(lib, inp, dev, row, ref)
        if slib is not None and w == targets[-1]:
            set_pad(0)
            swarps = slib.mpcq_sqp_block_warps(N)
            blocks = slib.mpcq_sqp_occupancy(0, N)
            srow = rows.setdefault("shaped", {
                "copy": shaped.name, "block_warps": swarps, "B": args.B, "N": N,
                "resident_blocks_per_sm": blocks, "resident_warps_per_sm": blocks * swarps})
            timed(slib, inp, dev, srow, ref)
    set_pad(0)
    for row in rows.values():
        print(json.dumps(row), flush=True)
    print(json.dumps({"ptxas": ptxas_lines(root)}), flush=True)
    if shaped:
        print(json.dumps({"ptxas_min_blocks": args.min_blocks, "ptxas_block_warps": args.block_warps,
                          "ptxas": ptxas_lines(shaped)}), flush=True)


if __name__ == "__main__":
    main()
