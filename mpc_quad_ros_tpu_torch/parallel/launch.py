"""Start the multi-process scenario farm on one host and collect its results.

Counterpart of ``mpc_quad_ros_tpu/parallel/launch.py``: spawns `nproc` fresh
``python -m mpc_quad_ros_tpu_torch.parallel.mp_worker`` processes (never a
fork of a process whose CUDA is up) joined by a ``file://`` rendezvous in a
private temporary directory (no port to probe, so concurrent launches
cannot collide), waits for them, and returns their results ordered by rank.
A nonzero exit or a timeout raises with the worker's log tail.

On the card the CUDA library is built once here, before the ranks start,
so they load it instead of each compiling every source.  Ranks that
outnumber the cards share them over gloo (``parallel/distributed.py``):
with one card, two ranks time-share it, and their solves/s measure that
contention, not scaling.

    python -m mpc_quad_ros_tpu_torch.parallel.launch --nproc 2 --device cuda \\
        --global-batch 131072 --qp-iters 12 --chain 3 --ticks 3 --repeats 5
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np

REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]


def launch_workers(nproc: int = 2, global_batch: int = 1024, qp_iters: int = 12,
                   ticks: int = 0, repeats: int = 1, chain: int = 1, device="cuda",
                   timeout: float = 1800.0) -> list[dict]:
    """Run the worker in `nproc` local processes; their result dicts ordered
    by rank.  Raises on any nonzero exit or timeout."""
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        from ..ops.cuda import _build

        _build.build()
    with tempfile.TemporaryDirectory() as td:
        init = pathlib.Path(td, "rendezvous").as_uri()
        outs = [os.path.join(td, f"shard{rank}.npz") for rank in range(nproc)]
        logs = [open(os.path.join(td, f"rank{rank}.log"), "w+") for rank in range(nproc)]
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join([str(REPO_ROOT)] + [
            p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                  "MASTER_PORT"):
            env.pop(k, None)
        if dev.type == "cpu" and "OMP_NUM_THREADS" not in env:
            # ranks on the CPU split its cores (each taking them all
            # oversubscribes them: 3.5x slower at two ranks on eight cores)
            env["OMP_NUM_THREADS"] = str(max(1, len(os.sched_getaffinity(0)) // nproc))
        procs = []
        try:
            for rank in range(nproc):
                cmd = [sys.executable, "-m", "mpc_quad_ros_tpu_torch.parallel.mp_worker",
                       "--init-method", init, "--num-processes", str(nproc),
                       "--process-id", str(rank), "--global-batch", str(global_batch),
                       "--qp-iters", str(qp_iters), "--ticks", str(ticks),
                       "--repeats", str(repeats), "--chain", str(chain),
                       "--device", dev.type, "--out", outs[rank]]
                procs.append(subprocess.Popen(cmd, env=env, cwd=REPO_ROOT, stdout=logs[rank],
                                              stderr=subprocess.STDOUT, text=True))
            failed = []
            for rank, proc in enumerate(procs):
                try:
                    proc.wait(timeout=timeout)
                except subprocess.TimeoutExpired:
                    failed.append((rank, f"timed out after {timeout} s"))
                    break
                if proc.returncode != 0:
                    failed.append((rank, f"exited {proc.returncode}"))
            if failed:
                rank, what = failed[0]
                logs[rank].seek(0)
                raise RuntimeError(f"mp_worker {rank} {what}:\n{logs[rank].read()[-4000:]}")
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            for f in logs:
                f.close()
        results = []
        for out in outs:
            with np.load(out) as z:
                results.append({k: z[k] for k in z.files})
    return results


def summary(results: list[dict]) -> dict:
    """The run in one JSON-ready dict: backend, global sums, each rank's
    launches and, when timed, the step's solves/s."""
    r0 = results[0]
    out = {"processes": len(results), "backend": str(r0["backend"]),
           "device_kind": str(r0["device_kind"]), "global_n": float(r0["n"]),
           "kkt_sum": float(r0["kkt_sum"]), "cost_sum": float(r0["cost_sum"]),
           "launches": [{k[len("launches_"):]: int(v) for k, v in r.items()
                         if k.startswith("launches_") and int(v)} for r in results]}
    if "solves_per_sec" in r0:
        out["solves_per_sec"] = float(r0["solves_per_sec"])
        out["sec_per_step"] = float(r0["sec_per_step"])
    if "ep_n" in r0:
        out["ep_sq_err_sum"] = float(r0["ep_sq_err_sum"])
        out["ep_n"] = float(r0["ep_n"])
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--global-batch", type=int, default=1024)
    ap.add_argument("--qp-iters", type=int, default=12)
    ap.add_argument("--ticks", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--chain", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args(argv)
    res = launch_workers(a.nproc, a.global_batch, a.qp_iters, a.ticks, a.repeats, a.chain,
                         a.device)
    print(json.dumps(summary(res)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
