"""The control-sequence parity matrix over every recorded closed-loop run.

Counterpart of ``mpc_quad_ros_tpu/bench/parity_matrix.py``.  Every pickle in
the Gazebo and python-sim log directories (arguments; by default the JAX
package's directories inside the reference checkout given by
``--reference`` or ``$MPCQUAD_REFERENCE``) that carries ``x_odom``,
``w_odom``, ``x_ref`` and ``x_pred_odom`` gets a row:

- Gazebo (ROS node, 100 Hz odometry): n_nodes=5, skip=20, hummingbird
  parameters; the horizon is not logged, so N=10, skip=10 is replayed too
  and the better fit kept.  gp1 logs take the Gazebo GP model directory;
  gp2 logs feed their logged posterior (basis linspace(-v_max, v_max, 20)).
- python sim (10 Hz ticks): n_nodes=10, skip=1, the ``Quadrotor3D``
  default parameters of the vintage that reproduces the log's own one-step
  predictions (``infer_python_params``).

The drag mode is read from the name (``_gp0`` or ``nogp``, ``_gp1``,
``_gp2``), or, without a tag, from the log's own posterior keys (gp2).  A
log with neither gets the row "mode unknown" with its model parity and no
replay: replaying a GP-flown log without its model (the JAX matrix replays
``trajectory_using_gp.pkl`` as gp0) measures the mode, not the solver.  A
log whose own run diverged (|x| > 50 m, or a posterior above 100) is
replayed over its sane prefix only; where that prefix is shorter than the
replay floor (20 ticks) plus one horizon, the row says "prefix too short"
and nothing is replayed (the JAX matrix replays 20 ticks into the diverged
part).  A gp1 log without a model directory says "no gp models".

Outputs: ``PARITY.json`` and ``PARITY.md`` under the output directory.  With
no log directory present the matrix prints that it skipped, writes its
empty rows and exits 0.  The replays run on the card unless given
``device="cpu"`` (float64 there, float32 on the card).

    python -m mpc_quad_ros_tpu_torch.bench.parity_matrix [--reference DIR] [--gazebo DIR]
        [--pysim DIR] [--gp-models DIR] [--pysim-gp-models DIR] [--out DIR] [--quick] [--cpu]
"""

from __future__ import annotations

import glob
import json
import os
import pickle
import re

import numpy as np
import torch

from ..utils.device import resolve_device

# the log and model directories, relative to the reference checkout
GAZEBO = "outputs/gazebo_simulation/data"
PYSIM = "outputs/python_simulation/data"
GP_MODELS = "outputs/gazebo_simulation/gp_models"
PYSIM_GP_MODELS = "outputs/python_simulation/gp_models"
REQUIRED_KEYS = ("x_odom", "w_odom", "x_ref", "x_pred_odom")
REPLAY_FLOOR = 20           # the fewest ticks a replay is worth
DIVERGED_STATE = 50.0       # |x| [m, m/s] past which a run left the arena
DIVERGED_POSTERIOR = 100.0  # |mu_g| past which a gp2 run's posterior blew up


def _vmax_from_name(name: str) -> float:
    m = re.search(r"_v(?:_max)?(\d+(?:\.\d+)?)", name)
    return float(m.group(1)) if m else 10.0


def _sane_prefix(x_odom: np.ndarray, limit: float = DIVERGED_STATE) -> int:
    """Ticks before the run's own state diverged."""
    bad = np.where(np.abs(x_odom).max(axis=1) > limit)[0]
    return int(bad[0]) if bad.size else x_odom.shape[0]


def _load(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)


def pred_parity(log_path: str, dt: float, params: str, device="cuda") -> float:
    """max |x_pred_odom[k] - RK4_nominal(x_odom[k], clip(w_odom[k]), dt)|
    over the log's sane prefix, in float64: the model-parity oracle."""
    from ..models import make_mpc_dynamics
    from ..ops.sqp import MPCConfig, SQPSolver
    from .parity import preset_params

    dev = resolve_device(device)
    d = _load(log_path)
    X = np.array(d["x_odom"])
    W = np.clip(np.array(d["w_odom"]), 0, 1)
    XP = np.array(d["x_pred_odom"])
    n = _sane_prefix(X)
    kw = dict(dtype=torch.float64, device=dev)
    s = SQPSolver(MPCConfig(), make_mpc_dynamics(preset_params(params, torch.float64, dev)))
    pred = s.discrete_dynamics(torch.as_tensor(X[:n], **kw), torch.as_tensor(W[:n], **kw), dt)
    return float(np.abs(pred.cpu().numpy() - XP[:n]).max())


def infer_python_params(log_path: str, device="cuda") -> tuple[str, float]:
    """The ``Quadrotor3D`` default-parameter vintage ("default" or
    "default_v1") that reproduces the log's own one-step predictions, and
    that parity; machine precision tells them apart."""
    best = ("default", float("inf"))
    for preset in ("default", "default_v1"):
        e = pred_parity(log_path, 0.1, preset, device)
        if e < best[1]:
            best = (preset, e)
    return best


def _logs(directory: str | None) -> list[str]:
    """The closed-loop pickles of a directory: every ``*.pkl`` that carries
    REQUIRED_KEYS."""
    if not directory or not os.path.isdir(directory):
        return []
    out = []
    for path in sorted(glob.glob(os.path.join(directory, "*.pkl"))):
        try:
            d = _load(path)
        except Exception:   # not a log pickle
            continue
        if isinstance(d, dict) and all(k in d for k in REQUIRED_KEYS):
            out.append(path)
    return out


def _mode(name: str, d: dict) -> str:
    """gp0, gp1, gp2, or "unknown": from the name's tag, else gp2 where the
    log carries its posterior."""
    if "_gp0" in name or "nogp" in name:
        return "gp0"
    if "_gp1" in name:
        return "gp1"
    if "_gp2" in name or "rgp_mu_g_t" in d or "rgp_params" in d:
        return "gp2"
    return "unknown"


def _jobs(gazebo, pysim, gp_models, pysim_gp_models, device) -> list:
    """(env, name, mode, path, replay kwargs, prediction dt, parameters,
    flag) a log; a flagged log is not replayed."""
    jobs = []
    for env, directory in (("gazebo", gazebo), ("python", pysim)):
        models = gp_models if env == "gazebo" else pysim_gp_models
        for path in _logs(directory):
            name = os.path.basename(path)
            d = _load(path)
            mode = _mode(name, d)
            if env == "gazebo":
                kw, dt = dict(n_nodes=5, skip=20, drop_tail=150, params="hummingbird"), 0.01
            else:
                preset, _ = infer_python_params(path, device)
                kw, dt = dict(n_nodes=10, skip=1, drop_tail=15, params=preset), 0.1
            flag = None
            if mode == "gp1":
                if models and os.path.isdir(models):
                    kw["gp_path"] = models
                else:
                    flag = "no gp models"
            elif mode == "gp2":
                kw["rgp_from_log"] = True
                if "rgp_mu_g_t" not in d:
                    v = _vmax_from_name(name)
                    kw["rgp_basis"] = np.stack([np.linspace(-v, v, 20) for _ in range(3)])
            elif mode == "unknown":
                flag = "mode unknown"
            jobs.append((env, name, mode, path, kw, dt, kw["params"], flag))
    return jobs


def _sane_ticks(d: dict, rgp_from_log: bool) -> int:
    """Ticks before the run's state, or its logged posterior, diverged."""
    n = _sane_prefix(np.array(d["x_odom"]))
    if rgp_from_log and "rgp_mu_g_t" in d:
        mu = np.array(d["rgp_mu_g_t"])
        bad = np.where(np.abs(mu).reshape(mu.shape[0], -1).max(axis=1) > DIVERGED_POSTERIOR)[0]
        if bad.size:
            n = min(n, int(bad[0]))
    return n


def run_matrix(out_dir: str = "outputs/parity", quick: bool = False, gazebo: str | None = None,
               pysim: str | None = None, gp_models: str | None = None,
               pysim_gp_models: str | None = None, device="cuda",
               reference: str | None = None) -> dict:
    """Every log's row; writes PARITY.json and PARITY.md into `out_dir`.  A
    directory not given is the JAX package's inside the reference checkout
    (`reference`, else ``$MPCQUAD_REFERENCE``), or none without one."""
    from .parity import reference_path, replay_reference_log

    dev = resolve_device(device)
    gazebo = gazebo or reference_path(GAZEBO, reference)
    pysim = pysim or reference_path(PYSIM, reference)
    gp_models = gp_models or reference_path(GP_MODELS, reference)
    pysim_gp_models = pysim_gp_models or reference_path(PYSIM_GP_MODELS, reference)
    jobs = _jobs(gazebo, pysim, gp_models, pysim_gp_models, dev)
    if not jobs:
        print(f"parity_matrix: no closed-loop logs under {gazebo!r} or {pysim!r}; skipped",
              flush=True)
    if quick:
        jobs = jobs[:3]

    rows = []
    for env, name, mode, path, kw, dt, params, flag in jobs:
        d = _load(path)
        T = np.array(d["x_odom"]).shape[0]
        row = {"env": env, "log": name, "mode": mode, "params": params}
        if not flag:
            n_sane = _sane_ticks(d, kw.get("rgp_from_log", False))
            row["ref_run_diverged"] = n_sane < T
            # the gazebo horizon is not logged: replay N=5 and N=10
            configs = [kw] + ([dict(kw, n_nodes=10, skip=10)] if env == "gazebo" else [])
            if n_sane < T:
                # replay the sane prefix only, leaving room for the chunk
                fits = [c for c in configs
                        if n_sane - c["n_nodes"] * c["skip"] >= REPLAY_FLOOR]
                configs = [dict(c, drop_tail=T - (n_sane - c["n_nodes"] * c["skip"]))
                           for c in fits]
                if not configs:
                    flag = "prefix too short"
        if flag:
            row["flag"] = flag
        try:
            if not flag:
                best = best_kw = None
                for ckw in configs:
                    r = replay_reference_log(path, device=dev, **ckw)
                    if best is None or r["du_mean"] < best["du_mean"]:
                        best, best_kw = r, ckw
                row.update(ticks=len(best["u_ours"]), inferred_n_nodes=best_kw["n_nodes"],
                           **{k: v for k, v in best.items() if k.startswith("du_")})
            row["pred_parity_max"] = pred_parity(path, dt, params, dev)
        except Exception as e:   # a log the replay cannot read: its row says why
            row["error"] = f"{type(e).__name__}: {e}"
        rows.append(row)
        print(json.dumps(row), flush=True)

    os.makedirs(out_dir, exist_ok=True)
    out = {"rows": rows, "config": {
        "gazebo": "n_nodes=5 skip=20 (or 10/10, the better fit) sqp_iters=2 hummingbird",
        "python": "n_nodes=10 skip=1 sqp_iters=2 Quadrotor3D defaults (inferred vintage)",
        "dtype": "float32 on the card, float64 on the CPU", "device": str(dev),
        "gazebo_dir": gazebo, "pysim_dir": pysim}}
    with open(os.path.join(out_dir, "PARITY.json"), "w") as f:
        json.dump(out, f, indent=1)
    with open(os.path.join(out_dir, "PARITY.md"), "w") as f:
        f.write("\n".join(markdown(rows)) + "\n")
    return out


def markdown(rows: list) -> list[str]:
    """The rows as a markdown table."""
    lines = ["# Control-sequence parity matrix", "",
             "du values are |u_ours - u_logged| on the [0,1] scale; pred_parity is the",
             "model's one-step prediction against the log's own.", "",
             "| env | log | mode | ticks | N | du_mean | du_median | du_p95 | pred_parity | "
             "ref diverged | note |",
             "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        pp = f"{r['pred_parity_max']:.1e}" if "pred_parity_max" in r else ""
        div = "YES" if r.get("ref_run_diverged") else ""
        note = r.get("error") or r.get("flag") or ""
        if "du_mean" in r:
            lines.append(f"| {r['env']} | {r['log']} | {r['mode']} | {r['ticks']} | "
                         f"{r['inferred_n_nodes']} | {r['du_mean']:.2e} | {r['du_median']:.2e} | "
                         f"{r['du_p95']:.2e} | {pp} | {div} | {note} |")
        else:
            lines.append(f"| {r['env']} | {r['log']} | {r['mode']} | — | — | — | — | — | "
                         f"{pp} | {div} | {note} |")
    return lines


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reference", default=None,
                    help="the reference project's checkout (default $MPCQUAD_REFERENCE)")
    ap.add_argument("--gazebo", default=None, help=f"default: the checkout's {GAZEBO}")
    ap.add_argument("--pysim", default=None, help=f"default: the checkout's {PYSIM}")
    ap.add_argument("--gp-models", default=None, help=f"default: the checkout's {GP_MODELS}")
    ap.add_argument("--pysim-gp-models", default=None,
                    help=f"default: the checkout's {PYSIM_GP_MODELS}")
    ap.add_argument("--out", default="outputs/parity")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="replay on the CPU in float64")
    a = ap.parse_args(argv)
    run_matrix(a.out, a.quick, a.gazebo, a.pysim, a.gp_models, a.pysim_gp_models,
               "cpu" if a.cpu else "cuda", a.reference)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
