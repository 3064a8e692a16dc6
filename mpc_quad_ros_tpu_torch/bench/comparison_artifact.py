"""The reference's headline A/B deliverables as artifacts.

Counterpart of ``mpc_quad_ros_tpu/bench/comparison_artifact.py``:

1. ``compare.run_matrix_batched`` on the reference's own run matrix
   (``config/comparisson_config.json``: gpe 1 against gpe 0 on the circle
   at v_max 10, 15, 20) -> the mean-RMSE-against-peak-velocity scatter and
   a JSON of the rows.  It reads the reference checkout (``--reference`` or
   ``$MPCQUAD_REFERENCE``: the JSON and the python-sim GP models): without
   them this part is skipped.
2. The paper's covariance-reduction table: cov(v_axis, e_axis) on the
   accelerating circle for gp0 against the online RGP (gp2) at v_peak 3, 6,
   9, 12 (``covariance_table``, which needs no reference data), beside the
   reference's measured ``src/covariance_data.csv`` where that file exists.

The flights run on the card unless given ``device="cpu"`` (float64 there,
float32 on the card).  Outputs under the output directory:
``COMPARISON.json``, ``COVARIANCE.md``, ``NOTE.md`` and, with the reference,
``rmse_vs_vmax.png``.

    python -m mpc_quad_ros_tpu_torch.bench.comparison_artifact [--out DIR] [--reference DIR]
        [--ref-config JSON] [--ref-cov-csv CSV] [--gp-dir DIR] [--cpu]
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..utils.device import resolve_device

# the reference checkout's files, relative to it
REF_CONFIG = "config/comparisson_config.json"
REF_COV_CSV = "src/covariance_data.csv"
GP_DIR = "outputs/python_simulation/gp_models"


def covariance_table(v_peaks=(3.0, 6.0, 9.0, 12.0), t_max: float = 12.0, device="cuda",
                     dtype=None) -> list:
    """gp0-against-gp2 velocity/error covariance on the accelerating 10 m
    circle (one hummingbird, ``run_episode``, `t_max` seconds), per v_peak:
    the JAX ``comparison_artifact.covariance_table``'s computation."""
    from ..io.logger import Logger
    from ..io.viz import Visualiser
    from ..loop import EpisodeConfig, run_episode
    from ..models import GPEnsemble, hummingbird_params, make_mpc_dynamics
    from ..ops.sqp import MPCConfig, SQPSolver
    from ..traj import circle_trajectory_accelerating, states_from_flat_outputs

    dev = resolve_device(device)
    if dtype is None:
        dtype = torch.float32 if dev.type == "cuda" else torch.float64
    kw = dict(dtype=dtype, device=dev)
    rows = []
    for v in v_peaks:
        covs = {}
        for mode in (0, 2):
            p = hummingbird_params(**kw)
            cfg = EpisodeConfig(mpc=MPCConfig(u_ref=float(p.hover_input)))
            _, pos, vel, _ = circle_trajectory_accelerating(10.0, v, t_max=t_max, dt=cfg.mpc.dt)
            x_traj = torch.as_tensor(states_from_flat_outputs(np.asarray(pos), np.asarray(vel)),
                                     **kw)
            x0 = torch.tensor([0, 0, 3, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0], **kw)
            solver = SQPSolver(cfg.mpc, make_mpc_dynamics(p))
            rgp0 = None
            if mode == 2:
                rgp0 = GPEnsemble.fromrange([(-v, v)] * 3, 10, theta=(3.0, 0.1, 0.01),
                                            dtype=dtype, device=dev).state
            _, outs = run_episode(cfg, solver, p, x0, x_traj, x_traj.shape[0], rgp0=rgp0)
            viz = Visualiser.from_logger(Logger.from_episode(outs))
            covs[mode] = np.asarray(viz.velocity_error_covariance())
        rows.append({"v_peak": v, "gp0": covs[0][:3].tolist(), "gp2": covs[2][:3].tolist()})
    return rows


def read_reference_covariances(path: str) -> list:
    """The reference's ``covariance_data.csv`` rows; [] without the file."""
    if not path or not os.path.exists(path):
        return []
    rows = []
    with open(path) as f:
        next(f)
        for line in f:
            _, vp, gp, cx, cy, cz = [s.strip() for s in line.split(",")]
            rows.append({"v_peak": float(vp), "gp": int(gp),
                         "c": [float(cx), float(cy), float(cz)]})
    return rows


def covariance_markdown(cov_rows: list, ref_rows: list) -> list[str]:
    lines = ["# Covariance-reduction table", "",
             "cov(v_axis, error_axis) on the accelerating circle, gp0 (nominal MPC)",
             "against gp2 (online RGP); the reference's measured values where its",
             "`src/covariance_data.csv` was given.  The paper's claim: the magnitude",
             "shrinks when the RGP learns the drag online.", "",
             "| v_peak | ours gp0 (c_x, c_y) | ours gp2 (c_x, c_y) | ours reduction | "
             "ref gp0 c_x | ref gp2 c_x | ref reduction |",
             "|---|---|---|---|---|---|---|"]
    for r in cov_rows:
        ref = {x["gp"]: x["c"][0] for x in ref_rows if x["v_peak"] == r["v_peak"]}
        red = abs(r["gp0"][0]) / max(abs(r["gp2"][0]), 1e-9)
        rref = (abs(ref[0]) / max(abs(ref[2]), 1e-9)) if 0 in ref and 2 in ref else float("nan")
        lines.append(
            f"| {r['v_peak']:g} | ({r['gp0'][0]:.4f}, {r['gp0'][1]:.4f}) | "
            f"({r['gp2'][0]:.4f}, {r['gp2'][1]:.4f}) | {red:.1f}x | "
            f"{ref.get(0, float('nan')):.4f} | {ref.get(2, float('nan')):.4f} | {rref:.1f}x |")
    return lines


def main(out_dir: str = "outputs/comparison", ref_config: str | None = None,
         ref_cov_csv: str | None = None, gp_dir: str | None = None, device="cuda",
         v_peaks=(3.0, 6.0, 9.0, 12.0), t_max: float = 12.0, reference: str | None = None) -> dict:
    """The artifacts; a file not given is the reference checkout's
    (`reference`, else ``$MPCQUAD_REFERENCE``), or none without one."""
    from ..compare import plot_results, run_matrix_batched
    from .parity import reference_path

    ref_config = ref_config or reference_path(REF_CONFIG, reference)
    ref_cov_csv = ref_cov_csv or reference_path(REF_COV_CSV, reference)
    gp_dir = gp_dir or reference_path(GP_DIR, reference)
    os.makedirs(out_dir, exist_ok=True)
    results = []
    if ref_config and os.path.exists(ref_config):
        results = run_matrix_batched(ref_config, out_dir, gp_path=gp_dir if gp_dir and
                                     os.path.isdir(gp_dir) else None, device=device)
        plot_results(results, save_path=os.path.join(out_dir, "rmse_vs_vmax.png"))
    else:
        print(f"comparison_artifact: no run matrix at {ref_config!r}; the RMSE scatter is "
              "skipped", flush=True)
    cov_rows = covariance_table(v_peaks, t_max, device)
    ref_rows = read_reference_covariances(ref_cov_csv)
    if not ref_rows:
        print(f"comparison_artifact: no {ref_cov_csv!r}; the table has no reference column",
              flush=True)
    out = {"rmse_matrix": results, "covariance_ours": cov_rows, "covariance_reference": ref_rows}
    with open(os.path.join(out_dir, "COMPARISON.json"), "w") as f:
        json.dump(out, f, indent=1)
    with open(os.path.join(out_dir, "COVARIANCE.md"), "w") as f:
        f.write("\n".join(covariance_markdown(cov_rows, ref_rows)) + "\n")

    note = ["# Reference headline A/B", ""]
    if results:
        note += ["`compare.run_matrix_batched` on the reference's run matrix (gpe 1, the",
                 "pretrained GP, against gpe 0 on the circle), one fused batch a mode.", ""]
        for r0 in sorted((r for r in results if r["gpe"] == 0), key=lambda r: r["v_max"]):
            r1 = next((r for r in results if r["gpe"] == 1 and r["v_max"] == r0["v_max"]), None)
            if r1 and np.isfinite(r1["mean_rmse_pos"]):
                note.append(f"- v_max={r0['v_max']:g}: nominal RMSE {r0['mean_rmse_pos']:.3f} m "
                            f"-> GP-augmented {r1['mean_rmse_pos']:.3f} m")
            elif r1:
                note.append(f"- v_max={r0['v_max']:g}: nominal RMSE {r0['mean_rmse_pos']:.3f} m;"
                            " GP-augmented diverged")
    else:
        note.append("The RMSE matrix was skipped: no reference run matrix.")
    note += ["", "Covariance-reduction table: `COVARIANCE.md`."]
    with open(os.path.join(out_dir, "NOTE.md"), "w") as f:
        f.write("\n".join(note) + "\n")
    print("comparison artifacts written to", out_dir, flush=True)
    return out


def cli(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="outputs/comparison")
    ap.add_argument("--reference", default=None,
                    help="the reference project's checkout (default $MPCQUAD_REFERENCE)")
    ap.add_argument("--ref-config", default=None, help=f"default: the checkout's {REF_CONFIG}")
    ap.add_argument("--ref-cov-csv", default=None, help=f"default: the checkout's {REF_COV_CSV}")
    ap.add_argument("--gp-dir", default=None, help=f"default: the checkout's {GP_DIR}")
    ap.add_argument("--cpu", action="store_true")
    a = ap.parse_args(argv)
    main(a.out, a.ref_config, a.ref_cov_csv, a.gp_dir, "cpu" if a.cpu else "cuda",
         reference=a.reference)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
