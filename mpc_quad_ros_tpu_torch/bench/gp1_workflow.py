"""The gp1 workflow: learn a drag GP from a logged flight, then fly it.

The reference paper's pretrained model (gp1), made as its users make it:

1. ``training_flight``: the closed-loop scenario (``closed_loop.setup``: the
   accelerating 10 m circle at 8 m/s, per-episode randomised drag) flown
   with the nominal model (gp0) through the fused loop; episode 0's outputs
   logged with the tick times (``Logger.from_episode``) and pickled;
2. ``fit``: ``train_gp`` on that log (``DataLoaderGP``: N_TRAIN points an
   axis; ``gp_fit`` in float64 on the device), the model files written and
   read back (``GPEnsemble.fromdir``);
3. the fitted GP flown through the closed loops (``closed_loop(drag=...)``);
4. ``offline_rgp``: ``train_rgp`` (N_BASIS_RGP basis vectors) on the same
   log, then LEARN_SAMPLES samples of ``rgp_learn`` on the 3-axis ensemble,
   on the device and on the CPU, both in float64.

Entry points run on the card unless given ``device="cpu"``.

    python -m mpc_quad_ros_tpu_torch.bench.gp1_workflow
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from ..io.logger import Logger
from ..models.dataloader import DataLoaderGP
from ..models.ensemble import GPEnsemble
from ..models.rgp import rgp_learn, rgp_learn_init
from ..models.train import train_gp, train_rgp
from ..ops.sqp import MPCConfig
from ..utils.device import resolve_device
from .closed_loop import closed_loop

N_TRAIN = 10          # training points an axis (the reference's gp_train default)
N_BASIS_RGP = 20      # basis vectors an axis of the offline RGP
LEARN_SAMPLES = 50


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest difference over the largest entry of b."""
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(torch.finfo(torch.float64).tiny))


def training_flight(B: int, out_dir: str, device="cuda", t_max: float = 10.0,
                    outputs: bool = False) -> tuple:
    """The gp0 flight of B episodes; episode 0 logged to out_dir: (the
    flight's closed-loop summary, the log's path), and with `outputs` the
    flight's ``EpisodeOutput`` after them."""
    dev = resolve_device(device)
    summary, outs = closed_loop(B=B, v=8.0, t_max=t_max, device=dev, drag=None, outputs=True)
    ep0 = outs.map(lambda a: a[0])
    t_odom = torch.arange(ep0.x_odom.shape[0], dtype=torch.float64) * MPCConfig().dt
    path = Logger.from_episode(ep0, t_odom=t_odom).save_log(os.path.join(out_dir, "gp0_flight.pkl"))
    return (summary, path, outs) if outputs else (summary, path)


def fit(log_path: str, save_dir: str, device="cuda", n: int = N_TRAIN) -> tuple[GPEnsemble, dict]:
    """``train_gp`` on the log (timed on the host clock, to a synchronise),
    then the saved files read back: (the ensemble, a summary with the
    fitted thetas and whether the reloaded state is the fitted one
    bitwise)."""
    dev = resolve_device(device)
    dl = DataLoaderGP(log_path, n)
    t0 = time.perf_counter()
    gpe = train_gp(log_path, save_dir, n, plot=False, device=dev)
    _sync(dev)
    fit_s = time.perf_counter() - t0
    back = GPEnsemble.fromdir(save_dir, "GP", device=dev)
    same = all(torch.equal(getattr(back.state, k), v) for k, v in gpe.state.fields().items())
    alpha = gpe.state.alpha
    return gpe, {"samples": int(dl.X.shape[0]), "n_train": n,
                 "label_abs_max": float(np.abs(dl.y).max()), "fit_s": fit_s,
                 "theta": [[float(v) for v in row] for row in gpe.get_theta()],
                 "alpha_abs_max": float(alpha.abs().max()), "reloaded_bitwise": same}


def offline_rgp(log_path: str, save_dir: str, device="cuda", n_basis: int = N_BASIS_RGP,
                samples: int = LEARN_SAMPLES) -> dict:
    """``train_rgp`` on the log, then `samples` samples of the log through
    ``rgp_learn`` from the trained ensemble, on the device and on the CPU
    (float64 both): their wall times, whether every value is finite, and
    the device's largest difference from the CPU's relative to the largest
    entry."""
    dev = resolve_device(device)
    dl = DataLoaderGP(log_path, n_basis)
    runs = {}
    for name, d in (("device", dev), ("cpu", torch.device("cpu"))):
        t0 = time.perf_counter()
        gpe = train_rgp(log_path, os.path.join(save_dir, f"rgp_{name}"), n_basis, plot=False,
                        device=d)
        _sync(d)
        t1 = time.perf_counter()
        X = torch.as_tensor(dl.X[:samples].T, device=d)[..., None]     # (3, S, 1)
        y = torch.as_tensor(dl.y[:samples].T, device=d)[..., None]
        ls = rgp_learn_init(gpe.state)
        for k in range(X.shape[1]):
            ls = rgp_learn(ls, X[:, k], y[:, k])
        _sync(d)
        runs[name] = (gpe.state, ls, t1 - t0, time.perf_counter() - t1)
    (st, ls, train_s, learn_s), (st_c, ls_c, train_c, learn_c) = runs["device"], runs["cpu"]
    finite = all(bool(torch.isfinite(a).all()) for a in
                 (st.mu_g, st.C_g, ls.base.mu_g, ls.base.C_g, ls.mu_eta, ls.C_eta))
    return {"n_basis": n_basis, "stream_samples": int(dl.X.shape[0]), "learn_samples": samples,
            "train_rgp_s": train_s, "train_rgp_cpu_s": train_c,
            "rgp_learn_s": learn_s, "rgp_learn_cpu_s": learn_c, "finite": finite,
            "train_rgp_rel_vs_cpu": max(rel(getattr(st, k), getattr(st_c, k)) for k in ("mu_g", "C_g")),
            "rgp_learn_rel_vs_cpu": max(
                rel(ls.base.mu_g, ls_c.base.mu_g), rel(ls.base.C_g, ls_c.base.C_g),
                rel(ls.mu_eta, ls_c.mu_eta), rel(ls.C_eta, ls_c.C_eta)),
            "theta_learned": [[float(v) for v in row] for row in ls.mu_eta.cpu()]}


def main() -> int:
    """The whole workflow on the card, written under build/gp1_workflow:
    JSON lines."""
    out = os.path.join("build", "gp1_workflow")
    os.makedirs(out, exist_ok=True)
    gp0, log_path = training_flight(16384, out)
    print(json.dumps({"phase": "training_flight", **gp0}), flush=True)
    gpe, fitted = fit(log_path, os.path.join(out, "gp1"))
    print(json.dumps({"phase": "fit", **fitted}), flush=True)
    gp1 = closed_loop(B=16384, drag=gpe.state)
    print(json.dumps({"phase": "gp1_closed_loop", **gp1}), flush=True)
    print(json.dumps({"phase": "offline_rgp", **offline_rgp(log_path, out)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
