"""Offline GP / RGP training from an episode log.

Counterpart of ``mpc_quad_ros_tpu/models/train.py``:

- ``train_gp``: log -> ``DataLoaderGP`` -> 3 per-axis exact GPs, each fitted
  by ``gp_fit`` -> the ensemble saved as ``mdl_{x,y,z}.gp``;
- ``train_rgp``: every sample of the log streamed through ``rgp_regress``
  (a loop over time, the 3 axes at once) from linspaced basis vectors ->
  ``mdl_{x,y,z}.rgp``.

Both run on the card in float64 unless given ``device="cpu"``; with `plot`
they also write diagnostic plots (matplotlib, imported only then).

    python -m mpc_quad_ros_tpu_torch.models.train gp --data LOG.pkl --save_dir DIR [--cpu] [--no_plot]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..utils.containers import stack_records
from ..utils.device import resolve_device
from .dataloader import DataLoaderGP
from .ensemble import GPEnsemble
from .gp import gp_fit
from .rgp import rgp_regress


def train_gp(dataset_path: str, save_dir: str, n_training_samples: int = 10,
             theta0=(1.0, 1.0, 1.0), plot: bool = True, device="cuda") -> GPEnsemble:
    dev = resolve_device(device)
    dl = DataLoaderGP(dataset_path, n_training_samples)
    ten = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
    states = [gp_fit(ten(dl.X_train[:, d]), ten(dl.y_train[:, d]), theta0) for d in range(3)]
    gpe = GPEnsemble(stack_records(states), "GP")
    gpe.save(save_dir)
    if plot:
        dl.plot(os.path.join(save_dir, "training_data.pdf"))
        _plot_ensemble_fit(gpe, dl, os.path.join(save_dir, "gp_fit.pdf"))
    return gpe


def train_rgp(dataset_path: str, save_dir: str, n_basis: int = 20, theta=(1.0, 0.1, 0.1),
              plot: bool = True, device="cuda") -> GPEnsemble:
    dl = DataLoaderGP(dataset_path, n_basis)
    v_abs = np.abs(dl.X).max()
    gpe = GPEnsemble.fromrange([(-v_abs, v_abs)] * 3, n_basis, theta=theta,
                               dtype=torch.float64, device=device)
    X = torch.as_tensor(dl.X.T, device=gpe.state.X.device)     # (3, T)
    y = torch.as_tensor(dl.y.T, device=gpe.state.X.device)
    state = gpe.state
    for k in range(X.shape[1]):
        state = rgp_regress(state, X[:, k, None], y[:, k, None])
    gpe.state = state
    gpe.save(save_dir)
    if plot:
        dl.plot(os.path.join(save_dir, "training_data.pdf"))
        _plot_ensemble_fit(gpe, dl, os.path.join(save_dir, "rgp_fit.pdf"))
    return gpe


def _plot_ensemble_fit(gpe: GPEnsemble, dl: DataLoaderGP, path: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    xyz = ["x", "y", "z"]
    fig = plt.figure(figsize=(10, 6), dpi=100)
    for d in range(3):
        plt.subplot(1, 3, d + 1)
        xs = np.linspace(dl.X[:, d].min(), dl.X[:, d].max(), 100)
        mu = gpe.predict(np.tile(xs, (3, 1)))[d].cpu().numpy()
        plt.scatter(dl.X[:, d], dl.y[:, d], s=0.5, alpha=0.4, label="samples")
        plt.plot(xs, mu, "r", label="posterior mean")
        plt.xlabel(f"v_body {xyz[d]} [m/s]")
        plt.legend(fontsize=7)
    plt.tight_layout()
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("mode", choices=("gp", "rgp"))
    parser.add_argument("--data", required=True, help="episode log pickle")
    parser.add_argument("--save_dir", required=True)
    parser.add_argument("-n", type=int, default=10, help="training points / basis vectors")
    parser.add_argument("--cpu", action="store_true",
                        help="train on the CPU (the default is the card)")
    parser.add_argument("--no_plot", action="store_true", help="write no plots (no matplotlib)")
    args = parser.parse_args(argv)
    train = train_gp if args.mode == "gp" else train_rgp
    train(args.data, args.save_dir, args.n, plot=not args.no_plot,
          device="cpu" if args.cpu else "cuda")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
