"""Training data from episode logs: the drag labels and the training points.

Counterpart of ``mpc_quad_ros_tpu/models/dataloader.py`` (``DataLoaderGP``):
load a logged run, rotate the world-frame velocities to the body frame,
label each tick with the drag acceleration y = (v_body[k+1] -
v_body_pred[k]) / dt[k], and pick n representative training points per axis
by a deterministic 1-D k-means (or, with ``method="gmm"``, the reference's
sklearn Gaussian mixture, imported only then).  numpy on the host, as in
the JAX package, with the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.rotations import q_to_rot_mat


def _to_body(v_world: np.ndarray, q: np.ndarray) -> np.ndarray:
    """R(q)^T v, batched (the port's rotation in float64)."""
    R = q_to_rot_mat(torch.as_tensor(q, dtype=torch.float64)).numpy()
    return np.einsum("nji,nj->ni", R, v_world)


class DataLoaderGP:
    def __init__(self, filepath_or_dict, number_of_training_samples: int = 10,
                 method: str = "kmeans"):
        if isinstance(filepath_or_dict, str):
            from ..io.logger import load_dict

            self.data_dict = load_dict(filepath_or_dict)
        else:
            self.data_dict = filepath_or_dict
        self.number_of_training_samples = number_of_training_samples
        self.method = method
        self.X, self.y = self.preprocess_data()
        self.X_train, self.y_train = self.cluster_data3D(self.X, self.y)

    # ------------------------------------------------------------------ #
    def preprocess_data(self):
        """(`DataLoaderGP.py:66-99`) X = v_body[k], y = (v_body[k+1] -
        v_body_pred[k]) / dt[k]."""
        d = self.data_dict
        x = np.stack(d["x_odom"], axis=0)
        xp = np.stack(d["x_pred_odom"], axis=0)
        t = np.asarray(d["t_odom"], dtype=float)

        self.v_body = _to_body(x[:, 7:10], x[:, 3:7])
        self.v_body_pred = _to_body(xp[:, 7:10], xp[:, 3:7])
        dt = np.diff(t)
        dt = np.where(dt <= 0, np.median(dt[dt > 0]) if (dt > 0).any() else 1.0, dt)

        y = (self.v_body[1:] - self.v_body_pred[:-1]) / dt[:, None]
        X = self.v_body[:-1]
        return X, y

    # ------------------------------------------------------------------ #
    def cluster_data1D(self, X: np.ndarray, y: np.ndarray):
        n = self.number_of_training_samples
        if self.method == "gmm":
            from sklearn.mixture import GaussianMixture
            import scipy.stats

            GMM = GaussianMixture(n_components=n, random_state=0, n_init=3,
                                  init_params="kmeans")
            GMM.fit(X)
            Xr, yr = [], []
            for i in range(GMM.n_components):
                dens = scipy.stats.multivariate_normal(
                    cov=GMM.covariances_[i], mean=GMM.means_[i]
                ).logpdf(X)
                idx = np.argmax(dens)
                Xr.append(X[idx])
                yr.append(y[idx])
            return np.asarray(Xr).ravel(), np.asarray(yr).ravel()

        # deterministic 1-D k-means: quantile init, Lloyd iterations, then the
        # sample closest to each centroid
        x = X.ravel()
        centers = np.quantile(x, np.linspace(0.02, 0.98, n))
        for _ in range(25):
            assign = np.argmin(np.abs(x[:, None] - centers[None, :]), axis=1)
            for c in range(n):
                m = assign == c
                if m.any():
                    centers[c] = x[m].mean()
        idx = np.argmin(np.abs(x[:, None] - centers[None, :]), axis=0)
        return x[idx], y.ravel()[idx]

    def cluster_data3D(self, X: np.ndarray, y: np.ndarray):
        """Per-axis representative selection (`DataLoaderGP.py:145-160`).
        Returns X_train, y_train of shape (n, 3)."""
        Xr, yr = [], []
        for ax in range(3):
            xs, ys = self.cluster_data1D(X[:, ax].reshape(-1, 1), y[:, ax].reshape(-1, 1))
            Xr.append(xs)
            yr.append(ys)
        return np.stack(Xr, axis=1), np.stack(yr, axis=1)

    # ------------------------------------------------------------------ #
    def plot(self, filepath=None, show=False):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        xyz = ["x", "y", "z"]
        fig = plt.figure(figsize=(10, 6), dpi=100)
        for col in range(3):
            plt.subplot(1, 3, col + 1)
            plt.scatter(self.X[:, col], self.y[:, col], s=0.5, label="samples")
            plt.scatter(self.X_train[:, col], self.y_train[:, col], marker="+", c="k",
                        label="training points")
            plt.xlabel(f"v_body {xyz[col]} [m/s]")
            plt.ylabel(f"drag accel {xyz[col]} [m/s2]")
            plt.legend(fontsize=7)
        plt.tight_layout()
        if filepath:
            plt.savefig(filepath, bbox_inches="tight")
        if show:
            plt.show()
        plt.close(fig)
