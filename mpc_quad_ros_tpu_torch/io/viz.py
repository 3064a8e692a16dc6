"""Post-hoc analysis and figures of episode logs, and the in-flight view.

Counterpart of ``mpc_quad_ros_tpu/io/viz.py``.  The metric half of
``Visualiser`` (``rms_errors`` and ``velocity_error_covariance``, the
paper's learning metric) is numpy on the host; the figures are the JAX
package's: the 12-panel tracking report (``plot_data``), the 3D path and its
animation, the RGP posterior's evolution and its animations, the covariance
comparison across runs, and ``LiveFlightView`` (the in-flight view fed by
``node.ControllerNode(live_callback=...)``).

matplotlib is imported at the first figure, on the Agg backend, never when
the module is imported: the metric half, and ``node.py``, work where it is
not installed.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def _pyplot():
    """matplotlib.pyplot on the Agg backend, imported at first use."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _ragged(v) -> bool:
    """Whether v has no rectangular numpy form."""
    try:
        return np.asarray(v).dtype == object
    except ValueError:
        return True


class Visualiser:
    def __init__(self, data: dict):
        """data: a log dict under the reference's keys (x_odom, x_ref, ...);
        rectangular values become numpy arrays, the rest stay as given."""
        self.d = {k: np.asarray(v) for k, v in data.items() if v is not None and not _ragged(v)}
        for k, v in data.items():
            if k not in self.d:
                self.d[k] = v

    @classmethod
    def from_logger(cls, logger) -> "Visualiser":
        return cls(logger.dictionary)

    @classmethod
    def from_file(cls, path: str) -> "Visualiser":
        from .logger import load_dict

        return cls(load_dict(path))

    def rms_errors(self) -> dict:
        """RMS position [mm], quaternion, velocity [mm/s] and body-rate
        tracking errors over the log."""
        e = self.d["x_odom"] - self.d["x_ref"]
        rms = lambda a: np.sqrt(np.mean(np.sum(a**2, axis=1)))
        return {"rms_pos_mm": 1e3 * rms(e[:, 0:3]), "rms_quat": rms(e[:, 3:7]),
                "rms_vel_mm_s": 1e3 * rms(e[:, 7:10]), "rms_rate": rms(e[:, 10:13])}

    def velocity_error_covariance(self) -> np.ndarray:
        """Per axis, cov(v_axis, position error_axis) over the log: the
        paper's learning metric (it shrinks as the drag is learned)."""
        x, r = self.d["x_odom"], self.d["x_ref"]
        return np.asarray([np.cov(np.stack([x[:, 7 + ax], x[:, ax] - r[:, ax]]))[0, 1]
                           for ax in range(3)])

    # ------------------------------------------------------------------ #
    def plot_data(self, save_path: Optional[str] = None, show: bool = False):
        """The 12-panel tracking report, the reference Visualiser's 3 x 4
        layout: position / orientation / velocity / angular velocity
        (each vs reference), per-axis position-, quaternion-, velocity- and
        rate-error panels with RMS totals in the titles, the
        velocity-vs-error covariance heatmap, error-vs-velocity scatter,
        control input, MPC solve time (variance-honest — see t_cpu_kind) and
        solution cost.  The reference overlays its rate-error plot onto the
        heatmap axis; here they get separate panels."""
        plt = _pyplot()
        d = self.d
        x, ref, u = d["x_odom"], d["x_ref"], d["w_odom"]
        t = d.get("t_odom")
        t = np.asarray(t) if t is not None else np.arange(x.shape[0])
        rms = self.rms_errors()

        e_pos = x[:, 0:3] - ref[:, 0:3]
        e_quat = x[:, 3:7] - ref[:, 3:7]
        e_vel = x[:, 7:10] - ref[:, 7:10]
        e_rate = x[:, 10:13] - ref[:, 10:13]
        _rms1 = lambda e: np.sqrt(np.mean(e**2, axis=1))
        rms_pos, rms_quat = _rms1(e_pos), _rms1(e_quat)
        rms_vel, rms_rate = _rms1(e_vel), _rms1(e_rate)
        v_norm = np.linalg.norm(x[:, 7:10], axis=1)
        v_ref_norm = np.linalg.norm(ref[:, 7:10], axis=1)

        fig, axes = plt.subplots(3, 4, figsize=(22, 12), dpi=100)
        labels = ["x", "y", "z"]

        # (0,*): tracked states vs reference
        for i in range(3):
            axes[0, 0].plot(t, x[:, i], label=labels[i], color=f"C{i}")
            axes[0, 0].plot(t, ref[:, i], "--", lw=0.8, color=f"C{i}")
            axes[0, 2].plot(t, x[:, 7 + i], label=f"v{labels[i]}", color=f"C{i}")
            axes[0, 2].plot(t, ref[:, 7 + i], "--", lw=0.8, color=f"C{i}")
            axes[0, 3].plot(t, x[:, 10 + i], label=f"w{labels[i]}", color=f"C{i}")
            axes[0, 3].plot(t, ref[:, 10 + i], "--", lw=0.8, color=f"C{i}")
        axes[0, 0].set_title("Position [m]")
        for q_i, lab in enumerate(["qw", "qx", "qy", "qz"]):
            axes[0, 1].plot(t, x[:, 3 + q_i], label=lab, color=f"C{q_i}")
            axes[0, 1].plot(t, ref[:, 3 + q_i], "--", lw=0.8, color=f"C{q_i}")
        axes[0, 1].set_title("Orientation")
        axes[0, 2].plot(t, v_norm, label="|v|", color="C3")
        axes[0, 2].plot(t, v_ref_norm, "--", lw=0.8, color="C3")
        axes[0, 2].set_title("Velocity [m/s]")
        axes[0, 3].set_title("Angular velocity [rad/s]")

        # (1,*): error panels with RMS totals
        for i in range(3):
            axes[1, 0].plot(t, e_pos[:, i], label=f"e_{labels[i]}", color=f"C{i}")
            axes[1, 2].plot(t, e_vel[:, i], label=f"e_v{labels[i]}", color=f"C{i}")
            axes[1, 3].plot(t, e_rate[:, i], label=f"e_w{labels[i]}", color=f"C{i}")
        # title totals use the reference's convention (mean over axes, then
        # RMS over time), which is sqrt(3)
        # smaller than the sum-over-axes metric `rms_errors()` reports
        total_pos_mm = float(np.sqrt(np.mean(rms_pos**2))) * 1e3
        total_vel_mms = float(np.sqrt(np.mean(rms_vel**2))) * 1e3
        axes[1, 0].plot(t, rms_pos, label="rms", color="C3")
        axes[1, 0].set_title(f"RMS position error, total {total_pos_mm:.2f} mm")
        axes[1, 1].plot(t, rms_quat, label="rms", color="C0")
        axes[1, 1].set_title("RMS quaternion error")
        axes[1, 2].plot(t, rms_vel, label="rms", color="C3")
        axes[1, 2].set_title(
            f"RMS velocity error, total {total_vel_mms:.2f} mm/s")
        axes[1, 3].plot(t, rms_rate, label="rms", color="C3")
        axes[1, 3].set_title("RMS angular velocity error")

        # (2,0): covariance heatmap of velocity vs position error — the
        # reference's 8x8 df.cov() lower triangle
        feats = np.stack([x[:, 7], x[:, 8], x[:, 9], v_norm,
                          e_pos[:, 0], e_pos[:, 1], e_pos[:, 2], rms_pos])
        cov = np.cov(feats)
        # strict-upper triangle, like the reference's mask=triu(cov).T
        cov_masked = np.where(np.triu(np.ones_like(cov), k=1) > 0, cov, np.nan)
        names = ["v_x", "v_y", "v_z", "v_norm", "e_x", "e_y", "e_z", "rms_pos"]
        im = axes[2, 0].imshow(cov_masked, cmap="coolwarm")
        axes[2, 0].set_xticks(range(8), names, rotation=45, fontsize=6)
        axes[2, 0].set_yticks(range(8), names, fontsize=6)
        fig.colorbar(im, ax=axes[2, 0], fraction=0.046)
        axes[2, 0].set_title("Covariance matrix")
        axes[2, 0].grid(False)

        # (2,1): per-axis error vs per-axis velocity, covariance in the
        # legend
        for i in range(3):
            c = float(np.cov(np.stack([x[:, 7 + i], e_pos[:, i]]))[0, 1])
            axes[2, 1].scatter(x[:, 7 + i], e_pos[:, i], s=3, alpha=0.5,
                               color=f"C{i}", label=f"{labels[i]}: {c:.4f}")
        axes[2, 1].scatter(v_norm, rms_pos, s=3, alpha=0.5, color="C3",
                           label="rms vs |v|")
        axes[2, 1].set_xlabel("velocity [m/s]")
        axes[2, 1].set_title("Position error vs velocity")

        # (2,2): control input
        for u_i in range(4):
            axes[2, 2].plot(t, u[:, u_i], label=f"u{u_i + 1}", color=f"C{u_i}")
        axes[2, 2].set_ylim(-0.05, 1.05)
        axes[2, 2].set_title("Control input")

        # (2,3): split between solve time and cost;
        # solve time only when honest per-tick or clearly-labeled constant
        if "cost_solution" in d:
            axes[2, 3].plot(t, d["cost_solution"], color="C0")
            axes[2, 3].set_title("Solution cost")
            axes[2, 3].set_yscale("log")
        if "t_cpu" in d:
            tc = np.asarray(d["t_cpu"]) * 1e3
            kind = d.get("t_cpu_kind")
            if kind is not None:
                flat = np.asarray(kind).ravel()
                kind = str(flat[0]) if flat.size else None
            ax2 = axes[2, 3].twinx()
            if kind in ("amortized_episode_wall", "chained_device_latency"):
                # one measured number, NOT per-tick samples — render the
                # level only, no fake variance (reference logs and the node
                # path carry true per-tick times and take the else branch)
                ax2.axhline(float(np.mean(tc)), color="C1", lw=0.8)
                label = ("amortized episode wall/tick"
                         if kind == "amortized_episode_wall"
                         else "chained device latency")
                ax2.set_ylabel(f"solve {np.mean(tc):.3f} ms ({label})",
                               fontsize=6)
            else:
                ax2.plot(t, tc, color="C1", lw=0.6)
                ax2.set_ylabel(
                    f"solve [ms] avg {np.mean(tc):.3f} std {np.std(tc):.3f}",
                    fontsize=6)

        for ax in axes.ravel():
            if ax is not axes[2, 0]:
                ax.grid(True, alpha=0.3)
                ax.legend(fontsize=6, loc="upper right")
        fig.tight_layout()
        return _finish(fig, save_path, show)

    # ------------------------------------------------------------------ #
    def plot_3d(self, save_path: Optional[str] = None, show: bool = False):
        """3D flight path vs reference."""
        plt = _pyplot()
        x, ref = self.d["x_odom"], self.d["x_ref"]
        fig = plt.figure(figsize=(8, 8), dpi=100)
        ax = fig.add_subplot(projection="3d")
        ax.plot(x[:, 0], x[:, 1], x[:, 2], label="flown")
        ax.plot(ref[:, 0], ref[:, 1], ref[:, 2], "--", label="reference")
        ax.scatter(*x[0, :3], c="g", marker="o", label="start")
        ax.scatter(*x[-1, :3], c="r", marker="x", label="end")
        ax.set_xlabel("x [m]"), ax.set_ylabel("y [m]"), ax.set_zlabel("z [m]")
        ax.legend()
        return _finish(fig, save_path, show)

    def create_animation(self, save_path: str, fps: int = 20, stride: int = 5):
        """3D flight animation, saved as gif/mp4."""
        plt = _pyplot()
        from matplotlib import animation

        x, ref = self.d["x_odom"], self.d["x_ref"]
        fig = plt.figure(figsize=(6, 6), dpi=80)
        ax = fig.add_subplot(projection="3d")
        ax.plot(ref[:, 0], ref[:, 1], ref[:, 2], "--", lw=0.8, label="reference")
        (line,) = ax.plot([], [], [], label="flown")
        (dot,) = ax.plot([], [], [], "ro")
        for setter, col in ((ax.set_xlim, 0), (ax.set_ylim, 1), (ax.set_zlim, 2)):
            lo, hi = ref[:, col].min(), ref[:, col].max()
            pad = 0.1 * max(hi - lo, 1.0)
            setter(lo - pad, hi + pad)
        frames = range(1, x.shape[0], stride)

        def update(k):
            line.set_data(x[:k, 0], x[:k, 1])
            line.set_3d_properties(x[:k, 2])
            dot.set_data([x[k - 1, 0]], [x[k - 1, 1]])
            dot.set_3d_properties([x[k - 1, 2]])
            return line, dot

        anim = animation.FuncAnimation(fig, update, frames=frames, blit=False)
        anim.save(save_path, writer=animation.PillowWriter(fps=fps))
        plt.close(fig)
        return save_path

    # ------------------------------------------------------------------ #
    def _basis_per_axis(self):
        """(3, nb) basis-vector locations or None.  Handles both our stacked
        array logs and the reference's per-tick list-of-3-axis format (the
        basis is constant in regress mode; the first tick's is used)."""
        bv = self.d.get("rgp_basis_vectors")
        if bv is None:
            return None
        bv = np.asarray(bv)
        return bv[0] if bv.ndim == 3 else bv            # (T,3,nb) -> (3,nb)

    def _posterior_sigma(self):
        """(T, 3, nb) per-basis-vector posterior std from the logged C_g_t,
        or None when the covariance was not logged."""
        cg = self.d.get("rgp_C_g_t")
        if cg is None:
            return None
        cg = np.asarray(cg)                             # (T, 3, nb, nb)
        var = np.diagonal(cg, axis1=-2, axis2=-1)
        return np.sqrt(np.clip(var, 0.0, None))

    def plot_rgp_evolution(self, save_path: Optional[str] = None, show: bool = False,
                           ticks: Optional[list] = None):
        """Posterior mean at the basis vectors over selected ticks, plus the
        visited (v_body, a_drag) samples: the RGP-learning figure."""
        plt = _pyplot()
        mu = np.asarray(self.d["rgp_mu_g_t"])           # (T, 3, nb)
        vb = np.asarray(self.d["v_body"])               # (T, 3)
        ad = np.asarray(self.d["a_drag"])               # (T, 3)
        T, _, nb = mu.shape
        if ticks is None:
            ticks = [0, T // 4, T // 2, 3 * T // 4, T - 1]
        xyz = ["x", "y", "z"]
        fig, axes = plt.subplots(1, 3, figsize=(15, 4.5), dpi=100)
        basis = self._basis_per_axis()
        sig = self._posterior_sigma()                   # (T, 3, nb) | None
        for ax_i in range(3):
            a = axes[ax_i]
            a.scatter(vb[:, ax_i], ad[:, ax_i], s=2, alpha=0.3, label="samples")
            xb = (basis[ax_i] if basis is not None
                  else np.linspace(vb[:, ax_i].min() - 1, vb[:, ax_i].max() + 1, nb))
            for k in ticks:
                a.plot(xb, mu[k, ax_i], alpha=0.3 + 0.7 * k / max(T - 1, 1),
                       label=f"t={k}" if ax_i == 0 else None)
            if sig is not None:
                # +-2 sigma band around the first and final plotted posteriors
                for k, col in ((ticks[0], "C2"), (ticks[-1], "C1")):
                    a.fill_between(xb, mu[k, ax_i] - 2 * sig[k, ax_i],
                                   mu[k, ax_i] + 2 * sig[k, ax_i],
                                   alpha=0.15, color=col,
                                   label=f"±2σ t={k}" if ax_i == 0 else None)
            a.set_xlabel(f"v_body {xyz[ax_i]} [m/s]")
            a.set_ylabel(f"drag accel {xyz[ax_i]} [m/s2]")
            a.grid(alpha=0.3)
        axes[0].legend(fontsize=6)
        fig.suptitle("RGP posterior evolution")
        fig.tight_layout()
        return _finish(fig, save_path, show)

    def create_rgp_animation(self, save_path: str, fps: int = 10, stride: int = 10):
        """Animated RGP posterior evolution — the per-axis posterior mean at
        the basis vectors sweeping through time alongside the drag samples
        seen so far."""
        plt = _pyplot()
        from matplotlib import animation

        mu = np.asarray(self.d["rgp_mu_g_t"])           # (T, 3, nb)
        vb = np.asarray(self.d["v_body"])               # (T, 3)
        ad = np.asarray(self.d["a_drag"])               # (T, 3)
        basis = self._basis_per_axis()
        sig = self._posterior_sigma()                   # (T, 3, nb) | None
        T, _, nb = mu.shape
        xyz = ["x", "y", "z"]

        fig, axes = plt.subplots(1, 3, figsize=(13, 4), dpi=80)
        scats, lines, bands = [], [], [None, None, None]
        for ax_i, a in enumerate(axes):
            xb = (basis[ax_i] if basis is not None
                  else np.linspace(np.min(vb[:, ax_i]) - 1, np.max(vb[:, ax_i]) + 1, nb))
            a.set_xlim(xb.min() - 0.5, xb.max() + 0.5)
            lo, hi = min(ad[:, ax_i].min(), mu[:, ax_i].min()), max(ad[:, ax_i].max(), mu[:, ax_i].max())
            pad = 0.1 * max(hi - lo, 0.1)
            a.set_ylim(lo - pad, hi + pad)
            scats.append(a.scatter([], [], s=3, alpha=0.4))
            (ln,) = a.plot(xb, mu[0, ax_i], "C1.-")
            lines.append((ln, xb))
            a.set_xlabel(f"v_body {xyz[ax_i]} [m/s]")
            a.grid(alpha=0.3)
        title = fig.suptitle("RGP posterior, t=0")

        def update(k):
            for ax_i in range(3):
                scats[ax_i].set_offsets(np.stack([vb[:k + 1, ax_i], ad[:k + 1, ax_i]], axis=1))
                ln, xb = lines[ax_i]
                ln.set_data(xb, mu[k, ax_i])
                if sig is not None:
                    # redraw the ±2σ uncertainty band each frame
                    if bands[ax_i] is not None:
                        bands[ax_i].remove()
                    bands[ax_i] = axes[ax_i].fill_between(
                        xb, mu[k, ax_i] - 2 * sig[k, ax_i],
                        mu[k, ax_i] + 2 * sig[k, ax_i], alpha=0.2, color="C1")
            title.set_text(f"RGP posterior, t={k}")
            return scats + [ln for ln, _ in lines]

        anim = animation.FuncAnimation(fig, update, frames=range(0, T, stride), blit=False)
        anim.save(save_path, writer=animation.PillowWriter(fps=fps))
        plt.close(fig)
        return save_path

    def create_rgp_full_animation(self, save_path: str, fps: int = 10,
                                  stride: int = 10):
        """The combined flight and posterior animation: the 3D flight path
        and the three per-axis RGP posterior panels animate in ONE
        synchronized figure — left: flown trajectory growing against the
        reference with the current position marked; right column: per-axis
        posterior mean (+-2 sigma when the covariance was logged) sweeping
        through time over the drag samples seen so far."""
        plt = _pyplot()
        from matplotlib import animation
        from matplotlib.gridspec import GridSpec

        x, ref = self.d["x_odom"], self.d["x_ref"]
        mu = np.asarray(self.d["rgp_mu_g_t"])           # (T, 3, nb)
        vb = np.asarray(self.d["v_body"])               # (T, 3)
        ad = np.asarray(self.d["a_drag"])               # (T, 3)
        basis = self._basis_per_axis()
        sig = self._posterior_sigma()                   # (T, 3, nb) | None
        T, _, nb = mu.shape
        xyz = ["x", "y", "z"]

        fig = plt.figure(figsize=(13, 7.5), dpi=80)
        gs = GridSpec(3, 2, width_ratios=[1.6, 1.0], figure=fig)
        ax3 = fig.add_subplot(gs[:, 0], projection="3d")
        ax3.plot(ref[:, 0], ref[:, 1], ref[:, 2], "--", lw=0.8,
                 label="reference")
        (fl_line,) = ax3.plot([], [], [], label="flown")
        (fl_dot,) = ax3.plot([], [], [], "ro")
        for setter, col in ((ax3.set_xlim, 0), (ax3.set_ylim, 1),
                            (ax3.set_zlim, 2)):
            lo, hi = ref[:, col].min(), ref[:, col].max()
            pad = 0.1 * max(hi - lo, 1.0)
            setter(lo - pad, hi + pad)
        ax3.set_xlabel("x [m]"), ax3.set_ylabel("y [m]"), ax3.set_zlabel("z [m]")
        ax3.legend(fontsize=7)

        paxes, scats, lines, bands = [], [], [], [None, None, None]
        for ax_i in range(3):
            a = fig.add_subplot(gs[ax_i, 1])
            paxes.append(a)
            xb = (basis[ax_i] if basis is not None
                  else np.linspace(np.min(vb[:, ax_i]) - 1,
                                   np.max(vb[:, ax_i]) + 1, nb))
            a.set_xlim(xb.min() - 0.5, xb.max() + 0.5)
            lo = min(ad[:, ax_i].min(), mu[:, ax_i].min())
            hi = max(ad[:, ax_i].max(), mu[:, ax_i].max())
            pad = 0.1 * max(hi - lo, 0.1)
            a.set_ylim(lo - pad, hi + pad)
            scats.append(a.scatter([], [], s=3, alpha=0.4))
            (ln,) = a.plot(xb, mu[0, ax_i], "C1.-")
            lines.append((ln, xb))
            a.set_ylabel(f"a_drag {xyz[ax_i]}", fontsize=8)
            a.grid(alpha=0.3)
        paxes[-1].set_xlabel("v_body [m/s]")
        title = fig.suptitle("flight + RGP posterior, t=0")

        def update(k):
            fl_line.set_data(x[: k + 1, 0], x[: k + 1, 1])
            fl_line.set_3d_properties(x[: k + 1, 2])
            fl_dot.set_data([x[k, 0]], [x[k, 1]])
            fl_dot.set_3d_properties([x[k, 2]])
            for ax_i in range(3):
                scats[ax_i].set_offsets(
                    np.stack([vb[: k + 1, ax_i], ad[: k + 1, ax_i]], axis=1))
                ln, xb = lines[ax_i]
                ln.set_data(xb, mu[k, ax_i])
                if sig is not None:
                    if bands[ax_i] is not None:
                        bands[ax_i].remove()
                    bands[ax_i] = paxes[ax_i].fill_between(
                        xb, mu[k, ax_i] - 2 * sig[k, ax_i],
                        mu[k, ax_i] + 2 * sig[k, ax_i], alpha=0.2, color="C1")
            title.set_text(f"flight + RGP posterior, t={k}")
            return [fl_line, fl_dot] + scats + [ln for ln, _ in lines]

        anim = animation.FuncAnimation(fig, update, frames=range(0, T, stride),
                                       blit=False)
        anim.save(save_path, writer=animation.PillowWriter(fps=fps))
        plt.close(fig)
        return save_path

    @staticmethod
    def compare_covariance(logs: dict, save_path: Optional[str] = None, show: bool = False):
        """cov(v, e) against the peak velocity for several runs: the gp0
        against gp2 comparison."""
        plt = _pyplot()
        fig, ax = plt.subplots(figsize=(7, 5), dpi=100)
        for name, viz in logs.items():
            v_peak = np.linalg.norm(viz.d["x_odom"][:, 7:10], axis=1).max()
            covs = viz.velocity_error_covariance()
            ax.scatter([v_peak] * 3, covs, label=name)
        ax.set_xlabel("peak |v| [m/s]")
        ax.set_ylabel("cov(v_axis, e_axis)")
        ax.grid(alpha=0.3)
        ax.legend()
        return _finish(fig, save_path, show)


def _finish(fig, save_path, show):
    """Save and show a figure as asked, then close it; returns save_path."""
    plt = _pyplot()
    if save_path:
        os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
        fig.savefig(save_path, bbox_inches="tight")
    if show:
        plt.show()
    plt.close(fig)
    return save_path


class LiveFlightView:
    """In-flight view, the controller's rviz markers (the reference chunk,
    the MPC-optimal path, the target), driven by the `LiveFrame` callback of
    `node.ControllerNode(live_callback=...)`.

    Works headless: frames are rendered into an internal figure that can be
    saved per-frame (`save_every` + `out_dir`), exported as an animation
    (`to_animation`), or shown interactively (`interactive=True` on a display
    backend).  The flown path accumulates as a trail like rviz's Path."""

    def __init__(self, interactive: bool = False, save_every: int = 0,
                 out_dir: Optional[str] = None, trail_len: int = 2000,
                 stride: int = 1):
        self.interactive = interactive
        self.save_every = save_every
        self.out_dir = out_dir
        self.trail_len = trail_len
        self.stride = max(1, stride)
        self.frames: list = []          # retained LiveFrames (strided)
        self._trail: list = []
        self._n = 0
        self._fig = None
        self._ax = None
        self._artists = None

    # ------------------------------------------------------------------ #
    def __call__(self, frame) -> None:
        """The live_callback entry: consume one LiveFrame."""
        self._n += 1
        self._trail.append(np.asarray(frame.x[:3]))
        if len(self._trail) > self.trail_len:
            self._trail.pop(0)
        if (self._n - 1) % self.stride == 0:
            self.frames.append(frame)
        if self.interactive or (self.save_every and self._n % self.save_every == 0):
            self._render(frame)
            if self.interactive:
                _pyplot().pause(1e-3)
            if self.save_every and self._n % self.save_every == 0 and self.out_dir:
                os.makedirs(self.out_dir, exist_ok=True)
                self._fig.savefig(os.path.join(self.out_dir, f"live_{self._n:06d}.png"))

    # ------------------------------------------------------------------ #
    def _ensure_fig(self):
        plt = _pyplot()
        if self._fig is None:
            self._fig = plt.figure(figsize=(7, 6))
            self._ax = self._fig.add_subplot(111, projection="3d")
        return self._fig, self._ax

    def _render(self, frame):
        fig, ax = self._ensure_fig()
        ax.cla()
        trail = np.asarray(self._trail)
        ax.plot(trail[:, 0], trail[:, 1], trail[:, 2], "-", color="0.6",
                lw=1.0, label="flown")
        chunk = np.asarray(frame.x_ref_chunk)
        ax.plot(chunk[:, 0], chunk[:, 1], chunk[:, 2], "g.-", lw=1.5,
                label="reference chunk")
        hor = np.asarray(frame.x_horizon)
        ax.plot(hor[:, 0], hor[:, 1], hor[:, 2], "b.-", lw=1.5,
                label="MPC horizon")
        x = np.asarray(frame.x)
        ax.scatter([x[0]], [x[1]], [x[2]], color="k", s=40)
        tgt = np.asarray(frame.target)
        ax.scatter([tgt[0]], [tgt[1]], [tgt[2]], color="r", marker="*", s=120,
                   label="target")
        ax.set_title(f"t = {frame.t:.2f} s")
        ax.legend(loc="upper left", fontsize=8)
        return fig

    # ------------------------------------------------------------------ #
    def save_frame(self, path: str, frame=None) -> str:
        """Render one frame (default: the latest) to an image."""
        frame = frame if frame is not None else self.frames[-1]
        fig = self._render(frame)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        fig.savefig(path, bbox_inches="tight")
        return path

    def to_animation(self, path: str, fps: int = 20) -> str:
        """Export the retained frames as an animation (gif/mp4 by suffix)."""
        plt = _pyplot()
        from matplotlib import animation

        if not self.frames:
            raise ValueError("no frames retained")
        fig, ax = self._ensure_fig()
        trail_bak = list(self._trail)
        # rebuild the trail progressively from the retained frames
        pts = [np.asarray(f.x[:3]) for f in self.frames]

        def draw(i):
            self._trail = pts[: i + 1]
            self._render(self.frames[i])
            return []

        anim = animation.FuncAnimation(fig, draw, frames=len(self.frames),
                                       interval=1000 // fps, blit=False)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        writer = "pillow" if path.endswith(".gif") else None
        anim.save(path, writer=writer, fps=fps)
        self._trail = trail_bak
        plt.close(fig)
        self._fig = self._ax = None
        return path
