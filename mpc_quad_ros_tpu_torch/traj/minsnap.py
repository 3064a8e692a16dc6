"""Minimum-snap polynomial trajectories through waypoints, in numpy.

Counterpart of ``mpc_quad_ros_tpu/traj/minsnap.py``: piecewise 7th-order
polynomials through the waypoints within v_max / a_max, in the 33-column CSV
of the min-snap generator.

1. Per axis, the snap integral is minimised subject to waypoint
   interpolation, rest boundaries (v = a = j = 0 at both ends) and C^4
   continuity at the interior knots: an equality-constrained QP solved
   through its KKT system, each segment in tau = t / T for conditioning.
2. The durations start from a trapezoidal-speed guess and are scaled
   uniformly (v as 1/s, a as 1/s^2) until the sampled peak speed and
   acceleration meet the limits.

``native_minsnap.py`` binds a C++ build of the same math; this module is
its oracle, and ``backend`` picks between them.
"""

from __future__ import annotations

import numpy as np

from .polynomial import PiecewisePolynomial4D

_ORDER = 8  # coefficients per segment (7th-order polynomial)


def _snap_gram_unit() -> np.ndarray:
    """Gram matrix of the 4th-derivative inner product on tau in [0,1]:
    Q[i,k] = (i!/(i-4)!)(k!/(k-4)!) / (i+k-7) for i,k >= 4."""
    Q = np.zeros((_ORDER, _ORDER))
    for i in range(4, _ORDER):
        for k in range(4, _ORDER):
            ci = i * (i - 1) * (i - 2) * (i - 3)
            ck = k * (k - 1) * (k - 2) * (k - 3)
            Q[i, k] = ci * ck / (i + k - 7)
    return Q


_Q_UNIT = _snap_gram_unit()


def _deriv_row(m: int, tau: float) -> np.ndarray:
    """Row vector evaluating the m-th tau-derivative of a 7th-order polynomial
    at tau (ascending-power coefficients)."""
    row = np.zeros(_ORDER)
    for k in range(m, _ORDER):
        fac = 1.0
        for j in range(m):
            fac *= k - j
        row[k] = fac * tau ** (k - m)
    return row


def _solve_axis(way: np.ndarray, T: np.ndarray) -> np.ndarray:
    """Min-snap coefficients for one axis.  way: (K+1,), T: (K,) durations.
    Returns (K, 8) real-time ascending-power coefficients."""
    K = len(T)
    n = _ORDER * K

    # objective: sum_j  c_jᵀ (Q_unit / T_j^7) c_j  in tau-coefficients
    Q = np.zeros((n, n))
    for j in range(K):
        Q[j * _ORDER:(j + 1) * _ORDER, j * _ORDER:(j + 1) * _ORDER] = _Q_UNIT / T[j] ** 7

    rows, rhs = [], []

    def add(row_sparse, b):
        r = np.zeros(n)
        for j, row in row_sparse:
            r[j * _ORDER:(j + 1) * _ORDER] = row
        rows.append(r)
        rhs.append(b)

    # waypoint interpolation: p_j(0) = w_j, p_j(1) = w_{j+1}
    for j in range(K):
        add([(j, _deriv_row(0, 0.0))], way[j])
        add([(j, _deriv_row(0, 1.0))], way[j + 1])
    # rest boundary: derivatives 1..3 zero at both ends (real-time derivative
    # zero == tau-derivative zero since the scaling is a nonzero factor)
    for m in range(1, 4):
        add([(0, _deriv_row(m, 0.0))], 0.0)
        add([(K - 1, _deriv_row(m, 1.0))], 0.0)
    # C^1..C^4 continuity at interior knots, in REAL time:
    # d^m/dt^m = T^-m d^m/dtau^m
    for j in range(K - 1):
        for m in range(1, 5):
            add(
                [(j, _deriv_row(m, 1.0) / T[j] ** m), (j + 1, -_deriv_row(m, 0.0) / T[j + 1] ** m)],
                0.0,
            )

    A = np.stack(rows)
    b = np.asarray(rhs)
    m_con = A.shape[0]

    # KKT system; tiny Tikhonov keeps the (singular on low orders) Q safe
    KKT = np.zeros((n + m_con, n + m_con))
    KKT[:n, :n] = 2 * Q + 1e-9 * np.eye(n)
    KKT[:n, n:] = A.T
    KKT[n:, :n] = A
    sol = np.linalg.solve(KKT, np.concatenate([np.zeros(n), b]))
    c_tau = sol[:n].reshape(K, _ORDER)

    # tau -> real time: c_k_real = c_k_tau / T^k
    powers = T[:, None] ** np.arange(_ORDER)
    return c_tau / powers


def _initial_durations(waypoints: np.ndarray, v_max: float, a_max: float) -> np.ndarray:
    """Trapezoidal-profile per-segment time guess (accelerate at a_max to at
    most v_max, cruise, decelerate)."""
    d = np.linalg.norm(np.diff(waypoints, axis=0), axis=1)
    d = np.maximum(d, 1e-3)
    t_tri = 2 * np.sqrt(d / a_max)                      # triangular profile
    t_trap = d / v_max + v_max / a_max                  # trapezoidal profile
    return np.where(d < v_max**2 / a_max, t_tri, t_trap)


def min_snap_trajectory(waypoints: np.ndarray, v_max: float, a_max: float,
                        max_scaling_iters: int = 12,
                        backend: str = "auto") -> PiecewisePolynomial4D:
    """Min-snap piecewise polynomial through waypoints (N,3) honouring
    v_max / a_max, with zero yaw (genTrajectory's waypoint files carry no yaw
    and the sampled CSV never feeds yaw to the controller).

    backend: "auto" takes the native C++ optimizer when g++ can build it
    (``native_available``) and this numpy one otherwise; "native" requires
    it; "python" takes the numpy one.
    """
    waypoints = np.asarray(waypoints, dtype=float)
    if waypoints.ndim != 2 or waypoints.shape[1] != 3 or waypoints.shape[0] < 2:
        raise ValueError(f"waypoints must be (n >= 2, 3), not {waypoints.shape}")

    if backend not in ("auto", "native", "python"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend != "python":
        from .native_minsnap import native_available, native_min_snap_trajectory

        if backend == "native" or native_available():
            return native_min_snap_trajectory(waypoints, v_max, a_max, max_scaling_iters)

    T = _initial_durations(waypoints, v_max, a_max)

    def build(T):
        coeffs = np.stack([_solve_axis(waypoints[:, ax], T) for ax in range(3)], axis=1)
        yaw = np.zeros((len(T), 1, _ORDER))
        return PiecewisePolynomial4D(T, np.concatenate([coeffs, yaw], axis=1))

    poly = build(T)
    for _ in range(max_scaling_iters):
        dt = max(poly.duration / 2000.0, 1e-3)
        f = poly.eval_flat(np.arange(0.0, poly.duration, dt))
        vmax_cur = np.linalg.norm(f["vel"], axis=1).max()
        amax_cur = np.linalg.norm(f["acc"], axis=1).max()
        s = max(vmax_cur / v_max, np.sqrt(amax_cur / a_max))
        if 0.99 <= s <= 1.01:
            break
        # don't speed up beyond 2x per iteration (keeps the resample honest)
        s = np.clip(s, 0.5, 2.0)
        T = T * s
        poly = build(T)
    return poly


def generate_trajectory_csv(waypoints_csv: str, output_csv: str, v_max: float, a_max: float) -> None:
    """CLI-parity helper: waypoints CSV in, polynomial CSV out — the
    `genTrajectory -i ... -o ... --v_max ... --a_max ...` contract."""
    waypoints = np.loadtxt(waypoints_csv, delimiter=",", ndmin=2)
    poly = min_snap_trajectory(waypoints[:, :3], v_max, a_max)
    poly.savecsv(output_csv)
