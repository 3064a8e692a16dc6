"""Active-learning velocity curriculum.  Counterpart of
``mpc_quad_ros_tpu/explorer.py`` (``Explorer``): the next exploration
velocity from what the GP ensemble has covered, explored_vmax = the least
over the axes of max |X_d|, next = min(explored_vmax + step, desired_vmax).
"""

from __future__ import annotations

import numpy as np


class Explorer:
    def __init__(self, gpe=None, desired_explored_vmax: float = 20.0,
                 exploration_step: float = 10.0):
        self.desired_explored_vmax = desired_explored_vmax
        self.exploration_step = exploration_step
        self.explored_velocities = self._explored_from_gpe(gpe)
        explored_vmax = self.calculate_explored_vmax(self.explored_velocities)
        self.velocity_to_explore = self.calculate_velocity_to_explore(explored_vmax)

    def calculate_velocity_to_explore(self, explored_vmax: float) -> float:
        if explored_vmax + self.exploration_step < self.desired_explored_vmax:
            return explored_vmax + self.exploration_step
        return self.desired_explored_vmax

    @staticmethod
    def calculate_explored_vmax(explored_velocities) -> float:
        return min(max(ev["max"], abs(ev["min"])) for ev in explored_velocities)

    @staticmethod
    def _explored_from_gpe(gpe):
        """Each axis's basis-vector range (3, nb), or zeros without a model."""
        if gpe is None:
            return [{"min": 0.0, "max": 0.0} for _ in range(3)]
        X = gpe.state.X
        X = X.detach().cpu().numpy() if hasattr(X, "detach") else np.asarray(X)
        return [{"min": float(X[d].min()), "max": float(X[d].max())} for d in range(3)]
