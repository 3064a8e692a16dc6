"""Quadrotor physical parameters as a frozen record of tensors.

Counterpart of ``mpc_quad_ros_tpu/models/params.py`` (``QuadParams``,
``hummingbird_params``, ``randomize_params``).  Every field is a tensor so a
leading (B,) axis can carry per-episode parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..utils.containers import Tensors


@dataclasses.dataclass(frozen=True)
class QuadParams(Tensors):
    mass: torch.Tensor           # [kg]
    J: torch.Tensor              # (3,) diagonal inertia [kg m^2]
    max_thrust: torch.Tensor     # [N] per-rotor max thrust
    x_f: torch.Tensor            # (4,) rotor x positions [m]
    y_f: torch.Tensor            # (4,) rotor y positions [m]
    z_l_tau: torch.Tensor        # (4,) signed yaw-torque arms [m]
    g: torch.Tensor              # (3,) gravity vector [m/s^2]
    aero_drag: torch.Tensor      # quadratic aero-drag coefficient
    rotor_drag: torch.Tensor     # (3,) linear rotor-drag coefficients
    rotor_functionality: torch.Tensor  # (4,) 1 = healthy rotor
    payload_mass: torch.Tensor   # [kg]

    @property
    def hover_input(self) -> torch.Tensor:
        """Motor activation for static hover (uniform across rotors)."""
        return self.mass * self.g[..., 2] / (4.0 * self.max_thrust)


def hummingbird_params(dtype=torch.float32, device=None) -> QuadParams:
    """RotorS hummingbird, '+' rotor configuration — the values of the JAX
    package's preset (mass = body + 4 rotors, max_thrust = w_max^2 * k_m)."""
    mass = 0.68 + 4 * 0.009
    length = 0.17
    c = 0.016
    max_thrust = 838.0**2 * 8.54858e-6
    values = dict(
        mass=mass,
        J=[0.007, 0.007, 0.012],
        max_thrust=max_thrust,
        x_f=[length, 0.0, -length, 0.0],
        y_f=[0.0, length, 0.0, -length],
        z_l_tau=[c, -c, c, -c],
        g=[0.0, 0.0, 9.81],
        aero_drag=0.008,
        rotor_drag=[0.3, 0.3, 0.0],
        rotor_functionality=[1.0, 1.0, 1.0, 1.0],
        payload_mass=0.0,
    )
    return QuadParams(**{k: torch.tensor(v, dtype=dtype, device=device)
                         for k, v in values.items()})


def randomize_params(base: QuadParams, n: int,
                     generator: Optional[torch.Generator] = None,
                     drag_scale_range=(0.5, 2.0)) -> QuadParams:
    """n randomised parameter sets (aero and rotor drag scaled by independent
    U(lo, hi) draws); every field gains a leading (n,) axis.  The draws are
    made on the generator's device, in the base dtype."""
    dtype, device = base.mass.dtype, base.mass.device
    gen_device = generator.device if generator is not None else device

    def uniform(lo, hi):
        u = torch.rand(n, generator=generator, dtype=dtype, device=gen_device)
        return (lo + (hi - lo) * u).to(device)

    drag_s = uniform(*drag_scale_range)
    rotor_s = uniform(*drag_scale_range)
    tiled = base.map(lambda a: a.expand((n,) + a.shape).clone())
    return tiled.replace(
        aero_drag=tiled.aero_drag * drag_s,
        rotor_drag=tiled.rotor_drag * rotor_s[:, None],
    )
