"""Quadrotor physical parameters as a frozen record of tensors.

Counterpart of ``mpc_quad_ros_tpu/models/params.py`` (``QuadParams``, the
presets ``default_params``, ``default_v1_params``, ``hummingbird_params`` and
``crazyflie_params`` with their ``payload`` argument, ``params_from_xacro``,
``randomize_params``).  Every field is a tensor so a leading (B,) axis can
carry per-episode parameters.
"""

from __future__ import annotations

import dataclasses
import math
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


def _mk(values: dict, payload: bool, dtype, device) -> QuadParams:
    """A preset: its own constants, and the gravity, drag, healthy rotors and
    payload (0.3 kg with `payload`) every preset shares."""
    values = dict(values, g=[0.0, 0.0, 9.81], aero_drag=0.008, rotor_drag=[0.3, 0.3, 0.0],
                  rotor_functionality=[1.0, 1.0, 1.0, 1.0], payload_mass=0.3 if payload else 0.0)
    return QuadParams(**{k: torch.tensor(v, dtype=dtype, device=device)
                         for k, v in values.items()})


def _plus_frame(length: float) -> dict:
    """Rotor positions of the '+' configuration."""
    return dict(x_f=[length, 0.0, -length, 0.0], y_f=[0.0, length, 0.0, -length])


def default_params(dtype=torch.float32, device=None, payload: bool = False) -> QuadParams:
    """The reference's default constants (mass 0.03 kg, arm 0.04 m)."""
    return _mk(dict(mass=0.03, J=[0.03, 0.03, 0.06], max_thrust=20.0, **_plus_frame(0.04),
                    z_l_tau=[-0.013, 0.013, -0.013, 0.013]), payload, dtype, device)


def default_v1_params(dtype=torch.float32, device=None, payload: bool = False) -> QuadParams:
    """The reference's earlier defaults (mass 1.0 kg, arm 0.235 m), which
    some recorded simulation logs were made with."""
    return _mk(dict(mass=1.0, J=[0.03, 0.03, 0.06], max_thrust=20.0, **_plus_frame(0.47 / 2),
                    z_l_tau=[-0.013, 0.013, -0.013, 0.013]), payload, dtype, device)


def hummingbird_params(dtype=torch.float32, device=None, payload: bool = False) -> QuadParams:
    """RotorS hummingbird, '+' rotor configuration — the values of the JAX
    package's preset (mass = body + 4 rotors, max_thrust = w_max^2 * k_m)."""
    c = 0.016
    return _mk(dict(mass=0.68 + 4 * 0.009, J=[0.007, 0.007, 0.012],
                    max_thrust=838.0**2 * 8.54858e-6, **_plus_frame(0.17),
                    z_l_tau=[c, -c, c, -c]), payload, dtype, device)


def crazyflie_params(dtype=torch.float32, device=None, payload: bool = False) -> QuadParams:
    """Crazyflie 2.0, 'x' rotor configuration."""
    h = math.cos(math.pi / 4) * 0.04
    c = 0.016
    return _mk(dict(mass=0.027, J=[1.8e-5, 1.8e-5, 3.3e-5], max_thrust=0.3,
                    x_f=[h, -h, -h, h], y_f=[-h, -h, h, h], z_l_tau=[-c, c, -c, c]),
               payload, dtype, device)


def params_from_xacro(path: str, quad_name: str = "hummingbird", dtype=torch.float32,
                      device=None, payload: bool = False) -> QuadParams:
    """Parameters from a RotorS-style xacro file: mass = body + 4 rotors,
    J from the first <inertia>, max_thrust = w_max^2 * k_m; the '+' frame
    for "hummingbird" (z arms negated), the 'x' frame for any other name."""
    from ..utils.xacro import parse_xacro_properties

    attrib = parse_xacro_properties(path)
    inertia = attrib["body_inertia"][0]
    length = float(attrib["arm_length"])
    c = float(attrib["moment_constant"])
    if quad_name != "hummingbird":
        h = math.cos(math.pi / 4) * length
        frame = dict(x_f=[h, -h, -h, h], y_f=[-h, -h, h, h], z_l_tau=[-c, c, -c, c])
    else:
        frame = dict(**_plus_frame(length), z_l_tau=[c, -c, c, -c])
    return _mk(dict(mass=float(attrib["mass"]) + 4 * float(attrib["mass_rotor"]),
                    J=[float(inertia["ixx"]), float(inertia["iyy"]), float(inertia["izz"])],
                    max_thrust=float(attrib["max_rot_velocity"]) ** 2
                    * float(attrib["motor_constant"]), **frame), payload, dtype, device)


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
