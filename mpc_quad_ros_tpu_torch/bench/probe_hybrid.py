"""Where the "hybrid" step's time goes besides its kernels, what mirroring H
costs, and the Riccati kernel's time per IPM iteration.

Counterpart of ``mpc_quad_ros_tpu/bench/probe_hybrid.py``:

- ``jfed_standalone`` — kernel B alone on random inputs of the real scale,
  its time as a line in the IPM iteration count;
- ``hybrid_breakdown`` — the whole "hybrid" solve against kernel A and
  kernel B alone: the rest is the glue (tensor code and launches between);
- ``transpose_probe`` — kernels H (``mirror_probe``) and I (``elem_probe``),
  ``csrc/transpose_probe.cu``: ``reps`` masked mirrors of (B, nz, nz) tiles
  against the same without the transpose; their difference over ``reps`` is
  one mirror of H, the step kernels B, D and F run once per solve;
- ``riccati_profile`` — kernel C alone on the Riccati path's first-step
  inputs, its time as a line in the IPM iteration count at several
  horizons, its utilisation against the card's measured rate
  (``phases.vpu_peak``).

Timing: CUDA events (``phases.device_seconds``).  Entry points run on the
card unless the caller passes ``device="cpu"``.

    python -m mpc_quad_ros_tpu_torch.bench.probe_hybrid --what all
"""

from __future__ import annotations

import argparse
import json

import torch

from ..models import fold_drag, hummingbird_params, make_mpc_dynamics
from ..ops.cuda import _build, lin_kernel, riccati_kernel, sqp_fused_kernel
from ..ops.sqp import MPCConfig, SQPSolver, init_carry
from . import bounds
from .operating_point import operating_point
from .phases import (QW, RW, _bench_setup, device_kind, device_seconds, kernel_device_ms,
                     line_fit, resolve_device, time_solves, vpu_peak)

# ------------------------------------------------------------------ #
# kernel B alone, and the hybrid step's glue
# ------------------------------------------------------------------ #


def _jfed_inputs(B: int, device, N: int = 10, seed: int = 0) -> tuple:
    """Kernel B's inputs (J, r, dx0, ex0, gu, lb, ub), random at the JAX
    probe's scale (``bench/probe_hybrid.py:42-58``): J = 0.1 N(0, 1) plus
    [I; 0] in each stage's 17 x 13 tangents, so the A blocks stay near the
    identity and condensing stays bounded; r, dx0, gu 0.01 N(0, 1); ex0
    N(0, 1); the box [-0.16, 0.84]."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    kw = dict(dtype=torch.float32, device=dev)
    randn = lambda *shape: torch.randn(shape, generator=gen, **kw)
    nz = 4 * N
    eye = torch.cat([torch.eye(13, **kw), torch.zeros((4, 13), **kw)])
    return (0.1 * randn(B, N, 17, 13) + eye, 0.01 * randn(B, N, 13), 0.01 * randn(B, 13),
            randn(B, N + 1, 13), 0.01 * randn(B, nz), torch.full((B, nz), -0.16, **kw),
            torch.full((B, nz), 0.84, **kw))


def jfed_standalone(B: int = 16384, iters_grid=(1, 4, 12), device="cuda", reps: int = 5) -> dict:
    """Slope and intercept of kernel B alone (condensing, IPM, KKT, dX; no
    linearisation, no glue) over the IPM iteration count."""
    dev = resolve_device(device)
    args = _jfed_inputs(B, dev)
    times = {it: device_seconds(lambda it=it: sqp_fused_kernel.fused_sqp_from_J(
        *args, QW, QW, RW, it), reps, dev) for it in iters_grid}
    slope, intercept = line_fit(times) if len(times) > 1 else (float("nan"), float("nan"))
    return {"batch": B, "per_iters_seconds": {str(k): v for k, v in times.items()},
            "ipm_slope_s": slope, "kernel_intercept_s": intercept,
            "t_at_12_s": times.get(12, float("nan"))}


def hybrid_breakdown(B: int = 16384, device="cuda", chained: int = 5, reps: int = 10) -> dict:
    """The whole "hybrid" solve against kernel A at the operating point
    (RGP drag folded in) and kernel B alone at 12 iterations: the
    difference is the glue."""
    dev = resolve_device(device)
    solver, carry, x0, y_ref, rgp = _bench_setup(B, dev)
    full_s = time_solves(solver, carry, x0, y_ref, rgp, chained, dev)[0][0]

    N = solver.cfg.n_nodes
    X = x0[:, None, :].expand(B, N + 1, 13).contiguous()
    U = torch.full((B, N, 4), solver.cfg.u_ref, dtype=x0.dtype, device=dev)
    aug = fold_drag(rgp).map(lambda a: a.contiguous())
    lin_s = device_seconds(lambda: lin_kernel.linearize(X, U, aug, solver.f, solver.cfg.dt),
                           reps, dev)
    jfed_s = jfed_standalone(B, iters_grid=(12,), device=dev)["per_iters_seconds"]["12"]
    glue = full_s - lin_s - jfed_s
    return {"batch": B, "device_kind": device_kind(dev), "full_hybrid_s": full_s,
            "lin_standalone_s": lin_s, "jfed_standalone_12it_s": jfed_s, "glue_s": glue,
            "glue_fraction": glue / full_s, "us_per_solve": full_s / B * 1e6}


def riccati_breakdown(B: int = 65536, N: int = 40, device="cuda", reps: int = 3) -> dict:
    """One Gauss-Newton step of the Riccati slice by part: the solve cell at
    horizon N (``qp_method="riccati"``, what "auto" takes there) after one
    warm-up solve; kernel A's linearisation, the glue that forms kernel C's
    inputs, kernel C, and ``_riccati_finish`` (the four-candidate rollout and
    line search, kernel A again, the adjoint KKT), each timed alone, and the
    whole step (``_gn_step_batch_riccati``) from the same carry."""
    dev = resolve_device(device)
    solver, carry, x0, y_ref, rgp = operating_point(B, dev, N=N, qp_method="riccati")
    carry, _ = solver.solve_batch(carry, x0, y_ref, y_ref[:, -1], rgp)
    cfg = solver.cfg
    aug = fold_drag(rgp).map(lambda a: a.contiguous())
    X, U, yN = carry.X, carry.U, y_ref[:, -1]
    lin = lambda: solver._linearize(X, U, aug)
    xp, J = lin()
    glue = lambda: solver.riccati_inputs(X, U, x0, y_ref, yN, xp)
    args = (J, *glue())
    kern = lambda: riccati_kernel.riccati_ipm_from_J(*args, *cfg.weight_tuples(), cfg.qp_iters)
    dU, _ = kern()
    parts = {"lin_kernel_s": lin, "glue_s": glue, "riccati_kernel_s": kern,
             "riccati_finish_s": lambda: solver._riccati_finish(U, x0, y_ref, yN, aug, dU),
             "step_s": lambda: solver._gn_step_batch_riccati(X, U, carry.zl, carry.zu, x0, y_ref,
                                                             yN, aug)}
    out = {"batch": B, "N": N, "iters": cfg.qp_iters, "device_kind": device_kind(dev)}
    out.update({k: device_seconds(fn, reps, dev) for k, fn in parts.items()})
    return out


# ------------------------------------------------------------------ #
# kernels H and I: the cost of a mirror on the Hessian's shape
# ------------------------------------------------------------------ #

def _strict_lower(acc):
    nz = acc.shape[-1]
    mask = torch.ones((nz, nz), dtype=torch.bool, device=acc.device).tril(-1)
    return torch.where(mask, acc, 0.0)


def mirror_probe_plain(x, reps: int):
    """The JAX ``_mirror_kernel`` per scenario: `reps` times
    acc = acc + strict_lower(acc)^T (1 + 1e-6 i).  x (B, nz, nz)."""
    acc = x
    for i in range(reps):
        acc = acc + _strict_lower(acc).mT * (1.0 + 1e-6 * i)
    return acc


def elem_probe_plain(x, reps: int):
    """The JAX ``_elem_kernel``: the same without the transpose."""
    acc = x
    for i in range(reps):
        acc = acc + _strict_lower(acc) * (1.0 + 1e-6 * i)
    return acc


def _launch_probe(name: str, entry: str, x, reps: int):
    B, nz = x.shape[0], x.shape[-1]
    _build.check_cuda_inputs(name, {"x": x}, {"x": (B, nz, nz)})
    if nz % 4:
        raise ValueError(f"{name}: nz={nz} is not a multiple of 4 (the kernel moves 16-byte quads)")
    out = torch.empty_like(x)
    for key, t in (("x", x), ("out", out)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} is not 16-byte aligned")
    lib = _build.load_library()
    need = lib.mpcq_transpose_ws_bytes(nz)
    limit = torch.cuda.get_device_properties(x.device).shared_memory_per_block_optin
    if not 0 < need <= limit:
        raise ValueError(f"{name}: nz={nz} needs {need or 'more'} bytes of shared memory per "
                         f"warp, the device allows {limit} a block")
    rc = getattr(lib, entry)(x.data_ptr(), out.data_ptr(), B, nz, int(reps),
                             torch.cuda.current_stream(x.device).cuda_stream)
    return out, rc


def mirror_probe(x, reps: int):
    """Kernel H on x (B, nz, nz): the plain version for a CPU tensor, the
    kernel for a CUDA tensor (f32, contiguous, 16-byte aligned, nz % 4 == 0,
    sm_90)."""
    if x.device.type == "cpu":
        return mirror_probe_plain(x, reps)
    out, rc = _launch_probe("mirror_probe", "mpcq_mirror", x, reps)
    mirror_probe.launches += 1
    _build.check_status("mirror_probe", rc)
    return out


def elem_probe(x, reps: int):
    """Kernel I on x (B, nz, nz), as ``mirror_probe``."""
    if x.device.type == "cpu":
        return elem_probe_plain(x, reps)
    out, rc = _launch_probe("elem_probe", "mpcq_elem", x, reps)
    elem_probe.launches += 1
    _build.check_status("elem_probe", rc)
    return out


mirror_probe.launches = 0
elem_probe.launches = 0


def probe_input(B: int = 128 * 128, nz: int = 40, device="cuda"):
    """The probe's (B, nz, nz) f32 tiles: ``torch.randn`` from seed 0 on the
    device (the JAX probe's 128 tiles of 128 scenarios by default)."""
    gen = torch.Generator(device=device).manual_seed(0)
    return torch.randn((B, nz, nz), generator=gen, dtype=torch.float32, device=device)


def transpose_probe(nz: int = 40, B: int = 128 * 128, reps: int = 4, device="cuda",
                    launches: int = 100) -> dict:
    """Kernels H and I on the same random (B, nz, nz) tiles, `launches`
    launches each (CUDA events): (mirror - elem) / reps is one mirror, per
    scenario and for the whole batch.  On the card also each kernel's device
    time of one launch (``phases.kernel_device_ms``, without the wrapper's
    host path) and, as a yardstick that moves the same bytes but computes
    nothing of the probe, the device time of ``Tensor.copy_`` on the same
    tiles; and the bound (``bounds.transpose_work``)."""
    dev = resolve_device(device)
    x = probe_input(B, nz, dev)
    t_mirror = device_seconds(lambda: mirror_probe(x, reps), launches, dev)
    t_elem = device_seconds(lambda: elem_probe(x, reps), launches, dev)
    per_batch = (t_mirror - t_elem) / reps
    out = {"mirror_s": t_mirror, "elem_s": t_elem, "transpose_per_scenario_s": per_batch / B,
           "transpose_batch_s": per_batch, "device_kind": device_kind(dev),
           "note": f"nz={nz}, B={B}, reps={reps}", "reps": reps,
           "bound_ms": bounds.transpose_work(B, nz, reps)["bound_ms"]}
    if dev.type == "cuda":
        y = torch.empty_like(x)
        out.update({
            "mirror_device_ms": kernel_device_ms(lambda: mirror_probe(x, reps), "mirror_kernel",
                                                 launches),
            "elem_device_ms": kernel_device_ms(lambda: elem_probe(x, reps), "elem_kernel",
                                               launches),
            # a contiguous copy on one device is a device-to-device memcpy
            "copy_yardstick_device_ms": kernel_device_ms(lambda: y.copy_(x), "Memcpy", launches)})
    return out


# ------------------------------------------------------------------ #
# the Riccati path's time per IPM iteration
# ------------------------------------------------------------------ #

def executed_riccati_flops(N=10, nx=13, nu=4, iters=12):
    """Per-solve FLOPs that the JAX Riccati-IPM kernel executes, counted
    from its loops: ``mpc_quad_ros_tpu/bench/probe_hybrid.py:230-255``."""
    stage = 0
    stage += 2 * (nx + nu) * nx * nx
    stage += 2 * nx * (nu * nu + nu * nx)
    stage += nu * nu
    stage += 2 * nx * nu
    stage += 2 * (nu * (nu - 1) // 2) * 2
    stage += 2 * 2 * (nu * (nu - 1) // 2) * (nx + 1)
    stage += 2 * nu * (nx + 1)
    stage += 2 * nx * nx * nx
    stage += 2 * nu * nx * nx
    stage += 4 * nx * nx
    stage += 2 * (nx + nx * nx + nu * nx)
    per_iter = N * stage
    per_iter += 2 * N * ((nx + nu) * nx)
    per_iter += N * (2 * nu * nx + 2 * (nx + nu) * nx)
    per_iter += 30 * N * nu
    return {"per_stage": stage, "per_iter": per_iter,
            "total": iters * per_iter}


def _riccati_inputs(B: int, N: int, device) -> tuple:
    """Kernel C's inputs at the first step of the JAX profile's solve
    (``bench/probe_hybrid.py:276-282``: hover at 3 m, x-velocity over
    linspace(-2, 2), y_ref = x0, no drag): kernel A's J along the initial
    carry, then the Riccati glue; and the weights."""
    p = hummingbird_params(dtype=torch.float32).map(lambda a: a.to(device))
    cfg = MPCConfig(n_nodes=N, t_horizon=0.1 * N, u_ref=float(p.hover_input),
                    qp_method="riccati")
    solver = SQPSolver(cfg, make_mpc_dynamics(p))
    kw = dict(dtype=torch.float32, device=device)
    x0 = torch.zeros((B, 13), **kw)
    x0[:, 3] = 1.0
    x0[:, 2] = 3.0
    x0[:, 7] += torch.linspace(-2, 2, B, **kw)
    y_ref = x0[:, None, :].repeat(1, N, 1)
    carry = init_carry(cfg, x0)
    xp, J = solver._linearize(carry.X, carry.U, None)
    args = (J, *solver.riccati_inputs(carry.X, carry.U, x0, y_ref, y_ref[:, -1], xp))
    return args, cfg.weight_tuples()


def riccati_profile(Ns=(10, 20, 40), B: int = 1024, iters_grid=(2, 6, 12), device="cuda",
                    peak: dict | None = None, reps: int = 20) -> dict:
    """t(iters) line fit of kernel C alone at each horizon, on the profile's
    first-step inputs: the slope is one IPM iteration (one backward sweep
    and the forward pass), the intercept the kernel's own set-up and its
    two rollouts.  (The JAX profile fits the whole
    ``solve_batch``; in the port the line search's host time, tens of ms at
    B=1024, varies by more than the slope.)  The utilisation divides each
    iteration's operations (the JAX count and the port's
    ``bounds.riccati_work``) by the slope and by the measured shared-memory
    streaming rate (`peak`, a ``phases.vpu_peak`` result of this run;
    measured here when None)."""
    dev = resolve_device(device)
    peak = peak or vpu_peak(dev)
    rate = peak["smem_streaming_f32_flops_per_s"]
    out = {"batch": B, "device_kind": device_kind(dev), "measured_vpu_peak_tflops": rate / 1e12}
    for N in Ns:
        args, w = _riccati_inputs(B, N, dev)
        times = {it: device_seconds(lambda it=it: riccati_kernel.riccati_ipm_from_J(*args, *w, it),
                                    reps, dev) for it in iters_grid}
        slope, intercept = line_fit(times)
        jax_fl = executed_riccati_flops(N=N)["per_iter"]
        port_fl = bounds.riccati_work(1, N, 1)["flops"] - bounds.riccati_work(1, N, 0)["flops"]
        util = lambda fl: fl * B / slope / rate if slope > 0 else None
        out[str(N)] = {"per_iters_seconds": {str(k): v for k, v in times.items()},
                       "sweep_slope_s": slope, "intercept_s": intercept,
                       "kernel_us_per_scenario_at_12": (intercept + 12 * slope) / B * 1e6,
                       "executed_flops_per_iter": jax_fl, "port_flops_per_iter": port_fl,
                       "sweep_vpu_utilization": util(port_fl),
                       "sweep_vpu_utilization_jax_count": util(jax_fl)}
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--what", choices=("breakdown", "jfed", "transpose", "riccati", "all"),
                    default="all")
    ap.add_argument("--batch", type=int, default=16384)
    a = ap.parse_args(argv)
    out = {}
    if a.what == "jfed":
        out["jfed"] = jfed_standalone(a.batch)
    if a.what in ("breakdown", "all"):
        out["breakdown"] = hybrid_breakdown(a.batch)
    if a.what in ("transpose", "all"):
        out["transpose"] = transpose_probe()
    if a.what == "riccati":
        out["riccati"] = riccati_profile()
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
