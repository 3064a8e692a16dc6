"""The least time an H100 could take for each kernel's work: the larger of
its bytes over the memory rate and its operations over the f32 rate.

Bytes count each input read once and each output written once (f32).
Operations count what the algorithm does on these inputs, from the kernels'
code: a multiply-add is two, every other arithmetic operation, an exp or a
divide one.  The IPMs run a fixed number of iterations, so nothing depends
on the data.  Rates: NVIDIA's H100 SXM data sheet at its 700 W limit,
3.35 TB/s and 67 TFLOP/s f32 outside the tensor cores.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
F32 = 4
NX, NU, NT = 13, 4, 17


def bound(nbytes: float, flops: float) -> dict:
    """{"bound_ms", "bound_by", "bytes", "flops"} of one call."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def _model_flops(nb: int) -> tuple[int, int]:
    """(primal, per-tangent) operations of one evaluation of model.cuh's
    model_f: the primal ~150 plus the drag's 24 per basis vector and its
    Jacobian diagonal's 9 (per axis: 8 + 3 operations per basis vector); a
    tangent ~2 operations per primal one outside the drag, 3 in it."""
    return 150 + 33 * nb, 300 + 3


def lin_work(B: int, N: int, nb: int) -> dict:
    """Kernel A: x+ and the 17 tangents of the RK4 step per (scenario, stage)."""
    primal, tangent = _model_flops(nb)
    combine = 15 * NX                  # the RK4 combinations per direction
    per_column = 4 * primal + combine + NT * (4 * tangent + combine)
    nbytes = F32 * B * ((N + 1) * NX + N * NU + 3 * (2 * nb + 2) + N * NX + N * NT * NX)
    return bound(nbytes, B * N * per_column)


def condense_flops(N: int) -> int:
    """The condensing of condense.cuh per scenario: g and the lower triangle
    of H at live width 4k for k = 1..N, the M and d recurrences, the control
    diagonal."""
    flops = 0
    for k in range(1, N + 1):
        lw = NU * k
        flops += NX * 4 * lw + NX * 3 * lw * (lw + 1) // 2
    for k in range(N):
        flops += 2 * NX * NX * (NU * k) + 2 * NX * NX
    return flops + N * NU


def ipm_flops(nz: int, iters: int) -> int:
    """The IPM of ipm_box.cuh per scenario: the scaling, then per iteration
    Hz, the Cholesky (nz^3 / 6 multiply-adds), two substitutions and ~40
    vector operations per entry."""
    return 3 * nz * nz + 10 * nz + iters * (nz ** 3 // 3 + 4 * nz * nz + 40 * nz)


def _step_tail_flops(N: int) -> int:
    """KKT residual and the dX recurrence per scenario."""
    nz = NU * N
    return 2 * nz * nz + 5 * nz + 2 * N * NX * NT


def sqp_from_J_work(B: int, N: int, iters: int, warm: bool = False) -> dict:
    """Kernel B."""
    nz = NU * N
    n_in = N * NT * NX + N * NX + NX + (N + 1) * NX + 3 * nz + (2 * nz if warm else 0)
    n_out = nz + (N + 1) * NX + 1 + 2 * nz
    flops = condense_flops(N) + nz + ipm_flops(nz, iters) + _step_tail_flops(N)
    return bound(F32 * B * (n_in + n_out), B * flops)


def condense_work(B: int, N: int) -> dict:
    """Kernels D and J (J reads A and B, the same 221 floats a stage as J):
    H, g, M and d out."""
    nz = NU * N
    n_in = N * NT * NX + N * NX + NX + (N + 1) * NX
    n_out = nz * nz + nz + (N + 1) * NX * nz + (N + 1) * NX
    return bound(F32 * B * (n_in + n_out), B * condense_flops(N))


def box_qp_work(B: int, nz: int, iters: int, warm: bool = False) -> dict:
    """Kernel E."""
    n_in = nz * nz + 3 * nz + (2 * nz if warm else 0)
    return bound(F32 * B * (n_in + 3 * nz), B * ipm_flops(nz, iters))


def step_flops(N: int, nb: int, iters: int) -> dict:
    """Kernel F's operations per scenario by phase: kernel A's linearisation,
    the condensing with g += gu, the IPM (its scaling and one iteration),
    the KKT residual and the dX recurrence."""
    nz = NU * N
    out = {"lin": lin_work(1, N, nb)["flops"], "condense": condense_flops(N) + nz,
           "ipm_setup": ipm_flops(nz, 0), "ipm_per_iter": ipm_flops(nz, 1) - ipm_flops(nz, 0),
           "kkt_and_dX": _step_tail_flops(N)}
    out["ipm_total"] = ipm_flops(nz, iters)
    out["total"] = out["lin"] + out["condense"] + out["ipm_total"] + out["kkt_and_dX"]
    return out


def sqp_step_work(B: int, N: int, nb: int, iters: int, warm: bool = False) -> dict:
    """Kernel F: kernel A's work per scenario, then kernel B's, with
    (X, U, drag) in place of J and r."""
    nz = NU * N
    n_in = ((N + 1) * NX + N * NU + 3 * (2 * nb + 2) + NX + (N + 1) * NX + 3 * nz
            + (2 * nz if warm else 0))
    n_out = nz + (N + 1) * NX + 1 + 2 * nz
    return bound(F32 * B * (n_in + n_out), B * step_flops(N, nb, iters)["total"])


def riccati_work(B: int, N: int, iters: int) -> dict:
    """Kernel C: per stage and iteration the backward sweep (A'P and A'PA at
    13^3 multiply-adds each, B'P, B'PA and S'K at 4 13^2, B'PB, A'p, the p
    update and B'p, the 4x4 solve) and the forward pass over J and K; per
    stage twice in all the rollout over J (the cold start's and the final
    one: inside the loop dX moves by alpha ddx)."""
    per_stage = 2 * (2 * NX ** 3 + 3 * NU * NX * NX + NU * NU * NX + NX * NX + 2 * NU * NX
                     + NT * NX) + 250
    rollouts = 2 * 2 * NT * NX
    n_in = N * NT * NX + N * NX + NX + N * NX + N * NU + NX + 2 * N * NU
    n_out = N * NU + (N + 1) * NX
    return bound(F32 * B * (n_in + n_out), B * N * (iters * per_stage + rollouts))


def fma_work(elements: int, chains: int, steps: int) -> dict:
    """Kernel G: each element read and written once; per element `chains`
    chains of `steps` multiply-adds, `chains` + 1 multiplies to start them and
    `chains` - 1 adds to sum them."""
    return bound(2 * F32 * elements, elements * (2 * chains * steps + 2 * chains))


def transpose_work(B: int, nz: int, reps: int) -> dict:
    """Kernels H and I: the (B, nz, nz) tiles read and written once; per
    repetition one multiply-add on each of a strict triangle's entries."""
    return bound(2 * F32 * B * nz * nz, B * reps * nz * (nz - 1))
