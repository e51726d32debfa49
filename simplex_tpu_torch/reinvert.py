"""Reinversion restart: rebuild the tableau exactly for a drifted basis
and continue the mixed loop.

Port of ``simplex_tpu.reinvert.restart_device``. When refinement shows
that a long mixed walk drifted (its certificates fail), the final basis
is usually a few pivots from optimal. One round:

1. sharpens the drifted slack block ``M ~ B^{-1}`` by Newton-Schulz
   steps ``M <- M (2I - B M)`` (f32 matmuls in IEEE precision);
2. rebuilds the phase-2 tableau for that basis: structural block
   ``M A``, slack block ``M``, right-hand side the refinement's f64
   basic values (clamped at 0), costs by Gaussian elimination;
3. re-enters ``run_solve_loop`` from that clean tableau.

Plain torch matmuls (the JAX package leaves them to XLA).
"""

from __future__ import annotations

import torch

from .config import SolverOptions, Status
from .solver import run_solve_loop
from .tableau import Tableau, extract_solution, gaussian_eliminate, \
    padded_dims

#: Newton-Schulz sharpening steps (quadratic: drift 1e-1 -> f32 eps in 3).
NS_STEPS = 3


def restart_device(A: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                   base: torch.Tensor, binv: torch.Tensor,
                   xB: torch.Tensor, n: int, m: int,
                   options: SolverOptions):
    """One reinversion-restart round. ``base`` (M_pad,) and ``binv =
    Tt[:m, n:n+m]`` come from the previous round, ``xB`` (m,) f64 from its
    refinement. Returns ``(DeviceSolveOutput, binv, ns_residual)``: the
    output contract of a phase-2-only solve, the new slack block for the
    next refinement, and ``max|I - B M|`` after sharpening (telemetry)."""
    _, R2_pad, M_pad = padded_dims(n, m, options)
    tab, ns_res = restart_tableau(A, b, c, base, binv, xB, n, m, options,
                                  M_pad, 0, R2_pad)
    costs0 = tab.costs
    tab = gaussian_eliminate(tab)
    tab2, status2, iters2 = run_solve_loop(
        tab, options, options.resolved_max_iter(n + 2 * m, m), costs0)
    out = restart_output(tab2, status2, iters2, b, c, xB)
    return out, tab2.Tt[:m, n:n + m], ns_res


def restart_tableau(A, b, c, base, binv, xB, n: int, m: int,
                    options: SolverOptions, M_pad: int, lo: int,
                    R_loc: int):
    """Steps 1 and 2 of a round: the sharpened ``M`` and the columns
    ``[lo, lo + R_loc)`` of the rebuilt phase-2 tableau (all of it at
    ``lo = 0``, ``R_loc = R_pad``; a rank's slice in the sharded solve),
    before Gaussian elimination. Returns (tableau, ns_residual)."""
    dtype = getattr(torch, options.dtype.name)
    vdtype = getattr(torch, options.vector_dtype.name)
    dev = A.device
    hi = lo + R_loc

    # precision=HIGHEST in the JAX package: IEEE f32 products, no TF32.
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        A32 = A.to(dtype)
        v = base[:m].to(torch.int64)
        struct = v < n
        slack = (v >= n) & (v < n + m)
        unit = torch.where(slack, v - n, torch.arange(m, device=dev))
        eye = torch.eye(m, dtype=dtype, device=dev)
        Bt = torch.where(struct[:, None], A32.t()[v.clamp(0, n - 1)],
                         eye[unit])
        B = Bt.t()
        M = binv.to(dtype)
        for _ in range(NS_STEPS):
            M = M @ (2.0 * eye - B @ M)
        ns_res = float((eye - B @ M).abs().max())

        Tt = torch.zeros((M_pad, R_loc), dtype=dtype, device=dev)
        if lo < n:
            Tt[:m, :min(hi, n) - lo] = M @ A32[:, lo:min(hi, n)]
        a, e = max(lo, n), min(hi, n + m)
        if a < e:
            Tt[:m, a - lo:e - lo] = M[:, a - n:e - n]
        del A32, Bt, B
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32

    b_pad = torch.zeros(M_pad, dtype=vdtype, device=dev)
    b_pad[:m] = xB.to(vdtype).clamp(min=0.0)
    gi = lo + torch.arange(R_loc, device=dev)
    costs0 = torch.where(
        gi < n, -c.to(vdtype).index_select(0, gi.clamp(max=n - 1)), 0.0)
    tab = Tableau(Tt=Tt, b=b_pad, costs=costs0,
                  z=torch.zeros((), dtype=vdtype, device=dev),
                  base=base.to(torch.int32).clone(), n=n, m=m, r=n + m)
    return tab, ns_res


def restart_output(tab2: Tableau, status2: int, iters2: int, b, c, xB):
    """Step 3's outcome: the ``DeviceSolveOutput`` of a phase-2-only
    solve from the restarted loop's final (replicated) state."""
    from .two_phase import DeviceSolveOutput

    x = extract_solution(tab2)
    status = Status.MAXITER if status2 == int(Status.RUNNING) \
        else Status(status2)
    finite = bool(torch.isfinite(tab2.z)) and bool(torch.isfinite(x).all())
    # Micro-infeasibility beyond the mixed envelope means a junk basis.
    bad_basis = float(xB.min()) < -1e-4 * (1.0 + float(b.abs().max()))
    if not finite or bad_basis:
        status = Status.NUMERIC
    if status2 == int(Status.OPTIMAL):
        objective = float(c.to(x.dtype) @ x)
    else:
        objective = float(tab2.z)
    if status != Status.OPTIMAL:
        x = torch.zeros_like(x)
    return DeviceSolveOutput(status, x, objective, 0, iters2, 0, tab2.base)
