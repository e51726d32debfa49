"""Two-phase simplex orchestration and the public ``solve``.

Port of ``simplex_tpu.two_phase``: phase-1 build, Gaussian elimination,
the loop ``run_solve_loop`` picks (the sequential reference loop, its K6
variant, or a deferred block-pivot loop), the infeasibility and
degeneracy checks, pivoting artificials out of a degenerate basis, phase
2, extraction, the status resolution with its NUMERIC guards, and, in
the mixed mode, f64 refinement with its LU retry and up to two
reinversion-restart rounds, then the f64 finishing tier
(``fallback_solve``: the warm host finish ``finish.finish_from_basis``,
else the full f64 re-solve on the device); and ``equilibrate``
(``scaling.py``).

The statuses are host values here: the loops sync once per chunk or
window anyway, so phase 2 is skipped when phase 1 already decided the
outcome (the JAX core runs it on the device and masks it out).
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from .config import DEFAULT_OPTIONS, SolverOptions, Status, refine_enabled
from .problem import Problem
from .result import SolveResult
from .solver import pivot_update, run_solve_loop
from .tableau import (Tableau, build_phase1, count_basic_artificials,
                      extract_solution, gaussian_eliminate, phase1_objective,
                      phase2_reset)


class DeviceSolveOutput(NamedTuple):
    """Outcome of one two-phase solve (``x`` and ``base`` on the
    device)."""

    status: Status
    x: torch.Tensor          # (n,), zeros unless OPTIMAL
    objective: float
    iterations_phase1: int
    iterations_phase2: int
    n_artificial_in_base: int
    base: torch.Tensor       # (M_pad,) int32 final basis


def pivot_out_artificials(tab: Tableau, options: SolverOptions) -> Tableau:
    """Drive zero-valued artificials out of the phase-1 basis
    (``simplex_tpu.two_phase.pivot_out_artificials``): for each
    constraint whose basic variable is artificial, pivot in the
    lowest-index structural or slack variable with a coefficient of at
    least eps in that row; a row with none is a redundant constraint --
    its row of ``Tt`` is zeroed and its base entry set to the R_pad
    sentinel. One pass per basic artificial, at most m; updates the
    tableau in place."""
    eps = float(options.eps_resolved)
    n, m = tab.n, tab.m
    R_pad = tab.rows_padded
    real = torch.arange(R_pad, device=tab.Tt.device) < n + m
    for _ in range(m):
        is_art = (tab.base >= n + m) & (tab.base < n + 2 * m)
        arts = torch.nonzero(is_art)
        if arts.numel() == 0:
            break
        k = int(arts[0, 0])
        cands = torch.nonzero(real & (tab.Tt[k].abs() >= eps))
        if cands.numel():
            h = int(cands[0, 0])
            tab = pivot_update(tab, h, k, tab.costs[h])
        else:
            tab.Tt[k].zero_()
            b = tab.b.clone()
            b[k] = 0.0
            base = tab.base.clone()
            base[k] = R_pad
            tab = dataclasses.replace(tab, b=b, base=base)
    return tab


def solve_device_with_binv(A: torch.Tensor, b: torch.Tensor,
                           c: torch.Tensor, n: int, m: int,
                           options: SolverOptions):
    """Full two-phase solve on ``A``'s device (``A`` (m, n), ``b`` (m,),
    ``c`` (n,)). Returns ``(DeviceSolveOutput, binv)`` with ``binv =
    Tt[:m, n:n+m]``, the final tableau's slack block -- ``B^{-1}`` of the
    final basis up to drift (None when phase 2 did not run)."""
    eps = float(options.eps_resolved)
    max_iter = options.resolved_max_iter(n + 2 * m, m)
    inputs_finite = bool(torch.isfinite(A).all() & torch.isfinite(b).all()
                         & torch.isfinite(c).all())

    # ---- Phase 1 ----
    tab = build_phase1(A, b, n, m, options)
    costs0 = tab.costs
    tab = gaussian_eliminate(tab)
    tab, status1, iters1 = run_solve_loop(tab, options, max_iter, costs0)

    # Infeasibility on the exact phase-1 objective, scaled by |b|.
    z_phase1 = float(phase1_objective(tab))
    b_scale = 1.0 + float(b.abs().max())
    infeasible = z_phase1 <= -eps * b_scale
    n_art = count_basic_artificials(tab)
    degenerate = n_art > 0
    fuse1 = status1 == int(Status.RUNNING)
    if (options.degeneracy == "continue" and degenerate and not infeasible
            and not fuse1):
        tab = pivot_out_artificials(tab, options)

    # Phase 1 decided the outcome: report the phase-1 objective.
    if not (np.isfinite(z_phase1) and inputs_finite):
        status = Status.NUMERIC
    elif fuse1:
        status = Status.MAXITER
    elif infeasible:
        status = Status.INFEASIBLE
    elif options.degeneracy == "reference" and degenerate:
        status = Status.DEGENERATE
    else:
        status = None
    if status is not None:
        x = torch.zeros(n, dtype=tab.b.dtype, device=A.device)
        return DeviceSolveOutput(status, x, z_phase1, iters1, 0, n_art,
                                 tab.base), None

    # ---- Phase 2 ----
    tab2 = phase2_reset(tab, c)
    costs0 = tab2.costs
    tab2 = gaussian_eliminate(tab2)
    tab2, status2, iters2 = run_solve_loop(tab2, options, max_iter, costs0)
    x = extract_solution(tab2)

    status = Status.MAXITER if status2 == int(Status.RUNNING) \
        else Status(status2)
    z2 = float(tab2.z)
    if not (np.isfinite(z2) and bool(torch.isfinite(x).all())):
        status = Status.NUMERIC
    if status2 == int(Status.OPTIMAL):
        objective = float(c.to(x.dtype) @ x)   # drift-immune c @ x
    else:
        objective = z2
    if status != Status.OPTIMAL:
        x = torch.zeros_like(x)
    out = DeviceSolveOutput(status, x, objective, iters1, iters2, n_art,
                            tab2.base)
    return out, tab2.Tt[:m, n:n + m]


def refine_result(problem: Problem, base, options: SolverOptions,
                  A_dev, b_dev, c_dev, raw_objective: float = float("nan"),
                  binv=None):
    """f64 refinement of one OPTIMAL basis, certified
    (``simplex_tpu.two_phase.refine_result``): the slack-block path
    first, then the LU retry unless the slack-block refinement converged
    primally and only dual feasibility failed (then the basis is truly
    suboptimal and the LU would agree). Returns ``(x, objective,
    RefineInfo, RefineOutput)``; x is None when the certificates fail."""
    from .refine import (RefineInfo, certificates_pass, refine_solution,
                         refine_solution_tableau)

    t0 = time.perf_counter()
    m, n = problem.constraints, problem.vars
    tol = float(options.refine_tol)
    ro = None
    method = "lu"
    ok = False
    skip_lu = False
    if binv is not None:
        ro = refine_solution_tableau(A_dev, b_dev, c_dev, base, binv, n, m)
        ok = certificates_pass(ro, problem.b, problem.c, tol)
        method = "tableau"
        if not ok:
            b_scale = 1.0 + float(np.max(np.abs(problem.b)))
            skip_lu = max(float(ro.primal_residual),
                          float(ro.primal_negativity),
                          float(ro.artificial_mass)) <= tol * b_scale
    if not ok and not skip_lu:
        ro = refine_solution(A_dev, b_dev, c_dev, base, n, m,
                             iters=int(options.refine_iters))
        ok = certificates_pass(ro, problem.b, problem.c, tol)
        method = "lu"
    info = RefineInfo(
        certified=ok,
        primal_residual=float(ro.primal_residual),
        primal_negativity=float(ro.primal_negativity),
        artificial_mass=float(ro.artificial_mass),
        dual_infeasibility=float(ro.dual_infeasibility),
        tol=tol,
        objective_shift=float(ro.objective) - raw_objective,
        wall_s=round(time.perf_counter() - t0, 4),
        method=method)
    if not ok:
        return None, None, info, ro
    return ro.x.cpu().numpy(), float(ro.objective), info, ro


class Certified(NamedTuple):
    """What ``certify`` returns: the certified ``x`` and objective with
    their RefineInfo and the restart rounds' extra phase-2 pivots; or,
    when no mixed tier certified, ``fallback``, the finishing tier's whole
    result (``x`` and ``objective`` then None), its RefineInfo marked
    ``fallback=True``."""

    x: np.ndarray | None
    objective: float | None
    refine: object
    extra_pivots: int
    fallback: SolveResult | None


def certify(problem: Problem, base, binv, objective: float,
            options: SolverOptions, A_dev, b_dev, c_dev,
            restart=None) -> Certified:
    """The mixed mode's tiers for one OPTIMAL result
    (``simplex_tpu.two_phase.solve``): f64 refinement of the final basis
    (``refine_result``), then up to two reinversion-restart rounds from
    the final slack block ``binv`` (``restart``, ``reinvert.
    restart_device`` by default; the sharded solve passes its own), and
    when none certifies the f64 finishing tier ``fallback_solve`` from
    the last basis, on the data's device. A RuntimeError inside a restart
    round (out of device memory at extreme shapes) goes to the finishing
    tier too."""
    from .reinvert import restart_device

    restart_device = restart or restart_device
    m, n = problem.constraints, problem.vars
    rx, robj, info, ro = refine_result(problem, base, options, A_dev, b_dev,
                                       c_dev, raw_objective=objective,
                                       binv=binv)
    extra = 0
    if rx is None and binv is not None:
        for _ in range(2):
            try:
                out2, binv2, _ = restart_device(A_dev, b_dev, c_dev, base,
                                                binv, ro.xB, n, m, options)
            except RuntimeError:   # out of memory and the like: hand
                break              # over to the finishing tier
            if out2.status != Status.OPTIMAL:
                break
            extra += out2.iterations_phase2
            base, binv = out2.base, binv2
            rx, robj, info, ro = refine_result(
                problem, base, options, A_dev, b_dev, c_dev,
                raw_objective=out2.objective, binv=binv)
            if rx is not None:
                info = info._replace(method="restart")
                break
    if rx is not None:
        return Certified(rx, robj, info, extra, None)
    result64 = fallback_solve(problem, options, base=base,
                              device=A_dev.device)
    # The finishing tier's own RefineInfo when it has one: the failed
    # certificates describe a solution that was thrown away.
    info = (result64.refine or info)._replace(fallback=True)
    return Certified(None, None, info, extra,
                     dataclasses.replace(result64, refine=info))


def fallback_options(options: SolverOptions) -> SolverOptions:
    """The f64 finishing configuration (``simplex_tpu.two_phase.
    fallback_options``): an f64 tableau and vectors (an ``eps`` of None
    re-resolves to 1e-9), refinement off."""
    return dataclasses.replace(
        options, dtype=np.float64, vector_dtype=np.float64, refine=False)


def fallback_solve(problem: Problem, options: SolverOptions, base=None, *,
                   device="cuda") -> SolveResult:
    """The f64 finishing tier for a result whose certificates fail
    (``simplex_tpu.two_phase.fallback_solve``). With ``base`` (the mixed
    solve's final basis) the warm host finish ``finish.finish_from_basis``
    goes first; where it does not apply, the full f64 re-solve on
    ``device`` (``resolve_f64``)."""
    if base is not None:
        from .finish import finish_from_basis

        if isinstance(base, torch.Tensor):
            base = base.cpu().numpy()
        finished = finish_from_basis(problem, np.asarray(base), options)
        if finished is not None:
            return finished
    return resolve_f64(problem, fallback_options(options),
                       resolve_device(device))


def resolve_f64(problem: Problem, options: SolverOptions,
                dev: torch.device) -> SolveResult:
    """The full f64 re-solve of the finishing tier with its extraction
    refinement, the result of ``simplex_tpu.checkpoint.solve_resumable(...,
    refine_extraction=True)`` (``checkpoint.py:255-290``): the two-phase
    solve on ``dev`` in one call (the JAX package cuts it into
    checkpointed chunks only for the TPU runtime's watchdog); an OPTIMAL
    basis refined on the host against the f64 data with the final slack
    block, its RefineInfo attached (method "tableau") and, when it
    certifies, its x and objective reported."""
    from .refine import (RefineInfo, certificates_pass,
                         refine_solution_tableau_host)

    m, n = problem.constraints, problem.vars
    out, binv = solve_device_with_binv(
        *(torch.as_tensor(np.asarray(v), device=dev)
          for v in (problem.A, problem.b, problem.c)), n, m, options)
    degenerate = out.n_artificial_in_base > 0
    if out.status != Status.OPTIMAL:
        return SolveResult(out.status, None, out.objective,
                           out.iterations_phase1, out.iterations_phase2,
                           degenerate=degenerate)
    x = out.x.cpu().numpy()
    objective = float(np.dot(problem.c, x))
    ro = refine_solution_tableau_host(problem.A, problem.b, problem.c,
                                      out.base.cpu().numpy(),
                                      binv.t().cpu().numpy(), n, m)
    ok = certificates_pass(ro, problem.b, problem.c,
                           float(options.refine_tol))
    info = RefineInfo(
        certified=ok, primal_residual=float(ro.primal_residual),
        primal_negativity=float(ro.primal_negativity),
        artificial_mass=float(ro.artificial_mass),
        dual_infeasibility=float(ro.dual_infeasibility),
        tol=float(options.refine_tol), method="tableau",
        objective_shift=float(ro.objective) - objective)
    if ok:
        x, objective = ro.x.numpy(), float(ro.objective)
    return SolveResult(Status.OPTIMAL, x, objective, out.iterations_phase1,
                       out.iterations_phase2, degenerate=degenerate,
                       refine=info)


def resolve_device(device) -> torch.device:
    """The solve's device, as given: asking for CUDA where there is none
    raises instead of running elsewhere."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but torch.cuda is not "
                           "available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def solve(problem: Problem, options: SolverOptions | None = None, *,
          device="cuda", **replacements) -> SolveResult:
    """Solve a dense LP ``max c x s.t. A x <= b, x >= 0`` on ``device``.

    ``replacements`` override SolverOptions fields. The defaults are the
    reference-parity mode: an f64 tableau, eps 1e-9, Dantzig pricing and
    the sequential loop. The production call is ``solve(p,
    dtype="float32", vector_dtype="float64", block_pivots=128)``; in
    that mixed mode every OPTIMAL result is refined in f64 and
    certified, through the tiers of ``certify`` (refinement, up to two
    reinversion restarts, then the f64 finishing tier, which marks its
    RefineInfo ``fallback``).

    With ``equilibrate=True`` the problem is scaled by powers of two
    (``scaling.equilibrate``) and solved, refined and certified in scaled
    space (the finishing tier too); x and the objective of an OPTIMAL
    result are unwound to original units (``scaling.unwind_result``),
    while a non-OPTIMAL objective stays in scaled units, as in
    ``simplex_tpu.two_phase.solve``."""
    options = options or DEFAULT_OPTIONS
    if replacements:
        options = dataclasses.replace(options, **replacements)
    dev = resolve_device(device)

    scaling = None
    solve_problem = problem
    if options.equilibrate:
        from .scaling import equilibrate

        solve_problem, scaling = equilibrate(problem)

    m, n = problem.constraints, problem.vars
    A_dev, b_dev, c_dev = (torch.as_tensor(np.asarray(v), device=dev)
                           for v in (solve_problem.A, solve_problem.b,
                                     solve_problem.c))
    out, binv = solve_device_with_binv(A_dev, b_dev, c_dev, n, m, options)
    status = out.status
    x = out.x.cpu().numpy() if status == Status.OPTIMAL else None
    objective = out.objective
    if scaling is not None and x is not None:
        x = scaling.col * x
        objective = float(problem.c @ x)
    refine_info = None
    extra_pivots = 0
    if status == Status.OPTIMAL and refine_enabled(options):
        cert = certify(solve_problem, out.base, binv, objective, options,
                       A_dev, b_dev, c_dev)
        if cert.fallback is not None:
            if scaling is None:
                return cert.fallback
            from .scaling import unwind_result

            return unwind_result(cert.fallback, scaling, problem)
        x, objective = cert.x, cert.objective
        refine_info, extra_pivots = cert.refine, cert.extra_pivots
        if scaling is not None:
            # The certified values were found in scaled space.
            x = scaling.col * x
            objective = float(problem.c @ x)

    return SolveResult(
        status=status,
        x=x,
        objective=objective,
        iterations_phase1=out.iterations_phase1,
        iterations_phase2=out.iterations_phase2 + extra_pivots,
        degenerate=out.n_artificial_in_base > 0,
        refine=refine_info,
    )
