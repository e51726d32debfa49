"""Per-operation timed two-phase solve (the reference's -D TIMER build).

Port of ``simplex_tpu.timed``: the solve split at the operation
boundaries the reference times -- ``fillTableau``, ``gauss1``,
``solve``, ``checkDegeneracy``, ``costsVector``, ``gauss2``, ``solve``,
``solution`` -- each bracketed by the chrono (CUDA events on the card),
rows written with the reference's schema and conventions.

Two solve-timing modes:

* aggregate (default): one ``solve`` row per phase (the whole
  ``run_solve_loop``) plus a ``solveIterations`` row whose elapsed_time
  column holds the pivot count;
* ``per_iteration=True``: the reference's own behaviour -- the
  sequential loop's body is stepped from the host and every step gets
  its own ``solve`` row, the exit-detecting step included, so a phase
  has pivots + 1 rows.

The JAX package compiles each operation ahead of its timer and caps the
pivots per device call for the TPU's watchdog; neither has a
counterpart here. Instead the kernels are built and the device warmed
before the first timed operation, as the reference's ``setupDevice``
precedes every timer.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from .chrono import Chrono, NullChrono
from .config import DEFAULT_OPTIONS, SolverOptions, Status, refine_enabled
from .problem import Problem
from .result import SolveResult
from .solver import initial_state, iteration_body, run_solve_loop
from .tableau import (build_phase1, count_basic_artificials,
                      extract_solution, format_tableau, gaussian_eliminate,
                      phase1_objective, phase2_reset)
from .two_phase import certify, pivot_out_artificials, resolve_device


def _run_solve(tab, options, max_iter, chrono, rows_csv, per_iteration,
               costs0, dev, pivot_cb=None):
    if not per_iteration:
        chrono.start(rows_csv, tab.m, "solve", dev)
        tab, status, iters = run_solve_loop(tab, options, max_iter, costs0)
        chrono.stop()
        chrono.row(rows_csv, tab.m, "solveIterations", iters / 1e6)
        return tab, status, iters

    if options.pivot_rule_resolved == "devex":
        raise ValueError(
            "per-iteration timing drives the single-pivot reference "
            "loop, which prices with Dantzig/Bland only (devex lives in "
            "the blocked loops)")
    if options.block_pivots and int(options.block_pivots) > 1:
        warnings.warn(
            f"per_iteration timing drives the single-pivot reference "
            f"loop; block_pivots={options.block_pivots} is ignored "
            "(use the aggregate solve timing for the blocked loop)",
            RuntimeWarning, stacklevel=3)

    state = initial_state(tab, options)
    iters = 0
    status = int(Status.RUNNING)
    while status == int(Status.RUNNING) and iters < max_iter:
        chrono.start(rows_csv, tab.m, "solve", dev)
        state = iteration_body(state, options, max_iter)
        status, now = (int(v) for v in
                       torch.stack([state.status, state.iterations]).tolist())
        chrono.stop()
        if now > iters and pivot_cb is not None:
            pivot_cb(state.tab, now)
        iters = now
    return state.tab, status, iters


def solve_timed(problem: Problem, options: SolverOptions | None = None,
                chrono: Chrono | NullChrono | None = None,
                per_iteration: bool = False, debug: bool = False,
                pause: bool = False, *, device="cuda",
                **replacements) -> SolveResult:
    """Host-orchestrated two-phase solve with per-operation CSV timing on
    ``device`` (``simplex_tpu.timed.solve_timed``); the same result
    contract as ``two_phase.solve`` with the reference's host early
    returns for INFEASIBLE / DEGENERATE. ``debug=True`` prints the
    tableau after every stage (and after every pivot with
    ``per_iteration``); ``pause=True`` also waits for Enter after each
    dump. In the mixed mode an OPTIMAL result is certified as ``solve``
    certifies it, outside the timed operations."""
    options = options or DEFAULT_OPTIONS
    if replacements:
        options = dataclasses.replace(options, **replacements)
    if per_iteration and options.pivot_rule is None:
        # The per-iteration mode steps the sequential loop, where the
        # auto rule's devex (an f32 blocked default) would raise: auto
        # resolves to the reference's own Dantzig here.
        options = dataclasses.replace(options, pivot_rule="dantzig")
    dev = resolve_device(device)
    chrono = chrono or NullChrono()

    m, n = problem.constraints, problem.vars
    eps = float(options.eps_resolved)
    max_iter = options.resolved_max_iter(n + 2 * m, m)
    A = torch.as_tensor(np.asarray(problem.A), device=dev)
    b = torch.as_tensor(np.asarray(problem.b), device=dev)
    c = torch.as_tensor(np.asarray(problem.c), device=dev)
    # The CSV's "vars" column counts the tableau's cost row too.
    r1, r2 = n + 2 * m + 1, n + m + 1

    if dev.type == "cuda":
        # Outside every timer: build (or load) the kernels and make the
        # first launch, as the reference's setupDevice does.
        from .kernels._build import load_library

        load_library()
        (torch.zeros(1, device=dev) + 1).sum().item()

    def dump(stage, tab):
        if debug:
            print(f"--- {stage} ---")
            print(format_tableau(tab))
            if pause:
                try:
                    input("[debug] Enter to continue...")
                except EOFError:       # non-interactive stdin: no pause
                    pass

    pivot_cb = ((lambda t, it: dump(f"pivot {it}", t))
                if (debug and per_iteration) else None)

    def timed(rows, op, fn, *args):
        chrono.start(rows, m, op, dev)
        out = fn(*args)
        chrono.stop()
        return out

    # ---- Phase 1 ----
    tab = timed(r1, "fillTableau", build_phase1, A, b, n, m, options)
    dump("fillTableau", tab)
    costs0_1 = tab.costs
    tab = timed(r1, "gauss1", gaussian_eliminate, tab)
    dump("gauss1", tab)
    tab, status1, iters1 = _run_solve(tab, options, max_iter, chrono, r1,
                                      per_iteration, costs0_1, dev, pivot_cb)
    dump("phase1 solved", tab)
    if status1 == int(Status.RUNNING):
        return SolveResult(Status.MAXITER, None, float(tab.z), iters1, 0)
    z1 = float(phase1_objective(tab))
    if z1 <= -eps * (1.0 + float(np.max(np.abs(problem.b)))):
        return SolveResult(Status.INFEASIBLE, None, z1, iters1, 0)

    n_art = timed(r1, "checkDegeneracy", count_basic_artificials, tab)
    degenerate = n_art > 0
    if degenerate:
        if options.degeneracy == "reference":
            return SolveResult(Status.DEGENERATE, None, float(tab.z),
                               iters1, 0, degenerate=True)
        tab = pivot_out_artificials(tab, options)

    # ---- Phase 2 ----
    tab = timed(r2, "costsVector", phase2_reset, tab, c)
    costs0_2 = tab.costs
    tab = timed(r2, "gauss2", gaussian_eliminate, tab)
    dump("gauss2", tab)
    tab, status2, iters2 = _run_solve(tab, options, max_iter, chrono, r2,
                                      per_iteration, costs0_2, dev, pivot_cb)
    dump("phase2 solved", tab)
    if status2 == int(Status.RUNNING):
        return SolveResult(Status.MAXITER, None, float(tab.z), iters1,
                           iters2, degenerate=degenerate)
    if status2 != int(Status.OPTIMAL):
        return SolveResult(Status(status2), None, float(tab.z), iters1,
                           iters2, degenerate=degenerate)

    x = timed(r2, "solution", lambda t: extract_solution(t).cpu().numpy(),
              tab)
    # c @ x recomputed from the final basis, as two_phase.solve reports.
    objective = float(np.dot(problem.c, x))
    refine_info = None
    if refine_enabled(options):
        # The pivot counts stay the timed walk's, which the CSV recorded,
        # also when a reinversion restart certified the result.
        cert = certify(problem, tab.base, tab.Tt[:m, n:n + m], objective,
                       options, A, b, c)
        if cert.fallback is not None:
            # The finishing tier's result with the timed walk's pivot
            # counts, as simplex_tpu.timed reports it.
            return dataclasses.replace(cert.fallback,
                                       iterations_phase1=iters1,
                                       iterations_phase2=iters2)
        x, objective, refine_info = cert.x, cert.objective, cert.refine
    return SolveResult(Status.OPTIMAL, x, objective, iters1, iters2,
                       degenerate=degenerate, refine=refine_info)
