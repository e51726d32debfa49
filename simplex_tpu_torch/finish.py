"""Warm-start f64 finishing from a near-optimal basis.

Port of ``simplex_tpu.finish`` (host NumPy/LAPACK; no device work), on
the port's own copy of the oracle.

The refinement layer (refine.py) certifies most mixed-precision solves
at 1e-9; the residual class — long walks (>10-20k pivots) whose f32
tableau drift steered the basis measurably off optimal (dual
infeasibility O(1e-2..1) in the r5 sweep at 8192-class sizes) — used
to fall back to a FULL f64 re-solve: 635-1393 s at the sweep's largest
sizes, impossible at flagship scale. But the drifted basis is not
garbage: it is primal feasible and a few hundred pivots from optimal.
This module rebuilds the exact f64 phase-2 tableau FOR THAT BASIS on
the host (one LAPACK solve of B against the [A | I] block — BLAS-3,
seconds) and lets the NumPy oracle's own f64 solve loop finish the
walk under the reference's 1e-9 discipline (oracle.py `_solve_loop` —
the machinery the whole parity ladder is pinned on).

Returns None when warm finishing does not apply (singular basis
system, primal-infeasible basis in exact arithmetic, non-negligible
artificial mass, memory beyond the cap, or the pivot cap hit); the
caller then falls back to the full f64 re-solve on the device
(two_phase.fallback_solve).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .config import EPS, SolverOptions, Status
from .oracle import _gaussian_eliminate, _solve_loop, _Tableau
from .problem import Problem
from .result import SolveResult

#: Refuse to materialise a warm tableau bigger than this (bytes) — the
#: flagship-scale escape hatch (a (n+m) x m f64 block).
WARM_TABLEAU_BYTE_CAP = 8 << 30


def finish_from_basis(problem: Problem, base, options: SolverOptions,
                      max_pivots: int | None = None,
                      _depth: int = 0) -> SolveResult | None:
    """Finish a solve in f64 from ``base`` (the mixed solve's final
    basis; tableau convention — [0, n) structural, [n, n+m) slack,
    anything else artificial/dropped). See module docstring.

    Iterates: the warm walk optimizes a micro-CLAMPED right-hand side
    (the drifted basis's exact-arithmetic infeasibility, <= the mixed
    envelope), so its optimum can sit ~clamp-size off the true one
    (observed 4.5e-7 relative on silicon). When the finished basis
    fails the STRONG (1e-9 scale-relative) certificates, one more
    round re-builds the exact tableau for it — the residual clamp
    shrinks each round — up to two extra rounds before settling for
    the ``refine_tol`` certificate."""
    m, n = problem.constraints, problem.vars
    R2 = n + m
    if R2 * m * 8 > WARM_TABLEAU_BYTE_CAP:
        return None

    A = np.asarray(problem.A, np.float64)
    b = np.asarray(problem.b, np.float64)
    c = np.asarray(problem.c, np.float64)
    v = np.asarray(base, np.int64)[:m]

    # The oracle's flipped system (b >= 0 rows; _build_phase1): row
    # scaling leaves variable values and the basis untouched.
    flip = b <= -EPS
    sign = np.where(flip, -1.0, 1.0)
    b_t = b * sign

    struct = v < n
    slack = (v >= n) & (v < R2)
    unit = np.where(slack, v - n, np.arange(m))

    # B~ rows-of-columns: row k = flipped column of basic variable v_k.
    Bt = np.eye(m)
    Bt[~struct] = np.eye(m)[unit[~struct]]
    Bt[slack, unit[slack]] = sign[unit[slack]]
    Bt[struct] = A.T[v[struct]] * sign[None, :]

    try:
        # Warm tableau = B~^{-1} [flipped A | flipped I], one factorized
        # solve against R2 right-hand sides (LAPACK dgesv, BLAS-3).
        rhs = np.concatenate([A * sign[:, None], np.diag(sign),
                              b_t[:, None]], axis=1)
        X = np.linalg.solve(Bt.T, rhs)
    except np.linalg.LinAlgError:
        return None
    if not np.isfinite(X).all():
        return None
    T_new = np.ascontiguousarray(X[:, :R2].T)     # (R2, m) variable-major
    b_new = X[:, R2]

    # A drifted basis is typically MICRO-infeasible in exact f64 (the
    # r5 flagship probe measured x_B min = -5.5e-6): within the mixed
    # envelope, clamp it — warm finishing is then a BASIS PREDICTOR on
    # an invisibly perturbed right-hand side, and the finished basis is
    # re-certified against the ORIGINAL data below (an exact-refined
    # answer or None, never a silently perturbed one). Beyond the
    # envelope the basis is junk: full fallback.
    b_scale = 1.0 + float(np.max(np.abs(b))) if m else 1.0
    envelope = 1e-4 * b_scale
    if float(b_new.min(initial=0.0)) < -envelope:
        return None                    # basis badly infeasible in f64
    aux_mass = float(np.abs(b_new[~(struct | slack)]).max(initial=0.0))
    if aux_mass > envelope:
        return None                    # artificial carrying real mass
    np.maximum(b_new, 0.0, out=b_new)

    costs0 = np.concatenate([-c, np.zeros(m)])
    t2 = _Tableau(T_new, b_new, costs0, 0.0, v.copy())
    _gaussian_eliminate(t2)

    # Reference f64 discipline for the finishing pivots (Dantzig — the
    # parity rule resolves for f64), bounded: a warm basis needing more
    # than the cap is not "finishing" — hand back to the full fallback.
    opts64 = dataclasses.replace(options, dtype=np.float64,
                                 vector_dtype=np.float64, refine=False,
                                 pivot_rule=None, eps=None)
    cap = int(max_pivots) if max_pivots is not None else 4 * m + 1000
    status, iters = _solve_loop(t2, np.ones(R2, bool), opts64, cap)
    if status == Status.UNBOUNDED:
        return SolveResult(Status.UNBOUNDED, None, float(t2.z), 0, iters)
    if status != Status.OPTIMAL:
        return None

    # Certify the FINISHED basis against the original data: the warm
    # tableau's slack block is an f64-quality basis inverse, so a
    # couple of host IR sweeps reach round-off — no LU. This closes the
    # clamp above: the returned x/objective are exact-refined for the
    # ORIGINAL problem, or the whole warm finish reports None.
    from .refine import certificates_pass, refine_solution_tableau_host

    ro = refine_solution_tableau_host(A, b, c, t2.base,
                                      t2.T[n:n + m, :], n, m)
    if not certificates_pass(ro, b, c, float(options.refine_tol)):
        return None
    c_scale = 1.0 + float(np.max(np.abs(c))) if c.size else 1.0
    d_scale = c_scale + float(ro.y.abs().max())
    strong = (float(ro.primal_residual) <= 1e-9 * b_scale
              and float(ro.primal_negativity) <= 1e-9 * b_scale
              and float(ro.artificial_mass) <= 1e-9 * b_scale
              and float(ro.dual_infeasibility) <= 1e-9 * d_scale)
    if not strong and _depth < 2:
        again = finish_from_basis(problem, t2.base, options, max_pivots,
                                  _depth=_depth + 1)
        if again is not None:
            return again
    from .refine import RefineInfo

    info = RefineInfo(
        certified=True,
        primal_residual=float(ro.primal_residual),
        primal_negativity=float(ro.primal_negativity),
        artificial_mass=float(ro.artificial_mass),
        dual_infeasibility=float(ro.dual_infeasibility),
        tol=float(options.refine_tol), method="finish")
    return SolveResult(Status.OPTIMAL, ro.x.numpy(),
                       float(ro.objective), 0, iters, refine=info)
