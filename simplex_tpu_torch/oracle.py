"""Pure-NumPy two-phase tableau simplex — the test oracle.

The port's own copy of ``simplex_tpu.oracle`` (NumPy and SciPy only),
with ``utils/cuda_order`` and ``utils/fma_native`` beside it. Besides the
tests it carries the f64 loop of the warm finishing tier (finish.py).

A host-side implementation that is semantics-faithful to the reference's
algorithm (SURVEY.md §3.2): Dantzig entering rule over an epsilon-aware
argmin (reference src/solver.cu:78-126, src/reduction.cu:82-140), the
eps=1e-9 three-way comparison discipline (include/macro.h:28-42), identical
tableau layout semantics (variables-as-stored-rows, separate cost row and
right-hand side; include/tabular.cuh:5-30, relazione.Rmd:290-301), the
Phase-1 artificial-variable construction (twoPhaseMethod.cu:145-200), the
Gaussian objective elimination (src/gaussian.cu:110-162) and the reference's
status codes. It replaces the CUDA binary as the source of golden outputs
for every test in ``tests/`` (the reference repo persists no solution
artifacts).

Two deliberate divergences from the reference, both documented in SURVEY.md:

* Ties in argmin reductions break toward the lowest index (deterministic),
  not the reference's GPU-reduction order — EXCEPT with
  ``tie_rule='cuda'``, which replays the reference GPU's eps-tie
  reduction order exactly (utils/cuda_order.py) and reproduces the
  reference's recorded per-phase pivot counts on its regenerated
  benchmark instances (tests/test_parity.py).
* The Phase-1 sign fix for negative right-hand sides negates the constraint
  row and its slack but keeps the artificial coefficient +1
  (``checkColumns``/``negateColumn``, twoPhaseMethod.cu:86-111, negate the
  artificial identity entry too, which leaves Phase 1 starting from an
  infeasible basis; none of the reference's benchmark instances — all with
  b > 0 — ever hit that path).

Beyond the reference (north-star requirements): Bland's-rule anti-cycling
fallback and pivoting artificial variables out of a degenerate Phase-1 basis
instead of aborting.
"""

from __future__ import annotations

import numpy as np

from .config import DEFAULT_OPTIONS, SolverOptions, Status
from .problem import Problem
from .result import SolveResult

try:
    # In-place BLAS rank-1 update: ~250x faster than `T -= np.outer(...)`
    # at reference-sweep sizes (no 100 MB temporary per pivot), which is
    # what makes the 2048-class pivot-count parity replay a ~1 min test
    # instead of ~50. dger rounds the product and the subtraction
    # separately, where the reference GPU rounds once (fma,
    # solver.cu:43); the replayed counts are insensitive to that last
    # ulp through the 2048 class, and update_rule='fma' (see _pivot)
    # removes the difference entirely for larger fingerprints —
    # asserted end-to-end by tests/test_parity.py.
    from scipy.linalg.blas import dger as _dger
except ImportError:                                 # pragma: no cover
    _dger = None


class _Tableau:
    """Host tableau in the reference's transposed layout: ``T[i, j]`` is the
    coefficient of variable i in constraint j; ``b`` and the cost row live
    outside the matrix (tabular.cuh:5-30, relazione.Rmd:290-301)."""

    def __init__(self, T, b, costs, z, base):
        self.T = T          # (R, m) variable-major coefficient matrix
        self.b = b          # (m,)
        self.costs = costs  # (R,) reduced costs
        self.z = z          # objective cell (reference costs[0])
        self.base = base    # (m,) int — basic variable per constraint


def _build_phase1(problem: Problem, eps: float) -> _Tableau:
    """Phase-1 tableau (reference fillTableu, twoPhaseMethod.cu:145-200):
    stored rows = [structural | slack | artificial], b copied, artificial
    basis, costs 1 on artificials; constraints with b <= -eps are negated
    (structural + slack + b) so b >= 0 while artificials stay +1."""
    m, n = problem.constraints, problem.vars
    R = n + 2 * m
    T = np.zeros((R, m), dtype=np.float64)
    T[:n, :] = problem.A.T
    T[n:n + m, :] = np.eye(m)
    T[n + m:, :] = np.eye(m)
    b = problem.b.astype(np.float64).copy()

    flip = b <= -eps
    T[:n + m, flip] *= -1.0
    b[flip] *= -1.0

    costs = np.zeros(R, dtype=np.float64)
    costs[n + m:] = 1.0
    base = np.arange(n + m, n + 2 * m, dtype=np.int64)
    return _Tableau(T, b, costs, 0.0, base)


def _gaussian_eliminate(t: _Tableau) -> None:
    """Express the objective in terms of non-basic variables
    (reference updateObjectiveFunction, gaussian.cu:110-162):
    ``costs -= T @ costs[base]`` and ``z -= b @ costs[base]``.

    Base entries pointing past the truncated tableau (redundant constraints
    whose artificial stayed basic; their columns are zeroed) contribute 0."""
    R = t.costs.shape[0]
    valid = t.base < R
    coeffs = np.where(valid, t.costs[np.minimum(t.base, R - 1)], 0.0)
    t.costs = t.costs - t.T @ coeffs
    t.z = t.z - t.b @ coeffs


def _entering(costs, mask, eps, bland: bool, tie_rule: str = "lowest",
              weights=None):
    """Entering variable: Dantzig argmin of reduced costs
    (solver.cu:87, reduction.cu:82-104), Bland's lowest eligible index,
    or — when ``weights`` is given — the Devex rule (largest
    cost^2 / weight among eligible; Forrest & Goldfarb 1992
    reference-framework weights). Returns (h, min_cost); h == -1 when
    optimal (no eligible column).

    ``tie_rule='cuda'`` replays the reference GPU's exact eps-tie
    reduction order (utils/cuda_order.py) instead of lowest-index —
    required to reproduce the reference's recorded pivot counts."""
    masked = np.where(mask, costs, np.inf)
    if bland:
        eligible = np.nonzero(masked <= -eps)[0]
        if eligible.size == 0:
            return -1, 0.0
        h = int(eligible[0])
        return h, float(costs[h])
    if weights is not None:
        eligible = masked <= -eps
        if not eligible.any():
            return -1, float(masked.min())
        score = np.where(eligible, masked * masked / weights, -np.inf)
        h = int(np.argmax(score))      # ties -> lowest index
        return h, float(costs[h])
    if tie_rule == "cuda":
        from .utils.cuda_order import cuda_argmin

        h, minc = cuda_argmin(np.where(mask, costs, np.inf), eps)
    else:
        h = int(np.argmin(masked))
        minc = float(masked[h])
    if not (minc <= -eps):
        return -1, minc
    return h, minc


def _pivot(t: _Tableau, h: int, k: int, minc: float,
           fma: bool = False) -> None:
    """Rank-1 pivot update (reference updateTableau + updateCostsVector,
    solver.cu:34-75): divide pivot column k by p, subtract
    ``outer(T[:, k], a_h / p)`` elsewhere; same for b and the cost row.

    ``fma=True`` replays the GPU's per-element rounding EXACTLY
    (native/fma_update.cpp): the device rounds each updated element once
    — ``fma(-a_h[j]/p, colk[i], T[i][j])``, solver.cu:43,55 — where the
    NumPy/BLAS path rounds the product and the subtraction separately. A
    rank-1 update has no accumulation order, so that single rounding is
    the only arithmetic difference; with it closed, pivot-count parity
    extends beyond the 2048-class boundary (tests/test_parity.py)."""
    a_h = t.T[h, :].copy()
    p = a_h[k]
    colk = t.T[:, k].copy()
    bk = t.b[k]
    factor = a_h / p
    if fma:
        from .utils import fma_native

        u = minc / p
        fma_native.pivot_update_fma(t.T, colk, factor, k, p)
        fma_native.axpy_fma(t.b, factor, -bk)
        t.b[k] = bk / p
        fma_native.axpy_fma(t.costs, colk, -u)
        t.z = fma_native.fma_scalar(-u, bk, t.z)
        t.base[k] = h
        return
    if _dger is not None and t.T.flags.c_contiguous:
        # T -= outer(colk, factor), in place: T.T is an F-order view, so
        # dger(-1, factor, colk, a=T.T) updates T without a temporary.
        _dger(-1.0, factor, colk, a=t.T.T, overwrite_a=1)
    else:
        t.T -= np.outer(colk, factor)
    t.T[:, k] = colk / p
    t.b -= bk * factor
    t.b[k] = bk / p
    t.costs -= (minc / p) * colk
    t.z -= (minc / p) * bk
    t.base[k] = h


def _solve_loop(t: _Tableau, enter_mask, options: SolverOptions,
                max_iter: int, tie_rule: str = "lowest",
                fma: bool = False) -> tuple[Status, int]:
    """The hot loop (reference solve, solver.cu:78-149): entering argmin ->
    unboundedness test -> min-ratio leaving test -> rank-1 update. Adds the
    Bland fallback after ``bland_threshold`` consecutive non-improving
    pivots and an iteration fuse (no reference equivalents)."""
    eps = options.eps_resolved
    bland = options.pivot_rule_resolved == "bland"
    devex = options.pivot_rule_resolved == "devex"
    # Devex reference-framework weights (Forrest & Goldfarb 1992), one
    # per stored variable row, re-initialised to 1 whenever they drift
    # too far from the reference framework.
    weights = np.ones(t.costs.shape[0]) if devex else None
    stall = 0
    for it in range(max_iter):
        h, minc = _entering(t.costs, enter_mask, eps, bland, tie_rule,
                            weights=None if bland else weights)
        if h < 0:
            return Status.OPTIMAL, it
        a_h = t.T[h, :]
        ratio_mask = a_h >= eps
        if not ratio_mask.any():
            return Status.UNBOUNDED, it
        if tie_rule == "cuda":
            from .utils.cuda_order import cuda_ratio_argmin

            k, _ = cuda_ratio_argmin(t.b, a_h, eps)
        else:
            ratios = np.where(ratio_mask,
                              t.b / np.where(ratio_mask, a_h, 1.0), np.inf)
            k = int(np.argmin(ratios))
        z_before = t.z
        if devex:
            # Weight update BEFORE the pivot mutates T: alpha is the
            # leaving row over all variables (our colk), l the variable
            # leaving the basis.
            colk = t.T[:, k]
            p = a_h[k]
            l = int(t.base[k])
            wh = weights[h]
            alpha = colk / p
            np.maximum(weights, alpha * alpha * wh, out=weights)
            if l < weights.shape[0]:
                weights[l] = max(wh / (p * p), 1.0)
            np.minimum(weights, 1e12, out=weights)   # overflow cap
            weights[np.isnan(weights)] = 1.0
            if weights.max() > 1e8:    # re-anchor the framework
                weights[:] = 1.0
        _pivot(t, h, k, minc, fma=fma)
        if options.pivot_rule_resolved != "bland" and options.bland_threshold:
            if abs(t.z - z_before) < eps:
                stall += 1
                if stall >= options.bland_threshold:
                    bland = True
            else:
                stall = 0
                bland = False
    return Status.MAXITER, max_iter


def _pivot_out_artificials(t: _Tableau, n: int, m: int, eps: float,
                           fma: bool = False) -> None:
    """Drive zero-valued artificial variables out of the Phase-1 basis so
    Phase 2 can proceed (north-star extension; the reference instead returns
    DEGENERATE and aborts, twoPhaseMethod.cu:270-282). For each basic
    artificial row, pivot in any non-artificial variable with a nonzero
    coefficient; if the row has none it is a redundant constraint and is
    zeroed out (excluded from future ratio tests)."""
    for k in range(m):
        if t.base[k] < n + m:
            continue
        row = t.T[:n + m, k]
        candidates = np.nonzero(np.abs(row) >= eps)[0]
        if candidates.size:
            h = int(candidates[0])
            # Degenerate pivot: b[k] ~ 0, so feasibility is preserved even
            # for a negative pivot element.
            _pivot(t, h, k, float(t.costs[h]), fma=fma)
        else:
            t.T[:, k] = 0.0
            t.b[k] = 0.0


def solve_oracle(problem: Problem,
                 options: SolverOptions = DEFAULT_OPTIONS,
                 tie_rule: str = "lowest",
                 update_rule: str = "blas") -> SolveResult:
    """Two-phase simplex, host NumPy (reference twoPhaseMethod,
    twoPhaseMethod.cu:385-435). ``tie_rule='cuda'`` replays the reference
    GPU's eps-tie reduction order for pivot-count parity;
    ``update_rule='fma'`` additionally replays the GPU's per-element fma
    rounding in the rank-1 update (native/fma_update.cpp — needed for
    exact pivot counts past the 2048-class boundary, where the eps-tie
    pattern becomes last-ulp sensitive; ~3x slower than BLAS dger)."""
    assert update_rule in ("blas", "fma"), update_rule
    fma = update_rule == "fma"
    if fma:
        from .utils import fma_native

        if not fma_native.available():
            raise RuntimeError(
                "update_rule='fma' needs the native helper "
                "(simplex_tpu_torch/native/fma_update.cpp) and no C++ "
                "compiler is available to build it; use "
                "update_rule='blas' or install g++")
    m, n = problem.constraints, problem.vars
    eps = float(options.eps_resolved)
    R = n + 2 * m
    max_iter = options.resolved_max_iter(R, m)

    # ---- Phase 1 (twoPhaseMethod.cu:225-283) ----
    t = _build_phase1(problem, eps)
    _gaussian_eliminate(t)
    mask1 = np.ones(R, dtype=bool)
    status1, iters1 = _solve_loop(t, mask1, options, max_iter, tie_rule,
                                  fma=fma)
    if status1 == Status.MAXITER:
        return SolveResult(Status.MAXITER, None, float(t.z), iters1, 0)
    # Infeasibility test: SAME semantics as the device core
    # (two_phase.solve_device) — the phase-1 objective recomputed exactly
    # from the final basis (-sum of basic artificials' values; immune to
    # the running cell's per-pivot drift), against a threshold scaled by
    # the right-hand side's magnitude: an artificial residual of ~1e-9
    # relative to b values of ~100 is a degenerate zero, not
    # infeasibility. (The reference instead reads the incrementally
    # updated costs[0] against an absolute eps, twoPhaseMethod.cu:264-268;
    # the two rules agree except on knife-edge residuals within
    # eps * max|b| of zero — pinned by tests/test_degeneracy.py.)
    z1 = -float(t.b[t.base >= n + m].sum())
    b_scale = 1.0 + float(np.max(np.abs(problem.b)))
    if z1 <= -eps * b_scale:
        return SolveResult(Status.INFEASIBLE, None, z1, iters1, 0)

    degenerate = bool((t.base >= n + m).any())
    if degenerate and options.degeneracy == "reference":
        return SolveResult(Status.DEGENERATE, None, float(t.z), iters1, 0,
                           degenerate=True)
    if degenerate:
        _pivot_out_artificials(t, n, m, eps, fma=fma)

    # ---- Phase 2 (twoPhaseMethod.cu:285-356) ----
    # Truncate the artificial block (rows -= cols, twoPhaseMethod.cu:288),
    # rebuild costs = [-c | 0] keeping the phase-1 objective cell
    # (twoPhaseMethod.cu:296-325), re-eliminate, re-solve.
    R2 = n + m
    t2 = _Tableau(t.T[:R2], t.b, np.concatenate(
        [-problem.c.astype(np.float64), np.zeros(m)]), t.z, t.base)
    _gaussian_eliminate(t2)
    mask2 = np.ones(R2, dtype=bool)
    status2, iters2 = _solve_loop(t2, mask2, options, max_iter, tie_rule,
                                  fma=fma)
    if status2 != Status.OPTIMAL:
        return SolveResult(status2, None, float(t2.z), iters1, iters2,
                           degenerate=degenerate)

    # ---- Solution extraction (twoPhaseMethod.cu:370-383):
    # x[base[k]] = b[k] for basic structural variables.
    x = np.zeros(n, dtype=np.float64)
    structural = t2.base < n
    x[t2.base[structural]] = t2.b[structural]
    return SolveResult(Status.OPTIMAL, x, float(t2.z), iters1, iters2,
                       degenerate=degenerate)
