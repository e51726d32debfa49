"""Power-of-two equilibration for extreme-magnitude LPs.

Port of ``simplex_tpu.scaling`` (host NumPy), with its docstrings written
from the code. Geometric row and column equilibration, every factor
rounded to a power of two, applied on the host before the solve and
unwound after it (``two_phase.solve(equilibrate=True)``).

A power-of-two factor changes only exponents, so every scaled
coefficient is exact. Row scaling ``(A_i, b_i) * r_i`` leaves the
feasible set as it is; column scaling substitutes ``x_j = s_j x'_j``
(column j of A and c_j scale by s_j, and the solution unwinds as ``x = s
* x'``). Statuses are invariant, and ``c' @ x' = c @ x``.

How ``solve`` uses it: it solves the scaled problem, refines and
certifies in scaled space against the scaled problem's f64 data (the
finishing tiers too run on the scaled problem), and then unwinds the
certified values with ``unwind_result``: ``x = col * x'`` and the
objective recomputed as ``c @ x`` in original units. A result that is
not refined unwinds the same way. A non-OPTIMAL result keeps its
objective (a phase-1 value) in scaled units. The eps discipline applies
in scaled units.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

from .problem import Problem


class Scaling(NamedTuple):
    """The factors of one equilibration: ``A' = diag(row) @ A @
    diag(col)``, ``b' = row * b``, ``c' = col * c``; unwind ``x = col *
    x'``."""

    row: np.ndarray    # (m,) powers of two, > 0
    col: np.ndarray    # (n,) powers of two, > 0


def _pow2(scale: np.ndarray) -> np.ndarray:
    """The power of two nearest to ``1 / scale`` (by rounding log2),
    1 where ``scale`` is zero or not finite, exponents clipped to
    [-1000, 1000]."""
    with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
        e = np.round(np.log2(scale))
    e = np.where(np.isfinite(e), e, 0.0)
    return np.exp2(-np.clip(e, -1000, 1000))


def equilibrate(problem: Problem, sweeps: int = 2
                ) -> tuple[Problem, Scaling]:
    """Geometric equilibration: ``sweeps`` rounds of rows then columns,
    each line scaled by the power of two nearest to ``1 / sqrt(max *
    min)`` of its nonzero magnitudes (rows over ``[A | b]``, so that a
    lone huge b_i normalizes too; columns over A). Returns the scaled
    problem and the accumulated factors."""
    A = problem.A.astype(np.float64, copy=True)
    b = problem.b.astype(np.float64, copy=True)
    c = problem.c.astype(np.float64, copy=True)
    m, n = A.shape
    row = np.ones(m)
    col = np.ones(n)

    def geo(M, axis):
        absM = np.abs(M)
        mx = absM.max(axis=axis)
        with np.errstate(invalid="ignore"):
            mn = np.where(absM > 0, absM, np.inf).min(axis=axis)
        mn = np.where(np.isfinite(mn), mn, 1.0)
        return np.sqrt(mx * mn)

    for _ in range(int(sweeps)):
        r = _pow2(geo(np.concatenate([A, b[:, None]], axis=1), 1))
        A *= r[:, None]
        b *= r
        row *= r
        s = _pow2(geo(A, 0))
        A *= s[None, :]
        c *= s
        col *= s

    return Problem(A=A, b=b, c=c), Scaling(row=row, col=col)


def unwind_result(result, scaling: Scaling, problem: Problem):
    """A scaled-space SolveResult in original units: ``x = col * x'`` and
    the objective recomputed as ``problem.c @ x`` in f64, whether or not
    the result was refined (its RefineInfo is kept as it is, in scaled
    units). A result without x (not OPTIMAL) is returned unchanged."""
    if result.x is None:
        return result
    x = scaling.col * np.asarray(result.x, np.float64)
    objective = float(problem.c @ x)
    return dataclasses.replace(result, x=x, objective=objective)
