"""Solve result container shared by the oracle and the TPU solver."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .config import Status


@dataclasses.dataclass
class SolveResult:
    """Outcome of a two-phase solve.

    Mirrors the reference's output surface (status code + solution vector +
    optimal value, twoPhaseMethod.h:19, twoPhaseMethod.cu:370-383) and adds
    iteration counts and a degeneracy flag (the reference conflates
    "degenerate" with a status that aborts the solve; here a degenerate
    phase-1 basis is reported but — by default — still solved through).
    """

    status: Status
    #: (vars,) optimal x, zeros unless status == OPTIMAL.
    x: Optional[np.ndarray]
    #: Optimal objective (reference convention: tableau cell costs[0]).
    objective: float
    #: Pivot iterations per phase.
    iterations_phase1: int = 0
    iterations_phase2: int = 0
    #: Artificial variables left in the phase-1 basis (reference
    #: checkDegeneracy, twoPhaseMethod.cu:206-223).
    degenerate: bool = False
    #: f64 basis-refinement record (refine.RefineInfo) when the solve
    #: went through solution refinement; None otherwise (f64 parity
    #: mode, non-OPTIMAL statuses, refinement disabled).
    refine: Optional[object] = None

    @property
    def iterations(self) -> int:
        return self.iterations_phase1 + self.iterations_phase2
