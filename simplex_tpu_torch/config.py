"""Numerics config and solver options for the PyTorch port.

Same surface as ``simplex_tpu.config``: the ``Status`` codes, the ``EPS*``
constants, ``SolverOptions`` with its raw-plus-resolved ``eps`` /
``pivot_rule`` fields, and the ``refine_enabled`` / ``normalize_enabled``
resolvers. The one change is the kernel gate: the JAX package asks for a
TPU backend before it takes the fused blocked-kernel loop, while the port
is told its device explicitly, so ``kernel_blocked_enabled`` is
eligibility alone.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Union

import numpy as np

#: Epsilon used by every comparison in the f64 solver.
EPS = 1e-9

#: Default epsilon for float32 tableaus: an f32 tableau carries ~1e-6
#: relative noise in every re-priced reduced cost, so a 1e-9 discipline
#: sees noise as eligible entering columns and pivots degenerately at the
#: optimal vertex until the iteration fuse.
EPS_F32 = 1e-4

#: Relative pricing floor for f32 tableaus under cost normalization: a
#: reduced cost below EPS_REL_F32 * (1 + max|costs|) is data-precision
#: noise of an f32 tableau.
EPS_REL_F32 = 1e-7


class Status(enum.IntEnum):
    """Solver exit statuses (same codes as ``simplex_tpu.config.Status``)."""

    OPTIMAL = 0
    INFEASIBLE = -1
    UNBOUNDED = -2
    DEGENERATE = -3    # artificial variable left in base (reference policy)
    MAXITER = -4       # iteration fuse tripped
    NUMERIC = -5       # non-finite tableau state detected
    RUNNING = -10      # internal: loop not finished

    @property
    def message(self) -> str:
        return {
            Status.OPTIMAL: "Problem solved!",
            Status.INFEASIBLE: "Problem INFEASIBLE!",
            Status.UNBOUNDED: "Problem UNBOUNDED!",
            Status.DEGENERATE: "Problem DEGENERATE!",
            Status.MAXITER: "Iteration limit reached!",
            Status.NUMERIC: "Numerical failure (non-finite tableau)!",
            Status.RUNNING: "Still running",
        }[self]


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Options controlling the two-phase solve; fields, defaults and
    resolution rules are those of ``simplex_tpu.SolverOptions`` (see its
    docstrings for the measured reasons behind each default).

    ``two_phase.solve`` runs every option set: ``run_solve_loop``
    dispatches the fused blocked-kernel loop, the plain blocked loop and
    the sequential loops (over K6 or not) as the JAX package does, and
    ``equilibrate`` scales the problem (``scaling.py``). As in the JAX
    package only ``solve`` reads ``equilibrate``."""

    #: Tableau dtype.
    dtype: np.dtype = np.dtype(np.float64)
    #: Comparison epsilon; None resolves by tableau dtype (EPS for f64,
    #: EPS_F32 for f32) into ``eps_resolved``.
    eps: Optional[float] = None
    #: Derived: ``eps`` resolved against the tableau dtype.
    eps_resolved: float = dataclasses.field(init=False, repr=False,
                                            compare=False)
    #: Dtype of b, the reduced costs and z at the tableau boundary
    #: (defaults to ``dtype``). Inside the kernel loop the port keeps
    #: them in f64 whatever this says.
    vector_dtype: Optional[np.dtype] = None
    #: Scale-aware pricing for low-precision tableaus ("auto": f32 only).
    normalize_costs: Union[str, bool] = "auto"
    #: Pivot fuse per phase; None -> 50 * (rows + cols).
    max_iter: Optional[int] = None
    #: 'dantzig', 'devex' or 'bland'; None resolves by mode into
    #: ``pivot_rule_resolved`` (devex for f32 blocked, else dantzig).
    pivot_rule: Optional[str] = None
    #: Derived: ``pivot_rule`` resolved against the mode.
    pivot_rule_resolved: str = dataclasses.field(init=False, repr=False,
                                                 compare=False)
    #: Consecutive non-improving pivots before switching to Bland.
    bland_threshold: Optional[int] = 50
    #: 'continue' (pivot artificials out after phase 1) or 'reference'.
    degeneracy: str = "continue"
    #: Kernel switch: False selects the plain loops (no kernel); True
    #: takes K6 on a pure-f32 sequential tableau.
    use_pallas: str | bool = "auto"
    #: Deferred block pivoting window length L.
    block_pivots: Optional[int] = None
    #: Exact window-boundary re-pricing cadence (windows).
    reprice_every: int = 2
    #: Window length of the batched kernel (validated for parity only).
    batch_block_pivots: Optional[int] = None
    #: f64 basis refinement at extraction ("auto": mixed mode only).
    refine: Union[str, bool] = "auto"
    #: Iterative-refinement sweeps of the LU refinement path.
    refine_iters: int = 3
    #: Scale-relative certificate tolerance.
    refine_tol: float = 1e-6
    #: Power-of-two equilibration (``two_phase.solve`` only).
    equilibrate: bool = False
    #: Pad the constraint axis to a multiple of this.
    lane_pad: int = 128
    #: Pad the variable axis to a multiple of this (128 on the kernel
    #: path, see tableau.padded_dims).
    sublane_pad: int = 8

    def resolved_max_iter(self, rows: int, cols: int) -> int:
        if self.max_iter is not None:
            return int(self.max_iter)
        return 50 * (rows + cols)

    def __post_init__(self):
        if self.pivot_rule not in (None, "dantzig", "devex", "bland"):
            raise ValueError(f"unknown pivot_rule {self.pivot_rule!r}")
        if self.degeneracy not in ("continue", "reference"):
            raise ValueError(f"unknown degeneracy policy {self.degeneracy!r}")
        if int(self.reprice_every) < 1:
            raise ValueError(
                f"reprice_every must be >= 1, got {self.reprice_every}")
        if self.refine not in ("auto", True, False):
            raise ValueError(f"refine must be 'auto'/True/False, "
                             f"got {self.refine!r}")
        if int(self.refine_iters) < 1:
            raise ValueError(
                f"refine_iters must be >= 1, got {self.refine_iters}")
        if not (float(self.refine_tol) > 0.0):
            raise ValueError(
                f"refine_tol must be > 0, got {self.refine_tol}")
        if self.batch_block_pivots is not None and (
                int(self.batch_block_pivots) < 8
                or int(self.batch_block_pivots) > 128
                or int(self.batch_block_pivots) % 8):
            raise ValueError(
                "batch_block_pivots must be a multiple of 8 in [8, 128], "
                f"got {self.batch_block_pivots}")
        object.__setattr__(self, "dtype", np.dtype(self.dtype))
        object.__setattr__(
            self, "vector_dtype",
            np.dtype(self.vector_dtype) if self.vector_dtype is not None
            else np.dtype(self.dtype))
        object.__setattr__(
            self, "eps_resolved",
            float(self.eps) if self.eps is not None
            else (EPS if self.dtype.itemsize == 8 else EPS_F32))
        if self.pivot_rule is not None:
            resolved_rule = self.pivot_rule
        elif (self.block_pivots and int(self.block_pivots) > 1
                and self.dtype.itemsize == 4):
            resolved_rule = "devex"
        else:
            resolved_rule = "dantzig"
        object.__setattr__(self, "pivot_rule_resolved", resolved_rule)


def refine_enabled(options: SolverOptions) -> bool:
    """'auto' means the mixed production mode only (f32 tableau + f64
    vectors)."""
    if options.refine == "auto":
        return (np.dtype(options.dtype).itemsize == 4
                and np.dtype(options.vector_dtype).itemsize == 8)
    return bool(options.refine)


def normalize_enabled(options: SolverOptions) -> bool:
    """'auto' means f32 tableaus only."""
    if options.normalize_costs == "auto":
        return np.dtype(options.dtype).itemsize == 4
    return bool(options.normalize_costs)


def kernel_blocked_enabled(options: SolverOptions) -> bool:
    """True when the options select the fused blocked-kernel loop: blocked
    mode, f32 tableau, kernels not switched off, and a window length the
    kernels take (a multiple of 8). The JAX package also asks for a TPU
    backend here; the port's device is explicit, so eligibility is the
    whole gate."""
    L = int(options.block_pivots or 1)
    if L <= 1 or L % 8:
        return False
    if np.dtype(options.dtype).itemsize != 4:
        return False
    return options.use_pallas == "auto" or bool(options.use_pallas)


DEFAULT_OPTIONS = SolverOptions()
