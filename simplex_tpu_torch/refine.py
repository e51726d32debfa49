"""f64 basis refinement at solution extraction.

Port of ``simplex_tpu.refine``: after a mixed-precision solve, the final
*basis* is rebuilt from the original f64 problem data and its systems
``B x_B = b`` and ``B^T y = c_B`` are solved to f64 round-off by
iterative refinement, then certified:

* ``refine_solution_tableau`` preconditions the refinement with the
  final tableau's slack block, which is ``B^{-1}`` up to the solve's f32
  drift (no factorization);
* ``refine_solution`` factorizes ``B`` in f32 (LU) and refines in f64 --
  the retry when the slack-block refinement does not certify.

Plain torch f64 operations on the solve's device (the JAX package leaves
these to XLA; none is a Pallas kernel). The slack block here is
``Tt[:m, n:n+m]``, which is ``B^{-1}`` itself; the JAX package passes
its transpose ``T[n:n+m, :m]``. Every residual is formed in f64.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class RefineOutput(NamedTuple):
    """Refined solution and f64 certificates (tensors on the solve's
    device; ``certificates_pass`` normalizes the scales)."""

    x: torch.Tensor                  # (n,) refined solution
    objective: torch.Tensor          # c @ x
    primal_residual: torch.Tensor    # max |B x_B - b|
    primal_negativity: torch.Tensor  # max(0, -min x_B)
    artificial_mass: torch.Tensor    # max |x_B| over artificial/dropped slots
    dual_infeasibility: torch.Tensor  # max(0, -min d) over nonbasic columns
    y: torch.Tensor                  # (m,) dual vector
    xB: torch.Tensor                 # (m,) basic values


class RefineInfo(NamedTuple):
    """Host-side refinement record attached to SolveResult (fields of
    ``simplex_tpu.refine.RefineInfo``)."""

    certified: bool
    primal_residual: float
    primal_negativity: float
    artificial_mass: float
    dual_infeasibility: float
    tol: float
    fallback: bool = False
    #: "tableau" (slack-block preconditioner), "lu" (f32 LU + IR) or
    #: "restart" (certified after a reinversion restart).
    method: str = "lu"
    #: refined - raw objective (telemetry).
    objective_shift: float = 0.0
    #: Wall seconds of the refinement stage.
    wall_s: float = 0.0


class _Basis:
    """Index bookkeeping of a basis ``v = base[:m]`` in the tableau's
    variable numbering: [0, n) structural, [n, n+m) slack, anything else
    artificial or a dropped redundant row."""

    def __init__(self, base: torch.Tensor, n: int, m: int, device):
        v = base[:m].to(device=device, dtype=torch.int64)
        self.n, self.m = n, m
        self.v = v
        self.struct = v < n
        self.slack = (v >= n) & (v < n + m)
        self.aux = ~(self.struct | self.slack)
        self.unit = torch.where(self.slack, v - n,
                                torch.arange(m, device=device))
        self.vc = v.clamp(0, n - 1)
        self.sv = torch.where(self.struct, v, n)      # structural slot

    def scatter_x(self, xB: torch.Tensor) -> torch.Tensor:
        """x (n,) with the basic structural values in place."""
        x = torch.zeros(self.n + 1, dtype=xB.dtype, device=xB.device)
        x[self.sv] = torch.where(self.struct, xB, 0.0)
        return x[:self.n]

    def apply_B(self, A: torch.Tensor, xB: torch.Tensor) -> torch.Tensor:
        """B @ xB: structural columns through one A matvec, slack and
        auxiliary columns through unit rows."""
        x = torch.zeros(self.n + 1, dtype=xB.dtype, device=xB.device)
        x.index_add_(0, self.sv, torch.where(self.struct, xB, 0.0))
        s = torch.zeros(self.m + 1, dtype=xB.dtype, device=xB.device)
        s.index_add_(0, torch.where(self.struct, self.m, self.unit),
                     torch.where(self.struct, 0.0, xB))
        return A @ x[:self.n] + s[:self.m]

    def apply_Bt(self, A: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """B^T @ y: column k of B dotted with y."""
        return torch.where(self.struct, (A.t() @ y)[self.vc], y[self.unit])

    def matrix(self, A: torch.Tensor) -> torch.Tensor:
        """B (m, m) in A's dtype."""
        eye = torch.eye(self.m, dtype=A.dtype, device=A.device)
        Bt = torch.where(self.struct[:, None], A.t()[self.vc],
                         eye[self.unit])
        return Bt.t().contiguous()

    def certify(self, A, c, xB, y, primal_residual) -> RefineOutput:
        """Reduced costs ``d = [A^T y - c ; y]`` over the nonbasic
        columns, the scatter of x and the certificates."""
        n, m = self.n, self.m
        dev = xB.device
        d_struct = A.t() @ y - c
        nb_struct = torch.ones(n + 1, dtype=torch.bool, device=dev)
        nb_struct[self.sv] = False
        nb_slack = torch.ones(m + 1, dtype=torch.bool, device=dev)
        nb_slack[torch.where(self.slack, self.v - n, m)] = False
        d_min = torch.minimum(
            torch.where(nb_struct[:n], d_struct, torch.inf).min(),
            torch.where(nb_slack[:m], y, torch.inf).min())
        x = self.scatter_x(xB)
        return RefineOutput(
            x=x, objective=c @ x, primal_residual=primal_residual,
            primal_negativity=torch.clamp(-xB.min(), min=0.0),
            artificial_mass=torch.where(self.aux, xB.abs(), 0.0).max(),
            dual_infeasibility=torch.clamp(-d_min, min=0.0), y=y, xB=xB)


def refine_solution_tableau(A: torch.Tensor, b: torch.Tensor,
                            c: torch.Tensor, base: torch.Tensor,
                            binv: torch.Tensor, n: int, m: int,
                            iters: int = 8) -> RefineOutput:
    """LU-free refinement preconditioned by the final tableau's slack
    block ``binv = Tt[:m, n:n+m]`` (``B^{-1}`` up to drift): each sweep
    ``x_B += binv @ (b - B x_B)`` and ``y += binv^T (c_B - B^T y)``.
    ``A`` (m, n), ``b``, ``c`` are the original problem data on the
    device; all arithmetic is f64."""
    f64 = torch.float64
    dev = A.device
    A = A.to(f64)
    b = b.to(f64)
    c = c.to(f64)
    M = binv.to(f64)
    basis = _Basis(base, n, m, dev)

    xB = torch.zeros(m, dtype=f64, device=dev)
    for _ in range(iters):
        xB = xB + M @ (b - basis.apply_B(A, xB))
    primal_residual = (b - basis.apply_B(A, xB)).abs().max()

    c_B = torch.where(basis.struct, c[basis.vc], 0.0)
    y = torch.zeros(m, dtype=f64, device=dev)
    for _ in range(iters):
        y = y + M.t() @ (c_B - basis.apply_Bt(A, y))
    return basis.certify(A, c, xB, y, primal_residual)


def refine_solution(A: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                    base: torch.Tensor, n: int, m: int,
                    iters: int = 3) -> RefineOutput:
    """Refinement with an f32 LU of ``B`` and f64 residuals: the retry
    when the slack-block refinement does not certify (a redundant-row
    drop leaves the block singular along one direction)."""
    f64 = torch.float64
    dev = A.device
    A = A.to(f64)
    b = b.to(f64)
    c = c.to(f64)
    basis = _Basis(base, n, m, dev)
    B = basis.matrix(A)
    LU, piv = torch.linalg.lu_factor(B.float())

    def correct(r, adjoint):
        return torch.linalg.lu_solve(LU, piv, r.float()[:, None],
                                     adjoint=adjoint)[:, 0].to(f64)

    xB = correct(b, False)
    for _ in range(iters):
        xB = xB + correct(b - B @ xB, False)
    primal_residual = (b - B @ xB).abs().max()

    c_B = torch.where(basis.struct, c[basis.vc], 0.0)
    y = correct(c_B, True)
    for _ in range(iters):
        y = y + correct(c_B - B.t() @ y, True)
    return basis.certify(A, c, xB, y, primal_residual)


def refine_solution_host(A, b, c, base, n: int, m: int
                         ) -> RefineOutput | None:
    """Straight f64 solve of one basis on the host with NumPy/LAPACK
    (``simplex_tpu.refine.refine_solution_host``): LAPACK factorizes in
    f64, so no iterative refinement is needed. The batched solve uses it
    because the device copy of A was cast to the tableau dtype for the
    transfer, while the f64 problem data is on the host anyway. Returns
    None for a singular or non-finite basis system (the certificates
    could never pass); else a RefineOutput of CPU f64 tensors."""
    A = np.asarray(A, np.float64)
    b = np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    v = np.asarray(base[:m], np.int64)

    struct = v < n
    slack = (v >= n) & (v < n + m)
    aux = ~(struct | slack)
    unit = np.where(slack, v - n, np.arange(m))
    Bt = np.eye(m)[unit]
    Bt[struct] = A.T[v[struct]]
    B = Bt.T

    c_B = np.where(struct, c[np.clip(v, 0, n - 1)], 0.0)
    try:
        xB = np.linalg.solve(B, b)
        y = np.linalg.solve(B.T, c_B)
    except np.linalg.LinAlgError:
        return None
    if not (np.isfinite(xB).all() and np.isfinite(y).all()):
        return None

    d_struct = A.T @ y - c
    nonbasic_struct = np.ones(n, bool)
    nonbasic_struct[v[struct]] = False
    nonbasic_slack = np.ones(m, bool)
    nonbasic_slack[unit[slack]] = False
    cands = np.concatenate([d_struct[nonbasic_struct], y[nonbasic_slack]])
    d_min = float(cands.min()) if cands.size else 0.0

    x = np.zeros(n)
    x[v[struct]] = xB[struct]

    def f64(val):
        return torch.as_tensor(val, dtype=torch.float64)

    return RefineOutput(
        x=f64(x), objective=f64(c @ x),
        primal_residual=f64(np.max(np.abs(b - B @ xB)) if m else 0.0),
        primal_negativity=f64(max(0.0, -xB.min()) if m else 0.0),
        artificial_mass=f64(np.max(np.abs(xB[aux]), initial=0.0)),
        dual_infeasibility=f64(max(0.0, -d_min)), y=f64(y), xB=f64(xB))


def refine_solution_tableau_host(A, b, c, base, binv_t, n: int, m: int,
                                 iters: int = 8) -> RefineOutput:
    """NumPy version of ``refine_solution_tableau`` for host callers
    (``simplex_tpu.refine.refine_solution_tableau_host``): the warm finish
    certifies its basis with its own f64 tableau's slack block, and the
    full f64 re-solve of ``two_phase.fallback_solve`` with the card's
    final slack block. ``binv_t`` is that block in the JAX layout,
    ``B^{-T}`` (the port's ``Tt[:m, n:n+m].T``). Returns a RefineOutput of
    CPU f64 tensors."""
    A = np.asarray(A, np.float64)
    b = np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    Mt = np.asarray(binv_t, np.float64)
    v = np.asarray(base, np.int64)[:m]

    struct = v < n
    slack = (v >= n) & (v < n + m)
    aux = ~(struct | slack)
    unit = np.where(slack, v - n, np.arange(m))

    def apply_B(xB):
        x_full = np.zeros(n)
        np.add.at(x_full, v[struct], xB[struct])
        s_full = np.zeros(m)
        np.add.at(s_full, unit[~struct], xB[~struct])
        return A @ x_full + s_full

    def apply_Bt(y):
        w = A.T @ y
        return np.where(struct, w[np.clip(v, 0, n - 1)], y[unit])

    xB = np.zeros(m)
    for _ in range(iters):
        xB = xB + (b - apply_B(xB)) @ Mt
    primal_residual = float(np.max(np.abs(b - apply_B(xB)))) if m else 0.0

    c_B = np.where(struct, c[np.clip(v, 0, n - 1)], 0.0)
    y = np.zeros(m)
    for _ in range(iters):
        y = y + Mt @ (c_B - apply_Bt(y))

    d_struct = A.T @ y - c
    nonbasic_struct = np.ones(n, bool)
    nonbasic_struct[v[struct]] = False
    nonbasic_slack = np.ones(m, bool)
    nonbasic_slack[unit[slack]] = False
    cands = np.concatenate([d_struct[nonbasic_struct], y[nonbasic_slack]])
    d_min = float(cands.min()) if cands.size else 0.0

    x = np.zeros(n)
    x[v[struct]] = xB[struct]

    def f64(val):
        return torch.as_tensor(val, dtype=torch.float64)

    return RefineOutput(
        x=f64(x), objective=f64(c @ x), primal_residual=f64(primal_residual),
        primal_negativity=f64(max(0.0, -xB.min()) if m else 0.0),
        artificial_mass=f64(np.max(np.abs(xB[aux]), initial=0.0)),
        dual_infeasibility=f64(max(0.0, -d_min)), y=f64(y), xB=f64(xB))


def certificates_pass(out: RefineOutput, b, c, tol: float) -> bool:
    """Scale-relative certification (``simplex_tpu.refine``): the primal
    residual, negativity and artificial mass against ``1 + max|b|``, the
    dual infeasibility against ``1 + max|c| + max|y|``."""
    b_scale = 1.0 + float(np.max(np.abs(b))) if np.size(b) else 1.0
    c_scale = 1.0 + float(np.max(np.abs(c))) if np.size(c) else 1.0
    vals = torch.stack([out.primal_residual, out.primal_negativity,
                        out.artificial_mass, out.dual_infeasibility,
                        out.y.abs().max()]).tolist()
    pr, neg, art, dual, ymax = vals
    d_scale = c_scale + ymax
    return (pr <= tol * b_scale and neg <= tol * b_scale
            and art <= tol * b_scale and dual <= tol * d_scale)
