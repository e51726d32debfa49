"""Device tableau, stored transposed.

Port of ``simplex_tpu.tableau``. The JAX package keeps ``T (R_pad,
M_pad)`` variable-major and its blocked loop transposes it on entry and
again on exit. The port stores the transposed tableau ``Tt (M_pad,
R_pad)`` -- ``Tt[j, i]`` is the coefficient of variable ``i`` in
constraint ``j`` -- from the build on, so one copy exists at any time:

* the structural block is ``Tt[:m, :n] = A * sign`` (A is already
  constraint-major, so the build copies it without a transpose);
* the slack block that refinement reads is ``Tt[:m, n:n+m]``, which is
  ``B^{-1}`` of the final basis in exact arithmetic (the JAX package reads
  its transpose ``T[n:n+m, :m]``).

b, the reduced costs and z carry the options' vector dtype; ``base`` is
int32. The variable axis pads to 128 whenever the blocked-kernel loop is
selected, on every device, so the CPU tests and the card see the same
shapes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import SolverOptions, kernel_blocked_enabled

#: Row chunk (bytes of the f64 temporary) of the f64 matvecs over Tt.
MATVEC_CHUNK_BYTES = 1 << 28


def round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


@dataclasses.dataclass
class Tableau:
    """Solver state: ``Tt (M_pad, R_pad)``, ``b (M_pad,)``, ``costs
    (R_pad,)``, ``z ()``, ``base (M_pad,) int32``; ``n`` structural
    variables, ``m`` constraints, ``r`` active variables (n + 2m in phase
    1, n + m in phase 2)."""

    Tt: torch.Tensor
    b: torch.Tensor
    costs: torch.Tensor
    z: torch.Tensor
    base: torch.Tensor
    n: int
    m: int
    r: int

    @property
    def rows_padded(self) -> int:
        """R_pad: the padded variable axis (the JAX ``T.shape[0]``)."""
        return self.Tt.shape[1]


def padded_dims(n: int, m: int,
                options: SolverOptions) -> tuple[int, int, int]:
    """(R1_pad, R2_pad, M_pad) for phase-1 rows n+2m, phase-2 rows n+m."""
    sub = options.sublane_pad
    if kernel_blocked_enabled(options):
        sub = max(sub, 128)
    return (round_up(n + 2 * m, sub), round_up(n + m, sub),
            round_up(m, options.lane_pad))


def tt_matvec(Tt: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``Tt^T @ v`` (R_pad,) accumulated in v's dtype, in row chunks so
    that no widened copy of the whole tableau is materialised."""
    if Tt.dtype == v.dtype:
        return v @ Tt
    m_pad, r_pad = Tt.shape
    chunk = max(1, MATVEC_CHUNK_BYTES // (r_pad * v.element_size()))
    out = torch.zeros(r_pad, dtype=v.dtype, device=Tt.device)
    for i in range(0, m_pad, chunk):
        out += v[i:i + chunk] @ Tt[i:i + chunk].to(v.dtype)
    return out


def build_phase1(A: torch.Tensor, b: torch.Tensor, n: int, m: int,
                 options: SolverOptions) -> Tableau:
    """Phase-1 tableau (``simplex_tpu.tableau.build_phase1``): variables
    [structural | slack | artificial], artificial basis, costs 1 on the
    artificials, and the sign fix for b <= -eps (structural and slack
    entries and b negated, artificials kept +1). ``A`` (m, n) and ``b``
    (m,) are tensors on the solve's device."""
    dtype = getattr(torch, options.dtype.name)
    vdtype = getattr(torch, options.vector_dtype.name)
    dev = A.device
    R_pad, _, M_pad = padded_dims(n, m, options)
    r = n + 2 * m

    b = b.to(vdtype)
    flip = b <= -options.eps_resolved
    sign = torch.where(flip, -1.0, 1.0).to(dtype)

    Tt = torch.zeros((M_pad, R_pad), dtype=dtype, device=dev)
    Tt[:m, :n].copy_(A)                  # in place: no (m, n) temporary
    Tt[:m, :n].mul_(sign[:, None])
    idx = torch.arange(m, device=dev)
    Tt[idx, n + idx] = sign
    Tt[idx, n + m + idx] = 1.0
    b_pad = torch.zeros(M_pad, dtype=vdtype, device=dev)
    b_pad[:m] = b * sign.to(vdtype)
    costs = torch.zeros(R_pad, dtype=vdtype, device=dev)
    costs[n + m:r] = 1.0
    base = torch.full((M_pad,), R_pad, dtype=torch.int32, device=dev)
    base[:m] = torch.arange(n + m, n + 2 * m, dtype=torch.int32, device=dev)
    return Tableau(Tt=Tt, b=b_pad, costs=costs,
                   z=torch.zeros((), dtype=vdtype, device=dev),
                   base=base, n=n, m=m, r=r)


def basic_costs(base: torch.Tensor, costs: torch.Tensor,
                r: int) -> torch.Tensor:
    """``costs[base]`` with out-of-range entries (padding, artificials past
    a truncated phase, dropped rows) contributing 0."""
    r_pad = costs.shape[0]
    idx = torch.clamp(base.long(), max=r_pad - 1)
    return torch.where(base < r, costs[idx], torch.zeros_like(costs[idx]))


def gaussian_eliminate(tab: Tableau) -> Tableau:
    """Objective-row elimination: ``costs -= Tt^T @ costs[base]``,
    ``z -= b @ costs[base]``, accumulated in the vector dtype."""
    coeffs = basic_costs(tab.base, tab.costs, tab.r)
    delta = tt_matvec(tab.Tt, coeffs)
    return dataclasses.replace(tab, costs=tab.costs - delta,
                               z=tab.z - tab.b @ coeffs)


def phase2_reset(tab: Tableau, c: torch.Tensor) -> Tableau:
    """Install the phase-2 objective (costs ``[-c | 0]``; z carries over).

    The artificial variables leave the active set through ``r = n + m``
    while the phase-1 allocation stays: trimming the variable axis of
    ``Tt`` would be a strided copy of the whole tableau. The JAX package
    does the same above 2 GB (``two_phase.py:182-184``); the artificial
    columns cost 2m/(n+2m) of the phase-2 window apply."""
    n, m = tab.n, tab.m
    costs = torch.zeros_like(tab.costs)
    costs[:n] = -c.to(costs.dtype)
    return dataclasses.replace(tab, costs=costs, r=n + m)


def extract_solution(tab: Tableau) -> torch.Tensor:
    """``x[base[k]] = b[k]`` for basic structural variables."""
    idx = torch.where(tab.base < tab.n, tab.base,
                      torch.full_like(tab.base, tab.n)).long()
    x_ext = torch.zeros(tab.n + 1, dtype=tab.b.dtype, device=tab.b.device)
    x_ext[idx] = tab.b
    return x_ext[:tab.n]


def phase1_objective(tab: Tableau) -> torch.Tensor:
    """Phase-1 objective of the current basis: minus the summed values of
    the basic artificials (drift-immune, unlike the running z)."""
    is_art = (tab.base >= tab.n + tab.m) & (tab.base < tab.n + 2 * tab.m)
    return -torch.where(is_art, tab.b, torch.zeros_like(tab.b)).sum()


def count_basic_artificials(tab: Tableau) -> int:
    """Artificial variables still in the base."""
    is_art = (tab.base >= tab.n + tab.m) & (tab.base < tab.n + 2 * tab.m)
    return int(is_art.sum())


def tableau_from_numpy(T, b, costs, z, base, n: int, m: int, r: int,
                       device="cpu") -> Tableau:
    """The port's Tableau from the JAX package's arrays in ITS layout
    (``T (R_pad, M_pad)``): lets a test start both loops from one
    tableau."""
    dev = torch.device(device)
    return Tableau(
        Tt=torch.from_numpy(np.ascontiguousarray(np.asarray(T).T)).to(dev),
        b=torch.from_numpy(np.array(b)).to(dev),
        costs=torch.from_numpy(np.array(costs)).to(dev),
        z=torch.from_numpy(np.array(z)).to(dev),
        base=torch.from_numpy(np.asarray(base, np.int32).copy()).to(dev),
        n=n, m=m, r=r)
