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
    R_pad, _, M_pad = padded_dims(n, m, options)
    return batch_build_phase1(A[None], b[None], n, m, options,
                              dims=(R_pad, M_pad)).lane(0)


def basic_costs(base: torch.Tensor, costs: torch.Tensor,
                r: int) -> torch.Tensor:
    """``costs[base]`` with out-of-range entries (padding, artificials past
    a truncated phase, dropped rows) contributing 0."""
    return batch_basic_costs(base[None], costs[None], r)[0]


def batch_basic_costs(base: torch.Tensor, costs: torch.Tensor,
                      r: int) -> torch.Tensor:
    """``basic_costs`` per lane: (B, M_pad)."""
    idx = torch.clamp(base.long(), max=costs.shape[1] - 1)
    picked = costs.gather(1, idx)
    return torch.where(base < r, picked, torch.zeros_like(picked))


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
    does the same above 2 GB (``two_phase.py:182-184``); the m artificial
    columns cost m/(n+2m) of every phase-2 pass over the tableau: the
    window apply of the blocked loops, and the rank-1 update of the
    sequential loops (one third of it at n = m), which the JAX package
    pays only above 2 GB."""
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


def format_tableau(tab: Tableau, max_rows: int = 32,
                   max_cols: int = 16) -> str:
    """Debug rendering of the tableau (``simplex_tpu.tableau.
    format_tableau``, the reference's ``printTableauToStream``): the cost
    row with the objective, then one line per variable with its
    constraint coefficients (a column of ``Tt``), then b and the base.
    Large tableaus elide middle rows and columns."""
    import io

    out = io.StringIO()
    T = tab.Tt[:tab.m, :tab.r].t().cpu().numpy()
    costs = tab.costs[:tab.r].cpu().numpy()
    b = tab.b[:tab.m].cpu().numpy()
    base = tab.base[:tab.m].cpu().numpy()

    def fmt_row(label, vals):
        shown = vals if len(vals) <= max_cols else np.concatenate(
            [vals[:max_cols // 2], vals[-max_cols // 2:]])
        ellip = " ... " if len(vals) > max_cols else " "
        cells = ellip.join(" ".join(f"{v:10.4f}" for v in half)
                           for half in (np.array_split(shown, 2)
                                        if len(vals) > max_cols
                                        else [shown]))
        out.write(f"{label:>8s} | {cells}\n")

    out.write(f"Tableau {tab.r} vars x {tab.m} constraints "
              f"(z = {float(tab.z):.6f})\n")
    fmt_row("costs", costs[:max_rows])
    rows = range(tab.r) if tab.r <= max_rows else (
        list(range(max_rows // 2))
        + list(range(tab.r - max_rows // 2, tab.r)))
    last = -1
    for i in rows:
        if i != last + 1:
            out.write("     ...\n")
        fmt_row(f"x{i}", T[i])
        last = i
    fmt_row("b", b)
    out.write("    base | " + " ".join(str(v) for v in base) + "\n")
    return out.getvalue()


def count_basic_artificials(tab: Tableau) -> int:
    """Artificial variables still in the base."""
    is_art = (tab.base >= tab.n + tab.m) & (tab.base < tab.n + 2 * tab.m)
    return int(is_art.sum())


def batch_tt_matvec(T3: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per lane ``T3[i]^T @ v[i]`` (B, R_pad), ``T3 (B, M_pad, R_pad)``,
    accumulated in v's dtype, in chunks of lanes so that no widened copy
    of the whole batch exists (256 lanes of 512 x 3072 would be 3.2 GB in
    f64)."""
    B, m_pad, r_pad = T3.shape
    chunk = max(1, MATVEC_CHUNK_BYTES // (m_pad * r_pad * v.element_size()))
    out = torch.empty((B, r_pad), dtype=v.dtype, device=T3.device)
    for i in range(0, B, chunk):
        out[i:i + chunk] = torch.bmm(v[i:i + chunk, None, :],
                                     T3[i:i + chunk].to(v.dtype))[:, 0]
    return out


# ---------------------------------------------------------------------------
# Batched tableaus: B independent LPs of one shape, for ``batch.py``.

@dataclasses.dataclass
class BatchTableau:
    """B lanes of solver state: ``Tt (B*M_pad, R_pad)`` (the lanes'
    transposed tableaus stacked, the kernels' layout), ``b (B, M_pad)``,
    ``costs (B, R_pad)``, ``z (B,)``, ``base (B, M_pad) int32``; ``n``,
    ``m`` and ``r`` are shared."""

    Tt: torch.Tensor
    b: torch.Tensor
    costs: torch.Tensor
    z: torch.Tensor
    base: torch.Tensor
    n: int
    m: int
    r: int

    @property
    def T3(self) -> torch.Tensor:
        """``Tt`` as (B, M_pad, R_pad), a view."""
        B, M_pad = self.b.shape
        return self.Tt.view(B, M_pad, self.Tt.shape[1])

    def lane(self, i: int) -> Tableau:
        """Lane i as a Tableau whose ``Tt`` is a view into the batch."""
        return Tableau(Tt=self.T3[i], b=self.b[i], costs=self.costs[i],
                       z=self.z[i], base=self.base[i], n=self.n, m=self.m,
                       r=self.r)


def batch_build_phase1(A: torch.Tensor, b: torch.Tensor, n: int, m: int,
                       options: SolverOptions,
                       dims: tuple[int, int]) -> BatchTableau:
    """``build_phase1`` per lane, ``A (B, m, n)``, ``b (B, m)``, padded to
    ``dims = (R_pad, M_pad)``."""
    dtype = getattr(torch, options.dtype.name)
    vdtype = getattr(torch, options.vector_dtype.name)
    dev = A.device
    B = A.shape[0]
    R_pad, M_pad = dims
    r = n + 2 * m

    b = b.to(vdtype)
    sign = torch.where(b <= -options.eps_resolved, -1.0, 1.0).to(dtype)
    Tt = torch.zeros((B * M_pad, R_pad), dtype=dtype, device=dev)
    T3 = Tt.view(B, M_pad, R_pad)
    T3[:, :m, :n].copy_(A)
    T3[:, :m, :n].mul_(sign[:, :, None])
    idx = torch.arange(m, device=dev)
    T3[:, idx, n + idx] = sign
    T3[:, idx, n + m + idx] = 1.0
    b_pad = torch.zeros((B, M_pad), dtype=vdtype, device=dev)
    b_pad[:, :m] = b * sign.to(vdtype)
    costs = torch.zeros((B, R_pad), dtype=vdtype, device=dev)
    costs[:, n + m:r] = 1.0
    base = torch.full((B, M_pad), R_pad, dtype=torch.int32, device=dev)
    base[:, :m] = torch.arange(n + m, n + 2 * m, dtype=torch.int32,
                               device=dev)
    return BatchTableau(Tt=Tt, b=b_pad, costs=costs,
                        z=torch.zeros(B, dtype=vdtype, device=dev),
                        base=base, n=n, m=m, r=r)


def batch_gaussian_eliminate(tabs: BatchTableau) -> BatchTableau:
    """``gaussian_eliminate`` per lane, accumulated in the vector dtype."""
    coeffs = batch_basic_costs(tabs.base, tabs.costs, tabs.r)
    delta = batch_tt_matvec(tabs.T3, coeffs)
    return dataclasses.replace(tabs, costs=tabs.costs - delta,
                               z=tabs.z - (tabs.b * coeffs).sum(dim=1))


def batch_phase2_reset(tabs: BatchTableau, c: torch.Tensor,
                       r2_pad: int) -> BatchTableau:
    """``phase2_reset`` per lane, ``c (B, n)``, with the variable axis cut
    to ``r2_pad`` (a copy): the window kernel's work scales with it."""
    n, m = tabs.n, tabs.m
    B, M_pad = tabs.b.shape
    Tt = tabs.T3[:, :, :r2_pad].contiguous().view(B * M_pad, r2_pad)
    costs = torch.zeros((B, r2_pad), dtype=tabs.costs.dtype,
                        device=Tt.device)
    costs[:, :n] = -c.to(costs.dtype)
    return dataclasses.replace(tabs, Tt=Tt, costs=costs, r=n + m)


def batch_extract_solution(tabs: BatchTableau) -> torch.Tensor:
    """``extract_solution`` per lane: (B, n)."""
    n = tabs.n
    idx = torch.where(tabs.base < n, tabs.base,
                      torch.full_like(tabs.base, n)).long()
    x_ext = torch.zeros((tabs.b.shape[0], n + 1), dtype=tabs.b.dtype,
                        device=tabs.b.device)
    x_ext.scatter_(1, idx, tabs.b)
    return x_ext[:, :n]


def _artificial(tabs: BatchTableau) -> torch.Tensor:
    return (tabs.base >= tabs.n + tabs.m) & (tabs.base < tabs.n + 2 * tabs.m)


def batch_phase1_objective(tabs: BatchTableau) -> torch.Tensor:
    """``phase1_objective`` per lane: (B,)."""
    return -torch.where(_artificial(tabs), tabs.b,
                        torch.zeros_like(tabs.b)).sum(dim=1)


def batch_count_basic_artificials(tabs: BatchTableau) -> torch.Tensor:
    """``count_basic_artificials`` per lane: (B,) int64, on the device."""
    return _artificial(tabs).sum(dim=1)


def batch_from_numpy(Tt_stack, b, costs, z, base, n: int, m: int, r: int,
                     device="cpu") -> BatchTableau:
    """The port's batched state from the JAX package's arrays: either a
    batched ``Tableau``'s ``T (B, R_pad, M_pad)``, or the kernels' layout
    ``Tt (B*M_pad, R_pad)``; ``b``, ``costs`` and ``z`` in f64 (a kernel
    caller turns its (hi, lo) pairs into f64 with ``ff32_to_f64``). Lets
    a test start both implementations from one state."""
    dev = torch.device(device)
    T = np.asarray(Tt_stack)
    if T.ndim == 3:
        B, R_pad, M_pad = T.shape
        T = T.transpose(0, 2, 1).reshape(B * M_pad, R_pad)
    return BatchTableau(
        Tt=torch.from_numpy(np.ascontiguousarray(T)).to(dev),
        b=torch.from_numpy(np.array(b)).to(dev),
        costs=torch.from_numpy(np.array(costs)).to(dev),
        z=torch.from_numpy(np.array(z)).to(dev),
        base=torch.from_numpy(np.asarray(base, np.int32).copy()).to(dev),
        n=n, m=m, r=r)


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
