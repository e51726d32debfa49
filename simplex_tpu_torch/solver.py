"""The pivot loop: deferred block pivoting on the K1-K4 passes.

Port of the production loop of ``simplex_tpu.solver``:
``solve_loop_blocked_kernel`` (the fused blocked-kernel loop),
``run_solve_loop`` (its dispatch with the ``normalize_costs`` scaling),
``anticycling_update`` and ``pivot_update``. The f64 sequential loop and
the XLA blocked loop are not ported yet (ROADMAP queue 1, items 2 and 3):
``run_solve_loop`` raises ``NotImplementedError`` for the options that
select them.

The loop keeps every per-pivot decision on the device: the candidates,
``do``, ``status``, ``stall``, ``bland`` and the iteration count are 0-dim
tensors, and a window of L pivots enqueues its kernels without a host
sync. The host reads status and iterations once per window, for the
loop condition and the re-pricing cadence (plus once more on a window
that ends optimal, for the premature-optimal test). b, the reduced
costs and z are native f64 inside the loop, so the in-window optimality
test, the candidate fold and the window-boundary premature test all read
one representation (the JAX loop's double-f32 pairs needed the
round-trip discipline of ``simplex_tpu/solver.py:813-823``; the
``windows < max_iter`` bound stays all the same).
"""

from __future__ import annotations

import dataclasses

import torch

from .config import (EPS_REL_F32, SolverOptions, Status,
                     kernel_blocked_enabled, normalize_enabled)
from .kernels.blocked import (BIG_INDEX, ah_ratio, apply_reprice,
                              apply_window, colk_costs, entering_candidates)
from .tableau import Tableau, basic_costs

RUNNING = int(Status.RUNNING)


def anticycling_update(do, improved, prev_stall, prev_bland, *,
                       bland_static: bool, threshold):
    """The stall/Bland anti-cycling policy (``simplex_tpu.solver``): an
    applied pivot that improves z by >= eps resets the stall counter and
    leaves Bland mode; a non-improving one increments it and enters Bland
    once it reaches ``threshold``. Returns (stall, bland) tensors."""
    stall = torch.where(do, torch.where(improved, 0, prev_stall + 1),
                        prev_stall).to(torch.int32)
    if bland_static:
        bland = torch.ones_like(prev_bland)
    elif threshold is None:
        bland = torch.zeros_like(prev_bland)
    else:
        bland = torch.where(do, ~improved & (stall >= threshold), prev_bland)
    return stall, bland


def pivot_update(tab: Tableau, h: int, k: int, minc: torch.Tensor) -> Tableau:
    """One rank-1 pivot on the transposed tableau, in place (entering
    variable h, leaving constraint k): row k of ``Tt`` becomes
    ``Tt[k] / p`` and every other row j loses ``(a_h[j] / p) * Tt[k]``,
    with ``a_h = Tt[:, h]`` and ``p = a_h[k]``; b, costs, z and base follow
    as in ``simplex_tpu.solver.pivot_update``."""
    Tt = tab.Tt
    colk = Tt[k].clone()
    a_h = Tt[:, h].clone()
    p = a_h[k]
    factor = a_h / p
    Tt.addr_(factor, colk, alpha=-1.0)
    Tt[k] = colk / p
    bk = tab.b[k].clone()
    b = tab.b - bk * factor
    b[k] = bk / p
    u = minc / p
    return dataclasses.replace(
        tab, b=b, costs=tab.costs - u * colk, z=tab.z - u * bk,
        base=tab.base.index_fill(0, torch.tensor([k], device=Tt.device), h))


def solve_loop_blocked_kernel(tab: Tableau, options: SolverOptions,
                              max_iter: int,
                              costs0: torch.Tensor | None = None
                              ) -> tuple[Tableau, int, int]:
    """Deferred block pivoting over K1-K4 (port of
    ``simplex_tpu.solver.solve_loop_blocked_kernel``).

    Per pivot: K1 builds the live entering column and runs the ratio
    test; K2 builds the pivot row into ``C[t]``, updates costs, b, base,
    the eta row ``F[t]`` and the devex weights, and folds the next
    candidates. Per window of L pivots: ``Tt -= F^T C`` in place, fused
    with the exact re-pricing ``costs0 - coeffs @ Tt`` every
    ``reprice_every`` windows and on every window that ends non-RUNNING
    (K3), else the apply alone (K4; always when ``costs0`` is None). The
    tableau is updated in place. Returns (tableau, status, iterations);
    status stays RUNNING when the iteration fuse tripped."""
    eps = float(options.eps_resolved)
    bland_static = options.pivot_rule_resolved == "bland"
    devex = options.pivot_rule_resolved == "devex"
    threshold = options.bland_threshold
    L = int(options.block_pivots)
    every = max(1, int(options.reprice_every))
    Tt = tab.Tt
    M, R = Tt.shape
    if Tt.dtype != torch.float32 or R % 128:
        raise ValueError(f"the kernel loop needs an f32 tableau padded to "
                         f"128 variables, got {Tt.dtype} R={R}")
    dev = Tt.device
    f64 = torch.float64
    r = tab.r
    row_mask = torch.arange(R, device=dev) < r

    b = tab.b.to(f64).clone()
    costs = tab.costs.to(f64).clone()
    z = tab.z.to(f64).clone()
    base = tab.base.to(torch.int32).clone()
    if costs0 is not None:
        costs0 = costs0.to(f64)
    w = torch.ones(R, dtype=torch.float32, device=dev) if devex else None
    status = torch.tensor(RUNNING, dtype=torch.int32, device=dev)
    iterations = torch.zeros((), dtype=torch.int32, device=dev)
    stall = torch.zeros((), dtype=torch.int32, device=dev)
    bland = torch.tensor(bland_static, device=dev)
    h_d, v_d, h_b, v_b = entering_candidates(costs, w, r, eps)
    # Every row of C and F is rewritten each window before any pass reads
    # it (a skipped pivot writes zeros), so the factors are never cleared.
    C = torch.zeros((L, R), dtype=torch.float32, device=dev)
    F = torch.zeros((L, M), dtype=torch.float32, device=dev)

    st, it, windows = RUNNING, 0, 0
    while st == RUNNING and it < max_iter and windows < max_iter:
        for t in range(L):
            active = (status == RUNNING) & (iterations < max_iter)
            use_bland = bland & (h_b < BIG_INDEX)
            h = torch.where(use_bland, h_b, h_d)
            minc = torch.where(use_bland, v_b, v_d)
            optimal = minc > -eps
            a_h, k, p, bk, unb = ah_ratio(Tt, F, C, b, h, t, eps)
            unbounded = unb != 0
            do = active & ~(optimal | unbounded)
            p = torch.where(do, p, 1.0)
            u = torch.where(do, minc / p.to(f64), 0.0)
            h_d, v_d, h_b, v_b = colk_costs(
                Tt, C, F, costs, k, t, u, do, r, eps, a_h, b, base, h, p,
                bk, w)
            z2 = torch.where(do, z - u * bk, z)
            status = torch.where(
                active,
                torch.where(optimal, int(Status.OPTIMAL),
                            torch.where(unbounded, int(Status.UNBOUNDED),
                                        RUNNING)),
                status).to(torch.int32)
            stall, bland = anticycling_update(
                do, (z2 - z).abs() >= eps, stall, bland,
                bland_static=bland_static, threshold=threshold)
            iterations = iterations + do.to(torch.int32)
            z = z2
        if devex:
            # Re-anchor the reference framework once per window when the
            # weights drift too far.
            w = torch.where(w.max() > 1e8, 1.0, w)
        # The window's one host sync.
        st, it = (int(v) for v in torch.stack([status, iterations]).tolist())
        # Exact re-pricing every ``reprice_every`` windows and on every
        # window that ends non-RUNNING (K3); otherwise the apply alone
        # (K4), the in-window costs and candidates being current.
        if costs0 is not None and (st != RUNNING
                                   or (windows + 1) % every == 0):
            coeffs = basic_costs(base, costs0, r)
            costs = costs0 - apply_reprice(Tt, C, F, coeffs)
            h_d, v_d, h_b, v_b = entering_candidates(costs, w, r, eps)
            if st == int(Status.OPTIMAL) and float(
                    torch.where(row_mask, costs, torch.inf).min()) <= -eps:
                # Declared optimal on in-window costs while exact pricing
                # still shows an improving column: keep running.
                status.fill_(RUNNING)
                st = RUNNING
        else:
            apply_window(Tt, C, F)
        windows += 1

    vdtype = tab.costs.dtype
    out = dataclasses.replace(tab, Tt=Tt, b=b.to(vdtype),
                              costs=costs.to(vdtype), z=z.to(vdtype),
                              base=base)
    return out, st, it


def run_solve_loop(tab: Tableau, options: SolverOptions, max_iter: int,
                   costs0: torch.Tensor | None = None
                   ) -> tuple[Tableau, int, int]:
    """Dispatch to the blocked-kernel loop, with the ``normalize_costs``
    scaling of ``simplex_tpu.solver.run_solve_loop``: the working costs,
    z and costs0 are divided by ``max(1, EPS_REL_F32 / eps * (1 +
    max|costs|))`` for the call and restored on exit, which floors the
    pricing eps at the f32 data-precision threshold."""
    if not kernel_blocked_enabled(options):
        raise NotImplementedError(
            "only the blocked-kernel loop is ported (f32 tableau, "
            "block_pivots > 1 and a multiple of 8); the f64 sequential "
            "loop is ROADMAP queue 1 item 2, the XLA blocked loop item 3")
    scale = None
    if normalize_enabled(options):
        live = torch.arange(tab.rows_padded, device=tab.costs.device) < tab.r
        cmax = torch.where(live, tab.costs, 0.0).abs().max()
        scale = torch.clamp(
            (EPS_REL_F32 / float(options.eps_resolved)) * (1.0 + cmax),
            min=1.0).to(tab.costs.dtype)
        tab = dataclasses.replace(tab, costs=tab.costs / scale,
                                  z=tab.z / scale)
        if costs0 is not None:
            costs0 = costs0 / scale

    tab_out, status, iters = solve_loop_blocked_kernel(tab, options,
                                                       max_iter, costs0)
    if scale is not None:
        tab_out = dataclasses.replace(tab_out, costs=tab_out.costs * scale,
                                      z=tab_out.z * scale)
    return tab_out, status, iters
