"""Column-sharded two-phase simplex over ``torch.distributed``.

Port of ``simplex_tpu.parallel.sharded``. The tableau's variable axis
is split across the ranks of a process group: rank i holds the columns
``[i * R_loc, (i + 1) * R_loc)`` of the transposed tableau, ``Tt_loc
(M_pad, R_loc)``, and the same slice of the reduced costs; ``b``,
``base``, ``z`` and the window's eta rows ``F`` are replicated, and every
rank updates its copy the same way. Every rank calls ``solve_sharded``
with the same problem; the JAX package's one process over a ``Mesh``
becomes one process per rank (``group.spawn``, or any launcher).

Per pivot the loops exchange (``group.all_gather`` / ``all_reduce``):

1. the entering candidates: two ``all_gather``s, one of each rank's
   stacked candidate values, one of its stacked global indices, then a
   lexicographic (value, lowest global index) fold that every rank
   computes alike;
2. the entering column: the owner's column, zeros elsewhere, in one
   (M_pad,) ``all_reduce`` -- on the kernel path the owner's column is
   K5's live column of its slice;
3. nothing else: the ratio test and the b / base / z updates are
   replicated, the rank-1 update, the pivot row (K2) and the window apply
   (K3/K4) are local.

Per window (the blocked loops) the exact re-pricing gathers the basic
costs in one (M_pad,) ``all_reduce`` and the premature-optimal test and
the candidates in ``all_gather``s; per solve the slack block that
refinement reads is summed in one (m, m) ``all_reduce``. No pivot waits
for the host: it reads status once per chunk (the sequential loop) or
window (the blocked loops), and every rank reads the same replicated
values, so every rank issues the same collectives.

Each rank builds only its own slice from A (``build_phase1_sharded``);
the JAX package builds the global tableau and lets XLA lay it out.
Refinement runs on every rank's card from the gathered slack block, as
in the port's ``solve``; a reinversion restart rebuilds the slices and
re-enters the sharded loop (``restart_sharded``).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.distributed as dist

from ..config import (DEFAULT_OPTIONS, EPS_REL_F32, SolverOptions, Status,
                      kernel_blocked_enabled, normalize_enabled,
                      refine_enabled)
from ..kernels.blocked import (BIG_INDEX, ah, ah_plain, apply_reprice,
                               apply_window, colk_costs, colk_workspace,
                               entering_candidates)
from ..problem import Problem
from ..result import SolveResult
from ..solver import (OPTIMAL, RUNNING, LoopState, _at, _drive,
                      _exit_status, anticycling_update, initial_state,
                      pivot_update, ratio_test)
from ..tableau import (Tableau, count_basic_artificials, extract_solution,
                       phase1_objective, round_up, tt_matvec)
from ..two_phase import DeviceSolveOutput, certify, resolve_device
from .group import Shard, all_gather, all_reduce


def _column_unit(options: SolverOptions, nranks: int) -> int:
    """What the variable axis pads to: ``nranks`` slices of whole
    ``sublane_pad`` columns -- of 128 on the kernel path, whose kernels
    take slices of whole 128-column tiles."""
    unit = options.sublane_pad
    if kernel_blocked_enabled(options):
        unit = max(unit, 128)
    return unit * nranks


def sharded_padded_dims(n: int, m: int, nranks: int,
                        options: SolverOptions) -> tuple[int, int]:
    """(R_pad, M_pad) of the phase-1 tableau over ``nranks`` slices
    (``simplex_tpu/parallel/sharded.py:71-84``). At one rank these are
    the port's single-card dims."""
    return (round_up(n + 2 * m, _column_unit(options, nranks)),
            round_up(m, options.lane_pad))


def build_phase1_sharded(A: torch.Tensor, b: torch.Tensor, n: int, m: int,
                         shard: Shard, options: SolverOptions,
                         M_pad: int, device) -> Tableau:
    """The rank's slice of the phase-1 tableau (``tableau.build_phase1``
    restricted to global columns ``[offset, offset + R_loc)``): the
    structural columns of A in the slice, times the row signs; the slack
    and artificial columns by their global index; costs 1 on the
    artificials. ``A`` (m, n) may lie anywhere (only the slice's columns
    are copied to ``device``); b, base and z are replicated, base padded
    with the global R_pad."""
    dtype = getattr(torch, options.dtype.name)
    vdtype = getattr(torch, options.vector_dtype.name)
    dev = torch.device(device)
    lo, R_loc = shard.offset, shard.R_loc
    hi = lo + R_loc

    b = b.to(dev, vdtype)
    sign = torch.where(b <= -options.eps_resolved, -1.0, 1.0).to(dtype)
    Tt = torch.zeros((M_pad, R_loc), dtype=dtype, device=dev)
    if lo < n:
        cols = slice(0, min(hi, n) - lo)
        Tt[:m, cols].copy_(A[:, lo:min(hi, n)])
        Tt[:m, cols].mul_(sign[:, None])
    for first, value in ((n, sign), (n + m, None)):      # slack, artificial
        i0, i1 = max(lo - first, 0), min(hi - first, m)
        if i0 < i1:
            i = torch.arange(i0, i1, device=dev)
            Tt[i, first + i - lo] = 1.0 if value is None else value[i]
    b_pad = torch.zeros(M_pad, dtype=vdtype, device=dev)
    b_pad[:m] = b * sign.to(vdtype)
    gi = lo + torch.arange(R_loc, device=dev)
    costs = ((gi >= n + m) & (gi < n + 2 * m)).to(vdtype)
    base = torch.full((M_pad,), shard.R_pad, dtype=torch.int32, device=dev)
    base[:m] = torch.arange(n + m, n + 2 * m, dtype=torch.int32, device=dev)
    return Tableau(Tt=Tt, b=b_pad, costs=costs,
                   z=torch.zeros((), dtype=vdtype, device=dev), base=base,
                   n=n, m=m, r=n + 2 * m)


def shard_tableau(tab: Tableau, rank: int, nranks: int) -> Tableau:
    """Rank ``rank``'s slice of a whole tableau (for instance the JAX
    package's state through ``tableau.tableau_from_numpy``): the columns
    ``[rank * R_loc, (rank + 1) * R_loc)`` of Tt and the costs, copies of
    the replicated vectors. Lets a test start both implementations from
    one tableau."""
    R_pad = tab.Tt.shape[1]
    if R_pad % nranks:
        raise ValueError(f"R_pad={R_pad} does not split into {nranks}")
    R_loc = R_pad // nranks
    cols = slice(rank * R_loc, (rank + 1) * R_loc)
    return dataclasses.replace(
        tab, Tt=tab.Tt[:, cols].contiguous(), costs=tab.costs[cols].clone(),
        b=tab.b.clone(), z=tab.z.clone(), base=tab.base.clone())


# ---------------------------------------------------------------------------
# Collective building blocks.

def _owned(idx: torch.Tensor, shard: Shard):
    """(local index clamped into the slice, whether this rank owns the
    global ``idx``)."""
    loc = idx.long() - shard.offset
    own = (loc >= 0) & (loc < shard.R_loc)
    return loc.clamp(0, shard.R_loc - 1), own


def gather_basic_coeffs(base: torch.Tensor, costs: torch.Tensor, r: int,
                        shard: Shard) -> torch.Tensor:
    """(M_pad,) replicated ``costs[base]`` over the basic variables
    (``sharded.py:191-204``): each rank contributes the entries whose
    global variable it owns, entries ``base >= r`` (artificials past the
    phase, dropped rows, padding) contribute 0; one ``all_reduce``."""
    loc, own = _owned(base, shard)
    vals = costs.index_select(0, loc)
    return all_reduce(torch.where(own & (base < r), vals, 0.0), shard.group)


def gather_column(Tt: torch.Tensor, h: torch.Tensor, shard: Shard,
                  C: torch.Tensor | None = None,
                  F: torch.Tensor | None = None, t: int = 0):
    """The replicated (M_pad,) column h (global) of the live tableau
    ``Tt - C[:t]^T F[:t]`` (``broadcast_entering_column`` and
    ``broadcast_live_row``, ``sharded.py:166-178, 288-302``): the owner's
    column, zeros elsewhere, one ``all_reduce``."""
    loc, own = _owned(h, shard)
    col = ah_plain(Tt, F, C, loc, t)
    return all_reduce(torch.where(own, col, 0.0), shard.group)


def gather_at(x: torch.Tensor, h: torch.Tensor, shard: Shard):
    """Replicate ``x[h]`` (global h) of a sharded vector: one
    ``all_reduce`` of a scalar (``gather_cost_at``, ``sharded.py:181``)."""
    loc, own = _owned(h, shard)
    return all_reduce(torch.where(own, _at(x, loc), 0.0), shard.group)


def global_max(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    """max over every rank of a 0-dim ``x``: one ``all_gather`` of P
    scalars (the JAX package avoids ``pmax``, which its AOT toolchain does
    not lower; one gather of scalars costs the same collective)."""
    return all_gather(x, shard.group).max()


def global_min(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    return all_gather(x, shard.group).min()


def fold_candidates(vals: torch.Tensor, idxs: torch.Tensor, shard: Shard,
                    main_key: torch.Tensor | None = None):
    """Global candidates from each rank's local ones. ``vals`` (k,) holds
    the rank's main-candidate value, its Bland value and any riders,
    ``idxs`` (2,) its main and Bland candidates as global indices
    (``BIG_INDEX`` for none). Two ``all_gather``s; then the main candidate
    is the rank with the largest ``main_key`` (default: the smallest
    value), the Bland candidate the lowest global index -- ties to the
    lowest rank, and the slices are contiguous, so ties go to the lowest
    global index as on one card. Returns (h_main, h_bland, the main
    owner's vals, the Bland owner's vals)."""
    g = shard.group
    if main_key is not None:
        vals = torch.cat([vals, main_key.view(1).to(vals.dtype)])
    V = all_gather(vals, g)                         # (P, k)
    Ix = all_gather(idxs, g)                        # (P, 2)
    key = V[:, -1] if main_key is not None else -V[:, 0]
    # Rows picked by index_select: indexing with a 0-dim tensor would
    # read it on the host, a sync a pivot.
    od = torch.argmax((key == key.max()).to(torch.int8)).view(1)
    ob = torch.argmin(Ix[:, 1]).view(1)
    vd, vb = V.index_select(0, od)[0], V.index_select(0, ob)[0]
    return (Ix.index_select(0, od)[0, 0], Ix.index_select(0, ob)[0, 1],
            vd, vb)


def _global_index(loc: torch.Tensor, shard: Shard) -> torch.Tensor:
    loc = loc.long()
    return torch.where(loc >= BIG_INDEX, BIG_INDEX, shard.offset + loc)


# ---------------------------------------------------------------------------
# The sequential sharded loop (the default options: f64, Dantzig, L = 1).

def entering_sharded(costs: torch.Tensor, bland: torch.Tensor, r: int,
                     eps: float, shard: Shard, w: torch.Tensor | None = None):
    """Distributed entering choice (``entering_sharded`` and
    ``entering_sharded_devex``, ``sharded.py:118-163, 305-351``): each
    rank's Dantzig argmin (devex: the argmax of cost^2 / w over eligible
    columns) and its lowest eligible column, one fold. Returns (h
    global int32, the cost at h, the weight at h or None), replicated;
    the loop is optimal iff that cost > -eps. Matches the port's
    single-card ``choose_entering`` / ``_entering_blocked``."""
    R_loc = shard.R_loc
    dev = costs.device
    iota = torch.arange(R_loc, device=dev)
    masked = torch.where(shard.row_mask(r, dev), costs, torch.inf)
    eligible = masked <= -eps
    has = eligible.any()
    lb = torch.argmin(torch.where(eligible, iota, R_loc)).clamp(
        max=R_loc - 1)
    key = None
    if w is None:
        ld = torch.argmin(masked)
        riders = []
    else:
        score = torch.where(eligible, masked * masked / w, -torch.inf)
        ld = torch.argmax(score)
        key = _at(score, ld)
        riders = [_at(w, ld), torch.where(has, _at(w, lb), 1.0)]
    vals = torch.stack([_at(masked, ld),
                        torch.where(has, _at(masked, lb), torch.inf),
                        *[x.to(masked.dtype) for x in riders]])
    idxs = torch.stack([shard.offset + ld,
                        torch.where(has, shard.offset + lb, BIG_INDEX)])
    h_d, h_b, vd, vb = fold_candidates(vals, idxs, shard, key)
    use_b = bland & (h_b < BIG_INDEX)
    h = torch.where(use_b, h_b, h_d).to(torch.int32)
    minc = torch.where(use_b, vb[1], vd[0])
    wh = None if w is None else torch.where(use_b, vb[3], vd[2]).to(w.dtype)
    return h, minc, wh


def iteration_body_sharded(state: LoopState, shard: Shard,
                           options: SolverOptions,
                           max_iter: int) -> LoopState:
    """One pivot of the sequential sharded loop (``solve_loop_sharded``'s
    body, ``sharded.py:253-279``): the entering fold, the entering column
    from its owner, the replicated ratio test, and the port's
    ``pivot_update`` on the local slice (the same rounding as ``solve``);
    idempotent once the loop has finished."""
    eps = float(options.eps_resolved)
    tab = state.tab
    active = (state.status == RUNNING) & (state.iterations < max_iter)
    h, minc, _ = entering_sharded(tab.costs, state.bland, tab.r, eps, shard)
    optimal = minc > -eps
    a_h = gather_column(tab.Tt, h, shard)
    k, unbounded = ratio_test(tab, a_h, eps)
    do = active & ~(optimal | unbounded)
    p = torch.where(do, _at(a_h, k), 1.0)
    tab2 = pivot_update(tab, h, k, minc, p=p, do=do, a_h=a_h)
    stall, bland = anticycling_update(
        do, (tab2.z - tab.z).abs() >= eps, state.stall, state.bland,
        bland_static=options.pivot_rule_resolved == "bland",
        threshold=options.bland_threshold)
    return LoopState(tab2, _exit_status(active, optimal, unbounded,
                                        state.status),
                     state.iterations + do.to(torch.int32), stall, bland)


def solve_loop_sharded(tab: Tableau, shard: Shard, options: SolverOptions,
                       max_iter: int) -> tuple[Tableau, int, int]:
    """``sharded.py:240-286``: pivots until OPTIMAL / UNBOUNDED / the
    fuse, the host reading status once per ``SEQ_CHUNK`` pivots."""
    state, st, it = _drive(
        lambda s: iteration_body_sharded(s, shard, options, max_iter),
        initial_state(tab, options), max_iter)
    return state.tab, st, it


# ---------------------------------------------------------------------------
# The plain blocked sharded loop (f64 blocked, and f32 off the kernels).

def devex_update_sharded(w, do, colk, p, wh, old_base_k, shard: Shard):
    """Forrest-Goldfarb weights on the local slice (``devex_update_sharded``,
    ``sharded.py:354-383``; the port's ``solver._devex_update``): alpha is
    the slice of the leaving row over p, the leaving variable (owned by
    one rank; any global column < R_pad) gets max(w_h / p^2, 1); the
    1e12 cap and NaN reset. The 1e8 re-anchor on the global max is the
    caller's (``reanchor``): per pivot in the plain loop, per window in
    the kernel loop."""
    alpha = (colk / p).to(w.dtype)
    w2 = torch.maximum(w, alpha * alpha * wh)
    hit = shard.offset + torch.arange(shard.R_loc, device=w.device) \
        == old_base_k.long()
    w2 = torch.where(hit, torch.maximum(wh / (p * p).to(w.dtype),
                                        torch.ones_like(wh)), w2)
    w2 = torch.minimum(w2, torch.full_like(w2, 1e12))
    w2 = torch.where(torch.isnan(w2), 1.0, w2)
    return torch.where(do, w2, w)


def reanchor(w, shard: Shard):
    """(w reset to 1 where the global max passed 1e8, whether it did):
    one scalar ``all_gather``."""
    reset = global_max(w.max(), shard) > 1e8
    return torch.where(reset, 1.0, w), reset


def solve_loop_blocked_sharded(tab: Tableau, shard: Shard,
                               options: SolverOptions, max_iter: int,
                               costs0: torch.Tensor | None = None):
    """Sharded deferred block pivoting in plain torch
    (``solve_loop_blocked_sharded``, ``sharded.py:386-510``; the port's
    ``solver.solve_loop_blocked`` on the local slice): the stale slice
    and the eta columns ``C (L, R_loc)`` are local, the eta rows ``F`` and
    the vectors replicated. Per pivot the entering fold and the live
    column ``Tt[:, h] - C[:t, h] @ F[:t]`` from its owner (plus the
    devex re-anchor's max); per window the local apply and, with
    ``costs0`` and an f32 tableau, the exact re-pricing."""
    eps = float(options.eps_resolved)
    bland_static = options.pivot_rule_resolved == "bland"
    devex = options.pivot_rule_resolved == "devex"
    threshold = options.bland_threshold
    L = int(options.block_pivots or 1)
    Tt = tab.Tt
    M, R_loc = Tt.shape
    dev = Tt.device
    dtype, vd = Tt.dtype, tab.costs.dtype
    if dtype == torch.float64:
        costs0 = None
    elif dev.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise ValueError("the f32 window apply needs IEEE products: set "
                         "torch.backends.cuda.matmul.allow_tf32 = False")
    iota_m = torch.arange(M, device=dev)
    row_mask = shard.row_mask(tab.r, dev)

    b, costs, z, base = tab.b, tab.costs, tab.z, tab.base
    w = torch.ones(R_loc, dtype=vd, device=dev) if devex else None
    status = torch.tensor(RUNNING, dtype=torch.int32, device=dev)
    iterations = torch.zeros((), dtype=torch.int32, device=dev)
    stall = torch.zeros((), dtype=torch.int32, device=dev)
    bland = torch.tensor(bland_static, device=dev)
    C = torch.zeros((L, R_loc), dtype=dtype, device=dev)
    F = torch.zeros((L, M), dtype=dtype, device=dev)

    st, it = RUNNING, 0
    while st == RUNNING and it < max_iter:
        for t in range(L):
            active = (status == RUNNING) & (iterations < max_iter)
            h, minc, wh = entering_sharded(costs, bland, tab.r, eps, shard,
                                           w)
            optimal = minc > -eps
            a_h = gather_column(Tt, h, shard, C, F, t)
            mask = a_h >= eps
            unbounded = ~mask.any()
            k = torch.argmin(torch.where(
                mask, b / torch.where(mask, a_h, 1.0), torch.inf))
            do = active & ~(optimal | unbounded)
            p = torch.where(do, _at(a_h, k), 1.0)
            kl = k.view(1)
            colk = Tt.index_select(0, kl).view(R_loc)
            if t:
                colk = colk - F[:t].index_select(1, kl).view(t) @ C[:t]
            bk = _at(b, k)
            u = minc / p.to(vd)
            costs2 = torch.where(do, costs - u * colk.to(vd), costs)
            z2 = torch.where(do, z - u * bk, z)
            is_k = iota_m == k
            b = torch.where(do, torch.where(is_k, bk / p.to(vd),
                                            b - bk * (a_h / p).to(vd)), b)
            if devex:
                w, _ = reanchor(devex_update_sharded(
                    w, do, colk, p, wh, _at(base, k), shard), shard)
            base = torch.where(do & is_k, h, base)
            C[t] = torch.where(do, colk, 0.0)
            F[t] = torch.where(do, torch.where(is_k, 1.0 - 1.0 / p,
                                               a_h / p), 0.0)
            status = _exit_status(active, optimal, unbounded, status)
            stall, bland = anticycling_update(
                do, (z2 - z).abs() >= eps, stall, bland,
                bland_static=bland_static, threshold=threshold)
            iterations = iterations + do.to(torch.int32)
            costs, z = costs2, z2
        Tt.addmm_(F.t(), C, alpha=-1.0)
        if costs0 is not None:
            costs = costs0 - tt_matvec(Tt, gather_basic_coeffs(
                base, costs0, tab.r, shard))
            vmin = global_min(torch.where(row_mask, costs, torch.inf).min(),
                              shard)
            status = torch.where((status == OPTIMAL) & (vmin <= -eps),
                                 RUNNING, status).to(torch.int32)
        st, it = (int(v) for v in torch.stack([status, iterations]).tolist())

    out = dataclasses.replace(tab, b=b, costs=costs, z=z, base=base)
    return out, st, it


# ---------------------------------------------------------------------------
# The kernel sharded loop (K5, K2, K3/K4 on each slice).

def _local_candidates(costs, w, r_loc: int, eps: float, shard: Shard):
    """The slice's candidates over its f64 costs (``entering_candidates``)
    ready for ``fold_candidates``: values [v_d, v_b, w at h_d, w at h_b]
    (the weights under devex only), global indices, and under devex the
    main key cost^2 / w (-inf when the slice has no eligible column)."""
    h_d, v_d, h_b, v_b = entering_candidates(costs, w, r_loc, eps)
    return _pack(h_d, v_d, h_b, v_b, w, shard)


def _pack(h_d, v_d, h_b, v_b, w, shard: Shard):
    vals = [v_d, v_b]
    key = None
    if w is not None:
        R_loc = shard.R_loc
        w_d = _at(w, h_d.long().clamp(max=R_loc - 1)).double()
        w_b = torch.where(h_b < BIG_INDEX,
                          _at(w, h_b.long().clamp(max=R_loc - 1)).double(),
                          1.0)
        key = torch.where(h_b < BIG_INDEX, v_d * v_d / w_d, -torch.inf)
        vals += [w_d, w_b]
    idxs = torch.stack([_global_index(h_d, shard), _global_index(h_b, shard)])
    return torch.stack(vals), idxs, key


def _fold(packed, shard: Shard):
    """(h_d, v_d, h_b, v_b, w at h_d, w at h_b) from ``_pack``'s output,
    replicated; the weights are 1 without devex."""
    vals, idxs, key = packed
    h_d, h_b, vd, vb = fold_candidates(vals, idxs, shard, key)
    one = torch.ones((), dtype=torch.float32, device=vals.device)
    w_d = vd[2].float() if key is not None else one
    w_b = vb[3].float() if key is not None else one
    return (h_d.to(torch.int32), vd[0], h_b.to(torch.int32), vb[1], w_d,
            w_b)


def solve_loop_blocked_kernel_sharded(tab: Tableau, shard: Shard,
                                      options: SolverOptions, max_iter: int,
                                      costs0: torch.Tensor | None = None):
    """Deferred block pivoting over K5, K2 and K3/K4 on each rank's slice
    (``solve_loop_blocked_kernel_sharded``, ``sharded.py:540-859``; the
    port's ``solver.solve_loop_blocked_kernel``, which it equals pivot for
    pivot at one rank).

    Per pivot: K5 builds the owner's live entering column, one (M_pad,)
    ``all_reduce`` replicates it, the ratio test runs on it in f64 (as
    K1's), K2 builds the slice's pivot row into ``C[t]``, updates the
    slice's costs and the replicated b, base and eta row ``F[t]``, and
    folds the slice's candidates, which two ``all_gather``s fold across
    the ranks. Under devex the weights are updated in torch ops on the
    slice and its candidates re-derived (K2's devex stage indexes its
    weights by global column; ``sharded.py:705-737`` does the same), and
    the fold carries the weights at both candidates. Per window: the devex
    re-anchor's global max (one ``all_gather``); then either K4 (off
    cadence) or the basic-cost ``all_reduce``, K3, the premature-optimal
    minimum and the candidate fold (three ``all_gather``s), chosen on the
    host as the single-card loop chooses. The tableau slice is updated in
    place. Returns (tableau, status, iterations)."""
    eps = float(options.eps_resolved)
    bland_static = options.pivot_rule_resolved == "bland"
    devex = options.pivot_rule_resolved == "devex"
    threshold = options.bland_threshold
    L = int(options.block_pivots)
    every = max(1, int(options.reprice_every))
    Tt = tab.Tt
    M, R_loc = Tt.shape
    if Tt.dtype != torch.float32 or R_loc % 128:
        raise ValueError(f"the kernel loop needs an f32 slice of whole "
                         f"128-column tiles, got {Tt.dtype} R_loc={R_loc}")
    dev = Tt.device
    f64 = torch.float64
    r = tab.r
    r_loc = shard.local_r(r)
    row_mask = shard.row_mask(r, dev)

    b = tab.b.to(f64).clone()
    costs = tab.costs.to(f64).clone()
    z = tab.z.to(f64).clone()
    base = tab.base.to(torch.int32).clone()
    if costs0 is not None:
        costs0 = costs0.to(f64)
    w = torch.ones(R_loc, dtype=torch.float32, device=dev) if devex else None
    status = torch.tensor(RUNNING, dtype=torch.int32, device=dev)
    iterations = torch.zeros((), dtype=torch.int32, device=dev)
    stall = torch.zeros((), dtype=torch.int32, device=dev)
    bland = torch.tensor(bland_static, device=dev)
    h_d, v_d, h_b, v_b, w_d, w_b = _fold(
        _local_candidates(costs, w, r_loc, eps, shard), shard)
    C = torch.zeros((L, R_loc), dtype=torch.float32, device=dev)
    F = torch.zeros((L, M), dtype=torch.float32, device=dev)
    ws = colk_workspace(R_loc, dev)

    st, it, windows = RUNNING, 0, 0
    while st == RUNNING and it < max_iter and windows < max_iter:
        for t in range(L):
            active = (status == RUNNING) & (iterations < max_iter)
            use_bland = bland & (h_b < BIG_INDEX)
            h = torch.where(use_bland, h_b, h_d)
            minc = torch.where(use_bland, v_b, v_d)
            optimal = minc > -eps
            hl, own = _owned(h, shard)
            a_h = all_reduce(torch.where(
                own, ah(Tt, F, C, hl.to(torch.int32), t), 0.0), shard.group)
            mask = a_h >= eps
            unbounded = ~mask.any()
            k = torch.argmin(torch.where(
                mask, b / torch.where(mask, a_h, 1.0).double(), torch.inf))
            do = active & ~(optimal | unbounded)
            p = torch.where(do, _at(a_h, k), 1.0)
            bk = _at(b, k)
            u = torch.where(do, minc / p.to(f64), 0.0)
            lvar = _at(base, k)                  # before K2 changes base
            k32 = k.to(torch.int32)
            cands = colk_costs(Tt, C, F, costs, k32, t, u, do, r_loc, eps,
                               a_h, b, base, h, p, bk, ws=ws)
            if devex:
                w = devex_update_sharded(w, do, C[t], p,
                                         torch.where(use_bland, w_b, w_d),
                                         lvar, shard)
                packed = _local_candidates(costs, w, r_loc, eps, shard)
            else:
                packed = _pack(*cands, None, shard)
            h_d, v_d, h_b, v_b, w_d, w_b = _fold(packed, shard)
            z2 = torch.where(do, z - u * bk, z)
            status = _exit_status(active, optimal, unbounded, status)
            stall, bland = anticycling_update(
                do, (z2 - z).abs() >= eps, stall, bland,
                bland_static=bland_static, threshold=threshold)
            iterations = iterations + do.to(torch.int32)
            z = z2
        if devex:
            # Re-anchor the framework on the global max, once per window;
            # the carried weights at the candidates follow.
            w, reset = reanchor(w, shard)
            w_d = torch.where(reset, 1.0, w_d)
            w_b = torch.where(reset, 1.0, w_b)
        st, it = (int(v) for v in torch.stack([status, iterations]).tolist())
        if costs0 is not None and (st != RUNNING
                                   or (windows + 1) % every == 0):
            coeffs = gather_basic_coeffs(base, costs0, r, shard)
            costs = costs0 - apply_reprice(Tt, C, F, coeffs)
            h_d, v_d, h_b, v_b, w_d, w_b = _fold(
                _local_candidates(costs, w, r_loc, eps, shard), shard)
            vmin = global_min(torch.where(row_mask, costs, torch.inf).min(),
                              shard)
            if st == OPTIMAL and float(vmin) <= -eps:
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


def run_solve_loop_sharded(tab: Tableau, shard: Shard,
                           options: SolverOptions, max_iter: int,
                           costs0: torch.Tensor | None = None):
    """Dispatch (``run_solve_loop_sharded``, ``sharded.py:862-913``): the
    kernel loop when ``block_pivots`` > 1 and the kernels take the options
    and the slice, else the plain blocked loop; the sequential loop at
    L = 1 (the port's K6 variant has no sharded form, as in the JAX
    package). ``normalize_costs`` scales by the global cost max (one
    ``all_gather``)."""
    L = int(options.block_pivots or 1)
    if options.pivot_rule_resolved == "devex" and L <= 1:
        raise ValueError(
            "sharded pivot_rule='devex' requires block_pivots > 1 (the "
            "deferred block-pivot loops carry the devex weights); the "
            "sequential sharded loop prices with Dantzig/Bland only")
    scale = None
    if normalize_enabled(options):
        live = shard.row_mask(tab.r, tab.costs.device)
        cmax = global_max(torch.where(live, tab.costs, 0.0).abs().max(),
                          shard)
        scale = torch.clamp(
            (EPS_REL_F32 / float(options.eps_resolved)) * (1.0 + cmax),
            min=1.0).to(tab.costs.dtype)
        tab = dataclasses.replace(tab, costs=tab.costs / scale,
                                  z=tab.z / scale)
        if costs0 is not None:
            costs0 = costs0 / scale

    if L > 1:
        if kernel_blocked_enabled(options) and shard.R_loc % 128 == 0:
            out = solve_loop_blocked_kernel_sharded(tab, shard, options,
                                                    max_iter, costs0)
        else:
            out = solve_loop_blocked_sharded(tab, shard, options, max_iter,
                                             costs0)
    else:
        out = solve_loop_sharded(tab, shard, options, max_iter)

    tab_out, status, iters = out
    if scale is not None:
        tab_out = dataclasses.replace(tab_out, costs=tab_out.costs * scale,
                                      z=tab_out.z * scale)
    return tab_out, status, iters


# ---------------------------------------------------------------------------
# The two phases.

def gaussian_eliminate_sharded(tab: Tableau, shard: Shard) -> Tableau:
    """Objective-row elimination (``sharded.py:916-928``): the basic costs
    in one ``all_reduce``, then ``costs -= Tt_loc^T coeffs`` locally and
    ``z -= b @ coeffs`` replicated."""
    coeffs = gather_basic_coeffs(tab.base, tab.costs, tab.r, shard)
    return dataclasses.replace(tab, costs=tab.costs - tt_matvec(tab.Tt,
                                                                coeffs),
                               z=tab.z - tab.b @ coeffs)


def phase2_costs_local(tab: Tableau, c: torch.Tensor,
                       shard: Shard) -> torch.Tensor:
    """The slice of the phase-2 costs ``[-c | 0]`` by global column
    (``_phase2_costs_local``, ``sharded.py:931-938``)."""
    gi = shard.offset + torch.arange(shard.R_loc, device=tab.costs.device)
    cv = c.to(tab.costs.dtype).index_select(0, gi.clamp(max=tab.n - 1))
    return torch.where(gi < tab.n, -cv, 0.0)


def pivot_out_artificials_sharded(tab: Tableau, shard: Shard,
                                  options: SolverOptions) -> Tableau:
    """``two_phase.pivot_out_artificials`` on the slices
    (``sharded.py:960-1012``): for each basic artificial, the lowest
    structural or slack column with a coefficient of at least eps in its
    row over every slice (one ``all_gather``), pivoted in with its column
    and cost from the owner (two ``all_reduce``s); a row with none is a
    redundant constraint, dropped with the sentinel ``n + 2m`` (out of
    range of every ``base < r`` mask and of the solution scatter)."""
    eps = float(options.eps_resolved)
    n, m = tab.n, tab.m
    dev = tab.Tt.device
    gi = shard.offset + torch.arange(shard.R_loc, device=dev)
    for _ in range(m):
        is_art = (tab.base >= n + m) & (tab.base < n + 2 * m)
        arts = torch.nonzero(is_art)
        if arts.numel() == 0:
            break
        k = int(arts[0, 0])
        cand = (gi < n + m) & (tab.Tt[k].abs() >= eps)
        lh = torch.where(cand, gi, BIG_INDEX).min()
        h = int(all_gather(lh, shard.group).min())
        if h < BIG_INDEX:
            hh = torch.tensor(h, device=dev)
            tab = pivot_update(tab, h, k, gather_at(tab.costs, hh, shard),
                               a_h=gather_column(tab.Tt, hh, shard))
        else:
            tab.Tt[k].zero_()
            b = tab.b.clone()
            b[k] = 0.0
            base = tab.base.clone()
            base[k] = n + 2 * m
            tab = dataclasses.replace(tab, b=b, base=base)
    return tab


def gather_slack_block(tab: Tableau, shard: Shard) -> torch.Tensor:
    """The final tableau's slack block ``Tt[:m, n:n+m]`` (``B^{-1}`` up to
    drift), each rank's owned columns summed into every rank's copy: one
    (m, m) ``all_reduce`` per solve (``sharded.py:1103-1117``)."""
    n, m = tab.n, tab.m
    lo = shard.offset
    a, e = max(n, lo), min(n + m, lo + shard.R_loc)
    block = torch.zeros((m, m), dtype=tab.Tt.dtype, device=tab.Tt.device)
    if a < e:
        block[:, a - n:e - n] = tab.Tt[:m, a - lo:e - lo]
    return all_reduce(block, shard.group)


def solve_device_sharded(A, b: torch.Tensor, c: torch.Tensor, n: int,
                         m: int, shard: Shard, options: SolverOptions,
                         inputs_finite: bool, device, want_binv: bool):
    """Both phases on the slices (``_two_phase_core``,
    ``sharded.py:1015-1117``), with the statuses, NUMERIC guards and
    degeneracy repair of the port's ``two_phase.solve_device_with_binv``:
    phase 2 is skipped when phase 1 decided the outcome. ``A`` (m, n)
    may lie anywhere (``build_phase1_sharded``); ``b``, ``c`` on the
    rank's device. Returns ``(DeviceSolveOutput, binv)``, both
    replicated; ``binv`` (the gathered slack block) only with
    ``want_binv`` and an OPTIMAL result, else None."""
    eps = float(options.eps_resolved)
    max_iter = options.resolved_max_iter(n + 2 * m, m)
    _, M_pad = sharded_padded_dims(n, m, shard.size, options)

    tab = build_phase1_sharded(A, b, n, m, shard, options, M_pad, device)
    costs0 = tab.costs
    tab = gaussian_eliminate_sharded(tab, shard)
    tab, status1, iters1 = run_solve_loop_sharded(tab, shard, options,
                                                  max_iter, costs0)

    z_phase1 = float(phase1_objective(tab))
    b_scale = 1.0 + float(b.abs().max())
    infeasible = z_phase1 <= -eps * b_scale
    n_art = count_basic_artificials(tab)
    degenerate = n_art > 0
    fuse1 = status1 == RUNNING
    if (options.degeneracy == "continue" and degenerate and not infeasible
            and not fuse1):
        tab = pivot_out_artificials_sharded(tab, shard, options)

    if not (np.isfinite(z_phase1) and inputs_finite):
        status = Status.NUMERIC
    elif fuse1:
        status = Status.MAXITER
    elif infeasible:
        status = Status.INFEASIBLE
    elif options.degeneracy == "reference" and degenerate:
        status = Status.DEGENERATE
    else:
        status = None
    if status is not None:
        x = torch.zeros(n, dtype=tab.b.dtype, device=tab.b.device)
        return DeviceSolveOutput(status, x, z_phase1, iters1, 0, n_art,
                                 tab.base), None

    tab2 = dataclasses.replace(tab, costs=phase2_costs_local(tab, c, shard),
                               r=n + m)
    costs0 = tab2.costs
    tab2 = gaussian_eliminate_sharded(tab2, shard)
    tab2, status2, iters2 = run_solve_loop_sharded(tab2, shard, options,
                                                   max_iter, costs0)
    x = extract_solution(tab2)

    status = Status.MAXITER if status2 == RUNNING else Status(status2)
    z2 = float(tab2.z)
    if not (np.isfinite(z2) and bool(torch.isfinite(x).all())):
        status = Status.NUMERIC
    if status2 == OPTIMAL:
        objective = float(c.to(x.dtype) @ x)
    else:
        objective = z2
    if status != Status.OPTIMAL:
        x = torch.zeros_like(x)
    out = DeviceSolveOutput(status, x, objective, iters1, iters2, n_art,
                            tab2.base)
    binv = (gather_slack_block(tab2, shard)
            if want_binv and status == Status.OPTIMAL else None)
    return out, binv


def restart_sharded(shard: Shard, A, b, c, base, binv, xB, n: int, m: int,
                    options: SolverOptions):
    """One reinversion-restart round on the slices (the port's
    ``reinvert.restart_device``, with its signature after ``shard``):
    every rank sharpens the gathered slack block alike, builds its slice
    of the rebuilt phase-2 tableau (variables padded as the phase-2 axis
    would be, ``n + m`` over the ranks) and re-enters the sharded loop.
    Returns ``(DeviceSolveOutput, binv, ns_residual)``, replicated."""
    from ..reinvert import restart_output, restart_tableau

    R_pad = round_up(n + m, _column_unit(options, shard.size))
    sh = Shard(shard.group, shard.rank, shard.size, R_pad // shard.size)
    _, M_pad = sharded_padded_dims(n, m, shard.size, options)
    tab, ns_res = restart_tableau(A, b, c, base, binv, xB, n, m, options,
                                  M_pad, sh.offset, sh.R_loc)
    costs0 = tab.costs
    tab = gaussian_eliminate_sharded(tab, sh)
    tab2, status2, iters2 = run_solve_loop_sharded(
        tab, sh, options, options.resolved_max_iter(n + 2 * m, m), costs0)
    out = restart_output(tab2, status2, iters2, b, c, xB)
    return out, gather_slack_block(tab2, sh), ns_res


def solve_sharded(problem: Problem, mesh=None,
                  options: SolverOptions | None = None, *, device="cuda",
                  **replacements) -> SolveResult:
    """Solve one LP with its variable axis split across the ranks of
    ``mesh``, a ``torch.distributed`` ProcessGroup (None: the default
    group). Every rank calls it with the same problem and options; each
    returns the same result. ``device`` is the rank's own (``"cuda"``,
    the default, is the current card and raises where CUDA is absent;
    ``"cpu"`` runs the kernels' plain versions, over gloo).
    ``replacements`` override SolverOptions fields, as in ``solve``. In
    the mixed mode every OPTIMAL result is refined in f64 and certified on
    every rank's device from the gathered slack block, with up to two
    reinversion-restart rounds on the slices (``two_phase.certify`` with
    ``restart_sharded``), and then the f64 finishing tier
    (``two_phase.fallback_solve`` on the rank's device), whose result is
    returned as ``simplex_tpu.parallel.sharded.solve_sharded`` returns it
    (the JAX package goes to that tier without the restart rounds)."""
    options = options or DEFAULT_OPTIONS
    if replacements:
        options = dataclasses.replace(options, **replacements)
    dev = resolve_device(device)
    group = mesh if mesh is not None else dist.group.WORLD
    m, n = problem.constraints, problem.vars
    R_pad, _ = sharded_padded_dims(n, m, dist.get_world_size(group),
                                   options)
    shard = Shard.of(group, R_pad)

    A = np.asarray(problem.A)
    inputs_finite = bool(np.isfinite(A).all()
                         and np.isfinite(problem.b).all()
                         and np.isfinite(problem.c).all())
    refine = refine_enabled(options)
    # Refinement reads all of A on the rank's device; otherwise only the
    # slice's columns travel.
    A_src = torch.as_tensor(A, device=dev if refine else None)
    b_dev = torch.as_tensor(np.asarray(problem.b), device=dev)
    c_dev = torch.as_tensor(np.asarray(problem.c), device=dev)
    out, binv = solve_device_sharded(A_src, b_dev, c_dev, n, m, shard,
                                     options, inputs_finite, dev, refine)
    status = out.status
    x = out.x.cpu().numpy() if status == Status.OPTIMAL else None
    objective = out.objective
    refine_info = None
    extra = 0
    if status == Status.OPTIMAL and refine:
        cert = certify(problem, out.base, binv, objective, options, A_src,
                       b_dev, c_dev,
                       restart=functools.partial(restart_sharded, shard))
        if cert.fallback is not None:
            return cert.fallback
        x, objective = cert.x, cert.objective
        refine_info, extra = cert.refine, cert.extra_pivots
    return SolveResult(
        status=status, x=x, objective=objective,
        iterations_phase1=out.iterations_phase1,
        iterations_phase2=out.iterations_phase2 + extra,
        degenerate=out.n_artificial_in_base > 0, refine=refine_info)


def solve_sharded_rank(group, device, cases):
    """``solve_sharded`` of each (problem, options) in ``cases`` in turn,
    for ``group.spawn`` (one spawn for several instances). Returns the
    results."""
    return [solve_sharded(p, group, o, device=device) for p, o in cases]


def count_collectives(group, device, problem: Problem, cases):
    """The collectives the phase-1 loop issues, for ``group.spawn``: for
    each (options, caps) in ``cases`` and each cap, ``run_solve_loop_
    sharded`` from the options' eliminated phase-1 tableau, capped there;
    then one whole ``solve_sharded``. Returns, per case, ([(iterations,
    COUNTS by kind) per cap], SHAPES of the solve): what the
    collective-structure test reads."""
    from . import group as pg

    dev = resolve_device(device)
    m, n = problem.constraints, problem.vars
    A = torch.as_tensor(np.asarray(problem.A))
    b = torch.as_tensor(np.asarray(problem.b), device=dev)
    out = []
    for options, caps in cases:
        R_pad, M_pad = sharded_padded_dims(n, m, dist.get_world_size(group),
                                           options)
        shard = Shard.of(group, R_pad)
        tab0 = build_phase1_sharded(A, b, n, m, shard, options, M_pad, dev)
        costs0 = tab0.costs
        tab0 = gaussian_eliminate_sharded(tab0, shard)
        loops = []
        for cap in caps:
            tab = dataclasses.replace(tab0, Tt=tab0.Tt.clone())
            pg.reset_counts()
            _, _, iters = run_solve_loop_sharded(tab, shard, options, cap,
                                                 costs0)
            loops.append((iters, dict(pg.COUNTS)))
        pg.reset_counts()
        solve_sharded(problem, group, options, device=dev)
        out.append((loops, dict(pg.SHAPES)))
    return out
