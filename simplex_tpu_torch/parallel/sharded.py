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
from ..kernels.blocked import (BIG_INDEX, ShardedScalars,
                               ah, ah_fold_head, ah_plain,
                               anticycling_update, apply_reprice,
                               apply_window, colk_costs_sharded_tail,
                               colk_workspace, entering_candidates,
                               exit_status, sharded_fold, sharded_pack,
                               sharded_ratio, sharded_scalars,
                               sharded_step_pre)
from ..kernels.eta import (SLICE_LAUNCHES, SLICE_PACK, eta_colk_slice,
                           eta_fold_column, eta_ratio_summed, eta_workspace,
                           pack_slice)
from ..kernels.pivot import LAUNCHES as PIVOT_LAUNCHES
from ..kernels.seq import LAUNCHES as SEQ_LAUNCHES
from ..kernels.seq import (SeqScalars, pack_candidates, seq_fold_column,
                           seq_rank1, seq_ratio_colk_sharded, seq_scalars)
from ..problem import Problem
from ..result import SolveResult
from ..solver import (OPTIMAL, RUNNING, SEQ_CHUNK, LoopState, _at, _capture,
                      _check_apply, pivot_update, ratio_test)
from ..tableau import (Tableau, count_basic_artificials, extract_solution,
                       phase1_objective, round_up, tt_matvec)
from ..two_phase import DeviceSolveOutput, certify, resolve_device
from .group import (CapturedCollectives, Shard, all_gather,
                    all_gather_into, all_reduce, all_reduce_, capturable)


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
    return all_reduce_(torch.where(own & (base < r), vals, 0.0), shard.group)


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
    """One pivot of the sequential sharded loop as it ran eagerly
    (``solve_loop_sharded``'s body, ``sharded.py:253-279``; about 40
    torch calls and three allocating collectives): the entering fold, the
    entering column from its owner, the replicated ratio test, and the
    port's ``pivot_update`` on the local slice (the same rounding as
    ``solve``); idempotent once the loop has finished. The reference that
    the tests and ``chip_smoke.py`` hold ``solve_loop_sharded`` to."""
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
    return LoopState(tab2, exit_status(active, optimal, unbounded,
                                        state.status),
                     state.iterations + do.to(torch.int32), stall, bland)


@dataclasses.dataclass
class ShardedSeqLoop:
    """The sequential sharded loop's state on one rank (``solver.SeqLoop``
    on a slice): a fixed set of tensors, each only ever updated in place,
    since a CUDA graph of the chunk bakes in every pointer it reads -- its
    collectives' buffers included. ``Tt`` is the caller's slice; b, the
    slice's costs and base the loop's own copies; ``ah`` the (M_pad,)
    column ``seq_fold_column`` writes and the ``all_reduce`` sums in
    place; ``colk`` the slice's leaving row and ``fac`` the factors;
    ``send_v``, ``send_i`` and ``recv_v``, ``recv_i`` the two candidate
    ``all_gather``s' buffers ((2,) f64 and (2,) int32, and (P, 2) of
    each); ``s`` the scalars (h global); ``shard`` the rank's slice and
    ``r_loc`` its live columns."""

    Tt: torch.Tensor
    b: torch.Tensor
    costs: torch.Tensor
    base: torch.Tensor
    ah: torch.Tensor
    colk: torch.Tensor
    fac: torch.Tensor
    send_v: torch.Tensor
    send_i: torch.Tensor
    recv_v: torch.Tensor
    recv_i: torch.Tensor
    s: SeqScalars
    shard: Shard
    r_loc: int


def sharded_seq_loop(tab: Tableau, shard: Shard,
                     options: SolverOptions) -> ShardedSeqLoop:
    """The state at the start of ``solve_loop_sharded``: status RUNNING
    and the slice's first candidates packed into the send buffers
    (``entering_candidates``, ``pack_candidates``), with no collective:
    each pivot's two ``all_gather``s fold them."""
    Tt = tab.Tt
    M, R_loc = Tt.shape
    dev, dt = Tt.device, Tt.dtype
    f64, i32 = torch.float64, torch.int32
    loop = ShardedSeqLoop(
        Tt, b=tab.b.clone(), costs=tab.costs.clone(),
        base=tab.base.to(i32).clone(),
        ah=torch.zeros(M, dtype=dt, device=dev),
        colk=torch.zeros(R_loc, dtype=dt, device=dev),
        fac=torch.zeros(M, dtype=dt, device=dev),
        send_v=torch.empty(2, dtype=f64, device=dev),
        send_i=torch.empty(2, dtype=i32, device=dev),
        recv_v=torch.empty((shard.size, 2), dtype=f64, device=dev),
        recv_i=torch.empty((shard.size, 2), dtype=i32, device=dev),
        s=seq_scalars(tab.z.to(tab.costs.dtype),
                      options.pivot_rule_resolved == "bland", dt),
        shard=shard, r_loc=shard.local_r(tab.r))
    pack_candidates(entering_candidates(loop.costs, None, loop.r_loc,
                                        float(options.eps_resolved)),
                    shard.offset, loop.send_v, loop.send_i)
    return loop


def run_chunk_sharded(loop: ShardedSeqLoop, options: SolverOptions,
                      max_iter: int, pivots: int = SEQ_CHUNK) -> None:
    """Enqueue ``pivots`` pivots with no host read, each: the two
    ``all_gather``s of the candidates the pivot before packed (or the
    loop's start), ``seq_fold_column`` (their fold and the step before as
    its head, then the owner's column), the ``all_reduce`` of the column,
    ``seq_ratio_colk_sharded`` (the ratio test, the slice's pass, the
    pack and the step after) and ``seq_rank1`` on the slice: 2
    ``all_gather``s, 1 ``all_reduce`` and 3 launches a pivot, the body a
    CUDA graph captures (at one NCCL rank an ``all_gather`` is a device
    copy and the ``all_reduce`` no node). A skipped pivot still issues
    its collectives on every rank, and leaves the slice untouched."""
    eps = float(options.eps_resolved)
    policy = dict(bland_static=options.pivot_rule_resolved == "bland",
                  threshold=options.bland_threshold)
    s, sh = loop.s, loop.shard
    for _ in range(pivots):
        all_gather_into(loop.recv_v, loop.send_v, sh.group)
        all_gather_into(loop.recv_i, loop.send_i, sh.group)
        seq_fold_column(loop.Tt, loop.recv_v, loop.recv_i, loop.ah, s,
                        max_iter, eps, sh.offset)
        all_reduce_(loop.ah, sh.group)
        seq_ratio_colk_sharded(loop.Tt, loop.costs, loop.b, loop.base,
                               loop.ah, loop.colk, loop.fac, s, loop.r_loc,
                               eps, max_iter, offset=sh.offset,
                               send_v=loop.send_v, send_i=loop.send_i,
                               **policy)
        seq_rank1(loop.Tt, loop.fac, loop.colk, s)


def _capture_collectives(run, device, *tables):
    """``solver._capture`` of ``run`` with the collectives it issues:
    (graph, ``CapturedLaunches``, ``CapturedCollectives``). The group's
    communicator must be up (a collective issued on it before); the
    capture is thread-local, so ProcessGroupNCCL's watchdog thread may go
    on querying its events meanwhile. A failed capture raises."""
    with CapturedCollectives() as colls:
        graph, launches = _capture(run, device, *tables)
    return graph, launches, colls


def capture_chunk_sharded(loop: ShardedSeqLoop, options: SolverOptions,
                          max_iter: int):
    """One chunk of ``SEQ_CHUNK`` pivots (``run_chunk_sharded``) captured
    as a CUDA graph with its NCCL collectives: (graph,
    ``CapturedLaunches``, ``CapturedCollectives``)."""
    return _capture_collectives(
        lambda: run_chunk_sharded(loop, options, max_iter), loop.Tt.device,
        SEQ_LAUNCHES, PIVOT_LAUNCHES)


def solve_loop_sharded(tab: Tableau, shard: Shard, options: SolverOptions,
                       max_iter: int, *, graph: bool = True
                       ) -> tuple[Tableau, int, int]:
    """The sequential sharded loop (``sharded.py:240-286``): pivots until
    OPTIMAL / UNBOUNDED / the fuse, the host reading status once per
    ``SEQ_CHUNK`` pivots; the slice updated in place, b, the costs, z and
    base the loop's (``ShardedSeqLoop``). Each pivot is
    ``iteration_body_sharded``'s arithmetic as three kernels and three
    collectives (``run_chunk_sharded``), bit for bit.

    Where the group's collectives can be captured (NCCL on the card,
    ``group.capturable``) a chunk is one CUDA graph, its collectives
    inside, captured once a call and replayed once a chunk -- the JAX
    ``lax.while_loop`` under ``shard_map``; a chunk past the exit or the
    fuse runs skipped pivots. ``graph=False`` enqueues the same kernels
    and collectives eagerly, the on-card comparison path. Gloo ranks and
    the CPU run eagerly (the CPU with the plain versions), a chunk cut at
    the fuse as the eager body was: ``max_iter - iterations`` pivots at
    most."""
    loop = sharded_seq_loop(tab, shard, options)
    s = loop.s
    replay = graph and capturable(shard.group, tab.Tt)
    captured = None
    st, it = RUNNING, 0
    while st == RUNNING and it < max_iter:
        if replay:
            if captured is None:
                captured = capture_chunk_sharded(loop, options, max_iter)
            cuda_graph, launches, colls = captured
            cuda_graph.replay()
            launches.replayed()
            colls.replayed()
        else:
            run_chunk_sharded(loop, options, max_iter,
                              min(SEQ_CHUNK, max_iter - it))
        # The chunk's one host sync.
        st, it = (int(v) for v in
                  torch.stack([s.status, s.iterations]).tolist())
    out = dataclasses.replace(tab, b=loop.b, costs=loop.costs, z=s.z,
                              base=loop.base)
    return out, st, it


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


def blocked_sharded_reference_pivot(Tt, C, F, t: int, x: dict,
                                    shard: Shard, r: int,
                                    options: SolverOptions, max_iter: int,
                                    live=None) -> dict:
    """Pivot t of the plain blocked sharded loop as it ran before its
    window's graph (``solve_loop_blocked_sharded``'s body,
    ``sharded.py:411-466``; about 30 torch calls on new tensors and three
    allocating collectives, four under devex): the entering fold
    (``entering_sharded``), the live column from its owner (one
    ``all_reduce``), the replicated ratio test, the live row on the slice,
    and under devex the weights' update and re-anchor on the global max
    (``reanchor``, one ``all_gather``); from the carry ``x`` -- b, costs,
    z, base, w (the devex weights, else None), status, iterations, stall,
    bland -- to the next one; ``C[t]`` and ``F[t]`` are written in place.
    ``live(head, coef, rows, t)``, when given, forms the live column and
    row ``head - sum_{s<t} coef[s] rows[s]`` in place of ``head -
    coef[:t] @ rows[:t]`` (the tests pass ``kernels.eta.eta_live``, the
    kernels' order and precision)."""
    eps = float(options.eps_resolved)
    M, R_loc = Tt.shape
    vd = x["costs"].dtype
    b, costs, z, base, w = (x[n] for n in ("b", "costs", "z", "base", "w"))
    if live is None:
        def live(head, coef, rows, t):
            return head - coef[:t] @ rows[:t] if t else head
    active = (x["status"] == RUNNING) & (x["iterations"] < max_iter)
    h, minc, wh = entering_sharded(costs, x["bland"], r, eps, shard, w)
    optimal = minc > -eps
    loc, own = _owned(h, shard)
    hl = loc.view(1)
    a_h = all_reduce(torch.where(own, live(
        Tt.index_select(1, hl).view(M), C.index_select(1, hl).view(-1), F,
        t), 0.0), shard.group)
    mask = a_h >= eps
    unbounded = ~mask.any()
    k = torch.argmin(torch.where(
        mask, b / torch.where(mask, a_h, 1.0), torch.inf))
    do = active & ~(optimal | unbounded)
    p = torch.where(do, _at(a_h, k), 1.0)
    kl = k.view(1)
    colk = live(Tt.index_select(0, kl).view(R_loc),
                F.index_select(1, kl).view(-1), C, t)
    bk = _at(b, k)
    u = minc / p.to(vd)
    z2 = torch.where(do, z - u * bk, z)
    is_k = torch.arange(M, device=Tt.device) == k
    if w is not None:
        w, _ = reanchor(devex_update_sharded(
            w, do, colk, p, wh, _at(base, k), shard), shard)
    C[t] = torch.where(do, colk, 0.0)
    F[t] = torch.where(do, torch.where(is_k, 1.0 - 1.0 / p, a_h / p), 0.0)
    stall, bland = anticycling_update(
        do, (z2 - z).abs() >= eps, x["stall"], x["bland"],
        bland_static=options.pivot_rule_resolved == "bland",
        threshold=options.bland_threshold)
    return dict(
        b=torch.where(do, torch.where(is_k, bk / p.to(vd),
                                      b - bk * (a_h / p).to(vd)), b),
        costs=torch.where(do, costs - u * colk.to(vd), costs), z=z2,
        base=torch.where(do & is_k, h, base), w=w,
        status=exit_status(active, optimal, unbounded, x["status"]),
        iterations=x["iterations"] + do.to(torch.int32), stall=stall,
        bland=bland)


def blocked_sharded_reference_windows(tab: Tableau, shard: Shard,
                                      options: SolverOptions, max_iter: int,
                                      costs0: torch.Tensor | None = None,
                                      live=None):
    """The plain blocked sharded loop as it ran before its window's graph
    (``sharded.py:386-510``; the port's ``solver.blocked_reference_
    windows`` on the local slice): ``blocked_sharded_reference_pivot`` L
    times, the local apply ``Tt.addmm_`` and, with ``costs0`` on an f32
    tableau, the exact re-pricing (one ``all_reduce`` of the basic costs)
    and the reopening of a premature OPTIMAL (one ``all_gather`` of the
    slices' minima); one host read of status and iterations a window. A
    generator: after each window it yields the carry; ``Tt`` is updated in
    place. The reference that the tests and ``chip_smoke.py`` hold
    ``solve_loop_blocked_sharded`` to."""
    eps = float(options.eps_resolved)
    L = int(options.block_pivots or 1)
    Tt = tab.Tt
    M, R_loc = Tt.shape
    dev = Tt.device
    if Tt.dtype == torch.float64:
        costs0 = None
    _check_apply(Tt)
    row_mask = shard.row_mask(tab.r, dev)
    devex = options.pivot_rule_resolved == "devex"
    x = dict(b=tab.b, costs=tab.costs, z=tab.z, base=tab.base,
             w=torch.ones(R_loc, dtype=tab.costs.dtype, device=dev)
             if devex else None,
             status=torch.tensor(RUNNING, dtype=torch.int32, device=dev),
             iterations=torch.zeros((), dtype=torch.int32, device=dev),
             stall=torch.zeros((), dtype=torch.int32, device=dev),
             bland=torch.tensor(options.pivot_rule_resolved == "bland",
                                device=dev))
    C = torch.zeros((L, R_loc), dtype=Tt.dtype, device=dev)
    F = torch.zeros((L, M), dtype=Tt.dtype, device=dev)

    st, it = RUNNING, 0
    while st == RUNNING and it < max_iter:
        for t in range(L):
            x = blocked_sharded_reference_pivot(Tt, C, F, t, x, shard, tab.r,
                                                options, max_iter, live)
        Tt.addmm_(F.t(), C, alpha=-1.0)
        if costs0 is not None:
            x["costs"] = costs0 - tt_matvec(Tt, gather_basic_coeffs(
                x["base"], costs0, tab.r, shard))
            vmin = global_min(torch.where(row_mask, x["costs"],
                                          torch.inf).min(), shard)
            x["status"] = torch.where(
                (x["status"] == OPTIMAL) & (vmin <= -eps), RUNNING,
                x["status"]).to(torch.int32)
        st, it = (int(v) for v in
                  torch.stack([x["status"], x["iterations"]]).tolist())
        yield x


def solve_loop_blocked_sharded_reference(tab: Tableau, shard: Shard,
                                         options: SolverOptions,
                                         max_iter: int,
                                         costs0: torch.Tensor | None = None,
                                         live=None):
    """``blocked_sharded_reference_windows`` run to its end: (tableau,
    status, iterations), as ``solve_loop_blocked_sharded`` returns them."""
    for x in blocked_sharded_reference_windows(tab, shard, options,
                                               max_iter, costs0, live):
        pass
    out = dataclasses.replace(tab, b=x["b"], costs=x["costs"], z=x["z"],
                              base=x["base"])
    return out, int(x["status"]), int(x["iterations"])


@dataclasses.dataclass
class ShardedBlockedLoop:
    """The plain blocked sharded loop's state on one rank
    (``solver.BlockedLoop`` on a slice): a fixed set of tensors, each only
    ever updated in place, since a CUDA graph of the window bakes in every
    pointer it reads -- its collectives' buffers included. ``Tt`` is the
    caller's slice; ``C (L, R_loc)`` and ``F (L, M)`` the window's eta
    factors and ``ah`` the entering column (T); b, the slice's costs and
    base the loop's own copies, ``w`` the slice's devex weights (V; None
    under the other rules); ``ws`` ``eta_colk_slice``'s workspace;
    ``send_v``, ``send_i`` and ``recv_v``, ``recv_i`` the candidates'
    ``all_gather`` buffers (``kernels.eta.SLICE_PACK`` entries, and P rows
    of them);
    under devex ``send_w``, ``recv_w`` the re-anchor's (the slice's largest
    weight, every rank's) and ``wh`` the weight at h; where the window
    ends in the exact re-pricing (an f32 tableau with ``costs0``) the
    slice's ``costs0``, ``coef`` the basic costs' ``all_reduce`` buffer and
    ``send_min``, ``recv_min`` the premature-optimal minimum's, else None;
    ``s`` the scalars (h
    global); ``shard`` the rank's slice, ``r_loc`` its live columns and
    ``r`` the global ones."""

    Tt: torch.Tensor
    C: torch.Tensor
    F: torch.Tensor
    b: torch.Tensor
    costs: torch.Tensor
    base: torch.Tensor
    w: torch.Tensor | None
    ah: torch.Tensor
    ws: torch.Tensor
    send_v: torch.Tensor
    send_i: torch.Tensor
    recv_v: torch.Tensor
    recv_i: torch.Tensor
    send_w: torch.Tensor | None
    recv_w: torch.Tensor | None
    wh: torch.Tensor | None
    coef: torch.Tensor | None
    send_min: torch.Tensor | None
    recv_min: torch.Tensor | None
    costs0: torch.Tensor | None
    s: SeqScalars
    shard: Shard
    r_loc: int
    r: int

    def pack(self, eps: float) -> None:
        """The slice's candidates over its costs into the send buffers
        (``pack_slice``), with no collective: the next pivot's
        ``all_gather``s fold them."""
        pack_slice(self.costs, self.w, self.r_loc, eps, self.shard.offset,
                   self.send_v, self.send_i, self.send_w)


def sharded_blocked_loop(tab: Tableau, shard: Shard, options: SolverOptions,
                         costs0: torch.Tensor | None = None
                         ) -> ShardedBlockedLoop:
    """The state at the start of ``solve_loop_blocked_sharded``: the vectors
    in their own dtype, the devex weights at 1 (and no rank's largest
    weight past 1e8), status RUNNING and the slice's first candidates
    packed, with no collective."""
    L = int(options.block_pivots)
    Tt = tab.Tt
    M, R_loc = Tt.shape
    dev, dt, vd = Tt.device, Tt.dtype, tab.costs.dtype
    f64, i32 = torch.float64, torch.int32
    devex = options.pivot_rule_resolved == "devex"
    kv, ki = SLICE_PACK[devex]
    P = shard.size
    reprice = costs0 is not None and dt != torch.float64
    # Pivot t writes C[t] and F[t] (zeros when skipped) and reads rows
    # < t only, so the factors are never cleared.
    loop = ShardedBlockedLoop(
        Tt, C=torch.zeros((L, R_loc), dtype=dt, device=dev),
        F=torch.zeros((L, M), dtype=dt, device=dev), b=tab.b.clone(),
        costs=tab.costs.clone(), base=tab.base.to(i32).clone(),
        w=torch.ones(R_loc, dtype=vd, device=dev) if devex else None,
        ah=torch.zeros(M, dtype=dt, device=dev),
        ws=eta_workspace(M, R_loc, dev),
        send_v=torch.empty(kv, dtype=f64, device=dev),
        send_i=torch.empty(ki, dtype=i32, device=dev),
        recv_v=torch.empty((P, kv), dtype=f64, device=dev),
        recv_i=torch.empty((P, ki), dtype=i32, device=dev),
        send_w=torch.zeros((), dtype=f64, device=dev) if devex else None,
        recv_w=torch.zeros(P, dtype=f64, device=dev) if devex else None,
        wh=torch.ones((), dtype=vd, device=dev) if devex else None,
        coef=torch.zeros(M, dtype=vd, device=dev) if reprice else None,
        send_min=torch.zeros((), dtype=vd, device=dev) if reprice else None,
        recv_min=torch.zeros(P, dtype=vd, device=dev) if reprice else None,
        costs0=costs0 if reprice else None,
        s=seq_scalars(tab.z.to(vd), options.pivot_rule_resolved == "bland",
                      dt),
        shard=shard, r_loc=shard.local_r(tab.r), r=tab.r)
    loop.pack(float(options.eps_resolved))
    return loop


def _reprice_window(loop: ShardedBlockedLoop, eps: float) -> None:
    """The window boundary's exact re-pricing on an f32 tableau
    (``sharded.py:494-505``): the basic costs gathered into ``coef`` (one
    ``all_reduce``), ``costs = costs0 - Tt^T coef`` on the slice, the
    premature-optimal minimum over every slice (one ``all_gather``) and
    the reopening; then, under devex, the re-anchor the last pivot left to
    the next fold applied to the slice's weights, and the slice's
    candidates repacked over the new costs."""
    sh, s = loop.shard, loop.s
    loc, own = _owned(loop.base, sh)
    loop.coef.copy_(torch.where(own & (loop.base < loop.r),
                                loop.costs0.index_select(0, loc), 0.0))
    all_reduce_(loop.coef, sh.group)
    loop.costs.copy_(loop.costs0 - tt_matvec(loop.Tt, loop.coef))
    live = sh.row_mask(loop.r, loop.costs.device)
    loop.send_min.copy_(torch.where(live, loop.costs, torch.inf).min())
    all_gather_into(loop.recv_min, loop.send_min, sh.group)
    s.status.copy_(torch.where((s.status == OPTIMAL)
                               & (loop.recv_min.min() <= -eps), RUNNING,
                               s.status))
    if loop.w is not None:
        loop.w.copy_(torch.where(loop.recv_w.max() > 1e8, 1.0, loop.w))
    loop.pack(eps)


def run_blocked_pivot_sharded(loop: ShardedBlockedLoop, t: int,
                              options: SolverOptions, max_iter: int) -> None:
    """Enqueue pivot t of the window: the two ``all_gather``s of the
    candidates the pivot before packed (or the loop's start),
    ``eta_fold_column`` (their fold and the step before as its head, then
    the owner's live column), the ``all_reduce`` of the column,
    ``eta_ratio_summed`` (the ratio test and the step between),
    ``eta_colk_slice`` (the live row on the slice, the vectors, the eta
    pair, the pack and the step after) and, under devex, the
    ``all_gather`` of the slices' largest weights (the re-anchor's): 3
    launches, 2 ``all_gather``s (3 under devex) and 1 ``all_reduce``. A
    skipped pivot still issues its collectives on every rank."""
    eps = float(options.eps_resolved)
    s, sh = loop.s, loop.shard
    all_gather_into(loop.recv_v, loop.send_v, sh.group)
    all_gather_into(loop.recv_i, loop.send_i, sh.group)
    eta_fold_column(loop.Tt, loop.C, loop.F, loop.recv_v, loop.recv_i,
                    loop.recv_w, loop.ah, loop.w, loop.wh, s, t, max_iter,
                    eps, sh.offset)
    all_reduce_(loop.ah, sh.group)
    eta_ratio_summed(loop.b, loop.ah, s, eps)
    eta_colk_slice(loop.Tt, loop.C, loop.F, loop.costs, loop.b, loop.base,
                   loop.w, loop.ah, s, t, loop.r_loc, eps, max_iter, loop.ws,
                   offset=sh.offset, wh=loop.wh, send_v=loop.send_v,
                   send_i=loop.send_i, send_w=loop.send_w,
                   bland_static=options.pivot_rule_resolved == "bland",
                   threshold=options.bland_threshold)
    if loop.w is not None:
        all_gather_into(loop.recv_w, loop.send_w, sh.group)


def run_blocked_window_sharded(loop: ShardedBlockedLoop,
                               options: SolverOptions, max_iter: int) -> None:
    """Enqueue one window with no host read: L pivots
    (``run_blocked_pivot_sharded``), then the apply ``Tt -= F^T C`` on the
    slice (one ``addmm_``, cuBLAS) and, with ``costs0``,
    ``_reprice_window``: the body a CUDA graph captures (at one NCCL rank
    an ``all_gather`` is a device copy and the ``all_reduce`` no node)."""
    for t in range(loop.C.shape[0]):
        run_blocked_pivot_sharded(loop, t, options, max_iter)
    loop.Tt.addmm_(loop.F.t(), loop.C, alpha=-1.0)
    if loop.costs0 is not None:
        _reprice_window(loop, float(options.eps_resolved))


def capture_blocked_window_sharded(loop: ShardedBlockedLoop,
                                   options: SolverOptions, max_iter: int):
    """One window (``run_blocked_window_sharded``) captured as a CUDA graph
    with its NCCL collectives (``_capture_collectives``; the group's
    communicator must be up): (graph, ``CapturedLaunches``,
    ``CapturedCollectives``). The apply's and the re-pricing's scratch
    come from the graph's private memory pool."""
    return _capture_collectives(
        lambda: run_blocked_window_sharded(loop, options, max_iter),
        loop.Tt.device, SLICE_LAUNCHES)


def solve_loop_blocked_sharded(tab: Tableau, shard: Shard,
                               options: SolverOptions, max_iter: int,
                               costs0: torch.Tensor | None = None, *,
                               graph: bool = True):
    """Sharded deferred block pivoting (``solve_loop_blocked_sharded``,
    ``sharded.py:386-510``; the port's ``solver.solve_loop_blocked`` on
    the local slice, which it equals bit for bit at one rank): the stale
    slice and the eta columns ``C (L, R_loc)`` are local, the eta rows
    ``F`` and the vectors replicated. Each pivot is
    ``blocked_sharded_reference_pivot``'s as three kernels and its
    collectives (``run_blocked_window_sharded``; the live column and row in
    ``kernels.eta.eta_live``'s order and precision); a window ends in the
    slice's apply and, with ``costs0`` and an f32 tableau, the exact
    re-pricing and the reopening of a premature OPTIMAL. The slice is
    updated in place; b, the costs, z and base are the loop's
    (``ShardedBlockedLoop``). Returns (tableau, status, iterations).

    Where the group's collectives can be captured (NCCL on the card,
    ``group.capturable``) a window is one CUDA graph, its collectives
    inside, captured once a call and replayed once a window, the host
    reading status and iterations once a window -- the JAX loop's
    ``lax.while_loop`` over its ``lax.fori_loop`` under ``shard_map``.
    ``graph=False`` enqueues the same kernels and collectives eagerly, the
    on-card comparison path. Gloo ranks and the CPU run eagerly, the CPU
    with the plain versions. An f32 apply on the card needs TF32 off."""
    _check_apply(tab.Tt)
    loop = sharded_blocked_loop(tab, shard, options, costs0)
    s = loop.s
    replay = graph and capturable(shard.group, tab.Tt)
    captured = None
    st, it = RUNNING, 0
    while st == RUNNING and it < max_iter:
        if replay:
            if captured is None:
                captured = capture_blocked_window_sharded(loop, options,
                                                          max_iter)
            cuda_graph, launches, colls = captured
            cuda_graph.replay()
            launches.replayed()
            colls.replayed()
        else:
            run_blocked_window_sharded(loop, options, max_iter)
        # The window's one host sync.
        st, it = (int(v) for v in
                  torch.stack([s.status, s.iterations]).tolist())
    out = dataclasses.replace(tab, b=loop.b, costs=loop.costs, z=s.z,
                              base=loop.base)
    return out, st, it


# ---------------------------------------------------------------------------
# The kernel sharded loop (K5, K2, K3/K4 and the sharded step kernels on
# each slice).

@dataclasses.dataclass
class ShardedKernelLoop:
    """The sharded kernel loop's state on one rank (``solver.KernelLoop``'s
    counterpart): a fixed set of tensors, each only ever updated in place,
    since a CUDA graph of the window bakes in every pointer it reads --
    its collectives' buffers included. ``Tt`` is the caller's slice; b,
    the slice's costs (f64) and base the loop's own copies; ``w`` the
    slice's devex weights (None under the other rules); ``ah`` the (M_pad,)
    column K5 writes and the ``all_reduce`` sums in place; ``send_v``,
    ``send_i`` and ``recv_v``, ``recv_i`` the two candidate
    ``all_gather``s' buffers ((k,) f64 and (2,) int32, and (P, k), (P, 2));
    ``ws_k2`` K2's workspace; ``s`` the per-pivot scalars; ``shard`` the
    rank's slice and ``r_loc`` its live columns."""

    Tt: torch.Tensor
    C: torch.Tensor
    F: torch.Tensor
    b: torch.Tensor
    costs: torch.Tensor
    base: torch.Tensor
    w: torch.Tensor | None
    ah: torch.Tensor
    send_v: torch.Tensor
    send_i: torch.Tensor
    recv_v: torch.Tensor
    recv_i: torch.Tensor
    ws_k2: torch.Tensor
    s: ShardedScalars
    shard: Shard
    r_loc: int

    def refold(self, eps: float) -> None:
        """The slice's candidates over its costs, folded across the ranks
        into the scalars (the window boundary's fold): ``sharded_pack``,
        the two ``all_gather``s, ``sharded_fold``."""
        s, sh = self.s, self.shard
        for dst, src in zip((s.h_d, s.v_d, s.h_b, s.v_b), entering_candidates(
                self.costs, self.w, self.r_loc, eps)):
            dst.copy_(src)
        sharded_pack(s, self.w, sh.offset, self.send_v, self.send_i)
        all_gather_into(self.recv_v, self.send_v, sh.group)
        all_gather_into(self.recv_i, self.send_i, sh.group)
        sharded_fold(s, self.recv_v, self.recv_i)


def sharded_kernel_loop(tab: Tableau, shard: Shard,
                        options: SolverOptions) -> ShardedKernelLoop:
    """The state at the start of ``solve_loop_blocked_kernel_sharded``:
    the vectors in f64, the devex weights at 1, status RUNNING and the
    first candidates folded across the ranks (two ``all_gather``s, which
    also bring up the group's communicator before any capture)."""
    L = int(options.block_pivots)
    Tt = tab.Tt
    M, R_loc = Tt.shape
    dev = Tt.device
    f64, i32 = torch.float64, torch.int32
    devex = options.pivot_rule_resolved == "devex"
    kv = 5 if devex else 2
    # Every row of C and F is rewritten each window before any pass reads
    # it (a skipped pivot writes zeros), so the factors are never cleared.
    loop = ShardedKernelLoop(
        Tt, C=torch.zeros((L, R_loc), dtype=torch.float32, device=dev),
        F=torch.zeros((L, M), dtype=torch.float32, device=dev),
        b=tab.b.to(f64).clone(), costs=tab.costs.to(f64).clone(),
        base=tab.base.to(i32).clone(),
        w=torch.ones(R_loc, dtype=torch.float32, device=dev) if devex
        else None,
        ah=torch.empty(M, dtype=torch.float32, device=dev),
        send_v=torch.empty(kv, dtype=f64, device=dev),
        send_i=torch.empty(2, dtype=i32, device=dev),
        recv_v=torch.empty((shard.size, kv), dtype=f64, device=dev),
        recv_i=torch.empty((shard.size, 2), dtype=i32, device=dev),
        ws_k2=colk_workspace(R_loc, dev),
        s=sharded_scalars(tab.z, options.pivot_rule_resolved == "bland"),
        shard=shard, r_loc=shard.local_r(tab.r))
    loop.refold(float(options.eps_resolved))
    return loop


def run_window_sharded(loop: ShardedKernelLoop, options: SolverOptions,
                       max_iter: int) -> None:
    """Enqueue one window of L pivots with no host read: the step before
    K5 of the window's first pivot (``sharded_step_pre``); then per pivot
    K5 (the owner's column, zeros elsewhere; for every pivot but the first
    with the fold of the candidates gathered after the pivot before and
    the step before K5 as its head), its ``all_reduce``, the ratio test,
    K2 on the slice with the step after K2 and the pack of the slice's
    candidates into the send buffers as its tail, and the two candidate
    ``all_gather``s; then the fold of the last pivot's (``sharded_fold``).
    The step after K2 runs before the fold that the sharded loop first
    ran ahead of it: the two touch disjoint fields.
    ``t`` is a constant of each call: the body that a CUDA graph captures,
    collectives included."""
    eps = float(options.eps_resolved)
    L = int(options.block_pivots)
    policy = dict(bland_static=options.pivot_rule_resolved == "bland",
                  threshold=options.bland_threshold)
    s, sh = loop.s, loop.shard
    where = dict(offset=sh.offset, R_loc=sh.R_loc)
    sharded_step_pre(s, max_iter, eps, **where)
    for t in range(L):
        if t:
            ah_fold_head(loop.Tt, loop.F, loop.C, t, s, loop.recv_v,
                         loop.recv_i, max_iter, eps, sh.offset, out=loop.ah)
        else:
            ah(loop.Tt, loop.F, loop.C, s.hl, t, own=s.own, out=loop.ah)
        all_reduce_(loop.ah, sh.group)
        sharded_ratio(s, loop.ah, loop.b, eps)
        colk_costs_sharded_tail(
            loop.Tt, loop.C, loop.F, loop.costs, t, loop.r_loc, eps,
            loop.ah, loop.b, loop.base, loop.w, s, max_iter, loop.ws_k2,
            offset=sh.offset, send_v=loop.send_v, send_i=loop.send_i,
            **policy)
        all_gather_into(loop.recv_v, loop.send_v, sh.group)
        all_gather_into(loop.recv_i, loop.send_i, sh.group)
    sharded_fold(s, loop.recv_v, loop.recv_i)


def capture_window_sharded(loop: ShardedKernelLoop, options: SolverOptions,
                           max_iter: int):
    """One window (``run_window_sharded``) captured as a CUDA graph with
    its NCCL collectives (``_capture_collectives``; the communicator is up
    after ``sharded_kernel_loop``'s fold): (graph, ``CapturedLaunches``,
    ``CapturedCollectives``)."""
    return _capture_collectives(
        lambda: run_window_sharded(loop, options, max_iter), loop.Tt.device)


def solve_loop_blocked_kernel_sharded(tab: Tableau, shard: Shard,
                                      options: SolverOptions, max_iter: int,
                                      costs0: torch.Tensor | None = None, *,
                                      graph: bool = True):
    """Deferred block pivoting over K5, K2 and K3/K4 on each rank's slice
    (``solve_loop_blocked_kernel_sharded``, ``sharded.py:540-859``; the
    port's ``solver.solve_loop_blocked_kernel``, which it equals pivot for
    pivot at one rank).

    Per pivot: K5 builds the owner's live entering column (zeros on the
    other ranks), one (M_pad,) ``all_reduce`` sums it in place, the ratio
    step runs the ratio test on it in f64 (as K1's), K2 builds the
    slice's pivot row into ``C[t]``, updates the slice's costs and devex
    weights and the replicated b, base and eta row ``F[t]``, and folds and
    packs the slice's candidates, which two ``all_gather``s fold across
    the ranks, carrying the weights at both candidates; the step
    kernels (``kernels.blocked.sharded_*``) carry the scalar glue. Per
    window: the devex re-anchor's global max (one ``all_gather``); then
    either K4 (off cadence) or the basic-cost ``all_reduce``, K3, the
    candidate fold and the premature-optimal minimum (three
    ``all_gather``s), chosen on the host as the single-card loop chooses.
    The tableau slice is updated in place. Returns (tableau, status,
    iterations).

    Where the group's collectives can be captured (NCCL on the card,
    ``group.capturable``) the L pivots of a window are one CUDA graph,
    its collectives inside, captured once a call and replayed once a
    window -- the JAX loop's jitted ``lax.fori_loop`` under ``shard_map``;
    the window boundary stays on the host. ``graph=False`` enqueues the
    same kernels and collectives eagerly instead, the on-card comparison
    path. Gloo stages CUDA tensors through the host, which no graph
    captures, and the CPU has no graphs: both run eagerly, the CPU with
    the plain versions."""
    eps = float(options.eps_resolved)
    every = max(1, int(options.reprice_every))
    Tt = tab.Tt
    R_loc = Tt.shape[1]
    if Tt.dtype != torch.float32 or R_loc % 128:
        raise ValueError(f"the kernel loop needs an f32 slice of whole "
                         f"128-column tiles, got {Tt.dtype} R_loc={R_loc}")
    r = tab.r
    row_mask = shard.row_mask(r, Tt.device)
    if costs0 is not None:
        costs0 = costs0.to(torch.float64)
    loop = sharded_kernel_loop(tab, shard, options)
    s = loop.s
    replay = graph and capturable(shard.group, Tt)
    captured = None

    st, it, windows = RUNNING, 0, 0
    while st == RUNNING and it < max_iter and windows < max_iter:
        if replay:
            if captured is None:
                captured = capture_window_sharded(loop, options, max_iter)
            cuda_graph, launches, colls = captured
            cuda_graph.replay()
            launches.replayed()
            colls.replayed()
        else:
            run_window_sharded(loop, options, max_iter)
        if loop.w is not None:
            # Re-anchor the framework on the global max, once per window;
            # the carried weights at the candidates follow.
            reset = global_max(loop.w.max(), shard) > 1e8
            for x in (loop.w, s.w_d, s.w_b):
                x.copy_(torch.where(reset, 1.0, x))
        # The window's one host sync.
        st, it = (int(v) for v in
                  torch.stack([s.status, s.iterations]).tolist())
        if costs0 is not None and (st != RUNNING
                                   or (windows + 1) % every == 0):
            coeffs = gather_basic_coeffs(loop.base, costs0, r, shard)
            loop.costs.copy_(costs0 - apply_reprice(Tt, loop.C, loop.F,
                                                    coeffs))
            loop.refold(eps)
            vmin = global_min(torch.where(row_mask, loop.costs,
                                          torch.inf).min(), shard)
            if st == OPTIMAL and float(vmin) <= -eps:
                # Declared optimal on in-window costs while exact pricing
                # still shows an improving column: keep running.
                s.status.fill_(RUNNING)
                st = RUNNING
        else:
            apply_window(Tt, loop.C, loop.F)
        windows += 1

    vdtype = tab.costs.dtype
    out = dataclasses.replace(tab, Tt=Tt, b=loop.b.to(vdtype),
                              costs=loop.costs.to(vdtype),
                              z=s.z.to(vdtype), base=loop.base)
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
