"""The pivot loops and their dispatch.

Port of ``simplex_tpu.solver``: the sequential reference loop
(``choose_entering``, ``ratio_test``, ``iteration_body``,
``solve_loop``), its fused variant over K6 (``solve_loop_pallas``), the
plain deferred block-pivot loop (``solve_loop_blocked``), the
blocked-kernel loop over K1-K4 (``solve_loop_blocked_kernel``), and
``run_solve_loop``, which picks one of the four in the JAX package's
order and applies the ``normalize_costs`` scaling.

Every loop keeps its per-pivot decisions on the device: the candidates,
``do``, ``status``, ``stall``, ``bland`` and the iteration count are
0-dim tensors, and no pivot waits for the host. The host reads status
and iterations once per chunk of ``SEQ_CHUNK`` pivots (the sequential
loops) or once per window (the blocked loops): a pivot body is
idempotent once its loop has finished, and every pivot is gated on
``status == RUNNING and iterations < max_iter``, so a MAXITER exit
reports exactly ``max_iter`` pivots whatever the chunk.

The tableau is updated in place (the JAX package's loops return a new
one). The sequential loops (``SeqLoop``), the plain blocked loop
(``BlockedLoop``) and the blocked-kernel loop (``KernelLoop``) keep their
whole state in fixed tensors updated in place, and on the card replay one
CUDA graph a chunk or a window: the port of the JAX loops' compiled
``lax.while_loop`` and ``lax.fori_loop``. ``iteration_body``
(``timed.solve_timed``'s per-iteration pivot) and the plain blocked loop's
old body (``blocked_reference_windows``, the tests' reference) build new
b, costs, z and base each pivot.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import (EPS_REL_F32, SolverOptions, kernel_blocked_enabled,
                     normalize_enabled)
from .kernels.blocked import (OPTIMAL, RUNNING, CapturedLaunches,
                              PivotScalars, ah_ratio_tail,
                              ah_ratio_workspace, anticycling_update,
                              apply_reprice, apply_window, colk_costs_tail,
                              colk_workspace, entering_candidates,
                              exit_status, pivot_scalars, step_pre)
from .kernels.eta import LAUNCHES as ETA_LAUNCHES
from .kernels.eta import eta_candidates, eta_colk, eta_ratio, eta_workspace
from .kernels.pivot import LAUNCHES as PIVOT_LAUNCHES
from .kernels.seq import LAUNCHES as SEQ_LAUNCHES
from .kernels.seq import (SeqScalars, fused_pivot_tail,
                          fused_pivot_tail_workspace, seq_rank1,
                          seq_ratio_colk, seq_ratio_snapshot, seq_scalars,
                          seq_step_pre, set_candidates)
from .tableau import Tableau, basic_costs, tt_matvec

#: Pivots the sequential loops enqueue between two host reads of the
#: status: one CUDA graph on the card. After the exit the rest of a chunk
#: are skipped pivots, each a few microseconds of scalar work (no pass
#: over the tableau).
SEQ_CHUNK = 32


def _at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-dim index tensor, as a 0-dim tensor, without a
    host sync."""
    return x.index_select(0, i.long().view(1)).view(())


# ---------------------------------------------------------------------------
# The sequential reference loop.

def choose_entering(tab: Tableau, bland: torch.Tensor, eps: float):
    """Entering variable (``simplex_tpu.solver.choose_entering``): the
    Dantzig argmin of the active reduced costs, or -- when the Bland
    fallback is on and some column is eligible -- the lowest index with
    cost <= -eps; ties to the lowest index. Returns 0-dim (h int32,
    minc); the loop is optimal iff ``minc > -eps``."""
    R = tab.rows_padded
    iota = torch.arange(R, device=tab.costs.device)
    masked = torch.where(iota < tab.r, tab.costs, torch.inf)
    eligible = masked <= -eps
    h_bland = torch.argmin(torch.where(eligible, iota, R))
    h = torch.where(bland & eligible.any(), h_bland, torch.argmin(masked))
    return h.to(torch.int32), _at(masked, h)


def ratio_test(tab: Tableau, a_h: torch.Tensor, eps: float):
    """Leaving constraint (``simplex_tpu.solver.ratio_test``): the argmin
    of ``b / a_h`` over ``a_h >= eps`` (in the wider of the two dtypes),
    ties to the lowest index. Returns 0-dim (k int32, unbounded bool);
    unbounded iff no row is eligible (then k is 0)."""
    mask = a_h >= eps
    ratios = torch.where(mask, tab.b / torch.where(mask, a_h, 1.0),
                         torch.inf)
    return torch.argmin(ratios).to(torch.int32), ~mask.any()


def pivot_update(tab: Tableau, h, k, minc, p=None, do=None,
                 a_h=None) -> Tableau:
    """One rank-1 pivot (``simplex_tpu.solver.pivot_update``), entering
    variable h, leaving constraint k, both ints or 0-dim tensors: with
    ``a_h = Tt[:, h]``, ``p = a_h[k]`` (unless given) and ``colk =
    Tt[k]``, every row j of ``Tt`` loses ``(a_h[j] / p) * colk`` and row k
    becomes ``colk / p``; b, the costs, z and base follow, the vectors in
    their own dtype (``minc / p`` and the f32 tableau factors widen to it,
    as in the JAX package). With ``do`` (a 0-dim bool) false nothing
    changes. ``a_h``, when given, is the caller's copy of ``Tt[:, h]``.

    The tableau is updated in place by one ``Tt.addr_(factor, colk,
    alpha=-1)``: no tableau-sized temporary (1.6 GB at the 8192^2 f64
    tableau). It rounds as PyTorch's ``addr`` kernel does for the
    device: on an H100 (torch 2.11) the product and the difference apart,
    as the JAX package does, where the reference CUDA program rounds once
    (an FMA, ``solver.cu:43``); ``batch_fallback.seq_step``'s batched
    update rounds the same way. The CPU tests hold the f64 walks equal to
    the JAX package's."""
    Tt = tab.Tt
    M, R = Tt.shape
    dev = Tt.device
    h = torch.as_tensor(h, device=dev).long().view(1)
    k = torch.as_tensor(k, device=dev).long().view(1)
    if a_h is None:
        a_h = Tt.index_select(1, h).view(M)
    if p is None:
        p = a_h.index_select(0, k).view(())
    colk = Tt.index_select(0, k).view(R)
    bk = tab.b.index_select(0, k).view(())
    factor = a_h / p
    row_k = colk / p
    if do is not None:
        factor = torch.where(do, factor, 0.0)
        row_k = torch.where(do, row_k, colk)
    Tt.addr_(factor, colk, alpha=-1.0)
    Tt.index_copy_(0, k, row_k[None])

    vd = tab.b.dtype
    pv = p.to(vd)
    u = minc.to(vd) / pv
    b = tab.b - bk * factor.to(vd)
    b.index_copy_(0, k, (bk / pv).view(1))
    costs = tab.costs - u * colk.to(vd)
    z = tab.z - u * bk
    base = tab.base.index_copy(0, k, h.to(tab.base.dtype))
    if do is not None:
        b = torch.where(do, b, tab.b)
        costs = torch.where(do, costs, tab.costs)
        z = torch.where(do, z, tab.z)
        base = torch.where(do, base, tab.base)
    return dataclasses.replace(tab, b=b, costs=costs, z=z, base=base)


@dataclasses.dataclass
class LoopState:
    """The carry of ``iteration_body`` (``simplex_tpu.solver.LoopState``):
    the tableau, and 0-dim status, iterations and stall (int32) and bland
    (bool)."""

    tab: Tableau
    status: torch.Tensor
    iterations: torch.Tensor
    stall: torch.Tensor
    bland: torch.Tensor


def initial_state(tab: Tableau, options: SolverOptions) -> LoopState:
    dev = tab.Tt.device
    return LoopState(
        tab, torch.tensor(RUNNING, dtype=torch.int32, device=dev),
        torch.zeros((), dtype=torch.int32, device=dev),
        torch.zeros((), dtype=torch.int32, device=dev),
        torch.tensor(options.pivot_rule_resolved == "bland", device=dev))


def iteration_body(state: LoopState, options: SolverOptions,
                   max_iter: int) -> LoopState:
    """One pivot of the sequential loop (``simplex_tpu.solver.
    iteration_body``) in torch ops: entering argmin, unboundedness and
    min-ratio tests, the rank-1 update, the status and the anti-cycling
    policy, with no host sync. A skipped pivot (the loop finished, or the
    fuse reached) changes no value -- its ``addr_`` with factor 0 can only
    turn a -0.0 into +0.0, or an inf of the leaving row into NaN rows --
    so the body is idempotent once the loop has finished.
    ``timed.solve_timed``'s per-iteration pivot; ``solve_loop`` runs the
    same arithmetic as ``kernels.seq``'s passes, skipping the tableau on
    a skipped pivot."""
    eps = float(options.eps_resolved)
    tab = state.tab
    active = (state.status == RUNNING) & (state.iterations < max_iter)
    h, minc = choose_entering(tab, state.bland, eps)
    optimal = minc > -eps
    a_h = tab.Tt.index_select(1, h.long().view(1)).view(-1)
    k, unbounded = ratio_test(tab, a_h, eps)
    do = active & ~(optimal | unbounded)
    # Guard the division of a skipped pivot (p could be ~0 garbage).
    p = torch.where(do, _at(a_h, k), 1.0)
    tab2 = pivot_update(tab, h, k, minc, p=p, do=do, a_h=a_h)
    stall, bland = anticycling_update(
        do, (tab2.z - tab.z).abs() >= eps, state.stall, state.bland,
        bland_static=options.pivot_rule_resolved == "bland",
        threshold=options.bland_threshold)
    return LoopState(tab2, exit_status(active, optimal, unbounded,
                                        state.status),
                     state.iterations + do.to(torch.int32), stall, bland)


# ---------------------------------------------------------------------------
# The sequential loops as one device program a chunk.

@dataclasses.dataclass
class SeqLoop:
    """The sequential loops' state: a fixed set of tensors, each only ever
    updated in place, since a CUDA graph of the chunk bakes in every
    pointer. ``Tt`` is the caller's tableau; b, the costs and base the
    loop's own copies; ``ah`` and ``colk`` the pivot's entering column and
    leaving row, ``fac`` its factors ``a_h / p`` (None in the K6 loop,
    whose pass forms them); ``ws_pass`` K6's workspace, its partials and
    its tail's counter (None in the default loop, whose kernels take
    none); ``s`` the scalars; ``pallas``
    whether the pivot's pass is K6."""

    Tt: torch.Tensor
    b: torch.Tensor
    costs: torch.Tensor
    base: torch.Tensor
    ah: torch.Tensor
    colk: torch.Tensor
    fac: torch.Tensor | None
    ws_pass: torch.Tensor | None
    s: SeqScalars
    r: int
    pallas: bool


def seq_loop(tab: Tableau, options: SolverOptions,
             pallas: bool = False) -> SeqLoop:
    """The state at the start of a sequential loop: status RUNNING, the
    first candidates folded over the costs (``entering_candidates``, as
    ``choose_entering`` folds them)."""
    Tt = tab.Tt
    M, R = Tt.shape
    dev, dt = Tt.device, Tt.dtype
    loop = SeqLoop(
        Tt, b=tab.b.clone(), costs=tab.costs.clone(),
        base=tab.base.to(torch.int32).clone(),
        ah=torch.zeros(M, dtype=dt, device=dev),
        colk=torch.zeros(R, dtype=dt, device=dev),
        fac=None if pallas else torch.zeros(M, dtype=dt, device=dev),
        ws_pass=fused_pivot_tail_workspace(R, dev) if pallas else None,
        s=seq_scalars(tab.z.to(tab.costs.dtype),
                      options.pivot_rule_resolved == "bland", dt),
        r=tab.r, pallas=pallas)
    set_candidates(loop.s, entering_candidates(
        loop.costs, None, tab.r, float(options.eps_resolved)))
    return loop


def run_chunk(loop: SeqLoop, options: SolverOptions, max_iter: int) -> None:
    """Enqueue one chunk of ``SEQ_CHUNK`` pivots with no host read: the
    step before the first pivot's ratio test, then per pivot
    ``seq_ratio_colk`` (the column, the ratio test, the step between, the
    row, costs, candidates, b and base, the step after and the next
    pivot's step before) and ``seq_rank1`` -- or in the K6 loop
    ``seq_ratio_snapshot`` (the column, the ratio test, the step between,
    the row, b and base) and K6 with its fold and the step after as the
    tail of its last tile block. 2 SEQ_CHUNK + 1 launches on the card,
    the body a CUDA graph captures: as many nodes."""
    eps = float(options.eps_resolved)
    policy = dict(bland_static=options.pivot_rule_resolved == "bland",
                  threshold=options.bland_threshold)
    s = loop.s
    seq_step_pre(s, max_iter, eps)
    for t in range(SEQ_CHUNK):
        then_pre = t + 1 < SEQ_CHUNK
        if loop.pallas:
            seq_ratio_snapshot(loop.Tt, loop.b, loop.base, loop.ah,
                               loop.colk, s, eps)
            fused_pivot_tail(loop.Tt, loop.costs, loop.colk, loop.ah, s,
                             loop.r, eps, max_iter, loop.ws_pass,
                             then_pre=then_pre, **policy)
        else:
            seq_ratio_colk(loop.Tt, loop.costs, loop.b, loop.base, loop.ah,
                           loop.colk, loop.fac, s, loop.r, eps, max_iter,
                           then_pre=then_pre, **policy)
            seq_rank1(loop.Tt, loop.fac, loop.colk, s)


def _capture(run, device, *tables) -> tuple[torch.cuda.CUDAGraph,
                                            CapturedLaunches]:
    """``run()`` captured as a CUDA graph on a side stream, and the
    launches it holds (counted in ``tables``). A capture runs nothing, so
    no state moves; the kernel library is loaded first, outside it. A
    failed capture raises."""
    from .kernels._build import load_library

    load_library()
    graph = torch.cuda.CUDAGraph()
    with CapturedLaunches(*tables) as launches, \
            torch.cuda.stream(torch.cuda.Stream(device)):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            run()
        finally:
            graph.capture_end()
    return graph, launches


def capture_chunk(loop: SeqLoop, options: SolverOptions, max_iter: int
                  ) -> tuple[torch.cuda.CUDAGraph, CapturedLaunches]:
    """One chunk (``run_chunk``) captured as a CUDA graph, and the
    launches it holds."""
    return _capture(lambda: run_chunk(loop, options, max_iter),
                    loop.Tt.device, SEQ_LAUNCHES, PIVOT_LAUNCHES)


def _drive(s, run, capture, max_iter: int, graph: bool) -> tuple[int, int]:
    """Run a loop whose scalars are ``s`` to its exit, one ``run()`` (a
    chunk or a window) between two host reads of status and iterations:
    on the card one replay of ``capture()``'s CUDA graph, captured once a
    call (``graph=False``: ``run()`` enqueued eagerly), on the CPU
    ``run()`` with the plain versions. Returns (status, iterations)."""
    captured = None
    st, it = RUNNING, 0
    while st == RUNNING and it < max_iter:
        if graph and s.status.is_cuda:
            if captured is None:
                captured = capture()
            cuda_graph, launches = captured
            cuda_graph.replay()
            launches.replayed()
        else:
            run()
        # The chunk's or window's one host sync.
        st, it = (int(v) for v in
                  torch.stack([s.status, s.iterations]).tolist())
    return st, it


def _solve_seq(tab: Tableau, loop: SeqLoop, options: SolverOptions,
               max_iter: int, graph: bool) -> tuple[Tableau, int, int]:
    """Run ``loop`` to its exit, a chunk between two host reads of status
    and iterations (``_drive``)."""
    st, it = _drive(loop.s, lambda: run_chunk(loop, options, max_iter),
                    lambda: capture_chunk(loop, options, max_iter), max_iter,
                    graph)
    out = dataclasses.replace(tab, b=loop.b, costs=loop.costs, z=loop.s.z,
                              base=loop.base)
    return out, st, it


def solve_loop(tab: Tableau, options: SolverOptions, max_iter: int, *,
               graph: bool = True) -> tuple[Tableau, int, int]:
    """Pivots until OPTIMAL / UNBOUNDED / the iteration fuse
    (``simplex_tpu.solver.solve_loop``). Returns (tableau, status,
    iterations); status stays RUNNING if the fuse tripped. The pivot is
    ``iteration_body``'s arithmetic as two kernels (``run_chunk``); the
    tableau is updated in place and b, the costs, z and base are the
    loop's. On the card a chunk of ``SEQ_CHUNK`` pivots is one CUDA graph
    replay (the JAX ``lax.while_loop``), ``graph=False`` the same kernels
    enqueued eagerly (the on-card comparison path). A tableau and vectors
    of a dtype pair with no kernel raise on the card."""
    return _solve_seq(tab, seq_loop(tab, options), options, max_iter, graph)


def use_pallas(options: SolverOptions) -> bool:
    """Whether the sequential loop takes the fused pivot pass K6
    (``simplex_tpu.solver.use_pallas``): explicit ``use_pallas=True`` on
    a pure-f32 tableau (the pass is single-dtype). The JAX package also
    asks for a TPU backend; here K6's wrapper launches the kernel for
    CUDA tensors and takes its plain version for CPU ones."""
    if np.dtype(options.dtype).itemsize != 4:
        return False
    if np.dtype(options.vector_dtype) != np.dtype(options.dtype):
        return False
    return options.use_pallas is not False and options.use_pallas != "auto"


def solve_loop_pallas(tab: Tableau, options: SolverOptions, max_iter: int,
                      *, graph: bool = True) -> tuple[Tableau, int, int]:
    """The sequential loop over K6 (``simplex_tpu.solver.
    solve_loop_pallas``): per pivot one fused pass updates the tableau and
    the costs and folds the next candidates, so the body never re-reads
    the cost vector; before it ``seq_ratio_snapshot``, and its fold and
    the step after it the tail of its last tile block: two nodes a pivot.
    The same pivot sequence as
    ``solve_loop`` in exact arithmetic; in f32 K6 scales by ``1/p`` and
    the two part where rounding decides a tie. On the card one CUDA graph
    a chunk, as ``solve_loop``."""
    return _solve_seq(tab, seq_loop(tab, options, pallas=True), options,
                      max_iter, graph)


# ---------------------------------------------------------------------------
# The plain deferred block-pivot loop.

def _entering_blocked(costs, w, bland, r: int, eps: float, devex: bool):
    """``choose_entering`` on the bare cost vector, with the devex score
    (cost^2 / weight over eligible columns) in place of the Dantzig
    argmin when configured (``simplex_tpu.solver.solve_loop_blocked``'s
    ``entering``)."""
    R = costs.shape[0]
    iota = torch.arange(R, device=costs.device)
    masked = torch.where(iota < r, costs, torch.inf)
    eligible = masked <= -eps
    if devex:
        h_main = torch.argmax(torch.where(eligible, masked * masked / w,
                                          -torch.inf))
    else:
        h_main = torch.argmin(masked)
    h_bland = torch.argmin(torch.where(eligible, iota, R))
    h = torch.where(bland & eligible.any(), h_bland, h_main)
    return h.to(torch.int32), _at(masked, h)


def _devex_update(w, do, colk, p, h, old_base_k):
    """Forrest-Goldfarb reference-framework weights (``simplex_tpu.solver.
    solve_loop_blocked``'s ``devex_update``): alpha is the leaving row
    over all variables (colk / p); the leaving variable gets max(w_h /
    p^2, 1); capped at 1e12 with NaN reset to 1, and re-anchored to all
    ones when the framework drifts beyond 1e8."""
    R = w.shape[0]
    wh = _at(w, h)
    alpha = (colk / p).to(w.dtype)
    w2 = torch.maximum(w, alpha * alpha * wh)
    lv = old_base_k.clamp(max=R - 1).long().view(1)
    leaving = torch.maximum(wh / (p * p).to(w.dtype), torch.ones_like(wh))
    w2 = w2.index_copy(0, lv, torch.where(old_base_k < R, leaving,
                                          _at(w2, lv)).view(1))
    w2 = torch.minimum(w2, torch.full_like(w2, 1e12))
    w2 = torch.where(torch.isnan(w2), 1.0, w2)
    w2 = torch.where(w2.max() > 1e8, 1.0, w2)
    return torch.where(do, w2, w)


def _check_apply(Tt: torch.Tensor) -> None:
    """An f32 window apply on the card needs IEEE products (TF32 off)."""
    if (Tt.dtype != torch.float64 and Tt.is_cuda
            and torch.backends.cuda.matmul.allow_tf32):
        raise ValueError("the f32 window apply needs IEEE products: set "
                         "torch.backends.cuda.matmul.allow_tf32 = False")


def blocked_reference_pivot(Tt, C, F, t: int, x: dict, r: int,
                            options: SolverOptions, max_iter: int,
                            live=None) -> dict:
    """Pivot t of the plain blocked loop as it ran before its window's
    graph (about 30 torch calls on new tensors: ``_entering_blocked``, the
    eta corrections as ``@`` products, ``_devex_update``), from the carry
    ``x`` -- b, costs, z, base, w (the devex weights, ones under the other
    rules), status, iterations, stall, bland -- to the next one; ``C[t]``
    and ``F[t]`` are written in place. ``live(head, coef, rows, t)``, when
    given, forms the live column and row ``head - sum_{s<t} coef[s]
    rows[s]`` in place of ``head - coef[:t] @ rows[:t]`` (the tests pass
    ``kernels.eta.eta_live``, the kernels' order and precision)."""
    eps = float(options.eps_resolved)
    devex = options.pivot_rule_resolved == "devex"
    M, R = Tt.shape
    vd = x["costs"].dtype
    b, costs, z, base, w = (x[n] for n in ("b", "costs", "z", "base", "w"))
    active = (x["status"] == RUNNING) & (x["iterations"] < max_iter)
    h, minc = _entering_blocked(costs, w, x["bland"], r, eps, devex)
    optimal = minc > -eps
    if live is None:
        def live(head, coef, rows, t):
            return head - coef[:t] @ rows[:t] if t else head
    hl = h.long().view(1)
    a_h = live(Tt.index_select(1, hl).view(M), C.index_select(1, hl).view(-1),
               F, t)
    mask = a_h >= eps
    unbounded = ~mask.any()
    k = torch.argmin(torch.where(
        mask, b / torch.where(mask, a_h, 1.0), torch.inf))
    do = active & ~(optimal | unbounded)
    p = torch.where(do, _at(a_h, k), 1.0)
    kl = k.view(1)
    colk = live(Tt.index_select(0, kl).view(R),
                F.index_select(1, kl).view(-1), C, t)
    bk = _at(b, k)
    u = minc / p.to(vd)
    z2 = torch.where(do, z - u * bk, z)
    is_k = torch.arange(M, device=Tt.device) == k
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
        base=torch.where(do & is_k, h, base),
        w=_devex_update(w, do, colk, p, h, _at(base, k)) if devex else w,
        status=exit_status(active, optimal, unbounded, x["status"]),
        iterations=x["iterations"] + do.to(torch.int32), stall=stall,
        bland=bland)


def blocked_reference_windows(tab: Tableau, options: SolverOptions,
                              max_iter: int,
                              costs0: torch.Tensor | None = None,
                              live=None):
    """The plain blocked loop as it ran before its window's graph:
    ``blocked_reference_pivot`` L times, the window's apply
    ``Tt.addmm_`` and, with ``costs0`` on an f32 tableau, the re-pricing
    and the reopening of a premature OPTIMAL; one host read of status and
    iterations a window. A generator: after each window it yields the
    loop's carry (``blocked_reference_pivot``'s dict of tensors, its live
    column and row formed by ``live``); ``Tt`` is updated in place. The
    reference that the tests and ``chip_smoke.py`` hold
    ``solve_loop_blocked`` to."""
    eps = float(options.eps_resolved)
    L = int(options.block_pivots or 1)
    Tt = tab.Tt
    M, R = Tt.shape
    dev = Tt.device
    if Tt.dtype == torch.float64:
        costs0 = None
    _check_apply(Tt)
    row_mask = torch.arange(R, device=dev) < tab.r
    x = dict(b=tab.b, costs=tab.costs, z=tab.z, base=tab.base,
             w=torch.ones(R, dtype=tab.costs.dtype, device=dev),
             status=torch.tensor(RUNNING, dtype=torch.int32, device=dev),
             iterations=torch.zeros((), dtype=torch.int32, device=dev),
             stall=torch.zeros((), dtype=torch.int32, device=dev),
             bland=torch.tensor(options.pivot_rule_resolved == "bland",
                                device=dev))
    # Pivot t writes C[t] and F[t] (zeros when skipped) and reads rows
    # < t only, so the factors are never cleared.
    C = torch.zeros((L, R), dtype=Tt.dtype, device=dev)
    F = torch.zeros((L, M), dtype=Tt.dtype, device=dev)

    st, it = RUNNING, 0
    while st == RUNNING and it < max_iter:
        for t in range(L):
            x = blocked_reference_pivot(Tt, C, F, t, x, tab.r, options,
                                        max_iter, live)
        Tt.addmm_(F.t(), C, alpha=-1.0)
        if costs0 is not None:
            x["costs"] = costs0 - tt_matvec(
                Tt, basic_costs(x["base"], costs0, tab.r))
            vmin = torch.where(row_mask, x["costs"], torch.inf).min()
            x["status"] = torch.where(
                (x["status"] == OPTIMAL) & (vmin <= -eps), RUNNING,
                x["status"]).to(torch.int32)
        # The window's one host read.
        st, it = (int(v) for v in
                  torch.stack([x["status"], x["iterations"]]).tolist())
        yield x


def solve_loop_blocked_reference(tab: Tableau, options: SolverOptions,
                                 max_iter: int,
                                 costs0: torch.Tensor | None = None,
                                 live=None) -> tuple[Tableau, int, int]:
    """``blocked_reference_windows`` run to its end: (tableau, status,
    iterations), as ``solve_loop_blocked`` returns them."""
    for state in blocked_reference_windows(tab, options, max_iter, costs0,
                                           live):
        pass
    out = dataclasses.replace(tab, b=state["b"], costs=state["costs"],
                              z=state["z"], base=state["base"])
    return out, int(state["status"]), int(state["iterations"])


@dataclasses.dataclass
class BlockedLoop:
    """The plain blocked loop's state: a fixed set of tensors, each only
    ever updated in place, since a CUDA graph of the window bakes in every
    pointer. ``Tt`` is the caller's tableau (T); ``C (L, R)`` and ``F (L,
    M)`` the window's eta factors and ``ah`` the entering column (T); b,
    the costs and base the loop's own copies and ``w`` the devex weights
    (V; None under the other rules); ``ws`` the kernels' workspace
    (``kernels.eta.eta_workspace``); ``s`` the scalars; ``costs0`` the
    phase's pre-elimination costs where the window ends in the exact
    re-pricing (an f32 tableau), else None."""

    Tt: torch.Tensor
    C: torch.Tensor
    F: torch.Tensor
    b: torch.Tensor
    costs: torch.Tensor
    base: torch.Tensor
    w: torch.Tensor | None
    ah: torch.Tensor
    ws: torch.Tensor
    s: SeqScalars
    r: int
    costs0: torch.Tensor | None


def blocked_loop(tab: Tableau, options: SolverOptions,
                 costs0: torch.Tensor | None = None) -> BlockedLoop:
    """The state at the start of ``solve_loop_blocked``: the vectors in
    their own dtype, the devex weights at 1, status RUNNING and the first
    candidates folded over the costs (``eta_candidates``)."""
    L = int(options.block_pivots)
    Tt = tab.Tt
    M, R = Tt.shape
    dev, dt, vd = Tt.device, Tt.dtype, tab.costs.dtype
    devex = options.pivot_rule_resolved == "devex"
    # Pivot t writes C[t] and F[t] (zeros when skipped) and reads rows
    # < t only, so the factors are never cleared.
    loop = BlockedLoop(
        Tt, C=torch.zeros((L, R), dtype=dt, device=dev),
        F=torch.zeros((L, M), dtype=dt, device=dev), b=tab.b.clone(),
        costs=tab.costs.clone(), base=tab.base.to(torch.int32).clone(),
        w=torch.ones(R, dtype=vd, device=dev) if devex else None,
        ah=torch.zeros(M, dtype=dt, device=dev),
        ws=eta_workspace(M, R, dev),
        s=seq_scalars(tab.z.to(vd), options.pivot_rule_resolved == "bland",
                      dt),
        r=tab.r, costs0=None if dt == torch.float64 else costs0)
    set_candidates(loop.s, eta_candidates(
        loop.costs, loop.w, tab.r, float(options.eps_resolved)))
    return loop


def run_blocked_window(loop: BlockedLoop, options: SolverOptions,
                       max_iter: int) -> None:
    """Enqueue one window with no host read: ``seq_step_pre``, then per
    pivot t ``eta_ratio`` (the column, the ratio test, the step between)
    and ``eta_colk`` (the row, C[t], F[t], the vectors, the candidates,
    the step after and, but at t = L - 1, the next step before), then the
    apply ``Tt -= F^T C`` (one ``addmm_``, cuBLAS) and, with ``costs0``,
    the exact re-pricing (``tt_matvec``), the reopening of a premature
    OPTIMAL and the candidates refolded: 2L + 1 kernels and the apply on
    the card (more nodes for the re-pricing), the body a CUDA graph
    captures."""
    eps = float(options.eps_resolved)
    L = loop.C.shape[0]
    policy = dict(bland_static=options.pivot_rule_resolved == "bland",
                  threshold=options.bland_threshold)
    s = loop.s
    seq_step_pre(s, max_iter, eps)
    for t in range(L):
        eta_ratio(loop.Tt, loop.C, loop.F, loop.b, loop.ah, s, t, eps,
                  loop.ws)
        eta_colk(loop.Tt, loop.C, loop.F, loop.costs, loop.b, loop.base,
                 loop.w, loop.ah, s, t, loop.r, eps, max_iter, loop.ws,
                 then_pre=t + 1 < L, **policy)
    loop.Tt.addmm_(loop.F.t(), loop.C, alpha=-1.0)
    if loop.costs0 is not None:
        # Exact re-pricing at the window boundary: an OPTIMAL declared on
        # drifted costs while exact pricing still shows an improving
        # column is reopened.
        loop.costs.copy_(loop.costs0 - tt_matvec(
            loop.Tt, basic_costs(loop.base, loop.costs0, loop.r)))
        live = torch.arange(loop.costs.shape[0],
                            device=loop.costs.device) < loop.r
        vmin = torch.where(live, loop.costs, torch.inf).min()
        s.status.copy_(torch.where((s.status == OPTIMAL) & (vmin <= -eps),
                                   RUNNING, s.status))
        set_candidates(s, eta_candidates(loop.costs, loop.w, loop.r, eps))


def capture_blocked_window(loop: BlockedLoop, options: SolverOptions,
                           max_iter: int
                           ) -> tuple[torch.cuda.CUDAGraph, CapturedLaunches]:
    """One window (``run_blocked_window``) captured as a CUDA graph, and
    the launches it holds. The apply's and the re-pricing's scratch come
    from the graph's private memory pool."""
    return _capture(lambda: run_blocked_window(loop, options, max_iter),
                    loop.Tt.device, ETA_LAUNCHES, SEQ_LAUNCHES)


def solve_loop_blocked(tab: Tableau, options: SolverOptions, max_iter: int,
                       costs0: torch.Tensor | None = None, *,
                       graph: bool = True) -> tuple[Tableau, int, int]:
    """Deferred block pivoting (``simplex_tpu.solver.solve_loop_blocked``):
    the loop for f64 tableaus, and for f32 ones when the kernels are off
    (``use_pallas=False``), L is not a multiple of 8 or R not of 128.

    The tableau stays stale for a window of L pivots. Pivot t reads the
    live entering column ``Tt[:, h] - sum_{s<t} C[s, h] F[s]`` and leaving
    row ``Tt[k] - sum_{s<t} F[s, k] C[s]``, updates b, the costs, z, base
    and the devex weights exactly (the weights re-anchored every pivot),
    and stores its eta pair in ``C[t]``, ``F[t]``; the window ends in ``Tt
    -= F^T C`` (one ``addmm_``, in place). With ``costs0`` and an f32
    tableau the costs are re-priced exactly at every window boundary
    (``reprice_every`` is not read, as in the JAX loop), and an OPTIMAL
    declared on drifted costs while exact pricing still shows an improving
    column is reopened. f64 tableaus are not re-priced (incremental f64
    updates drift ~1e-13). Returns (tableau, status, iterations); status
    stays RUNNING when the iteration fuse tripped, which it does at
    exactly ``max_iter`` pivots, mid-window too.

    A pivot is two kernels (``kernels.eta``; ``run_blocked_window``); the
    tableau is updated in place and b, the costs, z and base are the
    loop's. On the card a window is one CUDA graph replay, captured once a
    call (the JAX ``lax.while_loop`` over its ``lax.fori_loop``), and the
    host reads status and iterations once a window; ``graph=False``
    enqueues the same kernels and calls eagerly (the on-card comparison
    path); the CPU runs the plain versions eagerly. The JAX package
    emulates f64 on the TPU, so it forms the f64 eta corrections
    elementwise and the f64 apply as a Dekker split (``_split_dot``); here
    both are native f64. An f32 apply on the card needs TF32 off (IEEE
    products, the JAX loop's HIGHEST precision). A tableau and vectors of
    a dtype pair with no kernel raise on the card."""
    _check_apply(tab.Tt)
    loop = blocked_loop(tab, options, costs0)
    st, it = _drive(
        loop.s, lambda: run_blocked_window(loop, options, max_iter),
        lambda: capture_blocked_window(loop, options, max_iter), max_iter,
        graph)
    out = dataclasses.replace(tab, b=loop.b, costs=loop.costs, z=loop.s.z,
                              base=loop.base)
    return out, st, it


# ---------------------------------------------------------------------------
# The blocked-kernel loop (K1-K4).

@dataclasses.dataclass
class KernelLoop:
    """The blocked-kernel loop's state: a fixed set of tensors, each only
    ever updated in place, since a CUDA graph of the window bakes in every
    pointer it reads. ``Tt`` is the caller's tableau; b, the costs (f64)
    and base are the loop's own copies; ``w`` holds the devex weights
    (None under the other rules); ``ah`` is K1's column, ``ws_k1`` and
    ``ws_k2`` K1's and K2's workspaces; ``s`` the per-pivot scalars."""

    Tt: torch.Tensor
    C: torch.Tensor
    F: torch.Tensor
    b: torch.Tensor
    costs: torch.Tensor
    base: torch.Tensor
    w: torch.Tensor | None
    ah: torch.Tensor
    ws_k1: torch.Tensor
    ws_k2: torch.Tensor
    s: PivotScalars
    r: int

    def set_candidates(self, cands) -> None:
        for dst, src in zip((self.s.h_d, self.s.v_d, self.s.h_b,
                             self.s.v_b), cands):
            dst.copy_(src)


def kernel_loop(tab: Tableau, options: SolverOptions) -> KernelLoop:
    """The state at the start of ``solve_loop_blocked_kernel``: the
    vectors in f64, the devex weights at 1, status RUNNING and the first
    candidates folded over the costs."""
    L = int(options.block_pivots)
    Tt = tab.Tt
    M, R = Tt.shape
    dev = Tt.device
    f64 = torch.float64
    devex = options.pivot_rule_resolved == "devex"
    # Every row of C and F is rewritten each window before any pass reads
    # it (a skipped pivot writes zeros), so the factors are never cleared.
    loop = KernelLoop(
        Tt, C=torch.zeros((L, R), dtype=torch.float32, device=dev),
        F=torch.zeros((L, M), dtype=torch.float32, device=dev),
        b=tab.b.to(f64).clone(), costs=tab.costs.to(f64).clone(),
        base=tab.base.to(torch.int32).clone(),
        w=torch.ones(R, dtype=torch.float32, device=dev) if devex else None,
        ah=torch.empty(M, dtype=torch.float32, device=dev),
        ws_k1=ah_ratio_workspace(M, dev), ws_k2=colk_workspace(R, dev),
        s=pivot_scalars(tab.z, options.pivot_rule_resolved == "bland"),
        r=tab.r)
    loop.set_candidates(entering_candidates(
        loop.costs, loop.w, tab.r, float(options.eps_resolved)))
    return loop


def run_window(loop: KernelLoop, options: SolverOptions,
               max_iter: int) -> None:
    """Enqueue one window of L pivots with no host read: the step before
    K1 of the window's first pivot, then per pivot K1 with the step
    between K1 and K2 as its tail, and K2 with the step after as its
    tail, which also runs the next pivot's step before K1 -- 2L + 1
    launches on the card. ``t`` is a constant of each call: the body that
    a CUDA graph captures."""
    eps = float(options.eps_resolved)
    L = int(options.block_pivots)
    policy = dict(bland_static=options.pivot_rule_resolved == "bland",
                  threshold=options.bland_threshold)
    s = loop.s
    step_pre(s, max_iter, eps)
    for t in range(L):
        ah_ratio_tail(loop.Tt, loop.F, loop.C, loop.b, t, eps, s, loop.ah,
                      loop.ws_k1)
        colk_costs_tail(loop.Tt, loop.C, loop.F, loop.costs, t, loop.r, eps,
                        loop.ah, loop.b, loop.base, loop.w, s, max_iter,
                        loop.ws_k2, then_pre=t + 1 < L, **policy)


def capture_window(loop: KernelLoop, options: SolverOptions, max_iter: int
                   ) -> tuple[torch.cuda.CUDAGraph, CapturedLaunches]:
    """One window (``run_window``) captured as a CUDA graph, and the
    launches it holds."""
    return _capture(lambda: run_window(loop, options, max_iter),
                    loop.Tt.device)


def solve_loop_blocked_kernel(tab: Tableau, options: SolverOptions,
                              max_iter: int,
                              costs0: torch.Tensor | None = None, *,
                              graph: bool = True
                              ) -> tuple[Tableau, int, int]:
    """Deferred block pivoting over K1-K4 (port of
    ``simplex_tpu.solver.solve_loop_blocked_kernel``).

    Per pivot: K1 builds the live entering column and runs the ratio
    test; K2 builds the pivot row into ``C[t]``, updates costs, b, base,
    the eta row ``F[t]`` and the devex weights, and folds the next
    candidates; the scalar glue between them runs as their tails
    (``kernels.blocked.ah_ratio_tail``, ``colk_costs_tail``), and a
    window's first step before K1 as ``step_pre``. Per window of L pivots: ``Tt -= F^T C`` in
    place, fused with the exact re-pricing ``costs0 - coeffs @ Tt`` every
    ``reprice_every`` windows and on every window that ends non-RUNNING
    (K3), else the apply alone (K4; always when ``costs0`` is None). The
    tableau is updated in place. Returns (tableau, status, iterations);
    status stays RUNNING when the iteration fuse tripped.

    On the card the L pivots of a window are one CUDA graph, captured
    once a call and replayed once a window (the JAX loop's jitted
    ``lax.fori_loop``); the window boundary -- the devex re-anchor, the
    one host read of status and iterations, K3 or K4 -- stays on the
    host (the ``while_loop``'s ``cond`` and tail). ``graph=False``
    enqueues the same kernels eagerly instead, the on-card comparison
    path; on the CPU the loop always runs eagerly, with the plain
    versions.

    b, the reduced costs and z are native f64 inside the loop, so the
    in-window optimality test, the candidate fold and the window-boundary
    premature test all read one representation (the JAX loop's
    double-f32 pairs needed the round-trip discipline of
    ``simplex_tpu/solver.py:813-823``; the ``windows < max_iter`` bound
    stays all the same). The host reads status and iterations once per
    window (plus once more on a window that ends optimal, for the
    premature-optimal test)."""
    eps = float(options.eps_resolved)
    every = max(1, int(options.reprice_every))
    Tt = tab.Tt
    R = Tt.shape[1]
    if Tt.dtype != torch.float32 or R % 128:
        raise ValueError(f"the kernel loop needs an f32 tableau padded to "
                         f"128 variables, got {Tt.dtype} R={R}")
    r = tab.r
    if costs0 is not None:
        costs0 = costs0.to(torch.float64)
    loop = kernel_loop(tab, options)
    s = loop.s
    captured = None

    st, it, windows = RUNNING, 0, 0
    while st == RUNNING and it < max_iter and windows < max_iter:
        if graph and Tt.is_cuda:
            if captured is None:
                captured = capture_window(loop, options, max_iter)
            cuda_graph, launches = captured
            cuda_graph.replay()
            launches.replayed()
        else:
            run_window(loop, options, max_iter)
        if loop.w is not None:
            # Re-anchor the reference framework once per window when the
            # weights drift too far.
            loop.w.copy_(torch.where(loop.w.max() > 1e8, 1.0, loop.w))
        # The window's one host sync.
        st, it = (int(v) for v in
                  torch.stack([s.status, s.iterations]).tolist())
        # Exact re-pricing every ``reprice_every`` windows and on every
        # window that ends non-RUNNING (K3); otherwise the apply alone
        # (K4), the in-window costs and candidates being current.
        if costs0 is not None and (st != RUNNING
                                   or (windows + 1) % every == 0):
            coeffs = basic_costs(loop.base, costs0, r)
            loop.costs.copy_(costs0 - apply_reprice(Tt, loop.C, loop.F,
                                                    coeffs))
            loop.set_candidates(entering_candidates(loop.costs, loop.w, r,
                                                    eps))
            if st == OPTIMAL and float(torch.where(
                    torch.arange(R, device=Tt.device) < r, loop.costs,
                    torch.inf).min()) <= -eps:
                # Declared optimal on in-window costs while exact pricing
                # still shows an improving column: keep running.
                s.status.fill_(RUNNING)
                st = RUNNING
        else:
            apply_window(Tt, loop.C, loop.F)
        windows += 1

    vdtype = tab.costs.dtype
    out = dataclasses.replace(tab, b=loop.b.to(vdtype),
                              costs=loop.costs.to(vdtype),
                              z=s.z.to(vdtype), base=loop.base)
    return out, st, it


def run_solve_loop(tab: Tableau, options: SolverOptions, max_iter: int,
                   costs0: torch.Tensor | None = None
                   ) -> tuple[Tableau, int, int]:
    """Dispatch (``simplex_tpu.solver.run_solve_loop``): the deferred
    block-pivot loops when ``block_pivots`` > 1 (the kernel loop when
    ``kernel_blocked_enabled``, else the plain one), else the sequential
    loop, over K6 when ``use_pallas`` selects it. ``costs0`` (the phase's
    pre-elimination costs) enables the blocked loops' exact re-pricing;
    the sequential loops ignore it.

    With ``normalize_costs`` on (f32 tableaus by default) the working
    costs, z and costs0 are divided by ``max(1, EPS_REL_F32 / eps * (1 +
    max|costs|))`` for the call and restored on exit, which floors the
    pricing eps at the f32 data-precision threshold."""
    L = int(options.block_pivots or 1)
    if options.pivot_rule_resolved == "devex" and L <= 1:
        raise ValueError(
            "pivot_rule='devex' requires block_pivots > 1 (the deferred "
            "block-pivot loops carry the devex weights); the sequential "
            "reference loop prices with Dantzig/Bland only")
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

    if L > 1:
        if kernel_blocked_enabled(options) and tab.rows_padded % 128 == 0:
            out = solve_loop_blocked_kernel(tab, options, max_iter, costs0)
        else:
            out = solve_loop_blocked(tab, options, max_iter, costs0)
    elif use_pallas(options):
        out = solve_loop_pallas(tab, options, max_iter)
    else:
        out = solve_loop(tab, options, max_iter)

    tab_out, status, iters = out
    if scale is not None:
        tab_out = dataclasses.replace(tab_out, costs=tab_out.costs * scale,
                                      z=tab_out.z * scale)
    return tab_out, status, iters
